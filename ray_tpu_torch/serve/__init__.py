"""ray_tpu_torch.serve: model serving (Ray Serve analog, `python/ray/serve/`).

Counterpart: ``ray_tpu/serve/__init__.py``. `@serve.deployment` ->
`.bind()` -> `serve.run()`; replicas are async actors behind a
power-of-two-choices router with prefix affinity; the controller reconciles
replica counts, replaces dead replicas and autoscales on in-flight requests
and queue depth. The LLM deployment is ``serve.llm.LLMServer``
(``build_app``).

This module imports the runtime only, never torch: a driver that deploys
plain functions never loads it.

Not ported yet (ROADMAP A4b): the HTTP proxy (``start``), ASGI ingress
(``ingress``) and the binary RPC ingress (``start_rpc_ingress``). Each
raises ``NotImplementedError``; none falls back to another path.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Tuple, Union

import ray_tpu_torch as rt
from ray_tpu_torch.serve._private.controller import (CONTROLLER_NAME,
                                                     ServeController)
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.handle import DeploymentHandle, DeploymentResponse
from ray_tpu_torch.serve.multiplex import (get_multiplexed_model_id,
                                           multiplexed)

_A4B = ("is not ported yet (ROADMAP A4b: the HTTP proxy on asyncio "
        "streams, ASGI and the RPC ingress)")


def start(*, http_port: int = 8000) -> int:
    """The HTTP proxy: not ported yet."""
    raise NotImplementedError(f"serve.start (the HTTP proxy) {_A4B}")


def start_rpc_ingress(port: int = 0) -> int:
    """The binary RPC ingress: not ported yet."""
    raise NotImplementedError(f"serve.start_rpc_ingress {_A4B}")


def ingress(asgi_app: Any):
    """ASGI ingress (a class decorator in the JAX package): not ported
    yet."""
    raise NotImplementedError(f"serve.ingress (ASGI) {_A4B}")


@dataclasses.dataclass
class AutoscalingConfig:
    """Analog of `ray.serve.config.AutoscalingConfig`."""

    min_replicas: int = 1
    max_replicas: int = 1
    target_ongoing_requests: float = 2.0
    # retire nodes fully vacated by an autoscaler scale-down via the
    # controller's node_drain RPC (immediate channel/pin/lease handoff,
    # no crash debounce). Opt-in: a drain takes the whole node, so this
    # is only safe when the autoscaled replica pool owns its nodes.
    drain_nodes: bool = False

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class Application:
    """A bound deployment graph node (reference: `Deployment.bind`
    `python/ray/serve/deployment.py:245`)."""

    def __init__(self, deployment: "Deployment", args: Tuple, kwargs: Dict):
        self.deployment = deployment
        self.args = args
        self.kwargs = kwargs


class Deployment:
    def __init__(self, func_or_class: Any, name: str,
                 num_replicas: int = 1,
                 max_ongoing_requests: int = 8,
                 ray_actor_options: Optional[Dict] = None,
                 autoscaling_config: Optional[Union[Dict,
                                                    AutoscalingConfig]] = None,
                 user_config: Any = None):
        self.func_or_class = func_or_class
        self.name = name
        self.num_replicas = num_replicas
        self.max_ongoing_requests = max_ongoing_requests
        self.ray_actor_options = ray_actor_options or {}
        if isinstance(autoscaling_config, AutoscalingConfig):
            autoscaling_config = autoscaling_config.to_dict()
        self.autoscaling_config = autoscaling_config
        self.user_config = user_config

    def bind(self, *args, **kwargs) -> Application:
        return Application(self, args, kwargs)

    def options(self, **overrides) -> "Deployment":
        fields = dict(
            func_or_class=self.func_or_class, name=self.name,
            num_replicas=self.num_replicas,
            max_ongoing_requests=self.max_ongoing_requests,
            ray_actor_options=dict(self.ray_actor_options),
            autoscaling_config=self.autoscaling_config,
            user_config=self.user_config)
        fields.update(overrides)
        return Deployment(**fields)

    def _spec(self, init_args: Tuple, init_kwargs: Dict) -> Dict[str, Any]:
        cls = self.func_or_class
        num = self.num_replicas
        if self.autoscaling_config:
            num = max(num, self.autoscaling_config.get("min_replicas", 1))
        return {
            "name": self.name,
            "num_replicas": num,
            "max_ongoing_requests": self.max_ongoing_requests,
            "ray_actor_options": self.ray_actor_options,
            "autoscaling_config": self.autoscaling_config,
            "user_config": self.user_config,
            "callable_factory": lambda: cls,
            "init_args": init_args,
            "init_kwargs": init_kwargs,
        }


def deployment(_func_or_class: Optional[Any] = None, *,
               name: Optional[str] = None,
               num_replicas: int = 1,
               max_ongoing_requests: int = 8,
               ray_actor_options: Optional[Dict] = None,
               autoscaling_config: Optional[Union[Dict,
                                                  AutoscalingConfig]] = None,
               user_config: Any = None):
    """`@serve.deployment` (reference `python/ray/serve/api.py`)."""

    def wrap(fc):
        return Deployment(fc, name or fc.__name__,
                          num_replicas=num_replicas,
                          max_ongoing_requests=max_ongoing_requests,
                          ray_actor_options=ray_actor_options,
                          autoscaling_config=autoscaling_config,
                          user_config=user_config)

    return wrap(_func_or_class) if _func_or_class is not None else wrap


# ----------------------------------------------------------------- control


def _get_or_create_controller():
    try:
        c = rt.get_actor(CONTROLLER_NAME)
        # the name registry may still hold a controller a previous
        # serve.shutdown killed: liveness-check before trusting it
        rt.get(c.get_routes.remote(), timeout=10)
        return c
    except Exception:
        # a detached named actor that asks for no card, so its worker
        # is spawned with CUDA_VISIBLE_DEVICES=""
        return rt.remote(ServeController).options(
            name=CONTROLLER_NAME, lifetime="detached", num_cpus=0.1,
            max_concurrency=256).remote()


def _collect_specs(app: Application, specs: Dict[str, Dict],
                   ) -> DeploymentHandle:
    """DFS the bind graph; nested Applications become DeploymentHandles."""
    dep = app.deployment

    def resolve(v):
        if isinstance(v, Application):
            return _collect_specs(v, specs)
        return v

    init_args = tuple(resolve(a) for a in app.args)
    init_kwargs = {k: resolve(v) for k, v in app.kwargs.items()}
    if dep.name not in specs:
        specs[dep.name] = dep._spec(init_args, init_kwargs)
    return DeploymentHandle(_current_app_name, dep.name)


_current_app_name = "default"


def run(app: Application, *, name: str = "default",
        route_prefix: Optional[str] = "/", _blocking: bool = True,
        timeout_s: float = 60.0) -> DeploymentHandle:
    """Deploy ``app`` and return its ingress handle; with ``_blocking``
    (the default) wait up to ``timeout_s`` for every deployment of the
    app to be RUNNING (a replica that loads a large model needs more
    than the default)."""
    global _current_app_name
    _current_app_name = name
    controller = _get_or_create_controller()
    specs: Dict[str, Dict] = {}
    ingress_handle = _collect_specs(app, specs)
    rt.get(controller.deploy_application.remote(
        name, list(specs.values()), route_prefix, app.deployment.name),
        timeout=timeout_s)
    if _blocking:
        deadline = time.monotonic() + timeout_s
        st: Dict[str, Any] = {}
        while time.monotonic() < deadline:
            st = rt.get(controller.status.remote(), timeout=timeout_s).get(
                name, {})
            if st and all(d["status"] == "RUNNING" for d in st.values()):
                break
            time.sleep(0.1)
        else:
            raise TimeoutError(f"application {name!r} not RUNNING: {st}")
    ingress_handle._controller = controller
    return ingress_handle


def get_app_handle(name: str = "default") -> DeploymentHandle:
    controller = rt.get_actor(CONTROLLER_NAME)
    routes = rt.get(controller.get_routes.remote())
    for target in routes.values():
        app_name, dep = target.split("/", 1)
        if app_name == name:
            return DeploymentHandle(app_name, dep, controller)
    raise ValueError(f"no application named {name!r}")


def get_deployment_handle(deployment_name: str,
                          app_name: str = "default") -> DeploymentHandle:
    controller = rt.get_actor(CONTROLLER_NAME)
    return DeploymentHandle(app_name, deployment_name, controller)


def status() -> Dict[str, Any]:
    controller = rt.get_actor(CONTROLLER_NAME)
    return rt.get(controller.status.remote())


def delete(name: str) -> None:
    controller = rt.get_actor(CONTROLLER_NAME)
    rt.get(controller.delete_application.remote(name))


def shutdown() -> None:
    try:
        controller = rt.get_actor(CONTROLLER_NAME)
    except Exception:
        return
    try:
        rt.get(controller.graceful_shutdown.remote())
    except Exception:
        pass
    try:
        rt.kill(controller)
    except Exception:
        pass


__all__ = [
    "Application", "AutoscalingConfig", "Deployment", "DeploymentHandle",
    "DeploymentResponse", "batch", "delete", "deployment",
    "get_app_handle", "get_deployment_handle", "get_multiplexed_model_id",
    "ingress", "multiplexed", "run", "shutdown", "start",
    "start_rpc_ingress", "status",
]

from ray_tpu_torch._private.usage import record_library_usage as _rlu

_rlu("serve")
del _rlu
