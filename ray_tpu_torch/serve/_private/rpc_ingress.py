"""Binary RPC ingress: the second (non-HTTP) ingress protocol.

Counterpart: ``ray_tpu/serve/_private/rpc_ingress.py``. Role-parity with
the reference's gRPC ingress (`python/ray/serve/grpc_util.py` + proxy gRPC
service): a length-prefixed binary protocol for low-overhead programmatic
clients, speaking the framework's native RPC
framing (`_private/rpc.py`) instead of gRPC: the control plane's stance
(no proto toolchain, no grpcio) applied to the ingress. The C++ client in
``cpp/serve_client/`` speaks this protocol. The module imports the
runtime only, never torch.

Server: an actor that routes `invoke` frames to applications by name and
streams chunked responses for generator endpoints.

Client:
    from ray_tpu_torch.serve.rpc_ingress_client import ServeRpcClient
    c = ServeRpcClient("host:port")
    c.invoke("default", {"prompt": "hi"})        # -> result
    for tok in c.invoke_stream("llm", {...}):    # -> chunks
        ...
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Dict

import ray_tpu_torch as rt

logger = logging.getLogger(__name__)


class RpcIngressActor:
    """Async actor hosting an RpcServer; `invoke` routes to app handles
    through the same pow-2 router as every other caller."""

    STREAM_IDLE_TTL_S = 60.0

    def __init__(self, controller, port: int = 0):
        self._controller = controller
        self._port = port
        self._server = None
        self._handles: Dict[str, Any] = {}
        # ingress stream key (uuid) -> (replica_handle, replica_sid,
        # last_pull_ts): replica sids are per-replica counters and collide
        # across replicas, so the ingress mints its own ids
        self._streams: Dict[str, list] = {}
        self._started = asyncio.Event()
        self._janitor = None

    async def ready(self) -> int:
        if self._server is None:
            from ray_tpu_torch._private.rpc import RpcServer

            self._server = RpcServer(host="0.0.0.0", port=self._port)
            self._server.register("invoke", self._invoke)
            self._server.register("stream_next", self._stream_next)
            addr = await self._server.start()
            self._port = addr[1]
            self._janitor = asyncio.ensure_future(self._janitor_loop())
            self._started.set()
            logger.info("serve rpc ingress on :%d", self._port)
        else:
            await self._started.wait()
        return self._port

    async def _janitor_loop(self):
        """Reap abandoned streams (the replica reaps its side after its
        own idle TTL; the ingress must not leak its mapping) and drop
        cached app handles whose route target changed (redeploys)."""
        import time

        while True:
            await asyncio.sleep(5.0)
            now = time.monotonic()
            for key, rec in list(self._streams.items()):
                if now - rec[2] > self.STREAM_IDLE_TTL_S:
                    self._streams.pop(key, None)
            try:
                routes = await self._controller.get_routes.remote()
            except Exception:
                continue
            targets = {}
            for dest in routes.values():
                app_name, dep = dest.split("/", 1)
                targets[app_name] = dep
            for app, h in list(self._handles.items()):
                if targets.get(app) != h._deployment:
                    self._handles.pop(app, None)
                    # retire the evicted handle's router, or its long-poll
                    # thread keeps polling the dead deployment forever
                    if h._router is not None:
                        try:
                            h._router.stop()
                        except Exception:
                            pass

    async def _handle_for(self, app: str):
        h = self._handles.get(app)
        if h is None:
            routes = await self._controller.get_routes.remote()
            target = None
            for dest in routes.values():
                app_name, dep = dest.split("/", 1)
                if app_name == app:
                    target = (app_name, dep)
                    break
            if target is None:
                raise ValueError(f"no application named {app!r}")
            from ray_tpu_torch.serve.handle import DeploymentHandle

            h = DeploymentHandle(target[0], target[1], self._controller)
            self._handles[app] = h
        return h

    async def _invoke(self, body: Dict[str, Any]):
        import time
        import uuid

        from ray_tpu_torch.serve.handle import STREAM_MARKER

        h = await self._handle_for(body["app"])
        if body.get("multiplexed_model_id"):
            h = h.options(
                multiplexed_model_id=body["multiplexed_model_id"])
        method = body.get("method") or "__call__"
        # an explicit empty args list means a zero-arg call, not f(None)
        args = (body["args"] if body.get("args") is not None
                else [body.get("payload")])
        # router does blocking controller lookups: keep them off this loop
        resp = await asyncio.to_thread(
            lambda: h._call(method, tuple(args), body.get("kwargs") or {}))
        out = await resp
        if isinstance(out, dict) and STREAM_MARKER in out:
            # ingress-unique key: replica sids are per-replica counters
            key = uuid.uuid4().hex[:16]
            self._streams[key] = [resp._replica, out[STREAM_MARKER],
                                  time.monotonic()]
            return {"stream": key}
        return {"result": out}

    async def _stream_next(self, body: Dict[str, Any]):
        import time

        rec = self._streams.get(body["stream"])
        if rec is None:
            return {"items": [], "done": True}
        replica, sid, _ = rec
        rec[2] = time.monotonic()
        chunk = await replica.stream_next.remote(sid)
        if chunk.get("done"):
            self._streams.pop(body["stream"], None)
        return chunk


def start_rpc_ingress(port: int = 0) -> int:
    """Start (or find) the cluster's RPC ingress; returns the bound port.
    ≈ `serve.start(grpc_options=...)` in the reference."""
    from ray_tpu_torch.serve import (RPC_INGRESS_NAME,
                                     _get_or_create_controller)

    controller = _get_or_create_controller()
    try:
        actor = rt.get_actor(RPC_INGRESS_NAME)
    except Exception:
        actor = rt.remote(RpcIngressActor).options(
            name=RPC_INGRESS_NAME, lifetime="detached", num_cpus=0.1,
            max_concurrency=256).remote(controller, port)
    return rt.get(actor.ready.remote())
