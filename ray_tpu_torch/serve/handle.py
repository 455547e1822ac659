"""DeploymentHandle: composable client to a deployment.

Counterpart: ``ray_tpu/serve/handle.py``. Analog of
`ray.serve.handle.DeploymentHandle`: `handle.remote(...)` returns a
`DeploymentResponse` (resolve with `.result()`, await it, or pass the
underlying ref onward). Method access (`handle.other.remote()`) routes to
that method of the callable. A deployment method that returns
a (sync or async) generator streams: iterate the response
(`for chunk in handle.remote(...)`) to pull chunks as they are produced
(≈ handle.options(stream=True) in the reference).
"""

from __future__ import annotations

from typing import Any, Iterator, Optional

import ray_tpu_torch as rt
from ray_tpu_torch.serve._private.router import Router

STREAM_MARKER = "__serve_stream__"


class DeploymentResponse:
    def __init__(self, ref, replica=None):
        self._ref = ref
        self._replica = replica

    def result(self, timeout: Optional[float] = None) -> Any:
        if isinstance(self._ref, rt.ObjectRefGenerator):
            raise TypeError(
                "streaming response (handle.options(stream=True)): iterate "
                "it instead of calling .result()")
        return rt.get(self._ref, timeout=timeout)

    def __await__(self):
        if isinstance(self._ref, rt.ObjectRefGenerator):
            raise TypeError(
                "streaming response (handle.options(stream=True)): use "
                "'async for' instead of awaiting it")
        return self._ref.__await__()

    def __aiter__(self):
        """Async streaming: async-for over chunks (each awaited get)."""
        async def agen():
            if isinstance(self._ref, rt.ObjectRefGenerator):
                async for chunk_ref in self._ref:
                    yield await chunk_ref
                return
            out = await self._ref
            if isinstance(out, dict) and STREAM_MARKER in out:
                raise TypeError("chunk-pull streams are sync-iterate only; "
                                "use handle.options(stream=True) for async")
            yield out

        return agen()

    @property
    def ref(self):
        return self._ref

    def __iter__(self) -> Iterator[Any]:
        """Stream the response. Non-streaming results yield once."""
        if isinstance(self._ref, rt.ObjectRefGenerator):
            # native generator transport (handle.options(stream=True)):
            # chunks are owner-owned refs arriving as produced
            for chunk_ref in self._ref:
                yield rt.get(chunk_ref)
            return
        out = self.result()
        if not (isinstance(out, dict) and STREAM_MARKER in out):
            yield out
            return
        if self._replica is None:
            raise RuntimeError("streaming response without replica binding")
        sid = out[STREAM_MARKER]
        while True:
            chunk = rt.get(self._replica.stream_next.remote(sid))
            for item in chunk["items"]:
                yield item
            if chunk.get("error"):
                raise RuntimeError(f"stream failed: {chunk['error']}")
            if chunk["done"]:
                return


class _BoundMethod:
    def __init__(self, handle: "DeploymentHandle", method_name: str):
        self._handle = handle
        self._method = method_name

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        return self._handle._call(self._method, args, kwargs)


class DeploymentHandle:
    def __init__(self, app_name: str, deployment_name: str,
                 controller=None, multiplexed_model_id: str = "",
                 stream: bool = False):
        self._app = app_name
        self._deployment = deployment_name
        self._controller = controller
        self._router: Optional[Router] = None
        self._mux_id = multiplexed_model_id
        self._stream = stream

    def options(self, *, multiplexed_model_id: Optional[str] = None,
                stream: Optional[bool] = None) -> "DeploymentHandle":
        """≈ `serve.handle.DeploymentHandle.options`: a copy of this handle
        whose requests carry (and route by) the multiplexed model id
        and/or stream via the native generator transport (stream=True,
        ≈ the reference's handle.options(stream=True)). Unspecified
        options keep their current values, so chained .options() calls
        compose."""
        h = DeploymentHandle(
            self._app, self._deployment, self._controller,
            multiplexed_model_id=(self._mux_id if multiplexed_model_id
                                  is None else multiplexed_model_id),
            stream=self._stream if stream is None else stream)
        # share ONE router (and its replica view + affinity state) across
        # all options() copies — materialize it now so per-request
        # h.options(...) calls don't each build a router + poll threads
        h._router = self._get_router()
        return h

    def _get_router(self) -> Router:
        if self._router is None:
            controller = self._controller
            if controller is None:
                from ray_tpu_torch.serve._private.controller import \
                    CONTROLLER_NAME

                controller = rt.get_actor(CONTROLLER_NAME)
                self._controller = controller
            self._router = Router(controller, self._app, self._deployment)
        return self._router

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        return self._call("__call__", args, kwargs)

    def _call(self, method: str, args, kwargs) -> DeploymentResponse:
        # resolve nested responses so chained models compose
        args = tuple(a._ref if isinstance(a, DeploymentResponse) else a
                     for a in args)
        kwargs = {k: (v._ref if isinstance(v, DeploymentResponse) else v)
                  for k, v in kwargs.items()}
        if self._mux_id:
            kwargs = dict(kwargs, __serve_mux_id=self._mux_id)
        ref, replica = self._get_router().assign_request_with_replica(
            method, args, kwargs, multiplexed_model_id=self._mux_id,
            streaming=self._stream)
        return DeploymentResponse(ref, replica=replica)

    def __getattr__(self, name: str) -> _BoundMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        return _BoundMethod(self, name)

    def __reduce__(self):
        return (DeploymentHandle,
                (self._app, self._deployment, None, self._mux_id,
                 self._stream))
