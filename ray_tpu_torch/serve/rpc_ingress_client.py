"""Synchronous client for the serve RPC ingress (no cluster membership,
no HTTP stack: just the framework's length-prefixed frames).

Counterpart: ``ray_tpu/serve/rpc_ingress_client.py``. ≈ the generated gRPC
stub of the reference's gRPC ingress; see
`_private/rpc_ingress.py` for the server."""

from __future__ import annotations

import asyncio
import threading
from typing import Any, Dict, Iterator, Optional


class ServeRpcClient:
    def __init__(self, address: str, request_timeout_s: float = 120.0):
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._loop.run_forever,
                                        name="serve-rpc-client", daemon=True)
        self._thread.start()

        async def mk():
            from ray_tpu_torch._private.rpc import RpcClient

            return RpcClient(address, request_timeout_s=request_timeout_s)

        self._client = self._call_async(mk())

    def _call_async(self, coro, timeout=None):
        return asyncio.run_coroutine_threadsafe(
            coro, self._loop).result(timeout)

    def invoke(self, app: str, payload: Any = None, *,
               method: Optional[str] = None,
               multiplexed_model_id: str = "",
               args: Optional[list] = None,
               kwargs: Optional[Dict[str, Any]] = None) -> Any:
        reply = self._call_async(self._client.call("invoke", {
            "app": app, "payload": payload, "method": method,
            "multiplexed_model_id": multiplexed_model_id,
            "args": args, "kwargs": kwargs,
        }))
        if "stream" in reply:
            raise ValueError(
                "endpoint streams; use invoke_stream() instead")
        return reply["result"]

    def invoke_stream(self, app: str, payload: Any = None, **kw
                      ) -> Iterator[Any]:
        reply = self._call_async(self._client.call("invoke", {
            "app": app, "payload": payload,
            "method": kw.get("method"),
            "multiplexed_model_id": kw.get("multiplexed_model_id", ""),
            "args": kw.get("args"), "kwargs": kw.get("kwargs"),
        }))
        if "stream" not in reply:
            yield reply["result"]
            return
        sid = reply["stream"]
        while True:
            chunk = self._call_async(
                self._client.call("stream_next", {"stream": sid}))
            for item in chunk.get("items", ()):
                yield item
            if chunk.get("error"):
                raise RuntimeError(chunk["error"])
            if chunk.get("done"):
                return

    def close(self) -> None:
        try:
            self._call_async(self._client.close())
        except Exception:
            pass
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=2)
