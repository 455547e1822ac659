"""Replica actor: hosts one copy of the user's deployment callable.

Counterpart: ``ray_tpu/serve/_private/replica.py``. Analog of
`ray.serve._private.replica.Replica` (`python/ray/serve/_private/
replica.py`): an async actor (max_concurrency = max_ongoing_requests) that
tracks in-flight counts for autoscaling and health. On a GPU replica
(``ray_actor_options={"num_gpus": 1}``) the callable owns the card and the
decode loop; concurrency > 1 lets the continuous scheduler (or
``serve.batch``) gather requests.

Blocking work stays off the actor's event loop, so health checks, stats
and stream pulls keep flowing while a request computes: a sync callable
runs through ``run_in_executor``, a sync generator is pumped on a thread,
and ``export_prefix`` waits off the loop.
"""

from __future__ import annotations

import asyncio
import inspect
import sys
import time
from typing import Any, Dict, Optional


class _Stream:
    """One in-flight streaming response: the source generator, the chunk
    buffer, and consumer-liveness bookkeeping."""

    __slots__ = ("gen", "queue", "last_pull", "cancelled")

    def __init__(self, gen):
        self.gen = gen
        self.queue: asyncio.Queue = asyncio.Queue()
        self.last_pull = time.monotonic()
        self.cancelled = False

    async def close(self) -> None:
        """Stop the pump and release the generator."""
        self.cancelled = True
        try:
            if inspect.isasyncgen(self.gen):
                await self.gen.aclose()
            else:
                self.gen.close()
        except Exception:
            # a sync generator mid-__next__ on the pump thread raises
            # "generator already executing"; the cancelled flag stops the
            # pump at its next item instead
            pass


class ReplicaActor:
    def __init__(self, app_name: str, deployment_name: str,
                 callable_factory, init_args, init_kwargs):
        self._app = app_name
        self._deployment = deployment_name
        user = callable_factory()
        if inspect.isclass(user):
            self._callable = user(*init_args, **(init_kwargs or {}))
            self._is_function = False
        else:
            self._callable = user
            self._is_function = True
        self._ongoing = 0
        self._total = 0
        self._started = time.time()
        # streaming responses: stream_id -> _Stream
        self._streams: Dict[int, "_Stream"] = {}
        self._next_stream_id = 0
        self._stream_idle_ttl_s = 60.0
        self._stream_reaper_task = None

    def multiplex_info(self) -> Dict[str, Any]:
        """Model ids this replica has loaded (router affinity source)."""
        from ray_tpu_torch.serve.multiplex import loaded_model_ids

        return {"model_ids": loaded_model_ids(self._callable)}

    async def handle_request(self, method_name: str, args, kwargs) -> Any:
        from ray_tpu_torch.serve.multiplex import _set_request_model_id

        mux_token = None
        if kwargs and "__serve_mux_id" in kwargs:
            mux_token = _set_request_model_id(kwargs.pop("__serve_mux_id"))
        self._ongoing += 1
        self._total += 1
        try:
            if self._is_function:
                fn = self._callable
            else:
                fn = getattr(self._callable, method_name or "__call__")
            if inspect.iscoroutinefunction(fn):
                out = fn(*args, **(kwargs or {}))
            else:
                # sync callables (decode steps, blocking compute)
                # must not stall the actor loop — health checks and
                # concurrent requests ride the same loop. copy_context so
                # get_multiplexed_model_id() works off-loop too.
                import contextvars as _cv

                ctx = _cv.copy_context()
                out = await asyncio.get_running_loop().run_in_executor(
                    None, lambda: ctx.run(fn, *args, **(kwargs or {})))
            if inspect.isawaitable(out):
                out = await out
            if inspect.isgenerator(out) or inspect.isasyncgen(out):
                # streaming response: drain the generator into a queue the
                # caller pulls with stream_next (the chunk-pull transport
                # standing in for the reference's gRPC/ASGI streaming,
                # proxy.py:424)
                sid = self._next_stream_id
                self._next_stream_id += 1
                stream = _Stream(out)
                self._streams[sid] = stream
                asyncio.ensure_future(self._drain_stream(stream))
                if self._stream_reaper_task is None:
                    self._stream_reaper_task = asyncio.ensure_future(
                        self._stream_reaper())
                return {"__serve_stream__": sid}
            return out
        finally:
            self._ongoing -= 1
            if mux_token is not None:
                from ray_tpu_torch.serve.multiplex import _request_model_id

                _request_model_id.reset(mux_token)

    async def handle_request_streaming(self, method_name: str, args, kwargs):
        """Streaming entry: an async generator the handle invokes with
        ``num_returns="streaming"`` — each yielded chunk becomes an
        owner-owned object the instant it is produced (native generator
        transport; ≈ the reference's handle.options(stream=True) riding
        ObjectRefGenerator instead of the chunk-pull `stream_next` path
        below, which remains for un-optioned callers)."""
        from ray_tpu_torch.serve.multiplex import _set_request_model_id

        mux_token = None
        if kwargs and "__serve_mux_id" in kwargs:
            mux_token = _set_request_model_id(kwargs.pop("__serve_mux_id"))
        self._ongoing += 1
        self._total += 1
        try:
            if self._is_function:
                fn = self._callable
            else:
                fn = getattr(self._callable, method_name or "__call__")
            out = fn(*args, **(kwargs or {}))
            if inspect.isawaitable(out):
                out = await out
            if inspect.isasyncgen(out):
                async for item in out:
                    yield item
            elif inspect.isgenerator(out):
                # sync generator (e.g. a decode step per token):
                # step it off-loop so health checks keep flowing, under
                # the request's contextvars (multiplexed model id)
                import contextvars as _cv

                from ray_tpu_torch._private.async_utils import (
                    END_OF_ITERATION, step_off_loop)

                ctx = _cv.copy_context()
                while True:
                    item = await step_off_loop(lambda: next(out), ctx)
                    if item is END_OF_ITERATION:
                        break
                    yield item
            else:
                yield out  # non-streaming callable: single-chunk stream
        finally:
            self._ongoing -= 1
            if mux_token is not None:
                from ray_tpu_torch.serve.multiplex import _request_model_id

                _request_model_id.reset(mux_token)

    async def _stream_reaper(self) -> None:
        """Abandoned streams (consumer gone mid-iteration) must not pump
        the generator, hold buffered chunks, or count as ongoing work for
        the replica's lifetime — reap proactively, not only on the next
        request."""
        while True:
            await asyncio.sleep(5.0)
            now = time.monotonic()
            for sid, stream in list(self._streams.items()):
                if now - stream.last_pull > self._stream_idle_ttl_s:
                    self._streams.pop(sid, None)
                    await stream.close()

    def _active_streams(self, window_s: float = 15.0) -> int:
        now = time.monotonic()
        return sum(1 for s in self._streams.values()
                   if now - s.last_pull < window_s)

    async def _drain_stream(self, stream: "_Stream") -> None:
        gen, q = stream.gen, stream.queue
        try:
            if inspect.isasyncgen(gen):
                async for item in gen:
                    await q.put(("item", item))
                    if stream.cancelled:
                        return
            else:
                # a sync generator's body (e.g. a decode step per
                # token) must not block the actor loop: pump on a thread —
                # under the request's contextvars so the generator body
                # still sees get_multiplexed_model_id()
                import contextvars as _cv

                loop = asyncio.get_running_loop()
                ctx = _cv.copy_context()

                def pump():
                    def run():
                        for item in gen:
                            if stream.cancelled:
                                return
                            loop.call_soon_threadsafe(
                                q.put_nowait, ("item", item))

                    ctx.run(run)

                await loop.run_in_executor(None, pump)
            await q.put(("end", None))
        except Exception as e:  # noqa: BLE001 — crosses to the consumer
            await q.put(("error", f"{type(e).__name__}: {e}"))

    async def stream_next(self, stream_id: int, max_items: int = 256,
                          timeout_s: float = 10.0) -> Dict[str, Any]:
        """Pull the next buffered chunk(s) of a streaming response.
        Returns {items, done, error?}; an unknown id is a finished stream."""
        stream = self._streams.get(stream_id)
        if stream is None:
            return {"items": [], "done": True}
        q = stream.queue
        stream.last_pull = time.monotonic()
        items: list = []
        done = False
        error = None
        try:
            kind, item = await asyncio.wait_for(q.get(), timeout=timeout_s)
        except asyncio.TimeoutError:
            return {"items": [], "done": False}
        while True:
            if kind == "end":
                done = True
                break
            if kind == "error":
                done = True
                error = item
                break
            items.append(item)
            if len(items) >= max_items or q.empty():
                break
            kind, item = q.get_nowait()
        if done:
            self._streams.pop(stream_id, None)
        out: Dict[str, Any] = {"items": items, "done": done}
        if error is not None:
            out["error"] = error
        return out

    async def reconfigure(self, user_config: Any) -> None:
        if hasattr(self._callable, "reconfigure"):
            out = self._callable.reconfigure(user_config)
            if inspect.isawaitable(out):
                await out

    def _queue_depth(self) -> float:
        """Backlog the callable is holding beyond in-flight requests —
        the `ray_tpu_serve_queue_depth` signal. A callable exposes it via
        a `queue_depth()` method (the LLM server's continuous scheduler
        does); otherwise fall back to this process's gauge so any
        scheduler that sets the metric is covered."""
        probe = getattr(self._callable, "queue_depth", None)
        if callable(probe):
            try:
                return float(probe())
            except Exception:
                return 0.0
        # the gauge exists only where the scheduler's module was loaded;
        # importing it here would pull torch into a plain deployment
        mod = sys.modules.get("ray_tpu_torch.serve._private.continuous")
        if mod is None:
            return 0.0
        try:
            return float(mod._m_queue_depth.value())
        except Exception:
            return 0.0

    def _prefix_digest(self) -> Dict[str, Any]:
        """Prefix-affinity digest, relayed through stats so the
        controller's EXISTING poll carries it: replicas never originate a
        control-plane RPC for affinity."""
        probe = getattr(self._callable, "prefix_digest", None)
        if callable(probe):
            try:
                return probe() or {}
            except Exception:
                return {}
        return {}

    async def export_prefix(self, tokens, timeout_s: float = 30.0):
        """Migration pull entry (peer replica → this replica). The
        callable's scheduler does the radix match + gather on its own
        thread; run the blocking wait off the actor loop so health checks
        and requests keep flowing during a large export."""
        probe = getattr(self._callable, "export_prefix", None)
        if not callable(probe):
            return {"matched_len": 0, "page_tokens": 0, "k": [], "v": []}
        return await asyncio.get_running_loop().run_in_executor(
            None, lambda: probe(tokens, timeout_s=timeout_s))

    async def stats(self) -> Dict[str, Any]:
        # actively-consumed streams count as ongoing work for autoscaling;
        # abandoned ones must not pin the replica at scale. queue_depth
        # reports work ADMITTED but not yet scheduled (the continuous
        # batcher's pending queue) — in-flight counts alone undercount a
        # backlogged replica, which is exactly when scaling matters.
        return {"ongoing": self._ongoing + self._active_streams(),
                "queue_depth": self._queue_depth(),
                "total": self._total,
                "uptime_s": time.time() - self._started,
                "prefix_digest": self._prefix_digest()}

    async def check_health(self) -> bool:
        if hasattr(self._callable, "check_health"):
            out = self._callable.check_health()
            if inspect.isawaitable(out):
                out = await out
            return bool(out) if out is not None else True
        return True

    async def prepare_for_shutdown(self) -> None:
        # drain: wait for in-flight requests AND actively-consumed streams
        # (abandoned streams must not burn the drain window). The window
        # must exceed stream_next's 10s server-side pull wait — a consumer
        # blocked in a pull is active even though last_pull is aging.
        deadline = time.monotonic() + 10
        while ((self._ongoing > 0 or self._active_streams(window_s=15.0))
               and time.monotonic() < deadline):
            await asyncio.sleep(0.02)
