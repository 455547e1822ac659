"""Dynamic request batching.

Counterpart: ``ray_tpu/serve/batching.py``, copied (it is asyncio only).
Analog of `ray.serve.batching.batch` (`python/ray/serve/batching.py`):
decorate an async method taking a LIST of items; concurrent callers (the
replica runs requests concurrently on one asyncio loop) are coalesced
into batches of up to `max_batch_size`, flushed when full or after
`batch_wait_timeout_s`.

This is the GENERIC (request-level) batcher: one flush runs its whole
batch to completion before results resolve. The LLM replica rides it only
as the measured baseline (``scheduler="batch"``); its default path,
`serve/_private/continuous.py`, admits and retires sequences at
decode-iteration granularity.

Error semantics: if the batch fn raises, every waiter in that flush gets
the exception; if it returns normally, any `Exception` INSTANCE in the
output list is routed to just its own waiter (per-item error isolation:
one poisoned input does not fail its batchmates).
"""

from __future__ import annotations

import asyncio
import functools
from typing import Any, Callable, List, Optional


class _BatchQueue:
    def __init__(self, fn: Callable, max_batch_size: int, timeout_s: float):
        self._fn = fn
        self._max = max_batch_size
        self._timeout = timeout_s
        self._items: List[Any] = []
        self._futures: List[asyncio.Future] = []
        self._flush_task: Optional[asyncio.Task] = None
        self._self_obj = None

    async def submit(self, self_obj, item: Any) -> Any:
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self._self_obj = self_obj
        self._items.append(item)
        self._futures.append(fut)
        if len(self._items) >= self._max:
            self._flush_now()
        elif self._flush_task is None:
            self._flush_task = loop.create_task(self._flush_later())
        return await fut

    async def _flush_later(self):
        try:
            await asyncio.sleep(self._timeout)
        except asyncio.CancelledError:
            # a full-batch flush consumed our batch between scheduling and
            # expiry — nothing left to do
            return
        if self._flush_task is not asyncio.current_task():
            # stale timer: a full-batch flush raced our wakeup (its
            # cancel() landed after our sleep completed but before we ran)
            # and a NEW batch may already own a new timer — flushing here
            # would flush the new batch early, or double-flush
            return
        self._flush_now()

    def _flush_now(self):
        # clear the timer handle BEFORE flushing, so a submit() landing
        # while _run_batch is in flight arms a fresh timer for the next
        # batch instead of seeing a dead task
        task, self._flush_task = self._flush_task, None
        if task is not None and task is not asyncio.current_task():
            task.cancel()
        items, futures = self._items, self._futures
        self._items, self._futures = [], []
        if not items:
            return
        asyncio.ensure_future(self._run_batch(items, futures))

    async def _run_batch(self, items, futures):
        try:
            if self._self_obj is not None:
                outs = await self._fn(self._self_obj, items)
            else:
                outs = await self._fn(items)
            if outs is None or len(outs) != len(items):
                raise ValueError(
                    f"batch fn returned "
                    f"{'None' if outs is None else len(outs)} results for "
                    f"{len(items)} inputs")
            for f, o in zip(futures, outs):
                if f.done():
                    continue
                if isinstance(o, Exception):
                    # per-item failure: only this waiter sees it
                    f.set_exception(o)
                else:
                    f.set_result(o)
        except BaseException as e:
            for f in futures:
                if not f.done():
                    f.set_exception(e)


def batch(_fn: Optional[Callable] = None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    def decorator(fn: Callable):
        if not asyncio.iscoroutinefunction(fn):
            raise TypeError("@serve.batch requires an async function")
        queue_attr = f"__serve_batch_queue_{fn.__name__}"

        @functools.wraps(fn)
        async def wrapper(*args):
            if len(args) == 2:  # bound method: (self, item)
                self_obj, item = args
                q = getattr(self_obj, queue_attr, None)
                if q is None:
                    # instances may override the decorator defaults
                    # (e.g. a model replica configured at deploy time)
                    size = getattr(
                        self_obj, "__serve_batch_size_" + fn.__name__,
                        max_batch_size)
                    timeout = getattr(
                        self_obj, "__serve_batch_timeout_" + fn.__name__,
                        batch_wait_timeout_s)
                    q = _BatchQueue(fn, size, timeout)
                    setattr(self_obj, queue_attr, q)
                return await q.submit(self_obj, item)
            (item,) = args
            q = wrapper.__dict__.setdefault(
                "_queue", _BatchQueue(fn, max_batch_size,
                                      batch_wait_timeout_s))
            return await q.submit(None, item)

        return wrapper

    return decorator(_fn) if _fn is not None else decorator
