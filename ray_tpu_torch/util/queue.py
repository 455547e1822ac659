"""Distributed FIFO queue backed by an actor.

Analog of `ray.util.queue.Queue` (`python/ray/util/queue.py`): an async
actor owns an `asyncio.Queue`; any process holding the handle can
put/get with optional blocking + timeout. Empty/Full mirror the
reference's exception surface (aliases of the stdlib queue exceptions).
"""

from __future__ import annotations

import asyncio
from queue import Empty, Full  # re-exported, reference-compatible
from typing import Any, List, Optional

import ray_tpu_torch as rt

__all__ = ["Queue", "Empty", "Full"]


class _QueueActor:
    def __init__(self, maxsize: int = 0):
        self._q: asyncio.Queue = asyncio.Queue(maxsize=maxsize)
        self._maxsize = maxsize

    async def put(self, item: Any, timeout: Optional[float] = None) -> bool:
        if timeout is None:
            await self._q.put(item)
            return True
        try:
            await asyncio.wait_for(self._q.put(item), timeout)
            return True
        except asyncio.TimeoutError:
            return False

    async def put_nowait(self, item: Any) -> bool:
        try:
            self._q.put_nowait(item)
            return True
        except asyncio.QueueFull:
            return False

    async def put_nowait_batch(self, items: List[Any]) -> int:
        n = 0
        for it in items:
            try:
                self._q.put_nowait(it)
                n += 1
            except asyncio.QueueFull:
                break
        return n

    async def get(self, timeout: Optional[float] = None):
        if timeout is None:
            return (True, await self._q.get())
        try:
            return (True, await asyncio.wait_for(self._q.get(), timeout))
        except asyncio.TimeoutError:
            return (False, None)

    async def get_nowait(self):
        try:
            return (True, self._q.get_nowait())
        except asyncio.QueueEmpty:
            return (False, None)

    async def get_nowait_batch(self, max_items: int) -> List[Any]:
        out = []
        while len(out) < max_items:
            try:
                out.append(self._q.get_nowait())
            except asyncio.QueueEmpty:
                break
        return out

    async def qsize(self) -> int:
        return self._q.qsize()

    async def empty(self) -> bool:
        return self._q.empty()

    async def full(self) -> bool:
        return self._q.full()


class Queue:
    """Sync client facade; safe to pass between tasks/actors (pickles to
    the underlying actor handle)."""

    def __init__(self, maxsize: int = 0, *, actor_options: Optional[dict]
                 = None, _actor=None):
        if _actor is not None:
            self._actor = _actor
            return
        opts = dict(actor_options or {})
        opts.setdefault("num_cpus", 0.1)
        # a parked blocking get() must not hold the actor's only execution
        # slot — puts have to interleave to wake it
        opts.setdefault("max_concurrency", 1000)
        self._actor = rt.remote(_QueueActor).options(**opts).remote(
            maxsize)

    def put(self, item: Any, block: bool = True,
            timeout: Optional[float] = None) -> None:
        if not block:
            if not rt.get(self._actor.put_nowait.remote(item)):
                raise Full
            return
        ok = rt.get(self._actor.put.remote(item, timeout))
        if not ok:
            raise Full

    def put_nowait(self, item: Any) -> None:
        self.put(item, block=False)

    def put_nowait_batch(self, items: List[Any]) -> int:
        return rt.get(self._actor.put_nowait_batch.remote(list(items)))

    def get(self, block: bool = True, timeout: Optional[float] = None):
        if not block:
            ok, item = rt.get(self._actor.get_nowait.remote())
            if not ok:
                raise Empty
            return item
        ok, item = rt.get(self._actor.get.remote(timeout))
        if not ok:
            raise Empty
        return item

    def get_nowait(self):
        return self.get(block=False)

    def get_nowait_batch(self, max_items: int) -> List[Any]:
        return rt.get(
            self._actor.get_nowait_batch.remote(int(max_items)))

    def qsize(self) -> int:
        return rt.get(self._actor.qsize.remote())

    def size(self) -> int:
        return self.qsize()

    def empty(self) -> bool:
        return rt.get(self._actor.empty.remote())

    def full(self) -> bool:
        return rt.get(self._actor.full.remote())

    def shutdown(self) -> None:
        try:
            rt.kill(self._actor)
        except Exception:
            pass

    @classmethod
    def _from_actor(cls, actor) -> "Queue":
        return cls(_actor=actor)

    def __reduce__(self):
        # pickling must NOT create a fresh queue actor — rebind the handle
        return (Queue._from_actor, (self._actor,))
