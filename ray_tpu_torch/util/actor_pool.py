"""ActorPool — fan work over a fixed set of actors.

Analog of `ray.util.ActorPool` (`python/ray/util/actor_pool.py`): submit
tasks to whichever pooled actor is free, collect results in submission
order (`map`/`get_next`) or completion order (`map_unordered`/
`get_next_unordered`); actors can be added (`push`) or checked out
(`pop_idle`) while work is in flight.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, List, Optional

import ray_tpu_torch as rt


class ActorPool:
    def __init__(self, actors: Iterable[Any]):
        self._idle: List[Any] = list(actors)
        # a future's actor is tracked only while in flight (recycled as
        # soon as the task completes); its index mapping lives until the
        # caller consumes the result
        self._inflight_actor = {}
        self._future_to_index = {}
        self._index_to_future = {}
        self._next_task_index = 0

    # ------------------------------------------------------------------ map

    def map(self, fn: Callable[[Any, Any], Any], values: Iterable[Any]
            ) -> Iterator[Any]:
        """Results in submission order. `fn(actor, value)` must return an
        ObjectRef (e.g. `lambda a, v: a.work.remote(v)`)."""
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable[[Any, Any], Any],
                      values: Iterable[Any]) -> Iterator[Any]:
        """Results in completion order."""
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    # --------------------------------------------------------------- submit

    def submit(self, fn: Callable[[Any, Any], Any], value: Any) -> None:
        """Run fn(actor, value) on a free actor (blocks for one to free up
        when the pool is saturated)."""
        if not self._idle:
            # recycle the earliest-completed in-flight task's actor
            ready, _ = rt.wait(list(self._inflight_actor),
                                    num_returns=1)
            self._return_actor(ready[0])
        actor = self._idle.pop()
        future = fn(actor, value)
        self._inflight_actor[future] = actor
        self._future_to_index[future] = self._next_task_index
        self._index_to_future[self._next_task_index] = future
        self._next_task_index += 1

    def _return_actor(self, future) -> None:
        actor = self._inflight_actor.pop(future, None)
        if actor is not None:
            self._idle.append(actor)

    def has_next(self) -> bool:
        return bool(self._index_to_future)

    def get_next(self, timeout: Optional[float] = None) -> Any:
        """Next result in SUBMISSION order.

        On timeout raises TimeoutError WITHOUT consuming the task: the
        cursor and mappings are only advanced once the result is ready, so
        the caller can retry and the result is never dropped. The next
        result is the earliest submitted one still held, so results that
        ``get_next_unordered`` already took are skipped.
        """
        if not self.has_next():
            raise StopIteration("no more results")
        idx = min(self._index_to_future)
        future = self._index_to_future[idx]
        ready, _ = rt.wait([future], num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError(f"result {idx} not ready within {timeout}s")
        self._index_to_future.pop(idx)
        self._future_to_index.pop(future, None)
        self._return_actor(future)
        return rt.get(future)

    def get_next_unordered(self, timeout: Optional[float] = None) -> Any:
        """Next result in COMPLETION order."""
        if not self.has_next():
            raise StopIteration("no more results")
        ready, _ = rt.wait(list(self._index_to_future.values()),
                                num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("no result within timeout")
        future = ready[0]
        idx = self._future_to_index.pop(future)
        self._index_to_future.pop(idx)
        self._return_actor(future)
        return rt.get(future)

    # ------------------------------------------------------------ membership

    def push(self, actor: Any) -> None:
        """Add an idle actor to the pool."""
        self._idle.append(actor)

    def pop_idle(self) -> Optional[Any]:
        """Remove and return an idle actor (None if all are busy)."""
        return self._idle.pop() if self._idle else None

    def has_free(self) -> bool:
        return bool(self._idle)
