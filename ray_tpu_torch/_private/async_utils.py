"""Small asyncio bridges shared across the runtime."""

from __future__ import annotations

import asyncio
from typing import Any, Callable

END_OF_ITERATION = object()
"""Sentinel returned by :func:`step_off_loop` at iterator exhaustion —
StopIteration itself can neither escape a coroutine (PEP 479) nor be
raised into a Future."""


async def step_off_loop(step: Callable[[], Any], ctx=None) -> Any:
    """Run one step of a sync iterator in the default executor (so the
    event loop keeps serving) and return its value, or END_OF_ITERATION
    when the iterator is exhausted. ``ctx`` (a contextvars.Context) runs
    the step under the caller's request context when given."""

    def run():
        try:
            return ctx.run(step) if ctx is not None else step()
        except StopIteration:
            return END_OF_ITERATION

    return await asyncio.get_running_loop().run_in_executor(None, run)
