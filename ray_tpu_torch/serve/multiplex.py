"""Model multiplexing — many models per deployment, LRU-cached per replica.

Analog of `python/ray/serve/multiplex.py` (`@serve.multiplexed`) +
`_ModelMultiplexWrapper`: a decorated `load_model(self, model_id)` becomes
an LRU cache of live models; requests carry `multiplexed_model_id` (set via
`handle.options(multiplexed_model_id=...)`), the router prefers replicas
that already hold the model (falling back to pow-2 on misses), and
`serve.get_multiplexed_model_id()` exposes the id inside the request.

Divergence from the reference: model locations reach the router by a
lightweight poll of replica `multiplex_info` (only while multiplexed
requests flow) instead of the controller long-poll channel — same
preference semantics, one less controller hop.
"""

from __future__ import annotations

import asyncio
import contextvars
import functools
import inspect
from collections import OrderedDict
from typing import Any, Callable, Optional

_request_model_id: contextvars.ContextVar[str] = contextvars.ContextVar(
    "serve_multiplexed_model_id", default="")

#: attribute on the user callable instance holding the LRU cache — the
#: replica reads it to report loaded model ids
MUX_ATTR = "__serve_mux_models__"


def get_multiplexed_model_id() -> str:
    """Inside a request: the model id this request was routed with
    (≈ `serve.get_multiplexed_model_id`)."""
    return _request_model_id.get()


def _set_request_model_id(model_id: Optional[str]):
    if model_id:
        return _request_model_id.set(model_id)
    return None


def multiplexed(max_num_models_per_replica: int = 3) -> Callable:
    """Decorator for an async (or sync) `load_model(self, model_id)`
    method; calls become LRU-cached model lookups."""

    def decorate(load_fn: Callable) -> Callable:
        is_method = "self" in inspect.signature(load_fn).parameters

        async def _load(owner, model_id: str):
            cache: OrderedDict = getattr(owner, MUX_ATTR, None)
            if cache is None:
                cache = OrderedDict()
                setattr(owner, MUX_ATTR, cache)
                owner.__serve_mux_loading__ = {}
            # fast path: hits never wait behind another model's cold load
            if model_id in cache:
                cache.move_to_end(model_id)
                return cache[model_id]
            # dedupe concurrent loads of the SAME model; different models
            # load concurrently (reference _ModelMultiplexWrapper semantics)
            loading: dict = owner.__serve_mux_loading__
            fut = loading.get(model_id)
            if fut is None:
                async def do_load():
                    try:
                        out = (load_fn(owner, model_id) if is_method
                               else load_fn(model_id))
                        if inspect.isawaitable(out):
                            out = await out
                        # cache inside the load task: the result must land
                        # even if every waiter was cancelled meanwhile
                        cache[model_id] = out
                        while len(cache) > max_num_models_per_replica:
                            cache.popitem(last=False)  # evict LRU; GC unloads
                        return out
                    finally:
                        loading.pop(model_id, None)

                fut = asyncio.ensure_future(do_load())
                loading[model_id] = fut
            # every waiter (leader included) shields: one cancelled request
            # must not cancel the shared load out from under the others
            return await asyncio.shield(fut)

        if is_method:
            @functools.wraps(load_fn)
            async def wrapper(self, model_id: str):
                return await _load(self, model_id)
        else:
            # bare function deployments: cache lives on the function object
            @functools.wraps(load_fn)
            async def wrapper(model_id: str):
                return await _load(wrapper, model_id)

        wrapper.__is_multiplexed__ = True
        return wrapper

    return decorate


def loaded_model_ids(user_callable: Any) -> list:
    """Model ids currently cached on a replica's callable (newest last)."""
    cache = getattr(user_callable, MUX_ATTR, None)
    return list(cache.keys()) if cache else []
