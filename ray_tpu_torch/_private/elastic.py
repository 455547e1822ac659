"""Elastic respawn policy: preemption-tolerant worker replacement.

Counterpart: ``ray_tpu/_private/elastic.py``. ``ElasticSupervisor`` is
the per-workload policy object behind the elastic membership layer
(``util/collective/resizable.py``): when a dp replica / env-runner dies (node
preemption, chaos kill), the workload asks this policy whether and when
to respawn a replacement — a bounded respawn budget so a crash-looping
spec cannot spin forever, exponential backoff between attempts on the
SAME slot so a flapping node is not hammered, and placement resolved
through the existing ``channels.resolve_actor_placement`` so the
replacement's channels land exactly like the original's did.

The policy is deliberately dumb about *what* to spawn — the workload
passes a zero-arg ``spawn_fn`` that runs its own actor-options path —
and strict about *accounting*: every departure, respawn and rejoin is
counted (``ray_tpu_elastic_{departures,joins,reshards}_total``), and
rejoin latency (death observed -> replacement serving at the new epoch)
lands in the ``ray_tpu_elastic_rejoin_seconds`` histogram plus an
``elastic.rejoin`` flight span, so a soak can assert elasticity's cost
the same way it asserts its correctness.

Knobs (config fields / env):

  * ``RAY_TPU_TORCH_ELASTIC_RESPAWN_BUDGET`` — max respawns per slot for the
    workload's lifetime.
  * ``RAY_TPU_TORCH_ELASTIC_BACKOFF_S`` — base backoff; attempt n on a slot
    waits ``backoff * 2**(n-1)`` seconds (capped at 30s).
  * ``RAY_TPU_TORCH_ELASTIC_RESIZE_TIMEOUT_S`` — budget for the post-resize
    first operation (survivor re-rendezvous + joiner param sync).

All three reject explicit zeros loudly (``require_positive``, never a
falsy-zero ``or`` chain): 0 never silently means "some default", it
raises at build time.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch._private import flight
from ray_tpu_torch._private.metrics import Counter, Histogram

logger = logging.getLogger(__name__)

_F_REJOIN = flight.intern("elastic.rejoin")

m_joins = Counter(
    "ray_tpu_elastic_joins_total",
    "Replacement workers spawned and rejoined after a departure")
m_departures = Counter(
    "ray_tpu_elastic_departures_total",
    "Members lost from elastic groups (death fan-out observed)")
m_reshards = Counter(
    "ray_tpu_elastic_reshards_total",
    "Elastic group re-declarations (shrink or grow) at a new epoch")
m_rejoin_seconds = Histogram(
    "ray_tpu_elastic_rejoin_seconds",
    "Departure-observed to replacement-serving latency",
    buckets=(0.5, 1, 2, 5, 10, 30, 60, 120))


def require_positive(name: str, value, kind=int):
    """Validate an elastic knob: explicit zeros (and negatives) RAISE
    instead of falling through a falsy-``or`` chain to some default."""
    if value is None:
        raise ValueError(f"{name} must be set")
    v = kind(value)
    if v <= 0:
        raise ValueError(
            f"{name} must be a positive {kind.__name__}, got {value!r} "
            f"(explicit zeros are rejected, never silently replaced "
            f"with a default)")
    return v


_BACKOFF_CAP_S = 30.0


class ElasticSupervisor:
    """Respawn budget + backoff + placement for one elastic workload.

    Thread-safe; one instance per topology (``PipelineTrainer``,
    ``SebulbaTopology``). Slots are caller-chosen keys (e.g.
    ``("dp", 2)`` or ``"runner3"``) so the budget is per-position, not
    global — losing every dp row once is N respawns of budget 1 each,
    not one slot burning the whole budget.
    """

    def __init__(self, *, respawn_budget: Optional[int] = None,
                 backoff_s: Optional[float] = None,
                 resize_timeout_s: Optional[float] = None,
                 config=None, name: str = "elastic"):
        if config is None:
            from ray_tpu_torch._private.config import global_config

            config = global_config()
        if respawn_budget is None:
            respawn_budget = config.elastic_respawn_budget
        if backoff_s is None:
            backoff_s = config.elastic_backoff_s
        if resize_timeout_s is None:
            resize_timeout_s = config.elastic_resize_timeout_s
        self.name = name
        self.respawn_budget = require_positive(
            "elastic_respawn_budget", respawn_budget)
        self.backoff_s = require_positive(
            "elastic_backoff_s", backoff_s, kind=float)
        self.resize_timeout_s = require_positive(
            "elastic_resize_timeout_s", resize_timeout_s, kind=float)
        self._lock = threading.Lock()
        self._attempts: Dict[Any, int] = {}

    @property
    def resize_timeout_ms(self) -> int:
        return int(self.resize_timeout_s * 1000)

    def attempts(self, slot: Any) -> int:
        with self._lock:
            return self._attempts.get(slot, 0)

    def respawn(self, slot: Any, spawn_fn: Callable[[], Any]) -> Any:
        """Spawn slot's replacement under the budget/backoff policy.

        Raises ``RuntimeError`` when the slot's budget is exhausted —
        the workload then surfaces the clean terminal error chaos_soak
        expects for non-recoverable schedules. Sleeps out the
        exponential backoff (caller's thread: respawn happens at a
        flush/step boundary, which is exactly where the workload is
        allowed to stall)."""
        with self._lock:
            n = self._attempts.get(slot, 0) + 1
            if n > self.respawn_budget:
                raise RuntimeError(
                    f"elastic respawn budget exhausted for slot {slot!r} "
                    f"({self.respawn_budget} respawn(s)); treating the "
                    f"departure as terminal")
            self._attempts[slot] = n
        if n > 1:
            delay = min(self.backoff_s * 2 ** (n - 2), _BACKOFF_CAP_S)
            logger.info("elastic %s: slot %r respawn attempt %d, backing "
                        "off %.1fs", self.name, slot, n, delay)
            time.sleep(delay)
        actor = spawn_fn()
        m_joins.inc(labels={"workload": self.name})
        return actor

    def resolve_placement(self, core, actor, views) -> dict:
        """Where did the replacement land (worker/node identity for
        channel participant sets) — the existing placement path, one
        name."""
        from ray_tpu_torch._private import channels as _channels

        return _channels.resolve_actor_placement(core, actor._actor_id,
                                                 views)

    def rejoin_span(self, started_monotonic: float) -> None:
        """Record one completed rejoin (departure observed at
        ``started_monotonic`` -> replacement serving now)."""
        dt = max(0.0, time.monotonic() - started_monotonic)
        m_rejoin_seconds.observe(dt, labels={"workload": self.name})
        t_now = flight.now()
        if t_now:
            flight.span_since(_F_REJOIN, max(1, t_now - int(dt * 1e9)))
