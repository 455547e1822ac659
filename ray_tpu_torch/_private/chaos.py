"""Deterministic, seed-driven fault injection for the control plane.

The reference runtime earns its fault tolerance from gRPC's retriable,
idempotent control RPCs; ours comes from the reconnect/retry + idempotency
layer in ``rpc.py``. This module is how we *prove* it: a ``FaultController``
that both sides of the RPC layer (and interested daemons) consult before
sending/handling a frame, injecting message drops (connection sever),
duplicated sends, bounded delays, and daemon crash points.

Determinism: every decision is a pure function of ``(seed, point, n)`` where
``point`` is a stable string like ``"client:request_lease"`` and ``n`` is the
per-point call counter — NOT a draw from one shared RNG stream. Concurrency
can reorder *which call* observes the n-th decision of a point, but the
decision sequence per point is byte-identical for a given seed, so a failing
seed replays the same fault schedule (``tests/test_chaos.py`` asserts this).

Configuration rides the normal ``Config``/env path (``RAY_TPU_TORCH_CHAOS_*``), so
``Cluster(config=Config(chaos_seed=..., ...))`` propagates one schedule to
every daemon it spawns. All knobs default off; with ``chaos_seed < 0`` the
hot-path cost is one module-global ``is None`` check.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import os
import struct
from typing import Callable, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

_U64 = struct.Struct("<QQQQ")
_DENOM = float(1 << 64)

NO_FAULT = None  # sentinel meaning "no decision drawn / nothing to inject"


@dataclasses.dataclass(frozen=True)
class FaultDecision:
    """One injected fault for one RPC event.

    ``drop``      — lose the message in transit: the injector severs the
                    connection instead of delivering (client side: the request
                    never goes out; server side: the reply never comes back).
    ``duplicate`` — deliver the frame twice (client side only: two identical
                    request frames hit the server, exercising the dedupe
                    cache).
    ``delay_s``   — hold the frame this long before delivering.
    """

    drop: bool = False
    duplicate: bool = False
    delay_s: float = 0.0

    def any(self) -> bool:
        return self.drop or self.duplicate or self.delay_s > 0.0


class FaultController:
    """Seed-keyed fault schedule shared by client and server RPC paths.

    ``methods`` restricts injection to a comma-separated set of RPC method
    names ("" = every method). ``crash_points`` is
    ``"name[:nth][,name2[:nth]]"``: the nth time a daemon passes
    ``maybe_crash(name)`` the process hard-exits (SIGKILL analog), giving
    deterministic process-death placement inside a seeded run.
    """

    def __init__(
        self,
        seed: int,
        drop_prob: float = 0.0,
        dup_prob: float = 0.0,
        delay_prob: float = 0.0,
        delay_max_ms: int = 50,
        methods: str = "",
        crash_points: str = "",
        record: bool = False,
        exit_fn: Callable[[int], None] = os._exit,
    ):
        self.seed = int(seed)
        self.drop_prob = float(drop_prob)
        self.dup_prob = float(dup_prob)
        self.delay_prob = float(delay_prob)
        self.delay_max_ms = int(delay_max_ms)
        self._methods = frozenset(
            m.strip() for m in methods.split(",") if m.strip())
        self._counts: Dict[str, int] = {}
        self._crash_spec: Dict[str, int] = {}
        self._crash_hits: Dict[str, int] = {}
        self._exit_fn = exit_fn
        for part in (crash_points or "").split(","):
            part = part.strip()
            if not part:
                continue
            name, _, nth = part.partition(":")
            self._crash_spec[name] = int(nth) if nth else 1
        # optional schedule trace for the determinism test / seed bisection
        self.trace: Optional[List[Tuple[str, int, FaultDecision]]] = (
            [] if record else None)

    @classmethod
    def from_config(cls, cfg) -> Optional["FaultController"]:
        if getattr(cfg, "chaos_seed", -1) < 0:
            return None
        return cls(
            seed=cfg.chaos_seed,
            drop_prob=cfg.chaos_drop_prob,
            dup_prob=cfg.chaos_dup_prob,
            delay_prob=cfg.chaos_delay_prob,
            delay_max_ms=cfg.chaos_delay_max_ms,
            methods=cfg.chaos_methods,
            crash_points=cfg.chaos_crash_points,
        )

    # -------------------------------------------------------------- decisions

    def _uniforms(self, point: str, n: int) -> Tuple[float, float, float, float]:
        """Four U[0,1) values as a pure function of (seed, point, n)."""
        digest = hashlib.blake2b(
            f"{self.seed}:{point}:{n}".encode(), digest_size=32).digest()
        return tuple(v / _DENOM for v in _U64.unpack(digest))  # type: ignore[return-value]

    def rpc(self, side: str, method: str) -> Optional[FaultDecision]:
        """Decision for one RPC event. ``side`` is "client" (request about to
        be sent) or "server" (request received / reply about to be sent).
        Returns None when nothing is injected for this event."""
        if self._methods and method not in self._methods:
            return NO_FAULT
        point = f"{side}:{method}"
        n = self._counts.get(point, 0)
        self._counts[point] = n + 1
        u_drop, u_dup, u_delay, u_amount = self._uniforms(point, n)
        drop = u_drop < self.drop_prob
        decision = FaultDecision(
            drop=drop,
            # a dropped frame can't also be duplicated
            duplicate=(not drop) and u_dup < self.dup_prob,
            delay_s=(u_amount * self.delay_max_ms / 1000.0
                     if u_delay < self.delay_prob else 0.0),
        )
        if self.trace is not None:
            self.trace.append((point, n, decision))
        if not decision.any():
            return NO_FAULT
        return decision

    def local_delay(self, point: str) -> float:
        """Deterministic delay (seconds, possibly 0) for a non-RPC point —
        shared-memory protocols (compiled-graph channels) have no frame to
        drop or duplicate, but their seqlock timing can be perturbed: a
        delay between "reader observed version" and "reader acked" is
        exactly the interleaving a torn protocol would lose data under.
        Drawn from the same (seed, point, n) stream as rpc decisions, so a
        failing seed replays byte-identically."""
        if self._methods and point not in self._methods:
            return 0.0
        key = f"local:{point}"
        n = self._counts.get(key, 0)
        self._counts[key] = n + 1
        _, _, u_delay, u_amount = self._uniforms(key, n)
        delay = (u_amount * self.delay_max_ms / 1000.0
                 if u_delay < self.delay_prob else 0.0)
        if self.trace is not None:
            self.trace.append((key, n, FaultDecision(delay_s=delay)))
        return delay

    def schedule_bytes(self) -> bytes:
        """Canonical encoding of every decision drawn so far (record=True
        only) — the byte-identical replay artifact the determinism test
        compares."""
        if self.trace is None:
            raise RuntimeError("FaultController(record=True) required")
        out = []
        for point, n, d in self.trace:
            out.append(
                f"{point}#{n}:drop={int(d.drop)},dup={int(d.duplicate)},"
                f"delay_us={int(d.delay_s * 1e6)}")
        return "\n".join(out).encode()

    # ----------------------------------------------------------- crash points

    def maybe_crash(self, point: str) -> None:
        """Hard-exit the process the nth time this point is passed (only if
        the point was named in ``chaos_crash_points``)."""
        nth = self._crash_spec.get(point)
        if nth is None:
            return
        hits = self._crash_hits.get(point, 0) + 1
        self._crash_hits[point] = hits
        if hits == nth:
            logger.warning("chaos crash point %r hit %d: exiting", point, nth)
            self._exit_fn(137)


# ------------------------------------------------------------ process global

_controller: Optional[FaultController] = None
_configured = False


def fault_controller() -> Optional[FaultController]:
    """The process-wide controller, lazily built from the global Config
    (env-driven, so daemons spawned with RAY_TPU_TORCH_CHAOS_* inherit the
    schedule). None — the overwhelmingly common case — means chaos is off."""
    global _controller, _configured
    if not _configured:
        from ray_tpu_torch._private.config import global_config

        _controller = FaultController.from_config(global_config())
        _configured = True
    return _controller


def set_fault_controller(fc: Optional[FaultController]) -> None:
    """Install an explicit controller (tests)."""
    global _controller, _configured
    _controller = fc
    _configured = True


def reset() -> None:
    """Forget the cached controller; the next use re-reads config/env."""
    global _controller, _configured
    _controller = None
    _configured = False


def maybe_crash(point: str) -> None:
    """Convenience for daemon code: crash-point check against the process
    controller (no-op when chaos is off)."""
    fc = fault_controller()
    if fc is not None:
        fc.maybe_crash(point)


def maybe_delay(point: str) -> None:
    """Synchronous deterministic delay at a named local point (channel
    read/write/ack interleaving; no-op when chaos is off). Sync because
    the channel protocol runs on executor/user threads, never on an
    event loop."""
    fc = fault_controller()
    if fc is not None:
        delay = fc.local_delay(point)
        if delay > 0.0:
            import time

            time.sleep(delay)
