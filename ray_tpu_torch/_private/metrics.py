"""Process-local metrics registry with Prometheus text exposition.

Analog of the reference's stats layer (`src/ray/stats/metric.h:392`
Counter/Gauge/Histogram + `metric_defs.h:46` definitions) and the
Prometheus export path (`python/ray/_private/metrics_agent.py`), without
OpenCensus: a lock-protected registry per process, rendered on demand in
Prometheus text format, served by each daemon's HTTP endpoint
(`http_util.py` in this package).

User-facing wrappers live in `ray_tpu_torch.util.metrics`.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Optional[Dict[str, str]]) -> _LabelKey:
    return tuple(sorted((labels or {}).items()))


def _escape_label_value(v: str) -> str:
    """Prometheus exposition escaping: one bad user label value must not
    invalidate the whole scrape."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _render_labels(key: _LabelKey) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in key)
    return "{" + inner + "}"


class Metric:
    def __new__(cls, name=None, *args, **kwargs):
        # Re-creating a metric of the SAME name and type returns the
        # registered instance instead of silently replacing it in the
        # registry — the old behaviour orphaned the first object, so
        # modules still incrementing it never rendered again. The
        # get-or-create is ONE critical section: registration happens
        # here, not in __init__, so two racing first-creators cannot
        # both see "absent" and leave one holding an unregistered
        # orphan whose increments never render.
        registry = kwargs.get("registry")
        if registry is None:
            for a in args:
                if isinstance(a, Registry):
                    registry = a
                    break
        if registry is None:
            registry = default_registry()
        with registry._lock:
            existing = registry._metrics.get(name)
            if existing is not None:
                if type(existing) is not cls:
                    raise ValueError(
                        f"metric {name!r} already registered with a "
                        f"different type")
                return existing
            inst = super().__new__(cls)
            registry._metrics[name] = inst
            return inst

    def __init__(self, name: str, description: str, registry: "Registry"):
        if getattr(self, "_registered", False):
            return  # reused instance: keep its recorded state
        self.name = name
        self.description = description
        self._lock = threading.Lock()
        self._init_state()
        self._registered = True

    def _init_state(self) -> None:
        """Subclass hook creating the value stores (runs exactly once per
        registered instance — re-construction must not wipe them)."""

    def value(self, labels: Optional[Dict[str, str]] = None) -> float:
        """Current value for one label set (counter-based assertions in
        tests; 0.0 when the series was never set/incremented). Only
        meaningful for single-valued metrics (Counter/Gauge)."""
        with self._lock:
            return getattr(self, "_values", {}).get(_label_key(labels), 0.0)

    def total(self) -> float:
        """Sum over every label set (Counter/Gauge): the
        "did ANY series move" form counter-based tests need — e.g. the
        compiled-graph suite proves a steady-state step issues zero
        control RPCs by snapshotting the rpc client-call counter's total
        across all method labels."""
        with self._lock:
            return float(sum(getattr(self, "_values", {}).values()))


class Counter(Metric):
    TYPE = "counter"

    def __init__(self, name, description="", registry=None):
        super().__init__(name, description, registry or default_registry())

    def _init_state(self) -> None:
        self._values: Dict[_LabelKey, float] = {}

    def inc(self, value: float = 1.0,
            labels: Optional[Dict[str, str]] = None) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def render(self) -> List[str]:
        with self._lock:
            return [
                f"{self.name}{_render_labels(k)} {v}"
                for k, v in sorted(self._values.items())
            ]


class Gauge(Metric):
    TYPE = "gauge"

    def __init__(self, name, description="", registry=None):
        super().__init__(name, description, registry or default_registry())

    def _init_state(self) -> None:
        self._values: Dict[_LabelKey, float] = {}

    def set(self, value: float,
            labels: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(value)

    def inc(self, value: float = 1.0, labels=None) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def dec(self, value: float = 1.0, labels=None) -> None:
        self.inc(-value, labels)

    def render(self) -> List[str]:
        with self._lock:
            return [
                f"{self.name}{_render_labels(k)} {v}"
                for k, v in sorted(self._values.items())
            ]


DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                   60.0, 300.0)


class _HistogramTimer:
    """Context manager recording a wall-clock span into a Histogram."""

    def __init__(self, hist: "Histogram", labels: Optional[Dict[str, str]]):
        self._hist = hist
        self._labels = labels
        self._t0 = 0.0

    def __enter__(self) -> "_HistogramTimer":
        import time

        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        import time

        self._hist.observe(time.perf_counter() - self._t0, self._labels)


class Histogram(Metric):
    TYPE = "histogram"

    def __init__(self, name, description="",
                 buckets: Sequence[float] = DEFAULT_BUCKETS, registry=None):
        if not getattr(self, "_registered", False):
            self.buckets = tuple(sorted(buckets))
        super().__init__(name, description, registry or default_registry())

    def _init_state(self) -> None:
        self._counts: Dict[_LabelKey, List[int]] = {}
        self._sums: Dict[_LabelKey, float] = {}
        self._totals: Dict[_LabelKey, int] = {}

    def observe(self, value: float,
                labels: Optional[Dict[str, str]] = None) -> None:
        key = _label_key(labels)
        idx = bisect.bisect_left(self.buckets, value)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            if idx < len(counts):
                counts[idx] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1

    def time(self, labels: Optional[Dict[str, str]] = None) -> _HistogramTimer:
        """``with hist.time():`` — observe the block's wall-clock seconds
        (the collective round / RPC latency idiom)."""
        return _HistogramTimer(self, labels)

    def count_total(self) -> int:
        """Observations across every label set — the "did this span get
        recorded at all" form counter-based tests need (e.g. proving
        CollectiveWork.wait() instrumented its block)."""
        with self._lock:
            return int(sum(self._totals.values()))

    def sum_total(self) -> float:
        """Sum of observed values across every label set (overlap-fraction
        arithmetic: wait_seconds.sum_total() / round_seconds.sum_total())."""
        with self._lock:
            return float(sum(self._sums.values()))

    def render(self) -> List[str]:
        out: List[str] = []
        with self._lock:
            for key, counts in sorted(self._counts.items()):
                cumulative = 0
                for bound, c in zip(self.buckets, counts):
                    cumulative += c
                    lk = dict(key)
                    lk["le"] = repr(bound)
                    out.append(
                        f"{self.name}_bucket{_render_labels(_label_key(lk))}"
                        f" {cumulative}")
                lk = dict(key)
                lk["le"] = "+Inf"
                out.append(
                    f"{self.name}_bucket{_render_labels(_label_key(lk))}"
                    f" {self._totals[key]}")
                out.append(
                    f"{self.name}_sum{_render_labels(key)} {self._sums[key]}")
                out.append(
                    f"{self.name}_count{_render_labels(key)} "
                    f"{self._totals[key]}")
        return out


class Registry:
    def __init__(self):
        self._metrics: Dict[str, Metric] = {}
        self._lock = threading.Lock()

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def render_prometheus(self) -> str:
        with self._lock:
            metrics = list(self._metrics.values())
        lines: List[str] = []
        for m in metrics:
            if not getattr(m, "_registered", False):
                continue  # registered in __new__, still mid-__init__
            lines.append(f"# HELP {m.name} {m.description}")
            lines.append(f"# TYPE {m.name} {m.TYPE}")
            lines.extend(m.render())
        return "\n".join(lines) + "\n"


def relabel_exposition(text: str, extra: Dict[str, str]) -> str:
    """Inject labels into every sample line of a Prometheus exposition —
    the cluster-wide scrape merge (`util.state.cluster_metrics(
    all_nodes=True)`) stamps ``node``/``component`` onto each daemon's
    text so identically-named series stay distinguishable."""
    extra_str = ",".join(
        f'{k}="{_escape_label_value(v)}"' for k, v in sorted(extra.items()))
    out: List[str] = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            out.append(line)
            continue
        # the value never contains spaces; label VALUES may, so split at
        # the last space only
        try:
            left, value = line.rsplit(" ", 1)
        except ValueError:
            out.append(line)
            continue
        if left.endswith("}"):
            out.append(f"{left[:-1]},{extra_str}}} {value}")
        else:
            out.append(f"{left}{{{extra_str}}} {value}")
    return "\n".join(out)


def merge_expositions(parts: Iterable[str]) -> str:
    """Merge already-relabelled expositions into parser-valid Prometheus
    text. A metric family present in several processes (most are) must
    render as ONE ``# HELP``/``# TYPE`` block with every part's samples
    grouped under it — the exposition format rejects duplicate TYPE
    lines and split families, so a plain concatenation scrapes fine by
    eye but fails promtool/Prometheus ingestion."""
    help_lines: Dict[str, str] = {}
    type_lines: Dict[str, str] = {}
    samples: Dict[str, List[str]] = {}
    order: List[str] = []

    def bucket(family: str) -> List[str]:
        got = samples.get(family)
        if got is None:
            got = samples[family] = []
            order.append(family)
        return got

    for text in parts:
        family = ""  # samples before any header stay in one '' bucket
        for line in text.splitlines():
            if line.startswith("# HELP ") or line.startswith("# TYPE "):
                family = line.split(" ", 3)[2]
                target = help_lines if line.startswith("# HELP ") \
                    else type_lines
                target.setdefault(family, line)
                bucket(family)
            elif not line or line.startswith("#"):
                continue
            else:
                # our renderers emit samples directly under their
                # family's header block, so `family` still names it
                bucket(family).append(line)
    out: List[str] = []
    for fam in order:
        if fam in help_lines:
            out.append(help_lines[fam])
        if fam in type_lines:
            out.append(type_lines[fam])
        out.extend(samples[fam])
    return "\n".join(out) + "\n"


_default: Optional[Registry] = None
_default_lock = threading.Lock()


def default_registry() -> Registry:
    global _default
    with _default_lock:
        if _default is None:
            _default = Registry()
        return _default
