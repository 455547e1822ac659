"""Search spaces + variant generation.

Analog of `ray.tune.search` (`python/ray/tune/search/variant_generator.py`,
sample domains `python/ray/tune/search/sample.py`, basic variant generator
`python/ray/tune/search/basic_variant.py`): grid_search entries form a
cross product; Domain entries are sampled per variant; `num_samples`
repeats the whole expansion.

Counterpart: ``ray_tpu/tune/search.py``. The draws are numpy's, seeded as
the JAX package seeds them, so one seed gives the same variants and the
same TPE suggestions in both packages.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, List, Optional

import numpy as np


class Domain:
    def sample(self, rng: np.random.Generator) -> Any:
        raise NotImplementedError


class Uniform(Domain):
    def __init__(self, low, high):
        self.low, self.high = low, high

    def sample(self, rng):
        return float(rng.uniform(self.low, self.high))


class QUniform(Domain):
    def __init__(self, low, high, q):
        self.low, self.high, self.q = low, high, q

    def sample(self, rng):
        v = rng.uniform(self.low, self.high)
        return float(np.round(v / self.q) * self.q)


class LogUniform(Domain):
    def __init__(self, low, high):
        self.low, self.high = low, high

    def sample(self, rng):
        return float(np.exp(rng.uniform(np.log(self.low),
                                        np.log(self.high))))


class RandInt(Domain):
    def __init__(self, low, high):
        self.low, self.high = low, high

    def sample(self, rng):
        return int(rng.integers(self.low, self.high))


class Choice(Domain):
    def __init__(self, categories):
        self.categories = list(categories)

    def sample(self, rng):
        return self.categories[int(rng.integers(0, len(self.categories)))]


class Normal(Domain):
    def __init__(self, mean, sd):
        self.mean, self.sd = mean, sd

    def sample(self, rng):
        return float(rng.normal(self.mean, self.sd))


class SampleFrom(Domain):
    def __init__(self, fn: Callable):
        self.fn = fn

    def sample(self, rng):
        return self.fn(None)


class GridSearch:
    def __init__(self, values):
        self.values = list(values)


# public constructors (tune.uniform etc., `python/ray/tune/search/sample.py`)
def uniform(low, high):
    return Uniform(low, high)


def quniform(low, high, q):
    return QUniform(low, high, q)


def loguniform(low, high):
    return LogUniform(low, high)


def randint(low, high):
    return RandInt(low, high)


def choice(categories):
    return Choice(categories)


def randn(mean=0.0, sd=1.0):
    return Normal(mean, sd)


def sample_from(fn):
    return SampleFrom(fn)


def grid_search(values):
    return GridSearch(values)


# --------------------------------------------------------------- expansion


def _walk(space: Any, path=()):
    """Yield (path, spec) for every GridSearch/Domain leaf."""
    if isinstance(space, dict):
        for k, v in space.items():
            yield from _walk(v, path + (k,))
    elif isinstance(space, (GridSearch, Domain)):
        yield path, space


def _set(cfg: Dict, path, value):
    d = cfg
    for k in path[:-1]:
        d = d[k]
    d[path[-1]] = value


def _deepcopy_plain(space):
    if isinstance(space, dict):
        return {k: _deepcopy_plain(v) for k, v in space.items()}
    return space


class BasicVariantGenerator:
    """Grid cross-product × random samples
    (`python/ray/tune/search/basic_variant.py`)."""

    def __init__(self, seed: Optional[int] = None):
        self._rng = np.random.default_rng(seed)

    def generate(self, param_space: Dict[str, Any],
                 num_samples: int = 1) -> List[Dict[str, Any]]:
        leaves = list(_walk(param_space))
        grid_leaves = [(p, s) for p, s in leaves if isinstance(s, GridSearch)]
        domain_leaves = [(p, s) for p, s in leaves if isinstance(s, Domain)]
        grid_axes = [s.values for _, s in grid_leaves] or [[None]]
        variants = []
        for _ in range(num_samples):
            for combo in itertools.product(*grid_axes):
                cfg = _deepcopy_plain(param_space)
                if grid_leaves:
                    for (path, _), v in zip(grid_leaves, combo):
                        _set(cfg, path, v)
                for path, dom in domain_leaves:
                    _set(cfg, path, dom.sample(self._rng))
                variants.append(cfg)
        return variants


# --------------------------------------------------------------------------
# Adaptive searchers (suggest/observe protocol)


class Searcher:
    """Adaptive search protocol (≈ `python/ray/tune/search/searcher.py`):
    the controller asks `suggest()` for each new trial config and feeds
    completed results back via `on_trial_complete()`."""

    def set_objective(self, metric: str, mode: str) -> None:
        self._metric = metric
        self._mode = mode

    def set_search_space(self, param_space: Dict[str, Any]) -> None:
        self._space = param_space

    def _score(self, result: Optional[Dict[str, Any]]) -> Optional[float]:
        if not result:
            return None
        v = result.get(self._metric)
        if v is None:
            return None
        return float(v) if self._mode == "max" else -float(v)

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]]) -> None:
        pass


class TPESearcher(Searcher):
    """Tree-structured Parzen Estimator (the BOHB model family; ≈ the role
    of `python/ray/tune/search/bohb/bohb_search.py` without the external
    ConfigSpace/HpBandSter deps — pure numpy).

    After `n_initial` random suggestions, observations are split into a good
    (top `gamma` fraction) and bad set per numeric dimension; candidates are
    drawn from a Gaussian KDE over the good set and ranked by the density
    ratio l(x)/g(x). Choice dimensions use smoothed category counts.
    GridSearch entries are unsupported (use BasicVariantGenerator);
    SampleFrom falls back to random sampling.
    """

    def __init__(self, n_initial: int = 10, gamma: float = 0.25,
                 n_candidates: int = 24, seed: Optional[int] = None):
        self.n_initial = n_initial
        self.gamma = gamma
        self.n_candidates = n_candidates
        self._rng = np.random.default_rng(seed)
        self._suggested: Dict[str, Dict[str, Any]] = {}
        self._obs: List[tuple] = []  # (config, score or None)

    def set_search_space(self, param_space: Dict[str, Any]) -> None:
        super().set_search_space(param_space)
        self._leaves = list(_walk(param_space))
        for path, spec in self._leaves:
            if isinstance(spec, GridSearch):
                raise ValueError(
                    "TPESearcher does not support grid_search entries; "
                    "use BasicVariantGenerator for grids")
        self._obs = []  # list of (config, score)

    # ------------------------------------------------------------- transforms

    @staticmethod
    def _to_unit(spec, v):
        """Map a value into the KDE's working space."""
        if isinstance(spec, LogUniform):
            return np.log(v)
        return float(v)

    @staticmethod
    def _from_unit(spec, u):
        if isinstance(spec, LogUniform):
            v = float(np.exp(u))
            return float(np.clip(v, spec.low, spec.high))
        if isinstance(spec, Uniform):
            return float(np.clip(u, spec.low, spec.high))
        if isinstance(spec, QUniform):
            v = float(np.clip(u, spec.low, spec.high))
            return float(np.round(v / spec.q) * spec.q)
        if isinstance(spec, RandInt):
            return int(np.clip(round(u), spec.low, spec.high - 1))
        if isinstance(spec, Normal):
            return float(u)
        return float(u)

    def _kde_sample_and_pick(self, spec, good_u, bad_u):
        """Sample candidates from KDE(good), rank by good/bad density."""
        good_u = np.asarray(good_u, np.float64)
        bad_u = np.asarray(bad_u, np.float64)

        def bw(xs):
            if len(xs) < 2:
                return 1.0
            s = np.std(xs)
            return max(s * len(xs) ** -0.2, 1e-6)

        bw_g, bw_b = bw(good_u), bw(bad_u)
        centers = good_u[self._rng.integers(0, len(good_u),
                                            self.n_candidates)]
        cands = centers + self._rng.normal(0, bw_g, self.n_candidates)

        def log_density(xs, b, at):
            d = (at[:, None] - xs[None, :]) / b
            return np.log(np.mean(np.exp(-0.5 * d * d), axis=1) / b + 1e-12)

        score = log_density(good_u, bw_g, cands)
        if len(bad_u):
            score = score - log_density(bad_u, bw_b, cands)
        return float(cands[int(np.argmax(score))])

    def _choice_pick(self, spec, good_vals):
        """Categorical: sample ∝ smoothed counts in the good set."""
        cats = spec.categories
        counts = np.ones(len(cats), np.float64)
        for v in good_vals:
            try:
                counts[cats.index(v)] += 1.0
            except ValueError:
                pass
        p = counts / counts.sum()
        return cats[int(self._rng.choice(len(cats), p=p))]

    # --------------------------------------------------------------- protocol

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        scored = [(c, s) for c, s in self._obs if s is not None]
        cfg = _deepcopy_plain(self._space)
        if len(scored) < self.n_initial:
            for path, spec in self._leaves:
                _set(cfg, path, spec.sample(self._rng))
            self._suggested[trial_id] = cfg
            return cfg
        scored.sort(key=lambda cs: cs[1], reverse=True)
        n_good = max(1, int(np.ceil(self.gamma * len(scored))))
        good = [c for c, _ in scored[:n_good]]
        bad = [c for c, _ in scored[n_good:]]
        for path, spec in self._leaves:
            if isinstance(spec, Choice):
                _set(cfg, path, self._choice_pick(
                    spec, [_get(c, path) for c in good]))
            elif isinstance(spec, SampleFrom):
                _set(cfg, path, spec.sample(self._rng))
            else:
                good_u = [self._to_unit(spec, _get(c, path)) for c in good]
                bad_u = [self._to_unit(spec, _get(c, path)) for c in bad]
                u = self._kde_sample_and_pick(spec, good_u, bad_u)
                _set(cfg, path, self._from_unit(spec, u))
        self._suggested[trial_id] = cfg
        return cfg

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]]) -> None:
        cfg = self._suggested.pop(trial_id, None)
        if cfg is not None:
            self._obs.append((cfg, self._score(result)))


# BOHB = the TPE model driven under HyperBand halving
# (pair TPESearcher with schedulers.HyperBandScheduler, per the reference's
# TuneBOHB + HyperBandForBOHB split).
BOHBSearcher = TPESearcher


def _get(cfg: Dict, path):
    cur = cfg
    for p in path:
        cur = cur[p]
    return cur
