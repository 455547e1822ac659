"""Trial schedulers.

Analog of `ray.tune.schedulers` — FIFO, ASHA
(`python/ray/tune/schedulers/async_hyperband.py`), median stopping
(`median_stopping_rule.py`), PBT (`pbt.py`). Schedulers see every report
and decide CONTINUE / STOP; PBT additionally requests exploit-and-explore
(clone a top trial's checkpoint with mutated hyperparams), executed by the
controller as an actor restart.

Counterpart: ``ray_tpu/tune/schedulers.py``. PBT's and PB2's draws are
numpy's, seeded as the JAX package seeds them.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Dict, List, Optional

import numpy as np

logger = logging.getLogger(__name__)

CONTINUE = "CONTINUE"
STOP = "STOP"


class TrialScheduler:
    def set_objective(self, metric: str, mode: str) -> None:
        self._metric = metric
        self._mode = mode

    def _score(self, result: Dict[str, Any]) -> Optional[float]:
        v = result.get(self._metric)
        if v is None:
            return None
        return float(v) if self._mode == "max" else -float(v)

    def on_trial_result(self, trial, result: Dict[str, Any]) -> str:
        return CONTINUE

    def on_trial_complete(self, trial, result: Optional[Dict]) -> None:
        pass


class FIFOScheduler(TrialScheduler):
    pass


class AsyncHyperBandScheduler(TrialScheduler):
    """ASHA: rungs at grace_period·rf^k; at each rung a trial continues only
    if its metric is in the top 1/rf of scores recorded at that rung."""

    def __init__(self, time_attr: str = "training_iteration",
                 grace_period: int = 1, reduction_factor: int = 4,
                 max_t: int = 100):
        self.time_attr = time_attr
        self.grace_period = grace_period
        self.rf = reduction_factor
        self.max_t = max_t
        # rung milestone -> {trial_id: score recorded when it got there}
        self._rungs: Dict[int, Dict[str, float]] = {}
        milestones = []
        t = grace_period
        while t < max_t:
            milestones.append(t)
            t *= reduction_factor
        self._milestones = milestones

    def on_trial_result(self, trial, result) -> str:
        t = result.get(self.time_attr, 0)
        score = self._score(result)
        if score is None:
            return CONTINUE
        passed = [m for m in self._milestones if m <= t]
        if not passed:
            return CONTINUE
        top = passed[-1]
        rung = self._rungs.setdefault(top, {})
        rung.setdefault(trial.trial_id, score)
        # Re-evaluate the trial's standing at its top rung on EVERY report:
        # with near-lockstep trials the rung is part-filled when a trial
        # first arrives, so a one-shot check at the milestone would let
        # early-arriving weak trials through.
        if len(rung) >= self.rf:
            cutoff = float(np.percentile(
                list(rung.values()), 100 * (1 - 1.0 / self.rf)))
            if rung[trial.trial_id] < cutoff:
                return STOP
        if t >= self.max_t:
            return STOP
        return CONTINUE


ASHAScheduler = AsyncHyperBandScheduler


class MedianStoppingRule(TrialScheduler):
    """Stop a trial whose running-average score falls below the median of
    other trials' averages at the same step."""

    def __init__(self, time_attr: str = "training_iteration",
                 grace_period: int = 1, min_samples_required: int = 3):
        self.time_attr = time_attr
        self.grace_period = grace_period
        self.min_samples = min_samples_required
        self._scores: Dict[str, List[float]] = {}

    def on_trial_result(self, trial, result) -> str:
        score = self._score(result)
        t = result.get(self.time_attr, 0)
        if score is None:
            return CONTINUE
        self._scores.setdefault(trial.trial_id, []).append(score)
        if t <= self.grace_period:
            return CONTINUE
        means = [np.mean(v) for k, v in self._scores.items()
                 if k != trial.trial_id and v]
        if len(means) < self.min_samples:
            return CONTINUE
        my_mean = np.mean(self._scores[trial.trial_id])
        if my_mean < np.median(means):
            return STOP
        return CONTINUE


@dataclasses.dataclass
class _Exploit:
    source_trial_id: str
    new_config: Dict[str, Any]


class PopulationBasedTraining(TrialScheduler):
    """PBT (`python/ray/tune/schedulers/pbt.py:PopulationBasedTraining`):
    every `perturbation_interval` iterations, bottom-quantile trials copy a
    top-quantile trial's checkpoint and mutate hyperparams (×0.8/×1.2 or
    resample)."""

    def __init__(self, time_attr: str = "training_iteration",
                 perturbation_interval: int = 5,
                 hyperparam_mutations: Optional[Dict[str, Any]] = None,
                 quantile_fraction: float = 0.25,
                 resample_probability: float = 0.25,
                 seed: Optional[int] = None):
        self.time_attr = time_attr
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.resample_p = resample_probability
        self._rng = np.random.default_rng(seed)
        self._latest: Dict[str, float] = {}
        self._configs: Dict[str, Dict[str, Any]] = {}
        self.pending_exploits: Dict[str, _Exploit] = {}

    def on_trial_result(self, trial, result) -> str:
        score = self._score(result)
        if score is not None:
            self._latest[trial.trial_id] = score
        self._configs[trial.trial_id] = dict(trial.config)
        t = result.get(self.time_attr, 0)
        if t == 0 or t % self.interval != 0 or len(self._latest) < 2:
            return CONTINUE
        scores = sorted(self._latest.items(), key=lambda kv: kv[1])
        k = max(1, int(len(scores) * self.quantile))
        bottom = {tid for tid, _ in scores[:k]}
        top = [tid for tid, _ in scores[-k:]]
        if trial.trial_id in bottom:
            src = top[int(self._rng.integers(0, len(top)))]
            if src != trial.trial_id:
                # explore = perturb the SOURCE's hyperparams (the cloned
                # weights were trained under them), not this trial's own —
                # otherwise good hyperparams never propagate.
                src_config = self._configs.get(src, trial.config)
                self.pending_exploits[trial.trial_id] = _Exploit(
                    source_trial_id=src,
                    new_config=self._mutate(src_config))
        return CONTINUE

    def _mutate(self, config: Dict[str, Any]) -> Dict[str, Any]:
        from ray_tpu_torch.tune.search import Domain

        new = dict(config)
        for key, spec in self.mutations.items():
            if key not in new:
                continue
            if self._rng.random() < self.resample_p or not isinstance(
                    new[key], (int, float)):
                if isinstance(spec, Domain):
                    new[key] = spec.sample(self._rng)
                elif isinstance(spec, list):
                    new[key] = spec[int(self._rng.integers(0, len(spec)))]
                elif callable(spec):
                    new[key] = spec()
            else:
                factor = 1.2 if self._rng.random() < 0.5 else 0.8
                new[key] = type(new[key])(new[key] * factor)
        return new

    def on_trial_complete(self, trial, result) -> None:
        self._latest.pop(trial.trial_id, None)
        self.pending_exploits.pop(trial.trial_id, None)


PAUSE = "PAUSE"


class HyperBandScheduler(TrialScheduler):
    """Synchronous HyperBand (`python/ray/tune/schedulers/hyperband.py`).

    Trials are packed into brackets on arrival; each bracket halves at
    milestones r·eta^k. A trial reaching its bracket's current milestone is
    PAUSED (checkpoint + actor release) until every live member of the
    bracket arrives; then the top 1/eta resume and the rest stop. The
    controller executes the PAUSE/resume/stop decisions (`pop_actions`).
    Pair with `TPESearcher` for a BOHB-equivalent setup.
    """

    def __init__(self, time_attr: str = "training_iteration",
                 max_t: int = 81, reduction_factor: int = 3):
        self.time_attr = time_attr
        self.max_t = max_t
        self.eta = reduction_factor
        s_max = int(np.floor(np.log(max_t) / np.log(self.eta)))
        # bracket templates (s = s_max..0): n trials at initial budget r
        self._templates = []
        for s in range(s_max, -1, -1):
            n = int(np.ceil((s_max + 1) / (s + 1) * self.eta ** s))
            r = max(1, int(max_t * self.eta ** (-s)))
            self._templates.append((n, r))
        self._brackets: List[_Bracket] = []
        self._trial_bracket: Dict[str, "_Bracket"] = {}
        self._actions: Dict[str, str] = {}

    def _assign(self, trial) -> "_Bracket":
        b = self._trial_bracket.get(trial.trial_id)
        if b is not None:
            return b
        for cand in self._brackets:
            if cand.has_room():
                b = cand
                break
        else:
            tmpl = self._templates[len(self._brackets)
                                   % len(self._templates)]
            b = _Bracket(*tmpl, eta=self.eta, max_t=self.max_t)
            self._brackets.append(b)
        b.add(trial.trial_id)
        self._trial_bracket[trial.trial_id] = b
        return b

    def on_trial_result(self, trial, result) -> str:
        t = result.get(self.time_attr, 0)
        score = self._score(result)
        b = self._assign(trial)
        if t < b.milestone:
            return CONTINUE
        if t >= self.max_t:
            return STOP
        b.record(trial.trial_id, score if score is not None else -np.inf)
        if b.rung_full():
            self._actions.update(b.promote())
            # this trial's own fate was just decided by the promotion
            return self._actions.pop(trial.trial_id, PAUSE)
        return PAUSE

    def on_trial_complete(self, trial, result) -> None:
        b = self._trial_bracket.get(trial.trial_id)
        if b is not None:
            b.drop(trial.trial_id)
            if b.rung_full():
                self._actions.update(b.promote())

    def pop_actions(self) -> Dict[str, str]:
        """Controller hook: {trial_id: 'RESUME'|'STOP'} for paused trials."""
        out, self._actions = self._actions, {}
        return out

    def on_no_more_trials(self, live_trial_ids) -> None:
        """Searcher exhausted + nothing runnable: force part-filled rungs to
        resolve so a short supply of trials can't deadlock a bracket."""
        for b in self._brackets:
            self._actions.update(b.promote(force=True, live=live_trial_ids))


class _Bracket:
    def __init__(self, n: int, r: int, *, eta: int, max_t: int):
        self.capacity = n
        self.milestone = r
        self.eta = eta
        self.max_t = max_t
        self.members: set = set()       # live trial ids
        self.scores: Dict[str, float] = {}  # arrived at current rung
        self._entered = 0               # lifetime admissions (never resets)

    def has_room(self) -> bool:
        # lifetime count: a bracket whose trials finished must not regain
        # room, or late trials would be packed into a dead bracket whose
        # milestone is already max_t (degenerating halving into FIFO)
        return self._entered < self.capacity

    def add(self, trial_id: str) -> None:
        if trial_id not in self.members:
            self._entered += 1
        self.members.add(trial_id)

    def drop(self, trial_id: str) -> None:
        self.members.discard(trial_id)
        self.scores.pop(trial_id, None)

    def rung_full(self) -> bool:
        # full once the bracket stopped admitting and every live member has
        # reported at this rung (dead members don't block their peers)
        return (self._entered >= self.capacity
                and bool(self.members)
                and len(self.scores) >= len(self.members))

    def record(self, trial_id: str, score: float) -> None:
        self.scores[trial_id] = score

    def promote(self, force: bool = False, live=None) -> Dict[str, str]:
        """Resolve the current rung: top 1/eta RESUME, rest STOP."""
        if not self.scores:
            return {}
        if force and live is not None:
            # only trials still alive can be resumed/stopped
            self.scores = {t: s for t, s in self.scores.items()
                           if t in live}
            if not self.scores:
                return {}
        elif not force and not self.rung_full():
            return {}
        ranked = sorted(self.scores.items(), key=lambda kv: kv[1],
                        reverse=True)
        keep = max(1, int(np.floor(len(ranked) / self.eta)))
        actions = {}
        for i, (tid, _) in enumerate(ranked):
            actions[tid] = "RESUME" if i < keep else "STOP"
        survivors = {tid for tid, a in actions.items() if a == "RESUME"}
        for tid in list(self.members):
            if tid not in survivors:
                self.members.discard(tid)
        self.capacity = len(self.members)
        self.scores = {}
        self.milestone = min(self.milestone * self.eta, self.max_t)
        return actions


class PB2(PopulationBasedTraining):
    """PB2 (`python/ray/tune/schedulers/pb2.py`): PBT where continuous
    hyperparam mutations are chosen by a GP-UCB bandit over observed
    (config -> score-improvement) pairs instead of random perturbation.
    Pure-numpy GP (RBF kernel), no GPy dependency."""

    def __init__(self, time_attr: str = "training_iteration",
                 perturbation_interval: int = 5,
                 hyperparam_bounds: Optional[Dict[str, List[float]]] = None,
                 quantile_fraction: float = 0.25,
                 seed: Optional[int] = None):
        super().__init__(time_attr=time_attr,
                         perturbation_interval=perturbation_interval,
                         hyperparam_mutations={},
                         quantile_fraction=quantile_fraction,
                         seed=seed)
        self.bounds = {k: (float(lo), float(hi))
                       for k, (lo, hi) in (hyperparam_bounds or {}).items()}
        self._gp_data: List = []       # (x_vec, improvement)
        self._prev_score: Dict[str, float] = {}

    def on_trial_result(self, trial, result) -> str:
        score = self._score(result)
        if score is not None:
            prev = self._prev_score.get(trial.trial_id)
            if prev is not None:
                x = self._vec(trial.config)
                if x is not None:
                    self._gp_data.append((x, score - prev))
                    if len(self._gp_data) > 200:
                        self._gp_data.pop(0)
            self._prev_score[trial.trial_id] = score
        decision = super().on_trial_result(trial, result)
        if trial.trial_id in self.pending_exploits:
            # the next report's score jump comes from the adopted checkpoint,
            # not this trial's config — don't credit it to the GP
            self._prev_score.pop(trial.trial_id, None)
        return decision

    def on_trial_complete(self, trial, result) -> None:
        self._prev_score.pop(trial.trial_id, None)
        super().on_trial_complete(trial, result)

    def _vec(self, config) -> Optional[np.ndarray]:
        try:
            return np.array([
                (float(config[k]) - lo) / (hi - lo + 1e-12)
                for k, (lo, hi) in self.bounds.items()], np.float64)
        except (KeyError, TypeError, ValueError):
            return None

    def _mutate(self, config: Dict[str, Any]) -> Dict[str, Any]:
        new = dict(config)
        if not self.bounds:
            return new
        n_cand = 64
        cands = self._rng.uniform(0, 1, (n_cand, len(self.bounds)))
        if len(self._gp_data) >= 4:
            X = np.stack([x for x, _ in self._gp_data])
            y = np.array([v for _, v in self._gp_data], np.float64)
            y = (y - y.mean()) / (y.std() + 1e-9)
            ell, noise = 0.2, 1e-3
            def k(a, b):
                d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
                return np.exp(-d2 / (2 * ell * ell))
            K = k(X, X) + noise * np.eye(len(X))
            Kinv_y = np.linalg.solve(K, y)
            Ks = k(cands, X)
            mu = Ks @ Kinv_y
            var = np.clip(1.0 - np.einsum(
                "ij,ji->i", Ks, np.linalg.solve(K, Ks.T)), 1e-9, None)
            ucb = mu + 1.5 * np.sqrt(var)
            best = cands[int(np.argmax(ucb))]
        else:
            best = cands[0]
        for i, (kname, (lo, hi)) in enumerate(self.bounds.items()):
            val = lo + best[i] * (hi - lo)
            if isinstance(config.get(kname), int):
                val = int(round(val))
            new[kname] = val
        return new
