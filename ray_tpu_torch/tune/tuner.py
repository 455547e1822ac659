"""Tuner — the experiment-level entry point.

Analog of `ray.tune.Tuner` (`python/ray/tune/tuner.py:344` fit) +
`TuneConfig` (`python/ray/tune/tune_config.py`) + `ResultGrid`
(`python/ray/tune/result_grid.py`). Counterpart: ``ray_tpu/tune/tuner.py``.
Inverted layering vs the reference: trainers don't route through Tune; instead
Tune wraps any trainable — a function(config), a function(config) using
tune.report, or a BaseTrainer instance (its train_loop_config is
overridden per trial and its fit() runs inside the trial actor).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.air.config import RunConfig
from ray_tpu_torch.train._checkpoint import Checkpoint
from ray_tpu_torch.train._internal.storage import make_experiment_name
from ray_tpu_torch.train.trainer import BaseTrainer, Result
from ray_tpu_torch.tune.controller import TuneController
from ray_tpu_torch.tune.schedulers import TrialScheduler
from ray_tpu_torch.tune.search import BasicVariantGenerator
from ray_tpu_torch.tune.trial import ERROR, PENDING, RUNNING, Trial


@dataclasses.dataclass
class TuneConfig:
    metric: Optional[str] = None
    mode: str = "max"
    num_samples: int = 1
    max_concurrent_trials: Optional[int] = None
    scheduler: Optional[TrialScheduler] = None
    search_seed: Optional[int] = None
    # adaptive searcher (e.g. search.TPESearcher); when set, trial configs
    # are suggested incrementally instead of pre-generated
    search_alg: Optional[Any] = None

    def __post_init__(self):
        if self.mode not in ("max", "min"):
            raise ValueError("mode must be 'max' or 'min'")


class ResultGrid:
    def __init__(self, results: List[Result], metric: Optional[str],
                 mode: str):
        self._results = results
        self._metric = metric
        self._mode = mode

    def __len__(self) -> int:
        return len(self._results)

    def __getitem__(self, i: int) -> Result:
        return self._results[i]

    def __iter__(self):
        return iter(self._results)

    @property
    def errors(self) -> List[Exception]:
        return [r.error for r in self._results if r.error is not None]

    @property
    def num_errors(self) -> int:
        return len(self.errors)

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> Result:
        metric = metric or self._metric
        mode = mode or self._mode
        if metric is None:
            raise ValueError("no metric given to get_best_result")
        candidates = [r for r in self._results
                      if r.metrics and metric in r.metrics]
        if not candidates:
            raise RuntimeError("no trial reported the metric "
                               f"{metric!r}")
        key = lambda r: r.metrics[metric]  # noqa: E731
        return (max if mode == "max" else min)(candidates, key=key)

    def get_dataframe(self):
        import pandas as pd

        rows = []
        for r in self._results:
            row = dict(r.metrics or {})
            for k, v in (r.config or {}).items():
                row[f"config/{k}"] = v
            rows.append(row)
        return pd.DataFrame(rows)


def _trainer_to_fn(trainer: BaseTrainer) -> Callable[[Dict[str, Any]], Any]:
    """Run a trainer inside the trial actor, per-trial config overrides
    merged into train_loop_config (reference: param_space routing in
    `python/ray/train/base_trainer.py`)."""

    def fn(config):
        from ray_tpu_torch.train._internal import session as session_mod

        t = copy.copy(trainer)
        overrides = config.get("train_loop_config", config)
        merged = dict(getattr(t, "_train_loop_config", None) or {})
        merged.update(overrides or {})
        t._train_loop_config = merged
        # nest the trainer's own experiment under this trial's dir
        s = session_mod.get_session()
        t.run_config = copy.copy(t.run_config or RunConfig())
        t.run_config.storage_path = s.storage.trial_fs_path
        t.run_config.name = "inner"
        res = t.fit()
        if res.error is not None:
            raise res.error
        final = dict(res.metrics or {})
        ckpt = res.checkpoint
        session_mod.report(final, checkpoint=None if ckpt is None else ckpt)

    return fn


def with_resources(trainable: Callable, resources: Dict[str, float]):
    """`tune.with_resources` analog — attach per-trial resources."""
    trainable._tune_resources = dict(resources)  # type: ignore
    return trainable


class Tuner:
    def __init__(
        self,
        trainable: Any,
        *,
        param_space: Optional[Dict[str, Any]] = None,
        tune_config: Optional[TuneConfig] = None,
        run_config: Optional[RunConfig] = None,
    ):
        self._trainable = trainable
        self._param_space = param_space or {}
        self._tune_config = tune_config or TuneConfig()
        self._run_config = run_config or RunConfig()
        if self._run_config.name is None:
            self._run_config.name = make_experiment_name("tune")
        self._restored_trials: Optional[List[Trial]] = None

    # ------------------------------------------------------------------ fit

    def fit(self) -> ResultGrid:
        fn, resources, gang_bundles = self._resolve_trainable()
        searcher = self._tune_config.search_alg
        if self._restored_trials is not None:
            trials = self._restored_trials
        elif searcher is not None:
            searcher.set_objective(self._tune_config.metric or "_none_",
                                   self._tune_config.mode)
            searcher.set_search_space(self._param_space)
            trials = []  # suggested incrementally by the controller
        else:
            variants = BasicVariantGenerator(
                self._tune_config.search_seed).generate(
                    self._param_space, self._tune_config.num_samples)
            trials = [Trial(config=v, resources=dict(resources))
                      for v in variants]
        controller = TuneController(
            trainable_fn=fn,
            trials=trials,
            run_config=self._run_config,
            scheduler=self._tune_config.scheduler,
            metric=self._tune_config.metric,
            mode=self._tune_config.mode,
            max_concurrent_trials=self._tune_config.max_concurrent_trials,
            stop=self._run_config.stop,
            gang_bundles=gang_bundles,
            gang_strategy=(self._trainable.scaling_config.placement_strategy
                           if isinstance(self._trainable, BaseTrainer)
                           else "PACK"),
            searcher=searcher if self._restored_trials is None else None,
            num_samples=self._tune_config.num_samples,
            trial_resources=dict(resources),
        )
        trials = controller.run()
        return self._to_result_grid(trials, controller)

    def _resolve_trainable(self):
        t = self._trainable
        resources = getattr(t, "_tune_resources", None)
        if isinstance(t, BaseTrainer):
            # gang-reserve the trial actor AND the trainer's whole worker
            # group in ONE placement group per trial (bundle 0 = trial
            # actor, 1..N = train workers) so concurrent trials can never
            # hold actors while starving each other's worker bundles
            # (reference: tune/execution/placement_groups.py)
            sc = t.scaling_config
            trial_bundle = dict(resources
                                or sc.trainer_resources or {"CPU": 1.0})
            gang = [trial_bundle] + sc.as_placement_group_bundles()
            return _trainer_to_fn(t), trial_bundle, gang
        if callable(t):
            return t, resources or {"CPU": 1.0}, None
        raise TypeError(f"not a trainable: {t!r}")

    def _to_result_grid(self, trials: List[Trial],
                        controller: TuneController) -> ResultGrid:
        results = []
        for t in trials:
            results.append(Result(
                metrics=t.last_result,
                checkpoint=t.latest_checkpoint,
                path=os.path.join(controller.experiment_path,
                                  f"trial_{t.trial_id}"),
                error=RuntimeError(t.error) if t.error else None,
                metrics_history=t.metrics_history,
                config=t.config,
            ))
        return ResultGrid(results, self._tune_config.metric,
                          self._tune_config.mode)

    # -------------------------------------------------------------- restore

    @classmethod
    def restore(cls, path: str, trainable: Any,
                tune_config: Optional[TuneConfig] = None,
                resume_errored: bool = False) -> "Tuner":
        """Rebuild a Tuner from a saved experiment dir
        (reference: `Tuner.restore`, `tune/execution/experiment_state.py`).

        metric/mode are recovered from the saved state; the scheduler is
        not serializable, so pass `tune_config` to resume with one.
        """
        state_file = os.path.join(path, "tuner_state.json")
        with open(state_file) as f:
            state = json.load(f)
        trials = [Trial.from_json(d) for d in state["trials"]]
        for t in trials:
            if t.status == RUNNING:
                t.status = PENDING
            if resume_errored and t.status == ERROR:
                t.status = PENDING
                t.error = None
                t.num_failures = 0
        if tune_config is None:
            tune_config = TuneConfig(metric=state.get("metric"),
                                     mode=state.get("mode", "max"))
        tuner = cls(trainable,
                    tune_config=tune_config,
                    run_config=RunConfig(
                        name=os.path.basename(path.rstrip("/")),
                        storage_path=os.path.dirname(path.rstrip("/"))))
        tuner._restored_trials = trials
        return tuner
