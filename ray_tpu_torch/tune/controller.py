"""The trial-driving event loop.

Analog of `ray.tune.execution.tune_controller.TuneController`
(`python/ray/tune/execution/tune_controller.py:68`, step `:666`,
_schedule_trial_actor `:964`): trials run as single-worker actor gangs
(WorkerGroup under a placement group); the controller pumps one
outstanding next_report per running trial through `ray_tpu.wait`, feeds
the scheduler, executes early stops / PBT exploits as actor restarts, and
persists experiment state after every transition for Tuner.restore.

Counterpart: ``ray_tpu/tune/controller.py``. The runtime hands out whole
cards, so trials that each ask for ``GPU: 1`` run one at a time on a
one-card node only with ``max_concurrent_trials=1``: a function trial's
``WorkerGroup.start`` waits in this loop for its bundle (and raises after
60 s), and a trainer trial's gang group turns ``ERROR`` after
``gang_placement_timeout_s``, both as in the JAX package.
"""

from __future__ import annotations

import functools
import json
import logging
import os
import time
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.air.config import RunConfig
from ray_tpu_torch.train._checkpoint import Checkpoint
from ray_tpu_torch.train._internal.session import TrainingReport
from ray_tpu_torch.train._internal.storage import StorageContext
from ray_tpu_torch.train._internal.worker_group import WorkerGroup
from ray_tpu_torch.tune import schedulers as sched_mod
from ray_tpu_torch.tune.trial import (ERROR, PAUSED, PENDING, RUNNING, TERMINATED,
                                Trial)

logger = logging.getLogger(__name__)


class _RunningTrial:
    def __init__(self, trial: Trial, group: WorkerGroup):
        self.trial = trial
        self.group = group
        self.pending_ref = None

    @property
    def actor(self):
        return self.group.workers[0].actor

    def arm(self):
        self.pending_ref = self.actor.next_report.remote(None)

    def shutdown(self):
        try:
            self.actor.end_session.remote()
        except Exception:
            pass
        self.group.shutdown()


class TuneController:
    def __init__(
        self,
        trainable_fn: Callable[[Dict[str, Any]], Any],
        trials: List[Trial],
        run_config: RunConfig,
        scheduler: Optional[sched_mod.TrialScheduler] = None,
        metric: Optional[str] = None,
        mode: str = "max",
        max_concurrent_trials: Optional[int] = None,
        stop: Optional[Dict[str, Any]] = None,
        gang_bundles: Optional[List[Dict[str, float]]] = None,
        gang_strategy: str = "PACK",
        gang_placement_timeout_s: float = 60.0,
        searcher=None,
        num_samples: int = 0,
        trial_resources: Optional[Dict[str, float]] = None,
    ):
        self._fn = trainable_fn
        self.trials = trials
        # adaptive search: trials are suggested incrementally (up to
        # num_samples) instead of pre-generated
        self._searcher = searcher
        self._num_samples = num_samples
        self._trial_resources = dict(trial_resources or {"CPU": 1.0})
        # one PG per trial covering the trial actor + its trainer's
        # worker gang; None for plain function trainables
        self._gang_bundles = gang_bundles
        self._gang_strategy = gang_strategy
        self._gang_timeout = gang_placement_timeout_s
        self._trial_pgs: Dict[str, Any] = {}
        self._pg_created_at: Dict[str, float] = {}
        self._run_config = run_config
        self._scheduler = scheduler or sched_mod.FIFOScheduler()
        self._scheduler.set_objective(metric or "_none_", mode)
        self._max_concurrent = max_concurrent_trials or 8
        self._stop_criteria = stop or {}
        self._experiment_name = run_config.name
        self._running: Dict[str, _RunningTrial] = {}
        self._max_failures = (run_config.failure_config.max_failures
                              if run_config.failure_config else 0)
        self._metric = metric
        self._mode = mode
        self._last_save = 0.0

    # ---------------------------------------------------------------- state

    @property
    def experiment_path(self) -> str:
        return os.path.join(self._run_config.storage_path,
                            self._experiment_name)

    def save_state(self, force: bool = True) -> None:
        """Persist experiment state; non-forced saves (per-report) are
        throttled — rewriting every trial's full history on every report
        would be O(reports²) I/O (reference throttles with
        checkpoint_period)."""
        now = time.monotonic()
        if not force and now - self._last_save < 5.0:
            return
        self._last_save = now
        os.makedirs(self.experiment_path, exist_ok=True)
        state = {"trials": [t.to_json() for t in self.trials],
                 "metric": self._metric, "mode": self._mode}
        tmp = os.path.join(self.experiment_path, ".tuner_state.tmp")
        with open(tmp, "w") as f:
            json.dump(state, f, default=str)
        os.replace(tmp, os.path.join(self.experiment_path, "tuner_state.json"))

    # ----------------------------------------------------------------- run

    def run(self) -> List[Trial]:
        try:
            while True:
                self._apply_scheduler_actions()
                self._maybe_suggest_trials()
                self._start_pending()
                if self._running:
                    self._poll_once()
                    continue
                if any(t.status == PENDING for t in self.trials):
                    continue
                paused = [t for t in self.trials if t.status == PAUSED]
                if paused:
                    # nothing runnable anywhere: let the scheduler resolve
                    # part-filled rungs (HyperBand with a short trial
                    # supply), then retry once before giving up
                    if hasattr(self._scheduler, "on_no_more_trials"):
                        self._scheduler.on_no_more_trials(
                            {t.trial_id for t in paused})
                        self._apply_scheduler_actions()
                        if any(t.status == PENDING for t in self.trials):
                            continue
                    for t in paused:
                        t.status = TERMINATED
                        self._scheduler.on_trial_complete(t, t.last_result)
                        if self._searcher is not None:
                            self._searcher.on_trial_complete(
                                t.trial_id, t.last_result)
                break
        finally:
            for rt in list(self._running.values()):
                rt.shutdown()
            self._running.clear()
            for trial in self.trials:
                self._remove_trial_pg(trial)
            self.save_state()
        return self.trials

    def _apply_scheduler_actions(self) -> None:
        """Execute RESUME/STOP verdicts for paused trials (HyperBand)."""
        pop = getattr(self._scheduler, "pop_actions", None)
        if pop is None:
            return
        actions = pop()
        if not actions:
            return
        by_id = {t.trial_id: t for t in self.trials}
        for tid, act in actions.items():
            trial = by_id.get(tid)
            if trial is None or trial.status != PAUSED:
                continue
            if act == "RESUME":
                trial.status = PENDING
            else:
                trial.status = TERMINATED
                self._scheduler.on_trial_complete(trial, trial.last_result)
                if self._searcher is not None:
                    self._searcher.on_trial_complete(tid, trial.last_result)
        self.save_state(force=False)

    def _maybe_suggest_trials(self) -> None:
        """Adaptive search: keep the concurrency window fed with fresh
        suggestions until num_samples trials exist."""
        if self._searcher is None:
            return
        while (len(self.trials) < self._num_samples
               and sum(1 for t in self.trials
                       if t.status in (PENDING, RUNNING))
               < self._max_concurrent):
            trial = Trial(config={}, resources=dict(self._trial_resources))
            cfg = self._searcher.suggest(trial.trial_id)
            if cfg is None:
                return
            trial.config = cfg
            self.trials.append(trial)

    def _start_pending(self) -> None:
        slots = self._max_concurrent - len(self._running)
        for trial in self.trials:
            if slots <= 0:
                return
            if trial.status != PENDING:
                continue
            if self._gang_bundles is not None:
                pg = self._ensure_trial_pg(trial)
                if not pg.wait(timeout=0.05):
                    # gang not placed yet: the trial stays PENDING and we
                    # keep polling running trials — never block the loop.
                    # An unsatisfiable gang must surface, not spin forever.
                    age = time.monotonic() - self._pg_created_at.get(
                        trial.trial_id, time.monotonic())
                    if age > self._gang_timeout:
                        self._remove_trial_pg(trial)
                        trial.status = ERROR
                        trial.error = (
                            f"gang placement group {self._gang_bundles} not "
                            f"placeable within {self._gang_timeout}s")
                        self.save_state()
                        continue
                    slots -= 1  # the pg holds a start slot
                    continue
            self._start_trial(trial)
            slots -= 1

    def _ensure_trial_pg(self, trial: Trial):
        from ray_tpu_torch.util.placement_group import placement_group

        pg = self._trial_pgs.get(trial.trial_id)
        if pg is None:
            pg = placement_group(
                [dict(b) for b in self._gang_bundles],
                strategy=self._gang_strategy)
            self._trial_pgs[trial.trial_id] = pg
            self._pg_created_at[trial.trial_id] = time.monotonic()
        return pg

    def _remove_trial_pg(self, trial: Trial) -> None:
        from ray_tpu_torch.util.placement_group import remove_placement_group

        pg = self._trial_pgs.pop(trial.trial_id, None)
        self._pg_created_at.pop(trial.trial_id, None)
        if pg is not None:
            try:
                remove_placement_group(pg)
            except Exception:
                pass

    def _start_trial(self, trial: Trial,
                     checkpoint: Optional[Checkpoint] = None) -> None:
        pg = self._trial_pgs.get(trial.trial_id)
        group = WorkerGroup(num_workers=1,
                            resources_per_worker=trial.resources,
                            placement_group=pg, bundle_offset=0)
        group.start()
        storage = StorageContext(self._run_config.storage_path,
                                 self._experiment_name,
                                 trial_dir_name=f"trial_{trial.trial_id}")
        storage.current_checkpoint_index = trial.checkpoint_index
        storage.make_dirs()
        ckpt = checkpoint or trial.latest_checkpoint
        kwargs = dict(
            train_fn=functools.partial(self._fn, trial.config),
            world_rank=0, local_rank=0, world_size=1, local_world_size=1,
            node_rank=0, storage=storage,
            experiment_name=self._experiment_name,
            trial_name=f"trial_{trial.trial_id}",
            loaded_checkpoint=ckpt,
            trial_info={"trial_id": trial.trial_id, "config": trial.config},
            gang_pg=pg,  # trainer's inner WorkerGroup joins bundles 1..N
        )
        rt = _RunningTrial(trial, group)
        try:
            ray_tpu_torch.get(rt.actor.start_session.remote(kwargs))
        except Exception as e:
            group.shutdown()
            trial.status = ERROR
            trial.error = f"failed to start: {e}"
            self._remove_trial_pg(trial)
            return
        trial.status = RUNNING
        rt.arm()
        self._running[trial.trial_id] = rt
        self.save_state()

    def _poll_once(self) -> None:
        refs = {rt.pending_ref: rt for rt in self._running.values()}
        ready, _ = ray_tpu_torch.wait(list(refs.keys()), num_returns=1,
                                timeout=5.0)
        for ref in ready:
            rt = refs[ref]
            try:
                report: TrainingReport = ray_tpu_torch.get(ref)
            except Exception as e:
                self._on_trial_failed(rt, f"actor died: {e}")
                continue
            if report.kind == "error":
                self._on_trial_failed(rt, report.error)
            elif report.kind == "done":
                self._finish_trial(rt, TERMINATED)
            else:
                self._on_result(rt, report)

    # -------------------------------------------------------------- events

    def _on_result(self, rt: _RunningTrial, report: TrainingReport) -> None:
        trial = rt.trial
        trial.iteration += 1
        trial.checkpoint_index += 1
        result = dict(report.metrics or {})
        result.setdefault("training_iteration", trial.iteration)
        result["trial_id"] = trial.trial_id
        trial.last_result = result
        trial.metrics_history.append(result)
        if report.checkpoint_path:
            trial.latest_checkpoint_path = report.checkpoint_path
        decision = self._scheduler.on_trial_result(trial, result)
        if self._should_stop(result):
            decision = sched_mod.STOP
        exploit = None
        if isinstance(self._scheduler, sched_mod.PopulationBasedTraining):
            exploit = self._scheduler.pending_exploits.pop(
                trial.trial_id, None)
        if exploit is not None:
            self._exploit(rt, exploit)
        elif decision == sched_mod.STOP:
            self._finish_trial(rt, TERMINATED)
        elif decision == sched_mod.PAUSE:
            self._pause_trial(rt)
        else:
            rt.arm()
        self.save_state(force=False)

    def _pause_trial(self, rt: _RunningTrial) -> None:
        """Release the trial's actor + gang; it stays resumable from its
        latest checkpoint (HyperBand rung synchronization)."""
        trial = rt.trial
        rt.shutdown()
        self._running.pop(trial.trial_id, None)
        self._remove_trial_pg(trial)
        trial.status = PAUSED
        self.save_state(force=False)

    def _exploit(self, rt: _RunningTrial, exploit) -> None:
        """PBT: restart this trial from the source trial's checkpoint with
        the mutated config."""
        trial = rt.trial
        src = next((t for t in self.trials
                    if t.trial_id == exploit.source_trial_id), None)
        src_ckpt = src.latest_checkpoint if src else None
        logger.info("PBT exploit: trial %s <- %s, config %s",
                    trial.trial_id, exploit.source_trial_id,
                    exploit.new_config)
        rt.shutdown()
        self._running.pop(trial.trial_id, None)
        # fresh gang PG for the restart: the old one's bundles may still be
        # transiently held while the inner workers die with their owner
        self._remove_trial_pg(trial)
        trial.config = exploit.new_config
        if src is not None and src.latest_checkpoint_path:
            # restart from the exploited trial's checkpoint
            trial.latest_checkpoint_path = src.latest_checkpoint_path
        trial.status = PENDING  # the main loop re-places and restarts it

    def _should_stop(self, result: Dict[str, Any]) -> bool:
        for k, v in self._stop_criteria.items():
            if k in result and result[k] >= v:
                return True
        return False

    def _finish_trial(self, rt: _RunningTrial, status: str,
                      error: Optional[str] = None) -> None:
        rt.trial.status = status
        rt.trial.error = error
        self._scheduler.on_trial_complete(rt.trial, rt.trial.last_result)
        if self._searcher is not None:
            self._searcher.on_trial_complete(rt.trial.trial_id,
                                             rt.trial.last_result)
        rt.shutdown()
        self._running.pop(rt.trial.trial_id, None)
        self._remove_trial_pg(rt.trial)
        self.save_state()

    def _on_trial_failed(self, rt: _RunningTrial, error: str) -> None:
        trial = rt.trial
        trial.num_failures += 1
        logger.warning("trial %s failed (%d): %s", trial.trial_id,
                       trial.num_failures, error)
        rt.shutdown()
        self._running.pop(trial.trial_id, None)
        if self._max_failures < 0 or trial.num_failures <= self._max_failures:
            trial.status = PENDING  # restart from its latest checkpoint
            self._remove_trial_pg(trial)  # restart places a fresh gang
        else:
            trial.status = ERROR
            trial.error = error
            self._scheduler.on_trial_complete(trial, trial.last_result)
            if self._searcher is not None:
                self._searcher.on_trial_complete(trial.trial_id,
                                                 trial.last_result)
            self._remove_trial_pg(trial)
        self.save_state()
