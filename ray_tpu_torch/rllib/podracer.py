"""Podracer RL topologies: Anakin and Sebulba (arXiv:2104.06272).

Counterpart: ``ray_tpu/rllib/podracer.py``.

**Sebulba** (split actor/learner pods, ``SebulbaTopology``): R env-runner
actors stream fixed-shape trajectory batches into L learner ranks through
depth-k slot-ring channels (``_private/channels.py``); the writer
backpressure IS the off-policy bound: a runner can sample at most
``podracer_channel_depth`` batches ahead of its learner consuming them.
Learner ranks average their gradients over the host collective and fresh
params flow back to the runners through ``collective.broadcast`` over one
learner+runners host group, never an object-store put or a per-runner
``set_weights`` RPC. A steady iteration is channel reads/writes and
collective rounds only: ZERO control-plane RPCs per rank, counter-proven
by the ``ray_tpu_rpc_client_calls_total`` delta each report carries. The
driver's whole steady-state job is one shared-memory report read per
learner per iteration. Each runner and learner runs on the config's
``env_runner_device`` and ``learner_device`` (the card unless they name
the CPU; a card role asks the runtime for ``num_gpus=1``).

Schedule (iteration n, 1-based): every runner samples batch n and commits
it at channel version 2n; its learner reads its runners' batches n, runs
the algorithm's update program, and every ``broadcast_interval``-th
iteration all learners + all runners meet in a parameter broadcast
(learner rank 0 is the root). With ``broadcast_interval=1`` the broadcast
is the iteration barrier and training is exactly the dynamic loop's
on-policy math. At ``interval > 1`` (IMPALA's async shape) runners
free-run ahead, bounded by min(depth, interval) batches of lag.

**Anakin** (co-located, ``AnakinTrainer``): one process where the
vectorized env steps on the card inside the policy rollout, followed by
the V-trace loss, the gradients and Adam, all on the card with no host
read (``SyntheticAtariEnv`` is pure arithmetic with an exact tensor mirror,
``synthetic_atari.torch_step``/``torch_reset``). JAX compiles the whole
iteration into one program; here it is eager torch, its kernels launched
one by one (their count per iteration is recorded in PERF.md).

Failure semantics match the pipeline trainer: teardown or any
participant's death closes every channel, blocked peers raise
``ChannelClosedError`` instead of hanging, and a broken topology can
produce an error, never a wrong update.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ray_tpu_torch._private import channels as _channels
from ray_tpu_torch._private import chaos, flight, serialization
from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch._private.exceptions import ChannelClosedError
from ray_tpu_torch._private.metrics import Counter
from ray_tpu_torch.rllib.core.learner import (actor_device, actor_options,
                                              make_optimizer, to_numpy_tree,
                                              trainable)
from ray_tpu_torch.train._internal.gradients import (tree_flatten,
                                                     tree_unflatten)

logger = logging.getLogger(__name__)

# flight-recorder span ids: the per-iteration runner/learner/broadcast
# phases of the zero-RPC Sebulba loop (per-thread ring records, no RPCs)
_F_SAMPLE = flight.intern("rl.sample")
_F_UPDATE = flight.intern("rl.update")
_F_BCAST = flight.intern("rl.bcast")

_m_iterations = Counter(
    "ray_tpu_podracer_iterations_total",
    "Sebulba learner iterations completed (per learner process)")
_m_batches = Counter(
    "ray_tpu_podracer_rollout_batches_total",
    "Sebulba rollout batches streamed through trajectory channels")
_m_broadcasts = Counter(
    "ray_tpu_podracer_broadcasts_total",
    "Parameter broadcast rounds joined, by role")
_m_env_steps = Counter(
    "ray_tpu_podracer_env_steps_total",
    "Env steps consumed by Sebulba learners (driver-side tally)")


def require_positive(name: str, value, kind=int):
    """Validate a topology knob: explicit zeros (and negatives) RAISE
    instead of falling through a falsy-``or`` chain to some default —
    enforced for every ``RAY_TPU_TORCH_PODRACER_*`` / topology knob."""
    if value is None:
        raise ValueError(f"{name} must be set")
    v = kind(value)
    if v <= 0:
        raise ValueError(
            f"{name} must be a positive {kind.__name__}, got {value!r} "
            f"(explicit zeros are rejected, never silently replaced "
            f"with a default)")
    return v


# ------------------------------------------------------------------- plans


@dataclasses.dataclass
class _RunnerPlan:
    """Everything one env-runner actor needs for its streaming loop."""

    out_spec: _channels.ChannelSpec  # trajectory channel (on learner node)
    rollout: int  # fragment length per batch
    bcast: Dict[str, Any]  # group/world/rank/root/interval/timeout_ms


@dataclasses.dataclass
class _LearnerPlan:
    """Everything one learner rank needs for its consume/update loop."""

    in_specs: List[_channels.ChannelSpec]  # its runners' channels (local)
    report_spec: _channels.ChannelSpec  # learner -> driver, 1 per iteration
    bcast: Dict[str, Any]


# --------------------------------------------------------- learner programs


class _SebulbaProgram:
    """Algorithm-specific learner math, shipped (pickled) to the learner
    actors. Subclasses implement ``update(learner, samples, iteration)``
    where ``samples`` are the iteration's [T, B, ...] rollout dicts from
    this rank's runners (zero-copy views over the trajectory channels —
    valid until the loop acks, after update returns)."""

    broadcast_interval = 1

    def __init__(self, spec, loss_fn, loss_cfg, opt_cfg, device=None):
        self.spec = spec
        self.loss_fn = loss_fn
        self.loss_cfg = dict(loss_cfg)
        self.opt_cfg = dict(opt_cfg)
        # the learners' device: None is the card
        self.device = device

    def make_learner(self, rank: int, world: int, seed: int,
                     group_name: str):
        from ray_tpu_torch.rllib.core.learner import Learner

        return Learner(
            self.spec, self.loss_fn, dict(self.opt_cfg), seed=seed,
            collective_rank=rank, collective_world=world,
            collective_group=group_name, collective_init=True,
            device=actor_device(self.device))

    def iterations_per_step(self, num_runners: int) -> int:
        """How many topology iterations one driver ``step()`` consumes
        (each iteration = one batch per runner). IMPALA overrides this to
        honor ``num_batches_per_iteration``."""
        return 1

    def update(self, learner, samples, iteration: int) -> Dict[str, float]:
        raise NotImplementedError


class ImpalaSebulbaProgram(_SebulbaProgram):
    """One V-trace update per consumed runner batch (the dynamic sync
    loop's math, batch for batch). ``broadcast_interval`` is in UPDATES
    like the dynamic loop's knob; the topology converts it to iteration
    granularity (one iteration = R/L updates per learner — the finest
    schedulable sync point, exact whenever interval divides by R/L).
    ``num_batches_per_iteration`` is honored at the driver: one train()
    consumes ceil(nbpi / R) iterations, so batch and env-step accounting
    matches the dynamic loop whenever nbpi is a multiple of R (the bench
    harnesses pin this) and otherwise ROUNDS UP to whole iterations —
    every runner contributes equally per iteration, so partial
    iterations are not schedulable."""

    def __init__(self, *, spec, loss_fn, loss_cfg, opt_cfg, device=None,
                 broadcast_interval: int = 1,
                 num_batches_per_iteration: int = 1):
        super().__init__(spec, loss_fn, loss_cfg, opt_cfg, device)
        self.broadcast_interval = require_positive(
            "broadcast_interval", broadcast_interval)
        self.num_batches_per_iteration = require_positive(
            "num_batches_per_iteration", num_batches_per_iteration)

    def iterations_per_step(self, num_runners: int) -> int:
        return -(-self.num_batches_per_iteration // num_runners)

    def update(self, learner, samples, iteration: int) -> Dict[str, float]:
        from ray_tpu_torch.rllib.algorithms.impala import to_column_major

        metrics: Dict[str, float] = {}
        for s in samples:
            metrics = learner.update_from_batch(
                to_column_major(s), self.loss_cfg)
        return metrics


class PPOSebulbaProgram(_SebulbaProgram):
    """The dynamic PPO ``training_step`` math verbatim: merge the
    iteration's runner batches, GAE, minibatch epochs over the SAME RNG
    stream (``seed + iteration - 1``), adaptive-KL state held learner-side.
    PPO is on-policy, so ``broadcast_interval`` is pinned to 1 — the
    param broadcast is the iteration barrier that keeps rollouts
    on-policy."""

    broadcast_interval = 1

    def __init__(self, *, spec, loss_fn, loss_cfg, opt_cfg, gamma, lam,
                 seed, num_epochs, minibatch_size, kl_coeff, kl_target,
                 device=None):
        super().__init__(spec, loss_fn, loss_cfg, opt_cfg, device)
        self.gamma = float(gamma)
        self.lam = float(lam)
        self.seed = int(seed)
        self.num_epochs = require_positive("num_epochs", num_epochs)
        self.minibatch_size = require_positive(
            "minibatch_size", minibatch_size)
        self.kl_target = float(kl_target)
        self._kl_coeff = float(kl_coeff)

    def update(self, learner, samples, iteration: int) -> Dict[str, float]:
        from ray_tpu_torch.rllib.algorithms.algorithm import merge_time_major
        from ray_tpu_torch.rllib.algorithms.ppo import prepare_train_batch

        flat = prepare_train_batch(
            merge_time_major(samples), gamma=self.gamma, lam=self.lam)
        n = len(flat["actions"])
        mb = min(self.minibatch_size, n)
        rng = np.random.default_rng(self.seed + iteration - 1)
        last: Dict[str, float] = {}
        for _ in range(self.num_epochs):
            perm = rng.permutation(n)
            for lo in range(0, n - mb + 1, mb):
                idx = perm[lo:lo + mb]
                minibatch = {k: v[idx] for k, v in flat.items()}
                minibatch["kl_coeff"] = np.full(
                    len(idx), self._kl_coeff, np.float32)
                last = learner.update_from_batch(minibatch, self.loss_cfg)
        kl = last.get("mean_kl", 0.0)
        if learner._world > 1:
            # each rank measures mean_kl on its OWN runners' minibatches;
            # adapting per-rank would fork the KL controllers (x1.5 on
            # one rank, x1.0 on another — never resynced, since the
            # param broadcast carries weights, not program state). One
            # scalar mean over the grad group keeps every rank's
            # kl_coeff column identical.
            from ray_tpu_torch.util import collective as col
            from ray_tpu_torch.util.collective.types import ReduceOp

            kl = float(col.allreduce(
                np.asarray([kl], np.float32),
                group_name=learner._collective_group,
                op=ReduceOp.MEAN)[0])
        if kl > 2.0 * self.kl_target:
            self._kl_coeff *= 1.5
        elif kl < 0.5 * self.kl_target:
            self._kl_coeff *= 0.5
        last["kl_coeff"] = self._kl_coeff
        return last


# ----------------------------------------------- param broadcast plumbing


def _leaf_meta(leaf):
    """(shape, numpy dtype) of a numpy or torch leaf."""
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), np.dtype(str(leaf.dtype).split(".")[-1])
    leaf = np.asarray(leaf)
    return leaf.shape, leaf.dtype


def _all_f32(leaves) -> bool:
    return all(_leaf_meta(x)[1] == np.float32 for x in leaves)


def _broadcast_tree_send(col, b: Dict[str, Any], host_tree) -> None:
    """Root side of one param sync: float32 trees (every RLModule)
    coalesce into ONE flat broadcast round; mixed-dtype trees fall back
    to a round per leaf (receivers derive the layout from their own
    identically-structured params, so no header round is needed). Leaves
    go in ``tree_flatten``'s order (dicts by sorted key) on every rank."""
    leaves = [np.ascontiguousarray(x) for x in tree_flatten(host_tree)[0]]
    if _all_f32(leaves):
        flat = (leaves[0].ravel() if len(leaves) == 1
                else np.concatenate([x.ravel() for x in leaves]))
        col.broadcast(flat, src_rank=b["root"], group_name=b["group"],
                      timeout_ms=b["timeout_ms"])
        return
    for leaf in leaves:
        col.broadcast(leaf, src_rank=b["root"], group_name=b["group"],
                      timeout_ms=b["timeout_ms"])


def _broadcast_tree_recv(col, b: Dict[str, Any], template_tree):
    """Receiver side: same rounds as the root, unpacked (host numpy) into
    the template's structure and shapes; the template's leaves may be
    tensors on any device."""
    leaves, treedef = tree_flatten(template_tree)
    if _all_f32(leaves):
        flat = np.asarray(col.broadcast(
            np.empty(0, np.float32), src_rank=b["root"],
            group_name=b["group"], timeout_ms=b["timeout_ms"]))
        out, off = [], 0
        for leaf in leaves:
            shape = _leaf_meta(leaf)[0]
            n = int(np.prod(shape)) if shape else 1
            out.append(np.asarray(flat[off:off + n]).reshape(shape))
            off += n
        if off != flat.size:
            raise ValueError(
                f"broadcast payload carries {flat.size} params, receiver "
                f"template expects {off} — mismatched module specs")
        return tree_unflatten(treedef, out)
    fresh = [np.asarray(col.broadcast(
        np.empty(0, np.float32), src_rank=b["root"], group_name=b["group"],
        timeout_ms=b["timeout_ms"])) for _ in leaves]
    return tree_unflatten(treedef, fresh)


# ------------------------------------------------------- actor-side loops


# (open_local, local_dict, release_pins) run-loop bookkeeping — hoisted
# into _private/channels.py, shared with the streaming data stages
_open_local_factory = _channels.open_local_factory


class _SebulbaRunnerImpl:
    """Env-runner actor body: wraps the standard SingleAgentEnvRunner (so
    sampling math is byte-identical to the dynamic loop) and streams its
    rollouts through a trajectory channel instead of returning them
    through the object store."""

    def __init__(self, env_name, spec, num_envs, seed, env_config,
                 obs_connector, device=None):
        from ray_tpu_torch.rllib.env.single_agent_env_runner import (
            SingleAgentEnvRunner)

        self._runner = SingleAgentEnvRunner(
            env_name, spec, num_envs=num_envs, seed=seed,
            env_config=env_config, obs_connector=obs_connector,
            device=device)

    def ping(self) -> str:
        return "ok"

    def probe_payload_bytes(self, rollout: int) -> int:
        """Packed size of one trajectory payload (content-independent:
        pickle-5 out-of-band buffers dominate) — the driver sizes the
        fixed-shape channels off this, so a too-small buffer can never
        surface as a mid-training write failure."""
        payload = serialization.pack({
            "batch": self._runner.zero_batch(rollout),
            "metrics": {"episode_return_mean": 0.0,
                        "episode_len_mean": 0.0, "num_episodes": 0},
            "iteration": 0, "rpc_calls": 0})
        return len(payload)

    def run_loop(self, plan: _RunnerPlan) -> dict:
        from ray_tpu_torch._private import api, rpc
        from ray_tpu_torch.util import collective as col

        core = api._core
        if core is None:
            raise RuntimeError("sebulba runner loop outside a worker")
        open_local, local, release_pins = _open_local_factory(core)
        remote_specs: List[_channels.ChannelSpec] = []
        try:
            out = _channels.VersionedWriter(core, plan.out_spec, open_local)
            if not out.is_local:
                remote_specs.append(plan.out_spec)
        except BaseException:
            release_pins()
            raise

        def close_everything() -> None:
            _channels.close_channels_nowait(
                core, local.values(), remote_specs)

        b = plan.bcast
        group_ready = [False]

        def recv_params() -> None:
            t0 = flight.now()
            if not group_ready[0]:
                col.init_collective_group(
                    b["world"], b["rank"], backend="host",
                    group_name=b["group"])
                group_ready[0] = True
            self._runner.set_weights(_broadcast_tree_recv(
                col, b, self._runner.params))
            flight.span_since(_F_BCAST, t0)
            _m_broadcasts.inc(labels={"role": "runner"})

        n = 0
        prev_rpc = rpc._m_client_calls.total()
        try:
            # round 0: the learners' init params, before the first sample
            # (the dynamic loop's constructor-time _sync_weights)
            recv_params()
            while True:
                chaos.maybe_crash("worker.podracer_step")
                n += 1
                t0 = flight.now()
                batch = self._runner.sample(plan.rollout)
                flight.span_since(_F_SAMPLE, t0)
                metrics = self._runner.get_metrics()
                now = rpc._m_client_calls.total()
                payload = serialization.pack({
                    "batch": batch, "metrics": metrics, "iteration": n,
                    "rpc_calls": now - prev_rpc})
                prev_rpc = now
                out.write(payload, 2 * n)
                _m_batches.inc()
                if n % b["interval"] == 0:
                    recv_params()
        except ChannelClosedError:
            # normal exit: teardown (or a peer's death) closed the
            # channels; re-fan the close so every peer unwinds
            try:
                close_everything()
            except Exception:
                logger.exception("runner close-on-exit failed")
            return {"batches": n}
        except BaseException:
            try:
                close_everything()
            except Exception:
                logger.exception("runner close-on-error failed")
            raise
        finally:
            try:
                if group_ready[0]:
                    col.destroy_collective_group(b["group"])
            except Exception:
                pass
            release_pins()

    def stop(self) -> None:
        self._runner.stop()


class _SebulbaLearnerImpl:
    """Learner-rank actor body: consumes its runners' trajectory channels,
    runs the algorithm program (grads allreduced over the learner group
    when world > 1), broadcasts fresh params at the interval, and writes
    one report per iteration back to the driver."""

    def __init__(self, program: _SebulbaProgram, rank: int, world: int,
                 seed: int, grad_group: str):
        self._program = program
        self._learner = program.make_learner(rank, world, seed, grad_group)
        self._rank = int(rank)

    def ping(self) -> str:
        return "ok"

    def run_loop(self, plan: _LearnerPlan) -> dict:
        from ray_tpu_torch._private import api, rpc
        from ray_tpu_torch.util import collective as col

        core = api._core
        if core is None:
            raise RuntimeError("sebulba learner loop outside a worker")
        open_local, local, release_pins = _open_local_factory(core)
        remote_specs: List[_channels.ChannelSpec] = []
        try:
            # trajectory channels live on THIS learner's node (reader-side
            # placement), so consuming them is always a local seqlock read
            in_chs = [open_local(s) for s in plan.in_specs]
            report_w = _channels.VersionedWriter(
                core, plan.report_spec, open_local)
            if not report_w.is_local:
                remote_specs.append(plan.report_spec)
        except BaseException:
            release_pins()
            raise

        def close_everything() -> None:
            _channels.close_channels_nowait(
                core, local.values(), remote_specs)

        b = plan.bcast
        group_ready = [False]

        def sync_params() -> None:
            t0 = flight.now()
            if not group_ready[0]:
                col.init_collective_group(
                    b["world"], b["rank"], backend="host",
                    group_name=b["group"])
                group_ready[0] = True
            if b["rank"] == b["root"]:
                _broadcast_tree_send(
                    col, b, to_numpy_tree(self._learner.params))
            else:
                # non-root learners receive too: allreduced updates keep
                # ranks identical already, but taking the root's bytes
                # makes the sync exact by construction
                self._learner.set_weights(_broadcast_tree_recv(
                    col, b, self._learner.params))
            flight.span_since(_F_BCAST, t0)
            _m_broadcasts.inc(labels={"role": "learner"})

        n = 0
        prev_rpc = rpc._m_client_calls.total()
        try:
            sync_params()  # round 0: deliver init params to the runners
            while True:
                chaos.maybe_crash("worker.podracer_step")
                n += 1
                t_iter = time.perf_counter()
                msgs = [serialization.unpack(ch.read(2 * n))
                        for ch in in_chs]
                t_read = time.perf_counter()
                samples = [m["batch"] for m in msgs]
                env_steps = sum(int(np.size(s["rewards"]))
                                for s in samples)
                runner_metrics = [dict(m["metrics"]) for m in msgs]
                runner_rpc = int(sum(int(m["rpc_calls"]) for m in msgs))
                t0 = flight.now()
                metrics = self._program.update(self._learner, samples, n)
                flight.span_since(_F_UPDATE, t0)
                # the update consumed the zero-copy views (device/host
                # copies made); release the writers
                del samples, msgs
                for ch in in_chs:
                    ch.ack(0, 2 * n)
                t_update = time.perf_counter()
                if n % b["interval"] == 0:
                    sync_params()
                _m_iterations.inc()
                now = rpc._m_client_calls.total()
                report = {
                    "iteration": n,
                    "learner_rank": self._rank,
                    "metrics": metrics,
                    "env_steps": env_steps,
                    "runner_metrics": runner_metrics,
                    "runner_rpc_calls": runner_rpc,
                    # this rank's outbound-RPC delta over the whole
                    # iteration (reads, update, allreduce, broadcast) —
                    # the steady-state zero-RPC proof rides in-band
                    "rpc_calls": now - prev_rpc,
                    "iterations_total": _m_iterations.value(),
                    # where the iteration went: waiting on rollouts
                    # (sampler-bound), updating (learner-bound), or
                    # syncing params
                    "wait_s": t_read - t_iter,
                    "update_s": t_update - t_read,
                    "bcast_s": time.perf_counter() - t_update,
                }
                prev_rpc = now
                report_w.write(serialization.pack(report), 2 * n)
        except ChannelClosedError:
            try:
                close_everything()
            except Exception:
                logger.exception("learner close-on-exit failed")
            return {"iterations": n}
        except BaseException:
            try:
                close_everything()
            except Exception:
                logger.exception("learner close-on-error failed")
            raise
        finally:
            try:
                if group_ready[0]:
                    col.destroy_collective_group(b["group"])
            except Exception:
                pass
            release_pins()

    def fetch_weights(self):
        """Host copy of the params (valid before the loop starts or after
        it exits — the run loop dedicates this actor)."""
        return self._learner.get_weights()


_runner_actor_cls = None
_learner_actor_cls = None


def _runner_actor():
    global _runner_actor_cls
    if _runner_actor_cls is None:
        import ray_tpu_torch

        _runner_actor_cls = ray_tpu_torch.remote(_SebulbaRunnerImpl)
    return _runner_actor_cls


def _learner_actor():
    global _learner_actor_cls
    if _learner_actor_cls is None:
        import ray_tpu_torch

        _learner_actor_cls = ray_tpu_torch.remote(_SebulbaLearnerImpl)
    return _learner_actor_cls


# ------------------------------------------------------------ the topology


class SebulbaTopology:
    """Compiled split actor/learner RL topology (module docstring).

    Built by ``Algorithm`` when the config says
    ``.learners(topology="sebulba")``; tests and the chaos soak construct
    it directly to control actor placement::

        topo = SebulbaTopology(config, program,
                               runner_options=[{"resources": {"a": 1}}],
                               learner_options=[{"resources": {"b": 1}}])
        out = topo.step()      # one iteration's merged learner reports
        topo.shutdown()
    """

    def __init__(self, config, program: _SebulbaProgram, *,
                 runner_options: Optional[Sequence[dict]] = None,
                 learner_options: Optional[Sequence[dict]] = None,
                 elastic: bool = False,
                 name: str = "sebulba"):
        import ray_tpu_torch
        from ray_tpu_torch._private import api

        core = api._require_core()
        self._core = core
        R = int(config.num_env_runners)
        if R < 1:
            raise ValueError(
                "topology='sebulba' needs num_env_runners >= 1 (runners "
                "are dedicated streaming actors; there is no local mode)")
        L = max(1, int(config.num_learners))
        if R % L != 0:
            raise ValueError(
                f"num_env_runners ({R}) must divide evenly across "
                f"num_learners ({L}) — every learner rank consumes a "
                f"fixed runner set")
        depth = config.podracer_channel_depth
        if depth is None:
            depth = core.config.podracer_channel_depth
        self._depth = require_positive("podracer_channel_depth", depth)
        interval_updates = require_positive(
            "broadcast_interval",
            getattr(program, "broadcast_interval", 1))
        # the dynamic loop counts broadcast_interval in UPDATES; one
        # sebulba iteration runs R/L updates per learner, so convert to
        # iteration granularity (the finest schedulable sync point —
        # runners can only join a broadcast at batch boundaries). Exact
        # whenever the interval divides by R/L; otherwise the nearest
        # iteration count, never less than every iteration.
        per = R // L
        interval = max(1, round(interval_updates / per))
        self._bcast_timeout_ms = int(1000 * require_positive(
            "podracer_bcast_timeout_s",
            core.config.podracer_bcast_timeout_s, kind=float))
        rollout = require_positive(
            "rollout_fragment_length", config.rollout_fragment_length)
        self._R, self._L, self._interval = R, L, interval
        # one driver step() consumes this many iterations, so train()
        # batch / env-step accounting matches the dynamic loop's
        # num_batches_per_iteration
        self._iters_per_step = require_positive(
            "iterations_per_step", program.iterations_per_step(R))
        self._it = 0
        # channel-version iteration counter: tracks self._it except that
        # an elastic heal resets it with the rebuilt channels
        self._vit = 0
        self._dead = False
        self._torn = False
        self._teardown_lock = threading.Lock()
        self._all_specs: List[_channels.ChannelSpec] = []
        self._local_channels: Dict[bytes, _channels.LocalChannel] = {}
        self._loop_refs: List[Any] = []
        self._actor_info: Dict[str, dict] = {}
        self._actor_subs: Dict[str, Any] = {}
        self._slot_of_hex: Dict[str, tuple] = {}
        self._runners: List[Any] = []
        self._learners: List[Any] = []
        self._name = name
        self._cfg = config
        self._runner_options = runner_options

        # ---- elastic membership: env-runners respawn and
        # rejoin over the interval broadcast; learner loss stays terminal
        # (a learner's optimizer state is not replayable)
        self._elastic = bool(elastic)
        self._note_lock = threading.Lock()
        self._lost_hexes: set = set()
        self._heal_pending = False
        self._heal_t0 = 0.0
        self._epoch = 0
        self._sup = None
        if self._elastic:
            from ray_tpu_torch._private.elastic import ElasticSupervisor

            self._sup = ElasticSupervisor(name=name)

        # per-topology token: two concurrently-live topologies must never
        # meet in collective rendezvous (the pipeline trainer's rule)
        token = uuid.uuid4().hex[:8]
        self._bcast_group = f"{name}.{token}.bcast"
        grad_group = f"{name}.{token}.grads"

        runner_cls = _runner_actor()
        learner_cls = _learner_actor()

        def options_for(cls, opts, i):
            o = dict(opts[i]) if opts and i < len(opts) and opts[i] else {}
            for k, v in actor_options(program.device).items():
                o.setdefault(k, v)
            return cls.options(**o)

        spec = program.spec
        self._spec = spec
        # everything past this point can strand live actors on failure
        # (ActorHandles have no GC-kill), so ANY mid-build error unwinds
        # through shutdown() — which kills whatever was already created
        try:
            self._runners = [self._spawn_runner(i) for i in range(R)]
            self._learners = [
                options_for(learner_cls, learner_options, i).remote(
                    program, i, L, config.seed, grad_group)
                for i in range(L)]
            for i, a in enumerate(self._runners):
                self._slot_of_hex[a._actor_id.hex()] = ("runner", i)
            for l, a in enumerate(self._learners):
                self._slot_of_hex[a._actor_id.hex()] = ("learner", l)
            ray_tpu_torch.get([a.ping.remote()
                               for a in self._runners + self._learners],
                              timeout=180)

            # fixed-shape channel sizing off one packed zero batch (+25%
            # and a floor of slack for the metrics dict)
            probe = int(ray_tpu_torch.get(
                self._runners[0].probe_payload_bytes.remote(rollout),
                timeout=120))
            self._buffer = probe + probe // 4 + 64 * 1024
            self._build_channels(config)
        except BaseException:
            try:
                self.shutdown()
            except Exception:
                logger.debug("sebulba build unwind failed", exc_info=True)
            raise

    # -- properties the microbenchmark fallback guards key on

    @property
    def is_channel_backed(self) -> bool:
        return bool(self._all_specs) and not self._dead

    @property
    def channel_depth(self) -> int:
        return self._depth

    @property
    def num_runners(self) -> int:
        return self._R

    @property
    def num_learners(self) -> int:
        return self._L

    # -- build

    def _spawn_runner(self, i: int):
        """Create env-runner i — build and elastic-respawn share the
        exact spawn (seed + 1000*i keeps the replacement on the SAME
        sample stream slot as the runner it replaces)."""
        cls = _runner_actor()
        opts = self._runner_options
        o = dict(opts[i]) if opts and i < len(opts) and opts[i] else {}
        cfg = self._cfg
        for k, v in actor_options(cfg.env_runner_device).items():
            o.setdefault(k, v)
        return cls.options(**o).remote(
            cfg.env, self._spec, cfg.num_envs_per_env_runner,
            cfg.seed + 1000 * i, cfg.env_config,
            cfg.env_to_module_connector,
            device=actor_device(cfg.env_runner_device))

    def _bcast_name(self) -> str:
        """The bcast group's wire name for the current elastic epoch: a
        killed member never destroys its imperative rendezvous state, so
        each heal moves the whole world to a fresh name instead of
        re-initializing over the old generation's leftovers."""
        if self._epoch == 0:
            return self._bcast_group
        return f"{self._bcast_group}.e{self._epoch}"

    def _create_channel(self, node_addr, participants, *, depth: int,
                        buffer: int) -> _channels.ChannelSpec:
        core = self._core
        spec = _channels.create_channel(
            core, node_addr, buffer, depth, 1, participants)
        self._all_specs.append(spec)
        if tuple(node_addr) == tuple(core.supervisor_addr):
            self._local_channels[spec.key()] = _channels.LocalChannel(
                core.arena, spec)
        return spec

    def _build_channels(self, config) -> None:
        core = self._core
        driver_node = tuple(core.supervisor_addr)
        if core.arena is None:
            raise RuntimeError(
                "sebulba channels need a driver attached to a node arena")
        ctrl = core.clients.get(core.controller_addr)
        views = core._run(ctrl.call("node_views"))
        for a in self._runners + self._learners:
            hexid = a._actor_id.hex()
            self._actor_info[hexid] = _channels.resolve_actor_placement(
                core, a._actor_id, views)

        # any participant's death closes everything: learners are serially
        # fed by their runners and all ranks meet at the broadcast, so no
        # subset can make progress alone
        participants = {core._store_client_id}
        for info in self._actor_info.values():
            participants.add(info["worker_id_hex"])
            participants.add(f"node:{info['node_id_hex']}")

        def node_of(actor):
            return self._actor_info[actor._actor_id.hex()]["node_addr"]

        per = self._R // self._L
        world = self._L + self._R

        def bcast(rank):
            return {"group": self._bcast_name(), "world": world,
                    "rank": rank, "root": 0, "interval": self._interval,
                    "timeout_ms": self._bcast_timeout_ms}

        # trajectory channels live on the READER's (learner's) node: a
        # same-node runner writes the seqlock directly, a cross-node
        # runner pushes through the chunked mirror path
        traj = [self._create_channel(
            node_of(self._learners[r // per]), participants,
            depth=self._depth, buffer=self._buffer)
            for r in range(self._R)]
        # reports carry one small stats dict per iteration; a shallow
        # slot ring (not depth 1) lets learners run a few iterations
        # ahead of the driver draining reports, so the driver's poll
        # cadence never paces the learner ranks
        reports = [self._create_channel(
            driver_node, participants, depth=min(self._depth, 4),
            buffer=256 * 1024)
            for _ in range(self._L)]
        self._report_readers = [
            self._local_channels[sp.key()] for sp in reports]

        for hexid in self._actor_info:
            cb = self._make_actor_cb(hexid)
            self._actor_subs[hexid] = cb
            core.subscribe("actor:" + hexid, cb)

        rollout = int(config.rollout_fragment_length)
        for r, actor in enumerate(self._runners):
            self._loop_refs.append(actor.run_loop.remote(_RunnerPlan(
                out_spec=traj[r], rollout=rollout,
                bcast=bcast(self._L + r))))
        for l, actor in enumerate(self._learners):
            self._loop_refs.append(actor.run_loop.remote(_LearnerPlan(
                in_specs=traj[l * per:(l + 1) * per],
                report_spec=reports[l], bcast=bcast(l))))

    # -- failure fan-out (the pipeline trainer's shape)

    def _make_actor_cb(self, hexid: str):
        def cb(message) -> None:
            if self._torn or not isinstance(message, dict):
                return
            if message.get("state") in ("DEAD", "RESTARTING"):
                self._note_death(hexid)
        return cb

    def _note_death(self, hexid: str) -> None:
        if not self._elastic:
            if self._dead:
                return
            self._close_for_failure()
            return
        with self._note_lock:
            if not self._heal_pending:
                self._heal_pending = True
                self._heal_t0 = time.monotonic()
            self._lost_hexes.add(hexid)
        if self._slot_of_hex.get(hexid):
            from ray_tpu_torch._private.elastic import m_departures

            m_departures.inc(labels={"group": self._bcast_group})
        self._close_for_failure()

    def _close_for_failure(self) -> None:
        self._dead = True
        _channels.close_channels_nowait(
            self._core, self._local_channels.values(), self._all_specs)

    def _surface_failure(self, closed: ChannelClosedError):
        self._close_for_failure()
        _channels.surface_loop_failure(self._core, self._loop_refs, closed)

    # -- elastic heal (the step() boundary, never mid-iteration)

    def _heal(self) -> None:
        while True:
            with self._note_lock:
                if not self._heal_pending:
                    return
                self._heal_pending = False
                lost, self._lost_hexes = self._lost_hexes, set()
            self._heal_once(lost)

    def _heal_once(self, lost: set) -> None:
        import ray_tpu_torch

        from ray_tpu_torch._private.elastic import m_reshards

        core = self._core
        t0 = self._heal_t0
        slots = sorted(self._slot_of_hex[h] for h in lost
                       if h in self._slot_of_hex)
        dead_learners = [i for (kind, i) in slots if kind == "learner"]
        if dead_learners:
            raise RuntimeError(
                f"sebulba {self._name}: learner rank(s) {dead_learners} "
                f"died — learner optimizer state is not replayable "
                f"without a checkpoint; treating the outage as terminal")
        dead_runners = [i for (kind, i) in slots if kind == "runner"]
        logger.info("sebulba %s: healing after loss of runner(s) %s",
                    self._name, dead_runners or sorted(lost))

        # 1. drain the old world
        for ch in self._local_channels.values():
            try:
                ch.close()
            except Exception:
                pass
        for ref in self._loop_refs:
            try:
                core.get([ref], timeout=self._sup.resize_timeout_s)
            except Exception:
                pass
        for hexid, cb in self._actor_subs.items():
            try:
                core.unsubscribe("actor:" + hexid, cb)
            except Exception:
                pass
        self._actor_subs.clear()
        try:
            _channels.free_and_unpin_specs(core, self._all_specs)
        except Exception:
            logger.debug("elastic spec free failed", exc_info=True)
        self._all_specs = []
        self._local_channels = {}
        self._loop_refs = []
        self._actor_info = {}

        # 2. respawn dead runners (budget + backoff per slot)
        for i in dead_runners:
            old_hex = self._runners[i]._actor_id.hex()
            self._slot_of_hex.pop(old_hex, None)
            a = self._sup.respawn(
                ("runner", i), lambda i=i: self._spawn_runner(i))
            self._runners[i] = a
            self._slot_of_hex[a._actor_id.hex()] = ("runner", i)
        if dead_runners:
            ray_tpu_torch.get([self._runners[i].ping.remote()
                               for i in dead_runners], timeout=120)

        # 3. move the whole world to the next broadcast epoch and
        # restart the loops: iteration 0's param sync (learner rank 0 ->
        # everyone) IS the replacement's rejoin — current weights over
        # collective.broadcast, no checkpoint restore
        self._epoch += 1
        m_reshards.inc(labels={"group": self._bcast_group})
        self._vit = 0
        try:
            self._build_channels(self._cfg)
        except BaseException:
            self._close_for_failure()
            raise
        with self._note_lock:
            if not self._heal_pending:
                self._dead = False
        self._sup.rejoin_span(t0)
        logger.info("sebulba %s: healed (%d respawn(s), epoch %d)",
                    self._name, len(dead_runners), self._epoch)

    # -- stepping

    def step(self) -> Dict[str, Any]:
        """One driver step: read every learner rank's report for the next
        ``iterations_per_step`` iterations (shared-memory seqlock reads —
        the driver's entire steady-state cost) and merge. Raises cleanly
        if the topology died."""
        if self._elastic and self._heal_pending and not self._torn:
            self._heal()
        if self._dead:
            raise ChannelClosedError("sebulba topology was torn down")
        reports: List[dict] = []
        try:
            for _ in range(self._iters_per_step):
                rv = 2 * (self._vit + 1)
                for ch in self._report_readers:
                    view = ch.read(rv)
                    rep = serialization.unpack(bytes(view))
                    del view
                    ch.ack(0, rv)
                    reports.append(rep)
                self._it += 1
                self._vit += 1
        except ChannelClosedError as e:
            self._surface_failure(e)
        env_steps = int(sum(r["env_steps"] for r in reports))
        _m_env_steps.inc(env_steps)
        keys = reports[0]["metrics"].keys()
        metrics = {k: float(np.mean([r["metrics"][k] for r in reports]))
                   for k in keys}
        returns: List[float] = []
        lens: List[float] = []
        episodes = 0
        for rep in reports:
            for m in rep["runner_metrics"]:
                cnt = int(m.get("num_episodes", 0))
                episodes += cnt
                if cnt and m.get("episode_return_mean") is not None:
                    returns.extend([m["episode_return_mean"]] * cnt)
                    lens.extend([m["episode_len_mean"]] * cnt)
        return {
            "metrics": metrics,
            "env_steps": env_steps,
            "reports": reports,
            "episode_return_mean": (float(np.mean(returns))
                                    if returns else None),
            "episode_len_mean": float(np.mean(lens)) if lens else None,
            "num_episodes": episodes,
        }

    # -- introspection / teardown

    def fetch_weights(self, learner_rank: int = 0):
        """Learner params (after shutdown(kill_actors=False) — the run
        loop dedicates the actor while the topology lives)."""
        import ray_tpu_torch

        return ray_tpu_torch.get(
            self._learners[learner_rank].fetch_weights.remote(),
            timeout=120)

    def shutdown(self, kill_actors: bool = True,
                 timeout: float = 30) -> Dict[str, Any]:
        """Close every channel, drain the loops, release the pins,
        (optionally) kill the actors. Idempotent."""
        self._dead = True
        with self._teardown_lock:
            if self._torn:
                return {}
            self._torn = True
        core = self._core
        for ch in self._local_channels.values():
            try:
                ch.close()
            except Exception:
                pass
        for hexid, cb in self._actor_subs.items():
            try:
                core.unsubscribe("actor:" + hexid, cb)
            except Exception:
                pass
        self._actor_subs = {}

        _channels.close_specs(core, self._all_specs)
        stats: Dict[str, Any] = {"loops": []}
        for ref in self._loop_refs:
            try:
                stats["loops"].append(core.get([ref], timeout=timeout)[0])
            except Exception:
                stats["loops"].append(None)
        _channels.free_and_unpin_specs(core, self._all_specs)
        if kill_actors:
            import ray_tpu_torch

            for a in self._runners + self._learners:
                try:
                    ray_tpu_torch.kill(a)
                except Exception:
                    pass
        return stats

    def __del__(self):
        try:
            self.shutdown()
        except Exception:
            pass


# ----------------------------------------------------------------- Anakin


class AnakinTrainer:
    """Podracer's co-located topology: a vectorized env and the learner in
    ONE process on one device (the card unless ``device="cpu"``). An
    iteration steps the env ``rollout`` times inside the policy rollout
    (``synthetic_atari.torch_step``, actions drawn from a generator on the
    device), then runs the actor-critic update in the V-trace shape
    (on-policy here, so rho == c == 1 by construction): the loss, the
    gradients and Adam. The frame bank, the step counters, the
    observations, the noise and the rewards stay on the device, and
    neither the rollout nor the update reads anything back to the host;
    ``train`` reads the metrics once, after its last iteration.

        trainer = AnakinTrainer(num_envs=64, rollout=16)
        out = trainer.train(iterations=100)   # {"total_loss", ...,
                                              #  "env_steps_per_sec"}

    Pass a small ``frames`` bank + an MLP ``module_spec`` for cheap runs;
    the default is the 84x84x4 Nature-CNN Atari shape. ``collect``,
    ``loss`` and ``learn`` are the iteration's parts: a trajectory, the
    loss of a trajectory at given params, and one step from a trajectory.
    """

    def __init__(self, *, num_envs: int = 32, rollout: int = 16,
                 episode_len: int = 1000, frames=None, module_spec=None,
                 num_actions: int = 6, lr: float = 3e-4,
                 gamma: float = 0.99, entropy_coeff: float = 0.01,
                 vf_loss_coeff: float = 0.5, grad_clip: float = 0.5,
                 seed: int = 0, device=None):
        from ray_tpu_torch.rllib.core.rl_module import (RLModuleSpec,
                                                        make_module)
        from ray_tpu_torch.rllib.env import synthetic_atari as sa

        num_envs = require_positive("num_envs", num_envs)
        rollout = require_positive("rollout", rollout)
        episode_len = require_positive("episode_len", episode_len)
        self.device = resolve_device(device)
        frames_np = (sa.frame_bank(seed) if frames is None
                     else np.asarray(frames))
        obs_shape = tuple(int(x) for x in frames_np.shape[1:])
        if module_spec is None:
            module_spec = RLModuleSpec(
                obs_dim=int(np.prod(obs_shape)), num_actions=num_actions,
                obs_shape=obs_shape)
        self.spec = module_spec
        self.module = make_module(module_spec)
        self.num_envs, self.rollout = num_envs, rollout
        self.episode_len = episode_len
        self.gamma = gamma
        self.entropy_coeff = entropy_coeff
        self.vf_loss_coeff = vf_loss_coeff
        self.params = trainable(self.module.init_params(seed, self.device))
        self._opt = make_optimizer(lr, grad_clip)
        self.opt_state = self._opt.init(self.params)
        self._gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        self._frames = torch.from_numpy(frames_np).to(self.device)
        self._t = torch.zeros(num_envs, dtype=torch.int32,
                              device=self.device)
        self._obs = self._frames[0].expand(
            (num_envs,) + obs_shape).clone()
        self._conv = len(module_spec.obs_shape) == 3
        self._uint8 = frames_np.dtype == np.uint8
        self._iterations = 0
        self._env_steps = 0

    def _prep(self, obs: torch.Tensor) -> torch.Tensor:
        if self._conv:
            return obs  # the conv stem normalizes uint8 itself
        x = obs.reshape(obs.shape[0], -1).to(torch.float32)
        return x / 255.0 if self._uint8 else x

    @torch.no_grad()
    def collect(self) -> Dict[str, torch.Tensor]:
        """One rollout of ``rollout`` steps from the env state, which it
        advances: [T, B] ``obs`` (the observation each action saw),
        ``actions``, behaviour ``logp`` and ``values``, ``rewards``,
        ``truncs``, and ``last_obs`` [B] (the bootstrap observation)."""
        from ray_tpu_torch.rllib.core.rl_module import sample_categorical
        from ray_tpu_torch.rllib.env import synthetic_atari as sa

        keys = ("obs", "actions", "logp", "values", "rewards", "truncs")
        steps = {k: [] for k in keys}
        t, obs = self._t, self._obs
        for _ in range(self.rollout):
            logits, value = self.module.forward_train(self.params,
                                                      self._prep(obs))
            action = sample_categorical(logits, self._gen)
            logp = torch.log_softmax(logits, -1).gather(
                -1, action[:, None])[:, 0]
            t1, obs1, reward, trunc = sa.torch_step(
                self._frames, self.episode_len, t, action)
            t1, obs1 = sa.torch_reset(self._frames, t1, obs1, trunc)
            for k, v in zip(keys, (obs, action, logp, value, reward,
                                   trunc)):
                steps[k].append(v)
            t, obs = t1, obs1
        self._t, self._obs = t, obs
        traj = {k: torch.stack(v) for k, v in steps.items()}
        traj["last_obs"] = obs
        return traj

    def loss(self, params, traj: Dict[str, torch.Tensor]):
        """(total, metrics) of a trajectory at ``params``: the V-trace
        actor-critic loss. Gradients flow only through this recompute;
        the V-trace targets are detached."""
        from ray_tpu_torch.rllib.utils.advantages import vtrace_returns

        T, B = traj["actions"].shape
        obs_seq = traj["obs"]
        flat = self._prep(obs_seq.reshape((T * B,) + obs_seq.shape[2:]))
        logits, values = self.module.forward_train(params, flat)
        logp_all = torch.log_softmax(logits, -1)
        tlogp = logp_all.gather(
            -1, traj["actions"].reshape(T * B)[:, None])[:, 0]
        tm = lambda x: x.reshape(T, B)  # noqa: E731
        with torch.no_grad():
            _, boot = self.module.forward_train(
                params, self._prep(traj["last_obs"]))
            vs, pg_adv = vtrace_returns(
                traj["logp"], tm(tlogp), traj["rewards"], tm(values), boot,
                torch.zeros_like(traj["truncs"]), traj["truncs"],
                gamma=self.gamma)
        pi_loss = -torch.mean(tm(tlogp) * pg_adv)
        vf_loss = 0.5 * torch.mean((tm(values) - vs) ** 2)
        probs = torch.softmax(logits, -1)
        entropy = -torch.mean(torch.sum(probs * logp_all, dim=-1))
        total = (pi_loss + self.vf_loss_coeff * vf_loss
                 - self.entropy_coeff * entropy)
        return total, {"policy_loss": pi_loss, "vf_loss": vf_loss,
                       "entropy": entropy}

    def learn(self, traj: Dict[str, torch.Tensor]):
        """One update from a trajectory: loss, gradients, Adam (in place).
        Returns (loss, metrics) as tensors on the device, unread."""
        from ray_tpu_torch.models.transformer import _leaves

        loss, metrics = self.loss(self.params, traj)
        grads = torch.autograd.grad(loss, _leaves(self.params))
        self._opt.update(list(grads), self.opt_state, self.params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["reward_mean"] = torch.mean(traj["rewards"])
        return loss.detach(), metrics

    def update(self):
        """One iteration: ``learn(collect())``."""
        return self.learn(self.collect())

    def train(self, iterations: int = 1) -> Dict[str, Any]:
        iterations = require_positive("iterations", iterations)
        t0 = time.perf_counter()
        for _ in range(iterations):
            loss, metrics = self.update()
        # the one host read: every metric of the last iteration together
        names = list(metrics)
        values = torch.stack([metrics[k] for k in names] + [loss]).tolist()
        dt = time.perf_counter() - t0
        steps = iterations * self.rollout * self.num_envs
        self._iterations += iterations
        self._env_steps += steps
        out = dict(zip(names, values[:-1]))
        out.update({
            "total_loss": values[-1],
            "training_iteration": self._iterations,
            "env_steps": steps,
            "num_env_steps_sampled_lifetime": self._env_steps,
            "env_steps_per_sec": steps / max(dt, 1e-9),
        })
        return out

