"""Learner + LearnerGroup: the SGD side of the training split.

Counterpart: ``ray_tpu/rllib/core/learner.py``. A learner owns a module's
params and its optimizer state on its device (the card unless the caller
names the CPU); ``update_from_batch`` runs the algorithm's loss, the
gradients and the optimizer, then reads every metric back in ONE
device-to-host copy. With several learner actors, the gradients are
averaged over the learner group's host collective
(``train/_internal/gradients.py::GradientAverager``) between the
gradients and the optimizer, so every learner applies identical updates.

The optimizer is the JAX package's ``optax.chain(clip_by_global_norm(clip),
adam(lr))`` written out as ``models/training.py``'s chain: the clip scales
only when the global norm is at least ``clip`` (no epsilon), Adam with b1
0.9, b2 0.999, eps 1e-8, the bias corrections at t = count + 1, no weight
decay, at a constant rate.

Weights and state leave a learner as host numpy arrays under the module's
names (``get_weights``, ``get_state``), as the JAX learner's do; the state's
``opt_state`` is ``{"count", "mu", "nu"}`` (``_private/convert.py`` carries
a JAX learner's optax state across).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models.training import (AdamW, AdamWState,
                                           OptimizerConfig)
from ray_tpu_torch.models.transformer import _leaves, map_params
from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec, make_module


def make_optimizer(lr: float, grad_clip: float) -> AdamW:
    """``optax.chain(clip_by_global_norm(grad_clip), adam(lr))``: the
    port's AdamW chain with b2 0.999, no weight decay, and a schedule that
    is ``lr`` at every count (a cosine whose floor is its peak)."""
    return AdamW(OptimizerConfig(
        learning_rate=lr, weight_decay=0.0, b1=0.9, b2=0.999,
        grad_clip=grad_clip, warmup_steps=0, decay_steps=1,
        min_lr_ratio=1.0))


def is_card(device) -> bool:
    """Whether a role's device is a card: ``None`` (the default) or a
    CUDA device."""
    return device is None or torch.device(device).type == "cuda"


def actor_options(device) -> Dict[str, Any]:
    """Resources of an actor role on ``device``: a whole card, or one CPU
    as the JAX package asks for every role."""
    return {"num_gpus": 1} if is_card(device) else {"num_cpus": 1}


def actor_device(device):
    """The device an actor role is built with: its worker's own card
    (``None``) when the role runs on a card, else the device named."""
    return None if is_card(device) else device


def to_numpy_tree(tree):
    """Host copies of a params tree's tensors, as numpy arrays."""
    return map_params(
        lambda _p, t: t.detach().to("cpu", copy=True).numpy(), tree)


def to_tensor(v, device) -> torch.Tensor:
    """A batch column or leaf on ``device``, in its own dtype. A read-only
    numpy view (a channel slot) is copied rather than shared."""
    if isinstance(v, torch.Tensor):
        return v.to(device)
    v = np.asarray(v)
    if device.type == "cpu" and not v.flags.writeable:
        v = v.copy()
    return torch.as_tensor(v, device=device)


def trainable(params):
    """The params tree, each leaf marked for autograd (in place)."""
    return map_params(lambda _p, t: t.requires_grad_(True), params)


def params_from_numpy(tree, device, requires_grad: bool = False):
    return map_params(
        lambda _p, a: to_tensor(np.array(a, np.float32), device)
        .requires_grad_(requires_grad), tree)


class Learner:
    """Owns module params + optimizer state; ``update_from_batch`` runs one
    step. The loss comes from the algorithm (``loss_fn(module, params,
    batch, cfg) -> (loss, metrics)``)."""

    def __init__(self, spec: RLModuleSpec, loss_fn: Callable,
                 optimizer_config: Optional[Dict[str, Any]] = None,
                 seed: int = 0, collective_rank: Optional[int] = None,
                 collective_world: int = 1,
                 collective_group: str = "learners",
                 collective_init: bool = False,
                 device=None):
        # a card role in a process that sees no card raises here
        self.device = resolve_device(device)
        self.module = make_module(spec)
        self.loss_fn = loss_fn
        cfg = dict(optimizer_config or {})
        self._optimizer = make_optimizer(cfg.get("lr", 5e-4),
                                         cfg.get("grad_clip", 0.5))
        self.params = trainable(self.module.init_params(seed, self.device))
        self.opt_state = self._optimizer.init(self.params)
        self._rank = collective_rank
        self._world = collective_world
        # which collective group the grad allreduce rides: the default
        # "learners" group is declared by the LearnerGroup driver; the
        # podracer topology passes its own token-unique group name and
        # collective_init=True (imperative, idempotent member-side init)
        self._collective_group = collective_group
        self._collective_init = collective_init
        # the averager (persistent landing buffers, copy-on-wait), built
        # lazily so it binds to the driver-declared "learners" group
        self._grad_avg = None

    def _batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: to_tensor(v, self.device) for k, v in batch.items()}

    def compute_grads(self, batch: Dict[str, Any],
                      loss_cfg: Dict[str, Any]):
        """(loss, metrics, grads) at the current params, nothing applied."""
        leaves = _leaves(self.params)
        loss, metrics = self.loss_fn(self.module, self.params,
                                     self._batch(batch), loss_cfg)
        # a leaf the loss never reads (DQN's value head) gets a zero grad,
        # as under jax.grad
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss, metrics, [torch.zeros_like(p) if g is None else g
                               for p, g in zip(leaves, grads)]

    def update_from_batch(self, batch: Dict[str, np.ndarray],
                          loss_cfg: Dict[str, Any]) -> Dict[str, float]:
        loss, metrics, grads = self.compute_grads(batch, loss_cfg)
        if self._world > 1:
            # the allreduce runs between the grads and the optimizer
            grads = self._allreduce_grads(grads)
        self._optimizer.update(grads, self.opt_state, self.params)
        # ONE device-to-host copy for every metric scalar: a float() per
        # entry costs a blocking transfer each
        names = list(metrics)
        values = torch.stack(
            [metrics[k].detach().to(torch.float32).reshape(())
             for k in names] + [loss.detach().reshape(())]).tolist()
        out = dict(zip(names, values[:-1]))
        out["total_loss"] = values[-1]
        return out

    def _allreduce_grads(self, grads: List[torch.Tensor]):
        # the mean over the group through the shared GradientAverager
        # (persistent landing buffers, buckets in reverse-backward order;
        # op="mean" pre-scales into the pack copy)
        if self._grad_avg is None:
            from ray_tpu_torch.train._internal.gradients import \
                GradientAverager

            self._grad_avg = GradientAverager(
                group_name=self._collective_group, world_size=self._world,
                rank=self._rank if self._rank is not None else 0,
                init_group=self._collective_init)
        return self._grad_avg.average(grads)

    # --------------------------------------------------------------- state

    def get_weights(self) -> Dict[str, Any]:
        return to_numpy_tree(self.params)

    def set_weights(self, weights: Dict[str, Any]) -> None:
        self.params = params_from_numpy(weights, self.device, True)

    def get_state(self) -> Dict[str, Any]:
        st = self.opt_state
        return {"params": to_numpy_tree(self.params),
                "opt_state": {"count": int(st.count),
                              "mu": to_numpy_tree(st.mu),
                              "nu": to_numpy_tree(st.nu)}}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.params = params_from_numpy(state["params"], self.device, True)
        st = state["opt_state"]
        self.opt_state = AdamWState(
            count=int(st["count"]),
            mu=params_from_numpy(st["mu"], self.device),
            nu=params_from_numpy(st["nu"], self.device))

    def device_name(self) -> str:
        return str(next(iter(_leaves(self.params))).device)


class LearnerGroup:
    """N learner actors with collective grad-allreduce, or one local
    learner when ``num_learners`` is 0. A learner actor on a card asks the
    runtime for ``num_gpus=1``; one on the CPU for ``num_cpus=1``."""

    def __init__(self, spec: RLModuleSpec, loss_fn: Callable,
                 optimizer_config: Optional[Dict[str, Any]] = None,
                 num_learners: int = 0, seed: int = 0,
                 batch_connector=None, device=None):
        # learner connector (rllib/connectors.py): host-side batch
        # transform applied once, before row-sharding to learner actors
        self._batch_connector = batch_connector
        self._local: Optional[Learner] = None
        self._actors: List[Any] = []
        if num_learners <= 0:
            self._local = Learner(spec, loss_fn, optimizer_config, seed,
                                  device=device)
        else:
            actor_cls = ray_tpu_torch.remote(Learner)
            self._actors = [
                actor_cls.options(**actor_options(device)).remote(
                    spec, loss_fn, optimizer_config, seed,
                    collective_rank=i, collective_world=num_learners,
                    device=actor_device(device))
                for i in range(num_learners)
            ]
            if num_learners > 1:
                from ray_tpu_torch.util import collective

                collective.create_collective_group(
                    self._actors, num_learners,
                    list(range(num_learners)), backend="host",
                    group_name="learners")

    @property
    def is_local(self) -> bool:
        return self._local is not None

    def update_from_batch(self, batch: Dict[str, np.ndarray],
                          loss_cfg: Dict[str, Any]) -> Dict[str, float]:
        if self._batch_connector is not None:
            batch = self._batch_connector(dict(batch))
        if self._local is not None:
            return self._local.update_from_batch(batch, loss_cfg)
        n = len(self._actors)
        if n == 1:
            return ray_tpu_torch.get(
                self._actors[0].update_from_batch.remote(batch, loss_cfg))
        # shard the batch across learners; allreduce makes results identical
        rows = len(next(iter(batch.values())))
        cuts = [round(i * rows / n) for i in range(n + 1)]
        refs = [
            a.update_from_batch.remote(
                {k: v[cuts[i]:cuts[i + 1]] for k, v in batch.items()},
                loss_cfg)
            for i, a in enumerate(self._actors)
        ]
        metrics = ray_tpu_torch.get(refs)
        return {k: float(np.mean([m[k] for m in metrics]))
                for k in metrics[0]}

    def get_weights(self) -> Dict[str, Any]:
        if self._local is not None:
            return self._local.get_weights()
        return ray_tpu_torch.get(self._actors[0].get_weights.remote())

    def get_state(self) -> Dict[str, Any]:
        if self._local is not None:
            return self._local.get_state()
        return ray_tpu_torch.get(self._actors[0].get_state.remote())

    def set_state(self, state) -> None:
        if self._local is not None:
            self._local.set_state(state)
        else:
            ray_tpu_torch.get([a.set_state.remote(state)
                               for a in self._actors])

    def shutdown(self) -> None:
        for a in self._actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass
        self._actors = []
