"""JAX params <-> the port's tensors.

``from_jax`` takes the params of ``ray_tpu.models.transformer.init_params``
as numpy arrays (``jax.tree.map(np.asarray, params)``), with the blocks
either scan-stacked (each leaf has a leading layer axis) or per-layer under
``"0".."L-1"``, and returns the port's params: the same names and layouts,
the blocks as a list of per-layer dicts, float32 CPU tensors as given.
``to_jax`` is its inverse. Both take a pipeline chunk shard as well (any
dict with ``"blocks"``, ``presets.partition_pipeline_params``'s shape), and
``shards_from_jax``/``shards_to_jax`` carry a whole list of chunk shards,
each chunk either one shard or a list of tensor-parallel rank shards.

``train_state_from_jax`` carries a JAX ``TrainState`` across (params, the
optax AdamW moments ``mu``/``nu``, its count, and the step), so a run that
resumes from JAX state takes the same next step; ``train_state_to_jax`` is
its inverse, filling a JAX state of numpy leaves given as the template.
The optax states are found by their field names, never by their types.
Both take a meshed state too: ``train_state_from_jax(..., mesh=, specs=)``
places each leaf as a DTensor (every rank keeps its own shard of the whole
numpy leaf it was given), and ``train_state_to_jax`` gathers a DTensor
leaf with ``full_tensor()``, a collective every rank of the mesh calls.

``rl_params_from_jax``/``rl_params_to_jax`` carry an RLModule's params
(``ray_tpu.rllib``'s ``init_params``, as numpy arrays) across: the same
names, dense weights as they are, conv weights HWIO <-> OIHW; both sides
are host numpy trees, as ``Learner.get_weights``/``set_weights`` take
them. ``rl_learner_state_from_jax`` turns a JAX ``Learner.get_state()``
(params and the optax chain's state of numpy leaves) into the port
learner's state (``{"params", "opt_state": {"count", "mu", "nu"}}``), the
Adam state found by field name; ``rl_learner_state_to_jax`` is its inverse
into a JAX state given as the template. SAC's and CQL's tree (``actor``,
``q1``, ``q2`` and the 0-d ``log_alpha``) goes through the same functions.
``dreamer_state_from_jax``/``dreamer_state_to_jax`` carry a DreamerV3's
params and its three Adam states (``wm``, ``actor``, ``critic``).

This module never imports JAX or optax; numpy is the common ground.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models.training import AdamWState, TrainState
from ray_tpu_torch.models.transformer import map_params


def _tensor(path: str, a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def from_jax(tree: Dict[str, Any]) -> Dict[str, Any]:
    """JAX param tree (or chunk shard) of numpy arrays -> the port's, its
    keys in the given order."""
    return {k: _blocks_from_jax(v) if k == "blocks"
            else map_params(_tensor, v) for k, v in tree.items()}


def _blocks_from_jax(blocks) -> list:
    if all(k.isdigit() for k in blocks):
        return [map_params(_tensor, blocks[str(i)])
                for i in range(len(blocks))]
    n = len(blocks["attn"]["wq"])

    def layer(i):
        return map_params(lambda p, a: _tensor(p, np.asarray(a)[i]), blocks)

    return [layer(i) for i in range(n)]


def shards_from_jax(shards) -> list:
    """JAX ``partition_pipeline_params`` output (numpy leaves) -> the
    port's: per chunk one shard, or (tensor_parallel > 1) a list of rank
    shards."""
    return [[from_jax(s) for s in c] if isinstance(c, list)
            else from_jax(c) for c in shards]


def shards_to_jax(shards, stacked: bool = True) -> list:
    """Inverse of ``shards_from_jax``."""
    return [[to_jax(s, stacked) for s in c] if isinstance(c, list)
            else to_jax(c, stacked) for c in shards]


def to_jax(params: Dict[str, Any], stacked: bool = True) -> Dict[str, Any]:
    """The port's params -> a JAX-layout tree of float32 numpy arrays;
    ``stacked`` picks scan-stacked blocks or per-layer ``"0".."L-1"``. A
    DTensor leaf is gathered whole (``full_tensor``, a collective)."""
    def arr(_p, t):
        if hasattr(t, "full_tensor"):
            t = t.full_tensor()
        return t.detach().to("cpu", torch.float32).numpy()

    blocks = [map_params(arr, b) for b in params["blocks"]]
    tree = {k: None if k == "blocks" else map_params(arr, v)
            for k, v in params.items()}
    if not stacked:
        tree["blocks"] = {str(i): b for i, b in enumerate(blocks)}
        return tree

    def stack(path, _t):
        keys = path.split(".")

        def leaf(b):
            for k in keys:
                b = b[k]
            return b

        return np.stack([leaf(b) for b in blocks])

    tree["blocks"] = map_params(stack, blocks[0])
    return tree


def _adam_state(opt_state):
    """The (count, mu, nu) named tuple inside an optax chain's state."""
    if hasattr(opt_state, "_fields") and "mu" in opt_state._fields:
        return opt_state
    if isinstance(opt_state, tuple):
        for sub in opt_state:
            found = _adam_state(sub)
            if found is not None:
                return found
    return None


def train_state_from_jax(state, device: Optional[torch.device | str] = None,
                         mesh=None, specs=None) -> TrainState:
    """A JAX ``TrainState`` with numpy leaves (``jax.tree.map(np.asarray,
    state)``) -> the port's ``TrainState`` on ``device`` (the card unless
    ``"cpu"`` is asked for), params ready for autograd. With ``mesh`` and
    ``specs`` (the params' partition specs, e.g. ``param_specs(params,
    mesh, rules, logical_axes(cfg))``) every leaf is a DTensor; the moments
    follow their params."""
    device = resolve_device(device)
    adam = _adam_state(state.opt_state)
    if adam is None:
        raise ValueError("no AdamW state (count, mu, nu) in opt_state")

    def place(tree, grad=False):
        tree = map_params(lambda _p, t: t.to(device), from_jax(tree))
        if mesh is not None:
            from ray_tpu_torch.parallel.sharding import shard_params

            tree = shard_params(tree, mesh, specs=specs)
        return map_params(lambda _p, t: t.requires_grad_(grad), tree)

    return TrainState(
        params=place(state.params, grad=True),
        opt_state=AdamWState(count=int(adam.count), mu=place(adam.mu),
                             nu=place(adam.nu)),
        step=int(state.step))


def train_state_to_jax(state: TrainState, like):
    """The port's ``TrainState`` -> a JAX ``TrainState`` of numpy leaves,
    shaped as ``like`` (one such state, e.g. of ``init_train_state``):
    its params, moments, both optax counts and the step are replaced. A
    meshed state's leaves are gathered whole: every rank of the mesh
    calls this."""
    stacked = not all(k.isdigit() for k in like.params["blocks"])
    count = np.asarray(state.opt_state.count, np.int32)
    mu = to_jax(state.opt_state.mu, stacked)
    nu = to_jax(state.opt_state.nu, stacked)

    def fill(x):
        fields = getattr(x, "_fields", None)
        if fields is not None:
            if "mu" in fields:
                return x._replace(count=count, mu=mu, nu=nu)
            return x._replace(count=count) if "count" in fields else x
        if isinstance(x, tuple):
            return tuple(fill(sub) for sub in x)
        return x

    return type(like)(params=to_jax(state.params, stacked),
                      opt_state=fill(like.opt_state),
                      step=np.asarray(state.step, np.int32))


def _rl_map(fn, tree, path=""):
    if isinstance(tree, dict):
        return {k: _rl_map(fn, v, f"{path}.{k}" if path else k)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rl_map(fn, v, f"{path}.{i}") for i, v in enumerate(tree)]
    return fn(path, tree)


def _is_conv_w(path: str) -> bool:
    parts = path.split(".")
    return parts[0] == "conv" and parts[-1] == "w"


def _contiguous(a: np.ndarray) -> np.ndarray:
    # np.ascontiguousarray gives a 0-d leaf (SAC's log_alpha) a length-1
    # axis; the reshape takes it back
    return np.ascontiguousarray(a).reshape(a.shape)


def rl_params_from_jax(tree) -> Dict[str, Any]:
    """An RLModule's JAX params (numpy leaves) -> the port's, as float32
    numpy arrays: conv kernels HWIO -> OIHW, the rest (0-d leaves too) as
    they are."""
    def leaf(path, a):
        a = np.asarray(a, np.float32)
        return _contiguous(a.transpose(3, 2, 0, 1) if _is_conv_w(path)
                           else a)

    return _rl_map(leaf, tree)


def rl_params_to_jax(params) -> Dict[str, Any]:
    """Inverse of ``rl_params_from_jax``; takes numpy or tensor leaves."""
    def leaf(path, a):
        if isinstance(a, torch.Tensor):
            a = a.detach().to("cpu", torch.float32).numpy()
        a = np.asarray(a, np.float32)
        return _contiguous(a.transpose(2, 3, 1, 0) if _is_conv_w(path)
                           else a)

    return _rl_map(leaf, params)


def _adam_from_jax(opt_state) -> Dict[str, Any]:
    adam = _adam_state(opt_state)
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in opt_state")
    return {"count": int(np.asarray(adam.count)),
            "mu": rl_params_from_jax(adam.mu),
            "nu": rl_params_from_jax(adam.nu)}


def _adam_to_jax(st: Dict[str, Any], like):
    """An optax chain state shaped as ``like``, its Adam count, ``mu`` and
    ``nu`` (and every other count) replaced by the port's ``st``."""
    count = np.asarray(st["count"], np.int32)
    mu, nu = rl_params_to_jax(st["mu"]), rl_params_to_jax(st["nu"])

    def fill(x):
        fields = getattr(x, "_fields", None)
        if fields is not None:
            if "mu" in fields:
                return x._replace(count=count, mu=mu, nu=nu)
            return x._replace(count=count) if "count" in fields else x
        if isinstance(x, tuple):
            return tuple(fill(sub) for sub in x)
        return x

    return fill(like)


def rl_learner_state_from_jax(state) -> Dict[str, Any]:
    """A JAX ``Learner.get_state()`` -> the port ``Learner.set_state``'s
    input: params and Adam's ``mu``/``nu`` converted, ``count`` kept."""
    return {"params": rl_params_from_jax(state["params"]),
            "opt_state": _adam_from_jax(state["opt_state"])}


def rl_learner_state_to_jax(state: Dict[str, Any], like) -> Dict[str, Any]:
    """The port learner's state -> a JAX ``Learner.get_state()`` shaped as
    ``like`` (one such state): params, ``mu``, ``nu`` and the count are
    replaced."""
    return {"params": rl_params_to_jax(state["params"]),
            "opt_state": _adam_to_jax(state["opt_state"],
                                      like["opt_state"])}


def dreamer_state_from_jax(params, opt_state) -> Dict[str, Any]:
    """A JAX ``DreamerV3``'s ``params`` (``wm`` with its nested ``gru``
    dict, ``actor``, ``critic``) and its three ``optax.adam`` states (a
    dict by those names), numpy leaves -> the port ``DreamerV3.set_state``'s
    input: ``{"params", "opt_state": {name: {"count", "mu", "nu"}}}``."""
    return {"params": rl_params_from_jax(params),
            "opt_state": {k: _adam_from_jax(v)
                          for k, v in opt_state.items()}}


def dreamer_state_to_jax(state: Dict[str, Any], like_opt_state
                         ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Inverse of ``dreamer_state_from_jax``: (params, opt_state) as JAX
    holds them, the optax states shaped as ``like_opt_state``."""
    return (rl_params_to_jax(state["params"]),
            {k: _adam_to_jax(st, like_opt_state[k])
             for k, st in state["opt_state"].items()})
