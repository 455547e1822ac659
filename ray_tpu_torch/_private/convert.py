"""JAX params <-> the port's tensors.

``from_jax`` takes the params of ``ray_tpu.models.transformer.init_params``
as numpy arrays (``jax.tree.map(np.asarray, params)``), with the blocks
either scan-stacked (each leaf has a leading layer axis) or per-layer under
``"0".."L-1"``, and returns the port's params: the same names and layouts,
the blocks as a list of per-layer dicts, float32 CPU tensors as given.
``to_jax`` is its inverse.

``train_state_from_jax`` carries a JAX ``TrainState`` across (params, the
optax AdamW moments ``mu``/``nu``, its count, and the step), so a run that
resumes from JAX state takes the same next step; ``train_state_to_jax`` is
its inverse, filling a JAX state of numpy leaves given as the template.
The optax states are found by their field names, never by their types.

This module never imports JAX or optax; numpy is the common ground.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models.training import AdamWState, TrainState
from ray_tpu_torch.models.transformer import map_params


def _tensor(path: str, a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def from_jax(tree: Dict[str, Any]) -> Dict[str, Any]:
    """JAX param tree of numpy arrays -> the port's param tree."""
    tree = dict(tree)
    blocks = tree.pop("blocks")
    out = map_params(_tensor, tree)
    if all(k.isdigit() for k in blocks):
        out["blocks"] = [map_params(_tensor, blocks[str(i)])
                         for i in range(len(blocks))]
        return out
    n = len(blocks["attn"]["wq"])

    def layer(i):
        return map_params(lambda p, a: _tensor(p, np.asarray(a)[i]), blocks)

    out["blocks"] = [layer(i) for i in range(n)]
    return out


def to_jax(params: Dict[str, Any], stacked: bool = True) -> Dict[str, Any]:
    """The port's params -> a JAX-layout tree of float32 numpy arrays;
    ``stacked`` picks scan-stacked blocks or per-layer ``"0".."L-1"``."""
    def arr(_p, t):
        return t.detach().to("cpu", torch.float32).numpy()

    tree = {k: map_params(arr, v) for k, v in params.items()
            if k != "blocks"}
    blocks = [map_params(arr, b) for b in params["blocks"]]
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


def train_state_from_jax(state, device: Optional[torch.device | str] = None
                         ) -> TrainState:
    """A JAX ``TrainState`` with numpy leaves (``jax.tree.map(np.asarray,
    state)``) -> the port's ``TrainState`` on ``device`` (the card unless
    ``"cpu"`` is asked for), params ready for autograd."""
    device = resolve_device(device)
    adam = _adam_state(state.opt_state)
    if adam is None:
        raise ValueError("no AdamW state (count, mu, nu) in opt_state")

    def place(tree, grad=False):
        return map_params(lambda _p, t: t.to(device).requires_grad_(grad),
                          from_jax(tree))

    return TrainState(
        params=place(state.params, grad=True),
        opt_state=AdamWState(count=int(adam.count), mu=place(adam.mu),
                             nu=place(adam.nu)),
        step=int(state.step))


def train_state_to_jax(state: TrainState, like):
    """The port's ``TrainState`` -> a JAX ``TrainState`` of numpy leaves,
    shaped as ``like`` (one such state, e.g. of ``init_train_state``):
    its params, moments, both optax counts and the step are replaced."""
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
