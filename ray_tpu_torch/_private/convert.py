"""JAX params <-> the port's tensors.

``from_jax`` takes the params of ``ray_tpu.models.transformer.init_params``
as numpy arrays (``jax.tree.map(np.asarray, params)``), with the blocks
either scan-stacked (each leaf has a leading layer axis) or per-layer under
``"0".."L-1"``, and returns the port's params: the same names and layouts,
the blocks as a list of per-layer dicts, float32 CPU tensors as given.
``to_jax`` is its inverse. This module never imports JAX; numpy is the
common ground.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

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
