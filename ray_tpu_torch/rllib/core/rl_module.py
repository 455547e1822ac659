"""RLModule: the neural-net abstraction of the new API stack.

Counterpart: ``ray_tpu/rllib/core/rl_module.py``. A module is a set of plain
functions over a params dict of tensors, under the JAX package's names: a
Nature-CNN stem ``conv`` for image observations, the dense ``torso``, the
policy head ``pi``, the value head ``vf`` and, unless ``vf_share_layers``,
a separate value torso ``vf_torso``. Dense weights keep the JAX layout
``[in, out]`` (``x @ w + b``); conv weights are OIHW for ``F.conv2d``
(``_private/convert.py`` turns JAX's HWIO into OIHW and back).

The conv stem takes NHWC frames as the JAX one does: it permutes them to
NCHW, convolves, and permutes the output back to NHWC before flattening,
so the first torso layer's rows follow JAX's NHWC order. A uint8 frame is
taken to float32 and divided by 255.

Params are drawn from a CPU ``torch.Generator`` seeded by ``seed`` and then
moved to the device, so the card and the CPU start from the same weights.
``forward_exploration`` takes a ``torch.Generator`` (on the obs' device)
where JAX takes a key, and samples by Gumbel-max (argmax of the logits plus
Gumbel noise), as ``jax.random.categorical`` does, with no host read.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch._private.device import resolve_device


@dataclasses.dataclass(frozen=True)
class RLModuleSpec:
    """The JAX package's ``RLModuleSpec``, field for field."""

    obs_dim: int
    num_actions: int  # discrete action space
    hiddens: Tuple[int, ...] = (64, 64)
    #: "categorical" (discrete)
    dist_type: str = "categorical"
    #: separate value-net trunk (shared trunks let large value errors swamp
    #: the policy gradient)
    vf_share_layers: bool = False
    #: image observations: obs_shape (e.g. (84, 84, 4), an Atari stack)
    #: selects the Nature-CNN torso; uint8 obs are normalized to [0, 1]
    obs_shape: Tuple[int, ...] = ()
    conv_filters: Tuple[Tuple[int, int, int], ...] = (
        (32, 8, 4), (64, 4, 2), (64, 3, 1))  # (out_ch, kernel, stride)
    #: custom module class; None uses the default RLModule. Must accept
    #: (spec) and expose init_params().
    module_class: Any = None


def make_module(spec: "RLModuleSpec"):
    """Module factory honoring spec.module_class."""
    return (spec.module_class or RLModule)(spec)


def _orthogonal(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    w = torch.empty(shape, dtype=torch.float32)
    # PPO-standard orthogonal init keeps early KL small
    return torch.nn.init.orthogonal_(w, gain=scale, generator=gen)


def _init_linear(gen: torch.Generator, fan_in: int, fan_out: int,
                 scale: float = 1.0) -> Dict[str, torch.Tensor]:
    return {"w": _orthogonal(gen, (fan_in, fan_out), scale),
            "b": torch.zeros(fan_out)}


def params_to(params, device) -> Dict[str, Any]:
    """The params tree with every tensor on ``device``."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to(v, device) for v in params]
    return params.to(device)


class RLModule:
    """Stateless function collection over a params dict."""

    def __init__(self, spec: RLModuleSpec):
        self.spec = spec

    @property
    def _is_conv(self) -> bool:
        return len(self.spec.obs_shape) == 3

    def _conv_out_dim(self) -> int:
        h, w, _ = self.spec.obs_shape
        for _, k, s in self.spec.conv_filters:
            h = (h - k) // s + 1
            w = (w - k) // s + 1
            if h <= 0 or w <= 0:
                raise ValueError(
                    f"obs_shape {self.spec.obs_shape} too small for "
                    f"conv_filters {self.spec.conv_filters}: spatial dim "
                    f"collapses to {h}x{w} at kernel={k} stride={s}")
        return h * w * self.spec.conv_filters[-1][0]

    def init_params(self, seed: int = 0, device=None) -> Dict[str, Any]:
        """Params drawn on the CPU from ``seed``, then moved to ``device``
        (the card unless the caller names the CPU)."""
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(int(seed))
        params: Dict[str, Any] = {}
        if self._is_conv:
            # Nature-CNN stem shared by policy and value (the dense torso
            # is still separate when vf_share_layers=False)
            params["conv"] = []
            in_ch = self.spec.obs_shape[-1]
            for out_ch, k, _s in self.spec.conv_filters:
                params["conv"].append({
                    "w": _orthogonal(gen, (out_ch, in_ch, k, k),
                                     math.sqrt(2)),
                    "b": torch.zeros(out_ch),
                })
                in_ch = out_ch
            fan_in = self._conv_out_dim()
        else:
            fan_in = self.spec.obs_dim
        params["torso"] = []
        for h in self.spec.hiddens:
            params["torso"].append(_init_linear(gen, fan_in, h,
                                                math.sqrt(2)))
            fan_in = h
        params["pi"] = _init_linear(gen, fan_in, self.spec.num_actions,
                                    0.01)
        params["vf"] = _init_linear(gen, fan_in, 1, 1.0)
        if not self.spec.vf_share_layers:
            params["vf_torso"] = []
            fan_in = (self._conv_out_dim() if self._is_conv
                      else self.spec.obs_dim)
            for h in self.spec.hiddens:
                params["vf_torso"].append(_init_linear(
                    gen, fan_in, h, math.sqrt(2)))
                fan_in = h
        return params_to(params, device)

    def _conv_stem(self, params, obs):
        if obs.dtype == torch.uint8:
            x = obs.to(torch.float32) / 255.0
        else:
            x = obs.to(torch.float32)
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        for layer, (_out, _k, s) in zip(params["conv"],
                                        self.spec.conv_filters):
            x = torch.relu(F.conv2d(x, layer["w"], layer["b"], stride=s))
        # flatten in NHWC order, as the JAX stem does
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)

    def _torso(self, params, obs, key="torso", stem=None):
        # the conv stem is shared between the torsos; dense layers differ
        if self._is_conv:
            x = self._conv_stem(params, obs) if stem is None else stem
        else:
            x = obs
        for layer in params[key]:
            x = torch.tanh(x @ layer["w"] + layer["b"])
        return x

    def forward_train(self, params, obs):
        """-> (logits, value). Used by losses."""
        stem = self._conv_stem(params, obs) if self._is_conv else None
        x = self._torso(params, obs, stem=stem)
        logits = x @ params["pi"]["w"] + params["pi"]["b"]
        xv = (self._torso(params, obs, "vf_torso", stem=stem)
              if "vf_torso" in params else x)
        value = (xv @ params["vf"]["w"] + params["vf"]["b"]).squeeze(-1)
        return logits, value

    def forward_inference(self, params, obs):
        logits, _ = self.forward_train(params, obs)
        return logits

    def forward_exploration(self, params, obs, generator: torch.Generator):
        """-> (action, logp, value); the sampling path of the env runners."""
        logits, value = self.forward_train(params, obs)
        action = sample_categorical(logits, generator)
        logp = torch.log_softmax(logits, -1).gather(
            -1, action[:, None])[:, 0]
        return action, logp, value


def sample_categorical(logits: torch.Tensor,
                       generator: torch.Generator) -> torch.Tensor:
    """Gumbel-max draw of one action per row (int64), on the logits'
    device, from ``generator``: ``argmax(logits - log(-log(u)))`` with
    ``u`` uniform in [tiny, 1), as ``jax.random.categorical`` draws."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=logits.dtype)
    u = u.clamp_min(torch.finfo(logits.dtype).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)
