"""ConnectorV2-style pipelines.

Counterpart: ``ray_tpu/rllib/connectors.py``, copied: small composable
transforms between the env boundary and the module/loss. Env-to-module
connectors run on HOST numpy arrays BEFORE the forward (so obs casting and
normalization end in one copy to the module's device), and learner
connectors transform the host batch before ``update_from_batch``; nothing
here runs on the card, so pipelines may branch on data freely.

Pipelines are picklable (they ship to env-runner actors via the config).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np


class Connector:
    """One transform; subclass or wrap a function with FnConnector."""

    def __call__(self, data: Any, ctx: Optional[Dict[str, Any]] = None):
        raise NotImplementedError


class FnConnector(Connector):
    def __init__(self, fn: Callable, name: str = ""):
        self._fn = fn
        self.name = name or getattr(fn, "__name__", "fn")

    def __call__(self, data, ctx=None):
        return self._fn(data)


class ConnectorPipeline(Connector):
    """Ordered composition; append/prepend mirror the reference's pipeline
    surgery API."""

    def __init__(self, connectors: Sequence[Any] = ()):
        self.connectors: List[Connector] = [self._coerce(c)
                                            for c in connectors]

    @staticmethod
    def _coerce(c) -> Connector:
        return c if isinstance(c, Connector) else FnConnector(c)

    def append(self, c) -> "ConnectorPipeline":
        self.connectors.append(self._coerce(c))
        return self

    def prepend(self, c) -> "ConnectorPipeline":
        self.connectors.insert(0, self._coerce(c))
        return self

    def __call__(self, data, ctx=None):
        for c in self.connectors:
            data = c(data, ctx)
        return data

    def __len__(self):
        return len(self.connectors)


# ------------------------------------------------------ built-in connectors


class NormalizeObs(Connector):
    """Running mean/std observation normalization (env-to-module).
    State lives per env-runner; the learner sees already-normalized obs in
    the batch, matching the reference's MeanStdFilter placement."""

    def __init__(self, clip: float = 10.0, eps: float = 1e-8):
        self.clip = clip
        self.eps = eps
        self._count = 0.0
        self._mean: Optional[np.ndarray] = None
        self._m2: Optional[np.ndarray] = None

    def __call__(self, obs: np.ndarray, ctx=None) -> np.ndarray:
        obs = np.asarray(obs, np.float32)
        batch = obs.reshape(-1, obs.shape[-1])
        if self._mean is None:
            self._mean = np.zeros(batch.shape[-1], np.float64)
            self._m2 = np.ones(batch.shape[-1], np.float64)
        # Welford batch update
        n_b = len(batch)
        if n_b:
            mean_b = batch.mean(0)
            var_b = batch.var(0)
            n_a = self._count
            tot = n_a + n_b
            delta = mean_b - self._mean
            self._mean = self._mean + delta * n_b / tot
            self._m2 = (self._m2 + var_b * n_b
                        + delta ** 2 * n_a * n_b / tot)
            self._count = tot
        std = np.sqrt(self._m2 / max(self._count, 1.0)) + self.eps
        out = (obs - self._mean.astype(np.float32)) / std.astype(np.float32)
        return np.clip(out, -self.clip, self.clip)


class ClipRewards(Connector):
    """Learner-side reward clipping (the Atari sign-clip by default).

    Placement note: the learner connector sees the per-update batch AS THE
    ALGORITHM FORMS IT — IMPALA/APPO batches carry raw rewards (V-trace
    runs inside the loss, so clipping here bounds the learning signal);
    PPO minibatches are post-GAE (clip rewards in the env connector
    instead)."""

    def __init__(self, limit: float = 1.0, sign: bool = False):
        self.limit = limit
        self.sign = sign

    def __call__(self, batch: Dict[str, np.ndarray], ctx=None):
        r = batch["rewards"]
        batch["rewards"] = (np.sign(r) if self.sign
                            else np.clip(r, -self.limit, self.limit))
        return batch


class FlattenObs(Connector):
    """Flatten trailing obs dims into one feature axis, keeping
    `keep_dims` leading axes (default 1: the env-runner's [B, *obs]
    batches). Operates on ARRAYS — in a learner pipeline (which passes
    the batch dict) wrap it per column, e.g.
    ``lambda b, ctx=None: {**b, "obs": FlattenObs(2)(b["obs"])}``."""

    def __init__(self, keep_dims: int = 1):
        self.keep_dims = keep_dims

    def __call__(self, obs: np.ndarray, ctx=None):
        obs = np.asarray(obs)
        if obs.ndim <= self.keep_dims + 1:
            return obs
        return obs.reshape(obs.shape[:self.keep_dims] + (-1,))


class CastObs(Connector):
    def __init__(self, dtype=np.float32, scale: float = 1.0):
        self.dtype = dtype
        self.scale = scale

    def __call__(self, obs, ctx=None):
        out = np.asarray(obs).astype(self.dtype)
        return out * self.scale if self.scale != 1.0 else out
