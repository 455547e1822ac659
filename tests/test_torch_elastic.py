"""Elastic world membership in the port (``ray_tpu_torch._private.
elastic``, ``util/collective/resizable.py`` and the elastic
``PipelineTrainer``) on the CPU: the twins of ``tests/test_elastic.py``'s
``TestRequirePositive``, ``TestElasticSupervisor``, ``TestResizableGroup``
and ``test_pipeline_elastic_rejoin_exact`` /
``test_pipeline_elastic_requires_dp_channels``.

``sync_tree`` carries the port's own trees (dicts, lists, tuples, the
``AdamWState`` dataclass; float32, bfloat16 and int64 tensors and numpy
arrays): every leaf arrives bit for bit in its dtype, a bfloat16 leaf
crossing as its int16 bits. The elastic pipeline (dp=2, S=2, every stage
with ``num_gpus=0`` and one OpenMP thread) loses one replica's stage between flushes, respawns
it, reshards the dp group and streams params to the joiner with no
checkpoint; its four losses match JAX's uninterrupted single-process
reference on the same weights to ``atol=1e-5``, and every pin comes
back. Every ``get`` waits at most ``TIMEOUT`` seconds.
"""

import os
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch._private.elastic import ElasticSupervisor, require_positive

os.environ.setdefault("RAY_TPU_TORCH_LOG_LEVEL", "WARNING")

TIMEOUT = 120


class TestRequirePositive:
    def test_accepts_positive(self):
        assert require_positive("k", 3) == 3
        assert require_positive("k", "4") == 4
        assert require_positive("k", 0.5, kind=float) == 0.5

    @pytest.mark.parametrize("bad", [0, -1, "0"])
    def test_rejects_zero_and_negative(self, bad):
        with pytest.raises(ValueError, match="positive"):
            require_positive("k", bad)

    def test_rejects_none(self):
        with pytest.raises(ValueError, match="must be set"):
            require_positive("k", None)


class TestElasticSupervisor:
    def _sup(self, **kw):
        kw.setdefault("respawn_budget", 2)
        kw.setdefault("backoff_s", 0.01)
        kw.setdefault("resize_timeout_s", 5.0)
        return ElasticSupervisor(**kw)

    def test_budget_is_per_slot(self):
        sup = self._sup()
        spawned = []
        for _ in range(2):
            sup.respawn("a", lambda: spawned.append("a"))
        with pytest.raises(RuntimeError, match="budget exhausted"):
            sup.respawn("a", lambda: spawned.append("a"))
        sup.respawn("b", lambda: spawned.append("b"))
        assert spawned == ["a", "a", "b"]
        assert sup.attempts("a") == 2 and sup.attempts("b") == 1

    def test_backoff_grows_on_same_slot(self):
        sup = self._sup(respawn_budget=3, backoff_s=0.05)
        t0 = time.monotonic()
        sup.respawn("s", lambda: None)      # first attempt: no backoff
        first = time.monotonic() - t0
        t0 = time.monotonic()
        sup.respawn("s", lambda: None)      # second: ~backoff_s
        second = time.monotonic() - t0
        assert first < 0.04
        assert second >= 0.04

    @pytest.mark.parametrize("knob", [
        dict(respawn_budget=0),
        dict(backoff_s=0.0),
        dict(resize_timeout_s=0),
    ])
    def test_explicit_zero_knobs_raise(self, knob):
        with pytest.raises(ValueError, match="positive"):
            self._sup(**knob)

    def test_env_knobs_flow_through_config(self, monkeypatch):
        from ray_tpu_torch._private.config import Config

        monkeypatch.setenv("RAY_TPU_TORCH_ELASTIC_RESPAWN_BUDGET", "5")
        monkeypatch.setenv("RAY_TPU_TORCH_ELASTIC_BACKOFF_S", "0.25")
        sup = ElasticSupervisor(config=Config.from_env())
        assert sup.respawn_budget == 5
        assert sup.backoff_s == 0.25
        assert sup.resize_timeout_ms == 120_000

    def test_env_zero_rejected_not_defaulted(self, monkeypatch):
        from ray_tpu_torch._private.config import Config

        monkeypatch.setenv("RAY_TPU_TORCH_ELASTIC_RESPAWN_BUDGET", "0")
        with pytest.raises(ValueError, match="positive"):
            ElasticSupervisor(config=Config.from_env())


def _state_tree():
    """A pipeline stage's state as ``sync_tree`` sees it: params, an
    AdamW state (a dataclass), bucket keys that are tuples."""
    from ray_tpu_torch.models.training import AdamWState

    g = torch.Generator().manual_seed(11)
    w = torch.randn(4, 3, generator=g)
    return {"params": [{"w": w, "b": torch.randn(3, generator=g).bfloat16()},
                       {"ids": torch.arange(5), "empty": torch.zeros(0)}],
            "opt": AdamWState(count=3, mu={"w": w * 2}, nu={"w": w * w}),
            "fused": {(0, 1): None, (2,): (np.arange(3.0), 7)}}


def _assert_same(a, b, path="tree"):
    assert type(a) is type(b), (path, type(a), type(b))
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.view(-1).view(torch.uint8).numpy().tobytes() == \
            b.view(-1).view(torch.uint8).numpy().tobytes(), path
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), path
    elif isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif hasattr(a, "__dataclass_fields__"):
        for k in a.__dataclass_fields__:
            _assert_same(getattr(a, k), getattr(b, k), f"{path}.{k}")
    else:
        assert a == b, path


@rt.remote
class Member:
    def allreduce(self, fill, name, timeout_ms=60000):
        from ray_tpu_torch.util import collective as col

        out = col.allreduce(np.full(4, float(fill), np.float64),
                            group_name=name, timeout_ms=timeout_ms)
        return float(out[0])

    def refresh(self, name):
        from ray_tpu_torch.util.collective.resizable import \
            refresh_membership

        return refresh_membership(name)

    def sync(self, fill, name, src_rank=0):
        from ray_tpu_torch.util.collective.resizable import sync_tree

        tree = None
        if fill is not None:
            tree = {"w": np.full(3, float(fill), np.float64)}
        out = sync_tree(tree, name, src_rank=src_rank)
        return float(out["w"][0]), out["w"].shape

    def sync_state(self, send, name):
        from ray_tpu_torch.util.collective.resizable import sync_tree

        return sync_tree(_state_tree() if send else None, name, src_rank=1)


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=16, num_gpus=0, object_store_memory=256 * 1024 * 1024)
    yield
    rt.shutdown()


class TestResizableGroup:
    def test_resize_and_sync_tree(self, cluster):
        from ray_tpu_torch.util.collective.resizable import ResizableGroup

        name = f"rz_{os.getpid()}"
        members = [Member.remote() for _ in range(3)]
        group = ResizableGroup(members, group_name=name, backend="host")
        epoch0 = group.epoch
        assert group.world_size == 3
        assert rt.get([m.allreduce.remote(i + 1, name)
                       for i, m in enumerate(members)],
                      timeout=TIMEOUT) == [6.0] * 3

        # a departure marks the group, a shrink re-declares the two
        # survivors at a fresh generation
        assert group.note_departure(members[2])
        assert group.resize_pending
        assert not group.note_departure(members[2])  # already noted
        group.resize()
        assert not group.resize_pending and group.epoch > epoch0
        assert group.world_size == 2
        rt.get([m.refresh.remote(name) for m in members[:2]],
               timeout=TIMEOUT)
        assert rt.get([m.allreduce.remote(i + 1, name)
                       for i, m in enumerate(members[:2])],
                      timeout=TIMEOUT) == [3.0] * 2

        # grow: a fresh joiner enters at the next generation and receives
        # rank 0's tree leaf by leaf over broadcast
        joiner = Member.remote()
        world = [members[0], members[1], joiner]
        group.resize(world)
        rt.get([m.refresh.remote(name) for m in world], timeout=TIMEOUT)
        outs = rt.get([world[0].sync.remote(7.5, name),
                       world[1].sync.remote(None, name),
                       joiner.sync.remote(None, name)], timeout=TIMEOUT)
        for first, shape in outs:
            assert first == 7.5 and tuple(shape) == (3,)
        assert rt.get([m.allreduce.remote(1, name) for m in world],
                      timeout=TIMEOUT) == [3.0] * 3

        # the port's own trees: tensors of every dtype, a dataclass,
        # tuple keys; rank 1 sends
        states = rt.get([m.sync_state.remote(r == 1, name)
                         for r, m in enumerate(world)], timeout=TIMEOUT)
        for st in states:
            _assert_same(_state_tree(), st)


@pytest.mark.preempt
class TestElasticPipeline:
    def test_pipeline_elastic_rejoin_exact(self, cluster):
        """Kill one dp stage replica between flushes: the trainer
        respawns it, reshards the dp group, streams params to the joiner
        over broadcast (no checkpoint restore), and every loss matches
        the uninterrupted single-process reference."""
        from ray_tpu_torch._private import api as _api
        from ray_tpu_torch._private.elastic import (m_departures, m_joins,
                                                    m_rejoin_seconds,
                                                    m_reshards)
        from ray_tpu_torch.models import presets
        from ray_tpu_torch.train import PipelineTrainer
        from tests.test_torch_pipeline_math import _batch, _jax_cfg, \
            _tiny_cfg
        from tests.test_torch_train_pipeline import (CPU_STAGE,
                                                     _jax_local_losses,
                                                     _store_pins, _wait_pins)

        core = _api._require_core()
        pins0 = _store_pins(core)
        joins0, deps0 = m_joins.total(), m_departures.total()
        reshards0 = m_reshards.total()
        rejoins0 = m_rejoin_seconds.count_total()

        cfg = _tiny_cfg()
        batch = _batch()
        STEPS = 4
        ref = _jax_local_losses(cfg, _jax_cfg(), batch, 2, STEPS)
        trainer = PipelineTrainer(
            presets.pipeline_stage_defs(cfg, 2, seed=0),
            num_microbatches=2, dp=2, optimizer=("sgd", 0.05),
            elastic=True, stage_options=[CPU_STAGE] * 2)
        both = np.concatenate([batch, batch])
        got = []
        try:
            got.append(trainer.step(both)["loss"])
            got.append(trainer.step(both)["loss"])
            rt.kill(trainer._actors[1][0][0])  # dp row 1, stage 0
            deadline = time.monotonic() + 30
            while not trainer._heal_pending \
                    and time.monotonic() < deadline:
                time.sleep(0.05)
            assert trainer._heal_pending, \
                "death fan-out never marked the trainer for healing"
            got.append(trainer.step(both)["loss"])  # heals, then steps
            got.append(trainer.step(both)["loss"])
        finally:
            trainer.shutdown()

        assert np.allclose(got, ref, atol=1e-5), (got, ref)
        assert m_joins.total() == joins0 + 1
        assert m_departures.total() == deps0 + 1
        assert m_reshards.total() == reshards0 + 1
        assert m_rejoin_seconds.count_total() == rejoins0 + 1
        assert _wait_pins(core, pins0, timeout=30) == pins0

    def test_pipeline_elastic_requires_dp_channels(self, cluster):
        from ray_tpu_torch.models import presets
        from ray_tpu_torch.train import PipelineTrainer
        from tests.test_torch_pipeline_math import _tiny_cfg

        with pytest.raises(ValueError, match="elastic"):
            PipelineTrainer(
                presets.pipeline_stage_defs(_tiny_cfg(), 2, seed=0),
                num_microbatches=2, dp=1, optimizer=("sgd", 0.05),
                elastic=True)
