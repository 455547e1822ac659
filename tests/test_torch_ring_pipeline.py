"""The port's ring attention, SPMD pipelines and expert-parallel MoE against
the JAX package's, twins of ``tests/test_ops.py::TestRingAttention`` and
``tests/test_moe_pipeline.py::TestPipeline`` /
``test_expert_parallel_matches_single_device``.

JAX runs on conftest's 8 virtual CPU devices in the test process; the port
runs once in a gloo world of 4 CPU processes (``tests/torch_spmd_worlds.py``,
no JAX there): ring attention at sp 4, causal with GQA and non-causal
MHA, against
JAX's ring and JAX's full attention, forward and grads; ``pipeline_apply``
over pp 4 (linear stages, DTensor stage params) and over pp 2 x dp 2 (two
tanh stages on a loss every rank computes from the replicated output:
each rank's stage grad equals JAX's pipeline's and sequential autodiff's,
not the axis size times it);
``pipeline_1f1b`` over pp 4 in float32, with bf16 microbatches, and with 32
microbatches through its 8-slot store, loss and grads against JAX's; four
llama_debug blocks pipelined 2 x 2 against JAX's sequential forward; the
ring branch of the model (``attn_impl="ring"``, sp 4) against JAX's
forward; and moe_debug's forward over dp 2 x ep 2 against JAX's EP-sharded
and one-device forwards. With remat on and the backward on another
thread (as autograd runs it on the card), the ring branch and the MoE
layer give the grads of the remat-off run bit for bit. Two more mesh
train steps, held against the
port's meshless step from the same converted JAX params (3 steps at a
learning rate of 3e-4; losses, grad norms, params and both Adam moments
within ``METRIC_TOL``/``WEIGHT_TOL``): llama_debug at tp 4,
where the 2 kv heads stay whole and each rank narrows them to its query
head's, and moe_debug at dp 2 x ep 2 (whole-batch routing and routing
loss, each ep rank its experts). float32 tolerances: ``TOL`` (2e-5 abs and
rel, JAX's own ring test's) for ops and pipelines, ``MODEL_TOL`` (2e-4,
JAX's EP test's) for whole-model logits; bf16 ``BF16_TOL`` (2e-2 rel).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh
from torch.distributed.tensor import Replicate, Shard

from ray_tpu.models import presets as jpresets
from ray_tpu.models import transformer as jtransformer
from ray_tpu.ops.ring_attention import ring_attention as jax_ring_attention
from ray_tpu.ops.flash_attention import reference_attention
from ray_tpu.parallel import pipeline as jpipeline
from ray_tpu.parallel.mesh import MeshSpec, build_mesh
from ray_tpu.parallel.sharding import shard_params
from tests.torch_spmd_worlds import save_tree, spmd_world, start_world

TOL = dict(atol=2e-5, rtol=2e-5)
METRIC_TOL = dict(atol=2e-5, rtol=2e-4)
WEIGHT_TOL = dict(atol=2e-5, rtol=2e-4)
TRAIN_STEPS = 3
MODEL_TOL = dict(atol=2e-4, rtol=2e-4)
BF16_TOL = dict(atol=1e-3, rtol=2e-2)


def _qkv(b, s, h, hkv, d, seed):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(*shape).astype(np.float32) for shape in
                 ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, h, d)))


RING = {"causal_gqa": dict(b=1, s=64, h=8, hkv=2, d=16, causal=True),
        "full_mha": dict(b=2, s=128, h=4, hkv=4, d=16, causal=False)}


def _one_f1b_cases():
    rng = np.random.RandomState(0)
    affine = {"w": np.stack([rng.randn(8, 8) * 0.5 for _ in range(4)]),
              "b": np.stack([rng.randn(8) * 0.1 for _ in range(4)])}
    x_affine = rng.randn(6, 4, 8)
    return {
        "float32": dict(params={k: v.astype(np.float32)
                                for k, v in affine.items()},
                        x=x_affine.astype(np.float32), dtype="float32",
                        stage="affine"),
        "bf16": dict(params={"w": np.stack([np.eye(8) * (0.8 + 0.1 * i)
                                            for i in range(4)]).astype(
                                                np.float32)},
                     x=np.ones((6, 4, 8), np.float32), dtype="bfloat16",
                     stage="matmul"),
        "store32": dict(params={"w": np.array([0.9 + 0.05 * i
                                               for i in range(4)],
                                              np.float32)},
                        x=np.linspace(0.1, 1.0, 32 * 4).reshape(32, 4)
                        .astype(np.float32), dtype="float32",
                        stage="scale"),
    }


def _jax_1f1b(c, mesh):
    dt = jnp.bfloat16 if c["dtype"] == "bfloat16" else jnp.float32
    params = {k: jnp.asarray(v).astype(dt) for k, v in c["params"].items()}
    fn = {"affine": lambda p, x: jnp.tanh(x @ p["w"] + p["b"]),
          "matmul": lambda p, x: jnp.tanh(x @ p["w"]),
          "scale": lambda p, x: x * p["w"]}[c["stage"]]
    return jpipeline.pipeline_1f1b(
        fn, lambda a: jnp.mean(a.astype(jnp.float32) ** 2), params,
        jnp.asarray(c["x"]).astype(dt), mesh=mesh)


def _jax_expectations(cases, params, cfg, mparams, mcfg):
    """JAX's side of every case, computed while the port's world runs."""
    want = {}
    sp4 = build_mesh(MeshSpec.of(sp=4), devices=jax.devices()[:4])
    for name, c in cases["ring"].items():
        q, k, v, cot = (jnp.asarray(c[x]) for x in ("q", "k", "v", "cot"))
        full = functools.partial(reference_attention, causal=c["causal"])
        out, vjp = jax.vjp(jax.jit(full), q, k, v)
        want[f"ring/{name}"] = {
            "ring": np.asarray(jax_ring_attention(q, k, v, sp4,
                                                  causal=c["causal"])),
            "full": np.asarray(out),
            "grads": [np.asarray(g) for g in vjp(cot)]}
    pp4 = Mesh(np.array(jax.devices()[:4]), ("pp",))
    c = cases["linear"]
    stacked = jpipeline.stack_stage_params(
        [{"w": jnp.float32(w), "b": jnp.float32(b)}
         for w, b in zip(c["w"], c["b"])])
    x = jnp.asarray(c["x"])
    y, vjp = jax.vjp(lambda sp: jpipeline.pipeline_apply(
        lambda p, h: h * p["w"] + p["b"], sp, x, mesh=pp4), stacked)
    (g_pipe,) = vjp(2 * y)  # the grad of sum(y ** 2)

    def seq(sp):
        h = x
        for i in range(4):
            h = h * sp["w"][i] + sp["b"][i]
        return jnp.sum(h ** 2)

    want["linear"] = {"y": np.asarray(y),
                      "grad": jax.tree.map(np.asarray, g_pipe),
                      "seq_grad": jax.tree.map(np.asarray,
                                               jax.grad(seq)(stacked))}
    for name, c in cases["1f1b"].items():
        loss, grads = _jax_1f1b(c, pp4)
        want[f"1f1b/{name}"] = {
            "loss": float(loss),
            "grads": {k: np.asarray(g.astype(jnp.float32))
                      for k, g in grads.items()}}
    tokens = jnp.asarray(cases["tokens"])
    want["forward"] = np.asarray(jtransformer.forward(cfg, params, tokens))
    mtokens = jnp.asarray(cases["moe_tokens"])
    want["moe"] = np.asarray(jtransformer.forward(mcfg, mparams, mtokens))
    dp_ep = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "ep"))
    sharded = shard_params(mparams, dp_ep,
                           logical=jtransformer.logical_axes(mcfg))
    want["moe_ep"] = np.asarray(jax.jit(
        lambda p, t: jtransformer.forward(mcfg, p, t))(sharded, mtokens))
    return want


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ring_pipeline")
    ring = {}
    for name, c in RING.items():
        q, k, v, cot = _qkv(c["b"], c["s"], c["h"], c["hkv"], c["d"], 0)
        ring[name] = dict(q=q, k=k, v=v, cot=cot, causal=c["causal"])
    cfg = jpresets.llama_debug(num_layers=4, remat=False)
    params = jax.jit(lambda k: jtransformer.init_params(cfg, k))(
        jax.random.PRNGKey(0))
    save_tree(str(tmp / "llama.npz"), jax.tree.map(np.asarray, params))
    mcfg = jpresets.moe_debug()
    mparams = jax.jit(lambda k: jtransformer.init_params(mcfg, k))(
        jax.random.PRNGKey(0))
    save_tree(str(tmp / "moe.npz"), jax.tree.map(np.asarray, mparams))
    cases = {
        "ring": ring,
        "linear": dict(w=[float(i + 2) for i in range(4)],
                       b=[float(i) for i in range(4)],
                       x=np.arange(24, dtype=np.float32).reshape(6, 4)),
        "1f1b": _one_f1b_cases(),
        "tokens": np.random.RandomState(1).randint(0, cfg.vocab_size,
                                                   (4, 16)),
        "moe_tokens": np.random.RandomState(2).randint(0, mcfg.vocab_size,
                                                       (2, 16)),
        "train_tokens": np.random.RandomState(3).randint(0, cfg.vocab_size,
                                                         (8, 16)),
        "train_steps": TRAIN_STEPS,
    }
    handle = start_world(spmd_world, 4, tmp, cases=cases,
                         params_npz=str(tmp / "llama.npz"),
                         moe_npz=str(tmp / "moe.npz"))
    want = _jax_expectations(cases, params, cfg, mparams, mcfg)
    return {"ranks": handle.join(), "cases": cases, "want": want,
            "mcfg": mcfg}


@pytest.mark.parametrize("name", list(RING))
def test_ring_attention_matches_jax_ring_and_full(world, name):
    want = world["want"][f"ring/{name}"]
    for r in world["ranks"]:
        got = r[f"ring/{name}"]
        assert got["placements"] == (Shard(1),)
        np.testing.assert_allclose(got["out"], want["ring"], **TOL)
        np.testing.assert_allclose(got["out"], want["full"], **TOL)


@pytest.mark.parametrize("name", list(RING))
def test_ring_attention_grads_match_full_attention(world, name):
    want = world["want"][f"ring/{name}"]["grads"]
    ranks = world["ranks"]
    for r in ranks:
        got = r[f"ring/{name}"]
        for key, w in zip(("dq", "dk", "dv"), want):
            np.testing.assert_allclose(got[key], w, err_msg=key, **TOL)
            assert np.array_equal(got[key], ranks[0][f"ring/{name}"][key])


def test_pipeline_apply_linear_stages_and_grads(world):
    """Forward and grads against JAX's pipeline, whose grads are
    sequential autodiff's."""
    c, want = world["cases"]["linear"], world["want"]["linear"]
    for k in ("w", "b"):
        np.testing.assert_allclose(want["grad"][k], want["seq_grad"][k],
                                   rtol=1e-6)
    expect = np.asarray(c["x"])
    for i in range(4):
        expect = expect * (i + 2) + i
    for r in world["ranks"]:
        np.testing.assert_allclose(r["linear"]["y"], expect, rtol=1e-6)
        np.testing.assert_allclose(r["linear"]["y"], want["y"], rtol=1e-6)
        np.testing.assert_allclose(r["linear"]["gw"], want["grad"]["w"],
                                   rtol=1e-5)
        np.testing.assert_allclose(r["linear"]["gb"], want["grad"]["b"],
                                   rtol=1e-5)


def test_pipeline_apply_grads_equal_sequential(world):
    """JAX's ``test_pipeline_is_differentiable`` stages; the port's grads
    against JAX's sequential autodiff."""
    x = jnp.ones((4, 3))

    def seq(w):
        return jnp.sum(jnp.tanh(jnp.tanh(x * w[0]) * w[1]) ** 2)

    want = np.asarray(jax.grad(seq)(jnp.array([1.5, 0.5])))
    for r in world["ranks"]:  # each rank holds its own stage's grad
        s = r["tanh"]["stage"]
        np.testing.assert_allclose(r["tanh"]["grad"][s], want[s], **TOL)
        assert r["tanh"]["grad"][1 - s] == 0.0


@pytest.mark.parametrize("name", ["float32", "bf16", "store32"])
def test_pipeline_1f1b_matches_jax(world, name):
    c = world["cases"]["1f1b"][name]
    want = world["want"][f"1f1b/{name}"]
    tol = BF16_TOL if name == "bf16" else TOL
    for r in world["ranks"]:
        got = r[f"1f1b/{name}"]
        assert np.isfinite(got["loss"]) and got["loss"] > 0
        np.testing.assert_allclose(got["loss"], want["loss"], **tol)
        for k, w in want["grads"].items():
            np.testing.assert_allclose(got["grads"][k], w, err_msg=k, **tol)
            assert np.abs(got["grads"][k]).sum() > 0
    if name == "store32":  # 32 microbatches through 8 slots: closed form
        w = c["params"]["w"].astype(np.float64)
        x = c["x"].astype(np.float64)
        np.testing.assert_allclose(
            world["ranks"][0]["1f1b/store32"]["loss"],
            np.mean((x * np.prod(w)) ** 2), rtol=1e-5)


def test_pipelined_transformer_blocks_match_sequential(world):
    for r in world["ranks"]:
        np.testing.assert_allclose(r["blocks"], world["want"]["forward"],
                                   **MODEL_TOL)


def test_ring_model_branch_matches_jax_forward(world):
    for r in world["ranks"]:
        np.testing.assert_allclose(r["ring_model"], world["want"]["forward"],
                                   **MODEL_TOL)


def test_expert_parallel_moe_matches_jax(world):
    cfg = world["mcfg"]
    for r in world["ranks"]:
        got = r["moe"]
        assert got["w_gate_placements"] == (Replicate(), Shard(0))
        assert got["w_gate_local"][0] == cfg.moe_num_experts // 2
        np.testing.assert_allclose(got["logits"], world["want"]["moe_ep"],
                                   **MODEL_TOL)
        np.testing.assert_allclose(got["logits"], world["want"]["moe"],
                                   **MODEL_TOL)


@pytest.mark.parametrize("name", ["ring_sp4", "moe_dp2_ep2"])
def test_remat_backward_on_another_thread_keeps_the_mesh(world, name):
    """Under remat each block runs again in backward, and on the card
    autograd runs the backward on its own device thread: the ring branch
    (sp 4) and the MoE layer (dp 2 x ep 2) are given their mesh as an
    argument, so that rerun, here on a new thread that holds none of the
    forward thread's context, computes the grads of the remat-off run on
    the forward thread, bit for bit (the same ops on the same bits)."""
    for r in world["ranks"]:
        diffs = r["remat_thread"][name]
        assert len(diffs) > 0
        assert max(diffs) == 0.0, diffs


@pytest.mark.parametrize("name", ["tp4_kv_narrowed", "dp2_ep2_moe"])
def test_mesh_train_step_equals_meshless(world, name):
    ranks = world["ranks"]
    r0 = ranks[0]["train"][name]
    for r in ranks:  # the metrics come back the same on every rank
        assert r["train"][name]["mesh"] == r0["mesh"]
    assert len(r0["mesh"]) == TRAIN_STEPS
    for got, want in zip(r0["mesh"], r0["meshless"]):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                       **METRIC_TOL)
    for got_key, want_key in (("final", "meshless_final"),
                              ("mu", "meshless_mu"), ("nu", "meshless_nu")):
        want = _flat_tree(r0[want_key])
        got = _flat_tree(r0[got_key])
        assert sorted(got) == sorted(want)
        for path, leaf in got.items():
            np.testing.assert_allclose(leaf, want[path],
                                       err_msg=f"{got_key} {path}",
                                       **WEIGHT_TOL)
    if name == "tp4_kv_narrowed":  # 2 kv heads over tp 4: replicated
        assert r0["wk_placements"] == (Replicate(),)
    else:
        assert "moe_aux" in r0["mesh"][0]


def _flat_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_tree(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_local_mesh_spans_the_world(world):
    """``local_mesh`` is ``build_mesh(MeshSpec.of(**sizes))`` over every
    rank: rank r at the row-major coordinates of JAX device r."""
    for rank, r in enumerate(world["ranks"]):
        names, shape, coord = r["local_mesh"]
        assert names == ("fsdp", "tp") and shape == (2, 2)
        assert list(coord) == [rank // 2, rank % 2]
