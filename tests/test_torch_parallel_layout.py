"""The port's mesh specs, sharding rules and slice topology against the JAX
package's (``ray_tpu/parallel/{mesh,sharding,slices}.py``), with no process
group: ``ShardingRules.spec``, ``param_specs`` and ``sanitize_spec`` read
only a mesh's axis names and sizes, so the port's side takes a ``MeshSpec``
while JAX's takes a ``Mesh`` over conftest's 8 virtual CPU devices.

Specs are held equal exactly, leaf by leaf, for llama_debug and moe_debug
on fsdp4 x tp2, dp2 x ep2, sp8 and tp8 (where the 2 kv heads and the 4
query heads do not divide and both sides replicate them). JAX's blocks are
scan-stacked, so each of its block specs loses its leading ``"layers"``
entry (always None) before the comparison.
"""


import jax
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from ray_tpu.models import presets as jpresets
from ray_tpu.models import transformer as jtransformer
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import sharding as jsharding
from ray_tpu.parallel import slices as jslices
from ray_tpu_torch.models import presets, transformer
from ray_tpu_torch.parallel import mesh as pmesh
from ray_tpu_torch.parallel import sharding as psharding
from ray_tpu_torch.parallel import slices as pslices

MESHES = {
    "fsdp4_tp2": dict(fsdp=4, tp=2),
    "dp2_ep2": dict(dp=2, ep=2),
    "sp8": dict(sp=8),
    "tp8_undividable_kv": dict(tp=8),
}
MODELS = ("llama_debug", "moe_debug")


def _jax_mesh(sizes):
    spec = jmesh.MeshSpec.of(**sizes)
    return jmesh.build_mesh(spec, devices=jax.devices()[:spec.size])


def _entries(spec):
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e
                 for e in spec)


def _flat(tree, path=""):
    """path -> leaf for the port's trees and JAX's (stacked) dict trees."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}.{k}" if path else k))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{path}.{i}"))
        return out
    return {path: tree}


def _expected_placements(spec, names):
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry,) if isinstance(entry, str) else entry:
            out[names.index(a)] = Shard(d)
    return tuple(out)


@pytest.mark.parametrize("sizes", [
    dict(), dict(dp=1), dict(fsdp=4, tp=2), dict(tp=2, fsdp=4),
    dict(pp=2, dp=2, fsdp=2), dict(ep=2, dp=2), dict(sp=8),
    dict(pp=2, ep=2, tp=2), dict(dp=2, fsdp=1, tp=4)])
def test_mesh_spec_of_matches_jax(sizes):
    want = jmesh.MeshSpec.of(**sizes)
    got = pmesh.MeshSpec.of(**sizes)
    assert got.axes == want.axes
    assert (got.size, got.names, got.shape) == (want.size, want.names,
                                                 want.shape)
    for a in jmesh.AXIS_ORDER:
        assert got.axis_size(a) == want.axis_size(a)


@pytest.mark.parametrize("n,tp,fsdp", [(1, 1, True), (8, 1, True),
                                       (8, 2, True), (8, 2, False),
                                       (4, 8, True), (6, 2, False)])
def test_mesh_spec_auto_matches_jax(n, tp, fsdp):
    want = jmesh.MeshSpec.auto(n, model_needs_tp=tp, fsdp=fsdp)
    got = pmesh.MeshSpec.auto(n, model_needs_tp=tp, fsdp=fsdp)
    assert got.axes == want.axes


def test_mesh_spec_refuses_unknown_axis():
    with pytest.raises(ValueError, match="unknown mesh axis"):
        pmesh.MeshSpec.of(xp=2)
    assert pmesh.AXIS_ORDER == jmesh.AXIS_ORDER


def test_build_mesh_needs_a_group():
    with pytest.raises(RuntimeError, match="process group"):
        pmesh.build_mesh(pmesh.MeshSpec.of(fsdp=2), device_type="cpu")


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_data_sharding_and_rules_match_jax(mesh_name):
    sizes = MESHES[mesh_name]
    jm, pm = _jax_mesh(sizes), pmesh.MeshSpec.of(**sizes)
    assert pmesh.data_sharding(pm).spec == _entries(
        jmesh.data_sharding(jm).spec)
    assert pmesh.replicated(pm).spec == _entries(jmesh.replicated(jm).spec)
    jr, pr = jsharding.ShardingRules(), psharding.ShardingRules()
    assert pr.rules == jr.rules
    for logical in [("batch", "seq", "embed"), ("vocab", "embed"),
                    ("embed", "heads", "head_dim"), ("expert", "embed",
                                                     "mlp"),
                    ("mlp", "mlp"), (None, "kv"), ("layers", "embed_notp")]:
        assert pr.spec(logical, pm) == _entries(jr.spec(logical, jm))
    over_j = jr.with_overrides(embed=None, mlp=("fsdp", "tp"))
    over_p = pr.with_overrides(embed=None, mlp=("fsdp", "tp"))
    assert over_p.spec(("embed", "mlp"), pm) == _entries(
        over_j.spec(("embed", "mlp"), jm))


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_param_specs_and_placements_match_jax(model, mesh_name):
    sizes = MESHES[mesh_name]
    jcfg = getattr(jpresets, model)()
    cfg = getattr(presets, model)()
    jm, pm = _jax_mesh(sizes), pmesh.MeshSpec.of(**sizes)
    jparams = jax.eval_shape(
        lambda: jtransformer.init_params(jcfg, jax.random.PRNGKey(0)))
    jspecs = _flat(jsharding.param_specs(
        jparams, jm, logical=jtransformer.logical_axes(jcfg)))
    params = transformer.init_params(cfg, 0, "cpu",
                                     param_dtype=torch.float32)
    specs = psharding.param_specs(params, pm,
                                  logical=transformer.logical_axes(cfg))
    flat = _flat(specs, "")
    names = pm.names
    n_checked = 0
    for path, spec in _flat(specs).items():
        parts = path.split(".")
        if parts[0] == "blocks":
            jpath = ".".join(["blocks"] + parts[2:])
            want = _entries(jspecs[jpath])
            assert want[0] is None, (jpath, want)
            want = want[1:]
        else:
            want = _entries(jspecs[path])
        assert spec == want, (path, spec, want)
        placements = psharding.spec_to_placements(spec, pm)
        assert placements == _expected_placements(want, names), path
        n_checked += 1
    assert n_checked == len(flat) == len(_flat(params))
    if mesh_name == "tp8_undividable_kv":  # 2 kv heads over tp 8: replicated
        assert specs["blocks"][0]["attn"]["wk"] == (None, None, None)
    if mesh_name == "fsdp4_tp2" and model == "llama_debug":
        pl = psharding.spec_to_placements(
            specs["blocks"][0]["mlp"]["w_gate"], pm)
        assert pl == (Shard(0), Shard(1))  # fsdp on embed, tp on mlp
    if mesh_name == "dp2_ep2" and model == "moe_debug":
        pl = psharding.spec_to_placements(
            specs["blocks"][0]["mlp"]["w_gate"], pm)
        assert pl == (Replicate(), Shard(0))  # experts split over ep


def test_logical_axes_are_jax_less_layers():
    for model in MODELS + ("gpt2_small",):
        jcfg = getattr(jpresets, model)()
        cfg = getattr(presets, model)()
        jaxes = _flat(jtransformer.logical_axes(jcfg))
        axes = _flat(transformer.logical_axes(cfg))
        assert len(axes) == len(
            [p for p in jaxes if not p.startswith("blocks")]) + \
            cfg.num_layers * len([p for p in jaxes if p.startswith("blocks")])
        for path, ax in axes.items():
            parts = path.split(".")
            if parts[0] == "blocks":
                want = jaxes[".".join(["blocks"] + parts[2:])]
                assert want[0] == "layers"
                assert ax == tuple(want[1:]), path
            else:
                assert ax == tuple(jaxes[path]), path


def test_sanitize_and_infer_match_jax():
    jm, pm = _jax_mesh(dict(fsdp=4, tp=2)), pmesh.MeshSpec.of(fsdp=4, tp=2)
    for spec, shape in [((("fsdp", "tp"), None), (8, 3)),
                        ((("fsdp", "tp"), None), (4, 3)),
                        (("tp", "fsdp"), (3, 8)), (("fsdp",), (6,)),
                        ((None, "tp"), (2, 2))]:
        want = jsharding.sanitize_spec(
            jax.sharding.PartitionSpec(*spec), shape, jm)
        assert psharding.sanitize_spec(spec, shape, pm) == _entries(want)
    tree = {"a": np.zeros((4, 16)), "b": np.zeros((7,)),
            "c": np.zeros((3, 3, 2))}
    want = jsharding.infer_logical_axes(tree)
    got = psharding.infer_logical_axes(
        {k: torch.zeros(v.shape) for k, v in tree.items()})
    assert got == {k: tuple(v) for k, v in want.items()}


def test_spec_to_placements_refuses_out_of_order_axes():
    pm = pmesh.MeshSpec.of(dp=2, fsdp=2)
    assert psharding.spec_to_placements((("dp", "fsdp"),), pm) == (
        Shard(0), Shard(0))
    with pytest.raises(ValueError, match="mesh order"):
        psharding.spec_to_placements((("fsdp", "dp"),), pm)


@pytest.mark.parametrize("spec", [("x", "y"), (None, "y"), ("x",),
                                  (("x", "y"),), ()])
def test_placements_to_spec_inverts_spec_to_placements(spec):
    """Every spec of JAX's device-object tests, on its 2x4 ("x", "y")
    mesh: spec -> placements -> the same spec."""
    pm = pmesh.MeshSpec((("x", 2), ("y", 4)))
    placements = psharding.spec_to_placements(spec, pm)
    assert psharding.placements_to_spec(placements, pm) == spec
    # trailing Nones are dropped: JAX's spec keeps what its caller wrote
    assert psharding.placements_to_spec(
        psharding.spec_to_placements(spec + (None,), pm), pm) == spec


def test_placements_to_spec_refuses_partial():
    from torch.distributed.tensor import Partial

    pm = pmesh.MeshSpec((("x", 2), ("y", 4)))
    with pytest.raises(ValueError, match="redistribute"):
        psharding.placements_to_spec((Partial(), Shard(0)), pm)
    with pytest.raises(ValueError, match="2 dims"):
        psharding.placements_to_spec((Shard(0),), pm)


@pytest.mark.parametrize("name", ["v4-8", "v4-32", "v5p-64", "v5e-16",
                                  "v5litepod-256", "v6e-8", "v6e-64",
                                  "v2-8", "v5e-4", " V5P-8 "])
def test_slice_topology_matches_jax(name):
    want = jslices.SliceTopology.parse(name)
    got = pslices.SliceTopology.parse(name)
    assert (got.generation, got.num_chips, got.chips_per_host) == (
        want.generation, want.num_chips, want.chips_per_host)
    assert got.num_hosts == want.num_hosts
    assert got.head_resource == want.head_resource
    # the port asks for the runtime's GPU resource where JAX asks for TPU
    assert got.bundles() == [
        {("GPU" if k == "TPU" else k): v for k, v in b.items()}
        for b in want.bundles()]


def test_slice_topology_refuses_and_detects(monkeypatch):
    for bad in ("tpu", "v5p", "a100-8"):
        with pytest.raises(ValueError):
            pslices.SliceTopology.parse(bad)
        with pytest.raises(ValueError):
            jslices.SliceTopology.parse(bad)
    monkeypatch.delenv("TPU_ACCELERATOR_TYPE", raising=False)
    monkeypatch.delenv("RAY_TPU_TOPOLOGY", raising=False)
    assert pslices.SliceTopology.detect() is None
    monkeypatch.setenv("RAY_TPU_TOPOLOGY", "v5p-16")
    assert pslices.SliceTopology.detect() == pslices.SliceTopology(
        "v5p", 8, 4)
    monkeypatch.setenv("RAY_TPU_TOPOLOGY", "bogus")
    assert pslices.SliceTopology.detect() is None
    assert jslices.SliceTopology.detect() is None


def test_worker_env_for_host_is_env_rendezvous():
    topo = pslices.SliceTopology.parse("v5p-64")
    env = pslices.worker_env_for_host(topo, 3, "10.0.0.2:29500")
    assert env == {"MASTER_ADDR": "10.0.0.2", "MASTER_PORT": "29500",
                   "NODE_RANK": "3", "NNODES": "8"}
    jenv = jslices.worker_env_for_host(jslices.SliceTopology.parse(
        "v5p-64"), 3, "10.0.0.2:29500")
    assert jenv["TPU_WORKER_ID"] == env["NODE_RANK"]
    assert jenv["RAY_TPU_NUM_HOSTS"] == env["NNODES"]
    with pytest.raises(ValueError, match="host:port"):
        pslices.worker_env_for_host(topo, 0, "10.0.0.2")


def test_slice_placement_group_gangs_gpu_bundles():
    import ray_tpu_torch as rt
    from ray_tpu_torch.util.placement_group import remove_placement_group
    from tests.test_torch_runtime_cluster import retire_leftover_jax_runtime

    retire_leftover_jax_runtime()
    topo = pslices.SliceTopology.parse("v5p-8")  # 4 chips on one host
    rt.init(num_cpus=2, num_gpus=4, resources={topo.head_resource: 1.0},
            object_store_memory=64 * 1024 * 1024)
    try:
        pg = pslices.slice_placement_group(topo, name="gang")
        assert pg.wait(30)
        assert pg.bundle_specs == [{"GPU": 4.0, "TPU-v5p-4-head": 1.0}]
        remove_placement_group(pg)
    finally:
        rt.shutdown()
