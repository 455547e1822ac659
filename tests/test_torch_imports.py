"""Import hygiene of the port: no module of ``ray_tpu_torch`` and not
``chip_smoke.py`` imports JAX or anything of the JAX package ``ray_tpu``,
nor an HTTP library the card's machine lacks (``aiohttp``, ``httpx``,
``starlette``: the ingress has its own server). The serve ingress modules
never import torch: a proxy or RPC ingress actor needs neither torch nor
a card.
``ray_tpu_torch`` shares the prefix, so module names are matched exactly
(``ray_tpu`` or ``ray_tpu.<sub>``), never by prefix."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "ray_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "ray_tpu", "aiohttp", "httpx", "starlette")
INGRESS = ("ray_tpu_torch/serve/asgi.py",
           "ray_tpu_torch/serve/_private/proxy.py",
           "ray_tpu_torch/serve/_private/http_server.py",
           "ray_tpu_torch/serve/_private/rpc_ingress.py",
           "ray_tpu_torch/serve/rpc_ingress_client.py")


def _banned(name: str, banned=BANNED) -> bool:
    return any(name == b or name.startswith(b + ".") for b in banned)


def _imported_modules(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
            for alias in node.names:
                yield node.lineno, f"{node.module}.{alias.name}"


def test_matcher_tells_the_port_from_the_jax_package():
    assert _banned("ray_tpu") and _banned("ray_tpu.ops.norms")
    assert _banned("jax") and _banned("jax.numpy")
    assert not _banned("ray_tpu_torch") and not _banned("ray_tpu_torch.ops")
    assert not _banned("jaxtyping")
    assert _banned("aiohttp.web") and _banned("httpx")
    assert not _banned("http.client") and not _banned("torchvision",
                                                      ("torch",))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_ray_tpu_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(line, name) for line, name in _imported_modules(tree)
           if _banned(name)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("rel", INGRESS)
def test_ingress_modules_never_import_torch(rel):
    tree = ast.parse((ROOT / rel).read_text(), filename=rel)
    bad = [(line, name) for line, name in _imported_modules(tree)
           if _banned(name, ("torch",))]
    assert not bad, f"{rel} imports {bad}"


def test_importing_the_ingress_loads_no_torch():
    """What the proxy's and the RPC ingress's processes import, with all
    it pulls in: ``torch`` stays out of ``sys.modules``."""
    mods = [rel[:-3].replace("/", ".") for rel in INGRESS]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "print(sorted(m for m in sys.modules "
              "if m == 'torch' or m.startswith('torch.')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


# the collectives' group API, placement groups, air, Train, and the
# pipeline trainer with its tp ops and elastic groups
TRAIN_MODULES = (
    "ray_tpu_torch.util.collective",
    "ray_tpu_torch.util.collective.collective",
    "ray_tpu_torch.util.collective.async_work",
    "ray_tpu_torch.util.collective.shm",
    "ray_tpu_torch.util.placement_group", "ray_tpu_torch.air",
    "ray_tpu_torch.air.config", "ray_tpu_torch.train",
    "ray_tpu_torch.train.backend", "ray_tpu_torch.train.trainer",
    "ray_tpu_torch.train._checkpoint",
    "ray_tpu_torch.train._internal.session",
    "ray_tpu_torch.train._internal.storage",
    "ray_tpu_torch.train._internal.checkpoint_manager",
    "ray_tpu_torch.train._internal.worker_group",
    "ray_tpu_torch.train._internal.backend_executor",
    "ray_tpu_torch.train._internal.gradients",
    # the pipeline and tensor-parallel trainer and the elastic groups
    "ray_tpu_torch.train._internal.pipeline",
    "ray_tpu_torch.util.collective.tp",
    "ray_tpu_torch.util.collective.resizable",
    "ray_tpu_torch._private.elastic",
    "ray_tpu_torch.util.scheduling_strategies",
    "ray_tpu_torch.models.presets", "ray_tpu_torch.models.transformer")


# Tune, the DAG API, workflows and client mode
TUNE_DAG_MODULES = (
    "ray_tpu_torch.tune", "ray_tpu_torch.tune.trial",
    "ray_tpu_torch.tune.search", "ray_tpu_torch.tune.schedulers",
    "ray_tpu_torch.tune.search_external", "ray_tpu_torch.tune.controller",
    "ray_tpu_torch.tune.tuner", "ray_tpu_torch.dag",
    "ray_tpu_torch.workflow", "ray_tpu_torch.util.client",
    "ray_tpu_torch.util.client.common", "ray_tpu_torch.util.client.client",
    "ray_tpu_torch.util.client.server")


def _module_file(mod: str) -> Path:
    path = ROOT / mod.replace(".", "/")
    return path / "__init__.py" if path.is_dir() else path.with_suffix(".py")


@pytest.mark.parametrize("mod", TRAIN_MODULES)
def test_train_and_collective_modules_are_checked(mod):
    """Each module of the slice is one of the files the ast check reads."""
    assert _module_file(mod) in FILES


def test_importing_train_and_collectives_loads_no_jax():
    """Importing the slice's modules, with all they pull in, leaves
    ``jax`` and the JAX package out of ``sys.modules``."""
    code = ("import sys\n" + "".join(f"import {m}\n" for m in TRAIN_MODULES)
            + "print(sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'ray_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("mod", TUNE_DAG_MODULES)
def test_tune_dag_and_client_modules_are_checked(mod):
    assert _module_file(mod) in FILES


def test_importing_tune_dag_and_client_loads_no_jax():
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in TUNE_DAG_MODULES)
            + "print(sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'ray_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_bind_and_client_addresses_no_longer_raise():
    """``.bind`` builds DAG nodes and ``client://`` reaches the client
    branch of ``init``; neither raises ``NotImplementedError``."""
    api = (ROOT / "ray_tpu_torch/_private/api.py").read_text()
    assert "NotImplementedError" not in api
    import ray_tpu_torch as rt
    from ray_tpu_torch.dag import FunctionNode

    @rt.remote
    def f(x):
        return x

    assert isinstance(f.bind(1), FunctionNode)
    from ray_tpu_torch._private.rpc import RpcConnectionError

    with pytest.raises(RpcConnectionError):
        # nothing listens there: the client's connection is refused
        rt.init(address="client://127.0.0.1:1")
    assert not rt.is_initialized()
    # ActorMethod.bind builds a ClassMethodNode (tests/test_torch_dag.py
    # binds the methods of live actors)
    assert "ClassMethodNode(self, args, kwargs)" in api


# the rest of util, the autoscaler, the job CLI and the reaper
UTIL_AUTOSCALER_MODULES = (
    "ray_tpu_torch.util.metrics", "ray_tpu_torch.util.actor_pool",
    "ray_tpu_torch.util.queue", "ray_tpu_torch.util.state",
    "ray_tpu_torch.autoscaler", "ray_tpu_torch.autoscaler.node_provider",
    "ray_tpu_torch.autoscaler.autoscaler", "ray_tpu_torch.autoscaler.v2",
    "ray_tpu_torch.scripts", "ray_tpu_torch.scripts.jobs",
    "ray_tpu_torch._private.reaper")


@pytest.mark.parametrize("mod", UTIL_AUTOSCALER_MODULES)
def test_util_autoscaler_jobs_and_reaper_modules_are_checked(mod):
    assert _module_file(mod) in FILES


def test_importing_util_autoscaler_jobs_and_reaper_loads_no_jax_or_torch():
    """The autoscaler, the job CLI, the reaper and these utilities run in
    processes that need no card: importing them loads neither JAX nor
    torch."""
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in UTIL_AUTOSCALER_MODULES)
            + "print(sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'ray_tpu', 'torch')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_job_manager_names_a_cli_that_exists():
    text = (ROOT / "ray_tpu_torch/_private/job_manager.py").read_text()
    assert "ray_tpu_torch.scripts.jobs" in text
    assert _module_file("ray_tpu_torch.scripts.jobs").exists()
    util = (ROOT / "ray_tpu_torch/util/__init__.py").read_text()
    assert "not ported" not in util


# Data: the package, blocks, the iterator, the dataset, the datasources,
# the execution layer and the native codec
DATA_MODULES = (
    "ray_tpu_torch.data", "ray_tpu_torch.data.block",
    "ray_tpu_torch.data.iterator", "ray_tpu_torch.data.dataset",
    "ray_tpu_torch.data.datasource", "ray_tpu_torch.data._internal",
    "ray_tpu_torch.data._internal.logical",
    "ray_tpu_torch.data._internal.executor",
    "ray_tpu_torch.data._internal.streaming",
    "ray_tpu_torch.data._internal.exchange",
    "ray_tpu_torch._native.codec")


@pytest.mark.parametrize("mod", DATA_MODULES)
def test_data_modules_are_checked(mod):
    assert _module_file(mod) in FILES


def _loaded_heavy(imports, banned=("jax", "jaxlib", "ray_tpu", "torch")):
    code = ("import sys\n" + "".join(f"import {m}\n" for m in imports)
            + "print(sorted(m for m in sys.modules if m.split('.')[0] in "
              f"{banned!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip()


def test_importing_data_loads_no_jax_or_torch():
    """The reader, transform, batcher, producer and consumer actors are
    CPU processes: the data modules import torch only inside the
    functions that make tensors."""
    assert _loaded_heavy(DATA_MODULES) == "[]"


def test_a_worker_starts_without_torch():
    """What every worker process imports at start-up (the worker's main
    module and the collective ring it registers) loads no torch: a CPU
    worker never pays for it."""
    assert _loaded_heavy((
        "ray_tpu_torch._private.workers.default_worker",
        "ray_tpu_torch.util.collective.ring",
        "ray_tpu_torch.util.collective")) == "[]"


# RLlib: the module, the learner, the estimators, replay, connectors, the
# envs and their runners, the algorithms and the Podracer topologies
RLLIB_MODULES = (
    "ray_tpu_torch.rllib", "ray_tpu_torch.rllib.core.rl_module",
    "ray_tpu_torch.rllib.core.learner", "ray_tpu_torch.rllib.utils",
    "ray_tpu_torch.rllib.utils.advantages",
    "ray_tpu_torch.rllib.utils.replay_buffers",
    "ray_tpu_torch.rllib.connectors", "ray_tpu_torch.rllib.env",
    "ray_tpu_torch.rllib.env.synthetic_atari",
    "ray_tpu_torch.rllib.env.single_agent_env_runner",
    "ray_tpu_torch.rllib.env.multi_agent_env",
    "ray_tpu_torch.rllib.algorithms",
    "ray_tpu_torch.rllib.algorithms.algorithm",
    "ray_tpu_torch.rllib.algorithms.algorithm_config",
    "ray_tpu_torch.rllib.algorithms.ppo",
    "ray_tpu_torch.rllib.algorithms.impala",
    "ray_tpu_torch.rllib.algorithms.appo",
    "ray_tpu_torch.rllib.algorithms.dqn",
    "ray_tpu_torch.rllib.algorithms.sac",
    "ray_tpu_torch.rllib.algorithms.marwil",
    "ray_tpu_torch.rllib.algorithms.cql",
    "ray_tpu_torch.rllib.algorithms.dreamerv3",
    "ray_tpu_torch.rllib.podracer")


@pytest.mark.parametrize("mod", RLLIB_MODULES)
def test_rllib_modules_are_checked(mod):
    assert _module_file(mod) in FILES


def test_importing_rllib_loads_no_jax():
    """The whole RLlib port imports in a fresh interpreter without JAX or
    the JAX package (gymnasium, where present, is imported only by the
    synthetic env's registration, as in the JAX package)."""
    assert _loaded_heavy(RLLIB_MODULES,
                         banned=("jax", "jaxlib", "ray_tpu")) == "[]"


def _jax_all(rel: str) -> list:
    """The ``__all__`` list of a JAX package module, read with ``ast`` (this
    file imports nothing of the JAX package)."""
    tree = ast.parse((ROOT / rel).read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError(f"no __all__ in {rel}")


def test_rllib_exports_only_the_ported_algorithms():
    """With SAC, CQL, MARWIL/BC and DreamerV3 ported, the port's two RLlib
    packages export exactly what the JAX package's do, in its order, and
    every name imports."""
    import ray_tpu_torch.rllib as rl
    import ray_tpu_torch.rllib.algorithms as alg

    for mod, rel in ((rl, "ray_tpu/rllib/__init__.py"),
                     (alg, "ray_tpu/rllib/algorithms/__init__.py")):
        assert mod.__all__ == _jax_all(rel), rel
        for name in mod.__all__:
            assert getattr(mod, name) is not None, name
    for name in ("SAC", "SACConfig", "BC", "BCConfig", "MARWIL",
                 "MARWILConfig"):
        assert getattr(rl, name) is getattr(alg, name)
    assert {"CQL", "CQLConfig", "DreamerV3", "DreamerV3Config"} <= set(
        alg.__all__)


SPMD = ("ray_tpu_torch/parallel/__init__.py",
        "ray_tpu_torch/parallel/mesh.py",
        "ray_tpu_torch/parallel/sharding.py",
        "ray_tpu_torch/parallel/_spmd.py",
        "ray_tpu_torch/parallel/pipeline.py",
        "ray_tpu_torch/parallel/slices.py",
        "ray_tpu_torch/ops/ring_attention.py",
        "ray_tpu_torch/models/_mesh_step.py",
        "ray_tpu_torch/scripts/mesh_memory.py")


def test_spmd_modules_are_checked():
    checked = {str(p.relative_to(ROOT)) for p in FILES}
    assert set(SPMD) <= checked


def test_importing_the_spmd_layer_and_its_test_worlds_loads_no_jax():
    """The SPMD layer and the gloo worlds its tests spawn
    (``tests/torch_spmd_worlds.py``): neither ``jax`` nor ``ray_tpu`` in
    ``sys.modules`` after importing them."""
    mods = [rel[:-3].replace("/", ".").removesuffix(".__init__")
            for rel in SPMD] + ["tests.torch_spmd_worlds"]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "print(sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'ray_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
