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
