"""Runtime environments: per-task/actor working_dir, py_modules, pip.

Analog of `python/ray/_private/runtime_env/{working_dir,py_modules,pip}.py`:
the driver packages local directories into content-addressed zips uploaded
to the controller KV (≈ the GCS package store,
`runtime_env/packaging.py`); each supervisor materializes them once per
URI under the session dir and spawns workers with

  * cwd = the staged working_dir,
  * PYTHONPATH prepended with working_dir + each py_module parent,
  * for `pip`: a per-requirements-hash venv (--system-site-packages so
    torch & co. resolve from the base image) whose interpreter runs the
    worker (`runtime_env/pip.py` analog; installs run with --no-index
    unless the env sets RAY_TPU_TORCH_PIP_INDEX — this image has no egress).

`env_vars` stays supported as before.
"""

from __future__ import annotations

import asyncio
import hashlib
import io
import logging
import os
import subprocess
import sys
import zipfile
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

_EXCLUDE_DIRS = {".git", "__pycache__", ".venv", "node_modules"}
MAX_PACKAGE_BYTES = 256 * 1024 * 1024


# ------------------------------------------------------------------ driver


def package_local_path(path: str) -> Tuple[str, bytes]:
    """Zip a local file/dir into a deterministic, content-addressed blob.
    Returns (uri, zip_bytes); uri is 'pkg_<sha256[:32]>'."""
    path = os.path.abspath(path)
    if not os.path.exists(path):
        raise FileNotFoundError(f"runtime_env path does not exist: {path}")
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        if os.path.isfile(path):
            zf.write(path, os.path.basename(path))
        else:
            base = os.path.basename(path.rstrip("/")) or "pkg"
            for root, dirs, files in os.walk(path):
                dirs[:] = sorted(d for d in dirs if d not in _EXCLUDE_DIRS)
                for f in sorted(files):
                    full = os.path.join(root, f)
                    rel = os.path.join(base, os.path.relpath(full, path))
                    zf.write(full, rel)
    blob = buf.getvalue()
    if len(blob) > MAX_PACKAGE_BYTES:
        raise ValueError(
            f"runtime_env package {path} is {len(blob)} bytes "
            f"(limit {MAX_PACKAGE_BYTES}); exclude large data")
    uri = "pkg_" + hashlib.sha256(blob).hexdigest()[:32]
    return uri, blob


def resolve_runtime_env(env: Optional[Dict[str, Any]], core) -> Optional[Dict[str, Any]]:
    """Driver-side normalization: local paths become uploaded KV URIs so
    the spec shipped in every TaskSpec is small and location-independent.
    Idempotent for already-resolved specs."""
    if not env:
        return env
    out = dict(env)
    uploads: List[Tuple[str, bytes]] = []

    def upload_path(p: str) -> str:
        uri, blob = package_local_path(p)
        uploads.append((uri, blob))
        return uri

    wd = out.get("working_dir")
    if wd and not str(wd).startswith("pkg_"):
        out["working_dir"] = upload_path(wd)
    mods = out.get("py_modules")
    if mods:
        out["py_modules"] = [
            m if str(m).startswith("pkg_") else upload_path(m) for m in mods
        ]
    pip = out.get("pip")
    if pip is not None:
        if isinstance(pip, str):
            pip = [line.strip() for line in open(pip) if line.strip()]
        out["pip"] = list(pip)

    async def put_all():
        ctrl = core.clients.get(core.controller_addr)
        for uri, blob in uploads:
            exists = await ctrl.call("kv_exists", {"ns": "pkg", "key": uri})
            if not exists:
                await ctrl.call(
                    "kv_put",
                    {"ns": "pkg", "key": uri, "value": blob,
                     "overwrite": False})

    if uploads:
        core._run(put_all())
    return out


# -------------------------------------------------------------- supervisor


class WorkerEnvSpec:
    """What _spawn_worker needs: interpreter, cwd, extra env, and (for
    container envs) how to wrap the worker command in an engine run."""

    def __init__(self, python: str = sys.executable,
                 cwd: Optional[str] = None,
                 env_vars: Optional[Dict[str, str]] = None):
        self.python = python
        self.cwd = cwd
        self.env_vars = env_vars or {}
        # set for container runtime envs: {"engine","image","run_options"}
        self.container: Optional[Dict[str, Any]] = None
        # env-files minted by wrap_command, pending deletion by the
        # spawner once the engine has consumed them (they hold secrets)
        self.env_files: List[str] = []

    def wrap_command(self, cmd: List[str], env: Dict[str, str],
                     mounts: List[str],
                     env_file_dir: Optional[str] = None) -> List[str]:
        """Wrap the worker argv in an engine invocation (ref
        `python/ray/_private/runtime_env/container.py` worker-command
        injection). Host networking + IPC so the worker reaches the
        supervisor/controller sockets and maps the /dev/shm arena.

        Env is forwarded through a 0600 ``--env-file``, NOT ``--env k=v``
        argv: the worker env carries secrets (user env_vars, cloud
        credentials inherited from the driver), and argv is world-readable
        through ``ps``/``/proc/<pid>/cmdline`` for the lifetime of the
        engine client process."""
        if not self.container:
            return cmd
        argv = [self.container["engine"], "run", "--rm",
                "--network=host", "--ipc=host"]
        for m in mounts:
            argv += ["-v", f"{m}:{m}"]
        if self.cwd:
            argv += ["--workdir", self.cwd]
        import tempfile

        fd, env_path = tempfile.mkstemp(  # mkstemp => mode 0600
            prefix="rtpu_env_", suffix=".env", dir=env_file_dir)
        with os.fdopen(fd, "w") as f:
            for k, v in env.items():
                if "\n" in k or "\n" in str(v):
                    # the env-file format is line-based; a newline value
                    # cannot be represented — drop it rather than corrupt
                    # the vars after it
                    logger.warning(
                        "container env var %s dropped (embedded newline)",
                        k)
                    continue
                f.write(f"{k}={v}\n")
        self.env_files.append(env_path)
        argv += ["--env-file", env_path]
        argv += list(self.container.get("run_options") or [])
        argv.append(self.container["image"])
        return argv + cmd


class RuntimeEnvManager:
    """Materializes runtime env resources once per URI/hash on one node
    (≈ the per-node runtime env agent, `runtime_env/agent/`)."""

    def __init__(self, session_dir: str, node_tag: str, kv_get):
        """kv_get: async (ns, key) -> bytes | None (controller KV)."""
        self._root = os.path.join(session_dir, "runtime_envs", node_tag)
        os.makedirs(self._root, exist_ok=True)
        self._kv_get = kv_get
        self._locks: Dict[str, asyncio.Lock] = {}
        self._ready: Dict[str, str] = {}  # uri/hash -> staged path

    def _lock(self, key: str) -> asyncio.Lock:
        if key not in self._locks:
            self._locks[key] = asyncio.Lock()
        return self._locks[key]

    async def setup(self, runtime_env: Optional[Dict[str, Any]]) -> WorkerEnvSpec:
        spec = WorkerEnvSpec()
        if not runtime_env:
            return spec
        paths: List[str] = []
        wd = runtime_env.get("working_dir")
        if wd:
            staged = await self._ensure_package(wd)
            # the zip wraps a single top-level dir (or file) — the
            # working dir is that entry
            entries = os.listdir(staged)
            spec.cwd = (os.path.join(staged, entries[0])
                        if len(entries) == 1 else staged)
            paths.append(spec.cwd)
        for uri in runtime_env.get("py_modules") or []:
            staged = await self._ensure_package(uri)
            paths.append(staged)
        pip = runtime_env.get("pip")
        conda = runtime_env.get("conda")
        if pip and conda:
            raise ValueError(
                "runtime_env: 'pip' and 'conda' are mutually exclusive "
                "(install pip packages inside the conda spec)")
        if pip:
            spec.python = await self._ensure_venv(pip)
        if conda:
            spec.python = await self._ensure_conda(conda)
        container = runtime_env.get("container")
        if container:
            spec.container = self._container_spec(container)
        if paths:
            spec.env_vars["RAY_TPU_TORCH_RUNTIME_ENV_PYTHONPATH"] = os.pathsep.join(
                paths)
        return spec

    async def _ensure_conda(self, conda) -> str:
        """Conda env interpreter (ref
        `python/ray/_private/runtime_env/conda.py`): a string names an
        EXISTING env (or prefix path); a dict is an environment spec
        created once per content hash under the session dir. Gated on a
        conda binary (RAY_TPU_TORCH_CONDA_EXE overrides discovery)."""
        import shutil

        conda_exe = os.environ.get("RAY_TPU_TORCH_CONDA_EXE") or \
            shutil.which("conda") or shutil.which("mamba")
        if not conda_exe:
            raise RuntimeError(
                "runtime_env 'conda' requires a conda/mamba binary on "
                "PATH (or RAY_TPU_TORCH_CONDA_EXE); none found on this node")
        if isinstance(conda, str):
            # named env or explicit prefix path
            if os.sep in conda:
                prefix = conda
            else:
                base = (await self._run_out(
                    [conda_exe, "info", "--base"])).strip()
                prefix = os.path.join(base, "envs", conda)
            python = os.path.join(prefix, "bin", "python")
            if not os.path.exists(python):
                raise RuntimeError(
                    f"conda env {conda!r} has no interpreter at {python}")
            return python
        # dict spec -> content-addressed created env
        import json

        key = "conda_" + hashlib.sha256(
            json.dumps(conda, sort_keys=True).encode()).hexdigest()[:16]
        async with self._lock(key):
            ready = self._ready.get(key)
            if ready:
                return ready
            prefix = os.path.join(self._root, key)
            python = os.path.join(prefix, "bin", "python")
            if not os.path.exists(python):
                spec_path = os.path.join(self._root, key + ".yml")
                with open(spec_path, "w") as f:
                    f.write(_conda_spec_yaml(conda))
                await self._run_cmd([conda_exe, "env", "create", "-y",
                                     "-p", prefix, "-f", spec_path])
                if not os.path.exists(python):
                    raise RuntimeError(
                        f"conda env create produced no interpreter "
                        f"at {python}")
            self._ready[key] = python
            return python

    @staticmethod
    def _container_spec(container) -> Dict[str, Any]:
        """Validate + resolve the container engine (ref
        `python/ray/_private/runtime_env/container.py`). Gated on a
        podman/docker binary (RAY_TPU_TORCH_CONTAINER_RUNTIME overrides)."""
        import shutil

        if isinstance(container, str):
            container = {"image": container}
        image = container.get("image")
        if not image:
            raise ValueError("runtime_env 'container' needs an 'image'")
        engine = os.environ.get("RAY_TPU_TORCH_CONTAINER_RUNTIME") or \
            shutil.which("podman") or shutil.which("docker")
        if not engine:
            raise RuntimeError(
                "runtime_env 'container' requires podman or docker on "
                "PATH (or RAY_TPU_TORCH_CONTAINER_RUNTIME); none found")
        return {"engine": engine, "image": image,
                "run_options": list(container.get("run_options") or [])}

    @staticmethod
    async def _run_out(cmd: List[str]) -> str:
        proc = await asyncio.create_subprocess_exec(
            *cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        out, _ = await proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(
                f"runtime_env command failed ({' '.join(cmd[:4])}): "
                f"{out.decode(errors='replace')[-2000:]}")
        return out.decode(errors="replace")

    async def _ensure_package(self, uri: str) -> str:
        async with self._lock(uri):
            staged = self._ready.get(uri)
            if staged:
                return staged
            dest = os.path.join(self._root, uri)
            if not os.path.isdir(dest):
                blob = await self._kv_get("pkg", uri)
                if blob is None:
                    raise RuntimeError(
                        f"runtime_env package {uri} not in cluster KV")
                tmp = dest + ".tmp"
                os.makedirs(tmp, exist_ok=True)
                with zipfile.ZipFile(io.BytesIO(blob)) as zf:
                    zf.extractall(tmp)
                os.replace(tmp, dest)
            self._ready[uri] = dest
            return dest

    async def _ensure_venv(self, requirements: List[str]) -> str:
        key = "venv_" + hashlib.sha256(
            "\n".join(sorted(requirements)).encode()).hexdigest()[:16]
        async with self._lock(key):
            ready = self._ready.get(key)
            if ready:
                return ready
            venv_dir = os.path.join(self._root, key)
            python = os.path.join(venv_dir, "bin", "python")
            if not os.path.exists(python):
                await self._run_cmd(
                    [sys.executable, "-m", "venv",
                     "--system-site-packages", venv_dir])
                # --system-site-packages chains to the BASE interpreter; if
                # we ourselves run in a venv (a venv with torch etc.), its
                # site dirs are lost. Inherit the parent's import paths via
                # a .pth so the env venv sees everything this process does.
                sp = os.path.join(
                    venv_dir, "lib",
                    f"python{sys.version_info.major}.{sys.version_info.minor}",
                    "site-packages")
                parent_paths = [
                    p for p in sys.path
                    if p and os.path.isdir(p) and "zip" not in p
                ]
                with open(os.path.join(sp, "_rtpu_inherit.pth"), "w") as f:
                    f.write("\n".join(parent_paths) + "\n")
                pip_cmd = [python, "-m", "pip", "install",
                           "--no-warn-script-location"]
                index = os.environ.get("RAY_TPU_TORCH_PIP_INDEX", "")
                if index:
                    pip_cmd += ["--index-url", index]
                else:
                    # no egress in this image: local paths/wheels only, and
                    # build isolation would try to fetch setuptools
                    pip_cmd += ["--no-index", "--no-build-isolation"]
                pip_cmd += list(requirements)
                await self._run_cmd(pip_cmd)
            self._ready[key] = python
            return python

    @staticmethod
    async def _run_cmd(cmd: List[str]) -> None:
        proc = await asyncio.create_subprocess_exec(
            *cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        out, _ = await proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(
                f"runtime_env command failed ({' '.join(cmd[:4])}...): "
                f"{out.decode(errors='replace')[-2000:]}")


def _conda_spec_yaml(spec: Dict[str, Any]) -> str:
    """Minimal YAML emitter for conda environment specs (name,
    channels, dependencies incl. nested pip lists) — avoids a yaml
    dependency for the one shape `conda env create -f` accepts."""
    lines = []
    if spec.get("name"):
        lines.append(f"name: {spec['name']}")
    for key in ("channels", "dependencies"):
        vals = spec.get(key)
        if not vals:
            continue
        lines.append(f"{key}:")
        for v in vals:
            if isinstance(v, dict):  # {"pip": [...]}
                for k2, sub in v.items():
                    lines.append(f"  - {k2}:")
                    for s in sub:
                        lines.append(f"      - {s}")
            else:
                lines.append(f"  - {v}")
    return "\n".join(lines) + "\n"


def runtime_env_cache_key(runtime_env: Optional[Dict[str, Any]]) -> tuple:
    """The parts of a runtime env that make worker processes
    non-interchangeable (used in the supervisor's worker-pool env key)."""
    if not runtime_env:
        return ()
    conda = runtime_env.get("conda")
    container = runtime_env.get("container")
    if isinstance(container, str):
        container = {"image": container}
    return (
        runtime_env.get("working_dir") or "",
        tuple(runtime_env.get("py_modules") or ()),
        tuple(sorted(runtime_env.get("pip") or ())),
        tuple(sorted((runtime_env.get("env_vars") or {}).items())),
        repr(conda) if conda else "",
        (container.get("image"),
         tuple(container.get("run_options") or ())) if container else (),
    )
