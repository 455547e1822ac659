"""Node bootstrap: spawning the controller and supervisor daemons.

Analog of the reference's node bootstrap (`python/ray/_private/node.py:1342`,
`services.py:1432,1496`): the driver starting a local cluster spawns the
controller process (≈ gcs_server) and a supervisor process (≈ raylet), wires
addresses through files in the session directory, and tears them down on
shutdown.

Daemons never touch a card: they import neither torch nor CUDA, and count
GPUs without opening one (``resources.detect_node_resources``).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, Optional, Tuple

from ray_tpu_torch._private.config import Config

Address = Tuple[str, int]


def _daemon_env(extra: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    from ray_tpu_torch._private.watchdog import owner_env

    env = owner_env(dict(os.environ))  # daemon dies with this process
    # make ray_tpu_torch importable in daemons/workers regardless of cwd
    import ray_tpu_torch

    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(ray_tpu_torch.__file__)))
    existing = env.get("PYTHONPATH", "")
    if pkg_root not in existing.split(os.pathsep):
        env["PYTHONPATH"] = pkg_root + (os.pathsep + existing if existing else "")
    if extra:
        env.update(extra)
    return env


def _wait_for_address_file(path: str, timeout: float = 30.0) -> Address:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if os.path.exists(path):
            with open(path) as f:
                content = f.read().strip()
            if content:
                host, port = content.rsplit(":", 1)
                return (host, int(port))
        time.sleep(0.01)
    raise TimeoutError(f"daemon did not write {path} within {timeout}s")


def new_session_dir() -> str:
    base = os.path.join(tempfile.gettempdir(), "ray_tpu_torch")
    os.makedirs(base, exist_ok=True)
    # ns resolution: two inits in the same second (fast test cycles) must
    # NOT share a dir — a stale controller_address file from the earlier
    # session would short-circuit _wait_for_address_file and hand the new
    # driver a dead controller's port
    session = os.path.join(base,
                           f"session_{time.time_ns()}_{os.getpid()}")
    os.makedirs(os.path.join(session, "logs"), exist_ok=True)
    return session


def start_controller(
    session_dir: str, config: Config, port: int = 0
) -> Tuple[subprocess.Popen, Address]:
    addr_file = os.path.join(session_dir, "controller_address")
    log = open(os.path.join(session_dir, "logs", "controller.log"), "ab")
    proc = subprocess.Popen(
        [
            sys.executable,
            "-m",
            "ray_tpu_torch._private.controller",
            "--port",
            str(port),
            "--session-dir",
            session_dir,
            "--address-file",
            addr_file,
        ],
        env=_daemon_env(config.to_env()),
        stdout=log,
        stderr=subprocess.STDOUT,
    )
    addr = _wait_for_address_file(addr_file)
    return proc, addr


def start_supervisor(
    session_dir: str,
    config: Config,
    controller_addr: Address,
    resources: Optional[Dict[str, float]] = None,
    node_name: str = "",
    labels: Optional[Dict[str, str]] = None,
    env: Optional[Dict[str, str]] = None,
) -> Tuple[subprocess.Popen, Address]:
    """Start a supervisor for one node. ``env`` is set in its environment
    over this process's (a launched node's ``CUDA_VISIBLE_DEVICES``: the
    card ids it hands its workers)."""
    tag = node_name or f"node{int(time.monotonic_ns() % 1_000_000)}"
    addr_file = os.path.join(session_dir, f"supervisor_{tag}_address")
    try:  # a dead node of the same name must not hand over its address
        os.remove(addr_file)
    except FileNotFoundError:
        pass
    log = open(os.path.join(session_dir, "logs", f"supervisor_{tag}.log"), "ab")
    cmd = [
        sys.executable,
        "-m",
        "ray_tpu_torch._private.supervisor",
        "--controller",
        f"{controller_addr[0]}:{controller_addr[1]}",
        "--session-dir",
        session_dir,
        "--address-file",
        addr_file,
        "--node-name",
        tag,
    ]
    if resources is not None:
        cmd += ["--resources", json.dumps(resources)]
    if labels:
        cmd += ["--labels", json.dumps(labels)]
    proc = subprocess.Popen(
        cmd, env=_daemon_env({**config.to_env(), **(env or {})}), stdout=log,
        stderr=subprocess.STDOUT
    )
    addr = _wait_for_address_file(addr_file)
    return proc, addr


class NodeHandle:
    """A locally-started head node (controller + one supervisor)."""

    def __init__(
        self,
        session_dir: str,
        controller_proc: subprocess.Popen,
        controller_addr: Address,
        supervisor_proc: subprocess.Popen,
        supervisor_addr: Address,
    ):
        self.session_dir = session_dir
        self.controller_proc = controller_proc
        self.controller_addr = controller_addr
        self.supervisor_proc = supervisor_proc
        self.supervisor_addr = supervisor_addr

    @classmethod
    def start_head(
        cls,
        config: Config,
        num_cpus: Optional[float] = None,
        num_gpus: Optional[int] = None,
        resources: Optional[Dict[str, float]] = None,
    ) -> "NodeHandle":
        session_dir = new_session_dir()
        controller_proc, controller_addr = start_controller(session_dir, config)
        node_resources = None
        if num_cpus is not None or num_gpus is not None or resources is not None:
            from ray_tpu_torch._private.resources import detect_node_resources

            node_resources = dict(
                detect_node_resources(
                    num_cpus=num_cpus,
                    num_gpus=num_gpus,
                    object_store_bytes=config.object_store_memory_bytes,
                    custom=resources,
                )
            )
        supervisor_proc, supervisor_addr = start_supervisor(
            session_dir, config, controller_addr, resources=node_resources, node_name="head"
        )
        os.environ.setdefault(
            "RAY_TPU_TORCH_ADDRESS", f"{controller_addr[0]}:{controller_addr[1]}"
        )
        return cls(
            session_dir, controller_proc, controller_addr, supervisor_proc, supervisor_addr
        )

    def stop(self) -> None:
        for proc in (self.supervisor_proc, self.controller_proc):
            try:
                proc.terminate()
            except Exception:
                pass
        deadline = time.monotonic() + 3
        for proc in (self.supervisor_proc, self.controller_proc):
            try:
                proc.wait(timeout=max(0.1, deadline - time.monotonic()))
            except Exception:
                try:
                    proc.kill()
                except Exception:
                    pass
