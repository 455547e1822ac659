"""The port's owner watchdog and stale-session reaper
(``ray_tpu_torch._private.reaper``): the twins of
``tests/test_watchdog_reaper.py`` on the port's daemons, arenas
(``/dev/shm/rtpu_torch_*``) and sessions (``<tmp>/ray_tpu_torch``), and
the line between the two packages: the port's sweep never touches a JAX
daemon or a JAX arena, and the JAX sweep spares a port arena that is
still mapped."""

import mmap
import os
import signal
import subprocess
import sys
import textwrap
import time
import uuid

import pytest

from ray_tpu._private import reaper as jax_reaper
from ray_tpu_torch._private import reaper
from ray_tpu_torch._private.watchdog import proc_start_time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pids_matching(marker: str):
    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        if marker in cmd:
            out.append(int(d))
    return out


def _dead_pid() -> int:
    """A pid that is certainly dead: spawn and reap a trivial process."""
    dead = subprocess.Popen([sys.executable, "-c", "pass"])
    dead.wait()
    return dead.pid


def _arena(directory, name: str) -> str:
    """An unmapped 4 KiB arena file ``name`` in ``directory``."""
    path = os.path.join(os.path.realpath(directory), name)
    with open(path, "wb") as f:
        f.write(b"\0" * 4096)
    return path


def _held_shm_arena(prefix: str):
    """A 4 KiB arena in /dev/shm under a name of its own (pid and uuid),
    open from the moment it is made, so that no sweep of any package can
    count it unheld; returns (path, fd, mmap)."""
    path = f"/dev/shm/{prefix}{os.getpid()}_{uuid.uuid4().hex}"
    fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_EXCL, 0o600)
    os.ftruncate(fd, 4096)
    return path, fd, mmap.mmap(fd, 4096)


def _start_controller(tmp_path, owner_pid: int, module: str):
    """A controller daemon of ``module``'s package whose recorded owner is
    ``owner_pid`` (watchdog off: the reaper is under test)."""
    env = dict(os.environ)
    for prefix in ("RAY_TPU_", "RAY_TPU_TORCH_"):
        env[f"{prefix}OWNER_WATCHDOG"] = "0"
        env[f"{prefix}OWNER_PID"] = str(owner_pid)
    addr_file = str(tmp_path / "addr")
    proc = subprocess.Popen(
        [sys.executable, "-m", module, "--port", "0",
         "--session-dir", str(tmp_path), "--address-file", addr_file],
        env=env, cwd=REPO, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and not os.path.exists(addr_file):
        time.sleep(0.05)
    assert os.path.exists(addr_file), f"{module} never came up"
    return proc


def _stop(proc):
    if proc.poll() is None:
        proc.kill()
    proc.wait()


def test_proc_start_time():
    me = proc_start_time(os.getpid())
    assert isinstance(me, int) and me > 0
    assert proc_start_time(2 ** 22 + 12345) is None


def test_markers_and_prefix_are_the_ports():
    assert all(m.startswith("ray_tpu_torch._private.")
               for m in reaper._DAEMON_MARKERS)
    # no port marker is inside a JAX daemon's cmdline, nor the reverse
    for m in reaper._DAEMON_MARKERS:
        assert not any(m in j or j in m for j in jax_reaper._DAEMON_MARKERS)
    assert reaper.ARENA_PREFIX == "rtpu_torch_"


def test_daemon_tree_collapses_on_driver_sigkill():
    """kill -9 the driver -> controller+supervisor+workers all exit."""
    script = textwrap.dedent(f"""
        import sys, time
        sys.path.insert(0, {REPO!r})
        import ray_tpu_torch as rt

        rt.init(num_cpus=1, num_gpus=0, object_store_memory=64 * 1024 * 1024)
        assert rt.get(rt.remote(lambda x: x + 1).remote(1)) == 2
        print("READY", flush=True)
        time.sleep(120)
    """)
    env = dict(os.environ)
    env["RAY_TPU_TORCH_WATCHDOG_INTERVAL_S"] = "0.2"
    proc = subprocess.Popen([sys.executable, "-c", script], env=env,
                            stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert "READY" in line, f"driver failed to start: {line!r}"
        session_pids = [
            p for p in _pids_matching("ray_tpu_torch._private.")
            if reaper._read_env_var(p, "RAY_TPU_TORCH_OWNER_PID")
            == str(proc.pid)]
        assert session_pids, "driver spawned no daemons?"
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            alive = [p for p in session_pids
                     if proc_start_time(p) is not None]
            if not alive:
                return
            time.sleep(0.2)
        pytest.fail(f"daemons survived driver SIGKILL: {alive}")
    finally:
        if proc.poll() is None:
            proc.kill()


def test_reaper_removes_unmapped_arena(tmp_path):
    path = _arena(tmp_path, "rtpu_torch_arena_test_stale_deadbeef")
    removed = reaper.reap_stale_arenas(shm_dir=str(tmp_path))
    assert removed == [path]
    assert not os.path.exists(path)


def test_reaper_keeps_mapped_arena(tmp_path):
    path = _arena(tmp_path, "rtpu_torch_arena_test_live_cafef00d")
    fd = os.open(path, os.O_RDWR)
    try:
        mm = mmap.mmap(fd, 4096)
        assert reaper.reap_stale_arenas(shm_dir=str(tmp_path)) == []
        assert os.path.exists(path)
        mm.close()
    finally:
        os.close(fd)


def test_reaper_keeps_an_arena_only_opened(tmp_path):
    """An arena open but not yet mapped (a supervisor starting) is held."""
    path = _arena(tmp_path, "rtpu_torch_arena_test_opening_f00dcafe")
    fd = os.open(path, os.O_RDWR)
    try:
        assert reaper.reap_stale_arenas(shm_dir=str(tmp_path)) == []
        assert os.path.exists(path)
    finally:
        os.close(fd)


def test_port_sweep_spares_a_jax_arena(tmp_path):
    path = _arena(tmp_path, "rtpu_arena_test_jax_owned_0badf00d")
    stale = _arena(tmp_path, "rtpu_torch_arena_test_stale_0badf00d")
    assert reaper.reap_stale_arenas(shm_dir=str(tmp_path)) == [stale]
    assert os.path.exists(path)


def test_jax_sweep_spares_a_mapped_port_arena():
    """The JAX package's ``rtpu_`` prefix also matches the port's arenas;
    one a live process maps survives its sweep of /dev/shm (the JAX
    package's sweep reads no other directory)."""
    path, fd, mm = _held_shm_arena("rtpu_torch_arena_test_live_")
    try:
        assert path not in jax_reaper.reap_stale_arenas()
        assert os.path.exists(path)
    finally:
        mm.close()
        os.close(fd)
        os.unlink(path)


def test_reaper_kills_daemon_with_dead_owner(tmp_path):
    proc = _start_controller(tmp_path, _dead_pid(),
                             "ray_tpu_torch._private.controller")
    try:
        assert proc.pid in reaper.find_stale_daemons()
        assert proc.pid in reaper.reap_stale_daemons()
        proc.wait(timeout=5)
    finally:
        _stop(proc)


def test_reaper_spares_daemon_with_live_owner(tmp_path):
    proc = _start_controller(tmp_path, os.getpid(),
                             "ray_tpu_torch._private.controller")
    try:
        assert proc.pid not in reaper.find_stale_daemons()
        assert proc.poll() is None
    finally:
        _stop(proc)


def test_port_sweep_spares_a_jax_daemon(tmp_path):
    """A JAX controller whose owner is dead is stale to the JAX reaper,
    and invisible to the port's: its sweep neither lists nor signals it.
    (A JAX sweep elsewhere on the machine may reap it meanwhile; that
    takes nothing from what the port's sweep is shown to do.)"""
    proc = _start_controller(tmp_path, _dead_pid(),
                             "ray_tpu._private.controller")
    try:
        assert (proc.pid in jax_reaper.find_stale_daemons()
                or proc.poll() is not None)
        assert proc.pid not in reaper.find_stale_daemons()
        assert proc.pid not in reaper.reap_stale_daemons()
    finally:
        _stop(proc)


def test_stale_sessions_of_the_port_only(tmp_path):
    """A port session dir whose owner died and that is older than the
    cut goes; a JAX one of the same age and a port one whose owner lives
    stay."""
    base = os.path.join(str(tmp_path), "ray_tpu_torch")
    jax_base = os.path.join(str(tmp_path), "ray_tpu")
    dead = _dead_pid()
    paths = {
        "stale": os.path.join(base, f"session_{time.time_ns()}_{dead}"),
        "live": os.path.join(base, f"session_{time.time_ns()}_{os.getpid()}"),
        "jax": os.path.join(jax_base, f"session_{time.time_ns()}_{dead}"),
    }
    old = time.time() - 7200
    for p in paths.values():
        os.makedirs(os.path.join(p, "logs"))
        os.utime(p, (old, old))
    removed = reaper.reap_stale_sessions(max_age_s=3600,
                                         tmp_dir=str(tmp_path))
    assert removed == [paths["stale"]]
    assert not os.path.exists(paths["stale"])
    assert os.path.exists(paths["live"]) and os.path.exists(paths["jax"])


def test_reap_all_reports_counts(tmp_path):
    _arena(tmp_path, "rtpu_torch_arena_test_stale_5eed5eed")
    out = reaper.reap_all(shm_dir=str(tmp_path))
    assert set(out) == {"daemons", "arenas", "sessions"}
    assert all(isinstance(v, int) and v >= 0 for v in out.values())
    assert out["arenas"] == 1 and os.listdir(tmp_path) == []
