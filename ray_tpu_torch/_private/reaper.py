"""Stale-session reaper: clean up daemons/arenas orphaned by killed runs.

The failure mode this defends: a SIGKILLed driver leaves a
controller+supervisor+worker tree behind, and a worker that held a card
keeps its memory and CUDA context from every later run. The owner
watchdog (watchdog.py) makes new trees self-collapse; this module sweeps
trees and /dev/shm arenas left by OLD runs (or runs with the watchdog
disabled) before a harness touches the card. Reference analog: the
raylet/GCS reconnect-and-fence machinery
(`src/ray/raylet/node_manager.cc:1432`, `gcs_health_check_manager.h:39`)
— here collapsed into an explicit pre-flight sweep because harnesses,
not a long-lived cluster, own the machine.

Only processes that are provably the port's are touched: the cmdline
must name a ``ray_tpu_torch._private`` daemon module. A daemon is stale
when its recorded owner (RAY_TPU_TORCH_OWNER_PID env, falling back to
the pid encoded in its --session-dir) is dead, or when it has been
orphaned to init. Arenas are the port's ``/dev/shm/rtpu_torch_*`` files
and sessions its ``<tmp>/ray_tpu_torch/session_*`` dirs; the JAX
package's daemons (``ray_tpu._private``), arenas (``rtpu_arena_*``) and
sessions are never touched.
"""

from __future__ import annotations

import logging
import os
import re
import signal
import tempfile
import time
from typing import Dict, List, Optional, Set

from ray_tpu_torch._private.watchdog import (ENV_OWNER_PID, ENV_OWNER_START,
                                             proc_start_time)

logger = logging.getLogger(__name__)

_DAEMON_MARKERS = (
    "ray_tpu_torch._private.controller",
    "ray_tpu_torch._private.supervisor",
    "ray_tpu_torch._private.workers.default_worker",
)
# the port's object-store arenas (supervisor.py names them
# rtpu_torch_arena_<...>); the JAX package's are rtpu_arena_*
ARENA_PREFIX = "rtpu_torch_"
SHM_DIR = "/dev/shm"
_SESSION_PID_RE = re.compile(r"session_\d+_(\d+)")


def _read_cmdline(pid: int) -> str:
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return f.read().replace(b"\0", b" ").decode(errors="replace")
    except OSError:
        return ""


def _read_env_var(pid: int, name: str) -> Optional[str]:
    try:
        with open(f"/proc/{pid}/environ", "rb") as f:
            blob = f.read()
    except OSError:
        return None
    needle = name.encode() + b"="
    for entry in blob.split(b"\0"):
        if entry.startswith(needle):
            return entry[len(needle):].decode(errors="replace")
    return None


def _ppid(pid: int) -> Optional[int]:
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            data = f.read()
        return int(data[data.rindex(b")") + 2 :].split()[1])
    except Exception:
        return None


def _alive(pid: int) -> bool:
    return proc_start_time(pid) is not None


def find_stale_daemons() -> List[int]:
    """Pids of ray_tpu_torch daemons whose owning driver is dead."""
    me = os.getpid()
    stale: List[int] = []
    try:
        pids = [int(d) for d in os.listdir("/proc") if d.isdigit()]
    except OSError:
        return stale
    for pid in pids:
        if pid == me:
            continue
        cmd = _read_cmdline(pid)
        if not cmd or not any(m in cmd for m in _DAEMON_MARKERS):
            continue
        owner: Optional[int] = None
        owner_start: Optional[int] = None
        raw = _read_env_var(pid, ENV_OWNER_PID)
        if raw and raw.isdigit():
            owner = int(raw)
            raw_start = _read_env_var(pid, ENV_OWNER_START)
            if raw_start and raw_start.isdigit():
                owner_start = int(raw_start)
        else:
            m = _SESSION_PID_RE.search(cmd)
            if m:
                owner = int(m.group(1))
        if owner is not None:
            cur_start = proc_start_time(owner)
            owner_alive = cur_start is not None and (
                # start-time stamp (when present) defends against the
                # owner pid being recycled by an unrelated process — a
                # wedged orphan must not survive the sweep behind a
                # look-alike pid
                owner_start is None or cur_start == owner_start)
            if owner == me or owner_alive:
                continue
            stale.append(pid)
        else:
            # No provenance (pre-watchdog daemon). Every legitimate
            # spawner is a python driver/CLI and daemons are its direct
            # children; a non-python parent means the daemon was
            # reparented — to init OR a child-subreaper (claude/tmux/
            # systemd set PR_SET_CHILD_SUBREAPER, so ppid==1 alone is
            # not a reliable orphan test).
            ppid = _ppid(pid)
            if ppid is None or ppid == 1 or \
                    "python" not in _read_cmdline(ppid).lower():
                stale.append(pid)
    return stale


def reap_stale_daemons(grace_s: float = 2.0) -> List[int]:
    """SIGTERM stale daemons, SIGKILL survivors after *grace_s*.

    Runs to a fixpoint (bounded): killing a stale supervisor makes its
    workers stale on the NEXT scan (their owner was alive during the
    first), so one pass is not enough to collapse a whole orphan tree —
    and a card-holding worker is exactly the process that must not
    survive the sweep.
    """
    reaped: List[int] = []
    for _round in range(3):
        stale = [p for p in find_stale_daemons() if p not in reaped]
        if not stale:
            break
        logger.warning("reaping %d stale ray_tpu_torch daemons: %s",
                       len(stale), stale)
        for pid in stale:
            try:
                os.kill(pid, signal.SIGTERM)
            except OSError:
                pass
        deadline = time.monotonic() + grace_s
        while time.monotonic() < deadline and any(_alive(p) for p in stale):
            time.sleep(0.05)
        for pid in stale:
            if _alive(pid):
                try:
                    os.kill(pid, signal.SIGKILL)
                except OSError:
                    pass
        reaped.extend(stale)
        time.sleep(0.3)  # let ppid-watch cascades land before re-scanning
    return reaped


def _mapped_shm_paths(shm_dir: str = SHM_DIR) -> Set[str]:
    """Every path under *shm_dir* currently mmapped or opened by a live
    process."""
    root = shm_dir.rstrip("/") + "/"
    mapped: Set[str] = set()
    try:
        pids = [d for d in os.listdir("/proc") if d.isdigit()]
    except OSError:
        return mapped
    for pid in pids:
        try:
            with open(f"/proc/{pid}/maps") as f:
                for line in f:
                    idx = line.find(root)
                    if idx >= 0:
                        mapped.add(line[idx:].rstrip("\n").split(" (deleted)")[0])
        except OSError:
            continue
        # an arena can be open-but-not-yet-mapped during startup
        try:
            fddir = f"/proc/{pid}/fd"
            for fd in os.listdir(fddir):
                try:
                    target = os.readlink(os.path.join(fddir, fd))
                except OSError:
                    continue
                if target.startswith(root):
                    mapped.add(target.split(" (deleted)")[0])
        except OSError:
            continue
    return mapped


def reap_stale_arenas(prefix: str = ARENA_PREFIX,
                      shm_dir: str = SHM_DIR) -> List[str]:
    """Unlink object-store arenas in *shm_dir* that no live process
    holds."""
    shm = os.path.realpath(shm_dir)
    try:
        entries = os.listdir(shm)
    except OSError:
        return []
    candidates = [os.path.join(shm, e) for e in entries if e.startswith(prefix)]
    if not candidates:
        return []
    mapped = _mapped_shm_paths(shm)
    removed: List[str] = []
    for path in candidates:
        if path in mapped:
            continue
        try:
            os.unlink(path)
            removed.append(path)
        except OSError:
            pass
    if removed:
        logger.info("removed %d stale shm arenas", len(removed))
    return removed


def reap_stale_sessions(max_age_s: float = 24 * 3600.0,
                        tmp_dir: Optional[str] = None) -> List[str]:
    """Remove <tmp>/ray_tpu_torch/session_* dirs whose owner died, once
    they are older than *max_age_s* (kept around that long for log
    forensics). <tmp> is *tmp_dir*, by default the temp directory."""
    base = os.path.join(tmp_dir or tempfile.gettempdir(), "ray_tpu_torch")
    removed: List[str] = []
    try:
        entries = os.listdir(base)
    except OSError:
        return removed
    now = time.time()
    for entry in entries:
        m = _SESSION_PID_RE.fullmatch(entry)
        if not m:
            continue
        path = os.path.join(base, entry)
        try:
            age = now - os.stat(path).st_mtime
        except OSError:
            continue
        if age < max_age_s or _alive(int(m.group(1))):
            continue
        import shutil

        shutil.rmtree(path, ignore_errors=True)
        removed.append(path)
    return removed


def reap_all(shm_dir: str = SHM_DIR) -> Dict[str, int]:
    """Pre-flight sweep for harnesses: daemons, then the arenas they held
    (in *shm_dir*)."""
    daemons = reap_stale_daemons()
    arenas = reap_stale_arenas(shm_dir=shm_dir)
    sessions = reap_stale_sessions()
    return {
        "daemons": len(daemons),
        "arenas": len(arenas),
        "sessions": len(sessions),
    }


if __name__ == "__main__":
    logging.basicConfig(level="INFO")
    print(reap_all())
