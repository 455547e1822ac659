"""Owner-liveness watchdog: daemons exit when the process that spawned
them dies.

Analog of the reference raylet noticing a client disconnect
(`src/ray/raylet/node_manager.cc:1432` DisconnectClient) and the GCS
health-checking nodes (`src/ray/gcs/gcs_server/gcs_health_check_manager.h:39`):
a SIGKILLed driver must not orphan its controller/supervisor/worker tree.
An orphaned worker holding a card keeps its memory and context from
every later run, so this is load-bearing, not cosmetic.

Chain of custody: the driver spawns controller+supervisors with
``RAY_TPU_TORCH_OWNER_PID`` = driver pid; the supervisor re-stamps worker envs
with its own pid. Each process polls its owner every
``RAY_TPU_TORCH_WATCHDOG_INTERVAL_S`` (default 1s) and hard-exits when the
owner is gone, so a killed driver collapses the whole tree within ~2
poll intervals. Pid-reuse is guarded by comparing the owner's
``/proc/<pid>/stat`` start time recorded at spawn.
"""

from __future__ import annotations

import logging
import os
import signal
import threading
import time
from typing import Optional

logger = logging.getLogger(__name__)

ENV_OWNER_PID = "RAY_TPU_TORCH_OWNER_PID"
ENV_OWNER_START = "RAY_TPU_TORCH_OWNER_START"
ENV_DISABLE = "RAY_TPU_TORCH_OWNER_WATCHDOG"  # set to "0" to disable


def proc_start_time(pid: int) -> Optional[int]:
    """Kernel start time (clock ticks since boot) of *pid*, or None if the
    process does not exist. Field 22 of /proc/<pid>/stat; the comm field
    may contain spaces/parens, so parse after the last ')'."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            data = f.read()
    except OSError:
        return None
    try:
        rest = data[data.rindex(b")") + 2 :].split()
        # rest[0] is field 3 (state); start time is field 22 -> rest[19]
        return int(rest[19])
    except Exception:
        return None


def owner_env(env: dict) -> dict:
    """Stamp *env* so a child started with it watches THIS process."""
    env[ENV_OWNER_PID] = str(os.getpid())
    start = proc_start_time(os.getpid())
    if start is not None:
        env[ENV_OWNER_START] = str(start)
    return env


def _owner_alive(pid: int, expect_start: Optional[int]) -> bool:
    start = proc_start_time(pid)
    if start is None:
        return False
    if expect_start is not None and start != expect_start:
        return False  # pid reused by an unrelated process
    return True


def _kill_children(sig: int = signal.SIGTERM) -> None:
    """Best-effort signal to our direct children (their own watchdogs —
    which watch us — finish the job for grandchildren)."""
    me = os.getpid()
    try:
        pids = [int(d) for d in os.listdir("/proc") if d.isdigit()]
    except OSError:
        return
    for pid in pids:
        try:
            with open(f"/proc/{pid}/stat", "rb") as f:
                data = f.read()
            ppid = int(data[data.rindex(b")") + 2 :].split()[1])
            if ppid == me:
                os.kill(pid, sig)
        except Exception:
            continue


def start_owner_watchdog_from_env(label: str = "") -> Optional[threading.Thread]:
    """Start the watchdog thread if RAY_TPU_TORCH_OWNER_PID is set (and the
    watchdog isn't disabled). Called from every daemon/worker main()."""
    if os.environ.get(ENV_DISABLE, "1") == "0":
        return None
    raw = os.environ.get(ENV_OWNER_PID, "")
    if not raw:
        return None
    try:
        owner = int(raw)
    except ValueError:
        return None
    expect_start: Optional[int] = None
    raw_start = os.environ.get(ENV_OWNER_START, "")
    if raw_start:
        try:
            expect_start = int(raw_start)
        except ValueError:
            expect_start = None
    interval = float(os.environ.get("RAY_TPU_TORCH_WATCHDOG_INTERVAL_S", "1.0"))

    def run() -> None:
        while True:
            if not _owner_alive(owner, expect_start):
                logger.warning(
                    "%s: owner pid %d is gone; exiting", label or "watchdog", owner
                )
                _kill_children()
                # os._exit: the owner is dead, nobody is listening; a
                # graceful asyncio teardown can itself hang on the wedged
                # resource we exist to release.
                os._exit(78)
            time.sleep(interval)

    t = threading.Thread(target=run, name="owner-watchdog", daemon=True)
    t.start()
    return t
