"""Job submission: run driver entrypoints on the head node.

Analog of the reference's job manager
(`dashboard/modules/job/job_manager.py:405` JobManager.submit_job): an
entrypoint shell command runs as a subprocess on the controller's host
with RAY_TPU_TORCH_ADDRESS pointing at this cluster, stdout/stderr captured to
a per-job log file, status tracked through PENDING/RUNNING/SUCCEEDED/
FAILED/STOPPED. The REST surface (/api/jobs) and the `ray_tpu_torch.scripts.jobs`
CLI wrap this, mirroring `ray job submit/status/logs/stop`.
"""

from __future__ import annotations

import os
import signal
import subprocess
import time
import uuid
from typing import Any, Dict, List, Optional


class JobManager:
    def __init__(self, session_dir: str, cluster_address: str):
        self._dir = os.path.join(session_dir or ".", "job_logs")
        os.makedirs(self._dir, exist_ok=True)
        self._address = cluster_address
        self._jobs: Dict[str, Dict[str, Any]] = {}

    def submit(self, entrypoint: str,
               env_vars: Optional[Dict[str, str]] = None,
               submission_id: Optional[str] = None) -> str:
        job_id = submission_id or f"raysubmit_{uuid.uuid4().hex[:12]}"
        if job_id in self._jobs:
            raise ValueError(f"submission_id {job_id!r} already exists")
        log_path = os.path.join(self._dir, f"{job_id}.log")
        env = dict(os.environ)
        env["RAY_TPU_TORCH_ADDRESS"] = self._address
        env.update(env_vars or {})
        log = open(log_path, "ab")
        proc = subprocess.Popen(
            ["/bin/bash", "-c", entrypoint],
            stdout=log, stderr=subprocess.STDOUT, env=env,
            start_new_session=True,  # signal the whole entrypoint group
        )
        log.close()
        self._jobs[job_id] = {
            "job_id": job_id,
            "entrypoint": entrypoint,
            "proc": proc,
            "log_path": log_path,
            "start_time": time.time(),
            "end_time": None,
            "status": "RUNNING",
        }
        return job_id

    def _refresh(self, rec: Dict[str, Any]) -> None:
        if rec["status"] != "RUNNING":
            return
        code = rec["proc"].poll()
        if code is None:
            return
        rec["end_time"] = time.time()
        rec["status"] = "SUCCEEDED" if code == 0 else "FAILED"
        rec["exit_code"] = code

    def status(self, job_id: str) -> Optional[Dict[str, Any]]:
        rec = self._jobs.get(job_id)
        if rec is None:
            return None
        self._refresh(rec)
        return {k: v for k, v in rec.items() if k != "proc"}

    def list(self) -> List[Dict[str, Any]]:
        for rec in self._jobs.values():
            self._refresh(rec)
        return [{k: v for k, v in r.items() if k != "proc"}
                for r in self._jobs.values()]

    def logs(self, job_id: str, tail_bytes: int = 1024 * 1024) -> str:
        rec = self._jobs.get(job_id)
        if rec is None:
            return ""
        try:
            with open(rec["log_path"], "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size - tail_bytes))
                return f.read().decode(errors="replace")
        except OSError:
            return ""

    def stop(self, job_id: str) -> bool:
        rec = self._jobs.get(job_id)
        if rec is None:
            return False
        self._refresh(rec)
        if rec["status"] != "RUNNING":
            return False
        try:
            os.killpg(os.getpgid(rec["proc"].pid), signal.SIGTERM)
        except Exception:
            try:
                rec["proc"].terminate()
            except Exception:
                pass
        try:
            rec["proc"].wait(timeout=10)
        except Exception:
            try:
                os.killpg(os.getpgid(rec["proc"].pid), signal.SIGKILL)
            except Exception:
                pass
        rec["status"] = "STOPPED"
        rec["end_time"] = time.time()
        return True
