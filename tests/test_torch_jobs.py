"""Job submission on the port's cluster: the twins of
``tests/test_jobs_dashboard.py::TestJobSubmission`` (REST submit, status,
logs, a failed job, stop, and the CLI's ``submit --follow``), and the
port's job CLI (``python -m ray_tpu_torch.scripts.jobs``) through
``status``, ``logs``, ``list`` and ``stop``, its address from
``RAY_TPU_TORCH_ADDRESS``; a job's driver joins the cluster that ran it
through ``init(address="auto")``. The CLI never imports torch."""

import json
import os
import subprocess
import sys
import time
import urllib.request

import pytest

import ray_tpu_torch as rt
from tests.test_torch_runtime_cluster import \
    retire_leftover_jax_runtime_for_later_files

os.environ.setdefault("RAY_TPU_TORCH_LOG_LEVEL", "WARNING")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI = [sys.executable, "-m", "ray_tpu_torch.scripts.jobs"]


@pytest.fixture(scope="module", autouse=True)
def _no_leftover_jax_runtime():
    yield
    retire_leftover_jax_runtime_for_later_files()


@pytest.fixture(scope="module")
def cluster():
    info = rt.init(num_cpus=8, num_gpus=0,
                   object_store_memory=64 * 1024 * 1024)
    yield info["address"]
    rt.shutdown()


def _controller_http_port():
    from ray_tpu_torch._private import api

    core = api._require_core()
    return core._run(
        core.clients.get(core.controller_addr).call("dashboard_port"))


def _http(port, path, data=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(data).encode() if data is not None else None,
        headers={"Content-Type": "application/json"} if data else {},
    )
    with urllib.request.urlopen(req, timeout=15) as resp:
        body = resp.read().decode()
        ctype = resp.headers.get("Content-Type", "")
    return json.loads(body) if "json" in ctype else body


def _wait_done(port, job_id, timeout=30):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        st = _http(port, f"/api/jobs/{job_id}")
        if st["status"] != "RUNNING":
            return st
        time.sleep(0.3)
    return st


def _cli(*args, address=None, timeout=120):
    env = dict(os.environ)
    env.pop("RAY_TPU_TORCH_ADDRESS", None)
    if address:
        env["RAY_TPU_TORCH_ADDRESS"] = address
    return subprocess.run(CLI + list(args), capture_output=True, text=True,
                          timeout=timeout, cwd=REPO, env=env)


class TestJobSubmission:
    def test_submit_status_logs_via_rest(self, cluster):
        port = _controller_http_port()
        assert port > 0
        out = _http(port, "/api/jobs", {
            "entrypoint":
                f"{sys.executable} -c \"print('JOB-SAYS-HI'); print(2+2)\"",
        })
        job_id = out["job_id"]
        st = _wait_done(port, job_id)
        assert st["status"] == "SUCCEEDED", st
        logs = _http(port, f"/api/jobs/{job_id}/logs")
        assert "JOB-SAYS-HI" in logs and "4" in logs
        listing = _http(port, "/api/jobs")
        assert any(j["job_id"] == job_id for j in listing)

    def test_failed_job_reports_failed(self, cluster):
        port = _controller_http_port()
        out = _http(port, "/api/jobs",
                    {"entrypoint": f"{sys.executable} -c 'raise SystemExit(3)'"})
        st = _wait_done(port, out["job_id"])
        assert st["status"] == "FAILED"
        assert st["exit_code"] == 3

    def test_stop_running_job(self, cluster):
        port = _controller_http_port()
        out = _http(port, "/api/jobs",
                    {"entrypoint": f"{sys.executable} -c 'import time; time.sleep(60)'"})
        job_id = out["job_id"]
        stopped = _http(port, f"/api/jobs/{job_id}/stop", {})
        assert stopped["stopped"] is True
        st = _http(port, f"/api/jobs/{job_id}")
        assert st["status"] == "STOPPED"

    def test_cli_submit_follow(self, cluster):
        proc = _cli("submit", "--address", cluster, "--follow", "--",
                    "echo", "CLI-JOB-OK")
        assert proc.returncode == 0, proc.stderr
        assert "CLI-JOB-OK" in proc.stdout
        assert "status: SUCCEEDED" in proc.stderr


class TestJobCli:
    def test_status_logs_list_agree(self, cluster, tmp_path):
        """A job whose driver joins this cluster (``address="auto"``) and
        runs a task: ``status`` and ``list`` say SUCCEEDED, ``logs`` holds
        the task's answer. The address comes from the environment."""
        script = tmp_path / "driver.py"
        script.write_text(
            f"import sys, json\nsys.path.insert(0, {REPO!r})\n"
            "import ray_tpu_torch as rt\n"
            "info = rt.init(address='auto')\n"
            "double = rt.remote(lambda x: 2 * x)\n"
            "print(json.dumps({'answer': rt.get(double.remote(21), "
            "timeout=60), 'address': info['address']}))\n"
            "rt.shutdown()\n")
        sub = _cli("submit", "--submission-id", "cli-auto", "--",
                   sys.executable, str(script), address=cluster)
        assert sub.returncode == 0, sub.stderr
        assert sub.stdout.strip() == "cli-auto"
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            st = json.loads(_cli("status", "cli-auto",
                                 address=cluster).stdout)
            if st["status"] != "RUNNING":
                break
            time.sleep(0.5)
        assert st["status"] == "SUCCEEDED", _cli("logs", "cli-auto",
                                                 address=cluster).stdout
        listing = json.loads(_cli("list", address=cluster).stdout)
        assert {j["job_id"]: j["status"] for j in listing}["cli-auto"] == \
            "SUCCEEDED"
        logs = _cli("logs", "cli-auto", address=cluster).stdout
        line = next(ln for ln in logs.splitlines() if ln.startswith("{"))
        assert json.loads(line) == {"answer": 42, "address": cluster}

    def test_follow_of_a_failing_job_exits_1(self, cluster):
        proc = _cli("submit", "--address", cluster, "--follow", "--",
                    f"{sys.executable} -c 'import sys; sys.exit(1)'")
        assert proc.returncode == 1
        assert "status: FAILED" in proc.stderr

    def test_stop_and_unknown_job(self, cluster):
        sub = _cli("submit", "--submission-id", "cli-sleep", "--",
                   f"{sys.executable} -c 'import time; time.sleep(60)'",
                   address=cluster)
        assert sub.returncode == 0, sub.stderr
        assert "True" in _cli("stop", "cli-sleep", address=cluster).stdout
        st = json.loads(_cli("status", "cli-sleep", address=cluster).stdout)
        assert st["status"] == "STOPPED"
        missing = _cli("status", "no-such-job", address=cluster)
        assert missing.returncode == 1 and "no such job" in missing.stderr

    def test_refuses_without_an_address_or_entrypoint(self, cluster):
        assert _cli("list").returncode == 2
        assert _cli("submit", address=cluster).returncode == 2
        assert _cli("status", address=cluster).returncode == 2


def test_cli_loads_no_torch():
    code = ("import sys, runpy\n"
            "import ray_tpu_torch.scripts.jobs\n"
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('torch', 'jax', 'ray_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("argv", [
    ["submit", "--address", "h:1", "--submission-id", "s", "--",
     "python", "x.py", "--follow"],
    ["submit", "--submission-id", "s", "--address", "h:1", "--",
     "python", "x.py", "--follow"],
    ["--address", "h:1", "submit", "--submission-id", "s", "--",
     "python", "x.py", "--follow"],
    ["submit", "--address", "h:1", "--submission-id", "s", "python",
     "x.py"],
])
def test_entrypoint_is_everything_after_the_dashes(monkeypatch, argv):
    """Options before ``--`` in any order, and the entrypoint's own
    options after it, which the CLI leaves alone (``--follow`` here is
    the entrypoint's). The split happens before argparse sees the line:
    some argparse versions refuse a ``--`` that follows options once the
    command is matched."""
    from ray_tpu_torch.scripts import jobs

    calls = []

    def fake_call(address, method, body=None):
        calls.append((address, method, body))
        return {"job_id": "s"}

    monkeypatch.setattr(jobs, "_call", fake_call)
    assert jobs.main(argv) == 0
    entry = "python x.py" + (" --follow" if "--" in argv else "")
    assert calls == [("h:1", "job_submit",
                      {"entrypoint": entry, "submission_id": "s"})]


@pytest.mark.parametrize("argv", [
    ["status", "--address", "h:1", "J"],
    ["--address", "h:1", "status", "J"],
    ["status", "J", "--address", "h:1"],
])
def test_job_id_after_options(monkeypatch, argv, capsys):
    """A command's job id may follow its options (the card machine's
    argparse refused ``status --address A J`` until the line was parsed
    intermixed)."""
    from ray_tpu_torch.scripts import jobs

    calls = []

    def fake_call(address, method, body=None):
        calls.append((address, method, body))
        return {"job_id": "J", "status": "SUCCEEDED"}

    monkeypatch.setattr(jobs, "_call", fake_call)
    assert jobs.main(argv) == 0
    assert calls == [("h:1", "job_status", {"job_id": "J"})]
    assert json.loads(capsys.readouterr().out)["status"] == "SUCCEEDED"
