"""The port's state API (``ray_tpu_torch.util.state``), user metrics
(``ray_tpu_torch.util.metrics``), timelines and live profiles on a CPU
cluster: the twins of ``tests/test_observability.py``'s registry, state,
metrics, timeline and profiling cases, and the same inputs through the
JAX package's pure pieces giving the same outputs (the metrics text of the
same registry operations; the timeline of the same task events). Two
repairs of the copied code are held here too: an actor's calls reach the
timeline (with the pid of the worker that ran each), and a listing sees
the caller's own task events that have not filled a batch of 100 yet.
The ``device`` profile reports torch's caching allocator; on the CPU it
says CUDA is not initialized. Actor classes ship by value."""

import json
import os
import sys
import time
import urllib.request

import cloudpickle
import pytest

import ray_tpu_torch as rt
from ray_tpu.util import state as jax_state
from ray_tpu_torch._private import flight
from ray_tpu_torch._private.metrics import Counter, Gauge, Histogram, Registry
from ray_tpu_torch.util import metrics as user_metrics
from ray_tpu_torch.util import state as state_api
from tests.test_torch_runtime_cluster import \
    retire_leftover_jax_runtime_for_later_files

os.environ.setdefault("RAY_TPU_TORCH_LOG_LEVEL", "WARNING")
cloudpickle.register_pickle_by_value(sys.modules[__name__])

TIMEOUT = 60


@pytest.fixture(scope="module", autouse=True)
def _no_leftover_jax_runtime():
    yield
    retire_leftover_jax_runtime_for_later_files()


class TestRegistry:
    def test_counter_and_labels(self):
        reg = Registry()
        c = Counter("t_total", "desc", registry=reg)
        c.inc()
        c.inc(2, labels={"k": "a"})
        text = reg.render_prometheus()
        assert "# TYPE t_total counter" in text
        assert "t_total 1.0" in text
        assert 't_total{k="a"} 2.0' in text

    def test_gauge_set_inc_dec(self):
        reg = Registry()
        g = Gauge("t_gauge", registry=reg)
        g.set(5)
        g.inc()
        g.dec(2)
        assert "t_gauge 4.0" in reg.render_prometheus()

    def test_histogram_buckets(self):
        reg = Registry()
        h = Histogram("t_hist", buckets=(0.1, 1.0, 10.0), registry=reg)
        for v in (0.05, 0.5, 5.0, 500.0):
            h.observe(v)
        text = reg.render_prometheus()
        assert 't_hist_bucket{le="0.1"} 1' in text
        assert 't_hist_bucket{le="1.0"} 2' in text
        assert 't_hist_bucket{le="10.0"} 3' in text
        assert 't_hist_bucket{le="+Inf"} 4' in text
        assert "t_hist_count 4" in text

    def test_type_conflict_raises(self):
        reg = Registry()
        Counter("t_x", registry=reg)
        with pytest.raises(ValueError, match="different type"):
            Gauge("t_x", registry=reg)

    def test_reregister_same_type_reuses_instance(self):
        reg = Registry()
        c1 = Counter("t_reuse_total", "first", registry=reg)
        c1.inc(3)
        c2 = Counter("t_reuse_total", "second", registry=reg)
        assert c1 is c2
        c2.inc(2)
        assert "t_reuse_total 5.0" in reg.render_prometheus()
        c1.inc(1)
        assert "t_reuse_total 6.0" in reg.render_prometheus()
        h1 = Histogram("t_reuse_h", buckets=(1.0, 5.0), registry=reg)
        h1.observe(0.5)
        h2 = Histogram("t_reuse_h", registry=reg)
        assert h1 is h2
        assert h2.buckets == (1.0, 5.0)
        assert h2.count_total() == 1

    def test_user_metrics_are_the_registry_classes(self):
        assert user_metrics.Counter is Counter
        assert user_metrics.Gauge is Gauge
        assert user_metrics.Histogram is Histogram
        Counter("t_user_render_total", "via util.metrics").inc(7)
        assert "t_user_render_total 7.0" in user_metrics.render()


def _registry_ops(mod):
    """The same metric operations on a fresh registry of ``mod``."""
    reg = mod.Registry()
    c = mod.Counter("ops_total", "ops done", registry=reg)
    c.inc()
    c.inc(2.5, labels={"kind": "a"})
    c.inc(1, labels={"kind": "b", "node": "x"})
    g = mod.Gauge("queue_depth", "items", registry=reg)
    g.set(7)
    g.dec(3, labels={"q": "z"})
    h = mod.Histogram("lat_s", "latency", buckets=(0.01, 0.1, 1.0),
                      registry=reg)
    for v in (0.005, 0.05, 0.5, 5.0, 0.07):
        h.observe(v)
    h.observe(0.2, labels={"route": "/x"})
    return reg.render_prometheus()


def test_metrics_text_equals_the_jax_package():
    """The same registry operations render the same exposition text."""
    from ray_tpu._private import metrics as jax_metrics
    from ray_tpu_torch._private import metrics as port_metrics

    assert _registry_ops(port_metrics) == _registry_ops(jax_metrics)


def _synthetic_task_events():
    """Task events as the controller's sink holds them: tasks with every
    span, a task still running, one that failed, one reconstructed."""
    evs = []
    t = 1_700_000_000.0
    for i in range(6):
        tid = f"{i:02d}" + "ab" * 10
        node = "node-" + "c" * 20 if i % 2 else ""
        states = [("SUBMITTED", 0.0), ("PUSHED", 0.01 * (i + 1))]
        if i == 3:
            states.append(("FAILED", 0.2))
        elif i == 4:
            states = [("SUBMITTED", 0.0), ("RECONSTRUCTING", 0.05),
                      ("PUSHED", 0.06), ("FINISHED", 0.3)]
        elif i != 5:
            states.append(("FINISHED", 0.1 + 0.05 * i))
        for state, dt in states:
            evs.append({"task_id": tid, "name": f"work{i % 3}",
                        "state": state, "ts": t + i + dt, "job_id": "01",
                        "kind": "NORMAL_TASK", "node": node})
    return evs


def test_timeline_format_equals_the_jax_package(monkeypatch, tmp_path):
    """The same task events through the port's ``timeline`` and the JAX
    package's: the same Chrome-trace events, and the same file."""
    events = _synthetic_task_events()
    monkeypatch.setattr(state_api, "_call", lambda m, b=None: list(events))
    monkeypatch.setattr(state_api, "_flush_own_events", lambda: None)
    monkeypatch.setattr(jax_state, "_call", lambda m, b=None: list(events))
    port = state_api.timeline(str(tmp_path / "port.json"))
    jax_trace = jax_state.timeline(str(tmp_path / "jax.json"))
    assert port == jax_trace and len(port) == 11
    assert json.load(open(tmp_path / "port.json")) == \
        json.load(open(tmp_path / "jax.json"))
    assert state_api.summarize_tasks() == jax_state.summarize_tasks()


def test_timeline_names_the_worker_pid(monkeypatch):
    """An end event with ``worker_pid`` puts it in the span's args; the
    rest of the event is as above."""
    events = _synthetic_task_events()
    for ev in events:
        if ev["state"] == "FINISHED":
            ev["worker_pid"] = 4242
    monkeypatch.setattr(state_api, "_call", lambda m, b=None: list(events))
    monkeypatch.setattr(state_api, "_flush_own_events", lambda: None)
    trace = state_api.timeline()
    runs = {e["tid"]: e["args"].get("worker_pid")
            for e in trace if e["name"].endswith(":run")}
    # tasks 0-2 and 4 finished, 3 failed, 5 is still running
    assert runs == {"00ababab": 4242, "01ababab": 4242, "02ababab": 4242,
                    "03ababab": None, "04ababab": 4242}


def test_timeline_actor_call_span_from_its_run_start(monkeypatch):
    """An actor call records FINISHED alone, with the worker's
    ``run_start``: one run span from that start to FINISHED; a FINISHED
    without ``run_start`` and no PUSHED gives no span."""
    t = 1_700_000_000.0
    base = {"name": "ping", "state": "FINISHED", "job_id": "01",
            "kind": "ACTOR_TASK", "node": "ab" * 14}
    events = [dict(base, task_id="aa" * 12, ts=t + 0.25, run_start=t,
                   worker_pid=77),
              dict(base, task_id="bb" * 12, ts=t + 0.5)]
    monkeypatch.setattr(state_api, "_call", lambda m, b=None: list(events))
    monkeypatch.setattr(state_api, "_flush_own_events", lambda: None)
    (span,) = state_api.timeline()
    assert span["name"] == "ping:run" and span["tid"] == "aa" * 4
    assert span["ts"] == t * 1e6 and span["dur"] == 0.25 * 1e6
    assert span["args"] == {"task_id": "aa" * 12, "state_from": "RUNNING",
                            "worker_pid": 77}


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=32, num_gpus=0, object_store_memory=64 * 1024 * 1024)
    yield
    rt.shutdown()


def _work(i):
    return i * 2


def _traced_work(i):
    time.sleep(0.01)
    return i


class _Holder:
    def ping(self):
        return "ok"

    def pid(self):
        return os.getpid()


class _Busy:
    def __init__(self):
        self.n = 0

    def distinctive_method_name_for_stacks(self, sec):
        end = time.time() + sec
        while time.time() < end:
            self.n += 1
        return self.n


class _Hog:
    def __init__(self):
        self.blob = [bytes(1024) for _ in range(1000)]

    def ping(self):
        return 1


class _TensorHolder:
    def __init__(self):
        import torch

        self.t = torch.ones(256, 256)

    def ready(self):
        return True


class _Scorer:
    """Counts its calls in a user metric, as phase 17's scorers do."""

    def __init__(self):
        self.c = user_metrics.Counter("test_scored_total", "calls scored")

    def score(self, i):
        self.c.inc()
        return i, os.getpid()


class TestClusterObservability:
    def test_scrape_and_state_during_run(self, cluster):
        work = rt.remote(_work)
        assert rt.get([work.remote(i) for i in range(20)],
                      timeout=TIMEOUT) == [i * 2 for i in range(20)]
        a = rt.remote(_Holder).remote()
        assert rt.get(a.ping.remote(), timeout=TIMEOUT) == "ok"

        text = state_api.cluster_metrics()
        assert 'ray_tpu_nodes{state="alive"} 1.0' in text
        assert "ray_tpu_actors" in text

        from ray_tpu_torch._private import api

        core = api._require_core()
        port = core._run(
            core.clients.get(core.supervisor_addr).call("metrics_port"))
        assert port > 0
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=5).read().decode()
        assert "ray_tpu_leases_granted_total" in body
        assert "ray_tpu_workers " in body

        nodes = state_api.list_nodes()
        assert len(nodes) == 1 and nodes[0]["alive"]
        actors = state_api.list_actors(state="ALIVE")
        assert any(rec["class_name"] == "_Holder" for rec in actors)
        assert all("creation_spec" not in rec for rec in actors)
        summary = state_api.summarize_tasks()
        assert summary["_work"]["FINISHED"] >= 20
        jobs = state_api.list_jobs()
        assert any(j["job_id_hex"] == core.job_id.hex() for j in jobs)
        assert isinstance(state_api.list_placement_groups(), list)
        events = state_api.list_cluster_events(limit=100)
        assert any(e["event_type"] == "WORKER_SPAWNED" for e in events)
        rt.kill(a)

    def test_listing_sees_this_process_unflushed_events(self, cluster):
        """Fewer than 100 new events stay in the owner's buffer; the
        listing sends them first (JAX's listing missed them)."""
        from ray_tpu_torch._private import api

        core = api._require_core()
        state_api.list_tasks()  # sends what the earlier tests left
        fresh = rt.remote(_work).options(name="fresh_work")
        assert rt.get([fresh.remote(i) for i in range(3)],
                      timeout=TIMEOUT) == [0, 2, 4]
        tasks = state_api.list_tasks(name="fresh_work")
        assert sorted(t["state"] for t in tasks) == ["FINISHED"] * 3
        assert len(core._task_events) == 0

    def test_timeline_chrome_trace(self, cluster, tmp_path):
        traced = rt.remote(_traced_work)
        rt.get([traced.remote(i) for i in range(30)], timeout=TIMEOUT)
        trace = state_api.timeline(str(tmp_path / "trace.json"))
        run_events = [ev for ev in trace
                      if "_traced_work" in ev["name"]
                      and ":run" in ev["name"]]
        assert len(run_events) == 30
        ev = run_events[0]
        assert ev["ph"] == "X" and ev["dur"] >= 1.0 and ev["ts"] > 0
        loaded = json.load(open(tmp_path / "trace.json"))
        assert len(loaded) == len(trace)

    def test_actor_calls_in_the_timeline_with_worker_pids(self, cluster):
        """Calls on two actors each get a run span from the start their
        worker reported to FINISHED, the only event an actor call records;
        the run spans name the two workers' pids."""
        actors = [rt.remote(_Holder).remote() for _ in range(2)]
        pids = set(rt.get([a.pid.remote() for a in actors],
                          timeout=TIMEOUT))
        rt.get([a.ping.remote() for a in actors for _ in range(5)],
               timeout=TIMEOUT)
        trace = state_api.timeline()
        runs = [e for e in trace if e["name"] == "ping:run"]
        assert len(runs) >= 10
        assert {e["args"].get("worker_pid") for e in runs} >= pids
        assert all(e["args"]["state_from"] == "RUNNING" and e["dur"] >= 1.0
                   for e in runs)
        assert not [e for e in trace if e["name"] == "ping:schedule"]
        summary = state_api.summarize_tasks()
        assert summary["ping"]["FINISHED"] >= 10
        for a in actors:
            rt.kill(a)

    def test_cluster_metrics_all_nodes(self, cluster):
        """A user counter bumped inside actor workers shows up in the
        fanned-out scrape, summed over the workers."""
        actors = [rt.remote(_Scorer).remote() for _ in range(2)]
        got = rt.get([a.score.remote(i) for i, a in
                      enumerate(actors * 3)], timeout=TIMEOUT)
        assert len({pid for _, pid in got}) == 2
        text = state_api.cluster_metrics(all_nodes=True)
        assert 'component="controller"' in text
        assert 'component="driver"' in text
        assert 'component="supervisor"' in text
        assert 'component="worker:' in text
        total = sum(float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
                    if ln.startswith("test_scored_total{"))
        assert total == 6.0
        type_lines = [ln for ln in text.splitlines()
                      if ln.startswith("# TYPE ")]
        assert len(type_lines) == len(set(type_lines)), type_lines
        fam = None
        for ln in text.splitlines():
            if ln.startswith("# TYPE "):
                fam = ln.split(" ", 3)[2]
            elif ln and not ln.startswith("#"):
                name = ln.split("{", 1)[0].split(" ", 1)[0]
                assert fam and name.startswith(fam), (name, fam)
        assert "component=" not in state_api.cluster_metrics()
        for a in actors:
            rt.kill(a)

    def test_merged_flight_timeline_all_roles(self, cluster, tmp_path):
        from ray_tpu_torch.util import tracing

        def touch():
            with flight.span("test.worker_side"):
                return 1

        assert rt.get([rt.remote(touch).remote() for _ in range(4)],
                      timeout=TIMEOUT) == [1] * 4
        tracing.enable()
        try:
            with tracing.span("test.user_span"):
                pass
        finally:
            tracing.disable()
        path = tmp_path / "flight.json"
        events = state_api.flight_timeline(str(path))
        assert events
        assert len(json.load(open(path))) == len(events)
        roles = set()
        for e in events:
            pid = str(e.get("pid", ""))
            for role in ("driver", "controller", "supervisor", "worker"):
                if f"/{role}:" in pid or pid.startswith(f"{role}:"):
                    roles.add(role)
        assert {"driver", "controller", "supervisor", "worker"} <= roles, \
            roles
        names = {e.get("name") for e in events}
        assert "test.user_span" in names
        assert "test.worker_side" in names
        assert any(e["ph"] == "C" and str(e["name"]).startswith("ray_tpu_")
                   for e in events)


class TestLiveProfiling:
    def test_stack_profile_of_busy_actor(self, cluster):
        a = rt.remote(_Busy).options(name="busyprof").remote()
        rt.get(a.distinctive_method_name_for_stacks.remote(0.01),
               timeout=TIMEOUT)
        ref = a.distinctive_method_name_for_stacks.remote(8.0)
        found = False
        deadline = time.monotonic() + 7
        while not found and time.monotonic() < deadline:
            prof = state_api.profile_actor("busyprof", kind="stack")
            assert prof["pid"] > 0
            rendered = "\n".join(line for frames in prof["threads"].values()
                                 for line in frames)
            found = "distinctive_method_name_for_stacks" in rendered
        assert found, "live stack dump never showed the running method"
        rt.get(ref, timeout=TIMEOUT)
        rt.kill(a)

    def test_memory_profile(self, cluster):
        a = rt.remote(_Hog).options(name="memprof").remote()
        rt.get(a.ping.remote(), timeout=TIMEOUT)
        first = state_api.profile_actor("memprof", kind="memory")
        assert first["rss_bytes"] > 0
        assert first["gc_objects"] > 0
        rt.get(a.ping.remote(), timeout=TIMEOUT)
        second = state_api.profile_actor("memprof", kind="memory")
        assert not second["tracemalloc_warming_up"]
        rt.kill(a)

    def test_device_profile_without_a_card(self, cluster):
        """The ``device`` kind reads torch's caching allocator; a worker
        whose tensors live on the CPU reports CUDA uninitialized, and the
        profile does not initialize it."""
        a = rt.remote(_TensorHolder).options(name="devprof").remote()
        assert rt.get(a.ready.remote(), timeout=TIMEOUT)
        prof = state_api.profile_actor("devprof", kind="device")
        assert prof["pid"] > 0
        assert prof["cuda_initialized"] is False and prof["devices"] == {}
        rt.kill(a)

    def test_profile_of_a_dead_or_unknown_actor_refused(self, cluster):
        with pytest.raises(ValueError, match="no actor"):
            state_api.profile_actor("no-such-actor")

    def test_list_workers(self, cluster):
        a = rt.remote(_Holder).options(name="lw").remote()
        pid = rt.get(a.pid.remote(), timeout=TIMEOUT)
        workers = state_api.list_workers()
        assert any(w["is_actor"] and w["pid"] == pid for w in workers)
        assert all("pid" in w and "node_id_hex" in w for w in workers)
        rt.kill(a)
