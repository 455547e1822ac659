"""State API: list/summarize cluster entities from the driver.

Analog of `python/ray/util/state/api.py` (`ray list tasks`,
`list_actors`, `summary`): thin client functions over the controller's
record tables and task-event sink. Each returns plain dicts so output is
directly printable/serializable.
"""

from __future__ import annotations

from collections import Counter as _Counter
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private import api


def _call(method: str, body: Optional[dict] = None):
    core = api._require_core()
    return core._run(
        core.clients.get(core.controller_addr).call(method, body))


def list_nodes() -> List[Dict[str, Any]]:
    return _call("node_views")


def list_actors(state: Optional[str] = None) -> List[Dict[str, Any]]:
    records = _call("actor_list")
    out = []
    for rec in records:
        rec = dict(rec)
        rec.pop("creation_spec", None)  # serialized bytes, not listable
        if state is None or rec.get("state") == state:
            out.append(rec)
    return out


def list_placement_groups() -> List[Dict[str, Any]]:
    return _call("pg_list")


def list_cluster_events(*, limit: int = 1000,
                        event_type: Optional[str] = None,
                        source_type: Optional[str] = None,
                        severity: Optional[str] = None
                        ) -> List[Dict[str, Any]]:
    """Structured lifecycle events from every daemon, time-ordered
    (≈ `ray list cluster-events`; emitters: _private/events.py)."""
    return _call("events_list", {
        "limit": limit, "event_type": event_type,
        "source_type": source_type, "severity": severity})


def list_jobs() -> List[Dict[str, Any]]:
    return _call("job_list")


def _flush_own_events() -> None:
    """An owner sends its task events to the controller's sink in batches
    of 100; send what this process holds back first, so a listing sees
    every task it submitted."""
    core = api._require_core()
    buffered = getattr(core, "_task_events", None)
    if not buffered:
        return

    async def flush():
        # on the core's loop, where the events are recorded
        events = list(buffered)
        buffered.clear()
        if events:
            await core.clients.get(core.controller_addr).call(
                "task_events", {"events": events})

    core._run(flush())


def list_tasks(limit: int = 1000,
               name: Optional[str] = None) -> List[Dict[str, Any]]:
    """Task lifecycle events folded to latest-state-per-task
    (≈ `ray list tasks` over the GCS task events)."""
    _flush_own_events()
    events = _call("state_tasks", {"limit": limit * 8})
    latest: Dict[str, Dict[str, Any]] = {}
    for ev in events:
        latest[ev["task_id"]] = ev
    out = [
        ev for ev in latest.values()
        if name is None or ev.get("name") == name
    ]
    return out[-limit:]


def summarize_tasks() -> Dict[str, Dict[str, int]]:
    """{task name: {state: count}} (≈ `ray summary tasks`)."""
    summary: Dict[str, _Counter] = {}
    for ev in list_tasks(limit=100_000):
        summary.setdefault(ev["name"], _Counter())[ev["state"]] += 1
    return {k: dict(v) for k, v in summary.items()}


def cluster_metrics(all_nodes: bool = False) -> str:
    """Prometheus exposition text. Default: the controller's own
    registry (the pre-existing behaviour). ``all_nodes=True`` fans the
    scrape out to every supervisor AND every worker registry (plus this
    driver's own) and merges the expositions with ``node``/``component``
    labels — the data-plane metrics recorded inside worker processes
    (channels, collectives, pipeline, serve, podracer) are otherwise
    invisible cluster-wide."""
    text = _call("metrics")
    if not all_nodes:
        return text
    from ray_tpu_torch._private.metrics import (default_registry,
                                                merge_expositions,
                                                relabel_exposition)

    core = api._require_core()
    parts = [relabel_exposition(
        text, {"node": "head", "component": "controller"})]
    parts.append(relabel_exposition(
        default_registry().render_prometheus(),
        {"node": "head", "component": "driver"}))
    nodes = []
    for node in _call("node_views"):
        if not node.get("alive", True):
            continue  # a dead node's client burns the connect deadline
        name = (node.get("labels") or {}).get("node_name") \
            or node["node_id_hex"][:8]
        nodes.append((name, core.clients.get(tuple(node["address"]))))

    async def _gather_scrapes():
        # concurrent: one wedged supervisor costs its own 30s timeout,
        # not 30s times its position in the node list
        import asyncio

        return await asyncio.gather(
            *(client.call("metrics_all", {}, timeout=30)
              for _, client in nodes),
            return_exceptions=True)

    for (name, _), sections in zip(nodes, core._run(_gather_scrapes())):
        if isinstance(sections, BaseException):
            continue  # a dying node must not fail the cluster scrape
        for component, body in sections:
            parts.append(relabel_exposition(
                body, {"node": name, "component": component}))
    # regroup into one HELP/TYPE block per family: concatenation would
    # emit duplicate TYPE lines, which Prometheus ingestion rejects
    return merge_expositions(parts)


def timeline(path: Optional[str] = None) -> List[Dict[str, Any]]:
    """Chrome-trace events from the task-event sink (≈ ray.timeline /
    `ray timeline`): load the result into chrome://tracing or Perfetto.

    Each task contributes one duration event per lifecycle span
    (SUBMITTED→PUSHED as 'schedule', PUSHED→FINISHED/FAILED as 'run')
    on a row per worker node. An actor call records FINISHED alone: its
    'run' span goes from the start its worker reported (``run_start``,
    state_from RUNNING) to FINISHED. A span whose end event names the
    worker process that ran it (``worker_pid``) carries that pid in its
    args. Returns the event list; writes JSON to `path` when given.
    """
    _flush_own_events()
    events = _call("state_tasks", {"limit": 100_000})
    by_task: Dict[str, List[Dict[str, Any]]] = {}
    for ev in events:
        by_task.setdefault(ev["task_id"], []).append(ev)

    trace: List[Dict[str, Any]] = []
    for task_id, evs in by_task.items():
        evs.sort(key=lambda e: e["ts"])
        stamps = {e["state"]: e for e in evs}
        name = evs[0].get("name", task_id[:8])
        node = evs[0].get("node", "") or "driver"
        spans = [("schedule", "SUBMITTED", ("PUSHED", "RECONSTRUCTING")),
                 ("run", "PUSHED", ("FINISHED", "FAILED"))]
        for label, start_state, end_states in spans:
            start = stamps.get(start_state)
            end = next((stamps[s] for s in end_states if s in stamps), None)
            if (start is None and label == "run" and end is not None
                    and end.get("run_start") is not None):
                start_state, start = "RUNNING", {"ts": end["run_start"]}
            if start is None or end is None:
                continue
            args = {"task_id": task_id, "state_from": start_state}
            if end.get("worker_pid") is not None:
                args["worker_pid"] = end["worker_pid"]
            trace.append({
                "name": f"{name}:{label}",
                "cat": "task",
                "ph": "X",  # complete event
                "ts": start["ts"] * 1e6,   # chrome-trace wants microseconds
                "dur": max(1.0, (end["ts"] - start["ts"]) * 1e6),
                "pid": node[:12],
                "tid": task_id[:8],
                "args": args,
            })
    if path:
        import json

        with open(path, "w") as f:
            json.dump(trace, f)
    return trace


def flight_timeline(path: Optional[str] = None) -> List[Dict[str, Any]]:
    """One merged Chrome-trace/Perfetto timeline of every flight
    recorder in the cluster (`_private/flight.py`): the zero-RPC hot-loop
    spans (channel waits, 1F1B fwd/bwd/flush, serve admit/prefill/decode
    iterations, collective rounds, Sebulba phases) that ``timeline()``'s
    task-event feed cannot see, plus metrics-registry counters sampled at
    drain time and per-flush bubble counter tracks.

    The drain is out-of-band: one ``flight_dump`` RPC per daemon (each
    supervisor relays to its workers), issued only when THIS function
    runs — recording itself never leaves the process. Cross-host clocks
    align via each process's monotonic->wall anchor plus a per-node
    wall-offset handshake with the supervisor, corrected by RTT/2.

    Returns the event list; writes Perfetto-loadable JSON to ``path``
    when given.
    """
    import time as _time

    from ray_tpu_torch._private import flight

    core = api._require_core()
    entries = [(flight.drain(), "head", 0)]
    try:
        controller_dump = _call("flight_dump")
    except Exception:
        controller_dump = None  # controller mid-restart: merge what we can
    nodes = []
    for node in _call("node_views"):
        if not node.get("alive", True):
            # a dead node's client would burn the full connect-retry
            # deadline — worst exactly on the chaos dump-on-failure path
            continue
        addr = tuple(node["address"])
        name = (node.get("labels") or {}).get("node_name") \
            or node["node_id_hex"][:8]
        client = core.clients.get(addr)
        try:
            # RTT/2-corrected wall-clock offset of this node vs the
            # driver's host: the supervisor's clock read is assumed to
            # happen mid-flight, so offset = remote_wall - (t0+t1)/2.
            # Handshakes stay sequential — each needs its own clean RTT
            # measurement, and they are cheap
            t0 = _time.time_ns()
            clock = core._run(client.call("flight_clock", {}, timeout=15))
            t1 = _time.time_ns()
        except Exception:
            continue  # a dying node must not fail the merge
        nodes.append((name, client, int(clock["wall_ns"] - (t0 + t1) // 2),
                      addr))

    if controller_dump is not None:
        # the controller shares the head node's host clock: reuse that
        # supervisor's measured offset (a remotely-attached driver's
        # wall clock can differ from the head's; 0 would skew exactly
        # the controller's rows)
        head_host = core.controller_addr[0]
        head_offset = next((off for _, _, off, a in nodes
                            if a[0] == head_host), 0)
        entries.append((controller_dump, "head", head_offset))

    async def _gather_dumps():
        # the heavy part runs concurrently: total drain time is bounded
        # by the slowest node, not the sum over nodes
        import asyncio

        return await asyncio.gather(
            *(client.call("flight_dump", {"include_workers": True},
                          timeout=60) for _, client, _, _ in nodes),
            return_exceptions=True)

    for (name, _, offset_ns, _), reply in zip(nodes,
                                           core._run(_gather_dumps())):
        if isinstance(reply, BaseException):
            continue  # a dying node must not fail the merge
        for dump in reply.get("dumps", []):
            entries.append((dump, name, offset_ns))
    return flight.merge_dumps(entries, path=path)


# ------------------------------------------------- live worker profiling


def _supervisor_call(node_id_hex: str, method: str, body: dict):
    core = api._require_core()
    node = next((n for n in _call("node_views")
                 if n["node_id_hex"] == node_id_hex), None)
    if node is None:
        raise ValueError(f"node {node_id_hex} not in cluster view")
    return core._run(
        core.clients.get(tuple(node["address"])).call(method, body))


def list_workers(node_id_hex: Optional[str] = None) -> List[Dict[str, Any]]:
    """Live worker processes per node (pid, actor binding)."""
    out = []
    for node in _call("node_views"):
        if node_id_hex and node["node_id_hex"] != node_id_hex:
            continue
        r = _supervisor_call(node["node_id_hex"], "worker_profile", {})
        for w in r["workers"]:
            out.append(dict(w, node_id_hex=node["node_id_hex"]))
    return out


def profile_worker(node_id_hex: str, worker_id_hex: str,
                   kind: str = "stack", limit: int = 20) -> Dict[str, Any]:
    """On-demand live profile of a RUNNING worker — no restart, no
    external profiler (≈ the dashboard's py-spy/memray attach,
    `dashboard/modules/reporter/reporter_agent.py:391`; collectors in
    `_private/profiling.py`). Kinds: "stack" (all thread stacks),
    "memory" (RSS + tracemalloc top sites), "device" (per-card bytes
    held by torch's caching allocator — the GPU question generic
    profilers can't answer)."""
    return _supervisor_call(node_id_hex, "worker_profile",
                            {"worker_id_hex": worker_id_hex,
                             "kind": kind, "limit": limit})


def profile_actor(name_or_id: str, kind: str = "stack",
                  limit: int = 20) -> Dict[str, Any]:
    """Profile the worker currently hosting an actor (by name or id)."""
    for rec in _call("actor_list"):
        if rec["actor_id_hex"] == name_or_id or rec["name"] == name_or_id:
            if rec["state"] != "ALIVE":
                raise ValueError(
                    f"actor {name_or_id} is {rec['state']}, not ALIVE")
            return profile_worker(rec["node_id_hex"],
                                  rec["worker_id_hex"], kind, limit)
    raise ValueError(f"no actor {name_or_id!r}")
