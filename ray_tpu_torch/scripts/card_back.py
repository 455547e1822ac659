"""Splits the time from ``serve.shutdown()`` until a new card actor is up
into its steps, on the host clock, each from the start: the serve
controller's ``graceful_shutdown`` returns (it deletes every application,
so each replica drains and is killed), every replica's process is gone,
``serve.shutdown()`` returns (it kills the proxy, the RPC ingress and the
controller), the cluster shows ``GPU: 1`` free, and a ``num_gpus=1``
actor is up.

``card_back(rt, core, serve, probe_cls)`` measures it inside a running
cluster with live applications (``chip_smoke.py``'s serve-app phase calls
it). Run alone, the script starts a cluster, deploys llama_debug in one
``num_gpus=1`` replica, sends it a few requests through the handle, HTTP
and the RPC ingress, and measures:

    python3 ray_tpu_torch/scripts/card_back.py [--device cpu]

on a machine with a card (or on the CPU, where the card is a ``GPU``
resource that ``rt.init(num_gpus=1)`` counts and nothing touches CUDA).
The runtime it drives is the one that ``import ray_tpu_torch`` finds, so
with ``PYTHONPATH`` set to another checkout (run from that checkout's
root, where its daemons start) it measures that checkout's. Prints a last
line ``CARD_BACK <json>``.
"""

import argparse
import http.client
import json
import os
import sys
import time
from pathlib import Path

TIMEOUT_S = 120.0
PROMPTS = ["hi", "hello 123", "a much longer prompt than the others!"]


class _Probe:
    def visible(self):
        return os.environ.get("CUDA_VISIBLE_DEVICES")


def _exited(pid: int) -> bool:
    """The process has exited (a zombie not yet reaped counts)."""
    try:
        stat = Path(f"/proc/{pid}/stat").read_text()
    except FileNotFoundError:
        return True
    return stat.rsplit(")", 1)[1].split()[0] == "Z"


def _wait(what: str, cond, timeout: float = TIMEOUT_S) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{what} not within {timeout:.0f} s")
        time.sleep(0.01)


def replica_pids(rt, core) -> list:
    """The process ids of every serve replica, from the serve controller's
    replica lists and the local supervisor's worker table."""
    from ray_tpu_torch.serve._private.controller import CONTROLLER_NAME

    ctrl = rt.get_actor(CONTROLLER_NAME)
    ids = set()
    for app, deps in rt.get(ctrl.status.remote(), timeout=TIMEOUT_S).items():
        for dep in deps:
            reps = rt.get(ctrl.get_replicas.remote(app, dep),
                          timeout=TIMEOUT_S)["replicas"]
            ids.update(h._actor_id.hex() for h in reps)
    workers = core._run(core.clients.get(core.supervisor_addr).call(
        "worker_profile", {}), timeout=TIMEOUT_S)["workers"]
    return sorted(w["pid"] for w in workers if w["actor_id_hex"] in ids)


def card_back(rt, core, serve, probe_cls=_Probe) -> dict:
    """The split, in seconds from the start of the shutdown, and the
    probe's ``visible()`` (its ``CUDA_VISIBLE_DEVICES``)."""
    from ray_tpu_torch.serve._private.controller import CONTROLLER_NAME

    pids = replica_pids(rt, core)
    if not pids:
        raise RuntimeError("no serve replica to shut down")
    t0 = time.perf_counter()
    r = {"replica_pids": pids}

    def mark(name):
        r[name] = time.perf_counter() - t0

    rt.get(rt.get_actor(CONTROLLER_NAME).graceful_shutdown.remote(),
           timeout=TIMEOUT_S)
    mark("graceful_shutdown_s")
    _wait("the replicas' exit", lambda: all(_exited(p) for p in pids))
    mark("replicas_gone_s")
    serve.shutdown()
    mark("serve_shutdown_s")
    _wait("GPU 1 free",
          lambda: rt.available_resources().get("GPU", 0) >= 1)
    mark("gpu_free_s")
    probe = rt.remote(probe_cls).options(num_gpus=1).remote()
    r["visible"] = rt.get(probe.visible.remote(), timeout=TIMEOUT_S)
    mark("probe_up_s")
    rt.kill(probe)
    return r


def _http_text(port: int, path: str, body=None) -> str:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT_S)
    try:
        if body is None:
            conn.request("GET", path)
        else:
            conn.request("POST", path, body=json.dumps(body),
                         headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.read().decode()
    finally:
        conn.close()


def run(device=None) -> dict:
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch._private import api as rt_api
    from ray_tpu_torch.serve.llm import LLMServer
    from ray_tpu_torch.serve.rpc_ingress_client import ServeRpcClient

    t0 = time.perf_counter()
    rt.init(num_gpus=1) if device == "cpu" else rt.init()
    try:
        app = LLMServer.options(
            num_replicas=1, ray_actor_options={"num_gpus": 1}).bind(
            preset="llama_debug", max_new_tokens=8, slots=4,
            prefill_chunk=8, page_tokens=4,
            **({"device": device} if device else {}))
        h = serve.run(app, name="llama_debug", route_prefix="/llama_debug",
                      timeout_s=600)
        texts = [h.remote({"prompt": p}).result(timeout=600)["text"]
                 for p in PROMPTS]
        port = serve.start(http_port=0)
        _wait("the proxy's route", lambda: "/llama_debug" in json.loads(
            _http_text(port, "/-/routes")))
        over_http = [json.loads(_http_text(
            port, "/llama_debug", {"prompt": p}))["text"] for p in PROMPTS]
        client = ServeRpcClient(f"127.0.0.1:{serve.start_rpc_ingress()}",
                                request_timeout_s=600)
        try:
            over_rpc = [client.invoke("llama_debug", {"prompt": p})["text"]
                        for p in PROMPTS]
        finally:
            client.close()
        if not texts == over_http == over_rpc:
            raise AssertionError(f"texts differ: {texts} {over_http} "
                                 f"{over_rpc}")
        setup_s = time.perf_counter() - t0
        r = card_back(rt, rt_api._core, serve)
    finally:
        rt.shutdown()
    return {"runtime": os.path.dirname(os.path.dirname(rt.__file__)),
            "setup_s": setup_s, **r}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu: the replica on the CPU, the card faked")
    args = ap.parse_args(argv)
    # run by path: this checkout's runtime, unless PYTHONPATH names another
    sys.path.append(str(Path(__file__).resolve().parents[2]))
    print("CARD_BACK " + json.dumps(run(args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
