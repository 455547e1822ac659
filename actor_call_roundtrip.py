"""Round trip of a no-op actor call through the port's runtime.

Starts a one-node ``ray_tpu_torch`` cluster with no GPU, makes one actor
with a ``ping`` method that does nothing, and times on the host clock:
``--calls`` sequential calls (each ``rt.get`` before the next submit), then
``--burst`` calls submitted together and fetched with one ``rt.get``.
Prints one JSON line: median and p90 of the sequential round trips in ms,
and the burst's calls per second.

``--repo`` names the checkout whose ``ray_tpu_torch`` is imported, so two
trees can be compared on one host, one after the other:

    python3 actor_call_roundtrip.py --repo /path/to/parent
    python3 actor_call_roundtrip.py --repo .
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


class Noop:
    def ping(self):
        return None


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--repo", default=os.path.dirname(os.path.abspath(
        __file__)), help="checkout to import ray_tpu_torch from")
    p.add_argument("--calls", type=int, default=1000)
    p.add_argument("--burst", type=int, default=2000)
    p.add_argument("--label", default="")
    args = p.parse_args()
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    os.environ.setdefault("RAY_TPU_TORCH_LOG_LEVEL", "WARNING")
    import ray_tpu_torch as rt

    rt.init(num_cpus=2, num_gpus=0, object_store_memory=256 * 2 ** 20)
    try:
        a = rt.remote(Noop).remote()
        rt.get([a.ping.remote() for _ in range(100)], timeout=120)  # warm
        trips = []
        for _ in range(args.calls):
            t0 = time.perf_counter()
            rt.get(a.ping.remote(), timeout=120)
            trips.append(time.perf_counter() - t0)
        trips.sort()
        t0 = time.perf_counter()
        rt.get([a.ping.remote() for _ in range(args.burst)], timeout=300)
        burst_s = time.perf_counter() - t0
    finally:
        rt.shutdown()
    print(json.dumps({
        "label": args.label or repo, "calls": args.calls,
        "median_ms": trips[len(trips) // 2] * 1e3,
        "p90_ms": trips[int(len(trips) * 0.9)] * 1e3,
        "burst": args.burst, "burst_calls_per_s": args.burst / burst_s,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
