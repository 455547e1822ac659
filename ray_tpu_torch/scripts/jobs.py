"""Job submission CLI (≈ `ray job submit/status/logs/stop/list`).

    python -m ray_tpu_torch.scripts.jobs submit --address HOST:PORT -- CMD...
    python -m ray_tpu_torch.scripts.jobs status  --address HOST:PORT JOB_ID
    python -m ray_tpu_torch.scripts.jobs logs    --address HOST:PORT JOB_ID
    python -m ray_tpu_torch.scripts.jobs stop    --address HOST:PORT JOB_ID
    python -m ray_tpu_torch.scripts.jobs list    --address HOST:PORT

--address defaults to $RAY_TPU_TORCH_ADDRESS (what ``init`` sets and
reads). Talks the controller RPC directly (the same operations are
served over HTTP at /api/jobs on the controller's dashboard port); it
needs the standard library and the port's RPC client, never torch.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import time


def _call(address: str, method: str, body=None):
    from ray_tpu_torch._private.rpc import RpcClient

    host, port = address.rsplit(":", 1)

    async def go():
        client = RpcClient((host, int(port)))
        try:
            return await client.call(method, body, timeout=30)
        finally:
            await client.close()

    return asyncio.run(go())


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="ray_tpu_torch jobs")
    parser.add_argument("command",
                        choices=["submit", "status", "logs", "stop", "list"])
    parser.add_argument("args", nargs="*")
    parser.add_argument("--address",
                        default=os.environ.get("RAY_TPU_TORCH_ADDRESS", ""))
    parser.add_argument("--submission-id", default=None)
    parser.add_argument("--follow", action="store_true",
                        help="submit: stream status until the job finishes")
    # the entrypoint is everything after the first "--", split off here,
    # and the rest parsed intermixed: argparse versions differ on a
    # positional or a "--" that follows options once the command is
    # matched ("unrecognized arguments")
    argv = list(sys.argv[1:] if argv is None else argv)
    entry = []
    if "--" in argv:
        cut = argv.index("--")
        argv, entry = argv[:cut], argv[cut + 1:]
    ns = parser.parse_intermixed_args(argv)
    ns.args = list(ns.args) + entry
    if not ns.address:
        print("no --address and RAY_TPU_TORCH_ADDRESS unset", file=sys.stderr)
        return 2

    if ns.command == "submit":
        if not ns.args:
            print("submit needs an entrypoint after --", file=sys.stderr)
            return 2
        entrypoint = " ".join(ns.args)
        out = _call(ns.address, "job_submit",
                    {"entrypoint": entrypoint,
                     "submission_id": ns.submission_id})
        job_id = out["job_id"]
        print(job_id)
        if ns.follow:
            while True:
                st = _call(ns.address, "job_status", {"job_id": job_id})
                if st is None:
                    print(f"job {job_id} vanished (controller restarted?)",
                          file=sys.stderr)
                    return 1
                if st["status"] != "RUNNING":
                    print(_call(ns.address, "job_logs", {"job_id": job_id}))
                    print(f"status: {st['status']}", file=sys.stderr)
                    return 0 if st["status"] == "SUCCEEDED" else 1
                time.sleep(1)
        return 0
    if ns.command == "list":
        print(json.dumps(_call(ns.address, "job_submissions"), indent=1,
                         default=str))
        return 0
    if not ns.args:
        print(f"{ns.command} needs a JOB_ID", file=sys.stderr)
        return 2
    job_id = ns.args[0]
    if ns.command == "status":
        st = _call(ns.address, "job_status", {"job_id": job_id})
        if st is None:
            print(f"no such job: {job_id}", file=sys.stderr)
            return 1
        print(json.dumps(st, indent=1, default=str))
    elif ns.command == "logs":
        print(_call(ns.address, "job_logs", {"job_id": job_id}))
    elif ns.command == "stop":
        print(_call(ns.address, "job_stop", {"job_id": job_id}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
