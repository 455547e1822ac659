"""Times a fresh worker's first call on a one-card cluster: three
``num_gpus=1`` actors whose method imports torch and touches CUDA, then
three ``num_cpus=0.5`` actors that report whether torch was imported in
their process. Prints one line, ``AB <tree> <json>``.

Run it as a file with the root of the checkout to time as its argument,
from that root, so the workers import the same tree; to compare two
commits on one card, alternate them in one call (parent, change, change,
parent):

    cd <tree> && python3 <this file> .
"""

import json
import os
import sys
import time

sys.path.insert(0, sys.argv[1] if len(sys.argv) > 1 else ".")

import ray_tpu_torch as rt  # noqa: E402


class Card:
    def go(self):
        t0 = time.perf_counter()
        import torch

        t1 = time.perf_counter()
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        return {"pid": os.getpid(), "import_s": t1 - t0,
                "cuda_s": time.perf_counter() - t1}


class Cpu:
    def go(self):
        return "torch" in sys.modules


def main() -> None:
    rt.init()
    out = {"card": [], "cpu": []}
    try:
        for _ in range(3):
            t0 = time.perf_counter()
            a = rt.remote(Card).options(num_gpus=1).remote()
            r = rt.get(a.go.remote(), timeout=300)
            r["total_s"] = time.perf_counter() - t0
            out["card"].append(r)
            rt.kill(a)
            time.sleep(1.0)
        for _ in range(3):
            t0 = time.perf_counter()
            a = rt.remote(Cpu).options(num_cpus=0.5).remote()
            loaded = rt.get(a.go.remote(), timeout=300)
            out["cpu"].append({"total_s": time.perf_counter() - t0,
                               "torch_loaded": loaded})
            rt.kill(a)
    finally:
        rt.shutdown()
    print("AB", sys.argv[1] if len(sys.argv) > 1 else ".", json.dumps(out))


if __name__ == "__main__":
    main()
