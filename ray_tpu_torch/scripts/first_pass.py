"""Splits a fresh process's first gpt2_small train step into its parts:
the torch import, the CUDA context, the first bf16 product, the flash
kernels' first call, the param init, the first forward (no grad), the first
step and the second. The fused cross entropy recomputes each token chunk in
its backward (pass ``own``); a ``checkpoint`` pass runs that recompute
through ``torch.utils.checkpoint`` instead (which imports ``torch._dynamo``
on its first call), so both costs show in one run. A pass marked ``+pyc`` runs
with Python's bytecode cache written and read under ``build/pycache`` of
the checkout (``PYTHONPYCACHEPREFIX``, ``PYTHONDONTWRITEBYTECODE`` unset):
the first such pass fills it. Each pass is its own process.

    python3 ray_tpu_torch/scripts/first_pass.py [--order own,checkpoint+pyc,...]

from the root of the checkout, on a machine with a card (B8 x S1024, 12
layers, bf16), or with ``--device cpu`` (a 2-layer model, B1 x S64). Prints
one line per process and a last line ``FIRST_PASS <json>``.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

CHILD = r'''
import json, sys, time
sys.path.insert(0, {root!r})
device, mode = {device!r}, {mode!r}
laps, t0 = {{}}, time.perf_counter()


def lap(what):
    global t0
    if device == "cuda":
        torch.cuda.synchronize()
    laps[what] = time.perf_counter() - t0
    t0 = time.perf_counter()


import torch
lap("import_torch")
torch.zeros(1, device=device)
lap("context")
a = torch.randn(1024, 1024, device=device, dtype=torch.bfloat16)
(a @ a).sum().item()
lap("first_bf16_product")
from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.ops import losses
if mode == "checkpoint":
    from torch.utils.checkpoint import checkpoint
    losses._RecomputedChunkLoss.apply = staticmethod(
        lambda *a: checkpoint(losses._chunk_loss, *a, use_reentrant=False))
q = torch.randn(1, 64, 4, 64, device=device, dtype=torch.bfloat16)
fa.flash_forward(q, q, q)
lap("first_flash")
from ray_tpu_torch import presets
from ray_tpu_torch.models.training import (OptimizerConfig, init_train_state,
                                           make_train_step)
from ray_tpu_torch.models.transformer import loss_fn
small = device == "cpu"
cfg = presets.gpt2_small(remat=False, ce_chunk=8192,
                         num_layers=2 if small else 12)
state, tx = init_train_state(cfg, OptimizerConfig(warmup_steps=0),
                             seed=0, device=device)
g = torch.Generator(device=device).manual_seed(1)
shape = (1, 64) if small else (8, 1024)
batch = {{"tokens": torch.randint(0, cfg.vocab_size, shape, generator=g,
                                 device=device)}}
step = make_train_step(cfg, tx)
lap("init_state")
with torch.no_grad():
    float(loss_fn(cfg, state.params, batch)[0])
lap("first_forward")
state, m = step(state, batch)
float(m["loss"])
lap("first_step")
state, m = step(state, batch)
float(m["loss"])
lap("second_step")
print("LAPS " + json.dumps(dict(laps, mode=mode,
                                dynamo="torch._dynamo" in sys.modules)))
'''


PYCACHE = os.path.join(ROOT, "build", "pycache")


def one(device: str, mode: str) -> dict:
    env = dict(os.environ)
    mode, pyc = mode.split("+")[0], mode.endswith("+pyc")
    if pyc:
        env.pop("PYTHONDONTWRITEBYTECODE", None)
        env["PYTHONPYCACHEPREFIX"] = PYCACHE
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-c", CHILD.format(root=ROOT, device=device,
                                            mode=mode)],
        capture_output=True, text=True, timeout=600, env=env)
    wall = time.perf_counter() - t0
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("LAPS ")]
    if out.returncode != 0 or not lines:
        raise SystemExit(f"the {mode} pass failed:\n{out.stderr[-3000:]}")
    r = json.loads(lines[0][len("LAPS "):])
    r.update(process_wall=wall, pycache=pyc)
    return r


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--order", default="checkpoint,own,own+pyc,own+pyc,"
                    "checkpoint+pyc,own,checkpoint")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    if args.device == "cuda":
        from ray_tpu_torch.ops import _build

        _build.load("flash_attention")  # built once, before the passes
    runs = []
    for mode in args.order.split(","):
        r = one(args.device, mode)
        runs.append(r)
        print(" ".join(f"{k} {v:.3f}" if isinstance(v, float) else
                       f"{k} {v}" for k, v in r.items()), flush=True)
    print("FIRST_PASS " + json.dumps(runs))


if __name__ == "__main__":
    main()
