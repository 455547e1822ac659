"""Times the float32 K2 and K3 (``ray_tpu_torch.ops.flash_attention``) on
the card, in one or more checkouts of this repository, in turns.

    python3 flash_compare.py [ROOT ...]

Each ROOT (default: this checkout) is measured in a process of its own,
which imports that checkout's ``ray_tpu_torch`` (and builds its kernels)
and this checkout's ``chip_smoke.py``, whose cases, inputs and timer it
uses: ``FLASH_CASES`` and ``TRAIN_PARITY_FLASH``, ``flash_inputs``,
``flash_routes`` and ``time_ms``. With two roots the turns are A, B, B, A,
so the card's drift falls on both alike. Each case also records, as
shares of the float32 gate (``F32_GATE`` through ``_gate_err``), how far
the checkout's kernels and its plain dQ, dK and dV lie from the plain
ones with their float32 steps in float64 (``_dq_float64``,
``_dkv_float64``), and the kernels from the checkout's plain ones.
Prints one JSON line per turn (each case's K2 and K3 ms, the shares and
the routes the checkout takes) and writes them all to
``chiprun_out/flash_compare.json``; needs one card.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def child(root: str) -> dict:
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    c = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(c)
    import torch

    from ray_tpu_torch._private.device import resolve_device
    from ray_tpu_torch.ops import flash_attention as fa

    resolve_device()  # TF32 off
    out = {"root": root, "card": c.card_line()}
    for name, case in dict(c.FLASH_CASES,
                           train_parity=c.TRAIN_PARITY_FLASH).items():
        causal = case["causal"]
        q, k, v, do = c.flash_inputs(torch, case, torch.float32)
        o, lse = fa.flash_forward(q, k, v, causal=causal)
        delta = fa.delta_rows(do, o)
        args = (q, k, v, do, lse, delta)
        r = out[name] = {
            "routes": c.flash_routes(torch.float32, case["D"]),
            "dq_ms": c.time_ms(torch, lambda: fa.flash_dq(*args,
                                                           causal=causal)),
            "dkv_ms": c.time_ms(torch, lambda: fa.flash_dkv(*args,
                                                             causal=causal))}
        kernel = (fa.flash_dq(*args, causal=causal),
                  *fa.flash_dkv(*args, causal=causal))
        plain = (fa.flash_dq_reference(*args, causal=causal),
                 *fa.flash_dkv_reference(*args, causal=causal))
        f64 = (c._dq_float64(torch, fa, *args, causal),
               *c._dkv_float64(torch, fa, *args, causal))
        for key, got, ref, alt in zip(("dq", "dk", "dv"), kernel, plain, f64):
            gate = c._gate(key, "float32")
            r[f"{key}_kernel_vs_plain"] = c._gate_err(got, ref, key, gate)[2]
            r[f"{key}_kernel_vs_float64"] = c._gate_err(got, alt, key,
                                                        gate)[2]
            r[f"{key}_plain_vs_float64"] = c._gate_err(alt, ref, key, gate)[2]
        del q, k, v, do, o, lse, delta, args, kernel, plain, f64
        torch.cuda.empty_cache()
    return out


def main(argv) -> int:
    if argv[:1] == ["--child"]:
        print(json.dumps(child(argv[1])), flush=True)
        return 0
    roots = [str(Path(r).resolve()) for r in argv] or [str(HERE)]
    turns = roots if len(roots) == 1 else roots + roots[::-1]
    results = []
    for root in turns:
        proc = subprocess.run(
            [sys.executable, str(HERE / "flash_compare.py"), "--child", root],
            capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        results.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(results[-1]), flush=True)
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "flash_compare.json").write_text(json.dumps(results,
                                                           indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
