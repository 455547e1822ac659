"""Times K4 (``ray_tpu_torch.ops.paged_attention``) over float32 page pools
on the card, in one or more checkouts of this repository, in turns.

    python3 k4_compare.py [ROOT ...]

Each ROOT (default: this checkout) is measured in a process of its own,
which imports that checkout's ``ray_tpu_torch`` (and builds its kernels)
and this checkout's ``chip_smoke.py``, whose cases, checks and timer it
uses: ``make_case``, ``_k4_check`` (the kernel against its plain version),
``_plan_line`` and ``_k4_times`` (kernel, plain and SDPA times; the bound
at the peak of the route the checkout's plan names). With two roots the
turns are A, B, B, A, so the card's drift falls on both alike. Cases:
the float32 pair at llama_debug's decode in the harness serve probe
(``K4_D16["decode_d16"]``) and both float32-pool pairs at llama3_8b's
decode (``DECODE_LENGTHS``). Prints one JSON line per turn and writes them
all to ``chiprun_out/k4_compare.json``; needs one card.
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

    cases = {
        "decode_d16_float32": ("float32", "float32", c.K4_D16["decode_d16"]),
        "decode_float32": ("float32", "float32",
                           dict(S=8, K=1, lengths=c.DECODE_LENGTHS)),
        "decode_bfloat16_q_float32_pool": (
            "bfloat16", "float32", dict(S=8, K=1, lengths=c.DECODE_LENGTHS)),
    }
    out = {"root": root, "card": c.card_line()}
    for name, (q_name, pool_name, shape) in cases.items():
        case = c.make_case(torch, getattr(torch, q_name), **shape,
                           pool_dtype=getattr(torch, pool_name))
        ref, max_err = c._k4_check(torch, case, name, q_name)
        out[name] = c._k4_times(torch, case, ref, max_err, q_name, pool_name,
                                c._plan_line(case))
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
            [sys.executable, str(HERE / "k4_compare.py"), "--child", root],
            capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        results.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(results[-1]), flush=True)
    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "k4_compare.json").write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
