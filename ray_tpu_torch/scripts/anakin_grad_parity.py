"""Repeats ``chip_smoke.py``'s phase 19 (a) Anakin sequence on the card
(2 iterations, one update, 20 iterations, 3 updates under torch.profiler,
then one collected trajectory) and holds that trajectory's grads on the
card against the CPU's from the same float32 params. For each repeat it
prints how many of the Nature-CNN's ReLU inputs take another sign on the
card than on the CPU, and the largest leaf's relative L2 distance of the
grads as computed and with the card's ReLUs made the CPU's masks. The
card's training is not bitwise repeatable (cuDNN's weight grads sum in
no fixed order), so the repeats land on nearby params.

    python3 ray_tpu_torch/scripts/anakin_grad_parity.py [REPEATS]

from the root of the checkout, on a machine with a card. The last line is
``ANAKIN_GRAD_PARITY <json>``.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from ray_tpu_torch._private.device import resolve_device  # noqa: E402
from ray_tpu_torch.models.transformer import _leaves, map_params  # noqa: E402
from ray_tpu_torch.rllib import AnakinTrainer  # noqa: E402


def with_relu(fn, record=None, masks=None):
    """``fn()`` with ``torch.relu`` (the RLModule's conv activation)
    recording each call's mask ``x > 0`` into ``record``, or, given
    ``masks``, made ``x * masks[i]`` for its i-th call: the same
    piecewise-linear function as on the device the masks came from, with
    the same grads wherever the signs agree. ``chip_smoke.py``'s phase 19
    (a) holds the card's grads to the CPU's through it."""
    relu, calls = torch.relu, iter(masks or ())

    def patched(x):
        if record is not None:
            record.append(x.detach() > 0)
        if masks is None:
            return relu(x)
        return x * next(calls).to(x.device, x.dtype)

    torch.relu = patched
    try:
        return fn()
    finally:
        torch.relu = relu


def largest_leaf(a, b) -> float:
    return max(float((x.detach().double().cpu() - y.double()).norm()
                     / y.double().norm()) for x, y in zip(a, b))


def main() -> None:
    repeats = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    resolve_device()
    runs = []
    for i in range(repeats):
        tr = AnakinTrainer(num_envs=32, rollout=16, seed=0)
        tr.train(2)
        tr.update()
        tr.train(20)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            for _ in range(3):
                tr.update()
            torch.cuda.synchronize()
        traj = tr.collect()
        cpu = {k: v.cpu() for k, v in traj.items()}
        ref = AnakinTrainer(num_envs=32, rollout=16, seed=0, device="cpu")
        ref.params = map_params(
            lambda _p, x: x.detach().cpu().clone().requires_grad_(True),
            tr.params)
        cmasks, gmasks = [], []
        closs, _ = with_relu(lambda: ref.loss(ref.params, cpu), cmasks)
        cg = torch.autograd.grad(closs, _leaves(ref.params))
        loss, _ = with_relu(lambda: tr.loss(tr.params, traj), gmasks)
        g = torch.autograd.grad(loss, _leaves(tr.params))
        mloss, _ = with_relu(lambda: tr.loss(tr.params, traj), masks=cmasks)
        mg = torch.autograd.grad(mloss, _leaves(tr.params))
        r = {"flips": [int((a.cpu() != b).sum())
                       for a, b in zip(gmasks, cmasks)],
             "units": sum(m.numel() for m in cmasks),
             "as_computed": largest_leaf(g, cg),
             "cpu_masks": largest_leaf(mg, cg)}
        runs.append(r)
        print(i, json.dumps(r), flush=True)
    print("ANAKIN_GRAD_PARITY " + json.dumps(runs))


if __name__ == "__main__":
    main()
