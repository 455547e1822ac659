"""Bytes per rank of the mesh train step at fsdp N against the meshless
step, on the CPU.

Spawns a gloo world of N CPU processes (``--world``, 4 by default), one
thread each, which meet through a ``FileStore`` in a temporary directory.
Each rank builds ``init_train_state(..., mesh=)`` on ``MeshSpec.of(fsdp=N)``
and runs ``make_train_step(..., mesh=)``; then this process runs the
meshless step of the same model on the same batch. For each it prints:

  * ``state``: the bytes of the train state the process holds (params and
    both Adam moments; on a rank, its local shards);
  * ``init_peak`` and ``step_peak``: the most bytes that
    ``init_train_state``, and one train step (the second), allocated and
    held at once beyond what was allocated when the call began (for the
    step, beyond the state and the batch), from the allocation and free
    events torch.profiler records (``profile_memory``).

The model is ``CFG``: llama_debug's shape widened so that the params
outweigh the activations, remat on (the default, ``"full"``). The numbers
are the CPU's allocations, not a card's. Usage, from the root of a
checkout (under a minute):

    python -m ray_tpu_torch.scripts.mesh_memory [--world 4]

The last line is ``MESH_MEMORY <json>``.
"""

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import torch  # noqa: E402

CFG = dict(vocab_size=4096, num_layers=8, embed_dim=256, num_heads=8,
           num_kv_heads=4, mlp_dim=768)
BATCH, SEQ = 8, 64


def _cfg():
    from ray_tpu_torch.models import presets

    return presets.llama_debug(**CFG)


def _peak(fn):
    """(fn's result, the most bytes that the call's own allocations held
    at once above what was allocated when it began): the running sum of
    the allocation and free events torch.profiler records
    (``profile_memory``)."""
    from torch._C._profiler import _EventType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        out = fn()
    events = []
    stack = list(prof.profiler.kineto_results.experimental_event_tree())
    while stack:
        e = stack.pop()
        if e.tag == _EventType.Allocation:
            events.append((e.start_time_ns, e.extra_fields.alloc_size))
        stack.extend(e.children)
    held = peak = 0
    for _, size in sorted(events):
        held += size
        peak = max(peak, held)
    return out, peak


def _state_bytes(state) -> int:
    from ray_tpu_torch.models.transformer import _leaves

    def local(t):
        return t.to_local() if hasattr(t, "to_local") else t

    trees = [state.params, state.opt_state.mu, state.opt_state.nu]
    return sum(local(t).numel() * local(t).element_size()
               for tree in trees for t in _leaves(tree))


def _measure(mesh) -> dict:
    from ray_tpu_torch.models import training

    cfg = _cfg()
    ocfg = training.OptimizerConfig(learning_rate=1e-3, warmup_steps=1,
                                    decay_steps=100)
    (state, tx), init_peak = _peak(lambda: training.init_train_state(
        cfg, ocfg, seed=0, device="cpu", mesh=mesh))
    step = training.make_train_step(cfg, tx, mesh=mesh)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, SEQ),
                           generator=torch.Generator().manual_seed(1))
    state, first = step(state, {"tokens": tokens})
    (state, second), step_peak = _peak(lambda: step(state,
                                                    {"tokens": tokens}))
    return {"state": _state_bytes(state), "init_peak": init_peak,
            "step_peak": step_peak,
            "losses": [float(first["loss"]), float(second["loss"])]}


def _rank(rank, world, root):
    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(root, "store"), world), rank=rank, world_size=world)
    try:
        mesh = build_mesh(MeshSpec.of(fsdp=world), device_type="cpu")
        out = _measure(mesh)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def main() -> None:
    import torch.multiprocessing as mp

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--world", type=int, default=4)
    args = parser.parse_args()
    with tempfile.TemporaryDirectory() as root:
        mp.start_processes(_rank, args=(args.world, root), nprocs=args.world,
                           start_method="spawn")
        ranks = []
        for r in range(args.world):
            with open(os.path.join(root, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    torch.set_num_threads(1)
    meshless = _measure(None)
    for name, m in [("meshless", meshless)] + [
            (f"fsdp{args.world} rank {r}", m) for r, m in enumerate(ranks)]:
        print(f"{name}: state {m['state']} B, init peak {m['init_peak']} B, "
              f"step peak {m['step_peak']} B, losses {m['losses']}")
    print("MESH_MEMORY " + json.dumps({
        "cfg": CFG, "batch": BATCH, "seq": SEQ, "world": args.world,
        "meshless": meshless, "ranks": ranks}))


if __name__ == "__main__":
    main()
