"""The runtime: a copy of the JAX package's ``ray_tpu/_private`` (and of
``ray_tpu/_native``, ``ray_tpu/util/tracing.py``, the collectives' ring
transport and ``ray_tpu/cluster_utils.py``), taken at commit
``0169014`` (the JAX package is unchanged from there on).

Drift from the reference shows mechanically: rename the reference's names
and diff, e.g.

    sed -e 's/ray_tpu\\./ray_tpu_torch./g; s/RAY_TPU_/RAY_TPU_TORCH_/g' \\
        -e 's/ray_tpu /ray_tpu_torch /g' ray_tpu/_private/rpc.py \\
      | diff - ray_tpu_torch/_private/rpc.py

Intended deltas, and nothing else:

- names: imports ``ray_tpu_torch``; every environment variable read or
  set is ``RAY_TPU_TORCH_*``; sessions under ``<tmp>/ray_tpu_torch``, the
  arena ``/dev/shm/rtpu_torch_arena_*``, the native build cache
  ``~/.cache/ray_tpu_torch_native``, so a cluster of the port never joins
  one of the JAX package;
- a ``GPU`` resource in TPU's place (``resources``, ``scheduling``,
  ``node``, ``usage``, ``cluster_utils``, ``num_gpus=`` in ``api``), whole
  cards only, counted without importing torch; no TPU-pod resources;
- GPU pinning in ``supervisor``: a worker is spawned with
  ``CUDA_VISIBLE_DEVICES`` set to its cards (``""`` without), the card
  ids are in the worker pool's key, and a card still held by an exiting
  actor is waited for; ``workers/default_worker._maybe_setup_gpu`` checks
  them;
- ``serialization``: torch tensors as their raw bytes, dtype and shape;
  ``write_packed`` copies 64 MiB or more of buffers into the arena in
  16 MiB pieces on a few threads (page faults on fresh shared-memory pages
  bound a one-thread copy);
- ``device_objects``: CUDA tensors, and DTensors on a mesh (put by every
  rank, each shard held by its own rank), stored and handed out as copies
  taken where they live, as torch tensors are mutable;
- ``profiling.collect_device`` reads ``torch.cuda.memory_stats``;
  ``object_store`` reports which free list it uses (``native_allocator``);
- ``config``: of the serve knobs only ``serve_affinity``,
  ``serve_affinity_skew`` and ``serve_migration_budget`` (the router and
  the scheduler read them); the data, pipeline, podracer and elastic
  knobs that nothing here reads are left out;
- the ``placement_group`` option takes only a
  ``util.placement_group.PlacementGroup`` (anything else raises
  ``TypeError``);
- two repairs of the copy: ``core_worker`` pins an actor-creation task's
  ref arguments until ``__init__`` ran, and ``default_worker`` holds its
  liveness-bond task so the collector cannot destroy it.

The compiled-graph half of ``channels`` carries ``ray_tpu_torch.dag``'s
compiled graphs; its channels also carry the host collectives'
shared-memory rounds (``util/collective/shm.py``). ``api`` proxies
through ``ray_tpu_torch.util.client`` when ``init`` was given a
``client://`` address.
"""
