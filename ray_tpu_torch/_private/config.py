"""Framework configuration flags.

Analog of the reference's ``RAY_CONFIG`` macro table
(`src/ray/common/ray_config_def.h`, 219 entries): a single typed flag table,
overridable per-process via ``RAY_TPU_TORCH_<NAME>`` environment variables and via
the ``_system_config`` dict passed to ``ray_tpu_torch.init`` (propagated to daemons
through their spawn environment).

Flags are plain dataclass fields; types are inferred from defaults. Env parsing
accepts ints, floats, bools ("1/0/true/false") and strings.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict

_ENV_PREFIX = "RAY_TPU_TORCH_"


@dataclasses.dataclass
class Config:
    # ---- RPC / control plane ----
    rpc_connect_timeout_s: float = 10.0
    rpc_request_timeout_s: float = 60.0
    rpc_retry_interval_ms: int = 100
    rpc_max_retries: int = 20
    controller_port: int = 0  # 0 = pick free port
    # ---- health / failure detection (≈ GcsHealthCheckManager, gcs_health_check_manager.h:39) ----
    health_check_period_ms: int = 1000
    health_check_timeout_ms: int = 3000
    health_check_failure_threshold: int = 3
    # ---- workers / scheduling ----
    num_workers_soft_limit: int = 4  # max idle pre-started workers per node
    worker_register_timeout_s: float = 60.0
    worker_lease_timeout_s: float = 30.0
    # push_task replies as soon as the executor QUEUES the task; a worker
    # that can't ack within this window is wedged and its tasks retry
    task_push_timeout_s: float = 60.0
    idle_worker_killing_time_ms: int = 60_000
    # hybrid policy: prefer local node until its utilization crosses this
    # threshold, then pack remote nodes by score (hybrid_scheduling_policy.h:50).
    scheduler_spread_threshold: float = 0.5
    max_tasks_in_flight_per_worker: int = 10
    # ---- object store ----
    object_store_memory_bytes: int = 2 * 1024**3
    # objects <= this are inlined in task replies / in-process store
    # (reference inlines <100KB returns, core_worker.cc:2852 path).
    max_direct_call_object_size: int = 100 * 1024
    object_transfer_chunk_bytes: int = 8 * 1024**2
    # cross-node pulls stream this many chunk RPCs concurrently (a bounded
    # window keeps the wire full without buffering the whole object)
    object_transfer_window: int = 4
    object_spilling_threshold: float = 0.8
    object_spilling_dir: str = ""
    # URI spill target (≈ the reference's object_spilling_config /
    # external_storage.py:496): "" = local dir above; file:///path,
    # mock://dir (fake remote, tests), s3://bucket/prefix
    object_spilling_uri: str = ""
    # ---- control-plane payload guard ----
    # kv_put rejects values above this size with a pointer at the object
    # store / collectives: the controller KV is a metadata plane, and a
    # tensor-sized value would approach MAX_FRAME and stall every other
    # control RPC behind one pickled socket
    kv_max_value_bytes: int = 64 * 1024**2
    # ---- collectives (util/collective, "host" backend data plane) ----
    # data-path algorithm: "auto" picks shared-memory channels when every
    # rank sits on one node (and the world fits the channel reader slots),
    # else the cross-node ring; "shm"/"ring" force one; "kv" forces the
    # controller-KV rounds (rendezvous-only baseline)
    collective_algo: str = "auto"
    # per-frame chunk size + bounded window of in-flight chunk RPCs for
    # ring segments (the RAY_TPU_TORCH_OBJECT_TRANSFER_WINDOW pattern): tensors
    # larger than MAX_FRAME stream as many small frames
    collective_chunk_bytes: int = 4 * 1024**2
    collective_window: int = 4
    # payload capacity of each rank's shared-memory collective channel;
    # larger tensors stream through it in multiple seqlock rounds
    collective_channel_bytes: int = 4 * 1024**2
    # allreduce_coalesced packs same-dtype tensors into buckets of at
    # most this many bytes (one collective round per bucket)
    collective_coalesce_bytes: int = 32 * 1024**2
    # async overlapped collectives (allreduce_coalesced_async): the
    # per-group runner pipelines device->host bucket copies against
    # shm/ring reduce rounds; 0 forces the synchronous coalesced path
    collective_overlap: bool = True
    # mover->reducer handoff depth: packed staging buckets that may sit
    # between the copy stage and the reduce stage
    collective_overlap_depth: int = 2
    # ---- compiled-graph channels (dag.experimental_compile) ----
    # payload capacity of each mutable channel; a step whose packed
    # value exceeds it raises (train.PipelineTrainer takes buffer_bytes=)
    channel_buffer_bytes: int = 4 * 1024**2
    # slot-ring depth: how many committed-but-unacked steps a channel
    # holds before its writer blocks. 1 is the one-in-flight-step
    # seqlock protocol; the pipeline trainer raises it (1F1B runs
    # microbatches ahead of their consumer)
    channel_depth: int = 1
    # total budget for one cross-node per-step push (chunk window +
    # commit); the commit side also waits for remote reader acks under it
    channel_remote_timeout_s: float = 120.0
    # ---- pipeline-parallel training (train.PipelineTrainer) ----
    # interleaved 1F1B virtual stages: each of the S stage actors owns
    # this many non-contiguous model chunks (stage s owns chunks s, s+S,
    # ...), shrinking the bubble roughly by 1/V. An explicit 0 (env or
    # argument) RAISES at build: 0 never silently means 1
    pipeline_virtual_stages: int = 1
    # tensor-parallel width: each stage's chunk params are Megatron
    # column/row-sharded over this many ranks, partial sums allreduced
    # over per-(stage, dp-rank) collective groups. An explicit 0 RAISES
    pipeline_tp: int = 1
    # ---- streaming data plane (data/_internal/streaming.py) ----
    # slot-ring depth of every streaming-ingest channel (reader ->
    # transform -> batcher -> consumer): how many blocks/batches each
    # stage may run ahead of its consumer. Writer backpressure IS the
    # prefetch bound of Dataset.stream_batches. Explicit zeros are
    # REJECTED at build (the falsy-zero lesson)
    data_stream_depth: int = 4
    # default windowed-shuffle buffer ROWS inside the batcher stage when
    # a stream doesn't pass shuffle_buffer= itself; 0 (the default) means
    # no shuffle, but an EXPLICIT RAY_TPU_TORCH_DATA_SHUFFLE_BUFFER=0
    # raises at build instead of silently meaning "off"
    data_shuffle_buffer: int = 0
    # slot-ring depth of every exchange-mesh channel in the streaming
    # all-to-all (data/_internal/exchange.py): how many bucket frames a
    # producer may run ahead of each consumer — the shuffle's
    # backpressure bound. Explicit RAY_TPU_TORCH_DATA_EXCHANGE_DEPTH=0
    # raises at build (the falsy-zero lesson)
    data_exchange_depth: int = 4
    # max ROWS per bucket frame on an exchange edge: a (block, consumer)
    # bucket larger than this streams as several frames, bounding the
    # per-slot channel buffer independently of block size. Explicit
    # RAY_TPU_TORCH_DATA_EXCHANGE_BUCKET_ROWS=0 raises at build
    data_exchange_bucket_rows: int = 4096
    # ---- Podracer RL topologies (rllib/podracer.py) ----
    # slot-ring depth of each runner->learner trajectory channel: how many
    # rollout batches a runner may stream ahead of its learner consuming
    # them, the off-policy lag bound of the Sebulba topology (writer
    # backpressure). Explicit zeros are REJECTED at build
    podracer_channel_depth: int = 4
    # budget for one parameter broadcast round over the learner+runners
    # host collective group
    podracer_bcast_timeout_s: float = 120.0
    # ---- elastic membership (util/collective/resizable.py,
    # _private/elastic.py) ----
    # max respawns PER SLOT over a workload's lifetime before a departure
    # is terminal; explicit zeros are REJECTED at build (pass
    # elastic=False for no elasticity)
    elastic_respawn_budget: int = 3
    # base backoff between respawn attempts on the same slot; attempt n
    # waits backoff * 2**(n-1) seconds (capped at 30s)
    elastic_backoff_s: float = 1.0
    # budget for the post-resize first operation: survivor re-rendezvous
    # at the new generation + joiner param sync over broadcast
    elastic_resize_timeout_s: float = 120.0
    # ---- OOM defense (≈ memory_monitor.h:52) ----
    # kill the newest leased worker when host memory use crosses this
    # fraction; <= 0 disables the monitor
    memory_usage_threshold: float = 0.95
    memory_monitor_interval_ms: int = 1000
    # ---- retries / lineage ----
    task_max_retries: int = 3
    actor_max_restarts: int = 0
    lineage_max_bytes: int = 64 * 1024**2
    # ---- serve: the fleet (router and scheduler) ----
    # prefix-affinity routing: replicas advertise a digest of their radix
    # cache's page-boundary prefix hashes through the controller's stats
    # poll; the router steers a prompt to the replica holding the deepest
    # match, falling back to pow-2 choice past the skew bound below
    serve_affinity: bool = True
    # the steered replica may carry at most this many MORE in-flight
    # requests than the least-loaded one before the router drops affinity
    # for pow-2 choice on this pick
    serve_affinity_skew: int = 4
    # cross-replica page migration: max pages one fleet-hit pull copies
    # from the holder. An explicit 0 RAISES at build; it never means
    # "migration off" (pass serve_affinity=False / no hint for that)
    serve_migration_budget: int = 64
    # ---- logging / observability ----
    # flight recorder (_private/flight.py): always-on per-thread ring
    # buffers of packed span records over the zero-RPC hot loops, drained
    # out-of-band via the flight_dump RPC / util.state.flight_timeline.
    # NOTE: flight.py reads these via the RAY_TPU_TORCH_FLIGHT_* env vars at
    # import (before any cluster config exists); the fields here document
    # the knobs and propagate non-default values to spawned daemons
    flight_enabled: bool = True
    flight_buffer_records: int = 16384
    log_dir: str = ""
    event_buffer_size: int = 10_000
    metrics_report_interval_ms: int = 5000
    task_event_buffer_size: int = 100_000
    # Prometheus /metrics HTTP port per daemon: 0 = auto-pick, -1 = off
    metrics_export_port: int = 0
    # bind address for /metrics; set 0.0.0.0 for off-host Prometheus
    # (the scrape endpoint is read-only; the jobs/dashboard API lives on
    # its own port below and is NOT safe to expose unauthenticated)
    metrics_export_host: str = "127.0.0.1"
    # dashboard + job-submission REST (loopback-only by default: the job
    # API executes entrypoints, treat like ssh); -1 disables
    dashboard_host: str = "127.0.0.1"
    dashboard_port: int = 0
    # controller durable-state snapshot cadence (actors/PGs/jobs/KV)
    controller_snapshot_interval_ms: int = 500
    # in-process KV shards, partitioned by namespace hash; each shard
    # appends to its own WAL stream (kv_shards.KvShardMap — the
    # structural first step toward out-of-process control-plane shards)
    controller_kv_shards: int = 8
    # how long clients ride out a controller kill+restart window:
    # registrations and re-issued kv_wait long-polls retry reconnecting
    # for this budget before surfacing the outage to the caller
    controller_reconnect_budget_s: float = 30.0
    # durable control-plane store target: "" = session-dir files; any
    # external-storage URI (file://, mock://, s3://) puts snapshots+WAL
    # in that backend so head-disk loss is recoverable
    # (≈ src/ray/gcs/store_client/redis_store_client.h)
    controller_store_uri: str = ""
    # ---- fault injection (chaos.py; every knob defaults OFF) ----
    # seed for the deterministic fault schedule; < 0 disables chaos
    # entirely (the rpc hot path then pays one None-check)
    chaos_seed: int = -1
    # per-RPC-event probabilities, each drawn deterministically from
    # (seed, side:method, nth-call): drop = lose the frame + sever the
    # connection; dup = deliver the request twice; delay = hold the frame
    # up to chaos_delay_max_ms
    chaos_drop_prob: float = 0.0
    chaos_dup_prob: float = 0.0
    chaos_delay_prob: float = 0.0
    chaos_delay_max_ms: int = 50
    # comma-separated RPC method names to target ("" = all methods)
    chaos_methods: str = ""
    # "point[:nth],..." — hard-exit the daemon the nth time it passes the
    # named chaos.maybe_crash() point (deterministic process death)
    chaos_crash_points: str = ""
    # ---- testing ----
    fake_cluster: bool = False

    def recovery_grace_s(self) -> float:
        """How long a node gets to re-register after a controller
        restart before it is treated as lost. Shared by the controller's
        post-recovery reconcile (ghost-node death fan-out, actor
        failover) and the supervisors' missing-node debounce (pin /
        channel sweep) — the two sides of the recovery protocol must
        agree on this window or a supervisor could sweep a peer's pins
        while the controller still expects it back."""
        return (self.health_check_period_ms
                * self.health_check_failure_threshold / 1000.0) + 3.0

    @classmethod
    def from_env(cls, overrides: Dict[str, Any] | None = None) -> "Config":
        cfg = cls()
        for f in dataclasses.fields(cls):
            env_key = _ENV_PREFIX + f.name.upper()
            if env_key in os.environ:
                setattr(cfg, f.name, _parse(os.environ[env_key], f.type, getattr(cfg, f.name)))
        if overrides:
            for k, v in overrides.items():
                if not hasattr(cfg, k):
                    raise ValueError(f"Unknown system config key: {k}")
                setattr(cfg, k, v)
        return cfg

    def to_env(self) -> Dict[str, str]:
        """Render non-default flags as env vars for spawned daemons."""
        out = {}
        default = Config()
        for f in dataclasses.fields(self):
            val = getattr(self, f.name)
            if val != getattr(default, f.name):
                out[_ENV_PREFIX + f.name.upper()] = _render(val)
        return out


def _parse(raw: str, typ, default):
    t = type(default)
    if t is bool:
        return raw.lower() in ("1", "true", "yes", "on")
    if t is int:
        return int(raw)
    if t is float:
        return float(raw)
    return raw


def _render(val) -> str:
    if isinstance(val, bool):
        return "1" if val else "0"
    if isinstance(val, (dict, list)):
        return json.dumps(val)
    return str(val)


def env_flag_explicit(field_name: str) -> bool | None:
    """True/False iff the ``RAY_TPU_TORCH_<FIELD_NAME>`` env var is explicitly
    set — parsed by the SAME bool rule ``Config.from_env`` uses — else
    None. For callers that must distinguish an operator's explicit env
    intent from a config-field default (e.g. loud knob-conflict
    rejection) without re-implementing the parser."""
    raw = os.environ.get(_ENV_PREFIX + field_name.upper())
    if raw is None:
        return None
    return bool(_parse(raw, bool, False))


_global_config: Config | None = None


def global_config() -> Config:
    global _global_config
    if _global_config is None:
        _global_config = Config.from_env()
    return _global_config


def set_global_config(cfg: Config) -> None:
    global _global_config
    _global_config = cfg
