"""Pluggable control-plane persistence (≈ the reference's GCS store
clients: `src/ray/gcs/store_client/redis_store_client.h` for the remote
case, `gcs_init_data.h` for recovery composition).

The controller persists two things: interval snapshots (full durable
state, compaction) and a write-ahead log of registration/tombstone
frames acked between snapshots. This module puts both behind one
``ControlStore`` interface so the storage can be:

- ``FileControlStore`` — fsynced files in the session dir (default;
  single-disk, fast appends);
- ``UriControlStore`` — any `external_storage.py` URI backend
  (file://, mock://, s3://): every WAL frame is its own sequenced
  object and snapshots are epoch-keyed objects, which is exactly the
  one-write-per-op shape Redis gives the reference's GCS — and means
  head-node loss no longer loses the control plane.

Keys are unique-write (``snap.<epoch>``, ``wal.<epoch>.<seq>``), so no
backend needs overwrite or native append; recovery lists by prefix and
takes the newest snapshot plus every frame of newer epochs.

WAL *streams*: the controller's KV is sharded by namespace hash
(``kv_shards.KvShardMap``) and each shard appends to its own named
stream (``wal-kv3.<epoch>``) — the default stream (``stream=""``) keeps
the legacy ``wal.<epoch>`` naming, so pre-shard session dirs still
replay. Separate streams are the storage-side half of the refactor that
lets shards move out-of-process later: a shard's durable log is already
self-contained.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Tuple

from ray_tpu_torch._private import external_storage

_LEN = 4  # file-WAL frame header bytes


def _wal_prefix(stream: str) -> str:
    """``wal.`` for the default stream, ``wal-<stream>.`` for named ones
    (both parse their epoch as ``name.split(".")[1]``)."""
    return f"wal-{stream}." if stream else "wal."


class ControlStore:
    """Durable snapshot + WAL storage for the controller."""

    def write_snapshot(self, epoch: int, blob: bytes) -> None:
        raise NotImplementedError

    def load_latest_snapshot(self) -> Optional[bytes]:
        for blob in self.load_snapshots():
            return blob
        return None

    def load_snapshots(self) -> Iterator[bytes]:
        """Readable snapshot blobs, NEWEST epoch first. Recovery takes the
        first one that also *parses*: a corrupt latest snapshot falls back
        to the previous epoch instead of discarding the control plane."""
        raise NotImplementedError

    def list_snapshot_epochs(self) -> List[int]:
        """Sorted epochs with a snapshot on disk. Compaction keys its
        retention off this inventory (keep the previous snapshot + the
        WAL it needs) — epoch numbers are NOT consecutive across
        controller restarts, so arithmetic on the current epoch would
        sweep the fallback generation."""
        raise NotImplementedError

    def append_wal(self, epoch: int, frame: bytes, stream: str = "") -> None:
        """Durable before return (the ack-implies-durability contract)."""
        raise NotImplementedError

    def read_wal(self, epoch: int, stream: str = "") -> List[bytes]:
        raise NotImplementedError

    def list_wal_epochs(self) -> List[int]:
        """Sorted epochs with at least one frame in ANY stream. Recovery
        replays every epoch newer than the installed snapshot (several can
        accumulate when interval snapshots failed or fell back)."""
        raise NotImplementedError

    def list_wal_streams(self) -> List[str]:
        """Sorted NAMED streams with frames on disk (the default stream is
        not listed). Recovery replays every stream it finds, so frames
        written by an incarnation with a different KV shard count are
        never silently skipped."""
        raise NotImplementedError

    def sweep_wals(self, max_epoch: int) -> None:
        """Remove frames of epochs <= max_epoch across EVERY stream."""
        raise NotImplementedError

    def sweep_snapshots(self, keep_epoch: int) -> None:
        pass


class FileControlStore(ControlStore):
    """Session-dir files: one fsynced snapshot file per epoch (atomic
    tmp-then-replace) and one append-only fsynced WAL file per epoch.
    A torn WAL tail — crash mid-append — ends the replay cleanly."""

    def __init__(self, base_dir: str):
        self._dir = base_dir
        os.makedirs(base_dir, exist_ok=True)

    def _snap_path(self, epoch: int) -> str:
        return os.path.join(self._dir, f"snap.{epoch:012d}")

    def _wal_path(self, epoch: int, stream: str = "") -> str:
        return os.path.join(self._dir, f"{_wal_prefix(stream)}{epoch:012d}")

    def write_snapshot(self, epoch: int, blob: bytes) -> None:
        path = self._snap_path(epoch)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def _snap_epochs(self) -> List[int]:
        out = []
        try:
            names = os.listdir(self._dir)
        except OSError:
            return out
        for n in names:
            if n.startswith("snap.") and not n.endswith(".tmp"):
                try:
                    out.append(int(n[len("snap."):]))
                except ValueError:
                    continue
        return sorted(out)

    def load_snapshots(self) -> "Iterator[bytes]":
        for epoch in reversed(self._snap_epochs()):
            try:
                with open(self._snap_path(epoch), "rb") as f:
                    yield f.read()
            except OSError:
                continue

    def list_snapshot_epochs(self) -> List[int]:
        return self._snap_epochs()

    def append_wal(self, epoch: int, frame: bytes, stream: str = "") -> None:
        with open(self._wal_path(epoch, stream), "ab") as f:
            f.write(len(frame).to_bytes(_LEN, "big") + frame)
            f.flush()
            os.fsync(f.fileno())

    def read_wal(self, epoch: int, stream: str = "") -> List[bytes]:
        try:
            with open(self._wal_path(epoch, stream), "rb") as f:
                data = f.read()
        except OSError:
            return []
        frames, off = [], 0
        while off + _LEN <= len(data):
            n = int.from_bytes(data[off:off + _LEN], "big")
            if off + _LEN + n > len(data):
                break  # torn tail
            frames.append(data[off + _LEN:off + _LEN + n])
            off += _LEN + n
        return frames

    def _wal_names(self) -> List[str]:
        try:
            names = os.listdir(self._dir)
        except OSError:
            return []
        return [n for n in names
                if (n.startswith("wal.") or n.startswith("wal-"))
                and "." in n]

    def list_wal_epochs(self) -> List[int]:
        epochs = set()
        for n in self._wal_names():
            try:
                epochs.add(int(n.split(".", 1)[1]))
            except ValueError:
                continue
        return sorted(epochs)

    def list_wal_streams(self) -> List[str]:
        return sorted({n.split(".", 1)[0][len("wal-"):]
                       for n in self._wal_names()
                       if n.startswith("wal-")})

    def sweep_wals(self, max_epoch: int) -> None:
        for n in self._wal_names():
            try:
                if int(n.split(".", 1)[1]) <= max_epoch:
                    os.unlink(os.path.join(self._dir, n))
            except (ValueError, OSError):
                continue

    def sweep_snapshots(self, keep_epoch: int) -> None:
        for epoch in self._snap_epochs():
            if epoch < keep_epoch:
                try:
                    os.unlink(self._snap_path(epoch))
                except OSError:
                    pass


class UriControlStore(ControlStore):
    """Control plane on an external (possibly remote) object store.

    One object per WAL frame (``wal.<epoch>.<seq>``) — the Redis write
    shape — and one object per snapshot epoch. Requires the backend to
    support ``list_keys`` (all real object stores do)."""

    def __init__(self, backend: external_storage.ExternalStorage):
        self._backend = backend
        # per-(stream, epoch) next-sequence counters, lazily seeded
        self._seqs: dict = {}

    def _put(self, key: str, blob: bytes) -> None:
        self._backend.put(key, blob)

    def _list(self, prefix: str) -> List[Tuple[str, str]]:
        return sorted(self._backend.list_keys(prefix))

    def write_snapshot(self, epoch: int, blob: bytes) -> None:
        self._put(f"snap.{epoch:012d}", blob)

    def load_snapshots(self) -> "Iterator[bytes]":
        entries = self._list("snap.")
        for key, uri in reversed(entries):
            try:
                yield self._backend.get(uri)
            except Exception:
                continue

    def list_snapshot_epochs(self) -> List[int]:
        out = []
        for key, _ in self._list("snap."):
            try:
                out.append(int(key.split(".", 1)[1]))
            except (ValueError, IndexError):
                continue
        return sorted(out)

    def append_wal(self, epoch: int, frame: bytes, stream: str = "") -> None:
        seq = self._seqs.get((stream, epoch))
        if seq is None:
            # resume past any frames a previous incarnation wrote to
            # this epoch (crash after snapshot, appends, crash again):
            # starting at 1 would overwrite them
            existing = self._list(f"{_wal_prefix(stream)}{epoch:012d}.")
            seq = max(
                (int(k.split(".")[2]) for k, _ in existing), default=0)
        seq += 1
        self._seqs[(stream, epoch)] = seq
        self._put(f"{_wal_prefix(stream)}{epoch:012d}.{seq:012d}", frame)

    def read_wal(self, epoch: int, stream: str = "") -> List[bytes]:
        out = []
        for key, uri in self._list(f"{_wal_prefix(stream)}{epoch:012d}."):
            try:
                out.append(self._backend.get(uri))
            except Exception as e:
                # unlike a file WAL — where a torn frame can only be the
                # tail of a crashed append — every listed URI frame was
                # fully written before the next ack, so a mid-log read
                # failure is a transient backend error. Swallowing it
                # would silently discard every LATER acked frame; fail
                # recovery loudly and let the operator retry.
                raise RuntimeError(
                    f"control-plane WAL frame {key} unreadable during "
                    f"recovery; retry (transient backend error?): {e}"
                ) from e
        return out

    def _wal_entries(self) -> List[Tuple[str, str]]:
        # "wal" matches both the default ("wal.") and named ("wal-kv3.")
        # stream key families; both parse their epoch as split(".")[1]
        return [(k, u) for k, u in self._list("wal")
                if k.startswith("wal.") or k.startswith("wal-")]

    def list_wal_epochs(self) -> List[int]:
        epochs = set()
        for key, _ in self._wal_entries():
            try:
                epochs.add(int(key.split(".")[1]))
            except (ValueError, IndexError):
                continue
        return sorted(epochs)

    def list_wal_streams(self) -> List[str]:
        return sorted({key.split(".", 1)[0][len("wal-"):]
                       for key, _ in self._wal_entries()
                       if key.startswith("wal-")})

    def sweep_wals(self, max_epoch: int) -> None:
        for key, uri in self._wal_entries():
            try:
                if int(key.split(".")[1]) <= max_epoch:
                    self._backend.delete(uri)
            except (ValueError, IndexError):
                continue
        # the per-(stream, epoch) sequence counters of swept epochs are
        # dead weight: compaction sweeps on every dirty interval, so
        # without pruning a long-lived controller accretes one entry per
        # epoch per stream forever
        for k in [k for k in self._seqs if k[1] <= max_epoch]:
            del self._seqs[k]

    def sweep_snapshots(self, keep_epoch: int) -> None:
        for key, uri in self._list("snap."):
            try:
                if int(key.split(".", 1)[1]) < keep_epoch:
                    self._backend.delete(uri)
            except (ValueError, IndexError):
                continue


def control_store_for(target: str, default_dir: str) -> ControlStore:
    """Build the controller's store: empty target / file:// / bare path
    -> fsynced session-or-target-dir files (FileControlStore — the
    external FileSystemStorage backend never fsyncs, which would break
    append_wal's durable-before-ack contract on local disks); genuinely
    remote URIs (mock://, s3://) -> that backend (config flag
    ``controller_store_uri``, ref `redis_store_client.h`)."""
    if not target:
        return FileControlStore(default_dir)
    if target.startswith("file://"):
        return FileControlStore(target[len("file://"):])
    if "://" not in target:
        return FileControlStore(target)
    return UriControlStore(
        external_storage.storage_from_spill_target(target, default_dir))
