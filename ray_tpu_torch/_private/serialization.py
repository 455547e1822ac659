"""Object serialization.

Analog of the reference's serialization context
(`python/ray/_private/serialization.py:111`): cloudpickle for arbitrary Python
objects, with pickle-5 out-of-band buffers so large numpy arrays serialize
zero-copy into (and out of) the shared-memory host object store.

Differences from the reference, by design:
  * torch tensors serialize as their raw bytes plus dtype and shape: one
    out-of-band ``uint8`` buffer (so a GiB tensor is written into the arena
    piecewise, with one memcpy) and a small in-band header. The bytes are
    the tensor's own, so bf16 (which numpy cannot hold) round-trips bit for
    bit. A CUDA tensor is copied to the host here; the object layer keeps
    large CUDA tensors on their card instead (``device_objects``), and only
    small ones or nested ones come through this path. Rebuilt tensors live
    on the CPU. A tensor read from the arena is copied out of it once
    (numpy arrays stay read-only views): torch has no read-only tensors,
    and a write through a view would change the shared copy.
  * No vendored cloudpickle; the environment pins a compatible version.

Wire format of a serialized object:
    [u32 n_buffers] [u64 len_meta] [meta pickle bytes] [u64 len_b0] [b0] ...
"""

from __future__ import annotations

import io
import pickle
import struct
from typing import Any, List, Tuple

import cloudpickle

PICKLE_PROTOCOL = 5

_HEADER = struct.Struct("<IQ")
_BUFLEN = struct.Struct("<Q")


def _is_torch_tensor(obj: Any) -> bool:
    # By module name first: control-plane daemons never import torch.
    if not type(obj).__module__.startswith("torch"):
        return False
    import torch

    return isinstance(obj, torch.Tensor)


def _rebuild_tensor(data, dtype_name: str, shape: Tuple[int, ...]):
    import torch

    dtype = getattr(torch, dtype_name)
    buf = memoryview(data).cast("B")
    if buf.nbytes == 0:
        return torch.empty(shape, dtype=dtype)
    if buf.readonly:  # an in-band copy, or a read-only arena view
        buf = memoryview(bytearray(buf))
    return torch.frombuffer(buf, dtype=torch.uint8).view(dtype).reshape(shape)


class _TensorPickler(cloudpickle.CloudPickler):
    """cloudpickle with torch tensors reduced to (raw bytes, dtype, shape)."""

    def reducer_override(self, obj):
        if _is_torch_tensor(obj):
            return _reduce_tensor(obj)
        return super().reducer_override(obj)


def _reduce_tensor(t):
    import torch

    if t.requires_grad:
        t = t.detach()
    t = t.cpu().contiguous()
    shape = tuple(t.shape)
    raw = t.reshape(-1).view(torch.uint8).numpy() if t.numel() else b""
    return _rebuild_tensor, (pickle.PickleBuffer(raw) if len(raw) else raw,
                             str(t.dtype).split(".")[-1], shape)


def _dumps(obj: Any, buffer_callback=None) -> bytes:
    f = io.BytesIO()
    _TensorPickler(f, protocol=PICKLE_PROTOCOL,
                   buffer_callback=buffer_callback).dump(obj)
    return f.getvalue()


def serialize(obj: Any) -> Tuple[bytes, List[pickle.PickleBuffer]]:
    """Serialize to (meta_bytes, out_of_band_buffers)."""
    buffers: List[pickle.PickleBuffer] = []
    meta = _dumps(obj, buffer_callback=buffers.append)
    return meta, buffers


def pack_parts(meta: bytes, buffers: List[pickle.PickleBuffer]) -> bytes:
    """Join already-serialized parts into the contiguous pack() layout."""
    parts = [_HEADER.pack(len(buffers), len(meta)), meta]
    for b in buffers:
        raw = b.raw()
        parts.append(_BUFLEN.pack(raw.nbytes))
        parts.append(raw)
    return b"".join(parts)


def pack(obj: Any) -> bytes:
    """Serialize to a single contiguous byte string (header + meta + buffers)."""
    meta, buffers = serialize(obj)
    return pack_parts(meta, buffers)


def pack_into(obj: Any, dest: memoryview) -> int:
    """Pack directly into a writable memoryview (e.g. a shared-memory segment).

    Returns bytes written. Raises ValueError if dest is too small.
    """
    data = pack(obj)  # single copy path; arena-level zero-copy is the C++ store's job
    if len(data) > len(dest):
        raise ValueError(f"object of size {len(data)} exceeds buffer {len(dest)}")
    dest[: len(data)] = data
    return len(data)


def unpack(data) -> Any:
    """Inverse of pack(). Accepts bytes or memoryview; buffers are zero-copy views."""
    view = memoryview(data)
    n_buf, len_meta = _HEADER.unpack_from(view, 0)
    off = _HEADER.size
    meta = view[off : off + len_meta]
    off += len_meta
    buffers = []
    for _ in range(n_buf):
        (blen,) = _BUFLEN.unpack_from(view, off)
        off += _BUFLEN.size
        buffers.append(view[off : off + blen])
        off += blen
    return pickle.loads(meta, buffers=buffers)


def inband_size(view) -> int:
    """Bytes pickle will parse IN-BAND for this packed payload (the meta
    pickle). Out-of-band buffers deserialize as O(1) views, so this — not
    the total size — is what decides whether unpacking is heavy."""
    _, len_meta = _HEADER.unpack_from(view, 0)
    return len_meta


def unpack_zero_copy(view: memoryview, buffer_factory) -> Tuple[Any, int]:
    """unpack() variant for pin-backed zero-copy reads: each out-of-band
    payload buffer is routed through ``buffer_factory(sub_view)`` and the
    factory's RESULT is what pickle hands to the reconstructor (numpy et
    al. keep a reference to it for the life of the deserialized array) —
    the caller uses that hook to attach pin-release finalizers. In-band
    meta is parsed by pickle without retaining the input buffer, so only
    out-of-band buffers keep the arena range alive. Returns
    (obj, n_out_of_band_buffers)."""
    n_buf, len_meta = _HEADER.unpack_from(view, 0)
    off = _HEADER.size
    meta = view[off : off + len_meta]
    off += len_meta
    buffers = []
    for _ in range(n_buf):
        (blen,) = _BUFLEN.unpack_from(view, off)
        off += _BUFLEN.size
        buffers.append(buffer_factory(view[off : off + blen]))
        off += blen
    return pickle.loads(meta, buffers=buffers), n_buf


def packed_size(obj: Any) -> Tuple[bytes, List[pickle.PickleBuffer], int]:
    """Serialize and report total packed size without concatenating."""
    meta, buffers = serialize(obj)
    total = _HEADER.size + len(meta)
    for b in buffers:
        total += _BUFLEN.size + b.raw().nbytes
    return meta, buffers, total


# buffers at least this large are copied into the arena by a few threads
# at once: a copy into fresh shared-memory pages is bound by page faults,
# which a single thread takes one by one (chip_smoke.py's 1 GiB host put
# on the H100 machine: 0.47-0.48 GB/s on one thread, 2.56 GB/s on eight)
_PARALLEL_COPY_BYTES = 64 * 1024 * 1024
_COPY_PIECE_BYTES = 16 * 1024 * 1024
_COPY_THREADS = 8


def _copy_pieces(dest: memoryview, jobs) -> None:
    """Copy each (offset, source buffer) of ``jobs`` into ``dest`` in
    pieces, on up to ``_COPY_THREADS`` threads: numpy's copy releases the
    GIL, so the pieces fault their pages in parallel."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    out = np.frombuffer(dest, np.uint8)
    pieces = []
    for off, raw in jobs:
        src = np.frombuffer(raw, np.uint8)
        for a in range(0, src.size, _COPY_PIECE_BYTES):
            pieces.append((off + a, src[a:a + _COPY_PIECE_BYTES]))

    def copy(piece):
        off, src = piece
        np.copyto(out[off:off + src.size], src)

    threads = min(_COPY_THREADS, os.cpu_count() or 1, len(pieces))
    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(copy, pieces))


def write_packed(dest: memoryview, meta: bytes,
                 buffers: List[pickle.PickleBuffer]) -> int:
    """Write the pack() layout piecewise into *dest* (an arena view):
    each out-of-band buffer lands with ONE copy from its source, no
    intermediate join (1 full copy instead of 2 for a GiB-class numpy or
    torch payload); past ``_PARALLEL_COPY_BYTES`` of them, the copies run
    in pieces on a few threads. Returns bytes written; layout identical to
    pack()/unpack()."""
    pos = 0
    big = []

    def put(chunk) -> None:
        nonlocal pos
        n = chunk.nbytes if isinstance(chunk, memoryview) else len(chunk)
        dest[pos:pos + n] = chunk
        pos += n

    put(_HEADER.pack(len(buffers), len(meta)))
    put(meta)
    for b in buffers:
        raw = b.raw()
        put(_BUFLEN.pack(raw.nbytes))
        big.append((pos, raw))
        pos += raw.nbytes
    if sum(raw.nbytes for _, raw in big) >= _PARALLEL_COPY_BYTES:
        _copy_pieces(dest, big)
    else:
        for off, raw in big:
            dest[off:off + raw.nbytes] = raw
    return pos


def payload_nbytes(obj: Any) -> int:
    """Cheap size estimate for control-plane payload caps: exact for the
    bulk carriers (bytes-likes, numpy arrays, torch tensors — the things users
    mistakenly push through the KV), 0 for small structured values whose
    serialized size is not worth computing. Containers sum recursively so
    a list/dict/tuple of arrays is still caught."""
    if isinstance(obj, memoryview):
        return obj.nbytes  # len() is the first-dimension element count
    if isinstance(obj, (bytes, bytearray)):
        return len(obj)
    if isinstance(obj, str):
        return len(obj)  # ≈ utf-8 bytes for the ascii bulk cases
    nbytes = getattr(obj, "nbytes", None)
    if nbytes is not None:
        try:
            return int(nbytes)
        except (TypeError, ValueError):
            return 0
    if isinstance(obj, (list, tuple)):
        return sum(payload_nbytes(v) for v in obj)
    if isinstance(obj, dict):
        return sum(payload_nbytes(v) for v in obj.values())
    return 0


def dumps(obj: Any) -> bytes:
    """Plain in-band pickle (for RPC messages, not object payloads)."""
    return _dumps(obj)


def loads(data: bytes) -> Any:
    return pickle.loads(data)
