"""ctypes surface over codec.cpp (CRC32C + proto varints) with pure-Python
fallbacks. Consumers: the TFRecord datasource (masked CRCs over MB-scale
payloads, int64 feature lists) and object-chunk integrity checks."""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import numpy as np

from ray_tpu_torch._native.build import load_library

_lib: Optional[ctypes.CDLL] = None
_probed = False


def _get() -> Optional[ctypes.CDLL]:
    global _lib, _probed
    if not _probed:
        _probed = True
        lib = load_library("codec")
        if lib is not None:
            lib.rt_crc32c.restype = ctypes.c_uint32
            lib.rt_crc32c.argtypes = [ctypes.c_uint32, ctypes.c_char_p,
                                      ctypes.c_size_t]
            lib.rt_masked_crc32c.restype = ctypes.c_uint32
            lib.rt_masked_crc32c.argtypes = [ctypes.c_char_p,
                                             ctypes.c_size_t]
            lib.rt_varint_encode.restype = ctypes.c_size_t
            lib.rt_varint_encode.argtypes = [
                ctypes.POINTER(ctypes.c_int64), ctypes.c_size_t,
                ctypes.c_char_p]
            lib.rt_varint_decode.restype = ctypes.c_size_t
            lib.rt_varint_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_size_t]
        _lib = lib
    return _lib


def crc32c(data: bytes, crc: int = 0) -> int:
    lib = _get()
    if lib is not None:
        return int(lib.rt_crc32c(crc, data, len(data)))
    return _py_crc32c(data, crc)


def masked_crc32c(data: bytes) -> int:
    lib = _get()
    if lib is not None:
        return int(lib.rt_masked_crc32c(data, len(data)))
    crc = _py_crc32c(data, 0)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


def varint_encode(vals: Sequence[int]) -> bytes:
    lib = _get()
    if lib is not None:
        arr = np.asarray(vals, np.int64)
        out = ctypes.create_string_buffer(10 * len(arr))
        n = lib.rt_varint_encode(
            arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(arr), out)
        return out.raw[:n]
    return b"".join(_py_encode_varint(int(v)) for v in vals)


def varint_decode(buf: bytes, max_count: Optional[int] = None) -> List[int]:
    lib = _get()
    if lib is not None:
        cap = max_count if max_count is not None else len(buf)
        out = (ctypes.c_int64 * cap)()
        n = lib.rt_varint_decode(buf, len(buf), out, cap)
        if n == ctypes.c_size_t(-1).value:
            raise ValueError("truncated varint stream")
        return list(out[:n])
    vals, pos = [], 0
    while pos < len(buf) and (max_count is None or len(vals) < max_count):
        try:
            x, pos = _py_read_varint(buf, pos)
        except (IndexError, OverflowError):
            raise ValueError("truncated varint stream") from None
        if x >= 1 << 63:
            x -= 1 << 64
        vals.append(x)
    return vals


# ------------------------------------------------------- python fallbacks

_PY_TABLE: Optional[List[int]] = None


def _py_crc32c(data: bytes, crc: int = 0) -> int:
    global _PY_TABLE
    if _PY_TABLE is None:
        poly = 0x82F63B78
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            table.append(c)
        _PY_TABLE = table
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = _PY_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _py_encode_varint(x: int) -> bytes:
    if x < 0:
        x += 1 << 64
    out = bytearray()
    while True:
        b = x & 0x7F
        x >>= 7
        if x:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _py_read_varint(buf: bytes, pos: int):
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift >= 64:  # overlong: reject like the native path
            raise OverflowError("varint exceeds 64 bits")
