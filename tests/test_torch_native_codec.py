"""Native codec (CRC32C + varints): correctness vs known vectors and the
python fallbacks, and the native/python paths agreeing bit-for-bit — the
twins of ``tests/test_native_codec.py`` — plus the port's outputs equal
to the JAX package's codec on the same seeded bytes and values."""

import numpy as np
import pytest

from ray_tpu_torch._native import codec
from ray_tpu_torch._native.build import native_available


class TestCRC32C:
    def test_known_vectors(self):
        # RFC 3720 test vectors for CRC-32C
        assert codec.crc32c(b"") == 0
        assert codec.crc32c(b"123456789") == 0xE3069283
        assert codec.crc32c(b"\x00" * 32) == 0x8A9136AA

    def test_python_fallback_matches(self):
        rng = np.random.default_rng(0)
        for n in (1, 7, 8, 63, 1024, 100_000):
            data = rng.integers(0, 256, n, np.uint8).tobytes()
            assert codec.crc32c(data) == codec._py_crc32c(data)

    def test_masked_crc_tfrecord_convention(self):
        crc = codec.crc32c(b"payload")
        expect = ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF
        assert codec.masked_crc32c(b"payload") == expect

    def test_incremental(self):
        data = b"hello tfrecord world" * 13
        whole = codec.crc32c(data)
        part = codec.crc32c(data[7:], codec.crc32c(data[:7]))
        assert part == whole


class TestVarints:
    @pytest.mark.parametrize("vals", [
        [0], [1], [127], [128], [300], [2 ** 40],
        [-1], [-123456789], [2 ** 62, -(2 ** 62)],
        list(range(-50, 50)),
    ])
    def test_roundtrip(self, vals):
        blob = codec.varint_encode(vals)
        assert codec.varint_decode(blob) == vals

    def test_matches_python_encoding(self):
        vals = [0, 1, -1, 300, -300, 2 ** 50]
        blob = codec.varint_encode(vals)
        expect = b"".join(codec._py_encode_varint(v) for v in vals)
        assert blob == expect

    def test_truncated_raises_or_detects(self):
        blob = codec.varint_encode([2 ** 40])
        if native_available("codec"):
            with pytest.raises(ValueError, match="truncated"):
                codec.varint_decode(blob[:-1] + b"\x80")


def test_native_build_available():
    """The image ships g++: the native path must actually be exercised in
    CI, not silently fall back."""
    assert native_available("codec"), "native codec failed to build"


class TestAgainstJax:
    """The port's codec (built into its own cache) against the JAX
    package's, on the same seeded inputs."""

    @pytest.mark.parametrize("n", [0, 1, 7, 8, 63, 4096, 100_003])
    def test_crc32c_and_masked_crc_match_jax(self, n):
        from ray_tpu._native import codec as jcodec

        data = np.random.default_rng(n).integers(0, 256, n,
                                                 np.uint8).tobytes()
        assert codec.crc32c(data) == jcodec.crc32c(data)
        assert codec.masked_crc32c(data) == jcodec.masked_crc32c(data)
        assert codec.crc32c(data, 12345) == jcodec.crc32c(data, 12345)

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_varints_match_jax(self, seed):
        from ray_tpu._native import codec as jcodec

        rng = np.random.default_rng(seed)
        vals = (rng.integers(-2 ** 63, 2 ** 63 - 1, 200, dtype=np.int64)
                >> rng.integers(0, 63, 200)).tolist() + [0, -1, 2 ** 63 - 1]
        blob = codec.varint_encode(vals)
        assert blob == jcodec.varint_encode(vals)
        assert codec.varint_decode(blob) == jcodec.varint_decode(blob) == vals

    def test_both_packages_run_their_native_builds(self):
        from ray_tpu._native import codec as jcodec

        assert codec._get() is not None and jcodec._get() is not None
        assert codec._get()._name != jcodec._get()._name
