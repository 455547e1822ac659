// Native wire-codec primitives for the data plane.
//
// Host-side analog of the reference's native record/transfer code paths
// (crc32c in object_manager chunk transfer; record framing in data
// ingest): slice-by-8 CRC32C, the TFRecord masked CRC, and batch varint
// encode/decode for the tf.train.Example int64 lists. Exposed as plain C
// symbols for ctypes (no pybind11 in the image).
//
// Build: g++ -O2 -shared -fPIC (see _native/build.py).

#include <cstdint>
#include <cstddef>
#include <cstring>

namespace {

constexpr uint32_t kPoly = 0x82F63B78u;  // CRC-32C (Castagnoli)

struct Tables {
  uint32_t t[8][256];
  Tables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ kPoly : c >> 1;
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int s = 1; s < 8; ++s)
        t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

const Tables kTables;

}  // namespace

extern "C" {

// Slice-by-8 CRC32C over buf[0..len); init with 0 for a fresh checksum.
uint32_t rt_crc32c(uint32_t crc, const uint8_t* buf, size_t len) {
  crc = ~crc;
  // align-friendly 8-byte blocks
  while (len >= 8) {
    uint64_t w;
    std::memcpy(&w, buf, 8);
    crc ^= static_cast<uint32_t>(w);
    uint32_t hi = static_cast<uint32_t>(w >> 32);
    crc = kTables.t[7][crc & 0xFF] ^ kTables.t[6][(crc >> 8) & 0xFF] ^
          kTables.t[5][(crc >> 16) & 0xFF] ^ kTables.t[4][crc >> 24] ^
          kTables.t[3][hi & 0xFF] ^ kTables.t[2][(hi >> 8) & 0xFF] ^
          kTables.t[1][(hi >> 16) & 0xFF] ^ kTables.t[0][hi >> 24];
    buf += 8;
    len -= 8;
  }
  while (len--) crc = kTables.t[0][(crc ^ *buf++) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

// TFRecord masked crc: rotr15(crc) + magic (record_writer.cc convention).
uint32_t rt_masked_crc32c(const uint8_t* buf, size_t len) {
  uint32_t crc = rt_crc32c(0, buf, len);
  return ((crc >> 15) | (crc << 17)) + 0xA282EAD8u;
}

// Batch-encode n int64s as proto varints (two's complement as unsigned).
// Returns bytes written; out must hold >= 10*n bytes.
size_t rt_varint_encode(const int64_t* vals, size_t n, uint8_t* out) {
  uint8_t* p = out;
  for (size_t i = 0; i < n; ++i) {
    uint64_t x = static_cast<uint64_t>(vals[i]);
    while (x >= 0x80) {
      *p++ = static_cast<uint8_t>(x) | 0x80;
      x >>= 7;
    }
    *p++ = static_cast<uint8_t>(x);
  }
  return static_cast<size_t>(p - out);
}

// Decode varints from buf[0..len) into out (capacity cap). Returns the
// count decoded, or (size_t)-1 on truncated input.
size_t rt_varint_decode(const uint8_t* buf, size_t len, int64_t* out,
                        size_t cap) {
  size_t n = 0, pos = 0;
  while (pos < len && n < cap) {
    uint64_t x = 0;
    int shift = 0;
    for (;;) {
      if (pos >= len) return static_cast<size_t>(-1);
      uint8_t b = buf[pos++];
      x |= static_cast<uint64_t>(b & 0x7F) << shift;
      if (!(b & 0x80)) break;
      shift += 7;
      if (shift >= 64) return static_cast<size_t>(-1);
    }
    out[n++] = static_cast<int64_t>(x);
  }
  return n;
}

}  // extern "C"
