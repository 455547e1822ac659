// Flash attention for Hopper (sm_90a): the forward (K1), dQ (K2) and dK/dV
// (K3) kernels of training.
//
// Replaces, in ray_tpu/ops/flash_attention.py, the three Pallas TPU kernels
//   K1 _fwd_kernel (launched by _flash_fwd),
//   K2 _dq_kernel and K3 _dkv_kernel (both launched by _flash_bwd).
// They compute what those kernels compute; the tiling is this card's, not a
// copy of the Pallas blocks.
//
// Layouts: q, dO, O, dQ are [B, Sq, H, D]; k, v, dK, dV are [B, Sk, Hkv, D];
// lse and delta are [B, H, Sq] float32. Query head h reads kv head
// h / (H / Hkv); no kv head is repeated in memory.
//
// Two designs share this file.
//
// bf16 K1, K2 and K3 at D = 64 and 128 (the train path): tensor cores.
//   What bounds them: at gpt2_small shapes the card's least time for K1 is
//   set by its bytes (q, k, v, O once each) and for K2 and K3 by their
//   operations, all within 30% of each other. Each block reads every key
//   row from L2 for 2 * 2 * 64 * D flops or more, so a kernel that streams
//   its tiles well is held by the rate at which it starts tensor-core
//   products and, beside them, the float32 exp of the softmax. So:
//   * products are mma.sync.m16n8k16 (bf16 in, float32 accumulators), the
//     fragments loaded from shared memory by ldmatrix (.trans for the
//     operand whose rows run along the product's depth: V in P.V, K in
//     dQ += dS.K, dO and Q in dV += P^T.dO and dK += dS^T.Q);
//   * tiles stay bf16 in shared memory, rows padded by 16 bytes so the
//     eight row addresses of one ldmatrix fall in eight different banks;
//     they arrive by cp.async 16-byte copies in a ring of two stages, so
//     tile j + 1 is in flight while tile j is multiplied;
//   * 4 warps a block, each owning 16 rows (query rows in K1 and K2, key
//     rows in K3). A row's scores stay in the accumulator fragments of the
//     quad of threads that hold it: its max and sum are two shuffles, and
//     P (dS) goes from two accumulator fragments to one A fragment of the
//     next product in registers, rounded to bf16 as the JAX kernels cast it;
//   * K1 keeps Q's fragments in registers over the whole key loop; K2 reads
//     Q's and dO's from shared memory at each key tile, so dQ (64 registers
//     a thread at D = 128) and S, dP over a 64-key tile (64 more) fit; K3
//     reads K's and V's from shared memory and, at D = 128, takes 32-query
//     inner tiles so dK, dV (128 registers a thread) and S^T, dP^T fit in
//     255;
//   * the masking rule of the FMA kernels below is kept: scale, then mask
//     to -1e30, expf without fast math, so a masked P is exactly 0; only
//     tiles that hold a masked pair test keys, future tiles are skipped,
//     and in K3 a warp whose keys no query of a causal tile sees skips its
//     products (they would add exact zeros).
//   Wider per-warp tiles (two 16-row groups, or 128-key steps) save
//   shared-memory reads but need more registers, so fewer warps fit on an
//   SM; tried on the card, they were no faster. The sums run in another
//   order than the plain versions', so dQ, dK and dV may round to the
//   neighbouring bf16 value; K2 and K3 stay deterministic (no atomics, a
//   fixed loop order).
//
// float32 everywhere, and bf16 at D = 16 (which nothing on the card runs):
// float32 FMA. Tensor cores would mean TF32 for float32 and break its
// semantics. What bounds them: operations. At training shapes a block does
// about 2 * 64 * D flops for every key row it reads, far above the ~20
// flops per byte where float32 arithmetic off the tensor cores stops being
// memory-bound. So the design keeps every tile it multiplies in shared
// memory as float32 and gives each thread a 4 x 4 register tile of scores
// and a 4 x (D / 16) register tile of its output, so that each value read
// from shared memory feeds four multiply-adds. The float32 K2 equals its
// plain version bit for bit.
//
// FMA design (first, simple version):
//   * 256 threads as a 16 x 16 grid (ty, tx); tiles of 64 query rows and 64
//     key rows. Thread (ty, tx) owns score rows ty + 16 i and columns
//     tx + 16 j (i, j < 4), and output columns tx + 16 c (c < D / 16).
//     The 16 threads of a row are one half-warp, so a row's max and sum are
//     butterfly shuffles inside it, and every one of them holds the same
//     result bit for bit.
//   * tiles are read from device memory in 16-byte vectors and widened to
//     float32 in shared memory, rows padded by 4 floats so the 16-byte
//     shared loads of eight neighbouring rows hit distinct banks.
//   * all arithmetic is float32 FMA (no TF32, no fast math). Scores are
//     scaled, then masked to -1e30, so exp(-1e30 - m) is exactly 0 for
//     every masked key; future key tiles of a causal row are never visited.
//   * the casts of the JAX kernels are kept: P is rounded to v's dtype
//     before P.V (K1), P and dS to the dtype of the operand they multiply
//     (K2, K3). bf16 x bf16 products are exact in float32, so the products
//     equal those of a bf16 tensor-core product with float32 accumulation.
//   * K3 owns one key tile of one kv head and loops over the group's query
//     heads and the query tiles: dK and dV sum in registers and are written
//     once, with no atomics, so two runs give the same bits.
//   * the tensor-core kernels above replace it for bf16 K1, K2 and K3 at
//     D = 64 and 128; wgmma and TMA are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;  // not -inf: masked keys add exact zeros
constexpr int kTile = 64;          // query rows and key rows per tile
constexpr int kThreads = 256;      // 16 x 16
constexpr int kPad = 4;            // floats of padding per shared row
constexpr int kLdP = kTile + kPad; // row stride of the P / dS tiles

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}
// x rounded to T and widened back: the cast the JAX kernels make before a
// product in the inputs' dtype
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}

// a 16-byte vector of T into float32 shared memory (16-byte aligned)
__device__ __forceinline__ void unpack(float* dst, uint4 v, float) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(&v);
}
__device__ __forceinline__ void unpack(float* dst, uint4 v, __nv_bfloat16) {
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&v);
  float2 f[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) f[k] = __bfloat1622float2(b[k]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(f[0].x, f[0].y, f[1].x,
                                                  f[1].y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(f[2].x, f[2].y, f[3].x,
                                                  f[3].y);
}

// Rows [r0, r0 + 64) of head `head` of a [B, S, NH, D] tensor into a
// [64][D + kPad] float32 tile; rows at or past S are zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int b, int head, int r0, int S,
                                          int NH) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int kRowVecs = D / VEC;
  constexpr int ld = D + kPad;
  for (int e = threadIdx.x; e < kTile * kRowVecs; e += kThreads) {
    const int r = e / kRowVecs;
    const int c = (e - r * kRowVecs) * VEC;
    const int row = r0 + r;
    float* out = dst + r * ld + c;
    if (row < S) {
      const T* p =
          src + ((static_cast<size_t>(b) * S + row) * NH + head) * D + c;
      unpack(out, *reinterpret_cast<const uint4*>(p), T());
    } else {
#pragma unroll
      for (int u = 0; u < VEC; u += 4)
        *reinterpret_cast<float4*>(out + u) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// Rows [r0, r0 + 64) of a [B, H, S] float32 row statistic; 0 past S.
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ src,
                                          int bh, int r0, int S) {
  if (threadIdx.x < kTile) {
    const int row = r0 + threadIdx.x;
    dst[threadIdx.x] =
        row < S ? src[static_cast<size_t>(bh) * S + row] : 0.f;
  }
}

// s[i][j] = A[ty + 16 i] . Bm[tx + 16 j] over D; A, Bm are [64][D + kPad].
template <int D>
__device__ __forceinline__ void dot_tile(float (&s)[4][4],
                                         const float* A, const float* Bm,
                                         int ty, int tx) {
  constexpr int ld = D + kPad;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * ld + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(Bm + (tx + 16 * j) * ld + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float t = s[i][j];
        t = fmaf(a[i].x, b[j].x, t);
        t = fmaf(a[i].y, b[j].y, t);
        t = fmaf(a[i].z, b[j].z, t);
        t = fmaf(a[i].w, b[j].w, t);
        s[i][j] = t;
      }
  }
}

// acc[i][c] += sum_r P[ty + 16 i][r] * X[r][tx + 16 c] over the 64 rows r;
// P is [64][kLdP], X is [64][D + kPad].
template <int D>
__device__ __forceinline__ void acc_tile(float (&acc)[4][D / 16],
                                         const float* P, const float* X,
                                         int ty, int tx) {
  constexpr int ld = D + kPad;
  constexpr int DC = D / 16;
#pragma unroll 2
  for (int r = 0; r < kTile; r += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = *reinterpret_cast<const float4*>(P + (ty + 16 * i) * kLdP + r);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float x = X[(r + u) * ld + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pv = u == 0 ? p[i].x : u == 1 ? p[i].y
                         : u == 2 ? p[i].z : p[i].w;
          acc[i][c] = fmaf(pv, x, acc[i][c]);
        }
      }
    }
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ bool visible(int qrow, int key, int Sq, int Sk,
                                        int causal) {
  return qrow < Sq && key < Sk && (!causal || qrow >= key);
}

// ------------------------------------------------------------------ K1

// grid (query tiles, H, B); the last query tiles, which walk the most keys
// under a causal mask, are started first
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int H, int Hkv,
                 float sm_scale, int causal) {
  constexpr int ld = D + kPad;
  constexpr int DC = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                  // [64][ld]
  float* ks = qs + kTile * ld;       // [64][ld]
  float* vs = ks + kTile * ld;       // [64][ld]
  float* ps = vs + kTile * ld;       // [64][kLdP]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;

  load_tile<T, D>(qs, q, b, h, q0, Sq, H);
  float acc[4][DC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }
  const int k_end = causal ? min(Sk, q0 + kTile) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // every thread is done with the previous tiles
    load_tile<T, D>(ks, k, b, kvh, k0, Sk, Hkv);
    load_tile<T, D>(vs, v, b, kvh, k0, Sk, Hkv);
    __syncthreads();
    float s[4][4];
    dot_tile<D>(s, qs, ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        s[i][j] = (key < Sk && (!causal || row >= key)) ? s[i][j] * sm_scale
                                                        : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        ps[(ty + 16 * i) * kLdP + tx + 16 * j] = round_to(p, T());
      }
      l[i] = alpha * l[i] + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // the P tile is whole
    acc_tile<D>(acc, ps, vs, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float ls = l[i] == 0.f ? 1.f : l[i];  // a masked row gives 0
    T* orow = o + ((static_cast<size_t>(b) * Sq + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) store(&orow[tx + 16 * c], acc[i][c] / ls);
    if (tx == 0)
      lse[(static_cast<size_t>(b) * H + h) * Sq + row] = m[i] + logf(ls);
  }
}

// ------------------------------------------------------------------ K2

// grid (query tiles, H, B)
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int Sq,
                int Sk, int H, int Hkv, float sm_scale, int causal) {
  constexpr int ld = D + kPad;
  constexpr int DC = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                  // [64][ld]
  float* dos = qs + kTile * ld;      // [64][ld]
  float* ks = dos + kTile * ld;      // [64][ld]
  float* vs = ks + kTile * ld;       // [64][ld]
  float* dss = vs + kTile * ld;      // [64][kLdP]
  float* lse_s = dss + kTile * kLdP; // [64]
  float* delta_s = lse_s + kTile;    // [64]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;

  load_tile<T, D>(qs, q, b, h, q0, Sq, H);
  load_tile<T, D>(dos, dout, b, h, q0, Sq, H);
  load_rows(lse_s, lse, b * H + h, q0, Sq);
  load_rows(delta_s, delta, b * H + h, q0, Sq);
  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  const int k_end = causal ? min(Sk, q0 + kTile) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();
    load_tile<T, D>(ks, k, b, kvh, k0, Sk, Hkv);
    load_tile<T, D>(vs, v, b, kvh, k0, Sk, Hkv);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_tile<D>(s, qs, ks, ty, tx);
    dot_tile<D>(dp, dos, vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        const float sv = visible(q0 + r, key, Sq, Sk, causal)
                             ? s[i][j] * sm_scale : kNegInf;
        const float p = expf(sv - lse_s[r]);  // masked -> exactly 0
        const float ds = p * (dp[i][j] - delta_s[r]) * sm_scale;
        dss[r * kLdP + tx + 16 * j] = round_to(ds, T());
      }
    }
    __syncthreads();  // the dS tile is whole
    acc_tile<D>(acc, dss, ks, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    T* drow = dq + ((static_cast<size_t>(b) * Sq + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) store(&drow[tx + 16 * c], acc[i][c]);
  }
}

// ------------------------------------------------------------------ K3

// grid (key tiles, Hkv, B). The block's score tile is transposed: rows are
// keys (ty + 16 i), columns queries (tx + 16 j).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int Sq, int Sk, int H, int Hkv,
                 float sm_scale, int causal) {
  constexpr int ld = D + kPad;
  constexpr int DC = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                  // [64][ld]
  float* vs = ks + kTile * ld;       // [64][ld]
  float* qs = vs + kTile * ld;       // [64][ld]
  float* dos = qs + kTile * ld;      // [64][ld]
  float* pts = dos + kTile * ld;     // [64][kLdP]  P^T
  float* dsts = pts + kTile * kLdP;  // [64][kLdP]  dS^T
  float* lse_s = dsts + kTile * kLdP;
  float* delta_s = lse_s + kTile;

  const int k0 = blockIdx.x * kTile;  // the first key tiles see most queries
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / Hkv;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;

  load_tile<T, D>(ks, k, b, kvh, k0, Sk, Hkv);
  load_tile<T, D>(vs, v, b, kvh, k0, Sk, Hkv);
  float dk_acc[4][DC], dv_acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk_acc[i][c] = 0.f;
      dv_acc[i][c] = 0.f;
    }

  // under a causal mask, query tiles before this key tile see none of it
  const int q_begin = causal ? (k0 / kTile) * kTile : 0;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    for (int q0 = q_begin; q0 < Sq; q0 += kTile) {
      __syncthreads();
      load_tile<T, D>(qs, q, b, h, q0, Sq, H);
      load_tile<T, D>(dos, dout, b, h, q0, Sq, H);
      load_rows(lse_s, lse, b * H + h, q0, Sq);
      load_rows(delta_s, delta, b * H + h, q0, Sq);
      __syncthreads();
      float st[4][4], dpt[4][4];
      dot_tile<D>(st, ks, qs, ty, tx);
      dot_tile<D>(dpt, vs, dos, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const float sv = visible(q0 + c, k0 + r, Sq, Sk, causal)
                               ? st[i][j] * sm_scale : kNegInf;
          const float p = expf(sv - lse_s[c]);  // masked -> exactly 0
          const float ds = p * (dpt[i][j] - delta_s[c]) * sm_scale;
          pts[r * kLdP + c] = round_to(p, T());
          dsts[r * kLdP + c] = round_to(ds, T());
        }
      }
      __syncthreads();  // the P^T and dS^T tiles are whole
      acc_tile<D>(dv_acc, pts, dos, ty, tx);
      acc_tile<D>(dk_acc, dsts, qs, ty, tx);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= Sk) continue;
    const size_t off = ((static_cast<size_t>(b) * Sk + key) * Hkv + kvh) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      store(&dk[off + tx + 16 * c], dk_acc[i][c]);
      store(&dv[off + tx + 16 * c], dv_acc[i][c]);
    }
  }
}

// -------------------------------------- tensor cores: bf16 K1, K2 and K3

using bf16 = __nv_bfloat16;
constexpr int kMmaThreads = 128;  // 4 warps, 16 rows each
constexpr int kPadH = 8;          // bf16 of padding per shared row (16 B)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; zeros where !in (the source is not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(in ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(in ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr) : "memory");
}

// c += a . b: a 16 x 16 (row), b 16 x 8 (col), bf16 in, float32 sums
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Accumulator fragments c[2i], c[2i + 1] (16 rows x 16 columns) as the A
// fragment of a product over those 16 columns, rounded to bf16.
__device__ __forceinline__ void to_a_frag(uint32_t (&a)[4],
                                          const float (&lo)[4],
                                          const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// Rows [r0, r0 + ROWS) of head `head` of a [B, S, NH, D] bf16 tensor into
// a [ROWS][D + kPadH] shared tile by cp.async; rows at or past S are zeros.
template <int D, int ROWS>
__device__ __forceinline__ void cp_tile(bf16* dst,
                                        const bf16* __restrict__ src, int b,
                                        int head, int r0, int S, int NH) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  constexpr int ld = D + kPadH;
  static_assert(ROWS * kChunks % kMmaThreads == 0, "tile / threads");
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / kMmaThreads; ++i) {
    const int e = threadIdx.x + i * kMmaThreads;
    const int r = e / kChunks;
    const int c = (e % kChunks) * 8;
    const int row = r0 + r;
    const bool in = row < S;
    const bf16* p =
        src + ((static_cast<size_t>(b) * S + (in ? row : 0)) * NH + head) * D
        + c;
    cp_async16(smem_addr(dst + r * ld + c), p, in);
  }
}

// Rows [r0, r0 + ROWS) of a [B, H, S] float32 row statistic; 0 past S.
template <int ROWS>
__device__ __forceinline__ void cp_rows(float* dst,
                                        const float* __restrict__ src, int bh,
                                        int r0, int S) {
  if (threadIdx.x < ROWS) {
    const int row = r0 + threadIdx.x;
    const bool in = row < S;
    cp_async4(smem_addr(dst + threadIdx.x),
              src + static_cast<size_t>(bh) * S + (in ? row : 0), in);
  }
}

// Per-lane element offsets into a [rows][ld] bf16 tile for ldmatrix.x4:
//  * a_off: the A fragment of rows 0-15, columns 0-15 (also the B fragments,
//    .trans, of two 8-column n-tiles over rows 0-15 as the product's depth);
//  * b_off: the B fragments, non-trans, of two n-tiles of 8 rows (rows 0-7
//    and 8-15) over columns 0-15 as the depth.
__device__ __forceinline__ int a_off(int lane, int ld) {
  return (lane & 15) * ld + (lane >> 4) * 8;
}
__device__ __forceinline__ int b_off(int lane, int ld) {
  return ((lane & 7) + (lane >> 4) * 8) * ld + ((lane >> 3) & 1) * 8;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Rows [0, 16) of a warp's [16][ld] bf16 shared staging tile to rows
// r0 + [0, 16) of head `head` of a [B, S, NH, D] tensor, 16 bytes a store.
template <int D>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst,
                                           const bf16* stage, int b,
                                           int head, int r0, int S, int NH,
                                           int lane) {
  constexpr int kChunks = D / 8;
  constexpr int ld = D + kPadH;
#pragma unroll
  for (int e = lane; e < 16 * kChunks; e += 32) {
    const int r = e / kChunks;
    const int c = (e % kChunks) * 8;
    const int row = r0 + r;
    if (row < S)
      *reinterpret_cast<uint4*>(
          dst + ((static_cast<size_t>(b) * S + row) * NH + head) * D + c) =
          *reinterpret_cast<const uint4*>(stage + r * ld + c);
  }
}

// K1 on tensor cores. grid (query tiles, H, B), the last query tiles
// first; warp w owns query rows q0 + 16 w + [0, 16). A lane holds rows
// g = lane / 4 and g + 8 of its warp's slice, columns 2 (lane % 4) + {0, 1}
// of each 8-column n-tile.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int Sq, int Sk, int H, int Hkv,
                     float sm_scale, int causal) {
  constexpr int ld = D + kPadH;
  constexpr int KD = D / 16;      // k-steps over D
  constexpr int DN = D / 8;       // n-tiles over D
  constexpr int KN = kTile / 8;   // n-tiles over a key tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [64][ld]; O at the end
  bf16* ks = qs + kTile * ld;                    // [2][64][ld]
  bf16* vs = ks + 2 * kTile * ld;                // [2][64][ld]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row_lo = q0 + 16 * warp + g;  // and row_lo + 8
  const int k_end = causal ? min(Sk, q0 + kTile) : Sk;
  const int n_tiles = (k_end + kTile - 1) / kTile;

  cp_tile<D, kTile>(qs, q, b, h, q0, Sq, H);
  cp_async_commit();
  cp_tile<D, kTile>(ks, k, b, kvh, 0, Sk, Hkv);
  cp_tile<D, kTile>(vs, v, b, kvh, 0, Sk, Hkv);
  cp_async_commit();

  // Q's fragments stay in registers over the whole key loop
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[KD][4];
  {
    const uint32_t qs_a = smem_addr(qs + 16 * warp * ld + a_off(lane, ld));
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) ldsm_x4(qf[kd], qs_a + kd * 32);
  }
  float acc[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kTile;
    if (j + 1 < n_tiles) {  // tile j + 1 flies while tile j is multiplied
      const int st = (j + 1) & 1;
      cp_tile<D, kTile>(ks + st * kTile * ld, k, b, kvh, k0 + kTile, Sk, Hkv);
      cp_tile<D, kTile>(vs + st * kTile * ld, v, b, kvh, k0 + kTile, Sk, Hkv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t ks_b =
        smem_addr(ks + (j & 1) * kTile * ld + b_off(lane, ld));
    const uint32_t vs_a =
        smem_addr(vs + (j & 1) * kTile * ld + a_off(lane, ld));

    float s[KN][4];
#pragma unroll
    for (int n = 0; n < KN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
#pragma unroll
      for (int jj = 0; jj < KN / 2; ++jj) {
        uint32_t kb[4];
        ldsm_x4(kb, ks_b + (16 * jj * ld + 16 * kd) * 2);
        mma(s[2 * jj], qf[kd], kb[0], kb[1]);
        mma(s[2 * jj + 1], qf[kd], kb[2], kb[3]);
      }

    // scale, then mask (only the diagonal and the last tile have masked
    // keys); exp(-1e30 - m) is exactly 0 for a masked key
    const bool masked = k0 + kTile > Sk || (causal && k0 + kTile - 1 > q0);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < KN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * sm_scale;
        if (masked) {
          const int key = k0 + 8 * n + 2 * t + (e & 1);
          const int row = row_lo + 8 * (e >> 1);
          if (!(key < Sk && (!causal || row >= key))) x = kNegInf;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      alpha[i] = expf(m[i] - mx[i]);
      m[i] = mx[i];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < KN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e >> 1]);
        rs[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = alpha[i] * l[i] + rs[i];
#pragma unroll
    for (int n = 0; n < DN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];

    // O += bf16(P) . V, P straight from the score fragments
#pragma unroll
    for (int kk = 0; kk < KN / 2; ++kk) {
      uint32_t pa[4];
      to_a_frag(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dd = 0; dd < DN / 2; ++dd) {
        uint32_t vb[4];
        ldsm_x4_t(vb, vs_a + (16 * kk * ld + 16 * dd) * 2);
        mma(acc[2 * dd], pa, vb[0], vb[1]);
        mma(acc[2 * dd + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // stage j & 1 is free for tile j + 2
  }

  // O / l to bf16 through the warp's own rows of the Q tile; a masked row
  // (l == 0) gives 0
  float ls[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float sum = quad_sum(l[i]);
    ls[i] = sum == 0.f ? 1.f : sum;
  }
  bf16* stage = qs + 16 * warp * ld;
#pragma unroll
  for (int n = 0; n < DN; ++n) {
    const int c = 8 * n + 2 * t;
    *reinterpret_cast<uint32_t*>(stage + g * ld + c) =
        pack_bf16(acc[n][0] / ls[0], acc[n][1] / ls[0]);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * ld + c) =
        pack_bf16(acc[n][2] / ls[1], acc[n][3] / ls[1]);
  }
  __syncwarp();
  store_rows<D>(o, stage, b, h, q0 + 16 * warp, Sq, H, lane);
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row_lo + 8 * i;
      if (row < Sq)
        lse[(static_cast<size_t>(b) * H + h) * Sq + row] = m[i] + logf(ls[i]);
    }
  }
}

// K2 on tensor cores. K1's block: grid (query tiles, H, B), the last query
// tiles first; warp w owns query rows q0 + 16 w + [0, 16), and K, V come
// in a two-stage cp.async ring. Per key tile: S = Q.K^T and dP = dO.V^T,
// P = exp(S scale - lse) (masked to exactly 0), dS = P (dP - delta) scale,
// dQ += bf16(dS).K with dS fed from the accumulators. Q's and dO's
// fragments are read from shared memory at each tile: held in registers
// beside dQ, S and dP they would not fit in 255 at D = 128.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int Sq, int Sk, int H, int Hkv, float sm_scale,
                    int causal) {
  constexpr int ld = D + kPadH;
  constexpr int KD = D / 16;      // k-steps over D
  constexpr int DN = D / 8;       // n-tiles over D
  constexpr int KN = kTile / 8;   // n-tiles over a key tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [64][ld]; dQ at the end
  bf16* dos = qs + kTile * ld;                   // [64][ld]
  bf16* ks = dos + kTile * ld;                   // [2][64][ld]
  bf16* vs = ks + 2 * kTile * ld;                // [2][64][ld]
  float* lse_s = reinterpret_cast<float*>(vs + 2 * kTile * ld);  // [64]
  float* delta_s = lse_s + kTile;                                // [64]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row_lo = q0 + 16 * warp + g;  // and row_lo + 8
  const int k_end = causal ? min(Sk, q0 + kTile) : Sk;
  const int n_tiles = (k_end + kTile - 1) / kTile;

  cp_tile<D, kTile>(qs, q, b, h, q0, Sq, H);
  cp_tile<D, kTile>(dos, dout, b, h, q0, Sq, H);
  cp_rows<kTile>(lse_s, lse, b * H + h, q0, Sq);
  cp_rows<kTile>(delta_s, delta, b * H + h, q0, Sq);
  cp_tile<D, kTile>(ks, k, b, kvh, 0, Sk, Hkv);
  cp_tile<D, kTile>(vs, v, b, kvh, 0, Sk, Hkv);
  cp_async_commit();

  const uint32_t qs_a = smem_addr(qs + 16 * warp * ld + a_off(lane, ld));
  const uint32_t dos_a = smem_addr(dos + 16 * warp * ld + a_off(lane, ld));
  float acc[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kTile;
    if (j + 1 < n_tiles) {  // tile j + 1 flies while tile j is multiplied
      const int st = (j + 1) & 1;
      cp_tile<D, kTile>(ks + st * kTile * ld, k, b, kvh, k0 + kTile, Sk, Hkv);
      cp_tile<D, kTile>(vs + st * kTile * ld, v, b, kvh, k0 + kTile, Sk, Hkv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kst = ks + (j & 1) * kTile * ld;
    const bf16* vst = vs + (j & 1) * kTile * ld;
    const uint32_t ks_b = smem_addr(kst + b_off(lane, ld));
    const uint32_t vs_b = smem_addr(vst + b_off(lane, ld));
    const uint32_t ks_t = smem_addr(kst + a_off(lane, ld));

    // S = Q.K^T and dP = dO.V^T
    float s[KN][4], dp[KN][4];
#pragma unroll
    for (int n = 0; n < KN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = 0.f;
        dp[n][e] = 0.f;
      }
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t qa[4], oa[4];
      ldsm_x4(qa, qs_a + kd * 32);
      ldsm_x4(oa, dos_a + kd * 32);
#pragma unroll
      for (int jj = 0; jj < KN / 2; ++jj) {
        uint32_t kb[4], vb[4];
        ldsm_x4(kb, ks_b + (16 * jj * ld + 16 * kd) * 2);
        mma(s[2 * jj], qa, kb[0], kb[1]);
        mma(s[2 * jj + 1], qa, kb[2], kb[3]);
        ldsm_x4(vb, vs_b + (16 * jj * ld + 16 * kd) * 2);
        mma(dp[2 * jj], oa, vb[0], vb[1]);
        mma(dp[2 * jj + 1], oa, vb[2], vb[3]);
      }
    }

    // P = exp(S scale - lse), masked to exactly 0 (only the diagonal and
    // the last tile have masked keys); dS = P (dP - delta) scale
    const bool masked = k0 + kTile > Sk || (causal && k0 + kTile - 1 > q0);
    float lse_r[2], delta_r[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      lse_r[i] = lse_s[16 * warp + g + 8 * i];
      delta_r[i] = delta_s[16 * warp + g + 8 * i];
    }
#pragma unroll
    for (int n = 0; n < KN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * sm_scale;
        if (masked) {
          const int key = k0 + 8 * n + 2 * t + (e & 1);
          const int row = row_lo + 8 * (e >> 1);
          if (!(key < Sk && (!causal || row >= key))) x = kNegInf;
        }
        const float p = expf(x - lse_r[e >> 1]);
        dp[n][e] = p * (dp[n][e] - delta_r[e >> 1]) * sm_scale;
      }

    // dQ += bf16(dS) . K, dS straight from the dP fragments
#pragma unroll
    for (int kk = 0; kk < KN / 2; ++kk) {
      uint32_t da[4];
      to_a_frag(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int dd = 0; dd < DN / 2; ++dd) {
        uint32_t kb[4];
        ldsm_x4_t(kb, ks_t + (16 * kk * ld + 16 * dd) * 2);
        mma(acc[2 * dd], da, kb[0], kb[1]);
        mma(acc[2 * dd + 1], da, kb[2], kb[3]);
      }
    }
    __syncthreads();  // stage j & 1 is free for tile j + 2
  }

  // dQ to bf16 through the warp's own rows of the Q tile
  bf16* stage = qs + 16 * warp * ld;
#pragma unroll
  for (int n = 0; n < DN; ++n) {
    const int c = 8 * n + 2 * t;
    *reinterpret_cast<uint32_t*>(stage + g * ld + c) =
        pack_bf16(acc[n][0], acc[n][1]);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * ld + c) =
        pack_bf16(acc[n][2], acc[n][3]);
  }
  __syncwarp();
  store_rows<D>(dq, stage, b, h, q0 + 16 * warp, Sq, H, lane);
}

// K3's inner query tile: at D = 128, 32 rows, so that dK and dV (128
// registers a thread) and S^T, dP^T fit in 255 registers
__host__ __device__ constexpr int dkv_query_rows(int D) {
  return D <= 64 ? 64 : 32;
}

// K3 on tensor cores. grid (key tiles, Hkv, B); warp w owns key rows
// k0 + 16 w + [0, 16) and loops, with the whole block, over the group's
// query heads and the query tiles from the causal start. The score tiles
// are transposed: rows are keys, columns queries.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int Sq, int Sk, int H, int Hkv,
                     float sm_scale, int causal) {
  constexpr int ld = D + kPadH;
  constexpr int QT = dkv_query_rows(D);  // query rows per inner tile
  constexpr int KD = D / 16;
  constexpr int DN = D / 8;
  constexpr int QN = QT / 8;             // n-tiles over a query tile
  constexpr int kStage = 2 * QT * ld + 4 * QT;  // bf16 elements a stage
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [64][ld]; dK at the end
  bf16* vs = ks + kTile * ld;                    // [64][ld]; dV at the end
  bf16* stages = vs + kTile * ld;  // [2] x {Q, dO [QT][ld]; lse, delta [QT]}

  const int k0 = blockIdx.x * kTile;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / Hkv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int key_lo = k0 + 16 * warp;  // this warp's first key

  // under a causal mask, query tiles before this key tile see none of it
  const int q_begin = causal ? k0 : 0;
  const int nq = q_begin < Sq ? (Sq - q_begin + QT - 1) / QT : 0;
  const int total = G * nq;  // (query head, query tile) steps, in order

  auto load_step = [&](int it) {
    bf16* st = stages + (it & 1) * kStage;
    const int gi = it / nq;
    const int h = kvh * G + gi;
    const int q0 = q_begin + (it - gi * nq) * QT;
    cp_tile<D, QT>(st, q, b, h, q0, Sq, H);
    cp_tile<D, QT>(st + QT * ld, dout, b, h, q0, Sq, H);
    float* rows = reinterpret_cast<float*>(st + 2 * QT * ld);
    cp_rows<QT>(rows, lse, b * H + h, q0, Sq);
    cp_rows<QT>(rows + QT, delta, b * H + h, q0, Sq);
  };

  cp_tile<D, kTile>(ks, k, b, kvh, k0, Sk, Hkv);
  cp_tile<D, kTile>(vs, v, b, kvh, k0, Sk, Hkv);
  if (total > 0) load_step(0);
  cp_async_commit();

  const uint32_t ks_a = smem_addr(ks + 16 * warp * ld + a_off(lane, ld));
  const uint32_t vs_a = smem_addr(vs + 16 * warp * ld + a_off(lane, ld));
  float dka[DN][4], dva[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dka[n][e] = 0.f;
      dva[n][e] = 0.f;
    }

  for (int it = 0; it < total; ++it) {
    const int q0 = q_begin + (it % nq) * QT;
    if (it + 1 < total) {  // the next step flies while this one multiplies
      load_step(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qs = stages + (it & 1) * kStage;
    const bf16* dos = qs + QT * ld;
    const float* lse_s = reinterpret_cast<const float*>(qs + 2 * QT * ld);
    const float* delta_s = lse_s + QT;
    // a warp whose keys all lie after every query of the tile adds zeros
    if (!causal || key_lo <= q0 + QT - 1) {
      const uint32_t qs_b = smem_addr(qs + b_off(lane, ld));
      const uint32_t dos_b = smem_addr(dos + b_off(lane, ld));
      float s[QN][4], dp[QN][4];
#pragma unroll
      for (int n = 0; n < QN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = 0.f;
          dp[n][e] = 0.f;
        }
      // S^T = K . Q^T and dP^T = V . dO^T
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t ka[4], va[4];
        ldsm_x4(ka, ks_a + kd * 32);
        ldsm_x4(va, vs_a + kd * 32);
#pragma unroll
        for (int jj = 0; jj < QN / 2; ++jj) {
          uint32_t qb[4], ob[4];
          ldsm_x4(qb, qs_b + (16 * jj * ld + 16 * kd) * 2);
          mma(s[2 * jj], ka, qb[0], qb[1]);
          mma(s[2 * jj + 1], ka, qb[2], qb[3]);
          ldsm_x4(ob, dos_b + (16 * jj * ld + 16 * kd) * 2);
          mma(dp[2 * jj], va, ob[0], ob[1]);
          mma(dp[2 * jj + 1], va, ob[2], ob[3]);
        }
      }
      // P^T = exp(S^T scale - lse), masked to exactly 0; dS^T
      const bool masked = q0 + QT > Sq || k0 + kTile > Sk ||
                          (causal && q0 < key_lo + 15);
#pragma unroll
      for (int n = 0; n < QN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * n + 2 * t + (e & 1);  // query in the tile
          float sv = s[n][e] * sm_scale;
          if (masked && !visible(q0 + c, key_lo + g + 8 * (e >> 1), Sq, Sk,
                                 causal))
            sv = kNegInf;
          const float p = expf(sv - lse_s[c]);
          dp[n][e] = p * (dp[n][e] - delta_s[c]) * sm_scale;
          s[n][e] = p;
        }
      // dV += bf16(P^T) . dO and dK += bf16(dS^T) . Q
      const uint32_t qs_t = smem_addr(qs + a_off(lane, ld));
      const uint32_t dos_t = smem_addr(dos + a_off(lane, ld));
#pragma unroll
      for (int kk = 0; kk < QN / 2; ++kk) {
        uint32_t pa[4], da[4];
        to_a_frag(pa, s[2 * kk], s[2 * kk + 1]);
        to_a_frag(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int dd = 0; dd < DN / 2; ++dd) {
          uint32_t ob[4], qb[4];
          ldsm_x4_t(ob, dos_t + (16 * kk * ld + 16 * dd) * 2);
          mma(dva[2 * dd], pa, ob[0], ob[1]);
          mma(dva[2 * dd + 1], pa, ob[2], ob[3]);
          ldsm_x4_t(qb, qs_t + (16 * kk * ld + 16 * dd) * 2);
          mma(dka[2 * dd], da, qb[0], qb[1]);
          mma(dka[2 * dd + 1], da, qb[2], qb[3]);
        }
      }
    }
    __syncthreads();  // stage it & 1 is free for step it + 2
  }
  cp_async_wait<0>();  // with no query tile, K and V may still be landing
  __syncthreads();

  // dK, dV to bf16 through the warp's own rows of the K and V tiles
  bf16* kst = ks + 16 * warp * ld;
  bf16* vst = vs + 16 * warp * ld;
#pragma unroll
  for (int n = 0; n < DN; ++n) {
    const int c = 8 * n + 2 * t;
    *reinterpret_cast<uint32_t*>(kst + g * ld + c) =
        pack_bf16(dka[n][0], dka[n][1]);
    *reinterpret_cast<uint32_t*>(kst + (g + 8) * ld + c) =
        pack_bf16(dka[n][2], dka[n][3]);
    *reinterpret_cast<uint32_t*>(vst + g * ld + c) =
        pack_bf16(dva[n][0], dva[n][1]);
    *reinterpret_cast<uint32_t*>(vst + (g + 8) * ld + c) =
        pack_bf16(dva[n][2], dva[n][3]);
  }
  __syncwarp();
  store_rows<D>(dk, kst, b, kvh, key_lo, Sk, Hkv, lane);
  store_rows<D>(dv, vst, b, kvh, key_lo, Sk, Hkv, lane);
}

template <int D>
constexpr size_t fwd_mma_smem() {
  return 5 * static_cast<size_t>(kTile) * (D + kPadH) * sizeof(bf16);
}
template <int D>
constexpr size_t dq_mma_smem() {  // Q, dO, K and V ring; lse, delta
  return 6 * static_cast<size_t>(kTile) * (D + kPadH) * sizeof(bf16) +
         2 * kTile * sizeof(float);
}
template <int D>
constexpr size_t dkv_mma_smem() {
  constexpr int QT = dkv_query_rows(D);
  return (2 * static_cast<size_t>(kTile) * (D + kPadH) +
          2 * (2 * QT * (D + kPadH) + 4 * QT)) * sizeof(bf16);
}

// bf16 at D = 64 and 128 takes the tensor-core kernels
template <typename T, int D>
constexpr bool kTensorCores = std::is_same<T, bf16>::value && D >= 64;

// ------------------------------------------------------------------ launch

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

constexpr size_t tile_floats(int D) {
  return static_cast<size_t>(kTile) * (D + kPad);
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                void* lse, int B, int Sq, int Sk, int H, int Hkv,
                float sm_scale, int causal, cudaStream_t st) {
  if constexpr (kTensorCores<T, D>) {
    constexpr size_t smem = fwd_mma_smem<D>();
    auto kernel = flash_fwd_mma_kernel<D>;
    cudaError_t err = set_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((Sq + kTile - 1) / kTile, H, B);
    kernel<<<grid, kMmaThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o),
        static_cast<float*>(lse), Sq, Sk, H, Hkv, sm_scale, causal);
  } else {
    const size_t smem = (3 * tile_floats(D) + kTile * kLdP) * sizeof(float);
    auto kernel = flash_fwd_kernel<T, D>;
    cudaError_t err = set_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((Sq + kTile - 1) / kTile, H, B);
    kernel<<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o),
        static_cast<float*>(lse), Sq, Sk, H, Hkv, sm_scale, causal);
  }
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dqp, int B, int Sq,
               int Sk, int H, int Hkv, float sm_scale, int causal,
               cudaStream_t st) {
  dim3 grid((Sq + kTile - 1) / kTile, H, B);
  if constexpr (kTensorCores<T, D>) {
    constexpr size_t smem = dq_mma_smem<D>();
    auto kernel = flash_dq_mma_kernel<D>;
    cudaError_t err = set_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kMmaThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dqp), Sq, Sk, H, Hkv, sm_scale, causal);
  } else {
    const size_t smem =
        (4 * tile_floats(D) + kTile * kLdP + 2 * kTile) * sizeof(float);
    auto kernel = flash_dq_kernel<T, D>;
    cudaError_t err = set_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dqp), Sq, Sk, H, Hkv, sm_scale, causal);
  }
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                void* dkp, void* dvp, int B, int Sq, int Sk, int H, int Hkv,
                float sm_scale, int causal, cudaStream_t st) {
  dim3 grid((Sk + kTile - 1) / kTile, Hkv, B);
  if constexpr (kTensorCores<T, D>) {
    constexpr size_t smem = dkv_mma_smem<D>();
    auto kernel = flash_dkv_mma_kernel<D>;
    cudaError_t err = set_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kMmaThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dkp), static_cast<T*>(dvp), Sq, Sk, H, Hkv, sm_scale,
        causal);
  } else {
    const size_t smem =
        (4 * tile_floats(D) + 2 * kTile * kLdP + 2 * kTile) * sizeof(float);
    auto kernel = flash_dkv_kernel<T, D>;
    cudaError_t err = set_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dkp), static_cast<T*>(dvp), Sq, Sk, H, Hkv,
        sm_scale, causal);
  }
  return cudaGetLastError();
}

bool shape_ok(int B, int Sq, int Sk, int H, int Hkv) {
  return B > 0 && Sq > 0 && Sk > 0 && Hkv > 0 && H % Hkv == 0 &&
         H <= 65535 && B <= 65535;
}

// one switch over the head widths the kernels are built for
#define FLASH_DISPATCH_D(D, CALL)                        \
  switch (D) {                                           \
    case 16: { constexpr int kD = 16; return CALL; }     \
    case 64: { constexpr int kD = 64; return CALL; }     \
    case 128: { constexpr int kD = 128; return CALL; }   \
    default: return cudaErrorInvalidValue;               \
  }

template <typename T>
cudaError_t fwd_any(const void* q, const void* k, const void* v, void* o,
                    void* lse, int B, int Sq, int Sk, int H, int Hkv, int D,
                    float sm_scale, int causal, void* stream) {
  if (!shape_ok(B, Sq, Sk, H, Hkv)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH_D(D, (launch_fwd<T, kD>(q, k, v, o, lse, B, Sq, Sk, H, Hkv,
                                  sm_scale, causal, st)))
}

template <typename T>
cudaError_t dq_any(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dqp, int B, int Sq, int Sk, int H, int Hkv, int D,
                   float sm_scale, int causal, void* stream) {
  if (!shape_ok(B, Sq, Sk, H, Hkv)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH_D(D, (launch_dq<T, kD>(q, k, v, dout, lse, delta, dqp, B, Sq, Sk,
                                 H, Hkv, sm_scale, causal, st)))
}

template <typename T>
cudaError_t dkv_any(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dkp, void* dvp, int B, int Sq, int Sk, int H,
                    int Hkv, int D, float sm_scale, int causal,
                    void* stream) {
  if (!shape_ok(B, Sq, Sk, H, Hkv)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH_D(D, (launch_dkv<T, kD>(q, k, v, dout, lse, delta, dkp, dvp, B,
                                  Sq, Sk, H, Hkv, sm_scale, causal, st)))
}

}  // namespace

// Plain C entry points, one per kernel and dtype, loaded with ctypes. Each
// returns cudaGetLastError() after the launch (0 = launched).
#define FLASH_ENTRIES(SUFFIX, T)                                             \
  extern "C" int flash_fwd_##SUFFIX(const void* q, const void* k,            \
                                    const void* v, void* o, void* lse,       \
                                    int B, int Sq, int Sk, int H, int Hkv,   \
                                    int D, float sm_scale, int causal,       \
                                    void* stream) {                          \
    return static_cast<int>(fwd_any<T>(q, k, v, o, lse, B, Sq, Sk, H, Hkv,   \
                                       D, sm_scale, causal, stream));        \
  }                                                                          \
  extern "C" int flash_dq_##SUFFIX(const void* q, const void* k,             \
                                   const void* v, const void* dout,          \
                                   const void* lse, const void* delta,       \
                                   void* dq, int B, int Sq, int Sk, int H,   \
                                   int Hkv, int D, float sm_scale,           \
                                   int causal, void* stream) {               \
    return static_cast<int>(dq_any<T>(q, k, v, dout, lse, delta, dq, B, Sq,  \
                                      Sk, H, Hkv, D, sm_scale, causal,       \
                                      stream));                              \
  }                                                                          \
  extern "C" int flash_dkv_##SUFFIX(const void* q, const void* k,            \
                                    const void* v, const void* dout,         \
                                    const void* lse, const void* delta,      \
                                    void* dk, void* dv, int B, int Sq,       \
                                    int Sk, int H, int Hkv, int D,           \
                                    float sm_scale, int causal,              \
                                    void* stream) {                          \
    return static_cast<int>(dkv_any<T>(q, k, v, dout, lse, delta, dk, dv, B, \
                                       Sq, Sk, H, Hkv, D, sm_scale, causal,  \
                                       stream));                             \
  }

FLASH_ENTRIES(f32, float)
FLASH_ENTRIES(bf16, __nv_bfloat16)

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
