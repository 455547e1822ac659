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
// What bounds them on this card: operations. At training shapes (S = 1024,
// D = 64 or 128) a block does about 2 * 64 * D flops for every key row it
// reads, far above the ~20 flops per byte where float32 arithmetic off the
// tensor cores stops being memory-bound. So the design keeps every tile it
// multiplies in shared memory as float32 and gives each thread a 4 x 4
// register tile of scores and a 4 x (D / 16) register tile of its output,
// so that each value read from shared memory feeds four multiply-adds.
//
// Design (first, simple version):
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
//   * tensor cores (mma/wgmma), TMA and double-buffered staging are left for
//     later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
  const size_t smem = (3 * tile_floats(D) + kTile * kLdP) * sizeof(float);
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kTile - 1) / kTile, H, B);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), Sq, Sk, H, Hkv, sm_scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dqp, int B, int Sq,
               int Sk, int H, int Hkv, float sm_scale, int causal,
               cudaStream_t st) {
  const size_t smem =
      (4 * tile_floats(D) + kTile * kLdP + 2 * kTile) * sizeof(float);
  auto kernel = flash_dq_kernel<T, D>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kTile - 1) / kTile, H, B);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dqp), Sq, Sk, H, Hkv, sm_scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                void* dkp, void* dvp, int B, int Sq, int Sk, int H, int Hkv,
                float sm_scale, int causal, cudaStream_t st) {
  const size_t smem =
      (4 * tile_floats(D) + 2 * kTile * kLdP + 2 * kTile) * sizeof(float);
  auto kernel = flash_dkv_kernel<T, D>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sk + kTile - 1) / kTile, Hkv, B);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dkp), static_cast<T*>(dvp), Sq, Sk, H, Hkv, sm_scale,
      causal);
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
