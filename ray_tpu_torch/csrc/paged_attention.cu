// Paged attention for Hopper (sm_90a): attention of a K-token query window
// through per-slot page tables, reading the KV page pools in place.
//
// Replaces ray_tpu/ops/paged_attention.py::_paged_kernel (the Pallas TPU
// kernel launched by _paged_attention_pallas). It computes what that kernel
// computes; it is not a block-by-block copy of it.
//
// What bounds it on this card: the bytes of the live pages. A decode step
// reads ceil((length + K) / T) pages of k and v per (slot, kv-head) and does
// about 4 * G * K * D flops per key read (G = query heads per kv head), far
// below the ~295 flops per byte where an H100 stops being memory-bound. So
// the design reads each live page once per block from device memory into
// shared memory and never touches a page past the slot's cursor.
//
// Design (first, simple version):
//   * one thread block per (slot, kv-head, tile of kWarps query rows); one
//     warp per query row. Row r = i * G + g is query token i of head
//     h = kv_head * G + g, at logical position lengths[s] + i.
//   * the block reads its own lengths[s] and table row, walks the slot's
//     pages in ascending table order, stages the [T, D] k and v rows of its
//     kv head in shared memory (as float32), then each warp does float32
//     scores, the -1e30 mask and the online-softmax update for its row.
//   * the page rows move in 16-byte vectors, and the next page's vectors
//     are loaded into registers while the warps compute on the current
//     one, so a block waits on one memory latency per page at most, not on
//     one per element.
//   * a row's arithmetic depends only on its own position: the lane split
//     of D, the butterfly reduction, the page order and the per-page update
//     are the same whatever K is and wherever the row sits in its tile. Pages
//     past a row's own position are fully masked and add exact zeros
//     (exp(-1e30 - m) == 0.0f, alpha == 1.0f), so row i of a K-window equals
//     a K=1 call at lengths[s] + i bit for bit.
//   * cp.async/TMA staging, tensor-core products and split-K over pages are
//     left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // not -inf: masked keys add exact zeros
constexpr int kWarps = 8;          // query rows per block, one warp each
constexpr int kThreads = kWarps * 32;
constexpr int kMaxVecs = 4;        // 16-byte vectors per thread per tensor

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
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
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// DPL: head-dim elements per lane (lane handles d = j * 32 + lane).
template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q,           // [S, K, H, D]
                       const T* __restrict__ k_pool,      // [N, Tp, Hkv, D]
                       const T* __restrict__ v_pool,      // [N, Tp, Hkv, D]
                       const int* __restrict__ tables,    // [S, P]
                       const int* __restrict__ lengths,   // [S]
                       T* __restrict__ out,               // [S, K, H, D]
                       int K, int H, int Hkv, int D, int N, int Tp, int P,
                       float sm_scale) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                 // [Tp, D] k rows of this page and head
  float* vs = smem + Tp * D;        // [Tp, D] v rows
  float* sc = smem + 2 * Tp * D;    // [kWarps, Tp] scores of each row

  const int s = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = H / Hkv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.z * kWarps + warp;
  const bool live = row < K * G;    // warp-uniform
  const int i = live ? row / G : 0;
  const int h = kvh * G + (live ? row % G : 0);

  const int length = lengths[s];
  const int row_pos = length + i;
  int n_pages = (length + K + Tp - 1) / Tp;  // block-uniform trip count
  if (n_pages > P) n_pages = P;

  float qr[DPL];
  float acc[DPL];
  const T* qrow = q + ((static_cast<size_t>(s) * K + i) * H + h) * D;
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    const int d = j * 32 + lane;
    qr[j] = (live && d < D) ? to_f32(qrow[d]) : 0.f;
    acc[j] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;
  float* my_sc = sc + warp * Tp;
  const size_t tok_stride = static_cast<size_t>(Hkv) * D;  // tokens of a page
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte vector
  uint4 kreg[kMaxVecs];
  uint4 vreg[kMaxVecs];
  auto load_page = [&](int p) {
    int pid = tables[s * P + p];
    pid = min(max(pid, 0), N - 1);  // clamp as XLA's gather does
    const size_t base = static_cast<size_t>(pid) * Tp * tok_stride +
                        static_cast<size_t>(kvh) * D;
#pragma unroll
    for (int r = 0; r < kMaxVecs; ++r) {
      const int e = (r * kThreads + threadIdx.x) * VEC;
      if (e < Tp * D) {
        const int t = e / D;
        const size_t off = base + t * tok_stride + (e - t * D);
        kreg[r] = *reinterpret_cast<const uint4*>(k_pool + off);
        vreg[r] = *reinterpret_cast<const uint4*>(v_pool + off);
      }
    }
  };
  if (n_pages > 0) load_page(0);

  for (int p = 0; p < n_pages; ++p) {
    __syncthreads();  // every warp is done with the previous page's tiles
#pragma unroll
    for (int r = 0; r < kMaxVecs; ++r) {
      const int e = (r * kThreads + threadIdx.x) * VEC;
      if (e < Tp * D) {
        unpack(ks + e, kreg[r], T());
        unpack(vs + e, vreg[r], T());
      }
    }
    __syncthreads();
    if (p + 1 < n_pages) load_page(p + 1);  // in flight during the compute
    if (!live) continue;

    float mx = m;
    // the keys' reductions are independent chains: unrolling lets them
    // overlap without changing any row's arithmetic
#pragma unroll 4
    for (int t = 0; t < Tp; ++t) {
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        const int d = j * 32 + lane;
        if (d < D) part += qr[j] * ks[t * D + d];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      // every lane holds the same sum: the butterfly adds the same pairs
      const float sv = (p * Tp + t <= row_pos) ? part * sm_scale : kNegInf;
      if (lane == 0) my_sc[t] = sv;
      mx = fmaxf(mx, sv);
    }
    __syncwarp();
    const float alpha = expf(m - mx);
    float lsum = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[j] *= alpha;
    for (int t = 0; t < Tp; ++t) {
      const float pr = expf(my_sc[t] - mx);
      lsum += pr;
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        const int d = j * 32 + lane;
        if (d < D) acc[j] += pr * vs[t * D + d];
      }
    }
    __syncwarp();  // my_sc is rewritten by the next page
    l = l * alpha + lsum;
    m = mx;
  }

  if (!live) return;
  if (l == 0.f) l = 1.f;  // a fully masked row gives 0, not NaN
  T* orow = out + ((static_cast<size_t>(s) * K + i) * H + h) * D;
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    const int d = j * 32 + lane;
    if (d < D) store(&orow[d], acc[j] / l);
  }
}

template <typename T, int DPL>
cudaError_t launch_dpl(const void* q, const void* k_pool, const void* v_pool,
                       const void* tables, const void* lengths, void* out,
                       int S, int K, int H, int Hkv, int D, int N, int Tp,
                       int P, float sm_scale, cudaStream_t stream) {
  const size_t smem = (2 * static_cast<size_t>(Tp) * D + kWarps * Tp) *
                      sizeof(float);
  if (D % (16 / sizeof(T)) != 0 ||
      Tp * D > kMaxVecs * kThreads * static_cast<int>(16 / sizeof(T)))
    return cudaErrorInvalidValue;  // the wrapper checks these first
  auto kernel = paged_attention_kernel<T, DPL>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int rows = K * (H / Hkv);
  dim3 grid(S, Hkv, (rows + kWarps - 1) / kWarps);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<T*>(out), K, H, Hkv, D,
      N, Tp, P, sm_scale);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* tables, const void* lengths, void* out, int S, int K,
           int H, int Hkv, int D, int N, int Tp, int P, float sm_scale,
           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D <= 32)
    err = launch_dpl<T, 1>(q, k_pool, v_pool, tables, lengths, out, S, K, H,
                           Hkv, D, N, Tp, P, sm_scale, st);
  else if (D <= 64)
    err = launch_dpl<T, 2>(q, k_pool, v_pool, tables, lengths, out, S, K, H,
                           Hkv, D, N, Tp, P, sm_scale, st);
  else if (D <= 128)
    err = launch_dpl<T, 4>(q, k_pool, v_pool, tables, lengths, out, S, K, H,
                           Hkv, D, N, Tp, P, sm_scale, st);
  else if (D <= 256)
    err = launch_dpl<T, 8>(q, k_pool, v_pool, tables, lengths, out, S, K, H,
                           Hkv, D, N, Tp, P, sm_scale, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // namespace

// Plain C entry points, one per dtype, loaded with ctypes. Each returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int paged_attention_f32(const void* q, const void* k_pool,
                                   const void* v_pool, const void* tables,
                                   const void* lengths, void* out, int S,
                                   int K, int H, int Hkv, int D, int N,
                                   int Tp, int P, float sm_scale,
                                   void* stream) {
  return launch<float>(q, k_pool, v_pool, tables, lengths, out, S, K, H, Hkv,
                       D, N, Tp, P, sm_scale, stream);
}

extern "C" int paged_attention_bf16(const void* q, const void* k_pool,
                                    const void* v_pool, const void* tables,
                                    const void* lengths, void* out, int S,
                                    int K, int H, int Hkv, int D, int N,
                                    int Tp, int P, float sm_scale,
                                    void* stream) {
  return launch<__nv_bfloat16>(q, k_pool, v_pool, tables, lengths, out, S, K,
                               H, Hkv, D, N, Tp, P, sm_scale, stream);
}

extern "C" const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
