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
// below the ~295 flops per byte where an H100 stops being memory-bound. At
// serving sizes those bytes are few (17 MB for 8 slots of llama3_8b at
// lengths up to 2047: 5 us at 3.35 TB/s), so what holds a kernel back is
// latency: how many page loads are in flight at once, how long one block's
// walk over its pages is, and how long the arithmetic of each page takes
// on the few warps a decode step gives each SM. A walk of one slot's 128
// pages by one block, one page after another, takes a few microseconds a
// page; so does a page's scores and P.V in dependent float32 FMA chains.
//
// Design: split over pages.
//   * a slot's page table is cut into fixed splits of kSplitKeys keys
//     (max(1, kSplitKeys / T) pages each; 16 pages of 16 tokens). The split
//     count is ceil(P / pages per split), a function of the table width
//     alone, never of the lengths, which stay on the card.
//   * one block per (slot, kv head, split, tile of kRowTile query rows):
//     512 blocks for 8 slots x 8 kv heads x 8 splits at decode. A block
//     whose split starts past its slot's live pages exits at once; a live
//     one walks at most pages-per-split pages. Row r = i * G + g is query
//     token i of head h = kv_head * G + g, at position lengths[s] + i.
//   * the block's k pages, then its v pages, stream through a ring of page
//     slots by cp.async 16-byte copies, several pages in flight, kept in
//     their own dtype in shared memory (no widening pass).
//   * pass 1 writes the split's scores to shared memory; the softmax of the
//     split is then exact, not online: its row max m, P = exp(s - m) and
//     l = sum P (per lane a sequential chain over keys lane, lane + 32, ...,
//     then a butterfly); pass 2 sums P.V. The block writes (m, l, acc) of
//     each row to a float32 workspace the wrapper allocates, and a second
//     kernel of the same call merges a row's splits in ascending order.
//   * bf16 pools (head widths 32, 64, 128, 256; pages of a multiple of 16
//     tokens), llama3_8b's serve path, under bf16 or float32 q:
//     paged_attention_split_mma_kernel<TQ>. The products run on the tensor
//     cores (mma.sync m16n8k16, float32 sums), so a page's arithmetic is a
//     few dozen instructions a warp: a step is 4 pages, one a warp, two
//     steps in flight; the query tile is always 16 rows (zeros past the
//     call's rows). Under bf16 q, P goes to P.V as bf16 hi + lo parts, so
//     it keeps float32's precision to ~2^-17. Float32 q (a float32 model
//     over a bf16 cache: the TPU kernel widens q and every page to float32,
//     and writes q's dtype) is split once into three bf16 planes in shared
//     memory (hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid),
//     whose sum is x exactly), so S is the sum of three exact products over
//     the unchanged bf16 pages, and P goes to P.V in three parts: the
//     float32 products of the FMA kernel, in another order of sums. What
//     held that pair back on the FMA kernel was not its bytes (the same as
//     the bf16 pair's) but its dependent float32 chains per page.
//   * float32 pools, the other bf16 shapes, bf16 q over a float32 pool (the
//     TPU kernel widens both, and so does this one), and float32 q over a
//     bf16 pool whose tensor-core tile does not fit one block's shared
//     memory: paged_attention_split_kernel, float32 FMA. Every warp has work at decode (K G = 4 rows): a
//     score (row, key) is one quad of lanes, each lane a sequential FMA
//     chain over its eighth of D, summed by two shuffles; P.V gives each
//     thread 4 columns of up to kRowTile / (128 / (D / 4)) rows, a
//     sequential FMA chain over keys. Its ring holds kRing single pages,
//     rows padded so the 16-byte reads of two neighbouring rows fall in
//     distinct banks.
//
// Row i of a K-token window equals a K=1 call at lengths[s] + i bit for
// bit: a row's arithmetic depends only on its own position. The split
// boundaries are fixed pages; a (row, key) score or a (row, column) sum is
// the same chain whichever thread holds it and wherever the row sits in its
// tile (a tensor-core product's element depends on its own row of the
// tile alone); keys past the row's position, in pages a block walks
// because of the window's later rows, score -1e30 and add exact zeros at
// the end of each chain (exp(-1e30 - m) == 0.0f); and the merge takes
// exactly the splits up to the one that holds the row's own position, a
// function of that position alone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;  // not -inf: masked keys add exact zeros
constexpr int kThreads = 128;      // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRowTile = 16;       // query rows per block
constexpr int kSplitKeys = 256;    // keys per split (whole pages)
constexpr int kRing = 8;           // page slots in the shared-memory ring
constexpr int kPairBatch = 4;      // score pairs a quad of lanes runs at once
constexpr int kMaxSmem = 232448;   // bytes of shared memory a block can use

__host__ __device__ constexpr int pages_per_split(int Tp) {
  return Tp >= kSplitKeys ? 1 : kSplitKeys / Tp;
}

// bytes of one page row in shared memory: D elements, padded so the row
// stride is 64 bytes past a multiple of 128 (16 banks apart)
__host__ __device__ constexpr int row_bytes(int D, int elem) {
  return D * elem + ((64 - (D * elem) % 128) + 128) % 128;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes from global to shared memory; zeros where !in (the source is
// not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(in ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// 8 consecutive elements of a shared page row, widened to float32
__device__ __forceinline__ void load8(float (&x)[8], const float* p) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(float (&x)[8], const __nv_bfloat16* p) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    x[2 * k] = f.x;
    x[2 * k + 1] = f.y;
  }
}
// 4 consecutive elements, widened
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

// The ring's item `it` (it < n: k page it of the split; n <= it < 2n: v
// page it - n) into its slot by cp.async, then one commit group (empty
// past the last item, so the waits count alike everywhere).
template <typename T>
__device__ __forceinline__ void issue_item(
    int it, int n, unsigned char* ring, int slot_bytes, int rb,
    const T* __restrict__ k_pool, const T* __restrict__ v_pool,
    const int* pids, int kvh, int Hkv, int D, int Tp) {
  if (it < 2 * n) {
    const bool is_v = it >= n;
    const size_t tok_stride = static_cast<size_t>(Hkv) * D;
    const T* src = (is_v ? v_pool : k_pool) +
                   static_cast<size_t>(pids[is_v ? it - n : it]) * Tp *
                       tok_stride +
                   static_cast<size_t>(kvh) * D;
    unsigned char* dst = ring + (it % kRing) * slot_bytes;
    const int chunks = D * static_cast<int>(sizeof(T)) / 16;  // per row
    for (int e = threadIdx.x; e < Tp * chunks; e += kThreads) {
      const int row = e / chunks;
      const int c = e - row * chunks;
      cp_async16(smem_addr(dst + row * rb + c * 16),
                 src + row * tok_stride + c * (16 / sizeof(T)));
    }
  }
  cp_async_commit();
}

// dynamic shared memory of the split kernel: the page ring (rows of the
// pool's elements), the tile's query rows (q's elements), its scores, the
// split's page ids
__host__ __device__ constexpr int split_smem(int D, int elem_q, int elem_p,
                                             int Tp, int rt) {
  return kRing * Tp * row_bytes(D, elem_p) + rt * row_bytes(D, elem_q) +
         rt * pages_per_split(Tp) * Tp * 4 + pages_per_split(Tp) * 4;
}

// One split of one (slot, kv head, row tile), for head widths D <= DMAX;
// q in TQ, the pools in TP, each widened to float32 as it is read.
// Workspace: ws_acc [S, Hkv, splits, R, D] (unnormalised P.V sums),
// ws_ml [S, Hkv, splits, R, 2] (row max m, row sum l), R = K * G.
template <typename TQ, typename TP, int DMAX>
__global__ void __launch_bounds__(kThreads)
paged_attention_split_kernel(const TQ* __restrict__ q,         // [S,K,H,D]
                             const TP* __restrict__ k_pool,    // [N,Tp,Hkv,D]
                             const TP* __restrict__ v_pool,    // [N,Tp,Hkv,D]
                             const int* __restrict__ tables,   // [S, P]
                             const int* __restrict__ lengths,  // [S]
                             float* __restrict__ ws_acc,
                             float* __restrict__ ws_ml, int K, int H,
                             int Hkv, int D, int N, int Tp, int P,
                             int splits, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.x;
  const int kvh = blockIdx.y;
  const int split = blockIdx.z % splits;
  const int r0 = (blockIdx.z / splits) * kRowTile;
  const int G = H / Hkv;
  const int R = K * G;
  const int rt = min(kRowTile, R - r0);  // rows of this tile
  const int pps = pages_per_split(Tp);
  const int KS = pps * Tp;               // keys of a split
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  const int rb = row_bytes(D, sizeof(TP));
  const int ldp = rb / static_cast<int>(sizeof(TP));  // page row stride
  const int slot_bytes = Tp * rb;
  const int rbq = row_bytes(D, sizeof(TQ));
  const int ldq = rbq / static_cast<int>(sizeof(TQ));  // query row stride
  unsigned char* ring = smem;                               // [kRing][Tp]
  const TQ* qs = reinterpret_cast<const TQ*>(smem + kRing * slot_bytes);
  float* sc = reinterpret_cast<float*>(smem + kRing * slot_bytes + rt * rbq);
  int* pids = reinterpret_cast<int*>(sc + rt * KS);         // [pps]

  // the split's page ids and the slot's length, loaded side by side
  const int first = split * pps;  // the split's first page
  for (int p = tid; p < pps && first + p < P; p += kThreads)
    pids[p] = min(max(tables[static_cast<size_t>(s) * P + first + p], 0),
                  N - 1);  // clamp as XLA's gather does
  const int length = lengths[s];
  const int live = min((length + K + Tp - 1) / Tp, P);
  if (first >= live) return;      // the whole split lies past the slot
  const int n = min(pps, live - first);  // pages this block walks

  // the tile's query rows, in q's dtype, join the first item's group
  {
    const int chunks = D * static_cast<int>(sizeof(TQ)) / 16;
    for (int e = tid; e < rt * chunks; e += kThreads) {
      const int r = e / chunks;
      const int c = e - r * chunks;
      const int i = (r0 + r) / G;
      const int h = kvh * G + (r0 + r - i * G);
      cp_async16(smem_addr(smem + kRing * slot_bytes + r * rbq + c * 16),
                 q + ((static_cast<size_t>(s) * K + i) * H + h) * D +
                     c * (16 / sizeof(TQ)));
    }
  }
  __syncthreads();  // the page ids are in place
#pragma unroll
  for (int it = 0; it < kRing - 1; ++it)
    issue_item(it, n, ring, slot_bytes, rb, k_pool, v_pool, pids, kvh, Hkv,
               D, Tp);

  // P.V mapping: thread (rg, c) holds columns 4c .. 4c + 3 of rows
  // rg + RS j, j < NJ
  constexpr int NJ = kRowTile * DMAX / (4 * kThreads) > 0
                         ? kRowTile * DMAX / (4 * kThreads) : 1;
  const int CH = D / 4;
  const int RS = kThreads / CH;
  const bool pv_live = tid < RS * CH;
  const int pv_c = tid % CH;
  const int pv_rg = tid / CH;
  float acc[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const int quad = tid >> 2;
  const int ql = tid & 3;
  const int c8 = D / 8;  // 8-element chunks of a row

  for (int it = 0; it < 2 * n; ++it) {
    issue_item(it + kRing - 1, n, ring, slot_bytes, rb, k_pool, v_pool, pids,
               kvh, Hkv, D, Tp);
    cp_async_wait<kRing - 1>();  // item it has landed (this thread's part)
    __syncthreads();
    const TP* page =
        reinterpret_cast<const TP*>(ring + (it % kRing) * slot_bytes);
    if (it < n) {
      // scores of page it: quad -> pairs (row, key) quad + 32 u, each an
      // independent chain; lane ql -> chunks ql + 4 c of the row
      for (int base = 0; base < rt * Tp; base += kPairBatch * kThreads / 4) {
        float part[kPairBatch];
        int pr[kPairBatch], pt[kPairBatch];
        bool ok[kPairBatch];
#pragma unroll
        for (int u = 0; u < kPairBatch; ++u) {
          const int pair = base + quad + u * (kThreads / 4);
          ok[u] = pair < rt * Tp;
          pr[u] = ok[u] ? pair / Tp : 0;
          pt[u] = ok[u] ? pair - pr[u] * Tp : 0;
          part[u] = 0.f;
        }
#pragma unroll
        for (int cs = 0; cs < DMAX / 32; ++cs) {
          const int ch = ql + 4 * cs;
          if (ch < c8) {
#pragma unroll
            for (int u = 0; u < kPairBatch; ++u) {
              if (ok[u]) {
                float kx[8], qx[8];
                load8(kx, page + pt[u] * ldp + 8 * ch);
                load8(qx, qs + pr[u] * ldq + 8 * ch);
#pragma unroll
                for (int e = 0; e < 8; ++e)
                  part[u] = fmaf(qx[e], kx[e], part[u]);
              }
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kPairBatch; ++u) {
          part[u] += __shfl_xor_sync(0xffffffffu, part[u], 1);
          part[u] += __shfl_xor_sync(0xffffffffu, part[u], 2);
          if (ok[u] && ql == 0) {
            const int key = (first + it) * Tp + pt[u];
            const int row_pos = length + (r0 + pr[u]) / G;
            sc[pr[u] * KS + it * Tp + pt[u]] =
                key <= row_pos ? part[u] * sm_scale : kNegInf;
          }
        }
      }
      if (it == n - 1) {
        __syncthreads();  // every score of the split is in place
        // the split's softmax, one warp per row
        for (int r = warp; r < rt; r += kWarps) {
          float* srow = sc + r * KS;
          float m = kNegInf;
          for (int x = lane; x < n * Tp; x += 32) m = fmaxf(m, srow[x]);
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
          float l = 0.f;
          for (int x = lane; x < n * Tp; x += 32) {
            const float p = expf(srow[x] - m);
            srow[x] = p;
            l += p;
          }
          // every lane ends with the same sum: the butterfly adds the same
          // pairs
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            l += __shfl_xor_sync(0xffffffffu, l, o);
          if (lane == 0) {
            float* ml = ws_ml + ((((static_cast<size_t>(s) * Hkv + kvh) *
                                   splits + split) * R) + r0 + r) * 2;
            ml[0] = m;
            ml[1] = l;
          }
        }
      }
    } else if (pv_live) {
      // acc += P . V over page it - n, one key after another
      const int pg = it - n;
#pragma unroll 4
      for (int t = 0; t < Tp; ++t) {
        const float4 vx = load4(page + t * ldp + 4 * pv_c);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int r = pv_rg + RS * j;
          if (r < rt) {
            const float p = sc[r * KS + pg * Tp + t];
            acc[j][0] = fmaf(p, vx.x, acc[j][0]);
            acc[j][1] = fmaf(p, vx.y, acc[j][1]);
            acc[j][2] = fmaf(p, vx.z, acc[j][2]);
            acc[j][3] = fmaf(p, vx.w, acc[j][3]);
          }
        }
      }
    }
    __syncthreads();  // the ring slot of item it is free for item it + kRing
  }
  cp_async_wait<0>();  // only empty groups are left; none outlives the block

  if (!pv_live) return;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int r = pv_rg + RS * j;
    if (r < rt) {
      float* dst = ws_acc + ((((static_cast<size_t>(s) * Hkv + kvh) * splits
                               + split) * R) + r0 + r) * D + 4 * pv_c;
      *reinterpret_cast<float4*>(dst) =
          make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
    }
  }
}

// ------------------------------------------ tensor cores: bf16, D % 16 == 0

using bf16 = __nv_bfloat16;
constexpr int kStep = kWarps;  // pages a step of the mma kernel: one a warp
constexpr int kRingSteps = 3;  // steps in its ring: two in flight

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
// p as bf16 hi + lo parts (hi = bf16(p), lo = bf16(p - hi)), each a pair
// packed lo-element first: p is float32 and P.V keeps it to about 2^-17
__device__ __forceinline__ void split_bf16(float2 p, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p.x, p.y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(p.x - hf.x, p.y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}
// p as three bf16 parts (hi, mid = bf16(p - hi), lo = bf16(p - hi - mid)),
// whose sum is p exactly, each a pair packed lo-element first
__device__ __forceinline__ void split3(float2 p, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p.x, p.y);
  const float2 hf = __bfloat1622float2(h);
  const float rx = p.x - hf.x;
  const float ry = p.y - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l = __floats2bfloat162_rn(rx - mf.x, ry - mf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}
// Per-lane element offsets into a [rows][ld] bf16 tile for ldmatrix.x4:
// a_off, the A fragment of rows 0-15, columns 0-15 (also, .trans, the B
// fragments of two 8-column n-tiles over rows 0-15 as the depth); b_off,
// the B fragments of two n-tiles of 8 rows over columns 0-15 as the depth.
__device__ __forceinline__ int a_off(int lane, int ld) {
  return (lane & 15) * ld + (lane >> 4) * 8;
}
__device__ __forceinline__ int b_off(int lane, int ld) {
  return ((lane & 7) + (lane >> 4) * 8) * ld + ((lane >> 3) & 1) * 8;
}

// dynamic shared memory of the mma kernel: the page ring (reused for the
// warps' partial sums at the end), the query tile (q_planes bf16 planes of
// it: 1 for bf16 q, 3 for float32 q), the scores, page ids
__host__ __device__ constexpr int mma_ld(int D) { return D + 8; }
__host__ __device__ constexpr int mma_sc_ld(int Tp) {
  return pages_per_split(Tp) * Tp + 8;
}
__host__ __device__ constexpr int split_mma_smem(int D, int Tp,
                                                 int q_planes) {
  return kRingSteps * kStep * Tp * mma_ld(D) * 2 +
         q_planes * kRowTile * mma_ld(D) * 2 + kRowTile * mma_sc_ld(Tp) * 4 +
         pages_per_split(Tp) * 4;
}
// bf16 planes of the mma kernel's query tile for q in TQ
template <typename TQ>
__host__ __device__ constexpr int q_planes() {
  return std::is_same<TQ, float>::value ? 3 : 1;
}

// Step `st` of the mma kernel's ring (st < nks: k pages 4 st .. 4 st + 3
// of the split; nks <= st < 2 nks: those v pages) into its slots, then one
// commit group (empty past the last step).
template <int D>
__device__ __forceinline__ void issue_step(
    int st, int nks, int n, bf16* ring, const bf16* __restrict__ k_pool,
    const bf16* __restrict__ v_pool, const int* pids, int kvh, int Hkv,
    int Tp) {
  constexpr int ld = mma_ld(D);
  constexpr int chunks = D / 8;  // 16-byte pieces of a row
  if (st < 2 * nks) {
    const bool is_v = st >= nks;
    const int p0 = kStep * (is_v ? st - nks : st);
    const size_t tok_stride = static_cast<size_t>(Hkv) * D;
    bf16* slots = ring + (st % kRingSteps) * kStep * Tp * ld;
    for (int j = 0; j < kStep && p0 + j < n; ++j) {
      const bf16* src = (is_v ? v_pool : k_pool) +
                        static_cast<size_t>(pids[p0 + j]) * Tp * tok_stride +
                        static_cast<size_t>(kvh) * D;
      bf16* dst = slots + j * Tp * ld;
      for (int e = threadIdx.x; e < Tp * chunks; e += kThreads) {
        const int row = e / chunks;
        const int c = e % chunks;
        cp_async16(smem_addr(dst + row * ld + 8 * c),
                   src + row * tok_stride + 8 * c);
      }
    }
  }
  cp_async_commit();
}

// One split of one (slot, kv head, 16-row tile) on the tensor cores, for
// bf16 pools with D % 16 == 0 and Tp % 16 == 0, under q in TQ (bf16 or
// float32). The same plan, workspace and merge as
// paged_attention_split_kernel. A step is 4 pages, one a warp; pass 1 (k
// pages): S = Q.K^T by mma.sync m16n8k16, Q's fragments read from shared
// memory at each k-step (float32 q: from each of its three planes, the
// smallest part first), scaled, masked and written to the scores; the
// split's exact softmax as in the FMA kernel; pass 2 (v pages): each warp
// sums P.V over its own pages (pages w, w + 4, ... of the split, in
// order) with P split into bf16 parts (hi and lo under bf16 q, so P keeps
// float32's precision to about 2^-17; hi, mid and lo under float32 q, so P
// is exact); the four warps' sums are then added in warp order. Every
// element of a product depends only on its own row of the query tile, and
// a row's masked keys give exact zeros in P, so row i of a window is still
// a 1-token call at lengths[s] + i bit for bit.
template <typename TQ, int D>
__global__ void __launch_bounds__(kThreads)
paged_attention_split_mma_kernel(const TQ* __restrict__ q,
                                 const bf16* __restrict__ k_pool,
                                 const bf16* __restrict__ v_pool,
                                 const int* __restrict__ tables,
                                 const int* __restrict__ lengths,
                                 float* __restrict__ ws_acc,
                                 float* __restrict__ ws_ml, int K, int H,
                                 int Hkv, int N, int Tp, int P, int splits,
                                 float sm_scale) {
  constexpr int ld = mma_ld(D);
  constexpr int KD = D / 16;  // k-steps over D
  constexpr int DN = D / 8;   // n-tiles over D
  constexpr int kQP = q_planes<TQ>();
  constexpr uint32_t kQPlaneBytes = kRowTile * ld * 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.x;
  const int kvh = blockIdx.y;
  const int split = blockIdx.z % splits;
  const int r0 = (blockIdx.z / splits) * kRowTile;
  const int G = H / Hkv;
  const int R = K * G;
  const int rt = min(kRowTile, R - r0);
  const int pps = pages_per_split(Tp);
  const int ldsc = mma_sc_ld(Tp);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  bf16* ring = reinterpret_cast<bf16*>(smem);  // [kRingSteps * 4][Tp][ld]
  bf16* qs = ring + kRingSteps * kStep * Tp * ld;       // [kQP][16][ld]
  float* sc = reinterpret_cast<float*>(qs + kQP * kRowTile * ld);  // [16][ldsc]
  int* pids = reinterpret_cast<int*>(sc + kRowTile * ldsc);  // [pps]

  const int first = split * pps;
  for (int p = tid; p < pps && first + p < P; p += kThreads)
    pids[p] = min(max(tables[static_cast<size_t>(s) * P + first + p], 0),
                  N - 1);  // clamp as XLA's gather does
  const int length = lengths[s];
  const int live = min((length + K + Tp - 1) / Tp, P);
  if (first >= live) return;  // the whole split lies past the slot
  const int n = min(pps, live - first);
  const int nks = (n + kStep - 1) / kStep;  // steps of each pass

  if constexpr (kQP == 1) {
    // the tile's query rows (zeros past the tile) join the first group
    for (int e = tid; e < kRowTile * (D / 8); e += kThreads) {
      const int r = e / (D / 8);
      const int c = e % (D / 8);
      const int i = (r0 + r) / G;
      const int h = kvh * G + (r0 + r - i * G);
      const bool in = r < rt;
      cp_async16(
          smem_addr(qs + r * ld + 8 * c),
          q + ((static_cast<size_t>(s) * K + (in ? i : 0)) * H +
               (in ? h : 0)) * D + 8 * c,
          in);
    }
  } else {
    // float32 query rows (zeros past the tile), read from device memory
    // and split into their hi, mid and lo planes
    for (int e = tid; e < kRowTile * (D / 4); e += kThreads) {
      const int r = e / (D / 4);
      const int c = (e % (D / 4)) * 4;
      const int i = (r0 + r) / G;
      const int h = kvh * G + (r0 + r - i * G);
      const float4 x =
          r < rt ? *reinterpret_cast<const float4*>(
                       q + ((static_cast<size_t>(s) * K + i) * H + h) * D + c)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
      uint32_t h0, m0, l0, h1, m1, l1;
      split3(make_float2(x.x, x.y), h0, m0, l0);
      split3(make_float2(x.z, x.w), h1, m1, l1);
      bf16* dst = qs + r * ld + c;
      *reinterpret_cast<uint2*>(dst) = make_uint2(h0, h1);
      *reinterpret_cast<uint2*>(dst + kRowTile * ld) = make_uint2(m0, m1);
      *reinterpret_cast<uint2*>(dst + 2 * kRowTile * ld) = make_uint2(l0, l1);
    }
  }
  __syncthreads();  // the page ids (and float32 q's planes) are in place
#pragma unroll
  for (int st = 0; st < kRingSteps - 1; ++st)
    issue_step<D>(st, nks, n, ring, k_pool, v_pool, pids, kvh, Hkv, Tp);

  float acc[DN][4];
#pragma unroll
  for (int d = 0; d < DN; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  const uint32_t qs_a = smem_addr(qs + a_off(lane, ld));

  for (int st = 0; st < 2 * nks; ++st) {
    issue_step<D>(st + kRingSteps - 1, nks, n, ring, k_pool, v_pool, pids,
                  kvh, Hkv, Tp);
    cp_async_wait<kRingSteps - 1>();  // step st has landed
    __syncthreads();
    const bool kpass = st < nks;
    const int pg = kStep * (kpass ? st : st - nks) + warp;  // page of split
    const bf16* page = ring + ((st % kRingSteps) * kStep + warp) * Tp * ld;
    if (pg < n && kpass) {
      // S = Q.K^T over the page's 16-key tiles
      const uint32_t kb_addr = smem_addr(page + b_off(lane, ld));
      for (int kt = 0; kt < Tp / 16; ++kt) {
        float sf[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kd = 0; kd < KD; ++kd) {
          if constexpr (kQP == 1) {
            uint32_t qa[4], kb[4];
            ldsm_x4(qa, qs_a + kd * 32);
            ldsm_x4(kb, kb_addr + (16 * kt * ld + 16 * kd) * 2);
            mma(sf[0], qa, kb[0], kb[1]);
            mma(sf[1], qa, kb[2], kb[3]);
          } else {
            uint32_t kb[4];
            ldsm_x4(kb, kb_addr + (16 * kt * ld + 16 * kd) * 2);
#pragma unroll
            for (int p = 2; p >= 0; --p) {  // lo, mid, hi
              uint32_t qa[4];
              ldsm_x4(qa, qs_a + p * kQPlaneBytes + kd * 32);
              mma(sf[0], qa, kb[0], kb[1]);
              mma(sf[1], qa, kb[2], kb[3]);
            }
          }
        }
        // scale, then mask to -1e30; rows g and g + 8 of the tile
#pragma unroll
        for (int nn = 0; nn < 2; ++nn)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int row = g + 8 * hr;
            const int col = pg * Tp + 16 * kt + 8 * nn + 2 * t;  // in split
            const int key = first * Tp + col;
            const int row_pos = length + (r0 + row) / G;
            float2 v;
            v.x = key <= row_pos ? sf[nn][2 * hr] * sm_scale : kNegInf;
            v.y = key + 1 <= row_pos ? sf[nn][2 * hr + 1] * sm_scale
                                     : kNegInf;
            *reinterpret_cast<float2*>(sc + row * ldsc + col) = v;
          }
      }
    } else if (pg < n) {
      // acc += P . V over the page's 16-key tiles, P as bf16 hi + lo
      // (bf16 q) or hi + mid + lo (float32 q)
      const uint32_t vb_addr = smem_addr(page + a_off(lane, ld));
      for (int kt = 0; kt < Tp / 16; ++kt) {
        const int col = pg * Tp + 16 * kt + 2 * t;
        const float2 pf[4] = {
            *reinterpret_cast<const float2*>(sc + g * ldsc + col),
            *reinterpret_cast<const float2*>(sc + (g + 8) * ldsc + col),
            *reinterpret_cast<const float2*>(sc + g * ldsc + col + 8),
            *reinterpret_cast<const float2*>(sc + (g + 8) * ldsc + col + 8)};
        if constexpr (kQP == 1) {
          uint32_t ph[4], pl[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) split_bf16(pf[e], ph[e], pl[e]);
#pragma unroll
          for (int dd = 0; dd < DN / 2; ++dd) {
            uint32_t vb[4];
            ldsm_x4_t(vb, vb_addr + (16 * kt * ld + 16 * dd) * 2);
            mma(acc[2 * dd], ph, vb[0], vb[1]);
            mma(acc[2 * dd + 1], ph, vb[2], vb[3]);
            mma(acc[2 * dd], pl, vb[0], vb[1]);
            mma(acc[2 * dd + 1], pl, vb[2], vb[3]);
          }
        } else {
          uint32_t pp[3][4];  // hi, mid, lo
#pragma unroll
          for (int e = 0; e < 4; ++e)
            split3(pf[e], pp[0][e], pp[1][e], pp[2][e]);
#pragma unroll
          for (int dd = 0; dd < DN / 2; ++dd) {
            uint32_t vb[4];
            ldsm_x4_t(vb, vb_addr + (16 * kt * ld + 16 * dd) * 2);
#pragma unroll
            for (int p = 2; p >= 0; --p) {  // lo, mid, hi
              mma(acc[2 * dd], pp[p], vb[0], vb[1]);
              mma(acc[2 * dd + 1], pp[p], vb[2], vb[3]);
            }
          }
        }
      }
    }
    if (st == nks - 1) {
      __syncthreads();  // every score of the split is in place
      // the split's softmax, one warp per row, as in the FMA kernel
      for (int r = warp; r < rt; r += kWarps) {
        float* srow = sc + r * ldsc;
        float m = kNegInf;
        for (int x = lane; x < n * Tp; x += 32) m = fmaxf(m, srow[x]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
        float l = 0.f;
        for (int x = lane; x < n * Tp; x += 32) {
          const float p = expf(srow[x] - m);
          srow[x] = p;
          l += p;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          l += __shfl_xor_sync(0xffffffffu, l, o);
        if (lane == 0) {
          float* ml = ws_ml + ((((static_cast<size_t>(s) * Hkv + kvh) *
                                 splits + split) * R) + r0 + r) * 2;
          ml[0] = m;
          ml[1] = l;
        }
      }
    }
    __syncthreads();  // the ring slots of step st are free for st + 3
  }
  cp_async_wait<0>();  // only empty groups are left

  // the warps' partial sums, added in warp order through the ring
  float* red = reinterpret_cast<float*>(ring);  // [4][16][ld]
#pragma unroll
  for (int d = 0; d < DN; ++d) {
    const int c = 8 * d + 2 * t;
    *reinterpret_cast<float2*>(red + (warp * kRowTile + g) * ld + c) =
        make_float2(acc[d][0], acc[d][1]);
    *reinterpret_cast<float2*>(red + (warp * kRowTile + g + 8) * ld + c) =
        make_float2(acc[d][2], acc[d][3]);
  }
  __syncthreads();
  for (int e = tid; e < rt * (D / 4); e += kThreads) {
    const int r = e / (D / 4);
    const int c = 4 * (e % (D / 4));
    float4 sum = *reinterpret_cast<const float4*>(red + r * ld + c);
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const float4 x =
          *reinterpret_cast<const float4*>(red + (w * kRowTile + r) * ld + c);
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    *reinterpret_cast<float4*>(
        ws_acc + ((((static_cast<size_t>(s) * Hkv + kvh) * splits + split) *
                   R) + r0 + r) * D + c) = sum;
  }
}

// Merges each row's splits, in ascending order, up to the split that holds
// the row's own position. grid (ceil(R / kWarps), Hkv, S); one warp a row,
// lane -> columns lane + 32 c. DPL: columns per lane.
template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads)
paged_attention_merge_kernel(const float* __restrict__ ws_acc,
                             const float* __restrict__ ws_ml,
                             const int* __restrict__ lengths,
                             T* __restrict__ out, int K, int H, int Hkv,
                             int D, int Tp, int P, int splits) {
  const int s = blockIdx.z;
  const int kvh = blockIdx.y;
  const int G = H / Hkv;
  const int R = K * G;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= R) return;
  const int i = r / G;
  const int h = kvh * G + (r - i * G);
  const int KS = pages_per_split(Tp) * Tp;
  const int row_pos = lengths[s] + i;
  const int last = min(row_pos, P * Tp - 1) / KS;  // the row's last split

  const size_t base = (static_cast<size_t>(s) * Hkv + kvh) * splits;
  float m = kNegInf;
  for (int j = 0; j <= last; ++j)
    m = fmaxf(m, ws_ml[((base + j) * R + r) * 2]);
  float l = 0.f;
  float acc[DPL];
#pragma unroll
  for (int c = 0; c < DPL; ++c) acc[c] = 0.f;
  for (int j = 0; j <= last; ++j) {
    const size_t row = (base + j) * R + r;
    const float w = expf(ws_ml[row * 2] - m);
    l = fmaf(w, ws_ml[row * 2 + 1], l);
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int d = lane + 32 * c;
      if (d < D) acc[c] = fmaf(w, ws_acc[row * D + d], acc[c]);
    }
  }
  if (l == 0.f) l = 1.f;  // a fully masked row gives 0, not NaN
  T* orow = out + ((static_cast<size_t>(s) * K + i) * H + h) * D;
#pragma unroll
  for (int c = 0; c < DPL; ++c) {
    const int d = lane + 32 * c;
    if (d < D) store(&orow[d], acc[c] / l);
  }
}

// lets `kernel` take `smem` bytes of dynamic shared memory (past 48 KB)
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename TQ, typename TP, int DMAX>
cudaError_t launch_d(const void* q, const void* k_pool, const void* v_pool,
                     const void* tables, const void* lengths, void* out,
                     void* ws_acc, void* ws_ml, int S, int K, int H, int Hkv,
                     int D, int N, int Tp, int P, int splits, float sm_scale,
                     cudaStream_t stream) {
  const int R = K * (H / Hkv);
  const int rt = R < kRowTile ? R : kRowTile;
  const dim3 grid(S, Hkv, splits * ((R + kRowTile - 1) / kRowTile));
  // the tensor cores take bf16 pools, under bf16 or float32 q, at the head
  // widths they are built for, where the tile fits one block
  constexpr bool kBf16Pool = std::is_same<TP, bf16>::value;
  const int mma_smem = split_mma_smem(D, Tp, q_planes<TQ>());
  const bool tensor_cores =
      kBf16Pool && D == DMAX && Tp % 16 == 0 && mma_smem <= kMaxSmem;
  const size_t smem = tensor_cores
                          ? mma_smem
                          : split_smem(D, sizeof(TQ), sizeof(TP), Tp, rt);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err;
  if constexpr (kBf16Pool) {
    if (tensor_cores) {
      auto kernel = paged_attention_split_mma_kernel<TQ, DMAX>;
      err = set_smem(kernel, smem);
      if (err != cudaSuccess) return err;
      kernel<<<grid, kThreads, smem, stream>>>(
          static_cast<const TQ*>(q), static_cast<const bf16*>(k_pool),
          static_cast<const bf16*>(v_pool), static_cast<const int*>(tables),
          static_cast<const int*>(lengths), static_cast<float*>(ws_acc),
          static_cast<float*>(ws_ml), K, H, Hkv, N, Tp, P, splits, sm_scale);
    }
  }
  if (!tensor_cores) {
    auto kernel = paged_attention_split_kernel<TQ, TP, DMAX>;
    err = set_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const TQ*>(q), static_cast<const TP*>(k_pool),
        static_cast<const TP*>(v_pool), static_cast<const int*>(tables),
        static_cast<const int*>(lengths), static_cast<float*>(ws_acc),
        static_cast<float*>(ws_ml), K, H, Hkv, D, N, Tp, P, splits,
        sm_scale);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_attention_merge_kernel<TQ, DMAX / 32>
      <<<dim3((R + kWarps - 1) / kWarps, Hkv, S), kThreads, 0, stream>>>(
          static_cast<const float*>(ws_acc),
          static_cast<const float*>(ws_ml), static_cast<const int*>(lengths),
          static_cast<TQ*>(out), K, H, Hkv, D, Tp, P, splits);
  return cudaGetLastError();
}

// one switch over the head widths the kernels are built for
#define PAGED_DISPATCH_D(CALL)                                  \
  if (D <= 32) { constexpr int kD = 32; err = CALL; }           \
  else if (D <= 64) { constexpr int kD = 64; err = CALL; }      \
  else if (D <= 128) { constexpr int kD = 128; err = CALL; }    \
  else if (D <= 256) { constexpr int kD = 256; err = CALL; }    \
  else err = cudaErrorInvalidValue;

template <typename TQ, typename TP>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* tables, const void* lengths, void* out, void* ws_acc,
           void* ws_ml, int S, int K, int H, int Hkv, int D, int N, int Tp,
           int P, int pages, float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the wrapper checks these first; the workspace is sized by its split
  // plan, which must be this file's
  if (S <= 0 || K <= 0 || Hkv <= 0 || H % Hkv || D % 8 || Tp <= 0 ||
      Tp > kSplitKeys || P <= 0 || N <= 0 || pages != pages_per_split(Tp) ||
      S > 65535 || Hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int splits = (P + pages - 1) / pages;
  const int tiles = (K * (H / Hkv) + kRowTile - 1) / kRowTile;
  if (static_cast<long long>(splits) * tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  PAGED_DISPATCH_D((launch_d<TQ, TP, kD>(q, k_pool, v_pool, tables, lengths, out,
                                        ws_acc, ws_ml, S, K, H, Hkv, D, N,
                                        Tp, P, splits, sm_scale, st)))
  return static_cast<int>(err);
}

}  // namespace

// Plain C entry points, one per (q dtype, pool dtype) pair, loaded with
// ctypes: f32 and bf16 name both, f32_bf16 is float32 q over bf16 pools and
// bf16_f32 bf16 q over float32 pools; the output is in q's dtype. Each
// launches the split kernel and the merge kernel on `stream` and returns
// cudaGetLastError() after the launches (0 = launched). `pages` is the
// caller's pages per split, checked against this file's.
extern "C" int paged_attention_f32(const void* q, const void* k_pool,
                                   const void* v_pool, const void* tables,
                                   const void* lengths, void* out,
                                   void* ws_acc, void* ws_ml, int S, int K,
                                   int H, int Hkv, int D, int N, int Tp,
                                   int P, int pages, float sm_scale,
                                   void* stream) {
  return launch<float, float>(q, k_pool, v_pool, tables, lengths, out, ws_acc, ws_ml,
                       S, K, H, Hkv, D, N, Tp, P, pages, sm_scale, stream);
}

extern "C" int paged_attention_bf16(const void* q, const void* k_pool,
                                    const void* v_pool, const void* tables,
                                    const void* lengths, void* out,
                                    void* ws_acc, void* ws_ml, int S, int K,
                                    int H, int Hkv, int D, int N, int Tp,
                                    int P, int pages, float sm_scale,
                                    void* stream) {
  return launch<bf16, bf16>(q, k_pool, v_pool, tables, lengths, out, ws_acc,
                            ws_ml, S, K, H, Hkv, D, N, Tp, P, pages,
                            sm_scale, stream);
}

extern "C" int paged_attention_f32_bf16(const void* q, const void* k_pool,
                                        const void* v_pool,
                                        const void* tables,
                                        const void* lengths, void* out,
                                        void* ws_acc, void* ws_ml, int S,
                                        int K, int H, int Hkv, int D, int N,
                                        int Tp, int P, int pages,
                                        float sm_scale, void* stream) {
  return launch<float, bf16>(q, k_pool, v_pool, tables, lengths, out, ws_acc,
                             ws_ml, S, K, H, Hkv, D, N, Tp, P, pages,
                             sm_scale, stream);
}

extern "C" int paged_attention_bf16_f32(const void* q, const void* k_pool,
                                        const void* v_pool,
                                        const void* tables,
                                        const void* lengths, void* out,
                                        void* ws_acc, void* ws_ml, int S,
                                        int K, int H, int Hkv, int D, int N,
                                        int Tp, int P, int pages,
                                        float sm_scale, void* stream) {
  return launch<bf16, float>(q, k_pool, v_pool, tables, lengths, out, ws_acc,
                             ws_ml, S, K, H, Hkv, D, N, Tp, P, pages,
                             sm_scale, stream);
}

extern "C" const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
