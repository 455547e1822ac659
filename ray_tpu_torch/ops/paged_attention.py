"""Paged attention: online-softmax attention THROUGH the page table.

Counterpart: ``ray_tpu/ops/paged_attention.py``. Each layer's KV cache is a
pool ``[num_pages, page_tokens, Hkv, D]`` plus per-slot page tables; this op
attends directly against the pool, reading only the pages that cover a
slot's live tokens. No contiguous per-slot view is ever built.

  * On a CUDA tensor, ``paged_attention`` launches the hand-written Hopper
    kernels in ``ray_tpu_torch/csrc/paged_attention.cu`` (built by
    ``ops/_build.py``), or raises: one kernel over (slot, kv head, split of
    the page table, tile of query rows) into a float32 workspace, and one
    that merges each row's splits. The split kernel runs on the tensor
    cores for bf16 pools at the head widths of ``MMA_HEAD_DIMS`` and pages
    of a multiple of 16 tokens (llama3_8b's serve path), under bf16 q or
    float32 q, where its tile fits one block, and float32 FMA otherwise.
    q and the pools may differ in dtype, as the TPU kernel allows
    (``cache_dtype``): float32 q over bf16 pools, or bf16 q over float32
    pools; the TPU kernel widens both to float32. Float32 q on the tensor
    cores is split into three bf16 parts whose sum is q exactly, so its
    products over the bf16 pages are float32's; bf16 q over float32 pools
    takes the FMA kernel, which widens both. The output is in q's dtype.
    Any other pair raises.
    ``split_plan`` is the host side of that split; it reads shapes only,
    never ``lengths`` or ``tables``, which stay on the card.
    ``paged_attention.launches`` counts the wrapper's launches, and
    ``paged_attention.pair_launches`` the launches of each dtype pair's
    entry (keyed ``"float32/bfloat16"``: q's dtype, then the pools').
  * On a CPU tensor it runs ``paged_attention_reference``, the plain PyTorch
    version with the same math: the same page order, the same -1e30 mask
    and the same online-softmax update, in float32.

Mask: query row ``i`` of slot ``s`` sits at logical position
``lengths[s] + i`` and may attend position ``j`` iff ``j <= lengths[s] + i``.
Table entries past a slot's allocation point at the garbage page 0; every
position they cover is masked, and exp(-1e30 - m) is exactly 0.0, so their
content can never reach an output. The plain version reduces each query
row over pages in ascending order under that mask; the kernel over fixed
splits of pages, merged in ascending order up to the split that holds the
row's position. Either way row ``i`` of a K-token window is the same as a
K=1 call at ``lengths[s] + i``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from ray_tpu_torch.ops import _build

NEG_INF = -1e30
MAX_HEAD_DIM = 256
MAX_PAGE_VECTORS = 4 * 256  # 16-byte vectors of one page and head
# the kernels' split plan (``csrc/paged_attention.cu``: kSplitKeys,
# kRowTile, kRing, kRingSteps; the C entry checks pages per split against
# its own)
SPLIT_KEYS = 256   # keys per split, in whole pages
ROW_TILE = 16      # query rows per block
RING_PAGES = 8     # page slots of the FMA kernel's shared-memory ring
RING_STEPS = 3     # steps of 4 pages in the tensor-core kernel's ring
MMA_HEAD_DIMS = (32, 64, 128, 256)  # head widths of the tensor-core kernel
MAX_SMEM = 232448  # bytes of shared memory a block can use

# the C entry point of each (q dtype, pool dtype) pair the kernels take
_ENTRY = {(torch.float32, torch.float32): "paged_attention_f32",
          (torch.bfloat16, torch.bfloat16): "paged_attention_bf16",
          (torch.float32, torch.bfloat16): "paged_attention_f32_bf16",
          (torch.bfloat16, torch.float32): "paged_attention_bf16_f32"}
_NAME = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
             + [ctypes.c_float, ctypes.c_void_p])


class SplitPlan(NamedTuple):
    """How the kernel cuts a call: pages per split, splits of the page
    table, tiles of query rows, the split kernel's grid, the float32
    workspace (``[S, Hkv, splits, rows, D]`` sums and ``[..., 2]`` row max
    and sum), the split kernel's shared memory in bytes, and whether that
    kernel is the tensor-core one (bf16 pools under bf16 or float32 q, D in
    ``MMA_HEAD_DIMS``, pages of a multiple of 16 tokens, its shared memory
    within ``MAX_SMEM``) or the float32 FMA one."""
    pages_per_split: int
    splits: int
    row_tiles: int
    grid: Tuple[int, int, int]
    workspace: Tuple[int, int, int, int, int]
    smem_bytes: int
    tensor_cores: bool


@functools.lru_cache(maxsize=256)
def split_plan(S: int, K: int, H: int, Hkv: int, D: int, T: int, P: int,
               elem_bytes: int, q_bytes: Optional[int] = None) -> SplitPlan:
    """The split plan of a call from its shapes alone: S slots, a K-token
    window, H query and Hkv kv heads of width D, T-token pages, P-page
    tables, ``elem_bytes`` per pool element and ``q_bytes`` per query
    element (2: bf16, 4: float32; ``None``: the pool's)."""
    q_bytes = elem_bytes if q_bytes is None else q_bytes
    pages = max(1, SPLIT_KEYS // T)
    splits = -(-P // pages)
    rows = K * (H // Hkv)
    tiles = -(-rows // ROW_TILE)
    # the tensor-core kernel: the ring of 4-page steps, the 16-row query
    # tile (rows of D + 8 bf16; float32 q as three bf16 planes), the scores
    # (rows of pages * T + 8 floats), the page ids
    q_planes = 3 if q_bytes == 4 else 1
    mma_smem = ((RING_STEPS * 4 * T + ROW_TILE * q_planes) * 2 * (D + 8)
                + ROW_TILE * (pages * T + 8) * 4 + pages * 4)
    tensor_cores = (elem_bytes == 2 and D in MMA_HEAD_DIMS and T % 16 == 0
                    and mma_smem <= MAX_SMEM)
    if tensor_cores:
        smem = mma_smem
    else:
        def padded(elem):  # a page or query row, padded as the kernel's
            row = D * elem
            return row + (64 - row % 128) % 128

        rt = min(ROW_TILE, rows)
        # the page ring, the tile's query rows and scores, the page ids
        smem = (RING_PAGES * T * padded(elem_bytes) + rt * padded(q_bytes)
                + rt * pages * T * 4 + pages * 4)
    return SplitPlan(pages, splits, tiles, (S, Hkv, splits * tiles),
                     (S, Hkv, splits, rows, D), smem, tensor_cores)


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, tables: torch.Tensor,
                    lengths: torch.Tensor,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Attention for q at positions [lengths[s], lengths[s] + K) of each slot.

    q: [S, K, H, D] queries (K = 1 decode, K > 1 a prefill window).
    k_pool/v_pool: [N, T, Hkv, D] page pools (page 0 = garbage page).
    tables: [S, P] int32 page tables; lengths: [S] int32 slot cursors.
    Returns [S, K, H, D] in q's dtype. The pools may be in another dtype
    than q (both are widened to float32, as in the TPU kernel).

    The new tokens' k/v must already be WRITTEN into their pages (write
    before attend); this op only reads.
    """
    if q.shape[0] != tables.shape[0] or q.shape[0] != lengths.shape[0]:
        raise ValueError(
            f"slot axis mismatch: q {tuple(q.shape)}, tables "
            f"{tuple(tables.shape)}, lengths {tuple(lengths.shape)}")
    if q.shape[3] != k_pool.shape[3] or q.shape[2] % k_pool.shape[2] != 0:
        raise ValueError(
            f"head mismatch: q {tuple(q.shape)} vs pool "
            f"{tuple(k_pool.shape)} (H must be a multiple of Hkv, D must "
            "match)")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pool, v_pool, tables, lengths,
                                         sm_scale)
    return _paged_attention_cuda(q, k_pool, v_pool, tables, lengths,
                                 sm_scale)


paged_attention.launches = 0
paged_attention.pair_launches = {}


def paged_attention_reference(q, k_pool, v_pool, tables, lengths,
                              sm_scale: Optional[float] = None):
    """Plain PyTorch twin of the kernel: one loop over pages, all slots
    batched per iteration. The trip count is the BATCH MAX of pages any slot
    needs; pages past a slot's own need hit its garbage-page table tail and
    contribute exact zeros."""
    S, K, H, D = q.shape
    _, T, Hkv, _ = k_pool.shape
    P = tables.shape[1]
    G = H // Hkv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    dev = q.device
    qf = q.reshape(S, K, Hkv, G, D).float()
    qpos = lengths.long()[:, None] + torch.arange(K, device=dev)[None, :]
    n_pages = min((int(lengths.max()) + K + T - 1) // T, P)
    m = torch.full((S, K, Hkv, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((S, K, Hkv, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((S, K, Hkv, G, D), dtype=torch.float32, device=dev)
    for p in range(n_pages):
        pids = tables[:, p].long()
        kpg = k_pool[pids].float()                       # [S, T, Hkv, D]
        vpg = v_pool[pids].float()
        s_ = torch.einsum("skhgd,sthd->skhgt", qf, kpg) * sm_scale
        kpos = p * T + torch.arange(T, device=dev)         # [T]
        allowed = kpos[None, None, :] <= qpos[:, :, None]  # [S, K, T]
        s_ = torch.where(allowed[:, :, None, None, :], s_,
                         torch.tensor(NEG_INF, device=dev))
        m_new = torch.maximum(m, s_.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        pr = torch.exp(s_ - m_new[..., None])
        l = l * alpha + pr.sum(dim=-1)
        acc = (acc * alpha[..., None]
               + torch.einsum("skhgt,sthd->skhgd", pr, vpg))
        m = m_new
    l = torch.where(l == 0.0, torch.ones_like(l), l)  # masked row -> 0
    return (acc / l[..., None]).reshape(S, K, H, D).to(q.dtype)


def _kernel_entry(q_dtype: torch.dtype, pool_dtype: torch.dtype):
    lib = _build.load("paged_attention")
    fn = getattr(lib, _ENTRY[q_dtype, pool_dtype])
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.paged_attention_error_string.argtypes = [ctypes.c_int]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
    return lib, fn


def _paged_attention_cuda(q, k_pool, v_pool, tables, lengths, sm_scale):
    if (q.dtype, k_pool.dtype) not in _ENTRY or v_pool.dtype != k_pool.dtype:
        raise TypeError(
            f"paged_attention kernel takes float32 or bfloat16 q over k and "
            f"v pools of one float32 or bfloat16 dtype, got q {q.dtype}, "
            f"k {k_pool.dtype}, v {v_pool.dtype}")
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on CPU or CUDA tensors, "
                         f"got {q.device}")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError(f"tables and lengths must be int32, got "
                        f"{tables.dtype} and {lengths.dtype}")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("tables", tables), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if k_pool.shape != v_pool.shape:
        raise ValueError(f"k_pool {tuple(k_pool.shape)} and v_pool "
                         f"{tuple(v_pool.shape)} differ")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("page pools must be contiguous")
    S, K, H, D = q.shape
    N, T, Hkv, _ = k_pool.shape
    P = tables.shape[1]
    vec = 16 // k_pool.element_size()  # the kernel moves 16-byte vectors
    if D > MAX_HEAD_DIM or D % 8 or T * D > MAX_PAGE_VECTORS * vec \
            or T > SPLIT_KEYS:
        raise ValueError(
            f"the kernel takes head_dim <= {MAX_HEAD_DIM}, a multiple of 8, "
            f"pages of at most {SPLIT_KEYS} tokens and "
            f"{MAX_PAGE_VECTORS * vec} elements per head; got head_dim {D}, "
            f"page_tokens {T}")
    plan = split_plan(S, K, H, Hkv, D, T, P, k_pool.element_size(),
                      q.element_size())
    if plan.smem_bytes > MAX_SMEM or plan.grid[2] > 65535 or S > 65535:
        raise ValueError(f"split plan {plan} does not fit one block's shared "
                         f"memory or the grid")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("page pools must be 16-byte aligned")
    q = q.contiguous()
    if q.data_ptr() % 16:  # the kernel copies q in 16-byte pieces
        q = q.clone()
    tables = tables.contiguous()
    lengths = lengths.contiguous()
    out = torch.empty_like(q)
    # one float32 workspace: the sums, then each row's max and sum
    n_acc = math.prod(plan.workspace)
    ws = torch.empty(n_acc + 2 * n_acc // D, dtype=torch.float32,
                     device=q.device)
    lib, fn = _kernel_entry(q.dtype, k_pool.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                 ws.data_ptr(), ws.data_ptr() + 4 * n_acc, S, K, H, Hkv, D,
                 N, T, P, plan.pages_per_split, float(sm_scale), stream)
    if err != 0:
        msg = lib.paged_attention_error_string(err).decode()
        raise RuntimeError(f"paged_attention kernel launch failed: {msg} "
                           f"(cuda error {err})")
    paged_attention.launches += 1
    pair = f"{_NAME[q.dtype]}/{_NAME[k_pool.dtype]}"
    paged_attention.pair_launches[pair] = (
        paged_attention.pair_launches.get(pair, 0) + 1)
    return out
