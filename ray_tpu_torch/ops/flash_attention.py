"""Flash attention, forward and backward, for training.

Counterpart: ``ray_tpu/ops/flash_attention.py``. Layout ``[B, S, H, D]``
queries against ``[B, S, Hkv, D]`` keys and values (GQA when ``H > Hkv``;
query head ``h`` reads kv head ``h // (H // Hkv)``, and no kv head is ever
repeated in memory).

Three kernels, each behind its own wrapper:

  * ``flash_forward`` (K1): O and the per-row logsumexp ``lse [B, H, Sq]``
    (float32), with an online softmax in float32.
  * ``flash_dq`` (K2): dQ, recomputing P = exp(S - lse) from q, k and lse.
  * ``flash_dkv`` (K3): dK and dV, the GQA group summed into its kv head
    inside the kernel.

On a CUDA tensor each wrapper launches its hand-written Hopper kernel in
``ray_tpu_torch/csrc/flash_attention.cu`` (built by ``ops/_build.py``), or
raises; ``<wrapper>.launches`` counts its launches. At head widths 64 and
128, K1, K2 and K3 in bf16 and K1 in float32 run on the tensor cores
(``mma.sync``, float32 sums), and so do the float32 K2 and K3 at every
width (16 too); a float32 kernel splits each operand into three bf16
parts, whose six cross products above 2^-24 keep float32's product
precision. K1 in float32 at head width 16, and bf16 at 16, run float32
FMA (``kernel_route`` says which). On a CPU tensor each
wrapper runs its plain PyTorch version (``flash_forward_reference``,
``flash_dq_reference``, ``flash_dkv_reference``), with the same math in
float32 and the same casts: P is cast to v's dtype before P.V, and P and dS
to the dtype of the operand they multiply in the backward products. The
plain backward takes each of its products (S, dP, and the sums of dQ, dK
and dV) in float64 and rounds it to float32 once, so it does not rest on
any order of sums: in float32, a long sum in another order lands further
from the exact one than the float32 gate the kernels are held to.

``flash_attention`` is the differentiable op: a ``torch.autograd.Function``
that saves q, k, v, O and lse and runs K2 and K3 in its backward. Delta =
rowsum(dO * O) is a plain torch op between them, as in the JAX package.

Masking: a key is masked (-1e30 before the softmax, so its P is exactly 0)
when it lies past the end of the keys or, under ``causal``, after the query
(query i may attend key j iff i >= j).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ray_tpu_torch.ops import _build

NEG_INF = -1e30
HEAD_DIMS = (16, 64, 128)  # head widths the kernels are built for
# the head widths at which a kernel runs on the tensor cores, per dtype
# (``csrc/flash_attention.cu``: kTensorCores, kF32TensorCores,
# kF32BwdTensorCores)
MMA_HEAD_DIMS = {("flash_fwd", torch.bfloat16): (64, 128),
                 ("flash_dq", torch.bfloat16): (64, 128),
                 ("flash_dkv", torch.bfloat16): (64, 128),
                 ("flash_fwd", torch.float32): (64, 128),
                 ("flash_dq", torch.float32): HEAD_DIMS,
                 ("flash_dkv", torch.float32): HEAD_DIMS}

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_ARGTYPES = {
    "flash_fwd": [ctypes.c_void_p] * 5,
    "flash_dq": [ctypes.c_void_p] * 7,
    "flash_dkv": [ctypes.c_void_p] * 8,
}
_DIMS = [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def kernel_route(name: str, dtype: torch.dtype, head_dim: int) -> str:
    """Which kernel ``name`` ("flash_fwd", "flash_dq", "flash_dkv") takes
    in ``dtype`` at ``head_dim``: "tensor cores" or "FMA"."""
    dims = MMA_HEAD_DIMS.get((name, dtype), ())
    return "tensor cores" if head_dim in dims else "FMA"


def _scale(q: torch.Tensor, sm_scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale


# ---------------------------------------------------------------- plain


def _mask(s, causal):
    """Scores [..., Sq, Sk] with the keys after each query at NEG_INF."""
    if not causal:
        return s
    Sq, Sk = s.shape[-2:]
    allowed = (torch.arange(Sq, device=s.device)[:, None]
               >= torch.arange(Sk, device=s.device)[None, :])
    return torch.where(allowed, s, torch.tensor(NEG_INF, device=s.device))


def _scores(q, k, sm_scale, causal):
    """Masked, scaled scores [B, Hkv, G, Sq, Sk] in float32; the scale is
    applied before the mask, as the kernels do."""
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Sq, Hkv, H // Hkv, D).float()
    return _mask(torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * sm_scale,
                 causal)


def _dot64(eq, a, b):
    """``einsum(eq, a, b)`` taken in float64 and rounded to float32 once:
    a float32 product whose every element is as near the exact one as
    float32 allows, whatever order a kernel sums it in."""
    return torch.einsum(eq, a.double(), b.double()).float()


def _heads(t, B, Hkv, G, Sq):
    """[B, H, Sq] float32 row statistics -> [B, Hkv, G, Sq, 1]."""
    return t.float().reshape(B, Hkv, G, Sq, 1)


def flash_forward_reference(q, k, v, sm_scale=None, causal=True
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1: (O [B, Sq, H, D] in q's dtype, lse [B, H, Sq]
    float32)."""
    sm_scale = _scale(q, sm_scale)
    B, Sq, H, D = q.shape
    s = _scores(q, k, sm_scale, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), v.float()) / l
    o = o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)
    lse = (m + torch.log(l)).reshape(B, H, Sq)
    return o, lse


def _p_and_ds(q, k, v, do, lse, delta, sm_scale, causal):
    """P and dS [B, Hkv, G, Sq, Sk] in float32, S and dP by ``_dot64``;
    and dO as [B, Sq, Hkv, G, D]."""
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D)
    s = _mask(_dot64("bqhgd,bkhd->bhgqk", qg, k) * sm_scale, causal)
    p = torch.exp(s - _heads(lse, B, Hkv, G, Sq))  # masked -> exactly 0
    dog = do.reshape(B, Sq, Hkv, G, D)
    dp = _dot64("bqhgd,bkhd->bhgqk", dog, v)
    ds = p * (dp - _heads(delta, B, Hkv, G, Sq)) * sm_scale
    return p, ds, dog


def flash_dq_reference(q, k, v, do, lse, delta, sm_scale=None, causal=True):
    """Plain version of K2: dQ = scale * sum_k P * (dO.V^T - delta) . K, in
    q's dtype. lse, delta: [B, H, Sq] float32. Its products by ``_dot64``."""
    sm_scale = _scale(q, sm_scale)
    _, ds, _ = _p_and_ds(q, k, v, do, lse, delta, sm_scale, causal)
    dq = _dot64("bhgqk,bkhd->bqhgd", ds.to(k.dtype), k)
    return dq.reshape(q.shape).to(q.dtype)


def flash_dkv_reference(q, k, v, do, lse, delta, sm_scale=None, causal=True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3: (dK, dV) [B, Sk, Hkv, D] in k's and v's dtypes,
    each query head's share summed into its kv head. Its products by
    ``_dot64``."""
    sm_scale = _scale(q, sm_scale)
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    p, ds, dog = _p_and_ds(q, k, v, do, lse, delta, sm_scale, causal)
    qg = q.reshape(B, Sq, Hkv, H // Hkv, D)
    dv = _dot64("bhgqk,bqhgd->bkhd", p.to(do.dtype), dog)
    dk = _dot64("bhgqk,bqhgd->bkhd", ds.to(q.dtype), qg)
    return dk.to(k.dtype), dv.to(v.dtype)


def reference_attention(q, k, v, sm_scale=None, causal=True, bias=None):
    """Plain attention ([B, S, H, D] x [B, S, Hkv, D]), softmax in float32,
    differentiable by autograd; ``bias`` is added to the scaled scores
    before the causal mask."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    sm_scale = _scale(q, sm_scale)
    qg = q.reshape(B, Sq, Hkv, H // Hkv, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * sm_scale
    if bias is not None:
        s = s + bias
    if causal:
        allowed = (torch.arange(Sq, device=q.device)[:, None]
                   >= torch.arange(Sk, device=q.device)[None, :])
        s = torch.where(allowed, s, torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)


# ---------------------------------------------------------------- kernels


def _check(name, q, k, v, *rest):
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} kernel takes float32 or bfloat16 q, k and v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    B, Sq, H, D = q.shape
    Bk, Sk, Hkv, Dk = k.shape
    if v.shape != k.shape or Bk != B or Dk != D or H % Hkv:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} (need [B,Sq,H,D] and "
                         "[B,Sk,Hkv,D] with H a multiple of Hkv)")
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: the kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {D}")
    if rest:  # the backward's do, lse, delta
        do, lse, delta = rest
        if do.shape != q.shape or lse.shape != (B, H, Sq) \
                or delta.shape != (B, H, Sq):
            raise ValueError(f"{name}: do {tuple(do.shape)}, lse "
                             f"{tuple(lse.shape)}, delta {tuple(delta.shape)}"
                             f" (need {tuple(q.shape)} and {(B, H, Sq)})")
    for t in (k, v, *rest):
        if t.device != q.device:
            raise ValueError(f"{name}: tensors on {t.device} and {q.device}")


def _launch(name: str, dtype: torch.dtype, tensors, dims, sm_scale, causal,
            device):
    lib = _build.load("flash_attention")
    fn = getattr(lib, f"{name}_{_DTYPES[dtype]}")
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name] + _DIMS
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*[t.data_ptr() for t in tensors], *dims, float(sm_scale),
                 int(bool(causal)), stream)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} "
                           f"(cuda error {err})")


def _dims(q, k):
    B, Sq, H, D = q.shape
    return (B, Sq, k.shape[1], H, k.shape[2], D)


def flash_forward(q, k, v, sm_scale=None, causal=True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: (O [B, Sq, H, D] in q's dtype, lse [B, H, Sq] float32)."""
    sm_scale = _scale(q, sm_scale)
    if q.device.type == "cpu":
        return flash_forward_reference(q, k, v, sm_scale, causal)
    _check("flash_forward", q, k, v)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    B, Sq, H, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    _launch("flash_fwd", q.dtype, (q, k, v, o, lse), _dims(q, k), sm_scale,
            causal, q.device)
    flash_forward.launches += 1
    return o, lse


def flash_dq(q, k, v, do, lse, delta, sm_scale=None, causal=True):
    """K2: dQ in q's dtype. lse, delta: [B, H, Sq] float32. No atomics:
    each block owns one query tile of one head and walks the key tiles in a
    fixed order, so two runs give the same bits. The tensor-core sums run
    in another order than the plain version's: in bf16 dQ may land on the
    neighbouring bf16 value, in float32 a few float32 roundings away."""
    sm_scale = _scale(q, sm_scale)
    if q.device.type == "cpu":
        return flash_dq_reference(q, k, v, do, lse, delta, sm_scale, causal)
    _check("flash_dq", q, k, v, do, lse, delta)
    q, k, v, do = (t.contiguous() for t in (q, k, v, do))
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    dq = torch.empty_like(q)
    _launch("flash_dq", q.dtype, (q, k, v, do.to(q.dtype), lse, delta, dq),
            _dims(q, k), sm_scale, causal, q.device)
    flash_dq.launches += 1
    return dq


def flash_dkv(q, k, v, do, lse, delta, sm_scale=None, causal=True
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: (dK, dV) [B, Sk, Hkv, D] in k's dtype. No atomics: each block
    owns one key tile of one kv head and walks the query tiles in a fixed
    order, so two runs give the same bits. The tensor-core sums run in
    another order than the plain version's: in bf16 dK and dV may land on
    the neighbouring bf16 value, in float32 a few float32 roundings away."""
    sm_scale = _scale(q, sm_scale)
    if q.device.type == "cpu":
        return flash_dkv_reference(q, k, v, do, lse, delta, sm_scale, causal)
    _check("flash_dkv", q, k, v, do, lse, delta)
    q, k, v, do = (t.contiguous() for t in (q, k, v, do))
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("flash_dkv", q.dtype,
            (q, k, v, do.to(q.dtype), lse, delta, dk, dv), _dims(q, k),
            sm_scale, causal, q.device)
    flash_dkv.launches += 1
    return dk, dv


flash_forward.launches = 0
flash_dq.launches = 0
flash_dkv.launches = 0
KERNELS = (flash_forward, flash_dq, flash_dkv)


# ---------------------------------------------------------------- public op


def delta_rows(do: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """Delta = rowsum(dO * O) in float32, [B, S, H, D] -> [B, H, S]."""
    d = (do.float() * o.float()).sum(dim=-1)
    return d.transpose(1, 2).contiguous()


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, sm_scale, causal):
        o, lse = flash_forward(q, k, v, sm_scale, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.sm_scale, ctx.causal = sm_scale, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        delta = delta_rows(do, o)
        dq = flash_dq(q, k, v, do, lse, delta, ctx.sm_scale, ctx.causal)
        dk, dv = flash_dkv(q, k, v, do, lse, delta, ctx.sm_scale,
                           ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sm_scale: Optional[float] = None,
                    causal: bool = True) -> torch.Tensor:
    """Differentiable attention through K1 (forward) and K2 + K3 (backward).
    q: [B, Sq, H, D]; k, v: [B, Sk, Hkv, D]. Returns [B, Sq, H, D] in q's
    dtype; the grads come back in the inputs' dtypes."""
    return _FlashAttention.apply(q, k, v, _scale(q, sm_scale), causal)
