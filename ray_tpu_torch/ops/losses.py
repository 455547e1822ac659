"""Cross-entropy losses in float32, with optional z-loss, mask-aware.

Counterpart: ``ray_tpu/ops/losses.py``. ``fused_softmax_cross_entropy``
folds the vocab projection into the loss: logits are computed one token
chunk at a time from the final hidden states and never held whole, and the
backward recomputes each chunk's logits (``torch.utils.checkpoint`` per
chunk) instead of keeping them. Its products are plain ``torch.mm``, as the
JAX package leaves them to XLA.

Each chunk's logits keep the product's float32 accumulator, as JAX's
``preferred_element_type=float32`` does: with bf16 operands the product runs
on the tensor cores and is never rounded to bf16 (``_ChunkLogits``). Its
backward multiplies the float32 cotangent cast to the operands' dtype.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e30
VOCAB_PAD = 128


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          z_loss: float = 0.0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-level CE. logits: [..., vocab] (any dtype), labels: [...] int,
    mask: [...] {0, 1}. Returns (mean loss, token count), both float32; the
    logsumexp runs in float32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    label_logits = logits.gather(-1, labels.long()[..., None])[..., 0]
    loss = lse - label_logits
    if z_loss > 0.0:
        loss = loss + z_loss * lse.square()
    if mask is None:
        n = torch.tensor(float(loss.numel()), device=loss.device)
        return loss.mean(), n
    mask = mask.float()
    n = mask.sum().clamp(min=1.0)
    return (loss * mask).sum() / n, n


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with a float32 result: bf16 operands are multiplied exactly and
    summed in float32, never rounded to bf16."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()  # the CPU has no mixed-dtype product


class _ChunkLogits(torch.autograd.Function):
    """x [C, D] @ w [V', D]^T -> float32 logits [C, V']. The backward's
    products take the cotangent in the operands' dtype and return grads in
    it, as XLA's transpose of the JAX product does."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _mm_f32(x, w.T)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = g @ w if ctx.needs_input_grad[0] else None
        dw = g.T @ x if ctx.needs_input_grad[1] else None
        return dx, dw


def _chunk_loss(x, w, col_bias, labels, mask, z_loss: float):
    """Summed masked CE of one token chunk; x [C, D] and w [V', D] in the
    compute dtype; the logits are the product's float32 result."""
    logits = _ChunkLogits.apply(x, w) + col_bias
    lse = torch.logsumexp(logits, dim=-1)
    per_tok = lse - logits.gather(-1, labels[:, None])[:, 0]
    if z_loss > 0.0:
        per_tok = per_tok + z_loss * lse.square()
    return (per_tok * mask).sum()


def fused_softmax_cross_entropy(hidden: torch.Tensor, table: torch.Tensor,
                                labels: torch.Tensor,
                                mask: Optional[torch.Tensor] = None, *,
                                z_loss: float = 0.0, chunk: int = 2048,
                                transpose_table: bool = False,
                                compute_dtype: torch.dtype = torch.bfloat16
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Projection-fused token CE: logits are ``hidden @ table^T``, one token
    chunk at a time. hidden: [..., D] (after the final norm); table: [V, D]
    (tied embedding) or [D, V] with ``transpose_table`` (untied lm_head);
    labels: [...] int; mask: [...] {0, 1}. Returns (mean loss, token
    count), as ``softmax_cross_entropy``.

    The vocab axis is padded to a multiple of 128 with a -1e30 bias on the
    pad columns, so they add nothing to the logsumexp; the token axis is
    padded to a multiple of the chunk with mask 0."""
    if transpose_table:
        table = table.T
    V, D = table.shape
    x = hidden.reshape(-1, D).to(compute_dtype)
    n_tok = x.shape[0]
    labels = labels.reshape(-1).long()
    m = (torch.ones(n_tok, device=x.device) if mask is None
         else mask.reshape(-1).float())
    chunk = min(chunk, n_tok)
    pad_n = (-n_tok) % chunk
    if pad_n:
        x = F.pad(x, (0, 0, 0, pad_n))
        labels = F.pad(labels, (0, pad_n))
        m = F.pad(m, (0, pad_n))
    pad_v = (-V) % VOCAB_PAD
    w = table.to(compute_dtype)
    if pad_v:
        w = F.pad(w, (0, 0, 0, pad_v))
    col_bias = torch.where(torch.arange(V + pad_v, device=x.device) < V,
                           0.0, NEG_INF).float()
    total = torch.zeros((), device=x.device)
    for i in range(0, x.shape[0], chunk):
        total = total + checkpoint(
            _chunk_loss, x[i:i + chunk], w, col_bias, labels[i:i + chunk],
            m[i:i + chunk], z_loss, use_reentrant=False)
    n = (torch.tensor(float(n_tok), device=x.device) if mask is None
         else m.sum().clamp(min=1.0))
    return total / n, n
