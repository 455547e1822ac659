"""LLM decode replica on the continuous paged scheduler.

Counterpart: the continuous path of ``ray_tpu/serve/llm.py``
(``LLMServerImpl``). A replica owns the model's weights on its device and a
``ContinuousScheduler`` over a paged KV arena with a radix prefix cache;
requests are admitted between decode iterations, prefilled in chunks and
streamed token by token.

The replica runs on the CUDA card unless the caller passes ``device="cpu"``
(as the tests do); with no card and no device named it raises. Weights come
from ``params_loader(cfg)`` (the port's param tree, e.g. converted from JAX
by ``ray_tpu_torch._private.convert.from_jax``) or from a seeded random
init. Prompts go through the byte tokenizer. The serve deployment wrapper,
the per-node shared weights arena, custom tokenizers and EOS handling are
not ported yet.
"""

from __future__ import annotations

import asyncio
from functools import partial
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models import presets
from ray_tpu_torch.models.transformer import init_params, place_params
from ray_tpu_torch.serve._private.continuous import ContinuousScheduler


def _byte_tokenize(text: str, vocab_size: int) -> List[int]:
    """Byte-level toy tokenizer (every preset has vocab >= 256)."""
    return [b % vocab_size for b in text.encode("utf-8")]


def _byte_detokenize(ids: List[int]) -> str:
    return bytes(int(i) % 256 for i in ids).decode("utf-8", errors="replace")


class LLMServerImpl:
    """One model replica: its weights on ``device`` and its continuous
    scheduler."""

    def __init__(self, preset: str = "llama_debug",
                 max_new_tokens: int = 16,
                 temperature: float = 0.0,
                 params_loader=None,
                 slots: int = 8,
                 prefill_chunk: int = 32,
                 arena_len: Optional[int] = None,
                 page_tokens: int = 16,
                 device=None):
        self.device = resolve_device(device)
        self.cfg = getattr(presets, preset)()
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self._seq_counter = 0
        if params_loader is not None:
            params = params_loader(self.cfg)
        else:
            params = init_params(self.cfg, seed=0, device=self.device)
        self.params = place_params(self.cfg, params, self.device)
        self._tokenize = partial(_byte_tokenize,
                                 vocab_size=self.cfg.vocab_size)
        self._detokenize = _byte_detokenize
        self._sched = ContinuousScheduler(
            self.cfg, self.params, device=self.device, slots=slots,
            prefill_chunk=prefill_chunk, arena_len=arena_len,
            page_tokens=page_tokens)

    def _submit(self, ids: List[int], max_new: int, temperature: float):
        loop = asyncio.get_running_loop()
        q: asyncio.Queue = asyncio.Queue()
        self._seq_counter += 1
        seq = self._sched.submit(
            ids, max_new_tokens=max_new, temperature=temperature,
            seed=self._seq_counter, loop=loop, queue=q)
        return seq, q

    async def _run_continuous(self, ids: List[int], max_new: int,
                              temperature: float) -> List[int]:
        seq, q = self._submit(ids, max_new, temperature)
        toks: List[int] = []
        try:
            while True:
                kind, val = await q.get()
                if kind == "tok":
                    toks.append(val)
                elif kind == "end":
                    return toks
                else:
                    raise RuntimeError(f"generation failed: {val}")
        except asyncio.CancelledError:
            self._sched.cancel(seq)
            raise

    async def _stream_continuous(self, ids: List[int], max_new: int,
                                 temperature: float):
        """Streaming consumes the scheduler's per-slot token queue.
        Abandoning the generator cancels the sequence."""
        seq, q = self._submit(ids, max_new, temperature)
        try:
            while True:
                kind, val = await q.get()
                if kind == "tok":
                    yield self._detokenize([val])
                elif kind == "end":
                    return
                else:
                    raise RuntimeError(f"generation failed: {val}")
        finally:
            self._sched.cancel(seq)

    async def __call__(self, request: Optional[Dict[str, Any]] = None):
        request = request or {}
        if isinstance(request, str):
            request = {"prompt": request}
        prompt = request.get("prompt", "")
        ids = self._tokenize(prompt)
        if not ids:
            raise ValueError("prompt must be non-empty")
        max_new = int(request.get("max_new_tokens", self.max_new_tokens))
        temperature = float(request.get("temperature", self.temperature))
        if request.get("stream"):
            return self._stream_continuous(ids, max_new, temperature)
        out_ids = await self._run_continuous(ids, max_new, temperature)
        return {"prompt": prompt, "text": self._detokenize(out_ids),
                "num_tokens": len(out_ids)}

    def scheduler_stats(self) -> Dict[str, Any]:
        return self._sched.stats()

    def check_health(self) -> bool:
        return not self._sched.closed

    def shutdown(self) -> None:
        self._sched.shutdown()

    def __del__(self):
        sched = getattr(self, "_sched", None)
        if sched is not None:
            sched.shutdown()
