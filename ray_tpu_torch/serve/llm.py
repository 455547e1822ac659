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
init. Prompts go through the byte tokenizer.

``drafter`` turns on speculative decoding (``serve/_private/
speculative.py``): ``"self"`` drafts with the replica's own params, a preset
name with that preset's params from a seeded random init, ``""`` or ``None``
means off; ``spec_k`` is the draft tokens per round. The JAX package also
reads both from environment variables; here the arguments carry the same
defaults.

Not ported yet: the serve deployment wrapper, the per-node shared weights
arena, the request-level ``scheduler="batch"`` path, custom tokenizers and
EOS handling.
"""

from __future__ import annotations

import asyncio
from functools import partial
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models import presets
from ray_tpu_torch.models.transformer import init_params, place_params
from ray_tpu_torch.serve._private.continuous import ContinuousScheduler
from ray_tpu_torch.serve._private.speculative import Drafter


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
                 drafter: Optional[str] = None,
                 spec_k: int = 4,
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
            page_tokens=page_tokens,
            drafter=self._build_drafter(drafter, slots, arena_len),
            spec_k=spec_k)

    def _build_drafter(self, drafter: Optional[str], slots: int,
                       arena_len: Optional[int]) -> Optional[Drafter]:
        """The drafter knob as a ``speculative.Drafter`` (``""``/``None``:
        off). ``"self"`` reuses this replica's params (no extra weight
        memory, KV adopted from the paged cache); any other name is a
        preset whose params come from a seeded random init on this
        replica's device. A drafter must share the target's vocabulary, or
        its proposals would be meaningless token ids."""
        if not drafter:
            return None
        arena = self.cfg.max_seq_len if arena_len is None else arena_len
        if drafter == "self":
            d_cfg, d_params, shares = self.cfg, self.params, True
        else:
            try:
                d_cfg = getattr(presets, drafter)()
            except AttributeError:
                raise ValueError(f"unknown drafter preset {drafter!r}")
            if d_cfg.vocab_size != self.cfg.vocab_size:
                raise ValueError(
                    f"drafter {drafter!r} vocab_size ({d_cfg.vocab_size}) "
                    f"!= target vocab_size ({self.cfg.vocab_size})")
            d_params = place_params(
                d_cfg, init_params(d_cfg, seed=0, device=self.device),
                self.device)
            shares = False
        if arena > d_cfg.max_seq_len:
            raise ValueError(
                f"drafter {drafter!r} max_seq_len ({d_cfg.max_seq_len}) is "
                f"shorter than the serving arena ({arena})")
        return Drafter(d_cfg, d_params, slots=slots, arena_len=arena,
                       device=self.device, name=drafter,
                       shares_target=shares)

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
