"""LLM decode replica.

Counterpart: ``ray_tpu/serve/llm.py`` (``LLMServerImpl``). A replica owns
the model's weights on its device and one of two schedulers:

  * ``scheduler="continuous"`` (the default): a ``ContinuousScheduler``
    over a paged KV arena with a radix prefix cache (or, with
    ``kv_layout="contiguous"``, a slot arena); requests are admitted
    between decode iterations, prefilled in chunks and streamed token by
    token. ``eos_id``, ``kv_layout``, ``page_tokens``, ``kv_pages``,
    ``prefix_cache``, ``attn`` and ``cache_dtype`` pass through to it.
  * ``scheduler="batch"``: the request-level baseline, flush and drain.
    ``serve.batch`` coalesces up to ``max_batch_size`` requests; a flush
    groups them by prompt length and runs each group's prefill and whole
    decode loop over contiguous caches (``models/decode.py``) to the end
    before any new request is taken. A stream runs its own single-sequence
    loop. The work runs on an executor thread, never on the event loop.
    It refuses a budget below 1 or past ``cfg.max_seq_len`` and a
    per-request temperature, and, as in JAX, ignores ``eos_id``. It samples
    on the host: greedy at temperature 0, and above it from a seeded
    ``torch.Generator``, which cannot draw JAX's ``jax.random`` stream, so
    only its temperature-0 texts equal the JAX replica's.

The replica runs on the CUDA card unless the caller passes ``device="cpu"``
(as the tests do); with no card and no device named it raises. Weights come
from ``params_loader(cfg)`` (the port's param tree, e.g. converted from JAX
by ``ray_tpu_torch._private.convert.from_jax``) or from a seeded random
init; ``preset_overrides`` change the preset's fields. Prompts go through
``tokenize``/``detokenize`` (default: the byte tokenizer), or arrive as
token ids under the request key ``prompt_ids``.

``drafter`` turns on speculative decoding (``serve/_private/
speculative.py``): ``"self"`` drafts with the replica's own params, a preset
name with that preset's params from a seeded random init, ``""`` or ``None``
means off; ``spec_k`` is the draft tokens per round. The JAX package also
reads both from environment variables; here the arguments carry the same
defaults.

As a deployment: ``LLMServer`` is ``LLMServerImpl`` under
``serve.deployment`` (``build_app`` binds it), so ``serve.run`` starts it
in a ``ReplicaActor`` behind the affinity router. The weights are shared
per node by default (``share_weights=True``): the first replica on a node
publishes its host params into the node's object arena and later replicas
attach read-only views with no extra arena bytes
(``serve/_private/weights.py``; ``weights_info()`` says which); each
replica then copies them once onto its device. A custom ``params_loader``
shares only under an explicit ``weights_key``. ``export_prefix`` serves a
peer replica's page-migration pull, and a request carrying the router's
``_fleet_hint`` pulls its prefix pages from the holder first
(``migration_budget`` pages at most).

Not ported yet (ROADMAP A5): the weights broadcast to a new node
(``weights_bcast``, ``push_weights``), which needs the collective group
API. Both raise ``NotImplementedError``.
"""

from __future__ import annotations

import asyncio
import threading
from functools import partial
from typing import Any, Dict, List, Optional

import torch

import ray_tpu_torch.serve as serve
from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models import presets
from ray_tpu_torch.models.decode import (decode_step, init_caches, prefill,
                                         sample_token)
from ray_tpu_torch.models.transformer import init_params, place_params
from ray_tpu_torch.serve._private import weights as _weights
from ray_tpu_torch.serve._private.continuous import ContinuousScheduler
from ray_tpu_torch.serve._private.speculative import Drafter

_A5 = ("needs the collective group API, which is not ported yet "
       "(ROADMAP A5)")


def _byte_tokenize(text: str, vocab_size: int) -> List[int]:
    """Byte-level toy tokenizer (every preset has vocab >= 256)."""
    return [b % vocab_size for b in text.encode("utf-8")]


def _byte_detokenize(ids: List[int]) -> str:
    return bytes(int(i) % 256 for i in ids).decode("utf-8", errors="replace")


class LLMServerImpl:
    """One model replica: its weights on ``device`` and its scheduler.
    Weights are shared per node through the object arena unless
    ``share_weights=False``."""

    def __init__(self, preset: str = "llama_debug",
                 preset_overrides: Optional[Dict[str, Any]] = None,
                 max_new_tokens: int = 16,
                 temperature: float = 0.0,
                 max_batch_size: int = 8,
                 params_loader=None,
                 tokenize=None, detokenize=None,
                 scheduler: str = "continuous",
                 slots: int = 8,
                 prefill_chunk: int = 32,
                 arena_len: Optional[int] = None,
                 kv_layout: str = "paged",
                 page_tokens: int = 16,
                 kv_pages: int = 0,
                 prefix_cache: Optional[bool] = None,
                 share_weights: bool = True,
                 weights_key: Optional[str] = None,
                 weights_bcast: Optional[Dict[str, Any]] = None,
                 eos_id: Optional[int] = None,
                 drafter: Optional[str] = None,
                 spec_k: int = 4,
                 migration_budget: Optional[int] = None,
                 attn: Optional[str] = None,
                 cache_dtype: Optional[torch.dtype] = None,
                 device=None):
        if scheduler not in ("continuous", "batch"):
            raise ValueError(
                f"scheduler must be 'continuous' or 'batch', got "
                f"{scheduler!r}")
        self.device = resolve_device(device)
        # preset fields (e.g. a wider max_seq_len) are overridable per
        # deployment; the KV arena and admission limits follow cfg
        self.cfg = getattr(presets, preset)(**(preset_overrides or {}))
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self._max_batch = max_batch_size
        self._cache_dtype = cache_dtype
        self._seq_counter = 0
        if weights_bcast is not None:
            raise NotImplementedError(
                f"weights_bcast (receiving the weights over a broadcast) "
                f"{_A5}")

        def load():
            if params_loader is not None:
                return params_loader(self.cfg)
            return init_params(self.cfg, seed=0, device=self.device)

        # a custom loader has no stable identity to share under: it opts
        # in with an explicit weights_key
        if share_weights and (params_loader is None
                              or weights_key is not None):
            # preset overrides change the parameter shapes: fold them into
            # the default key so differently configured deployments never
            # attach to each other's arena copy
            ov = ""
            if preset_overrides:
                ov = ":" + ",".join(f"{k}={preset_overrides[k]}"
                                    for k in sorted(preset_overrides))
            key = weights_key or f"llm:{preset}{ov}:seed0"
            host, self._weights_info = _weights.get_or_publish(key, load)
        else:
            host, self._weights_info = load(), {"mode": "local",
                                                "shared": False}
        # one private copy on the device; the shared host copy stays in
        # the node arena, and _host_params keeps its read-only views (and
        # their pins) alive for this replica's lifetime
        self._host_params = host if self._weights_info["shared"] else None
        self.params = place_params(self.cfg, host, self.device)
        del host
        self._tokenize = tokenize or partial(
            _byte_tokenize, vocab_size=self.cfg.vocab_size)
        self._detokenize = detokenize or _byte_detokenize
        # a router can steer on prompts it can tokenize itself: the byte
        # tokenizer's; custom tokenizers need prompt_ids in the request
        self._byte_tok = tokenize is None
        # the batch path's sampler: one seeded host generator, shared by
        # flushes that run on executor threads
        self._generator = torch.Generator().manual_seed(0)
        self._generator_lock = threading.Lock()
        # the deploy-time batch size overrides serve.batch's default
        setattr(self, "__serve_batch_size__generate_batch", max_batch_size)
        self._sched = None
        if scheduler == "continuous":
            self._sched = ContinuousScheduler(
                self.cfg, self.params, device=self.device, slots=slots,
                prefill_chunk=prefill_chunk, arena_len=arena_len,
                eos_id=eos_id, cache_dtype=cache_dtype, kv_layout=kv_layout,
                page_tokens=page_tokens, kv_pages=kv_pages,
                prefix_cache=prefix_cache,
                drafter=self._build_drafter(drafter, slots, arena_len),
                spec_k=spec_k, migration_budget=migration_budget, attn=attn)
        elif drafter:
            raise ValueError(
                "speculative decoding (drafter=...) requires "
                "scheduler='continuous'")
        elif attn is not None:
            raise ValueError(
                "attn lane selection (attn=...) requires "
                "scheduler='continuous' with kv_layout='paged'")

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

    def _submit(self, ids: List[int], max_new: int, temperature: float,
                fleet_hint=None):
        loop = asyncio.get_running_loop()
        q: asyncio.Queue = asyncio.Queue()
        self._seq_counter += 1
        seq = self._sched.submit(
            ids, max_new_tokens=max_new, temperature=temperature,
            seed=self._seq_counter, loop=loop, queue=q,
            fleet_hint=fleet_hint)
        return seq, q

    async def _run_continuous(self, ids: List[int], max_new: int,
                              temperature: float,
                              fleet_hint=None) -> List[int]:
        seq, q = self._submit(ids, max_new, temperature, fleet_hint)
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
                                 temperature: float, fleet_hint=None):
        """Streaming consumes the scheduler's per-slot token queue.
        Abandoning the generator cancels the sequence."""
        seq, q = self._submit(ids, max_new, temperature, fleet_hint)
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

    # ------------------------------------------------ request-level path
    # (the measured flush-and-drain baseline: one serve.batch window runs
    # prefill + the WHOLE decode loop before any newly arrived request is
    # admitted)

    @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.02)
    async def _generate_batch(self, items) -> List[List[int]]:
        """Request-level batching: the flush runs every request in it to
        the end. The torch work runs on an executor thread: blocking the
        event loop would stall health checks and streams."""
        return await asyncio.get_running_loop().run_in_executor(
            None, self._generate_batch_sync, items)

    def _generate_batch_sync(self, items) -> List[List[int]]:
        """Group prompts by exact length and run one decode loop per group.
        Padding mixed lengths into one loop would let real tokens attend to
        pad positions (the cache mask has no pad masking); grouping keeps
        every loop exact while still batching the same-shape case."""
        by_len: Dict[int, List[int]] = {}
        for i, (p, _new) in enumerate(items):
            by_len.setdefault(len(p), []).append(i)
        outs: List[List[int]] = [[] for _ in items]
        for indices in by_len.values():
            group = [items[i][0] for i in indices]
            # flush and drain: the group decodes until its LONGEST request
            # is done; shorter requests are cut after
            steps = max(items[i][1] for i in indices)
            for i, out in zip(indices, self._generate_group(group, steps)):
                outs[i] = out[: items[i][1]]
        return outs

    def _sample_host(self, logits: torch.Tensor,
                     generator: torch.Generator) -> List[int]:
        """The batch path's sampler, on the host (greedy at temperature 0,
        else from ``generator``)."""
        host = logits.float().cpu()
        with self._generator_lock:
            return sample_token(host, generator, self.temperature).tolist()

    @torch.no_grad()
    def _generate_group(self, prompts: List[List[int]],
                        new_tokens: int) -> List[List[int]]:
        """One batched decode loop over same-length prompts."""
        batch, length = len(prompts), len(prompts[0])
        tokens = torch.tensor(prompts, dtype=torch.int32, device=self.device)
        caches = init_caches(self.cfg, batch, length + new_tokens,
                             device=self.device, dtype=self._cache_dtype)
        logits = prefill(self.cfg, self.params, tokens, caches)
        outs: List[List[int]] = [[] for _ in range(batch)]
        for step in range(new_tokens):
            tok = self._sample_host(logits, self._generator)
            for out, t in zip(outs, tok):
                out.append(int(t))
            if step + 1 < new_tokens:
                logits = decode_step(
                    self.cfg, self.params,
                    torch.tensor(tok, dtype=torch.int32,
                                 device=self.device)[:, None], caches)
        return outs

    @torch.no_grad()
    def _generate_stream(self, prompt_ids: List[int], new_tokens: int):
        """Streaming under scheduler="batch": a single-sequence decode loop
        owning its own KV cache, one detokenized token per ``next``. Each
        live stream holds a whole decode loop; the continuous path streams
        from the shared arena instead."""
        tokens = torch.tensor([prompt_ids], dtype=torch.int32,
                              device=self.device)
        caches = init_caches(self.cfg, 1, len(prompt_ids) + new_tokens,
                             device=self.device, dtype=self._cache_dtype)
        logits = prefill(self.cfg, self.params, tokens, caches)
        generator = torch.Generator().manual_seed(len(prompt_ids))
        for step in range(new_tokens):
            tok = self._sample_host(logits, generator)
            yield self._detokenize(tok)
            if step + 1 < new_tokens:
                logits = decode_step(
                    self.cfg, self.params,
                    torch.tensor([tok], dtype=torch.int32,
                                 device=self.device), caches)

    async def _stream_batch(self, ids: List[int], max_new: int):
        """Pumps ``_generate_stream`` one token at a time on an executor
        thread (the JAX replica hands its caller the plain generator)."""
        loop = asyncio.get_running_loop()
        gen = self._generate_stream(ids, max_new)
        end = object()
        while True:
            piece = await loop.run_in_executor(None, next, gen, end)
            if piece is end:
                return
            yield piece

    # ------------------------------------------------------------ entry

    async def __call__(self, request: Optional[Dict[str, Any]] = None):
        request = request or {}
        if isinstance(request, str):
            request = {"prompt": request}
        prompt = request.get("prompt", "")
        if request.get("prompt_ids") is not None:
            # explicit token ids (custom-tokenizer clients; also what the
            # affinity router hashed, so steering and execution agree)
            ids = [int(t) for t in request["prompt_ids"]]
        else:
            ids = self._tokenize(prompt)
        if not ids:
            raise ValueError("prompt must be non-empty")
        max_new = int(request.get("max_new_tokens", self.max_new_tokens))
        temperature = float(request.get("temperature", self.temperature))
        # the router's pull hint (the prefix lives on another replica);
        # only the continuous scheduler uses it
        fleet_hint = request.get("_fleet_hint")
        if self._sched is not None:
            if request.get("stream"):
                return self._stream_continuous(ids, max_new, temperature,
                                               fleet_hint)
            out_ids = await self._run_continuous(ids, max_new, temperature,
                                                 fleet_hint)
        else:
            # the request-level path has no per-sequence bound of its own
            # (the continuous scheduler checks at submit): check the budget
            # before it sizes a cache, and refuse a per-request temperature
            # its whole-batch sampler cannot honour
            if max_new < 1:
                raise ValueError("max_new_tokens must be >= 1")
            if len(ids) + max_new > self.cfg.max_seq_len:
                raise ValueError(
                    f"prompt of {len(ids)} tokens + {max_new} new tokens "
                    f"exceeds cfg.max_seq_len ({self.cfg.max_seq_len})")
            if temperature != self.temperature:
                raise ValueError(
                    "per-request temperature requires the continuous "
                    "scheduler (this replica runs scheduler='batch')")
            if request.get("stream"):
                return self._stream_batch(ids, max_new)
            out_ids = await self._generate_batch((ids, max_new))
        return {"prompt": prompt, "text": self._detokenize(out_ids),
                "num_tokens": len(out_ids)}

    # ------------------------------------------------------ introspection

    def scheduler_stats(self) -> Dict[str, Any]:
        if self._sched is not None:
            return self._sched.stats()
        return {"mode": "batch", "max_batch_size": self._max_batch}

    def queue_depth(self) -> int:
        """Requests waiting for a free slot (0 under scheduler="batch")."""
        if self._sched is not None:
            return self._sched.queue_depth()
        return 0

    def prefix_digest(self) -> Dict[str, Any]:
        """The radix cache's chain-hash digest plus what a router needs to
        hash prompts the same way (tokenizer kind and vocabulary). Empty
        when there is nothing to advertise (batch scheduler, contiguous
        layout, prefix cache off)."""
        if self._sched is None:
            return {}
        d = self._sched.prefix_digest()
        if d:
            d = dict(d)
            d["vocab_size"] = self.cfg.vocab_size
            d["tok"] = "byte" if self._byte_tok else "opaque"
        return d

    def export_prefix(self, tokens: List[int],
                      timeout_s: float = 30.0) -> Dict[str, Any]:
        """A peer replica's migration pull: the longest cached prefix of
        ``tokens`` as per-layer K and V pages on the host (replica to
        replica, never through the controller)."""
        if self._sched is None:
            return {"matched_len": 0, "page_tokens": 0, "k": [], "v": []}
        return self._sched.export_prefix(list(tokens), timeout_s=timeout_s)

    def weights_info(self) -> Dict[str, Any]:
        """How this replica got its weights: ``mode`` "published" (the
        node's first replica), "attached" (views of the published copy) or
        "local" (not shared), with the key, node and bytes when shared."""
        return dict(self._weights_info)

    def push_weights(self, group: str, world_size: int,
                     rank: int = 0) -> bool:
        """Root side of a broadcast to replicas on new nodes: not ported
        yet."""
        raise NotImplementedError(f"push_weights {_A5}")

    def check_health(self) -> bool:
        if self._sched is not None and self._sched.closed:
            return False
        return self.params is not None

    def shutdown(self) -> None:
        if self._sched is not None:
            self._sched.shutdown()

    def __del__(self):
        sched = getattr(self, "_sched", None)
        if sched is not None:
            sched.shutdown()


LLMServer = serve.deployment(name="llm", max_ongoing_requests=32)(
    LLMServerImpl)


def build_app(preset: str = "llama_debug", num_replicas: int = 1,
              max_new_tokens: int = 16, temperature: float = 0.0,
              **kwargs) -> "serve.Application":
    """``serve.run(build_app(...))``: the deployable LLM application."""
    dep = LLMServer.options(num_replicas=num_replicas)
    return dep.bind(preset=preset, max_new_tokens=max_new_tokens,
                    temperature=temperature, **kwargs)
