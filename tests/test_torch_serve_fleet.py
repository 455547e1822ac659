"""The serve fleet of the port: prefix affinity, shared weights and page
migration, on one local cluster of the port's runtime.

  * Parity: the port's ``AffinityIndex`` and its router's steering against
    the JAX package's, given the same digests and chains: the same picks
    (the pow-2 fallback under one ``random`` seed), hints and skew and
    fail-mark fallbacks.
  * Two replicas of llama_debug (float32, on the CPU, the weights of one
    JAX ``init_params`` converted by ``convert.from_jax``) through
    ``serve.run``: one publishes the tree into the node's arena, the other
    attaches (the arena grows by one tree's bytes), the leaves are bit-equal
    to the JAX weights, a write to one replica's params leaves the other's
    and the shared copy unchanged, and a killed attacher's pins are swept.
  * Affinity steers a prompt to the replica holding its prefix; a hinted
    request pulls the pages from the holder (``m_migrated_pages`` > 0 in
    the puller) with its text unchanged; a failed pull degrades to a cold
    prefill with the same text.
"""

import asyncio
import os
import random
import threading
import time
from functools import partial

import jax
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu.models import presets as jpresets
from ray_tpu.models import transformer as jtransformer
from ray_tpu.serve._private import affinity as jaffinity
from ray_tpu.serve._private.router import Router as JaxRouter
from ray_tpu.serve.llm import LLMServerImpl as JaxLLMServerImpl
from ray_tpu_torch import serve
from ray_tpu_torch._private import api as rt_api
from ray_tpu_torch.serve._private import affinity
from ray_tpu_torch.serve._private.controller import CONTROLLER_NAME
from ray_tpu_torch.serve._private.router import Router
from ray_tpu_torch.serve.llm import LLMServerImpl

os.environ.setdefault("RAY_TPU_TORCH_LOG_LEVEL", "WARNING")

TIMEOUT = 60
NEW = 6
SERVER_KW = dict(max_new_tokens=NEW, slots=4, prefill_chunk=8, page_tokens=4)
KEY = "llm:llama_debug:jax-seed0"
PREFIX = "shared preamble long enough to span multiple kv pages ok. "


# ------------------------------------------------------------ parity

class _Aid:
    def __init__(self, h):
        self._h = h

    def hex(self):
        return self._h


class _Rep:
    def __init__(self, h):
        self._actor_id = _Aid(h)


def _router(cls, keys=("a", "b", "c"), skew=4):
    """A router with its replica set installed directly: steering and its
    fallbacks are functions of this state alone, no control plane."""
    r = cls(controller=None, app_name="t", deployment_name="t")
    r._digest_thread = threading.current_thread()
    r._poll_thread = threading.current_thread()
    r._replicas = [_Rep(k) for k in keys]
    r._key_to_idx = {k: i for i, k in enumerate(keys)}
    r._inflight = {i: 0 for i in range(len(keys))}
    r._affinity_skew = skew
    return r


def _digests(holders, pt=4):
    return {"version": 1, "digests": {
        key: {"page_tokens": pt, "vocab_size": 256, "tok": "byte",
              "hashes": affinity.chain_hashes(toks, pt)}
        for key, toks in holders.items()}}


TOKS = list(range(16))
CASES = {
    # name: (holders, chain tokens, in-flight, fail-marked keys, skew)
    "deepest": ({"a": TOKS[:8], "b": TOKS}, TOKS, (0, 0, 0), (), 4),
    "shallow_only": ({"a": TOKS[:8]}, TOKS, (0, 0, 0), (), 4),
    "at_skew_bound": ({"b": TOKS}, TOKS, (0, 2, 0), (), 2),
    "past_skew_bound": ({"b": TOKS}, TOKS, (0, 3, 0), (), 2),
    "fail_marked_holder": ({"b": TOKS}, TOKS, (0, 0, 0), ("b",), 4),
    "no_match": ({"b": TOKS}, [99] * 16, (0, 0, 0), (), 4),
    "skewed_and_busy": ({"a": TOKS, "c": TOKS[:4]}, TOKS, (7, 1, 0), (), 4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_steering_matches_jax(case):
    """The same digests, chain, loads and fail marks give the JAX router
    and the port's the same pick, the same hint (holder and tokens) and the
    same index view, over 20 picks under one random seed each."""
    holders, toks, loads, failing, skew = CASES[case]
    payload = _digests(holders)
    chain = affinity.chain_hashes(toks, 4)
    assert chain == jaffinity.chain_hashes(toks, 4)
    picks = {}
    for name, cls in (("jax", JaxRouter), ("port", Router)):
        r = _router(cls, skew=skew)
        r._affinity.update(payload)
        for key in failing:
            r._note_result(key, ok=False)
        out = []
        for seed in range(20):
            r._inflight = dict(enumerate(loads))
            random.seed(seed)
            idx, rep, hint = r._pick(chain=chain)
            out.append((idx, None if hint is None else (
                hint["handle"]._actor_id.hex(), hint["tokens"])))
        picks[name] = out
        assert r._affinity.steer(chain, ["a", "b", "c"]) == \
            jaffinity_steer(payload, chain)
    assert picks["port"] == picks["jax"]


def jaffinity_steer(payload, chain):
    idx = jaffinity.AffinityIndex()
    idx.update(payload)
    return idx.steer(chain, ["a", "b", "c"])


def test_affinity_index_and_chains_match_jax():
    """Tokenization, chains for prompts and explicit ids, depth and
    readiness agree; ``_attach_hint`` copies the request in both."""
    port, jx = affinity.AffinityIndex(), jaffinity.AffinityIndex()
    assert not port.ready() and port.chain_for("x") == jx.chain_for("x")
    payload = _digests({"a": [b for b in PREFIX.encode()]})
    port.update(payload)
    jx.update(payload)
    for prompt in (PREFIX + "q", "hello", PREFIX[:20]):
        assert port.tokenize(prompt) == jx.tokenize(prompt)
        assert port.chain_for(prompt) == jx.chain_for(prompt)
        chain = port.chain_for(prompt)
        assert port.depth("a", chain) == jx.depth("a", chain)
    ids = list(range(9))
    assert port.chain_for(prompt_ids=ids) == jx.chain_for(prompt_ids=ids)
    assert port.stats() == jx.stats()
    req = {"prompt": "p", "max_new_tokens": 3}
    hint = {"handle": "h", "tokens": 8}
    assert Router._attach_hint((req,), hint) == \
        JaxRouter._attach_hint((req,), hint)
    assert "_fleet_hint" not in req
    r, j = _router(Router), _router(JaxRouter)
    r._affinity.update(payload)
    j._affinity.update(payload)
    for args in ((123,), (), ({"op": "sum"},), ({"prompt_ids": ids},),
                 (PREFIX + "q",)):
        assert r._affinity_chain(args) == j._affinity_chain(args)


# -------------------------------------------------------- the fleet

@pytest.fixture(scope="module")
def jax_run():
    """JAX's in-process replica on one JAX init: its texts for the prompts
    below, and the weights as a numpy tree."""
    cfg = jpresets.llama_debug()
    params = jax.jit(partial(jtransformer.init_params, cfg))(
        jax.random.PRNGKey(0))
    srv = JaxLLMServerImpl(share_weights=False, attn="reference",
                           params_loader=lambda c: params, **SERVER_KW)
    try:
        texts = {p: asyncio.run(srv({"prompt": p}))["text"]
                 for p in _prompts()}
    finally:
        srv.shutdown()
    return texts, jax.tree.map(np.asarray, params)


def _prompts():
    return [PREFIX + f"q{i}" for i in range(4)] + ["hi", "hello 123"]


def _load_from_ref(boxed, cfg):
    from ray_tpu_torch import convert

    return convert.from_jax(rt.get(boxed[0], timeout=TIMEOUT))


def _flat(params):
    from ray_tpu_torch.models.transformer import map_params

    out = {}
    map_params(lambda path, t: out.__setitem__(path, t.detach().clone()),
               params)
    return out


class FleetProbe(LLMServerImpl):
    """The LLM deployment with a few probes into its replica process."""

    def params_flat(self):
        return _flat(self.params)

    def shared_flat(self):
        return _flat(self._host_params)

    def poke(self):
        """Write into this replica's own params (``unpoke`` restores
        them)."""
        from ray_tpu_torch.models.transformer import map_params

        self._saved = _flat(self.params)
        map_params(lambda _p, t: t.add_(1.0), self.params)

    def unpoke(self):
        from ray_tpu_torch.models.transformer import map_params

        map_params(lambda path, t: t.copy_(self._saved[path]), self.params)

    def fleet_counters(self):
        return {"migrated_pages": affinity.m_migrated_pages.total(),
                "migrations": affinity.m_migrations.total()}

    def pid(self):
        return os.getpid()


class Attacher:
    """A plain actor that attaches to the published tree and holds it."""

    def attach(self):
        from ray_tpu_torch.serve._private import weights

        def refuse():
            raise AssertionError("the tree must come from the arena")

        self.params, info = weights.get_or_publish(KEY, refuse)
        return info


def _store():
    core = rt_api._core
    return core._run(core.clients.get(core.supervisor_addr).call(
        "store_stats"), timeout=TIMEOUT)


def _used(st):
    return st["capacity"] - st["free_bytes"]


@pytest.fixture(scope="module")
def fleet(jax_run):
    """Two replicas behind one handle, sharing one arena copy. Yields the
    handle, the replica handles ordered (publisher, attacher), their
    weights infos, and the arena's used bytes before the deploy."""
    _, tree = jax_run
    rt.init(num_cpus=16, num_gpus=0, object_store_memory=256 * 1024 * 1024)
    try:
        boxed = [rt.put(tree)]
        used0 = _used(_store())
        dep = serve.deployment(name="llm", max_ongoing_requests=32)(
            FleetProbe).options(num_replicas=2)
        h = serve.run(dep.bind(
            device="cpu", weights_key=KEY, attn="reference",
            params_loader=partial(_load_from_ref, boxed), **SERVER_KW),
            name="fleet", route_prefix="/fleet", timeout_s=120)
        ctl = rt.get_actor(CONTROLLER_NAME)
        reps = rt.get(ctl.get_replicas.remote("fleet", "llm"),
                      timeout=TIMEOUT)["replicas"]
        infos = [_call(r, "weights_info") for r in reps]
        order = sorted(range(2), key=lambda i: infos[i]["mode"] != "published")
        yield (h, [reps[i] for i in order], [infos[i] for i in order],
               used0)
    finally:
        serve.shutdown()
        rt.shutdown()


def _call(rep, method, *args):
    return rt.get(rep.handle_request.remote(method, args, {}),
                  timeout=TIMEOUT)


def test_one_arena_copy_published_and_attached(fleet, jax_run):
    _, reps, infos, used0 = fleet
    assert [i["mode"] for i in infos] == ["published", "attached"]
    assert all(i["shared"] and i["key"] == KEY for i in infos)
    nbytes = infos[0]["nbytes"]
    assert nbytes == infos[1]["nbytes"] > 0
    grown = _used(_store()) - used0
    # one tree in the arena (plus a little framing), not two
    assert nbytes <= grown < 1.5 * nbytes, (grown, nbytes)
    from ray_tpu_torch import convert

    want = _flat(convert.from_jax(jax_run[1]))
    for rep in reps:
        got = _call(rep, "params_flat")
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k


def test_a_write_to_one_replica_reaches_no_other(fleet, jax_run):
    _, reps, _, _ = fleet
    before = _call(reps[1], "params_flat")
    shared = _call(reps[0], "shared_flat")
    _call(reps[0], "poke")
    try:
        poked = _call(reps[0], "params_flat")
        other = _call(reps[1], "params_flat")
        for k in before:
            assert not torch.equal(poked[k], before[k]), k
            assert torch.equal(other[k], before[k]), k
        for rep in reps:  # the shared copy is as it was
            now = _call(rep, "shared_flat")
            assert all(torch.equal(now[k], shared[k]) for k in shared)
    finally:
        _call(reps[0], "unpoke")
    restored = _call(reps[0], "params_flat")
    assert all(torch.equal(restored[k], before[k]) for k in before)


def test_a_killed_attachers_pins_are_swept(fleet):
    pins0 = _store()["pins_total"]
    a = rt.remote(Attacher).remote()
    info = rt.get(a.attach.remote(), timeout=TIMEOUT)
    assert info["mode"] == "attached"
    pinned = _store()["pins_total"]
    assert pinned > pins0
    rt.kill(a)
    deadline = time.monotonic() + 30
    while _store()["pins_total"] > pins0 and time.monotonic() < deadline:
        time.sleep(0.2)
    assert _store()["pins_total"] == pins0


def test_affinity_steers_to_the_holder(fleet, jax_run):
    """With one replica holding the prefix, the router's digest view steers
    prompts that share it to that replica, one at a time."""
    h, reps, _, _ = fleet
    texts, _ = jax_run
    holder = reps[1]
    assert _call(holder, "__call__", {"prompt": _prompts()[0]})["text"] \
        == texts[_prompts()[0]]
    router = h._get_router()
    key = Router._replica_key(holder)
    h.remote({"prompt": "hi"}).result(timeout=TIMEOUT)  # polls running
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        with router._lock:
            chain = router._affinity.chain_for(_prompts()[1])
            if router._affinity.depth(key, chain) > 0:
                break
        time.sleep(0.2)
    else:
        pytest.fail("the holder's digest never reached the router")
    before = [_call(r, "scheduler_stats")["admitted"] for r in reps]
    hits0 = affinity.m_affinity_hits.total()
    for p in _prompts()[1:4]:
        assert h.remote({"prompt": p}).result(timeout=TIMEOUT)["text"] == \
            texts[p]
    after = [_call(r, "scheduler_stats")["admitted"] for r in reps]
    assert after[1] - before[1] == 3 and after[0] == before[0]
    assert affinity.m_affinity_hits.total() - hits0 == 3


@rt.remote
class _Gone:
    def export_prefix(self, tokens, timeout_s=30.0):
        return {}


def test_hinted_request_migrates_pages(fleet, jax_run):
    """A request hinted at the holder pulls its prefix pages before
    admission (the holder's export, the puller's splice); the text is the
    JAX replica's. A hint at a dead holder degrades to a cold prefill with
    the same text."""
    _, reps, _, _ = fleet
    texts, _ = jax_run
    # the holder already caches PREFIX (the affinity test), the puller not
    puller, holder = reps
    p = PREFIX + "migrate"
    want = _call(holder, "__call__", {"prompt": p})["text"]
    n = len(p.encode()) // 4 * 4
    st0 = _call(puller, "scheduler_stats")
    c0 = _call(puller, "fleet_counters")
    out = _call(puller, "__call__", {"prompt": p, "_fleet_hint": {
        "handle": holder, "tokens": n}})
    st = _call(puller, "scheduler_stats")
    c = _call(puller, "fleet_counters")
    assert out["text"] == want
    assert st["migrations"] - st0["migrations"] == 1
    assert c["migrated_pages"] - c0["migrated_pages"] == \
        st["migrated_pages"] - st0["migrated_pages"] > 0
    assert st["prefix_hits"] - st0["prefix_hits"] == 1
    assert st["radix_active_refs"] == 0 and st["migrations_pending"] == 0

    gone = _Gone.remote()
    rt.get(gone.export_prefix.remote([]), timeout=TIMEOUT)
    rt.kill(gone)
    q = PREFIX + "cold"
    cold = _call(holder, "__call__", {"prompt": q})["text"]
    out = _call(puller, "__call__", {"prompt": q, "_fleet_hint": {
        "handle": gone, "tokens": n}})
    st2 = _call(puller, "scheduler_stats")
    assert out["text"] == cold
    assert st2["migration_failures"] - st["migration_failures"] == 1
    assert st2["migrations"] == st["migrations"]
    assert st2["radix_active_refs"] == 0


@pytest.mark.parametrize("big", [False, True])
def test_arena_write_in_pieces_equals_pack(big):
    """A published tree reaches the arena through ``write_packed``; past
    64 MiB of buffers it copies them in 16 MiB pieces on a few threads.
    Either way the bytes are ``pack``'s, and bf16 comes back bit for bit."""
    from ray_tpu_torch._private import serialization

    rng = np.random.default_rng(0)
    size = (70 << 20) + 12345 if big else 1000
    obj = {"skeleton": {"w": ("bfloat16", (3, 5), 0)},
           "leaves": [torch.randn(3, 5, dtype=torch.bfloat16),
                      rng.integers(0, 255, size, dtype=np.uint8),
                      np.zeros(0, np.uint8)]}
    meta, bufs, total = serialization.packed_size(obj)
    dest = bytearray(total)
    assert serialization.write_packed(memoryview(dest), meta, bufs) == total
    assert bytes(dest) == serialization.pack(obj)
    back = serialization.unpack(memoryview(dest))
    assert torch.equal(back["leaves"][0].view(torch.int16),
                       obj["leaves"][0].view(torch.int16))
    assert np.array_equal(back["leaves"][1], obj["leaves"][1])
