"""Request router with power-of-two-choices replica scheduling.

Counterpart: ``ray_tpu/serve/_private/router.py``. Analog of
`ray.serve._private.router.Router.assign_request`
(`python/ray/serve/_private/router.py:518`) +
`PowerOfTwoChoicesReplicaScheduler`
(`_private/replica_scheduler/pow_2_scheduler.py:49`): sample two replicas,
send to the one with the lower locally-tracked in-flight count.

The replica set is pushed, not polled: a background thread holds a
long-poll (`controller.listen_for_change`) open so config changes land
the moment the controller bumps the version — there is no interval
re-listing and no sleep loop in the request hot path
(≈ `python/ray/serve/_private/long_poll.py` LongPollClient).

PREFIX AFFINITY: a second long-poll
(`controller.listen_for_digests`) mirrors every replica's radix-cache
chain-hash digest into an `AffinityIndex`; the pick path hashes the
incoming prompt's page-aligned prefix and steers to the replica holding
the deepest match — unless that replica is fail-marked or its in-flight
count exceeds the least-loaded replica's by more than the skew bound, in
which case the pick falls back to pow-2 and the chosen replica gets a
``_fleet_hint`` naming the holder so it can PULL the pages itself.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Dict, List, Optional

import ray_tpu_torch as rt
from ray_tpu_torch.serve._private.affinity import (AffinityIndex,
                                                   m_affinity_hits,
                                                   m_affinity_misses)


class _WatchedStream(rt.ObjectRefGenerator):
    """ObjectRefGenerator that reports its terminal state (clean
    exhaustion vs task error) back to the router's per-replica failure
    accounting: a replica that only serves streams must still be
    observed when it starts failing. Subclasses rather than
    wraps so handle-side isinstance(ObjectRefGenerator) checks hold."""

    def __init__(self, inner: rt.ObjectRefGenerator, router: "Router",
                 replica_key: str, mux_id: str = "",
                 inflight_idx: Optional[int] = None):
        super().__init__(inner._task_id, inner._owner_addr)
        # take over stream ownership: the inner generator is dropped
        # right after this call and its __del__ must not release the
        # still-live stream out from under us
        inner._released = True
        self._router = router
        self._replica_key = replica_key
        self._mux_id = mux_id
        # the stream HOLDS its pick's in-flight count until it settles
        # (exhaustion, task error, or consumer abandonment via GC) — a
        # counter released at submit time would make every streaming
        # request invisible to the pow-2 draw AND to the affinity skew
        # bound, letting steering pile streams onto one replica unbounded
        self._inflight_idx = inflight_idx
        self._settled = False

    def _settle(self, ok: Optional[bool] = None) -> None:
        """Release the in-flight count exactly once; optionally feed the
        terminal state into failure accounting."""
        if self._settled:
            return
        self._settled = True
        r = self._router
        idx = self._inflight_idx
        if idx is not None:
            with r._lock:
                if idx in r._inflight and r._inflight[idx] > 0:
                    r._inflight[idx] -= 1
        if ok is not None:
            r._note_result(self._replica_key, ok=ok, mux_id=self._mux_id)

    def _next(self, timeout=None):
        import asyncio
        import concurrent.futures

        try:
            return super()._next(timeout)
        except StopIteration:
            self._settle(ok=True)
            raise
        except (TimeoutError, GeneratorExit, asyncio.CancelledError,
                concurrent.futures.CancelledError):
            # NOT replica failures: a timeout is the CONSUMER's deadline
            # on a slow-but-healthy stream (GetTimeoutError subclasses
            # TimeoutError), GeneratorExit/Cancelled are consumer-side
            # aborts. Marking these would penalize a replica for 10s in
            # the pow-2 draw for merely streaming slowly.
            raise
        except BaseException:
            self._settle(ok=False)
            raise

    next = _next  # re-bind: the base class aliases its own _next

    def __del__(self):
        # consumer dropped the stream mid-iteration: release the count
        # (no terminal verdict — abandonment says nothing about the
        # replica), then let the base class release the stream itself
        try:
            self._settle()
        except Exception:
            pass
        try:
            super().__del__()
        except Exception:
            pass


class Router:
    LONG_POLL_TIMEOUT_S = 30.0

    def __init__(self, controller, app_name: str, deployment_name: str):
        self._controller = controller
        self._app = app_name
        self._deployment = deployment_name
        self._replicas: List[Any] = []
        self._version = -2
        self._inflight: Dict[int, int] = {}
        self._lock = threading.Lock()
        self._update_event = threading.Event()
        self._stopped = False
        self._poll_thread: Optional[threading.Thread] = None
        # multiplexing: model_id -> STABLE replica keys (actor ids, not
        # list indices — a long-poll update reorders/replaces the replica
        # list and index-keyed marks would silently point at different
        # replicas, routing to cold ones until the next mux poll) holding
        # it; refreshed by a background poll only while multiplexed
        # requests flow. Keys translate to indices at pick time.
        self._mux_locations: Dict[str, set] = {}
        self._key_to_idx: Dict[str, int] = {}
        self._mux_thread: Optional[threading.Thread] = None
        # optimistic (model, key) marks with timestamps: kept through
        # refreshes while the model may still be loading on that replica
        self._mux_marks: Dict[tuple, float] = {}
        self._mux_last_request = 0.0
        # replica key -> time of its last observed request failure; fed
        # by unary completions AND stream terminal states (a replica
        # that only serves streams must still be observable),
        # read by _pick to deprioritize recently-failing replicas
        self._fail_marks: Dict[str, float] = {}
        # prefix affinity: replica digests mirrored by a
        # second long-poll; steering happens inside _pick
        from ray_tpu_torch._private.config import global_config

        conf = global_config()
        self._affinity_on = bool(conf.serve_affinity)
        self._affinity_skew = int(conf.serve_affinity_skew)
        self._affinity = AffinityIndex()
        self._digest_thread: Optional[threading.Thread] = None

    FAIL_PENALTY_S = 10.0  # how long a failure skews the pow-2 draw

    def _note_result(self, key: str, ok: bool, mux_id: str = "") -> None:
        with self._lock:
            if ok:
                self._fail_marks.pop(key, None)
            else:
                self._fail_marks[key] = time.monotonic()
                if mux_id:
                    # the optimistic "this replica will hold the model
                    # after this request" insert (assign_request) is now
                    # known false — the request died, likely before the
                    # model loaded. Left in place it steers sibling
                    # requests at a cold (or dead) replica for up to
                    # MUX_MARK_TTL_S; drop it and let the next refresh
                    # poll re-observe reality.
                    self._mux_marks.pop((mux_id, key), None)
                    locs = self._mux_locations.get(mux_id)
                    if locs is not None:
                        locs.discard(key)
                        if not locs:
                            self._mux_locations.pop(mux_id, None)

    @staticmethod
    def _replica_key(rep) -> str:
        aid = getattr(rep, "_actor_id", None)
        return aid.hex() if aid is not None else repr(rep)

    def _ensure_polling(self) -> None:
        if self._poll_thread is None:
            with self._lock:
                if self._poll_thread is None:
                    t = threading.Thread(
                        target=self._poll_loop,
                        name=f"serve-longpoll-{self._deployment}",
                        daemon=True,
                    )
                    self._poll_thread = t
                    t.start()

    def _poll_loop(self) -> None:
        """Keep one listen_for_change call in flight; apply each push.
        If the controller stays unreachable (serve.shutdown), the thread
        retires itself; the next assign_request restarts polling. So it
        does once the runtime is shut down: a call from here would start a
        new local cluster (the API's calls initialize one when none is
        up)."""
        failures = 0
        while not self._stopped:
            if not rt.is_initialized():
                with self._lock:
                    self._replicas = []
                    self._version = -2
                    self._poll_thread = None
                return
            try:
                info = rt.get(
                    self._controller.listen_for_change.remote(
                        self._app, self._deployment, self._version,
                        self.LONG_POLL_TIMEOUT_S),
                    timeout=self.LONG_POLL_TIMEOUT_S + 30,
                )
            except Exception:
                if self._stopped:
                    return
                failures += 1
                if failures >= 10:
                    with self._lock:
                        self._replicas = []
                        self._version = -2
                        self._poll_thread = None
                    return
                time.sleep(min(0.2 * failures, 2.0))
                continue
            failures = 0
            if info["version"] != self._version:
                with self._lock:
                    self._replicas = info["replicas"]
                    self._version = info["version"]
                    self._inflight = {
                        i: 0 for i in range(len(self._replicas))}
                    self._key_to_idx = {
                        self._replica_key(r): i
                        for i, r in enumerate(self._replicas)}
                self._update_event.set()

    def _ensure_digest_polling(self) -> None:
        if self._digest_thread is None:
            with self._lock:
                if self._digest_thread is None:
                    t = threading.Thread(
                        target=self._digest_poll_loop,
                        name=f"serve-digests-{self._deployment}",
                        daemon=True,
                    )
                    self._digest_thread = t
                    t.start()

    def _digest_poll_loop(self) -> None:
        """Mirror replica prefix digests via a long-poll on the
        controller (which in turn reads them off its EXISTING replica
        stats poll — no new steady-state RPC originates at any replica).
        Retires itself if the controller stays unreachable or the runtime
        is shut down; the next affinity-eligible request restarts it."""
        failures = 0
        while not self._stopped:
            if not rt.is_initialized():
                with self._lock:
                    self._digest_thread = None
                return
            with self._lock:
                known = self._affinity.version
            try:
                info = rt.get(
                    self._controller.listen_for_digests.remote(
                        self._app, self._deployment, known,
                        self.LONG_POLL_TIMEOUT_S),
                    timeout=self.LONG_POLL_TIMEOUT_S + 30,
                )
            except Exception:
                if self._stopped:
                    return
                failures += 1
                if failures >= 10:
                    with self._lock:
                        self._digest_thread = None
                    return
                time.sleep(min(0.2 * failures, 2.0))
                continue
            failures = 0
            with self._lock:
                self._affinity.update(info)

    def _affinity_chain(self, args) -> Optional[list]:
        """Chain-hash the incoming prompt for steering, or None when the
        request is not an LLM payload / no digest data has arrived yet."""
        req = args[0] if args else None
        if isinstance(req, str):
            prompt, ids = req, None
        elif isinstance(req, dict):
            prompt = req.get("prompt") or ""
            ids = req.get("prompt_ids")
        else:
            return None
        if not prompt and not ids:
            return None
        self._ensure_digest_polling()
        with self._lock:
            if not self._affinity.ready():
                return None
            chain = self._affinity.chain_for(prompt, prompt_ids=ids)
        return chain or None

    @staticmethod
    def _attach_hint(args, hint: Dict[str, Any]):
        """Return args with ``_fleet_hint`` injected into a COPY of the
        request payload — the caller's dict must not be mutated."""
        req = args[0]
        req = dict(req) if isinstance(req, dict) else {"prompt": req}
        req["_fleet_hint"] = hint
        return (req,) + tuple(args[1:])

    def _pick(self, multiplexed_model_id: str = "",
              chain: Optional[list] = None):
        """Pow-2 choice under the lock; None if no replicas known. With a
        model id, restrict the pow-2 draw to replicas already holding that
        model (reference `multiplex.py` routing affinity) when any do.

        With a prefix ``chain``, steer to the replica whose
        radix cache matches the deepest page-aligned prefix — unless it is
        fail-marked or its in-flight count exceeds the least-loaded
        replica's by more than the skew bound, in which case fall back to
        pow-2 and return a ``_fleet_hint`` so the chosen replica can pull
        the pages from the holder. Returns (idx, replica, hint|None)."""
        with self._lock:
            n = len(self._replicas)
            if not n:
                return None
            candidates = list(range(n))
            if multiplexed_model_id:
                hot = self._mux_locations.get(multiplexed_model_id)
                if hot:
                    hot_idx = [self._key_to_idx[k] for k in hot
                               if k in self._key_to_idx]
                    if hot_idx:
                        candidates = hot_idx
            hint = None
            steered = None
            holder_idx = None
            if chain:
                keys = [self._replica_key(r) for r in self._replicas]
                holder_key, depth = self._affinity.steer(chain, keys)
                if holder_key is not None and holder_key in self._key_to_idx:
                    holder_idx = self._key_to_idx[holder_key]
                    now = time.monotonic()
                    failing = (now - self._fail_marks.get(holder_key, 0.0)
                               < self.FAIL_PENALTY_S)
                    min_load = min(self._inflight.get(i, 0)
                                   for i in candidates)
                    skewed = (self._inflight.get(holder_idx, 0) - min_load
                              > self._affinity_skew)
                    if (holder_idx in candidates and not failing
                            and not skewed):
                        steered = holder_idx
                        m_affinity_hits.inc()
                    else:
                        # holder known but unusable: pow-2 below, and tell
                        # the chosen replica where to PULL the prefix from
                        hint = {
                            "handle": self._replicas[holder_idx],
                            "tokens": depth * self._affinity.page_tokens,
                        }
                        m_affinity_misses.inc()
                else:
                    m_affinity_misses.inc()
            if steered is not None:
                idx = steered
            elif len(candidates) == 1:
                idx = candidates[0]
            else:
                now = time.monotonic()

                def load(i):
                    # a recent failure outweighs any plausible in-flight
                    # difference without permanently blacklisting
                    key = self._replica_key(self._replicas[i])
                    mark = self._fail_marks.get(key, 0.0)
                    penalty = 1000 if now - mark < self.FAIL_PENALTY_S else 0
                    return self._inflight.get(i, 0) + penalty

                a, b = random.sample(candidates, 2)
                idx = a if load(a) <= load(b) else b
            if hint is not None and (idx == holder_idx
                                     or not hint["tokens"]):
                hint = None  # landed on the holder anyway / nothing to pull
            self._inflight[idx] = self._inflight.get(idx, 0) + 1
            return idx, self._replicas[idx], hint

    def assign_request(self, method_name: str, args, kwargs):
        ref, _replica = self.assign_request_with_replica(
            method_name, args, kwargs)
        return ref

    def assign_request_with_replica(self, method_name: str, args, kwargs,
                                    multiplexed_model_id: str = "",
                                    streaming: bool = False):
        """Returns (result_ref, replica_handle) — or, with streaming=True,
        (ObjectRefGenerator, replica_handle): the request rides the native
        generator transport (replica.handle_request_streaming) and chunks
        arrive as owner-owned ObjectRefs as they are produced. The replica
        handle lets callers continue a chunk-pull streaming response on
        the same replica (legacy path)."""
        self._ensure_polling()
        if multiplexed_model_id:
            self._ensure_mux_refresh()
        chain = None
        if self._affinity_on and not multiplexed_model_id:
            chain = self._affinity_chain(args)
        deadline = time.monotonic() + 30
        while True:
            # clear BEFORE picking: a push landing between a failed pick
            # and clear() would otherwise be erased and stall us a full
            # wait interval
            self._update_event.clear()
            picked = self._pick(multiplexed_model_id, chain)
            if picked is not None:
                idx, replica, hint = picked
                break
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise RuntimeError(
                    f"no replicas for {self._app}/{self._deployment}")
            # wait for the long-poll push, not an interval
            self._update_event.wait(timeout=min(remaining, 5.0))
        if hint is not None:
            args = self._attach_hint(args, hint)
        if multiplexed_model_id:
            # optimistic: the chosen replica will hold the model after this
            # request, so siblings route there before the next poll lands
            key = self._replica_key(replica)
            with self._lock:
                self._mux_locations.setdefault(
                    multiplexed_model_id, set()).add(key)
                self._mux_marks[(multiplexed_model_id, key)] = (
                    time.monotonic())
                self._mux_last_request = time.monotonic()
        if streaming:
            gen = replica.handle_request_streaming.options(
                num_returns="streaming").remote(method_name, args, kwargs)
            # in-flight accounting: the watched wrapper holds the count
            # for the STREAM's lifetime and releases it at exhaustion,
            # task error, or consumer GC — releasing at submit would hide
            # every streaming request from the pow-2 draw and from the
            # affinity skew bound (steering would pile streams onto the
            # digest holder unbounded). Terminal state still feeds
            # failure accounting via the wrapper.
            return (_WatchedStream(gen, self, self._replica_key(replica),
                                   mux_id=multiplexed_model_id,
                                   inflight_idx=idx),
                    replica)
        ref = replica.handle_request.remote(method_name, args, kwargs)
        self._watch_completion(ref, idx, self._replica_key(replica),
                               mux_id=multiplexed_model_id)
        return ref, replica

    def _ensure_mux_refresh(self) -> None:
        self._mux_last_request = time.monotonic()
        if self._mux_thread is None:
            with self._lock:
                if self._mux_thread is None:
                    t = threading.Thread(
                        target=self._mux_refresh_loop,
                        name=f"serve-mux-{self._deployment}", daemon=True)
                    self._mux_thread = t
                    t.start()

    MUX_MARK_TTL_S = 30.0     # optimistic marks survive refreshes this long
    MUX_IDLE_EXIT_S = 60.0    # refresh thread retires when mux traffic stops

    def _mux_refresh_loop(self) -> None:
        """Poll replicas' loaded-model sets so affinity reflects real LRU
        state (evictions included). Recent optimistic marks and entries of
        unreachable replicas are merged in, not wiped — a model mid-load
        (or one slow poll) must not bounce the next request to a cold
        replica. The thread retires itself once mux traffic stops or the
        runtime is shut down."""
        while not self._stopped:
            time.sleep(1.0)
            now = time.monotonic()
            if (now - self._mux_last_request > self.MUX_IDLE_EXIT_S
                    or not rt.is_initialized()):
                with self._lock:
                    self._mux_thread = None
                return
            with self._lock:
                replicas = list(enumerate(self._replicas))
            if not replicas:
                continue
            fresh: Dict[str, set] = {}
            failed: set = set()
            for _idx, rep in replicas:
                key = self._replica_key(rep)
                try:
                    info = rt.get(rep.multiplex_info.remote(),
                                       timeout=5)
                except Exception:
                    failed.add(key)
                    continue
                for mid in info.get("model_ids", ()):
                    fresh.setdefault(mid, set()).add(key)
            with self._lock:
                for (mid, key), ts in list(self._mux_marks.items()):
                    if now - ts > self.MUX_MARK_TTL_S:
                        del self._mux_marks[(mid, key)]
                    else:
                        fresh.setdefault(mid, set()).add(key)
                for mid, idxs in self._mux_locations.items():
                    keep = idxs & failed
                    if keep:
                        fresh.setdefault(mid, set()).update(keep)
                self._mux_locations = fresh

    def _watch_completion(self, ref, idx: int, key: str, mux_id: str = ""):
        def done(f):
            with self._lock:
                if idx in self._inflight and self._inflight[idx] > 0:
                    self._inflight[idx] -= 1
            try:
                self._note_result(key, ok=f.exception() is None,
                                  mux_id=mux_id)
            except Exception:
                pass

        try:
            ref.future().add_done_callback(done)
        except Exception:
            with self._lock:
                if idx in self._inflight and self._inflight[idx] > 0:
                    self._inflight[idx] -= 1

    def stop(self) -> None:
        self._stopped = True
