"""Client server: lets a remote process drive this cluster without joining it.

Analog of the reference's Ray Client server
(`python/ray/util/client/server/`): the server process is a real driver
(CoreWorker connected to the cluster); each client session proxies
task-submission / actor / object ops through it over the framework's own RPC
(length-prefixed frames — no gRPC, matching `_private/rpc.py`'s stance).

Run standalone:
    python -m ray_tpu_torch.util.client.server --cluster <host:port> --port 10001

Blocking driver calls (get/wait) run in a thread pool so one slow client
cannot stall the server's event loop.

Counterpart: ``ray_tpu/util/client/server.py``. A tensor in a reply is
pickled as the port's serialization pickles it: a CUDA tensor is copied to
the host, and the client rebuilds it on the CPU. Sessions are not
authenticated and their payloads are unpickled, so the server listens on
the loopback interface unless ``host``/``--host`` names another: anyone
who can reach the port runs code as the cluster's user.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import pickle
import threading
import time
from typing import Any, Dict, Optional

from ray_tpu_torch.util.client.common import (ACTOR_PID, REF_PID, dumps_with_ids,
                                        loads_with_ids)

logger = logging.getLogger(__name__)


class _Session:
    """Per-client state: pinned refs + known actor handles."""

    def __init__(self, session_id: str, namespace: str = "default"):
        self.id = session_id
        self.namespace = namespace
        self.refs: Dict[str, Any] = {}       # hex -> real ObjectRef (pin)
        # pin counts: each serialize of a ref to the client mints one client
        # stub, and each stub GC sends one release — counts must balance or a
        # duplicate stub (e.g. from wait()) would drop a shared pin early
        self.pins: Dict[str, int] = {}
        self.actors: Dict[str, Any] = {}     # hex -> real ActorHandle
        self.last_seen = time.monotonic()


class ClientServer:
    def __init__(self, cluster_address: Optional[str] = None,
                 host: str = "127.0.0.1", port: int = 10001, *,
                 namespace: str = "default", init_kwargs: Optional[dict] = None,
                 session_ttl_s: float = 600.0):
        self._cluster_address = cluster_address
        self._host, self._port = host, port
        self._namespace = namespace
        self._init_kwargs = dict(init_kwargs or {})
        self._session_ttl = session_ttl_s
        self._sessions: Dict[str, _Session] = {}
        self._lock = threading.Lock()
        self._server = None
        self._reaper_task = None

    # ------------------------------------------------------------- pickle glue

    def _session(self, body: Dict[str, Any]) -> _Session:
        sid = body["session"]
        with self._lock:
            s = self._sessions.get(sid)
            if s is None:
                s = self._sessions[sid] = _Session(
                    sid, body.get("namespace") or self._namespace)
            s.last_seen = time.monotonic()
            return s

    def _session_if_exists(self, body: Dict[str, Any]) -> Optional[_Session]:
        with self._lock:
            s = self._sessions.get(body.get("session", ""))
        if s is not None:
            s.last_seen = time.monotonic()
        return s

    def _id_for(self, session: _Session):
        """persistent_id for server→client payloads: pin refs, map handles."""
        from ray_tpu_torch._private.api import ActorHandle, ObjectRef

        def id_for(obj):
            if isinstance(obj, ObjectRef):
                h = obj.hex()
                session.refs.setdefault(h, obj)
                session.pins[h] = session.pins.get(h, 0) + 1
                return (REF_PID, h)
            if isinstance(obj, ActorHandle):
                session.actors.setdefault(obj._actor_id.hex(), obj)
                return (ACTOR_PID, obj._actor_id.hex(),
                        getattr(obj, "_class_name", ""))
            return None

        return id_for

    def _load_pid(self, session: _Session):
        """persistent_load for client→server payloads."""

        def load(pid):
            kind, hex_id = pid[0], pid[1]
            if kind == REF_PID:
                ref = session.refs.get(hex_id)
                if ref is None:
                    raise KeyError(
                        f"client ref {hex_id[:16]} is not pinned in this "
                        f"session (already released?)")
                return ref
            if kind == ACTOR_PID:
                h = session.actors.get(hex_id)
                if h is None:
                    from ray_tpu_torch._private.api import ActorHandle
                    from ray_tpu_torch._private.ids import ActorID

                    h = ActorHandle(ActorID.from_hex(hex_id))
                    session.actors[hex_id] = h
                return h
            raise pickle.UnpicklingError(f"unknown persistent id {pid!r}")

        return load

    def _dumps(self, session: _Session, obj) -> bytes:
        return dumps_with_ids(obj, self._id_for(session))

    def _loads(self, session: _Session, blob: bytes):
        return loads_with_ids(blob, self._load_pid(session))

    # ---------------------------------------------------------------- handlers

    async def _wrap(self, session: _Session, fn, *args):
        """Run a blocking driver op off-loop; ship back {ok} or {exc}."""
        try:
            result = await asyncio.to_thread(fn, *args)
            return {"ok": self._dumps(session, result)}
        except BaseException as e:  # noqa: BLE001 — exceptions cross the wire
            try:
                blob = self._dumps(session, e)
            except Exception:
                blob = self._dumps(session, RuntimeError(repr(e)))
            return {"exc": blob}

    async def cl_ping(self, body):
        s = self._session(body)
        import ray_tpu_torch

        return {"pong": True, "namespace": s.namespace,
                "cluster": ray_tpu_torch.is_initialized()}

    async def cl_task(self, body):
        s = self._session(body)

        def run():
            from ray_tpu_torch._private import api

            args, kwargs = self._loads(s, body["args"])
            opts = body.get("opts") or {}
            core = api._require_core()
            import hashlib

            blob = body["fn"]
            key = hashlib.sha256(blob).hexdigest()
            num_returns = opts.get("num_returns", 1)
            if (num_returns in ("streaming", "dynamic")
                    or (isinstance(num_returns, int) and num_returns < 0)):
                # stream state lives in the owner process; a client://
                # proxy consumer needs per-item forwarding (not yet built)
                raise NotImplementedError(
                    "num_returns='streaming' is not supported in client mode")
            oids = core.submit_task(
                None, args, kwargs,
                name=opts.get("name") or body.get("fn_name", "client_task"),
                num_returns=num_returns,
                resources=api._resources_from_options(opts),
                strategy=api._strategy_from_options(opts),
                max_retries=opts.get("max_retries", -1),
                retry_exceptions=bool(opts.get("retry_exceptions", False)),
                runtime_env=api._resolve_runtime_env(
                    opts.get("runtime_env"), core),
                function_key=key,
                function_blob=blob,
            )
            refs = [api.ObjectRef(oid, core.address) for oid in oids]
            return refs[0] if num_returns == 1 else refs

        return await self._wrap(s, run)

    async def cl_put(self, body):
        s = self._session(body)

        def run():
            from ray_tpu_torch._private import api

            return api.put(self._loads(s, body["value"]))

        return await self._wrap(s, run)

    async def cl_get(self, body):
        s = self._session(body)

        def run():
            from ray_tpu_torch._private import api

            refs = self._loads(s, body["refs"])
            return api.get(refs, timeout=body.get("timeout"))

        return await self._wrap(s, run)

    async def cl_wait(self, body):
        s = self._session(body)

        def run():
            from ray_tpu_torch._private import api

            refs = self._loads(s, body["refs"])
            return api.wait(refs, num_returns=body["num_returns"],
                            timeout=body.get("timeout"))

        return await self._wrap(s, run)

    async def cl_actor(self, body):
        s = self._session(body)

        def run():
            from ray_tpu_torch._private import api

            cls = loads_with_ids(body["cls"], self._load_pid(s))
            args, kwargs = self._loads(s, body["args"])
            opts = dict(body.get("opts") or {})
            opts.setdefault("namespace", s.namespace)
            handle = api.ActorClass(cls, opts).remote(*args, **kwargs)
            s.actors[handle._actor_id.hex()] = handle
            return handle

        return await self._wrap(s, run)

    async def cl_actor_call(self, body):
        s = self._session(body)

        def run():
            handle = self._load_pid(s)((ACTOR_PID, body["actor"]))
            args, kwargs = self._loads(s, body["args"])
            method = getattr(handle, body["method"])
            if body.get("num_returns", 1) != 1:
                method = method.options(num_returns=body["num_returns"])
            return method.remote(*args, **kwargs)

        return await self._wrap(s, run)

    async def cl_named_actor(self, body):
        s = self._session(body)

        def run():
            from ray_tpu_torch._private import api

            h = api.get_actor(body["name"],
                              body.get("namespace") or s.namespace)
            s.actors[h._actor_id.hex()] = h
            return h

        return await self._wrap(s, run)

    async def cl_kill(self, body):
        s = self._session(body)

        def run():
            from ray_tpu_torch._private import api

            h = self._load_pid(s)((ACTOR_PID, body["actor"]))
            api.kill(h, no_restart=body.get("no_restart", True))

        return await self._wrap(s, run)

    async def cl_cancel(self, body):
        s = self._session(body)

        def run():
            from ray_tpu_torch._private import api

            ref = self._load_pid(s)((REF_PID, body["ref"]))
            api.cancel(ref, force=body.get("force", False))

        return await self._wrap(s, run)

    async def cl_query(self, body):
        s = self._session(body)
        kind = body["kind"]

        def run():
            from ray_tpu_torch._private import api

            if kind == "nodes":
                return api.nodes()
            if kind == "cluster_resources":
                return api.cluster_resources()
            if kind == "available_resources":
                return api.available_resources()
            raise ValueError(f"unknown query {kind!r}")

        return await self._wrap(s, run)

    async def cl_release(self, body):
        # must not resurrect a disconnected session as a fresh empty one
        s = self._session_if_exists(body)
        if s is not None:
            for hex_id in body.get("refs", ()):
                n = s.pins.get(hex_id, 0) - 1
                if n <= 0:
                    s.pins.pop(hex_id, None)
                    s.refs.pop(hex_id, None)
                else:
                    s.pins[hex_id] = n
        return {}

    async def cl_disconnect(self, body):
        sid = body["session"]
        with self._lock:
            s = self._sessions.pop(sid, None)
        if s:
            s.refs.clear()
            s.pins.clear()
            s.actors.clear()
        return {}

    # ------------------------------------------------------------------- run

    async def start(self):
        import ray_tpu_torch
        from ray_tpu_torch._private.rpc import RpcServer

        if not ray_tpu_torch.is_initialized():
            # init() drives its own event loops internally — keep it off ours
            kwargs = dict(self._init_kwargs, namespace=self._namespace)
            if self._cluster_address:
                kwargs["address"] = self._cluster_address
            await asyncio.to_thread(lambda: ray_tpu_torch.init(**kwargs))
        self._server = RpcServer(host=self._host, port=self._port)
        for name in dir(self):
            if name.startswith("cl_"):
                self._server.register(name, getattr(self, name))
        addr = await self._server.start()
        self._reaper_task = asyncio.ensure_future(self._reap_sessions())
        logger.info("client server listening on %s:%s", *addr)
        return addr

    async def _reap_sessions(self):
        """Expire sessions whose client vanished without cl_disconnect so
        their pinned refs don't leak for the server's lifetime."""
        while True:
            await asyncio.sleep(min(60.0, self._session_ttl / 4))
            cutoff = time.monotonic() - self._session_ttl
            with self._lock:
                dead = [sid for sid, s in self._sessions.items()
                        if s.last_seen < cutoff]
                for sid in dead:
                    s = self._sessions.pop(sid)
                    s.refs.clear()
                    s.pins.clear()
                    s.actors.clear()
            if dead:
                logger.info("reaped %d idle client session(s)", len(dead))

    async def stop(self):
        if self._reaper_task:
            self._reaper_task.cancel()
        if self._server:
            await self._server.stop()


def _arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="ray_tpu_torch client server")
    parser.add_argument("--cluster", default=None,
                        help="controller host:port (default: start local)")
    parser.add_argument("--host", default="127.0.0.1",
                        help="interface to listen on (default: loopback)")
    parser.add_argument("--port", type=int, default=10001)
    parser.add_argument("--namespace", default="default")
    return parser


def main(argv=None):
    args = _arg_parser().parse_args(argv)

    async def run():
        srv = ClientServer(args.cluster, args.host, args.port,
                           namespace=args.namespace)
        await srv.start()
        print(f"client server ready on {args.host}:{args.port}", flush=True)
        await asyncio.Event().wait()

    asyncio.run(run())


if __name__ == "__main__":
    main()
