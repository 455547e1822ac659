"""Async RPC substrate for the control plane.

Analog of the reference's gRPC wrapper layer (`src/ray/rpc/
grpc_server.h`, `grpc_client.h`, `client_call.h`): every daemon (controller,
supervisor, worker) runs one ``RpcServer``; peers hold multiplexed,
auto-reconnecting ``RpcClient``s.

We deliberately do not use gRPC for the control plane: the reference needs
gRPC for cross-language parity (C++/Java/Python all speak the same proto); our
control plane is Python+C++ only and latency-bound by asyncio scheduling, not
marshalling. The wire protocol is length-prefixed pickles over TCP — trivially
inspectable, no proto toolchain in the loop, and the object-payload path never
rides it (objects move via the shared-memory store and the chunked transfer
protocol in object_store.py / supervisor.py).

Frame: [u32 little-endian length][payload]
Payload: pickle of (kind, msg_id, method, body[, client_id])
  kind: 0=request 1=reply 2=error 3=oneway
  client_id: 8 random bytes stable for the client's lifetime; with msg_id it
  forms the exactly-once key for the server's replay cache (requests only;
  replies echo the bare msg_id).

Fault tolerance (what gRPC + the GCS managers give the reference, rebuilt):

  * ``RpcClient.call`` retries transparently on connection loss —
    reconnect, exponential backoff + jitter, the SAME ``msg_id`` resent —
    all under one deadline budget covering connect + request + retries.
  * The server replays cached replies for retried/duplicated deliveries of
    methods registered ``replay_cached=True`` (non-idempotent control RPCs:
    lease grants, task pushes, registrations). A retried ``request_lease``
    whose first reply was lost gets the original grant back instead of
    leasing a second worker. Handlers are annotated at their definition with
    :func:`replay_cached` / :func:`idempotent`.
  * Both sides consult :mod:`ray_tpu_torch._private.chaos` so a seeded
    ``FaultController`` can drop (sever), duplicate, or delay any frame —
    the substrate the chaos suite drives.
"""

from __future__ import annotations

import asyncio
import contextvars
import inspect
import logging
import os
import pickle
import random
import socket
import struct
import time
from collections import OrderedDict
from typing import Any, Awaitable, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch._private import serialization
from ray_tpu_torch._private.chaos import fault_controller
from ray_tpu_torch._private.metrics import Counter

logger = logging.getLogger(__name__)

# every outbound RPC this process issues, by method. The compiled-graph
# suite snapshots total() around a steady-state step window to PROVE the
# channel path does zero control-plane RPCs (transparent retries of one
# logical call count once — a retry is not a new control decision).
_m_client_calls = Counter(
    "ray_tpu_rpc_client_calls_total",
    "Outbound RPC calls issued by this process (call + notify), by method")

# every request this process's server DISPATCHES (replay-cache hits
# included), by method: the serve-side twin of the client counter. The
# controller-HA suite scrapes the controller's series to prove the
# steady task loop leases node-locally (0 controller request_lease).
_m_server_requests = Counter(
    "ray_tpu_rpc_server_requests_total",
    "Requests dispatched by this process's RPC server, by method")

# the (client_id, msg_id) replay key of the request currently being
# dispatched, visible to replay-cached handlers: the controller embeds
# it (plus the reply) in the SAME WAL frame as the mutation, making
# exactly-once durable across its own restart — one frame, no window
# between "applied" and "reply cached" for a crash to split.
_current_replay_key: contextvars.ContextVar = contextvars.ContextVar(
    "rpc_replay_key", default=None)


def current_replay_key() -> Optional[Tuple[bytes, int, str]]:
    """(client_id, msg_id, method) of the in-flight replay-cached request,
    or None outside such a dispatch."""
    return _current_replay_key.get()

_LEN = struct.Struct("<I")
REQUEST, REPLY, ERROR, ONEWAY = 0, 1, 2, 3

MAX_FRAME = 512 * 1024 * 1024

# completed replies kept for duplicate/retried delivery replay, per server
REPLAY_CACHE_SIZE = 4096


class RpcError(Exception):
    pass


class RpcConnectionError(RpcError):
    pass


class RpcTimeoutError(RpcError):
    pass


class _ConnectionLostMidCall(RpcConnectionError):
    """Internal: an ESTABLISHED connection dropped before the reply. The only
    failure the transparent retry loop absorbs — a reconnect that fails means
    the peer is gone, and that must surface immediately (callers like the
    actor push path re-resolve a NEW address on RpcConnectionError; eating
    the signal here would starve their failover)."""


class RemoteError(RpcError):
    """An exception raised inside the remote handler, re-raised locally."""

    def __init__(self, method: str, cause_repr: str, cause: Exception | None = None):
        super().__init__(f"remote handler {method!r} failed: {cause_repr}")
        self.cause = cause


def replay_cached(fn):
    """Mark an ``rpc_*`` handler non-idempotent: the server caches its reply
    keyed by (client_id, msg_id) and replays it for duplicated or retried
    deliveries instead of re-executing. Use for anything that mints ids,
    grants resources, or appends durable records."""
    fn._rpc_replay_cached = True
    return fn


def idempotent(fn):
    """Audit marker: re-executing this handler with the same body converges
    to the same state (reads, overwrite-by-key writes, guarded transitions).
    Duplicated/retried deliveries may re-execute it freely."""
    fn._rpc_idempotent = True
    return fn


async def _read_frame(reader: asyncio.StreamReader) -> bytes:
    header = await reader.readexactly(_LEN.size)
    (length,) = _LEN.unpack(header)
    if length > MAX_FRAME:
        raise RpcError(f"frame too large: {length}")
    return await reader.readexactly(length)


def _write_frame(writer: asyncio.StreamWriter, payload: bytes) -> None:
    writer.write(_LEN.pack(len(payload)))
    writer.write(payload)


class RpcServer:
    """Method-dispatch TCP server.

    Handlers are registered by name; they may be sync or async, and receive
    (body, ) or (body, peer) if they accept two arguments.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._host = host
        self._port = port
        self._handlers: Dict[str, Callable] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: set = set()
        # exactly-once layer for non-idempotent methods: (client_id, msg_id)
        # -> completed reply payload bytes, or an asyncio.Future while the
        # first delivery is still executing (concurrent duplicates await it)
        self._replay_methods: set = set()
        self._replay_cache: "OrderedDict[Tuple[bytes, int], Any]" = OrderedDict()

    def register(self, method: str, handler: Callable,
                 replay_cached: bool = False) -> None:
        if replay_cached or getattr(handler, "_rpc_replay_cached", False):
            self._replay_methods.add(method)
        self._handlers[method] = handler

    def register_object(self, obj: Any, prefix: str = "") -> None:
        """Register every public method of obj whose name starts with 'rpc_'."""
        for name in dir(obj):
            if name.startswith("rpc_"):
                self.register(prefix + name[4:], getattr(obj, name))

    @property
    def address(self) -> Tuple[str, int]:
        return (self._host, self._port)

    @property
    def address_str(self) -> str:
        return f"{self._host}:{self._port}"

    async def start(self) -> Tuple[str, int]:
        self._server = await asyncio.start_server(
            self._handle_conn, self._host, self._port, limit=MAX_FRAME
        )
        self._port = self._server.sockets[0].getsockname()[1]
        return (self._host, self._port)

    async def stop(self) -> None:
        # Close live connections BEFORE wait_closed(): since 3.12,
        # Server.wait_closed() waits for every connection handler to finish,
        # and our handlers sit in read loops until the peer (or we) close.
        if self._server is not None:
            self._server.close()
        for w in list(self._conns):
            try:
                w.close()
            except Exception:
                pass
        if self._server is not None:
            try:
                await asyncio.wait_for(self._server.wait_closed(), timeout=2)
            except Exception:
                pass

    async def _handle_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        peer = writer.get_extra_info("peername")
        self._conns.add(writer)
        try:
            while True:
                try:
                    frame = await _read_frame(reader)
                except (asyncio.IncompleteReadError, ConnectionResetError):
                    break
                # Dispatch without blocking the read loop so one slow handler
                # doesn't head-of-line-block the connection.
                asyncio.get_running_loop().create_task(
                    self._dispatch(frame, writer, peer)
                )
        finally:
            self._conns.discard(writer)
            try:
                writer.close()
            except Exception:
                pass

    async def _dispatch(self, frame: bytes, writer: asyncio.StreamWriter, peer):
        msg = pickle.loads(frame)
        kind, msg_id, method, body = msg[:4]
        client_id = msg[4] if len(msg) > 4 else None
        drop_reply = False
        if kind == REQUEST:
            fc = fault_controller()
            if fc is not None:
                decision = fc.rpc("server", method)
                if decision is not None:
                    if decision.delay_s:
                        await asyncio.sleep(decision.delay_s)
                    # server-side drop = the reply is lost in transit: the
                    # handler runs (and its reply is cached), then the
                    # connection severs so the client retries and must be
                    # served from the replay cache
                    drop_reply = decision.drop

        handler = self._handlers.get(method)
        if handler is None:
            if kind == REQUEST:
                self._send_reply(
                    writer,
                    self._encode_reply(ERROR, msg_id, method,
                                       f"no such method: {method}"),
                    drop_reply)
            return

        if kind == REQUEST:
            _m_server_requests.inc(labels={"method": method})
        key = None
        if kind == REQUEST and client_id is not None \
                and method in self._replay_methods:
            key = (client_id, msg_id)
            hit = self._replay_cache.get(key)
            if hit is not None:
                if isinstance(hit, asyncio.Future):
                    payload = await hit  # first delivery still executing
                else:
                    payload = hit
                self._send_reply(writer, payload, drop_reply)
                return
            self._replay_cache[key] = asyncio.get_running_loop().create_future()

        payload = None
        token = None
        if key is not None:
            # replay-cached handlers may fold this key into their durable
            # mutation record (controller WAL) for restart-proof dedupe
            token = _current_replay_key.set((client_id, msg_id, method))
        try:
            sig_args = (body, peer) if _wants_peer(handler) else (body,)
            result = handler(*sig_args)
            if inspect.isawaitable(result):
                result = await result
            if kind == REQUEST:
                payload = self._encode_reply(REPLY, msg_id, method, result)
        except Exception as e:  # noqa: BLE001 — handler errors cross the wire
            logger.debug("handler %s raised", method, exc_info=True)
            if kind == REQUEST:
                payload = self._encode_reply(ERROR, msg_id, method, e)
        finally:
            if token is not None:
                _current_replay_key.reset(token)
        if key is not None:
            self._finish_replay(key, payload)
        if payload is not None:
            self._send_reply(writer, payload, drop_reply)

    def _encode_reply(self, kind: int, msg_id, method: str, body) -> bytes:
        try:
            return serialization.dumps((kind, msg_id, method, body))
        except Exception:
            # unpicklable result/exception: degrade to its repr
            return serialization.dumps((ERROR, msg_id, method, repr(body)))

    def seed_replay(self, client_id: bytes, msg_id: int, method: str,
                    reply_value: Any) -> None:
        """Install a COMPLETED reply for (client_id, msg_id) — recovery
        seeding from WAL frames that embedded their replay key. A
        retry straddling the server's restart is then answered
        from the cache exactly like a same-incarnation redelivery."""
        self.seed_replay_payload(
            (client_id, msg_id),
            self._encode_reply(REPLY, msg_id, method, reply_value))

    def seed_replay_payload(self, key: Tuple[bytes, int],
                            payload: bytes) -> None:
        """Install a pre-encoded reply payload (snapshot-carried entries)."""
        existing = self._replay_cache.get(key)
        if isinstance(existing, asyncio.Future):
            return  # a live dispatch owns this key; never clobber it
        self._replay_cache[key] = payload
        self._replay_cache.move_to_end(key)
        excess = len(self._replay_cache) - REPLAY_CACHE_SIZE
        if excess > 0:
            for k in [k for k, v in self._replay_cache.items()
                      if not isinstance(v, asyncio.Future)][:excess]:
                del self._replay_cache[k]

    def export_replay(self) -> List[Tuple[bytes, int, bytes]]:
        """Completed replay entries as (client_id, msg_id, payload) — the
        snapshot's carry so compaction (which sweeps the WAL frames that
        embedded them) does not reopen the exactly-once window."""
        return [(k[0], k[1], v) for k, v in self._replay_cache.items()
                if not isinstance(v, asyncio.Future)]

    def _finish_replay(self, key, payload: bytes) -> None:
        fut = self._replay_cache.get(key)
        self._replay_cache[key] = payload
        self._replay_cache.move_to_end(key)
        if isinstance(fut, asyncio.Future) and not fut.done():
            fut.set_result(payload)
        # trim oldest COMPLETED entries only: evicting an in-flight Future
        # would strand duplicate dispatches awaiting it and let a late
        # retry re-execute the non-idempotent handler
        excess = len(self._replay_cache) - REPLAY_CACHE_SIZE
        if excess > 0:
            for k in [k for k, v in self._replay_cache.items()
                      if not isinstance(v, asyncio.Future)][:excess]:
                del self._replay_cache[k]

    def _send_reply(self, writer, payload: bytes, drop_reply: bool) -> None:
        if drop_reply:
            # injected reply loss: sever so the client's retry machinery
            # (not a silent timeout) observes it
            try:
                writer.close()
            except Exception:
                pass
            return
        try:
            _write_frame(writer, payload)
        except (ConnectionResetError, RuntimeError):
            pass


def _wants_peer(handler) -> bool:
    try:
        params = inspect.signature(handler).parameters
        return len([p for p in params.values() if p.default is p.empty]) >= 2
    except (TypeError, ValueError):
        return False


class RpcClient:
    """Multiplexed client with lazy connect and transparent retry.

    A call whose connection drops before the reply arrives reconnects and
    resends the SAME (client_id, msg_id) with exponential backoff + jitter,
    all under a single deadline budget — the server's replay cache makes the
    resend exactly-once for non-idempotent methods. All calls must run on the
    owning event loop.
    """

    def __init__(
        self,
        address: Tuple[str, int] | str,
        connect_timeout_s: float = 10.0,
        request_timeout_s: float = 60.0,
        retry_base_s: float = 0.1,
    ):
        if isinstance(address, str):
            host, port = address.rsplit(":", 1)
            address = (host, int(port))
        self._addr = address
        self._connect_timeout = connect_timeout_s
        self._request_timeout = request_timeout_s
        self._retry_base = max(0.001, retry_base_s)
        self._client_id = os.urandom(8)
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._pending: Dict[int, asyncio.Future] = {}
        self._next_id = 0
        self._lock = asyncio.Lock()
        self._read_task: Optional[asyncio.Task] = None
        self._closed = False
        self._ever_connected = False
        # fired (as tasks) after a RE-connect — i.e. the peer process may
        # have restarted and lost its soft state. The controller-restart
        # protocol hangs off this: core workers re-subscribe their pubsub
        # channels here, event-driven, with zero steady-state polling.
        self._reconnect_hooks: List[Callable[[], Any]] = []
        self._eager_task: Optional[asyncio.Task] = None

    @property
    def address(self) -> Tuple[str, int]:
        return self._addr

    async def _ensure_connected(self, one_shot: bool = False) -> None:
        """Establish the connection. ``one_shot`` (reconnect attempts inside
        a call's transparent retry) tries exactly once: if the peer cannot be
        re-reached NOW it is presumed dead and the caller must fail over —
        only the initial connect gets the patient retry window (the peer may
        legitimately still be starting up)."""
        if self._writer is not None and not self._writer.is_closing():
            return
        async with self._lock:
            if self._writer is not None and not self._writer.is_closing():
                return
            deadline = time.monotonic() + self._connect_timeout
            delay = 0.05
            while True:
                try:
                    self._reader, self._writer = await asyncio.wait_for(
                        asyncio.open_connection(*self._addr, limit=MAX_FRAME),
                        timeout=max(0.1, deadline - time.monotonic()),
                    )
                    sock = self._writer.get_extra_info("socket")
                    if sock is not None:
                        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                    break
                except (OSError, asyncio.TimeoutError) as e:
                    if one_shot or time.monotonic() + delay >= deadline \
                            or self._closed:
                        raise RpcConnectionError(
                            f"cannot connect to {self._addr}: {e}"
                        ) from e
                    await asyncio.sleep(delay)
                    delay = min(delay * 2, 1.0)
            loop = asyncio.get_running_loop()
            self._read_task = loop.create_task(self._read_loop())
            reconnected = self._ever_connected
            self._ever_connected = True
            if reconnected:
                # the peer was reachable before and the connection is
                # fresh: it may be a restarted incarnation with empty
                # soft state — let interested layers re-establish theirs
                # (idempotent re-subscribes; a mere TCP blip re-adds the
                # same set entries). Run as tasks: a hook that RPCs back
                # through this client must not re-enter under our lock.
                for hook in list(self._reconnect_hooks):
                    loop.create_task(self._run_reconnect_hook(hook))

    @staticmethod
    async def _run_reconnect_hook(hook: Callable[[], Any]) -> None:
        try:
            result = hook()
            if inspect.isawaitable(result):
                await result
        except Exception:
            logger.debug("reconnect hook failed", exc_info=True)

    def add_reconnect_hook(self, hook: Callable[[], Any]) -> None:
        """Register a callback (sync or async) fired after every
        re-established connection to this peer."""
        self._reconnect_hooks.append(hook)

    async def _read_loop(self) -> None:
        reader = self._reader
        try:
            while True:
                frame = await _read_frame(reader)
                kind, msg_id, method, body = pickle.loads(frame)[:4]
                fut = self._pending.pop(msg_id, None)
                if fut is None or fut.done():
                    continue
                if kind == REPLY:
                    fut.set_result(body)
                elif kind == ERROR:
                    if isinstance(body, Exception):
                        fut.set_exception(RemoteError(method, repr(body), body))
                    else:
                        fut.set_exception(RemoteError(method, str(body)))
        except (asyncio.IncompleteReadError, ConnectionResetError, OSError, asyncio.CancelledError):
            pass
        finally:
            err = RpcConnectionError(f"connection to {self._addr} lost")
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(err)
            self._pending.clear()
            if self._writer is not None:
                try:
                    self._writer.close()
                except Exception:
                    pass
            self._writer = None
            self._reader = None
            if self._reconnect_hooks and not self._closed \
                    and self._eager_task is None:
                # a hook-bearing client (a core worker watching the
                # controller) reconnects EAGERLY: an idle process — the
                # zero-RPC steady state — would otherwise never re-issue
                # its subscriptions after a controller restart and
                # silently miss actor/node death fan-out. One bounded
                # backoff loop per outage; nothing periodic at steady
                # state.
                try:
                    self._eager_task = asyncio.get_running_loop(
                    ).create_task(self._eager_reconnect())
                except RuntimeError:
                    pass

    async def _eager_reconnect(self) -> None:
        delay = 0.5
        try:
            while not self._closed:
                await asyncio.sleep(delay)
                if self._writer is not None \
                        and not self._writer.is_closing():
                    return  # a concurrent call already reconnected
                try:
                    # success fires the reconnect hooks from inside
                    await self._ensure_connected(one_shot=True)
                    return
                except RpcConnectionError:
                    delay = min(delay * 2, 5.0)
        finally:
            self._eager_task = None

    def reserve_msg_id(self) -> int:
        """Pre-allocate a request id so several call() attempts can share one
        (client_id, msg_id) replay-cache key (see retry_call)."""
        self._next_id += 1
        return self._next_id

    async def call(self, method: str, body: Any = None,
                   timeout: float | None = None,
                   _reuse_msg_id: int | None = None) -> Any:
        # One deadline covers connect + request + every transparent retry
        # (a 2s call must not ride a 10s connect-retry window to a dead
        # peer, nor get a fresh 2s after a 1.9s connect).
        budget = timeout if timeout is not None else self._request_timeout
        deadline = time.monotonic() + budget
        if _reuse_msg_id is not None:
            # a retry_call attempt riding a shared replay-cache key: the
            # logical call was already counted (by retry_call), and a
            # redelivery is not a new control decision
            msg_id = _reuse_msg_id
        else:
            _m_client_calls.inc(labels={"method": method})
            msg_id = self.reserve_msg_id()
        # the payload (same msg_id) is reused verbatim across retries so the
        # server-side replay cache can recognize the redelivery
        payload = serialization.dumps(
            (REQUEST, msg_id, method, body, self._client_id))
        attempt = 0
        while True:
            try:
                return await self._attempt(method, msg_id, payload, deadline,
                                           reconnect=attempt > 0)
            except _ConnectionLostMidCall:
                # the peer WAS reachable and the frame (or its reply) was
                # lost — retry under the deadline; a reconnect that fails
                # raises plain RpcConnectionError out of _attempt instead,
                # surfacing peer death to the caller's failover logic
                attempt += 1
                delay = min(self._retry_base * (2 ** (attempt - 1)), 2.0)
                delay *= 0.5 + random.random()  # jitter: 0.5x..1.5x
                if self._closed or time.monotonic() + delay >= deadline:
                    raise
                await asyncio.sleep(delay)

    async def _attempt(self, method: str, msg_id: int, payload: bytes,
                       deadline: float, reconnect: bool) -> Any:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise RpcConnectionError(
                f"{method} to {self._addr}: deadline exhausted reconnecting")
        try:
            # connect failures are TERMINAL for the call (peer unreachable);
            # one_shot on reconnects keeps dead-peer failover instant
            await asyncio.wait_for(self._ensure_connected(one_shot=reconnect),
                                   timeout=remaining)
        except asyncio.TimeoutError as e:
            raise RpcConnectionError(
                f"cannot connect to {self._addr} within budget") from e
        # snapshot: the read loop nulls self._writer when the connection
        # dies, and that can interleave even between _ensure_connected
        # resolving and this coroutine resuming — never deref the attribute
        # after an await
        writer = self._writer
        if writer is None:
            raise _ConnectionLostMidCall(
                f"connection to {self._addr} lost before send")
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[msg_id] = fut
        try:
            send = True
            fc = fault_controller()
            if fc is not None:
                decision = fc.rpc("client", method)
                if decision is not None:
                    if decision.delay_s:
                        await asyncio.sleep(decision.delay_s)
                    if decision.drop:
                        # request lost in transit: sever instead of sending;
                        # the read loop fails `fut` and the retry loop in
                        # call() re-sends — exactly a real network drop
                        send = False
                        writer.close()
                    elif decision.duplicate:
                        _write_frame(writer, payload)
            if send:
                if writer.is_closing():
                    raise _ConnectionLostMidCall(
                        f"connection to {self._addr} closed before send")
                _write_frame(writer, payload)
                await writer.drain()
            return await asyncio.wait_for(
                fut, max(0.05, deadline - time.monotonic())
            )
        except asyncio.TimeoutError as e:
            raise RpcTimeoutError(f"{method} to {self._addr} timed out") from e
        except RpcConnectionError as e:
            # the established connection died before the reply (read loop
            # failed our future) — the one retriable failure
            raise _ConnectionLostMidCall(str(e)) from e
        except (ConnectionResetError, BrokenPipeError, OSError) as e:
            raise _ConnectionLostMidCall(
                f"send to {self._addr} failed: {e}") from e
        finally:
            # the read loop pops on reply; this covers every other exit —
            # drain/serialization failures, timeouts, cancellation — so a
            # failed attempt can never leak its pending-future entry
            self._pending.pop(msg_id, None)

    async def notify(self, method: str, body: Any = None) -> None:
        """Fire-and-forget (at-most-once; never retried)."""
        _m_client_calls.inc(labels={"method": method})
        await self._ensure_connected()
        writer = self._writer  # see _attempt: never deref after an await
        if writer is None:
            raise RpcConnectionError(
                f"connection to {self._addr} lost before send")
        self._next_id += 1
        payload = serialization.dumps(
            (ONEWAY, self._next_id, method, body, self._client_id))
        fc = fault_controller()
        if fc is not None:
            decision = fc.rpc("client", method)
            if decision is not None:
                if decision.delay_s:
                    await asyncio.sleep(decision.delay_s)
                if decision.drop:
                    return  # lost in transit (oneway: nothing notices)
                if decision.duplicate:
                    _write_frame(writer, payload)
        if writer.is_closing():
            raise RpcConnectionError(
                f"connection to {self._addr} closed before send")
        _write_frame(writer, payload)
        await writer.drain()

    async def close(self) -> None:
        self._closed = True
        if self._read_task is not None:
            self._read_task.cancel()
        if self._eager_task is not None:
            self._eager_task.cancel()
        if self._writer is not None:
            try:
                self._writer.close()
            except Exception:
                pass
        self._writer = None


async def retry_call(
    client: RpcClient,
    method: str,
    body: Any = None,
    *,
    timeout: float | None = None,
    per_call_timeout: float | None = None,
    base_interval_s: float = 0.1,
    max_interval_s: float = 5.0,
    retry_on: tuple = (RpcConnectionError, RpcTimeoutError),
) -> Any:
    """Deadline-budgeted retry wrapper shared by control-plane call sites.

    ``RpcClient.call`` already retries transparently on connection loss; this
    helper additionally absorbs peer restarts and per-call timeouts across a
    longer window — the replacement for the hand-rolled fixed-interval retry
    loops daemons used to carry. ``timeout`` bounds the WHOLE effort
    (defaults to the client's request timeout); each attempt gets
    ``per_call_timeout`` (clamped to the remaining budget); sleeps between
    attempts follow exponential backoff from ``base_interval_s``
    (``Config.rpc_retry_interval_ms`` at call sites) with 0.5x..1.5x jitter.
    Safe for non-idempotent methods only because the server's replay cache
    dedupes redeliveries — every attempt here shares ONE reserved
    (client_id, msg_id) key, so even a retry after a timeout whose first
    delivery actually executed is answered from the cache, never
    re-executed."""
    budget = timeout if timeout is not None else client._request_timeout
    deadline = time.monotonic() + budget
    msg_id = client.reserve_msg_id()
    # one logical call regardless of how many attempts share the msg_id
    _m_client_calls.inc(labels={"method": method})
    attempt = 0
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise RpcTimeoutError(
                f"{method} to {client.address}: retry budget exhausted")
        call_timeout = remaining if per_call_timeout is None \
            else min(per_call_timeout, remaining)
        try:
            return await client.call(method, body, timeout=call_timeout,
                                     _reuse_msg_id=msg_id)
        except retry_on:
            attempt += 1
            delay = min(base_interval_s * (2 ** (attempt - 1)), max_interval_s)
            delay *= 0.5 + random.random()
            if time.monotonic() + delay >= deadline:
                raise
            await asyncio.sleep(delay)


async def call_chunked(
    client: RpcClient,
    method: str,
    base_body: dict,
    payload,
    *,
    chunk_bytes: int,
    window: int,
    timeout: float,
) -> int:
    """Ship ``payload`` as a bounded window of ``method`` frames.

    The shared transfer shape of the data plane (object pulls, compiled-DAG
    mirror pushes, collective ring segments): each frame is
    ``{**base_body, "offset": <byte offset>, "data": <chunk>}``, at most
    ``window`` frames in flight at once, every frame under the caller's one
    deadline budget. Handlers must be idempotent (same-offset rewrites
    converge), which makes drop/dup/retry safe without a replay cache.
    A zero-length payload still sends one frame so the receiver observes
    the message. Returns the number of frames sent; any frame failure
    cancels the rest of the window and propagates."""
    view = memoryview(payload)
    chunk = max(1, int(chunk_bytes))
    offsets = list(range(0, len(view), chunk)) or [0]
    deadline = time.monotonic() + timeout
    sem = asyncio.Semaphore(max(1, int(window)))

    async def send(pos: int) -> None:
        async with sem:
            await client.call(
                method,
                {**base_body, "offset": pos,
                 "data": bytes(view[pos:pos + chunk])},
                timeout=max(0.05, deadline - time.monotonic()))

    tasks = [asyncio.ensure_future(send(pos)) for pos in offsets]
    try:
        await asyncio.gather(*tasks)
    except BaseException:
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        raise
    return len(offsets)


class ClientPool:
    """Cache of RpcClients keyed by address."""

    def __init__(self, connect_timeout_s: float = 10.0,
                 request_timeout_s: float = 60.0,
                 retry_base_s: float = 0.1):
        self._clients: Dict[Tuple[str, int], RpcClient] = {}
        self._connect_timeout = connect_timeout_s
        self._request_timeout = request_timeout_s
        self._retry_base = retry_base_s

    def get(self, address: Tuple[str, int] | str) -> RpcClient:
        if isinstance(address, str):
            host, port = address.rsplit(":", 1)
            address = (host, int(port))
        client = self._clients.get(address)
        if client is None:
            client = RpcClient(
                address,
                connect_timeout_s=self._connect_timeout,
                request_timeout_s=self._request_timeout,
                retry_base_s=self._retry_base,
            )
            self._clients[address] = client
        return client

    def drop(self, address: Tuple[str, int]) -> None:
        self._clients.pop(address, None)

    async def close_all(self) -> None:
        for c in self._clients.values():
            await c.close()
        self._clients.clear()
