"""ASGI ingress adapter: serve any ASGI app (FastAPI, Starlette, raw
ASGI callables) as a deployment.

Counterpart: ``ray_tpu/serve/asgi.py``. Analog of `serve.ingress`
(`python/ray/serve/api.py:172`) plus the proxy's ASGI/websocket bridging
(`serve/_private/proxy.py:431`):

    app = FastAPI()            # any ASGI3 app object

    @serve.deployment
    @serve.ingress(app)
    class MyService:
        ...                    # regular deployment class; `app` routes
                               # can call its methods via `self`

HTTP requests reaching the proxy for this deployment are translated to
ASGI scope/receive/send; response headers and body chunks stream back
over the native generator transport, so an ASGI streaming response
(chunked transfer, SSE) streams end-to-end. Websocket scopes run the
same app with a bidirectional bridge: outbound ASGI events ride a
streaming generator to the proxy, inbound client frames are fed by
per-message actor calls into the session's receive queue.

FastAPI itself is optional: the adapter speaks the ASGI3 protocol, and
the tests exercise it with dependency-free ASGI apps. The module imports
neither torch nor the runtime.
"""

from __future__ import annotations

import asyncio
from typing import Any, Dict


_CLOSED = object()  # websocket-session tombstone (see __serve_ws_feed__)


def _encode_scope(scope: Dict[str, Any]) -> Dict[str, Any]:
    """Wire scope (str values, picklable) -> ASGI-spec scope: headers,
    query_string, and raw_path must be bytes (Starlette/FastAPI decode
    them)."""
    scope = dict(scope)
    scope["headers"] = [(k.encode(), v.encode())
                        for k, v in scope.get("headers", [])]
    qs = scope.get("query_string", b"")
    if isinstance(qs, str):
        scope["query_string"] = qs.encode()
    rp = scope.get("raw_path", b"")
    if isinstance(rp, str):
        scope["raw_path"] = rp.encode()
    return scope


def ingress(asgi_app: Any):
    """Class decorator binding *asgi_app* as the deployment's HTTP
    surface (apply UNDER @serve.deployment, reference api.py:172)."""

    def decorator(cls):
        class ASGIIngress(cls):
            # static marker the serve controller publishes with the route
            # so the proxy dispatches ASGI-style without probing user code
            __serve_is_asgi__ = True

            def _ws_sessions(self) -> Dict[str, asyncio.Queue]:
                if not hasattr(self, "__ws_sessions__"):
                    self.__ws_sessions__ = {}
                return self.__ws_sessions__

            async def __serve_asgi__(self, scope: Dict[str, Any],
                                     body: bytes):
                """HTTP: async generator yielding the response-start
                event first, then body chunks (streams incrementally when
                the app streams)."""
                scope = _encode_scope(scope)
                sent_request = False

                async def receive():
                    nonlocal sent_request
                    if not sent_request:
                        sent_request = True
                        return {"type": "http.request",
                                "body": body or b"", "more_body": False}
                    # Starlette's listen_for_disconnect awaits a second
                    # receive() WHILE streaming; returning http.disconnect
                    # here would abort every StreamingResponse. Block
                    # until the request task is torn down instead.
                    await asyncio.Event().wait()

                queue: asyncio.Queue = asyncio.Queue()

                async def send(event):
                    await queue.put(event)

                async def run_app():
                    try:
                        await asgi_app(scope, receive, send)
                    except Exception as e:  # surfaces as a 500 downstream
                        await queue.put({"type": "__app_error__",
                                         "error": f"{type(e).__name__}: {e}"})
                    finally:
                        await queue.put({"type": "__app_done__"})

                task = asyncio.ensure_future(run_app())
                try:
                    started = False
                    while True:
                        event = await queue.get()
                        etype = event["type"]
                        if etype == "http.response.start":
                            started = True
                            yield {"status": event["status"],
                                   "headers": [
                                       (k.decode(), v.decode())
                                       for k, v in event.get("headers", [])]}
                        elif etype == "http.response.body":
                            chunk = event.get("body", b"")
                            if chunk:
                                yield chunk
                            if not event.get("more_body", False):
                                return
                        elif etype == "__app_error__":
                            if not started:
                                yield {"status": 500,
                                       "headers": [("content-type",
                                                    "text/plain")]}
                            yield event["error"].encode()
                            return
                        elif etype == "__app_done__":
                            if not started:
                                yield {"status": 500,
                                       "headers": [("content-type",
                                                    "text/plain")]}
                                yield b"ASGI app sent no response"
                            return
                finally:
                    task.cancel()

            async def __serve_ws__(self, session_id: str,
                                   scope: Dict[str, Any]):
                """Websocket: async generator of outbound ASGI events;
                inbound frames arrive via __serve_ws_feed__."""
                scope = _encode_scope(scope)
                scope["type"] = "websocket"
                inbound = self._ws_sessions().setdefault(
                    session_id, asyncio.Queue())
                await inbound.put({"type": "websocket.connect"})
                outbound: asyncio.Queue = asyncio.Queue()

                async def receive():
                    return await inbound.get()

                async def send(event):
                    await outbound.put(event)

                async def run_app():
                    try:
                        await asgi_app(scope, receive, send)
                    except Exception as e:
                        await outbound.put({"type": "websocket.close",
                                            "code": 1011,
                                            "reason": f"{e}"})
                    finally:
                        await outbound.put({"type": "__app_done__"})

                task = asyncio.ensure_future(run_app())
                try:
                    while True:
                        event = await outbound.get()
                        if event["type"] == "__app_done__":
                            return
                        yield event
                        if event["type"] == "websocket.close":
                            return
                finally:
                    task.cancel()
                    # tombstone, not pop: the proxy's final disconnect
                    # feed must not setdefault() a fresh queue that then
                    # leaks (one per closed websocket on a long-lived
                    # replica)
                    self._ws_sessions()[session_id] = _CLOSED

            async def __serve_ws_feed__(self, session_id: str,
                                        event: Dict[str, Any]) -> bool:
                """Inbound client frame -> the session's receive queue.
                Async so it runs on the actor loop (asyncio.Queue is not
                thread-safe). Returns False when the session is gone."""
                sessions = self._ws_sessions()
                q = sessions.get(session_id)
                if q is _CLOSED:
                    # session over. Only the proxy's FINAL feed (the
                    # disconnect in its finally block) clears the
                    # tombstone — an in-flight data frame racing the
                    # close must not consume it, or the disconnect feed
                    # would setdefault a fresh queue and leak it
                    if event.get("type") == "websocket.disconnect":
                        sessions.pop(session_id, None)
                    return False
                if q is None:
                    # a client frame can race __serve_ws__'s queue
                    # registration (the proxy feeds per-message while the
                    # streaming call is still being scheduled) — early
                    # frames must buffer, not drop
                    q = sessions.setdefault(session_id, asyncio.Queue())
                q.put_nowait(event)
                return True

        ASGIIngress.__name__ = cls.__name__
        ASGIIngress.__qualname__ = cls.__qualname__
        ASGIIngress.__module__ = cls.__module__
        return ASGIIngress

    return decorator
