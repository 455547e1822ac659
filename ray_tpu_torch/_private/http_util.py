"""Minimal asyncio HTTP server for daemon endpoints (/metrics, /healthz).

The daemons' RPC substrate is a binary protocol (rpc.py); Prometheus and
humans speak HTTP. This is a deliberately tiny HTTP/1.0 responder — one
request per connection, GET only — sufficient for scrape endpoints
(≈ the reference's metrics agent exposing the Prometheus port).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Callable, Dict, Optional, Tuple

logger = logging.getLogger(__name__)


class HttpNotFound(Exception):
    """Raise from a handler to produce a 404 instead of a 500."""


class MetricsHttpServer:
    """Tiny route table over HTTP/1.0.

    Handlers are registered per (method, path); a path ending in '/*'
    matches any suffix (passed as `tail`). A handler may be sync or
    async and returns (content_type, text); JSON handlers can return a
    plain dict/list which is serialized for them. POST handlers receive
    (body_bytes, tail); GET handlers receive (tail) when their route is
    a prefix route, else no args — introspected by arity.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._host = host
        self._port = port
        self._routes: Dict[Tuple[str, str], Callable] = {}
        self._server: Optional[asyncio.AbstractServer] = None

    def route(self, path: str, handler: Callable, method: str = "GET"):
        self._routes[(method.upper(), path)] = handler

    @property
    def port(self) -> int:
        return self._port

    async def start(self) -> int:
        self._server = await asyncio.start_server(
            self._handle, self._host, self._port)
        self._port = self._server.sockets[0].getsockname()[1]
        return self._port

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            try:
                await asyncio.wait_for(self._server.wait_closed(), timeout=2)
            except Exception:
                pass

    def _match(self, method: str, path: str):
        exact = self._routes.get((method, path))
        if exact is not None:
            return exact, None
        for (m, pat), handler in self._routes.items():
            if m == method and pat.endswith("/*") and \
                    path.startswith(pat[:-1]):
                return handler, path[len(pat) - 1:]
        return None, None

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            line = await asyncio.wait_for(reader.readline(), timeout=10)
            parts = line.decode("latin1").split()
            method = parts[0].upper() if parts else "GET"
            path = parts[1].split("?")[0] if len(parts) >= 2 else "/"
            clen = 0
            while True:
                h = await asyncio.wait_for(reader.readline(), timeout=10)
                if h in (b"\r\n", b"\n", b""):
                    break
                if h.lower().startswith(b"content-length:"):
                    clen = int(h.split(b":", 1)[1].strip())
            req_body = (await asyncio.wait_for(
                reader.readexactly(clen), timeout=30)) if clen else b""

            handler, tail = self._match(method, path)
            if handler is None:
                self._write(writer, 404, "text/plain", "not found")
                return
            args = []
            if method in ("POST", "PUT", "DELETE"):
                args.append(req_body)
            if tail is not None:
                args.append(tail)
            try:
                result = handler(*args)
                if asyncio.iscoroutine(result):
                    result = await result
                if isinstance(result, tuple):
                    ctype, text = result
                else:  # plain JSON-able value
                    import json as _json

                    ctype, text = "application/json", _json.dumps(result)
                self._write(writer, 200, ctype, text)
            except HttpNotFound as e:
                self._write(writer, 404, "text/plain", str(e))
            except Exception as e:  # noqa: BLE001 — surface as 500
                logger.debug("http handler failed", exc_info=True)
                self._write(writer, 500, "text/plain",
                            f"{type(e).__name__}: {e}")
            await writer.drain()
        except Exception:
            logger.debug("http request failed", exc_info=True)
        finally:
            try:
                writer.close()
            except Exception:
                pass

    @staticmethod
    def _write(writer, status: int, ctype: str, text: str) -> None:
        body = text.encode()
        reason = {200: "OK", 404: "Not Found", 500: "Error"}.get(
            status, "OK")
        head = (f"HTTP/1.0 {status} {reason}\r\nContent-Type: {ctype}\r\n"
                f"Content-Length: {len(body)}\r\n\r\n")
        writer.write(head.encode("latin1") + body)
