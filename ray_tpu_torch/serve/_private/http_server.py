"""A small HTTP/1.1 server on asyncio streams, with websockets (RFC 6455).

The JAX package's serve proxy (``ray_tpu/serve/_private/proxy.py``) runs
on aiohttp's server, which the port does not depend on. This module stands
in for the part of aiohttp that the proxy uses, so it has no counterpart
module in the JAX package; ``proxy.py`` uses it the way JAX's proxy uses
``aiohttp.web``.

    server = HttpServer(handler, host="0.0.0.0", port=0)
    host, port = await server.start()

``handler(request)`` is a coroutine that returns a ``Response``, or a
``StreamResponse`` / ``WebSocketResponse`` it has already prepared and
written itself. What it serves:

  * requests: the request line and headers (``MAX_HEADER_BYTES`` of them,
    431 past that), a body by ``Content-Length`` or chunked transfer
    (``MAX_BODY_BYTES``, 413 past that), ``Expect: 100-continue``, the
    query string; a malformed request gets 400 and the connection closes;
  * connections: keep-alive (HTTP/1.1 unless ``Connection: close``;
    HTTP/1.0 with ``Connection: keep-alive``), requests answered in order;
  * responses: with a ``Content-Length``, or chunked (``StreamResponse``:
    ``prepare``, ``write``, ``write_eof``);
  * websockets: the upgrade handshake, then text, binary and fragmented
    messages, ping (answered with a pong), pong, and close with a code;
    client frames must be masked (1002 otherwise) and a message may hold
    ``MAX_WS_MESSAGE`` bytes (1009 past that);
  * a client that goes away mid-response: the next write raises
    ``ConnectionResetError`` to that handler and the connection closes;
    every other connection goes on being served.
"""

from __future__ import annotations

import asyncio
import base64
import enum
import hashlib
import json
import logging
import struct
from http import HTTPStatus
from typing import Any, Awaitable, Callable, Dict, List, NamedTuple, Optional
from urllib.parse import parse_qsl, unquote

logger = logging.getLogger(__name__)

MAX_HEADER_BYTES = 32 * 1024   # request line and headers together
MAX_BODY_BYTES = 1 << 20       # aiohttp's default client_max_size
MAX_WS_MESSAGE = 4 << 20       # aiohttp's default max_msg_size
WS_CLOSE_TIMEOUT_S = 10.0      # wait this long for the peer's close reply
WS_GUID = b"258EAFA5-E914-47DA-95CA-C5AB0DC85B11"  # RFC 6455 section 1.3

TEXT_PLAIN = "text/plain; charset=utf-8"
APPLICATION_JSON = "application/json; charset=utf-8"
OCTET_STREAM = "application/octet-stream"


class HttpError(Exception):
    """A request the server answers itself, with ``status``, and then
    closes the connection."""

    def __init__(self, status: int, text: str):
        super().__init__(text)
        self.status = status


class Headers:
    """Header pairs in arrival order; lookups ignore case."""

    def __init__(self, pairs: List[tuple]):
        self._pairs = pairs

    def get(self, name: str, default: Optional[str] = None) -> Optional[str]:
        name = name.lower()
        for k, v in self._pairs:
            if k.lower() == name:
                return v
        return default

    def items(self) -> List[tuple]:
        return list(self._pairs)


class _Conn:
    """One client connection: its streams, and whether it is still fit
    for another request."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer
        peer = writer.get_extra_info("peername")
        self.remote = peer[0] if peer else None
        self.broken = False
        self.responded = False  # a response head went out for this request

    async def write(self, data: bytes) -> None:
        if self.writer.is_closing():
            self.broken = True
            raise ConnectionResetError("the client closed the connection")
        self.writer.write(data)
        try:
            await self.writer.drain()
        except (ConnectionError, OSError):
            self.broken = True
            raise


class Request:
    def __init__(self, conn: _Conn, method: str, target: str, version: str,
                 headers: Headers, body: bytes, framed: bool):
        self._conn = conn
        self.method = method
        self.version = version
        self.raw_path, _, self.query_string = target.partition("?")
        self.path = unquote(self.raw_path)
        self.headers = headers
        self.body = body
        # a body was framed (chunked, or a Content-Length above 0): as
        # aiohttp's can_read_body, which the proxy branches on
        self.can_read_body = framed
        self.remote = conn.remote

    @property
    def query(self) -> Dict[str, str]:
        """The query's fields; the first of a repeated name wins."""
        out: Dict[str, str] = {}
        for k, v in parse_qsl(self.query_string, keep_blank_values=True):
            out.setdefault(k, v)
        return out

    async def read(self) -> bytes:
        return self.body

    def keep_alive(self) -> bool:
        conn = (self.headers.get("Connection") or "").lower()
        if self.version == "HTTP/1.0":
            return "keep-alive" in conn
        return "close" not in conn


def _reason(status: int) -> str:
    try:
        return HTTPStatus(status).phrase
    except ValueError:
        return "Unknown"


def _head(status: int, headers: Dict[str, str]) -> bytes:
    lines = [f"HTTP/1.1 {status} {_reason(status)}"]
    lines += [f"{k}: {v}" for k, v in headers.items()]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


class Response:
    """A whole response: the server writes it with a Content-Length."""

    def __init__(self, *, status: int = 200, body: bytes = b"",
                 text: Optional[str] = None,
                 content_type: str = OCTET_STREAM):
        if text is not None:
            body, content_type = text.encode(), TEXT_PLAIN
        self.status = status
        self.body = body
        self.content_type = content_type

    async def _send(self, conn: _Conn, keep_alive: bool) -> None:
        headers = {"Content-Type": self.content_type,
                   "Content-Length": str(len(self.body)),
                   "Connection": "keep-alive" if keep_alive else "close"}
        conn.responded = True
        await conn.write(_head(self.status, headers) + self.body)


def json_response(obj: Any) -> Response:
    return Response(body=json.dumps(obj).encode(),
                    content_type=APPLICATION_JSON)


class StreamResponse:
    """A chunked response the handler writes piece by piece."""

    def __init__(self, *, status: int = 200,
                 headers: Optional[Dict[str, str]] = None):
        self.status = status
        self.headers = dict(headers or {})
        self.finished = False
        self._conn: Optional[_Conn] = None

    async def prepare(self, request: Request) -> None:
        self._conn = request._conn
        headers = {k: v for k, v in self.headers.items()
                   if k.lower() not in ("content-length",
                                        "transfer-encoding", "connection")}
        if not any(k.lower() == "content-type" for k in headers):
            headers["Content-Type"] = OCTET_STREAM
        headers["Transfer-Encoding"] = "chunked"
        headers["Connection"] = ("keep-alive" if request.keep_alive()
                                 else "close")
        self._conn.responded = True
        await self._conn.write(_head(self.status, headers))

    async def write(self, data: bytes) -> None:
        if data:
            await self._conn.write(b"%x\r\n%s\r\n" % (len(data), data))

    async def write_eof(self) -> None:
        if not self.finished:
            await self._conn.write(b"0\r\n\r\n")
            self.finished = True


# ---------------------------------------------------------------- websocket


class WSMsgType(enum.IntEnum):
    TEXT = 0x1
    BINARY = 0x2
    CLOSE = 0x8
    CLOSED = 0x101   # the connection ended without a close frame
    ERROR = 0x102    # the peer broke the protocol; a close was sent


_CONT, _TEXT, _BINARY, _CLOSE, _PING, _PONG = 0x0, 0x1, 0x2, 0x8, 0x9, 0xA


class WSMessage(NamedTuple):
    type: WSMsgType
    data: Any          # str (text), bytes (binary), int (close code)


class _WSProtocolError(Exception):
    def __init__(self, code: int, reason: str):
        super().__init__(reason)
        self.code = code


def _ws_accept_key(key: str) -> str:
    """``Sec-WebSocket-Accept`` for a client's ``Sec-WebSocket-Key``."""
    return base64.b64encode(
        hashlib.sha1(key.encode() + WS_GUID).digest()).decode()


def _ws_frame(opcode: int, payload: bytes) -> bytes:
    """One whole frame as a server sends it: final, unmasked."""
    n = len(payload)
    if n < 126:
        head = struct.pack("!BB", 0x80 | opcode, n)
    elif n < 1 << 16:
        head = struct.pack("!BBH", 0x80 | opcode, 126, n)
    else:
        head = struct.pack("!BBQ", 0x80 | opcode, 127, n)
    return head + payload


def _unmask(key: bytes, data: bytes) -> bytes:
    n = len(data)
    whole = (key * (n // 4 + 1))[:n]
    return (int.from_bytes(data, "big") ^ int.from_bytes(whole, "big")
            ).to_bytes(n, "big")


class WebSocketResponse:
    """The server's side of one websocket: ``prepare`` answers the
    upgrade, then ``receive`` (or ``async for``) reads messages while
    ``send_str``/``send_bytes`` write them and ``close`` ends the
    session."""

    def __init__(self):
        self._conn: Optional[_Conn] = None
        self._close_sent = False
        self._closed = False           # no more messages will be read
        self._abort: Optional[asyncio.TimerHandle] = None

    async def prepare(self, request: Request) -> None:
        h = request.headers
        key = h.get("Sec-WebSocket-Key")
        if (request.method != "GET"
                or (h.get("Upgrade") or "").lower() != "websocket"
                or "upgrade" not in (h.get("Connection") or "").lower()
                or h.get("Sec-WebSocket-Version") != "13" or not key):
            raise HttpError(400, "not a websocket upgrade")
        self._conn = request._conn
        self._conn.responded = True
        await self._conn.write(_head(101, {
            "Upgrade": "websocket", "Connection": "Upgrade",
            "Sec-WebSocket-Accept": _ws_accept_key(key)}))

    async def send_str(self, data: str) -> None:
        await self._conn.write(_ws_frame(_TEXT, data.encode()))

    async def send_bytes(self, data: bytes) -> None:
        await self._conn.write(_ws_frame(_BINARY, bytes(data)))

    async def close(self, code: int = 1000, reason: str = "") -> None:
        """Send a close frame (once). The peer's reply ends ``receive``;
        without one, the connection is cut after ``WS_CLOSE_TIMEOUT_S``."""
        if self._close_sent or self._conn is None:
            return
        self._close_sent = True
        try:
            await self._conn.write(_ws_frame(
                _CLOSE, struct.pack("!H", code) + reason.encode()))
        except (ConnectionError, OSError):
            self._closed = True
            return
        if self._closed:
            self._conn.writer.close()
        else:
            self._abort = asyncio.get_running_loop().call_later(
                WS_CLOSE_TIMEOUT_S, self._conn.writer.close)

    def __aiter__(self):
        return self

    async def __anext__(self) -> WSMessage:
        msg = await self.receive()
        if msg.type in (WSMsgType.CLOSE, WSMsgType.CLOSED, WSMsgType.ERROR):
            raise StopAsyncIteration
        return msg

    async def receive(self) -> WSMessage:
        if self._closed:
            return WSMessage(WSMsgType.CLOSED, None)
        try:
            return await self._receive()
        except _WSProtocolError as e:
            self._closed = True
            await self.close(e.code, str(e))
            return WSMessage(WSMsgType.ERROR, e.code)
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            self._closed = True
            return WSMessage(WSMsgType.CLOSED, None)
        finally:
            if self._closed and self._abort is not None:
                self._abort.cancel()

    async def _receive(self) -> WSMessage:
        parts: List[bytes] = []
        first = None                   # opcode of the fragmented message
        size = 0
        while True:
            fin, opcode, payload = await self._read_frame()
            if opcode == _PING:
                await self._conn.write(_ws_frame(_PONG, payload))
                continue
            if opcode == _PONG:
                continue
            if opcode == _CLOSE:
                return await self._on_close(payload)
            if opcode == _CONT:
                if first is None:
                    raise _WSProtocolError(1002, "continuation of nothing")
            elif first is not None:
                raise _WSProtocolError(1002, "new message inside a "
                                             "fragmented one")
            else:
                first = opcode
            size += len(payload)
            if size > MAX_WS_MESSAGE:
                raise _WSProtocolError(1009, "message too big")
            parts.append(payload)
            if fin:
                data = b"".join(parts)
                if first == _BINARY:
                    return WSMessage(WSMsgType.BINARY, data)
                try:
                    return WSMessage(WSMsgType.TEXT, data.decode())
                except UnicodeDecodeError:
                    raise _WSProtocolError(1007, "text is not UTF-8")

    async def _on_close(self, payload: bytes) -> WSMessage:
        if len(payload) == 1:
            raise _WSProtocolError(1002, "close payload of one byte")
        code = struct.unpack("!H", payload[:2])[0] if payload else 1005
        self._closed = True
        # answer with the peer's code, unless this side closed first
        await self.close(1000 if code == 1005 else code)
        self._conn.writer.close()
        return WSMessage(WSMsgType.CLOSE, code)

    async def _read_frame(self):
        read = self._conn.reader.readexactly
        b0, b1 = await read(2)
        fin, opcode = bool(b0 & 0x80), b0 & 0x0F
        if b0 & 0x70:
            raise _WSProtocolError(1002, "reserved bits set")
        if opcode not in (_CONT, _TEXT, _BINARY, _CLOSE, _PING, _PONG):
            raise _WSProtocolError(1002, f"unknown opcode {opcode:#x}")
        if not b1 & 0x80:
            raise _WSProtocolError(1002, "client frames must be masked")
        n = b1 & 0x7F
        if opcode >= _CLOSE and (not fin or n > 125):
            raise _WSProtocolError(1002, "bad control frame")
        if n == 126:
            n = struct.unpack("!H", await read(2))[0]
        elif n == 127:
            n = struct.unpack("!Q", await read(8))[0]
        if n > MAX_WS_MESSAGE:
            raise _WSProtocolError(1009, "frame too big")
        key = await read(4)
        return fin, opcode, _unmask(key, await read(n))


# ------------------------------------------------------------------- server


Handler = Callable[[Request], Awaitable[Any]]


class HttpServer:
    def __init__(self, handler: Handler, host: str = "127.0.0.1",
                 port: int = 0):
        self._handler = handler
        self._host = host
        self._port = port
        self._server: Optional[asyncio.AbstractServer] = None

    async def start(self) -> tuple:
        """Bind and listen; returns (host, port), the real port when 0
        was asked for. Raises ``OSError`` when the bind fails."""
        self._server = await asyncio.start_server(
            self._serve, self._host, self._port, limit=MAX_HEADER_BYTES)
        self._port = self._server.sockets[0].getsockname()[1]
        return self._host, self._port

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def _serve(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        conn = _Conn(reader, writer)
        try:
            while not conn.broken:
                try:
                    request = await self._read_request(conn)
                except HttpError as e:
                    await Response(status=e.status, text=str(e))._send(
                        conn, keep_alive=False)
                    return
                if request is None:
                    return
                if not await self._answer(request):
                    return
        except (ConnectionError, OSError, asyncio.IncompleteReadError):
            pass
        finally:
            writer.close()

    async def _answer(self, request: Request) -> bool:
        """Run the handler and send its response; True when the
        connection may carry another request."""
        conn = request._conn
        conn.responded = False
        keep_alive = request.keep_alive()
        try:
            resp = await self._handler(request)
        except HttpError as e:
            resp, keep_alive = Response(status=e.status, text=str(e)), False
        except Exception:  # noqa: BLE001 — the server answers for it
            logger.exception("http handler failed on %s", request.path)
            resp = Response(status=500, text="Internal Server Error")
        if isinstance(resp, WebSocketResponse):
            return False
        if isinstance(resp, StreamResponse):
            return keep_alive and resp.finished and not conn.broken
        if conn.responded:
            return False  # a handler failed after its head went out
        await resp._send(conn, keep_alive)
        return keep_alive

    async def _read_request(self, conn: _Conn) -> Optional[Request]:
        try:
            head = await conn.reader.readuntil(b"\r\n\r\n")
        except asyncio.IncompleteReadError as e:
            if e.partial.strip():
                raise HttpError(400, "incomplete request head")
            return None  # the client closed between requests
        except asyncio.LimitOverrunError:
            raise HttpError(431, "request header fields too large")
        lines = head[:-4].decode("latin-1").split("\r\n")
        parts = lines[0].split(" ")
        if len(parts) != 3 or not parts[2].startswith("HTTP/1.") \
                or not parts[1].startswith("/"):
            raise HttpError(400, "malformed request line")
        method, target, version = parts
        pairs = []
        for line in lines[1:]:
            name, sep, value = line.partition(":")
            if not sep or not name or name != name.strip():
                raise HttpError(400, "malformed header line")
            pairs.append((name, value.strip()))
        headers = Headers(pairs)
        chunked = "chunked" in (headers.get("Transfer-Encoding") or "").lower()
        length = headers.get("Content-Length")
        try:
            n = int(length) if length is not None else 0
        except ValueError:
            raise HttpError(400, "bad Content-Length")
        if n < 0:
            raise HttpError(400, "bad Content-Length")
        if n > MAX_BODY_BYTES:
            raise HttpError(413, "request body too large")
        if (chunked or n) and (headers.get("Expect") or "").lower() \
                == "100-continue":
            await conn.write(b"HTTP/1.1 100 Continue\r\n\r\n")
        if chunked:
            body = await self._read_chunked(conn.reader)
        else:
            body = await conn.reader.readexactly(n) if n else b""
        return Request(conn, method, target, version, headers, body,
                       framed=chunked or n > 0)

    @staticmethod
    async def _read_chunked(reader: asyncio.StreamReader) -> bytes:
        parts: List[bytes] = []
        size = 0
        try:
            while True:
                line = await reader.readuntil(b"\r\n")
                n = int(line.split(b";", 1)[0].strip(), 16)
                if n == 0:
                    while (await reader.readuntil(b"\r\n")) != b"\r\n":
                        pass  # trailer fields are read and dropped
                    return b"".join(parts)
                size += n
                if size > MAX_BODY_BYTES:
                    raise HttpError(413, "request body too large")
                parts.append(await reader.readexactly(n))
                if await reader.readexactly(2) != b"\r\n":
                    raise HttpError(400, "malformed chunk")
        except (ValueError, asyncio.LimitOverrunError):
            raise HttpError(400, "malformed chunk")
