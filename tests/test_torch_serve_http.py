"""The port's HTTP ingress against the JAX package's, side by side: the
same deployments behind JAX's ``serve.start`` (aiohttp) and the port's
(``ray_tpu_torch/serve/_private/http_server.py``), the same requests to
both, and the answers equal in status, body, ``content-type``, ``x-app``
and ``x-serve-stream``. The cases: ``tests/test_serve.py::
test_http_proxy``, the proxy's other reply kinds (routes, query payloads,
text, bytes, errors, chunk-pull streams and their error tail), the six
cases of ``tests/test_serve_asgi.py`` on its own ``_echo_app``, and the
websocket echo with aiohttp's client and with a raw-socket client
(masked fragmented text, a ping, a close; an unmasked frame refused). Then
unit tests of the port's server alone: a chunked request body,
keep-alive, 400 and 431, and a client gone mid-stream while the server
goes on serving. A JAX-side call that times out runs once more
(``jax_side``: a fault of the JAX runtime that the port's copy no longer
has); the port's side runs once."""

import asyncio
import base64
import hashlib
import json
import os
import socket
import struct
import subprocess
import time

import aiohttp
import httpx
import pytest

import ray_tpu
import ray_tpu_torch as rt
from ray_tpu import serve as jserve
from ray_tpu._private.rpc import RpcTimeoutError as JaxRpcTimeoutError
from ray_tpu_torch import serve
from ray_tpu_torch.serve._private import http_server
from tests.test_serve_asgi import _echo_app
from tests.test_torch_runtime_cluster import retire_leftover_jax_runtime

os.environ.setdefault("RAY_TPU_TORCH_LOG_LEVEL", "WARNING")

TIMEOUT = 60
JAX_TIMEOUT = 20  # a JAX-side wait this long is a hang; see jax_side
COMPARED = ("content-type", "x-app", "x-serve-stream")


def jax_side(call):
    """``call()`` against the JAX package's ingress, run once more if it
    times out. The JAX runtime can lose an awaited ref's value for good
    (a ref dropped at once is freed before its get: the fault repaired in
    the port's copy, ROADMAP §C), and in the JAX proxy or RPC ingress that
    stalls one request or websocket session. The port's side is never
    retried."""
    try:
        return call()
    except (TimeoutError, httpx.TimeoutException, JaxRpcTimeoutError,
            subprocess.TimeoutExpired):
        return call()


@pytest.fixture(scope="module")
def port_base():
    """A JAX cluster and a port cluster in this process; the port's proxy
    up for the module. Yields the port proxy's base URL."""
    retire_leftover_jax_runtime()
    ray_tpu.init(num_cpus=16, object_store_memory=128 * 1024 * 1024)
    rt.init(num_cpus=16, num_gpus=0, object_store_memory=128 * 1024 * 1024)
    try:
        yield f"http://127.0.0.1:{serve.start(http_port=0)}"
    finally:
        serve.shutdown()
        rt.shutdown()
        jserve.shutdown()
        retire_leftover_jax_runtime()


@pytest.fixture
def deploy(port_base):
    """deploy((name, jax_app, port_app, prefix), ...): the applications in
    both packages, then JAX's proxy started after them, as JAX's own tests
    do (a JAX proxy started first may never see a later route, its route
    refresh stalled as ``jax_side`` says); waits until both proxies list
    just these routes. Returns the base URLs, JAX's first. JAX's serve is
    shut down and the port's applications deleted after the test."""
    names = []

    def _deploy(*apps):
        for name, jax_app, port_app, prefix in apps:
            names.append(name)
            jserve.run(jax_app, name=name, route_prefix=prefix)
            serve.run(port_app, name=name, route_prefix=prefix)
        bases = [f"http://127.0.0.1:{jserve.start(http_port=0)}", port_base]
        prefixes = {a[3] for a in apps}
        deadline = time.monotonic() + TIMEOUT
        for who, base in zip(("JAX's proxy", "the port's proxy"), bases):
            # exactly these routes: the port's proxy may still list the
            # last test's for up to a second
            while set(_routes(who, base)) != prefixes:
                assert time.monotonic() < deadline, \
                    f"{who} at {base} never routed just {prefixes}"
                time.sleep(0.1)
        return bases

    yield _deploy
    jserve.shutdown()
    for name in names:
        serve.delete(name)


def _routes(who: str, base: str):
    """One proxy's route table; a proxy that does not answer within
    ``TIMEOUT`` fails the test naming which proxy it was."""
    try:
        return httpx.get(base + "/-/routes", timeout=TIMEOUT).json()
    except httpx.TimeoutException as e:
        raise AssertionError(f"{who} at {base} did not answer /-/routes "
                             f"within {TIMEOUT} s: {e!r}") from e


def _both(bases, method, path, **kw):
    jax_base, port_base = bases
    return [jax_side(lambda: httpx.request(method, jax_base + path,
                                           timeout=JAX_TIMEOUT, **kw)),
            httpx.request(method, port_base + path, timeout=TIMEOUT, **kw)]


def _same(jax_r, port_r):
    assert port_r.status_code == jax_r.status_code, (jax_r.text, port_r.text)
    assert port_r.content == jax_r.content
    for h in COMPARED:
        assert port_r.headers.get(h) == jax_r.headers.get(h), h


def _pair(bases, method, path, **kw):
    jax_r, port_r = _both(bases, method, path, **kw)
    _same(jax_r, port_r)
    return port_r


class Echo:
    def __call__(self, payload):
        return {"got": payload}


class Replies:
    """One reply of each kind the proxy tells apart."""

    def __call__(self, payload):
        kind = payload.get("kind") if isinstance(payload, dict) else None
        if kind == "text":
            return "plain words"
        if kind == "bytes":
            return b"\x00raw\xff"
        if kind == "list":
            return [1, 2.5, None, True]
        if kind == "number":
            return 7
        if kind == "fail":
            raise ValueError("refused by the deployment")
        return payload


class Tokens:
    def __call__(self, req):
        def gen():
            for i in range(int(req["n"])):
                yield f"tok{i} "
            if req.get("fail"):
                raise ValueError("boom mid-stream")
        return gen()


def _apps(name, cls, prefix):
    return (name, jserve.deployment(cls).bind(),
            serve.deployment(cls).bind(), prefix)


def test_http_proxy(deploy):
    """``tests/test_serve.py::test_http_proxy``: health check, a JSON
    body through an Echo deployment, 404 off every route."""
    bases = deploy(_apps("http", Echo, "/echo"))
    assert _pair(bases, "GET", "/-/healthz").text == "ok"
    r = _pair(bases, "POST", "/echo", json={"x": 1})
    assert r.status_code == 200 and r.json() == {"got": {"x": 1}}
    r404 = _pair(bases, "GET", "/nope")
    assert r404.status_code == 404 and r404.text == "no route"


def test_reply_kinds_and_query_payloads(deploy):
    bases = deploy(_apps("replies", Replies, "/replies"))
    routes = _pair(bases, "GET", "/-/routes").json()
    assert routes["/replies"] == "replies/Replies"
    for kind in ("text", "bytes", "list", "number"):
        _pair(bases, "POST", "/replies", json={"kind": kind})
    # no body: the query's fields are the payload
    r = _pair(bases, "GET", "/replies?kind=x&a=1&a=2")
    assert r.json() == {"kind": "x", "a": "1"}
    assert _pair(bases, "GET", "/replies").json() is None
    # a body that is not JSON reaches the deployment as text, and a str
    # reply goes back as text
    assert _pair(bases, "POST", "/replies",
                 content=b"not json").text == "not json"
    jax_r, port_r = _both(bases, "POST", "/replies", json={"kind": "fail"})
    assert port_r.status_code == jax_r.status_code == 500
    assert port_r.headers["content-type"] == jax_r.headers["content-type"]
    for r in (jax_r, port_r):
        assert "refused by the deployment" in r.text


def test_streamed_reply(deploy):
    """A deployment that returns a generator: a chunked ``X-Serve-Stream``
    reply over the replica's chunk pull, and its error tail."""
    bases = deploy(_apps("tokens", Tokens, "/tokens"))
    r = _pair(bases, "POST", "/tokens", json={"n": 5})
    assert r.headers["x-serve-stream"] == "1"
    assert r.text == "".join(f"tok{i} " for i in range(5))
    jax_r, port_r = _both(bases, "POST", "/tokens",
                          json={"n": 2, "fail": True})
    for r in (jax_r, port_r):
        assert r.status_code == 200
        assert r.text.startswith("tok0 tok1 \n[stream error: ")
        assert "boom mid-stream" in r.text


# ----------------------------------------------- tests/test_serve_asgi.py


def _asgi_apps():
    @jserve.deployment(name="App")
    @jserve.ingress(_echo_app)
    class JaxApp:
        pass

    @serve.deployment(name="App")
    @serve.ingress(_echo_app)
    class PortApp:
        pass

    return "asgiapp", JaxApp.bind(), PortApp.bind(), "/api"


@pytest.fixture
def bases(deploy):
    """Both proxies in front of ``tests/test_serve_asgi.py``'s app."""
    return deploy(_asgi_apps())


def test_asgi_http_roundtrip_and_headers(bases):
    r = _pair(bases, "POST", "/api/", content="hello")
    assert r.status_code == 200
    assert r.headers["x-app"] == "asgi-echo"
    out = r.json()
    assert out["method"] == "POST" and out["path"] == "/"
    assert out["got"] == "hello"


def _streamed(base, timeout):
    chunks = []
    with httpx.stream("GET", base + "/api/stream", timeout=timeout) as r:
        assert r.status_code == 200
        for chunk in r.iter_raw():
            chunks.append(chunk)
        return b"".join(chunks), {h: r.headers.get(h) for h in COMPARED}


def test_asgi_streaming_response(bases):
    jax_out = jax_side(lambda: _streamed(bases[0], JAX_TIMEOUT))
    port_out = _streamed(bases[1], TIMEOUT)
    assert port_out == jax_out
    assert port_out[0] == b"chunk0;chunk1;chunk2;chunk3;end"


def test_asgi_app_error_becomes_500(bases):
    r = _pair(bases, "GET", "/api/boom")
    assert r.status_code == 500 and "app exploded" in r.text


def test_asgi_unknown_path_404_from_app(bases):
    r = _pair(bases, "GET", "/api/missing")
    assert r.status_code == 404 and r.text == "nope"


async def _aiohttp_echo(base, timeout):
    async with aiohttp.ClientSession() as sess:
        async with sess.ws_connect(
                base + "/api/ws",
                timeout=aiohttp.ClientWSTimeout(ws_close=timeout)) as ws:
            await ws.send_str("hi")
            first = await asyncio.wait_for(ws.receive_str(), timeout)
            await ws.send_str("there")
            second = await asyncio.wait_for(ws.receive_str(), timeout)
            await ws.send_str("close")
            closed = await asyncio.wait_for(ws.receive(), timeout)
            return first, second, closed.type, ws.close_code


def test_asgi_websocket_echo(bases):
    jax_out = jax_side(
        lambda: asyncio.run(_aiohttp_echo(bases[0], JAX_TIMEOUT)))
    port_out = asyncio.run(_aiohttp_echo(bases[1], TIMEOUT))
    assert port_out == jax_out
    first, second, closed_type, code = port_out
    assert (first, second, code) == ("echo:hi", "echo:there", 1000)
    assert closed_type in (aiohttp.WSMsgType.CLOSE, aiohttp.WSMsgType.CLOSED)


def test_asgi_plain_deployments_unaffected(deploy):
    """Non-ASGI deployments keep the plain JSON contract beside an ASGI
    one."""
    bases = deploy(_asgi_apps(), _apps("plain", Doubler, "/plain"))
    r = _pair(bases, "POST", "/plain", json=21)
    assert r.json() == {"doubled": 42}


class Doubler:
    def __call__(self, payload):
        return {"doubled": (payload or 0) * 2}


# ------------------------------------------------- a raw websocket client


class _RawWS:
    """A websocket client on a bare socket, framing by RFC 6455 here (not
    with the server's code): client frames masked unless asked not to."""

    def __init__(self, base: str, path: str, timeout: float = TIMEOUT):
        host, port = base.rsplit("/", 1)[1].split(":")
        self.sock = socket.create_connection((host, int(port)),
                                             timeout=timeout)
        key = base64.b64encode(os.urandom(16)).decode()
        self.sock.sendall((
            f"GET {path} HTTP/1.1\r\nHost: {host}\r\nUpgrade: websocket\r\n"
            f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
            f"Sec-WebSocket-Version: 13\r\n\r\n").encode())
        self.buf = b""
        while b"\r\n\r\n" not in self.buf:
            self.buf += self._recv_some()
        head, self.buf = self.buf.split(b"\r\n\r\n", 1)
        lines = head.decode().split("\r\n")
        self.status = int(lines[0].split()[1])
        headers = {k.lower(): v.strip() for k, v in
                   (line.split(":", 1) for line in lines[1:])}
        want = base64.b64encode(hashlib.sha1(
            (key + "258EAFA5-E914-47DA-95CA-C5AB0DC85B11").encode()
        ).digest()).decode()
        self.accept_ok = headers.get("sec-websocket-accept") == want

    def _recv_some(self) -> bytes:
        data = self.sock.recv(65536)
        if not data:
            raise ConnectionError("server closed the connection")
        return data

    def _take(self, n: int) -> bytes:
        while len(self.buf) < n:
            self.buf += self._recv_some()
        out, self.buf = self.buf[:n], self.buf[n:]
        return out

    def send(self, opcode: int, payload: bytes, fin: bool = True,
             mask: bool = True) -> None:
        head = bytes([(0x80 if fin else 0) | opcode])
        bit = 0x80 if mask else 0
        n = len(payload)
        if n < 126:
            head += bytes([bit | n])
        else:
            head += bytes([bit | 126]) + struct.pack("!H", n)
        if mask:
            key = os.urandom(4)
            head += key
            payload = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
        self.sock.sendall(head + payload)

    def recv(self):
        """(opcode, payload) of the next server frame; (None, b"") once
        the server has closed the connection."""
        try:
            b0, b1 = self._take(2)
        except ConnectionError:
            return None, b""
        assert not b1 & 0x80, "server frames are never masked"
        n = b1 & 0x7F
        if n == 126:
            n = struct.unpack("!H", self._take(2))[0]
        elif n == 127:
            n = struct.unpack("!Q", self._take(8))[0]
        return b0 & 0x0F, self._take(n)

    def close(self):
        self.sock.close()


TEXT, CONT, CLOSE, PING, PONG = 0x1, 0x0, 0x8, 0x9, 0xA


def _raw_session(base, timeout):
    ws = _RawWS(base, "/api/ws", timeout)
    try:
        assert ws.status == 101 and ws.accept_ok
        ws.send(TEXT, b"he", fin=False)
        ws.send(CONT, b"ll", fin=False)
        ws.send(PING, b"p1")        # a control frame between fragments
        ws.send(CONT, "o é".encode())
        frames = [ws.recv(), ws.recv()]
        ws.send(CLOSE, struct.pack("!H", 1000) + b"bye")
        reply = ws.recv()
        return frames, (reply[0], reply[1][:2])
    finally:
        ws.close()


def test_websocket_raw_client(bases):
    jax_out = jax_side(lambda: _raw_session(bases[0], JAX_TIMEOUT))
    port_out = _raw_session(bases[1], TIMEOUT)
    assert port_out == jax_out
    frames, close = port_out
    assert frames == [(PONG, b"p1"), (TEXT, "echo:hello é".encode())]
    assert close == (CLOSE, struct.pack("!H", 1000))


def test_websocket_unmasked_frame_refused(bases):
    """A client frame without a mask is a protocol error (RFC 6455
    section 5.1): the port's server answers with close code 1002 and
    ends the connection, and the app never sees the frame."""
    ws = _RawWS(bases[1], "/api/ws")
    try:
        assert ws.status == 101
        ws.send(TEXT, b"unmasked", mask=False)
        opcode, payload = ws.recv()
        assert (opcode, payload[:2]) == (CLOSE, struct.pack("!H", 1002))
        assert ws.recv() == (None, b"")
    finally:
        ws.close()


# --------------------------------------------- the port's server, alone


def _serve(handler, client):
    """Run ``client(port)`` in a thread against an ``HttpServer`` on this
    thread's loop; returns what the client returns."""
    async def main():
        server = http_server.HttpServer(handler)
        _, port = await server.start()
        try:
            return await asyncio.wait_for(
                asyncio.to_thread(client, port), TIMEOUT)
        finally:
            await server.stop()

    return asyncio.run(main())


async def _echo_handler(request):
    return http_server.json_response({
        "method": request.method, "path": request.path,
        "query": request.query, "body": request.body.decode(),
        "framed": request.can_read_body})


def _exchange(port, raw: bytes) -> bytes:
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=TIMEOUT) as s:
        s.sendall(raw)
        out = b""
        while True:
            data = s.recv(65536)
            if not data:
                return out
            out += data


def test_server_chunked_request_body():
    def client(port):
        return httpx.post(f"http://127.0.0.1:{port}/up?x=1",
                          content=iter([b"ab", b"", b"cdef", b"g"]),
                          timeout=TIMEOUT)

    r = _serve(_echo_handler, client)
    assert r.status_code == 200
    assert r.headers["content-type"] == "application/json; charset=utf-8"
    assert r.json() == {"method": "POST", "path": "/up", "query": {"x": "1"},
                        "body": "abcdefg", "framed": True}


def test_server_keep_alive():
    """Two requests and a chunked response on one connection, answered in
    order; ``Connection: close`` ends it."""
    async def handler(request):
        if request.path == "/stream":
            resp = http_server.StreamResponse(
                headers={"Content-Type": "text/plain"})
            await resp.prepare(request)
            for piece in (b"a", b"bc"):
                await resp.write(piece)
            await resp.write_eof()
            return resp
        return await _echo_handler(request)

    def client(port):
        import http.client

        c = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
        c.request("POST", "/one", body=b"1")
        r1 = c.getresponse()
        one = (r1.status, json.loads(r1.read())["body"])
        sock = c.sock
        c.request("GET", "/stream")
        r2 = c.getresponse()
        two = (r2.status, r2.getheader("transfer-encoding"), r2.read())
        same = c.sock is sock
        c.request("GET", "/three", headers={"Connection": "close"})
        r3 = c.getresponse()
        three = (r3.status, r3.getheader("connection"), r3.read())
        c.close()
        return one, two, same, three

    one, two, same, three = _serve(handler, client)
    assert one == (200, "1")
    assert two == (200, "chunked", b"abc")
    assert same
    assert three[:2] == (200, "close")


def test_server_malformed_request_is_400():
    out = _serve(_echo_handler, lambda port: [
        _exchange(port, b"NOT-HTTP\r\n\r\n"),
        _exchange(port, b"GET /x HTTP/1.1\r\nno colon here\r\n\r\n"),
        _exchange(port, b"POST /x HTTP/1.1\r\nContent-Length: -3\r\n\r\n"),
        _exchange(port, b"POST /x HTTP/1.1\r\nTransfer-Encoding: chunked"
                        b"\r\n\r\nzz\r\n")])
    for raw in out:
        assert raw.startswith(b"HTTP/1.1 400 Bad Request\r\n"), raw
        assert b"Connection: close" in raw


def test_server_header_cap_is_431():
    big = b"X-Pad: " + b"a" * http_server.MAX_HEADER_BYTES + b"\r\n"
    out = _serve(_echo_handler, lambda port: [
        _exchange(port, b"GET / HTTP/1.1\r\n" + big + b"\r\n"),
        _exchange(port, b"GET /ok HTTP/1.1\r\nConnection: close\r\n\r\n")])
    assert out[0].startswith(b"HTTP/1.1 431 Request Header Fields Too "
                             b"Large\r\n")
    assert out[1].startswith(b"HTTP/1.1 200 OK\r\n")  # still serving


def test_server_client_gone_mid_stream():
    """A client that drops a chunked response: that handler's next write
    raises, its connection closes, and a client connected all along and
    a new one are both still served."""
    ended = []

    async def handler(request):
        if request.path != "/forever":
            return await _echo_handler(request)
        resp = http_server.StreamResponse()
        await resp.prepare(request)
        try:
            while True:
                await resp.write(b"x" * 1024)
                await asyncio.sleep(0.01)
        except ConnectionError as e:
            ended.append(type(e).__name__)
        return resp

    def client(port):
        import http.client

        keep = http.client.HTTPConnection("127.0.0.1", port,
                                          timeout=TIMEOUT)
        keep.request("GET", "/before")
        assert keep.getresponse().read()
        with socket.create_connection(("127.0.0.1", port),
                                      timeout=TIMEOUT) as s:
            s.sendall(b"GET /forever HTTP/1.1\r\nHost: x\r\n\r\n")
            assert s.recv(4096).startswith(b"HTTP/1.1 200 OK\r\n")
        deadline = time.monotonic() + TIMEOUT
        while not ended and time.monotonic() < deadline:
            time.sleep(0.02)
        keep.request("GET", "/after-on-the-old-connection")
        old = json.loads(keep.getresponse().read())["path"]
        keep.close()
        new = httpx.get(f"http://127.0.0.1:{port}/after", timeout=TIMEOUT)
        return old, new.json()["path"]

    old, new = _serve(handler, client)
    assert ended == ["ConnectionResetError"] or ended == [
        "BrokenPipeError"]
    assert (old, new) == ("/after-on-the-old-connection", "/after")


@pytest.mark.parametrize("extra", [0, 1 << 20])
def test_server_websocket_protocol_error_drains_before_close(extra):
    """An unmasked frame, then ``extra`` more bytes, most of them still in
    the server's socket when it refuses the frame: the client reads the
    1002 close frame and then a clean end of stream, never a reset (a
    socket closed over unread bytes sends RST, and the peer may lose the
    close frame); the app sees an ERROR, not the frame."""
    seen = []

    async def handler(request):
        ws = http_server.WebSocketResponse()
        await ws.prepare(request)
        msg = await ws.receive()
        seen.append(msg.type)
        return ws

    def client(port):
        ws = _RawWS(f"http://127.0.0.1:{port}", "/ws")
        try:
            assert ws.status == 101
            try:
                ws.send(TEXT, b"unmasked", mask=False)
                ws.sock.sendall(b"x" * extra)
            except (BrokenPipeError, ConnectionResetError) as e:
                return ("send", type(e).__name__)
            first = ws.recv()  # (None, b"") if a reset lost the frame
            assert not ws.buf
            try:  # the raw socket tells a clean end from a reset
                end = ws.sock.recv(1)
            except ConnectionResetError as e:
                end = type(e).__name__
            return first[0], first[1][:2], end
        finally:
            ws.close()

    out = _serve(handler, client)
    assert out == (CLOSE, struct.pack("!H", 1002), b""), out
    assert seen == [http_server.WSMsgType.ERROR]
