"""HTTP ingress proxy.

Counterpart: ``ray_tpu/serve/_private/proxy.py``, on the port's own
HTTP/1.1 server (``http_server.py``) where the JAX proxy runs on aiohttp.
Analog of `ray.serve._private.proxy.ProxyActor/HTTPProxy`
(`python/ray/serve/_private/proxy.py:1112,748`, proxy_request `:424`): an
async actor runs the server on its actor event loop; requests route by
longest matching route prefix to the app's ingress deployment handle and
flow through the same power-of-two router as Python-side calls. The
module imports the runtime only, never torch: a proxy process takes no
card.
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import Any, Dict, Optional

from ray_tpu_torch.serve._private import http_server as web

logger = logging.getLogger(__name__)


class ProxyActor:
    def __init__(self, controller, port: int):
        self._controller = controller
        self._port = port
        self._routes: Dict[str, Any] = {}
        self._route_asgi: Dict[str, bool] = {}  # target -> ASGI ingress
        self._handles: Dict[str, Any] = {}
        self._server: Optional[web.HttpServer] = None
        self._refresher: Optional[asyncio.Task] = None
        self._started_evt = asyncio.Event()
        self._start_error: Optional[str] = None

    async def ready(self) -> int:
        await self._start()
        return self._port

    async def _start(self):
        if self._server is not None:
            # a concurrent first caller may still be mid-bind: wait until
            # the real port is known before reporting it
            await self._started_evt.wait()
            if self._start_error:
                raise RuntimeError(self._start_error)
            return
        self._server = web.HttpServer(self._handle, "0.0.0.0", self._port)
        try:
            _, port = await self._server.start()
        except BaseException as e:
            # a failed bind (port in use) must not wedge future ready()
            # calls behind a never-set event
            self._server = None
            self._start_error = f"proxy bind failed: {e}"
            self._started_evt.set()
            self._started_evt = asyncio.Event()  # fresh gate for retries
            raise
        # an ephemeral bind (port 0) reports the real port (tests and
        # multi-tenant hosts use port 0 to avoid collisions)
        self._port = port
        self._start_error = None
        self._started_evt.set()
        self._refresher = asyncio.ensure_future(self._route_refresher())
        logger.info("serve proxy listening on :%d", self._port)

    async def _route_refresher(self):
        while True:
            await self._refresh_routes()
            await asyncio.sleep(1.0)

    async def _refresh_routes(self):
        try:
            # fetch BOTH, then assign together with no await in between:
            # assigning routes first opened a window where a request saw
            # the new route with a stale ASGI flag and took the plain
            # handle_request path into an ASGI-only deployment
            # (AttributeError: no __call__). asgi is fetched second so
            # it is at least as new as the routes it annotates.
            routes = await self._controller.get_routes.remote()
            # published by the controller from the deployment class's
            # static marker: the proxy never probes user code, and a
            # redeploy (plain <-> ASGI) takes effect on the next refresh
            route_asgi = await self._controller.get_route_asgi.remote()
            self._routes = routes
            self._route_asgi = route_asgi
        except Exception:
            pass

    async def _handle(self, request: web.Request):
        path = request.path
        if path == "/-/healthz":
            return web.Response(text="ok")
        if path == "/-/routes":
            if not self._routes:
                await self._refresh_routes()
            return web.json_response(self._routes)
        if not self._routes:
            await self._refresh_routes()
        target = None
        best = -1
        for prefix, dest in self._routes.items():
            if path.startswith(prefix) and len(prefix) > best:
                target, best = dest, len(prefix)
        if target is None:
            return web.Response(status=404, text="no route")
        handle = self._handles.get(target)
        if handle is None:
            from ray_tpu_torch.serve.handle import DeploymentHandle

            app_name, dep = target.split("/", 1)
            handle = DeploymentHandle(app_name, dep, self._controller)
            self._handles[target] = handle
        if self._route_asgi.get(target, False):
            # ASGI deployment (serve.ingress): full scope translation,
            # streaming responses, websocket bridging (proxy.py:431)
            try:
                if request.headers.get("Upgrade", "").lower() == "websocket":
                    return await self._handle_ws(request, handle, path,
                                                 best)
                return await self._handle_asgi(request, handle, path, best)
            except Exception as e:  # noqa: BLE001 — replica/router failure
                logger.exception("asgi proxy error on %s", path)
                return web.Response(status=500,
                                    text=f"{type(e).__name__}: {e}")
        try:
            if request.can_read_body:
                body = await request.read()
                try:
                    payload = json.loads(body) if body else None
                except json.JSONDecodeError:
                    payload = body.decode()
            else:
                payload = dict(request.query) or None
            # assign_request does blocking controller lookups: keep them
            # off the proxy's event loop
            loop = asyncio.get_running_loop()
            resp = await loop.run_in_executor(
                None, lambda: handle.remote(payload))
            out = await resp
            from ray_tpu_torch.serve.handle import STREAM_MARKER

            if isinstance(out, dict) and STREAM_MARKER in out:
                # token streaming: chunked transfer, one pull loop on the
                # replica that produced the stream (proxy.py:424 analog)
                return await self._stream_response(
                    request, resp._replica, out[STREAM_MARKER])
            if isinstance(out, (dict, list, int, float, bool)) or out is None:
                return web.json_response(out)
            if isinstance(out, bytes):
                return web.Response(body=out)
            return web.Response(text=str(out))
        except Exception as e:
            logger.exception("proxy error on %s", path)
            return web.Response(status=500, text=f"{type(e).__name__}: {e}")

    # ------------------------------------------------------------- ASGI

    def _asgi_scope(self, request: web.Request, path: str, prefix_len: int,
                    ws: bool = False) -> Dict[str, Any]:
        root = path[:prefix_len].rstrip("/")
        return {
            "type": "websocket" if ws else "http",
            "asgi": {"version": "3.0", "spec_version": "2.3"},
            "http_version": "1.1",
            "method": request.method,
            "scheme": "ws" if ws else "http",
            "path": path[prefix_len:] or "/",
            "raw_path": path,
            "root_path": root,
            "query_string": request.query_string,
            # header values as str pairs on the wire; the replica-side
            # adapter re-encodes to the bytes pairs ASGI requires
            "headers": [(k.lower(), v) for k, v in request.headers.items()],
            "client": (request.remote, 0),
        }

    async def _handle_asgi(self, request: web.Request, handle, path: str,
                           prefix_len: int):
        body = await request.read() if request.can_read_body else b""
        scope = self._asgi_scope(request, path, prefix_len)
        loop = asyncio.get_running_loop()
        sh = handle.options(stream=True)
        resp_obj = await loop.run_in_executor(
            None, lambda: sh._call("__serve_asgi__", (scope, body), {}))
        gen = resp_obj.ref  # ObjectRefGenerator of header + body chunks
        try:
            first_ref = await gen.__anext__()
        except StopAsyncIteration:
            return web.Response(status=500, text="empty ASGI response")
        head = await first_ref
        resp = web.StreamResponse(status=head.get("status", 200))
        for k, v in head.get("headers", []):
            if k.lower() not in ("content-length", "transfer-encoding"):
                resp.headers[k] = v
        await resp.prepare(request)
        try:
            async for chunk_ref in gen:
                chunk = await chunk_ref
                if isinstance(chunk, str):
                    chunk = chunk.encode()
                if chunk:
                    await resp.write(chunk)
        except Exception as e:  # noqa: BLE001 — mid-stream failure
            logger.warning("asgi stream aborted: %s", e)
        try:
            await resp.write_eof()
        except Exception:
            pass
        return resp

    async def _handle_ws(self, request: web.Request, handle, path: str,
                         prefix_len: int):
        """Websocket pass-through (≈ proxy.py:431): outbound ASGI events
        ride a streaming generator from the replica; inbound frames feed
        the session via per-message calls to the SAME replica."""
        import uuid

        # dispatch BEFORE upgrading: a replica/router failure here still
        # has a plain HTTP connection to answer with a 500 (after the
        # 101 upgrade there is no way to signal an error)
        sid = uuid.uuid4().hex
        scope = self._asgi_scope(request, path, prefix_len, ws=True)
        loop = asyncio.get_running_loop()
        sh = handle.options(stream=True)
        resp_obj = await loop.run_in_executor(
            None, lambda: sh._call("__serve_ws__", (sid, scope), {}))
        gen, replica = resp_obj.ref, resp_obj._replica

        ws = web.WebSocketResponse()
        await ws.prepare(request)
        # post-upgrade failures must end as close frames on THIS ws: the
        # shared 500-Response handler upstream cannot answer an
        # already-upgraded connection
        try:
            return await self._pump_ws(ws, gen, replica, sid)
        except Exception as e:  # noqa: BLE001 — replica died mid-session
            logger.warning("ws session %s failed: %s", sid[:8], e)
            try:
                await ws.close(code=1011)
            except Exception:
                pass
            return ws

    async def _pump_ws(self, ws: web.WebSocketResponse, gen, replica,
                       sid: str):
        async def pump_outbound():
            try:
                async for ev_ref in gen:
                    event = await ev_ref
                    et = event["type"]
                    if et == "websocket.accept":
                        continue  # accepted at prepare()
                    if et == "websocket.send":
                        if event.get("text") is not None:
                            await ws.send_str(event["text"])
                        elif event.get("bytes") is not None:
                            await ws.send_bytes(event["bytes"])
                    elif et == "websocket.close":
                        await ws.close(code=event.get("code", 1000))
                        return
            except Exception as e:  # noqa: BLE001
                logger.warning("ws outbound pump ended: %s", e)
                try:
                    await ws.close(code=1011)
                except Exception:
                    pass

        out_task = asyncio.ensure_future(pump_outbound())

        async def feed(event):
            await replica.handle_request.remote(
                "__serve_ws_feed__", (sid, event), {})

        try:
            async for msg in ws:
                if msg.type == web.WSMsgType.TEXT:
                    await feed({"type": "websocket.receive",
                                "text": msg.data})
                elif msg.type == web.WSMsgType.BINARY:
                    await feed({"type": "websocket.receive",
                                "bytes": msg.data})
        finally:
            try:
                await feed({"type": "websocket.disconnect", "code": 1000})
            except Exception:
                pass
            if not out_task.done():
                # give the app a moment to close gracefully
                try:
                    await asyncio.wait_for(out_task, timeout=5)
                except Exception:
                    out_task.cancel()
        return ws

    async def _stream_response(self, request: web.Request, replica,
                               stream_id: int):
        resp = web.StreamResponse(
            headers={"Content-Type": "text/plain; charset=utf-8",
                     "X-Serve-Stream": "1"})
        await resp.prepare(request)
        # once prepare() has sent 200 + headers, every failure must
        # terminate THIS response: returning a fresh 500 Response on a
        # transport mid-chunked-stream corrupts the connection
        try:
            while True:
                chunk = await replica.stream_next.remote(stream_id)
                for item in chunk["items"]:
                    if isinstance(item, bytes):
                        data = item
                    elif isinstance(item, str):
                        data = item.encode()
                    else:
                        data = (json.dumps(item) + "\n").encode()
                    await resp.write(data)
                if chunk.get("error"):
                    await resp.write(
                        f"\n[stream error: {chunk['error']}]".encode())
                    break
                if chunk["done"]:
                    break
        except Exception as e:  # noqa: BLE001 — replica died / client gone
            logger.warning("stream %d aborted: %s", stream_id, e)
            try:
                await resp.write(f"\n[stream aborted: {e}]".encode())
            except Exception:
                pass
        try:
            await resp.write_eof()
        except Exception:
            pass
        return resp
