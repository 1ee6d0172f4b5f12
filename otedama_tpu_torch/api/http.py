"""Minimal asyncio HTTP/1.1 server with routing, plus RFC6455 websockets
(counterpart of ``otedama_tpu/api/http.py``).

The image has no aiohttp/fastapi (no pip installs), and http.server is
thread-blocking — the ops shell is asyncio end-to-end, so this module
implements the small HTTP subset the API needs: request-line + headers
parse, fixed-size bodies, JSON helpers, and the websocket upgrade +
unfragmented text frames for the live-stats push.

Reference parity: the role of internal/api/server.go's gin router; the
surface is deliberately tiny (the reference pulls in a web framework).
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import json
import logging
import re
import struct
from typing import Awaitable, Callable

log = logging.getLogger("otedama.api.http")

_WS_MAGIC = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
MAX_HEADER_BYTES = 16 * 1024
MAX_BODY_BYTES = 1 << 20


class Request:
    def __init__(self, method: str, path: str, query: dict[str, str],
                 headers: dict[str, str], body: bytes, peer: str):
        self.method = method
        self.path = path
        self.query = query
        self.headers = headers
        self.body = body
        self.peer = peer
        self.params: dict[str, str] = {}   # route captures

    def json(self):
        """Parse the request body with resource caps (size/depth/key-count,
        security.validation) — handlers must never see a RecursionError or
        a multi-hundred-MB allocation from a hostile body. Raises
        json.JSONDecodeError for malformed/oversized input so existing
        handlers' except clauses keep working."""
        if not self.body:
            return None
        from otedama_tpu_torch.security import validation as val

        try:
            return val.validate_json_body(self.body)
        except val.ValidationError as e:
            raise json.JSONDecodeError(str(e), "", 0) from None


class Response:
    def __init__(self, status: int = 200, body: bytes | str = b"",
                 content_type: str = "text/plain; charset=utf-8",
                 headers: dict[str, str] | None = None):
        self.status = status
        self.body = body.encode() if isinstance(body, str) else body
        self.content_type = content_type
        self.headers = headers or {}

    @classmethod
    def json(cls, obj, status: int = 200) -> "Response":
        return cls(status, json.dumps(obj), "application/json")

    @classmethod
    def error(cls, status: int, message: str) -> "Response":
        return cls.json({"error": message}, status)

    def encode(self) -> bytes:
        reason = {200: "OK", 400: "Bad Request", 401: "Unauthorized",
                  403: "Forbidden", 404: "Not Found", 405: "Method Not Allowed",
                  429: "Too Many Requests", 500: "Internal Server Error",
                  503: "Service Unavailable",
                  101: "Switching Protocols"}.get(self.status, "Status")
        head = [f"HTTP/1.1 {self.status} {reason}"]
        hdrs = {
            "content-type": self.content_type,
            "content-length": str(len(self.body)),
            "connection": "close",
            **self.headers,
        }
        for k, v in hdrs.items():
            head.append(f"{k}: {v}")
        return ("\r\n".join(head) + "\r\n\r\n").encode() + self.body


Handler = Callable[[Request], Awaitable[Response]]
WsHandler = Callable[[Request, "WebSocket"], Awaitable[None]]


class WebSocket:
    """Server side of an upgraded connection (text frames, no fragmentation)."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer
        self.closed = False

    async def send_text(self, text: str) -> None:
        payload = text.encode()
        n = len(payload)
        if n < 126:
            header = struct.pack("!BB", 0x81, n)
        elif n < (1 << 16):
            header = struct.pack("!BBH", 0x81, 126, n)
        else:
            header = struct.pack("!BBQ", 0x81, 127, n)
        self.writer.write(header + payload)
        await self.writer.drain()

    async def send_json(self, obj) -> None:
        await self.send_text(json.dumps(obj))

    async def recv(self) -> str | None:
        """One text message; None on close (any mid-frame disconnect closes)."""
        while True:
            try:
                head = await self.reader.readexactly(2)
                opcode = head[0] & 0x0F
                masked = head[1] & 0x80
                length = head[1] & 0x7F
                if length == 126:
                    length = struct.unpack("!H", await self.reader.readexactly(2))[0]
                elif length == 127:
                    length = struct.unpack("!Q", await self.reader.readexactly(8))[0]
                if length > MAX_BODY_BYTES:
                    self.closed = True
                    return None
                mask = await self.reader.readexactly(4) if masked else b"\x00" * 4
                payload = bytearray(await self.reader.readexactly(length))
            except (asyncio.IncompleteReadError, ConnectionError):
                self.closed = True
                return None
            for i in range(length):
                payload[i] ^= mask[i % 4]
            if opcode == 0x8:  # close
                self.closed = True
                return None
            if opcode == 0x9:  # ping -> pong
                if len(payload) > 125:  # RFC 6455: control frames cap at 125
                    self.closed = True
                    return None
                try:
                    self.writer.write(
                        struct.pack("!BB", 0x8A, len(payload)) + bytes(payload)
                    )
                    await self.writer.drain()
                except (ConnectionError, RuntimeError):
                    self.closed = True
                    return None
                continue
            if opcode in (0x1, 0x2):
                return payload.decode(errors="replace")

    async def close(self) -> None:
        if not self.closed:
            self.closed = True
            try:
                self.writer.write(struct.pack("!BB", 0x88, 0))
                await self.writer.drain()
            except (ConnectionError, RuntimeError):
                pass
        self.writer.close()


class HttpServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host = host
        self.port = port
        self._routes: list[tuple[str, re.Pattern, Handler]] = []
        self._ws_routes: list[tuple[re.Pattern, WsHandler]] = []
        self._middleware: list[Callable[[Request], Awaitable[Response | None]]] = []
        self._server: asyncio.AbstractServer | None = None

    def route(self, method: str, pattern: str, handler: Handler) -> None:
        """Pattern supports ``{name}`` captures."""
        regex = re.compile(
            "^" + re.sub(r"\{(\w+)\}", r"(?P<\1>[^/]+)", pattern) + "$"
        )
        self._routes.append((method.upper(), regex, handler))

    def websocket(self, pattern: str, handler: WsHandler) -> None:
        regex = re.compile(
            "^" + re.sub(r"\{(\w+)\}", r"(?P<\1>[^/]+)", pattern) + "$"
        )
        self._ws_routes.append((regex, handler))

    def middleware(self, fn) -> None:
        """fn(request) -> Response to short-circuit, or None to continue."""
        self._middleware.append(fn)

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        log.info("http server on %s:%d", self.host, self.port)

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            request = await self._read_request(reader, writer)
            if request is None:
                writer.close()
                return
            # websocket upgrade? (middleware — rate limiting — applies first)
            if request.headers.get("upgrade", "").lower() == "websocket":
                for fn in self._middleware:
                    early = await fn(request)
                    if early is not None:
                        writer.write(early.encode())
                        await writer.drain()
                        writer.close()
                        return
                await self._handle_ws(request, reader, writer)
                return
            response = await self._dispatch(request)
        except Exception:
            log.exception("request handling failed")
            response = Response.error(500, "internal error")
        try:
            writer.write(response.encode())
            await writer.drain()
        except (ConnectionError, RuntimeError):
            pass
        finally:
            writer.close()

    async def _read_request(self, reader, writer) -> Request | None:
        try:
            head = await asyncio.wait_for(
                reader.readuntil(b"\r\n\r\n"), timeout=10.0
            )
        except (asyncio.IncompleteReadError, asyncio.TimeoutError,
                asyncio.LimitOverrunError, ConnectionError):
            return None
        if len(head) > MAX_HEADER_BYTES:
            return None
        lines = head.decode(errors="replace").split("\r\n")
        try:
            method, target, _version = lines[0].split(" ", 2)
        except ValueError:
            return None
        headers: dict[str, str] = {}
        for line in lines[1:]:
            if ":" in line:
                k, v = line.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        path, _, query_str = target.partition("?")
        query = {}
        for pair in query_str.split("&"):
            if "=" in pair:
                k, v = pair.split("=", 1)
                query[k] = v
        body = b""
        length = int(headers.get("content-length", "0") or 0)
        if length:
            if length > MAX_BODY_BYTES:
                return None
            try:
                body = await asyncio.wait_for(
                    reader.readexactly(length), timeout=10.0
                )
            except (asyncio.IncompleteReadError, asyncio.TimeoutError):
                return None
        peer = writer.get_extra_info("peername")
        return Request(
            method.upper(), path, query, headers, body,
            peer[0] if peer else "?",
        )

    async def _dispatch(self, request: Request) -> Response:
        for fn in self._middleware:
            early = await fn(request)
            if early is not None:
                return early
        allowed = set()
        for method, regex, handler in self._routes:
            m = regex.match(request.path)
            if m:
                if method == request.method:
                    request.params = m.groupdict()
                    return await handler(request)
                allowed.add(method)
        if allowed:
            return Response.error(405, "method not allowed")
        return Response.error(404, "not found")

    async def _handle_ws(self, request: Request, reader, writer) -> None:
        handler = None
        for regex, h in self._ws_routes:
            m = regex.match(request.path)
            if m:
                request.params = m.groupdict()
                handler = h
                break
        key = request.headers.get("sec-websocket-key", "")
        if handler is None or not key:
            writer.write(Response.error(404, "no websocket here").encode())
            writer.close()
            return
        accept = base64.b64encode(
            hashlib.sha1((key + _WS_MAGIC).encode()).digest()
        ).decode()
        writer.write(
            b"HTTP/1.1 101 Switching Protocols\r\n"
            b"upgrade: websocket\r\nconnection: Upgrade\r\n"
            + f"sec-websocket-accept: {accept}\r\n\r\n".encode()
        )
        await writer.drain()
        ws = WebSocket(reader, writer)
        try:
            await handler(request, ws)
        except (ConnectionError, RuntimeError):
            pass
        finally:
            await ws.close()
