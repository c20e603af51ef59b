"""A small asyncio HTTP/1.1 server on the standard library.

Port of ``kfserving_tpu/server/http.py``.  One process owns the card, so
one asyncio event loop serves every connection while the engines' worker
threads run the device work.  Supports keep-alive, Content-Length bodies,
chunked transfer decoding, and streaming (chunked) responses with write
backpressure for token streams.  A stop closes idle keep-alive
connections (a peer's connection pool would otherwise hold it open) and
waits for responses in flight.
"""

import asyncio
import logging
import re
from typing import Awaitable, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qsl, unquote

logger = logging.getLogger("kfserving_tpu_torch.http")

MAX_HEADER_BYTES = 64 * 1024
# Same default cap as the reference server's tornado max_buffer_size
# (reference kfserver.py:31).
MAX_BODY_BYTES = 104857600

STATUS_PHRASES = {
    200: "OK", 204: "No Content", 400: "Bad Request", 404: "Not Found",
    405: "Method Not Allowed", 411: "Length Required",
    413: "Payload Too Large", 500: "Internal Server Error",
    502: "Bad Gateway", 503: "Service Unavailable",
    504: "Gateway Timeout",
}


class Request:
    __slots__ = ("method", "path", "query", "headers", "body", "path_params")

    def __init__(self, method: str, path: str, query: Dict[str, str],
                 headers: Dict[str, str], body: bytes):
        self.method = method
        self.path = path
        self.query = query
        self.headers = headers
        self.body = body
        self.path_params: Dict[str, str] = {}


class Response:
    __slots__ = ("status", "body", "headers")

    def __init__(self, body: bytes = b"", status: int = 200,
                 headers: Optional[Dict[str, str]] = None,
                 content_type: str = "application/json"):
        self.status = status
        self.body = body
        self.headers = headers or {}
        self.headers.setdefault("content-type", content_type)


class StreamingResponse(Response):
    """Chunked-transfer response whose body is an async iterator of byte
    chunks (the token-streaming surface of generative models): each
    chunk is flushed as one HTTP/1.1 chunk as it is produced."""

    __slots__ = ("chunks",)

    def __init__(self, chunks, status: int = 200,
                 headers: Optional[Dict[str, str]] = None,
                 content_type: str = "text/event-stream"):
        super().__init__(b"", status=status, headers=headers,
                         content_type=content_type)
        self.chunks = chunks


Handler = Callable[[Request], Awaitable[Response]]


class Router:
    """Regex route table; literal-prefix fast path for hot routes."""

    def __init__(self):
        self._routes: List[Tuple[str, re.Pattern, Handler]] = []
        self._exact: Dict[Tuple[str, str], Handler] = {}

    def add(self, method: str, pattern: str, handler: Handler) -> None:
        """`pattern` uses {name} placeholders, e.g. /v1/models/{name}:predict.

        Placeholders match the reference's model-name charset
        (reference kfserver.py:68: `[a-zA-Z0-9_-]+`, we additionally allow
        dots for versioned names).
        """
        if "{" not in pattern:
            self._exact[(method, pattern)] = handler
            return
        parts = re.split(r"\{(\w+)\}", pattern)
        regex = ""
        for i, part in enumerate(parts):
            if i % 2 == 0:
                regex += re.escape(part)
            else:
                regex += f"(?P<{part}>[a-zA-Z0-9_.-]+)"
        self._routes.append((method, re.compile(f"^{regex}$"), handler))

    def resolve(self, method: str, path: str
                ) -> Tuple[Optional[Handler], Dict[str, str]]:
        handler = self._exact.get((method, path))
        if handler is not None:
            return handler, {}
        for m, rx, h in self._routes:
            if m != method:
                continue
            match = rx.match(path)
            if match:
                return h, match.groupdict()
        return None, {}


class _HttpProtocol(asyncio.Protocol):
    __slots__ = ("server", "transport", "_buf", "_expect_body", "_headers",
                 "_method", "_target", "_keepalive", "_chunked", "_task",
                 "_chunk_out", "_chunk_pos", "_can_write")

    def __init__(self, server: "HTTPServer"):
        self.server = server
        self.transport: Optional[asyncio.Transport] = None
        self._buf = bytearray()
        self._expect_body = -1  # -1: parsing headers
        self._headers: Dict[str, str] = {}
        self._method = ""
        self._target = ""
        self._keepalive = True
        self._chunked = False
        self._task: Optional[asyncio.Task] = None
        # Incremental chunked-decoding state (persists across packets so a
        # large chunked body is decoded in O(n), not re-parsed per packet).
        self._chunk_out = bytearray()
        self._chunk_pos = 0
        # Set while the transport accepts writes (cleared between
        # pause_writing and resume_writing).
        self._can_write = asyncio.Event()
        self._can_write.set()

    def connection_made(self, transport):
        self.transport = transport
        self.server.connections.add(self)
        try:
            transport.get_extra_info("socket").setsockopt(
                __import__("socket").IPPROTO_TCP,
                __import__("socket").TCP_NODELAY, 1)
        except (OSError, AttributeError):
            pass

    def data_received(self, data: bytes):
        self._buf += data
        self._process()

    def _process(self):
        while True:
            if self._expect_body < 0:
                end = self._buf.find(b"\r\n\r\n")
                if end < 0:
                    if len(self._buf) > MAX_HEADER_BYTES:
                        self._fail(400, "headers too large")
                    return
                head = bytes(self._buf[:end])
                del self._buf[:end + 4]
                try:
                    self._parse_head(head)
                except ValueError as e:
                    self._fail(400, str(e))
                    return
            if self._chunked:
                if len(self._chunk_out) > MAX_BODY_BYTES:
                    self._fail(413, "body too large")
                    return
                body = self._try_dechunk()
                if body is None:
                    return
                self._dispatch(body)
            else:
                if self._expect_body > MAX_BODY_BYTES:
                    self._fail(413, "body too large")
                    return
                if len(self._buf) < self._expect_body:
                    return
                body = bytes(self._buf[:self._expect_body])
                del self._buf[:self._expect_body]
                self._dispatch(body)
            if not self._buf:
                return

    def _parse_head(self, head: bytes):
        lines = head.split(b"\r\n")
        try:
            method, target, _version = lines[0].decode("latin1").split(" ", 2)
        except ValueError:
            raise ValueError("malformed request line")
        headers: Dict[str, str] = {}
        for line in lines[1:]:
            k, _, v = line.decode("latin1").partition(":")
            headers[k.strip().lower()] = v.strip()
        self._method = method
        self._target = target
        self._headers = headers
        self._keepalive = headers.get("connection", "").lower() != "close"
        te = headers.get("transfer-encoding", "").lower()
        self._chunked = "chunked" in te
        if self._chunked:
            self._expect_body = 0
            self._chunk_out = bytearray()
            self._chunk_pos = 0
        else:
            try:
                self._expect_body = int(headers.get("content-length", "0") or "0")
            except ValueError:
                raise ValueError("invalid content-length")
            if self._expect_body < 0:
                raise ValueError("invalid content-length")

    def _try_dechunk(self) -> Optional[bytes]:
        """Incrementally decode chunked body bytes from the buffer.

        Consumes complete chunks into self._chunk_out as they arrive (O(n)
        over the body); returns the full body when the terminal chunk is
        seen, else None.
        """
        buf = self._buf
        while True:
            nl = buf.find(b"\r\n", self._chunk_pos)
            if nl < 0:
                return None
            try:
                size = int(bytes(buf[self._chunk_pos:nl]).split(b";")[0], 16)
            except ValueError:
                self._fail(400, "bad chunk size")
                return None
            start = nl + 2
            if size == 0:
                tail = buf.find(b"\r\n", start)
                if tail < 0:
                    return None
                del buf[:tail + 2]
                self._chunk_pos = 0
                body = bytes(self._chunk_out)
                self._chunk_out = bytearray()
                return body
            if len(buf) < start + size + 2:
                return None
            self._chunk_out += buf[start:start + size]
            if len(self._chunk_out) > MAX_BODY_BYTES:
                self._fail(413, "body too large")
                return None
            # Drop consumed bytes so the buffer never re-parses old chunks.
            del buf[:start + size + 2]
            self._chunk_pos = 0

    def _dispatch(self, body: bytes):
        method, target, headers = self._method, self._target, self._headers
        keepalive = self._keepalive
        self._expect_body = -1
        self._headers = {}
        path, _, qs = target.partition("?")
        query = dict(parse_qsl(qs)) if qs else {}
        request = Request(method, unquote(path), query, headers, body)
        prev = self._task
        self._task = asyncio.ensure_future(
            self._respond(request, keepalive, prev))

    async def _respond(self, request: Request, keepalive: bool,
                       prev: Optional[asyncio.Task]):
        try:
            response = await self.server.handle(request)
        except Exception:
            logger.exception("unhandled error serving %s %s",
                             request.method, request.path)
            response = Response(b'{"error": "internal server error"}',
                                status=500)
        # Handlers may run concurrently, but responses on one connection
        # must be written in request order (HTTP/1.1 pipelining).
        if prev is not None and not prev.done():
            await asyncio.shield(prev)
        if self.transport is None or self.transport.is_closing():
            # Client gone before the response started.  A streaming body
            # still holds resources (an engine decode slot) released by
            # its close path: close it now, not at garbage collection.
            if isinstance(response, StreamingResponse):
                from kfserving_tpu_torch.streams import aclose_quietly

                await aclose_quietly(response.chunks,
                                     "unstarted stream producer")
            return
        if isinstance(response, StreamingResponse):
            await self._write_streaming(response, keepalive)
            return
        self.transport.write(encode_response(response, keepalive))
        if not keepalive:
            self.transport.close()

    async def _write_streaming(self, response: StreamingResponse,
                               keepalive: bool):
        phrase = STATUS_PHRASES.get(response.status, "Unknown")
        lines = [f"HTTP/1.1 {response.status} {phrase}"]
        for k, v in response.headers.items():
            lines.append(f"{k}: {v}")
        lines.append("transfer-encoding: chunked")
        lines.append("connection: " + ("keep-alive" if keepalive
                                       else "close"))
        self.transport.write(
            ("\r\n".join(lines) + "\r\n\r\n").encode("latin1"))
        try:
            try:
                async for chunk in response.chunks:
                    if not chunk:
                        continue
                    if self.transport is None or \
                            self.transport.is_closing():
                        return  # client went away: stop producing
                    self.transport.write(b"%x\r\n" % len(chunk) + chunk
                                         + b"\r\n")
                    # Backpressure: a slow client must not buffer the
                    # whole generation in memory.
                    await self._can_write.wait()
            except Exception:
                logger.exception("streaming body failed mid-response")
                # The chunked framing is committed: close the connection
                # so the client sees a truncated stream, not a success.
                if self.transport is not None:
                    self.transport.close()
                return
            if self.transport is not None and \
                    not self.transport.is_closing():
                self.transport.write(b"0\r\n\r\n")
                if not keepalive:
                    self.transport.close()
        finally:
            # Close the producer on every exit path (client gone,
            # mid-stream failure): its close path frees engine work.
            from kfserving_tpu_torch.streams import aclose_quietly

            await aclose_quietly(response.chunks, "stream producer")

    def pause_writing(self):
        self._can_write.clear()

    def resume_writing(self):
        self._can_write.set()

    def _fail(self, status: int, reason: str):
        # Chain behind any in-flight response so a pipelined connection never
        # sees the failure attributed to an earlier request.
        resp = Response(('{"error": "%s"}' % reason).encode(), status=status)
        prev = self._task
        self._task = asyncio.ensure_future(self._write_failure(resp, prev))

    async def _write_failure(self, resp: Response,
                             prev: Optional[asyncio.Task]):
        if prev is not None and not prev.done():
            await asyncio.shield(prev)
        if self.transport and not self.transport.is_closing():
            self.transport.write(encode_response(resp, False))
            self.transport.close()

    def idle(self) -> bool:
        """Between requests on a keep-alive connection: nothing read of
        a next request and no response owed."""
        return (self._expect_body < 0 and not self._buf
                and (self._task is None or self._task.done()))

    def connection_lost(self, exc):
        self.server.connections.discard(self)
        self.transport = None
        # Unblock a streaming writer waiting on backpressure; it sees
        # the transport gone and stops.
        self._can_write.set()


def encode_response(resp: Response, keepalive: bool) -> bytes:
    phrase = STATUS_PHRASES.get(resp.status, "Unknown")
    lines = [f"HTTP/1.1 {resp.status} {phrase}"]
    for k, v in resp.headers.items():
        lines.append(f"{k}: {v}")
    lines.append(f"content-length: {len(resp.body)}")
    lines.append("connection: " + ("keep-alive" if keepalive else "close"))
    head = ("\r\n".join(lines) + "\r\n\r\n").encode("latin1")
    return head + resp.body


class HTTPServer:
    def __init__(self, router: Router):
        self.router = router
        self._server: Optional[asyncio.AbstractServer] = None
        self.port: Optional[int] = None
        # Open connections (their protocols), so a stop can close the
        # idle keep-alive ones: a peer's pooled connection would
        # otherwise hold wait_closed() open indefinitely.
        self.connections: set = set()

    async def handle(self, request: Request) -> Response:
        handler, params = self.router.resolve(request.method, request.path)
        if handler is None:
            return Response(b'{"error": "not found"}', status=404)
        request.path_params = params
        return await handler(request)

    async def start(self, host: str = "0.0.0.0", port: int = 8080):
        loop = asyncio.get_running_loop()
        self._server = await loop.create_server(
            lambda: _HttpProtocol(self), host, port)
        self.port = self._server.sockets[0].getsockname()[1]
        logger.info("Listening on port %s", self.port)

    async def stop(self):
        """Stop listening, close idle keep-alive connections, and wait for
        the responses still being written."""
        if self._server is not None:
            self._server.close()
            for conn in list(self.connections):
                if conn.idle() and conn.transport is not None:
                    conn.transport.close()
            await self._server.wait_closed()
            self._server = None
