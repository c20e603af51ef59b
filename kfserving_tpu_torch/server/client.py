"""A small asyncio HTTP/1.1 client on the standard library.

The client side of ``server/http.py``: the proxy hop of ``Model``
(``predictor_host`` / ``explainer_host``, where the JAX package holds an
aiohttp session) and the ingress router's upstream calls speak through
it.  Bodies are read by ``Content-Length``, by chunked transfer
decoding, or to the close of a connection that announced neither.

Two connection modes:

- ``keepalive=True`` (the proxy hop): idle connections are kept per
  (host, port) and reused; a request sent on a reused connection that
  the peer had closed is sent once more on a fresh one.
- ``keepalive=False`` (the router): every request opens its own
  connection, asks the peer to close it, and is never sent twice, so an
  error after the connect means the request may have reached the peer.

``open`` returns a response as soon as its head is in, so a caller can
stream the body (``iter_chunks``, one chunk per read) or ``read`` it
whole; ``close`` drops the connection, which a streaming caller does when
its own downstream goes away.

Transport failures raise ``OSError`` subclasses, so retry policies
classify them as transient: ``ConnectError`` when the connection could
not be opened (nothing of the request was sent), ``TimeoutError`` when
the budget runs out, ``HTTPClientError`` for a malformed or truncated
response, and the socket's own resets.
"""

import asyncio
import urllib.parse
from typing import AsyncIterator, Dict, List, Mapping, Optional, Tuple

MAX_HEADER_BYTES = 64 * 1024
# Idle keep-alive connections kept per (host, port).
MAX_IDLE_PER_HOST = 8
# Largest read of a Content-Length or close-delimited body while
# streaming it.
STREAM_READ_BYTES = 64 * 1024

Response = Tuple[int, Dict[str, str], bytes]


class HTTPClientError(ConnectionError):
    """The peer's response is not well-formed HTTP/1.1."""


class ConnectError(ConnectionError):
    """The connection could not be opened: nothing was sent."""


def _parse_url(url: str) -> Tuple[str, int, str]:
    parts = urllib.parse.urlsplit(url)
    if parts.scheme != "http" or not parts.hostname:
        raise ValueError(f"{url!r} is not an http:// URL")
    target = parts.path or "/"
    if parts.query:
        target = f"{target}?{parts.query}"
    return parts.hostname, parts.port or 80, target


class _Connection:
    __slots__ = ("reader", "writer")

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer

    def close(self) -> None:
        self.writer.close()


async def _read_head(conn: _Connection, method: str
                     ) -> Tuple[int, Dict[str, str], bool, bool]:
    """(status, lower-cased headers, reusable, has_body)."""
    try:
        head = await conn.reader.readuntil(b"\r\n\r\n")
    except asyncio.IncompleteReadError as e:
        raise HTTPClientError("connection closed before a response") from e
    except asyncio.LimitOverrunError as e:
        raise HTTPClientError("response headers too large") from e
    lines = head[:-4].decode("latin1").split("\r\n")
    try:
        version, code = lines[0].split(" ", 2)[:2]
        status = int(code)
    except ValueError as e:
        raise HTTPClientError(f"malformed status line {lines[0]!r}") from e
    headers: Dict[str, str] = {}
    for line in lines[1:]:
        key, _, value = line.partition(":")
        headers[key.strip().lower()] = value.strip()
    reusable = (version == "HTTP/1.1"
                and headers.get("connection", "").lower() != "close")
    has_body = not (method == "HEAD" or status in (204, 304)
                    or 100 <= status < 200)
    return status, headers, reusable, has_body


async def _iter_body(conn: _Connection, headers: Dict[str, str]
                     ) -> AsyncIterator[bytes]:
    """The body's bytes as they arrive: one item per chunk of a chunked
    body, else per read of at most STREAM_READ_BYTES."""
    reader = conn.reader
    try:
        if headers.get("transfer-encoding", "").lower() == "chunked":
            while True:
                size_line = await reader.readuntil(b"\r\n")
                size = int(size_line.split(b";", 1)[0].strip(), 16)
                if size == 0:
                    # Trailers, if any, end with an empty line.
                    while await reader.readuntil(b"\r\n") != b"\r\n":
                        pass
                    return
                data = await reader.readexactly(size)
                await reader.readexactly(2)
                yield data
        elif "content-length" in headers:
            left = int(headers["content-length"])
            while left > 0:
                data = await reader.read(min(left, STREAM_READ_BYTES))
                if not data:
                    raise HTTPClientError("connection closed mid-body")
                left -= len(data)
                yield data
        else:
            while True:
                data = await reader.read(STREAM_READ_BYTES)
                if not data:
                    return
                yield data
    except asyncio.IncompleteReadError as e:
        raise HTTPClientError("connection closed mid-body") from e
    except ValueError as e:
        raise HTTPClientError(f"malformed body framing: {e}") from e


async def _read_response(conn: _Connection, method: str
                         ) -> Tuple[int, Dict[str, str], bytes, bool]:
    """(status, lower-cased headers, body, reusable)."""
    status, headers, reusable, has_body = await _read_head(conn, method)
    if not has_body:
        return status, headers, b"", reusable
    delimited = ("content-length" in headers or headers.get(
        "transfer-encoding", "").lower() == "chunked")
    body = bytearray()
    async for data in _iter_body(conn, headers):
        body += data
    return status, headers, bytes(body), reusable and delimited


class UpstreamResponse:
    """A response whose head has been read; the body is still on the
    connection.  ``read`` takes it whole, ``iter_chunks`` as it arrives;
    either closes the connection at the end, and ``close`` drops it at
    once."""

    def __init__(self, conn: _Connection, status: int,
                 headers: Dict[str, str], has_body: bool):
        self._conn = conn
        self.status = status
        self.headers = headers
        self._has_body = has_body

    async def iter_chunks(self, read_timeout: Optional[float] = None
                          ) -> AsyncIterator[bytes]:
        """Yield the body as it arrives; ``read_timeout`` bounds the wait
        for each piece (``TimeoutError``), not the whole body."""
        if not self._has_body:
            self.close()
            return
        body = _iter_body(self._conn, self.headers).__aiter__()
        try:
            while True:
                try:
                    if read_timeout is None:
                        data = await body.__anext__()
                    else:
                        data = await asyncio.wait_for(body.__anext__(),
                                                      read_timeout)
                except StopAsyncIteration:
                    return
                yield data
        finally:
            await body.aclose()
            self.close()

    async def read(self) -> bytes:
        out = bytearray()
        async for data in self.iter_chunks():
            out += data
        return bytes(out)

    def close(self) -> None:
        self._conn.close()


class HTTPClient:
    """HTTP/1.1 requests from one event loop, over kept-alive connections
    or (``keepalive=False``) a connection each."""

    def __init__(self, timeout: Optional[float] = 600.0,
                 keepalive: bool = True):
        self.timeout = timeout
        self.keepalive = keepalive
        self._idle: Dict[Tuple[str, int], List[_Connection]] = {}
        self.connections_opened = 0

    async def _connect(self, host: str, port: int) -> Tuple[_Connection,
                                                             bool]:
        idle = self._idle.get((host, port)) if self.keepalive else None
        while idle:
            conn = idle.pop()
            if not conn.reader.at_eof() and not conn.writer.is_closing():
                return conn, True
            conn.close()
        return await self._open_connection(host, port), False

    async def _open_connection(self, host: str, port: int) -> _Connection:
        try:
            reader, writer = await asyncio.open_connection(
                host, port, limit=MAX_HEADER_BYTES)
        except TimeoutError:
            raise
        except OSError as e:
            raise ConnectError(f"cannot connect to {host}:{port}: {e}") \
                from e
        self.connections_opened += 1
        return _Connection(reader, writer)

    def _head(self, method: str, host: str, port: int, target: str,
              body: bytes, headers: Optional[Mapping[str, str]]) -> bytes:
        lines = [f"{method} {target} HTTP/1.1",
                 f"Host: {host}:{port}",
                 f"Content-Length: {len(body)}"]
        if not self.keepalive:
            lines.append("Connection: close")
        lines += [f"{k}: {v}" for k, v in (headers or {}).items()]
        return ("\r\n".join(lines) + "\r\n\r\n").encode("latin1")

    def _release(self, host: str, port: int, conn: _Connection) -> None:
        idle = self._idle.setdefault((host, port), [])
        if len(idle) < MAX_IDLE_PER_HOST:
            idle.append(conn)
        else:
            conn.close()

    async def _exchange(self, conn: _Connection, method: str, head: bytes,
                        body: bytes) -> Tuple[int, Dict[str, str], bytes,
                                              bool]:
        conn.writer.write(head)
        if body:
            conn.writer.write(body)
        await conn.writer.drain()
        return await _read_response(conn, method)

    async def request(self, method: str, url: str, body: bytes = b"",
                      headers: Optional[Mapping[str, str]] = None,
                      timeout: Optional[float] = None) -> Response:
        """One request; returns (status, lower-cased headers, body).
        With keep-alive, a request sent on a reused connection that the
        peer had closed is sent once more on a fresh one (the idle
        connection may have timed out on the server's side); without
        it, a request is sent once."""
        host, port, target = _parse_url(url)
        head = self._head(method, host, port, target, body, headers)
        budget = self.timeout if timeout is None else timeout

        async def attempt():
            if not self.keepalive:
                response = await self._send(host, port, method, head,
                                            body)
                return response.status, response.headers, \
                    await response.read()
            for _ in range(2):
                conn, reused = await self._connect(host, port)
                try:
                    status, out, data, reusable = await self._exchange(
                        conn, method, head, body)
                except (HTTPClientError, ConnectionResetError,
                        BrokenPipeError):
                    conn.close()
                    if reused:
                        continue
                    raise
                except BaseException:
                    conn.close()
                    raise
                if reusable:
                    self._release(host, port, conn)
                else:
                    conn.close()
                return status, out, data
            raise HTTPClientError(f"{host}:{port} closed the connection")

        if budget is None:
            return await attempt()
        return await asyncio.wait_for(attempt(), timeout=budget)

    async def _send(self, host: str, port: int, method: str, head: bytes,
                    body: bytes) -> UpstreamResponse:
        conn = await self._open_connection(host, port)
        try:
            conn.writer.write(head)
            if body:
                conn.writer.write(body)
            await conn.writer.drain()
            status, headers, _reusable, has_body = await _read_head(
                conn, method)
        except BaseException:
            conn.close()
            raise
        return UpstreamResponse(conn, status, headers, has_body)

    async def open(self, method: str, url: str, body: bytes = b"",
                   headers: Optional[Mapping[str, str]] = None,
                   timeout: Optional[float] = None) -> UpstreamResponse:
        """Send one request on a connection of its own and return once
        the response head is in (``timeout`` bounds the connect, the
        send and the head).  The request is sent once; the caller reads
        or streams the body and the connection closes after it."""
        host, port, target = _parse_url(url)
        head = self._head(method, host, port, target, body, headers)
        budget = self.timeout if timeout is None else timeout
        send = self._send(host, port, method, head, body)
        if budget is None:
            return await send
        return await asyncio.wait_for(send, timeout=budget)

    async def close(self) -> None:
        """Close every idle connection."""
        idle, self._idle = self._idle, {}
        for conns in idle.values():
            for conn in conns:
                conn.close()
