"""A small asyncio HTTP/1.1 client on the standard library.

The client side of ``server/http.py``: the proxy hop of ``Model``
(``predictor_host`` / ``explainer_host``, where the JAX package holds an
aiohttp session) speaks through it.  One ``HTTPClient``
keeps idle keep-alive connections per (host, port) and reuses them;
each request is bounded by the client's timeout or its own.  Bodies are
read by ``Content-Length``, by chunked transfer decoding, or to the
close of a connection that announced neither.

Transport failures raise ``OSError`` subclasses (a refused or reset
connection, ``TimeoutError`` when the budget runs out, and
``HTTPClientError`` for a malformed response), so retry policies
classify them as transient.
"""

import asyncio
import urllib.parse
from typing import Dict, List, Mapping, Optional, Tuple

MAX_HEADER_BYTES = 64 * 1024
# Idle keep-alive connections kept per (host, port).
MAX_IDLE_PER_HOST = 8

Response = Tuple[int, Dict[str, str], bytes]


class HTTPClientError(ConnectionError):
    """The peer's response is not well-formed HTTP/1.1."""


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


async def _read_response(conn: _Connection, method: str
                         ) -> Tuple[int, Dict[str, str], bytes, bool]:
    """(status, lower-cased headers, body, reusable)."""
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
    if method == "HEAD" or status in (204, 304) or 100 <= status < 200:
        return status, headers, b"", reusable
    try:
        if headers.get("transfer-encoding", "").lower() == "chunked":
            body = bytearray()
            while True:
                size_line = await conn.reader.readuntil(b"\r\n")
                size = int(size_line.split(b";", 1)[0].strip(), 16)
                if size == 0:
                    # Trailers, if any, end with an empty line.
                    while await conn.reader.readuntil(b"\r\n") != b"\r\n":
                        pass
                    break
                body += await conn.reader.readexactly(size)
                await conn.reader.readexactly(2)
            return status, headers, bytes(body), reusable
        if "content-length" in headers:
            n = int(headers["content-length"])
            return status, headers, await conn.reader.readexactly(n), \
                reusable
    except asyncio.IncompleteReadError as e:
        raise HTTPClientError("connection closed mid-body") from e
    except ValueError as e:
        raise HTTPClientError(f"malformed body framing: {e}") from e
    return status, headers, await conn.reader.read(), False


class HTTPClient:
    """Keep-alive HTTP/1.1 requests from one event loop."""

    def __init__(self, timeout: Optional[float] = 600.0):
        self.timeout = timeout
        self._idle: Dict[Tuple[str, int], List[_Connection]] = {}
        self.connections_opened = 0

    async def _connect(self, host: str, port: int) -> Tuple[_Connection,
                                                             bool]:
        idle = self._idle.get((host, port))
        while idle:
            conn = idle.pop()
            if not conn.reader.at_eof() and not conn.writer.is_closing():
                return conn, True
            conn.close()
        reader, writer = await asyncio.open_connection(
            host, port, limit=MAX_HEADER_BYTES)
        self.connections_opened += 1
        return _Connection(reader, writer), False

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
        A request sent on a reused connection that the peer had closed
        is sent once more on a fresh one (the idle connection may have
        timed out on the server's side)."""
        host, port, target = _parse_url(url)
        lines = [f"{method} {target} HTTP/1.1",
                 f"Host: {host}:{port}",
                 f"Content-Length: {len(body)}"]
        lines += [f"{k}: {v}" for k, v in (headers or {}).items()]
        head = ("\r\n".join(lines) + "\r\n\r\n").encode("latin1")
        budget = self.timeout if timeout is None else timeout

        async def attempt():
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

    async def close(self) -> None:
        """Close every idle connection."""
        idle, self._idle = self._idle, {}
        for conns in idle.values():
            for conn in conns:
                conn.close()
