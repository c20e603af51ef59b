"""Request tracing: span ids through the server, batcher and engine.

Port of ``kfserving_tpu/tracing.py``; its ``ProfilerControl`` runs
``torch.profiler`` (CPU and, on the card, CUDA activities) where the JAX
package's ran ``jax.profiler``, behind ``/debug/profiler/start|stop`` and
``/debug/profile/capture``.

Design: a process-wide ring buffer of completed spans plus a contextvar
carrying the current request id.  The request id enters via the W3C
``traceparent`` header or ``x-request-id`` (or is minted at the server),
rides the contextvar through the asyncio handler and, via
``contextvars.copy_context``, into the engine's worker threads, so the
``engine.execute`` span attaches to the request that caused it.  Spans
are queryable at ``GET /debug/traces`` and logged at DEBUG.
"""

import contextlib
import contextvars
import logging
import os
import re
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger("kfserving_tpu_torch.tracing")

REQUEST_ID_HEADER = "x-request-id"
# W3C Trace Context (https://www.w3.org/TR/trace-context/): the
# cross-hop carrier.  `traceparent` wins over x-request-id when both
# arrive; x-request-id stays the echo/correlation header for clients
# that never adopted W3C.
TRACEPARENT_HEADER = "traceparent"

_HEX32 = re.compile(r"^[0-9a-f]{32}$")
_HEX16 = re.compile(r"^[0-9a-f]{16}$")

# Current request id; propagated into engine worker threads by running
# the executor callable under contextvars.copy_context().
current_request_id: contextvars.ContextVar[Optional[str]] = \
    contextvars.ContextVar("kfs_request_id", default=None)


def parse_traceparent(value: str) -> Optional[Tuple[str, str]]:
    """(trace_id, parent_span_id) from a `traceparent` header, or None
    when malformed (all-zero ids are invalid per spec)."""
    parts = value.strip().lower().split("-")
    if len(parts) < 4:
        return None
    _version, trace_id, span_id = parts[0], parts[1], parts[2]
    if not _HEX32.match(trace_id) or not _HEX16.match(span_id):
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id


def format_traceparent(trace_id: str, span_id: str) -> str:
    return f"00-{trace_id}-{span_id}-01"


def mint_trace_id() -> str:
    return uuid.uuid4().hex


def mint_span_id() -> str:
    return uuid.uuid4().hex[:16]


@dataclass
class TraceContext:
    """One hop's view of the request's trace: the shared trace id, the
    upstream hop's span id (None at the trace root), and this hop's
    own span id (forwarded downstream as the parent)."""

    trace_id: str
    parent_span_id: Optional[str] = None
    span_id: str = field(default_factory=mint_span_id)

    def forward_traceparent(self) -> Optional[str]:
        """The `traceparent` value to send downstream, or None when
        the trace id is not W3C-shaped (a client-supplied
        x-request-id keeps carrying context on its own header — never
        rewrite the id the client correlates by)."""
        if not _HEX32.match(self.trace_id):
            return None
        return format_traceparent(self.trace_id, self.span_id)


def ensure_trace_context(headers: Dict[str, str],
                         mint: str = "short") -> TraceContext:
    """Join (or start) the request's trace and set the contextvar, as
    ``ensure_request_id`` does, keeping this hop's span id for the
    downstream ``traceparent``.  ``mint="w3c"`` mints a full 32-hex id
    (the ingress router, which must emit a valid traceparent);
    ``"short"`` keeps the 16-hex x-request-id shape."""
    tp = headers.get(TRACEPARENT_HEADER)
    if tp:
        parsed = parse_traceparent(tp)
        if parsed is not None:
            ctx = TraceContext(parsed[0], parent_span_id=parsed[1])
            current_request_id.set(ctx.trace_id)
            return ctx
    rid = headers.get(REQUEST_ID_HEADER)
    if not rid:
        rid = mint_trace_id() if mint == "w3c" else uuid.uuid4().hex[:16]
    ctx = TraceContext(rid)
    current_request_id.set(ctx.trace_id)
    return ctx


@dataclass
class Span:
    trace_id: str
    name: str
    start: float          # time.time() epoch seconds
    duration_ms: float
    attrs: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {"trace_id": self.trace_id, "name": self.name,
                "start": self.start, "duration_ms": self.duration_ms,
                "attrs": self.attrs}


class Tracer:
    """Process-wide completed-span ring buffer (bounded, lock-guarded)."""

    def __init__(self, capacity: int = 512):
        self._spans: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()

    def record(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)
        logger.debug("span %s %s %.2fms %s", span.trace_id, span.name,
                     span.duration_ms, span.attrs)

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Time a block; attaches to the current request id (or 'untraced').
        Yields a dict the block may add attributes to."""
        trace_id = current_request_id.get() or "untraced"
        start_wall = time.time()
        start = time.perf_counter()
        span_attrs: Dict[str, Any] = dict(attrs)
        try:
            yield span_attrs
        finally:
            self.record(Span(trace_id, name, start_wall,
                             (time.perf_counter() - start) * 1000.0,
                             span_attrs))

    def spans(self, trace_id: Optional[str] = None,
              limit: int = 100) -> List[Dict[str, Any]]:
        with self._lock:
            items = list(self._spans)
        if trace_id is not None:
            items = [s for s in items if s.trace_id == trace_id]
        return [s.to_dict() for s in items[-limit:]]

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()


# The process tracer (one serving process = one trace sink).
tracer = Tracer()


def ensure_request_id(headers: Dict[str, str]) -> str:
    """Read (or mint) the request's trace id, set the contextvar and
    return the id, so the response can echo it.  Precedence: a valid
    `traceparent` wins (its 32-hex trace id becomes THE id on every
    layer's spans); else `x-request-id` (any string, legacy
    correlation); else a fresh 16-hex id."""
    tp = headers.get(TRACEPARENT_HEADER)
    parsed = parse_traceparent(tp) if tp else None
    if parsed is not None:
        rid = parsed[0]
    else:
        rid = headers.get(REQUEST_ID_HEADER) or uuid.uuid4().hex[:16]
    current_request_id.set(rid)
    return rid


class ProfilerControl:
    """On-demand ``torch.profiler`` capture.  One capture at a time:
    ``start`` answers False while one is active (the routes' 409), and
    ``stop`` writes the capture as a Chrome trace (``trace-<pid>-<ms>
    .json``, kernels by name on the CUDA track) into the log dir it was
    started with and returns that dir (``last_trace`` holds the file).
    A profiler that fails to start raises.  Start and stop must run on
    one thread, the one that first used torch (the profiler's CUPTI
    client is registered there): the server calls both on its loop."""

    def __init__(self):
        self._active_dir: Optional[str] = None
        self._profile = None
        self._lock = threading.Lock()
        self.last_trace: Optional[str] = None

    @property
    def active_dir(self) -> Optional[str]:
        return self._active_dir

    def start(self, log_dir: str) -> bool:
        import torch

        with self._lock:
            if self._active_dir is not None:
                return False
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            profile = torch.profiler.profile(activities=activities)
            profile.start()
            self._profile, self._active_dir = profile, log_dir
            logger.info("torch.profiler capture -> %s", log_dir)
            return True

    def stop(self) -> Optional[str]:
        with self._lock:
            if self._active_dir is None:
                return None
            profile, self._profile = self._profile, None
            out, self._active_dir = self._active_dir, None
            profile.stop()
            os.makedirs(out, exist_ok=True)
            path = os.path.join(
                out, f"trace-{os.getpid()}-{int(time.time() * 1000)}.json")
            profile.export_chrome_trace(path)
            self.last_trace = path
        logger.info("torch.profiler capture stopped (%s)", path)
        return out


profiler = ProfilerControl()
