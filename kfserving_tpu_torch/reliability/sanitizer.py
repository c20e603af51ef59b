"""Runtime device-discipline sanitizer (``KFS_SANITIZE=1``).

Port of ``kfserving_tpu/reliability/sanitizer.py``.  It proves at run
time that the serving process does not commit the two silent
throughput killers, implicit host<->device transfers on the scheduler
and compilations after warmup, and that the event loop keeps turning:

- **transfer guard** -- while a generation scheduler loop runs,
  ``loop_guard`` arms a ``torch.overrides.TorchFunctionMode`` on the
  loop thread.  Torch function modes live in thread-local state, so
  the guard sees only that thread's calls: the fetch executor's and
  the predict engine's sanctioned fetches on their own threads are
  never covered (``torch.cuda.set_sync_debug_mode`` would cover the
  whole process).  Under the guard an implicit move of a tensor on
  the guarded device type (``cuda`` when serving; the CPU tests pass
  ``cpu``) raises ``ForbiddenTransfer``: toward the host ``item``,
  ``tolist``, ``cpu``, ``numpy``, ``to`` a CPU device,
  ``__bool__``/``__int__``/``__float__``/``__index__`` and ``nonzero``
  (whose output size needs the device's answer); onto the device
  ``to``/``cuda``/``copy_`` from a host tensor and ``torch.tensor``/
  ``torch.as_tensor`` with a device of the guarded type.  Each is
  counted as a ``forbidden_transfer`` violation, pinned into the
  flight recorder, and re-raised (a sanitize run fails loudly).
  ``sanctioned_fetch()`` suspends the guard for the declared fetch
  points.
- **recompile-after-warmup** -- engines report every first capture of
  a program through ``engine/compile_cache.note_compilation``.  Once a
  source declared its warmup complete (``declare_warmup_complete``),
  a further compilation from it is a ``recompile`` violation.
- **event-loop stall watchdog** -- a heartbeat thread posts
  ``call_soon_threadsafe`` ticks onto the serving loop; a tick the
  loop fails to run within ``KFS_SANITIZE_STALL_MS`` (default 250) is
  a ``loop_stall`` violation with the observed stall attached.

Violations land in ``kfserving_tpu_sanitizer_violations_total{kind}``
and, when a flight recorder is attached (the server wires its
monitoring recorder in), as pinned ``sanitizer_<kind>`` entries.

``KFS_SANITIZE`` unset/0 is a true no-op: every hook degrades to an env
read or a null context manager, no mode is entered and no thread
starts.
"""

import contextlib
import os
import threading
import time
from typing import Any, Dict, Optional

import torch
from torch.overrides import TorchFunctionMode

ENV_VAR = "KFS_SANITIZE"
STALL_ENV_VAR = "KFS_SANITIZE_STALL_MS"
DEFAULT_STALL_MS = 250.0

VIOLATION_KINDS = ("forbidden_transfer", "recompile", "loop_stall")


def enabled() -> bool:
    return os.environ.get(ENV_VAR, "") not in ("", "0", "false")


class _State:
    def __init__(self):
        self.lock = threading.Lock()
        self.violations: Dict[str, int] = {}
        self.warm: set = set()          # sources past declared warmup
        self.recorder = None            # FlightRecorder or None
        self.watchdog: Optional["LoopStallWatchdog"] = None


_state = _State()


def reset() -> None:
    """Tests only: drop violation counts, warmup declarations, the
    recorder attachment, the arming count and any running watchdog."""
    global _guard_arms
    stop_watchdog()
    with _state.lock:
        _guard_arms = 0
        _state.violations.clear()
        _state.warm.clear()
        _state.recorder = None


def attach_flight_recorder(recorder) -> None:
    """Pin future violations into `recorder` (the owning server
    attaches its monitoring FlightRecorder at startup and detaches
    with None on stop)."""
    _state.recorder = recorder


def record_violation(kind: str, detail: Dict[str, Any]) -> None:
    """Count and pin one violation (the hooks and the watchdog share
    this path)."""
    with _state.lock:
        _state.violations[kind] = _state.violations.get(kind, 0) + 1
    from kfserving_tpu_torch.observability import metrics as obs

    obs.sanitizer_violations_total().labels(kind=kind).inc()
    recorder = _state.recorder
    if recorder is not None:
        entry = {"sanitizer": kind}
        entry.update(detail)
        recorder.record(entry, pin=f"sanitizer_{kind}")


def violations() -> Dict[str, int]:
    with _state.lock:
        return dict(_state.violations)


def status() -> Dict[str, Any]:
    """The health-endpoint block: enabled flag, the transfer guard
    (threads armed now, and how many times a thread armed it: a
    scheduler loop disarms when it idles), armed sources, and per-kind
    violation counts (all zero is the clean bill)."""
    with _state.lock:
        return {
            "enabled": enabled(),
            "stall_threshold_ms": _stall_threshold_ms(),
            "watchdog": _state.watchdog is not None,
            "guard": {"armed_threads": _guards_armed,
                      "arms": _guard_arms},
            "warmed_sources": sorted(_state.warm),
            "violations": dict(_state.violations),
        }


# -- recompile-after-warmup --------------------------------------------------

def declare_warmup_complete(source: str) -> None:
    """After this, any compilation noted for `source` is a violation."""
    if not enabled():
        return
    with _state.lock:
        _state.warm.add(source)


def note_compilation(source: str, key: Any) -> None:
    """Called (via engine/compile_cache.note_compilation) on every
    first capture of a program.  Post-warmup notes are violations."""
    if not enabled():
        return
    with _state.lock:
        armed = source in _state.warm
    if armed:
        record_violation("recompile", {
            "source": source,
            "shape": str(key),
            "detail": "compilation after declared warmup — the "
                      "bucket grid was supposed to be closed",
        })


# -- transfer guard ----------------------------------------------------------

class ForbiddenTransfer(RuntimeError):
    """An implicit host<->device transfer under an armed guard."""


_Tensor = torch.Tensor
# Methods whose result lives on the host: each one waits for the device
# and copies its data back.
_TO_HOST = frozenset([
    _Tensor.item, _Tensor.tolist, _Tensor.cpu, _Tensor.numpy,
    _Tensor.__bool__, _Tensor.__int__, _Tensor.__float__,
    _Tensor.__index__, _Tensor.nonzero, torch.nonzero])
_MOVES = frozenset([_Tensor.to, _Tensor.cuda, _Tensor.copy_])
_FACTORIES = frozenset([torch.tensor, torch.as_tensor])


def _device_type(value: Any) -> Optional[str]:
    if isinstance(value, torch.device):
        return value.type
    if isinstance(value, str):
        try:
            return torch.device(value).type
        except RuntimeError:
            return None
    if isinstance(value, int) and not isinstance(value, bool):
        return "cuda"   # a bare ordinal names a CUDA device
    return None


def _target_type(func, args, kwargs) -> Optional[str]:
    """The device type a ``to``/``cuda``/``copy_`` call moves data to
    (None: it names none, or only a dtype)."""
    if func is _Tensor.cuda:
        return "cuda"
    if func is _Tensor.copy_:
        return args[0].device.type if len(args) > 0 else None
    if "device" in kwargs:
        return _device_type(kwargs["device"])
    for arg in args[1:]:
        if isinstance(arg, _Tensor):
            return arg.device.type
        kind = _device_type(arg)
        if kind is not None:
            return kind
    return None


class _TransferGuard(TorchFunctionMode):
    """Raises on an implicit transfer of a tensor on ``device_type``."""

    def __init__(self, device_type: str):
        super().__init__()
        self.device_type = device_type

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not getattr(_guard_tls, "suspended", False):
            self._check(func, args, kwargs)
        return func(*args, **kwargs)

    def _check(self, func, args, kwargs) -> None:
        guarded = self.device_type
        if func in _TO_HOST:
            src = args[0] if args else None
            if isinstance(src, _Tensor) and src.device.type == guarded:
                raise ForbiddenTransfer(
                    f"disallowed device-to-host transfer: "
                    f"{getattr(func, '__name__', func)} on a {guarded} "
                    f"tensor under the transfer guard")
            return
        if func in _MOVES:
            tensor = args[1] if func is _Tensor.copy_ else args[0]
            if not isinstance(tensor, _Tensor):
                return
            src, dst = tensor.device.type, _target_type(func, args,
                                                        kwargs)
            if dst is None or src == dst or guarded not in (src, dst):
                return
            raise ForbiddenTransfer(
                f"disallowed {src}->{dst} transfer: "
                f"{getattr(func, '__name__', func)} under the transfer "
                f"guard")
        if func in _FACTORIES and guarded != "cpu" and \
                _device_type(kwargs.get("device")) == guarded:
            raise ForbiddenTransfer(
                f"disallowed host-to-device transfer: "
                f"{func.__name__} onto {guarded} under the transfer guard")


# Per-thread arming.  Two engines sharing one server loop both hold
# loop_guard across awaits, and their scopes exit in completion order,
# not LIFO: one mode per thread, entered at depth 0->1 and exited at
# 1->0, keeps the guard armed exactly while any loop_guard scope is
# live.  Process-wide counts of armed threads and of armings feed
# status().
_guard_tls = threading.local()
_guards_armed = 0
_guard_arms = 0


def _guard_enter(device_type: str) -> None:
    global _guards_armed, _guard_arms
    depth = getattr(_guard_tls, "depth", 0)
    if depth == 0:
        mode = _TransferGuard(device_type)
        mode.__enter__()
        _guard_tls.mode = mode
        with _state.lock:
            _guards_armed += 1
            _guard_arms += 1
    _guard_tls.depth = depth + 1


def _guard_exit() -> None:
    global _guards_armed
    _guard_tls.depth -= 1
    if _guard_tls.depth == 0:
        mode, _guard_tls.mode = _guard_tls.mode, None
        mode.__exit__(None, None, None)
        with _state.lock:
            _guards_armed -= 1


def guard_active() -> bool:
    """True while the calling thread runs under an armed guard."""
    return getattr(_guard_tls, "depth", 0) > 0


@contextlib.contextmanager
def loop_guard(source: str = "scheduler", device_type: str = "cuda"):
    """Arm the transfer guard on the calling thread for the enclosed
    scope (the generation scheduler wraps its pipeline in this, so the
    guard covers the loop thread for the engine's lifetime).  A
    disallowed transfer is counted and pinned, then re-raised."""
    if not enabled():
        yield
        return
    _guard_enter(device_type)
    try:
        yield
    except ForbiddenTransfer as exc:
        record_violation("forbidden_transfer", {
            "source": source,
            "error": str(exc)[:300],
        })
        raise
    finally:
        _guard_exit()


@contextlib.contextmanager
def sanctioned_fetch():
    """The explicit-allow scope of the declared fetch points: the guard
    is suspended on this thread for the enclosed block.  Null when
    sanitizing is off."""
    if not enabled():
        yield
        return
    prior = getattr(_guard_tls, "suspended", False)
    _guard_tls.suspended = True
    try:
        yield
    finally:
        _guard_tls.suspended = prior


# -- event-loop stall watchdog -----------------------------------------------

def _stall_threshold_ms() -> float:
    try:
        return float(os.environ.get(STALL_ENV_VAR,
                                    DEFAULT_STALL_MS))
    except ValueError:
        return DEFAULT_STALL_MS


class LoopStallWatchdog:
    """Heartbeat thread: posts a tick onto the watched loop every
    ``interval_s`` and measures how long the loop takes to run it.  A
    tick older than the threshold when it finally lands (or still
    pending past the threshold at the next check) is one
    ``loop_stall`` violation per stall episode."""

    def __init__(self, loop, threshold_ms: Optional[float] = None,
                 interval_s: Optional[float] = None):
        self.loop = loop
        self.threshold_s = (threshold_ms
                            if threshold_ms is not None
                            else _stall_threshold_ms()) / 1000.0
        self.interval_s = interval_s or max(0.05,
                                            self.threshold_s / 2.0)
        self._sent_at: Optional[float] = None
        self._stalled = False  # one violation per episode
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="kfs-sanitize-watchdog",
            daemon=True)
        self.stalls = 0

    def start(self) -> "LoopStallWatchdog":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)

    def _beat(self, sent_at: float) -> None:
        # Runs ON the loop: the tick landed.
        stall_s = time.perf_counter() - sent_at
        self._sent_at = None
        if stall_s > self.threshold_s:
            self._record(stall_s)
        else:
            self._stalled = False

    def _record(self, stall_s: float) -> None:
        if self._stalled:
            return  # same episode
        self._stalled = True
        self.stalls += 1
        record_violation("loop_stall", {
            "stall_ms": round(stall_s * 1000.0, 1),
            "threshold_ms": round(self.threshold_s * 1000.0, 1),
        })

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            pending = self._sent_at
            if pending is not None:
                stall_s = time.perf_counter() - pending
                if stall_s > self.threshold_s:
                    # The loop has not run our tick yet: it is stalled
                    # right now; record without waiting for release.
                    self._record(stall_s)
                continue
            sent = time.perf_counter()
            self._sent_at = sent
            try:
                self.loop.call_soon_threadsafe(self._beat, sent)
            except RuntimeError:
                return  # loop closed


def start_watchdog(loop) -> Optional[LoopStallWatchdog]:
    """Start (at most one) stall watchdog on `loop` when sanitizing.
    Returns the watchdog, or None when disabled/already running."""
    if not enabled():
        return None
    with _state.lock:
        if _state.watchdog is not None:
            return None
        wd = LoopStallWatchdog(loop)
        _state.watchdog = wd
    return wd.start()


def stop_watchdog() -> None:
    with _state.lock:
        wd, _state.watchdog = _state.watchdog, None
    if wd is not None:
        wd.stop()
