"""Flight recorder: a per-replica ring buffer of request timelines.

Port of ``kfserving_tpu/observability/monitoring/flight_recorder.py``,
unchanged in behaviour.  It keeps the last N request timelines (trace
id, stage timings, outcome, cost record) in a bounded ring and PINS
entries that tripped a trigger into a separate bounded buffer, so
evidence survives the healthy traffic that follows an incident:

    slo_breach       the model's SLO alert state was active
    slo_violation    latency exceeded the model's declared objective
    deadline_shed    the request died of its budget (504)
    unavailable      a 503 (admission queue full, model not ready)
    error            other 5xx outcome
    latency_outlier  latency above the rolling per-model p99

Detectors pin here too: trend change-points (``trend_<series>``),
sanitizer violations (``sanitizer_<kind>``), eviction and fault-back
storms, and the KV handoff's re-attach, peer pull and export.  Pin
listeners (the incident engine) see every pinned entry.

Served at ``GET /debug/flightrecorder``.  Knobs:
``KFS_FLIGHTRECORDER_SIZE`` (ring), ``KFS_FLIGHTRECORDER_PINNED`` (pin
buffer), ``KFS_FLIGHTRECORDER_LATENCY_WINDOW`` (p99 sample window).
"""

import logging
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

logger = logging.getLogger("kfserving_tpu_torch.monitoring.flightrecorder")

from kfserving_tpu_torch.observability import metrics as obs
from kfserving_tpu_torch.observability.monitoring.knobs import env_number

DEFAULT_SIZE = 256
DEFAULT_PINNED = 64
DEFAULT_LATENCY_WINDOW = 256
# Below this many samples the rolling p99 is noise, not a trigger.
MIN_OUTLIER_SAMPLES = 32


class FlightRecorder:
    def __init__(self, size: int = DEFAULT_SIZE,
                 pinned_size: int = DEFAULT_PINNED,
                 latency_window: int = DEFAULT_LATENCY_WINDOW):
        self.size = max(1, int(size))
        self.pinned_size = max(1, int(pinned_size))
        self.latency_window = max(MIN_OUTLIER_SAMPLES,
                                  int(latency_window))
        self._ring: deque = deque(maxlen=self.size)
        self._pinned: deque = deque(maxlen=self.pinned_size)
        self._latencies: Dict[str, deque] = {}
        self._lock = threading.Lock()
        self.recorded = 0
        self.pinned_count = 0
        # Pin taps: called with every PINNED entry, outside the lock
        # (recording happens on the event loop, executor threads, and
        # the sanitizer watchdog thread alike — listeners must be
        # thread-safe and cheap).  The incident engine subscribes here
        # to turn detector pins into incident triggers.
        self._pin_listeners: List[Callable[[Dict[str, Any]], None]] = []

    @classmethod
    def from_env(cls) -> "FlightRecorder":
        return cls(
            size=int(env_number("KFS_FLIGHTRECORDER_SIZE",
                                DEFAULT_SIZE)),
            pinned_size=int(env_number("KFS_FLIGHTRECORDER_PINNED",
                                       DEFAULT_PINNED)),
            latency_window=int(env_number(
                "KFS_FLIGHTRECORDER_LATENCY_WINDOW",
                DEFAULT_LATENCY_WINDOW)))

    # -- triggers ----------------------------------------------------------
    def observe_latency(self, model: str, latency_ms: float) -> bool:
        """Feed the per-model rolling latency window; True when this
        observation sits above the window's p99 (the latency-outlier
        pin trigger).  The window is consulted BEFORE this sample
        joins it, so one giant outlier can't raise the bar against
        itself."""
        with self._lock:
            window = self._latencies.get(model)
            if window is None:
                window = self._latencies[model] = deque(
                    maxlen=self.latency_window)
            is_outlier = False
            if len(window) >= MIN_OUTLIER_SAMPLES:
                ordered = sorted(window)
                p99 = ordered[min(len(ordered) - 1,
                                  int(len(ordered) * 0.99))]
                is_outlier = latency_ms > p99
            window.append(latency_ms)
            return is_outlier

    # -- recording ---------------------------------------------------------
    def record(self, entry: Dict[str, Any],
               pin: Optional[str] = None) -> None:
        """Append one request timeline; `pin` names the trigger that
        also copies it into the pinned buffer."""
        entry = dict(entry)
        entry.setdefault("ts", time.time())
        if pin:
            entry["pinned"] = pin
        with self._lock:
            self.recorded += 1
            self._ring.append(entry)
            if pin:
                self.pinned_count += 1
                self._pinned.append(entry)
        if pin:
            obs.flightrecorder_pinned_total().labels(reason=pin).inc()
            for listener in list(self._pin_listeners):
                try:
                    listener(entry)
                except Exception:
                    # A broken tap must never fail the recording path.
                    logger.exception("pin listener failed")

    def add_pin_listener(
            self, listener: Callable[[Dict[str, Any]], None]) -> None:
        """Subscribe to pinned entries (each call gets the stamped
        entry dict, `pinned` key included)."""
        self._pin_listeners.append(listener)

    # -- dumping -----------------------------------------------------------
    def dump(self, limit: int = 100,
             pinned_only: bool = False,
             pin_type: Optional[str] = None,
             since_ts: Optional[float] = None) -> Dict[str, Any]:
        """`pin_type` keeps only entries whose pin reason starts with
        the given prefix (`trend`, `slo_`, `sanitizer_recompile`, ...)
        — unpinned ring entries are excluded too, so an incident
        bundle can pull just the detector evidence instead of the
        whole ring.  `since_ts` keeps entries stamped at or after the
        given wall-clock time."""
        # Clamp BEFORE slicing: [-0:] is the whole deque, and a
        # negative limit would slice an arbitrary tail — a ?limit=0
        # query must mean "none", not "everything".
        limit = max(0, int(limit))

        def keep(entry: Dict[str, Any]) -> bool:
            if since_ts is not None and \
                    float(entry.get("ts") or 0.0) < since_ts:
                return False
            if pin_type:
                reason = entry.get("pinned")
                if not reason or not str(reason).startswith(pin_type):
                    return False
            return True

        filtering = pin_type or since_ts is not None
        with self._lock:
            pinned_src = ([e for e in self._pinned if keep(e)]
                          if filtering else list(self._pinned))
            pinned = pinned_src[-limit:] if limit else []
            if pinned_only or not limit:
                entries = []
            else:
                ring_src = ([e for e in self._ring if keep(e)]
                            if filtering else list(self._ring))
                entries = ring_src[-limit:]
            return {
                "recorded": self.recorded,
                "pinned_total": self.pinned_count,
                "entries": entries,
                "pinned": pinned,
            }

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._pinned.clear()
            self._latencies.clear()
