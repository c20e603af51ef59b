"""Engine event timeline: a bounded, allocation-light ring of
device-path events.

Port of ``kfserving_tpu/observability/profiling/timeline.py``,
unchanged in behaviour.  The generator's waves, chunks, prefills,
preemptions, growth-HOLD windows and cache events, the predict
engine's dispatches, the batcher's flushes and the residency manager's
fault-ins and evictions land here with a wall-clock start, a duration,
a track (host / device / per-slot / counter) and the owning request's
trace id, so:

- ``GET /debug/profile`` renders it as a Chrome-trace/Perfetto
  timeline (``trace_export.py``);
- pinned flight-recorder entries embed the engine events overlapping
  the request's span (``monitoring/__init__.py``);
- ``trace_export.summarize`` derives dispatch gaps, HOLD time and the
  suppressed-wave ratio from it.

A device event is the host-clock busy interval between a dispatch's
enqueue and the completion of its results (the generator's
overlap-corrected ``busy``): no synchronize is added for it.

Hot-path contract (the generator records from its scheduler loop and
its enqueue/fetch executor threads):

- **never blocks**: ``record()`` is one tuple build and a ring-slot
  store under a lock held for two statements;
- **bounded memory**: the ring is preallocated at ``capacity`` slots
  and overwrites oldest-first;
- **reader-safe**: ``snapshot()``/``window()`` copy the slot
  references under the same lock (events are immutable tuples).

Knobs: ``KFS_TIMELINE_EVENTS`` sizes the process ring (default 8192).
"""

import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

DEFAULT_CAPACITY = 8192

# Track names.  "host" and "device" are the two shared tracks; slot
# events carry track="slot" plus the slot index; "counter" events are
# point-in-time occupancy samples the exporter renders as Chrome
# counter series.
HOST, DEVICE, SLOT, COUNTER = "host", "device", "slot", "counter"

# Event tuple layout (immutable — readers copy references, writers
# never mutate a published event):
#   (start_epoch_s, dur_s, track, name, trace_id, slot, attrs)
Event = Tuple[float, float, str, str, Optional[str], int,
              Optional[Dict[str, Any]]]


class EngineTimeline:
    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = max(16, int(capacity))
        self._ring: List[Optional[Event]] = [None] * self.capacity
        self._next = 0          # total events ever recorded
        self._lock = threading.Lock()

    @classmethod
    def from_env(cls) -> "EngineTimeline":
        try:
            cap = int(os.environ.get("KFS_TIMELINE_EVENTS",
                                     DEFAULT_CAPACITY))
        except ValueError:
            cap = DEFAULT_CAPACITY
        return cls(cap)

    # -- writing (hot path) ------------------------------------------------
    def record(self, track: str, name: str, dur_s: float = 0.0,
               trace_id: Optional[str] = None, slot: int = -1,
               t_end: Optional[float] = None,
               attrs: Optional[Dict[str, Any]] = None) -> None:
        """Record one event ending at `t_end` (default: now) that ran
        for `dur_s` seconds (0 = instant).  `attrs` is stored by
        reference and must not be mutated after the call."""
        end = time.time() if t_end is None else t_end
        event: Event = (end - dur_s, dur_s, track, name, trace_id,
                        int(slot), attrs)
        with self._lock:
            self._ring[self._next % self.capacity] = event
            self._next += 1

    def counter(self, name: str, values: Dict[str, Any]) -> None:
        """Point-in-time occupancy sample (free blocks, active slots,
        pending depth) — rendered as a Chrome counter track."""
        self.record(COUNTER, name, attrs=values)

    # -- reading -----------------------------------------------------------
    @property
    def recorded(self) -> int:
        return self._next

    def snapshot(self, window_s: Optional[float] = None,
                 now: Optional[float] = None) -> List[Event]:
        """Events oldest-first, optionally only those whose span ends
        inside the trailing `window_s` seconds."""
        with self._lock:
            n = self._next
            if n <= self.capacity:
                events = [e for e in self._ring[:n]]
            else:
                head = n % self.capacity
                events = self._ring[head:] + self._ring[:head]
        events = [e for e in events if e is not None]
        if window_s is not None:
            cutoff = (now if now is not None else time.time()) \
                - float(window_s)
            events = [e for e in events if e[0] + e[1] >= cutoff]
        return events

    def window(self, t0: float, t1: float, limit: int = 64
               ) -> List[Dict[str, Any]]:
        """Events overlapping [t0, t1] as dicts (newest `limit`), for
        embedding in flight-recorder entries.  Tuples are filtered and
        sliced BEFORE dict conversion — this runs on every pin, and
        dict-ifying a full ring to keep 64 would tax exactly the
        tail-latency storms pins exist for."""
        limit = max(0, int(limit))
        if limit == 0:
            return []
        hits = [e for e in self.snapshot()
                if e[0] <= t1 and e[0] + e[1] >= t0]
        return [self.event_dict(e) for e in hits[-limit:]]

    @staticmethod
    def event_dict(event: Event) -> Dict[str, Any]:
        start, dur, track, name, trace_id, slot, attrs = event
        out: Dict[str, Any] = {
            "t": round(start, 6),
            "dur_ms": round(dur * 1000.0, 3),
            "track": track,
            "name": name,
        }
        if trace_id is not None:
            out["trace_id"] = trace_id
        if slot >= 0:
            out["slot"] = slot
        if attrs:
            out["attrs"] = dict(attrs)
        return out

    def clear(self) -> None:
        with self._lock:
            self._ring = [None] * self.capacity
            self._next = 0


# The process timeline: one serving process = one device path = one
# event ring (the same singleton shape as tracing.tracer).
TIMELINE = EngineTimeline.from_env()
