"""Bounded in-process ring TSDB with downsampled retention tiers.

Port of ``kfserving_tpu/observability/history/store.py``, unchanged in
behaviour.  One ``HistoryStore`` holds many series, each identified by
(family name, label set) and carrying a ``kind`` that fixes its
aggregation:

    gauge      instantaneous value          (downsample: mean)
    rate       counter delta / tick seconds (mean)
    quantile   derived histogram quantile   (mean)
    ratio      synthetic 0..1 ratio         (mean)

Memory is fixed by construction: every series owns one preallocated
``array('d')`` ring per retention tier (default 1 s x 600 and
10 s x 720), and the series population is capped (``max_series``,
overflow counted in ``self.dropped``).  The coarse tiers fill from a
running (sum, count) accumulator, so a tier-1 point is the mean of the
tier-0 points in its window.  One store-wide lock guards the series map
and every ring mutation (the sampler appends from its tick while
``/debug/history`` queries from the event loop).
"""

import math
import threading
from array import array
from typing import Dict, Iterable, List, Optional, Tuple

# (step seconds multiplier over the tick, capacity): tier 0 retains
# tick_s x 600 (10 min at the 1 s default), tier 1 retains
# 10 x tick_s x 720 (2 h at the default).
DEFAULT_TIERS = ((1, 600), (10, 720))

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Optional[Dict[str, str]]) -> _LabelKey:
    if not labels:
        return ()
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class _Ring:
    """Fixed-capacity (ts, value) circular buffer."""

    __slots__ = ("step_s", "capacity", "_ts", "_val", "_head",
                 "_count")

    def __init__(self, step_s: float, capacity: int):
        self.step_s = step_s
        self.capacity = capacity
        self._ts = array("d", [0.0]) * capacity
        self._val = array("d", [0.0]) * capacity
        self._head = 0   # next write slot
        self._count = 0

    def append(self, ts: float, value: float) -> None:
        self._ts[self._head] = ts
        self._val[self._head] = value
        self._head = (self._head + 1) % self.capacity
        self._count = min(self._count + 1, self.capacity)

    def span_s(self) -> float:
        return self.step_s * self.capacity

    def frames(self, since: Optional[float] = None
               ) -> List[Tuple[float, float]]:
        """Chronological (ts, value) pairs, optionally since a
        timestamp."""
        start = (self._head - self._count) % self.capacity
        out: List[Tuple[float, float]] = []
        for i in range(self._count):
            j = (start + i) % self.capacity
            if since is None or self._ts[j] >= since:
                out.append((self._ts[j], self._val[j]))
        return out


class _Series:
    __slots__ = ("name", "labels", "kind", "rings", "_acc")

    def __init__(self, name: str, labels: Dict[str, str], kind: str,
                 tiers: Iterable[Tuple[float, int]]):
        self.name = name
        self.labels = dict(labels)
        self.kind = kind
        self.rings = [_Ring(step, cap) for step, cap in tiers]
        # Per coarse tier: [bucket start ts or None, sum, count].
        self._acc = [[None, 0.0, 0] for _ in self.rings[1:]]

    def append(self, ts: float, value: float) -> None:
        self.rings[0].append(ts, value)
        for i, ring in enumerate(self.rings[1:]):
            bucket = math.floor(ts / ring.step_s) * ring.step_s
            acc = self._acc[i]
            if acc[0] is not None and bucket != acc[0]:
                ring.append(acc[0], acc[1] / max(1, acc[2]))
                acc[0], acc[1], acc[2] = None, 0.0, 0
            if acc[0] is None:
                acc[0] = bucket
            acc[1] += value
            acc[2] += 1

    def points(self) -> int:
        return sum(r._count for r in self.rings)


class HistoryStore:
    def __init__(self, tick_s: float = 1.0,
                 tiers: Optional[Iterable[Tuple[float, int]]] = None,
                 max_series: int = 4096):
        self.tick_s = tick_s
        if tiers is None:
            tiers = [(mult * tick_s, cap)
                     for mult, cap in DEFAULT_TIERS]
        self.tiers: List[Tuple[float, int]] = [
            (float(step), int(cap)) for step, cap in tiers]
        self.max_series = max_series
        self.dropped = 0  # series refused at the population cap
        self._lock = threading.Lock()
        self._series: Dict[Tuple[str, _LabelKey], _Series] = {}

    # -- writes (sampler tick) -------------------------------------------
    def record(self, name: str, labels: Optional[Dict[str, str]],
               kind: str, ts: float, value: float) -> bool:
        """Append one sample; False when refused at the series cap."""
        key = (name, _label_key(labels))
        with self._lock:
            series = self._series.get(key)
            if series is None:
                if len(self._series) >= self.max_series:
                    self.dropped += 1
                    return False
                series = _Series(name, dict(labels or {}), kind,
                                 self.tiers)
                self._series[key] = series
            series.append(ts, float(value))
            return True

    def sweep(self, live: set) -> int:
        """Drop every series whose (name, label key) is NOT in
        `live` — the set of keys the sampler saw this tick.  A pruned
        registry child's series stops here immediately: it must not
        survive as a ghost ring that a rollout rollback would then
        resurrect with stale frames.  Returns the number dropped."""
        with self._lock:
            gone = [k for k in self._series if k not in live]
            for k in gone:
                del self._series[k]
            return len(gone)

    @staticmethod
    def key(name: str, labels: Optional[Dict[str, str]] = None
            ) -> Tuple[str, _LabelKey]:
        """The sweep/live-set key for one series."""
        return (name, _label_key(labels))

    # -- reads (/debug/history, detector) --------------------------------
    def series_count(self) -> int:
        with self._lock:
            return len(self._series)

    def index(self) -> List[Dict]:
        """Discovery view: every live series with its kind and point
        count (no frames)."""
        with self._lock:
            items = list(self._series.values())
        return sorted(
            ({"name": s.name, "labels": s.labels, "kind": s.kind,
              "points": s.points()} for s in items),
            key=lambda d: (d["name"], sorted(d["labels"].items())))

    def latest(self, name: str,
               labels: Optional[Dict[str, str]] = None
               ) -> Optional[Tuple[float, float]]:
        """Newest tier-0 frame of one exact series (None if absent
        or empty)."""
        with self._lock:
            series = self._series.get((name, _label_key(labels)))
            if series is None:
                return None
            frames = series.rings[0].frames()
        return frames[-1] if frames else None

    def watched(self, names) -> List[Tuple[str, Dict[str, str], str,
                                           List[Tuple[float, float]]]]:
        """(name, labels, kind, tier-0 frames) for every series whose
        name is in `names` — the detector's per-tick read."""
        wanted = set(names)
        with self._lock:
            items = [s for s in self._series.values()
                     if s.name in wanted]
            return [(s.name, dict(s.labels), s.kind,
                     s.rings[0].frames()) for s in items]

    def query(self, series: Optional[str] = None,
              labels: Optional[Dict[str, str]] = None,
              window_s: float = 600.0,
              step_s: Optional[float] = None,
              now: Optional[float] = None) -> List[Dict]:
        """Aligned (ts, value) frames for every series matching `series`
        (exact family name; None = all) whose labels contain every
        pair in `labels`.

        Frames are resampled onto an absolute epoch grid
        (ts = floor(sample_ts / step) * step, mean per bucket), so the
        router can merge replicas' answers by timestamp.  The source
        tier is the finest whose retention covers `window_s`."""
        if now is None:
            import time

            now = time.time()
        with self._lock:
            matched = [
                s for s in self._series.values()
                if (series is None or s.name == series)
                and (not labels
                     or all(s.labels.get(k) == str(v)
                            for k, v in labels.items()))]
            out = []
            since = now - window_s
            for s in matched:
                ring = s.rings[-1]
                for r in s.rings:
                    if r.span_s() >= window_s:
                        ring = r
                        break
                step = float(step_s) if step_s else ring.step_s
                out.append((s.name, dict(s.labels), s.kind,
                            ring.frames(since), step))
        results = []
        for name, lbls, kind, frames, step in out:
            results.append({
                "name": name, "labels": lbls, "kind": kind,
                "step_s": step,
                "frames": _resample(frames, step)})
        return sorted(results,
                      key=lambda d: (d["name"],
                                     sorted(d["labels"].items())))


def _resample(frames: List[Tuple[float, float]],
              step: float) -> List[List[float]]:
    """Mean-aggregate frames onto the absolute epoch grid."""
    buckets: Dict[float, List[float]] = {}
    order: List[float] = []
    for ts, v in frames:
        b = math.floor(ts / step) * step
        slot = buckets.get(b)
        if slot is None:
            buckets[b] = slot = [0.0, 0.0]
            order.append(b)
        slot[0] += v
        slot[1] += 1.0
    return [[b, buckets[b][0] / buckets[b][1]]
            for b in sorted(order)]
