"""Labeled metrics registry with OpenMetrics exemplars.

Port of ``kfserving_tpu/observability/registry.py``, unchanged: named
families of labeled counters / gauges / histograms, safe label escaping,
``prune`` of children by label, and exemplars on histogram buckets
linking a latency observation to the trace id that produced it.

Render format is the Prometheus text exposition (version 0.0.4); with
``render(exemplars=True)`` histogram bucket lines additionally carry
OpenMetrics exemplar suffixes:

    name_bucket{le="5"} 12 # {trace_id="4bf9..."} 3.2 1700000000.000

Exemplars are legal ONLY under the ``application/openmetrics-text``
content type: endpoints negotiate on the Accept header and default to
the classic exposition without them (the classic parser rejects the
suffix and drops the whole scrape).  Counters and gauges never carry
exemplars.

Thread-safety: the registry lock guards family registration; each
family carries its own lock guarding its children and their sample
mutation (instruments are touched from asyncio handlers, engine worker
threads and the generator's executors).

`REGISTRY` is the process-wide default (the series every layer feeds and
every /metrics endpoint appends).  `Registry.reset()` drops all families
(test isolation).  `family` and `families` are the read-only lookups
the SLO engine and the history sampler walk.
"""

import bisect
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

LATENCY_BUCKETS_MS = [0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000,
                      2500, 5000, 10000]
RATIO_BUCKETS = [0.1, 0.25, 0.5, 0.75, 0.9, 0.95, 1.0]
THROUGHPUT_BUCKETS = [1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000, 2500]

_LabelKey = Tuple[Tuple[str, str], ...]


def escape_label_value(value: str) -> str:
    """Prometheus label-value escaping: backslash, double-quote, and
    newline must be escaped or the exposition line is unparseable."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def format_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{escape_label_value(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _format_value(v: float) -> str:
    # Counters render integral values without a trailing ".0" so
    # existing parsers (and humans) see "3", not "3.0".
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class Counter:
    __slots__ = ("value", "_lock")

    def __init__(self, lock: threading.Lock):
        self.value = 0.0
        self._lock = lock

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount


class Gauge:
    __slots__ = ("value", "_lock")

    def __init__(self, lock: threading.Lock):
        self.value = 0.0
        self._lock = lock

    def set(self, value: float) -> None:
        self.value = float(value)


class Histogram:
    __slots__ = ("buckets", "counts", "total", "sum", "exemplars",
                 "_lock")

    def __init__(self, buckets: List[float], lock: threading.Lock):
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)
        self.total = 0
        self.sum = 0.0
        # bucket index -> (trace_id, observed value, unix seconds);
        # last observation wins (one live exemplar per bucket).
        self.exemplars: Dict[int, Tuple[str, float, float]] = {}
        self._lock = lock

    def observe(self, value: float,
                trace_id: Optional[str] = None) -> None:
        idx = bisect.bisect_left(self.buckets, value)
        # Locked: engine worker threads observe concurrently, and a
        # lost '+= 1' would leave total != sum(counts) — a broken
        # '+Inf == _count' invariant in the exposition.
        with self._lock:
            self.counts[idx] += 1
            self.total += 1
            self.sum += value
            if trace_id:
                self.exemplars[idx] = (trace_id, float(value),
                                       time.time())


class _Family:
    """One named metric of one kind; children keyed by label values."""

    __slots__ = ("kind", "name", "help", "buckets", "_children",
                 "_lock")

    def __init__(self, kind: str, name: str, help_text: str,
                 buckets: Optional[List[float]], lock: threading.Lock):
        self.kind = kind
        self.name = name
        self.help = help_text
        self.buckets = buckets
        self._children: Dict[_LabelKey, object] = {}
        self._lock = lock

    def labels(self, **labels: str):
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            child = self._children.get(key)
            if child is None:
                if self.kind == "counter":
                    child = Counter(self._lock)
                elif self.kind == "gauge":
                    child = Gauge(self._lock)
                else:
                    child = Histogram(self.buckets, self._lock)
                self._children[key] = child
            return child

    # Unlabeled convenience: family.inc()/set()/observe() act on the
    # empty-label child.
    def inc(self, amount: float = 1.0) -> None:
        self.labels().inc(amount)

    def set(self, value: float) -> None:
        self.labels().set(value)

    def observe(self, value: float,
                trace_id: Optional[str] = None) -> None:
        self.labels().observe(value, trace_id=trace_id)

    def samples(self) -> Iterable[Tuple[Dict[str, str], object]]:
        with self._lock:
            items = list(self._children.items())
        for key, child in items:
            yield dict(key), child

    def prune(self, **labels: str) -> int:
        """Drop every child whose labels contain all given pairs —
        series hygiene for label values with bounded lifetimes (a
        GC'd revision's per-revision series must not grow /metrics
        and every scan over the family forever).  Returns the number
        of children removed."""
        match = {(k, str(v)) for k, v in labels.items()}
        with self._lock:
            gone = [key for key in self._children
                    if match <= set(key)]
            for key in gone:
                del self._children[key]
            return len(gone)


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    def _family(self, kind: str, name: str, help_text: str,
                buckets: Optional[List[float]] = None) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                # Per-FAMILY lock, not the registry's: hot paths (the
                # generator's per-token counters, engine worker
                # threads) must not serialize against every other
                # instrument in the process.
                fam = _Family(kind, name, help_text, buckets,
                              threading.Lock())
                self._families[name] = fam
            elif fam.kind != kind:
                raise ValueError(
                    f"metric {name} already registered as {fam.kind}, "
                    f"not {kind}")
            return fam

    def counter(self, name: str, help_text: str = "") -> _Family:
        return self._family("counter", name, help_text)

    def gauge(self, name: str, help_text: str = "") -> _Family:
        return self._family("gauge", name, help_text)

    def histogram(self, name: str, help_text: str = "",
                  buckets: Optional[List[float]] = None) -> _Family:
        return self._family("histogram", name, help_text,
                            buckets or LATENCY_BUCKETS_MS)

    # -- introspection ---------------------------------------------------
    def family(self, name: str) -> Optional[_Family]:
        """Read-only lookup of an existing family (None when absent): a
        reader must never create an empty family a later writer would
        then re-kind against."""
        with self._lock:
            return self._families.get(name)

    def families(self) -> Dict[str, str]:
        """{family name: kind} snapshot."""
        with self._lock:
            return {name: fam.kind
                    for name, fam in self._families.items()}

    def sample_names(self) -> List[str]:
        """Names of families that hold at least one child sample."""
        with self._lock:
            return [name for name, fam in self._families.items()
                    if fam._children]

    # -- test isolation ---------------------------------------------------
    def reset(self) -> None:
        with self._lock:
            self._families.clear()

    # -- exposition ------------------------------------------------------
    def render_lines(self, exemplars: bool = True) -> List[str]:
        """Prometheus text lines.  ``exemplars=True`` adds OpenMetrics
        exemplar suffixes on histogram buckets — legal ONLY under the
        ``application/openmetrics-text`` content type; endpoints must
        pass False when serving the classic text/plain exposition (the
        classic parser rejects the suffix and drops the whole scrape).
        """
        with self._lock:
            families = sorted(self._families.values(),
                              key=lambda f: f.name)
        lines: List[str] = []
        for fam in families:
            samples = list(fam.samples())
            if not samples:
                continue
            if fam.help:
                lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            if fam.kind == "histogram":
                for labels, hist in samples:
                    self._render_histogram(lines, fam.name, labels,
                                           hist, exemplars)
            else:
                for labels, child in samples:
                    lines.append(f"{fam.name}{format_labels(labels)} "
                                 f"{_format_value(child.value)}")
        return lines

    @staticmethod
    def _render_histogram(lines: List[str], name: str,
                          labels: Dict[str, str],
                          hist: Histogram,
                          exemplars: bool = True) -> None:
        with hist._lock:
            counts = list(hist.counts)
            total = hist.total
            total_sum = hist.sum
            exemplar_map = dict(hist.exemplars)
        cumulative = 0
        for idx, (bound, count) in enumerate(zip(hist.buckets,
                                                 counts)):
            cumulative += count
            bucket_labels = dict(labels)
            bucket_labels["le"] = str(bound)
            line = (f"{name}_bucket{format_labels(bucket_labels)} "
                    f"{cumulative}")
            ex = exemplar_map.get(idx) if exemplars else None
            if ex is not None:
                trace_id, value, ts = ex
                line += (f' # {{trace_id="{escape_label_value(trace_id)}"}}'
                         f" {_format_value(value)} {ts:.3f}")
            lines.append(line)
        inf_labels = dict(labels)
        inf_labels["le"] = "+Inf"
        lines.append(f"{name}_bucket{format_labels(inf_labels)} "
                     f"{total}")
        lines.append(f"{name}_sum{format_labels(labels)} "
                     f"{_format_value(total_sum)}")
        lines.append(f"{name}_count{format_labels(labels)} "
                     f"{total}")


# The process-wide default registry: batcher, engine, generator, and
# reliability series all land here; every /metrics endpoint appends it.
REGISTRY = Registry()
