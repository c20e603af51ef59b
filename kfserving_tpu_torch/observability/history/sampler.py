"""The background tick that turns registry point samples into history.

Port of ``kfserving_tpu/observability/history/sampler.py``, unchanged
in behaviour.  Each tick (default 1 s, ``KFS_HISTORY_TICK_S``):

1. runs the registered scrape-time publishers (the roofline and pool
   gauges the ``/metrics`` handler refreshes), so the gauges it samples
   are the ones a live scrape sees;
2. walks every family of every attached registry: counters land as
   per-second rates over the tick (a reset clamps to the new value,
   never a negative rate), gauges as values, histograms as per-bucket
   deltas reduced to ``<name>_p50`` / ``<name>_p99`` quantile series
   (linear interpolation inside the winning bucket) plus a
   ``<name>_count`` rate;
3. derives the synthetic ratios ``kfserving_tpu_history_error_ratio``
   (5xx over all request deltas) and
   ``kfserving_tpu_history_prefix_hit_ratio`` per model;
4. sweeps series whose source disappeared and runs the trend detector.

The loop is an asyncio task registered as a server service; the tick
body is synchronous, in-memory work (tests drive ``tick()`` with pinned
timestamps).  The owning server injects an async ``fault_hook`` probing
the ``observability.history_tick`` fault site before each tick: a hang
parks only this task, an error is swallowed and counted in
``kfserving_tpu_history_tick_failures_total``.

The first sight of a counter or histogram child only establishes its
delta baseline (no frame).
"""

import logging
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

from kfserving_tpu_torch.observability import metrics as obs
from kfserving_tpu_torch.observability.history.store import HistoryStore
from kfserving_tpu_torch.observability.metrics import REQUEST_TOTAL_SERIES
from kfserving_tpu_torch.observability.registry import Registry

logger = logging.getLogger("kfserving_tpu_torch.observability.history")

ENV_ENABLE = "KFS_HISTORY"
ENV_TICK = "KFS_HISTORY_TICK_S"
ENV_MAX_SERIES = "KFS_HISTORY_MAX_SERIES"
DEFAULT_TICK_S = 1.0

# Synthetic cross-label series this sampler derives per tick (their
# sources are counters whose interesting signal is a ratio of label
# slices, which no single registry child carries).
ERROR_RATIO_SERIES = "kfserving_tpu_history_error_ratio"
PREFIX_HIT_RATIO_SERIES = "kfserving_tpu_history_prefix_hit_ratio"
_PREFIX_LOOKUPS_SERIES = "kfserving_tpu_generator_prefix_lookups_total"

# Derived-quantile points per histogram child per tick.
QUANTILES = ((0.5, "_p50"), (0.99, "_p99"))


def history_enabled() -> bool:
    return os.environ.get(ENV_ENABLE, "1") != "0"


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        logger.warning("ignoring non-numeric %s=%r", name, raw)
        return default


def _quantile(buckets: List[float], counts: List[int], total: int,
              q: float) -> float:
    """Quantile from per-bucket deltas: linear interpolation inside
    the winning bucket; the +Inf bucket extrapolates past the last
    bound (a 1.5x convention)."""
    rank = q * total
    cum = 0.0
    lower = 0.0
    for bound, count in zip(buckets, counts):
        if count > 0:
            if cum + count >= rank:
                return lower + (bound - lower) * \
                    min(1.0, max(0.0, (rank - cum) / count))
            cum += count
        lower = bound
    return buckets[-1] * 1.5 if buckets else 0.0


class HistorySampler:
    """Ticks the registries into a `HistoryStore`; a server service
    (`await start()` / `await stop()`)."""

    def __init__(self, store: Optional[HistoryStore] = None,
                 registries: Optional[List[Registry]] = None,
                 tick_s: Optional[float] = None,
                 detector=None,
                 fault_hook: Optional[Callable] = None,
                 publishers: Optional[List[Callable]] = None):
        self.tick_s = (tick_s if tick_s is not None
                       else _env_float(ENV_TICK, DEFAULT_TICK_S))
        self.tick_s = max(0.01, self.tick_s)
        self.store = store or HistoryStore(
            tick_s=self.tick_s,
            max_series=int(_env_float(ENV_MAX_SERIES, 4096)))
        self.registries: List[Registry] = list(registries or [])
        self.detector = detector
        self._fault_hook = fault_hook
        self.publishers: List[Callable] = list(publishers or [])
        self.ticks = 0
        self.failures = 0
        # Delta baselines, keyed (registry id, family, label key):
        # counters map to their last value, histograms to their last
        # (counts, total) snapshot.
        self._prev_counter: Dict[tuple, float] = {}
        self._prev_hist: Dict[tuple, Tuple[List[int], int]] = {}
        self._last_tick_t: Optional[float] = None
        self._fail_log_t: Optional[float] = None
        self._task = None

    # -- service lifecycle ----------------------------------------------
    async def start(self) -> None:
        import asyncio

        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(
                self._loop())

    async def stop(self) -> None:
        import asyncio

        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _loop(self) -> None:
        import asyncio

        while True:
            await asyncio.sleep(self.tick_s)
            try:
                if self._fault_hook is not None:
                    # Chaos seam (observability.history_tick): an
                    # injected hang parks THIS task only — async
                    # sleep, the serving loop keeps running and
                    # /debug/history serves stale frames.
                    await self._fault_hook()
                self.tick()
            except asyncio.CancelledError:
                raise
            except Exception:
                self.failures += 1
                obs.history_tick_failures_total().inc()
                # A persistently failing tick would otherwise emit a
                # traceback every tick_s: full exception on the first
                # failure of a streak, then one WARNING per minute;
                # the failure counter carries the exact count.
                now = time.monotonic()
                if self._fail_log_t is None:
                    logger.exception("history tick failed (history is "
                                     "stale-but-served)")
                    self._fail_log_t = now
                elif now - self._fail_log_t >= 60.0:
                    logger.warning(
                        "history tick still failing (%d failures so "
                        "far; history is stale-but-served)",
                        self.failures)
                    self._fail_log_t = now
            else:
                self._fail_log_t = None

    # -- the tick ---------------------------------------------------------
    def tick(self, now: Optional[float] = None) -> int:
        """One sampling pass; returns points recorded.  `now` pins the
        sample timestamp (tests/bench); the delta denominator is the
        gap since the previous tick (first tick assumes `tick_s`)."""
        t0 = time.perf_counter()
        if now is None:
            now = time.time()
        dt = (now - self._last_tick_t
              if self._last_tick_t is not None else self.tick_s)
        dt = max(dt, 1e-6)
        self._last_tick_t = now
        for pub in self.publishers:
            try:
                pub()
            except Exception:
                logger.exception("history publisher failed")
        live: set = set()
        points = 0
        # {model: {outcome-ish: delta}} feeds for the synthetic ratios.
        request_deltas: Dict[str, Dict[str, float]] = {}
        prefix_deltas: Dict[str, Dict[str, float]] = {}
        seen_baselines: set = set()
        for reg in self.registries:
            for name, kind in reg.families().items():
                fam = reg.family(name)
                if fam is None:
                    continue
                for labels, child in fam.samples():
                    if kind == "counter":
                        points += self._sample_counter(
                            reg, name, labels, child, now, dt, live,
                            seen_baselines, request_deltas,
                            prefix_deltas)
                    elif kind == "gauge":
                        key = self.store.key(name, labels)
                        live.add(key)
                        if self.store.record(name, labels, "gauge",
                                             now, child.value):
                            points += 1
                    else:
                        points += self._sample_histogram(
                            reg, name, labels, child, now, dt, live,
                            seen_baselines)
        points += self._synthetic_ratios(now, live, request_deltas,
                                         prefix_deltas)
        # Baselines whose child vanished (prune/reset) go too — a
        # re-registered child must start fresh, not diff against a
        # ghost.
        for prev in (self._prev_counter, self._prev_hist):
            for key in [k for k in prev if k not in seen_baselines]:
                del prev[key]
        swept = self.store.sweep(live)
        self.ticks += 1
        if self.detector is not None:
            try:
                self.detector.evaluate(now)
            except Exception:
                logger.exception("trend detector failed")
        obs.history_samples_total().inc(points)
        obs.history_series().set(self.store.series_count())
        obs.history_tick_ms().observe(
            (time.perf_counter() - t0) * 1000.0)
        if swept:
            logger.debug("history sweep dropped %d series", swept)
        return points

    def _sample_counter(self, reg, name, labels, child, now, dt,
                        live, seen_baselines, request_deltas,
                        prefix_deltas) -> int:
        base_key = (id(reg), name, tuple(sorted(labels.items())))
        seen_baselines.add(base_key)
        cur = child.value
        prev = self._prev_counter.get(base_key)
        self._prev_counter[base_key] = cur
        if prev is None:
            return 0  # baseline only: no frame on first sight
        delta = cur - prev if cur >= prev else cur  # reset-safe
        if name == REQUEST_TOTAL_SERIES:
            model = labels.get("model", "")
            by = request_deltas.setdefault(model, {})
            status = labels.get("status", "")
            bucket = ("error" if status[:1] in ("5",) else "ok")
            by[bucket] = by.get(bucket, 0.0) + delta
        elif name == _PREFIX_LOOKUPS_SERIES:
            model = labels.get("model", "")
            by = prefix_deltas.setdefault(model, {})
            outcome = labels.get("outcome", "")
            by[outcome] = by.get(outcome, 0.0) + delta
        key = self.store.key(name, labels)
        live.add(key)
        return 1 if self.store.record(name, labels, "rate", now,
                                      delta / dt) else 0

    def _sample_histogram(self, reg, name, labels, child, now, dt,
                          live, seen_baselines) -> int:
        base_key = (id(reg), name, tuple(sorted(labels.items())))
        seen_baselines.add(base_key)
        with child._lock:
            counts = list(child.counts)
            total = child.total
        prev = self._prev_hist.get(base_key)
        self._prev_hist[base_key] = (counts, total)
        # Derived series stay live while their source child exists
        # (idle histograms keep stale-but-served quantile rings).
        for _, suffix in QUANTILES:
            live.add(self.store.key(name + suffix, labels))
        live.add(self.store.key(name + "_count", labels))
        if prev is None:
            return 0
        prev_counts, prev_total = prev
        if total < prev_total or len(prev_counts) != len(counts):
            prev_counts, prev_total = [0] * len(counts), 0  # reset
        d_total = total - prev_total
        points = 0
        if self.store.record(name + "_count", labels, "rate", now,
                             d_total / dt):
            points += 1
        if d_total <= 0:
            return points  # no new observations: quantiles get a gap
        d_counts = [a - b for a, b in zip(counts, prev_counts)]
        for q, suffix in QUANTILES:
            value = _quantile(child.buckets, d_counts, d_total, q)
            if self.store.record(name + suffix, labels, "quantile",
                                 now, value):
                points += 1
        return points

    def _synthetic_ratios(self, now, live, request_deltas,
                          prefix_deltas) -> int:
        points = 0
        for model, by in request_deltas.items():
            seen = by.get("ok", 0.0) + by.get("error", 0.0)
            key = self.store.key(ERROR_RATIO_SERIES,
                                 {"model": model})
            live.add(key)
            if seen <= 0:
                continue  # idle: keep the ring, record nothing
            if self.store.record(ERROR_RATIO_SERIES,
                                 {"model": model}, "ratio", now,
                                 by.get("error", 0.0) / seen):
                points += 1
        for model, by in prefix_deltas.items():
            lookups = sum(by.values())
            key = self.store.key(PREFIX_HIT_RATIO_SERIES,
                                 {"model": model})
            live.add(key)
            if lookups <= 0:
                continue
            hits = by.get("hit", 0.0) + by.get("host_hit", 0.0)
            if self.store.record(PREFIX_HIT_RATIO_SERIES,
                                 {"model": model}, "ratio", now,
                                 hits / lookups):
                points += 1
        return points
