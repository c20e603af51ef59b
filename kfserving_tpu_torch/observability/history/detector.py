"""EWMA + z-score change-point detection over the history rings.

Port of ``kfserving_tpu/observability/history/detector.py``, unchanged
in behaviour.  Each watched series (family names in
``KFS_HISTORY_WATCH``, defaulting to the latency, error-ratio,
occupancy and hit-rate indicators) carries per-label-set state: an
exponentially weighted mean and variance plus an EWMA'd first
derivative (the trend slope).  A sample whose z-score against the
pre-change mean exceeds the threshold for ``KFS_HISTORY_WATCH_TICKS``
consecutive ticks, after a ``KFS_HISTORY_WATCH_MIN_SAMPLES`` warmup, is
a change point:

- a ``trend_<series>`` entry is pinned into the flight recorder with
  the pre/post window frames around the breach;
- ``kfserving_tpu_trend_changepoints_total`` increments;
- the baseline re-seeds at the new level and a cooldown suppresses
  re-pinning while the series settles.

On every tick the detector exports
``kfserving_tpu_trend_slope_per_second`` and
``kfserving_tpu_trend_zscore`` gauges labeled ``{series=<name>,
...underlying labels}``, pruned when the underlying series is swept.
The flight recorder is injected by the owning server.
"""

import logging
import math
import os
from typing import Dict, List, Optional, Tuple

from kfserving_tpu_torch.observability import metrics as obs
from kfserving_tpu_torch.observability.history.store import HistoryStore

logger = logging.getLogger("kfserving_tpu_torch.observability.history")

ENV_WATCH = "KFS_HISTORY_WATCH"
ENV_ALPHA = "KFS_HISTORY_WATCH_ALPHA"
ENV_Z = "KFS_HISTORY_WATCH_Z"
ENV_MIN_SAMPLES = "KFS_HISTORY_WATCH_MIN_SAMPLES"
ENV_TICKS = "KFS_HISTORY_WATCH_TICKS"
ENV_COOLDOWN = "KFS_HISTORY_WATCH_COOLDOWN_S"
ENV_WINDOW = "KFS_HISTORY_WATCH_WINDOW_S"

# Leading indicators every deployment has: time-to-first-token and
# request latency tails, the error ratio, pool pressure, and prefix
# cache effectiveness.  `KFS_HISTORY_WATCH` (comma-separated family
# names) replaces the list wholesale.
DEFAULT_WATCHES = (
    "kfserving_tpu_llm_ttft_ms_p99",
    "kfserving_tpu_request_latency_ms_p99",
    "kfserving_tpu_revision_request_ms_p99",
    "kfserving_tpu_history_error_ratio",
    "kfserving_tpu_generator_pool_occupancy_ratio",
    "kfserving_tpu_history_prefix_hit_ratio",
)

DEFAULT_ALPHA = 0.3
DEFAULT_Z = 4.0
DEFAULT_MIN_SAMPLES = 20
DEFAULT_TICKS = 3
DEFAULT_COOLDOWN_S = 60.0
DEFAULT_WINDOW_S = 120.0

# The z-score denominator floor: a flat-lined series (variance ~0)
# must not turn the first real fluctuation into a division-by-epsilon
# z in the thousands — std is floored at 5% of the level and an
# absolute epsilon.
_REL_STD_FLOOR = 0.05
_ABS_STD_FLOOR = 1e-3


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        logger.warning("ignoring non-numeric %s=%r", name, raw)
        return default


class _SeriesState:
    __slots__ = ("ewma", "var", "slope", "streak", "streak_start_ts",
                 "cooldown_until", "n", "last_ts", "last_value",
                 "last_z")

    def __init__(self):
        self.ewma = 0.0
        self.var = 0.0
        self.slope = 0.0
        self.streak = 0
        self.streak_start_ts = 0.0
        self.cooldown_until = 0.0
        self.n = 0
        self.last_ts: Optional[float] = None
        self.last_value = 0.0
        self.last_z = 0.0


class TrendDetector:
    """Per-watched-series EWMA/z-score state machine; `evaluate()`
    runs at the end of every sampler tick."""

    def __init__(self, store: HistoryStore,
                 watches: Optional[List[str]] = None,
                 recorder=None,
                 alpha: Optional[float] = None,
                 z_threshold: Optional[float] = None,
                 min_samples: Optional[int] = None,
                 breach_ticks: Optional[int] = None,
                 cooldown_s: Optional[float] = None,
                 window_s: Optional[float] = None):
        self.store = store
        if watches is None:
            raw = os.environ.get(ENV_WATCH, "")
            watches = ([w.strip() for w in raw.split(",") if w.strip()]
                       if raw.strip() else list(DEFAULT_WATCHES))
        self.watches = list(watches)
        self.recorder = recorder
        self.alpha = (alpha if alpha is not None
                      else _env_float(ENV_ALPHA, DEFAULT_ALPHA))
        self.z_threshold = (
            z_threshold if z_threshold is not None
            else _env_float(ENV_Z, DEFAULT_Z))
        self.min_samples = int(
            min_samples if min_samples is not None
            else _env_float(ENV_MIN_SAMPLES, DEFAULT_MIN_SAMPLES))
        self.breach_ticks = int(
            breach_ticks if breach_ticks is not None
            else _env_float(ENV_TICKS, DEFAULT_TICKS))
        self.cooldown_s = (
            cooldown_s if cooldown_s is not None
            else _env_float(ENV_COOLDOWN, DEFAULT_COOLDOWN_S))
        self.window_s = (
            window_s if window_s is not None
            else _env_float(ENV_WINDOW, DEFAULT_WINDOW_S))
        self._state: Dict[tuple, _SeriesState] = {}
        self.changepoints = 0

    # -- the per-tick pass ------------------------------------------------
    def evaluate(self, now: Optional[float] = None) -> int:
        """Advance every watched series by its newest frame; returns
        the number of change-points declared this pass."""
        if now is None:
            import time

            now = time.time()
        declared = 0
        seen: set = set()
        for name, labels, kind, frames in self.store.watched(
                self.watches):
            if not frames:
                continue
            key = (name, tuple(sorted(labels.items())))
            seen.add(key)
            state = self._state.get(key)
            if state is None:
                state = self._state[key] = _SeriesState()
            # Only frames this state machine has not consumed yet —
            # an idle series (no new frame) advances nothing.
            fresh = [f for f in frames
                     if state.last_ts is None or f[0] > state.last_ts]
            for ts, value in fresh:
                if self._step(name, labels, state, ts, value,
                              frames, now):
                    declared += 1
            self._export(name, labels, state)
        self._prune_stale(seen)
        return declared

    def _step(self, name: str, labels: Dict[str, str],
              state: _SeriesState, ts: float, value: float,
              frames: List[Tuple[float, float]],
              now: float) -> bool:
        if state.last_ts is not None and ts > state.last_ts:
            dv_dt = (value - state.last_value) / (ts - state.last_ts)
            state.slope += self.alpha * (dv_dt - state.slope)
        state.last_ts = ts
        state.last_value = value
        if state.n == 0:
            state.ewma = value
            state.n = 1
            return False
        std = max(math.sqrt(max(state.var, 0.0)),
                  _REL_STD_FLOOR * abs(state.ewma), _ABS_STD_FLOOR)
        z = (value - state.ewma) / std
        state.last_z = z
        breaching = (state.n >= self.min_samples
                     and abs(z) >= self.z_threshold)
        if breaching:
            if state.streak == 0:
                state.streak_start_ts = ts
            state.streak += 1
            # The baseline holds still during a suspected shift so a
            # slow ramp can't drag the mean along and never breach.
            if (state.streak >= self.breach_ticks
                    and ts >= state.cooldown_until):
                self._changepoint(name, labels, state, ts, value, z,
                                  frames)
                return True
            return False
        state.streak = 0
        diff = value - state.ewma
        incr = self.alpha * diff
        state.ewma += incr
        state.var = (1.0 - self.alpha) * (state.var + diff * incr)
        state.n += 1
        return False

    def _changepoint(self, name: str, labels: Dict[str, str],
                     state: _SeriesState, ts: float, value: float,
                     z: float,
                     frames: List[Tuple[float, float]]) -> None:
        self.changepoints += 1
        split = state.streak_start_ts
        half = self.window_s / 2.0
        pre = [[t, v] for t, v in frames
               if split - half <= t < split]
        post = [[t, v] for t, v in frames
                if split <= t <= split + half]
        pin = "trend_" + name
        entry = {
            "kind": "trend",
            "series": name,
            "labels": dict(labels),
            "ts": ts,
            "value": value,
            "baseline": state.ewma,
            "z": z,
            "slope_per_s": state.slope,
            "breach_start_ts": split,
            "pre": pre,
            "post": post,
        }
        if self.recorder is not None:
            try:
                self.recorder.record(entry, pin=pin)
            except Exception:
                logger.exception("trend pin failed")
        obs.trend_changepoints_total().labels(series=name).inc()
        logger.warning(
            "change-point on %s%s: %.4g -> %.4g (z=%.1f)",
            name, labels, state.ewma, value, z)
        # Re-seed at the new level: the shifted regime is the new
        # normal, and the cooldown absorbs its settling noise.
        state.ewma = value
        state.var = 0.0
        state.n = max(state.n, self.min_samples)
        state.streak = 0
        state.cooldown_until = ts + self.cooldown_s

    # -- gauge export -----------------------------------------------------
    def _export(self, name: str, labels: Dict[str, str],
                state: _SeriesState) -> None:
        merged = dict(labels)
        merged["series"] = name
        obs.trend_slope_per_second().labels(**merged).set(state.slope)
        obs.trend_zscore().labels(**merged).set(state.last_z)

    def _prune_stale(self, seen: set) -> None:
        """Drop detector state and exported gauge children for series
        the store swept (pruned revision, reset) — trend gauges must
        not outlive their source rings."""
        for key in [k for k in self._state if k not in seen]:
            del self._state[key]
            name, label_key = key
            merged = dict(label_key)
            merged["series"] = name
            obs.trend_slope_per_second().prune(**merged)
            obs.trend_zscore().prune(**merged)
