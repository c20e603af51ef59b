"""Online drift / outlier monitors: streaming consumers for the bus.

Port of ``kfserving_tpu/observability/monitoring/monitors.py``,
unchanged in behaviour.  The monitors run the detectors' math as
in-process MonitorBus consumers and publish their verdicts per model:

    kfserving_tpu_drift_score{model=...}
    kfserving_tpu_outlier_rate{model=...}
    kfserving_tpu_monitor_alert_state{model=..., monitor=...}

The math is that of ``kfserving_tpu/detectors/drift.py`` (a
Bonferroni-corrected per-feature two-sample KS test) and
``kfserving_tpu/detectors/outlier.py`` (Mahalanobis distance to a
fitted Gaussian, a percentile threshold): the port has no detectors
package yet, so this module keeps its own copy of the functions the
monitors call.  Both monitors summarize the reference sample once and
keep a bounded sliding window of live rows.
"""

import json
import logging
import math
from collections import deque
from typing import Any, Dict, Optional

import numpy as np

from kfserving_tpu_torch.observability import metrics as obs
from kfserving_tpu_torch.protocol.errors import InvalidInput

logger = logging.getLogger("kfserving_tpu_torch.monitoring.monitors")


# -- the detectors' math (kfserving_tpu/detectors/drift.py, outlier.py) --
def ks_statistic(a: np.ndarray, b: np.ndarray,
                 a_sorted: bool = False) -> float:
    """Two-sample Kolmogorov-Smirnov statistic (max ECDF distance).
    a_sorted=True skips re-sorting a static reference sample."""
    a = np.asarray(a, np.float64)
    if not a_sorted:
        a = np.sort(a)
    b = np.sort(np.asarray(b, np.float64))
    grid = np.concatenate([a, b])
    cdf_a = np.searchsorted(a, grid, side="right") / len(a)
    cdf_b = np.searchsorted(b, grid, side="right") / len(b)
    return float(np.abs(cdf_a - cdf_b).max())


def ks_p_value(d: float, n: int, m: int) -> float:
    """Asymptotic two-sample KS p-value (Kolmogorov distribution with
    the Stephens small-sample correction, as scipy's asymp mode)."""
    if d <= 0:
        return 1.0
    en = math.sqrt(n * m / (n + m))
    lam = (en + 0.12 + 0.11 / en) * d
    total = 0.0
    for k in range(1, 101):
        term = (-1) ** (k - 1) * math.exp(-2.0 * (k * lam) ** 2)
        total += term
        if abs(term) < 1e-10:
            break
    return max(0.0, min(1.0, 2.0 * total))


def ks_drift_test(ref_sorted: np.ndarray, window: np.ndarray,
                  reference_len: int,
                  p_value: float) -> Dict[str, Any]:
    """Bonferroni-corrected per-feature KS drift verdict: the drift
    flag, per-feature p-values, the max KS statistic (the exported
    drift score) and the corrected threshold."""
    d = ref_sorted.shape[1]
    stats, p_values = [], []
    for j in range(d):
        stat = ks_statistic(ref_sorted[:, j], window[:, j],
                            a_sorted=True)
        stats.append(stat)
        p_values.append(ks_p_value(stat, reference_len, len(window)))
    threshold = p_value / d  # Bonferroni
    return {
        "drift": bool(min(p_values) < threshold),
        "score": float(max(stats)),
        "p_values": p_values,
        "threshold": threshold,
        "window": len(window),
    }


class MahalanobisScorer:
    """Closed-form Mahalanobis distance to a fitted Gaussian."""

    def __init__(self, train: np.ndarray, regularization: float = 1e-6):
        train = np.asarray(train, np.float64)
        if train.ndim != 2 or len(train) < 2:
            raise InvalidInput("outlier train data must be [m>=2, d]")
        self.mean = train.mean(axis=0)
        cov = np.atleast_2d(np.cov(train, rowvar=False))
        cov += regularization * np.eye(cov.shape[0])
        self.precision = np.linalg.inv(cov)

    def score(self, batch: np.ndarray) -> np.ndarray:
        """[n] Mahalanobis distances; rows flattened to the fitted d."""
        x = np.asarray(batch, np.float64).reshape(len(batch), -1)
        if x.shape[1] != self.mean.shape[0]:
            raise InvalidInput(
                f"instance dim {x.shape[1]} != fitted dim "
                f"{self.mean.shape[0]}")
        delta = x - self.mean
        return np.sqrt(np.einsum("ni,ij,nj->n", delta, self.precision,
                                 delta))


def fit_threshold(scorer: MahalanobisScorer, train: np.ndarray,
                  percentile: float = 99.5) -> float:
    """Threshold = a percentile of the train sample's own scores."""
    return float(np.percentile(scorer.score(
        np.asarray(train, np.float64)), percentile))


def event_instances(event: Dict[str, Any]) -> Optional[np.ndarray]:
    """[n, d] float array from a bus event's payload, or None when the
    payload is not a numeric V1 body (generate bodies, V2 tensors,
    malformed JSON — the monitor just skips those samples)."""
    payload = event.get("payload")
    if not payload:
        return None
    try:
        body = json.loads(payload)
    except (ValueError, UnicodeDecodeError):
        return None
    if not isinstance(body, dict):
        return None
    instances = body.get("instances", body.get("inputs"))
    if not isinstance(instances, list) or not instances:
        return None
    try:
        arr = np.asarray(instances, np.float64)
    except (ValueError, TypeError):
        return None
    if arr.dtype == object:
        return None
    if arr.ndim == 1:
        arr = arr[None]
    return arr.reshape(len(arr), -1)


class _ModelFilter:
    """Shared event gating: a monitor watches exactly one model."""

    def __init__(self, model: str):
        self.model = model

    def _instances(self, event: Dict[str, Any]
                   ) -> Optional[np.ndarray]:
        if event.get("model") != self.model:
            return None
        return event_instances(event)


class DriftMonitor(_ModelFilter):
    """Sliding-window per-feature KS drift vs a reference sample,
    Bonferroni-corrected: the served KS drift detector's
    semantics as a streaming consumer."""

    def __init__(self, model: str, reference: np.ndarray,
                 window: int = 128, p_value: float = 0.05,
                 test_stride: Optional[int] = None):
        super().__init__(model)
        self.name = f"drift:{model}"
        reference = np.asarray(reference, np.float64)
        if reference.ndim != 2 or len(reference) < 2:
            raise ValueError("drift reference must be [m>=2, d]")
        self.reference_len = len(reference)
        self._ref_sorted = np.sort(reference, axis=0)
        self.dim = reference.shape[1]
        self.window_size = max(1, int(window))
        self.p_value = float(p_value)
        self.window: deque = deque(maxlen=self.window_size)
        self.test_stride = int(test_stride if test_stride is not None
                               else max(1, self.window_size // 16))
        self._rows_since_test = 0
        self.alerting = False
        self.last_result: Optional[Dict[str, Any]] = None

    async def __call__(self, event: Dict[str, Any]) -> None:
        instances = self._instances(event)
        if instances is None or instances.shape[1] != self.dim:
            return
        for row in instances:
            self.window.append(row)
        self._rows_since_test += len(instances)
        if len(self.window) < self.window_size or \
                self._rows_since_test < self.test_stride:
            return
        self._rows_since_test = 0
        result = ks_drift_test(self._ref_sorted, np.stack(self.window),
                               self.reference_len, self.p_value)
        self.alerting = result["drift"]
        self.last_result = {
            "drift": self.alerting,
            "score": round(result["score"], 6),
            "min_p_value": round(min(result["p_values"]), 8),
            "threshold": result["threshold"],
            "window": result["window"],
        }
        obs.drift_score().labels(model=self.model).set(
            result["score"])
        obs.monitor_alert_state().labels(
            model=self.model, monitor="drift").set(
                1.0 if self.alerting else 0.0)
        if self.alerting:
            logger.warning("drift alert for model %s: %s", self.model,
                           self.last_result)


class OutlierMonitor(_ModelFilter):
    """Windowed Mahalanobis outlier RATE: the served outlier
    detector's scoring as a streaming consumer.  The exported signal is the
    fraction of the sliding window past the fitted threshold, which a
    single extreme request can't saturate (per-request verdicts stay
    the served detector's job)."""

    def __init__(self, model: str, reference: Optional[np.ndarray] = None,
                 scorer=None, threshold: Optional[float] = None,
                 threshold_percentile: float = 99.5,
                 window: int = 128, alert_rate: float = 0.1):
        super().__init__(model)
        self.name = f"outlier:{model}"
        if scorer is None:
            if reference is None:
                raise ValueError(
                    "OutlierMonitor needs a reference sample or a "
                    "fitted scorer")
            scorer = MahalanobisScorer(reference)
        self.scorer = scorer
        if threshold is None:
            if reference is None:
                raise ValueError(
                    "threshold required when wrapping a bare scorer")
            threshold = fit_threshold(self.scorer, reference,
                                      threshold_percentile)
        self.threshold = float(threshold)
        self.window_size = max(1, int(window))
        self.alert_rate = float(alert_rate)
        self.flags: deque = deque(maxlen=self.window_size)
        self.seen = 0
        self.flagged = 0
        self.alerting = False

    async def __call__(self, event: Dict[str, Any]) -> None:
        instances = self._instances(event)
        if instances is None:
            return
        try:
            scores = self.scorer.score(instances)
        except InvalidInput:
            return  # dimension mismatch: not this monitor's traffic
        flags = scores > self.threshold
        self.seen += len(flags)
        self.flagged += int(flags.sum())
        self.flags.extend(bool(f) for f in flags)
        rate = (sum(self.flags) / len(self.flags)) if self.flags else 0.0
        was = self.alerting
        self.alerting = len(self.flags) >= min(8, self.window_size) \
            and rate >= self.alert_rate
        obs.outlier_rate().labels(model=self.model).set(rate)
        obs.monitor_alert_state().labels(
            model=self.model, monitor="outlier").set(
                1.0 if self.alerting else 0.0)
        if self.alerting and not was:
            logger.warning(
                "outlier alert for model %s: window rate %.3f >= %.3f "
                "(threshold %.3f)", self.model, rate, self.alert_rate,
                self.threshold)
