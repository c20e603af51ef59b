"""Online drift / outlier monitors: streaming consumers for the bus.

Port of ``kfserving_tpu/observability/monitoring/monitors.py``,
unchanged in behaviour.  The monitors run the detectors' math as
in-process MonitorBus consumers and publish their verdicts per model:

    kfserving_tpu_drift_score{model=...}
    kfserving_tpu_outlier_rate{model=...}
    kfserving_tpu_monitor_alert_state{model=..., monitor=...}

The math is the detectors' (``kfserving_tpu_torch/detectors``): a
Bonferroni-corrected per-feature two-sample KS test, and a Mahalanobis
distance to a fitted Gaussian with a percentile threshold.  Both
monitors summarize the reference sample once and keep a bounded sliding
window of live rows.
"""

import json
import logging
from collections import deque
from typing import Any, Dict, Optional

import numpy as np

from kfserving_tpu_torch.detectors import (
    MahalanobisScorer,
    fit_threshold,
    ks_drift_test,
)
from kfserving_tpu_torch.observability import metrics as obs
from kfserving_tpu_torch.protocol.errors import InvalidInput

logger = logging.getLogger("kfserving_tpu_torch.monitoring.monitors")


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

    @classmethod
    def from_detector(cls, detector, window: Optional[int] = None
                      ) -> "DriftMonitor":
        """Wrap a loaded `KSDriftDetector` (its reference and config) as
        a streaming monitor."""
        return cls(detector.name, detector.reference,
                   window=window or detector.window_size,
                   p_value=detector.p_value,
                   test_stride=detector.test_stride)

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

    @classmethod
    def from_detector(cls, detector, window: int = 128,
                      alert_rate: float = 0.1) -> "OutlierMonitor":
        """Wrap a loaded `OutlierDetector` (its fitted scorer and
        threshold) as a streaming monitor."""
        return cls(detector.name, scorer=detector.scorer,
                   threshold=detector.threshold, window=window,
                   alert_rate=alert_rate)

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
