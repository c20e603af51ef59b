"""Distribution drift of served payloads: a per-feature KS test.

Port of ``kfserving_tpu/detectors/drift.py``, unchanged in behaviour:
per-feature two-sample Kolmogorov-Smirnov tests between a reference
sample and a sliding window of served instances, Bonferroni-corrected
across features, in closed-form numpy.

Artifact layout (``storage_uri``):
    train.npy    - [m, d] reference sample
    drift.json   - {"window": 128, "p_value": 0.05}  (optional)
"""

import json
import logging
import math
import os
from collections import deque
from typing import Any, Dict, Optional

import numpy as np

from kfserving_tpu_torch.model.model import Model
from kfserving_tpu_torch.protocol import v1
from kfserving_tpu_torch.protocol.errors import InvalidInput

logger = logging.getLogger("kfserving_tpu_torch.detectors.drift")


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
    """Bonferroni-corrected per-feature KS drift verdict: the shared
    core of the served `KSDriftDetector` and the streaming
    `observability.monitoring.DriftMonitor`.

    ref_sorted: [m, d] reference, column-sorted once at load/fit.
    window: [w, d] live sample.  Returns drift flag, per-feature
    p-values, the max KS statistic (the exported drift score), and
    the corrected threshold."""
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


class KSDriftDetector(Model):
    """Sliding-window per-feature KS drift vs a reference sample.

    Each served payload appends to the window; once full, every event
    re-tests.  Bonferroni: drift when any feature's p-value falls below
    p_value / d (alibi-detect's default correction)."""

    def __init__(self, name: str, model_dir: str,
                 window: Optional[int] = None,
                 p_value: Optional[float] = None):
        super().__init__(name)
        self.model_dir = model_dir
        self._window_override = window
        self._p_override = p_value
        self.reference: Optional[np.ndarray] = None
        self.window: deque = deque()
        self.window_size = 128
        self.p_value = 0.05
        self.drift_events = 0
        self.last_result: Optional[Dict[str, Any]] = None

    def load(self) -> bool:
        from kfserving_tpu_torch.storage import Storage

        local = Storage.download(self.model_dir)
        self.reference = np.asarray(
            np.load(os.path.join(local, "train.npy")), np.float64)
        if self.reference.ndim != 2:
            raise InvalidInput("drift reference must be [m, d]")
        cfg: Dict[str, Any] = {}
        cfg_path = os.path.join(local, "drift.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                cfg = json.load(f)
        # `is not None` (not truthiness): an explicit override of 0 must
        # be rejected by the range checks below, not silently replaced
        # by the config default.
        self.window_size = int(
            self._window_override if self._window_override is not None
            else cfg.get("window", 128))
        self.p_value = float(
            self._p_override if self._p_override is not None
            else cfg.get("p_value", 0.05))
        if self.window_size < 1:
            raise InvalidInput(
                f"drift window must be >= 1, got {self.window_size}")
        if not 0.0 < self.p_value < 1.0:
            raise InvalidInput(
                f"drift p_value must be in (0, 1), got {self.p_value}")
        self.window = deque(maxlen=self.window_size)
        # Pre-sort the static reference once; re-test at a stride, not
        # per event (d KS tests over a high-dim payload per mirrored
        # request would stall the sink's event loop and drop payloads).
        self._ref_sorted = np.sort(self.reference, axis=0)
        self.test_stride = int(cfg.get(
            "test_stride", max(1, self.window_size // 16)))
        self._rows_since_test = 0
        self.ready = True
        return True

    async def predict(self, request: Any) -> Any:
        if self.reference is None:
            raise InvalidInput(f"detector {self.name} not loaded")
        if isinstance(request, dict) and "predictions" in request \
                and "instances" not in request and "inputs" not in request:
            return {"ignored": "response event"}
        try:
            instances = np.asarray(v1.get_instances(request), np.float64)
        except (ValueError, TypeError) as e:
            raise InvalidInput(f"non-numeric payload: {e}")
        if instances.ndim == 1:
            instances = instances[None]
        instances = instances.reshape(len(instances), -1)
        d = self.reference.shape[1]
        if instances.shape[1] != d:
            raise InvalidInput(
                f"instance dim {instances.shape[1]} != reference dim {d}")
        for row in instances:
            self.window.append(row)
        self._rows_since_test += len(instances)
        if len(self.window) < self.window_size:
            return {"drift": None,
                    "window_fill": len(self.window) / self.window_size}
        if self._rows_since_test < self.test_stride and \
                self.last_result is not None:
            return self.last_result
        self._rows_since_test = 0
        result = ks_drift_test(self._ref_sorted, np.stack(self.window),
                               len(self.reference), self.p_value)
        if result["drift"]:
            self.drift_events += 1
        result["p_values"] = [round(p, 6) for p in result["p_values"]]
        del result["score"]  # response-shape compatibility
        self.last_result = result
        return self.last_result

    def metadata(self) -> Dict[str, Any]:
        meta = super().metadata()
        meta.update({"detector": "ks-drift",
                     "window_size": self.window_size,
                     "drift_events": self.drift_events})
        return meta
