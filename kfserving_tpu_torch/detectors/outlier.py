"""Outliers in served payloads: Mahalanobis distance to the training
distribution.

Port of ``kfserving_tpu/detectors/outlier.py``, unchanged in behaviour:
a detector served as a Model; point an InferenceService's ``logger.url``
at its ``:predict`` route and every request payload is scored.  On an
outlier it may post an alert CloudEvent, fire and forget, through the
port's HTTP client (``server/client.py``).

Artifact layout (``storage_uri``):
    train.npy      - [m, d] reference sample (fit: mean + covariance)
    outlier.json   - {"threshold_percentile": 99.5} or
                     {"threshold": 12.3}  (optional; percentile of the
                     train sample's own scores by default)
"""

import json
import logging
import os
import time
from typing import Any, Dict, Optional

import numpy as np

from kfserving_tpu_torch.model.model import Model
from kfserving_tpu_torch.protocol import v1
from kfserving_tpu_torch.protocol.errors import InvalidInput

logger = logging.getLogger("kfserving_tpu_torch.detectors.outlier")


class MahalanobisScorer:
    """Closed-form Mahalanobis distance to a fitted Gaussian."""

    def __init__(self, train: np.ndarray, regularization: float = 1e-6):
        train = np.asarray(train, np.float64)
        if train.ndim != 2 or len(train) < 2:
            raise InvalidInput("outlier train data must be [m>=2, d]")
        self.mean = train.mean(axis=0)
        cov = np.cov(train, rowvar=False)
        cov = np.atleast_2d(cov)
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
    """Threshold = a percentile of the train sample's own scores: the
    shared fit used by the served `OutlierDetector` and the streaming
    `observability.monitoring.OutlierMonitor`."""
    return float(np.percentile(scorer.score(
        np.asarray(train, np.float64)), percentile))


class OutlierDetector(Model):
    """Served detector: scores request payloads against the training
    distribution; responds (and counts) per-instance verdicts.

    As a logger sink it receives CloudEvents; response events
    (org.kubeflow.serving.inference.response) are acknowledged and
    skipped — only request payloads carry feature vectors."""

    def __init__(self, name: str, model_dir: str,
                 alert_url: Optional[str] = None):
        super().__init__(name)
        self.model_dir = model_dir
        self.alert_url = alert_url
        self.scorer: Optional[MahalanobisScorer] = None
        self.threshold: Optional[float] = None
        self.seen = 0
        self.flagged = 0
        self.alerts_sent = 0
        self.alert_errors = 0
        # Strong refs: the loop holds tasks weakly — an un-referenced
        # fire-and-forget alert can be GC'd mid-POST.
        self._alert_tasks: set = set()

    def load(self) -> bool:
        from kfserving_tpu_torch.storage import Storage

        local = Storage.download(self.model_dir)
        train = np.load(os.path.join(local, "train.npy"))
        cfg: Dict[str, Any] = {}
        cfg_path = os.path.join(local, "outlier.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                cfg = json.load(f)
        self.scorer = MahalanobisScorer(
            train, regularization=float(cfg.get("regularization", 1e-6)))
        if "threshold" in cfg:
            self.threshold = float(cfg["threshold"])
        else:
            self.threshold = fit_threshold(
                self.scorer, train,
                float(cfg.get("threshold_percentile", 99.5)))
        self.ready = True
        return True

    async def predict(self, request: Any) -> Any:
        if self.scorer is None:
            raise InvalidInput(f"detector {self.name} not loaded")
        # Logger response events carry predictions, not features.
        if isinstance(request, dict) and "predictions" in request \
                and "instances" not in request and "inputs" not in request:
            return {"ignored": "response event"}
        try:
            instances = np.asarray(v1.get_instances(request), np.float64)
        except (ValueError, TypeError) as e:
            # Ragged / non-numeric mirrored payloads are the sender's
            # shape, not a server fault.
            raise InvalidInput(f"non-numeric payload: {e}")
        if instances.ndim == 1:
            instances = instances[None]
        scores = self.scorer.score(instances)
        outliers = scores > self.threshold
        self.seen += len(scores)
        self.flagged += int(outliers.sum())
        if outliers.any() and self.alert_url:
            # Fire-and-forget: a slow alert broker must not stall the
            # logger sink (its workers await this response; a blocked
            # sink drops mirrored payloads).
            import asyncio

            task = asyncio.get_running_loop().create_task(
                self._alert(scores[outliers]))
            self._alert_tasks.add(task)
            task.add_done_callback(self._alert_tasks.discard)
        return {
            "outlier": outliers.astype(int).tolist(),
            "score": np.round(scores, 6).tolist(),
            "threshold": self.threshold,
        }

    async def _alert(self, scores: np.ndarray) -> None:
        """Emit an alert CloudEvent (to a broker).  Uses the inherited
        Model.http_client, so close() closes it."""
        from kfserving_tpu_torch.protocol import cloudevents

        try:
            event = cloudevents.new_event(
                "io.kfserving_tpu.detector.outlier",
                f"detector/{self.name}",
                {"count": int(len(scores)),
                 "max_score": float(scores.max()),
                 "threshold": self.threshold,
                 "ts": time.time()})
            headers, body = cloudevents.to_binary(event)
            await self.http_client.request("POST", self.alert_url, body,
                                           headers)
            self.alerts_sent += 1
        except Exception as e:  # alerting must never fail serving
            self.alert_errors += 1
            logger.warning("outlier alert to %s failed: %s",
                           self.alert_url, e)

    async def close(self) -> None:
        """Drain in-flight alerts before the HTTP client closes."""
        import asyncio

        if self._alert_tasks:
            await asyncio.gather(*list(self._alert_tasks),
                                 return_exceptions=True)
        await super().close()

    def metadata(self) -> Dict[str, Any]:
        meta = super().metadata()
        meta.update({"detector": "mahalanobis", "seen": self.seen,
                     "flagged": self.flagged,
                     "threshold": self.threshold})
        return meta
