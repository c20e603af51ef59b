"""Payload detectors: outlier and drift scoring of served traffic.

Port of ``kfserving_tpu/detectors``.  Each detector is a Model: serve
one (``python -m kfserving_tpu_torch.detectors``) and point an
InferenceService's ``logger.url`` at its ``:predict`` route, and every
mirrored request payload is scored as it is served.  The math (KS tests,
Mahalanobis distance) is numpy on the host; the streaming monitors of
``observability/monitoring`` call the same functions.
"""

from kfserving_tpu_torch.detectors.drift import (  # noqa: F401
    KSDriftDetector,
    ks_drift_test,
    ks_p_value,
    ks_statistic,
)
from kfserving_tpu_torch.detectors.outlier import (  # noqa: F401
    MahalanobisScorer,
    OutlierDetector,
    fit_threshold,
)

DETECTOR_TYPES = ("outlier", "drift")


def build_detector(name: str, detector_type: str, storage_uri: str,
                   alert_url=None):
    if detector_type == "outlier":
        return OutlierDetector(name, storage_uri, alert_url=alert_url)
    if detector_type == "drift":
        return KSDriftDetector(name, storage_uri)
    raise ValueError(
        f"unknown detector type {detector_type!r} "
        f"(one of {list(DETECTOR_TYPES)})")
