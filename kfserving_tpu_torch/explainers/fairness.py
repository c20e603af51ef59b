"""Fairness metrics explainer — the aiffairness server's contract
(reference python/aiffairness/aifserver/model.py:25-90) without the
AIF360 dependency: the reported metrics are closed-form statistics of
(features, predictions), computed here with numpy.

Port of ``kfserving_tpu/explainers/fairness.py``: numpy only, with the same
seeds, predictor batching and transport chunking.

explain() takes V1 instances plus either precomputed "outputs" or a
predictor_host to score against, and returns the reference's metric
dict: base_rate, consistency, disparate_impact, num_instances,
num_negatives, num_positives, statistical_parity_difference.
"""

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from kfserving_tpu_torch.model.model import Model
from kfserving_tpu_torch.protocol.errors import InvalidInput


class FairnessExplainer(Model):
    """Bias metrics over a batch of predictions.

    privileged_groups / unprivileged_groups: lists of {feature: value}
    conditions (a row belongs to a group when all its conditions hold),
    same shape as the reference's ctor args.
    """

    def __init__(self, name: str,
                 feature_names: Sequence[str],
                 privileged_groups: List[Dict[str, Any]],
                 unprivileged_groups: List[Dict[str, Any]],
                 favorable_label: float = 1.0,
                 unfavorable_label: float = 0.0,
                 predictor_host: Optional[str] = None,
                 n_neighbors: int = 5):
        super().__init__(name)
        self.feature_names = list(feature_names)
        self.privileged_groups = privileged_groups
        self.unprivileged_groups = unprivileged_groups
        self.favorable_label = favorable_label
        self.unfavorable_label = unfavorable_label
        self.predictor_host = predictor_host
        self.n_neighbors = n_neighbors
        self.ready = True

    def _group_mask(self, X: np.ndarray,
                    groups: List[Dict[str, Any]]) -> np.ndarray:
        """Rows matching ANY group (conditions within a group AND)."""
        mask = np.zeros(X.shape[0], dtype=bool)
        for group in groups:
            g = np.ones(X.shape[0], dtype=bool)
            for feature, value in group.items():
                try:
                    col = self.feature_names.index(feature)
                except ValueError:
                    raise InvalidInput(
                        f"group condition references unknown feature "
                        f"{feature!r}; features: {self.feature_names}")
                g &= X[:, col] == value
            mask |= g
        return mask

    def _consistency(self, X: np.ndarray, y: np.ndarray) -> float:
        """AIF360 consistency: 1 - mean |y_i - mean(y of i's kNN)|
        (k nearest rows by euclidean distance, excluding self)."""
        n = X.shape[0]
        k = min(self.n_neighbors, n - 1)
        if k <= 0:
            return 1.0
        d2 = ((X[:, None, :] - X[None, :, :]) ** 2).sum(-1)
        np.fill_diagonal(d2, np.inf)
        idx = np.argpartition(d2, k - 1, axis=1)[:, :k]
        return float(1.0 - np.abs(y - y[idx].mean(axis=1)).mean())

    def metrics(self, X: np.ndarray, preds: np.ndarray) -> Dict[str, Any]:
        favorable = preds == self.favorable_label
        priv = self._group_mask(X, self.privileged_groups)
        unpriv = self._group_mask(X, self.unprivileged_groups)

        def base_rate(mask=None) -> float:
            sel = favorable if mask is None else favorable[mask]
            return float(sel.mean()) if sel.size else 0.0

        rate_priv = base_rate(priv)
        rate_unpriv = base_rate(unpriv)
        return {
            "base_rate": base_rate(),
            "consistency": [self._consistency(
                np.asarray(X, np.float64), favorable.astype(np.float64))],
            "disparate_impact": (rate_unpriv / rate_priv
                                 if rate_priv > 0 else float("inf")),
            "num_instances": float(preds.shape[0]),
            "num_negatives": float((~favorable).sum()),
            "num_positives": float(favorable.sum()),
            "statistical_parity_difference": rate_unpriv - rate_priv,
        }

    async def explain(self, request: Any) -> Any:
        if not isinstance(request, dict) or "instances" not in request:
            raise InvalidInput('expected "instances"')
        X = np.asarray(request["instances"], dtype=np.float64)
        if X.ndim != 2 or X.shape[1] != len(self.feature_names):
            raise InvalidInput(
                f"instances must be [n, {len(self.feature_names)}] rows "
                f"matching feature_names")
        if "outputs" in request:
            preds = np.asarray(request["outputs"], dtype=np.float64)
        elif self.predictor_host:
            resp = await super().predict(
                {"instances": request["instances"]})
            preds = np.asarray(resp["predictions"], dtype=np.float64)
        else:
            raise InvalidInput(
                'request needs "outputs" (precomputed predictions) or '
                'the explainer a predictor_host')
        preds = preds.reshape(-1)
        if preds.shape[0] != X.shape[0]:
            raise InvalidInput("outputs/instances length mismatch")
        return {"predictions": preds.tolist(),
                "metrics": self.metrics(X, preds)}
