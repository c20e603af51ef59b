"""Native LIME image explainer (aixexplainer parity).

Port of ``kfserving_tpu/explainers/lime.py``: numpy only, with the same
seeds, predictor batching and transport chunking.

The reference serves AIX360's LimeImageExplainer behind `:explain`
(reference python/aixexplainer/aixserver/model.py:25-110: segment the
image into superpixels, perturb by masking segments, fit a local linear
surrogate on the predictor's outputs, return per-label superpixel
masks).  This is a first-party implementation of the same artifact with
no lime/aix360/skimage dependency:

- segmentation is a native grid superpixel partition (the reference
  defaults to skimage quickshift; the surrogate fit is the content of
  LIME, the segmenter just needs locality);
- every perturbation batch is ONE predictor call, riding this stack's
  dynamic batcher and padded buckets (lime's default loops in
  chunks of 10);
- the local model is an exponentially-kernel-weighted ridge regression
  solved in closed form per label.

Response contract matches the reference handler: {"explanations":
{"temp": <image>, "masks": [per-label masks], "top_labels": [...]}}
(aixserver/model.py:96-105).
"""

import inspect
import json
import logging
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from kfserving_tpu_torch.explainers.proxy import PredictorProxyModel
from kfserving_tpu_torch.protocol import v1
from kfserving_tpu_torch.protocol.errors import InvalidInput

logger = logging.getLogger("kfserving_tpu_torch.explainers.lime")


def grid_segments(shape: Tuple[int, int], n_segments: int = 64
                  ) -> np.ndarray:
    """[H, W] int32 superpixel labels: a ceil(sqrt(n))^2 grid."""
    h, w = shape
    side = max(1, int(round(n_segments ** 0.5)))
    rows = np.minimum((np.arange(h) * side) // max(h, 1), side - 1)
    cols = np.minimum((np.arange(w) * side) // max(w, 1), side - 1)
    return (rows[:, None] * side + cols[None, :]).astype(np.int32)


def _ridge(x: np.ndarray, y: np.ndarray, weights: np.ndarray,
           alpha: float = 1.0) -> np.ndarray:
    """Weighted ridge fit; returns coefficients (no intercept term in
    the output — LIME ranks features by coefficient magnitude)."""
    xw = x * weights[:, None]
    # Append intercept column so segment weights aren't forced to soak
    # up the base rate.
    ones = np.ones((len(x), 1))
    xa = np.concatenate([x, ones], axis=1)
    xwa = np.concatenate([xw, weights[:, None]], axis=1)
    gram = xwa.T @ xa + alpha * np.eye(xa.shape[1])
    coef = np.linalg.solve(gram, xwa.T @ y)
    return coef[:-1]


class LimeImageSearch:
    """Sample-perturb-fit loop over one image.

    predict_fn: batch [n, H, W, C] -> probabilities [n, k] (or labels
        [n], one-hot'd here — the reference tolerates both through its
        predictor proxy).
    """

    def __init__(self, predict_fn: Callable,
                 n_segments: int = 64,
                 kernel_width: float = 0.25,
                 hide_color: float = 0.0,
                 seed: int = 0):
        self.predict_fn = predict_fn
        self.n_segments = n_segments
        self.kernel_width = kernel_width
        self.hide_color = hide_color
        self.rng = np.random.default_rng(seed)

    async def _raw(self, batch: np.ndarray) -> np.ndarray:
        out = self.predict_fn(batch)
        if inspect.isawaitable(out):
            out = await out
        return np.asarray(out)

    async def explain(self, image: np.ndarray,
                      num_samples: int = 256,
                      top_labels: int = 2,
                      num_features: int = 10,
                      positive_only: bool = True,
                      min_weight: float = 0.0,
                      batch_size: int = 64) -> Dict[str, Any]:
        if image.ndim == 2:
            image = image[..., None]
        if image.ndim != 3:
            raise InvalidInput(
                f"LIME images needs [H, W, C] or [H, W], got shape "
                f"{list(image.shape)}")
        segments = grid_segments(image.shape[:2], self.n_segments)
        seg_ids = np.unique(segments)
        s = len(seg_ids)
        onehot = (segments[None, ...] == seg_ids[:, None, None])

        # Binary presence vectors; first row = unperturbed image.
        z = self.rng.integers(0, 2, size=(num_samples, s)).astype(
            np.float64)
        z[0] = 1.0
        background = np.full_like(image, self.hide_color,
                                  dtype=image.dtype)
        raws = []
        for start in range(0, num_samples, batch_size):
            chunk = z[start:start + batch_size]
            # [b, H, W] pixel keep-mask from segment presence
            keep = np.einsum("bs,shw->bhw", chunk, onehot) > 0
            batch = np.where(keep[..., None], image[None], background)
            raws.append(await self._raw(batch))
        if raws[0].ndim == 1:
            # Label outputs: one-hot AFTER concatenation so the class
            # width is global, not per-chunk (chunks that happen not to
            # observe the top class would otherwise disagree in width).
            labels = np.concatenate(raws).astype(np.int64)
            y = np.eye(max(int(labels.max()) + 1, 2))[labels]
        else:
            y = np.concatenate(
                [np.asarray(r, np.float64) for r in raws], axis=0)

        # Exponential kernel on cosine distance to the full image.
        frac = z.sum(axis=1) / s
        dist = 1.0 - frac  # cosine distance to all-ones for binary z
        # _ridge applies this once when forming the normal equations
        # (gram = (X*w)^T X), so it must be the full kernel value, not
        # its square root, for the solved system to be
        # X^T diag(kernel) X (LIME's weighted least squares).
        weights = np.exp(-(dist ** 2) / self.kernel_width ** 2)

        order = np.argsort(y[0])[::-1][:top_labels]
        masks: List[List[List[int]]] = []
        weights_out = []
        for label in order:
            coef = _ridge(z, y[:, label], weights)
            rank = np.argsort(np.abs(coef))[::-1]
            chosen = []
            for j in rank[:num_features]:
                if positive_only and coef[j] <= 0:
                    continue
                if abs(coef[j]) < min_weight:
                    continue
                chosen.append(j)
            mask = np.zeros(segments.shape, np.int32)
            for j in chosen:
                mask[segments == seg_ids[j]] = 1 if coef[j] > 0 else -1
            masks.append(mask.tolist())
            weights_out.append(
                {str(int(seg_ids[j])): float(coef[j]) for j in chosen})
        return {
            "temp": image.tolist(),
            "masks": masks,
            "top_labels": [int(c) for c in order],
            "segment_weights": weights_out,
        }


class LimeImages(PredictorProxyModel):
    """Served LIME explainer: `:explain` with predictor proxying (the
    aixexplainer deployment shape, aixserver/model.py:44-50).

    Artifact layout (`storage_uri`, all optional):
        lime.json — {"n_segments": 64, "num_samples": 256,
                     "top_labels": 2, "positive_only": true,
                     "min_weight": 0.0, "kernel_width": 0.25}
    """

    def __init__(self, name: str, model_dir: str = "",
                 predictor_host: Optional[str] = None,
                 predict_fn: Optional[Callable] = None):
        super().__init__(name, predictor_host=predictor_host,
                         predict_fn=predict_fn)
        self.model_dir = model_dir
        self.config: Dict[str, Any] = {}
        self.search: Optional[LimeImageSearch] = None

    def load(self) -> bool:
        _, self.config = self._load_artifact_dir(self.model_dir,
                                                 "lime.json")
        self.search = LimeImageSearch(
            self._proxied_predict,
            n_segments=int(self.config.get("n_segments", 64)),
            kernel_width=float(self.config.get("kernel_width", 0.25)),
            hide_color=float(self.config.get("hide_color", 0.0)),
            seed=int(self.config.get("seed", 0)))
        self.ready = True
        return True

    async def explain(self, request: Any) -> Any:
        if self.search is None:
            raise InvalidInput(f"explainer {self.name} not loaded")
        instances = v1.get_instances(request)
        # len(): the server's native codec hands dense bodies over as
        # one ndarray, whose truth value is ambiguous.
        if len(instances) == 0:
            raise InvalidInput("LIME explainer needs one instance")
        # Per-request parameter overrides, same knobs as the reference
        # handler (aixserver/model.py:55-70).
        req = request if isinstance(request, dict) else {}
        explanation = await self.search.explain(
            np.asarray(instances[0], np.float64),
            num_samples=int(req.get(
                "num_samples", self.config.get("num_samples", 256))),
            top_labels=int(req.get(
                "top_labels", self.config.get("top_labels", 2))),
            num_features=int(req.get(
                "num_features", self.config.get("num_features", 10))),
            positive_only=bool(req.get(
                "positive_only", self.config.get("positive_only", True))),
            min_weight=float(req.get(
                "min_weight", self.config.get("min_weight", 0.0))),
            batch_size=int(self.config.get("batch_size", 64)))
        return {"explanations": explanation}
