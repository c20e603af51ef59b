"""Native anchor-images explainer: high-precision superpixel sets.

Port of ``kfserving_tpu/explainers/anchor_images.py``: numpy only, with
the same seeds, predictor batching and transport chunking.

The reference serves alibi's AnchorImage behind `:explain` (reference
python/alibiexplainer/alibiexplainer/anchor_images.py:26-50 — wraps a
built alibi.explainers.AnchorImage, argmax-adapts probability
predictors, explains inputs[0]; dispatch explainer.py:57-58).  This is
a first-party implementation of the same artifact: the smallest set of
superpixels whose presence alone keeps the model's prediction, with
precision estimated by Monte-Carlo segment dropout through the live
predictor.

Anchor semantics (Ribeiro 2018 §2, image instantiation):
- predicates are "superpixel j shows the original pixels";
- a perturbation keeps each non-anchored segment with probability
  p_sample and replaces dropped segments with the segment's mean color
  (alibi's default fudged-image fill);
- precision(A) = P[f(perturbed) == f(x)], coverage(A) = p_sample^|A| —
  the exact probability a random perturbation pattern satisfies the
  anchor under the sampling distribution (alibi estimates the same
  quantity from a sample of patterns).

Segmentation is the native grid partition shared with LIME images
(`lime.grid_segments`); the beam search, candidate coalescing (one
predictor round trip per beam level) and 5x confirmation are the shared
`anchors.beam_anchor_search`.
"""

import logging
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from kfserving_tpu_torch.explainers.anchors import (
    beam_anchor_search,
    call_labels,
    estimate_precisions,
)
from kfserving_tpu_torch.explainers.lime import grid_segments
from kfserving_tpu_torch.explainers.proxy import PredictorProxyModel
from kfserving_tpu_torch.protocol import v1
from kfserving_tpu_torch.protocol.errors import InvalidInput

logger = logging.getLogger("kfserving_tpu_torch.explainers.anchor_images")


class AnchorImageSearch:
    """Beam search for the smallest high-precision superpixel anchor.

    predict_fn: (sync or async) image batch [n, H, W, C] -> labels [n]
        (or probabilities [n, k], argmax'd — the reference argmax-wraps
        the same two cases, anchor_images.py:42-45).
    """

    def __init__(self, predict_fn: Callable,
                 n_segments: int = 36,
                 p_sample: float = 0.5,
                 max_call_bytes: int = 64 << 20,
                 seed: int = 0):
        self.predict_fn = predict_fn
        self.n_segments = n_segments
        if not 0.0 < p_sample < 1.0:
            raise InvalidInput(
                f"p_sample must be in (0, 1), got {p_sample}")
        self.p_sample = p_sample
        # Image rows are large (a 224x224x3 float64 frame is ~1.2 MB);
        # an unbounded level coalescing would concatenate gigabytes.
        # The shared estimator chunks transport at this budget while
        # keeping one logical estimate per beam level.
        self.max_call_bytes = int(max_call_bytes)
        self.rng = np.random.default_rng(seed)

    def _perturb(self, image: np.ndarray, onehot: np.ndarray,
                 mean_fill: np.ndarray, anchor: Tuple[int, ...],
                 n: int) -> np.ndarray:
        """n images: anchored segments original, the rest dropped to
        the mean fill with probability 1 - p_sample."""
        d = onehot.shape[0]
        keep = self.rng.random((n, d)) < self.p_sample
        keep[:, list(anchor)] = True
        # [n, H, W] pixel keep-mask from segment presence
        pixel_keep = np.einsum("ns,shw->nhw", keep.astype(np.float64),
                               onehot.astype(np.float64)) > 0
        return np.where(pixel_keep[..., None], image[None],
                        mean_fill[None])

    async def explain(self, image: Any, threshold: float = 0.95,
                      batch_size: int = 24, beam_size: int = 2,
                      max_anchor_size: Optional[int] = None
                      ) -> Dict[str, Any]:
        image = np.asarray(image, np.float64)
        if image.ndim == 2:
            image = image[..., None]
        if image.ndim != 3:
            raise InvalidInput(
                f"anchor images needs [H, W, C] or [H, W], got shape "
                f"{list(image.shape)}")
        segments = grid_segments(image.shape[:2], self.n_segments)
        seg_ids = np.unique(segments)
        d = len(seg_ids)
        onehot = (segments[None, ...] == seg_ids[:, None, None])
        # Per-segment mean color fill (alibi's default perturbation).
        mean_fill = np.empty_like(image)
        for s in range(d):
            mean_fill[onehot[s]] = image[onehot[s]].mean(axis=0)

        label = int((await call_labels(self.predict_fn,
                                       image[None]))[0])
        row_cap = max(1, self.max_call_bytes // max(1, image.nbytes))

        async def estimate_many(anchors: Sequence[Tuple[int, ...]],
                                n: int) -> Dict[Tuple[int, ...], float]:
            return await estimate_precisions(
                self.predict_fn,
                lambda a, k: self._perturb(image, onehot, mean_fill,
                                           a, k),
                label, anchors, n, max_rows_per_call=row_cap)

        base_prec = (await estimate_many([()], batch_size))[()]
        if base_prec >= threshold:
            return self._result(segments, seg_ids, label, (), base_prec,
                                True)
        anchor, prec, met = await beam_anchor_search(
            d, estimate_many,
            lambda a: float(self.p_sample ** len(a)),
            base_prec, threshold, batch_size, beam_size,
            max_anchor_size or d)
        return self._result(segments, seg_ids, label, anchor, prec, met)

    def _result(self, segments, seg_ids, label, anchor, precision,
                met) -> Dict[str, Any]:
        mask = np.isin(segments, seg_ids[list(anchor)]) if anchor \
            else np.zeros_like(segments, bool)
        return {
            # alibi's Explanation carries the anchor as image mask +
            # segment labels; ids keep the payload compact.
            "anchor_segments": [int(seg_ids[j]) for j in anchor],
            "mask": mask.astype(np.int32).tolist(),
            "segments": segments.tolist(),
            "precision": round(float(precision), 4),
            "coverage": round(float(self.p_sample ** len(anchor)), 4),
            "prediction": label,
            "met_threshold": met,
        }


class AnchorImages(PredictorProxyModel):
    """Served anchor-images explainer (`:explain`, predictor proxied —
    the alibiexplainer deployment shape, explainer.py:57-58).

    Artifact layout (`storage_uri`, entirely optional):
        anchor_images.json — {"n_segments": 36, "p_sample": 0.5,
                              "precision_threshold": 0.95,
                              "batch_size": 24, "beam_size": 2,
                              "max_anchor_size": null, "seed": 0}
    """

    def __init__(self, name: str, model_dir: str = "",
                 predictor_host: Optional[str] = None,
                 predict_fn: Optional[Callable] = None):
        super().__init__(name, predictor_host=predictor_host,
                         predict_fn=predict_fn)
        self.model_dir = model_dir
        self.config: Dict[str, Any] = {}
        self.search: Optional[AnchorImageSearch] = None

    def load(self) -> bool:
        _, self.config = self._load_artifact_dir(self.model_dir,
                                                 "anchor_images.json")
        self.search = AnchorImageSearch(
            self._proxied_predict,
            n_segments=int(self.config.get("n_segments", 36)),
            p_sample=float(self.config.get("p_sample", 0.5)),
            max_call_bytes=int(self.config.get("max_call_bytes",
                                               64 << 20)),
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
            raise InvalidInput("anchor images needs one instance")
        max_size = self.config.get("max_anchor_size")
        explanation = await self.search.explain(
            np.asarray(instances[0], np.float64),
            threshold=float(self.config.get("precision_threshold",
                                            0.95)),
            batch_size=int(self.config.get("batch_size", 24)),
            beam_size=int(self.config.get("beam_size", 2)),
            max_anchor_size=None if max_size is None else int(max_size))
        return {
            "meta": {"name": "AnchorImages"},
            "data": explanation,
        }
