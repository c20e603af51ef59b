"""Native adversarial-robustness explainer (artexplainer parity).

Port of ``kfserving_tpu/explainers/adversarial.py``: numpy only, with the same
seeds, predictor batching and transport chunking.

The reference serves ART's SquareAttack behind `:explain` (reference
python/artexplainer/artserver/model.py:25-77): a black-box evasion
attack that perturbs random squares of the input until the predictor's
label flips, reporting the adversarial example and its L2 distance as a
robustness certificate.  This is a first-party implementation of the
same decision-based attack (Andriushchenko et al. 2020, "Square
Attack", the p-schedule simplified) with no art dependency:

- label-only feedback, exactly like the reference's BlackBoxClassifier
  wrapper (its _predict one-hots the predicted label,
  artserver/model.py:43-50) — probabilities are used when the
  predictor returns them, improving acceptance from margin descent;
- candidate perturbations are evaluated in predictor BATCHES (one
  call per iteration of candidates), riding the dynamic batcher.

Response contract matches the reference handler: {"explanations":
{"adversarial_example", "L2 error", "adversarial_prediction",
"prediction"}} (artserver/model.py:71-74).
"""

import inspect
import json
import logging
from typing import Any, Callable, Dict, Optional

import numpy as np

from kfserving_tpu_torch.explainers.proxy import PredictorProxyModel
from kfserving_tpu_torch.protocol import v1
from kfserving_tpu_torch.protocol.errors import InvalidInput

logger = logging.getLogger("kfserving_tpu_torch.explainers.adversarial")


class SquareAttack:
    """Decision/score-based square attack on one instance.

    predict_fn: batch [n, ...] -> labels [n] or probabilities [n, k].
    eps: L-inf perturbation budget (in input units).
    """

    def __init__(self, predict_fn: Callable, eps: float = 0.3,
                 max_iter: int = 100, candidates_per_iter: int = 8,
                 p_init: float = 0.3, seed: int = 0,
                 clip_min: Optional[float] = None,
                 clip_max: Optional[float] = None):
        self.predict_fn = predict_fn
        self.eps = eps
        self.max_iter = max_iter
        self.candidates = candidates_per_iter
        self.p_init = p_init
        self.clip_min = clip_min
        self.clip_max = clip_max
        self.rng = np.random.default_rng(seed)
        # One-hot width for label-only predictors: at least the target
        # label + 1 (set by attack()) and monotone over everything
        # observed, so scores[:, label] always exists even when a batch
        # happens not to contain the high classes.
        self._n_classes = 2

    async def _scores(self, batch: np.ndarray) -> np.ndarray:
        """[n, k] scores; label outputs become one-hot (the reference's
        BlackBoxClassifier sees exactly that)."""
        out = self.predict_fn(batch)
        if inspect.isawaitable(out):
            out = await out
        out = np.asarray(out)
        if out.ndim == 1:
            self._n_classes = max(self._n_classes, int(out.max()) + 1)
            return np.eye(self._n_classes)[out.astype(np.int64)]
        return np.asarray(out, np.float64)

    def _margin(self, scores: np.ndarray, label: int) -> np.ndarray:
        """score[label] - best other; < 0 means misclassified."""
        if label >= scores.shape[1]:
            raise InvalidInput(
                f"label {label} out of range for predictor with "
                f"{scores.shape[1]} classes")
        others = scores.copy()
        others[:, label] = -np.inf
        return scores[:, label] - others.max(axis=1)

    def _square(self, shape, p: float):
        """Random square's slice bounds at side = sqrt(p * H * W)."""
        h, w = shape[0], shape[1]
        side = max(1, int(round((p * h * w) ** 0.5)))
        side = min(side, h, w)
        r = int(self.rng.integers(0, h - side + 1))
        c = int(self.rng.integers(0, w - side + 1))
        return slice(r, r + side), slice(c, c + side)

    async def attack(self, x: np.ndarray, label: int) -> Dict[str, Any]:
        x = np.asarray(x, np.float64)
        self._n_classes = max(self._n_classes, label + 1)
        if x.ndim == 1:
            # Tabular rows attack as [1, d] "images".
            work = x[None, :, None]
        elif x.ndim == 2:
            work = x[..., None]
        else:
            work = x
        # Unclipped by default, like the reference's BlackBoxClassifier
        # clip_values=(-inf, inf) (artserver/model.py:65); domains with
        # real bounds set them in art.json.
        clip_min = self.clip_min if self.clip_min is not None \
            else -np.inf
        clip_max = self.clip_max if self.clip_max is not None \
            else np.inf

        base_scores = await self._scores(x[None])
        prediction = int(np.argmax(base_scores[0]))
        best = work.copy()
        best_margin = float(self._margin(base_scores, label)[0])
        queries = 1
        for it in range(self.max_iter):
            if best_margin < 0:
                break  # already adversarial
            # Square side shrinks as the attack progresses (the paper's
            # p-schedule, piecewise-halved: p_init for the first fifth
            # of the budget, p_init/2 for the second, ...).
            p = self.p_init * 2.0 ** (
                -((it * 5) // max(1, self.max_iter)))
            batch = np.stack([best] * self.candidates)
            for b in range(self.candidates):
                rs, cs = self._square(work.shape, p)
                delta = self.rng.choice([-self.eps, self.eps],
                                        size=(1, 1, work.shape[2]))
                batch[b][rs, cs, :] = np.clip(
                    work[rs, cs, :] + delta, clip_min, clip_max)
            scores = await self._scores(
                batch.reshape((self.candidates,) + x.shape))
            queries += 1
            margins = self._margin(scores, label)
            j = int(np.argmin(margins))
            if margins[j] < best_margin:
                best = batch[j]
                best_margin = float(margins[j])
        adv = best.reshape(x.shape)
        adv_scores = await self._scores(adv[None])
        return {
            "adversarial_example": adv.tolist(),
            "L2 error": float(np.linalg.norm((adv - x).ravel())),
            "adversarial_prediction": int(np.argmax(adv_scores[0])),
            "prediction": prediction,
            "success": bool(best_margin < 0),
            "queries": queries,
        }


class AdversarialRobustness(PredictorProxyModel):
    """Served square-attack explainer (`:explain`, predictor proxy —
    the artexplainer deployment shape, artserver/model.py:43-50).

    Artifact layout (`storage_uri`, all optional):
        art.json — {"eps": 0.3, "max_iter": 100, "clip_min": 0.0,
                    "clip_max": 1.0, "candidates_per_iter": 8}
    """

    def __init__(self, name: str, model_dir: str = "",
                 predictor_host: Optional[str] = None,
                 predict_fn: Optional[Callable] = None):
        super().__init__(name, predictor_host=predictor_host,
                         predict_fn=predict_fn)
        self.model_dir = model_dir
        self.config: Dict[str, Any] = {}

    def load(self) -> bool:
        _, self.config = self._load_artifact_dir(self.model_dir,
                                                 "art.json")
        self.ready = True
        return True

    async def explain(self, request: Any) -> Any:
        # Reference contract: instances = [image, label]
        # (artserver/model.py:53-54).
        instances = v1.get_instances(request)
        if len(instances) < 2:
            raise InvalidInput(
                "adversarial explainer needs instances = [input, label]")
        x = np.asarray(instances[0], np.float64)
        label = int(np.asarray(instances[1]).reshape(-1)[0])
        req = request if isinstance(request, dict) else {}
        attack = SquareAttack(
            self._proxied_predict,
            eps=float(req.get("eps", self.config.get("eps", 0.3))),
            max_iter=int(req.get(
                "max_iter", self.config.get("max_iter", 100))),
            candidates_per_iter=int(self.config.get(
                "candidates_per_iter", 8)),
            clip_min=self.config.get("clip_min"),
            clip_max=self.config.get("clip_max"),
            seed=int(self.config.get("seed", 0)))
        return {"explanations": await attack.attack(x, label)}
