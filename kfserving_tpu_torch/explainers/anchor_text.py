"""Native anchor-text explainer: high-precision token sets.

Port of ``kfserving_tpu/explainers/anchor_text.py``: numpy only, with the same
seeds, predictor batching and transport chunking.

The reference serves alibi's AnchorText behind `:explain` (reference
python/alibiexplainer/alibiexplainer/anchor_text.py:28-61 — loads a
spacy language model, argmax-adapts probability predictors, explains
inputs[0]; dispatch explainer.py:59-60).  This is a first-party
implementation of the same artifact with no spacy dependency: the
smallest set of tokens whose presence alone keeps the classifier's
prediction.

Anchor semantics (Ribeiro 2018 §2, text instantiation; alibi's
use_unk=True default path, which needs no synonym embeddings):
- tokenization is whitespace splitting (the reference needs spacy only
  for its similarity-sampling mode; UNK-mode perturbation is
  tokenizer-agnostic);
- a perturbation keeps each non-anchored token with probability
  p_sample and replaces dropped tokens with a mask token ("UNK");
- precision(A) = P[f(perturbed) == f(x)], coverage(A) = p_sample^|A|
  (exact under the sampling distribution).

The beam search with coalesced per-level predictor calls is the shared
`anchors.beam_anchor_search`; every level's perturbed sentences ride
ONE predict round trip.
"""

import logging
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from kfserving_tpu_torch.explainers.anchors import (
    beam_anchor_search,
    call_labels,
    estimate_precisions,
)
from kfserving_tpu_torch.explainers.proxy import PredictorProxyModel
from kfserving_tpu_torch.protocol import v1
from kfserving_tpu_torch.protocol.errors import InvalidInput

logger = logging.getLogger("kfserving_tpu_torch.explainers.anchor_text")


class AnchorTextSearch:
    """Beam search for the smallest high-precision token anchor.

    predict_fn: (sync or async) list of n strings -> labels [n] (or
        probabilities [n, k], argmax'd — the reference argmax-wraps the
        same two cases, anchor_text.py:53-58).
    """

    def __init__(self, predict_fn: Callable,
                 unk_token: str = "UNK",
                 p_sample: float = 0.5,
                 max_call_bytes: int = 8 << 20,
                 seed: int = 0):
        self.predict_fn = predict_fn
        self.unk_token = unk_token
        if not 0.0 < p_sample < 1.0:
            raise InvalidInput(
                f"p_sample must be in (0, 1), got {p_sample}")
        self.p_sample = p_sample
        # Long documents inflate fast: d candidates x batch_size
        # doc-sized sentences in one JSON POST can pass the server's
        # 100 MB body cap (http.py MAX_BODY_BYTES).  The shared
        # estimator chunks transport at this budget while keeping one
        # logical estimate per beam level.
        self.max_call_bytes = int(max_call_bytes)
        self.rng = np.random.default_rng(seed)

    async def _labels(self, batch: List[str]) -> np.ndarray:
        return await call_labels(self.predict_fn, batch)

    def _perturb(self, tokens: List[str], anchor: Tuple[int, ...],
                 n: int) -> List[str]:
        d = len(tokens)
        keep = self.rng.random((n, d)) < self.p_sample
        if anchor:
            keep[:, list(anchor)] = True
        toks = np.array(tokens, dtype=object)
        unk = np.array([self.unk_token] * d, dtype=object)
        return [" ".join(np.where(keep[i], toks, unk).tolist())
                for i in range(n)]

    async def explain(self, text: str, threshold: float = 0.95,
                      batch_size: int = 64, beam_size: int = 2,
                      max_anchor_size: Optional[int] = None
                      ) -> Dict[str, Any]:
        if not isinstance(text, str) or not text.strip():
            raise InvalidInput("anchor text needs a non-empty string")
        tokens = text.split()
        d = len(tokens)
        label = int((await self._labels([text]))[0])
        # A perturbed row is at most the document plus UNK growth per
        # token; JSON escaping adds a little more.
        row_bytes = len(text.encode()) \
            + d * (len(self.unk_token) + 4) + 16
        row_cap = max(1, self.max_call_bytes // row_bytes)

        async def estimate_many(anchors: Sequence[Tuple[int, ...]],
                                n: int) -> Dict[Tuple[int, ...], float]:
            return await estimate_precisions(
                self.predict_fn,
                lambda a, k: self._perturb(tokens, a, k),
                label, anchors, n, max_rows_per_call=row_cap)

        base_prec = (await estimate_many([()], batch_size))[()]
        if base_prec >= threshold:
            return self._result(tokens, label, (), base_prec, True)
        anchor, prec, met = await beam_anchor_search(
            d, estimate_many,
            lambda a: float(self.p_sample ** len(a)),
            base_prec, threshold, batch_size, beam_size,
            max_anchor_size or d)
        return self._result(tokens, label, anchor, prec, met)

    def _result(self, tokens, label, anchor, precision,
                met) -> Dict[str, Any]:
        return {
            # alibi's text Explanation carries the anchor words; the
            # positions disambiguate repeated words.
            "anchor": [tokens[j] for j in anchor],
            "positions": list(anchor),
            "precision": round(float(precision), 4),
            "coverage": round(float(self.p_sample ** len(anchor)), 4),
            "prediction": label,
            "met_threshold": met,
        }


class AnchorText(PredictorProxyModel):
    """Served anchor-text explainer (`:explain`, predictor proxied —
    the alibiexplainer deployment shape, explainer.py:59-60).

    Artifact layout (`storage_uri`, entirely optional):
        anchor_text.json — {"unk_token": "UNK", "p_sample": 0.5,
                            "precision_threshold": 0.95,
                            "batch_size": 64, "beam_size": 2,
                            "max_anchor_size": null, "seed": 0}
    """

    def __init__(self, name: str, model_dir: str = "",
                 predictor_host: Optional[str] = None,
                 predict_fn: Optional[Callable] = None):
        super().__init__(name, predictor_host=predictor_host,
                         predict_fn=predict_fn)
        self.model_dir = model_dir
        self.config: Dict[str, Any] = {}
        self.search: Optional[AnchorTextSearch] = None

    def load(self) -> bool:
        _, self.config = self._load_artifact_dir(self.model_dir,
                                                 "anchor_text.json")
        self.search = AnchorTextSearch(
            self._predict_strings,
            unk_token=str(self.config.get("unk_token", "UNK")),
            p_sample=float(self.config.get("p_sample", 0.5)),
            max_call_bytes=int(self.config.get("max_call_bytes",
                                               8 << 20)),
            seed=int(self.config.get("seed", 0)))
        self.ready = True
        return True

    async def _predict_strings(self, batch: List[str]):
        # Text payloads stay a plain JSON list (the V2 binary fast hop
        # is numeric-only; _dense_instances already rejects U/object
        # dtypes, so pass the list through unchanged).
        return await self._proxied_predict(batch)

    async def explain(self, request: Any) -> Any:
        if self.search is None:
            raise InvalidInput(f"explainer {self.name} not loaded")
        instances = v1.get_instances(request)
        if len(instances) == 0:
            raise InvalidInput("anchor text needs one instance")
        text = instances[0]
        if isinstance(text, (list, tuple)):
            # Some clients pre-tokenize; the reference's contract is
            # inputs[0] = the document (anchor_text.py:51).
            text = " ".join(str(t) for t in text)
        explanation = await self.search.explain(
            str(text),
            threshold=float(self.config.get("precision_threshold",
                                            0.95)),
            batch_size=int(self.config.get("batch_size", 64)),
            beam_size=int(self.config.get("beam_size", 2)),
            max_anchor_size=(None if self.config.get("max_anchor_size")
                             is None
                             else int(self.config["max_anchor_size"])))
        return {
            "meta": {"name": "AnchorText"},
            "data": explanation,
        }
