"""Explainers of the port: the explainer component of the data plane,
served at ``/v1/models/<m>:explain`` and ``/v2/models/<m>/explain``.

Port of ``kfserving_tpu/explainers/__init__.py``.  The device-side
explainer is gradient saliency, computed by autograd on the card next to
the served model (no black-box perturbation loop over HTTP).  The
black-box explainers (anchors for tables, images and text, LIME images,
the square attack, fairness metrics) are numpy and score their
perturbations against ``predictor_host`` over the proxy hop.
"""

from typing import Any, Optional

from kfserving_tpu_torch.explainers.adversarial import (  # noqa: F401
    AdversarialRobustness,
    SquareAttack,
)
from kfserving_tpu_torch.explainers.anchor_images import (  # noqa: F401
    AnchorImages,
    AnchorImageSearch,
)
from kfserving_tpu_torch.explainers.anchor_text import (  # noqa: F401
    AnchorText,
    AnchorTextSearch,
)
from kfserving_tpu_torch.explainers.anchors import (  # noqa: F401
    AnchorSearch,
    AnchorTabular,
)
from kfserving_tpu_torch.explainers.fairness import (  # noqa: F401
    FairnessExplainer,
)
from kfserving_tpu_torch.explainers.lime import (  # noqa: F401
    LimeImages,
    LimeImageSearch,
)
from kfserving_tpu_torch.explainers.saliency import (  # noqa: F401
    BlackBoxExplainer,
    SaliencyExplainer,
)

# One dispatch table for every deployment shape (the standalone
# explainer server and in-process builders resolve types here).
EXPLAINER_TYPES = ("saliency", "anchor_tabular", "anchor_images",
                   "anchor_text", "lime_images", "square_attack",
                   "fairness")
# Types whose load() fails without an artifact dir (saliency serves a
# model, anchors needs train.npy, fairness its group config).
ARTIFACT_REQUIRED_TYPES = ("saliency", "anchor_tabular", "fairness")


def build_explainer(name: str, explainer_type: str,
                    storage_uri: str = "",
                    predictor_host: Optional[str] = None,
                    device: Any = "cuda"):
    """Instantiate an in-tree explainer by type name.  ``device`` is the
    saliency explainer's (the card unless the caller asks for the
    CPU); the others run on the host."""
    if explainer_type == "fairness":
        # The group definitions live in the artifact dir, like every
        # other explainer config.
        import json
        import os

        from kfserving_tpu_torch.storage import Storage

        if not storage_uri:
            raise ValueError(
                "fairness explainer needs a storage_uri containing "
                "fairness.json (feature_names + group definitions)")
        local = Storage.download(storage_uri)
        with open(os.path.join(local, "fairness.json")) as f:
            cfg = json.load(f)
        return FairnessExplainer(
            name,
            feature_names=cfg["feature_names"],
            privileged_groups=cfg["privileged_groups"],
            unprivileged_groups=cfg["unprivileged_groups"],
            favorable_label=cfg.get("favorable_label", 1.0),
            unfavorable_label=cfg.get("unfavorable_label", 0.0),
            n_neighbors=int(cfg.get("n_neighbors", 5)),
            predictor_host=predictor_host)
    if explainer_type == "anchor_tabular":
        return AnchorTabular(name, storage_uri,
                             predictor_host=predictor_host)
    if explainer_type == "anchor_images":
        return AnchorImages(name, storage_uri,
                            predictor_host=predictor_host)
    if explainer_type == "anchor_text":
        return AnchorText(name, storage_uri,
                          predictor_host=predictor_host)
    if explainer_type == "lime_images":
        return LimeImages(name, storage_uri,
                          predictor_host=predictor_host)
    if explainer_type == "square_attack":
        return AdversarialRobustness(name, storage_uri,
                                     predictor_host=predictor_host)
    if explainer_type == "saliency":
        model = SaliencyExplainer(name, storage_uri, device=device)
        if predictor_host:
            model.predictor_host = predictor_host
        return model
    raise ValueError(
        f"unknown explainer_type {explainer_type!r} "
        f"(one of {list(EXPLAINER_TYPES)}, or set an explicit command)")
