"""Native tree-ensemble evaluators: xgboost-JSON and LightGBM-text.

Port of ``kfserving_tpu/predictors/trees.py``, unchanged in behaviour.
The xgboost and lightgbm servers load their models with the framework
library when it imports; without it they evaluate the public, documented
artifact formats here with numpy, on the host, as the JAX package does.

Formats:
- xgboost >= 1.7 JSON (`booster.save_model("model.json")`): trees as
  parallel arrays `split_indices / split_conditions / left_children /
  right_children / default_left`; a node is a leaf when left_children[i]
  == -1, and `split_conditions` then holds the leaf value.  `tree_info`
  maps each tree to its output group (class).  base_score is stored in
  output space; it enters the margin through the objective's inverse
  link.
- LightGBM text (`booster.save_model("model.txt")`): per-tree blocks
  `split_feature / threshold / decision_type / left_child / right_child
  / leaf_value`; negative child ids are ~leaf references; tree k of a
  num_class=K model scores class k % K.

Both evaluators batch over rows: every tree is walked with vectorized
gathers (max tree depth iterations, no Python per-row loop).
"""

import json
import math
from typing import Any, Dict, List, Optional

import numpy as np


def _sigmoid(z: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-z))


def _softmax(z: np.ndarray) -> np.ndarray:
    z = z - z.max(axis=-1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=-1, keepdims=True)


class _Tree:
    """One decision tree as parallel arrays (gather-walk evaluation)."""

    __slots__ = ("feature", "threshold", "left", "right", "default_left",
                 "is_leaf", "value")

    def __init__(self, feature, threshold, left, right, default_left,
                 is_leaf, value):
        self.feature = np.asarray(feature, np.int32)
        self.threshold = np.asarray(threshold, np.float64)
        self.left = np.asarray(left, np.int32)
        self.right = np.asarray(right, np.int32)
        self.default_left = np.asarray(default_left, bool)
        self.is_leaf = np.asarray(is_leaf, bool)
        self.value = np.asarray(value, np.float64)

    def predict(self, X: np.ndarray) -> np.ndarray:
        """Vectorized walk: all rows descend together, one gather per
        level, until every row sits on a leaf."""
        n = X.shape[0]
        node = np.zeros(n, np.int32)
        active = ~self.is_leaf[node]
        while active.any():
            idx = node[active]
            feat = self.feature[idx]
            x = X[active, feat]
            missing = np.isnan(x)
            go_left = np.where(missing, self.default_left[idx],
                               x < self.threshold[idx])
            node[active] = np.where(go_left, self.left[idx],
                                    self.right[idx])
            active = ~self.is_leaf[node]
        return self.value[node]


class XGBoostEnsemble:
    """Evaluate an xgboost JSON model (cites reference xgbserver
    model.py:predict for the serving contract it replaces)."""

    def __init__(self, trees: List[_Tree], tree_groups: List[int],
                 num_class: int, base_score: float, objective: str):
        self.trees = trees
        self.tree_groups = tree_groups
        self.num_class = max(1, num_class)
        self.objective = objective
        # base_score is recorded in output space; margins accumulate in
        # link space, so invert the link once here.
        if objective.startswith(("binary:logistic", "reg:logistic")):
            base_score = min(max(base_score, 1e-7), 1 - 1e-7)
            self.base_margin = math.log(base_score / (1 - base_score))
        else:
            self.base_margin = base_score

    @classmethod
    def from_file(cls, path: str) -> "XGBoostEnsemble":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    # Objectives whose output transform the evaluator implements.  Ranker
    # and squared-error objectives are identity in margin space; anything
    # with another inverse link (poisson/gamma/tweedie exp, etc.) must
    # raise at load rather than silently return link-space numbers.
    SUPPORTED_OBJECTIVES = (
        "binary:logistic", "reg:logistic", "multi:softprob",
        "multi:softmax", "reg:squarederror", "reg:squaredlogerror",
        "reg:linear", "reg:absoluteerror", "reg:pseudohubererror",
        "rank:pairwise", "rank:ndcg", "rank:map",
    )

    @classmethod
    def from_dict(cls, model: Dict[str, Any]) -> "XGBoostEnsemble":
        learner = model["learner"]
        booster = learner["gradient_booster"]
        if booster.get("name") not in (None, "gbtree"):
            # dart's JSON nests trees differently and needs weight_drop
            # scaling — reject rather than misparse.
            raise ValueError(
                f"unsupported booster {booster.get('name')!r} "
                f"(native evaluator handles gbtree)")
        objective = learner.get("objective", {}).get("name", "")
        if objective and objective not in cls.SUPPORTED_OBJECTIVES:
            raise ValueError(
                f"unsupported objective {objective!r}; native evaluator "
                f"handles {list(cls.SUPPORTED_OBJECTIVES)} — install "
                f"xgboost for others")
        gmodel = booster["model"]
        trees = []
        for t in gmodel["trees"]:
            left = np.asarray(t["left_children"], np.int32)
            trees.append(_Tree(
                feature=t["split_indices"],
                threshold=t["split_conditions"],
                left=left,
                right=t["right_children"],
                default_left=np.asarray(t["default_left"]) == 1,
                is_leaf=left < 0,
                # split_conditions holds the leaf value at leaf nodes
                value=t["split_conditions"],
            ))
        params = learner["learner_model_param"]
        return cls(
            trees=trees,
            tree_groups=[int(g) for g in gmodel.get(
                "tree_info", [0] * len(trees))],
            num_class=int(params.get("num_class", "0") or 0),
            base_score=float(params.get("base_score", "0.5")),
            objective=objective,
        )

    def margin(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, np.float64)
        out = np.full((X.shape[0], self.num_class), self.base_margin)
        for tree, group in zip(self.trees, self.tree_groups):
            out[:, group] += tree.predict(X)
        return out

    def predict(self, X: np.ndarray, output_margin: bool = False
                ) -> np.ndarray:
        m = self.margin(X)
        if output_margin:
            return m[:, 0] if self.num_class == 1 else m
        if self.objective.startswith(("binary:logistic",)):
            return _sigmoid(m[:, 0])
        if self.objective.startswith("multi:softprob"):
            return _softmax(m)
        if self.objective.startswith("multi:softmax"):
            return np.argmax(m, axis=-1).astype(np.float64)
        return m[:, 0] if self.num_class == 1 else m


class LightGBMEnsemble:
    """Evaluate a LightGBM text model (reference lgbserver model.py)."""

    def __init__(self, trees: List[_Tree], num_class: int, objective: str):
        self.trees = trees
        self.num_class = max(1, num_class)
        self.objective = objective

    @classmethod
    def from_file(cls, path: str) -> "LightGBMEnsemble":
        with open(path) as f:
            return cls.from_text(f.read())

    @classmethod
    def from_text(cls, text: str) -> "LightGBMEnsemble":
        objective = ""
        num_class = 1
        trees: List[_Tree] = []
        block: Dict[str, str] = {}

        def finish_block():
            if "num_leaves" not in block:
                return
            num_leaves = int(block["num_leaves"])
            leaf_value = [float(v) for v in block["leaf_value"].split()]
            if num_leaves == 1:
                # Stump: a single leaf, no splits.
                trees.append(_Tree([0], [0.0], [-1], [-1], [True], [True],
                                   [leaf_value[0]]))
                return
            feat = [int(v) for v in block["split_feature"].split()]
            # LightGBM numerical splits are `x <= threshold -> left`;
            # _Tree tests `x < threshold` (xgboost semantics), so nudge
            # each threshold up one ULP at parse time.
            thresh = [float(np.nextafter(float(v), np.inf))
                      for v in block["threshold"].split()]
            lc = [int(v) for v in block["left_child"].split()]
            rc = [int(v) for v in block["right_child"].split()]
            dt = [int(v) for v in block.get(
                "decision_type", " ".join(["2"] * len(feat))).split()]
            if any(d & 1 for d in dt):
                # Bit 0 = categorical split: thresholds are
                # cat_boundaries indices, not comparable values.
                raise ValueError(
                    "model uses categorical splits; the native "
                    "evaluator handles numerical splits only — install "
                    "lightgbm for categorical models")
            if any((d >> 2) & 3 == 1 for d in dt):
                # Bits 2-3 = missing_type (0 None, 1 Zero, 2 NaN).  The
                # walk routes only NaN through the default branch; a
                # zero_as_missing model needs zeros routed there too —
                # reject at load rather than silently diverge from
                # lightgbm's output.
                raise ValueError(
                    "model uses zero-as-missing splits "
                    "(missing_type=Zero); the native evaluator routes "
                    "only NaN as missing — install lightgbm for this "
                    "model")
            n_internal = len(feat)
            # Flatten internal nodes then leaves into one array; child id
            # c >= 0 is internal node c, c < 0 is leaf ~c (= -(c)-1).
            def child(c):
                return c if c >= 0 else n_internal + (~c)
            value = [0.0] * n_internal + leaf_value
            trees.append(_Tree(
                feature=feat + [0] * num_leaves,
                threshold=thresh + [0.0] * num_leaves,
                left=[child(c) for c in lc] + [0] * num_leaves,
                right=[child(c) for c in rc] + [0] * num_leaves,
                # bit 2 of decision_type = default left
                default_left=[bool(d & 2) for d in dt] +
                             [False] * num_leaves,
                is_leaf=[False] * n_internal + [True] * num_leaves,
                value=value,
            ))

        for raw in text.splitlines():
            line = raw.strip()
            if line.startswith("Tree="):
                finish_block()
                block = {}
            elif line.startswith("end of trees"):
                finish_block()
                block = {}
            elif "=" in line:
                k, v = line.split("=", 1)
                block[k] = v
                if k == "objective":
                    objective = v
                    for part in v.split():
                        if part.startswith("num_class:"):
                            num_class = int(part.split(":")[1])
        finish_block()
        return cls(trees, num_class, objective)

    def predict(self, X: np.ndarray, raw_score: bool = False) -> np.ndarray:
        X = np.asarray(X, np.float64)
        out = np.zeros((X.shape[0], self.num_class))
        for i, tree in enumerate(self.trees):
            out[:, i % self.num_class] += tree.predict(X)
        if raw_score:
            return out[:, 0] if self.num_class == 1 else out
        if self.objective.startswith("binary"):
            return _sigmoid(out[:, 0])
        if self.objective.startswith(("multiclass", "softmax")):
            return _softmax(out)
        return out[:, 0] if self.num_class == 1 else out
