"""Native PMML evaluator: TreeModel and RegressionModel, stdlib XML.

Port of ``kfserving_tpu/predictors/pmml_eval.py``, unchanged in
behaviour.  The pmml server evaluates with pypmml (a JVM bridge) when it
imports; without it, this parses the two model kinds the common examples
use (decision trees, regressions) and evaluates them row by row on the
host.

Supported: SimplePredicate (all six operators), CompoundPredicate
(and/or), True/False predicates, nested Nodes with scores,
ScoreDistribution probabilities, RegressionTable with NumericPredictors.
Missing features raise at load, not silently at predict.
"""

import xml.etree.ElementTree as ET
from typing import Any, Dict, List, Optional

import numpy as np


def _local(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def _children(el, name: str):
    return [c for c in el if _local(c.tag) == name]


_OPS = {
    "equal": lambda x, v: x == v,
    "notEqual": lambda x, v: x != v,
    "lessThan": lambda x, v: x < v,
    "lessOrEqual": lambda x, v: x <= v,
    "greaterThan": lambda x, v: x > v,
    "greaterOrEqual": lambda x, v: x >= v,
}


class _Predicate:
    def __init__(self, el, field_index: Dict[str, int]):
        self.kind = _local(el.tag)
        if self.kind == "SimplePredicate":
            field = el.get("field")
            if field not in field_index:
                raise ValueError(f"predicate references unknown field "
                                 f"{field!r}")
            self.col = field_index[field]
            op = el.get("operator")
            if op not in _OPS:
                raise ValueError(f"unsupported operator {op!r}")
            self.op = _OPS[op]
            self.value = float(el.get("value"))
        elif self.kind == "CompoundPredicate":
            self.bool_op = el.get("booleanOperator")
            if self.bool_op not in ("and", "or"):
                raise ValueError(
                    f"unsupported booleanOperator {self.bool_op!r}")
            self.parts = [_Predicate(c, field_index) for c in el
                          if _local(c.tag).endswith("Predicate")
                          or _local(c.tag) in ("True", "False")]
        elif self.kind not in ("True", "False"):
            raise ValueError(f"unsupported predicate {self.kind!r}")

    def test(self, row: np.ndarray) -> bool:
        if self.kind == "True":
            return True
        if self.kind == "False":
            return False
        if self.kind == "SimplePredicate":
            return bool(self.op(row[self.col], self.value))
        results = (p.test(row) for p in self.parts)
        return all(results) if self.bool_op == "and" else any(results)


class _Node:
    def __init__(self, el, field_index: Dict[str, int]):
        self.score: Optional[str] = el.get("score")
        pred_el = next(
            (c for c in el if _local(c.tag) in
             ("SimplePredicate", "CompoundPredicate", "True", "False")),
            None)
        # A root node without a predicate is implicitly True.
        self.predicate = (_Predicate(pred_el, field_index)
                          if pred_el is not None else None)
        self.children = [_Node(c, field_index) for c in _children(el, "Node")]
        self.distribution = {
            c.get("value"): float(c.get("recordCount"))
            for c in _children(el, "ScoreDistribution")
        }

    def evaluate(self, row: np.ndarray):
        for child in self.children:
            if child.predicate is None or child.predicate.test(row):
                return child.evaluate(row)
        return self


class PMMLModel:
    """A parsed PMML TreeModel or RegressionModel."""

    def __init__(self, path: str):
        root = ET.parse(path).getroot()
        dd = next(iter(_children(root, "DataDictionary")), None)
        if dd is None:
            raise ValueError("PMML file missing DataDictionary")
        self.fields: List[str] = []
        self.target: Optional[str] = None
        model_el = None
        for kind in ("TreeModel", "RegressionModel"):
            found = _children(root, kind)
            if found:
                model_el = found[0]
                self.kind = kind
                break
        else:
            kinds = sorted({_local(c.tag) for c in root})
            raise ValueError(
                f"no supported model in PMML (found {kinds}; native "
                f"evaluator handles TreeModel/RegressionModel — install "
                f"pypmml for others)")
        # Active fields in MiningSchema order define the input columns
        # (the reference passes a positional row list, model.py).
        schema = next(iter(_children(model_el, "MiningSchema")))
        for mf in _children(schema, "MiningField"):
            if mf.get("usageType") in ("target", "predicted"):
                self.target = mf.get("name")
            else:
                self.fields.append(mf.get("name"))
        index = {f: i for i, f in enumerate(self.fields)}
        self.function = model_el.get("functionName", "classification")

        if self.kind == "TreeModel":
            self.root = _Node(
                next(iter(_children(model_el, "Node"))), index)
        else:
            self.normalization = model_el.get(
                "normalizationMethod", "none")
            if self.normalization not in ("none", "softmax", "logit"):
                raise ValueError(
                    f"unsupported normalizationMethod "
                    f"{self.normalization!r} (native evaluator handles "
                    f"none/softmax/logit — install pypmml for others)")
            table_els = _children(model_el, "RegressionTable")
            self.tables = []
            for t in table_els:
                coeffs = np.zeros(len(self.fields))
                for p in _children(t, "NumericPredictor"):
                    coeffs[index[p.get("name")]] = float(
                        p.get("coefficient"))
                self.tables.append((t.get("targetCategory"),
                                    float(t.get("intercept", 0.0)),
                                    coeffs))

    def predict_row(self, row: np.ndarray) -> Dict[str, Any]:
        """One row -> output dict (mirrors pypmml's predict().values()
        shape: predicted value first, then class probabilities)."""
        if self.kind == "TreeModel":
            leaf = self.root.evaluate(row)
            out: Dict[str, Any] = {"predicted": leaf.score}
            total = sum(leaf.distribution.values())
            if total > 0:
                for cls, count in leaf.distribution.items():
                    out[f"probability_{cls}"] = count / total
            return out
        scores = [(cat, intercept + float(row @ coeffs))
                  for cat, intercept, coeffs in self.tables]
        if self.function == "regression" or len(scores) == 1:
            return {"predicted": scores[0][1]}
        z = np.array([s for _, s in scores])
        if self.normalization == "softmax":
            p = np.exp(z - z.max())
            p /= p.sum()
        elif self.normalization == "logit" and len(scores) == 2:
            p1 = 1.0 / (1.0 + np.exp(-z[0]))
            p = np.array([p1, 1.0 - p1])
        else:  # "none": raw scores rank categories, no probabilities
            p = None
        best = int(np.argmax(z if p is None else p))
        out = {"predicted": scores[best][0]}
        if p is not None:
            for (cat, _), prob in zip(scores, p):
                out[f"probability_{cat}"] = float(prob)
        return out

    def predict(self, X: np.ndarray) -> List[Dict[str, Any]]:
        X = np.asarray(X, np.float64)
        return [self.predict_row(row) for row in X]
