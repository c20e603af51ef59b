"""The port's native tree-ensemble and PMML evaluators against the JAX
package's (``kfserving_tpu_torch.predictors.{trees,pmml_eval}`` vs
``kfserving_tpu.predictors.{trees,pmml_eval}``), on the CPU.

The inputs are ``tests/test_trees.py``'s hand-written artifacts, the
sklearn-generated fixtures under ``tests/fixtures/trees``, and seeded
random ensembles at the sizes the chip run serves (100 trees of depth 6,
and 100 trees of 31 leaves, over 28 features) written by
``chip_smoke.py``'s generators.  Rows carry NaNs.  Outputs must be equal
bit for bit; a refused artifact must raise the same class with the same
message in both packages.
"""

import json
import os

import numpy as np
import pytest
from test_trees import _LGB_TEXT, _PMML_REG, _PMML_TREE, FIXDIR, _xgb_model

import chip_smoke
from kfserving_tpu.predictors import pmml_eval as jax_pmml_eval
from kfserving_tpu.predictors import trees as jax_trees
from kfserving_tpu_torch.predictors import pmml_eval, trees

PACKAGES = {"jax": (jax_trees, jax_pmml_eval), "torch": (trees, pmml_eval)}


def _stump(v):
    return {"split_indices": [0], "split_conditions": [v],
            "left_children": [-1], "right_children": [-1],
            "default_left": [0], "base_weights": [0.0]}


def _fixture(name):
    with open(os.path.join(FIXDIR, name)) as f:
        return f.read()


def _random_xgb(objective):
    return chip_smoke.xgb_ensemble(np.random.default_rng(3),
                                   objective=objective)


XGB_MODELS = {
    "binary_logistic": lambda: _xgb_model(),
    "squarederror": lambda: _xgb_model(objective="reg:squarederror",
                                       base_score="0.25"),
    "softprob": lambda: _xgb_model(
        objective="multi:softprob", base_score="0.0", num_class="3",
        trees=[_stump(0.2), _stump(0.5), _stump(-0.1)],
        tree_info=[0, 1, 2]),
    "softmax": lambda: _xgb_model(
        objective="multi:softmax", base_score="0.0", num_class="3",
        trees=[_stump(0.2), _stump(0.5), _stump(-0.1)],
        tree_info=[0, 1, 2]),
    "fixture_reg": lambda: json.loads(_fixture("xgb_reg.json")),
    "fixture_binary": lambda: json.loads(_fixture("xgb_binary.json")),
    "fixture_multi": lambda: json.loads(_fixture("xgb_multi.json")),
    "random_binary": lambda: _random_xgb("binary:logistic"),
    "random_reg_logistic": lambda: _random_xgb("reg:logistic"),
    "random_ndcg": lambda: _random_xgb("rank:ndcg"),
}

LGB_TEXTS = {
    "binary": lambda: _LGB_TEXT,
    "stump": lambda: _LGB_TEXT.replace(
        "objective=binary sigmoid:1", "objective=regression").replace(
        "end of trees", "Tree=1\nnum_leaves=1\nnum_cat=0\n"
        "leaf_value=2.5\n\nend of trees", 1),
    "fixture_reg": lambda: _fixture("lgb_reg.txt"),
    "fixture_multi": lambda: _fixture("lgb_multi.txt"),
    "random_binary": lambda: chip_smoke.lgb_ensemble_text(
        np.random.default_rng(4)),
    "random_multiclass": lambda: chip_smoke.lgb_ensemble_text(
        np.random.default_rng(5), trees=30,
        objective="multiclass num_class:3"),
}

PMML_DOCS = {
    "tree": lambda: _PMML_TREE,
    "regression": lambda: _PMML_REG,
    "fixture_tree": lambda: _fixture("pmml_tree.xml"),
    "random_tree": lambda: chip_smoke.pmml_tree_xml(
        np.random.default_rng(6)),
    "softmax": lambda: _PMML_REG.replace(
        '<RegressionModel functionName="regression">',
        '<RegressionModel functionName="classification" '
        'normalizationMethod="softmax">').replace(
        '<RegressionTable intercept="1.5">',
        '<RegressionTable intercept="1.5" targetCategory="p">').replace(
        "</RegressionTable>", "</RegressionTable><RegressionTable "
        'intercept="-0.5" targetCategory="q"><NumericPredictor name="x0" '
        'coefficient="0.25"/></RegressionTable>', 1),
}


def _rows(n_features, n=257, nan_share=0.1, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, n_features)) * 2.0
    x[rng.random(x.shape) < nan_share] = np.nan
    return x


def _width(kind, text):
    """The feature count an artifact reads."""
    if kind == "xgb":
        return int(text["learner"]["learner_model_param"]["num_feature"])
    for line in text.splitlines():
        if line.startswith("max_feature_idx="):
            return int(line.split("=")[1]) + 1
    return 2


@pytest.mark.parametrize("case", sorted(XGB_MODELS))
def test_xgboost_ensemble_equals_jax(case):
    model = XGB_MODELS[case]()
    x = _rows(_width("xgb", model))
    out = {}
    for pkg, (tr, _) in PACKAGES.items():
        ens = tr.XGBoostEnsemble.from_dict(model)
        out[pkg] = (ens.predict(x), ens.predict(x, output_margin=True),
                    ens.margin(x))
    for got, want in zip(out["torch"], out["jax"]):
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("case", sorted(LGB_TEXTS))
def test_lightgbm_ensemble_equals_jax(case):
    text = LGB_TEXTS[case]()
    x = _rows(_width("lgb", text), seed=1)
    out = {}
    for pkg, (tr, _) in PACKAGES.items():
        ens = tr.LightGBMEnsemble.from_text(text)
        out[pkg] = (ens.predict(x), ens.predict(x, raw_score=True))
    for got, want in zip(out["torch"], out["jax"]):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_the_random_ensembles_have_the_served_shape():
    """100 trees of depth 6 over 28 features (XGBoost's defaults, HIGGS's
    width) and 100 trees of 31 leaves (LightGBM's default); the NaN rows
    take both default branches."""
    xgb = trees.XGBoostEnsemble.from_dict(XGB_MODELS["random_binary"]())
    assert len(xgb.trees) == 100
    assert {int(t.is_leaf.sum()) for t in xgb.trees} == {64}
    assert {bool(d) for t in xgb.trees for d in t.default_left} == \
        {True, False}
    lgb = trees.LightGBMEnsemble.from_text(LGB_TEXTS["random_binary"]())
    assert len(lgb.trees) == 100
    assert {int(t.is_leaf.sum()) for t in lgb.trees} == {31}
    assert lgb.trees[0].feature.max() < 28


@pytest.mark.parametrize("case", sorted(PMML_DOCS))
def test_native_pmml_equals_jax(case, tmp_path):
    path = tmp_path / "model.pmml"
    path.write_text(PMML_DOCS[case]())
    out = {}
    for pkg, (_, pm) in PACKAGES.items():
        model = pm.PMMLModel(str(path))
        x = np.nan_to_num(_rows(len(model.fields), seed=2))
        out[pkg] = (model.fields, model.target, model.predict(x))
    assert out["torch"] == out["jax"]


REFUSED = {
    "gblinear": ("xgb", lambda: _set_booster(_xgb_model(), "gblinear")),
    "dart": ("xgb", lambda: _set_booster(_xgb_model(), "dart")),
    "poisson": ("xgb", lambda: _xgb_model(objective="count:poisson",
                                          base_score="1.0")),
    "lgb_categorical": ("lgb", lambda: _LGB_TEXT.replace(
        "decision_type=2 2", "decision_type=1 2")),
    "lgb_zero_as_missing": ("lgb", lambda: _LGB_TEXT.replace(
        "decision_type=2 2", "decision_type=6 2")),
    "pmml_normalization": ("pmml", lambda: _PMML_REG.replace(
        '<RegressionModel functionName="regression">',
        '<RegressionModel functionName="classification" '
        'normalizationMethod="simplemax">')),
    "pmml_model_kind": ("pmml", lambda: _PMML_REG.replace(
        "RegressionModel", "NeuralNetwork")),
    "pmml_operator": ("pmml", lambda: _PMML_TREE.replace(
        'operator="lessThan"', 'operator="isIn"')),
    "pmml_unknown_field": ("pmml", lambda: _PMML_TREE.replace(
        'field="f1"', 'field="nope"')),
    "pmml_no_dictionary": ("pmml", lambda: _PMML_REG.replace(
        "DataDictionary", "Other")),
}


def _set_booster(model, name):
    model["learner"]["gradient_booster"]["name"] = name
    return model


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused_artifacts_raise_as_jax(case, tmp_path):
    kind, build = REFUSED[case]
    path = tmp_path / "model.pmml"
    raised = {}
    for pkg, (tr, pm) in PACKAGES.items():
        artifact = build()
        try:
            if kind == "xgb":
                tr.XGBoostEnsemble.from_dict(artifact)
            elif kind == "lgb":
                tr.LightGBMEnsemble.from_text(artifact)
            else:
                path.write_text(artifact)
                pm.PMMLModel(str(path))
        except Exception as e:  # compared across the packages
            raised[pkg] = (type(e).__name__, str(e))
    assert "jax" in raised and raised["torch"] == raised["jax"]


def test_port_modules_import_no_jax_module():
    """The evaluators are the port's own copies."""
    for module in (trees, pmml_eval):
        assert module.__name__.startswith("kfserving_tpu_torch.")
        assert module.np is np
        assert not any(getattr(v, "__module__", "").startswith(
            "kfserving_tpu.") for v in vars(module).values())
