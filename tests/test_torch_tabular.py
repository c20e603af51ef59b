"""The port's tabular predictors (``kfserving_tpu_torch.predictors.
{tabular,sklearnserver,xgbserver,lgbserver,pmmlserver}``) against the JAX
package's, on the CPU.

The same artifacts load in both packages: an sklearn iris SVC as joblib
and as pickle, seeded xgboost-JSON and LightGBM-text ensembles and PMML
tree models (``chip_smoke.py``'s generators and ``tests/test_trees.py``'s
tree).  One request set goes to a JAX package ModelServer and to the
port's: V1 JSON, V2 JSON (FP64, FP32 and BF16), V2 binary (FP32 and
BF16), V2 binary with binary outputs, and the bad requests.  Statuses and response bodies must
be equal (binary responses byte for byte); no id is generated on either
side.  Artifact discovery, load errors and ``SKLearnModelRepository`` go
through both packages too.
"""

import asyncio
import json
import os
import pickle

import numpy as np
import pytest
import torch
from test_trees import _PMML_TREE
from torch_serving import arequest, serve

import chip_smoke
from kfserving_tpu.observability import REGISTRY as JAX_REGISTRY
from kfserving_tpu.predictors import lgbserver as jax_lgbserver
from kfserving_tpu.predictors import pmmlserver as jax_pmmlserver
from kfserving_tpu.predictors import sklearnserver as jax_sklearnserver
from kfserving_tpu.predictors import xgbserver as jax_xgbserver
from kfserving_tpu.protocol import v2 as jax_v2
from kfserving_tpu_torch.observability import REGISTRY
from kfserving_tpu_torch.predictors import lgbserver, pmmlserver
from kfserving_tpu_torch.predictors import sklearnserver, xgbserver
from kfserving_tpu_torch.protocol import v2

SERVERS = {
    "jax": {"sklearn": jax_sklearnserver.SKLearnModel,
            "xgb": jax_xgbserver.XGBoostModel,
            "lgb": jax_lgbserver.LightGBMModel,
            "pmml": jax_pmmlserver.PMMLModel},
    "torch": {"sklearn": sklearnserver.SKLearnModel,
              "xgb": xgbserver.XGBoostModel,
              "lgb": lgbserver.LightGBMModel,
              "pmml": pmmlserver.PMMLModel},
}
IRIS_ROWS = [[6.8, 2.8, 4.8, 1.4], [6.0, 3.4, 4.5, 1.6],
             [5.1, 3.5, 1.4, 0.2]]


def _iris_svc():
    from sklearn import datasets, svm

    X, y = datasets.load_iris(return_X_y=True)
    return svm.SVC(gamma="scale").fit(X, y)


def _write_artifacts(root):
    """{model name: (server kind, model dir, rows to send)}."""
    import joblib

    clf = _iris_svc()
    out = {}
    for name, filename in (("iris_joblib", "model.joblib"),
                           ("iris_pickle", "model.pkl")):
        d = os.path.join(root, name)
        os.makedirs(d)
        if filename.endswith(".joblib"):
            joblib.dump(clf, os.path.join(d, filename))
        else:
            with open(os.path.join(d, filename), "wb") as f:
                pickle.dump(clf, f)
        out[name] = ("sklearn", d, np.asarray(IRIS_ROWS))
    trees = chip_smoke.write_tabular_artifacts(os.path.join(root, "gen"))
    rng = np.random.default_rng(9)
    for kind in ("xgb", "lgb", "pmml"):
        rows = rng.normal(size=(5, chip_smoke.TABULAR_FEATURES))
        out[kind] = (kind, trees[kind], rows)
    d = os.path.join(root, "pmml_tree")
    os.makedirs(d)
    with open(os.path.join(d, "model.pmml"), "w") as f:
        f.write(_PMML_TREE)
    out["pmml_tree"] = ("pmml", d, np.array([[0.5, 0.0], [1.5, 3.0]]))
    return out


def _requests(name, rows):
    """[(case, path, body, headers)] for one served model."""
    v1 = f"/v1/models/{name}:predict"
    infer = f"/v2/models/{name}/infer"
    json_headers = {"content-type": "application/json"}
    out = [("v1", v1, {"instances": rows.tolist()}, json_headers),
           ("v1_one_row", v1, {"instances": rows[:1].tolist()},
            json_headers)]
    for dtype, datatype in ((np.float64, "FP64"), (np.float32, "FP32")):
        out.append((f"v2_json_{datatype}", infer, {
            "id": f"req-{datatype}", "inputs": [{
                "name": "input_0", "datatype": datatype,
                "shape": list(rows.shape),
                "data": rows.astype(dtype).ravel().tolist()}]},
            json_headers))
    # BF16: JSON numbers round to bfloat16 in both codecs; the binary
    # body carries the port's torch.bfloat16 bits.
    out.append(("v2_json_BF16", infer, {
        "id": "req-BF16", "inputs": [{
            "name": "input_0", "datatype": "BF16",
            "shape": list(rows.shape), "data": rows.ravel().tolist()}]},
        json_headers))
    binary = {"out0": rows.astype(np.float32),
              "out1": rows.astype(np.float32),
              "bf16": torch.from_numpy(rows).to(torch.bfloat16)}
    for case, tensor in binary.items():
        body, hlen = v2.make_binary_request(
            {"input_0": tensor}, id="bin",
            binary_output=case == "out1")
        out.append((f"v2_binary_{case}", infer, body,
                    {"content-type": "application/octet-stream",
                     "inference-header-content-length": str(hlen)}))
    out += [
        ("bad_not_a_list", v1, {"instances": 5}, json_headers),
        ("bad_width", v1, {"instances": [[1.0]]}, json_headers),
        ("bad_two_tensors", infer, {"inputs": [
            {"name": n, "datatype": "FP32", "shape": [1, 2],
             "data": [1.0, 2.0]} for n in ("a", "b")]}, json_headers),
    ]
    return out


ARTIFACT_NAMES = ("iris_joblib", "iris_pickle", "xgb", "lgb", "pmml",
                  "pmml_tree")


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """{pkg: {(model, case): (status, headers, body)}} from each
    package's ModelServer on the same artifacts and requests."""
    artifacts = _write_artifacts(str(tmp_path_factory.mktemp("tabular")))
    out = {}
    for pkg in ("jax", "torch"):
        models = []
        for name, (kind, d, _) in artifacts.items():
            model = SERVERS[pkg][kind](name, d)
            model.load()
            models.append(model)

        async def drive(server):
            got = {}
            for name, (_, _, rows) in artifacts.items():
                for case, path, body, headers in _requests(name, rows):
                    status, resp_headers, data = await arequest(
                        server.http_port, "POST", path, body, headers)
                    got[(name, case)] = (status, resp_headers, data)
            got[("missing", "v1")] = (await arequest(
                server.http_port, "POST", "/v1/models/missing:predict",
                {"instances": [[1.0]]}))[0]
            return got

        out[pkg] = asyncio.run(serve(pkg, models, drive))
    JAX_REGISTRY.reset()
    REGISTRY.reset()
    out["artifacts"] = artifacts
    return out


CASES = [c for c, _, _, _ in _requests("m", np.zeros((1, 2)))]


@pytest.mark.parametrize("name", ARTIFACT_NAMES)
@pytest.mark.parametrize("case", CASES)
def test_same_response_as_the_jax_server(served, name, case):
    jax_status, jax_headers, jax_body = served["jax"][(name, case)]
    status, headers, body = served["torch"][(name, case)]
    assert status == jax_status
    for header in ("content-type", "inference-header-content-length"):
        assert headers.get(header) == jax_headers.get(header)
    if case == "v2_binary_out1" and status == 200:
        assert body == jax_body
    else:
        assert json.loads(body) == json.loads(jax_body)
    if case.startswith("bad"):
        assert status in (400, 500)
    else:
        assert status == 200, body


def test_answers_are_the_evaluators(served):
    """The served answers are the models' own: iris [1, 1, 0] (the
    reference e2e contract), the ensembles' direct predict on the rows
    as the server received them (float32 from the V1 body)."""
    got = json.loads(served["torch"][("iris_joblib", "v1")][2])
    assert got == {"predictions": [1, 1, 0]}
    _, d, rows = served["artifacts"]["xgb"]
    from kfserving_tpu_torch.predictors.trees import XGBoostEnsemble

    want = XGBoostEnsemble.from_file(os.path.join(d, "model.json")).predict(
        rows.astype(np.float32))
    assert json.loads(served["torch"][("xgb", "v1")][2]) == \
        {"predictions": want.tolist()}
    out = json.loads(served["torch"][("pmml_tree", "v1")][2])
    assert [row[0] for row in out["predictions"]] == ["a", "b"]
    _, headers, body = served["torch"][("xgb", "v2_binary_out1")]
    resp = jax_v2.decode_binary_response(
        body, int(headers["inference-header-content-length"]))
    assert np.array_equal(resp["outputs"][0]["data"], want)
    # BF16 rows reach the evaluator widened exactly from their bits.
    rounded = torch.from_numpy(rows).to(torch.bfloat16).float().numpy()
    want = XGBoostEnsemble.from_file(os.path.join(d, "model.json")).predict(
        rounded)
    for case in ("v2_json_BF16", "v2_binary_bf16"):
        out = json.loads(served["torch"][("xgb", case)][2])["outputs"][0]
        assert out["data"] == want.tolist()


def test_unknown_model_is_404_in_both(served):
    assert served["torch"][("missing", "v1")] == \
        served["jax"][("missing", "v1")] == 404


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # compared across the packages
        return ("raised", type(e).__name__, str(e))


def test_artifact_discovery_errors_match(tmp_path):
    empty = tmp_path / "empty"
    empty.mkdir()
    two = tmp_path / "two"
    two.mkdir()
    (two / "a.joblib").write_bytes(b"")
    (two / "b.pkl").write_bytes(b"")
    xgb_bin = tmp_path / "bst"
    xgb_bin.mkdir()
    (xgb_bin / "model.bst").write_bytes(b"\x00")
    cases = [("sklearn", empty), ("sklearn", two), ("xgb", empty),
             ("lgb", empty), ("pmml", empty), ("xgb", xgb_bin)]
    for kind, d in cases:
        got = {pkg: _outcome(SERVERS[pkg][kind]("m", str(d)).load)
               for pkg in SERVERS}
        assert got["torch"] == got["jax"], (kind, d)
        assert got["torch"][0] == "raised"


async def test_model_level_predict_and_errors_match(served):
    """The Model contract without the server: V1 and V2 dicts, an
    InferRequest, and the errors, through each package's predictors."""
    artifacts = served["artifacts"]
    for name in ARTIFACT_NAMES:
        kind, d, rows = artifacts[name]
        out = {}
        for pkg, module in (("jax", jax_v2), ("torch", v2)):
            model = SERVERS[pkg][kind](name, d)
            model.load()
            res = []
            for request in (
                    {"instances": rows.tolist()},
                    {"inputs": [{"name": "x", "datatype": "FP64",
                                 "shape": list(rows.shape),
                                 "data": rows.ravel().tolist()}]},
                    module.InferRequest.from_binary(
                        *module.make_binary_request({"x": rows})),
                    {"instances": 5}, {"nothing": 1}):
                try:
                    res.append(await model.predict(request))
                except Exception as e:  # compared across the packages
                    res.append((type(e).__name__, str(e)))
            model.unload()
            assert not model.ready
            out[pkg] = res
        assert out["torch"] == out["jax"], name


async def test_sklearn_repository_matches_jax(tmp_path):
    import joblib

    (tmp_path / "iris").mkdir()
    joblib.dump(_iris_svc(), str(tmp_path / "iris" / "model.joblib"))
    (tmp_path / "empty").mkdir()
    out = {}
    for pkg, module in (("jax", jax_sklearnserver),
                        ("torch", sklearnserver)):
        repo = module.SKLearnModelRepository(models_dir=str(tmp_path))
        loaded = [await repo.load("iris"), repo.is_model_ready("iris"),
                  await repo.load("missing"), await repo.load("iris")]
        try:
            await repo.load("empty")
        except Exception as e:  # compared across the packages
            loaded.append((type(e).__name__, str(e)))
        model = repo.get_model("iris")
        loaded.append(await model.predict({"instances": IRIS_ROWS}))
        out[pkg] = loaded
    assert out["torch"] == out["jax"]
    assert out["torch"][:4] == [True, True, False, True]


def test_entry_points_parse_the_orchestrators_argv():
    """The subprocess orchestrator passes --device to every in-tree
    runtime: each tabular entry point's parser takes it and ignores it."""
    from kfserving_tpu_torch.predictors.lgbserver import __main__ as lgb
    from kfserving_tpu_torch.predictors.pmmlserver import __main__ as pm
    from kfserving_tpu_torch.predictors.sklearnserver import __main__ as sk
    from kfserving_tpu_torch.predictors.xgbserver import __main__ as xg

    argv = ["--model_name", "m", "--model_dir", "/x", "--http_port", "0",
            "--device", "cuda", "--max_batch_size", "4"]
    for entry in (sk, xg, lgb, pm):
        args, rest = entry.parser.parse_known_args(argv)
        assert (args.model_name, args.model_dir, args.http_port) == \
            ("m", "/x", 0)
        assert rest == ["--device", "cuda"]
    assert xg.parser.parse_known_args(argv + ["--nthread", "3"])[0] \
        .nthread == 3
