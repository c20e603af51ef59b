"""The port's black-box explainers against the JAX package's, on the CPU.

The explainers are numpy in both packages, so every case gives the JAX
class and the port's the same seeded predictor and input and requires the
same explanation dict, and the same predictor calls (batch sizes, in
order), exactly: anchors for tables, images and text, LIME images, the
square attack, fairness metrics and the noise-flip BlackBoxExplainer,
searched directly and served from their artifact configs.  Then
``build_explainer`` dispatch, and one explainer served through the port
server's ``:explain`` route, scoring its perturbations against a
predictor over the V2 binary wire.
"""

import asyncio
import json

import numpy as np
import pytest
from torch_serving import arequest

import kfserving_tpu.explainers as jax_explainers
import kfserving_tpu_torch.explainers as port_explainers
from kfserving_tpu.explainers import saliency as jax_saliency
from kfserving_tpu_torch.explainers import saliency as port_saliency
from kfserving_tpu_torch.protocol.v2 import InferRequest, make_response
from kfserving_tpu_torch.server.app import ModelServer
from kfserving_tpu_torch.server.http import HTTPServer, Response, Router

PACKAGES = {"jax": jax_explainers, "torch": port_explainers}
SALIENCY = {"jax": jax_saliency, "torch": port_saliency}


def bright_pixel(batch):
    """Class 1 iff the sentinel pixel (2, 2) is bright."""
    return (np.asarray(batch, np.float64)[:, 2, 2, 0] > 0.5).astype(
        np.int64)


def bright_proba(batch):
    hot = bright_pixel(batch)
    return np.stack([1.0 - hot, hot.astype(np.float64)], axis=-1)


def sentinel_image(h=16, w=16):
    img = np.zeros((h, w, 1))
    img[2, 2, 0] = 1.0
    return img


def keyword(batch):
    return np.asarray([1 if "good" in str(s).split() else 0
                       for s in batch])


def both_words(batch):
    return np.asarray([1 if {"very", "good"} <= set(str(s).split()) else 0
                       for s in batch])


def patch_proba(batch):
    p1 = np.clip(np.asarray(batch)[:, :8, :8, 0].mean(axis=(1, 2)), 0, 1)
    return np.stack([1 - p1, p1], axis=1)


def three_labels(batch):
    m = np.asarray(batch).reshape(len(batch), -1).mean(axis=1)
    return np.where(m > 0.9, 2, np.where(m > 0.4, 1, 0)).astype(np.int64)


def linear(w):
    def predict(batch):
        z = np.asarray(batch).reshape(len(batch), -1) @ w
        return np.stack([-z, z], axis=1)
    return predict


def tabular_data():
    rng = np.random.default_rng(0)
    train = rng.normal(0, 1, (200, 4))
    return train


def tabular_rule(batch):
    """Class 2 when features 0 and 2 are high, 1 when only 0 is, else 0."""
    b = np.asarray(batch)
    return np.where((b[:, 0] > 0.3) & (b[:, 2] > 0), 2,
                    np.where(b[:, 0] > 0.3, 1, 0))


async def _anchor_tabular(pkg, predict, root):
    search = pkg.AnchorSearch(predict, tabular_data(),
                              feature_names=["a", "b", "c", "d"], seed=0)
    return await search.explain(np.array([1.0, 0.0, 1.0, 0.0]),
                                threshold=0.9, batch_size=64)


def _anchor_tabular_served(pkg, predict, root):
    root.mkdir(exist_ok=True)
    np.save(root / "train.npy", tabular_data())
    (root / "anchors.json").write_text(json.dumps(
        {"feature_names": ["a", "b", "c", "d"], "batch_size": 32,
         "precision_threshold": 0.9, "seed": 1}))
    model = pkg.AnchorTabular("t", str(root), predict_fn=predict)
    model.load()
    return model.explain({"instances": [[1.0, 0.0, 1.0, 0.0]]})


async def _anchor_images(pkg, predict, root):
    search = pkg.AnchorImageSearch(predict, n_segments=16, seed=0)
    return await search.explain(sentinel_image(), threshold=0.95,
                                batch_size=16)


async def _anchor_images_chunked(pkg, predict, root):
    search = pkg.AnchorImageSearch(predict, n_segments=16,
                                   max_call_bytes=8 * 2048, seed=0)
    return await search.explain(sentinel_image(), threshold=0.95,
                                batch_size=16)


async def _anchor_images_gray(pkg, predict, root):
    search = pkg.AnchorImageSearch(predict, n_segments=16, seed=1)
    return await search.explain(sentinel_image()[..., 0], threshold=0.9)


def _anchor_images_served(pkg, predict, root):
    root.mkdir(exist_ok=True)
    (root / "anchor_images.json").write_text(json.dumps(
        {"n_segments": 9, "p_sample": 0.4, "batch_size": 12, "seed": 2}))
    model = pkg.AnchorImages("i", str(root), predict_fn=predict)
    model.load()
    return model.explain(
        {"instances": [sentinel_image(12, 12).tolist()]})


async def _anchor_text(pkg, predict, root):
    search = pkg.AnchorTextSearch(predict, seed=0)
    out = [await search.explain(doc, threshold=0.95) for doc in (
        "this movie is good really", "a plainly dull film",
        "a very good film indeed")]
    chunked = pkg.AnchorTextSearch(predict, max_call_bytes=16_000, seed=0)
    out.append(await chunked.explain("filler " * 40 + "good ending",
                                     threshold=0.95, batch_size=32))
    return out


def _anchor_text_served(pkg, predict, root):
    root.mkdir(exist_ok=True)
    (root / "anchor_text.json").write_text(json.dumps(
        {"unk_token": "<mask>", "p_sample": 0.4, "seed": 3}))
    model = pkg.AnchorText("e", str(root), predict_fn=predict)
    model.load()
    return model.explain(
        {"instances": [["the", "very", "good", "film"]]})


async def _lime(pkg, predict, root):
    search = pkg.LimeImageSearch(predict, n_segments=16, seed=0)
    return await search.explain(np.ones((16, 16, 1)), num_samples=128,
                                top_labels=2, num_features=4)


async def _lime_labels(pkg, predict, root):
    search = pkg.LimeImageSearch(predict, n_segments=4, seed=3)
    return await search.explain(np.ones((8, 8)), num_samples=96,
                                top_labels=1, batch_size=16)


def _lime_served(pkg, predict, root):
    root.mkdir(exist_ok=True)
    (root / "lime.json").write_text(json.dumps(
        {"n_segments": 16, "num_samples": 64, "top_labels": 1,
         "batch_size": 24}))
    model = pkg.LimeImages("img", str(root), predict_fn=predict)
    model.load()
    return model.explain(
        {"instances": [np.ones((16, 16, 1)).tolist()], "num_features": 3})


_W16 = np.random.default_rng(0).normal(size=16)


async def _square_attack(pkg, predict, root):
    x = 0.05 * _W16 / np.linalg.norm(_W16) ** 2
    flipped = await pkg.SquareAttack(predict, eps=0.5, max_iter=50,
                                     seed=0).attack(x, label=1)
    robust = await pkg.SquareAttack(predict, eps=0.01, max_iter=10,
                                    seed=0).attack(np.ones(16), label=1)
    return [flipped, robust]


def _square_attack_served(pkg, predict, root):
    root.mkdir(exist_ok=True)
    (root / "art.json").write_text(json.dumps(
        {"eps": 0.5, "max_iter": 40, "candidates_per_iter": 4}))
    model = pkg.AdversarialRobustness("art", str(root), predict_fn=predict)
    model.load()
    x = (0.05 * _W16 / np.linalg.norm(_W16) ** 2).reshape(4, 4)
    return model.explain({"instances": [x.tolist(), 1]})


async def _square_attack_unseen_label(pkg, predict, root):
    return await pkg.SquareAttack(predict, eps=0.1, max_iter=5,
                                  seed=0).attack(np.full(4, -1.0), label=2)


async def _fairness(pkg, predict, root):
    rng = np.random.default_rng(1)
    X = np.stack([rng.integers(0, 2, 40), rng.normal(0, 1, 40)], axis=1)
    model = pkg.FairnessExplainer(
        "f", feature_names=["sex", "income"],
        privileged_groups=[{"sex": 1}], unprivileged_groups=[{"sex": 0}])
    return await model.explain({"instances": X.tolist(),
                                "outputs": predict(X).tolist()})


async def _blackbox(pkg, predict, root):
    mod = SALIENCY["jax" if pkg is jax_explainers else "torch"]
    model = mod.BlackBoxExplainer("bb", num_samples=8, seed=4,
                                  predict_fn=predict)
    model.load()
    rng = np.random.default_rng(2)
    return await model.explain({"instances": rng.normal(0, 1, (3, 4))
                                .tolist()})


CASES = {
    "anchor_tabular": (_anchor_tabular, tabular_rule),
    "anchor_tabular_served": (_anchor_tabular_served, tabular_rule),
    "anchor_images": (_anchor_images, bright_pixel),
    "anchor_images_proba_chunked": (_anchor_images_chunked, bright_proba),
    "anchor_images_gray": (_anchor_images_gray, bright_pixel),
    "anchor_images_served": (_anchor_images_served, bright_proba),
    "anchor_text": (_anchor_text, keyword),
    "anchor_text_conjunction": (_anchor_text, both_words),
    "anchor_text_served": (_anchor_text_served, both_words),
    "lime_images": (_lime, patch_proba),
    "lime_images_label_widths": (_lime_labels, three_labels),
    "lime_images_served": (_lime_served, patch_proba),
    "square_attack": (_square_attack, linear(_W16)),
    "square_attack_served": (_square_attack_served, linear(_W16)),
    "square_attack_unseen_label": (
        _square_attack_unseen_label,
        lambda b: (np.asarray(b).reshape(len(b), -1).sum(axis=1) > 0
                   ).astype(np.int64)),
    "fairness": (_fairness, lambda X: (X[:, 1] > 0).astype(np.float64)),
    "blackbox": (_blackbox, lambda b: (np.asarray(b).sum(axis=1) > 0
                                       ).astype(np.int64)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_explanations_equal_jax(tmp_path, case):
    """The same explanation, to the last bit, and the same predictor
    calls in the same order and sizes."""
    run, predict = CASES[case]
    results, calls = {}, {}
    for name, pkg in PACKAGES.items():
        seen = calls.setdefault(name, [])

        def counting(batch, seen=seen):
            seen.append(np.shape(batch) if isinstance(batch, np.ndarray)
                        else len(batch))
            return predict(batch)

        results[name] = asyncio.run(run(pkg, counting, tmp_path / name))
    assert json.dumps(results["torch"], sort_keys=True) == \
        json.dumps(results["jax"], sort_keys=True)
    assert calls["torch"] == calls["jax"] and calls["torch"]


@pytest.mark.parametrize("make,request_", [
    (lambda pkg: pkg.AnchorTextSearch(keyword), "   "),
    (lambda pkg: pkg.AdversarialRobustness("art", predict_fn=lambda b: b),
     {"instances": [[1.0, 2.0]]}),
    (lambda pkg: pkg.AnchorImageSearch(bright_pixel), np.zeros(4)),
    (lambda pkg: pkg.FairnessExplainer("f", ["a"], [{"a": 1}], [{"a": 0}]),
     {"instances": [[1.0]]}),
    (lambda pkg: pkg.AnchorImages("i", predict_fn=bright_pixel),
     {"instances": []}),
    (lambda pkg: pkg.LimeImages("l", predict_fn=patch_proba),
     {"instances": []}),
])
def test_refusals_alike(make, request_):
    """Bad inputs raise the same error class with the same message."""
    errors = []
    for pkg in PACKAGES.values():
        explainer = make(pkg)
        if hasattr(explainer, "load"):
            explainer.load()

        async def run():
            return await explainer.explain(request_)

        with pytest.raises(Exception) as e:
            asyncio.run(run())
        errors.append((type(e.value).__name__, str(e.value)))
    assert errors[0] == errors[1] and errors[0][0] == "InvalidInput"


def test_build_explainer_dispatch_and_tables(tmp_path):
    """Every type resolves to the same class in both packages; the type
    tables are equal; fairness reads its artifact; unknown types and a
    fairness build without an artifact raise alike."""
    assert port_explainers.EXPLAINER_TYPES == jax_explainers.EXPLAINER_TYPES
    assert port_explainers.ARTIFACT_REQUIRED_TYPES == \
        jax_explainers.ARTIFACT_REQUIRED_TYPES
    (tmp_path / "fairness.json").write_text(json.dumps(
        {"feature_names": ["a"], "privileged_groups": [{"a": 1}],
         "unprivileged_groups": [{"a": 0}], "n_neighbors": 3}))
    for kind in port_explainers.EXPLAINER_TYPES:
        if kind == "saliency":
            continue     # builds a model; covered by test_torch_saliency
        uri = str(tmp_path) if kind == "fairness" else ""
        port = port_explainers.build_explainer("e", kind, uri, "h:1")
        ref = jax_explainers.build_explainer("e", kind, uri, "h:1")
        assert type(port).__name__ == type(ref).__name__
        assert port.predictor_host == ref.predictor_host == "h:1"
    saliency = port_explainers.build_explainer("e", "saliency",
                                               str(tmp_path), "h:1",
                                               device="cpu")
    assert type(saliency).__name__ == "SaliencyExplainer"
    assert saliency.predictor_host == "h:1"
    for kind, uri in (("nope", ""), ("fairness", "")):
        errors = []
        for pkg in PACKAGES.values():
            with pytest.raises(ValueError) as e:
                pkg.build_explainer("e", kind, uri)
            errors.append(str(e.value))
        assert errors[0] == errors[1]


def test_anchor_images_served_through_the_explain_route(tmp_path):
    """AnchorImages on the port's server: POST :explain, its
    perturbations scored by a predictor over the V2 binary wire, equal to
    the JAX explainer with the classifier in process."""
    seen = []

    async def infer(req):
        assert "inference-header-content-length" in req.headers
        request = InferRequest.from_binary(
            req.body, int(req.headers["inference-header-content-length"]))
        batch = next(iter(request.named_numpy().values()))
        seen.append(batch.shape)
        return Response(json.dumps(make_response(
            "img", {"output_0": bright_pixel(batch)})).encode())

    image = sentinel_image(12, 12)
    want = asyncio.run(_anchor_images_served(jax_explainers, bright_pixel,
                                             tmp_path / "jax"))
    root = tmp_path / "torch"
    root.mkdir()
    (root / "anchor_images.json").write_text(json.dumps(
        {"n_segments": 9, "p_sample": 0.4, "batch_size": 12, "seed": 2}))

    async def run():
        router = Router()
        router.add("POST", "/v2/models/{name}/infer", infer)
        predictor = HTTPServer(router)
        await predictor.start("127.0.0.1", 0)
        explainer = await asyncio.to_thread(
            port_explainers.build_explainer, "img", "anchor_images",
            str(root), f"127.0.0.1:{predictor.port}")
        await asyncio.to_thread(explainer.load)
        server = ModelServer(http_port=0)
        await server.start_async([explainer], host="127.0.0.1")
        try:
            status, _, raw = await arequest(
                server.http_port, "POST", "/v1/models/img:explain",
                {"instances": [image.tolist()]})
        finally:
            await server.stop_async()
            await explainer.close()
            await predictor.stop()
        return status, json.loads(raw)

    status, got = asyncio.run(run())
    assert status == 200, got
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert seen and all(s[1:] == (12, 12, 1) for s in seen)
