"""The port's multi-model serving path on the CPU: the MLP against the JAX
package's, the device-memory ledger (``engine/hbm.py``), the eager
``TorchModelRepository`` (``residency=False``) with LRU eviction under a
byte budget, staged reloads, the repository routes over the port's HTTP
server, and the jaxserver entry point's ``--multi_model``.  The
demand-paged default is tested in ``test_torch_residency.py``.
"""

import asyncio
import json
import os
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch
from flax import serialization
from torch_parity import randomized

from kfserving_tpu.models import create_model as jax_create_model
from kfserving_tpu_torch.engine.hbm import HBMManager, InsufficientHBM
from kfserving_tpu_torch.models import create_model
from kfserving_tpu_torch.models import weights
from kfserving_tpu_torch.predictors.jaxserver import __main__ as jaxserver
from kfserving_tpu_torch.predictors.jaxserver.repository import (
    TorchModelRepository,
)
from kfserving_tpu_torch.predictors.torch_model import TorchModel
from kfserving_tpu_torch.server.app import ModelServer

# The multi-model catalog's MLP (benchmarks/configs.py, _write_mms_catalog).
CATALOG_KWARGS = {"input_dim": 32, "features": [64], "num_classes": 8}
# fp32 on both sides: summation order only.
FP32_ATOL = 1e-5
# bf16 (the default): one bf16 dense layer whose output is rounded to bf16
# (8 mantissa bits) at other places; logits are O(1).
BF16_ATOL = 0.02


def _variables(seed: int = 1):
    spec = jax_create_model("mlp", **CATALOG_KWARGS)
    shapes = jax.eval_shape(lambda: spec.module.init(
        jax.random.PRNGKey(0), spec.example))
    return randomized(shapes, seed)


@pytest.mark.parametrize("dtype,atol", [("float32", FP32_ATOL),
                                        ("bfloat16", BF16_ATOL)])
def test_mlp_logits_match_jax(dtype, atol):
    variables = _variables()
    spec = jax_create_model("mlp", **CATALOG_KWARGS)
    module = spec.module.clone(dtype=getattr(jax.numpy, dtype))
    x = np.random.default_rng(0).normal(size=(5, 32)).astype(np.float32)
    expect = np.asarray(jax.jit(module.apply)(variables, x))
    model = weights.materialize(
        create_model("mlp", dtype=dtype, **CATALOG_KWARGS).module,
        torch.device("cpu"),
        state_dict=weights.mlp_params_from_flax(variables))
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == expect.shape == (5, 8)
    np.testing.assert_allclose(got, expect, atol=atol, rtol=0)


def test_mlp_checkpoint_round_trip(tmp_path):
    variables = _variables()
    path = os.path.join(str(tmp_path), "checkpoint.msgpack")
    with open(path, "wb") as f:
        f.write(serialization.to_bytes(variables))
    sd = weights.mlp_params_from_flax(weights.read_flax_msgpack(path))
    module = create_model("mlp", **CATALOG_KWARGS).module
    assert set(sd) == set(module.state_dict()) == {
        "dense_0.weight", "dense_0.bias", "head.weight", "head.bias"}
    np.testing.assert_array_equal(
        sd["dense_0.weight"], variables["params"]["dense_0"]["kernel"].T)
    assert module.flops(3) == 2 * 3 * (32 * 64 + 64 * 8)


def _write_model_dir(root, name, with_checkpoint=True, seed=0):
    model_dir = os.path.join(str(root), name)
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump({"architecture": "mlp", "arch_kwargs": CATALOG_KWARGS,
                   "max_latency_ms": 2, "warmup": False}, f)
    if with_checkpoint:
        with open(os.path.join(model_dir, "checkpoint.msgpack"), "wb") as f:
            f.write(serialization.to_bytes(_variables(seed)))
    return model_dir


def _model_bytes() -> int:
    module = create_model("mlp", **CATALOG_KWARGS).module
    return sum(t.numel() * t.element_size() for t in module.parameters())


def test_hbm_ledger_admits_evicts_and_refuses():
    evicted = []
    hbm = HBMManager(budget_bytes=300, evict_cb=evicted.append)
    assert hbm.admit("a", 100) == [] and hbm.admit("b", 100) == []
    hbm.admit("c", 100)
    hbm.touch("a")                                  # b is now LRU
    assert hbm.admit("d", 150) == ["b", "c"] and evicted == ["b", "c"]
    assert hbm.resident_models() == ["a", "d"]
    assert hbm.debug()["evictions"] == {"b": 1, "c": 1}
    with pytest.raises(InsufficientHBM) as err:
        hbm.admit("huge", 301)
    assert err.value.permanent
    with pytest.raises(InsufficientHBM, match="eviction disabled"):
        hbm.admit("e", 100, evict=False)
    assert hbm.resident_models() == ["a", "d"]   # a failed plan books nothing
    hbm.admit("d!staging", 50, evict=False)
    hbm.commit("d!staging", "d", nbytes=60)
    assert hbm.debug()["resident"][1]["bytes"] == 60
    assert hbm.used_bytes == 160 and hbm.free_bytes == 140
    hbm.release("a")
    assert hbm.resident_models() == ["d"]


def test_hbm_budget_from_environment(monkeypatch):
    monkeypatch.setenv("KFS_HBM_BUDGET", "12345")
    assert HBMManager().budget_bytes == 12345
    monkeypatch.delenv("KFS_HBM_BUDGET")
    if not torch.cuda.is_available():
        assert HBMManager().budget_bytes == HBMManager.DEFAULT_BUDGET


def test_repository_load_unload_and_lru_eviction(tmp_path):
    """Eager mode: two models and a budget that fits one; loading the
    second evicts AND unloads the first, which stays registered but not
    ready (tests/test_jaxserver.py's contract for the JAX package)."""
    _write_model_dir(tmp_path, "m1")
    _write_model_dir(tmp_path, "m2", seed=1)
    hbm = HBMManager(budget_bytes=_model_bytes() + 100)
    repo = TorchModelRepository(models_dir=str(tmp_path), hbm=hbm,
                                residency=False, device="cpu")

    async def run():
        assert await repo.load("m1")
        assert repo.is_model_ready("m1")
        m1 = repo.get_model("m1")
        assert await repo.load("m2")
        assert not repo.is_model_ready("m1") and repo.is_model_ready("m2")
        assert m1.engine is None and m1.module is None     # freed
        assert hbm.resident_models() == ["m2"]
        assert hbm.evictions == {"m1": 1}
        await repo.unload("m2")
        assert hbm.resident_models() == [] and repo.get_model("m2") is None

    asyncio.run(run())


def test_repository_load_missing_dir(tmp_path):
    repo = TorchModelRepository(models_dir=str(tmp_path), device="cpu")

    async def run():
        assert not await repo.load("nope")
        assert repo.get_model("nope") is None

    asyncio.run(run())


def test_residency_mode_is_not_ported_yet(tmp_path):
    """Residency is ported now and is the default, as in the JAX
    package: a load registers the model with no device memory."""
    _write_model_dir(tmp_path, "m1")
    repo = TorchModelRepository(models_dir=str(tmp_path), device="cpu")
    assert repo.residency is not None

    async def run():
        assert await repo.load("m1")
        assert repo.is_model_ready("m1")
        assert repo.get_model("m1").engine is None
        assert repo.residency.state_of("m1") == "registered"
        assert repo.hbm.resident_models() == []

    asyncio.run(run())


def test_reload_is_staged_then_committed(tmp_path, monkeypatch):
    """A reload admits the new generation under '<name>!staging' without
    evicting, keeps the old one serving until the new one is built, then
    commits the staged entry in the ledger; with no headroom for both it
    closes the old generation first."""
    model_dir = _write_model_dir(tmp_path, "m")
    nbytes = _model_bytes()
    hbm = HBMManager(budget_bytes=2 * nbytes + 100)
    admits = []
    real_admit = hbm.admit
    monkeypatch.setattr(hbm, "admit", lambda name, n, evict=True: (
        admits.append((name, evict)), real_admit(name, n, evict))[1])
    model = TorchModel("m", model_dir, device="cpu", hbm=hbm)
    model.load()
    first = model.engine
    model.load()
    assert admits == [("m", True), ("m!staging", False)]
    assert first.params is None and model.engine is not first
    assert hbm.resident_models() == ["m"]
    assert hbm.debug()["resident"][0]["bytes"] == \
        model.engine.param_bytes() == nbytes
    hbm.budget_bytes = nbytes + 100          # no room for a second copy
    model.load()
    assert admits[2:] == [("m!staging", False), ("m", True)]
    assert hbm.resident_models() == ["m"] and model.ready
    x = np.zeros((1, 32), np.float32)
    assert len(asyncio.run(model.predict({"instances": x.tolist()}))[
        "predictions"]) == 1
    model.unload()
    assert hbm.resident_models() == []


def test_failed_load_releases_the_ledger(tmp_path):
    model_dir = _write_model_dir(tmp_path, "bad", with_checkpoint=False)
    with open(os.path.join(model_dir, "checkpoint.msgpack"), "wb") as f:
        f.write(b"not a checkpoint")
    hbm = HBMManager(budget_bytes=10 ** 6)
    model = TorchModel("bad", model_dir, device="cpu", hbm=hbm)
    with pytest.raises(Exception):
        model.load()
    assert hbm.resident_models() == [] and not model.ready


def _http(port, method, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read() or b"null")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


async def test_repository_routes_over_http(tmp_path):
    """POST load for three catalog models under a budget of two: the
    index shows the least recently used one UNAVAILABLE, predicts answer
    from the resident ones with the model's own direct forward, unload
    drops a model, and unknown names are 404 (unload) or 503 (load)."""
    for i in range(3):
        _write_model_dir(tmp_path, f"m{i}", seed=i)
    hbm = HBMManager(budget_bytes=2 * _model_bytes() + 100)
    repo = TorchModelRepository(models_dir=f"file://{tmp_path}", hbm=hbm,
                                residency=False, device="cpu")
    server = ModelServer(http_port=0, registered_models=repo)
    await server.start_async([], host="127.0.0.1")
    port = server.http_port

    async def call(method, path, body=None):
        return await asyncio.to_thread(_http, port, method, path, body)

    try:
        for i in range(3):
            assert await call("POST", f"/v2/repository/models/m{i}/load") \
                == (200, {"name": f"m{i}", "load": True})
        status, index = await call("GET", "/v2/repository/index")
        assert status == 200 and index == [
            {"name": "m0", "state": "UNAVAILABLE"},
            {"name": "m1", "state": "READY"},
            {"name": "m2", "state": "READY"}]
        x = np.random.default_rng(1).normal(size=(2, 32)).astype(np.float32)
        status, body = await call("POST", "/v1/models/m2:predict",
                                  {"instances": x.tolist()})
        with torch.inference_mode():
            direct = repo.get_model("m2").module(torch.from_numpy(x))
        assert status == 200
        np.testing.assert_allclose(body["predictions"], direct.numpy(),
                                   atol=1e-6, rtol=0)
        assert await call("POST", "/v2/repository/models/m1/unload") == \
            (200, {"name": "m1", "unload": True})
        assert (await call("POST", "/v2/repository/models/m1/unload"))[0] \
            == 404
        assert (await call("POST", "/v2/repository/models/nope/load"))[0] \
            == 503
        status, index = await call("GET", "/v2/repository/index")
        assert [m["name"] for m in index] == ["m0", "m2"]
        assert hbm.resident_models() == ["m2"]
    finally:
        await server.stop_async()
        for model in repo.get_models():
            model.unload()


def test_multi_model_flag_serves_the_catalog_root(tmp_path, monkeypatch):
    started = []
    monkeypatch.setattr(ModelServer, "start",
                        lambda self, models: started.append((self, models)))
    jaxserver.main(["--model_dir", str(tmp_path), "--multi_model",
                    "--device", "cpu", "--http_port", "0"])
    (server, models), = started
    assert models == []
    assert isinstance(server.repository, TorchModelRepository)
    assert server.repository.residency is not None      # demand-paged
    assert server.repository.models_dir == str(tmp_path)
