"""The port's serving path (kfserving_tpu_torch predictor, batcher,
engine and server) against the JAX package's on one artifact, on the CPU.
"""

import asyncio
import json
import os
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
from flax import serialization

from kfserving_tpu.models import create_model as jax_create_model
from kfserving_tpu.models import init_params
from kfserving_tpu.predictors.jax_model import JaxModel
from kfserving_tpu.storage import Storage as JaxStorage
from kfserving_tpu_torch.predictors.torch_model import TorchModel
from kfserving_tpu_torch.protocol.errors import InvalidInput
from kfserving_tpu_torch.storage import Storage
from kfserving_tpu_torch.server.app import ModelServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# fp32 on both sides (arch_kwargs dtype), so the top-5 ids agree exactly
# and the scores to fp32 summation-order noise.
SCORE_ATOL = 1e-4


def _artifact(tmp_path, output="topk"):
    model_dir = os.path.join(str(tmp_path), "bert")
    os.makedirs(model_dir)
    cfg = {"architecture": "bert_tiny", "arch_kwargs": {"dtype": "float32"},
           "seq_buckets": [16, 32], "batch_buckets": [1, 4],
           "max_batch_size": 4, "max_latency_ms": 2, "warmup": False,
           "output": output, "topk": 5}
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(cfg, f)
    spec = jax_create_model("bert_tiny", dtype="float32")
    with open(os.path.join(model_dir, "checkpoint.msgpack"), "wb") as f:
        f.write(serialization.to_bytes(init_params(spec, seed=1)))
    return model_dir


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    return _artifact(tmp_path_factory.mktemp("artifact"))


@pytest.fixture(scope="module")
def torch_model(artifact, tmp_path_factory):
    # A module fixture is set up before the per-test private param cache
    # of tests/conftest.py: this load gets a private cache of its own.
    prior = os.environ.get("KFS_PARAM_CACHE")
    os.environ["KFS_PARAM_CACHE"] = str(tmp_path_factory.mktemp("params"))
    try:
        model = TorchModel("bert", artifact, device="cpu")
        model.load()
    finally:
        if prior is None:
            os.environ.pop("KFS_PARAM_CACHE", None)
        else:
            os.environ["KFS_PARAM_CACHE"] = prior
    yield model
    model.unload()


def _token_rows(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 1024, size=n).tolist() for n in lengths]


def _assert_topk_equal(got, expect):
    np.testing.assert_array_equal(np.asarray(got["indices"]),
                                  np.asarray(expect["indices"]))
    np.testing.assert_allclose(np.asarray(got["values"]),
                               np.asarray(expect["values"]),
                               atol=SCORE_ATOL, rtol=0)


def _v2_topk(response):
    outputs = {o["name"]: o for o in response["outputs"]}
    assert set(outputs) == {"values", "indices"}
    return {k: np.reshape(o["data"], o["shape"]) for k, o in outputs.items()}


def test_topk_matches_jax_model(artifact, torch_model):
    """V1 (concurrent requests, so batches form) and V2 through the JAX
    package's JaxModel and the port's TorchModel on one checkpoint."""
    jax_model = JaxModel("bert", artifact)
    jax_model.load()
    rows = _token_rows([12, 30, 5])
    ids = np.asarray(_token_rows([20, 20], seed=1), np.int32)
    v2_request = {"id": "r1", "inputs": [{
        "name": "input_ids", "shape": list(ids.shape), "datatype": "INT32",
        "data": ids.ravel().tolist()}]}

    async def run(model):
        v1 = await asyncio.gather(*(
            model.predict({"instances": [r]}) for r in rows))
        return v1, await model.predict(v2_request)

    try:
        expect_v1, expect_v2 = asyncio.run(run(jax_model))
    finally:
        jax_model.unload()
    got_v1, got_v2 = asyncio.run(run(torch_model))
    assert torch_model.param_source == "checkpoint"
    for g, e in zip(got_v1, expect_v1):
        assert len(g["predictions"]) == 1
        _assert_topk_equal(g["predictions"][0], e["predictions"][0])
    assert got_v2["model_name"] == "bert" and got_v2["id"] == "r1"
    assert [o["shape"] for o in got_v2["outputs"]] == \
        [o["shape"] for o in expect_v2["outputs"]] == [[2, 32, 5]] * 2
    _assert_topk_equal(_v2_topk(got_v2), _v2_topk(expect_v2))


def test_left_padded_mask_rejected(torch_model):
    inst = {"input_ids": list(range(1, 9)),
            "attention_mask": [0, 0, 1, 1, 1, 1, 1, 1]}
    with pytest.raises(InvalidInput, match="not suffix padding"):
        asyncio.run(torch_model.predict({"instances": [inst]}))


def test_sequence_past_largest_bucket_rejected(torch_model):
    with pytest.raises(InvalidInput, match="exceeds the largest bucket"):
        asyncio.run(torch_model.predict(
            {"instances": _token_rows([40])}))


def test_engine_stats_and_metadata(torch_model):
    asyncio.run(torch_model.predict({"instances": _token_rows([3])}))
    stats = torch_model.engine_stats()
    assert stats["execute_count"] >= 1 and stats["compile_count"] == 0
    for key in ("avg_prepare_ms", "avg_device_ms", "avg_fetch_ms"):
        assert stats[key] >= 0.0
    assert "mfu" not in stats          # no peak for a CPU device
    meta = torch_model.metadata()
    assert meta["platform"] == "pytorch"
    assert meta["seq_buckets"] == [16, 32]
    assert {i["name"] for i in meta["inputs"]} == {"input_ids",
                                                   "attention_mask"}


def test_warmup_runs_every_bucket(artifact):
    model = TorchModel("bert", artifact, device="cpu",
                       config_overrides={"warmup": True})
    model.load()
    try:
        assert model.engine.compile_count == 4   # 2 batch x 2 seq
        assert "bucket_hits" not in model.engine.stats()
    finally:
        model.unload()


def test_cuda_without_card_raises(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        TorchModel("bert", str(tmp_path), device="cuda")


def test_local_model_dir(tmp_path, monkeypatch):
    """A model_dir resolves through Storage.download as in the JAX
    package: a path and file:// to the directory itself, and a remote
    scheme whose SDK is missing fails with the JAX package's message."""
    import sys

    model_dir = tmp_path / "bert"
    model_dir.mkdir()
    for storage in (Storage, JaxStorage):
        assert storage.download(f"file://{model_dir}") == str(model_dir)
        assert storage.download(str(model_dir)) == str(model_dir)
    # The SDK made unimportable, so no client is ever built.
    monkeypatch.setitem(sys.modules, "minio", None)
    errors = []
    for storage in (Storage, JaxStorage):
        with pytest.raises(RuntimeError, match="not installed") as e:
            storage.download("s3://bucket/bert", str(tmp_path / "out"))
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def _http(port, method, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


async def test_model_server_answers_v1_and_v2(torch_model):
    server = ModelServer(http_port=0)
    await server.start_async([torch_model], host="127.0.0.1")
    port = server.http_port
    try:
        async def call(method, path, body=None):
            return await asyncio.to_thread(_http, port, method, path, body)

        assert await call("GET", "/") == (200, b"Alive")
        status, body = await call("GET", "/v2/health/ready")
        assert status == 200 and json.loads(body) == {"ready": True}
        status, body = await call("GET", "/v1/models")
        assert json.loads(body) == ["bert"]
        status, body = await call("GET", "/v1/models/bert")
        assert json.loads(body) == {"name": "bert", "ready": True}
        assert (await call("GET", "/v2/models/bert/ready"))[0] == 200
        status, body = await call("GET", "/v2/models/bert")
        assert json.loads(body)["architecture"] == "bert_tiny"
        assert (await call("GET", "/v1/models/nope"))[0] == 404
        row = _token_rows([9], seed=3)[0]
        status, body = await call("POST", "/v1/models/bert:predict",
                                  {"instances": [row]})
        assert status == 200
        expect = await torch_model.predict({"instances": [row]})
        _assert_topk_equal(json.loads(body)["predictions"][0],
                           expect["predictions"][0])
        status, body = await call(
            "POST", "/v2/models/bert/infer",
            {"inputs": [{"name": "input_ids", "shape": [1, 9],
                         "datatype": "INT64", "data": row}]})
        assert status == 200
        assert [o["shape"] for o in json.loads(body)["outputs"]] == \
            [[1, 16, 5], [1, 16, 5]]
        status, body = await call("POST", "/v1/models/bert:predict",
                                  {"instances": 5})
        assert status == 400
        assert (await call("POST", "/v1/models/nope:predict",
                           {"instances": [row]}))[0] == 404
    finally:
        await server.stop_async()


def test_port_imports_nothing_of_jax():
    code = (
        "import sys\n"
        "import kfserving_tpu_torch\n"
        "import kfserving_tpu_torch.server.app\n"
        "import kfserving_tpu_torch.predictors.torch_model\n"
        "import kfserving_tpu_torch.predictors.jaxserver.__main__\n"
        "import kfserving_tpu_torch.predictors.jaxserver.repository\n"
        "import kfserving_tpu_torch.engine.hbm\n"
        "import kfserving_tpu_torch.engine.param_cache\n"
        "import kfserving_tpu_torch.engine.residency\n"
        "import kfserving_tpu_torch.reliability.faults\n"
        "import kfserving_tpu_torch.reliability.fault_sites\n"
        "import kfserving_tpu_torch.models.resnet\n"
        "import kfserving_tpu_torch.models.vit\n"
        "import kfserving_tpu_torch.models.mlp\n"
        "import kfserving_tpu_torch.models.weights\n"
        "import kfserving_tpu_torch.models.decoder\n"
        "import kfserving_tpu_torch.ops.paged_attention\n"
        "import kfserving_tpu_torch.engine.generator\n"
        "import kfserving_tpu_torch.predictors.llm\n"
        "import kfserving_tpu_torch.predictors.llmserver.__main__\n"
        "import kfserving_tpu_torch.streams\n"
        "import kfserving_tpu_torch.storage.__main__\n"
        "import kfserving_tpu_torch.storage.credentials\n"
        "import kfserving_tpu_torch.reliability.retry\n"
        "import kfserving_tpu_torch.model.model\n"
        "import kfserving_tpu_torch.server.client\n"
        "import kfserving_tpu_torch.explainers.__main__\n"
        "import kfserving_tpu_torch.explainers.saliency\n"
        "import kfserving_tpu_torch.explainers.anchor_text\n"
        "import kfserving_tpu_torch.observability.attribution\n"
        "import kfserving_tpu_torch.observability.monitoring\n"
        "import kfserving_tpu_torch.observability.history\n"
        "import kfserving_tpu_torch.observability.incidents\n"
        "import kfserving_tpu_torch.observability.profiling\n"
        "import kfserving_tpu_torch.reliability.sanitizer\n"
        "import kfserving_tpu_torch.reliability.breaker\n"
        "import kfserving_tpu_torch.reliability.brownout\n"
        "import kfserving_tpu_torch.reliability.envknobs\n"
        "import kfserving_tpu_torch.observability.federation\n"
        "import kfserving_tpu_torch.tools.convert\n"
        "import kfserving_tpu_torch.tools.check_metrics\n"
        "import kfserving_tpu_torch.tools.torch2openapi\n"
        "optional = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "    ('grpc', 'msgpack', 'transformers', 'tokenizers')\n"
        "    or m.startswith('google.protobuf'))\n"
        "assert not optional, optional\n"
        "import importlib, pkgutil\n"
        "import kfserving_tpu_torch.control, kfserving_tpu_torch.examples\n"
        "import kfserving_tpu_torch.agent, kfserving_tpu_torch.client\n"
        "import kfserving_tpu_torch.detectors\n"
        "import kfserving_tpu_torch.predictors\n"
        "import kfserving_tpu_torch.protocol\n"
        "import kfserving_tpu_torch.parallel\n"
        "import kfserving_tpu_torch.tools\n"
        "for pkg in (kfserving_tpu_torch.control,\n"
        "            kfserving_tpu_torch.parallel,\n"
        "            kfserving_tpu_torch.examples,\n"
        "            kfserving_tpu_torch.agent,\n"
        "            kfserving_tpu_torch.client,\n"
        "            kfserving_tpu_torch.detectors,\n"
        "            kfserving_tpu_torch.predictors,\n"
        "            kfserving_tpu_torch.protocol,\n"
        "            kfserving_tpu_torch.tools):\n"
        "    for info in pkgutil.walk_packages(pkg.__path__,\n"
        "                                      pkg.__name__ + '.'):\n"
        "        importlib.import_module(info.name)\n"
        "assert 'kfserving_tpu_torch.control.subprocess_orchestrator' \\\n"
        "    in sys.modules\n"
        "assert 'kfserving_tpu_torch.client.__main__' in sys.modules\n"
        "for name in ('detectors.__main__', 'protocol.avro',\n"
        "             'predictors.tabular', 'predictors.trees',\n"
        "             'predictors.pmml_eval',\n"
        "             'predictors.sklearnserver.__main__',\n"
        "             'predictors.xgbserver.__main__',\n"
        "             'predictors.lgbserver.__main__',\n"
        "             'predictors.pmmlserver.__main__',\n"
        "             'predictors.torchserver.__main__',\n"
        "             'parallel.follower', 'parallel.mesh',\n"
        "             'parallel.multihost', 'parallel.ring_attention',\n"
        "             'parallel.sharding', 'tools.analyzers.naming',\n"
        "             'protocol.grpc.kfs_generate_pb2'):\n"
        "    assert 'kfserving_tpu_torch.' + name in sys.modules, name\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "    ('jax', 'jaxlib', 'flax', 'aiohttp', 'msgpack', 'ml_dtypes',\n"
        "     'kfserving_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_grpc_server_imports_nothing_of_jax():
    """The gRPC front end (imported only for --grpc_port) brings grpc and
    protobuf, and nothing of JAX, the JAX package or msgpack."""
    pytest.importorskip("grpc")
    code = (
        "import sys\n"
        "from kfserving_tpu_torch.server.grpc_server import GRPCServer\n"
        "assert len(GRPCServer(None)._handlers()) == 3\n"
        "assert 'grpc' in sys.modules and 'google.protobuf' in sys.modules\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "    ('jax', 'jaxlib', 'flax', 'msgpack', 'ml_dtypes',\n"
        "     'kfserving_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("buckets,cap", [(None, 8), ([1, 4, 16], 16),
                                         ([16, 64, 128], 128)])
def test_batcher_chunking_matches_jax(buckets, cap):
    from kfserving_tpu.batching.batcher import DynamicBatcher as JaxBatcher
    from kfserving_tpu_torch.batching import DynamicBatcher

    async def handler(instances, key=None):
        return instances

    ref = JaxBatcher(handler, max_batch_size=cap, buckets=buckets)
    port = DynamicBatcher(handler, max_batch_size=cap, buckets=buckets)
    assert port.max_batch_size == ref.max_batch_size
    for n in range(1, 300):
        assert port._chunk_sizes(n) == ref._chunk_sizes(n), n


async def test_batcher_aligned_flush_scatters_per_caller():
    from kfserving_tpu_torch.batching import DynamicBatcher

    calls = []

    async def handler(instances, key):
        assert all(i % 2 == key for i in instances)   # keys never mix
        calls.append(len(instances))
        return [i * 10 for i in instances]

    batcher = DynamicBatcher(handler, max_batch_size=4, max_latency_ms=20,
                             key_fn=lambda i: i % 2, buckets=[1, 4])
    results = await asyncio.gather(*(batcher.submit([i])
                                     for i in range(10)))
    assert [r.predictions for r in results] == [[i * 10]
                                                for i in range(10)]
    assert sorted(calls) == [1, 1, 4, 4]     # bucket-sized executions
    assert batcher.instances_batched == 10


async def test_batcher_cancel_withdraws_and_mismatch_raises():
    from kfserving_tpu_torch.batching import BatchSizeMismatch, DynamicBatcher

    seen = []

    async def handler(instances):
        seen.extend(instances)
        return instances

    batcher = DynamicBatcher(handler, max_batch_size=8, max_latency_ms=30)
    first = asyncio.ensure_future(batcher.submit(["a"]))
    second = asyncio.ensure_future(batcher.submit(["b"]))
    await asyncio.sleep(0)
    first.cancel()
    assert (await second).predictions == ["b"]
    assert seen == ["b"]

    async def short(instances):
        return instances[:-1]

    bad = DynamicBatcher(short, max_batch_size=2, max_latency_ms=30)
    with pytest.raises(BatchSizeMismatch):
        await bad.submit([1, 2])
