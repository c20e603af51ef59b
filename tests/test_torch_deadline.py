"""Deadlines, admission and the ``dataplane.infer`` fault site of the
port against the JAX package's, on the CPU: the same requests to a JAX
ModelServer and to the port's must answer with the same status codes
(504 from the admission queue, the batch queue and the engine dispatch,
503 from a full admission queue), and a generate stream whose budget runs
out ends with finish_reason "timeout".
"""

import asyncio
import json

import numpy as np
import pytest
import torch
from torch_serving import (
    MLP_CONFIG,
    arequest,
    load_models,
    serve,
    write_artifact,
)

import kfserving_tpu
from kfserving_tpu.engine.jax_engine import JaxEngine
from kfserving_tpu.reliability import deadline as jax_deadline
from kfserving_tpu.reliability.faults import faults as jax_faults
from kfserving_tpu_torch.engine.buckets import BucketPolicy
from kfserving_tpu_torch.engine.torch_engine import TorchEngine
from kfserving_tpu_torch.model.model import Model
from kfserving_tpu_torch.observability import REGISTRY
from kfserving_tpu_torch.observability import metrics as obs
from kfserving_tpu_torch.predictors.llm import GenerativeModel
from kfserving_tpu_torch.reliability import deadline
from kfserving_tpu_torch.reliability.faults import faults
from kfserving_tpu_torch.server.app import ModelServer

HOLD_S = 1.0        # how long the slow model holds its admission slot


@pytest.fixture(autouse=True)
def _isolated():
    REGISTRY.reset()
    yield
    REGISTRY.reset()
    faults.reset()
    jax_faults.reset()


class _SlowPort(Model):
    async def predict(self, request):
        await asyncio.sleep(HOLD_S)
        return {"predictions": request["instances"]}


class _SlowJax(kfserving_tpu.Model):
    async def predict(self, request):
        await asyncio.sleep(HOLD_S)
        return {"predictions": request["instances"]}


async def _admission_run(server):
    """Slot held by a slow request; a budgeted request queues and times
    out (504); one more finds the queue full (503)."""
    port = server.http_port
    path = "/v1/models/slow:predict"
    held = asyncio.ensure_future(arequest(port, "POST", path,
                                          {"instances": [1]}))
    await asyncio.sleep(0.2)
    queued = asyncio.ensure_future(arequest(
        port, "POST", path, {"instances": [2]},
        headers={"x-request-timeout-ms": "400"}))
    await asyncio.sleep(0.15)
    full = await arequest(port, "POST", path, {"instances": [3]})
    results = [await held, await queued, full]
    spent = await arequest(port, "POST", path, {"instances": [4]},
                           headers={"x-request-timeout-ms": "0.001"})
    return [(status, json.loads(body)) for status, _, body in
            results + [spent]]


@pytest.mark.parametrize("kind", ["jax", "torch"])
def test_admission_queue_sheds(kind):
    model = _SlowJax("slow") if kind == "jax" else _SlowPort("slow")
    model.load()
    got = asyncio.run(serve(kind, [model], _admission_run,
                            container_concurrency=1, max_queue_depth=1))
    assert [status for status, _ in got] == [200, 504, 503, 504]
    assert got[0][1] == {"predictions": [1]}
    assert got[1][1]["error"] == got[3][1]["error"] == \
        "request deadline exceeded (admission queue)"
    assert got[2][1]["error"] == "concurrency limit exceeded"


def test_port_parser_takes_container_concurrency():
    from kfserving_tpu.server.app import parser as jax_parser
    from kfserving_tpu_torch.server.app import parser

    args = parser.parse_args(["--container_concurrency", "3"])
    assert args.container_concurrency == 3
    assert jax_parser.parse_known_args(
        ["--container_concurrency", "3"])[0].container_concurrency == 3
    server = ModelServer(http_port=0, container_concurrency=3)
    assert (server._admission.limit, server.max_queue_depth) == (3, 8)
    assert ModelServer(http_port=0)._admission is None


async def _batch_queue_run(server):
    """An mlp whose batcher waits 1 s for more instances: a request with a
    150 ms budget expires in the batch queue; an unbudgeted one is
    served once the batch flushes."""
    port = server.http_port
    rows = np.random.default_rng(0).standard_normal((1, 64)).tolist()
    path = "/v1/models/mlp:predict"
    budgeted = await arequest(port, "POST", path, {"instances": rows},
                              headers={"x-request-timeout-ms": "150"})
    served = await arequest(port, "POST", path, {"instances": rows})
    return [(status, json.loads(body)) for status, _, body in
            (budgeted, served)]


@pytest.mark.parametrize("kind", ["jax", "torch"])
def test_batch_queue_sheds(kind, tmp_path):
    cfg = dict(MLP_CONFIG, max_latency_ms=1000)
    artifacts = {"mlp": write_artifact(str(tmp_path), "mlp", cfg)}
    got = asyncio.run(serve(kind, load_models(kind, artifacts),
                            _batch_queue_run))
    assert [status for status, _ in got] == [504, 200]
    assert got[0][1]["error"] == \
        "request deadline exceeded (expired in batch queue)"
    if kind == "torch":
        assert obs.deadline_exceeded_total().labels(
            stage="expired in batch queue").value == 1


def test_engine_dispatch_sheds():
    """An engine call under a spent budget fails 504 before any device
    work, in both packages; a call with no budget (a batch: the batcher
    clears it) runs."""
    import jax.numpy as jnp

    from kfserving_tpu.engine.buckets import BucketPolicy as JaxBuckets

    jax_engine = JaxEngine(lambda p, x: x * p, jnp.float32(2.0),
                           batch_buckets=JaxBuckets([1, 2]))
    port_engine = TorchEngine(lambda m, x: x * 2.0, torch.nn.Linear(1, 1),
                              batch_buckets=BucketPolicy([1, 2]),
                              device="cpu")
    x = np.ones((1, 3), np.float32)

    async def run(engine, module):
        with module.deadline_scope(module.Deadline(1e-9)):
            await asyncio.sleep(0.001)
            try:
                await engine.predict(x)
            except module.DeadlineExceeded as e:
                return e

    jax_err = asyncio.run(run(jax_engine, jax_deadline))
    port_err = asyncio.run(run(port_engine, deadline))
    assert isinstance(port_err, deadline.DeadlineExceeded)
    assert (port_err.status_code, port_err.reason) == \
        (jax_err.status_code, jax_err.reason) == \
        (504, "request deadline exceeded (engine dispatch)")
    assert obs.deadline_exceeded_total().labels(
        stage="engine dispatch").value == 1
    executed = port_engine.execute_count

    async def unbudgeted():
        return await port_engine.predict(x)

    np.testing.assert_array_equal(asyncio.run(unbudgeted()), x * 2.0)
    assert port_engine.execute_count == executed + 1
    port_engine.close()


@pytest.mark.parametrize("kind", ["jax", "torch"])
def test_dataplane_infer_fault_site(kind, tmp_path, monkeypatch):
    monkeypatch.setenv("KFS_FAULTS", json.dumps(
        {"dataplane.infer": {"fail_first": 1, "match": "mlp"}}))
    faults.reset()
    jax_faults.reset()
    artifacts = {"mlp": write_artifact(str(tmp_path), "mlp", MLP_CONFIG)}
    rows = np.zeros((1, 64)).tolist()

    async def run(server):
        return [(await arequest(server.http_port, "POST",
                                "/v1/models/mlp:predict",
                                {"instances": rows}))[0]
                for _ in range(2)]

    assert asyncio.run(serve(kind, load_models(kind, artifacts), run)) == \
        [500, 200]


# -- the generate stream's budget -------------------------------------------
GEN_CONFIG = {"architecture": "decoder_tiny",
              "arch_kwargs": dict(num_layers=2, hidden_size=64, num_heads=2,
                                  intermediate_size=128, max_seq=128),
              "max_slots": 2, "max_seq": 128, "prefill_buckets": [32, 128],
              "block_size": 16, "cache_blocks": 16, "steps_per_call": 2,
              "tokenizer": "byte"}


@pytest.fixture
def generator(tmp_path):
    model = GenerativeModel("gen", write_artifact(str(tmp_path), "gen",
                                                  GEN_CONFIG),
                            device="cpu")
    model.load()
    yield model
    model.unload()


class _Budget:
    """A deadline whose expiry the test sets (the engine reads only
    ``expired``)."""
    expired = False


def test_stream_times_out_mid_generation(generator):
    engine = generator.engine

    async def run():
        budget = _Budget()
        with deadline.deadline_scope(budget):
            req = engine.submit(list(b"hello there"), max_new_tokens=100)
        events = []
        async for token, reason in engine.stream(req):
            events.append((token, reason))
            if len(events) == 3:
                budget.expired = True
        for _ in range(100):
            if all(s is None for s in engine._slots):
                break
            await asyncio.sleep(0.01)
        return events

    events = asyncio.run(run())
    assert events[-1] == (None, "timeout")
    assert 3 <= len(events) - 1 < 100
    assert all(s is None for s in engine._slots)
    assert engine.stats()["requests_finished"] == 1


def test_stream_with_spent_budget_ends_timeout_over_http(generator):
    async def run(server):
        status, _, body = await arequest(
            server.http_port, "POST", "/v2/models/gen/generate_stream",
            {"text_input": "hello", "max_tokens": 100},
            headers={"x-request-timeout-ms": "0.001"})
        return status, body

    server_models = [generator]
    status, body = asyncio.run(_serve_keep(server_models, run))
    events = [json.loads(line[len(b"data: "):])
              for line in body.split(b"\n\n") if line.startswith(b"data: ")]
    assert status == 200
    assert events[-1]["finish_reason"] == "timeout"
    assert all(s is None for s in generator.engine._slots)


async def _serve_keep(models, drive):
    server = ModelServer(http_port=0)
    await server.start_async(models, host="127.0.0.1")
    try:
        return await drive(server)
    finally:
        await server.stop_async()
        # The engine's scheduler task belongs to this event loop.
        for model in models:
            await model.engine.close()


def test_generator_refuses_shapes_either_kernel_lacks():
    """On a CUDA device the engine checks K1's head dims as well as K2's
    at construction.  Both are built for one set (16, 32, 64, 80, 96,
    128, 192, 256): head dim 48 is in neither, and the refusal names the
    set; 16, decoder_tiny's 32, 80 and 256 are in both, paged or dense.
    K2's own gate, which the paged mode adds, refuses 48 naming it."""
    from kfserving_tpu_torch.engine.generator import check_device_shapes
    from kfserving_tpu_torch.models import create_model
    from kfserving_tpu_torch.ops.paged_attention import check_head_dim
    from kfserving_tpu_torch.protocol.errors import InvalidInput

    cuda = torch.device("cuda")
    module = create_model("decoder_tiny", **GEN_CONFIG["arch_kwargs"]).module
    check_device_shapes(module, torch.device("cpu"))
    check_device_shapes(module, cuda)
    d48 = create_model("decoder_tiny", num_heads=2, hidden_size=96).module
    check_device_shapes(d48, torch.device("cpu"))
    with pytest.raises(InvalidInput, match=r"flash attention kernel .*"
                       r"\(16, 32, 64, 80, 96, 128, 192, 256\)"):
        check_device_shapes(d48, cuda)
    with pytest.raises(InvalidInput, match=r"paged decode kernel .*"
                       r"\(16, 32, 64, 80, 96, 128, 192, 256\)"):
        check_head_dim(torch.float32, 48)
    d16 = create_model("decoder_tiny", num_heads=4, hidden_size=64).module
    check_device_shapes(d16, cuda)
    check_device_shapes(d16, cuda, paged=False)
    for hidden in (160, 512):                      # head dims 80 and 256
        wide = create_model("decoder_tiny", num_heads=2, hidden_size=hidden,
                            dtype=torch.bfloat16).module
        check_device_shapes(wide, cuda)
    wide = create_model("decoder_tiny", num_heads=1, hidden_size=64,
                        dtype=torch.bfloat16).module
    check_device_shapes(wide, cuda)


# Since the parallel layer a mesh of several devices is served; the
# config refuses an axis below 1.
@pytest.mark.parametrize("mesh,refused", [
    ({"tp": 0}, True), ({"dp": 1, "tp": 1, "sp": 1}, False), ({}, False),
    (None, False)])
def test_predict_config_refuses_a_mesh(mesh, refused):
    from kfserving_tpu_torch.predictors.torch_model import TorchModelConfig
    from kfserving_tpu_torch.protocol.errors import InvalidInput

    if refused:
        with pytest.raises(InvalidInput, match="mesh"):
            TorchModelConfig(architecture="mlp", mesh=mesh)
    else:
        TorchModelConfig(architecture="mlp", mesh=mesh)
