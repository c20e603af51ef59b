"""The port's multi-device serving against the JAX package on the CPU
(the port's counterpart of tests/test_multichip_serving.py).

A config ``mesh`` reaches TorchModel's load path (parallel/): this
process is rank 0, the other ranks are follower processes over gloo on
the CPU, every batch runs on every rank, and the answers come back over
the port's HTTP server.  They are held against the JAX package's
unsharded model on the same weights (fp32, 1e-4).  The decoder serves
tensor-parallel through GenerativeModel; its tokens are held against the
port's unsharded model and the JAX decoder's greedy forward.  After each
unload no follower process is left.
"""

import asyncio
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import serialization

from kfserving_tpu.models import create_model as jax_create_model
from kfserving_tpu.models import init_params
from kfserving_tpu.models.registry import apply_fn_for as jax_apply_fn_for

from kfserving_tpu_torch.predictors.llm import GenerativeModel
from kfserving_tpu_torch.predictors.torch_model import TorchModel
from kfserving_tpu_torch.protocol.errors import InvalidInput
from kfserving_tpu_torch.server.app import ModelServer
from tests.torch_generation import ARCH as GEN_ARCH, TinyDecoder
from tests.torch_parity import randomized
from tests.torch_serving import arequest

BERT = {"architecture": "bert_tiny",
        "arch_kwargs": {"seq_len": 16, "dtype": "float32"},
        "max_batch_size": 4, "max_latency_ms": 2.0, "warmup": False,
        "output": "logits"}
TOL = 1e-4


def _write(path, config, checkpoint=None) -> str:
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)
    if checkpoint is not None:
        with open(os.path.join(path, "checkpoint.msgpack"), "wb") as f:
            f.write(checkpoint)
    return path


@pytest.fixture(scope="module")
def bert(tmp_path_factory):
    """bert_tiny (fp32) weights as a Flax checkpoint, three requests and
    the JAX package's unsharded answers to them."""
    spec = jax_create_model("bert_tiny", seq_len=16, dtype=jnp.float32)
    variables = randomized(init_params(spec))
    ids = np.random.default_rng(0).integers(1, 1024, size=(3, 16))
    batch = {"input_ids": ids.astype(np.int32),
             "attention_mask": np.ones((3, 16), np.int32)}
    expect = np.asarray(jax.jit(jax_apply_fn_for(spec))(variables, batch))
    return {"root": tmp_path_factory.mktemp("bert"), "ids": ids,
            "expect": expect,
            "checkpoint": serialization.to_bytes(variables)}


def _gone(pids) -> bool:
    for pid in pids:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            continue
        return False
    return True


async def _predict(port: int, model: str, ids) -> np.ndarray:
    status, _, body = await arequest(
        port, "POST", f"/v1/models/{model}:predict",
        {"instances": np.asarray(ids).tolist()})
    assert status == 200, body
    return np.asarray(json.loads(body)["predictions"], np.float32)


@pytest.mark.parametrize("mesh", [{"tp": 2}, {"dp": 2, "tp": 2},
                                  {"sp": 2}, {"dp": 2, "sp": 2}])
async def test_mesh_sharded_model_serves_with_parity(bert, mesh):
    """A config-mesh TorchModel serves through ModelServer, each rank
    holding its shard (tp: its heads and MLP slice; sp: ring attention
    through the hook over its sequence block), with parity to the JAX
    package's unsharded model."""
    name = "m" + "".join(f"{k}{v}" for k, v in sorted(mesh.items()))
    model_dir = _write(str(bert["root"] / name), dict(BERT, mesh=mesh),
                       bert["checkpoint"])
    model = TorchModel(name, model_dir, device="cpu")
    await asyncio.to_thread(model.load)
    pids = list(model.engine._leader.pids)
    ranks = int(np.prod(list(mesh.values())))
    assert len(pids) == ranks - 1
    cfg = model.module.config
    query = model.module.layers[0].attention.query.weight
    assert query.shape[0] == 128 // mesh.get("tp", 1)
    assert (cfg.tp_group is not None) == ("tp" in mesh)
    assert (cfg.attn_fn is not None) == ("sp" in mesh)
    assert not model.offloadable and model.engine.host_params is None
    server = ModelServer(http_port=0)
    await server.start_async([model], host="127.0.0.1")
    try:
        out = await _predict(server.http_port, name, bert["ids"])
        single = await _predict(server.http_port, name, bert["ids"][:1])
    finally:
        await server.stop_async()
        model.unload()
    np.testing.assert_allclose(out, bert["expect"], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(single, bert["expect"][:1], atol=TOL,
                               rtol=TOL)
    assert _gone(pids)


async def test_spec_parallelism_reaches_served_engine(bert):
    """ParallelismSpec(tp=2) on an InferenceService: the port's
    orchestrator builds the TorchModel with the mesh override, its engine
    holds a tp shard with one follower, and the ingress router answers
    with the JAX package's unsharded logits."""
    from kfserving_tpu_torch.control.controller import Controller
    from kfserving_tpu_torch.control.orchestrator import (
        InProcessOrchestrator,
    )
    from kfserving_tpu_torch.control.router import IngressRouter
    from kfserving_tpu_torch.control.spec import (
        InferenceService,
        ParallelismSpec,
        PredictorSpec,
    )

    model_dir = _write(str(bert["root"] / "spec"), BERT, bert["checkpoint"])
    orch = InProcessOrchestrator(device="cpu")
    controller = Controller(orch)
    router = IngressRouter(controller)
    await router.start_async()
    try:
        await controller.apply(InferenceService(
            name="tpbert", predictor=PredictorSpec(
                framework="jax", storage_uri=f"file://{model_dir}",
                parallelism=ParallelismSpec(tp=2))))
        replicas = orch.replicas("default/tpbert/predictor")
        model = replicas[0].handle.repository.get_model("tpbert")
        assert model.config.mesh == {"dp": 1, "tp": 2, "sp": 1}
        pids = list(model.engine._leader.pids)
        assert len(pids) == 1
        assert model.module.layers[0].attention.query.weight.shape[0] == 64
        out = await _predict(router.http_port, "tpbert", bert["ids"][:2])
        np.testing.assert_allclose(out, bert["expect"][:2], atol=TOL,
                                   rtol=TOL)
    finally:
        await router.stop_async()
        await orch.shutdown()
    assert _gone(pids)


@pytest.mark.parametrize("arch", ["mlp", "vit_tiny"])
def test_sp_mesh_rejects_non_pluggable_arch(tmp_path, arch):
    """sp > 1 on an architecture whose input the engine cannot split
    along a sequence fails at load, before any rank starts."""
    kwargs = ({"input_dim": 8, "features": [16], "num_classes": 4}
              if arch == "mlp" else {})
    model = TorchModel("m", _write(str(tmp_path / "m"), {
        "architecture": arch, "arch_kwargs": kwargs, "mesh": {"sp": 2},
        "warmup": False}), device="cpu")
    with pytest.raises(InvalidInput, match="sequence parallelism"):
        model.load()
    assert model.engine is None


# -- the decoder, tensor parallel -------------------------------------------
GEN = {"architecture": "decoder_tiny", "arch_kwargs": GEN_ARCH,
       "max_slots": 4, "max_seq": GEN_ARCH["max_seq"],
       "prefill_buckets": [32, 128], "block_size": 16, "cache_blocks": 32,
       "steps_per_call": 4, "max_new_tokens": 12, "tokenizer": "byte"}


@pytest.fixture(scope="module")
def decoder(tmp_path_factory):
    tiny = TinyDecoder(dict(GEN_ARCH, vocab_size=384))
    root = tmp_path_factory.mktemp("gen")
    checkpoint = serialization.to_bytes(tiny.variables)
    arch = dict(GEN_ARCH, vocab_size=384)
    plain = _write(str(root / "plain"), dict(GEN, arch_kwargs=arch),
                   checkpoint)
    sharded = _write(str(root / "tp2"), dict(GEN, arch_kwargs=arch,
                                             mesh={"tp": 2}), checkpoint)
    return tiny, plain, sharded


async def test_tp_decoder_matches_unsharded_and_jax_greedy(decoder):
    """decoder_tiny under {"tp": 2}: the same text and token_count as
    the port's unsharded model (streams admitted together share
    prefills and waves), every token the JAX decoder's greedy choice
    teacher-forced; the KV pool holds half the heads a rank."""
    tiny, plain_dir, sharded_dir = decoder
    prompts = ["parity check", "the quick brown fox", "a", "tp" * 9]
    plain = GenerativeModel("plain", plain_dir, device="cpu")
    sharded = GenerativeModel("tp2", sharded_dir, device="cpu")
    await asyncio.to_thread(plain.load)
    await asyncio.to_thread(sharded.load)
    leader = sharded.engine._leader
    pids = list(leader.pids)
    try:
        assert len(pids) == 1
        assert sharded.engine.cache_bytes() * 2 == plain.engine.cache_bytes()
        assert sharded.engine.param_bytes() < plain.engine.param_bytes()
        report = (await asyncio.to_thread(leader.ask, ("report",)))[0]
        assert report["cache_bytes"] == sharded.engine.cache_bytes()
        assert report["param_bytes"] == sharded.engine.param_bytes()

        async def run(model):
            return await asyncio.gather(*[
                model.predict({"instances": [{"prompt": p,
                                              "max_tokens": 12}]})
                for p in prompts])

        want, got = await run(plain), await run(sharded)
        stream = [e async for e in sharded.engine.stream(
            sharded.engine.submit(sharded.tokenizer.encode(prompts[1]),
                                  max_new_tokens=12))]
    finally:
        await plain.close()
        await sharded.close()
        sharded.unload()
    for a, b in zip(want, got):
        assert a["predictions"][0]["text"] == b["predictions"][0]["text"]
        assert (a["predictions"][0]["token_count"]
                == b["predictions"][0]["token_count"])
    tokens = [t for t, _ in stream if t is not None]
    ids = sharded.tokenizer.encode(prompts[1])
    assert tokens == tiny.greedy(ids, len(tokens))
    assert _gone(pids)


RANK0 = """
import json, time
from kfserving_tpu_torch.parallel.follower import Leader
from kfserving_tpu_torch.parallel.mesh import MeshConfig
leader = Leader(MeshConfig(tp=2), ["cpu"] * 2, "gloo", {"kind": "spmd"})
leader.join().wait_ready()
print(json.dumps(leader.pids), flush=True)
time.sleep(600)
"""


def test_followers_exit_when_rank0_dies():
    """SIGKILL rank 0 (no unload, no stop command): its followers go
    with it (pipe EOF, and PR_SET_PDEATHSIG once the forkserver follows
    rank 0)."""
    import signal
    import subprocess
    import sys
    import time

    proc = subprocess.Popen([sys.executable, "-c", RANK0],
                            stdout=subprocess.PIPE, text=True)
    try:
        pids = json.loads(proc.stdout.readline())
        assert len(pids) == 1 and not _gone(pids)
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait()
    deadline = time.monotonic() + 15
    while not _gone(pids) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert _gone(pids)
