"""Demand-paged residency of the port (``kfserving_tpu_torch/engine/
residency.py``, the admission-aware ``engine/hbm.py``, ``TorchEngine``'s
``offload``/``restore`` and the demand-paged ``TorchModelRepository``) on
the CPU.  Ports the residency cases of ``tests/test_residency.py`` with
the catalog ``mlp``, ``bert_tiny`` and a reduced ResNet, and holds the
port against the JAX package on one scenario: the same catalog, the same
traffic, the same states, ledger and fault counts, and served answers
within 0.02 (the bf16 MLP; logits are O(1)).  A restore is held bit for
bit against the answers before the offload.

The flight-recorder pin of an eviction storm
(``test_residency.py::test_eviction_storm_pins_flight_recorder``) waits
for the port's flight recorder (ROADMAP Queue 1 item g); the storm count
it rests on is tested here.
"""

import asyncio
import json
import os

import jax
import numpy as np
import pytest
import torch
from flax import serialization
from torch_parity import randomized

from kfserving_tpu.engine.hbm import HBMManager as JaxHBMManager
from kfserving_tpu.models import create_model as jax_create_model
from kfserving_tpu.predictors.jaxserver import JaxModelRepository
from kfserving_tpu.reliability.faults import faults as jax_faults
from kfserving_tpu_torch.engine.hbm import HBMManager, InsufficientHBM
from kfserving_tpu_torch.engine.torch_engine import TorchEngine, module_bytes
from kfserving_tpu_torch.models import create_model
from kfserving_tpu_torch.models import registry as port_registry
from kfserving_tpu_torch.models import weights
from kfserving_tpu_torch.models.resnet import ResNet
from kfserving_tpu_torch.predictors.jaxserver.repository import (
    TorchModelRepository,
)
from kfserving_tpu_torch.reliability import fault_sites
from kfserving_tpu_torch.reliability.faults import faults

X = {"instances": np.ones((1, 8)).tolist()}
MLP_KWARGS = {"input_dim": 8, "features": [16], "num_classes": 3}
BF16_ATOL = 0.02
REDUCED = dict(stage_sizes=[1, 1, 1, 1], num_filters=8, num_classes=7)


def _mlp_bytes() -> int:
    return module_bytes(create_model("mlp", **MLP_KWARGS).module)


def _write_models(root, n, arch="mlp", arch_kwargs=None, extra=None,
                  checkpoint=None):
    for i in range(n):
        d = os.path.join(str(root), f"m{i}")
        os.makedirs(d, exist_ok=True)
        cfg = {"architecture": arch,
               "arch_kwargs": MLP_KWARGS if arch_kwargs is None
               else arch_kwargs,
               "max_latency_ms": 2, "warmup": False}
        cfg.update(extra or {})
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(cfg, f)
        if checkpoint is not None:
            with open(os.path.join(d, "checkpoint.msgpack"), "wb") as f:
                f.write(checkpoint(i))


def _repo(root, budget=None, **kwargs):
    hbm = HBMManager(budget_bytes=budget or 2 * _mlp_bytes() + 100)
    return TorchModelRepository(models_dir=str(root), hbm=hbm,
                                device="cpu", **kwargs), hbm


@pytest.fixture(autouse=True)
def _reset_faults():
    yield
    faults.reset()
    jax_faults.reset()


# -- declarative registration -------------------------------------------------
def test_load_is_declarative_registration(tmp_path):
    _write_models(tmp_path, 2)
    repo, hbm = _repo(tmp_path)

    async def run():
        assert await repo.load("m0")
        m0 = repo.get_model("m0")
        assert m0.ready and m0.engine is None        # no device memory
        assert hbm.resident_models() == []
        assert repo.residency.state_of("m0") == "registered"
        resp = await m0.predict(X)                   # transparent fault
        assert len(resp["predictions"]) == 1
        assert repo.residency.state_of("m0") == "resident"
        assert hbm.resident_models() == ["m0"]
        assert repo.residency.debug()["models"]["m0"]["fault_ins"][
            "cold"] == 1
        assert m0.param_source == "init" and m0.offloadable

    asyncio.run(run())


def test_register_all_scans_catalog(tmp_path):
    _write_models(tmp_path, 5)
    os.makedirs(os.path.join(str(tmp_path), "not-a-model"))
    repo, hbm = _repo(tmp_path)
    names = repo.register_all()
    assert names == [f"m{i}" for i in range(5)]
    assert all(repo.is_model_ready(n) for n in names)
    assert hbm.resident_models() == []
    eager, _ = _repo(tmp_path, residency=False)
    with pytest.raises(RuntimeError, match="residency mode"):
        eager.register_all()


def test_register_all_isolates_a_corrupt_model(tmp_path):
    _write_models(tmp_path, 3)
    with open(os.path.join(str(tmp_path), "m1", "config.json"), "w") as f:
        f.write("{not json")
    repo, _ = _repo(tmp_path)
    assert repo.register_all() == ["m0", "m2"]
    assert repo.get_model("m1") is None
    assert repo.is_model_ready("m0") and repo.is_model_ready("m2")


def test_file_uri_catalog_root(tmp_path):
    _write_models(tmp_path, 2)
    repo = TorchModelRepository(models_dir=f"file://{tmp_path}",
                                hbm=HBMManager(budget_bytes=10 ** 6),
                                device="cpu")
    assert repo.register_all() == ["m0", "m1"]
    assert repo.models_dir == str(tmp_path)


# -- demand paging and eviction -----------------------------------------------
def test_eviction_offloads_and_warm_fault_restores(tmp_path):
    """Budget for two: the third predict offloads the LRU model, which
    keeps its engine and host params; its next predict warm-faults it
    back and serves the same bits."""
    _write_models(tmp_path, 3)
    repo, hbm = _repo(tmp_path)

    async def run():
        repo.register_all()
        first = await repo.get_model("m0").predict(X)
        await repo.get_model("m1").predict(X)
        await repo.get_model("m2").predict(X)        # evicts m0
        assert hbm.resident_models() == ["m1", "m2"]
        assert repo.residency.state_of("m0") == "host"
        m0 = repo.get_model("m0")
        assert m0.ready and m0.engine is not None
        assert m0.engine.param_bytes() == 0          # storage dropped
        again = await m0.predict(X)                  # warm fault
        assert again == first
        assert repo.residency.debug()["models"]["m0"]["fault_ins"] == {
            "cold": 1, "warm": 1, "coalesced": 0, "error": 0}
        assert sum(hbm.evictions.values()) >= 2
        assert hbm.used_bytes <= hbm.budget_bytes

    asyncio.run(run())


def test_predict_touches_lru_order(tmp_path):
    _write_models(tmp_path, 3)
    repo, hbm = _repo(tmp_path)

    async def run():
        repo.register_all()
        await repo.get_model("m0").predict(X)
        await repo.get_model("m1").predict(X)
        await repo.get_model("m0").predict(X)        # m0 -> MRU
        await repo.get_model("m2").predict(X)        # evicts m1
        assert hbm.resident_models() == ["m0", "m2"]

    asyncio.run(run())


def test_concurrent_fault_ins_coalesce_single_flight(tmp_path):
    _write_models(tmp_path, 2)
    repo, hbm = _repo(tmp_path)

    async def run():
        repo.register_all()
        m0 = repo.get_model("m0")
        await m0.predict(X)
        await repo.get_model("m1").predict(X)
        hbm.admit("filler", _mlp_bytes())            # forces m0 out
        assert repo.residency.state_of("m0") == "host"
        restores = []
        real = m0.engine.restore
        m0.engine.restore = lambda: restores.append(1) or real()
        answers = await asyncio.gather(*(m0.predict(X) for _ in range(8)))
        assert all(a == answers[0] for a in answers)
        assert len(restores) == 1                    # one transfer
        counts = repo.residency.debug()["models"]["m0"]["fault_ins"]
        assert counts["warm"] == 1 and counts["coalesced"] == 7

    asyncio.run(run())


def test_inflight_model_is_never_a_victim(tmp_path):
    _write_models(tmp_path, 1)
    repo, hbm = _repo(tmp_path, budget=_mlp_bytes())

    async def run():
        repo.register_all()
        await repo.get_model("m0").predict(X)
        async with repo.residency.serving("m0"):
            with pytest.raises(InsufficientHBM, match="busy"):
                hbm.admit("intruder", _mlp_bytes())
            assert hbm.resident_models() == ["m0"]
            assert repo.residency.state_of("m0") == "resident"
            assert hbm.eviction_skips.get("m0", 0) >= 1
        hbm.admit("intruder", _mlp_bytes())
        assert hbm.resident_models() == ["intruder"]
        assert repo.residency.state_of("m0") == "host"

    asyncio.run(run())


def test_fault_in_waits_for_busy_victims_to_free(tmp_path):
    _write_models(tmp_path, 2)
    repo, hbm = _repo(tmp_path, budget=_mlp_bytes())

    async def run():
        repo.register_all()
        m0, m1 = repo.get_model("m0"), repo.get_model("m1")
        await m0.predict(X)
        await m1.predict(X)
        gate = repo.residency.serving("m1")
        await gate.__aenter__()          # m1 busy: m0 cannot evict it
        try:
            task = asyncio.ensure_future(m0.predict(X))
            await asyncio.sleep(0.2)
            assert not task.done()
        finally:
            await gate.__aexit__(None, None, None)
        resp = await asyncio.wait_for(task, timeout=10)
        assert len(resp["predictions"]) == 1
        assert hbm.resident_models() == ["m0"]

    asyncio.run(run())


def test_permanent_insufficient_hbm_fails_at_once(tmp_path):
    _write_models(tmp_path, 1)
    repo, hbm = _repo(tmp_path, budget=_mlp_bytes() - 1)
    repo.residency.admit_wait_s = 30.0

    async def run():
        repo.register_all()
        with pytest.raises(InsufficientHBM) as err:
            await asyncio.wait_for(repo.get_model("m0").predict(X), 5)
        assert err.value.permanent
        assert repo.residency.state_of("m0") == "registered"

    asyncio.run(run())


# -- chaos --------------------------------------------------------------------
def test_failed_fault_in_keeps_incumbents_serving(tmp_path):
    """An injected failure at engine.residency_swap reaches the faulting
    request alone: the resident set is untouched and serves the same
    answers, and the next fault-in succeeds."""
    _write_models(tmp_path, 3)
    repo, hbm = _repo(tmp_path)
    x = {"instances": np.random.default_rng(0).normal(size=(2, 8)).tolist()}

    async def run():
        repo.register_all()
        m0, m1, m2 = (repo.get_model(f"m{i}") for i in range(3))
        before = [await m1.predict(x), await m2.predict(x)]
        faults.configure({fault_sites.ENGINE_RESIDENCY_SWAP: {
            "fail_first": 1, "match": "m0"}})
        with pytest.raises(Exception, match="injected fault at "
                                            "engine.residency_swap"):
            await m0.predict(x)
        assert hbm.resident_models() == ["m1", "m2"]
        assert repo.residency.state_of("m0") == "registered"
        assert [await m1.predict(x), await m2.predict(x)] == before
        assert len((await m0.predict(x))["predictions"]) == 2
        counts = repo.residency.debug()["models"]["m0"]["fault_ins"]
        assert counts["error"] == 1 and counts["cold"] == 1

    asyncio.run(run())


def test_failed_warm_restore_releases_the_booking(tmp_path):
    _write_models(tmp_path, 2)
    repo, hbm = _repo(tmp_path, budget=_mlp_bytes())

    async def run():
        repo.register_all()
        m0, m1 = repo.get_model("m0"), repo.get_model("m1")
        first = await m0.predict(X)
        await m1.predict(X)                          # m0 -> host
        m0.engine.restore = lambda: (_ for _ in ()).throw(
            RuntimeError("restore failed"))
        with pytest.raises(RuntimeError, match="restore failed"):
            await m0.predict(X)
        assert repo.residency.state_of("m0") == "host"
        assert "m0" not in hbm.resident_models()
        del m0.engine.restore                        # the real one again
        assert await m0.predict(X) == first

    asyncio.run(run())


def test_eviction_storm_is_counted(tmp_path):
    _write_models(tmp_path, 2)
    repo, _ = _repo(tmp_path, budget=_mlp_bytes())
    repo.residency.storm_threshold = 2
    repo.residency.storm_window_s = 60.0

    async def run():
        repo.register_all()
        for _ in range(3):                           # m0 <-> m1 thrash
            await repo.get_model("m0").predict(X)
            await repo.get_model("m1").predict(X)

    asyncio.run(run())
    debug = repo.residency.debug()
    assert debug["eviction_storms"] == 1             # one per window
    assert debug["evictions_total"] == 5


def test_cache_disabled_model_is_demoted(tmp_path, monkeypatch):
    """No host restore source: the victim is demoted to registered and
    cold-faults a fresh build on its next predict."""
    monkeypatch.setenv("KFS_PARAM_CACHE", "off")
    _write_models(tmp_path, 2)
    repo, hbm = _repo(tmp_path, budget=_mlp_bytes())

    async def run():
        repo.register_all()
        m0 = repo.get_model("m0")
        first = await m0.predict(X)
        await repo.get_model("m1").predict(X)
        assert repo.residency.state_of("m0") == "registered"
        assert m0.engine is None and m0.ready
        assert await m0.predict(X) == first
        assert repo.residency.debug()["models"]["m0"]["fault_ins"][
            "cold"] == 2

    asyncio.run(run())


# -- the ledger ---------------------------------------------------------------
def test_hbm_victim_release_on_failed_plan():
    hbm = HBMManager(budget_bytes=100)
    released = []
    hbm.victim_release = released.append
    hbm.admit("a", 60)
    hbm.admit("b", 40)
    hbm.victim_ok = lambda name: name == "a"
    with pytest.raises(InsufficientHBM):
        hbm.admit("c", 90)
    assert released == ["a"]
    assert hbm.resident_models() == ["a", "b"]
    assert hbm.eviction_skips.get("b") == 1
    with pytest.raises(InsufficientHBM):              # a retry: same
        hbm.admit("c", 90)                           # episode
    assert hbm.eviction_skips.get("b") == 1
    hbm.end_skip_episode("c")
    with pytest.raises(InsufficientHBM):
        hbm.admit("c", 90)
    assert hbm.eviction_skips.get("b") == 2
    assert hbm.debug()["eviction_skips"] == {"b": 2}


def test_hbm_victim_bytes_accounted_until_physical_offload():
    hbm = HBMManager(budget_bytes=100)
    seen = {}

    def evict_cb(name):
        seen["used"] = hbm.used_bytes
        seen["resident"] = set(hbm.resident_models())

    hbm.evict_cb = evict_cb
    hbm.admit("a", 60)
    assert hbm.admit("b", 60) == ["a"]
    assert seen == {"used": 120, "resident": {"a", "b"}}
    assert hbm.resident_models() == ["b"] and hbm.used_bytes == 60


def test_hbm_failed_evict_cb_does_not_strand_later_victims():
    hbm = HBMManager(budget_bytes=100)
    offloaded = []

    def evict_cb(name):
        if name == "a":
            raise RuntimeError("offload blew up")
        offloaded.append(name)

    hbm.evict_cb = evict_cb
    hbm.admit("a", 60)
    hbm.admit("b", 40)
    assert hbm.admit("c", 100) == ["a", "b"]
    assert offloaded == ["b"]
    assert hbm.resident_models() == ["c"]


@pytest.mark.parametrize("cls", [HBMManager, JaxHBMManager])
def test_ledger_matches_the_jax_package(cls):
    """One admission script through both ledgers: the same victims, LRU
    order, skips and errors."""
    hbm = cls(budget_bytes=100)
    busy = {"b"}
    hbm.victim_ok = lambda name: name not in busy
    log = [hbm.admit("a", 40), hbm.admit("b", 40)]
    hbm.touch("a")
    log.append(hbm.admit("c", 50))                   # b busy -> a goes
    with pytest.raises(InsufficientHBM if cls is HBMManager
                       else Exception) as err:
        hbm.admit("d", 101)
    log.append(err.value.permanent)
    busy.clear()
    log.append(hbm.admit("d", 60))
    log.append(hbm.resident_models())
    log.append(dict(hbm.eviction_skips))
    assert log == [[], [], ["a"], True, ["b", "c"], ["d"], {"b": 1}]


# -- the engine ---------------------------------------------------------------
class _Tied(torch.nn.Module):
    """An embedding whose matrix is also the output head (one Parameter
    under two names), and a buffer."""

    def __init__(self):
        super().__init__()
        self.embed = torch.nn.Embedding(10, 4)
        self.head = torch.nn.Linear(4, 10, bias=False)
        self.head.weight = self.embed.weight
        self.register_buffer("shift", torch.arange(4, dtype=torch.float32))

    def forward(self, ids):
        return self.head(self.embed(ids) + self.shift)


def _host(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def test_engine_offload_guard():
    """A straggler that reaches an offloaded engine raises; it never
    reads freed memory.  Storage, not the Parameter objects, goes."""
    module = torch.nn.Linear(4, 3)
    params = list(module.parameters())
    eng = TorchEngine(lambda m, x: m(x), module, device="cpu",
                      host_params=_host(module))
    x = np.ones((2, 4), np.float32)
    out = eng.predict_sync(x)
    assert eng.offloadable and eng.host_param_bytes() == (12 + 3) * 4
    assert eng.offload()
    assert eng.param_bytes() == 0
    assert all(p.untyped_storage().nbytes() == 0 for p in params)
    with pytest.raises(RuntimeError, match="offloaded"):
        eng.predict_sync(x)
    assert eng.restore() >= 0.0
    assert list(module.parameters()) == params and \
        all(a is b for a, b in zip(module.parameters(), params))
    np.testing.assert_array_equal(eng.predict_sync(x), out)
    eng.close()
    plain = TorchEngine(lambda m, x: m(x), torch.nn.Linear(4, 3),
                        device="cpu")
    assert not plain.offloadable and not plain.offload()
    with pytest.raises(RuntimeError, match="no host params"):
        plain.restore()
    with pytest.raises(ValueError, match="do not match"):
        TorchEngine(lambda m, x: m(x), torch.nn.Linear(4, 3), device="cpu",
                    host_params={"weight": torch.zeros(3, 4)})


def test_restore_keeps_ties_and_buffers():
    torch.manual_seed(0)
    module = _Tied().eval()
    eng = TorchEngine(lambda m, x: m(x), module, device="cpu",
                      host_params=_host(module))
    ids = np.array([[1, 2, 3]], np.int64)
    before = eng.predict_sync(ids)
    assert eng.host_param_bytes() == (40 + 4) * 4    # the tie counted once
    eng.offload()
    assert module.shift.numel() == 0 and module.embed.weight.numel() == 0
    eng.restore()
    assert module.head.weight is module.embed.weight
    assert module.head.weight.data_ptr() == module.embed.weight.data_ptr()
    np.testing.assert_array_equal(eng.predict_sync(ids), before)


def test_restore_keeps_channels_last_and_resnet_outputs():
    """A reduced ResNet (bf16, BatchNorm buffers): after offload and
    restore every conv weight is channels-last again and the logits are
    the same bits."""
    with torch.device("meta"):
        module = ResNet(**REDUCED, image_size=32)
    module = weights.materialize(module, torch.device("cpu"), seed=3)
    eng = TorchEngine(lambda m, x: m(x), module, device="cpu",
                      host_params=_host(module))
    x = np.random.default_rng(0).uniform(size=(2, 32, 32, 3)).astype(
        np.float32)
    before = eng.predict_sync(x)
    convs = [p for p in module.parameters() if p.dim() == 4]
    strides = [p.stride() for p in convs]
    # 3x3 kernels are laid out otherwise than contiguous (1x1 are both).
    assert any(not p.is_contiguous() for p in convs)
    assert all(p.is_contiguous(memory_format=torch.channels_last)
               for p in convs)
    eng.offload()
    eng.restore()
    assert [p.stride() for p in convs] == strides
    assert all(p.is_contiguous(memory_format=torch.channels_last)
               for p in convs)
    # One device block for the model, each tensor at an aligned offset.
    tensors = list(module.parameters()) + list(module.buffers())
    assert len({t.untyped_storage().data_ptr() for t in tensors}) == 1
    assert all(t.storage_offset() * t.element_size() % 256 == 0
               for t in tensors)
    np.testing.assert_array_equal(eng.predict_sync(x), before)


def test_resnet_and_bert_warm_faults_serve_the_same_answers(tmp_path,
                                                            monkeypatch):
    """Demand-paged bert_tiny (top-5, tied MLM decoder) and the reduced
    ResNet (uint8 wire) under a one-model budget: every warm fault
    serves what the cold build served, bit for bit."""
    monkeypatch.setitem(port_registry._REGISTRY, "resnet_reduced",
                        lambda image_size=32: (_meta_resnet(image_size),
                                               np.zeros((1, image_size,
                                                         image_size, 3),
                                                        np.float32)))
    os.makedirs(os.path.join(str(tmp_path), "bert"))
    with open(os.path.join(str(tmp_path), "bert", "config.json"), "w") as f:
        json.dump({"architecture": "bert_tiny",
                   "arch_kwargs": {"seq_len": 16}, "seq_buckets": [16],
                   "batch_buckets": [1, 2], "max_latency_ms": 2,
                   "warmup": False, "output": "topk", "topk": 5}, f)
    os.makedirs(os.path.join(str(tmp_path), "resnet"))
    with open(os.path.join(str(tmp_path), "resnet", "config.json"),
              "w") as f:
        json.dump({"architecture": "resnet_reduced",
                   "batch_buckets": [1, 2], "max_latency_ms": 2,
                   "warmup": False, "input_dtype": "uint8",
                   "scale": 1 / 255.0, "output": "logits"}, f)
    hbm = HBMManager()
    repo = TorchModelRepository(models_dir=str(tmp_path), hbm=hbm,
                                device="cpu")
    ids = {"instances": [[5, 6, 7, 8, 9, 10, 11]]}
    img = {"instances": np.random.default_rng(1).integers(
        0, 256, (1, 32, 32, 3)).tolist()}

    hbm.budget_bytes = max(
        module_bytes(create_model("bert_tiny", seq_len=16).module),
        module_bytes(_meta_resnet(32)))

    async def run():
        assert repo.register_all() == ["bert", "resnet"]
        bert, resnet = repo.get_model("bert"), repo.get_model("resnet")
        first = [await bert.predict(ids), await resnet.predict(img)]
        assert repo.residency.state_of("bert") == "host"
        word = bert.module.word_embeddings.weight
        for _ in range(2):
            assert await bert.predict(ids) == first[0]
            assert repo.residency.state_of("resnet") == "host"
            assert await resnet.predict(img) == first[1]
            assert repo.residency.state_of("bert") == "host"
        assert bert.module.word_embeddings.weight is word
        counts = {n: repo.residency.debug()["models"][n]["fault_ins"]
                  for n in ("bert", "resnet")}
        assert counts["bert"]["warm"] == 2 and counts["resnet"]["warm"] == 2

    asyncio.run(run())


def _meta_resnet(image_size):
    with torch.device("meta"):
        return ResNet(**REDUCED, image_size=image_size)


# -- one scenario through both packages ---------------------------------------
def _mlp_checkpoint(i: int) -> bytes:
    spec = jax_create_model("mlp", **MLP_KWARGS)
    shapes = jax.eval_shape(lambda: spec.module.init(
        jax.random.PRNGKey(0), spec.example))
    return serialization.to_bytes(randomized(shapes, 10 + i))


def test_scenario_matches_the_jax_package(tmp_path):
    """Four catalog MLPs (one checkpoint each) under a two-model budget,
    the same predicts through the JAX package's JaxModelRepository and
    the port's: after every request the same states, the same ledger
    order and the same fault counts; answers within 0.02."""
    _write_models(tmp_path, 4, checkpoint=_mlp_checkpoint)
    jax_bytes = 4 * (8 * 16 + 16 + 16 * 3 + 3)       # fp32 Flax params
    jax_repo = JaxModelRepository(
        models_dir=str(tmp_path),
        hbm=JaxHBMManager(budget_bytes=2 * jax_bytes + 100))
    port_repo, _ = _repo(tmp_path)
    order = ["m0", "m1", "m2", "m0", "m3", "m1", "m1", "m2", "m3", "m0"]
    x = {"instances": np.random.default_rng(2).normal(size=(2, 8)).tolist()}

    async def trace(repo):
        assert repo.register_all() == ["m0", "m1", "m2", "m3"]
        steps = []
        for name in order:
            resp = await repo.get_model(name).predict(x)
            debug = repo.residency.debug()
            steps.append((resp["predictions"],
                          {n: m["state"] for n, m in
                           debug["models"].items()},
                          repo.hbm.resident_models(),
                          {n: m["fault_ins"] for n, m in
                           debug["models"].items()},
                          debug["evictions_total"]))
        return steps

    expect = asyncio.run(trace(jax_repo))
    got = asyncio.run(trace(port_repo))
    for (g_pred, *g_rest), (e_pred, *e_rest) in zip(got, expect):
        assert g_rest == e_rest
        np.testing.assert_allclose(g_pred, e_pred, atol=BF16_ATOL, rtol=0)
    assert all(port_repo.get_model(n).param_source == "checkpoint"
               for n in ("m0", "m1", "m2", "m3"))
