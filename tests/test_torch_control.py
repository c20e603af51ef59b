"""The port's control-plane schema and reconcile logic against the JAX
package's (``kfserving_tpu_torch.control`` vs ``kfserving_tpu.control``).

The same specs, mutations and TrainedModels go through both packages:
spec round trips, defaults, validation messages, topology placements,
shard packing, reconcile plans on ``FakeOrchestrator`` (replicas,
revisions, traffic, status) and the TrainedModel flow must come out
equal.  Since the port serves meshes (``kfserving_tpu_torch/parallel/``),
a mesh of more than one device validates and applies as in the JAX
package.
"""

import asyncio
import dataclasses
import json
import os

import pytest

from kfserving_tpu.control import clusterconfig as jax_clusterconfig
from kfserving_tpu.control import controller as jax_controller
from kfserving_tpu.control import defaults as jax_defaults
from kfserving_tpu.control import modelconfig as jax_modelconfig
from kfserving_tpu.control import orchestrator as jax_orchestrator
from kfserving_tpu.control import reconciler as jax_reconciler
from kfserving_tpu.control import sharding as jax_sharding
from kfserving_tpu.control import spec as jax_spec
from kfserving_tpu.control import topology as jax_topology
from kfserving_tpu.control import validation as jax_validation
from kfserving_tpu_torch.control import clusterconfig, controller, defaults
from kfserving_tpu_torch.control import modelconfig, orchestrator
from kfserving_tpu_torch.control import reconciler, sharding, spec
from kfserving_tpu_torch.control import topology, validation

PACKAGES = {
    "jax": dict(spec=jax_spec, defaults=jax_defaults,
                validation=jax_validation, topology=jax_topology,
                sharding=jax_sharding, reconciler=jax_reconciler,
                controller=jax_controller, orchestrator=jax_orchestrator,
                modelconfig=jax_modelconfig,
                clusterconfig=jax_clusterconfig),
    "torch": dict(spec=spec, defaults=defaults, validation=validation,
                  topology=topology, sharding=sharding,
                  reconciler=reconciler, controller=controller,
                  orchestrator=orchestrator, modelconfig=modelconfig,
                  clusterconfig=clusterconfig),
}


def _isvc(pkg, name="svc", **pred_kwargs):
    s = PACKAGES[pkg]["spec"]
    pred_kwargs.setdefault("framework", "jax")
    pred_kwargs.setdefault("storage_uri", "file:///models/m")
    return s.InferenceService(name=name,
                              predictor=s.PredictorSpec(**pred_kwargs))


def _both(build):
    """build(pkg) for each package -> {pkg: result}."""
    return {pkg: build(pkg) for pkg in PACKAGES}


def _outcome(fn):
    """The value of fn(), or ("raised", type name, message)."""
    try:
        return fn()
    except Exception as e:  # compared across the packages
        return ("raised", type(e).__name__, str(e))


# ---------------------------------------------------------------- schema --
def test_spec_round_trip_matches_jax():
    def build(pkg):
        s = PACKAGES[pkg]["spec"]
        isvc = _isvc(pkg)
        isvc.predictor.batcher = s.BatcherSpec(max_batch_size=16)
        isvc.predictor.logger = s.LoggerSpec(url="http://sink")
        isvc.transformer = s.TransformerSpec(min_replicas=2,
                                             command=["t"])
        isvc.explainer = s.ExplainerSpec(explainer_type="square_attack")
        d = isvc.to_dict()
        wire = json.loads(json.dumps(d))
        assert s.InferenceService.from_dict(d) == isvc
        assert s.InferenceService.from_dict(json.loads(json.dumps(wire))) \
            == isvc
        return wire

    out = _both(build)
    assert out["torch"] == out["jax"]


@pytest.mark.parametrize("mutate", [
    lambda i: setattr(i.predictor, "max_replicas", 0),
    lambda i: setattr(i.predictor, "timeout_seconds", 0),
    lambda i: setattr(i.predictor, "multi_model", True),
    lambda i: setattr(i.predictor, "framework", "generative"),
])
def test_defaults_match_jax(mutate):
    def build(pkg):
        isvc = _isvc(pkg)
        mutate(isvc)
        PACKAGES[pkg]["defaults"].apply_defaults(isvc)
        return isvc.to_dict()

    out = _both(build)
    assert out["torch"] == out["jax"]


def test_revision_hashes_match_jax():
    """The revision is the content hash the router stamps on every answer
    (x-kfs-revision): one spec hashes alike in both packages, and policy
    fields do not mint a revision."""
    def build(pkg):
        r = PACKAGES[pkg]["reconciler"]
        isvc = _isvc(pkg)
        base = r.revision_of(isvc.predictor)
        isvc.predictor.min_replicas = 3
        isvc.predictor.canary_traffic_percent = 20
        assert r.revision_of(isvc.predictor) == base
        isvc.predictor.storage_uri = "file:///models/m2"
        return base, r.revision_of(isvc.predictor)

    out = _both(build)
    assert out["torch"] == out["jax"]


# ------------------------------------------------------------ validation --
MUTATIONS = [
    lambda i, s: setattr(i, "name", "Bad_Name"),
    lambda i, s: setattr(i.predictor, "framework", "caffe2"),
    lambda i, s: setattr(i.predictor, "storage_uri", "ftp://x"),
    lambda i, s: setattr(i.predictor, "min_replicas", -1),
    lambda i, s: setattr(i.predictor, "canary_traffic_percent", 150),
    lambda i, s: setattr(i.predictor, "logger", s.LoggerSpec(mode="bogus")),
    lambda i, s: setattr(i.predictor.parallelism, "tp", 0),
    lambda i, s: setattr(i.predictor, "batcher",
                         s.BatcherSpec(max_batch_size=0)),
    lambda i, s: setattr(i.predictor, "parallelism",
                         s.ParallelismSpec(dp=1024)),
    lambda i, s: setattr(i.predictor, "rollout",
                         s.RolloutPolicy(steps=[50, 20])),
    lambda i, s: setattr(i.predictor, "framework", "custom"),
    lambda i, s: setattr(i, "explainer",
                         s.ExplainerSpec(explainer_type="alibi")),
    lambda i, s: setattr(i, "explainer",
                         s.ExplainerSpec(explainer_type="custom")),
    lambda i, s: setattr(i, "explainer",
                         s.ExplainerSpec(explainer_type="anchor_tabular")),
    lambda i, s: setattr(i, "explainer",
                         s.ExplainerSpec(explainer_type="square_attack")),
    lambda i, s: setattr(i, "explainer", s.ExplainerSpec(
        explainer_type="anchor_tabular", storage_uri="bogus://x")),
    lambda i, s: setattr(i, "explainer", s.ExplainerSpec(
        explainer_type="alibi", command=["alibi-server"])),
    lambda i, s: setattr(i.predictor, "framework", "tensorflow"),
    lambda i, s: setattr(i.predictor, "storage_uri",
                         "file:///models/m.pb") or setattr(
        i.predictor, "framework", "onnx"),
    lambda i, s: None,
]


@pytest.mark.parametrize("mutate", MUTATIONS)
def test_validation_matches_jax(mutate):
    """One spec mutation through both validators: the same verdict and,
    on a refusal, the same message."""
    def build(pkg):
        isvc = _isvc(pkg)
        mutate(isvc, PACKAGES[pkg]["spec"])
        return _outcome(lambda: PACKAGES[pkg]["validation"].validate(isvc))

    out = _both(build)
    assert out["torch"] == out["jax"]


@pytest.mark.parametrize("framework", ["sklearn", "xgboost", "lightgbm",
                                       "pmml", "pytorch"])
def test_validation_refuses_unported_frameworks(framework):
    """The numpy frameworks and pytorch are ported: the port admits each
    spec exactly where the JAX package does, and refuses a broken one
    with the same errors.  No framework is refused as unported."""
    assert not hasattr(validation, "UNPORTED_FRAMEWORKS")

    def verdicts(pkg):
        v = PACKAGES[pkg]["validation"]
        return [_outcome(lambda kw=kw: v.validate(_isvc(
                    pkg, framework=framework, **kw)))
                for kw in ({}, {"storage_uri": None},
                           {"storage_uri": "ftp://x"},
                           {"min_replicas": -1})]

    out = _both(verdicts)
    assert out["torch"] == out["jax"]
    assert out["torch"][0] is None     # the plain spec is admitted
    assert all(v[0] == "raised" for v in out["torch"][1:])


def test_validation_refuses_a_multi_device_mesh():
    """A multi-device mesh is refused exactly where the JAX package
    refuses it (no slice holds it, or an axis below 1), and placed where
    it places it: the port serves meshes since the parallel layer.  The
    selector itself answers alike."""
    def placement(pkg):
        s = PACKAGES[pkg]["spec"]
        return dataclasses.asdict(PACKAGES[pkg]["topology"].select_topology(
            s.PredictorSpec(framework="jax",
                            parallelism=s.ParallelismSpec(dp=2, tp=2))))

    assert placement("torch") == placement("jax")

    def verdicts(pkg):
        s, v = PACKAGES[pkg]["spec"], PACKAGES[pkg]["validation"]
        return [_outcome(lambda p=p: v.validate(_isvc(
            pkg, parallelism=s.ParallelismSpec(**p))))
            for p in (dict(dp=2, tp=2), dict(tp=8, sp=4),
                      dict(dp=1024, tp=4), dict(tp=0))]

    out = _both(verdicts)
    assert out["torch"] == out["jax"]
    assert out["torch"][0] is None
    assert all(v[0] == "raised" for v in out["torch"][2:])


def test_trained_model_validation_matches_jax():
    def build(pkg):
        s, v = PACKAGES[pkg]["spec"], PACKAGES[pkg]["validation"]
        return [_outcome(lambda tm=tm: v.validate_trained_model(tm))
                for tm in (s.TrainedModel("m", "svc", "bogus"),
                           s.TrainedModel("Bad_", "", "file:///x"),
                           s.TrainedModel("m", "svc", "file:///x",
                                          memory_bytes=-1),
                           s.TrainedModel("m", "svc", "file:///x"))]

    out = _both(build)
    assert out["torch"] == out["jax"]


# -------------------------------------------------------------- topology --
TOPOLOGY_CASES = [
    (dict(framework="sklearn"), {}),
    (dict(framework="jax"), {}),
    (dict(framework="generative"), {}),
    (dict(framework="jax", parallelism=dict(dp=2, tp=2, sp=2)), {}),
    (dict(framework="jax", parallelism=dict(dp=3, tp=2)), {}),
    (dict(framework="jax", parallelism=dict(dp=4, tp=2)),
     {"tpu.kfserving.dev/generation": "v4"}),
    (dict(framework="jax", parallelism=dict(dp=4, tp=2)),
     {"tpu.kfserving.dev/topology": "4x4"}),
    (dict(framework="jax", parallelism=dict(dp=4, tp=2)),
     {"tpu.kfserving.dev/topology": "2x2"}),
    (dict(framework="jax", parallelism=dict(dp=4, tp=2)),
     {"tpu.kfserving.dev/generation": "v9"}),
    (dict(framework="jax", parallelism=dict(dp=1024, tp=1)), {}),
    (dict(framework="custom"), {"tpu.kfserving.dev/generation": "v5p"}),
]


@pytest.mark.parametrize("kwargs,annotations", TOPOLOGY_CASES)
def test_topology_matches_jax(kwargs, annotations):
    def build(pkg):
        s, t = PACKAGES[pkg]["spec"], PACKAGES[pkg]["topology"]
        kw = dict(kwargs)
        if "parallelism" in kw:
            kw["parallelism"] = s.ParallelismSpec(**kw["parallelism"])

        def select():
            p = t.select_topology(s.PredictorSpec(**kw), annotations)
            return None if p is None else (dataclasses.asdict(p), p.env(),
                                           p.spare_chips)
        return _outcome(select)

    out = _both(build)
    assert out["torch"] == out["jax"]


# -------------------------------------------------------------- sharding --
def test_shard_packing_matches_jax():
    def build(pkg):
        s, sh = PACKAGES[pkg]["spec"], PACKAGES[pkg]["sharding"]
        strat = sh.HBMShardStrategy(shard_budget_bytes=100, max_shards=3)
        models = [s.TrainedModel(f"m{i}", "svc", "file:///x",
                                 memory_bytes=b)
                  for i, b in enumerate([60, 50, 40, 30, 20])]
        placement = strat.pack(models)
        sticky = sh.HBMShardStrategy(shard_budget_bytes=100, max_shards=1)
        tm = s.TrainedModel("a", "svc", "file:///x", memory_bytes=60)
        steps = [sticky.get_or_assign(tm), sticky.get_or_assign(tm)]
        for big in (70, 1000):
            steps.append(_outcome(lambda b=big: sticky.get_or_assign(
                s.TrainedModel(f"b{b}", "svc", "file:///x",
                               memory_bytes=b))))
        return placement, len(strat.shards), steps

    out = _both(build)
    assert out["torch"] == out["jax"]
    assert out["torch"][0]["m0"] == 0 and out["torch"][0]["m1"] == 1


def test_modelconfig_codec_matches_jax(tmp_path):
    def build(pkg):
        s, mc = PACKAGES[pkg]["spec"], PACKAGES[pkg]["modelconfig"]
        tms = [s.TrainedModel("m1", "svc", "file:///a", framework="jax",
                              memory_bytes=10),
               s.TrainedModel("m2", "svc", "gs://b", memory_bytes=20)]
        path = str(tmp_path / f"{pkg}.json")
        entries = mc.render(tms)
        mc.write_file(path, entries)
        loaded = mc.load_file(path)
        delta = mc.apply_delta(
            loaded, [s.TrainedModel("m3", "svc", "file:///c",
                                    memory_bytes=5)], ["m1"])
        return entries, loaded, delta, mc.diff_names(delta)

    out = _both(build)
    assert out["torch"] == out["jax"]


def test_cluster_config_runs_the_port_entry_points():
    """Every runtime entry equals the JAX package's but for the module,
    which names the port's entry point; the port's jax and generative
    modules exist."""
    import importlib.util

    jax_cfg = jax_clusterconfig.ClusterConfig.from_dict(
        {"autoscaler": {"tick_seconds": 1.0}})
    cfg = clusterconfig.ClusterConfig.from_dict(
        {"autoscaler": {"tick_seconds": 1.0}})
    assert sorted(cfg.predictors) == sorted(jax_cfg.predictors)
    for name, entry in cfg.predictors.items():
        ref = dict(jax_cfg.predictors[name])
        if "module" in ref:
            assert entry["module"] == ref["module"].replace(
                "kfserving_tpu.", "kfserving_tpu_torch.", 1)
        assert {k: v for k, v in entry.items() if k != "module"} == \
            {k: v for k, v in ref.items() if k != "module"}
    assert dataclasses.asdict(cfg.autoscaler) == \
        dataclasses.asdict(jax_cfg.autoscaler)
    for fw in ("jax", "generative"):
        assert importlib.util.find_spec(cfg.runtime_for(fw)["module"])


# ------------------------------------------------------------ reconciler --
def _replicas(orch):
    return sorted((r.component_id, r.revision, r.host,
                   None if r.placement is None
                   else dataclasses.asdict(r.placement))
                  for cid in orch.state for r in orch.replicas(cid))


def _status(status):
    return None if status is None else dataclasses.asdict(status)


async def _reconcile_scenario(pkg):
    """apply with min 2, a canary at 20%, its promotion, a transformer,
    scale, a removal: replicas and status after each step."""
    s = PACKAGES[pkg]["spec"]
    orch = PACKAGES[pkg]["orchestrator"].FakeOrchestrator()
    c = PACKAGES[pkg]["controller"].Controller(orch)
    trail = []
    isvc = _isvc(pkg)
    isvc.predictor.min_replicas, isvc.predictor.max_replicas = 2, 3
    trail.append((_status(await c.apply(isvc)), _replicas(orch)))
    canary = _isvc(pkg, storage_uri="file:///models/m-v2")
    canary.predictor.canary_traffic_percent = 20
    trail.append((_status(await c.apply(canary)), _replicas(orch)))
    promoted = _isvc(pkg, storage_uri="file:///models/m-v2")
    promoted.transformer = s.TransformerSpec(min_replicas=1,
                                             max_replicas=4,
                                             command=["t"])
    trail.append((_status(await c.apply(promoted)), _replicas(orch)))
    await c.reconciler.scale(promoted, "transformer", 3)
    trail.append((_status(c.status_of("svc")), _replicas(orch)))
    await c.reconciler.scale(promoted, "transformer", 9)
    trail.append((_status(c.status_of("svc")), _replicas(orch)))
    zero = _isvc(pkg, name="zero")
    zero.predictor.min_replicas = 0
    trail.append((_status(await c.apply(zero)), _replicas(orch)))
    await c.remove("svc")
    trail.append((_status(c.status_of("svc")), _replicas(orch)))
    return trail


async def test_reconcile_plans_match_jax():
    jax_trail = await _reconcile_scenario("jax")
    torch_trail = await _reconcile_scenario("torch")
    assert torch_trail == jax_trail
    # The canary step kept the stable revision at 80%.
    traffic = {t["revision"]: t["percent"]
               for t in torch_trail[1][0]["components"]["predictor"][
                   "traffic"]}
    assert sorted(traffic.values()) == [20, 80]


def _load_json(path):
    with open(path) as f:
        return json.load(f)


async def _trained_model_scenario(pkg, root):
    s = PACKAGES[pkg]["spec"]
    v = PACKAGES[pkg]["validation"]
    c = PACKAGES[pkg]["controller"].Controller(
        PACKAGES[pkg]["orchestrator"].FakeOrchestrator(),
        modelconfig_dir=root, shard_budget_bytes=100)
    isvc = _isvc(pkg)
    isvc.predictor.multi_model = True
    isvc.predictor.storage_uri = ""
    await c.apply(isvc)
    out = []
    for tm in (s.TrainedModel("m1", "nope", "file:///x", memory_bytes=10),
               s.TrainedModel("m1", "svc", "file:///x", memory_bytes=60),
               s.TrainedModel("m2", "svc", "file:///y", memory_bytes=60)):
        try:
            out.append(await c.apply_trained_model(tm))
        except v.ValidationError as e:
            out.append(("refused", str(e)))
    files = {name: await asyncio.to_thread(_load_json,
                                           os.path.join(root, name))
             for name in sorted(os.listdir(root))}
    await c.remove_trained_model("m1")
    out.append(await asyncio.to_thread(
        _load_json, os.path.join(root, "default-svc-shard-0.json")))
    plain = PACKAGES[pkg]["controller"].Controller(
        PACKAGES[pkg]["orchestrator"].FakeOrchestrator())
    await plain.apply(_isvc(pkg))
    try:
        await plain.apply_trained_model(
            s.TrainedModel("m1", "svc", "file:///x", memory_bytes=1))
    except v.ValidationError as e:
        out.append(("refused", str(e)))
    return out, files


async def test_trained_model_flow_matches_jax(tmp_path):
    roots = {pkg: str(tmp_path / pkg) for pkg in PACKAGES}
    for root in roots.values():
        os.makedirs(root)
    jax_out = await _trained_model_scenario("jax", roots["jax"])
    torch_out = await _trained_model_scenario("torch", roots["torch"])
    assert torch_out == jax_out
    steps, files = torch_out
    assert steps[1]["shard"] == 0 and steps[2]["shard"] == 1
    assert "not found" in steps[0][1] and "not a multi-model" in steps[-1][1]
    assert [e["modelName"] for e in files["default-svc-shard-0.json"]] == \
        ["m1"]


async def test_reconcile_attaches_the_single_device_placement():
    orch = orchestrator.FakeOrchestrator()
    c = controller.Controller(orch)
    status = await c.apply(_isvc("torch", framework="generative"))
    placement = status.components["predictor"].placement
    assert placement.mesh_chips == 1
    assert orch.replicas("default/svc/predictor")[0].placement is placement


async def test_apply_refuses_an_unported_framework_before_any_replica():
    """The numpy frameworks, pytorch and (since the parallel layer) a
    multi-device mesh apply to a replica; an invalid spec (an axis
    below 1) is still refused before any replica exists."""
    orch = orchestrator.FakeOrchestrator()
    c = controller.Controller(orch)
    await c.apply(_isvc("torch", framework="sklearn"))
    assert len(orch.replicas("default/svc/predictor")) == 1
    orch = orchestrator.FakeOrchestrator()
    c = controller.Controller(orch)
    await c.apply(_isvc("torch",
                        parallelism=spec.ParallelismSpec(dp=2, tp=2)))
    assert len(orch.replicas("default/svc/predictor")) == 1
    orch = orchestrator.FakeOrchestrator()
    c = controller.Controller(orch)
    with pytest.raises(validation.ValidationError, match="axes must be"):
        await c.apply(_isvc("torch",
                            parallelism=spec.ParallelismSpec(dp=2, tp=0)))
    assert orch.state == {}


def test_default_factory_builds_port_models_on_the_given_device(tmp_path):
    """The factory's predictor models are the port's, on the device the
    orchestrator was given, the tabular predictors and pytorch
    included."""
    from kfserving_tpu_torch.predictors.jaxserver.repository import (
        TorchModelRepository,
    )
    from kfserving_tpu_torch.predictors.llm import GenerativeModel
    from kfserving_tpu_torch.predictors.torch_model import TorchModel

    orch = orchestrator.InProcessOrchestrator(device="cpu")
    assert orch.device == "cpu"
    jax_model = orch.model_factory(
        "default/a/predictor", spec.PredictorSpec(framework="jax",
                                                  storage_uri="/x"))
    assert isinstance(jax_model, TorchModel)
    assert jax_model.device.type == "cpu"
    gen = orch.model_factory(
        "default/g/predictor",
        spec.PredictorSpec(framework="generative", storage_uri="/x"))
    assert isinstance(gen, GenerativeModel) and gen.device.type == "cpu"
    repo = orch.model_factory(
        "default/r/predictor",
        spec.PredictorSpec(framework="jax", multi_model=True,
                           storage_uri=str(tmp_path)))
    assert isinstance(repo, TorchModelRepository) and repo.device == "cpu"
    from kfserving_tpu_torch.predictors.lgbserver import LightGBMModel
    from kfserving_tpu_torch.predictors.pmmlserver import PMMLModel
    from kfserving_tpu_torch.predictors.sklearnserver import SKLearnModel
    from kfserving_tpu_torch.predictors.torchserver import PyTorchModel
    from kfserving_tpu_torch.predictors.xgbserver import XGBoostModel

    for framework, cls in (("sklearn", SKLearnModel),
                           ("xgboost", XGBoostModel),
                           ("lightgbm", LightGBMModel),
                           ("pmml", PMMLModel), ("pytorch", PyTorchModel)):
        model = orch.model_factory(
            "default/s/predictor",
            spec.PredictorSpec(framework=framework, storage_uri="/x"))
        assert isinstance(model, cls) and model.name == "s"
    assert model.device == "cpu"         # the torchserver's device
    with pytest.raises(ValueError, match="cannot run framework 'onnx'"):
        orch.model_factory("default/o/predictor",
                           spec.PredictorSpec(framework="onnx",
                                              storage_uri="/x.onnx"))
    # The default device is the card.
    assert orchestrator.InProcessOrchestrator().device == "cuda"
