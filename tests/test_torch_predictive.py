"""The port's predictive scaler and standby pools against the JAX
package's (``kfserving_tpu_torch.control.predictive`` vs
``kfserving_tpu.control.predictive``).

One fake-clock series (healthy, a latency and arrival spike, calm again)
goes through both packages' router counters, per-revision series,
``PredictiveScaler``, ``BrownoutController`` and ``Autoscaler(predictive=)``
on ``FakeOrchestrator``; every tick's desired replicas, burn state,
arrival and service estimates, pre-arm targets, brownout levels, replica
counts and decision trail must be equal (exact: control logic), with the
slope-aware sizing and the chain's joint provisioning as cases.  The
in-process standby pool arms and is adopted by a scale-up in both
packages alike, and the subprocess orchestrator's per-component standby
target (which replaces the port's old constant depth of 1) arms, clamps
and reaps as the JAX one's does.
"""

import asyncio
import types

import pytest

from kfserving_tpu.control import autoscaler as jax_autoscaler
from kfserving_tpu.control import controller as jax_controller
from kfserving_tpu.control import orchestrator as jax_orchestrator
from kfserving_tpu.control import predictive as jax_predictive
from kfserving_tpu.control import router as jax_router
from kfserving_tpu.control import spec as jax_spec
from kfserving_tpu.control import subprocess_orchestrator as jax_subproc
from kfserving_tpu.model.model import Model as JaxModel
from kfserving_tpu.observability import REGISTRY as JAX_REGISTRY
from kfserving_tpu.observability import metrics as jax_obs
from kfserving_tpu.observability.monitoring.slo import (
    SLOObjective as JaxSLOObjective,
)
from kfserving_tpu.reliability import BrownoutController as JaxBrownout
from kfserving_tpu_torch.control import autoscaler, controller, orchestrator
from kfserving_tpu_torch.control import predictive, router, spec
from kfserving_tpu_torch.control import subprocess_orchestrator as subproc
from kfserving_tpu_torch.model.model import Model
from kfserving_tpu_torch.observability import REGISTRY
from kfserving_tpu_torch.observability import metrics as obs
from kfserving_tpu_torch.observability.monitoring.slo import SLOObjective
from kfserving_tpu_torch.reliability import BrownoutController

PACKAGES = {
    "jax": dict(autoscaler=jax_autoscaler, controller=jax_controller,
                orchestrator=jax_orchestrator, predictive=jax_predictive,
                router=jax_router, spec=jax_spec, subproc=jax_subproc,
                model=JaxModel, registry=JAX_REGISTRY, obs=jax_obs,
                objective=JaxSLOObjective, brownout=JaxBrownout),
    "torch": dict(autoscaler=autoscaler, controller=controller,
                  orchestrator=orchestrator, predictive=predictive,
                  router=router, spec=spec, subproc=subproc, model=Model,
                  registry=REGISTRY, obs=obs, objective=SLOObjective,
                  brownout=BrownoutController),
}


@pytest.fixture(autouse=True)
def _registries():
    for p in PACKAGES.values():
        p["registry"].reset()
    yield
    for p in PACKAGES.values():
        p["registry"].reset()


def _pool_orchestrator(pkg):
    """FakeOrchestrator with a standby pool that records its targets and
    holds `armed` standbys per component."""
    base = PACKAGES[pkg]["orchestrator"].FakeOrchestrator

    class PoolOrch(base):
        def __init__(self):
            super().__init__()
            self.targets = []
            self.armed = {}

        def set_standby_target(self, cid, target):
            self.targets.append((cid, target))
            self.armed[cid] = min(target, 2)

        def standby_count(self, cid):
            return self.armed.get(cid, 0)

    return PoolOrch()


# (ticks, offered requests/s at the entry, latency ms of each sample)
PHASES = [(4, 20, 5.0), (8, 200, 400.0), (14, 2, 1.0)]
TICK_S = 0.5


async def _run_series(pkg, monkeypatch, slope=None, chain=False):
    p = PACKAGES[pkg]
    s = p["spec"]
    clock = {"t": 1000.0}
    monkeypatch.setattr(p["predictive"], "time", types.SimpleNamespace(
        monotonic=lambda: clock["t"]))
    orch = _pool_orchestrator(pkg)
    c = p["controller"].Controller(orch)
    isvc = s.InferenceService(name="m", predictor=s.PredictorSpec(
        framework="jax", storage_uri="file:///models/m", min_replicas=1,
        max_replicas=3, container_concurrency=2))
    entry = "predictor"
    if chain:
        isvc.transformer = s.TransformerSpec(
            min_replicas=1, max_replicas=3, container_concurrency=2,
            command=["true"])
        entry = "transformer"
    await c.apply(isvc)
    r = p["router"].IngressRouter(c)  # not started: series fed directly
    brownout = p["brownout"]()
    pred = p["predictive"].PredictiveScaler(
        c, r, objectives={"m": p["objective"]("m", latency_ms=100.0)},
        windows_s=(1.0, 5.0), burn_alert=2.0, burn_exit=1.0,
        exit_ticks=2, brownout=brownout, slope_aware=slope is not None,
        slope_horizon_s=10.0)
    scaler = p["autoscaler"].Autoscaler(c, r, tick_seconds=60.0,
                                        predictive=pred)
    if slope is not None:
        p["obs"].trend_slope_per_second().labels(
            series="kfserving_tpu_revision_request_ms_p99", model="m"
        ).set(slope)
    offered = 0
    trail = []
    for ticks, rps, latency in PHASES:
        for _ in range(ticks):
            offered += int(rps * TICK_S)
            r.offered_count[f"router/m/{entry}"] = offered
            for _ in range(10):
                p["obs"].revision_requests_total().labels(
                    model="m", revision="r1", status="200").inc()
                p["obs"].revision_request_ms().labels(
                    model="m", revision="r1").observe(latency)
            clock["t"] += TICK_S
            await scaler.tick()
            fast, rates = pred.burn_state("m")
            trail.append({
                "fast_burn": fast, "burn_rates": rates,
                "arrival": round(pred.arrival_rate(f"router/m/{entry}"), 6),
                "service_s": pred.service_estimate_s("m"),
                "plans": {cid: {k: v for k, v in plan.items()}
                          for cid, plan in pred._plans.items()},
                "targets": list(orch.targets),
                "level": brownout.level("m"),
                "replicas": {cid: len(orch.replicas(cid))
                             for cid in sorted(orch.state)},
                "predicted": sorted(
                    (tuple(sorted(labels.items())), child.value)
                    for labels, child in
                    p["obs"].autoscaler_predicted_replicas().samples()),
                "decisions": [
                    {k: d.get(k) for k in (
                        "kind", "action", "component", "model",
                        "predicted_gap", "standby_target", "level",
                        "required", "current", "coverage",
                        "slope_ms_per_s")}
                    for d in pred.decisions],
            })
    pinned = p["predictive"].ensure_flight_recorder(orch).dump(
        limit=64, pinned_only=True)["pinned"]
    trail.append(sorted((e.get("kind"), e.get("action")) for e in pinned))
    return trail


@pytest.mark.parametrize("case", ["plain", "slope", "chain"])
async def test_fake_clock_series_matches_jax(monkeypatch, case):
    kwargs = {"slope": 2.5} if case == "slope" else {}
    kwargs["chain"] = case == "chain"
    out = {pkg: await _run_series(pkg, monkeypatch, **kwargs)
           for pkg in PACKAGES}
    for i, (want, got) in enumerate(zip(out["jax"], out["torch"])):
        assert got == want, (case, i)
    trail = out["torch"]
    # The loop engaged and let go: fast burn, a pre-arm, brownout entered
    # during the spike and exited after it, the pool handed back.
    assert any(t["fast_burn"] for t in trail[:-1])
    actions = {d["action"] for d in trail[-2]["decisions"]}
    assert {"pre_arm", "brownout_enter", "brownout_exit"} <= actions
    assert max(t["level"] for t in trail[:-1]) > 0
    assert trail[-2]["level"] == 0
    assert trail[-2]["targets"][-1][1] == 0


# ------------------------------------------------------ standby pools --
def _echo_factory(pkg):
    base = PACKAGES[pkg]["model"]

    class Echo(base):
        def load(self):
            self.ready = True
            return True

        async def predict(self, request, headers=None):
            return {"predictions": [1]}

    return lambda cid, spec_: Echo("m")


async def _pool_trace(pkg):
    p = PACKAGES[pkg]
    s = p["spec"]
    kwargs = {"model_factory": _echo_factory(pkg)}
    if pkg == "torch":
        kwargs["device"] = "cpu"
    orch = p["orchestrator"].InProcessOrchestrator(**kwargs)
    c = p["controller"].Controller(orch)
    isvc = s.InferenceService(name="m", predictor=s.PredictorSpec(
        framework="jax", storage_uri="file:///models/m", min_replicas=1,
        max_replicas=4))
    await c.apply(isvc)
    cid = "default/m/predictor"
    trace = []

    async def settle(n):
        for _ in range(200):
            if orch.standby_count(cid) == n:
                return
            await asyncio.sleep(0.01)

    try:
        trace.append(orch.standby_target(cid))
        orch.set_standby_target(cid, 2)
        await settle(2)
        trace.append((orch.standby_target(cid), orch.standby_count(cid),
                      len(orch.replicas(cid))))
        await c.reconciler.scale(isvc, "predictor", 3)
        trace.append((orch.standby_count(cid), len(orch.replicas(cid)),
                      orch.standby_adoptions))
        orch.set_standby_target(cid, 3)
        await settle(3)
        orch.set_standby_target(cid, 1)  # shrinking reaps at once
        trace.append((orch.standby_target(cid), orch.standby_count(cid)))
        orch.set_standby_target(cid, 50)  # clamped
        trace.append(orch.standby_target(cid))
        orch.set_standby_target(cid, 0)
        trace.append((orch.standby_target(cid), orch.standby_count(cid)))
    finally:
        await orch.shutdown()
    return trace


async def test_inprocess_standby_pool_arms_and_adopts_as_jax():
    out = {pkg: await _pool_trace(pkg) for pkg in PACKAGES}
    assert out["torch"] == out["jax"]
    # Default 0; two armed outside rotation; the scale-up adopts both.
    assert out["torch"][:3] == [0, (2, 2, 1), (0, 3, 2)]


class _FakeProcess:
    def __init__(self):
        self.returncode = None
        self.terminated = False

    def terminate(self):
        self.terminated = True


async def _subprocess_trace(pkg, monkeypatch):
    p = PACKAGES[pkg]
    s = p["spec"]
    orch = p["subproc"].SubprocessOrchestrator()
    cid = "default/m/predictor"
    pred = s.PredictorSpec(framework="jax", storage_uri="file:///m")
    proc = p["subproc"]._Proc(process=_FakeProcess(), port=1, spec=pred)
    replica = p["orchestrator"].Replica(cid, "rev1", "127.0.0.1:1",
                                        handle=proc)
    orch.state[cid] = p["orchestrator"]._ComponentState(replicas=[replica])
    armed = []

    async def arm(key, spec_, placement):
        armed.append(key)

    async def terminate(process):
        process.terminate()

    monkeypatch.setattr(orch, "_arm_standby", arm)
    monkeypatch.setattr(orch, "_terminate", terminate)
    trace = [orch.standby_target(cid), orch.standby_count(cid)]
    for target in (None, 3, 0, 12):
        if target is not None:
            orch.set_standby_target(cid, target)
        armed.clear()
        orch._maintain_standby_pool()
        await asyncio.sleep(0)
        trace.append((orch.standby_target(cid), len(armed)))
    # A pool deeper than its target shrinks back to it.
    orch.set_standby_target(cid, 2)
    pool = [p["orchestrator"].Replica(cid, "rev1", f"127.0.0.1:{10 + i}",
                                      handle=p["subproc"]._Proc(
                                          process=_FakeProcess(), port=i))
            for i in range(4)]
    orch._standbys[(cid, "rev1")] = list(pool)
    trace.append(orch.standby_count(cid))
    orch._reap_orphan_standbys()
    await asyncio.sleep(0)
    trace.append((orch.standby_count(cid),
                  [r.handle.process.terminated for r in pool]))
    orch._standbys.clear()
    return trace


async def test_subprocess_standby_target_replaces_the_constant(monkeypatch):
    out = {pkg: await _subprocess_trace(pkg, monkeypatch)
           for pkg in PACKAGES}
    assert out["torch"] == out["jax"]
    assert not hasattr(subproc.SubprocessOrchestrator, "STANDBY_DEPTH")
    # Default 1 armed; a target of 3 arms two more beside the one in
    # flight; 0 clamps to the lifecycle floor of 1 (nothing to arm); 12
    # to the cap of 8 (five more).
    assert out["torch"][:6] == [1, 0, (1, 1), (3, 2), (1, 0), (8, 5)]
    # The excess two are terminated.
    assert out["torch"][-1][1] == [False, False, True, True]
