"""The port's progressive rollout against the JAX package's
(``kfserving_tpu_torch.control.rollout`` vs ``kfserving_tpu.control.rollout``).

Each scenario of the JAX file (tests/test_rollout.py) runs as one script
of applies, ticks, per-revision series samples, probe answers and sleeps
through both packages' ``RolloutManager`` on ``FakeOrchestrator``; after
every step the records must be equal (exact: the state machine is
control logic): traffic split, replicas by revision, active records
(phase, step, percent, reason, events without their time stamps),
history, quarantine and the status's quarantined revision.  The JAX
file's default ``sklearn`` framework is refused by the port, so both
sides use ``jax``.  ``_p95_ms`` is held to the JAX one on the same
bucket counts.  Two in-process scenarios go through real routers and
replicas (the port's on the CPU): a canary whose model raises rolls back
with its evidence fetched over HTTP, and a healthy canary promotes with
no operator call.  On the port alone, ``dataplane.infer`` and
``router.dispatch`` faults matched to the canary's revision roll it back.
"""

import asyncio
import json

import pytest
from torch_serving import arequest

from kfserving_tpu import Model as JaxModel
from kfserving_tpu.control import controller as jax_controller
from kfserving_tpu.control import orchestrator as jax_orchestrator
from kfserving_tpu.control import reconciler as jax_reconciler
from kfserving_tpu.control import rollout as jax_rollout
from kfserving_tpu.control import router as jax_router
from kfserving_tpu.control import spec as jax_spec
from kfserving_tpu.observability import REGISTRY as JAX_REGISTRY
from kfserving_tpu.observability import metrics as jax_obs
from kfserving_tpu.reliability import faults as jax_faults
from kfserving_tpu_torch.control import controller, orchestrator
from kfserving_tpu_torch.control import reconciler, rollout, router, spec
from kfserving_tpu_torch.model.model import Model
from kfserving_tpu_torch.observability import REGISTRY
from kfserving_tpu_torch.observability import metrics as obs
from kfserving_tpu_torch.reliability import faults
from kfserving_tpu_torch.server.client import HTTPClient

PACKAGES = {
    "jax": dict(spec=jax_spec, controller=jax_controller,
                orchestrator=jax_orchestrator, reconciler=jax_reconciler,
                rollout=jax_rollout, router=jax_router, obs=jax_obs,
                registry=JAX_REGISTRY, faults=jax_faults, model=JaxModel),
    "torch": dict(spec=spec, controller=controller,
                  orchestrator=orchestrator, reconciler=reconciler,
                  rollout=rollout, router=router, obs=obs,
                  registry=REGISTRY, faults=faults, model=Model),
}
CID = "default/svc/predictor"


@pytest.fixture(autouse=True)
def _state():
    for p in PACKAGES.values():
        p["registry"].reset()
        p["faults"].reset()
    yield
    for p in PACKAGES.values():
        p["registry"].reset()
        p["faults"].reset()


@pytest.mark.parametrize("sample", [
    {"buckets": [1, 10, 100], "counts": [95, 5, 0, 0]},
    {"buckets": [1, 10, 100], "counts": [50, 0, 45, 5]},
    {"buckets": [1, 10, 100], "counts": [0, 0, 0, 10]},
    {"buckets": [1, 10, 100], "counts": [0, 0, 0, 0]},
    {"buckets": [5, 10], "counts": [1, 18, 1]},
    {"buckets": None, "counts": None},
])
def test_p95_ms_matches_jax(sample):
    assert rollout._p95_ms(sample) == jax_rollout._p95_ms(sample)


# ------------------------------------------------------------ scenarios --
def _policy(**kw):
    kw.setdefault("steps", [50, 100])
    kw.setdefault("hold_s", 0.0)
    kw.setdefault("settle_s", 0.0)
    kw.setdefault("warmup_probes", 1)
    return kw


# Each step: ("apply", uri, policy kwargs[, predictor kwargs]), ("tick",),
# ("feed", revision index, status, n, latency ms), ("probe", ok),
# ("sleep", s), ("scale", replicas).  Revision index 0 is the first
# applied uri's, 1 the second's, and so on.
SCENARIOS = {
    "healthy_steps_and_promotes": [
        ("apply", "file:///m", _policy()),
        ("apply", "file:///m2", _policy(steps=[5, 25, 100])),
        ("tick",), ("tick",), ("tick",), ("tick",),
    ],
    "adjacent_bucket_p95_is_not_a_regression": [
        ("apply", "file:///m", _policy()),
        ("apply", "file:///m2", _policy(min_requests=3,
                                        max_latency_regression=1.5)),
        ("tick",),
        ("feed", 0, "200", 10, 4.0), ("feed", 1, "200", 10, 8.0),
        ("tick",),
    ],
    "warmup_gates_first_step": [
        ("probe", False),
        ("apply", "file:///m", _policy()),
        ("apply", "file:///m2", _policy(warmup_probes=2)),
        ("tick",), ("tick",), ("tick",), ("tick",),
        ("probe", True), ("tick",), ("tick",),
    ],
    "warmup_timeout_rolls_back_and_quarantines": [
        ("probe", False),
        ("apply", "file:///m", _policy()),
        ("apply", "file:///wedged", _policy(warmup_timeout_s=0.1)),
        ("tick",), ("sleep", 0.15), ("tick",),
    ],
    "finished_rollouts_prune_dead_revision_series": [
        ("apply", "file:///m", _policy()),
        ("apply", "file:///m2", _policy()),
        ("feed", 0, "200", 3, 1.0), ("feed", 1, "200", 3, 1.0),
        ("tick",), ("tick",), ("tick",), ("tick",),
    ],
    "hold_requires_min_requests": [
        ("apply", "file:///m", _policy()),
        ("apply", "file:///m2", _policy(min_requests=5)),
        ("tick",), ("tick",), ("tick",), ("tick",),
        ("feed", 1, "200", 5, 1.0), ("tick",),
    ],
    "error_ratio_rolls_back_quarantines_and_holds": [
        ("apply", "file:///m", _policy()),
        ("apply", "file:///bad", _policy(min_requests=3,
                                         max_error_ratio=0.1)),
        ("tick",),
        ("feed", 1, "500", 4, 1.0), ("feed", 0, "200", 10, 1.0),
        ("tick",),
        # The identical spec again: no re-roll.
        ("apply", "file:///bad", _policy(min_requests=3,
                                         max_error_ratio=0.1)),
        ("tick",),
        # A fixed spec (new content hash) rolls out.
        ("apply", "file:///fixed", _policy()),
        ("tick",),
    ],
    "settle_excludes_cold_start_samples": [
        ("apply", "file:///m", _policy()),
        ("apply", "file:///m2", _policy(settle_s=0.2, min_requests=2,
                                        max_error_ratio=0.05)),
        ("tick",),
        ("feed", 1, "500", 6, 900.0), ("feed", 0, "200", 6, 1.0),
        ("tick",), ("sleep", 0.25), ("tick",),
        ("feed", 1, "200", 4, 1.0), ("feed", 0, "200", 4, 1.0),
        ("tick",),
    ],
    "reapply_mid_rollout_reasserts_step_percent": [
        ("apply", "file:///m", _policy()),
        ("apply", "file:///m2", _policy(min_requests=5)),
        ("tick",),
        ("apply", "file:///m2", _policy(min_requests=5)),
        ("tick",),
    ],
    "scale_keeps_stable_floor_at_final_step": [
        ("apply", "file:///m", _policy()),
        ("apply", "file:///m2", _policy(steps=[100]), {"max_replicas": 4}),
        ("tick",), ("scale", 3),
    ],
    "latency_regression_rolls_back": [
        ("apply", "file:///m", _policy()),
        ("apply", "file:///slow", _policy(min_requests=3,
                                          max_latency_regression=2.0)),
        ("tick",),
        ("feed", 0, "200", 10, 1.0), ("feed", 1, "200", 10, 400.0),
        ("tick",),
    ],
    "slo_breach_attributed_to_canary_rolls_back": [
        ("slo", True),
        ("apply", "file:///m", _policy()),
        ("apply", "file:///m2", _policy()),
        ("tick",), ("tick",),
    ],
    "superseded_mid_rollout": [
        ("apply", "file:///m", _policy()),
        ("apply", "file:///m2", _policy(min_requests=50)),
        ("tick",),
        ("apply", "file:///m3", _policy(steps=[100])),
        ("tick",), ("tick",),
    ],
}


def _scrub(events):
    return [{k: v for k, v in e.items() if k != "ts"} for e in events]


def _record_view(d):
    keep = ("component_id", "revision", "stable_revision", "policy",
            "phase", "step_index", "percent", "reason")
    return ({k: d[k] for k in keep}, _scrub(d["events"]),
            [e.get("pinned") for e in d["evidence"]])


async def _run_scenario(pkg, steps):
    p = PACKAGES[pkg]
    s = p["spec"]
    orch = p["orchestrator"].FakeOrchestrator()
    c = p["controller"].Controller(orch)
    answers = {"probe": True, "slo": False}
    mgr = p["rollout"].RolloutManager(
        c, probe=lambda host: answers["probe"],
        slo_check=lambda model, hosts: answers["slo"])
    revisions = []
    trail = []
    isvc = None
    for step in steps:
        kind = step[0]
        if kind == "apply":
            pred = dict(framework="jax", storage_uri=step[1],
                        rollout=s.RolloutPolicy(**step[2]))
            pred.update(step[3] if len(step) > 3 else {})
            isvc = s.InferenceService(name="svc",
                                      predictor=s.PredictorSpec(**pred))
            await c.apply(isvc)
            rev = p["reconciler"].revision_of(isvc.predictor)
            if rev not in revisions:
                revisions.append(rev)
        elif kind == "tick":
            await mgr.tick()
        elif kind == "feed":
            _, idx, status, n, latency = step
            for _ in range(n):
                p["obs"].revision_requests_total().labels(
                    model="svc", revision=revisions[idx],
                    status=status).inc()
                p["obs"].revision_request_ms().labels(
                    model="svc", revision=revisions[idx]).observe(latency)
        elif kind in ("probe", "slo"):
            answers[kind] = step[1]
        elif kind == "sleep":
            await asyncio.sleep(step[1])
        elif kind == "scale":
            await c.reconciler.scale(isvc, "predictor", step[1])
        status = c.reconciler.status.get("default/svc")
        cstatus = status.components["predictor"] if status else None
        counts = {}
        for r in orch.replicas(CID):
            counts[r.revision] = counts.get(r.revision, 0) + 1
        report = mgr.report()
        trail.append({
            "step": step[0],
            "traffic": sorted((t.revision, t.percent)
                              for t in cstatus.traffic) if cstatus else None,
            "quarantined_revision": (cstatus.quarantined_revision
                                     if cstatus else None),
            "replicas": sorted(counts.items()),
            "active": [_record_view(r) for r in report["active"]],
            "history": [_record_view(h) for h in report["history"]],
            "quarantine": {cid: sorted((rev, q.get("reason"),
                                        q.get("stable"))
                                       for rev, q in revs.items())
                           for cid, revs in report["quarantine"].items()},
            "series_revisions": sorted({
                labels["revision"] for labels, _ in
                p["obs"].revision_requests_total().samples()}),
            "rollout_state": sorted(
                (tuple(sorted(labels.items())), child.value)
                for labels, child in p["obs"].rollout_state().samples()),
        })
    return trail


@pytest.mark.parametrize("name", sorted(SCENARIOS))
async def test_rollout_scenario_matches_jax(name):
    out = {pkg: await _run_scenario(pkg, SCENARIOS[name])
           for pkg in PACKAGES}
    for i, (want, got) in enumerate(zip(out["jax"], out["torch"])):
        assert got == want, (name, i)
    assert len(out["torch"]) == len(SCENARIOS[name])


# ----------------------------------------------------------- in-process --
def _factory(pkg):
    base = PACKAGES[pkg]["model"]

    class OkModel(base):
        def load(self):
            self.ready = True
            return True

        async def predict(self, request, headers=None):
            return {"predictions": [1]}

    class BoomModel(OkModel):
        async def predict(self, request, headers=None):
            raise RuntimeError("canary artifact is broken")

    def build(component_id, spec_):
        cls = BoomModel if "bad" in (spec_.storage_uri or "") else OkModel
        return cls(component_id.split("/")[1])

    return build


async def _drive(port, n):
    statuses = []
    for _ in range(n):
        status, _, _ = await arequest(port, "POST", "/v1/models/roll:predict",
                                      {"instances": [[1.0]]})
        statuses.append(status)
    return statuses


def _roll_isvc(s, uri, policy):
    return s.InferenceService(name="roll", predictor=s.PredictorSpec(
        framework="custom", command=["unused"], storage_uri=uri,
        rollout=s.RolloutPolicy(**policy)))


async def _in_process(pkg, scenario):
    """tests/test_rollout.py's end-to-end scenarios: "fault" is
    test_e2e_failing_canary_auto_rollback_with_evidence (a canary whose
    model raises), "healthy" test_e2e_healthy_canary_auto_promotes."""
    p = PACKAGES[pkg]
    s = p["spec"]
    kwargs = {"model_factory": _factory(pkg)}
    if pkg == "torch":
        kwargs["device"] = "cpu"
    orch = p["orchestrator"].InProcessOrchestrator(**kwargs)
    c = p["controller"].Controller(orch)
    r = p["router"].IngressRouter(c, seed=3)
    mgr = p["rollout"].RolloutManager(c)
    if pkg == "jax":
        import aiohttp

        mgr._session = aiohttp.ClientSession(
            timeout=aiohttp.ClientTimeout(total=2.0))
    else:
        mgr._http = HTTPClient(timeout=2.0, keepalive=False)
    await r.start_async()
    cid = "default/roll/predictor"
    try:
        if scenario == "fault":
            policy = _policy(steps=[50, 100], min_requests=3,
                             max_error_ratio=0.1, warmup_probes=1)
            await c.apply(_roll_isvc(s, "file:///good", policy))
            bad = _roll_isvc(s, "file:///bad-v2", policy)
            await c.apply(bad)
            await mgr.tick()  # real ready probe -> step 0 (50%)
            statuses = await _drive(r.http_port, 24)
            await mgr.tick()  # error-ratio gate -> rollback
            after = await _drive(r.http_port, 6)
            _, _, body = await arequest(r.http_port, "GET", "/v2/rollouts")
            body = json.loads(body)
            await c.apply(_roll_isvc(s, "file:///bad-v2", policy))
            await mgr.tick()
            cstatus = c.reconciler.status["default/roll"].components[
                "predictor"]
            record = body["history"][-1]
            return {"statuses": sorted(set(statuses)),
                    "after": after,
                    "traffic": sorted((t.revision, t.percent)
                                      for t in cstatus.traffic),
                    "replicas": sorted(x.revision
                                       for x in orch.replicas(cid)),
                    "record": _record_view(record)[0],
                    "events": [e["event"] for e in record["events"]],
                    "evidence_pins": sorted(
                        {e.get("pinned") for e in record["evidence"]}),
                    "quarantine": sorted(body["quarantine"].get(cid, {})),
                    "bad": p["reconciler"].revision_of(bad.predictor)}
        # Latency gate loosened: two replicas' first requests on a
        # shared CPU can sit buckets apart, which is timing, not a
        # regression of the canary.
        policy = _policy(steps=[25, 100], min_requests=2, warmup_probes=1,
                         max_latency_regression=100.0)
        await c.apply(_roll_isvc(s, "file:///good", policy))
        v2 = _roll_isvc(s, "file:///good-v2", policy)
        await c.apply(v2)
        rev2 = p["reconciler"].revision_of(v2.predictor)
        phases = []
        for _ in range(8):
            await mgr.tick()
            await _drive(r.http_port, 8)
            phases.append([x["phase"] for x in mgr.report()["active"]])
            cstatus = c.reconciler.status["default/roll"].components[
                "predictor"]
            if {t.revision for t in cstatus.traffic} == {rev2}:
                break
        status, headers, _ = await arequest(
            r.http_port, "POST", "/v1/models/roll:predict",
            {"instances": [[1.0]]})
        _, _, rollouts = await arequest(r.http_port, "GET", "/v2/rollouts")
        return {"phases": phases,
                "replicas": sorted(x.revision for x in orch.replicas(cid)),
                "tag": (status, headers.get("x-kfs-revision") == rev2),
                "history": [h["phase"] for h in
                            json.loads(rollouts)["history"]]}
    finally:
        if pkg == "jax":
            await mgr._session.close()
        else:
            await mgr._http.close()
        await r.stop_async()
        await orch.shutdown()


async def test_in_process_healthy_rollout_matches_jax():
    out = {pkg: await _in_process(pkg, "healthy") for pkg in PACKAGES}
    assert out["torch"] == out["jax"]
    assert out["torch"]["history"] == ["promoted"]
    assert out["torch"]["tag"] == (200, True)


async def test_in_process_failing_canary_rolls_back_with_evidence():
    """The port alone against the assertions of
    tests/test_rollout.py::test_e2e_failing_canary_auto_rollback_with_evidence
    (the JAX side of this scenario spends ~16 s stopping the rolled-back
    replica behind the router's pooled connections, too long for this
    lane): the canary's 5xx roll it back, traffic returns to stable, the
    evidence pinned "error" on the canary is fetched over HTTP before
    teardown, and an identical re-apply does not re-roll."""
    got = await _in_process("torch", "fault")
    assert 500 in got["statuses"] and set(got["after"]) == {200}
    assert got["record"]["phase"] == "rolled_back"
    assert got["record"]["reason"] == "error_ratio"
    assert got["record"]["revision"] == got["bad"]
    assert "error" in got["evidence_pins"]
    assert got["quarantine"] == [got["bad"]]
    assert [pct for _, pct in got["traffic"]] == [100]
    assert got["replicas"] == [got["traffic"][0][0]]


@pytest.mark.chaos
@pytest.mark.parametrize("site", ["dataplane.infer", "router.dispatch"])
async def test_revision_matched_fault_rolls_back(site):
    """The chip smoke's rollback path on the port, with no operator
    call: faults matched to the canary's revision
    (tests/test_rollout.py::test_revision_matched_fault_drives_rollback)
    roll it back in one tick and quarantine it, and an identical re-apply
    does not re-roll.  At ``dataplane.infer`` (in-process replicas key it
    by revision) the canary's own 5xx are pinned and copied into the
    record as evidence."""
    s = spec
    orch = orchestrator.InProcessOrchestrator(model_factory=_factory("torch"),
                                              device="cpu")
    c = controller.Controller(orch)
    r = router.IngressRouter(c, seed=1)
    mgr = rollout.RolloutManager(c)
    await r.start_async()
    await mgr.start()
    mgr._task.cancel()  # ticked by hand below
    cid = "default/roll/predictor"
    try:
        policy = _policy(steps=[50, 100], min_requests=2,
                         max_error_ratio=0.1, warmup_probes=0)
        await c.apply(_roll_isvc(s, "file:///good", policy))
        stable = reconciler.revision_of(c.get("roll").predictor)
        v2 = _roll_isvc(s, "file:///good-v2", policy)
        await c.apply(v2)
        rev2 = reconciler.revision_of(v2.predictor)
        faults.configure({site: {"error_rate": 1.0,
                                 "match": f"revision:{rev2}"}})
        await mgr.tick()
        await _drive(r.http_port, 16)
        await mgr.tick()
        cstatus = c.reconciler.status["default/roll"].components[
            "predictor"]
        assert [(t.revision, t.percent) for t in cstatus.traffic] == \
            [(stable, 100)]
        report = mgr.report()
        record = report["history"][-1]
        assert record["phase"] == "rolled_back"
        assert rev2 in report["quarantine"][cid]
        if site == "dataplane.infer":
            assert {e.get("pinned") for e in record["evidence"]} == \
                {"error"}
        faults.reset()
        assert set(await _drive(r.http_port, 4)) == {200}
        await c.apply(_roll_isvc(s, "file:///good-v2", policy))
        await mgr.tick()
        assert mgr.records == {}
        assert {x.revision for x in orch.replicas(cid)} == {stable}
    finally:
        faults.reset()
        await mgr.stop()
        await r.stop_async()
        await orch.shutdown()
