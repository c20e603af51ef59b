"""SLO-gated progressive rollout: the self-driving canary loop.

The reference's canary is two revisions and a traffic split the
operator edits by hand (ksvc_reconciler.go:84-118); PR 3's SLO engine
computes breach signals nothing consumed.  This manager closes the
loop, per TensorFlow-Serving's version-lifecycle manager
(arXiv:1712.06139) and InferLine's objective-driven control
(arXiv:1812.01776): revision health, not a human, gates traffic.

State machine per component with a `RolloutPolicy` and an active
canary pair (latest revision != previous revision):

    warming      new-revision replicas hold 0% traffic until
                 `/v2/health/ready` answers and `warmup_probes`
                 consecutive probes succeed per replica — a revision
                 that loads but cannot serve never takes a step;
    progressing  canary_traffic_percent climbs `policy.steps`,
                 holding `hold_s` at each step while the analyzer
                 compares the canary's per-revision 5xx ratio and
                 latency p95 (the router's revision-tagged series)
                 against the stable revision's;
    promoted     the final step (100) passed its gate: canary becomes
                 the only revision, the previous one is GC'd;
    rolled_back  a failed gate — or an SLO breach reported by a canary
                 replica — reverted traffic to stable in one
                 reconcile, quarantined the revision's content hash
                 (re-applying the identical spec does not re-roll),
                 and pinned the canary's flight-recorder evidence
                 into the rollout record before teardown.

Records are served at the router's `GET /v2/rollouts`; state rides the
`kfserving_tpu_rollout_*` gauges.

Port of ``kfserving_tpu/control/rollout.py``.  The readiness probe, the
canary's SLO check and the evidence collection speak HTTP through the
port's ``server/client.py`` (a connection per request, sent once); a
manager that was not started makes no HTTP call, so the test doubles
that pass ``probe=`` and tick by hand see what the JAX manager does
without its session.
"""

import asyncio
import json
import logging
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from kfserving_tpu_torch.observability import REGISTRY
from kfserving_tpu_torch.observability import metrics as obs
from kfserving_tpu_torch.observability.metrics import (
    REVISION_LATENCY_SERIES,
    REVISION_REQUESTS_SERIES,
)
from kfserving_tpu_torch.server.client import HTTPClient

logger = logging.getLogger("kfserving_tpu_torch.control.rollout")

# Budget of one probe, SLO check or evidence fetch against a replica.
HTTP_TIMEOUT_S = 2.0

DEFAULT_TICK_S = 1.0
# Finished rollouts kept for GET /v2/rollouts after their component
# moves on (bounded — the endpoint must not grow without limit).
HISTORY_SIZE = 64
# Flight-recorder entries pinned into a rollback record per replica.
EVIDENCE_LIMIT = 20

_PHASE_CODE = {"warming": 0, "progressing": 1, "promoted": 2,
               "rolled_back": 3}


def _series_sample(registry, model: str, revision: str) -> Dict[str, Any]:
    """Cumulative per-(model, revision) sample of the router's
    revision-tagged request series: attempt count, 5xx count, latency
    histogram bucket counts."""
    out: Dict[str, Any] = {"total": 0.0, "errors": 0.0,
                           "buckets": None, "counts": None}
    fam = registry.family(REVISION_REQUESTS_SERIES)
    if fam is not None:
        for labels, child in fam.samples():
            if labels.get("model") != model or \
                    labels.get("revision") != revision:
                continue
            out["total"] += child.value
            try:
                if int(labels.get("status", 0)) >= 500:
                    out["errors"] += child.value
            except ValueError:
                pass
    fam = registry.family(REVISION_LATENCY_SERIES)
    if fam is not None:
        for labels, hist in fam.samples():
            if labels.get("model") != model or \
                    labels.get("revision") != revision:
                continue
            with hist._lock:
                counts = list(hist.counts)
            if out["counts"] is None:
                out["buckets"] = list(hist.buckets)
                out["counts"] = [0.0] * len(counts)
            if len(counts) == len(out["counts"]):
                out["counts"] = [a + b for a, b in
                                 zip(out["counts"], counts)]
    return out


def _delta(cur: Dict[str, Any], base: Dict[str, Any]) -> Dict[str, Any]:
    """Window delta of two cumulative samples (counter resets — a
    registry wipe mid-step — clamp to zero instead of going negative)."""
    out = {"total": max(0.0, cur["total"] - base["total"]),
           "errors": max(0.0, cur["errors"] - base["errors"]),
           "buckets": cur["buckets"], "counts": None}
    if cur["counts"] is not None:
        if base["counts"] is not None and \
                len(base["counts"]) == len(cur["counts"]):
            out["counts"] = [max(0.0, a - b) for a, b in
                             zip(cur["counts"], base["counts"])]
        else:
            out["counts"] = list(cur["counts"])
    return out


def _p95_bucket(sample: Dict[str, Any]) -> Optional[int]:
    """Index of the histogram bucket holding the p95 (None = no
    data; index == len(buckets) = the overflow bucket)."""
    counts = sample.get("counts")
    buckets = sample.get("buckets")
    if not counts or buckets is None:
        return None
    total = sum(counts)
    if total <= 0:
        return None
    need = 0.95 * total
    cumulative = 0.0
    for idx, count in enumerate(counts):
        cumulative += count
        if cumulative >= need:
            return idx
    return len(counts) - 1


def _bucket_bound(sample: Dict[str, Any], idx: int) -> float:
    buckets = sample["buckets"]
    return float(buckets[idx]) if idx < len(buckets) else float("inf")


def _p95_ms(sample: Dict[str, Any]) -> Optional[float]:
    """p95 upper bound from histogram bucket counts (None = no data;
    inf = the p95 sits in the overflow bucket)."""
    idx = _p95_bucket(sample)
    if idx is None:
        return None
    return _bucket_bound(sample, idx)


@dataclass
class RolloutRecord:
    """One rollout's lifecycle (active or finished)."""

    cid: str
    namespace: str
    name: str
    component: str
    revision: str       # the canary under evaluation
    stable: str         # the previous-ready revision rollback targets
    policy: Dict[str, Any]
    phase: str = "warming"
    step_idx: int = -1
    percent: int = 0
    reason: str = ""
    started_ts: float = field(default_factory=time.time)
    updated_ts: float = field(default_factory=time.time)
    events: List[Dict[str, Any]] = field(default_factory=list)
    # Pinned flight-recorder entries captured from the canary's
    # replicas at rollback, before their teardown destroys the rings.
    evidence: List[Dict[str, Any]] = field(default_factory=list)
    # -- non-serialized working state --
    started_mono: float = field(default_factory=time.monotonic)
    step_started_mono: float = 0.0
    settled: bool = False
    warmup: Dict[str, int] = field(default_factory=dict)
    baseline_canary: Optional[Dict[str, Any]] = None
    baseline_stable: Optional[Dict[str, Any]] = None

    def event(self, kind: str, **detail: Any) -> None:
        self.updated_ts = time.time()
        self.events.append({"ts": self.updated_ts, "event": kind,
                            **detail})

    def to_dict(self) -> Dict[str, Any]:
        return {
            "component_id": self.cid,
            "namespace": self.namespace,
            "name": self.name,
            "component": self.component,
            "revision": self.revision,
            "stable_revision": self.stable,
            "policy": self.policy,
            "phase": self.phase,
            "step_index": self.step_idx,
            "percent": self.percent,
            "reason": self.reason,
            "started_ts": self.started_ts,
            "updated_ts": self.updated_ts,
            "events": list(self.events),
            "evidence": list(self.evidence),
        }


class RolloutManager:
    """Ticks the rollout state machine over every InferenceService the
    controller holds.  `probe` and `slo_check` are injectable for
    hardware-free tests; the defaults HTTP-probe the canary replicas
    (ready endpoint / federated SLO health)."""

    def __init__(self, controller, tick_seconds: float = DEFAULT_TICK_S,
                 probe: Optional[Callable] = None,
                 slo_check: Optional[Callable] = None,
                 registry=REGISTRY):
        self.controller = controller
        self.tick_seconds = tick_seconds
        self.registry = registry
        self._probe = probe
        self._slo_check = slo_check
        self.records: Dict[str, RolloutRecord] = {}   # cid -> active
        self.history: deque = deque(maxlen=HISTORY_SIZE)
        self._task: Optional[asyncio.Task] = None
        # Set by start(): the client of the probes, SLO checks and
        # evidence fetches (None = no HTTP, as the JAX manager without
        # its session).
        self._http: Optional[HTTPClient] = None
        # The router (and tests) reach the manager through the
        # controller, like reconciler/status.
        controller.rollout_manager = self

    # -- lifecycle ---------------------------------------------------------
    async def start(self) -> None:
        if self._http is None:
            self._http = HTTPClient(timeout=HTTP_TIMEOUT_S,
                                    keepalive=False)
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(
                self._loop())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        if self._http is not None:
            await self._http.close()
            self._http = None

    async def _get_json(self, url: str) -> Optional[Dict[str, Any]]:
        """GET a replica's JSON route; None on any failure or non-200."""
        try:
            status, _, body = await self._http.request("GET", url)
            if status != 200:
                return None
            return json.loads(body)
        except Exception:
            return None

    async def _loop(self) -> None:
        while True:
            try:
                await self.tick()
            except Exception:
                logger.exception("rollout tick failed")
            await asyncio.sleep(self.tick_seconds)

    # -- reporting ---------------------------------------------------------
    def report(self) -> Dict[str, Any]:
        """The GET /v2/rollouts body: active rollouts, recent finished
        ones, and the quarantine ledger."""
        return {
            "active": [r.to_dict() for r in self.records.values()],
            "history": list(self.history),
            "quarantine":
                self.controller.reconciler.quarantine_report(),
        }

    def _export_gauges(self, rec: RolloutRecord) -> None:
        obs.rollout_state().labels(
            component=rec.cid, revision=rec.revision).set(
                _PHASE_CODE.get(rec.phase, -1))
        obs.rollout_step_percent().labels(component=rec.cid).set(
            rec.percent)

    # -- tick --------------------------------------------------------------
    async def tick(self) -> None:
        """One state-machine evaluation over every service (callable
        directly in tests, like Autoscaler.tick)."""
        reconciler = self.controller.reconciler
        seen: set = set()
        for key, isvc in list(self.controller.specs.items()):
            status = reconciler.status.get(key)
            if status is None:
                continue
            for cname, comp in isvc.components().items():
                if comp.rollout is None:
                    continue
                cstatus = status.components.get(cname)
                if cstatus is None:
                    continue
                cid = reconciler.component_id(isvc, cname)
                seen.add(cid)
                await self._tick_component(isvc, cname, comp, cstatus,
                                           cid)
        # Services deleted out from under an active rollout.
        for cid in [c for c in self.records if c not in seen]:
            self._finish(self.records.pop(cid), "superseded",
                         reason="service removed")
        for cid, revs in self.controller.reconciler.quarantine.items():
            obs.rollout_quarantined().labels(component=cid).set(
                len(revs))

    async def _tick_component(self, isvc, cname: str, comp, cstatus,
                              cid: str) -> None:
        latest = cstatus.latest_revision
        stable = cstatus.previous_revision
        active = bool(stable) and stable != latest and \
            comp.canary_traffic_percent is not None
        rec = self.records.get(cid)
        if rec is not None and rec.revision != latest:
            # A newer spec superseded the canary mid-rollout (or a
            # rollback moved latest back to stable).
            if rec.phase in ("warming", "progressing"):
                self._finish(rec, "superseded",
                             reason=f"revision {latest} applied")
            self.records.pop(cid, None)
            rec = None
        if not active:
            return
        if rec is None:
            rec = RolloutRecord(
                cid=cid, namespace=isvc.namespace, name=isvc.name,
                component=cname, revision=latest, stable=stable,
                policy={
                    "steps": list(comp.rollout.steps),
                    "hold_s": comp.rollout.hold_s,
                    "settle_s": comp.rollout.settle_s,
                    "max_error_ratio": comp.rollout.max_error_ratio,
                    "max_latency_regression":
                        comp.rollout.max_latency_regression,
                    "min_requests": comp.rollout.min_requests,
                    "warmup_probes": comp.rollout.warmup_probes,
                    "warmup_timeout_s": comp.rollout.warmup_timeout_s,
                })
            rec.event("started", stable=stable)
            self.records[cid] = rec
            logger.info("rollout started: %s canary=%s stable=%s "
                        "steps=%s", cid, latest, stable,
                        comp.rollout.steps)
        if rec.phase == "warming":
            await self._tick_warming(isvc, cname, comp, cid, rec)
        elif rec.phase == "progressing":
            await self._tick_progressing(isvc, cname, comp, cid, rec)
        self._export_gauges(rec)

    # -- warming -----------------------------------------------------------
    async def _tick_warming(self, isvc, cname: str, comp, cid: str,
                            rec: RolloutRecord) -> None:
        policy = comp.rollout
        if policy.warmup_timeout_s > 0 and \
                time.monotonic() - rec.started_mono > \
                policy.warmup_timeout_s:
            # A revision that never becomes ready is the most common
            # bad-revision symptom; without a deadline it would park
            # the rollout (and its 0%-floor replicas) forever.
            rec.event("gate_failed", reason="warmup_timeout",
                      timeout_s=policy.warmup_timeout_s)
            await self._rollback(isvc, cname, cid, rec,
                                 "warmup_timeout")
            return
        replicas = [r for r in
                    self.controller.reconciler.orchestrator.replicas(cid)
                    if r.revision == rec.revision]
        if not replicas:
            return  # reconciler still actuating
        if policy.warmup_probes > 0:
            all_warm = True
            for r in replicas:
                if rec.warmup.get(r.host, 0) >= policy.warmup_probes:
                    continue
                ok = await self._probe_ready(r.host)
                rec.warmup[r.host] = (rec.warmup.get(r.host, 0) + 1
                                      if ok else 0)
                if rec.warmup[r.host] < policy.warmup_probes:
                    all_warm = False
            if not all_warm:
                return
        rec.event("warmed", replicas=[r.host for r in replicas])
        await self._enter_step(isvc, cname, comp, cid, rec, 0)

    async def _probe_ready(self, host: str) -> bool:
        if self._probe is not None:
            result = self._probe(host)
            if asyncio.iscoroutine(result):
                result = await result
            return bool(result)
        if self._http is None:
            return False
        try:
            status, _, _ = await self._http.request(
                "GET", f"http://{host}/v2/health/ready")
        except Exception:
            return False
        return status == 200

    # -- progressing -------------------------------------------------------
    async def _enter_step(self, isvc, cname: str, comp, cid: str,
                          rec: RolloutRecord, idx: int) -> None:
        percent = comp.rollout.steps[idx]
        rec.phase = "progressing"
        rec.step_idx = idx
        rec.percent = percent
        rec.step_started_mono = time.monotonic()
        rec.settled = comp.rollout.settle_s <= 0
        rec.baseline_canary = _series_sample(self.registry, isvc.name,
                                             rec.revision)
        rec.baseline_stable = _series_sample(self.registry, isvc.name,
                                             rec.stable)
        comp.canary_traffic_percent = percent
        await self.controller.reconciler.reconcile(isvc)
        rec.event("step", index=idx, percent=percent)
        obs.rollout_transitions_total().labels(
            component=cid, event="step").inc()
        logger.info("rollout %s: canary %s -> %d%%", cid,
                    rec.revision, percent)

    async def _tick_progressing(self, isvc, cname: str, comp, cid: str,
                                rec: RolloutRecord) -> None:
        policy = comp.rollout
        if comp.canary_traffic_percent != rec.percent:
            # An external re-apply of the unchanged spec reset the
            # managed split (defaulting pins it to 0).  Re-assert the
            # current step — otherwise a min_requests gate waits
            # forever on a revision receiving no traffic.
            comp.canary_traffic_percent = rec.percent
            await self.controller.reconciler.reconcile(isvc)
        if not rec.settled:
            # Analysis delay (the Kayenta/Flagger shape): the step's
            # first settle_s seconds are cold-start noise — first
            # requests pay lazy imports / compile and would read as a
            # latency regression against a warmed stable.  Gates see
            # only samples observed after the re-baseline below.
            if time.monotonic() - rec.step_started_mono < \
                    comp.rollout.settle_s:
                return
            rec.settled = True
            rec.baseline_canary = _series_sample(
                self.registry, isvc.name, rec.revision)
            rec.baseline_stable = _series_sample(
                self.registry, isvc.name, rec.stable)
        canary = _delta(
            _series_sample(self.registry, isvc.name, rec.revision),
            rec.baseline_canary or {"total": 0, "errors": 0,
                                    "buckets": None, "counts": None})
        stable = _delta(
            _series_sample(self.registry, isvc.name, rec.stable),
            rec.baseline_stable or {"total": 0, "errors": 0,
                                    "buckets": None, "counts": None})
        failure = self._gate_failure(policy, canary, stable)
        if failure is None and await self._canary_slo_breach(isvc, cid,
                                                             rec):
            failure = ("slo_breach",
                       {"detail": "canary replica reports SLO alert"})
        if failure is not None:
            reason, detail = failure
            rec.event("gate_failed", step=rec.step_idx, reason=reason,
                      **detail)
            await self._rollback(isvc, cname, cid, rec, reason)
            return
        held_s = time.monotonic() - rec.step_started_mono
        if held_s < policy.hold_s or canary["total"] < \
                policy.min_requests:
            return
        rec.event("gate_passed", step=rec.step_idx,
                  canary_requests=canary["total"],
                  canary_errors=canary["errors"])
        if rec.step_idx + 1 < len(policy.steps):
            await self._enter_step(isvc, cname, comp, cid, rec,
                                   rec.step_idx + 1)
        else:
            await self._promote(isvc, cname, comp, cid, rec)

    def _gate_failure(self, policy, canary: Dict, stable: Dict
                      ) -> Optional[tuple]:
        """Evaluate the hard gates on this step's window; None = pass.
        Gates only engage once the canary has enough evidence
        (min_requests, floor 1) — an idle canary cannot fail."""
        need = max(policy.min_requests, 1)
        if canary["total"] < need:
            return None
        canary_err = canary["errors"] / canary["total"]
        stable_err = (stable["errors"] / stable["total"]
                      if stable["total"] > 0 else 0.0)
        if canary_err > stable_err + policy.max_error_ratio:
            return ("error_ratio", {
                "canary_error_ratio": round(canary_err, 4),
                "stable_error_ratio": round(stable_err, 4),
                "max_error_ratio": policy.max_error_ratio})
        canary_idx = _p95_bucket(canary)
        stable_idx = _p95_bucket(stable)
        if canary_idx is not None and stable_idx is not None and \
                stable["total"] >= need:
            canary_p95 = _bucket_bound(canary, canary_idx)
            stable_p95 = _bucket_bound(stable, stable_idx)
            # Bucketed percentiles are quantized by the bucket
            # geometry (~2x here): two ADJACENT buckets can differ by
            # 2x with near-identical underlying latencies, so a ratio
            # policy only engages when the p95s sit more than one
            # bucket apart — claims finer than the measurement's
            # resolution are noise, not regressions (live-fire verify:
            # 5ms-vs-10ms bucket adjacency read as a "2x regression").
            if canary_idx > stable_idx + 1 and \
                    canary_p95 > stable_p95 * \
                    policy.max_latency_regression:
                return ("latency_regression", {
                    "canary_p95_ms": canary_p95,
                    "stable_p95_ms": stable_p95,
                    "max_latency_regression":
                        policy.max_latency_regression})
        return None

    async def _canary_slo_breach(self, isvc, cid: str,
                                 rec: RolloutRecord) -> bool:
        """SLO breach attributed to the canary REVISION: only the
        canary's own replicas are consulted, so a fleet-wide burn
        caused by the stable side never blames the canary."""
        hosts = [r.host for r in
                 self.controller.reconciler.orchestrator.replicas(cid)
                 if r.revision == rec.revision]
        if self._slo_check is not None:
            result = self._slo_check(isvc.name, hosts)
            if asyncio.iscoroutine(result):
                result = await result
            return bool(result)
        if self._http is None or not hosts:
            return False
        for host in hosts:
            body = await self._get_json(f"http://{host}/v2/health/slo")
            if body is None:
                continue
            if isvc.name in body.get("alerting", []):
                return True
        return False

    # -- terminal transitions ----------------------------------------------
    async def _promote(self, isvc, cname: str, comp, cid: str,
                       rec: RolloutRecord) -> None:
        comp.canary_traffic_percent = None
        await self.controller.reconciler.promote(isvc, cname)
        rec.percent = 100
        self._finish(rec, "promoted")
        self.records.pop(cid, None)
        obs.rollout_transitions_total().labels(
            component=cid, event="promoted").inc()
        logger.info("rollout %s: canary %s promoted to 100%%", cid,
                    rec.revision)

    async def _rollback(self, isvc, cname: str, cid: str,
                        rec: RolloutRecord, reason: str) -> None:
        # Evidence FIRST: the canary replicas' pinned flight-recorder
        # entries (5xx, deadline sheds, SLO violations auto-pin there)
        # are copied into the record before the rollback reconcile
        # tears those replicas — and their rings — down.
        rec.evidence = await self._collect_evidence(cid, rec)
        quarantined = await self.controller.reconciler.rollback(
            isvc, cname, reason=reason)
        rec.reason = reason
        self._finish(rec, "rolled_back", reason=reason,
                     quarantined=quarantined)
        self.records.pop(cid, None)
        obs.rollout_transitions_total().labels(
            component=cid, event="rolled_back").inc()
        logger.warning("rollout %s: canary %s rolled back (%s), "
                       "%d evidence entries pinned", cid, rec.revision,
                       reason, len(rec.evidence))

    async def _collect_evidence(self, cid: str, rec: RolloutRecord
                                ) -> List[Dict[str, Any]]:
        evidence: List[Dict[str, Any]] = []
        # Supervisor-side evidence first: the orchestrator's pinned
        # failover/swap-failure timelines for this component (a canary
        # that kept crashing shows up HERE — its own ring died with
        # every crash).
        recorder = getattr(self.controller.reconciler.orchestrator,
                           "flight_recorder", None)
        if recorder is not None:
            dump = recorder.dump(limit=EVIDENCE_LIMIT,
                                 pinned_only=True)
            evidence += [dict(e, replica="supervisor")
                         for e in dump.get("pinned", [])
                         if e.get("component") == cid]
        if self._http is None:
            return evidence
        hosts = [r.host for r in
                 self.controller.reconciler.orchestrator.replicas(cid)
                 if r.revision == rec.revision]
        for host in hosts:
            body = await self._get_json(
                f"http://{host}/debug/flightrecorder"
                f"?pinned=1&limit={EVIDENCE_LIMIT}")
            if body is None:
                continue
            evidence += [dict(e, replica=host)
                         for e in body.get("pinned", [])]
        return evidence

    def _finish(self, rec: RolloutRecord, phase: str,
                **detail: Any) -> None:
        rec.phase = phase
        rec.event(phase, **detail)
        self.history.append(rec.to_dict())
        # Series hygiene: revisions that stopped existing with this
        # transition must not leak registry children forever (a
        # control plane doing rollouts daily would otherwise grow
        # /metrics and every analyzer scan without bound).
        dead = {"promoted": rec.stable,
                "rolled_back": rec.revision,
                "superseded": rec.revision}.get(phase)
        if dead:
            obs.revision_requests_total().prune(model=rec.name,
                                                revision=dead)
            obs.revision_request_ms().prune(model=rec.name,
                                            revision=dead)
        # One rollout_state child per component: drop earlier
        # revisions' children, then export this terminal state.
        obs.rollout_state().prune(component=rec.cid)
        self._export_gauges(rec)
