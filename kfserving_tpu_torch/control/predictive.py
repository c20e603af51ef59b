"""Feed-forward predictive scaling: close the loop from burn rate to
capacity.

The reactive autoscaler (autoscaler.py) sizes replicas from
*instantaneous* in-flight concurrency — by the time a traffic step
shows up in that gauge, the p99 objective is already breached, and
when capacity physically cannot arrive in time there is no
graceful-degradation path at all.  InferLine (arXiv:1812.01776) shows
latency-objective-driven provisioning planned over the whole pipeline
beats per-stage reactivity; this module is that planner for the
single-host fabric:

- **Signals** — the SLO engine's multi-window burn rates evaluated at
  the ROUTER's vantage point (the per-revision request series the
  router feeds per upstream attempt: `kfserving_tpu_revision_*`),
  plus the router's per-component arrival-rate counters.  The burn
  rate is the leading edge: it trips within one short window of a
  step, long before the in-flight average window turns over.
- **Sizing** — Little's law over observed traffic: required
  concurrency = arrival rate x observed service time; replicas =
  ceil(required / (target_util x per-replica concurrency)).  Observed
  service time comes from the latency histogram (bucket-midpoint
  mean), so queue growth inflates the estimate and the plan
  over-provisions exactly when the queue is the problem.
- **Actuation** — the standby pool is PRE-ARMED to the predicted size
  (`set_standby_target`), so the scale-up the autoscaler then issues
  actuates as a one-tick standby activation, not a cold spawn.
- **Chains** — an InferenceService with a transformer is provisioned
  JOINTLY: the entry component's arrival rate floors every downstream
  component's arrival (each transformer request fans a predictor call
  through the ingress direct lane), so the predictor scales with the
  step the transformer just saw instead of waiting to measure it
  (the serverless-dataflow chain view, arXiv:2007.05832).
- **Brownout** — when the predicted gap exceeds what current replicas
  + armed standbys can cover (or max_replicas caps it), the router's
  BrownoutController sheds the lowest-priority traffic with explicit
  retriable 503s instead of blowing p99 for everyone; exit is
  automatic as the burn rate recovers.

Every decision (inputs, predicted gap, action) is pinned into the
supervisor flight recorder — federated at `/debug/flightrecorder` as
replica="supervisor" — and counted in
`kfserving_tpu_autoscaler_decisions_total`.

Port of ``kfserving_tpu/control/predictive.py``, the same sizing and
brownout rules over the port's router, orchestrators and SLO engine.
"""

import logging
import math
import time
from typing import Any, Dict, List, Optional, Tuple

from kfserving_tpu_torch.observability import REGISTRY
from kfserving_tpu_torch.observability import metrics as obs
from kfserving_tpu_torch.observability.metrics import (
    REVISION_LATENCY_SERIES,
    REVISION_REQUESTS_SERIES,
)
from kfserving_tpu_torch.observability.monitoring import FlightRecorder
from kfserving_tpu_torch.observability.monitoring.slo import (
    SLOEngine,
    SLOObjective,
    _window_label,
    objectives_from_env,
)

logger = logging.getLogger("kfserving_tpu_torch.control.predictive")

# Control-plane burn windows: much shorter than the replica-side
# default (60/300 s) — the control loop must see a step within a few
# ticks, and a single-spike false positive costs one pre-armed
# standby, not a page.
DEFAULT_WINDOWS_S = (10.0, 60.0)
DEFAULT_TARGET_UTIL = 0.8
DEFAULT_BURN_EXIT = 1.0
DEFAULT_EXIT_TICKS = 3
DEFAULT_MAX_BROWNOUT_LEVEL = 2
# When a component declares no containerConcurrency the reactive
# autoscaler falls back to its target concurrency; the sizing model
# needs the same per-replica capacity assumption.
DEFAULT_FALLBACK_CONCURRENCY = 4
# Slope-aware gap sizing (off by default): how far ahead
# the history detector's latency trend slope is projected when
# inflating the observed service time.
DEFAULT_SLOPE_HORIZON_S = 15.0
# The watched latency series whose trend slope feeds the projection
# (ms of p99 per second) — the router's own per-revision view first,
# the replicas' request-latency view as fallback.
SLOPE_SERIES_NAMES = (
    "kfserving_tpu_revision_request_ms_p99",
    "kfserving_tpu_request_latency_ms_p99",
)


def ensure_flight_recorder(orchestrator) -> Optional[FlightRecorder]:
    """The supervisor flight recorder for decision evidence.  The
    subprocess orchestrator carries one (its failover timelines);
    in-process/fake orchestrators get one attached on first use so
    the router's replica="supervisor" federation serves the decision
    trail on every backend."""
    recorder = getattr(orchestrator, "flight_recorder", None)
    if recorder is None:
        recorder = FlightRecorder.from_env()
        try:
            orchestrator.flight_recorder = recorder
        except Exception:  # frozen/slotted test double: no evidence
            return None
    return recorder


class PredictiveScaler:
    """The feed-forward half of the autoscaler: burn-driven sizing,
    standby pre-arming, and brownout entry/exit.  One instance per
    control plane; the Autoscaler calls `observe()` once per tick and
    `desired_replicas()` / `evaluate_brownout()` per component/model.
    """

    def __init__(self, controller, router,
                 objectives: Optional[Dict[str, SLOObjective]] = None,
                 windows_s: Tuple[float, ...] = DEFAULT_WINDOWS_S,
                 burn_alert: Optional[float] = None,
                 burn_exit: float = DEFAULT_BURN_EXIT,
                 exit_ticks: int = DEFAULT_EXIT_TICKS,
                 target_util: float = DEFAULT_TARGET_UTIL,
                 brownout=None,
                 max_brownout_level: int = DEFAULT_MAX_BROWNOUT_LEVEL,
                 slope_aware: bool = False,
                 slope_horizon_s: float = DEFAULT_SLOPE_HORIZON_S):
        self.controller = controller
        self.router = router
        self.brownout = brownout
        self.target_util = target_util
        # Slope-aware gap sizing: when on, the history
        # detector's trend-slope gauge inflates the observed service
        # time by the projected latency growth over `slope_horizon_s`
        # — capacity for where the latency is HEADING, one window
        # before the mean catches up.  Off (the default) leaves the
        # sizing math exactly as before.
        self.slope_aware = slope_aware
        self.slope_horizon_s = slope_horizon_s
        self.burn_exit = burn_exit
        self.exit_ticks = max(1, int(exit_ticks))
        self.max_brownout_level = max_brownout_level
        if objectives is None:
            objectives = objectives_from_env()
        # Burn-rate evaluation at the router's vantage point: same
        # multi-window math as the replicas' engines, over the
        # per-revision series the router records per upstream attempt.
        # export_gauges=False — the replicas own the slo_* gauge
        # children for their models; this engine reports through the
        # decision records instead.
        slo_kwargs: Dict[str, Any] = dict(
            objectives=objectives, windows_s=windows_s,
            total_series=REVISION_REQUESTS_SERIES,
            latency_series=REVISION_LATENCY_SERIES,
            export_gauges=False)
        if burn_alert is not None:
            slo_kwargs["burn_alert"] = burn_alert
        self.slo = SLOEngine([REGISTRY], **slo_kwargs)
        # (monotonic t, {gauge_key: cumulative router request count}).
        self._count_snaps: List[Tuple[float, Dict[str, int]]] = []
        # Last sized plan per component id (one tick's cache, consumed
        # by evaluate_brownout after the components scaled).
        self._plans: Dict[str, Dict[str, Any]] = {}
        # Per-model brownout bookkeeping.
        self._calm_ticks: Dict[str, int] = {}
        self._last_sized: Dict[str, int] = {}
        # Components whose standby pool this loop pre-armed: the
        # target must be handed back to the backend default when the
        # loop disengages, or one transient spike parks warm
        # processes at peak depth forever.
        self._pre_armed: set = set()
        self.decisions: List[Dict[str, Any]] = []

    @property
    def enabled(self) -> bool:
        return self.slo.enabled

    # -- signal collection --------------------------------------------------
    def observe(self, now: Optional[float] = None) -> None:
        """One tick's signal snapshot: burn rates (SLO engine tick)
        plus the router's per-component arrival counters."""
        now = time.monotonic() if now is None else now
        self.slo.tick(now)
        # OFFERED load (counted before the router's brownout gate):
        # shedding must not erase the demand signal that justified it.
        self._count_snaps.append((now, dict(self.router.offered_count)))
        horizon = now - self.slo.windows_s[-1]
        while len(self._count_snaps) > 2 and \
                self._count_snaps[1][0] <= horizon:
            self._count_snaps.pop(0)
        if self.brownout is not None:
            for model in self._models_with_traffic():
                service_s = self.service_estimate_s(model)
                if service_s is not None:
                    self.brownout.update_estimate(model, service_s)

    def _models_with_traffic(self) -> List[str]:
        if not self._count_snaps:
            return []
        models = set()
        for key in self._count_snaps[-1][1]:
            parts = key.split("/")
            if len(parts) == 3:
                models.add(parts[1])
        return sorted(models)

    def arrival_rate(self, gauge_key: str,
                     window_s: Optional[float] = None) -> float:
        """Requests/s at one router gauge over the SHORT window (the
        leading signal — by design it reacts within one window of a
        step)."""
        if not self._count_snaps:
            return 0.0
        window_s = window_s or self.slo.windows_s[0]
        now_t, now_counts = self._count_snaps[-1]
        base_t, base_counts = self._count_snaps[0]
        for t, counts in self._count_snaps:
            if t <= now_t - window_s:
                base_t, base_counts = t, counts
            else:
                break
        dt = now_t - base_t
        if dt <= 0:
            return 0.0
        delta = now_counts.get(gauge_key, 0) - \
            base_counts.get(gauge_key, 0)
        return max(0.0, delta / dt)

    def service_estimate_s(self, model: str) -> Optional[float]:
        """Observed mean service time (seconds) from the router's
        per-revision latency histogram over the short window: bucket-
        midpoint weighted mean (the registry histogram keeps no sum).
        Queue wait is included on purpose — when the queue grows, the
        plan must grow with it."""
        snaps = self.slo._snapshots
        if not snaps:
            return None
        now_t, now_snap = snaps[-1]
        base = self.slo._baseline(now_t - self.slo.windows_s[0])
        cur = now_snap.get(model)
        if cur is None or cur.get("lat_counts") is None:
            return None
        counts = list(cur["lat_counts"])
        buckets = cur["lat_buckets"]
        prev = (base or {}).get(model)
        if prev is not None and prev.get("lat_counts") is not None \
                and len(prev["lat_counts"]) == len(counts):
            counts = [a - b for a, b in zip(counts,
                                            prev["lat_counts"])]
        total = sum(c for c in counts if c > 0)
        if total <= 0 or not buckets:
            return None
        weighted = 0.0
        lower = 0.0
        for bound, count in zip(buckets, counts):
            if count > 0:
                weighted += count * (lower + bound) / 2.0
            lower = bound
        if len(counts) > len(buckets) and counts[-1] > 0:
            weighted += counts[-1] * buckets[-1] * 1.5  # +Inf bucket
        return (weighted / total) / 1000.0

    def _latency_slope_ms_per_s(self, model: str) -> Optional[float]:
        """The history detector's trend slope for this model's watched
        latency-p99 series (ms per second), worst series wins.  None
        when no history subsystem exports the gauge — the slope-aware
        path then degrades to exactly the slope-off sizing."""
        fam = REGISTRY.family(obs.TREND_SLOPE_SERIES)
        if fam is None:
            return None
        worst: Optional[float] = None
        for labels, child in fam.samples():
            if labels.get("series") not in SLOPE_SERIES_NAMES:
                continue
            if labels.get("model") != model:
                continue
            if worst is None or child.value > worst:
                worst = child.value
        return worst

    def burn_state(self, model: str
                   ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
        """(fast_burn, burn_rates) for a model.  Fast burn = the
        SHORTEST window burns past the alert threshold while the
        longest is not already cooling below it — the leading-edge
        trend, not the sustained multi-window page condition."""
        report = self.slo._last_report or {}
        entry = (report.get("models") or {}).get(model)
        if not entry:
            return False, {}
        rates = entry.get("burn_rates", {})
        short_l = _window_label(self.slo.windows_s[0])
        long_l = _window_label(self.slo.windows_s[-1])
        for component_rates in rates.values():
            short = component_rates.get(short_l)
            long_r = component_rates.get(long_l, 0.0)
            if short is not None and short > self.slo.burn_alert \
                    and short >= long_r:
                return True, rates
        return False, rates

    # -- sizing -------------------------------------------------------------
    def desired_replicas(self, name: str, isvc, cname: str, comp,
                         cid: str, current: int) -> int:
        """Feed-forward replica count for one component (0 = not
        engaged; the reactive signal rules alone).  Side effects: the
        standby pool is pre-armed toward the prediction and the sizing
        decision lands in the flight recorder."""
        if not self.enabled:
            return 0
        objective = self.slo.objective_for(name)
        if objective is None:
            return 0
        fast_burn, burn_rates = self.burn_state(name)
        gauge_key = f"router/{name}/{cname}"
        arrival = self.arrival_rate(gauge_key)
        # Chain-joint provisioning: the entry component's arrival
        # floors every downstream component's — the step the
        # transformer just absorbed reaches the predictor one proxy
        # hop later, so provision it NOW, not after it is measured.
        entry = self.router._entry_component(isvc, "predict")
        if cname != entry:
            arrival = max(arrival,
                          self.arrival_rate(f"router/{name}/{entry}"))
        service_s = self.service_estimate_s(name)
        slope_ms_per_s = None
        if self.slope_aware and service_s:
            # Leading input: project the observed service
            # time to where the trend says latency will BE one
            # horizon out.  Only a rising slope inflates — a falling
            # one must not shrink capacity below what is measured.
            slope_ms_per_s = self._latency_slope_ms_per_s(name)
            if slope_ms_per_s is not None and slope_ms_per_s > 0:
                service_s = service_s + (slope_ms_per_s / 1000.0) \
                    * self.slope_horizon_s
        plan: Dict[str, Any] = {
            "component": cid,
            "arrival_per_s": round(arrival, 3),
            "service_ms": (round(service_s * 1000.0, 3)
                           if service_s else None),
            "burn_rates": burn_rates,
            "fast_burn": fast_burn,
            "current": current,
            "max_replicas": comp.max_replicas,
        }
        if self.slope_aware:
            plan["slope_ms_per_s"] = (
                round(slope_ms_per_s, 4)
                if slope_ms_per_s is not None else None)
            plan["slope_horizon_s"] = self.slope_horizon_s
        # The sizing itself runs UNGATED (brownout needs the demand
        # picture even after shedding calmed the latency series);
        # only the scaling/pre-arm actuation is gated on fast burn.
        required = 0
        if arrival > 0 and service_s:
            per_replica = comp.container_concurrency \
                or DEFAULT_FALLBACK_CONCURRENCY
            required_conc = arrival * service_s  # Little's law
            required = max(1, math.ceil(
                required_conc / (self.target_util * per_replica)))
        plan["required"] = required
        self._plans[cid] = plan
        if not fast_burn and not self._engaged(name):
            obs.autoscaler_predicted_replicas().labels(
                component=cid).set(0.0)
            self._last_sized.pop(cid, None)
            # Disengaging (spike ended, burn calm): any pre-armed
            # pool depth goes back to the backend default NOW — the
            # `required <= current` reset below may never be reached
            # when arrival collapsed with the spike.
            self._reset_pool(cid)
            return 0
        if required == 0:
            return 0
        obs.autoscaler_predicted_replicas().labels(
            component=cid).set(float(required))
        sized = min(required, comp.max_replicas)
        if required > current and \
                self._last_sized.get(cid) != required:
            self._last_sized[cid] = required
            self._pre_arm(cid, required, current, plan)
        elif required <= current:
            self._last_sized.pop(cid, None)
            self._reset_pool(cid)
        return sized

    def _engaged(self, model: str) -> bool:
        """Stay engaged while a brownout is active: shedding calms
        the burn rate by construction, and releasing the predicted
        replica floor on that calm would scale down into the very
        overload being shed."""
        return self.brownout is not None and \
            self.brownout.level(model) > 0

    def _pre_arm(self, cid: str, required: int, current: int,
                 plan: Dict[str, Any]) -> None:
        """Arm the standby pool toward the predicted gap and pin the
        sizing decision.  The scale-up itself is the autoscaler's
        (which now adopts armed standbys in _scale_revisions)."""
        gap = max(0, required - current)
        orch = self.controller.reconciler.orchestrator
        set_target = getattr(orch, "set_standby_target", None)
        action = "scale_up"
        if set_target is not None and gap > 0:
            set_target(cid, gap)
            self._pre_armed.add(cid)
            action = "pre_arm"
        self._record(dict(
            kind="predictive_scaling", action=action,
            predicted_gap=gap, standby_target=gap if
            action == "pre_arm" else None, **plan))

    def _reset_pool(self, cid: str) -> None:
        """Hand a pre-armed pool back to the backend default.  Target
        0 means "your own floor": the subprocess backend clamps back
        to its lifecycle default of 1 (crash failover always wants a
        warm successor), the in-process backend back to 0 (its pool
        exists only while pre-armed)."""
        if cid not in self._pre_armed:
            return
        self._pre_armed.discard(cid)
        orch = self.controller.reconciler.orchestrator
        set_target = getattr(orch, "set_standby_target", None)
        if set_target is not None:
            set_target(cid, 0)

    # -- brownout entry/exit ------------------------------------------------
    def evaluate_brownout(self, name: str, isvc) -> None:
        """Per-model brownout decision, after this tick's components
        were sized: enter/escalate while the predicted gap exceeds
        what replicas + armed standbys can cover, step back down as
        the burn rate recovers."""
        if self.brownout is None or not self.enabled:
            return
        if self.slo.objective_for(name) is None:
            return
        fast_burn, burn_rates = self.burn_state(name)
        orch = self.controller.reconciler.orchestrator
        gap = 0
        worst: Optional[Dict[str, Any]] = None
        for cname in isvc.components():
            cid = self.controller.reconciler.component_id(isvc, cname)
            plan = self._plans.get(cid)
            if not plan or not plan.get("required"):
                continue
            standby_count = getattr(orch, "standby_count",
                                    lambda c: 0)(cid)
            coverage = min(plan["required"],
                           plan["current"] + standby_count,
                           plan["max_replicas"])
            comp_gap = plan["required"] - coverage
            if comp_gap > gap:
                gap, worst = comp_gap, dict(plan,
                                            coverage=coverage)
        level = self.brownout.level(name)
        if fast_burn and gap > 0:
            self._calm_ticks.pop(name, None)
            new_level = min(level + 1, self.max_brownout_level)
            direction = self.brownout.set_level(name, new_level)
            if direction is not None:
                self._record({
                    "kind": "brownout", "model": name,
                    "action": ("brownout_enter" if direction == "enter"
                               else "brownout_escalate"),
                    "level": new_level,
                    "predicted_gap": gap,
                    "inputs": worst or {"burn_rates": burn_rates},
                }, component=name)
            return
        if level <= 0:
            self._calm_ticks.pop(name, None)
            return
        # Recovery hysteresis: the SHORT window must sit below the
        # exit threshold for exit_ticks consecutive ticks before each
        # step down.  While the predicted gap persists, recovery
        # stops at level 1 (shedding calms the admitted-traffic burn
        # by construction — a full exit on that calm would oscillate
        # the floodgates open and shut every few ticks); the final
        # exit to level 0 waits for the demand gap itself to clear.
        # Levels ABOVE 1 do step down under a calm burn even mid-gap:
        # escalation past the minimal shed is re-earned per tick, so
        # traffic that fits the remaining capacity is not shed a
        # moment longer than the burn justifies.
        short = 0.0
        for component_rates in burn_rates.values():
            short = max(short, component_rates.get(
                _window_label(self.slo.windows_s[0]), 0.0))
        if short >= self.burn_exit or (gap > 0 and level <= 1):
            self._calm_ticks[name] = 0
            return
        calm = self._calm_ticks.get(name, 0) + 1
        self._calm_ticks[name] = calm
        if calm < self.exit_ticks:
            return
        self._calm_ticks[name] = 0
        direction = self.brownout.set_level(name, level - 1)
        if direction is not None:
            self._record({
                "kind": "brownout", "model": name,
                "action": ("brownout_exit" if level - 1 == 0
                           else "brownout_recover"),
                "level": level - 1,
                "inputs": {"burn_rates": burn_rates,
                           "short_window_burn": short},
            }, component=name)

    # -- evidence -----------------------------------------------------------
    def _record(self, entry: Dict[str, Any],
                component: Optional[str] = None) -> None:
        action = entry.get("action", "decision")
        obs.autoscaler_decisions_total().labels(
            component=component or entry.get("component", ""),
            action=action).inc()
        self.decisions.append(entry)
        del self.decisions[:-256]  # bounded local trail
        recorder = ensure_flight_recorder(
            self.controller.reconciler.orchestrator)
        if recorder is not None:
            recorder.record(dict(entry), pin=entry["kind"])
        logger.info("predictive decision: %s", entry)
