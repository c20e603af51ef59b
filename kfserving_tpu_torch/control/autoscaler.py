"""Concurrency-based replica autoscaling (Knative KPA equivalent).

Reference knobs (pkg/apis/serving/v1beta1/component.go:72-82 +
ksvc_reconciler.go:70-83): min/max replicas and containerConcurrency; the
KPA scales on observed concurrency per replica and supports scale-to-zero
with activator buffering.

This autoscaler samples the router's in-flight gauge each tick, averages
over a sliding window, and converges each component to
ceil(avg_concurrency / target_concurrency), clamped to [min, max].
Scale-to-zero fires after `idle_ticks` windows of zero traffic when
min_replicas == 0 (cold start is then the router's _activate path, which
on TPU includes compile time — the persistent compile cache is what makes
it tolerable, SURVEY.md §5.3).

With a `PredictiveScaler` attached (control/predictive.py) each tick
additionally runs the feed-forward plan: burn-driven sizing from the
router's latency/arrival series, standby pre-arming, and brownout
entry/exit — the reactive signal then acts as the floor, the
prediction as the leading edge.
"""

import asyncio
import logging
import math
from collections import deque
from typing import Dict, Optional

from kfserving_tpu_torch.observability import metrics as obs
from kfserving_tpu_torch.reliability import fault_sites, faults

logger = logging.getLogger("kfserving_tpu_torch.control.autoscaler")

DEFAULT_TARGET_CONCURRENCY = 4.0
WINDOW_TICKS = 6
IDLE_TICKS_TO_ZERO = 30
# Generative scaling target: keep engine slot pools at or below this
# utilization (occupancy + queued prefills vs capacity) — the KPA
# "target concurrency" analogue for slot-structured load.
TARGET_SLOT_UTIL = 0.8
# Consecutive failed ticks before the dead control loop is pinned into
# the supervisor flight recorder (one-off failures just retry).
STALL_TICKS = 3


class Autoscaler:
    def __init__(self, controller, router,
                 target_concurrency: float = DEFAULT_TARGET_CONCURRENCY,
                 tick_seconds: float = 2.0,
                 predictive: Optional[object] = None):
        self.controller = controller
        self.router = router
        self.target_concurrency = target_concurrency
        self.tick_seconds = tick_seconds
        # PredictiveScaler (control/predictive.py) or None (purely
        # reactive).
        self.predictive = predictive
        self._windows: Dict[str, deque] = {}
        self._idle: Dict[str, int] = {}
        self._consecutive_failures = 0
        self._stall_pinned = False
        self._task = None

    async def start(self):
        self._task = asyncio.create_task(self._loop())

    async def stop(self):
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _loop(self):
        while True:
            try:
                await self.tick()
            except Exception:
                # Swallowing alone made a dead control loop invisible
                # until the next overload: count every failure and pin
                # evidence once the loop is provably stalled, so
                # /debug/flightrecorder (replica="supervisor") shows
                # it before the capacity gap does.
                logger.exception("autoscaler tick failed")
                self._note_tick_failure()
            else:
                self._consecutive_failures = 0
                self._stall_pinned = False
            await asyncio.sleep(self.tick_seconds)

    def _note_tick_failure(self) -> None:
        obs.autoscaler_tick_failures_total().inc()
        self._consecutive_failures += 1
        if self._consecutive_failures < STALL_TICKS or \
                self._stall_pinned:
            return
        self._stall_pinned = True
        from kfserving_tpu_torch.control.predictive import (
            ensure_flight_recorder,
        )

        recorder = ensure_flight_recorder(
            self.controller.reconciler.orchestrator)
        if recorder is not None:
            recorder.record({
                "kind": "autoscaler_stalled",
                "consecutive_failures": self._consecutive_failures,
                "tick_seconds": self.tick_seconds,
            }, pin="autoscaler_stalled")
        logger.error("autoscaler control loop stalled: %d consecutive "
                     "tick failures", self._consecutive_failures)

    async def tick(self):
        """One scaling evaluation (callable directly in tests).  The
        predictive signal snapshot and the brownout evaluation run
        BEFORE the per-component actuation (and before its fault
        site): a wedged scale() must not keep the brownout gate from
        engaging."""
        if self.predictive is not None:
            self.predictive.observe()
        for name, isvc in list(self.controller.specs.items()):
            if self.predictive is not None:
                # isvc.name, not the namespaced specs key: objectives
                # and the router's series are keyed by model name.
                self.predictive.evaluate_brownout(isvc.name, isvc)
            for cname, comp in isvc.components().items():
                if faults.configured(fault_sites.AUTOSCALER_TICK):
                    await faults.inject(fault_sites.AUTOSCALER_TICK,
                                        key=f"{name}/{cname}")
                await self._scale_component(name, isvc, cname, comp)

    def _occupancy_desired(self, cid: str) -> int:
        """Generative saturation: replicas needed so engine slot
        occupancy (busy slots + queued prefills) sits at or below
        TARGET_SLOT_UTIL of pool capacity.  Returns 0 for components
        without a generation engine (the request-count signal rules
        alone there).  Reads in-process replica handles; subprocess
        replicas without a handle contribute nothing (their load still
        shows in the router's request gauge)."""
        replicas = self.controller.reconciler.orchestrator.replicas(cid)
        busy = 0
        per_replica_cap = 0
        for r in replicas:
            repo = getattr(getattr(r, "handle", None),
                           "repository", None)
            if repo is None:
                continue
            replica_cap = 0
            for m in repo.get_models():
                eng = getattr(m, "engine", None)
                gauges = getattr(eng, "load_gauges", None)
                if gauges is None:
                    continue
                g = gauges()
                busy += g["active_slots"] + g["pending"]
                replica_cap += g["max_slots"]
            # A replica's capacity is the SUM of its engines' pools (a
            # repository may host several generative models).
            per_replica_cap = max(per_replica_cap, replica_cap)
        if per_replica_cap == 0:
            return 0
        return math.ceil(busy / (TARGET_SLOT_UTIL * per_replica_cap))

    async def _scale_component(self, name, isvc, cname, comp):
        gauge_key = f"router/{isvc.name}/{cname}"
        inflight = self.router.inflight.get(gauge_key, 0)
        cid = self.controller.reconciler.component_id(isvc, cname)
        # A generative replica's true load signal: slot occupancy +
        # pending prefill depth.  Request count alone cannot see a
        # replica saturated by a handful of long-lived streams.
        occupancy_load = self._occupancy_desired(cid)
        window = self._windows.setdefault(
            f"{name}/{cname}", deque(maxlen=WINDOW_TICKS))
        window.append(inflight)
        avg = sum(window) / len(window)
        target = (comp.container_concurrency
                  or self.target_concurrency)
        desired = math.ceil(avg / target) if avg > 0 else 0
        desired = max(desired, occupancy_load)
        # Feed-forward: the predictive plan (burn rate x latency
        # model, chain-joint) leads; the reactive average is the
        # floor.  Pre-arming/evidence happen inside the plan call.
        if self.predictive is not None:
            current = len(
                self.controller.reconciler.orchestrator.replicas(cid))
            desired = max(desired, self.predictive.desired_replicas(
                isvc.name, isvc, cname, comp, cid, current))
        key = f"{name}/{cname}"
        if desired == 0:
            self._idle[key] = self._idle.get(key, 0) + 1
            if comp.min_replicas == 0 and \
                    self._idle[key] >= IDLE_TICKS_TO_ZERO:
                await self.controller.reconciler.scale(isvc, cname, 0)
                return
            desired = max(comp.min_replicas, 0)
            if desired == 0:
                return  # stay as-is until idle threshold
        else:
            self._idle[key] = 0
        current = len(
            self.controller.reconciler.orchestrator.replicas(cid))
        clamped = max(comp.min_replicas, min(comp.max_replicas, desired))
        if clamped != current and clamped > 0:
            logger.info("scaling %s/%s %d -> %d (avg conc %.1f)",
                        name, cname, current, clamped, avg)
            await self.controller.reconciler.scale(isvc, cname, clamped)
