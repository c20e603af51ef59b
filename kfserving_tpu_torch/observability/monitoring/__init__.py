"""Online model monitoring: the loop that acts on the request telemetry.

Port of ``kfserving_tpu/observability/monitoring/``:

- ``bus``             -- bounded, sampling, never-blocking request tee
                         feeding async consumers;
- ``monitors``        -- streaming drift / outlier monitors exporting
                         per-model score, rate and alert-state series;
- ``slo``             -- per-model latency/error objectives evaluated
                         as multi-window burn rates, served at
                         ``GET /v2/health/slo``;
- ``flight_recorder`` -- ring buffer of recent request timelines that
                         pins SLO breaches, deadline sheds and latency
                         outliers, at ``GET /debug/flightrecorder``.

``Monitoring`` is the per-server facade the ModelServer owns: it wires
the bus onto the request-hook point, runs the SLO evaluation loop as a
server service, and assembles flight-recorder entries (stage timings,
tracer spans, cost record, engine timeline events) on every request
completion.

Nothing here imports ``server/``, ``engine/`` or ``reliability/``: the
server hands itself in.
"""

import asyncio
import logging
from typing import Any, Dict, List, Optional

from kfserving_tpu_torch.observability.monitoring.bus import MonitorBus
from kfserving_tpu_torch.observability.monitoring.flight_recorder import (
    FlightRecorder,
)
from kfserving_tpu_torch.observability.monitoring.knobs import env_number
from kfserving_tpu_torch.observability.monitoring.monitors import (
    DriftMonitor,
    OutlierMonitor,
)
from kfserving_tpu_torch.observability.monitoring.slo import (
    DEFAULT_EVAL_S,
    ENV_EVAL,
    SLOEngine,
    SLOObjective,
)

logger = logging.getLogger("kfserving_tpu_torch.monitoring")

__all__ = [
    "MonitorBus", "FlightRecorder", "DriftMonitor", "OutlierMonitor",
    "SLOEngine", "SLOObjective", "Monitoring",
]

# Span names whose timings make up a request's flight-recorder
# timeline (the cross-layer stages the tracer records).
_TIMELINE_SPAN_PREFIXES = ("server.", "dataplane.", "batcher.",
                           "engine.", "generator.")


class Monitoring:
    """Per-ModelServer monitoring loop: bus + monitors + SLO engine +
    flight recorder.  Constructed with the server (cheap — no tasks);
    `start()`/`stop()` run as one of the server's background
    services."""

    def __init__(self, server):
        self.server = server
        self.bus = MonitorBus.from_env()
        self.bus.attach(server)
        self.flight_recorder = FlightRecorder.from_env()
        # The server's private request registry: both HTTP and gRPC
        # requests land there, so the SLO sees every protocol.
        self.slo = SLOEngine.from_env([server.metrics.registry])
        self.eval_interval_s = env_number(ENV_EVAL, DEFAULT_EVAL_S)
        self._slo_task: Optional[asyncio.Task] = None

    # -- service lifecycle -------------------------------------------------
    async def start(self) -> None:
        await self.bus.start()
        if self.slo.enabled and self._slo_task is None:
            self.slo.tick()  # baseline snapshot at serving start
            self._slo_task = asyncio.get_running_loop().create_task(
                self._slo_loop())

    async def stop(self) -> None:
        if self._slo_task is not None:
            self._slo_task.cancel()
            try:
                await self._slo_task
            except asyncio.CancelledError:
                pass
            self._slo_task = None
        await self.bus.stop()

    async def _slo_loop(self) -> None:
        while True:
            await asyncio.sleep(max(0.05, self.eval_interval_s))
            try:
                self.slo.tick()
            except Exception:  # evaluation must never kill the loop
                logger.exception("SLO evaluation failed")

    # -- monitor wiring ----------------------------------------------------
    def add_drift_monitor(self, monitor: DriftMonitor) -> DriftMonitor:
        self.bus.subscribe(monitor)
        return monitor

    def add_outlier_monitor(self, monitor: OutlierMonitor
                            ) -> OutlierMonitor:
        self.bus.subscribe(monitor)
        return monitor

    # -- flight recording --------------------------------------------------
    def record_request(self, model: str, verb: str, status: int,
                       latency_ms: float,
                       trace_id: Optional[str] = None,
                       stages: Optional[Dict[str, float]] = None
                       ) -> None:
        """Assemble and record one request's timeline; evaluates the
        pin triggers.  Called from the server's completion path —
        must never raise into it."""
        try:
            pin = self._pin_reason(model, status, latency_ms)
            is_outlier = self.flight_recorder.observe_latency(
                model, latency_ms)
            if pin is None and is_outlier:
                pin = "latency_outlier"
            entry = {
                "trace_id": trace_id,
                "model": model,
                "verb": verb,
                "status": status,
                "latency_ms": round(latency_ms, 3),
                "stages": stages or {},
            }
            # Cost attribution: the request's cost record
            # (attributed device ms, prefill/decode tokens, blocks
            # held, cache-saved tokens) rides every entry it exists
            # for — a pinned p99 outlier then shows what the request
            # COST, not just how long it took.  One bounded-dict
            # lookup; absent for non-generative verbs.
            if trace_id:
                from kfserving_tpu_torch.observability import attribution

                cost = attribution.lookup(trace_id)
                if cost is not None:
                    entry["cost"] = cost
            # Eager span capture ONLY for pinned entries: pinned
            # evidence must not depend on the tracer ring still
            # holding the spans at dump time, but scanning the ring
            # for every healthy request would put an O(ring) copy +
            # tracer-lock hit on the serving hot path.  Un-pinned
            # ring entries resolve their timeline lazily at dump
            # (best-effort — spans may have rotated out).
            if pin:
                entry["timeline"] = self._timeline(trace_id)
                # Device-path evidence: the engine events
                # overlapping this request's span — a p99-outlier pin
                # shows WHICH decode wave / prefill chunk / preemption
                # / HOLD window produced the tail, not just that the
                # engine stage was slow.
                entry["engine_events"] = self._engine_events(
                    latency_ms)
            self.flight_recorder.record(entry, pin=pin)
        except Exception:
            logger.exception("flight-recorder capture failed")

    def dump_flightrecorder(self, limit: int = 100,
                            pinned_only: bool = False,
                            pin_type: Optional[str] = None,
                            since_ts: Optional[float] = None
                            ) -> Dict[str, Any]:
        """The /debug/flightrecorder body: recorder dump with lazy
        timeline resolution for ring entries recorded without one (a
        debug endpoint can afford the tracer scans the hot path
        can't).  `pin_type`/`since_ts` pass through to the recorder's
        pin-stream filters."""
        dump = self.flight_recorder.dump(limit=limit,
                                         pinned_only=pinned_only,
                                         pin_type=pin_type,
                                         since_ts=since_ts)
        # Copies, not in-place writes: dump() hands back the stored
        # dicts, which the recording path may be appending around.
        dump["entries"] = [
            entry if "timeline" in entry
            else dict(entry,
                      timeline=self._timeline(entry.get("trace_id")))
            for entry in dump["entries"]]
        return dump

    def _pin_reason(self, model: str, status: int,
                    latency_ms: float) -> Optional[str]:
        if status == 504:
            return "deadline_shed"
        if status == 503:
            # Admission-queue overflow / model not ready: capacity
            # evidence, distinct from a 5xx failure.
            return "unavailable"
        if status >= 500:
            return "error"
        objective = self.slo.objective_for(model)
        if objective is not None and objective.latency_ms is not None \
                and latency_ms > objective.latency_ms:
            return ("slo_breach" if self.slo.alerting(model)
                    else "slo_violation")
        return None

    @staticmethod
    def _engine_events(latency_ms: float,
                       limit: int = 64) -> List[Dict[str, Any]]:
        """Engine timeline events overlapping the just-finished
        request's wall-clock span (+50 ms of slack on the open end:
        the pin evaluates microseconds after the request closed, and
        the wave that delivered its last token may be stamped a hair
        later)."""
        import time as _time

        from kfserving_tpu_torch.observability.profiling import TIMELINE

        now = _time.time()
        return TIMELINE.window(now - latency_ms / 1000.0 - 0.05,
                               now + 0.05, limit=limit)

    @staticmethod
    def _timeline(trace_id: Optional[str]) -> List[Dict[str, Any]]:
        """The request's stage spans (batcher queue wait, engine
        prepare/transfer/compute/fetch with batch fill, generator
        decode, dataplane stages), captured NOW — pinned evidence must
        not depend on the tracer ring still holding the spans at dump
        time."""
        if not trace_id:
            return []
        from kfserving_tpu_torch.tracing import tracer

        return [s for s in tracer.spans(trace_id, limit=64)
                if s["name"].startswith(_TIMELINE_SPAN_PREFIXES)]
