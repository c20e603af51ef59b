"""IncidentManager: detector firings -> diagnosed incident records.

Port of ``kfserving_tpu/observability/incidents/manager.py``, unchanged
in behaviour.  Every detector firing becomes a TRIGGER that either opens
an incident or attaches to the open one for its dedup key (the model
under breach, ``_server`` for process-wide storms and sanitizer
violations), so one regression produces one record instead of several
disconnected pins.

On open the manager snapshots an evidence bundle (history frames of the
watched series, the overlapping pinned flight-recorder entries, the
engine-timeline slice of the breach window, the top-K cost records by
device ms and held blocks, and the snapshot providers the server
injected, such as the ``/debug/cache`` state), runs the classifier
(``classify.py``) over it and stores the ranked hypotheses; the
classifier re-runs on every attach.

Triggers are a cheap thread-safe enqueue; diagnosis happens on a
background worker task that probes the ``observability.incident_open``
fault site (an injected hook) before each event: an error is swallowed
and counted (``kfserving_tpu_incident_failures_total{reason=error}``), a
hang parks only the worker while the bounded queue drops overflow
(``reason=dropped``).

An incident closes when its SLO alert has cleared (or never existed)
and no trigger attached for ``KFS_INCIDENT_COOLDOWN_S``.  Records live
in a bounded ring; with ``KFS_INCIDENT_SPOOL_DIR`` set, every open and
close also writes ``<id>.json`` there through an executor.
``KFS_INCIDENTS=0`` disables the engine.

Nothing here imports ``server/``, ``engine/`` or ``reliability/``: the
fault hook and the snapshot providers are injected at construction.
"""

import asyncio
import json
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from kfserving_tpu_torch.observability import attribution
from kfserving_tpu_torch.observability import metrics as obs
from kfserving_tpu_torch.observability.incidents.classify import classify
from kfserving_tpu_torch.observability.profiling import TIMELINE

logger = logging.getLogger("kfserving_tpu_torch.incidents")

ENV_ENABLED = "KFS_INCIDENTS"
ENV_RING = "KFS_INCIDENT_RING"
ENV_QUEUE = "KFS_INCIDENT_QUEUE"
ENV_COOLDOWN = "KFS_INCIDENT_COOLDOWN_S"
ENV_DEDUP = "KFS_INCIDENT_DEDUP_S"
ENV_WINDOW = "KFS_INCIDENT_WINDOW_S"
ENV_TICK = "KFS_INCIDENT_TICK_S"
ENV_SPOOL = "KFS_INCIDENT_SPOOL_DIR"
ENV_TOPK = "KFS_INCIDENT_TOPK"

DEFAULT_RING = 64
DEFAULT_QUEUE = 256
DEFAULT_COOLDOWN_S = 60.0
DEFAULT_DEDUP_S = 120.0
DEFAULT_WINDOW_S = 120.0
DEFAULT_TICK_S = 0.5
DEFAULT_TOPK = 5
# Per-incident bounds: the record must stay a debug-endpoint payload,
# not a heap leak, no matter how long a storm rains triggers on it.
MAX_TRIGGERS_KEPT = 32
MAX_PINS_IN_BUNDLE = 32
MAX_TIMELINE_EVENTS = 128

# The process-wide dedup key for triggers that have no model (eviction
# storms, sanitizer violations, failovers).
SERVER_KEY = "_server"

# History series the evidence bundle snapshots (pre/post frames for
# each): the request-latency quantiles the SLO breaches on, the
# synthetic health ratios, and the queue-wait quantile the classifier
# separates queue_wait from device_compute with.
EVIDENCE_SERIES = (
    "kfserving_tpu_request_latency_ms_p99",
    "kfserving_tpu_request_latency_ms_p50",
    "kfserving_tpu_history_error_ratio",
    "kfserving_tpu_history_prefix_hit_ratio",
    "kfserving_tpu_batch_queue_wait_ms_p99",
)


def incidents_enabled() -> bool:
    return os.environ.get(ENV_ENABLED, "1") != "0"


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


class IncidentManager:
    """Bounded incident ring + background diagnosis worker.

    Server-lifecycle service: async `start()`/`stop()` like every
    other entry in `ModelServer.services`."""

    def __init__(self,
                 history=None,
                 recorder=None,
                 providers: Optional[Dict[str, Callable[[], Any]]] = None,
                 fault_hook: Optional[Callable] = None,
                 ring_size: Optional[int] = None,
                 queue_size: Optional[int] = None,
                 cooldown_s: Optional[float] = None,
                 dedup_window_s: Optional[float] = None,
                 evidence_window_s: Optional[float] = None,
                 tick_s: Optional[float] = None,
                 spool_dir: Optional[str] = None,
                 top_k: Optional[int] = None):
        self.history = history          # HistoryStore or None
        self.recorder = recorder        # FlightRecorder or None
        self.providers = dict(providers or {})
        self.fault_hook = fault_hook
        self.ring_size = max(1, ring_size if ring_size is not None
                             else _env_int(ENV_RING, DEFAULT_RING))
        self.queue_size = max(1, queue_size if queue_size is not None
                              else _env_int(ENV_QUEUE, DEFAULT_QUEUE))
        self.cooldown_s = (cooldown_s if cooldown_s is not None
                           else _env_float(ENV_COOLDOWN,
                                           DEFAULT_COOLDOWN_S))
        self.dedup_window_s = (dedup_window_s
                               if dedup_window_s is not None
                               else _env_float(ENV_DEDUP,
                                               DEFAULT_DEDUP_S))
        self.evidence_window_s = (evidence_window_s
                                  if evidence_window_s is not None
                                  else _env_float(ENV_WINDOW,
                                                  DEFAULT_WINDOW_S))
        self.tick_s = (tick_s if tick_s is not None
                       else _env_float(ENV_TICK, DEFAULT_TICK_S))
        self.spool_dir = (spool_dir if spool_dir is not None
                          else os.environ.get(ENV_SPOOL) or None)
        self.top_k = max(1, top_k if top_k is not None
                         else _env_int(ENV_TOPK, DEFAULT_TOPK))
        # Trigger queue: appended from the event loop, executor
        # threads, and the sanitizer watchdog alike (deque.append is
        # atomic); drained only by the worker/drain().
        self._queue: deque = deque()
        self._records: deque = deque(maxlen=self.ring_size)
        self._open: Dict[str, Dict[str, Any]] = {}
        self._lock = threading.Lock()
        self._seq = 0
        self._task: Optional[asyncio.Task] = None

    # -- service lifecycle -------------------------------------------------
    async def start(self) -> None:
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

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(max(0.05, self.tick_s))
            try:
                await self.drain()
            except asyncio.CancelledError:
                raise
            except Exception:
                # The worker itself must survive anything diagnosis
                # throws — drain() already counts per-event failures.
                logger.exception("incident worker tick failed")

    # -- trigger intake (thread-safe, never blocks) ------------------------
    def trigger(self, kind: str, model: Optional[str] = None,
                detail: Optional[Dict[str, Any]] = None,
                ts: Optional[float] = None) -> None:
        """Enqueue one detector firing.  Called synchronously from
        whatever context the detector runs in; all real work happens
        on the worker."""
        try:
            obs.incident_triggers_total().labels(kind=kind).inc()
            if len(self._queue) >= self.queue_size:
                # Bounded: a wedged worker sheds triggers, it never
                # grows the heap.  Detector pins still recorded the
                # evidence — only the JOIN is lost.
                obs.incident_failures_total().labels(
                    reason="dropped").inc()
                return
            self._queue.append({
                "kind": kind,
                "model": model or None,
                "detail": detail or {},
                "ts": time.time() if ts is None else float(ts),
            })
        except Exception:
            logger.exception("incident trigger enqueue failed")

    def on_pin(self, entry: Dict[str, Any]) -> None:
        """Flight-recorder pin tap: map detector pins onto trigger
        kinds.  Request-level pins (latency outliers, single errors)
        are NOT triggers — an incident needs a detector's judgment,
        not one slow request."""
        reason = str(entry.get("pinned") or "")
        ts = entry.get("ts")
        labels = entry.get("labels") or {}
        model = entry.get("model") or labels.get("model")
        if reason.startswith("trend_"):
            self.trigger("trend", model=model, ts=ts, detail={
                "series": entry.get("series"),
                "z": entry.get("z"),
                "value": entry.get("value"),
                "baseline": entry.get("baseline"),
                "slope_per_s": entry.get("slope_per_s")})
        elif reason.startswith("sanitizer_"):
            self.trigger("sanitizer", model=model, ts=ts, detail={
                "kind": reason[len("sanitizer_"):]})
        elif reason == "eviction_storm":
            self.trigger("eviction_storm", model=model, ts=ts,
                         detail={"kind": entry.get("kind")})
        elif reason == "kv_faultback_storm":
            self.trigger("faultback_storm", model=model, ts=ts,
                         detail={"kind": entry.get("kind")})
        elif reason in ("replica_failover", "swap_failure"):
            self.trigger("failover", model=model, ts=ts,
                         detail={"event": reason})

    def on_slo_transition(self, model: str, alerting: bool,
                          burn_rates: Dict[str, Any]) -> None:
        """SLOEngine breach-edge tap (healthy<->alerting)."""
        if alerting:
            self.trigger("slo_breach", model=model,
                         detail={"burn_rates": burn_rates})
        else:
            # Recovery is CLOSE evidence, not a trigger: mark the open
            # incident so the cooldown clock can run out.
            with self._lock:
                incident = self._open.get(model) or \
                    self._open.get(SERVER_KEY)
                if incident is not None:
                    incident["alerting"] = False
                    incident["recovered_ts"] = time.time()

    # -- diagnosis worker --------------------------------------------------
    async def drain(self, now: Optional[float] = None) -> int:
        """Process every queued trigger (fault-site probe per event),
        then run the close sweep.  Returns the number of events
        diagnosed.  Tests drive this directly for determinism; the
        background loop calls it every tick."""
        processed = 0
        while self._queue:
            try:
                event = self._queue.popleft()
            except IndexError:
                break
            try:
                if self.fault_hook is not None:
                    await self.fault_hook()
                self._process(event, now=now)
                processed += 1
            except asyncio.CancelledError:
                raise
            except Exception:
                obs.incident_failures_total().labels(
                    reason="error").inc()
                logger.exception("incident diagnosis failed for %s",
                                 event.get("kind"))
        await self._sweep_closes(now=now)
        return processed

    def _process(self, event: Dict[str, Any],
                 now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        key = event.get("model") or SERVER_KEY
        with self._lock:
            incident = self._open.get(key)
            stale = (incident is not None
                     and not incident.get("alerting")
                     and now - incident["last_trigger_ts"]
                     > self.dedup_window_s)
        if stale:
            # The open incident fell out of the dedup window without a
            # live alert: this firing is a NEW episode, not an attach.
            self._close(incident, now=now)
            incident = None
        if incident is not None:
            self._attach(incident, event, now)
        else:
            self._open_incident(key, event, now)

    def _open_incident(self, key: str, event: Dict[str, Any],
                       now: float) -> None:
        self._seq += 1
        incident_id = f"inc-{self._seq}-{int(now) % 100000}"
        evidence = self._evidence(key, now)
        counts = {event["kind"]: 1}
        hypotheses = classify(counts, evidence)
        cause = hypotheses[0]["cause"] if hypotheses else "unclassified"
        incident = {
            "id": incident_id,
            "state": "open",
            "key": key,
            "model": None if key == SERVER_KEY else key,
            "opened_ts": now,
            "updated_ts": now,
            "last_trigger_ts": now,
            "closed_ts": None,
            # slo_breach opens in the alerting state; everything else
            # only needs the cooldown to run out.
            "alerting": event["kind"] == "slo_breach",
            "recovered_ts": None,
            "triggers": [dict(event)],
            "trigger_counts": counts,
            "evidence": evidence,
            "hypotheses": hypotheses,
            "root_cause": cause,
        }
        with self._lock:
            self._open[key] = incident
            self._records.append(incident)
        obs.incident_open().labels(model=key).set(
            self._open_count(key))
        obs.incident_opened_total().labels(cause=cause).inc()
        logger.warning("incident %s opened (key=%s cause=%s trigger=%s)",
                       incident_id, key, cause, event["kind"])
        self._spool(incident)

    def _attach(self, incident: Dict[str, Any],
                event: Dict[str, Any], now: float) -> None:
        with self._lock:
            incident["updated_ts"] = now
            incident["last_trigger_ts"] = now
            counts = incident["trigger_counts"]
            counts[event["kind"]] = counts.get(event["kind"], 0) + 1
            if len(incident["triggers"]) < MAX_TRIGGERS_KEPT:
                incident["triggers"].append(dict(event))
            if event["kind"] == "slo_breach":
                incident["alerting"] = True
                incident["recovered_ts"] = None
            counts = dict(counts)
            evidence = incident["evidence"]
        # Re-rank outside the lock: classify() is pure over the
        # bundle + updated counts.
        hypotheses = classify(counts, evidence)
        with self._lock:
            incident["hypotheses"] = hypotheses
            if hypotheses:
                incident["root_cause"] = hypotheses[0]["cause"]

    async def _sweep_closes(self, now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        to_close = []
        with self._lock:
            for incident in self._open.values():
                if incident.get("alerting"):
                    continue
                if now - incident["last_trigger_ts"] >= self.cooldown_s:
                    to_close.append(incident)
        for incident in to_close:
            self._close(incident, now=now)

    def _close(self, incident: Dict[str, Any], now: float) -> None:
        with self._lock:
            if incident.get("state") != "open":
                return
            incident["state"] = "closed"
            incident["closed_ts"] = now
            key = incident["key"]
            if self._open.get(key) is incident:
                del self._open[key]
        duration_ms = max(0.0, (now - incident["opened_ts"]) * 1000.0)
        obs.incident_open().labels(model=key).set(
            self._open_count(key))
        obs.incident_duration_ms().observe(duration_ms)
        logger.info("incident %s closed after %.1fs (cause=%s)",
                    incident["id"], duration_ms / 1000.0,
                    incident["root_cause"])
        self._spool(incident)

    def _open_count(self, key: str) -> int:
        with self._lock:
            return 1 if key in self._open else 0

    # -- evidence bundle ---------------------------------------------------
    def _evidence(self, key: str, now: float) -> Dict[str, Any]:
        """Snapshot the cross-signal bundle for the breach window
        [now - evidence_window_s, now].  Every source is best-effort:
        a missing feed yields an absent key, never a failed open."""
        window = self.evidence_window_s
        t0 = now - window
        bundle: Dict[str, Any] = {
            "window": {"start": round(t0, 3), "end": round(now, 3),
                       "span_s": window},
        }
        sources: List[str] = []
        if self.history is not None:
            try:
                series = []
                for name in EVIDENCE_SERIES:
                    series.extend(self.history.query(
                        series=name, window_s=window, now=now))
                bundle["history"] = series
                if series:
                    sources.append("history")
            except Exception:
                logger.exception("history evidence failed")
        if self.recorder is not None:
            try:
                dump = self.recorder.dump(
                    limit=MAX_PINS_IN_BUNDLE, pinned_only=True,
                    since_ts=t0)
                bundle["flightrecorder"] = {
                    "pinned_total": dump.get("pinned_total", 0),
                    "pinned": dump.get("pinned", [])}
                if dump.get("pinned"):
                    sources.append("flightrecorder")
            except Exception:
                logger.exception("flight-recorder evidence failed")
        try:
            events = TIMELINE.window(t0, now,
                                     limit=MAX_TIMELINE_EVENTS)
            bundle["timeline"] = events
            if events:
                sources.append("timeline")
        except Exception:
            logger.exception("timeline evidence failed")
        try:
            by_cost = attribution.top(self.top_k, window_s=window,
                                      by="device_ms", now=now)
            by_blocks = attribution.top(self.top_k, window_s=window,
                                        by="held_blocks", now=now)
            bundle["attribution"] = {
                "top_by_device_ms": by_cost,
                "top_by_held_blocks": by_blocks}
            if by_cost or by_blocks:
                sources.append("attribution")
        except Exception:
            logger.exception("attribution evidence failed")
        for name, provider in self.providers.items():
            try:
                snapshot = provider()
                if snapshot is not None:
                    bundle[name] = snapshot
                    sources.append(name)
            except Exception:
                logger.exception("evidence provider %s failed", name)
        bundle["consistency"] = self._consistency(bundle)
        bundle["sources"] = sources
        return bundle

    @staticmethod
    def _consistency(bundle: Dict[str, Any]) -> Dict[str, Any]:
        """The additive-decomposition cross-check: attributed
        device-ms (per-request records, window-filtered) against the
        engine timeline's device-track busy time for the same window.
        The attribution discipline says these sum to the same total; an
        incident bundle where they disagree by more than the in-flight
        edge effects is itself a finding."""
        attr_ms = 0.0
        for record in (bundle.get("attribution") or {}).get(
                "top_by_device_ms") or []:
            attr_ms += float(record.get("total_device_ms") or 0.0)
        timeline_ms = 0.0
        for event in bundle.get("timeline") or []:
            if event.get("track") == "device":
                timeline_ms += float(event.get("dur_ms") or 0.0)
        out = {"attribution_device_ms": round(attr_ms, 3),
               "timeline_device_ms": round(timeline_ms, 3)}
        if timeline_ms > 0:
            out["delta_ratio"] = round(
                abs(attr_ms - timeline_ms) / timeline_ms, 4)
        return out

    # -- JSON spool (executor — no blocking I/O on the loop) --------------
    def _spool(self, incident: Dict[str, Any]) -> None:
        if not self.spool_dir:
            return
        snapshot = self.get(incident["id"])
        if snapshot is None:
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            loop = None
        if loop is not None:
            loop.run_in_executor(None, self._spool_write, snapshot)
        else:
            # No loop (unit tests driving the manager synchronously):
            # a short-lived thread keeps the invariant that the spool
            # NEVER writes on the calling thread.
            threading.Thread(target=self._spool_write,
                             args=(snapshot,), daemon=True).start()

    def _spool_write(self, snapshot: Dict[str, Any]) -> None:
        try:
            os.makedirs(self.spool_dir, exist_ok=True)
            path = os.path.join(self.spool_dir,
                                f"{snapshot['id']}.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(snapshot, f)
            os.replace(tmp, path)
        except Exception:
            obs.incident_failures_total().labels(reason="spool").inc()
            logger.exception("incident spool write failed")

    # -- query surface -----------------------------------------------------
    def get(self, incident_id: str) -> Optional[Dict[str, Any]]:
        """Full record (evidence bundle included) by id."""
        with self._lock:
            for incident in self._records:
                if incident["id"] == incident_id:
                    # JSON round-trip = deep copy + serializability
                    # guarantee in one move (default=str mops up any
                    # non-JSON value a provider snuck into evidence).
                    return json.loads(json.dumps(incident,
                                                 default=str))
        return None

    def list(self, state: Optional[str] = None,
             limit: int = 50) -> List[Dict[str, Any]]:
        """Newest-first incident summaries (no evidence payload —
        fetch the detail by id)."""
        limit = max(0, int(limit))
        with self._lock:
            records = list(self._records)
        records.reverse()
        out = []
        for incident in records:
            if state and incident["state"] != state:
                continue
            top = (incident["hypotheses"][0]
                   if incident["hypotheses"] else None)
            out.append({
                "id": incident["id"],
                "state": incident["state"],
                "model": incident["model"],
                "opened_ts": incident["opened_ts"],
                "updated_ts": incident["updated_ts"],
                "closed_ts": incident["closed_ts"],
                "root_cause": incident["root_cause"],
                "top_hypothesis": top,
                "trigger_counts": dict(incident["trigger_counts"]),
                "evidence_sources": list(
                    incident["evidence"].get("sources") or []),
            })
            if len(out) >= limit:
                break
        return out

    def report(self, state: Optional[str] = None,
               limit: int = 50) -> Dict[str, Any]:
        """The GET /debug/incidents list body."""
        with self._lock:
            open_count = len(self._open)
            total = self._seq
        return {
            "enabled": True,
            "open": open_count,
            "total_opened": total,
            "queued_triggers": len(self._queue),
            "incidents": self.list(state=state, limit=limit),
        }
