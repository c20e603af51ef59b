"""SLO engine: multi-window error-budget burn rates over live series.

Port of ``kfserving_tpu/observability/monitoring/slo.py``, unchanged in
behaviour.  Objectives are declared per model (``KFS_SLO_OBJECTIVES``
JSON, or a ``KFS_SLO_DEFAULT_*`` wildcard for every served model): a
latency bound with an availability target and/or an error-rate target.
Each evaluation snapshots the cumulative ``kfserving_tpu_request_total``
counter and ``kfserving_tpu_request_latency_ms`` histogram and computes
the burn rate over each configured window (``KFS_SLO_WINDOWS_S``): the
fraction of the error budget (1 - target) spent, 1.0 meaning exactly
the budget.  A model alerts only when EVERY window burns past
``KFS_SLO_BURN_ALERT``.

Latency thresholds are evaluated against histogram buckets, so a
threshold between bucket bounds rounds DOWN to the nearest bound
(conservative).  State derives from cumulative counters, so the engine
costs nothing between ticks.  Served at ``GET /v2/health/slo``.
"""

import bisect
import json
import logging
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from kfserving_tpu_torch.observability import metrics as obs
from kfserving_tpu_torch.observability.metrics import (
    REQUEST_LATENCY_SERIES,
    REQUEST_TOTAL_SERIES,
)

logger = logging.getLogger("kfserving_tpu_torch.monitoring.slo")

ENV_OBJECTIVES = "KFS_SLO_OBJECTIVES"
ENV_DEFAULT_LATENCY = "KFS_SLO_DEFAULT_LATENCY_MS"
ENV_DEFAULT_TARGET = "KFS_SLO_DEFAULT_TARGET"
ENV_WINDOWS = "KFS_SLO_WINDOWS_S"
ENV_BURN_ALERT = "KFS_SLO_BURN_ALERT"
ENV_EVAL = "KFS_SLO_EVAL_S"

DEFAULT_TARGET = 0.99
DEFAULT_WINDOWS_S = (60.0, 300.0)
DEFAULT_BURN_ALERT = 2.0
DEFAULT_EVAL_S = 5.0
# Hard cap on retained snapshots: the background loop's cadence keeps
# history small by itself, but ?refresh=1 lets an unauthenticated
# poller force a tick per request — memory and tick cost must stay
# bounded regardless (past the cap the oldest snapshots drop, which
# can only SHORTEN the effective long window, never break it).
MAX_SNAPSHOTS = 256

def _window_label(window: float) -> str:
    """Exposition/report label for a window: integral seconds render
    bare ("60"), fractional ones keep their fraction ("0.5") — two
    sub-second windows must not collide into one label."""
    return str(int(window)) if window == int(window) else str(window)


def _clamp_target(target: float) -> float:
    """Targets must leave a non-empty budget: 1.0 (or more) would make
    every burn rate infinite.  Clamp into (0, 1) loudly."""
    if not 0.0 < target < 1.0:
        logger.warning("SLO target %s outside (0, 1); clamping", target)
        return min(0.9999, max(0.0001, target))
    return target


@dataclass
class SLOObjective:
    model: str
    latency_ms: Optional[float] = None
    target: float = DEFAULT_TARGET          # for the latency objective
    error_target: Optional[float] = None    # non-5xx availability

    def __post_init__(self):
        self.target = _clamp_target(float(self.target))
        if self.error_target is not None:
            self.error_target = _clamp_target(float(self.error_target))
        if self.latency_ms is not None:
            self.latency_ms = float(self.latency_ms)

    def to_dict(self) -> Dict[str, Any]:
        return {"latency_ms": self.latency_ms, "target": self.target,
                "error_target": self.error_target}


def objectives_from_env() -> Dict[str, SLOObjective]:
    """Parse the env-declared objective set.  `"*"` (or the
    KFS_SLO_DEFAULT_* pair) declares a wildcard applied to every model
    that has traffic.  Malformed JSON or knobs log and are skipped —
    a bad objective must not take the server down."""
    objectives: Dict[str, SLOObjective] = {}
    raw = os.environ.get(ENV_OBJECTIVES)
    if raw:
        try:
            parsed = json.loads(raw)
            if not isinstance(parsed, dict):
                raise ValueError("must be a JSON object keyed by model")
            for model, spec in parsed.items():
                if not isinstance(spec, dict):
                    raise ValueError(f"objective for {model!r} must be "
                                     "an object")
                objectives[model] = SLOObjective(
                    model,
                    latency_ms=spec.get("latency_ms"),
                    target=spec.get("target", DEFAULT_TARGET),
                    error_target=spec.get("error_target"))
        except (ValueError, TypeError) as e:
            logger.error("malformed %s (%s); ignoring", ENV_OBJECTIVES, e)
            objectives = {}
    default_latency = os.environ.get(ENV_DEFAULT_LATENCY)
    if default_latency and "*" not in objectives:
        try:
            objectives["*"] = SLOObjective(
                "*", latency_ms=float(default_latency),
                target=float(os.environ.get(ENV_DEFAULT_TARGET,
                                            DEFAULT_TARGET)))
        except ValueError:
            logger.error("non-numeric %s / %s; ignoring",
                         ENV_DEFAULT_LATENCY, ENV_DEFAULT_TARGET)
    return objectives


class SLOEngine:
    """Burn-rate evaluation over one or more metrics registries (the
    server's private request registry, plus any others)."""

    def __init__(self, registries: Sequence,
                 objectives: Optional[Dict[str, SLOObjective]] = None,
                 windows_s: Sequence[float] = DEFAULT_WINDOWS_S,
                 burn_alert: float = DEFAULT_BURN_ALERT,
                 total_series: str = REQUEST_TOTAL_SERIES,
                 latency_series: str = REQUEST_LATENCY_SERIES,
                 export_gauges: bool = True):
        self.registries = list(registries)
        # Which cumulative series the burn rates are computed over:
        # replicas evaluate their own request series (the default), the
        # control plane's predictive loop the router's per-revision
        # series.  Any counter with model/status labels and any
        # histogram with a model label fit the snapshot shape.
        self.total_series = total_series
        self.latency_series = latency_series
        # Secondary engines (the control plane's) evaluate silently: the
        # replicas' engines own the kfserving_tpu_slo_* gauge children.
        self.export_gauges = export_gauges
        self.objectives = dict(objectives or {})
        self.windows_s = tuple(sorted(float(w) for w in windows_s))
        self.burn_alert = float(burn_alert)
        # (monotonic time, {model: sample}) history, pruned past the
        # longest window.
        self._snapshots: List[Tuple[float, Dict[str, Dict]]] = []
        self._alerting: Dict[str, bool] = {}
        self._last_report: Dict[str, Any] = {}
        # Breach-transition taps: called as (model, alerting,
        # burn_rates) on every healthy->alerting and alerting->healthy
        # edge — the incident engine opens/recovers incidents off this
        # edge instead of polling the report.  Listeners must not
        # raise; a broken tap is logged and skipped.
        self.transition_listeners: List[Any] = []

    @classmethod
    def from_env(cls, registries: Sequence) -> "SLOEngine":
        from kfserving_tpu_torch.observability.monitoring.knobs import (
            env_number,
        )

        raw_windows = os.environ.get(ENV_WINDOWS, "")
        windows: List[float] = []
        for part in raw_windows.split(","):
            part = part.strip()
            if not part:
                continue
            try:
                windows.append(float(part))
            except ValueError:
                logger.warning("ignoring non-numeric window %r in %s",
                               part, ENV_WINDOWS)
        return cls(registries, objectives_from_env(),
                   windows_s=windows or DEFAULT_WINDOWS_S,
                   burn_alert=env_number(ENV_BURN_ALERT,
                                         DEFAULT_BURN_ALERT))

    @property
    def enabled(self) -> bool:
        return bool(self.objectives)

    def objective_for(self, model: str) -> Optional[SLOObjective]:
        return self.objectives.get(model) or self.objectives.get("*")

    def alerting(self, model: str) -> bool:
        return self._alerting.get(model, False)

    # -- series reading ----------------------------------------------------
    def _snapshot(self) -> Dict[str, Dict]:
        """Cumulative per-model sample: total/error request counts and
        summed latency-histogram bucket counts (verbs merged — an SLO
        covers the model, not one verb)."""
        snap: Dict[str, Dict] = {}

        def entry(model: str) -> Dict:
            return snap.setdefault(model, {
                "total": 0.0, "errors": 0.0,
                "lat_buckets": None, "lat_counts": None,
                "lat_total": 0.0})

        for registry in self.registries:
            fam = registry.family(self.total_series)
            if fam is not None and fam.kind == "counter":
                for labels, child in fam.samples():
                    model = labels.get("model")
                    if model is None:
                        continue
                    e = entry(model)
                    e["total"] += child.value
                    try:
                        if int(labels.get("status", 0)) >= 500:
                            e["errors"] += child.value
                    except ValueError:
                        pass
            fam = registry.family(self.latency_series)
            if fam is not None and fam.kind == "histogram":
                for labels, hist in fam.samples():
                    model = labels.get("model")
                    if model is None:
                        continue
                    with hist._lock:
                        counts = list(hist.counts)
                        total = hist.total
                    e = entry(model)
                    if e["lat_counts"] is None:
                        e["lat_buckets"] = list(hist.buckets)
                        e["lat_counts"] = [0.0] * len(counts)
                    if len(counts) == len(e["lat_counts"]):
                        e["lat_counts"] = [a + b for a, b in
                                           zip(e["lat_counts"], counts)]
                        e["lat_total"] += total
        return snap

    @staticmethod
    def _good_below(sample: Dict, threshold_ms: float) -> float:
        """Observations at or under the largest bucket bound <=
        threshold (the conservative rounding documented above)."""
        buckets, counts = sample["lat_buckets"], sample["lat_counts"]
        if not buckets or counts is None:
            return 0.0
        idx = bisect.bisect_right(buckets, threshold_ms)
        return float(sum(counts[:idx]))

    # -- evaluation --------------------------------------------------------
    def tick(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Snapshot the series, evaluate every objective over every
        window, export the gauges, and return the report served at
        /v2/health/slo."""
        now = time.monotonic() if now is None else now
        snap = self._snapshot()
        self._snapshots.append((now, snap))
        horizon = now - self.windows_s[-1] if self.windows_s else now
        # Keep one snapshot at-or-before the horizon as the longest
        # window's baseline.
        while len(self._snapshots) > 2 and \
                self._snapshots[1][0] <= horizon:
            self._snapshots.pop(0)
        while len(self._snapshots) > MAX_SNAPSHOTS:
            self._snapshots.pop(0)

        models: Dict[str, Any] = {}
        alerting: List[str] = []
        for model in sorted(snap):
            objective = self.objective_for(model)
            if objective is None:
                continue
            burn_rates: Dict[str, Dict[str, float]] = {}
            component_alerts: Dict[str, bool] = {}
            for window in self.windows_s:
                base = self._baseline(now - window)
                rates = self._burn(objective, snap.get(model),
                                   base.get(model) if base else None)
                for component, rate in rates.items():
                    burn_rates.setdefault(component, {})[
                        _window_label(window)] = round(rate, 4)
                    alerts = component_alerts.setdefault(component,
                                                         True)
                    component_alerts[component] = \
                        alerts and rate > self.burn_alert
                    # Rounded: 0.1/0.01 renders as 10, not
                    # 9.99999999999999, in the exposition.
                    if self.export_gauges:
                        obs.slo_burn_rate().labels(
                            model=model, objective=component,
                            window=_window_label(window)).set(
                                round(rate, 6))
            is_alerting = any(component_alerts.values()) \
                if component_alerts else False
            was = self._alerting.get(model, False)
            self._alerting[model] = is_alerting
            if self.export_gauges:
                obs.slo_alert_state().labels(model=model).set(
                    1.0 if is_alerting else 0.0)
            if is_alerting and not was:
                if self.export_gauges:
                    obs.slo_breaches_total().labels(model=model).inc()
                logger.warning("SLO alert for model %s: burn rates %s "
                               "(threshold %s)", model, burn_rates,
                               self.burn_alert)
                self._notify_transition(model, True, burn_rates)
            elif was and not is_alerting:
                self._notify_transition(model, False, burn_rates)
            models[model] = {
                "objective": objective.to_dict(),
                "burn_rates": burn_rates,
                "alerting": is_alerting,
            }
            if is_alerting:
                alerting.append(model)
        self._last_report = {
            "healthy": not alerting,
            "alerting": alerting,
            "burn_alert_threshold": self.burn_alert,
            "windows_s": list(self.windows_s),
            "models": models,
        }
        return self._last_report

    def _notify_transition(self, model: str, alerting: bool,
                           burn_rates: Dict[str, Any]) -> None:
        for listener in list(self.transition_listeners):
            try:
                listener(model, alerting, dict(burn_rates))
            except Exception:
                logger.exception("SLO transition listener failed")

    def _baseline(self, at: float) -> Optional[Dict[str, Dict]]:
        """Newest snapshot taken at or before `at`; when history is
        still shorter than the window, the oldest held snapshot (a
        young replica evaluates over its whole life — better an
        honest short window than no signal).  On the very first tick
        there is no earlier snapshot at all: the baseline is zero, so
        everything the counters accumulated counts as in-window
        (diffing the snapshot against itself would read burn 0
        forever)."""
        base = None
        for t, s in self._snapshots:
            if t <= at:
                base = s
            else:
                break
        if base is None and len(self._snapshots) > 1:
            base = self._snapshots[0][1]
        return base

    def _burn(self, objective: SLOObjective,
              current: Optional[Dict],
              base: Optional[Dict]) -> Dict[str, float]:
        """Burn rate per component over one window's delta."""
        rates: Dict[str, float] = {}
        if current is None:
            return rates
        if objective.latency_ms is not None and \
                current.get("lat_counts") is not None:
            total = current["lat_total"] - (
                base["lat_total"] if base
                and base.get("lat_counts") is not None else 0.0)
            good = self._good_below(current, objective.latency_ms)
            if base and base.get("lat_counts") is not None:
                good -= self._good_below(base, objective.latency_ms)
            # The latency SLI is "SUCCESSFUL requests under X ms": a
            # hard-down model failing fast would otherwise land every
            # 5xx under the bound and report a healthy latency SLO
            # with zero working requests.  The histogram carries no
            # status label, so subtract the window's 5xx delta from
            # the good count (conservative: assumes errors were fast).
            errors = current["errors"] - (base["errors"] if base
                                          else 0.0)
            good = max(0.0, good - errors)
            if total > 0:
                bad_frac = max(0.0, 1.0 - good / total)
                rates["latency"] = bad_frac / (1.0 - objective.target)
            else:
                rates["latency"] = 0.0
        if objective.error_target is not None:
            total = current["total"] - (base["total"] if base else 0.0)
            errors = current["errors"] - (base["errors"] if base
                                          else 0.0)
            if total > 0:
                rates["errors"] = (errors / total) / \
                    (1.0 - objective.error_target)
            else:
                rates["errors"] = 0.0
        return rates

    def report(self) -> Dict[str, Any]:
        """The last tick's evaluation (fresh tick when none yet)."""
        if not self._last_report:
            return self.tick()
        return self._last_report
