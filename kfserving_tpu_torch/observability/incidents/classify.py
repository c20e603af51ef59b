"""Rule-based causal classifier over the additive decomposition.

Port of ``kfserving_tpu/observability/incidents/classify.py``, unchanged
in behaviour.  A serving pipeline's latency decomposes additively (queue
wait + host work + device compute), and the decomposition is what
diagnosis needs.  This module turns an incident's evidence bundle into
a RANKED list of causal hypotheses, each scored 0..1 from numbers the
bundle holds, with those numbers repeated inline:

    queue_wait          latency dominated by waiting for an admission
                        slot or a batch flush, not work
    device_compute      the infer stage (engine dispatches) dominates
    cache_miss_storm    the prefix-cache hit ratio collapsed
    eviction_thrash     the block pool, residency or host KV tier is
                        churning state faster than requests finish
    recompile_host_sync the sanitizer caught recompiles or implicit
                        host<->device transfers on the hot path
    brownout_shed       requests are shed by admission control
    failover            replica death or swap failure

Scores are heuristic but deterministic: the same bundle always ranks
the same way.  Pure functions over plain dicts.
"""

from typing import Any, Dict, List, Optional, Tuple

# Pin reasons that represent one slow/failed REQUEST (as opposed to a
# detector firing) — the per-request additive decomposition lives in
# these entries' `stages` dicts.
REQUEST_PINS = ("slo_breach", "slo_violation", "latency_outlier",
                "deadline_shed", "error")

CAUSES = ("queue_wait", "device_compute", "cache_miss_storm",
          "eviction_thrash", "recompile_host_sync", "brownout_shed",
          "failover")

PREFIX_HIT_SERIES = "kfserving_tpu_history_prefix_hit_ratio"
QUEUE_WAIT_SERIES = "kfserving_tpu_batch_queue_wait_ms_p99"
LATENCY_P99_SERIES = "kfserving_tpu_request_latency_ms_p99"


def _clamp01(value: float) -> float:
    return min(1.0, max(0.0, float(value)))


def _series_frames(evidence: Dict[str, Any],
                   name: str) -> List[List[float]]:
    """All frames for `name` across label sets, concatenated in time
    order (diagnosis wants the shape, not the per-label split)."""
    frames: List[List[float]] = []
    for series in evidence.get("history") or []:
        if series.get("name") == name:
            frames.extend(series.get("frames") or [])
    frames.sort(key=lambda f: f[0])
    return frames


def _pre_post_means(frames: List[List[float]]
                    ) -> Tuple[Optional[float], Optional[float]]:
    """Mean of the first and second half of a frame list — the
    cheapest possible "did this series move across the window"."""
    if len(frames) < 4:
        return None, None
    mid = len(frames) // 2
    pre = [f[1] for f in frames[:mid]]
    post = [f[1] for f in frames[mid:]]
    return sum(pre) / len(pre), sum(post) / len(post)


def _request_pins(evidence: Dict[str, Any]) -> List[Dict[str, Any]]:
    pins = (evidence.get("flightrecorder") or {}).get("pinned") or []
    return [e for e in pins
            if e.get("pinned") in REQUEST_PINS
            and isinstance(e.get("latency_ms"), (int, float))
            and float(e["latency_ms"]) > 0]


def _stage_shares(evidence: Dict[str, Any]
                  ) -> Tuple[Optional[float], Optional[float], int]:
    """(mean infer-stage share, mean unattributed-wait share, n) over
    the bundle's pinned slow requests.  The unattributed wait —
    latency minus every recorded stage — is admission-queue time plus
    loop overhead: the queue-wait component of the decomposition as
    seen per request."""
    infer_shares: List[float] = []
    wait_shares: List[float] = []
    for entry in _request_pins(evidence):
        latency = float(entry["latency_ms"])
        stages = entry.get("stages") or {}
        if not stages:
            continue
        staged = sum(float(v) for v in stages.values()
                     if isinstance(v, (int, float)))
        infer = float(stages.get("infer") or 0.0)
        infer_shares.append(_clamp01(infer / latency))
        wait_shares.append(_clamp01((latency - staged) / latency))
    if not infer_shares:
        return None, None, 0
    n = len(infer_shares)
    return (sum(infer_shares) / n, sum(wait_shares) / n, n)


def classify(trigger_counts: Dict[str, int],
             evidence: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Rank the causal hypotheses for one incident.  Returns a list of
    `{"cause", "score", "summary", "evidence"}` dicts sorted by score
    descending; zero-scored causes are dropped.  An empty list means
    the bundle held no usable decomposition — callers report the
    incident as `unclassified` rather than guessing."""
    hypotheses: List[Dict[str, Any]] = []
    infer_share, wait_share, n_pins = _stage_shares(evidence)
    lat_frames = _series_frames(evidence, LATENCY_P99_SERIES)
    lat_latest = lat_frames[-1][1] if lat_frames else None

    # -- queue_wait ------------------------------------------------------
    queue_frames = _series_frames(evidence, QUEUE_WAIT_SERIES)
    queue_p99 = queue_frames[-1][1] if queue_frames else None
    queue_score = 0.0
    queue_ev: Dict[str, Any] = {}
    if wait_share is not None:
        queue_score = wait_share
        queue_ev["unattributed_wait_share"] = round(wait_share, 4)
        queue_ev["pinned_requests"] = n_pins
    if queue_p99 is not None and lat_latest:
        hist_share = _clamp01(queue_p99 / lat_latest)
        queue_score = max(queue_score, hist_share)
        queue_ev["batch_queue_wait_ms_p99"] = round(queue_p99, 3)
        queue_ev["request_latency_ms_p99"] = round(lat_latest, 3)
    if queue_score > 0:
        hypotheses.append({
            "cause": "queue_wait",
            "score": round(queue_score, 4),
            "summary": ("requests spend "
                        f"{queue_score:.0%} of their latency waiting, "
                        "not computing"),
            "evidence": queue_ev})

    # -- device_compute --------------------------------------------------
    if infer_share is not None:
        # The infer stage dominating WHILE the queue does not is the
        # device-compute signature; a saturated queue re-explains a
        # high infer share (everything is slow), so it discounts.
        device_score = infer_share * (1.0 - _clamp01(wait_share or 0.0))
        device_ev: Dict[str, Any] = {
            "infer_stage_share": round(infer_share, 4),
            "pinned_requests": n_pins}
        consistency = evidence.get("consistency") or {}
        for key in ("attribution_device_ms", "timeline_device_ms",
                    "delta_ratio"):
            if key in consistency:
                device_ev[key] = consistency[key]
        if lat_latest is not None:
            device_ev["request_latency_ms_p99"] = round(lat_latest, 3)
        if device_score > 0:
            hypotheses.append({
                "cause": "device_compute",
                "score": round(device_score, 4),
                "summary": (f"the infer stage is {infer_share:.0%} of "
                            "pinned request latency — the compute "
                            "itself got slower"),
                "evidence": device_ev})

    # -- cache_miss_storm ------------------------------------------------
    hit_frames = _series_frames(evidence, PREFIX_HIT_SERIES)
    pre_hit, post_hit = _pre_post_means(hit_frames)
    if pre_hit is not None and pre_hit >= 0.2:
        drop = max(0.0, pre_hit - post_hit)
        miss_score = _clamp01(2.0 * drop)
        if miss_score > 0:
            hypotheses.append({
                "cause": "cache_miss_storm",
                "score": round(miss_score, 4),
                "summary": ("prefix-cache hit ratio fell "
                            f"{pre_hit:.2f} -> {post_hit:.2f} across "
                            "the window — saved prefill compute is "
                            "back on the chip"),
                "evidence": {"pre_hit_ratio": round(pre_hit, 4),
                             "post_hit_ratio": round(post_hit, 4)}})

    # -- eviction_thrash -------------------------------------------------
    storms = int(trigger_counts.get("eviction_storm", 0)) + \
        int(trigger_counts.get("faultback_storm", 0))
    thrash_score = _clamp01(0.5 + 0.2 * storms) if storms else 0.0
    thrash_ev: Dict[str, Any] = {"storm_triggers": storms}
    occupancy = _max_pool_occupancy(evidence)
    if occupancy is not None:
        thrash_ev["pool_occupancy_ratio"] = round(occupancy, 4)
        if storms and occupancy >= 0.9:
            thrash_score = _clamp01(thrash_score + 0.15)
    if thrash_score > 0:
        hypotheses.append({
            "cause": "eviction_thrash",
            "score": round(thrash_score, 4),
            "summary": (f"{storms} eviction/fault-back storm "
                        "detections in the window — KV state is "
                        "churning faster than requests finish"),
            "evidence": thrash_ev})

    # -- recompile_host_sync ---------------------------------------------
    sanitizer = int(trigger_counts.get("sanitizer", 0))
    if sanitizer:
        kinds: Dict[str, int] = {}
        for entry in (evidence.get("flightrecorder") or {}).get(
                "pinned") or []:
            reason = str(entry.get("pinned") or "")
            if reason.startswith("sanitizer_"):
                kind = reason[len("sanitizer_"):]
                kinds[kind] = kinds.get(kind, 0) + 1
        hypotheses.append({
            "cause": "recompile_host_sync",
            "score": round(_clamp01(0.5 + 0.2 * sanitizer), 4),
            "summary": (f"{sanitizer} device-discipline violations "
                        "(recompile / host sync) on the hot path"),
            "evidence": {"sanitizer_triggers": sanitizer,
                         "violation_kinds": kinds}})

    # -- brownout_shed ---------------------------------------------------
    shed = 0
    for entry in (evidence.get("flightrecorder") or {}).get(
            "pinned") or []:
        if entry.get("pinned") == "unavailable" or \
                entry.get("status") == 503:
            shed += 1
    router = evidence.get("router") or {}
    level = max([0] + [int(v) for v in
                       (router.get("brownout_levels") or {}).values()])
    if shed or level:
        hypotheses.append({
            "cause": "brownout_shed",
            "score": round(_clamp01(0.3 + 0.1 * shed + 0.2 * level), 4),
            "summary": (f"{shed} shed/unavailable requests pinned"
                        + (f", brownout level {level} active"
                           if level else "")),
            "evidence": {"shed_pins": shed, "brownout_level": level}})

    # -- failover --------------------------------------------------------
    failovers = int(trigger_counts.get("failover", 0))
    if failovers:
        hypotheses.append({
            "cause": "failover",
            "score": round(_clamp01(0.6 + 0.2 * failovers), 4),
            "summary": (f"{failovers} replica failover / swap-failure "
                        "events — lost capacity, not slow compute"),
            "evidence": {"failover_triggers": failovers}})

    hypotheses.sort(key=lambda h: (-h["score"], h["cause"]))
    return hypotheses


def _max_pool_occupancy(evidence: Dict[str, Any]) -> Optional[float]:
    """Worst per-model pool occupancy from the cache snapshot."""
    cache = evidence.get("cache") or {}
    worst: Optional[float] = None
    for snap in (cache.get("models") or {}).values():
        paged = (snap or {}).get("paged")
        pool = (snap or {}).get("pool") or {}
        occ = None
        if isinstance(paged, dict):
            occ = paged.get("pool_occupancy_ratio")
        if occ is None:
            occ = pool.get("pool_occupancy_ratio")
        if isinstance(occ, (int, float)):
            worst = occ if worst is None else max(worst, occ)
    return worst
