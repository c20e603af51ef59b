"""Per-request cost attribution: device time, tokens and cache economics.

Port of ``kfserving_tpu/observability/attribution.py``, unchanged in
behaviour.  The generator folds its dispatch accounting into one cost
record per finished request (attributed device milliseconds by phase,
prefill and decode tokens, peak blocks held, prompt tokens the prefix
cache and the host KV tier saved) and hands it here.  The record then:

- lands in the JSON access log (``cost`` field);
- is embedded in flight-recorder entries, so a pinned outlier shows
  what the request cost;
- feeds the per-model histograms
  ``kfserving_tpu_request_device_ms{model,phase}``,
  ``_request_phase_tokens``, ``_request_held_blocks``,
  ``_request_cache_saved_tokens`` and
  ``_request_host_tier_saved_tokens``.

Attribution discipline: a dispatch's busy interval is split EVENLY
across the live streams it served, so per-request device ms sum to the
engine's total device time (``prefill_device_s + decode_device_s`` of
its ``stats()``): an additive decomposition, not a latency measurement.

The record store is a bounded ring keyed by trace id
(``KFS_ATTRIBUTION_RECORDS``, default 1024); lookups are
non-destructive (the access log and the flight recorder read the same
record).

Nothing here imports ``server/``, ``engine/`` or ``reliability/``: the
engine calls into this module, never the reverse.
"""

import os
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Set

from kfserving_tpu_torch.observability import metrics as obs

DEFAULT_RECORDS = 1024

_lock = threading.Lock()
_records: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()


def _capacity() -> int:
    try:
        return max(16, int(os.environ.get("KFS_ATTRIBUTION_RECORDS",
                                          DEFAULT_RECORDS)))
    except ValueError:
        return DEFAULT_RECORDS


def observe(model: str, trace_id: Optional[str],
            record: Dict[str, Any]) -> Dict[str, Any]:
    """Finalize one request's cost record: stamp the model, feed the
    per-model aggregate histograms, and (when traced) store it for the
    access log / flight recorder to attach.  Never raises into the
    engine's completion path."""
    record = dict(record)
    record["model"] = model
    # Wall-clock stamp: the top-coster query (and the incident
    # engine's evidence bundle) filters records by finish time.
    record.setdefault("ts", time.time())
    try:
        device = record.get("device_ms") or {}
        for phase in ("prefill", "decode"):
            ms = device.get(phase)
            if isinstance(ms, (int, float)) and ms > 0:
                obs.request_device_ms().labels(
                    model=model, phase=phase).observe(
                        float(ms), trace_id=trace_id)
        for phase, key in (("prefill", "prefill_tokens"),
                           ("decode", "decode_tokens")):
            n = record.get(key)
            if isinstance(n, (int, float)):
                obs.request_phase_tokens().labels(
                    model=model, phase=phase).observe(float(n))
        blocks = record.get("blocks_held")
        if isinstance(blocks, (int, float)) and blocks > 0:
            obs.request_held_blocks().labels(model=model).observe(
                float(blocks))
        saved = record.get("cache_saved_tokens")
        if isinstance(saved, (int, float)):
            obs.request_cache_saved_tokens().labels(
                model=model).observe(float(saved))
        # Distinct from cache_saved_tokens (device prefix hits): these
        # prompt tokens were recovered from the HOST tier by a
        # fault-back — additive, never double-counted (a block is
        # either a device hit or a host fault, per plan).
        host_saved = record.get("host_tier_saved_tokens")
        if isinstance(host_saved, (int, float)):
            obs.request_host_tier_saved_tokens().labels(
                model=model).observe(float(host_saved))
        if trace_id:
            with _lock:
                _records[trace_id] = record
                _records.move_to_end(trace_id)
                cap = _capacity()
                while len(_records) > cap:
                    _records.popitem(last=False)
    except Exception:
        # Telemetry must never fail a finishing request.
        import logging

        logging.getLogger("kfserving_tpu_torch.attribution").exception(
            "cost attribution failed for %s", model)
    return record


def lookup(trace_id: Optional[str]) -> Optional[Dict[str, Any]]:
    """Non-destructive fetch of a trace's cost record (None when the
    request was untraced, never finished a generation, or rotated out
    of the bounded store)."""
    if not trace_id:
        return None
    with _lock:
        rec = _records.get(trace_id)
        return dict(rec) if rec is not None else None


def recent(limit: int = 10) -> List[Dict[str, Any]]:
    """Newest `limit` records (bench evidence / debugging)."""
    limit = max(0, int(limit))
    with _lock:
        return [dict(r) for r in list(_records.values())[-limit:]]


def total_device_ms(record: Dict[str, Any]) -> float:
    """A record's attributed device milliseconds summed over phases."""
    device = record.get("device_ms") or {}
    total = 0.0
    for ms in device.values():
        if isinstance(ms, (int, float)):
            total += float(ms)
    return total


def top(k: int = 10, window_s: Optional[float] = None,
        by: str = "device_ms",
        now: Optional[float] = None) -> List[Dict[str, Any]]:
    """Top-K cost records from the ring, ranked by attributed device
    milliseconds (`by="device_ms"`, summed over phases) or peak blocks
    held (`by="held_blocks"`).  `window_s` keeps only records whose
    finish stamp falls inside the trailing window — the incident
    engine's evidence bundle asks for "the most expensive requests of
    the breach window", ``/debug/cache?top_cost=`` asks the same
    question interactively.  Each returned copy carries its computed
    `total_device_ms` so rankings are self-explanatory."""
    if by not in ("device_ms", "held_blocks"):
        raise ValueError("by must be device_ms or held_blocks")
    k = max(0, int(k))
    now = time.time() if now is None else now
    with _lock:
        records = [dict(r) for r in _records.values()]
    if window_s is not None:
        horizon = now - float(window_s)
        records = [r for r in records
                   if float(r.get("ts") or 0.0) >= horizon]
    for r in records:
        r["total_device_ms"] = round(total_device_ms(r), 3)
    if by == "device_ms":
        records.sort(key=lambda r: r["total_device_ms"], reverse=True)
    else:
        records.sort(key=lambda r: float(r.get("blocks_held") or 0.0),
                     reverse=True)
    return records[:k]


def clear() -> None:
    with _lock:
        _records.clear()


def _clamp01(value: float) -> float:
    return min(1.0, max(0.0, float(value)))


def publish_cache_gauges(model: str, stats: Dict[str, Any]) -> Set[str]:
    """Promote an engine stats dict's paged-pool ratios into registry
    gauges at /metrics scrape time (the roofline.publish_gauges shape).
    Returns the consumed top-level stat keys: none, since the ``paged``
    dict keeps its per-key export
    (``kfserving_tpu_engine_paged{bucket=...}``) and the ratio gauges
    are published beside it."""
    consumed: Set[str] = set()
    try:
        paged = stats.get("paged")
        if isinstance(paged, dict):
            occ = paged.get("pool_occupancy_ratio")
            if isinstance(occ, (int, float)):
                obs.generator_pool_occupancy_ratio().labels(
                    model=model).set(_clamp01(occ))
            frag = paged.get("fragmentation_ratio")
            if isinstance(frag, (int, float)):
                obs.generator_pool_fragmentation_ratio().labels(
                    model=model).set(_clamp01(frag))
    except Exception:
        import logging

        logging.getLogger("kfserving_tpu_torch.attribution").exception(
            "cache gauge publish failed for %s", model)
    return consumed
