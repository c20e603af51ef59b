"""Chrome-trace / Perfetto export of the engine event timeline.

Port of ``kfserving_tpu/observability/profiling/trace_export.py``,
unchanged in behaviour.  ``to_chrome_trace`` renders ``EngineTimeline``
events as the Chrome Trace Event JSON object (``{"traceEvents":
[...]}``), loadable in Perfetto or chrome://tracing:

- one *process* per replica (``merge_traces`` re-pids each replica's
  trace and names the process after its host);
- *threads* are the tracks: host (tid 1), device (tid 2), one per
  engine slot (tid 10 + slot);
- complete events (``ph: "X"``, microsecond ts/dur) for spans, instant
  events (``ph: "i"``) for zero-duration markers, counter events
  (``ph: "C"``) for pool-occupancy samples;
- every event's ``args`` carries its trace id when it belongs to a
  request.

``summarize()`` derives dispatch-gap percentiles (device idle between
consecutive device slices), total growth-HOLD time and the
suppressed-wave ratio from the same events the trace renders.
"""

from typing import Any, Dict, List, Optional, Tuple

from kfserving_tpu_torch.observability.profiling.timeline import (
    COUNTER,
    DEVICE,
    HOST,
    SLOT,
    Event,
)

_TID_HOST = 1
_TID_DEVICE = 2
_TID_SLOT_BASE = 10


def _tid(track: str, slot: int) -> int:
    if track == DEVICE:
        return _TID_DEVICE
    if track == SLOT and slot >= 0:
        return _TID_SLOT_BASE + slot
    return _TID_HOST


def to_chrome_trace(events: List[Event], pid: int = 1,
                    process_name: str = "kfserving-tpu"
                    ) -> Dict[str, Any]:
    """Render timeline events as a Chrome Trace Event JSON object."""
    out: List[Dict[str, Any]] = [{
        "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
        "args": {"name": process_name},
    }]
    tids_seen: Dict[int, str] = {}
    for start, dur, track, name, trace_id, slot, attrs in events:
        ts_us = start * 1e6
        if track == COUNTER:
            # Counter samples: numeric attrs become stacked series.
            vals = {k: v for k, v in (attrs or {}).items()
                    if isinstance(v, (int, float))}
            if vals:
                out.append({"ph": "C", "name": name, "pid": pid,
                            "tid": _TID_HOST, "ts": ts_us,
                            "args": vals})
            continue
        tid = _tid(track, slot)
        if tid not in tids_seen:
            tids_seen[tid] = (
                "host" if tid == _TID_HOST else
                "device" if tid == _TID_DEVICE else
                f"slot {tid - _TID_SLOT_BASE}")
        args: Dict[str, Any] = dict(attrs) if attrs else {}
        if trace_id is not None:
            args["trace_id"] = trace_id
        if slot >= 0:
            args.setdefault("slot", slot)
        event: Dict[str, Any] = {
            "name": name, "cat": track, "pid": pid, "tid": tid,
            "ts": ts_us, "args": args,
        }
        if dur > 0:
            event["ph"] = "X"
            event["dur"] = dur * 1e6
        else:
            event["ph"] = "i"
            event["s"] = "t"  # thread-scoped instant
        out.append(event)
    for tid, tname in sorted(tids_seen.items()):
        out.append({"ph": "M", "name": "thread_name", "pid": pid,
                    "tid": tid, "args": {"name": tname}})
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def merge_traces(traces: List[Tuple[str, Dict[str, Any]]]
                 ) -> Dict[str, Any]:
    """Merge per-replica Chrome traces into one: each replica becomes
    its own process (re-pid'd, process_name prefixed with the host) so
    Perfetto shows the fleet as parallel process groups."""
    merged: List[Dict[str, Any]] = []
    for idx, (host, trace) in enumerate(traces):
        pid = idx + 1
        for event in trace.get("traceEvents", []):
            event = dict(event, pid=pid)
            if event.get("ph") == "M" and \
                    event.get("name") == "process_name":
                inner = dict(event.get("args") or {})
                inner["name"] = f"{host} · {inner.get('name', '')}"
                event["args"] = inner
            merged.append(event)
    return {"traceEvents": merged, "displayTimeUnit": "ms"}


def _percentile(values: List[float], q: float) -> float:
    ordered = sorted(values)
    idx = min(len(ordered) - 1, int(len(ordered) * q))
    return ordered[idx]


def summarize(events: List[Event]) -> Dict[str, Any]:
    """Timeline-derived device-path summary for bench records:

    - dispatch_gap p50/p99: idle ms between consecutive device-track
      slices (how much of
      wall clock the device actually sat waiting on the host);
    - hold_ms: total growth-starvation HOLD window time;
    - suppressed_wave_ratio: waves the adaptive governor refused vs
      dispatched decode waves;
    - slice counts per kind (waves, chunks, prefills, preemptions).
    """
    device = sorted(
        ((start, dur) for start, dur, track, *_ in events
         if track == DEVICE and dur > 0))
    gaps_ms: List[float] = []
    prev_end: Optional[float] = None
    for start, dur in device:
        if prev_end is not None:
            gaps_ms.append(max(0.0, (start - prev_end) * 1000.0))
        prev_end = max(prev_end or 0.0, start + dur)
    waves = sum(1 for _, _, t, n, *_ in events
                if t == DEVICE and n == "decode.wave")
    chunks = sum(1 for _, _, t, n, *_ in events
                 if t == DEVICE and n == "prefill.chunk")
    prefills = sum(1 for _, _, t, n, *_ in events
                   if t == DEVICE and n == "prefill.bucket")
    preempts = sum(1 for _, _, t, n, *_ in events
                   if t == HOST and n == "preempt")
    suppressed = sum(1 for _, _, t, n, *_ in events
                     if t == HOST and n == "wave.suppressed")
    hold_ms = sum(dur for _, dur, t, n, *_ in events
                  if t == HOST and n == "hold") * 1000.0
    out: Dict[str, Any] = {
        "decode_waves": waves,
        "prefill_chunks": chunks,
        "prefill_dispatches": prefills,
        "preemptions": preempts,
        "suppressed_waves": suppressed,
        "suppressed_wave_ratio": round(
            suppressed / (suppressed + waves), 4)
        if suppressed + waves else 0.0,
        "hold_ms": round(hold_ms, 3),
    }
    if gaps_ms:
        out["dispatch_gap_p50_ms"] = round(_percentile(gaps_ms, 0.50),
                                           3)
        out["dispatch_gap_p99_ms"] = round(_percentile(gaps_ms, 0.99),
                                           3)
    return out
