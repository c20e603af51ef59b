"""Metrics-exposition linter: keep every exported family well-formed.

Port of ``kfserving_tpu/tools/check_metrics.py`` with the same rules:

- every family name carries the `kfserving_tpu_` prefix;
- counters end in `_total` (and nothing else ends in `_total`);
- time/size-valued families carry a unit suffix (`_ms`, `_seconds`,
  `_bytes`, `_ratio`, `_per_second`) and never a spelled-out
  `_milliseconds`;
- `_ratio`-suffixed gauges are bounded: every exported sample must sit
  in [0, 1];
- no family is declared twice in one exposition (strict OpenMetrics
  parsers abort the whole scrape on a re-declared family);
- no family is registered under two kinds.

Run standalone (`python -m kfserving_tpu_torch.tools.check_metrics`) it
boots the port's in-process server, serves one smoke request, touches
every family the serving layers publish, and lints the full rendered
scrape: exit 1 on any problem.
"""

import asyncio
import re
import sys
from typing import Dict, List

from kfserving_tpu_torch.tools.analyzers.naming import (
    PREFIX,
    family_name_problems,
)


def lint_families(families: Dict[str, str]) -> List[str]:
    """Lint a {family name: kind} mapping (registry introspection)
    with the naming rules of `tools/analyzers/naming.py`."""
    problems: List[str] = []
    for name, kind in sorted(families.items()):
        problems.extend(family_name_problems(name, kind))
    return problems


def lint_exposition(text: str) -> List[str]:
    """Lint a rendered scrape: duplicate family declarations, the
    naming rules over every declared family, and prefix coverage of
    every sample line (declared or bare)."""
    problems: List[str] = []
    declared: Dict[str, str] = {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            parts = line.split(" ")
            if len(parts) < 4:
                problems.append(f"malformed TYPE line: {line!r}")
                continue
            name, kind = parts[2], parts[3]
            if name in declared:
                problems.append(
                    f"{name}: declared twice (strict parsers abort "
                    "the whole scrape)")
            declared[name] = kind
            continue
        if not line or line.startswith("#"):
            continue
        sample = re.split(r"[{ ]", line, maxsplit=1)[0]
        if not sample.startswith(PREFIX):
            problems.append(
                f"sample {sample!r}: missing the {PREFIX!r} prefix")
        # Gauge-unit rule: a `_ratio` gauge promises [0, 1] — check
        # every sample value (gauge lines are `name[{labels}] value`;
        # gauges never carry exemplar suffixes).
        if declared.get(sample) == "gauge" \
                and sample.endswith("_ratio"):
            try:
                value = float(line.rsplit(" ", 1)[1])
            except (IndexError, ValueError):
                problems.append(
                    f"{sample}: unparseable gauge sample {line!r}")
                continue
            if not 0.0 <= value <= 1.0:  # NaN fails both bounds
                problems.append(
                    f"{sample}: _ratio gauge sample {value} outside "
                    f"[0, 1]")
    problems += lint_families(declared)
    return problems


async def smoke() -> List[str]:
    """Boot an in-process server, serve one request (populating the
    request/batcher/engine families), and lint the merged scrape plus
    both registries' introspection."""
    from kfserving_tpu_torch.model.model import Model
    from kfserving_tpu_torch.observability import REGISTRY
    from kfserving_tpu_torch.server.app import ModelServer
    from kfserving_tpu_torch.server.http import Request

    class _Probe(Model):
        def load(self):
            self.ready = True
            return True

        async def predict(self, request):
            return {"predictions": request["instances"]}

    server = ModelServer(http_port=0)
    probe = _Probe("metrics-probe")
    probe.load()
    server.register_model(probe)
    req = Request(method="POST",
                  path="/v1/models/metrics-probe:predict", query={},
                  headers={}, body=b'{"instances": [[1.0, 2.0]]}')
    req.path_params = {"name": "metrics-probe"}
    resp = await server._inference(req, "predict",
                                   server.dataplane.infer)
    # Populate the roofline families with representative values so the
    # lint always covers them (the probe model has no engine; a real
    # replica publishes these from its engine stats at scrape time).
    from kfserving_tpu_torch.observability.profiling import roofline

    roofline.publish_gauges("metrics-probe", {
        "mfu": 0.42, "decode_mfu": 0.011, "prefill_mfu": 0.2,
        "achieved_tflops": 82.7, "achieved_decode_tflops": 2.1,
        "goodput_ratio": 0.97, "hbm_bw_util": 0.63,
        "bucket_pad_waste": {"b8": 0.25, "b8s128": 0.5},
        "prefill_bucket_pad_waste": {"s64": 0.11},
    })
    # Replica-lifecycle families: touched with
    # representative samples so the lint always covers the names,
    # label shapes, and unit suffixes the orchestrator/router emit.
    from kfserving_tpu_torch.observability import metrics as obs

    obs.lifecycle_swaps_total().labels(
        mode="warm_standby", outcome="ok").inc()
    obs.lifecycle_swap_failures_total().labels(
        reason="activate_error").inc()
    obs.lifecycle_promotions_total().labels(
        trigger="process_exit", outcome="promoted").inc()
    for phase, ms in (("standby_spawn", 1800.0), ("activate", 650.0),
                      ("drain", 120.0), ("promote", 900.0)):
        obs.lifecycle_phase_ms().labels(phase=phase).observe(ms)
    obs.lifecycle_standby_pool().labels(
        component="default/probe/predictor").set(1.0)
    obs.router_swap_held_total().labels(outcome="served").inc()
    obs.router_swap_hold_ms().observe(42.0)
    obs.router_stream_failover_total().labels(
        model="metrics-probe").inc()
    obs.param_cache_total().labels(outcome="hit").inc()
    # Predictive control-loop families: decision counters,
    # the feed-forward sizing gauge, and the brownout trio.
    obs.autoscaler_tick_failures_total().inc()
    obs.autoscaler_decisions_total().labels(
        component="default/probe/predictor", action="pre_arm").inc()
    obs.autoscaler_predicted_replicas().labels(
        component="default/probe/predictor").set(3.0)
    obs.brownout_level().labels(model="metrics-probe").set(1.0)
    obs.brownout_shed_total().labels(
        model="metrics-probe", reason="priority").inc()
    obs.brownout_transitions_total().labels(
        model="metrics-probe", direction="enter").inc()
    # Cache & cost attribution families: prefix-index
    # lookups/evictions/reuse depth, the paged-pool `_ratio` gauges
    # (must be bounded [0, 1]), HBM residency, and the per-request
    # attribution histograms — touched with representative samples so
    # the lint always covers names, label shapes, and unit suffixes.
    obs.generator_prefix_lookups_total().labels(
        model="metrics-probe", outcome="hit").inc(3)
    obs.generator_prefix_lookups_total().labels(
        model="metrics-probe", outcome="miss").inc()
    obs.generator_prefix_lookups_total().labels(
        model="metrics-probe", outcome="host_hit").inc()
    obs.generator_prefill_tokens_saved_total().labels(
        model="metrics-probe").inc(384)
    # `capacity` split by fate — spilled to the host tier
    # vs dropped (the baseline / a failed spill).
    for cause in ("capacity_spilled", "capacity_dropped",
                  "index_invalidation", "zombie_deferral"):
        obs.generator_block_evictions_total().labels(
            model="metrics-probe", cause=cause).inc()
    obs.generator_prefix_reuse_depth_hits().labels(
        model="metrics-probe").observe(3)
    obs.generator_pool_occupancy_ratio().labels(
        model="metrics-probe").set(0.62)
    obs.generator_pool_fragmentation_ratio().labels(
        model="metrics-probe").set(0.18)
    obs.hbm_resident_bytes().labels(model="metrics-probe").set(2.1e9)
    obs.hbm_budget_bytes().set(12.0 * 1024**3)
    obs.hbm_evictions_total().labels(model="metrics-probe").inc()
    for phase, ms in (("prefill", 41.0), ("decode", 220.0)):
        obs.request_device_ms().labels(
            model="metrics-probe", phase=phase).observe(ms)
    obs.request_phase_tokens().labels(
        model="metrics-probe", phase="prefill").observe(128)
    obs.request_phase_tokens().labels(
        model="metrics-probe", phase="decode").observe(64)
    obs.request_held_blocks().labels(
        model="metrics-probe").observe(5)
    obs.request_cache_saved_tokens().labels(
        model="metrics-probe").observe(256)
    # Tiered KV residency families: host-tier occupancy,
    # spill/fault-back outcomes, tier evictions, fault-back latency,
    # and the per-request host-tier savings histogram (distinct from
    # the device-cache one just above) — representative samples so
    # names, label shapes, and unit suffixes always lint.
    obs.generator_kv_tier_blocks().labels(
        model="metrics-probe").set(48.0)
    obs.generator_kv_tier_occupancy_ratio().labels(
        model="metrics-probe").set(0.75)
    for outcome in ("spilled", "failed", "duplicate"):
        obs.generator_kv_tier_spills_total().labels(
            model="metrics-probe", outcome=outcome).inc()
    for outcome in ("faulted", "coalesced", "failed"):
        obs.generator_kv_tier_faultbacks_total().labels(
            model="metrics-probe", outcome=outcome).inc()
    obs.generator_kv_tier_faultback_ms().labels(
        model="metrics-probe").observe(3.2)
    for reason in ("capacity", "skipped_inflight", "faultback_failed"):
        obs.generator_kv_tier_evictions_total().labels(
            model="metrics-probe", reason=reason).inc()
    obs.generator_kv_tier_tokens_saved_total().labels(
        model="metrics-probe").inc(512)
    obs.request_host_tier_saved_tokens().labels(
        model="metrics-probe").observe(512)
    # Session-continuity KV handoff families: the drain
    # parachute's export outcomes, re-attach adoption outcomes, the
    # peer-transfer pull outcomes, and the export wall-time histogram —
    # representative samples so names, label shapes, and unit suffixes
    # always lint.
    for outcome in ("exported", "skipped", "dropped", "failed"):
        obs.kv_handoff_exported_blocks_total().labels(
            model="metrics-probe", outcome=outcome).inc()
    for outcome in ("adopted", "duplicate", "corrupt", "truncated",
                    "torn", "version_skew", "dropped_capacity",
                    "failed"):
        obs.kv_handoff_reattached_blocks_total().labels(
            model="metrics-probe", outcome=outcome).inc()
    for outcome in ("imported", "digest_mismatch", "skipped",
                    "failed"):
        obs.kv_handoff_peer_blocks_total().labels(
            model="metrics-probe", outcome=outcome).inc()
    obs.kv_handoff_export_ms().labels(
        model="metrics-probe").observe(14.0)
    # Model residency & affinity routing families: the
    # residency state/fault-in telemetry, the admission-aware
    # eviction-skip counter, and the router's affinity-pick outcomes —
    # representative samples so names, label shapes, and unit suffixes
    # always lint.
    obs.residency_state().labels(model="metrics-probe").set(3.0)
    for source, ms in (("warm", 12.0), ("cold", 850.0)):
        obs.residency_fault_in_ms().labels(source=source).observe(ms)
    for outcome in ("warm", "cold", "coalesced", "error"):
        obs.residency_fault_ins_total().labels(
            model="metrics-probe", outcome=outcome).inc()
    obs.hbm_eviction_skips_total().labels(
        model="metrics-probe", reason="busy").inc()
    for mode in ("model", "prefix"):
        for outcome in ("ring", "spill", "fallback"):
            obs.router_affinity_total().labels(
                mode=mode, outcome=outcome).inc()
    # Speculative-decoding families: proposal/acceptance
    # counters split by proposer, the chaos-fallback counter split by
    # seam, the accepted-length and draft-overhead histograms, and the
    # bounded acceptance-rate gauge — representative samples so names,
    # label shapes, and unit suffixes always lint.
    for proposer in ("draft", "ngram"):
        obs.specdec_proposed_tokens_total().labels(
            model="metrics-probe", proposer=proposer).inc(12)
        obs.specdec_accepted_tokens_total().labels(
            model="metrics-probe", proposer=proposer).inc(7)
        obs.specdec_draft_ms().labels(
            model="metrics-probe", proposer=proposer).observe(0.4)
    for site in ("draft", "verify"):
        obs.specdec_fallbacks_total().labels(
            model="metrics-probe", site=site).inc()
    obs.specdec_accepted_length_tokens().labels(
        model="metrics-probe").observe(3)
    obs.specdec_acceptance_ratio().labels(
        model="metrics-probe").set(0.58)
    # Device-discipline sanitizer families: the violation
    # counter (one sample per kind) and the armed gauge, touched with
    # representative values so names/labels/suffixes always lint.
    for kind in ("forbidden_transfer", "recompile", "loop_stall"):
        obs.sanitizer_violations_total().labels(kind=kind).inc()
    obs.sanitizer_armed().set(1)
    # Telemetry history & trend families: the sampler's
    # self-metrics, the synthetic ratio series (bounded [0, 1]), and
    # the trend detector's slope/z-score/change-point exports — one
    # real tick over the populated registries plus representative
    # touches so names, label shapes, and unit suffixes always lint.
    if server.history is not None:
        server.history.tick()
        server.history.tick()
    obs.history_tick_ms().observe(0.8)
    obs.history_tick_failures_total().inc()
    obs.history_samples_total().inc(64)
    obs.history_series().set(17.0)
    obs.trend_slope_per_second().labels(
        series="kfserving_tpu_request_latency_ms_p99",
        model="metrics-probe").set(2.5)
    obs.trend_zscore().labels(
        series="kfserving_tpu_request_latency_ms_p99",
        model="metrics-probe").set(4.2)
    obs.trend_changepoints_total().labels(
        series="kfserving_tpu_request_latency_ms_p99").inc()
    # Incident-engine families: the per-key open gauge,
    # the cause-labeled open counter, the kind-labeled trigger
    # counter, the failure counter (every reason the worker can
    # shed), and the duration histogram — touched with
    # representative values so names, label shapes, and unit
    # suffixes always lint.
    obs.incident_open().labels(model="metrics-probe").set(1)
    obs.incident_open().labels(model="_server").set(0)
    for cause in ("queue_wait", "device_compute", "cache_miss_storm",
                  "eviction_thrash", "recompile_host_sync",
                  "brownout_shed", "failover", "unclassified"):
        obs.incident_opened_total().labels(cause=cause).inc()
    for kind in ("slo_breach", "trend", "sanitizer", "eviction_storm",
                 "faultback_storm", "failover"):
        obs.incident_triggers_total().labels(kind=kind).inc()
    for reason in ("error", "dropped", "spool"):
        obs.incident_failures_total().labels(reason=reason).inc()
    obs.incident_duration_ms().observe(42_000.0)
    problems: List[str] = []
    if resp.status != 200:
        problems.append(
            f"smoke request failed with status {resp.status}")
    problems += lint_exposition(server.metrics.render())
    problems += lint_families(server.metrics.registry.families())
    problems += lint_families(REGISTRY.families())
    # Deduplicate: a family can be flagged by both the exposition and
    # the registry pass.
    return sorted(set(problems))


def main() -> int:
    problems = asyncio.run(smoke())
    if problems:
        print("metrics lint FAILED:")
        for p in problems:
            print(f"  - {p}")
        return 1
    print("metrics lint OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
