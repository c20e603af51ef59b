"""The metric catalog: accessors for the instruments of the port's layers.

Port of ``kfserving_tpu/observability/metrics.py``, holding only the
families that layers already in the port emit; each keeps the JAX
package's name, kind, labels and buckets.  Each accessor re-resolves its
family from the process registry on every call (registration is an
idempotent dict lookup), so a test-time ``REGISTRY.reset()`` never leaves
a caller holding a stale instrument::

    from kfserving_tpu_torch.observability import metrics as obs

    obs.batch_queue_wait_ms().labels(bucket=str(key)).observe(age_ms)
    obs.llm_ttft_ms().observe(ttft, trace_id=req.trace_id)

Histograms are milliseconds unless the name says otherwise.
"""

from kfserving_tpu_torch.observability.registry import (
    LATENCY_BUCKETS_MS,
    RATIO_BUCKETS,
    REGISTRY,
    THROUGHPUT_BUCKETS,
)

# The per-request accounting series (the server's Metrics feeds them).
REQUEST_TOTAL_SERIES = "kfserving_tpu_request_total"
REQUEST_LATENCY_SERIES = "kfserving_tpu_request_latency_ms"
# The per-revision series the router feeds, which the rollout analyzer
# gates on and the predictive loop's burn rates read.
REVISION_REQUESTS_SERIES = "kfserving_tpu_revision_requests_total"
REVISION_LATENCY_SERIES = "kfserving_tpu_revision_request_ms"
# The trend-slope gauge the history detector exports.
TREND_SLOPE_SERIES = "kfserving_tpu_trend_slope_per_second"

# Count-valued buckets of the cost-attribution distributions: token
# counts span prompt sizes (1..4k), block counts span pool tables.
TOKEN_BUCKETS = [1, 4, 16, 64, 256, 1024, 4096]
BLOCK_BUCKETS = [1, 2, 4, 8, 16, 32, 64, 128]


# -- batcher -------------------------------------------------------------
def batch_queue_wait_ms():
    return REGISTRY.histogram(
        "kfserving_tpu_batch_queue_wait_ms",
        "Time a request's oldest instance waited in the dynamic "
        "batcher queue before its batch flushed")


def batch_fill_ratio():
    return REGISTRY.histogram(
        "kfserving_tpu_batch_fill_ratio",
        "Flushed batch size as a fraction of the executed bucket "
        "(1.0 = zero pad slots)", buckets=RATIO_BUCKETS)


# -- engine --------------------------------------------------------------
def engine_stage_ms():
    return REGISTRY.histogram(
        "kfserving_tpu_engine_stage_ms",
        "Per-execution engine stage timing (stage=prepare|transfer|"
        "compute|fetch).  Dispatch is asynchronous: compute ends when "
        "the launches return, and fetch includes the wait for the "
        "card")


def compile_cache_events():
    return REGISTRY.counter(
        "kfserving_tpu_compile_cache_total",
        "Compiled-executable cache lookups by outcome (outcome=hit "
        "means the shape was already compiled; miss paid a compile)")


# -- LLM generation ------------------------------------------------------
def llm_ttft_ms():
    return REGISTRY.histogram(
        "kfserving_tpu_llm_ttft_ms",
        "Time from generation submit to the first emitted token")


def llm_inter_token_ms():
    return REGISTRY.histogram(
        "kfserving_tpu_llm_inter_token_ms",
        "Gap between consecutive emitted tokens of one generation")


def llm_tokens_per_second():
    return REGISTRY.histogram(
        "kfserving_tpu_llm_tokens_per_second",
        "Whole-generation decode throughput at finish",
        buckets=THROUGHPUT_BUCKETS)


def llm_tokens_total():
    return REGISTRY.counter(
        "kfserving_tpu_llm_tokens_total",
        "Prompt and generated tokens by direction (direction=in|out)")


def generator_prefill_chunks_total():
    return REGISTRY.counter(
        "kfserving_tpu_generator_prefill_chunks_total",
        "Chunked-prefill chunks by outcome (outcome=dispatched — one "
        "device call riding the decode FIFO; skipped_shared — every "
        "block was a prefix-cache hit, no compute dispatched)")


def generator_prefill_chunk_stall_ms():
    return REGISTRY.histogram(
        "kfserving_tpu_generator_prefill_chunk_stall_ms",
        "Device-busy time one prefill chunk inserted between decode "
        "fetches — the stall a cold prompt adds to live streams per "
        "chunk (the monolithic-prefill stall divided by chunk count)")


def generator_pipeline_depth():
    return REGISTRY.gauge(
        "kfserving_tpu_generator_pipeline_depth",
        "Effective decode pipeline depth after the adaptive governor "
        "(configured depth when streams extend past the in-flight "
        "horizon; 1 when speculative waves could only decode garbage)")


def generator_suppressed_waves_total():
    return REGISTRY.counter(
        "kfserving_tpu_generator_suppressed_waves_total",
        "Speculative decode waves the adaptive-depth governor did not "
        "enqueue because every active stream provably finishes within "
        "the waves already in flight")


# -- prefix cache & block pool -------------------------------------------
def generator_prefix_lookups_total():
    return REGISTRY.counter(
        "kfserving_tpu_generator_prefix_lookups_total",
        "Chain-hash prefix-index probes per full prompt block at plan "
        "time, by outcome (hit = the block's k/v were already "
        "device-resident and the plan points at the shared block; "
        "host_hit = a device miss answered by the host KV tier, the "
        "block faults back instead of re-prefilling; miss = a fresh "
        "block was allocated)")


# Reuse depth of an index entry: hit counts per entry, shallow to hot.
REUSE_DEPTH_BUCKETS = [1, 2, 4, 8, 16, 32, 64]


def generator_prefix_reuse_depth_hits():
    return REGISTRY.histogram(
        "kfserving_tpu_generator_prefix_reuse_depth_hits",
        "Cumulative hit count of a prefix-index entry at each hit "
        "(observed per hit event: an entry hit for the Nth time "
        "lands in the N bucket) — deep entries are hot shared "
        "system prompts, the routing-affinity signal",
        buckets=REUSE_DEPTH_BUCKETS)


def generator_prefill_tokens_saved_total():
    return REGISTRY.counter(
        "kfserving_tpu_generator_prefill_tokens_saved_total",
        "Prompt tokens whose k/v came from shared prefix blocks "
        "instead of being stored again (hit blocks x block_size)")


def generator_block_evictions_total():
    return REGISTRY.counter(
        "kfserving_tpu_generator_block_evictions_total",
        "Pool blocks leaving their role, by cause: capacity_spilled "
        "= LRU reclaim of a zero-ref cached prefix block under "
        "allocation pressure whose k/v landed in the host KV tier; "
        "capacity_dropped = the same reclaim with the state lost (no "
        "tier, no chain, or a failed spill); index_invalidation = provisional prefix "
        "registrations dropped because their planned writes never "
        "dispatched (plan rollback / enqueue failure); "
        "zombie_deferral = slot blocks released after maturing "
        "through the zombie-wave deferral window (the normal free "
        "path, counted so the deferral machinery is observable)")


def generator_pool_occupancy_ratio():
    return REGISTRY.gauge(
        "kfserving_tpu_generator_pool_occupancy_ratio",
        "Referenced (ref > 0) blocks over the whole pool at the last "
        "scrape — 1.0 means every block is held by a live slot or "
        "shared prefix; reclaimable cached blocks do not count")


def generator_pool_fragmentation_ratio():
    return REGISTRY.gauge(
        "kfserving_tpu_generator_pool_fragmentation_ratio",
        "Internal fragmentation of slot tables: 1 - resident tokens "
        "/ (table blocks x block_size), with shared prefix blocks "
        "counted per sharer on both sides — the tail positions "
        "allocated for growth but not yet holding k/v")


# -- speculative decoding (GenerationEngine draft/verify waves) ---------
def specdec_proposed_tokens_total():
    return REGISTRY.counter(
        "kfserving_tpu_specdec_proposed_tokens_total",
        "Draft tokens proposed to the verify dispatch, per model and "
        "proposer (draft = registered draft model, ngram = the "
        "prompt-lookup head)")


def specdec_accepted_tokens_total():
    return REGISTRY.counter(
        "kfserving_tpu_specdec_accepted_tokens_total",
        "Proposed draft tokens the target's own sampled draw agreed "
        "with (the longest-agreeing-prefix rule), per model and "
        "proposer — accepted/proposed is the acceptance rate")


def specdec_fallbacks_total():
    return REGISTRY.counter(
        "kfserving_tpu_specdec_fallbacks_total",
        "Speculative waves degraded to plain non-speculative decode "
        "by an injected fault, per model and seam (site=draft|"
        "verify) — output stays bit-exact, only tokens-per-dispatch "
        "drops")


# Accepted length per spec wave row is 1 (first draft token rejected;
# the target's own draw still lands) up to K+1 (all K accepted + the
# bonus draw).
SPECDEC_LENGTH_BUCKETS = [1, 2, 3, 4, 6, 8, 12, 16]


def specdec_accepted_length_tokens():
    return REGISTRY.histogram(
        "kfserving_tpu_specdec_accepted_length_tokens",
        "Tokens committed per live slot per speculative wave "
        "(1 = proposal rejected outright, K+1 = fully accepted plus "
        "the bonus draw), per model",
        buckets=SPECDEC_LENGTH_BUCKETS)


def specdec_draft_ms():
    return REGISTRY.histogram(
        "kfserving_tpu_specdec_draft_ms",
        "Draft-proposal overhead per speculative wave (device time "
        "for a registered draft model, host time for the n-gram "
        "head), per model and proposer",
        buckets=LATENCY_BUCKETS_MS)


def specdec_acceptance_ratio():
    return REGISTRY.gauge(
        "kfserving_tpu_specdec_acceptance_ratio",
        "Running acceptance rate (accepted/proposed draft tokens, "
        "0..1) per model — the knob that decides whether K is paying "
        "for itself")


# -- device-memory ledger (engine/hbm.py) --------------------------------
def hbm_resident_bytes():
    return REGISTRY.gauge(
        "kfserving_tpu_hbm_resident_bytes",
        "Accounted HBM residency per model (params + cache pool as "
        "admitted to the HBMManager budget); series are pruned when "
        "the model is released")


def hbm_budget_bytes():
    return REGISTRY.gauge(
        "kfserving_tpu_hbm_budget_bytes",
        "The HBMManager's packing budget for this device/mesh")


def hbm_evictions_total():
    return REGISTRY.counter(
        "kfserving_tpu_hbm_evictions_total",
        "Models evicted from HBM residency by the LRU accountant to "
        "fit an admission, labeled by the evicted model")


def hbm_eviction_skips_total():
    return REGISTRY.counter(
        "kfserving_tpu_hbm_eviction_skips_total",
        "LRU eviction candidates the admission plan passed over, by "
        "skipped model and reason (busy = the residency manager vetoed "
        "a victim with queued or in-flight work — the admission-aware "
        "guarantee that a serving model is never yanked from HBM)")


# -- model residency (engine/residency.py) -------------------------------
def residency_state():
    return REGISTRY.gauge(
        "kfserving_tpu_residency_state",
        "Per-model residency state (0=registered, 1=host-resident "
        "mmap-backed, 2=fault-in in flight, 3=HBM-resident serving); "
        "series are pruned when the model deregisters")


def residency_fault_in_ms():
    return REGISTRY.histogram(
        "kfserving_tpu_residency_fault_in_ms",
        "Fault-in latency of a predict that found its model outside "
        "HBM, by source (warm = host mmap params re-placed on device; "
        "cold = first activation paying download/materialize/compile)")


def residency_fault_ins_total():
    return REGISTRY.counter(
        "kfserving_tpu_residency_fault_ins_total",
        "Residency fault-ins by model and outcome (warm|cold = one "
        "physical transfer; coalesced = a concurrent request rode an "
        "already-in-flight fault instead of issuing its own; error = "
        "the fault failed and the incumbent resident set kept serving)")


# -- engine roofline (published at /metrics scrape time from engine stats)
def engine_mfu():
    return REGISTRY.gauge(
        "kfserving_tpu_engine_mfu",
        "Model FLOP utilization: achieved FLOP/s over the chip's "
        "peak, per phase (phase=infer — the bucketed TorchEngine path; "
        "decode|prefill — the generator's device spans).  A floor on "
        "true utilization: device seconds include the runtime round "
        "trip in non-blocking mode")


def engine_achieved_tflops():
    return REGISTRY.gauge(
        "kfserving_tpu_engine_achieved_tflops",
        "Achieved dense-compute TFLOP/s per engine phase (the MFU "
        "numerator, absolute)")


def engine_padding_waste_ratio():
    return REGISTRY.gauge(
        "kfserving_tpu_engine_padding_waste_ratio",
        "Fraction of dispatched batch/sequence slots that were "
        "bucket padding, per compiled bucket (0 = every slot carried "
        "a real token/row)")


def engine_goodput_ratio():
    return REGISTRY.gauge(
        "kfserving_tpu_engine_goodput_ratio",
        "Useful emitted tokens over useful + garbage token steps "
        "(speculative-wave decode past a finish/cancel) — the decode "
        "pipeline's goodput split")


def engine_hbm_bw_util_ratio():
    return REGISTRY.gauge(
        "kfserving_tpu_engine_hbm_bw_util_ratio",
        "Decode HBM read-bandwidth utilization estimated from the "
        "params + resident KV-cache working set per token step over "
        "the chip's peak HBM bandwidth (decode is bandwidth-bound: "
        "this is its roofline axis)")


# -- reliability ---------------------------------------------------------
def deadline_exceeded_total():
    return REGISTRY.counter(
        "kfserving_tpu_deadline_exceeded_total",
        "Requests shed because their latency budget ran out, by stage")


def retry_total():
    return REGISTRY.counter(
        "kfserving_tpu_retry_total",
        "Retries performed, labeled by edge (policy name) and reason "
        "(exception class)")


# -- mmap param cache (engine/param_cache.py) ----------------------------
def param_cache_total():
    return REGISTRY.counter(
        "kfserving_tpu_param_cache_total",
        "mmap param-cache lookups and stores, by outcome "
        "(hit|miss|store|error)")


# -- host KV tier (engine/kv_tier.py): spilled conversation state one
# level under the device pool ---------------------------------------------
def generator_kv_tier_blocks():
    return REGISTRY.gauge(
        "kfserving_tpu_generator_kv_tier_blocks",
        "Blocks currently held by the host KV tier (spilled "
        "conversation prefixes a returning turn can fault back "
        "instead of re-prefilling)")


def generator_kv_tier_occupancy_ratio():
    return REGISTRY.gauge(
        "kfserving_tpu_generator_kv_tier_occupancy_ratio",
        "Host KV tier occupancy over its capacity (1.0 = the tier's "
        "own LRU ledger is evicting on every admission)")


def generator_kv_tier_spills_total():
    return REGISTRY.counter(
        "kfserving_tpu_generator_kv_tier_spills_total",
        "Capacity-evicted blocks offered to the host tier by outcome: "
        "spilled = payload landed and the index entry published; "
        "failed = the spill failed (the eviction degraded to a drop, "
        "counted under block_evictions{cause=\"capacity_dropped\"}); "
        "duplicate = the chain was already host-resident")


def generator_kv_tier_faultbacks_total():
    return REGISTRY.counter(
        "kfserving_tpu_generator_kv_tier_faultbacks_total",
        "Host-tier blocks a returning turn's admission plan claimed, by "
        "outcome: faulted = one physical read + pool insert; coalesced "
        "= a concurrent plan rode an in-flight fault (single-flight); "
        "failed = the fault-back failed and the turn fell through to a "
        "normal re-prefill")


def generator_kv_tier_faultback_ms():
    return REGISTRY.histogram(
        "kfserving_tpu_generator_kv_tier_faultback_ms",
        "Latency of one fault-back batch (tier read into pinned memory "
        "+ host-to-device copy and pool insert enqueue): the "
        "milliseconds a returning turn paid instead of a re-prefill")


def generator_kv_tier_evictions_total():
    return REGISTRY.counter(
        "kfserving_tpu_generator_kv_tier_evictions_total",
        "Host-tier entries leaving the ledger by reason: capacity = LRU "
        "eviction admitting a newer spill; skipped_inflight = an "
        "eviction vetoed because the victim was mid-fault-in; "
        "faultback_failed = entry dropped because its read failed (the "
        "payload is suspect: the turn re-prefills)")


def generator_kv_tier_tokens_saved_total():
    return REGISTRY.counter(
        "kfserving_tpu_generator_kv_tier_tokens_saved_total",
        "Prompt tokens served from the host KV tier instead of "
        "re-prefilled (host-hit blocks x block_size), kept apart from "
        "generator_prefill_tokens_saved_total")


# -- KV handoff: conversation state surviving the replica process (drain
# exports, manifest re-attach, peer transfer) ------------------------------
def kv_handoff_exported_blocks_total():
    return REGISTRY.counter(
        "kfserving_tpu_kv_handoff_exported_blocks_total",
        "Device KV blocks offered to the durable host tier by the drain "
        "export (live slots and hot prefix chains), by outcome: "
        "exported = payload landed in the tier; skipped = already "
        "host-resident; dropped = the drain budget ran out first "
        "(hottest first, so drops are the coldest tail); failed = the "
        "export failed (engine.kv_export or a gather/copy error)")


def kv_handoff_reattached_blocks_total():
    return REGISTRY.counter(
        "kfserving_tpu_kv_handoff_reattached_blocks_total",
        "Predecessor-generation tier entries processed on re-attach "
        "(boot-time adoption or POST /kv/reattach), by outcome: adopted "
        "= digest-verified and admitted; duplicate = already resident; "
        "corrupt = payload digest mismatch; truncated = payload file "
        "short of the recorded slot; torn = unparseable manifest line; "
        "version_skew = record schema version unknown to this build; "
        "dropped_capacity = adoption never evicts the successor's own "
        "entries; failed = admission failed")


def kv_handoff_peer_blocks_total():
    return REGISTRY.counter(
        "kfserving_tpu_kv_handoff_peer_blocks_total",
        "KV blocks pulled over the replica-to-replica transfer path "
        "(GET /kv/chains/<chain> on a peer), by outcome: imported = "
        "digest-verified on receipt and admitted; digest_mismatch = "
        "wire payload failed verification (discarded); skipped = "
        "already resident locally; failed = fetch error or the "
        "engine.kv_import fault site")


def kv_handoff_export_ms():
    return REGISTRY.histogram(
        "kfserving_tpu_kv_handoff_export_ms",
        "Wall time of one drain export pass (gather + device-to-host "
        "copy + tier writes for all surviving candidates), bounded by "
        "KFS_KV_EXPORT_BUDGET_S")


# -- per-request cost attribution (observability/attribution.py) --------
def request_device_ms():
    return REGISTRY.histogram(
        "kfserving_tpu_request_device_ms",
        "Per-request attributed device time by phase (prefill|"
        "decode): each dispatch's busy interval is split evenly "
        "across the live streams it served, so the series sums to "
        "total device time (the InferLine-style per-stage cost the "
        "provisioning math consumes)")


def request_phase_tokens():
    return REGISTRY.histogram(
        "kfserving_tpu_request_phase_tokens",
        "Per-request token counts by phase (prefill = prompt tokens "
        "ingested, decode = tokens generated)",
        buckets=TOKEN_BUCKETS)


def request_held_blocks():
    return REGISTRY.histogram(
        "kfserving_tpu_request_held_blocks",
        "Peak pool blocks a request's slot table held (paged mode; "
        "prompt + growth horizon) — the residency cost of admitting "
        "this request",
        buckets=BLOCK_BUCKETS)


def request_cache_saved_tokens():
    return REGISTRY.histogram(
        "kfserving_tpu_request_cache_saved_tokens",
        "Prompt tokens a request did not re-store thanks to prefix-"
        "cache hits (hit blocks x block_size; 0 = fully cold)",
        buckets=TOKEN_BUCKETS)


def request_host_tier_saved_tokens():
    return REGISTRY.histogram(
        "kfserving_tpu_request_host_tier_saved_tokens",
        "Prompt tokens a request served from the host KV tier "
        "(fault-back) instead of re-prefilling — distinct from "
        "request_cache_saved_tokens (device prefix hits) so the "
        "per-request cost record shows WHICH tier earned the "
        "savings; the two are additive",
        buckets=TOKEN_BUCKETS)



# -- monitoring loop (observability/monitoring/) ------------------------
def monitor_events_total():
    return REGISTRY.counter(
        "kfserving_tpu_monitor_events_total",
        "Monitor-bus publish outcomes (outcome=published|sampled_out|"
        "dropped; dropped = bounded queue full, serving never blocks)")


def monitor_consumer_errors_total():
    return REGISTRY.counter(
        "kfserving_tpu_monitor_consumer_errors_total",
        "Monitor consumer callbacks that raised (by consumer name); "
        "a broken monitor never breaks the bus or serving")


def monitor_alert_state():
    return REGISTRY.gauge(
        "kfserving_tpu_monitor_alert_state",
        "Per-model online monitor alert state (monitor=drift|outlier; "
        "1 = alerting)")


def drift_score():
    return REGISTRY.gauge(
        "kfserving_tpu_drift_score",
        "Max per-feature two-sample KS statistic of the live window "
        "vs the reference sample (0 = identical distributions)")


def outlier_rate():
    return REGISTRY.gauge(
        "kfserving_tpu_outlier_rate",
        "Fraction of the sliding window flagged as Mahalanobis "
        "outliers against the reference distribution")


def slo_burn_rate():
    return REGISTRY.gauge(
        "kfserving_tpu_slo_burn_rate",
        "Error-budget burn rate per model/objective/window (1.0 = "
        "spending exactly the budget; alert past the threshold)")


def slo_alert_state():
    return REGISTRY.gauge(
        "kfserving_tpu_slo_alert_state",
        "Per-model SLO alert state (1 = burn rate over threshold on "
        "every configured window)")


def slo_breaches_total():
    return REGISTRY.counter(
        "kfserving_tpu_slo_breaches_total",
        "SLO alert activations (0 -> 1 transitions) per model")


def flightrecorder_pinned_total():
    return REGISTRY.counter(
        "kfserving_tpu_flightrecorder_pinned_total",
        "Flight-recorder entries pinned, by trigger reason")



# -- telemetry history and trend detection (observability/history/) ----
def history_tick_ms():
    return REGISTRY.histogram(
        "kfserving_tpu_history_tick_ms",
        "Wall time of one history sampler tick (walk every registry "
        "family, append rings, run the trend detector) — the "
        "sampler's own overhead, bounded by construction")


def history_tick_failures_total():
    return REGISTRY.counter(
        "kfserving_tpu_history_tick_failures_total",
        "History sampler ticks that raised (swallowed; history goes "
        "stale-but-served) — a climbing rate means the time axis is "
        "silently frozen")


def history_samples_total():
    return REGISTRY.counter(
        "kfserving_tpu_history_samples_total",
        "Points appended to the in-process history rings across all "
        "series and ticks")


def history_series():
    return REGISTRY.gauge(
        "kfserving_tpu_history_series",
        "Live series in the history ring store (bounded by "
        "KFS_HISTORY_MAX_SERIES; overflow is dropped, never grown)")


def trend_slope_per_second():
    return REGISTRY.gauge(
        TREND_SLOPE_SERIES,
        "EWMA'd first derivative of each watched history series "
        "(units of the series per second), labeled {series=family, "
        "...underlying labels} — the leading input slope-aware "
        "predictive scaling consumes")


def trend_zscore():
    return REGISTRY.gauge(
        "kfserving_tpu_trend_zscore",
        "Latest z-score of each watched history series against its "
        "EWMA baseline (|z| past the threshold for consecutive ticks "
        "declares a change-point)")


def trend_changepoints_total():
    return REGISTRY.counter(
        "kfserving_tpu_trend_changepoints_total",
        "Change-points the history trend detector declared, by "
        "watched series — each one also pins a trend_<series> "
        "flight-recorder entry embedding the pre/post window frames")



# -- device-discipline sanitizer (KFS_SANITIZE=1) -----------------------
def sanitizer_violations_total():
    return REGISTRY.counter(
        "kfserving_tpu_sanitizer_violations_total",
        "Runtime device-discipline violations by kind "
        "(forbidden_transfer: implicit host<->device transfer under "
        "the armed guard; recompile: a compilation after a source's "
        "declared warmup; loop_stall: the event loop failed to run a "
        "watchdog tick within the threshold)")


def sanitizer_armed():
    return REGISTRY.gauge(
        "kfserving_tpu_sanitizer_armed",
        "1 while KFS_SANITIZE=1 has the runtime sanitizer active in "
        "this process (transfer guard + recompile assertion + loop "
        "watchdog)")



# -- incident engine (observability/incidents/) -------------------------
def incident_open():
    return REGISTRY.gauge(
        "kfserving_tpu_incident_open",
        "Open (undiagnosed-recovery) incidents per dedup key — the "
        "model under breach, or `_server` for process-wide storms")


def incident_opened_total():
    return REGISTRY.counter(
        "kfserving_tpu_incident_opened_total",
        "Incidents opened, labeled by the causal classifier's "
        "top-ranked hypothesis at open time (queue_wait|"
        "device_compute|cache_miss_storm|eviction_thrash|"
        "recompile_host_sync|brownout_shed|failover|unclassified)")


def incident_triggers_total():
    return REGISTRY.counter(
        "kfserving_tpu_incident_triggers_total",
        "Detector firings fed to the incident engine by trigger kind "
        "(slo_breach|trend|sanitizer|eviction_storm|faultback_storm|"
        "failover) — each either opens an incident or attaches to the "
        "open one inside the dedup window")


def incident_failures_total():
    return REGISTRY.counter(
        "kfserving_tpu_incident_failures_total",
        "Incident pipeline failures by reason (error = diagnosis "
        "raised and was swallowed, dropped = the bounded trigger "
        "queue overflowed while the worker was wedged) — under chaos "
        "the pipeline degrades to plain detector pins, it never "
        "blocks serving")


# An incident lives seconds (a one-tick blip) to tens of minutes (a
# sustained regression).
INCIDENT_DURATION_BUCKETS_MS = [
    1000, 5000, 15000, 60000, 300000, 900000, 3600000]


def incident_duration_ms():
    return REGISTRY.histogram(
        "kfserving_tpu_incident_duration_ms",
        "Open-to-close wall time of resolved incidents (close = "
        "recovery observed, then the cooldown window passed with no "
        "further triggers)",
        buckets=INCIDENT_DURATION_BUCKETS_MS)


# -- control plane: breakers, router, autoscaler, brownout, lifecycle ---
def breaker_state():
    return REGISTRY.gauge(
        "kfserving_tpu_breaker_state",
        "Circuit breaker state (0=closed, 1=half_open, 2=open)")


def breaker_transitions():
    return REGISTRY.counter(
        "kfserving_tpu_breaker_transitions_total",
        "Circuit breaker state transitions (to=open|closed)")


def router_inflight():
    return REGISTRY.gauge(
        "kfserving_tpu_router_inflight",
        "In-flight proxied requests per component")


def router_requests_total():
    return REGISTRY.counter(
        "kfserving_tpu_router_requests_total",
        "Requests routed per component")


def router_rotation_skips_total():
    return REGISTRY.counter(
        "kfserving_tpu_router_rotation_skips_total",
        "Replica picks skipped because the host's breaker was open")


def router_shed_total():
    return REGISTRY.counter(
        "kfserving_tpu_router_shed_total",
        "Requests the router shed instead of proxying, by reason")


def router_request_ms():
    return REGISTRY.histogram(
        "kfserving_tpu_router_request_ms",
        "Router-observed request latency (proxy hop included)",
        buckets=LATENCY_BUCKETS_MS)


def autoscaler_tick_failures_total():
    return REGISTRY.counter(
        "kfserving_tpu_autoscaler_tick_failures_total",
        "Autoscaler ticks that raised (the control loop swallowed the "
        "exception and kept running) — a climbing rate means the "
        "scaling loop is silently dead")


def brownout_level():
    return REGISTRY.gauge(
        "kfserving_tpu_brownout_level",
        "Per-model brownout level (0 = off; level N sheds priority "
        "tiers below N with explicit retriable 503s)")


def brownout_shed_total():
    return REGISTRY.counter(
        "kfserving_tpu_brownout_shed_total",
        "Requests the brownout admission gate shed, by model and "
        "reason (priority = tier below the active level, deadline = "
        "remaining budget cannot cover the observed service time, "
        "fault = injected admission fault)")


def brownout_transitions_total():
    return REGISTRY.counter(
        "kfserving_tpu_brownout_transitions_total",
        "Brownout level transitions per model (direction=enter|"
        "escalate|recover|exit)")


def revision_requests_total():
    return REGISTRY.counter(
        "kfserving_tpu_revision_requests_total",
        "Router upstream attempts per served revision (labels: model, "
        "revision, status; transport failures count as 5xx) — the "
        "per-revision series the rollout analyzer gates on")


def revision_request_ms():
    return REGISTRY.histogram(
        "kfserving_tpu_revision_request_ms",
        "Router-observed upstream attempt latency per served revision",
        buckets=LATENCY_BUCKETS_MS)


def rollout_state():
    return REGISTRY.gauge(
        "kfserving_tpu_rollout_state",
        "Rollout state machine phase per component/revision "
        "(0=warming, 1=progressing, 2=promoted, 3=rolled_back)")


def rollout_step_percent():
    return REGISTRY.gauge(
        "kfserving_tpu_rollout_step_percent",
        "Current canary traffic percent the rollout manager has "
        "granted the component's latest revision")


def rollout_transitions_total():
    return REGISTRY.counter(
        "kfserving_tpu_rollout_transitions_total",
        "Rollout state-machine transitions by event (step|promoted|"
        "rolled_back)")


def rollout_quarantined():
    return REGISTRY.gauge(
        "kfserving_tpu_rollout_quarantined",
        "Quarantined (rolled-back) revision hashes currently "
        "remembered per component")


def autoscaler_decisions_total():
    return REGISTRY.counter(
        "kfserving_tpu_autoscaler_decisions_total",
        "Predictive control-loop decisions by component and action "
        "(scale_up|pre_arm|brownout_enter|brownout_exit) — every one "
        "also lands as a pinned supervisor flight-recorder record")


def autoscaler_predicted_replicas():
    return REGISTRY.gauge(
        "kfserving_tpu_autoscaler_predicted_replicas",
        "Replica count the feed-forward latency model sized for a "
        "component at the last tick (arrival rate x observed service "
        "time vs SLO headroom); 0 = the predictive path is not "
        "engaged")


def payload_log_total():
    return REGISTRY.counter(
        "kfserving_tpu_payload_log_total",
        "CloudEvents payload-logger events by outcome "
        "(outcome=sent|failed|dropped)")


def payload_log_queued():
    return REGISTRY.gauge(
        "kfserving_tpu_payload_log_queued",
        "CloudEvents payload-logger queue depth")


def lifecycle_swaps_total():
    return REGISTRY.counter(
        "kfserving_tpu_lifecycle_swaps_total",
        "Replica recycle swaps by mode (warm_standby|exclusive_"
        "standby|overlap|cold) and outcome (ok|failed)")


def lifecycle_swap_failures_total():
    return REGISTRY.counter(
        "kfserving_tpu_lifecycle_swap_failures_total",
        "Standby swaps that aborted with the incumbent kept serving, "
        "by reason (spawn_error|activate_error|activate_timeout)")


def lifecycle_promotions_total():
    return REGISTRY.counter(
        "kfserving_tpu_lifecycle_promotions_total",
        "Crash-detected replicas replaced by standby promotion, by "
        "trigger (process_exit|health_fail|crash_report) and outcome "
        "(promoted|cold_respawn)")


# Lifecycle phases span three decades (a warm activate is hundreds of
# ms, a cold standby spawn tens of seconds) — the request-latency
# ladder tops out too low to separate a 14 s activate from a 40 s one.
LIFECYCLE_BUCKETS_MS = [50, 100, 250, 500, 1000, 2000, 5000, 10000,
                        20000, 40000, 80000]


def lifecycle_phase_ms():
    return REGISTRY.histogram(
        "kfserving_tpu_lifecycle_phase_ms",
        "Wall time of each replica lifecycle phase (standby_spawn|"
        "activate|drain|promote)",
        buckets=LIFECYCLE_BUCKETS_MS)


def lifecycle_standby_pool():
    return REGISTRY.gauge(
        "kfserving_tpu_lifecycle_standby_pool",
        "Warm standby processes currently armed (spawned, imports + "
        "artifact done, device untouched) per component")


def router_swap_held_total():
    return REGISTRY.counter(
        "kfserving_tpu_router_swap_held_total",
        "Requests that hit an announced swap window, by outcome "
        "(served = a replica appeared inside the hold budget, shed = "
        "bounded queue full, expired = hold budget ran out)")


def router_swap_hold_ms():
    return REGISTRY.histogram(
        "kfserving_tpu_router_swap_hold_ms",
        "Time requests were held at the router across an announced "
        "drain->activate swap window before being served",
        buckets=LATENCY_BUCKETS_MS)


def router_affinity_total():
    return REGISTRY.counter(
        "kfserving_tpu_router_affinity_total",
        "Affinity replica picks by key mode and outcome (mode=model "
        "hashes the model name, mode=prefix hashes the normalized "
        "prompt's first-N-block chain digest onto the same ring; "
        "ring = served at the key's primary ring position; spill = "
        "overload/breaker moved it to the next ring position; "
        "fallback = the ring yielded no host or an injected "
        "affinity-pick fault dropped the request to plain "
        "round-robin)")


def router_stream_failover_total():
    return REGISTRY.counter(
        "kfserving_tpu_router_stream_failover_total",
        "Mid-stream upstream deaths surfaced to the client as an "
        "explicit retriable failover event, per model")
