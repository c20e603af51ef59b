"""Fault-injection site names of the port.

Port of ``kfserving_tpu/reliability/fault_sites.py``: the same names, so
one ``KFS_FAULTS`` configuration reads alike in both packages.  Only the
sites the port calls are here; the others come with the modules that
call them.
"""

# Storage.download's remote pull, keyed by URI: an injected failure is a
# flaky object store, replayed by the KFS_STORAGE retry policy.
STORAGE_DOWNLOAD = "storage.download"

# The agent Downloader's pull of one model, keyed by model name: injected
# before any filesystem change, so the puller's KFS_PULLER retry policy
# replays it like a storage flake.
AGENT_PULL = "agent.pull"

# KFServingClient's HTTP calls, keyed by URL: an injected error is a
# refused connect, which the KFS_CLIENT retry policy replays (nothing was
# sent).
CLIENT_REQUEST = "client.request"

# DataPlane.infer, keyed by model name (with " revision:<hash>" on a
# replica of the in-process orchestrator, whose replicas share one
# injector): an injected failure lands inside the request's measured path,
# as a model-side failure would.
DATAPLANE_INFER = "dataplane.infer"

# ResidencyManager fault-in, keyed by "<model> source:cold|warm": an
# injected failure fails that model's fault-in alone while the resident
# set keeps serving.
ENGINE_RESIDENCY_SWAP = "engine.residency_swap"

# GenerationEngine draft-proposal seam of a speculative decode wave, keyed
# by engine name: an injected error degrades that wave to plain decode
# with the same tokens (specdec_fallbacks_total{site="draft"}).
ENGINE_SPEC_DRAFT = "engine.spec_draft"

# GenerationEngine K+1-position verify seam of a speculative decode wave,
# keyed by engine name: as above, counted under site="verify".
ENGINE_SPEC_VERIFY = "engine.spec_verify"

# GenerationEngine host-tier spill of capacity-evicted KV blocks, keyed by
# engine name: an injected error fails the spill before the tier index
# publishes, so the eviction degrades to a plain drop (counted
# cause=capacity_dropped).
ENGINE_KV_SPILL = "engine.kv_spill"

# GenerationEngine host-tier fault-back of a returning turn's spilled
# blocks, keyed by engine name: an injected error fails the read before
# any pool insert, so the plan rolls back and the turn re-prefills.
ENGINE_KV_FAULTBACK = "engine.kv_faultback"

# GenerationEngine drain export of live-slot and hot prefix-chain KV into
# the durable host tier, keyed by engine name: an injected error fails the
# export before any tier write (every candidate counted outcome=failed).
ENGINE_KV_EXPORT = "engine.kv_export"

# GenerationEngine admission of peer-transferred KV payloads (the
# /kv/reattach pull path), keyed by engine name: an injected error rejects
# the batch before any tier publication.
ENGINE_KV_IMPORT = "engine.kv_import"

# HistorySampler background tick, probed through the async hook the
# server injects: an injected hang parks only the sampler task and an
# injected error is swallowed and counted, so history degrades to
# stale-but-served and the serving path never blocks on its telemetry.
OBSERVABILITY_HISTORY_TICK = "observability.history_tick"

# IncidentManager diagnosis worker, probed before each queued trigger:
# an injected error is swallowed and counted
# (kfserving_tpu_incident_failures_total), an injected hang parks only
# the worker, so a wedged incident pipeline degrades to plain detector
# pins and predicts never wait on diagnosis.
OBSERVABILITY_INCIDENT_OPEN = "observability.incident_open"

# IngressRouter upstream proxy attempts, keyed by "<url>
# revision:<hash>" so a match can scope chaos to one side of a canary
# split: an injected error takes the pre-dispatch failover path a
# refused connection would, an injected hang the upstream timeout.
ROUTER_DISPATCH = "router.dispatch"

# IngressRouter brownout admission gate, keyed by "<model>
# priority:<tier>": an injected error sheds as an explicit retriable
# 503, a delay stalls admission.
ROUTER_ADMISSION = "router.admission"

# IngressRouter model-affinity ring pick, keyed by "<model> <component>":
# an injected error drops the request to plain round-robin (counted as
# outcome=fallback).
ROUTER_AFFINITY_PICK = "router.affinity_pick"

# SubprocessOrchestrator standby activation, keyed by "<host> <cid>
# revision:<hash>": drives the swap-failure path (the incumbent keeps
# serving, the standby is reaped).
ORCHESTRATOR_STANDBY_ACTIVATE = "orchestrator.standby_activate"

# Autoscaler per-component scaling evaluation, keyed by
# "<isvc>/<component>": an injected delay or failure wedges the control
# loop itself.
AUTOSCALER_TICK = "autoscaler.tick"
