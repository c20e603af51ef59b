"""GenerationEngine: KV-cache decoding with continuous batching.

Port of ``kfserving_tpu/engine/generator.py``: its two cache modes, its
chunked prefill and its speculative decoding.

- **paged cache** (``block_size`` set): per layer a shared block pool
  [NB + 1, BS, H, D] (the last block is the sink that dropped writes land
  in, see ``ops/paged_attention.py``) plus per-slot block tables [S, MB]
  on the host.  Device memory scales with resident tokens; identical
  prompt prefixes share blocks through a chain-hash index; pool pressure
  queues admissions; block release is deferred past in-flight waves (the
  zombie-wave hazard); a slot that cannot grow is preempted and resumes
  exactly.
- **dense slots** (no ``block_size``): per layer one [S, max_seq + 1, H,
  D] cache per slot row, written in place (the last position is the sink
  that parked rows' and out-of-window writes land in), so the engine
  holds one cache, as the JAX engine's donated caches are one.  Decode
  attends with the masked plain attention (XLA in the reference).
- **prefill/decode split**: a prompt group runs one bucket-padded
  forward (causal + lengths: the CUDA flash kernel on the card), its k/v
  scatter into the pool blocks or slot rows (bucket-padding rows drop),
  and the first tokens land in the device feed arrays.  Decode then runs
  ``steps_per_call`` single-token steps per wave (paged: through the
  paged decode kernel), feeding each step's tokens to the next on the
  device.
- **chunked prefill** (paged, ``prefill_chunk_tokens``): a cold prompt
  longer than the chunk lands in block-aligned chunks that ride the
  in-flight FIFO between decode waves: one chunk in flight while other
  streams decode, ``pipeline_depth`` otherwise.  A chunk writes its k/v
  through the slot's table and attends over the pool per query
  (``paged_prefill_attention``, a gather, as in the reference); fresh
  prefix registrations wait until their chunk dispatches; a chunk whose
  every block was a prefix hit is skipped; the final chunk samples the
  stream's first token, noise-keyed on the full prompt length.  Under
  pool pressure a mid-prefill slot yields its blocks first and restarts.
- **speculative decoding** (``speculative``): at depth 1, a wave
  proposes K tokens a live slot (the n-gram head on the host, or a draft
  model's K greedy forwards over a rolling window) and verifies all K + 1
  positions in one dispatch whose every position samples with the decode
  wave's (seed, position) noise (the positions run layer by layer at the
  decode step's shapes, so their logits are a sequential decode's bit for
  bit on the card too); the longest prefix on which
  the proposal equals the target's own draw is accepted, so the tokens
  equal non-speculative decode's.  The ``engine.spec_draft`` and
  ``engine.spec_verify`` fault sites degrade one wave to a plain wave
  (after re-syncing the device feed from the host).
- **pipelined, sync-free dispatch**: all device work is enqueued on ONE
  enqueue thread, on the engine's own CUDA stream (in order), inside
  ``torch.inference_mode()``.  Results copy into pinned host memory with
  ``non_blocking=True`` behind a CUDA event; the fetch executor waits on
  the event, never the loop thread or the enqueue thread.  Nothing on the
  enqueue path reads a device value back (no ``.item()``, ``.tolist()``
  or ``.cpu()``), so ``pipeline_depth`` waves stay in flight.
- **compiled programs**: on the card every program but the bucketed
  prefill is a CUDA graph over static inputs (one host-to-device copy a
  dispatch), the JAX engine's one compiled program per shape split by
  the host's sampling decisions: the decode wave per ("decode", S, K,
  flags), a chunk per ("chunk", table blocks, flags), the verify per
  ("spec_verify", S, K + 1, flags), the draft per ("spec_draft", S, W)
  and the feed re-sync per ("feed_resync", S).  A program's first
  dispatch runs eagerly (its results are that dispatch's) and is then
  captured; the greedy wave is captured when the engine starts.  All of
  an engine's graphs share one memory pool; each first capture is noted
  to ``engine/compile_cache.py``.  On the CPU every program runs eagerly
  on the same static tensors.
- **sampling on the device**: greedy (``argmax``, first index on ties),
  temperature via the Gumbel trick, top-k and top-p.  Where JAX branches
  on the device (``lax.cond``), the port decides on the host from the
  slots' own request parameters: the noise, the support mask and the
  logprobs run only when some row needs them, and give the same result
  for every row either way.  The noise is JAX's: each row draws
  ``jax.random.gumbel`` under the key ``fold_in(fold_in(PRNGKey(
  rng_seed), seed), position)``, computed in torch integer ops
  (``engine/threefry.py``; its bits equal JAX's, its logarithm is
  torch's), so a seeded request draws the JAX package's tokens however
  it is scheduled (preemption, chunking and speculation included).
- **host KV tier** (paged, ``host_tier_blocks``): a capacity-evicted
  prefix block's k/v spill to a host mmap tier (``engine/kv_tier.py``)
  instead of being dropped, and a returning turn's plan probes device
  index -> host tier -> re-prefill.  The spill gathers the blocks
  (``index_select`` over the real blocks) on the engine's stream before
  any dispatch that could rewrite them, copies them into pinned memory
  behind an event, and the fetch executor writes the tier.  A fault-back
  reads the payloads into pinned memory, copies them to the card on the
  engine's stream and writes them into the pool in place
  (``paged_insert``), before the plan's own dispatches; each staging
  buffer is held until its copy's event.  A failed spill degrades to a
  drop, a failed fault-back rolls the plan back to a re-prefill, both
  counted.  ``export_kv`` copies live slots' and hot chains' blocks into
  a persistent tier for a successor; ``kv_import`` admits a peer's.
- **deadlines and telemetry**: a request carries the deadline and trace
  id of the context that submitted it; between decode waves a request
  whose budget ran out ends with finish_reason ``"timeout"`` and frees
  its slot.  Tokens feed the TTFT / inter-token / tokens-per-second
  series, the prefix index and the pool their lookup, reuse-depth,
  tokens-saved and eviction counters, chunks and speculation their
  families, and every finished request records a ``generator.generate``
  span; ``stats()`` carries the roofline accounting (decode and prefill
  FLOP/s and MFU, decode memory bandwidth) that ``/metrics`` publishes,
  and ``cache_debug()`` the ``/debug/cache`` block.
- **cost attribution and the timeline**: each fetched dispatch's busy
  interval (enqueue to its results' completion, overlap-corrected, the
  interval ``prefill_device_s`` and ``decode_device_s`` sum) is split
  evenly across the live requests it served, so the per-request cost
  records (``observability/attribution.py``, one per request on every
  terminal path: eos, length, timeout, cancel) sum to the engine's
  device time.  The same interval is a device-track event on the engine
  timeline (``decode.wave``, ``spec.verify``, ``prefill.bucket``,
  ``prefill.chunk``) beside per-slot events carrying each request's
  trace id; preemptions, HOLD windows, suppressed waves, cache hits,
  evictions, fault-backs and KV export/import are host-track events, and
  each fetch samples the pool as a counter.
- **sanitizer**: under ``KFS_SANITIZE=1`` the scheduler loop runs inside
  ``sanitizer.loop_guard`` (an implicit transfer of a tensor on the
  engine's device type on the loop thread raises), and each fetch is a
  sanctioned one.

- **meshes** (``mesh``, a DeviceMesh of more than one rank): the module
  is this rank's tensor-parallel shard (``parallel/sharding.py``), and
  the KV pool or the dense slot caches shard on the heads axis as the
  q/k/v projections that fill them do (they replicate when ``num_heads
  % tp`` leaves a remainder, as the projections then do): cache writes,
  the flash prefill and draft forwards (K1) and the paged decode and
  verify (K2) run on the rank's local heads, and the all-reduce after
  each layer's out and MLP-down projections is the only collective of a
  forward.  The LM head stays replicated, so every rank holds the same
  logits.  Rank 0's engine sends every device operation to the other
  ranks (``attach_leader``) from its enqueue thread before it runs it,
  so they arrive in its dispatch order and the ranks' collectives pair
  up: decode waves, prefill buckets, chunks, spec waves, feed re-syncs,
  tier gathers and fault-back inserts.  The other ranks' engines never
  schedule and run what arrives (``mirror``).  Every mode is served
  under a mesh:

  - dense slots and chunked prefill need nothing more: a chunk is one
    command, dispatched whole, so a preemption or a cancel between
    chunks leaves no rank inside a collective;
  - speculative decoding: the n-gram head's proposals travel in the
    spec command's host input, and a draft model runs on rank 0 alone,
    its proposals broadcast into every rank's verify input
    (``parallel/mesh.py::broadcast_from_rank0``; on the device over
    NCCL, through the host over gloo, whose all-reduces already join
    the host every layer).  Replicas of the draft on every rank (the
    JAX package replicates it) would hold one draft per rank and would
    need every rank's proposals to be bit-equal to rank 0's, which
    nothing guarantees across cards or BLAS algorithm choices: one
    flipped argmax would feed a follower's verify other tokens and
    corrupt the all-reduced logits of every later token;
  - the host KV tier and handoff stay on rank 0's host, their payloads
    in the JAX layout with every head (as the JAX package's
    ``device_get`` of a sharded pool gathers them): a spill or export
    gathers every rank's heads of the blocks at rank 0
    (``_collect_heads``), and a fault-back scatters each rank its heads
    (``_scatter_heads``), over the process group.  A follower holds its
    share of the pool and of each snapshot, never a tier.  With
    replicated heads rank 0's snapshot is the payload and every rank
    receives the whole of a fault-back's.  A tier or handoff directory
    is therefore the same under any mesh.

  Under a mesh every program runs eagerly (a gloo collective cannot sit
  inside a CUDA graph).

Left for later: graphs for the prefill buckets, and graphs under a
mesh.
"""

import asyncio
import concurrent.futures
import contextlib
import hashlib
import itertools
import logging
import os
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Dict, List, Optional, Tuple

import numpy as np
import torch

from kfserving_tpu_torch.engine import compile_cache, graphs, threefry
from kfserving_tpu_torch.engine.kv_tier import HostKVTier
from kfserving_tpu_torch.engine.speculative import (
    DEFAULT_DRAFT_WINDOW,
    NGramProposer,
    make_draft_proposer,
    rolling_windows,
)
from kfserving_tpu_torch.engine.torch_engine import device_peak_flops
from kfserving_tpu_torch.observability import attribution
from kfserving_tpu_torch.observability import metrics as obs
from kfserving_tpu_torch.observability.profiling import TIMELINE
from kfserving_tpu_torch.observability.profiling.roofline import (
    device_peak_hbm_bw,
)
from kfserving_tpu_torch.ops.flash_attention import check_kernel_shapes
from kfserving_tpu_torch.ops.paged_attention import (
    check_head_dim,
    paged_insert,
)
from kfserving_tpu_torch.protocol.errors import InferenceError, InvalidInput
from kfserving_tpu_torch.reliability import fault_sites, sanitizer
from kfserving_tpu_torch.reliability.deadline import current_deadline
from kfserving_tpu_torch.reliability.faults import FaultInjected, faults
from kfserving_tpu_torch.tracing import Span, current_request_id, tracer

logger = logging.getLogger("kfserving_tpu_torch.engine.generator")

# Process-monotonic generator ids (compile-cache sources).
_generator_seq = itertools.count()

# Blocks per spill gather, fault-back insert and export gather: bounds the
# device snapshot (4.7 MB a block at GPT-2-small width in bf16).
TIER_GROUP_BLOCKS = 32

def sampling_noise(base_key: torch.Tensor, seeds: torch.Tensor,
                   positions: torch.Tensor, vocab: int) -> torch.Tensor:
    """[B, V] float32 Gumbel(0, 1) noise: row b draws
    ``jax.random.gumbel(fold_in(fold_in(base_key, seeds[b]),
    positions[b]), (V,))``, as the JAX generator's sampler does."""
    keys = threefry.fold_in(threefry.fold_in(base_key, seeds), positions)
    return threefry.gumbel(keys, vocab)


def mask_to_support(logits: torch.Tensor, top_ks: torch.Tensor,
                    top_ps: torch.Tensor) -> torch.Tensor:
    """Restrict [B, V] logits to each row's top-k and nucleus support
    (0 / 1.0 disable them); one sort serves both masks."""
    v = logits.shape[-1]
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    k_eff = torch.where((top_ks <= 0) | (top_ks >= v),
                        torch.full_like(top_ks, v), top_ks).long()
    kth = sorted_desc.gather(-1, (k_eff - 1)[:, None])
    keep = logits >= kth
    # Nucleus: the smallest prefix of the sorted distribution whose mass
    # reaches top_p (the first token always stays).
    probs = torch.softmax(sorted_desc, dim=-1)
    cum = probs.cumsum(dim=-1)
    n_keep = ((cum - probs) < top_ps[:, None]).sum(dim=-1).clamp_min(1)
    p_thresh = sorted_desc.gather(-1, (n_keep - 1)[:, None])
    keep &= logits >= p_thresh
    return torch.where(keep, logits, torch.finfo(logits.dtype).min)


def check_device_shapes(module, device: torch.device,
                        paged: bool = True) -> None:
    """On the card, refuse a decoder that a kernel of its path is not
    built for, at construction rather than on its first request: the
    prefill runs the flash kernel (K1), and the paged mode's decode waves
    the paged kernel (K2)."""
    check_kernel_shapes(module, device)
    if paged and device.type == "cuda":
        check_head_dim(module.config.dtype, module.config.head_dim)


@dataclass
class _Sampling:
    """One dispatch's per-row sampling parameters (device tensors) and
    the host's decisions about which device work the rows need."""
    temps: torch.Tensor
    top_ks: torch.Tensor
    top_ps: torch.Tensor
    seeds: torch.Tensor
    any_sampled: bool      # some row has temperature > 0
    need_mask: bool        # ... and some row sets top_k or top_p
    want_lp: bool          # some row asked for logprobs


@dataclass
class _Request:
    prompt_ids: np.ndarray
    max_new_tokens: int
    temperature: float
    top_k: int = 0            # 0 = off
    top_p: float = 1.0        # 1.0 = off
    seed: int = 0             # keys the sampling noise with the position
    logprobs: int = 0         # top-N logprobs per token; 0 = off
    out: asyncio.Queue = field(default_factory=asyncio.Queue)
    cancelled: bool = False
    # Per-token logprob records in emit order: the chosen token's
    # logprob and [(token_id, logprob)] top-N, aligned with content
    # tokens.
    lp_chosen: List[float] = field(default_factory=list)
    lp_top: List[List[Tuple[int, float]]] = field(default_factory=list)
    # The submitting context's budget: once it is spent, the request
    # ends with finish_reason "timeout" at the next wave boundary.
    deadline: Optional[Any] = None
    trace_id: Optional[str] = None
    submit_t: float = 0.0
    last_emit_t: Optional[float] = None
    # -- the cost record, accumulated over the request's whole life
    # (preemptions included) and finalized once at its terminal event.
    # Device ms are the request's even share of each dispatch's busy
    # interval, so the records sum to the engine's device time.
    prefill_device_ms: float = 0.0
    decode_device_ms: float = 0.0
    tokens_out: int = 0
    blocks_held: int = 0          # peak slot-table blocks (paged)
    cache_hit_blocks: int = 0     # prompt blocks served by the index
    cache_saved_tokens: int = 0   # hit blocks x block_size
    # Prompt blocks faulted back from the host KV tier instead of
    # re-prefilled (kept apart from device prefix hits; the two add).
    host_tier_hit_blocks: int = 0
    host_tier_saved_tokens: int = 0
    # Speculative decoding's draft/verify split of decode_device_ms (a
    # breakdown of the same intervals, not additive terms).
    spec_draft_ms: float = 0.0
    spec_verify_ms: float = 0.0


@dataclass
class _Active:
    req: _Request
    length: int          # tokens whose k/v are in the cache
    last_token: int      # the token the next step feeds at `length`
    generated: int
    # Content tokens emitted so far: preemption re-prefills prompt +
    # tokens to resume the stream exactly.
    tokens: List[int] = field(default_factory=list)
    # -- chunked prefill (paged mode, cold prompts) ---------------------
    # A prefilling slot is not decodable yet: decode waves park its feed
    # row on the out-of-range position, so their writes drop, and
    # discard its rows.
    prefilling: bool = False
    chunk_next: int = 0        # next chunk index to dispatch
    chunk_total: int = 0
    chunks_inflight: int = 0   # chunk dispatches not yet fetched
    # Per-block insert destinations of the plan (-1 = prefix hit: a
    # chunk of hits only skips its dispatch).
    chunk_dest: List[int] = field(default_factory=list)
    # block index -> (chain, block): fresh full-block registrations,
    # published when the chunk that writes the block dispatches.
    chunk_regs: Dict[int, Tuple[bytes, int]] = field(default_factory=dict)


@dataclass
class _Fetch:
    """Device results on their way to pinned host memory: ``event``
    fires when the copies are done (None on the CPU, where they are);
    ``draft_event``, in a draft-model speculative wave, when the draft
    program is."""
    host: List[torch.Tensor]
    event: Optional[Any]
    draft_event: Optional[Any] = None
    # A device tensor the copies read (a spill snapshot): held until the
    # event fired, so the allocator cannot hand it out under the copy.
    source: Optional[torch.Tensor] = None


class GenerationEngine:
    """Continuous-batching token generation over one device.

    module: a materialized ``DecoderLM`` (models/decoder.py) on the
        serving device.
    """

    def __init__(self, module, *,
                 max_slots: int = 8,
                 max_seq: int = 512,
                 prefill_buckets: Optional[List[int]] = None,
                 eos_id: Optional[int] = None,
                 steps_per_call: int = 1,
                 pipeline_depth: int = 2,
                 block_size: Optional[int] = None,
                 cache_blocks: Optional[int] = None,
                 prefill_chunk_tokens: Optional[int] = None,
                 adaptive_depth: bool = True,
                 speculative: Optional[Dict[str, Any]] = None,
                 host_tier_blocks: Optional[int] = None,
                 host_tier_dir: Optional[str] = None,
                 rng_seed: int = 0,
                 logprob_topk: int = 5,
                 name: str = "decoder",
                 mesh=None):
        self.module = module
        self.device = next(module.parameters()).device
        # Programs become CUDA graphs on the card, unless the module's
        # forward holds a mesh's collectives.
        self._graphs = self.device.type == "cuda" and mesh is None
        # Rank 0 of a mesh: the followers' command channel
        # (attach_leader).
        self._leader = None
        self.max_slots = int(max_slots)
        self.max_seq = int(max_seq)
        if steps_per_call < 1:
            raise InvalidInput("steps_per_call must be >= 1")
        self.steps_per_call = int(steps_per_call)
        if pipeline_depth < 1:
            raise InvalidInput("pipeline_depth must be >= 1")
        # Decode waves in flight: at depth >= 2 the fetch of wave N
        # overlaps wave N+1 on the device; stop decisions lag the device
        # by up to depth-1 waves (wasted steps are counted).
        self.pipeline_depth = int(pipeline_depth)
        # Adaptive depth: no speculative wave when every live stream
        # finishes within the waves already in flight.
        self.adaptive_depth = bool(adaptive_depth)
        cfg = module.config
        if self.max_seq > cfg.max_seq:
            raise InvalidInput(
                f"engine max_seq {self.max_seq} exceeds the model's "
                f"position table {cfg.max_seq}")
        self.vocab_size = cfg.vocab_size
        # Heads this rank holds: all of them, or its tensor-parallel
        # share (the projections' rows say which).
        heads = module.layers[0].query.weight.shape[0] // cfg.head_dim
        # Under a mesh: whether the ranks split the heads (else every
        # rank holds them all), and whether this rank follows rank 0 (a
        # follower keeps no host tier: the tier and its buffers live on
        # rank 0).
        self._mesh = mesh
        self._heads_sharded = heads != cfg.num_heads
        self._follower = (mesh is not None
                          and torch.distributed.get_rank() != 0)
        self.eos_id = eos_id
        self.name = name
        buckets = sorted(set(prefill_buckets or
                             _pow2_buckets(self.max_seq)))
        if buckets[-1] > self.max_seq:
            raise InvalidInput(
                f"prefill bucket {buckets[-1]} exceeds max_seq "
                f"{self.max_seq}")
        self.prefill_buckets = buckets
        self.rng_seed = int(rng_seed)
        self.logprob_topk = max(1, int(logprob_topk))
        # Default per-request seeds: a deterministic counter.
        self._seed_counter = 0
        S = self.max_slots

        # -- paged vs dense cache ------------------------------------------
        self.block_size = int(block_size) if block_size else None
        if self.block_size is not None:
            bs = self.block_size
            if self.max_seq % bs != 0:
                raise InvalidInput(
                    f"max_seq {self.max_seq} must be a multiple of "
                    f"block_size {bs}")
            for b in buckets:
                if b % bs != 0:
                    raise InvalidInput(
                        f"prefill bucket {b} must be a multiple of "
                        f"block_size {bs} (paged insert writes whole "
                        f"blocks)")
            check_device_shapes(module, self.device)
            self.blocks_per_slot = self.max_seq // bs
            self.num_blocks = int(cache_blocks or
                                  self.max_slots * self.blocks_per_slot)
            self._cache_shape = (self.num_blocks, bs, heads, cfg.head_dim)
            # NB + 1 blocks: the last is the sink no table names.
            alloc_shape = (self.num_blocks + 1,) + self._cache_shape[1:]
        else:
            check_device_shapes(module, self.device, paged=False)
            self.blocks_per_slot = 0
            self.num_blocks = 0
            self._cache_shape = (S, self.max_seq, heads, cfg.head_dim)
            # max_seq + 1 positions: the last is the sink no query reads.
            alloc_shape = (S, self.max_seq + 1, heads, cfg.head_dim)
        self._cache_dtype = cfg.dtype

        # -- chunked prefill (paged mode only) -----------------------------
        self.prefill_chunk_tokens = (int(prefill_chunk_tokens)
                                     if prefill_chunk_tokens else None)
        if self.prefill_chunk_tokens is not None:
            if self.block_size is None:
                raise InvalidInput(
                    "prefill_chunk_tokens requires the paged cache "
                    "(set block_size): chunk state is carried in the "
                    "block table")
            if self.prefill_chunk_tokens % self.block_size != 0:
                raise InvalidInput(
                    f"prefill_chunk_tokens {self.prefill_chunk_tokens} "
                    f"must be a multiple of block_size "
                    f"{self.block_size} (chunks write whole blocks)")
            if self.prefill_chunk_tokens > self.max_seq:
                raise InvalidInput(
                    f"prefill_chunk_tokens {self.prefill_chunk_tokens} "
                    f"exceeds max_seq {self.max_seq}")
            if self.prefill_chunk_tokens > self.prefill_buckets[-1]:
                # Prompts between the two would fit neither path, and a
                # preempted stream whose merged length lands there
                # could never resume.
                raise InvalidInput(
                    f"prefill_chunk_tokens {self.prefill_chunk_tokens} "
                    f"must not exceed the largest prefill bucket "
                    f"{self.prefill_buckets[-1]} (prompts between the "
                    f"two would fit neither the bucketed nor the "
                    f"chunked prefill path)")

        # -- speculative decoding ------------------------------------------
        # {"tokens": K, optional "draft_module" (a materialized decoder on
        # this device) and "draft_window"}; None defers to the
        # KFS_SPECDEC_TOKENS env twin (n-gram proposer only).
        if speculative is None:
            try:
                env_spec = int(os.environ.get("KFS_SPECDEC_TOKENS", "0"))
            except ValueError:
                env_spec = 0
            if env_spec > 0:
                speculative = {"tokens": env_spec}
        self.spec_tokens = 0
        self._draft_module = None
        self._draft_window = 0
        if speculative:
            self.spec_tokens = int(speculative.get("tokens", 0))
            if self.spec_tokens < 0:
                raise InvalidInput("speculative tokens must be >= 0")
            if self.spec_tokens > 0:
                self._draft_module = speculative.get("draft_module")
                if self._draft_module is not None:
                    self._draft_window = int(speculative.get(
                        "draft_window", DEFAULT_DRAFT_WINDOW))
                    # The draft's forwards run the flash kernel on the
                    # card at L = window.
                    check_kernel_shapes(self._draft_module, self.device)
        self._ngram = (NGramProposer(self.spec_tokens)
                       if self.spec_tokens else None)
        self._draft_proposer = (
            make_draft_proposer(self._draft_module, S, self._draft_window,
                                self.spec_tokens)
            if self._draft_module is not None else None)

        MB = self.blocks_per_slot
        with torch.inference_mode():
            self._caches = [
                (torch.zeros(alloc_shape, dtype=cfg.dtype,
                             device=self.device),
                 torch.zeros(alloc_shape, dtype=cfg.dtype,
                             device=self.device))
                for _ in range(cfg.num_layers)]
            # Device feed state: the token each slot feeds next and its
            # position, plus a sink row (index max_slots) that a
            # prefill batch's padding rows, a non-final chunk and a
            # re-sync's kept rows write.  Rows of free slots go stale by
            # design: a garbage decode there writes to the sink and its
            # tokens are dropped at distribute.
            self._feed_tokens = torch.zeros(S + 1, dtype=torch.int32,
                                            device=self.device)
            self._feed_positions = torch.zeros(S + 1, dtype=torch.int32,
                                               device=self.device)
            self._base_key = threefry.prng_key(self.rng_seed,
                                               device=self.device)
            # Each program's static input, one int32 tensor a program
            # (float32 arrays as their bits), filled by one host-to-
            # device copy a dispatch.  The wave: the block table [S, MB]
            # (none in dense mode) and the four sampling arrays [S].
            self._wave_in = self._static_input(S * MB + 4 * S)
            self._wave_table = self._wave_in[:S * MB].view(S, MB)
            self._wave_sampling = self._sampling_views(
                self._wave_in[S * MB:], S)
            if self.prefill_chunk_tokens is not None:
                # A chunk: ids [C], query positions [C], the slot's
                # table row [MB], then the last real query's index, the
                # slot to park, the feed row to write (the slot on the
                # final chunk, else the sink row), the prompt length and
                # the four sampling values.
                C = self.prefill_chunk_tokens
                self._chunk_in = self._static_input(2 * C + MB + 8)
            if self.spec_tokens:
                # A verify: last tokens [S], proposals [S, K], query
                # positions [S, K + 1], the table [S, MB], the sampling
                # arrays; the draft's windows [S, W]; a re-sync's slot
                # rows, tokens and positions [3, S].
                K = self.spec_tokens
                self._spec_in = self._static_input(
                    S + S * K + S * (K + 1) + S * MB + 4 * S)
                self._resync_in = self._static_input(3 * S)
                if self._draft_module is not None:
                    self._draft_in = self._static_input(
                        S * self._draft_window)

        # Compiled programs: key -> (graph, static outputs, kernel launch
        # tally), in one pool, on the engine's stream.
        self._stream = None
        self._pool = None
        self._programs: Dict[tuple, Any] = {}
        self.compile_source = f"generator:{name}:{next(_generator_seq)}"
        self.wave_captures = 0
        self.capture_ms_total = 0.0

        # Host-side paging state, guarded by _block_lock (cancel() on
        # the loop thread races table snapshots on the enqueue thread).
        self._block_lock = threading.Lock()
        self._tables = np.full((S, MB), -1, np.int32)
        self._free_blocks: deque = deque(range(self.num_blocks))
        self._block_ref = np.zeros(self.num_blocks, np.int64)
        # chain digest -> block of a FULL prompt block (prefix reuse);
        # zero-ref registered blocks linger in _reclaimable (LRU) until
        # allocation pressure evicts them.
        self._prefix_index: Dict[bytes, int] = {}
        self._block_chain: Dict[int, bytes] = {}
        self._reclaimable: "OrderedDict[int, None]" = OrderedDict()
        # Hits per live index entry (reuse depth): the /debug/cache
        # census reads it; an entry's count goes with the entry.
        self._chain_hits: Dict[bytes, int] = {}
        # Capacity evictions split by fate: spilled (the chain survives in
        # the host tier) or dropped.
        self.block_evictions: Dict[str, int] = {
            "capacity_dropped": 0, "capacity_spilled": 0,
            "index_invalidation": 0, "zombie_deferral": 0}
        self.prefill_tokens_saved = 0
        # (release_at_decode_step, [block ids]): see
        # _schedule_block_release.
        self._deferred_frees: deque = deque()
        # slot -> provisional prefix registrations of its last plan.
        self._plan_regs: Dict[int, List[Tuple[bytes, int]]] = {}
        self.prefix_hits = 0
        self.prefix_misses = 0

        # -- host KV tier (paged mode only) --------------------------------
        # KFS_KV_TIER_BLOCKS and KFS_KV_TIER_DIR are the env twins.  One
        # block's payload is its k/v in the JAX layout with every head:
        # [layers, (k, v), BS, H, D]; a mesh rank's share of it holds
        # its own heads.
        self.kv_tier: Optional[HostKVTier] = None
        if self.block_size is not None:
            self._local_payload_shape = ((cfg.num_layers, 2)
                                         + tuple(alloc_shape[1:]))
            self._payload_shape = (cfg.num_layers, 2, self.block_size,
                                   cfg.num_heads, cfg.head_dim)
            if host_tier_blocks is None:
                try:
                    host_tier_blocks = int(os.environ.get(
                        "KFS_KV_TIER_BLOCKS", "0"))
                except ValueError:
                    host_tier_blocks = 0
            if host_tier_blocks and int(host_tier_blocks) > 0 \
                    and not self._follower:
                self.kv_tier = HostKVTier(
                    block_bytes=(int(np.prod(self._payload_shape))
                                 * torch.empty((), dtype=cfg.dtype
                                               ).element_size()),
                    capacity_blocks=int(host_tier_blocks),
                    directory=(host_tier_dir
                               or os.environ.get("KFS_KV_TIER_DIR")),
                    model=name)
        # Spills awaiting their gather: (chain, block), appended under
        # _block_lock at eviction and drained on the enqueue thread before
        # any dispatch that could rewrite the block (that thread's FIFO is
        # the stream's order, so the gather reads the evicted bytes).
        self._spill_pending: List[Tuple[bytes, int]] = []
        # Fault-backs awaiting their insert: (chain, block, request,
        # primary); a primary=False row rides a primary's read of the
        # same chain.
        self._faultback_pending: List[Tuple[bytes, int, _Request,
                                            bool]] = []
        # chain -> destination block of a pending fault-back: a second
        # plan in the same admission shares the block (single-flight).
        self._faultback_by_chain: Dict[bytes, int] = {}
        self.host_tier_tokens_saved = 0
        # Fault-back copies to the card in flight: (event, pinned
        # staging buffer), each buffer held until its copy's event.
        self._h2d_inflight: deque = deque()

        # `_executor` waits for fetches (two workers, so a decode wave's
        # tokens never queue behind a prefill's); `_enqueue_executor`
        # owns every device dispatch, so its FIFO is stream order.
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=2, thread_name_prefix=f"generator-{name}")
        self._enqueue_executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"generator-enq-{name}")
        self._slots: List[Optional[_Active]] = [None] * S
        self._pending: deque = deque()
        # Growth starvation: a slot cannot grow while freed blocks are
        # still maturing through the deferral window; the scheduler
        # HOLDS (no admissions, no waves) instead of preempting.
        self._growth_starved = False
        # Start of the current growth-HOLD window (a host-track timeline
        # span once it releases).
        self._hold_since: Optional[float] = None
        self._wakeup: Optional[asyncio.Event] = None
        self._loop_task: Optional[asyncio.Task] = None
        self._closed = False

        # stats
        self.tokens_generated = 0
        self.decode_steps = 0       # decode and spec waves dispatched
        self._token_steps = 0       # waves fetched x steps_per_call
        self.prefills = 0           # prefill dispatches fetched
        self.prefill_requests = 0
        self.requests_finished = 0
        self.preemptions = 0
        self.prefill_chunks = 0     # chunked-prefill dispatches
        self.prefill_chunks_skipped = 0  # whole-chunk prefix hits
        self.chunked_admissions = 0
        self.suppressed_waves = 0
        self._depth_effective = self.pipeline_depth
        # Speculative decoding (engine twins of the specdec families).
        self.spec_waves = 0
        self.spec_proposed_tokens = 0
        self.spec_accepted_tokens = 0
        self.spec_emitted_tokens = 0
        self.spec_fallbacks: Dict[str, int] = {}
        # Bounded accepted-length reservoir for the p50/p99.
        self._spec_lengths: deque = deque(maxlen=4096)
        self._spec_draft_s = 0.0
        self._spec_verify_s = 0.0
        self._occupied_slot_steps = 0
        self._wasted_token_steps = 0
        # Union of enqueue->fetch intervals (overlap-corrected).
        self._decode_device_s = 0.0
        self._last_fetch_done = 0.0
        self._decode_wait_s = 0.0
        self._prefill_wait_s = 0.0
        self._prefill_device_s = 0.0
        # Roofline accounting over live rows: 2 x params matmul FLOPs per
        # token plus attention's 4 x layers x heads x head_dim per
        # resident context position; decode reads the params and every
        # live slot's resident k/v once per token step.
        self._flops_matmul_per_token = 2.0 * sum(
            p.numel() for p in module.parameters())
        self._attn_flops_coeff = (4.0 * cfg.num_layers * heads
                                  * cfg.head_dim)
        self._param_read_bytes = self.param_bytes()
        self._kv_bytes_per_token = (
            2 * cfg.num_layers * heads * cfg.head_dim
            * torch.empty((), dtype=cfg.dtype).element_size())
        self._peak_flops = device_peak_flops(self.device)
        self._peak_hbm_bw = device_peak_hbm_bw(self.device)
        self._decode_flops = 0.0
        self._prefill_flops = 0.0
        self._decode_hbm_bytes = 0.0
        # Per prefill bucket: [real tokens, padded tokens].
        self._prefill_bucket_tokens: Dict[int, List[float]] = {}
        if self.device.type == "cuda":
            # The module and the caches were written on this thread's
            # stream; the engine's own stream starts behind them, and
            # the greedy wave is compiled on the enqueue thread.
            self._stream = torch.cuda.Stream(self.device)
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
            if self._graphs:
                self._pool = torch.cuda.graph_pool_handle()
            self._enqueue_executor.submit(self._warm_greedy_wave).result()

    def _static_input(self, n: int) -> torch.Tensor:
        return torch.zeros(n, dtype=torch.int32, device=self.device)

    @staticmethod
    def _sampling_views(buf: torch.Tensor, n: int) -> tuple:
        """(temps, top_ks, top_ps, seeds) over ``buf``'s first 4 n int32
        values: float32 arrays as their bits."""
        rows = [buf[i * n:(i + 1) * n] for i in range(4)]
        return (rows[0].view(torch.float32), rows[1],
                rows[2].view(torch.float32), rows[3])

    # -- public API --------------------------------------------------------
    def cache_bytes(self) -> int:
        """Bytes of the KV caches: the block pools or the slot rows (the
        sink block or position not counted)."""
        itemsize = torch.empty((), dtype=self._cache_dtype).element_size()
        return (int(np.prod(self._cache_shape)) * itemsize * 2
                * len(self._caches))

    def param_bytes(self) -> int:
        return sum(p.numel() * p.element_size()
                   for p in self.module.parameters())

    async def generate(self, prompt_ids, max_new_tokens: int = 32,
                       temperature: float = 0.0, **sampling
                       ) -> AsyncIterator[Tuple[Optional[int],
                                                Optional[str]]]:
        """Yields (token_id, finish_reason) events: (id, None) for
        intermediate tokens, then (id, 'length') or (None, 'eos').
        Engine failures surface as InferenceError mid-stream."""
        req = self.submit(prompt_ids, max_new_tokens, temperature,
                          **sampling)
        async for event in self.stream(req):
            yield event

    def submit(self, prompt_ids, max_new_tokens: int = 32,
               temperature: float = 0.0, *, top_k: int = 0,
               top_p: float = 1.0, seed: Optional[int] = None,
               logprobs: int = 0) -> _Request:
        """Validate and enqueue a request now (InvalidInput reaches the
        caller before any response bytes are committed).  Pair with
        ``stream()``."""
        if self._closed:
            raise InvalidInput(f"generator {self.name} is closed")
        ids = np.asarray(prompt_ids, np.int64).reshape(-1)
        if ids.size == 0:
            raise InvalidInput("empty prompt")
        chunked = (self.prefill_chunk_tokens is not None
                   and ids.size > self.prefill_chunk_tokens)
        if ids.size > self.prefill_buckets[-1] and not chunked:
            # Cold (chunked) prompts ride no bucket: max_seq bounds
            # them, through the budget below.
            raise InvalidInput(
                f"prompt length {ids.size} exceeds the largest prefill "
                f"bucket {self.prefill_buckets[-1]}")
        if ids.min() < 0 or ids.max() >= self.vocab_size:
            # Checked on the host: an out-of-range embedding index is a
            # device assert on CUDA (XLA clamped it silently).
            raise InvalidInput(
                f"token ids must be in [0, {self.vocab_size})")
        if self.block_size is not None:
            need = -(-int(ids.size) // self.block_size)
            if need > self.num_blocks:
                raise InvalidInput(
                    f"prompt needs {need} cache blocks but the pool "
                    f"holds {self.num_blocks}")
        if max_new_tokens < 1:
            raise InvalidInput("max_new_tokens must be >= 1")
        if not 0.0 < float(top_p) <= 1.0:
            raise InvalidInput("top_p must be in (0, 1]")
        if top_k < 0:
            raise InvalidInput("top_k must be >= 0")
        if logprobs < 0 or logprobs > self.logprob_topk:
            raise InvalidInput(
                f"logprobs must be in [0, {self.logprob_topk}]")
        # Prompt + generated tokens must fit max_seq.
        budget = min(int(max_new_tokens), self.max_seq - int(ids.size))
        if budget < 1:
            raise InvalidInput(
                f"prompt length {ids.size} leaves no room to generate "
                f"within max_seq {self.max_seq}")
        if seed is None:
            seed = self._seed_counter
            self._seed_counter += 1
        req = _Request(ids.astype(np.int32), budget, float(temperature),
                       top_k=int(top_k), top_p=float(top_p),
                       seed=int(seed) & 0x7FFFFFFF,
                       logprobs=int(logprobs),
                       deadline=current_deadline(),
                       trace_id=current_request_id.get(),
                       submit_t=time.perf_counter())
        self._pending.append(req)
        self._ensure_loop()
        return req

    async def stream(self, req: _Request
                     ) -> AsyncIterator[Tuple[Optional[int],
                                              Optional[str]]]:
        while True:
            token, reason = await req.out.get()
            if reason is not None and reason.startswith("error"):
                raise InferenceError(reason)
            yield token, reason
            if reason is not None:
                return

    def cancel(self, req: _Request) -> None:
        """Abandon a request (client disconnect, stop-sequence match):
        frees its slot at the next wave boundary.  Loop thread only;
        idempotent."""
        if req.cancelled:
            return
        req.cancelled = True
        try:
            self._pending.remove(req)
            req.out.put_nowait((None, "cancelled"))
            self._finalize_cost(req, "cancelled")
            self.requests_finished += 1
            return
        except ValueError:
            pass
        for i, s in enumerate(self._slots):
            if s is not None and s.req is req:
                self._free_slot_state(i)
                self.requests_finished += 1
                req.out.put_nowait((None, "cancelled"))
                self._finalize_cost(req, "cancelled")
                return
        # Neither pending nor active: finished already, or mid-enqueue
        # (the install step checks `cancelled`).

    async def complete(self, prompt_ids, max_new_tokens: int = 32,
                       temperature: float = 0.0, **sampling
                       ) -> Tuple[List[int], str]:
        tokens: List[int] = []
        reason = "length"
        async for token, fin in self.generate(prompt_ids, max_new_tokens,
                                              temperature, **sampling):
            if token is not None:
                tokens.append(token)
            if fin is not None:
                reason = fin
        return tokens, reason

    def _ensure_loop(self):
        if self._loop_task is None or self._loop_task.done():
            self._wakeup = asyncio.Event()
            self._loop_task = asyncio.get_running_loop().create_task(
                self._run())
        self._wakeup.set()

    async def close(self):
        self._closed = True
        if self._loop_task is not None:
            if self._wakeup is not None:
                self._wakeup.set()
            try:
                await self._loop_task
            except asyncio.CancelledError:
                pass
        self._executor.shutdown(wait=True)
        self._enqueue_executor.shutdown(wait=True)
        if self.kv_tier is not None:
            self.kv_tier.close()
        self._close_leader()

    def shutdown_nowait(self):
        """Synchronous teardown (unload runs outside async context):
        stop admitting, let the scheduler drain, release the threads
        without joining (under a mesh the enqueue thread is joined: its
        dispatches' collectives finish before the followers stop)."""
        self._closed = True
        if self._wakeup is not None:
            self._wakeup.set()
        self._executor.shutdown(wait=False)
        self._enqueue_executor.shutdown(wait=self._leader is not None)
        if self.kv_tier is not None:
            self.kv_tier.close()
        self._close_leader()

    def _close_leader(self) -> None:
        if self._leader is not None:
            self._leader.close()
            self._leader = None

    def load_gauges(self) -> Dict[str, int]:
        """Occupied slots and queued requests: a generative replica
        saturates by slots, not by request count (the server's drain
        waits for both to reach 0)."""
        return {"active_slots": sum(1 for s in self._slots
                                    if s is not None),
                "pending": len(self._pending),
                "max_slots": self.max_slots}

    def graph_stats(self) -> Dict[str, Any]:
        """The compiled programs: the keys captured (``wave_graphs`` the
        decode waves'), their capture ms and the pool's bytes (kept out
        of ``stats()``, which ``/metrics`` publishes)."""
        keys = sorted(self._programs, key=repr)
        return {"programs": keys,
                "wave_graphs": [k for k in keys if k[0] == "decode"],
                "captures": self.wave_captures,
                "capture_ms_total": self.capture_ms_total,
                "pool_bytes": (graphs.pool_bytes(self._pool, self.device)
                               if self._pool is not None else 0)}

    def stats(self) -> Dict[str, Any]:
        steps = max(1, self._token_steps)
        out = {
            "tokens_generated": self.tokens_generated,
            "decode_steps": self.decode_steps,
            "token_steps": self._token_steps,
            "steps_per_call": self.steps_per_call,
            "prefills": self.prefills,
            "prefill_requests": self.prefill_requests,
            "requests_finished": self.requests_finished,
            "slot_occupancy": round(
                self._occupied_slot_steps / (steps * self.max_slots), 4),
            "max_slots": self.max_slots,
            "max_seq": self.max_seq,
            "pipeline_depth": self.pipeline_depth,
            "adaptive_depth": self.adaptive_depth,
            "depth_effective": self._depth_effective,
            "suppressed_waves": self.suppressed_waves,
            "wasted_token_steps": self._wasted_token_steps,
            "cache_bytes": self.cache_bytes(),
            "decode_device_s": round(self._decode_device_s, 4),
            "decode_wait_s": round(self._decode_wait_s, 4),
            "prefill_wait_s": round(self._prefill_wait_s, 4),
            "prefill_device_s": round(self._prefill_device_s, 4),
        }
        # The roofline block (observability/profiling/roofline.py
        # publishes these keys).  Device seconds are the union of
        # enqueue -> fetch intervals: a floor on utilization.
        if self._decode_flops > 0 and self._decode_device_s > 0:
            achieved = self._decode_flops / self._decode_device_s
            out["achieved_decode_tflops"] = round(achieved / 1e12, 6)
            if self._peak_flops:
                out["decode_mfu"] = round(achieved / self._peak_flops, 6)
        if self._prefill_flops > 0 and self._prefill_device_s > 0:
            achieved = self._prefill_flops / self._prefill_device_s
            out["achieved_prefill_tflops"] = round(achieved / 1e12, 6)
            if self._peak_flops:
                out["prefill_mfu"] = round(achieved / self._peak_flops, 6)
        if self.tokens_generated + self._wasted_token_steps > 0:
            out["goodput_ratio"] = round(
                self.tokens_generated
                / (self.tokens_generated + self._wasted_token_steps), 4)
        if self._decode_hbm_bytes > 0 and self._decode_device_s > 0:
            rate = self._decode_hbm_bytes / self._decode_device_s
            out["decode_hbm_gb_s"] = round(rate / 1e9, 3)
            if self._peak_hbm_bw:
                out["hbm_bw_util"] = round(
                    min(1.0, rate / self._peak_hbm_bw), 6)
        if self._prefill_bucket_tokens:
            out["prefill_bucket_pad_waste"] = {
                f"s{b}": round(1.0 - real / padded, 4)
                for b, (real, padded)
                in sorted(self._prefill_bucket_tokens.copy().items())
                if padded > 0}
        if self.block_size is not None:
            out["paged"] = self._pool_stats()
            if self.kv_tier is not None:
                out["paged"]["host_tier_tokens_saved"] = \
                    self.host_tier_tokens_saved
                out["host_tier"] = self.kv_tier.debug()
            if self.prefill_chunk_tokens is not None:
                out["chunked_prefill"] = {
                    "chunk_tokens": self.prefill_chunk_tokens,
                    "admissions": self.chunked_admissions,
                    "chunks_dispatched": self.prefill_chunks,
                    "chunks_skipped_shared": self.prefill_chunks_skipped,
                }
        if self.spec_tokens:
            out["speculative"] = self.spec_debug()
        return out

    def _pool_stats(self) -> Dict[str, Any]:
        with self._block_lock:
            refd = int(np.sum(self._block_ref > 0))
            resident = sum(s.length for s in self._slots if s is not None)
            # Over per-slot TABLE blocks: a shared prefix block counts
            # once per sharer in both the numerator and denominator.
            table_blocks = int(np.sum(self._tables >= 0))
            frag = (1.0 - resident / (table_blocks * self.block_size)
                    if table_blocks else 0.0)
            return {
                "block_size": self.block_size,
                "pool_blocks": self.num_blocks,
                "free_blocks": len(self._free_blocks),
                "reclaimable_blocks": len(self._reclaimable),
                "prefix_hits": self.prefix_hits,
                "prefix_misses": self.prefix_misses,
                "prefill_tokens_saved": self.prefill_tokens_saved,
                "index_entries": len(self._prefix_index),
                "pool_occupancy_ratio": round(
                    min(1.0, refd / max(1, self.num_blocks)), 4),
                "fragmentation_ratio": round(min(1.0, max(0.0, frag)), 4),
                "evictions": dict(self.block_evictions),
                "preemptions": self.preemptions,
            }

    def spec_debug(self) -> Dict[str, Any]:
        """The speculative-decoding block of ``stats()`` and
        ``/debug/cache``, under the JAX engine's keys."""
        lengths = sorted(self._spec_lengths)

        def lpct(q: float) -> int:
            if not lengths:
                return 0
            return lengths[min(len(lengths) - 1, int(len(lengths) * q))]

        proposed = self.spec_proposed_tokens
        return {
            "tokens": self.spec_tokens,
            "proposer": self._proposer_name(),
            "waves": self.spec_waves,
            "proposed_tokens": proposed,
            "accepted_tokens": self.spec_accepted_tokens,
            "emitted_tokens": self.spec_emitted_tokens,
            "acceptance_rate": (round(
                self.spec_accepted_tokens / proposed, 4)
                if proposed else 0.0),
            "accepted_length_p50": lpct(0.50),
            "accepted_length_p99": lpct(0.99),
            "draft_device_s": round(self._spec_draft_s, 4),
            "verify_device_s": round(self._spec_verify_s, 4),
            "draft_param_bytes": self.draft_param_bytes(),
            "fallbacks": dict(self.spec_fallbacks),
        }

    def _proposer_name(self) -> str:
        return "draft" if self._draft_module is not None else "ngram"

    def cache_debug(self, top_k: int = 10) -> Dict[str, Any]:
        """The engine's ``GET /debug/cache`` block: the prefix index's
        census (entries, reuse-depth distribution, the top-K hot chains
        by hit count) and the pool's state, plus the speculative block;
        a dense engine reports ``{"paged": False}``."""
        if self.block_size is None:
            out: Dict[str, Any] = {"paged": False}
            if self.spec_tokens:
                out["speculative"] = self.spec_debug()
            return out
        with self._block_lock:
            census = {chain: self._chain_hits.get(chain, 0)
                      for chain in self._prefix_index}
        depths = sorted(census.values())

        def pct(q: float) -> int:
            if not depths:
                return 0
            return depths[min(len(depths) - 1, int(len(depths) * q))]

        hot = sorted(census.items(), key=lambda kv: (-kv[1], kv[0]))
        hot = hot[:max(0, int(top_k))]
        out = {
            "paged": True,
            "index_entries": len(census),
            "reuse_depth": {
                "p50": pct(0.50),
                "p99": pct(0.99),
                "max": depths[-1] if depths else 0,
                "mean": (round(sum(depths) / len(depths), 3)
                         if depths else 0.0),
            },
            "hot_chains": [{"chain": chain.hex(), "hits": hits}
                           for chain, hits in hot],
            "pool": self._pool_stats(),
        }
        if self.spec_tokens:
            out["speculative"] = self.spec_debug()
        return out

    def draft_param_bytes(self) -> int:
        """The draft model's parameter bytes (0 with the n-gram head or
        no speculation): what the ledger books for it."""
        if self._draft_module is None:
            return 0
        return sum(p.numel() * p.element_size()
                   for p in self._draft_module.parameters())

    # -- paged-cache bookkeeping (under _block_lock) -----------------------
    def _alloc_block_locked(self) -> Optional[int]:
        if self._free_blocks:
            return self._free_blocks.popleft()
        if self._reclaimable:
            # Evict the LRU zero-ref registered block.
            blk, _ = self._reclaimable.popitem(last=False)
            chain = self._block_chain.pop(blk, None)
            if chain is not None and self._prefix_index.get(chain) == blk:
                self._prefix_index.pop(chain, None)
                self._chain_hits.pop(chain, None)
            # The evicted state's fate: with a tier and a chain it spills
            # (counted spilled or dropped when the tier write resolves),
            # else it drops.
            if self.kv_tier is None or chain is None:
                self._count_evictions_locked("capacity_dropped", 1, blk)
            elif self.kv_tier.contains(chain):
                # Spilled before and faulted back since: already safe.
                self._count_evictions_locked("capacity_spilled", 1, blk)
            else:
                self._spill_pending.append((chain, blk))
            return blk
        return None

    def _count_evictions_locked(self, cause: str, n: int,
                                blk: int = -1) -> None:
        """Count ``n`` evictions of ``cause``; a capacity eviction (of
        block ``blk``) and an index invalidation are ``cache.evict``
        events on the timeline, the zombie deferral's releases are not."""
        if n <= 0:
            return
        self.block_evictions[cause] += n
        obs.generator_block_evictions_total().labels(
            model=self.name, cause=cause).inc(n)
        if cause == "index_invalidation":
            TIMELINE.record("host", "cache.evict",
                            attrs={"cause": cause, "entries": n})
        elif cause != "zombie_deferral":
            TIMELINE.record("host", "cache.evict",
                            attrs={"cause": cause, "block": blk})

    def _ref_block_locked(self, blk: int) -> None:
        self._block_ref[blk] += 1
        self._reclaimable.pop(blk, None)

    def _unref_block_locked(self, blk: int) -> None:
        self._block_ref[blk] -= 1
        if self._block_ref[blk] <= 0:
            self._block_ref[blk] = 0
            if blk in self._block_chain:
                self._reclaimable[blk] = None  # linger for reuse
            else:
                self._free_blocks.append(blk)

    def _free_slot_state(self, i: int) -> None:
        """Free slot i and schedule its blocks' release."""
        self._slots[i] = None
        self._schedule_block_release(i)

    def _deregister_plan(self, slot: int) -> None:
        """Remove a slot's provisional prefix registrations (its prefill
        never enqueued, so the registered blocks hold no data)."""
        with self._block_lock:
            dropped = 0
            for chain, blk in self._plan_regs.pop(slot, []):
                if self._prefix_index.pop(chain, None) is not None:
                    dropped += 1
                    self._chain_hits.pop(chain, None)
                self._block_chain.pop(blk, None)
            self._count_evictions_locked("index_invalidation", dropped)

    def _confirm_plan(self, slot: int) -> None:
        """The slot's prefill is enqueued: its registrations are backed
        by dispatched writes."""
        with self._block_lock:
            self._plan_regs.pop(slot, None)

    def _schedule_block_release(self, slot: int) -> None:
        """Queue a slot's blocks for release, deferred by pipeline_depth
        waves: dispatches already in flight carry the old table and keep
        writing the dead slot's tail blocks, so reallocating those blocks
        inside that window would let a zombie wave corrupt another
        request's cache."""
        with self._block_lock:
            blocks = [int(b) for b in self._tables[slot] if b >= 0]
            self._tables[slot, :] = -1
        if blocks:
            self._deferred_frees.append(
                (self.decode_steps + self.pipeline_depth + 1, blocks))

    def _process_deferred_frees(self, force: bool = False) -> None:
        released = 0
        while self._deferred_frees and (
                force or self._deferred_frees[0][0] <= self.decode_steps):
            _, blocks = self._deferred_frees.popleft()
            released += len(blocks)
            with self._block_lock:
                for blk in blocks:
                    self._unref_block_locked(blk)
        with self._block_lock:
            self._count_evictions_locked("zombie_deferral", released)

    def _plan_prompt_blocks(self, req: _Request, slot: int,
                            chunk_regs: Optional[Dict[int, Tuple[
                                bytes, int]]] = None
                            ) -> Optional[List[int]]:
        """Allocate or share blocks for a prompt (loop thread).  Full
        blocks probe the prefix index by chain digest: causal attention
        makes the k/v of positions [0, m) a pure function of the first m
        tokens.  A device miss probes the host tier: a chain it holds
        gets a fresh block that the fault-back drain fills (dest -1, as
        a hit), or rides a pending fault-back of the same chain.  Returns
        the per-block insert destinations (-1 = its write drops), or
        None when the pool cannot hold the prompt now (the request stays
        pending).

        chunk_regs (a chunked admission): fresh full-block registrations
        land here by block index instead of in the index; the scheduler
        publishes each chunk's when that chunk dispatches (a sharer
        must never read a block no dispatch was enqueued for).  Hits
        (device or host) are then taken only as a prefix of whole
        chunks, never into the final chunk: a chunk writes every
        position it covers, so a chunk mixing shared and fresh blocks
        would rewrite shared ones."""
        bs = self.block_size
        tier = self.kv_tier
        n = int(req.prompt_ids.size)
        full = n // bs
        total = (n + bs - 1) // bs
        dest: List[int] = []
        taken: List[int] = []
        fresh_regs: List[Tuple[bytes, int]] = []
        plan_hits = plan_misses = plan_host_hits = 0
        hit_chains: List[bytes] = []
        depth_obs: List[int] = []
        # (chain, block, primary) fault-backs this plan claims.
        host_faults: List[Tuple[bytes, int, bool]] = []
        chains: List[bytes] = []
        chain = b""
        for c in range(full):
            chain = hashlib.blake2b(
                chain + req.prompt_ids[c * bs:(c + 1) * bs].tobytes(),
                digest_size=16).digest()
            chains.append(chain)
        with self._block_lock:
            max_hit_blocks = None
            if chunk_regs is not None:
                bpc = self.prefill_chunk_tokens // bs
                h = 0
                while h < full and (
                        self._prefix_index.get(chains[h]) is not None
                        or (tier is not None and (
                            chains[h] in self._faultback_by_chain
                            or tier.contains(chains[h])))):
                    h += 1
                n_chunks = -(-n // self.prefill_chunk_tokens)
                max_hit_blocks = min((h // bpc) * bpc,
                                     bpc * (n_chunks - 1))
            for c in range(total):
                host_chain: Optional[bytes] = None
                accept = max_hit_blocks is None or c < max_hit_blocks
                if c < full:
                    hit = self._prefix_index.get(chains[c])
                    if hit is not None and accept:
                        self._ref_block_locked(hit)
                        self._tables[slot, c] = hit
                        taken.append(hit)
                        dest.append(-1)
                        plan_hits += 1
                        hit_chains.append(chains[c])
                        depth = self._chain_hits.get(chains[c], 0) + 1
                        self._chain_hits[chains[c]] = depth
                        depth_obs.append(depth)
                        continue
                    if tier is not None and accept:
                        shared = self._faultback_by_chain.get(chains[c])
                        if shared is not None:
                            # Ride the pending fault-back's block.
                            self._ref_block_locked(shared)
                            self._tables[slot, c] = shared
                            taken.append(shared)
                            dest.append(-1)
                            plan_host_hits += 1
                            host_faults.append((chains[c], shared, False))
                            continue
                        if tier.begin_fault(chains[c]):
                            host_chain = chains[c]
                blk = self._alloc_block_locked()
                if blk is None and host_chain is not None:
                    tier.end_fault(host_chain)
                if blk is None:
                    # Roll back; this plan's fresh registrations were
                    # never written, so a later hit on them would share
                    # unwritten blocks.
                    dropped = 0
                    for ch, b in fresh_regs:
                        if self._prefix_index.pop(ch, None) is not None:
                            dropped += 1
                            self._chain_hits.pop(ch, None)
                        self._block_chain.pop(b, None)
                    self._count_evictions_locked("index_invalidation",
                                                 dropped)
                    for b in taken:
                        self._unref_block_locked(b)
                    # Release this plan's tier claims: the replan probes
                    # the tier from scratch.
                    for ch, _b, primary in host_faults:
                        if primary:
                            tier.end_fault(ch)
                            self._faultback_by_chain.pop(ch, None)
                    # The replan probes these chains again.
                    for ch in hit_chains:
                        d = self._chain_hits.get(ch)
                        if d is not None:
                            if d <= 1:
                                self._chain_hits.pop(ch, None)
                            else:
                                self._chain_hits[ch] = d - 1
                    self._tables[slot, :] = -1
                    self._count_lookups(plan_hits, plan_misses, 0, [],
                                        plan_host_hits)
                    return None
                self._ref_block_locked(blk)
                self._tables[slot, c] = blk
                taken.append(blk)
                if host_chain is not None:
                    # The fault-back drain writes the chain's k/v into
                    # blk before any dispatch of this plan reads it.
                    dest.append(-1)
                    plan_host_hits += 1
                    host_faults.append((host_chain, blk, True))
                    self._faultback_by_chain[host_chain] = blk
                    continue
                dest.append(blk)
                if c < full:
                    # Full prompt blocks become shareable (decode writes
                    # land past the prompt).
                    self.prefix_misses += 1
                    plan_misses += 1
                    if chunk_regs is not None:
                        # A demoted hit keeps the canonical entry.
                        if self._prefix_index.get(chains[c]) is None:
                            chunk_regs[c] = (chains[c], blk)
                    else:
                        # Provisional until the prefill enqueues.
                        self._prefix_index[chains[c]] = blk
                        self._block_chain[blk] = chains[c]
                        fresh_regs.append((chains[c], blk))
            if chunk_regs is None:
                self._plan_regs[slot] = fresh_regs
            # The caller drains these (a tier read and a pool insert on
            # the enqueue thread) before any dispatch of this plan, and
            # rolls the plan back if the drain fails.
            for ch, b, primary in host_faults:
                self._faultback_pending.append((ch, b, req, primary))
            self.prefix_hits += plan_hits
            self.prefill_tokens_saved += plan_hits * bs
        self._count_lookups(plan_hits, plan_misses, plan_hits * bs,
                            depth_obs, plan_host_hits)
        # The plan's cache economics fold into the request's cost record.
        req.blocks_held = max(req.blocks_held, len(dest))
        if plan_hits:
            req.cache_hit_blocks += plan_hits
            req.cache_saved_tokens += plan_hits * bs
            TIMELINE.record("host", "cache.hit", trace_id=req.trace_id,
                            attrs={"blocks": plan_hits,
                                   "tokens_saved": plan_hits * bs})
        return dest

    def _count_lookups(self, hits: int, misses: int, saved: int,
                       depths: List[int], host_hits: int = 0) -> None:
        """One plan's prefix-index probes, the reuse depth each hit
        reached and the prompt tokens its hits saved, into the registry
        families.  Host-tier answers count as ``host_hit``; their saved
        tokens are counted when the fault-back lands."""
        if hits:
            obs.generator_prefix_lookups_total().labels(
                model=self.name, outcome="hit").inc(hits)
            fam = obs.generator_prefix_reuse_depth_hits()
            for depth in depths:
                fam.labels(model=self.name).observe(depth)
        if host_hits:
            obs.generator_prefix_lookups_total().labels(
                model=self.name, outcome="host_hit").inc(host_hits)
        if misses:
            obs.generator_prefix_lookups_total().labels(
                model=self.name, outcome="miss").inc(misses)
        if saved:
            obs.generator_prefill_tokens_saved_total().labels(
                model=self.name).inc(saved)

    def _ensure_block_capacity(self) -> List[int]:
        """Grow decodable slots' tables to cover the positions the next
        pipeline_depth waves (or one spec wave's K + 1 positions) can
        reach.  Returns the slots that could not grow."""
        if self.block_size is None:
            return []
        bs = self.block_size
        horizon = self.steps_per_call * self.pipeline_depth + 1
        if self.spec_tokens:
            horizon = max(horizon, self.spec_tokens + 2)
        failed: List[int] = []
        with self._block_lock:
            for i, s in enumerate(self._slots):
                if s is None or s.prefilling:
                    # A prefilling slot holds its whole prompt's blocks
                    # and decodes nothing yet.
                    continue
                need = min((s.length + horizon + bs - 1) // bs,
                           self.blocks_per_slot)
                cur = int(np.sum(self._tables[i] >= 0))
                grown = cur
                for c in range(cur, need):
                    blk = self._alloc_block_locked()
                    if blk is None:
                        failed.append(i)
                        break
                    self._ref_block_locked(blk)
                    self._tables[i, c] = blk
                    grown = c + 1
                # The table's block count now: the cost record's peak.
                s.req.blocks_held = max(s.req.blocks_held, grown)
        return failed

    # -- host KV tier: spill and fault-back --------------------------------
    # Both ride the enqueue thread, whose FIFO is the engine stream's
    # order: a gather enqueued before an overwriting dispatch reads the
    # evicted bytes whenever its copy completes, and a fault-back insert
    # enqueued before the plan's own dispatches is in the pool before
    # anything reads the block.

    def _drain_spills(self) -> None:
        """Enqueue thread, before any dispatch that could rewrite a
        spill-pending block: gather the pending blocks on the engine's
        stream and queue their copy into pinned memory; the fetch
        executor waits for it and writes the tier (no tier I/O on the
        scheduler loop, no host sync here).  Under a mesh whose ranks
        split the heads the gather collects every rank's heads at rank
        0 through the host (``_collect_heads``), which blocks this
        thread until the blocks are read."""
        if self.kv_tier is None:
            return
        with self._block_lock:
            if not self._spill_pending:
                return
            pending, self._spill_pending = self._spill_pending, []
        for i in range(0, len(pending), TIER_GROUP_BLOCKS):
            grp = pending[i:i + TIER_GROUP_BLOCKS]
            try:
                handle = self._gather_blocks([b for _, b in grp])
            except Exception:
                # Counted as failed spills (drops) by _spill_write.
                logger.exception("kv spill gather failed")
                handle = None
            self._executor.submit(self._spill_write, grp, handle)

    def _gather_blocks(self, blocks: List[int]) -> _Fetch:
        """Enqueue thread: one [N, layers, 2, BS, H, D] snapshot of pool
        blocks (row n: block n's payload in the JAX layout), gathered
        with ``index_select`` over the named blocks on the engine's
        stream, and its copy to pinned host memory behind an event.  The
        snapshot rides the handle until the event fired.  Under a mesh
        whose ranks split the heads, every rank gathers its heads (the
        followers from the ``"gather"`` command) and rank 0 collects
        them into the full payload on the host (``_collect_heads``),
        a synchronous gather that blocks the enqueue thread (the handle
        has no event then); with replicated heads rank 0's own snapshot
        is the payload, copied behind an event as on one device."""
        sharded = self._mesh is not None and self._heads_sharded
        if sharded and self._leader is not None:
            self._leader.send(("gather", blocks))
        with torch.inference_mode(), self._device_scope():
            idx = self._to_device(np.asarray(blocks, np.int64))
            snap = torch.empty((len(blocks),) + self._local_payload_shape,
                               dtype=self._cache_dtype, device=self.device)
            for li, (pk, pv) in enumerate(self._caches):
                snap[:, li, 0] = pk.index_select(0, idx)
                snap[:, li, 1] = pv.index_select(0, idx)
            if sharded:
                return _Fetch([self._collect_heads(snap)], None)
            handle = self._start_fetch([snap])
        handle.source = snap
        return handle

    def _rank_heads(self) -> List[int]:
        """Each global rank's tensor-parallel index: the block of heads
        it holds."""
        from kfserving_tpu_torch.parallel.mesh import MeshConfig, axis_sizes
        from kfserving_tpu_torch.parallel.sharding import rank_coords

        config = MeshConfig(**axis_sizes(self._mesh))
        return [rank_coords(config, r)["tp"]
                for r in range(config.num_devices)]

    def _collect_heads(self, snap: torch.Tensor) -> Optional[torch.Tensor]:
        """Every rank's [N, layers, 2, BS, H / tp, D] snapshot gathered at
        rank 0 and joined on the heads axis in tp order (the blocks of
        ranks with one tp index are copies); None on the other ranks."""
        from kfserving_tpu_torch.parallel.mesh import gather_to_rank0

        parts = gather_to_rank0(snap)
        if parts is None:
            return None
        first = {}
        for part, t in zip(parts, self._rank_heads()):
            first.setdefault(t, part)
        return torch.cat([first[t] for t in sorted(first)], dim=4)

    def _scatter_heads(self, buf: Optional[torch.Tensor],
                       n: int) -> torch.Tensor:
        """Rank 0's staged full payloads [N, layers, 2, BS, H, D] (None on
        the other ranks) -> this rank's heads of them, on its device."""
        from kfserving_tpu_torch.parallel.mesh import scatter_from_rank0

        parts = None
        if buf is not None:
            if self._heads_sharded:
                h = self._local_payload_shape[3]
                parts = [buf[:, :, :, :, t * h:(t + 1) * h].contiguous()
                         for t in self._rank_heads()]
            else:
                parts = [buf] * len(self._rank_heads())
        return scatter_from_rank0(parts, (n,) + self._local_payload_shape,
                                  self._cache_dtype, self.device)

    def _payload_rows(self, handle: _Fetch) -> np.ndarray:
        """Wait for a gather's copy; its rows as [N, block_bytes] uint8
        (bfloat16 as its bit patterns)."""
        with sanitizer.sanctioned_fetch():
            if handle.event is not None:
                handle.event.synchronize()
            handle.source = None
            host = handle.host[0]
            return host.view(torch.uint8).numpy().reshape(
                host.shape[0], -1)

    def _spill_write(self, grp: List[Tuple[bytes, int]],
                     handle: Optional[_Fetch]) -> None:
        """Fetch executor: write each gathered block into the tier.
        Per block transactional: any failure (the ``engine.kv_spill``
        fault site, a full tier, an mmap error) degrades that eviction
        to a drop, and the tier publishes only complete payloads.  The
        eviction's cause lands here: capacity_spilled when the tier
        committed, capacity_dropped otherwise."""
        outcomes: List[Tuple[int, str]] = []
        try:
            if handle is not None:
                if faults.configured(fault_sites.ENGINE_KV_SPILL):
                    faults.inject_sync(fault_sites.ENGINE_KV_SPILL,
                                       key=self.name)
                rows = self._payload_rows(handle)
                for row, (chain, blk) in zip(rows, grp):
                    ok = self.kv_tier.put(chain, row)
                    outcomes.append((blk, "capacity_spilled" if ok
                                     else "capacity_dropped"))
        except FaultInjected:
            pass  # the remaining blocks degrade to drops below
        except Exception:
            logger.exception("kv spill batch failed")
        finally:
            aborted = len(grp) - len(outcomes)
            if aborted:
                self.kv_tier.note_spill_failure(aborted)
                outcomes.extend((blk, "capacity_dropped")
                                for _, blk in grp[len(outcomes):])
            with self._block_lock:
                for blk, cause in outcomes:
                    self._count_evictions_locked(cause, 1, blk)

    def _drain_faultbacks(self) -> bool:
        """Enqueue thread, after planning and before the plans'
        dispatches: read every pending primary fault-back's payload from
        the tier into pinned memory, copy it to the card and write it
        into its pool block in place.  Returns False on any read failure
        (the ``engine.kv_faultback`` fault site, an entry evicted since
        the probe) having dispatched nothing: the failed chains leave the
        tier, and the caller rolls the plans back so the requests
        re-admit as plain re-prefills.  Spills drain first: this
        admission's fresh blocks may be spill-pending evictions."""
        self._drain_spills()
        if self.kv_tier is None:
            return True
        with self._block_lock:
            if not self._faultback_pending:
                return True
            pending, self._faultback_pending = self._faultback_pending, []
        primaries = [(ch, blk) for ch, blk, _r, prim in pending if prim]
        riders = len(pending) - len(primaries)
        t0 = time.perf_counter()
        staged: List[Tuple[torch.Tensor, List[int]]] = []
        try:
            if faults.configured(fault_sites.ENGINE_KV_FAULTBACK):
                faults.inject_sync(fault_sites.ENGINE_KV_FAULTBACK,
                                   key=self.name)
            for i in range(0, len(primaries), TIER_GROUP_BLOCKS):
                grp = primaries[i:i + TIER_GROUP_BLOCKS]
                buf = torch.empty((len(grp),) + self._payload_shape,
                                  dtype=self._cache_dtype,
                                  pin_memory=self.device.type == "cuda")
                rows = buf.view(torch.uint8).numpy().reshape(len(grp), -1)
                for row, (ch, _blk) in zip(rows, grp):
                    self.kv_tier.read_into(ch, row)
                staged.append((buf, [blk for _, blk in grp]))
        except Exception as e:
            # Nothing dispatched, nothing published: the suspect chains
            # leave the tier so the replanned turns miss it.
            if not isinstance(e, (FaultInjected, KeyError)):
                logger.warning("kv fault-back failed: %r", e)
            self.kv_tier.note_fault_failure(len(pending))
            with self._block_lock:
                for ch, _blk in primaries:
                    self._faultback_by_chain.pop(ch, None)
            for ch, _blk in primaries:
                self.kv_tier.drop(ch)
                self.kv_tier.end_fault(ch)
            return False
        with torch.inference_mode(), self._device_scope():
            for buf, blocks in staged:
                self._insert_payloads(buf, blocks)
        elapsed_ms = (time.perf_counter() - t0) * 1000.0
        saved = 0
        with self._block_lock:
            for ch, blk in primaries:
                # The insert is enqueued: the block is ordinary prefix
                # state.  An identical admission may have registered
                # the chain first; its entry stays canonical.
                if self._prefix_index.get(ch) is None:
                    self._prefix_index[ch] = blk
                    self._block_chain[blk] = ch
                self._faultback_by_chain.pop(ch, None)
            for _ch, _blk, req, _prim in pending:
                req.host_tier_hit_blocks += 1
                req.host_tier_saved_tokens += self.block_size
                saved += self.block_size
            self.host_tier_tokens_saved += saved
        for ch, _blk in primaries:
            self.kv_tier.end_fault(ch)
        obs.generator_kv_tier_tokens_saved_total().labels(
            model=self.name).inc(saved)
        self.kv_tier.note_faultback(len(primaries), elapsed_ms)
        if riders:
            self.kv_tier.note_coalesced(riders)
        TIMELINE.record("host", "cache.faultback",
                        attrs={"blocks": len(primaries),
                               "coalesced": riders,
                               "ms": round(elapsed_ms, 3)})
        return True

    def _insert_payloads(self, buf: Optional[torch.Tensor],
                         blocks: List[int]) -> None:
        """Enqueue thread, in the device scope: copy staged payloads [N,
        layers, 2, BS, H, D] to the card on the engine's stream and write
        them into pool blocks ``blocks`` in place (the pools' addresses
        are baked into the captured graphs).  On the card the pinned
        buffer is held until the copy's event fired.  Under a mesh rank
        0 scatters each rank its heads of the payloads (the followers
        run this from the ``"insert"`` command, with no buffer)."""
        if self._mesh is not None:
            if self._leader is not None:
                self._leader.send(("insert", blocks))
            buf = self._scatter_heads(buf, len(blocks))
        dev = (buf.to(self.device, non_blocking=True)
               if self.device.type == "cuda" else buf)
        dest = self._to_device(np.asarray(blocks, np.int64)[:, None])
        for li, (pk, pv) in enumerate(self._caches):
            paged_insert(pk, pv, dev[:, li, 0], dev[:, li, 1], dest)
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
            self._h2d_inflight.append((event, buf))
        while self._h2d_inflight and self._h2d_inflight[0][0].query():
            self._h2d_inflight.popleft()

    # -- durable handoff: drain export and peer import ----------------------
    def export_kv(self, budget_s: float = 2.0) -> Dict[str, int]:
        """Drain export: copy live slots' blocks, then the prefix index's
        chains hottest first, into the host tier within ``budget_s``, so a
        successor process (or a peer pulling ``/kv/chains``) serves the
        returning conversations by fault-back instead of re-prefill.
        Blocking: call it off the event loop.  It runs on the enqueue
        thread, after every dispatch already enqueued.  What the budget
        cannot cover is counted dropped."""
        zeros = {"exported": 0, "skipped": 0, "dropped": 0, "failed": 0}
        if self.block_size is None or self.kv_tier is None:
            return zeros
        deadline = time.monotonic() + max(0.0, float(budget_s))
        try:
            fut = self._enqueue_executor.submit(self._export_kv_worker,
                                                deadline)
        except RuntimeError:
            return zeros  # executor already shut down
        return fut.result()

    def _export_kv_worker(self, deadline: float) -> Dict[str, int]:
        """Enqueue thread: the export.  Candidates in eviction-value
        order (live slots first, whose return is the most certain, then
        registered chains by reuse depth).  Per block transactional; the
        ``engine.kv_export`` fault site fails the whole pass before any
        tier write (every candidate counted failed)."""
        out = {"exported": 0, "skipped": 0, "dropped": 0, "failed": 0}
        t0 = time.perf_counter()
        bs = self.block_size
        cand: List[Tuple[bytes, int]] = []
        seen: set = set()
        with self._block_lock:
            for si, s in enumerate(self._slots):
                if s is None or s.prefilling:
                    continue
                ids = s.req.prompt_ids
                ext = max(0, int(s.length) - int(ids.size))
                # The return visit's prompt extends prompt + output: its
                # plan probes chains over the concatenation.
                allids = (np.concatenate(
                    [ids, np.asarray(s.tokens[:ext], np.int32)])
                    if ext > 0 and s.tokens else ids)
                chain = b""
                for c in range(min(int(s.length), int(allids.size)) // bs):
                    chain = hashlib.blake2b(
                        chain + allids[c * bs:(c + 1) * bs].tobytes(),
                        digest_size=16).digest()
                    blk = int(self._tables[si, c])
                    if blk < 0 or chain in seen:
                        continue
                    seen.add(chain)
                    if self.kv_tier.contains(chain):
                        out["skipped"] += 1
                        continue
                    cand.append((chain, blk))
            hot = sorted(((self._chain_hits.get(ch, 0), ch, blk)
                          for ch, blk in self._prefix_index.items()
                          if ch not in seen),
                         key=lambda t: t[0], reverse=True)
            for _depth, ch, blk in hot:
                seen.add(ch)
                if self.kv_tier.contains(ch):
                    out["skipped"] += 1
                    continue
                cand.append((ch, blk))
        try:
            if cand and faults.configured(fault_sites.ENGINE_KV_EXPORT):
                faults.inject_sync(fault_sites.ENGINE_KV_EXPORT,
                                   key=self.name)
        except FaultInjected:
            out["failed"] = len(cand)
            cand = []
        for i in range(0, len(cand), TIER_GROUP_BLOCKS):
            if time.monotonic() >= deadline:
                # The coldest tail: counted, never stretching the drain.
                out["dropped"] += len(cand) - i
                break
            grp = cand[i:i + TIER_GROUP_BLOCKS]
            try:
                rows = self._payload_rows(
                    self._gather_blocks([b for _, b in grp]))
            except Exception:
                logger.exception("kv export gather failed")
                out["failed"] += len(grp)
                continue
            for row, (chain, _blk) in zip(rows, grp):
                out["exported" if self.kv_tier.put(chain, row)
                    else "failed"] += 1
        elapsed_ms = (time.perf_counter() - t0) * 1000.0
        for outcome, count in out.items():
            if count:
                obs.kv_handoff_exported_blocks_total().labels(
                    model=self.name, outcome=outcome).inc(count)
        obs.kv_handoff_export_ms().labels(model=self.name).observe(
            elapsed_ms)
        TIMELINE.record("host", "kv.export",
                        attrs={**out, "ms": round(elapsed_ms, 3)})
        if any(out.values()):
            logger.info("kv export (%s): exported=%d skipped=%d "
                        "dropped=%d failed=%d in %.1fms", self.name,
                        out["exported"], out["skipped"], out["dropped"],
                        out["failed"], elapsed_ms)
        return out

    def kv_import(self, pairs: List[Tuple[bytes, bytes]]
                  ) -> Dict[str, int]:
        """Admit peer-transferred (chain, payload) pairs into the host
        tier (the ``/kv/reattach`` pull; the server verified each payload
        against its digest header).  Blocking but dispatch-free.  The
        ``engine.kv_import`` fault site rejects the whole batch before
        any tier publication (every pair counted failed)."""
        out = {"imported": 0, "skipped": 0, "failed": 0}
        if self.block_size is None or self.kv_tier is None or not pairs:
            return out
        try:
            if faults.configured(fault_sites.ENGINE_KV_IMPORT):
                faults.inject_sync(fault_sites.ENGINE_KV_IMPORT,
                                   key=self.name)
        except FaultInjected:
            out["failed"] = len(pairs)
            obs.kv_handoff_peer_blocks_total().labels(
                model=self.name, outcome="failed").inc(len(pairs))
            return out
        for chain, payload in pairs:
            if self.kv_tier.contains(chain):
                out["skipped"] += 1
                continue
            out["imported" if self.kv_tier.put(chain, payload)
                else "failed"] += 1
        for outcome, count in out.items():
            if count:
                obs.kv_handoff_peer_blocks_total().labels(
                    model=self.name, outcome=outcome).inc(count)
        TIMELINE.record("host", "kv.import", attrs=dict(out))
        return out

    # -- device programs (enqueue thread) ----------------------------------
    def _device_scope(self):
        """The enqueue thread's device context: the card and the engine's
        stream."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        scope = contextlib.ExitStack()
        scope.enter_context(torch.cuda.device(self.device))
        scope.enter_context(torch.cuda.stream(self._stream))
        return scope

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor without a stream sync (pinned
        staging, non_blocking)."""
        t = self._to_host_staging(arr)
        if self.device.type == "cuda":
            return t.to(self.device, non_blocking=True)
        return t.clone()

    def _stage(self, static: torch.Tensor, host: np.ndarray) -> None:
        """Queue the copy of ``host`` (int32) into a static input."""
        static.copy_(self._to_host_staging(host.astype(np.int32)),
                     non_blocking=True)

    def _kv(self, table: torch.Tensor) -> list:
        """The decoder's per-layer cache argument: (pool_k, pool_v,
        table) 3-tuples in paged mode, the (k, v) slot caches in dense
        mode (which take no table)."""
        if self.block_size is None:
            return self._caches
        return [(pk, pv, table) for pk, pv in self._caches]

    def _start_fetch(self, tensors: List[torch.Tensor]) -> _Fetch:
        """Queue device -> pinned host copies behind an event (on the
        CPU, copies: a static input may be staged again before the
        fetch)."""
        if self.device.type != "cuda":
            return _Fetch([t.clone() for t in tensors], None)
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in tensors]
        for h, t in zip(host, tensors):
            h.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return _Fetch(host, event)

    def _fetch(self, handle: _Fetch):
        """Fetch executor: wait for the copies, return (tokens,
        logprob arrays or None, wait seconds)."""
        t0 = time.perf_counter()
        # The sanctioned generation fetch: device results become host
        # arrays here, on the fetch executor.
        with sanitizer.sanctioned_fetch():
            if handle.event is not None:
                # kfslint: disable=host-sync sanctioned fetch: the fetch
                # executor waits for the copies' event
                handle.event.synchronize()
            arrays = [h.numpy() for h in handle.host]
        lp = tuple(arrays[1:]) if len(arrays) > 1 else None
        return arrays[0], lp, time.perf_counter() - t0

    @staticmethod
    def _sampling_arrays(rows: List[Optional[_Request]], n: int):
        """Host sampling arrays (temps, top_ks, top_ps, seeds) for a
        dispatch of n rows (None rows: padding or free slots, greedy),
        and the (any_sampled, need_mask, want_lp) decisions."""
        temps = np.zeros(n, np.float32)
        top_ks = np.zeros(n, np.int32)
        top_ps = np.ones(n, np.float32)
        seeds = np.zeros(n, np.int32)
        want_lp = False
        for i, r in enumerate(rows):
            if r is None:
                continue
            temps[i], top_ks[i], top_ps[i] = r.temperature, r.top_k, r.top_p
            seeds[i] = r.seed
            want_lp = want_lp or r.logprobs > 0
        sampled = temps > 0
        flags = (bool(sampled.any()),
                 bool(np.any(sampled & ((top_ks > 0) | (top_ps < 1.0)))),
                 want_lp)
        return (temps, top_ks, top_ps, seeds), flags

    @staticmethod
    def _sampling_bits(arrays) -> np.ndarray:
        """The four sampling arrays as one int32 array (floats as their
        bits), in the static inputs' order."""
        temps, top_ks, top_ps, seeds = arrays
        return np.concatenate([temps.view(np.int32), top_ks,
                               top_ps.view(np.int32), seeds])

    def _sampling(self, rows: List[Optional[_Request]], n: int) -> _Sampling:
        """Per-row sampling arrays on the device for a dispatch of n
        rows (None rows: padding or free slots, greedy)."""
        arrays, flags = self._sampling_arrays(rows, n)
        return _Sampling(*(self._to_device(a) for a in arrays), *flags)

    def _sample(self, logits: torch.Tensor, p: _Sampling,
                noise_pos: torch.Tensor) -> torch.Tensor:
        """logits [B, V] float32 -> [B] int32.  The noise is keyed per
        row on (seed, absolute position), never on the slot or wave."""
        greedy = logits.argmax(dim=-1)
        if not p.any_sampled:
            return greedy.to(torch.int32)
        masked = (mask_to_support(logits, p.top_ks, p.top_ps)
                  if p.need_mask else logits)
        noise = sampling_noise(self._base_key, p.seeds, noise_pos,
                               logits.shape[-1])
        scaled = masked / p.temps.clamp_min(1e-6)[:, None]
        sampled = (scaled + noise).argmax(dim=-1)
        return torch.where(p.temps <= 0, greedy, sampled).to(torch.int32)

    def _logprob_of(self, logits: torch.Tensor, chosen: torch.Tensor):
        """Chosen-token logprob and top-N over the unmasked
        distribution."""
        lps = torch.log_softmax(logits, dim=-1)
        chosen_lp = lps.gather(-1, chosen.long()[:, None])[:, 0]
        top_lps, top_ids = torch.topk(lps, self.logprob_topk, dim=-1)
        return chosen_lp, top_ids.to(torch.int32), top_lps

    def _run_program(self, key: tuple, fn) -> List[torch.Tensor]:
        """Enqueue thread: run program ``key`` (``fn`` over its static
        inputs) from its graph on the card, captured at its first
        dispatch, which runs eagerly; eagerly on the CPU.  Returns the
        program's outputs."""
        if not self._graphs:
            return fn()
        program = self._programs.get(key)
        if program is None:
            return self._compile_program(key, fn)
        graph, outputs, tally = program
        graphs.replay(graph, tally)
        return outputs

    def _compile_program(self, key: tuple, fn) -> List[torch.Tensor]:
        """The first dispatch of a program: run it eagerly (its results
        are this dispatch's), then capture the same program into a
        graph whose outputs are static.  Returns the eager outputs."""
        out = fn()
        t0 = time.perf_counter()
        graph, outputs, tally = graphs.capture(fn, self._stream,
                                               self._pool)
        self._programs[key] = (graph, outputs, tally)
        self.wave_captures += 1
        self.capture_ms_total += (time.perf_counter() - t0) * 1e3
        compile_cache.note_compilation(self.compile_source, key)
        return out

    def _enqueue_wave(self):
        """Dispatch one decode wave of steps_per_call steps over every
        slot; the feed arrays carry the last step's tokens/positions to
        the next wave on the device.  Prefilling slots are None in the
        snapshot: the wave decodes their parked rows, whose writes drop
        and whose tokens are discarded."""
        # Slot growth for this wave may have evicted spill-pending
        # blocks the wave writes: gather first.
        self._drain_spills()
        S = self.max_slots
        snapshot = [None if (s is not None and s.prefilling) else s
                    for s in self._slots]
        with self._block_lock:
            table_h = self._tables.copy()
        arrays, flags = self._sampling_arrays(
            [None if s is None else s.req for s in self._slots], S)
        with torch.inference_mode(), self._device_scope():
            handle = self._start_fetch(self._run_wave(table_h, arrays,
                                                      flags))
        self.decode_steps += 1
        return handle, snapshot, time.perf_counter()

    def _wave_key(self, flags) -> tuple:
        return ("decode", self.max_slots, self.steps_per_call) + tuple(flags)

    def _run_wave(self, table: np.ndarray, arrays, flags) -> List[
            torch.Tensor]:
        """Enqueue thread: stage the wave's table and sampling arrays
        into the static input and run the wave.  Returns its outputs."""
        if self._leader is not None:
            self._leader.send(("wave", table, arrays, flags))
        p = self._stage_wave(table, arrays, flags)
        return self._run_program(self._wave_key(flags), lambda: self._wave(p))

    def _stage_wave(self, table: np.ndarray, arrays, flags) -> _Sampling:
        """Queue the copy of a wave's table and sampling arrays into the
        static input; returns the wave's sampling view of it."""
        self._stage(self._wave_in, np.concatenate([
            table.astype(np.int32).ravel(), self._sampling_bits(arrays)]))
        return _Sampling(*self._wave_sampling, *flags)

    def _to_host_staging(self, arr: np.ndarray) -> torch.Tensor:
        """A host tensor to copy from without a stream sync: pinned on
        the card's side."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        return t.pin_memory() if self.device.type == "cuda" else t

    def _wave(self, p: _Sampling) -> List[torch.Tensor]:
        """The wave's device program over the static inputs: the decode
        steps, then their last tokens and positions written back into
        the feed arrays."""
        S = self.max_slots
        out, tokens, positions = self._decode_steps(
            self._wave_table, self._feed_tokens[:S],
            self._feed_positions[:S], p)
        self._feed_tokens[:S] = tokens
        self._feed_positions[:S] = positions
        return out

    def _warm_greedy_wave(self) -> None:
        """Enqueue thread, at engine start: compile the greedy wave.  No
        slot is live, so its eager run decodes the free rows, which
        write only the sink."""
        S = self.max_slots
        table = np.full((S, self.blocks_per_slot), -1, np.int32)
        arrays, flags = self._sampling_arrays([None] * S, S)
        with torch.inference_mode(), self._device_scope():
            self._run_wave(table, arrays, flags)

    def _decode_steps(self, table: torch.Tensor, tokens: torch.Tensor,
                      positions: torch.Tensor, p: _Sampling):
        """The wave's device program: steps_per_call decode steps, each
        feeding the last one's tokens.  Returns ([tokens [S, K], then
        the logprob arrays when asked], last tokens, next positions)."""
        toks, lps = [], []
        kv = self._kv(table)
        for _ in range(self.steps_per_call):
            logits, _ = self.module(tokens[:, None], positions=positions,
                                    kv_cache=kv)
            lg = logits[:, 0]
            # The sampled token extends a prefix of positions + 1
            # tokens: the noise index prefill and decode agree on.
            nxt = self._sample(lg, p, positions + 1)
            if p.want_lp:
                lps.append(self._logprob_of(lg, nxt))
            toks.append(nxt)
            tokens, positions = nxt, positions + 1
        out = [torch.stack(toks, dim=1)]
        if p.want_lp:
            out += [torch.stack(x, dim=1) for x in zip(*lps)]
        return out, tokens, positions

    def _enqueue_prefill_group(self, group: List[_Request],
                               slots: List[int], bucket: int,
                               dest_rows: Optional[List[List[int]]]
                               ) -> _Fetch:
        """Dispatch one bucket-padded prefill for the group, insert its
        k/v into the pool blocks (paged) or the group's slot rows
        (dense), and its first tokens into the feed arrays; no host
        sync.  Rows pad to a power of two (padding rows: length 1, feed
        row = the sink row, every write dropped)."""
        self._drain_spills()
        b = len(group)
        b_bucket = 1
        while b_bucket < b:
            b_bucket *= 2
        ids = np.zeros((b_bucket, bucket), np.int32)
        lengths = np.ones(b_bucket, np.int32)
        slot_arr = np.full(b_bucket, self.max_slots, np.int64)
        for i, (req, slot) in enumerate(zip(group, slots)):
            n = req.prompt_ids.size
            ids[i, :n] = req.prompt_ids
            lengths[i] = n
            slot_arr[i] = slot
            # Real-token FLOPs: matmuls plus causal attention's
            # triangular sum; padding burns device time without them.
            self._prefill_flops += (self._flops_matmul_per_token * n
                                    + self._attn_flops_coeff * n * (n + 1)
                                    / 2.0)
        rec = self._prefill_bucket_tokens.setdefault(bucket, [0.0, 0.0])
        rec[0] += float(lengths[:b].sum())
        rec[1] += b_bucket * bucket
        dest = None
        if dest_rows is not None:
            dest = np.full((b_bucket, bucket // self.block_size), -1,
                           np.int64)
            for i, row in enumerate(dest_rows):
                dest[i, :len(row)] = row
        arrays, flags = self._sampling_arrays(
            list(group) + [None] * (b_bucket - b), b_bucket)
        with torch.inference_mode(), self._device_scope():
            return self._start_fetch(self._prefill_program(
                ids, lengths, slot_arr, dest, arrays, flags, b))

    def _prefill_program(self, ids: np.ndarray, lengths: np.ndarray,
                         slot_arr: np.ndarray, dest: Optional[np.ndarray],
                         arrays, flags, b: int) -> List[torch.Tensor]:
        """The prefill's device work from its host arrays: the forward,
        the k/v into the pool blocks ``dest`` (paged) or the first ``b``
        rows' slots (dense), the first tokens and lengths into the feed
        arrays.  Returns the tokens (and logprob arrays when asked)."""
        if self._leader is not None:
            self._leader.send(("prefill", ids, lengths, slot_arr, dest,
                               arrays, flags, b))
        bucket = ids.shape[1]
        p = _Sampling(*(self._to_device(a) for a in arrays), *flags)
        ids_d, lengths_d = self._to_device(ids), self._to_device(lengths)
        logits, caches = self.module(ids_d, kv_lengths=lengths_d,
                                     return_cache=True,
                                     logit_positions=lengths_d - 1)
        last = logits[:, 0]
        firsts = self._sample(last, p, lengths_d)
        slot_d = self._to_device(slot_arr)
        if dest is not None:
            dest_d = self._to_device(dest)
            for (pk, pv), (k, v) in zip(self._caches, caches):
                paged_insert(pk, pv, k, v, dest_d)
        else:
            # Dense: the real rows into their slots' first `bucket`
            # positions (the padding rows are not written).
            rows = slot_d[:b]
            for (kc, vc), (k, v) in zip(self._caches, caches):
                kc[rows, :bucket] = k[:b].to(kc.dtype)
                vc[rows, :bucket] = v[:b].to(vc.dtype)
        del caches
        self._feed_tokens[slot_d] = firsts
        self._feed_positions[slot_d] = lengths_d
        out = [firsts]
        if p.want_lp:
            out += list(self._logprob_of(last, firsts))
        return out

    # -- meshes -------------------------------------------------------------
    def attach_leader(self, leader) -> None:
        """Rank 0 of a mesh: send each device operation to the other
        ranks from now on (after construction, whose greedy wave every
        rank's engine runs for itself)."""
        self._leader = leader

    def mirror(self, command: tuple) -> None:
        """A follower rank: run a device operation rank 0 dispatched,
        from the same host inputs; its outputs stay here.  Rank 0 sends
        every one from its enqueue thread, so the commands arrive in its
        dispatch order: a decode wave, a prefill bucket, a chunk, a
        spec wave (the verify, with rank 0's draft proposals), a feed
        re-sync, a tier gather (a spill or an export) or a fault-back
        insert."""
        kind, args = command[0], command[1:]
        run = {"wave": self._run_wave, "prefill": self._prefill_program,
               "chunk": self._run_chunk,
               "spec": lambda host, drafted, flags: self._run_spec(
                   host, None, flags, drafted),
               "resync": self._run_resync, "gather": self._gather_blocks,
               "insert": lambda blocks: self._insert_payloads(None, blocks),
               }.get(kind)
        if run is None:
            raise ValueError(f"unknown generator command {kind!r}")
        with torch.inference_mode(), self._device_scope():
            run(*args)

    # -- chunked prefill (device side) --------------------------------------
    def _enqueue_chunk(self, slot: int, act: _Active, idx: int,
                       final: bool) -> _Fetch:
        """Enqueue thread: dispatch chunk ``idx`` of a cold prompt.  The
        program parks the slot's feed row (decode waves' writes for it
        must drop until its first token exists), writes the chunk's k/v
        through the slot's table row, attends per query over the pool,
        and samples at the chunk's last real query; the final chunk's
        token and the prompt length land in the slot's feed row, so the
        next wave decodes the slot without a host round trip.  The table
        row is cut to the blocks chunks 0..idx cover (one program per
        chunk index, as the JAX engine's)."""
        self._drain_spills()
        req = act.req
        C = self.prefill_chunk_tokens
        MB = self.blocks_per_slot
        n = int(req.prompt_ids.size)
        start = idx * C
        end = min(start + C, n)
        width = end - start
        # This chunk's queries attend the resident prefix up to their own
        # positions: the monolithic path's triangular term, per chunk.
        self._prefill_flops += (
            self._flops_matmul_per_token * width
            + self._attn_flops_coeff * width * (start + end) / 2.0)
        nb = min((idx + 1) * (C // self.block_size), MB)
        with self._block_lock:
            row = self._tables[slot].copy()
        host = np.zeros(2 * C + MB + 8, np.int32)
        host[:width] = req.prompt_ids[start:end]
        # Padding queries of a partial final chunk park on the
        # out-of-range position: their writes drop.
        host[C:2 * C] = self.max_seq
        host[C:C + width] = np.arange(start, end, dtype=np.int32)
        host[2 * C:2 * C + MB] = row
        tail = 2 * C + MB
        host[tail:tail + 4] = (max(width - 1, 0), slot,
                               slot if final else self.max_slots, n)
        arrays, flags = self._sampling_arrays([req], 1)
        host[tail + 4:] = self._sampling_bits(arrays)
        with torch.inference_mode(), self._device_scope():
            return self._start_fetch(self._run_chunk(host, nb, flags))

    def _run_chunk(self, host: np.ndarray, nb: int, flags
                   ) -> List[torch.Tensor]:
        """Enqueue thread: stage a chunk's host inputs into its static
        input and run the chunk program over ``nb`` table blocks."""
        if self._leader is not None:
            self._leader.send(("chunk", host, nb, flags))
        self._stage(self._chunk_in, host)
        tail = 2 * self.prefill_chunk_tokens + self.blocks_per_slot
        p = _Sampling(*self._sampling_views(self._chunk_in[tail + 4:], 1),
                      *flags)
        return self._run_program(("chunk", nb) + flags,
                                 lambda: self._chunk_program(nb, p))

    def _chunk_program(self, nb: int, p: _Sampling) -> List[torch.Tensor]:
        C = self.prefill_chunk_tokens
        MB = self.blocks_per_slot
        ci = self._chunk_in
        ids = ci[:C].view(1, C)
        qpos = ci[C:2 * C].view(1, C)
        row = ci[2 * C:2 * C + MB].view(1, MB)[:, :nb]
        tail = 2 * C + MB
        last_idx, park, feed, length = (ci[tail + i:tail + i + 1]
                                        for i in range(4))
        park, feed = park.long(), feed.long()
        self._feed_tokens.index_fill_(0, park, 0)
        self._feed_positions.index_fill_(0, park, self.max_seq)
        logits, _ = self.module(ids, positions=qpos, kv_cache=self._kv(row),
                                logit_positions=last_idx)
        lg = logits[:, 0]
        # Noise keyed on the full prompt length: the monolithic prefill's
        # first-token draw.
        first = self._sample(lg, p, length)
        self._feed_tokens[feed] = first
        self._feed_positions[feed] = length
        out = [first]
        if p.want_lp:
            out += list(self._logprob_of(lg, first))
        return out

    # -- speculative decoding (device side) ---------------------------------
    def _spec_views(self):
        """(last [S], proposals [S, K], query positions [S, K + 1],
        table [S, MB], sampling) views of the verify's static input."""
        S, K, MB = self.max_slots, self.spec_tokens, self.blocks_per_slot
        si = self._spec_in
        o1, o2 = S, S + S * K
        o3 = o2 + S * (K + 1)
        o4 = o3 + S * MB
        return (si[:o1], si[o1:o2].view(S, K), si[o2:o3].view(S, K + 1),
                si[o3:o4].view(S, MB), self._sampling_views(si[o4:], S))

    def _enqueue_spec_wave(self, eligible, ngram: Optional[np.ndarray],
                           windows: Optional[np.ndarray],
                           host_draft_ms: float):
        """Enqueue thread: stage the verify (and the draft's windows),
        run the draft program when a draft model proposes (it writes its
        proposals into the verify's input on the card: no host round
        trip between them) and the K + 1-position verify.  Rows not in
        ``eligible`` park on the max_seq position: their writes drop and
        their samples are discarded."""
        self._drain_spills()
        S, K = self.max_slots, self.spec_tokens
        last = np.zeros(S, np.int32)
        qpos = np.full((S, K + 1), self.max_seq, np.int32)
        for i, s in eligible:
            last[i] = s.last_token
            qpos[i] = s.length + np.arange(K + 1, dtype=np.int32)
        with self._block_lock:
            table = self._tables.copy()
        arrays, flags = self._sampling_arrays(
            [None if s is None else s.req for s in self._slots], S)
        draft = ngram if ngram is not None else np.zeros((S, K), np.int32)
        host = np.concatenate([last, draft.ravel(), qpos.ravel(),
                               table.ravel(), self._sampling_bits(arrays)])
        with torch.inference_mode(), self._device_scope():
            out, draft_event = self._run_spec(host, windows, flags)
            handle = self._start_fetch(out)
        handle.draft_event = draft_event
        self.decode_steps += 1
        self.spec_waves += 1
        return handle, (list(eligible), host_draft_ms), time.perf_counter()

    def _run_spec(self, host: np.ndarray, windows: Optional[np.ndarray],
                  flags, drafted: bool = False
                  ) -> Tuple[List[torch.Tensor], Optional[Any]]:
        """Enqueue thread: stage a spec wave's verify input (and the
        draft's windows), run the draft program when a draft model
        proposes, then the verify.  Under a mesh rank 0 alone holds the
        draft: its proposals are broadcast into every rank's verify
        input (``drafted``: a follower's wave whose proposals rank 0's
        draft makes).  Returns the verify's outputs and, on the card,
        the draft's event (None otherwise)."""
        drafted = drafted or windows is not None
        if self._leader is not None:
            self._leader.send(("spec", host, drafted, flags))
        S, K = self.max_slots, self.spec_tokens
        draft_event = None
        self._stage(self._spec_in, host)
        if windows is not None:
            self._stage(self._draft_in, windows.ravel())
            self._run_program(("spec_draft", S, self._draft_window),
                              self._draft_program)
            if self.device.type == "cuda":
                draft_event = torch.cuda.Event()
                draft_event.record()
        if drafted and self._mesh is not None:
            from kfserving_tpu_torch.parallel.mesh import (
                broadcast_from_rank0)

            broadcast_from_rank0(self._spec_views()[1])
        p = _Sampling(*self._spec_views()[4], *flags)
        out = self._run_program(("spec_verify", S, K + 1) + flags,
                                lambda: self._verify_program(p))
        return out, draft_event

    def _draft_program(self) -> List[torch.Tensor]:
        S, W = self.max_slots, self._draft_window
        proposals = self._draft_proposer(self._draft_in.view(S, W))
        self._spec_views()[1].copy_(proposals)
        return [proposals]

    def _verify_program(self, p: _Sampling) -> List[torch.Tensor]:
        """Row i feeds [last token, proposals] at positions [L, L + K];
        the head runs at all K + 1 positions, and position j's draw uses
        the noise a sequential decode would use there, (seed, position +
        1).  The forward is the decoder's stepwise mode: the JAX verify
        is one Lq = K + 1 forward, whose logits equal a sequential
        decode's only where products round alike at every shape; on the
        card they do not (a bf16 product at M = S(K + 1) and one at
        M = S differ in the last bit, and a greedy stream forks at the
        next near-tie), so each position runs at the decode step's
        shapes, through the paged kernel.  No cache rollback: the host's
        length advances only over accepted positions, and later writes
        replace the rest before any query reads them."""
        S, K = self.max_slots, self.spec_tokens
        last, draft, qpos, table, _ = self._spec_views()
        tokens = torch.cat([last[:, None], draft], dim=1)
        logits, _ = self.module(tokens, positions=qpos,
                                kv_cache=self._kv(table), stepwise=True)
        flat = logits.reshape(S * (K + 1), -1)
        rep = [a.repeat_interleave(K + 1)
               for a in (p.temps, p.top_ks, p.top_ps, p.seeds)]
        samples = self._sample(flat, _Sampling(*rep, p.any_sampled,
                                               p.need_mask, p.want_lp),
                               (qpos + 1).reshape(-1))
        out = [samples.view(S, K + 1), draft]
        if p.want_lp:
            chosen, ids, lps = self._logprob_of(flat, samples)
            out += [chosen.view(S, K + 1), ids.view(S, K + 1, -1),
                    lps.view(S, K + 1, -1)]
        return out

    def _fetch_spec(self, handle: _Fetch):
        """Fetch executor: join a spec wave.  The draft's event first:
        its time splits the wave's busy interval into draft and
        verify."""
        t0 = time.perf_counter()
        draft_ready_s = 0.0
        with sanitizer.sanctioned_fetch():
            if handle.draft_event is not None:
                # kfslint: disable=host-sync sanctioned fetch: the fetch
                # executor waits for the copies' event
                handle.draft_event.synchronize()
                draft_ready_s = time.perf_counter() - t0
            if handle.event is not None:
                # kfslint: disable=host-sync sanctioned fetch: the fetch
                # executor waits for the copies' event
                handle.event.synchronize()
            arrays = [h.numpy() for h in handle.host]
        lp = tuple(arrays[2:]) if len(arrays) > 2 else None
        return ((arrays[0], arrays[1], draft_ready_s), lp,
                time.perf_counter() - t0)

    def _enqueue_resynced_wave(self):
        """Enqueue thread: write the device feed rows from host slot
        state, then dispatch a plain decode wave.  Spec waves are
        host-fed and leave the device feed behind; rows whose first
        token is still in the FIFO (last_token < 0) keep the values the
        prefill wrote, and parked or free rows their stale ones."""
        S = self.max_slots
        host = np.zeros((3, S), np.int32)
        host[0] = S      # the sink row: keep
        for i, s in enumerate(self._slots):
            if s is not None and not s.prefilling and s.last_token >= 0:
                host[:, i] = (i, s.last_token, s.length)
        with torch.inference_mode(), self._device_scope():
            self._run_resync(host.ravel())
        return self._enqueue_wave()

    def _run_resync(self, host: np.ndarray) -> None:
        """Enqueue thread: stage a re-sync's rows, tokens and positions
        and write them into the device feed."""
        if self._leader is not None:
            self._leader.send(("resync", host))
        self._stage(self._resync_in, host)
        self._run_program(("feed_resync", self.max_slots),
                          self._resync_program)

    def _resync_program(self) -> List[torch.Tensor]:
        S = self.max_slots
        rows = self._resync_in[:S].long()
        self._feed_tokens[rows] = self._resync_in[S:2 * S]
        self._feed_positions[rows] = self._resync_in[2 * S:]
        return []

    # -- scheduler ---------------------------------------------------------
    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self._slots):
            if s is None:
                return i
        return None

    async def _run(self):
        try:
            await self._run_inner()
        except Exception as e:  # a device failure: global
            logger.exception("generation scheduler failed")
            self._fail_all(f"error: generation failed: {e}")
        finally:
            if self._closed:
                self._fail_all("error: generator closed")

    def _expire_deadlines(self) -> None:
        """Between decode waves: requests whose budget ran out get a
        terminal "timeout" event and free their slot (active) or leave
        the queue (pending); no further wave is spent on them."""
        for i, s in enumerate(self._slots):
            if s is not None and s.req.deadline is not None \
                    and s.req.deadline.expired:
                s.req.out.put_nowait((None, "timeout"))
                self._record_finish_span(s.req, s.generated, "timeout")
                self._finalize_cost(s.req, "timeout")
                self._free_slot_state(i)
                self.requests_finished += 1
        if any(r.deadline is not None and r.deadline.expired
               for r in self._pending):
            keep = deque()
            while self._pending:
                r = self._pending.popleft()
                if r.deadline is not None and r.deadline.expired:
                    r.out.put_nowait((None, "timeout"))
                    self._record_finish_span(r, 0, "timeout")
                    self._finalize_cost(r, "timeout")
                    self.requests_finished += 1
                else:
                    keep.append(r)
            self._pending = keep

    @staticmethod
    def _record_finish_span(req: _Request, tokens: int,
                            finished: str) -> None:
        """One `generator.generate` span per finished generation, on
        every terminal path (eos, length and timeout)."""
        if req.trace_id is None:
            return
        duration_s = max(0.0, time.perf_counter() - req.submit_t)
        tracer.record(Span(
            req.trace_id, "generator.generate",
            time.time() - duration_s, duration_s * 1000.0,
            {"tokens": tokens, "finish_reason": finished}))

    def _finalize_cost(self, req: _Request, finished: str) -> None:
        """Fold the request's accumulated accounting into its one cost
        record (device ms by phase, prefill and decode tokens, peak
        blocks held, cache-saved tokens).  Every terminal path calls
        this: eos and length, timeout and cancel."""
        device_ms = {"prefill": round(req.prefill_device_ms, 3),
                     "decode": round(req.decode_device_ms, 3)}
        if self.spec_tokens:
            # Draft and verify refine the decode figure; prefill +
            # decode still sums to the engine's device time.
            device_ms["spec_draft"] = round(req.spec_draft_ms, 3)
            device_ms["spec_verify"] = round(req.spec_verify_ms, 3)
        attribution.observe(self.name, req.trace_id, {
            "trace_id": req.trace_id,
            "finish_reason": finished,
            "device_ms": device_ms,
            "prefill_tokens": int(req.prompt_ids.size),
            "decode_tokens": req.tokens_out,
            "blocks_held": req.blocks_held,
            "cache_hit_blocks": req.cache_hit_blocks,
            "cache_saved_tokens": req.cache_saved_tokens,
            "host_tier_hit_blocks": req.host_tier_hit_blocks,
            "host_tier_saved_tokens": req.host_tier_saved_tokens,
        })

    def _fail_all(self, reason: str):
        for i, s in enumerate(self._slots):
            if s is not None:
                s.req.out.put_nowait((None, reason))
                self._free_slot_state(i)
        while self._pending:
            self._pending.popleft().out.put_nowait((None, reason))

    def _bucket_for(self, n: int) -> int:
        return next(b for b in self.prefill_buckets if b >= n)

    def _take_prefill_group(self):
        """Pop the front run of pending (not cold) requests that share a
        prefill bucket, up to the free slot count, planning each one's
        blocks in paged mode; strict FIFO.  A request the pool cannot
        hold yet stays pending.  Returns (group, slots, bucket,
        dest_rows), dest_rows None in dense mode."""
        free = [i for i, s in enumerate(self._slots) if s is None]
        group: List[_Request] = []
        bucket = 0
        dest_rows: Optional[List[List[int]]] = (
            [] if self.block_size is not None else None)
        while self._pending and len(group) < len(free):
            if self._is_cold(self._pending[0]):
                break  # cold prompts take the chunked path
            b = self._bucket_for(self._pending[0].prompt_ids.size)
            if not group:
                bucket = b
            elif b != bucket:
                break
            if dest_rows is not None:
                plan = self._plan_prompt_blocks(self._pending[0],
                                                free[len(group)])
                if plan is None:
                    break  # pool pressure: wait for released blocks
                dest_rows.append(plan)
            group.append(self._pending.popleft())
        return group, free[:len(group)], bucket, dest_rows

    async def _run_inner(self):
        loop = asyncio.get_running_loop()
        # Decode waves, spec waves, prefill groups and chunks share one
        # FIFO of dispatched, unfetched work: (kind, fetch future, meta,
        # t0).
        inflight: deque = deque()
        try:
            # KFS_SANITIZE=1: the transfer guard covers this (the loop's)
            # thread while the pipeline runs; the fetches run on executor
            # threads it never covers.  Off, one env read.
            with sanitizer.loop_guard(self.name, self.device.type):
                await self._run_pipeline(loop, inflight)
        finally:
            for item in inflight:
                item[1].add_done_callback(
                    lambda f: f.cancelled() or f.exception())

    async def _admit(self, loop, inflight: deque) -> bool:
        """Admit pending requests while slots (and blocks) allow: a cold
        prompt at the front takes the chunked path, the rest ride
        bucketed prefill groups."""
        admitted = False
        while (not self._growth_starved and self._pending
               and self._free_slot() is not None):
            if self._is_cold(self._pending[0]):
                if not await self._admit_chunked(loop, inflight):
                    break  # pool pressure: wait for frees
                admitted = True
                continue
            group, slots, bucket, dest_rows = self._take_prefill_group()
            if not group:
                break  # pool pressure: wait for frees
            if not await self._land_faultbacks(loop):
                # Nothing was dispatched: roll the group's plans back and
                # re-queue it at the front; the replans miss the tier
                # (the failed chains were dropped) and re-prefill.
                for slot in slots:
                    self._deregister_plan(slot)
                    self._schedule_block_release(slot)
                self._pending.extendleft(reversed(group))
                continue
            try:
                handle = await loop.run_in_executor(
                    self._enqueue_executor, self._enqueue_prefill_group,
                    group, slots, bucket, dest_rows)
            except Exception as e:
                # Fails THAT group; live slots keep decoding.  Planned
                # blocks release and their registrations go.
                logger.exception("prefill enqueue failed")
                for req, slot in zip(group, slots):
                    req.out.put_nowait((None, f"error: prefill failed: {e}"))
                    self._deregister_plan(slot)
                    self._schedule_block_release(slot)
                continue
            entries = []
            for req, slot in zip(group, slots):
                self._confirm_plan(slot)
                if req.cancelled:
                    # Cancelled between submit and here: never occupy a
                    # slot (the enqueued prefill still writes the
                    # blocks, so their release is deferred).
                    req.out.put_nowait((None, "cancelled"))
                    self._finalize_cost(req, "cancelled")
                    self.requests_finished += 1
                    self._schedule_block_release(slot)
                    entries.append((slot, None))
                    continue
                act = _Active(req=req, length=int(req.prompt_ids.size),
                              last_token=-1, generated=0)
                self._slots[slot] = act
                entries.append((slot, act))
            fut = loop.run_in_executor(self._executor, self._fetch, handle)
            inflight.append(("prefill", fut, entries, time.perf_counter()))
            admitted = True
        return admitted

    async def _land_faultbacks(self, loop) -> bool:
        """Drain the admission's planned fault-backs on the enqueue
        thread, before its dispatches; False when they failed."""
        if self.kv_tier is None or not self._faultback_pending:
            return True
        return await loop.run_in_executor(self._enqueue_executor,
                                          self._drain_faultbacks)

    # -- chunked prefill (scheduler side) -----------------------------------
    def _is_cold(self, req: _Request) -> bool:
        return (self.prefill_chunk_tokens is not None
                and int(req.prompt_ids.size) > self.prefill_chunk_tokens)

    def _chunk_shared(self, act: _Active, idx: int) -> bool:
        """Every block of chunk ``idx`` was a prefix hit: the pool holds
        its k/v already, and its dispatch is skipped."""
        bpc = self.prefill_chunk_tokens // self.block_size
        lo = idx * bpc
        hi = min(lo + bpc, len(act.chunk_dest))
        return all(act.chunk_dest[c] == -1 for c in range(lo, hi))

    async def _admit_chunked(self, loop, inflight: deque) -> bool:
        """Admit the front (cold) request onto a free slot: plan all its
        blocks now (hits share; fresh registrations wait for their
        chunk), install the slot as prefilling and dispatch the first
        chunk.  False on pool pressure: the request stays pending."""
        slot = self._free_slot()
        req = self._pending[0]
        chunk_regs: Dict[int, Tuple[bytes, int]] = {}
        dest = self._plan_prompt_blocks(req, slot, chunk_regs=chunk_regs)
        if dest is None:
            return False
        if not await self._land_faultbacks(loop):
            # Nothing was dispatched: release the plan's blocks (its fresh
            # registrations were never published) and leave the request
            # pending; its replan misses the tier and re-prefills.
            self._schedule_block_release(slot)
            return True
        self._pending.popleft()
        n = int(req.prompt_ids.size)
        act = _Active(req=req, length=n, last_token=-1, generated=0,
                      prefilling=True,
                      chunk_total=-(-n // self.prefill_chunk_tokens),
                      chunk_dest=dest, chunk_regs=chunk_regs)
        self._slots[slot] = act
        self.chunked_admissions += 1
        await self._step_chunk(loop, inflight, slot, act)
        return True

    async def _step_chunk(self, loop, inflight: deque, slot: int,
                          act: _Active) -> None:
        """Dispatch the next chunk of a prefilling slot into the FIFO,
        skipping chunks of prefix hits (never the final one: it samples
        the first token)."""
        idx = act.chunk_next
        # kfslint: disable=spin-loop — bounded by chunk_total (each pass
        # increments idx); no other coroutine gates the exit.
        while idx < act.chunk_total - 1 and self._chunk_shared(act, idx):
            self.prefill_chunks_skipped += 1
            obs.generator_prefill_chunks_total().labels(
                outcome="skipped_shared").inc()
            idx += 1
        final = idx >= act.chunk_total - 1
        act.chunk_next = idx + 1
        try:
            handle = await loop.run_in_executor(
                self._enqueue_executor, self._enqueue_chunk, slot, act,
                idx, final)
        except Exception as e:
            # As a failed prefill enqueue: fail this request, release its
            # blocks; its deferred registrations were never published.
            logger.exception("chunk-prefill enqueue failed")
            if self._slots[slot] is act:
                self._free_slot_state(slot)
                act.req.out.put_nowait((None, f"error: prefill failed: {e}"))
            return
        if self._slots[slot] is act:
            # This chunk's fresh blocks are backed by a dispatched write
            # now (a cancel during the enqueue released them: no
            # publish then).
            self._register_chunk_blocks(act, idx)
            if final:
                # The first token is in the feed arrays: waves enqueued
                # from here decode the slot.
                act.prefilling = False
        self.prefill_chunks += 1
        obs.generator_prefill_chunks_total().labels(
            outcome="dispatched").inc()
        act.chunks_inflight += 1
        fut = loop.run_in_executor(self._executor, self._fetch, handle)
        inflight.append(("chunk", fut, (slot, act, idx, final),
                         time.perf_counter()))

    def _register_chunk_blocks(self, act: _Active, idx: int) -> None:
        if not act.chunk_regs:
            return
        bpc = self.prefill_chunk_tokens // self.block_size
        lo = idx * bpc
        hi = min(lo + bpc, len(act.chunk_dest))
        with self._block_lock:
            for c in range(lo, hi):
                reg = act.chunk_regs.pop(c, None)
                if reg is None:
                    continue
                chain, blk = reg
                if self._prefix_index.get(chain) is not None:
                    # An identical admission registered the chain first:
                    # keep the canonical entry; this block stays private.
                    continue
                self._prefix_index[chain] = blk
                self._block_chain[blk] = chain

    async def _dispatch_chunks(self, loop, inflight: deque) -> None:
        """Mid-prefill slots dispatch their next chunks: one chunk in
        flight a slot while streams decode (chunks and waves alternate
        in the FIFO, so a stream stalls one chunk at a time), up to
        max(2, pipeline_depth) with no decodable stream."""
        decodable_now = any(s is not None and not s.prefilling
                            for s in self._slots)
        limit = 1 if decodable_now else max(2, self.pipeline_depth)
        for i, s in enumerate(list(self._slots)):
            while (s is not None and s.prefilling
                   and self._slots[i] is s
                   and s.chunks_inflight < limit
                   and s.chunk_next < s.chunk_total):
                await self._step_chunk(loop, inflight, i, s)

    def _preempt_or_hold(self) -> bool:
        """Grow every decodable slot's table; returns True to HOLD.  On
        pool pressure prefilling slots yield their blocks first (nothing
        was sampled for them: they restart from the queue's front), and
        the failing streams hold while those blocks, or frees already
        maturing through the deferral window, come back.  Otherwise a
        slot the pool cannot grow is preempted: its request re-queues at
        the front with prompt = prompt + tokens so far and resumes
        exactly (the noise is keyed on the absolute position)."""
        failed = self._ensure_block_capacity()
        if not failed:
            return False
        yielded = False
        for i, s in enumerate(self._slots):
            if s is not None and s.prefilling:
                self._free_slot_state(i)
                self._pending.appendleft(s.req)
                self.preemptions += 1
                yielded = True
                TIMELINE.record("host", "preempt", trace_id=s.req.trace_id,
                                slot=i, attrs={"phase": "prefill"})
        if yielded or self._deferred_frees:
            return True
        for i in failed:
            s = self._slots[i]
            if s is None:
                continue
            merged_len = int(s.req.prompt_ids.size) + len(s.tokens)
            # A merged sequence past the largest bucket still resumes
            # when the chunked path can carry it.
            fits = (merged_len <= self.prefill_buckets[-1]
                    or (self.prefill_chunk_tokens is not None
                        and merged_len > self.prefill_chunk_tokens))
            if (not fits
                    or -(-merged_len // self.block_size) > self.num_blocks
                    or s.req.max_new_tokens - s.generated < 1):
                s.req.out.put_nowait((None,
                                      "error: kv cache pool exhausted"))
                self._free_slot_state(i)
                continue
            s.req.prompt_ids = np.concatenate(
                [s.req.prompt_ids, np.asarray(s.tokens, np.int32)])
            s.req.max_new_tokens -= s.generated
            self._free_slot_state(i)
            self._pending.appendleft(s.req)
            self.preemptions += 1
            TIMELINE.record("host", "preempt", trace_id=s.req.trace_id,
                            slot=i, attrs={"phase": "decode"})
        return False

    def _set_hold(self, held: bool) -> None:
        """Track growth-starvation HOLD transitions: the window from the
        first held iteration to the release is one host-track timeline
        span."""
        self._growth_starved = held
        if held:
            if self._hold_since is None:
                self._hold_since = time.time()
        elif self._hold_since is not None:
            now = time.time()
            TIMELINE.record("host", "hold", dur_s=now - self._hold_since,
                            t_end=now)
            self._hold_since = None

    async def _run_pipeline(self, loop, inflight: deque):
        while not self._closed:
            self._expire_deadlines()
            admitted = await self._admit(loop, inflight)
            active = any(s is not None for s in self._slots)
            if not active and not inflight:
                # Nothing in flight can write a block: release every
                # deferred free now.
                self._process_deferred_frees(force=True)
                self._set_hold(False)
                if not self._pending:
                    self._wakeup.clear()
                    if admitted:
                        continue
                    try:
                        await asyncio.wait_for(self._wakeup.wait(),
                                               timeout=1.0)
                    except asyncio.TimeoutError:
                        if not self._pending and not any(
                                s is not None for s in self._slots):
                            return  # idle; a submit restarts the loop
                continue
            # Chunks first: a slot whose final chunk lands here becomes
            # decodable, and its table must grow to the decode horizon
            # before this iteration's waves.
            await self._dispatch_chunks(loop, inflight)
            held = self._preempt_or_hold()
            self._set_hold(held)
            decodable = [] if held else [
                s for s in self._slots if s is not None and not s.prefilling]
            waves = sum(1 for it in inflight if it[0] in ("decode", "spec"))
            if self.spec_tokens and decodable and waves == 0:
                # Speculative mode runs at depth 1: a spec wave is fed
                # from the host's committed histories, so it waits for
                # the last wave's verdicts.
                await self._spec_or_fallback_wave(loop, inflight)
                waves = 1
            while not self.spec_tokens and decodable \
                    and waves < self.pipeline_depth:
                if (self.adaptive_depth and waves >= 1 and all(
                        s.req.max_new_tokens - s.generated
                        <= waves * self.steps_per_call
                        for s in decodable)):
                    # Every stream finishes within the waves in flight:
                    # another wave could only decode garbage.
                    self.suppressed_waves += 1
                    obs.generator_suppressed_waves_total().inc()
                    TIMELINE.record("host", "wave.suppressed")
                    break
                handle, snap, t0 = await loop.run_in_executor(
                    self._enqueue_executor, self._enqueue_wave)
                fut = loop.run_in_executor(self._executor, self._fetch,
                                           handle)
                inflight.append(("decode", fut, snap, t0))
                waves += 1
            if decodable and waves != self._depth_effective:
                self._depth_effective = waves
                obs.generator_pipeline_depth().set(waves)
            if not inflight:
                # A held drain reached an empty pipeline: no zombie
                # dispatch exists, so the yielded blocks can go now.
                self._process_deferred_frees(force=True)
                continue
            kind, fut, meta, t0 = inflight.popleft()
            t_await = time.perf_counter()
            try:
                fetched, lp, _ = await fut
                wait_s = time.perf_counter() - t_await
            except Exception as e:
                if kind == "prefill":
                    logger.exception("prefill failed")
                    for slot, act in meta:
                        if act is not None and self._slots[slot] is act:
                            self._free_slot_state(slot)
                            act.req.out.put_nowait(
                                (None, f"error: prefill failed: {e}"))
                    continue
                if kind == "chunk":
                    slot, act, _idx, _final = meta
                    act.chunks_inflight -= 1
                    logger.exception("chunk prefill failed")
                    if self._slots[slot] is act:
                        self._free_slot_state(slot)
                        act.req.out.put_nowait(
                            (None, f"error: prefill failed: {e}"))
                    continue
                raise
            now = time.perf_counter()
            busy = now - max(t0, self._last_fetch_done)
            self._last_fetch_done = now
            # The union of busy intervals: a device-track timeline event
            # per fetched dispatch (the interval the device_s stats sum
            # and the cost records split), per-slot events with each
            # stream's trace id, and a pool sample.
            wall = time.time()
            dev_s = max(0.0, busy)
            if kind == "decode":
                self._decode_device_s += busy
                self._decode_wait_s += wait_s
                TIMELINE.record(
                    "device", "decode.wave", dur_s=dev_s, t_end=wall,
                    attrs={"steps": self.steps_per_call,
                           "wait_ms": round(wait_s * 1e3, 3)})
                for slot_i, s in enumerate(meta):
                    if s is not None and self._slots[slot_i] is s:
                        TIMELINE.record("slot", "decode", dur_s=dev_s,
                                        t_end=wall,
                                        trace_id=s.req.trace_id,
                                        slot=slot_i)
                self._record_pool_sample()
                self._distribute(fetched, lp, meta, dev_s * 1e3)
            elif kind == "spec":
                self._decode_device_s += busy
                self._decode_wait_s += wait_s
                self._finish_spec(fetched, lp, meta, dev_s, wall, wait_s)
            elif kind == "chunk":
                self._prefill_device_s += busy
                self._prefill_wait_s += wait_s
                # The stall this chunk put between decode fetches.
                obs.generator_prefill_chunk_stall_ms().observe(busy * 1e3)
                slot, act, idx, final = meta
                TIMELINE.record("device", "prefill.chunk", dur_s=dev_s,
                                t_end=wall, trace_id=act.req.trace_id,
                                slot=slot,
                                attrs={"chunk": idx, "final": final})
                TIMELINE.record("slot", "prefill.chunk", dur_s=dev_s,
                                t_end=wall, trace_id=act.req.trace_id,
                                slot=slot, attrs={"chunk": idx})
                # A chunk serves one request: its whole busy interval
                # is that request's prefill cost.
                act.req.prefill_device_ms += dev_s * 1e3
                self._finish_chunk(fetched, lp, meta)
            else:
                self._prefill_device_s += busy
                self._prefill_wait_s += wait_s
                TIMELINE.record("device", "prefill.bucket", dur_s=dev_s,
                                t_end=wall, attrs={"batch": len(meta)})
                for slot_i, act in meta:
                    if act is not None and self._slots[slot_i] is act:
                        TIMELINE.record("slot", "prefill", dur_s=dev_s,
                                        t_end=wall,
                                        trace_id=act.req.trace_id,
                                        slot=slot_i)
                self._finish_prefill(fetched, lp, meta, dev_s * 1e3)
            self._process_deferred_frees()

    def _record_pool_sample(self) -> None:
        """Occupancy counter sample for the timeline (a Chrome counter
        track); the ``engine`` string tells two engines' pools apart."""
        values = {"active_slots": sum(1 for s in self._slots
                                      if s is not None),
                  "pending": len(self._pending),
                  "engine": self.name}
        if self.block_size is not None:
            values["free_blocks"] = len(self._free_blocks)
            values["reclaimable_blocks"] = len(self._reclaimable)
        TIMELINE.counter("pool", values)

    def _finish_chunk(self, first: np.ndarray, lp, meta) -> None:
        """A fetched chunk; the final one carries the stream's first
        token (the feed arrays had it at enqueue, so waves in between
        decoded the slot; FIFO order delivers this token first)."""
        slot, act, _idx, final = meta
        act.chunks_inflight -= 1
        if final and self._slots[slot] is act:
            self.prefill_requests += 1
            self._emit(slot, int(first[0]), _lp_record(lp, act.req, 0))

    def _finish_prefill(self, firsts: np.ndarray, lp, entries,
                        device_ms: float = 0.0):
        """Deliver a prefill batch's first tokens; a slot whose _Active
        changed since enqueue (cancel) discards its row.  The dispatch's
        device ms split evenly over the rows whose cost records are
        still open (a cancelled row's was finalized at cancel, so its
        share goes to the survivors: device time stays conserved)."""
        self.prefills += 1
        live = [act for slot, act in entries
                if act is not None and self._slots[slot] is act]
        for act in live:
            act.req.prefill_device_ms += device_ms / len(live)
        for i, (slot, act) in enumerate(entries):
            if act is None or self._slots[slot] is not act:
                continue
            self.prefill_requests += 1
            self._emit(slot, int(firsts[i]), _lp_record(lp, act.req, i))

    def _emit(self, slot: int, token: int, lp_rec=None):
        """Account a produced token for `slot` and deliver it (or the
        finish marker).  `length` counts tokens whose k/v are in the
        cache; the produced token's k/v are written by the step that
        feeds it, so this never touches `length`."""
        s = self._slots[slot]
        s.generated += 1
        s.req.tokens_out += 1
        self.tokens_generated += 1
        obs.llm_tokens_total().labels(direction="out").inc()
        # The first emission is the TTFT, later ones inter-token gaps;
        # both carry the request's trace id as an exemplar.
        now = time.perf_counter()
        if s.req.last_emit_t is None:
            obs.llm_ttft_ms().observe((now - s.req.submit_t) * 1000.0,
                                      trace_id=s.req.trace_id)
        else:
            obs.llm_inter_token_ms().observe(
                (now - s.req.last_emit_t) * 1000.0,
                trace_id=s.req.trace_id)
        s.req.last_emit_t = now
        finished = None
        if self.eos_id is not None and token == self.eos_id:
            finished = "eos"
        elif s.generated >= s.req.max_new_tokens:
            finished = "length"
        if finished == "eos":
            s.req.out.put_nowait((None, "eos"))   # a stop, not content
        else:
            if lp_rec is not None:
                s.req.lp_chosen.append(lp_rec[0])
                s.req.lp_top.append(lp_rec[1])
            s.tokens.append(token)
            s.req.out.put_nowait((token, finished))
        if finished is not None:
            duration_s = now - s.req.submit_t
            if duration_s > 0:
                obs.llm_tokens_per_second().observe(
                    s.generated / duration_s, trace_id=s.req.trace_id)
            self._record_finish_span(s.req, s.generated, finished)
            self._finalize_cost(s.req, finished)
            self._free_slot_state(slot)
            self.requests_finished += 1
        else:
            s.last_token = token

    def _distribute(self, tokens: np.ndarray, lp, snapshot,
                    device_ms: float = 0.0):
        """tokens [S, K]: deliver each slot's steps in order.  A slot
        consumes its row only if the _Active it held at enqueue is still
        there; freed slots' rows are garbage (counted as waste), and a
        slot finishing mid-wave discards the rest of its row.  The wave's
        device ms split evenly over the live streams it decoded."""
        k = tokens.shape[1]
        self._token_steps += k
        resident_tokens = 0
        live = sum(1 for i, s in enumerate(snapshot)
                   if s is not None and self._slots[i] is s)
        share_ms = device_ms / live if live else 0.0
        for i, s in enumerate(snapshot):
            if s is None:
                continue
            if self._slots[i] is not s:
                self._wasted_token_steps += k
                continue
            self._occupied_slot_steps += k
            s.req.decode_device_ms += share_ms
            if self.block_size is not None:
                s.req.blocks_held = max(s.req.blocks_held,
                                        -(-int(s.length) // self.block_size))
            # Roofline accounting over live rows, at the slot's length
            # at wave start.
            self._decode_flops += k * (self._flops_matmul_per_token
                                       + self._attn_flops_coeff * s.length)
            resident_tokens += s.length
            for j in range(k):
                if self._slots[i] is not s:
                    self._wasted_token_steps += k - j
                    break
                s.length += 1   # step j wrote the fed token's k/v
                self._emit(i, int(tokens[i, j]),
                           _lp_record(lp, s.req, (i, j)))
        if resident_tokens:
            self._decode_hbm_bytes += k * (
                self._param_read_bytes
                + resident_tokens * self._kv_bytes_per_token)


    # -- speculative decoding (scheduler side) ------------------------------
    async def _spec_or_fallback_wave(self, loop, inflight: deque) -> None:
        """Enqueue one wave in speculative mode: a draft/verify wave over
        the host-feedable slots, or a plain wave after re-syncing the
        device feed when a spec fault site trips or no slot has a
        host-visible last token yet (a prefill's first token still in
        the FIFO: its device feed row is right, so the plain wave
        decodes it).  The tokens are the same either way."""
        eligible = [(i, s) for i, s in enumerate(self._slots)
                    if s is not None and not s.prefilling
                    and s.last_token >= 0]
        fall_site = await self._probe_spec_fault() if eligible else None
        if eligible and fall_site is None:
            ngram = windows = None
            host_ms = 0.0
            if self._draft_module is not None:
                windows = rolling_windows(
                    [self._spec_history(s) for _, s in eligible],
                    self.max_slots, [i for i, _ in eligible],
                    self._draft_window)
            else:
                ngram, host_ms = self._propose_ngram(eligible)
            handle, meta, t0 = await loop.run_in_executor(
                self._enqueue_executor, self._enqueue_spec_wave,
                eligible, ngram, windows, host_ms)
            fut = loop.run_in_executor(self._executor, self._fetch_spec,
                                       handle)
            inflight.append(("spec", fut, meta, t0))
            return
        if fall_site is not None:
            self._count_spec_fallback(fall_site)
        handle, snap, t0 = await loop.run_in_executor(
            self._enqueue_executor, self._enqueue_resynced_wave)
        fut = loop.run_in_executor(self._executor, self._fetch, handle)
        inflight.append(("decode", fut, snap, t0))

    async def _probe_spec_fault(self) -> Optional[str]:
        """The speculative path's fault sites, probed on the loop: an
        injected error at either degrades THIS wave to plain decode."""
        if faults.configured(fault_sites.ENGINE_SPEC_DRAFT):
            try:
                await faults.inject(fault_sites.ENGINE_SPEC_DRAFT,
                                    key=self.name)
            except FaultInjected:
                return "draft"
        if faults.configured(fault_sites.ENGINE_SPEC_VERIFY):
            try:
                await faults.inject(fault_sites.ENGINE_SPEC_VERIFY,
                                    key=self.name)
            except FaultInjected:
                return "verify"
        return None

    def _count_spec_fallback(self, site: str) -> None:
        self.spec_fallbacks[site] = self.spec_fallbacks.get(site, 0) + 1
        obs.specdec_fallbacks_total().labels(model=self.name,
                                             site=site).inc()

    @staticmethod
    def _spec_history(s: _Active) -> List[int]:
        """A slot's committed stream: prompt + emitted content tokens
        (which end with last_token), the prefix the next draw extends."""
        return [int(t) for t in s.req.prompt_ids] + s.tokens

    def _propose_ngram(self, eligible) -> Tuple[np.ndarray, float]:
        """Host-side prompt-lookup proposals for the eligible rows, and
        their host ms (the n-gram arm's draft cost)."""
        t0 = time.perf_counter()
        draft = np.zeros((self.max_slots, self.spec_tokens), np.int32)
        for i, s in eligible:
            draft[i] = self._ngram.propose(self._spec_history(s))
        return draft, (time.perf_counter() - t0) * 1000.0

    def _finish_spec(self, fetched, lp, meta, dev_s: float, wall: float,
                     wait_s: float) -> None:
        """Split a fetched spec wave's busy interval ``dev_s`` into draft
        and verify (the draft model's program completes before the
        verify on the stream; the n-gram head's cost is host time),
        record them on the timeline, then commit its rows."""
        samples, draft, draft_ready_s = fetched
        entries, host_draft_ms = meta
        dev_ms = dev_s * 1e3
        if self._draft_module is not None:
            draft_ms = min(max(draft_ready_s * 1e3, 0.0), dev_ms)
            verify_ms = max(0.0, dev_ms - draft_ms)
        else:
            draft_ms, verify_ms = host_draft_ms, dev_ms
        self._spec_draft_s += draft_ms / 1e3
        self._spec_verify_s += verify_ms / 1e3
        TIMELINE.record("device" if self._draft_module is not None
                        else "host", "spec.draft", dur_s=draft_ms / 1e3,
                        t_end=wall, attrs={"k": self.spec_tokens})
        TIMELINE.record("device", "spec.verify", dur_s=verify_ms / 1e3,
                        t_end=wall,
                        attrs={"k": self.spec_tokens, "rows": len(entries),
                               "wait_ms": round(wait_s * 1e3, 3)})
        for slot_i, s in entries:
            if self._slots[slot_i] is s:
                TIMELINE.record("slot", "spec.decode", dur_s=dev_s,
                                t_end=wall, trace_id=s.req.trace_id,
                                slot=slot_i)
        self._record_pool_sample()
        self._distribute_spec(samples, draft, lp, entries, dev_ms,
                              draft_ms, verify_ms)

    def _distribute_spec(self, samples: np.ndarray, draft: np.ndarray, lp,
                         entries, device_ms: float, draft_ms: float,
                         verify_ms: float) -> None:
        """samples [S, K + 1], draft [S, K]: commit each live row's
        longest agreeing prefix.  Row acceptance a (1..K + 1): draw j
        extends a prefix that is right only if every earlier proposal
        matched, so emission stops at the first mismatch, whose TARGET
        draw is still right and is emitted; all K matching emits the
        K + 1'th (bonus) draw too."""
        K = self.spec_tokens
        kp1 = K + 1
        self._token_steps += kp1
        live = [(i, s) for i, s in entries if self._slots[i] is s]
        # Rows freed after enqueue: K + 1 garbage positions each.
        self._wasted_token_steps += (len(entries) - len(live)) * kp1
        # Each live row's even share of the wave, and of its split.
        n_live = max(1, len(live))
        shares = (device_ms / n_live, draft_ms / n_live,
                  verify_ms / n_live)
        accepted_wave = 0
        resident_tokens = 0
        length_fam = obs.specdec_accepted_length_tokens()
        for i, s in live:
            a = 1
            while a <= K and int(draft[i, a - 1]) == int(samples[i, a - 1]):
                a += 1
            self.spec_proposed_tokens += K
            self.spec_accepted_tokens += a - 1
            accepted_wave += a - 1
            self._spec_lengths.append(a)
            length_fam.labels(model=self.name).observe(float(a))
            s.req.decode_device_ms += shares[0]
            s.req.spec_draft_ms += shares[1]
            s.req.spec_verify_ms += shares[2]
            if self.block_size is not None:
                s.req.blocks_held = max(
                    s.req.blocks_held,
                    -(-int(s.length + a) // self.block_size))
            # Roofline over accepted tokens only: rejected positions are
            # the acceptance trade (goodput_ratio shows them).
            self._decode_flops += a * (self._flops_matmul_per_token
                                       + self._attn_flops_coeff * s.length)
            resident_tokens += s.length
            emitted = 0
            for j in range(a):
                if self._slots[i] is not s:
                    break  # finished mid-row: the rest is past its end
                s.length += 1
                self._emit(i, int(samples[i, j]),
                           _lp_record(lp, s.req, (i, j)))
                emitted += 1
            self.spec_emitted_tokens += emitted
            self._occupied_slot_steps += emitted
            self._wasted_token_steps += kp1 - emitted
        if live:
            proposer = self._proposer_name()
            obs.specdec_proposed_tokens_total().labels(
                model=self.name, proposer=proposer).inc(len(live) * K)
            obs.specdec_accepted_tokens_total().labels(
                model=self.name, proposer=proposer).inc(accepted_wave)
            obs.specdec_draft_ms().labels(
                model=self.name, proposer=proposer).observe(draft_ms)
            obs.specdec_acceptance_ratio().labels(model=self.name).set(
                self.spec_accepted_tokens / self.spec_proposed_tokens)
        if resident_tokens:
            # One parameter read serves all K + 1 positions, while each
            # query streams the resident k/v.
            self._decode_hbm_bytes += (
                self._param_read_bytes
                + kp1 * resident_tokens * self._kv_bytes_per_token)


def _lp_record(lp, req: _Request, index):
    """(chosen logprob, [(id, logprob)] top-N) of one row, or None when
    the request did not ask for logprobs."""
    n = req.logprobs
    if lp is None or n <= 0:
        return None
    chosen, ids, lps = lp
    return (float(chosen[index]),
            [(int(t), float(v)) for t, v in zip(ids[index][:n],
                                                lps[index][:n])])


def _pow2_buckets(max_seq: int) -> List[int]:
    out, b = [], 16
    while b < max_seq:
        out.append(b)
        b *= 2
    out.append(max_seq)
    return out
