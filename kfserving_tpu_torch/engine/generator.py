"""GenerationEngine: paged KV-cache decoding with continuous batching.

Port of ``kfserving_tpu/engine/generator.py``, paged mode:

- **paged cache**: per layer a shared block pool [NB + 1, BS, H, D] (the
  last block is the sink that dropped writes land in, see
  ``ops/paged_attention.py``) plus per-slot block tables [S, MB] on the
  host.  Device memory scales with resident tokens; identical prompt
  prefixes share blocks through a chain-hash index; pool pressure queues
  admissions; block release is deferred past in-flight waves (the
  zombie-wave hazard); a slot that cannot grow is preempted and resumes
  exactly.
- **prefill/decode split**: a prompt group runs one bucket-padded
  forward (causal + lengths: the CUDA flash kernel on the card), its k/v
  scatter into the pool, and the first tokens land in the device feed
  arrays.  Decode then runs ``steps_per_call`` single-token steps per
  wave through the paged decode kernel, feeding each step's tokens to
  the next on the device.
- **pipelined, sync-free dispatch**: all device work is enqueued on ONE
  enqueue thread, on the engine's own CUDA stream (in order), inside
  ``torch.inference_mode()``.  Results copy into pinned host memory with
  ``non_blocking=True`` behind a CUDA event; the fetch executor waits on
  the event, never the loop thread or the enqueue thread.  Nothing on the
  enqueue path reads a device value back (no ``.item()``, ``.tolist()``
  or ``.cpu()``), so ``pipeline_depth`` waves stay in flight.
- **the decode wave as a CUDA graph**: on the card a wave's
  ``steps_per_call`` steps, its sampling and the write-back of its last
  tokens and positions into the device feed arrays are one captured
  graph per (max_slots, steps_per_call, any_sampled, need_mask,
  want_lp), the JAX generator's one decode program per (max_slots,
  steps_per_call) split by the host's decisions below.  A wave copies
  the block table and the four sampling arrays into one static input
  tensor (one host-to-device copy), replays its variant's graph and
  copies the graph's static outputs out.  The greedy variant is captured
  when the engine starts; another is captured at its first wave, which
  runs eagerly (its tokens are that wave's) just before the capture.
  All variants share one memory pool; each first capture is noted to
  ``engine/compile_cache.py``.  The prefill stays eager.  On the CPU
  every wave runs eagerly on the same static tensors.
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
  it is scheduled (preemption and resume included).

- **deadlines and telemetry**: a request carries the deadline and trace
  id of the context that submitted it; between decode waves a request
  whose budget ran out ends with finish_reason ``"timeout"`` and frees
  its slot.  Tokens feed the TTFT / inter-token / tokens-per-second
  series, the prefix index and the pool their lookup, tokens-saved and
  eviction counters, and every finished request records a
  ``generator.generate`` span; ``stats()`` carries the roofline
  accounting (decode and prefill FLOP/s and MFU, decode memory
  bandwidth) that ``/metrics`` publishes.

Left for later: the dense slot mode (a config without ``block_size`` is
refused), chunked prefill, speculative decoding, the host KV tier, the
timeline, meshes, and graphs for the prefill buckets.
"""

import asyncio
import concurrent.futures
import contextlib
import hashlib
import itertools
import logging
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Dict, List, Optional, Tuple

import numpy as np
import torch

from kfserving_tpu_torch.engine import compile_cache, graphs, threefry
from kfserving_tpu_torch.engine.torch_engine import device_peak_flops
from kfserving_tpu_torch.observability import metrics as obs
from kfserving_tpu_torch.observability.profiling.roofline import (
    device_peak_hbm_bw,
)
from kfserving_tpu_torch.ops.flash_attention import check_kernel_shapes
from kfserving_tpu_torch.ops.paged_attention import (
    SUPPORTED_DTYPES,
    SUPPORTED_HEAD_DIMS,
    paged_insert,
)
from kfserving_tpu_torch.protocol.errors import InferenceError, InvalidInput
from kfserving_tpu_torch.reliability.deadline import current_deadline
from kfserving_tpu_torch.tracing import Span, current_request_id, tracer

logger = logging.getLogger("kfserving_tpu_torch.engine.generator")

# Process-monotonic generator ids (compile-cache sources).
_generator_seq = itertools.count()

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


def check_device_shapes(module, device: torch.device) -> None:
    """On the card, refuse a decoder that either kernel of the path is not
    built for, at construction rather than on its first request: the
    prefill runs the flash kernel (K1) and the decode waves the paged
    kernel (K2)."""
    check_kernel_shapes(module, device)
    cfg = module.config
    if device.type == "cuda" and (cfg.dtype not in SUPPORTED_DTYPES
                                  or cfg.head_dim not in
                                  SUPPORTED_HEAD_DIMS):
        raise InvalidInput(
            f"the paged decode kernel takes dtypes {SUPPORTED_DTYPES} and "
            f"head dims {SUPPORTED_HEAD_DIMS}, not {cfg.dtype} and "
            f"{cfg.head_dim}")


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


@dataclass
class _Active:
    req: _Request
    length: int          # tokens whose k/v are in the cache
    last_token: int      # the token the next step feeds at `length`
    generated: int
    # Content tokens emitted so far: preemption re-prefills prompt +
    # tokens to resume the stream exactly.
    tokens: List[int] = field(default_factory=list)


@dataclass
class _Fetch:
    """Device results on their way to pinned host memory: ``event``
    fires when the copies are done (None on the CPU, where they are)."""
    host: List[torch.Tensor]
    event: Optional[Any]


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
                 adaptive_depth: bool = True,
                 rng_seed: int = 0,
                 logprob_topk: int = 5,
                 name: str = "decoder"):
        self.module = module
        self.device = next(module.parameters()).device
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

        if not block_size:
            raise InvalidInput(
                "the PyTorch port serves the paged KV cache only: set "
                "block_size (the dense slot mode is not ported yet)")
        bs = self.block_size = int(block_size)
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
        self._cache_dtype = cfg.dtype
        self._cache_shape = (self.num_blocks, bs, cfg.num_heads,
                             cfg.head_dim)
        with torch.inference_mode():
            # NB + 1 blocks: the last is the sink no table names.
            pool_shape = (self.num_blocks + 1,) + self._cache_shape[1:]
            self._caches = [
                (torch.zeros(pool_shape, dtype=cfg.dtype,
                             device=self.device),
                 torch.zeros(pool_shape, dtype=cfg.dtype,
                             device=self.device))
                for _ in range(cfg.num_layers)]
            # Device feed state: the token each slot feeds next and its
            # position, plus a sink row (index max_slots) that a
            # prefill batch's padding rows write.  Rows of free slots go
            # stale by design: a garbage decode there writes to the sink
            # block and its tokens are dropped at distribute.
            self._feed_tokens = torch.zeros(self.max_slots + 1,
                                            dtype=torch.int32,
                                            device=self.device)
            self._feed_positions = torch.zeros(self.max_slots + 1,
                                               dtype=torch.int32,
                                               device=self.device)
            self._base_key = threefry.prng_key(self.rng_seed,
                                               device=self.device)
            # The wave's static input: the block table [S, MB] and the
            # four sampling arrays [S] (temperatures and top-p as float32
            # bits), one host-to-device copy a wave.
            S, MB = self.max_slots, self.blocks_per_slot
            self._wave_in = torch.zeros(S * MB + 4 * S, dtype=torch.int32,
                                        device=self.device)
            self._wave_table = self._wave_in[:S * MB].view(S, MB)
            rows = [self._wave_in[S * MB + i * S:S * MB + (i + 1) * S]
                    for i in range(4)]
            self._wave_sampling = (rows[0].view(torch.float32), rows[1],
                                   rows[2].view(torch.float32), rows[3])

        # Decode-wave programs: variant key -> (graph, static outputs,
        # kernel launch tally), in one pool, on the engine's stream.
        self._stream = None
        self._pool = None
        self._programs: Dict[tuple, Any] = {}
        self.compile_source = f"generator:{name}:{next(_generator_seq)}"
        self.wave_captures = 0
        self.capture_ms_total = 0.0

        # Host-side paging state, guarded by _block_lock (cancel() on
        # the loop thread races table snapshots on the enqueue thread).
        self._block_lock = threading.Lock()
        self._tables = np.full((self.max_slots, self.blocks_per_slot), -1,
                               np.int32)
        self._free_blocks: deque = deque(range(self.num_blocks))
        self._block_ref = np.zeros(self.num_blocks, np.int64)
        # chain digest -> block of a FULL prompt block (prefix reuse);
        # zero-ref registered blocks linger in _reclaimable (LRU) until
        # allocation pressure evicts them.
        self._prefix_index: Dict[bytes, int] = {}
        self._block_chain: Dict[int, bytes] = {}
        self._reclaimable: "OrderedDict[int, None]" = OrderedDict()
        self.block_evictions: Dict[str, int] = {
            "capacity_dropped": 0, "index_invalidation": 0,
            "zombie_deferral": 0}
        self.prefill_tokens_saved = 0
        # (release_at_decode_step, [block ids]): see
        # _schedule_block_release.
        self._deferred_frees: deque = deque()
        # slot -> provisional prefix registrations of its last plan.
        self._plan_regs: Dict[int, List[Tuple[bytes, int]]] = {}
        self.prefix_hits = 0
        self.prefix_misses = 0

        # `_executor` waits for fetches (two workers, so a decode wave's
        # tokens never queue behind a prefill's); `_enqueue_executor`
        # owns every device dispatch, so its FIFO is stream order.
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=2, thread_name_prefix=f"generator-{name}")
        self._enqueue_executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"generator-enq-{name}")
        self._slots: List[Optional[_Active]] = [None] * self.max_slots
        self._pending: deque = deque()
        # Growth starvation: a slot cannot grow while freed blocks are
        # still maturing through the deferral window; the scheduler
        # HOLDS (no admissions, no waves) instead of preempting.
        self._growth_starved = False
        self._wakeup: Optional[asyncio.Event] = None
        self._loop_task: Optional[asyncio.Task] = None
        self._closed = False

        # stats
        self.tokens_generated = 0
        self.decode_steps = 0       # decode waves dispatched
        self._token_steps = 0       # waves fetched x steps_per_call
        self.prefills = 0           # prefill dispatches fetched
        self.prefill_requests = 0
        self.requests_finished = 0
        self.preemptions = 0
        self.suppressed_waves = 0
        self._depth_effective = self.pipeline_depth
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
        self._attn_flops_coeff = (4.0 * cfg.num_layers * cfg.num_heads
                                  * cfg.head_dim)
        self._param_read_bytes = self.param_bytes()
        self._kv_bytes_per_token = (
            2 * cfg.num_layers * cfg.num_heads * cfg.head_dim
            * torch.empty((), dtype=cfg.dtype).element_size())
        self._peak_flops = device_peak_flops(self.device)
        self._peak_hbm_bw = device_peak_hbm_bw(self.device)
        self._decode_flops = 0.0
        self._prefill_flops = 0.0
        self._decode_hbm_bytes = 0.0
        # Per prefill bucket: [real tokens, padded tokens].
        self._prefill_bucket_tokens: Dict[int, List[float]] = {}
        if self.device.type == "cuda":
            # The module and the pools were written on this thread's
            # stream; the engine's own stream starts behind them, and
            # the greedy wave is compiled on the enqueue thread.
            self._stream = torch.cuda.Stream(self.device)
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
            self._pool = torch.cuda.graph_pool_handle()
            self._enqueue_executor.submit(self._warm_greedy_wave).result()

    # -- public API --------------------------------------------------------
    def cache_bytes(self) -> int:
        """Bytes of the KV pools (the sink block not counted)."""
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
        if ids.size > self.prefill_buckets[-1]:
            raise InvalidInput(
                f"prompt length {ids.size} exceeds the largest prefill "
                f"bucket {self.prefill_buckets[-1]}")
        if ids.min() < 0 or ids.max() >= self.vocab_size:
            # Checked on the host: an out-of-range embedding index is a
            # device assert on CUDA (XLA clamped it silently).
            raise InvalidInput(
                f"token ids must be in [0, {self.vocab_size})")
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
            self.requests_finished += 1
            return
        except ValueError:
            pass
        for i, s in enumerate(self._slots):
            if s is not None and s.req is req:
                self._free_slot_state(i)
                self.requests_finished += 1
                req.out.put_nowait((None, "cancelled"))
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

    def shutdown_nowait(self):
        """Synchronous teardown (unload runs outside async context):
        stop admitting, let the scheduler drain, release the threads
        without joining."""
        self._closed = True
        if self._wakeup is not None:
            self._wakeup.set()
        self._executor.shutdown(wait=False)
        self._enqueue_executor.shutdown(wait=False)

    def graph_stats(self) -> Dict[str, Any]:
        """The decode-wave graphs: variants captured, their capture ms
        and the pool's bytes (kept out of ``stats()``, which ``/metrics``
        publishes)."""
        return {"wave_graphs": sorted(self._programs),
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
        with self._block_lock:
            refd = int(np.sum(self._block_ref > 0))
            resident = sum(s.length for s in self._slots if s is not None)
            # Over per-slot TABLE blocks: a shared prefix block counts
            # once per sharer in both the numerator and denominator.
            table_blocks = int(np.sum(self._tables >= 0))
            frag = (1.0 - resident / (table_blocks * self.block_size)
                    if table_blocks else 0.0)
            out["paged"] = {
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
        return out

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
            self._count_evictions_locked("capacity_dropped", 1)
            return blk
        return None

    def _count_evictions_locked(self, cause: str, n: int) -> None:
        if n <= 0:
            return
        self.block_evictions[cause] += n
        obs.generator_block_evictions_total().labels(
            model=self.name, cause=cause).inc(n)

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

    def _plan_prompt_blocks(self, req: _Request, slot: int
                            ) -> Optional[List[int]]:
        """Allocate or share blocks for a prompt (loop thread).  Full
        blocks probe the prefix index by chain digest: causal attention
        makes the k/v of positions [0, m) a pure function of the first m
        tokens.  Returns the per-block insert destinations (-1 = shared
        hit, its write drops), or None when the pool cannot hold the
        prompt now (the request stays pending)."""
        bs = self.block_size
        n = int(req.prompt_ids.size)
        full = n // bs
        total = (n + bs - 1) // bs
        dest: List[int] = []
        taken: List[int] = []
        fresh_regs: List[Tuple[bytes, int]] = []
        plan_hits = plan_misses = 0
        chains: List[bytes] = []
        chain = b""
        for c in range(full):
            chain = hashlib.blake2b(
                chain + req.prompt_ids[c * bs:(c + 1) * bs].tobytes(),
                digest_size=16).digest()
            chains.append(chain)
        with self._block_lock:
            for c in range(total):
                if c < full:
                    hit = self._prefix_index.get(chains[c])
                    if hit is not None:
                        self._ref_block_locked(hit)
                        self._tables[slot, c] = hit
                        taken.append(hit)
                        dest.append(-1)
                        plan_hits += 1
                        continue
                blk = self._alloc_block_locked()
                if blk is None:
                    # Roll back; this plan's fresh registrations were
                    # never written, so a later hit on them would share
                    # unwritten blocks.
                    dropped = 0
                    for ch, b in fresh_regs:
                        if self._prefix_index.pop(ch, None) is not None:
                            dropped += 1
                        self._block_chain.pop(b, None)
                    self._count_evictions_locked("index_invalidation",
                                                 dropped)
                    for b in taken:
                        self._unref_block_locked(b)
                    self._tables[slot, :] = -1
                    self._count_lookups(plan_hits, plan_misses, 0)
                    return None
                self._ref_block_locked(blk)
                self._tables[slot, c] = blk
                taken.append(blk)
                dest.append(blk)
                if c < full:
                    # Full prompt blocks become shareable (decode writes
                    # land past the prompt); provisional until the
                    # prefill enqueues.
                    self.prefix_misses += 1
                    plan_misses += 1
                    self._prefix_index[chains[c]] = blk
                    self._block_chain[blk] = chains[c]
                    fresh_regs.append((chains[c], blk))
            self._plan_regs[slot] = fresh_regs
            self.prefix_hits += plan_hits
            self.prefill_tokens_saved += plan_hits * bs
        self._count_lookups(plan_hits, plan_misses, plan_hits * bs)
        return dest

    def _count_lookups(self, hits: int, misses: int, saved: int) -> None:
        """One plan's prefix-index probes and the prompt tokens its hits
        saved, into the registry families."""
        if hits:
            obs.generator_prefix_lookups_total().labels(
                model=self.name, outcome="hit").inc(hits)
        if misses:
            obs.generator_prefix_lookups_total().labels(
                model=self.name, outcome="miss").inc(misses)
        if saved:
            obs.generator_prefill_tokens_saved_total().labels(
                model=self.name).inc(saved)

    def _ensure_block_capacity(self) -> List[int]:
        """Grow active slots' tables to cover the positions the next
        pipeline_depth waves can reach.  Returns the slots that could
        not grow."""
        bs = self.block_size
        horizon = self.steps_per_call * self.pipeline_depth + 1
        failed: List[int] = []
        with self._block_lock:
            for i, s in enumerate(self._slots):
                if s is None:
                    continue
                need = min((s.length + horizon + bs - 1) // bs,
                           self.blocks_per_slot)
                cur = int(np.sum(self._tables[i] >= 0))
                for c in range(cur, need):
                    blk = self._alloc_block_locked()
                    if blk is None:
                        failed.append(i)
                        break
                    self._ref_block_locked(blk)
                    self._tables[i, c] = blk
        return failed

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

    def _start_fetch(self, tensors: List[torch.Tensor]) -> _Fetch:
        """Queue device -> pinned host copies behind an event."""
        if self.device.type != "cuda":
            return _Fetch(list(tensors), None)
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
        if handle.event is not None:
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

    def _enqueue_wave(self):
        """Dispatch one decode wave of steps_per_call steps over every
        slot; the feed arrays carry the last step's tokens/positions to
        the next wave on the device."""
        S = self.max_slots
        snapshot = list(self._slots)
        with self._block_lock:
            table_h = self._tables.copy()
        arrays, flags = self._sampling_arrays(
            [None if s is None else s.req for s in snapshot], S)
        with torch.inference_mode(), self._device_scope():
            handle = self._start_fetch(self._run_wave(table_h, arrays,
                                                      flags))
        self.decode_steps += 1
        return handle, snapshot, time.perf_counter()

    def _run_wave(self, table: np.ndarray, arrays, flags) -> List[
            torch.Tensor]:
        """Enqueue thread: stage the wave's table and sampling arrays
        into the static input and run the wave, from its graph on the
        card (compiled at its first wave) or eagerly on the CPU.  Returns
        the wave's output tensors."""
        p = self._stage_wave(table, arrays, flags)
        if self.device.type != "cuda":
            return self._wave(p)
        key = (self.max_slots, self.steps_per_call) + tuple(flags)
        program = self._programs.get(key)
        if program is None:
            return self._compile_wave(key, p)
        graph, outputs, tally = program
        graphs.replay(graph, tally)
        return outputs

    def _stage_wave(self, table: np.ndarray, arrays, flags) -> _Sampling:
        """Queue the copy of a wave's table and sampling arrays into the
        static input; returns the wave's sampling view of it."""
        temps, top_ks, top_ps, seeds = arrays
        host = np.concatenate([
            table.astype(np.int32).ravel(), temps.view(np.int32), top_ks,
            top_ps.view(np.int32), seeds])
        self._wave_in.copy_(self._to_host_staging(host), non_blocking=True)
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

    def _compile_wave(self, key: tuple, p: _Sampling
                      ) -> List[torch.Tensor]:
        """The first wave of a variant: run it eagerly (its tokens are
        this wave's), then capture the same program into a graph whose
        outputs are static.  Returns the eager wave's outputs."""
        out = self._wave(p)
        t0 = time.perf_counter()
        graph, outputs, tally = graphs.capture(lambda: self._wave(p),
                                               self._stream, self._pool)
        self._programs[key] = (graph, outputs, tally)
        self.wave_captures += 1
        self.capture_ms_total += (time.perf_counter() - t0) * 1e3
        compile_cache.note_compilation(self.compile_source,
                                       ("decode",) + key)
        return out

    def _warm_greedy_wave(self) -> None:
        """Enqueue thread, at engine start: compile the greedy wave.  No
        slot is live, so its eager run decodes the free rows, which
        write only the sink block."""
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
        for _ in range(self.steps_per_call):
            kv = [(pk, pv, table) for pk, pv in self._caches]
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
                               dest_rows: List[List[int]]) -> _Fetch:
        """Dispatch one bucket-padded prefill for the group, insert its
        k/v into the pool and its first tokens into the feed arrays; no
        host sync.  Rows pad to a power of two (padding rows: length 1,
        feed row = the sink row, every block dropped)."""
        b = len(group)
        b_bucket = 1
        while b_bucket < b:
            b_bucket *= 2
        ids = np.zeros((b_bucket, bucket), np.int32)
        lengths = np.ones(b_bucket, np.int32)
        slot_arr = np.full(b_bucket, self.max_slots, np.int64)
        dest = np.full((b_bucket, bucket // self.block_size), -1, np.int64)
        for i, (req, slot) in enumerate(zip(group, slots)):
            n = req.prompt_ids.size
            ids[i, :n] = req.prompt_ids
            lengths[i] = n
            slot_arr[i] = slot
            dest[i, :len(dest_rows[i])] = dest_rows[i]
            # Real-token FLOPs: matmuls plus causal attention's
            # triangular sum; padding burns device time without them.
            self._prefill_flops += (self._flops_matmul_per_token * n
                                    + self._attn_flops_coeff * n * (n + 1)
                                    / 2.0)
        rec = self._prefill_bucket_tokens.setdefault(bucket, [0.0, 0.0])
        rec[0] += float(lengths[:b].sum())
        rec[1] += b_bucket * bucket
        with torch.inference_mode(), self._device_scope():
            p = self._sampling(list(group) + [None] * (b_bucket - b),
                               b_bucket)
            ids_d, lengths_d = self._to_device(ids), self._to_device(lengths)
            logits, caches = self.module(ids_d, kv_lengths=lengths_d,
                                         return_cache=True,
                                         logit_positions=lengths_d - 1)
            last = logits[:, 0]
            firsts = self._sample(last, p, lengths_d)
            dest_d = self._to_device(dest)
            for (pk, pv), (k, v) in zip(self._caches, caches):
                paged_insert(pk, pv, k, v, dest_d)
            del caches
            slot_d = self._to_device(slot_arr)
            self._feed_tokens[slot_d] = firsts
            self._feed_positions[slot_d] = lengths_d
            out = [firsts]
            if p.want_lp:
                out += list(self._logprob_of(last, firsts))
            return self._start_fetch(out)

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
        """Pop the front run of pending requests that share a prefill
        bucket, up to the free slot count, planning each one's blocks;
        strict FIFO.  A request the pool cannot hold yet stays pending.
        Returns (group, slots, bucket, dest_rows)."""
        free = [i for i, s in enumerate(self._slots) if s is None]
        group: List[_Request] = []
        bucket = 0
        dest_rows: List[List[int]] = []
        while self._pending and len(group) < len(free):
            b = self._bucket_for(self._pending[0].prompt_ids.size)
            if not group:
                bucket = b
            elif b != bucket:
                break
            plan = self._plan_prompt_blocks(self._pending[0],
                                            free[len(group)])
            if plan is None:
                break  # pool pressure: wait for released blocks
            dest_rows.append(plan)
            group.append(self._pending.popleft())
        return group, free[:len(group)], bucket, dest_rows

    async def _run_inner(self):
        loop = asyncio.get_running_loop()
        # Decode waves and prefill groups share one FIFO of dispatched,
        # unfetched work: ("decode" | "prefill", fetch future, meta, t0).
        inflight: deque = deque()
        try:
            await self._run_pipeline(loop, inflight)
        finally:
            for item in inflight:
                item[1].add_done_callback(
                    lambda f: f.cancelled() or f.exception())

    async def _admit(self, loop, inflight: deque) -> bool:
        """Admit pending requests while slots and blocks allow."""
        admitted = False
        while (not self._growth_starved and self._pending
               and self._free_slot() is not None):
            group, slots, bucket, dest_rows = self._take_prefill_group()
            if not group:
                break  # pool pressure: wait for frees
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

    def _preempt_or_hold(self) -> bool:
        """Grow every active slot's table; returns True to HOLD.  A slot
        the pool cannot grow is preempted: its request re-queues at the
        front with prompt = prompt + tokens so far, and resumes exactly
        (the noise is keyed on the absolute position).  While freed
        blocks are still maturing, the scheduler holds instead."""
        failed = self._ensure_block_capacity()
        if failed and self._deferred_frees:
            return True
        for i in failed:
            s = self._slots[i]
            if s is None:
                continue
            merged_len = int(s.req.prompt_ids.size) + len(s.tokens)
            if (merged_len > self.prefill_buckets[-1]
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
        return False

    async def _run_pipeline(self, loop, inflight: deque):
        while not self._closed:
            self._expire_deadlines()
            admitted = await self._admit(loop, inflight)
            active = any(s is not None for s in self._slots)
            if not active and not inflight:
                # Nothing in flight can write a block: release every
                # deferred free now.
                self._process_deferred_frees(force=True)
                self._growth_starved = False
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
            held = self._preempt_or_hold()
            self._growth_starved = held
            decodable = [] if held else [s for s in self._slots
                                         if s is not None]
            waves = sum(1 for it in inflight if it[0] == "decode")
            while decodable and waves < self.pipeline_depth:
                if (self.adaptive_depth and waves >= 1 and all(
                        s.req.max_new_tokens - s.generated
                        <= waves * self.steps_per_call
                        for s in decodable)):
                    # Every stream finishes within the waves in flight:
                    # another wave could only decode garbage.
                    self.suppressed_waves += 1
                    obs.generator_suppressed_waves_total().inc()
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
                raise
            now = time.perf_counter()
            busy = now - max(t0, self._last_fetch_done)
            self._last_fetch_done = now
            if kind == "decode":
                self._decode_device_s += busy
                self._decode_wait_s += wait_s
                self._distribute(fetched, lp, meta)
            else:
                self._prefill_device_s += busy
                self._prefill_wait_s += wait_s
                self._finish_prefill(fetched, lp, meta)
            self._process_deferred_frees()

    def _finish_prefill(self, firsts: np.ndarray, lp, entries):
        """Deliver a prefill batch's first tokens; a slot whose _Active
        changed since enqueue (cancel) discards its row."""
        self.prefills += 1
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
            self._free_slot_state(slot)
            self.requests_finished += 1
        else:
            s.last_token = token

    def _distribute(self, tokens: np.ndarray, lp, snapshot):
        """tokens [S, K]: deliver each slot's steps in order.  A slot
        consumes its row only if the _Active it held at enqueue is still
        there; freed slots' rows are garbage (counted as waste), and a
        slot finishing mid-wave discards the rest of its row."""
        k = tokens.shape[1]
        self._token_steps += k
        resident_tokens = 0
        for i, s in enumerate(snapshot):
            if s is None:
                continue
            if self._slots[i] is not s:
                self._wasted_token_steps += k
                continue
            self._occupied_slot_steps += k
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
