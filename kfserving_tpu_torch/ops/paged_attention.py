"""Paged KV-cache attention: the CUDA decode kernel
``csrc/paged_attention.cu``, its plain PyTorch version, and the paged
cache's writes and multi-token attention.

Port of ``kfserving_tpu/ops/paged_attention.py``.  A shared block pool
``[NB, BS, H, D]`` per layer plus a per-slot block table ``[B, MB]``
(int32, -1 = unallocated) replaces the dense ``[S, max_seq, H, D]`` slot
cache, so device memory scales with resident tokens and identical prompt
prefixes share blocks.

Contract of the decode attention (per layer):
    q           [B, 1, H, D]   the step's query
    pool_k/v    [NB', BS, H, D] block pools
    block_table [B, MB] int32  block ids per row, -1 = unallocated
    lengths     [B] int32      valid tokens INCLUDING the step just
                               written; a row of length 0 gives 0, and a
                               length past MB * BS reads the whole table
Returns [B, 1, H, D].

The sink block.  Torch has no ``mode="drop"`` scatter, and filtering the
indices on the host would cost a device sync per step.  The engine
therefore allocates ``NB + 1`` blocks and never names the last one in a
table: ``paged_write`` and ``paged_insert`` send every write that must
drop (a -1 table entry, a position past the table, a -1 destination) to
that sink block, which nothing reads.  The caller reports ``NB``.

On a CPU tensor ``paged_attention_kernel`` runs ``paged_attention_plain``;
on a CUDA tensor it launches the kernel or raises.  The kernel takes the
head dims in ``SUPPORTED_HEAD_DIMS`` in bf16 and fp32 and has two paths
(``kernel_path``): bf16 at head dims 64, 128, 192 and 256 (the TPU
kernel's multiples of 64) takes the hopper path, a ring of bulk copies of
all heads of a token span, split over the card by ``split_plan``; float32,
and bf16 at head dims 16, 32, 80 and 96, take the simple flash-decoding
path.
"""

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch

from kfserving_tpu_torch.ops import launches
from kfserving_tpu_torch.protocol.errors import InvalidInput

# Head dims and dtypes the kernel is instantiated for: the TPU kernels'
# multiples of 64 up to 256, the tiny configs' 16 and 32, and 80 and 96
# (ViT-H/14 and Phi-2, GPT-NeoX-20B).  K1 takes the same set.
SUPPORTED_HEAD_DIMS = (16, 32, 64, 80, 96, 128, 192, 256)
SUPPORTED_DTYPES = (torch.bfloat16, torch.float32)
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
# Head dims the hopper path takes in bf16; every other supported
# (dtype, head dim) takes the simple path.
HOPPER_HEAD_DIMS = (64, 128, 192, 256)
# Simple path: tokens of one row's walk that one thread block covers; a
# combine pass merges the partitions (flash decoding).  Keep equal to
# PARTITION_TOKENS in csrc/paged_attention.cu.
PARTITION_TOKENS = 256
_MAX_GRID_YZ = 65535

# Hopper path (split_plan): the defaults, the fastest plan at every decode
# case of tools/paged_sweep.py on an H100 (PERF.md, PR 18).
SPAN_STAGE_BYTES = 48 * 1024   # K + V of one ring stage, at most
SPAN_STAGES = 2                # ring stages
SPAN_TOKENS = 64               # tokens of one partial (at least a tile)
SPAN_CONSUMERS = 512           # consumer threads of a CTA, at most
SPAN_CTAS_PER_SM = 1           # resident CTAs an SM is planned for
SMEM_PER_SM = 233472           # 228 KB, of which 1 KB is reserved per CTA
# Equal to MAX_CONSUMERS, LANE_ELEMS and SMEM_LIMIT in the .cu.
SPAN_MAX_CONSUMERS = 512
SPAN_LANE_ELEMS = 8            # bf16 in one 16-byte load
SMEM_PER_CTA = 232448          # 227 KB


def span_lanes(D: int) -> int:
    """Lanes of one (token, head) row on the hopper path (row_lanes in
    the .cu): its D / 8 vectors rounded up to a power of two, at most a
    warp; 32 with 8 idle at D = 192."""
    lanes = 1
    while lanes < D // SPAN_LANE_ELEMS and lanes < 32:
        lanes *= 2
    return lanes

_fn = None
_hopper_fn = None


def _check_shapes(q, pool_k, pool_v, block_table, lengths
                  ) -> Tuple[int, int, int, int, int]:
    if q.dim() != 4 or pool_k.dim() != 4:
        raise ValueError("q must be [B, Lq, H, D] and the pools "
                         "[NB, BS, H, D]")
    B, _, H, D = q.shape
    if pool_k.shape[2:] != (H, D) or pool_v.shape != pool_k.shape:
        raise ValueError(
            f"pool shapes {tuple(pool_k.shape)}/{tuple(pool_v.shape)} do "
            f"not match q's heads {(H, D)}")
    if block_table.dim() != 2 or block_table.shape[0] != B:
        raise ValueError(f"block_table must be [{B}, MB], got "
                         f"{tuple(block_table.shape)}")
    if lengths.shape != (B,):
        raise ValueError(f"lengths must be [{B}], got "
                         f"{tuple(lengths.shape)}")
    return B, H, D, pool_k.shape[1], block_table.shape[1]


def _gather(pool: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """[B, MB * BS, H, D] fp32 view of each row's blocks; -1 entries read
    block 0 (masked by the caller), as the JAX gather clamps them."""
    b, mb = block_table.shape
    _, bs, h, d = pool.shape
    table = block_table.long().clamp(0, pool.shape[0] - 1)
    return pool[table].reshape(b, mb * bs, h, d).float()


def paged_attention_plain(q: torch.Tensor, pool_k: torch.Tensor,
                          pool_v: torch.Tensor, block_table: torch.Tensor,
                          lengths: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch (``paged_attention_xla`` in
    fp32): gather the table's blocks, mask keys at or past each row's
    length, softmax in fp32.  A row with no valid key gives exactly 0, as
    the kernel's ``acc / max(l, 1e-30)`` does."""
    B, H, D, BS, MB = _check_shapes(q, pool_k, pool_v, block_table,
                                    lengths)
    k = _gather(pool_k, block_table)
    v = _gather(pool_v, block_table)
    keys = torch.arange(MB * BS, device=q.device)
    valid = (keys[None, :] < lengths.to(q.device).long()[:, None])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) / math.sqrt(D)
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)  # noqa: E741
    out = torch.einsum("bhqk,bkhd->bqhd", p / l, v)
    return out.to(q.dtype)


def check_head_dim(dtype: torch.dtype, head_dim: int) -> None:
    """Raises InvalidInput for a (dtype, head dim) the kernel is not built
    for, naming what it takes."""
    if dtype not in SUPPORTED_DTYPES or head_dim not in SUPPORTED_HEAD_DIMS:
        raise InvalidInput(
            f"the paged decode kernel takes dtypes {SUPPORTED_DTYPES} and "
            f"head dims {SUPPORTED_HEAD_DIMS}, not {dtype} and head dim "
            f"{head_dim}")


def kernel_path(dtype: torch.dtype, head_dim: int) -> str:
    """Which of the kernel's paths a CUDA call takes: "hopper" (bf16 at
    head dims 64, 128, 192 and 256) or "simple" (the rest)."""
    if dtype == torch.bfloat16 and head_dim in HOPPER_HEAD_DIMS:
        return "hopper"
    return "simple"


@dataclass(frozen=True)
class SplitPlan:
    """The hopper path's launch: a grid of ``ctas`` x ``head_groups`` CTAs,
    each with ``consumers`` threads plus a producer warp and
    ``smem_bytes`` of shared memory, staging ``tile_tokens`` tokens of
    ``head_group`` heads per ring stage over ``stages`` stages;
    ``groups_per_head`` lane groups share one head's tokens.  Each row's
    partials are its spans of ``span_tokens`` tokens, and a CTA takes
    whole spans, so a row's output never depends on the other rows."""
    head_group: int
    head_groups: int
    tile_tokens: int
    span_tokens: int
    stages: int
    groups_per_head: int
    consumers: int
    smem_bytes: int
    ctas: int


def span_smem_bytes(D: int, head_group: int, tile_tokens: int,
                    stages: int, groups_per_head: int) -> int:
    """Shared memory of one CTA (span_smem_bytes in the .cu): the ring
    (K and V of each stage), the span merge's two scratch buffers, the
    barriers and the CTA's share."""
    return (2 * stages * tile_tokens * head_group * D * 2
            + 2 * groups_per_head * head_group * (D + 2) * 4
            + 2 * stages * 8 + 16)


def split_plan(B: int, H: int, D: int, BS: int, MB: int, sm_count: int,
               stage_bytes: int = SPAN_STAGE_BYTES,
               stages: int = SPAN_STAGES,
               ctas_per_sm: int = SPAN_CTAS_PER_SM,
               consumers: int = SPAN_CONSUMERS,
               span_tokens: int = SPAN_TOKENS) -> SplitPlan:
    """The hopper path's plan from the shapes and the card's SM count; no
    length is read, so the launch is static (CUDA graphs capture it).

    A head group is every head, unless one token's K and V of all heads
    overflow a stage or its lane groups overflow the CTA.  A tile is the
    largest power of two of tokens dividing BS whose K and V fit a stage,
    so a tile never crosses a pool block; a span is ``span_tokens``
    tokens, or a tile if that is longer.  The grid fills ``ctas_per_sm``
    CTAs on every SM (fewer where shared memory does not hold them), and
    the kernel divides all rows' spans evenly among them."""
    if B * MB * BS >= 2 ** 31:
        raise ValueError(f"B * MB * BS = {B * MB * BS} tokens overflow the "
                         "kernel's 32-bit token counts")
    lpg = span_lanes(D)                 # lanes of one (token, head) row
    row = D * 2                         # bytes of one (token, head) row

    def min_groups(hg):                 # whole warps of consumers
        return 32 // math.gcd(32, lpg * hg)

    head_group = next(
        hg for hg in range(H, 0, -1)
        if H % hg == 0 and 2 * hg * row <= stage_bytes
        and lpg * hg * min_groups(hg) <= SPAN_MAX_CONSUMERS)
    groups = 1
    while lpg * head_group * groups * 2 <= consumers:
        groups *= 2
    groups = max(groups, min_groups(head_group))
    tile = 1
    while BS % (2 * tile) == 0 and 2 * 2 * tile * head_group * row \
            <= stage_bytes:
        tile *= 2
    smem = span_smem_bytes(D, head_group, tile, stages, groups)
    if smem > SMEM_PER_CTA:
        raise ValueError(f"a plan of {stages} stages of {tile} tokens needs "
                         f"{smem} bytes of shared memory, over "
                         f"{SMEM_PER_CTA}")
    per_sm = max(1, min(ctas_per_sm, SMEM_PER_SM // (smem + 1024)))
    head_groups = H // head_group
    return SplitPlan(
        head_group=head_group, head_groups=head_groups, tile_tokens=tile,
        span_tokens=max(span_tokens, tile), stages=stages,
        groups_per_head=groups,
        consumers=lpg * head_group * groups, smem_bytes=smem,
        ctas=max(1, sm_count * per_sm // head_groups))


def span_slots(B: int, MB: int, BS: int, plan: SplitPlan) -> int:
    """Partial slots the merge needs at most: every row's spans at the
    longest length."""
    return B * -(-(MB * BS) // plan.span_tokens)


def split_tiles(plan: SplitPlan, lengths: Sequence[int], max_tokens: int
                ) -> List[Tuple[int, int, int, int, int]]:
    """The tiles the hopper path stages for these lengths, as (CTA, slot,
    row, first token, tokens): the kernel's division of all rows' spans,
    laid end to end, into equal shares of ``min(ctas, spans)`` CTAs, and
    its walk over each share; a span's partial goes to its slot, its index
    among all spans.  The CPU tests hold it to its contract; the kernel
    does the same arithmetic on the device."""
    lens = [min(max(int(n), 0), max_tokens) for n in lengths]
    span, tt = plan.span_tokens, plan.tile_tokens
    spans = [-(-n // span) for n in lens]
    total = sum(spans)
    ctas = min(plan.ctas, total)
    tiles = []
    for g in range(ctas):
        begin, end = g * total // ctas, (g + 1) * total // ctas
        row, before = 0, 0
        while before + spans[row] <= begin:
            before += spans[row]
            row += 1
        pos, left, slot = (begin - before) * span, end - begin, begin
        while left > 0:
            n = min(lens[row] - pos, tt - pos % tt)
            tiles.append((g, slot, row, pos, n))
            pos += n
            if pos != lens[row] and pos % span:
                continue
            left -= 1
            slot += 1
            if pos == lens[row] and left > 0:
                pos = 0
                row += 1
                while lens[row] == 0 and row + 1 < len(lens):
                    row += 1
    return tiles


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def bind(lib: ctypes.CDLL, symbol: str):
    """One of the library's C entry points with its argument types:
    pointers, then ints, then the scale and the stream."""
    pointers, ints = {"kfs_paged_attention": (8, 7),
                      "kfs_paged_attention_hopper": (9, 11)}[symbol]
    fn = getattr(lib, symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * ints
                   + [ctypes.c_float, ctypes.c_void_p])
    return fn


def _kernel():
    global _fn
    if _fn is None:
        from kfserving_tpu_torch.csrc import build

        _fn = bind(build.load("paged_attention"), "kfs_paged_attention")
    return _fn


def _hopper_kernel():
    global _hopper_fn
    if _hopper_fn is None:
        from kfserving_tpu_torch.csrc import build

        _hopper_fn = bind(build.load("paged_attention"),
                          "kfs_paged_attention_hopper")
    return _hopper_fn


def _check_cuda_operands(q, pool_k, pool_v, block_table, lengths, D):
    if q.dtype not in SUPPORTED_DTYPES:
        raise ValueError(f"paged_attention kernel takes bfloat16 or "
                         f"float32, got {q.dtype}")
    if pool_k.dtype != q.dtype or pool_v.dtype != q.dtype:
        raise ValueError("q and the pools must share one dtype")
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"paged_attention kernel supports head dims "
                         f"{SUPPORTED_HEAD_DIMS}, got {D}")
    if q.shape[1] != 1:
        raise ValueError(f"paged_attention kernel decodes one query per "
                         f"row, got Lq = {q.shape[1]}")
    for name, t in (("pool_k", pool_k), ("pool_v", pool_v),
                    ("block_table", block_table), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("pool_k", pool_k), ("pool_v", pool_v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary "
                             "for the kernel's vector loads")
    if block_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("block_table and lengths must be int32")


def paged_attention_kernel(q: torch.Tensor, pool_k: torch.Tensor,
                           pool_v: torch.Tensor, block_table: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """Single-token decode attention over the block pools (the contract in
    the module docstring).  CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    B, H, D, BS, MB = _check_shapes(q, pool_k, pool_v, block_table,
                                    lengths)
    if q.device.type == "cpu":
        return paged_attention_plain(q, pool_k, pool_v, block_table,
                                     lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda (kernel) or cpu "
                         f"(plain version), not {q.device.type}")
    q = q.contiguous()
    _check_cuda_operands(q, pool_k, pool_v, block_table, lengths, D)
    if B > _MAX_GRID_YZ or H > _MAX_GRID_YZ:
        raise ValueError(f"B = {B} or H = {H} exceeds the kernel grid's "
                         f"{_MAX_GRID_YZ}")
    if kernel_path(q.dtype, D) == "hopper":
        out = launch_hopper(q, pool_k, pool_v, block_table, lengths,
                            split_plan(B, H, D, BS, MB, _sm_count(q.device)))
    else:
        out = _launch_simple(q, pool_k, pool_v, block_table, lengths)
    launches.count(paged_attention_kernel)
    return out


# Kernel executions since the count was last set to 0, graph replays
# included (ops/launches.py; chip_smoke.py reads it to show that the
# decode path ran through the kernel).
paged_attention_kernel.launches = 0


def _launch_simple(q: torch.Tensor, pool_k: torch.Tensor,
                   pool_v: torch.Tensor, block_table: torch.Tensor,
                   lengths: torch.Tensor) -> torch.Tensor:
    """The simple path (operands checked by the caller)."""
    B, _, H, D = q.shape
    BS, MB = pool_k.shape[1], block_table.shape[1]
    out = torch.empty_like(q)
    parts = -(-(MB * BS) // PARTITION_TOKENS)
    part_acc = torch.empty((B, H, parts, D), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((B, H, parts, 2), dtype=torch.float32,
                          device=q.device)
    rc = _kernel()(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
                   block_table.data_ptr(), lengths.data_ptr(),
                   out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
                   B, H, D, BS, MB, parts, _DTYPE_CODE[q.dtype],
                   1.0 / math.sqrt(D),
                   torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"cudaError {rc}")
    return out


def launch_hopper(q: torch.Tensor, pool_k: torch.Tensor,
                  pool_v: torch.Tensor, block_table: torch.Tensor,
                  lengths: torch.Tensor, plan: SplitPlan,
                  kernel=None) -> torch.Tensor:
    """The hopper path under ``plan`` (operands checked by the caller:
    bf16, a head dim of ``HOPPER_HEAD_DIMS``, contiguous, on one card),
    through the built
    library's entry point unless ``kernel`` names another build's.  The
    wrapper passes ``split_plan``'s plan; tools/paged_sweep.py times
    others."""
    B, _, H, D = q.shape
    BS, MB = pool_k.shape[1], block_table.shape[1]
    out = torch.empty_like(q)
    # One scratch buffer: part_acc [slots, H, D], part_ml [slots, H, 2]
    # and row_first [B] (int32).
    slots = span_slots(B, MB, BS, plan)
    scratch = torch.empty(slots * H * (D + 2) + B, dtype=torch.float32,
                          device=q.device)
    part_ml = scratch[slots * H * D:]
    row_first = scratch[slots * H * (D + 2):].view(torch.int32)
    rc = (kernel or _hopper_kernel())(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
        block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), part_ml.data_ptr(), row_first.data_ptr(), B, H,
        D, BS, MB, plan.head_group, plan.tile_tokens, plan.span_tokens,
        plan.stages, plan.groups_per_head, plan.ctas, 1.0 / math.sqrt(D),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention hopper kernel launch failed: "
                           f"cudaError {rc}")
    return out


# The decode attention the decoder calls, under the JAX dispatcher's name.
# It is the kernel wrapper itself: on the card there is no gate and no
# switch that reroutes a call to the plain version (an unsupported dtype,
# head dim or Lq raises), and a CPU tensor runs the plain version.
paged_attention = paged_attention_kernel


def paged_slots(block_table: torch.Tensor, positions: torch.Tensor,
                pool_blocks: int, block_size: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(block, offset) of each position's cache write, positions [B] or
    [B, L].  A -1 table entry, or a position past the table's coverage,
    maps to the sink block (``pool_blocks - 1``, the pools' last) — never
    a clamp, which would land inside another position's block."""
    sink = pool_blocks - 1
    mb = block_table.shape[1]
    positions = positions.long()
    block_idx = torch.div(positions, block_size, rounding_mode="floor")
    offs = positions.remainder(block_size)
    rows = torch.arange(block_table.shape[0], device=positions.device)
    if positions.dim() == 2:
        rows = rows[:, None]
    blocks = block_table[rows, block_idx.clamp(0, mb - 1)].long()
    drop = (blocks < 0) | (block_idx >= mb) | (positions < 0)
    return torch.where(drop, torch.full_like(blocks, sink), blocks), offs


def paged_write(pool_k: torch.Tensor, pool_v: torch.Tensor,
                k_step: torch.Tensor, v_step: torch.Tensor,
                block_table: torch.Tensor, positions: torch.Tensor,
                slots=None):
    """Write a step's k/v into the pools, in place, at each row's
    positions.  Two call shapes:

      decode:        k/v [B, H, D],    positions [B]
      chunk prefill: k/v [B, L, H, D], positions [B, L]

    Writes that must drop land in the sink block (``paged_slots``).
    ``slots``, when given, is ``paged_slots`` of these positions, computed
    once for all the layers of a step.  Returns the pools."""
    if slots is None:
        slots = paged_slots(block_table, positions, pool_k.shape[0],
                            pool_k.shape[1])
    blocks, offs = slots
    pool_k[blocks, offs] = k_step.to(pool_k.dtype)
    pool_v[blocks, offs] = v_step.to(pool_v.dtype)
    return pool_k, pool_v


def paged_prefill_attention(q: torch.Tensor, pool_k: torch.Tensor,
                            pool_v: torch.Tensor, block_table: torch.Tensor,
                            q_positions: torch.Tensor) -> torch.Tensor:
    """Multi-token queries over the paged pool with per-query causal
    masking (a query at absolute position p attends keys at positions
    <= p); plain PyTorch, the port of ``paged_prefill_attention_xla``.

    q [B, L, H, D], q_positions [B, L] int.  Returns [B, L, H, D]."""
    D = q.shape[-1]
    mb, bs = block_table.shape[1], pool_k.shape[1]
    k = _gather(pool_k, block_table)
    v = _gather(pool_v, block_table)
    key_pos = torch.arange(mb * bs, device=q.device)[None, None, :]
    mask = (key_pos <= q_positions.long()[:, :, None])[:, None]  # [B,1,L,K]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) / math.sqrt(D)
    logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", weights, v)
    return out.to(q.dtype)


def paged_insert(pool_k: torch.Tensor, pool_v: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor,
                 dest_blocks: torch.Tensor):
    """Insert a prefill batch's k/v ([B, L, H, D], L a multiple of BS)
    into pool blocks, in place.  dest_blocks [B, L / BS] int: the
    destination block of each L-chunk of each row; -1 chunks (bucket
    padding rows, prefix-cache hits whose blocks already hold the data)
    drop into the sink block.  Returns the pools."""
    b, l, h, d = k_new.shape
    bs = pool_k.shape[1]
    chunks = l // bs
    if chunks * bs != l:
        raise ValueError(f"prefill length {l} is not a multiple of the "
                         f"block size {bs}")
    sink = pool_k.shape[0] - 1
    dest = dest_blocks.long().reshape(b * chunks)
    dest = torch.where(dest < 0, torch.full_like(dest, sink), dest)
    pool_k[dest] = k_new.reshape(b * chunks, bs, h, d).to(pool_k.dtype)
    pool_v[dest] = v_new.reshape(b * chunks, bs, h, d).to(pool_v.dtype)
    return pool_k, pool_v
