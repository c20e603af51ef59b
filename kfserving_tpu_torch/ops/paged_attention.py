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
on a CUDA tensor it launches the kernel or raises.
"""

import ctypes
import math
from typing import Tuple

import torch

from kfserving_tpu_torch.ops import launches

# Head dims and dtypes the kernel is instantiated for.
SUPPORTED_HEAD_DIMS = (32, 64, 128)
SUPPORTED_DTYPES = (torch.bfloat16, torch.float32)
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
# Tokens of one row's walk that one thread block of the kernel covers;
# a combine pass merges the partitions (flash decoding).  Keep equal to
# PARTITION_TOKENS in csrc/paged_attention.cu.
PARTITION_TOKENS = 256
_MAX_GRID_YZ = 65535

_fn = None


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


def _kernel():
    global _fn
    if _fn is None:
        from kfserving_tpu_torch.csrc import build

        fn = build.load("paged_attention").kfs_paged_attention
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
        _fn = fn
    return _fn


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
    parts = -(-(MB * BS) // PARTITION_TOKENS)
    out = torch.empty_like(q)
    part_acc = torch.empty((B, H, parts, D), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((B, H, parts, 2), dtype=torch.float32,
                          device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _kernel()(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
                   block_table.data_ptr(), lengths.data_ptr(),
                   out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
                   B, H, D, BS, MB, parts, _DTYPE_CODE[q.dtype],
                   1.0 / math.sqrt(D), stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"cudaError {rc}")
    launches.count(paged_attention_kernel)
    return out


# Kernel executions since the count was last set to 0, graph replays
# included (ops/launches.py; chip_smoke.py reads it to show that the
# decode path ran through the kernel).
paged_attention_kernel.launches = 0


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
