"""Ring attention: sequence-parallel attention over the ``sp`` ranks.

Port of ``kfserving_tpu/parallel/ring_attention.py``.  For contexts too
long for one card, the sequence axis shards over the mesh's ``sp`` dim.
Each rank holds its local Q/K/V block; K/V blocks (with their key mask)
rotate around the ring (``dist.batch_isend_irecv``) while every rank
folds each visiting block into a running online-softmax accumulator: the
JAX package's fp32 math (``-1e30`` for masked scores, the normalizer
clamped at ``1e-30``, causal positions from the block owner's index).
After sp steps every query has attended to the full sequence; the next
block's exchange is posted before the current block is folded.

The fold is plain torch, as the JAX fold is plain ``jnp`` (no Pallas
kernel to port).  Two entry points:

- ``ring_attention(q, k, v, mesh, ...)`` takes the global [B, L, H, D]
  tensors on every rank, as the JAX function does, and returns the global
  output: each rank folds its block (through the hook below), and the
  blocks are gathered.
- ``ring_attention_sharded(mesh, ...)`` is the model zoo's ``attn_fn``
  hook over *local* blocks: under ``sp`` the port keeps activations
  sequence-sharded through the encoder (each rank embeds its block at its
  global positions), so the hook sees [B, L / sp, H, D] and a [B, 1, 1,
  L / sp] or [B, L / sp] key mask.
"""

from typing import Optional

import torch
import torch.distributed as dist

from kfserving_tpu_torch.parallel.mesh import (
    all_gather_cat,
    axis_index,
    axis_sizes,
    exchange,
)

_NEG_INF = -1e30


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_mask: Optional[torch.Tensor], group,
                         causal: bool = False) -> torch.Tensor:
    """One rank's body: q, k, v [B, L_local, H, D] local sequence
    blocks; kv_mask [B, L_local] bool (True = real token), rotating
    around the ring alongside its K/V block so padding never attends.
    Group rank i holds positions [i * L_local, (i + 1) * L_local)."""
    sp = dist.get_world_size(group) if group is not None else 1
    my_idx = dist.get_group_rank(group, dist.get_rank()) if sp > 1 else 0
    ranks = dist.get_process_group_ranks(group) if sp > 1 else [0]
    B, Lq, H, D = q.shape
    scale = 1.0 / D ** 0.5
    qf = q.float() * scale
    if kv_mask is None:
        kv_mask = torch.ones((B, k.shape[1]), dtype=torch.bool,
                             device=q.device)
    kv_mask = kv_mask.bool()
    acc = torch.zeros((B, Lq, H, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Lq, 1), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l_sum = torch.zeros((B, H, Lq, 1), dtype=torch.float32, device=q.device)
    k_blk, v_blk, m_blk = k, v, kv_mask
    nxt, prv = ranks[(my_idx + 1) % sp], ranks[(my_idx - 1) % sp]
    for i in range(sp):
        # Block owner index walks backwards around the ring from my_idx.
        block_idx = (my_idx - i) % sp
        # The last step's rotation would bring back the rank's own
        # block: it is skipped.
        incoming = (exchange([k_blk, v_blk, m_blk], nxt, prv, group)
                    if i + 1 < sp else None)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k_blk.float())
        Lk = k_blk.shape[1]
        if causal:
            q_pos = my_idx * Lq + torch.arange(Lq, device=q.device)[:, None]
            k_pos = block_idx * Lk + torch.arange(Lk, device=q.device)[None]
            s = torch.where((q_pos >= k_pos)[None, None], s,
                            torch.full_like(s, _NEG_INF))
        # [B, Lk] -> [B, 1, 1, Lk]: mask padded keys in this block.
        s = torch.where(m_blk[:, None, None, :], s,
                        torch.full_like(s, _NEG_INF))
        m_cur = s.amax(dim=-1, keepdim=True)                 # [B,H,Lq,1]
        m_new = torch.maximum(m, m_cur)
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l_sum = alpha * l_sum + p.sum(dim=-1, keepdim=True)
        pv = torch.einsum("bhqk,bkhd->bqhd", p, v_blk.float())
        acc = acc * alpha.permute(0, 2, 1, 3) + pv
        m = m_new
        if incoming is not None:
            k_blk, v_blk, m_blk = incoming()
    # Fully-masked query rows (padding) would divide by zero; clamp — their
    # outputs are sliced off / ignored downstream anyway.
    out = acc / l_sum.clamp_min(1e-30).permute(0, 2, 1, 3)
    return out.to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh, axis_name: str = "sp", causal: bool = False,
                   kv_mask: Optional[torch.Tensor] = None,
                   batch_axis: Optional[str] = "dp") -> torch.Tensor:
    """Sequence-parallel attention over global [B, L, H, D] tensors
    (every rank passes the same ones), L sharded on ``axis_name`` (and B
    on ``batch_axis`` when it divides).

    kv_mask: optional [B, L] bool/int padding mask (True = attend to that
    key position); it shards and rotates with the K/V blocks.  Returns
    the global output on every rank.
    """
    sizes = axis_sizes(mesh)
    sp = sizes.get(axis_name, 1)
    if q.shape[1] % sp:
        raise ValueError(
            f"sequence length {q.shape[1]} not divisible by mesh axis "
            f"{axis_name}={sp}")
    # Batch sharding is best-effort: a batch that can't split over dp is
    # replicated, sharded otherwise.
    if batch_axis is not None and (batch_axis not in sizes or
                                   q.shape[0] % sizes[batch_axis]):
        batch_axis = None
    if kv_mask is None:
        kv_mask = torch.ones(q.shape[:2], dtype=torch.bool, device=q.device)
    else:
        kv_mask = kv_mask.bool()

    def block(x):
        L = x.shape[1] // sp
        x = x[:, axis_index(mesh, axis_name) * L:][:, :L]
        if batch_axis is not None:
            b = x.shape[0] // sizes[batch_axis]
            x = x[axis_index(mesh, batch_axis) * b:][:b]
        return x

    # Each rank's blocks through the model zoo's hook, the key mask in
    # its [B, 1, 1, L] broadcast form.
    attn = ring_attention_sharded(mesh, axis_name, batch_axis, causal)
    out = attn(block(q), block(k), block(v), block(kv_mask)[:, None, None])
    if sp > 1:
        out = all_gather_cat(out, mesh.get_group(axis_name), dim=1)
    if batch_axis is not None and sizes[batch_axis] > 1:
        out = all_gather_cat(out, mesh.get_group(batch_axis), dim=0)
    return out


def ring_attention_sharded(mesh, axis_name: str = "sp",
                           batch_axis: Optional[str] = "dp",
                           causal: bool = False):
    """The model zoo's pluggable-attention hook (q, k, v, mask) over
    local sequence blocks, where mask is a broadcastable [B, 1, 1, L] or
    [B, L] key-padding mask.  The batch reaches the hook already split
    over ``batch_axis`` (the engine shards it before the forward), so
    only the ``axis_name`` ring runs here."""
    group = (mesh.get_group(axis_name)
             if axis_sizes(mesh).get(axis_name, 1) > 1 else None)

    def attn(q, k, v, mask=None):
        if mask is not None and mask.ndim == 4:
            # [B, 1, 1, L] (BERT-style broadcast mask) -> [B, L]
            mask = mask[:, 0, 0, :]
        return ring_attention_local(q, k, v, mask, group, causal=causal)
    return attn
