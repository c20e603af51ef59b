"""Decoder-only transformer (GPT-class) with KV-cache serving modes.

Port of ``kfserving_tpu/models/decoder.py``: pre-LN blocks with the
tanh-approximate GELU, LayerNorm with fp32 statistics, a learned position
table whose index is clamped to ``max_seq - 1``, and the LM head tied to
the token embedding, computed in the config dtype with fp32 logits.  One
module, these executions:

- **full**: ``input_ids [B, L] -> logits [B, L, V]``, causal attention.
- **prefill**: the same with ``return_cache=True`` (per-layer (k, v)
  [B, L, H, D] come back too) and ``kv_lengths`` for suffix padding; the
  causal + lengths attention runs the CUDA flash kernel on the card.
- **paged decode / chunk prefill**: ``kv_cache`` is a list of per-layer
  (pool_k, pool_v, block_table) 3-tuples, all with one block table and
  one pool geometry (layer 0's give every layer's write slots).  The
  step's k/v are written into the pools IN PLACE (the JAX module returns
  new pools; here the engine's pools update on one CUDA stream, so no
  second copy exists), then Lq == 1 attends through the paged decode
  kernel and Lq > 1 with per-query causal masking.  The returned caches
  are the same pools.
- **dense decode / verify**: ``kv_cache`` of (k_cache, v_cache)
  [B, M + 1, H, D] 2-tuples: positions [0, M) hold keys, and the last
  position is a sink that every write outside [0, M) lands in (a parked
  row's, or one past the window), so the step writes IN PLACE and the
  engine holds one cache (the JAX module returns new caches, written
  with ``mode="drop"``).  A query at position p attends the keys at
  positions <= p over the window, with the masked plain attention (XLA
  in the reference).  The returned caches are the same tensors.

``logit_positions`` ([B] or [B, P]) runs the final norm and head only at
those positions.  ``stepwise=True`` (with a cache) runs a multi-token
step position by position at the decode step's shapes, so each
position's logits are a sequential decode's bit for bit (the speculative
verify).  Every gather index (positions, logit positions) is
clamped explicitly: on CUDA an out-of-range gather is a device assert.
"""

from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from kfserving_tpu_torch.models.bert import (
    LayerNorm,
    as_torch_dtype,
    row_parallel,
)
from kfserving_tpu_torch.ops import dot_product_attention
from kfserving_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_prefill_attention,
    paged_slots,
    paged_write,
)


class DecoderConfig:
    def __init__(self, vocab_size=32000, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=3072, max_seq=1024,
                 layer_norm_eps=1e-5, dtype=torch.bfloat16, attn_fn=None):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size
        self.max_seq = max_seq
        self.layer_norm_eps = layer_norm_eps
        self.dtype = as_torch_dtype(dtype)
        # Pluggable full/prefill attention (q, k, v, mask) -> out, mask
        # the boolean [B, 1, L, L] causal (and padding) mask.
        self.attn_fn = attn_fn
        # Set by parallel/sharding.py::shard_module under a mesh: the
        # rank holds its heads (and its slice of the MLP), and the out
        # and mlp_out projections all-reduce over this group.
        self.tp_group = None

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads


class DecoderBlock(nn.Module):
    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.cfg = cfg
        hidden = cfg.hidden_size
        self.attn_norm = LayerNorm(hidden, cfg.layer_norm_eps)
        self.query = nn.Linear(hidden, hidden, dtype=cfg.dtype)
        self.key = nn.Linear(hidden, hidden, dtype=cfg.dtype)
        self.value = nn.Linear(hidden, hidden, dtype=cfg.dtype)
        self.out = nn.Linear(hidden, hidden, dtype=cfg.dtype)
        self.mlp_norm = LayerNorm(hidden, cfg.layer_norm_eps)
        self.mlp_in = nn.Linear(hidden, cfg.intermediate_size,
                                dtype=cfg.dtype)
        self.mlp_out = nn.Linear(cfg.intermediate_size, hidden,
                                 dtype=cfg.dtype)

    def forward(self, hidden: torch.Tensor, *,
                kv_lengths: Optional[torch.Tensor] = None,
                cache: Optional[tuple] = None,
                positions: Optional[torch.Tensor] = None,
                paged_step: Optional[tuple] = None,
                dense_step: Optional[tuple] = None):
        """paged_step / dense_step: with a paged or a dense ``cache``,
        what every layer of the step shares (``_paged_step``,
        ``_dense_step``)."""
        cfg = self.cfg
        B, L, _ = hidden.shape
        heads = (B, L, -1, cfg.head_dim)            # this rank's heads
        x = self.attn_norm(hidden)
        q = self.query(x).view(heads)
        k = self.key(x).view(heads)
        v = self.value(x).view(heads)
        if cache is not None and len(cache) == 3:
            pool_k, pool_v, table = cache
            slots, lengths = paged_step
            if L == 1:
                paged_write(pool_k, pool_v, k[:, 0], v[:, 0], table,
                            positions[:, 0], slots=slots)
                out = paged_attention(q, pool_k, pool_v, table, lengths)
            else:
                paged_write(pool_k, pool_v, k, v, table, positions,
                            slots=slots)
                out = paged_prefill_attention(q, pool_k, pool_v, table,
                                              positions)
            new_cache = (pool_k, pool_v)
        elif cache is not None:
            k_cache, v_cache = cache
            rows, dest, attn_mask = dense_step
            k_cache[rows, dest] = k.to(k_cache.dtype)
            v_cache[rows, dest] = v.to(v_cache.dtype)
            new_cache = (k_cache, v_cache)
            width = k_cache.shape[1] - 1
            out = dot_product_attention(q, k_cache[:, :width],
                                        v_cache[:, :width], mask=attn_mask)
        elif cfg.attn_fn is not None:
            mask = torch.ones((L, L), dtype=torch.bool,
                              device=hidden.device).tril()[None, None]
            if kv_lengths is not None:
                keys = torch.arange(L, device=hidden.device)
                pad = (keys[None, :] < kv_lengths.to(hidden.device)
                       [:, None])[:, None, None, :]
                mask = mask & pad
            out = cfg.attn_fn(q, k, v, mask)
            new_cache = (k, v)
        else:
            out = dot_product_attention(q, k, v, causal=True,
                                        kv_lengths=kv_lengths)
            new_cache = (k, v)
        hidden = hidden + row_parallel(self.out, out.reshape(B, L, -1),
                                       cfg.tp_group)
        x = F.gelu(self.mlp_in(self.mlp_norm(hidden)), approximate="tanh")
        return hidden + row_parallel(self.mlp_out, x, cfg.tp_group), \
            new_cache


def _paged_step(pool: torch.Tensor, table: torch.Tensor,
                positions: torch.Tensor) -> tuple:
    """What every layer of one paged step shares: the write slots of
    ``positions`` [B, L], and for a decode step (L == 1) the attended
    lengths, the written position + 1."""
    if positions.shape[1] == 1:
        pos = positions[:, 0]
        lengths = (pos + 1).to(torch.int32)
    else:
        pos, lengths = positions, None
    return paged_slots(table, pos, pool.shape[0], pool.shape[1]), lengths


def _dense_step(cache: torch.Tensor, positions: torch.Tensor) -> tuple:
    """What every layer of one dense-cache step shares, for positions
    [B, L]: the write rows and positions (a position outside the cache's
    window goes to its last position, the sink) and the attention mask
    over the window (a query at position p attends keys <= p)."""
    width = cache.shape[1] - 1
    pos = positions.long()
    rows = torch.arange(pos.shape[0], device=pos.device)[:, None]
    dest = torch.where((pos >= 0) & (pos < width), pos,
                       torch.full_like(pos, width))
    keys = torch.arange(width, device=pos.device)
    mask = (keys[None, None, :] <= pos[:, :, None])[:, None]
    return rows, dest, mask


class DecoderLM(nn.Module):
    """Token ids -> next-token logits, with optional KV-cache modes (see
    the module docstring).  Returns logits [B, L or P, V] (float32), plus
    the per-layer caches when ``kv_cache`` is given or ``return_cache``
    is set."""

    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.config = cfg
        self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                dtype=cfg.dtype)
        self.wpe = nn.Embedding(cfg.max_seq, cfg.hidden_size,
                                dtype=cfg.dtype)
        self.layers = nn.ModuleList(
            DecoderBlock(cfg) for _ in range(cfg.num_layers))
        self.final_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                kv_cache: Optional[Any] = None,
                kv_lengths: Optional[torch.Tensor] = None,
                return_cache: bool = False,
                logit_positions: Optional[torch.Tensor] = None,
                stepwise: bool = False):
        cfg = self.config
        if stepwise:
            return self._stepwise(input_ids, positions, kv_cache)
        B, L = input_ids.shape
        device = input_ids.device
        if positions is None:
            pos = torch.arange(L, device=device)[None, :].expand(B, L)
        else:
            pos = positions.reshape(B, -1).long()
        hidden = self.wte(input_ids.long())
        hidden = hidden + self.wpe(pos.clamp(0, cfg.max_seq - 1))
        # A paged step's write slots and lengths are computed once, from
        # layer 0: every layer shares one block table and pool geometry.
        paged_step = dense_step = None
        if kv_cache is not None and len(kv_cache[0]) == 3:
            pool0, _, table = kv_cache[0]
            paged_step = _paged_step(pool0, table, pos)
        elif kv_cache is not None:
            dense_step = _dense_step(kv_cache[0][0], pos)
        caches = []
        for i, layer in enumerate(self.layers):
            hidden, new_cache = layer(
                hidden, kv_lengths=kv_lengths,
                cache=None if kv_cache is None else kv_cache[i],
                positions=None if kv_cache is None else pos,
                paged_step=paged_step, dense_step=dense_step)
            caches.append(new_cache)
        if logit_positions is not None:
            idx = logit_positions.reshape(B, -1, 1).long().clamp(0, L - 1)
            hidden = torch.take_along_dim(hidden, idx, dim=1)
        hidden = self.final_norm(hidden)
        logits = F.linear(hidden, self.wte.weight).float()
        if kv_cache is not None or return_cache:
            return logits, caches
        return logits

    def _stepwise(self, input_ids: torch.Tensor, positions: torch.Tensor,
                  kv_cache: Any):
        """Lq positions of a cached step, each run at the single-token
        decode step's shapes: layer by layer, every position's products
        at M = B and its attention through the decode path (the paged
        kernel, or the dense masked attention), logits at every
        position [B, Lq, V].  A product's rounding on the card depends
        on its shape, so only this gives each position the logits a
        sequential decode computes, bit for bit; a layer's weights serve
        all Lq positions back to back (from L2 on the card)."""
        cfg = self.config
        B, L = input_ids.shape
        pos = positions.reshape(B, -1).long()
        hidden = self.wte(input_ids.long())
        hidden = hidden + self.wpe(pos.clamp(0, cfg.max_seq - 1))
        cols = [pos[:, j:j + 1] for j in range(L)]
        if len(kv_cache[0]) == 3:
            pool0, _, table = kv_cache[0]
            steps = [dict(paged_step=_paged_step(pool0, table, c))
                     for c in cols]
        else:
            steps = [dict(dense_step=_dense_step(kv_cache[0][0], c))
                     for c in cols]
        hs = [hidden[:, j:j + 1].contiguous() for j in range(L)]
        for i, layer in enumerate(self.layers):
            hs = [layer(h, cache=kv_cache[i], positions=c, **st)[0]
                  for h, c, st in zip(hs, cols, steps)]
        logits = torch.cat([
            F.linear(self.final_norm(h), self.wte.weight).float()
            for h in hs], dim=1)
        return logits, [tuple(c[:2]) for c in kv_cache]

    def flops(self, batch: int, seq: Optional[int]) -> float:
        """Multiply-add operations (x2) of one full forward at this
        shape, causal attention counted over the triangle; 0 without a
        sequence length (not counted)."""
        if seq is None:
            return 0.0
        cfg = self.config
        h, i, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
        tokens = batch * seq
        dense = cfg.num_layers * (4 * h * h + 2 * h * i) + h * v
        attention = cfg.num_layers * 2 * batch * seq * (seq + 1) * h
        return float(2 * tokens * dense + attention)


def decoder_small(**overrides) -> DecoderConfig:
    """GPT-2-small-class config (124M at vocab 50257)."""
    defaults = dict(vocab_size=50257, hidden_size=768, num_layers=12,
                    num_heads=12, intermediate_size=3072, max_seq=1024)
    defaults.update(overrides)
    return DecoderConfig(**defaults)


def decoder_tiny(**overrides) -> DecoderConfig:
    """4-layer/128-wide config for hermetic CPU tests; vocab 384 covers
    the byte tokenizer's 258 ids."""
    defaults = dict(vocab_size=384, hidden_size=128, num_layers=4,
                    num_heads=4, intermediate_size=512, max_seq=256,
                    dtype=torch.float32)
    defaults.update(overrides)
    return DecoderConfig(**defaults)


def create_decoder(config: Optional[DecoderConfig] = None,
                   seq_len: int = 64):
    """Returns (module on the meta device, example input ids)."""
    cfg = config or decoder_small()
    with torch.device("meta"):
        module = DecoderLM(cfg)
    return module, np.zeros((1, seq_len), np.int32)


def _create_decoder_small(**kw):
    """Registry factory: 'decoder'."""
    seq_len = kw.pop("seq_len", 64)
    return create_decoder(decoder_small(**kw) if kw else None,
                          seq_len=seq_len)


def _create_decoder_tiny(seq_len=32, **kw):
    """Registry factory: 'decoder_tiny'."""
    return create_decoder(decoder_tiny(**kw), seq_len=seq_len)
