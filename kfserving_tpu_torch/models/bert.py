"""BERT encoder with an MLM head — the seq-len-bucketed serving config.

Port of ``kfserving_tpu/models/bert.py`` (BASELINE.json config #3,
"jaxserver BERT-base fill-mask (seq-len bucketed batching)").  Same
configuration kwargs, the same ``attn_fn`` and ``prefix_padding`` hooks,
the tanh-approximate GELU by default, LayerNorm eps 1e-12 with fp32
statistics, and the tied MLM decoder with fp32 logits plus ``mlm_bias``.

Attention sees [B, L, H, D] tensors, so padded sequence buckets reach the
CUDA flash kernel with their padding as per-row lengths.  Under tensor
parallelism (``parallel/sharding.py::shard_module``) each rank holds its
own heads and a slice of the MLP, and ``config.tp_group`` is set: the
attention output and MLP down projections all-reduce over it
(``row_parallel``).  Under sequence parallelism ``config.seq_shard``
(the rank's index along ``sp``) offsets the position ids of the rank's
sequence block.  Modules are
built on the meta device by the registry factories and materialized by
``models/weights.py`` (a Flax checkpoint or a seeded init).
"""

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from kfserving_tpu_torch.ops import dot_product_attention

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def as_torch_dtype(dtype: Any) -> torch.dtype:
    """A torch dtype from a torch dtype or its name (config.json form)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise ValueError(f"unsupported dtype {dtype!r}; "
                         f"known: {sorted(_DTYPES)}")


class BertConfig:
    def __init__(self, vocab_size=30522, hidden_size=768,
                 num_layers=12, num_heads=12, intermediate_size=3072,
                 max_position=512, type_vocab_size=2,
                 layer_norm_eps=1e-12, dtype=torch.bfloat16,
                 gelu_approximate=True, prefix_padding=True,
                 attn_fn=None):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size
        self.max_position = max_position
        self.type_vocab_size = type_vocab_size
        self.layer_norm_eps = layer_norm_eps
        self.dtype = as_torch_dtype(dtype)
        # tanh-approx gelu matches the JAX package's default; HF torch
        # BERT checkpoints ("gelu" = erf) set False.
        self.gelu_approximate = gelu_approximate
        # attention_mask is suffix key padding (what the batcher
        # produces), which the flash kernel takes as per-row lengths.
        self.prefix_padding = prefix_padding
        # Pluggable attention (q, k, v, mask) -> out, mask being the
        # broadcastable [B, 1, 1, L] key-padding mask (or None).
        self.attn_fn = attn_fn
        # Set by parallel/sharding.py::shard_module under a mesh.
        self.tp_group = None
        # Under sp: this rank's block index of the sequence (its inputs
        # are that block of every row).
        self.seq_shard = 0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


class LayerNorm(nn.Module):
    """LayerNorm with fp32 parameters and statistics, output in the
    input's dtype (Flax LayerNorm with param_dtype float32)."""

    def __init__(self, size: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(size))
        self.bias = nn.Parameter(torch.zeros(size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.weight.shape, self.weight,
                         self.bias, self.eps)
        return y.to(x.dtype)


def row_parallel(linear: nn.Linear, x: torch.Tensor, group) -> torch.Tensor:
    """``linear(x)`` for a projection whose input dim is sharded over
    ``group``: each rank's partial product, kept in fp32, is all-reduced,
    the bias is added once, and the sum is rounded to x's dtype once, as
    the unsharded product's fp32 accumulator is.  Without a group, or
    for a projection the mesh left whole (its head count does not
    divide over ``tp``: every rank holds the full product),
    ``linear(x)``."""
    if group is None or linear.weight.shape[1] == linear.in_features:
        return linear(x)
    from kfserving_tpu_torch.parallel.mesh import all_reduce

    w = linear.weight
    if x.dtype == torch.float32:
        y = F.linear(x, w)
    elif x.is_cuda:
        # bf16 operands, fp32 result (cuBLAS's accumulator, unrounded).
        y = torch.mm(x.reshape(-1, x.shape[-1]), w.t(),
                     out_dtype=torch.float32).reshape(*x.shape[:-1], -1)
    else:
        y = F.linear(x.float(), w.float())
    y = all_reduce(y, group)
    if linear.bias is not None:
        y = y + linear.bias.float()
    return y.to(x.dtype)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        hidden = cfg.hidden_size
        self.query = nn.Linear(hidden, hidden, dtype=cfg.dtype)
        self.key = nn.Linear(hidden, hidden, dtype=cfg.dtype)
        self.value = nn.Linear(hidden, hidden, dtype=cfg.dtype)
        self.out = nn.Linear(hidden, hidden, dtype=cfg.dtype)

    def forward(self, hidden: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
        cfg = self.cfg
        B, L, _ = hidden.shape
        heads = (B, L, -1, cfg.head_dim)            # this rank's heads
        q = self.query(hidden).view(heads)          # [B, L, H, D]
        k = self.key(hidden).view(heads)
        v = self.value(hidden).view(heads)
        attn_mask = None
        if mask is not None:
            attn_mask = mask[:, None, None, :].bool()
        if cfg.attn_fn is not None:
            out = cfg.attn_fn(q, k, v, attn_mask)
        else:
            out = dot_product_attention(q, k, v, mask=attn_mask,
                                        prefix_padding=cfg.prefix_padding)
        return row_parallel(self.out, out.reshape(B, L, -1), cfg.tp_group)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.gelu = "tanh" if cfg.gelu_approximate else "none"
        self.attention = BertSelfAttention(cfg)
        self.attention_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.intermediate = nn.Linear(cfg.hidden_size, cfg.intermediate_size,
                                      dtype=cfg.dtype)
        self.output = nn.Linear(cfg.intermediate_size, cfg.hidden_size,
                                dtype=cfg.dtype)
        self.output_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, hidden: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
        hidden = self.attention_norm(hidden + self.attention(hidden, mask))
        mlp = F.gelu(self.intermediate(hidden), approximate=self.gelu)
        return self.output_norm(
            hidden + row_parallel(self.output, mlp, self.cfg.tp_group))


class BertForMaskedLM(nn.Module):
    """Token ids -> MLM logits.  Inputs: input_ids [B, L] (int),
    optional attention_mask [B, L] (1 = real token)."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.config = cfg
        hidden = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, hidden,
                                            dtype=cfg.dtype)
        self.position_embeddings = nn.Embedding(cfg.max_position, hidden,
                                                dtype=cfg.dtype)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  hidden, dtype=cfg.dtype)
        self.embeddings_norm = LayerNorm(hidden, cfg.layer_norm_eps)
        self.layers = nn.ModuleList(
            BertLayer(cfg) for _ in range(cfg.num_layers))
        self.mlm_transform = nn.Linear(hidden, hidden, dtype=cfg.dtype)
        self.mlm_norm = LayerNorm(hidden, cfg.layer_norm_eps)
        self.mlm_bias = nn.Parameter(torch.zeros(cfg.vocab_size))
        self.gelu = "tanh" if cfg.gelu_approximate else "none"

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        L = input_ids.shape[1]
        positions = torch.arange(L, device=input_ids.device)[None, :] \
            + self.config.seq_shard * L
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        hidden = self.word_embeddings(input_ids)
        hidden = hidden + self.position_embeddings(positions)
        hidden = hidden + self.token_type_embeddings(token_type_ids)
        hidden = self.embeddings_norm(hidden)
        for layer in self.layers:
            hidden = layer(hidden, attention_mask)
        # MLM head: transform + tied-embedding decoder, logits in fp32.
        hidden = F.gelu(self.mlm_transform(hidden), approximate=self.gelu)
        hidden = self.mlm_norm(hidden)
        logits = F.linear(hidden, self.word_embeddings.weight)
        return logits.float() + self.mlm_bias

    def flops(self, batch: int, seq: Optional[int]) -> float:
        """Multiply-add operations (x2) of one forward at this shape; 0
        when the engine has no sequence bucket to give (not counted)."""
        if seq is None:
            return 0.0
        cfg = self.config
        h, i, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
        tokens = batch * seq
        dense = cfg.num_layers * (4 * h * h + 2 * h * i) + h * h + h * v
        attention = cfg.num_layers * 4 * batch * seq * seq * h
        return float(2 * tokens * dense + attention)


def bert_base(**overrides) -> BertConfig:
    return BertConfig(**overrides)


def bert_tiny(**overrides) -> BertConfig:
    """4-layer/128-wide config for hermetic CPU tests."""
    defaults = dict(vocab_size=1024, hidden_size=128, num_layers=4,
                    num_heads=4, intermediate_size=512, max_position=512)
    defaults.update(overrides)
    return BertConfig(**defaults)


def create_bert(config: Optional[BertConfig] = None, seq_len: int = 128):
    """Returns (module on the meta device, example inputs dict)."""
    cfg = config or bert_base()
    with torch.device("meta"):
        module = BertForMaskedLM(cfg)
    example: Dict[str, np.ndarray] = {
        "input_ids": np.zeros((1, seq_len), np.int32),
        "attention_mask": np.ones((1, seq_len), np.int32),
    }
    return module, example


def _create_bert_base(**kw):
    """Registry factory: 'bert'."""
    seq_len = kw.pop("seq_len", 128)
    return create_bert(bert_base(**kw) if kw else None, seq_len=seq_len)


def _create_bert_tiny(seq_len=128, **kw):
    """Registry factory: 'bert_tiny'."""
    return create_bert(bert_tiny(**kw), seq_len=seq_len)
