"""Multi-head attention dispatch: the CUDA flash kernel on the card,
plain PyTorch attention otherwise.

Port of ``kfserving_tpu/ops/attention.py``.  One public entry point,
``dot_product_attention(q, k, v, mask=None)``, over
[batch, len, heads, head_dim] tensors.  A CUDA call whose mask case the
kernel handles (``flash_handles_mask``: none, suffix padding as lengths,
causal with Lq == Lk, or causal with Lq == Lk plus lengths) always goes
to ``flash_attention``, which launches the kernel or raises
``ValueError`` for a dtype, head dim or layout it does not take.  A mask
case the kernel does not handle (an arbitrary mask, or causal with
Lq != Lk as in the dense-cache decode) and every CPU call take
``_torch_attention``, the port of the JAX package's einsum path.  The
TPU's sequence-length thresholds do not apply on the card, and unlike
the JAX dispatcher, causal + ``kv_lengths`` (the decoder's bucketed
prefill) goes to the kernel, which applies both masks at once.

A card call that autograd records (grad enabled and an operand requiring
grad: the saliency explainer's gradient through ViT) goes through
``FlashAttentionGrad``: its forward launches the kernel as any other
call does, and its backward is the vector-Jacobian product of
``_torch_attention``, recomputed from the saved q, k, v and lengths.
The JAX package differentiates its XLA attention there (no Pallas
kernel in it has a backward), so the backward is that function's VJP.
"""

from typing import Optional

import torch

from kfserving_tpu_torch.ops.flash_attention import flash_attention


def _torch_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Reference attention in BLHD layout: the scale applied to q in its
    own dtype, the softmax in fp32."""
    depth = q.shape[-1]
    scale = float(torch.tensor(1.0 / depth ** 0.5, dtype=q.dtype))
    scores = torch.einsum("bqhd,bkhd->bhqk", q * scale, k)   # [B, H, Lq, Lk]
    if mask is not None:
        scores = torch.where(mask, scores,
                             torch.finfo(scores.dtype).min)
    # fp32 at least (float64 stays float64, for gradient checks).
    softmax_dtype = torch.promote_types(scores.dtype, torch.float32)
    weights = torch.softmax(scores.to(softmax_dtype), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def _plain_mask(Lq: int, Lk: int, causal: bool,
                kv_lengths: Optional[torch.Tensor],
                device: torch.device) -> Optional[torch.Tensor]:
    """The boolean [B|1, 1, Lq, Lk] mask of ``causal`` and suffix key
    padding ``kv_lengths``, for ``_torch_attention``."""
    mask = None
    if kv_lengths is not None:
        keys = torch.arange(Lk, device=device)
        mask = (keys[None, :] < kv_lengths.to(device)[:, None]
                )[:, None, None, :]
    if causal:
        causal_mask = torch.ones((Lq, Lk), dtype=torch.bool,
                                 device=device).tril(Lk - Lq)[None, None]
        mask = causal_mask if mask is None else (mask & causal_mask)
    return mask


class FlashAttentionGrad(torch.autograd.Function):
    """``flash_attention`` under autograd: the forward is the kernel call
    (counted, and raising as it raises), the backward the VJP of
    ``_torch_attention`` with the same masking, recomputed from the saved
    operands.  A query row with no valid key is 0 in the kernel's
    forward, so its incoming gradient is dropped."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool,
                kv_lengths: Optional[torch.Tensor]):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, kv_lengths)
        return flash_attention(q, k, v, causal=causal,
                               kv_lengths=kv_lengths)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, kv_lengths = ctx.saved_tensors
        mask = _plain_mask(q.shape[1], k.shape[1], ctx.causal, kv_lengths,
                           q.device)
        if kv_lengths is not None:
            live = (kv_lengths.to(q.device) > 0).to(grad_out.dtype)
            grad_out = grad_out * live[:, None, None, None]
        with torch.enable_grad():
            operands = [t.detach().requires_grad_(need) for t, need in
                        zip((q, k, v), ctx.needs_input_grad[:3])]
            out = _torch_attention(*operands, mask)
            wanted = [t for t in operands if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, grad_out))
        return (*(next(grads) if t.requires_grad else None
                  for t in operands), None, None)


def _on_card(q: torch.Tensor) -> bool:
    """Whether a call runs on the card, where a mask case the kernel
    handles always launches it (or raises)."""
    return q.is_cuda


def flash_handles_mask(causal: bool, lq: int, lk: int, has_mask: bool,
                       has_lengths: bool) -> bool:
    """Whether the flash kernel computes a call's masking by itself.

    has_mask: the caller passed an explicit mask.  has_lengths: the key
    padding arrives as per-row lengths (``kv_lengths``, or lengths the
    dispatcher derived from a ``prefix_padding`` mask).  The kernel's
    causal mask puts query i at position i, so causal needs Lq == Lk; it
    composes with lengths (one pass applies both, as the decoder's
    bucketed prefill needs) but not with an arbitrary mask."""
    if causal:
        return lq == lk and not has_mask
    return not has_mask or has_lengths


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          causal: bool = False,
                          kv_lengths: Optional[torch.Tensor] = None,
                          prefix_padding: bool = False) -> torch.Tensor:
    """Attention over [batch, len, heads, head_dim] tensors.

    mask: optional broadcastable boolean [B, H, Lq, Lk] (True = attend).
    causal: apply a causal mask; composes with an explicit mask.  With
        Lq < Lk query i sits at position Lk - Lq + i (shifted triangle).
    kv_lengths: optional int [B] declaring suffix key padding.  Mutually
        exclusive with `mask`: lengths fully determine the suffix mask.
    prefix_padding: declares `mask` to be suffix key padding; the kernel
        then consumes it as per-row lengths, while the plain path still
        applies the mask itself.
    """
    if kv_lengths is not None and mask is not None:
        raise ValueError(
            "mask and kv_lengths are mutually exclusive: kv_lengths "
            "asserts suffix padding and the flash path would silently "
            "ignore a disagreeing mask; pass the mask alone for "
            "arbitrary patterns (optionally with prefix_padding=True)")
    Lq, Lk = q.shape[1], k.shape[1]
    lengths = kv_lengths
    if prefix_padding and mask is not None and not causal:
        # Any one query row's key mask gives the row's real-key count.
        flat = mask.reshape(mask.shape[0], -1, mask.shape[-1])
        lengths = flat[:, 0, :].sum(dim=-1, dtype=torch.int32)
    if _on_card(q) and flash_handles_mask(causal, Lq, Lk, mask is not None,
                                          lengths is not None):
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return FlashAttentionGrad.apply(q, k, v, causal, lengths)
        return flash_attention(q, k, v, causal=causal, kv_lengths=lengths)
    plain = _plain_mask(Lq, Lk, causal, kv_lengths, q.device)
    if plain is not None:
        mask = plain if mask is None else mask & plain
    return _torch_attention(q, k, v, mask)
