"""Flash attention: the CUDA kernel ``csrc/flash_attention.cu`` and its
plain PyTorch version.

Port of the Pallas TPU kernel
``kfserving_tpu/ops/pallas_attention.py::flash_attention``:
``softmax(Q K^T / sqrt(D)) V`` over ``[B, L, H, D]`` tensors with an
online softmax whose max, normalizer and accumulator stay fp32 while the
operands enter the products in the input dtype.  Options: ``causal``
(query i sits at position i) and ``kv_lengths`` (int32 ``[B]``, suffix key
padding; key tiles past a row's length are skipped).  A row with no valid
key gives 0.  Any sequence length is taken: the TPU kernel's rule that L
be a multiple of 8 came from its lane tiling, while this kernel masks
keys past Lk in the tile that crosses it and stores no query row past Lq
(ViT-B/16 at 224 px runs L = 197).

The kernel, for an H100, takes the head dims in ``SUPPORTED_HEAD_DIMS``
in bf16 and fp32 (``kernel_path`` names the path of each): bf16 at head
dims 64, 128, 192 and 256 runs a warp-specialized kernel (a TMA producer
warp feeding a ring of K/V tiles to two ``wgmma`` consumer warpgroups);
fp32 at every head dim runs an ``mma.sync`` kernel over bf16 hi + lo
halves, and bf16 at head dims 16, 32, 80 and 96 the same kernel on bf16
tiles.  Its source note says what bounds each and why.

On a CPU tensor the wrapper runs ``flash_attention_plain``; on a CUDA
tensor it launches the kernel or raises.
"""

import ctypes
import math
from typing import Optional, Tuple

import torch

from kfserving_tpu_torch.ops import launches
from kfserving_tpu_torch.protocol.errors import InvalidInput

# Head dims the kernel is instantiated for (csrc/flash_attention.cu): the
# TPU kernel's multiples of 64 up to 256, the tiny configs' 16 and 32, and
# 80 and 96 (ViT-H/14 and Phi-2, GPT-NeoX-20B; XLA's in the JAX package).
SUPPORTED_HEAD_DIMS = (16, 32, 64, 80, 96, 128, 192, 256)
SUPPORTED_DTYPES = (torch.bfloat16, torch.float32)
# Head dims of the wgmma path in bf16 (64-column swizzled panels); every
# other supported (dtype, head dim) runs on mma.sync.
WGMMA_HEAD_DIMS = (64, 128, 192, 256)
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
# Elements per 16-byte vector load, by dtype.
_VEC = {torch.bfloat16: 8, torch.float32: 4}
_MAX_GRID_Y = 65535
# kfs_flash_attention returns this + the CUresult of a refused tensor map.
_TENSOR_MAP_ERROR = 10000

_fn = None


def kernel_path(dtype: torch.dtype, head_dim: int) -> str:
    """Which of the kernel's paths a CUDA call takes: "wgmma" (bf16 at
    head dims 64, 128, 192 and 256) or "mma" (mma.sync: the rest)."""
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "mma"


def check_kernel_shapes(module: torch.nn.Module,
                        device: torch.device) -> None:
    """On the card, refuse a model whose attention this kernel is not
    built for (it would raise on the first batch; nothing reroutes a card
    call to the plain version), naming the dtypes and head dims it takes.
    Models without attention pass.  The predict path and the generation
    engine both call it at load."""
    cfg = getattr(module, "config", None)
    head_dim = getattr(cfg, "head_dim", None)
    if device.type != "cuda" or head_dim is None:
        return
    if cfg.dtype not in SUPPORTED_DTYPES or head_dim not in \
            SUPPORTED_HEAD_DIMS:
        raise InvalidInput(
            f"the flash attention kernel takes dtypes {SUPPORTED_DTYPES} "
            f"and head dims {SUPPORTED_HEAD_DIMS}, not {cfg.dtype} and "
            f"head dim {head_dim}")


def _check_lengths(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                   ) -> Tuple[int, int, int, int, int]:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be [B, L, H, D]")
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    if k.shape != (B, Lk, H, D) or v.shape != k.shape:
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}")
    return B, Lq, H, D, Lk


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, causal: bool = False,
                          kv_lengths: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """The kernel's function in plain PyTorch: fp32 scores and
    statistics, P rounded to the value dtype before the P V product."""
    B, Lq, H, D, Lk = _check_lengths(q, k, v)
    # fp32 at least (float64 stays float64, for gradient checks).
    acc = torch.promote_types(q.dtype, torch.float32)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) / math.sqrt(D)
    valid = torch.ones((1, 1, Lq, Lk), dtype=torch.bool, device=q.device)
    if causal:
        valid = valid & torch.ones((Lq, Lk), dtype=torch.bool,
                                   device=q.device).tril()
    if kv_lengths is not None:
        keys = torch.arange(Lk, device=q.device)
        lengths = kv_lengths.to(device=q.device, dtype=torch.int64)
        valid = valid & (keys[None, :] < lengths[:, None])[:, None, None, :]
    s = s.masked_fill(~valid, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)  # noqa: E741
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).to(acc), v.to(acc))
    return (out / l.permute(0, 2, 1, 3)).to(q.dtype)


def _kernel():
    global _fn
    if _fn is None:
        from kfserving_tpu_torch.csrc import build

        fn = build.load("flash_attention").kfs_flash_attention
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 12
                       + [ctypes.c_float, ctypes.c_void_p])
        _fn = fn
    return _fn


def _check_cuda_operands(q, k, v, D) -> None:
    if q.dtype not in SUPPORTED_DTYPES:
        raise ValueError(f"flash_attention kernel takes bfloat16 or "
                         f"float32, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k and v must share one dtype")
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention kernel supports head dims "
                         f"{SUPPORTED_HEAD_DIMS}, got {D}")
    vec = _VEC[q.dtype]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError("q, k and v must be on one device")
        if t.stride(3) != 1:
            raise ValueError(f"{name}: the head-dim axis must be "
                             "contiguous")
        if (t.data_ptr() % 16
                or any(t.stride(i) % vec for i in range(3))):
            raise ValueError(f"{name}: rows must start on 16-byte "
                             "boundaries for the kernel's TMA and vector "
                             "loads")


def _launch_error(rc: int) -> str:
    if rc >= _TENSOR_MAP_ERROR:
        return f"the driver refused a TMA tensor map (CUresult " \
               f"{rc - _TENSOR_MAP_ERROR})"
    return f"cudaError {rc}"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False,
                    kv_lengths: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Fused attention over [B, L, H, D]; returns [B, L, H, D].

    kv_lengths: optional int [B] — per-row count of real keys (suffix
    padding beyond is masked, and wholly padded key tiles are skipped).
    """
    B, Lq, H, D, Lk = _check_lengths(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     kv_lengths=kv_lengths)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda (kernel) or cpu "
                         f"(plain version), not {q.device.type}")
    _check_cuda_operands(q, k, v, D)
    if q.dtype == torch.float32 and B * H > _MAX_GRID_Y:
        raise ValueError(f"B*H = {B * H} exceeds the fp32 kernel grid's "
                         f"{_MAX_GRID_Y}")
    lengths = None
    if kv_lengths is not None:
        lengths = kv_lengths.to(device=q.device,
                                dtype=torch.int32).contiguous()
        if lengths.shape != (B,):
            raise ValueError(f"kv_lengths must be [{B}], got "
                             f"{tuple(lengths.shape)}")
    out = torch.empty((B, Lq, H, D), dtype=q.dtype, device=q.device)
    fn = _kernel()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lengths is None else lengths.data_ptr(),
            B, H, Lq, Lk, D, _DTYPE_CODE[q.dtype], int(bool(causal)),
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), out.stride(2),
            1.0 / math.sqrt(D), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"{_launch_error(rc)}")
    launches.count(flash_attention)
    return out


# Kernel executions since the count was last set to 0, graph replays
# included (ops/launches.py; chip_smoke.py reads it to show that the
# serving path ran through the kernel).
flash_attention.launches = 0
