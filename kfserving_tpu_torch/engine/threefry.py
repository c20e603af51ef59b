"""Threefry-2x32 counter-based random numbers, bit for bit as JAX draws them.

Port of the parts of ``jax._src.prng`` and ``jax._src.random`` that the
JAX package's generator samples with (jax 0.9, default implementation
``threefry2x32``, ``jax_threefry_partitionable`` on, x64 off):

- ``prng_key(seed)``: ``threefry_seed`` of a 32-bit seed, ``[0, seed]``;
- ``threefry2x32(keys, x0, x1)``: the 20-round hash;
- ``fold_in(keys, data)``: ``threefry_2x32(key, [0, data])``, batched;
- ``random_bits(keys, n)``: 32-bit words in the partitionable layout
  (counter ``i`` hashed as the pair ``(0, i)``, the two output words
  xor-ed);
- ``uniform(keys, n, minval, maxval)``: float32 from the top 23 bits;
- ``gumbel(keys, n)``: mode "low", ``-log(-log(u))`` of a uniform on
  ``[tiny, 1)``.

Keys are int64 tensors ``[..., 2]`` holding unsigned 32-bit words: torch's
uint32 arithmetic is partial, so every operation works on int64 and masks
to 32 bits (shifts never reach bit 63).  Everything is plain tensor work
on the tensors' device, with no host read, so a CUDA graph can capture it.
The bits, the uniforms and the keys equal JAX's; the Gumbel values differ
from XLA's by the rounding of its ``log``.
"""

from typing import Tuple, Union

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(torch.finfo(torch.float32).tiny)
# float32 1.0: the exponent the 23 random mantissa bits are or-ed under.
_ONE_BITS = 0x3F800000


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as an int64 ``[2]``: a 32-bit seed
    (JAX without x64 holds it as int32) gives ``[0, seed mod 2**32]``."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} does not fit in 32 bits")
    return torch.tensor([0, seed & _M32], dtype=torch.int64, device=device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(keys: torch.Tensor, x0: Union[torch.Tensor, int],
                 x1: Union[torch.Tensor, int]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash of the word pairs ``(x0, x1)`` under
    ``keys`` ``[..., 2]``; ``x0`` and ``x1`` broadcast against
    ``keys[..., 0]``.  Returns the two output words (int64, < 2**32)."""
    k0, k1 = keys[..., 0], keys[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def fold_in(keys: torch.Tensor, data: Union[torch.Tensor, int]
            ) -> torch.Tensor:
    """``jax.random.fold_in`` row by row: ``keys`` ``[2]`` or ``[B, 2]``,
    ``data`` an int or ``[B]`` (taken mod 2**32, as JAX's uint32 cast).
    Returns ``[B, 2]`` (``[2]`` for a scalar fold of one key)."""
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64) & _M32
    else:
        data = int(data) & _M32
    x0, x1 = threefry2x32(keys, 0, data)
    return torch.stack([x0, x1], dim=-1)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,))`` per key row, as uint32 values in an
    int64 tensor ``[..., n]`` (the partitionable layout: counter ``i`` is
    the pair ``(0, i)``, and the word is the xor of the two outputs)."""
    counts = torch.arange(n, dtype=torch.int64, device=keys.device)
    k = keys[..., None, :]
    x0, x1 = threefry2x32(k, 0, counts)
    return x0 ^ x1


def uniform(keys: torch.Tensor, n: int, minval: float = _TINY,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, maxval)`` per key
    row: the top 23 bits as the mantissa of a float in [1, 2), minus 1,
    scaled and shifted, and clamped below at ``minval``."""
    bits = random_bits(keys, n)
    floats = (((bits >> 9) | _ONE_BITS).to(torch.int32)
              .view(torch.float32) - 1.0)
    # The bounds and their difference rounded to float32, as JAX holds
    # them; Python scalars, so that no host tensor is copied in (a CUDA
    # graph capture refuses that).
    lo = float(np.float32(minval))
    scale = float(np.float32(maxval) - np.float32(minval))
    return (floats * scale + lo).clamp_min(lo)


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,))`` per key row (float32, mode
    "low")."""
    return -torch.log(-torch.log(uniform(keys, n)))
