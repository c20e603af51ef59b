"""kfslint golden fixture (port): prng-key-reuse MUST fire on every
marked line (never executed, only parsed)."""
import torch

from kfserving_tpu_torch.engine import threefry


def sample_pair(n):
    key = threefry.prng_key(0)
    a = threefry.gumbel(key, n)
    b = threefry.uniform(key, n)                  # FIRE: key drawn twice
    return a, b


def loop_reuse(n):
    key = threefry.prng_key(1)
    out = []
    for _ in range(4):
        out.append(threefry.random_bits(key, n))  # FIRE: every pass
    return out


def reseeded(shape):
    gen = torch.Generator()
    gen.manual_seed(7)
    a = torch.randn(shape, generator=gen)
    gen.manual_seed(7)
    b = torch.randn(shape, generator=gen)         # FIRE: same state
    return a, b


def reseeded_loop(shape):
    gen = torch.Generator()
    out = []
    for _ in range(3):
        gen.manual_seed(11)
        out.append(torch.rand(shape, generator=gen))  # FIRE: every pass
    return out
