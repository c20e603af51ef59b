"""kfslint golden fixture (port): prng-key-reuse must NOT fire (never
executed)."""
import torch

from kfserving_tpu_torch.engine import threefry


def sample_pair(n, seeds, positions):
    key = threefry.prng_key(0)
    a = threefry.gumbel(threefry.fold_in(key, seeds), n)
    keys = threefry.fold_in(key, positions)
    b = threefry.uniform(keys, n)
    return a, b


def loop_fold(n):
    key = threefry.prng_key(1)
    out = []
    for i in range(4):
        key = threefry.fold_in(key, i)
        out.append(threefry.random_bits(key, n))
    return out


def advancing(shape, seed):
    # A generator advances with each draw: two draws are independent.
    gen = torch.Generator()
    gen.manual_seed(seed)
    a = torch.randn(shape, generator=gen)
    b = torch.randn(shape, generator=gen)
    gen.manual_seed(seed + 1)
    c = torch.randn(shape, generator=gen)
    return a, b, c


def branches(shape, flag):
    gen = torch.Generator()
    gen.manual_seed(3)
    if flag:
        return torch.randn(shape, generator=gen)
    return torch.rand(shape, generator=gen)
