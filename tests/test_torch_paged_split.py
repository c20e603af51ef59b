"""The paged decode kernel's hopper path, as far as the CPU can hold it:
its split plan (``split_plan``) and the walk its CTAs make over the valid
tokens (``split_tiles``, the kernel's arithmetic in Python), the choice of
path by dtype and head dim, the shared-header digest of the kernel build,
and the plain version against the JAX package at the lengths the split
makes hard (around a tile, around a block, parked and empty rows).

The kernel itself runs only on the card, where chip_smoke.py holds it
against the plain version at these lengths.
"""

import collections
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kfserving_tpu.ops import paged_attention as jax_paged
from kfserving_tpu_torch.csrc import build
from kfserving_tpu_torch.ops import paged_attention as port

# fp32 on both sides, as in tests/test_torch_paged.py.
ATOL = RTOL = 2e-5
EDGE = [1, 127, 128, 129, 3021, 4096, 4097, 0]
MAX_TOKENS = 4096


def _covered_once(plan, lengths, BS, max_tokens=MAX_TOKENS):
    """Checks the walk of every CTA: each valid (row, token) read once, no
    tile across a pool block, a tile boundary or a span; each span whole in
    one CTA, at its own slot."""
    tiles = port.split_tiles(plan, lengths, max_tokens)
    span, tt = plan.span_tokens, plan.tile_tokens
    seen = collections.Counter()
    slots = collections.defaultdict(list)      # slot -> (cta, row, pos, n)
    for cta, slot, row, pos, n in tiles:
        assert 1 <= n <= tt and pos % tt + n <= tt
        assert pos // BS == (pos + n - 1) // BS
        assert pos // span == (pos + n - 1) // span
        seen.update((row, t) for t in range(pos, pos + n))
        slots[slot].append((cta, row, pos, n))
    want = {(r, t) for r, n in enumerate(lengths)
            for t in range(min(max(n, 0), max_tokens))}
    assert set(seen) == want and set(seen.values()) <= {1}
    # A row's partials are its spans, fixed by its own length alone (so
    # its output cannot depend on the other rows), each read by one CTA in
    # order, at the span's index among all rows' spans: what the merge
    # reads as the row's first slot plus the span's index.
    want_spans = [(r, s * span, min((s + 1) * span, n))
                  for r, n in enumerate(min(max(n, 0), max_tokens)
                                        for n in lengths)
                  for s in range(-(-n // span))]
    assert sorted(slots) == list(range(len(want_spans)))
    assert len(want_spans) <= port.span_slots(
        len(lengths), max_tokens // BS, BS, plan)
    for slot, (row, start, stop) in enumerate(want_spans):
        parts = slots[slot]
        assert len({cta for cta, _, _, _ in parts}) == 1
        assert {r for _, r, _, _ in parts} == {row}
        assert parts[0][2] == start and parts[-1][2] + parts[-1][3] == stop
        assert all(a + n == b for (_, _, a, n), (_, _, b, _)
                   in zip(parts, parts[1:]))


@pytest.mark.parametrize("H,D,BS,sms", list(itertools.product(
    (6, 12), (64, 128), (32, 128), (132, 5))) + list(itertools.product(
        (8, 12), (192, 256), (32, 128), (132, 5))))
def test_split_plan_covers_every_token_once(H, D, BS, sms):
    MB = MAX_TOKENS // BS
    plan = port.split_plan(len(EDGE), H, D, BS, MB, sms)
    assert plan.head_group * plan.head_groups == H
    assert BS % plan.tile_tokens == 0
    assert 2 * plan.tile_tokens * plan.head_group * D * 2 \
        <= port.SPAN_STAGE_BYTES
    assert plan.smem_bytes == port.span_smem_bytes(
        D, plan.head_group, plan.tile_tokens, plan.stages,
        plan.groups_per_head)
    assert plan.smem_bytes <= port.SMEM_PER_CTA
    assert plan.consumers % 32 == 0
    assert plan.consumers <= port.SPAN_MAX_CONSUMERS
    assert plan.ctas * plan.head_groups <= sms * port.SPAN_CTAS_PER_SM
    tt = plan.tile_tokens
    for lengths in (EDGE, [tt - 1, tt, tt + 1, BS - 1, BS, BS + 1, 4 * BS,
                           24 * BS], [0] * 7 + [4096], [0] * 8):
        _covered_once(plan, lengths, BS)


def test_split_plan_divides_one_long_row_evenly():
    plan = port.split_plan(1, 12, 64, 128, 32, 132)
    tiles = port.split_tiles(plan, [4096], MAX_TOKENS)
    per_cta = collections.Counter()
    for cta, _, _, _, n in tiles:
        per_cta[cta] += n
    assert len(per_cta) == min(plan.ctas, 4096 // plan.span_tokens)
    assert max(per_cta.values()) - min(per_cta.values()) <= plan.span_tokens


def test_a_rows_spans_do_not_depend_on_the_other_rows():
    plan = port.split_plan(4, 12, 64, 128, 32, 7)
    alone = port.split_tiles(plan, [0, 3021, 0, 0], MAX_TOKENS)
    crowded = port.split_tiles(plan, [4096, 3021, 17, 900], MAX_TOKENS)

    def spans(tiles):   # row 1's tokens of each of its partials
        out = collections.defaultdict(list)
        first = min(slot for _, slot, row, _, _ in tiles if row == 1)
        for _, slot, row, pos, n in tiles:
            if row == 1:
                out[slot - first].append((pos, n))
        return dict(out)

    assert spans(alone) == spans(crowded)


def test_split_plan_groups_heads_when_a_token_overflows_a_stage():
    # 64 heads of 128: all heads' K and V of one token (32 KB) fit a stage
    # of 48 KB, but their lane groups would overflow the CTA.
    plan = port.split_plan(4, 64, 128, 16, 32, 132)
    assert plan.head_groups > 1 and 64 % plan.head_group == 0
    assert plan.consumers <= port.SPAN_MAX_CONSUMERS
    _covered_once(plan, [5, 0, 600, 17], 16, max_tokens=32 * 16)


@pytest.mark.parametrize("dtype,D,path", [
    (torch.bfloat16, 64, "hopper"), (torch.bfloat16, 128, "hopper"),
    (torch.bfloat16, 32, "simple"), (torch.float32, 32, "simple"),
    (torch.float32, 64, "simple"), (torch.float32, 128, "simple"),
    (torch.bfloat16, 192, "hopper"), (torch.bfloat16, 256, "hopper"),
    (torch.bfloat16, 16, "simple"), (torch.bfloat16, 80, "simple"),
    (torch.bfloat16, 96, "simple"), (torch.float32, 80, "simple"),
    (torch.float32, 256, "simple")])
def test_kernel_path_by_dtype_and_head_dim(dtype, D, path):
    assert port.kernel_path(dtype, D) == path


@pytest.mark.parametrize("dtype,D", [(torch.float16, 64),
                                     (torch.bfloat16, 48),
                                     (torch.float32, 272)])
def test_operands_neither_path_takes_raise(dtype, D):
    q = torch.zeros((2, 1, 4, D), dtype=dtype)
    pool = torch.zeros((3, 16, 4, D), dtype=dtype)
    table = torch.zeros((2, 2), dtype=torch.int32)
    lengths = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        port._check_cuda_operands(q, pool, pool, table, lengths, D)


def test_library_path_digests_the_shared_headers(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC_DIR", str(tmp_path))
    before = build.library_path("k")
    assert build.library_path("k") == before
    (tmp_path / "h.cuh").write_text("// two\n")
    edited = build.library_path("k")
    assert edited != before
    (tmp_path / "other.cuh").write_text("// new header\n")
    assert build.library_path("k") != edited
    assert build.headers() == ["h.cuh", "other.cuh"]


def _pools(seed, B, H, D, BS, NB):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32) for shape in (
        (B, 1, H, D), (NB, BS, H, D), (NB, BS, H, D)))


def _edge_lengths(H, D, BS, MB):
    tt = port.split_plan(8, H, D, BS, MB, 132).tile_tokens
    # Around the tile, around a block, a multiple of the block, parked
    # past the table, empty.
    return [tt - 1, tt, tt + 1, BS - 1, BS + 1, 2 * BS, MB * BS + 1, 0]


@pytest.mark.parametrize("H", [6, 12])
def test_plain_matches_pallas_and_xla_at_split_edges(H):
    D, BS, MB = 64, 128, 3
    lengths = _edge_lengths(H, D, BS, MB)
    NB = 8 * MB
    q, pool_k, pool_v = _pools(H, 8, H, D, BS, NB)
    table = np.arange(NB, dtype=np.int32).reshape(8, MB)[:, ::-1].copy()
    table[0, 1:] = -1                      # a -1 tail
    table[2, 0] = table[4, 0]              # a shared first block
    lens = np.asarray(lengths, np.int32)
    got = port.paged_attention_kernel(
        torch.from_numpy(q), torch.from_numpy(pool_k),
        torch.from_numpy(pool_v), torch.from_numpy(table),
        torch.from_numpy(lens)).numpy()
    pallas = np.asarray(jax_paged.paged_attention_tpu.__wrapped__(
        jnp.asarray(q), jnp.asarray(pool_k), jnp.asarray(pool_v),
        jnp.asarray(table), jnp.asarray(lens), interpret=True))
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=RTOL)
    # The zero-length row is exactly 0 (the XLA path averages V there, so
    # it is held against the Pallas kernel only).
    assert np.all(got[7] == 0.0) and np.all(pallas[7] == 0.0)
    xla = np.asarray(jax_paged.paged_attention_xla(
        jnp.asarray(q), jnp.asarray(pool_k), jnp.asarray(pool_v),
        jnp.asarray(table), jnp.asarray(lens)))
    np.testing.assert_allclose(got[:7], xla[:7], atol=ATOL, rtol=RTOL)
