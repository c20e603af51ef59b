"""The port's host KV tier against the JAX package's, on the CPU.

The port's ``HostKVTier`` runs the same seeded operation sequences as the
JAX one and must leave the same ``debug()`` block and payloads; a tier
directory written by either package must be adopted by the other with the
same outcome counts.  The port's engine runs the three-turn return-visit
workload of ``tests/test_kv_tier.py`` (P1, then P2 evicting P1's blocks
from a 4-block pool, then P1 again): with the tier the return visit faults
P1's blocks back, and every arm (tier, spill fault, fault-back fault)
gives the drop baseline's tokens, which are the JAX decoder's greedy
tokens.  A spilled payload decodes, in the JAX layout, to the JAX
decoder's k/v.  The JAX GenerationEngine itself is never driven.
"""

import asyncio
import glob
import hashlib
import json
import os
import shutil

import numpy as np
import pytest
from torch_generation import ARCH, TinyDecoder

from kfserving_tpu.engine.kv_tier import HostKVTier as JaxHostKVTier
from kfserving_tpu_torch.engine.generator import GenerationEngine
from kfserving_tpu_torch.engine.kv_tier import HostKVTier, payload_digest
from kfserving_tpu_torch.observability import REGISTRY
from kfserving_tpu_torch.predictors.llm import GenerativeConfig
from kfserving_tpu_torch.reliability.faults import faults

MAX_SEQ = 64
BS = 16
# The return-visit workload of tests/test_kv_tier.py.
P1 = list(range(1, 2 * BS + 1))
P2 = list(range(40, 40 + 3 * BS))
# fp32 payload k/v against the JAX decoder's apply (another summation
# order), as tests/test_torch_decoder.py bounds caches.
KV_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _clean_slate():
    REGISTRY.reset()
    faults.reset()
    yield
    faults.reset()
    REGISTRY.reset()


@pytest.fixture(scope="module")
def tiny():
    return TinyDecoder()


@pytest.fixture(scope="module")
def port_module(tiny):
    return tiny.port()


def make_engine(module, **kw):
    kw.setdefault("max_slots", 1)
    kw.setdefault("max_seq", MAX_SEQ)
    kw.setdefault("prefill_buckets", [16, 32, MAX_SEQ])
    kw.setdefault("block_size", BS)
    return GenerationEngine(module, name=kw.pop("name", "kvtier"), **kw)


def counter(family: str, **labels) -> float:
    fam = REGISTRY.counter(family)
    want = {(k, str(v)) for k, v in labels.items()}
    return sum(child.value for sample, child in fam.samples()
               if want <= set(sample.items()))


async def settle_pool(eng, timeout_s: float = 10.0):
    total = eng.stats()["paged"]["pool_blocks"]
    for _ in range(int(timeout_s / 0.02)):
        await asyncio.sleep(0.02)
        st = eng.stats()["paged"]
        if st["free_blocks"] + st["reclaimable_blocks"] == total:
            return st
    raise AssertionError(f"pool never settled: {eng.stats()['paged']}")


async def settle_tier(eng, timeout_s: float = 5.0):
    """Spill causes land on the fetch executor after the eviction: wait
    until every capacity eviction is accounted."""
    for _ in range(int(timeout_s / 0.02)):
        st = eng.stats()
        ev = st["paged"]["evictions"]
        ht = st["host_tier"]
        attempts = (ht["spills"] + ht["spill_failures"]
                    + ht["spill_duplicates"])
        if (attempts >= ev["capacity_spilled"] + ev["capacity_dropped"]
                and not eng._spill_pending):
            return st
        await asyncio.sleep(0.02)
    return eng.stats()


async def three_turns(eng):
    out = []
    for p in (P1, P2, P1):
        toks, reason = await eng.complete(p, max_new_tokens=3)
        assert reason == "length"
        await settle_pool(eng)
        out.append(toks)
    return out


def chains_of(ids, bs: int = BS):
    """The engine's chain digests of a prompt's full blocks."""
    ids = np.asarray(ids, np.int32)
    out, chain = [], b""
    for c in range(ids.size // bs):
        chain = hashlib.blake2b(chain + ids[c * bs:(c + 1) * bs].tobytes(),
                                digest_size=16).digest()
        out.append(chain)
    return out


# ------------------------------------------------- tier parity (unit)

def _payload(seed: int, size: int) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, size, dtype=np.uint8).tobytes()


def _chain(i: int) -> bytes:
    return hashlib.blake2b(str(i).encode(), digest_size=16).digest()


def _ops(kind: str, rng):
    """A seeded operation sequence: (op, chain index, argument)."""
    if kind == "lru":
        ops = [("put", i, None) for i in range(6)]
        ops += [("read", int(i), None) for i in rng.integers(3, 6, 4)]
        ops += [("put", i, None) for i in range(6, 9)]
        ops += [("read", i, None) for i in range(9)]
    elif kind == "admission":
        # The LRU entry mid-fault-in is never the victim.
        ops = [("put", 0, None), ("put", 1, None), ("begin", 0, None),
               ("put", 2, None), ("put", 3, None), ("end", 0, None),
               ("read", 3, None), ("put", 4, None), ("coalesced", 0, 3)]
        ops += [("read", i, None) for i in range(5)]
    elif kind == "half_spilled":
        # A wrong-size payload never publishes; a full one round-trips.
        ops = [("bad_put", 0, None), ("contains", 0, None),
               ("begin", 0, None), ("read", 0, None), ("put", 0, None),
               ("read", 0, None), ("put", 0, None)]
    else:  # "faults": fault-back bookkeeping, drops, spill failures
        ops = [("put", i, None) for i in range(4)]
        ops += [("begin", 1, None), ("faultback", 1, 2.5),
                ("end", 1, None), ("fault_failure", 2, 2),
                ("drop", 2, None), ("drop", 2, None),
                ("spill_failure", 0, 3), ("put", 5, None),
                ("read", 2, None), ("read", 5, None)]
    return ops


def _run_ops(tier, ops, size: int):
    out = []
    for op, i, arg in ops:
        c = _chain(i)
        if op == "put":
            out.append(tier.put(c, _payload(i, size)))
        elif op == "bad_put":
            out.append(tier.put(c, _payload(i, size - 1)))
        elif op == "read":
            try:
                out.append(tier.read(c))
            except KeyError:
                out.append("missing")
        elif op == "contains":
            out.append(tier.contains(c))
        elif op == "begin":
            out.append(tier.begin_fault(c))
        elif op == "end":
            tier.end_fault(c)
        elif op == "coalesced":
            tier.note_coalesced(arg)
        elif op == "faultback":
            tier.note_faultback(1, arg)
        elif op == "fault_failure":
            tier.note_fault_failure(arg)
        elif op == "drop":
            tier.drop(c)
        elif op == "spill_failure":
            tier.note_spill_failure(arg)
    out.append(tier.chains())
    return out


@pytest.mark.parametrize("persistent", [False, True],
                         ids=["ephemeral", "persistent"])
@pytest.mark.parametrize("kind", ["lru", "admission", "half_spilled",
                                  "faults"])
def test_tier_matches_the_jax_tier(tmp_path, kind, persistent):
    rng = np.random.default_rng(len(kind))
    ops = _ops(kind, rng)
    capacity = 2 if kind == "admission" else 4
    results = {}
    for name, cls in (("jax", JaxHostKVTier), ("torch", HostKVTier)):
        directory = str(tmp_path / name) if persistent else None
        tier = cls(block_bytes=96, capacity_blocks=capacity,
                   directory=directory, model=f"parity-{kind}")
        try:
            results[name] = (_run_ops(tier, ops, 96), tier.debug())
        finally:
            tier.close()
    assert results["torch"][0] == results["jax"][0]
    assert results["torch"][1] == results["jax"][1]


def test_read_into_copies_the_payload():
    tier = HostKVTier(block_bytes=64, capacity_blocks=2, model="read-into")
    try:
        payload = _payload(3, 64)
        assert tier.put(b"x" * 16, payload)
        out = np.zeros(64, np.uint8)
        tier.read_into(b"x" * 16, out)
        assert out.tobytes() == payload == tier.read(b"x" * 16)
        with pytest.raises(KeyError):
            tier.read_into(b"y" * 16, out)
        with pytest.raises(ValueError):
            tier.read_into(b"x" * 16, np.zeros(63, np.uint8))
    finally:
        tier.close()


# ------------------------------------------- cross-package adoption

def _corrupt(d: str, outcome: str, stride: int) -> None:
    """Damage one predecessor generation as a crash or a skewed build
    would."""
    mpath = glob.glob(os.path.join(d, "kv_tier-*.manifest"))[0]
    bpath = mpath[:-len(".manifest")] + ".bin"
    if outcome == "truncated":
        os.truncate(bpath, 2 * stride)   # the third slot is cut off
    elif outcome == "corrupt":
        with open(bpath, "r+b") as f:
            first = f.read(1)
            f.seek(0)
            f.write(bytes([first[0] ^ 0xFF]))
    elif outcome == "torn":
        with open(mpath, "a") as f:
            f.write('{"op": "put", "v":\n')
            f.write(json.dumps({"op": "frobnicate", "v": 1}) + "\n")
    elif outcome == "version_skew":
        with open(mpath, "a") as f:
            f.write(json.dumps({"op": "put", "v": 2, "chain": "ab" * 16,
                                "slot": 3, "digest": "00" * 16}) + "\n")
    elif outcome == "header_skew":
        lines = open(mpath).read().splitlines()
        header = json.loads(lines[0])
        header["v"] = 99
        lines[0] = json.dumps(header)
        with open(mpath, "w") as f:
            f.write("\n".join(lines) + "\n")


@pytest.mark.parametrize("outcome", ["clean", "truncated", "corrupt",
                                     "torn", "version_skew",
                                     "header_skew"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_generation_adopted_across_packages(tmp_path, writer, outcome):
    """A generation written by one package's tier is adopted by both
    packages' tiers alike: the same handoff tallies, the same surviving
    chains, byte-equal payloads."""
    classes = {"jax": JaxHostKVTier, "torch": HostKVTier}
    src = str(tmp_path / "src")
    payloads = {_chain(i): _payload(10 + i, 200) for i in range(3)}
    tier = classes[writer](block_bytes=200, capacity_blocks=4,
                           directory=src, model="xpkg")
    for chain, payload in payloads.items():
        assert tier.put(chain, payload)
    stride = tier.slot_bytes
    tier.close()
    _corrupt(src, outcome, stride)
    adopted = {}
    for reader, cls in classes.items():
        d = str(tmp_path / f"read-{reader}")
        shutil.copytree(src, d)
        succ = cls(block_bytes=200, capacity_blocks=4, directory=d,
                   model="xpkg")
        try:
            got = {c: succ.read(c) for c in payloads if succ.contains(c)}
            adopted[reader] = (dict(succ.handoff), got)
            # The drained generation's files went; only the reader's own
            # generation is left.
            assert len(glob.glob(os.path.join(d, "*.manifest"))) == 1
        finally:
            succ.close()
    assert adopted["torch"] == adopted["jax"]
    handoff, got = adopted["torch"]
    for chain, payload in got.items():
        assert payload == payloads[chain]
    expected = {"clean": ("adopted", 3), "truncated": ("truncated", 1),
                "corrupt": ("corrupt", 1), "torn": ("torn", 2),
                "version_skew": ("version_skew", 1),
                "header_skew": ("generations_rejected", 1)}[outcome]
    assert handoff[expected[0]] == expected[1]
    assert handoff["adopted"] == len(got) == {
        "clean": 3, "truncated": 2, "corrupt": 2, "torn": 3,
        "version_skew": 3, "header_skew": 0}[outcome]


def test_payload_digest_is_the_jax_digest():
    from kfserving_tpu.engine.kv_tier import payload_digest as jax_digest

    payload = _payload(5, 4096)
    assert payload_digest(payload) == jax_digest(payload)


# ----------------------------------------------- engine: return visits

async def test_return_visit_faults_back_with_the_drop_tokens(tiny,
                                                             port_module):
    """The three-turn workload: the tier arm's tokens equal the drop
    baseline's and the JAX greedy rule's; P2's pressure spilled P1's two
    chains, the return visit faulted both back, and the saved-token
    ledger is (faulted + coalesced) x block_size."""
    want = [tiny.greedy(p, 3) for p in (P1, P2, P1)]
    base = make_engine(port_module, cache_blocks=4, name="kvtier-base")
    try:
        assert await three_turns(base) == want
        assert base.kv_tier is None
        ev = base.stats()["paged"]["evictions"]
        assert ev["capacity_dropped"] >= 2 and ev["capacity_spilled"] == 0
    finally:
        await base.close()

    eng = make_engine(port_module, cache_blocks=4, host_tier_blocks=8,
                      name="kvtier-hot")
    try:
        pools = [(k.data_ptr(), v.data_ptr()) for k, v in eng._caches]
        assert await three_turns(eng) == want
        # The fault-back wrote in place: captured graphs keep the pools'
        # addresses.
        assert [(k.data_ptr(), v.data_ptr()) for k, v in eng._caches] == \
            pools
        st = await settle_tier(eng)
        ht, ev = st["host_tier"], st["paged"]["evictions"]
        assert ev["capacity_spilled"] >= 2
        assert ev["capacity_dropped"] == 0
        assert ht["spills"] == ev["capacity_spilled"]
        assert ht["spill_failures"] == 0
        assert ht["faulted_blocks"] == 2
        assert ht["fault_failures"] == 0
        saved = st["paged"]["host_tier_tokens_saved"]
        assert saved == (ht["faulted_blocks"]
                         + ht["coalesced_blocks"]) * BS == 2 * BS
        assert counter("kfserving_tpu_generator_kv_tier_spills_total",
                       model="kvtier-hot", outcome="spilled") == ht["spills"]
        assert counter("kfserving_tpu_generator_kv_tier_faultbacks_total",
                       model="kvtier-hot", outcome="faulted") == 2
        assert counter("kfserving_tpu_generator_kv_tier_tokens_saved_total",
                       model="kvtier-hot") == saved
        assert counter("kfserving_tpu_generator_block_evictions_total",
                       model="kvtier-hot", cause="capacity_spilled") == \
            ev["capacity_spilled"]
        assert counter("kfserving_tpu_generator_prefix_lookups_total",
                       model="kvtier-hot", outcome="host_hit") >= 1
        assert ht["capacity_blocks"] == 8 and ht["used_blocks"] >= 2
    finally:
        await eng.close()


@pytest.mark.parametrize("site", ["engine.kv_spill", "engine.kv_faultback"])
async def test_tier_faults_degrade_to_reprefill(tiny, port_module, site):
    """A failing spill degrades each eviction to a drop; a failing
    fault-back rolls the plan back, drops the suspect chains and
    re-prefills.  Either way the tokens are the JAX rule's."""
    want = [tiny.greedy(p, 3) for p in (P1, P2, P1)]
    faults.configure({site: {"fail_first": 1000}})
    eng = make_engine(port_module, cache_blocks=4, host_tier_blocks=8,
                      name="kvtier-chaos")
    try:
        assert await three_turns(eng) == want
        st = await settle_tier(eng)
        ht, ev = st["host_tier"], st["paged"]["evictions"]
        assert ht["faulted_blocks"] == 0
        assert st["paged"]["host_tier_tokens_saved"] == 0
        if site == "engine.kv_spill":
            assert ev["capacity_spilled"] == 0
            assert ev["capacity_dropped"] >= 2
            assert ht["spill_failures"] == ev["capacity_dropped"]
            assert ht["used_blocks"] == 0 and ht["spills"] == 0
            assert counter("kfserving_tpu_generator_kv_tier_spills_total",
                           model="kvtier-chaos", outcome="failed") == \
                ht["spill_failures"]
        else:
            assert ht["spills"] >= 2
            assert ht["fault_failures"] >= 2 and ht["dropped"] >= 2
            assert ht["coalesced_blocks"] == 0
            assert counter("kfserving_tpu_generator_kv_tier_evictions_total",
                           model="kvtier-chaos",
                           reason="faultback_failed") == ht["dropped"]
            assert counter(
                "kfserving_tpu_generator_kv_tier_faultbacks_total",
                model="kvtier-chaos", outcome="failed") == \
                ht["fault_failures"]
    finally:
        await eng.close()


async def _force_spill(eng, n: int) -> None:
    """Evict n reclaimable blocks (the pool is large, so natural pressure
    would not) and let the next dispatch gather them."""
    with eng._block_lock:
        held = list(eng._free_blocks)
        eng._free_blocks.clear()
        victims = [eng._alloc_block_locked() for _ in range(n)]
        assert all(v is not None for v in victims)
        eng._free_blocks.extend(held + victims)
    await eng.complete([90, 91, 92], max_new_tokens=1)
    await settle_pool(eng)
    await settle_tier(eng)


async def test_coalesced_riders_share_one_faultback(tiny, port_module):
    """Two return visits to the same spilled conversation in one
    admission: one tier read per block, the second plan rides it, both
    get the JAX rule's tokens and the ledger counts every block once."""
    eng = make_engine(port_module, max_slots=2, cache_blocks=16,
                      host_tier_blocks=8, name="kvtier-ride")
    try:
        await eng.complete(P1 + [69], max_new_tokens=2)
        await settle_pool(eng)
        await _force_spill(eng, 2)
        assert eng.stats()["host_tier"]["used_blocks"] >= 2
        ra = eng.submit(P1 + [70], max_new_tokens=3)
        rb = eng.submit(P1 + [71], max_new_tokens=3)

        async def collect(req):
            toks = []
            async for tok, fin in eng.stream(req):
                if tok is not None:
                    toks.append(tok)
                if fin is not None:
                    return toks

        ga, gb = await asyncio.gather(collect(ra), collect(rb))
        assert ga == tiny.greedy(P1 + [70], 3)
        assert gb == tiny.greedy(P1 + [71], 3)
        await settle_pool(eng)
        st = await settle_tier(eng)
        ht = st["host_tier"]
        assert ht["faulted_blocks"] == 2 and ht["coalesced_blocks"] == 2
        assert ht["fault_failures"] == 0
        assert st["paged"]["host_tier_tokens_saved"] == \
            (ht["faulted_blocks"] + ht["coalesced_blocks"]) * BS
        assert (ra.host_tier_hit_blocks, rb.host_tier_hit_blocks) == (2, 2)
        assert ra.host_tier_saved_tokens == 2 * BS
        assert counter("kfserving_tpu_generator_kv_tier_faultbacks_total",
                       model="kvtier-ride", outcome="coalesced") == 2
    finally:
        await eng.close()


async def test_spilled_payload_is_the_jax_decoders_kv(tiny, port_module):
    """A spilled block's payload, read in the JAX layout (layer-major, k
    then v, each [BS, H, D] fp32), equals the JAX decoder's k/v of the
    same positions from its apply."""
    import jax
    import jax.numpy as jnp

    eng = make_engine(port_module, cache_blocks=16, host_tier_blocks=8,
                      name="kvtier-layout")
    try:
        await eng.complete(P1, max_new_tokens=1)
        await settle_pool(eng)
        await _force_spill(eng, 2)
        payloads = [eng.kv_tier.read(c) for c in chains_of(P1)]
    finally:
        await eng.close()
    ids = np.asarray([P1], np.int32)
    _, caches = jax.jit(lambda v, i: tiny.jax_module.apply(
        v, i, return_cache=True))(tiny.variables, jnp.asarray(ids))
    L, H = ARCH["num_layers"], ARCH["num_heads"]
    D = ARCH["hidden_size"] // H
    for c, payload in enumerate(payloads):
        got = np.frombuffer(payload, np.float32).reshape(L, 2, BS, H, D)
        for li, (k, v) in enumerate(caches):
            sl = slice(c * BS, (c + 1) * BS)
            np.testing.assert_allclose(got[li, 0], np.asarray(k)[0, sl],
                                       atol=KV_ATOL, rtol=0)
            np.testing.assert_allclose(got[li, 1], np.asarray(v)[0, sl],
                                       atol=KV_ATOL, rtol=0)


def test_host_tier_config_is_served():
    # The config carries both tier keys (no mode is refused any more, a
    # mesh's included: tests/test_torch_mesh_modes.py).
    cfg = GenerativeConfig(architecture="decoder_tiny", block_size=16,
                           host_tier_blocks=8, host_tier_dir="/tmp/kv",
                           mesh={"tp": 2})
    assert (cfg.host_tier_blocks, cfg.host_tier_dir) == (8, "/tmp/kv")
    assert not hasattr(cfg, "check_ported")
