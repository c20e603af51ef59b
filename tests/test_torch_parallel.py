"""The port's parallel layer (kfserving_tpu_torch/parallel/) against the
JAX package's (kfserving_tpu/parallel/) on the CPU.

The JAX side runs on conftest.py's 8 virtual host devices; the port's
ranks are processes over gloo, started by the port's own follower
launcher (parallel/follower.py: a spawned rank imports neither JAX nor
this module), with this test process as rank 0.  One 4-rank group serves
the ring-attention and mesh tests (``Leader.call`` runs a port function
on every rank); the tp parity loads go through TorchModel, which starts
its own ranks.
"""

import functools
import json
import logging
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kfserving_tpu.models import create_model as jax_create_model
from kfserving_tpu.models import init_params
from kfserving_tpu.models.registry import apply_fn_for as jax_apply_fn_for
from kfserving_tpu.ops.attention import _xla_attention
from kfserving_tpu.parallel import build_mesh as jax_build_mesh
from kfserving_tpu.parallel import hybrid_mesh as jax_hybrid_mesh
from kfserving_tpu.parallel import shard_params as jax_shard_params
from kfserving_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from kfserving_tpu.parallel.ring_attention import (
    ring_attention as jax_ring_attention,
)
from kfserving_tpu.parallel.sharding import describe as jax_describe
from kfserving_tpu.parallel.sharding import param_specs as jax_param_specs

from kfserving_tpu_torch.models import create_model
from kfserving_tpu_torch.models.weights import FLAX_CONVERTERS
from kfserving_tpu_torch.parallel import (
    MeshConfig,
    build_mesh,
    hybrid_mesh,
    multihost,
)
from kfserving_tpu_torch.parallel.follower import Leader
from kfserving_tpu_torch.parallel.sharding import (
    describe,
    local_slice,
    param_specs,
    rank_coords,
    shard_params,
)
from tests.torch_parity import randomized

RING = "kfserving_tpu_torch.parallel.ring_attention:"
TOL = 1e-5


# -- mesh shapes and errors (no group needed) ----------------------------------
def test_mesh_config_matches_jax():
    for sizes in ({}, {"dp": 2, "tp": 4}, {"sp": 3}):
        ours, theirs = MeshConfig(**sizes), JaxMeshConfig(**sizes)
        assert ours.sizes() == theirs.sizes()
        assert ours.num_devices == theirs.num_devices
        assert tuple(ours.axis_order) == tuple(theirs.axis_order)
    assert MeshConfig.from_dict({"tp": "2", "devices": ["cpu"] * 2,
                                 "backend": "gloo"}) == MeshConfig(tp=2)


@pytest.mark.parametrize("build,kw", [
    ("mesh", dict(dp=4, tp=4)),
    ("hybrid", dict(config=MeshConfig(dp=8, tp=2), dcn_replicas=2)),
])
def test_too_many_devices_raises_the_jax_text(build, kw):
    """Eight devices on both sides: the same ValueError text."""
    def outcome(fn, kwargs):
        with pytest.raises(ValueError) as e:
            fn(**kwargs)
        return str(e.value)

    if build == "mesh":
        ours = outcome(build_mesh, dict(kw, devices=["cpu"] * 8))
        theirs = outcome(jax_build_mesh, kw)
        assert "needs 16 devices" in ours
    else:
        jax_kw = dict(kw, config=JaxMeshConfig(dp=8, tp=2))
        ours = outcome(hybrid_mesh, dict(kw, devices=["cpu"] * 8))
        theirs = outcome(jax_hybrid_mesh, jax_kw)
        assert "hybrid mesh needs" in ours
    assert ours == theirs


# -- sharding rules against the JAX rules ------------------------------------
JAX_ARCHS = {
    "bert_tiny": dict(seq_len=16),
    "vit_tiny": {},
    "decoder_tiny": {},
}


def _flax_leaves(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flax_leaves(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _unflatten(leaves):
    tree = {}
    for path, v in leaves.items():
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _port_sources(arch, params):
    """Port state-dict name -> (flax path, port axis -> flax axes), from
    the converter itself: run once over leaves holding their leaf's
    number and once over leaves holding each element's flat index (both
    exact in the converter's float32), the converted tensors say which
    leaf and which elements each port tensor holds."""
    leaves = _flax_leaves(params)
    names = list(leaves)
    convert = FLAX_CONVERTERS[arch]
    ids = convert({"params": _unflatten({
        p: np.full(leaves[p].shape, i) for i, p in enumerate(names)})})
    flat = convert({"params": _unflatten({
        p: np.arange(leaves[p].size).reshape(leaves[p].shape)
        for p in names})})
    sources = {}
    for port_name, marks in ids.items():
        leaf = names[int(np.asarray(marks).flat[0])]
        coords = np.unravel_index(np.asarray(flat[port_name], np.int64),
                                  leaves[leaf].shape)
        groups = [tuple(i for i, c in enumerate(coords)
                        if np.ptp(c, axis=axis).any())
                  for axis in range(np.ndim(marks))]
        sources[port_name] = (leaf, groups)
    return sources


def _mapped_spec(jax_spec, groups):
    """A JAX spec on Flax axes as the port's spec string: each port axis
    takes the axis of the outermost Flax axis it flattens (the others
    must be unsharded, or the port's slice would not be a block)."""
    spec = tuple(jax_spec) + (None,) * 8
    out = []
    for group in groups:
        axes = [spec[i] for i in group]
        assert all(a is None for a in axes[1:]), (jax_spec, groups)
        out.append(axes[0] if axes else None)
    while out and out[-1] is None:
        out.pop()
    return "PartitionSpec(" + ", ".join(repr(a) for a in out) + ")"


def _strip(spec: str) -> str:
    """JAX prints trailing Nones; compare specs without them."""
    inner = spec[len("PartitionSpec("):-1]
    parts = [p.strip() for p in inner.split(",") if p.strip()]
    while parts and parts[-1] == "None":
        parts.pop()
    return "PartitionSpec(" + ", ".join(parts) + ")"


@functools.lru_cache(maxsize=None)
def _jax_variables(arch, **kwargs):
    """Randomized JAX variables of ``arch`` (built once a module)."""
    spec = jax_create_model(arch, **dict(JAX_ARCHS[arch], **kwargs))
    return spec, randomized(init_params(spec))


def _jax_params(arch):
    return _jax_variables(arch)[1]["params"]


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_describe_matches_jax_through_the_converters(arch):
    params = _jax_params(arch)
    theirs = jax_describe(params)
    module = create_model(arch).module
    ours = describe(module)
    sources = _port_sources(arch, params)
    assert set(ours) == set(sources)
    sharded = 0
    for name, (leaf, groups) in sources.items():
        want = _mapped_spec(eval(theirs[leaf],
                                {"PartitionSpec": lambda *a: a}), groups)
        assert _strip(ours[name]) == want, (name, leaf, theirs[leaf])
        sharded += want != "PartitionSpec()"
    assert sharded > 0


@pytest.mark.parametrize("arch,tp", [("bert_tiny", 3), ("decoder_tiny", 8),
                                     ("vit_tiny", 2)])
def test_non_dividing_guard_matches_jax(arch, tp):
    """With a mesh, an axis that does not divide a dimension replicates
    it, on the port's heads as on JAX's [in, H, D] kernels."""
    params = _jax_params(arch)
    mesh = jax_build_mesh(tp=tp)
    theirs = jax_param_specs(params, mesh=mesh)
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): spec
            for path, spec in jax.tree_util.tree_flatten_with_path(
                theirs, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]}
    ours = param_specs(create_model(arch).module, mesh=MeshConfig(tp=tp))
    for name, (leaf, groups) in _port_sources(arch, params).items():
        assert _strip(str(ours[name])) == _mapped_spec(flat[leaf], groups), \
            (name, flat[leaf])


def test_shards_equal_jax_shards_converted():
    """JAX's shard_params on the 8 host devices (dp 2 x tp 4), the
    addressable shard on device r converted, equals the port's rank-r
    shard of the converted full tensors, exactly."""
    params = _jax_params("bert_tiny")
    mesh = jax_build_mesh(dp=2, tp=4)
    with mesh:
        sharded = jax_shard_params(params, mesh)
    full = FLAX_CONVERTERS["bert_tiny"]({"params": params})
    config = MeshConfig(dp=2, tp=4)
    devices = list(mesh.devices.flat)
    for rank, device in enumerate(devices):
        shard_tree = jax.tree.map(
            lambda leaf: np.asarray(next(
                s.data for s in leaf.addressable_shards
                if s.device == device)), sharded)
        converted = FLAX_CONVERTERS["bert_tiny"]({"params": shard_tree})
        ours = shard_params(full, config, rank=rank, num_heads=4)
        assert set(ours) == set(converted)
        for name in converted:
            np.testing.assert_array_equal(
                np.asarray(ours[name]), converted[name], err_msg=name)


def test_rank_coords_and_local_slice():
    config = MeshConfig(dp=2, sp=2, tp=2)
    assert rank_coords(config, 5) == {"dp": 1, "sp": 0, "tp": 1}
    x = np.arange(16).reshape(4, 4)
    from kfserving_tpu_torch.parallel.sharding import P

    block = local_slice(x, P(("dp", "tp"), None), config.sizes(),
                        {"dp": 1, "tp": 0})
    np.testing.assert_array_equal(block, x[2:3])


# -- the 4-rank group --------------------------------------------------------
@pytest.fixture(scope="class")
def group4():
    leader = Leader(MeshConfig(sp=4), ["cpu"] * 4, "gloo",
                    {"kind": "spmd"}).join()
    leader.wait_ready()
    yield leader
    pids = leader.pids
    leader.close()
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def _qkv(seed, B, L, H=2, D=8):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, L, H, D)).astype(np.float32)
            for _ in range(3)]


def _full(q, k, v, mask):
    return np.asarray(_xla_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v),
                                     None if mask is None
                                     else jnp.asarray(mask)))


class TestGroup:
    @pytest.mark.parametrize("sizes,causal,padded", [
        ({"sp": 4}, False, False),
        ({"sp": 4}, True, False),
        ({"sp": 4}, False, True),
        ({"dp": 2, "sp": 2}, False, True),
        ({"dp": 2, "sp": 2}, True, True),
    ])
    def test_ring_attention_matches_jax_and_full(self, group4, sizes,
                                                 causal, padded):
        B, L = 2, 16
        q, k, v = _qkv(3, B, L)
        mask = None
        if padded:
            mask = np.ones((B, L), bool)
            mask[0, 10:] = False          # spans the last two ring blocks
            mask[1, :] = False            # a fully padded row
        ours = group4.call(
            sizes, RING + "ring_attention", torch.from_numpy(q),
            torch.from_numpy(k), torch.from_numpy(v), causal=causal,
            kv_mask=None if mask is None else torch.from_numpy(mask))
        jmesh = jax_build_mesh(JaxMeshConfig(**sizes))
        theirs = np.asarray(jax_ring_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jmesh,
            causal=causal, kv_mask=None if mask is None
            else jnp.asarray(mask)))
        np.testing.assert_allclose(ours.numpy(), theirs, atol=TOL,
                                   rtol=TOL)
        full_mask = None
        if causal:
            full_mask = np.tril(np.ones((L, L), bool))[None, None]
        if mask is not None:
            pad = mask[:, None, None, :]
            full_mask = pad if full_mask is None else full_mask & pad
        rows = slice(None) if not padded else slice(0, 1)
        np.testing.assert_allclose(ours.numpy()[rows],
                                   _full(q, k, v, full_mask)[rows],
                                   atol=TOL, rtol=TOL)

    def test_ring_attention_indivisible_length(self, group4):
        q, k, v = _qkv(4, 1, 10)
        with pytest.raises(ValueError) as ours:
            group4.call({"sp": 4}, RING + "ring_attention",
                        *map(torch.from_numpy, (q, k, v)))
        with pytest.raises(ValueError) as theirs:
            jax_ring_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v),
                               jax_build_mesh(JaxMeshConfig(sp=4)))
        assert str(ours.value) == str(theirs.value)

    def test_bert_hook_mask(self, group4):
        """The zoo's attn_fn contract: BERT passes the [B,1,1,L]
        broadcast mask.  The port's ring_attention folds each rank's
        block through its hook with that form of the mask; JAX's hook
        takes it on the global tensors."""
        from kfserving_tpu.parallel.ring_attention import (
            ring_attention_sharded as jax_hook,
        )

        q, _, _ = _qkv(7, 1, 8)
        mask4d = np.ones((1, 1, 1, 8), bool)
        mask4d[..., 6:] = False
        ours = group4.call({"sp": 4}, RING + "ring_attention",
                           *[torch.from_numpy(q)] * 3,
                           kv_mask=torch.from_numpy(mask4d[:, 0, 0]))
        theirs = np.asarray(jax_hook(jax_build_mesh(
            JaxMeshConfig(sp=4)))(jnp.asarray(q), jnp.asarray(q),
                                  jnp.asarray(q), jnp.asarray(mask4d)))
        np.testing.assert_allclose(ours.numpy(), theirs, atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(ours.numpy(), _full(q, q, q, mask4d),
                                   atol=TOL, rtol=TOL)

    def test_hybrid_mesh_dims(self, group4):
        degenerate = group4.call(None, "kfserving_tpu_torch.parallel."
                                 "multihost:hybrid_mesh",
                                 MeshConfig(dp=2, tp=2),
                                 devices=["cpu"] * 4)
        assert degenerate.mesh_dim_names == ("dcn", "dp", "sp", "tp")
        assert dict(zip(degenerate.mesh_dim_names, degenerate.shape)) == \
            {"dcn": 1, "dp": 2, "sp": 1, "tp": 2}
        fleet = group4.call(None, "kfserving_tpu_torch.parallel."
                            "multihost:hybrid_mesh", MeshConfig(dp=2),
                            dcn_replicas=2, devices=["cpu"] * 4)
        assert dict(zip(fleet.mesh_dim_names, fleet.shape)) == \
            {"dcn": 2, "dp": 2, "sp": 1, "tp": 1}
        theirs = jax_hybrid_mesh(JaxMeshConfig(dp=2, tp=2))
        assert tuple(theirs.axis_names) == degenerate.mesh_dim_names

    def test_build_mesh_dims_and_batch_split(self, group4):
        mesh = group4.call({"dp": 2, "tp": 2},
                           "kfserving_tpu_torch.parallel.mesh:axis_sizes")
        assert mesh == {"dp": 2, "sp": 1, "tp": 2}
        jmesh = jax_build_mesh(dp=2, tp=2)
        assert dict(jmesh.shape) == mesh
        x = np.arange(8 * 3).reshape(8, 3)
        rows = group4.call({"dp": 2, "tp": 2}, "kfserving_tpu_torch."
                           "parallel.sharding:shard_batch", x)
        np.testing.assert_array_equal(rows, x[:4])      # rank 0: dp 0
        odd = group4.call({"dp": 2, "tp": 2}, "kfserving_tpu_torch."
                          "parallel.sharding:shard_batch", x[:3])
        np.testing.assert_array_equal(odd, x[:3])       # replicated

    def test_initialize_adopts_the_group(self, group4, caplog):
        multihost._initialized = False
        try:
            with caplog.at_level(logging.WARNING,
                                 "kfserving_tpu_torch.parallel.multihost"):
                assert multihost.initialize(num_processes=3) is True
            assert "topology mismatch" in caplog.text
            assert multihost.initialize() is True       # idempotent
        finally:
            multihost._initialized = False


# -- initialize without a group ----------------------------------------------
def test_initialize_noop_without_coordinates(monkeypatch):
    for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
                "MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    multihost._initialized = False
    assert multihost.initialize() is False


INIT_FROM_ENV = """
import torch.distributed as dist
from kfserving_tpu_torch.parallel import multihost
up = multihost.initialize()
t = __import__("torch").ones(2) * (dist.get_rank() + 1)
dist.all_reduce(t)
print(up, dist.get_rank(), dist.get_world_size(), t.tolist())
dist.destroy_process_group()
"""


def test_initialize_from_env(tmp_path):
    """Two processes find each other from COORDINATOR_ADDRESS /
    NUM_PROCESSES / PROCESS_ID alone (a file:// rendezvous)."""
    procs = []
    for rank in range(2):
        env = dict(os.environ, COORDINATOR_ADDRESS=f"file://{tmp_path}/rv",
                   NUM_PROCESSES="2", PROCESS_ID=str(rank))
        for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
            env.pop(var, None)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", INIT_FROM_ENV], env=env,
            stdout=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=60)[0].split() for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert sorted(o[1] for o in outs) == ["0", "1"]
    for out in outs:
        assert out[0] == "True" and out[2] == "2"
        assert json.loads(" ".join(out[3:])) == [3.0, 3.0]


# -- tensor-parallel BERT against JAX's unsharded apply ------------------------
@pytest.mark.parametrize("tp", [2, 4])
def test_tp_bert_tiny_matches_jax_unsharded(tmp_path, tp):
    """fp32 bert_tiny under {"tp": tp} (the port's ranks over gloo)
    against JAX's unsharded jit apply on the same weights."""
    from flax import serialization

    from kfserving_tpu_torch.predictors.torch_model import TorchModel

    spec, variables = _jax_variables("bert_tiny", dtype=jnp.float32)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 1000, size=(2, 16)).astype("int32")
    batch = {"input_ids": ids, "attention_mask": np.ones((2, 16), "int32")}
    expect = np.asarray(jax.jit(jax_apply_fn_for(spec))(variables, batch))

    d = tmp_path / "m"
    d.mkdir()
    (d / "config.json").write_text(json.dumps({
        "architecture": "bert_tiny",
        "arch_kwargs": {"seq_len": 16, "dtype": "float32"},
        "batch_buckets": [2], "seq_buckets": [16], "warmup": False,
        "output": "logits", "mesh": {"tp": tp}}))
    (d / "checkpoint.msgpack").write_bytes(serialization.to_bytes(variables))
    model = TorchModel("m", str(d), device="cpu")
    model.load()
    try:
        leader = model.engine._leader
        assert len(leader.pids) == tp - 1
        q = model.module.layers[0].attention.query.weight
        assert q.shape[0] == 128 // tp                # this rank's heads
        out = model.engine.predict_sync(batch)
    finally:
        model.unload()
    np.testing.assert_allclose(out, expect, atol=1e-4, rtol=1e-4)
