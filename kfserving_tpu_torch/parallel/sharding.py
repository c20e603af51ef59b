"""Parameter and activation sharding rules.

Port of ``kfserving_tpu/parallel/sharding.py``: Megatron-style tensor
parallelism for the transformer zoo, expressed as regex -> spec rules over
the port's ``state_dict`` names (``nn.Linear`` weights are [out, in]):

- q/k/v projections shard the *heads* (output) dimension on ``tp``: each
  rank computes its own heads, no communication.
- attention output and MLP down projections shard the *input* dimension
  on ``tp``: the module all-reduces their product over the ``tp`` group
  (the psum XLA inserts in the JAX package) and adds the bias once, after
  the reduction.
- MLP up projections shard their output dimension.
- embeddings/layernorms/heads replicate.

Each rule shards the same logical dimension as the JAX package's rule for
the Flax leaf the port's tensor is converted from (``models/weights.py``).
Where JAX shards the heads axis of a [in, H, D] kernel, the port's
[H * D, in] weight is cut into whole heads: a spec built ``per_head``
checks that the mesh axis divides the head count.

``shard_params`` returns a rank's local slices; ``shard_module`` slices a
materialized module's parameters in place and hands its layers the
``tp`` process group.  There is no single controller: every rank calls
them with its own mesh coordinates.
"""

import re
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch

from kfserving_tpu_torch.parallel.mesh import MeshConfig, axis_sizes


class P(tuple):
    """A partition spec: one mesh axis name (or None, or a tuple of
    names) per tensor dim; printed as JAX prints a PartitionSpec.
    ``per_head``: the first sharded dim is whole heads (its axis must
    divide the module's head count)."""

    def __new__(cls, *axes, per_head: bool = False):
        spec = super().__new__(cls, axes)
        spec.per_head = per_head
        return spec

    def __repr__(self) -> str:
        return "PartitionSpec(" + ", ".join(repr(a) for a in self) + ")"

    __str__ = __repr__


def transformer_rules() -> Sequence[Tuple[str, P]]:
    """Rules matched against '.'-joined state_dict names, first match
    wins.  Covers models/bert.py, models/decoder.py and models/vit.py."""
    return (
        # Attention projections: Linear [H * D, hidden]
        (r".*\.(query|key|value)\.weight$", P("tp", None, per_head=True)),
        (r".*\.(query|key|value)\.bias$", P("tp", per_head=True)),
        # Attention out-proj: [hidden, H * D] — contract dims sharded
        (r".*\.out\.weight$", P(None, "tp", per_head=True)),
        # MLP up: [intermediate, hidden]
        (r".*\.(intermediate|mlp_in)\.weight$", P("tp", None)),
        (r".*\.(intermediate|mlp_in)\.bias$", P("tp")),
        # MLP down: [hidden, intermediate]
        (r".*\.(output|mlp_out)\.weight$", P(None, "tp")),
        # Everything else (embeddings, norms, heads, convs): replicated
        (r".*", P()),
    )


def _axis_size(sizes: Mapping[str, int], axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= sizes.get(a, 1)
        return n
    return sizes.get(axis, 1)


def _leaf_spec(path: str, shape: Tuple[int, ...],
               rules: Sequence[Tuple[str, P]],
               mesh=None, num_heads: Optional[int] = None) -> P:
    for pattern, spec in rules:
        if re.match(pattern, path):
            # Guard: a spec longer than the leaf's rank means the rule was
            # written for a different layer shape — replicate instead of
            # failing placement.
            if len(spec) > len(shape):
                return P()
            if mesh is not None:
                # Drop mesh axes that don't divide the dimension (e.g. 4
                # heads over tp=3): replicate that dim instead of failing.
                sizes = axis_sizes(mesh)
                cleaned = []
                for dim, axis in zip(shape, spec):
                    size = _axis_size(sizes, axis)
                    if getattr(spec, "per_head", False) and axis and \
                            num_heads is not None:
                        dim = num_heads
                    cleaned.append(axis if dim % size == 0 else None)
                return P(*cleaned)
            return spec
    return P()


def _named(params: Any) -> Dict[str, Any]:
    """name -> tensor of a module (parameters and buffers) or a state
    dict."""
    if isinstance(params, torch.nn.Module):
        return dict(params.state_dict(keep_vars=True))
    return dict(params)


def _num_heads(params: Any) -> Optional[int]:
    cfg = getattr(params, "config", None)
    return getattr(cfg, "num_heads", None)


def param_specs(params: Any,
                rules: Optional[Sequence[Tuple[str, P]]] = None,
                mesh=None, num_heads: Optional[int] = None
                ) -> Dict[str, P]:
    """name -> spec for a module or state dict.  With ``mesh`` (a
    DeviceMesh or a MeshConfig), specs are validated against leaf shapes
    (non-dividing axes replicate; a module gives its head count)."""
    rules = rules if rules is not None else transformer_rules()
    heads = num_heads if num_heads is not None else _num_heads(params)
    return {path: _leaf_spec(path, tuple(getattr(leaf, "shape", ())),
                             rules, mesh, heads)
            for path, leaf in _named(params).items()}


def rank_coords(config: MeshConfig, rank: int,
                axis_names: Optional[Sequence[str]] = None
                ) -> Dict[str, int]:
    """{axis: index} of global rank ``rank`` in a row-major mesh (the
    layout ``build_mesh`` gives)."""
    names = tuple(axis_names or config.axis_order)
    sizes = config.sizes()
    coords = {}
    for axis in reversed(names):
        n = sizes.get(axis, 1)
        coords[axis] = rank % n
        rank //= n
    return coords


def _coords(mesh, rank: Optional[int]) -> Tuple[Dict[str, int],
                                                Dict[str, int]]:
    if isinstance(mesh, MeshConfig):
        if rank is None:
            raise ValueError("a MeshConfig mesh needs the rank to shard for")
        return mesh.sizes(), rank_coords(mesh, rank)
    names = mesh.mesh_dim_names
    coord = mesh.get_coordinate()
    return axis_sizes(mesh), dict(zip(names, coord))


def local_slice(t: torch.Tensor, spec: P, sizes: Mapping[str, int],
                coords: Mapping[str, int]) -> torch.Tensor:
    """The block of ``t`` (a tensor or an array) a rank at ``coords``
    holds under ``spec``: a view."""
    out = t
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        names = axis if isinstance(axis, tuple) else (axis,)
        n, idx = 1, 0
        for a in names:              # the first name is the outermost
            idx = idx * sizes.get(a, 1) + coords.get(a, 0)
            n *= sizes.get(a, 1)
        if n == 1:
            continue
        step = out.shape[dim] // n
        out = out[(slice(None),) * dim + (slice(idx * step,
                                                (idx + 1) * step),)]
    return out


def shard_params(params: Any, mesh,
                 rules: Optional[Sequence[Tuple[str, P]]] = None,
                 rank: Optional[int] = None,
                 num_heads: Optional[int] = None) -> Dict[str, Any]:
    """This rank's local slices of a module's or state dict's tensors
    (contiguous; a slice along dim 0 is a view), per the rules.  ``mesh`` is the rank's
    DeviceMesh, or a MeshConfig with the global ``rank`` to shard for."""
    specs = param_specs(params, rules, mesh=mesh, num_heads=num_heads)
    sizes, coords = _coords(mesh, rank)
    return {name: local_slice(torch.as_tensor(t), specs[name], sizes,
                              coords).contiguous()
            for name, t in _named(params).items()}


def shard_bytes(module: torch.nn.Module, mesh,
                rules: Optional[Sequence[Tuple[str, P]]] = None) -> int:
    """Parameter and buffer bytes of one rank's shard of ``module``
    (meta tensors included; every rank's shard is the same size): what
    a rank books in its HBM ledger."""
    specs = param_specs(module, rules, mesh=mesh)
    sizes = axis_sizes(mesh)
    total = 0
    for name, t in _named(module).items():
        n = t.numel()
        for axis in specs[name]:
            n //= _axis_size(sizes, axis)
        total += n * t.element_size()
    return total


def replicate_params(params: Any, mesh) -> Dict[str, Any]:
    """Fully replicate (dp-only serving; ResNet/MLP zoo): every rank
    holds every tensor."""
    return _named(params)


def shard_module(module: torch.nn.Module, mesh,
                 rules: Optional[Sequence[Tuple[str, P]]] = None
                 ) -> torch.nn.Module:
    """Slice a materialized module's parameters to this rank's shard in
    place (the full tensors are freed) and give its config the mesh's
    ``tp`` group, which its row-parallel projections all-reduce over.
    With tp = 1 only the group is set (None)."""
    cfg = getattr(module, "config", None)
    tp = axis_sizes(mesh).get("tp", 1)
    if tp > 1:
        local = shard_params(module, mesh, rules)
        with torch.no_grad():
            for name, t in module.state_dict(keep_vars=True).items():
                if tuple(local[name].shape) != tuple(t.shape):
                    # A copy: a view would keep the full storage alive.
                    t.data = local[name].clone()
    if cfg is not None:
        cfg.tp_group = mesh.get_group("tp") if tp > 1 else None
    return module


def batch_sharding(mesh, batch_axis="dp") -> P:
    """Input batches split along dp; all other dims replicated."""
    return P(batch_axis)


def shard_batch(batch: Any, mesh, batch_axis="dp", rank: Optional[int] = None
                ) -> Any:
    """This rank's rows of a batch (an array or tensor, or a dict of
    them): the leading dim splits over ``batch_axis``.  A batch that does
    not divide by the axis size is replicated, as ring attention
    replicates a batch it cannot split."""
    sizes, coords = _coords(mesh, rank)
    spec = batch_sharding(mesh, batch_axis)

    def one(x):
        if x.shape[0] % _axis_size(sizes, batch_axis):
            return x
        return local_slice(x, spec, sizes, coords)

    if isinstance(batch, dict):
        return {k: one(v) for k, v in batch.items()}
    return one(batch)


def describe(params: Any,
             rules: Optional[Sequence[Tuple[str, P]]] = None
             ) -> Dict[str, str]:
    """name -> spec string, for debugging/ops visibility."""
    rules = rules if rules is not None else transformer_rules()
    return {path: str(_leaf_spec(path, tuple(getattr(leaf, "shape", ())),
                                 rules))
            for path, leaf in _named(params).items()}
