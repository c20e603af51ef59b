"""Device mesh construction for serving replicas.

Port of ``kfserving_tpu/parallel/mesh.py``.  A serving replica owns some
set of cards; the mesh axes are the JAX package's:

- ``dp``: data parallel — request batches split across this axis; no
  parameter communication.
- ``tp``: tensor parallel — transformer weight matrices shard across this
  axis; activations all-reduce inside each layer.
- ``sp``: sequence parallel — long-context attention rotates K/V around
  this axis (ring attention).

The JAX package runs one controller that addresses every device; torch
runs one process per rank in a process group (NCCL on cards, gloo on the
CPU), so ``build_mesh`` is called by every rank of an initialized group
and returns a ``torch.distributed.device_mesh.DeviceMesh`` whose dims are
named ``dp``, ``sp``, ``tp`` (``tp`` innermost: its all-reduce runs in
every layer).  ``devices[r]`` is rank r's device.  Ranks may share one
card only over gloo (``backend="gloo"``, named by the caller); NCCL takes
one card per rank, and two NCCL ranks on one card raise.

The collectives the port's models and ring attention issue also live
here: over a gloo group a CUDA tensor is staged through pinned host
memory explicitly (gloo runs its collectives on host buffers), over NCCL
it stays on the card.
"""

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class MeshConfig:
    """Declarative mesh shape.  Sizes of 1 are valid (axis present but
    trivial) so code can always reference all three axes."""

    dp: int = 1
    tp: int = 1
    sp: int = 1
    axis_order: Sequence[str] = ("dp", "sp", "tp")

    @property
    def num_devices(self) -> int:
        return self.dp * self.tp * self.sp

    def sizes(self) -> Dict[str, int]:
        return {"dp": self.dp, "tp": self.tp, "sp": self.sp}

    @classmethod
    def from_dict(cls, mesh: Optional[Dict]) -> "MeshConfig":
        """The config.json / control-plane ``mesh`` block (other keys
        ignored, as the JAX predictors ignore them)."""
        return cls(**{k: int(v) for k, v in (mesh or {}).items()
                      if k in ("dp", "tp", "sp")})


def default_devices() -> List[torch.device]:
    """One card per rank: every visible CUDA device (none without one)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def default_backend(devices: Sequence[torch.device]) -> str:
    """NCCL on cards, gloo on the CPU."""
    return "nccl" if devices and torch.device(devices[0]).type == "cuda" \
        else "gloo"


def _world(n: int, backend: str) -> None:
    """Check (or, for one rank, create) the process group a mesh of n
    ranks runs over."""
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(
                f"a mesh of {n} ranks needs an initialized process group "
                "(parallel.multihost.initialize, or the follower launcher "
                "of parallel/follower.py)")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    if dist.get_world_size() != n:
        raise ValueError(f"mesh of {n} ranks over a process group of "
                         f"{dist.get_world_size()}")
    have = dist.get_backend()
    if have != backend:
        raise ValueError(f"mesh asks for backend {backend!r}; the process "
                         f"group runs {have!r}")


def _build(shape, names, devices, backend) -> "DeviceMesh":
    from torch.distributed.device_mesh import DeviceMesh

    n = 1
    for s in shape:
        n *= s
    devices = [torch.device(d) for d in devices[:n]]
    backend = backend or default_backend(devices)
    if backend == "nccl" and len(set(devices)) < n:
        raise ValueError(
            f"nccl takes one card per rank; {n} ranks over "
            f"{len(set(devices))} distinct devices (ranks that share a "
            "card run backend='gloo')")
    _world(n, backend)
    device = devices[dist.get_rank()]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    # A gloo mesh is a host-side mesh whatever its ranks' devices (its
    # collectives stage CUDA tensors through host memory).
    mesh = DeviceMesh("cpu" if backend == "gloo" else device.type,
                      torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(names))
    mesh.rank_devices = tuple(devices)
    mesh.backend = backend
    return mesh


def build_mesh(config: Optional[MeshConfig] = None, devices=None,
               backend: Optional[str] = None, **axis_sizes):
    """A DeviceMesh from a MeshConfig (or dp=/tp=/sp= kwargs), over the
    calling process group; every rank of the group calls it.

    Axis order puts ``tp`` innermost: tensor-parallel collectives are the
    most latency-sensitive, and neighbouring ranks are the ones a launcher
    places closest (the same card's NVLink peers).  ``backend`` defaults
    to NCCL for cards and gloo for the CPU.
    """
    if config is None:
        config = MeshConfig(**axis_sizes)
    devices = list(devices if devices is not None else default_devices())
    n = config.num_devices
    if n > len(devices):
        raise ValueError(
            f"mesh {config.sizes()} needs {n} devices; "
            f"{len(devices)} available")
    shape = tuple(getattr(config, a) for a in config.axis_order)
    return _build(shape, config.axis_order, devices, backend)


def single_device_mesh(device=None, backend: Optional[str] = None):
    """Degenerate 1-device mesh so single-card and multi-card serving
    share one code path (a one-rank group's collectives are no-ops)."""
    devices = [device] if device is not None else default_devices()[:1]
    return build_mesh(MeshConfig(), devices=devices, backend=backend)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh or a MeshConfig."""
    if isinstance(mesh, MeshConfig):
        return mesh.sizes()
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_index(mesh, axis: str) -> int:
    """This rank's index along ``axis`` (0 for an absent axis)."""
    if axis not in mesh.mesh_dim_names:
        return 0
    return mesh.get_local_rank(axis)


# -- collectives ---------------------------------------------------------------
def _staged(group) -> bool:
    """A gloo group: CUDA tensors go through host memory."""
    return dist.get_backend(group) == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    if t.device.type != "cuda":
        return t.contiguous()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return host.copy_(t)


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place; returns it.  Over gloo the sum
    runs in fp32 on the host (one rounding back to t's dtype, as a
    two-rank bf16 sum rounds once)."""
    if dist.get_world_size(group) == 1:
        return t
    if not _staged(group):
        dist.all_reduce(t, group=group)
        return t
    host = _to_host(t).float()
    dist.all_reduce(host, group=group)
    t.copy_(host.to(t.dtype))
    return t


def all_gather_cat(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Concatenate every rank's ``t`` (one shape) along ``dim`` in group
    rank order."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    src = _to_host(t) if _staged(group) else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def exchange(send: List[torch.Tensor], dst: int, src: int, group):
    """Post the sends of the tensors to global rank ``dst`` and the
    receives of their counterparts from ``src`` (one
    ``batch_isend_irecv``); returns a function that waits for them and
    returns the received tensors on the senders' device, so the caller
    computes while they travel.  Bool tensors travel as uint8."""
    staged = _staged(group)
    device = send[0].device
    ops, recv = [], []
    for t in send:
        wire = t.to(torch.uint8) if t.dtype == torch.bool else t
        wire = _to_host(wire) if staged else wire.contiguous()
        buf = torch.empty_like(wire)
        ops.append(dist.P2POp(dist.isend, wire, dst, group))
        ops.append(dist.P2POp(dist.irecv, buf, src, group))
        recv.append((buf, t.dtype))
    reqs = dist.batch_isend_irecv(ops)

    def finish() -> List[torch.Tensor]:
        for req in reqs:
            req.wait()
        return [buf.to(device).bool() if dtype == torch.bool
                else buf.to(device) for buf, dtype in recv]
    return finish


def broadcast_from_rank0(t: torch.Tensor) -> torch.Tensor:
    """Global rank 0's ``t`` written into ``t`` on every rank (one shape
    and dtype); returns it.  Over NCCL it moves on the device; over gloo
    a CUDA tensor goes through host memory.  Every rank of the world
    group calls it."""
    if dist.get_world_size() == 1:
        return t
    if dist.get_backend() != "gloo":
        dist.broadcast(t, src=0)
        return t
    host = _to_host(t)
    dist.broadcast(host, src=0)
    if host is not t:
        t.copy_(host)
    return t


def _wire(t: torch.Tensor, staged: bool) -> torch.Tensor:
    """``t`` as contiguous bytes (gloo gathers and scatters no bf16), on
    the host over gloo."""
    t = _to_host(t) if staged else t.contiguous()
    return t.view(torch.uint8)


def gather_to_rank0(t: torch.Tensor) -> Optional[List[torch.Tensor]]:
    """Every rank's ``t`` (one shape and dtype) at global rank 0, in
    rank order, on the host; None on the other ranks.  Every rank of the
    world group calls it."""
    n = dist.get_world_size()
    if n == 1:
        return [t.cpu()]
    staged = dist.get_backend() == "gloo"
    wire = _wire(t, staged)
    parts = ([torch.empty_like(wire) for _ in range(n)]
             if dist.get_rank() == 0 else None)
    dist.gather(wire, parts, dst=0)
    if parts is None:
        return None
    return [p.cpu().view(t.dtype).view(t.shape) for p in parts]


def scatter_from_rank0(parts: Optional[List[torch.Tensor]], shape,
                       dtype: torch.dtype,
                       device: torch.device) -> torch.Tensor:
    """Rank r's ``parts[r]`` (given at global rank 0, None elsewhere;
    each of ``shape`` and ``dtype``), returned on ``device``.  Every rank
    of the world group calls it."""
    if dist.get_world_size() == 1:
        return parts[0].to(device)
    staged = dist.get_backend() == "gloo"
    recv = torch.empty(shape, dtype=dtype,
                       device="cpu" if staged else device)
    send = None
    if parts is not None:
        send = [_wire(p if staged else p.to(device), staged)
                for p in parts]
    dist.scatter(recv.view(torch.uint8), send, src=0)
    return recv.to(device)
