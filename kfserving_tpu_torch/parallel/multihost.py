"""Multi-host distributed runtime: DCN x intra-node hybrid meshes.

Port of ``kfserving_tpu/parallel/multihost.py``.  Replica-to-replica
traffic stays HTTP between peers, as in the reference; what this adds is
a single *model* spanning several processes (and hosts), with its
collectives riding NVLink within a node and the data-center network
between nodes.

- ``initialize()``: one-call ``torch.distributed`` bring-up.  Every
  process runs the same binary; coordinates come from arguments or the
  JAX package's env (COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID),
  else from a launcher's own (torchrun's MASTER_ADDR, MASTER_PORT,
  WORLD_SIZE, RANK: the card's counterpart of Cloud TPU's metadata
  auto-detection).  Idempotent, and it adopts a process group that is
  already initialized.
- ``hybrid_mesh()``: a mesh whose outermost dim ("dcn") spans nodes and
  whose inner dims (dp/sp/tp) span the cards within a node.  Sharding
  rules stay written against dp/sp/tp; batches additionally split over
  "dcn" (``data_sharding``).
"""

import logging
import os
from typing import Optional

import torch.distributed as dist

from kfserving_tpu_torch.parallel.mesh import (
    MeshConfig,
    _build,
    default_backend,
    default_devices,
)
from kfserving_tpu_torch.parallel.sharding import P

logger = logging.getLogger("kfserving_tpu_torch.parallel.multihost")

_initialized = False
# The init_method this module brought the group up with.
_address: Optional[str] = None


def _init_method(address: str) -> str:
    """A coordinator address as an init_method: host:port -> tcp://;
    a URL (tcp://, file://, env://) is taken as it is."""
    return address if "://" in address else f"tcp://{address}"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> bool:
    """Bring up torch.distributed across processes; returns True when
    running distributed, False when single-process (no coordinates
    anywhere).

    Priority: explicit args > COORDINATOR_ADDRESS/NUM_PROCESSES/
    PROCESS_ID env > MASTER_ADDR:MASTER_PORT/WORLD_SIZE/RANK (torchrun).
    Single-process serving never needs this: the call is a no-op without
    coordinates.
    """
    global _initialized, _address
    if _initialized:
        return dist.get_world_size() > 1
    if dist.is_initialized():
        # Brought up externally (an entrypoint called
        # init_process_group itself): adopt it instead of a second
        # initialize, which raises.
        _initialized = True
        world = dist.get_world_size()
        if num_processes is not None and num_processes != world:
            logger.warning(
                "adopting an externally-initialized distributed "
                "runtime with %d processes, but the caller asked "
                "for %d — topology mismatch", world, num_processes)
        adopted = _address or (
            f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
            if os.getenv("MASTER_ADDR") and os.getenv("MASTER_PORT")
            else None)
        if coordinator_address is not None and adopted is not None and \
                _init_method(coordinator_address) != _init_method(adopted):
            logger.warning(
                "adopting an externally-initialized distributed "
                "runtime at %s, but the caller asked for "
                "coordinator %s — possible wrong-cluster adoption",
                adopted, coordinator_address)
        return world > 1
    coordinator_address = coordinator_address or os.getenv(
        "COORDINATOR_ADDRESS")
    if num_processes is None and os.getenv("NUM_PROCESSES"):
        num_processes = int(os.environ["NUM_PROCESSES"])
    if process_id is None and os.getenv("PROCESS_ID"):
        process_id = int(os.environ["PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        if not (os.getenv("MASTER_ADDR") and os.getenv("WORLD_SIZE")):
            logger.info("no distributed coordinates; single-process mode")
            return False
        # torchrun's coordinates.
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ.get("RANK", "0"))
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            "distributed bring-up needs a coordinator address, a process "
            f"count and a process id; got {coordinator_address!r}, "
            f"{num_processes!r}, {process_id!r}")
    backend = backend or default_backend(default_devices())
    dist.init_process_group(backend,
                            init_method=_init_method(coordinator_address),
                            world_size=int(num_processes),
                            rank=int(process_id))
    _initialized = True
    _address = coordinator_address
    logger.info("distributed runtime up: process %d/%d over %s",
                dist.get_rank(), dist.get_world_size(), backend)
    return dist.get_world_size() > 1


def hybrid_mesh(config: Optional[MeshConfig] = None,
                dcn_replicas: int = 1, devices=None,
                backend: Optional[str] = None, **axis_sizes):
    """Mesh with dims ("dcn", dp, sp, tp): "dcn" spans nodes (data
    parallel over the data-center network), the rest span the cards of
    one node.

    With dcn_replicas=1 this degenerates to a 4-dim single-node mesh,
    so code always references the same dim names whether the deployment
    is one card, one node, or several.  Ranks are laid out node-major
    (a launcher's ranks 0..n-1 are node 0's), so each node's ranks are
    one "dcn" index.
    """
    if config is None:
        config = MeshConfig(**axis_sizes)
    devices = list(devices if devices is not None else default_devices())
    per_slice = config.num_devices
    need = per_slice * dcn_replicas
    if need > len(devices):
        raise ValueError(
            f"hybrid mesh needs {need} devices "
            f"({config.sizes()} x dcn={dcn_replicas}); "
            f"{len(devices)} available")
    ici_shape = tuple(getattr(config, a) for a in config.axis_order)
    return _build((dcn_replicas,) + ici_shape,
                  ("dcn",) + tuple(config.axis_order), devices, backend)


def data_sharding(mesh) -> P:
    """Batch sharding for a hybrid mesh: the leading batch dim splits
    over (dcn, dp) — between-node data parallelism costs zero
    collectives in the forward pass (``sharding.shard_batch``)."""
    return P(("dcn", "dp"))
