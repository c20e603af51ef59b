"""Followers: how the port gives one serving controller several ranks.

The JAX package is one controller: one process addresses every device of
a mesh and XLA inserts the collectives (``kfserving_tpu/parallel/
sharding.py``).  torch runs one process per rank, so this module, which
has no JAX counterpart and adds no feature, supplies the other ranks:

- **Rank 0 is the serving process.**  At load, a predictor with a mesh of
  n > 1 ranks starts n - 1 follower processes (``Leader``).  Each loads
  the same config, maps the same parameters from the mmap param cache,
  keeps only its shard (``sharding.shard_module``) and follows.
- **One follower loop** mirrors every device operation rank 0 issues, in
  rank 0's order, so the ranks' collectives pair up: a predict batch
  (``run_sharded``), or a generator's device operation with its host
  inputs (tokens, lengths, slot rows, block tables, sampling arrays):
  a prefill bucket, a decode wave, a prefill chunk, a speculative wave
  (its verify; rank 0 alone runs a draft model and broadcasts its
  proposals), a feed re-sync, the gather of KV blocks rank 0
  spills or exports, the insert of blocks it faults back
  (``GenerationEngine.mirror``).  Rank 0 sends each command to every
  follower before it runs the operation itself, all from one thread (a
  generator's enqueue thread, a predict engine's batch under
  ``Leader.lock``); only rank 0 runs the scheduler, the batcher, the
  host side of sampling and the host KV tier.  A follower's decode wave
  draws the same tokens as rank 0's (the logits are replicated over
  ``tp``), which keeps its device feed equal to rank 0's.
- **Processes.**  Followers are forked from a forkserver (one per
  serving process, started at the first mesh) that has imported torch
  and this package once, so a mesh's ranks start in a fraction of a
  second after the first.  A follower never initializes CUDA before it
  is forked.
- **Commands** travel over each follower's pipe (a multiprocessing
  connection); replies (readiness, launch counts, bytes) come back on
  it.  The collectives of the model run over the process group (gloo on
  the CPU, or ranks sharing one card; NCCL with one card per rank),
  rendezvoused through a ``FileStore`` in a private temporary directory.
- **Followers never outlive their model.**  A follower exits on the stop
  command (rank 0's unload or close), at EOF on its pipe or a failed
  collective (rank 0 died: its end of the pipe and its sockets close
  with it), on SIGTERM, and, on Linux, by ``PR_SET_PDEATHSIG`` when its
  parent, the forkserver, exits (which it does after rank 0).

"""

import atexit
import contextlib
import ctypes
import datetime
import importlib
import multiprocessing
import os
import shutil
import signal
import sys
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from kfserving_tpu_torch.parallel.mesh import (
    MeshConfig,
    axis_index,
    axis_sizes,
    build_mesh,
    default_backend,
    default_devices,
)
from kfserving_tpu_torch.parallel.sharding import shard_batch

# How long a collective may wait for a peer (a first batch compiles the
# kernels' modules on every rank); read when a mesh starts, and handed to
# its followers.
COLLECTIVE_TIMEOUT_S = 600
# How long a stopped follower gets to exit before it is killed.
STOP_GRACE_S = 20.0


# What the forkserver imports once, so that each follower forked from it
# starts without importing them (torch._dynamo: a module's first
# construction on the meta device imports it).
_PRELOAD = ["kfserving_tpu_torch.parallel.follower", "torch._dynamo"]
_context = None


def _forkserver():
    global _context
    if _context is None:
        _context = multiprocessing.get_context("forkserver")
        _context.set_forkserver_preload(_PRELOAD)
        atexit.register(stop_forkserver)
    return _context


def stop_forkserver() -> None:
    """Stop the forkserver and reap it (the next mesh starts a new one).
    Its own exit follows this process's only after the process has gone;
    a program that must leave no process behind calls this (it runs at
    exit too).  The standard library stops it only through
    ``ForkServer._stop``, which its tests use; without it, nothing is
    done."""
    from multiprocessing import forkserver

    stop = getattr(forkserver._forkserver, "_stop", None)
    if stop is not None:
        stop()


def mesh_devices(mesh_block: Dict[str, Any], n: int,
                 device: torch.device) -> List[torch.device]:
    """Rank r's device for a model served on ``device``: the mesh
    block's ``devices`` when it names them, else one card per rank on
    the card, or the CPU for every rank."""
    named = mesh_block.get("devices")
    if named:
        return [torch.device(d) for d in named]
    if device.type == "cpu":
        return [torch.device("cpu")] * n
    return default_devices()


class Leader:
    """Rank 0's side of a mesh: the follower processes, their command
    channel and the mesh.  ``target`` tells a follower what to load:
    ``{"kind": "predict" | "generate", "name", "local_dir", "config"
    (the predictor config's keyword arguments), "seed"}``, or
    ``{"kind": "spmd"}`` (no model: the ranks run ``call``).  The mesh
    spans the whole group, its dims ``config``'s."""

    def __init__(self, config: MeshConfig, devices: List[torch.device],
                 backend: Optional[str], target: Dict[str, Any]):
        if dist.is_initialized():
            raise RuntimeError(
                "this process already serves a mesh (one process group a "
                "process); unload that model first")
        n = config.num_devices
        if n > len(devices):
            raise ValueError(f"mesh {config.sizes()} needs {n} devices; "
                             f"{len(devices)} available")
        devices = [torch.device(d) for d in devices[:n]]
        backend = backend or default_backend(devices)
        self.config = config
        self._dir = tempfile.mkdtemp(prefix="kfs-mesh-")
        store = os.path.join(self._dir, "store")
        self._timeout_s = COLLECTIVE_TIMEOUT_S
        init = {"store": store, "world": n, "mesh": config.sizes(),
                "devices": [str(d) for d in devices], "backend": backend,
                "target": target, "timeout_s": self._timeout_s}
        self.procs: List[Any] = []
        self._conns: List[Any] = []
        self.mesh = None
        # Held by a predict engine from a batch's command to the end of
        # its forward: the ranks run one forward at a time, in order.
        self.lock = threading.Lock()
        # One message at a time on the pipes; one question at a time.
        self._io = threading.Lock()
        self._asking = threading.Lock()
        self._closed = False
        # Meshes ``call`` built, by shape.
        self._meshes: Dict[tuple, Any] = {}
        self._join_args = (store, n, devices, backend)
        try:
            ctx = _forkserver()
            for rank in range(1, n):
                ours, theirs = ctx.Pipe()
                proc = ctx.Process(target=_follower, args=(theirs,),
                                   name=f"mesh-rank-{rank}", daemon=True)
                proc.start()
                theirs.close()
                self.procs.append(proc)
                self._conns.append(ours)
                ours.send(dict(init, rank=rank))
        except BaseException:
            self.close()
            raise

    def join(self) -> "Leader":
        """Rank 0 joins the group and builds the mesh (the followers
        start up meanwhile: a caller may load its own shard's source
        between the constructor and this call, so the followers find
        the param cache entry it stores)."""
        store, n, devices, backend = self._join_args
        try:
            dist.init_process_group(
                backend, store=dist.FileStore(store, n), rank=0,
                world_size=n,
                timeout=datetime.timedelta(seconds=self._timeout_s))
            self.mesh = build_mesh(self.config, devices=devices,
                                   backend=backend)
        except BaseException:
            self.close()
            raise
        return self

    @property
    def pids(self) -> List[int]:
        return [p.pid for p in self.procs]

    def wait_ready(self) -> List[Dict[str, Any]]:
        """The followers' load replies; raises with a follower's error."""
        return self._replies()

    def _replies(self) -> List[Any]:
        out = []
        for rank, (proc, conn) in enumerate(zip(self.procs, self._conns),
                                            start=1):
            try:
                reply = conn.recv()
            except (EOFError, OSError):
                proc.join(timeout=1.0)
                raise RuntimeError(
                    f"mesh follower rank {rank} exited "
                    f"(code {proc.exitcode})") from None
            if isinstance(reply, dict) and "error" in reply:
                raise RuntimeError(f"mesh follower rank {rank}: "
                                   f"{reply['error']}")
            out.append(reply)
        return out

    def send(self, command: tuple) -> None:
        """Send a command to every follower (rank 0 then runs it too)."""
        with self._io:
            for conn in self._conns:
                conn.send(command)

    def ask(self, command: tuple) -> List[Any]:
        """A command every follower answers (no device work): a
        follower answers once it has run every command sent before."""
        with self._asking:
            self.send(command)
            return self._replies()

    def call(self, sizes: Optional[Dict[str, int]], fn: str, *args,
             **kwargs) -> Any:
        """Run a function of the port on every rank of a ``"spmd"``
        target's group, in SPMD fashion: ``fn`` ("module:function",
        under ``kfserving_tpu_torch``) gets ``mesh=`` a mesh of ``sizes``
        over the group (built once per shape on every rank) unless
        ``sizes`` is None.  Returns rank 0's result."""
        with self.lock:
            self.send(("call", sizes, fn, args, kwargs))
            return _spmd_call(self._meshes, self.mesh, sizes, fn, args,
                              kwargs)

    def close(self) -> None:
        """Stop the followers (killed after STOP_GRACE_S) and leave the
        process group.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        for conn in self._conns:
            with contextlib.suppress(OSError, ValueError):
                conn.send(("stop",))
                conn.close()
        deadline = time.monotonic() + STOP_GRACE_S
        for proc in self.procs:
            proc.join(timeout=max(0.1, deadline - time.monotonic()))
            if proc.exitcode is None:
                proc.kill()
                proc.join()
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(self._dir, ignore_errors=True)


# -- the sharded predict forward (rank 0 and followers) -----------------------
def _split_sequence(batch: Any, mesh) -> Any:
    """This rank's sequence block of every [B, L, ...] input."""
    sp = axis_sizes(mesh).get("sp", 1)
    idx = axis_index(mesh, "sp")

    def one(x):
        if x.ndim < 2:
            return x
        if x.shape[1] % sp:
            raise ValueError(
                f"sequence length {x.shape[1]} not divisible by mesh axis "
                f"sp={sp}")
        L = x.shape[1] // sp
        return x[:, idx * L:(idx + 1) * L]

    if isinstance(batch, dict):
        return {k: one(v) for k, v in batch.items()}
    return one(batch)


def _map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: fn(v) for k, v in tree.items()}
    return fn(tree)


def _gather_to_rank0(out: torch.Tensor, mesh, dp_split: bool,
                     sp_split: bool) -> Optional[torch.Tensor]:
    """Rank 0: the global output assembled from the tp-rank-0 pieces
    (batch blocks along dim 0 over dp, sequence blocks along dim 1 over
    sp); other ranks: None.  The pieces travel through host memory."""
    n = dist.get_world_size()
    # NCCL gathers device tensors, gloo host ones.
    piece = (out.detach().contiguous() if dist.get_backend() == "nccl"
             else out.detach().cpu().contiguous())
    if n == 1:
        return piece.cpu()
    rank = dist.get_rank()
    parts = [torch.empty_like(piece) for _ in range(n)] if rank == 0 \
        else None
    dist.gather(piece, parts, dst=0)
    if rank != 0:
        return None
    parts = [p.cpu() for p in parts]
    sizes = axis_sizes(mesh)
    names = mesh.mesh_dim_names
    grid: Dict[tuple, torch.Tensor] = {}
    for r, part in enumerate(parts):
        coord = dict(zip(names, (int(i) for i in np.unravel_index(
            r, tuple(mesh.shape)))))
        if coord.get("tp", 0) != 0:
            continue
        if not dp_split and coord.get("dp", 0) != 0:
            continue
        if not sp_split and coord.get("sp", 0) != 0:
            continue
        grid[(coord.get("dp", 0), coord.get("sp", 0))] = part
    rows = []
    for d in range(sizes.get("dp", 1) if dp_split else 1):
        cols = [grid[(d, s)] for s in range(sizes.get("sp", 1)
                                            if sp_split else 1)]
        rows.append(torch.cat(cols, dim=1) if len(cols) > 1 else cols[0])
    return torch.cat(rows, dim=0) if len(rows) > 1 else rows[0]


def run_sharded(apply_fn: Callable, module: torch.nn.Module, mesh,
                batch: Any, device: torch.device) -> Any:
    """One padded predict batch (numpy, every rank the same) through
    this rank's shard: the rows of its ``dp`` block (a batch that does
    not divide is replicated), the sequence block of its ``sp`` index,
    the forward (its row-parallel projections all-reduce over ``tp``,
    its attention rotates K/V over ``sp``), then the output pieces
    gathered to rank 0.  Returns the global output on the host on rank
    0, None elsewhere."""
    sizes = axis_sizes(mesh)
    first = next(iter(batch.values())) if isinstance(batch, dict) else batch
    dp_split = sizes.get("dp", 1) > 1 and \
        first.shape[0] % sizes.get("dp", 1) == 0
    sp_split = sizes.get("sp", 1) > 1
    local = shard_batch(batch, mesh)
    if sp_split:
        local = _split_sequence(local, mesh)
    with torch.inference_mode():
        x = _map(lambda a: torch.from_numpy(np.ascontiguousarray(a))
                 .to(device), local)
        out = apply_fn(module, x)
        return _map(lambda t: _gather_to_rank0(t, mesh, dp_split,
                                               sp_split), out)


# -- the follower process ------------------------------------------------------
def _set_pdeathsig() -> None:
    if sys.platform.startswith("linux"):
        with contextlib.suppress(Exception):
            libc = ctypes.CDLL("libc.so.6", use_errno=True)
            libc.prctl(1, signal.SIGKILL)          # PR_SET_PDEATHSIG


class _PredictReplica:
    """A follower's TorchModel shard: runs each predict batch rank 0
    runs."""

    def __init__(self, target: Dict[str, Any], mesh, device):
        from kfserving_tpu_torch.predictors.torch_model import (
            TorchModel,
            TorchModelConfig,
        )

        model = TorchModel(target["name"], target["local_dir"],
                           config=TorchModelConfig(**target["config"]),
                           device=device)
        model.init_seed = target["seed"]
        self.apply, self.module = model.mesh_shard(mesh)
        self.mesh, self.device = mesh, device

    def handle(self, command: tuple) -> None:
        if command[0] == "predict":
            run_sharded(self.apply, self.module, self.mesh, command[1],
                        self.device)
        else:
            raise ValueError(f"unknown predict command {command[0]!r}")

    def report(self) -> Dict[str, Any]:
        return {"param_bytes": sum(p.numel() * p.element_size()
                                   for p in self.module.parameters())}

    def close(self) -> None:
        self.module = None


class _GenerateReplica:
    """A follower's GenerationEngine shard: its engine never schedules;
    it runs each device operation rank 0 dispatches."""

    def __init__(self, target: Dict[str, Any], mesh, device):
        from kfserving_tpu_torch.predictors.llm import (
            GenerativeConfig,
            GenerativeModel,
        )

        model = GenerativeModel(target["name"], target["local_dir"],
                                config=GenerativeConfig(**target["config"]),
                                device=device)
        self.engine = model.mesh_engine(target["local_dir"], mesh)

    def handle(self, command: tuple) -> None:
        self.engine.mirror(command)

    def report(self) -> Dict[str, Any]:
        """What this rank holds: its shard's and its KV caches' bytes,
        and its draft's (0: rank 0 alone holds the draft)."""
        return {"param_bytes": self.engine.param_bytes(),
                "cache_bytes": self.engine.cache_bytes(),
                "draft_param_bytes": self.engine.draft_param_bytes()}

    def close(self) -> None:
        self.engine.shutdown_nowait()


def _spmd_call(meshes: Dict[tuple, Any], world_mesh, sizes, fn: str,
               args: tuple, kwargs: Dict[str, Any]) -> Any:
    module_name, _, name = fn.partition(":")
    if not module_name.startswith("kfserving_tpu_torch."):
        raise ValueError(f"spmd call of {fn!r}: only the port's functions")
    target = getattr(importlib.import_module(module_name), name)
    if sizes is not None:
        key = tuple(sorted(sizes.items()))
        if key not in meshes:
            meshes[key] = build_mesh(
                MeshConfig(**sizes), devices=list(world_mesh.rank_devices),
                backend=world_mesh.backend)
        kwargs = dict(kwargs, mesh=meshes[key])
    return target(*args, **kwargs)


class _SpmdReplica:
    """A follower with no model: it runs each ``Leader.call``."""

    def __init__(self, target: Dict[str, Any], mesh, device):
        self.mesh = mesh
        self.meshes: Dict[tuple, Any] = {}

    def handle(self, command: tuple) -> None:
        if command[0] != "call":
            raise ValueError(f"unknown spmd command {command[0]!r}")
        try:
            _spmd_call(self.meshes, self.mesh, *command[1:])
        except Exception as e:
            # Every rank runs the same call: rank 0 raises the same
            # error to its caller, and the group stays usable.
            print(f"spmd call {command[2]} raised {type(e).__name__}: {e}",
                  file=sys.stderr, flush=True)

    def report(self) -> Dict[str, Any]:
        return {}

    def close(self) -> None:
        self.meshes = {}


def _launch_counts() -> Dict[str, int]:
    from kfserving_tpu_torch.ops.flash_attention import flash_attention
    from kfserving_tpu_torch.ops.paged_attention import (
        paged_attention_kernel,
    )

    return {"flash_attention": flash_attention.launches,
            "paged_attention": paged_attention_kernel.launches}


def _reset_counts() -> None:
    from kfserving_tpu_torch.ops.flash_attention import flash_attention
    from kfserving_tpu_torch.ops.paged_attention import (
        paged_attention_kernel,
    )

    flash_attention.launches = 0
    paged_attention_kernel.launches = 0


def _follower(conn) -> None:
    """A follower rank's process (forked from the forkserver): load the
    target, then run rank 0's commands until it stops or goes."""
    _set_pdeathsig()
    signal.signal(signal.SIGTERM, lambda *_: os._exit(0))
    try:
        init = conn.recv()
    except EOFError:
        os._exit(0)
    replica = None
    try:
        devices = [torch.device(d) for d in init["devices"]]
        rank = init["rank"]
        dist.init_process_group(
            init["backend"],
            store=dist.FileStore(init["store"], init["world"]),
            rank=rank, world_size=init["world"],
            timeout=datetime.timedelta(seconds=init["timeout_s"]))
        mesh = build_mesh(MeshConfig(**init["mesh"]), devices=devices,
                          backend=init["backend"])
        target = init["target"]
        kind = {"predict": _PredictReplica, "generate": _GenerateReplica,
                "spmd": _SpmdReplica}[target["kind"]]
        replica = kind(target, mesh, devices[rank])
        conn.send({"ready": rank, "pid": os.getpid()})
    except Exception as e:                      # reported to rank 0
        with contextlib.suppress(Exception):
            conn.send({"error": f"{type(e).__name__}: {e}"})
        os._exit(1)
    while True:
        try:
            command = conn.recv()
        except EOFError:
            break
        if command[0] == "stop":
            break
        if command[0] == "report":
            conn.send(dict(replica.report(), launches=_launch_counts(),
                           pid=os.getpid()))
        elif command[0] == "reset_counts":
            _reset_counts()
            conn.send({"ok": True})
        else:
            replica.handle(command)
    replica.close()
    # The process ends here: its group's sockets close with it.
    os._exit(0)

