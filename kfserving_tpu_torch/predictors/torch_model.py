"""TorchModel: the port's predictor for the jaxserver artifact format.

Port of ``kfserving_tpu/predictors/jax_model.py`` (``JaxModel``): load a
model from the registry plus its weights, run shape-bucketed batches on
the card, and serve V1/V2 predict through the in-process dynamic batcher.
Weights load through the mmap param cache (``engine/param_cache.py``):
the first load of an artifact materializes and stores its state dict,
later loads map it (``param_source`` "mmap"), and the mapped tensors are
the engine's host restore source.  With an ``HBMManager`` the model's
parameter and buffer bytes are admitted before it is built (evicting
least-recently-used models), and a reload is staged beside the serving
generation, as in the JAX package.  With a ``ResidencyManager`` the model
is demand-paged: ``register()`` only reads its config, the predict path
faults it onto the card, and eviction offloads its params to the mapped
host copy (``offload``/``fault_in``).

Model directory layout (``model_dir`` is a storage URI: a local path,
``file://``, ``http(s)://``, ``gs://``, ``s3://`` or an Azure blob URL,
pulled through ``Storage.download`` as the JAX package pulls it):

    config.json          — required; see TorchModelConfig
    checkpoint.msgpack   — Flax ``to_bytes`` variables as the JAX package
                           writes them (optional: absent -> seeded random
                           init)

config.json keys (all optional except architecture), with the JAX
package's defaults:
    {
      "architecture": "resnet50" | "bert" | "vit_b16" | "mlp" | <registered>,
      "arch_kwargs": {...},            # forwarded to the registry factory
      "max_batch_size": 32,            # bucket ceiling (pow2 buckets)
      "batch_buckets": [1, 4, 16],     # explicit batch buckets
      "max_latency_ms": 5.0,           # batcher flush deadline
      "seq_buckets": [64, 128, 256],   # seq-len buckets (token models)
      "pipeline_depth": 2,             # engine worker threads
      "warmup": true,                  # compile every bucket shape at load
      "input_dtype": "uint8"|"float32",# client payload dtype on the wire
      "scale": 0.00392156862,          # on-device input scaling (1/255)
      "output": "logits"|"argmax"|"topk",
      "topk": 5,
      "mesh": {"dp": 1, "tp": 1, "sp": 1}  # see below
    }

A ``mesh`` of more than one rank serves the model sharded (as the JAX
package's load path does): ``tp`` shards the transformer weights
(``parallel/sharding.py``), ``dp`` splits each batch, and ``sp`` (BERT
only) splits each sequence and serves ring attention.  This process is
rank 0; it starts the other ranks (``parallel/follower.py``), which load
the same artifact and follow its batches.  The ranks run on one card
each over NCCL, or on the CPU over gloo when the model serves on the
CPU; the block's optional ``"devices"`` (one per rank, e.g. ``["cuda:0",
"cuda:0"]``) and ``"backend"`` (``"gloo"`` for ranks sharing a card)
override that.  A sharded engine runs eagerly (no CUDA graphs) and is
not offloadable.
"""

import json
import logging
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from kfserving_tpu_torch import startup
from kfserving_tpu_torch.batching import DynamicBatcher
from kfserving_tpu_torch.engine import compile_cache, graphs, param_cache
from kfserving_tpu_torch.engine.buckets import BucketPolicy
from kfserving_tpu_torch.engine.hbm import HBMManager, InsufficientHBM
from kfserving_tpu_torch.engine.torch_engine import (
    TorchEngine,
    module_bytes,
    resolve_device,
)
from kfserving_tpu_torch.model.model import Model
from kfserving_tpu_torch.models import apply_fn_for, create_model
from kfserving_tpu_torch.ops.flash_attention import check_kernel_shapes
from kfserving_tpu_torch.parallel.mesh import MeshConfig
from kfserving_tpu_torch.parallel.sharding import shard_bytes
from kfserving_tpu_torch.protocol import v1
from kfserving_tpu_torch.protocol.errors import InferenceError, InvalidInput
from kfserving_tpu_torch.protocol.v2 import (
    InferRequest,
    datatype_of,
    make_response,
)
from kfserving_tpu_torch.server.dataplane import is_v2_request
from kfserving_tpu_torch.storage import Storage

logger = logging.getLogger("kfserving_tpu_torch.predictors")

DEFAULT_CONFIG_NAME = "config.json"
CHECKPOINT_NAME = param_cache.CHECKPOINT_NAME


class TorchModelConfig:
    def __init__(self, architecture: str, arch_kwargs: Optional[Dict] = None,
                 max_batch_size: int = 32, max_latency_ms: float = 5.0,
                 batch_buckets: Optional[List[int]] = None,
                 seq_buckets: Optional[List[int]] = None,
                 input_dtype: str = "float32", scale: Optional[float] = None,
                 output: str = "logits", topk: int = 5,
                 warmup: bool = True, pipeline_depth: int = 2,
                 mesh: Optional[Dict[str, Any]] = None,
                 **_ignored):
        # The control plane injects `mesh` as an override.
        self.mesh = dict(mesh or {})
        if any(int(v) < 1 for k, v in self.mesh.items()
               if k in ("dp", "tp", "sp")):
            raise InvalidInput(f"mesh axes must be >= 1, got {mesh}")
        self.architecture = architecture
        self.arch_kwargs = arch_kwargs or {}
        self.max_batch_size = max_batch_size
        self.max_latency_ms = max_latency_ms
        self.batch_buckets = batch_buckets
        self.seq_buckets = seq_buckets
        self.input_dtype = input_dtype
        self.scale = scale
        self.output = output
        self.topk = topk
        self.warmup = warmup
        self.pipeline_depth = pipeline_depth

    @classmethod
    def from_file(cls, path: str,
                  overrides: Optional[Dict[str, Any]] = None
                  ) -> "TorchModelConfig":
        with open(path) as f:
            data = json.load(f)
        if overrides:
            data.update(overrides)
        if "architecture" not in data:
            raise InvalidInput(f"{path} missing required key 'architecture'")
        return cls(**data)


class TorchModel(Model):
    """A served PyTorch model with bucketed batched execution."""

    def __init__(self, name: str, model_dir: str,
                 config: Optional[TorchModelConfig] = None,
                 config_overrides: Optional[Dict[str, Any]] = None,
                 device: Any = "cuda", hbm: Optional[HBMManager] = None,
                 residency=None):
        super().__init__(name)
        self.model_dir = model_dir
        self.config = config
        self.config_overrides = dict(config_overrides or {})
        self.device = resolve_device(device)
        self.hbm = hbm
        # ResidencyManager (engine/residency.py): when set, the model is
        # demand-paged.
        self.residency = residency
        self.engine: Optional[TorchEngine] = None
        self.batcher: Optional[DynamicBatcher] = None
        self.module: Optional[torch.nn.Module] = None
        self._spec = None
        # The V2 signature metadata() reports, traced once per load.
        self._signature: Optional[Dict[str, Any]] = None
        # The artifact's local directory once Storage.download pulled it.
        self._local_dir: Optional[str] = None
        # How the weights were materialized: "mmap" (param-cache hit),
        # "checkpoint" or "init".
        self.param_source: Optional[str] = None
        # Seed of the random init served when the artifact has no
        # checkpoint.  Not a config.json key (the artifact format is the
        # JAX package's); a program building a catalog in process may set
        # it before the first load to give each model its own weights.
        self.init_seed = 0

    # -- lifecycle ---------------------------------------------------------
    def _read_config(self) -> TorchModelConfig:
        if self.config is None:
            self.config = TorchModelConfig.from_file(
                os.path.join(self._local_dir, DEFAULT_CONFIG_NAME),
                overrides=self.config_overrides)
        return self.config

    def register(self) -> bool:
        """Declarative registration (residency mode): download the
        artifact and parse the config, touch no device memory.  The model
        is ``ready`` (addressable); its first predict cold-faults it
        in."""
        startup.mark("load_start")
        self._local_dir = Storage.download(self.model_dir)
        startup.mark("download")
        self._read_config()
        if self.residency is not None:
            self.residency.register(self.name, self)
        self.ready = True
        return True

    def load(self) -> bool:
        startup.mark("load_start")
        if self.residency is None or not self._local_dir:
            # A managed cold fault reuses what register() pulled: the
            # admission wait retries load(), and a remote URI must not
            # be pulled into a fresh directory per retry.
            self._local_dir = Storage.download(self.model_dir)
        local_dir = self._local_dir
        startup.mark("download")
        cfg = self._read_config()
        spec = create_model(cfg.architecture, **cfg.arch_kwargs)
        check_kernel_shapes(spec.module, self.device)
        mesh_cfg = MeshConfig.from_dict(cfg.mesh)
        sharded = mesh_cfg.num_devices > 1
        if sharded and mesh_cfg.sp > 1:
            self._check_sequence_parallel(spec, cfg)
        if sharded and self.engine is not None:
            # One process group a process: the serving generation's mesh
            # goes before the new one starts (downtime).
            self._drop_generation()
            if self.hbm is not None:
                self.hbm.release(self.name)
        # Reload is transactional: the new generation is built aside and
        # swapped in only on success.  Both are resident until the swap,
        # so the new one is admitted under a staging key beside the old
        # entry; with no headroom for both, the old generation is closed
        # first (downtime, but never an overcommitted card).
        old_engine = self.engine
        staging_key = f"{self.name}!staging"   # '!' is not in model names
        zero_downtime = True
        if self.hbm is not None:
            # Each rank books its own shard.
            nbytes = (shard_bytes(spec.module, mesh_cfg) if sharded
                      else module_bytes(spec.module))
            if old_engine is None:
                self.hbm.admit(self.name, nbytes)
            else:
                try:
                    # Staging never evicts live models, this one's
                    # serving generation included.
                    self.hbm.admit(staging_key, nbytes, evict=False)
                except InsufficientHBM:
                    zero_downtime = False
                    self._drop_generation()
                    old_engine = None
                    self.hbm.release(self.name)
                    self.hbm.admit(self.name, nbytes)
        try:
            # A managed model pins its params with one restore() of the
            # mapped tensors, into one device block as every warm fault
            # places them; on a cache hit they are not copied in twice.
            pin = self.residency is not None and not sharded
            # The other ranks start up while this one materializes; they
            # load once it has joined, and map the entry it stored.
            leader = (self._start_mesh(mesh_cfg, cfg, local_dir)
                      if sharded else None)
            try:
                module, host, source = param_cache.load_or_materialize(
                    cfg.architecture, cfg.arch_kwargs, spec, local_dir,
                    self.device, checkpoint_name=CHECKPOINT_NAME,
                    seed=self.init_seed, fill=not pin)
                self.param_source = source
                if leader is not None:
                    self._shard(module, leader.join().mesh)
                    leader.wait_ready()
                    # A shard has no host restore source: not offloadable.
                    host = None
                engine, batcher = self._build_engine(spec, module, host,
                                                     cfg, pin, leader)
            except BaseException:
                if leader is not None:
                    leader.close()
                raise
            if self.hbm is not None and engine.booked_bytes() != nbytes:
                # The warmed graphs' pool joins the booking, evicting as
                # the parameters' admission did.
                staged = old_engine is not None
                try:
                    self.hbm.admit(staging_key if staged else self.name,
                                   engine.booked_bytes(), evict=not staged)
                except Exception:
                    engine.close()
                    raise
        except Exception:
            if self.hbm is not None:
                self.hbm.release(staging_key if old_engine is not None
                                 else self.name)
            raise
        self._spec, self.module = spec, module
        self.engine, self.batcher = engine, batcher
        self._signature = None
        self.ready = True
        if old_engine is not None:
            old_engine.close()
            if self.hbm is not None and zero_downtime:
                self.hbm.commit(staging_key, self.name,
                                engine.booked_bytes())
        if self.hbm is not None:
            # A bucket captured later (past a minimal warmup, or after a
            # restore beyond the warmed grid's pool) grows the booking.
            engine.on_capture = lambda nbytes: self.hbm.resize(
                self.name, nbytes)
        if self.residency is not None:
            # Idempotent on a cold fault (the manager holds the record);
            # a direct load joins the managed set as resident.
            self.residency.register(self.name, self)
        return True

    def _check_sequence_parallel(self, spec, cfg: TorchModelConfig) -> None:
        """sp > 1 serves ring attention through the model's attention
        hook over sequence-sharded activations; an architecture without
        both fails at load, never silently serving unsharded."""
        mcfg = getattr(spec.module, "config", None)
        if not (hasattr(mcfg, "attn_fn") and hasattr(mcfg, "seq_shard")):
            raise InvalidInput(
                f"architecture {cfg.architecture!r} does not support "
                f"sequence parallelism (no pluggable attention hook over "
                f"a sequence-sharded input)")

    def _start_mesh(self, mesh_cfg: MeshConfig, cfg: TorchModelConfig,
                    local_dir: str):
        """Start the mesh's other ranks (rank 0 is this process)."""
        from kfserving_tpu_torch.parallel.follower import (
            Leader,
            mesh_devices,
        )

        devices = mesh_devices(cfg.mesh, mesh_cfg.num_devices, self.device)
        return Leader(mesh_cfg, devices, cfg.mesh.get("backend"),
                      {"kind": "predict", "name": self.name,
                       "local_dir": local_dir, "config": dict(vars(cfg)),
                       "seed": self.init_seed})

    @staticmethod
    def _shard(module, mesh) -> None:
        """Keep this rank's shard of the module; under sp, serve ring
        attention through its hook (the JAX package rebuilds the module
        with the hook; here the live module's config takes it) over the
        rank's sequence block."""
        from kfserving_tpu_torch.parallel.mesh import axis_index, axis_sizes
        from kfserving_tpu_torch.parallel.ring_attention import (
            ring_attention_sharded,
        )
        from kfserving_tpu_torch.parallel.sharding import shard_module

        shard_module(module, mesh)
        if axis_sizes(mesh).get("sp", 1) > 1:
            module.config.attn_fn = ring_attention_sharded(mesh)
            module.config.seq_shard = axis_index(mesh, "sp")

    def mesh_shard(self, mesh):
        """A follower rank's load: (serve function, this rank's shard
        of the module), from the artifact's directory (``model_dir`` is
        the rank 0's local copy) and the given config."""
        cfg = self._read_config()
        spec = create_model(cfg.architecture, **cfg.arch_kwargs)
        check_kernel_shapes(spec.module, self.device)
        module, _, self.param_source = param_cache.load_or_materialize(
            cfg.architecture, cfg.arch_kwargs, spec, self.model_dir,
            self.device, checkpoint_name=CHECKPOINT_NAME,
            seed=self.init_seed)
        self._shard(module, mesh)
        return self._serve_fn(spec, cfg), module

    @staticmethod
    def _serve_fn(spec, cfg: TorchModelConfig):
        base_apply = apply_fn_for(spec)
        # The JAX package computes x.astype(bf16) * scale with the weakly
        # typed scale rounded to bf16, and XLA keeps the product in fp32
        # when the model casts it on at once: the port multiplies in fp32
        # by the bf16-rounded scale, and the model rounds to its dtype.
        scale = (None if cfg.scale is None else
                 float(torch.tensor(cfg.scale, dtype=torch.bfloat16)))
        output_mode, topk = cfg.output, cfg.topk

        def serve_fn(m, batch):
            x = batch
            if not isinstance(x, dict) and scale is not None:
                x = x.float() * scale
            out = base_apply(m, x)
            if output_mode == "argmax":
                return out.argmax(dim=-1).to(torch.int32)
            if output_mode == "topk":
                vals, idx = torch.topk(out, topk, dim=-1)
                return {"values": vals.float(),
                        "indices": idx.to(torch.int32)}
            return out
        return serve_fn

    def _build_engine(self, spec, module, host, cfg: TorchModelConfig,
                      pin: bool = False, leader=None):
        serve_fn = self._serve_fn(spec, cfg)
        seq_buckets = (BucketPolicy(cfg.seq_buckets)
                       if cfg.seq_buckets else None)
        engine = TorchEngine(
            serve_fn, module,
            batch_buckets=(BucketPolicy(cfg.batch_buckets)
                           if cfg.batch_buckets
                           else BucketPolicy.pow2(cfg.max_batch_size)),
            seq_buckets=seq_buckets,
            pipeline_depth=cfg.pipeline_depth,
            device=self.device, host_params=host, leader=leader)
        if self.hbm is not None and self.device.type == "cuda":
            self.hbm.set_shared("cublas_workspace", graphs.workspace_bytes[
                self.device.index if self.device.index is not None
                else torch.cuda.current_device()])
        try:
            if pin and engine.offloadable:
                engine.restore()
            if cfg.warmup:
                # Recycle successors trim the grid, as the JAX predictor
                # does: the largest batch bucket per seq bucket, the rest
                # compiled at their first request.
                minimal = os.environ.get("KFS_MINIMAL_WARMUP", "") \
                    not in ("", "0", "false")
                engine.warmup(self._example_instance(spec),
                              minimal=minimal)
                if not minimal:
                    compile_cache.declare_warmup_complete(
                        engine.compile_source)
        except Exception:
            engine.close()
            raise
        batcher = DynamicBatcher(
            self._batch_handler,
            max_batch_size=(max(cfg.batch_buckets) if cfg.batch_buckets
                            else cfg.max_batch_size),
            max_latency_ms=cfg.max_latency_ms,
            key_fn=self._bucket_key if seq_buckets else None,
            # One more than the engine's workers, so a batch is always
            # staged when a worker frees.
            max_inflight=cfg.pipeline_depth + 1,
            buckets=engine.batch_buckets.buckets)
        return engine, batcher

    def _example_instance(self, spec):
        if isinstance(spec.example, dict):
            return {k: np.asarray(v)[0] for k, v in spec.example.items()}
        ex = np.asarray(spec.example)[0]
        if self.config.input_dtype == "uint8":
            return np.zeros(ex.shape, np.uint8)
        return ex.astype(self.config.input_dtype)

    def _drop_generation(self) -> None:
        """Close the engine and drop every reference to the module, so
        its device memory is freed."""
        self.ready = False
        if self.engine is not None:
            self.engine.close()
        self.engine, self.batcher = None, None
        self.module, self._spec = None, None

    def unload(self) -> None:
        if self.residency is not None:
            self.residency.deregister(self.name)
        self._drop_generation()
        if self.hbm is not None:
            self.hbm.release(self.name)

    # -- residency hooks (engine/residency.py contract) --------------------
    @property
    def offloadable(self) -> bool:
        """Can the model leave the card and keep its warm engine?  True
        once the engine holds a host (mmap) restore source."""
        return self.engine is not None and self.engine.offloadable

    def offload(self) -> None:
        """Eviction body: drop the device params, keep the engine, its
        batcher and the host mmap params.  The model stays ``ready``."""
        if self.engine is not None:
            self.engine.offload()

    def demote(self) -> None:
        """Eviction body of a model without a host restore source: drop
        the engine.  The model stays registered and addressable; its next
        predict cold-faults a fresh build."""
        if self.engine is not None:
            self.engine.close()
        self.engine, self.batcher = None, None
        self.module, self._spec = None, None

    def fault_in(self) -> None:
        """Warm fault body (blocking; residency executor): copy the host
        params back onto the card."""
        if self.engine is None:
            raise InferenceError(
                f"model {self.name} has no engine to fault in")
        self.engine.restore()

    def host_bytes(self) -> int:
        """Device bytes a fault-in of this model claims: its parameters
        and its warmed grid's graph pool (a restored engine captures its
        buckets again as they are hit)."""
        if self.engine is None:
            return 0
        return self.engine.booked_bytes()

    @property
    def wire_dtype(self) -> Optional[str]:
        """Dtype hint for the server's native V1 JSON parser: a uint8
        model takes integer image bodies straight to uint8 on the wire."""
        if self.config is not None and self.config.input_dtype == "uint8":
            return "u1"
        return None

    # -- inference ---------------------------------------------------------
    def _bucket_key(self, instance: Any):
        """Seq-bucket key: instances whose (padded) seq length lands in
        different buckets never share a batch."""
        arr = (next(iter(instance.values())) if isinstance(instance, dict)
               else instance)
        arr = np.asarray(arr)
        n = arr.shape[0] if arr.ndim else 1
        bucket = self.engine.seq_buckets.fit(n)
        if bucket is None:
            raise InvalidInput(
                f"sequence length {n} exceeds the largest bucket "
                f"{self.engine.seq_buckets.max}")
        return bucket

    async def _batch_handler(self, instances: List[Any], key=None
                             ) -> List[Any]:
        first = instances[0]
        if isinstance(first, dict):
            batch = {}
            for k in first:
                rows = [np.asarray(inst[k]) for inst in instances]
                if key is not None:  # pad rows to the shared seq bucket
                    rows = [self._pad_seq(r, key) for r in rows]
                batch[k] = np.stack(rows)
            if "attention_mask" in batch:
                self._check_prefix_mask(batch["attention_mask"])
        else:
            rows = [np.asarray(inst) for inst in instances]
            lengths = [r.shape[0] if r.ndim else 1 for r in rows]
            if key is not None:
                rows = [self._pad_seq(r, key) for r in rows]
            batch = np.stack(rows)
            if self.config.input_dtype == "uint8":
                batch = batch.astype(np.uint8)
            if (isinstance(self._spec.example, dict)
                    and "attention_mask" in self._spec.example):
                # Bare token rows take the model's dict signature with a
                # synthesized suffix padding mask.
                primary = next(iter(self._spec.example))
                mask = np.zeros(batch.shape[:2], np.int32)
                for i, n in enumerate(lengths):
                    mask[i, :n] = 1
                batch = {primary: batch, "attention_mask": mask}
        out = await self.engine.predict(batch)
        return self._scatter(out, len(instances))

    def _check_prefix_mask(self, mask: np.ndarray) -> None:
        """BERT models with prefix_padding (the default) read
        attention_mask as suffix padding and give it to the flash kernel
        as lengths; any other mask would be silently wrong there, so
        reject it on the host."""
        if not self.config.architecture.startswith("bert"):
            return
        if not self.config.arch_kwargs.get("prefix_padding", True):
            return
        m = np.asarray(mask)
        if m.ndim != 2:
            return
        # suffix form == row values never increase (1s then 0s)
        if np.any(np.diff(m.astype(np.int8), axis=1) > 0):
            raise InvalidInput(
                "attention_mask is not suffix padding (1s then 0s); "
                "this model serves masks as sequence lengths "
                "(prefix_padding). Set arch_kwargs.prefix_padding=false "
                "in the model config to serve arbitrary mask patterns.")

    @staticmethod
    def _pad_seq(row: np.ndarray, bucket: int) -> np.ndarray:
        if row.shape[0] == bucket:
            return row
        pad = [(0, bucket - row.shape[0])] + [(0, 0)] * (row.ndim - 1)
        return np.pad(row, pad)

    @staticmethod
    def _scatter(out: Any, n: int) -> List[Any]:
        if isinstance(out, dict):
            return [{k: v[i] for k, v in out.items()} for i in range(n)]
        return [out[i] for i in range(n)]

    async def predict(self, request: Any) -> Any:
        if self.residency is not None:
            # The residency gate: count the request in flight (a model
            # with queued work is never evicted), fault the model in if
            # needed, and touch the ledger.
            async with self.residency.serving(self.name):
                return await self._predict_resident(request)
        if self.hbm is not None:
            self.hbm.touch(self.name)     # LRU order follows use
        return await self._predict_resident(request)

    async def _predict_resident(self, request: Any) -> Any:
        if self.batcher is None:
            raise InferenceError(f"model {self.name} not loaded")
        if isinstance(request, InferRequest) or is_v2_request(request):
            return await self._predict_v2(request)
        instances = v1.get_instances(request)
        result = await self.batcher.submit(instances)
        return v1.make_response([_tolist(p) for p in result.predictions])

    async def _predict_v2(self, request: Any) -> Dict[str, Any]:
        req = (request if isinstance(request, InferRequest)
               else InferRequest.from_dict(request))
        named = req.named_numpy()
        if len(named) == 1:
            batch = next(iter(named.values()))
            instances = [batch[i] for i in range(batch.shape[0])]
        else:
            n = next(iter(named.values())).shape[0]
            instances = [{k: v[i] for k, v in named.items()}
                         for i in range(n)]
        result = await self.batcher.submit(instances)
        preds = result.predictions
        if preds and isinstance(preds[0], dict):
            outputs = {k: np.stack([p[k] for p in preds])
                       for k in preds[0]}
        else:
            outputs = {"output_0": np.stack(preds)}
        return make_response(self.name, outputs, id=req.id)

    # -- metadata ----------------------------------------------------------
    def metadata(self) -> Dict[str, Any]:
        meta = super().metadata()
        if self.engine is None or self.config is None:
            return meta
        meta["platform"] = "pytorch"
        meta["architecture"] = self.config.architecture
        meta["batch_buckets"] = list(self.engine.batch_buckets.buckets)
        if self.engine.seq_buckets:
            meta["seq_buckets"] = list(self.engine.seq_buckets.buckets)
        if self._signature is None:
            self._signature = self._signature_metadata()
        meta.update(self._signature)
        return meta

    def _signature_metadata(self) -> Dict[str, Any]:
        """V2 model-metadata inputs and outputs, as the JAX package
        reports them: the serving function run on a fresh meta-device
        module and meta tensors (no storage, no compute, no device
        work).  The batch dim reports -1."""
        def on_meta(arr: np.ndarray) -> torch.Tensor:
            return torch.empty(arr.shape, device="meta",
                               dtype=torch.from_numpy(arr[:0]).dtype)

        def v2_datatype(dtype: torch.dtype) -> str:
            empty = torch.empty(0, dtype=dtype)
            return datatype_of(empty if dtype == torch.bfloat16
                               else empty.numpy())

        try:
            cfg = self.config
            spec = create_model(cfg.architecture, **cfg.arch_kwargs)
            example = spec.example
            if isinstance(example, dict):
                example = {k: np.asarray(v) for k, v in example.items()}
                inputs = [{"name": k, "datatype": datatype_of(v),
                           "shape": [-1] + list(v.shape[1:])}
                          for k, v in example.items()]
                batch = {k: on_meta(v) for k, v in example.items()}
            else:
                example = np.asarray(example)
                if cfg.input_dtype == "uint8":
                    example = example.astype(np.uint8)
                inputs = [{"name": "input_0",
                           "datatype": datatype_of(example),
                           "shape": [-1] + list(example.shape[1:])}]
                batch = on_meta(example)
            with torch.no_grad():
                out = self._serve_fn(spec, cfg)(spec.module, batch)
            leaves = (out.items() if isinstance(out, dict)
                      else [("output_0", out)])
            outputs = [{"name": k, "datatype": v2_datatype(leaf.dtype),
                        "shape": [-1] + list(leaf.shape[1:])}
                       for k, leaf in leaves]
            return {"inputs": inputs, "outputs": outputs}
        except Exception:  # metadata is best-effort, never fatal
            logger.debug("signature metadata unavailable", exc_info=True)
            return {}

    def engine_stats(self) -> Dict[str, Any]:
        stats = dict(self.engine.stats()) if self.engine else {}
        stats["param_source"] = self.param_source
        if self.batcher:
            stats["batches_flushed"] = self.batcher.batches_flushed
            stats["instances_batched"] = self.batcher.instances_batched
            if self.batcher.queue_age_ms:
                # Per-bucket flush-time queue age (the starvation
                # diagnostic), exported as labeled series on /metrics.
                stats["bucket_queue_age_max_ms"] = {
                    str(k): v["max"]
                    for k, v in self.batcher.queue_age_ms.items()}
        return stats


def _tolist(x: Any) -> Any:
    if isinstance(x, dict):
        return {k: _tolist(v) for k, v in x.items()}
    arr = np.asarray(x)
    return arr.item() if arr.ndim == 0 else arr.tolist()
