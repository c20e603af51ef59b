"""TorchEngine: the execution runtime behind a served model.

Port of ``kfserving_tpu/engine/jax_engine.py`` (``JaxEngine``):

- ``apply_fn(params, batch)`` runs one padded batch; requests are padded
  up to the nearest batch (and sequence) bucket and sliced back after, so
  the model only ever sees the bucket shapes that warmup visited;
- execution runs on ``pipeline_depth`` worker threads, so the asyncio
  serving loop never blocks on the device and one batch's host work
  (padding, transfers, result fetch) overlaps another's kernels;
- the device is explicit, and the model runs under
  ``torch.inference_mode()``;
- with a host state dict (the mmap tensors of ``engine/param_cache.py``)
  the engine is ``offloadable``: ``offload()`` drops the device storage
  of every parameter and buffer and ``restore()`` copies them back, for
  demand-paged residency (``engine/residency.py``).  The module and its
  ``Parameter`` objects stay, so nothing is rebuilt.

On the card each (batch, seq) bucket is compiled, as the JAX engine jits
one executable per bucket: the first dispatch of a shape runs the model
eagerly (its answer is the batch's; it also does the kernels' one-time
set-up outside any capture) and then records the same forward into a
CUDA graph with static input and output tensors (``engine/graphs.py``);
every later dispatch copies the padded batch into the static inputs,
replays the graph and copies the real rows out.  The capture runs on the
process's one capture thread, on a stream of its own; every predict
engine launches on one stream, and an engine's graphs share one memory
pool.  The pool is
shared, so one graph's temporaries may lie where another graph keeps its
static inputs or outputs: the engine's workers take one lock from the
copy in until the copy out is enqueued, which keeps each batch's copy,
replay and copy out together in stream order.  A failed capture
or replay raises; nothing falls back to eager launches.  ``offload()``
drops the graphs and their pool (a graph bakes in the parameters'
addresses, which ``restore()`` changes), so each bucket is captured
again at its first dispatch after a restore.  On the CPU the engine runs
eagerly.  ``compile_count`` counts captured graphs on the card and warmed
shapes on the CPU; every dispatch counts
``kfserving_tpu_compile_cache_total`` ``miss`` (the first dispatch of a
shape: on the card, its capture) or ``hit``, as the JAX engine counts
them, and the first compile of a shape is noted to
``engine/compile_cache.py``.  ``booked_bytes()`` is what the HBM ledger
books for the engine: its parameters and its graph pool, or the warmed
grid's pool while a restored engine captures its buckets again (the
capture thread's cuBLAS workspaces, which every predict engine's graphs
share, are booked once).

Each execution checks the caller's deadline first (the caller's context
rides into the worker thread), records an ``engine.execute`` span and
observes ``kfserving_tpu_engine_stage_ms`` per stage: prepare (pad on
the host), transfer (the host-to-device copies are queued), compute (the
forward, or the replay, is queued) and fetch (wait for the card, copy
the rows back).  Dispatch is asynchronous, so compute ends when the
launches return and fetch holds the wait for the device; ``stats()``
says so with ``blocking_stats`` false, as the JAX engine does in its
non-blocking mode.  The dispatch-to-result span is also an
``engine.execute`` event on the engine timeline's device track, and the
fetch is a sanctioned one for the sanitizer's transfer guard.

With a ``leader`` (``parallel/follower.py``: the model is sharded over a
mesh and this process is rank 0), each dispatched batch goes to the
followers and runs through ``run_sharded`` on every rank, one batch at a
time (the ranks' collectives pair up in order), eagerly: a gloo
collective cannot sit inside a CUDA graph.  Such an engine holds its
rank's shard, has no host restore source (not offloadable, as the JAX
engine's mesh-sharded params are not) and closes the mesh with itself.
"""

import asyncio
import concurrent.futures
import contextvars
import itertools
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from kfserving_tpu_torch.engine import compile_cache, graphs
from kfserving_tpu_torch.engine.buckets import BucketPolicy
from kfserving_tpu_torch.observability import metrics as obs
from kfserving_tpu_torch.observability.profiling import TIMELINE
from kfserving_tpu_torch.reliability import sanitizer
from kfserving_tpu_torch.reliability.deadline import check_deadline
from kfserving_tpu_torch.tracing import current_request_id, tracer

# Dense bf16 tensor-core peaks (NVIDIA data sheets, SXM parts), by the
# substring of torch.cuda.get_device_name() that names the part.
_PEAK_FLOPS = (("h100", 989e12), ("h200", 989e12), ("a100", 312e12))


def resolve_device(device: Any = "cuda") -> torch.device:
    """A torch.device; asking for cuda without a card raises (there is
    no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was asked for but torch.cuda.is_available() "
            "is false; pass device='cpu' to run on the CPU")
    return dev


def device_peak_flops(device: Optional[torch.device] = None
                      ) -> Optional[float]:
    """Peak dense bf16 FLOP/s of the serving card, for MFU.

    Override with KFS_PEAK_FLOPS.  None when unknown (a CPU device or an
    unlisted card) — stats then omit the MFU line rather than fake it.
    """
    env = os.getenv("KFS_PEAK_FLOPS")
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    if device is None or device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device).lower()
    for marker, peak in _PEAK_FLOPS:
        if marker in name:
            return peak
    return None


def module_bytes(module: torch.nn.Module) -> int:
    """Parameter and buffer bytes of a module (meta tensors included)."""
    tensors = list(module.parameters()) + list(module.buffers())
    return sum(t.numel() * t.element_size() for t in tensors)


def _resize_seq(arr: np.ndarray, seq: int) -> np.ndarray:
    """Clip or tile a single instance's leading (sequence) axis to `seq`
    for warmup shape synthesis."""
    if arr.ndim == 0 or arr.shape[0] == seq:
        return arr
    if arr.shape[0] > seq:
        return arr[:seq]
    reps = (seq + arr.shape[0] - 1) // arr.shape[0]
    return np.concatenate([arr] * reps, axis=0)[:seq]


def _map(fn: Callable, out: Any) -> Any:
    if isinstance(out, dict):
        return {k: fn(v) for k, v in out.items()}
    return fn(out)


def _map2(fn: Callable, a: Any, b: Any) -> Any:
    """``_map`` over two trees of one structure (a dict or one leaf)."""
    if isinstance(a, dict):
        return {k: fn(v, b[k]) for k, v in a.items()}
    return fn(a, b)


def _pinned_copy(t: torch.Tensor) -> torch.Tensor:
    """Queue a device -> pinned host copy of ``t`` on the current
    stream."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return host.copy_(t, non_blocking=True)


# Offset alignment of a tensor inside a restored model's one device block.
_SLOT_ALIGN = 256

# Process-monotonic engine ids: the compile-cache source of an engine
# (a recycled id would hand a new engine its predecessor's warmup).
_engine_seq = itertools.count()


class _Program:
    """One bucket's CUDA graph: its static input and output tensors and
    the kernel launches a replay makes."""

    __slots__ = ("graph", "inputs", "outputs", "launches")

    def __init__(self, graph, inputs, outputs, launches):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.launches = launches


class _Slot:
    """One parameter or buffer of a module: the tensor object (kept
    across offload and restore) and the layout it is restored in, at
    ``offset`` bytes into the model's device block."""

    __slots__ = ("name", "tensor", "shape", "stride", "dtype", "nbytes",
                 "span", "offset")

    def __init__(self, name: str, tensor: torch.Tensor, offset: int = 0):
        self.name = name
        self.tensor = tensor
        self.shape = tuple(tensor.shape)
        self.stride = tuple(tensor.stride())
        self.dtype = tensor.dtype
        self.nbytes = tensor.numel() * tensor.element_size()
        # Bytes the strides reach (a dense tensor: nbytes).
        self.span = 0 if not self.nbytes else tensor.element_size() * (
            1 + sum((n - 1) * st for n, st in zip(self.shape, self.stride)))
        self.offset = offset


def _tensor_slots(module: torch.nn.Module,
                  host: Dict[str, torch.Tensor]) -> List[_Slot]:
    """Every distinct parameter and buffer of ``module`` (a tensor shared
    under two names appears once, so a tie survives a restore), checked
    against its host copy."""
    slots, offset = [], 0
    for name, t in (list(module.named_parameters())
                    + list(module.named_buffers())):
        slots.append(_Slot(name, t, offset))
        offset += -(-slots[-1].span // _SLOT_ALIGN) * _SLOT_ALIGN
    for slot in slots:
        src = host.get(slot.name)
        if src is None or tuple(src.shape) != slot.shape \
                or src.dtype != slot.dtype:
            raise ValueError(
                f"host params do not match the module at {slot.name}: "
                f"{None if src is None else (tuple(src.shape), src.dtype)}"
                f" vs {(slot.shape, slot.dtype)}")
    return slots


class TorchEngine:
    """Bucketed, padded batch execution of `apply_fn(params, batch)`.

    apply_fn: a function of (params, batch_tensor) or (params,
        dict_of_batch_tensors) returning a tensor or a dict of tensors
        whose leading axis is the batch dimension.
    params: the model (an nn.Module already on `device`).
    batch_buckets: BucketPolicy for the leading batch dimension.
    seq_buckets: optional BucketPolicy for axis 1 (sequence length).
    host_params: optional restore source, a state dict of CPU tensors
        holding every parameter and buffer of ``params`` by name.
    """

    def __init__(self, apply_fn: Callable, params: Any,
                 batch_buckets: Optional[BucketPolicy] = None,
                 seq_buckets: Optional[BucketPolicy] = None,
                 pipeline_depth: int = 2,
                 device: Any = "cuda",
                 host_params: Optional[Dict[str, torch.Tensor]] = None,
                 leader=None):
        self.device = resolve_device(device)
        self._leader = leader
        if leader is not None:
            host_params = None
        self._apply = apply_fn
        self.params = params
        self._host_params = host_params
        self._slots = (_tensor_slots(params, host_params)
                       if host_params is not None else [])
        self._offloaded = False
        self.batch_buckets = batch_buckets or BucketPolicy.pow2(32)
        self.seq_buckets = seq_buckets
        self.pipeline_depth = max(1, pipeline_depth)
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=self.pipeline_depth,
            thread_name_prefix="torch-engine")
        self._flops_fn = getattr(params, "flops", None)
        self._peak_flops = device_peak_flops(self.device)
        self._stats_lock = threading.Lock()
        # Compiled programs.  On the card: bucket -> captured graph, all
        # in one memory pool, launched on the predict stream (the module
        # was built on this thread's stream: the predict stream waits for
        # it) and captured on the capture stream.  On the CPU: the
        # buckets dispatched so far.
        self._cuda = self.device.type == "cuda"
        self._stream = self._capture_stream = None
        if self._cuda:
            self._stream, self._capture_stream = graphs.predict_streams(
                self.device)
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        self._pool = None
        self._programs: Dict[Any, _Program] = {}
        self._dispatched: set = set()
        self._noted: set = set()
        self._compile_lock = threading.Lock()
        # Held from a batch's copy in to its copy out being enqueued (the
        # graphs share a pool: see the module note).
        self._replay_lock = threading.Lock()
        self.compile_source = f"torch_engine:{next(_engine_seq)}"
        # Called with booked_bytes() after each capture (the predictor
        # books a pool grown past its reserve in the HBM ledger).
        self.on_capture: Optional[Callable[[int], None]] = None
        self.pool_bytes = 0
        # The pool of the grid warmup captured: what a restored engine's
        # buckets are booked for while they are captured again.
        self.pool_reserve = 0
        self.captures = 0
        self.capture_ms_total = 0.0
        self.compile_count = 0
        self.execute_count = 0
        self.last_execute_ms = 0.0
        self.padded_waste_total = 0.0
        self.prepare_ms_total = 0.0   # host: pad to the bucket
        self.device_ms_total = 0.0    # transfer + dispatch (asynchronous)
        self.fetch_ms_total = 0.0     # wait for the device + D2H slice
        self.flops_total = 0.0
        self._bucket_hits: Dict[Any, int] = {}
        self._bucket_waste: Dict[Any, float] = {}
        self._slots_total = 0
        self._padded_slots_total = 0

    # -- shape plumbing ------------------------------------------------------
    def _pad_to_bucket(self, arr: np.ndarray) -> Tuple[np.ndarray, int]:
        """Pad leading (and optionally seq) dims to bucket sizes."""
        n = arr.shape[0]
        b = self.batch_buckets.fit(n)
        if b is None:
            raise ValueError(
                f"batch of {n} exceeds the largest bucket "
                f"{self.batch_buckets.max}")
        pad = [(0, b - n)] + [(0, 0)] * (arr.ndim - 1)
        if self.seq_buckets is not None and arr.ndim >= 2:
            s = self.seq_buckets.fit(arr.shape[1])
            if s is None:
                raise ValueError(
                    f"sequence length {arr.shape[1]} exceeds the largest "
                    f"bucket {self.seq_buckets.max}")
            pad[1] = (0, s - arr.shape[1])
        if any(p[1] for p in pad):
            arr = np.pad(arr, pad)
        return arr, n

    def _prepare(self, inputs: Any) -> Tuple[Any, int]:
        if isinstance(inputs, dict):
            padded = {}
            n = None
            for k, v in inputs.items():
                p, n_k = self._pad_to_bucket(np.asarray(v))
                padded[k] = p
                if n is None:
                    n = n_k
                elif n != n_k:
                    raise ValueError("inconsistent batch sizes across inputs")
            return padded, int(n)
        return self._pad_to_bucket(np.asarray(inputs))

    def _shape_key(self, batch: Any) -> Tuple[int, Optional[int]]:
        """Stats key: (batch bucket, seq bucket)."""
        first = (batch[next(iter(batch))]
                 if isinstance(batch, dict) else batch)
        return (int(first.shape[0]),
                int(first.shape[1]) if self.seq_buckets is not None
                and first.ndim >= 2 else None)

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            self.device, non_blocking=True)

    # -- execution -----------------------------------------------------------
    def _execute_sync(self, inputs: Any) -> Any:
        # Last stop before device work: an over-budget request fails 504
        # here.  Batched executions carry no deadline (the batcher clears
        # it; per-request budgets were settled at the queue edge).
        check_deadline("engine dispatch")
        if self.params is None:
            raise RuntimeError("engine is closed")
        if self._offloaded:
            # A straggler past the residency gate fails fast; it never
            # reads freed device memory.
            raise RuntimeError(
                "engine params are offloaded from the device; the model "
                "must be faulted in first")
        with tracer.span("engine.execute") as span:
            t0 = time.perf_counter()
            padded, n = self._prepare(inputs)
            key = self._shape_key(padded)
            t1 = time.perf_counter()
            run = (self._run_mesh if self._leader is not None
                   else self._run_on_card if self._cuda else self._run_eager)
            result, miss, t_transfer, t2, t3 = run(key, padded, n)
            bucket = key[0]
            span.update(batch=n, bucket=int(bucket),
                        prepare_ms=round((t1 - t0) * 1e3, 3),
                        device_ms=round((t2 - t1) * 1e3, 3),
                        fetch_ms=round((t3 - t2) * 1e3, 3))
        # Stage histograms, exemplared with the request's trace id (the
        # contextvar rode into this worker thread).
        trace_id = current_request_id.get()
        stage_hist = obs.engine_stage_ms()
        for stage, ms in (("prepare", (t1 - t0) * 1e3),
                          ("transfer", (t_transfer - t1) * 1e3),
                          ("compute", (t2 - t_transfer) * 1e3),
                          ("fetch", (t3 - t2) * 1e3)):
            stage_hist.labels(stage=stage).observe(ms, trace_id=trace_id)
        # The dispatch -> host-visible-result span on the device track,
        # and a host marker at a shape's first dispatch (its capture).
        TIMELINE.record("device", "engine.execute", dur_s=t3 - t1,
                        trace_id=trace_id,
                        attrs={"bucket": int(bucket), "batch": n})
        if miss:
            TIMELINE.record("host", "compile.miss", trace_id=trace_id,
                            attrs={"shape": str(key)})
        # Models without a sequence axis (ResNet, MLP, ViT) take None.
        flops = self._flops_fn(*key) if self._flops_fn else 0.0
        first = False
        with self._stats_lock:
            obs.compile_cache_events().labels(
                outcome="miss" if miss else "hit").inc()
            if miss and key not in self._noted:
                self._noted.add(key)
                first = True
            self.last_execute_ms = (t3 - t1) * 1000.0
            self.execute_count += 1
            self.padded_waste_total += (bucket - n) / bucket
            self.prepare_ms_total += (t1 - t0) * 1e3
            self.device_ms_total += (t2 - t1) * 1e3
            self.fetch_ms_total += (t3 - t2) * 1e3
            self.flops_total += flops
            self._bucket_hits[key] = self._bucket_hits.get(key, 0) + 1
            self._bucket_waste[key] = \
                self._bucket_waste.get(key, 0.0) + (bucket - n) / bucket
            self._slots_total += bucket
            self._padded_slots_total += bucket - n
        if first:
            compile_cache.note_compilation(self.compile_source, key)
        return result

    def _run_eager(self, key, padded: Any, n: int):
        """CPU: one eager forward.  The first dispatch of a bucket is its
        compile-cache miss."""
        with torch.inference_mode():
            batch = _map(self._to_device, padded)
            t_transfer = time.perf_counter()
            out = self._apply(self.params, batch)
            t2 = time.perf_counter()
            with sanitizer.sanctioned_fetch():
                result = _map(lambda t: t[:n].cpu().numpy(), out)
        t3 = time.perf_counter()
        with self._stats_lock:
            miss = key not in self._dispatched
            self._dispatched.add(key)
        return result, miss, t_transfer, t2, t3

    def _run_mesh(self, key, padded: Any, n: int):
        """A sharded model: the followers get the padded batch, then
        every rank runs its shard; rank 0 receives the output.  The first
        dispatch of a bucket is its compile-cache miss."""
        from kfserving_tpu_torch.parallel.follower import run_sharded

        with self._leader.lock:
            self._leader.send(("predict", padded))
            t_transfer = time.perf_counter()
            out = run_sharded(self._apply, self.params, self._leader.mesh,
                              padded, self.device)
            t2 = time.perf_counter()
        result = _map(lambda t: t[:n].numpy(), out)
        with self._stats_lock:
            miss = key not in self._dispatched
            self._dispatched.add(key)
        return result, miss, t_transfer, t2, time.perf_counter()

    def _run_on_card(self, key, padded: Any, n: int):
        """The card: replay the bucket's graph, or compile it (a miss)."""
        program = self._programs.get(key)
        if program is None:
            with self._compile_lock:
                program = self._programs.get(key)
                if program is None:
                    return graphs.on_capture_thread(self._compile, key,
                                                    padded, n)
        staged = _map(lambda a: torch.from_numpy(np.ascontiguousarray(a)),
                      padded)
        with self._replay_lock, torch.inference_mode(), \
                torch.cuda.stream(self._stream):
            _map2(lambda dst, src: dst.copy_(src, non_blocking=True),
                  program.inputs, staged)
            t_transfer = time.perf_counter()
            graphs.replay(program.graph, program.launches)
            t2 = time.perf_counter()
            host = _map(lambda t: _pinned_copy(t[:n]), program.outputs)
            done = torch.cuda.Event()
            done.record(self._stream)
        # The one device -> host join of a batch.
        with sanitizer.sanctioned_fetch():
            done.synchronize()
            result = _map(lambda h: h.numpy().copy(), host)
        return result, False, t_transfer, t2, time.perf_counter()

    def _compile(self, key, padded: Any, n: int):
        """Capture thread: run the bucket eagerly on the predict stream
        (the batch's answer; it also does every kernel's one-time set-up
        outside the capture), then record the same forward, on the
        capture stream, into a graph whose static inputs and outputs
        live in the engine's pool."""
        with torch.inference_mode(), torch.cuda.stream(self._stream):
            batch = _map(self._to_device, padded)
            t_transfer = time.perf_counter()
            out = self._apply(self.params, batch)
            t2 = time.perf_counter()
            with sanitizer.sanctioned_fetch():
                result = _map(lambda t: t[:n].cpu().numpy(), out)
            t3 = time.perf_counter()
            del out
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()

            def forward():
                inputs = _map(torch.empty_like, batch)
                return inputs, self._apply(self.params, inputs)

            graph, (inputs, outputs), tally = graphs.capture(
                forward, self._capture_stream, self._pool)
            del batch
        self._programs[key] = _Program(graph, inputs, outputs, tally)
        pool = graphs.pool_bytes(self._pool, self.device)
        with self._stats_lock:
            self.pool_bytes = pool
            self.captures += 1
            self.compile_count += 1
            self.capture_ms_total += (time.perf_counter() - t3) * 1e3
        if self.on_capture is not None:
            self.on_capture(self.booked_bytes())
        # The batch's stages end at its fetch; the capture after it is
        # in ``capture_ms``.
        return result, True, t_transfer, t2, t3

    async def predict(self, inputs: Any) -> Any:
        """Async batch predict: pads, executes off-loop, unpads.  The
        call runs in a copy of the caller's context, so its deadline and
        trace id ride into the worker thread."""
        loop = asyncio.get_running_loop()
        ctx = contextvars.copy_context()
        return await loop.run_in_executor(
            self._executor, ctx.run, self._execute_sync, inputs)

    def predict_sync(self, inputs: Any) -> Any:
        return self._execute_sync(inputs)

    # -- lifecycle -----------------------------------------------------------
    def warmup(self, example: Any, buckets: Optional[List[int]] = None,
               minimal: bool = False) -> float:
        """Dispatch every shape a request can hit once, which on the card
        captures its graph: all batch buckets x all seq buckets
        (minimal=True: only the largest batch bucket per seq bucket; the
        others compile at their first request).  `example` is a single
        instance (no batch dim) as array or dict of arrays.  Returns the
        seconds it took."""
        start = time.perf_counter()
        batch_buckets = buckets or self.batch_buckets.buckets
        if minimal:
            batch_buckets = [max(batch_buckets)]
        seq_buckets = (self.seq_buckets.buckets
                       if self.seq_buckets is not None else [None])

        def instance_at(seq):
            if seq is None:
                return example
            if isinstance(example, dict):
                return {k: _resize_seq(np.asarray(v), seq)
                        for k, v in example.items()}
            return _resize_seq(np.asarray(example), seq)

        for s in seq_buckets:
            inst = instance_at(s)
            for b in batch_buckets:
                if isinstance(inst, dict):
                    batch = {k: np.stack([np.asarray(v)] * b)
                             for k, v in inst.items()}
                else:
                    batch = np.stack([np.asarray(inst)] * b)
                self._execute_sync(batch)
                if not self._cuda or self._leader is not None:
                    self.compile_count += 1
        # Warmup batches are exactly full: leaving them in the traffic
        # counters would report phantom bucket hits.
        with self._stats_lock:
            self.pool_reserve = max(self.pool_reserve, self.pool_bytes)
            self._bucket_hits.clear()
            self._bucket_waste.clear()
            self._slots_total = 0
            self._padded_slots_total = 0
        return time.perf_counter() - start

    def param_bytes(self) -> int:
        """Parameter and buffer bytes held on the device (0 while
        offloaded)."""
        return module_bytes(self.params)

    def booked_bytes(self) -> int:
        """What the HBM ledger books for the engine while it is resident:
        its parameters, and its graph pool or, when larger, the pool its
        warmed grid took (a restored engine captures its buckets again
        as they are hit, and the booking holds their room)."""
        params = self.host_param_bytes() or self.param_bytes()
        return params + max(self.pool_bytes, self.pool_reserve)

    def _drop_programs(self) -> None:
        """Forget the captured graphs and their pool; each bucket is
        captured again at its next dispatch."""
        with self._stats_lock:
            self._programs = {}
            self._pool = None
            self.pool_bytes = 0

    # -- residency -----------------------------------------------------------
    @property
    def offloadable(self) -> bool:
        return self._host_params is not None and self.params is not None

    @property
    def host_params(self) -> Optional[Dict[str, torch.Tensor]]:
        """The host restore source (the mapped state dict), or None."""
        return self._host_params

    def host_param_bytes(self) -> int:
        """Device bytes a restore places (0 without a host source)."""
        return sum(slot.nbytes for slot in self._slots)

    def offload(self) -> bool:
        """Drop the device storage of every parameter and buffer; the
        host state dict stays as the restore source.  False when there
        is none.  The caller (the residency manager) guarantees that no
        batch is queued or running."""
        if not self.offloadable:
            return False
        # The graphs hold the parameters' addresses: they go with them.
        self._drop_programs()
        with torch.no_grad():
            for slot in self._slots:
                slot.tensor.data = torch.empty(
                    0, dtype=slot.dtype, device=self.device)
        self._offloaded = True
        return True

    def restore(self) -> float:
        """Copy the host tensors onto the device, each shared tensor once
        and in its own strides (channels-last convs stay channels-last),
        into one device block, every tensor a view at an aligned offset.
        The block an evicted model of the same size frees is then taken
        whole, where a few hundred blocks, one a tensor, would be rounded
        by the caching allocator as its free-block history happens to
        fall.  A model still on the device (a freshly built one that a
        cold fault pins) first drops its storage, as ``offload`` does.
        Synchronizes before it returns, so the seconds returned are the
        transfer."""
        if self._host_params is None:
            raise RuntimeError("engine keeps no host params to restore from")
        t0 = time.perf_counter()
        self.offload()
        with torch.no_grad():
            if self._slots:
                last = self._slots[-1]
                block = torch.empty(last.offset + last.span,
                                    dtype=torch.uint8, device=self.device)
            for slot in self._slots:
                dst = block[slot.offset:slot.offset + slot.span].view(
                    slot.dtype).as_strided(slot.shape, slot.stride)
                dst.copy_(self._host_params[slot.name])
                slot.tensor.data = dst
        if self._cuda:
            # This thread's stream, not the device: a device-wide
            # synchronize must not overlap another thread's capture.
            torch.cuda.current_stream(self.device).synchronize()
        self._offloaded = False
        return time.perf_counter() - t0

    def close(self, wait: bool = True) -> None:
        """Quiesce the workers and drop the model's device memory."""
        self._executor.shutdown(wait=wait)
        self._drop_programs()
        if self._leader is not None:
            self._leader.close()
        self.on_capture = None
        self.params = None
        self._flops_fn = None     # a bound method of the module
        self._slots = []
        self._host_params = None

    def graph_stats(self) -> Dict[str, Any]:
        """The compiled programs: graphs captured (recaptures after a
        restore included), their capture ms and the pool's bytes.  Kept
        out of ``stats()``, whose keys ``/metrics`` publishes as the JAX
        engine's gauges."""
        with self._stats_lock:
            return {"graphs": len(self._programs),
                    "captures": self.captures,
                    "capture_ms_total": self.capture_ms_total,
                    "pool_bytes": self.pool_bytes,
                    "pool_reserve_bytes": self.pool_reserve}

    def stats(self) -> Dict[str, Any]:
        with self._stats_lock:
            n = self.execute_count
            out = {
                "execute_count": n,
                "compile_count": self.compile_count,
                "pipeline_depth": self.pipeline_depth,
                "blocking_stats": False,
                "last_execute_ms": self.last_execute_ms,
                "avg_pad_waste": (self.padded_waste_total / n
                                  if n else 0.0),
                "slot_pad_waste": (
                    self._padded_slots_total / self._slots_total
                    if self._slots_total else 0.0),
                "avg_prepare_ms": self.prepare_ms_total / n if n else 0.0,
                "avg_device_ms": self.device_ms_total / n if n else 0.0,
                "avg_fetch_ms": self.fetch_ms_total / n if n else 0.0,
            }
            # Dispatch is asynchronous: device work completes inside the
            # fetch wait, so MFU divides by their sum (a floor).
            device_s = (self.device_ms_total + self.fetch_ms_total) / 1e3
            if self.flops_total > 0 and device_s > 0:
                achieved = self.flops_total / device_s
                out["achieved_tflops"] = achieved / 1e12
                if self._peak_flops:
                    out["mfu"] = achieved / self._peak_flops
            if self._bucket_hits:
                out["bucket_hits"] = {
                    (f"b{b}" if s is None else f"b{b}s{s}"): hits
                    for (b, s), hits in sorted(self._bucket_hits.items())}
                out["bucket_pad_waste"] = {
                    (f"b{b}" if s is None else f"b{b}s{s}"):
                        round(waste / self._bucket_hits[(b, s)], 4)
                    for (b, s), waste in sorted(self._bucket_waste.items())}
        return out
