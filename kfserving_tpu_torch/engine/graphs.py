"""CUDA graphs: the port's compiled programs.

The JAX engines run one compiled executable per shape; on the card the
port records one CUDA graph per shape, which the host replays with one
call.  This module holds what the predict engine (``torch_engine.py``)
and the generator (``generator.py``) share:

- ``capture``: record a function into a graph on a given stream, its
  allocations taken from a given memory pool, and tally the hand-written
  kernels it launches (``ops/launches.py``: a replay adds the tally to
  their counts; the capture itself counts nothing).  A failed capture
  raises; nothing falls back to eager launches.
- ``CAPTURE_LOCK``: one capture in the process at a time.  Captures run
  in ``thread_local`` mode, so other threads keep launching, allocating
  and synchronizing their own streams, but a device-wide synchronize
  must not overlap one: the port's own (priming the workspaces) takes
  this lock, and ``TorchEngine.restore`` synchronizes its stream only.
- ``on_capture_thread`` and ``predict_streams``: the predict engines
  compile on one thread; they launch (replays and the eager first runs)
  on one stream and capture on another, which nothing else launches on,
  so a capture never records another engine's work.  The process then
  holds one cuBLAS workspace per stream for all of them (the capture
  stream's is the one the graphs bake in, and their replays are
  serialized on the launch stream), rather than one per worker thread
  and stream.  ``workspace_bytes`` is what those workspaces hold on the
  card.
- ``pool_bytes``: the device bytes a graph pool holds, from the caching
  allocator's segments.
"""

import concurrent.futures
import threading
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from kfserving_tpu_torch.ops import launches

CAPTURE_LOCK = threading.RLock()

_state_lock = threading.Lock()
_capture_executor: Optional[concurrent.futures.ThreadPoolExecutor] = None
_capture_thread: Optional[int] = None
_streams: Dict[int, Tuple[torch.cuda.Stream, torch.cuda.Stream]] = {}
# Device index -> bytes the capture thread's cuBLAS workspaces hold on
# the predict streams.
workspace_bytes: Dict[int, int] = {}


def capture(fn: Callable[[], Any], stream, pool
            ) -> Tuple[torch.cuda.CUDAGraph, Any, Dict[Callable, int]]:
    """Record ``fn()`` on ``stream`` into a new graph allocating from
    ``pool``.  Returns (graph, what fn returned, kernel launch tally).
    The caller keeps fn's outputs (and the pool) alive with the graph:
    a replay writes them in place."""
    graph = torch.cuda.CUDAGraph()
    with CAPTURE_LOCK, torch.cuda.stream(stream), \
            launches.recording() as tally:
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            out = fn()
        finally:
            graph.capture_end()
    return graph, out, dict(tally)


def replay(graph: torch.cuda.CUDAGraph, tally: Dict[Callable, int]) -> None:
    """Launch a captured graph on the current stream and count its
    kernels."""
    graph.replay()
    launches.replayed(tally)


def pool_bytes(pool, device: torch.device) -> int:
    """Bytes of the caching allocator's segments that belong to graph
    pool ``pool`` on ``device``: what the pool keeps reserved on the card
    (its live tensors and its free blocks alike)."""
    pool = tuple(pool)
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    total = 0
    for seg in torch.cuda.memory_snapshot():
        if "segment_pool_id" not in seg:
            raise RuntimeError("this torch's allocator snapshot does not "
                               "name segment pools")
        if seg["device"] == index and \
                tuple(seg["segment_pool_id"]) == pool:
            total += seg["total_size"]
    return total


def on_capture_thread(fn: Callable, *args) -> Any:
    """Run ``fn(*args)`` on the process's one capture thread and return
    its result (directly when already there)."""
    global _capture_executor, _capture_thread
    if threading.get_ident() == _capture_thread:
        return fn(*args)
    with _state_lock:
        if _capture_executor is None:
            _capture_executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="cuda-graph-capture")
            _capture_thread = _capture_executor.submit(
                threading.get_ident).result()
        executor = _capture_executor
    return executor.submit(fn, *args).result()


def _prime_workspace(device: torch.device, streams) -> int:
    """Capture thread: run a cuBLAS and a cuBLASLt product on each of
    ``streams`` so that their workspaces for this thread and those
    streams exist before any capture, and return the bytes they took."""
    def requested() -> int:
        torch.cuda.synchronize(device)
        return torch.cuda.memory_stats(device)[
            "requested_bytes.all.current"]

    with CAPTURE_LOCK:
        before = requested()
        for stream in streams:
            with torch.cuda.stream(stream), torch.inference_mode():
                for dtype in (torch.bfloat16, torch.float32):
                    a = torch.ones((64, 64), dtype=dtype, device=device)
                    torch.mm(a, a)
                    torch.nn.functional.linear(a, a, a[0])
                del a
        return requested() - before


def predict_streams(device: torch.device):
    """(launch stream, capture stream) of every predict engine on
    ``device``, created with the capture thread's workspaces at first
    use."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    with _state_lock:
        streams = _streams.get(index)
    if streams is not None:
        return streams
    dev = torch.device("cuda", index)
    streams = (torch.cuda.Stream(dev), torch.cuda.Stream(dev))
    nbytes = on_capture_thread(_prime_workspace, dev, streams)
    with _state_lock:
        if index not in _streams:
            _streams[index] = streams
            workspace_bytes[index] = nbytes
        return _streams[index]
