"""In-process dynamic request batcher, shape-bucket aware.

Port of ``kfserving_tpu/batching/batcher.py`` without its observability,
tracing and deadline hooks.  Semantics kept:

- requests accumulate until `max_batch_size` instances are queued or the
  oldest request has waited `max_latency_ms`;
- each caller gets back exactly its own predictions, scattered by index;
  a batch result whose prediction count mismatches the instance count is
  an error;
- a `key_fn` partitions requests into independent batches (e.g. by padded
  sequence-length bucket);
- `max_inflight` bounds batches in flight: further flush triggers leave
  the batch accumulating and it flushes the moment a slot frees;
- `buckets` aligns flushes to the engine's batch buckets: a flush takes
  the largest bucket-sized prefix of the queue (split at request
  boundaries) and the remainder keeps its own deadline;
- a flush larger than `max_batch_size` runs as concurrent chunks.
"""

import asyncio
import uuid
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable, Dict, Hashable, List, Optional

from kfserving_tpu_torch.engine.buckets import BucketPolicy

DEFAULT_MAX_BATCH_SIZE = 32
DEFAULT_MAX_LATENCY_MS = 5000


class BatchSizeMismatch(Exception):
    def __init__(self, message: str = "size of prediction is not equal to "
                 "the size of instances"):
        super().__init__(message)


@dataclass
class BatchResult:
    predictions: List[Any]
    batch_id: str


@dataclass
class _Waiter:
    start: int                  # offset of this request's instances
    count: int
    future: asyncio.Future
    # loop.time()-based flush deadline (arrival + max_latency), so a
    # remainder left by a prefix flush re-arms at its own oldest request.
    flush_at: float = 0.0


@dataclass
class _Pending:
    instances: List[Any] = field(default_factory=list)
    waiters: List[_Waiter] = field(default_factory=list)
    timer: Optional[asyncio.TimerHandle] = None
    ripe: bool = False  # flush requested but deferred (no inflight slot)


BatchHandler = Callable[[List[Any]], Awaitable[List[Any]]]


class DynamicBatcher:
    """Coalesce per-request instance lists into batched handler calls.

    handler: async callable mapping a list of instances to a same-length
    list of predictions.  key_fn: optional shape-bucket key; requests with
    different keys never share a batch, and the handler then receives
    (instances, key).
    """

    def __init__(self, handler: BatchHandler,
                 max_batch_size: int = DEFAULT_MAX_BATCH_SIZE,
                 max_latency_ms: float = DEFAULT_MAX_LATENCY_MS,
                 key_fn: Optional[Callable[[Any], Hashable]] = None,
                 max_inflight: Optional[int] = None,
                 buckets: Optional[List[int]] = None):
        if max_batch_size <= 0:
            max_batch_size = DEFAULT_MAX_BATCH_SIZE
        if max_latency_ms <= 0:
            max_latency_ms = DEFAULT_MAX_LATENCY_MS
        if max_inflight is not None and max_inflight <= 0:
            max_inflight = 1  # 0 would defer every flush forever
        self.handler = handler
        self.max_batch_size = max_batch_size
        self.max_latency_ms = max_latency_ms
        self.key_fn = key_fn
        self.max_inflight = max_inflight
        self._bucket_policy = BucketPolicy(buckets) if buckets else None
        if self._bucket_policy is not None:
            # A chunk must never exceed the largest bucket.
            self.max_batch_size = min(self.max_batch_size,
                                      self._bucket_policy.max)
        self._inflight = 0
        self._pending: Dict[Hashable, _Pending] = {}
        # Strong refs to in-flight batch tasks (the loop holds weak ones).
        self._tasks: set = set()
        self.batches_flushed = 0
        self.instances_batched = 0

    async def submit(self, instances: List[Any]) -> BatchResult:
        """Enqueue one request's instances; resolves with its own
        predictions."""
        if len(instances) == 0:
            raise ValueError("no instances in the request")
        key = self.key_fn(instances[0]) if self.key_fn else None
        loop = asyncio.get_running_loop()
        pending = self._pending.get(key)
        if pending is None:
            pending = _Pending()
            self._pending[key] = pending
            pending.timer = loop.call_later(
                self.max_latency_ms / 1000.0, self._flush_by_timer, key)
        start = len(pending.instances)
        pending.instances.extend(instances)
        future = loop.create_future()
        waiter = _Waiter(start, len(instances), future,
                         loop.time() + self.max_latency_ms / 1000.0)
        pending.waiters.append(waiter)
        if len(pending.instances) >= self.max_batch_size:
            self._begin_flush(key)
        try:
            return await future
        except asyncio.CancelledError:
            # A cancelled submit withdraws its still-queued instances.
            self._discard_waiter(key, waiter)
            raise

    def _discard_waiter(self, key: Hashable, waiter: _Waiter) -> None:
        """Remove a cancelled waiter from its pending group, rebuilding
        sibling offsets.  No-op once flushed."""
        pending = self._pending.get(key)
        if pending is None or waiter not in pending.waiters:
            return
        pending.waiters.remove(waiter)
        del pending.instances[waiter.start:waiter.start + waiter.count]
        for w in pending.waiters:
            if w.start > waiter.start:
                w.start -= waiter.count
        if not pending.waiters:
            if pending.timer is not None:
                pending.timer.cancel()
            self._pending.pop(key, None)

    def _flush_by_timer(self, key: Hashable):
        if key in self._pending and self._pending[key].instances:
            self._begin_flush(key)

    def _split_prefix(self, pending: _Pending, target: int):
        """Split `pending` at request boundaries into (head, rest) where
        head holds the oldest waiters totalling <= target instances.
        Returns (pending, None) when no split is possible."""
        cum = j = 0
        for w in pending.waiters:
            if cum + w.count > target:
                break
            cum += w.count
            j += 1
        if j == 0 or j == len(pending.waiters):
            return pending, None
        head = _Pending(instances=pending.instances[:cum],
                        waiters=pending.waiters[:j])
        # ripe is not inherited: the remainder's requests are younger.
        rest = _Pending(instances=pending.instances[cum:],
                        waiters=pending.waiters[j:])
        for w in rest.waiters:
            w.start -= cum
        return head, rest

    def _begin_flush(self, key: Hashable, align: bool = True):
        pending = self._pending.get(key)
        if pending is None:
            return
        if self.max_inflight is not None and \
                self._inflight >= self.max_inflight:
            # Engine busy: keep the batch open; _on_batch_done flushes it.
            pending.ripe = True
            return
        head, rest = pending, None
        if align and self._bucket_policy is not None:
            n = len(pending.instances)
            target = self._bucket_policy.floor_fit(n)
            if target is not None and target < n:
                head, rest = self._split_prefix(pending, target)
        if pending.timer is not None:
            pending.timer.cancel()
            pending.timer = None
        loop = asyncio.get_running_loop()
        if rest is not None:
            self._pending[key] = rest
            rest.timer = loop.call_at(rest.waiters[0].flush_at,
                                      self._flush_by_timer, key)
        else:
            self._pending.pop(key)
        self._inflight += 1
        task = asyncio.ensure_future(self._run_batch(key, head))
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)
        if rest is not None and len(rest.instances) >= self.max_batch_size:
            self._begin_flush(key, align=align)

    def _on_batch_done(self):
        self._inflight -= 1
        # Flush the deferred batch whose oldest request has waited
        # longest, the larger batch breaking ties.
        ripe = [(p.waiters[0].flush_at, -len(p.instances), id(p), k)
                for k, p in self._pending.items()
                if p.ripe and p.instances]
        if ripe:
            ripe.sort()
            self._begin_flush(ripe[0][3])

    async def _run_batch(self, key: Hashable, pending: _Pending):
        batch_id = str(uuid.uuid4())
        try:
            predictions = await self._run_chunked(pending.instances, key)
        except Exception as e:
            for w in pending.waiters:
                if not w.future.done():
                    w.future.set_exception(
                        e if len(pending.waiters) == 1 else _clone_exc(e))
            return
        finally:
            self._on_batch_done()
        self.batches_flushed += 1
        self.instances_batched += len(pending.instances)
        for w in pending.waiters:
            if not w.future.done():
                w.future.set_result(BatchResult(
                    predictions[w.start:w.start + w.count], batch_id))

    async def _run_chunked(self, instances: List[Any],
                           key: Hashable) -> List[Any]:
        """Execute a flush in handler calls of at most max_batch_size,
        run concurrently; results re-concatenate in order."""
        sizes = self._chunk_sizes(len(instances))
        chunks, pos = [], 0
        for s in sizes:
            chunks.append(instances[pos:pos + s])
            pos += s
        if self.key_fn is not None:
            coros = [self.handler(c, key) for c in chunks]
        else:
            coros = [self.handler(c) for c in chunks]
        # return_exceptions: a failing chunk must not leave siblings
        # running untracked.
        results = await asyncio.gather(*coros, return_exceptions=True)
        for preds in results:
            if isinstance(preds, BaseException):
                raise preds
        for chunk, preds in zip(chunks, results):
            if len(preds) != len(chunk):
                raise BatchSizeMismatch()
        return [p for preds in results for p in preds]

    def _chunk_sizes(self, n: int) -> List[int]:
        """Split an n-instance flush into handler-call sizes: chunks of
        max_batch_size, or with a bucket ladder greedy largest-bucket-
        first, merging the trailing fragment into its neighbour when
        that does not add padded slots."""
        cap = self.max_batch_size
        if self._bucket_policy is None:
            if n <= cap:
                return [n]
            return [cap] * (n // cap) + ([n % cap] if n % cap else [])
        sizes, rem = [], n
        while rem > 0:
            b = self._bucket_policy.floor_fit(min(rem, cap))
            if b is None:
                sizes.append(rem)  # below the smallest bucket: one call
                break
            sizes.append(b)
            rem -= b

        def padded(m: int) -> int:
            return self._bucket_policy.fit(m) or m

        while len(sizes) >= 2:
            merged = sizes[-1] + sizes[-2]
            if merged <= cap and \
                    padded(merged) <= padded(sizes[-1]) + padded(sizes[-2]):
                sizes[-2:] = [merged]
            else:
                break
        return sizes


def _clone_exc(e: Exception) -> Exception:
    """Best-effort per-waiter copy of a batch failure (the HTTP status
    mapping dispatches on the exception class)."""
    try:
        return type(e)(*e.args)
    except Exception:
        return e
