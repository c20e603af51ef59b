"""In-process dynamic request batcher, shape-bucket aware.

Port of ``kfserving_tpu/batching/batcher.py``.  Semantics kept:

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
- a flush larger than `max_batch_size` runs as concurrent chunks;
- a request's deadline (``reliability/deadline.py``) is captured at
  submit: a waiter whose budget runs out while queued fails with 504 at
  that moment and withdraws its instances, and expired or cancelled
  waiters are reaped before a flush commits batch slots to them;
- each flush records every waiter's queue wait
  (``kfserving_tpu_batch_queue_wait_ms``), the batch's fill against its
  bucket (``kfserving_tpu_batch_fill_ratio``), one ``batcher.queue``
  span per traced request and a ``batch.flush`` timeline event.
"""

import asyncio
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable, Dict, Hashable, List, Optional

from kfserving_tpu_torch.engine.buckets import BucketPolicy
from kfserving_tpu_torch.observability import metrics as obs
from kfserving_tpu_torch.observability.profiling import TIMELINE
from kfserving_tpu_torch.reliability.deadline import (
    Deadline,
    DeadlineExceeded,
    clear_deadline,
    current_deadline,
)
from kfserving_tpu_torch.tracing import Span, current_request_id, tracer

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
    # The request's budget, captured from the ambient context at submit.
    budget: Optional[Deadline] = None
    expiry: Optional[asyncio.TimerHandle] = None
    # The submitting request's trace id: the flush records a
    # `batcher.queue` span against it.
    trace_id: Optional[str] = None


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
        self.last_batch_size = 0
        # Per-bucket queue age at flush (ms), the starvation diagnostic:
        # a bucket whose max age >> max_latency_ms is losing slot races.
        self.queue_age_ms: Dict[Hashable, Dict[str, float]] = {}

    async def submit(self, instances: List[Any]) -> BatchResult:
        """Enqueue one request's instances; resolves with its own
        predictions."""
        if len(instances) == 0:
            raise ValueError("no instances in the request")
        budget = current_deadline()
        if budget is not None:
            # Already over budget: 504 before touching the queue.
            budget.raise_if_expired("batch queue admission")
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
                         loop.time() + self.max_latency_ms / 1000.0,
                         budget, trace_id=current_request_id.get())
        pending.waiters.append(waiter)
        if budget is not None:
            # Fail at the budget's expiry, not at the next flush: a 5 s
            # flush deadline must not sit on a 50 ms budget's 504.
            waiter.expiry = loop.call_later(
                max(0.0, budget.remaining_s()),
                self._expire_waiter, key, waiter)
        if len(pending.instances) >= self.max_batch_size:
            self._begin_flush(key)
        try:
            return await future
        except asyncio.CancelledError:
            # A cancelled submit withdraws its still-queued instances.
            self._discard_waiter(key, waiter)
            if future.done() and not future.cancelled():
                # Retrieve an exception an expiry set in the race
                # window, or asyncio logs it as never retrieved.
                future.exception()
            raise
        finally:
            if waiter.expiry is not None:
                waiter.expiry.cancel()

    def _expire_waiter(self, key: Hashable, waiter: _Waiter) -> None:
        """The budget ran out while queued: fail THIS waiter with 504 and
        withdraw its instances (the rest of the batch is untouched)."""
        if waiter.future.done():
            return
        if not waiter.budget.expired:
            # The timer fired early (clock granularity): the 504 follows
            # the budget, not timer arithmetic, so re-arm.
            waiter.expiry = asyncio.get_running_loop().call_later(
                max(0.001, waiter.budget.remaining_s()),
                self._expire_waiter, key, waiter)
            return
        waiter.future.set_exception(
            DeadlineExceeded("expired in batch queue"))
        self._discard_waiter(key, waiter)

    def _discard_waiter(self, key: Hashable, waiter: _Waiter) -> None:
        """Remove a dead waiter (expired or cancelled) from its pending
        group, rebuilding sibling offsets.  No-op once flushed."""
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

    def _reap_dead(self, pending: _Pending) -> None:
        """Drop waiters that can no longer use a result (budget spent:
        fail them with 504 now; future already done: cancelled) before a
        flush commits batch slots to them."""
        dead = [w for w in pending.waiters
                if w.future.done()
                or (w.budget is not None and w.budget.expired)]
        if not dead:
            return
        for w in dead:
            if not w.future.done():
                w.future.set_exception(
                    DeadlineExceeded("expired in batch queue"))
            pending.waiters.remove(w)
        instances, pos = [], 0
        for w in pending.waiters:
            instances.extend(
                pending.instances[w.start:w.start + w.count])
            w.start = pos
            pos += w.count
        pending.instances = instances

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
        # Expired and cancelled waiters must not occupy slots in the
        # batch about to run.
        self._reap_dead(pending)
        if not pending.waiters:
            if pending.timer is not None:
                pending.timer.cancel()
            self._pending.pop(key, None)
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
        self._record_flush(key, head, loop)
        self._inflight += 1
        task = asyncio.ensure_future(self._run_batch(key, head))
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)
        if rest is not None and len(rest.instances) >= self.max_batch_size:
            self._begin_flush(key, align=align)

    def _record_flush(self, key: Hashable, head: _Pending, loop) -> None:
        """Per-flush telemetry: the bucket's queue age, every waiter's
        queue wait, the fill against the bucket the batch runs in (1.0 =
        no pad slots) and one `batcher.queue` span per traced waiter."""
        now = loop.time()
        arrival = head.waiters[0].flush_at - self.max_latency_ms / 1000.0
        age_ms = max(0.0, (now - arrival) * 1000.0)
        rec = self.queue_age_ms.setdefault(key, {"max": 0.0, "last": 0.0})
        rec["last"] = round(age_ms, 1)
        rec["max"] = round(max(rec["max"], age_ms), 1)
        n = len(head.instances)
        if self._bucket_policy is not None:
            padded = self._bucket_policy.fit(
                min(n, self.max_batch_size)) or n
        else:
            padded = self.max_batch_size
        fill = min(1.0, n / padded)
        wait_hist = obs.batch_queue_wait_ms()
        for w in head.waiters:
            wait_ms = max(0.0, (now - (w.flush_at
                                       - self.max_latency_ms / 1000.0))
                          * 1000.0)
            wait_hist.labels(bucket=str(key)).observe(wait_ms)
            if w.trace_id is not None:
                tracer.record(Span(
                    w.trace_id, "batcher.queue",
                    time.time() - wait_ms / 1000.0, wait_ms,
                    {"bucket": str(key), "batch": n,
                     "fill": round(fill, 4)}))
        obs.batch_fill_ratio().labels(bucket=str(key)).observe(fill)
        # One host-track marker per flushed batch on the engine timeline.
        TIMELINE.record("host", "batch.flush",
                        attrs={"bucket": str(key), "batch": n,
                               "fill": round(fill, 4)})

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
        # This task inherits the context of whichever request's submit
        # (or timer) triggered the flush; the batch serves many requests,
        # so that one request's deadline must not govern it (budgets were
        # enforced per waiter at flush time).
        clear_deadline()
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
        self.last_batch_size = len(pending.instances)
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
