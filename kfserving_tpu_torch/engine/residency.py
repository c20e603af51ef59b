"""Demand-paged model residency: host-resident always, on the card on
demand.

Port of ``kfserving_tpu/engine/residency.py`` (the whole module).  Many
models share one card, and "loaded" means resident in device memory,
the resource ``engine/hbm.py`` books:

- REGISTRATION is declarative and cheap: a registered model is
  addressable and ``ready`` but owns no device memory.  Its host params
  are mmap tensors (``engine/param_cache.py``), so the whole repository
  stays host-resident.
- Device residency is an LRU cache over the ``HBMManager`` ledger.  A
  request to a non-resident model FAULTS it in: the first fault pays
  the cold build (materialize + warmup); every later one is one
  ``TorchEngine.restore()`` off the mmap tensors, with nothing rebuilt.
- Fault-ins are SINGLE-FLIGHT: concurrent requests to one non-resident
  model share one transfer (counted ``coalesced``).
- Eviction is ADMISSION-AWARE: a model with queued or in-flight work is
  never a victim (the ``HBMManager.victim_ok`` veto, counted in
  ``eviction_skips``); a victim is claimed under the ledger lock, so a
  fault-in racing an eviction of the same model serializes.
- A failed fault-in (fault site ``engine.residency_swap``, a bad
  artifact, out of memory) returns only that model to its prior state;
  the resident set keeps serving and the error reaches the requester
  alone.

States: registered -> faulting -> resident <-> evicting -> host.

Published: ``kfserving_tpu_residency_state{model}`` (pruned when a model
deregisters), ``kfserving_tpu_residency_fault_in_ms{source}`` and
``kfserving_tpu_residency_fault_ins_total{model,outcome}``.  Each
fault-in and eviction is a ``residency.fault_in`` / ``residency.evict``
event on the engine timeline.  More than ``KFS_RESIDENCY_STORM_THRESHOLD``
evictions inside ``KFS_RESIDENCY_STORM_WINDOW_S`` is an eviction storm:
counted in ``debug()`` and pinned (``eviction_storm``, with the ledger
and the residency block) into the flight recorder the server attaches.
"""

import asyncio
import concurrent.futures
import contextlib
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Dict, Optional

from kfserving_tpu_torch.engine.hbm import HBMManager, InsufficientHBM
from kfserving_tpu_torch.observability import metrics as obs
from kfserving_tpu_torch.observability.profiling import TIMELINE
from kfserving_tpu_torch.reliability import fault_sites
from kfserving_tpu_torch.reliability.faults import FaultInjected, faults

logger = logging.getLogger("kfserving_tpu_torch.residency")

# A fault-in that finds every eviction candidate busy waits for one to
# free instead of failing the request (the veto makes "no victim" a
# transient condition, not an error).
DEFAULT_ADMIT_WAIT_S = 5.0
# More than threshold evictions inside the window count as one storm
# (the working set exceeds the budget).
DEFAULT_STORM_WINDOW_S = 10.0
DEFAULT_STORM_THRESHOLD = 8
# kfserving_tpu_residency_state values; an evicting model is still on the
# card.
STATE_CODES = {"registered": 0, "host": 1, "faulting": 2,
               "resident": 3, "evicting": 3}


class _Record:
    __slots__ = ("name", "model", "state", "inflight", "nbytes",
                 "fault", "fault_counts", "last_fault_ms")

    def __init__(self, name: str, model: Any):
        self.name = name
        self.model = model
        # "registered" (no engine yet) | "host" (engine built, params
        # offloaded) | "faulting" | "resident" | "evicting" (claimed by
        # an admission plan, still on the card)
        self.state = "registered" if not getattr(model, "ready", False) \
            or getattr(model, "engine", None) is None else "resident"
        self.inflight = 0
        self.nbytes = 0
        self.fault: Optional[asyncio.Task] = None
        self.fault_counts = {"cold": 0, "warm": 0, "coalesced": 0,
                             "error": 0}
        self.last_fault_ms = 0.0


class ResidencyManager:
    """Owns the host <-> device lifecycle of N registered models over one
    HBMManager.  A managed model provides: blocking ``load()`` (cold
    build; admits its own bytes), blocking ``fault_in()`` (warm device
    restore), ``offload()``, ``demote()``, ``host_bytes()`` and
    ``offloadable`` (see TorchModel)."""

    def __init__(self, hbm: HBMManager,
                 admit_wait_s: Optional[float] = None):
        self.hbm = hbm
        hbm.evict_cb = self._evict
        hbm.victim_ok = self._victim_ok
        hbm.victim_release = self._victim_release
        self.admit_wait_s = admit_wait_s if admit_wait_s is not None \
            else float(os.environ.get("KFS_RESIDENCY_ADMIT_WAIT_S",
                                      DEFAULT_ADMIT_WAIT_S))
        self.storm_window_s = float(os.environ.get(
            "KFS_RESIDENCY_STORM_WINDOW_S", DEFAULT_STORM_WINDOW_S))
        self.storm_threshold = int(float(os.environ.get(
            "KFS_RESIDENCY_STORM_THRESHOLD", DEFAULT_STORM_THRESHOLD)))
        self._flight_recorder = None
        self._models: Dict[str, _Record] = {}
        # Dedicated fault-in workers: a fault must not queue behind the
        # resident models' batches on a shared executor; that wait would
        # land inside the fault-in latency.
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="residency")
        # Guards record state/inflight transitions.  Lock order: the
        # ledger lock is OUTER (victim_ok/release run under it); nothing
        # here takes the ledger lock while holding this one.
        self._lock = threading.Lock()
        self._evict_times: deque = deque(maxlen=256)
        self._storm_at = 0.0
        self.storms = 0
        # Bounded recent fault-in latencies (debug p50/p99).
        self.fault_ms: Dict[str, deque] = {
            "warm": deque(maxlen=512), "cold": deque(maxlen=512)}

    # -- registration ------------------------------------------------------
    def register(self, name: str, model: Any) -> None:
        """Declarative registration: the model joins the managed set in
        the state it is in (a loaded model registers as resident, a
        configured one as registered; its first predict cold-faults
        it)."""
        rec = self._models.get(name)
        if rec is not None and rec.model is model:
            return
        rec = _Record(name, model)
        if rec.state == "resident":
            rec.nbytes = self._host_bytes(model)
        self._models[name] = rec
        self._publish_state(rec)

    def deregister(self, name: str) -> None:
        self._models.pop(name, None)
        obs.residency_state().prune(model=name)

    def state_of(self, name: str) -> Optional[str]:
        rec = self._models.get(name)
        return rec.state if rec is not None else None

    @staticmethod
    def _host_bytes(model) -> int:
        fn = getattr(model, "host_bytes", None)
        return int(fn()) if fn is not None else 0

    @staticmethod
    def _publish_state(rec: "_Record") -> None:
        obs.residency_state().labels(model=rec.name).set(
            float(STATE_CODES.get(rec.state, 0)))

    def close(self) -> None:
        """Release the fault-in workers (server shutdown)."""
        self._executor.shutdown(wait=False)

    # -- request gate ------------------------------------------------------
    @contextlib.asynccontextmanager
    async def serving(self, name: str):
        """The predict-path gate: counts the request as in flight (which
        protects the model from eviction, held across the batcher wait),
        faults the model in when it is not resident, and touches the
        ledger so victims follow use order."""
        rec = self._models.get(name)
        if rec is None:
            yield
            return
        with self._lock:
            rec.inflight += 1
        try:
            await self.ensure_resident(name)
            yield
        finally:
            with self._lock:
                rec.inflight -= 1

    async def ensure_resident(self, name: str) -> None:
        """Fault ``name`` in if needed (single-flight); the fast path is
        one lock and an LRU touch."""
        rec = self._models.get(name)
        if rec is None:
            return
        with self._lock:
            resident = rec.state == "resident"
        if resident:
            self.hbm.touch(name)
            return
        fault = rec.fault
        if fault is None or fault.done():
            fault = rec.fault = asyncio.get_running_loop().create_task(
                self._fault_in(rec))
        else:
            rec.fault_counts["coalesced"] += 1
            obs.residency_fault_ins_total().labels(
                model=name, outcome="coalesced").inc()
        # shield: one cancelled requester must not cancel the transfer
        # its coalesced peers wait on.
        await asyncio.shield(fault)
        self.hbm.touch(name)

    async def _fault_in(self, rec: _Record) -> None:
        loop = asyncio.get_running_loop()
        # Only an unclaimed state (registered/host) turns to faulting: an
        # admission that claimed this model as a victim (evicting) owns
        # the device until its offload lands, so wait for it.
        source = None
        while source is None:
            with self._lock:
                if rec.state == "resident":
                    return   # an earlier fault (or a load) already won
                if rec.state in ("registered", "host"):
                    source = ("cold" if rec.state == "registered"
                              else "warm")
                    rec.state = "faulting"
            if source is None:
                await asyncio.sleep(0.005)
        self._publish_state(rec)
        t0 = time.perf_counter()
        try:
            if faults.configured(fault_sites.ENGINE_RESIDENCY_SWAP):
                await faults.inject(fault_sites.ENGINE_RESIDENCY_SWAP,
                                    key=f"{rec.name} source:{source}")
            work = (rec.model.load if source == "cold"
                    else lambda: self._admit_and_restore(rec))
            # Every candidate may be busy for a moment: wait for one to
            # free, bounded.
            until = loop.time() + self.admit_wait_s
            while True:
                try:
                    await loop.run_in_executor(self._executor, work)
                    break
                except InsufficientHBM as e:
                    # Permanent = bigger than the whole budget: no
                    # eviction will ever make room.
                    if e.permanent or loop.time() >= until:
                        raise
                    await asyncio.sleep(0.02)
            with self._lock:
                rec.state = "resident"
            rec.nbytes = self._host_bytes(rec.model) or rec.nbytes
        except BaseException as e:
            # The resident set is untouched (the admission plan is
            # transactional, the fault site sits before it); only this
            # model returns to its prior state.  Its admission episode
            # is over, so a retry counts busy victims afresh.
            self.hbm.end_skip_episode(rec.name)
            with self._lock:
                rec.state = "registered" if source == "cold" else "host"
            rec.fault_counts["error"] += 1
            obs.residency_fault_ins_total().labels(
                model=rec.name, outcome="error").inc()
            self._publish_state(rec)
            if isinstance(e, (FaultInjected, InsufficientHBM)):
                logger.warning("fault-in of %s failed (%s); the resident "
                               "set keeps serving", rec.name, e)
            else:
                logger.exception("fault-in of %s failed", rec.name)
            raise
        finally:
            rec.fault = None
        ms = (time.perf_counter() - t0) * 1e3
        rec.last_fault_ms = ms
        rec.fault_counts[source] += 1
        self.fault_ms[source].append(ms)
        obs.residency_fault_in_ms().labels(source=source).observe(ms)
        obs.residency_fault_ins_total().labels(
            model=rec.name, outcome=source).inc()
        TIMELINE.record("host", "residency.fault_in", dur_s=ms / 1e3,
                        attrs={"model": rec.name, "source": source})
        self._publish_state(rec)
        logger.info("faulted %s onto the card (%s, %.1f ms)", rec.name,
                    source, ms)

    def _admit_and_restore(self, rec: _Record) -> None:
        """Warm fault body (executor thread): book the bytes (evicting
        admission-approved victims), then copy the mmap tensors back.
        A failed restore releases the booking."""
        nbytes = rec.nbytes or self._host_bytes(rec.model)
        self.hbm.admit(rec.name, nbytes)
        try:
            rec.model.fault_in()
        except BaseException:
            self.hbm.release(rec.name)
            raise

    # -- eviction (HBMManager callbacks) -----------------------------------
    def _victim_ok(self, name: str) -> bool:
        """Veto and claim, under the ledger lock: only an idle, fully
        resident model can be a victim, and a yes claims it (state ->
        evicting), so a racing fault-in serializes on the ledger."""
        rec = self._models.get(name)
        if rec is None:
            return True   # an unmanaged entry (a staging key)
        with self._lock:
            if rec.inflight > 0 or rec.state != "resident":
                return False
            rec.state = "evicting"
            return True

    def _victim_release(self, name: str) -> None:
        rec = self._models.get(name)
        if rec is None:
            return
        with self._lock:
            if rec.state == "evicting":
                rec.state = "resident"

    def _evict(self, name: str) -> None:
        """Offload of a committed victim (the ledger is already updated).
        An offloadable model keeps its engine, warm, and its host mmap
        params; one without a host restore source (param cache disabled)
        is demoted to registered, and its next fault is a cold build."""
        rec = self._models.get(name)
        if rec is None:
            return
        offloaded = False
        try:
            if getattr(rec.model, "offloadable", False):
                rec.model.offload()
                offloaded = True
            else:
                demote = getattr(rec.model, "demote", None)
                if demote is not None:
                    demote()
        finally:
            with self._lock:
                rec.state = "host" if offloaded else "registered"
            self._publish_state(rec)
        TIMELINE.record("host", "residency.evict",
                        attrs={"model": name, "bytes": rec.nbytes,
                               "warm": offloaded})
        logger.info("evicted %s from the card (%s)", name,
                    "host params retained" if offloaded
                    else "demoted to registered")
        self._note_eviction()

    def attach_flight_recorder(self, recorder) -> None:
        """Eviction-storm pins land in ``recorder`` (the serving
        ModelServer attaches its monitoring recorder at start)."""
        self._flight_recorder = recorder

    def _note_eviction(self) -> None:
        now = time.monotonic()
        self._evict_times.append(now)
        recent = sum(1 for t in self._evict_times
                     if now - t <= self.storm_window_s)
        # One storm per window, not one per eviction in it.
        if recent <= self.storm_threshold or \
                now - self._storm_at < self.storm_window_s:
            return
        self._storm_at = now
        self.storms += 1
        recorder = self._flight_recorder
        if recorder is not None:
            recorder.record({
                "kind": "residency_eviction_storm",
                "evictions_in_window": recent,
                "window_s": self.storm_window_s,
                "hbm": self.hbm.debug(),
                "residency": self.debug(),
            }, pin="eviction_storm")
        logger.warning(
            "eviction storm: %d evictions in %.0f s (the working set "
            "exceeds the budget)", recent, self.storm_window_s)

    # -- introspection -----------------------------------------------------
    def debug(self) -> Dict[str, Any]:
        """The ``/debug/cache`` residency block."""
        def pct(values, q):
            if not values:
                return None
            ordered = sorted(values)
            return round(ordered[min(len(ordered) - 1,
                                     int(len(ordered) * q))], 3)

        with self._lock:
            models = {
                name: {"state": rec.state, "inflight": rec.inflight,
                       "nbytes": rec.nbytes,
                       "fault_ins": dict(rec.fault_counts),
                       "last_fault_ms": round(rec.last_fault_ms, 3)}
                for name, rec in self._models.items()}
        warm = list(self.fault_ms["warm"])
        cold = list(self.fault_ms["cold"])
        return {
            "registered": len(models),
            "resident": sum(1 for m in models.values()
                            if m["state"] in ("resident", "evicting")),
            "models": models,
            "fault_in_ms": {
                "warm_p50": pct(warm, 0.50), "warm_p99": pct(warm, 0.99),
                "cold_p50": pct(cold, 0.50), "cold_p99": pct(cold, 0.99),
                "warm_count": len(warm), "cold_count": len(cold),
            },
            "evictions_total": sum(self.hbm.evictions.values()),
            "eviction_skips_total": sum(self.hbm.eviction_skips.values()),
            "eviction_storms": self.storms,
        }
