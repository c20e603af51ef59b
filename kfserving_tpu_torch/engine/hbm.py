"""Device-memory accounting and LRU eviction for multi-model serving.

Port of ``kfserving_tpu/engine/hbm.py`` (``HBMManager``).  On the card
"loaded" means resident in device memory, the scarce resource: the ledger
books each model's bytes against a budget, and an admission that would
overflow it picks least-recently-used victims, which ``evict_cb`` frees.

The ledger is admission-aware: ``victim_ok`` (set by the residency
manager, ``engine/residency.py``) vetoes a candidate with queued or
in-flight work and claims the ones it passes, under the ledger lock, so
a fault-in racing an eviction of the same model serializes; a vetoed
candidate is counted in ``eviction_skips`` (once per admission
episode), and a plan that fails after claiming victims gives them back
through ``victim_release``.

Beside the models, the ledger books what the process keeps on the card
for all of them (``set_shared``: the capture thread's cuBLAS workspace,
whose address every predict graph bakes in), and a model's entry grows
with its engine's graph pool as buckets are captured (``resize``).

The budget is ``KFS_HBM_BUDGET`` when set, else 90% of the card's memory
(``torch.cuda.mem_get_info``), else 12 GiB when no card reports one.  The
ledger publishes ``kfserving_tpu_hbm_budget_bytes``,
``kfserving_tpu_hbm_resident_bytes{model}`` (pruned when a model leaves),
``kfserving_tpu_hbm_evictions_total{model}`` and
``kfserving_tpu_hbm_eviction_skips_total{model,reason}``.
"""

import logging
import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import torch

from kfserving_tpu_torch.observability import metrics as obs

logger = logging.getLogger("kfserving_tpu_torch.hbm")


def device_hbm_bytes(device: Any = None) -> Optional[int]:
    """Total memory of the serving card; None without one."""
    if not torch.cuda.is_available():
        return None
    return torch.cuda.mem_get_info(device)[1]


def device_hbm_in_use(device: Any = None) -> Optional[int]:
    """Bytes the caching allocator holds in live tensors on the card."""
    if not torch.cuda.is_available():
        return None
    return torch.cuda.memory_allocated(device)


def host_memory_bytes() -> int:
    """Available host memory (bytes), 0 when unknowable: the host-side
    twin of ``device_hbm_bytes``, against which the host KV tier
    (``engine/kv_tier.py``) clamps its spill file."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    return 0


class InsufficientHBM(Exception):
    """No room for an admission.  ``permanent`` tells "can never fit"
    (bigger than the whole budget) from the transient case of no
    evictable victim, which a waiting fault-in may retry."""

    permanent = False


@dataclass
class Residency:
    name: str
    bytes: int
    loaded_at: float
    last_used: float


class HBMManager:
    """Byte ledger for the models resident on one card.

    budget_bytes: capacity to pack into (default: see the module note).
    evict_cb: called with a model name when the ledger evicts it; the
        callback must actually free the model's memory (unload or
        offload it).
    victim_ok: optional admission-aware veto, consulted in LRU order
        while planning an eviction, under the ledger lock; True claims
        the candidate as a victim.  A vetoed candidate is skipped, never
        evicted, and counted in ``eviction_skips``.
    victim_release: called for claimed victims of a plan that failed
        (undoes victim_ok's claim).
    """

    DEFAULT_BUDGET = 12 * 1024**3
    HEADROOM = 0.10     # of the card's memory, left out of the budget

    def __init__(self, budget_bytes: Optional[int] = None,
                 evict_cb: Optional[Callable[[str], None]] = None,
                 victim_ok: Optional[Callable[[str], bool]] = None):
        if budget_bytes is None:
            env = os.environ.get("KFS_HBM_BUDGET", "")
            if env:
                budget_bytes = int(float(env))
        if budget_bytes is None:
            total = device_hbm_bytes()
            budget_bytes = (int(total * (1 - self.HEADROOM)) if total
                            else self.DEFAULT_BUDGET)
        self.budget_bytes = budget_bytes
        self.evict_cb = evict_cb
        self.victim_ok = victim_ok
        self.victim_release: Optional[Callable[[str], None]] = None
        self._resident: "OrderedDict[str, Residency]" = OrderedDict()
        # Bytes held for every model at once (not evictable).
        self._shared: Dict[str, int] = {}
        self._lock = threading.Lock()
        # Lifetime evictions and admission skips per model.
        self.evictions: Dict[str, int] = {}
        self.eviction_skips: Dict[str, int] = {}
        # Busy candidates already counted for a still-waiting admission
        # (admitted name -> candidates): a waiting fault-in retries
        # admit every ~20 ms, and a busy candidate counts once per
        # admission episode, not once per retry.
        self._skips_counted: Dict[str, set] = {}
        obs.hbm_budget_bytes().set(float(budget_bytes))

    @property
    def used_bytes(self) -> int:
        with self._lock:
            return (sum(r.bytes for r in self._resident.values())
                    + sum(self._shared.values()))

    @property
    def free_bytes(self) -> int:
        return self.budget_bytes - self.used_bytes

    def resident_models(self) -> List[str]:
        """Resident models in LRU order (index 0 is the next victim)."""
        with self._lock:
            return list(self._resident)

    def admit(self, name: str, nbytes: int, evict: bool = True) -> List[str]:
        """Book ``nbytes`` for ``name``, evicting LRU models to make room.

        Returns the models evicted.  Raises InsufficientHBM when the model
        is bigger than the budget (``permanent``), or when there is no
        room and ``evict`` is False or every candidate is vetoed.  Three
        phases: plan the victims and reserve the bytes under the lock
        (victims stay booked, claimed through ``victim_ok``), free the
        victims through ``evict_cb`` outside it, then drop the victims'
        entries.  Until the victims are out of memory, ``used_bytes``
        counts both them and the incoming model, so a concurrent
        admission never plans against memory that is not free yet.  A
        reload of ``name`` replaces its entry rather than counting it
        twice.  A failed plan leaves the books untouched and releases
        the victims it claimed.
        """
        victims: List[str] = []
        skipped: List[str] = []
        claimed: List[str] = []
        try:
            with self._lock:
                if nbytes > self.budget_bytes:
                    err = InsufficientHBM(
                        f"model {name} needs {nbytes} bytes; budget is "
                        f"{self.budget_bytes}")
                    err.permanent = True
                    raise err
                plan = OrderedDict((k, v) for k, v in self._resident.items()
                                   if k != name)
                while True:
                    free = self.budget_bytes - sum(
                        r.bytes for r in plan.values()) - sum(
                            self._shared.values())
                    if nbytes <= free:
                        break
                    if not evict:
                        raise InsufficientHBM(
                            f"model {name} needs {nbytes} bytes; only "
                            f"{free} free and eviction disabled")
                    # LRU order, admission-aware: victim_ok vetoes busy
                    # candidates and claims the one it passes.
                    victim = None
                    for cand in plan:
                        if cand in skipped:
                            continue
                        if self.victim_ok is None or self.victim_ok(cand):
                            victim = cand
                            break
                        skipped.append(cand)
                    if victim is None:
                        raise InsufficientHBM(
                            f"model {name} needs {nbytes} bytes; no "
                            f"evictable victim ({len(skipped)} "
                            f"candidate(s) busy, nothing else to evict)")
                    plan.pop(victim)
                    victims.append(victim)
                    claimed.append(victim)
                now = time.time()
                self._resident.pop(name, None)
                self._resident[name] = Residency(name, nbytes, now, now)
                victim_entries = {v: self._resident[v] for v in victims}
                claimed = []    # reserved: the plan owns its victims now
        except BaseException:
            if self.victim_release is not None:
                for cand in claimed:
                    self.victim_release(cand)
            self._count_skips(name, skipped, done=False)
            raise
        self._count_skips(name, skipped, done=True)
        for victim in victims:
            logger.info("evicting model %s to fit %s", victim, name)
            if self.evict_cb:
                # One victim's failed unload must not strand the others
                # in their claimed state: its entry is dropped below all
                # the same.
                try:
                    self.evict_cb(victim)
                except Exception:
                    logger.exception("evict callback failed for %s (entry "
                                     "released anyway)", victim)
        popped: List[str] = []
        with self._lock:
            for victim, entry in victim_entries.items():
                # Identity check: a victim faulted back in meanwhile
                # keeps its new entry.
                if self._resident.get(victim) is entry:
                    self._resident.pop(victim)
                    popped.append(victim)
                self.evictions[victim] = self.evictions.get(victim, 0) + 1
        for victim in victims:
            obs.hbm_evictions_total().labels(model=victim).inc()
        # Prune only victims that left the ledger: one re-admitted
        # mid-eviction keeps its live series.
        for victim in popped:
            obs.hbm_resident_bytes().prune(model=victim)
        obs.hbm_resident_bytes().labels(model=name).set(float(nbytes))
        return victims

    def _count_skips(self, name: str, skipped: List[str],
                     done: bool) -> None:
        """Count the busy candidates a plan passed over, once per
        admission episode; ``done`` (the plan committed) closes it."""
        with self._lock:
            counted = self._skips_counted.setdefault(name, set())
            fresh = [c for c in skipped if c not in counted]
            counted.update(fresh)
            if done:
                self._skips_counted.pop(name, None)
            for cand in fresh:
                self.eviction_skips[cand] = \
                    self.eviction_skips.get(cand, 0) + 1
        for cand in fresh:
            obs.hbm_eviction_skips_total().labels(
                model=cand, reason="busy").inc()

    def end_skip_episode(self, name: str) -> None:
        """Close a waiting admission's skip episode without a commit (a
        fault-in that gave up or failed), so a later admission of the
        same model counts its busy victims afresh."""
        with self._lock:
            self._skips_counted.pop(name, None)

    def resize(self, name: str, nbytes: int) -> None:
        """Set a resident model's booked bytes (its engine captured a
        graph and its pool grew).  Evicts nothing: the next admission
        plans against the new total."""
        with self._lock:
            res = self._resident.get(name)
            if res is None:
                return
            res.bytes = int(nbytes)
        obs.hbm_resident_bytes().labels(model=name).set(float(nbytes))

    def set_shared(self, name: str, nbytes: int) -> None:
        """Book ``nbytes`` that the process holds for all models at once
        under ``name`` (never evicted)."""
        with self._lock:
            self._shared[name] = int(nbytes)

    def touch(self, name: str) -> None:
        """Mark a model as recently used (moves it to MRU position)."""
        with self._lock:
            res = self._resident.get(name)
            if res is not None:
                res.last_used = time.time()
                self._resident.move_to_end(name)

    def release(self, name: str) -> None:
        with self._lock:
            self._resident.pop(name, None)
        # Prune, not zero: a released model drops out of /metrics.
        obs.hbm_resident_bytes().prune(model=name)

    def commit(self, staging: str, name: str,
               nbytes: Optional[int] = None) -> None:
        """Atomically replace ``name``'s entry with the ``staging`` entry
        (a reload that kept the old generation serving until the new one
        was built).  ``nbytes`` overrides the staged estimate."""
        with self._lock:
            staged = self._resident.pop(staging, None)
            old = self._resident.pop(name, None)
            src = staged or old
            if src is None:
                return
            final = nbytes if nbytes is not None else src.bytes
            self._resident[name] = Residency(name, final, src.loaded_at,
                                             time.time())
        obs.hbm_resident_bytes().prune(model=staging)
        obs.hbm_resident_bytes().labels(model=name).set(float(final))

    def debug(self) -> Dict[str, Any]:
        """The ``/debug/cache`` ledger block: budget totals and the
        per-model ledger in LRU order (index 0 is the next eviction
        victim)."""
        with self._lock:
            residents = [
                {"model": r.name, "bytes": r.bytes,
                 "loaded_at": round(r.loaded_at, 3),
                 "last_used": round(r.last_used, 3)}
                for r in self._resident.values()]
            evictions = dict(self.evictions)
            skips = dict(self.eviction_skips)
            shared = dict(self._shared)
        out = {
            "budget_bytes": self.budget_bytes,
            "used_bytes": (sum(r["bytes"] for r in residents)
                           + sum(shared.values())),
            "resident": residents,
            "evictions": evictions,
            "eviction_skips": skips,
        }
        if shared:
            out["shared"] = shared
        return out
