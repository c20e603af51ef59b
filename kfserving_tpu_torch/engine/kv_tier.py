"""Host-memory KV tier: capacity-evicted prefix blocks spill here and
fault back with one host-to-device copy and pool insert on the next turn.

Port of ``kfserving_tpu/engine/kv_tier.py``, with the same manifest format
and ``_MANIFEST_V``: a tier directory written by either package is adopted
by the other.  The engine's capacity evictions (``generator.py``
``_alloc_block_locked``) spill the LRU cached prefix block's k/v into a
page-aligned host mmap keyed by the chain digest the prefix index already
computes, and the admission plan probes device index -> host tier ->
re-prefill.

A payload is one block's k/v in the JAX layout: layer-major, k then v,
each ``[block_size, heads, head_dim]`` in the cache dtype (bfloat16 as its
16-bit patterns).

Robustness contract:

- **Transactional spill**: the in-memory index entry publishes only after
  the slot's full payload is written; a failed spill leaves the tier as
  it was and the eviction degrades to a plain drop.
- **Transactional fault-back**: ``begin_fault``/``end_fault`` bracket a
  read; a failed fault-back drops the (now suspect) entry so the
  replanned admission misses the tier and re-prefills.
- **Bounded LRU ledger with admission-aware eviction**: at most
  ``capacity_blocks`` entries; admitting a spill evicts the LRU entry but
  never one mid-fault-in, and the file is clamped against the host's
  available memory (``hbm.host_memory_bytes``).
- **Single-flight fault-in**: ``begin_fault`` refcounts in-flight chains;
  concurrent returning turns coalesce on one read (outcome=coalesced).
- **Durable handoff**: under a persistent directory (``KFS_KV_TIER_DIR``
  or ``directory=``) each process writes its payload file plus a
  versioned, crash-safe JSONL manifest (``kv_tier-<model>-<nonce>
  .manifest``) and holds an exclusive ``flock`` on it for its lifetime.
  The flock is the liveness authority: it releases on any process death,
  SIGKILL included.  A successor adopts every unlocked generation it
  finds; each entry is digest-verified against its manifest record, and
  torn, truncated, corrupt or version-skewed entries drop one by one
  (never served, never fatal to the boot); the drained generation's files
  are deleted.  With no directory the tier lives in a private tempdir and
  nothing survives the process.
- **Observable**: occupancy, spill and fault families plus the
  ``kv_handoff_reattached_blocks_total`` adoption outcomes, and a
  ``debug()`` block under ``/debug/cache``.  A fault-back storm
  (``KFS_KV_TIER_STORM_*``) is counted and pins a flight-recorder entry
  into the recorder the server attaches.

Storage: page-aligned slot stride, one preallocated file; publication is
the in-memory index, and in persistent mode the manifest record lands
before the index publishes, so the on-disk view never claims a chain
whose payload is not fully written (a crash between payload write and
manifest append leaves an unreferenced slot; a crash mid-append leaves a
torn line the replay skips).

Path containment: the directory is resolved once; every file this module
creates, reads or deletes is checked to lie inside it, and a
non-directory target fails construction with a clear error.

Threading: ``put()`` runs on the engine's fetch executor, ``read()`` and
``read_into()`` on the enqueue executor, ``contains``/``begin_fault`` on
the scheduler loop; all state is guarded by one lock, and every payload
copy in or out of the mmap happens under it.
"""

import fcntl
import hashlib
import json
import logging
import mmap
import os
import tempfile
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional

from kfserving_tpu_torch.engine.hbm import host_memory_bytes
from kfserving_tpu_torch.observability import metrics as obs

logger = logging.getLogger("kfserving_tpu_torch.kv_tier")

# Page alignment for slot strides (the param cache's discipline): the
# kernel faults whole pages, so a slot straddling page boundaries costs
# an extra fault per read for no layout benefit.
_ALIGN = 4096

# Never let the spill file claim more than this fraction of the host's
# available memory — the tier is a cache under the serving process, not
# a tenant that evicts it.
_HOST_MEM_FRACTION = 0.5

# Manifest record schema version.  Replay skips records whose `v`
# differs (counted as version_skew) — a rolling upgrade where old and
# new replicas share one tier dir drops only the unreadable entries.
_MANIFEST_V = 1

# Payload digests are 16-byte blake2b — same construction as the
# prefix-index chain digests, so verification cost stays proportional
# to one block's bytes.
_DIGEST_SIZE = 16

_ADOPT_OUTCOMES = ("adopted", "duplicate", "corrupt", "truncated",
                   "torn", "version_skew", "dropped_capacity",
                   "failed")


def _env_int(name: str, default: int) -> int:
    try:
        return int(float(os.environ.get(name, default)))
    except (TypeError, ValueError):
        return default


def payload_digest(payload: bytes) -> str:
    """Hex digest a block payload is verified against: on manifest
    replay, on peer-transfer receipt (`/kv/chains/<chain>`), and in
    the response header the peer endpoint serves."""
    return hashlib.blake2b(payload, digest_size=_DIGEST_SIZE).hexdigest()


class HostKVTier:
    """Bounded host-memory ledger of spilled KV blocks, chain-keyed.

    `block_bytes` is the exact payload size of one block's k/v across
    all layers; `capacity_blocks` bounds the ledger (clamped against
    available host memory).  The tier never touches device state — the
    engine owns gather/insert dispatches; this class owns bytes,
    the LRU index, the durable manifest, and the telemetry.
    """

    def __init__(self, *, block_bytes: int, capacity_blocks: int,
                 directory: Optional[str] = None,
                 model: str = "decoder"):
        if block_bytes <= 0:
            raise ValueError("block_bytes must be positive")
        if capacity_blocks <= 0:
            raise ValueError("capacity_blocks must be positive")
        self.model = model
        self.block_bytes = int(block_bytes)
        self.slot_bytes = (
            (self.block_bytes + _ALIGN - 1) // _ALIGN * _ALIGN)
        # hbm.py ledger interplay: the device ledger budgets HBM, this
        # one budgets host RAM — clamp the file against what the host
        # can actually give without swapping the serving process out.
        avail = host_memory_bytes()
        capacity_blocks = int(capacity_blocks)
        if avail > 0:
            max_blocks = int(avail * _HOST_MEM_FRACTION
                             // self.slot_bytes)
            if 0 < max_blocks < capacity_blocks:
                logger.warning(
                    "kv tier capacity clamped %d -> %d blocks "
                    "(host memory available: %.1f GiB)",
                    capacity_blocks, max_blocks, avail / 1024**3)
                capacity_blocks = max_blocks
        self.capacity_blocks = max(1, capacity_blocks)

        # A caller-provided directory means the tier is PERSISTENT:
        # its files outlive this process for a successor to adopt.  No
        # directory means an ephemeral tempdir.
        self._owns_dir = directory is None
        self.persistent = directory is not None
        if directory is not None:
            directory = os.path.realpath(directory)
            if os.path.exists(directory) and \
                    not os.path.isdir(directory):
                raise ValueError(
                    f"KV tier dir {directory!r} exists and is not a "
                    "directory — point KFS_KV_TIER_DIR (or the "
                    "model's host_tier_dir) at a directory path")
        else:
            directory = os.path.realpath(tempfile.mkdtemp(
                prefix=f"kfs-kvtier-{model}-"))
        os.makedirs(directory, exist_ok=True)
        self.directory = directory

        if self.persistent:
            # Per-process generation naming: pid + random nonce, so
            # two replicas sharing the dir never collide and a
            # successor can tell its own files from a predecessor's.
            nonce = f"{os.getpid():x}-{os.urandom(4).hex()}"
            base = f"kv_tier-{model}-{nonce}"
        else:
            base = "kv_tier"
        self.path = os.path.join(directory, base + ".bin")
        size = self.capacity_blocks * self.slot_bytes
        fd = os.open(self.path, os.O_RDWR | os.O_CREAT, 0o600)
        try:
            os.ftruncate(fd, size)  # sparse until slots are written
            self._mm = mmap.mmap(fd, size)
        finally:
            os.close(fd)

        self._lock = threading.Lock()
        self._index: "OrderedDict[bytes, int]" = OrderedDict()
        self._free: deque = deque(range(self.capacity_blocks))
        # chain -> in-flight fault-back refcount: eviction never
        # victimizes these (admission-aware), and a second concurrent
        # fault on the same chain is counted as coalesced.
        self._inflight: Dict[bytes, int] = {}
        self._closed = False

        # -- durable manifest (persistent mode only) -------------------
        self._manifest_path = os.path.join(
            directory, base + ".manifest")
        self._mfd: Optional[int] = None
        self._digests: Dict[bytes, str] = {}
        self._manifest_records = 0
        self.manifest_failures = 0
        # Compaction bound: the manifest is append-only, so a
        # long-lived churny tier would grow it without this.
        self._manifest_max_records = max(
            1024, 8 * self.capacity_blocks)
        if self.persistent:
            self._mfd = os.open(
                self._manifest_path,
                os.O_RDWR | os.O_CREAT | os.O_APPEND, 0o600)
            # The flock IS the liveness authority for adoption: held
            # for this process's lifetime, auto-released on any death
            # (SIGKILL included) — a successor that can take it knows
            # the generation is orphaned.
            fcntl.flock(self._mfd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            header = {
                "kind": "kfs-kv-tier", "v": _MANIFEST_V,
                "model": self.model,
                "block_bytes": self.block_bytes,
                "slot_bytes": self.slot_bytes,
                "capacity_blocks": self.capacity_blocks,
            }
            os.write(self._mfd,
                     (json.dumps(header) + "\n").encode("utf-8"))
            self._manifest_records = 1

        # -- counters (ints under the lock; registry twins emitted at
        # the event site) ----------------------------------------------
        self.spills = 0
        self.spill_failures = 0
        self.spill_duplicates = 0
        self.faults = 0            # physically read-back blocks
        self.coalesced = 0         # riders on an in-flight fault
        self.fault_failures = 0
        self.evictions = 0         # LRU capacity evictions
        self.eviction_skips = 0    # vetoed: victim mid-fault-in
        self.dropped = 0           # entries dropped after a failed
        #                            fault-back (presumed unusable)
        self._fault_ms: deque = deque(maxlen=512)

        # Lifetime adoption tallies (per-outcome block counts plus
        # generation-level bookkeeping), surfaced in debug().
        self.handoff: Dict[str, int] = {
            k: 0 for k in _ADOPT_OUTCOMES}
        self.handoff["generations_adopted"] = 0
        self.handoff["generations_live"] = 0
        self.handoff["generations_rejected"] = 0

        # -- fault-back storm detection (flight-recorder pin) ----------
        self.storm_window_s = float(os.environ.get(
            "KFS_KV_TIER_STORM_WINDOW_S", "10"))
        self.storm_threshold = _env_int(
            "KFS_KV_TIER_STORM_THRESHOLD", 32)
        self._fault_times: deque = deque(maxlen=1024)
        self._storm_pinned_at = 0.0
        self._flight_recorder = None

        if self.persistent:
            # Boot-time adoption: drain every orphaned predecessor
            # generation in the shared dir (exclusive-swap successors
            # and plain restarts get their warm chains here; warm
            # swaps and crash promotions re-scan via reattach()).
            self._adopt_generations()

    # -- wiring ------------------------------------------------------------
    def attach_flight_recorder(self, recorder) -> None:
        """Point storm pins at a flight recorder (the serving
        ModelServer attaches its monitoring recorder at start)."""
        self._flight_recorder = recorder

    # -- probes (scheduler-loop safe: dict lookups only) -------------------
    def contains(self, chain: bytes) -> bool:
        with self._lock:
            return chain in self._index

    def chains(self) -> List[str]:
        """Hex chain digests currently resident (MRU last) — the
        peer-transfer index `GET /kv/chains` serves."""
        with self._lock:
            return [c.hex() for c in self._index]

    def begin_fault(self, chain: bytes) -> bool:
        """Mark `chain` in-flight for fault-back (single-flight
        bracket).  Returns False when the tier no longer holds it —
        the caller falls through to re-prefill.  While in-flight the
        entry cannot be evicted by a concurrent spill admission."""
        with self._lock:
            if chain not in self._index:
                return False
            self._inflight[chain] = self._inflight.get(chain, 0) + 1
            return True

    def note_coalesced(self, blocks: int = 1) -> None:
        with self._lock:
            self.coalesced += blocks
        obs.generator_kv_tier_faultbacks_total().labels(
            model=self.model, outcome="coalesced").inc(blocks)

    def end_fault(self, chain: bytes) -> None:
        with self._lock:
            n = self._inflight.get(chain, 0) - 1
            if n <= 0:
                self._inflight.pop(chain, None)
            else:
                self._inflight[chain] = n

    # -- path containment ---------------------------------------------------
    def _contained(self, path: str) -> bool:
        """True when `path` resolves inside the tier directory — the
        gate every unlink/rename candidate passes before the
        filesystem call (a symlink planted in a shared tier dir must
        not steer a delete outside it)."""
        try:
            rp = os.path.realpath(path)
            return os.path.commonpath(
                [rp, self.directory]) == self.directory
        except (OSError, ValueError):
            return False

    # -- durable manifest --------------------------------------------------
    def _manifest_append_locked(self, record: Dict[str, Any]) -> None:
        """Append one record (caller holds the lock).  A failed append
        is non-fatal — the in-memory tier keeps serving; the entry
        just won't survive a handoff (counted)."""
        if self._mfd is None:
            return
        try:
            os.write(self._mfd,
                     (json.dumps(record) + "\n").encode("utf-8"))
            self._manifest_records += 1
            if self._manifest_records > self._manifest_max_records:
                self._compact_manifest_locked()
        except OSError:
            self.manifest_failures += 1

    def _compact_manifest_locked(self) -> None:
        """Rewrite the manifest as header + one put per live entry.
        The tmp file is flocked BEFORE the rename so there is no
        instant where the published manifest is unlocked (a scanning
        successor would otherwise adopt a live generation)."""
        tmp = self._manifest_path + ".tmp"
        if not (self._contained(tmp)
                and self._contained(self._manifest_path)):
            self.manifest_failures += 1
            return
        header = {
            "kind": "kfs-kv-tier", "v": _MANIFEST_V,
            "model": self.model,
            "block_bytes": self.block_bytes,
            "slot_bytes": self.slot_bytes,
            "capacity_blocks": self.capacity_blocks,
        }
        lines = [json.dumps(header)]
        for chain, slot in self._index.items():
            digest = self._digests.get(chain)
            if digest is None:
                continue
            lines.append(json.dumps({
                "op": "put", "v": _MANIFEST_V, "chain": chain.hex(),
                "slot": slot, "digest": digest}))
        fd = os.open(tmp, os.O_RDWR | os.O_CREAT | os.O_TRUNC
                     | os.O_APPEND, 0o600)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            os.write(fd, ("\n".join(lines) + "\n").encode("utf-8"))
            os.replace(tmp, self._manifest_path)
        except OSError:
            self.manifest_failures += 1
            os.close(fd)
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return
        old = self._mfd
        self._mfd = fd
        self._manifest_records = len(lines)
        if old is not None:
            try:
                os.close(old)
            except OSError:
                pass

    # -- spill (fetch-executor thread) -------------------------------------
    def put(self, chain: bytes, payload: bytes) -> bool:
        """Admit one block's payload.  Transactional: the index entry
        publishes only after the slot holds the complete payload (and,
        in persistent mode, after the manifest records it), so a
        failure at any point leaves the tier without the chain (the
        eviction that produced it degrades to a plain drop).  Returns
        False on failure; never raises."""
        try:
            if len(payload) != self.block_bytes:
                raise ValueError(
                    f"payload {len(payload)}B != block {self.block_bytes}B")
            with self._lock:
                if self._closed:
                    return False
                if chain in self._index:
                    # Already safe (a fault-back re-registered the
                    # chain on device and it was re-evicted before
                    # this late spill resolved).
                    self.spill_duplicates += 1
                    obs.generator_kv_tier_spills_total().labels(
                        model=self.model, outcome="duplicate").inc()
                    return True
                slot = self._reserve_slot_locked()
                if slot is None:
                    raise RuntimeError(
                        "kv tier full: every entry is mid-fault-in")
                off = slot * self.slot_bytes
                self._mm[off:off + self.block_bytes] = payload
                if self.persistent:
                    digest = payload_digest(payload)
                    self._digests[chain] = digest
                    # Record BEFORE publication: the on-disk view
                    # never claims a chain whose payload isn't fully
                    # written (replay digest-verifies regardless).
                    self._manifest_append_locked({
                        "op": "put", "v": _MANIFEST_V,
                        "chain": chain.hex(), "slot": slot,
                        "digest": digest})
                # Publication point: a reader can only find the chain
                # AFTER the full payload landed.
                self._index[chain] = slot
                self._index.move_to_end(chain)
                self.spills += 1
            obs.generator_kv_tier_spills_total().labels(
                model=self.model, outcome="spilled").inc()
            self._publish_occupancy()
            return True
        except Exception:
            logger.exception("kv tier spill failed (%s)", self.model)
            with self._lock:
                self.spill_failures += 1
            obs.generator_kv_tier_spills_total().labels(
                model=self.model, outcome="failed").inc()
            return False

    def note_spill_failure(self, blocks: int = 1) -> None:
        """Spills aborted before ever reaching put() — e.g. the
        `engine.kv_spill` chaos site firing on the gather fetch.  The
        evictions degrade to plain drops; this keeps the tier's
        attempt accounting honest about it."""
        with self._lock:
            self.spill_failures += blocks
        obs.generator_kv_tier_spills_total().labels(
            model=self.model, outcome="failed").inc(blocks)

    def _reserve_slot_locked(self) -> Optional[int]:
        if self._free:
            return self._free.popleft()
        # LRU eviction, admission-aware: never victimize an entry a
        # fault-back is reading right now (hbm.py's victim_ok veto,
        # host-side) — skip it and take the next-oldest.
        for chain in self._index:
            if chain in self._inflight:
                self.eviction_skips += 1
                obs.generator_kv_tier_evictions_total().labels(
                    model=self.model, reason="skipped_inflight").inc()
                continue
            slot = self._index.pop(chain)
            self._digests.pop(chain, None)
            # No drop record: the put that triggered this eviction
            # writes a put record for the SAME slot, and replay is
            # last-writer-wins per slot — the evicted chain is
            # superseded on disk the moment the admission lands.  A
            # crash in between leaves a record whose payload digest
            # no longer matches; replay drops it as corrupt.
            self.evictions += 1
            obs.generator_kv_tier_evictions_total().labels(
                model=self.model, reason="capacity").inc()
            return slot
        return None

    # -- fault-back (enqueue-executor thread) ------------------------------
    def read(self, chain: bytes) -> bytes:
        """One block's payload (a bytes copy — the mmap slot can be
        recycled by a concurrent spill the moment the lock drops).
        Raises KeyError when the chain is gone (evicted between the
        plan's probe and this read) — the caller's fault-back fails
        transactionally and the turn re-prefills."""
        with self._lock:
            slot = self._index.get(chain)
            if slot is None:
                raise KeyError(chain.hex())
            off = slot * self.slot_bytes
            payload = bytes(self._mm[off:off + self.block_bytes])
            self._index.move_to_end(chain)
        return payload

    def read_into(self, chain: bytes, out) -> None:
        """Copy one block's payload into ``out`` (a writable buffer of
        ``block_bytes`` bytes, e.g. a pinned staging row): the fault-back's
        single host copy.  Raises KeyError as ``read()`` does."""
        view = memoryview(out).cast("B")
        if len(view) != self.block_bytes:
            raise ValueError(
                f"buffer {len(view)}B != block {self.block_bytes}B")
        with self._lock:
            slot = self._index.get(chain)
            if slot is None:
                raise KeyError(chain.hex())
            off = slot * self.slot_bytes
            src = memoryview(self._mm)
            try:
                view[:] = src[off:off + self.block_bytes]
            finally:
                src.release()  # an exported mmap cannot close
            self._index.move_to_end(chain)

    def note_faultback(self, blocks: int, elapsed_ms: float) -> None:
        """Account one successful fault-back batch: `blocks` physical
        reads landed on device in `elapsed_ms`."""
        with self._lock:
            self.faults += blocks
            self._fault_ms.append(elapsed_ms)
        obs.generator_kv_tier_faultbacks_total().labels(
            model=self.model, outcome="faulted").inc(blocks)
        obs.generator_kv_tier_faultback_ms().labels(
            model=self.model).observe(elapsed_ms)
        self._note_storm(blocks)

    def note_fault_failure(self, blocks: int = 1) -> None:
        with self._lock:
            self.fault_failures += blocks
        obs.generator_kv_tier_faultbacks_total().labels(
            model=self.model, outcome="failed").inc(blocks)

    def drop(self, chain: bytes) -> None:
        """Remove an entry (failed fault-back: the payload is suspect
        — the replanned turn must MISS the tier and re-prefill)."""
        with self._lock:
            slot = self._index.pop(chain, None)
            if slot is None:
                return
            self._free.append(slot)
            self._digests.pop(chain, None)
            if self.persistent:
                self._manifest_append_locked({
                    "op": "drop", "v": _MANIFEST_V,
                    "chain": chain.hex()})
            self.dropped += 1
        obs.generator_kv_tier_evictions_total().labels(
            model=self.model, reason="faultback_failed").inc()
        self._publish_occupancy()

    # -- durable handoff: adopting predecessor generations -----------------
    def reattach(self) -> Dict[str, int]:
        """Re-scan the tier dir and adopt any orphaned predecessor
        generation (POST /kv/reattach; the orchestrator calls it on
        the successor after a warm swap or crash promotion).  Returns
        this invocation's per-outcome block tallies.  No-op for
        ephemeral tiers."""
        if not self.persistent:
            return {}
        return self._adopt_generations()

    def _adopt_generations(self) -> Dict[str, int]:
        out: Dict[str, int] = {k: 0 for k in _ADOPT_OUTCOMES}
        out["generations_adopted"] = 0
        out["generations_live"] = 0
        out["generations_rejected"] = 0
        try:
            names = sorted(os.listdir(self.directory))
        except OSError:
            return out
        own = os.path.realpath(self._manifest_path)
        for name in names:
            if not (name.startswith("kv_tier-")
                    and name.endswith(".manifest")):
                continue
            mpath = os.path.join(self.directory, name)
            if os.path.realpath(mpath) == own:
                continue
            if not self._contained(mpath):
                out["generations_rejected"] += 1
                continue
            self._adopt_one(mpath, out)
        for outcome in _ADOPT_OUTCOMES:
            if out[outcome]:
                obs.kv_handoff_reattached_blocks_total().labels(
                    model=self.model, outcome=outcome).inc(
                        out[outcome])
        with self._lock:
            for k, v in out.items():
                self.handoff[k] = self.handoff.get(k, 0) + v
        if out["adopted"] or out["generations_rejected"] or any(
                out[k] for k in ("corrupt", "truncated", "torn",
                                 "version_skew")):
            logger.info(
                "kv tier handoff (%s): adopted=%d duplicate=%d "
                "corrupt=%d truncated=%d torn=%d version_skew=%d "
                "dropped_capacity=%d generations=%d/%d live=%d",
                self.model, out["adopted"], out["duplicate"],
                out["corrupt"], out["truncated"], out["torn"],
                out["version_skew"], out["dropped_capacity"],
                out["generations_adopted"],
                out["generations_adopted"]
                + out["generations_rejected"],
                out["generations_live"])
        recorder = self._flight_recorder
        if recorder is not None and (
                out["adopted"] or out["generations_rejected"]):
            try:
                recorder.record({
                    "kind": "kv_handoff_reattach",
                    "model": self.model, **out,
                }, pin="kv_handoff_reattach")
            except Exception:
                pass
        return out

    def _adopt_one(self, mpath: str, out: Dict[str, int]) -> None:
        """Adopt (or discard) one foreign generation.  The flock probe
        decides everything: held → the owner is alive, skip entirely;
        acquired → the generation is orphaned, drain it and delete its
        files.  Every admitted payload is digest-verified first."""
        try:
            fd = os.open(mpath, os.O_RDWR)
        except OSError:
            return
        try:
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                # Owner alive (another replica of this model sharing
                # the dir) — its generation is not ours to touch.
                out["generations_live"] += 1
                os.close(fd)
                return
            try:
                with open(fd, "r", encoding="utf-8",
                          errors="replace", closefd=False) as f:
                    lines = f.read().splitlines()
            except OSError:
                lines = []
            header = None
            if lines:
                try:
                    header = json.loads(lines[0])
                except (ValueError, TypeError):
                    header = None
            if (not isinstance(header, dict)
                    or header.get("kind") != "kfs-kv-tier"):
                # Unrecognizable generation: self-delete (torn header
                # from a crash mid-create, or junk in the dir).
                out["generations_rejected"] += 1
                self._discard_generation(mpath)
                return
            if header.get("model") != self.model:
                # Another model's tier sharing the dir — not ours.
                return
            if header.get("v") != _MANIFEST_V:
                out["generations_rejected"] += 1
                out["version_skew"] += max(0, len(lines) - 1)
                self._discard_generation(mpath)
                return
            if header.get("block_bytes") != self.block_bytes:
                # Geometry changed across the restart (model config
                # edit): payloads are uninterpretable — discard.
                out["generations_rejected"] += 1
                self._discard_generation(mpath)
                return
            try:
                foreign_stride = int(header.get(
                    "slot_bytes", self.slot_bytes))
            except (TypeError, ValueError):
                foreign_stride = self.slot_bytes
            state = self._replay_records(lines[1:], out)
            if state:
                self._admit_entries(mpath, foreign_stride, state, out)
            out["generations_adopted"] += 1
            self._discard_generation(mpath)
        finally:
            try:
                os.close(fd)  # releases the flock last
            except OSError:
                pass

    @staticmethod
    def _replay_records(lines: List[str],
                        out: Dict[str, int]) -> "OrderedDict":
        """Last-writer-wins replay, keyed per chain AND per slot: a
        later put to the same slot supersedes the earlier chain (how
        evictions are represented without drop records), and a drop
        removes the chain.  Torn JSON lines (crash mid-append) and
        version-skewed records each drop only themselves."""
        state: "OrderedDict[bytes, Any]" = OrderedDict()
        slot_owner: Dict[int, bytes] = {}
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except (ValueError, TypeError):
                out["torn"] += 1
                continue
            if not isinstance(rec, dict):
                out["torn"] += 1
                continue
            if rec.get("v") != _MANIFEST_V:
                out["version_skew"] += 1
                continue
            op = rec.get("op")
            try:
                if op == "put":
                    chain = bytes.fromhex(rec["chain"])
                    slot = int(rec["slot"])
                    digest = str(rec["digest"])
                    prev = slot_owner.get(slot)
                    if prev is not None and prev != chain:
                        state.pop(prev, None)
                    state.pop(chain, None)
                    state[chain] = (slot, digest)
                    slot_owner[slot] = chain
                elif op == "drop":
                    chain = bytes.fromhex(rec["chain"])
                    old = state.pop(chain, None)
                    if old is not None and \
                            slot_owner.get(old[0]) == chain:
                        slot_owner.pop(old[0], None)
                else:
                    out["torn"] += 1
            except (KeyError, ValueError, TypeError):
                out["torn"] += 1
        return state

    def _admit_entries(self, mpath: str, foreign_stride: int,
                       state: "OrderedDict",
                       out: Dict[str, int]) -> None:
        bin_path = mpath[:-len(".manifest")] + ".bin"
        if not self._contained(bin_path):
            out["truncated"] += len(state)
            return
        try:
            bf = open(bin_path, "rb")
        except OSError:
            # Payload file gone: every surviving record is unservable.
            out["truncated"] += len(state)
            return
        try:
            try:
                bin_size = os.fstat(bf.fileno()).st_size
            except OSError:
                bin_size = 0
            # Manifest order is admission order, so iterating it keeps
            # the predecessor's LRU shape: the hottest (most recently
            # put) chains land last and become our MRU.
            for chain, (slot, digest) in state.items():
                off = slot * foreign_stride
                if off + self.block_bytes > bin_size:
                    out["truncated"] += 1
                    continue
                try:
                    bf.seek(off)
                    payload = bf.read(self.block_bytes)
                except OSError:
                    out["truncated"] += 1
                    continue
                if len(payload) != self.block_bytes:
                    out["truncated"] += 1
                    continue
                if payload_digest(payload) != digest:
                    out["corrupt"] += 1
                    continue
                with self._lock:
                    if self._closed:
                        out["failed"] += 1
                        continue
                    if chain in self._index:
                        out["duplicate"] += 1
                        continue
                    if not self._free:
                        # Adoption never evicts our own live entries —
                        # the successor's working set outranks the
                        # predecessor's cold tail.
                        out["dropped_capacity"] += 1
                        continue
                    slot2 = self._free.popleft()
                    off2 = slot2 * self.slot_bytes
                    self._mm[off2:off2 + self.block_bytes] = payload
                    self._digests[chain] = digest
                    self._manifest_append_locked({
                        "op": "put", "v": _MANIFEST_V,
                        "chain": chain.hex(), "slot": slot2,
                        "digest": digest})
                    self._index[chain] = slot2
                out["adopted"] += 1
        finally:
            bf.close()
        self._publish_occupancy()

    def _discard_generation(self, mpath: str) -> None:
        """Delete one foreign generation's files (containment-checked:
        nothing outside the tier dir is ever unlinked)."""
        for path in (mpath, mpath[:-len(".manifest")] + ".bin"):
            if not self._contained(path):
                continue
            try:
                os.unlink(path)
            except OSError:
                pass

    # -- storm pin ---------------------------------------------------------
    def _note_storm(self, blocks: int) -> None:
        now = time.monotonic()
        for _ in range(blocks):
            self._fault_times.append(now)
        recent = sum(1 for t in self._fault_times
                     if now - t <= self.storm_window_s)
        if recent <= self.storm_threshold:
            return
        recorder = self._flight_recorder
        # One pin per storm window, not one per fault in it.
        if recorder is None or \
                now - self._storm_pinned_at < self.storm_window_s:
            return
        self._storm_pinned_at = now
        recorder.record({
            "kind": "kv_tier_faultback_storm",
            "model": self.model,
            "faults_in_window": recent,
            "window_s": self.storm_window_s,
            "host_tier": self.debug(),
        }, pin="kv_faultback_storm")
        logger.warning(
            "kv tier fault-back storm: %d blocks in %.0fs (device "
            "pool churns conversations through the host tier — "
            "flight-recorder entry pinned)",
            recent, self.storm_window_s)

    # -- introspection -----------------------------------------------------
    def _publish_occupancy(self) -> None:
        with self._lock:
            used = len(self._index)
        obs.generator_kv_tier_blocks().labels(
            model=self.model).set(float(used))
        obs.generator_kv_tier_occupancy_ratio().labels(
            model=self.model).set(
                min(1.0, used / max(1, self.capacity_blocks)))

    def debug(self) -> Dict[str, Any]:
        """The `host_tier` block of `/debug/cache`, federated by the
        router under the `replica` label."""
        with self._lock:
            samples = sorted(self._fault_ms)

            def pct(q: float) -> float:
                if not samples:
                    return 0.0
                return round(samples[min(len(samples) - 1,
                                         int(len(samples) * q))], 3)

            return {
                "capacity_blocks": self.capacity_blocks,
                "used_blocks": len(self._index),
                "block_bytes": self.block_bytes,
                "slot_bytes": self.slot_bytes,
                "file_bytes": self.capacity_blocks * self.slot_bytes,
                "inflight_faults": len(self._inflight),
                "spills": self.spills,
                "spill_failures": self.spill_failures,
                "spill_duplicates": self.spill_duplicates,
                "faulted_blocks": self.faults,
                "coalesced_blocks": self.coalesced,
                "fault_failures": self.fault_failures,
                "evictions": self.evictions,
                "eviction_skips": self.eviction_skips,
                "dropped": self.dropped,
                "faultback_ms": {"p50": pct(0.50), "p99": pct(0.99)},
                "persistent": self.persistent,
                "manifest_records": self._manifest_records,
                "manifest_failures": self.manifest_failures,
                "handoff": dict(self.handoff),
            }

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._index.clear()
            self._inflight.clear()
            self._digests.clear()
            try:
                self._mm.close()
            except Exception:
                pass
            if self._mfd is not None:
                try:
                    os.close(self._mfd)  # releases the flock
                except OSError:
                    pass
                self._mfd = None
        if self.persistent:
            # The whole point: files STAY for the successor to adopt.
            return
        try:
            os.unlink(self.path)
            if self._owns_dir:
                os.rmdir(os.path.dirname(self.path))
        except OSError:
            pass
