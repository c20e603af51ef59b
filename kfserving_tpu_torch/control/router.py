"""Ingress router: the Istio-VirtualService + activator equivalent.

Reference routing rules (pkg/controller/v1beta1/inferenceservice/
reconcilers/ingress/ingress_reconciler.go:164-236): top-level traffic goes
to the transformer when one exists, else the predictor; `:explain` paths
go to the explainer; canary splits ride weighted revision targets.  The
activator role (buffer + scale-from-zero, reference
test/benchmark/README.md:14-17) lives here too: a request for a
zero-replica component triggers scale-up and waits for readiness.

One router fronts many InferenceServices; services are addressed by model
name (the isvc name), matching the reference's host-regex authority match
reduced to its observable effect.
"""

import asyncio
import bisect
import hashlib
import itertools
import json
import logging
import os
import random
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from kfserving_tpu_torch.observability import REGISTRY
from kfserving_tpu_torch.observability import metrics as obs
from kfserving_tpu_torch.observability.accesslog import log_access
from kfserving_tpu_torch.observability.federation import merge_scrapes
from kfserving_tpu_torch.reliability import (
    CircuitBreaker,
    Deadline,
    FaultInjected,
    PRIORITY_HEADER,
    TIMEOUT_HEADER,
    fault_sites,
    faults,
    priority_tier,
)
from kfserving_tpu_torch.server.client import ConnectError, HTTPClient
from kfserving_tpu_torch.server.http import (
    HTTPServer,
    Request,
    Response,
    Router,
    StreamingResponse,
)
from kfserving_tpu_torch.streams import GuardedStream
from kfserving_tpu_torch.tracing import (
    REQUEST_ID_HEADER,
    TRACEPARENT_HEADER,
    TraceContext,
    ensure_trace_context,
    tracer,
)

logger = logging.getLogger("kfserving_tpu_torch.control.router")

ACTIVATOR_TIMEOUT_S = 60.0

# Every proxied response is tagged with the revision that served it:
# clients (and tests) can attribute an answer to canary vs stable
# without scraping metrics.
REVISION_HEADER = "x-kfs-revision"


class IngressRouter:
    # Virtual nodes per replica on the consistent-hash ring.  Arc
    # balance decides whether a replica's model share fits its HBM
    # budget, so small fleets need MANY vnodes: at 2 replicas, 32
    # vnodes can split a 20-model catalog 13/7 (the heavy replica
    # thrashes its arc), while 128 keeps splits near-even.  Ring
    # build is O(replicas * vnodes * log) and cached per replica set.
    AFFINITY_VNODES = 128

    def __init__(self, controller, http_port: int = 0, seed: int = 0,
                 upstream_timeout_s: Optional[float] = None,
                 buffer_deadline_s: Optional[float] = None,
                 breaker_factory: Optional[
                     Callable[[str], CircuitBreaker]] = None,
                 swap_hold_max: int = 1024,
                 brownout=None,
                 affinity: Optional[str] = None,
                 affinity_spill: Optional[int] = None):
        self.controller = controller  # Controller (store + reconciler)
        self.http_port = http_port
        self.upstream_timeout_s = upstream_timeout_s or ACTIVATOR_TIMEOUT_S
        # Bounded activator buffering: a request that finds no ready
        # replica (scale-from-zero, recycle swap window) waits at most
        # this long before shedding 503 + Retry-After.  Unbounded
        # parking hides a swap brownout inside "100% success" at a
        # p99 of many seconds; shedding past a deadline is the better
        # trade under overload.
        self.buffer_deadline_s = (buffer_deadline_s
                                  if buffer_deadline_s is not None
                                  else ACTIVATOR_TIMEOUT_S)
        # Announced-swap holds: when the orchestrator
        # publishes a drain->activate window for a component, requests
        # that find no replica are HELD in a bounded queue (at most
        # swap_hold_max concurrently; the hold is also bounded by
        # buffer_deadline_s and the request's own budget) instead of
        # shedding 503s across a planned swap.
        self.swap_hold_max = swap_hold_max
        self._swap_held: Dict[str, int] = {}
        # Brownout admission control: a BrownoutController
        # whose per-model levels the predictive control loop sets.
        # None = every request admitted (the pre-brownout behavior).
        self.brownout = brownout
        # Model-affinity routing: "model" hashes the
        # requested model name onto a consistent ring over the
        # component's replicas, so a fleet fronting a multi-model
        # repository PARTITIONS the model set — each replica's HBM
        # working set shrinks to its ring arc instead of every replica
        # thrashing the whole catalog.  "prefix" hashes the
        # normalized prompt's first-N-block chain digest instead, so
        # conversations sharing a prompt prefix land on the replica
        # whose engine-side prefix index already holds those KV blocks
        # (the digest construction mirrors the engine's, so equal keys
        # really mean shareable blocks).  Both modes ride the SAME
        # ring/vnode/spill machinery, and the breaker/health machinery
        # stays the escape hatch: an unhealthy or overloaded primary
        # spills to the next ring position, and a ring that yields
        # nothing (or an injected `router.affinity_pick` fault) falls
        # back to plain round-robin.  Default "none" keeps the blind
        # round-robin spray (single-model services gain nothing from
        # pinning every request to one replica).
        self.affinity = (affinity if affinity is not None
                         else os.environ.get("KFS_ROUTER_AFFINITY",
                                             "none"))
        # Per-host in-flight ceiling before an affinity pick spills to
        # the next ring position (0 disables spilling-on-load).
        self.affinity_spill = (
            affinity_spill if affinity_spill is not None
            else int(os.environ.get("KFS_ROUTER_AFFINITY_SPILL", "8")))
        # Prefix-affinity key shape: how many leading prompt blocks of
        # how many tokens feed the chain digest.  The block size should
        # match the serving engine's `block_size` so the router's key
        # equals the engine's prefix-index chain for those blocks;
        # the block COUNT bounds both hashing cost and key cardinality
        # (deeper chains over-shard conversations that share a long
        # system prompt but diverge late).
        self.affinity_prefix_blocks = int(os.environ.get(
            "KFS_ROUTER_AFFINITY_PREFIX_BLOCKS", "4"))
        self.affinity_prefix_block_tokens = int(os.environ.get(
            "KFS_ROUTER_AFFINITY_PREFIX_BLOCK", "128"))
        self._host_inflight: Dict[str, int] = {}
        self._ring_cache: Dict[tuple, List[Tuple[int, str]]] = {}
        self._rng = random.Random(seed)
        self._rr = {}  # component_id -> round-robin counter
        self.router = Router()
        self._register_routes()
        self.http_server = HTTPServer(self.router)
        self._session = None
        self.inflight: Dict[str, int] = {}  # component_id -> gauge
        self.request_count: Dict[str, int] = {}
        # OFFERED load per entry component, counted BEFORE the
        # brownout gate: the predictive scaler's arrival signal must
        # see shed demand, or shedding would erase the very signal
        # that justified it (request_count stays "dispatched", the
        # pre-brownout meaning).
        self.offered_count: Dict[str, int] = {}
        # One circuit breaker per replica host (KFS_ROUTER_BREAKER_*
        # knobs).  half_open_max=0: recovery is NEVER a trial request —
        # an opened breaker's host rejoins rotation only after the
        # background health reprobe sees it answer its liveness route.
        # Timeouts feed the breaker but (unlike connect failures) do
        # not evict: a hung replica may still be chewing real work, so
        # it is *skipped* and reprobed — graceful degradation instead
        # of an error storm against a sick upstream.
        self._breaker_factory = breaker_factory or (
            lambda host: CircuitBreaker.from_env(
                "KFS_ROUTER", half_open_max=0,
                name=f"replica:{host}"))
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._reprobes: Dict[str, asyncio.Task] = {}

    # -- routes ------------------------------------------------------------
    def _register_routes(self):
        r = self.router
        r.add("POST", "/v1/models/{name}:predict", self._predict)
        r.add("POST", "/v1/models/{name}:explain", self._explain)
        r.add("POST", "/v2/models/{name}/infer", self._predict)
        r.add("POST", "/v2/models/{name}/explain", self._explain)
        # Generative verbs: route to the predictor component like
        # :predict (generation IS prediction in the component model).
        # Token streams pass through WITHOUT body buffering — each
        # upstream SSE chunk is flushed to the client as it arrives —
        # so streams get the same canary split, dead-replica failover
        # (at stream start), and scale-from-zero buffering as every
        # other verb (the flagship feature must not route around the
        # deployment machinery).
        r.add("POST", "/v1/models/{name}:generate", self._generate)
        r.add("POST", "/v2/models/{name}/generate", self._generate)
        r.add("POST", "/v2/models/{name}/generate_stream",
              self._generate)
        r.add("GET", "/v1/models/{name}", self._health)
        # Direct-to-predictor lane for transformer->predictor hops (the
        # reference's cluster-local gateway, constants.go:121-127).
        r.add("POST", "/direct/predictor/v1/models/{name}:predict",
              self._predict_direct)
        r.add("POST", "/direct/predictor/v2/models/{name}/infer",
              self._predict_direct)
        # Fleet telemetry: the router's own series plus every replica
        # scrape federated under a `replica` label, and a federated
        # trace view (?trace_id=&limit=&replica= pull from one replica
        # without dumping every ring buffer).
        r.add("GET", "/metrics", self._metrics)
        r.add("GET", "/debug/traces", self._debug_traces)
        # Monitoring-loop federation: fleet SLO health and
        # flight-recorder timelines, replica-scraped like the trace
        # view (?replica= narrows to one host).
        r.add("GET", "/v2/health/slo", self._slo_health)
        r.add("GET", "/debug/flightrecorder",
              self._debug_flightrecorder)
        # Device-time profiling federation: every replica's
        # engine event timeline merged into ONE Chrome trace, each
        # replica its own Perfetto process group (?replica= narrows to
        # one host; window_s/format pass through).
        r.add("GET", "/debug/profile", self._debug_profile)
        # Cache & cost attribution federation: every
        # replica's /debug/cache snapshot keyed under the `replica`
        # label — the feed prefix-affinity routing (ROADMAP item 3)
        # and the HBM residency manager (item 4) will consume.
        r.add("GET", "/debug/cache", self._debug_cache)
        # Telemetry-history federation: every replica's
        # ring-TSDB frames keyed under the `replica` label, resampled
        # onto one absolute epoch grid so a fleet rollup can merge
        # them by timestamp (rates sum, everything else means).
        r.add("GET", "/debug/history", self._debug_history)
        # Incident-engine federation: every replica's
        # diagnosed incidents keyed under the `replica` label, plus a
        # fleet rollup that dedups by (root cause, model) — the same
        # regression breaching N replicas is ONE fleet incident — and
        # the router's own admission/brownout state beside it (the
        # evidence only this vantage point holds).
        r.add("GET", "/debug/incidents", self._debug_incidents)
        # Progressive-delivery status: active rollouts,
        # recent promotions/rollbacks with pinned evidence, and the
        # quarantine ledger.
        r.add("GET", "/v2/rollouts", self._rollouts)

    async def start_async(self, host: str = "127.0.0.1"):
        # keepalive=False: no connection pooling to upstreams, and no
        # request is ever sent twice.  A reused half-closed socket
        # would fail before the replica saw anything — indistinguishable
        # from a true mid-request drop, which must NOT be retried (may
        # duplicate inference).  A connection per request makes "error
        # after connect" reliably mean "the request was dispatched"
        # (ConnectError is the only pre-dispatch failure), at the cost
        # of a TCP handshake per proxy hop (local links; the
        # reference's activator pays the same per-request dial).
        self._session = HTTPClient(timeout=self.upstream_timeout_s,
                                   keepalive=False)
        await self.http_server.start(host, self.http_port)
        self.http_port = self.http_server.port
        # Publish the cluster-local gateway address: explainer and
        # transformer replicas built after this point get predictor_host
        # injected (orchestrator._inject_predictor_host; subprocess
        # replicas see it as KFS_CLUSTER_LOCAL_URL).  Overwrite
        # unconditionally — a router restart binds a new ephemeral port
        # and a stale address would point new replicas at a dead socket.
        orch = self.controller.reconciler.orchestrator
        if hasattr(orch, "cluster_local_url"):
            orch.cluster_local_url = f"{host}:{self.http_port}"

    async def stop_async(self):
        for task in self._reprobes.values():
            task.cancel()
        if self._reprobes:
            await asyncio.gather(*self._reprobes.values(),
                                 return_exceptions=True)
        self._reprobes.clear()
        if self._session is not None:
            await self._session.close()
            self._session = None
        await self.http_server.stop()

    # -- per-replica circuit breaking ---------------------------------------
    def _breaker(self, host: str) -> CircuitBreaker:
        breaker = self._breakers.get(host)
        if breaker is None:
            breaker = self._breaker_factory(host)
            self._breakers[host] = breaker
        return breaker

    def _record_failure(self, host: str) -> None:
        breaker = self._breaker(host)
        breaker.record_failure()
        if breaker.state != "closed":
            self._ensure_reprobe(host)

    def _host_release(self, host: str) -> None:
        n = self._host_inflight.get(host, 0) - 1
        if n <= 0:
            self._host_inflight.pop(host, None)
        else:
            self._host_inflight[host] = n

    def _record_success(self, host: str) -> None:
        # Success == no failure history worth keeping (record_success
        # clears the rolling window anyway), so drop the entry: the
        # breaker map then holds ONLY hosts with in-window failures,
        # staying bounded under replica churn (a healthy replica that
        # scales away never leaves an entry behind).
        self._breakers.pop(host, None)

    def _ensure_reprobe(self, host: str) -> None:
        task = self._reprobes.get(host)
        if task is not None and not task.done():
            return
        self._reprobes[host] = asyncio.get_running_loop().create_task(
            self._reprobe(host))

    async def _reprobe(self, host: str) -> None:
        """Background recovery path for an open breaker: poll the
        replica's liveness route; the first success closes the breaker
        and rejoins the host to rotation.  Gives up once the replica
        is no longer registered anywhere (evicted / scaled away) —
        its breaker entry is dropped with it."""
        try:
            first = self._breakers.get(host)
            if first is None:
                return
            interval = max(0.05, first.reset_timeout_s / 2.0)
            while self._session is not None:
                await asyncio.sleep(interval)
                # get(), NOT _breaker(): an eviction pops the entry
                # mid-probe, and recreating it would leak a breaker
                # for a dead host:port forever.
                breaker = self._breakers.get(host)
                if breaker is None or breaker.state == "closed":
                    return
                orch = self.controller.reconciler.orchestrator
                known = any(r.host == host
                            for cid in getattr(orch, "state", {})
                            for r in orch.replicas(cid))
                if not known:
                    self._breakers.pop(host, None)
                    return
                if await self._probe_ok(host):
                    logger.info("replica %s answers liveness again; "
                                "closing its breaker", host)
                    breaker.record_success()
                    self._record_success(host)  # absence == closed
                    return
        finally:
            # Self-deregister so replica churn can't grow the task
            # map unboundedly (guard: a newer task may own the slot).
            if self._reprobes.get(host) is asyncio.current_task():
                self._reprobes.pop(host, None)

    async def _probe_ok(self, host: str) -> bool:
        """Strict positive probe for breaker recovery: only a prompt
        2xx-4xx answer counts.  Opposite polarity from
        `_replica_alive` — there a timeout means "busy, don't evict";
        here it means "still not answering, keep the breaker open"."""
        try:
            status, _, _ = await self._session.request(
                "GET", f"http://{host}/", timeout=2.0)
            return status < 500
        except Exception:
            return False

    # -- routing core ------------------------------------------------------
    def _lookup_service(self, name: str):
        """Resolve a request's model name to its InferenceService.  A
        name that is not an isvc may be a TrainedModel under a
        multi-model parent (the reference's TrainedModel URL shape,
        `<isvc-url>/v1/models/<tm>:predict`) — route to the parent's
        predictor fleet; the replica's repository serves the model by
        name.  Returns (isvc, affinity_key): the TRAINED-MODEL name is
        the affinity key, so the parent's fleet partitions the model
        set.  A direct isvc hit gets NO affinity key unless its
        predictor is multi-model: pinning a single-model service's
        whole traffic to one ring home would idle the rest of its
        replicas below the spill ceiling."""
        isvc = self.controller.get(name)
        if isvc is not None:
            multi = bool(getattr(
                getattr(isvc, "predictor", None), "multi_model",
                False))
            return isvc, (name if multi else None)
        tms = getattr(self.controller, "trained_models", None)
        if not tms:
            return None, None
        tm = tms.get(f"default/{name}")
        if tm is None:
            tm = next((t for t in tms.values() if t.name == name),
                      None)
        if tm is None:
            return None, None
        return self.controller.get(tm.inference_service,
                                   tm.namespace), name

    def _prefix_affinity_key(self, body) -> Optional[str]:
        """Chain digest of the request prompt's first N blocks — the
        affinity key for `KFS_ROUTER_AFFINITY=prefix`.  The prompt is
        normalized exactly the way the serving engine will see it
        (byte-tokenizer ids: BOS 256 + utf-8 bytes, int32
        little-endian), then chained with blake2b-16 per block of
        `affinity_prefix_block_tokens` tokens — the identical
        construction the engine's prefix index keys full prompt blocks
        by, so two requests hashing to the same key really do share
        cached KV on the replica the ring pins them to.  A prompt
        shorter than one full block digests whole (short prompts still
        pin consistently); an unparsable body returns None (the caller
        keeps whatever key `_lookup_service` produced)."""
        if not body:
            return None
        try:
            payload = json.loads(body)
        except Exception:
            return None
        inst: Any = payload
        if isinstance(payload, dict):
            insts = payload.get("instances")
            if isinstance(insts, list) and insts:
                inst = insts[0]
        if isinstance(inst, dict):
            inst = inst.get("prompt", inst.get("text_input"))
        if not isinstance(inst, str) or not inst:
            return None
        raw = b"".join(
            t.to_bytes(4, "little")
            for t in [256] + list(inst.encode("utf-8")))
        bs = 4 * max(1, self.affinity_prefix_block_tokens)
        full = min(len(raw) // bs, max(1, self.affinity_prefix_blocks))
        chain = b""
        for c in range(full):
            chain = hashlib.blake2b(chain + raw[c * bs:(c + 1) * bs],
                                    digest_size=16).digest()
        if not full:
            chain = hashlib.blake2b(raw, digest_size=16).digest()
        return chain.hex()

    def _entry_component(self, isvc, verb: str) -> str:
        if verb == "explain":
            if isvc.explainer is not None:
                return "explainer"
            return "predictor"
        if isvc.transformer is not None:
            return "transformer"
        return "predictor"

    def _pick_revision(self, cstatus) -> Optional[str]:
        targets = [t for t in cstatus.traffic if t.percent > 0]
        if not targets:
            return None
        roll = self._rng.uniform(0, 100)
        acc = 0.0
        for t in targets:
            acc += t.percent
            if roll <= acc:
                return t.revision
        return targets[-1].revision

    def _eligible(self, cid: str, revision: str, exclude=()):
        """Replicas that could serve (revision match, not excluded) —
        BEFORE breaker gating.  The single source of eligibility for
        both the picker and _resolve's circuit-open-vs-scale-from-zero
        distinction, so the two can never drift."""
        return [r for r in
                self.controller.reconciler.orchestrator.replicas(cid)
                if r.revision == revision and r.host not in exclude]

    def _ring(self, hosts: Tuple[str, ...]) -> List[Tuple[int, str]]:
        """Consistent-hash ring over a replica set (cached per set:
        replica churn builds a new ring, stable fleets reuse it)."""
        ring = self._ring_cache.get(hosts)
        if ring is None:
            ring = sorted(
                (int(hashlib.md5(f"{host}#{v}".encode())
                     .hexdigest()[:8], 16), host)
                for host in hosts
                for v in range(self.AFFINITY_VNODES))
            if len(self._ring_cache) >= 64:  # bounded under churn
                self._ring_cache.clear()
            self._ring_cache[hosts] = ring
        return ring

    def _affinity_pick(self, affinity_key: str, replicas, gate
                       ) -> Optional[str]:
        """Walk the ring clockwise from the model's hash point: the
        first position is the model's home replica; overload (host
        in-flight at the spill ceiling) or a breaker veto spills to
        the next DISTINCT host.  None = every host vetoed (caller
        falls back to round-robin)."""
        hosts = tuple(sorted(r.host for r in replicas))
        ring = self._ring(hosts)
        point = int(hashlib.md5(affinity_key.encode())
                    .hexdigest()[:8], 16)
        idx = bisect.bisect_left(ring, (point, ""))
        seen = set()
        for i in range(len(ring)):
            host = ring[(idx + i) % len(ring)][1]
            if host in seen:
                continue
            primary = not seen
            seen.add(host)
            if 0 < self.affinity_spill <= \
                    self._host_inflight.get(host, 0):
                continue
            breaker = gate(host)
            if breaker is not None and not breaker.allow():
                continue
            obs.router_affinity_total().labels(
                mode=self.affinity,
                outcome="ring" if primary else "spill").inc()
            return host
        return None

    def _pick_replica(self, cid: str, revision: str,
                      exclude=(), affinity_key: Optional[str] = None
                      ) -> Optional[str]:
        # A host whose breaker is open is skipped exactly like an
        # excluded one: traffic flows to the healthy replicas while
        # the background reprobe decides when the sick one returns.
        # Filtering reads `state` (pure); allow() — which consumes a
        # half-open trial slot — runs only on the replica round-robin
        # actually picks, so candidates that lose the pick never burn
        # their trial (matters for caller-supplied breaker factories
        # with half_open_max > 0).
        # .get(), never _breaker(): a host with no failure history has
        # no entry (== closed), and creating one per filtered host
        # would grow the map with every replica ever seen.
        def gate(host):
            return self._breakers.get(host)

        replicas = []
        for r in self._eligible(cid, revision, exclude):
            breaker = gate(r.host)
            if breaker is not None and breaker.state == "open":
                obs.router_rotation_skips_total().labels(
                    replica=r.host).inc()
                continue
            replicas.append(r)
        if not replicas:
            return None
        if affinity_key is not None and len(replicas) > 1:
            host = self._affinity_pick(affinity_key, replicas, gate)
            if host is not None:
                return host
            # Ring exhausted (every host overloaded or breaker-vetoed):
            # the round-robin escape hatch below still applies.
            obs.router_affinity_total().labels(
                mode=self.affinity, outcome="fallback").inc()
        for _ in range(len(replicas)):
            idx = self._rr.get(cid, 0)
            self._rr[cid] = idx + 1
            pick = replicas[idx % len(replicas)]
            breaker = gate(pick.host)
            if breaker is None or breaker.allow():
                return pick.host
        return None

    async def _replica_alive(self, host: str) -> bool:
        """Quick liveness probe (the server's `/` route) deciding
        whether a mid-request failure came from a dead process or a
        transient glitch on a live one.  Only a refused/unroutable
        connection means dead; a probe TIMEOUT is indeterminate (a
        tabular replica chewing a multi-second batch on its event loop
        can't answer) and must classify as alive — evicting a busy
        replica would duplicate its in-flight inference and destroy
        healthy capacity, the exact mistakes the timeout branch of
        _proxy refuses to make."""
        try:
            status, _, _ = await self._session.request(
                "GET", f"http://{host}/", timeout=2.0)
            return status < 500
        except TimeoutError:
            return True  # indeterminate: busy, not dead
        except OSError:
            return False
        except Exception:
            return True

    async def _mark_failed_and_evict(self, name: str, cname: str,
                                     host: str, failed: set,
                                     resolved=None) -> None:
        """Shared failure bookkeeping for the retry loop: exclude the
        host from further attempts and evict its replica.  Resolves
        through _lookup_service (or the caller's already-resolved
        pair): `name` may be a TrainedModel (the affinity path), and
        its crashed PARENT replica must be evicted and
        standby-promoted exactly like a direct isvc request would —
        otherwise the dead host stays the TM's ring home, eating a
        connect error per request until its breaker trips."""
        failed.add(host)
        isvc, _ = (resolved if resolved is not None
                   else self._lookup_service(name))
        if isvc is not None:
            cid = self.controller.reconciler.component_id(isvc, cname)
            await self._evict_replica(cid, host)

    async def _evict_replica(self, cid: str, host: str) -> None:
        """Drop a replica whose transport failed (crashed process) so
        rotation skips it.  Orchestrators with crash supervision
        (`report_crash`) promote the component's armed standby in the
        same tick; otherwise the reconciler/autoscaler recreates
        capacity on its next pass (the reference leans on kubelet
        restart + readiness for this, SURVEY.md §5.3)."""
        orch = self.controller.reconciler.orchestrator
        report = getattr(orch, "report_crash", None)
        for r in orch.replicas(cid):
            if r.host == host:
                try:
                    if report is not None:
                        await report(r)
                    else:
                        await orch.delete_replica(r)
                except Exception:
                    logger.exception("evicting dead replica %s failed",
                                     host)
                # The host is gone; its breaker (and any reprobe
                # chasing it) goes with it.
                self._breakers.pop(host, None)
                logger.warning("evicted dead replica %s of %s", host, cid)
                return

    async def _resolve(self, name: str, verb: str,
                       component: Optional[str] = None,
                       exclude=(), deadline: Optional[Deadline] = None,
                       resolved=None
                       ) -> Tuple[Optional[str], Optional[str],
                                  Optional[str], Optional[str]]:
        """Returns (host, component_name, revision, error).  `resolved`
        carries a (isvc, affinity_key) pair the caller already looked
        up — the dispatch loop resolves once per REQUEST, not once per
        failover attempt (the TrainedModel fallback scans the catalog
        for non-default namespaces)."""
        isvc, affinity_key = (resolved if resolved is not None
                              else self._lookup_service(name))
        if isvc is None:
            return None, None, None, \
                f"inference service {name} not found"
        cname = component or self._entry_component(isvc, verb)
        key = f"{isvc.namespace}/{isvc.name}"
        status = self.controller.reconciler.status.get(key)
        cstatus = status.components.get(cname) if status else None
        if cstatus is None:
            return None, cname, None, \
                f"component {cname} of {name} not reconciled"
        revision = self._pick_revision(cstatus)
        if revision is None:
            return None, cname, None, \
                f"no traffic targets for {name}/{cname}"
        cid = self.controller.reconciler.component_id(isvc, cname)
        if self.affinity not in ("model", "prefix") or verb == "health":
            affinity_key = None
        if affinity_key is not None and faults.configured(
                fault_sites.ROUTER_AFFINITY_PICK):
            try:
                await faults.inject(fault_sites.ROUTER_AFFINITY_PICK,
                                    key=f"{name} {cname}")
            except FaultInjected:
                # Chaos-proven escape hatch: a broken affinity pick
                # degrades to the blind round-robin spray, never to an
                # unroutable request.
                obs.router_affinity_total().labels(
                    mode=self.affinity, outcome="fallback").inc()
                affinity_key = None
        host = self._pick_replica(cid, revision, exclude=exclude,
                                  affinity_key=affinity_key)
        if host is None:
            # Distinguish "nothing registered" (scale-from-zero: spin
            # up and buffer) from "replicas exist but every breaker is
            # open / every host already failed" — activating there
            # would churn scale() and park each request for the full
            # buffer deadline, the exact error-storm amplification the
            # breaker exists to prevent.  Shed fast instead; the
            # reprobe (or the reconciler) restores capacity.
            if self._eligible(cid, revision, exclude):
                return None, cname, revision, (
                    f"no healthy replicas for {name}/{cname} "
                    f"(circuit open)")
            # Announced swap window: the orchestrator said this
            # component is mid drain->activate — hold (bounded queue)
            # rather than churning scale(); the successor it already
            # has in flight will appear.
            verdict, held_host = await self._hold_for_swap(
                cid, revision, exclude, deadline)
            if verdict == "host":
                host = held_host
            elif verdict == "shed":
                return None, cname, revision, (
                    f"no replicas for {name}/{cname} "
                    f"(swap-hold queue full)")
            else:
                host = await self._activate(isvc, cname, cid, revision,
                                            deadline=deadline)
            if host is None:
                return None, cname, revision, \
                    f"no replicas for {name}/{cname}"
        return host, cname, revision, None

    async def _hold_for_swap(self, cid: str, revision: str, exclude,
                             deadline: Optional[Deadline]
                             ) -> Tuple[str, Optional[str]]:
        """Hold a request across an announced swap window.  Returns
        ("host", h) when a replica (re)appeared inside the hold
        budget, ("shed", None) when the bounded queue is full, and
        ("pass", None) when no window is announced (or it closed
        without a replica — the activator path takes over)."""
        orch = self.controller.reconciler.orchestrator
        announced = getattr(orch, "swap_announced", None)
        if not announced or cid not in announced:
            return "pass", None
        loop = asyncio.get_running_loop()
        if loop.time() >= announced.get(cid, 0.0):
            return "pass", None
        held = self._swap_held.get(cid, 0)
        if held >= self.swap_hold_max:
            obs.router_swap_held_total().labels(outcome="shed").inc()
            return "shed", None
        budget_s = self.buffer_deadline_s
        if deadline is not None:
            budget_s = min(budget_s, max(0.0, deadline.remaining_s()))
        start = loop.time()
        until = start + budget_s
        self._swap_held[cid] = held + 1
        try:
            while loop.time() < until:
                host = self._pick_replica(cid, revision,
                                          exclude=exclude)
                if host is not None:
                    hold_ms = (loop.time() - start) * 1000.0
                    obs.router_swap_held_total().labels(
                        outcome="served").inc()
                    obs.router_swap_hold_ms().observe(hold_ms)
                    return "host", host
                if cid not in announced and \
                        not getattr(orch, "pending_creates",
                                    lambda c, r: 0)(cid, revision):
                    # Window closed with nothing in flight (failed
                    # swap, incumbent kept or reconciler's turn):
                    # stop holding, let the activator decide.
                    return "pass", None
                await asyncio.sleep(0.02)
            obs.router_swap_held_total().labels(
                outcome="expired").inc()
            return "pass", None
        finally:
            n = self._swap_held.get(cid, 1) - 1
            if n <= 0:
                self._swap_held.pop(cid, None)
            else:
                self._swap_held[cid] = n

    async def _activate(self, isvc, cname: str, cid: str,
                        revision: str,
                        deadline: Optional[Deadline] = None
                        ) -> Optional[str]:
        """Scale-from-zero: bring up one replica and wait (activator
        buffering).  The spawn runs as a BACKGROUND task: a cold load
        (artifact download + compile) can dwarf any request budget,
        and the buffering request must honor its deadline — bounded
        wait then 504 — never ride the spawn to completion.  The
        spawn itself keeps running past the shed, so the capacity
        still arrives for the client's retry."""
        logger.info("activating %s (scale from zero)", cid)
        scale_task = asyncio.get_running_loop().create_task(
            self.controller.reconciler.scale(isvc, cname, 1))
        # Activator buffering is bounded by BOTH the router's own
        # deadline and the request's remaining budget: parking a
        # 2s-budget request for a 60s scale-up serves nobody.
        budget_s = self.buffer_deadline_s
        if deadline is not None:
            budget_s = min(budget_s, max(0.0, deadline.remaining_s()))
        until = asyncio.get_running_loop().time() + budget_s
        try:
            while asyncio.get_running_loop().time() < until:
                host = self._pick_replica(cid, revision)
                if host is not None:
                    return host
                if scale_task is not None and scale_task.done() and \
                        scale_task.exception() is not None:
                    # A racing create (e.g. a recycle swap) may win
                    # the chip and fail this one — the poll still
                    # succeeds off the winner's replica.  But if
                    # nothing else is creating one, the failure is
                    # deterministic (bad spec, storage error): fail
                    # fast instead of hanging the client for the
                    # full poll.
                    logger.error("activation scale for %s failed",
                                 cid, exc_info=scale_task.exception())
                    pending = getattr(
                        self.controller.reconciler.orchestrator,
                        "pending_creates", lambda c, r: 0)
                    if pending(cid, revision) == 0 and \
                            self._pick_replica(cid, revision) is None:
                        return None
                    scale_task = None  # handled; keep polling
                await asyncio.sleep(0.05)
            return None
        finally:
            # EVERY exit (served off a racing create, budget shed,
            # fail-fast) leaves the spawn finishing in the
            # background for the next request; the callback keeps a
            # late failure from dying as an unretrieved task
            # exception.
            if scale_task is not None and not scale_task.done():
                scale_task.add_done_callback(
                    self._log_late_activation)

    @staticmethod
    def _log_late_activation(task: asyncio.Task) -> None:
        if task.cancelled():
            return
        exc = task.exception()
        if exc is not None:
            logger.warning("background activation scale failed: %s",
                           exc)

    # -- handlers ----------------------------------------------------------
    async def _predict(self, req: Request) -> Response:
        return await self._proxy(req, "predict")

    async def _explain(self, req: Request) -> Response:
        return await self._proxy(req, "explain")

    async def _generate(self, req: Request) -> Response:
        # stream_ok: the upstream may answer with an SSE body (the
        # dedicated /generate_stream route or the {"stream": true}
        # upgrade) — pass it through chunk-by-chunk, and drop the
        # total-duration timeout in favor of an inter-chunk one (a
        # legitimate generation can outlive any fixed total budget;
        # a hung replica stops producing chunks and still trips).
        return await self._proxy(req, "predict", component="predictor",
                                 stream_ok=True)

    async def _predict_direct(self, req: Request) -> Response:
        return await self._proxy(req, "predict", component="predictor",
                                 strip_prefix="/direct/predictor")

    async def _health(self, req: Request) -> Response:
        return await self._proxy(req, "health")

    # -- fleet telemetry ---------------------------------------------------
    def _replica_hosts(self):
        """Every replica host currently registered anywhere (the
        federation scrape set)."""
        orch = self.controller.reconciler.orchestrator
        hosts = []
        for cid in getattr(orch, "state", {}):
            for r in orch.replicas(cid):
                if r.host not in hosts:
                    hosts.append(r.host)
        return hosts

    def _refresh_own_series(self) -> None:
        """Mirror the router's live dict-based telemetry (kept as
        plain dicts — the autoscaler reads them directly) into the
        registry at scrape time."""
        for cid, v in self.inflight.items():
            obs.router_inflight().labels(component=cid).set(v)
        for cid, v in self.request_count.items():
            # Mirror, not increment: the dict is the source of truth
            # and the registry child just exposes its current total.
            obs.router_requests_total().labels(
                component=cid).value = float(v)

    async def _scrape(self, host: str, path: str,
                      accept: Optional[str] = None) -> Optional[str]:
        """One replica GET with a bounded timeout; None on any
        failure (a sick replica must not fail the fleet scrape)."""
        headers = {"accept": accept} if accept else None
        try:
            status, _, body = await self._session.request(
                "GET", f"http://{host}{path}", headers=headers,
                timeout=2.0)
            if status != 200:
                return None
            return body.decode("utf-8")
        except Exception:
            logger.debug("scrape of %s%s failed", host, path)
            return None

    async def _scrape_json_all(self, hosts, path: str):
        """Concurrent JSON scrape of `path` from every host: the
        shared fan-out of all federated debug/health views.  Yields
        (host, parsed body) pairs; unreachable hosts and non-JSON
        answers are skipped (a sick replica must not fail the fleet
        view), and N sick replicas cost ONE scrape timeout, not N."""
        if self._session is None or not hosts:
            return []
        texts = await asyncio.gather(
            *[self._scrape(host, path) for host in hosts])
        out = []
        for host, text in zip(hosts, texts):
            if text is None:
                continue
            try:
                out.append((host, json.loads(text)))
            except ValueError:
                continue
        return out

    async def _metrics(self, req: Request) -> Response:
        self._refresh_own_series()
        want_om = "application/openmetrics-text" in \
            req.headers.get("accept", "")
        lines = REGISTRY.render_lines(exemplars=want_om)
        if req.query.get("federate", "1") != "0" \
                and self._session is not None:
            hosts = self._replica_hosts()
            # Concurrent scrapes: N sick replicas must cost ONE
            # 2s timeout, not N sequential ones (a hung fleet is
            # exactly when the scrape must still answer fast).
            texts = await asyncio.gather(
                *[self._scrape(host, "/metrics",
                               accept="application/openmetrics-text")
                  for host in hosts])
            # Family-grouped merge: each metric declared once, all of
            # its samples (own + per-replica) contiguous — strict
            # parsers reject re-declared or scattered families.
            lines = merge_scrapes(
                lines,
                [(host, text) for host, text in zip(hosts, texts)
                 if text is not None],
                keep_exemplars=want_om)
        body = "\n".join(lines) + "\n"
        if want_om:
            body += "# EOF\n"
            ctype = ("application/openmetrics-text; version=1.0.0; "
                     "charset=utf-8")
        else:
            ctype = "text/plain; version=0.0.4"
        return Response(body.encode(),
                        headers={"content-type": ctype})

    async def _debug_traces(self, req: Request) -> Response:
        trace_id = req.query.get("trace_id")
        try:
            limit = int(req.query.get("limit", "100"))
        except ValueError:
            return Response(b'{"error": "limit must be an integer"}',
                            status=400)
        only = req.query.get("replica")
        # Dedup key: in-process deployments share ONE tracer between
        # router and replicas, so the router's local read and the
        # federation scrape return the same spans — merge them by
        # identity (replica-labeled copy wins, except router-minted
        # spans keep their router attribution).
        merged: Dict[tuple, dict] = {}

        def add(span: dict, source: str):
            key = (span.get("trace_id"), span.get("name"),
                   span.get("start"), span.get("duration_ms"))
            if key in merged and span.get("name", "").startswith(
                    "router."):
                return
            merged[key] = dict(span, replica=source)

        if only is None or only == "router":
            for s in tracer.spans(trace_id, limit):
                add(s, "router")
        qs = f"?limit={limit}"
        if trace_id:
            qs += f"&trace_id={trace_id}"
        if only == "router":
            hosts = []
        elif only is not None:
            hosts = [only]
        else:
            hosts = self._replica_hosts()
        for host, body in await self._scrape_json_all(
                hosts, f"/debug/traces{qs}"):
            for s in body.get("spans", []):
                add(s, host)
        return Response(json.dumps(
            {"spans": list(merged.values())}).encode())

    async def _slo_health(self, req: Request) -> Response:
        """Fleet SLO view: every replica's /v2/health/slo merged under
        its host, plus the union of alerting (replica, model) pairs —
        one scrape answers "is anything burning budget anywhere"."""
        qs = "?refresh=1" if req.query.get("refresh") == "1" else ""
        replicas: Dict[str, dict] = {}
        alerting = []
        for host, body in await self._scrape_json_all(
                self._replica_hosts(), f"/v2/health/slo{qs}"):
            replicas[host] = body
            for model in body.get("alerting", []):
                alerting.append({"replica": host, "model": model})
        return Response(json.dumps({
            "healthy": not alerting,
            "alerting": alerting,
            "replicas": replicas,
        }).encode())

    async def _rollouts(self, req: Request) -> Response:
        """Progressive-delivery status: the rollout manager's active
        and recent records (with pinned rollback evidence) plus the
        reconciler's quarantine ledger.  Answers even when no manager
        is wired (quarantine still reported) — observability must not
        depend on the optional control loop."""
        manager = getattr(self.controller, "rollout_manager", None)
        if manager is not None:
            body = manager.report()
        else:
            body = {"active": [], "history": [],
                    "quarantine":
                        self.controller.reconciler.quarantine_report()}
        return Response(json.dumps(body).encode())

    async def _debug_profile(self, req: Request) -> Response:
        """Fleet device-time profile: per-replica engine timelines as
        one merged Chrome trace (each replica re-pid'd into its own
        Perfetto process group), or per-replica raw event lists under
        ?format=events."""
        from kfserving_tpu_torch.observability.profiling import merge_traces

        window = req.query.get("window_s")
        try:
            float(window) if window else None
        except ValueError:
            return Response(
                b'{"error": "window_s must be a number"}', status=400)
        fmt = req.query.get("format", "trace_json")
        if fmt not in ("trace_json", "events"):
            return Response(
                b'{"error": "format must be trace_json or events"}',
                status=400)
        only = req.query.get("replica")
        hosts = [only] if only else self._replica_hosts()
        qs = f"?format={fmt}"
        if window:
            qs += f"&window_s={window}"
        scraped = await self._scrape_json_all(hosts,
                                              f"/debug/profile{qs}")
        if fmt == "events":
            return Response(json.dumps({
                "replicas": {host: body for host, body in scraped},
            }).encode())
        return Response(json.dumps(merge_traces(
            [(host, body) for host, body in scraped])).encode())

    async def _debug_cache(self, req: Request) -> Response:
        """Federated cache view: each replica's /debug/cache body
        under its `replica` host key, plus a fleet rollup (index
        entries, hit totals) so one scrape answers "where are the warm
        prefixes".  ?replica= narrows to one host; ?top_k= passes
        through to the replicas' hot-chain census."""
        only = req.query.get("replica")
        top_k = req.query.get("top_k")
        top_cost = req.query.get("top_cost")
        for raw in (top_k, top_cost):
            if raw is not None:
                try:
                    int(raw)
                except ValueError:
                    return Response(
                        b'{"error": "top_k and top_cost must be '
                        b'integers"}', status=400)
        hosts = [only] if only else self._replica_hosts()
        params = []
        if top_k:
            params.append(f"top_k={top_k}")
        if top_cost:
            params.append(f"top_cost={top_cost}")
        qs = ("?" + "&".join(params)) if params else ""
        replicas: Dict[str, dict] = {}
        totals = {"index_entries": 0, "prefix_hits": 0,
                  "prefix_misses": 0, "prefill_tokens_saved": 0,
                  "host_tier_blocks": 0, "host_tier_spills": 0,
                  "host_tier_faulted_blocks": 0,
                  "host_tier_tokens_saved": 0}
        for host, body in await self._scrape_json_all(
                hosts, f"/debug/cache{qs}"):
            replicas[host] = body
            for snap in (body.get("models") or {}).values():
                if not snap.get("paged"):
                    continue
                totals["index_entries"] += snap.get("index_entries", 0)
                pool = snap.get("pool") or {}
                totals["prefix_hits"] += pool.get("prefix_hits", 0)
                totals["prefix_misses"] += pool.get(
                    "prefix_misses", 0)
                totals["prefill_tokens_saved"] += pool.get(
                    "prefill_tokens_saved", 0)
                totals["host_tier_tokens_saved"] += pool.get(
                    "host_tier_tokens_saved", 0)
            # Host KV tiers: where evicted conversation
            # state is parked, fleet-wide.
            for tier in (body.get("host_tier") or {}).values():
                totals["host_tier_blocks"] += tier.get(
                    "used_blocks", 0)
                totals["host_tier_spills"] += tier.get("spills", 0)
                totals["host_tier_faulted_blocks"] += tier.get(
                    "faulted_blocks", 0)
        return Response(json.dumps({
            "replicas": replicas,
            "fleet": totals,
        }).encode())

    async def _debug_history(self, req: Request) -> Response:
        """Federated telemetry history: each replica's /debug/history
        frames under its `replica` host key, plus a fleet rollup per
        (series, labels) merged by grid timestamp — rates (counter
        deltas/s) SUM across replicas, every other kind (gauges,
        quantiles, ratios) means.  The scrape pins `step_s` (default
        1 s) so every replica resamples onto the same absolute epoch
        grid; ?series=/?labels=/?window_s= pass through, ?replica=
        narrows to one host."""
        from urllib.parse import quote

        only = req.query.get("replica")
        step = req.query.get("step_s") or "1"
        window = req.query.get("window_s")
        try:
            float(step)
            if window is not None:
                float(window)
        except ValueError:
            return Response(
                b'{"error": "window_s and step_s must be numbers"}',
                status=400)
        qs = f"?step_s={quote(step)}"
        for param in ("series", "labels"):
            value = req.query.get(param)
            if value:
                qs += f"&{param}={quote(value)}"
        if window:
            qs += f"&window_s={quote(window)}"
        hosts = [only] if only else self._replica_hosts()
        replicas: Dict[str, dict] = {}
        merged: Dict[tuple, dict] = {}
        for host, body in await self._scrape_json_all(
                hosts, f"/debug/history{qs}"):
            replicas[host] = body
            for s in body.get("series") or []:
                key = (s.get("name"),
                       tuple(sorted((s.get("labels") or {}).items())))
                agg = merged.setdefault(key, {
                    "name": s.get("name"),
                    "labels": s.get("labels") or {},
                    "kind": s.get("kind"),
                    "step_s": s.get("step_s"),
                    "buckets": {}})
                for frame in s.get("frames") or []:
                    ts, value = frame[0], frame[1]
                    slot = agg["buckets"].setdefault(ts, [0.0, 0])
                    slot[0] += value
                    slot[1] += 1
        fleet = []
        for agg in merged.values():
            # A per-replica rate sums to the fleet rate; a mean of
            # gauges/quantiles/ratios is the only rollup that does
            # not invent load that never existed.
            summing = agg["kind"] == "rate"
            frames = [[ts, (acc if summing else acc / n)]
                      for ts, (acc, n) in
                      sorted(agg["buckets"].items())]
            fleet.append({"name": agg["name"],
                          "labels": agg["labels"],
                          "kind": agg["kind"],
                          "step_s": agg["step_s"],
                          "frames": frames})
        fleet.sort(key=lambda d: (d["name"],
                                  sorted(d["labels"].items())))
        return Response(json.dumps({
            "replicas": replicas,
            "fleet": fleet,
        }).encode())

    async def _debug_flightrecorder(self, req: Request) -> Response:
        """Federated flight-recorder dump: each replica's entries and
        pinned entries, tagged with the serving replica."""
        try:
            limit = int(req.query.get("limit", "100"))
        except ValueError:
            return Response(b'{"error": "limit must be an integer"}',
                            status=400)
        only = req.query.get("replica")
        hosts = [only] if only else self._replica_hosts()
        pinned_only = req.query.get("pinned", "0") == "1"
        qs = f"?limit={limit}"
        if pinned_only:
            qs += "&pinned=1"
        # Pin-stream filters pass through to every replica
        # AND apply to the supervisor's own recorder below.
        pin_type = req.query.get("pin_type") or None
        since_raw = req.query.get("since_ts")
        try:
            since_ts = float(since_raw) if since_raw else None
        except ValueError:
            return Response(
                b'{"error": "since_ts must be a number"}', status=400)
        if pin_type:
            from urllib.parse import quote
            qs += f"&pin_type={quote(pin_type)}"
        if since_ts is not None:
            qs += f"&since_ts={since_ts}"
        entries: list = []
        pinned: list = []
        # The supervisor's own recorder (failover/swap-failure
        # timelines pinned by the orchestrator's crash supervision)
        # federates as replica="supervisor" — the decision trail of a
        # promotion must be visible in the same place as the request
        # evidence, and it survives the dead replica whose ring died
        # with it.
        if only is None or only == "supervisor":
            recorder = getattr(
                self.controller.reconciler.orchestrator,
                "flight_recorder", None)
            if recorder is not None:
                body = recorder.dump(limit=limit,
                                     pinned_only=pinned_only,
                                     pin_type=pin_type,
                                     since_ts=since_ts)
                entries += [dict(e, replica="supervisor")
                            for e in body.get("entries", [])]
                pinned += [dict(e, replica="supervisor")
                           for e in body.get("pinned", [])]
        if only == "supervisor":
            hosts = []
        for host, body in await self._scrape_json_all(
                hosts, f"/debug/flightrecorder{qs}"):
            entries += [dict(e, replica=host)
                        for e in body.get("entries", [])]
            pinned += [dict(e, replica=host)
                       for e in body.get("pinned", [])]
        return Response(json.dumps(
            {"entries": entries, "pinned": pinned}).encode())

    def _router_admission_state(self) -> Dict[str, Any]:
        """The router's own admission evidence for incident views:
        brownout levels, in-flight gauges, breaker states — the
        vantage point no replica bundle can see."""
        state: Dict[str, Any] = {
            "brownout_levels": (self.brownout.report()
                                if self.brownout is not None else {}),
            "inflight": dict(self.inflight),
            "requests": dict(self.request_count),
            "offered": dict(self.offered_count),
        }
        state["breakers"] = {host: breaker.state
                             for host, breaker
                             in self._breakers.items()}
        return state

    async def _debug_incidents(self, req: Request) -> Response:
        """Federated incident view.  `?id=` pulls one full
        record from whichever replica owns it (404 when none does);
        the bare list returns every replica's summaries under its
        host key plus a FLEET rollup deduplicated by (root cause,
        model) — the same regression diagnosed on N replicas merges
        into one fleet incident listing the replicas it hit — and the
        router's own admission/brownout state.  ?replica= narrows,
        ?state=/?limit= pass through."""
        from urllib.parse import quote

        only = req.query.get("replica")
        hosts = [only] if only else self._replica_hosts()
        incident_id = req.query.get("id")
        if incident_id:
            qs = f"?id={quote(incident_id)}"
            for host, body in await self._scrape_json_all(
                    hosts, f"/debug/incidents{qs}"):
                if body.get("id"):
                    return Response(json.dumps(
                        dict(body, replica=host)).encode())
            return Response(
                json.dumps({"error":
                            f"unknown incident {incident_id}"}
                           ).encode(), status=404)
        try:
            limit = int(req.query.get("limit", "50"))
        except ValueError:
            return Response(b'{"error": "limit must be an integer"}',
                            status=400)
        state = req.query.get("state")
        qs = f"?limit={limit}"
        if state:
            qs += f"&state={quote(state)}"
        replicas: Dict[str, dict] = {}
        merged: Dict[tuple, dict] = {}
        for host, body in await self._scrape_json_all(
                hosts, f"/debug/incidents{qs}"):
            replicas[host] = body
            for inc in body.get("incidents") or []:
                key = (inc.get("root_cause"), inc.get("model"))
                fleet_inc = merged.setdefault(key, {
                    "root_cause": inc.get("root_cause"),
                    "model": inc.get("model"),
                    "replicas": [],
                    "incident_ids": [],
                    "count": 0,
                    "open": False,
                    "first_opened_ts": inc.get("opened_ts"),
                    "last_updated_ts": inc.get("updated_ts"),
                    "top_hypothesis": inc.get("top_hypothesis"),
                })
                fleet_inc["count"] += 1
                if host not in fleet_inc["replicas"]:
                    fleet_inc["replicas"].append(host)
                fleet_inc["incident_ids"].append(
                    {"replica": host, "id": inc.get("id")})
                if inc.get("state") == "open":
                    fleet_inc["open"] = True
                opened = inc.get("opened_ts")
                if opened is not None and (
                        fleet_inc["first_opened_ts"] is None
                        or opened < fleet_inc["first_opened_ts"]):
                    fleet_inc["first_opened_ts"] = opened
                updated = inc.get("updated_ts")
                if updated is not None and (
                        fleet_inc["last_updated_ts"] is None
                        or updated > fleet_inc["last_updated_ts"]):
                    fleet_inc["last_updated_ts"] = updated
                    fleet_inc["top_hypothesis"] = \
                        inc.get("top_hypothesis")
        fleet = sorted(
            merged.values(),
            key=lambda f: (not f["open"],
                           -(f["last_updated_ts"] or 0.0)))
        return Response(json.dumps({
            "replicas": replicas,
            "fleet": fleet,
            "open": sum(1 for f in fleet if f["open"]),
            "router": self._router_admission_state(),
        }).encode())

    # Transport-level failover attempts per request: a crashed replica is
    # evicted and the request retries the next one (the reference leans
    # on kubelet restart + readiness gates; a single-host fabric must
    # handle the dead-process window itself).
    MAX_UPSTREAM_ATTEMPTS = 3

    @staticmethod
    def _observe_attempt(name: str, revision: Optional[str],
                         status: int, started: float) -> None:
        """Per-revision request accounting, recorded PER ATTEMPT: a
        canary whose dispatches fail is charged those failures even
        when failover lands the request on the stable revision —
        otherwise an error-storming canary whose traffic always fails
        over would show a spotless per-revision series and never trip
        a rollout gate.  `name` is the OWNING isvc, not the requested
        TrainedModel: revisions belong to the service, and rollout
        cleanup prunes these series by isvc name."""
        if revision is None:
            return
        elapsed_ms = (time.perf_counter() - started) * 1000.0
        obs.revision_requests_total().labels(
            model=name, revision=revision, status=str(status)).inc()
        obs.revision_request_ms().labels(
            model=name, revision=revision).observe(elapsed_ms)

    def _stream_through(self, upstream, gauge_cid: str,
                        name: Optional[str] = None,
                        cname: Optional[str] = None,
                        host: Optional[str] = None) -> Response:
        """Chunk-by-chunk SSE pass-through: no body buffering (the
        server's own transport backpressure applies per chunk), the
        in-flight gauge held for the stream's whole life, and a
        mid-stream upstream death (replica crash, recycle past its
        drain budget) surfaces as a terminal SSE event — never a
        silently dead socket.  The router cannot transparently resume
        a broken generation (the decode state died with the replica,
        and re-running it silently would duplicate tokens already
        delivered) — so when the upstream process is DEAD it emits an
        EXPLICIT retriable failover signal (`finish_reason:
        "failover", retriable: true`), evicts the corpse so the
        client's retry lands on the promoted standby, and leaves
        non-fatal glitches on a live replica as the non-retriable
        error they always were."""
        async def chunks():
            try:
                async for chunk in upstream.iter_chunks(
                        read_timeout=self.upstream_timeout_s):
                    yield chunk
            except (asyncio.TimeoutError, OSError) as e:
                logger.warning("stream from upstream interrupted: %s",
                               e)
                dead = (host is not None
                        and not await self._replica_alive(host))
                if dead:
                    # The serving process is gone mid-generation:
                    # evict it (promoting its standby on supervised
                    # orchestrators) and tell the client — explicitly
                    # — that a retry is safe and capacity is coming.
                    obs.router_stream_failover_total().labels(
                        model=name or "").inc()
                    self._record_failure(host)
                    if name is not None and cname is not None:
                        asyncio.ensure_future(
                            self._mark_failed_and_evict(
                                name, cname, host, set()))
                    # The leading blank line terminates any partial
                    # SSE line the upstream death left dangling, so
                    # the event always parses as its own event.  The
                    # predecessor identity is the KV fetch hint
                    #: the client's retry forwards it
                    # (x-kfs-kv-peer, which the proxy retry path also
                    # injects itself) so the successor can pull the
                    # dead conversation's spilled KV from a surviving
                    # peer before re-prefilling.
                    event = json.dumps({
                        "error": ("replica failed mid-stream; "
                                  "standby promotion in progress"),
                        "finish_reason": "failover",
                        "retriable": True,
                        "retry_after_ms": 250,
                        "predecessor": host,
                    })
                    yield b"\n\ndata: " + \
                        event.encode("utf-8") + b"\n\n"
                    return
                yield (b'\n\ndata: {"error": "upstream stream '
                       b'interrupted", "finish_reason": "error"}\n\n')

        def on_close():
            self.inflight[gauge_cid] -= 1
            if host is not None:
                self._host_release(host)
            upstream.close()

        # Same response-header policy as the buffered path: trace-id
        # correlation must survive on the flagship streaming verb.
        headers = {
            k: v for k, v in upstream.headers.items()
            if k.lower() in ("content-type",
                             "inference-header-content-length",
                             REQUEST_ID_HEADER)
            or k.lower().startswith("ce-")}
        return StreamingResponse(GuardedStream(chunks(), on_close),
                                 status=upstream.status,
                                 headers=headers)

    async def _brownout_gate(self, name: str, req: Request,
                             deadline: Optional[Deadline]
                             ) -> Optional[Response]:
        """Admission verdict for one request: None = admitted, else
        the shed Response.  The `router.admission` fault site sits
        here so chaos runs can wedge/fail the admission path itself
        (an injected error sheds exactly like a brownout verdict —
        explicit and retriable)."""
        tier = priority_tier(req.headers.get(PRIORITY_HEADER))
        if faults.configured(fault_sites.ROUTER_ADMISSION):
            try:
                await faults.inject(fault_sites.ROUTER_ADMISSION,
                                    key=f"{name} priority:{tier}")
            except FaultInjected:
                obs.brownout_shed_total().labels(
                    model=name, reason="fault").inc()
                return self._brownout_shed(name, "fault")
        if self.brownout is None:
            return None
        remaining = (deadline.remaining_s()
                     if deadline is not None else None)
        admitted, reason = self.brownout.admit(name, tier, remaining)
        if admitted:
            return None
        return self._brownout_shed(name, reason)

    def _brownout_shed(self, name: str, reason: str) -> Response:
        """The explicit retriable shed: clients must be able to tell
        load management from failure, machine-readably — `retriable`
        in the body, `Retry-After` in the headers."""
        level = self.brownout.level(name) if self.brownout else 0
        retry_after = max(1, int(round(
            getattr(self.brownout, "retry_after_s", 1.0) or 1.0)))
        body = json.dumps({
            "error": f"brownout: request shed ({reason})",
            "retriable": True,
            "reason": reason,
            "brownout_level": level,
        }).encode()
        return Response(body=body, status=503,
                        headers={"retry-after": str(retry_after)})

    async def _proxy(self, req: Request, verb: str,
                     component: Optional[str] = None,
                     strip_prefix: str = "",
                     stream_ok: bool = False) -> Response:
        """Telemetry envelope around the proxy core: joins/mints the
        W3C trace context at ingress, records a router span + latency
        histogram (exemplared with the trace id), counts sheds, and
        emits one JSON access-log line per request."""
        name = req.path_params["name"]
        ctx = ensure_trace_context(req.headers, mint="w3c")
        info: Dict[str, Optional[str]] = {}
        start = time.perf_counter()
        with tracer.span("router.proxy", model=name, verb=verb) as sp:
            resp = await self._proxy_inner(req, verb, ctx, info,
                                           component, strip_prefix,
                                           stream_ok)
            sp["status"] = resp.status
            if info.get("upstream"):
                sp["upstream"] = info["upstream"]
        latency_ms = (time.perf_counter() - start) * 1000.0
        obs.router_request_ms().labels(verb=verb).observe(
            latency_ms, trace_id=ctx.trace_id)
        if resp.status in (502, 503, 504):
            obs.router_shed_total().labels(
                status=str(resp.status)).inc()
        log_access("router", trace_id=ctx.trace_id, model=name,
                   verb=verb, status=resp.status,
                   latency_ms=round(latency_ms, 3),
                   upstream=info.get("upstream"))
        # Echo the trace id even on router-local answers (404/503
        # sheds never reach a replica's echo path).
        resp.headers.setdefault(REQUEST_ID_HEADER, ctx.trace_id)
        # Revision attribution: which side of a canary split answered.
        if info.get("revision"):
            resp.headers.setdefault(REVISION_HEADER, info["revision"])
        return resp

    async def _proxy_inner(self, req: Request, verb: str,
                           ctx: TraceContext,
                           info: Dict[str, Optional[str]],
                           component: Optional[str] = None,
                           strip_prefix: str = "",
                           stream_ok: bool = False) -> Response:
        name = req.path_params["name"]
        path = req.path
        if strip_prefix and path.startswith(strip_prefix):
            path = path[len(strip_prefix):]
        # The body is forwarded whole with its own Content-Length, so
        # the client's framing headers stay behind.
        headers = {k: v for k, v in req.headers.items()
                   if k.lower() not in ("host", "content-length",
                                        "connection",
                                        "transfer-encoding")}
        # Forward the trace context so router, replica, and engine
        # spans all share one trace id: a W3C-shaped id rides
        # `traceparent` (with this hop's span id as the parent); any
        # client-supplied x-request-id passes through untouched, and a
        # router-minted id fills it for legacy correlation.
        forward = ctx.forward_traceparent()
        if forward is not None:
            headers[TRACEPARENT_HEADER] = forward
        headers.setdefault(REQUEST_ID_HEADER, ctx.trace_id)
        # The client's budget governs the router's OWN waiting
        # (activator buffering, failover attempts), and the replica
        # receives the REMAINING budget, not the original — time spent
        # buffered at the router must not be granted twice.
        deadline = Deadline.from_headers(headers)

        # Brownout admission: while the predictive loop
        # has a model browned out, the lowest-priority tiers — and
        # any request whose remaining budget provably cannot cover
        # the observed service time — shed HERE with an explicit
        # retriable 503 + Retry-After, before occupying an upstream
        # slot.  Health probes are never shed: readiness gating must
        # keep seeing the truth during an overload.
        # Traffic is BOOKED under the owning isvc, not the requested
        # model name: a TrainedModel request (affinity path) must feed
        # the same router/{isvc}/{component} series the autoscaler and
        # predictive loop read — per-TM keys would leave a busy
        # multi-model fleet looking idle (and scaled to zero).
        resolved = self._lookup_service(name)
        # Prefix-affinity key: computed HERE — the one
        # place the request body is in hand — and threaded through
        # `resolved` so the per-attempt _resolve loop never re-parses
        # the payload.  A body with no extractable prompt keeps the
        # model-name key _lookup_service produced (multi-model
        # partitioning remains the backstop).
        if self.affinity == "prefix" and verb != "health":
            pkey = self._prefix_affinity_key(req.body)
            if pkey is not None:
                resolved = (resolved[0], pkey)
        svc = resolved[0]
        svc_name = svc.name if svc is not None else name
        if verb != "health":
            if svc is not None:
                entry = component or self._entry_component(svc, verb)
                offered_key = f"router/{svc_name}/{entry}"
                self.offered_count[offered_key] = \
                    self.offered_count.get(offered_key, 0) + 1
            # The brownout gate is keyed by the OWNING isvc too: the
            # predictive loop sets levels per service (off the
            # router/{svc}/... series above), so a TrainedModel
            # request must be shed under its parent's level.
            shed = await self._brownout_gate(svc_name, req, deadline)
            if shed is not None:
                return shed

        failed: set = set()
        gauge_cid = None
        try:
            for attempt in range(self.MAX_UPSTREAM_ATTEMPTS):
                if deadline is not None and deadline.expired:
                    return Response(
                        body=b'{"error": "request deadline exceeded '
                             b'(router)"}',
                        status=504)
                host, cname, revision, err = await self._resolve(
                    name, verb, component, exclude=failed,
                    deadline=deadline, resolved=resolved)
                info["revision"] = revision
                if err is not None:
                    # Unknown service/component is a true 404; replica
                    # exhaustion (e.g. after evicting a crashed one) is
                    # transient unavailability and must stay 503 so
                    # clients keep retrying.
                    status = (503 if err.startswith(("no replicas",
                                                     "no healthy",
                                                     "no traffic"))
                              else 404)
                    if status == 503 and deadline is not None \
                            and deadline.expired:
                        # The budget died while we buffered/failed
                        # over: every other expiry path answers 504,
                        # and telling the client to retry a request
                        # whose budget is spent helps nobody.
                        return Response(
                            body=b'{"error": "request deadline '
                                 b'exceeded (router buffering)"}',
                            status=504)
                    # json.dumps, not f-string interpolation: err embeds
                    # the client-supplied model name (may contain quotes).
                    resp_headers = {}
                    if status == 503:
                        # Buffer-deadline shed: tell retrying clients
                        # when capacity is likely back (a swap window).
                        resp_headers["retry-after"] = "1"
                    return Response(
                        body=json.dumps({"error": err}).encode(),
                        status=status, headers=resp_headers)
                if gauge_cid is None:
                    # Per-component gauge: the autoscaler must see
                    # transformer and predictor traffic separately.
                    gauge_cid = f"router/{svc_name}/{cname}"
                    self.inflight[gauge_cid] = \
                        self.inflight.get(gauge_cid, 0) + 1
                    self.request_count[gauge_cid] = \
                        self.request_count.get(gauge_cid, 0) + 1
                url = f"http://{host}{path}"
                info["upstream"] = host
                attempt_started = time.perf_counter()
                loop = asyncio.get_running_loop()
                # Per-host in-flight count: the affinity ring's
                # overload signal (spill past a loaded home replica).
                self._host_inflight[host] = \
                    self._host_inflight.get(host, 0) + 1
                held_host: Optional[str] = host
                try:
                    # Chaos hook: an injected error exercises the same
                    # pre-dispatch failover path a refused connection
                    # would (FaultInjected is handled with
                    # ConnectError below), and an injected hang sits
                    # under the SAME timeout envelope a hung replica
                    # would — wait_for turns hang_s into the
                    # TimeoutError branch (breaker food).  The
                    # configured() guard keeps the no-faults hot path
                    # at one dict lookup (no Task/timer allocation).
                    # The fault key carries the serving revision
                    # (`revision:<hash>`), so `match=` selectors can
                    # scope chaos to one side of a canary split — the
                    # hardware-free way to drive the rollout manager's
                    # rollback path.
                    if faults.configured(fault_sites.ROUTER_DISPATCH):
                        await asyncio.wait_for(
                            faults.inject(
                                fault_sites.ROUTER_DISPATCH,
                                key=f"{url} revision:{revision}"),
                            timeout=self.upstream_timeout_s)
                    # Forwarded budget computed AFTER the fault sleep:
                    # injected (or real) pre-dispatch latency must
                    # come out of the replica's remaining budget, or
                    # that time is granted twice.
                    if deadline is not None:
                        headers[TIMEOUT_HEADER] = str(max(
                            1, int(deadline.remaining_s() * 1000)))
                    # The response head, and a buffered body, are bounded
                    # in total; a stream's body only per read (a
                    # legitimate generation can outlive any fixed total
                    # budget).
                    until = loop.time() + self.upstream_timeout_s
                    upstream = await self._session.open(
                        req.method, url, body=req.body or b"",
                        headers=headers, timeout=self.upstream_timeout_s)
                    # Any completed HTTP exchange means the transport
                    # to this replica works (the status is the app's
                    # verdict, not the wire's).
                    self._record_success(host)
                    if stream_ok and upstream.headers.get(
                            "content-type", "").startswith(
                                "text/event-stream"):
                        self._observe_attempt(svc_name, revision,
                                              upstream.status,
                                              attempt_started)
                        resp = self._stream_through(upstream,
                                                    gauge_cid,
                                                    name=name,
                                                    cname=cname,
                                                    host=host)
                        # Gauge AND host-inflight slot now owned by
                        # the stream's close hook.
                        gauge_cid = None
                        held_host = None
                        return resp
                    try:
                        if stream_ok:
                            body = b"".join([
                                chunk async for chunk in
                                upstream.iter_chunks(
                                    read_timeout=self.upstream_timeout_s)])
                        else:
                            body = await asyncio.wait_for(
                                upstream.read(),
                                max(0.0, until - loop.time()))
                        # Observed AFTER the body read: a replica that
                        # crashes mid-response raises into the
                        # mid-request branch below, and one physical
                        # attempt must land exactly ONE sample in the
                        # per-revision series the rollout gates on.
                        self._observe_attempt(svc_name, revision,
                                              upstream.status,
                                              attempt_started)
                        resp_headers = {
                            k: v for k, v in upstream.headers.items()
                            if k.lower() in (
                                "content-type",
                                "inference-header-content-length",
                                REQUEST_ID_HEADER)
                            or k.lower().startswith("ce-")}
                        return Response(body=body,
                                        status=upstream.status,
                                        headers=resp_headers)
                    finally:
                        upstream.close()
                except asyncio.TimeoutError:
                    # A slow-but-alive replica (heavy batch, warmup
                    # compile): do NOT evict (it would kill in-flight
                    # work) and do NOT retry (the request may still
                    # execute — a retry would duplicate inference).
                    # The breaker DOES count it: enough consecutive
                    # hangs open it, rotation skips the replica, and
                    # the health reprobe decides when it returns —
                    # degradation to the healthy replicas instead of
                    # feeding every request into a 60s timeout.
                    logger.warning("proxy to %s timed out", url)
                    self._record_failure(host)
                    self._observe_attempt(svc_name, revision, 504,
                                          attempt_started)
                    return Response(
                        body=b'{"error": "upstream timeout"}',
                        status=504)
                except (ConnectError, FaultInjected) as e:
                    # PRE-dispatch connection failure (refused / no
                    # route): the request never reached the replica, so
                    # a retry cannot duplicate inference — evict and
                    # fail over.  HTTP-level errors returned above are
                    # never retried.
                    logger.warning("proxy to %s failed (attempt %d): %s",
                                   url, attempt + 1, e)
                    self._record_failure(host)
                    self._observe_attempt(svc_name, revision, 503,
                                          attempt_started)
                    await self._mark_failed_and_evict(
                        name, cname, host, failed,
                        resolved=resolved)
                    # Failover fetch hint: the retry attempt names the
                    # evicted predecessor so the successor can pull
                    # this session's KV (peer transfer) before it
                    # re-prefills from scratch.  Last eviction wins —
                    # that replica's tier holds the freshest chains.
                    headers["x-kfs-kv-peer"] = f"http://{host}"
                except OSError as e:
                    # Mid-request/-response failure (reset after
                    # dispatch, truncated read).  Disambiguate with a
                    # liveness probe: a replica that just DIED (crash /
                    # SIGKILL lands here as ECONNRESET when the kill
                    # races an in-flight connect) cannot have returned a
                    # response, so evicting and retrying is safe — the
                    # kubelet-restart role this fabric owns (SURVEY
                    # §5.3).  A replica that still answers its liveness
                    # route had a genuine mid-request glitch: neither
                    # retry (would duplicate inference) nor evict.
                    #
                    # Known window: if the replica executed the request
                    # and crashed while writing the response, the retry
                    # below re-runs the inference — side-effect sinks
                    # (payload-logger mirrors, drift/outlier detector
                    # counters) may observe the request twice.  This is
                    # the availability-over-exactly-once trade the
                    # reference's activator also makes; consumers that
                    # need dedup should key on the logger's request id.
                    logger.warning("proxy to %s failed mid-request: %s",
                                   url, e)
                    self._record_failure(host)
                    self._observe_attempt(svc_name, revision, 502,
                                          attempt_started)
                    if await self._replica_alive(host):
                        return Response(
                            body=b'{"error": "upstream connection '
                                 b'failed"}',
                            status=502)
                    logger.warning(
                        "replica %s dead after mid-request failure: "
                        "evicting and retrying", host)
                    await self._mark_failed_and_evict(
                        name, cname, host, failed,
                        resolved=resolved)
                    # Same fetch hint as the pre-dispatch branch: the
                    # retry carries the dead replica's address for the
                    # successor's peer KV pull.
                    headers["x-kfs-kv-peer"] = f"http://{host}"
                finally:
                    if held_host is not None:
                        self._host_release(held_host)
            return Response(
                body=b'{"error": "upstream unavailable"}', status=503)
        finally:
            # A streaming pass-through transfers gauge ownership to
            # the stream's close hook (the request is still in flight
            # when _proxy returns).
            if gauge_cid is not None:
                self.inflight[gauge_cid] -= 1
