"""SubprocessOrchestrator: replicas are real OS processes.

The reference's replicas are pods created by Knative from the ksvc the
reconciler writes (reference ksvc_reconciler.go:153-187); the
single-host equivalent is one process per replica, exec'd from the
per-framework entrypoint module registered in the cluster config
(`python -m kfserving_tpu_torch.predictors.<fw> --model_name ...
--model_dir ... --http_port ... --device cuda` — the same arg convention
the reference's predictor specs build, predictor_sklearn.go:77-96, plus
the device every in-tree replica serves on).

Readiness mirrors the pod readiness probe: the replica joins the
router's rotation only after its health route answers.  Deletion is
SIGTERM (the server's signal handler drains in-flight work) escalating
to SIGKILL.

Device note: every replica process opens its own CUDA context on the
card, so an incumbent and its standby can hold weights side by side
(the warm-standby and overlap swaps rely on it).  `exclusive_device`
keeps the drain-then-activate order for transports that admit one
resident process.  A replica asked for `cuda` on a machine without a
card fails at load, and its create fails with it: there is no CPU
fallback.
"""

import asyncio
import json
import logging
import os
import socket
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from kfserving_tpu_torch.control.clusterconfig import ClusterConfig
from kfserving_tpu_torch.control.orchestrator import Replica, _ComponentState
from kfserving_tpu_torch.observability import metrics as obs
from kfserving_tpu_torch.server.client import HTTPClient

logger = logging.getLogger("kfserving_tpu_torch.control.subprocess")

READY_TIMEOUT_S = 120.0
TERM_GRACE_S = 10.0


def _free_port(host: str = "127.0.0.1") -> int:
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


@dataclass
class RecyclePolicy:
    """Replica process recycling: a replica that crosses a request or
    memory threshold is replaced, as kubelet restarts a container that
    crosses its memory limit (SURVEY.md §5.3 delegation, built natively
    here).

    A replica crossing either threshold is drain-replaced; the old
    process gets SIGTERM (the server's handler drains in-flight
    work).  The router's readiness gating, scale-from-zero buffering,
    and announced-swap holds carry traffic across the swap.

    Standby-capable replicas (jax/generative, KFS_STANDBY honored)
    ALWAYS recycle through the warm-standby lifecycle — TensorFlow-
    Serving's aspired-versions discipline (arxiv 1712.06139): the
    successor loads FULLY warm (standby spawn -> /standby/activate,
    params mapped from the mmap cache, compile-cache-hot warmup)
    while the incumbent still serves, and only then does the incumbent
    drain.  An activation failure keeps the incumbent serving and
    tears the broken standby down (counted in
    kfserving_tpu_lifecycle_swap_failures_total) — a swap can only
    make things better.  The same armed standbys back crash
    promotion: a replica that dies (process exit, or
    health_fail_threshold consecutive probe failures, or a router
    crash report) is replaced by activating its standby within one
    supervisor tick.

    exclusive_device=True is for deployments where the transport
    admits ONE resident process (real TPU pods, where libtpu locks
    the chip): there the standby cannot touch the device until the
    incumbent exits, so the order is drain -> activate and the
    orchestrator ANNOUNCES the swap window (swap_announced) so the
    router holds requests in a bounded queue instead of shedding
    503s across it.

    Standby-incapable frameworks (sklearn/xgb/custom) keep the older
    paths: overlap=True (default) fully loads a successor before the
    drain; overlap=False is the cold drain-then-respawn.
    """

    max_requests: Optional[int] = None
    max_rss_mb: Optional[float] = None
    check_interval_s: float = 5.0
    overlap: bool = True
    # Exclusive-device transport: standby activation must wait for the
    # incumbent's exit (drain -> activate, announced swap window).
    exclusive_device: bool = False
    # Keep one armed standby (spawned, imports + artifact done, device
    # untouched) per component: recycles skip the spawn phase and
    # crash promotion has a warm successor ready.
    standby_pool: bool = True
    # Crash supervision: dead processes (and replicas failing this
    # many consecutive health probes — 0 disables probing) are
    # replaced by standby promotion in the same watchdog tick.
    crash_supervision: bool = True
    health_fail_threshold: int = 3
    # Router hold budget announced for an exclusive-device swap (the
    # drain -> activate gap it must bridge).
    announce_budget_s: float = 30.0
    # Successor grace: a replica younger than this is never recycled.
    # Without it, a threshold at/below a fresh process's baseline RSS
    # (easy with JAX loaded) would kill/spawn in an unbounded loop with
    # a zero-replica gap per cycle on chip owners.
    min_age_s: float = 30.0
    # Overlapped successors load at this nice level and are restored to
    # 0 once serving.  On a small host the successor's XLA
    # compile/deserialize otherwise starves the OLD replica's event
    # loop for the whole load — measured soak p99 went 0.7s -> 27s from
    # CPU contention alone, with zero unavailability.
    successor_nice: int = 15


def _proc_rss_mb(pid: int) -> Optional[float]:
    """Resident set size of a pid in MB (Linux /proc, no psutil)."""
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) / 1024.0
    except OSError:
        return None
    return None


@dataclass
class _Proc:
    process: asyncio.subprocess.Process
    port: int
    spec: object = None
    spawned_at: float = 0.0


class SubprocessOrchestrator:
    """Actuation backend that execs one server process per replica."""

    def __init__(self, cluster_config: Optional[ClusterConfig] = None,
                 env_overrides: Optional[Dict[str, str]] = None,
                 host: str = "127.0.0.1",
                 credentials=None,
                 recycle: Optional[RecyclePolicy] = None,
                 device: str = "cuda"):
        self.cluster_config = cluster_config or ClusterConfig()
        # The device every in-tree replica serves on (`--device`).
        self.device = device
        self.env_overrides = env_overrides or {}
        self.host = host
        # CredentialStore: per-service-account env injected into replica
        # processes (the reference injects credentials into the containers).
        self.credentials = credentials
        self.recycle = recycle
        self.recycle_count = 0
        # Chip-release -> successor-serving gap of each swap (the
        # soak's swap_window_s stat; warm-standby swaps record 0.0 —
        # the successor was serving before the incumbent left).
        self.swap_windows_s: List[float] = []
        self.standby_swaps = 0
        self.swap_failures = 0
        self.promotions = 0
        # Per-swap phase timing: {"mode", "standby_spawn_s",
        # "activate_s", "drain_s", ...} — which part to attack next.
        self.swap_breakdown: List[Dict[str, float]] = []
        # Announced swap windows: component_id -> loop-time deadline.
        # The router holds (bounded queue, never 503) requests for a
        # component inside its announced drain->activate window.
        self.swap_announced: Dict[str, float] = {}
        # Armed standbys ((cid, revision) -> [Replica, ...]): spawned
        # with KFS_STANDBY (imports + artifact done, device
        # untouched), promoted on recycle or crash, and adopted
        # directly by scale-ups (reconciler._scale_revisions prefers
        # an armed standby over a cold spawn).  Pool depth per
        # component is self._standby_targets (default 1: one warm
        # successor for a recycle or a crash); the predictive
        # autoscaler pre-arms it deeper ahead of a predicted capacity
        # gap, so a traffic step actuates as activations.
        self._standbys: Dict[tuple, List[Replica]] = {}
        self._standby_spawning: Dict[tuple, int] = {}
        self._standby_targets: Dict[str, int] = {}
        self._health_fails: Dict[int, int] = {}
        # Supervisor flight recorder: failover and swap-failure
        # timelines pinned in the control-plane process (the router
        # federates it under replica="supervisor").
        from kfserving_tpu_torch.observability.monitoring import (
            FlightRecorder,
        )

        self.flight_recorder = FlightRecorder.from_env()
        self._watchdog: Optional[asyncio.Task] = None
        # Background spawns, promotions and terminations (see
        # _background).
        self._tasks: set = set()
        self._recycling: set = set()  # replica ids being swapped
        # (cid, revision) -> count of creates past spawn but not yet
        # ready.  replicas() lists only ready processes, so without this
        # the reconciler's scale-up and the recycler would both spawn
        # during a swap window — fatal for chip-owning replicas (one
        # process per TPU).
        self._creating: Dict[tuple, int] = {}
        self.state: Dict[str, _ComponentState] = {}
        # Cluster-local gateway address, published by the ingress router
        # at start (router.py start_async); replicas get it as
        # KFS_CLUSTER_LOCAL_URL.
        self.cluster_local_url: Optional[str] = None

    def pending_creates(self, component_id: str, revision: str) -> int:
        return self._creating.get((component_id, revision), 0)

    def replicas(self, component_id: str) -> List[Replica]:
        return list(self.state.get(component_id,
                                   _ComponentState()).replicas)

    # -- spec -> argv -------------------------------------------------------
    def _command(self, component_id: str, spec, port: int) -> List[str]:
        from kfserving_tpu_torch.control.spec import (
            ExplainerSpec,
            PredictorSpec,
            TransformerSpec,
        )

        isvc_name = component_id.split("/")[1]
        if isinstance(spec, (TransformerSpec, ExplainerSpec)) and \
                getattr(spec, "command", None):
            return list(spec.command) + ["--http_port", str(port)]
        if isinstance(spec, ExplainerSpec):
            # In-tree explainer types run via the standalone explainer
            # server (the reference's per-explainer binaries,
            # alibiexplainer/__main__.py); predictor_host arrives via
            # the injected KFS_CLUSTER_LOCAL_URL.  Unknown types must
            # fail HERE with a clear error — the child's stderr goes to
            # DEVNULL, so an argparse rejection would surface only as
            # an opaque readiness failure.
            from kfserving_tpu_torch.explainers import (
                ARTIFACT_REQUIRED_TYPES,
                EXPLAINER_TYPES,
            )

            if spec.explainer_type not in EXPLAINER_TYPES:
                raise ValueError(
                    f"explainer_type {spec.explainer_type!r} needs an "
                    f"explicit command under the subprocess "
                    f"orchestrator (in-tree: {list(EXPLAINER_TYPES)})")
            if spec.explainer_type in ARTIFACT_REQUIRED_TYPES and \
                    not spec.storage_uri:
                # Without the artifact dir the child dies in
                # Storage.download with stderr discarded.
                raise ValueError(
                    f"{spec.explainer_type} explainer needs a "
                    f"storage_uri")
            argv = [sys.executable, "-m", "kfserving_tpu_torch.explainers",
                    "--model_name", isvc_name,
                    "--explainer_type", spec.explainer_type,
                    "--http_port", str(port),
                    "--device", self.device]
            if spec.storage_uri:
                argv += ["--storage_uri", spec.storage_uri]
            if spec.container_concurrency:
                argv += ["--container_concurrency",
                         str(spec.container_concurrency)]
            return argv
        if isinstance(spec, PredictorSpec):
            if spec.framework == "custom":
                if not spec.command:
                    raise ValueError(
                        "custom predictor needs an explicit command")
                return list(spec.command) + ["--http_port", str(port)]
            from kfserving_tpu_torch.control.spec import (
                EXTERNAL_RUNTIME_FRAMEWORKS,
            )

            if spec.framework in EXTERNAL_RUNTIME_FRAMEWORKS:
                return self._external_command(component_id, spec, port)
            runtime = self.cluster_config.runtime_for(spec.framework)
            argv = [sys.executable, "-m", runtime["module"],
                    "--model_name", isvc_name,
                    "--model_dir", spec.storage_uri,
                    "--http_port", str(port),
                    "--device", self.device]
            if spec.container_concurrency:
                argv += ["--container_concurrency",
                         str(spec.container_concurrency)]
            if spec.batcher is not None:
                argv += ["--max_batch_size",
                         str(spec.batcher.max_batch_size),
                         "--max_latency_ms",
                         str(spec.batcher.max_latency_ms)]
            if spec.multi_model:
                argv += ["--multi_model"]
            return argv
        raise ValueError(
            f"subprocess orchestrator cannot run component spec "
            f"{type(spec).__name__} without an explicit command")

    def _external_command(self, component_id: str, spec,
                          port: int) -> List[str]:
        """argv for an external server runtime, per that runtime's own
        CLI convention — the reference builds the same argument lists
        into its container specs (predictor_tfserving.go:84-90,
        predictor_triton.go:59-67, predictor_onnxruntime.go:67-72).
        The binary comes from the cluster config's `command` entry
        (spec.command overrides it, e.g. a site wrapper script)."""
        isvc_name = component_id.split("/")[1]
        runtime = self.cluster_config.runtime_for(spec.framework)
        base = list(spec.command or runtime.get("command") or ())
        if not base:
            raise ValueError(
                f"framework {spec.framework!r} needs a configured "
                f"external server command (cluster config predictors."
                f"{spec.framework}.command)")
        if not spec.storage_uri:
            raise ValueError(
                f"{spec.framework} predictor needs a storage_uri")
        model_dir = spec.storage_uri
        for prefix in ("file://",):
            if model_dir.startswith(prefix):
                model_dir = model_dir[len(prefix):]
        style = runtime.get("argStyle", spec.framework)
        if style == "tfserving":
            return base + [
                f"--rest_api_port={port}",
                f"--model_name={isvc_name}",
                f"--model_base_path={model_dir}",
            ]
        if style == "triton":
            return base + [
                f"--model-store={model_dir}",
                f"--http-port={port}",
                "--allow-http=true",
            ]
        if style == "onnx":
            return base + [
                f"--model_path={model_dir}",
                f"--http_port={port}",
            ]
        raise ValueError(f"unknown external argStyle {style!r}")

    # -- lifecycle ----------------------------------------------------------
    def _standby_capable(self, spec) -> bool:
        """Standby fast-swap needs the runtime to honor KFS_STANDBY
        (deferred device-touching load behind POST /standby/activate) —
        the chip-owning in-tree servers do."""
        from kfserving_tpu_torch.control.spec import PredictorSpec

        return (isinstance(spec, PredictorSpec)
                and spec.framework in ("jax", "generative")
                and not getattr(spec, "multi_model", False))

    async def create_replica(self, component_id: str, revision: str,
                             spec, placement=None,
                             standby: bool = False,
                             nice: int = 0,
                             minimal_warmup: bool = False) -> Replica:
        port = _free_port(self.host)
        argv = self._command(component_id, spec, port)
        env = dict(os.environ)
        if standby:
            env["KFS_STANDBY"] = "1"
        if minimal_warmup or standby:
            # Recycle successors (and standby activations, whose
            # warmup sits inside the exclusive-device swap gap) warm
            # only the largest bucket: the predecessor populated the
            # persistent compile cache, so the rest load on demand —
            # the full grid was the dominant term of successor load
            # time.
            env["KFS_MINIMAL_WARMUP"] = "1"
        else:
            # A cold first replica (empty persistent cache) must do
            # the full grid; never inherit a stray flag from the
            # orchestrator's own environment.
            env.pop("KFS_MINIMAL_WARMUP", None)
        # The package must be importable from the child even when not
        # pip-installed.
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = (
            repo_root + os.pathsep + env.get("PYTHONPATH", "")).rstrip(
                os.pathsep)
        if self.credentials is not None:
            env.update(self.credentials.build_env(
                getattr(spec, "service_account_name", "default")))
        if placement is not None:
            # Slice discovery env — the TPU analogue of the reference's
            # injected nodeSelector (accelerator_injector.go:38-44).
            env.update(placement.env())
        if self.cluster_local_url:
            # Custom explainer/transformer commands reach the predictor
            # through the gateway's direct lane (the reference injects
            # --predictor_host into those containers).
            env["KFS_CLUSTER_LOCAL_URL"] = self.cluster_local_url
        env.update(self.env_overrides)
        logger.info("spawning replica %s rev=%s%s: %s",
                    component_id, revision[:8],
                    " (standby)" if standby else "", " ".join(argv))
        key = (component_id, revision)
        # Standby spawns do NOT reserve a create: they are not serving
        # capacity (the reconciler must still scale the component up
        # while a pool standby arms).  The swap/promotion paths that
        # consume a standby hold their own reservation.
        if not standby:
            self._creating[key] = self._creating.get(key, 0) + 1
        try:
            preexec = None
            if nice > 0:
                def preexec(n=nice):  # runs in the child pre-exec
                    os.nice(n)
            process = await asyncio.create_subprocess_exec(
                *argv, env=env,
                stdout=asyncio.subprocess.DEVNULL,
                stderr=asyncio.subprocess.DEVNULL,
                preexec_fn=preexec)
            host = f"{self.host}:{port}"
            try:
                await self._wait_ready(process, host)
            except BaseException:
                # A cancelled spawn (shutdown during a standby's boot)
                # must not leave the process running either.
                await asyncio.shield(self._terminate(process))
                raise
        finally:
            if not standby:
                n = self._creating.get(key, 1) - 1
                if n <= 0:
                    self._creating.pop(key, None)
                else:
                    self._creating[key] = n
        replica = Replica(component_id, revision, host,
                          handle=_Proc(
                              process, port, spec=spec,
                              spawned_at=asyncio.get_running_loop().time()),
                          placement=placement)
        if standby:
            # Not serving yet: joins `state` (and the router's
            # rotation) only after _activate_standby succeeds.
            return replica
        self.state.setdefault(component_id,
                              _ComponentState()).replicas.append(replica)
        if self.recycle is not None and self._watchdog is None:
            self._watchdog = asyncio.ensure_future(self._watchdog_loop())
        return replica

    # -- announced swap windows --------------------------------------------
    def announce_swap(self, component_id: str, expected_s: float) -> None:
        """Publish a drain->activate window: the router holds (bounded
        queue) requests for this component until the window closes or a
        replica reappears, instead of shedding 503s across the swap."""
        self.swap_announced[component_id] = \
            asyncio.get_running_loop().time() + expected_s

    def clear_swap(self, component_id: str) -> None:
        self.swap_announced.pop(component_id, None)

    async def _activate_standby(self, replica: Replica) -> None:
        """Flip a standby successor live: POST its activation route (the
        deferred device-touching load runs there), then enter it into
        the serving state."""
        from kfserving_tpu_torch.reliability import fault_sites, faults

        # Chaos hook: an injected error/hang here drives the
        # activation-failure path (incumbent kept, standby reaped)
        # without breaking a real process.
        await faults.inject(
            fault_sites.ORCHESTRATOR_STANDBY_ACTIVATE,
            key=f"{replica.host} {replica.component_id} "
                f"revision:{replica.revision}")
        url = f"http://{replica.host}/standby/activate"
        status, _, body = await HTTPClient(keepalive=False).request(
            "POST", url, timeout=READY_TIMEOUT_S)
        if status != 200:
            raise RuntimeError(
                f"standby activation at {replica.host} failed "
                f"({status}): {body[:500].decode('utf-8', 'replace')}")
        # The min_age_s successor grace measures time SERVING, not time
        # armed: a standby that sat in the pool for minutes must not be
        # instantly re-recycled by a threshold at/below its baseline
        # (the thrash loop min_age_s exists to prevent).
        if replica.handle is not None:
            replica.handle.spawned_at = \
                asyncio.get_running_loop().time()
        self.state.setdefault(replica.component_id,
                              _ComponentState()).replicas.append(replica)
        if self.recycle is not None and self._watchdog is None:
            self._watchdog = asyncio.ensure_future(self._watchdog_loop())

    async def _wait_ready(self, process, host: str) -> None:
        """Poll the liveness route until it answers (readiness probe)."""
        deadline = asyncio.get_running_loop().time() + READY_TIMEOUT_S
        url = f"http://{host}/"
        client = HTTPClient(timeout=2.0, keepalive=False)
        while True:
            if process.returncode is not None:
                raise RuntimeError(
                    f"replica process exited rc={process.returncode} "
                    f"before becoming ready")
            try:
                status, _, _ = await client.request("GET", url)
                if status == 200:
                    return
            except Exception:
                pass
            if asyncio.get_running_loop().time() > deadline:
                raise TimeoutError(
                    f"replica at {host} not ready after "
                    f"{READY_TIMEOUT_S}s")
            await asyncio.sleep(0.1)

    # -- recycling ----------------------------------------------------------
    async def _startup_phases(self, host: str) -> Dict[str, float]:
        try:
            status, _, body = await HTTPClient(keepalive=False).request(
                "GET", f"http://{host}/startup_phases", timeout=2.0)
            if status == 200:
                return json.loads(body)
        except Exception:
            logger.debug("startup phases scrape of %s failed", host)
        return {}

    async def _request_count(self, host: str) -> Optional[float]:
        """Best-effort scrape of the replica's request counter (the
        server's Prometheus text endpoint)."""
        try:
            status, _, body = await HTTPClient(keepalive=False).request(
                "GET", f"http://{host}/metrics", timeout=2.0)
            if status != 200:
                return None
            text = body.decode("utf-8")
        except Exception:
            return None
        from kfserving_tpu_torch.observability.metrics import (
            REQUEST_TOTAL_SERIES,
        )

        total = 0.0
        for line in text.splitlines():
            if line.startswith(REQUEST_TOTAL_SERIES + "{"):
                try:
                    total += float(line.rsplit(" ", 1)[1])
                except (IndexError, ValueError):
                    pass
        return total

    def _over_threshold(self, handle: _Proc) -> Optional[str]:
        pol = self.recycle
        if pol.max_rss_mb is not None and handle.process.pid:
            rss = _proc_rss_mb(handle.process.pid)
            if rss is not None and rss > pol.max_rss_mb:
                return f"rss {rss:.0f}MB > {pol.max_rss_mb:.0f}MB"
        return None

    async def _watchdog_loop(self):
        while True:
            await asyncio.sleep(self.recycle.check_interval_s)
            try:
                await self._watchdog_tick()
            except asyncio.CancelledError:
                raise
            except Exception:
                # The watchdog must NEVER die silently: a single bad
                # tick (transient scrape error, racing delete) skips,
                # the next interval retries.
                logger.exception("recycle watchdog tick failed")

    async def _watchdog_tick(self):
            # Crash supervision FIRST: a dead replica's standby is
            # promoted in this same tick, before pool maintenance or
            # threshold recycling reason about capacity.
            if self.recycle.crash_supervision:
                await self._supervise_crashes()
            for cid, comp in list(self.state.items()):
                for replica in list(comp.replicas):
                    if id(replica) in self._recycling:
                        continue
                    handle: _Proc = replica.handle
                    if handle is None or \
                            handle.process.returncode is not None:
                        continue
                    age = asyncio.get_running_loop().time() \
                        - handle.spawned_at
                    if age < self.recycle.min_age_s:
                        continue  # successor grace: no thrash loop
                    # kfslint: disable=async-blocking — /proc reads
                    # are RAM-backed (never disk), microseconds per
                    # replica.
                    reason = self._over_threshold(handle)
                    if reason is None and \
                            self.recycle.max_requests is not None:
                        n = await self._request_count(replica.host)
                        if n is not None and \
                                n >= self.recycle.max_requests:
                            reason = (f"served {n:.0f} >= "
                                      f"{self.recycle.max_requests} "
                                      "requests")
                    if reason is not None:
                        self._recycling.add(id(replica))
                        try:
                            await self._recycle_replica(replica, reason)
                        except Exception:
                            logger.exception(
                                "recycle of %s failed", replica.host)
                        finally:
                            self._recycling.discard(id(replica))
            self._reap_orphan_standbys()
            if self.recycle.standby_pool:
                self._maintain_standby_pool()

    async def _recycle_replica(self, replica: Replica, reason: str):
        """Drain-then-replace, by lifecycle mode.  Standby-capable
        replicas take the warm-standby path (activate BEFORE drain —
        or after, announced, on exclusive-device transports); CPU
        frameworks keep the overlapped/cold successor paths."""
        logger.warning("recycling replica %s at %s: %s",
                       replica.component_id, replica.host, reason)
        handle: _Proc = replica.handle
        # Hold a create reservation across the WHOLE swap: in any
        # drain window (SIGTERM grace, up to TERM_GRACE_S) the replica
        # is already out of state and the successor not yet entered,
        # so without this the reconciler/autoscaler sees have < want
        # and spawns its own replacement while the old process still
        # owns the chip.
        key = (replica.component_id, replica.revision)
        self._creating[key] = self._creating.get(key, 0) + 1
        try:
            if self._standby_capable(handle.spec):
                if self.recycle.exclusive_device:
                    ok = await self._exclusive_standby_swap(replica)
                else:
                    ok = await self._warm_standby_swap(replica)
                if not ok:
                    return  # incumbent kept serving; not a recycle
            elif self.recycle.overlap:
                await self._overlap_swap(replica)
            else:
                await self._cold_swap(replica)
        finally:
            n = self._creating.get(key, 1) - 1
            if n <= 0:
                self._creating.pop(key, None)
            else:
                self._creating[key] = n
        self.recycle_count += 1

    def _pop_standby(self, key: tuple) -> Optional[Replica]:
        """Pop one LIVE armed standby for (cid, revision); pool
        corpses are discarded on the way (the next maintenance tick
        re-arms)."""
        pool = self._standbys.get(key)
        popped = None
        while pool:
            candidate = pool.pop(0)
            if candidate.handle.process.returncode is None:
                popped = candidate
                break
            logger.warning("pooled standby for %s died (rc=%s); "
                           "discarded", key[0],
                           candidate.handle.process.returncode)
        if not pool:
            self._standbys.pop(key, None)
        self._set_pool_gauge(key[0])
        return popped

    # -- predictive pre-arming (control/predictive.py) ----------------------
    def set_standby_target(self, component_id: str, target: int) -> None:
        """Size the armed-standby pool for a component: the feed-
        forward autoscaler pre-arms `target` standbys ahead of a
        predicted capacity gap so scale-up actuates as one-tick
        activations.  1 is the lifecycle default (crash failover
        always wants a warm successor); the cap keeps a runaway
        prediction from forking the host to death."""
        target = max(1, min(int(target), 8))
        if self._standby_targets.get(component_id, 1) != target:
            logger.info("standby pool target for %s -> %d",
                        component_id, target)
        self._standby_targets[component_id] = target

    def standby_target(self, component_id: str) -> int:
        return self._standby_targets.get(component_id, 1)

    def standby_count(self, component_id: str) -> int:
        """Live armed standbys for a component (the capacity the
        predictive loop can actuate without a spawn)."""
        return sum(
            1 for (cid, _rev), pool in self._standbys.items()
            if cid == component_id
            for r in pool if r.handle.process.returncode is None)

    async def adopt_standby(self, component_id: str,
                            revision: str) -> Optional[Replica]:
        """Scale-up fast path: activate an armed standby into serving
        instead of cold-spawning.  Returns the serving replica, or
        None when no live standby exists (or activation failed — the
        caller falls back to create_replica)."""
        standby = self._pop_standby((component_id, revision))
        if standby is None:
            return None
        key = (component_id, revision)
        # Reservation across the activation: replicas() lists only
        # serving processes, so without it a concurrent reconcile
        # would double-spawn while this standby activates.
        self._creating[key] = self._creating.get(key, 0) + 1
        try:
            await asyncio.wait_for(self._activate_standby(standby),
                                   READY_TIMEOUT_S)
        except asyncio.CancelledError:
            await asyncio.shield(
                self._terminate(standby.handle.process))
            raise
        except Exception:
            logger.exception("standby adoption for %s failed; caller "
                             "falls back to cold spawn", component_id)
            await asyncio.shield(
                self._terminate(standby.handle.process))
            return None
        finally:
            n = self._creating.get(key, 1) - 1
            if n <= 0:
                self._creating.pop(key, None)
            else:
                self._creating[key] = n
        obs.lifecycle_promotions_total().labels(
            trigger="scale_up", outcome="promoted").inc()
        logger.info("scale-up adopted armed standby %s for %s",
                    standby.host, component_id)
        return standby

    async def _obtain_standby(self, cid: str, revision: str, spec,
                              placement) -> Tuple[Replica, float]:
        """An armed standby for (cid, revision): a pooled one when it
        is still alive (spawn cost already paid outside the swap), else
        a fresh spawn.  Returns (standby, spawn_seconds)."""
        loop = asyncio.get_running_loop()
        pooled = self._pop_standby((cid, revision))
        if pooled is not None:
            return pooled, 0.0
        t0 = loop.time()
        standby = await self.create_replica(cid, revision, spec,
                                            placement=placement,
                                            standby=True)
        return standby, loop.time() - t0

    async def _warm_standby_swap(self, replica: Replica) -> bool:
        """The default lifecycle (TF-Serving aspired-versions order):
        the successor activates — device load off the mmap param
        cache, cache-hot warmup — while the incumbent still serves,
        and the incumbent drains only once the successor is IN the
        rotation.  Swap window: 0 by construction.  Returns False when
        activation failed (incumbent kept serving)."""
        loop = asyncio.get_running_loop()
        cid, rev = replica.component_id, replica.revision
        standby, spawn_s = await self._obtain_standby(
            cid, rev, replica.handle.spec, replica.placement)
        t0 = loop.time()
        try:
            await asyncio.wait_for(self._activate_standby(standby),
                                   READY_TIMEOUT_S)
        except asyncio.CancelledError:
            # Shutdown cancelling the watchdog mid-activate: the
            # standby is outside self.state and already popped from
            # the pool — reap it here or it orphans as a live process.
            await asyncio.shield(
                self._terminate(standby.handle.process))
            raise
        except Exception as e:
            await asyncio.shield(
                self._terminate(standby.handle.process))
            self._swap_failed(replica, standby, e,
                              mode="warm_standby")
            return False
        activate_s = loop.time() - t0
        t1 = loop.time()
        await self.delete_replica(replica)
        drain_s = loop.time() - t1
        # Incumbent gone (drain exported its live KV, exit released
        # its manifest flock): the successor adopts the generation so
        # returning conversations fault back instead of re-prefilling.
        await self._kv_reattach(standby.host)
        # The successor was serving before the incumbent left
        # rotation — no unavailability window.
        self.swap_windows_s.append(0.0)
        self.swap_breakdown.append({
            "mode": "warm_standby",
            "standby_spawn_s": round(spawn_s, 2),
            "activate_s": round(activate_s, 2),
            "drain_s": round(drain_s, 2),
            "successor_phases": await self._startup_phases(
                standby.host),
        })
        self.standby_swaps += 1
        self._observe_swap("warm_standby", "ok",
                           standby_spawn=spawn_s,
                           activate=activate_s, drain=drain_s)
        logger.info("warm standby swap of %s: activate %.2fs "
                    "(spawn %.2fs) drain %.2fs, window 0", cid,
                    activate_s, spawn_s, drain_s)
        return True

    async def _exclusive_standby_swap(self, replica: Replica) -> bool:
        """Exclusive-device order: the incumbent must release the chip
        before the standby can touch it — drain, then activate, inside
        an ANNOUNCED window the router bridges by holding requests."""
        loop = asyncio.get_running_loop()
        cid, rev = replica.component_id, replica.revision
        standby, spawn_s = await self._obtain_standby(
            cid, rev, replica.handle.spec, replica.placement)
        activated = False
        self.announce_swap(cid, self.recycle.announce_budget_s)
        try:
            t0 = loop.time()
            await self.delete_replica(replica)
            t_drained = loop.time()
            try:
                await asyncio.wait_for(
                    self._activate_standby(standby), READY_TIMEOUT_S)
                activated = True
            except Exception as e:
                # Successor unusable AND the incumbent is already
                # gone: cold respawn so the component is not left at
                # zero replicas.
                self._swap_failed(replica, standby, e,
                                  mode="exclusive_standby")
                logger.exception(
                    "standby activation failed; cold respawn")
                await self.create_replica(
                    cid, rev, replica.handle.spec,
                    placement=replica.placement)
        finally:
            self.clear_swap(cid)
            # A standby successor lives OUTSIDE self.state until
            # activation: any exit without activation (failure,
            # shutdown cancelling this task) must reap it here or it
            # orphans — on an exclusive-device pod an orphan holds
            # the chip forever.
            if not activated:
                await asyncio.shield(
                    self._terminate(standby.handle.process))
        window = loop.time() - t0
        if activated:
            # Outside the announced window (it just cleared): adopt
            # the drained incumbent's KV generation best-effort.
            await self._kv_reattach(standby.host)
        self.swap_windows_s.append(round(window, 3))
        self.swap_breakdown.append({
            "mode": "exclusive_standby",
            "standby_spawn_s": round(spawn_s, 2),
            "drain_s": round(t_drained - t0, 2),
            "activate_s": round(loop.time() - t_drained, 2),
        })
        self.standby_swaps += 1
        if activated:
            # The failure branch was already counted by _swap_failed.
            self._observe_swap("exclusive_standby", "ok",
                               standby_spawn=spawn_s,
                               drain=t_drained - t0,
                               activate=loop.time() - t_drained)
        logger.info("recycle swap window: %.2fs (drain %.2fs "
                    "activate %.2fs)", window, t_drained - t0,
                    loop.time() - t_drained)
        return True

    async def _overlap_swap(self, replica: Replica) -> None:
        """Zero-gap overlapped successor for standby-incapable
        frameworks: full load aside, then rotate."""
        loop = asyncio.get_running_loop()
        t_spawn = loop.time()
        successor = await self.create_replica(
            replica.component_id, replica.revision,
            replica.handle.spec, placement=replica.placement,
            nice=self.recycle.successor_nice, minimal_warmup=True)
        # Loaded and serving: restore normal CPU priority.
        if self.recycle.successor_nice > 0:
            try:
                os.setpriority(os.PRIO_PROCESS,
                               successor.handle.process.pid, 0)
            except (OSError, AttributeError) as e:
                # Lowering nice needs CAP_SYS_NICE; without it the
                # replica SERVES at nice 15 — loud warning, because
                # host contention then starves it permanently, not
                # just during the swap.
                logger.warning(
                    "cannot renice successor %s back to 0 (%s); it "
                    "will serve at nice %d — grant CAP_SYS_NICE or "
                    "set RecyclePolicy.successor_nice=0",
                    successor.handle.process.pid, e,
                    self.recycle.successor_nice)
        t0 = loop.time()
        await self.delete_replica(replica)
        # Zero-gap swap: the successor was serving before the old
        # replica left rotation — no unavailability window.
        self.swap_windows_s.append(0.0)
        self.swap_breakdown.append({
            "mode": "overlap",
            "successor_load_s": round(t0 - t_spawn, 2),
            "drain_s": round(loop.time() - t0, 2),
            # Where the load time went, from the successor's own boot
            # marks (interpreter_imports / download / init_params or
            # params_mmap / warmup / serving, cumulative seconds
            # since process birth).
            "successor_phases": await self._startup_phases(
                successor.host),
        })
        self._observe_swap("overlap", "ok", drain=loop.time() - t0)

    async def _cold_swap(self, replica: Replica) -> None:
        loop = asyncio.get_running_loop()
        cid = replica.component_id
        self.announce_swap(cid, self.recycle.announce_budget_s)
        try:
            t0 = loop.time()
            await self.delete_replica(replica)
            await self.create_replica(
                cid, replica.revision, replica.handle.spec,
                placement=replica.placement, minimal_warmup=True)
        finally:
            self.clear_swap(cid)
        self.swap_windows_s.append(round(loop.time() - t0, 3))
        self.swap_breakdown.append({
            "mode": "cold",
            "window_s": round(loop.time() - t0, 2)})
        self._observe_swap("cold", "ok")

    def _swap_failed(self, replica: Replica, standby: Replica,
                     exc: Exception, mode: str) -> None:
        """Bookkeeping for an aborted standby swap: counted, pinned,
        and (warm mode) the incumbent keeps serving untouched."""
        reason = ("activate_timeout"
                  if isinstance(exc, asyncio.TimeoutError)
                  else "activate_error")
        self.swap_failures += 1
        obs.lifecycle_swap_failures_total().labels(
            reason=reason).inc()
        self._observe_swap(mode, "failed")
        self.flight_recorder.record({
            "kind": "swap_failure",
            "component": replica.component_id,
            "revision": replica.revision,
            "mode": mode, "reason": reason,
            "standby_host": standby.host,
            "incumbent_host": replica.host,
            "error": str(exc)[:500],
        }, pin="swap_failure")
        logger.error("standby swap of %s aborted (%s): %s%s",
                     replica.component_id, reason, exc,
                     f" — incumbent {replica.host} keeps serving"
                     if mode == "warm_standby" else "")

    @staticmethod
    def _observe_swap(mode: str, outcome: str, **phases_s) -> None:
        obs.lifecycle_swaps_total().labels(
            mode=mode, outcome=outcome).inc()
        hist = obs.lifecycle_phase_ms()
        for phase, seconds in phases_s.items():
            hist.labels(phase=phase).observe(seconds * 1000.0)

    # -- crash supervision & standby pool -----------------------------------
    async def _probe_health(self, host: str) -> bool:
        """Liveness probe with the router's `_replica_alive` polarity:
        only a refused/unroutable connection counts as a failure.  A
        TIMEOUT is indeterminate — a replica chewing a multi-second
        batch on its event loop can't answer, and promoting (killing)
        a busy replica would abort its in-flight inference — so it
        classifies as alive.  Health-fail promotion therefore targets
        the crashed-but-not-reaped shape: a process whose socket
        refuses while the pid lingers."""
        try:
            status, _, _ = await HTTPClient(keepalive=False).request(
                "GET", f"http://{host}/", timeout=2.0)
            return status < 500
        except TimeoutError:
            return True  # indeterminate: busy, not dead
        except OSError:
            return False
        except Exception:
            return True

    async def _kv_reattach(self, host: str) -> None:
        """Best-effort: tell a just-promoted successor to rescan the
        durable KV tier directory for its predecessor's generation.
        The predecessor's manifest flock releases on ANY process death
        (SIGKILL included), so by the time the successor is in
        rotation the adoption can take the orphaned manifest.  Runs
        AFTER the swap window clears — adoption must never extend
        unavailability, it only warms the fault-back path.  Failure is
        non-fatal: without a persistent tier the replica answers with
        an empty adoption, and a dead endpoint just means the session
        re-prefills."""
        try:
            status, _, body = await HTTPClient(keepalive=False).request(
                "POST", f"http://{host}/kv/reattach", body=b"{}",
                headers={"content-type": "application/json"}, timeout=5.0)
            logger.info("kv reattach on %s: %d %s", host, status,
                        body[:200])
        except Exception as e:
            logger.info("kv reattach on %s skipped: %s", host, e)

    async def _supervise_crashes(self) -> None:
        """One supervisor pass: replicas whose process exited (or that
        failed health_fail_threshold consecutive probes) are replaced
        by standby promotion NOW — not on the reconciler's schedule."""
        threshold = self.recycle.health_fail_threshold
        for cid, comp in list(self.state.items()):
            for replica in list(comp.replicas):
                if id(replica) in self._recycling:
                    continue
                handle: _Proc = replica.handle
                if handle is None:
                    continue
                if handle.process.returncode is not None:
                    self._begin_promotion(replica, "process_exit")
                    await self._promote_standby(replica,
                                                "process_exit")
                    continue
                if not threshold:
                    continue
                if await self._probe_health(replica.host):
                    self._health_fails.pop(id(replica), None)
                    continue
                fails = self._health_fails.get(id(replica), 0) + 1
                self._health_fails[id(replica)] = fails
                if fails >= threshold:
                    logger.warning(
                        "replica %s failed %d consecutive health "
                        "probes; promoting its standby", replica.host,
                        fails)
                    self._begin_promotion(replica, "health_fail")
                    await self._promote_standby(replica,
                                                "health_fail")

    async def report_crash(self, replica: Replica) -> None:
        """Event-driven crash path (the router calls this when it
        evicts a dead replica): the corpse leaves rotation
        synchronously, promotion runs as a task so the reporting
        request keeps failing over without waiting for a spawn."""
        comp = self.state.get(replica.component_id)
        if comp is None or replica not in comp.replicas \
                or id(replica) in self._recycling:
            return
        self._begin_promotion(replica, "crash_report")
        self._background(self._promote_standby(replica, "crash_report"))

    def _begin_promotion(self, replica: Replica, trigger: str) -> None:
        """Synchronous half of a promotion (no await between check and
        effect, so concurrent reporters can't double-promote): corpse
        out of rotation, create reservation held until
        `_promote_standby` releases it.  The process itself is stopped
        in the async half with the normal SIGTERM-drain contract."""
        self._recycling.add(id(replica))
        comp = self.state.get(replica.component_id)
        if comp is not None and replica in comp.replicas:
            comp.replicas.remove(replica)
        self._health_fails.pop(id(replica), None)
        key = (replica.component_id, replica.revision)
        self._creating[key] = self._creating.get(key, 0) + 1

    async def _promote_standby(self, replica: Replica,
                               trigger: str) -> None:
        """Async half: activate the armed standby (or cold respawn) and
        pin the failover timeline.  `_begin_promotion` ran first."""
        loop = asyncio.get_running_loop()
        cid, rev = replica.component_id, replica.revision
        t0 = loop.time()
        phases: Dict[str, float] = {}
        outcome, promoted_host = "promoted", None
        try:
            handle: _Proc = replica.handle
            if handle is not None:
                # Out of rotation already (no new traffic); now stop
                # the process with the normal drain contract — SIGTERM
                # (in-flight work gets its grace), escalating to
                # SIGKILL past TERM_GRACE_S.  A crashed process costs
                # nothing here (wait returns immediately); a
                # misdiagnosed-alive one gets to drain instead of
                # losing its in-flight inference to an instant kill.
                try:
                    await self._terminate(handle.process)
                except Exception:
                    pass
            dead_rc = (handle.process.returncode
                       if handle is not None else None)
            standby = self._pop_standby((cid, rev))
            # Bridge the promotion gap for waiting requests: the dead
            # replica is out of rotation and the successor is not in
            # yet.
            self.announce_swap(cid, (self.recycle.announce_budget_s
                                     if self.recycle is not None
                                     else 30.0))
            try:
                if standby is not None:
                    t_act = loop.time()
                    try:
                        await asyncio.wait_for(
                            self._activate_standby(standby),
                            READY_TIMEOUT_S)
                        promoted_host = standby.host
                    except asyncio.CancelledError:
                        # Shutdown mid-promotion: the standby is
                        # popped from the pool and outside
                        # self.state — reap it or it orphans.
                        await asyncio.shield(
                            self._terminate(standby.handle.process))
                        raise
                    except Exception:
                        logger.exception(
                            "promotion activate of %s failed; cold "
                            "respawn", standby.host)
                        await asyncio.shield(
                            self._terminate(standby.handle.process))
                        standby = None
                    phases["activate_s"] = round(
                        loop.time() - t_act, 3)
                if standby is None:
                    outcome = "cold_respawn"
                    t_spawn = loop.time()
                    successor = await self.create_replica(
                        cid, rev,
                        handle.spec if handle is not None else None,
                        placement=replica.placement,
                        minimal_warmup=True)
                    promoted_host = successor.host
                    phases["respawn_s"] = round(
                        loop.time() - t_spawn, 3)
            finally:
                self.clear_swap(cid)
            if promoted_host is not None:
                # Crash failover: the corpse's flock auto-released on
                # death, so the successor can adopt its durable KV
                # generation — the returning conversation faults back
                # instead of paying a full re-prefill.  Best-effort,
                # after the window clears.
                await self._kv_reattach(promoted_host)
            phases["total_s"] = round(loop.time() - t0, 3)
            self.promotions += 1
            obs.lifecycle_promotions_total().labels(
                trigger=trigger, outcome=outcome).inc()
            obs.lifecycle_phase_ms().labels(phase="promote").observe(
                (loop.time() - t0) * 1000.0)
            self.flight_recorder.record({
                "kind": "replica_failover",
                "component": cid, "revision": rev,
                "trigger": trigger,
                "dead_host": replica.host,
                "dead_rc": dead_rc,
                "outcome": outcome,
                "promoted_host": promoted_host,
                "phases": phases,
            }, pin="replica_failover")
            logger.warning(
                "replica %s of %s failed (%s): %s -> %s in %.2fs",
                replica.host, cid, trigger, outcome, promoted_host,
                phases["total_s"])
        except Exception:
            # Promotion is best-effort: on total failure the
            # reconciler's next pass restores capacity.
            logger.exception("standby promotion for %s failed", cid)
            obs.lifecycle_promotions_total().labels(
                trigger=trigger, outcome="failed").inc()
        finally:
            key = (cid, rev)
            n = self._creating.get(key, 1) - 1
            if n <= 0:
                self._creating.pop(key, None)
            else:
                self._creating[key] = n
            self._recycling.discard(id(replica))

    def _set_pool_gauge(self, cid: str) -> None:
        obs.lifecycle_standby_pool().labels(component=cid).set(
            float(sum(len(pool)
                      for (c, _r), pool in self._standbys.items()
                      if c == cid)))

    def _maintain_standby_pool(self) -> None:
        """Arm standbys per component (for the latest revision a
        serving replica carries) up to the component's pool target
        (default 1; the predictive autoscaler pre-arms deeper ahead
        of a forecast capacity gap): recycles then skip the spawn
        phase, crash promotion always has a warm successor, and a
        predicted traffic step actuates as activations instead of
        cold spawns.  Spawning runs as background tasks — arming must
        never block the supervisor tick."""
        for cid, comp in list(self.state.items()):
            if not comp.replicas:
                continue
            replica = comp.replicas[-1]
            handle: _Proc = replica.handle
            if handle is None or not self._standby_capable(handle.spec):
                continue
            key = (cid, replica.revision)
            want = self._standby_targets.get(cid, 1)
            have = len(self._standbys.get(key, ())) + \
                self._standby_spawning.get(key, 0)
            for _ in range(max(0, want - have)):
                self._standby_spawning[key] = \
                    self._standby_spawning.get(key, 0) + 1
                self._background(self._arm_standby(
                    key, handle.spec, replica.placement))

    async def _arm_standby(self, key: tuple, spec, placement) -> None:
        cid, rev = key
        try:
            standby = await self.create_replica(
                cid, rev, spec, placement=placement, standby=True)
        except Exception:
            logger.exception("arming standby for %s failed", cid)
            return
        finally:
            n = self._standby_spawning.get(key, 1) - 1
            if n <= 0:
                self._standby_spawning.pop(key, None)
            else:
                self._standby_spawning[key] = n
        comp = self.state.get(cid)
        if comp is None or not any(r.revision == rev
                                   for r in comp.replicas):
            # The component (or this revision) retired while the
            # standby armed — reap, don't leak.
            await self._terminate(standby.handle.process)
            return
        self._standbys.setdefault(key, []).append(standby)
        self._set_pool_gauge(cid)
        logger.info("standby armed for %s rev=%s at %s (pool %d/%d)",
                    cid, rev[:8], standby.host,
                    len(self._standbys[key]),
                    self._standby_targets.get(cid, 1))

    def _reap_orphan_standbys(self) -> None:
        """Standbys whose component/revision no longer serves (scale
        to zero, canary retired, rollback) are torn down, dead pool
        processes are dropped (the next tick re-arms), and pools
        deeper than their target (a pre-arm whose predicted step never
        came, or already actuated) shrink back.  A revision
        with a create in flight still serves: a crash promotion holds
        one from the moment the corpse leaves the state until its
        standby is active, and reaping that standby in between would
        turn the promotion into a cold respawn."""
        for key, pool in list(self._standbys.items()):
            cid, rev = key
            comp = self.state.get(cid)
            wanted = self._creating.get(key, 0) > 0 or (
                comp is not None and any(
                    r.revision == rev for r in comp.replicas))
            want = self._standby_targets.get(cid, 1) if wanted else 0
            keep: List[Replica] = []
            for standby in pool:
                alive = standby.handle.process.returncode is None
                if alive and len(keep) < want:
                    keep.append(standby)
                    continue
                if alive:
                    # SIGTERM now: a shutdown may cancel the wait.
                    standby.handle.process.terminate()
                    self._background(
                        self._terminate(standby.handle.process))
            if keep:
                self._standbys[key] = keep
            else:
                self._standbys.pop(key, None)
            self._set_pool_gauge(cid)

    async def reap_standbys(self, component_id: str,
                            revision: Optional[str] = None) -> None:
        """Immediate teardown hook for the reconciler/rollout: a
        retired (or quarantined) revision's armed standbys must not
        survive to be promoted later."""
        for key, pool in list(self._standbys.items()):
            cid, rev = key
            if cid != component_id:
                continue
            if revision is not None and rev != revision:
                continue
            self._standbys.pop(key, None)
            self._set_pool_gauge(cid)
            for standby in pool:
                await self._terminate(standby.handle.process)

    async def delete_replica(self, replica: Replica) -> None:
        comp = self.state.get(replica.component_id)
        if comp and replica in comp.replicas:
            comp.replicas.remove(replica)
        self._health_fails.pop(id(replica), None)
        handle: _Proc = replica.handle
        if handle is not None:
            await self._terminate(handle.process)
        logger.info("replica down: %s at %s",
                    replica.component_id, replica.host)

    @staticmethod
    async def _terminate(process) -> None:
        if process.returncode is not None:
            return
        process.terminate()
        try:
            await asyncio.wait_for(process.wait(), TERM_GRACE_S)
        except asyncio.TimeoutError:
            process.kill()
            await process.wait()

    def _background(self, coro) -> None:
        """Run a coroutine as a task the orchestrator keeps until it ends:
        shutdown cancels and awaits every one, so no replica process a
        background spawn started outlives the orchestrator."""
        task = asyncio.ensure_future(coro)
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def shutdown(self):
        if self._watchdog is not None:
            self._watchdog.cancel()
            try:
                await self._watchdog
            except (asyncio.CancelledError, Exception):
                pass
            self._watchdog = None
        tasks = list(self._tasks)
        for task in tasks:
            task.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        # Armed standbys live outside self.state — reap them first or
        # they orphan (an exclusive-device orphan holds the chip).
        for key, pool in list(self._standbys.items()):
            self._standbys.pop(key, None)
            for standby in pool:
                await self._terminate(standby.handle.process)
        for comp in list(self.state.values()):
            for replica in list(comp.replicas):
                await self.delete_replica(replica)
