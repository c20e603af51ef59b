"""ModelServer: the V1/V2 inference routes on the stdlib HTTP server.

Port of the inference surface of ``kfserving_tpu/server/app.py``:

    GET  /                                  liveness ("Alive")
    GET  /v2/health/live                    V2 server live
    GET  /v2/health/ready                   V2 server ready (all models)
    GET  /v2                                V2 server metadata
    GET  /v1/models  /v2/models             list models
    GET  /v1/models/{name}                  model health
    GET  /v2/models/{name}/status           model health
    GET  /v2/models/{name}/ready            V2 model ready
    GET  /v2/models/{name}                  V2 model metadata
    POST /v1/models/{name}:predict          V1 predict
    POST /v2/models/{name}/infer            V2 infer
    GET  /v2/models/{name}/versions/{version}/ready   the versioned forms:
    GET  /v2/models/{name}/versions/{version}         any version serves
    POST /v2/models/{name}/versions/{version}/infer   the registered model
    POST /v1/models/{name}:explain          explain (the model's own, or
    POST /v2/models/{name}/explain            proxied to explainer_host)
    POST /v1/models/{name}:generate         generate (``"stream": true``
    POST /v2/models/{name}/generate           hands off to the stream)
    POST /v2/models/{name}/generate_stream  token stream, SSE
                                            ``data: {...}\n\n`` events
    POST /v2/repository/models/{name}/load    (re)load a model
    POST /v2/repository/models/{name}/unload  unload a model
    GET  /v2/repository/index               models and their states
    GET  /debug/cache                       generative models' prefix
                                            census and pools, the
                                            device-memory ledger and
                                            residency states (?top_k=)
    GET  /metrics                           Prometheus metrics (OpenMetrics
                                            with exemplars on request)
    GET  /debug/traces                      the span ring (?trace_id=,
                                            ?limit=)
    GET  /v2/health/slo                     SLO burn rates (?refresh=1)
    GET  /debug/flightrecorder              recent and pinned request
                                            timelines (?limit=, ?pinned=1,
                                            ?pin_type=, ?since_ts=)
    POST /debug/profiler/start|stop         a torch.profiler capture
                                            ({"log_dir": ...})
    GET  /debug/profile                     the engine event timeline as
                                            Chrome-trace JSON (?window_s=,
                                            ?format=events)
    POST /debug/profile/capture             a bounded torch.profiler
                                            window ({"duration_s": s})
    GET  /debug/history                     the telemetry history rings
                                            (?series=, ?labels=,
                                            ?window_s=, ?step_s=, ?index=1)
    GET  /debug/incidents                   diagnosed incidents (?id=,
                                            ?state=, ?limit=)
    GET  /startup_phases                    boot-phase marks (seconds
                                            since process birth)
    POST /standby/activate                  load the armed standby model
    GET  /kv/chains                         host-tier chains per model
                                            (?model=), with block_bytes
    GET  /kv/chains/{chain}                 one chain's payload, with its
                                            x-kfs-kv-digest header
    POST /kv/reattach                       adopt orphaned tier
                                            generations; {"peer": url}
                                            pulls a peer's chains instead

A V2 infer request may use the binary data extension
(``Inference-Header-Content-Length``); one that asks for
``binary_data_output`` gets a binary response.  A CloudEvent request
(binary or structured) gets its response in the same framing.

With ``grpc_port`` set (``--grpc_port`` on the entry points) the same
dataplane also serves the V2 gRPC API (``inference.GRPCInferenceService``,
``inference.ModelRepositoryService``) and the token stream
(``kfserving.generate.GenerationService``), from
``server/grpc_server.py``; gRPC requests land in the same request series.

Each inference request joins a trace (``traceparent`` or
``x-request-id``, echoed back as ``x-request-id``), may carry a budget
(``x-request-timeout-ms``: 504 once it is spent, at whichever stage),
passes the admission gate (``--container_concurrency``: at most that
many requests run at once, a bounded queue waits, the rest get 503), and
is counted in the request series and the access log (with its cost
record when the engine kept one), recorded in the flight recorder, and
handed to the request hooks (the monitor bus).  One asyncio process
serves; batched device execution runs on the engines' worker threads.

The server owns its observability services: the monitoring loop (flight
recorder, monitor bus, SLO burn rates), the telemetry history sampler
with its trend detector (``KFS_HISTORY=0`` disables it) and the incident
engine (``KFS_INCIDENTS=0``); under ``KFS_SANITIZE=1`` it also owns the
sanitizer's loop-stall watchdog and pins violations.

A generate request with an ``x-kfs-kv-peer`` header (a router's failover
hint naming the replica it was retried away from) first pulls that
peer's host-tier chains, once per peer, within ``KFS_KV_PEER_BUDGET_S``.
On SIGTERM the server drains in-flight work (``KFS_DRAIN_GRACE_S``),
exports live KV into persistent host tiers (``KFS_KV_EXPORT_BUDGET_S``),
then stops.  ``standby_model`` arms standby: the server listens with no
model until ``POST /standby/activate`` loads it.
"""

import argparse
import asyncio
import contextlib
import http.client
import json
import logging
import os
import signal
import tempfile
import time
import urllib.parse
from typing import Any, Dict, List, Optional, Tuple

from kfserving_tpu_torch import startup
from kfserving_tpu_torch.engine.kv_tier import payload_digest

from kfserving_tpu_torch.model.model import Model
from kfserving_tpu_torch.model.repository import ModelRepository
from kfserving_tpu_torch.observability import REGISTRY, attribution
from kfserving_tpu_torch.observability import metrics as obs
from kfserving_tpu_torch.observability.accesslog import log_access
from kfserving_tpu_torch.observability.history import (
    HistorySampler,
    TrendDetector,
    history_enabled,
)
from kfserving_tpu_torch.observability.incidents import (
    IncidentManager,
    incidents_enabled,
)
from kfserving_tpu_torch.observability.monitoring import Monitoring
from kfserving_tpu_torch.observability.profiling import (
    TIMELINE,
    roofline,
    to_chrome_trace,
)
from kfserving_tpu_torch.protocol import cloudevents, native
from kfserving_tpu_torch.protocol.errors import ServingError
from kfserving_tpu_torch.protocol.v2 import (
    INFERENCE_HEADER_CONTENT_LENGTH,
    InferRequest,
    encode_binary_response,
)
from kfserving_tpu_torch.reliability import fault_sites, sanitizer
from kfserving_tpu_torch.reliability.deadline import (
    Deadline,
    DeadlineExceeded,
    deadline_scope,
)
from kfserving_tpu_torch.reliability.faults import faults
from kfserving_tpu_torch.server.dataplane import DataPlane
from kfserving_tpu_torch.server.http import (
    HTTPServer,
    Request,
    Response,
    Router,
    StreamingResponse,
)
from kfserving_tpu_torch.server.metrics import Metrics
from kfserving_tpu_torch.streams import GuardedStream, aclose_quietly
from kfserving_tpu_torch.tracing import (
    REQUEST_ID_HEADER,
    ensure_request_id,
    profiler,
    tracer,
)

logger = logging.getLogger("kfserving_tpu_torch.server")

DEFAULT_HTTP_PORT = 8080
# Where a profiler capture writes when the request names no log_dir.
DEFAULT_PROFILE_DIR = os.path.join(tempfile.gettempdir(), "kfs-profile")

# The JAX package's parent parser surface (reference kfserver.py:34-43),
# so the orchestrators' argv reads alike for both packages; the batcher
# flags are accepted and, as there, the artifact's config.json decides
# the batcher.
parser = argparse.ArgumentParser(add_help=False)
parser.add_argument("--http_port", default=DEFAULT_HTTP_PORT, type=int,
                    help="The HTTP port listened to by the model server.")
parser.add_argument("--workers", default=1, type=int,
                    help="Unused; kept for reference CLI compatibility "
                         "(single process owns the card).")
parser.add_argument("--max_latency_ms", default=5.0, type=float,
                    help="Dynamic batcher flush deadline in milliseconds.")
parser.add_argument("--max_batch_size", default=32, type=int,
                    help="Dynamic batcher max batch size.")
parser.add_argument("--container_concurrency", default=0, type=int,
                    help="Max concurrent inference calls per replica "
                         "(0 = unlimited; Knative containerConcurrency).")
parser.add_argument("--grpc_port", default=None, type=int,
                    help="V2 gRPC port (unset = gRPC disabled, 0 = "
                         "ephemeral).")


def _json(data: Any, status: int = 200) -> Response:
    fast = native.dump_response(data)
    if fast is not None:
        return Response(fast, status=status)
    return Response(json.dumps(data, default=_np_default).encode("utf-8"),
                    status=status)


def _np_default(obj):
    tolist = getattr(obj, "tolist", None)
    if tolist is not None:
        return tolist()
    raise TypeError(
        f"Object of type {type(obj).__name__} is not JSON serializable")


@contextlib.contextmanager
def _staged(stages: Dict[str, float], stage: str):
    """Record a stage's wall time (ms) into `stages` for the access
    log."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        stages[stage] = round((time.perf_counter() - t0) * 1000.0, 3)


def _error(e: ServingError) -> Response:
    return _json({"error": e.reason}, status=e.status_code)


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def _http_get(base: str, path: str, timeout: float
              ) -> Tuple[int, Dict[str, str], bytes]:
    """One blocking GET of ``path`` on the http:// peer ``base``:
    (status, lower-cased headers, body)."""
    url = urllib.parse.urlsplit(base)
    if url.scheme != "http" or not url.hostname:
        raise ValueError(f"peer {base!r} is not an http:// URL")
    conn = http.client.HTTPConnection(url.hostname, url.port or 80,
                                      timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return (resp.status,
                {k.lower(): v for k, v in resp.getheaders()},
                resp.read())
    finally:
        conn.close()


class _AdmissionGate:
    """FIFO concurrency gate with a bounded wait queue.

    Not an asyncio.Semaphore: acquire() permits barging, which would let
    newcomers starve queued requests and grow the queue past its bound.
    This gate hands a finishing request's slot directly to the oldest
    waiter.
    """

    def __init__(self, limit: int, max_queue: int):
        self.limit = limit
        self.max_queue = max_queue
        self.active = 0
        self.queue = []  # FIFO of futures

    async def enter(self) -> bool:
        """True once a slot is held; False = queue full, reject."""
        if self.active < self.limit and not self.queue:
            self.active += 1
            return True
        if len(self.queue) >= self.max_queue:
            return False
        fut = asyncio.get_running_loop().create_future()
        self.queue.append(fut)
        try:
            await fut
        except asyncio.CancelledError:
            if fut.done() and not fut.cancelled():
                # Granted between the cancel and now: pass the slot on.
                self.exit()
            else:
                try:
                    self.queue.remove(fut)
                except ValueError:
                    pass
            raise
        return True

    def exit(self) -> None:
        while self.queue:
            fut = self.queue.pop(0)
            if not fut.done():
                fut.set_result(None)  # slot transferred; active unchanged
                return
        self.active -= 1


class ModelServer:
    def __init__(self, http_port: int = DEFAULT_HTTP_PORT,
                 registered_models: Optional[ModelRepository] = None,
                 container_concurrency: int = 0,
                 max_queue_depth: Optional[int] = None,
                 grpc_port: Optional[int] = None):
        self.repository = registered_models or ModelRepository()
        self.dataplane = DataPlane(self.repository)
        self.http_port = http_port
        # V2 gRPC front end over the same dataplane (None = disabled;
        # 0 = ephemeral port, which `self.grpc_port` then holds).
        self.grpc_port = grpc_port
        self.grpc_server = None
        self.metrics = Metrics()
        self.router = Router()
        self._register_routes()
        self.http_server = HTTPServer(self.router)
        # Called as hook(name, verb, request, response, latency_ms) after
        # every inference request (the monitor bus tees in here).
        self.request_hooks = []
        # Background services with async start()/stop(), run for the
        # server's lifetime.
        self.services = []
        # The monitoring loop: the monitor bus off the request hooks, the
        # SLO burn-rate engine over this server's request series, the
        # flight recorder of recent timelines.
        self.monitoring = Monitoring(self)
        self.services.append(self.monitoring)
        # Telemetry history: the ring-TSDB sampler ticks this server's
        # request registry and the process registry into bounded rings
        # (running the scrape-time publishers first, so history and a
        # live scrape agree) and feeds the trend detector, whose
        # change-points pin into the flight recorder.
        self.history: Optional[HistorySampler] = None
        if history_enabled():
            self.history = HistorySampler(
                registries=[self.metrics.registry, REGISTRY],
                fault_hook=self._history_tick_fault,
                publishers=[self.publish_engine_gauges])
            self.history.detector = TrendDetector(
                self.history.store,
                recorder=self.monitoring.flight_recorder)
            self.services.append(self.history)
        # The incident engine: detector pins and SLO breach edges become
        # diagnosed incident records (GET /debug/incidents).
        self.incidents: Optional[IncidentManager] = None
        if incidents_enabled():
            self.incidents = IncidentManager(
                history=(self.history.store
                         if self.history is not None else None),
                recorder=self.monitoring.flight_recorder,
                providers={"cache": self._incident_cache_snapshot},
                fault_hook=self._incident_open_fault)
            self.monitoring.flight_recorder.add_pin_listener(
                self.incidents.on_pin)
            self.monitoring.slo.transition_listeners.append(
                self.incidents.on_slo_transition)
            self.services.append(self.incidents)
        self._owns_sanitizer_watchdog = False
        # Per-replica admission control (Knative containerConcurrency):
        # at most `container_concurrency` inference calls run at once; up
        # to `max_queue_depth` more wait, the rest get 503 so the load
        # balancer retries another replica.  0 = unlimited.
        self.container_concurrency = container_concurrency
        self.max_queue_depth = (
            max_queue_depth if max_queue_depth is not None
            else max(2 * container_concurrency, 8))
        self._admission = (
            _AdmissionGate(container_concurrency, self.max_queue_depth)
            if container_concurrency > 0 else None)
        # Standby: a callable that does the deferred (device-touching)
        # model load, set by standby_model().
        self._standby_fn = None
        self._standby_state = "none"  # none | armed | activating | done
        # Peer pulls are single-flight: one per peer for the process's
        # life, however many hinted requests arrive at once.
        self._kv_peer_lock = asyncio.Lock()
        self._kv_peers_pulled: set = set()

    def standby_model(self, activate_fn) -> None:
        """Arm standby: the server starts with no model, and
        ``activate_fn`` (blocking; returns the loaded Model) runs on the
        first ``POST /standby/activate``.  What needs no card (imports,
        download, config parse) is done while the predecessor still
        holds it."""
        self._standby_fn = activate_fn
        self._standby_state = "armed"

    def _register_routes(self):
        r = self.router
        r.add("GET", "/", self._live)
        r.add("GET", "/v2/health/live", self._live)
        r.add("GET", "/v2/health/ready", self._server_ready)
        r.add("GET", "/v2", self._server_metadata)
        r.add("GET", "/v1/models", self._list_models)
        r.add("GET", "/v2/models", self._list_models)
        r.add("GET", "/v1/models/{name}", self._model_health)
        r.add("GET", "/v2/models/{name}/status", self._model_health)
        r.add("GET", "/v2/models/{name}/ready", self._model_ready)
        r.add("GET", "/v2/models/{name}", self._model_metadata)
        r.add("POST", "/v1/models/{name}:predict", self._predict_v1)
        r.add("POST", "/v2/models/{name}/infer", self._infer_v2)
        # Versioned forms: a server with one live version per name serves
        # the registered model under any version.
        r.add("GET", "/v2/models/{name}/versions/{version}/ready",
              self._model_ready)
        r.add("GET", "/v2/models/{name}/versions/{version}",
              self._model_metadata)
        r.add("POST", "/v2/models/{name}/versions/{version}/infer",
              self._infer_v2)
        r.add("POST", "/v1/models/{name}:explain", self._explain)
        r.add("POST", "/v2/models/{name}/explain", self._explain)
        r.add("POST", "/v1/models/{name}:generate", self._generate)
        r.add("POST", "/v2/models/{name}/generate", self._generate)
        r.add("POST", "/v2/models/{name}/generate_stream",
              self._generate_stream)
        r.add("POST", "/v2/repository/models/{name}/load", self._load)
        r.add("POST", "/v2/repository/models/{name}/unload", self._unload)
        r.add("GET", "/v2/repository/index", self._repository_index)
        r.add("GET", "/metrics", self._metrics)
        r.add("GET", "/startup_phases", self._startup_phases)
        r.add("POST", "/standby/activate", self._standby_activate)
        r.add("GET", "/kv/chains", self._kv_chains)
        r.add("GET", "/kv/chains/{chain}", self._kv_chain_payload)
        r.add("POST", "/kv/reattach", self._kv_reattach)
        r.add("GET", "/v2/health/slo", self._slo_health)
        r.add("GET", "/debug/flightrecorder", self._flightrecorder)
        r.add("GET", "/debug/traces", self._traces)
        r.add("POST", "/debug/profiler/start", self._profiler_start)
        r.add("POST", "/debug/profiler/stop", self._profiler_stop)
        r.add("GET", "/debug/profile", self._profile)
        r.add("POST", "/debug/profile/capture", self._profile_capture)
        r.add("GET", "/debug/cache", self._cache)
        r.add("GET", "/debug/history", self._history)
        r.add("GET", "/debug/incidents", self._incidents)

    # -- handlers ----------------------------------------------------------
    async def _live(self, req: Request) -> Response:
        return Response(b"Alive", content_type="text/plain")

    async def _server_ready(self, req: Request) -> Response:
        ready = self.dataplane.server_ready()
        body = {"ready": ready}
        if sanitizer.enabled():
            # Sanitized runs show their discipline state where the probe
            # already looks (all-zero violations is the clean bill).
            body["sanitizer"] = sanitizer.status()
        return _json(body, status=200 if ready else 503)

    async def _server_metadata(self, req: Request) -> Response:
        return _json(self.dataplane.server_metadata())

    async def _list_models(self, req: Request) -> Response:
        return _json(self.dataplane.list_models())

    async def _model_health(self, req: Request) -> Response:
        try:
            model = self.dataplane.model_ready(req.path_params["name"])
        except ServingError as e:
            return _error(e)
        return _json({"name": model.name, "ready": model.ready})

    async def _model_ready(self, req: Request) -> Response:
        try:
            self.dataplane.model_ready(req.path_params["name"])
        except ServingError as e:
            return _error(e)
        return Response(b"", status=200)

    async def _model_metadata(self, req: Request) -> Response:
        try:
            return _json(self.dataplane.model_metadata(
                req.path_params["name"]))
        except ServingError as e:
            return _error(e)

    async def _predict_v1(self, req: Request) -> Response:
        return await self._inference(req, "predict", self.dataplane.infer)

    async def _infer_v2(self, req: Request) -> Response:
        return await self._inference(req, "infer", self.dataplane.infer)

    async def _explain(self, req: Request) -> Response:
        return await self._inference(req, "explain", self.dataplane.explain)

    async def _inference(self, req: Request, verb: str, op) -> Response:
        name = req.path_params["name"]
        rid = ensure_request_id(req.headers)
        # The request's budget, minted here at ingress and carried by
        # contextvar through the data plane, the batcher queue and the
        # engine dispatch: each stage sheds the request with 504 the
        # moment it is spent.
        deadline = Deadline.from_headers(req.headers)
        start = time.perf_counter()
        if self._admission is not None:
            admitted = await self._enter_admission(deadline)
            if admitted is not True:
                status, error = self._shed_reason(admitted)
                latency_ms = (time.perf_counter() - start) * 1000.0
                resp = _json({"error": error}, status=status)
                self.metrics.observe_request(name, verb, status,
                                             latency_ms, trace_id=rid)
                # A shed is what the flight recorder keeps evidence of
                # (a 504 pins as deadline_shed), and the hooks see it.
                self.monitoring.record_request(name, verb, status,
                                               latency_ms, trace_id=rid)
                self._run_hooks(name, verb, req, resp, latency_ms)
                resp.headers[REQUEST_ID_HEADER] = rid
                return resp
            try:
                resp = await self._inference_inner(req, verb, op, name,
                                                   start, deadline, rid)
            finally:
                self._admission.exit()
        else:
            resp = await self._inference_inner(req, verb, op, name,
                                               start, deadline, rid)
        resp.headers[REQUEST_ID_HEADER] = rid
        return resp

    @staticmethod
    def _shed_reason(admitted: Optional[bool]):
        """Status and message of a failed admission.  False: the queue
        is full (503, the load balancer retries elsewhere).  None: the
        budget ran out while queued (504, no slot ever held)."""
        if admitted is False:
            return 503, "concurrency limit exceeded"
        return 504, "request deadline exceeded (admission queue)"

    async def _enter_admission(self, deadline) -> Optional[bool]:
        """Admission with a budget-bounded queue wait: True = slot held,
        False = queue full (503), None = deadline expired while queued
        (504).  wait_for's cancellation is safe against the grant race:
        _AdmissionGate.enter() hands a granted slot to the next waiter
        when cancelled."""
        if deadline is None:
            return await self._admission.enter()
        remaining = deadline.remaining_s()
        if remaining <= 0:
            return None
        try:
            return await asyncio.wait_for(self._admission.enter(),
                                          timeout=remaining)
        except asyncio.TimeoutError:
            return None

    async def _inference_inner(self, req: Request, verb: str, op,
                               name: str, start: float, deadline,
                               trace_id: str) -> Response:
        status = 200
        stages: Dict[str, float] = {}
        tokens_out = None
        try:
            if deadline is not None and deadline.expired:
                # Spent waiting for the admission slot: 504 without
                # touching decode or the engine.
                raise DeadlineExceeded("admission queue")
            with deadline_scope(deadline):
                with tracer.span("server.decode", model=name,
                                 verb=verb), _staged(stages, "decode"):
                    body = self.dataplane.decode_body(
                        req.headers, req.body,
                        dtype_hint=self.dataplane.wire_dtype_hint(name))
                with tracer.span("server.infer", model=name,
                                 verb=verb), _staged(stages, "infer"):
                    response = await op(name, body)
                with tracer.span("server.encode", model=name,
                                 verb=verb), _staged(stages, "encode"):
                    resp = self._encode_response(req, body, response)
                if isinstance(response, dict) and isinstance(
                        response.get("details"), dict):
                    tokens_out = response["details"].get("token_count")
        except ServingError as e:
            status = e.status_code
            resp = _error(e)
        except Exception as e:
            logger.exception("%s failed for model %s", verb, name)
            status = 500
            resp = _json({"error": str(e)}, status=500)
        latency_ms = (time.perf_counter() - start) * 1000.0
        self.metrics.observe_request(name, verb, status, latency_ms,
                                     trace_id=trace_id)
        # After the stage spans completed (the tracer ring holds this
        # trace's batcher and engine spans) and before the hooks.
        self.monitoring.record_request(name, verb, status, latency_ms,
                                       trace_id=trace_id,
                                       stages=stages or None)
        log_access("server", trace_id=trace_id, model=name, verb=verb,
                   status=status, latency_ms=round(latency_ms, 3),
                   stages=stages or None, tokens_out=tokens_out,
                   cost=attribution.lookup(trace_id))
        self._run_hooks(name, verb, req, resp, latency_ms)
        return resp

    def _run_hooks(self, name: str, verb: str, req: Request,
                   resp: Response, latency_ms: float) -> None:
        for hook in self.request_hooks:
            try:
                hook(name, verb, req, resp, latency_ms)
            except Exception:
                logger.exception("request hook failed")

    @staticmethod
    def _encode_response(req: Request, body: Any, response: Any
                         ) -> Response:
        """The request's CloudEvents framing echoed back when it was a
        CloudEvent; a binary-extension response when the V2 request
        asked for ``binary_data_output``; else JSON."""
        if isinstance(body, cloudevents.CloudEvent):
            event = cloudevents.CloudEvent(body.attributes, response)
            if cloudevents.is_structured(req.headers):
                headers, payload = cloudevents.to_structured(event)
            else:
                headers, payload = cloudevents.to_binary(event)
            return Response(payload, headers=headers)
        if (isinstance(body, InferRequest)
                and body.parameters.get("binary_data_output")
                and isinstance(response, dict) and response.get("outputs")):
            payload, hlen = encode_binary_response(response)
            return Response(payload, headers={
                "content-type": "application/octet-stream",
                INFERENCE_HEADER_CONTENT_LENGTH: str(hlen)})
        return _json(response)

    async def _generate(self, req: Request) -> Response:
        await self._maybe_peer_import(req.headers, req.path_params["name"])
        # {"stream": true} hands the request to the token stream.
        if b'"stream"' in req.body:
            try:
                body = json.loads(req.body) if req.body else {}
            except ValueError:
                return _json({"error": "malformed JSON body"}, status=400)
            if isinstance(body, dict) and body.get("stream"):
                return await self._generate_stream(req, body=body)
        return await self._inference(req, "generate",
                                     self.dataplane.generate)

    async def _generate_stream(self, req: Request,
                               body: Any = None) -> Response:
        name = req.path_params["name"]
        await self._maybe_peer_import(req.headers, name)
        rid = ensure_request_id(req.headers)
        # The budget applies to submission and rides into the engine
        # request (captured at submit): a stream whose budget runs out
        # mid-generation finishes with reason "timeout" instead of
        # holding its decode slot to the token budget.
        deadline = Deadline.from_headers(req.headers)
        if body is None:
            try:
                body = json.loads(req.body) if req.body else {}
            except ValueError:
                return _json({"error": "malformed JSON body"}, status=400)
        # Streams pass the same admission gate as every other inference
        # verb; the slot is held until the stream ends (released in
        # on_close, since the body outlives this handler).
        gated = False
        if self._admission is not None:
            admitted = await self._enter_admission(deadline)
            if admitted is not True:
                status, error = self._shed_reason(admitted)
                resp = _json({"error": error}, status=status)
                self.metrics.observe_request(name, "generate_stream",
                                             status, 0.0, trace_id=rid)
                resp.headers[REQUEST_ID_HEADER] = rid
                return resp
            gated = True
        try:
            # Validation and submission happen here, before headers are
            # committed: errors are plain 4xx/5xx responses.
            with deadline_scope(deadline):
                events = await self.dataplane.generate_stream(name, body)
        except ServingError as e:
            if gated:
                self._admission.exit()
            resp = _error(e)
            resp.headers[REQUEST_ID_HEADER] = rid
            return resp
        except Exception:
            if gated:
                self._admission.exit()
            raise
        start = time.perf_counter()
        admission = self._admission if gated else None
        state = {"status": 200}

        async def sse():
            try:
                async for event in events:
                    payload = json.dumps(event, default=_np_default)
                    yield f"data: {payload}\n\n".encode("utf-8")
            except Exception:
                logger.exception("generate stream for %s failed", name)
                state["status"] = 500
                raise

        async def on_close():
            # Runs once on every exit path, a client that went away
            # before the first event included: the admission slot is
            # released and closing the model's event stream frees its
            # engine slot.
            if admission is not None:
                admission.exit()
            await aclose_quietly(events, "model event stream")
            latency_ms = (time.perf_counter() - start) * 1000.0
            self.metrics.observe_request(name, "generate_stream",
                                         state["status"], latency_ms,
                                         trace_id=rid)
            # Recorded at close: the generator span and the cost record
            # exist once the stream ended (a cancel finalizes too).
            self.monitoring.record_request(name, "generate_stream",
                                           state["status"], latency_ms,
                                           trace_id=rid)
            log_access("server", trace_id=rid, model=name,
                       verb="generate_stream", status=state["status"],
                       latency_ms=round(latency_ms, 3),
                       cost=attribution.lookup(rid))
            # The hooks get the stream's real outcome with an empty body
            # (the token stream was never buffered).
            self._run_hooks(name, "generate_stream", req,
                            Response(b"", status=state["status"]),
                            latency_ms)

        return StreamingResponse(GuardedStream(sse(), on_close),
                                 headers={REQUEST_ID_HEADER: rid})

    async def _startup_phases(self, req: Request) -> Response:
        return _json(startup.phases())

    async def _standby_activate(self, req: Request) -> Response:
        if self._standby_fn is None:
            return _json({"error": "server is not in standby mode"},
                         status=409)
        if self._standby_state == "done":
            return _json({"activated": True, "already": True})
        if self._standby_state == "activating":
            return _json({"error": "activation already in progress"},
                         status=409)
        self._standby_state = "activating"
        t0 = time.perf_counter()
        try:
            model = await asyncio.get_running_loop().run_in_executor(
                None, self._standby_fn)
            self.register_model(model)
            self._standby_state = "done"
        except Exception as e:
            self._standby_state = "armed"  # retryable
            logger.exception("standby activation failed")
            return _json({"error": f"activation failed: {e}"}, status=500)
        startup.mark("standby_activate")
        return _json({
            "activated": True, "model": model.name,
            "activate_s": round(time.perf_counter() - t0, 3),
            "param_source": getattr(model, "param_source", None),
            "phases": startup.phases(),
        })

    # -- durable KV handoff --------------------------------------------------
    def _kv_tier_models(self, name: Optional[str] = None):
        """(model, engine, tier) for every registered model whose engine
        has a host KV tier (optionally one model by name)."""
        out = []
        for model in self.repository.get_models():
            if name is not None and model.name != name:
                continue
            engine = getattr(model, "engine", None)
            tier = getattr(engine, "kv_tier", None)
            if tier is not None:
                out.append((model, engine, tier))
        return out

    async def _kv_chains(self, req: Request) -> Response:
        """The peer-transfer index: each model's tier-resident chain
        digests (MRU last) and the block size a puller must match."""
        models = {model.name: {"block_bytes": tier.block_bytes,
                               "chains": tier.chains()}
                  for model, _engine, tier
                  in self._kv_tier_models(req.query.get("model"))}
        return _json({"models": models})

    async def _kv_chain_payload(self, req: Request) -> Response:
        """One chain's payload; the digest header lets the receiver
        discard a corrupted transfer."""
        chain_hex = req.path_params["chain"]
        try:
            chain = bytes.fromhex(chain_hex)
        except ValueError:
            return _json({"error": "chain must be a hex digest"},
                         status=400)
        loop = asyncio.get_running_loop()
        for model, _engine, tier in self._kv_tier_models(
                req.query.get("model")):
            try:
                # Off the loop: one block's copy out of the mmap.
                payload = await loop.run_in_executor(None, tier.read, chain)
            except KeyError:
                continue
            return Response(payload, headers={
                "content-type": "application/octet-stream",
                "x-kfs-kv-digest": payload_digest(payload),
                "x-kfs-kv-block-bytes": str(tier.block_bytes),
                "x-kfs-kv-model": model.name})
        return _json({"error": f"chain {chain_hex} is not resident"},
                     status=404)

    async def _kv_reattach(self, req: Request) -> Response:
        """Re-attach conversation KV after a process boundary: a bare
        POST re-scans each persistent tier's directory and adopts
        orphaned predecessor generations; ``{"peer": url}`` pulls that
        replica's resident chains instead (``model`` and ``budget_s``
        optional)."""
        body: Dict[str, Any] = {}
        if req.body:
            try:
                parsed = json.loads(req.body)
            except ValueError:
                return _json({"error": "malformed JSON body"}, status=400)
            if isinstance(parsed, dict):
                body = parsed
        name = body.get("model")
        try:
            budget_s = float(body.get(
                "budget_s", _env_float("KFS_KV_PEER_BUDGET_S", 2.0)))
        except (TypeError, ValueError):
            budget_s = 2.0
        peer = body.get("peer")
        if peer:
            results = await self._kv_pull_peer(str(peer).rstrip("/"),
                                               budget_s, name=name)
            return _json({"peer": peer, "models": results})
        loop = asyncio.get_running_loop()
        results: Dict[str, Any] = {}
        for model, _engine, tier in self._kv_tier_models(name):
            try:
                results[model.name] = await loop.run_in_executor(
                    None, tier.reattach)
            except Exception as e:
                logger.exception("kv reattach for %s failed", model.name)
                results[model.name] = {"error": str(e)}
        if results:
            self.monitoring.flight_recorder.record(
                {"kind": "kv_handoff_reattach", "models": results},
                pin="kv_handoff_reattach")
        return _json({"models": results})

    async def _kv_pull_peer(self, peer: str, budget_s: float,
                            name: Optional[str] = None) -> Dict[str, Any]:
        """Pull a peer's resident chains into the local tiers: the index,
        then each missing chain's payload, verified against its digest
        header on receipt, then one ``kv_import`` per model.  Bounded by
        ``budget_s``: a slow peer costs the returning conversation a
        re-prefill, never a stalled request.  Blocking HTTP runs in the
        default executor."""
        loop = asyncio.get_running_loop()
        deadline = loop.time() + max(0.1, budget_s)

        async def get(path: str):
            remaining = max(0.05, deadline - loop.time())
            return await loop.run_in_executor(None, _http_get, peer, path,
                                              remaining)

        results: Dict[str, Any] = {}
        try:
            status, _, raw = await get("/kv/chains")
            if status != 200:
                return {"error": f"peer index {status}"}
            index = json.loads(raw)
            for mname, info in (index.get("models") or {}).items():
                if name is not None and mname != name:
                    continue
                triples = self._kv_tier_models(mname)
                if not triples:
                    continue
                _model, engine, tier = triples[0]
                if info.get("block_bytes") != tier.block_bytes:
                    results[mname] = {"error": "block geometry mismatch"}
                    continue
                pairs = []
                mismatches = failed = 0
                for ch_hex in info.get("chains") or []:
                    if loop.time() >= deadline:
                        break
                    try:
                        chain = bytes.fromhex(ch_hex)
                    except ValueError:
                        continue
                    if tier.contains(chain):
                        continue
                    query = urllib.parse.urlencode({"model": mname})
                    try:
                        status, headers, payload = await get(
                            f"/kv/chains/{ch_hex}?{query}")
                    except (OSError, http.client.HTTPException):
                        failed += 1
                        continue
                    if status != 200:
                        failed += 1
                        continue
                    want = headers.get("x-kfs-kv-digest")
                    if len(payload) != tier.block_bytes or (
                            want and payload_digest(payload) != want):
                        mismatches += 1  # wire corruption: discarded
                        continue
                    pairs.append((chain, payload))
                res = dict(await loop.run_in_executor(
                    None, engine.kv_import, pairs))
                if mismatches:
                    res["digest_mismatch"] = mismatches
                    obs.kv_handoff_peer_blocks_total().labels(
                        model=mname, outcome="digest_mismatch").inc(
                            mismatches)
                if failed:
                    res["failed"] = res.get("failed", 0) + failed
                    obs.kv_handoff_peer_blocks_total().labels(
                        model=mname, outcome="failed").inc(failed)
                results[mname] = res
        except (OSError, ValueError, http.client.HTTPException) as e:
            results.setdefault("error", f"peer pull failed: {e!r}")
        if results:
            self.monitoring.flight_recorder.record(
                {"kind": "kv_handoff_peer_pull", "peer": peer,
                 "models": {k: v for k, v in results.items()
                            if isinstance(v, dict)}},
                pin="kv_handoff_peer_pull")
        return results

    async def _maybe_peer_import(self, headers: Dict[str, str],
                                 name: str) -> None:
        """Honor the router's failover hint: ``x-kfs-kv-peer`` names the
        replica this request was retried away from.  One bounded pull
        per peer warms the local tier before dispatch; any failure
        degrades to a plain re-prefill, never a failed request."""
        peer = (headers.get("x-kfs-kv-peer") or "").strip().rstrip("/")
        if not peer or peer in self._kv_peers_pulled:
            return
        if not self._kv_tier_models(name):
            return
        async with self._kv_peer_lock:
            if peer in self._kv_peers_pulled:
                return
            self._kv_peers_pulled.add(peer)
            budget = _env_float("KFS_KV_PEER_BUDGET_S", 2.0)
            if budget <= 0:
                return
            try:
                await self._kv_pull_peer(peer, budget, name=name)
            except Exception:
                logger.exception("kv peer pull from %s failed", peer)

    async def export_kv(self, budget_s: Optional[float] = None
                        ) -> Dict[str, Any]:
        """Drain export: every engine's live-slot and hot-chain KV into
        its persistent host tier (an ephemeral tier dies with the
        process), bounded by ``KFS_KV_EXPORT_BUDGET_S`` (0 disables)."""
        if budget_s is None:
            budget_s = _env_float("KFS_KV_EXPORT_BUDGET_S", 2.0)
        results: Dict[str, Any] = {}
        if budget_s <= 0:
            return results
        loop = asyncio.get_running_loop()
        for model, engine, tier in self._kv_tier_models():
            if not tier.persistent:
                continue
            try:
                results[model.name] = await loop.run_in_executor(
                    None, engine.export_kv, budget_s)
            except Exception:
                logger.exception("kv export for %s failed", model.name)
        if results:
            self.monitoring.flight_recorder.record(
                {"kind": "kv_handoff_export", "budget_s": budget_s,
                 "models": results},
                pin="kv_handoff_export")
        return results

    async def _load(self, req: Request) -> Response:
        name = req.path_params["name"]
        try:
            await self.dataplane.load(name)
        except ServingError as e:
            return _error(e)
        return _json({"name": name, "load": True})

    async def _unload(self, req: Request) -> Response:
        name = req.path_params["name"]
        try:
            await self.dataplane.unload(name)
        except ServingError as e:
            return _error(e)
        return _json({"name": name, "unload": True})

    async def _repository_index(self, req: Request) -> Response:
        return _json(self.dataplane.repository_index())

    def publish_engine_gauges(self) -> None:
        """Refresh the scrape-time families from the engines' stats
        dicts: the roofline gauges (MFU, achieved TFLOP/s, padding
        waste, goodput, memory bandwidth), the paged pool's ratios, and
        a ``kfserving_tpu_engine_<key>`` gauge per other numeric key."""
        for model in self.repository.get_models():
            engine_stats = getattr(model, "engine_stats", None)
            if engine_stats is None:
                continue
            try:
                stats = engine_stats()
                consumed = roofline.publish_gauges(model.name, stats)
                attribution.publish_cache_gauges(model.name, stats)
                for key, value in stats.items():
                    if key in consumed:
                        continue
                    if isinstance(value, dict):
                        # Per-bucket stats export as labeled series.
                        for bucket, v in value.items():
                            if isinstance(v, (int, float)):
                                self.metrics.set_gauge(
                                    f"kfserving_tpu_engine_{key}",
                                    float(v),
                                    labels={"model": model.name,
                                            "bucket": str(bucket)})
                        continue
                    if isinstance(value, (int, float)):
                        self.metrics.set_gauge(
                            f"kfserving_tpu_engine_{key}", float(value),
                            labels={"model": model.name})
            except Exception:
                logger.exception("engine stats for %s failed", model.name)

    async def _metrics(self, req: Request) -> Response:
        self.publish_engine_gauges()
        # Content negotiation: exemplars are legal only under the
        # OpenMetrics content type; the classic text parser would reject
        # the suffix and drop the whole scrape.
        want_om = "application/openmetrics-text" in \
            req.headers.get("accept", "")
        body = self.metrics.render(exemplars=want_om)
        if want_om:
            body += "# EOF\n"
            ctype = ("application/openmetrics-text; version=1.0.0; "
                     "charset=utf-8")
        else:
            ctype = "text/plain; version=0.0.4"
        return Response(body.encode("utf-8"), content_type=ctype)

    async def _traces(self, req: Request) -> Response:
        trace_id = req.query.get("trace_id")
        try:
            limit = int(req.query.get("limit", "100"))
        except ValueError:
            return _json({"error": "limit must be an integer"}, status=400)
        return _json({"spans": tracer.spans(trace_id, limit)})

    async def _slo_health(self, req: Request) -> Response:
        """The SLO engine's last evaluation; ``?refresh=1`` forces a
        fresh tick.  Always 200: a breach is a reported state, not an
        endpoint failure."""
        if req.query.get("refresh") == "1":
            return _json(self.monitoring.slo.tick())
        return _json(self.monitoring.slo.report())

    async def _flightrecorder(self, req: Request) -> Response:
        """``?limit=``, ``?pinned=1`` (pinned entries only),
        ``?pin_type=`` (pin-reason prefix: ``trend``, ``slo_``,
        ``sanitizer_`` ...) and ``?since_ts=`` (wall-clock seconds)."""
        try:
            limit = int(req.query.get("limit", "100"))
        except ValueError:
            return _json({"error": "limit must be an integer"},
                         status=400)
        pinned_only = req.query.get("pinned", "0") == "1"
        pin_type = req.query.get("pin_type") or None
        since_raw = req.query.get("since_ts")
        try:
            since_ts = float(since_raw) if since_raw else None
        except ValueError:
            return _json({"error": "since_ts must be a number"},
                         status=400)
        return _json(self.monitoring.dump_flightrecorder(
            limit=limit, pinned_only=pinned_only, pin_type=pin_type,
            since_ts=since_ts))

    async def _profile(self, req: Request) -> Response:
        """The engine event timeline as Chrome-trace JSON (Perfetto
        loads it); ``?window_s=`` trims to the trailing window,
        ``?format=events`` returns the raw event dicts."""
        window = req.query.get("window_s")
        try:
            window_s = float(window) if window else None
        except ValueError:
            return _json({"error": "window_s must be a number"},
                         status=400)
        fmt = req.query.get("format", "trace_json")
        if fmt not in ("trace_json", "events"):
            return _json({"error": "format must be trace_json or events"},
                         status=400)
        events = TIMELINE.snapshot(window_s)
        if fmt == "events":
            return _json({"events": [TIMELINE.event_dict(e)
                                     for e in events],
                          "recorded": TIMELINE.recorded})
        return _json(to_chrome_trace(events))

    @staticmethod
    def _profile_body(req: Request) -> Dict[str, Any]:
        try:
            body = json.loads(req.body) if req.body else {}
        except ValueError:
            body = {}
        return body if isinstance(body, dict) else {}

    async def _profile_capture(self, req: Request) -> Response:
        """A bounded torch.profiler window: start, hold ``duration_s``
        (clamped to [0.1, 60]), stop, and answer the log dir and the
        Chrome trace written there.  409 while another capture is
        active; a profiler that fails to start is a 500.  Start and stop
        run on the loop's thread: the profiler's CUPTI client must be
        driven from the thread that registered it."""
        body = self._profile_body(req)
        try:
            duration_s = float(body.get("duration_s", 2.0))
        except (TypeError, ValueError):
            return _json({"error": "duration_s must be a number"},
                         status=400)
        duration_s = max(0.1, min(duration_s, 60.0))
        log_dir = body.get("log_dir", DEFAULT_PROFILE_DIR)
        try:
            started = profiler.start(log_dir)
        except Exception as e:
            return _json({"error": f"profiler start failed: {e}"},
                         status=500)
        if not started:
            return _json({"error": "profiler already active",
                          "log_dir": profiler.active_dir}, status=409)
        try:
            await asyncio.sleep(duration_s)
        finally:
            profiler.stop()
        return _json({"captured": True, "log_dir": log_dir,
                      "trace": profiler.last_trace,
                      "duration_s": duration_s})

    async def _profiler_start(self, req: Request) -> Response:
        log_dir = self._profile_body(req).get("log_dir",
                                              DEFAULT_PROFILE_DIR)
        try:
            started = profiler.start(log_dir)
        except Exception as e:
            return _json({"error": f"profiler start failed: {e}"},
                         status=500)
        if not started:
            return _json({"error": "profiler already active",
                          "log_dir": profiler.active_dir}, status=409)
        return _json({"profiling": True, "log_dir": log_dir})

    async def _profiler_stop(self, req: Request) -> Response:
        log_dir = profiler.stop()
        if log_dir is None:
            return _json({"error": "profiler not active"}, status=409)
        return _json({"profiling": False, "log_dir": log_dir,
                      "trace": profiler.last_trace})

    async def _history(self, req: Request) -> Response:
        """Aligned (ts, value) frames from the history rings:
        ``?series=`` one family (omitted: every live series),
        ``?labels=k=v,k2=v2`` a label subset, ``?window_s=`` the
        lookback (default 600), ``?step_s=`` an absolute epoch grid;
        ``?index=1`` the series catalog instead.  History off answers
        ``{"enabled": false}``."""
        if self.history is None:
            return _json({"enabled": False, "series": []})
        if req.query.get("index") == "1":
            return _json({"enabled": True,
                          "tick_s": self.history.tick_s,
                          "tiers": self.history.store.tiers,
                          "series": self.history.store.index()})
        series = req.query.get("series") or None
        labels: Dict[str, str] = {}
        for pair in (req.query.get("labels") or "").split(","):
            if not pair:
                continue
            if "=" not in pair:
                return _json({"error": "labels must be k=v[,k2=v2...]"},
                             status=400)
            k, v = pair.split("=", 1)
            labels[k] = v
        try:
            window_s = float(req.query.get("window_s", "600"))
            step_raw = req.query.get("step_s")
            step_s = float(step_raw) if step_raw else None
        except ValueError:
            return _json({"error": "window_s and step_s must be numbers"},
                         status=400)
        if window_s <= 0 or (step_s is not None and step_s <= 0):
            return _json({"error": "window_s and step_s must be positive"},
                         status=400)
        return _json({
            "enabled": True,
            "tick_s": self.history.tick_s,
            "ticks": self.history.ticks,
            "series": self.history.store.query(
                series=series, labels=labels or None,
                window_s=window_s, step_s=step_s),
        })

    async def _incidents(self, req: Request) -> Response:
        """``?id=`` one full record (evidence bundle and ranked
        hypotheses); else newest-first summaries (``?state=open``,
        ``?limit=``).  Incidents off answers ``{"enabled": false}``."""
        if self.incidents is None:
            return _json({"enabled": False, "open": 0, "incidents": []})
        incident_id = req.query.get("id")
        if incident_id:
            record = self.incidents.get(incident_id)
            if record is None:
                return _json({"error": f"unknown incident {incident_id}"},
                             status=404)
            return _json(record)
        try:
            limit = int(req.query.get("limit", "50"))
        except ValueError:
            return _json({"error": "limit must be an integer"},
                         status=400)
        return _json(self.incidents.report(
            state=req.query.get("state") or None, limit=limit))

    def _incident_cache_snapshot(self) -> Dict[str, Any]:
        """Evidence provider: the /debug/cache state at incident open
        (a bounded hot-chain census)."""
        return self.cache_snapshot(top_k=5)

    async def _incident_open_fault(self) -> None:
        """The incident worker's fault site, probed before each queued
        trigger (injected here, so observability/ never imports the
        reliability layer)."""
        await faults.inject(fault_sites.OBSERVABILITY_INCIDENT_OPEN)

    async def _history_tick_fault(self) -> None:
        """The history sampler's fault site, probed before every
        tick."""
        await faults.inject(fault_sites.OBSERVABILITY_HISTORY_TICK)

    async def _cache(self, req: Request) -> Response:
        """``?top_k=`` bounds each generative model's hot-chain list
        (default 10); ``?top_cost=K`` appends the attribution ring's
        top-K cost records by device ms and by held blocks
        (``?cost_window_s=`` keeps records finished inside the trailing
        window)."""
        try:
            top_k = int(req.query.get("top_k", "10"))
            top_cost = int(req.query.get("top_cost", "0"))
        except ValueError:
            return _json({"error": "top_k and top_cost must be "
                                   "integers"}, status=400)
        body = self.cache_snapshot(top_k=top_k)
        if top_cost > 0:
            window_raw = req.query.get("cost_window_s")
            try:
                window_s = float(window_raw) if window_raw else None
            except ValueError:
                return _json({"error": "cost_window_s must be a number"},
                             status=400)
            body["top_cost"] = {
                "by_device_ms": attribution.top(
                    top_cost, window_s=window_s, by="device_ms"),
                "by_held_blocks": attribution.top(
                    top_cost, window_s=window_s, by="held_blocks"),
            }
        return _json(body)

    def cache_snapshot(self, top_k: int = 10) -> Dict[str, Any]:
        """The ``/debug/cache`` body under the JAX package's keys: per
        generative model its engine's block (``cache_debug``: prefix
        census, reuse depth, hot chains, pool, speculative), the
        device-memory ledger (``hbm``: the repository's, else the one
        the models book into), the demand-paged residency states
        (``residency``) and per model its host KV tier's block
        (``host_tier``, null when no model has one)."""
        models: Dict[str, Any] = {}
        host_tier: Dict[str, Any] = {}
        hbm = getattr(self.repository, "hbm", None)
        residency = getattr(self.repository, "residency", None)
        for model in self.repository.get_models():
            engine = getattr(model, "engine", None)
            debug = getattr(engine, "cache_debug", None)
            if debug is not None:
                try:
                    models[model.name] = debug(top_k=top_k)
                except Exception:
                    logger.exception("cache debug for %s failed",
                                     model.name)
            tier = getattr(engine, "kv_tier", None)
            if tier is not None:
                host_tier[model.name] = tier.debug()
            if hbm is None:
                hbm = getattr(model, "hbm", None)
        return {"models": models,
                "hbm": hbm.debug() if hbm is not None else None,
                "residency": (residency.debug() if residency is not None
                              else None),
                "host_tier": host_tier or None}

    # -- lifecycle ---------------------------------------------------------
    def register_model(self, model: Model) -> None:
        if not model.name:
            raise ValueError(
                "Failed to register model, model.name must be provided.")
        self.repository.update(model)
        logger.info("Registering model: %s", model.name)

    async def start_async(self, models: List[Model],
                          host: str = "0.0.0.0") -> None:
        """Register `models` and listen; http_port=0 picks a free port,
        which `self.http_port` then holds."""
        for model in models:
            self.register_model(model)
        for service in self.services:
            await service.start()
        # Eviction storms of the demand-paged repository and fault-back
        # storms of the host KV tiers pin into this server's recorder.
        recorder = self.monitoring.flight_recorder
        residency = getattr(self.repository, "residency", None)
        if residency is not None:
            residency.attach_flight_recorder(recorder)
        for _model, _engine, tier in self._kv_tier_models():
            tier.attach_flight_recorder(recorder)
        # KFS_SANITIZE=1: violations pin into this recorder and the stall
        # watchdog heartbeats the loop.  The watchdog is process-global:
        # only the server that started it wires the recorder and stops
        # it, so a second in-process server leaves the first's alone.
        if sanitizer.enabled():
            self._owns_sanitizer_watchdog = sanitizer.start_watchdog(
                asyncio.get_running_loop()) is not None
            if self._owns_sanitizer_watchdog:
                sanitizer.attach_flight_recorder(recorder)
                obs.sanitizer_armed().set(1)
        await self.http_server.start(host, self.http_port)
        self.http_port = self.http_server.port
        if self.grpc_port is not None:
            # grpc and protobuf load only for a server that asks for them.
            from kfserving_tpu_torch.server.grpc_server import GRPCServer

            self.grpc_server = GRPCServer(
                self.dataplane, port=self.grpc_port, host=host,
                metrics=self.metrics, monitoring=self.monitoring)
            await self.grpc_server.start()
            self.grpc_port = self.grpc_server.port
        startup.mark("serving")

    async def drain(self, budget_s: float) -> bool:
        """Wait up to ``budget_s`` for in-flight work (token streams
        included) to finish; True when it did.  Past the budget the
        engines' close delivers a terminal error event to every stream
        still open."""
        loop = asyncio.get_running_loop()
        deadline = loop.time() + budget_s
        while loop.time() < deadline:
            busy = (self._admission is not None
                    and self._admission.active > 0)
            for m in self.repository.get_models():
                gauges = getattr(getattr(m, "engine", None),
                                 "load_gauges", None)
                if gauges is not None:
                    g = gauges()
                    busy = busy or g["active_slots"] + g["pending"] > 0
            if not busy:
                return True
            await asyncio.sleep(0.1)
        return False

    async def stop_async(self) -> None:
        if self._owns_sanitizer_watchdog:
            sanitizer.stop_watchdog()
            # A stopped server's recorder has no debug surface left, and
            # the global reference would keep its object graph alive.
            sanitizer.attach_flight_recorder(None)
            self._owns_sanitizer_watchdog = False
            obs.sanitizer_armed().set(0)
        if self.grpc_server is not None:
            await self.grpc_server.stop()
            self.grpc_server = None
        await self.http_server.stop()
        residency = getattr(self.repository, "residency", None)
        if residency is not None:
            residency.close()
        for service in reversed(self.services):
            await service.stop()

    def start(self, models: List[Model]) -> None:
        """Blocking entry point: serve until SIGINT or SIGTERM, then
        drain in-flight work (``KFS_DRAIN_GRACE_S``), export live KV into
        persistent host tiers, stop, and close the models (their tiers'
        locks release for a successor)."""
        async def _main():
            await self.start_async(models)
            stop = asyncio.Event()
            loop = asyncio.get_running_loop()
            for sig in (signal.SIGINT, signal.SIGTERM):
                loop.add_signal_handler(sig, stop.set)
            await stop.wait()
            grace = _env_float("KFS_DRAIN_GRACE_S", 8.0)
            if grace > 0:
                await self.drain(grace)
            await self.export_kv()
            await self.stop_async()
            for model in self.repository.get_models():
                close = getattr(model, "close", None)
                if close is not None:
                    await close()

        logging.basicConfig(level=logging.INFO)
        asyncio.run(_main())
