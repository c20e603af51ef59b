"""Payload logger: tee request/response bodies as CloudEvents to a sink.

Port of ``kfserving_tpu/agent/logger.py``, with the reference's
semantics:

- event types ``org.kubeflow.serving.inference.request`` / ``.response``;
- CE extensions inferenceservicename / namespace / endpoint / component;
- a bounded queue (100) drained by a fixed worker pool (5);
- log modes all | request | response.

The logger attaches to ``ModelServer.request_hooks``, so the tee happens
after the response is computed.  A full queue drops the event and counts
it instead of blocking serving.  Events go out in binary CloudEvents mode
(attributes as ``ce-`` headers) through the port's ``server/client.py``
with a connection each: an event is sent once, and a failed send is
counted, never re-sent.
"""

import asyncio
import json
import logging
import uuid
from enum import Enum
from typing import Optional

from kfserving_tpu_torch.observability import metrics as obs
from kfserving_tpu_torch.server.client import HTTPClient
from kfserving_tpu_torch.tracing import current_request_id

logger = logging.getLogger("kfserving_tpu_torch.agent.logger")

CE_TYPE_REQUEST = "org.kubeflow.serving.inference.request"
CE_TYPE_RESPONSE = "org.kubeflow.serving.inference.response"
DEFAULT_WORKERS = 5   # reference dispatcher.go:25
QUEUE_SIZE = 100      # reference dispatcher.go:30
SEND_TIMEOUT_S = 30.0


class LogMode(str, Enum):
    all = "all"
    request = "request"
    response = "response"


class RequestLogger:
    """Async CloudEvents tee.  Call start() inside a running loop; attach()
    wires it into a ModelServer."""

    def __init__(self, log_url: str, source_uri: str = "",
                 log_mode: LogMode = LogMode.all,
                 inference_service: str = "", namespace: str = "",
                 endpoint: str = "", component: str = "predictor",
                 workers: int = DEFAULT_WORKERS,
                 queue_size: int = QUEUE_SIZE):
        self.log_url = log_url
        self.source_uri = source_uri
        self.log_mode = LogMode(log_mode)
        self.inference_service = inference_service
        self.namespace = namespace
        self.endpoint = endpoint
        self.component = component
        self.workers = workers
        self.queue: asyncio.Queue = asyncio.Queue(maxsize=queue_size)
        self.dropped = 0
        self.sent = 0
        self.failed = 0
        self._tasks = []
        self._client: Optional[HTTPClient] = None

    # -- lifecycle ---------------------------------------------------------
    async def start(self):
        self._client = HTTPClient(timeout=SEND_TIMEOUT_S, keepalive=False)
        self._tasks = [asyncio.create_task(self._worker())
                       for _ in range(self.workers)]

    async def stop(self):
        for t in self._tasks:
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks = []
        if self._client is not None:
            await self._client.close()
            self._client = None

    # -- hot path ----------------------------------------------------------
    def log(self, model: str, verb: str, kind: str, payload: bytes,
            request_id: Optional[str] = None, status: int = 200):
        """Enqueue one event; never blocks the serving path."""
        if self.log_mode == LogMode.request and kind != "request":
            return
        if self.log_mode == LogMode.response and kind != "response":
            return
        event = {
            "specversion": "1.0",
            "id": request_id or str(uuid.uuid4()),
            "type": (CE_TYPE_REQUEST if kind == "request"
                     else CE_TYPE_RESPONSE),
            "source": self.source_uri or f"http://localhost/models/{model}",
            "datacontenttype": "application/json",
            "inferenceservicename": self.inference_service,
            "namespace": self.namespace,
            "endpoint": self.endpoint,
            "component": self.component,
            "model": model,
            "verb": verb,
            "status": str(status),
        }
        try:
            self.queue.put_nowait((event, payload))
        except asyncio.QueueFull:
            if self.dropped == 0:
                # Warn once: the registry counter is the ongoing signal.
                logger.warning(
                    "payload log queue full (size %d): dropping "
                    "events (kfserving_tpu_payload_log_total"
                    "{outcome=\"dropped\"} counts further drops)",
                    self.queue.maxsize)
            self.dropped += 1
            obs.payload_log_total().labels(outcome="dropped").inc()
        obs.payload_log_queued().set(self.queue.qsize())

    def attach(self, server) -> None:
        """Hook into a ModelServer: tees both directions per request with
        a shared CE id, the request's active trace id (so a payload links
        to its spans at /debug/traces); a fresh uuid when untraced."""
        def hook(name, verb, req, resp, latency_ms):
            rid = current_request_id.get() or str(uuid.uuid4())
            status = resp.status if resp is not None else 200
            self.log(name, verb, "request", req.body, request_id=rid,
                     status=status)
            if resp is not None:
                self.log(name, verb, "response", resp.body,
                         request_id=rid, status=status)

        server.request_hooks.append(hook)

    # -- workers -----------------------------------------------------------
    async def _worker(self):
        while True:
            event, payload = await self.queue.get()
            try:
                await self._send(event, payload)
                self.sent += 1
                obs.payload_log_total().labels(outcome="sent").inc()
            except asyncio.CancelledError:
                raise
            except Exception as e:
                self.failed += 1
                obs.payload_log_total().labels(outcome="failed").inc()
                logger.warning("log sink send failed: %s", e)
            finally:
                self.queue.task_done()
                obs.payload_log_queued().set(self.queue.qsize())

    def _headers(self, event: dict) -> dict:
        """Binary CloudEvents encoding: attributes -> ce- headers."""
        headers = {"content-type": event["datacontenttype"]}
        for key in ("specversion", "id", "type", "source",
                    "inferenceservicename", "namespace", "endpoint",
                    "component", "model", "verb", "status"):
            if event.get(key):
                headers[f"ce-{key}"] = event[key]
        return headers

    async def _send(self, event: dict, payload: bytes):
        if isinstance(payload, str):
            payload = payload.encode("utf-8")
        status, _, _ = await self._client.request(
            "POST", self.log_url, body=payload or b"",
            headers=self._headers(event))
        if status >= 400:
            raise RuntimeError(f"sink returned {status}")

    def stats(self) -> dict:
        """Instance snapshot; the same numbers export as
        ``kfserving_tpu_payload_log_total{outcome}`` and
        ``kfserving_tpu_payload_log_queued``."""
        return {"sent": self.sent, "failed": self.failed,
                "dropped": self.dropped, "queued": self.queue.qsize()}


def structured_event(event: dict, payload: bytes) -> dict:
    """Structured-mode encoding helper (tests / alternative sinks)."""
    data: object = payload
    try:
        data = json.loads(payload)
    except Exception:
        if isinstance(payload, (bytes, bytearray)):
            data = payload.decode("utf-8", "replace")
    return {**event, "data": data}
