"""Structured JSON access log: one line per request.

Port of ``kfserving_tpu/observability/accesslog.py``.  Each line is a
single JSON object on the ``kfserving_tpu_torch.access`` logger, so
operators can route it (file, stdout, collector) with standard logging
config and parse it without regexes::

    {"component": "server", "trace_id": "4bf9...", "model": "m",
     "verb": "predict", "status": 200, "latency_ms": 12.3,
     "stages": {"decode": 0.1, "infer": 11.9, "encode": 0.2},
     "tokens_in": 17, "tokens_out": 64}

Fields with value None are dropped; emission never raises (a log
failure must not fail the request).
"""

import json
import logging

logger = logging.getLogger("kfserving_tpu_torch.access")


def log_access(component: str, **fields) -> None:
    record = {"component": component}
    record.update((k, v) for k, v in fields.items() if v is not None)
    try:
        logger.info("%s", json.dumps(record, default=str,
                                     sort_keys=True))
    except Exception:  # never let telemetry fail the request
        logger.debug("access log emission failed", exc_info=True)
