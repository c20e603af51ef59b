"""Minimal CloudEvents v1.0 support (binary and structured HTTP modes).

Port of ``kfserving_tpu/protocol/cloudevents.py``, unchanged: the data
plane accepts CloudEvents-wrapped predict payloads and echoes the
response in the request's framing, without the ``cloudevents`` SDK:

- binary mode: attributes ride ``ce-*`` HTTP headers, data is the raw
  body;
- structured mode: the body is a JSON envelope with a ``data`` member
  (content-type application/cloudevents+json).
"""

import json
import time
import uuid
from typing import Any, Dict, Optional, Tuple

REQUIRED_ATTRS = ("id", "source", "specversion", "type")
STRUCTURED_CONTENT_TYPE = "application/cloudevents+json"


class CloudEvent:
    def __init__(self, attributes: Dict[str, str], data: Any):
        self.attributes = dict(attributes)
        self.attributes.setdefault("specversion", "1.0")
        self.attributes.setdefault("id", str(uuid.uuid4()))
        self.data = data

    def __getitem__(self, key: str) -> str:
        return self.attributes[key]


def is_structured(headers: Dict[str, str]) -> bool:
    ctype = headers.get("content-type", "")
    return ctype.startswith(STRUCTURED_CONTENT_TYPE)


def has_ce_headers(headers: Dict[str, str]) -> bool:
    """Binary-header sniff matching the SDK's has_binary_headers: the spec's
    required attributes present as ce- headers."""
    return ("ce-specversion" in headers and "ce-source" in headers
            and "ce-type" in headers and "ce-id" in headers)


def from_http(headers: Dict[str, str], body: bytes) -> CloudEvent:
    """Decode either binary or structured mode from an HTTP request."""
    if is_structured(headers):
        envelope = json.loads(body.decode("utf-8"))
        missing = [a for a in REQUIRED_ATTRS if a not in envelope]
        if missing:
            raise ValueError(f"CloudEvent missing required fields: {missing}")
        data = envelope.get("data")
        if data is None and "data_base64" in envelope:
            import base64

            data = base64.b64decode(envelope["data_base64"])
        attrs = {k: v for k, v in envelope.items()
                 if k not in ("data", "data_base64")}
        return CloudEvent(attrs, data)
    # binary mode: the content-type HTTP header carries the datacontenttype
    # attribute (CE spec HTTP binding §3.1); keep a "content-type" alias for
    # reference-SDK attribute parity (test_server.py:146-149 asserts both).
    attrs = {k[3:]: v for k, v in headers.items() if k.startswith("ce-")}
    missing = [a for a in REQUIRED_ATTRS if a not in attrs]
    if missing:
        raise ValueError(f"CloudEvent missing required fields: {missing}")
    ctype = headers.get("content-type")
    if ctype:
        attrs.setdefault("datacontenttype", ctype)
        attrs.setdefault("content-type", ctype)
    return CloudEvent(attrs, body)


def _np_default(obj):
    """numpy arrays (native-codec fast path responses) serialize as lists."""
    tolist = getattr(obj, "tolist", None)
    if tolist is not None:
        return tolist()
    raise TypeError(
        f"Object of type {type(obj).__name__} is not JSON serializable")


def ce_time_now() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%S.000Z", time.gmtime())


def to_binary(event: CloudEvent) -> Tuple[Dict[str, str], bytes]:
    headers = {f"ce-{k}": str(v) for k, v in event.attributes.items()
               if k != "content-type"}
    headers["ce-time"] = ce_time_now()
    # datacontenttype rides the plain content-type header too (CE HTTP
    # binding; reference response asserts both, test_server.py:257-263).
    dct = event.attributes.get("datacontenttype")
    if dct:
        headers["content-type"] = dct
    data = event.data
    if isinstance(data, bytes):
        body = data
    else:
        body = json.dumps(data, default=_np_default).encode("utf-8")
        headers.setdefault("content-type", "application/json")
    return headers, body


def to_structured(event: CloudEvent) -> Tuple[Dict[str, str], bytes]:
    envelope = dict(event.attributes)
    envelope["time"] = ce_time_now()
    data = event.data
    if isinstance(data, bytes):
        try:
            envelope["data"] = json.loads(data.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            import base64

            envelope["data_base64"] = base64.b64encode(data).decode("ascii")
    else:
        envelope["data"] = data
    return ({"content-type": STRUCTURED_CONTENT_TYPE},
            json.dumps(envelope, default=_np_default).encode("utf-8"))


def new_event(event_type: str, source: str, data: Any,
              extensions: Optional[Dict[str, str]] = None) -> CloudEvent:
    """A fresh event (a new id) of ``event_type`` from ``source``."""
    attrs = {"type": event_type, "source": source, "specversion": "1.0",
             "id": str(uuid.uuid4())}
    if extensions:
        attrs.update(extensions)
    return CloudEvent(attrs, data)
