"""Minimal Avro binary codec (schema-driven decode and encode).

Port of ``kfserving_tpu/protocol/avro.py``, unchanged in behaviour.  The
data plane hands an avro-encoded CloudEvent's raw bytes through to the
model (``Model.preprocess``), which decodes them against its schema.
This implements the subset of the Avro 1.x binary encoding needed to
read and write datum payloads against a JSON schema, without the
``avro`` library:

- primitives: null, boolean, int, long (zigzag varint), float, double,
  bytes, string
- complex: record, enum, array, map, union, fixed

No object-container files (no sync markers or block compression): a
CloudEvent carries bare datum bytes.  Schemas are plain parsed-JSON
values (dict / list / str), as ``avro.schema.parse`` takes them.
"""

import io
import json
import struct
from typing import Any, Dict, List, Union

Schema = Union[str, Dict[str, Any], List[Any]]

PRIMITIVES = {"null", "boolean", "int", "long", "float", "double",
              "bytes", "string"}


def parse_schema(source: Union[str, bytes, Schema]) -> Schema:
    """Accept a JSON string (like avro.schema.parse) or pre-parsed JSON.
    A bare primitive name ("long") is valid shorthand for its schema."""
    if isinstance(source, bytes):
        source = source.decode("utf-8")
    if isinstance(source, str):
        stripped = source.strip()
        if stripped in PRIMITIVES:
            return stripped
        return json.loads(stripped)
    return source


def _named_types(schema: Schema, registry: Dict[str, Schema]) -> None:
    """Index named types (record/enum/fixed) so schemas can self-reference."""
    if isinstance(schema, dict):
        t = schema.get("type")
        name = schema.get("name")
        if name and t in ("record", "enum", "fixed"):
            ns = schema.get("namespace")
            registry[name] = schema
            if ns:
                registry[f"{ns}.{name}"] = schema
        if t == "record":
            for f in schema.get("fields", []):
                _named_types(f.get("type"), registry)
        elif t == "array":
            _named_types(schema.get("items"), registry)
        elif t == "map":
            _named_types(schema.get("values"), registry)
    elif isinstance(schema, list):
        for branch in schema:
            _named_types(branch, registry)


class _Reader:
    def __init__(self, buf: bytes):
        self._io = io.BytesIO(buf)

    def read(self, n: int) -> bytes:
        out = self._io.read(n)
        if len(out) != n:
            raise ValueError("truncated avro payload")
        return out

    def read_long(self) -> int:
        """Zigzag-encoded variable-length integer (int and long alike)."""
        shift, accum = 0, 0
        while True:
            b = self.read(1)[0]
            accum |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
            if shift > 70:
                raise ValueError("varint too long for avro long")
        return (accum >> 1) ^ -(accum & 1)

    def read_bytes(self) -> bytes:
        n = self.read_long()
        if n < 0:
            raise ValueError("negative avro bytes length")
        return self.read(n)


class _Writer:
    def __init__(self):
        self._io = io.BytesIO()

    def write(self, b: bytes) -> None:
        self._io.write(b)

    def write_long(self, value: int) -> None:
        datum = (value << 1) ^ (value >> 63)
        while True:
            chunk = datum & 0x7F
            datum >>= 7
            if datum:
                self._io.write(bytes([chunk | 0x80]))
            else:
                self._io.write(bytes([chunk]))
                break

    def write_bytes(self, value: bytes) -> None:
        self.write_long(len(value))
        self._io.write(value)

    def getvalue(self) -> bytes:
        return self._io.getvalue()


def _schema_type(schema: Schema) -> str:
    if isinstance(schema, str):
        return schema
    if isinstance(schema, list):
        return "union"
    return schema["type"]


def _read_datum(r: _Reader, schema: Schema,
                registry: Dict[str, Schema]) -> Any:
    if isinstance(schema, str) and schema not in PRIMITIVES:
        schema = registry[schema]  # named-type reference
    t = _schema_type(schema)
    if t == "null":
        return None
    if t == "boolean":
        return r.read(1) != b"\x00"
    if t in ("int", "long"):
        return r.read_long()
    if t == "float":
        return struct.unpack("<f", r.read(4))[0]
    if t == "double":
        return struct.unpack("<d", r.read(8))[0]
    if t == "bytes":
        return r.read_bytes()
    if t == "string":
        return r.read_bytes().decode("utf-8")
    if t == "union":
        branches = schema if isinstance(schema, list) else schema["type"]
        idx = r.read_long()
        if not 0 <= idx < len(branches):
            raise ValueError(f"avro union index {idx} out of range")
        return _read_datum(r, branches[idx], registry)
    if t == "record":
        return {f["name"]: _read_datum(r, f["type"], registry)
                for f in schema["fields"]}
    if t == "enum":
        idx = r.read_long()
        symbols = schema["symbols"]
        if not 0 <= idx < len(symbols):
            raise ValueError(f"avro enum index {idx} out of range")
        return symbols[idx]
    if t == "fixed":
        return r.read(schema["size"])
    if t == "array":
        out = []
        while True:
            count = r.read_long()
            if count == 0:
                break
            if count < 0:  # block with byte-size prefix
                count = -count
                r.read_long()
            for _ in range(count):
                out.append(_read_datum(r, schema["items"], registry))
        return out
    if t == "map":
        out = {}
        while True:
            count = r.read_long()
            if count == 0:
                break
            if count < 0:
                count = -count
                r.read_long()
            for _ in range(count):
                key = r.read_bytes().decode("utf-8")
                out[key] = _read_datum(r, schema["values"], registry)
        return out
    raise ValueError(f"unsupported avro type: {t!r}")


def _union_branch(value: Any, branches: List[Schema]) -> int:
    """Pick the first union branch whose type matches the python value."""
    for i, b in enumerate(branches):
        t = _schema_type(b)
        if value is None and t == "null":
            return i
        if isinstance(value, bool) and t == "boolean":
            return i
        if isinstance(value, int) and not isinstance(value, bool) \
                and t in ("int", "long"):
            return i
        if isinstance(value, float) and t in ("float", "double"):
            return i
        if isinstance(value, str) and t in ("string", "enum"):
            return i
        if isinstance(value, (bytes, bytearray)) and t in ("bytes", "fixed"):
            return i
        if isinstance(value, dict) and t in ("record", "map"):
            return i
        if isinstance(value, list) and t == "array":
            return i
    raise ValueError(f"no avro union branch matches {type(value).__name__}")


def _write_datum(w: _Writer, value: Any, schema: Schema,
                 registry: Dict[str, Schema]) -> None:
    if isinstance(schema, str) and schema not in PRIMITIVES:
        schema = registry[schema]
    t = _schema_type(schema)
    if t == "null":
        return
    if t == "boolean":
        w.write(b"\x01" if value else b"\x00")
    elif t in ("int", "long"):
        w.write_long(value)
    elif t == "float":
        w.write(struct.pack("<f", value))
    elif t == "double":
        w.write(struct.pack("<d", value))
    elif t == "bytes":
        w.write_bytes(bytes(value))
    elif t == "string":
        w.write_bytes(value.encode("utf-8"))
    elif t == "union":
        branches = schema if isinstance(schema, list) else schema["type"]
        idx = _union_branch(value, branches)
        w.write_long(idx)
        _write_datum(w, value, branches[idx], registry)
    elif t == "record":
        for f in schema["fields"]:
            _write_datum(w, value[f["name"]], f["type"], registry)
    elif t == "enum":
        w.write_long(schema["symbols"].index(value))
    elif t == "fixed":
        if len(value) != schema["size"]:
            raise ValueError("avro fixed size mismatch")
        w.write(bytes(value))
    elif t == "array":
        if value:
            w.write_long(len(value))
            for item in value:
                _write_datum(w, item, schema["items"], registry)
        w.write_long(0)
    elif t == "map":
        if value:
            w.write_long(len(value))
            for key, item in value.items():
                w.write_bytes(key.encode("utf-8"))
                _write_datum(w, item, schema["values"], registry)
        w.write_long(0)
    else:
        raise ValueError(f"unsupported avro type: {t!r}")


def decode(payload: bytes, schema: Union[str, bytes, Schema]) -> Any:
    """Decode one binary-encoded datum against a schema."""
    schema = parse_schema(schema)
    registry: Dict[str, Schema] = {}
    _named_types(schema, registry)
    r = _Reader(payload)
    return _read_datum(r, schema, registry)


def encode(value: Any, schema: Union[str, bytes, Schema]) -> bytes:
    """Binary-encode one datum against a schema."""
    schema = parse_schema(schema)
    registry: Dict[str, Schema] = {}
    _named_types(schema, registry)
    w = _Writer()
    _write_datum(w, value, schema, registry)
    return w.getvalue()
