"""V2 ("Predict Protocol - Version 2") tensors: JSON and the binary data
extension.

Port of ``kfserving_tpu/protocol/v2.py``:

    $inference_request = {
      "id": $string #optional, "parameters": $parameters #optional,
      "inputs": [ $request_input, ... ],
      "outputs": [ $request_output, ... ] #optional
    }
    $request_input = {"name", "shape", "datatype", "parameters"#opt, "data"}

Every datatype of the V2 spec (BOOL, UINT8-64, INT8-64, FP16-64, BF16,
BYTES; UINT8 carries the image models' uint8 wire).  numpy has no
bfloat16, so a BF16 tensor decodes to a ``torch.bfloat16`` tensor: its
uint16 bit pattern viewed as bfloat16, as the param cache reads bf16
leaves.  It encodes from such a tensor to the same JSON numbers and
wire bytes as the JAX package's codec: the values as float32 numbers in
JSON, the two-byte patterns on the binary wire.  ``named_numpy`` hands
the predictors numpy arrays, a BF16 input widened exactly to float32.

The HTTP **binary data extension** (the HTTP twin of the proto's
``raw_input_contents``): body = JSON header + the raw tensor bytes,
split by the ``Inference-Header-Content-Length`` header; each binary
input declares ``parameters: {"binary_data_size": N}`` and omits
"data".  A request whose parameters ask for ``binary_data_output`` gets
its outputs back the same way.  An image then travels as its bytes, not
as 150,528 numbers of text parsed on the serving loop.
"""

import json
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from kfserving_tpu_torch.protocol.errors import InvalidInput

DTYPES_TO_NUMPY = {
    "BOOL": np.bool_,
    "UINT8": np.uint8,
    "UINT16": np.uint16,
    "UINT32": np.uint32,
    "UINT64": np.uint64,
    "INT8": np.int8,
    "INT16": np.int16,
    "INT32": np.int32,
    "INT64": np.int64,
    "FP16": np.float16,
    "FP32": np.float32,
    "FP64": np.float64,
    "BYTES": np.object_,
}

NUMPY_TO_DTYPES = {np.dtype(v): k for k, v in DTYPES_TO_NUMPY.items()}

# Header names are lower-cased by the port's HTTP layer.
INFERENCE_HEADER_CONTENT_LENGTH = "inference-header-content-length"


def is_bf16(arr: Any) -> bool:
    """A ``torch.bfloat16`` tensor: how the port carries BF16."""
    import torch

    return isinstance(arr, torch.Tensor) and arr.dtype == torch.bfloat16


def bf16_bits(data: Any) -> np.ndarray:
    """The uint16 bit patterns of BF16 data: a bf16 tensor as it is,
    anything else (numbers) rounded to the nearest bfloat16."""
    import torch

    if is_bf16(data):
        return data.detach().cpu().contiguous().view(
            torch.int16).numpy().view(np.uint16)
    values = torch.as_tensor(np.asarray(data, np.float64))
    return values.to(torch.bfloat16).view(torch.int16).numpy().view(
        np.uint16)


def bf16_tensor(bits: np.ndarray):
    """A ``torch.bfloat16`` tensor of uint16 bit patterns."""
    import torch

    return torch.from_numpy(np.array(bits, np.uint16).view(
        np.int16)).view(torch.bfloat16)


def _numpy_dtype(datatype: str):
    try:
        return DTYPES_TO_NUMPY[datatype]
    except KeyError:
        raise InvalidInput(f"Unsupported datatype {datatype}")


def datatype_of(arr: np.ndarray) -> str:
    if is_bf16(arr):
        return "BF16"
    dt = np.dtype(arr.dtype)
    if dt.kind in ("U", "S", "O"):
        return "BYTES"
    try:
        return NUMPY_TO_DTYPES[dt]
    except KeyError:
        raise InvalidInput(f"Unsupported numpy dtype {arr.dtype}")


def frame_raw_bytes(elems) -> bytes:
    """V2 raw BYTES framing: a 4-byte little-endian length before each
    element."""
    out = []
    for e in elems:
        b = (e if isinstance(e, bytes)
             else e.encode() if isinstance(e, str) else bytes(e))
        out.append(struct.pack("<I", len(b)) + b)
    return b"".join(out)


def decode_raw_bytes(raw: bytes) -> List[bytes]:
    """The elements of a V2 raw BYTES tensor (``frame_raw_bytes``)."""
    out: List[bytes] = []
    offset, n = 0, len(raw)
    while offset < n:
        if offset + 4 > n:
            raise InvalidInput("truncated raw BYTES tensor")
        (length,) = struct.unpack_from("<I", raw, offset)
        offset += 4
        if offset + length > n:
            raise InvalidInput("truncated raw BYTES element")
        out.append(raw[offset:offset + length])
        offset += length
    return out


def _raw_of(datatype: str, data: Any) -> bytes:
    """A tensor's bytes on the binary wire."""
    if datatype == "BYTES":
        return frame_raw_bytes(
            e if isinstance(e, bytes) else str(e).encode()
            for e in np.asarray(data, np.object_).ravel())
    if datatype == "BF16":
        return bf16_bits(data).tobytes()
    return np.ascontiguousarray(
        np.asarray(data, dtype=_numpy_dtype(datatype))).tobytes()


class InferInput:
    """One named input tensor of a V2 inference request."""

    def __init__(self, name: str, shape: List[int], datatype: str,
                 data: Any, parameters: Optional[Dict] = None,
                 raw: Optional[bytes] = None):
        self.name = name
        self.shape = list(shape)
        self.datatype = datatype
        self.data = data
        self.parameters = parameters or {}
        self.raw = raw

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "InferInput":
        for required in ("name", "shape", "datatype"):
            if required not in d:
                raise InvalidInput(
                    f'Input tensor missing required field "{required}"')
        params = d.get("parameters") or {}
        if "data" not in d and not params.get("binary_data_size"):
            raise InvalidInput('Input tensor missing required field "data"')
        if not isinstance(d["shape"], list):
            raise InvalidInput('Input tensor "shape" must be a list')
        return cls(d["name"], d["shape"], d["datatype"], d.get("data"),
                   params)

    @property
    def binary_data_size(self) -> int:
        return int(self.parameters.get("binary_data_size") or 0)

    def as_numpy(self) -> np.ndarray:
        """The tensor as a numpy array (BF16: a ``torch.bfloat16``
        tensor)."""
        bf16 = self.datatype == "BF16"
        dtype = np.uint16 if bf16 else _numpy_dtype(self.datatype)
        if self.raw is not None:
            if self.datatype == "BYTES":
                arr = np.array(decode_raw_bytes(bytes(self.raw)),
                               dtype=np.object_)
            else:
                try:
                    arr = np.frombuffer(self.raw, dtype=dtype)
                except ValueError as e:
                    raise InvalidInput(
                        f"Input {self.name}: binary data of "
                        f"{len(self.raw)} bytes does not fit datatype "
                        f"{self.datatype}: {e}")
        elif self.data is None:
            # binary_data_size declared on a plain JSON body: a client
            # error, not a server fault.
            raise InvalidInput(
                f"Input {self.name} declares binary_data_size but the "
                f"request has no binary body (missing "
                f"Inference-Header-Content-Length?)")
        elif self.datatype == "BYTES":
            arr = np.array(self.data, dtype=np.object_)
        elif bf16:
            arr = bf16_bits(self.data)
        else:
            arr = np.asarray(self.data, dtype=dtype)
        try:
            arr = arr.reshape(self.shape)
        except ValueError:
            raise InvalidInput(
                f"Input {self.name}: data of size {arr.size} does not match "
                f"shape {self.shape}")
        return bf16_tensor(arr) if bf16 else arr

    def to_dict(self) -> Dict[str, Any]:
        out = {"name": self.name, "shape": self.shape,
               "datatype": self.datatype, "data": self.data}
        if self.parameters:
            out["parameters"] = self.parameters
        return out


class InferRequest:
    """A decoded V2 inference request."""

    def __init__(self, inputs: List[InferInput], id: Optional[str] = None,
                 parameters: Optional[Dict] = None,
                 outputs: Optional[List[Dict]] = None):
        self.inputs = inputs
        self.id = id
        self.parameters = parameters or {}
        self.outputs = outputs or []

    @classmethod
    def from_dict(cls, body: Dict[str, Any]) -> "InferRequest":
        if not isinstance(body, dict):
            raise InvalidInput("V2 inference request must be a JSON object")
        if "inputs" not in body or not isinstance(body["inputs"], list):
            raise InvalidInput('Expected "inputs" to be a list')
        inputs = [InferInput.from_dict(i) for i in body["inputs"]]
        return cls(inputs, body.get("id"), body.get("parameters"),
                   body.get("outputs"))

    @classmethod
    def from_binary(cls, body: bytes, header_length: int) -> "InferRequest":
        """Decode a binary-extension request: the JSON header in
        body[:header_length], then each binary input's raw bytes in
        input order."""
        if header_length <= 0 or header_length > len(body):
            raise InvalidInput(
                f"Inference-Header-Content-Length {header_length} out of "
                f"range for body of {len(body)} bytes")
        try:
            header = json.loads(body[:header_length])
        except ValueError as e:
            raise InvalidInput(f"invalid V2 binary header: {e}")
        req = cls.from_dict(header)
        offset = header_length
        view = memoryview(body)
        for inp in req.inputs:
            size = inp.binary_data_size
            if not size:
                continue
            if offset + size > len(body):
                raise InvalidInput(
                    f"binary data for input {inp.name!r} overruns the "
                    f"request body")
            # A view of the request buffer: np.frombuffer in as_numpy
            # reads it in place.
            inp.raw = view[offset:offset + size]
            offset += size
        if offset != len(body):
            raise InvalidInput(
                f"{len(body) - offset} trailing bytes after the last "
                f"binary input")
        return req

    def named_numpy(self) -> Dict[str, np.ndarray]:
        """Each input as a numpy array.  numpy has no bfloat16, so a BF16
        input widens to float32 here (exactly; the JAX package's
        evaluators and models widen their bfloat16 arrays too), where
        ``InferInput.as_numpy`` keeps the ``torch.bfloat16`` tensor."""
        out = {}
        for inp in self.inputs:
            arr = inp.as_numpy()
            out[inp.name] = arr.float().numpy() if is_bf16(arr) else arr
        return out

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"inputs": [i.to_dict() for i in self.inputs]}
        if self.id is not None:
            out["id"] = self.id
        if self.parameters:
            out["parameters"] = self.parameters
        if self.outputs:
            out["outputs"] = self.outputs
        return out


def make_binary_request(tensors: Dict[str, np.ndarray],
                        id: Optional[str] = None,
                        binary_output: bool = False) -> Tuple[bytes, int]:
    """Client-side encoder of the binary extension: (body, header
    length), to POST with ``Inference-Header-Content-Length`` set.
    ``binary_output`` asks for the outputs as raw bytes too."""
    inputs, raws = [], []
    for name, arr in tensors.items():
        if not is_bf16(arr):
            arr = np.ascontiguousarray(arr)
        datatype = datatype_of(arr)
        raw = _raw_of(datatype, arr)
        raws.append(raw)
        inputs.append({"name": name, "shape": list(arr.shape),
                       "datatype": datatype,
                       "parameters": {"binary_data_size": len(raw)}})
    header: Dict[str, Any] = {"inputs": inputs}
    if binary_output:
        header["parameters"] = {"binary_data_output": True}
    if id is not None:
        header["id"] = id
    hbytes = json.dumps(header).encode()
    return hbytes + b"".join(raws), len(hbytes)


def encode_binary_response(response: Dict[str, Any]) -> Tuple[bytes, int]:
    """Binary-extension response: the outputs' data as raw bytes after
    the JSON header.  Returns (body, header length)."""
    header = dict(response)
    outputs, raws = [], []
    for out in response.get("outputs", []):
        raw = _raw_of(out["datatype"], out.get("data"))
        entry = {k: v for k, v in out.items() if k != "data"}
        params = dict(entry.get("parameters") or {})
        params["binary_data_size"] = len(raw)
        entry["parameters"] = params
        outputs.append(entry)
        raws.append(raw)
    header["outputs"] = outputs
    hbytes = json.dumps(header).encode()
    return hbytes + b"".join(raws), len(hbytes)


def decode_binary_response(body: bytes,
                           header_length: int) -> Dict[str, Any]:
    """Client-side decode of a binary-extension response: the outputs'
    data come back as numpy arrays."""
    if header_length <= 0 or header_length > len(body):
        raise InvalidInput(
            f"response header length {header_length} out of range")
    resp = json.loads(body[:header_length])
    offset = header_length
    for out in resp.get("outputs", []):
        size = int((out.get("parameters") or {})
                   .get("binary_data_size") or 0)
        if not size:
            continue
        if offset + size > len(body):
            raise InvalidInput(
                f"binary output {out.get('name')!r} overruns the "
                f"response body: need {offset + size} bytes, "
                f"have {len(body)}")
        raw = body[offset:offset + size]
        offset += size
        if out["datatype"] == "BYTES":
            out["data"] = decode_raw_bytes(raw)
        elif out["datatype"] == "BF16":
            out["data"] = bf16_tensor(
                np.frombuffer(raw, np.uint16).reshape(out["shape"]))
        else:
            out["data"] = np.frombuffer(
                raw, dtype=_numpy_dtype(out["datatype"])
            ).reshape(out["shape"])
    return resp


def tensor_to_output(name: str, arr: np.ndarray) -> Dict[str, Any]:
    """Encode a numpy array (or a bfloat16 tensor) as a V2 response
    output tensor."""
    if is_bf16(arr):
        return {"name": name, "shape": list(arr.shape), "datatype": "BF16",
                "data": bf16_tensor(bf16_bits(arr)).float().reshape(
                    -1).tolist()}
    arr = np.asarray(arr)
    datatype = datatype_of(arr)
    if datatype == "BYTES":
        data = [x.decode() if isinstance(x, bytes) else str(x)
                for x in arr.ravel().tolist()]
    else:
        data = arr.ravel().tolist()
    return {"name": name, "shape": list(arr.shape), "datatype": datatype,
            "data": data}


def make_response(model_name: str, outputs: Dict[str, np.ndarray],
                  id: Optional[str] = None,
                  model_version: Optional[str] = None) -> Dict[str, Any]:
    resp: Dict[str, Any] = {
        "model_name": model_name,
        "outputs": [tensor_to_output(k, v) for k, v in outputs.items()],
    }
    if model_version is not None:
        resp["model_version"] = model_version
    if id is not None:
        resp["id"] = id
    return resp
