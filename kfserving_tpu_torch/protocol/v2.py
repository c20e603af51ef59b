"""V2 ("Predict Protocol - Version 2") JSON tensors.

Port of the JSON part of ``kfserving_tpu/protocol/v2.py``:

    $inference_request = {
      "id": $string #optional, "parameters": $parameters #optional,
      "inputs": [ $request_input, ... ],
      "outputs": [ $request_output, ... ] #optional
    }
    $request_input = {"name", "shape", "datatype", "parameters"#opt, "data"}

The numeric datatypes of the V2 spec (BOOL, UINT8-64, INT8-64, FP16-64;
UINT8 carries the image models' uint8 wire).  BYTES, BF16 and the binary
data extension are not ported yet.
"""

from typing import Any, Dict, List, Optional

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
}

NUMPY_TO_DTYPES = {np.dtype(v): k for k, v in DTYPES_TO_NUMPY.items()}


def _numpy_dtype(datatype: str):
    try:
        return DTYPES_TO_NUMPY[datatype]
    except KeyError:
        raise InvalidInput(f"Unsupported datatype {datatype}")


def datatype_of(arr: np.ndarray) -> str:
    try:
        return NUMPY_TO_DTYPES[np.dtype(arr.dtype)]
    except KeyError:
        raise InvalidInput(f"Unsupported numpy dtype {arr.dtype}")


class InferInput:
    """One named input tensor of a V2 inference request."""

    def __init__(self, name: str, shape: List[int], datatype: str,
                 data: Any, parameters: Optional[Dict] = None):
        self.name = name
        self.shape = list(shape)
        self.datatype = datatype
        self.data = data
        self.parameters = parameters or {}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "InferInput":
        for required in ("name", "shape", "datatype", "data"):
            if required not in d:
                raise InvalidInput(
                    f'Input tensor missing required field "{required}"')
        if not isinstance(d["shape"], list):
            raise InvalidInput('Input tensor "shape" must be a list')
        return cls(d["name"], d["shape"], d["datatype"], d["data"],
                   d.get("parameters"))

    def as_numpy(self) -> np.ndarray:
        arr = np.asarray(self.data, dtype=_numpy_dtype(self.datatype))
        try:
            return arr.reshape(self.shape)
        except ValueError:
            raise InvalidInput(
                f"Input {self.name}: data of size {arr.size} does not match "
                f"shape {self.shape}")

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

    def named_numpy(self) -> Dict[str, np.ndarray]:
        return {i.name: i.as_numpy() for i in self.inputs}

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"inputs": [i.to_dict() for i in self.inputs]}
        if self.id is not None:
            out["id"] = self.id
        if self.parameters:
            out["parameters"] = self.parameters
        if self.outputs:
            out["outputs"] = self.outputs
        return out


def tensor_to_output(name: str, arr: np.ndarray) -> Dict[str, Any]:
    """Encode a numpy array as a V2 response output tensor."""
    arr = np.asarray(arr)
    return {"name": name, "shape": list(arr.shape),
            "datatype": datatype_of(arr), "data": arr.ravel().tolist()}


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
