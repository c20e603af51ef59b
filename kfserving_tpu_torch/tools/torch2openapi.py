"""torch2openapi: OpenAPI 3.0 request/response schemas from a served
model of the port.

Port of ``kfserving_tpu/tools/jax2openapi.py`` (the reference's
tf2openapi analogue).  Shapes and dtypes come from running the module on
``torch.device("meta")``: tensors with a shape and a dtype and no
storage, so no weight is allocated and no FLOP runs, on the card or off
it, and the schema reflects what the served module computes.  The
document is the JAX tool's, key for key.

Usage:
    python -m kfserving_tpu_torch.tools.torch2openapi --model_dir DIR \
        [--name N]
    python -m kfserving_tpu_torch.tools.torch2openapi \
        --architecture resnet50

Emits an OpenAPI 3.0 document with the V1 predict path (instances as
nested fixed-length arrays mirroring the instance shape) and the V2
infer path (tensor objects with shape/datatype pinned to the model's).
"""

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

import numpy as np
import torch

_JSON_TYPES = {
    "f": "number", "i": "integer", "u": "integer", "b": "boolean",
}


def _leaf_type(dtype) -> str:
    kind = np.dtype(dtype).kind if np.dtype(dtype).kind in "fiub" else "f"
    return _JSON_TYPES[kind]


def array_schema(shape: List[Any], dtype) -> Dict[str, Any]:
    """Nested fixed-size array schema for one instance (no batch dim).
    Dynamic dims (None / -1) become unconstrained arrays."""
    if not shape:
        return {"type": _leaf_type(dtype)}
    inner = array_schema(list(shape[1:]), dtype)
    out: Dict[str, Any] = {"type": "array", "items": inner}
    dim = shape[0]
    if isinstance(dim, int) and dim > 0:
        out["minItems"] = dim
        out["maxItems"] = dim
    return out


def _v2_datatype(dtype) -> str:
    from kfserving_tpu_torch.protocol.v2 import NUMPY_TO_DTYPES

    if dtype == torch.bfloat16:
        return "BF16"
    return NUMPY_TO_DTYPES.get(np.dtype(dtype), "FP32")


def _numpy_dtype(dtype) -> Any:
    """A numpy dtype for a torch or numpy dtype; bfloat16, which numpy
    lacks, stays the torch dtype (``_v2_datatype`` names it BF16)."""
    if dtype == torch.bfloat16:
        return dtype
    if isinstance(dtype, torch.dtype):
        return np.dtype(str(dtype).removeprefix("torch."))
    return np.dtype(dtype)


def _shapes_of(tree) -> List[Dict[str, Any]]:
    """Flatten a forward's inputs or outputs to name/shape/dtype: a
    dict keeps its own names in its own order, a tensor or a sequence
    of tensors becomes output_0, output_1, ..."""
    if isinstance(tree, dict):
        items = list(tree.items())
    else:
        leaves = list(tree) if isinstance(tree, (list, tuple)) else [tree]
        items = [(f"output_{i}", leaf) for i, leaf in enumerate(leaves)]
    return [{"name": n, "shape": [int(s) for s in leaf.shape],
             "dtype": _numpy_dtype(leaf.dtype)} for n, leaf in items]


def _meta(example: np.ndarray) -> torch.Tensor:
    return torch.empty(example.shape, device="meta",
                       dtype=torch.from_numpy(
                           np.zeros((), example.dtype)).dtype)


def model_signature(architecture: str,
                    arch_kwargs: Optional[Dict] = None) -> Dict[str, Any]:
    """Run the module on meta tensors: input and output shapes and
    dtypes with no storage allocated and no compute."""
    from kfserving_tpu_torch.models import apply_fn_for, create_model

    spec = create_model(architecture, **(arch_kwargs or {}))
    example = spec.example
    if isinstance(example, dict):
        example = {k: np.asarray(v) for k, v in example.items()}
        batch = {k: _meta(v) for k, v in example.items()}
    else:
        example = np.asarray(example)
        batch = _meta(example)
    module = spec.module.to("meta")
    with torch.no_grad():
        out = apply_fn_for(spec)(module, batch)
    return {
        "inputs": _shapes_of(example if isinstance(example, dict)
                             else {"input_0": example}),
        "outputs": _shapes_of(out),
    }


def generate(name: str, architecture: str,
             arch_kwargs: Optional[Dict] = None) -> Dict[str, Any]:
    """Build the OpenAPI 3.0 document for one served model."""
    sig = model_signature(architecture, arch_kwargs)

    def instance_schema(entry):
        # drop the example's batch dim: per-instance schema
        return array_schema(entry["shape"][1:], entry["dtype"])

    if len(sig["inputs"]) == 1:
        v1_item = instance_schema(sig["inputs"][0])
    else:
        v1_item = {
            "type": "object",
            "properties": {e["name"]: instance_schema(e)
                           for e in sig["inputs"]},
            "required": [e["name"] for e in sig["inputs"]],
        }
    v1_request = {
        "type": "object",
        "required": ["instances"],
        "properties": {"instances": {"type": "array", "items": v1_item}},
    }
    v2_request = {
        "type": "object",
        "required": ["inputs"],
        "properties": {"inputs": {
            "type": "array",
            "items": {"oneOf": [
                {
                    "type": "object",
                    "required": ["name", "shape", "datatype", "data"],
                    "properties": {
                        "name": {"type": "string",
                                 "enum": [e["name"]]},
                        "shape": {"type": "array",
                                  "items": {"type": "integer"}},
                        "datatype": {
                            "type": "string",
                            "enum": [_v2_datatype(e["dtype"])]},
                        "data": {"type": "array"},
                    },
                } for e in sig["inputs"]
            ]},
        }},
    }
    return {
        "openapi": "3.0.0",
        "info": {"title": f"Predict API for {name}",
                 "version": "1"},
        "paths": {
            f"/v1/models/{name}:predict": {"post": {
                "requestBody": {"required": True, "content": {
                    "application/json": {"schema": v1_request}}},
                "responses": {"200": {
                    "description": "predictions",
                    "content": {"application/json": {"schema": {
                        "type": "object",
                        "properties": {"predictions":
                                       {"type": "array"}}}}},
                }},
            }},
            f"/v2/models/{name}/infer": {"post": {
                "requestBody": {"required": True, "content": {
                    "application/json": {"schema": v2_request}}},
                "responses": {"200": {"description": "infer response"}},
            }},
        },
        "x-model-signature": {
            "inputs": [{"name": e["name"], "shape": e["shape"],
                        "datatype": _v2_datatype(e["dtype"])}
                       for e in sig["inputs"]],
            "outputs": [{"name": e["name"], "shape": e["shape"],
                         "datatype": _v2_datatype(e["dtype"])}
                        for e in sig["outputs"]],
        },
    }


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Generate OpenAPI schemas from a model of the PyTorch port "
                    "(tf2openapi analogue)")
    p.add_argument("--model_dir",
                   help="model dir with config.json (architecture + "
                        "arch_kwargs)")
    p.add_argument("--architecture", help="registry architecture name")
    p.add_argument("--arch_kwargs", default="{}",
                   help="JSON kwargs for --architecture")
    p.add_argument("--name", default=None, help="served model name")
    args = p.parse_args(argv)
    if args.model_dir:
        with open(f"{args.model_dir.rstrip('/')}/config.json") as f:
            cfg = json.load(f)
        arch = cfg["architecture"]
        kwargs = cfg.get("arch_kwargs", {})
    elif args.architecture:
        arch = args.architecture
        kwargs = json.loads(args.arch_kwargs)
    else:
        p.error("one of --model_dir / --architecture is required")
    doc = generate(args.name or arch, arch, kwargs)
    json.dump(doc, sys.stdout, indent=2)
    sys.stdout.write("\n")


if __name__ == "__main__":
    main()
