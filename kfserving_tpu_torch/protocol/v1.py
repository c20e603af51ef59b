"""V1 predict protocol: `{"instances": [...]}` -> `{"predictions": [...]}`.

The request schema is the TF-Serving style row format used by the reference
(reference python/kfserving/kfserving/handlers/http.py:43-51 validates that
"instances"/"inputs" is a list; per-framework servers consume
`request["instances"]`, e.g. reference python/sklearnserver/sklearnserver/
model.py:42-53).
"""

from typing import Any, Dict, List

from kfserving_tpu_torch.protocol.errors import InvalidInput


def validate_request(request: Dict[str, Any]) -> Dict[str, Any]:
    """Validate a decoded V1 request body.

    Matches the reference check (handlers/http.py:43-51): if "instances" or
    "inputs" is present it must be a list.  Unlike the reference we also
    reject non-dict bodies early with a clear message.
    """
    if not isinstance(request, dict):
        raise InvalidInput('Expected request body to be a JSON object')
    for key in ("instances", "inputs"):
        value = request.get(key)
        if value is None:
            continue
        # Accepted: JSON lists, or numpy arrays from in-process callers.
        if not (isinstance(value, list) or hasattr(value, "ndim")):
            raise InvalidInput(
                'Expected "instances" or "inputs" to be a list')
    return request


def get_instances(request: Dict[str, Any]) -> List[Any]:
    """Extract the instance list from a V1 request ("instances" or "inputs")."""
    validate_request(request)
    if "instances" in request:
        return request["instances"]
    if "inputs" in request:
        return request["inputs"]
    raise InvalidInput('Expected "instances" or "inputs" in request body')


def make_response(predictions: List[Any]) -> Dict[str, Any]:
    return {"predictions": predictions}
