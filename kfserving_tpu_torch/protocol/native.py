"""The native V1 JSON codec and its pure-Python fallback.

Port of ``kfserving_tpu/protocol/native.py``.  The C extension
(``csrc/tensorjson.c``) parses dense V1 predict bodies into contiguous
buffers and dumps prediction tensors back to JSON in one pass.  This
wrapper:

- builds the extension at first use (``csrc/build.py::build_extension``:
  the host C compiler against the interpreter's ``Python.h``) and loads
  it; where it cannot be built or loaded, it logs one warning and
  exposes the same API in pure Python;
- returns numpy views over the parsed buffer (zero-copy reshape);
- counts the bodies each codec parsed in ``parse_counts`` ("native" or
  "python"), so a run can show which one served its requests.

Fast-path eligibility is decided by the caller (``server/dataplane``):
dense numeric bodies only; anything else (dicts, strings, V2 tensor
objects, CloudEvents) takes the json.loads route unchanged.
"""

import importlib.machinery
import importlib.util
import json
import logging
import threading
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger("kfserving_tpu_torch.native")

_native = None
_load_lock = threading.Lock()
# Bodies parse_v1 turned into an array, by the codec that parsed them.
parse_counts = {"native": 0, "python": 0}


def _import_extension(path: str):
    loader = importlib.machinery.ExtensionFileLoader("_tensorjson", path)
    spec = importlib.util.spec_from_file_location("_tensorjson", path,
                                                  loader=loader)
    module = importlib.util.module_from_spec(spec)
    loader.exec_module(module)
    return module


def _load():
    global _native
    if _native is not None:
        return _native
    with _load_lock:
        if _native is not None:
            return _native
        from kfserving_tpu_torch.csrc import build

        try:
            mod = _import_extension(build.build_extension("tensorjson"))
            # API probe: parse_v1 must report extra top-level keys
            # (5-tuple) AND accept the dtype hint (2-arg form); an
            # extension with an older API would drop keys or raise
            # TypeError on every hinted call, so refuse it.
            probe = mod.parse_v1(b'{"instances": [1], "x": 1}', "u1")
            if len(probe) != 5:
                raise TypeError("parse_v1 reports no extra-keys flag")
        except (build.KernelBuildError, ImportError, OSError, TypeError,
                ValueError) as e:
            logger.warning("native tensorjson codec unavailable (%s); "
                           "using the pure-Python codec", e)
            _native = False
        else:
            _native = mod
            logger.info("native tensorjson codec loaded")
    return _native


def available() -> bool:
    return bool(_load())


_DTYPES = {"u1": np.uint8, "i4": np.int32, "f4": np.float32}


def parse_v1(body: bytes, hint: Optional[str] = None
             ) -> Optional[Tuple[np.ndarray, str]]:
    """Parse a dense V1 body -> (array, key), or None if ineligible.

    hint="u1" (the served model's declared uint8 wire dtype) parses
    integer image bodies straight into uint8: no int32 intermediate, no
    astype copy downstream.  The hint is advisory: values outside
    [0, 255] give the normal i4/f4 and the model's own cast handles it.

    Never raises for non-dense bodies: the caller falls back to
    json.loads.
    """
    mod = _load()
    if not mod:
        out = _parse_v1_py(body, hint)
        if out is not None:
            parse_counts["python"] += 1
        return out
    try:
        data, shape, key, dtype, extra = mod.parse_v1(body, hint)
    except ValueError:
        return None
    if extra:
        # The body carries other top-level keys (parameters,
        # signature_name, custom fields): a {key: arr} dict would drop
        # them before model.preprocess, so fall back to json.loads.
        return None
    parse_counts["native"] += 1
    return np.frombuffer(data, dtype=_DTYPES[dtype]).reshape(shape), key


def _parse_v1_py(body: bytes, hint: Optional[str] = None
                 ) -> Optional[Tuple[np.ndarray, str]]:
    """Pure-Python fallback with identical eligibility rules."""
    try:
        obj = json.loads(body)
    except ValueError:
        return None
    if not isinstance(obj, dict):
        return None
    key = ("instances" if "instances" in obj
           else "inputs" if "inputs" in obj else None)
    if key is None or not isinstance(obj[key], list):
        return None
    if len(obj) > 1:
        # Extra top-level keys must survive to model.preprocess.
        return None
    try:
        arr = np.asarray(obj[key])
    except (ValueError, TypeError):
        return None
    if arr.ndim == 0 or arr.dtype == object:
        return None
    if np.issubdtype(arr.dtype, np.integer):
        if arr.size and (np.abs(arr) > np.iinfo(np.int32).max).any():
            arr = arr.astype(np.float32)
        elif hint == "u1" and (not arr.size or
                               (arr.min() >= 0 and arr.max() <= 255)):
            arr = arr.astype(np.uint8)
        else:
            arr = arr.astype(np.int32)
    elif np.issubdtype(arr.dtype, np.floating):
        arr = arr.astype(np.float32)
    else:
        return None
    return arr, key


def dump_f32(arr: np.ndarray) -> bytes:
    """Serialize a float tensor as a JSON array (bytes)."""
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    mod = _load()
    if mod:
        return mod.dump_f32(arr.tobytes(), tuple(arr.shape))
    return json.dumps(arr.tolist()).encode()


def dump_response(body) -> Optional[bytes]:
    """Serialize a ``{"predictions": <float32 ndarray>}`` response in one
    pass.  None when ineligible (other keys, a non-array, a dtype other
    than float32: integer class labels must round-trip as ints, not
    "1.0")."""
    if not isinstance(body, dict) or set(body) != {"predictions"}:
        return None
    arr = body["predictions"]
    if not isinstance(arr, np.ndarray) or arr.dtype != np.float32 \
            or arr.ndim == 0:
        return None
    return b'{"predictions": ' + dump_f32(arr) + b"}"
