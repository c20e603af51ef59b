"""Host-side mmap parameter cache: a model's weights are materialized once,
then mapped.

Port of ``kfserving_tpu/engine/param_cache.py`` (the whole module).  A
load materializes a model's state dict (seeded init or Flax checkpoint
through ``models/weights.py``'s converter), persists it in a layout
``np.memmap`` can serve, and every later load of the same content maps
the same page-cache-resident bytes and goes straight to the device
copy.  The mapped tensors are also the host restore source that the
residency manager (``engine/residency.py``) pages models back in from.

Cache layout (one entry per content digest):

    <cache_dir>/<digest>/manifest.json   leaf paths, dtypes, shapes,
                                         byte offsets into params.bin
    <cache_dir>/<digest>/params.bin      all leaves, 4096-aligned

An entry holds the port's state dict: torch names and layouts, after the
Flax converter, in the dtype the model serves (4-d conv weights in the
contiguous OIHW layout; ``materialize`` makes them channels-last on the
card).  The digest keys the content that determines those tensors:
architecture + arch_kwargs + init seed + the checkpoint's digest (its
shipped ``*.sha256`` sidecar when present, else a full file hash), plus
a ``"layout": "torch"`` term, so a JAX entry and a port entry never
share a key even in one directory.  An entry holds what the port's own
code made of those inputs, so the key also hashes that code
(``code_digest``): the source of ``models/weights.py`` (converters,
seeded init, layout) and of the module's definition.  A fix to either
turns every old entry into a miss instead of serving stale tensors.  An entry without a checkpoint also
keys the device type of its seeded init: ``torch.Generator`` draws other
numbers on the CPU than on the card.

The manifest names a bf16 leaf ``"bfloat16"``, as the JAX package writes
it; the port reads its bytes as uint16 and views them as
``torch.bfloat16`` (no ``ml_dtypes``).  Entries are published atomically
(temp dir + rename); a corrupt entry is deleted on load; loads are
zero-copy tensors over one copy-on-write memmap.  Outcomes are counted in
``kfserving_tpu_param_cache_total{outcome=hit|miss|store|error}``.  Knob:
``KFS_PARAM_CACHE``
(directory; ``0``/``off`` disables).
"""

import functools
import hashlib
import inspect
import json
import logging
import os
import shutil
import tempfile
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from kfserving_tpu_torch import startup
from kfserving_tpu_torch.observability import metrics as obs
from kfserving_tpu_torch.protocol.errors import InvalidInput

logger = logging.getLogger("kfserving_tpu_torch.param_cache")

ENV_VAR = "KFS_PARAM_CACHE"
DEFAULT_CACHE_DIR = os.path.expanduser("~/.cache/kfserving_tpu_torch/params")
MANIFEST_NAME = "manifest.json"
DATA_NAME = "params.bin"
MANIFEST_VERSION = 1
LAYOUT = "torch"
CHECKPOINT_NAME = "checkpoint.msgpack"
# Leaf offsets align to the page size so a mapped leaf never shares a
# page with its neighbour's tail (and the device copy reads aligned
# sources).
_ALIGN = 4096



def cache_dir() -> Optional[str]:
    """The active cache directory, or None when disabled."""
    value = os.environ.get(ENV_VAR, "")
    if value.lower() in ("0", "off", "false", "disabled"):
        return None
    return value or DEFAULT_CACHE_DIR


def _observe(outcome: str) -> None:
    obs.param_cache_total().labels(outcome=outcome).inc()


def file_digest(path: str) -> str:
    """Digest of a checkpoint file: the artifact's shipped
    ``<path>.sha256`` sidecar when present, else a full SHA-256."""
    sidecar = path + ".sha256"
    try:
        with open(sidecar) as f:
            token = f.read().split()[0].strip()
        if token:
            return token
    except (OSError, IndexError):
        pass
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


@functools.lru_cache(maxsize=None)
def _read_source(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def code_digest(module: torch.nn.Module) -> str:
    """Digest of the code that turns a checkpoint or a seed into the
    stored state dict: ``models/weights.py`` and the file that defines
    ``module``'s class (its parameter names, shapes and buffers)."""
    from kfserving_tpu_torch.models import weights

    h = hashlib.sha256()
    for path in sorted({inspect.getsourcefile(weights),
                        inspect.getsourcefile(type(module))}):
        h.update(_read_source(path))
    return h.hexdigest()[:16]


def content_key(architecture: str, arch_kwargs: Optional[Dict],
                seed: int = 0,
                checkpoint_digest: Optional[str] = None,
                init_device: Optional[str] = None,
                code: Optional[str] = None) -> str:
    """Digest over everything that determines the materialized state
    dict; two deployments agreeing on it may share bytes."""
    fields = {
        "architecture": architecture,
        "arch_kwargs": arch_kwargs or {},
        "seed": seed,
        "checkpoint": checkpoint_digest or "none",
        "version": MANIFEST_VERSION,
        "layout": LAYOUT,
    }
    if init_device is not None:
        fields["init_device"] = init_device
    if code is not None:
        fields["code"] = code
    blob = json.dumps(fields, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:24]


def _flatten(tree: Any, prefix: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """Depth-first (path, leaf) pairs of a nested dict; only dicts
    recurse.  A flat state dict gives one-element paths (its names)."""
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), value


def _unflatten(leaves: List[Tuple[Tuple[str, ...], Any]]) -> Dict:
    tree: Dict = {}
    for path, leaf in leaves:
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def _host_array(leaf: Any) -> Tuple[str, np.ndarray]:
    """(manifest dtype name, contiguous numpy array of the leaf's
    bytes).  bf16 travels as its uint16 bit pattern."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", t.view(torch.int16).numpy().view(np.uint16)
        arr = t.numpy()
    else:
        arr = np.ascontiguousarray(np.asarray(leaf))
    if arr.dtype.name == "bfloat16":           # an ml_dtypes array
        return "bfloat16", arr.view(np.uint16)
    return arr.dtype.name, arr


def _tensor_view(data: np.ndarray, dtype_name: str,
                 shape: List[int]) -> torch.Tensor:
    """A CPU tensor over ``data`` (a uint8 slice of the map), no copy."""
    if dtype_name == "bfloat16":
        arr = data.view(np.uint16).reshape(shape)
        return torch.from_numpy(arr).view(torch.bfloat16)
    return torch.from_numpy(data.view(np.dtype(dtype_name)).reshape(shape))


def store(key: str, tree: Dict[str, Any]) -> bool:
    """Persist a state dict (or nested dict of tensors/arrays) under
    ``key``.  Best-effort: False (and an ``error`` count) on any
    failure; a broken cache write never fails a load that succeeded."""
    root = cache_dir()
    if root is None or not isinstance(tree, dict):
        return False
    entry = os.path.join(root, key)
    if os.path.exists(os.path.join(entry, MANIFEST_NAME)):
        return True  # a concurrent loader already wrote it
    try:
        manifest: List[Dict[str, Any]] = []
        arrays = []
        offset = 0
        for path, leaf in _flatten(tree):
            dtype_name, arr = _host_array(leaf)
            offset = (offset + _ALIGN - 1) // _ALIGN * _ALIGN
            manifest.append({
                "path": list(path),
                "dtype": dtype_name,
                "shape": list(arr.shape),
                "offset": offset,
                "nbytes": int(arr.nbytes),
            })
            arrays.append((offset, arr))
            offset += arr.nbytes
        os.makedirs(root, exist_ok=True)
        tmp = tempfile.mkdtemp(prefix=f".{key}-", dir=root)
        try:
            with open(os.path.join(tmp, DATA_NAME), "wb") as f:
                for off, arr in arrays:
                    f.seek(off)
                    f.write(arr.tobytes())
                f.flush()
                os.fsync(f.fileno())
            with open(os.path.join(tmp, MANIFEST_NAME), "w") as f:
                json.dump({"version": MANIFEST_VERSION,
                           "total_bytes": offset,
                           "leaves": manifest}, f)
            # Atomic publish: readers see nothing or a whole entry (a
            # racing writer's entry is byte-identical, so losing is
            # fine).
            try:
                os.rename(tmp, entry)
            except OSError:
                shutil.rmtree(tmp, ignore_errors=True)
        except Exception:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
    except Exception:
        logger.warning("param-cache store of %s failed", key, exc_info=True)
        _observe("error")
        return False
    _observe("store")
    logger.info("param cache stored %s (%d leaves, %.1f MB)",
                key, len(manifest), offset / 1e6)
    return True


def load(key: str) -> Optional[Dict]:
    """Map a cached entry: one copy-on-write memmap of params.bin, every
    leaf a CPU tensor over it.  None on a miss or any corruption (a
    corrupt entry is deleted so the next load re-stores it)."""
    root = cache_dir()
    if root is None:
        return None
    entry = os.path.join(root, key)
    manifest_path = os.path.join(entry, MANIFEST_NAME)
    if not os.path.exists(manifest_path):
        _observe("miss")
        return None
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
        if manifest.get("version") != MANIFEST_VERSION:
            raise ValueError(f"manifest version {manifest.get('version')}")
        # mode="c": private copy-on-write pages, so the tensors are
        # writable views (torch warns on read-only ones) that never
        # write back to the file.
        data = np.memmap(os.path.join(entry, DATA_NAME), dtype=np.uint8,
                         mode="c")
        leaves = []
        for leaf in manifest["leaves"]:
            off, nbytes = leaf["offset"], leaf["nbytes"]
            if off + nbytes > data.size:
                raise ValueError(f"leaf {leaf['path']} overruns params.bin")
            leaves.append((tuple(leaf["path"]),
                           _tensor_view(data[off:off + nbytes],
                                        leaf["dtype"], leaf["shape"])))
    except Exception:
        logger.warning("param cache entry %s is corrupt; deleting", key,
                       exc_info=True)
        shutil.rmtree(entry, ignore_errors=True)
        _observe("error")
        return None
    _observe("hit")
    logger.info("param cache hit %s (%d leaves, %.1f MB mapped)",
                key, len(leaves), manifest["total_bytes"] / 1e6)
    return _unflatten(leaves)


def load_or_materialize(architecture: str, arch_kwargs: Optional[Dict],
                        spec, local_dir: str, device: torch.device,
                        checkpoint_name: str = CHECKPOINT_NAME,
                        seed: int = 0, fill: bool = True
                        ) -> Tuple[torch.nn.Module,
                                   Optional[Dict[str, torch.Tensor]], str]:
    """The predictor's load path: (module on ``device``, host state
    dict, source).  Source is "mmap" (cache hit), "checkpoint" (Flax
    checkpoint converted, then stored) or "init" (seeded init, then
    stored).  The host state dict is the mapped entry, the restore
    source of ``TorchEngine.offload``/``restore``; None when the cache
    is disabled or its store failed (the model then cannot be
    offloaded).

    ``fill=False`` on a hit allocates the module without copying the
    weights in: the caller pins them with one ``TorchEngine.restore()``
    (a residency-managed cold fault).  A miss always fills.
    """
    from kfserving_tpu_torch.models import weights

    device = torch.device(device)
    ckpt_path = os.path.join(local_dir, checkpoint_name)
    ckpt_digest = (file_digest(ckpt_path)
                   if os.path.exists(ckpt_path) else None)
    key = content_key(architecture, arch_kwargs, seed=seed,
                      checkpoint_digest=ckpt_digest,
                      init_device=None if ckpt_digest else device.type,
                      code=code_digest(spec.module))
    cached = load(key)
    if cached is not None:
        startup.mark("params_mmap")
        module = (weights.materialize(spec.module, device, state_dict=cached)
                  if fill else weights.allocate(spec.module, device))
        return module, cached, "mmap"
    state_dict, source = None, "init"
    if ckpt_digest is not None:
        convert = weights.FLAX_CONVERTERS.get(architecture)
        if convert is None:
            raise InvalidInput(
                f"no Flax checkpoint converter for architecture "
                f"{architecture!r}")
        state_dict = convert(weights.read_flax_msgpack(ckpt_path))
        startup.mark("checkpoint_restore")
        source = "checkpoint"
    else:
        logger.warning("no checkpoint at %s; serving a seeded init",
                       ckpt_path)
    module = weights.materialize(spec.module, device, state_dict=state_dict,
                                 seed=seed)
    startup.mark("init_params")
    # Serve the mapped bytes just written, not this process's copy: they
    # are the host restore source, and the page cache shares them with
    # every later load.
    if store(key, module.state_dict()):
        startup.mark("param_cache_store")
        mapped = load(key)
        if mapped is not None:
            return module, mapped, source
    return module, None, source
