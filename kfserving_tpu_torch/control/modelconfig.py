"""models.json shard-config codec.

Reference format and delta semantics (pkg/modelconfig/configmap.go:34-51,
79-111): the per-shard config is a JSON list of {modelName, modelSpec};
TrainedModel reconciles apply (added, deleted) deltas and the agent
watcher picks the file up.  File writes are atomic (tmp + rename) to give
the watcher the same torn-read-free guarantee kubelet's ..data symlink
swap provides.
"""

import json
import os
import tempfile
from typing import Dict, Iterable, List, Tuple

from kfserving_tpu_torch.control.spec import TrainedModel


def render(models: Iterable[TrainedModel]) -> List[dict]:
    return [m.to_model_spec() for m in models]


def load_file(path: str) -> List[dict]:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return json.load(f)


def write_file(path: str, entries: List[dict]) -> None:
    """Atomic write: the agent watcher must never observe a torn file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               prefix=".models-")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(entries, f)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def apply_delta(entries: List[dict],
                added: Iterable[TrainedModel] = (),
                deleted: Iterable[str] = ()) -> List[dict]:
    """Pure delta apply (reference ConfigsDelta.Process,
    configmap.go:79-111): added upserts by modelName, deleted removes."""
    by_name: Dict[str, dict] = {e["modelName"]: e for e in entries}
    for tm in added:
        by_name[tm.name] = tm.to_model_spec()
    for name in deleted:
        by_name.pop(name, None)
    return [by_name[k] for k in sorted(by_name)]


def diff_names(entries: List[dict]) -> Tuple[List[str], Dict[str, dict]]:
    names = [e["modelName"] for e in entries]
    return names, {e["modelName"]: e["modelSpec"] for e in entries}
