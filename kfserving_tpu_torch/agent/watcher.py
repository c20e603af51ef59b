"""Model-config watcher: config file changes -> load/unload events.

Port of ``kfserving_tpu/agent/watcher.py``.  The watched path is a
``models.json`` file (``[{modelName, modelSpec: {storageUri, framework,
memory}}]``) or a directory holding one, as a mounted ConfigMap
presents it.  An asyncio poll loop hashes its content, re-parses it on a
change, diffs it against the in-memory view and emits per-model ops:
load for a new or changed spec, unload for a removed one.
"""

import asyncio
import hashlib
import json
import logging
import os
from typing import Dict, Optional, Tuple

logger = logging.getLogger("kfserving_tpu_torch.agent.watcher")

MODEL_CONFIG_FILE = "models.json"


def parse_model_config(raw: bytes) -> Dict[str, dict]:
    """models.json -> {name: spec}.  Invalid entries are skipped with a
    warning (one bad model must not take down the others)."""
    try:
        entries = json.loads(raw or b"[]")
    except ValueError as e:
        raise ValueError(f"invalid model config: {e}")
    if not isinstance(entries, list):
        # A dict or scalar here is a config typo, not "zero models":
        # reading it as empty would unload the whole fleet.
        raise ValueError(
            f"invalid model config: expected a JSON list, got "
            f"{type(entries).__name__}")
    out: Dict[str, dict] = {}
    for entry in entries:
        if not isinstance(entry, dict):
            logger.warning("skipping invalid model config entry: %r", entry)
            continue
        name = entry.get("modelName")
        spec = entry.get("modelSpec")
        if not name or not isinstance(spec, dict) or \
                "storageUri" not in spec:
            logger.warning("skipping invalid model config entry: %r", entry)
            continue
        out[name] = spec
    return out


def diff_configs(old: Dict[str, dict], new: Dict[str, dict]
                 ) -> Tuple[Dict[str, dict], Dict[str, dict], list]:
    """Returns (added_or_changed, unchanged, removed_names)."""
    added = {n: s for n, s in new.items()
             if n not in old or old[n] != s}
    unchanged = {n: s for n, s in new.items()
                 if n in old and old[n] == s}
    removed = [n for n in old if n not in new]
    return added, unchanged, removed


class ModelConfigWatcher:
    """Polls a model-config path and pushes ("load"|"unload", name, spec)
    events onto `events` (consumed by the Puller)."""

    def __init__(self, config_path: str,
                 events: Optional[asyncio.Queue] = None,
                 poll_interval: float = 1.0):
        self.config_path = config_path
        self.events: asyncio.Queue = events or asyncio.Queue()
        self.poll_interval = poll_interval
        self.current: Dict[str, dict] = {}
        self._digest: Optional[str] = None
        self._task: Optional[asyncio.Task] = None

    def _resolve(self) -> str:
        """The file itself, or the models.json of a directory."""
        path = self.config_path
        if os.path.isdir(path):
            path = os.path.join(path, MODEL_CONFIG_FILE)
        return path

    def _read(self) -> Optional[bytes]:
        try:
            with open(self._resolve(), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    async def sync(self) -> bool:
        """One reconcile pass; returns True if events were emitted.  The
        read runs in an executor: the watcher shares the server's loop
        with live requests and pulls."""
        raw = await asyncio.get_running_loop().run_in_executor(
            None, self._read)
        if raw is None:
            return False
        digest = hashlib.sha256(raw).hexdigest()
        if digest == self._digest:
            return False
        try:
            new = parse_model_config(raw)
        except ValueError as e:
            logger.error("%s", e)
            return False
        added, _, removed = diff_configs(self.current, new)
        for name in removed:
            await self.events.put(("unload", name, self.current[name]))
        for name, spec in added.items():
            await self.events.put(("load", name, spec))
        self.current = new
        self._digest = digest
        if added or removed:
            logger.info("model config sync: +%d -%d",
                        len(added), len(removed))
        return bool(added or removed)

    async def start(self):
        self._task = asyncio.create_task(self._loop())

    async def _loop(self):
        while True:
            try:
                await self.sync()
            except Exception:
                logger.exception("model config sync failed")
            await asyncio.sleep(self.poll_interval)

    async def stop(self):
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
