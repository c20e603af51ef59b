"""Idempotent model artifact download.

Port of ``kfserving_tpu/agent/downloader.py``, on the port's ``storage``.
Each successful download of (model, spec) drops a
``SUCCESS.<sha256(spec)>`` marker inside the model dir; a restart that
finds the marker skips the pull, and a changed spec (another storageUri
or version) hashes differently and downloads anew.  A changed or partial
generation is wiped before the pull.
"""

import hashlib
import json
import logging
import os
import shutil
from typing import Optional

from kfserving_tpu_torch.reliability import fault_sites, faults
from kfserving_tpu_torch.storage import Storage

logger = logging.getLogger("kfserving_tpu_torch.agent.downloader")

SUCCESS_PREFIX = "SUCCESS"


def spec_digest(spec: dict) -> str:
    return hashlib.sha256(
        json.dumps(spec, sort_keys=True).encode()).hexdigest()


class Downloader:
    def __init__(self, model_dir: str):
        self.model_dir = model_dir
        os.makedirs(model_dir, exist_ok=True)

    def model_path(self, model_name: str) -> str:
        return os.path.join(self.model_dir, model_name)

    def _marker(self, model_name: str, digest: str) -> str:
        return os.path.join(self.model_path(model_name),
                            f"{SUCCESS_PREFIX}.{digest}")

    def is_downloaded(self, model_name: str, spec: dict) -> bool:
        return os.path.exists(self._marker(model_name, spec_digest(spec)))

    def download(self, model_name: str, spec: dict) -> Optional[str]:
        """Download spec["storageUri"] into <model_dir>/<model_name>.
        Returns the local path, or None when already current.

        Replay-safe: the marker lands only after a full pull and a
        changed or partial generation is wiped first, so the puller's
        retry policy can call this again freely (the ``agent.pull``
        fault site fires here, before any filesystem change)."""
        faults.inject_sync(fault_sites.AGENT_PULL, key=model_name)
        digest = spec_digest(spec)
        target = self.model_path(model_name)
        marker = self._marker(model_name, digest)
        if os.path.exists(marker):
            logger.info("model %s already downloaded (marker %s)",
                        model_name, os.path.basename(marker))
            return None
        # A changed spec invalidates the previous artifact wholesale, so
        # stale and new files never mix.
        if os.path.isdir(target):
            shutil.rmtree(target)
        os.makedirs(target, exist_ok=True)
        Storage.download(spec["storageUri"], target)
        with open(marker, "w") as f:
            f.write(digest)
        logger.info("downloaded %s from %s", model_name, spec["storageUri"])
        return target
