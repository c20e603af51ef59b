"""Shared env-knob parsing for the reliability family.

Every knob resolves `{prefix}_{infix}_{name}` first (the edge-specific
setting, e.g. `KFS_STORAGE_RETRY_MAX_ATTEMPTS`) and falls back to the
bare `KFS_{infix}_{name}` so one setting tunes every edge."""

import logging
import os

logger = logging.getLogger("kfserving_tpu_torch.reliability")


def env_float(name: str, prefix: str, infix: str,
              default: float) -> float:
    for key in (f"{prefix}_{infix}_{name}", f"KFS_{infix}_{name}"):
        raw = os.environ.get(key)
        if raw:
            try:
                return float(raw)
            except ValueError:
                logger.warning("ignoring non-numeric %s=%r", key, raw)
    return default
