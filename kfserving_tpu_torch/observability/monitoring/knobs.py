"""Env-knob parsing shared by the monitoring family (``KFS_MONITOR_*``,
``KFS_SLO_*``, ``KFS_FLIGHTRECORDER_*``).

Port of ``kfserving_tpu/observability/monitoring/knobs.py``: a
non-numeric value logs once and falls back to the default, so a typo'd
knob degrades to defaults and never crashes the server."""

import logging
import os

logger = logging.getLogger("kfserving_tpu_torch.monitoring")


def env_number(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        logger.warning("ignoring non-numeric %s=%r", name, raw)
        return default
