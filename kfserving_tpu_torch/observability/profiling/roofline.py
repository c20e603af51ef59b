"""Live roofline telemetry: engine FLOP / bandwidth / goodput gauges.

Port of ``kfserving_tpu/observability/profiling/roofline.py``.  The
engines keep FLOP, padding and goodput accounting in their ``stats()``
dicts; ``publish_gauges`` promotes them into process-registry gauges at
``/metrics`` scrape time:

    kfserving_tpu_engine_mfu{model,phase}         achieved/peak FLOP/s
    kfserving_tpu_engine_achieved_tflops{model,phase}
    kfserving_tpu_engine_padding_waste_ratio{model,bucket}
    kfserving_tpu_engine_goodput_ratio{model}     useful tokens over
                                                  useful + garbage-wave
    kfserving_tpu_engine_hbm_bw_util_ratio{model} decode KV+param read
                                                  rate over peak HBM BW

``publish_gauges`` returns the stat keys it consumed, so the server's
generic engine-stats exporter never declares the same family twice.
The paged pool's occupancy and fragmentation ratios are published by
``observability/attribution.py::publish_cache_gauges``.

The peak memory bandwidth is that of the card the port runs on, read
from its name, as ``engine/torch_engine.py::device_peak_flops`` reads
the FLOP peak; ``KFS_PEAK_HBM_BW`` (bytes/s) overrides it.
"""

import logging
import os
from typing import Any, Dict, Optional, Set

import torch

from kfserving_tpu_torch.observability import metrics as obs

logger = logging.getLogger("kfserving_tpu_torch.profiling.roofline")

# Peak memory bandwidth by the substring of torch.cuda.get_device_name()
# that names the part (NVIDIA data sheets); the first match wins.
_PEAK_HBM_BW = (("h100 pcie", 2.0e12), ("h100", 3.35e12),
                ("h200", 4.8e12), ("a100", 2.039e12))


def device_peak_hbm_bw(device: Optional[torch.device] = None
                       ) -> Optional[float]:
    """Peak memory bandwidth (bytes/s) of the serving card, for the
    decode bandwidth-utilization gauge.  None when unknown (a CPU device
    or an unlisted card): the gauge is then omitted rather than faked."""
    env = os.getenv("KFS_PEAK_HBM_BW")
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    if device is None or device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device).lower()
    for marker, bw in _PEAK_HBM_BW:
        if marker in name:
            return bw
    return None


def _clamp01(value: float) -> float:
    return min(1.0, max(0.0, float(value)))


# stats() keys this module owns, per phase.
_MFU_KEYS = (("mfu", "infer"), ("decode_mfu", "decode"),
             ("prefill_mfu", "prefill"))
_TFLOPS_KEYS = (("achieved_tflops", "infer"),
                ("achieved_decode_tflops", "decode"),
                ("achieved_prefill_tflops", "prefill"))
_WASTE_KEYS = ("bucket_pad_waste", "prefill_bucket_pad_waste")


def publish_gauges(model: str, stats: Dict[str, Any]) -> Set[str]:
    """Publish an engine stats dict's roofline numbers as gauges labeled
    by model.  Returns the stat keys consumed.  Never raises into the
    scrape path."""
    consumed: Set[str] = set()
    try:
        for key, phase in _MFU_KEYS:
            value = stats.get(key)
            if isinstance(value, (int, float)):
                obs.engine_mfu().labels(
                    model=model, phase=phase).set(float(value))
                consumed.add(key)
        for key, phase in _TFLOPS_KEYS:
            value = stats.get(key)
            if isinstance(value, (int, float)):
                obs.engine_achieved_tflops().labels(
                    model=model, phase=phase).set(float(value))
                consumed.add(key)
        for key in _WASTE_KEYS:
            waste = stats.get(key)
            if isinstance(waste, dict):
                for bucket, value in waste.items():
                    if isinstance(value, (int, float)):
                        obs.engine_padding_waste_ratio().labels(
                            model=model, bucket=str(bucket)).set(
                                _clamp01(value))
                consumed.add(key)
        value = stats.get("goodput_ratio")
        if isinstance(value, (int, float)):
            obs.engine_goodput_ratio().labels(model=model).set(
                _clamp01(value))
            consumed.add("goodput_ratio")
        value = stats.get("hbm_bw_util")
        if isinstance(value, (int, float)):
            obs.engine_hbm_bw_util_ratio().labels(model=model).set(
                _clamp01(value))
            consumed.add("hbm_bw_util")
    except Exception:  # telemetry must never fail a scrape
        logger.exception("roofline gauge publish failed for %s", model)
    return consumed
