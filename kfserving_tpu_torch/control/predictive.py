"""The supervisor flight recorder of the control plane.

Port of ``kfserving_tpu/control/predictive.py``, holding only
``ensure_flight_recorder``, which the autoscaler's stall pin needs.  The
rest of the module (the ``PredictiveScaler``: burn-driven sizing,
standby pre-arming and brownout entry and exit) comes with the next
slice of the control plane.
"""

from typing import Optional

from kfserving_tpu_torch.observability.monitoring import FlightRecorder


def ensure_flight_recorder(orchestrator) -> Optional[FlightRecorder]:
    """The supervisor flight recorder for decision evidence.  The
    subprocess orchestrator carries one (its failover timelines);
    in-process/fake orchestrators get one attached on first use so
    the router's replica="supervisor" federation serves the decision
    trail on every backend."""
    recorder = getattr(orchestrator, "flight_recorder", None)
    if recorder is None:
        recorder = FlightRecorder.from_env()
        try:
            orchestrator.flight_recorder = recorder
        except Exception:  # frozen/slotted test double: no evidence
            return None
    return recorder
