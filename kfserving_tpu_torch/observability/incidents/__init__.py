"""Incident engine: automated cross-signal diagnosis.

Port of ``kfserving_tpu/observability/incidents/``: the join over every
detector the server runs (SLO burn-rate breaches, trend change points,
sanitizer violations, eviction and fault-back storms, failovers),
turning isolated flight-recorder pins into one diagnosed,
evidence-bearing incident record per regression (``manager.py``),
classified against the additive latency decomposition
(``classify.py``).  Served at ``GET /debug/incidents`` and exported as
the ``kfserving_tpu_incident_*`` families.
"""

from kfserving_tpu_torch.observability.incidents.classify import (
    CAUSES,
    classify,
)
from kfserving_tpu_torch.observability.incidents.manager import (
    IncidentManager,
    incidents_enabled,
)

__all__ = [
    "CAUSES",
    "IncidentManager",
    "classify",
    "incidents_enabled",
]
