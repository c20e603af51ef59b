"""Metric family naming rules: the house conventions for every exported
metric family.

Port of ``kfserving_tpu/tools/analyzers/naming.py``, rule for rule.
``tools/check_metrics.py`` applies them to the families a booted server
registered and rendered.  The port keeps the JAX package's family names,
so it keeps the ``kfserving_tpu_`` prefix too.
"""

from typing import List

PREFIX = "kfserving_tpu_"
# Count units (_tokens, _blocks, _hits) joined the ladder with the
# cache/attribution families: token-count, block-count, and
# hits-per-entry histograms are distributions over discrete units, and
# forcing a time/size suffix onto them would lie about the unit.
UNIT_SUFFIXES = ("_ms", "_seconds", "_bytes", "_ratio", "_per_second",
                 "_tokens", "_blocks", "_hits")


def family_name_problems(name: str, kind: str) -> List[str]:
    """Naming problems for one family declaration.

    `kind` is "counter" | "gauge" | "histogram" (unknown kinds get the
    kind-independent checks only).
    """
    problems: List[str] = []
    if not name.startswith(PREFIX):
        problems.append(f"{name}: missing the {PREFIX!r} prefix")
    if kind == "counter" and not name.endswith("_total"):
        problems.append(f"{name}: counters must end in _total")
    if kind != "counter" and name.endswith("_total"):
        problems.append(
            f"{name}: _total suffix is reserved for counters "
            f"(is a {kind})")
    if "_milliseconds" in name or "_millis" in name:
        problems.append(f"{name}: spell milliseconds as _ms")
    if kind == "histogram" and not name.endswith(UNIT_SUFFIXES):
        problems.append(
            f"{name}: histograms must carry a unit suffix "
            f"({', '.join(UNIT_SUFFIXES)})")
    return problems
