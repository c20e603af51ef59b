"""Startup phase tracking: where a replica's boot time goes.

Port of ``kfserving_tpu/startup.py``.  Phases are measured from process
birth (read from /proc/self/stat, so the interpreter and import cost
before any of this package's code runs is the first phase), recorded as
cumulative seconds-since-birth marks, and served by the model server at
``GET /startup_phases``; a recycling orchestrator attaches them to its
swap breakdown.
"""

import logging
import os
import time
from typing import Dict, Optional

logger = logging.getLogger("kfserving_tpu_torch.startup")

_marks: Dict[str, float] = {}
_birth: Optional[float] = None


def _process_birth_monotonic() -> float:
    """CLOCK_MONOTONIC timestamp of process creation (exec), from
    /proc/self/stat field 22 (starttime, in clock ticks since boot).
    Falls back to import time on non-Linux."""
    try:
        with open("/proc/self/stat", "rb") as f:
            stat = f.read().split(b")")[-1].split()
        ticks = int(stat[19])  # field 22 overall; 20th after comm
        hz = os.sysconf("SC_CLK_TCK")
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        # starttime is relative to boot; CLOCK_MONOTONIC is too.
        return time.monotonic() - (uptime - ticks / hz)
    except Exception:
        return time.monotonic()


def mark(phase: str) -> float:
    """Record `phase` as completed now; returns seconds since process
    birth.  Phases are cumulative timestamps, so consumers diff
    adjacent marks for per-phase durations."""
    global _birth
    if _birth is None:
        _birth = _process_birth_monotonic()
    t = time.monotonic() - _birth
    _marks[phase] = round(t, 3)
    return t


def phases() -> Dict[str, float]:
    return dict(_marks)


# Import time is itself a phase boundary: everything before this point
# (interpreter start, sitecustomize, the importing module's own import
# chain) lands in "interpreter_imports".
mark("interpreter_imports")
