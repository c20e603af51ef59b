"""kfslint for the port — AST-based concurrency, serving-discipline and
device-discipline analyzer.

Port of ``kfserving_tpu/tools/analyzers/``: the same ten rule ids, with
copies of its framework (``core``), its concurrency four
(``asyncrules``: ``async-blocking``, ``spin-loop``,
``await-under-lock``, ``cancellation-safety``) and its serving-
discipline pair (``discipline``: ``fault-site`` against the port's
``reliability/fault_sites.py``, ``metric-name`` through ``naming``),
and a device tier for torch on the card (``devicerules``: ``host-sync``,
``jit-recompile-hazard``, ``blocking-dispatch``, ``prng-key-reuse``).

Usage::

    python -m kfserving_tpu_torch.tools.analyzers [paths ...]

With no paths it analyzes the port package, the port's tests
(``tests/test_torch_*.py``) and ``chip_smoke.py``.  Exit 0 means: zero
findings that are neither pragma-suppressed nor in the port's
committed ``baseline.json``, and zero stale baseline entries.
Suppression: ``# kfslint: disable=<rule>[,<rule>]  <justification>``
on the finding's line (or a comment line just above it).
"""

import glob
import os
from typing import List

from kfserving_tpu_torch.tools.analyzers.asyncrules import (
    AsyncBlockingRule,
    AwaitUnderLockRule,
    CancellationSafetyRule,
    SpinLoopRule,
)
from kfserving_tpu_torch.tools.analyzers.core import (
    Finding,
    Rule,
    analyze_paths,
    analyze_snippets,
    analyze_source,
    apply_baseline,
    load_baseline,
    save_baseline,
)
from kfserving_tpu_torch.tools.analyzers.devicerules import (
    BlockingDispatchRule,
    HostSyncRule,
    JitRecompileHazardRule,
    PrngKeyReuseRule,
)
from kfserving_tpu_torch.tools.analyzers.discipline import (
    FaultSiteRule,
    MetricNameRule,
)

__all__ = [
    "Finding", "Rule", "analyze_paths", "analyze_snippets",
    "analyze_source", "apply_baseline", "load_baseline",
    "save_baseline", "default_rules", "rule_ids",
    "default_baseline_path", "default_target", "default_targets",
]


def default_rules() -> List[Rule]:
    """Fresh rule instances (rules carry per-run state), in the JAX
    package's order."""
    return [AsyncBlockingRule(), SpinLoopRule(), AwaitUnderLockRule(),
            CancellationSafetyRule(), FaultSiteRule(),
            MetricNameRule(), HostSyncRule(),
            JitRecompileHazardRule(), BlockingDispatchRule(),
            PrngKeyReuseRule()]


def rule_ids() -> List[str]:
    return [r.id for r in default_rules()]


def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(__file__), "baseline.json")


def default_target() -> str:
    """The installed port package root."""
    import kfserving_tpu_torch
    return os.path.dirname(os.path.abspath(kfserving_tpu_torch.__file__))


def default_targets() -> List[str]:
    """What a bare run analyzes: the port package, plus, in a checkout
    (a ``pyproject.toml`` beside the package), the port's tests and
    ``chip_smoke.py``."""
    pkg = default_target()
    roots = [pkg]
    repo = os.path.dirname(pkg)
    if os.path.isfile(os.path.join(repo, "pyproject.toml")):
        roots += sorted(glob.glob(os.path.join(repo, "tests",
                                               "test_torch_*.py")))
        smoke = os.path.join(repo, "chip_smoke.py")
        if os.path.isfile(smoke):
            roots.append(smoke)
    return roots
