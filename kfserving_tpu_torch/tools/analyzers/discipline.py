"""kfslint serving-discipline rules: fault sites and metric names.

Port of ``kfserving_tpu/tools/analyzers/discipline.py`` (the port keeps
its own copy).  The port's manifest is its own
``kfserving_tpu_torch/reliability/fault_sites.py``: one commented
constant a site, no generated section, so the JAX package's
``--write-fault-sites`` has no counterpart here.

`fault-site` — every `faults.inject("<site>")` / `inject_sync` call
must name a site from the manifest, either as the literal string or as
the manifest constant.  A typo'd site configures chaos
that silently never fires — the worst possible failure mode for a
fault harness.  When the scan covers the manifest itself (i.e. a
whole-package run), the rule also fails manifest rows no call site
uses: dead sites rot the manifest into fiction.

`metric-name` — every string-literal family name passed to
`REGISTRY.counter/gauge/histogram(...)` (or any `*registry.` receiver)
is checked against the shared naming rules in `naming.py`.  This is
the static twin of `tools/check_metrics.py`'s runtime exposition lint:
the runtime lint only sees families a smoke request happens to touch;
this rule sees every declaration in the tree.
"""

import ast
from typing import Dict, Iterator, Optional, Set

from kfserving_tpu_torch.reliability import fault_sites
from kfserving_tpu_torch.tools.analyzers import naming
from kfserving_tpu_torch.tools.analyzers.core import (
    FileContext,
    Finding,
    Rule,
    dotted_name,
)

_MANIFEST_SUFFIX = "reliability/fault_sites.py"


def site_values() -> Dict[str, str]:
    """{CONSTANT_NAME: site string} of the port's manifest: its
    upper-case string constants."""
    return {name: value for name, value in vars(fault_sites).items()
            if name.isupper() and isinstance(value, str)}


class FaultSiteRule(Rule):
    id = "fault-site"
    description = ("faults.inject() sites must come from the "
                   "fault_sites.py manifest (and every manifest row "
                   "must have a call site)")

    def __init__(self):
        self._known: Dict[str, str] = site_values()
        self._used_sites: Set[str] = set()
        self._saw_manifest: Optional[str] = None

    def check(self, tree: ast.Module,
              ctx: FileContext) -> Iterator[Finding]:
        if ctx.path.endswith(_MANIFEST_SUFFIX):
            self._saw_manifest = ctx.path
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            # `configured` gates share the site namespace: a typo'd
            # site in the guard silently disables the injection it
            # wraps, the exact failure mode the manifest exists for.
            if not (isinstance(func, ast.Attribute)
                    and func.attr in ("inject", "inject_sync",
                                      "configured")):
                continue
            recv = dotted_name(func.value) or ""
            if recv.rsplit(".", 1)[-1] != "faults":
                continue
            if not node.args:
                continue
            site_arg = node.args[0]
            finding = self._check_site_arg(site_arg, ctx)
            if finding is not None:
                yield finding

    def _check_site_arg(self, arg: ast.expr,
                        ctx: FileContext) -> Optional[Finding]:
        if isinstance(arg, ast.Constant) and isinstance(arg.value,
                                                       str):
            if arg.value in self._known.values():
                self._used_sites.add(arg.value)
                return None
            return ctx.finding(
                self.id, arg,
                f"fault site {arg.value!r} is not in the "
                f"fault_sites.py manifest — a typo'd site never "
                f"fires; add its constant to the manifest")
        name = dotted_name(arg)
        if name is not None:
            const = name.rsplit(".", 1)[-1]
            if const in self._known:
                self._used_sites.add(self._known[const])
                return None
            if const.isupper():
                return ctx.finding(
                    self.id, arg,
                    f"fault-site constant {const} is not declared "
                    f"in the fault_sites.py manifest")
            # A lowercase name is a runtime-computed site key we
            # can't resolve statically — that defeats the manifest.
        return ctx.finding(
            self.id, arg,
            "fault site must be a fault_sites.py constant or a "
            "literal from the manifest (dynamic site names can't be "
            "checked and can silently never fire)")

    def finalize(self) -> Iterator[Finding]:
        # Coverage only makes sense for whole-package scans; a run
        # over one file or a fixture dir never saw the manifest.
        if self._saw_manifest is None:
            return
        for const, site in sorted(self._known.items()):
            if site not in self._used_sites:
                yield Finding(
                    rule=self.id, path=self._saw_manifest, line=1,
                    message=(f"manifest site {site!r} ({const}) has "
                             f"no faults.inject() call site — remove "
                             f"the dead row or wire the site"),
                    snippet=const)


class MetricNameRule(Rule):
    id = "metric-name"
    description = ("registry family declarations must follow the "
                   "shared naming rules (prefix, _total, units)")

    _KINDS = {"counter": "counter", "gauge": "gauge",
              "histogram": "histogram"}

    def check(self, tree: ast.Module,
              ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if not (isinstance(func, ast.Attribute)
                    and func.attr in self._KINDS):
                continue
            recv = dotted_name(func.value) or ""
            if recv.rsplit(".", 1)[-1].lower() != "registry":
                continue
            if not node.args:
                continue
            arg = node.args[0]
            if not (isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str)):
                continue  # dynamic names are the runtime lint's job
            for problem in naming.family_name_problems(
                    arg.value, self._KINDS[func.attr]):
                yield ctx.finding(self.id, arg, problem)
