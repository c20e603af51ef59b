"""kfslint for the port (``kfserving_tpu_torch/tools/analyzers``) against
the JAX package's (``kfserving_tpu/tools/analyzers``), on the CPU.

- the rule ids are the JAX package's ten, in its order;
- every rule fires exactly on its golden fixture's ``# FIRE`` lines and
  stays silent on its clean fixture (``tests/fixtures/kfslint_torch/``;
  the walker skips ``fixtures`` directories);
- on the JAX package's own fixtures (``tests/fixtures/kfslint/``, read,
  not edited) the six rules that know no JAX give the JAX analyzer's
  (rule, line) findings;
- pragmas, the baseline (churn, budget, stale entries) and the CLI's
  exit codes behave as ``tests/test_static_analysis.py`` holds the JAX
  package's to, each a case of one parametrized test;
- the live port tree (the package, ``tests/test_torch_*.py``,
  ``chip_smoke.py``) is clean modulo the port's baseline, each entry of
  which says why it stays; the new test files are clean under the JAX
  kfslint too, which scans ``tests/``.
"""

import json
import os

import pytest

from kfserving_tpu.tools import analyzers as jax_analyzers
from kfserving_tpu_torch.tools import analyzers
from kfserving_tpu_torch.tools.analyzers.__main__ import main as kfslint_main
from kfserving_tpu_torch.tools.analyzers.core import (
    Finding,
    analyze_source,
    apply_baseline,
    iter_python_files,
    pragma_lines,
)

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "fixtures", "kfslint_torch")
JAX_FIXTURES = os.path.join(HERE, "fixtures", "kfslint")

RULE_FIXTURES = [
    ("async-blocking", "async_blocking"),
    ("spin-loop", "spin_loop"),
    ("await-under-lock", "await_under_lock"),
    ("cancellation-safety", "cancellation"),
    ("fault-site", "fault_site"),
    ("metric-name", "metric_name"),
    ("host-sync", "host_sync"),
    ("jit-recompile-hazard", "jit_recompile"),
    ("blocking-dispatch", "blocking_dispatch"),
    ("prng-key-reuse", "prng_reuse"),
]
# The rules whose JAX implementation knows nothing of JAX: the port
# keeps copies, which must agree with them finding for finding.
JAX_FREE = RULE_FIXTURES[:6]


def _analyze(path, package=analyzers):
    return package.analyze_paths([path], package.default_rules())


def _fire_lines(path):
    with open(path) as f:
        return {i for i, line in enumerate(f, start=1) if "# FIRE" in line}


def test_rule_ids_are_the_jax_packages():
    assert analyzers.rule_ids() == jax_analyzers.rule_ids()
    assert [r for r, _ in RULE_FIXTURES] == analyzers.rule_ids()


@pytest.mark.parametrize("rule,stem", RULE_FIXTURES)
def test_rule_fires_exactly_on_golden_fixture(rule, stem):
    path = os.path.join(FIXTURES, f"{stem}_fire.py")
    fire = _fire_lines(path)
    assert fire, f"{path} has no FIRE markers"
    assert {f.line for f in _analyze(path) if f.rule == rule} == fire


@pytest.mark.parametrize("rule,stem", RULE_FIXTURES)
def test_rule_silent_on_clean_fixture(rule, stem):
    findings = _analyze(os.path.join(FIXTURES, f"{stem}_clean.py"))
    assert findings == [], [f.render() for f in findings]


@pytest.mark.parametrize("kind", ["fire", "clean"])
@pytest.mark.parametrize("rule,stem", JAX_FREE)
def test_jax_free_rules_agree_with_the_jax_analyzer(rule, stem, kind):
    """The JAX package's fixture through both analyzers: the same
    (rule, line) findings of the six JAX-free rules."""
    path = os.path.join(JAX_FIXTURES, f"{stem}_{kind}.py")
    names = {r for r, _ in JAX_FREE}

    def found(package):
        return sorted((f.rule, f.line) for f in _analyze(path, package)
                      if f.rule in names)

    assert found(analyzers) == found(jax_analyzers)
    if kind == "fire":
        assert {line for r, line in found(analyzers) if r == rule} == \
            _fire_lines(path)


# ------------------------------------------------------------- pragmas
PRAGMA_CASES = {
    # Trailing, and standalone heading a wrapped comment block.
    "placement": (
        "import time\n"
        "async def f():\n"
        "    time.sleep(1)  # kfslint: disable=async-blocking — why\n"
        "    # kfslint: disable=async-blocking — heads a comment\n"
        "    # block wrapping onto a second line.\n"
        "    time.sleep(2)\n", []),
    # A pragma with intervening code does not blanket the function.
    "line_tight": (
        "import time\n"
        "async def f():\n"
        "    # kfslint: disable=async-blocking — only the next line\n"
        "    time.sleep(1)\n"
        "    time.sleep(2)\n", [("async-blocking", 5)]),
    "named_rules_only": (
        "import time\n"
        "async def f():\n"
        "    time.sleep(1)  # kfslint: disable=spin-loop — wrong rule\n",
        [("async-blocking", 3)]),
    "string_literal_inert": (
        "import time\n"
        "async def f():\n"
        "    s = '# kfslint: disable=async-blocking'\n"
        "    time.sleep(1)\n", [("async-blocking", 4)]),
    "device_tier": (
        "import torch\n"
        "async def f(module, x):\n"
        "    # kfslint: disable=host-sync,blocking-dispatch sanctioned\n"
        "    y = module(x).item()\n"
        "    torch.cuda.synchronize()  # kfslint: disable=host-sync\n",
        [("blocking-dispatch", 5)]),
}


@pytest.mark.parametrize("case", sorted(PRAGMA_CASES))
def test_pragma_semantics_match_the_jax_package(case):
    src, want = PRAGMA_CASES[case]
    got = sorted((f.rule, f.line) for f in analyze_source(
        src, "x.py", analyzers.default_rules()))
    assert got == want
    if case in ("placement", "line_tight", "named_rules_only",
                "string_literal_inert"):
        jax = sorted((f.rule, f.line) for f in jax_analyzers.analyze_source(
            src, "x.py", jax_analyzers.default_rules()))
        assert got == jax
    if case == "placement":
        assert pragma_lines(src) == {3: {"async-blocking"},
                                     6: {"async-blocking"}}


# ------------------------------------------------------------ baseline
def _finding(line=3, snippet="while x:"):
    return Finding(rule="spin-loop", path="a.py", line=line, message="m",
                   snippet=snippet)


BASELINE_CASES = {
    # A finding whose line moved still matches its entry.
    "line_churn": ([_finding(line=99)],
                   [{"rule": "spin-loop", "path": "a.py", "line": 3,
                     "snippet": "while x:"}], 0, 0),
    # One entry consumes one finding.
    "budget": ([_finding(line=3), _finding(line=30)],
               [{"rule": "spin-loop", "path": "a.py",
                 "snippet": "while x:"}], 1, 0),
    # An entry whose finding is gone is stale.
    "stale": ([], [{"rule": "spin-loop", "path": "a.py",
                    "snippet": "while gone:"}], 0, 1),
}


@pytest.mark.parametrize("case", sorted(BASELINE_CASES))
def test_baseline_matches_the_jax_package(case):
    findings, baseline, n_new, n_stale = BASELINE_CASES[case]
    new, stale = apply_baseline(findings, baseline)
    jax_new, jax_stale = jax_analyzers.apply_baseline(findings, baseline)
    assert (len(new), len(stale)) == (n_new, n_stale)
    assert (new, stale) == (jax_new, jax_stale)


# ----------------------------------------------------------------- CLI
def _cli_stale(tmp_path):
    clean = os.path.join(FIXTURES, "spin_loop_clean.py")
    bl = tmp_path / "baseline.json"
    bl.write_text(json.dumps([{"rule": "spin-loop", "path": clean,
                               "snippet": "while nothing_matches_this:"}]))
    return [[clean, "--baseline", str(bl)]], 1, "stale baseline entry"


def _cli_write_then_clean(tmp_path):
    fire = os.path.join(FIXTURES, "spin_loop_fire.py")
    bl = str(tmp_path / "baseline.json")
    return ([[fire, "--baseline", bl, "--write-baseline"],
             [fire, "--baseline", bl]], 0, "kfslint: clean")


def _cli_missing_path(tmp_path):
    return [["no/such/dir", "--no-baseline"]], 2, "no such file"


def _cli_findings(tmp_path):
    return ([[os.path.join(FIXTURES, "host_sync_fire.py"),
              "--no-baseline"]], 1, "[host-sync]")


def _cli_list_rules(tmp_path):
    return [["--list-rules"]], 0, "prng-key-reuse"


def _cli_github(tmp_path):
    return ([[os.path.join(FIXTURES, "spin_loop_fire.py"), "--no-baseline",
              "--format", "github"]], 1, "title=kfslint spin-loop")


CLI_CASES = {"stale_baseline": _cli_stale,
             "write_baseline_then_clean": _cli_write_then_clean,
             "missing_path": _cli_missing_path,
             "findings": _cli_findings, "list_rules": _cli_list_rules,
             "github_format": _cli_github}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_exit_codes(case, tmp_path, capsys):
    runs, rc, text = CLI_CASES[case](tmp_path)
    for argv in runs:
        got = kfslint_main(argv)
    assert got == rc
    out = capsys.readouterr()
    assert text in out.out + out.err


def test_write_baseline_keeps_justifications(tmp_path):
    fire = os.path.join(FIXTURES, "spin_loop_fire.py")
    bl = tmp_path / "baseline.json"
    assert kfslint_main([fire, "--baseline", str(bl),
                         "--write-baseline"]) == 0
    entries = json.loads(bl.read_text())
    entries[0]["justification"] = "kept on purpose"
    bl.write_text(json.dumps(entries))
    assert kfslint_main([fire, "--baseline", str(bl),
                         "--write-baseline"]) == 0
    again = json.loads(bl.read_text())
    assert again[0]["justification"] == "kept on purpose"
    assert all("justification" not in e for e in again[1:])


# ------------------------------------------------------------ live tree
def test_live_port_tree_is_clean_modulo_its_baseline():
    findings = analyzers.analyze_paths(analyzers.default_targets(),
                                       analyzers.default_rules())
    baseline = analyzers.load_baseline(analyzers.default_baseline_path())
    new, stale = apply_baseline(findings, baseline)
    assert new == [], "kfslint findings:\n" + "\n".join(
        f.render() for f in new)
    assert stale == [], f"stale baseline entries: {stale}"
    assert all(e.get("justification") for e in baseline)


def test_default_targets_are_the_port_its_tests_and_chip_smoke():
    targets = analyzers.default_targets()
    names = {os.path.basename(t) for t in targets}
    assert {"kfserving_tpu_torch", "chip_smoke.py",
            "test_torch_static_analysis.py",
            "test_torch_mesh_modes.py"} <= names
    scanned = list(iter_python_files(targets))
    assert not any("fixtures" in p for p in scanned)
    assert not any(os.path.basename(p) == "test_static_analysis.py"
                   for p in scanned)


@pytest.mark.parametrize("name", ["test_torch_static_analysis.py",
                                  "test_torch_mesh_modes.py"])
def test_new_test_files_are_clean_under_both_analyzers(name):
    path = os.path.join(HERE, name)
    for package in (analyzers, jax_analyzers):
        findings = _analyze(path, package)
        assert findings == [], [f.render() for f in findings]
