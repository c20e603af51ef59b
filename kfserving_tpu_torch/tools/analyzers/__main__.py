"""kfslint CLI for the port: ``python -m
kfserving_tpu_torch.tools.analyzers``.

The JAX package's CLI (``kfserving_tpu/tools/analyzers/__main__.py``)
less ``--write-fault-sites``: the port's manifest is written by hand.
A rewritten baseline keeps each surviving entry's ``justification``."""

import argparse
import json
import sys
from typing import List, Optional

from kfserving_tpu_torch.tools import analyzers


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m kfserving_tpu_torch.tools.analyzers",
        description=("AST-based concurrency & serving-discipline "
                     "analyzer (kfslint)"))
    parser.add_argument(
        "paths", nargs="*",
        help="files/directories to analyze (default: the installed "
             "kfserving_tpu_torch package plus tests/test_torch_*.py "
             "and chip_smoke.py next to it)")
    parser.add_argument(
        "--baseline", default=None,
        help="baseline JSON path (default: the committed "
             "baseline.json next to the analyzers package)")
    parser.add_argument(
        "--no-baseline", action="store_true",
        help="report every finding, ignoring the baseline")
    parser.add_argument(
        "--write-baseline", action="store_true",
        help="rewrite the baseline from the current findings "
             "(pragma-suppressed findings stay out)")
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print rule ids and descriptions, then exit")
    parser.add_argument(
        "--json", action="store_true", dest="as_json",
        help="emit findings as JSON (alias for --format json)")
    parser.add_argument(
        "--format", choices=("text", "json", "github"),
        default=None, dest="fmt",
        help="output mode: text (default), json, or github "
             "workflow-annotation lines (::error file=...,line=...) "
             "so CI surfaces findings inline on the PR diff")
    args = parser.parse_args(argv)
    fmt = args.fmt or ("json" if args.as_json else "text")

    if args.list_rules:
        for rule in analyzers.default_rules():
            print(f"{rule.id:20s} {rule.description}")
        return 0

    paths = args.paths or analyzers.default_targets()
    try:
        findings = analyzers.analyze_paths(paths,
                                           analyzers.default_rules())
    except FileNotFoundError as e:
        print(f"kfslint: {e}", file=sys.stderr)
        return 2

    baseline_path = args.baseline or analyzers.default_baseline_path()
    if args.write_baseline:
        analyzers.save_baseline(baseline_path, findings,
                                keep=analyzers.load_baseline(
                                    baseline_path))
        print(f"wrote {len(findings)} baseline entries to "
              f"{baseline_path}")
        return 0

    baseline = [] if args.no_baseline \
        else analyzers.load_baseline(baseline_path)
    new, stale = analyzers.apply_baseline(findings, baseline)

    if fmt == "json":
        print(json.dumps({
            "findings": [vars(f) for f in new],
            "stale_baseline": stale,
        }, indent=2))
    elif fmt == "github":
        # One workflow-annotation line per finding: GitHub renders
        # these inline on the PR diff.  Newlines would start a new
        # (malformed) annotation, so flatten the message.
        for f in sorted(new, key=lambda f: (f.path, f.line, f.rule)):
            msg = " ".join(f.message.split())
            print(f"::error file={f.path},line={f.line},"
                  f"title=kfslint {f.rule}::{msg}")
        for entry in stale:
            print(f"::error file={entry.get('path')},line=1,"
                  f"title=kfslint stale-baseline::stale baseline "
                  f"entry [{entry.get('rule')}] "
                  f"{entry.get('snippet')!r} — the finding no longer "
                  f"exists; remove it from {baseline_path}")
    else:
        for f in sorted(new, key=lambda f: (f.path, f.line, f.rule)):
            print(f.render())
        for entry in stale:
            print(f"{entry.get('path')}: stale baseline entry "
                  f"[{entry.get('rule')}] {entry.get('snippet')!r} — "
                  f"the finding no longer exists; remove it from "
                  f"{baseline_path}")
        summary = (f"kfslint: {len(new)} finding(s), "
                   f"{len(stale)} stale baseline entr"
                   f"{'y' if len(stale) == 1 else 'ies'}")
        print(summary if (new or stale) else "kfslint: clean")
    return 1 if (new or stale) else 0


if __name__ == "__main__":
    sys.exit(main())
