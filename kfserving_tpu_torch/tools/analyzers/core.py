"""kfslint core: findings, pragmas, baseline, and the file walker.

Port of ``kfserving_tpu/tools/analyzers/core.py``: the port keeps its
own copy (it imports nothing of the JAX package); only the checkout
root a path normalizes against is the port package's parent.

Every rule is a stdlib-`ast` visitor producing `Finding`s with a
stable (rule, path, snippet) identity.  The framework owns everything
rules share:

- **pragmas** — `# kfslint: disable=<rule>[,<rule>...] <justification>`
  on the *finding's line* suppresses exactly those rules on exactly
  that line (comments are located with `tokenize`, so a pragma-shaped
  string literal never suppresses anything).  Scoping is deliberately
  line-tight: a pragma cannot blanket a function or file, so every
  deliberate violation carries its justification next to the code it
  excuses.
- **baseline** — a committed JSON list of known findings
  (`baseline.json` next to this package).  Findings matching a
  baseline entry don't fail the run; a baseline entry whose finding no
  longer exists is *stale* and FAILS the run (a fixed defect must be
  removed from the baseline, or the baseline rots into a blanket
  waiver).  Matching is by (rule, path, snippet) — line-number churn
  from unrelated edits never invalidates the baseline.
- **the walker** — `.py` files under the given roots, skipping
  `__pycache__` and generated protobuf modules.

Rules implement `check(tree, ctx)` (per file) and optionally
`finalize()` (tree-level cross-file checks, e.g. fault-site coverage).
"""

import ast
import io
import json
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Set, Tuple

_PRAGMA_RE = re.compile(r"#\s*kfslint:\s*disable=([\w,\-]+)")

# Generated modules are not hand-maintained; their style is the
# generator's problem, and protobuf output trips no serving rules.
_SKIP_FILE_RE = re.compile(r"_pb2(_grpc)?\.py$")

# Golden lint fixtures FIRE by design — scanning them would demand
# baselining deliberate violations.  Their tests analyze them one
# file at a time, which bypasses this prune.
_SKIP_DIR_NAMES = {"__pycache__", "fixtures"}


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str          # posix path as given to the walker
    line: int          # 1-based line of the offending node
    message: str
    snippet: str = ""  # stripped source line (baseline identity)

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"

    def key(self) -> Tuple[str, str, str]:
        return (self.rule, self.path, self.snippet)


@dataclass
class FileContext:
    """Everything a rule may want about the file under analysis."""
    path: str
    source: str
    lines: List[str] = field(default_factory=list)

    def __post_init__(self):
        if not self.lines:
            self.lines = self.source.splitlines()

    def snippet(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 0)
        return Finding(rule=rule, path=self.path, line=line,
                       message=message, snippet=self.snippet(line))


class Rule:
    """One analysis rule.  Subclasses set `id`/`description` and yield
    findings from `check`; tree-level rules may also yield from
    `finalize` after every file has been seen."""

    id: str = ""
    description: str = ""

    def check(self, tree: ast.Module,
              ctx: FileContext) -> Iterator[Finding]:
        raise NotImplementedError

    def finalize(self) -> Iterator[Finding]:
        return iter(())


# -- pragmas ----------------------------------------------------------------

def pragma_lines(source: str) -> Dict[int, Set[str]]:
    """{line: {rule, ...}} for every kfslint pragma comment.

    Two placements, both line-scoped:

    - trailing (``stmt  # kfslint: disable=r``) suppresses on the
      comment's own line;
    - standalone (a comment-only line) suppresses on the NEXT code
      line, skipping blank and comment-only lines — so a pragma can
      head a wrapped comment block above the statement it excuses.

    Tokenize-based so only real comments count; a source file that
    fails tokenization (it already parsed, so this is rare) falls back
    to a line-regex scan rather than silently losing its pragmas.
    """
    lines = source.splitlines()

    def _is_code(idx0: int) -> bool:
        stripped = lines[idx0].strip()
        return bool(stripped) and not stripped.startswith("#")

    def _target(line: int, col: int) -> int:
        if lines[line - 1][:col].strip():
            return line  # trailing: the statement shares the line
        for nxt in range(line, len(lines)):
            if _is_code(nxt):
                return nxt + 1
        return 0  # pragma at EOF: nothing to suppress

    pragmas: Dict[int, Set[str]] = {}

    def _add(line: int, col: int, text: str) -> None:
        m = _PRAGMA_RE.search(text)
        if m:
            rules = {r.strip() for r in m.group(1).split(",")
                     if r.strip()}
            pragmas.setdefault(_target(line, col),
                               set()).update(rules)

    try:
        for tok in tokenize.generate_tokens(
                io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                _add(tok.start[0], tok.start[1], tok.string)
    except (tokenize.TokenError, IndentationError):
        for i, line in enumerate(source.splitlines(), start=1):
            if "#" in line:
                _add(i, line.index("#"), line)
    return pragmas


# -- per-file analysis ------------------------------------------------------

def analyze_source(source: str, path: str, rules: Iterable[Rule],
                   respect_pragmas: bool = True) -> List[Finding]:
    """Run `rules` over one file's source.  A syntax error becomes a
    `parse-error` finding (an unparseable file in the serving tree is
    itself a defect, not a reason to skip analysis silently)."""
    ctx = FileContext(path=path, source=source)
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding(rule="parse-error", path=path,
                        line=e.lineno or 0,
                        message=f"file does not parse: {e.msg}",
                        snippet=ctx.snippet(e.lineno or 0))]
    findings: List[Finding] = []
    suppress = pragma_lines(source) if respect_pragmas else {}
    for rule in rules:
        for f in rule.check(tree, ctx):
            if f.rule in suppress.get(f.line, ()):
                continue
            findings.append(f)
    return findings


def iter_python_files(paths: Iterable[str]) -> Iterator[str]:
    for root in paths:
        if not os.path.exists(root):
            # A typo'd path must not scan zero files and pass as
            # "clean".
            raise FileNotFoundError(f"no such file or directory: "
                                    f"{root!r}")
        if os.path.isfile(root):
            if root.endswith(".py"):
                yield root
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in _SKIP_DIR_NAMES)
            for name in sorted(filenames):
                if name.endswith(".py") \
                        and not _SKIP_FILE_RE.search(name):
                    yield os.path.join(dirpath, name)


_repo_root_cache: List[Optional[str]] = []


def _repo_root() -> Optional[str]:
    """The checkout root (the installed package's parent) — lazy and
    cached; None when the package can't be located."""
    if not _repo_root_cache:
        try:
            import kfserving_tpu_torch
            _repo_root_cache.append(os.path.dirname(os.path.dirname(
                os.path.abspath(kfserving_tpu_torch.__file__))))
        except Exception:
            _repo_root_cache.append(None)
    return _repo_root_cache[0]


def normalize_path(path: str) -> str:
    """Stable finding/baseline path identity, posix separators.
    Paths inside the checkout normalize relative to the REPO ROOT —
    not the CWD — so the committed baseline (keyed on
    'chip_smoke.py', 'kfserving_tpu_torch/...') matches however and from
    wherever the run was spelled.  Paths outside the checkout fall
    back to CWD-relative."""
    abspath = os.path.abspath(path)
    root = _repo_root()
    if root is not None \
            and abspath.startswith(root.rstrip(os.sep) + os.sep):
        return os.path.relpath(abspath, root).replace(os.sep, "/")
    return os.path.relpath(abspath).replace(os.sep, "/")


def analyze_paths(paths: Iterable[str], rules: List[Rule],
                  respect_pragmas: bool = True) -> List[Finding]:
    sources: Dict[str, str] = {}
    for path in iter_python_files(paths):
        with open(path, "r", encoding="utf-8") as fh:
            sources[normalize_path(path)] = fh.read()
    return analyze_snippets(sources, rules,
                            respect_pragmas=respect_pragmas)


def analyze_snippets(sources: Dict[str, str], rules: List[Rule],
                     respect_pragmas: bool = True) -> List[Finding]:
    """The per-file + finalize + pragma pipeline over in-memory
    sources ({path: source}).  `analyze_paths` delegates here after
    reading and path-normalizing; tests and tools can call it
    directly without touching disk.  finalize() findings (cross-file
    rules) honor pragmas too — a helper-reached blocking call is
    suppressed at its call-site line like any direct finding."""
    findings: List[Finding] = []
    pragmas_by_path = {
        path: (pragma_lines(src) if respect_pragmas else {})
        for path, src in sources.items()}
    for path, src in sources.items():
        for f in analyze_source(src, path, rules,
                                respect_pragmas=False):
            if f.rule not in pragmas_by_path[path].get(f.line, ()):
                findings.append(f)
    for rule in rules:
        for f in rule.finalize():
            if f.rule in pragmas_by_path.get(f.path, {}).get(f.line,
                                                             ()):
                continue
            findings.append(f)
    return findings


# -- baseline ---------------------------------------------------------------

def load_baseline(path: str) -> List[Dict[str, str]]:
    if not os.path.exists(path):
        return []
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    if not isinstance(data, list):
        raise ValueError(f"baseline {path}: expected a JSON list")
    return data


def save_baseline(path: str, findings: List[Finding],
                  keep: Optional[List[Dict[str, str]]] = None) -> None:
    """Write the findings as the baseline.  ``keep``: the entries of the
    baseline being rewritten; a finding that matches one keeps its
    ``justification`` (the one line saying why it stays)."""
    why = {(e.get("rule", ""), e.get("path", ""), e.get("snippet", "")):
           e["justification"] for e in keep or ()
           if e.get("justification")}
    entries = []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule)):
        entry = {"rule": f.rule, "path": f.path, "line": f.line,
                 "snippet": f.snippet, "message": f.message}
        if f.key() in why:
            entry["justification"] = why[f.key()]
        entries.append(entry)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(entries, fh, indent=2)
        fh.write("\n")


def apply_baseline(findings: List[Finding],
                   baseline: List[Dict[str, str]]
                   ) -> Tuple[List[Finding], List[Dict[str, str]]]:
    """Split into (new findings, stale baseline entries).

    Each baseline entry consumes at most one matching live finding
    (two identical snippets need two entries), so the baseline can
    never grow looser than what was committed.
    """
    budget: Dict[Tuple[str, str, str], int] = {}
    for entry in baseline:
        key = (entry.get("rule", ""), entry.get("path", ""),
               entry.get("snippet", ""))
        budget[key] = budget.get(key, 0) + 1
    new: List[Finding] = []
    for f in findings:
        key = f.key()
        if budget.get(key, 0) > 0:
            budget[key] -= 1
        else:
            new.append(f)
    stale: List[Dict[str, str]] = []
    remaining = dict(budget)
    for entry in baseline:
        key = (entry.get("rule", ""), entry.get("path", ""),
               entry.get("snippet", ""))
        if remaining.get(key, 0) > 0:
            remaining[key] -= 1
            stale.append(entry)
    return new, stale


# -- shared scoping policy --------------------------------------------------

def is_test_function(name: str) -> bool:
    """`test*` functions are harnesses: each drives a private event
    loop with no other traffic on it, and legitimately does setup I/O
    and device fetches to assert on results.  Event-loop *throughput*
    rules (async-blocking, host-sync, blocking-dispatch) skip them —
    stalling a loop nobody shares is not the defect class.  Liveness
    and correctness rules (spin-loop, prng-key-reuse, the discipline
    pair) stay in force: a livelocked test hangs CI exactly like a
    livelocked scheduler hangs serving."""
    return name.startswith("test")


# -- shared AST helpers -----------------------------------------------------

def dotted_name(node: ast.AST) -> Optional[str]:
    """`a.b.c` for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def iter_body_nodes(stmts: Iterable[ast.stmt],
                    skip_nested_defs: bool = True) -> Iterator[ast.AST]:
    """Walk statements, optionally NOT descending into nested
    function/class definitions (their bodies run in a different
    execution context than the enclosing async frame)."""
    stack: List[ast.AST] = list(stmts)
    skip = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
            ast.ClassDef)
    while stack:
        node = stack.pop()
        yield node
        # A nested def is yielded (it IS a statement of this body) but
        # never expanded — its inner statements belong to a different
        # execution context.
        if skip_nested_defs and isinstance(node, skip):
            continue
        stack.extend(ast.iter_child_nodes(node))


def contains_await(stmts: Iterable[ast.stmt]) -> bool:
    """True if the statements await anything (Await / async for /
    async with), ignoring nested function bodies."""
    for node in iter_body_nodes(stmts):
        if isinstance(node, (ast.Await, ast.AsyncFor, ast.AsyncWith)):
            return True
    return False
