"""kfslint device tier — PyTorch/CUDA hot-path discipline rules.

The counterpart of ``kfserving_tpu/tools/analyzers/devicerules.py``:
the same four rule ids, each encoding the JAX rule's defect class for
torch on the card.  The port's hot path rests on the same two
invariants: decode waves never synchronize with the host implicitly
(results come back through pinned copies behind an event, waited on
the fetch executor), and CUDA graphs are captured per *bucket*, never
per request.

- `host-sync`: an implicit device->host transfer (`.item()`,
  `.tolist()`, `.cpu()`, `.numpy()`, `float()`/`int()`/`bool()` or
  `np.asarray` of a value data-flowed from a `torch.*` call, a module
  forward, a graph replay or a device move) and any explicit
  synchronize (`torch.cuda.synchronize()`, an Event's or a Stream's
  `.synchronize()`), inside an `async def` or a wave/dispatch/
  prefill/decode/fetch-named sync function: the host joins the
  card's stream on the spot.  The sanctioned fetch points carry
  line-tight pragmas naming themselves sanctioned.
- `jit-recompile-hazard`: a request-derived Python size (`len(...)`,
  `.size`, `.shape[i]`, `.size(i)`, `.numel()`) reaching a CUDA graph
  capture (`torch.cuda.graph`, `graphs.capture`) or a program key
  (`_run_program`, `_compile_program`) without passing through a
  bucketing call: one capture, and one graph pool's memory, per
  distinct request shape.
- `blocking-dispatch`: device work that waits or runs long (a module
  forward, `graph.replay()`, a CUDA graph capture, a synchronize)
  invoked in an `async def` stalls the event loop; the same calls under
  a held `threading` lock convoy every thread behind the dispatch.
- `prng-key-reuse`: one threefry key (``engine/threefry.py``'s
  stateless keys, JAX's) consumed by two draws (`random_bits`,
  `uniform`, `gumbel`) without an intervening `fold_in`: the draws
  repeat.  A `torch.Generator` advances with every draw, so its reuse
  is a re-seed: `g.manual_seed(s)` to a seed whose state an earlier
  draw already consumed, then another draw — the same numbers again.

Dataflow is per-function and shallow, as in the JAX tier (assignment-
chain taint, no cross-function propagation).  Device handles passed
between helpers named `*_h` are taint sources; a module forward is a
call of a name ending in `module` or `model`.
"""

import ast
import re
from typing import Dict, Iterator, List, Optional, Set, Tuple

from kfserving_tpu_torch.tools.analyzers.asyncrules import (
    _classify_locks,
    _import_aliases,
    _lockish_name,
    _resolve,
)
from kfserving_tpu_torch.tools.analyzers.core import (
    FileContext,
    Finding,
    Rule,
    dotted_name,
    is_test_function,
)

# Sync functions with one of these whole snake_case segments in their
# name are hot-path device code (they run on the engine's enqueue/fetch
# executors): `_fetch`, `_enqueue_wave`, `_prefill_program`.
_HOT_SEGMENTS = {"wave", "waves", "dispatch", "prefill", "decode",
                 "fetch"}

# Attributes and methods that yield host METADATA of a tensor, not its
# contents: `int(x.shape[0])` and `x.size(0)` are free.
_METADATA_ATTRS = {"shape", "dtype", "ndim", "device", "is_cuda",
                   "layout", "requires_grad", "size", "numel", "dim",
                   "element_size", "data_ptr"}

_DEVICE_HANDLE_PARAM = re.compile(r"_h\d*$")


def _taint_target(tainted: Set[str], target: ast.AST) -> None:
    """Record an assignment target (Name, self-attribute, or any
    nesting of tuple/list/starred unpacking) into a taint set."""
    if isinstance(target, ast.Name):
        tainted.add(target.id)
    elif isinstance(target, ast.Attribute):
        tainted.add(target.attr)
    elif isinstance(target, (ast.Tuple, ast.List)):
        for elt in target.elts:
            _taint_target(tainted, elt)
    elif isinstance(target, ast.Starred):
        _taint_target(tainted, target.value)


def _untaint_target(tainted: Set[str], target: ast.AST) -> None:
    """Reassignment from a clean RHS kills taint."""
    if isinstance(target, ast.Name):
        tainted.discard(target.id)
    elif isinstance(target, ast.Attribute):
        tainted.discard(target.attr)
    elif isinstance(target, (ast.Tuple, ast.List)):
        for elt in target.elts:
            _untaint_target(tainted, elt)
    elif isinstance(target, ast.Starred):
        _untaint_target(tainted, target.value)


def _hot_sync_name(name: str) -> bool:
    return any(seg in _HOT_SEGMENTS for seg in name.lower().split("_"))


def _call_parts(call: ast.Call) -> Tuple[Optional[str], List[str]]:
    name = dotted_name(call.func)
    return name, (name.split(".") if name else [])


def _bare(call: ast.Call) -> Optional[str]:
    """The called attribute or name, whatever the receiver (a call or a
    subscript has no dotted name)."""
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    if isinstance(call.func, ast.Name):
        return call.func.id
    return None


# A name ending in module/model whose first word is one of these names
# an accessor or an action on a model (`get_model`, `register_model`),
# not the model's forward.
_VERBS = {"get", "set", "register", "apply", "remove", "delete",
          "create", "validate", "load", "unload", "make", "build", "add",
          "update", "find", "resolve", "save", "list", "wrap", "convert",
          "shard", "to", "from", "is", "has", "reset", "check",
          "served", "serve"}


def _is_forward(call: ast.Call) -> bool:
    """A module forward: a call of a lower-case name ending in
    `module`/`model` (`self.module(ids)`, `self._draft_module(w)`,
    `model(x)`), not a class (`TrainedModel(...)`) or an accessor
    (`get_model(...)`)."""
    bare = _bare(call)
    if bare is None or not bare.lower().endswith(("module", "model")) \
            or bare.lstrip("_")[:1].isupper():
        return False
    return bare.lstrip("_").split("_")[0].lower() not in _VERBS


def _is_capture(call: ast.Call, aliases: Dict[str, str]) -> bool:
    name, parts = _call_parts(call)
    if name is None:
        return False
    resolved = _resolve(name, aliases)
    return (resolved in ("torch.cuda.graph", "torch.cuda.CUDAGraph")
            or parts[-1] in ("capture", "capture_begin")
            and (len(parts) == 1 or "graph" in parts[-2].lower()))


def _is_device_call(call: ast.Call, aliases: Dict[str, str]) -> bool:
    """Does this call produce device values: a `torch.*` op, a module
    forward, a graph replay, or a move to the card?"""
    if _is_forward(call) or _bare(call) in ("replay", "cuda", "to"):
        return True
    name, _parts = _call_parts(call)
    if name is None:
        return False
    resolved = _resolve(name, aliases)
    return resolved == "torch" or resolved.startswith("torch.")


def _iter_scoped_functions(tree: ast.Module
                           ) -> Iterator[Tuple[ast.AST, str]]:
    """All `async def`s plus sync defs with a hot-path name segment
    (test functions excepted: each drives a private loop)."""
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)) \
                or is_test_function(node.name):
            continue
        if isinstance(node, ast.AsyncFunctionDef):
            yield node, f"async def {node.name}"
        elif _hot_sync_name(node.name):
            yield node, f"def {node.name}"


def _stmt_calls(stmt: ast.stmt) -> Iterator[ast.Call]:
    """Call nodes belonging to THIS statement (not to child blocks or
    nested defs)."""
    bodies = set()
    for body in _child_bodies(stmt):
        for s in body:
            bodies.add(s)
    stack: List[ast.AST] = [stmt]
    while stack:
        node = stack.pop()
        if node in bodies or isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef,
                       ast.ClassDef, ast.Lambda)):
            continue
        if isinstance(node, ast.Call):
            yield node
        stack.extend(ast.iter_child_nodes(node))


def _child_bodies(stmt: ast.stmt) -> Iterator[List[ast.stmt]]:
    for name in ("body", "orelse", "finalbody"):
        block = getattr(stmt, name, None)
        if isinstance(block, list) and block \
                and isinstance(block[0], ast.stmt):
            yield block
    for handler in getattr(stmt, "handlers", []):
        yield handler.body


def _iter_own_nodes(stmts: List[ast.stmt]) -> Iterator[ast.AST]:
    """All nodes in these statements, not descending into nested
    function/class bodies (different execution context)."""
    stack: List[ast.AST] = list(stmts)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


# -- rule 1: host-sync -------------------------------------------------------

_SCALAR_SINKS = {"float", "int", "bool"}
_METHOD_SINKS = {"item", "tolist", "cpu", "numpy"}
_FETCH_FNS = {"numpy.asarray", "numpy.array"}


class _TaintScan:
    """One function body's device-value taint walk (source order;
    branch bodies share the taint set, an over-approximation backed by
    line-tight pragmas)."""

    def __init__(self, rule: "HostSyncRule", fn, where: str,
                 ctx: FileContext, aliases: Dict[str, str],
                 findings: List[Finding]):
        self.rule = rule
        self.where = where
        self.ctx = ctx
        self.aliases = aliases
        self.findings = findings
        self.tainted: Set[str] = set()
        for arg in (list(fn.args.posonlyargs) + list(fn.args.args)
                    + list(fn.args.kwonlyargs)):
            if _DEVICE_HANDLE_PARAM.search(arg.arg):
                self.tainted.add(arg.arg)

    def expr_tainted(self, expr: Optional[ast.AST]) -> bool:
        if expr is None:
            return False
        stack = [expr]
        while stack:
            node = stack.pop()
            if isinstance(node, ast.Attribute) \
                    and node.attr in _METADATA_ATTRS:
                continue
            if isinstance(node, ast.Lambda):
                continue
            if isinstance(node, ast.Name) and node.id in self.tainted:
                return True
            if isinstance(node, ast.Attribute) \
                    and node.attr in self.tainted \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id in ("self", "cls"):
                return True
            if isinstance(node, ast.Call):
                if isinstance(node.func, ast.Attribute) \
                        and node.func.attr in _METADATA_ATTRS:
                    continue
                if _is_device_call(node, self.aliases):
                    return True
            stack.extend(ast.iter_child_nodes(node))
        return False

    def _sink(self, call: ast.Call) -> Optional[str]:
        """If ``call`` is a host materialization or a synchronize, name
        it."""
        func = call.func
        if isinstance(func, ast.Name) and func.id in _SCALAR_SINKS:
            if any(self.expr_tainted(a) for a in call.args):
                return f"{func.id}()"
            return None
        if isinstance(func, ast.Attribute):
            if func.attr == "synchronize":
                return f"{dotted_name(func) or '.synchronize'}()"
            if func.attr in _METHOD_SINKS:
                if self.expr_tainted(func.value):
                    return f".{func.attr}()"
                return None
        name, parts = _call_parts(call)
        if name is None:
            return None
        resolved = _resolve(name, self.aliases)
        if resolved in _FETCH_FNS or (
                parts[-1] in ("asarray", "array")
                and any(p in ("np", "numpy") for p in parts[:-1])):
            if any(self.expr_tainted(a) for a in call.args):
                return f"{name}()"
        return None

    def _fire(self, node: ast.AST, sink: str) -> None:
        self.findings.append(self.ctx.finding(
            self.rule.id, node,
            f"implicit device->host sync: {sink} inside '{self.where}' "
            f"joins the card's stream on the spot — copy into pinned "
            f"memory behind an event and wait on the fetch executor, "
            f"or pragma the line as a sanctioned fetch site"))

    def scan(self, stmts: List[ast.stmt]) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if isinstance(stmt, (ast.Assign, ast.AnnAssign,
                                 ast.AugAssign)):
                value = stmt.value
                awaited = isinstance(value, ast.Await)
                if awaited:
                    value = value.value
                targets = (stmt.targets if isinstance(stmt, ast.Assign)
                           else [stmt.target])
                if not awaited and self.expr_tainted(value):
                    for t in targets:
                        _taint_target(self.tainted, t)
                elif not isinstance(stmt, ast.AugAssign):
                    for t in targets:
                        _untaint_target(self.tainted, t)
            if isinstance(stmt, (ast.For, ast.AsyncFor)) \
                    and self.expr_tainted(stmt.iter):
                _taint_target(self.tainted, stmt.target)
            for node in ast.walk(stmt):
                if isinstance(node, (ast.GeneratorExp, ast.ListComp,
                                     ast.SetComp, ast.DictComp)):
                    for gen in node.generators:
                        if self.expr_tainted(gen.iter):
                            _taint_target(self.tainted, gen.target)
            for call in _stmt_calls(stmt):
                sink = self._sink(call)
                if sink is not None:
                    self._fire(call, sink)
            for body in _child_bodies(stmt):
                self.scan(body)


class HostSyncRule(Rule):
    id = "host-sync"
    description = ("implicit device->host transfer (.item/.tolist/.cpu/"
                   ".numpy/float/int/bool/np.asarray of a tensor) or a "
                   "synchronize in an async def or wave/dispatch "
                   "function")

    def check(self, tree: ast.Module,
              ctx: FileContext) -> Iterator[Finding]:
        aliases = _import_aliases(tree)
        findings: List[Finding] = []
        for fn, where in _iter_scoped_functions(tree):
            _TaintScan(self, fn, where, ctx, aliases,
                       findings).scan(fn.body)
        return iter(findings)


# -- rule 2: jit-recompile-hazard -------------------------------------------

# Calls whose arguments name a captured program: every distinct value
# of an argument is one capture (and one graph's memory).
_PROGRAM_KEYS = {"_run_program", "_compile_program"}
_CLEANSE_SEGMENTS = {"fit", "bucket", "buckets"}


def _cleansing_call(call: ast.Call) -> bool:
    """A call through the bucketing vocabulary quantizes its input:
    `policy.fit(n)`, `self._bucket_for(n)`, `pow2_buckets(n)`."""
    name, parts = _call_parts(call)
    if name is None:
        return False
    segs = set()
    for part in parts:
        segs.update(part.lower().split("_"))
    return bool(segs & _CLEANSE_SEGMENTS)


class _SizeScan:
    """Raw request-derived sizes flowing into program keys and graph
    captures, per function, source order."""

    def __init__(self, rule: "JitRecompileHazardRule", where: str,
                 ctx: FileContext, aliases: Dict[str, str],
                 findings: List[Finding]):
        self.rule = rule
        self.where = where
        self.ctx = ctx
        self.aliases = aliases
        self.findings = findings
        self.tainted: Set[str] = set()

    def _size_source(self, expr: ast.AST) -> bool:
        if isinstance(expr, ast.Call):
            if _cleansing_call(expr):
                return False
            name, _parts = _call_parts(expr)
            if name is not None \
                    and _resolve(name, self.aliases) == "len":
                return True
            return (isinstance(expr.func, ast.Attribute)
                    and expr.func.attr in ("size", "numel"))
        if isinstance(expr, ast.Attribute) and expr.attr == "size":
            return True
        return (isinstance(expr, ast.Subscript)
                and isinstance(expr.value, ast.Attribute)
                and expr.value.attr == "shape")

    def expr_tainted(self, expr: Optional[ast.AST]) -> bool:
        """A key is a value: a raw size anywhere in it (a tuple or list
        display included) is one program per distinct size."""
        if expr is None:
            return False
        stack = [expr]
        while stack:
            node = stack.pop()
            if self._size_source(node):
                return True
            if isinstance(node, ast.Name) and node.id in self.tainted:
                return True
            if isinstance(node, ast.Lambda):
                continue
            if isinstance(node, ast.Call):
                if isinstance(node.func, ast.Name) \
                        and node.func.id in ("int", "round", "abs",
                                             "min", "max", "tuple"):
                    stack.extend(node.args)
                # Other calls launder.
                continue
            stack.extend(ast.iter_child_nodes(node))
        return False

    def _check_call(self, call: ast.Call) -> None:
        bare = _bare(call)
        if bare in _PROGRAM_KEYS:
            what = f"program key of '{bare}'"
        elif _is_capture(call, self.aliases):
            what = f"CUDA graph capture '{bare}'"
        else:
            return
        for arg in list(call.args) + [k.value for k in call.keywords]:
            if self.expr_tainted(arg):
                self.findings.append(self.ctx.finding(
                    self.rule.id, arg,
                    f"request-derived size reaches the {what} in "
                    f"'{self.where}' without passing through a bucket "
                    f"fit — every distinct value captures a new graph "
                    f"(route it through a bucketing call)"))
                break

    def scan(self, stmts: List[ast.stmt]) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if isinstance(stmt, (ast.Assign, ast.AnnAssign,
                                 ast.AugAssign)):
                value = stmt.value
                if isinstance(value, ast.Await):
                    value = value.value
                if self.expr_tainted(value):
                    targets = (stmt.targets
                               if isinstance(stmt, ast.Assign)
                               else [stmt.target])
                    for t in targets:
                        _taint_target(self.tainted, t)
            for call in _stmt_calls(stmt):
                self._check_call(call)
            for body in _child_bodies(stmt):
                self.scan(body)


class JitRecompileHazardRule(Rule):
    id = "jit-recompile-hazard"
    description = ("request-derived size reaches a CUDA graph capture "
                   "or a program key without bucketing")

    def check(self, tree: ast.Module,
              ctx: FileContext) -> Iterator[Finding]:
        aliases = _import_aliases(tree)
        findings: List[Finding] = []
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
                kind = ("async def"
                        if isinstance(node, ast.AsyncFunctionDef)
                        else "def")
                _SizeScan(self, f"{kind} {node.name}", ctx, aliases,
                          findings).scan(node.body)
        return iter(findings)


# -- rule 3: blocking-dispatch ----------------------------------------------

def _dispatch_call(call: ast.Call,
                   aliases: Dict[str, str]) -> Optional[str]:
    """Name the device dispatch or wait this call performs, if any."""
    bare = _bare(call)
    if bare is None:
        return None
    if _is_forward(call):
        return f"module forward '{bare}'"
    if bare == "replay":
        return "graph replay"
    if _is_capture(call, aliases):
        return "CUDA graph capture"
    if bare == "synchronize":
        return f"{dotted_name(call.func) or '.synchronize'}()"
    return None


class BlockingDispatchRule(Rule):
    id = "blocking-dispatch"
    description = ("device work (module forward, graph replay or "
                   "capture, synchronize) on the event loop or under a "
                   "held threading lock")

    def check(self, tree: ast.Module,
              ctx: FileContext) -> Iterator[Finding]:
        aliases = _import_aliases(tree)
        lock_kinds = _classify_locks(tree, aliases)

        def is_threadlock(with_item: ast.withitem) -> Optional[str]:
            expr = with_item.context_expr
            if isinstance(expr, ast.Call):
                expr = expr.func
            base = None
            if isinstance(expr, ast.Attribute):
                base = expr.attr
            elif isinstance(expr, ast.Name):
                base = expr.id
            if base is None:
                return None
            kinds = lock_kinds.get(base, set())
            if kinds == {"threading"} or (not kinds
                                          and _lockish_name(base)):
                return base
            return None

        funcs = [n for n in ast.walk(tree)
                 if isinstance(n, (ast.FunctionDef,
                                   ast.AsyncFunctionDef))]
        with_owner: Dict[int, ast.AST] = {}
        for fn in funcs:
            for sub in _iter_own_nodes(fn.body):
                if isinstance(sub, ast.With):
                    with_owner[id(sub)] = fn
        # Lock pass first (emitted second): a dispatch under a held
        # lock gets the lock diagnosis, and the async pass skips it.
        lock_findings: List[Finding] = []
        covered: Set[int] = set()
        for node in ast.walk(tree):
            if not isinstance(node, ast.With):
                continue
            fn = with_owner.get(id(node))
            if fn is not None and is_test_function(fn.name):
                continue
            for item in node.items:
                lock = is_threadlock(item)
                if lock is None:
                    continue
                for sub in _iter_own_nodes(node.body):
                    if isinstance(sub, ast.Call):
                        what = _dispatch_call(sub, aliases)
                        if what is not None:
                            covered.add(id(sub))
                            lock_findings.append(ctx.finding(
                                self.id, sub,
                                f"{what} under held lock `{lock}` — "
                                f"the dispatch convoys every thread "
                                f"waiting on the lock; dispatch "
                                f"outside the hold"))
                break
        for node in funcs:
            if not isinstance(node, ast.AsyncFunctionDef) \
                    or is_test_function(node.name):
                continue
            for sub in _iter_own_nodes(node.body):
                if isinstance(sub, ast.Call) and id(sub) not in covered:
                    what = _dispatch_call(sub, aliases)
                    if what is not None:
                        yield ctx.finding(
                            self.id, sub,
                            f"{what} inside 'async def {node.name}' "
                            f"stalls the event loop for device time — "
                            f"dispatch on the enqueue executor")
        for finding in lock_findings:
            yield finding


# -- rule 4: prng-key-reuse --------------------------------------------------

_KEY_MAKERS = {"prng_key", "fold_in"}
_KEY_DRAWS = {"random_bits", "uniform", "gumbel"}


class PrngKeyReuseRule(Rule):
    id = "prng-key-reuse"
    description = ("a threefry key consumed by two draws without a "
                   "fold_in, or a torch.Generator re-seeded to a state "
                   "an earlier draw consumed (the draws repeat)")

    def check(self, tree: ast.Module,
              ctx: FileContext) -> Iterator[Finding]:
        aliases = _import_aliases(tree)
        findings: List[Finding] = []
        seen_lines: Set[int] = set()
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
                self._scan_fn(node, ctx, aliases, findings, seen_lines)
        return iter(findings)

    @staticmethod
    def _threefry(call: ast.Call, aliases: Dict[str, str]
                  ) -> Optional[str]:
        """The threefry function a call names, if it names one."""
        name = dotted_name(call.func)
        if name is None:
            return None
        parts = _resolve(name, aliases).split(".")
        if "threefry" in parts[:-1]:
            return parts[-1]
        return None

    @staticmethod
    def _generator_of(call: ast.Call) -> Optional[str]:
        for kw in call.keywords:
            if kw.arg == "generator" and isinstance(kw.value, ast.Name):
                return kw.value.id
        return None

    def _scan_fn(self, fn, ctx: FileContext, aliases: Dict[str, str],
                 findings: List[Finding], seen_lines: Set[int]) -> None:
        # threefry key var -> line of its first draw; generator var ->
        # its current seed (an ast dump) and the seeds whose state a
        # draw consumed, with that draw's line.
        used: Dict[str, int] = {}
        seed_of: Dict[str, str] = {}
        consumed: Dict[str, Dict[str, int]] = {}

        def fire(call: ast.Call, message: str) -> None:
            if call.lineno not in seen_lines:
                seen_lines.add(call.lineno)
                findings.append(ctx.finding(self.id, call, message))

        def fresh(targets: List[ast.AST]) -> None:
            for t in targets:
                if isinstance(t, ast.Name):
                    used.pop(t.id, None)
                    seed_of.pop(t.id, None)
                    consumed.pop(t.id, None)
                elif isinstance(t, (ast.Tuple, ast.List)):
                    fresh(list(t.elts))
                elif isinstance(t, ast.Starred):
                    fresh([t.value])

        def draw(call: ast.Call) -> None:
            gen = self._generator_of(call)
            if gen is not None:
                seed = seed_of.get(gen)
                if seed is None:
                    return
                first = consumed.setdefault(gen, {})
                if seed in first:
                    fire(call, f"generator '{gen}' re-seeded to a state "
                               f"the draw at line {first[seed]} in "
                               f"'{fn.name}' consumed — the draws "
                               f"repeat; seed it anew")
                # One draw consumes the state: the next draws advance.
                seed_of[gen] = None
                first.setdefault(seed, call.lineno)
                return
            which = self._threefry(call, aliases)
            if which not in _KEY_DRAWS or not call.args \
                    or not isinstance(call.args[0], ast.Name):
                return
            key = call.args[0].id
            if key in used:
                fire(call, f"key '{key}' already consumed by a threefry "
                           f"draw at line {used[key]} in '{fn.name}' — "
                           f"fold_in before drawing again, or the two "
                           f"draws repeat")
            else:
                used[key] = call.lineno

        def scan(stmts: List[ast.stmt], twice_for_loops: bool) -> None:
            for stmt in stmts:
                if isinstance(stmt, (ast.FunctionDef,
                                     ast.AsyncFunctionDef,
                                     ast.ClassDef)):
                    continue
                if isinstance(stmt, (ast.Assign, ast.AnnAssign)) \
                        and isinstance(stmt.value, ast.Call):
                    made = self._threefry(stmt.value, aliases)
                    name = dotted_name(stmt.value.func) or ""
                    if made in _KEY_MAKERS or \
                            _resolve(name, aliases) == "torch.Generator":
                        fresh(stmt.targets
                              if isinstance(stmt, ast.Assign)
                              else [stmt.target])
                calls = sorted(_stmt_calls(stmt),
                               key=lambda c: (c.lineno, c.col_offset))
                for call in calls:
                    func = call.func
                    if isinstance(func, ast.Attribute) \
                            and func.attr == "manual_seed" \
                            and isinstance(func.value, ast.Name) \
                            and call.args:
                        seed_of[func.value.id] = ast.dump(call.args[0])
                        continue
                    draw(call)
                if isinstance(stmt, ast.If):
                    # Mutually exclusive branches: each scans a private
                    # copy of the entry state; the exits merge.
                    entry = (dict(used), dict(seed_of),
                             {g: dict(s) for g, s in consumed.items()})
                    exits = []
                    for body in (stmt.body, stmt.orelse):
                        used.clear()
                        used.update(entry[0])
                        seed_of.clear()
                        seed_of.update(entry[1])
                        consumed.clear()
                        consumed.update({g: dict(s) for g, s
                                         in entry[2].items()})
                        scan(body, twice_for_loops)
                        exits.append((dict(used), dict(seed_of),
                                      {g: dict(s)
                                       for g, s in consumed.items()}))
                    used.clear()
                    seed_of.clear()
                    consumed.clear()
                    # A generator stays armed only if every exit left
                    # it armed alike (a branch that drew advanced it).
                    for g in set(exits[0][1]) | set(exits[1][1]):
                        armed = {e[1].get(g) for e in exits}
                        seed_of[g] = armed.pop() if len(armed) == 1 \
                            else None
                    for u, _s, c in exits:
                        for k, line in u.items():
                            used.setdefault(k, line)
                        for g, seeds in c.items():
                            for sd, line in seeds.items():
                                consumed.setdefault(g, {}).setdefault(
                                    sd, line)
                    continue
                for body in _child_bodies(stmt):
                    # Loop bodies run twice: a key drawn once an
                    # iteration without a fold_in, or a generator
                    # re-seeded alike each iteration, is caught.
                    if isinstance(stmt, (ast.For, ast.AsyncFor,
                                         ast.While)) \
                            and twice_for_loops:
                        scan(body, False)
                    scan(body, twice_for_loops)

        scan(fn.body, True)
