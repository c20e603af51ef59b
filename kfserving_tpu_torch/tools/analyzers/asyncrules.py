"""kfslint concurrency rules — each one a landed defect class.

Port of ``kfserving_tpu/tools/analyzers/asyncrules.py``, rule for rule
(the port keeps its own copy).

Every rule here is derived from a bug this repo actually shipped and
then fixed (see ISSUE 11 / CHANGES.md):

- `async-blocking`: a blocking call (`time.sleep`, `requests.*`,
  subprocess/socket waits) inside an `async def` freezes the whole
  event loop for its duration — every live stream, health probe, and
  admission decision stalls behind it.
- `spin-loop`: a `while` loop in an `async def` with no `await` /
  `async for` / `async with` in its body never yields to the loop;
  if its exit condition is flipped by another coroutine, it livelocks
  the process (the growth-HOLD bug class).
- `await-under-lock`: an `await` while holding a `threading` lock
  parks the lock across an arbitrary suspension — any engine worker
  thread (or the loop itself, re-entering) that wants the lock now
  waits on scheduler whim (the chain-digest-hoist class).
- `cancellation-safety`: awaiting between acquiring a pooled resource
  and entering the `try/finally` (or `except CancelledError`) that
  releases it means a cancellation at that await orphans the resource
  (the standby-pop leak class).

All four analyze `async def` bodies wherever they appear — including
async defs nested inside sync functions — and none descend into
nested `def`/`lambda` bodies (those run in whatever context calls
them, typically an executor, and get their own visit if async).
"""

import ast
import re
from typing import Dict, Iterator, List, Optional, Set, Tuple

from kfserving_tpu_torch.tools.analyzers.core import (
    FileContext,
    Finding,
    Rule,
    contains_await,
    dotted_name,
    is_test_function,
    iter_body_nodes,
)


def _import_aliases(tree: ast.Module) -> Dict[str, str]:
    """{local name: canonical dotted name} from import statements, so
    `from time import sleep as zz` still resolves to time.sleep."""
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            for a in node.names:
                aliases[a.asname or a.name] = \
                    f"{node.module}.{a.name}"
    return aliases


def _resolve(call_name: str, aliases: Dict[str, str]) -> str:
    """Canonicalize a call's dotted name through the import aliases."""
    head, sep, rest = call_name.partition(".")
    full = aliases.get(head, head)
    return full + sep + rest if sep else full


def iter_async_functions(tree: ast.Module
                         ) -> Iterator[ast.AsyncFunctionDef]:
    for node in ast.walk(tree):
        if isinstance(node, ast.AsyncFunctionDef):
            yield node


# -- rule 1: async-blocking -------------------------------------------------

_BLOCKING_EXACT = {
    "time.sleep",
    "os.system",
    "os.wait", "os.waitpid",
    "socket.create_connection", "socket.getaddrinfo",
    "urllib.request.urlopen",
    "subprocess.run", "subprocess.call", "subprocess.check_call",
    "subprocess.check_output", "subprocess.getoutput",
    "subprocess.getstatusoutput",
    "shutil.copyfile", "shutil.copytree", "shutil.rmtree",
    # Blocking file I/O: a cold page-cache read (or an fsync-heavy
    # write) holds the loop for disk time, and every live stream
    # pays it.
    "open",
    "json.load", "json.dump",
    "pickle.load", "pickle.dump",
    "os.replace", "os.rename", "os.makedirs",
    "tempfile.mkdtemp",
    "numpy.load", "numpy.save", "numpy.fromfile",
}
_REQUESTS_VERBS = {"get", "post", "put", "delete", "head", "patch",
                   "options", "request"}


def _blocking_primitive(node: ast.Call,
                        aliases: Dict[str, str]) -> Optional[str]:
    name = dotted_name(node.func)
    if name is None:
        return None
    resolved = _resolve(name, aliases)
    if resolved in _BLOCKING_EXACT:
        return resolved
    if resolved.startswith("requests.") \
            and resolved.split(".", 1)[1] in _REQUESTS_VERBS:
        return resolved
    return None


def _bare_call_name(node: ast.Call) -> Optional[str]:
    func = node.func
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


class AsyncBlockingRule(Rule):
    """Direct blocking calls in async bodies, plus one-hop-at-a-time
    helper resolution: a *sync* function whose body contains a
    blocking primitive — or calls another blocking sync function — is
    itself blocking, and an async def calling it is flagged.  Helper
    matching is by bare name and gated on the name being defined
    EXACTLY ONCE in the scanned tree (a `load` defined 18 times tells
    us nothing; a `_persist_credentials` defined once tells us
    everything), which keeps the interprocedural pass from guessing.

    Two shapes are exempt from the helper pass:

    - executor offloads — `loop.run_in_executor(...)` /
      `asyncio.to_thread(...)` schedule work off-loop, and
      `functools.partial(...)` only binds arguments; none of the
      three blocks even when the scanned tree contains a same-named
      fake (a test double's `run_in_executor` calling the fn inline
      must not poison every real offload in the tree).  A blocking
      callable passed BY REFERENCE through them never fires; a call
      evaluated in the argument list (`to_thread(self._load())`)
      still does.
    - awaited calls — `await call(payload)` proves the callee is a
      coroutine function, so matching it to a same-named *sync* def
      elsewhere in the tree is definitionally wrong (the
      `retry.call` false-positive class).
    """

    id = "async-blocking"
    description = ("blocking call (time.sleep, requests.*, file/"
                   "subprocess/socket I/O) on an event-loop path")

    # Offload/binding vocabulary: these schedule or curry, never
    # block, whatever a same-named def in the scanned tree does.
    _OFFLOAD_NAMES = {"run_in_executor", "to_thread", "partial"}

    def __init__(self):
        # bare def name -> count across the scanned tree (sync+async)
        self._def_count: Dict[str, int] = {}
        # sync def name -> (primitive or None, {bare names it calls})
        self._sync_defs: Dict[str, Tuple[Optional[str], Set[str]]] = {}
        self._def_loc: Dict[str, str] = {}
        # deferred helper-call sites awaiting the cross-file index:
        # (path, line, snippet, async fn name, bare callee name)
        self._candidates: List[Tuple[str, int, str, str, str]] = []

    def check(self, tree: ast.Module,
              ctx: FileContext) -> Iterator[Finding]:
        aliases = _import_aliases(tree)
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
                self._def_count[node.name] = \
                    self._def_count.get(node.name, 0) + 1
                self._def_loc.setdefault(
                    node.name, f"{ctx.path}:{node.lineno}")
            if isinstance(node, ast.FunctionDef):
                primitive, calls = None, set()
                for n in iter_body_nodes(node.body):
                    if isinstance(n, ast.Call):
                        p = _blocking_primitive(n, aliases)
                        if p and primitive is None:
                            primitive = p
                        bare = _bare_call_name(n)
                        if bare and bare not in self._OFFLOAD_NAMES:
                            calls.add(bare)
                if node.name not in self._sync_defs \
                        or primitive is not None:
                    self._sync_defs[node.name] = (primitive, calls)
        for fn in iter_async_functions(tree):
            if is_test_function(fn.name):
                # A test's loop has no other traffic to stall; see
                # core.is_test_function for the scoping policy.
                continue
            awaited = {id(n.value) for n in iter_body_nodes(fn.body)
                       if isinstance(n, ast.Await)
                       and isinstance(n.value, ast.Call)}
            for node in iter_body_nodes(fn.body):
                if not isinstance(node, ast.Call):
                    continue
                primitive = _blocking_primitive(node, aliases)
                if primitive is not None:
                    yield ctx.finding(
                        self.id, node,
                        f"blocking call {primitive}() inside "
                        f"'async def {fn.name}' stalls the event "
                        f"loop (run it in an executor)")
                    continue
                bare = _bare_call_name(node)
                # An awaited callable is a coroutine function — a
                # same-named SYNC def elsewhere cannot be this
                # callee.  Offload/binding calls never block.
                if bare and id(node) not in awaited \
                        and bare not in self._OFFLOAD_NAMES:
                    line = node.lineno
                    self._candidates.append(
                        (ctx.path, line, ctx.snippet(line), fn.name,
                         bare))

    def finalize(self) -> Iterator[Finding]:
        # Fixpoint over uniquely-named sync defs: blocking spreads
        # from primitives up through call chains one hop per pass.
        blocking: Dict[str, str] = {
            name: prim for name, (prim, _calls)
            in self._sync_defs.items() if prim is not None}
        changed = True
        while changed:
            changed = False
            for name, (_prim, calls) in self._sync_defs.items():
                if name in blocking:
                    continue
                for callee in calls:
                    if callee in blocking \
                            and self._def_count.get(callee) == 1:
                        blocking[name] = (
                            f"{callee}() -> {blocking[callee]}")
                        changed = True
                        break
        for path, line, snippet, async_fn, bare in self._candidates:
            if bare in blocking and self._def_count.get(bare) == 1:
                via = self._def_loc.get(bare, "?")
                yield Finding(
                    rule=self.id, path=path, line=line,
                    message=(f"'async def {async_fn}' calls sync "
                             f"helper {bare}() ({via}) which blocks "
                             f"via {blocking[bare]} — move the call "
                             f"to an executor"),
                    snippet=snippet)


# -- rule 2: spin-loop ------------------------------------------------------

class SpinLoopRule(Rule):
    id = "spin-loop"
    description = ("while loop in an async def whose body never "
                   "awaits (event-loop starvation / livelock)")

    def check(self, tree: ast.Module,
              ctx: FileContext) -> Iterator[Finding]:
        for fn in iter_async_functions(tree):
            for node in iter_body_nodes(fn.body):
                if isinstance(node, ast.While) \
                        and not contains_await(node.body) \
                        and not any(isinstance(n, ast.Await)
                                    for n in ast.walk(node.test)):
                    yield ctx.finding(
                        self.id, node,
                        f"while loop in 'async def {fn.name}' has no "
                        f"await in its body — if its exit condition "
                        f"is flipped by another coroutine this "
                        f"livelocks the loop")


# -- rule 3: await-under-lock -----------------------------------------------

_THREADING_FACTORIES = {
    "threading.Lock", "threading.RLock", "threading.Condition",
    "threading.Semaphore", "threading.BoundedSemaphore",
}
_ASYNCIO_FACTORIES = {
    "asyncio.Lock", "asyncio.Condition", "asyncio.Semaphore",
    "asyncio.BoundedSemaphore", "asyncio.Event",
}
# Whole snake_case segments only: `_block_lock` is lockish,
# `block_table` (the dominant "block" noun in this codebase) is not.
_LOCKISH_SEGMENTS = {"lock", "rlock", "wlock", "mutex"}


def _lockish_name(name: str) -> bool:
    return any(seg in _LOCKISH_SEGMENTS
               for seg in name.lower().split("_"))


def _classify_locks(tree: ast.Module,
                    aliases: Dict[str, str]) -> Dict[str, Set[str]]:
    """{bare name: {"threading"|"asyncio", ...}} from every
    assignment / annotation whose RHS or type is a known lock factory.
    Attribute targets collapse to their attr name (`self._lock` →
    `_lock`) — file-local resolution is deliberate; cross-module lock
    identity is the pragma's job."""
    kinds: Dict[str, Set[str]] = {}

    def classify_value(node: Optional[ast.AST]) -> Optional[str]:
        if isinstance(node, ast.Call):
            node = node.func
        name = dotted_name(node) if node is not None else None
        if name is None:
            return None
        resolved = _resolve(name, aliases)
        if resolved in _THREADING_FACTORIES:
            return "threading"
        if resolved in _ASYNCIO_FACTORIES:
            return "asyncio"
        return None

    def record(target: ast.AST, kind: Optional[str]) -> None:
        if kind is None:
            return
        if isinstance(target, ast.Attribute):
            kinds.setdefault(target.attr, set()).add(kind)
        elif isinstance(target, ast.Name):
            kinds.setdefault(target.id, set()).add(kind)

    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            kind = classify_value(node.value)
            for target in node.targets:
                record(target, kind)
        elif isinstance(node, ast.AnnAssign):
            kind = classify_value(node.value) \
                or classify_value(node.annotation)
            record(node.target, kind)
        elif isinstance(node, ast.arg) and node.annotation is not None:
            kind = classify_value(node.annotation)
            if kind:
                kinds.setdefault(node.arg, set()).add(kind)
    return kinds


class AwaitUnderLockRule(Rule):
    id = "await-under-lock"
    description = ("await while holding a threading lock (sync "
                   "`with <lock>:` containing an await)")

    def check(self, tree: ast.Module,
              ctx: FileContext) -> Iterator[Finding]:
        aliases = _import_aliases(tree)
        lock_kinds = _classify_locks(tree, aliases)
        for fn in iter_async_functions(tree):
            for node in iter_body_nodes(fn.body):
                if not isinstance(node, ast.With):
                    continue
                for item in node.items:
                    expr = item.context_expr
                    if isinstance(expr, ast.Call):
                        expr = expr.func
                    base = None
                    if isinstance(expr, ast.Attribute):
                        base = expr.attr
                    elif isinstance(expr, ast.Name):
                        base = expr.id
                    if base is None:
                        continue
                    kinds = lock_kinds.get(base, set())
                    # Unclassified names still count when they LOOK
                    # like a lock: a sync `with` on an asyncio.Lock
                    # raises at runtime, so a lock-named object in a
                    # sync with-statement is a thread lock in practice.
                    threadlock = kinds == {"threading"} or (
                        not kinds and _lockish_name(base))
                    if threadlock and contains_await(node.body):
                        yield ctx.finding(
                            self.id, node,
                            f"await inside `with {base}:` in 'async "
                            f"def {fn.name}' holds a thread lock "
                            f"across a suspension point (deadlock/"
                            f"convoy risk — release before awaiting)")
                        break


# -- rule 4: cancellation-safety --------------------------------------------

_ACQUIRE_ATTRS = {"acquire", "pop_standby", "obtain_standby",
                  "checkout", "lease", "reserve"}
_POOLED_GET_ATTRS = {"get", "pop"}
_POOLED_RECEIVER = re.compile(
    r"queue|pool|standby|free|idle|avail", re.IGNORECASE)
_CANCELLED_NAMES = {"CancelledError", "BaseException"}


def _acquire_call(stmt: ast.stmt) -> Optional[str]:
    """If `stmt` is `x = await <pooled acquire>(...)`, return a label
    for the acquired resource, else None."""
    if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
        value = stmt.value
    else:
        return None
    if not isinstance(value, ast.Await) \
            or not isinstance(value.value, ast.Call):
        return None
    func = value.value.func
    if isinstance(func, ast.Attribute):
        recv = dotted_name(func.value) or ""
        # `self._obtain_standby` matches `obtain_standby`: private
        # naming must not hide an acquire from the rule.
        attr = func.attr.lstrip("_")
        if attr in _ACQUIRE_ATTRS:
            return f"{recv}.{func.attr}" if recv else func.attr
        if attr in _POOLED_GET_ATTRS and _POOLED_RECEIVER.search(
                recv.rsplit(".", 1)[-1]):
            return f"{recv}.{func.attr}"
    elif isinstance(func, ast.Name) and "acquire" in func.id.lower():
        return func.id
    return None


def _protective(node: ast.Try) -> bool:
    """Does this try release on cancellation — a finally, or an
    except clause catching CancelledError/BaseException?"""
    if node.finalbody:
        return True
    for handler in node.handlers:
        types = [handler.type]
        if isinstance(handler.type, ast.Tuple):
            types = list(handler.type.elts)
        for t in types:
            name = dotted_name(t) if t is not None else None
            if name and name.rsplit(".", 1)[-1] in _CANCELLED_NAMES:
                return True
    return False


def _stmt_awaits(stmt: ast.stmt) -> bool:
    return contains_await([stmt])


class CancellationSafetyRule(Rule):
    id = "cancellation-safety"
    description = ("await between a pooled-resource acquire and the "
                   "try/finally that releases it (cancellation "
                   "orphans the resource)")

    def check(self, tree: ast.Module,
              ctx: FileContext) -> Iterator[Finding]:
        findings: List[Finding] = []
        for fn in iter_async_functions(tree):
            self._scan_block(fn, fn.body, False, ctx, findings)
        return iter(findings)

    def _scan_block(self, fn: ast.AsyncFunctionDef,
                    stmts: List[ast.stmt], protected: bool,
                    ctx: FileContext,
                    findings: List[Finding]) -> None:
        for i, stmt in enumerate(stmts):
            label = None if protected else _acquire_call(stmt)
            if label is not None:
                for later in stmts[i + 1:]:
                    if isinstance(later, ast.Try) \
                            and _protective(later):
                        break
                    if _stmt_awaits(later):
                        findings.append(ctx.finding(
                            self.id, stmt,
                            f"'{label}' acquired in 'async def "
                            f"{fn.name}' but an await runs before "
                            f"the try/finally (or CancelledError "
                            f"handler) that would release it — a "
                            f"cancellation there orphans the "
                            f"resource"))
                        break
            for block, child_protected in self._child_blocks(
                    stmt, protected):
                self._scan_block(fn, block, child_protected, ctx,
                                 findings)

    @staticmethod
    def _child_blocks(stmt: ast.stmt, protected: bool
                      ) -> Iterator[Tuple[List[ast.stmt], bool]]:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return
        if isinstance(stmt, ast.Try):
            inner = protected or _protective(stmt)
            yield stmt.body, inner
            for handler in stmt.handlers:
                yield handler.body, protected
            # A finally covers the else-block's awaits too; handlers
            # do not (exceptions raised in else bypass them).
            yield stmt.orelse, protected or bool(stmt.finalbody)
            yield stmt.finalbody, protected
        elif isinstance(stmt, (ast.If, ast.While, ast.For,
                               ast.AsyncFor)):
            yield stmt.body, protected
            yield stmt.orelse, protected
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            yield stmt.body, protected
