"""unguarded-field-write: lock-discipline inference over threaded classes.

The concurrency surface (the cross-request scheduler, the tiered read
caches, the metrics registry) is hand-locked: each class owns one or
more ``threading.Lock``/``RLock``/``Condition`` fields and every
mutation of its shared state is supposed to happen inside a ``with
self._lock:`` block. A single missed ``with`` — one more code path
appending to the merged-batch queue, one cache insert on a new branch —
corrupts shared state *silently* under load, which in this codebase
means corrupted customer bytes, not a crash.

The rule infers the discipline instead of being told it:

1. **Lock fields** are attributes assigned a ``threading.Lock()`` /
   ``RLock()`` / ``Condition()`` (either ``self.X = threading.Lock()``
   in a method or the dataclass idiom
   ``X: Lock = field(default_factory=threading.Lock)``).
2. A statement is in a **locked context** when it sits inside ``with
   self.<lockfield>:`` (any of the class's locks), or in a method whose
   name ends in ``_locked`` — the codebase convention for "caller holds
   the lock" (``_grant_next_locked``, ``_report_locked``). ``__init__``
   / ``__post_init__`` are construction: their accesses are exempt in
   both directions (no thread has the object yet).
3. A field is **guarded** when at least one non-construction access to
   it happens in a locked context.
4. Every *write* to a guarded field outside any locked context is a
   finding. Writes are attribute assignment/augmented-assignment/del,
   stores through a subscript (``self.f[k] = v``), and calls of known
   mutating container methods (``self.f.append(...)``, ``.pop()``,
   ``.update()``, ...). Unlocked *reads* are deliberately tolerated:
   the serving path has documented lock-free fast reads (cache-hit
   paths, stat snapshots) whose worst case is staleness, not
   corruption — flagging them would bury the real signal.

Out of scope (documented, not detected): manual ``.acquire()`` /
``.release()`` pairing, locks inherited from a base class (a subclass
with no locally visible lock field simply infers nothing), and
module-global state — ``analysis/retrace.py``'s trace counter is
guarded by its own lock directly rather than relying on this rule.
"""
from __future__ import annotations

import ast

from .findings import ERROR, Finding

UNGUARDED_WRITE = "unguarded-field-write"

# threading factories plus the graftrace seam's traced drop-ins
# (analysis/graftrace/seam.py) — the serving core creates its locks
# through the seam, and the inference must see through it.
LOCK_FACTORIES = {"Lock", "RLock", "Condition",
                  "make_lock", "make_rlock", "make_condition"}
CONSTRUCTORS = {"__init__", "__post_init__", "__new__"}
# Container methods that mutate their receiver in place.
MUTATORS = {"append", "appendleft", "extend", "extendleft", "insert",
            "add", "discard", "remove", "pop", "popleft", "popitem",
            "clear", "update", "setdefault", "move_to_end", "sort",
            "reverse", "rotate", "setflags"}


def _leaf_name(node):
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _is_lock_factory(node) -> bool:
    return (isinstance(node, ast.Call)
            and _leaf_name(node.func) in LOCK_FACTORIES)


def _factory_ref(node) -> bool:
    """True for a default_factory value that builds a lock: a bare
    factory reference (``threading.Lock``) or the zero-arg-lambda idiom
    the seam needs for named locks
    (``lambda: seam.make_lock("Metrics._lock")``)."""
    if _leaf_name(node) in LOCK_FACTORIES:
        return True
    return isinstance(node, ast.Lambda) and _is_lock_factory(node.body)


def _self_attr(node, self_name: str):
    """The attribute name when ``node`` is ``<self>.<attr>``."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and \
            node.value.id == self_name:
        return node.attr
    return None


def _lock_fields(cls: ast.ClassDef) -> set:
    locks = set()
    for stmt in cls.body:
        # dataclass field: X: Lock = field(default_factory=Lock)
        if isinstance(stmt, ast.AnnAssign) and \
                isinstance(stmt.target, ast.Name) and \
                isinstance(stmt.value, ast.Call):
            if _is_lock_factory(stmt.value):
                locks.add(stmt.target.id)
            for kw in stmt.value.keywords:
                if kw.arg == "default_factory" and _factory_ref(kw.value):
                    locks.add(stmt.target.id)
        if isinstance(stmt, ast.Assign) and _is_lock_factory(stmt.value):
            for t in stmt.targets:
                if isinstance(t, ast.Name):
                    locks.add(t.id)
    for meth in cls.body:
        if not isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        self_name = _method_self(meth)
        if self_name is None:
            continue
        for node in ast.walk(meth):
            if isinstance(node, ast.Assign) and \
                    _is_lock_factory(node.value):
                for t in node.targets:
                    attr = _self_attr(t, self_name)
                    if attr:
                        locks.add(attr)
    return locks


def _method_self(meth) -> str | None:
    args = meth.args.posonlyargs + meth.args.args
    if not args:
        return None
    for dec in meth.decorator_list:
        if _leaf_name(dec) == "staticmethod":
            return None
    return args[0].arg


class _Access:
    __slots__ = ("locked", "write", "line", "method", "lock")

    def __init__(self, locked, write, line, method, lock):
        self.locked = locked
        self.write = write
        self.line = line
        self.method = method
        self.lock = lock


class _MethodWalk:
    """Collect self-field accesses in one method with a locked flag."""

    def __init__(self, self_name: str, locks: set, method: str,
                 accesses: dict):
        self.self_name = self_name
        self.locks = locks
        self.method = method
        self.accesses = accesses
        self.base_locked = method.endswith("_locked")

    def _add(self, attr, locked, write, line, lock=None):
        if attr in self.locks:
            return
        self.accesses.setdefault(attr, []).append(
            _Access(locked or self.base_locked, write, line,
                    self.method, lock))

    def _write_target(self, target, locked, lock):
        """Record stores: self.f = ..., self.f[k] = ..., tuple targets."""
        attr = self._self_attr(target)
        if attr:
            self._add(attr, locked, True, target.lineno, lock)
            return
        if isinstance(target, ast.Subscript):
            attr = self._self_attr(target.value)
            if attr:
                self._add(attr, locked, True, target.lineno, lock)
            return
        if isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._write_target(e, locked, lock)
        if isinstance(target, ast.Starred):
            self._write_target(target.value, locked, lock)

    def _self_attr(self, node):
        return _self_attr(node, self.self_name)

    def _reads(self, node, locked, lock):
        """Record remaining accesses in an expression tree: mutator
        method calls as writes, plain mentions as reads."""
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                f = sub.func
                if isinstance(f, ast.Attribute):
                    attr = self._self_attr(f.value)
                    if attr and f.attr in MUTATORS:
                        self._add(attr, locked, True, sub.lineno, lock)
            attr = self._self_attr(sub)
            if attr:
                self._add(attr, locked, False, sub.lineno, lock)

    def stmt(self, node, locked, lock):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # A nested def runs later, wherever it is called — its body
            # cannot assume the lock is still held, not even inside a
            # *_locked method (base_locked covers the method body, not
            # closures escaping it).
            saved = self.base_locked
            self.base_locked = False
            for s in node.body:
                self.stmt(s, False, None)
            self.base_locked = saved
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            inner, inner_lock = locked, lock
            for item in node.items:
                ctx = item.context_expr
                attr = self._self_attr(ctx)
                if attr in self.locks:
                    inner, inner_lock = True, attr
                else:
                    self._reads(ctx, locked, lock)
            for s in node.body:
                self.stmt(s, inner, inner_lock)
            return
        if isinstance(node, ast.Assign):
            self._reads(node.value, locked, lock)
            for t in node.targets:
                self._write_target(t, locked, lock)
            return
        if isinstance(node, ast.AugAssign):
            self._reads(node.value, locked, lock)
            self._write_target(node.target, locked, lock)
            return
        if isinstance(node, ast.AnnAssign):
            if node.value is not None:
                self._reads(node.value, locked, lock)
            self._write_target(node.target, locked, lock)
            return
        if isinstance(node, ast.Delete):
            for t in node.targets:
                self._write_target(t, locked, lock)
            return
        body_fields = ("body", "orelse", "finalbody")
        if isinstance(node, (ast.If, ast.While)):
            self._reads(node.test, locked, lock)
        elif isinstance(node, ast.For):
            self._reads(node.iter, locked, lock)
            self._write_target(node.target, locked, lock)
        elif isinstance(node, ast.Try):
            for h in node.handlers:
                for s in h.body:
                    self.stmt(s, locked, lock)
        elif isinstance(node, (ast.Return, ast.Expr)):
            if node.value is not None:
                self._reads(node.value, locked, lock)
            return
        elif isinstance(node, (ast.Raise, ast.Assert)):
            for sub in ast.iter_child_nodes(node):
                if isinstance(sub, ast.expr):
                    self._reads(sub, locked, lock)
            return
        elif isinstance(node, ast.stmt):
            for sub in ast.iter_child_nodes(node):
                if isinstance(sub, ast.expr):
                    self._reads(sub, locked, lock)
        for f in body_fields:
            for s in getattr(node, f, ()):
                self.stmt(s, locked, lock)


def class_accesses(cls: ast.ClassDef):
    """(lock fields, {attr: [access records]}) for one class. Shared
    between the unguarded-write check below and graftrace's
    static/dynamic cross-check (analysis/graftrace/explore.py), so the
    two analyses reason from the same inference."""
    locks = _lock_fields(cls)
    accesses: dict = {}
    if not locks:
        return locks, accesses
    for meth in cls.body:
        if not isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if meth.name in CONSTRUCTORS:
            continue
        self_name = _method_self(meth)
        if self_name is None:
            continue
        walk = _MethodWalk(self_name, locks, meth.name, accesses)
        for stmt in meth.body:
            walk.stmt(stmt, False, None)
    return locks, accesses


def _check_class(mod, cls: ast.ClassDef) -> list:
    locks, accesses = class_accesses(cls)
    if not locks:
        return []

    findings = []
    for attr, accs in sorted(accesses.items()):
        guards = sorted({a.lock for a in accs if a.locked and a.lock})
        guarded_in = sorted({a.method for a in accs if a.locked})
        if not guarded_in:
            continue                      # never lock-associated
        lock_desc = (f"self.{guards[0]}" if len(guards) == 1
                     else f"{[f'self.{g}' for g in guards]}")
        for a in accs:
            if a.write and not a.locked:
                findings.append(Finding(
                    UNGUARDED_WRITE, mod.relpath, a.line,
                    f"{cls.name}.{attr} is lock-guarded (held in "
                    f"{', '.join(guarded_in)} via {lock_desc}) but "
                    f"written here in {a.method}() with no lock held — "
                    "a racing thread sees the mutation mid-flight. "
                    "Wrap the access in the guarding lock, or rename "
                    "the method with the _locked suffix if every "
                    "caller already holds it",
                    ERROR, mod.source_line(a.line)))
    return findings


def run(project) -> list:
    findings: list = []
    for mod in project.modules:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef):
                findings += _check_class(mod, node)
    return findings
