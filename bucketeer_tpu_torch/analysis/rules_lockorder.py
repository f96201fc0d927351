"""lock-order-cycle: static lock-acquisition-order graph + cycle check.

The dynamic half of this analysis (graftrace's detector) records the
lock orders that *executed*; this rule computes the orders that are
*written*, so a cross-lock inversion is flagged on every PR even when
no test drives both paths. Locks are identified with the same
inference as ``rules_locks`` (class lock fields incl. the graftrace
seam factories, plus module-level ``NAME = threading.Lock()``
globals); an edge ``A -> B`` is recorded when code acquires B while
(statically) holding A:

- directly nested ``with`` blocks, and
- one hop through a same-class method call: ``with self._a:
  self.foo()`` where ``foo`` acquires ``self._b`` adds ``A -> B``
  (the device thread's cv-held snapshot of scheduler state is exactly
  this shape).

A cycle in the resulting digraph is deadlock *potential*: two threads
walking different edges of the cycle can block each other forever. A
length-1 cycle (re-acquiring a non-reentrant ``Lock`` you already
hold) is certain deadlock and is flagged too; reentrant kinds
(``RLock``/``Condition``) are exempt from self-edges.

Out of scope (documented): cross-class object graphs (two *different*
classes' locks nested — the dynamic graph covers those, with real
stacks), manual ``acquire()``/``release()`` pairing, and deeper than
one call hop. Closures and nested defs are skipped — they escape the
static context, same policy as ``rules_locks``.
"""
from __future__ import annotations

import ast

from .findings import ERROR, Finding
from .graftrace.detector import find_lock_cycles
from .rules_locks import LOCK_FACTORIES, _leaf_name, _method_self

LOCK_ORDER_CYCLE = "lock-order-cycle"

_REENTRANT = {"RLock", "Condition", "make_rlock", "make_condition"}


def _factory_kind(node):
    """The factory leaf name when ``node`` is a lock-factory call (or a
    zero-arg lambda around one, the dataclass default_factory idiom)."""
    if isinstance(node, ast.Lambda):
        node = node.body
    if isinstance(node, ast.Call):
        name = _leaf_name(node.func)
        if name in LOCK_FACTORIES:
            return name
    return None


def _class_lock_kinds(cls: ast.ClassDef) -> dict:
    """attr -> factory kind for a class's lock fields."""
    kinds: dict = {}
    for stmt in cls.body:
        if isinstance(stmt, ast.Assign):
            kind = _factory_kind(stmt.value)
            if kind:
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        kinds[t.id] = kind
        if isinstance(stmt, ast.AnnAssign) and \
                isinstance(stmt.target, ast.Name) and \
                isinstance(stmt.value, ast.Call):
            kind = _factory_kind(stmt.value)
            if kind:
                kinds[stmt.target.id] = kind
            for kw in stmt.value.keywords:
                if kw.arg == "default_factory":
                    kind = _factory_kind(kw.value) or \
                        (_leaf_name(kw.value)
                         if _leaf_name(kw.value) in LOCK_FACTORIES
                         else None)
                    if kind:
                        kinds[stmt.target.id] = kind
    for meth in cls.body:
        if not isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        self_name = _method_self(meth)
        if self_name is None:
            continue
        for node in ast.walk(meth):
            if isinstance(node, ast.Assign):
                kind = _factory_kind(node.value)
                if kind:
                    for t in node.targets:
                        if isinstance(t, ast.Attribute) and \
                                isinstance(t.value, ast.Name) and \
                                t.value.id == self_name:
                            kinds[t.attr] = kind
    return kinds


def _module_lock_kinds(mod) -> dict:
    kinds: dict = {}
    for stmt in mod.tree.body:
        if isinstance(stmt, ast.Assign):
            kind = _factory_kind(stmt.value)
            if kind:
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        kinds[t.id] = kind
    return kinds


class _FuncScan:
    """Edge collection over one function body with a held-lock stack."""

    def __init__(self, resolve, one_hop, edges, ctx):
        self.resolve = resolve      # expr -> (qual, kind) | None
        self.one_hop = one_hop      # method name -> set of (qual, kind, line)
        self.edges = edges          # (a, b) -> info dict
        self.ctx = ctx              # "Class.method" for messages

    def _add_edge(self, held, acq, line):
        (a, akind), (b, bkind) = held, acq
        if a == b and bkind in _REENTRANT:
            return
        self.edges.setdefault((a, b), {
            "held": a, "acquired": b, "line": line, "context": self.ctx})

    def scan(self, stmts, held):
        for stmt in stmts:
            self._stmt(stmt, held)

    def _stmt(self, stmt, held):
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return                      # closures escape the context
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            inner = list(held)
            for item in stmt.items:
                got = self.resolve(item.context_expr)
                if got is not None:
                    for h in inner:
                        self._add_edge(h, got, item.context_expr.lineno)
                    inner.append(got)
            self.scan(stmt.body, inner)
            return
        if held:
            self._calls(stmt, held)
        for name in ("body", "orelse", "finalbody"):
            for s in getattr(stmt, name, ()):
                self._stmt(s, held)
        for h in getattr(stmt, "handlers", ()):
            for s in h.body:
                self._stmt(s, held)

    def _calls(self, stmt, held):
        """One-hop: self-method calls in this statement's expressions
        add edges to every lock that method acquires."""
        for node in ast.iter_child_nodes(stmt):
            if isinstance(node, ast.stmt):
                continue                # child statements recurse above
            for sub in ast.walk(node):
                if not isinstance(sub, ast.Call):
                    continue
                f = sub.func
                if isinstance(f, ast.Attribute) and \
                        isinstance(f.value, ast.Name) and \
                        f.value.id == self.one_hop.get("__self__"):
                    for qual, kind, _line in \
                            self.one_hop.get(f.attr, ()):
                        for h in held:
                            self._add_edge(h, (qual, kind), sub.lineno)


def _acquired_in(meth, resolve) -> set:
    """Every lock a method acquires anywhere in its body (the one-hop
    summary). Nested defs excluded."""
    out = set()

    def walk(stmts):
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    got = resolve(item.context_expr)
                    if got is not None:
                        out.add((got[0], got[1], item.context_expr.lineno))
                walk(stmt.body)
                continue
            for name in ("body", "orelse", "finalbody"):
                walk(getattr(stmt, name, ()))
            for h in getattr(stmt, "handlers", ()):
                walk(h.body)

    walk(meth.body)
    return out


def _collect_edges(mod, edges: dict) -> None:
    mod_locks = _module_lock_kinds(mod)

    def module_resolve(expr):
        if isinstance(expr, ast.Name) and expr.id in mod_locks:
            return (f"{mod.relpath}:{expr.id}", mod_locks[expr.id])
        return None

    for node in mod.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scan = _FuncScan(module_resolve, {}, edges,
                             f"{mod.relpath}:{node.name}")
            scan.scan(node.body, [])
        if not isinstance(node, ast.ClassDef):
            continue
        cls = node
        lock_kinds = _class_lock_kinds(cls)
        methods = [m for m in cls.body
                   if isinstance(m, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))]

        def make_resolve(self_name):
            def resolve(expr):
                if isinstance(expr, ast.Attribute) and \
                        isinstance(expr.value, ast.Name) and \
                        expr.value.id == self_name and \
                        expr.attr in lock_kinds:
                    return (f"{cls.name}.{expr.attr}",
                            lock_kinds[expr.attr])
                return module_resolve(expr)
            return resolve

        summaries: dict = {}
        for meth in methods:
            self_name = _method_self(meth)
            if self_name is None:
                continue
            summaries[meth.name] = _acquired_in(meth,
                                                make_resolve(self_name))
        for meth in methods:
            self_name = _method_self(meth)
            if self_name is None:
                continue
            one_hop = dict(summaries)
            one_hop["__self__"] = self_name
            scan = _FuncScan(make_resolve(self_name), one_hop, edges,
                             f"{cls.name}.{meth.name}")
            scan.scan(meth.body, [])


def run(project) -> list:
    edges_by_mod: dict = {}
    all_edges: dict = {}
    for mod in project.modules:
        before = set(all_edges)
        _collect_edges(mod, all_edges)
        for key in set(all_edges) - before:
            edges_by_mod[key] = mod

    findings = []
    for cyc in find_lock_cycles(all_edges):
        first = cyc["edges"][0] if cyc["edges"] else None
        mod = edges_by_mod.get((first["held"], first["acquired"])) \
            if first else None
        path = mod.relpath if mod is not None else "<unknown>"
        line = first["line"] if first else 1
        chain = " -> ".join(cyc["nodes"] + (cyc["nodes"][0],))
        if len(cyc["nodes"]) == 1:
            msg = (f"non-reentrant lock {cyc['nodes'][0]} is re-acquired "
                   f"while already held (in {first['context']}) — "
                   "certain self-deadlock")
        else:
            detail = "; ".join(
                f"{e['context']} takes {e['acquired']} while holding "
                f"{e['held']} (line {e['line']})" for e in cyc["edges"])
            msg = (f"lock-acquisition-order cycle {chain}: {detail} — "
                   "two threads walking different edges deadlock; pick "
                   "one global order or drop the nesting")
        findings.append(Finding(
            LOCK_ORDER_CYCLE, path, line, msg, ERROR,
            mod.source_line(line) if mod is not None else ""))
    return findings
