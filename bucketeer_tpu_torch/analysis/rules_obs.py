"""Observability coverage: serving entry points must be span-covered.

``obs-unspanned-entry`` — two checks:

1. **Scheduler entries.** Every call site of a scheduler entry point
   (``submit`` / ``read`` / ``submit_tensor`` / ``encode_array`` /
   ``encode_jp2`` on a scheduler-shaped receiver — the encode/decode/
   tensor submission surface) must sit lexically under an active
   graftscope span: a ``with obs.span(...)`` / ``with <x>.metrics
   .time(...)`` block (``Metrics.time`` opens a span by construction),
   or inside a function wrapped whole by such a ``with``. Work that
   enters the scheduler unspanned is invisible to the flight recorder
   and unattributable in a trace — exactly the requests "why was this
   slow?" needs most.
2. **HTTP handlers.** A module that registers routes
   (``*.router.add_get(...)`` etc.) must build its
   ``web.Application`` with the graftscope trace middleware (a
   middleware whose name contains ``trace``) — that middleware *is*
   the handlers' root span + request-id seam, so with it present
   every registered handler runs spanned.

Exemptions: the scheduler's own module (internal delegation is not an
entry), and the analysis package (graftrace scenarios/explorers drive
the scheduler as a test harness, deliberately without a recorder).
Reviewed exceptions go in ``WHITELIST`` as ``(relpath, enclosing
function)`` pairs; entries that stop matching any call are reported
stale (the usual suppression hygiene), so the list cannot rot. The
repo ships clean with an empty whitelist.
"""
from __future__ import annotations

import ast

from .findings import ERROR, WARNING, Finding

OBS_UNSPANNED = "obs-unspanned-entry"

# Scheduler entry leaves (the tracing design's submit_encode /
# submit_decode surface maps to submit/encode_* and read here).
_ENTRY_LEAVES = {"submit", "read", "submit_tensor", "encode_array",
                 "encode_jp2"}
# Receiver must look like a scheduler for generic leaves ("read",
# "submit") so unrelated file/executor calls never trip the rule.
_RECEIVER_MARKERS = ("sched",)
_GETTER_NAMES = {"get_scheduler"}

# Span-opening context managers: obs.span(...) / request_context(...)
# and Metrics.time(...) (which opens a span itself).
_SPAN_LEAVES = {"span", "request_context"}

# (relpath, enclosing function name) pairs exempted by review.
WHITELIST: set = set()

_EXEMPT_SUFFIXES = ("engine/scheduler.py",)
_EXEMPT_PARTS = ("/analysis/",)

_ROUTE_METHODS = {"add_get", "add_post", "add_patch", "add_delete",
                  "add_put", "add_route", "add_head"}


def _attr_parts(node: ast.expr):
    attrs: list = []
    while isinstance(node, ast.Attribute):
        attrs.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        root: str | None = node.id
    elif isinstance(node, ast.Call):
        # get_scheduler().submit_tensor(...): keep the called name as
        # the chain root so the receiver test can see it.
        inner_root, inner_chain = _attr_parts(node.func)
        root = inner_chain[-1] if inner_chain else inner_root
    else:
        root = None
    return root, list(reversed(attrs))


def _is_sched_entry(call: ast.Call) -> bool:
    if not isinstance(call.func, ast.Attribute):
        return False
    root, chain = _attr_parts(call.func)
    leaf = chain[-1] if chain else None
    if leaf not in _ENTRY_LEAVES:
        return False
    receiver_names = ([root] if root else []) + chain[:-1]
    for name in receiver_names:
        low = (name or "").lower()
        if low in _GETTER_NAMES:
            return True
        if any(marker in low for marker in _RECEIVER_MARKERS):
            return True
    return False


def _opens_span(expr: ast.expr) -> bool:
    if not isinstance(expr, ast.Call):
        return False
    root, chain = _attr_parts(expr.func)
    leaf = chain[-1] if chain else root
    if leaf in _SPAN_LEAVES:
        return True
    if leaf == "time":
        receivers = ([root] if root else []) + chain[:-1]
        return any("metrics" in (r or "").lower() for r in receivers)
    return False


class _FuncWalker(ast.NodeVisitor):
    """Walk one function body tracking whether the current statement is
    lexically inside a span-opening ``with``. Nested function/class
    definitions are separate scopes and are not descended into (the
    outer rule loop visits them on their own)."""

    def __init__(self) -> None:
        self.covered = False
        self.hits: list = []       # uncovered scheduler-entry calls

    def visit_With(self, node: ast.With):
        opened = any(_opens_span(item.context_expr)
                     for item in node.items)
        for item in node.items:
            self.visit(item.context_expr)
        prev = self.covered
        self.covered = prev or opened
        for stmt in node.body:
            self.visit(stmt)
        self.covered = prev

    visit_AsyncWith = visit_With

    def visit_FunctionDef(self, node):
        return

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node):
        return

    def visit_Lambda(self, node):
        return

    def visit_Call(self, node: ast.Call):
        if not self.covered and _is_sched_entry(node):
            self.hits.append(node)
        self.generic_visit(node)


def _exempt(relpath: str) -> bool:
    rel = relpath.replace("\\", "/")
    if any(rel.endswith(suffix) for suffix in _EXEMPT_SUFFIXES):
        return True
    return any(part in rel for part in _EXEMPT_PARTS)


def _check_http_registration(mod) -> list:
    """Modules registering routes must build their Application with a
    trace middleware."""
    registrations: list = []
    traced_app = False
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        if isinstance(node.func, ast.Attribute):
            root, chain = _attr_parts(node.func)
            leaf = chain[-1] if chain else None
            receivers = ([root] if root else []) + chain[:-1]
            if leaf in _ROUTE_METHODS and any(
                    "router" in (r or "").lower() for r in receivers):
                registrations.append(node)
            if leaf == "Application" or (
                    leaf is None and root == "Application"):
                has_trace = False
                for kw in node.keywords:
                    if kw.arg != "middlewares":
                        continue
                    for elt in getattr(kw.value, "elts", []):
                        r, ch = _attr_parts(elt)
                        name = ch[-1] if ch else r
                        if name and "trace" in name.lower():
                            has_trace = True
                if has_trace:
                    traced_app = True
    if registrations and not traced_app:
        first = min(registrations, key=lambda n: n.lineno)
        return [Finding(
            OBS_UNSPANNED, mod.relpath, first.lineno,
            f"{len(registrations)} HTTP route registration(s) in a "
            "module whose web.Application lacks the graftscope trace "
            "middleware — handlers would serve requests with no root "
            "span, no request id, and no flight-recorder coverage; "
            "add obs' trace middleware to the middlewares list",
            ERROR, mod.source_line(first.lineno))]
    return []


def run(project) -> list:
    findings: list = []
    used_whitelist: set = set()
    for mod in project.modules:
        if _exempt(mod.relpath):
            continue
        findings += _check_http_registration(mod)
        for fnode in ast.walk(mod.tree):
            if not isinstance(fnode, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                continue
            walker = _FuncWalker()
            for stmt in fnode.body:
                walker.visit(stmt)
            for call in walker.hits:
                key = (mod.relpath, fnode.name)
                if key in WHITELIST:
                    used_whitelist.add(key)
                    continue
                root, chain = _attr_parts(call.func)
                leaf = chain[-1] if chain else "?"
                findings.append(Finding(
                    OBS_UNSPANNED, mod.relpath, call.lineno,
                    f"scheduler entry {leaf}() called outside any "
                    "active span (in "
                    f"{fnode.name}): wrap the call in obs.span(...) "
                    "or metrics.time(...) so the request is "
                    "attributable in traces and the flight recorder, "
                    "or whitelist it in analysis/rules_obs.py with "
                    "a reviewed reason",
                    ERROR, mod.source_line(call.lineno)))
    # Whitelist staleness: an entry suppressing nothing is itself a
    # finding — sanctioned holes must not outlive the code they cover.
    for relpath, func in sorted(WHITELIST - used_whitelist):
        if project.module_for(relpath) is None:
            continue
        findings.append(Finding(
            OBS_UNSPANNED, relpath, 1,
            f"stale obs whitelist entry ({relpath!r}, {func!r}) "
            "matches no unspanned scheduler entry — remove it from "
            "analysis/rules_obs.py",
            WARNING, ""))
    return findings
