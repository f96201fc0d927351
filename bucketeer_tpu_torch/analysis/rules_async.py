"""Async hygiene: blocking calls inside ``async def`` bodies.

``blocking-call-in-async``: a synchronous converter/encode/decode entry
point, or ``time.sleep``, called directly from an ``async def`` body.
Every such call stalls the whole event loop for the duration — exactly
the class of bug ``asyncio.to_thread`` exists to prevent, and the one
that would silently serialize the serving stack however good the encode
scheduler is. The sanctioned pattern passes the callable *as a value*
to ``asyncio.to_thread(...)`` / ``loop.run_in_executor(...)`` (the
function object is an argument, not a call, so it never trips the rule).

The blocking set is the project's known heavyweight sync surface
(converter ``convert``, the encoder/scheduler encode entry points, the
Tier-1 batch calls, ``read_image``/``read_id``, and — receiver-matched
as ``*.reader.read/probe`` because the bare leaves are too generic —
the TpuReader methods) plus ``time.sleep``. Nested ``def``s inside an
async
function are skipped — they run wherever they are called, typically on
an executor. Call sites that are genuinely fine (an async wrapper whose
job *is* the bridged call) can be whitelisted in ``WHITELIST`` as
``(relpath, async function name)`` pairs; the current codebase is clean
so the set ships empty.
"""
from __future__ import annotations

import ast

from .findings import ERROR, Finding

BLOCKING_ASYNC = "blocking-call-in-async"

# Leaf callable names that block: the sync encode/decode/convert surface.
_BLOCKING_LEAVES = {
    "convert",                          # converters.* (TPU, CLI)
    "encode_jp2", "encode_array",       # codec.encoder / the scheduler
    "encode_blocks", "encode_packed", "encode_cxd",   # codec.t1_batch
    "read_image",                       # codec.tiff
    "read_id",                          # converters.reader
}
# Leaves blocking only under a specific receiver/module root.
_ROOTED = {
    ("time", "sleep"),
}
# Leaves too generic to flag bare (bytes.read, multipart part.read(),
# file handles) that DO block when the receiver chain is the TpuReader
# attribute: `self.reader.read(...)` / `api.reader.probe(...)`.
_READER_LEAVES = {"read", "probe"}
_READER_RECEIVER = "reader"
# (relpath, enclosing async function name) pairs exempted by review.
WHITELIST: set = set()


def _attr_parts(node: ast.expr):
    attrs = []
    while isinstance(node, ast.Attribute):
        attrs.append(node.attr)
        node = node.value
    root = node.id if isinstance(node, ast.Name) else None
    return root, list(reversed(attrs))


class _AsyncBodyWalker(ast.NodeVisitor):
    """Walk one async function's own body: nested function/class
    definitions are separate execution contexts and are skipped."""

    def __init__(self) -> None:
        self.calls: list = []

    def visit_FunctionDef(self, node):            # nested sync def
        return

    def visit_AsyncFunctionDef(self, node):       # nested async def
        return

    def visit_Lambda(self, node):
        return

    def visit_Call(self, node):
        self.calls.append(node)
        self.generic_visit(node)


def _blocking_reason(func: ast.expr) -> str | None:
    root, chain = _attr_parts(func)
    leaf = chain[-1] if chain else root
    if leaf in _BLOCKING_LEAVES:
        return (f"{leaf}() is a synchronous encode/convert entry point")
    if (root, leaf) in _ROOTED:
        return "time.sleep() blocks the event loop (use asyncio.sleep)"
    if leaf in _READER_LEAVES and _READER_RECEIVER in chain[:-1]:
        return (f"reader.{leaf}() decodes synchronously (seconds per "
                "image)")
    return None


def run(project) -> list:
    findings = []
    for mod in project.modules:
        for fnode in ast.walk(mod.tree):
            if not isinstance(fnode, ast.AsyncFunctionDef):
                continue
            if (mod.relpath, fnode.name) in WHITELIST:
                continue
            walker = _AsyncBodyWalker()
            for stmt in fnode.body:
                walker.visit(stmt)
            for call in walker.calls:
                reason = _blocking_reason(call.func)
                if reason is None:
                    continue
                findings.append(Finding(
                    BLOCKING_ASYNC, mod.relpath, call.lineno,
                    f"blocking call inside async def {fnode.name}: "
                    f"{reason}; route it through asyncio.to_thread "
                    "(or an executor) so the event loop keeps serving",
                    ERROR, mod.source_line(call.lineno)))
    return findings
