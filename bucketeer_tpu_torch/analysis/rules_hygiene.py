"""Hygiene rules: swallowed exceptions and empty packages.

- ``swallowed-exception``: a handler that catches ``Exception`` /
  ``BaseException`` (or is bare) and whose body neither re-raises, nor
  returns an error value, nor logs. The engine/ message-bus handlers are
  the motivating case: a silent ``except Exception: pass`` there turns a
  converter bug into a job that hangs at "remaining: N" forever.
- ``empty-package``: a package directory whose ``__init__.py`` has no
  statements (not even a docstring) and which contains no other modules.
  An empty package is a landmine for documentation drift — this repo's
  ``codec/pallas`` once caused a docstring to claim a Pallas front-end
  that did not exist (commit b4c697b).
"""
from __future__ import annotations

import ast

from .findings import ERROR, Finding

SWALLOWED = "swallowed-exception"
EMPTY_PACKAGE = "empty-package"

_BROAD = {"Exception", "BaseException"}
_LOG_METHODS = {"debug", "info", "warning", "warn", "error", "exception",
                "critical", "log"}


def _exc_name(node: ast.expr):
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    if isinstance(t, ast.Tuple):
        return any(_exc_name(e) in _BROAD for e in t.elts)
    return _exc_name(t) in _BROAD


def _is_handled(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Return) and node.value is not None \
                and not (isinstance(node.value, ast.Constant)
                         and node.value.value is None):
            return True
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in _LOG_METHODS:
            return True
    return False


def _swallowed(project) -> list:
    findings = []
    for mod in project.modules:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if _is_broad(node) and not _is_handled(node):
                caught = ("bare except" if node.type is None else
                          f"except {ast.unparse(node.type)}")
                findings.append(Finding(
                    SWALLOWED, mod.relpath, node.lineno,
                    f"{caught} swallows the error silently: log it, "
                    "re-raise, return a failure value, or narrow the "
                    "exception type", ERROR,
                    mod.source_line(node.lineno)))
    return findings


def _empty_packages(project) -> list:
    findings = []
    for mod in project.modules:
        if mod.path.name != "__init__.py":
            continue
        if mod.tree.body:
            continue
        siblings = [p for p in mod.path.parent.glob("*.py")
                    if p.name != "__init__.py"]
        subpackages = [p for p in mod.path.parent.iterdir()
                       if p.is_dir() and (p / "__init__.py").exists()]
        if not siblings and not subpackages:
            findings.append(Finding(
                EMPTY_PACKAGE, mod.relpath, 1,
                "empty package: add a module docstring stating its "
                "planned role, or delete the directory", ERROR, ""))
    return findings


def run(project) -> list:
    return _swallowed(project) + _empty_packages(project)
