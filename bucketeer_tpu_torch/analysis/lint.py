"""graftlint engine: file discovery, rule dispatch, suppression, baseline.

The engine parses every ``.py`` file under the target package once, hands
the parsed project to each rule module, then filters the returned
findings through inline suppressions (``# graftlint: disable=<rule>`` on
the finding line or the line above, ``# graftlint: disable-file=<rule>``
anywhere in the file) and the optional baseline file of known
pre-existing findings.

Rules live in :mod:`rules_hygiene` (exception hygiene, empty
packages), :mod:`rules_async`, :mod:`rules_locks`,
:mod:`rules_lockorder`, :mod:`rules_obs` and :mod:`abi` (the ctypes <->
C/C++/CUDA cross-checker of the hand-written kernel and host-coder
bindings). The JAX package's device-region and donation rules walk from
``jax.jit`` roots, which this package has none of.
"""
from __future__ import annotations

import ast
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

from .findings import ERROR, WARNING, Finding

_DISABLE_RE = re.compile(r"#\s*graftlint:\s*disable=([\w,\-]+)")
_DISABLE_FILE_RE = re.compile(r"#\s*graftlint:\s*disable-file=([\w,\-]+)")

STALE_SUPPRESSION = "stale-suppression"
STALE_BASELINE = "stale-baseline-entry"


@dataclass
class ModuleInfo:
    """One parsed source file plus its import-alias environment."""
    path: Path
    relpath: str
    tree: ast.Module
    lines: list
    np_aliases: set = field(default_factory=set)
    jnp_aliases: set = field(default_factory=set)
    jax_aliases: set = field(default_factory=set)
    partial_aliases: set = field(default_factory=set)
    jit_names: set = field(default_factory=set)      # from jax import jit
    shardmap_names: set = field(default_factory=set)

    def source_line(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1]
        return ""


@dataclass
class Project:
    root: Path                       # package directory being linted
    modules: list
    # simple function name -> [(ModuleInfo, ast.FunctionDef)]
    funcs_by_name: dict = field(default_factory=dict)

    def module_for(self, relpath: str):
        for mod in self.modules:
            if mod.relpath == relpath:
                return mod
        return None


def _collect_aliases(mod: ModuleInfo) -> None:
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                name = alias.asname or alias.name.split(".")[0]
                if alias.name == "numpy":
                    mod.np_aliases.add(name)
                elif alias.name == "jax.numpy":
                    mod.jnp_aliases.add(alias.asname or "jax")
                elif alias.name in ("jax", "jax.lax", "jax.nn"):
                    mod.jax_aliases.add(name)
        elif isinstance(node, ast.ImportFrom):
            if node.module == "jax":
                for alias in node.names:
                    name = alias.asname or alias.name
                    if alias.name == "numpy":
                        mod.jnp_aliases.add(name)
                    elif alias.name == "jit":
                        mod.jit_names.add(name)
                    elif alias.name == "shard_map":
                        mod.shardmap_names.add(name)
                    elif alias.name in ("lax", "nn"):
                        mod.jax_aliases.add(name)
            elif node.module in ("jax.experimental.shard_map",
                                 "jax.experimental") or (
                    # parallel/compat.py re-exports jax's shard_map.
                    node.module is not None
                    and node.module.rsplit(".", 1)[-1] == "compat"):
                for alias in node.names:
                    if alias.name == "shard_map":
                        mod.shardmap_names.add(alias.asname or alias.name)
            elif node.module == "functools":
                for alias in node.names:
                    if alias.name == "partial":
                        mod.partial_aliases.add(alias.asname or alias.name)
            elif node.module == "numpy":
                # "from numpy import ..." is rare here; track the module
                # itself only (per-symbol tracking is not needed yet).
                pass


def _index_functions(project: Project) -> None:
    for mod in project.modules:
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                project.funcs_by_name.setdefault(node.name, []).append(
                    (mod, node))


def load_project(root: Path, rel_to: Path | None = None) -> Project:
    """Parse every .py file under ``root`` into a Project."""
    root = Path(root).resolve()
    rel_to = (rel_to or root.parent).resolve()
    modules = []
    for path in sorted(root.rglob("*.py")):
        try:
            text = path.read_text(encoding="utf-8")
            tree = ast.parse(text, filename=str(path))
        except (OSError, SyntaxError) as exc:
            mod = ModuleInfo(path, str(path.relative_to(rel_to)),
                             ast.Module(body=[], type_ignores=[]), [])
            modules.append(mod)
            # A file the engine cannot parse is itself a finding; stash
            # it on the module so run_lint can report it.
            mod.parse_error = exc  # type: ignore[attr-defined]
            continue
        modules.append(ModuleInfo(path, str(path.relative_to(rel_to)),
                                  tree, text.splitlines()))
    project = Project(root, modules)
    for mod in project.modules:
        _collect_aliases(mod)
    _index_functions(project)
    return project


def _suppressions(mod: ModuleInfo):
    """(per-line {lineno: set(rules)}, file-wide set(rules))."""
    per_line: dict = {}
    file_wide: set = set()
    for i, line in enumerate(mod.lines, start=1):
        m = _DISABLE_RE.search(line)
        if m:
            per_line[i] = set(m.group(1).split(","))
        m = _DISABLE_FILE_RE.search(line)
        if m:
            file_wide |= set(m.group(1).split(","))
    return per_line, file_wide


def _suppression_hit(finding: Finding, per_line: dict, file_wide: set):
    """The suppression that absorbs this finding, or None.

    Returns ``("file", rule)`` for a file-wide disable or
    ``("line", lineno, rule)`` for an inline one — the key the staleness
    pass marks as *used*, so disables that stop matching anything are
    themselves reported (suppressions are sanctioned exceptions; a
    stale one is a hole waiting for a new bug to walk through)."""
    for rule in (finding.rule, "all"):
        if rule in file_wide:
            return ("file", rule)
    for lineno in (finding.line, finding.line - 1):
        rules = per_line.get(lineno, ())
        for rule in (finding.rule, "all"):
            if rule in rules:
                return ("line", lineno, rule)
    return None


def _stale_suppression_findings(by_relpath: dict, suppressions: dict,
                                used: set) -> list:
    out = []
    for relpath, mod in by_relpath.items():
        per_line, file_wide = suppressions[relpath]
        for lineno in sorted(per_line):
            for rule in sorted(per_line[lineno]):
                if (relpath, "line", lineno, rule) not in used:
                    out.append(Finding(
                        STALE_SUPPRESSION, relpath, lineno,
                        f"'# graftlint: disable={rule}' suppresses no "
                        "live finding — remove the stale disable",
                        WARNING, mod.source_line(lineno)))
        for rule in sorted(file_wide):
            if (relpath, "file", rule) not in used:
                out.append(Finding(
                    STALE_SUPPRESSION, relpath, 1,
                    f"'# graftlint: disable-file={rule}' suppresses no "
                    "live finding in this file — remove it",
                    WARNING, mod.source_line(1)))
    return out


def load_baseline(path: Path) -> set:
    try:
        data = json.loads(Path(path).read_text(encoding="utf-8"))
    except (OSError, json.JSONDecodeError):
        return set()
    return {f["fingerprint"] for f in data.get("findings", [])
            if "fingerprint" in f}


def baseline_entries_for_rules(path: Path, prefix: str) -> list:
    """Baseline entries (full records) whose rule starts with
    ``prefix``. The staleness pass needs this to scope itself to rule
    families that actually ran: a ``perf-*`` entry is only judged stale
    by an invocation that ran the cost audit — a lint-only run must
    neither report it stale, prune it, nor drop it from a rewritten
    baseline."""
    try:
        data = json.loads(Path(path).read_text(encoding="utf-8"))
    except (OSError, json.JSONDecodeError):
        return []
    return [f for f in data.get("findings", [])
            if "fingerprint" in f
            and str(f.get("rule", "")).startswith(prefix)]


def prune_baseline(path: Path, used: set) -> int:
    """Rewrite the baseline file keeping only entries whose fingerprint
    still suppresses a live finding; returns how many were dropped."""
    try:
        data = json.loads(Path(path).read_text(encoding="utf-8"))
    except (OSError, json.JSONDecodeError):
        return 0
    entries = data.get("findings", [])
    live = [e for e in entries if e.get("fingerprint") in used]
    dropped = len(entries) - len(live)
    if dropped:
        Path(path).write_text(
            json.dumps({"findings": live}, indent=2) + "\n",
            encoding="utf-8")
    return dropped


def write_baseline(path: Path, findings: list,
                   keep_entries: list = ()) -> None:
    """Record ``findings`` as the new baseline. ``keep_entries``
    carries raw entries to preserve verbatim — rule families the
    current invocation did not run (perf-* on a lint-only rewrite),
    which would otherwise be silently dropped."""
    entries = list(keep_entries)
    seen = {e.get("fingerprint") for e in entries}
    entries += [{"fingerprint": f.fingerprint(), "rule": f.rule,
                 "path": f.path, "line": f.line}
                for f in findings if f.fingerprint() not in seen]
    Path(path).write_text(json.dumps({"findings": entries}, indent=2)
                          + "\n", encoding="utf-8")


def run_lint(root: Path, baseline: set | None = None,
             native_dir: Path | None = None,
             used_baseline: set | None = None) -> list:
    """Lint the package at ``root``; returns surviving findings sorted by
    (path, line). ``native_dir``, the C/C++/CUDA sources the ctypes
    bindings under ``root`` name, defaults to ``root``/csrc when present
    (set it explicitly to cross-check an out-of-tree fixture).
    ``used_baseline``, when given, collects the baseline fingerprints
    that actually matched a finding — the CLI diffs it against the full
    baseline to report (and ``--prune-baseline`` to drop) stale
    entries."""
    from . import abi, rules_async, rules_hygiene, rules_lockorder, \
        rules_locks, rules_obs

    project = load_project(Path(root))
    findings: list = []
    for mod in project.modules:
        err = getattr(mod, "parse_error", None)
        if err is not None:
            findings.append(Finding("parse-error", mod.relpath,
                                    getattr(err, "lineno", 1) or 1,
                                    f"cannot parse: {err}", ERROR))
    findings += rules_hygiene.run(project)
    findings += rules_async.run(project)
    findings += rules_locks.run(project)
    findings += rules_lockorder.run(project)
    findings += rules_obs.run(project)
    if native_dir is None:
        candidate = Path(root) / "csrc"
        native_dir = candidate if candidate.is_dir() else None
    if native_dir is not None:
        rel_root = Path(root).resolve().parent
        findings += abi.check_native(Path(native_dir), project,
                                     rel_to=rel_root)

    by_relpath = {mod.relpath: mod for mod in project.modules}
    suppressions = {relpath: _suppressions(mod)
                    for relpath, mod in by_relpath.items()}
    survivors = []
    used_supp: set = set()
    for f in findings:
        mod = by_relpath.get(f.path)
        if mod is not None:
            per_line, file_wide = suppressions[f.path]
            hit = _suppression_hit(f, per_line, file_wide)
            if hit is not None:
                used_supp.add((f.path,) + hit)
                continue
            if not f.source_line:
                f = Finding(f.rule, f.path, f.line, f.message, f.severity,
                            mod.source_line(f.line))
        survivors.append(f)
    # Stale-suppression hygiene runs before the baseline filter so a
    # --write-baseline round trip covers these findings too.
    survivors += _stale_suppression_findings(by_relpath, suppressions,
                                             used_supp)
    kept = []
    for f in survivors:
        if baseline and f.fingerprint() in baseline:
            if used_baseline is not None:
                used_baseline.add(f.fingerprint())
            continue
        kept.append(f)
    kept.sort(key=lambda f: (f.path, f.line, f.rule))
    return kept
