"""ABI cross-checker: the port's hand-written ctypes tables vs the
``extern "C"`` functions of its C++ and CUDA sources.

The port binds every native entry by hand. ``kernels/build.Library``
takes a table ``{symbol: (argtypes, restype)}`` (``codec/t1_batch.py``'s
``HOST_T1`` over ``csrc/host_t1.cpp``), and ``kernels/build.
kernel_library(name, sources, n_ptrs_in, n_ints, n_ptrs_out,
occupancy)`` builds the table of a CUDA kernel library: ``<name>_launch``
takes ``n_ptrs_in`` pointers, ``n_ints`` ints, ``n_ptrs_out`` pointers
and the stream; ``<name>_occupancy(int L, int *blocks_per_sm)`` is
bound when ``occupancy`` is set. Nothing but a crash at run time told a
drifted table from its source; this checker parses both sides:

- ``abi-missing-export``: a table binds a symbol that no ``extern "C"``
  function of the library's sources defines (an ``AttributeError`` at
  the first launch).
- ``abi-unbound-export``: a source exports a function that no table
  binds (a dead export, or a binding someone forgot) — warning.
- ``abi-arity-mismatch``: a table declares another number of arguments
  than the C definition takes; ctypes would pack the wrong frame.

The JAX package's ``abi-version-mismatch`` does not apply: a library's
file name follows the hash of its sources and flags
(``kernels/build.py``), so a stale build is never loaded, and
``t1_abi_version()`` is exported for outside tools only.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path

from .findings import ERROR, WARNING, Finding

MISSING_EXPORT = "abi-missing-export"
UNBOUND_EXPORT = "abi-unbound-export"
ARITY_MISMATCH = "abi-arity-mismatch"

# Exported for tools that read the library, never bound by the package.
_TOOL_EXPORTS = {"t1_abi_version"}

# A C function definition at column 0: return type tokens then the name.
_CPP_FN_RE = re.compile(r"(?m)^[A-Za-z_][\w]*\s*\*?\s+\*?(\w+)\s*\(")
# One declaration marked on its own: extern "C" <type tokens> name(
_EXTERN_ONE_RE = re.compile(r'extern\s+"C"\s+[\w\s\*]*?\b(\w+)\s*\(')
_CPP_KEYWORDS = {"if", "for", "while", "switch", "return", "sizeof"}
_SOURCE_SUFFIXES = (".cu", ".cpp", ".cc", ".c")


def _cpp_arity(text: str, open_paren: int) -> int | None:
    """Parameter count of the definition whose '(' is at ``open_paren``
    (handles multi-line parameter lists; None if unbalanced)."""
    depth = 0
    params = 0
    for i in range(open_paren, len(text)):
        ch = text[i]
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth == 0:
                inner = text[open_paren + 1:i].strip()
                if not inner or inner == "void":
                    return 0
                return params + 1
        elif ch == "," and depth == 1:
            params += 1
    return None


def _block_end(text: str, open_brace: int) -> int:
    depth = 0
    for i in range(open_brace, len(text)):
        if text[i] == "{":
            depth += 1
        elif text[i] == "}":
            depth -= 1
            if depth == 0:
                return i
    return len(text)


def parse_c_exports(text: str) -> dict:
    """{exported function name: parameter count or None} of one C, C++
    or CUDA source: the functions of ``extern "C" { ... }`` blocks
    (definitions at column 0) and single ``extern "C" <type> name(``
    definitions."""
    out: dict = {}
    for m in re.finditer(r'extern\s+"C"', text):
        rest = text[m.end():]
        if rest.lstrip().startswith("{"):
            start = m.end() + rest.index("{")
            block = text[start:_block_end(text, start)]
            for fm in _CPP_FN_RE.finditer(block):
                name = fm.group(1)
                if name not in _CPP_KEYWORDS:
                    out[name] = _cpp_arity(block, fm.end() - 1)
            continue
        fm = _EXTERN_ONE_RE.match(text, m.start())
        if fm is not None:
            out[fm.group(1)] = _cpp_arity(text, fm.end() - 1)
    return out


def _static_list_len(node: ast.expr, names: dict) -> int | None:
    """Statically evaluate the length of a ctypes argtypes expression:
    list literals, ``list + list``, ``list * k`` and module-level names
    bound to one of those. None when the shape isn't static."""
    if isinstance(node, ast.Name) and node.id in names:
        return _static_list_len(names[node.id], names)
    if isinstance(node, ast.List):
        return len(node.elts)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        left = _static_list_len(node.left, names)
        right = _static_list_len(node.right, names)
        return None if left is None or right is None else left + right
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
        seq, k = node.left, node.right
        if isinstance(seq, ast.Constant):
            seq, k = k, seq
        if isinstance(k, ast.Constant) and isinstance(k.value, int):
            n = _static_list_len(seq, names)
            return None if n is None else n * k.value
    return None


def _const(node):
    return node.value if isinstance(node, ast.Constant) else None


def _call_name(node: ast.Call) -> str:
    fn = node.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return fn.id if isinstance(fn, ast.Name) else ""


def parse_bindings(tree: ast.Module) -> list:
    """The binding tables of one module: ``[(library name, (source file
    names), {symbol: (declared arity or None, line)})]`` for every
    ``Library(...)`` and ``kernel_library(...)`` call whose name and
    sources are literals."""
    names: dict = {}          # module-level name -> value expression
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for target in node.targets:
                if isinstance(target, ast.Name):
                    names[target.id] = node.value
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or len(node.args) < 2:
            continue
        kind = _call_name(node)
        if kind not in ("Library", "kernel_library"):
            continue
        lib = _const(node.args[0])
        if not isinstance(lib, str) or \
                not isinstance(node.args[1], ast.Tuple):
            continue
        sources = tuple(_const(e) for e in node.args[1].elts)
        if not all(isinstance(s, str) for s in sources):
            continue
        table: dict = {}
        if kind == "Library":
            if len(node.args) < 3 or not isinstance(node.args[2], ast.Dict):
                continue
            for key, val in zip(node.args[2].keys, node.args[2].values):
                sym = _const(key) if key is not None else None
                if not isinstance(sym, str):
                    continue
                while isinstance(val, ast.Name) and val.id in names:
                    val = names[val.id]
                arity = None
                if isinstance(val, ast.Tuple) and val.elts:
                    arity = _static_list_len(val.elts[0], names)
                table[sym] = (arity, key.lineno)
        else:
            # kernels/build.kernel_library: pointers in, ints, pointers
            # out and the stream.
            counts = [_const(a) for a in node.args[2:5]]
            arity = (sum(counts) + 1
                     if len(counts) == 3
                     and all(isinstance(c, int) for c in counts) else None)
            table[f"{lib}_launch"] = (arity, node.lineno)
            occ = [kw.value for kw in node.keywords
                   if kw.arg == "occupancy"]
            if len(node.args) > 5:
                occ.append(node.args[5])
            if occ and _const(occ[0]) is True:
                table[f"{lib}_occupancy"] = (2, node.lineno)
        out.append((lib, sources, table))
    return out


def check_native(native_dir: Path, project, rel_to: Path | None = None
                 ) -> list:
    """Cross-check every binding table of ``project`` (a parsed
    lint.Project) against the sources in ``native_dir``; returns
    findings."""
    native_dir = Path(native_dir)

    def rel(p: Path) -> str:
        if rel_to is not None:
            try:
                return str(p.resolve().relative_to(Path(rel_to).resolve()))
            except ValueError:
                pass
        return str(p)

    exports: dict = {}        # source file name -> {symbol: arity}
    findings = []
    for path in sorted(native_dir.iterdir()):
        if path.suffix not in _SOURCE_SUFFIXES:
            continue
        try:
            exports[path.name] = parse_c_exports(
                path.read_text(encoding="utf-8"))
        except OSError as exc:
            findings.append(Finding(
                "parse-error", rel(path), 1,
                f"ABI cross-check could not read: {exc}", ERROR))
    bound: set = set()
    for mod in project.modules:
        for lib, sources, table in parse_bindings(mod.tree):
            defined: dict = {}
            for src in sources:
                defined.update(exports.get(src, {}))
            for sym, (n_py, line) in sorted(table.items()):
                bound.add(sym)
                if sym not in defined:
                    findings.append(Finding(
                        MISSING_EXPORT, mod.relpath, line,
                        f"library {lib} binds {sym} but no extern \"C\" "
                        f"function of {', '.join(sources)} defines it",
                        ERROR))
                    continue
                n_c = defined[sym]
                if n_py is not None and n_c is not None and n_py != n_c:
                    findings.append(Finding(
                        ARITY_MISMATCH, mod.relpath, line,
                        f"library {lib} declares {n_py} argument(s) for "
                        f"{sym} but the C definition takes {n_c}; ctypes "
                        "would pack the wrong call frame", ERROR))
    for src, syms in sorted(exports.items()):
        for sym in sorted(set(syms) - bound - _TOOL_EXPORTS):
            findings.append(Finding(
                UNBOUND_EXPORT, rel(native_dir / src), 1,
                f"{src} exports {sym}() but no ctypes table binds it",
                WARNING, sym))
    return findings
