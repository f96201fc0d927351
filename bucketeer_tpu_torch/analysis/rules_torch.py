"""Device-region rules for eager PyTorch: host-sync, float64-leak, d2h.

The port's device work is eager torch code: every tensor op queues a
kernel on the tensor's device and returns at once, until something
needs a value on the host. A host sync in the middle of a device
program stalls the host until the card drains, and serializes the
pipeline exactly as a sync inside a jitted program does on a TPU. These
rules find the *device region* — every function reachable from the
device programs the dispatch audit registers (``PROGRAM_ROOTS`` in the
linted package's ``analysis/deviceaudit.py``, read from its source) —
and run a taint walk over it: the root parameters that take tensors are
tainted, as are values that ``torch.*`` calls return; taint propagates
through arithmetic, indexing, method calls and calls into the package,
and is laundered by static attributes (``.shape``, ``.dtype``,
``.device``, ``.numel()``, ...). Host numpy values stay untainted, so
numpy's ``.tolist()`` or ``np.float64`` on host data is not a finding.
Violations are:

- ``host-sync``: ``.item()``, ``.tolist()``, ``.numpy()``, ``.cpu()``,
  ``float()``/``int()``/``bool()`` of a tensor, ``np.*`` applied to a
  tensor, ``torch.cuda.synchronize``, and a Python
  ``if``/``while``/``assert`` or conditional expression on a tensor's
  value (in eager torch a branch on a value is a
  ``_local_scalar_dense`` sync, so the JAX package's
  ``tracer-branch`` folds into this rule). Inside a function of
  ``D2H_SANCTIONED`` a sync is the function's job and is not reported.
- ``float64-leak``: ``torch.float64`` / ``torch.double``, a
  ``"float64"`` dtype argument, or ``.double()`` of a tensor inside the
  device region (the card's float64 rate is a small fraction of its
  float32 rate, and nothing in the codec needs it).
- ``d2h-outside-gather``: a device-to-host copy (``.cpu()``,
  ``.to("cpu")``) in the codec/parallel/tensor layers outside the
  sanctioned transfer functions of ``D2H_SANCTIONED``.

The rule ids are the JAX package's, so suppressions read alike in both
packages. The dispatch audit (deviceaudit.py) checks the same facts on
what actually runs and honours the same sanctioned list and the same
inline ``host-sync`` suppressions.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field

from .findings import ERROR, Finding

HOST_SYNC = "host-sync"
FLOAT64_LEAK = "float64-leak"
D2H = "d2h-outside-gather"

# Attribute reads that yield host values of a tensor.
LAUNDER_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
                 "requires_grad", "is_sparse", "itemsize", "nbytes"}
# Tensor methods whose result is a host value that needs no sync.
LAUNDER_METHODS = {"size", "dim", "numel", "nelement", "element_size",
                   "data_ptr", "is_contiguous", "stride", "storage_offset",
                   "get_device", "is_floating_point", "is_complex"}
# Builtins whose result is static even on a tensor argument.
LAUNDER_BUILTINS = {"isinstance", "len", "type", "hasattr", "callable",
                    "id", "repr", "str", "format", "getattr", "range",
                    "print", "tuple", "list", "zip", "enumerate"}
# Builtins that force a tensor's value onto the host.
SYNC_BUILTINS = {"float", "int", "bool", "complex"}
SYNC_METHODS = {"item", "tolist", "numpy", "cpu"}
F64_NAMES = ("float64", "f8", "double")

# Functions allowed to move device data to the host in the
# codec/parallel/tensor layers. Each is where a product (or the small
# host metadata a host stage needs) crosses: the front-end's per-block
# stats (PendingFrontend._host_stats, fetched once per launch and
# shared by the windows of a merged launch), the compaction gather
# (frontend.gather_rows: the packed bitmaps and the CX/D symbol rows),
# the fused Tier-1's byte segments and cursors (cxd.run_device_mq), the
# CX/D split's pass tables (cxd.run_cxd), the transform's Mallat planes
# for the host Tier-1 (pipeline.run_tiles, the mesh's run_tiles_sharded
# and sharded_transform_tile), the decoder's samples (decode.device.
# run_inverse, run_region_inverse), the tensor codec's block maxima
# (tensor.codec.fetch_block_meta) and its input tensor
# (tensor.planes.fetch_tensor), and the coefficient sets' explicit
# materialization (CoefficientSet.to_host, BandSlice.to_host).
D2H_SANCTIONED = {"_host_stats", "gather_rows", "run_device_mq",
                  "run_cxd", "run_tiles", "run_tiles_sharded",
                  "sharded_transform_tile", "run_inverse",
                  "run_region_inverse", "fetch_block_meta",
                  "fetch_tensor", "to_host"}
D2H_SCOPES = ("codec", "parallel", "tensor")

AUDIT_MODULE = "analysis/deviceaudit.py"


@dataclass
class _DeviceFn:
    mod: object
    node: ast.FunctionDef
    tainted: set = field(default_factory=set)     # tainted names


def torch_aliases(mod) -> set:
    """Names the module binds to the torch package."""
    out = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == "torch" or alias.name.startswith("torch."):
                    out.add(alias.asname or "torch")
    return out


def _param_names(node: ast.FunctionDef) -> list:
    args = node.args
    names = [a.arg for a in args.posonlyargs + args.args]
    if args.vararg:
        names.append(args.vararg.arg)
    names += [a.arg for a in args.kwonlyargs]
    return names


def _attr_root(node: ast.expr):
    """Name at the base of an attribute chain, plus the chain attrs."""
    attrs = []
    while isinstance(node, ast.Attribute):
        attrs.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        return node.id, list(reversed(attrs))
    return None, list(reversed(attrs))


def _is_cpu(node) -> bool:
    """A literal naming the host: "cpu" or torch.device("cpu")."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    if isinstance(node, ast.Call) and node.args:
        _, chain = _attr_root(node.func)
        return chain[-1:] == ["device"] and _is_cpu(node.args[0])
    return False


def _is_host_copy(node: ast.Call) -> bool:
    """``x.cpu()`` or ``x.to("cpu")`` / ``x.to(device="cpu")``."""
    func = node.func
    if not isinstance(func, ast.Attribute):
        return False
    if func.attr == "cpu" and not node.args:
        return True
    if func.attr == "to":
        if node.args and _is_cpu(node.args[0]):
            return True
        return any(kw.arg == "device" and _is_cpu(kw.value)
                   for kw in node.keywords)
    return False


class _FnAnalysis:
    """One pass over a device function: propagate taint, collect call
    edges (for device-region growth) and optionally emit findings."""

    def __init__(self, mod, node, tainted, torch_names, emit: bool,
                 project_funcs=frozenset(), syncs_allowed=False):
        self.mod = mod
        self.node = node
        self.env = set(tainted)
        self.torch = torch_names
        self.emit = emit
        self.project_funcs = project_funcs
        self.syncs_allowed = syncs_allowed
        self.findings: list = []
        # (callee name, [positional arg taints], {kwarg: taint})
        self.edges: list = []

    # -- reporting ----------------------------------------------------
    def _finding(self, rule, node, message):
        if not self.emit or (rule == HOST_SYNC and self.syncs_allowed):
            return
        self.findings.append(Finding(
            rule, self.mod.relpath, node.lineno, message, ERROR,
            self.mod.source_line(node.lineno)))

    def _sync(self, node, what: str):
        self._finding(HOST_SYNC, node,
                      f"{what} forces a host sync inside the device "
                      "region (the host waits for the card)")

    # -- expression taint ---------------------------------------------
    def taint(self, node) -> bool:
        if node is None or isinstance(node, ast.Constant):
            return False
        if isinstance(node, ast.Name):
            return node.id in self.env
        if isinstance(node, ast.Attribute):
            if node.attr in LAUNDER_ATTRS:
                self.taint(node.value)
                return False
            root, chain = _attr_root(node)
            if root in self.torch:
                return False          # torch.int32, torch.cuda, ...
            return self.taint(node.value)
        # Subexpressions are always evaluated eagerly (no short-circuit):
        # taint() also records call edges and findings.
        if isinstance(node, ast.Subscript):
            parts = [self.taint(node.value), self.taint(node.slice)]
            return parts[0]
        if isinstance(node, ast.Slice):
            for x in (node.lower, node.upper, node.step):
                self.taint(x)
            return False
        if isinstance(node, ast.BinOp):
            parts = [self.taint(node.left), self.taint(node.right)]
            return any(parts)
        if isinstance(node, ast.UnaryOp):
            return self.taint(node.operand)
        if isinstance(node, ast.BoolOp):
            parts = [self.taint(v) for v in node.values]
            return any(parts)
        if isinstance(node, ast.Compare):
            parts = [self.taint(node.left)]
            parts += [self.taint(c) for c in node.comparators]
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return False          # identity needs no value
            return any(parts)
        if isinstance(node, ast.IfExp):
            if self.taint(node.test):
                self._sync(node, "a conditional expression on a tensor")
            parts = [self.taint(node.body), self.taint(node.orelse)]
            return any(parts)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            parts = [self.taint(e) for e in node.elts]
            return any(parts)
        if isinstance(node, ast.Dict):
            parts = [self.taint(v) for v in node.values if v is not None]
            return any(parts)
        if isinstance(node, ast.Starred):
            return self.taint(node.value)
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            extra = set()
            for comp in node.generators:
                if self.taint(comp.iter):
                    for n in ast.walk(comp.target):
                        if isinstance(n, ast.Name):
                            extra.add(n.id)
            self.env |= extra
            return self.taint(node.elt) or bool(extra)
        if isinstance(node, ast.DictComp):
            return self.taint(node.value)
        if isinstance(node, ast.Call):
            return self.call(node)
        return False

    # -- calls --------------------------------------------------------
    def _float64_args(self, node: ast.Call) -> None:
        func = node.func
        for kw in node.keywords:
            if kw.arg == "dtype" and isinstance(kw.value, ast.Constant) \
                    and kw.value.value in F64_NAMES:
                self._finding(FLOAT64_LEAK, node,
                              "float64 dtype inside the device region")
        if isinstance(func, ast.Attribute) and func.attr in (
                "to", "type", "astype") and node.args and isinstance(
                node.args[0], ast.Constant) and \
                node.args[0].value in F64_NAMES:
            self._finding(FLOAT64_LEAK, node,
                          f".{func.attr}('{node.args[0].value}') inside "
                          "the device region")

    def call(self, node: ast.Call) -> bool:
        arg_taints = [self.taint(a) for a in node.args]
        kw_taints = {kw.arg: self.taint(kw.value)
                     for kw in node.keywords if kw.arg is not None}
        any_tainted = any(arg_taints) or any(kw_taints.values())
        func = node.func
        self._float64_args(node)

        if isinstance(func, ast.Name):
            name = func.id
            if name in LAUNDER_BUILTINS:
                return False
            if name in SYNC_BUILTINS:
                if any_tainted:
                    self._sync(node, f"{name}() of a tensor")
                return False
            self.edges.append((name, arg_taints, kw_taints))
            return name in self.project_funcs and any_tainted

        if isinstance(func, ast.Attribute):
            root, chain = _attr_root(func)
            if root in self.mod.np_aliases:
                if any_tainted:
                    self._sync(node, f"np.{'.'.join(chain)} of a tensor "
                                     "(an implicit copy to the host)")
                return False
            if root in self.torch:
                if chain[:2] == ["cuda", "synchronize"]:
                    self._sync(node, "torch.cuda.synchronize()")
                    return False
                if chain[:1] in (["cuda"], ["device"], ["Size"]) or \
                        chain[-1:] in (["is_tensor"], ["get_device_name"]):
                    return False
                return True               # a tensor
            obj_tainted = self.taint(func.value)
            if not obj_tainted:
                return any_tainted and func.attr not in LAUNDER_METHODS
            if func.attr in LAUNDER_METHODS:
                return False
            if func.attr in SYNC_METHODS or _is_host_copy(node):
                self._sync(node, f".{func.attr}() of a tensor")
                return False
            if func.attr == "double" and not node.args:
                self._finding(FLOAT64_LEAK, node,
                              ".double() inside the device region")
            return True
        return any_tainted

    # -- statements ---------------------------------------------------
    def _bind(self, target, tainted: bool) -> None:
        if isinstance(target, ast.Name):
            if tainted:
                self.env.add(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._bind(e, tainted)
        elif isinstance(target, ast.Starred):
            self._bind(target.value, tainted)
        elif isinstance(target, (ast.Subscript, ast.Attribute)):
            self.taint(target)

    def run(self) -> None:
        # Two passes so taint assigned late in a loop body reaches
        # earlier uses; findings are emitted only on the final pass.
        emit = self.emit
        self.emit = False
        for stmt in self.node.body:
            self.stmt(stmt)
        self.emit = emit
        self.findings = []
        self.edges = []
        for stmt in self.node.body:
            self.stmt(stmt)

    def stmt(self, node) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return            # nested defs analyzed via their own edges
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            value = node.value
            tainted = self.taint(value) if value is not None else False
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            if isinstance(node, ast.AugAssign):
                tainted = tainted or self.taint(node.target)
            for t in targets:
                self._bind(t, tainted)
            return
        if isinstance(node, (ast.If, ast.While)):
            if self.taint(node.test):
                kind = "if" if isinstance(node, ast.If) else "while"
                self._sync(node, f"`{kind}` on a tensor's value")
            for s in node.body + node.orelse:
                self.stmt(s)
            return
        if isinstance(node, ast.Assert):
            if self.taint(node.test):
                self._sync(node, "assert on a tensor's value")
            return
        if isinstance(node, ast.For):
            self._bind(node.target, self.taint(node.iter))
            for s in node.body + node.orelse:
                self.stmt(s)
            return
        if isinstance(node, ast.With):
            for item in node.items:
                self.taint(item.context_expr)
            for s in node.body:
                self.stmt(s)
            return
        if isinstance(node, ast.Try):
            for s in (node.body + node.orelse + node.finalbody
                      + [h for hh in node.handlers for h in hh.body]):
                self.stmt(s)
            return
        if isinstance(node, ast.Return):
            if node.value is not None:
                self.taint(node.value)
            return
        if isinstance(node, ast.Expr):
            self.taint(node.value)
            return
        if isinstance(node, (ast.Raise, ast.Pass, ast.Break,
                             ast.Continue, ast.Global, ast.Nonlocal,
                             ast.Import, ast.ImportFrom, ast.Delete)):
            return
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self.taint(child)


def enclosing_functions(mod) -> dict:
    """id(node) -> the innermost FunctionDef containing it."""
    out: dict = {}

    def visit(fnode, current):
        for child in ast.iter_child_nodes(fnode):
            inner = (child if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef))
                else current)
            if current is not None:
                out[id(child)] = current
            visit(child, inner)

    visit(mod.tree, None)
    return out


def program_roots(project) -> dict:
    """The audit registry's roots, read from the source of the linted
    package's analysis/deviceaudit.py: {name: (relpath, function,
    tensor params)}. Empty when the package has no such module."""
    want = f"{project.root.name}/{AUDIT_MODULE}"
    mod = project.module_for(want)
    if mod is None:
        return {}
    for node in mod.tree.body:
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            if any(isinstance(t, ast.Name) and t.id == "PROGRAM_ROOTS"
                   for t in targets):
                return ast.literal_eval(node.value)
    return {}


def _resolve(project, mod, name):
    """Find the FunctionDef for a called name: same module first."""
    candidates = project.funcs_by_name.get(name, [])
    for cmod, cnode in candidates:
        if cmod is mod:
            return cmod, cnode
    if len(candidates) == 1:
        return candidates[0]
    return None, None


def _root_function(project, relpath: str, name: str):
    mod = project.module_for(f"{project.root.name}/{relpath}")
    if mod is None:
        return None, None
    for node in mod.tree.body:
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return mod, node
    return mod, None


def _device_region(project, roots: dict):
    """Fixpoint: map id(FunctionDef) -> _DeviceFn with tainted names."""
    region: dict = {}
    worklist: list = []
    aliases: dict = {}

    def torch_of(mod):
        if id(mod) not in aliases:
            aliases[id(mod)] = torch_aliases(mod)
        return aliases[id(mod)]

    def add(mod, node, tainted) -> None:
        fn = region.get(id(node))
        if fn is None:
            fn = region[id(node)] = _DeviceFn(mod, node, set(tainted))
            worklist.append(fn)
            return
        new = set(tainted) - fn.tainted
        if new:
            fn.tainted |= new
            if fn not in worklist:
                worklist.append(fn)

    for relpath, name, params in roots.values():
        rmod, rnode = _root_function(project, relpath, name)
        if rnode is not None:
            add(rmod, rnode, set(params) & set(_param_names(rnode)))

    funcs = frozenset(project.funcs_by_name)
    while worklist:
        fn = worklist.pop()
        analysis = _FnAnalysis(fn.mod, fn.node, fn.tainted,
                               torch_of(fn.mod), emit=False,
                               project_funcs=funcs)
        analysis.run()
        for name, arg_taints, kw_taints in analysis.edges:
            cmod, cnode = _resolve(project, fn.mod, name)
            if cnode is None or id(cnode) == id(fn.node):
                continue
            params = _param_names(cnode)
            tainted = {params[i] for i, t in enumerate(arg_taints)
                       if t and i < len(params)}
            tainted |= {k for k, t in kw_taints.items()
                        if t and k in params}
            if cmod is fn.mod and any(n is cnode
                                      for n in ast.walk(fn.node)):
                # A nested def sees the caller's tensors by closure.
                tainted |= analysis.env
            add(cmod, cnode, tainted)
    return region, torch_of


def _d2h_rule(project) -> list:
    findings = []
    for mod in project.modules:
        parts = mod.relpath.split("/")
        if not any(p in parts for p in D2H_SCOPES):
            continue
        scopes = enclosing_functions(mod)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call) or not _is_host_copy(node):
                continue
            fnode = scopes.get(id(node))
            name = fnode.name if fnode is not None else "<module>"
            if name in D2H_SANCTIONED:
                continue
            findings.append(Finding(
                D2H, mod.relpath, node.lineno,
                f"device-to-host copy in {name}(): copies in the "
                "codec/parallel/tensor layers are restricted to the "
                f"sanctioned transfer functions {sorted(D2H_SANCTIONED)}",
                ERROR, mod.source_line(node.lineno)))
    return findings


def run(project, roots: dict | None = None) -> list:
    """Findings of the three rules. ``roots`` defaults to
    :func:`program_roots` of the project."""
    findings: list = []
    region, torch_of = _device_region(
        project, program_roots(project) if roots is None else roots)
    funcs = frozenset(project.funcs_by_name)
    for fn in region.values():
        analysis = _FnAnalysis(fn.mod, fn.node, fn.tainted,
                               torch_of(fn.mod), emit=True,
                               project_funcs=funcs,
                               syncs_allowed=fn.node.name in D2H_SANCTIONED)
        analysis.run()
        findings += analysis.findings
        for node in ast.walk(fn.node):
            if isinstance(node, ast.Attribute) and node.attr in (
                    "float64", "double"):
                root, _ = _attr_root(node)
                if root in torch_of(fn.mod):
                    findings.append(Finding(
                        FLOAT64_LEAK, fn.mod.relpath, node.lineno,
                        f"torch.{node.attr} inside the device region",
                        ERROR, fn.mod.source_line(node.lineno)))
    findings += _d2h_rule(project)
    unique = {(f.rule, f.path, f.line): f for f in findings}
    return list(unique.values())

