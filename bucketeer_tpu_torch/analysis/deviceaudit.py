"""deviceaudit: a dispatch audit of what the port's device programs run.

graftlint's AST rules (rules_torch) reason about *source*; this layer
reasons about what runs. Eager PyTorch has no lowered program to read,
so each registered device program — the JAX package's registry
(``bucketeer_tpu/analysis/deviceaudit.py`` ``registry()``), entry for
entry, under the same names and canonical shapes — is *run* on a given
device under a :class:`~torch.utils._python_dispatch.TorchDispatchMode`
that records every aten op it dispatches:

- **dtype hygiene** — an op whose output is float64 is a hard failure
  (the card's float64 rate is a small fraction of its float32 rate);
- **host syncs** — every ``aten._local_scalar_dense`` (``.item()``,
  ``int()``/``bool()`` of a tensor, a Python branch on a value) and
  every op whose output shape depends on the data (``nonzero`` and
  kin), on a tensor of the audited device, recorded with the innermost
  frame of the package. A sync outside a sanctioned function is a hard
  failure;
- **device-to-host copies** — on the card, every op that reads a
  tensor of the card and writes a host tensor (``.cpu()``, ``copy_``
  into a host buffer), with its bytes. A copy outside a sanctioned
  function is a hard failure.

A sync or copy is sanctioned when its innermost package function is in
``rules_torch.D2H_SANCTIONED``, or when its line carries the inline
graftlint suppression of ``host-sync`` (a copy is a sync too) or of
``d2h-outside-gather`` (a copy) that the static rule honours, with its
reason beside it.

Each sync and copy is also timed: the wall time of its op, which on the
card includes the wait for the work queued before it (a ``.cpu()`` of
a tensor of the card blocks until the stream reaches it).

The audit runs on the card unless the caller asks for the CPU, and
raises when the card is asked for and CUDA is unavailable. On the CPU,
``.cpu()`` and ``.numpy()`` of a host tensor dispatch no op, so copies
are not counted there (the facts say so and :func:`render` prints "not
counted"); the CPU run checks syncs and float64. The hand-written
kernels (the ``.pallas`` entries, named after the JAX entries they
mirror) run on the card only and are reported as skipped elsewhere. A
ctypes kernel launch is not an aten op: the recorder sees the kernel's
output tensors being allocated, not the launch.

:func:`audit_call` wraps a whole entry-point call (an encode, a read)
with the same recorder. The dispatch mode is per thread: while it runs,
work submitted to any ``ThreadPoolExecutor`` runs under a recorder of
its own thread that feeds the same record. That patch is process-wide,
so a task another thread submits during the call is recorded too, and
audited calls are serialised by a module lock; threads started before
the call (a scheduler's device workers) are not covered, and the facts
say which threads were.

The d2h whitelist validation closes the loop from the other side:
every name in ``rules_torch.D2H_SANCTIONED`` must still name a function
of the package that performs a transfer (``.cpu()``, ``.numpy()``,
``.item()``, ``.tolist()``, ``copy_``) or calls another sanctioned
function; an entry that no longer does is reported stale
(``stale-d2h-whitelist``).

Each registered program's run also gives its **manifest entry**: a
fingerprint (the sha256 of its dispatched op sequence — op names with
their output shapes and dtypes), its op histogram, and its modeled cost
(:mod:`graftcost`: flops, device-memory bytes, launches, peak live
bytes; a hand-written kernel's cost is declared by its wrapper's
``work()``, which the CPU computes from the plain version's outputs, so
the manifest carries every program's cost on either device). Copies
between the host and the card are transfers, not program work: they
join neither the op sequence nor the cost. ``--audit`` diffs these
against the checked-in ``.graftaudit-torch-manifest.json`` (written by
``--write-manifest`` on the CPU); a modeled cost that moves beyond
:data:`COST_DRIFT_TOLERANCE` fails with one actionable line. An entry
whose ops differ on the card is kept in a section of its own for the
card's device type (``"devices": {"cuda": {...}}``), written by
``--write-manifest --audit-device cuda``, and the gate compares like
with like. The header names the torch version of each section; eager op
sequences are compared op by op, so a version change shows as drift of
the programs it changed and is not a failure by itself.

The JAX audit's donation checks have no eager counterpart (nothing is
donated).
"""
from __future__ import annotations

import ast
import hashlib
import json
import re
import sys
import threading
import time
import weakref
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path

from .findings import ERROR, WARNING, Finding

HOST_SYNC = "audit-host-sync"
HOST_TRANSFER = "audit-host-transfer"
F64_IN_PROGRAM = "audit-f64"
TOO_FEW = "audit-registry"
STALE_D2H = "stale-d2h-whitelist"
MANIFEST_DRIFT = "audit-manifest-drift"

MANIFEST_NAME = ".graftaudit-torch-manifest.json"

# Relative drift in a modeled cost field (flops / hbm_bytes / scan_depth
# / peak_live_bytes / ici_bytes / launches) beyond which the manifest
# gate fails — a change that silently doubles a program's modeled
# traffic fails here, with no benchmark run. Small churn stays under it.
COST_DRIFT_TOLERANCE = 0.10

_PKG_DIR = Path(__file__).resolve().parent.parent
_THIS = str(Path(__file__).resolve())

# Registry name (before the first "/") -> (module under the package, the
# function the entry runs, its parameters that take tensors). The lint
# (rules_torch) reads this literal from the source to find the roots of
# the device region, so it stays a plain literal.
PROGRAM_ROOTS = {
    "frontend.rows": ("codec/frontend.py", "_frontend_body",
                      ("step_map", "batch")),
    "frontend.cxd": ("codec/frontend.py", "_frontend_body",
                     ("step_map", "batch")),
    "pipeline.transform": ("codec/pipeline.py", "_transform_batch",
                           ("step_map", "batch")),
    "cxd.scan": ("kernels/cxd_scan.py", "cxd_scan_plain",
                 ("blocks", "nbps", "floors", "cls", "hs", "ws")),
    "cxd.scan.pallas": ("kernels/cxd_scan.py", "cxd_scan",
                        ("blocks", "nbps", "floors", "cls", "hs", "ws")),
    "cxdmq.fused": ("kernels/fused_t1.py", "fused_t1_plain",
                    ("blocks", "nbps", "floors", "cls", "hs", "ws")),
    "cxdmq.fused.pallas": ("kernels/fused_t1.py", "fused_t1",
                           ("blocks", "nbps", "floors", "cls", "hs",
                            "ws")),
    "decode.inverse": ("codec/decode/device.py", "_inverse_body",
                       ("half_map", "hv")),
    "decode.region_inverse": ("codec/decode/device.py", "_region_body",
                              ("hvs",)),
    "frontend.gather": ("codec/frontend.py", "gather_rows", ("rows",)),
    "tensor.pack": ("tensor/codec.py", "pack_blocks", ()),
    "decode.coeffs.dequant": ("tensor/coeffs.py", "dequant", ("hvs",)),
    "batch.assemble.dequant": ("tensor/coeffs.py", "run_dequant_inline",
                               ()),
}

# Ops whose output shape depends on the data: the host waits for the
# card to learn it.
_SHAPE_SYNC_OPS = ("nonzero", "masked_select", "_unique2",
                   "unique_consecutive", "unique_dim")


@dataclass(frozen=True)
class AuditProgram:
    """One registered device program at one canonical shape.
    ``build(device) -> thunk``: makes the inputs on ``device`` (outside
    the recorder) and returns the call of the program on them.
    ``card_only``: a hand-written kernel, which runs on CUDA only."""
    name: str
    build: object
    card_only: bool = False


@dataclass(frozen=True)
class Site:
    """The innermost package frame of a recorded event."""
    path: str            # relative to the package's parent
    qualname: str
    line: int

    @property
    def function(self) -> str:
        """The enclosing named function (generator expressions and
        lambdas fold into it)."""
        parts = [p for p in self.qualname.split(".")
                 if not p.startswith("<")]
        return parts[-1] if parts else self.qualname

    def label(self) -> str:
        return f"{self.path}:{self.qualname}"


@dataclass
class ProgramFacts:
    """What one audited program (or call) dispatched."""
    name: str
    ops: int = 0
    f64: Counter = field(default_factory=Counter)        # (op, site)
    syncs: Counter = field(default_factory=Counter)      # site -> n
    copies: Counter = field(default_factory=Counter)     # site -> n
    copy_bytes: Counter = field(default_factory=Counter)  # site -> B
    sync_seconds: Counter = field(default_factory=Counter)  # site -> s
    copy_seconds: Counter = field(default_factory=Counter)  # site -> s
    copies_counted: bool = True     # False on the CPU: no op to see
    threads: set = field(default_factory=set)
    pool_tasks: int = 0
    skipped: str = ""
    seconds: float = 0.0
    fingerprint: str = ""           # sha256 of the dispatched op sequence
    op_counts: Counter = field(default_factory=Counter)   # op -> n
    transfer_bytes: int = 0         # host <-> device copies, kept apart
    cost: object = None             # graftcost.CostFacts
    kernel: bool = False            # cost declared by a kernel's work()

    def by_function(self, kind: str) -> dict:
        """{"path:qualname": count} of syncs or copies (``kind``), of
        copied bytes (``"copy_bytes"``), or of the wall seconds of the
        syncs or copies (``"sync_seconds"``, ``"copy_seconds"``)."""
        out: Counter = Counter()
        for site, n in getattr(self, kind).items():
            out[site.label()] += n
        return dict(sorted(out.items()))


def _innermost_site(frame) -> Site | None:
    while frame is not None:
        fname = frame.f_code.co_filename
        if fname != _THIS and fname.startswith(str(_PKG_DIR)):
            rel = str(Path(fname).relative_to(_PKG_DIR.parent))
            return Site(rel, frame.f_code.co_qualname, frame.f_lineno)
        frame = frame.f_back
    return None


def _tensors(tree) -> list:
    import torch
    from torch.utils._pytree import tree_leaves

    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


# Aten ops that copy between devices: with the host on one side and the
# audited device on the other, a transfer rather than program work.
_COPY_OPS = ("_to_copy", "copy", "_copy_from", "_copy_from_and_resize")
# Ops that write their first argument without reading it.
_WRITE_ONLY = ("copy", "fill", "zero")
# Markers that run nothing: ``torch.as_tensor`` / ``torch.tensor`` of host
# data lifts a fresh host tensor (on the card, a host op before the
# transfer), so it is neither program work nor part of the sequence.
_MARKERS = ("lift_fresh",)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class _Tally:
    """The cost side of a record (graftcost's eager model): the op
    sequence's hash and histogram, flops, device-memory bytes and
    launches per op, and the storages alive at once. ``paused`` stops
    the count while a hand-written kernel's wrapper runs; its cost is
    declared instead (:func:`declared_call`)."""

    def __init__(self, name: str, device_type: str) -> None:
        from .graftcost import CostFacts

        self.cost = CostFacts(name)
        self.device_type = device_type
        self.sha = hashlib.sha256()
        self.counts: Counter = Counter()
        self.transfer_bytes = 0
        self.paused = 0
        self.live = 0
        self.peak = 0
        self.inputs = 0
        self.seen: dict = {}            # id(storage) -> bytes
        # Finalizers may run on any thread, also inside observe().
        self.lock = threading.RLock()

    def _see_locked(self, t, produced: bool) -> None:
        if t.device.type != self.device_type:
            return
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = id(st)
        if key in self.seen:
            return
        n = st.nbytes()
        self.seen[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        if not produced:
            self.inputs += n
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        with self.lock:
            self.live -= self.seen.pop(key, 0)

    def op(self, func, name: str, ins: list, outs: list) -> None:
        from .graftcost import op_base, op_flops

        dev = self.device_type
        base = op_base(name)
        if base in _MARKERS:
            return
        with self.lock:
            if dev != "cpu" and base in _COPY_OPS:
                kinds = {t.device.type for t in ins} | {
                    t.device.type for t in outs}
                if "cpu" in kinds and dev in kinds:
                    self.transfer_bytes += sum(_nbytes(t) for t in outs)
                    for t in outs:
                        self._see_locked(t, True)
                    return
            if self.paused:
                return
            if not any(t.device.type == dev for t in ins + outs):
                return              # host work during a card audit
            for t in ins:
                self._see_locked(t, False)
            for t in outs:
                self._see_locked(t, True)
            self.sha.update(name.encode())
            for t in outs:
                self.sha.update(f"{tuple(t.shape)}{t.dtype}".encode())
            self.counts[name] += 1
            if getattr(func, "is_view", False):
                return
            reads = ins[1:] if base in _WRITE_ONLY else ins
            cost = self.cost
            cost.launches += 1
            cost.hbm_bytes += (sum(_nbytes(t) for t in reads)
                               + sum(_nbytes(t) for t in outs))
            cost.flops += op_flops(base, reads, outs)

    def declare(self, cost) -> None:
        """Fold a hand-written kernel's declared work into the count."""
        with self.lock:
            self.peak = max(self.peak, self.live + cost.peak_live_bytes)
            self.cost.add(cost)

    def finish(self, out) -> object:
        with self.lock:
            cost = self.cost
            cost.peak_live_bytes = self.peak
            cost.input_bytes = self.inputs
            cost.output_sizes = tuple(
                _nbytes(t) for t in _tensors(out)
                if t.device.type == self.device_type)
            cost.output_bytes = sum(cost.output_sizes)
            return cost


class _Record:
    """The shared record of one audited run (every covered thread feeds
    it, under a lock)."""

    def __init__(self, facts: ProgramFacts, device_type: str,
                 cost: bool = False) -> None:
        import torch

        self.facts = facts
        self.device_type = device_type
        self.lock = threading.Lock()
        self._f64 = torch.float64
        self._names: dict = {}          # op overload -> (name, sync op)
        self.tally = _Tally(facts.name, device_type) if cost else None

    def observe(self, func, args, kwargs, out, seconds: float) -> None:
        info = self._names.get(func)
        if info is None:
            name = func.name()
            op = name.split("::")[-1].split(".")[0]
            info = self._names[func] = (
                name, op == "_local_scalar_dense" or op in _SHAPE_SYNC_OPS)
        name, sync_op = info
        dev = self.device_type
        outs = _tensors(out)
        f64 = any(t.dtype == self._f64 and t.device.type == dev
                  for t in outs)
        sync = copy = False
        if sync_op or (dev != "cpu"
                       and any(t.device.type == "cpu" for t in outs)):
            on_dev = any(t.device.type == dev
                         for t in _tensors((args, kwargs)))
            sync = sync_op and on_dev
            copy = not sync_op and on_dev
        site = (_innermost_site(sys._getframe(2))
                if sync or copy or f64 else None)
        with self.lock:
            facts = self.facts
            facts.ops += 1
            if sync:
                facts.syncs[site] += 1
                facts.sync_seconds[site] += seconds
            if copy:
                facts.copies[site] += 1
                facts.copy_seconds[site] += seconds
                facts.copy_bytes[site] += sum(
                    t.numel() * t.element_size() for t in outs
                    if t.device.type == "cpu")
            if f64:
                facts.f64[(name, site)] += 1
        if self.tally is not None:
            self.tally.op(func, name, _tensors((args, kwargs)), outs)


# The records the calling thread's recorders feed, innermost last.
_ACTIVE = threading.local()


def _mode(record: _Record):
    """A recorder for the calling thread, feeding ``record``."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Recorder(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            t0 = time.perf_counter()
            out = func(*args, **kwargs)
            record.observe(func, args, kwargs, out,
                           time.perf_counter() - t0)
            return out

        def __enter__(self):
            stack = getattr(_ACTIVE, "records", None)
            if stack is None:
                stack = _ACTIVE.records = []
            stack.append(record)
            return super().__enter__()

        def __exit__(self, *exc):
            _ACTIVE.records.pop()
            return super().__exit__(*exc)

    with record.lock:
        record.facts.threads.add(threading.current_thread().name)
    return _Recorder()


def declared_call(fn, work, L: int, frac: int, args):
    """``fn(L, frac, *args)``, a hand-written kernel's wrapper, with its
    cost declared by ``work(L, args, out)`` (a ctypes launch is not an
    aten op): while it runs, the calling thread's record counts no op
    cost, then the declared work joins it. The syncs and copies of the
    wrapper are still judged. Without a recorder it is the plain call."""
    from torch.utils._python_dispatch import _disable_current_modes

    stack = getattr(_ACTIVE, "records", None)
    tally = stack[-1].tally if stack else None
    if tally is None:
        return fn(L, frac, *args)
    with tally.lock:
        for t in args:
            tally._see_locked(t, False)
        tally.paused += 1
    try:
        out = fn(L, frac, *args)
    finally:
        with tally.lock:
            tally.paused -= 1
    with _disable_current_modes():
        tally.declare(work(L, args, out))
    return out


class _CoverPools:
    """While active, every task submitted to a ThreadPoolExecutor runs
    under a recorder of its own thread feeding ``record``."""

    def __init__(self, record: _Record) -> None:
        self.record = record
        self._orig = None

    def __enter__(self):
        orig = self._orig = ThreadPoolExecutor.submit
        record = self.record

        def submit(pool, fn, /, *args, **kwargs):
            def covered(*a, **kw):
                with _mode(record):
                    return fn(*a, **kw)
            with record.lock:
                record.facts.pool_tasks += 1
            return orig(pool, covered, *args, **kwargs)

        ThreadPoolExecutor.submit = submit
        return self

    def __exit__(self, *exc):
        ThreadPoolExecutor.submit = self._orig
        return False


def device_type(device) -> str:
    """The device's type; raises when the card is asked for and CUDA is
    unavailable (an audit there would count nothing)."""
    import torch

    kind = torch.device(device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"an audit on {device} asked for, but CUDA is unavailable: "
            "this torch build or machine has no usable CUDA device (pass "
            "device \"cpu\" to audit on the host, where device-to-host "
            "copies are not counted)")
    return kind


def _synchronize(device_type: str) -> None:
    if device_type == "cuda":
        import torch

        torch.cuda.synchronize()


# One audited call at a time in a process: the pool patch is
# process-wide, and overlapping calls would restore it out of order.
_AUDIT_LOCK = threading.RLock()


def audit_call(fn, *args, audit_name: str | None = None,
               audit_device=None, audit_cost: bool = False, **kwargs):
    """Run ``fn(*args, **kwargs)`` under the recorder; returns
    (result, ProgramFacts). ``audit_device`` names the device whose
    syncs and copies count: by default the call's own ``device``
    argument, else the card. ``audit_cost`` also models the call's cost
    and fingerprints its op sequence (``facts.cost``,
    ``facts.fingerprint``, ``facts.op_counts``). Calls from several
    threads run one after another."""
    dtype = device_type(audit_device or kwargs.get("device", "cuda"))
    facts = ProgramFacts(audit_name
                         or getattr(fn, "__qualname__", str(fn)),
                         copies_counted=dtype != "cpu")
    record = _Record(facts, dtype, cost=audit_cost)
    with _AUDIT_LOCK:
        t0 = time.perf_counter()
        with _CoverPools(record), _mode(record):
            out = fn(*args, **kwargs)
            _synchronize(dtype)
        facts.seconds = time.perf_counter() - t0
    tally = record.tally
    if tally is not None:
        facts.cost = tally.finish(out)
        facts.fingerprint = tally.sha.hexdigest()
        facts.op_counts = tally.counts
        facts.transfer_bytes = tally.transfer_bytes
    return out, facts


def _root(prefix: str):
    """The function a registry entry runs, looked up from
    PROGRAM_ROOTS, so the registry and the lint's device region name
    the same functions."""
    import importlib

    path, func, _ = PROGRAM_ROOTS[prefix]
    module = importlib.import_module(
        f"{__package__.rsplit('.', 1)[0]}."
        + path.removesuffix(".py").replace("/", "."))
    return getattr(module, func)


def registry() -> list:
    """The audited device programs: one entry per JAX registry entry,
    same names and canonical shapes (the smallest power-of-two buckets
    of the shipping tile geometry), with inputs made from a fixed seed
    on the device the audit runs on."""
    import numpy as np
    import torch

    from ..codec import frontend
    from ..codec.decode import device as ddevice
    from ..codec.pipeline import _step_map, make_plan
    from ..codec.quant import FRAC_BITS

    rng = np.random.default_rng(0)

    def on(device, arr):
        return torch.as_tensor(np.ascontiguousarray(arr), device=device)

    plan_g = make_plan(64, 64, 1, 2, True, 8)
    plan_c = make_plan(64, 64, 3, 2, False, 8)
    tiles_g = rng.integers(0, 256, (1, 64, 64, 1)).astype(np.int32)
    tiles_c = rng.integers(0, 256, (2, 64, 64, 3)).astype(np.int32)

    def frontend_entry(plan, tiles, mode):
        body = _root(f"frontend.{mode}")

        def build(device):
            step_map = (None if plan.lossless
                        else on(device, _step_map(plan)))
            frac = 0 if plan.lossless else FRAC_BITS
            staged = on(device, tiles)
            P = frontend.layout_for(plan).P
            return lambda: body(plan, P, frac, mode, step_map, staged)
        return build

    entries = [
        AuditProgram("frontend.rows/gray8-lossless-64x64-L2/B1",
                     frontend_entry(plan_g, tiles_g, "rows")),
        AuditProgram("frontend.rows/rgb8-lossy-64x64-L2/B2",
                     frontend_entry(plan_c, tiles_c, "rows")),
        AuditProgram("frontend.cxd/gray8-lossless-64x64-L2/B1",
                     frontend_entry(plan_g, tiles_g, "cxd")),
    ]

    def transform_entry(device):
        staged = on(device, tiles_g)
        return lambda: _root("pipeline.transform")(plan_g, None, staged)

    entries.append(AuditProgram(
        "pipeline.transform/gray8-lossless-64x64-L2/B1", transform_entry))

    # One 64x64 block of magnitudes < 4 (two coded planes at L=2) with a
    # 16x16 coded extent (an edge block: the plain versions' loops stay
    # short on the CPU) and its (1,) meta, lossless (frac 0).
    block = rng.integers(-3, 4, (1, 64, 64)).astype(np.int32)
    meta = [np.full(1, v, np.int32) for v in (2, 0, 0, 16, 16)]

    def t1_entry(prefix):
        import importlib

        fn = _root(prefix)
        # A kernel's wrapper declares its cost (the launch is not an aten
        # op); the plain versions are counted op by op.
        work = (getattr(importlib.import_module(fn.__module__), "work",
                        None) if prefix.endswith(".pallas") else None)

        def build(device):
            args = [on(device, block)] + [on(device, m) for m in meta]

            def thunk():
                return fn(2, 0, *args)
            if work is not None:
                thunk.work = lambda out: work(2, args, out)
            return thunk
        return build

    entries += [
        AuditProgram("cxd.scan/L2/N1", t1_entry("cxd.scan")),
        AuditProgram("cxd.scan.pallas/L2/N1", t1_entry("cxd.scan.pallas"),
                     card_only=True),
        AuditProgram("cxdmq.fused/L2/N1", t1_entry("cxdmq.fused")),
        AuditProgram("cxdmq.fused.pallas/L2/N1",
                     t1_entry("cxdmq.fused.pallas"), card_only=True),
    ]

    iplan_g = ddevice.make_inverse_plan(64, 64, 1, 2, True, 8, False,
                                        lambda lvl, name: 1.0)
    iplan_c = ddevice.make_inverse_plan(64, 64, 3, 2, False, 8, True,
                                        lambda lvl, name: 0.5)

    def inverse_entry(plan, shape):
        hv = rng.integers(-512, 512, shape).astype(np.int32)

        def build(device):
            half_map = (None if plan.reversible
                        else ddevice._half_step_map(plan, str(device)))
            staged = on(device, hv)
            return lambda: _root("decode.inverse")(plan, half_map, staged)
        return build

    entries += [
        AuditProgram("decode.inverse/gray8-reversible-64x64-L2/B1",
                     inverse_entry(iplan_g, (1, 1, 64, 64))),
        AuditProgram("decode.inverse/rgb8-irreversible-64x64-L2/B2",
                     inverse_entry(iplan_c, (2, 3, 64, 64))),
    ]

    rplan = ddevice.make_region_plan(64, 64, 1, 2, True, 8, False,
                                     lambda lvl, name: 1.0,
                                     16, 48, 16, 48)
    region_hv = [rng.integers(-512, 512, (1, by1 - by0, bx1 - bx0))
                 .astype(np.int32)
                 for _, _, by0, by1, bx0, bx1, _ in rplan.slots]

    def region_entry(device):
        hvs = [on(device, a) for a in region_hv]
        return lambda: _root("decode.region_inverse")(rplan, hvs)

    entries.append(AuditProgram(
        "decode.region_inverse/gray8-reversible-64x64-L2/win32",
        region_entry))

    rows = rng.integers(0, 256, (84, 512)).astype(np.uint8)
    src = rng.integers(0, 84, 4096).astype(np.int64)

    def gather_entry(device):
        staged = on(device, rows)
        return lambda: _root("frontend.gather")(staged, src,
                                                frontend.ROW_BYTES)

    entries.append(AuditProgram("frontend.gather/rows512/chunk4096",
                                gather_entry))

    limbs = rng.integers(-2**15, 2**15, (4, 4096)).astype(np.int32)
    entries.append(AuditProgram(
        "tensor.pack/B4",
        lambda device: lambda: _root("tensor.pack")(limbs, device)))

    dq_shapes = ((1, 16, 16), (1, 16, 16), (1, 16, 16), (1, 16, 16),
                 (1, 32, 32), (1, 32, 32), (1, 32, 32))

    def dq_entry(reversible, deltas, shapes):
        planes = [rng.integers(-512, 512, s).astype(np.int32)
                  for s in shapes]

        def build(device):
            hvs = [on(device, p) for p in planes]
            return lambda: _root("decode.coeffs.dequant")(
                reversible, deltas, hvs)
        return build

    entries += [
        AuditProgram("decode.coeffs.dequant/gray-reversible-L2",
                     dq_entry(True, (1.0,) * 7, dq_shapes)),
        AuditProgram("decode.coeffs.dequant/gray-irreversible-L2",
                     dq_entry(False, (0.5,) * 7, dq_shapes)),
    ]

    # The merged dequantizer as the scheduler's _launch_dequant runs it
    # for a batch read (batches/assemble.py): the group's per-band host
    # planes stacked along a leading batch axis, one copy in.
    def bdq_entry(reversible, deltas, shapes):
        planes = [rng.integers(-512, 512, (4,) + s).astype(np.int32)
                  for s in shapes]
        return lambda device: lambda: _root("batch.assemble.dequant")(
            reversible, deltas, planes, device)

    entries += [
        AuditProgram("batch.assemble.dequant/gray-reversible-L2/B4",
                     bdq_entry(True, (1.0,) * 7, dq_shapes)),
        AuditProgram("batch.assemble.dequant/gray-irreversible-L2/B4",
                     bdq_entry(False, (0.5,) * 7, dq_shapes)),
    ]
    return entries


def _declared(thunk, out, name: str):
    """A kernel entry's declared cost: its wrapper's ``work()`` on the
    output, computed outside any recorder."""
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes():
        cost = thunk.work(out)
    cost.name = name
    return cost


def run_program(entry: AuditProgram, device="cuda") -> ProgramFacts:
    """Run one registered program on ``device`` (the card unless the
    caller asks for the CPU) under the recorder, its cost modeled. A
    hand-written kernel runs on the card only: elsewhere it is reported
    skipped, and its wrapper's declared work on the plain version's
    outputs (equal to the kernel's) still gives its cost."""
    dtype = device_type(device)
    thunk = entry.build(device)
    work = getattr(thunk, "work", None)
    if entry.card_only and dtype != "cuda":
        facts = ProgramFacts(entry.name, kernel=True, skipped=(
            "a hand-written CUDA kernel: it runs on the card only"))
        if work is not None:
            facts.cost = _declared(thunk, thunk(), entry.name)
        return facts
    _synchronize(dtype)
    out, facts = audit_call(thunk, audit_name=entry.name,
                            audit_device=device, audit_cost=True)
    if work is not None:
        facts.kernel = True
        facts.cost = _declared(thunk, out, entry.name)
    return facts


def run_programs(device="cuda") -> list:
    """Run every registered program; returns [ProgramFacts]. The Tier-1
    lookup tables (built once per device, on first use) are built first,
    so no program's peak live bytes depend on what ran before it in the
    process."""
    import torch

    from ..kernels.cxd_scan import tables

    device_type(device)
    tables(torch.empty(0, device=device).device)
    return [run_program(e, device) for e in registry()]


# --- manifest -------------------------------------------------------------

def manifest_entry(facts: ProgramFacts) -> dict | None:
    """One program's manifest record: the fingerprint of its op
    sequence, its op histogram and its cost — or, for a hand-written
    kernel, its declared cost alone (the ops the recorder sees there are
    the wrapper's bookkeeping, not the kernel). None when nothing is
    known."""
    if facts.kernel:
        if facts.cost is None:
            return None
        return {"kernel": True, "cost": facts.cost.manifest_entry()}
    if facts.skipped:
        return None
    entry = {"fingerprint": facts.fingerprint,
             "n_ops": sum(facts.op_counts.values()),
             "op_counts": dict(sorted(facts.op_counts.items()))}
    if facts.cost is not None:
        entry["cost"] = facts.cost.manifest_entry()
    return entry


def manifest_from_facts(all_facts: list) -> dict:
    import torch

    programs = {}
    for f in all_facts:
        entry = manifest_entry(f)
        if entry is not None:
            programs[f.name] = entry
    return {"torch": torch.__version__, "programs": programs}


def load_manifest(path) -> dict | None:
    try:
        return json.loads(Path(path).read_text(encoding="utf-8"))
    except (OSError, json.JSONDecodeError):
        return None


def write_manifest(path, manifest: dict) -> None:
    Path(path).write_text(json.dumps(manifest, indent=2) + "\n",
                          encoding="utf-8")


def section(manifest: dict | None, device: str, key: str = "programs"):
    """(entries, torch version) of ``manifest``'s ``key`` section as a
    device type sees it: the CPU run's entries with the device type's
    own entries (``"devices": {type: {key: ...}}``) in their place.
    (None, None) when the manifest has no such section."""
    if manifest is None or key not in manifest:
        return None, None
    entries = dict(manifest[key])
    version = manifest.get("torch")
    own = manifest.get("devices", {}).get(device)
    if own is not None:
        entries.update(own.get(key, {}))
        version = own.get("torch", version)
    return entries, version


def merge_manifest(old: dict | None, new: dict, device: str,
                   keys=("programs",)) -> dict:
    """The manifest to write after a run on ``device``: a CPU run
    replaces the ``keys`` sections (the rest is carried over); a run on
    another device type keeps the CPU sections and records, in that
    type's own section, only the entries whose ops differ from them
    (another fingerprint or collective histogram) or whose modeled cost
    moves beyond the tolerance."""
    out = json.loads(json.dumps(old)) if old else {}
    if device == "cpu" or not out:
        out["torch"] = new["torch"]
        for key in keys:
            out[key] = new[key]
        return out
    own = out.setdefault("devices", {}).setdefault(device, {})
    own["torch"] = new["torch"]
    for key in keys:
        base = out.get(key, {})
        own[key] = {name: e for name, e in new[key].items()
                    if _differs(base.get(name), e)}
    return out


def _differs(old: dict | None, new: dict) -> bool:
    if old is None:
        return True
    return (old.get("fingerprint") != new.get("fingerprint")
            or old.get("collectives") != new.get("collectives")
            or bool(_cost_drift(old.get("cost", {}), new.get("cost", {}))))


def _cost_drift(old_cost: dict, new_cost: dict) -> list:
    """Per-field relative drifts beyond COST_DRIFT_TOLERANCE, as
    rendered fragments ("hbm_bytes 1.2e6 -> 2.6e6 (+117%)")."""
    frags = []
    for key in ("flops", "hbm_bytes", "scan_depth", "peak_live_bytes",
                "ici_bytes", "launches"):
        a, b = old_cost.get(key), new_cost.get(key)
        if a is None or b is None or a == b:
            continue
        rel = (b - a) / max(abs(a), 1)
        if abs(rel) > COST_DRIFT_TOLERANCE:
            frags.append(f"{key} {a:g} -> {b:g} ({rel:+.0%})")
    return frags


def diff_manifest(old: dict | None, new: dict, skipped=(),
                  device: str = "cpu") -> list:
    """Human-readable drift lines between the checked-in manifest (as
    ``device``'s type sees it, :func:`section`) and a fresh run (empty =
    no drift). Programs named in ``skipped`` are tolerated missing;
    everything else — fingerprint changes, op-count deltas, added or
    removed programs, and modeled cost beyond COST_DRIFT_TOLERANCE —
    is drift. A modeled-cost drift is reported as what got more
    expensive and by how much, one line per program; a hand-written
    kernel's entry is its declared cost alone."""
    olds, version = section(old, device)
    if olds is None:
        return [f"no checked-in manifest: {len(new['programs'])} "
                "program(s) unaccounted — regenerate with "
                "--write-manifest and commit it"]
    note = ("" if version == new.get("torch") else
            f" (the manifest was written under torch {version}, this "
            f"run is torch {new.get('torch')})")
    lines = []
    news = new["programs"]
    for name in sorted(set(olds) - set(news) - set(skipped)):
        lines.append(f"{name}: in the manifest but no longer run "
                     "(registry entry removed?)")
    for name in sorted(set(news) - set(olds)):
        lines.append(f"{name}: run but absent from the manifest (new "
                     "program — regenerate the manifest)")
    for name in sorted(set(news) & set(olds)):
        o, n = olds[name], news[name]
        cost_frags = _cost_drift(o.get("cost", {}), n.get("cost", {}))
        if cost_frags:
            lines.append(
                f"{name}: modeled cost drifted beyond "
                f"{COST_DRIFT_TOLERANCE:.0%} ({'; '.join(cost_frags)})"
                " — a perf-relevant program change; if intentional, "
                "regenerate with --write-manifest and justify the new "
                "cost in review")
            continue
        if o.get("fingerprint") == n.get("fingerprint"):
            continue
        deltas = []
        oc, nc = o.get("op_counts", {}), n.get("op_counts", {})
        for op in sorted(set(oc) | set(nc)):
            a, b = oc.get(op, 0), nc.get(op, 0)
            if a != b:
                deltas.append(f"{op} {a}->{b}")
        detail = ("; ".join(deltas[:8]) if deltas
                  else "same op counts, different order or shapes")
        lines.append(f"{name}: dispatched program drifted "
                     f"({o.get('n_ops')} -> {n.get('n_ops')} ops: "
                     f"{detail}; modeled cost within tolerance){note}")
    return lines


# --- judging --------------------------------------------------------------

_SOURCE_LINES: dict = {}


def _suppressed(site: Site, rule: str) -> bool:
    """Whether the site's line (or the line above) carries the inline
    ``# graftlint: disable=<rule>`` the static rule honours."""
    from .lint import _DISABLE_RE

    lines = _SOURCE_LINES.get(site.path)
    if lines is None:
        try:
            lines = (_PKG_DIR.parent / site.path).read_text(
                encoding="utf-8").splitlines()
        except OSError:
            lines = []
        _SOURCE_LINES[site.path] = lines
    for lineno in (site.line, site.line - 1):
        if 1 <= lineno <= len(lines):
            m = _DISABLE_RE.search(lines[lineno - 1])
            if m and rule in m.group(1).split(","):
                return True
    return False


def sanctioned(site: Site | None, copy: bool = False) -> bool:
    """A sync (``copy=False``) or copy at ``site`` is sanctioned: its
    function is in D2H_SANCTIONED or its line carries the inline
    suppression of ``host-sync`` (or, for a copy, of
    ``d2h-outside-gather``)."""
    from .rules_torch import D2H, D2H_SANCTIONED, HOST_SYNC

    if site is None:
        return False
    if site.function in D2H_SANCTIONED or _suppressed(site, HOST_SYNC):
        return True
    return copy and _suppressed(site, D2H)


def unsanctioned(facts: ProgramFacts) -> tuple:
    """({site: n} syncs, {site: n} copies) outside the sanctioned
    list."""
    syncs = {s: n for s, n in facts.syncs.items() if not sanctioned(s)}
    copies = {s: n for s, n in facts.copies.items()
              if not sanctioned(s, copy=True)}
    return syncs, copies


def check_program(facts: ProgramFacts) -> list:
    """Findings for one program's facts (empty = clean)."""
    loc = f"<deviceaudit:{facts.name}>"
    if facts.skipped:
        return []
    out = []
    for (op, site), n in sorted(facts.f64.items(), key=str):
        where = site.label() if site else "outside the package"
        out.append(Finding(
            F64_IN_PROGRAM, loc, 0,
            f"{n} float64 output(s) of {op} in {where}", ERROR))
    syncs, copies = unsanctioned(facts)
    for site, n in sorted(syncs.items(), key=str):
        where = f"{site.label()}:{site.line}" if site else "outside the " \
            "package"
        out.append(Finding(
            HOST_SYNC, loc, 0,
            f"{n} host sync(s) in {where}, outside the sanctioned "
            "transfer functions", ERROR))
    for site, n in sorted(copies.items(), key=str):
        where = f"{site.label()}:{site.line}" if site else "outside the " \
            "package"
        out.append(Finding(
            HOST_TRANSFER, loc, 0,
            f"{n} device-to-host cop(ies) ({facts.copy_bytes[site]} B) "
            f"in {where}, outside the sanctioned transfer functions",
            ERROR))
    return out


def render(facts: ProgramFacts) -> str:
    """One line per program."""
    if facts.skipped:
        return f"deviceaudit: {facts.name}: skipped ({facts.skipped})"
    syncs, copies = unsanctioned(facts)
    copied = (f"{sum(facts.copies.values())} device-to-host cop(ies) of "
              f"{sum(facts.copy_bytes.values())} B "
              f"({sum(copies.values())} unsanctioned)"
              if facts.copies_counted else
              "device-to-host copies not counted on the CPU")
    return (f"deviceaudit: {facts.name}: {facts.ops} ops, "
            f"{sum(facts.syncs.values())} host sync(s) "
            f"({sum(syncs.values())} unsanctioned), {copied}, "
            f"{sum(facts.f64.values())} float64 output(s)")


# --- d2h whitelist validation --------------------------------------------

_TRANSFER_CALLS = {"cpu", "numpy", "item", "tolist", "copy_"}


def _calls_in(fnode: ast.AST):
    for node in ast.walk(fnode):
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute):
                yield f.attr
            elif isinstance(f, ast.Name):
                yield f.id


def validate_d2h_whitelist(project) -> list:
    """Cross-check rules_torch.D2H_SANCTIONED against the code: every
    sanctioned name must still name a function of the package that
    performs a device-to-host transfer or calls another sanctioned
    function; a stale entry widens the fence for free."""
    from .rules_torch import D2H_SANCTIONED

    defs: dict = {}
    for mod in project.modules:
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name in D2H_SANCTIONED:
                defs.setdefault(node.name, []).append((mod, node))

    where = f"{project.root.name}/analysis/rules_torch.py"
    findings = []
    for name in sorted(D2H_SANCTIONED):
        sites = defs.get(name)
        if not sites:
            findings.append(Finding(
                STALE_D2H, where, 1,
                f"d2h whitelist entry '{name}' matches no function of "
                "the package — remove it from D2H_SANCTIONED", WARNING))
            continue
        for mod, node in sites:
            called = set(_calls_in(node))
            if called & _TRANSFER_CALLS or called & (D2H_SANCTIONED
                                                    - {name}):
                continue
            findings.append(Finding(
                STALE_D2H, mod.relpath, node.lineno,
                f"d2h whitelist entry '{name}' no longer performs a "
                "device-to-host transfer (no .cpu() / .numpy() / "
                ".item() / .tolist() / copy_ and no call into another "
                "sanctioned function) — stale whitelist entries widen "
                "the fence for free", WARNING,
                mod.source_line(node.lineno)))
    return findings


# --- the full audit ------------------------------------------------------

def run_audit(device="cuda", package_root=None, manifest_path=None,
              facts=None, dump_dir=None):
    """Run every registered program on ``device``, judge each, validate
    the d2h whitelist and, with ``manifest_path``, diff the manifest.
    Returns (findings, facts). ``facts`` takes a precomputed
    ``run_programs()`` result, so a CLI run combining ``--audit`` with
    ``--cost`` runs the registry once. On any finding with ``dump_dir``
    set, each program's op histogram is written there."""
    from .lint import load_project

    all_facts = run_programs(device) if facts is None else facts
    findings = []
    for f in all_facts:
        findings += check_program(f)
    ran = [f for f in all_facts if not f.skipped]
    if len(ran) < 3:
        findings.append(Finding(
            TOO_FEW, "<deviceaudit>", 0,
            f"only {len(ran)} program(s) ran — the audit needs the "
            "registry to cover the device programs (skipped: "
            f"{[f.name for f in all_facts if f.skipped]})", ERROR))
    if manifest_path is not None:
        for line in diff_manifest(
                load_manifest(manifest_path),
                manifest_from_facts(all_facts),
                skipped=tuple(f.name for f in all_facts
                              if manifest_entry(f) is None),
                device=device_type(device)):
            findings.append(Finding(MANIFEST_DRIFT, str(manifest_path), 0,
                                    line, ERROR))
    if package_root is not None:
        findings += validate_d2h_whitelist(load_project(Path(package_root)))
    if findings and dump_dir:
        dump_ops(dump_dir, all_facts)
    return findings, all_facts


def dump_ops(dump_dir, all_facts: list) -> None:
    """Write each program's op histogram and fingerprint to
    ``dump_dir`` (the counterpart of the JAX audit's lowered-text
    dumps)."""
    dump = Path(dump_dir)
    dump.mkdir(parents=True, exist_ok=True)
    for f in all_facts:
        safe = re.sub(r"[^\w.\-]", "_", f.name)
        (dump / f"{safe}.ops.json").write_text(json.dumps({
            "name": f.name, "fingerprint": f.fingerprint,
            "op_counts": dict(sorted(f.op_counts.items())),
            "cost": (f.cost.manifest_entry() if f.cost is not None
                     else None)}, indent=2) + "\n", encoding="utf-8")
