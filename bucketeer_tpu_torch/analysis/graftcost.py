"""graftcost: the port's roofline and memory-traffic model of its device
programs.

The JAX package's graftcost walks lowered StableHLO text under a
fusion-region model (its ``parse_module`` / ``_body_cost`` /
``_while_trips``). Eager PyTorch has no lowered program to parse, so
none of that is here. This model reads what the port's dispatch
recorder (:mod:`deviceaudit`) already sees — every aten op an audited
program dispatches, with its argument and output tensors — and reports,
per program:

- **FLOPs, device-memory bytes and launches**, op by op. An op whose
  output aliases its input (``OpOverload.is_view``) moves nothing. Every
  other op reads its input tensors and writes its outputs once to device
  memory: eager PyTorch runs one kernel per op, so for the port this is
  a count of what runs, not a model of what a compiler would fuse (the
  JAX model's fusion regions have no counterpart). FLOPs use the JAX
  model's weights (``_FLOP_WEIGHT``): output elements for elementwise
  ops, input elements for reductions, ``2*M*N*K`` for ``mm`` / ``bmm`` /
  ``addmm``, and 0 for copies, indexing, layout and factories.
  ``launches`` is the count of non-view ops dispatched on the device.
  Copies between the host and the device are transfers, not program
  work: the recorder keeps them apart, so a program models alike on the
  CPU and on the card.
- **Peak live bytes**: the recorder's own tally of the storages alive at
  once (a ``weakref.finalize`` on each new storage it sees), so the CPU
  and the card count alike.
- **Declared cost of a hand-written kernel**: a ctypes launch is not an
  aten op and the recorder cannot see it, so each kernel wrapper
  (``kernels/fused_t1.py``, ``cxd_scan.py``, ``mq_scan.py``) declares
  ``work(L, args, out) -> CostFacts``: its input extents and meta read
  once, its meaningful outputs written once, one operation per coded
  decision, and ``scan_depth`` = ``max_trip`` = the decisions of the
  group's longest block (the serial chain).
- **Arithmetic intensity and a roofline classification** against a
  :class:`MachineModel` (``h100``, the default, and ``cpu``): modeled
  time = max(flops/peak, bytes/bandwidth, link bytes/link bandwidth) +
  serial steps x ``seq_step_s`` + launches x ``launch_s``; the bound is
  whichever of compute, memory, link and the serial chain dominates
  (the launch floor adds to the time, as the serial term does, but
  names no class).

Machine numbers rank programs and detect drift; ``chip_smoke.py``
phase 14 holds the ``h100`` model against measured kernel times (the
calibration loop), so the model is checked by use, not trusted.

The module also owns the **workload-shape histogram**: the codec's
launch seams (``frontend.dispatch_frontend``, ``pipeline.run_tiles``,
the Tier-1 launch groups in ``codec/cxd.py``,
``decode.device.run_inverse``) record (real, padded) pairs through
:func:`record_bucket`, and :func:`padding_waste` turns a histogram into
the fraction of modeled work spent on padding. The port pads no batch
to a pow-2 bucket (there is no compiled shape to reuse), so its batch
families record real == padded; ``cxd.planes`` records each launch
group's realized plane depth against its plane budget L.

Findings over these facts live in :mod:`rules_perf`; the CLI surface is
``python -m bucketeer_tpu_torch.analysis --cost [--machine h100|cpu]
[--cost-report out.json]``.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass

# --- machine models ------------------------------------------------------


@dataclass(frozen=True)
class MachineModel:
    """Roofline parameters for one execution target.

    ``seq_step_s`` is the cost of one serial step of a kernel (one coded
    decision of the Tier-1 scan's longest block); ``launch_s`` the floor
    of one kernel launch; ``vmem_bytes`` the fast-memory budget a
    resident working set must fit. ``ici_bandwidth`` (bytes/s per
    device) and ``n_devices`` price what crosses between mesh entries
    (analysis/graftmesh.py): modeled time becomes max(compute, memory,
    link) plus the serial and launch terms."""
    name: str
    peak_flops: float        # sustained 32-bit flop/s outside matrix units
    hbm_bytes_per_s: float
    vmem_bytes: int
    seq_step_s: float
    ici_bandwidth: float = 0.0   # per-device link bytes/s; 0 = no mesh
    n_devices: int = 1           # devices in the modeled mesh
    launch_s: float = 0.0        # per-launch floor

    def ridge(self) -> float:
        """Arithmetic intensity (flop/byte) where the roofline bends."""
        return self.peak_flops / self.hbm_bytes_per_s


MACHINES = {
    # NVIDIA H100 SXM (data sheet): 67 TFLOP/s float32 outside the
    # tensor cores, 3.35 TB/s HBM3, a 50 MB L2 as the fast-memory
    # budget, NVLink 4 at 450 GB/s each way per card, four cards to a
    # host. seq_step_s: fused_t1's serial chain, 113.7 ns per decision,
    # and launch_s: the probe kernel's launch floor, 1.08 us — both
    # measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6,
    # rows 1 and 4, chip_smoke.py).
    "h100": MachineModel("h100", peak_flops=67.0e12,
                         hbm_bytes_per_s=3.35e12,
                         vmem_bytes=50 * 1024 * 1024,
                         seq_step_s=113.7e-9,
                         ici_bandwidth=450.0e9, n_devices=4,
                         launch_s=1.08e-6),
    # The JAX package's cpu constants, unchanged, so the same facts give
    # the same roofline in both packages; the one new constant, the
    # launch floor, is the JAX per-step overhead (an eager op's dispatch
    # on the host), and facts with no launches — every JAX program's —
    # never pay it. The host mesh's "links" are memcpys through shared
    # memory, effectively free next to the compute and memory terms.
    "cpu": MachineModel("cpu", peak_flops=1.0e11,
                        hbm_bytes_per_s=3.0e10,
                        vmem_bytes=32 * 1024 * 1024,
                        seq_step_s=5.0e-6,
                        ici_bandwidth=1.0e12, n_devices=8,
                        launch_s=5.0e-6),
}
DEFAULT_MACHINE = "h100"


def machine_for(device) -> MachineModel:
    """The machine model of a launch's device: ``h100`` for a CUDA
    device, ``cpu`` for the CPU — chosen from the device itself, never
    from what is installed."""
    kind = getattr(device, "type", None) or str(device).split(":")[0]
    return MACHINES["cpu" if kind == "cpu" else "h100"]


# --- the op cost table ---------------------------------------------------

# Per-element flop weights of the JAX model, keyed by aten name.
_FLOP_WEIGHT = {"div": 4, "divide": 4, "remainder": 4, "fmod": 4,
                "floor_divide": 4, "pow": 8, "exp": 8, "expm1": 8,
                "log": 8, "log1p": 8, "log2": 8, "log10": 8, "tanh": 8,
                "sigmoid": 8, "sqrt": 4, "rsqrt": 4, "cos": 8, "sin": 8,
                "clamp": 2, "clamp_min": 1, "clamp_max": 1, "clip": 2}

# Matrix products: 2 * M * N * K.
_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "mv", "addmv", "dot"}

# Reductions and scans: one flop per input element.
_REDUCE = {"sum", "mean", "prod", "amax", "amin", "max", "min", "any",
           "all", "argmax", "argmin", "cumsum", "cumprod", "logsumexp",
           "norm", "linalg_vector_norm", "std", "var", "count_nonzero",
           "nansum", "aminmax", "sort", "topk", "cummax", "cummin"}

# Copies, indexing, layout and factories: bytes, no flops.
_MOVE = {"_to_copy", "copy", "clone", "contiguous", "cat", "stack",
         "index", "index_select", "gather", "scatter", "scatter_add",
         "index_put", "index_add", "index_copy", "masked_scatter",
         "empty", "empty_like", "empty_strided", "zeros", "zeros_like",
         "ones", "ones_like", "full", "full_like", "new_empty",
         "new_zeros", "new_ones", "new_full", "arange", "linspace",
         "fill", "zero", "repeat", "flip", "roll", "constant_pad_nd",
         "reflection_pad1d", "reflection_pad2d", "replication_pad1d",
         "replication_pad2d", "narrow_copy", "slice_scatter",
         "select_scatter", "diagonal_scatter", "as_strided_scatter",
         "_unsafe_view", "lift_fresh", "lift_fresh_copy", "scalar_tensor",
         "nonzero", "masked_select", "take", "tril", "triu", "repeat_interleave",
         "resize", "set", "_local_scalar_dense", "equal", "unfold_copy",
         "view_copy", "permute_copy", "expand_copy", "alias_copy",
         "_unique2", "unique_consecutive", "unique_dim", "bincount",
         "histc", "randint", "rand", "randn", "randperm", "bernoulli",
         "normal", "uniform", "random"}


def op_base(name: str) -> str:
    """``aten::add_.Tensor`` -> ``add`` (in-place and out forms fold
    into the functional name)."""
    base = name.split("::")[-1].split(".")[0]
    return base[:-1] if base.endswith("_") and base != "_" else base


def op_flops(base: str, ins: list, outs: list) -> int:
    """Modeled flops of one dispatched op from its input and output
    tensors (``ins`` in argument order)."""
    if base in _MOVE:
        return 0
    if base in _MATMUL:
        mats = [t for t in ins if t.dim() >= 1]
        out = outs[0] if outs else None
        if out is None or len(mats) < 2:
            return 0
        # The contracted length: the last dim of the left operand.
        lhs = mats[-2] if base in ("addmm", "baddbmm", "addmv") else mats[0]
        return 2 * out.numel() * int(lhs.shape[-1])
    if base in _REDUCE:
        return ins[0].numel() if ins else 0
    return (outs[0].numel() if outs else 0) * _FLOP_WEIGHT.get(base, 1)


@dataclass
class CostFacts:
    """The modeled cost of one device program."""
    name: str
    flops: int = 0
    hbm_bytes: int = 0
    scan_depth: int = 0
    max_trip: int = 0
    n_whiles: int = 0
    unknown_trips: int = 0
    peak_live_bytes: int = 0
    input_bytes: int = 0
    output_bytes: int = 0
    output_sizes: tuple = ()       # per-result bytes
    ici_bytes: int = 0             # per-device link bytes (graftmesh)
    launches: int = 0              # device ops (kernels) dispatched

    @property
    def intensity(self) -> float:
        return self.flops / self.hbm_bytes if self.hbm_bytes else 0.0

    def roofline(self, machine: MachineModel) -> dict:
        t_compute = self.flops / machine.peak_flops
        t_memory = self.hbm_bytes / machine.hbm_bytes_per_s
        t_ici = (self.ici_bytes / machine.ici_bandwidth
                 if machine.ici_bandwidth else 0.0)
        t_seq = self.scan_depth * machine.seq_step_s
        # The launch floor adds to the time but is no bound class: the
        # class says what the work itself is limited by, as in the JAX
        # model.
        t_launch = self.launches * machine.launch_s
        if t_seq > max(t_compute, t_memory, t_ici):
            bound = "sequential"
        elif t_ici > max(t_compute, t_memory):
            bound = "ici"
        elif t_memory >= t_compute:
            bound = "memory"
        else:
            bound = "compute"
        return {"machine": machine.name,
                "time_s": max(t_compute, t_memory, t_ici) + t_seq
                + t_launch,
                "bound": bound,
                "intensity": round(self.intensity, 4),
                "ridge": round(machine.ridge(), 4),
                "fits_vmem": self.peak_live_bytes <= machine.vmem_bytes}

    def manifest_entry(self) -> dict:
        """The cost fingerprint joining ``.graftaudit-torch-manifest.json``
        (deviceaudit.manifest_from_facts)."""
        entry = {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                 "scan_depth": self.scan_depth,
                 "max_trip": self.max_trip,
                 "peak_live_bytes": self.peak_live_bytes,
                 "intensity": round(self.intensity, 4),
                 "launches": self.launches}
        if self.ici_bytes:
            # Only mesh programs carry link traffic; keeping the key off
            # single-device entries keeps them byte-stable.
            entry["ici_bytes"] = self.ici_bytes
        return entry

    def add(self, other: "CostFacts") -> None:
        """Fold a launch that runs after this program's work so far on
        the same stream: traffic, work and serial steps add."""
        self.flops += other.flops
        self.hbm_bytes += other.hbm_bytes
        self.scan_depth += other.scan_depth
        self.max_trip = max(self.max_trip, other.max_trip)
        self.launches += other.launches
        self.ici_bytes += other.ici_bytes


# --- workload-shape histogram (padding waste) ----------------------------

_HIST_LOCK = threading.Lock()
_BUCKET_HIST: dict = {}          # family -> {(real, padded): count}


def record_bucket(family: str, real: int, padded: int) -> None:
    """Record one launch: ``real`` live items in a launch shaped for
    ``padded``. Called from the codec's launch seams; a dict update
    under a module lock — no device work."""
    with _HIST_LOCK:
        cells = _BUCKET_HIST.setdefault(family, {})
        key = (int(real), int(padded))
        cells[key] = cells.get(key, 0) + 1


def bucket_histogram() -> dict:
    """Snapshot of the recorded workload-shape histogram."""
    with _HIST_LOCK:
        return {fam: dict(cells) for fam, cells in _BUCKET_HIST.items()}


def reset_histogram() -> None:
    with _HIST_LOCK:
        _BUCKET_HIST.clear()


def padding_waste(hist: dict) -> dict:
    """Fraction of modeled work spent on padding, per family: per-bucket
    occupancy plus the launch-weighted overall waste
    (1 - sum(real)/sum(padded))."""
    out = {}
    for family, cells in hist.items():
        buckets: dict = {}
        real_sum = padded_sum = launches = 0
        for (real, padded), count in cells.items():
            b = buckets.setdefault(padded, {"real": 0, "padded": 0,
                                            "launches": 0})
            b["real"] += real * count
            b["padded"] += padded * count
            b["launches"] += count
            real_sum += real * count
            padded_sum += padded * count
            launches += count
        for b in buckets.values():
            b["waste"] = (round(1.0 - b["real"] / b["padded"], 4)
                          if b["padded"] else 0.0)
        out[family] = {
            "launches": launches,
            "waste": (round(1.0 - real_sum / padded_sum, 4)
                      if padded_sum else 0.0),
            "buckets": {str(k): v for k, v in sorted(buckets.items())},
        }
    return out


# --- report assembly ------------------------------------------------------

def cost_report(all_facts: list, machine: MachineModel,
                hist: dict | None = None) -> dict:
    """The machine-readable ``--cost-report`` payload: per-program
    modeled cost + roofline for ``machine``, plus padding waste from the
    recorded (or provided) workload-shape histogram. A hand-written
    kernel that could not run here still reports its declared cost."""
    programs = {}
    for f in all_facts:
        c = getattr(f, "cost", f)
        if not isinstance(c, CostFacts):
            continue
        programs[c.name] = dict(c.manifest_entry(),
                                input_bytes=c.input_bytes,
                                output_bytes=c.output_bytes,
                                n_whiles=c.n_whiles,
                                unknown_trips=c.unknown_trips,
                                roofline=c.roofline(machine))
    hist = bucket_histogram() if hist is None else hist
    return {"machine": machine.name, "programs": programs,
            "padding": padding_waste(hist) if hist else {}}


def render_cost_line(c: CostFacts, machine: MachineModel) -> str:
    roof = c.roofline(machine)
    comms = (f"{c.ici_bytes / 1e6:.3g} MB link, " if c.ici_bytes
             else "")
    return (f"{c.name}: {c.flops / 1e6:.3g} MFLOP, "
            f"{c.hbm_bytes / 1e6:.3g} MB HBM, {comms}"
            f"{c.launches} launch(es), "
            f"intensity {roof['intensity']:.3g} flop/B, "
            f"scan depth {c.scan_depth}, {roof['bound']}-bound "
            f"({machine.name}: {roof['time_s'] * 1e6:.3g} us)")


# --- the calibration prediction ------------------------------------------

_PREDICTION_CACHE: dict = {}
_PREDICTION_LOCK = threading.Lock()


def tier1_prediction(device="cuda") -> dict:
    """Modeled fused Tier-1 decision throughput per machine model, from
    the registry's fused kernel entry (``cxdmq.fused.pallas/L2/N1``, one
    block at L=2): its declared work (kernels/fused_t1.py ``work``),
    rooflined per machine — the serial chain term covers the scan and
    the coder alike, since the kernel runs them side by side on the
    block's decisions. ``chip_smoke.py`` prints this beside the measured
    ns per decision: the calibration loop that keeps the machine numbers
    honest. Runs the entry once per process on ``device`` (the card
    unless the caller asks for the CPU, where the plain version gives
    the same outputs)."""
    with _PREDICTION_LOCK:
        if _PREDICTION_CACHE:
            return dict(_PREDICTION_CACHE)
    from . import deviceaudit

    entry = next(e for e in deviceaudit.registry()
                 if e.name.startswith("cxdmq.fused.pallas/"))
    facts = deviceaudit.run_program(entry, device)
    fused = facts.cost
    if fused is None or fused.flops <= 0:
        return {}
    out = {}
    for mname, machine in MACHINES.items():
        t = fused.roofline(machine)["time_s"]
        out[mname] = {"symbols_per_s": round(fused.flops / t, 1),
                      "modeled_block_s": round(t, 9),
                      "ns_per_decision": round(t / fused.flops * 1e9, 3)}
    with _PREDICTION_LOCK:
        _PREDICTION_CACHE.update(out)
    return dict(out)
