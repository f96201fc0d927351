#!/usr/bin/env python3
"""Old against new: the Tier-1 kernels fused_t1, cxd_scan and mq_scan of
an earlier version of bucketeer_tpu_torch/csrc, timed in turns with the
current ones on one NVIDIA GPU, on the main path's real launch groups.

    python3 t1_ab.py OLD_CSRC [--kernels NAME ...] [--seed N] [--reps N]

OLD_CSRC is a directory holding the earlier fused_t1.cu, cxd_scan.cu,
mq_scan.cu and t1_common.cuh (the same C interfaces as now). Kept out
of the tree, for example:

    mkdir -p build/old
    for f in t1_common.cuh fused_t1.cu cxd_scan.cu mq_scan.cu; do
        git show <commit>:bucketeer_tpu_torch/csrc/$f > build/old/$f
    done
    python3 t1_ab.py build/old --kernels mq_scan

The script builds both versions of the kernels named (all three by
default; nvcc, one process per source, all at once, ptxas's register
and spill lines printed), forms chip_smoke.py's 4096x4096 image from
--seed and its groups as the fused path launches them: the largest
group of the first lossless chunk (L=8) and the largest lossy groups at
L=8 and L=16 (one lossy convert through CudaConverter, frac 7 and the
rate estimator's floors). mq_scan is fed the current cxd_scan's symbols,
counts and totals of each group, with the flags and budget the fused
kernel's coder has. On each group it requires old and new outputs to be
identical, then times each kernel in the order old, new, new, old (CUDA
events over --reps launches after a warm-up; for mq_scan the C launch
alone, since its wrapper's input check waits for the card), and the
serial chain of each version (the group's longest block launched alone)
with its ns per decision and launch / chain. Then torch.profiler traces
three calls of each current kernel's wrapper per group and prints what
the trace shows: the operations on the card, the kernel's own device
time, and the device's idle time inside the traced window. Last, each current kernel runs every second
and every fourth block of the group alone, so that each SM holds a half
and a quarter of the code-blocks: launch / chain against the number of
code-blocks per SM. It exits non-zero without a result when no
CUDA device is present.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import chip_smoke as smoke

KERNELS = ("fused_t1", "cxd_scan", "mq_scan")


def old_library(module, old_dir: str):
    """The earlier version of ``module``'s kernel as a Library under the
    same name, so the wrapper's ``launch`` finds its entry point."""
    from bucketeer_tpu_torch.kernels.build import Library

    name = module.KERNEL.name
    sources = tuple(os.path.abspath(os.path.join(old_dir, f))
                    for f in (f"{name}.cu", "t1_common.cuh"))
    return Library(name, sources, module.KERNEL.functions)


def modules():
    from bucketeer_tpu_torch.kernels import cxd_scan, fused_t1, mq_scan

    return {"fused_t1": fused_t1, "cxd_scan": cxd_scan, "mq_scan": mq_scan}


def build(old_dir: str, kernels) -> dict:
    """{(kernel, "old" | "new"): Library}, built all at once."""
    libs = {}
    for name in kernels:
        mod = modules()[name]
        libs[(name, "new")] = mod.KERNEL
        libs[(name, "old")] = old_library(mod, old_dir)
    with ThreadPoolExecutor(max_workers=len(libs)) as pool:
        list(pool.map(lambda lib: lib.build(), libs.values()))
    for (name, which), lib in libs.items():
        lib.library()
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line:
                smoke.say(f"build: {name} {which} ptxas: {line.strip()}")
    return libs


def run(libs: dict, name: str, which: str, L: int, frac: int, args):
    """One launch of kernel ``name`` in version ``which``; ``args`` are
    the group's inputs of that kernel (kernel_inputs)."""
    mod = modules()[name]
    saved = mod.KERNEL
    mod.KERNEL = libs[(name, which)]
    try:
        if name == "mq_scan":
            return mod.mq_scan(L, *smoke.mq_budget(L), *args)
        return getattr(mod, name)(L, frac, *args)
    finally:
        mod.KERNEL = saved


def launcher(libs: dict, name: str, which: str, L: int, frac: int, args):
    """A callable that launches kernel ``name`` in version ``which`` once,
    for timing. mq_scan's wrapper checks its inputs by a reduction on
    the card that the host waits for, so its outputs are allocated and
    its inputs checked once here, and each call is the C launch alone."""
    if name != "mq_scan":
        return lambda: run(libs, name, which, L, frac, args)
    mod = modules()[name]
    out = run(libs, name, which, L, frac, args)
    cap = smoke.mq_budget(L)[1]

    def one_launch():
        saved = mod.KERNEL
        mod.KERNEL = libs[(name, which)]
        try:
            mod.launch_mq(L, cap, *args, out)
        finally:
            mod.KERNEL = saved
    return one_launch


def kernel_inputs(L: int, frac: int, args) -> dict:
    """Each kernel's inputs on one launch group: the group's blocks for
    the scans; for mq_scan the current cxd_scan's symbols, counts and
    totals, and the flags of the fused kernel's coder."""
    from bucketeer_tpu_torch.kernels import cxd_scan

    scan = cxd_scan.cxd_scan(L, frac, *args)
    return {"fused_t1": args, "cxd_scan": args,
            "mq_scan": (scan[0], scan[1], scan[4], smoke.flags_of(args))}


def decisions(name: str, args, out):
    """Per block of a launch: its MQ decisions (fused_t1, mq_scan) or
    symbols (cxd_scan)."""
    if name == "fused_t1":
        return out[5]
    return args[2] if name == "mq_scan" else out[4]


def identical(name: str, L: int, new, old) -> float:
    if name == "fused_t1":
        return smoke.compare_fused(L, new, old)
    if name == "cxd_scan":
        return smoke.compare_scan(new, old)
    return smoke.compare_mq(new, old)


def lossy_groups(img) -> dict:
    """The fused lossy convert's largest launch group at each L."""
    from bucketeer_tpu_torch.codec import cxd
    from bucketeer_tpu_torch.converters import Conversion, CudaConverter

    workdir = tempfile.mkdtemp(prefix="t1-ab-")
    os.environ["BUCKETEER_TMPDIR"] = workdir
    src = os.path.join(workdir, "ab.tif")
    smoke.write_tiff(src, img)
    real = cxd.fused_t1
    capture = cxd.fused_t1 = smoke.GroupCapture(real)
    try:
        CudaConverter().convert("t1-ab-lossy", src, Conversion.LOSSY)
        torch.cuda.synchronize()
    finally:
        cxd.fused_t1 = real
        shutil.rmtree(workdir, ignore_errors=True)
    return capture.groups


def compare(libs: dict, kernels, label: str, L: int, frac: int, inputs,
            reps: int) -> dict:
    """Old against new on one group: identical outputs, then times in
    turns and both chains. Returns the numbers per kernel."""
    out = {}
    for name in kernels:
        args = inputs[name]
        n = args[0].shape[0]
        old = run(libs, name, "old", L, frac, args)
        new = run(libs, name, "new", L, frac, args)
        torch.cuda.synchronize()
        err = identical(name, L, new, old)
        cur = decisions(name, args, old)
        if err != 0:
            smoke.fail(f"{name} {label} L={L}: new outputs differ from old")
        times = {"old": [], "new": []}
        for which in ("old", "new", "new", "old"):
            times[which].append(smoke.time_kernel(
                launcher(libs, name, which, L, frac, args), reps))
        b = int(torch.argmax(cur))
        one = [a[b:b + 1].contiguous() for a in args]
        chain = {w: smoke.time_kernel(
            launcher(libs, name, w, L, frac, one), reps)
            for w in ("old", "new")}
        n_dec = int(cur[b])
        row = {"blocks": n, "decisions": int(cur.to(torch.int64).sum()),
               "longest_block_decisions": n_dec}
        for w in ("old", "new"):
            ms = sum(times[w]) / 2
            row[w] = {"ms": times[w], "chain_ms": chain[w],
                      "ns_per_decision": chain[w] * 1e6 / max(n_dec, 1),
                      "launch_over_chain": ms / chain[w]}
        smoke.say(
            f"ab: {name} {label} L={L} {n} blocks: old "
            f"{times['old'][0]:.3f}, new {times['new'][0]:.3f}, new "
            f"{times['new'][1]:.3f}, old {times['old'][1]:.3f} ms/launch; "
            f"chain ({n_dec} decisions) old {chain['old']:.3f} ms "
            f"({row['old']['ns_per_decision']:.1f} ns/decision), new "
            f"{chain['new']:.3f} ms ({row['new']['ns_per_decision']:.1f} "
            f"ns/decision); launch/chain old "
            f"{row['old']['launch_over_chain']:.2f}, new "
            f"{row['new']['launch_over_chain']:.2f}; outputs identical")
        out[name] = row
    return out


def trace(libs: dict, kernels, label: str, L: int, frac: int,
          inputs) -> dict:
    """torch.profiler over three launches of each current kernel: the
    operations the trace shows on the card (mq_scan's wrapper adds the
    reduction and copy of its totals check), the kernel's own mean
    device time, and the idle time between the first operation's start
    and the last one's end."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name in kernels:
        args = inputs[name]
        run(libs, name, "new", L, frac, args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                run(libs, name, "new", L, frac, args)
            torch.cuda.synchronize()
        kern = sorted((e for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA),
                      key=lambda e: e.time_range.start)
        if not kern:
            smoke.say(f"trace: {name} {label} L={L}: the profiler shows no "
                      "device time")
            continue
        busy = sum(e.time_range.elapsed_us() for e in kern)
        span = kern[-1].time_range.end - kern[0].time_range.start
        own = [e.time_range.elapsed_us() for e in kern
               if f"{name}_kernel" in e.name]
        names = sorted({e.name.split("(")[0] for e in kern})
        out[name] = {"operations": names, "events": len(kern),
                     "kernel_ms": sum(own) / max(len(own), 1) / 1e3,
                     "kernel_events": len(own),
                     "idle_ms": (span - busy) / 1e3}
        smoke.say(f"trace: {name} {label} L={L}: {len(kern)} device events "
                  f"({', '.join(names)}); the kernel "
                  f"{out[name]['kernel_ms']:.3f} ms each over {len(own)}; "
                  f"idle {(span - busy) / 1e3:.3f} ms of a "
                  f"{span / 1e3:.3f} ms window")
    return out


def thinned(libs: dict, kernels, label: str, L: int, frac: int, inputs,
            reps: int) -> dict:
    """Launch / chain of each current kernel on every k-th block of the
    group (k = 1, 2, 4): fewer code-blocks share each SM."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for name in kernels:
        rows = []
        for k in (1, 2, 4):
            sub = [a[::k].contiguous() for a in inputs[name]]
            res = run(libs, name, "new", L, frac, sub)
            cur = decisions(name, sub, res)
            b = int(torch.argmax(cur))
            one = [a[b:b + 1].contiguous() for a in sub]
            ms = smoke.time_kernel(
                launcher(libs, name, "new", L, frac, sub), reps)
            chain = smoke.time_kernel(
                launcher(libs, name, "new", L, frac, one), reps)
            n = sub[0].shape[0]
            rows.append({"every": k, "blocks": n, "per_sm": n / sms,
                         "ms": ms, "chain_ms": chain})
            smoke.say(f"thinned: {name} {label} L={L} every {k}th block: "
                      f"{n} blocks ({n / sms:.1f} per SM), {ms:.3f} ms, "
                      f"chain {chain:.3f} ms, launch/chain "
                      f"{ms / chain:.2f}")
        out[name] = rows
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old_csrc")
    ap.add_argument("--kernels", nargs="+", choices=KERNELS,
                    default=list(KERNELS))
    ap.add_argument("--seed", type=int, default=20261016)
    ap.add_argument("--reps", type=int, default=5)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        smoke.fail("torch.cuda.is_available() is false: no CUDA device")
    card = smoke.phase_card()
    libs = build(a.old_csrc, a.kernels)
    from bucketeer_tpu_torch.kernels.build import resident_blocks

    for name in a.kernels:
        for which in ("old", "new"):
            smoke.say(f"residency: {name} {which}, thread blocks per SM at "
                      "L 8 / 16: " + " / ".join(
                          str(resident_blocks(libs[(name, which)], L))
                          for L in (8, 16)))
    rng = np.random.default_rng(a.seed)
    img = smoke.photo(rng, smoke.SIZE, smoke.SIZE)
    L, _, args = max(smoke.first_chunk_groups(img), key=lambda g: len(g[1]))
    groups = [("lossless", L, 0, args)]
    for L, (frac, group) in sorted(lossy_groups(img).items()):
        if L in (8, 16):
            groups.append(("lossy", L, frac, group))
    result = {"card": card, "groups": []}
    for label, L, frac, args in groups:
        inputs = kernel_inputs(L, frac, args)
        row = compare(libs, a.kernels, label, L, frac, inputs, a.reps)
        row["trace"] = trace(libs, a.kernels, label, L, frac, inputs)
        row["thinned"] = thinned(libs, a.kernels, label, L, frac, inputs,
                                 a.reps)
        result["groups"].append({"label": label, "L": L, **row})
    smoke.say(json.dumps(result))


if __name__ == "__main__":
    sys.exit(main())
