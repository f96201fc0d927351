"""One run of one cell: set-up, the measured window, the checks against
the reference, and the result line."""
from __future__ import annotations

import asyncio
import json
import os
import shutil
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np

from . import guard, images, spec, trace
from .window import Window

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def limits(config: dict, mix: dict) -> dict:
    """{number: limit} compared in the cell: the configuration's (what
    its files must hold) and the mix's (its guarantees)."""
    return {**config["limits"], **mix["limits"]}


def verdict(readings: dict, lim: dict) -> tuple:
    """(correct, [(name, number, limit)]): every number compared is at or
    under its limit; a number the run could not read fails."""
    rows = []
    ok = True
    for name, limit in lim.items():
        value = readings.get(name)
        rows.append((name, value, limit))
        if value is None or value > limit:
            ok = False
    if readings.get("unreadable"):
        rows.append(("unreadable", readings["unreadable"], 0))
        ok = False
    return ok, rows


def run(args, t_start: float, device: str = "cuda", root: str = ROOT,
        base: str = spec.HERE, out=None, err=None, faults=None) -> int:
    """Run the cell ``args.workload`` of ``root``'s BENCHMARK.json once,
    with the configurations, mixes and metrics under ``base``; print its
    result line. ``device`` and ``faults`` (a function that breaks the
    timed path after set-up) are for the tests, which run on the CPU."""
    out = out or sys.stdout
    err = err or sys.stderr
    bench = spec.load(root)
    cell = spec.workload(bench, args.workload)
    config = spec.config(cell["config"], base)
    mix = spec.traffic(cell["traffic"], base)
    chips = cell["chips"]

    import torch
    if device == "cuda":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            print(f"run: the cell needs {chips} CUDA device(s); "
                  f"available: {torch.cuda.is_available()}, count: "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=err)
            return 2
    workdir = tempfile.mkdtemp(prefix=f"bench-{args.workload}-")
    os.environ["BUCKETEER_TMPDIR"] = workdir
    try:
        return _run(args, t_start, device, root, base, out, err, bench,
                    cell, config, mix, chips, workdir, faults)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _run(args, t_start, device, root, base, out, err, bench, cell, config,
         mix, chips, workdir, faults) -> int:
    import torch

    from bucketeer_tpu_torch import obs

    obs.maybe_install()
    sink = trace.Sink() if args.trace else None
    devices = list(range(chips)) if device == "cuda" else []
    ctx = SimpleNamespace(seed=args.seed, device=device, workdir=workdir,
                          gen_device=("cuda:0" if device == "cuda"
                                      else "cpu"),
                          sink=sink)
    kind = spec.kind(mix["kind"], base)(ctx, mix, config)
    window = Window(args.seconds)
    prof = None

    async def body():
        nonlocal prof
        await kind.setup()
        if faults is not None:
            faults(kind)
        for d in devices:
            torch.cuda.synchronize(d)
            torch.cuda.reset_peak_memory_stats(d)
        setup_s = time.perf_counter() - t_start
        if args.trace:
            trace.install_sink(sink)
            if devices:
                prof = trace.DeviceTrace().__enter__()
        mono0 = time.monotonic()
        window.open()
        await kind.run(window)
        window.close()
        if prof is not None:
            prof.__exit__(None, None, None)
        if args.trace:
            trace.install_sink(None)
        await kind.close()
        return setup_s, mono0

    setup_s, mono0 = asyncio.run(body())
    peak = max((torch.cuda.max_memory_allocated(d) for d in devices),
               default=0)
    rec = obs.get_recorder()
    spans = [s for s in (rec.snapshot() if rec is not None else [])
             if s.get("dur") is not None and s["t0"] >= mono0]
    # What the metric readers read (benchmark/README.md).
    run_ = SimpleNamespace(
        window=window, window_s=window.span, setup_s=setup_s, spans=spans,
        stages=sink.stages if sink else {}, device=None, objects=[])

    dev_info = {"platform": "gpu" if devices else device,
                "kind": (torch.cuda.get_device_name(0) if devices
                         else device),
                "count": chips, "memory_peak_bytes": int(peak)}
    breakdown = None
    if prof is not None:
        summary = trace.device_summary(prof.activities(), devices,
                                       window.span, trace.own_kernels(root))
        run_.device = summary
        dev_info["busy_s"] = summary["busy_s"]
        dev_info["window_s"] = summary["window_s"]
        host = [(s["name"], s["t0"] - mono0, s["t0"] - mono0 + s["dur"])
                for s in spans]
        host += [("bench." + mix["kind"], op["start"] - window.t0,
                  op["end"] - window.t0) for op in window.ops]
        top = sorted(summary["by_name"].items(), key=lambda kv: -kv[1])
        breakdown = {"device_ops": [[n[:160], s] for n, s in top[:10]],
                     "idle_gaps": trace.label_gaps(summary["gaps"], host)}

    rng = np.random.default_rng(images.seed_of(args.seed, 4))
    control = bool(getattr(args, "control", 0))
    t_check = time.perf_counter()
    readings = kind.check(rng, control=control)
    t_check = time.perf_counter() - t_check
    run_.objects = getattr(kind, "landed_bytes", [])
    lim = limits(config, mix)
    correct, rows = verdict(
        {k: v for k, v in readings.items() if not k.startswith("control.")},
        lim)

    metrics = {}
    for m in spec.metrics(bench, cell["name"], bool(args.trace)):
        value = spec.reader(m["name"], base)(run_)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    found = guard.jax_modules(sys.modules)
    if found:
        print(f"run: JAX or the JAX package was loaded: {found}", file=err)
        return 3
    attempted = int(window.total("images") or window.total("reads"))
    failed = int(readings.get("missing", readings.get("unresolved", 0)))
    written = sum(os.path.getsize(os.path.join(d, f))
                  for d, _, files in os.walk(workdir) for f in files)
    written += sum(n for _, _, n in run_.objects)
    print(f"disk: about {written} bytes written (sources, derivatives and "
          "their bucket copies)", file=err)
    print("requests: " + " ".join(f"{op['end'] - op['start']:.3f}"
                                  for op in window.ops), file=err)
    if readings.get("why"):
        print(f"unreadable: {readings['why'][:3]}", file=err)
    print(f"check: {t_check:.3f} s, {readings.get('blocks', 0)} blocks, "
          f"{readings.get('samples', 0)} samples", file=err)
    if control:
        # The control in the program's place, through the same verdict:
        # it replaces the readings it has, the rest stay the program's.
        swapped = {**readings, **{k[8:]: v for k, v in readings.items()
                                  if k.startswith("control.")}}
        ctrl_ok, ctrl_rows = verdict(swapped, lim)
        for name, value, limit in ctrl_rows:
            print(f"control {name} {value} limit {limit}", file=err)
        print(f"control correct {ctrl_ok}", file=err)
    for name, value, limit in rows:
        print(f"check {name} {value} limit {limit}", file=err)
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in rows}
    print(json.dumps(result), file=out, flush=True)
    return 0
