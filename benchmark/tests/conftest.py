"""Fixtures: a small copy of the benchmark that runs on the CPU."""
from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import time
import types

import pytest

from benchmark.harness import cell, spec

SMALL = 256          # image side of the small copies (one 256x256 tile)
MAP_SMALL = 320      # the map cell's: one tile whose bands straddle the grid


@pytest.fixture(scope="session")
def small_bench(tmp_path_factory):
    """A BENCHMARK.json, configurations and mixes like the real ones at a
    size the CPU runs in seconds; every cell on one chip."""
    root = tmp_path_factory.mktemp("bench")
    for kind in ("configs", "traffic", "kinds", "metrics"):
        shutil.copytree(os.path.join(spec.HERE, kind), root / kind)
    for path in (root / "configs").iterdir():
        c = json.loads(path.read_text())
        side = MAP_SMALL if "8192" in path.name else SMALL
        c["image_rows"] = c["image_columns"] = side
        path.write_text(json.dumps(c))
    mix = json.loads((root / "traffic" / "iiif-cold-cycle.json").read_text())
    mix["grid"] = 64
    mix["reads"] = [{"reduce": 2}, {"reduce": 0, "region": 64},
                    {"reduce": 1, "region": 128}]
    mix["warm"] = mix["reads"][:2]
    (root / "traffic" / "iiif-cold-cycle.json").write_text(json.dumps(mix))
    bench = spec.load(os.path.dirname(spec.HERE))
    for w in bench["workloads"]:
        w["chips"] = 1
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(root)


@contextlib.contextmanager
def sized(root: str, workload: str, side: int, **mix):
    """The small copy's ``workload`` with its images ``side`` square and
    the keys of ``mix`` that its mix has set as given, for the duration."""
    bench = spec.load(root)
    cell_ = spec.workload(bench, workload)
    paths = [os.path.join(root, "configs", cell_["config"] + ".json"),
             os.path.join(root, "traffic", cell_["traffic"] + ".json")]
    saved = [open(p).read() for p in paths]
    c, m = (json.loads(t) for t in saved)
    c["image_rows"] = c["image_columns"] = side
    m.update({k: v for k, v in mix.items() if k in m})
    for path, obj in zip(paths, (c, m)):
        with open(path, "w") as fh:
            json.dump(obj, fh)
    try:
        yield
    finally:
        for path, text in zip(paths, saved):
            with open(path, "w") as fh:
                fh.write(text)


def run_small(root: str, workload: str, seed: int = 2**31 + 11,
              seconds: float = 1.0, trace: int = 0, faults=None,
              control: int = 0) -> tuple:
    """Run a cell of the small copy on the CPU; (rc, result, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    args = types.SimpleNamespace(workload=workload, seed=seed,
                                 seconds=seconds, trace=trace,
                                 control=control)
    rc = cell.run(args, time.perf_counter(), device="cpu", root=root,
                  base=root, out=out, err=err, faults=faults)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
