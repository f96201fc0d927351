"""The harness on the CPU: seeded traffic, the window's arithmetic, the
result line, the yardstick's counts, the names, the files found by name
and the import guard."""
from __future__ import annotations

import ast
import glob
import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest

from benchmark.harness import guard, images, roofline, spec, trace
from benchmark.harness.window import Window
from benchmark.tests.conftest import run_small

REPO = os.path.dirname(spec.HERE)
BIG_SEED = 2**31 + 12345


def test_seeded_images_repeat_and_differ():
    a = images.scan(BIG_SEED, 0, 48, 40, "cpu")
    b = images.scan(BIG_SEED, 0, 48, 40, "cpu")
    c = images.scan(BIG_SEED + 1, 0, 48, 40, "cpu")
    d = images.scan(BIG_SEED, 1, 48, 40, "cpu")
    assert a.shape == (48, 40, 3) and a.dtype == np.uint8
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c) and not np.array_equal(a, d)


def test_seed_streams_repeat_and_take_any_seed():
    assert images.seed_of(BIG_SEED, 2) == images.seed_of(BIG_SEED, 2)
    assert images.seed_of(BIG_SEED, 2) != images.seed_of(BIG_SEED, 3)
    for seed in (0, 1, 2**31 + 7, 2**40, -5):
        assert 0 <= images.seed_of(seed, 1) < 2**63


def test_iiif_positions_repeat(small_bench):
    """The same seed reads the same regions in the same order."""
    kinds = []
    for _ in range(2):
        rc, res, err = run_small(small_bench, "iiif-lossless-4k",
                                 seed=BIG_SEED, seconds=0.01,
                                 faults=kinds.append)
        assert rc == 0 and res["correct"], err
    regions = [[(r, reg) for r, reg, _ in k.reads] for k in kinds]
    assert regions[0] == regions[1] and len(regions[0]) == 3


def test_window_counts_all_work_over_all_time_with_drain():
    now = [100.0]
    w = Window(10.0, clock=lambda: now[0])
    w.open()
    starts = []
    while w.due():
        starts.append(now[0])
        now[0] += 4.0                   # each request takes 4 s
        w.add(starts[-1], now[0], pixels=2_000_000)
    w.close()
    # due at 0, 4 and 8 s: the third request runs past the 10 s mark and
    # the window waits for it
    assert len(w.ops) == 3
    assert w.span == pytest.approx(12.0)
    assert w.rate("pixels") == pytest.approx(6_000_000 / 12.0)
    assert w.per("pixels") == pytest.approx(12.0 / 6_000_000)


def test_window_is_not_a_median_of_chunks():
    w = Window(1.0, clock=lambda: 0.0)
    w.open()
    w.add(0.0, 1.0, reads=1)
    w.add(1.0, 10.0, reads=1)
    w.close()
    assert w.per("reads") == pytest.approx(5.0)    # a median would say 1


def test_last_line_has_the_keys(small_bench):
    rc, res, err = run_small(small_bench, "ingest-lossless-4k")
    assert rc == 0, err
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert set(res["metrics"]) == {"encode_mpix_s", "setup_s"}
    for m in res["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert res["checks"]["mismatch"] == {"value": 0, "limit": 0}
    last = err.strip().splitlines()[-1]
    assert last.startswith("check ") and " limit " in last


def test_least_bytes_by_hand():
    # 4096x4096 RGB: 50,331,648 coefficients as int32, plus 30 MB coded
    n = roofline.tier1_least_bytes(4096 * 4096, 3, 30_000_000)
    assert n == 4096 * 4096 * 3 * 4 + 30_000_000 == 231_326_592
    assert roofline.least_seconds(n) == pytest.approx(n / 3.35e12)
    assert roofline.least_seconds(3_350_000) == pytest.approx(1e-6)


def test_own_kernels_are_the_csrc_globals():
    names = trace.own_kernels(REPO)
    assert {"fused_t1_kernel", "cxd_scan_kernel", "mq_scan_kernel",
            "probe_kernel"} <= names
    assert trace.kernel_name("fused_t1_kernel(int const*, int)") == \
        "fused_t1_kernel"
    assert trace.kernel_name(
        "(anonymous namespace)::fused_t1_kernel(int const*, int const*)"
    ) == "fused_t1_kernel"
    assert trace.kernel_name(
        "void at::native::vectorized_elementwise_kernel<4, float>(int)"
    ) == "vectorized_elementwise_kernel"


def test_busy_merges_overlaps_and_gaps_are_labelled():
    total, merged = trace.busy([(0.0, 1.0), (0.5, 1.0), (3.0, 1.0)])
    assert total == pytest.approx(2.5) and merged == [[0.0, 1.5],
                                                      [3.0, 4.0]]
    acts = [("k", 0, 0.0, 1.0), ("k", 0, 3.0, 1.0)]
    s = trace.device_summary(acts, [0], 5.0, {"k"})
    assert s["busy_s"] == pytest.approx(2.0)
    assert s["own_kernel_s"] == pytest.approx(2.0)
    assert s["gaps"] == [(1.0, 3.0), (4.0, 5.0)]
    gaps = trace.label_gaps(s["gaps"], [("outer", 0.0, 5.0),
                                        ("inner", 1.5, 2.5)])
    assert gaps[0] == ["inner", pytest.approx(2.0)]
    assert gaps[1] == ["outer", pytest.approx(1.0)]


def test_names_and_units_use_the_allowed_characters():
    bench = spec.load(REPO)
    assert spec.names_ok(bench) == []
    assert spec.names_ok({"workloads": [{"name": "a b"}],
                          "end_to_end": [{"name": "x", "unit": "µs"}]}) \
        == ["workloads.name='a b'", "end_to_end.unit='µs'"]


def test_each_layer_metric_moves_a_metric_its_cells_report():
    bench = spec.load(REPO)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = [w["name"] for w in bench["workloads"]]
    for m in bench["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in moved.get("workloads", cells), (m["name"], cell)
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= 1


def test_configs_mixes_and_metrics_are_found_by_name():
    bench = spec.load(REPO)
    for c in bench["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert spec.config(c["name"])["name"] == c["name"]
        assert spec.config(c["name"])["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        kind = spec.traffic(w["traffic"])["kind"]
        assert spec.kind(kind).__module__.endswith("kinds_" + kind)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
    with pytest.raises(FileNotFoundError):
        spec.traffic("no-such-mix")
    with pytest.raises(FileNotFoundError):
        spec.kind("no_such_kind")
    with pytest.raises(ValueError):
        spec.kind("../harness/cell")


def test_a_new_kind_is_a_new_file(tmp_path):
    """A kind of traffic is found by its file's name, with no edit to a
    file that is there."""
    (tmp_path / "kinds").mkdir()
    (tmp_path / "kinds" / "open_loop.py").write_text(
        "from benchmark.harness import traffic\n"
        "class Kind(traffic.Base):\n"
        "    rate = 1.5\n")
    kind = spec.kind("open_loop", str(tmp_path))
    assert kind.rate == 1.5 and kind.__mro__[1].__name__ == "Base"


def test_a_gray16_configuration_needs_no_edit(small_bench, tmp_path):
    """A 16-bit grayscale configuration (BASELINE config 3's kind) is a
    new file and a new cell: the sources are made and written at its
    depth, the port converts them, and the check holds them exactly."""
    root = tmp_path / "b"
    shutil.copytree(small_bench, root)
    c = json.loads((root / "configs" / "kdu-lossless-rgb8-4096.json")
                   .read_text())
    c.update(name="kdu-lossless-gray16-256", components=1, bitdepth=16)
    (root / "configs" / "kdu-lossless-gray16-256.json").write_text(
        json.dumps(c))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "ingest-gray16", "config": c["name"],
                               "traffic": "single-closed-1src", "chips": 1,
                               "why": "16-bit grayscale lossless"})
    for m in bench["end_to_end"]:
        if m["name"] == "encode_mpix_s":
            m["workloads"].append("ingest-gray16")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    kinds = []
    rc, res, err = run_small(str(root), "ingest-gray16",
                             faults=kinds.append)
    assert rc == 0 and res["correct"], err
    assert res["checks"]["mismatch"]["value"] == 0
    assert kinds[0].sources[0][1].dtype == np.uint16
    assert "encode_mpix_s" in res["metrics"]


@pytest.mark.parametrize("components,bitdepth", [(3, 8), (1, 8), (1, 16)])
def test_sources_are_written_at_their_depth(tmp_path, components,
                                            bitdepth):
    """The port reads back every sample of each kind of source."""
    from bucketeer_tpu_torch.codec import tiff
    img = images.scan(BIG_SEED, 0, 40, 56, "cpu", components, bitdepth)
    assert img.shape == (40, 56, components)
    assert img.dtype == (np.uint8 if bitdepth == 8 else np.uint16)
    assert int(img.max()) > (1 << (bitdepth - 2))
    path = str(tmp_path / "s.tif")
    images.write_tiff(path, img)
    back, depth = tiff.read_image(path)
    assert depth == bitdepth
    assert np.array_equal(back.reshape(img.shape), img)


def _stream(side: int, tile: int, levels: int = 6, comps: int = 3):
    from benchmark.reference import j2k
    s = object.__new__(j2k.Stream)
    s.width = s.height = side
    s.tile_w = s.tile_h = tile
    s.n_tx = -(-side // tile)
    s.n_tiles = s.n_tx ** 2
    s.levels, s.n_comps, s.xcb, s.ycb = levels, comps, 6, 6
    return s


@pytest.mark.parametrize("side", [4096, 8192])
def test_blocks_are_drawn_over_every_tile_row_and_the_fine_levels(side):
    from benchmark.reference import judge
    stream = _stream(side, 512)
    picks = judge.sample_blocks(stream, np.random.default_rng(5), 48)
    whole = [t for t, keys in picks.items() if len(keys) >= 219]
    assert whole and len(picks[whole[0]]) == 219
    single = [(t, k) for t, keys in picks.items() for k in keys
              if t != whole[0] or len(keys) < 219]
    rows = {t // stream.n_tx for t, _ in single}
    assert rows == set(range(min(48, stream.n_tiles // stream.n_tx)))
    finest = sum(k[1] == stream.levels for _, k in single)
    assert finest >= 48 // 4


def test_the_trace_is_read_from_kineto_only():
    """No second way to read the device's activity: a profiler without
    kineto results is an error, not a fallback."""
    dt = object.__new__(trace.DeviceTrace)
    dt._prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=None))
    with pytest.raises(RuntimeError):
        dt.activities()


def test_guard_compares_whole_top_level_names():
    mods = ["bucketeer_tpu_torch", "bucketeer_tpu_torch.codec",
            "jaxlib.xla", "jax", "bucketeer_tpu.codec", "jaxtyping",
            "flax"]
    assert guard.jax_modules(mods) == ["bucketeer_tpu.codec", "flax",
                                       "jax", "jaxlib.xla"]


def _imports(path: str) -> set:
    tree = ast.parse(open(path, encoding="utf-8").read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_source_of_the_benchmark_imports_jax():
    files = glob.glob(os.path.join(spec.HERE, "**", "*.py"), recursive=True)
    assert files
    for path in files:
        assert not _imports(path) & guard.FORBIDDEN, path
        text = open(path, encoding="utf-8").read()
        for old in ("bench.py", "bench_gate", "BENCH_REF", "MULTICHIP_"):
            assert old not in text or path.endswith(
                "test_bench_harness.py"), (path, old)


def test_a_run_loads_no_jax():
    """In a fresh process: every harness module and metric reader
    imported, the port loaded, and no forbidden module in sys.modules."""
    code = (
        "import sys, glob, os\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from benchmark.harness import cell, guard, spec\n"
        "from benchmark.reference import judge, j2k, wavelet\n"
        "import bucketeer_tpu_torch.engine, bucketeer_tpu_torch.converters\n"
        "b = spec.load(os.path.dirname(spec.HERE))\n"
        "[spec.reader(m['name']) for m in b['end_to_end'] + b['per_layer']]\n"
        "print(guard.jax_modules(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_without_a_card_prints_no_result(small_bench):
    """The command itself refuses to run where CUDA is absent."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, os.path.join(spec.HERE, "run.py"), "--workload",
         "ingest-lossless-4k", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.card
def test_a_cell_on_the_card():
    """A short run of the first cell on the card: correct, with its
    metrics."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, os.path.join(spec.HERE, "run.py"), "--workload",
         "ingest-lossless-4k", "--seed", str(BIG_SEED), "--seconds", "3",
         "--trace", "0"], capture_output=True, text=True, timeout=600,
        cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert set(res["metrics"]) == {"encode_mpix_s", "setup_s"}
