"""The port's cost model (bucketeer_tpu_torch/analysis/graftcost.py,
rules_perf.py, obs/cost.py and the manifest of deviceaudit.py), held to
the JAX package where both compute the same thing and ported case by
case from tests/test_graftcost.py where the JAX cases do not parse
StableHLO: the recorder's op model is exact on tiny eager programs, the
registry's 17 programs all model, padding waste follows a histogram, the
perf rules fire on today's offenders (and only through the baseline),
the manifest drift gate catches doubled modeled traffic, and each kernel
wrapper's declared work is the count chip_smoke.py's bounds used.

The registry runs once per module (~20 s on the CPU)."""
import copy
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from bucketeer_tpu.analysis import graftcost as jax_cost
from bucketeer_tpu.analysis import rules_perf as jax_rules
from bucketeer_tpu_torch.analysis import deviceaudit, graftcost, rules_perf
from bucketeer_tpu_torch.analysis.__main__ import main as cli_main
from bucketeer_tpu_torch.obs import cost as obs_cost

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "bucketeer_tpu_torch"
BASELINE = REPO / ".graftlint-torch-baseline.json"
MANIFEST = REPO / ".graftaudit-torch-manifest.json"
JAX_MANIFEST = REPO / ".graftaudit-manifest.json"


@pytest.fixture(scope="module")
def repo_facts():
    return deviceaudit.run_programs("cpu")


@pytest.fixture()
def cached_run(repo_facts, monkeypatch):
    """Replay the module's registry run in the CLI (the CLI tests check
    argument handling and gating, not the run itself)."""
    def replay(device="cuda"):
        assert device == "cpu"
        return copy.deepcopy(repo_facts)

    monkeypatch.setattr(deviceaudit, "run_programs", replay)
    return repo_facts


def _cost_of(fn, *args):
    _, facts = deviceaudit.audit_call(fn, *args, audit_device="cpu",
                                      audit_cost=True)
    return facts.cost


# --- the op model on hand-written eager programs -----------------------

def test_single_mm_flops_and_bytes_are_exact():
    """(8,16) @ (16,4) float32: 2*M*N*K = 1024 flops; bytes = both
    inputs read + the output written = 512 + 256 + 128; one launch."""
    x, w = torch.ones(8, 16), torch.ones(16, 4)
    c = _cost_of(lambda: x @ w)
    assert c.flops == 2 * 8 * 4 * 16
    assert c.hbm_bytes == 8 * 16 * 4 + 16 * 4 * 4 + 8 * 4 * 4
    assert c.launches == 1 and c.scan_depth == 0
    assert c.input_bytes == 8 * 16 * 4 + 16 * 4 * 4
    assert c.output_bytes == 8 * 4 * 4 and c.output_sizes == (128,)


def test_eager_elementwise_chain_materializes_each_op():
    """(x + 1) * (x + 1) on (4,4) float32 is three eager ops, each
    reading its inputs and writing its output once (the JAX model fuses
    them; eager PyTorch runs one kernel per op): 64+64, 64+64, 128+64."""
    x = torch.ones(4, 4)
    c = _cost_of(lambda: (x + 1) * (x + 1))
    assert c.launches == 3
    assert c.hbm_bytes == 128 + 128 + 192
    assert c.flops == 16 * 3


def test_matmul_then_add_counts_the_intermediate_twice():
    """y = x @ w then y + 1: y is written by mm and re-read by the add
    — on top of mm's reads and the final write."""
    x, w = torch.ones(8, 16), torch.ones(16, 4)
    c = _cost_of(lambda: (x @ w) + 1.0)
    y = 8 * 4 * 4
    assert c.hbm_bytes == 8 * 16 * 4 + 16 * 4 * 4 + y + y + y
    assert c.flops == 2 * 8 * 4 * 16 + 32


def test_reduction_counts_input_elements():
    """sum(x + x): the add reads x twice and writes once, the sum reads
    the intermediate and writes a scalar; flops = 1024 + 1024."""
    x = torch.ones(32, 32)
    c = _cost_of(lambda: torch.sum(x + x))
    n = 32 * 32 * 4
    assert c.hbm_bytes == 3 * n + n + 4
    assert c.flops == 1024 + 1024


def test_views_move_nothing_and_launch_nothing():
    x = torch.ones(8, 8)
    c = _cost_of(lambda: x.view(64)[:16])
    assert c.launches == 0 and c.hbm_bytes == 0 and c.flops == 0


def test_peak_live_bytes_follow_storages():
    """Three (256,) float32 temporaries alive at once over the 1 KiB
    input: peak 4 KiB; a chain that frees as it goes peaks lower."""
    x = torch.ones(256)

    def held():
        a, b, c = x + 1, x + 2, x + 3
        return a + b + c

    def chained():
        y = x + 1
        y = y + 1
        return y + 1

    assert _cost_of(held).peak_live_bytes >= 5 * 1024
    assert _cost_of(chained).peak_live_bytes <= 3 * 1024


def test_op_flop_weights_are_the_jax_weights():
    """The aten names of the JAX model's weighted ops carry its
    weights."""
    pairs = {"div": "divide", "remainder": "remainder", "pow": "power",
             "exp": "exponential", "log": "log", "tanh": "tanh",
             "sigmoid": "logistic", "sqrt": "sqrt", "rsqrt": "rsqrt",
             "cos": "cosine", "sin": "sine", "clamp": "clamp"}
    for aten, hlo in pairs.items():
        assert graftcost._FLOP_WEIGHT[aten] == jax_cost._FLOP_WEIGHT[hlo]


# --- machines and the roofline -----------------------------------------

def test_roofline_classification_and_machine_table():
    mem = graftcost.CostFacts("m", flops=10, hbm_bytes=10 ** 9)
    cpu = graftcost.MACHINES["cpu"]
    h100 = graftcost.MACHINES["h100"]
    assert mem.roofline(cpu)["bound"] == "memory"
    comp = graftcost.CostFacts("c", flops=10 ** 15, hbm_bytes=8)
    assert comp.roofline(h100)["bound"] == "compute"
    seq = graftcost.CostFacts("s", flops=8, hbm_bytes=8,
                              scan_depth=10 ** 6)
    assert seq.roofline(h100)["bound"] == "sequential"
    for m in (cpu, h100):
        assert 0.5 < m.ridge() < 100
    assert graftcost.DEFAULT_MACHINE == "h100"
    assert set(graftcost.MACHINES) == {"h100", "cpu"}
    # The card's published rates and its measured floors.
    assert (h100.peak_flops, h100.hbm_bytes_per_s) == (67.0e12, 3.35e12)
    assert (h100.ici_bandwidth, h100.n_devices) == (450.0e9, 4)
    assert h100.launch_s == 1.08e-6


def test_launches_add_their_floor_to_the_time():
    h100 = graftcost.MACHINES["h100"]
    base = graftcost.CostFacts("a", flops=1, hbm_bytes=1000)
    more = graftcost.CostFacts("b", flops=1, hbm_bytes=1000, launches=10)
    assert more.roofline(h100)["time_s"] == pytest.approx(
        base.roofline(h100)["time_s"] + 10 * h100.launch_s)
    assert more.roofline(h100)["bound"] == "memory"


def test_vmem_fit_flag():
    h100 = graftcost.MACHINES["h100"]
    small = graftcost.CostFacts("a", flops=1, hbm_bytes=1,
                                peak_live_bytes=1024)
    big = graftcost.CostFacts("b", flops=1, hbm_bytes=1,
                              peak_live_bytes=h100.vmem_bytes + 1)
    assert small.roofline(h100)["fits_vmem"]
    assert not big.roofline(h100)["fits_vmem"]


def test_machine_follows_the_launch_device():
    assert graftcost.machine_for("cpu").name == "cpu"
    assert graftcost.machine_for(torch.device("cpu")).name == "cpu"
    assert graftcost.machine_for("cuda:1").name == "h100"
    assert graftcost.machine_for(torch.device("cuda", 0)).name == "h100"


_counts = st.integers(min_value=0, max_value=10 ** 12)


@settings(max_examples=60, deadline=None)
@given(flops=_counts, hbm=_counts, depth=st.integers(0, 10 ** 7),
       ici=_counts, live=_counts)
def test_cpu_roofline_equals_jax_on_the_same_facts(flops, hbm, depth, ici,
                                                    live):
    mine = graftcost.CostFacts("p", flops=flops, hbm_bytes=hbm,
                               scan_depth=depth, ici_bytes=ici,
                               peak_live_bytes=live)
    theirs = jax_cost.CostFacts("p", flops=flops, hbm_bytes=hbm,
                                scan_depth=depth, ici_bytes=ici,
                                peak_live_bytes=live)
    assert mine.roofline(graftcost.MACHINES["cpu"]) == theirs.roofline(
        jax_cost.MACHINES["cpu"])


# --- padding waste -------------------------------------------------------

def test_padding_waste_weighted_by_histogram():
    hist = {"cxd.blocks": {(3, 8): 2, (8, 8): 1},
            "frontend.batch": {(1, 1): 4}}
    waste = graftcost.padding_waste(hist)
    blocks = waste["cxd.blocks"]
    assert blocks["waste"] == round(1 - 14 / 24, 4)
    assert blocks["launches"] == 3
    assert blocks["buckets"]["8"]["waste"] == round(1 - 14 / 24, 4)
    assert waste["frontend.batch"]["waste"] == 0.0


_cells = st.dictionaries(
    st.tuples(st.integers(0, 64), st.integers(1, 64)).filter(
        lambda rp: rp[0] <= rp[1]),
    st.integers(1, 50), max_size=8)


@settings(max_examples=80, deadline=None)
@given(hist=st.dictionaries(st.sampled_from(
    ["frontend.batch", "transform.batch", "cxd.blocks", "cxd.planes",
     "decode.batch"]), _cells, max_size=5))
def test_padding_waste_equals_jax(hist):
    assert graftcost.padding_waste(hist) == jax_cost.padding_waste(hist)


def test_record_bucket_seam_roundtrip():
    graftcost.reset_histogram()
    try:
        graftcost.record_bucket("t", 3, 4)
        graftcost.record_bucket("t", 3, 4)
        graftcost.record_bucket("t", 4, 4)
        hist = graftcost.bucket_histogram()
        assert hist == {"t": {(3, 4): 2, (4, 4): 1}}
        assert graftcost.padding_waste(hist)["t"]["waste"] == round(
            1 - 10 / 12, 4)
    finally:
        graftcost.reset_histogram()


def test_encodes_record_the_jax_families():
    """The codec seams fire: a default CPU encode records the front-end
    batch, a fused-path encode the Tier-1 launch groups (blocks unpadded,
    each group's realized plane depth within its budget L)."""
    from bucketeer_tpu_torch.codec import encoder
    from bucketeer_tpu_torch.codec.encoder import EncodeParams

    graftcost.reset_histogram()
    try:
        img = np.random.default_rng(3).integers(
            0, 255, (64, 64), dtype=np.uint8)
        encoder.encode_jp2(img, 8, EncodeParams(lossless=True),
                           device="cpu")
        flat = np.full((16, 16), 128, np.uint8)
        flat[4:8, 4:8] = 129
        encoder.encode_jp2(flat, 8, EncodeParams(lossless=True,
                                                 device_mq=True),
                           device="cpu")
        hist = graftcost.bucket_histogram()
        assert {"frontend.batch", "cxd.blocks", "cxd.planes"} <= set(hist)
        for fam in ("frontend.batch", "cxd.blocks"):
            assert all(real == padded for real, padded in hist[fam])
        assert all(0 < depth <= L for depth, L in hist["cxd.planes"])
        assert {L for _, L in hist["cxd.planes"]} <= {8, 16, 32}
    finally:
        graftcost.reset_histogram()


# --- the kernels' declared work ---------------------------------------------

def _group(n=5, seed=11):
    rng = np.random.default_rng(seed)
    blocks = np.zeros((n, 64, 64), np.int32)
    hs = rng.integers(1, 9, n).astype(np.int32)
    ws = rng.integers(1, 9, n).astype(np.int32)
    for i in range(n):
        blocks[i, :hs[i], :ws[i]] = rng.integers(-3, 4, (hs[i], ws[i]))
    meta = [np.full(n, 2, np.int32), np.zeros(n, np.int32),
            rng.integers(0, 3, n).astype(np.int32), hs, ws]
    return [torch.from_numpy(blocks)] + [torch.from_numpy(m) for m in meta]


def test_kernel_work_is_the_chip_smoke_bound_arithmetic():
    """Each wrapper's work() counts what chip_smoke.py's bounds counted
    before they read it (the arithmetic below, kept here as the
    reference), on a synthetic launch group; the script's bound
    functions now read work()."""
    import chip_smoke
    from bucketeer_tpu_torch.kernels import cxd_scan as cs
    from bucketeer_tpu_torch.kernels import fused_t1 as ft
    from bucketeer_tpu_torch.kernels import mq_scan as ms

    L = 2
    args = _group()
    fused = ft.fused_t1(L, 0, *args)
    scan = cs.cxd_scan(L, 0, *args)
    flags = (args[1] > args[2]).to(torch.int32)
    mq = ms.mq_scan(L, *chip_smoke.mq_budget(L), scan[0], scan[1],
                    scan[4], flags)
    hs, ws = args[4], args[5]
    n = hs.shape[0]
    extent = int((hs.to(torch.int64) * ws.to(torch.int64)).sum()) * 4

    def want_fused(dlen, cur):
        return (extent + n * 5 * 4 + int((dlen.to(torch.int64) + 1).sum())
                + n * L * 3 * 4 * 3 + n * 3 * 4,
                int(cur.to(torch.int64).sum()))

    def want_scan(cur):
        syms = int(cur.to(torch.int64).sum())
        return (extent + n * 5 * 4 + syms + n * L * 3 * 4 * 3 + n * 4,
                syms)

    def want_mq(cur, dlen):
        syms = int(cur.to(torch.int64).sum())
        return (syms + n * L * 3 * 4 + n * 8
                + int((dlen.to(torch.int64) + 1).sum()) + n * L * 3 * 4
                + n * 8, syms)

    wf = ft.work(L, args, fused)
    wc = cs.work(L, args, scan)
    wm = ms.work(L, (scan[0], scan[1], scan[4], flags), mq)
    assert (wf.hbm_bytes, wf.flops) == want_fused(fused[2], fused[5])
    assert (wc.hbm_bytes, wc.flops) == want_scan(scan[4])
    assert (wm.hbm_bytes, wm.flops) == want_mq(scan[4], mq[2])
    longest = int(scan[4].max())
    for w in (wf, wc, wm):
        assert w.scan_depth == w.max_trip == longest
        assert w.launches == 1
    # The script's bound functions read the same count.
    assert chip_smoke.fused_bound(L, hs, ws, fused[2], fused[5])[2] == \
        wf.hbm_bytes
    assert chip_smoke.scan_bound(L, hs, ws, scan[4])[2] == wc.hbm_bytes
    assert chip_smoke.mq_bound(L, scan[4], mq[2])[2] == wm.hbm_bytes
    ms_, by, _ = chip_smoke.fused_bound(L, hs, ws, fused[2], fused[5])
    assert ms_ == chip_smoke._bound(wf.hbm_bytes, wf.flops)[0]


# --- the registry programs -------------------------------------------------

def _costs(facts):
    return [f.cost for f in facts if f.cost is not None]


def test_registry_models_all_17_jax_programs(repo_facts):
    jax = json.loads(JAX_MANIFEST.read_text(encoding="utf-8"))
    costs = {c.name: c for c in _costs(repo_facts)}
    assert set(costs) == set(jax["programs"])
    assert len(costs) == 17
    for name, c in costs.items():
        assert c.hbm_bytes > 0, name
        assert c.launches > 0, name
        if ".pallas" in name:
            assert c.launches == 1 and c.scan_depth > 0, name
        else:
            assert c.scan_depth == 0, name


def test_kernel_chains_are_quantified(repo_facts):
    """The kernel entries' serial chain is the block's decisions, equal
    for the scan and the fused kernel (one block, L=2), and under the
    per-element threshold; the fused kernel writes no symbol buffer."""
    from bucketeer_tpu_torch.kernels.cxd_scan import max_syms

    costs = {c.name.split("/")[0]: c for c in _costs(repo_facts)}
    scan, fused = costs["cxd.scan.pallas"], costs["cxdmq.fused.pallas"]
    assert scan.scan_depth == scan.max_trip == fused.scan_depth > 0
    assert scan.flops == fused.flops == scan.scan_depth
    assert fused.max_trip < rules_perf.SCAN_TRIP_THRESHOLD
    assert max_syms(2) not in fused.output_sizes
    assert fused.hbm_bytes < scan.hbm_bytes
    for m in graftcost.MACHINES.values():
        assert scan.roofline(m)["bound"] == "sequential"


def test_transform_and_inverse_are_memory_bound(repo_facts):
    costs = {c.name.split("/")[0]: c for c in _costs(repo_facts)}
    h100 = graftcost.MACHINES["h100"]
    for fam in ("pipeline.transform", "decode.inverse",
                "frontend.gather"):
        assert costs[fam].roofline(h100)["bound"] == "memory", fam


# --- perf rules + baseline hygiene -------------------------------------

def test_perf_rules_fire_on_the_kernel_entries_only(repo_facts):
    findings = rules_perf.run(_costs(repo_facts),
                              graftcost.MACHINES["h100"])
    by_rule: dict = {}
    for f in findings:
        by_rule.setdefault(f.rule, []).append(f)
    assert rules_perf.SCAN_PER_ELEMENT not in by_rule
    assert rules_perf.HBM_ROUNDTRIP not in by_rule
    low = by_rule[rules_perf.LOW_INTENSITY]
    assert {f.path for f in low} == {"<graftcost:cxd.scan.pallas/L2/N1>",
                                     "<graftcost:cxdmq.fused.pallas/L2/N1>"}
    assert all(f.severity == "warning" for f in findings)


def _jax_facts(c):
    return jax_cost.CostFacts(
        c.name, flops=c.flops, hbm_bytes=c.hbm_bytes,
        scan_depth=c.scan_depth, max_trip=c.max_trip,
        peak_live_bytes=c.peak_live_bytes, input_bytes=c.input_bytes,
        output_bytes=c.output_bytes, output_sizes=c.output_sizes,
        ici_bytes=c.ici_bytes)


def test_perf_findings_equal_jax_on_equal_facts(repo_facts):
    """The rules, thresholds and messages are the JAX package's: the same
    facts give the same (rule, location, message) — on the registry's
    facts and on seeded per-element and low-intensity offenders."""
    seeded = [graftcost.CostFacts("seeded.scan/L2/N1", flops=10,
                                  hbm_bytes=100, scan_depth=4096,
                                  max_trip=2048),
              graftcost.CostFacts("seeded.kernel.pallas/L2/N1", flops=5,
                                  hbm_bytes=100)]
    mine = _costs(repo_facts) + seeded
    for m in ("cpu",):
        got = [(f.rule, f.path, f.message) for f in rules_perf.run(
            mine, graftcost.MACHINES[m])]
        want = [(f.rule, f.path, f.message) for f in jax_rules.run(
            [_jax_facts(c) for c in mine], jax_cost.MACHINES[m])]
        assert got == want
        assert {r for r, _, _ in got} == {rules_perf.SCAN_PER_ELEMENT,
                                          rules_perf.LOW_INTENSITY}
    assert rules_perf.CHAINS == jax_rules.CHAINS == ()


def test_known_offenders_are_baselined(repo_facts):
    from bucketeer_tpu_torch.analysis.lint import load_baseline

    baseline = load_baseline(BASELINE)
    findings = rules_perf.run(_costs(repo_facts),
                              graftcost.MACHINES["h100"])
    assert findings, "expected today's offenders to fire"
    missing = [f.render() for f in findings
               if f.fingerprint() not in baseline]
    assert missing == [], missing
    # The JAX baseline carries the same two entries.
    jax_fps = {e["fingerprint"] for e in json.loads(
        (REPO / ".graftlint-baseline.json").read_text())["findings"]}
    assert {f.fingerprint() for f in findings} == jax_fps


def test_cli_cost_strict_passes_on_repo(capsys, cached_run):
    rc = cli_main([str(PKG), "--cost", "--strict", "--audit-device",
                   "cpu", "--baseline", str(BASELINE)])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "cxd.scan.pallas/L2/N1" in out and "scan depth 722" in out
    assert "intensity" in out and "MB HBM" in out and "MFLOP" in out
    assert "launch(es)" in out and "(h100:" in out


def test_cli_cost_report_json(tmp_path, capsys, cached_run):
    report = tmp_path / "cost.json"
    rc = cli_main([str(PKG), "--cost", "--machine", "cpu",
                   "--audit-device", "cpu", "--baseline", str(BASELINE),
                   "--cost-report", str(report)])
    assert rc == 0, capsys.readouterr().out
    data = json.loads(report.read_text(encoding="utf-8"))
    assert data["machine"] == "cpu"
    progs = data["programs"]
    assert len(progs) == 17
    entry = progs["cxd.scan.pallas/L2/N1"]
    for key in ("flops", "hbm_bytes", "intensity", "scan_depth",
                "peak_live_bytes", "launches", "roofline"):
        assert key in entry, key
    assert entry["roofline"]["bound"] == "sequential"


def test_cli_cost_without_cuda_exits_2(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli_main([str(PKG), "--cost"]) == 2
    assert "CUDA is unavailable" in capsys.readouterr().err


def test_stale_perf_baseline_entry_fails_strict(tmp_path, capsys,
                                                cached_run):
    data = json.loads(BASELINE.read_text(encoding="utf-8"))
    data["findings"].append({
        "fingerprint": "deadbeefdeadbeef",
        "rule": "perf-scan-per-element",
        "path": "<graftcost:ghost.scan/P9/N1>", "line": 0})
    tampered = tmp_path / "baseline.json"
    tampered.write_text(json.dumps(data) + "\n", encoding="utf-8")

    rc = cli_main([str(PKG), "--cost", "--strict", "--audit-device",
                   "cpu", "--baseline", str(tampered)])
    out = capsys.readouterr().out
    assert rc == 1
    assert "stale-baseline-entry" in out and "deadbeefdeadbeef" in out

    # Without --cost the perf family did not run: not judged.
    rc = cli_main([str(PKG), "--strict", "--baseline", str(tampered)])
    assert rc == 0, capsys.readouterr().out


def test_lint_only_write_baseline_preserves_perf_entries(tmp_path,
                                                         capsys):
    working = tmp_path / "baseline.json"
    shutil.copy(BASELINE, working)
    before = {e["fingerprint"] for e in json.loads(
        working.read_text(encoding="utf-8"))["findings"]}
    assert before, "expected checked-in perf entries"

    rc = cli_main([str(PKG), "--write-baseline", "--baseline",
                   str(working)])
    assert rc == 0, capsys.readouterr().out
    after = json.loads(working.read_text(encoding="utf-8"))["findings"]
    kept = {e["fingerprint"] for e in after
            if e.get("rule", "").startswith("perf-")}
    assert kept == before


def test_unmodeled_program_perf_entries_are_not_stale(monkeypatch, capsys,
                                                      repo_facts):
    """A run that could not model a program (no cost) must not judge
    that program's perf baseline entries stale."""
    hobbled = copy.deepcopy(repo_facts)
    for f in hobbled:
        if f.name.startswith("cxdmq.fused.pallas"):
            f.cost = None
    monkeypatch.setattr(deviceaudit, "run_programs",
                        lambda device="cuda": copy.deepcopy(hobbled))
    rc = cli_main([str(PKG), "--cost", "--strict", "--audit-device",
                   "cpu", "--baseline", str(BASELINE)])
    out = capsys.readouterr().out
    assert "not modeled here" in out
    assert rc == 0, out


# --- the manifest drift gate -------------------------------------------

def test_doubled_modeled_traffic_fails_drift_gate(repo_facts):
    manifest = deviceaudit.manifest_from_facts(repo_facts)
    for name in ("cxd.scan/L2/N1", "cxd.scan.pallas/L2/N1"):
        tampered = json.loads(json.dumps(manifest))
        tampered["programs"][name]["cost"]["hbm_bytes"] //= 2
        drift = deviceaudit.diff_manifest(tampered, manifest)
        lines = [ln for ln in drift if name + ":" in ln]
        assert len(lines) == 1, drift
        assert "hbm_bytes" in lines[0] and "+100%" in lines[0]
        assert "modeled cost drifted" in lines[0]


def test_cost_within_tolerance_is_not_drift(repo_facts):
    manifest = deviceaudit.manifest_from_facts(repo_facts)
    nudged = json.loads(json.dumps(manifest))
    cost = nudged["programs"]["cxd.scan/L2/N1"]["cost"]
    cost["hbm_bytes"] = int(cost["hbm_bytes"] * 1.05)
    cost["flops"] = int(cost["flops"] * 0.95)
    assert deviceaudit.diff_manifest(nudged, manifest) == []


def test_scan_depth_and_op_drift_are_reported(repo_facts):
    """A kernel whose serial chain moves shows as a scan_depth line; a
    torch-op program whose ops change (same cost) as an op-count line."""
    manifest = deviceaudit.manifest_from_facts(repo_facts)
    name = "cxdmq.fused.pallas/L2/N1"
    tampered = json.loads(json.dumps(manifest))
    tampered["programs"][name]["cost"]["scan_depth"] *= 4
    drift = deviceaudit.diff_manifest(tampered, manifest)
    lines = [ln for ln in drift if name in ln]
    assert len(lines) == 1 and "scan_depth" in lines[0]

    name = "pipeline.transform/gray8-lossless-64x64-L2/B1"
    tampered = json.loads(json.dumps(manifest))
    tampered["programs"][name]["fingerprint"] = "0" * 64
    tampered["programs"][name]["op_counts"]["aten::copy_"] = 7
    drift = deviceaudit.diff_manifest(tampered, manifest)
    assert len(drift) == 1 and "aten::copy_ 7->" in drift[0]


def test_card_section_is_compared_like_with_like(repo_facts):
    """An entry whose ops differ on the card lives in the card's own
    section: the card's run is held to it, the CPU's to the CPU
    section; a torch version change alone is no drift."""
    manifest = deviceaudit.manifest_from_facts(repo_facts)
    name = "frontend.gather/rows512/chunk4096"
    card = json.loads(json.dumps(manifest))
    card["torch"] = "0.0-card"
    card["programs"][name]["fingerprint"] = "c" * 64
    merged = deviceaudit.merge_manifest(manifest, card, "cuda")
    assert set(merged["devices"]["cuda"]["programs"]) == {name}
    assert deviceaudit.diff_manifest(merged, card, device="cuda") == []
    assert deviceaudit.diff_manifest(merged, manifest, device="cpu") == []
    drift = deviceaudit.diff_manifest(merged, manifest, device="cuda")
    assert len(drift) == 1 and name in drift[0] and "0.0-card" in drift[0]


def test_checked_in_manifest_matches_the_cpu_run(repo_facts):
    manifest = deviceaudit.load_manifest(MANIFEST)
    assert manifest is not None
    assert len(manifest["programs"]) == 17
    for name, prog in manifest["programs"].items():
        for key in ("flops", "hbm_bytes", "scan_depth", "max_trip",
                    "peak_live_bytes", "intensity", "launches"):
            assert key in prog["cost"], (name, key)
    drift = deviceaudit.diff_manifest(
        manifest, deviceaudit.manifest_from_facts(repo_facts))
    assert drift == [], ("programs drifted; regenerate with `python -m "
                         "bucketeer_tpu_torch.analysis --write-manifest "
                         "--mesh-audit --audit-device cpu`:\n"
                         + "\n".join(drift))


def test_cli_audit_fails_on_doubled_bytes(tmp_path, capsys, cached_run):
    manifest = json.loads(MANIFEST.read_text(encoding="utf-8"))
    manifest["programs"]["decode.inverse/gray8-reversible-64x64-L2/B1"][
        "cost"]["hbm_bytes"] *= 2
    bad = tmp_path / "manifest.json"
    bad.write_text(json.dumps(manifest) + "\n", encoding="utf-8")
    dump = tmp_path / "dump"
    rc = cli_main([str(PKG), "--audit", "--audit-device", "cpu",
                   "--baseline", str(BASELINE), "--manifest", str(bad),
                   "--dump-dir", str(dump)])
    out = capsys.readouterr().out
    assert rc == 1
    assert "audit-manifest-drift" in out and "hbm_bytes" in out
    assert list(dump.glob("*.ops.json"))


# --- the launch model (obs/cost.py) ------------------------------------

def test_modeled_launch_seconds_from_manifest():
    obs_cost.reset_cache()
    modeled = obs_cost.modeled_launch_seconds(2, "cpu")
    assert modeled is not None, "the manifest should provide a model"
    seconds, source = modeled
    assert seconds > 0
    assert source.startswith("frontend.rows/") and source.endswith("@cpu")
    more, _ = obs_cost.modeled_launch_seconds(8, "cpu")
    assert more > seconds
    assert obs_cost.modeled_launch_seconds(0, "cpu") is None
    card, src = obs_cost.modeled_launch_seconds(2, "cuda:0")
    assert src.endswith("@h100") and 0 < card < seconds


def test_modeled_launch_law_equals_jax_through_the_cache_seam():
    """Fed the same manifest entries through the cache seam, both
    packages pick the same bucket and scale by the same law on the cpu
    model."""
    from bucketeer_tpu.obs import cost as jax_obs_cost

    jax = json.loads(JAX_MANIFEST.read_text(encoding="utf-8"))
    entries = []
    for key, rec in jax["programs"].items():
        if key.startswith("frontend.rows/"):
            entries.append((key, int(key.rsplit("/B", 1)[-1]),
                            rec["cost"]))
    saved = dict(jax_obs_cost._CACHE)
    try:
        jax_obs_cost._CACHE.update(loaded=True, entries=entries,
                                   machine=jax_cost.MACHINES["cpu"])
        with obs_cost._LOCK:
            obs_cost._CACHE.update(loaded=True, entries=entries,
                                   programs=None)
        for n in list(range(0, 20)) + [31, 64, 100]:
            assert obs_cost.modeled_launch_seconds(n, "cpu") == \
                jax_obs_cost.modeled_launch_seconds(n)
    finally:
        jax_obs_cost._CACHE.clear()
        jax_obs_cost._CACHE.update(saved)
        obs_cost.reset_cache()


def test_modeled_stage_costs_from_manifest():
    obs_cost.reset_cache()
    for device in ("cpu", "cuda"):
        costs = obs_cost.modeled_stage_costs(device)
        assert costs is not None
        front, t1 = costs
        assert front > 0 and t1 > 0
        # The plain fused Tier-1 is the heavy stage on both models.
        assert t1 > front


# --- the calibration prediction ----------------------------------------

def test_tier1_prediction_shape():
    graftcost._PREDICTION_CACHE.clear()
    pred = graftcost.tier1_prediction("cpu")
    assert set(pred) == set(graftcost.MACHINES)
    for entry in pred.values():
        assert entry["symbols_per_s"] > 0
        assert entry["modeled_block_s"] > 0
        assert entry["ns_per_decision"] > 0
    assert pred["h100"]["symbols_per_s"] > pred["cpu"]["symbols_per_s"]
    # The serial chain dominates the modeled block on the card.
    assert pred["h100"]["ns_per_decision"] == pytest.approx(
        graftcost.MACHINES["h100"].seq_step_s * 1e9, rel=0.05)
