"""The port's dispatch audit (bucketeer_tpu_torch/analysis/
deviceaudit.py): the registry mirrors the JAX package's entry for entry,
the repo's programs run clean on the CPU under the recorder, seeded host
syncs and float64 are caught, pool threads are covered, and the d2h
whitelist is live (the counterparts of tests/test_deviceaudit.py's
whitelist cases)."""
import textwrap
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from bucketeer_tpu_torch.analysis import deviceaudit, lint
from bucketeer_tpu_torch.analysis.__main__ import main as cli_main

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "bucketeer_tpu_torch"


@pytest.fixture(scope="module")
def repo_facts():
    return deviceaudit.run_programs("cpu")


def test_registry_names_equal_the_jax_registry():
    from bucketeer_tpu.analysis import deviceaudit as jax_audit

    names = [e.name for e in deviceaudit.registry()]
    assert names == [e.name for e in jax_audit.registry()]
    assert len(names) == 17
    prefixes = {name.split("/")[0] for name in names}
    assert prefixes == set(deviceaudit.PROGRAM_ROOTS)
    for entry in deviceaudit.registry():
        assert entry.card_only == entry.name.split("/")[0].endswith(
            ".pallas")


def test_registry_entries_run_their_lint_roots(monkeypatch):
    """Each entry runs the function PROGRAM_ROOTS names for its prefix,
    the root the lint walks the device region from."""
    for prefix, (path, func, _) in deviceaudit.PROGRAM_ROOTS.items():
        fn = deviceaudit._root(prefix)
        assert fn.__name__ == func
        assert fn.__module__.replace(".", "/").endswith(
            path.removesuffix(".py"))
    called = []

    def fake_root(prefix):
        return lambda *a, **kw: called.append(prefix)

    monkeypatch.setattr(deviceaudit, "_root", fake_root)
    for entry in deviceaudit.registry():
        called.clear()
        entry.build("cpu")()
        assert called == [entry.name.split("/")[0]], entry.name


def test_repo_programs_are_clean_on_the_cpu(repo_facts):
    findings = []
    for facts in repo_facts:
        findings += deviceaudit.check_program(facts)
    assert findings == [], "\n".join(f.render() for f in findings)
    ran = [f for f in repo_facts if not f.skipped]
    assert len(ran) == 15
    assert all(f.ops > 0 for f in ran)


def test_kernels_are_skipped_off_the_card(repo_facts):
    skipped = {f.name: f.skipped for f in repo_facts if f.skipped}
    assert set(skipped) == {"cxd.scan.pallas/L2/N1",
                            "cxdmq.fused.pallas/L2/N1"}
    assert all("card only" in why for why in skipped.values())
    line = deviceaudit.render(next(f for f in repo_facts if f.skipped))
    assert "skipped" in line


def test_cpu_audit_says_copies_are_not_counted(repo_facts):
    """On the CPU no copy dispatches an op: each line says the copies
    were not counted instead of printing 0."""
    for facts in repo_facts:
        if facts.skipped:
            continue
        assert not facts.copies_counted and not facts.copies
        line = deviceaudit.render(facts)
        assert "device-to-host copies not counted on the CPU" in line
        assert "cop(ies) of" not in line


def test_audit_defaults_to_the_card(monkeypatch, capsys):
    """The audit runs on the card unless asked for the CPU, and without
    CUDA it raises rather than count nothing; the CLI exits 2."""
    import inspect

    for fn in (deviceaudit.run_audit, deviceaudit.run_programs,
               deviceaudit.run_program):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        deviceaudit.run_programs()
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        deviceaudit.audit_call(lambda: None)
    assert cli_main([str(PKG), "--audit"]) == 2
    assert "CUDA is unavailable" in capsys.readouterr().err


def test_plain_version_syncs_are_recorded_and_sanctioned(repo_facts):
    """The plain Tier-1 versions bound their loops on the host: their
    syncs are recorded at the package function that makes them and are
    sanctioned by the inline suppression beside each."""
    fused = next(f for f in repo_facts if f.name == "cxdmq.fused/L2/N1")
    by_fn = fused.by_function("syncs")
    assert by_fn["bucketeer_tpu_torch/kernels/cxd_scan.py:"
                 "cxd_scan_plain"] == 3
    assert by_fn["bucketeer_tpu_torch/kernels/mq_scan.py:"
                 "mq_scan_plain"] > 0
    assert deviceaudit.unsanctioned(fused) == ({}, {})
    # Nothing else of the registry syncs on the CPU.
    for facts in repo_facts:
        if facts.name.split("/")[0] not in ("cxd.scan", "cxdmq.fused"):
            assert not facts.syncs, facts.name


def test_seeded_item_and_float64_are_caught():
    from bucketeer_tpu_torch.codec.pipeline import (_transform_batch,
                                                    make_plan)

    plan = make_plan(64, 64, 1, 2, True, 8)
    staged = torch.zeros((1, 64, 64, 1), dtype=torch.int32)

    def with_item():
        out = _transform_batch(plan, None, staged)
        return out.max().item()

    def with_f64():
        return _transform_batch(plan, None, staged).to(torch.float64)

    _, facts = deviceaudit.audit_call(with_item, audit_device="cpu")
    rules = [f.rule for f in deviceaudit.check_program(facts)]
    assert rules == [deviceaudit.HOST_SYNC]
    _, facts = deviceaudit.audit_call(with_f64, audit_device="cpu")
    found = deviceaudit.check_program(facts)
    assert [f.rule for f in found] == [deviceaudit.F64_IN_PROGRAM]
    assert "_to_copy" in found[0].message


def test_sync_is_attributed_to_the_innermost_package_function():
    from bucketeer_tpu_torch.kernels import mq_scan

    _, facts = deviceaudit.audit_call(
        mq_scan.check_steps, 16, torch.tensor([3, 5]), 64,
        audit_device="cpu")
    (site, n), = facts.syncs.items()
    assert n == 1 and site.function == "check_steps"
    assert site.path == "bucketeer_tpu_torch/kernels/mq_scan.py"
    assert deviceaudit.sanctioned(site)        # its inline suppression


def test_audited_calls_are_serialised_and_restore_the_pool():
    """Audits from two threads run one after another, and the pool's
    submit is the original again after both."""
    import threading

    original = ThreadPoolExecutor.submit
    inside = []
    gate = threading.Barrier(2)

    def call(tag):
        inside.append(("in", tag))
        with ThreadPoolExecutor(max_workers=1) as pool:
            pool.submit(lambda: torch.ones(2).sum().item()).result()
        time.sleep(0.2)            # room for the other thread to enter
        inside.append(("out", tag))

    def worker(tag):
        gate.wait()
        deviceaudit.audit_call(call, tag, audit_device="cpu")

    threads = [threading.Thread(target=worker, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert [k for k, _ in inside] == ["in", "out", "in", "out"]
    assert inside[0][1] == inside[1][1]
    assert ThreadPoolExecutor.submit is original


def test_pool_threads_are_covered():
    """The dispatch mode is per thread: work handed to a pool during the
    audited call runs under a recorder of its own thread."""
    def call():
        with ThreadPoolExecutor(max_workers=1) as pool:
            return pool.submit(lambda: torch.ones(3).sum().item()).result()

    out, facts = deviceaudit.audit_call(call, audit_device="cpu")
    assert out == 3.0
    assert facts.pool_tasks == 1 and len(facts.threads) == 2
    assert sum(facts.syncs.values()) == 1
    (site, seconds), = facts.sync_seconds.items()
    assert site in facts.syncs and seconds >= 0.0


def test_audited_encode_is_the_same_encode():
    """audit_call around the default CPU encode (the host Tier-1): the
    same bytes, no float64, no sync, the pool's Tier-1 thread
    covered."""
    from bucketeer_tpu_torch.codec import encoder

    img = np.random.default_rng(5).integers(0, 256, (40, 48, 3)).astype(
        np.uint8)
    params = encoder.EncodeParams.kakadu_recipe(lossless=True)
    params.levels, params.tile_size = 2, None
    want = encoder.encode_jp2(img, 8, params, jpx=True, device="cpu")
    got, facts = deviceaudit.audit_call(
        encoder.encode_jp2, img, 8, params, jpx=True, device="cpu")
    assert got == want
    assert facts.ops > 0 and not facts.syncs and not facts.f64
    assert facts.pool_tasks >= 1 and len(facts.threads) == 2
    assert deviceaudit.check_program(facts) == []


# --- d2h whitelist validation ------------------------------------------

def test_repo_d2h_whitelist_is_live():
    project = lint.load_project(PKG)
    findings = deviceaudit.validate_d2h_whitelist(project)
    assert findings == [], "\n".join(f.render() for f in findings)


def test_stale_d2h_whitelist_entry_is_reported(tmp_path):
    """A sanctioned function that no longer transfers anything (and one
    that vanished entirely) must both be reported stale."""
    root = tmp_path / "pkg"
    (root / "codec").mkdir(parents=True)
    (root / "__init__.py").write_text('"""fixture"""\n')
    (root / "codec" / "__init__.py").write_text('"""fixture"""\n')
    (root / "codec" / "xfer.py").write_text(textwrap.dedent("""\
        def gather_rows(rows):
            return rows * 2          # no copy to the host anymore


        def fetch_block_meta(maxmag):
            return maxmag.cpu().numpy()


        def run_tiles(plan, tiles):
            return gather_rows(tiles)    # delegates to a sanctioned name
        """), encoding="utf-8")
    project = lint.load_project(root)
    findings = deviceaudit.validate_d2h_whitelist(project)
    stale = {f.message.split("'")[1] for f in findings}
    assert "gather_rows" in stale
    assert "fetch_block_meta" not in stale
    assert "run_tiles" not in stale
    # Names with no definition at all in the fixture are also stale.
    assert "run_cxd" in stale
    assert all(f.severity == "warning" for f in findings)


# --- CLI ----------------------------------------------------------------

def test_cli_audit_passes_on_repo(capsys, monkeypatch, repo_facts):
    def programs(device):
        assert device == "cpu"
        return repo_facts

    monkeypatch.setattr(deviceaudit, "run_programs", programs)
    rc = cli_main([str(PKG), "--audit", "--audit-device", "cpu",
                   "--strict"])
    out = capsys.readouterr().out
    assert rc == 0, out
    lines = [ln for ln in out.splitlines()
             if ln.startswith("deviceaudit:")]
    assert len(lines) == 17
    assert sum("skipped" in ln for ln in lines) == 2
    assert "graftlint: clean" in out


def test_cli_audit_fails_on_a_hard_failure(capsys, monkeypatch):
    def bad_programs(device="cpu"):
        def f64():
            return torch.zeros(2, dtype=torch.float64) + 1
        return [deviceaudit.audit_call(f64, audit_name=f"bad/{i}",
                                       audit_device="cpu")[1]
                for i in range(3)]

    monkeypatch.setattr(deviceaudit, "run_programs", bad_programs)
    assert cli_main([str(PKG), "--audit", "--audit-device", "cpu"]) == 1
    assert "audit-f64" in capsys.readouterr().out
