"""The lint gate over the PyTorch port: bucketeer_tpu_torch must pass
graftlint in strict mode with no baseline entry for any lint rule (the
port copy of tests/test_lint_gate.py; the baseline file holds only the
cost model's and the mesh audit's known offenders, judged by their own
audits), and the ABI cross-check of its hand-written ctypes tables
against the extern "C" functions of csrc/ must be live: it reads every
table, and a table that disagrees with its source is reported."""
import textwrap
from pathlib import Path

import pytest

from bucketeer_tpu_torch.analysis import abi, lint
from bucketeer_tpu_torch.analysis.__main__ import DEFAULT_BASELINE
from bucketeer_tpu_torch.analysis.__main__ import main as cli_main

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "bucketeer_tpu_torch"


def test_repo_is_lint_clean_strict():
    baseline = REPO / DEFAULT_BASELINE
    if baseline.exists():
        import json

        rules = {e["rule"] for e in json.loads(
            baseline.read_text(encoding="utf-8"))["findings"]}
        assert all(r.startswith(("perf-", "shard-")) for r in rules), rules
    findings = lint.run_lint(PKG)
    assert findings == [], "\n" + "\n".join(f.render() for f in findings)


def test_cli_strict_exits_zero():
    assert cli_main([str(PKG), "--strict"]) == 0


def test_abi_tables_are_discovered():
    """Guard against the cross-check silently losing the binding tables
    (an empty table set would make the ABI rules vacuous): every kernel
    library, the host coder, the fused Tier-1's column assembly and the
    host back half are read, with their arities."""
    project = lint.load_project(PKG)
    tables = {}
    for mod in project.modules:
        for lib, sources, table in abi.parse_bindings(mod.tree):
            tables[lib] = (sources, {s: n for s, (n, _) in table.items()})
    assert set(tables) == {"fused_t1", "cxd_scan", "mq_scan", "probe",
                           "host_t1", "host_t2", "t1_columns"}
    assert tables["probe"] == (("probe.cu",), {"probe_launch": 4})
    assert tables["fused_t1"][1] == {"fused_t1_launch": 22,
                                     "fused_t1_occupancy": 2}
    assert tables["host_t1"][1]["t1_encode_packed"] == 9
    exports = abi.parse_c_exports(
        (PKG / "csrc" / "host_t1.cpp").read_text())
    assert exports["t1_encode_cxd"] == 10
    assert exports["t1_abi_version"] == 0
    assert tables["host_t2"] == (("host_t2.cpp",), {
        "t2_allocate": 11, "t2_write": 15, "t2_result_sizes": 3,
        "t2_result_take": 2})
    assert abi.parse_c_exports(
        (PKG / "csrc" / "host_t2.cpp").read_text()) == tables["host_t2"][1]
    assert tables["t1_columns"] == (("t1_columns.cpp",), {
        "t1_group_passes": 12, "t1_gather_bytes": 5})
    assert abi.parse_c_exports(
        (PKG / "csrc" / "t1_columns.cpp").read_text()) == \
        tables["t1_columns"][1]


_CU = """\
    #include <cuda_runtime.h>

    extern "C" int demo_launch(const void* x, int n, void* y,
                               void* stream) {
        return 0;
    }
    """

_CPP = """\
    #include <cstdint>

    extern "C" {

    int32_t t1_abi_version() { return 1; }

    void* coder_run(int n, const void* in, void* out) { return nullptr; }

    void coder_free(void* r) {}

    }  // extern "C"
    """

_PY = """\
    import ctypes

    from .build import Library, kernel_library

    _P = ctypes.c_void_p
    _RUN = ([ctypes.c_int] + [_P] * {run_ptrs}, _P)
    DEMO = kernel_library("demo", ("demo.cu",), 1, {ints}, 1)
    CODER = Library("coder", ("coder.cpp",), {{
        "coder_run": _RUN,
        {extra}
    }}, cuda=False)
    """


def _fixture(tmp_path, run_ptrs=2, ints=1,
             extra='"coder_free": ([_P], None),'):
    root = tmp_path / "pkg"
    (root / "csrc").mkdir(parents=True)
    (root / "__init__.py").write_text('"""fixture"""\n')
    (root / "csrc" / "demo.cu").write_text(textwrap.dedent(_CU))
    (root / "csrc" / "coder.cpp").write_text(textwrap.dedent(_CPP))
    (root / "bind.py").write_text(textwrap.dedent(_PY.format(
        run_ptrs=run_ptrs, ints=ints, extra=extra)))
    return root


def _abi_findings(root):
    return [f for f in lint.run_lint(root) if f.rule.startswith("abi-")]


def test_abi_fixture_in_agreement_is_clean(tmp_path):
    assert _abi_findings(_fixture(tmp_path)) == []


@pytest.mark.parametrize("kw,where", [
    ({"run_ptrs": 3}, "coder_run"),       # a Library table entry
    ({"ints": 2}, "demo_launch"),         # a kernel_library count
])
def test_abi_wrong_arity_is_reported(tmp_path, kw, where):
    findings = _abi_findings(_fixture(tmp_path, **kw))
    assert [f.rule for f in findings] == [abi.ARITY_MISMATCH]
    assert where in findings[0].message
    assert findings[0].path == "pkg/bind.py"
    assert cli_main([str(tmp_path / "pkg"), "--strict"]) == 1


def test_abi_missing_and_unbound_exports_are_reported(tmp_path):
    findings = _abi_findings(_fixture(
        tmp_path, extra='"coder_gone": ([_P], None),'))
    assert sorted(f.rule for f in findings) == [abi.MISSING_EXPORT,
                                                abi.UNBOUND_EXPORT]
    missing = next(f for f in findings if f.rule == abi.MISSING_EXPORT)
    assert "coder_gone" in missing.message
    unbound = next(f for f in findings if f.rule == abi.UNBOUND_EXPORT)
    assert "coder_free" in unbound.message
    assert unbound.severity == "warning"


def test_gate_runs_the_device_region_rules(monkeypatch):
    """The strict gate covers rules_torch on the repo itself: with one
    transfer seam taken off the sanctioned list, its copy is reported
    where it stands; and every plain-version sync is a live, reasoned
    suppression (a dead one would fail the strict gate as stale)."""
    from bucketeer_tpu_torch.analysis import rules_torch

    monkeypatch.setattr(rules_torch, "D2H_SANCTIONED",
                        rules_torch.D2H_SANCTIONED - {"fetch_block_meta"})
    findings = [f for f in lint.run_lint(PKG)
                if f.rule == rules_torch.D2H]
    assert [(f.path, "fetch_block_meta" in f.message) for f in findings] \
        == [("bucketeer_tpu_torch/tensor/codec.py", True)]
    suppressed = [ln for p in (PKG / "kernels").glob("*.py")
                  for ln in p.read_text().splitlines()
                  if "graftlint: disable=host-sync" in ln]
    assert len(suppressed) == 8
