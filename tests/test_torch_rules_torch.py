"""The port's device-region rules (bucketeer_tpu_torch/analysis/
rules_torch.py): seeded-defect fixtures, the counterparts of
tests/test_analysis.py's host-sync, tracer-branch/float64 and
d2h-outside-gather cases. Each plants violations in a fixture package
whose analysis/deviceaudit.py names the device programs' roots, as the
port's own does, and asserts the rule reports exactly them."""
import textwrap
from pathlib import Path

from bucketeer_tpu_torch.analysis import lint, rules_torch
from bucketeer_tpu_torch.analysis.__main__ import main as cli_main

PKG = Path(__file__).resolve().parent.parent / "bucketeer_tpu_torch"


def _make_pkg(tmp_path, files: dict, roots: dict):
    """A fixture package with ``files`` and a deviceaudit.py whose
    PROGRAM_ROOTS is ``roots``."""
    files = {**files, "analysis/deviceaudit.py":
             f'"""fixture"""\nPROGRAM_ROOTS = {roots!r}\n'}
    root = tmp_path / "pkg"
    for relpath, body in files.items():
        path = root / relpath
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(body), encoding="utf-8")
        init = path.parent / "__init__.py"
        if not init.exists():
            init.write_text('"""fixture"""\n', encoding="utf-8")
    if not (root / "__init__.py").exists():
        (root / "__init__.py").write_text('"""fixture"""\n',
                                          encoding="utf-8")
    return root


def _rules(findings):
    return [f.rule for f in findings]


def test_seeded_host_sync(tmp_path):
    root = _make_pkg(tmp_path, {"codec/bad.py": """\
        import torch


        def _body(x):
            y = torch.abs(x)
            return y.item()
        """}, {"bad": ("codec/bad.py", "_body", ("x",))})
    findings = lint.run_lint(root)
    assert _rules(findings) == ["host-sync"]
    assert findings[0].line == 6


def test_branch_on_a_value_and_float64(tmp_path):
    """A Python branch on a tensor's value is a sync in eager torch (the
    JAX package's tracer-branch folds into host-sync); float64 in the
    region is a leak."""
    root = _make_pkg(tmp_path, {"codec/bad.py": """\
        import torch


        def _body(x):
            if x.sum() > 0:
                x = x * 2
            return x.to(torch.float64)
        """}, {"bad": ("codec/bad.py", "_body", ("x",))})
    findings = lint.run_lint(root)
    assert sorted((f.rule, f.line) for f in findings) == [
        ("float64-leak", 7), ("host-sync", 5)]


def test_taint_follows_calls_and_spares_host_values(tmp_path):
    """Taint reaches a helper through its tensor argument and a value a
    torch call returns; static parameters, shapes, identity tests and
    host numpy (its .tolist(), its float64) are not tensors."""
    root = _make_pkg(tmp_path, {"codec/ok.py": """\
        import numpy as np
        import torch


        def _helper(t, n):
            if n > 2:                       # n: a host int
                t = t + 1
            return int(t.max())             # a sync: t is a tensor


        def _body(plan, step_map, x):
            if plan.lossless:               # static configuration
                x = x + 1
            if step_map is None:            # identity: no value read
                step_map = torch.ones(4)
            if x.shape[0] == 1:             # shape: a host value
                x = x * 2
            w = np.arange(4, dtype=np.float64).tolist()   # host numpy
            z = torch.zeros(3)
            bool(z.any())                   # a sync: z came from torch
            return _helper(x * step_map, len(w))
        """}, {"ok": ("codec/ok.py", "_body", ("step_map", "x"))})
    findings = lint.run_lint(root)
    assert sorted((f.rule, f.line) for f in findings) == [
        ("host-sync", 8), ("host-sync", 20)]


def test_sanctioned_function_may_sync_and_outside_code_is_not_linted(
        tmp_path):
    """A sanctioned transfer function may sync inside the region; code
    no registered program reaches is not the device region."""
    root = _make_pkg(tmp_path, {"codec/xfer.py": """\
        import torch


        def gather_rows(rows):
            return rows.cpu().numpy()       # sanctioned


        def _body(x):
            return gather_rows(x + 1)


        def host_side(x):
            return int(x.sum())             # no program reaches it
        """}, {"ok": ("codec/xfer.py", "_body", ("x",))})
    assert lint.run_lint(root) == []


def test_cuda_synchronize_and_inline_suppression(tmp_path):
    root = _make_pkg(tmp_path, {"kernels/k.py": """\
        import torch


        def _body(x):
            torch.cuda.synchronize()
            n = int(x.max())  # graftlint: disable=host-sync
            return x[:n]
        """}, {"k": ("kernels/k.py", "_body", ("x",))})
    findings = lint.run_lint(root)
    assert [(f.rule, f.line) for f in findings] == [("host-sync", 5)]


def test_d2h_outside_gather(tmp_path):
    root = _make_pkg(tmp_path, {"codec/xfer.py": """\
        import torch


        def helper(arr):
            return arr.cpu()


        def also(arr):
            return arr.to("cpu")


        def fetch_block_meta(arr):
            return arr.cpu().numpy()        # sanctioned


        def elsewhere(arr):
            return arr.to(torch.device("cuda"))
        """, "engine/host.py": """\
        def outside_scope(arr):
            return arr.cpu()                # engine/: not in scope
        """}, {})
    findings = lint.run_lint(root)
    assert sorted((f.rule, f.line) for f in findings) == [
        ("d2h-outside-gather", 5), ("d2h-outside-gather", 9)]
    assert "helper" in findings[0].message + findings[1].message
    assert cli_main([str(root), "--strict"]) == 1


def test_repo_device_region_reaches_the_programs():
    """Guard against a vacuous rule: the repo's device region is walked
    from every root of the audit registry, through the helpers they
    call."""
    project = lint.load_project(PKG)
    roots = rules_torch.program_roots(project)
    assert len(roots) == 13
    region, _ = rules_torch._device_region(project, roots)
    names = {fn.node.name for fn in region.values()}
    for want in ("_frontend_body", "_transform_batch", "dwt2d_forward",
                 "_prologue", "_blockify", "cxd_scan_plain",
                 "mq_scan_plain", "fused_t1", "launch", "_inverse_body",
                 "dwt2d_inverse", "_region_body", "gather_rows",
                 "pack_blocks", "dequant", "run_dequant_inline"):
        assert want in names, want
    # Every root names a function that exists.
    for relpath, name, params in roots.values():
        mod, node = rules_torch._root_function(project, relpath, name)
        assert node is not None, (relpath, name)
        assert set(params) <= set(rules_torch._param_names(node))
