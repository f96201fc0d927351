"""The port's mesh audit (bucketeer_tpu_torch/analysis/graftmesh.py,
rules_shard.py and the copy seam of parallel/mesh.py), held to the JAX
package where both compute the same thing and ported case by case from
tests/test_graftmesh.py where the JAX cases do not parse partitioned
HLO: the seam prices each copy kind by the table in the module
docstring, the six registered mesh programs run on eight entries of the
CPU, the DWT's halo bytes equal the JAX manifest's collective-permute
bytes, the data-parallel programs move nothing between entries, the
shard-* rules fire on seeded violations exactly once (with the JAX
messages), and the mesh manifest gate fails on doubled link bytes while
jitter under the tolerance passes.

The mesh registry runs once per module (~7 s on the CPU)."""
import copy
import json
from pathlib import Path

import pytest
import torch

from bucketeer_tpu.analysis import graftmesh as jax_mesh
from bucketeer_tpu.analysis import rules_shard as jax_rules
from bucketeer_tpu_torch.analysis import deviceaudit, graftmesh, rules_shard
from bucketeer_tpu_torch.analysis.__main__ import main as cli_main
from bucketeer_tpu_torch.parallel import mesh as mesh_mod

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "bucketeer_tpu_torch"
MANIFEST = REPO / ".graftaudit-torch-manifest.json"
BASELINE = REPO / ".graftlint-torch-baseline.json"
JAX_MANIFEST = REPO / ".graftaudit-manifest.json"


@pytest.fixture(scope="module")
def mesh_facts():
    return graftmesh.run_mesh_programs("cpu")


@pytest.fixture()
def cached_mesh(mesh_facts, monkeypatch):
    """Replay the module's mesh run in the CLI."""
    def replay(device="cuda", entries=None):
        assert device == "cpu" and entries is None
        return copy.deepcopy(mesh_facts)

    monkeypatch.setattr(graftmesh, "run_mesh_programs", replay)
    return mesh_facts


def _ran(mesh_facts):
    return [f for f in mesh_facts if not f.skipped]


def _run(name, build, **kw):
    return graftmesh.run_mesh_program(
        graftmesh.MeshProgram(name, build, **kw), "cpu")


# --- the copy seam's pricing ----------------------------------------------

def test_copy_kinds_are_priced_by_the_table():
    """halo = bytes in; gather at its root = (g-1) x in; replicate from
    its source = (g-1) x in; split from the host = 0 link bytes (its
    bytes kept apart), from an entry (g-1) x piece."""
    rec = graftmesh._Copies()
    g, H = 8, mesh_mod.HOST
    rec("halo", [(100, i - 1, i) for i in range(1, g)], None)
    rec("halo", [(100, i + 1, i) for i in range(g - 1)], None)
    rec("gather", [(64, i, 0) for i in range(g)], None)
    rec("replicate", [(32, 0, e) for e in range(g)], None)
    rec("split", [(16, H, e) for e in range(g)], "data")
    got = rec.collectives()
    assert got["halo"] == {"count": 2, "bytes_in": 200, "ici_bytes": 200,
                           "h2d_bytes": 0, "d2h_bytes": 0}
    assert got["gather"]["ici_bytes"] == 64 * (g - 1)
    assert got["gather"]["count"] == 1
    assert got["replicate"]["ici_bytes"] == 32 * (g - 1)
    assert got["split"] == {"count": 1, "bytes_in": 16, "ici_bytes": 0,
                            "h2d_bytes": 16 * g, "d2h_bytes": 0}
    assert rec.axes == {"data"}
    # The same split from entry 0: (g-1) pieces leave it.
    rec2 = graftmesh._Copies()
    rec2("split", [(16, 0, e) for e in range(g)], "data")
    assert rec2.collectives()["split"]["ici_bytes"] == 16 * (g - 1)
    # A gather onto the host is a device-to-host copy, no link bytes.
    rec3 = graftmesh._Copies()
    rec3("gather", [(64, i, H) for i in range(g)], None)
    assert rec3.collectives()["gather"] == {
        "count": 0, "bytes_in": 0, "ici_bytes": 0, "h2d_bytes": 0,
        "d2h_bytes": 64 * g}


def test_the_seam_counts_by_entry_not_by_device():
    """On eight entries of one device nothing is copied, yet the seam
    counts what eight cards would move."""
    mesh = mesh_mod.make_mesh(["cpu"] * 8)
    calls = []
    old = mesh_mod.set_copy_recorder(
        lambda kind, moves, axis: calls.append((kind, moves, axis)))
    try:
        x = torch.arange(64, dtype=torch.int32).reshape(8, 8)
        parts = mesh_mod.batch_sharding(x, mesh)
        mesh_mod.unshard(parts)
        mesh_mod.replicated(x, mesh)
    finally:
        mesh_mod.set_copy_recorder(old)
    assert [k for k, _, _ in calls] == ["split", "gather", "replicate"]
    split = calls[0][1]
    assert split == [(32, 0, e) for e in range(8)]
    assert calls[0][2] == mesh_mod.DATA_AXIS
    assert calls[1][1] == [(32, i, 0) for i in range(8)]
    assert mesh_mod._COPY_RECORDER is None


# --- the registry on the real mesh programs --------------------------------

def test_registry_runs_the_six_jax_mesh_programs(mesh_facts):
    jax = json.loads(JAX_MANIFEST.read_text(encoding="utf-8"))
    ran = _ran(mesh_facts)
    assert [f.name for f in ran] == list(jax[jax_mesh.MESH_MANIFEST_KEY])
    assert {"shard.dwt.tile", "shard.transform.data",
            "shard.cxdmq.fused.data"} <= {f.name.split("/")[0]
                                          for f in ran}


def test_dwt_halo_bytes_equal_the_jax_collective_permute(mesh_facts):
    """The row-sharded DWT copies exactly its halos: two per level over
    two levels, per device the bytes the JAX manifest's
    collective-permutes carry (3,072 B gray, 9,216 B RGB)."""
    jax = json.loads(JAX_MANIFEST.read_text(encoding="utf-8"))[
        jax_mesh.MESH_MANIFEST_KEY]
    dwt = [f for f in _ran(mesh_facts)
           if f.name.startswith("shard.dwt.tile/")]
    assert len(dwt) == 2
    for f in dwt:
        want = jax[f.name]["collectives"]["collective-permute"]
        assert set(f.collectives) == {"halo"}, f.name
        assert f.collectives["halo"]["count"] == want["count"] == 4
        assert f.collectives["halo"]["bytes_in"] == want["bytes_in"]
        assert f.ici_bytes == jax[f.name]["ici_bytes"]
    assert [f.collectives["halo"]["bytes_in"] for f in dwt] == [3072, 9216]


def test_data_parallel_programs_move_nothing_between_entries(mesh_facts):
    data = [f for f in _ran(mesh_facts)
            if f.name.split("/")[0].endswith(".data")]
    assert len(data) == 2
    for f in data:
        assert f.collectives == {}, (f.name, f.collectives)
        assert f.ici_bytes == 0


def test_batch_placement_splits_from_the_pool_device(mesh_facts):
    """What the port runs for a sharded batch copies each band's pieces
    from the dequantizer's device to the other seven entries — link
    bytes the JAX program (whose input is already sharded) does not
    have."""
    for f in _ran(mesh_facts):
        if not f.name.startswith("batch.assemble.dequant/"):
            continue
        assert set(f.collectives) == {"split"}
        # 4 bands of (8,1,16,16) and 3 of (8,1,32,32) int32 or float32:
        # seven pieces of each leave entry 0.
        piece = [16 * 16 * 4] * 4 + [32 * 32 * 4] * 3
        assert f.ici_bytes == 7 * sum(piece)
        assert f.collectives["split"]["count"] == 7


def test_mesh_facts_are_fully_populated(mesh_facts):
    for f in _ran(mesh_facts):
        assert f.peak_live_bytes > 0, f.name
        assert len(f.fingerprint) == 64, f.name
        n = 1
        for size in f.mesh_shape.values():
            n *= size
        assert n == graftmesh.MESH_DEVICES, (f.name, f.mesh_shape)
        assert f.axes_used, f.name
        assert f.cost is not None and f.cost.ici_bytes == f.ici_bytes
        assert f.cost.launches > 0, f.name


def test_repo_mesh_programs_are_rule_clean(mesh_facts):
    findings = rules_shard.run(mesh_facts)
    assert findings == [], "\n".join(f.render() for f in findings)


def test_checked_in_manifest_matches_mesh_programs(mesh_facts):
    drift = graftmesh.diff_mesh_manifest(
        deviceaudit.load_manifest(MANIFEST),
        graftmesh.mesh_manifest_from_facts(mesh_facts))
    assert drift == [], ("mesh programs drifted; regenerate with `python "
                         "-m bucketeer_tpu_torch.analysis --mesh-audit "
                         "--write-manifest --audit-device cpu` and commit "
                         "the diff:\n" + "\n".join(drift))


# --- seeded violations --------------------------------------------------

def test_seeded_implicit_allgather_fires_exactly_once():
    """An undeclared unshard of an 8 MB batch onto one entry pulls 7 MB
    over the links; shard-implicit-allgather fires, once."""
    def build(device):
        mesh = graftmesh._mesh(device)
        parts = mesh_mod.batch_sharding(
            torch.zeros(8, 512, 512, dtype=torch.float32), mesh)
        return (lambda: mesh_mod.unshard(parts) * 2), mesh, ("data",)

    facts = _run("synthetic/allgather", build)
    cell = facts.collectives.get("gather")
    assert cell and cell["ici_bytes"] >= rules_shard.ALLGATHER_MIN_BYTES
    findings = rules_shard.run([facts])
    assert [f.rule for f in findings] == [
        rules_shard.SHARD_IMPLICIT_ALLGATHER]
    assert "all-gather" in findings[0].message
    # Declared, it is no finding.
    facts.expected_collectives = ("gather",)
    assert rules_shard.run([facts]) == []


def test_seeded_replicated_large_operand_fires_exactly_once():
    """A 100 MB table replicated to every entry costs each the global
    array; shard-replicated-large fires, once, naming the operand."""
    def build(device):
        mesh = graftmesh._mesh(device)
        x = torch.zeros(8, 64)
        table = torch.zeros(25_000_000)

        def run():
            parts = mesh_mod.batch_sharding(x, mesh)
            tables = mesh_mod.replicated(table, mesh)
            return [p + t[0] for p, t in zip(parts, tables)]
        return run, mesh, ()

    facts = _run("synthetic/replicated", build)
    assert (1, 100_000_000) in facts.replicated_args
    findings = rules_shard.run([facts])
    assert [f.rule for f in findings] == [
        rules_shard.SHARD_REPLICATED_LARGE]
    assert "operand 1" in findings[0].message


def test_seeded_dead_mesh_axis_fires_exactly_once():
    """A 4x2 mesh whose program splits over 'data' only leaves the
    2-entry 'tile' axis idle; shard-axis-dead fires, once."""
    def build(device):
        mesh = mesh_mod.make_mesh(["cpu"] * 8, tile_parallel=2)
        x = torch.zeros(8, 64)
        return (lambda: [p * 2 for p in mesh_mod.batch_sharding(x, mesh)],
                mesh, ())

    facts = _run("synthetic/deadaxis", build)
    assert facts.mesh_shape == {"data": 4, "tile": 2}
    assert facts.axes_used == ("data",)
    findings = rules_shard.run([facts])
    assert [f.rule for f in findings] == [rules_shard.SHARD_AXIS_DEAD]
    assert "'tile'" in findings[0].message


def test_shard_findings_equal_jax_on_equal_facts():
    """The rules, thresholds and messages are the JAX package's: equal
    facts (the port's ``gather`` where JAX has ``all-gather``) give the
    same (rule, location, message)."""
    def pair(name, kind_mine, kind_jax, ici, replicated, shape, axes,
             expected=()):
        cell = {"count": 2, "bytes_in": ici // 7, "ici_bytes": ici}
        mine = graftmesh.MeshFacts(
            name, mesh_shape=shape, axes_used=axes,
            collectives={kind_mine: dict(cell)} if kind_mine else {},
            replicated_args=replicated,
            expected_collectives=tuple(k for k in expected))
        theirs = jax_mesh.MeshFacts(
            name, mesh_shape=shape, axes_used=axes,
            collectives={kind_jax: dict(cell)} if kind_jax else {},
            replicated_args=replicated,
            expected_collectives=tuple(
                "all-gather" if k == "gather" else k for k in expected))
        return mine, theirs

    cases = [
        pair("a", "gather", "all-gather", 8 << 20, (), {"data": 8}, ("data",)),
        pair("b", "gather", "all-gather", 1 << 10, (), {"data": 8}, ("data",)),
        pair("c", "gather", "all-gather", 8 << 20, (), {"data": 8},
             ("data",), expected=("gather",)),
        pair("d", None, None, 0, ((0, 4), (1, 100 << 20)),
             {"data": 8, "tile": 1}, ("data",)),
        pair("e", None, None, 0, (), {"data": 4, "tile": 2}, ("data",)),
        pair("f", "gather", "all-gather", 2 << 20, ((3, 64 << 20),),
             {"data": 2, "tile": 4}, ()),
    ]
    got = [(f.rule, f.path, f.message)
           for f in rules_shard.run([m for m, _ in cases])]
    want = [(f.rule, f.path, f.message)
            for f in jax_rules.run([t for _, t in cases])]
    assert got == want
    assert len(got) == 7
    assert (rules_shard.ALLGATHER_MIN_BYTES,
            rules_shard.REPLICATED_MIN_BYTES) == (
        jax_rules.ALLGATHER_MIN_BYTES, jax_rules.REPLICATED_MIN_BYTES)


# --- the mesh manifest drift gate --------------------------------------

def _synth_section():
    return {
        "shard.a.tile/T8": {
            "fingerprint": "a" * 64,
            "mesh": {"data": 1, "tile": 8},
            "collectives": {"halo": {
                "count": 4, "bytes_in": 3072, "ici_bytes": 3072,
                "h2d_bytes": 0, "d2h_bytes": 0}},
            "ici_bytes": 3072, "peak_live_bytes": 112696},
        "shard.b.data/B8": {
            "fingerprint": "b" * 64,
            "mesh": {"data": 8, "tile": 1},
            "collectives": {},
            "ici_bytes": 0, "peak_live_bytes": 228352},
    }


def _synth_manifest():
    return {"torch": torch.__version__, "programs": {},
            graftmesh.MESH_MANIFEST_KEY: _synth_section()}


def test_doubled_link_traffic_fails_drift_gate():
    new = _synth_section()
    new["shard.a.tile/T8"]["ici_bytes"] *= 2
    drift = graftmesh.diff_mesh_manifest(_synth_manifest(), new)
    assert len(drift) == 1 and "shard.a.tile/T8" in drift[0]
    assert "ici_bytes" in drift[0] and "+100%" in drift[0]


def test_doubled_halo_bytes_fail_drift_gate():
    new = _synth_section()
    new["shard.a.tile/T8"]["collectives"]["halo"]["bytes_in"] *= 2
    drift = graftmesh.diff_mesh_manifest(_synth_manifest(), new)
    assert len(drift) == 1 and "halo bytes_in" in drift[0]


def test_cost_jitter_under_tolerance_passes_drift_gate():
    new = _synth_section()
    for entry in new.values():
        entry["ici_bytes"] = int(entry["ici_bytes"] * 1.05)
        entry["peak_live_bytes"] = int(entry["peak_live_bytes"] * 1.05)
    assert graftmesh.diff_mesh_manifest(_synth_manifest(), new) == []


def test_collective_histogram_change_is_drift():
    new = _synth_section()
    new["shard.a.tile/T8"]["collectives"]["halo"]["count"] += 2
    drift = graftmesh.diff_mesh_manifest(_synth_manifest(), new)
    assert len(drift) == 1 and "shard.a.tile/T8" in drift[0]
    assert "collective histogram" in drift[0] and "halo" in drift[0]


def test_fingerprint_ghost_and_missing_section_drift():
    old = _synth_manifest()
    new = _synth_section()
    new["shard.a.tile/T8"]["fingerprint"] = "0" * 64
    drift = graftmesh.diff_mesh_manifest(old, new)
    assert len(drift) == 1 and "fingerprint changed" in drift[0]

    old[graftmesh.MESH_MANIFEST_KEY]["ghost/prog"] = {
        "fingerprint": "x", "collectives": {}, "ici_bytes": 0,
        "peak_live_bytes": 0}
    drift = graftmesh.diff_mesh_manifest(old, new)
    assert any("ghost/prog" in line for line in drift)
    assert not any("ghost/prog" in line for line in
                   graftmesh.diff_mesh_manifest(
                       old, new, skipped=("ghost/prog",)))

    for missing in (None, {"torch": torch.__version__}):
        lines = graftmesh.diff_mesh_manifest(missing, new)
        assert len(lines) == 1 and "--mesh-audit" in lines[0]


def test_card_mesh_section_is_compared_like_with_like():
    """A card run is held to the card's own mesh entries where they
    differ; a torch version change alone is no drift."""
    old = _synth_manifest()
    old["torch"] = "0.0.stale"
    card = _synth_section()
    card["shard.b.data/B8"]["fingerprint"] = "c" * 64
    assert len(graftmesh.diff_mesh_manifest(old, card,
                                            device="cuda")) == 1
    old["devices"] = {"cuda": {"torch": "0.0-card", "mesh_programs": {
        "shard.b.data/B8": card["shard.b.data/B8"]}}}
    assert graftmesh.diff_mesh_manifest(old, card, device="cuda") == []
    assert graftmesh.diff_mesh_manifest(old, _synth_section()) == []


# --- CLI ----------------------------------------------------------------

def test_cli_mesh_audit_passes_on_repo(capsys, cached_mesh):
    rc = cli_main([str(PKG), "--mesh-audit", "--strict", "--audit-device",
                   "cpu", "--baseline", str(BASELINE), "--manifest",
                   str(MANIFEST)])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "shard.dwt.tile/" in out and "MB link/device" in out
    assert "halo 3072 B in" in out


def test_cli_mesh_audit_without_cuda_exits_2(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli_main([str(PKG), "--mesh-audit"]) == 2
    assert "CUDA is unavailable" in capsys.readouterr().err


def test_cli_mesh_audit_fails_on_doubled_halo(tmp_path, capsys,
                                              cached_mesh):
    manifest = json.loads(MANIFEST.read_text(encoding="utf-8"))
    section = manifest[graftmesh.MESH_MANIFEST_KEY]
    assert any(e["ici_bytes"] for e in section.values())
    for entry in section.values():
        if "halo" in entry["collectives"]:
            entry["collectives"]["halo"]["bytes_in"] *= 2
            entry["ici_bytes"] *= 2
    bad = tmp_path / "manifest.json"
    bad.write_text(json.dumps(manifest) + "\n", encoding="utf-8")
    dump = tmp_path / "dump"
    rc = cli_main([str(PKG), "--mesh-audit", "--audit-device", "cpu",
                   "--baseline", str(BASELINE), "--manifest", str(bad),
                   "--dump-dir", str(dump)])
    assert rc == 1
    out = capsys.readouterr().out
    assert "shard-manifest-drift" in out and "ici_bytes" in out
    assert list(dump.glob("*.mesh.json"))


def test_cli_write_manifest_without_mesh_audit_preserves_section(
        tmp_path, capsys, monkeypatch):
    """A single-device --write-manifest refresh carries the mesh section
    (and any card section) over instead of dropping it. The registry
    run is stubbed out: this checks the merge, not the run."""
    import shutil

    working = tmp_path / "manifest.json"
    shutil.copy(MANIFEST, working)
    before = json.loads(working.read_text(encoding="utf-8"))
    assert before[graftmesh.MESH_MANIFEST_KEY]
    monkeypatch.setattr(deviceaudit, "run_programs", lambda device: [])
    rc = cli_main([str(PKG), "--write-manifest", "--audit-device", "cpu",
                   "--manifest", str(working)])
    assert rc == 0, capsys.readouterr().out
    after = json.loads(working.read_text(encoding="utf-8"))
    assert after[graftmesh.MESH_MANIFEST_KEY] == \
        before[graftmesh.MESH_MANIFEST_KEY]
    assert after.get("devices") == before.get("devices")


def test_stale_shard_baseline_entry_fails_strict(tmp_path, capsys,
                                                 cached_mesh):
    data = json.loads(BASELINE.read_text(encoding="utf-8"))
    data["findings"].append({
        "fingerprint": "feedfacefeedface",
        "rule": "shard-axis-dead",
        "path": "<graftmesh:ghost.mesh/T8>", "line": 0})
    tampered = tmp_path / "baseline.json"
    tampered.write_text(json.dumps(data) + "\n", encoding="utf-8")

    rc = cli_main([str(PKG), "--mesh-audit", "--strict", "--audit-device",
                   "cpu", "--baseline", str(tampered), "--manifest",
                   str(MANIFEST)])
    out = capsys.readouterr().out
    assert rc == 1
    assert "stale-baseline-entry" in out and "feedfacefeedface" in out

    rc = cli_main([str(PKG), "--strict", "--baseline", str(tampered)])
    assert rc == 0, capsys.readouterr().out


def test_skipped_mesh_program_shard_entries_are_not_stale(
        tmp_path, capsys, mesh_facts, monkeypatch):
    hobbled = copy.deepcopy(mesh_facts)
    hobbled[0].skipped = "synthetic: not run here"
    name = hobbled[0].name
    monkeypatch.setattr(graftmesh, "run_mesh_programs",
                        lambda device="cuda", entries=None:
                        copy.deepcopy(hobbled))
    data = json.loads(BASELINE.read_text(encoding="utf-8"))
    data["findings"].append({
        "fingerprint": "cafebabecafebabe",
        "rule": "shard-implicit-allgather",
        "path": f"<graftmesh:{name}>", "line": 0})
    tampered = tmp_path / "baseline.json"
    tampered.write_text(json.dumps(data) + "\n", encoding="utf-8")
    rc = cli_main([str(PKG), "--mesh-audit", "--strict", "--audit-device",
                   "cpu", "--baseline", str(tampered), "--manifest",
                   str(MANIFEST)])
    out = capsys.readouterr().out
    assert "not run here" in out
    assert rc == 0, out


def test_lint_only_write_baseline_preserves_shard_entries(tmp_path,
                                                          capsys):
    data = json.loads(BASELINE.read_text(encoding="utf-8"))
    data["findings"].append({
        "fingerprint": "0123456789abcdef",
        "rule": "shard-replicated-large",
        "path": "<graftmesh:ghost>", "line": 0})
    working = tmp_path / "baseline.json"
    working.write_text(json.dumps(data) + "\n", encoding="utf-8")
    rc = cli_main([str(PKG), "--write-baseline", "--baseline",
                   str(working)])
    assert rc == 0, capsys.readouterr().out
    after = json.loads(working.read_text(encoding="utf-8"))["findings"]
    assert any(e["fingerprint"] == "0123456789abcdef" for e in after)
