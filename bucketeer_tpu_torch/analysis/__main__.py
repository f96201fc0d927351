"""graftlint CLI over the port: ``python -m bucketeer_tpu_torch.analysis
[--strict] [--baseline FILE] [--write-baseline | --prune-baseline]
[--audit] [--cost [--machine {h100,cpu}] [--cost-report FILE]]
[--mesh-audit] [--audit-device {cpu,cuda}] [--manifest FILE]
[--write-manifest] [--dump-dir DIR] [--race ...] [--race-replay FILE]
[--json] [paths]``.

Exit codes: 0 clean (in non-strict mode, warnings alone stay clean),
1 findings, 2 bad invocation.

The lint runs the host rules, the device-region rules and the ABI
cross-check (:mod:`.lint`) over the package (or ``paths``).

``--audit`` adds the dispatch audit (:mod:`.deviceaudit`): every
registered device program runs on ``--audit-device`` (default cuda,
which needs a card: without one the run exits 2; ``cpu`` reports the
hand-written kernels as skipped and counts no device-to-host copies)
under a recorder of its aten ops, one line per program is printed, and
a float64 output or a host sync or device-to-host copy outside the
sanctioned functions fails the run; the d2h whitelist is validated
against the code; and the program manifest
(``.graftaudit-torch-manifest.json``: op fingerprints, op histograms,
modeled costs) is diffed against the checked-in file — drift fails.
After an intentional program change, regenerate it with
``--write-manifest`` (on the CPU; ``--audit-device cuda`` records the
entries whose ops differ on the card in a section of their own) and
commit the result.

``--cost`` adds the cost model (:mod:`.graftcost`): flops, device-memory
bytes, launches, intensity, serial chain and peak live bytes of every
registered program, rooflined on ``--machine`` (``h100`` default, or
``cpu``); the ``perf-*`` rules (:mod:`.rules_perf`) fire on
anti-patterns, with known offenders in the baseline. ``--cost-report``
writes the machine-readable report.

``--mesh-audit`` adds the mesh audit (:mod:`.graftmesh`): every
registered mesh program runs on a mesh of eight entries of
``--audit-device``, what it copies between entries is read at the mesh's
copy seam and priced per kind, the ``shard-*`` rules (:mod:`.rules_shard`)
fire, and the manifest's ``mesh_programs`` section is diffed.

``--dump-dir`` receives each program's op histogram when an audit
fails (the JAX CLI dumps lowered text there).

``--race`` adds the dynamic layer (graftrace): the serving core's
scenario suite is executed under the controlled scheduler, exploring
interleavings systematically (bounded preemptions) and by seeded
random walk within ``--race-budget-s``; data races, lock-inversion
cycles, deadlocks and broken scenario invariants become findings, each
carrying the schedule that produced it (``--race-trace-dir`` persists
the traces, ``--race-replay FILE`` re-executes one bit-for-bit).

Suppression hygiene is always on: a ``# graftlint: disable=`` comment
or a baseline entry that no longer suppresses any live finding is a
warning (so ``--strict`` fails on it); ``--prune-baseline`` rewrites the
baseline keeping only live entries. ``perf-`` and ``shard-`` baseline
entries are judged only by a run of their audit, are exempt when their
program could not be modeled here, and a lint-only ``--write-baseline``
keeps them.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .deviceaudit import MANIFEST_NAME as DEFAULT_MANIFEST
from .findings import ERROR
from .lint import (STALE_BASELINE, Finding, baseline_entries_for_rules,
                   load_baseline, prune_baseline, run_lint,
                   write_baseline)

DEFAULT_BASELINE = ".graftlint-torch-baseline.json"


def _replay(path: str) -> int:
    from .graftrace import explore

    try:
        trace = json.loads(Path(path).read_text(encoding="utf-8"))
    except (OSError, json.JSONDecodeError) as exc:
        print(f"cannot read trace {path}: {exc}", file=sys.stderr)
        return 2
    rt = explore.replay_trace(trace)
    issues = len(rt.detector.races) + len(rt.deadlocks) + len(rt.errors)
    if rt.divergence is not None:
        # A divergent replay proves nothing either way: the code under
        # test changed since the trace was recorded. Fail loudly so a
        # script gating on the exit code never gets a false green.
        print(f"replay DIVERGED at decision {rt.divergence}: the code "
              "under test no longer follows the recorded schedule — "
              "re-explore with --race instead")
        issues += 1
    print(f"replayed {trace.get('scenario')} "
          f"({len(rt.decision_log)} decisions, divergence="
          f"{rt.divergence}): {len(rt.detector.races)} race(s), "
          f"{len(rt.deadlocks)} deadlock(s), {len(rt.errors)} "
          "invariant failure(s)")
    for race in rt.detector.races:
        print(f"  race on {race['var']} ({race['kind']})")
    for name, exc in rt.errors:
        print(f"  {name}: {type(exc).__name__}: {exc}")
    return 1 if issues else 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m bucketeer_tpu_torch.analysis",
        description="host lint, ABI cross-check and race explorer for "
                    "the PyTorch port")
    parser.add_argument("paths", nargs="*",
                        help="package directories to lint (default: the "
                             "bucketeer_tpu_torch package)")
    parser.add_argument("--strict", action="store_true",
                        help="warnings also fail the run")
    parser.add_argument("--baseline", default=None,
                        help=f"baseline file (default: {DEFAULT_BASELINE} "
                             "next to the linted package, if present)")
    parser.add_argument("--write-baseline", action="store_true",
                        help="record current findings as the baseline "
                             "and exit 0")
    parser.add_argument("--prune-baseline", action="store_true",
                        help="rewrite the baseline dropping entries that "
                             "no longer suppress a live finding")
    parser.add_argument("--audit", action="store_true",
                        help="run every registered device program under "
                             "the dispatch recorder: float64, host syncs "
                             "and device-to-host copies outside the "
                             "sanctioned functions fail, and so does "
                             "manifest drift")
    parser.add_argument("--audit-device", default="cuda",
                        choices=("cpu", "cuda"),
                        help="device the audited programs run on "
                             "(default cuda, which also runs the "
                             "hand-written kernels and counts the "
                             "device-to-host copies; cpu skips the "
                             "kernels and counts no copies); also the "
                             "device of --cost, --mesh-audit and "
                             "--write-manifest")
    parser.add_argument("--manifest", default=None,
                        help="program manifest file (default: "
                             f"{DEFAULT_MANIFEST} next to the package)")
    parser.add_argument("--write-manifest", action="store_true",
                        help="regenerate the program manifest from the "
                             "registered programs and exit 0")
    parser.add_argument("--dump-dir", default=None,
                        help="on audit failure, write every program's "
                             "op histogram here")
    parser.add_argument("--cost", action="store_true",
                        help="cost model (graftcost): flops, device-"
                             "memory bytes, launches, intensity, serial "
                             "chain and peak live bytes of every "
                             "registered program; fire the perf-* rules")
    parser.add_argument("--machine", default=None,
                        choices=["h100", "cpu"],
                        help="machine model for the roofline "
                             "(default: h100)")
    parser.add_argument("--cost-report", default=None,
                        help="write the machine-readable cost report "
                             "(per-program modeled cost + roofline + "
                             "padding waste) to this JSON file")
    parser.add_argument("--mesh-audit", action="store_true",
                        help="mesh audit (graftmesh): run every "
                             "registered mesh program on eight entries "
                             "of the audit device, price what crosses "
                             "between entries, fire the shard-* rules "
                             "and diff the mesh manifest section")
    parser.add_argument("--race", action="store_true",
                        help="explore scheduler/cache interleavings "
                             "under the graftrace controlled scheduler "
                             "and report data races, lock inversions "
                             "and deadlocks")
    parser.add_argument("--race-schedules", type=int, default=120,
                        help="interleavings per scenario (default 120; "
                             "half systematic DFS, half seeded random)")
    parser.add_argument("--race-seed", type=int, default=0,
                        help="base seed for the random-walk schedules "
                             "(default 0); reruns with the same seed "
                             "explore byte-identical schedules")
    parser.add_argument("--race-preemptions", type=int, default=2,
                        help="preemption bound for the systematic "
                             "phase (default 2)")
    parser.add_argument("--race-budget-s", type=float, default=240.0,
                        help="wall-clock budget for the whole "
                             "exploration (default 240s; exhaustion is "
                             "reported, never silent)")
    parser.add_argument("--race-scenarios", default=None,
                        help="comma-separated scenario names (default: "
                             "the non-synthetic suite)")
    parser.add_argument("--race-trace-dir", default=None,
                        help="write the failing schedule traces here "
                             "as JSON")
    parser.add_argument("--race-summary-json", default=None,
                        help="write the exploration summary (counts "
                             "per scenario, crosscheck) to this file")
    parser.add_argument("--race-replay", default=None,
                        help="re-execute one recorded schedule trace "
                             "file bit-for-bit and report what it "
                             "finds")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="machine-readable output")
    args = parser.parse_args(argv)

    if args.paths:
        roots = [Path(p) for p in args.paths]
    else:
        roots = [Path(__file__).resolve().parent.parent]
    for root in roots:
        if not root.is_dir():
            print(f"not a directory: {root}", file=sys.stderr)
            return 2

    if args.race_replay:
        return _replay(args.race_replay)

    # One baseline file for the whole invocation (explicit --baseline,
    # else next to the first root) so a --write-baseline round trip
    # covers every linted root.
    baseline_path = (Path(args.baseline) if args.baseline
                     else roots[0].parent / DEFAULT_BASELINE)
    manifest_path = (Path(args.manifest) if args.manifest
                     else roots[0].parent / DEFAULT_MANIFEST)

    # The device layers share one run of the registry: --audit, --cost
    # and --write-manifest all read the same run_programs() facts.
    facts = mesh_facts = None
    if args.audit or args.cost or args.write_manifest or args.mesh_audit:
        from . import deviceaudit

        try:
            device = deviceaudit.device_type(args.audit_device)
        except RuntimeError as exc:         # the card, and no CUDA
            print(str(exc), file=sys.stderr)
            return 2
        if args.audit or args.cost or args.write_manifest:
            facts = deviceaudit.run_programs(args.audit_device)
        if args.mesh_audit:
            from . import graftmesh
            mesh_facts = graftmesh.run_mesh_programs(args.audit_device)

    if args.write_manifest:
        from . import graftmesh
        new = deviceaudit.manifest_from_facts(facts)
        keys = ("programs",)
        if mesh_facts is not None:
            new[graftmesh.MESH_MANIFEST_KEY] = \
                graftmesh.mesh_manifest_from_facts(mesh_facts)
            keys += (graftmesh.MESH_MANIFEST_KEY,)
        # Sections not run this time (--write-manifest without
        # --mesh-audit) are carried over, not dropped.
        manifest = deviceaudit.merge_manifest(
            deviceaudit.load_manifest(manifest_path), new, device, keys)
        deviceaudit.write_manifest(manifest_path, manifest)
        print(f"wrote {len(new['programs'])} program(s) and "
              f"{len(new.get(graftmesh.MESH_MANIFEST_KEY, {}))} mesh "
              f"program(s) of {device} to {manifest_path}")
        for f in facts + (mesh_facts or []):
            if f.skipped:
                print(f"  skipped {f.name}: {f.skipped}")
        return 0

    baseline = (set() if args.write_baseline
                else load_baseline(baseline_path)
                if baseline_path.exists() else set())
    used_baseline: set = set()
    findings = []
    for root in roots:
        findings += run_lint(root, baseline=baseline,
                             used_baseline=used_baseline)

    # perf-* baseline entries are only exercised by the cost model: a
    # lint-only run can neither judge them stale, prune them, nor drop
    # them from a rewritten baseline; a cost run additionally exempts
    # entries naming programs it could not model here. shard-* entries
    # get the same treatment under --mesh-audit.
    perf_entries = baseline_entries_for_rules(baseline_path, "perf-")
    shard_entries = baseline_entries_for_rules(baseline_path, "shard-")
    exempt_fps: set = set()
    if not args.cost:
        exempt_fps = {e["fingerprint"] for e in perf_entries}
    if not args.mesh_audit:
        exempt_fps |= {e["fingerprint"] for e in shard_entries}

    machine = None
    if args.cost or args.mesh_audit:
        from . import graftcost
        machine = graftcost.MACHINES[args.machine
                                     or graftcost.DEFAULT_MACHINE]

    if args.cost:
        from . import rules_perf
        costs = [f.cost for f in facts if f.cost is not None]
        for f in rules_perf.run(costs, machine):
            if f.fingerprint() in baseline:
                used_baseline.add(f.fingerprint())
                continue
            findings.append(f)
        unmodeled = [f.name for f in facts if f.cost is None]
        exempt_fps |= {e["fingerprint"] for e in perf_entries
                       if any(name in str(e.get("path", ""))
                              for name in unmodeled)}
        if args.cost_report:
            Path(args.cost_report).write_text(
                json.dumps(graftcost.cost_report(facts, machine),
                           indent=2) + "\n", encoding="utf-8")
        if not args.as_json:
            for c in costs:
                print(graftcost.render_cost_line(c, machine))
            if unmodeled:
                print(f"graftcost: {len(unmodeled)} program(s) not "
                      f"modeled here: {unmodeled}")

    if args.mesh_audit:
        from . import graftmesh, rules_shard
        for f in rules_shard.run(mesh_facts):
            if f.fingerprint() in baseline:
                used_baseline.add(f.fingerprint())
                continue
            findings.append(f)
        mesh_skipped = [f.name for f in mesh_facts if f.skipped]
        exempt_fps |= {e["fingerprint"] for e in shard_entries
                       if any(name in str(e.get("path", ""))
                              for name in mesh_skipped)}
        ran_mesh = [f for f in mesh_facts if not f.skipped]
        if len(ran_mesh) < 3:
            findings.append(Finding(
                graftmesh.MESH_DRIFT, "<graftmesh>", 1,
                f"only {len(ran_mesh)} mesh program(s) ran — the audit "
                "needs the registry to cover the sharded paths "
                f"(skipped: {mesh_skipped})", ERROR))
        mesh_drift = graftmesh.diff_mesh_manifest(
            deviceaudit.load_manifest(manifest_path),
            graftmesh.mesh_manifest_from_facts(mesh_facts),
            skipped=tuple(mesh_skipped), device=device)
        for line in mesh_drift:
            findings.append(Finding(graftmesh.MESH_DRIFT,
                                    str(manifest_path), 1, line, ERROR))
        if not args.as_json:
            for f in ran_mesh:
                print(graftmesh.render_mesh_line(f, machine))
            if mesh_skipped:
                print(f"graftmesh: {len(mesh_skipped)} program(s) not "
                      f"run here: {mesh_skipped}")
        if mesh_drift and args.dump_dir:
            graftmesh.dump_mesh(args.dump_dir, mesh_facts)

    if args.write_baseline:
        keep = list(() if args.cost else perf_entries)
        keep += list(() if args.mesh_audit else shard_entries)
        write_baseline(baseline_path, findings, keep_entries=keep)
        print(f"wrote {len(findings) + len(keep)} finding(s) to "
              f"{baseline_path}")
        return 0

    stale = baseline - used_baseline - exempt_fps
    if stale and args.prune_baseline:
        dropped = prune_baseline(baseline_path,
                                 used_baseline | exempt_fps)
        print(f"pruned {dropped} stale entr{'y' if dropped == 1 else 'ies'} "
              f"from {baseline_path}")
    elif stale:
        for fp in sorted(stale):
            findings.append(Finding(
                STALE_BASELINE, str(baseline_path), 1,
                f"baseline fingerprint {fp} matches no live finding — "
                "prune it with --prune-baseline", "warning"))

    if args.audit:
        audit_findings, _ = deviceaudit.run_audit(
            args.audit_device, package_root=roots[0],
            manifest_path=manifest_path, facts=facts,
            dump_dir=args.dump_dir)
        findings += audit_findings
        if not args.as_json:
            for f in facts:
                print(deviceaudit.render(f))

    if args.race:
        from .graftrace import explore

        scenario_names = (args.race_scenarios.split(",")
                          if args.race_scenarios else None)
        try:
            race_findings, summary = explore.run_race(
                roots[0], scenario_names=scenario_names,
                schedules=args.race_schedules, seed=args.race_seed,
                preemption_bound=args.race_preemptions,
                budget_s=args.race_budget_s,
                trace_dir=args.race_trace_dir)
        except ValueError as exc:
            print(str(exc), file=sys.stderr)
            return 2
        findings += race_findings
        if args.race_summary_json:
            Path(args.race_summary_json).write_text(
                json.dumps(summary, indent=2) + "\n", encoding="utf-8")
        if not args.as_json:
            print(f"graftrace: explored {summary['interleavings']} "
                  f"interleavings over {len(summary['scenarios'])} "
                  f"scenario(s) (seed {summary['seed']}, preemption "
                  f"bound {summary['preemption_bound']}) — "
                  f"{summary['races']} race(s), "
                  f"{summary['lock_cycles']} lock cycle(s), "
                  f"{summary['deadlocks']} deadlock(s), "
                  f"{summary['invariant_failures']} invariant "
                  f"failure(s), {summary['divergences']} divergence(s)")

    if args.as_json:
        print(json.dumps([{
            "rule": f.rule, "path": f.path, "line": f.line,
            "severity": f.severity, "message": f.message,
            "fingerprint": f.fingerprint(),
        } for f in findings], indent=2))
    else:
        for f in findings:
            print(f.render())

    errors = sum(1 for f in findings if f.severity == ERROR)
    warnings = len(findings) - errors
    if findings and not args.as_json:
        print(f"graftlint: {errors} error(s), {warnings} warning(s)")
    if errors or (args.strict and warnings):
        return 1
    if not findings and not args.as_json:
        print("graftlint: clean" + (" (audit passed)" if args.audit
                                    else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
