"""graftlint CLI over the port: ``python -m bucketeer_tpu_torch.analysis
[--strict] [--baseline FILE] [--race ...] [--race-replay FILE] [--json]
[paths]``.

Exit codes: 0 clean (in non-strict mode, warnings alone stay clean),
1 findings, 2 bad invocation.

The lint runs the host rules and the ABI cross-check (:mod:`.lint`)
over the package (or ``paths``). ``--race`` adds the dynamic layer
(graftrace): the serving core's scenario suite is executed under the
controlled scheduler, exploring interleavings systematically (bounded
preemptions) and by seeded random walk within ``--race-budget-s``;
data races, lock-inversion cycles, deadlocks and broken scenario
invariants become findings, each carrying the schedule that produced
it (``--race-trace-dir`` persists the traces, ``--race-replay FILE``
re-executes one bit-for-bit).

Suppression hygiene is always on: a ``# graftlint: disable=`` comment
or a baseline entry that no longer suppresses any live finding is a
warning (so ``--strict`` fails on it).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .findings import ERROR
from .lint import STALE_BASELINE, Finding, load_baseline, run_lint

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
    # else next to the first root).
    baseline_path = (Path(args.baseline) if args.baseline
                     else roots[0].parent / DEFAULT_BASELINE)
    baseline = (load_baseline(baseline_path)
                if baseline_path.exists() else set())
    used_baseline: set = set()
    findings = []
    for root in roots:
        findings += run_lint(root, baseline=baseline,
                             used_baseline=used_baseline)
    for fp in sorted(baseline - used_baseline):
        findings.append(Finding(
            STALE_BASELINE, str(baseline_path), 1,
            f"baseline fingerprint {fp} matches no live finding — "
            "remove it from the baseline", "warning"))

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
        print("graftlint: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
