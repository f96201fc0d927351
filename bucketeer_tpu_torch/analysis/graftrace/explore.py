"""The interleaving explorer: budgeted systematic + random schedule
search, aggregation into findings, schedule traces and replay.

Exploration per scenario is two-phase:

1. **Systematic (CHESS-style)**: depth-first over the schedule tree
   with a preemption bound. The first run uses the default rule
   (continue the current thread; switch only when it blocks); every
   decision point then seeds children that force one alternative
   thread at that point, skipping children whose forced switch would
   exceed the preemption budget. Exhausting the frontier means the
   scenario is *fully explored* at that bound.
2. **Seeded random**: the remaining schedule budget runs a uniform
   random walk per seed (`seed`, `seed+1`, ...), unbounded in
   preemptions — cheap coverage of deep interleavings the bound
   excludes.

Every run is captured as a **trace** (`scenario`, mode, seed, the full
chosen-thread decision list); any race/deadlock/invariant finding
carries its trace, `--race-trace-dir` persists them as JSON, and
:func:`replay_trace` re-executes one bit-for-bit — same stacks, same
report — which is what makes a schedule-dependent bug a regression
fixture instead of a flake.

Nothing is silently capped: truncated DFS frontiers, step-overflow
runs, replay divergences and budget exhaustion are all counted in the
summary.
"""
from __future__ import annotations

import json
import time
from pathlib import Path

from ..findings import ERROR, WARNING, Finding
from . import seam
from .detector import RaceDetector, find_lock_cycles
from .runtime import (GuidedStrategy, RandomStrategy, TracedThread,
                      TraceRuntime)

DYNAMIC_RACE = "dynamic-race"
LOCK_INVERSION = "lock-inversion"
SCHEDULE_DEADLOCK = "schedule-deadlock"
SCENARIO_INVARIANT = "scenario-invariant"
RACE_LINT_MISMATCH = "race-lint-mismatch"

_FRONTIER_CAP = 4096


class Ctl:
    """Handle scenarios use to spawn controlled threads."""

    def __init__(self, rt: TraceRuntime):
        self.rt = rt

    def spawn(self, fn, name: str) -> TracedThread:
        t = TracedThread(self.rt, fn, name)
        t.start()
        return t


def run_schedule(scenario_fn, strategy, max_steps: int = 50000
                 ) -> TraceRuntime:
    """Execute one controlled run of a scenario under ``strategy``.

    Any graftscope recorder installed by the surrounding process (a
    test that booted the server, say) is parked for the run: its locks
    were created *before* the runtime, so a controlled thread holding
    one across a yield point would block its sibling for real — a
    hang the explorer cannot model. Scenarios that want tracing under
    exploration install their own recorder inside the run, whose seam
    locks are controlled."""
    from ... import obs

    rt = TraceRuntime(strategy, RaceDetector(), max_steps)
    prev_rec = obs.get_recorder()
    obs.install(None)
    seam.install(rt)
    try:
        rt.run(lambda: scenario_fn(Ctl(rt)))
    finally:
        seam.install(None)
        obs.install(prev_rec)
    return rt


def _fmt_stack(stack) -> str:
    if not stack:
        return "<no frames>"
    return " <- ".join(f"{f}:{ln} in {fn}" for f, ln, fn in stack[:4])


def _top(stack):
    return stack[0] if stack else ("<unknown>", 1, "?")


class _Aggregate:
    """Dedup + trace bookkeeping across every run of one exploration."""

    def __init__(self):
        self.races: dict = {}        # key -> (race, trace)
        self.deadlocks: dict = {}    # key -> (report, trace)
        self.invariants: dict = {}   # key -> (thread, exc, trace)
        self.lock_edges: dict = {}   # merged dynamic lock-order graph
        self.vars: dict = {}         # display -> {"lockset", "raced"}
        self.divergences = 0
        self.step_overflows = 0

    def collect(self, rt: TraceRuntime, trace: dict):
        trace = dict(trace,
                     decisions=[d["chosen"] for d in rt.decision_log])
        for race in rt.detector.races:
            key = (race["var"], race["kind"],
                   frozenset((_top(race["a"]["stack"]),
                              _top(race["b"]["stack"]))))
            self.races.setdefault(key, (race, trace))
        for dl in rt.deadlocks:
            self.deadlocks.setdefault(dl, trace)
        for name, exc in rt.errors:
            key = (name, type(exc).__name__, str(exc)[:200])
            self.invariants.setdefault(key, (name, exc, trace))
        for key, info in rt.detector.lock_edges.items():
            self.lock_edges.setdefault(key, info)
        for var in rt.detector.vars.values():
            agg = self.vars.setdefault(
                var.display, {"lockset": None, "raced": False})
            if var.lockset is not None:
                agg["lockset"] = (set(var.lockset)
                                  if agg["lockset"] is None
                                  else agg["lockset"] & var.lockset)
        for race in rt.detector.races:
            self.vars.setdefault(
                race["var"], {"lockset": None, "raced": False}
            )["raced"] = True
        if rt.divergence is not None:
            self.divergences += 1
        if rt.step_overflow:
            self.step_overflows += 1


def explore_scenario(name: str, scenario_fn, *, schedules: int,
                     preemption_bound: int, seed: int,
                     deadline: float | None, agg: _Aggregate) -> dict:
    """Run up to ``schedules`` interleavings of one scenario (DFS half,
    random half), collecting into ``agg``. Returns per-scenario stats."""
    dfs_budget = max(1, schedules // 2)
    frontier: list = [()]
    dfs_runs = 0
    frontier_truncated = 0

    def time_left():
        return deadline is None or time.monotonic() < deadline

    while frontier and dfs_runs < dfs_budget and time_left():
        prefix = frontier.pop()
        rt = run_schedule(scenario_fn, GuidedStrategy(prefix))
        dfs_runs += 1
        agg.collect(rt, {"scenario": name, "mode": "dfs",
                         "seed": None, "prefix": list(prefix)})
        log = rt.decision_log
        preempts = 0
        chosen = [d["chosen"] for d in log]
        for i, d in enumerate(log):
            if i >= len(prefix):
                for alt in d["runnable"]:
                    if alt == d["chosen"]:
                        continue
                    is_pre = (alt != d["current"]
                              and d["current"] in d["runnable"])
                    if preempts + (1 if is_pre else 0) > preemption_bound:
                        continue
                    if len(frontier) >= _FRONTIER_CAP:
                        frontier_truncated += 1
                        continue
                    frontier.append(tuple(chosen[:i] + [alt]))
            if d["preempt"]:
                preempts += 1
    fully_explored = not frontier and not frontier_truncated

    random_runs = 0
    while dfs_runs + random_runs < schedules and time_left():
        s = seed + random_runs
        rt = run_schedule(scenario_fn, RandomStrategy(s))
        agg.collect(rt, {"scenario": name, "mode": "random",
                         "seed": s, "prefix": []})
        random_runs += 1

    return {
        "interleavings": dfs_runs + random_runs,
        "dfs": dfs_runs,
        "random": random_runs,
        "fully_explored": fully_explored,
        "frontier_remaining": len(frontier),
        "frontier_truncated": frontier_truncated,
        "budget_exhausted": not time_left(),
    }


def _race_finding(race: dict, trace: dict) -> Finding:
    path, line, _ = _top(race["b"]["stack"])
    msg = (f"data race on {race['var']} ({race['kind']}): "
           f"{race['a']['access']} by {race['a']['thread']} "
           f"[locks {race['a']['locks'] or 'none'}] at "
           f"{_fmt_stack(race['a']['stack'])} is unordered with "
           f"{race['b']['access']} by {race['b']['thread']} "
           f"[locks {race['b']['locks'] or 'none'}] at "
           f"{_fmt_stack(race['b']['stack'])} — "
           f"replay: {_trace_hint(trace)}")
    return Finding(DYNAMIC_RACE, path, line, msg, ERROR)


def _trace_hint(trace: dict) -> str:
    if trace.get("mode") == "random":
        return (f"scenario {trace['scenario']}, random seed "
                f"{trace['seed']}")
    return (f"scenario {trace['scenario']}, dfs prefix of "
            f"{len(trace.get('prefix', []))} forced choice(s)")


def run_race(package_root, *, scenario_names=None, schedules: int = 120,
             seed: int = 0, preemption_bound: int = 2,
             budget_s: float = 240.0, trace_dir=None,
             include_synthetic: bool = False):
    """Explore the scenario suite; returns ``(findings, summary)``.

    ``schedules`` is per scenario; the wall-clock ``budget_s`` caps the
    whole exploration (whatever was not reached is reported in the
    summary, never silently skipped).
    """
    from . import scenarios as scn

    scn.warm_imports()
    names = list(scenario_names) if scenario_names else \
        scn.default_names()
    if include_synthetic and not scenario_names:
        names = list(scn.SCENARIOS)
    unknown = [n for n in names if n not in scn.SCENARIOS]
    if unknown:
        raise ValueError(f"unknown scenario(s): {', '.join(unknown)}; "
                         f"known: {', '.join(sorted(scn.SCENARIOS))}")

    deadline = time.monotonic() + budget_s if budget_s else None
    agg = _Aggregate()
    per_scenario = {}
    for name in names:
        per_scenario[name] = explore_scenario(
            name, scn.SCENARIOS[name]["fn"], schedules=schedules,
            preemption_bound=preemption_bound, seed=seed,
            deadline=deadline, agg=agg)

    findings: list = []
    traces_to_dump: list = []

    for key in sorted(agg.races, key=str):
        race, trace = agg.races[key]
        findings.append(_race_finding(race, trace))
        traces_to_dump.append(("race", race["var"], trace))

    cycles = find_lock_cycles(agg.lock_edges)
    for cyc in cycles:
        edge = cyc["edges"][0] if cyc["edges"] else {}
        path, line, _ = _top(edge.get("stack", ()))
        chain = " -> ".join(cyc["nodes"] + (cyc["nodes"][0],))
        detail = "; ".join(
            f"{e['thread']} took {e['acquired']} while holding "
            f"{e['held']} at {_fmt_stack(e['stack'])}"
            for e in cyc["edges"])
        findings.append(Finding(
            LOCK_INVERSION, path, line,
            f"lock-acquisition-order cycle {chain}: {detail} — "
            "deadlock potential even in schedules that survived",
            ERROR))

    for dl, trace in sorted(agg.deadlocks.items(), key=str):
        threads = "; ".join(
            f"{name} waiting on {wait} holding {list(held) or 'nothing'}"
            f" at {_fmt_stack(stack)}"
            for name, wait, held, stack in dl)
        path, line = "bucketeer_tpu_torch", 1
        for _, _, _, stack in dl:
            if stack:
                path, line, _ = stack[0]
                break
        findings.append(Finding(
            SCHEDULE_DEADLOCK, path, line,
            f"deadlock: every thread blocked — {threads} — "
            f"replay: {_trace_hint(trace)}", ERROR))
        traces_to_dump.append(("deadlock", "all-blocked", trace))

    for key in sorted(agg.invariants, key=str):
        name, exc, trace = agg.invariants[key]
        findings.append(Finding(
            SCENARIO_INVARIANT, f"graftrace/{trace['scenario']}", 1,
            f"scenario invariant broken in thread {name}: "
            f"{type(exc).__name__}: {exc} — replay: "
            f"{_trace_hint(trace)}", ERROR))
        traces_to_dump.append(("invariant", name, trace))

    cross_findings, cross_summary = _crosscheck(agg, package_root)
    findings += cross_findings

    if trace_dir and traces_to_dump:
        out = Path(trace_dir)
        out.mkdir(parents=True, exist_ok=True)
        for i, (kind, what, trace) in enumerate(traces_to_dump):
            p = out / f"{trace['scenario']}-{kind}-{i}.json"
            p.write_text(json.dumps(
                {"kind": kind, "subject": str(what), **trace},
                indent=2) + "\n", encoding="utf-8")

    summary = {
        "interleavings": sum(s["interleavings"]
                             for s in per_scenario.values()),
        "scenarios": per_scenario,
        "races": len(agg.races),
        "lock_cycles": len(cycles),
        "deadlocks": len(agg.deadlocks),
        "invariant_failures": len(agg.invariants),
        "divergences": agg.divergences,
        "step_overflows": agg.step_overflows,
        "seed": seed,
        "preemption_bound": preemption_bound,
        "schedules_per_scenario": schedules,
        "crosscheck": cross_summary,
    }
    return findings, summary


def _crosscheck(agg: _Aggregate, package_root):
    """Validate the dynamic verdicts against the static rules_locks
    inference: a dynamic race on a field the lint believes lock-guarded
    means one of the two analyses is wrong — surface it instead of
    letting them silently disagree."""
    import ast

    from ..lint import load_project
    from ..rules_locks import class_accesses

    guards: dict = {}
    try:
        project = load_project(Path(package_root))
    except OSError:
        return [], {"error": f"cannot load {package_root}"}
    for mod in project.modules:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef):
                locks, accesses = class_accesses(node)
                if locks:
                    guards[node.name] = {
                        attr for attr, accs in accesses.items()
                        if any(a.locked for a in accs)}

    findings = []
    validated = []
    for display, info in sorted(agg.vars.items()):
        cls, _, fieldname = display.partition(".")
        statically_guarded = fieldname in guards.get(cls, ())
        if info["raced"] and statically_guarded:
            findings.append(Finding(
                RACE_LINT_MISMATCH, f"graftrace/{display}", 1,
                f"dynamic race observed on {display}, which the static "
                "unguarded-field-write rule infers to be lock-guarded — "
                "either the lint's inference or the locking is wrong; "
                "reconcile before trusting either analysis", WARNING))
        if not info["raced"] and statically_guarded and info["lockset"]:
            validated.append(display)
    return findings, {
        "static_guarded_classes": sorted(guards),
        "dynamic_fields": sorted(agg.vars),
        "validated_fields": validated,
    }


def replay_trace(trace: dict):
    """Re-execute one recorded schedule bit-for-bit; returns the
    finished TraceRuntime (races, deadlocks, errors, decision_log)."""
    from . import scenarios as scn

    scn.warm_imports()
    name = trace["scenario"]
    if name not in scn.SCENARIOS:
        raise ValueError(f"unknown scenario {name!r}")
    decisions = trace.get("decisions") or trace.get("prefix") or []
    if trace.get("mode") == "random" and not decisions:
        strategy = RandomStrategy(trace["seed"])
    else:
        strategy = GuidedStrategy(decisions)
    return run_schedule(scn.SCENARIOS[name]["fn"], strategy)
