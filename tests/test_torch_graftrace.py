"""The race explorer and the lock-order rule over the PyTorch port's
serving core: the port copies of tests/test_graftrace.py (runtime and
detector mechanics), tests/test_graftrace_scenarios.py (the scenario
suite over the port's EncodeScheduler, reader caches, Metrics and span
recorder) and tests/test_rules_lockorder.py, plus the pinned-schedule
regressions of tests/test_scheduler_shutdown.py and
tests/test_scheduler_pool.py. Every exploration runs the port's own
objects on a "cpu" pool with the device launch stubbed."""
import json
import textwrap
from pathlib import Path

import pytest

from bucketeer_tpu_torch.analysis import lint, rules_lockorder
from bucketeer_tpu_torch.analysis.__main__ import main as cli_main
from bucketeer_tpu_torch.analysis.graftrace import explore, scenarios, seam
from bucketeer_tpu_torch.analysis.graftrace.explore import run_schedule
from bucketeer_tpu_torch.analysis.graftrace.runtime import (GuidedStrategy,
                                                            RandomStrategy)

REPO = Path(__file__).resolve().parent.parent
PKG = str(REPO / "bucketeer_tpu_torch")


class Box:
    def __init__(self):
        self.value = 0


# --- serialization + determinism ---------------------------------------

def _bump_scenario(ctl, sync: bool):
    lock = seam.make_lock("Box._lock")
    box = Box()

    def bump():
        if sync:
            with lock:
                seam.write(box, "value")
                box.value += 1
        else:
            seam.write(box, "value")
            box.value += 1

    threads = [ctl.spawn(bump, f"bump{i}") for i in range(3)]
    for t in threads:
        t.join()
    return box


def test_run_is_deterministic_for_a_seed():
    runs = [run_schedule(lambda ctl: _bump_scenario(ctl, True),
                         RandomStrategy(7)) for _ in range(2)]
    logs = [[d["chosen"] for d in rt.decision_log] for rt in runs]
    assert logs[0] == logs[1]
    assert len(logs[0]) > 10                 # it actually scheduled
    assert all(not rt.detector.races for rt in runs)


def test_different_seeds_explore_different_schedules():
    logs = set()
    for seed in range(6):
        rt = run_schedule(lambda ctl: _bump_scenario(ctl, True),
                          RandomStrategy(seed))
        logs.add(tuple(d["chosen"] for d in rt.decision_log))
    assert len(logs) > 1


def test_unlocked_writes_race_with_both_stacks():
    rt = run_schedule(lambda ctl: _bump_scenario(ctl, False),
                      RandomStrategy(0))
    assert rt.detector.races
    race = rt.detector.races[0]
    assert race["var"] == "Box.value"
    # Both sides carry a stack into this test file.
    assert any("test_torch_graftrace" in f
               for f, _, _ in race["a"]["stack"])
    assert any("test_torch_graftrace" in f
               for f, _, _ in race["b"]["stack"])


def test_lock_ordered_writes_are_clean_across_seeds():
    for seed in range(8):
        rt = run_schedule(lambda ctl: _bump_scenario(ctl, True),
                          RandomStrategy(seed))
        assert rt.detector.races == [], (seed, rt.detector.races)


# --- happens-before edges ----------------------------------------------

def test_event_set_wait_orders_accesses():
    def scn(ctl):
        box = Box()
        ev = seam.make_event("ready")

        def writer():
            seam.write(box, "value")
            box.value = 42
            ev.set()

        def reader():
            ev.wait()
            seam.read(box, "value")
            assert box.value == 42

        t1 = ctl.spawn(writer, "writer")
        t2 = ctl.spawn(reader, "reader")
        t1.join()
        t2.join()

    for seed in range(8):
        rt = run_schedule(scn, RandomStrategy(seed))
        assert rt.detector.races == [], (seed, rt.detector.races)
        assert rt.errors == []


def test_fork_join_orders_accesses():
    def scn(ctl):
        box = Box()
        seam.write(box, "value")
        box.value = 1                      # before fork: ordered

        def child():
            seam.write(box, "value")
            box.value = 2

        t = ctl.spawn(child, "child")
        t.join()
        seam.read(box, "value")            # after join: ordered
        assert box.value == 2

    for seed in range(6):
        rt = run_schedule(scn, RandomStrategy(seed))
        assert rt.detector.races == [], (seed, rt.detector.races)
        assert rt.errors == []


def test_condition_wait_notify_roundtrip():
    def scn(ctl):
        cv = seam.make_condition("cv")
        box = Box()

        def producer():
            with cv:
                seam.write(box, "value")
                box.value = 7
                cv.notify_all()

        def consumer():
            with cv:
                while box.value == 0:
                    if not cv.wait(timeout=1.0):
                        break
                seam.read(box, "value")
                assert box.value == 7

        t2 = ctl.spawn(consumer, "consumer")
        t1 = ctl.spawn(producer, "producer")
        t1.join()
        t2.join()

    for seed in range(6):
        rt = run_schedule(scn, RandomStrategy(seed))
        assert rt.detector.races == [], (seed, rt.detector.races)
        assert rt.errors == [], (seed, rt.errors)


# --- deadlocks + virtual clock -----------------------------------------

def test_self_deadlock_is_reported_not_hung():
    def scn(ctl):
        lk = seam.make_lock("SelfLock")

        def t():
            with lk:
                lk.acquire()               # guaranteed self-deadlock

        th = ctl.spawn(t, "t")
        th.join()

    rt = run_schedule(scn, RandomStrategy(0))
    assert len(rt.deadlocks) == 1
    report = rt.deadlocks[0]
    assert any("lock:SelfLock" in waiting
               for _, waiting, _, _ in report)


def test_ab_ba_deadlock_found_and_deterministic():
    def scn(ctl):
        a = seam.make_lock("A")
        b = seam.make_lock("B")

        def ab():
            with a:
                seam.yield_point("mid")
                with b:
                    pass

        def ba():
            with b:
                seam.yield_point("mid")
                with a:
                    pass

        t1 = ctl.spawn(ab, "ab")
        t2 = ctl.spawn(ba, "ba")
        t1.join()
        t2.join()

    hits = [seed for seed in range(20)
            if run_schedule(scn, RandomStrategy(seed)).deadlocks]
    assert hits, "no seed drove the AB/BA interleaving into deadlock"
    # Same seeds -> same verdicts.
    rehits = [seed for seed in range(20)
              if run_schedule(scn, RandomStrategy(seed)).deadlocks]
    assert hits == rehits


def test_timed_wait_uses_the_virtual_clock():
    seen = {}

    def scn(ctl):
        ev = seam.make_event("never")
        t0 = seam.monotonic()
        assert ev.wait(timeout=3.0) is False
        seen["elapsed"] = seam.monotonic() - t0

    rt = run_schedule(scn, RandomStrategy(0))
    assert rt.errors == []
    assert seen["elapsed"] >= 3.0           # virtual, not wall clock


# --- guided replay -----------------------------------------------------

def test_guided_prefix_forces_a_schedule_and_replays():
    def scn(ctl):
        _bump_scenario(ctl, False)

    base = run_schedule(scn, RandomStrategy(3))
    decisions = [d["chosen"] for d in base.decision_log]
    replay = run_schedule(scn, GuidedStrategy(decisions))
    assert [d["chosen"] for d in replay.decision_log] == decisions
    assert replay.divergence is None
    assert replay.detector.races == base.detector.races


# --- the seeded synthetic bugs (acceptance) -----------------------------

def _explore_synthetic(name, seed):
    return explore.run_race(PKG, scenario_names=[name], schedules=6,
                            seed=seed, budget_s=120)


def test_synthetic_race_detected_and_replays_from_seed():
    f1, s1 = _explore_synthetic("synthetic_race", seed=11)
    f2, s2 = _explore_synthetic("synthetic_race", seed=11)
    assert s1["races"] == 1
    races = [f for f in f1 if f.rule == explore.DYNAMIC_RACE]
    assert len(races) == 1
    assert "Counter.value" in races[0].message
    # Bit-for-bit identical report on re-exploration from the seed.
    assert [f.render() for f in f1] == [f.render() for f in f2]
    assert s1 == s2
    # The static rule cannot see this write; the cross-check says so.
    assert any(f.rule == explore.RACE_LINT_MISMATCH for f in f1)


def test_synthetic_inversion_detected_and_replays_from_seed():
    f1, s1 = _explore_synthetic("synthetic_inversion", seed=5)
    f2, _ = _explore_synthetic("synthetic_inversion", seed=5)
    assert s1["lock_cycles"] == 1
    inv = [f for f in f1 if f.rule == explore.LOCK_INVERSION]
    assert len(inv) == 1
    assert "SyntheticA" in inv[0].message
    assert "SyntheticB" in inv[0].message
    assert [f.render() for f in f1] == [f.render() for f in f2]


def test_replay_trace_reproduces_the_synthetic_race(tmp_path):
    f1, _ = explore.run_race(
        PKG, scenario_names=["synthetic_race"], schedules=4, seed=2,
        budget_s=120, trace_dir=tmp_path)
    traces = sorted(tmp_path.glob("synthetic_race-race-*.json"))
    assert traces, list(tmp_path.iterdir())
    trace = json.loads(traces[0].read_text())
    rt = explore.replay_trace(trace)
    assert rt.divergence is None
    assert len(rt.detector.races) == 1
    assert rt.detector.races[0]["var"] == "Counter.value"


def test_unknown_scenario_is_a_loud_error():
    with pytest.raises(ValueError, match="unknown scenario"):
        explore.run_race(PKG, scenario_names=["nope"], schedules=2,
                         budget_s=10)


# --- the scenario suite over the port's serving core ----------------------

def test_default_suite_covers_the_required_scenarios():
    names = set(scenarios.default_names())
    assert names == {"merged_batch_encode", "read_vs_batch_priority",
                     "queuefull_deadline", "cache_eviction",
                     "shutdown_drain", "tensor_vs_read_priority",
                     "device_pool_storm", "batch_fanout_vs_read",
                     "worker_crash_requeue", "span_ring_concurrency"}
    assert "synthetic_race" not in names
    assert "synthetic_inversion" not in names


def test_scenario_suite_is_clean_small_budget():
    findings, summary = explore.run_race(PKG, schedules=16, seed=0,
                                         budget_s=240)
    assert findings == [], "\n".join(f.render() for f in findings)
    assert summary["races"] == 0
    assert summary["lock_cycles"] == 0
    assert summary["deadlocks"] == 0
    assert summary["invariant_failures"] == 0
    assert summary["interleavings"] == 16 * len(summary["scenarios"])
    # Nondeterminism in a scenario would show up as divergences.
    assert summary["divergences"] == 0
    assert summary["step_overflows"] == 0


def test_exploration_is_deterministic():
    _, s1 = explore.run_race(PKG, schedules=8, seed=42, budget_s=240)
    _, s2 = explore.run_race(PKG, schedules=8, seed=42, budget_s=240)
    assert s1 == s2


def test_crosscheck_validates_scheduler_and_cache_fields():
    """The dynamic explorer and the static rules_locks inference agree:
    the instrumented guarded fields were observed race-free under a
    consistent lockset. An empty intersection here would mean the two
    analyses are talking about different code."""
    _, summary = explore.run_race(PKG, schedules=12, seed=0,
                                  budget_s=240)
    validated = set(summary["crosscheck"]["validated_fields"])
    assert {"EncodeScheduler._djobs", "EncodeScheduler._running",
            "EncodeScheduler._waiting", "Metrics.counters",
            "_DecodeCache._bytes", "_DecodeCache._entries"} <= validated


def test_pinned_schedules_merged_batch_running_snapshot():
    """Pinned regression for the graftrace-found race: the device
    loop's merge heuristics read _running (written under _lock) under
    _dq_cv only. The fixed snapshot takes the lock; these schedules
    flagged the bare read."""
    findings, summary = explore.run_race(
        PKG, scenario_names=["merged_batch_encode"], schedules=40,
        seed=0, budget_s=240)
    assert summary["races"] == 0, \
        "\n".join(f.render() for f in findings)


def test_cli_race_meets_the_500_interleaving_bar(tmp_path):
    """Acceptance: the CLI deterministically explores >= 500
    interleavings of the scenario suite within the CI budget and exits
    clean on the race-free repo."""
    out1 = tmp_path / "s1.json"
    out2 = tmp_path / "s2.json"
    # 52 schedules x 10 scenarios = 520 interleavings: the bar at half
    # the JAX test's 104 per scenario.
    args = ["--race", "--race-schedules", "52", "--race-seed", "0",
            "--race-budget-s", "300"]
    assert cli_main(args + ["--race-summary-json", str(out1)]) == 0
    summary = json.loads(out1.read_text())
    assert summary["interleavings"] >= 500, summary
    assert summary["races"] == 0 and summary["deadlocks"] == 0
    # Determinism of the whole exploration, end to end.
    assert cli_main(args + ["--race-summary-json", str(out2)]) == 0
    assert json.loads(out2.read_text()) == summary


def test_cli_race_synthetic_fails_writes_trace_and_replays(tmp_path,
                                                           capsys):
    traces = tmp_path / "traces"
    rc = cli_main(["--race", "--race-scenarios", "synthetic_race",
                   "--race-schedules", "4", "--race-seed", "1",
                   "--race-budget-s", "120",
                   "--race-trace-dir", str(traces)])
    assert rc == 1
    out = capsys.readouterr().out
    assert "dynamic-race" in out and "Counter.value" in out
    written = sorted(traces.glob("*.json"))
    assert written
    rc = cli_main(["--race-replay", str(written[0])])
    assert rc == 1
    out = capsys.readouterr().out
    assert "race on Counter.value" in out


# --- the static lock-order rule ------------------------------------------

def _run(tmp_path, body):
    root = tmp_path / "pkg"
    (root / "engine").mkdir(parents=True)
    (root / "__init__.py").write_text('"""fixture"""\n')
    (root / "engine" / "__init__.py").write_text('"""fixture"""\n')
    (root / "engine" / "mod.py").write_text(textwrap.dedent(body),
                                            encoding="utf-8")
    return rules_lockorder.run(lint.load_project(root))


def test_nested_with_ab_ba_cycle_fires(tmp_path):
    findings = _run(tmp_path, """\
        import threading


        class Two:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()

            def fwd(self):
                with self._a:
                    with self._b:
                        pass

            def rev(self):
                with self._b:
                    with self._a:
                        pass
        """)
    assert [f.rule for f in findings] == ["lock-order-cycle"]
    msg = findings[0].message
    assert "Two._a" in msg and "Two._b" in msg
    assert "Two.fwd" in msg and "Two.rev" in msg


def test_one_hop_method_call_cycle_fires(tmp_path):
    """The edge hides behind a call: with A held, a method that takes
    B is invoked — and elsewhere the reverse."""
    findings = _run(tmp_path, """\
        import threading


        class Hop:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()

            def fwd(self):
                with self._a:
                    self._take_b()

            def _take_b(self):
                with self._b:
                    pass

            def rev(self):
                with self._b:
                    self._take_a()

            def _take_a(self):
                with self._a:
                    pass
        """)
    assert [f.rule for f in findings] == ["lock-order-cycle"]


def test_consistent_global_order_is_clean(tmp_path):
    findings = _run(tmp_path, """\
        import threading


        class Ordered:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()

            def one(self):
                with self._a:
                    with self._b:
                        pass

            def two(self):
                with self._a:
                    self._take_b()

            def _take_b(self):
                with self._b:
                    pass
        """)
    assert findings == []


def test_nonreentrant_self_reacquire_fires(tmp_path):
    findings = _run(tmp_path, """\
        import threading


        class Oops:
            def __init__(self):
                self._lock = threading.Lock()

            def outer(self):
                with self._lock:
                    with self._lock:
                        pass
        """)
    assert [f.rule for f in findings] == ["lock-order-cycle"]
    assert "self-deadlock" in findings[0].message


def test_class_body_assign_lock_is_inferred(tmp_path):
    """Plain (unannotated) class-attribute lock fields must feed the
    same inference — rules_locks handles them, so this rule must too."""
    findings = _run(tmp_path, """\
        import threading


        class Attr:
            _lock = threading.Lock()

            def outer(self):
                with self._lock:
                    with self._lock:
                        pass
        """)
    assert [f.rule for f in findings] == ["lock-order-cycle"]
    assert "self-deadlock" in findings[0].message


def test_reentrant_self_reacquire_is_clean(tmp_path):
    findings = _run(tmp_path, """\
        import threading


        class Fine:
            def __init__(self):
                self._lock = threading.RLock()
                self._cv = threading.Condition()

            def outer(self):
                with self._lock:
                    with self._lock:
                        pass
                with self._cv:
                    with self._cv:
                        pass
        """)
    assert findings == []


def test_module_level_lock_cycle_fires(tmp_path):
    findings = _run(tmp_path, """\
        import threading

        A = threading.Lock()
        B = threading.Lock()


        def fwd():
            with A:
                with B:
                    pass


        def rev():
            with B:
                with A:
                    pass
        """)
    assert [f.rule for f in findings] == ["lock-order-cycle"]
    assert "pkg/engine/mod.py:A" in findings[0].message


def test_seam_factory_locks_are_recognized(tmp_path):
    findings = _run(tmp_path, """\
        from bucketeer_tpu_torch.analysis.graftrace import seam


        class Traced:
            def __init__(self):
                self._a = seam.make_lock("Traced._a")
                self._b = seam.make_condition("Traced._b")

            def fwd(self):
                with self._a:
                    with self._b:
                        pass

            def rev(self):
                with self._b:
                    with self._a:
                        pass
        """)
    assert [f.rule for f in findings] == ["lock-order-cycle"]


def test_nested_def_does_not_inherit_held_locks(tmp_path):
    findings = _run(tmp_path, """\
        import threading


        class Box:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()

            def fwd(self):
                with self._a:
                    def later():
                        with self._b:
                            pass
                    return later

            def rev(self):
                with self._b:
                    pass

            def other(self):
                with self._b:
                    self._take_a_free()

            def _take_a_free(self):
                pass
        """)
    assert findings == []


# --- the repo gate ------------------------------------------------------

def test_repo_is_cycle_free():
    project = lint.load_project(REPO / "bucketeer_tpu_torch")
    findings = rules_lockorder.run(project)
    assert findings == [], "\n".join(f.render() for f in findings)


def test_repo_scheduler_cv_to_lock_edge_is_seen():
    """The device loop holds _dq_cv and snapshots _running under _lock
    (the graftrace-driven fix): the rule must see that nesting through
    the one-hop call, or the repo gate above is vacuous."""
    project = lint.load_project(REPO / "bucketeer_tpu_torch")
    edges: dict = {}
    for mod in project.modules:
        if mod.relpath.endswith("engine/scheduler.py"):
            rules_lockorder._collect_edges(mod, edges)
    assert ("EncodeScheduler._dq_cv", "EncodeScheduler._lock") in edges
    assert ("EncodeScheduler._lock", "EncodeScheduler._dq_cv") \
        not in edges


# --- pinned-schedule regressions ----------------------------------------

@pytest.mark.parametrize("name", ["shutdown_drain", "device_pool_storm"])
@pytest.mark.parametrize("seed", [0, 1])
def test_graftrace_pinned_schedules(name, seed):
    """Pinned-schedule sweeps of the JAX package's regression fixtures:
    shutdown_drain (the exploration that deadlocked a close() which
    never woke queued slot waiters, and caught a resurrected device
    thread) and device_pool_storm (fatal worker replacement,
    cross-worker priority order, close-drain over a 4-device pool)
    replay clean on the port. Deterministic per seed."""
    findings, summary = explore.run_race(
        PKG, scenario_names=[name], schedules=24, seed=seed,
        budget_s=240)
    assert findings == [], "\n".join(f.render() for f in findings)
    assert summary["deadlocks"] == 0
    assert summary["invariant_failures"] == 0
    assert summary["races"] == 0
