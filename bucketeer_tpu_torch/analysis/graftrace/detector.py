"""Happens-before race detection + dynamic lock-order recording.

Vector clocks, FastTrack-style epochs:

- every thread carries a vector clock ``vc``; fork/join and each sync
  object (lock release->acquire, event set->wait) join clocks in the
  standard way;
- per instrumented variable the detector keeps the last write as an
  epoch ``(tid, clock)`` plus all reads since that write; an access not
  ordered after the stored epoch(s) is a race, reported with *both*
  stack traces and the locks each side held.

Because the controlled scheduler serializes execution, races are found
logically (missing happens-before), not by lucky timing — one explored
schedule is enough to prove the race exists in *every* schedule that
lacks the ordering.

The detector also maintains the dynamic lock-acquisition-order graph:
an edge ``A -> B`` is recorded when a thread *attempts* B while holding
A (attempt, not success, so an actually-deadlocked schedule still
records both halves of the inversion). Cycles in the aggregated graph
are deadlock potential even when no explored schedule happened to
deadlock — the dynamic twin of the static ``lock-order-cycle`` rule.

Eraser-style locksets ride along per variable (the intersection of
locks held across all accesses); they don't gate race reports, but the
cross-check uses them to validate the static ``rules_locks`` inference
against observed behavior.
"""
from __future__ import annotations


def _join(a: dict, b: dict) -> dict:
    if not b:
        return a
    out = dict(a)
    for k, v in b.items():
        if out.get(k, 0) < v:
            out[k] = v
    return out


class VarState:
    __slots__ = ("owner", "display", "write_tid", "write_clock",
                 "write_stack", "write_thread", "write_locks", "reads",
                 "lockset")

    def __init__(self, owner, display: str):
        # Keep the owner alive for the run so id() reuse can't alias
        # two different objects onto one variable.
        self.owner = owner
        self.display = display
        self.write_tid = None
        self.write_clock = 0
        self.write_stack = ()
        self.write_thread = ""
        self.write_locks = ()
        self.reads: dict = {}   # tid -> (clock, stack, thread, locks)
        self.lockset = None     # intersection of locks held at accesses


class RaceDetector:
    def __init__(self):
        self.vars: dict = {}          # (id(owner), field) -> VarState
        self.races: list = []         # race dicts, deduped per run
        self._race_keys: set = set()
        self.lock_edges: dict = {}    # (held, acquired) -> edge info

    # -- happens-before bookkeeping ------------------------------------

    def init_thread(self, st):
        st.vc = {st.tid: 1}

    def fork(self, parent, child):
        child.vc = dict(parent.vc)
        child.vc[child.tid] = 1
        parent.vc[parent.tid] = parent.vc.get(parent.tid, 0) + 1

    def on_join(self, st, target):
        st.vc = _join(st.vc, target.vc)

    def finish(self, st):
        pass

    def on_acquire_attempt(self, st, lock):
        for held in st.held:
            # Same object = RLock-style reentry, not an ordering edge.
            # Distinct locks *sharing* a name (two instances of one
            # class) are kept: the name-graph self-loop they produce is
            # a real finding — no consistent order exists by name.
            if held is lock:
                continue
            key = (held.name, lock.name)
            if key not in self.lock_edges:
                from .runtime import app_stack
                self.lock_edges[key] = {
                    "held": held.name,
                    "acquired": lock.name,
                    "thread": st.name,
                    "stack": app_stack(skip=3),
                }

    def on_acquire(self, st, lock):
        st.vc = _join(st.vc, lock.vc)

    def on_release(self, st, lock):
        lock.vc = _join(lock.vc, st.vc)
        st.vc[st.tid] = st.vc.get(st.tid, 0) + 1

    def on_event_set(self, st, ev):
        ev.vc = _join(ev.vc, st.vc)
        st.vc[st.tid] = st.vc.get(st.tid, 0) + 1

    def on_event_wait(self, st, ev):
        st.vc = _join(st.vc, ev.vc)

    # -- the access check ----------------------------------------------

    def on_access(self, st, owner, field, is_write, stack):
        key = (id(owner), field)
        var = self.vars.get(key)
        if var is None:
            var = self.vars[key] = VarState(
                owner, f"{type(owner).__name__}.{field}")
        locks = tuple(lk.name for lk in st.held)
        lockset = set(locks)
        var.lockset = (lockset if var.lockset is None
                       else var.lockset & lockset)

        if var.write_tid is not None and var.write_tid != st.tid and \
                st.vc.get(var.write_tid, 0) < var.write_clock:
            self._report(var, "write-read" if not is_write
                         else "write-write",
                         prior=("write", var.write_thread,
                                var.write_stack, var.write_locks),
                         now=("write" if is_write else "read",
                              st.name, stack, locks))
        if is_write:
            for rtid, (rclock, rstack, rname, rlocks) in \
                    var.reads.items():
                if rtid != st.tid and st.vc.get(rtid, 0) < rclock:
                    self._report(var, "read-write",
                                 prior=("read", rname, rstack, rlocks),
                                 now=("write", st.name, stack, locks))
            var.write_tid = st.tid
            var.write_clock = st.vc.get(st.tid, 0)
            var.write_stack = stack
            var.write_thread = st.name
            var.write_locks = locks
            var.reads = {}
        else:
            var.reads[st.tid] = (st.vc.get(st.tid, 0), stack, st.name,
                                 locks)

    def _report(self, var, kind, prior, now):
        def top(stack):
            return stack[0] if stack else ("?", 0, "?")

        key = (var.display, kind,
               frozenset((top(prior[2]), top(now[2]))))
        if key in self._race_keys:
            return
        self._race_keys.add(key)
        self.races.append({
            "var": var.display,
            "kind": kind,
            "a": {"access": prior[0], "thread": prior[1],
                  "stack": prior[2], "locks": list(prior[3])},
            "b": {"access": now[0], "thread": now[1],
                  "stack": now[2], "locks": list(now[3])},
        })


def find_lock_cycles(edges: dict) -> list:
    """Cycles in the aggregated lock-order graph. ``edges`` maps
    ``(held, acquired)`` to edge info; returns a list of cycles, each a
    dict with the canonical node tuple and the recorded edge info (one
    stack per edge). Deterministic: nodes visited in sorted order."""
    graph: dict = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)
    cycles = []
    seen_cycles = set()

    def canonical(path):
        i = path.index(min(path))
        return tuple(path[i:] + path[:i])

    def dfs(node, path, on_path, visited):
        on_path.add(node)
        path.append(node)
        for nxt in sorted(graph.get(node, ())):
            if nxt in on_path:
                cyc = canonical(path[path.index(nxt):])
                if cyc not in seen_cycles:
                    seen_cycles.add(cyc)
                    cyc_edges = []
                    nodes = list(cyc) + [cyc[0]]
                    for a, b in zip(nodes, nodes[1:]):
                        info = edges.get((a, b))
                        if info is not None:
                            cyc_edges.append(info)
                    cycles.append({"nodes": cyc, "edges": cyc_edges})
            elif nxt not in visited:
                dfs(nxt, path, on_path, visited)
        on_path.discard(node)
        path.pop()
        visited.add(node)

    visited: set = set()
    for node in sorted(graph):
        if node not in visited:
            dfs(node, [], set(), visited)
    return cycles
