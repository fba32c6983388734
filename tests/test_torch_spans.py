"""Spans and counters of the port's frontier path (`Recorder.section`), on
the CPU.

One `frontier` call is one root section `frontier_dispatch`; every section
inside it names the root as its `query` and the section it was opened in
as its `parent`.  The evaluator evaluates each distinct (T, C) law of a
grid once (λ changes no law, and two policies that lower to one row are
one law): its chunks' `cells` and the counter `evaluator.cells` count the
laws it evaluates, and `evaluator.laws` the grid's laws.  Recording
changes no row.  Sections stamp the epoch clock that torch.profiler's
Chrome export reaches with `baseTimeNanoseconds`.
"""

import json
import math

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from repro_torch import core as tcore
from repro_torch import dag as tdag
from repro_torch import obs
from repro_torch.faults import FaultSpec
from repro_torch.fleet import vector

CPU = "cpu"
X = np.random.default_rng(0).exponential(1.0, 400) + 1.0  # a raw trace: the empirical path
N, N_JOBS, M_TRIALS, C = 40, 16, 2, 2  # n = 40: p 0.05, 0.1 and 0.2 fork at 2, 4 and 8 stragglers
#: shaped like the benchmark's job1.frontier grid: 8 single-fork policies x 4 loads
SINGLE = [tcore.SingleForkPolicy(p, r, keep) for p, r, keep in (
    (0.0, 0, True), (0.05, 1, True), (0.1, 1, True), (0.2, 1, True), (0.1, 2, True),
    (0.1, 1, False), (0.1, 2, False), (0.2, 1, False))]
LAMS4 = (0.05, 0.1, 0.15, 0.2)
#: shaped like job1.general's: delayed relaunch and a two-stage fork x 2 loads
GENERAL = [tcore.BASELINE, tcore.delayed_relaunch(2.0, r=0, keep=False),
           tcore.delayed_relaunch(3.0, r=1, keep=True),
           tcore.MultiForkPolicy(((0.4, 1, True), (0.1, 1, False)))]
LAMS2 = (0.1, 0.2)
#: each section's parent in one frontier call
PARENT = {"frontier.prepare": "frontier_dispatch", "evaluator": "frontier_dispatch",
          "evaluator.draws": "evaluator", "evaluator.chunk": "evaluator", "stats": "frontier_dispatch",
          "queue": "stats", "tails": "frontier_dispatch", "frontier.rows": "frontier_dispatch"}


@pytest.fixture
def rec():
    r = obs.enable(obs.Recorder())
    try:
        yield r
    finally:
        obs.disable()


def _front(policies, lams, **kw):
    return vector.frontier(X, policies, lams, N, N_JOBS, m_trials=M_TRIALS, c=C, device=CPU, **kw)


def _query(rec):
    """(root, the spans of its query) of the one frontier call recorded."""
    roots = rec.spans_named("frontier_dispatch")
    assert len(roots) == 1
    root = roots[0]
    return root, [s for s in rec.spans if s.args["query"] == root.args["id"]]


@pytest.mark.parametrize("grid", ["single", "general"])
def test_one_frontier_call_is_one_tree_of_sections(rec, monkeypatch, grid):
    monkeypatch.setattr(vector, "cell_chunk_size", lambda *a, **k: 3)
    policies, lams = (SINGLE, LAMS4) if grid == "single" else (GENERAL, LAMS2)
    _front(policies, lams)
    root, spans = _query(rec)
    assert len(spans) == len(rec.spans)  # nothing outside the query
    assert root.args["parent"] is None and root.args["query"] == root.args["id"]
    cells, laws = len(policies) * len(lams), len(policies)
    assert {k: root.args[k] for k in ("cells", "laws", "m_trials", "n_jobs", "tail", "chunk")} == dict(
        cells=cells, laws=laws, m_trials=M_TRIALS, n_jobs=N_JOBS, tail="exact", chunk=3)
    assert "padded" not in root.args
    by_id = {s.args["id"]: s for s in spans}
    assert len(by_id) == len(spans)
    for s in spans:
        assert s.pid == obs.PID_PROFILER and s.dur >= 0 and "device_ms" not in s.args
        if s is root:
            continue
        parent = by_id[s.args["parent"]]
        assert parent.name == PARENT[s.name]
        assert parent.ts <= s.ts and s.ts + s.dur <= parent.ts + parent.dur + 1e-6
    names = [s.name for s in spans]
    assert sorted(set(names)) == sorted({"frontier_dispatch", *PARENT})
    chunks = [s for s in spans if s.name == "evaluator.chunk"]
    assert len(chunks) == math.ceil(laws / 3)  # each law once, 3 a chunk
    assert sum(s.args["cells"] for s in chunks) == laws
    (evaluator,) = rec.spans_named("evaluator")
    assert (evaluator.args["cells"], evaluator.args["laws"]) == (cells, laws)
    assert {s.args["path"] for s in chunks} == {"masked" if grid == "single" else "lowered"}
    (queue,) = rec.spans_named("queue")
    assert queue.args["rows"] == cells * M_TRIALS and queue.args["jobs"] == N_JOBS
    assert queue.args["c"] == C and queue.args["path"] == "kw_queue"
    assert {s.cat for s in spans if s.name.startswith("frontier.")} == {"host"}


@pytest.mark.parametrize("grid, cells, laws", [("single", 32, 8), ("general", 8, 4), ("faulty", 8, 4),
                                              ("twins", 4, 1)])
def test_the_evaluator_counts_its_cells_and_their_distinct_laws(rec, grid, cells, laws):
    if grid == "single":
        _front(SINGLE, LAMS4)
    elif grid == "general":
        _front(GENERAL, LAMS2)
    elif grid == "twins":  # a single-fork policy and its algebra twin lower to one row
        _front([SINGLE[2], tcore.as_fork_policy(SINGLE[2])], LAMS2)
    else:  # 2 policies x 2 loads x 2 q: q is part of the law
        _front(SINGLE[1:3], LAMS2, fault=[FaultSpec(q=0.1, max_attempts=3), FaultSpec(q=0.2, max_attempts=3)])
    assert rec.counters == {"frontier.cells": cells, "evaluator.cells": laws, "evaluator.laws": laws}
    root, _ = _query(rec)
    assert (root.args["cells"], root.args["laws"]) == (cells, laws)


def _dag():
    keep = tcore.SingleForkPolicy(0.2, 1, True)
    dag = tdag.JobDAG.map_reduce(8, 4, X, X[::2], map_policy=keep, c_map=2, c_reduce=2)
    return dag, [dag.policies(), (tcore.BASELINE, tcore.BASELINE)]


@pytest.mark.parametrize("engine", ["frontier", "dag_frontier"])
def test_recording_changes_no_row(engine):
    def call():
        if engine == "frontier":
            return _front(SINGLE[:4] + GENERAL[1:3], LAMS2)
        dag, vecs = _dag()
        return tdag.dag_frontier(dag, vecs, LAMS2, N_JOBS, m_trials=M_TRIALS, seed=5, device=CPU)

    off = call()
    rec = obs.enable(obs.Recorder())
    try:
        on = call()
    finally:
        obs.disable()
    assert rec.spans and on == off  # float for float


def test_sections_outside_a_frontier_have_no_query(rec):
    dag, vecs = _dag()
    tdag.dag_frontier(dag, vecs, LAMS2, N_JOBS, m_trials=M_TRIALS, seed=5, device=CPU)
    names = {s.name for s in rec.spans}
    assert {"evaluator", "evaluator.draws", "evaluator.chunk", "queue"} <= names
    assert "frontier_dispatch" not in names
    assert all(s.args["query"] is None for s in rec.spans)
    assert {rec.spans[0].name} <= {"evaluator.draws", "evaluator.chunk"}  # children close first
    # the evaluator counts the laws it evaluates for the DAG too: the map stage's two
    # policies and the reduce stage's one; the grid's laws are the frontier's count
    evaluated = sum(s.args["laws"] for s in rec.spans_named("evaluator"))
    assert evaluated == 3 and rec.counters == {"evaluator.cells": evaluated}
    assert sum(s.args["cells"] for s in rec.spans_named("evaluator.chunk")) == evaluated
    # a root opened later starts its own query and leaves these as they were
    _front(SINGLE[:2], LAMS2)
    root = rec.spans_named("frontier_dispatch")[0]
    assert all(s.args["query"] in (None, root.args["id"]) for s in rec.spans)


def test_program_spans_line_up_with_the_profiler_export(rec, tmp_path):
    """Each program span of the second call against the same-named range of
    the profiler's Chrome export, moved to the epoch by its
    `baseTimeNanoseconds`: start and end within 50 µs."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):  # the first range a profiler records pays its set-up
            _front(SINGLE[:3], LAMS2)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    base_us = doc["baseTimeNanoseconds"] / 1e3
    ranges: dict = {}
    for e in doc["traceEvents"]:
        if e.get("cat") == "cpu_op":
            ranges.setdefault(e["name"], []).append((e["ts"] + base_us, e["ts"] + e["dur"] + base_us))
    root = rec.spans_named("frontier_dispatch")[-1]
    spans = [s for s in rec.spans if s.args["query"] == root.args["id"]]
    assert len(spans) >= 9
    for name in {s.name for s in spans}:
        ours = sorted((s.ts * 1e6, (s.ts + s.dur) * 1e6) for s in spans if s.name == name)
        theirs = sorted(ranges[name])[-len(ours):]
        for (a0, a1), (b0, b1) in zip(ours, theirs):
            assert abs(a0 - b0) <= 50 and abs(a1 - b1) <= 50, (name, a0 - b0, a1 - b1)


def test_a_call_that_raises_closes_its_sections(rec):
    """A query refused in `frontier.prepare` closes its sections on the
    way out: both are recorded, none stays open, and the next call is a
    root of its own."""
    with pytest.raises(ValueError, match="arrival rate"):
        _front(SINGLE[:2], (0.1, -1.0))
    assert [s.name for s in rec.spans] == ["frontier.prepare", "frontier_dispatch"]
    assert not rec._open and rec.counters == {}
    _front(SINGLE[:2], LAMS2)
    roots = rec.spans_named("frontier_dispatch")
    assert len(roots) == 2 and roots[1].args["parent"] is None
    assert roots[1].args["query"] == roots[1].args["id"] != roots[0].args["id"]


def test_the_null_recorder_hands_out_one_shared_section():
    null = obs.NULL_RECORDER
    a = null.section("frontier_dispatch", "engine", root=True, cells=3)
    b = null.section("queue", "engine", rows=4)
    assert a is b
    with a as s:
        s.note(chunk=2)
        assert s is a
    assert obs.get_recorder() is null
    _front(SINGLE[:2], LAMS2)  # disabled: nothing to record into
    assert len(null) == 0
