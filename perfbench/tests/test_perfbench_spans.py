"""The per-layer metrics read from the program's own spans
(`bench/spans.py`; `metrics/span_*.py`, `metrics/evaluator_distinct_pct.py`),
on the CPU at a tiny size and on made-up traces.  Loading a reader enables
the program's recorder; `conftest.py` disables it after each test."""

import math
import types

import pytest

import pbtest
from bench import spans, spec
from repro_torch import obs

NEW = ("span_evaluator_ms", "span_draws_ms", "span_eval_chunks_ms", "span_queue_ms", "span_stats_ms",
       "span_host_ms", "span_tails_host_ms", "evaluator_distinct_pct")
#: the evaluator runs each distinct (T, C) law once: every cell's grid reads 100
DISTINCT = {"job1.frontier": 100.0, "job1.general": 100.0}


@pytest.mark.parametrize("name", pbtest.CELLS)
def test_a_traced_run_reads_the_programs_spans(name):
    rc, line, _ = pbtest.run_tiny(name, trace=True)
    assert rc == 0 and line["correct"] is True
    got = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(NEW) <= set(got)
    assert all(math.isfinite(got[k]) and got[k] >= 0 for k in NEW)
    assert got["span_draws_ms"] + got["span_eval_chunks_ms"] <= got["span_evaluator_ms"]
    assert got["span_tails_host_ms"] > 0
    assert got["evaluator_distinct_pct"] == DISTINCT[name]
    units = {m["name"]: m["unit"] for m in spec.benchmark()["per_layer"]}
    assert all(line["metrics"][k]["unit"] == units[k] for k in NEW)


def _view(**kw):
    return types.SimpleNamespace(**dict(dict(n_queries=1, w0=0.0, w1=1000.0, device=[]), **kw))


def test_a_program_without_sections_reads_nothing(monkeypatch):
    """A program from before the sections records only a bare root span and
    no ranges of its own: every new metric reads None, and the run leaves
    it out."""
    monkeypatch.setattr(spans, "_trace", dict(events=[
        dict(cat="user_annotation", name="pb.query", ts=0.0, dur=1000.0, tid=1),
        dict(cat="user_annotation", name="pb.evaluator", ts=10.0, dur=900.0, tid=1)]))
    rec = obs.enable(obs.Recorder())
    rec.span("frontier_dispatch", "engine", 0.0, 0.05, pid=obs.PID_PROFILER,
             args=dict(cells=32, padded=32, m_trials=16, n_jobs=2048, tail="exact"))
    assert [spec.metric_module(name).read(_view()) for name in NEW] == [None] * len(NEW)
    assert obs.get_recorder() is rec  # a reader's load keeps a recorder that is there


def test_device_time_is_that_of_the_operations_launched_inside_a_section(monkeypatch):
    """A card's trace, made up: each operation counts for the sections open
    on its launching thread at its launch, whenever it runs; the stats less
    their queue, plus the tails; an operation launched outside every
    section, or on another thread, counts for none."""
    ranges = [("frontier_dispatch", 0, 200), ("evaluator", 10, 100), ("evaluator.draws", 10, 30),
              ("evaluator.chunk", 30, 60), ("evaluator.chunk", 60, 90), ("stats", 100, 150), ("queue", 110, 120),
              ("tails", 150, 170)]
    events = [dict(cat="cpu_op", name=n, ts=float(a), dur=float(b - a), tid=1) for n, a, b in ranges]
    # (launch ts, device start, device us, thread): draws 4, chunks 10 + 20, the evaluator's cat 1,
    # the queue 7, stats 2 + 3, tails 5, one launch between sections and one on another thread
    ops = [(12, 40, 4, 1), (31, 50, 10, 1), (61, 80, 20, 1), (95, 110, 1, 1), (112, 130, 7, 1), (105, 125, 2, 1),
           (140, 160, 3, 1), (155, 190, 5, 1), (180, 195, 9, 1), (50, 60, 11, 2)]
    for i, (launch, start, us, tid) in enumerate(ops):
        events.append(dict(cat="cuda_runtime", name="cudaLaunchKernel", ts=float(launch), dur=1.0, tid=tid,
                           args=dict(correlation=i)))
        events.append(dict(cat="kernel", name=f"k{i}", ts=float(start), dur=float(us), args=dict(correlation=i)))
    monkeypatch.setattr(spans, "_trace", dict(events=events))
    view = _view(n_queries=2, w0=0.0, w1=250.0, device=[("k", 0, 1, None)])
    want = dict(span_evaluator_ms=35, span_draws_ms=4, span_eval_chunks_ms=30, span_queue_ms=7, span_stats_ms=10)
    for name, us in want.items():
        assert spec.metric_module(name).read(view) == pytest.approx(us / 1e3 / 2), name


def test_on_the_cpu_a_sections_device_time_is_its_range(monkeypatch):
    ranges = [("evaluator", 10, 100), ("evaluator.draws", 10, 30), ("stats", 100, 150), ("queue", 110, 120),
              ("tails", 150, 170), ("evaluator", 2000, 2100)]  # the last lies outside the window
    monkeypatch.setattr(spans, "_trace", dict(events=[
        dict(cat="cpu_op", name=n, ts=float(a), dur=float(b - a), tid=1) for n, a, b in ranges]))
    view = _view(w0=0.0, w1=1000.0)
    got = {name: spec.metric_module(name).read(view) for name in ("span_evaluator_ms", "span_draws_ms",
                                                                    "span_queue_ms", "span_stats_ms")}
    assert got == pytest.approx(dict(span_evaluator_ms=0.09, span_draws_ms=0.02, span_queue_ms=0.01,
                                     span_stats_ms=0.06))
