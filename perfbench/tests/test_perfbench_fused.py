"""`evaluator_fused_pct` (`metrics/evaluator_fused_pct.py`): the share of a
query's laws that the single-job kernel evaluates, read from the program's
`evaluator.chunk` sections: made up here, and from tiny CPU runs, where the
program keeps its PyTorch chains and reads 0."""

import types

import pytest

import pbtest
from bench import spec
from repro_torch import obs

NAME = "evaluator_fused_pct"


def _view(n_queries):
    return types.SimpleNamespace(n_queries=n_queries, w0=0.0, w1=1000.0, device=[])


def _query(rec, chunks):
    with rec.section("frontier_dispatch", "engine", root=True, laws=sum(c for c, _ in chunks)):
        with rec.section("evaluator", "engine"):
            for cells, path in chunks:
                with rec.section("evaluator.chunk", "engine", cells=cells, path=path):
                    pass


@pytest.mark.parametrize("chunks, want", [
    ([(8, "fused")], 100.0), ([(3, "fused"), (1, "lowered")], 75.0), ([(4, "masked"), (4, "masked")], 0.0)])
def test_the_share_of_laws_in_fused_chunks(chunks, want):
    reader = spec.metric_module(NAME)
    rec = obs.enable(obs.Recorder())
    _query(rec, [(4, "lowered")])  # an older query, outside the one read
    _query(rec, chunks)
    assert reader.read(_view(1)) == pytest.approx(want)
    assert reader.read(_view(2)) == pytest.approx((0.0 + want) / 2)


def test_a_program_without_chunk_sections_reads_nothing():
    reader = spec.metric_module(NAME)
    rec = obs.enable(obs.Recorder())
    with rec.section("frontier_dispatch", "engine", root=True, laws=8):
        pass
    assert reader.read(_view(1)) is None


@pytest.mark.parametrize("name", pbtest.CELLS)
def test_the_cpu_keeps_the_chains(name):
    rc, line, _ = pbtest.run_tiny(name, trace=True)
    assert rc == 0 and line["correct"] is True
    assert line["metrics"][NAME]["value"] == 0.0 and line["metrics"][NAME]["unit"] == "%"
