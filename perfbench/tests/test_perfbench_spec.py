"""BENCHMARK.json against the contract's shape, and every configuration,
traffic mix and metric it names found by name."""

import json
import re

import numpy as np
import pytest

import pbtest
from bench import spec, traces

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_bounds():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert {"plan_p95_ms", "sim_jobs_per_s", "setup_s"} <= set(e2e)
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e and "\n" not in m["layer"]
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert set(m["workloads"]) <= {w["name"] for w in BENCH["workloads"]}


@pytest.mark.parametrize("name", pbtest.CELLS)
def test_cell_finds_its_files_by_name(name):
    wl = spec.workload(BENCH, name)
    assert wl["chips"] == 1 and len(wl["why"]) <= 200
    cfg = spec.config(BENCH, wl["config"])
    trf = spec.traffic(wl["traffic"])
    model = spec.model(cfg, trf)
    assert model.n_cells * model.m_trials * model.n_jobs == model.jobs_per_query > 0
    assert all(lam > 0 for lam in model.lams)
    layer = spec.per_layer(BENCH, name)
    assert layer, "every cell reports a per-layer metric"
    for m in layer:
        mod = spec.metric_module(m["name"])
        assert callable(mod.read) and isinstance(mod.WRAPS, tuple)
        assert not mod.WRAPS or isinstance(mod.LAYER, str)


def test_every_config_file_is_its_own_and_under_paths():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["file"].startswith("perfbench/") and c["reduced"] == []
        assert json.loads((pbtest.ROOT / c["file"]).read_text())["name"] == c["name"]
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_trace_copy_matches_the_programs_synthesis():
    from repro_torch.data.traces import synthesize_trace

    np.testing.assert_array_equal(traces.synthesize("job1"), synthesize_trace("job1"))
    assert traces.synthesize("job1").size == traces.N_TASKS["job1"]


def test_a_traffic_key_the_harness_does_not_read_is_refused(tmp_path, monkeypatch):
    trf = json.loads((pbtest.HERE / "traffic" / "frontier-sf8x4.json").read_text())
    (tmp_path / "traffic").mkdir()
    (tmp_path / "traffic" / "mix.json").write_text(json.dumps(dict(trf, tail="hist")))
    monkeypatch.setattr(spec, "HERE", tmp_path)
    with pytest.raises(ValueError, match="tail"):
        spec.traffic("mix")


def test_query_seeds_differ_and_take_large_seeds():
    seeds = {spec.query_seed(2**40 + 3, tag, i) for tag in (0, 1) for i in range(50)}
    assert len(seeds) == 100
    assert spec.query_seed(7, 0, 3) == spec.query_seed(7, 0, 3)
