"""The port's observability modules (`repro_torch.obs`: registry, slo,
export, dashboard, profile) against the JAX package's, on the CPU.

registry, slo, export and dashboard are numpy and plain-Python copies, so
on the same inputs they must give the same answers: snapshots, merges,
error messages, Chrome trace dicts, HTML and text are held equal, and burn
rates and SLO reports at rel 1e-12.  `profile` is rewritten for PyTorch
(CUDA events, torch.profiler), so it is held to the reference's contract
(keys, spans, gauges), not to its numbers.
"""

import json

import numpy as np
import pytest
import torch

import repro.obs as jobs
from repro.obs import trace as jtrace
from repro_torch import obs as tobs
from repro_torch.obs import trace as ttrace

PACKAGES = {"ref": jobs, "port": tobs}


# ------------------------------------------------------------ registry
def _fill_registry(m, seed):
    """One registry driven by a seeded stream of counter, gauge and
    labelled histogram updates."""
    rng = np.random.default_rng(seed)
    reg = m.MetricsRegistry()
    for _ in range(200):
        kind = rng.integers(3)
        label = {"class": ["gpu", "spot"][rng.integers(2)], "tenant": str(rng.integers(3))}
        if kind == 0:
            reg.counter("jobs", labels=label).inc(float(rng.integers(1, 4)))
        elif kind == 1:
            reg.gauge("rho", labels=label).set(float(rng.random()))
        else:
            reg.histogram("sojourn", labels=label).observe_many(rng.exponential(2.0, 5))
    return reg


def test_registry_collect_merge_and_render_equal_the_reference():
    ref, port = (_fill_registry(m, 0) for m in (jobs, tobs))
    assert port.collect() == ref.collect()
    assert port.collect("sojourn") == ref.collect("sojourn")
    assert sorted(port.labels_for("jobs")) == sorted(ref.labels_for("jobs"))
    assert port.render() == ref.render()
    ref.merge(_fill_registry(jobs, 1))
    port.merge(_fill_registry(tobs, 1))
    assert port.collect() == ref.collect()
    assert len(port) == len(ref)


def test_registry_errors_equal_the_reference():
    msgs = {}
    for key, m in PACKAGES.items():
        reg = m.MetricsRegistry()
        reg.counter("jobs", labels={"class": "gpu"}).inc()
        with pytest.raises(TypeError) as clash:
            reg.gauge("jobs", labels={"class": "gpu"})
        with pytest.raises(ValueError) as down:
            reg.counter("jobs").inc(-1.0)
        msgs[key] = (str(clash.value), str(down.value))
    assert msgs["port"] == msgs["ref"]


# ----------------------------------------------------------------- slo
def _slo_stream(m, seed, n=3000):
    """A tracker fed a seeded stream whose violation rate steps up midway,
    on a ring small enough that old buckets age out."""
    slo = m.SLO("p99<8", threshold=8.0, quantile=0.99, windows=(4.0, 16.0, 64.0))
    tr = m.SLOTracker(slo, buckets_per_window=4)
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.exponential(0.05, n))
    bad = rng.random(n) < np.where(np.arange(n) < n // 2, 0.002, 0.05)
    vals = np.where(bad, 8.0 + rng.exponential(4.0, n), rng.exponential(1.0, n))
    reports = []
    for i, (ti, v) in enumerate(zip(t, vals)):
        tr.observe(float(ti), float(v))
        if i % 500 == 499:
            reports.append(tr.report())
    return tr, reports, float(t[-1])


def _close(a, b, rel=1e-12):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k], rel)
    elif isinstance(a, float):
        assert b == pytest.approx(a, rel=rel, nan_ok=True)
    else:
        assert a == b


def test_slo_burn_rates_and_reports_agree_with_the_reference_under_ageing():
    (jt, jrep, end), (tt, trep, _) = (_slo_stream(m, 3) for m in (jobs, tobs))
    assert len(tt.window_sketch._ring) == tt.window_sketch.n_buckets  # the ring aged
    for a, b in zip(jrep, trep):
        _close(a, b)
    for now in (None, end - 30.0, end + 10.0, 1e6):
        _close(jt.burn_rates(now), tt.burn_rates(now))
        _close(jt.report(now), tt.report(now))
        assert tt.burning(1.0, now) == jt.burning(1.0, now)
    for w in (2.0, 16.0, 500.0):
        assert tt.window_sketch.sketch_over(w).summary() == jt.window_sketch.sketch_over(w).summary()
        assert tt.window_sketch.coverage(w) == jt.window_sketch.coverage(w)


def test_slo_validation_and_trackers_for_equal_the_reference():
    bad = [dict(threshold=8.0, quantile=1.0), dict(threshold=0.0), dict(threshold=1.0, windows=())]
    for kw in bad:
        msgs = []
        for m in (jobs, tobs):
            with pytest.raises(ValueError) as e:
                m.SLO("bad", **kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    for kw in (dict(bucket_s=0.0), dict(bucket_s=1.0, n_buckets=0)):
        msgs = []
        for m in (jobs, tobs):
            with pytest.raises(ValueError) as e:
                m.WindowedSketch(**kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    for key, m in PACKAGES.items():
        slo = m.SLO("gold", threshold=2.0)
        one = m.trackers_for(slo, [2, 0, 2, 1])
        mapped = m.trackers_for({0: slo}, [0, 1])
        assert sorted(one) == [0, 1, 2] and sorted(mapped) == [0]
        assert m.trackers_for(None, [0]) == {}
        with pytest.raises(TypeError, match=r"slos\[0\] must be an SLO"):
            m.trackers_for({0: "gold"}, [0])


# -------------------------------------------------------- chrome traces
def _recorder(trace_mod):
    rec = trace_mod.Recorder()
    rec.name_process(7, "myproc")
    rec.name_thread(7, 3, "lane")
    rng = np.random.default_rng(5)
    for i in range(20):
        ts = float(rng.exponential(1.0)) + i
        rec.span("job", "fleet", ts, float(rng.exponential(0.5)), pid=7, tid=int(rng.integers(4)),
                 args={"n": int(rng.integers(10)), "policy": "keep"})
        rec.instant("fork", "fleet", ts + 0.1, pid=7, tid=3, args={"r": 1})
        rec.counter_sample("depth", ts, float(rng.integers(8)), pid=7)
    rec.count("events", 2)
    return rec


def _spans(rec):
    return [(s.name, s.cat, s.ts, s.dur, s.pid, s.tid, s.args) for s in rec.spans]


def test_chrome_trace_dicts_equal_and_each_package_loads_the_others(tmp_path):
    jrec, trec = _recorder(jtrace), _recorder(ttrace)
    jdoc, tdoc = jobs.to_chrome_trace(jrec), tobs.to_chrome_trace(trec)
    assert tdoc == jdoc
    jpath = jobs.write_chrome_trace(str(tmp_path / "ref.json"), jrec)
    tpath = tobs.write_chrome_trace(str(tmp_path / "port.json"), trec)
    assert json.loads(open(jpath).read()) == json.loads(open(tpath).read())
    for path, loader, src in ((jpath, tobs.load_chrome_trace, jrec), (tpath, jobs.load_chrome_trace, trec)):
        back = loader(path)
        assert len(back.spans) == len(src.spans) == 20
        for a, b in zip(_spans(back), _spans(src)):
            assert a[:2] == b[:2] and a[4:] == b[4:]
            assert a[2] == pytest.approx(b[2], rel=1e-12) and a[3] == pytest.approx(b[3], rel=1e-12)
        assert len(back.instants) == len(src.instants)
        assert [c.value for c in back.samples] == [c.value for c in src.samples]
        assert back.process_names == src.process_names
        assert back.thread_names == src.thread_names
    assert isinstance(tobs.load_chrome_trace(jdoc), ttrace.Recorder)


# ------------------------------------------------------------ dashboard
def _dashboard_inputs(m, trace_mod):
    """Identical frontier rows, SLO reports, blame summary, decision log,
    sketches and registry, built with package `m`."""
    rows = [
        {"policy": "baseline", "lam": 0.3, "mean_sojourn": 3.25, "p99": 9.5, "p999": 14.0,
         "evt_p999": 13.75, "evt_xi": 0.125, "rho": 0.41, "mean_cost": 1.0},
        {"policy": "keep(p=0.1,r=1)", "lam": 0.3, "mean_sojourn": 2.5, "p99": 6.0, "p999": float("nan"),
         "evt_p999": 8.0, "evt_xi": -0.05, "rho": 0.46, "mean_cost": 1.125},
    ]
    rng = np.random.default_rng(11)
    tr = m.SLOTracker(m.SLO("p99<8", threshold=8.0, quantile=0.99, windows=(16.0, 64.0)))
    for i in range(300):
        tr.observe(i * 0.5, float(1.0 + 10.0 * (rng.random() < 0.03)))
    blame = m.StragglerBlame(quantile=0.95, min_samples=16)
    for _ in range(120):
        blame.observe("fast", 1.0 + rng.exponential(1.0))
        blame.observe("slow", 1.0 + rng.exponential(3.0))
    log = m.DecisionLog(recorder=trace_mod.NULL_RECORDER)
    for i in range(70):
        log.log(m.DecisionEvent(t=float(i), kind=[m.KIND_REPLAN, m.KIND_DRIFT, m.KIND_BLAME][i % 3],
                                label=f"keep(p=0.{i % 5},r=1)", trigger="periodic", lam_hat=0.25 + i / 100,
                                rho=0.5, ks_stat=0.1 * (i % 4), n_vetoed=i % 2, args={"score": 0.3}))
    sk = m.QuantileSketch()
    sk.add_many(rng.exponential(1.0, 500))
    reg = m.MetricsRegistry()
    reg.counter("serve.shed").inc(3)
    reg.gauge("fleet.availability").set(0.97)
    reg.histogram("serve.sojourn", labels={"priority": "0"}).observe_many(rng.exponential(2.0, 50))
    return dict(title="observatory", frontier=rows, slo={0: tr.report(), 1: tr.report(now=1e4)},
                blame=blame.summary(), decisions=log, sketches={"sojourn": sk}, registry=reg)


def test_dashboard_html_and_text_equal_the_reference(tmp_path):
    jin, tin = _dashboard_inputs(jobs, jtrace), _dashboard_inputs(tobs, ttrace)
    html = tobs.render_dashboard(**tin)
    assert html == jobs.render_dashboard(**jin)
    for needle in ("observatory", "evt_p999", "p99&lt;8", "slow", "sojourn", "<svg", "last 60 of 70"):
        assert needle in html
    assert tobs.render_text(**tin) == jobs.render_text(**jin)
    path = tobs.write_dashboard(tmp_path / "sub" / "dash.html", **tin)
    assert path.read_text() == html


# -------------------------------------------------------------- profile
def test_kernel_profile_on_the_cpu_keeps_the_reference_contract():
    reg = tobs.MetricsRegistry()
    rec = tobs.Recorder()
    x = torch.arange(4096, dtype=torch.float32)
    prof = tobs.kernel_profile(lambda v: torch.cumsum(v * 2.0, 0), x, name="toy", repeats=2,
                               recorder=rec, registry=reg, device="cpu")
    assert {"name", "compile_s", "wall_s", "wall_mean_s", "repeats", "device_ms_total",
            "device_ms_by_kernel"} == set(prof)
    assert "peak_bytes" not in prof  # no memory keys where the backend has none
    assert prof["wall_s"] > 0 and prof["compile_s"] > 0 and prof["repeats"] == 2
    assert prof["wall_mean_s"] >= prof["wall_s"]
    assert 0 < len(prof["device_ms_by_kernel"]) <= 10
    assert any("cumsum" in k for k in prof["device_ms_by_kernel"])
    assert prof["device_ms_total"] >= max(prof["device_ms_by_kernel"].values())
    assert len(rec.spans_named("toy:exec")) == 2
    assert rec.spans_named("toy:compile")
    assert rec.counters["profile.toy.runs"] == 2
    assert set(reg.collect()) == {'kernel_wall_s{kernel="toy"}', 'kernel_compile_s{kernel="toy"}'}
    assert reg.gauge("kernel_wall_s", {"kernel": "toy"}).value == prof["wall_s"]

