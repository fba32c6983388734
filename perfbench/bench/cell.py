"""One run of one cell: set-up, warm-up, the measured window of queries,
the comparison with the reference, and the result line.

The loop is closed with one caller: query i + 1 starts when query i's rows
are on the host.  Query i's seed comes from (--seed, i); the warm-up
queries take seeds of their own.  A few queries, drawn from the seed among
the first of the window, keep their evaluator and queue outputs on the
device for the comparison after the window.
"""

from __future__ import annotations

import json
import math
import sys
import time

import numpy as np
import torch

from . import check, hooks, peaks, port, reference, spec, timeline

#: capture points of the comparison: the evaluator's (T, C) and the queue
CAPTURES = (("repro_torch.fleet.vector", "cell_tc", "tc"), ("repro_torch.fleet.vector", "batched_queue", "queue"))
#: top-level module names that may not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def make_hooks(trace: bool, readers=()) -> hooks.Hooks:
    """Wrappers for the comparison's captures and, traced, for the layer
    ranges the per-layer metrics' readers ask for; installed."""
    hk = hooks.Hooks(trace)
    for module, name, key in CAPTURES:
        hk.bind(module, name, capture=key)
    for reader in readers:
        for module, name in reader.WRAPS:
            hk.bind(module, name, layer=reader.LAYER)
    hk.install()
    return hk


def _picks(seed: int, among: int, count: int) -> list:
    rng = np.random.default_rng(np.random.SeedSequence([int(seed) % (1 << 64), 2]))
    return sorted(int(i) for i in rng.choice(among, size=min(count, among), replace=False))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(bench: dict, wl: dict, cfg: dict, trf: dict, seed: int, seconds: float, trace: bool,
             device, t0: float, out=sys.stdout, err=sys.stderr, marks=()) -> int:
    device = torch.device(device)
    cuda = device.type == "cuda"
    marks = [*marks, ("start", time.perf_counter() - t0)]  # set-up's steps, seconds from process start
    if cuda:
        torch.cuda.init()
        marks.append(("cuda_init", time.perf_counter() - t0))
    model = spec.model(cfg, trf)
    marks.append(("inputs", time.perf_counter() - t0))
    query = port.entry(model, device)
    marks.append(("import_port", time.perf_counter() - t0))
    metrics = spec.per_layer(bench, wl["name"]) if trace else []
    readers = {m["name"]: spec.metric_module(m["name"]) for m in metrics}
    hk = make_hooks(trace, readers.values())
    chk = trf["check"]
    try:
        for i in range(trf["warmup_queries"]):
            query(spec.query_seed(seed, 1, i))
            _sync(device)
            marks.append((f"warmup_{i}", time.perf_counter() - t0))
        setup_s = time.perf_counter() - t0
        setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        n_traced = trf["trace_queries"]
        picks = _picks(seed, min(chk["among_first"], n_traced) if trace else chk["among_first"], chk["queries"])
        hk.calls.clear()
        latencies, all_rows, kept = [], [], {}
        prof = None
        if trace:
            acts = [torch.profiler.ProfilerActivity.CPU] + ([torch.profiler.ProfilerActivity.CUDA] if cuda else [])
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        w0 = time.perf_counter()
        deadline = w0 + seconds
        i = 0
        while (i < n_traced) if trace else (i <= picks[-1] or time.perf_counter() < deadline):
            hk.capturing = i in picks
            t = time.perf_counter()
            if trace:
                with torch.profiler.record_function("pb.query"):
                    rows = query(spec.query_seed(seed, 0, i))
            else:
                rows = query(spec.query_seed(seed, 0, i))
            latencies.append(time.perf_counter() - t)
            all_rows.append(rows)
            if hk.capturing:
                kept[i], hk.captured = hk.captured, {}
            hk.capturing = False
            i += 1
        window_s = time.perf_counter() - w0
        if prof is not None:
            prof.__exit__(None, None, None)
        window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    finally:
        hk.uninstall()
    found = forbidden_modules()
    if found:
        print(f"perfbench: forbidden modules loaded: {', '.join(found)}", file=err)
        return 3

    view = None
    if prof is not None:
        view = timeline.View(timeline.load(prof), len(latencies), hk.calls, window_peak)
        del prof
    failed = sum(1 for rows in all_rows if len(rows) != model.n_cells or not check.finite_rows(rows))

    # the comparison, once the window is closed and the peak read
    readings = []
    for q in picks:
        ref = reference.query(model, spec.query_seed(seed, 0, q), device)
        tc, fin = check.program_outputs(kept[q])
        readings.append(check.gaps(all_rows[q], tc, fin, ref))
        del ref, tc, fin
        check.free(kept[q])
    kept.clear()
    worst = check.worst(readings)
    limits = chk["limits"]
    correct = failed == 0 and check.held(worst, limits)

    lat_ms = np.asarray(latencies) * 1e3
    info = dict(workload=wl["name"], seed=seed, queries=len(latencies), window_s=window_s,
                plan_p50_ms=float(np.percentile(lat_ms, 50)), jobs_per_query=model.jobs_per_query,
                cells=model.n_cells, lams=model.lams, checked_queries=picks, power=peaks.power_limit(),
                missing_bindings=hk.missing, setup_marks=dict(marks))
    print(json.dumps(dict(info=info)), file=out)

    if trace:
        values = {}
        for m in metrics:
            v = readers[m["name"]].read(view)
            if v is not None:
                values[m["name"]] = dict(value=float(v), unit=m["unit"])
    else:
        e2e = dict(
            plan_p95_ms=float(np.percentile(lat_ms, 95)),
            sim_jobs_per_s=len(latencies) * model.jobs_per_query / window_s,
            setup_s=setup_s,
        )
        values = {m["name"]: dict(value=e2e[m["name"]], unit=m["unit"]) for m in bench["end_to_end"]}
    dev = dict(platform="gpu" if cuda else "cpu",
               kind=torch.cuda.get_device_name(device) if cuda else "cpu",
               count=int(wl.get("chips", 1)), memory_peak_bytes=int(max(setup_peak, window_peak)))
    if view is not None:
        dev.update(busy_s=view.busy_s, window_s=view.window_s)
    result = dict(correct=bool(correct), attempted=len(latencies), failed=failed, metrics=values, device=dev)
    if view is not None:
        result["breakdown"] = view.breakdown()
    result["checks"] = {k: dict(value=_num(worst[k]), limit=limits[k]) for k in check.NUMBERS}
    out.flush()
    for k in check.NUMBERS:
        print(f"check {k} {_num(worst[k])!r} limit {limits[k]!r} {'held' if worst[k] <= limits[k] else 'FAILED'}",
              file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return 0


def _num(v: float):
    return v if math.isfinite(v) else "inf"
