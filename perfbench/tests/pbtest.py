"""Shared helpers of the benchmark's tests: the harness's import path and
tiny CPU versions of the cells (the cell's own configuration and grid,
with few jobs and trials a query)."""

from __future__ import annotations

import io
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent  # perfbench/
ROOT = HERE.parent
for p in (str(HERE), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench import cell, spec  # noqa: E402

CELLS = tuple(w["name"] for w in spec.benchmark()["workloads"])
TINY = dict(n_jobs=16, m_trials=2)


def tiny_cell(name: str, **override):
    bench = spec.benchmark()
    wl = spec.workload(bench, name)
    trf = spec.traffic(wl["traffic"])
    trf.update(TINY, **override)
    return bench, wl, spec.config(bench, wl["config"]), trf


def run_tiny(name: str, trace: bool = False, seed: int = 2**33 + 5, seconds: float = 0.2, **override):
    """One run of the cell on the CPU at a tiny size, past the look for a
    card: (exit code, last stdout line as JSON or None, stderr text)."""
    bench, wl, cfg, trf = tiny_cell(name, **override)
    out, err = io.StringIO(), io.StringIO()
    rc = cell.run_cell(bench, wl, cfg, trf, seed, seconds, trace, "cpu", time.perf_counter(), out=out, err=err)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
