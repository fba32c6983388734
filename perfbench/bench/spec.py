"""`BENCHMARK.json` and the files it names, found by name.

A cell (`workloads` entry) names a configuration, `configs/<config>.json`,
and a traffic mix, `traffic/<traffic>.json`; a per-layer metric is read by
`metrics/<metric>.py`.  Adding a cell, a mix or a metric adds files and
entries and edits none.

A configuration is one job: its trace, n tasks and c gang blocks.  A
traffic mix is the query: the policy grid, the loads rho, jobs and trials a
query, the warm-up and traced queries, and the comparison's limits.  A
policy is plain data: `{"single": [p, r, keep]}`, `{"delayed": [t, r,
keep]}` (relaunch at time t) or `{"multi": [[p, r, keep], ...]}`.

Every cell runs a closed loop with one caller and exact tails; a key the
harness does not read is refused, so a mix that needs more brings the code
that honours it.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from . import traces

HERE = Path(__file__).resolve().parent.parent  # perfbench/
ROOT = HERE.parent  # the checkout

TRAFFIC_KEYS = {"policies", "rhos", "n_jobs", "m_trials", "warmup_queries", "trace_queries", "check"}
#: the Monte Carlo for E[T] behind the loads: fixed, so every seed gets the same loads
ET_REPS, ET_SEED = 4000, 7


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((ROOT / c["file"]).read_text())
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    trf = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    unknown = set(trf) - TRAFFIC_KEYS
    if unknown:
        raise ValueError(f"traffic {name!r}: keys the harness does not read: {sorted(unknown)}")
    return trf


def metric_module(name: str):
    """`metrics/<name>.py`, loaded from its file."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def per_layer(bench: dict, cell: str) -> list:
    """The per-layer metrics that list `cell` under their `workloads`."""
    return [m for m in bench["per_layer"] if cell in m["workloads"]]


def query_seed(seed: int, tag: int, i: int) -> int:
    """The seed of query i of a run (tag 0: timed, 1: warm-up), derived
    from the run's seed; any whole number is taken."""
    words = np.random.SeedSequence([int(seed) % (1 << 64), tag, i]).generate_state(2, dtype=np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


@dataclass
class Model:
    """The cell as plain data: what the benchmark makes and hands to both
    the program and the reference."""

    n: int
    c: int
    samples: np.ndarray  # the trace, float64, mean 1
    policies: list  # the grid's policy specs
    lams: list  # one per load
    n_jobs: int
    m_trials: int

    @property
    def n_cells(self) -> int:
        return len(self.policies) * len(self.lams)

    @property
    def jobs_per_query(self) -> int:
        return self.n_cells * self.m_trials * self.n_jobs

    def cells(self) -> list:
        """(policy spec, load) of every cell: policy-major, loads fastest,
        as the planner orders its rows."""
        return [(pol, lam) for pol in self.policies for lam in self.lams]


def _expected_max(samples: np.ndarray, n: int, rng) -> float:
    """E[max of n type-1 draws from the float32 trace], by Monte Carlo."""
    xs = np.sort(samples.astype(np.float32))
    u = rng.random((ET_REPS, n), dtype=np.float32)
    idx = np.clip(np.ceil(u * xs.size).astype(np.int64) - 1, 0, xs.size - 1)
    return float(xs[idx].max(axis=1).astype(np.float64).mean())


def model(cfg: dict, trf: dict) -> Model:
    """The cell's inputs: the trace, the grid, and the loads
    λ = ρ·c / E[T_baseline], so that the baseline stands at each ρ."""
    n, c = int(cfg["n"]), int(cfg["c"])
    samples = traces.trace(cfg["trace"])
    e_t = _expected_max(samples, n, np.random.default_rng(ET_SEED))
    return Model(n=n, c=c, samples=samples, policies=list(trf["policies"]),
                 lams=[rho * c / e_t for rho in trf["rhos"]], n_jobs=int(trf["n_jobs"]),
                 m_trials=int(trf["m_trials"]))
