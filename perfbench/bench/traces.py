"""The benchmark's own copy of the task-time trace (paper §4.2, Fig. 7a).

The Google Cluster Trace job the paper calls Job 1 (6252284914) is not in
the repository, so it is synthesized: a mixture matched to the documented
shape of Fig. 7a (1026 tasks, bimodal bulk, heavy straggler tail).  The
numbers are those of `repro_torch.data.traces` at its seed 0, copied here
so that a change to the program cannot move the benchmark's inputs.  Both
the program and the reference are handed the array made here.
"""

from __future__ import annotations

import hashlib

import numpy as np

#: documented task counts (paper Fig. 7)
N_TASKS = {"job1": 1026}


def synthesize(job: str) -> np.ndarray:
    """Execution-time samples (seconds) mimicking the Fig. 7a histogram."""
    if job != "job1":
        raise KeyError(f"unknown trace {job!r}")
    digest = hashlib.md5(f"trace|{job}|0".encode()).digest()
    rng = np.random.default_rng(int.from_bytes(digest[:8], "little"))
    n = N_TASKS[job]
    bulk = rng.normal(650.0, 110.0, size=int(n * 0.86))
    mid = rng.normal(1100.0, 150.0, size=int(n * 0.09))
    k = n - bulk.size - mid.size
    tail = 1300.0 + rng.pareto(1.8, size=k) * 900.0
    return np.clip(np.concatenate([bulk, mid, tail]), 400.0, None)


def trace(job: str) -> np.ndarray:
    """The trace of `job` as float64 samples, rescaled to mean 1 (as the
    planner's trace workloads normalise)."""
    x = synthesize(job)
    return x / np.mean(x)
