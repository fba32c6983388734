"""Task execution-time traces (paper §4.2).

The container is offline, so the Google Cluster Trace jobs the paper uses
(IDs 6252284914 / 6252315810) are SYNTHESIZED: mixture models matched to
the documented shape of Fig. 7 — task counts, bimodal bulk, heavy straggler
tail (Job 1 heavier than Job 2), and Job 3 = Job 2 with the 3 longest
samples removed (the paper's tail-shortening ablation).  Every number that
depends on these traces is flagged as synthetic in EXPERIMENTS.md.

Qualitative targets reproduced (paper §4.2):
  * small p replication reduces BOTH E[T] and E[C] on Jobs 1-2,
  * keep > kill on Jobs 1-2 (fork-time survivors are near completion),
  * on tail-shortened Job 3, killing hurts latency,
  * diminishing returns in r; Job 1's heavier tail rewards larger r.
"""

from __future__ import annotations

import numpy as np

TRACE_JOBS = ("job1", "job2", "job3")

#: stage-labeled view of the same synthesized traces for DAG workloads
#: (repro.dag): in the Google-trace evaluation map and reduce phases draw
#: from *different* empirical shapes, and which trace plays which stage is
#: exactly what makes per-stage policies diverge —
#:   map     -> job1  (heavy straggler tail: small-p replication cuts both
#:              E[T] and E[C], so the map stage WANTS forking)
#:   shuffle -> job2  (bimodal with a handful of extreme stragglers)
#:   reduce  -> job3  (tail-shortened: replication only burns slots, and
#:              killing actively hurts — the reduce stage wants BASELINE)
STAGE_TRACES = {"map": "job1", "shuffle": "job2", "reduce": "job3"}

#: documented task counts (paper Fig. 7)
_N_TASKS = {"job1": 1026, "job2": 488}


def synthesize_trace(job: str, seed: int = 0) -> np.ndarray:
    """Execution-time samples (seconds) mimicking the Fig. 7 histograms."""
    if job == "job3":
        # paper: Job 2 minus the 3 samples longer than 1400 s
        x = synthesize_trace("job2", seed=seed)
        return np.sort(x)[:-3]
    import hashlib

    digest = hashlib.md5(f"trace|{job}|{seed}".encode()).digest()
    rng = np.random.default_rng(int.from_bytes(digest[:8], "little"))
    if job == "job1":
        # Fig. 7a: ~650s bulk, secondary mode, heavy straggler tail.  The
        # hard floor (task minimum work) is what makes keep > kill (Lemma 1:
        # fresh copies must re-pay the floor, fork-time survivors don't).
        n = _N_TASKS["job1"]
        bulk = rng.normal(650.0, 110.0, size=int(n * 0.86))
        mid = rng.normal(1100.0, 150.0, size=int(n * 0.09))
        k = n - bulk.size - mid.size
        tail = 1300.0 + (rng.pareto(1.8, size=k)) * 900.0
        x = np.clip(np.concatenate([bulk, mid, tail]), 400.0, None)
    elif job == "job2":
        # Fig. 7b: tight ~210s bulk, small secondary mode, a handful of
        # stragglers of which exactly 3 exceed 1400s (removed for job3).
        n = _N_TASKS["job2"]
        bulk = rng.normal(210.0, 25.0, size=int(n * 0.90))
        mid = rng.normal(380.0, 50.0, size=int(n * 0.07))
        k = n - bulk.size - mid.size - 3
        tail = 550.0 + rng.uniform(0.0, 800.0, size=k) ** 1.0
        worst = np.array([1550.0, 1900.0, 2600.0])
        x = np.clip(np.concatenate([bulk, mid, tail, worst]), 170.0, None)
    else:
        raise KeyError(job)
    return x


def load_trace(job: str, seed: int = 0) -> np.ndarray:
    """Alias kept so a real Google-trace loader can slot in unchanged."""
    return synthesize_trace(job, seed)


def load_stage_trace(stage: str, seed: int = 0, normalize: bool = True) -> np.ndarray:
    """Execution-time samples for one MapReduce *stage* (repro.dag).

    Resolves the stage label through `STAGE_TRACES` (map/shuffle/reduce →
    the synthesized Fig. 7 job whose shape plays that role) and, by
    default, rescales to mean 1.0 so different stages impose comparable
    per-task load and a DAG's stage pools can be sized in common units —
    the same normalization `fleet.trace_workload` applies.  Pass
    `normalize=False` for the raw seconds.
    """
    if stage not in STAGE_TRACES:
        raise KeyError(
            f"unknown stage {stage!r}; expected one of {sorted(STAGE_TRACES)}"
        )
    x = synthesize_trace(STAGE_TRACES[stage], seed=seed)
    if normalize:
        x = x / np.mean(x)
    return x
