"""Fleet-level metrics over per-job records.

A copy of `repro.fleet.metrics` for the port.

The single-job layer reports (E[T], E[C]); a fleet adds the queueing
dimension: sojourn time (arrival -> finish), queueing delay (arrival ->
admission), pool utilization, and the tail percentiles (p50/p99/p999) that
a latency SLO is actually written against.  Replication shifts mass
between these: extra copies cut service time but raise per-job cost and
hence the offered load ρ = λ·E[C]·n / capacity — past ρ = 1 the queue
diverges and every percentile explodes, which is the fleet-level story the
single-job analysis cannot see.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from .scheduler import JobRecord
from .workload import MachineClass

__all__ = [
    "DagStats",
    "FleetStats",
    "class_sojourn_sketches",
    "compute_dag_stats",
    "compute_stats",
    "dag_critical_path_shares",
    "straggler_blame",
    "tail_quantiles",
]


def tail_quantiles(x: np.ndarray, qs: Sequence[float]) -> np.ndarray:
    """All requested percentiles (0..100) from ONE `np.partition` pass.

    `np.percentile(x, q)` called per quantile re-selects over the full
    array each time; for the tail triplet (p50, p99, p999) that is three
    O(n) selections plus three partial sorts.  Here the bracketing ranks
    of every quantile are partitioned in a single call — np.partition
    accepts a kth *vector* and places all those order statistics at once —
    then each percentile is finished with the same linear interpolation
    np.percentile uses, so results are bit-identical to the default
    interpolation="linear".
    """
    x = np.asarray(x, dtype=np.float64).ravel()
    if x.size == 0:
        raise ValueError("no samples")
    qs = np.asarray(qs, dtype=np.float64)
    if np.any(qs < 0) or np.any(qs > 100):
        raise ValueError("percentiles must be in [0, 100]")
    pos = qs / 100.0 * (x.size - 1)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, x.size - 1)
    kth = np.unique(np.concatenate([lo, hi]))
    part = np.partition(x, kth)
    frac = pos - lo
    return part[lo] * (1.0 - frac) + part[hi] * frac


def class_sojourn_sketches(records: Sequence[JobRecord],
                           rel_acc: float = 0.01) -> dict:
    """{machine_class -> QuantileSketch of sojourns} over served records.

    The per-class view the dashboard and the blame layer share: failed /
    shed records carry no served latency and are skipped, "mixed" pooled
    jobs keep their own bucket (they belong to no single class)."""
    from ..obs.sketch import QuantileSketch

    out: dict = {}
    for r in records:
        if r.failed:
            continue
        sk = out.get(r.machine_class)
        if sk is None:
            sk = out[r.machine_class] = QuantileSketch(rel_acc=rel_acc)
        sk.add(r.sojourn)
    return out


def straggler_blame(records: Sequence[JobRecord], quantile: float = 0.99):
    """Post-hoc per-machine-class blame over a finished run's records —
    the offline counterpart of the controller's streaming tracker.
    Returns a `repro_torch.obs.blame.StragglerBlame` ready for `ranking()`."""
    from ..obs.blame import StragglerBlame

    return StragglerBlame(quantile=quantile).observe_records(records)


@dataclasses.dataclass
class FleetStats:
    n_jobs: int
    mean_sojourn: float  # E[arrival -> finish]
    mean_service: float  # E[admission -> finish] (per-job E[T] under load)
    mean_wait: float  # E[queueing delay]
    mean_cost: float  # per-job E[C] (Definition 2)
    utilization: float  # busy slot-time / (capacity * makespan)
    throughput: float  # jobs finished per unit time
    p50_sojourn: float
    p99_sojourn: float
    p999_sojourn: float
    sojourn_std_err: float
    mean_replicas: float
    n_preempted: int
    # heterogeneous fleets: per-class busy fraction and job share, keyed by
    # class name (None on single-class fleets built without class specs)
    class_utilization: Optional[dict] = None
    class_job_share: Optional[dict] = None
    # chaos (repro_torch.faults): fraction of slot-time the fleet was up, the
    # share of jobs that ended terminally failed (shed / timeout /
    # max_attempts), mean copy launches per task (1.0 = no retries), and
    # the observed mean repair time per class (None when nothing crashed)
    availability: float = 1.0
    failed_job_share: float = 0.0
    mean_attempts: float = 1.0
    class_mttr: Optional[dict] = None

    def row(self) -> str:
        return (
            f"E[sojourn]={self.mean_sojourn:.3f} wait={self.mean_wait:.3f} "
            f"E[C]={self.mean_cost:.3f} util={self.utilization:.2f} "
            f"p99={self.p99_sojourn:.3f}"
        )


def _batch_means_se(x: np.ndarray, n_batches: int = 20, min_batch: int = 8) -> float:
    """Std error of the mean via batch means: consecutive sojourns share
    queue backlog, so the i.i.d. std/sqrt(n) formula understates the error
    badly near saturation.  Contiguous batches keep the within-batch
    autocorrelation; their means are approximately independent — but only
    if each batch actually spans several sojourns: with fewer records than
    `n_batches` the split degenerates to singletons, i.e. exactly the
    i.i.d. estimate this method exists to avoid.  So batches are at least
    `min_batch` long (using fewer batches when records are scarce), and
    with too few records for even 2 such batches the SE is reported as 0.0
    (unknown) rather than as a confidently-wrong singleton estimate."""
    nb = min(n_batches, len(x) // min_batch)
    if nb < 2:
        return 0.0
    means = np.array([b.mean() for b in np.array_split(x, nb)])
    return float(means.std(ddof=1) / np.sqrt(nb))


def compute_stats(
    records: Sequence[JobRecord],
    capacity: int,
    busy_time: float,
    classes: Optional[Sequence[MachineClass]] = None,
    busy_by_class: Optional[Sequence[float]] = None,
    down_time: float = 0.0,
    repairs_by_class: Optional[Sequence[Sequence[float]]] = None,
) -> FleetStats:
    if not records:
        raise ValueError("no job records")
    # latency percentiles/means describe jobs that actually completed —
    # a shed job's zero-length "sojourn" is a refusal, not a latency.
    # Cost, replicas, and attempts aggregate over EVERY record: retried
    # attempts' copy-seconds (and failed jobs' burned work) are real bills
    # the fleet paid, so they belong in E[C] (Definition 2 under faults).
    done = [r for r in records if not r.failed]
    latency_records = done if done else list(records)
    soj = np.array([r.sojourn for r in latency_records])
    wait = np.array([r.wait for r in latency_records])
    svc = np.array([r.service for r in latency_records])
    cost = np.array([r.cost for r in records])
    t0 = min(r.arrival for r in records)
    makespan = max(r.finish for r in records) - t0
    class_util = class_share = None
    if classes is not None and busy_by_class is not None:
        class_util = {
            k.name: float(b / (k.slots * max(makespan, 1e-12)))
            for k, b in zip(classes, busy_by_class)
        }
        # every job is attributed exactly once: to its class, to "mixed"
        # (pooled placement spanning classes — including a crash retry
        # re-queued onto another class), or to "unplaced" (shed / timed out
        # in queue).  The pop-then-append walk keys on whatever names the
        # records carry, so shares always sum to 1 even under chaos
        # (tests/test_fleet.py and tests/test_faults.py assert it).
        counts: dict = {}
        for r in records:
            counts[r.machine_class] = counts.get(r.machine_class, 0) + 1
        class_share = {k.name: counts.pop(k.name, 0) / len(records) for k in classes}
        for name, cnt in sorted(counts.items()):
            class_share[name] = cnt / len(records)
    class_mttr = None
    if repairs_by_class is not None and any(rep for rep in repairs_by_class):
        if classes is not None:
            names = [k.name for k in classes]
        elif len(repairs_by_class) == 1:
            names = ["default"]
        else:
            names = [f"class{i}" for i in range(len(repairs_by_class))]
        class_mttr = {
            nm: (float(np.mean(rep)) if len(rep) else float("nan"))
            for nm, rep in zip(names, repairs_by_class)
        }
    n_failed = len(records) - len(done)
    attempted = [r for r in records if r.n_attempts > 0]
    mean_attempts = (
        float(np.mean([r.n_attempts / r.n_tasks for r in attempted]))
        if attempted
        else 1.0
    )
    p50, p99, p999 = tail_quantiles(soj, (50.0, 99.0, 99.9))
    return FleetStats(
        n_jobs=len(records),
        mean_sojourn=float(soj.mean()),
        mean_service=float(svc.mean()),
        mean_wait=float(wait.mean()),
        mean_cost=float(cost.mean()),
        utilization=float(busy_time / (capacity * max(makespan, 1e-12))),
        throughput=float(len(latency_records) / max(makespan, 1e-12)),
        p50_sojourn=float(p50),
        p99_sojourn=float(p99),
        p999_sojourn=float(p999),
        sojourn_std_err=_batch_means_se(soj),
        mean_replicas=float(np.mean([r.n_replicas for r in records])),
        n_preempted=int(sum(r.n_preempted for r in records)),
        class_utilization=class_util,
        class_job_share=class_share,
        availability=float(1.0 - down_time / (capacity * max(makespan, 1e-12))),
        failed_job_share=float(n_failed / len(records)),
        mean_attempts=mean_attempts,
        class_mttr=class_mttr,
    )


# --------------------------------------------------------------------------
# DAG jobs: per-stage metrics + critical-path attribution over records
# --------------------------------------------------------------------------


@dataclasses.dataclass
class DagStats:
    """Fleet metrics for multi-stage DAG jobs.

    Job-level quantities span the whole DAG: sojourn is arrival → last sink
    barrier, wait/service/cost are *summed over stages* (a DAG job queues
    once per stage), and `critical_path_shares[name]` is the fraction of
    E[sojourn] spent in stage `name` on the path that determined each job's
    completion — the shares sum to 1 by construction and answer "which
    stage's stragglers dominate E[T]".  `stage` holds one full `FleetStats`
    per stage computed over that stage's own records and pool.
    """

    n_jobs: int
    mean_sojourn: float  # E[arrival -> last sink barrier]
    mean_wait: float  # E[Σ_s queueing delay]
    mean_service: float  # E[Σ_s stage makespan]
    mean_cost: float  # E[Σ_s C_s] (Definition 2 per stage)
    throughput: float
    p50_sojourn: float
    p99_sojourn: float
    p999_sojourn: float
    sojourn_std_err: float
    critical_path_shares: dict  # stage name -> share of E[sojourn]; sums to 1
    stage: dict  # stage name -> FleetStats over that stage's records

    def row(self) -> str:
        shares = " ".join(
            f"{k}={v:.2f}" for k, v in self.critical_path_shares.items()
        )
        return (
            f"E[sojourn]={self.mean_sojourn:.3f} wait={self.mean_wait:.3f} "
            f"E[C]={self.mean_cost:.3f} p99={self.p99_sojourn:.3f} "
            f"crit[{shares}]"
        )


def dag_critical_path_shares(
    stage_records: dict,
    preds: dict,
    sinks: Sequence[str],
    arrivals: Sequence[float],
) -> dict:
    """Critical-path attribution from per-stage event records.

    `stage_records[name]` lists one `JobRecord` per job in job-id order
    (its `arrival` is the stage's barrier-release time); `preds[name]`
    names the upstream stages (topological input order), `sinks` the
    stages nothing depends on; `arrivals` are the DAG jobs' arrival times.
    Walks each job backwards from the sink that finished last, crediting at
    every step the predecessor whose barrier released the stage — the same
    telescoping decomposition the vectorized engine computes in-program
    (`repro_torch.dag.rollout`), so Σ shares = 1 exactly.
    """
    arrivals = np.asarray(arrivals, dtype=np.float64)
    n = arrivals.shape[0]
    names = list(stage_records)
    fin = {k: np.array([r.finish for r in v]) for k, v in stage_records.items()}
    rel = {k: np.array([r.arrival for r in v]) for k, v in stage_records.items()}
    for k in names:
        if fin[k].shape[0] != n:
            raise ValueError(f"stage {k!r} has {fin[k].shape[0]} records for {n} jobs")
    sink_f = np.stack([fin[s] for s in sinks])
    sojourn = sink_f.max(axis=0) - arrivals
    winner = sink_f.argmax(axis=0)
    crit = {k: np.zeros(n, bool) for k in names}
    for j, s in enumerate(sinks):
        crit[s] |= winner == j
    attr = {}
    for name in reversed(names):  # stage_records is in topological order
        attr[name] = np.where(crit[name], fin[name] - rel[name], 0.0)
        ps = preds.get(name, ())
        if not ps:
            continue
        pred_f = np.stack([fin[p] for p in ps])
        win = pred_f.argmax(axis=0)
        for j, p in enumerate(ps):
            crit[p] |= crit[name] & (win == j)
    denom = max(float(sojourn.mean()), 1e-12)
    return {name: float(attr[name].mean() / denom) for name in names}


def compute_dag_stats(
    stage_records: dict,
    preds: dict,
    sinks: Sequence[str],
    arrivals: Sequence[float],
    stage_capacity: dict,
    stage_busy: dict,
) -> DagStats:
    """Aggregate per-stage records into DAG-level + per-stage statistics.

    `stage_capacity` / `stage_busy` carry each stage pool's slot count and
    accumulated busy copy-seconds (for per-stage utilization via
    `compute_stats`).  Stage dicts must be in topological order.
    """
    if not stage_records:
        raise ValueError("no stage records")
    arrivals = np.asarray(arrivals, dtype=np.float64)
    sink_fin = np.stack(
        [np.array([r.finish for r in stage_records[s]]) for s in sinks]
    )
    soj = sink_fin.max(axis=0) - arrivals
    wait = sum(
        np.array([r.wait for r in v]) for v in stage_records.values()
    )
    svc = sum(
        np.array([r.service for r in v]) for v in stage_records.values()
    )
    cost = sum(
        np.array([r.cost for r in v]) for v in stage_records.values()
    )
    makespan = float(sink_fin.max() - arrivals.min())
    stage = {
        name: compute_stats(recs, stage_capacity[name], stage_busy[name])
        for name, recs in stage_records.items()
    }
    p50, p99, p999 = tail_quantiles(soj, (50.0, 99.0, 99.9))
    return DagStats(
        n_jobs=arrivals.shape[0],
        mean_sojourn=float(soj.mean()),
        mean_wait=float(wait.mean()),
        mean_service=float(svc.mean()),
        mean_cost=float(cost.mean()),
        throughput=float(arrivals.shape[0] / max(makespan, 1e-12)),
        p50_sojourn=float(p50),
        p99_sojourn=float(p99),
        p999_sojourn=float(p999),
        sojourn_std_err=_batch_means_se(soj),
        critical_path_shares=dag_critical_path_shares(
            stage_records, preds, sinks, arrivals
        ),
        stage=stage,
    )
