"""Event-engine ground truth for DAG jobs: stage-aware gang admission.

A copy of `repro.dag.engine` for the port: the event engine runs on the
host and takes its stage distributions on the CPU.

Every stage of a `JobDAG` owns a dedicated pool (capacity = c·n_tasks
slots, the map-slot / reduce-slot split) realized as its own
`fleet.FleetScheduler` — so each stage keeps the full single-stage
semantics exactly as its own tests hold them: gang admission, best-effort
per-stage replication via the stage's (p, r, keep|kill) policy, delayed
relaunch, Definition-2 billing.  What is new is the composition:

  * all stage schedulers share ONE event heap through `events.OwnedHeap`
    views, so copy completions, forks, and admissions across stages
    interleave in true global time order under a single clock;
  * a job *re-enters the queue per stage*: when the driver observes a
    stage completion (the scheduler's `job_done_hook`), it checks the
    job's barrier — once every predecessor stage has finished, it pushes a
    barrier-release event (an `arrive` for the successor's scheduler) at
    the releasing stage's finish time, which by construction is the max
    over the predecessors' finishes;
  * per-stage records are kept per job, so DAG-level metrics (sojourn =
    arrival → last sink barrier, cost = Σ stages, critical-path shares)
    come straight from `fleet.metrics.compute_dag_stats`.

Default placement is "aligned" (one-class gang blocks) because that is the
exact discrete-event realization of the vectorized stage-composed engine
(`repro_torch.dag.rollout`) — the agreement tests and `chip_smoke.py`'s
phase `dag_event` race the two on shared configs.  "pooled" placement is allowed for
general work-conserving runs.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Sequence

import numpy as np

from ..fleet.events import EventHeap, OwnedHeap
from ..fleet.metrics import DagStats, compute_dag_stats
from ..fleet.scheduler import FleetScheduler, JobRecord
from ..fleet.workload import Job

from .graph import JobDAG

__all__ = [
    "DagFleetConfig",
    "DagFleetReport",
    "DagFleetScheduler",
    "DagFleetSim",
    "DagJobRecord",
    "poisson_arrivals",
    "run_dag_fleet",
]


def poisson_arrivals(n_jobs: int, rate: float, seed: int = 0) -> np.ndarray:
    """Poisson(λ=rate) DAG-job arrival instants (the workload of the
    vectorized rollout, realized as concrete times)."""
    if rate <= 0:
        raise ValueError("rate must be > 0")
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate, size=n_jobs))


@dataclasses.dataclass
class DagJobRecord:
    """One DAG job across all its stages."""

    job_id: int
    arrival: float
    finish: float  # last sink stage's barrier
    cost: float  # Σ stages' Definition-2 costs
    stages: dict  # stage name -> that stage's JobRecord

    @property
    def sojourn(self) -> float:
        return self.finish - self.arrival

    @property
    def wait(self) -> float:
        """Total queueing delay across stages."""
        return sum(r.wait for r in self.stages.values())


class DagFleetScheduler:
    """Drives one `FleetScheduler` per stage on a shared heap; owns the
    barrier logic between them."""

    def __init__(
        self,
        dag: JobDAG,
        policies: Optional[Sequence] = None,
        relaunch_delay: float = 0.0,
        fork_overhead: float = 0.0,
        placement: str = "aligned",
        seed: int = 0,
        recorder=None,  # repro_torch.obs Recorder; None = the process-wide one
    ):
        from ..obs import trace as _trace

        self.dag = dag
        self.policies = dag.validate_policy_vector(policies)
        self.heap = EventHeap()
        self._recorder = recorder
        self.stage_scheds: list[FleetScheduler] = []
        for i, spec in enumerate(dag.stages):
            sched = FleetScheduler(
                capacity=spec.c * spec.n_tasks,
                default_policy=self.policies[i],
                relaunch_delay=relaunch_delay,
                fork_overhead=fork_overhead,
                placement=placement,
                # decorrelate stage streams while staying reproducible
                seed=seed * 9973 + i,
                recorder=recorder,
                # each stage gets its own Perfetto process row
                obs_pid=_trace.PID_DAG_BASE + i,
            )
            # swap in the shared-heap view BEFORE any event exists, and
            # observe completions for barrier releases
            sched.heap = OwnedHeap(self.heap, sched)
            sched.job_done_hook = partial(self._on_stage_done, i)
            self.stage_scheds.append(sched)
        self._done: list[set] = []
        self.stage_records: dict = {name: {} for name in dag.names}

    def _rec(self):
        from ..obs import trace as _trace

        return self._recorder if self._recorder is not None else _trace.get_recorder()

    # ------------------------------------------------------------- barriers
    def _release(self, stage_idx: int, job_id: int, t: float) -> None:
        """Barrier release: job `job_id` enters stage `stage_idx`'s queue."""
        spec = self.dag.stages[stage_idx]
        job = Job(
            job_id=job_id,
            arrival=t,
            n_tasks=spec.n_tasks,
            dist=spec.dist,
            policy=self.policies[stage_idx],
        )
        self.stage_scheds[stage_idx].heap.push(t, "arrive", job)

    def _on_stage_done(self, stage_idx: int, record: JobRecord) -> None:
        name = self.dag.stages[stage_idx].name
        self.stage_records[name][record.job_id] = record
        done = self._done[record.job_id]
        done.add(stage_idx)
        for succ in self.dag.succs[name]:
            if all(self.dag.index[d] in done for d in self.dag.preds[succ]):
                # this stage finished last among the preds, so the release
                # instant record.finish IS the barrier max
                succ_idx = self.dag.index[succ]
                rec = self._rec()
                if rec.enabled:
                    from ..obs import trace as _trace

                    rec.instant(
                        "barrier_release", "dag", record.finish,
                        pid=_trace.PID_DAG_BASE + succ_idx, tid=record.job_id,
                        args={"from": name, "to": succ},
                    )
                self._release(succ_idx, record.job_id, record.finish)

    # ------------------------------------------------------------------ run
    def run(self, arrivals: Sequence[float]) -> list[DagJobRecord]:
        arrivals = [float(a) for a in arrivals]
        n = len(arrivals)
        if n == 0:
            raise ValueError("need at least one DAG job arrival")
        rec = self._rec()
        if rec.enabled:
            from ..obs import trace as _trace

            self.heap.recorder = rec
            for i, spec in enumerate(self.dag.stages):
                rec.name_process(_trace.PID_DAG_BASE + i, f"stage:{spec.name}")
            self._dag_pid = _trace.PID_DAG_BASE + len(self.dag.stages)
            rec.name_process(self._dag_pid, "dag.jobs")
        self._done = [set() for _ in range(n)]
        for j, t in enumerate(arrivals):
            for src in self.dag.sources:
                self._release(self.dag.index[src], j, t)
        while True:
            ev = self.heap.pop()
            if ev is None:
                break
            # every event on the shared heap was pushed through an OwnedHeap
            # view and carries its stage scheduler as `owner`
            ev.owner.handle(ev)
        for spec, sched in zip(self.dag.stages, self.stage_scheds):
            if sched.queue:
                stuck = [j.job_id for j in sched.queue]
                raise RuntimeError(
                    f"stage {spec.name!r}: jobs {stuck} can never be admitted"
                )
        out = []
        for j, t in enumerate(arrivals):
            if len(self._done[j]) != len(self.dag.stages):
                raise RuntimeError(f"job {j} finished only {self._done[j]}")
            stages = {
                name: self.stage_records[name][j] for name in self.dag.names
            }
            djr = DagJobRecord(
                job_id=j,
                arrival=t,
                finish=max(stages[s].finish for s in self.dag.sinks),
                cost=sum(r.cost for r in stages.values()),
                stages=stages,
            )
            if rec.enabled:
                # top-level DAG span: the per-stage queue/service spans of
                # the same tid nest inside it on the stage rows
                rec.span("dag_job", "dag", djr.arrival, djr.sojourn,
                         pid=self._dag_pid, tid=j,
                         args={"cost": round(djr.cost, 6)})
            out.append(djr)
        return out


@dataclasses.dataclass
class DagFleetConfig:
    dag: JobDAG
    policies: Optional[Sequence] = None  # None -> spec policies
    relaunch_delay: float = 0.0
    fork_overhead: float = 0.0
    placement: str = "aligned"  # the KW fast-path oracle; "pooled" also legal
    seed: int = 0
    # observability flag, same convention as FleetConfig.obs (None/False =
    # process-wide recorder, True = fresh private Recorder, or a Recorder)
    obs: object = None


@dataclasses.dataclass
class DagFleetReport:
    jobs: list[DagJobRecord]
    stage_records: dict  # stage name -> [JobRecord] in job order
    stats: DagStats
    # the repro_torch.obs Recorder that captured the run (NullRecorder if disabled)
    trace: Optional[object] = None

    @property
    def critical_path_shares(self) -> dict:
        return self.stats.critical_path_shares


class DagFleetSim:
    """Façade: arrivals -> per-stage schedulers -> DAG metrics in one call.

        from repro_torch.dag import DagFleetConfig, DagFleetSim, JobDAG, StageSpec

        dag = JobDAG.map_reduce(8, 4, map_dist, reduce_dist, c_map=2)
        report = DagFleetSim(DagFleetConfig(dag)).run(
            poisson_arrivals(500, rate=0.3))
        print(report.stats.row())
    """

    def __init__(self, config: DagFleetConfig):
        self.config = config

    def run(self, arrivals: Sequence[float]) -> DagFleetReport:
        from ..obs import trace as _trace

        cfg = self.config
        recorder = _trace.resolve_recorder(cfg.obs)
        sched = DagFleetScheduler(
            cfg.dag,
            policies=cfg.policies,
            relaunch_delay=cfg.relaunch_delay,
            fork_overhead=cfg.fork_overhead,
            placement=cfg.placement,
            seed=cfg.seed,
            recorder=recorder,
        )
        jobs = sched.run(arrivals)
        stage_records = {
            name: [sched.stage_records[name][j] for j in range(len(jobs))]
            for name in cfg.dag.names
        }
        stats = compute_dag_stats(
            stage_records,
            cfg.dag.preds,
            cfg.dag.sinks,
            [j.arrival for j in jobs],
            stage_capacity={
                s.name: sub.capacity
                for s, sub in zip(cfg.dag.stages, sched.stage_scheds)
            },
            stage_busy={
                s.name: sub.busy_time
                for s, sub in zip(cfg.dag.stages, sched.stage_scheds)
            },
        )
        return DagFleetReport(
            jobs=jobs, stage_records=stage_records, stats=stats,
            trace=recorder if recorder is not None else _trace.get_recorder(),
        )


def run_dag_fleet(arrivals: Sequence[float], config: DagFleetConfig) -> DagFleetReport:
    return DagFleetSim(config).run(arrivals)
