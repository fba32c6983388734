"""Hedged serving: the single-fork policy applied to inference requests.

A batch of decode requests fans out across replicas of the model server;
the scheduler watches completions and, once the (1-p) quantile has
finished, hedges the stragglers with r duplicate requests (keep) or
cancel-and-resend (kill).  This is 'the tail at scale' request hedging with
the paper's machinery choosing (p, r, keep|kill) from measured latency
traces instead of hand-tuned timeouts.

Counterpart of `repro.runtime.serving`, with both of its backends:
  * `HedgedServer`      — one batch at a time on a dedicated `SimCluster`
    (the paper's unlimited-pool regime);
  * `FleetHedgedServer` — many concurrent batches through the port's
    fleet: batches arrive over time, queue for a finite replica pool, and
    every hedge competes with admission of the next batch — the regime a
    real deployment bills for.

`device` (None means the card) is where each server's controller plans:
the bootstrap of `HedgedServer`'s, the KW policy search of
`FleetHedgedServer`'s.  The fleet's event engine runs on the host, so
`FleetHedgedServer`'s `latency_dist` is a distribution on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np

from ..core.adaptive import OnlinePolicyController
from ..core.policy import SingleForkPolicy
from ..device import resolve_device
from ..obs.registry import MetricsRegistry
from ..obs.sketch import QuantileSketch
from .cluster import SimCluster
from .executor import SpeculativeExecutor


@dataclasses.dataclass
class ServeStats:
    latency: float
    cost: float
    p50: float
    p99: float
    policy: str
    p999: float = float("nan")


class HedgedServer:
    def __init__(
        self,
        cluster: SimCluster,
        serve_fn: Callable[[object], object],
        policy: Optional[SingleForkPolicy] = None,
        adapt: bool = True,
        device=None,
    ):
        self.device = resolve_device(device)
        self.cluster = cluster
        self.executor = SpeculativeExecutor(cluster)
        self.serve_fn = serve_fn
        self.controller = OnlinePolicyController(objective="latency", device=self.device)
        self._policy = policy or SingleForkPolicy(p=0.05, r=1, keep=True)
        self.adapt = adapt
        self.latency_sketch = QuantileSketch()

    def serve_batch(self, requests: Sequence[object]) -> tuple[list, ServeStats]:
        tasks = [(lambda r=r: self.serve_fn(r)) for r in requests]
        report = self.executor.run(tasks, self._policy)
        for d in report.task_durations:
            self.controller.record_task_time(d)
        self.controller.record_job_complete(n_tasks=len(requests))
        if self.adapt and self.controller.current_policy().p > 0:
            self._policy = self.controller.current_policy()
        # the batch's finish times stream into the server's lifetime sketch,
        # so per-batch ServeStats carry the sketch's tails over every batch
        # served so far
        finishes = np.array([r.finish_time for r in report.results])
        self.latency_sketch.add_many(finishes)
        p50, p99, p999 = self.latency_sketch.quantiles((0.5, 0.99, 0.999))
        stats = ServeStats(
            latency=report.latency,
            cost=report.cost,
            p50=p50,
            p99=p99,
            p999=p999,
            policy=self._policy.label(),
        )
        return [r.value for r in report.results], stats


@dataclasses.dataclass
class BatchOutcome:
    """One served batch in fleet mode: values + its queueing telemetry.

    Under chaos / graceful degradation a batch may not be served at all:
    `failed=True` with `failure` in {"shed", "timeout", "max_attempts"}
    and an empty `values` list (the serve_fn never ran for it)."""

    values: list
    arrival: float
    start: float
    finish: float
    cost: float
    failed: bool = False
    failure: str = ""

    @property
    def sojourn(self) -> float:
        return self.finish - self.arrival


class FleetHedgedServer:
    """Fleet-backed serving: each request batch is one job competing for a
    finite pool of `capacity` model replicas.

    Values are computed exactly once per request (hedged copies are
    value-identical, as in `SpeculativeExecutor`); per-replica latency is
    drawn from `latency_dist` inside the fleet's discrete-event engine, so
    queueing delay between batches is part of every reported latency.
    """

    def __init__(
        self,
        capacity: Optional[int] = None,
        latency_dist=None,
        serve_fn: Callable[[object], object] = None,
        policy=None,  # any algebra policy; None -> hedged default
        adapt: bool = True,
        adapt_mode: str = "fleet",
        preempt_replicas: Optional[bool] = None,
        seed: int = 0,
        classes=None,
        placement: str = "pooled",
        dag=None,
        obs=None,
        deadlines: Optional[dict] = None,
        fault=None,
        shed_rho: Optional[float] = None,
        shed_min_priority: int = 1,
        slos=None,
        device=None,
    ):
        """`capacity` is a single homogeneous replica pool; alternatively
        pass `classes` (a sequence of `repro_torch.fleet.MachineClass`, e.g. a
        fast GPU pool plus a slow spot-instance pool) and a `placement`
        mode — "aligned" reserves a one-class gang block per batch, which
        is the regime the vectorized planner (`repro_torch.fleet.vector`) models,
        so capacity decisions simulated there transfer directly.

        `policy` accepts ANY algebra policy (`core.policy`): single-fork,
        multi-fork schedules, `delayed_relaunch(t)` wall-clock hedging,
        `group_replication(p, r, d)` group selection, or `on_class(...)`
        pinning batches to one replica class — the backing fleet engine
        executes all families natively.

        With `adapt=True` the hedging policy is closed-loop:
        `adapt_mode="fleet"` (default) uses the load-aware
        `fleet.adaptive.FleetPolicyController`, which watches batch
        arrivals and replica latencies and re-plans (p, r, keep|kill)
        through the vectorized KW policy search so hedging backs off
        before it saturates the replica pool; `adapt_mode="online"` keeps
        the single-batch learner (paper §5.2).

        `dag` switches the backend to multi-stage pipeline serving
        (`repro_torch.dag`): each batch is one DAG job traversing e.g. a prefill
        stage pool then a decode stage pool, with the stages' own task
        counts, latency distributions, per-stage hedging policies, and a
        barrier between stages; `capacity` / `latency_dist` / `adapt` are
        then carried by the DAG's stage specs and must be omitted.

        `obs` follows the fleet convention (None → global recorder,
        True → fresh private Recorder, a Recorder → that one) and is
        handed to the backing sim; serving-side tail latencies are kept
        per priority class in `self.metrics` regardless (see
        `tail_latencies`).

        Graceful degradation (the chaos-aware serving ladder):
        `deadlines` maps a priority class to a relative completion deadline
        — a batch not finished by arrival + deadline is killed (timeout);
        `fault` is a `repro_torch.faults.FaultSpec` executed by the backing fleet
        (crashes, retries, task failures); `shed_rho` turns on admission
        load-shedding for priorities >= `shed_min_priority` whenever the
        estimated occupancy exceeds it.  Shed / timed-out / failed batches
        come back as `BatchOutcome(failed=True)` and land in the
        serve.shed / serve.timeout / serve.failed counters alongside the
        fleet.availability / fleet.mttr gauges in `self.metrics`.

        `slos` turns on error-budget tracking (`repro_torch.obs.slo`): one
        `SLO` applied to every priority class, or a {priority: SLO}
        mapping.  Each served batch's sojourn lands in the matching
        tracker's windowed sketch; multi-window burn rates are emitted as
        `slo.burn_rate{priority,window}` gauges after every
        `serve_stream` (plus instants on the serving trace row) and
        summarized by `slo_report()`.

        `device` (None means the card) is where the controller's policy
        search runs, handed to `FleetConfig(device=...)`; the event engine
        and the latency draws stay on the host."""
        from ..fleet import FleetConfig, FleetSim
        from ..obs.trace import resolve_recorder

        self.metrics = MetricsRegistry()
        # resolve obs=True ONCE so the backing sim and the server's own
        # emissions (SLO burn instants) share the same private recorder
        self._rec = resolve_recorder(obs)
        obs = self._rec if self._rec is not None else obs
        self._obs = obs
        self.deadlines = dict(deadlines) if deadlines else {}
        self.slos = slos
        self._slo_trackers: dict = {}

        if dag is not None:
            from ..dag import DagFleetConfig, DagFleetSim

            if deadlines or fault is not None or shed_rho is not None:
                raise ValueError(
                    "dag mode: deadlines/fault/shed_rho are single-pool "
                    "fleet knobs; chaos for pipelines runs through "
                    "dag.rollout.dag_frontier(fault=...) or per-stage "
                    "FleetSim configs"
                )
            if capacity is not None or classes is not None or latency_dist is not None:
                raise ValueError(
                    "dag mode: capacity/classes/latency_dist come from the "
                    "DAG's stage specs; pass only the dag"
                )
            # the remaining single-pool knobs are owned by the stage specs
            # too — reject them instead of silently dropping them
            if (policy is not None or preempt_replicas is not None
                    or placement != "pooled" or adapt_mode != "fleet"
                    or adapt is not True):
                raise ValueError(
                    "dag mode: per-stage policies live on the DAG's stage "
                    "specs and adaptation/placement are not supported; leave "
                    "policy/adapt/adapt_mode/preempt_replicas/placement at "
                    "their defaults"
                )
            if serve_fn is None:
                raise ValueError("serve_fn is required")
            self.device = resolve_device(device)
            self.dag = dag
            self.capacity = sum(s.c * s.n_tasks for s in dag.stages)
            self.latency_dist = None
            self.serve_fn = serve_fn
            self.sim = DagFleetSim(DagFleetConfig(dag=dag, seed=seed, obs=obs))
            return
        self.dag = None
        if capacity is None and classes is None:
            raise ValueError("need either capacity or classes")
        if latency_dist is None or serve_fn is None:
            raise ValueError("latency_dist and serve_fn are required")
        if preempt_replicas is None:
            # default: hedge-yielding admission, except where it has no
            # effect (aligned); an EXPLICIT True still reaches the
            # scheduler, which rejects the combination like FleetSim does
            preempt_replicas = placement != "aligned"
        self.device = resolve_device(device)
        self.capacity = capacity if capacity is not None else sum(k.slots for k in classes)
        self.latency_dist = latency_dist
        self.serve_fn = serve_fn
        self.sim = FleetSim(
            FleetConfig(
                capacity=capacity,
                policy=policy or SingleForkPolicy(p=0.05, r=1, keep=True),
                preempt_replicas=preempt_replicas,
                adapt=adapt,
                adapt_mode=adapt_mode,
                seed=seed,
                classes=classes,
                placement=placement,
                obs=obs,
                fault=fault,
                shed_rho=shed_rho,
                shed_min_priority=shed_min_priority,
                device=self.device,
            )
        )

    @property
    def controller(self):
        """The policy controller learning across batches (None if fixed)."""
        return None if self.dag is not None else self.sim.controller

    def serve_stream(
        self,
        batches: Sequence[Sequence[object]],
        arrivals: Optional[Sequence[float]] = None,
        rate: float = 1.0,
        seed: int = 0,
        priorities: Optional[Sequence[int]] = None,
    ) -> tuple[list[BatchOutcome], "object"]:
        """Serve many batches arriving over time; returns per-batch outcomes
        (values in request order) and the fleet-level stats.

        `priorities` assigns one priority class per batch (lower = more
        urgent; it also drives the scheduler's "priority" discipline).
        Each batch's sojourn streams into a per-class latency histogram in
        `self.metrics`, so `tail_latencies()` reports live p50/p99/p999
        per class without retaining samples."""
        from ..fleet import Job

        if arrivals is None:
            rng = np.random.default_rng(seed)
            arrivals = np.cumsum(rng.exponential(1.0 / rate, size=len(batches)))
        if len(arrivals) != len(batches):
            raise ValueError("need one arrival time per batch")
        if priorities is None:
            priorities = [0] * len(batches)
        elif len(priorities) != len(batches):
            raise ValueError("need one priority per batch")
        if self.dag is not None:
            # pipeline mode: each batch is one DAG job through the stage
            # pools (task counts and latency draws come from the specs);
            # values still computed exactly once per request
            report = self.sim.run(arrivals)
            outcomes = [
                BatchOutcome(
                    values=[self.serve_fn(r) for r in batch],
                    arrival=rec.arrival,
                    start=min(s.start for s in rec.stages.values()),
                    finish=rec.finish,
                    cost=rec.cost,
                )
                for rec, batch in zip(report.jobs, batches)
            ]
            self._observe_latencies(outcomes, priorities)
            return outcomes, report.stats
        jobs = [
            Job(
                job_id=i,
                arrival=float(arrivals[i]),
                n_tasks=len(b),
                dist=self.latency_dist,
                priority=int(priorities[i]),
                deadline=self.deadlines.get(int(priorities[i])),
            )
            for i, b in enumerate(batches)
        ]
        report = self.sim.run(jobs)
        outcomes = []
        for rec, batch in zip(report.records, batches):
            outcomes.append(
                BatchOutcome(
                    # a shed / timed-out / failed batch was never served —
                    # no values, and the caller sees failed=True + why
                    values=[] if rec.failed else [self.serve_fn(r) for r in batch],
                    arrival=rec.arrival,
                    start=rec.start,
                    finish=rec.finish,
                    cost=rec.cost,
                    failed=rec.failed,
                    failure=rec.failure,
                )
            )
        self._observe_degradation(report)
        self._observe_latencies(outcomes, priorities)
        return outcomes, report.stats

    def _observe_latencies(self, outcomes, priorities) -> None:
        for out, pri in zip(outcomes, priorities):
            if out.failed:  # shed/timeout records carry no served latency
                continue
            self.metrics.histogram(
                "serve.sojourn", labels={"priority": str(int(pri))}
            ).observe(out.sojourn)
            tracker = self._slo_tracker_for(int(pri))
            if tracker is not None:
                tracker.observe(out.finish, out.sojourn)
        if self._slo_trackers:
            self._emit_slo()

    def _slo_tracker_for(self, pri: int):
        """Lazy per-priority tracker creation from the `slos` config."""
        if self.slos is None:
            return None
        tracker = self._slo_trackers.get(pri)
        if tracker is None:
            from ..obs.slo import SLO, SLOTracker

            slo = self.slos if isinstance(self.slos, SLO) else self.slos.get(pri)
            if slo is None:
                return None
            tracker = self._slo_trackers[pri] = SLOTracker(slo)
        return tracker

    def _emit_slo(self) -> None:
        """Burn rates → registry gauges + trace instants (serving pid)."""
        from ..obs.trace import PID_SERVING, get_recorder

        rec = self._rec if self._rec is not None else get_recorder()
        for pri, tracker in sorted(self._slo_trackers.items()):
            now = tracker.window_sketch.now
            for w, rate in tracker.burn_rates().items():
                self.metrics.gauge(
                    "slo.burn_rate",
                    labels={"priority": str(pri), "window": f"{w:g}"},
                ).set(rate)
                if rec.enabled:
                    rec.instant(
                        "slo_burn", "serving", now, pid=PID_SERVING,
                        args={"priority": pri, "window": w,
                              "burn_rate": round(rate, 4),
                              "slo": tracker.slo.name},
                    )
            self.metrics.gauge(
                "slo.burning", labels={"priority": str(pri)}
            ).set(1.0 if tracker.burning() else 0.0)

    def slo_report(self) -> dict:
        """{priority -> SLOTracker.report()} for every tracked class."""
        return {p: t.report() for p, t in sorted(self._slo_trackers.items())}

    def _observe_degradation(self, report) -> None:
        """Chaos / degradation telemetry into the serving registry: how many
        batches the ladder dropped and how healthy the pool was."""
        if report.n_shed:
            self.metrics.counter("serve.shed").inc(report.n_shed)
        if report.n_timeouts:
            self.metrics.counter("serve.timeout").inc(report.n_timeouts)
        if report.n_failed:
            self.metrics.counter("serve.failed").inc(report.n_failed)
        if report.n_retries:
            self.metrics.counter("serve.retries").inc(report.n_retries)
        stats = report.stats
        self.metrics.gauge("fleet.availability").set(stats.availability)
        if stats.class_mttr:
            vals = [v for v in stats.class_mttr.values() if v == v]
            if vals:
                self.metrics.gauge("fleet.mttr").set(float(np.mean(vals)))

    def tail_latencies(self) -> dict:
        """Live per-priority-class latency tails from the streaming sketch:
        {priority -> {"p50", "p99", "p999", "count"}} over every batch
        served through `serve_stream` so far."""
        tails: dict = {}
        for label_key in self.metrics.labels_for("serve.sojourn"):
            labels = dict(label_key)
            hist = self.metrics.histogram("serve.sojourn", labels=labels)
            p50, p99, p999 = hist.sketch.quantiles((0.5, 0.99, 0.999))
            tails[int(labels["priority"])] = {
                "p50": p50,
                "p99": p99,
                "p999": p999,
                "count": hist.sketch.count,
            }
        return dict(sorted(tails.items()))
