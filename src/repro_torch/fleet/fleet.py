"""Top-level fleet façade: workload -> scheduler -> metrics in one call.

A copy of `repro.fleet.fleet` for the port; the event engine runs on the
host, and only the controller it builds reaches the device
(`FleetConfig.device`, None meaning the card).

    from repro_torch.core import ShiftedExp, SingleForkPolicy
    from repro_torch.fleet import FleetConfig, FleetSim, poisson_workload

    jobs = poisson_workload(1000, rate=0.3, n_tasks=20, dist=ShiftedExp(1, 1))
    report = FleetSim(FleetConfig(capacity=20,
                                  policy=SingleForkPolicy(0.1, 1))).run(jobs)
    print(report.stats.row())

`FleetConfig.adapt=True` swaps the fixed policy for a closed-loop
controller.  The default (`adapt_mode="fleet"`) is the load-aware
`fleet.adaptive.FleetPolicyController`: it estimates the arrival rate and
service distribution from the fleet's own telemetry and re-plans
(p, r, keep|kill) through the vectorized Kiefer–Wolfowitz policy search,
so replication backs off before it pushes the offered load past ρ = 1.
`adapt_mode="online"` keeps the legacy single-job controller (paper §5.2),
which optimizes per-job (E[T], E[C]) and is blind to queueing.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from ..core.adaptive import OnlinePolicyController
from ..core.policy import BASELINE

from .adaptive import FleetPolicyController
from .metrics import FleetStats, compute_stats
from .scheduler import FleetScheduler, JobRecord
from .workload import Job, MachineClass, Policy

__all__ = ["FleetConfig", "FleetReport", "FleetSim", "run_fleet"]


@dataclasses.dataclass
class FleetConfig:
    capacity: Optional[int] = None  # or derive from `classes`
    policy: Policy = BASELINE  # default for jobs with policy=None (any algebra family)
    discipline: str = "fifo"  # or "priority"
    relaunch_delay: float = 0.0  # delayed-relaunch knob
    preempt_replicas: bool = False  # cancel speculation to admit queued work
    fork_overhead: float = 0.0  # per-replica launch latency
    adapt: bool = False  # learn the policy online
    adapt_mode: str = "fleet"  # "fleet" (load-aware) or "online" (single-job §5.2)
    objective: str = "latency"  # controller objective when adapt=True
    search_kernel: bool = False  # c = 1 search queues through the KW kernel too
    seed: int = 0
    # where the controller's search (or bootstrap) runs when adapt=True:
    # None means the card, "cpu" the plain PyTorch path
    device: object = None
    # heterogeneous pools: class specs + copy placement ("pooled" packs
    # fastest-free-first and may split a job across classes; "aligned"
    # reserves a one-class gang block per job — the KW fast-path oracle)
    classes: Optional[Sequence[MachineClass]] = None
    placement: str = "pooled"
    # observability: False/None = emit to the process-wide recorder (a
    # no-op unless `repro_torch.obs.enable()` was called); True = give this sim
    # its own fresh Recorder; a `repro_torch.obs.Recorder` = use that one.
    # Either way the live recorder comes back as `FleetReport.trace`.
    obs: object = None
    # chaos: a `repro_torch.faults.FaultSpec` (crash processes / outage schedule /
    # task-failure law + retry budget); None or a disabled spec reproduces
    # the historical engine bitwise
    fault: object = None
    # graceful degradation: shed arrivals of priority >= shed_min_priority
    # while the estimated occupancy ρ̂ exceeds shed_rho (None = never shed)
    shed_rho: Optional[float] = None
    shed_min_priority: int = 1


@dataclasses.dataclass
class FleetReport:
    records: list[JobRecord]
    stats: FleetStats
    capacity: int
    max_busy: int  # peak concurrently-busy slots (conservation witness)
    busy_time: float
    # FleetPolicyController or OnlinePolicyController, per adapt_mode
    controller: Optional[object] = None
    # the repro_torch.obs Recorder that captured this run (NullRecorder when
    # disabled)
    trace: Optional[object] = None
    # chaos / degradation counters (all zero without a fault spec)
    n_task_failures: int = 0
    n_crash_kills: int = 0
    n_retries: int = 0
    n_failed: int = 0
    n_timeouts: int = 0
    n_shed: int = 0

    @property
    def final_policy(self) -> Optional[str]:
        return self.controller.current_policy().label() if self.controller else None


def _build_controller(config: "FleetConfig"):
    if not config.adapt:
        return None
    if config.adapt_mode == "fleet":
        return FleetPolicyController(
            objective=config.objective, seed=config.seed,
            use_kernel=config.search_kernel, device=config.device,
        )
    if config.adapt_mode == "online":
        return OnlinePolicyController(
            objective=config.objective, seed=config.seed, device=config.device
        )
    raise ValueError(f"unknown adapt_mode {config.adapt_mode!r}")


class FleetSim:
    def __init__(self, config: FleetConfig):
        self.config = config
        self.controller = _build_controller(config)

    def run(self, jobs: Sequence[Job]) -> FleetReport:
        from ..obs import trace as _trace

        cfg = self.config
        recorder = _trace.resolve_recorder(cfg.obs)
        sched = FleetScheduler(
            capacity=cfg.capacity,
            default_policy=cfg.policy,
            discipline=cfg.discipline,
            relaunch_delay=cfg.relaunch_delay,
            preempt_replicas=cfg.preempt_replicas,
            fork_overhead=cfg.fork_overhead,
            controller=self.controller,
            seed=cfg.seed,
            classes=cfg.classes,
            placement=cfg.placement,
            recorder=recorder,
            fault=cfg.fault,
            shed_rho=cfg.shed_rho,
            shed_min_priority=cfg.shed_min_priority,
        )
        if self.controller is not None and hasattr(self.controller, "bind_recorder"):
            self.controller.bind_recorder(recorder)
        records = sched.run(jobs)
        stats = compute_stats(
            records,
            sched.capacity,
            sched.busy_time,
            classes=sched.classes if cfg.classes is not None else None,
            busy_by_class=sched.busy_by_class if cfg.classes is not None else None,
            down_time=sched.down_time,
            repairs_by_class=sched.repairs_by_class,
        )
        return FleetReport(
            records=records,
            stats=stats,
            capacity=sched.capacity,
            max_busy=sched.max_busy,
            busy_time=sched.busy_time,
            controller=self.controller,
            trace=recorder if recorder is not None else _trace.get_recorder(),
            n_task_failures=sched.n_task_failures,
            n_crash_kills=sched.n_crash_kills,
            n_retries=sched.n_retries,
            n_failed=sched.n_failed,
            n_timeouts=sched.n_timeouts,
            n_shed=sched.n_shed,
        )


def run_fleet(jobs: Sequence[Job], config: FleetConfig) -> FleetReport:
    return FleetSim(config).run(jobs)
