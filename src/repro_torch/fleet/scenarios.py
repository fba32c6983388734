"""Canonical nonstationary fleet scenarios (DESIGN.md §10).

A copy of `repro.fleet.scenarios` for the port.

One definition shared by the gated benchmark (`benchmarks/bench_fleet.py`),
the CI smoke demo (`examples/fleet_adaptive.py`) and the controller tests,
so what CI asserts and what the artifact records never silently diverge.
"""

from __future__ import annotations

import dataclasses

from ..core.distributions import Distribution, Pareto, ShiftedExp, Uniform
from ..core.policy import BASELINE, SingleForkPolicy

from .workload import Job, poisson_workload, regime_shift_workload

__all__ = ["CHAOS", "ChaosScenario", "REGIME_SHIFT", "RegimeShiftScenario"]


@dataclasses.dataclass(frozen=True)
class RegimeShiftScenario:
    """Calm + heavy tail, then rush hour + bounded tail.

    Act 1: arrivals at `lam_a` with Pareto task times — the fleet is mostly
    idle and replication slashes the straggler tail almost for free, so the
    regime-A optimum is an aggressive fork.  Act 2: `lam_b` (~4×) with
    bounded Uniform task times — stragglers barely exist and every replica
    competes with admissions, so the act-1 winner inflates E[C], drives
    ρ = λ·n·E[C]/capacity past 1, and collapses the queue.  Any fixed
    policy tuned on act 1 meets act 2 head-on; the load-aware controller
    must detect the drift and back replication off.
    """

    n_tasks: int = 16
    capacity: int = 48  # 3 gang blocks
    lam_a: float = 0.25
    lam_b: float = 1.1
    dist_a: Distribution = Pareto(1.5, 0.6)  # heavy tail, mean 1.8
    dist_b: Distribution = Uniform(1.5, 2.5)  # bounded, mean 2.0
    shift_frac: float = 0.5
    seed: int = 7
    # the fixed-policy grid an operator would sweep when tuning on act 1
    fixed_grid: tuple = (
        BASELINE,
        SingleForkPolicy(0.05, 1, True),
        SingleForkPolicy(0.1, 1, True),
        SingleForkPolicy(0.2, 1, False),
        SingleForkPolicy(0.3, 2, False),
        SingleForkPolicy(0.5, 2, False),
    )

    def workload(self, n_jobs: int) -> list[Job]:
        return regime_shift_workload(
            n_jobs, self.lam_a, self.lam_b, self.n_tasks,
            self.dist_a, self.dist_b, shift_frac=self.shift_frac, seed=self.seed,
        )

    def shift_index(self, n_jobs: int) -> int:
        return int(self.shift_frac * n_jobs)


REGIME_SHIFT = RegimeShiftScenario()


@dataclasses.dataclass(frozen=True)
class ChaosScenario:
    """Mid-run outage + task failures: the canonical chaos drill.

    A steady Poisson stream on a single pool; at `outage_start` a fraction
    `kill_frac` of the slots goes down for `outage_duration` (the
    deterministic `ChaosSchedule`, so examples and tests can assert exact
    windows), while every task attempt independently fails with
    probability `q`.  The ladder under test: retries absorb task failures,
    the shed guard (at `shed_rho`) drops best-effort arrivals while the
    shrunken pool is saturated, and tails recover after the outage ends.
    Shared by `examples/fleet_chaos.py`, `benchmarks/bench_fleet.py`'s
    chaos lane, and `tests/test_faults.py`.
    """

    n_tasks: int = 16
    capacity: int = 64  # 4 gang blocks
    lam: float = 0.5
    dist: Distribution = ShiftedExp(1.0, 1.0)  # Δ=1, mean 2
    q: float = 0.05
    kill_frac: float = 0.3
    outage_start: float = 120.0
    outage_duration: float = 120.0
    shed_rho: float = 0.9
    seed: int = 11
    policy: SingleForkPolicy = SingleForkPolicy(0.1, 1, True)

    def workload(self, n_jobs: int, priority_levels: int = 2) -> list[Job]:
        """`priority_levels=2` gives the shed guard a best-effort class
        (priority 1) to drop while priority 0 stays protected."""
        return poisson_workload(
            n_jobs, rate=self.lam, n_tasks=self.n_tasks, dist=self.dist,
            seed=self.seed, priority_levels=priority_levels,
        )

    def fault(self):
        from ..faults import FaultSpec, schedule_for_kill_fraction

        return FaultSpec(
            q=self.q,
            schedule=schedule_for_kill_fraction(
                self.capacity, self.kill_frac,
                start=self.outage_start, duration=self.outage_duration,
            ),
        )

    @property
    def outage_end(self) -> float:
        return self.outage_start + self.outage_duration


CHAOS = ChaosScenario()
