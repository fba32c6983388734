"""Job-arrival workloads for the fleet simulator.

A workload is a list of `Job`s with arrival times and a per-job execution
time distribution; the three generators cover the regimes the queueing
literature cares about:

  * `poisson_workload`  — memoryless arrivals at rate λ (M/G/k-style load);
  * `bursty_workload`   — on/off modulated Poisson (MMPP-flavored): bursts
    at a high rate separated by idle gaps, same mean rate as the Poisson
    workload but much higher arrival variance;
  * `trace_workload`    — replay against the synthesized Google-trace jobs
    (repro.data.traces): each arriving job draws its task-time distribution
    `Empirical(trace)` from one of the trace jobs, so fleet sweeps run on
    the paper's own workload shapes.

Nonstationary generators (the adaptive controller's proving ground):

  * `piecewise_poisson_workload` — λ ramps at known job indices, optional
    per-segment service distributions;
  * `regime_shift_workload`     — one abrupt (λ, F_X) change;
  * `diurnal_workload`          — sinusoidal λ(t) via Lewis–Shedler
    thinning (smooth drift rather than a jump).

Jobs with `policy=None` defer the replication decision to the scheduler
(its default policy or the online controller); a per-job policy overrides.

`MachineClass` describes one homogeneous pool of worker slots; a fleet's
capacity is a sequence of classes (e.g. a fast pool and a cheaper slow
pool whose `speed < 1` stretches every copy's execution time).  The class
specs live here with the workload because together they define the offered
load: ρ = λ·n·E[C] / Σ_k slots_k·speed_k in work units.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np

from ..core.distributions import Distribution, Empirical
from ..core.policy import ForkPolicy, MultiForkPolicy, SingleForkPolicy

__all__ = [
    "Job",
    "MachineClass",
    "poisson_workload",
    "bursty_workload",
    "trace_workload",
    "piecewise_poisson_workload",
    "regime_shift_workload",
    "diurnal_workload",
]

#: any algebra policy the engines accept (see core.policy.as_fork_policy)
Policy = Union[SingleForkPolicy, MultiForkPolicy, ForkPolicy]


@dataclasses.dataclass(frozen=True)
class MachineClass:
    """One homogeneous pool of worker slots.

    `speed` is a service-rate multiplier: a copy whose base execution draw
    is X runs for X / speed wall-clock seconds on this class (speed < 1 is
    a slow pool, speed > 1 an accelerated one).  Cost (Definition 2) bills
    wall-clock, so slow-pool copies are proportionally more expensive.
    """

    name: str
    slots: int
    speed: float = 1.0

    def __post_init__(self):
        if self.slots < 1:
            raise ValueError(f"class {self.name!r}: slots must be >= 1")
        if not self.speed > 0:
            raise ValueError(f"class {self.name!r}: speed must be > 0")


@dataclasses.dataclass
class Job:
    job_id: int
    arrival: float
    n_tasks: int
    dist: Distribution
    policy: Optional[Policy] = None  # None -> scheduler default / controller
    priority: int = 0  # lower value = more urgent (priority discipline)
    # relative completion deadline: the job is killed (terminal `failed`,
    # failure="timeout") if not finished by arrival + deadline; None = no
    # deadline.  The serving layer maps per-priority-class deadlines here.
    deadline: Optional[float] = None

    def __post_init__(self):
        if self.n_tasks < 1:
            raise ValueError(f"job {self.job_id}: n_tasks must be >= 1")
        if self.arrival < 0:
            raise ValueError(f"job {self.job_id}: negative arrival time")
        if self.deadline is not None and not self.deadline > 0:
            raise ValueError(f"job {self.job_id}: deadline must be > 0")


def poisson_workload(
    n_jobs: int,
    rate: float,
    n_tasks: int,
    dist: Distribution,
    seed: int = 0,
    policy: Optional[Policy] = None,
    priority_levels: int = 1,
) -> list[Job]:
    """n_jobs Poisson(λ=rate) arrivals, all with `n_tasks` tasks ~ dist."""
    if rate <= 0:
        raise ValueError("rate must be > 0")
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, size=n_jobs))
    return [
        Job(
            job_id=i,
            arrival=float(arrivals[i]),
            n_tasks=n_tasks,
            dist=dist,
            policy=policy,
            priority=int(rng.integers(0, priority_levels)) if priority_levels > 1 else 0,
        )
        for i in range(n_jobs)
    ]


def bursty_workload(
    n_jobs: int,
    rate: float,
    n_tasks: int,
    dist: Distribution,
    seed: int = 0,
    burst_factor: float = 8.0,
    mean_burst: int = 10,
    policy: Optional[Policy] = None,
) -> list[Job]:
    """On/off arrivals with the same long-run rate as Poisson(rate).

    Bursts of ~`mean_burst` jobs arrive at `burst_factor * rate`; between
    bursts the source idles long enough that the mean rate stays `rate`.
    """
    if rate <= 0 or burst_factor <= 1.0:
        raise ValueError("need rate > 0 and burst_factor > 1")
    rng = np.random.default_rng(seed)
    burst_rate = burst_factor * rate
    # per-job time saved inside a burst must be repaid by idle gaps
    gap_mean = mean_burst * (1.0 / rate - 1.0 / burst_rate)
    t, jobs = 0.0, []
    while len(jobs) < n_jobs:
        # numpy's geometric is supported on {1, 2, ...} with mean mean_burst
        burst_len = int(rng.geometric(1.0 / mean_burst))
        for _ in range(min(burst_len, n_jobs - len(jobs))):
            t += float(rng.exponential(1.0 / burst_rate))
            jobs.append(
                Job(job_id=len(jobs), arrival=t, n_tasks=n_tasks, dist=dist, policy=policy)
            )
        t += float(rng.exponential(gap_mean))
    return jobs


def piecewise_poisson_workload(
    segments: Sequence[tuple],
    n_tasks: int,
    dist: Distribution,
    seed: int = 0,
    policy: Optional[Policy] = None,
    dists: Optional[Sequence[Distribution]] = None,
) -> list[Job]:
    """Piecewise-constant λ: `segments` is a sequence of (rate, n_jobs)
    pairs and the arrival clock carries across segment boundaries, so the
    result is one sorted stream whose rate ramps at known job indices.

    `dists` (optional, one per segment) additionally switches the service
    distribution at each boundary — the regime-shift ingredient the
    adaptive controller's drift test is built for; default: `dist` all the
    way through.
    """
    if not segments:
        raise ValueError("need at least one (rate, n_jobs) segment")
    if dists is not None and len(dists) != len(segments):
        raise ValueError("need one dist per segment")
    rng = np.random.default_rng(seed)
    jobs: list[Job] = []
    t = 0.0
    for si, (rate, n_jobs) in enumerate(segments):
        if rate <= 0 or n_jobs < 0:
            raise ValueError("segment rates must be > 0 and job counts >= 0")
        seg_dist = dists[si] if dists is not None else dist
        for _ in range(int(n_jobs)):
            t += float(rng.exponential(1.0 / rate))
            jobs.append(
                Job(
                    job_id=len(jobs),
                    arrival=t,
                    n_tasks=n_tasks,
                    dist=seg_dist,
                    policy=policy,
                )
            )
    return jobs


def regime_shift_workload(
    n_jobs: int,
    rate_before: float,
    rate_after: float,
    n_tasks: int,
    dist_before: Distribution,
    dist_after: Distribution,
    shift_frac: float = 0.5,
    seed: int = 0,
    policy: Optional[Policy] = None,
) -> list[Job]:
    """One abrupt regime change: the first `shift_frac` of jobs arrive at
    `rate_before` with service times ~ `dist_before`, the rest at
    `rate_after` ~ `dist_after`.  The canonical adaptive-vs-fixed stressor:
    a policy tuned to the first regime meets the second one head-on.
    Shift job index = int(shift_frac * n_jobs)."""
    if not 0.0 < shift_frac < 1.0:
        raise ValueError("shift_frac must be in (0, 1)")
    k = int(shift_frac * n_jobs)
    return piecewise_poisson_workload(
        [(rate_before, k), (rate_after, n_jobs - k)],
        n_tasks,
        dist_before,
        seed=seed,
        policy=policy,
        dists=[dist_before, dist_after],
    )


def diurnal_workload(
    n_jobs: int,
    rate: float,
    period: float,
    n_tasks: int,
    dist: Distribution,
    amplitude: float = 0.8,
    seed: int = 0,
    policy: Optional[Policy] = None,
) -> list[Job]:
    """Sinusoidal λ(t) = rate·(1 + amplitude·sin(2πt/period)) via
    Lewis–Shedler thinning: candidates from a homogeneous Poisson process
    at the peak rate are accepted with probability λ(t)/λ_peak.  Long-run
    mean rate is `rate`; the instantaneous rate swings by ±amplitude —
    the smooth nonstationarity (vs the jump of `regime_shift_workload`)
    that exercises the controller's periodic re-optimization rather than
    its drift test."""
    if rate <= 0 or period <= 0:
        raise ValueError("rate and period must be > 0")
    if not 0.0 <= amplitude < 1.0:
        raise ValueError("amplitude must be in [0, 1)")
    rng = np.random.default_rng(seed)
    peak = rate * (1.0 + amplitude)
    t, jobs = 0.0, []
    while len(jobs) < n_jobs:
        t += float(rng.exponential(1.0 / peak))
        lam_t = rate * (1.0 + amplitude * np.sin(2.0 * np.pi * t / period))
        if rng.random() < lam_t / peak:
            jobs.append(
                Job(job_id=len(jobs), arrival=t, n_tasks=n_tasks, dist=dist, policy=policy)
            )
    return jobs


def trace_workload(
    n_jobs: int,
    rate: float,
    n_tasks: int = 64,
    trace_jobs: Sequence[str] = ("job1", "job2"),
    seed: int = 0,
    policy: Optional[Policy] = None,
) -> list[Job]:
    """Poisson arrivals whose task times replay the synthesized traces.

    Each arriving job picks one of `trace_jobs` uniformly and draws its
    task-time distribution as `Empirical` over that trace's samples —
    bootstrap resampling per task, exactly the Algorithm 1 view of F̂_X.
    Times are rescaled to mean 1 so different traces impose comparable load.
    """
    from ..data.traces import load_trace

    rng = np.random.default_rng(seed)
    dists = {}
    for name in trace_jobs:
        x = load_trace(name, seed=seed)
        dists[name] = Empirical(x / np.mean(x))
    arrivals = np.cumsum(rng.exponential(1.0 / rate, size=n_jobs))
    names = [trace_jobs[int(rng.integers(0, len(trace_jobs)))] for _ in range(n_jobs)]
    return [
        Job(
            job_id=i,
            arrival=float(arrivals[i]),
            n_tasks=n_tasks,
            dist=dists[names[i]],
            policy=policy,
        )
        for i in range(n_jobs)
    ]
