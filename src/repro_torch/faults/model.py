"""Fault model: crash/recovery processes and per-task failure laws.

The paper's stragglers are slow-but-eventually-finishing; real clusters
(including the Google trace the paper evaluates against) also *lose* work:
machines crash and recover, task attempts fail and must be re-run.  This
module is the declarative half of the chaos engine — `FaultSpec` describes
*what* can go wrong; `fleet.scheduler.FleetScheduler` executes it exactly
(machine_down/machine_up events, per-copy retries with capped exponential
backoff) and `fleet.vector`/`dag.rollout` fold the task-failure law into
the fused fast path via the geometric-retry transform (effective task
duration = sum of failed-attempt draws + the final success draw).

Two task-failure laws, mutually exclusive:
  * `q`         — each attempt fails with probability q, discovered only
                  when the attempt would have completed (the copy burns
                  its full drawn duration before failing);
  * `fail_dist` — a fail-time distribution racing the service draw: the
                  attempt fails at F ~ fail_dist if F < its service time,
                  else succeeds (partial work is still billed).

Machine faults, composable with either law:
  * `crashes`  — stochastic per-class `CrashProcess`es (MTBF/MTTR);
  * `schedule` — a deterministic `ChaosSchedule` of `Outage` windows, the
                 reproducible variant tests and examples script against.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

__all__ = [
    "ChaosSchedule",
    "CrashProcess",
    "FaultSpec",
    "Outage",
    "effective_fail_prob",
    "schedule_for_kill_fraction",
]


@dataclasses.dataclass(frozen=True)
class CrashProcess:
    """Stochastic crash/recovery process for one machine class.

    Crashes arrive Poisson at rate `slots / mtbf` for the targeted class
    (each machine fails independently at rate 1/mtbf); each crash takes
    `n_slots` slots down for an Exp(mean=mttr) repair.  `klass=None`
    targets every class.
    """

    mtbf: float
    mttr: float
    klass: Optional[str] = None
    n_slots: int = 1

    def __post_init__(self):
        if not (self.mtbf > 0 and math.isfinite(self.mtbf)):
            raise ValueError(f"mtbf must be positive and finite, got {self.mtbf}")
        if not (self.mttr > 0 and math.isfinite(self.mttr)):
            raise ValueError(f"mttr must be positive and finite, got {self.mttr}")
        if self.n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {self.n_slots}")


@dataclasses.dataclass(frozen=True)
class Outage:
    """One deterministic outage window: `n_slots` of `klass` go down at
    `time` and come back at `time + duration`."""

    time: float
    duration: float
    n_slots: int
    klass: Optional[str] = None

    def __post_init__(self):
        if self.time < 0 or not math.isfinite(self.time):
            raise ValueError(f"outage time must be >= 0 and finite, got {self.time}")
        if not (self.duration > 0 and math.isfinite(self.duration)):
            raise ValueError(f"outage duration must be positive, got {self.duration}")
        if self.n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {self.n_slots}")


@dataclasses.dataclass(frozen=True)
class ChaosSchedule:
    """Deterministic crash plan: a tuple of `Outage` windows.

    The reproducible counterpart of `CrashProcess` — tests and examples
    script exact kill/recover times against it, so chaos assertions don't
    depend on a crash RNG.
    """

    outages: Tuple[Outage, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "outages", tuple(self.outages))
        for o in self.outages:
            if not isinstance(o, Outage):
                raise TypeError(f"ChaosSchedule holds Outage entries, got {type(o)}")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Everything that can go wrong, in one declarative spec.

    Retry policy: a failed copy is relaunched (a fresh service draw) after
    a capped exponential backoff `min(backoff_base * backoff_factor**(k-1),
    backoff_cap)` following its k-th failure, up to `max_attempts` total
    attempts per copy.  A task whose every copy exhausts its attempts makes
    the job terminally `failed`.

    The fused engines (`fleet.vector.frontier(..., fault=...)`,
    `dag.rollout.dag_frontier(..., fault=...)`) model the `q` law with
    immediate relaunch (`backoff_base == 0`); nonzero backoff and
    `fail_dist`/machine crashes are event-engine territory.
    """

    q: float = 0.0
    fail_dist: Optional[object] = None  # repro.core Distribution
    max_attempts: int = 8
    backoff_base: float = 0.0
    backoff_factor: float = 2.0
    backoff_cap: float = 64.0
    crashes: Tuple[CrashProcess, ...] = ()
    schedule: Optional[ChaosSchedule] = None

    def __post_init__(self):
        if not (0.0 <= self.q < 1.0):
            raise ValueError(f"q must be in [0, 1), got {self.q}")
        if self.q > 0 and self.fail_dist is not None:
            raise ValueError("pass q or fail_dist, not both")
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.backoff_base < 0:
            raise ValueError(f"backoff_base must be >= 0, got {self.backoff_base}")
        if self.backoff_factor < 1.0:
            raise ValueError(
                f"backoff_factor must be >= 1, got {self.backoff_factor}"
            )
        if self.backoff_cap < 0:
            raise ValueError(f"backoff_cap must be >= 0, got {self.backoff_cap}")
        object.__setattr__(self, "crashes", tuple(self.crashes))
        for c in self.crashes:
            if not isinstance(c, CrashProcess):
                raise TypeError(f"crashes holds CrashProcess entries, got {type(c)}")

    # ------------------------------------------------------------- queries
    @property
    def task_faults(self) -> bool:
        """True when individual task attempts can fail."""
        return self.q > 0.0 or self.fail_dist is not None

    @property
    def machine_faults(self) -> bool:
        """True when whole machines can go down."""
        return bool(self.crashes) or bool(
            self.schedule is not None and self.schedule.outages
        )

    @property
    def enabled(self) -> bool:
        return self.task_faults or self.machine_faults

    def attempt_delay(self, failures: int) -> float:
        """Backoff before the relaunch that follows the `failures`-th
        failure of a copy (failures >= 1)."""
        if failures < 1:
            raise ValueError(f"failures must be >= 1, got {failures}")
        if self.backoff_base == 0.0:
            return 0.0
        return min(
            self.backoff_base * self.backoff_factor ** (failures - 1),
            self.backoff_cap,
        )

    def delays(self, attempts: Optional[int] = None):
        """Static backoff-delay vector (length attempts-1) for the fused
        geometric-retry transform: delays[k-1] precedes attempt k+1."""
        a = self.max_attempts if attempts is None else attempts
        return tuple(self.attempt_delay(k) for k in range(1, a))


def effective_fail_prob(
    q: float, crash_rate: float = 0.0, mean_service: float = 1.0
) -> float:
    """Per-attempt failure probability folding a machine crash rate into
    the task-failure law: an attempt of mean duration E[X] on a machine
    crashing at rate ν dies with probability 1 - (1-q)·exp(-ν·E[X]).

    This is the reduction the fused (λ, q) grids use to approximate
    crash-rate cells with the geometric-retry transform; the event engine
    executes the crash process exactly.
    """
    if not (0.0 <= q < 1.0):
        raise ValueError(f"q must be in [0, 1), got {q}")
    if crash_rate < 0:
        raise ValueError(f"crash_rate must be >= 0, got {crash_rate}")
    return 1.0 - (1.0 - q) * math.exp(-crash_rate * mean_service)


def schedule_for_kill_fraction(
    capacity: int,
    frac: float,
    start: float,
    duration: float,
    klass: Optional[str] = None,
) -> ChaosSchedule:
    """Convenience: one outage window taking `frac` of `capacity` down."""
    if not (0.0 < frac <= 1.0):
        raise ValueError(f"frac must be in (0, 1], got {frac}")
    n = max(1, int(round(capacity * frac)))
    return ChaosSchedule((Outage(start, duration, n, klass),))
