"""repro_torch.faults — the declarative fault model (a copy of
`repro.faults`, pure Python).  The port's fused planners fold the q
task-failure law in through the geometric-retry transform
(`repro_torch.fleet.vector.retry_transform`); the event engine
(`repro_torch.fleet.FleetSim`) runs crashes and backoff exactly."""

from .model import (
    ChaosSchedule,
    CrashProcess,
    FaultSpec,
    Outage,
    effective_fail_prob,
    schedule_for_kill_fraction,
)

__all__ = [
    "ChaosSchedule",
    "CrashProcess",
    "FaultSpec",
    "Outage",
    "effective_fail_prob",
    "schedule_for_kill_fraction",
]
