# The fused fleet fast path, ported: workloads and machine classes, and the
# vectorized frontier engine (repro.fleet.vector).  The event engine
# (events, scheduler, metrics, fleet, scenarios) and the adaptive
# controller are not ported yet (ROADMAP Queue 1).
from .workload import (  # noqa: F401
    Job,
    MachineClass,
    bursty_workload,
    diurnal_workload,
    piecewise_poisson_workload,
    poisson_workload,
    regime_shift_workload,
    trace_workload,
)
from ..faults import (  # noqa: F401
    ChaosSchedule,
    CrashProcess,
    FaultSpec,
    Outage,
    effective_fail_prob,
    schedule_for_kill_fraction,
)
from . import vector  # noqa: F401
from .vector import (  # noqa: F401
    VectorFleetResult,
    fleet_rollout,
    frontier,
    policy_search,
    sweep,
    sweep_loop,
    trace_kill_rollout,
)
