# Multi-job, finite-capacity fleet simulation, ported (repro.fleet).  Two
# paths:
#   * `FleetSim` — the exact event-heap discrete-event engine (events.py,
#     scheduler.py), on the host; with `adapt=True` its controller plans
#     through `vector.policy_search` on the device;
#   * `vector` — the fused many-trial rollouts for the gang-aligned G/G/c
#     regime (Kiefer–Wolfowitz queue, the CUDA kw_queue kernel on the card),
#     for frontiers, sweeps and policy search.
from .events import Event, EventHeap, OwnedHeap  # noqa: F401
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
from .adaptive import (  # noqa: F401
    FleetPolicyController,
    PolicyDecision,
    as_policy_provider,
    ks_statistic,
)
from .scenarios import (  # noqa: F401
    CHAOS,
    ChaosScenario,
    REGIME_SHIFT,
    RegimeShiftScenario,
)
from .scheduler import FleetScheduler, JobRecord  # noqa: F401
from ..faults import (  # noqa: F401
    ChaosSchedule,
    CrashProcess,
    FaultSpec,
    Outage,
    effective_fail_prob,
    schedule_for_kill_fraction,
)
from .metrics import (  # noqa: F401
    DagStats,
    FleetStats,
    class_sojourn_sketches,
    compute_dag_stats,
    compute_stats,
    dag_critical_path_shares,
    straggler_blame,
    tail_quantiles,
)
from .fleet import FleetConfig, FleetReport, FleetSim, run_fleet  # noqa: F401
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

__all__ = [
    "CHAOS",
    "ChaosSchedule",
    "ChaosScenario",
    "CrashProcess",
    "DagStats",
    "Event",
    "EventHeap",
    "FaultSpec",
    "FleetConfig",
    "FleetPolicyController",
    "FleetReport",
    "FleetScheduler",
    "FleetSim",
    "FleetStats",
    "Job",
    "JobRecord",
    "MachineClass",
    "Outage",
    "OwnedHeap",
    "PolicyDecision",
    "REGIME_SHIFT",
    "RegimeShiftScenario",
    "VectorFleetResult",
    "as_policy_provider",
    "bursty_workload",
    "class_sojourn_sketches",
    "effective_fail_prob",
    "schedule_for_kill_fraction",
    "compute_dag_stats",
    "compute_stats",
    "dag_critical_path_shares",
    "straggler_blame",
    "diurnal_workload",
    "fleet_rollout",
    "frontier",
    "ks_statistic",
    "piecewise_poisson_workload",
    "poisson_workload",
    "policy_search",
    "regime_shift_workload",
    "run_fleet",
    "sweep",
    "sweep_loop",
    "tail_quantiles",
    "trace_kill_rollout",
    "trace_workload",
    "vector",
]
