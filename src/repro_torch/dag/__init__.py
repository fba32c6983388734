# Multi-stage DAG jobs with per-stage replication policies, ported
# (repro.dag):
#   * `graph`   — StageSpec / JobDAG (validated topological stage order,
#     linear pipelines and fan-in barriers);
#   * `rollout` — the fused stage-composed engine: a whole (λ × per-stage
#     policy vector) grid over one shared draw set per stage, stage queues
#     through `fleet.vector.batched_queue` (the CUDA kw_queue kernel on the
#     card at c > 1);
#   * `search`  — joint per-stage policy search (coordinate ascent and
#     exhaustive small grids);
#   * `engine`  — the discrete-event ground truth on the host: one
#     FleetScheduler per stage pool on a shared heap.
from .graph import JobDAG, StageSpec  # noqa: F401
from .rollout import (  # noqa: F401
    DagRolloutResult,
    dag_frontier,
    dag_rollout,
    vector_label,
)
from .search import (  # noqa: F401
    best_stable,
    coordinate_search,
    exhaustive_search,
    uniform_vectors,
)
from .engine import (  # noqa: F401
    DagFleetConfig,
    DagFleetReport,
    DagFleetScheduler,
    DagFleetSim,
    DagJobRecord,
    poisson_arrivals,
    run_dag_fleet,
)

__all__ = [
    "DagFleetConfig",
    "DagFleetReport",
    "DagFleetScheduler",
    "DagFleetSim",
    "DagJobRecord",
    "DagRolloutResult",
    "JobDAG",
    "StageSpec",
    "best_stable",
    "coordinate_search",
    "dag_frontier",
    "dag_rollout",
    "exhaustive_search",
    "poisson_arrivals",
    "run_dag_fleet",
    "uniform_vectors",
    "vector_label",
]
