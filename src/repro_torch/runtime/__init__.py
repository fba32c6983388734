"""The serving runtime, ported: the simulated cluster, the speculative
executor and `HedgedServer`.  `FleetHedgedServer` and the trainer are
still to port (ROADMAP Queue 1 item 8)."""

from .cluster import SimCluster, WorkerSpec  # noqa: F401
from .executor import ExecutionReport, SpeculativeExecutor, TaskResult  # noqa: F401
from .serving import HedgedServer, ServeStats  # noqa: F401
