"""The serving runtime, ported: the simulated cluster, the speculative
executor, `HedgedServer` (one batch at a time on a dedicated cluster) and
`FleetHedgedServer` (batches queueing for a finite replica pool through
the port's fleet).  The trainer is still to port (ROADMAP Queue 1 item 8b)."""

from .cluster import SimCluster, WorkerSpec  # noqa: F401
from .executor import ExecutionReport, SpeculativeExecutor, TaskResult  # noqa: F401
from .serving import BatchOutcome, FleetHedgedServer, HedgedServer, ServeStats  # noqa: F401
