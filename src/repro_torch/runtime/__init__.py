"""The runtime, ported: the simulated cluster, the speculative executor,
`HedgedServer` (one batch at a time on a dedicated cluster),
`FleetHedgedServer` (batches queueing for a finite replica pool through
the port's fleet) and `StragglerAwareTrainer` (synchronous data-parallel
training with speculative replication of gradient shards)."""

from .cluster import SimCluster, WorkerSpec  # noqa: F401
from .executor import ExecutionReport, SpeculativeExecutor, TaskResult  # noqa: F401
from .serving import BatchOutcome, FleetHedgedServer, HedgedServer, ServeStats  # noqa: F401
from .trainer import StepReport, StragglerAwareTrainer, TrainerConfig  # noqa: F401
