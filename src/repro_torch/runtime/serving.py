"""Hedged serving: the single-fork policy applied to inference requests.

A batch of decode requests fans out across replicas of the model server;
the scheduler watches completions and, once the (1-p) quantile has
finished, hedges the stragglers with r duplicate requests (keep) or
cancel-and-resend (kill).  This is 'the tail at scale' request hedging with
the paper's machinery choosing (p, r, keep|kill) from measured latency
traces instead of hand-tuned timeouts.

Counterpart of `repro.runtime.serving`, with one backend so far:
`HedgedServer`, one batch at a time on a dedicated `SimCluster` (the
paper's unlimited-pool regime).  `FleetHedgedServer` waits for the event
engine (ROADMAP Queue 1 item 4).  `device` (None means the card) is where
the controller's bootstrap runs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np

from ..core.adaptive import OnlinePolicyController
from ..core.policy import SingleForkPolicy
from ..device import resolve_device
from ..obs.sketch import QuantileSketch
from .cluster import SimCluster
from .executor import SpeculativeExecutor


@dataclasses.dataclass
class ServeStats:
    latency: float
    cost: float
    p50: float
    p99: float
    policy: str
    p999: float = float("nan")


class HedgedServer:
    def __init__(
        self,
        cluster: SimCluster,
        serve_fn: Callable[[object], object],
        policy: Optional[SingleForkPolicy] = None,
        adapt: bool = True,
        device=None,
    ):
        self.device = resolve_device(device)
        self.cluster = cluster
        self.executor = SpeculativeExecutor(cluster)
        self.serve_fn = serve_fn
        self.controller = OnlinePolicyController(objective="latency", device=self.device)
        self._policy = policy or SingleForkPolicy(p=0.05, r=1, keep=True)
        self.adapt = adapt
        self.latency_sketch = QuantileSketch()

    def serve_batch(self, requests: Sequence[object]) -> tuple[list, ServeStats]:
        tasks = [(lambda r=r: self.serve_fn(r)) for r in requests]
        report = self.executor.run(tasks, self._policy)
        for d in report.task_durations:
            self.controller.record_task_time(d)
        self.controller.record_job_complete(n_tasks=len(requests))
        if self.adapt and self.controller.current_policy().p > 0:
            self._policy = self.controller.current_policy()
        # the batch's finish times stream into the server's lifetime sketch,
        # so per-batch ServeStats carry the sketch's tails over every batch
        # served so far
        finishes = np.array([r.finish_time for r in report.results])
        self.latency_sketch.add_many(finishes)
        p50, p99, p999 = self.latency_sketch.quantiles((0.5, 0.99, 0.999))
        stats = ServeStats(
            latency=report.latency,
            cost=report.cost,
            p50=p50,
            p99=p99,
            p999=p999,
            policy=self._policy.label(),
        )
        return [r.value for r in report.results], stats
