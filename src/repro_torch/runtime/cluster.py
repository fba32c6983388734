"""Simulated cluster backend.

Machine *timing* is discrete-event simulated while all task *values* are
real computation (on the card, for the served model).  The executor only
sees `sample_duration`, `alive`, and the failure events, so swapping in a
real backend replaces this file only.  Counterpart of
`repro.runtime.cluster`, with the same numpy RNG stream: the same seed
gives the same workers and the same durations.

Heterogeneity & failures (DESIGN.md §8):
  * per-worker speed multiplier (fail-slow / hot nodes),
  * transient crash probability per task (crashed copy never finishes —
    exactly the infinite-straggler case replication is meant to absorb),
  * permanent node-loss events (worker leaves the pool; elastic resize).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.distributions import Distribution


@dataclasses.dataclass
class WorkerSpec:
    worker_id: int
    speed: float = 1.0  # execution-time multiplier (>1 = slow node)
    crash_prob: float = 0.0  # per-task transient crash probability
    alive: bool = True


class SimCluster:
    def __init__(
        self,
        n_workers: int,
        dist: Distribution,
        seed: int = 0,
        slow_fraction: float = 0.0,
        slow_factor: float = 3.0,
        crash_prob: float = 0.0,
        node_loss_prob: float = 0.0,
    ):
        self.dist = dist
        self.rng = np.random.default_rng(seed)
        self.node_loss_prob = node_loss_prob
        self.workers: list[WorkerSpec] = []
        for i in range(n_workers):
            slow = self.rng.random() < slow_fraction
            self.workers.append(
                WorkerSpec(i, speed=slow_factor if slow else 1.0, crash_prob=crash_prob)
            )

    # ------------------------------------------------------------- queries
    @property
    def n_alive(self) -> int:
        return sum(w.alive for w in self.workers)

    def alive_workers(self) -> list[WorkerSpec]:
        return [w for w in self.workers if w.alive]

    # ----------------------------------------------------------- simulation
    def sample_duration(self, worker: WorkerSpec) -> float:
        """Execution time of one task copy on `worker`.

        A transient crash is detected at the timeout (the 99.9th duration
        percentile) and the copy restarts on the same machine — so a crash
        shows up as a very long duration, i.e. exactly the straggler the
        replication policy is meant to absorb."""
        u = self.rng.random()
        x = float(self.dist.quantile(u)) * worker.speed
        while worker.crash_prob > 0 and self.rng.random() < worker.crash_prob:
            timeout = float(self.dist.quantile(0.999)) * worker.speed
            x = timeout + float(self.dist.quantile(self.rng.random())) * worker.speed
        return x

    def step_node_failures(self) -> list[int]:
        """Between-step permanent node losses.  Returns lost worker ids."""
        lost = []
        for w in self.workers:
            if w.alive and self.rng.random() < self.node_loss_prob:
                w.alive = False
                lost.append(w.worker_id)
        return lost

    def add_workers(self, count: int) -> list[int]:
        """Elastic scale-up."""
        start = len(self.workers)
        new = []
        for i in range(count):
            w = WorkerSpec(start + i)
            self.workers.append(w)
            new.append(w.worker_id)
        return new
