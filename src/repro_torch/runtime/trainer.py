"""Straggler-aware synchronous data-parallel trainer.

Each global step is `n_tasks` gradient shards (one per DP host group).  The
runtime:

  1. executes the shards under the current single-fork policy (speculative
     replication of the slowest pn shards; see executor.py),
  2. feeds per-task durations to the OnlinePolicyController (reservoir ->
     Algorithm 1 -> §4.3 optimization) which adapts (p, r, keep|kill),
  3. applies the optimizer update exactly once (first-copy-wins gradients
     are value-identical, so the update is independent of scheduling),
  4. checkpoints every `checkpoint_every` steps (atomic; restart resumes
     bit-exactly), and
  5. handles permanent node losses elastically: the pool shrinks/grows and
     `n_tasks` is re-fit to the pool before the next step.

Gradient math: with `literal_replicas=False` (default) the global-batch
gradient is computed once per step — replication cannot change its value,
only its timing, so simulating per-shard timing is exact.  Tests run
`literal_replicas=True` on a small model to verify that the masked
per-shard-average equals the global gradient and that replica values are
identical (the first-copy-wins soundness argument).

Counterpart of `repro.runtime.trainer`, with the same `grad_fn` /
`update_fn` callables, plus `device` (None means the card): where the
controller's bootstrap runs and where checkpoints are restored.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from .. import checkpoint as ckpt
from .. import tree as tr
from ..core.adaptive import OnlinePolicyController
from ..core.policy import SingleForkPolicy
from ..device import resolve_device
from .cluster import SimCluster
from .executor import SpeculativeExecutor


@dataclasses.dataclass
class TrainerConfig:
    n_tasks: int = 8  # DP gradient shards per step
    spare_fraction: float = 0.5  # spare workers for replicas
    checkpoint_every: int = 20
    checkpoint_dir: Optional[str] = None
    keep_checkpoints: int = 3
    adapt_policy: bool = True
    initial_policy: SingleForkPolicy = dataclasses.field(
        default_factory=lambda: SingleForkPolicy(p=0.1, r=1, keep=True)  # MapReduce default
    )
    literal_replicas: bool = False
    seed: int = 0


@dataclasses.dataclass
class StepReport:
    step: int
    loss: float
    latency: float
    cost: float
    policy: str
    n_replicas: int
    lost_workers: list


class StragglerAwareTrainer:
    def __init__(
        self,
        cluster: SimCluster,
        grad_fn: Callable,  # (params, batch) -> (loss, grads)
        update_fn: Callable,  # (state, grads) -> state
        state: Any,
        config: TrainerConfig,
        device=None,
    ):
        self.device = resolve_device(device)
        self.cluster = cluster
        self.executor = SpeculativeExecutor(cluster)
        self.grad_fn = grad_fn
        self.update_fn = update_fn
        self.state = state
        self.cfg = config
        self.controller = OnlinePolicyController(
            seed=config.seed, n_tasks=config.n_tasks, device=self.device
        )
        self._policy = config.initial_policy
        self.history: list[StepReport] = []
        self.step = 0

    # ----------------------------------------------------------- lifecycle
    def maybe_restore(self):
        if self.cfg.checkpoint_dir:
            latest = ckpt.latest_step(self.cfg.checkpoint_dir)
            if latest is not None:
                self.state = ckpt.restore(self.cfg.checkpoint_dir, self.state, latest, device=self.device)
                self.step = latest
                return latest
        return None

    def _maybe_checkpoint(self):
        if self.cfg.checkpoint_dir and self.step % self.cfg.checkpoint_every == 0:
            ckpt.save(
                self.cfg.checkpoint_dir, self.state, self.step,
                keep=self.cfg.keep_checkpoints,
            )

    # -------------------------------------------------------------- elastic
    def _elastic_fit(self) -> list[int]:
        """Handle node losses; keep pool >= n_tasks (scale up spares)."""
        lost = self.cluster.step_node_failures()
        need = int(self.cfg.n_tasks * (1 + self.cfg.spare_fraction))
        if self.cluster.n_alive < need:
            self.cluster.add_workers(need - self.cluster.n_alive)
        return lost

    # ----------------------------------------------------------------- step
    def train_step(self, batch) -> StepReport:
        lost = self._elastic_fit()
        n = self.cfg.n_tasks

        if self.cfg.literal_replicas:
            shards = _split_batch(batch, n)
            grads_box = [None] * n

            def make_task(i):
                def task():
                    loss_i, g_i = self.grad_fn(self.state["params"], shards[i])
                    grads_box[i] = (loss_i, g_i)
                    return i

                return task

            report = self.executor.run([make_task(i) for i in range(n)], self._policy)
            losses = [grads_box[i][0] for i in range(n)]
            # in the gradients' own dtype, summed in shard order
            grads = tr.tree_map(lambda *gs: sum(gs) / n, *[grads_box[i][1] for i in range(n)])
            loss = float(sum(losses) / n)
        else:
            loss_val, grads = self.grad_fn(self.state["params"], batch)
            loss = float(loss_val)
            report = self.executor.run([(lambda i=i: i) for i in range(n)], self._policy)

        self.state = self.update_fn(self.state, grads)
        self.step += 1

        # telemetry -> online policy adaptation
        for d in report.task_durations:
            self.controller.record_task_time(d)
        self.controller.record_job_complete(n_tasks=n)
        if self.cfg.adapt_policy and self.controller.current_policy().p > 0:
            self._policy = self.controller.current_policy()

        self._maybe_checkpoint()
        rep = StepReport(
            step=self.step,
            loss=loss,
            latency=report.latency,
            cost=report.cost,
            policy=self._policy.label(),
            n_replicas=report.n_replicas_launched,
            lost_workers=lost,
        )
        self.history.append(rep)
        return rep

    @property
    def policy(self) -> SingleForkPolicy:
        return self._policy


def _split_batch(batch, n: int):
    """n shards of every tensor along axis 0, sized as `np.array_split`
    sizes them."""
    parts = {k: torch.tensor_split(v, n, dim=0) for k, v in batch.items()}
    return [{k: parts[k][i] for k in batch} for i in range(n)]
