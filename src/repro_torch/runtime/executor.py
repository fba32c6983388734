"""Speculative task execution under single-/multi-fork policies.

This is the paper's Definition 1 turned into a scheduler: launch the n
tasks, watch completions, and when (1-p)n have finished, replicate each
straggler onto fresh workers (keep or kill the original).  First finisher
wins; sibling copies are cancelled and their runtime until cancellation is
billed to the cost metric (Definition 2).

Because our tasks are pure functions (gradient shards, decode requests),
first-copy-wins is value-exact — the executor computes each task's value
once and the discrete-event layer accounts for time/cost of every copy.

The executor reports per-task telemetry that feeds the online policy
controller (empirical F̂_X -> Algorithm 1 -> §4.3 optimization).
Counterpart of `repro.runtime.executor` (host-side numpy, unchanged).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np

from ..core.policy import MultiForkPolicy, SingleForkPolicy, num_stragglers

from .cluster import SimCluster, WorkerSpec


@dataclasses.dataclass
class TaskResult:
    task_id: int
    value: object
    finish_time: float  # T_i
    winning_copy: int  # 0 = original
    n_copies: int


@dataclasses.dataclass
class ExecutionReport:
    latency: float  # T = max_i T_i
    cost: float  # C = sum of copy runtimes / n
    task_durations: list[float]  # original-copy durations (telemetry; inf = crash)
    results: list[TaskResult]
    fork_time: Optional[float]
    n_replicas_launched: int

    @property
    def wasted_fraction(self) -> float:
        """Fraction of paid compute that was cancelled copies."""
        useful = sum(min(r.finish_time, 1e30) for r in self.results)
        total = self.cost * len(self.results)
        return max(0.0, 1.0 - useful / max(total, 1e-12))


class SpeculativeExecutor:
    def __init__(self, cluster: SimCluster, fork_overhead: float = 0.0):
        self.cluster = cluster
        self.fork_overhead = fork_overhead  # replica launch delay (DESIGN §8)

    # ------------------------------------------------------------------ run
    def run(
        self,
        tasks: Sequence[Callable[[], object]],
        policy: SingleForkPolicy,
    ) -> ExecutionReport:
        """Execute `tasks` under `policy`.  Each task's value is computed
        exactly once (replicas are value-identical); timing/cost follow the
        single-fork semantics."""
        n = len(tasks)
        workers = self.cluster.alive_workers()
        if len(workers) < n:
            raise RuntimeError(
                f"pool too small: {len(workers)} alive workers < {n} tasks "
                "(elastic resize should have run first)"
            )
        originals = workers[:n]
        spares = workers[n:]

        durations = np.array(
            [self.cluster.sample_duration(w) for w in originals], dtype=np.float64
        )

        s = num_stragglers(n, policy.p)
        values = [None] * n
        results: list[TaskResult] = []
        n_launched = 0

        if s == 0:
            for i, t in enumerate(tasks):
                values[i] = t()
                results.append(TaskResult(i, values[i], float(durations[i]), 0, 1))
            latency = float(np.max(durations))
            cost = float(np.sum(durations)) / n
            return ExecutionReport(latency, cost, durations.tolist(), results, None, 0)

        order = np.argsort(durations)
        fork_time = float(durations[order[n - s - 1]]) if n - s - 1 >= 0 else 0.0
        straggler_ids = order[n - s :]
        done_ids = order[: n - s]

        # finished-before-fork tasks
        for i in done_ids:
            values[i] = tasks[i]()
            results.append(TaskResult(int(i), values[i], float(durations[i]), 0, 1))
        cost_sum = float(np.sum(durations[done_ids]))

        # straggling tasks: originals billed up to the fork point, then the
        # race between the original remainder (π_keep) and r (or r+1) fresh
        # copies on spare workers
        rng = self.cluster.rng
        spare_pool = list(spares) + list(originals)  # reuse freed machines
        replica_sources: list[WorkerSpec] = []
        for i_s, i in enumerate(straggler_ids):
            values[i] = tasks[i]()
            fresh_count = policy.r + (0 if policy.keep else 1)
            fresh = []
            for c in range(fresh_count):
                w = spare_pool[(i_s * max(fresh_count, 1) + c) % max(len(spare_pool), 1)]
                fresh.append(self.cluster.sample_duration(w) + self.fork_overhead)
            n_launched += fresh_count
            if policy.keep:
                cand = [float(durations[i]) - fork_time] + fresh
            else:
                cand = fresh
            y = float(np.min(cand)) if cand else float(durations[i]) - fork_time
            win = int(np.argmin(cand)) if cand else 0
            finish = fork_time + y
            copies = len(cand)
            # Definition 2 cost: every running copy billed until the winner
            cost_sum += fork_time  # original up to fork (kept or killed)
            cost_sum += copies * y if policy.keep else len(fresh) * y
            results.append(
                TaskResult(int(i), values[i], finish, win, copies + (0 if policy.keep else 1))
            )

        latency = max(r.finish_time for r in results)
        cost = cost_sum / n
        return ExecutionReport(
            latency=latency,
            cost=cost,
            task_durations=durations.tolist(),
            results=sorted(results, key=lambda r: r.task_id),
            fork_time=fork_time,
            n_replicas_launched=n_launched,
        )

    # ------------------------------------------------------------ multifork
    def run_multifork(
        self, tasks: Sequence[Callable[[], object]], policy: MultiForkPolicy
    ) -> ExecutionReport:
        """Sequential application of the fork stages (timing only differs
        from single-fork; values still computed once)."""
        n = len(tasks)
        workers = self.cluster.alive_workers()
        durations = np.array(
            [self.cluster.sample_duration(w) for w in workers[:n]], dtype=np.float64
        )
        finish = durations.copy()
        cost_per_task = np.zeros(n)
        active_since = np.zeros(n)  # originals start at 0
        copies = np.ones(n)
        n_launched = 0
        fork_time = None
        for p_i, r_i, keep_i in policy.stages:
            s_i = num_stragglers(n, p_i)
            t_fork = float(np.sort(finish)[n - s_i - 1]) if s_i < n else 0.0
            fork_time = t_fork if fork_time is None else fork_time
            unfinished = finish > t_fork
            for i in np.nonzero(unfinished)[0]:
                fresh = [
                    self.cluster.sample_duration(workers[(i + 1 + c) % len(workers)])
                    + self.fork_overhead
                    for c in range(r_i + (0 if keep_i else 1))
                ]
                n_launched += len(fresh)
                if keep_i:
                    cand = [finish[i] - t_fork] + fresh
                else:
                    cost_per_task[i] += copies[i] * (t_fork - active_since[i])
                    copies[i] = 0
                    cand = fresh
                y = float(np.min(cand))
                if keep_i:
                    cost_per_task[i] += copies[i] * (t_fork - active_since[i])
                copies[i] = len(cand) if keep_i else len(fresh)
                active_since[i] = t_fork
                finish[i] = t_fork + y
        for i in range(n):
            cost_per_task[i] += copies[i] * (finish[i] - active_since[i])
        values = [t() for t in tasks]
        results = [
            TaskResult(i, values[i], float(finish[i]), 0, int(copies[i])) for i in range(n)
        ]
        return ExecutionReport(
            latency=float(np.max(finish)),
            cost=float(np.sum(cost_per_task)) / n,
            task_durations=durations.tolist(),
            results=results,
            fork_time=fork_time,
            n_replicas_launched=n_launched,
        )
