"""Online policy adaptation (paper §5.2 'future directions', built here).

A real deployment does not know F_X a priori.  `OnlinePolicyController`
learns it from streaming task-completion telemetry and periodically re-runs
the bootstrap optimizer, with ε-greedy exploration over r (the multi-arm
bandit flavor the paper sketches):

  * every completed task contributes one execution-time sample (reservoir
    sampled to a bounded window so drifting clusters stay tracked);
  * every `reoptimize_every` completed *jobs* (steps), re-run Algorithm 1 +
    §4.3 optimization on the current window;
  * with prob. ε, perturb r by ±1 (clamped to [0, r_max]) to keep exploring;
    from BASELINE the perturbation is a small-p single fork instead, so the
    controller is never stuck at p = 0 with no way to gather counter-evidence.

The controller is deliberately framework-agnostic: the serving runtime
(`repro_torch.runtime`) feeds it samples and asks `current_policy()` each
step.  Counterpart of `repro.core.adaptive`; `device` (None means the card)
is where its bootstrap runs.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..device import resolve_device
from . import optimize
from .policy import BASELINE, SingleForkPolicy

__all__ = ["OnlinePolicyController"]


@dataclasses.dataclass
class OnlinePolicyController:
    objective: str = "latency"  # 'latency' (eq. 19) or 'cost' (eq. 20)
    lam: float = 0.1  # λ for the cost-sensitive objective
    r_max: int = 4
    window: int = 4096  # reservoir size
    min_samples: int = 64  # don't optimize before this many samples
    reoptimize_every: int = 8  # jobs between re-optimizations
    epsilon: float = 0.05  # exploration probability over r
    explore_p: float = 0.05  # fork fraction used when exploring away from baseline
    n_tasks: int | None = None  # per-job task count for eq. 20 (or plumbed per job)
    bootstrap_m: int = 200
    seed: int = 0
    device: object = None  # where the bootstrap runs; None means the card

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._rng = np.random.default_rng(self.seed)
        self._samples: list[float] = []
        self._seen = 0
        self._jobs = 0
        self._job_n = self.n_tasks  # last job size seen (eq. 20's n)
        self._policy = BASELINE
        self.history: list[SingleForkPolicy] = []

    # ----------------------------------------------------------- telemetry
    def record_task_time(self, seconds: float) -> None:
        """Reservoir-sample one completed task's execution time."""
        self._seen += 1
        if len(self._samples) < self.window:
            self._samples.append(float(seconds))
        else:
            j = int(self._rng.integers(0, self._seen))
            if j < self.window:
                self._samples[j] = float(seconds)

    def record_job_complete(self, n_tasks: int | None = None) -> None:
        if n_tasks is not None:
            self._job_n = int(n_tasks)
        self._jobs += 1
        if (
            self._jobs % self.reoptimize_every == 0
            and len(self._samples) >= self.min_samples
        ):
            self._reoptimize()

    # ------------------------------------------------------------- policy
    def current_policy(self) -> SingleForkPolicy:
        return self._policy

    @property
    def n_samples(self) -> int:
        return len(self._samples)

    def _reoptimize(self) -> None:
        ev = optimize.bootstrap_evaluator(
            np.asarray(self._samples), m=self.bootstrap_m, seed=int(self._rng.integers(2**31)),
            device=self.device,
        )
        # eq. 20's n is the job's task count, plumbed via `n_tasks` /
        # `record_job_complete` — NOT the reservoir size, which grows to
        # `window` and would drown E[T] in a 4096x-weighted cost term
        n = self._job_n if self._job_n else 1
        if self.objective == "latency":
            best, _ = optimize.optimize_latency_sensitive(
                ev, r_max=self.r_max, p_grid=np.arange(0.02, 0.42, 0.04)
            )
        else:
            best, _ = optimize.optimize_cost_sensitive(
                ev, lam=self.lam, n=n, r_max=self.r_max, p_grid=np.arange(0.02, 0.42, 0.04)
            )
        pol = best.policy
        # ε-greedy exploration (bounded): perturb r, or — when the optimizer
        # returned BASELINE — try a small-p fork so the controller can still
        # gather evidence away from p = 0 instead of sticking there forever
        if self._rng.random() < self.epsilon:
            if pol.is_baseline:
                pol = SingleForkPolicy(p=self.explore_p, r=1, keep=True)
            else:
                dr = int(self._rng.choice((-1, 1)))
                r = int(np.clip(pol.r + dr, 0, self.r_max))
                if not (pol.keep and r == 0):
                    pol = SingleForkPolicy(p=pol.p, r=r, keep=pol.keep)
        self._policy = pol
        self.history.append(pol)
