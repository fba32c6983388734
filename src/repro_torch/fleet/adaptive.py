"""Load-aware closed-loop fleet policy control (DESIGN.md §10).

Counterpart of `repro.fleet.adaptive`.  The controller's inner loop is
the port's `fleet.vector.policy_search`, which runs on `device` (None
means the card) and queues through the CUDA `kw_queue` kernel there; each
re-plan passes it an integer seed drawn from the controller's own numpy
stream where the reference drew a `PRNGKey`.

The paper's Algorithm 1 + §4.3 pick (p, r, keep|kill) from the single-job
(E[T], E[C]) — `core.adaptive.OnlinePolicyController` learns exactly that.
Under queueing it is load-blind: replication inflates per-job cost E[C],
hence the offered load ρ = λ·n·E[C]/capacity, and a policy that wins for
one job can push ρ past 1 and collapse the whole fleet (the failure
`examples/fleet_sim.py` demonstrates).  The right replication level is
load-dependent (Aktaş et al., "Which Clones Should Attack and When?";
"Straggler Mitigation by Delayed Relaunch of Tasks").

`FleetPolicyController` closes the loop at the fleet level:

  * task-completion telemetry streams into a bounded reservoir (uniform
    over the stream) plus a sliding recent window; job arrivals feed an
    online arrival-rate estimate λ̂;
  * every `reoptimize_every` jobs the controller re-optimizes by scoring a
    whole (p, r, keep|kill) candidate grid through
    `fleet.vector.policy_search` — bootstrap-resampled (T, C) pushed
    through the Kiefer–Wolfowitz G/G/c queue at λ̂ and the fleet's class
    mix, the entire grid one fused call on shared draws — so the decision
    variable is *fleet sojourn under estimated load*, not single-job
    latency.  The fresh-draw width is pinned to `r_max + 1` (`r_cap`), so
    successive re-plans share one random-stream layout; `use_kernel=True`
    routes c = 1 queue recursions through the `kernels.kw_queue` kernel too;
  * candidates whose estimated ρ ≥ `rho_max` are vetoed whenever a stable
    alternative exists (the stability guard the single-job controller
    lacks);
  * nonstationarity: a two-sample Kolmogorov–Smirnov test of the recent
    window against the reservoir; on drift the reservoir is flushed to the
    recent window and re-optimization fires immediately (with a cooldown so
    one shift does not thrash);
  * bounded ε-greedy exploration over r — allowed from BASELINE too, so
    the controller is never stuck at p = 0;
  * heterogeneous fleets get per-class policies: each machine class is
    re-searched at its share of λ̂ with its own speed and block count, and
    `policy_for(job, machine_class=...)` serves the class-specific pick;
  * straggler blame (`repro_torch.obs.blame`): completed-job sojourns are
    attributed per class, the counterfactual tail score names the class
    dragging the fleet tail, every re-plan surfaces it as a `blame`
    decision event, and `blame_target=True` escalates that class's pick
    to a replicating policy — replication aimed at the machines that
    actually straggle.

The controller implements the scheduler's policy-provider hook
(`fleet.scheduler.FleetScheduler`); `as_policy_provider` adapts the legacy
single-job controller to the same interface.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional, Sequence

import numpy as np

from ..core.adaptive import OnlinePolicyController
from ..core.policy import (
    BASELINE,
    SingleForkPolicy,
    delayed_relaunch,
    group_replication,
)

from ..device import resolve_device
from . import vector
from .workload import MachineClass

__all__ = [
    "FleetPolicyController",
    "PolicyDecision",
    "as_policy_provider",
    "ks_statistic",
]


def ks_statistic(a, b) -> float:
    """Two-sample Kolmogorov–Smirnov statistic sup_x |F̂_a(x) - F̂_b(x)|."""
    a = np.sort(np.asarray(a, dtype=np.float64))
    b = np.sort(np.asarray(b, dtype=np.float64))
    if a.size == 0 or b.size == 0:
        raise ValueError("need non-empty samples")
    grid = np.concatenate([a, b])
    cdf_a = np.searchsorted(a, grid, side="right") / a.size
    cdf_b = np.searchsorted(b, grid, side="right") / b.size
    return float(np.max(np.abs(cdf_a - cdf_b)))


@dataclasses.dataclass
class PolicyDecision:
    """One re-optimization outcome (the controller's audit trail)."""

    policy: SingleForkPolicy
    trigger: str  # "periodic" | "drift" | "failure_drift"
    lam_hat: float
    rho: float  # estimated offered load of the chosen policy
    mean_sojourn: float  # its predicted fleet sojourn at lam_hat
    n_samples: int
    explored: bool = False  # ε-greedy perturbation applied on top
    class_policies: Optional[dict] = None
    n_vetoed: int = 0  # candidates the ρ-guard rejected this re-plan
    t: float = float("nan")  # sim time of the decision


@dataclasses.dataclass
class FleetPolicyController:
    """Closed-loop (p, r, keep|kill) selection under queueing.

    Drop-in for `FleetConfig(adapt=True)`: the scheduler feeds arrivals and
    task telemetry, asks `policy_for` at each admission, and the controller
    periodically re-plans through the vectorized KW fast path.
    """

    objective: str = "latency"  # min E[sojourn] | "cost": + lam_cost·n·E[C]
    lam_cost: float = 0.1  # λ of eq. 20, applied to the *sojourn* analogue
    r_max: int = 3
    p_grid: tuple = (0.05, 0.1, 0.2, 0.3)
    # algebra families, enumerated uniformly with the single-fork grid and
    # scored through the same fused search (the ρ-guard applies unchanged):
    # wall-clock relaunch triggers (delayed_relaunch) and (n, d) group
    # widths (group_replication; widths not dividing the planned n are
    # skipped).  Both default empty: the classic grid is the classic grid.
    t_grid: tuple = ()
    d_grid: tuple = ()
    window: int = 2048  # reservoir size
    recent_window: int = 256  # sliding window for the drift test
    min_samples: int = 64
    reoptimize_every: int = 20  # jobs between periodic re-optimizations
    epsilon: float = 0.05  # ε-greedy exploration probability
    explore_p: float = 0.05  # fork fraction when exploring from baseline
    drift_threshold: float = 1.63  # KS c(α)·√((m+n)/mn); 1.63 ≈ α = 0.01
    drift_cooldown: int = 16  # min jobs between drift-triggered re-opts
    # failure-rate drift (chaos telemetry): attempt outcomes stream into a
    # bounded window (0 = success, 1 = failure via record_task_failure); a
    # half-split |q̂_new - q̂_old| over a full window beyond the threshold
    # re-plans immediately, and every re-plan scores candidates under the
    # estimated q̂ (policy_search's geometric-retry transform)
    fail_window: int = 512
    fail_drift_threshold: float = 0.15
    arrival_window: int = 48  # arrivals kept for the λ̂ estimate
    rho_max: float = 0.95  # stability guard: veto ρ̂ >= rho_max
    search_jobs: int = 192  # rollout horizon per candidate
    search_trials: int = 8  # independent fleets per candidate
    use_kernel: bool = False  # c = 1 queue recursions via the kw_queue kernel too
    seed: int = 0
    device: object = None  # where policy_search runs; None means the card
    # straggler blame (repro_torch.obs.blame): completed-job sojourns are
    # attributed per machine class; a class whose counterfactual tail
    # score clears blame_min_score is surfaced as a `blame` decision
    # event, and with blame_target=True its per-class policy is escalated
    # to the best *replicating* candidate — attribution as a
    # replication-targeting signal, not just a report
    blame_quantile: float = 0.99
    blame_min_score: float = 0.15
    blame_target: bool = False
    # fleet geometry — usually bound by the scheduler, not the caller
    n_tasks: Optional[int] = None
    capacity: Optional[int] = None
    classes: Optional[Sequence[MachineClass]] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._rng = np.random.default_rng(self.seed)
        self._samples: list[float] = []
        self._seen = 0
        self._recent: deque = deque(maxlen=self.recent_window)
        self._arrivals: deque = deque(maxlen=self.arrival_window)
        self._class_jobs: deque = deque(maxlen=256)
        self._job_sizes: deque = deque(maxlen=64)
        self._jobs = 0
        self._last_drift_job = -(10**9)
        self._policy: Optional[SingleForkPolicy] = None
        self._class_policies: dict = {}
        self.history: list[PolicyDecision] = []
        self.n_drifts = 0
        self.rho_hat: Optional[float] = None
        # structured decision log (repro_torch.obs): every re-plan / drift flush /
        # exploration / ρ-veto lands here and — when tracing is enabled —
        # as a marker on the controller's Perfetto row
        from ..obs.blame import StragglerBlame
        from ..obs.decisions import DecisionLog

        self.decisions = DecisionLog()
        self.blame = StragglerBlame(quantile=self.blame_quantile)
        self._now = 0.0  # latest sim time seen (arrivals / completions)
        self.last_ks_stat = float("nan")  # most recent drift-test statistic
        self._outcomes: deque = deque(maxlen=self.fail_window)
        self.last_fail_drift = float("nan")
        self.n_fail_drifts = 0

    # -------------------------------------------------- provider interface
    def bind_fleet(self, classes: Sequence[MachineClass]) -> None:
        """Scheduler hands over the pool geometry at construction."""
        self.classes = tuple(classes)
        self.capacity = sum(k.slots for k in self.classes)

    def bind_recorder(self, recorder) -> None:
        """Pin the decision log's trace sink (None keeps the process-wide
        recorder resolution)."""
        self.decisions.recorder = recorder

    def observe_arrival(self, t: float) -> None:
        self._arrivals.append(float(t))
        self._now = max(self._now, float(t))

    def record_task_time(self, seconds: float, machine_class: Optional[str] = None) -> None:
        """Reservoir-sample one completed task's base execution time."""
        x = float(seconds)
        self._seen += 1
        self._recent.append(x)
        self._outcomes.append(0)
        if len(self._samples) < self.window:
            self._samples.append(x)
        else:
            j = int(self._rng.integers(0, self._seen))
            if j < self.window:
                self._samples[j] = x

    def record_task_failure(self, machine_class: Optional[str] = None) -> None:
        """One failed task attempt (chaos telemetry from the scheduler):
        streams into the failure-rate window so q̂ tracks the live failure
        law and a drift in it triggers an immediate re-plan."""
        self._outcomes.append(1)

    def fail_rate_estimate(self) -> Optional[float]:
        """Per-attempt failure probability q̂ over the outcome window (None
        until min_samples attempts have been seen)."""
        if len(self._outcomes) < self.min_samples:
            return None
        return float(np.mean(self._outcomes))

    def record_job_complete(
        self,
        n_tasks: Optional[int] = None,
        machine_class: Optional[str] = None,
        now: Optional[float] = None,
        sojourn: Optional[float] = None,
    ) -> None:
        if n_tasks is not None:
            self._job_sizes.append(int(n_tasks))
        if machine_class is not None:
            self._class_jobs.append(machine_class)
            if sojourn is not None and machine_class not in ("unplaced",):
                # per-class sojourn attribution for straggler blame
                self.blame.observe(machine_class, float(sojourn))
        if now is not None:
            self._now = max(self._now, float(now))
        self._jobs += 1
        if self._drift_detected():
            # regime shift: the pre-shift mass in the reservoir is no longer
            # evidence — restart it from the recent window and re-plan now
            self._samples = list(self._recent)
            self._seen = len(self._samples)
            self.n_drifts += 1
            self._last_drift_job = self._jobs
            from ..obs.decisions import DecisionEvent, KIND_DRIFT

            self.decisions.log(DecisionEvent(
                t=self._now, kind=KIND_DRIFT, label="reservoir flushed",
                trigger="ks", ks_stat=self.last_ks_stat,
                n_samples=len(self._samples),
            ))
            self._reoptimize("drift")
        elif self._fail_drift_detected():
            # the failure law moved (a chaos wave started or ended): the old
            # window half is stale evidence — keep the new half and re-plan
            # under the fresh q̂ immediately
            half = len(self._outcomes) // 2
            kept = list(self._outcomes)[half:]
            self._outcomes.clear()
            self._outcomes.extend(kept)
            self.n_fail_drifts += 1
            self._last_drift_job = self._jobs
            from ..obs.decisions import DecisionEvent, KIND_DRIFT

            self.decisions.log(DecisionEvent(
                t=self._now, kind=KIND_DRIFT, label="failure-rate shift",
                trigger="failure_rate", ks_stat=self.last_fail_drift,
                n_samples=len(self._outcomes),
            ))
            self._reoptimize("failure_drift")
        elif (
            self._jobs % self.reoptimize_every == 0
            and len(self._samples) >= self.min_samples
        ):
            self._reoptimize("periodic")

    def policy_for(
        self, job=None, machine_class: Optional[str] = None
    ) -> Optional[SingleForkPolicy]:
        """The scheduler's admission-time hook; None = no recommendation yet
        (the scheduler then serves its configured default)."""
        if machine_class is not None and machine_class in self._class_policies:
            return self._class_policies[machine_class]
        return self._policy

    # ------------------------------------------------- compat / inspection
    def current_policy(self) -> SingleForkPolicy:
        return self._policy if self._policy is not None else BASELINE

    @property
    def n_samples(self) -> int:
        return len(self._samples)

    @property
    def job_n(self) -> Optional[int]:
        """The n the search plans for: the constructor pin, else the modal
        recent job size (NOT the last-completed job's — on mixed-size
        workloads that would retune the whole search to whichever job
        happened to finish most recently)."""
        if self.n_tasks is not None:
            return self.n_tasks
        if not self._job_sizes:
            return None
        sizes, counts = np.unique(np.asarray(self._job_sizes), return_counts=True)
        return int(sizes[np.argmax(counts)])

    def lam_estimate(self) -> Optional[float]:
        """Arrival rate over the sliding arrival window (None = too early)."""
        if len(self._arrivals) >= 2:
            span = self._arrivals[-1] - self._arrivals[0]
            if span > 0:
                return (len(self._arrivals) - 1) / span
        return None

    # ----------------------------------------------------------- internals
    def _drift_detected(self) -> bool:
        m = len(self._recent)
        if m < self.recent_window or len(self._samples) < self.min_samples:
            return False
        if self._jobs - self._last_drift_job < self.drift_cooldown:
            return False
        n = len(self._samples)
        d = ks_statistic(self._recent, self._samples)
        self.last_ks_stat = d  # surfaced in the structured decision log
        return d > self.drift_threshold * np.sqrt((m + n) / (m * n))

    def _fail_drift_detected(self) -> bool:
        """Half-split test on the attempt-outcome window: did the failure
        rate move by more than fail_drift_threshold within it?"""
        m = len(self._outcomes)
        if m < self.fail_window:  # demand a full window of evidence
            return False
        if self._jobs - self._last_drift_job < self.drift_cooldown:
            return False
        arr = np.asarray(self._outcomes, dtype=np.float64)
        half = m // 2
        d = abs(float(arr[half:].mean()) - float(arr[:half].mean()))
        self.last_fail_drift = d
        return d > self.fail_drift_threshold

    def _candidates(self, n: Optional[int] = None) -> list:
        cands: list = [BASELINE]
        for p in self.p_grid:
            for keep in (True, False):
                # π_keep(p, 0) is baseline in disguise; π_kill(p, 0) is a
                # genuine relaunch policy, so kill starts at r = 0
                for r in range(1 if keep else 0, self.r_max + 1):
                    cands.append(SingleForkPolicy(float(p), r, keep))
        for t in self.t_grid:
            for keep in (True, False):
                for r in range(1 if keep else 0, self.r_max + 1):
                    cands.append(delayed_relaunch(float(t), r=r, keep=keep))
        for d in self.d_grid:
            if n is not None and (d >= n or n % d):
                continue  # d = n is unrestricted; d must divide n
            for p in self.p_grid:
                for keep in (True, False):
                    for r in range(1 if keep else 0, self.r_max + 1):
                        cands.append(group_replication(float(p), r, int(d), keep=keep))
        return cands

    def _search_geometry(self, n: int):
        """(c, classes) for the KW model: whole gang blocks per class,
        rounded DOWN — modeling more capacity than exists would loosen the
        very ρ guard this controller adds, so leftover slots are dropped.
        Classes too small for one gang block are excluded; if none fits
        (pooled placement spanning classes), the pool is modeled as
        homogeneous blocks of the total, again rounding down."""
        if self.classes is None:
            return max(1, (self.capacity or n) // n), None
        eff = [
            MachineClass(k.name, (k.slots // n) * n, k.speed)
            for k in self.classes
            if k.slots >= n
        ]
        if not eff:
            return max(1, sum(k.slots for k in self.classes) // n), None
        return None, tuple(eff)

    def _objective(self, row: dict, n: int) -> float:
        if self.objective == "cost":
            return row["mean_sojourn"] + self.lam_cost * n * row["mean_cost"]
        return row["mean_sojourn"]

    def _choose(self, rows: list[dict], n: int) -> dict:
        """Best candidate by objective among the stable ones; if nothing is
        stable at λ̂ (an overloaded fleet), least-overloaded wins."""
        stable = [r for r in rows if r["rho"] < self.rho_max]
        if stable:
            return min(stable, key=lambda r: self._objective(r, n))
        return min(rows, key=lambda r: r["rho"])

    def _class_shares(self) -> dict:
        """Completed-job share per class name (slot-proportional fallback)."""
        total = sum(k.slots for k in self.classes)
        shares = {k.name: k.slots / total for k in self.classes}
        known = [c for c in self._class_jobs if c in shares]
        if len(known) >= 16:
            shares = {name: 0.0 for name in shares}
            for c in known:
                shares[c] += 1.0 / len(known)
        return shares

    def _search_seed(self) -> int:
        return int(self._rng.integers(2**31))

    def _apply_blame(self, class_picks: dict, class_rows: dict, n: int) -> None:
        """Straggler-blame step of a re-plan: surface the attribution in
        the decision log and (blame_target=True) escalate the blamed
        class's pick to the best stable *replicating* candidate.

        Replicating exactly the machines that drag the tail is the
        clone-timing result (arXiv:1710.00748) this wires in: the
        per-class search already scores candidates under the class's own
        speed, but its objective is mean sojourn at the class's load — a
        class that is *the fleet's tail* deserves the tail-optimal policy
        even when the mean-optimal one is baseline."""
        blamed = self.blame.blamed(self.blame_min_score)
        if blamed is None:
            return
        ranking = self.blame.ranking()
        top = ranking[0]
        escalated = False
        if (self.blame_target and blamed in class_picks
                and blamed in class_rows):
            current = class_picks[blamed]
            if getattr(current, "is_baseline", False):
                rows_b = [
                    r for r in class_rows[blamed]
                    if not getattr(r["policy"], "is_baseline", False)
                    and r["rho"] < self.rho_max
                ]
                if rows_b:
                    class_picks[blamed] = min(
                        rows_b, key=lambda r: self._objective(r, n)
                    )["policy"]
                    escalated = True
        from ..obs.decisions import DecisionEvent, KIND_BLAME

        args = {
            "score": round(top.score, 4),
            "tail_delta": round(top.tail_delta, 6),
            "share": round(top.share, 4),
            "escalated": escalated,
        }
        if escalated:
            args["policy"] = class_picks[blamed].label()
        drifted = self.blame.drifted()
        if blamed in drifted:
            args["drift"] = round(drifted[blamed], 3)
        self.decisions.log(DecisionEvent(
            t=self._now, kind=KIND_BLAME, label=blamed, trigger="blame",
            ks_stat=top.ks, n_samples=top.n, args=args,
        ))

    def _reoptimize(self, trigger: str) -> None:
        lam_hat = self.lam_estimate()
        n = self.job_n
        if n is None or lam_hat is None or len(self._samples) < 2:
            return  # not enough signal to be load-aware yet
        samples = np.asarray(self._samples, dtype=np.float64)
        if len(samples) != self.window:
            # fixed-length bootstrap resample, as in the reference (the
            # search resamples anyway, and the controller's numpy stream
            # stays the reference's)
            samples = self._rng.choice(samples, size=self.window, replace=True)
        cands = self._candidates(n)
        c, classes = self._search_geometry(n)
        # failure-aware scoring: candidates are evaluated under the live
        # estimated per-attempt failure probability q̂ (the fused geometric-
        # retry transform), so replication levels are chosen for the fleet
        # the telemetry actually shows, not an idealized fault-free one
        fault = None
        q_hat = self.fail_rate_estimate()
        if q_hat is not None and q_hat > 0.0:
            from ..faults.model import FaultSpec

            fault = FaultSpec(q=min(q_hat, 0.95))
        # r_cap pins the fresh-draw width to the grid's ceiling, so every
        # re-plan draws the same layout
        rows = vector.policy_search(
            samples, cands, lam_hat, n,
            n_jobs=self.search_jobs, m_trials=self.search_trials,
            seed=self._search_seed(), c=c, classes=classes,
            kernel=self.use_kernel, r_cap=self.r_max + 1, fault=fault,
            device=self.device,
        )
        pick = self._choose(rows, n)
        pol = pick["policy"]
        explored = False
        if self._rng.random() < self.epsilon:
            if pol.is_baseline:
                probe = SingleForkPolicy(p=self.explore_p, r=1, keep=True)
            elif not isinstance(pol, SingleForkPolicy):
                # r-perturbation is a single-fork move; algebra picks keep
                # their searched parameters (the grid already spans them)
                probe = None
            else:
                dr = int(self._rng.choice((-1, 1)))
                r = int(np.clip(pol.r + dr, 0, self.r_max))
                probe = (
                    None
                    if (pol.keep and r == 0) or r == pol.r
                    else SingleForkPolicy(p=pol.p, r=r, keep=pol.keep)
                )
            # exploration must respect the same stability guard as the
            # pick: never probe a policy the search just scored unstable
            probe_row = next(
                (row for row in rows if probe is not None and row["policy"] == probe),
                None,
            )
            if probe_row is not None and probe_row["rho"] < self.rho_max:
                pick, pol = probe_row, probe  # the decision records what runs
                explored = True
        # per-class policies: each class re-searched at its λ̂ share with its
        # own speed/blocks (a slow pool saturates at a lower replication
        # level than a fast one)
        class_picks = None
        class_rows: dict = {}
        if classes is not None and len(classes) > 1:
            shares = self._class_shares()
            class_picks = {}
            for k in classes:
                lam_k = lam_hat * shares.get(k.name, 0.0)
                if lam_k <= 0:
                    continue
                rows_k = vector.policy_search(
                    samples, cands, lam_k, n,
                    n_jobs=self.search_jobs, m_trials=self.search_trials,
                    seed=self._search_seed(), classes=(k,),
                    kernel=self.use_kernel, r_cap=self.r_max + 1, fault=fault,
                    device=self.device,
                )
                class_rows[k.name] = rows_k
                class_picks[k.name] = self._choose(rows_k, n)["policy"]
            self._apply_blame(class_picks, class_rows, n)
            self._class_policies = dict(class_picks)
        self._policy = pol
        self.rho_hat = pick["rho"]
        n_vetoed = sum(1 for row in rows if row["rho"] >= self.rho_max)
        self.history.append(
            PolicyDecision(
                policy=pol,
                trigger=trigger,
                lam_hat=float(lam_hat),
                rho=float(pick["rho"]),
                mean_sojourn=float(pick["mean_sojourn"]),
                n_samples=len(self._samples),
                explored=explored,
                class_policies=class_picks,
                n_vetoed=n_vetoed,
                t=self._now,
            )
        )
        from ..obs.decisions import (
            DecisionEvent, KIND_EXPLORE, KIND_REPLAN, KIND_VETO,
        )

        args = None
        if class_picks:
            args = {"class_" + k: p.label() for k, p in class_picks.items()}
        self.decisions.log(DecisionEvent(
            t=self._now, kind=KIND_REPLAN, label=pol.label(), trigger=trigger,
            lam_hat=float(lam_hat), rho=float(pick["rho"]),
            n_samples=len(self._samples), n_vetoed=n_vetoed, args=args,
        ))
        if n_vetoed:
            self.decisions.log(DecisionEvent(
                t=self._now, kind=KIND_VETO,
                label=f"{n_vetoed}/{len(rows)} candidates over rho_max",
                trigger=trigger, rho=float(self.rho_max), n_vetoed=n_vetoed,
            ))
        if explored:
            self.decisions.log(DecisionEvent(
                t=self._now, kind=KIND_EXPLORE, label=pol.label(),
                trigger="epsilon", rho=float(pick["rho"]),
            ))


# --------------------------------------------------------------------------
# provider adaptation for the legacy single-job controller
# --------------------------------------------------------------------------


class _LegacyProvider:
    """`OnlinePolicyController` behind the scheduler's provider hook.

    Preserves the pre-hook semantics exactly: telemetry forwarded, no
    arrival tracking, and the learned policy only overrides the scheduler
    default once it is a *replicating* one (baseline means "not learned
    yet" for the single-job controller, which starts at BASELINE)."""

    def __init__(self, inner: OnlinePolicyController):
        self.inner = inner

    def bind_fleet(self, classes) -> None:
        pass

    def observe_arrival(self, t: float) -> None:
        pass

    def policy_for(self, job=None, machine_class=None):
        learned = self.inner.current_policy()
        return None if learned.is_baseline else learned

    def record_task_time(self, seconds, machine_class=None) -> None:
        self.inner.record_task_time(seconds)

    def record_job_complete(self, n_tasks=None, machine_class=None, now=None,
                            sojourn=None) -> None:
        self.inner.record_job_complete(n_tasks=n_tasks)


def as_policy_provider(controller):
    """Normalize a controller to the scheduler's policy-provider interface
    (anything already exposing `policy_for` passes through untouched)."""
    if controller is None:
        return None
    if hasattr(controller, "policy_for"):
        return controller
    return _LegacyProvider(controller)
