"""Scheduling policies: the composable straggler-policy algebra.

The paper's single-fork policy π(p, r, keep|kill) (Definition 1) launches
all n tasks at t=0, waits for (1-p)n to finish, then for each of the pn
stragglers either

  * π_keep(p, r): keeps the original copy and launches r new replicas, or
  * π_kill(p, r): kills the original and launches r+1 new replicas.

Either way r+1 replicas run after the fork point; first finisher wins and
siblings are cancelled.  BASELINE is π(p=0, ·) — launch n, wait for all.

That policy is one point in a larger space the related work explores, and
the whole space factors over four independent axes (DESIGN.md §14):

  when       AtQuantile(p) — fork when (1-p)n tasks are done (the paper);
             AtTime(t) — fork at wall-clock t after job start ("delayed
             relaunch", Aktaş–Peng–Soljanin); a tuple of several = a
             multi-stage schedule.
  how_many   r fresh replicas per straggler (per stage).
  where      ANY_SLOT — replicas draw from the whole pool;
             GroupSelect(d) — (n, d) server selection / group replication
             (Badita et al.): tasks are partitioned into n/d groups of d
             and each group forks on its OWN completion quantile,
             replicating only its own stragglers (d = n recovers the
             unrestricted global fork exactly);
             OnClass(name) — placement pinned to one machine class (an
             event-engine / queue-geometry restriction: it changes which
             slots serve the job, not the single-job (T, C) law, so it
             lowers to engine configuration rather than tensor params).
  keep       keep|kill the original copy at each fork (per stage).

`ForkPolicy` composes the axes; `SingleForkPolicy` and `MultiForkPolicy`
remain as thin constructors for the classic families, and
`delayed_relaunch` / `group_replication` build the two related-work
families.  `lower_policies` produces the canonical fixed-width param
tensor every engine consumes — see LoweredPolicies.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple, Union

import numpy as np

__all__ = [
    "ANY_SLOT",
    "AnySlot",
    "AtQuantile",
    "AtTime",
    "BASELINE",
    "ForkPolicy",
    "GroupSelect",
    "LoweredPolicies",
    "MultiForkPolicy",
    "OnClass",
    "SingleForkPolicy",
    "as_fork_policy",
    "delayed_relaunch",
    "fork_index",
    "group_replication",
    "lower_policies",
    "max_replicas",
    "num_stragglers",
    "on_class",
]


# --------------------------------------------------------------------------
# the classic constructors (paper Definition 1 and [24, §6.4])
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SingleForkPolicy:
    p: float  # fraction of tasks declared stragglers (fork at (1-p)n done)
    r: int  # new replicas per straggler
    keep: bool = True  # keep the original copy (π_keep) or kill it (π_kill)

    def __post_init__(self):
        if not 0.0 <= self.p < 1.0:
            raise ValueError(f"p must be in [0, 1), got {self.p}")
        if self.r < 0:
            raise ValueError(f"r must be >= 0, got {self.r}")
        if not self.keep and self.r == 0 and self.p > 0:
            # π_kill(p, 0) relaunches one fresh copy; legal, just noting that
            # π_keep(p, 0) is the baseline in disguise.
            pass

    @property
    def is_baseline(self) -> bool:
        return self.p == 0.0 or (self.keep and self.r == 0)

    @property
    def replicas_after_fork(self) -> int:
        """Total copies of a straggling task running after the fork (= r+1)."""
        return self.r + 1

    def label(self) -> str:
        if self.is_baseline:
            return "baseline"
        mode = "keep" if self.keep else "kill"
        return f"pi_{mode}(p={self.p:g}, r={self.r})"


BASELINE = SingleForkPolicy(p=0.0, r=0, keep=True)


@dataclasses.dataclass(frozen=True)
class MultiForkPolicy:
    """Fork at several completion quantiles.  stages[i] = (p_i, r_i, keep_i):
    when (1 - p_i) n tasks are done, each still-running task gets r_i extra
    replicas (keep_i=False additionally kills currently running copies).
    p must be strictly decreasing (later forks act on fewer tasks)."""

    stages: Tuple[Tuple[float, int, bool], ...]

    def __post_init__(self):
        ps = [s[0] for s in self.stages]
        if any(not 0 < p < 1 for p in ps):
            raise ValueError("every stage p must be in (0,1)")
        if any(a <= b for a, b in zip(ps, ps[1:])):
            raise ValueError("stage p's must be strictly decreasing")
        if any(int(s[1]) < 0 for s in self.stages):
            raise ValueError("every stage r must be >= 0")

    @staticmethod
    def from_single(policy: SingleForkPolicy) -> "MultiForkPolicy":
        return MultiForkPolicy(((policy.p, policy.r, policy.keep),))

    def label(self) -> str:
        inner = " | ".join(
            f"p={p:g},r={r},{'keep' if keep else 'kill'}"
            for p, r, keep in self.stages
        )
        return f"pi_multi({inner})"


# --------------------------------------------------------------------------
# the algebra axes
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AtQuantile:
    """Fork when (1 - p)·width tasks are done (width = n, or the group's d)."""

    p: float

    def __post_init__(self):
        if not 0.0 < self.p < 1.0:
            raise ValueError(f"AtQuantile p must be in (0, 1), got {self.p}")


@dataclasses.dataclass(frozen=True)
class AtTime:
    """Fork at wall-clock time t after the job's start (delayed relaunch)."""

    t: float

    def __post_init__(self):
        if self.t < 0.0:
            raise ValueError(f"AtTime t must be >= 0, got {self.t}")


@dataclasses.dataclass(frozen=True)
class AnySlot:
    """Unrestricted placement: replicas draw from the whole pool."""


ANY_SLOT = AnySlot()


@dataclasses.dataclass(frozen=True)
class GroupSelect:
    """(n, d) server selection: tasks partition into groups of d; each group
    forks on its own local completion quantile and replicates only its own
    stragglers.  d = n is exactly the unrestricted global fork."""

    d: int

    def __post_init__(self):
        if self.d < 1:
            raise ValueError(f"GroupSelect d must be >= 1, got {self.d}")


@dataclasses.dataclass(frozen=True)
class OnClass:
    """Placement pinned to one machine class (by name)."""

    name: str

    def __post_init__(self):
        if not self.name:
            raise ValueError("OnClass needs a non-empty class name")


When = Union[AtQuantile, AtTime]
Where = Union[AnySlot, GroupSelect, OnClass]


def _when_key(w: When) -> str:
    if isinstance(w, AtQuantile):
        return "q"
    if isinstance(w, AtTime):
        return "t"
    raise TypeError(f"unsupported when-axis value {w!r}")


@dataclasses.dataclass(frozen=True)
class ForkPolicy:
    """A point of the policy algebra: when × how_many × where × keep/kill.

    `when` is a single trigger or a tuple of triggers (a multi-stage
    schedule); `how_many` / `keep` are one value applied to every stage or
    per-stage tuples of the same length.  An empty `when` tuple is the
    baseline (never fork).  Stages fire in order; quantile stages must have
    strictly decreasing p and time stages strictly increasing t (each
    subsequence, so mixed schedules stay causally ordered per kind).
    Group selection is single-stage (a per-group multi-stage schedule has
    no event-engine counterpart yet).
    """

    when: tuple  # tuple of AtQuantile | AtTime (possibly empty)
    how_many: tuple = ()  # per-stage r
    where: Where = ANY_SLOT
    keep: tuple = ()  # per-stage keep|kill

    def __post_init__(self):
        when = self.when if isinstance(self.when, tuple) else (self.when,)
        s = len(when)
        how = self.how_many
        if not isinstance(how, tuple):
            how = (int(how),) * s
        keep = self.keep
        if not isinstance(keep, tuple):
            keep = (bool(keep),) * s
        if len(how) != s or len(keep) != s:
            raise ValueError(
                f"how_many/keep must match the {s} stage(s) of `when`; "
                f"got {len(how)} and {len(keep)}"
            )
        for w in when:
            _when_key(w)  # raises on unsupported types
        if any(int(r) < 0 for r in how):
            raise ValueError("every stage r must be >= 0")
        ps = [w.p for w in when if isinstance(w, AtQuantile)]
        if any(a <= b for a, b in zip(ps, ps[1:])):
            raise ValueError("quantile stages must have strictly decreasing p")
        ts = [w.t for w in when if isinstance(w, AtTime)]
        if any(a >= b for a, b in zip(ts, ts[1:])):
            raise ValueError("time stages must have strictly increasing t")
        if not isinstance(self.where, (AnySlot, GroupSelect, OnClass)):
            raise TypeError(f"unsupported where-axis value {self.where!r}")
        if isinstance(self.where, GroupSelect) and s > 1:
            raise ValueError("group selection composes with single-stage schedules only")
        object.__setattr__(self, "when", when)
        object.__setattr__(self, "how_many", tuple(int(r) for r in how))
        object.__setattr__(self, "keep", tuple(bool(k) for k in keep))

    @property
    def stages(self) -> tuple:
        """((when_i, r_i, keep_i), ...) in firing order."""
        return tuple(zip(self.when, self.how_many, self.keep))

    @property
    def is_baseline(self) -> bool:
        return not self.when

    def label(self) -> str:
        if self.is_baseline:
            base = "baseline"
        else:
            parts = []
            for w, r, keep in self.stages:
                mode = "keep" if keep else "kill"
                if isinstance(w, AtQuantile):
                    parts.append(f"p={w.p:g},r={r},{mode}")
                else:
                    parts.append(f"t={w.t:g},r={r},{mode}")
            base = f"pi({' | '.join(parts)})"
        if isinstance(self.where, GroupSelect):
            return f"{base}@d{self.where.d}"
        if isinstance(self.where, OnClass):
            return f"{base}@class:{self.where.name}"
        return base


# --------------------------------------------------------------------------
# thin constructors for the related-work families
# --------------------------------------------------------------------------


def delayed_relaunch(t: float, r: int = 0, keep: bool = False) -> ForkPolicy:
    """Delayed relaunch at wall-clock t (Aktaş et al. 1710.00414): every
    task still running at t gets r fresh replicas (keep) or is killed and
    relaunched with r+1 fresh copies (kill, the classic single-relaunch at
    r=0).  t=0 with kill is the fork-at-start clone attack."""
    return ForkPolicy(when=AtTime(float(t)), how_many=int(r), keep=bool(keep))


def group_replication(p: float, r: int, d: int, keep: bool = True) -> ForkPolicy:
    """(n, d) group replication (Badita et al. 1911.05918): tasks partition
    into groups of d; each group forks at ITS (1-p)d-th completion,
    replicating its own stragglers with r fresh copies.  d = n is exactly
    the unrestricted single fork π(p, r, keep|kill)."""
    return ForkPolicy(
        when=AtQuantile(float(p)), how_many=int(r), where=GroupSelect(int(d)),
        keep=bool(keep),
    )


def on_class(policy, name: str) -> ForkPolicy:
    """Re-place an (unrestricted) policy onto one machine class."""
    fp = as_fork_policy(policy)
    if not isinstance(fp.where, AnySlot):
        raise ValueError(f"policy already carries a placement: {fp.where!r}")
    return dataclasses.replace(fp, where=OnClass(name))


def as_fork_policy(policy) -> ForkPolicy:
    """Canonicalize any supported policy object into the algebra."""
    if isinstance(policy, ForkPolicy):
        return policy
    if isinstance(policy, SingleForkPolicy):
        if policy.is_baseline:
            return ForkPolicy(when=())
        return ForkPolicy(
            when=AtQuantile(policy.p), how_many=policy.r, keep=policy.keep
        )
    if isinstance(policy, MultiForkPolicy):
        return ForkPolicy(
            when=tuple(AtQuantile(p) for p, _, _ in policy.stages),
            how_many=tuple(r for _, r, _ in policy.stages),
            keep=tuple(k for _, _, k in policy.stages),
        )
    raise TypeError(f"unsupported policy {policy!r}")


def max_replicas(policy) -> int:
    """Largest per-stage r of a policy (0 for baseline): the quantity
    engines pin their fresh-draw width (r_cap) to."""
    fp = as_fork_policy(policy)
    return max(fp.how_many, default=0)


# --------------------------------------------------------------------------
# the rounding contract and the canonical lowering
# --------------------------------------------------------------------------


def num_stragglers(n: int, p: float) -> int:
    """pn with explicit rounding (paper assumes pn integer; we round half
    UP — floor(pn + 1/2) — and keep at least 1 straggler for any p > 0 so
    π(p>0) always forks).  This is THE rounding contract: every engine's
    fork index derives from it via `fork_index` / `lower_policies`."""
    if p <= 0.0:
        return 0
    return max(1, min(n - 1, int(math.floor(p * n + 0.5))))


def fork_index(n: int, p: float) -> int:
    """The fork point k = n - pn: the completion count that triggers the
    fork (and the order-statistic index the masked sampler gathers at)."""
    return n - num_stragglers(n, p)


#: stage-mode codes in the lowered tensor
MODE_QUANTILE = 0
MODE_TIME = 1
MODE_INACTIVE = -1


@dataclasses.dataclass(frozen=True)
class LoweredPolicies:
    """The canonical fixed-width param tensor of a policy grid.

    One row per cell, `n_stages` (= the grid's max schedule length) stage
    slots per row, padded with inactive stages; every engine — the fused
    masked sampler, the single-job trial sampler, the event schedulers —
    reads THIS encoding, so a new family is one lowering rule, not one
    code path per engine.  All arrays are host numpy; engines convert.

      mode  (cells, S) int32   MODE_QUANTILE | MODE_TIME | MODE_INACTIVE
      k     (cells, S) int32   quantile fork index WITHIN the group width
                               (baseline lowers to k = width: zero stragglers)
      t     (cells, S) float   wall-clock fork instant (time stages; +inf
                               on others so masks stay inert)
      r     (cells, S) int32   fresh replicas per straggler
      keep  (cells, S) bool    keep|kill at that stage
      d     (cells,)   int32   group width (= n for unrestricted placement)

    `r_max` is the grid's largest r (engines draw fresh blocks of width
    >= r_max + 1); `multi_stage` / `has_time` / `has_group` are host-side
    hints (e.g. single-stage grids keep the historical bit-exact fast
    formulas).  OnClass placement does not lower to tensor params — it
    changes queue geometry, not the single-job law — so it surfaces as
    `class_names` for the event engines and is rejected by engines that
    model a single shared pool.
    """

    n: int
    n_stages: int
    mode: np.ndarray
    k: np.ndarray
    t: np.ndarray
    r: np.ndarray
    keep: np.ndarray
    d: np.ndarray
    class_names: tuple  # per-cell OnClass name or None
    r_max: int
    multi_stage: bool
    has_time: bool
    has_group: bool


def lower_policies(policies: Sequence, n: int) -> LoweredPolicies:
    """Lower a policy grid to the fixed-width tensor (see LoweredPolicies)."""
    fps = [as_fork_policy(pol) for pol in policies]
    if not fps:
        raise ValueError("need at least one policy to lower")
    n_stages = max(1, max(len(fp.when) for fp in fps))
    cells = len(fps)
    mode = np.full((cells, n_stages), MODE_INACTIVE, np.int32)
    k = np.zeros((cells, n_stages), np.int32)
    t = np.full((cells, n_stages), np.inf, np.float32)
    r = np.zeros((cells, n_stages), np.int32)
    keep = np.ones((cells, n_stages), bool)
    d = np.full((cells,), n, np.int32)
    class_names = []
    for i, fp in enumerate(fps):
        width = n
        if isinstance(fp.where, GroupSelect):
            width = fp.where.d
            if width > n or n % width:
                raise ValueError(
                    f"group width d={width} must divide n={n} "
                    f"(policy {fp.label()!r})"
                )
            d[i] = width
        class_names.append(fp.where.name if isinstance(fp.where, OnClass) else None)
        if fp.is_baseline:
            # the historical baseline encoding: an active quantile stage
            # whose fork index equals the width — zero stragglers
            mode[i, 0] = MODE_QUANTILE
            k[i, 0] = width
            continue
        for s, (w, r_s, keep_s) in enumerate(fp.stages):
            r[i, s] = r_s
            keep[i, s] = keep_s
            if isinstance(w, AtQuantile):
                mode[i, s] = MODE_QUANTILE
                k[i, s] = fork_index(width, w.p)
            else:
                mode[i, s] = MODE_TIME
                t[i, s] = w.t
    return LoweredPolicies(
        n=n,
        n_stages=n_stages,
        mode=mode,
        k=k,
        t=t,
        r=r,
        keep=keep,
        d=d,
        class_names=tuple(class_names),
        r_max=int(r.max()) if cells else 0,
        multi_stage=n_stages > 1,
        has_time=bool((mode == MODE_TIME).any()),
        has_group=bool((d != n).any()),
    )
