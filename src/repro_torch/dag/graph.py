"""Multi-stage DAG job model: stages, barriers, per-stage policies.

A copy of `repro.dag.graph` for the port.

The paper's setting is MapReduce — a job is map → shuffle → reduce, and
every stage ends in a synchronization *barrier*: the next stage cannot
start a single task until the previous stage's last task (straggler
included) has finished.  The frameworks the paper compares against
replicate per stage, and the interesting policy questions are
stage-coupled: the best (p, r, keep|kill) for the map stage depends on how
reduce-stage stragglers amplify through the barrier.  This module is the
pure data model; `repro_torch.dag.rollout` is the fused vectorized engine and
`repro_torch.dag.engine` the discrete-event ground truth.

A `StageSpec` is one gang of `n_tasks` i.i.d. tasks with its own service
distribution (analytic, `Empirical`, or a raw trace slice), its own
replication `policy`, and its own pool of `c` gang blocks (capacity =
c·n_tasks slots — the map-slot / reduce-slot split of classic MapReduce
schedulers).  `deps` names the stages whose barriers must release before
this stage may enter its queue (fan-in = a multi-input barrier: ready time
is the max of the predecessors' finish times).

A `JobDAG` is a tuple of stages in topological order — validated, not
assumed: every dependency must name an *earlier* stage, which makes cycles
unrepresentable and gives both engines a shared, deterministic traversal
order.  `JobDAG.pipeline` builds the linear map→reduce case;
`JobDAG.map_reduce` is the two-stage convenience used by the examples and
benchmarks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np

from ..core.distributions import Distribution, Empirical
from ..core.policy import BASELINE, OnClass, SingleForkPolicy, as_fork_policy

__all__ = ["JobDAG", "StageSpec"]


def _check_stage_policy(stage_name: str, policy) -> None:
    """A per-stage policy is anything the algebra lowers — except OnClass:
    a DAG stage's pool has no machine classes to restrict."""
    if isinstance(policy, SingleForkPolicy):
        return
    try:
        fp = as_fork_policy(policy)
    except TypeError as exc:
        raise TypeError(
            f"stage {stage_name!r}: expected an algebra policy "
            f"(SingleForkPolicy / MultiForkPolicy / ForkPolicy), got {policy!r}"
        ) from exc
    if isinstance(fp.where, OnClass):
        raise TypeError(
            f"stage {stage_name!r}: OnClass placement restricts machine "
            "classes in a fleet; DAG stage pools are homogeneous"
        )


def _as_distribution(dist) -> Distribution:
    """Accept a Distribution (incl. Empirical) or a raw trace slice."""
    if isinstance(dist, Distribution):
        return dist
    samples = np.asarray(dist, dtype=np.float64).ravel()
    if samples.size < 2:
        raise ValueError("a trace slice needs at least 2 samples")
    return Empirical(samples)


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """One barrier-terminated gang stage of a DAG job.

    `dist` may be any `Distribution` or a raw sample array (wrapped in
    `Empirical`, i.e. a per-stage trace slice); `policy` is the stage's
    default replication policy (rollouts and searches may override it with
    a per-stage policy vector); `c` is the number of concurrent gang blocks
    in this stage's dedicated pool; `deps` names the upstream stages whose
    completion releases this stage's barrier (empty = source stage fed by
    the job's arrival).
    """

    name: str
    n_tasks: int
    dist: Union[Distribution, Sequence[float]]
    policy: SingleForkPolicy = BASELINE
    c: int = 1
    deps: Tuple[str, ...] = ()

    def __post_init__(self):
        if not self.name:
            raise ValueError("stage name must be non-empty")
        if self.n_tasks < 1:
            raise ValueError(f"stage {self.name!r}: n_tasks must be >= 1")
        if self.c < 1:
            raise ValueError(f"stage {self.name!r}: c (gang blocks) must be >= 1")
        # normalize once so .dist is always a Distribution afterwards
        object.__setattr__(self, "dist", _as_distribution(self.dist))
        object.__setattr__(self, "deps", tuple(self.deps))
        _check_stage_policy(self.name, self.policy)


class JobDAG:
    """A job template: stages in validated topological order.

    Construction checks (the "validated topological order" contract both
    engines rely on):

      * stage names are unique and every `deps` entry names a stage that
        appears *earlier* in the list — so the listed order IS a
        topological order and cycles cannot be expressed;
      * at least one source stage (no deps) exists.

    Derived views: `preds` / `succs` (name-keyed adjacency), `sources`,
    `sinks` (stages nothing depends on — their barrier max is the job's
    completion), and `index[name]`.
    """

    def __init__(self, stages: Sequence[StageSpec]):
        stages = tuple(stages)
        if not stages:
            raise ValueError("a JobDAG needs at least one stage")
        names = [s.name for s in stages]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate stage names in {names}")
        self.stages: Tuple[StageSpec, ...] = stages
        self.index = {s.name: i for i, s in enumerate(stages)}
        for i, s in enumerate(stages):
            for d in s.deps:
                if d not in self.index:
                    raise ValueError(f"stage {s.name!r} depends on unknown stage {d!r}")
                if self.index[d] >= i:
                    raise ValueError(
                        f"stage {s.name!r} depends on {d!r}, which does not appear "
                        "earlier in the stage list — stages must be listed in "
                        "topological order"
                    )
        self.preds = {s.name: tuple(s.deps) for s in stages}
        succs: dict = {s.name: [] for s in stages}
        for s in stages:
            for d in s.deps:
                succs[d].append(s.name)
        self.succs = {k: tuple(v) for k, v in succs.items()}
        self.sources = tuple(s.name for s in stages if not s.deps)
        self.sinks = tuple(s.name for s in stages if not self.succs[s.name])
        if not self.sources:  # pragma: no cover — unreachable given topo check
            raise ValueError("a JobDAG needs at least one source stage")

    def __len__(self) -> int:
        return len(self.stages)

    def __iter__(self):
        return iter(self.stages)

    def stage(self, name: str) -> StageSpec:
        return self.stages[self.index[name]]

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(s.name for s in self.stages)

    def policies(self) -> Tuple[SingleForkPolicy, ...]:
        """The per-stage default policy vector."""
        return tuple(s.policy for s in self.stages)

    def validate_policy_vector(
        self, policies: Optional[Sequence[SingleForkPolicy]]
    ) -> Tuple[SingleForkPolicy, ...]:
        """Resolve an override vector (None = the stages' own policies)."""
        if policies is None:
            return self.policies()
        policies = tuple(policies)
        if len(policies) != len(self.stages):
            raise ValueError(
                f"policy vector has {len(policies)} entries for "
                f"{len(self.stages)} stages"
            )
        for s, pol in zip(self.stages, policies):
            _check_stage_policy(s.name, pol)
        return policies

    def with_policies(self, policies: Sequence[SingleForkPolicy]) -> "JobDAG":
        """A copy of this DAG with the per-stage policies replaced."""
        policies = self.validate_policy_vector(policies)
        return JobDAG(
            tuple(
                dataclasses.replace(s, policy=pol)
                for s, pol in zip(self.stages, policies)
            )
        )

    # ------------------------------------------------------------- builders
    @staticmethod
    def pipeline(stages: Sequence[StageSpec]) -> "JobDAG":
        """Linear chain: stage i depends on stage i-1 (map → shuffle → …)."""
        out, prev = [], None
        for s in stages:
            if s.deps:
                raise ValueError(
                    f"pipeline() wires deps itself; stage {s.name!r} already has "
                    f"{s.deps}"
                )
            out.append(dataclasses.replace(s, deps=(prev,) if prev else ()))
            prev = s.name
        return JobDAG(out)

    @staticmethod
    def map_reduce(
        n_map: int,
        n_reduce: int,
        map_dist,
        reduce_dist,
        map_policy: SingleForkPolicy = BASELINE,
        reduce_policy: SingleForkPolicy = BASELINE,
        c_map: int = 1,
        c_reduce: int = 1,
    ) -> "JobDAG":
        """The canonical two-stage map → reduce job."""
        return JobDAG.pipeline(
            [
                StageSpec("map", n_map, map_dist, map_policy, c=c_map),
                StageSpec("reduce", n_reduce, reduce_dist, reduce_policy, c=c_reduce),
            ]
        )

    def __repr__(self) -> str:
        parts = []
        for s in self.stages:
            dep = f"<-{','.join(s.deps)}" if s.deps else ""
            parts.append(f"{s.name}(n={s.n_tasks},c={s.c}){dep}")
        return f"JobDAG[{' '.join(parts)}]"
