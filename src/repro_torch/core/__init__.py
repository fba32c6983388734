# The paper's straggler-replication core, ported: distributions, the policy
# algebra and its lowering, residual distributions and the Theorem 1-3
# analysis, Monte-Carlo simulation, the Algorithm 1 bootstrap, policy
# optimization and the online controller.
from .distributions import (  # noqa: F401
    Distribution,
    Empirical,
    Pareto,
    ShiftedExp,
    Uniform,
    Weibull,
    upper_end_point,
)
from .policy import (  # noqa: F401
    BASELINE,
    AnySlot,
    AtQuantile,
    AtTime,
    ForkPolicy,
    GroupSelect,
    LoweredPolicies,
    MultiForkPolicy,
    OnClass,
    SingleForkPolicy,
    as_fork_policy,
    delayed_relaunch,
    fork_index,
    group_replication,
    lower_policies,
    max_replicas,
    num_stragglers,
    on_class,
)
from .simulate import (  # noqa: F401
    SimResult,
    lowered_policy_eval,
    policy_draws,
    simulate,
    simulate_multifork,
    single_fork_batch,
    single_fork_trial,
)
from .residual import ResidualDistribution  # noqa: F401
from .analysis import (  # noqa: F401
    LatencyCost,
    baseline_cost,
    baseline_latency,
    corollary1_exponent,
    lemma1_prefer_kill,
    theorem1,
    theorem2_cost,
    theorem2_latency,
    theorem3_cost,
    theorem3_latency,
)
from .bootstrap import BootstrapEstimate, estimate, residual_tail_grid  # noqa: F401
from .optimize import (  # noqa: F401
    PolicyEvaluation,
    analytic_evaluator,
    bootstrap_evaluator,
    optimize_cost_sensitive,
    optimize_latency_sensitive,
    tradeoff_curve,
)
from .adaptive import OnlinePolicyController  # noqa: F401
from . import evt  # noqa: F401
