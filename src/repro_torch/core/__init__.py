# The paper's straggler-replication core, ported: distributions, the policy
# algebra and its lowering, Monte-Carlo simulation and the Algorithm 1
# bootstrap.  analysis / residual / evt / optimize / adaptive are not
# ported yet (ROADMAP Queue 1).
from .distributions import (  # noqa: F401
    Distribution,
    Empirical,
    Pareto,
    ShiftedExp,
    Uniform,
    Weibull,
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
)
from .bootstrap import BootstrapEstimate, estimate, residual_tail_grid  # noqa: F401
