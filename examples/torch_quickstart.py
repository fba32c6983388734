"""Quickstart on the PyTorch port: the paper's core API in one page.

    PYTHONPATH=src python examples/torch_quickstart.py [--quick]               # on the card
    PYTHONPATH=src python examples/torch_quickstart.py --quick --device cpu

The port's counterpart of ``examples/quickstart.py``:

1. Define an execution-time distribution and a single-fork policy.
2. Get E[T], E[C] three ways: closed form, general quadrature, Monte Carlo.
3. Estimate the same metrics from an empirical trace (Algorithm 1).
4. Ask the optimizer for the best policy (eq. 19).

Asserted so that it runs as a smoke test: the quadrature agrees with the
closed form, Monte Carlo with both within 5 standard errors, replication
beats the baseline, and the optimizer's pick is faster than the baseline
at no more cost.  `--quick` takes fewer trials and a coarser p grid.  The
closed forms and the quadrature run on the host; Monte Carlo and
Algorithm 1 on the device, which without ``--device`` is the card (it
raises where there is none).
"""

import argparse

import numpy as np
import torch

from repro_torch.core import (
    BASELINE,
    Pareto,
    SingleForkPolicy,
    bootstrap_evaluator,
    estimate,
    optimize_latency_sensitive,
    simulate,
    theorem1,
    theorem3_cost,
    theorem3_latency,
)
from repro_torch.device import resolve_device

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--quick", action="store_true", help="fewer trials, a coarser p grid")
ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default: the card)")
args = ap.parse_args()
DEVICE = resolve_device(args.device)
M = 1000 if args.quick else 4000

# 1. heavy-tailed machines (Pareto fits datacenter task times; paper §3.2.2)
dist = Pareto(alpha=2.0, xm=2.0)
policy = SingleForkPolicy(p=0.1, r=1, keep=False)  # replicate slowest 10%, kill originals
n = 400  # tasks in the job

# 2. three routes to the same numbers
closed = (theorem3_latency(dist, policy, n), theorem3_cost(dist, policy, n))
quad = theorem1(dist, policy, n).as_tuple()
mc = simulate(dist, policy, n, m=M, seed=0, device=DEVICE)
print(f"closed form : E[T]={closed[0]:7.2f}  E[C]={closed[1]:5.2f}")
print(f"quadrature  : E[T]={quad[0]:7.2f}  E[C]={quad[1]:5.2f}")
print(f"monte-carlo : E[T]={mc.mean_latency:7.2f}  E[C]={mc.mean_cost:5.2f}  ({M} trials on {DEVICE})")
assert abs(quad[0] - closed[0]) <= 2e-2 * closed[0] and abs(quad[1] - closed[1]) <= 2e-2 * closed[1], (
    "Theorem 1's quadrature must agree with Theorem 3's closed form")
assert abs(mc.mean_latency - quad[0]) <= 5 * mc.latency_std_err + 2e-2 * quad[0], "Monte Carlo E[T]"
assert abs(mc.mean_cost - quad[1]) <= 5 * mc.cost_std_err + 2e-2 * quad[1], "Monte Carlo E[C]"

base = simulate(dist, BASELINE, n, m=M, seed=0, device=DEVICE)
print(
    f"vs baseline : E[T]={base.mean_latency:7.2f}  E[C]={base.mean_cost:5.2f}"
    f"  -> {base.mean_latency / mc.mean_latency:.1f}x faster, "
    f"{'cheaper' if mc.mean_cost < base.mean_cost else 'pricier'}"
)
assert mc.mean_latency < base.mean_latency, "replicating the slowest 10% must cut E[T]"

# 3. the same estimate from raw samples (Algorithm 1 — no fitted model)
trace = dist.sample(torch.Generator().manual_seed(1), (n,)).numpy()
est = estimate(trace, policy, m=M // 4, seed=0, device=DEVICE)
print(f"algorithm 1 : E[T]={est.latency:7.2f}  E[C]={est.cost:5.2f}  (from {n} samples)")
assert np.isfinite([est.latency, est.cost]).all() and est.latency > 0

# 4. best policy with no extra cost budget (eq. 19)
p_grid = np.arange(0.1, 0.45, 0.1) if args.quick else np.arange(0.05, 0.45, 0.05)
best, base_ev = optimize_latency_sensitive(bootstrap_evaluator(trace, m=300, device=DEVICE), r_max=4, p_grid=p_grid)
print(
    f"optimizer   : {best.policy.label()}  E[T]={best.latency:.2f} "
    f"({base_ev.latency / best.latency:.1f}x faster than baseline at equal cost)"
)
assert best.latency < base_ev.latency and best.cost <= base_ev.cost, "eq. 19's pick must beat the baseline"
