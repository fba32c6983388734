"""Trace-driven scheduling-policy search on the PyTorch port (paper §4 end
to end).

    PYTHONPATH=src python examples/torch_trace_policy_search.py [--job job1] [--quick]     # on the card
    PYTHONPATH=src python examples/torch_trace_policy_search.py --quick --device cpu

The port's counterpart of ``examples/trace_policy_search.py``: the Table 1
workflow on the synthesized Google-cluster jobs (`repro_torch.data.traces`)
— Algorithm 1's bootstrap estimates of the baseline and of MapReduce's
backup tasks, then the latency-sensitive (eq. 19) and cost-sensitive
(eq. 20, λ = 0.1) optimizers over r ≤ 4, keep and kill.  Asserted: each
latency-sensitive pick is faster than the baseline at no more cost, and
each cost-sensitive pick scores no worse than the baseline on its own
objective.  `--quick` takes one job, fewer replicates and a coarser grid.
The bootstrap runs on the device, which without ``--device`` is the card
(it raises where there is none).
"""

import argparse

import numpy as np

from repro_torch.core import (
    BASELINE,
    SingleForkPolicy,
    bootstrap_evaluator,
    estimate,
    optimize_cost_sensitive,
    optimize_latency_sensitive,
)
from repro_torch.data import TRACE_JOBS, synthesize_trace
from repro_torch.device import resolve_device

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--job", choices=TRACE_JOBS, default=None)
ap.add_argument("--quick", action="store_true", help="one job, fewer replicates, a coarser p grid")
ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default: the card)")
args = ap.parse_args()
DEVICE = resolve_device(args.device)
jobs = [args.job] if args.job else (["job2"] if args.quick else list(TRACE_JOBS))
M_EST, M_OPT = (200, 100) if args.quick else (400, 300)
P_GRID = np.arange(0.02, 0.42, 0.12 if args.quick else 0.04)
LAM = 0.1

for job in jobs:
    trace = synthesize_trace(job)
    print(f"\n=== {job}: {len(trace)} tasks, median {np.median(trace):.0f}s, max {trace.max():.0f}s ===")
    base = estimate(trace, BASELINE, m=M_EST, device=DEVICE)
    print(f"baseline              E[T]={base.latency:7.0f}  E[C]={base.cost:6.0f}")

    mapreduce = SingleForkPolicy(0.1, 1, True)  # 'backup tasks' (Remark 1)
    mr = estimate(trace, mapreduce, m=M_EST, device=DEVICE)
    print(f"mapreduce r=1 keep    E[T]={mr.latency:7.0f}  E[C]={mr.cost:6.0f}")

    ev = bootstrap_evaluator(trace, m=M_OPT, device=DEVICE)
    best_l, base_ev = optimize_latency_sensitive(ev, r_max=4, p_grid=P_GRID)
    print(f"latency-sensitive     E[T]={best_l.latency:7.0f}  E[C]={best_l.cost:6.0f}  <- {best_l.policy.label()}")
    best_c, _ = optimize_cost_sensitive(ev, lam=LAM, n=len(trace), r_max=4, p_grid=P_GRID)
    print(f"cost-sensitive λ=0.1  E[T]={best_c.latency:7.0f}  E[C]={best_c.cost:6.0f}  <- {best_c.policy.label()}")
    assert best_l.latency < base_ev.latency and best_l.cost <= base_ev.cost, f"{job}: eq. 19's pick"
    objective = lambda e: e.latency + LAM * len(trace) * e.cost  # noqa: E731
    assert objective(best_c) <= objective(base_ev), f"{job}: eq. 20's pick"
print("\nevery pick beats the baseline on its own objective")
