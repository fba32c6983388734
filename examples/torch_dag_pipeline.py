"""Multi-stage DAG jobs on the PyTorch port: per-stage replication beats
any uniform policy.

    PYTHONPATH=src python examples/torch_dag_pipeline.py [--quick]     # on the card
    PYTHONPATH=src python examples/torch_dag_pipeline.py --device cpu

The port's counterpart of ``examples/dag_pipeline.py``.  A wordcount-shaped
MapReduce job (8 map tasks -> barrier -> 4 reduce tasks) whose two stages
draw from different empirical task-time distributions, the stage-labelled
synthetic Google traces: map plays the heavy-tailed Job 1 (replication
cuts both E[T] and E[C]), reduce the tail-shortened Job 3 (aggressive
replication mostly burns slots).  Stage pools are separate, jobs queue
per stage, and stragglers amplify through the barrier.

Demonstrations, asserted so that this runs as a smoke test (`--quick`
shrinks the shapes; at its 128 jobs x 8 trials the best uniform policy is
a near-tie between two vectors, and demonstration 1's strict E[C]
domination holds for about 7 of 10 seeds, in the JAX package as here):

  1. the joint per-stage search (every candidate vector in one fused
     program over shared draws) finds a vector that strictly dominates the
     best uniform policy: lower E[T] and lower E[C];
  2. coordinate ascent over stages reaches the exhaustive optimum in
     fewer evaluations;
  3. critical-path attribution: which stage's stragglers dominate E[T],
     and how the best vector shifts the blame across load;
  4. the stage-aware event engine (`DagFleetSim`, on the host) agrees with
     the fused rollout on the chosen vector within Monte Carlo error;
  5. the event run's trace, written for Perfetto under build/examples/.

Without ``--device`` the fused engine runs on the card and raises where
there is none.
"""

import argparse
import pathlib
import time

import numpy as np

from repro_torch.core import SingleForkPolicy
from repro_torch.dag import (
    DagFleetConfig,
    DagFleetSim,
    JobDAG,
    best_stable,
    coordinate_search,
    dag_frontier,
    dag_rollout,
    exhaustive_search,
    poisson_arrivals,
    uniform_vectors,
)
from repro_torch.data.traces import load_stage_trace
from repro_torch.device import resolve_device
from repro_torch.obs import write_chrome_trace

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--quick", action="store_true", help="smaller shapes")
ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default: the card)")
args = ap.parse_args()

DEVICE = resolve_device(args.device)
N_JOBS = 128 if args.quick else 256
M_TRIALS = 8 if args.quick else 16
LAM = 0.55
R_CAPS = (3, 3)

BASE = SingleForkPolicy(0.0, 0, True)
CANDS = [
    BASE,
    SingleForkPolicy(0.05, 1, True),
    SingleForkPolicy(0.1, 1, True),
    SingleForkPolicy(0.1, 2, True),
    SingleForkPolicy(0.1, 1, False),
    SingleForkPolicy(0.2, 1, True),
]

# 8 map tasks -> 4 reduce tasks; two map gang blocks against one reduce
# block makes the reduce pool the hot one
dag = JobDAG.map_reduce(
    8, 4,
    load_stage_trace("map"),  # job1: heavy straggler tail
    load_stage_trace("reduce"),  # job3: tail-shortened
    c_map=2, c_reduce=1,
)

# -- 1. joint search vs the best uniform policy ------------------------------
t0 = time.perf_counter()
ex = exhaustive_search(dag, CANDS, lam=LAM, n_jobs=N_JOBS, m_trials=M_TRIALS, seed=0, device=DEVICE)
ex_s = time.perf_counter() - t0
joint = ex["best"]
uni_rows = dag_frontier(
    dag, uniform_vectors(dag, CANDS), (LAM,), N_JOBS, m_trials=M_TRIALS, seed=0, r_caps=R_CAPS, device=DEVICE,
)
uniform = best_stable(uni_rows)  # the searches' own ρ-guarded argmin
print(
    f"joint search over {ex['n_cells']} policy vectors "
    f"({len(CANDS)} candidates/stage, one fused program on {DEVICE}, {ex_s:.1f}s):"
)
print(f"  joint   {joint['label']}")
print(f"          E[T]={joint['mean_sojourn']:.3f}  E[C]={joint['mean_cost']:.3f}  "
      f"rho={joint['rho']:.2f}")
print(f"  uniform {uniform['label']}")
print(f"          E[T]={uniform['mean_sojourn']:.3f}  E[C]={uniform['mean_cost']:.3f}  "
      f"rho={uniform['rho']:.2f}")
assert joint["mean_sojourn"] < uniform["mean_sojourn"], "joint must cut latency"
assert joint["mean_cost"] < uniform["mean_cost"], "joint must cut cost"
mpol, rpol = joint["policies"]
assert mpol.label() != rpol.label(), "the winning vector must be stage-heterogeneous"
print("  -> strict domination: per-stage policies beat every uniform one\n")

# -- 2. coordinate ascent reaches the same optimum ---------------------------
co = coordinate_search(dag, CANDS, lam=LAM, n_jobs=N_JOBS, m_trials=M_TRIALS, seed=0, device=DEVICE)
print(
    f"coordinate ascent: {co['n_evals']} evaluations "
    f"(exhaustive: {ex['n_cells']}), {co['sweeps']} sweeps, "
    f"converged={co['converged']}"
)
print(f"  best {co['best']['label']}  E[T]={co['best']['mean_sojourn']:.3f}")
assert co["converged"], "coordinate ascent must converge on this grid"
assert co["best"]["mean_sojourn"] <= uniform["mean_sojourn"] + 1e-9

# -- 3. critical-path attribution across load --------------------------------
lams = (0.3, LAM, 0.75) if args.quick else (0.2, 0.35, LAM, 0.75, 0.9)
rows = dag_frontier(
    dag, [joint["policies"], (BASE, BASE)], lams, N_JOBS, m_trials=M_TRIALS, seed=0, r_caps=R_CAPS, device=DEVICE,
)
print("\ncritical-path shares (which stage's stragglers dominate E[T]):")
print(f"{'lambda':>7s} {'policy vector':44s} {'E[T]':>7s} {'map':>6s} {'reduce':>7s}")
for r in rows:
    print(
        f"{r['lam']:7.2f} {r['label']:44s} {r['mean_sojourn']:7.2f} "
        f"{r['map/share']:6.2f} {r['reduce/share']:7.2f}"
    )
    assert abs(r["map/share"] + r["reduce/share"] - 1.0) < 1e-4
hot = [r for r in rows if r["policies"] == joint["policies"]]
print(
    "  -> as load grows the one-block reduce pool's queueing takes over the "
    f"critical path ({hot[0]['reduce/share']:.2f} -> {hot[-1]['reduce/share']:.2f})."
)

# -- 4. event-engine cross-check on the chosen vector ------------------------
# obs=True records the event run's trace: one Perfetto process per stage
# (queue/service spans per job), barrier-release markers, and a dag.jobs
# row from each job's arrival to its sink barrier
n_ev = 200 if args.quick else 500
res = dag_rollout(dag, lam=LAM, n_jobs=n_ev, m_trials=M_TRIALS, policies=joint["policies"], seed=1, device=DEVICE)
rep = DagFleetSim(DagFleetConfig(dag, policies=joint["policies"], obs=True)).run(poisson_arrivals(n_ev, LAM, seed=2))
sigma = max(float(np.hypot(res.sojourn_std_err, rep.stats.sojourn_std_err)), 1e-12)
dev = abs(res.mean_sojourn - rep.stats.mean_sojourn) / sigma
print(
    f"\nevent-engine ground truth: fused E[T]={res.mean_sojourn:.3f} vs "
    f"event E[T]={rep.stats.mean_sojourn:.3f} ({dev:.2f} sigma); "
    f"event critical-path shares "
    f"map={rep.stats.critical_path_shares['map']:.2f} "
    f"reduce={rep.stats.critical_path_shares['reduce']:.2f}"
)
assert dev < 5.0, "fused rollout must agree with the stage-aware event engine"
assert abs(sum(rep.stats.critical_path_shares.values()) - 1.0) < 1e-9

# -- 5. export the event run's trace for Perfetto ----------------------------
trace_path = pathlib.Path(__file__).resolve().parent.parent / "build" / "examples" / "torch_dag_pipeline_trace.json"
trace_path.parent.mkdir(parents=True, exist_ok=True)
write_chrome_trace(trace_path, rep.trace)
dag_spans = rep.trace.spans_named("dag_job")
assert len(dag_spans) == n_ev, "one dag_job span per job"
print(
    f"wrote {len(rep.trace.spans)} spans ({len(dag_spans)} dag_job rows, "
    f"per-stage queue/service spans, barrier markers) to {trace_path}"
)
