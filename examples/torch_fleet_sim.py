"""Fleet-scale straggler replication on the PyTorch port: 1000 jobs on a
finite worker pool.

    PYTHONPATH=src python examples/torch_fleet_sim.py [--quick]               # on the card
    PYTHONPATH=src python examples/torch_fleet_sim.py --quick --device cpu

The port's counterpart of ``examples/fleet_sim.py``.  The single-job
analysis says more replication = less latency.  Under queueing it stops
being true: replicas consume the same slots arriving jobs need, so "naive
full replication" (kill-and-relaunch nearly every task with 3 copies)
inflates per-job cost E[C], pushes the offered load ρ = λ·n·E[C]/capacity
past 1, and the queue — hence every latency percentile — collapses.  A
small-p single fork (the paper's answer) cuts the straggler tail at ~2%
extra cost and stays comfortably stable.  Asserted: the small-p fork cuts
the p99 sojourn, and naive replication more than doubles the mean.

Also shown: the fused λ × policy frontier, the Kiefer–Wolfowitz G/G/c
capacity-planning curve (the CUDA kw_queue kernel on the card) and
heterogeneous pools, with one cell cross-checked by the event engine.
The event engine (`FleetSim`) runs on the host; the fused engines on the
device, which without ``--device`` is the card (it raises where there is
none).  `--quick` takes 400 jobs and 8 trials a cell.
"""

import argparse
import time

from repro_torch.core import ShiftedExp, SingleForkPolicy
from repro_torch.device import resolve_device
from repro_torch.fleet import FleetConfig, FleetSim, MachineClass, fleet_rollout, frontier, poisson_workload

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--quick", action="store_true", help="400 jobs, 8 trials a cell")
ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default: the card)")
args = ap.parse_args()
DEVICE = resolve_device(args.device)

DIST = ShiftedExp(1.0, 1.0)  # task times: 1s floor + Exp(1) tail
N_TASKS = 20  # tasks per job (gang-scheduled)
CAPACITY = 60  # worker slots shared by everyone
N_JOBS = 400 if args.quick else 1000
M_TRIALS = 8 if args.quick else 16
LAM = 0.75  # job arrivals per second

POLICIES = (
    ("baseline (no replication)", SingleForkPolicy(0.0, 0, True)),
    ("small-p fork pi_keep(0.05,1)", SingleForkPolicy(0.05, 1, True)),
    ("naive full replication pi_kill(0.9,2)", SingleForkPolicy(0.9, 2, False)),
)

print(f"{N_JOBS} jobs x {N_TASKS} tasks, capacity {CAPACITY}, lambda={LAM}/s\n")
print(f"{'policy':40s} {'E[sojourn]':>10s} {'p99':>8s} {'E[C]':>6s} {'util':>5s} {'wait':>7s}")
results = {}
for label, policy in POLICIES:
    jobs = poisson_workload(N_JOBS, rate=LAM, n_tasks=N_TASKS, dist=DIST, seed=11)
    s = FleetSim(FleetConfig(capacity=CAPACITY, policy=policy, seed=11)).run(jobs).stats
    results[label] = s
    print(f"{label:40s} {s.mean_sojourn:10.2f} {s.p99_sojourn:8.1f} {s.mean_cost:6.2f} {s.utilization:5.2f} "
          f"{s.mean_wait:7.2f}")

base, smart, naive = (results[label] for label, _ in POLICIES)
assert smart.p99_sojourn < base.p99_sojourn, "small-p fork should cut the p99 tail"
assert naive.mean_sojourn > 2 * smart.mean_sojourn, "naive full replication should collapse under queueing"
rho_base = LAM * N_TASKS * base.mean_cost / CAPACITY
rho_naive = LAM * N_TASKS * naive.mean_cost / CAPACITY
print(
    f"\nnaive replication inflates E[C] {naive.mean_cost / base.mean_cost:.1f}x, "
    f"offered load {rho_base:.2f} -> {rho_naive:.2f}: replicas crowd out gang\n"
    f"admissions (jobs need {N_TASKS} free slots at once) and queueing delay collapses;"
    f"\nsmall-p forking pays {100 * (smart.mean_cost / base.mean_cost - 1):.1f}% extra cost "
    f"for a {100 * (1 - smart.p99_sojourn / base.p99_sojourn):.0f}% lower p99."
)

# -- fused λ × policy frontier (dedicated-capacity regime) ------------------
# the whole cross-product is one device program over shared draws
lams = [0.05, 0.1, 0.15, 0.2, 0.25]
t0 = time.perf_counter()
rows = frontier(DIST, [p for _, p in POLICIES[:2]], lams, n=N_TASKS, n_jobs=N_JOBS, m_trials=M_TRIALS,
                device=DEVICE)
dt = time.perf_counter() - t0
print(f"\nfused lambda x policy frontier (capacity=n regime) on {DEVICE}, {dt:.2f}s for {len(rows)} cells:")
for r in rows:
    print(f"  {r['policy']:24s} lambda={r['lam']:.2f}  E[sojourn]={r['mean_sojourn']:6.2f}  "
          f"p99={r['p99']:6.1f}  util={r['utilization']:.2f}")

# -- multi-server fast path: how many gang blocks does the SLO need? --------
# Kiefer-Wolfowitz G/G/c sweep: same policy and load, growing c
print("\ncapacity planning via the KW fast path (lambda=0.6, pi_keep(0.05,1)):")
waits = []
for c in (1, 2, 3, 4):
    res = fleet_rollout(DIST, POLICIES[1][1], lam=0.6, n=N_TASKS, n_jobs=N_JOBS, m_trials=M_TRIALS, c=c,
                        device=DEVICE)
    waits.append(res.mean_wait)
    print(f"  c={c} blocks ({c * N_TASKS:3d} slots): E[wait]={res.mean_wait:7.2f}  "
          f"p99={res.percentile(99):7.1f}  util={float(res.utilization.mean()):.2f}")
assert waits == sorted(waits, reverse=True), "more gang blocks must not lengthen the wait"

# -- heterogeneous pools: is cheap slow capacity worth it? ------------------
# constant 4 gang blocks, part of the fleet a half-speed pool: jobs
# overflow onto it only when the fast pool is busy
print("\nfast/slow mix at 4 blocks (slow pool at half speed), lambda=0.6:")
for n_fast, n_slow in ((4, 0), (3, 1), (2, 2), (1, 3)):
    cls = []
    if n_fast:
        cls.append(MachineClass("fast", n_fast * N_TASKS, 1.0))
    if n_slow:
        cls.append(MachineClass("slow", n_slow * N_TASKS, 0.5))
    s = fleet_rollout(DIST, POLICIES[1][1], lam=0.6, n=N_TASKS, n_jobs=N_JOBS, m_trials=M_TRIALS,
                      classes=tuple(cls), device=DEVICE).summary()
    print(f"  {n_fast}fast+{n_slow}slow: E[sojourn]={s['mean_sojourn']:6.2f}  p99={s['p99']:6.1f}  "
          f"slow-pool util={s.get('util_slow', 0.0):.2f}")

# the same mix through the exact event engine (aligned placement) lands on
# the same frontier (tests/test_torch_events.py holds it); one cell here
jobs = poisson_workload(N_JOBS, rate=0.6, n_tasks=N_TASKS, dist=DIST, seed=3)
classes = (MachineClass("fast", 2 * N_TASKS, 1.0), MachineClass("slow", 2 * N_TASKS, 0.5))
rep = FleetSim(FleetConfig(policy=POLICIES[1][1], seed=3, classes=classes, placement="aligned")).run(jobs)
print(
    f"\nevent-engine cross-check (2fast+2slow): E[sojourn]={rep.stats.mean_sojourn:.2f}, "
    f"per-class util={ {k: round(v, 2) for k, v in rep.stats.class_utilization.items()} }, "
    f"job share={ {k: round(v, 2) for k, v in rep.stats.class_job_share.items()} }"
)
