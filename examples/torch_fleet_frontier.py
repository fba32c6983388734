"""The fused frontier engine of the PyTorch port: a whole (λ × policy)
design sweep in one device program, plus the CUDA Kiefer–Wolfowitz queue
kernel.

    PYTHONPATH=src python examples/torch_fleet_frontier.py [--quick]               # on the card
    PYTHONPATH=src python examples/torch_fleet_frontier.py --quick --device cpu

The port's counterpart of ``examples/fleet_frontier.py``.  The paper's
design questions (when to fork, how many replicas, keep or kill) are
answered by scanning latency–cost frontiers; `repro_torch.fleet.frontier`
evaluates the whole grid as one program over shared common-random-number
draws, so same-λ comparisons are variance-reduced.

Three demonstrations, asserted so that this runs as a smoke test
(`--quick` shrinks the shapes):

  1. the fused frontier against the per-cell loop (`sweep_loop`, one
     `fleet_rollout` a cell): the same answers within Monte Carlo error,
     a fraction of the wall time;
  2. the CUDA kw_queue kernel against `kw_queue_plain` on the batch the
     c = 3 frontier feeds it, bit for bit, and the c = 3 frontier through
     it.  It needs the card: on the CPU the wrapper runs the plain
     version itself, so there is nothing to compare;
  3. what the frontier is for: the cheapest stable policy per load.

Without ``--device`` every entry point runs on the card and raises where
there is none.
"""

import argparse
import time

import torch

from repro_torch.core import ShiftedExp, SingleForkPolicy
from repro_torch.device import resolve_device
from repro_torch.fleet import frontier
from repro_torch.fleet.vector import sweep_loop
from repro_torch.kernels.kw_queue import kw_queue, kw_queue_plain

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--quick", action="store_true", help="smaller shapes")
ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default: the card)")
args = ap.parse_args()

DEVICE = resolve_device(args.device)
DIST = ShiftedExp(1.0, 1.0)
N_TASKS = 16
N_JOBS = 200 if args.quick else 600
M_TRIALS = 8 if args.quick else 16
POLICIES = (
    SingleForkPolicy(0.0, 0, True),
    SingleForkPolicy(0.1, 1, True),
    SingleForkPolicy(0.2, 1, False),
    SingleForkPolicy(0.4, 1, True),
)
LAMS = (0.05, 0.12, 0.2) if args.quick else (0.05, 0.08, 0.12, 0.16, 0.2, 0.24)


def timed(fn):
    if DEVICE.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if DEVICE.type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


# -- 1. fused engine vs per-cell loop ---------------------------------------
frontier(DIST, POLICIES, LAMS, N_TASKS, N_JOBS, m_trials=M_TRIALS, seed=0, device=DEVICE)
sweep_loop(DIST, POLICIES, LAMS[:1], N_TASKS, N_JOBS, m_trials=M_TRIALS, seed=0, device=DEVICE)
fused, fused_s = timed(lambda: frontier(DIST, POLICIES, LAMS, N_TASKS, N_JOBS, m_trials=M_TRIALS, seed=0,
                                        device=DEVICE))
loop, loop_s = timed(lambda: sweep_loop(DIST, POLICIES, LAMS, N_TASKS, N_JOBS, m_trials=M_TRIALS, seed=0,
                                        device=DEVICE))
cells = len(POLICIES) * len(LAMS)
print(
    f"{len(POLICIES)} policies x {len(LAMS)} loads = {cells} cells on {DEVICE}: "
    f"fused {fused_s * 1e3:.0f}ms (one program) vs per-cell loop "
    f"{loop_s * 1e3:.0f}ms ({cells} rollouts) -> {loop_s / fused_s:.1f}x"
)
worst = 0.0
for f, l in zip(fused, loop):
    sigma = max((f["sojourn_std_err"] ** 2 + l["sojourn_std_err"] ** 2) ** 0.5, 1e-12)
    worst = max(worst, abs(f["mean_sojourn"] - l["mean_sojourn"]) / sigma)
print(f"agreement on every shared cell: worst deviation {worst:.2f} sigma")
assert worst < 5.0, "fused frontier must agree with the per-cell loop"

# -- 2. the CUDA kw_queue kernel carries the c > 1 frontier -----------------
if DEVICE.type == "cuda":
    # the batch one c = 3 cell's queue sees: M_TRIALS queues of N_JOBS jobs
    g = torch.Generator(device=DEVICE).manual_seed(1)
    arrivals = torch.cumsum(torch.empty((M_TRIALS * len(POLICIES), N_JOBS), device=DEVICE)
                            .exponential_(generator=g) / 0.5, dim=1)
    services = 1.0 + torch.empty_like(arrivals).exponential_(generator=g)
    speeds = torch.ones(3, device=DEVICE)
    got, want = kw_queue(arrivals, services, speeds), kw_queue_plain(arrivals, services, speeds)
    assert all(torch.equal(a, b) for a, b in zip(got, want)), "kernel and plain recursion must agree"
    before = kw_queue.launches
    rows = frontier(DIST, POLICIES, (0.5,), N_TASKS, N_JOBS, m_trials=M_TRIALS, c=3, seed=1, device=DEVICE)
    print(
        f"\nCUDA kw_queue vs kw_queue_plain on {tuple(arrivals.shape)} queues at c=3: bit-equal; "
        f"the c=3 frontier ({len(rows)} cells) launched it {kw_queue.launches - before} time(s)"
    )
    assert kw_queue.launches > before, "the c = 3 frontier must queue through the kernel"
else:
    print(
        f"\nCUDA kw_queue vs kw_queue_plain: not run on {DEVICE} (the kernel needs the card; "
        "on the CPU the wrapper runs kw_queue_plain itself, so there is nothing to compare)"
    )

# -- 3. the frontier read-out: cheapest stable policy per load --------------
print(f"\n{'lambda':>7s} {'best policy':26s} {'E[sojourn]':>10s} {'E[C]':>6s} {'rho':>5s}")
for lam in LAMS:
    at_lam = [r for r in fused if r["lam"] == lam]
    stable = [r for r in at_lam if r["rho"] < 0.95] or at_lam
    best = min(stable, key=lambda r: r["mean_sojourn"])
    print(
        f"{lam:7.2f} {best['policy']:26s} {best['mean_sojourn']:10.2f} "
        f"{best['mean_cost']:6.2f} {best['rho']:5.2f}"
    )

base_hi = next(r for r in fused if r["lam"] == LAMS[-1] and r["policy"] == "baseline")
print(
    "\nreplication wins while the fleet has headroom; as rho climbs the "
    f"frontier backs it off (baseline at lambda={LAMS[-1]}: "
    f"rho={base_hi['rho']:.2f})."
)
