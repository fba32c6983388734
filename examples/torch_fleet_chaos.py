"""Chaos drill on the PyTorch port: a mid-run outage kills 30% of the fleet
while every task attempt can fail — the graceful-degradation ladder sheds
best-effort work during the crunch and the tail recovers after repair.

    PYTHONPATH=src python examples/torch_fleet_chaos.py [--quick]               # on the card
    PYTHONPATH=src python examples/torch_fleet_chaos.py --quick --device cpu

The port's counterpart of ``examples/fleet_chaos.py``.  The scenario
(`repro_torch.fleet.CHAOS`): a steady Poisson stream of 16-task jobs on a
64-slot pool, task attempts failing with q = 5% (absorbed by capped-backoff
retries), and a deterministic outage window [120 s, 240 s) taking 19 slots
down.  The scheduler runs the full ladder:

  * failed copies re-queue with exponential backoff, draining before new
    admissions — no job is lost to transient failures;
  * while the shrunken pool saturates (estimated gang-occupancy ρ̂ above
    `shed_rho`), best-effort arrivals (priority 1) are shed at the door;
    priority 0 is never shed;
  * when the slots come back, shedding stops and the p99 sojourn returns
    to its pre-outage level.

It prints a per-window health table (before / during / after the outage),
the chaos counters and the availability / MTTR gauges, and asserts the
ladder's contract.  `--quick` runs 160 jobs instead of 260 and writes no
file; without it the run's Chrome trace goes to
build/examples/torch_fleet_chaos_trace.json.  The
drill is the event engine's, on the host; ``--device`` (default: the
card, which it then requires) is where its `FleetConfig` would plan.
"""

import argparse
import pathlib

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.fleet import CHAOS, FleetConfig, FleetSim
from repro_torch.obs import write_chrome_trace

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--quick", action="store_true", help="160 jobs, no trace file")
ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default: the card)")
args = ap.parse_args()
DEVICE = resolve_device(args.device)
SCEN = CHAOS
N_JOBS = 160 if args.quick else 260

jobs = SCEN.workload(N_JOBS)
fault = SCEN.fault()
(outage,) = fault.schedule.outages
print(
    f"{N_JOBS} jobs x {SCEN.n_tasks} tasks on {SCEN.capacity} slots, "
    f"lambda={SCEN.lam}/s, q={SCEN.q:.0%} task-failure rate;\n"
    f"outage: {outage.n_slots} slots down over [{outage.time:.0f}s, "
    f"{SCEN.outage_end:.0f}s), shed guard at rho={SCEN.shed_rho}\n"
)

sim = FleetSim(FleetConfig(
    capacity=SCEN.capacity,
    policy=SCEN.policy,
    discipline="priority",  # the shed guard protects priority 0
    seed=SCEN.seed,
    fault=fault,
    shed_rho=SCEN.shed_rho,
    obs=True,
    device=DEVICE,
))
rep = sim.run(jobs)

# -- per-window health: before / during / after the outage -----------------
done = [r for r in rep.records if not r.failed]
windows = [
    ("before outage", 0.0, outage.time),
    ("during outage", outage.time, SCEN.outage_end),
    ("after repair", SCEN.outage_end, float("inf")),
]
print(f"{'window':14s} {'jobs':>5s} {'E[wait]':>8s} {'p99 sojourn':>12s}")
health = {}
for name, lo, hi in windows:
    rs = [r for r in done if lo <= r.arrival < hi]
    wait = float(np.mean([r.wait for r in rs]))
    p99 = float(np.percentile([r.sojourn for r in rs], 99))
    health[name] = (wait, p99)
    print(f"{name:14s} {len(rs):5d} {wait:8.3f} {p99:12.2f}")

shed_arrivals = [r.arrival for r in rep.records if r.failure == "shed"]
print(
    f"\nchaos counters: {rep.n_task_failures} task failures, "
    f"{rep.n_retries} retries, {rep.n_crash_kills} crash kills, "
    f"{rep.n_shed} shed, {rep.n_timeouts} timeouts, {rep.n_failed} failed jobs"
)
print(
    f"availability = {rep.stats.availability:.3f}, "
    f"MTTR = {rep.stats.class_mttr['default']:.0f}s, "
    f"mean attempts/task = {rep.stats.mean_attempts:.3f}"
)
if shed_arrivals:
    print(f"shed arrivals span [{min(shed_arrivals):.0f}s, {max(shed_arrivals):.0f}s] — inside the outage window only")

if not args.quick:
    trace_path = pathlib.Path(__file__).resolve().parent.parent / "build" / "examples" / "torch_fleet_chaos_trace.json"
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    write_chrome_trace(trace_path, rep.trace)
    print(f"wrote {len(rep.trace.spans)} spans / {len(rep.trace.instants)} markers to {trace_path} "
          "(load in Perfetto / chrome://tracing)")

# -- the ladder's contract, asserted ---------------------------------------
# retries absorbed every transient failure: nothing lost, nothing retried
# past its budget
assert rep.n_task_failures > 0 and rep.n_retries > 0
assert len(rep.records) == N_JOBS
assert rep.n_failed == rep.n_shed  # only shed jobs are terminal here
# the shed guard fired, and only while the outage had the pool saturated
assert rep.n_shed > 0, "the outage should push rho-hat past the shed guard"
assert all(outage.time <= t < SCEN.outage_end for t in shed_arrivals), "shedding must be confined to the outage window"
# downtime is visible to the operator
assert rep.stats.availability < 1.0
assert rep.stats.class_mttr["default"] == outage.duration
# and the tail recovers once the slots come back
assert health["after repair"][0] < health["during outage"][0], "queueing delay should drain after repair"
assert health["after repair"][1] <= health["during outage"][1] + 0.5, (
    "p99 sojourn should recover to ~pre-outage level after repair")
print("\nchaos drill passed: shed only during the outage, tail recovered after.")
