#!/usr/bin/env python3
"""How far the host's jitter moves chip_smoke.py's recorder-overhead gates
(`obs_frontier_overhead`, `chaos_obs_overhead`), on one card.

    python3 tools/obs_noise.py [--rounds 20] [--round-s 0.5] [--device cuda]

For each of the two lanes of phase `fleet_gates` (the fused frontier, 5
policies x 6 loads, and the failure-aware grid on c = 2 blocks, both at
bench_fleet.py's 600 jobs x 12 trials), it prints one JSON line with:
  - `one_call_s`: one warm call's wall;
  - `blocks_3` and `blocks_long`: the ratio of two blocks' total walls,
    off/off (`aa`, the recorder never on) and on/off, over `--rounds`
    rounds of blocks of 3 calls (bench_fleet.py's rule) and of as many
    calls as fill `--round-s` seconds (a fifth as many rounds), sorted,
    with the count of ratios above the gates' 1.05;
  - `median_rule`: chip_smoke's `_obs_overhead` (alternating calls, the
    ratio of medians), run `--rounds` // 5 times.
The card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--round-s", type=float, default=0.5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from repro_torch.core import ShiftedExp
    from repro_torch.faults import FaultSpec
    from repro_torch.fleet import vector
    from repro_torch.obs import trace

    device = torch.device(args.device)
    if device.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip(), flush=True)
    fg = cs.FULL["fleet_gates"]
    dist, pols = ShiftedExp(*cs.GATE_DIST), cs.gate_policies()
    specs = tuple(FaultSpec(q=q, max_attempts=cs.GATE_CHAOS_ATTEMPTS) for q in cs.GATE_CHAOS_QS)

    def front(policies, lams, seed, **kw):
        return vector.frontier(dist, policies, lams, cs.GATE_N_TASKS, fg["n_jobs"], m_trials=fg["m_trials"],
                               seed=seed, device=device, **kw)

    lanes = dict(
        obs_frontier_overhead=lambda: front(pols["frontier"], cs.GATE_FRONTIER_LAMS, cs.GATE_SEEDS["frontier"]),
        chaos_obs_overhead=lambda: front(pols["policies"][:2], cs.GATE_CHAOS_LAMS, cs.GATE_SEEDS["chaos"],
                                         c=cs.GATE_CHAOS_BLOCKS, fault=specs),
    )

    def block(fn, reps, on):
        if on:
            trace.enable()
        try:
            return cs._timed_call(torch, device, lambda: [fn() for _ in range(reps)])[1]
        finally:
            trace.disable()

    for name, fn in lanes.items():
        for _ in range(3):
            fn()
        one_s = cs._timed_call(torch, device, fn)[1]
        line = dict(lane=name, one_call_s=one_s)
        long_reps = max(3, math.ceil(args.round_s / one_s))
        for key, reps, rounds in (("blocks_3", 3, args.rounds), ("blocks_long", long_reps, max(1, args.rounds // 5))):
            aa = sorted(block(fn, reps, False) / block(fn, reps, False) for _ in range(rounds))
            onoff = []
            for _ in range(rounds):
                off = block(fn, reps, False)
                onoff.append(block(fn, reps, True) / off)
            line[key] = dict(reps=reps, aa=aa, onoff=sorted(onoff), aa_above=sum(r > 1.05 for r in aa),
                             onoff_above=sum(r > 1.05 for r in onoff))
        line["median_rule"] = [cs._obs_overhead(torch, device, 3, fg["obs_reps"], args.round_s, fn)
                               for _ in range(max(1, args.rounds // 5))]
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
