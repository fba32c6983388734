#!/usr/bin/env python3
"""The single-job evaluator's kernel against its PyTorch chains, on the card.

    python3 tools/single_job_trace.py [--reps 20]

Phase `kernels`' single_job cases of `chip_smoke.py` alone
(`single_job_kernel_cases`): one JSON line a grid (`job1.frontier`: Job
1's 8 single-fork policies, sorted draws, r_cap 3; `job1.general`: its 4
delayed-relaunch and two-stage laws, S 2, r_cap 2; "cross": phase paper's
cross-family grid, group widths 6 and 2), at full size: 2048 jobs × 16
trials of 1026 tasks, drawn as the engine draws them (`fork_draws` or
`policy_draws`, then `running_min`).  Each line holds the card's name and
power limit, the kernel's and the chain's times (`chip_smoke.time_turns`:
CUDA events, L2 flushed before each call, kernel, chain, chain, kernel,
each the mean of its two medians), the byte bound (`single_job_bytes`: x
read once, the 32-byte sectors of cm that hold a column some law reads at
a straggler, T and C written, over 3.35 TB/s), and C's largest absolute
and relative gaps (T is checked bit-equal first).  Only a card runs it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    import torch

    import chip_smoke

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("single_job_trace: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    sizes = dict(chip_smoke.FULL, kernel_reps=args.reps)
    for case in chip_smoke.single_job_kernel_cases(torch, dev, sizes, flush):
        case["bound_ms"], case["bound_by"] = case.pop("bound")
        print(json.dumps(dict(case, card=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
