#!/usr/bin/env python3
"""Run the port's examples, each in its own process, and time them.

    python3 tools/run_examples.py                      # every examples/torch_*.py, on the card
    python3 tools/run_examples.py --device cpu --quick torch_quickstart torch_fleet_sim

Prints one JSON line an example (its wall seconds from start to exit, its
exit code, the last lines of its output), then the card's name and power
limit as nvidia-smi gives them where there is a card; exits nonzero if an
example failed.  `torch_straggler_training` (a 200-step training preset of
`repro_torch.launch.train`, which chip_smoke.py's phase `train` drives at
full width) is left out unless named.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", help="examples to run (default: every examples/torch_*.py but training)")
    ap.add_argument("--device", default=None, help="passed to each example (default: the card)")
    ap.add_argument("--quick", action="store_true", help="passed to each example")
    ap.add_argument("--timeout", type=float, default=600.0, help="seconds an example")
    args = ap.parse_args()
    names = args.names or sorted(p.stem for p in (ROOT / "examples").glob("torch_*.py")
                                 if p.stem != "torch_straggler_training")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    failed = 0
    for name in names:
        argv = [sys.executable, str(ROOT / "examples" / f"{name}.py")]
        argv += ["--device", args.device] if args.device else []
        argv += ["--quick"] if args.quick else []
        t0 = time.perf_counter()
        out = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True, text=True, timeout=args.timeout)
        wall = time.perf_counter() - t0
        failed += out.returncode != 0
        print(json.dumps(dict(example=name, wall_s=wall, rc=out.returncode, quick=args.quick,
                              device=args.device or "cuda", tail=(out.stdout + out.stderr).splitlines()[-4:])),
              flush=True)
    if args.device in (None, "cuda"):
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        print(smi.stdout.strip())
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
