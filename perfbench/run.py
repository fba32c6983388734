"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's configuration and traffic mix (named in BENCHMARK.json),
makes the inputs from the seed, warms up on the cell's own grid, runs the
closed loop of planner queries for `--seconds`, compares sampled queries
with the plain reference, and prints one JSON line last on standard
output.  `--trace 1` runs a few queries under torch.profiler and reports
the per-layer metrics instead of the end-to-end ones.  It needs an NVIDIA
card and never falls back to the CPU.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    marks = [("import_torch", time.perf_counter() - T0)]
    from bench import cell, spec

    bench = spec.benchmark()
    wl = spec.workload(bench, args.workload)
    available = torch.cuda.is_available()
    marks.append(("cuda_available", time.perf_counter() - T0))
    if not available:
        print("perfbench: no CUDA device; this benchmark runs on the card only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(wl.get("chips", 1)):
        print(f"perfbench: {wl['name']} needs {wl['chips']} cards, {torch.cuda.device_count()} present",
              file=sys.stderr)
        return 2
    cfg = spec.config(bench, wl["config"])
    trf = spec.traffic(wl["traffic"])
    return cell.run_cell(bench, wl, cfg, trf, args.seed, args.seconds, bool(args.trace), "cuda", T0, marks=marks)


if __name__ == "__main__":
    sys.exit(main())
