"""Readings behind the comparison's limits, for one cell, in one process.

    python3 perfbench/calibrate.py --workload <name> --seeds 11,12,... [--control 3]

For each seed: one query of the program at the cell's own size (the
window's first query of a run with that seed), the plain reference on it,
and the four numbers of `bench.check` (the lower readings).  For the first
`--control` seeds also the control: the reference computed in bfloat16, put
in the program's place and compared the same way (the upper readings).
One JSON line a seed, then a summary line.  Needs the card, as run.py does;
the benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent / "src"))


def readings(workload: str, seeds: list, n_control: int, device, trf_override=None) -> list:
    import torch

    from bench import cell, check, port, reference, spec

    bench = spec.benchmark()
    wl = spec.workload(bench, workload)
    cfg, trf = spec.config(bench, wl["config"]), spec.traffic(wl["traffic"])
    trf.update(trf_override or {})
    model = spec.model(cfg, trf)
    query = port.entry(model, device)
    hk = cell.make_hooks(trace=False)
    out = []
    try:
        query(spec.query_seed(0, 1, 0))
        for i, seed in enumerate(seeds):
            qs = spec.query_seed(seed, 0, 0)
            hk.capturing = True
            rows = query(qs)
            hk.capturing = False
            tc, fin = check.program_outputs(hk.captured)
            t0 = time.perf_counter()
            ref = reference.query(model, qs, device)
            rec = dict(seed=seed, reference_s=time.perf_counter() - t0, program=check.gaps(rows, tc, fin, ref))
            del tc, fin
            check.free(hk.captured)
            if i < n_control:
                low = reference.query(model, qs, device, dtype=torch.bfloat16)
                rec["control"] = check.gaps(low["rows"], (low["T"], low["C"]), low["fin"], ref)
                del low
            del ref
            out.append(rec)
    finally:
        hk.uninstall()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    recs = readings(args.workload, seeds, args.control, "cuda")
    for r in recs:
        print(json.dumps(r), flush=True)
    from bench import check

    summary = {k: dict(lower=max(r["program"][k] for r in recs),
                       upper=min((r["control"][k] for r in recs if "control" in r), default=None))
               for k in check.NUMBERS}
    print(json.dumps(dict(workload=args.workload, seeds=len(recs), summary=summary)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
