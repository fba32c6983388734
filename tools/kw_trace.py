#!/usr/bin/env python3
"""What sets the time of the kw_queue kernel's path "tma", on the card.

    python3 tools/kw_trace.py [B,J,c ...] [--loads 0.7,0.85,1.2]
                              [--segments 12,28,44] [--rounds 4,16]

(default: the main paths' shape classes (512, 2048, 4), (512, 2048, 1),
(144, 600, 2), (96, 384, 3), (232, 192, 3) at loads 0.7, 0.85 and 1.2).
Inputs are `chip_smoke.kw_inputs`'s (services 0.5 + Exp(1), Poisson
arrivals at the load) on speeds (2, 1, 1, 0.5) cut to c, or ones.  One
JSON line a (shape, load): the card; path "two_launch" and path "tma"
at the plan's cut, at each `--segments` (a fixed segment length) and at
each `--rounds` (`kw_queue.TMA_MAX_ROUNDS`), timed in turns on the same
inputs (`chip_smoke.time_turns`, L2 flushed before each call), every output checked bit-equal to
kw_queue_plain first; the byte bound; and from the kernel's own stats
(`kw_queue.launch(..., stats=...)`, at the plan's cut) the launch's span
from the first block's start to the last block's end, the blocks' start
times in µs after the first (quantiles: the waves), and the median and
90th percentile over blocks of each phase in µs (spec: start to the
speculative runs done; rounds; walk; store: the TMA stores issued and
complete), of the rounds run, of the segments re-run in rounds and of the
segments walked.  Only a card runs it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

CLASSES = ((512, 2048, 4), (512, 2048, 1), (144, 600, 2), (96, 384, 3), (232, 192, 3))
SPEEDS = (2.0, 1.0, 1.0, 0.5)


def quantiles(xs, qs=(0.0, 0.25, 0.5, 0.75, 0.9, 1.0)) -> list:
    return [float(np.quantile(xs, q)) for q in qs]


def stats_of(torch, kwk, args, plan) -> dict:
    """The kernel's per-block stats at the plan's cut, summarised."""
    st = torch.zeros((plan.blocks, 8), dtype=torch.int64, device=args[0].device)
    kwk.launch(*args, "tma", stats=st)
    torch.cuda.synchronize()
    st = st.cpu().numpy().astype(np.float64)
    t0 = st[:, 0].min()
    phases = {"spec": st[:, 1] - st[:, 0], "rounds": st[:, 2] - st[:, 1], "walk": st[:, 3] - st[:, 2],
              "store": st[:, 4] - st[:, 3]}
    return dict(
        span_us=(st[:, 4].max() - t0) / 1e3,
        block_starts_us=quantiles((st[:, 0] - t0) / 1e3),
        block_us=quantiles((st[:, 4] - st[:, 0]) / 1e3, (0.5, 0.9)),
        phase_us={k: quantiles(v / 1e3, (0.5, 0.9)) for k, v in phases.items()},
        rounds=quantiles(st[:, 5], (0.5, 0.9, 1.0)),
        reruns=quantiles(st[:, 6], (0.5, 0.9, 1.0)),
        walked=quantiles(st[:, 7], (0.5, 0.9, 1.0)),
    )


def main() -> int:
    import torch

    import chip_smoke
    from repro_torch.kernels import kw_queue as kwk

    ap = argparse.ArgumentParser()
    ap.add_argument("shapes", nargs="*", help="B,J,c")
    ap.add_argument("--loads", default="0.7,0.85,1.2")
    ap.add_argument("--segments", default="", help="fixed segment lengths of path tma, beside the plan's")
    ap.add_argument("--rounds", default="", help="most rounds before the walk, beside the default")
    ap.add_argument("--reps", type=int, default=20)
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        print("kw_trace: no CUDA device; this tool runs on the card only", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = chip_smoke.nvidia_smi()
    shapes = [tuple(int(x) for x in s.split(",")) for s in opt.shapes] or list(CLASSES)
    loads = [float(x) for x in opt.loads.split(",")]
    segments = [int(x) for x in opt.segments.split(",") if x]
    max_rounds = [int(x) for x in opt.rounds.split(",") if x]
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    g = torch.Generator(device=dev).manual_seed(1234)
    default_rounds = kwk.TMA_MAX_ROUNDS
    for B, J, c in shapes:
        for load in loads:
            speeds = list(SPEEDS[:c]) if c <= len(SPEEDS) else [1.0] * c
            args = chip_smoke.kw_inputs(torch, dev, g, B, J, speeds, load)
            want = kwk.kw_queue_plain(*args)
            plan = kwk.tma_plan(B, J, c, kwk.n_sms(dev))
            fns = {"two_launch": lambda: kwk.launch(*args, "two_launch")}
            variants = [(None, default_rounds)] + [(s, default_rounds) for s in segments] + [
                (None, n) for n in max_rounds]
            for seg, rounds in variants:
                name = ("tma" + ("" if seg is None else f" L={seg}")
                        + ("" if rounds == default_rounds else f" rounds={rounds}"))

                def call(seg=seg, rounds=rounds):
                    kwk.TMA_MAX_ROUNDS = rounds
                    return kwk.launch(*args, "tma", seg=seg)

                for a, b in zip(call(), want):
                    if not torch.equal(a, b):
                        raise SystemExit(f"kw_trace: {name} at {(B, J, c)}, load {load}: not bit-equal")
                fns[name] = call
            for a, b in zip(fns["two_launch"](), want):
                if not torch.equal(a, b):
                    raise SystemExit(f"kw_trace: two_launch at {(B, J, c)}, load {load}: not bit-equal")
            ms = chip_smoke.time_turns(torch, fns, opt.reps, dev, flush)
            kwk.TMA_MAX_ROUNDS = default_rounds
            bound_ms, bound_by = chip_smoke.bound(B * J * 24 + c * 4, B * J * (3 + 2 * c))
            print(json.dumps(dict(card=card, B=B, J=J, c=c, load=load, ms=ms, bound_ms=bound_ms, bound_by=bound_by,
                                  plan=dict(L=plan.L, K=plan.K, R=plan.R, blocks=plan.blocks, threads=plan.threads,
                                            smem=plan.smem),
                                  stats=stats_of(torch, kwk, args, plan))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
