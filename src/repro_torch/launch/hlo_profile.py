"""Byte profile by op of one dry-run step (no real hardware).

Counterpart of `repro.launch.hlo_profile`, with aten ops in place of HLO
ops: result bytes by op over one step of the plan traced on meta shards
over a fake process group (`launch.dryrun`), this rank's local ops only,
views excluded.  Eager tracing runs every layer, so there is no scan
factor to apply.

    PYTHONPATH=src python -m repro_torch.launch.hlo_profile --arch deepseek-v2-236b \\
        --shape train_4k --top 25
"""

from __future__ import annotations

import argparse


def profile_ops(fn, *inputs) -> dict:
    """Result bytes by aten op of `fn(*inputs)` (DTensors or plain tensors),
    counted on the local tensors (`dryrun.LocalCost`)."""
    from .dryrun import LocalCost

    with LocalCost() as cost:
        fn(*inputs)
    return dict(cost.bytes_by_op)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--serve-rules", default="train")
    args = ap.parse_args()

    from . import sharding as shd
    from .dryrun import cell_config
    from .mesh import fake_world, make_production_mesh
    from .shapes import SHAPES
    from .steps import plan_decode, plan_prefill, plan_train

    cfg = cell_config(args.arch)
    shape = SHAPES[args.shape]
    multi = args.mesh == "multi"
    with fake_world(512 if multi else 256):
        mesh = make_production_mesh(multi_pod=multi)
        rules = shd.rules_serve_stationary(mesh) if args.serve_rules == "stationary" else None
        if shape.kind == "train":
            fn, in_pl, _, inputs = plan_train(cfg, shape, mesh, remat=args.remat)
        elif shape.kind == "prefill":
            fn, in_pl, _, inputs = plan_prefill(cfg, shape, mesh, rules=rules)
        else:
            fn, in_pl, _, inputs = plan_decode(cfg, shape, mesh, rules=rules)
        agg = profile_ops(fn, *shd.distribute(inputs, in_pl, mesh))
    total_b = sum(agg.values())
    print(f"{'op':24s} {'GB':>12s} {'share':>7s}")
    for op, b in sorted(agg.items(), key=lambda kv: -kv[1])[: args.top]:
        print(f"{op:24s} {b/1e9:12.1f} {b/total_b:7.1%}")
    print(f"{'TOTAL':24s} {total_b/1e9:12.1f}")


if __name__ == "__main__":
    main()
