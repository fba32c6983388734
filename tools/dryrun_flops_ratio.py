#!/usr/bin/env python3
"""Per-rank FLOPs against an even 8-way split of the unsharded step, for
the reduced configs on the two 8-rank test meshes (2 x 4 and 2 x 2 x 2),
in the port or in the reference.  The mini dry-run of
tests/test_torch_sharding.py traces the same cells.

    PYTHONPATH=src python tools/dryrun_flops_ratio.py --package torch
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/dryrun_flops_ratio.py --package jax

Cells: vocab 512, seq 32, batch 8, kinds train and prefill.  The ratio is
8 x a rank's FLOPs / the unsharded step's FLOPs: 1.0 is an even split,
above it is work that several ranks repeat.
- torch: `launch.dryrun.trace_cell` inside `mesh.fake_world(8)` (matrix
  products on the local shards, `torch.utils.flop_counter`'s formulas),
  against a `FlopCounterMode` over the unsharded step on meta tensors.
- jax: XLA's cost analysis of the reference's plan compiled for 8 forced
  host devices, against the same step compiled for one device (XLA counts
  elementwise work too; a scan body counts once in both).
Prints one JSON object: {"<arch>/<kind>/<mesh>": ratio}.  A minute or two
a package on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

ARCHS = ("deepseek-v2-236b", "moonshot-v1-16b-a3b", "qwen3-32b", "zamba2-1.2b")
KINDS = ("train", "prefill")
MESHES = {"2x4": False, "2x2x2": True}


def torch_ratios(archs) -> dict:
    import torch
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_reduced
    from repro_torch.launch import dryrun, shapes, steps
    from repro_torch.launch.mesh import fake_world, make_test_mesh
    from repro_torch.models.lm import build_model
    from repro_torch.optim import AdamWConfig

    torch.set_num_threads(1)
    out = {}
    for arch in archs:
        cfg = get_reduced(arch).replace(vocab=512, attn_impl="chunked", ssm_impl="jnp")
        for kind in KINDS:
            shape = shapes.ShapeSpec("t", 32, 8, kind)
            batch = shapes.input_specs(cfg, shape)
            with FlopCounterMode(display=False) as counter:
                if kind == "train":
                    state, _ = steps.abstract_state(cfg)
                    steps.make_train_step(cfg, AdamWConfig())(state, batch)
                else:
                    steps.make_prefill_step(cfg)(build_model(cfg).init(device="meta"), batch)
            whole = counter.get_total_flops()
            for name, multi in MESHES.items():
                with fake_world(8):
                    rec = dryrun.trace_cell(cfg, shape, make_test_mesh(multi_pod=multi))
                assert not dist.is_initialized()
                out[f"{arch}/{kind}/{name}"] = rec["cost"]["flops"] * 8 / whole
    return out


def jax_ratios(archs) -> dict:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax

    from repro.configs import get_reduced
    from repro.launch.mesh import make_test_mesh
    from repro.launch.shapes import ShapeSpec
    from repro.launch.steps import plan_prefill, plan_train

    def flops(compiled) -> float:
        ca = compiled.cost_analysis()
        return float((ca[0] if isinstance(ca, (list, tuple)) else ca)["flops"])

    out = {}
    for arch in archs:
        cfg = get_reduced(arch).replace(vocab=512)
        for kind in KINDS:
            shape = ShapeSpec("t", seq_len=32, global_batch=8, kind=kind)
            plan = plan_train if kind == "train" else plan_prefill
            fn, _, _, inputs = plan(cfg, shape, make_test_mesh())
            whole = flops(jax.jit(fn).lower(*inputs).compile())
            for name, multi in MESHES.items():
                fn, in_sh, out_sh, inputs = plan(cfg, shape, make_test_mesh(multi_pod=multi))
                c = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh).lower(*inputs).compile()
                out[f"{arch}/{kind}/{name}"] = flops(c) * 8 / whole
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("torch", "jax"), required=True)
    ap.add_argument("--arch", action="append", help="default: " + ", ".join(ARCHS))
    args = ap.parse_args()
    archs = tuple(args.arch or ARCHS)
    print(json.dumps(torch_ratios(archs) if args.package == "torch" else jax_ratios(archs)))


if __name__ == "__main__":
    main()
