#!/usr/bin/env python3
"""The dry-run's full-size prefill_32k and decode_32k cells on one pod (16
x 16 ranks) as a markdown table: each cell's record under build/dryrun/
through `repro_torch.launch.roofline`, beside the bytes of the inputs a
rank holds under the reference's own specs.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --shape prefill_32k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --shape decode_32k --mesh single
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/dryrun_serve_table.py

The reference's column: its plan's inputs (parameters; the batch, or the
cache and the tokens) at `jax.eval_shape`'s shapes, each leaf's bytes
over the mesh axes `repro.launch.sharding.resolve_spec` gives it under the
train rules (the reference's `plan_prefill` and `plan_decode` defaults).
Nothing is compiled: the reference's own dry-run compiles each cell for
256 host devices.  Its decode position, a 4-byte scalar, is left out (the
port's is a Python int).  A few seconds a cell.
"""

from __future__ import annotations

import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SHAPES = ("prefill_32k", "decode_32k")


class _Pod:  # the production mesh's names and sizes, for the reference's rules
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


def reference_argument_bytes(arch: str, shape_name: str) -> int:
    import jax
    import numpy as np

    from repro.configs import get_config
    from repro.launch import sharding as shd
    from repro.launch.shapes import SHAPES as JSHAPES
    from repro.launch.shapes import input_specs
    from repro.models.lm import build_model

    cfg, mesh = get_config(arch), _Pod()
    rules = shd.rules_train(mesh)
    model = build_model(cfg)
    params, specs = model.init(jax.random.PRNGKey(0), abstract=True)
    inputs = input_specs(cfg, JSHAPES[shape_name])

    def leaf_bytes(axes, arr) -> int:
        spec = shd.resolve_spec(axes, arr.shape, mesh, rules)
        div = math.prod(shd._axes_size(mesh, p) for p in spec if p is not None)
        return math.prod(arr.shape) * np.dtype(arr.dtype).itemsize // div

    def tree_bytes(axes, tree) -> int:
        is_axes = lambda x: isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)
        return sum(jax.tree.leaves(jax.tree.map(leaf_bytes, axes, tree, is_leaf=is_axes)))

    total = tree_bytes(specs, params)
    if "cache" in inputs:
        total += tree_bytes(model.cache_axes(inputs["cache"]), inputs["cache"])
        inputs = {"tokens": inputs["tokens"]}
    bd = rules["batch"]
    for arr in inputs.values():
        total += leaf_bytes((("batch",) if arr.shape[0] % shd._axes_size(mesh, bd) == 0 else (None,))
                            + (None,) * (len(arr.shape) - 1), arr)
    return total


def rows() -> list[str]:
    from repro_torch.configs import ARCH_IDS
    from repro_torch.launch.roofline import RESULTS_DIR, analyze_cell

    out = []
    for shape in SHAPES:
        for arch in ARCH_IDS:
            path = RESULTS_DIR / f"{arch}__{shape}__single.json"
            if not path.exists():
                out.append(f"| {arch} | {shape} | not traced |")
                continue
            rec = json.loads(path.read_text())
            if rec.get("status") != "OK":
                out.append(f"| {arch} | {shape} | {rec.get('status')} |")
                continue
            r = analyze_cell(rec)
            coll = ", ".join(f"{k} {v:.3g}" for k, v in sorted(rec["collectives"].items()))
            big = rec["largest_output"]
            mem = rec["memory"]
            out.append(
                f"| {arch} | {shape} | {rec['compile_s']} | {r['flops_per_dev']:.3g} | {rec['bytes_adjusted']:.3g} "
                f"| {mem['argument_size_in_bytes']:,} | {reference_argument_bytes(arch, shape):,} "
                f"| {mem['peak_memory_in_bytes']:.3g} | {coll} | `{big['op']}` {tuple(big['shape'])} {big['bytes']:.3g} "
                f"| {r['t_compute_s']:.3g} | {r['t_memory_s']:.3g} | {r['t_collective_s']:.3g} | {r['dominant']} "
                f"| {r['useful_ratio']:.2f} |")
    return out


def main() -> None:
    print("| arch | shape | trace s | FLOPs | result bytes | arg bytes | reference's arg bytes | peak bytes "
          "| collective bytes | largest op result (bytes) | compute s | memory s | coll. s | dominant | useful |")
    print("|" + "---|" * 15)
    print("\n".join(rows()))


if __name__ == "__main__":
    main()
