"""Roofline analysis over dry-run records, with one NVIDIA H100's constants.

Counterpart of `repro.launch.roofline` (whose constants are a TPU v5e's).
Per (arch x shape x mesh) cell, from the dry-run's per-rank counts
(`launch.dryrun`):

  compute term    = matrix-product FLOPs per rank / 989e12 FLOP/s (bf16)
  memory term     = result bytes per rank (views excluded) / 3.35e12 B/s
  collective term = collective operand bytes per rank / 50e9 B/s

The collective term divides by `NET_BW`, one 400 Gb/s port per GPU: a
16-way mesh axis spans more than one 8-GPU NVLink node (`launch.mesh`).
The dry-run counts each rank's own work, so no term divides by the rank
count.

MODEL_FLOPS uses the standard 6·N·D training estimate (2·N·D forward for
prefill; 2·N_active·B per decoded token), with N_active for MoE.  The ratio
MODEL_FLOPS / (FLOPs per rank x ranks) shows how much traced compute is
useful; replicated work (heads that do not divide the model axis) lowers it.

    PYTHONPATH=src python -m repro_torch.launch.roofline [--markdown]
"""

from __future__ import annotations

import json
from pathlib import Path

from ..configs import get_config
from .mesh import HBM_BW, NET_BW, PEAK_FLOPS_BF16
from .shapes import SHAPES, ShapeSpec

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"

_PARAM_CACHE: dict[str, tuple[int, int]] = {}


def param_counts(arch: str) -> tuple[int, int]:
    """(total, active) parameter counts, cached (an init on the meta
    device, no allocation)."""
    if arch not in _PARAM_CACHE:
        cfg = get_config(arch)
        _PARAM_CACHE[arch] = (cfg.param_count(), cfg.active_param_count())
    return _PARAM_CACHE[arch]


def model_flops(arch: str, shape: str | ShapeSpec) -> float:
    """Useful-compute estimate for the cell (a shape name or a ShapeSpec)."""
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    total, active = param_counts(arch)
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * active * tokens  # fwd + bwd
    if shape.kind == "prefill":
        return 2.0 * active * tokens
    # decode: one token per sequence
    return 2.0 * active * shape.global_batch


def analyze_cell(rec: dict, shape: ShapeSpec | None = None) -> dict:
    """The roofline row of a dry-run record; `shape` for a cell whose shape
    is not one of `SHAPES`."""
    arch, shape_name = rec["arch"], rec["shape"]
    chips = rec["n_devices"]
    flops_dev = rec["cost"].get("flops", 0.0)
    bytes_raw = rec["cost"].get("bytes accessed", 0.0)
    bytes_dev = rec.get("bytes_adjusted", bytes_raw)
    coll_dev = sum(rec.get("collectives", {}).values())

    t_compute = flops_dev / PEAK_FLOPS_BF16
    t_memory = bytes_dev / HBM_BW
    t_collective = coll_dev / NET_BW

    terms = {"compute": t_compute, "memory": t_memory, "collective": t_collective}
    dominant = max(terms, key=terms.get)
    mf = model_flops(arch, shape or shape_name)
    traced_global = flops_dev * chips
    bound = max(terms.values())
    # roofline fraction: useful-FLOPs time at peak vs the dominant term
    t_useful = mf / (chips * PEAK_FLOPS_BF16)
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": rec["mesh"],
        "tag": rec.get("tag", ""),
        "chips": chips,
        "flops_per_dev": flops_dev,
        "bytes_per_dev": bytes_dev,
        "bytes_raw_per_dev": bytes_raw,
        "collective_bytes_per_dev": coll_dev,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
        "dominant": dominant,
        "model_flops": mf,
        "flops_global": traced_global,
        "useful_ratio": mf / traced_global if traced_global else 0.0,
        "roofline_fraction": t_useful / bound if bound > 0 else 0.0,
        "collectives": rec.get("collectives", {}),
    }


def load_all(tag: str = "") -> list[dict]:
    out = []
    for p in sorted(RESULTS_DIR.glob("*.json")):
        rec = json.loads(p.read_text())
        if rec.get("status") != "OK" or rec.get("tag", "") != tag:
            continue
        out.append(analyze_cell(rec))
    return out


def table(rows: list[dict]) -> str:
    hdr = (
        f"{'arch':24s} {'shape':12s} {'mesh':6s} {'comp(s)':>9s} {'mem(s)':>9s} "
        f"{'coll(s)':>9s} {'dom':>5s} {'useful':>7s} {'roofl':>6s}"
    )
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(
            f"{r['arch']:24s} {r['shape']:12s} {r['mesh']:6s} "
            f"{r['t_compute_s']:9.3g} {r['t_memory_s']:9.3g} {r['t_collective_s']:9.3g} "
            f"{r['dominant'][:5]:>5s} {r['useful_ratio']:7.2f} {r['roofline_fraction']:6.3f}"
        )
    return "\n".join(lines)


def markdown_table(rows: list[dict]) -> str:
    lines = [
        "| arch | shape | mesh | compute (s) | memory (s) | collective (s) | dominant | useful ratio | roofline frac |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['t_compute_s']:.3g} "
            f"| {r['t_memory_s']:.3g} | {r['t_collective_s']:.3g} | {r['dominant']} "
            f"| {r['useful_ratio']:.2f} | {r['roofline_fraction']:.4f} |"
        )
    return "\n".join(lines)


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="")
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--markdown", action="store_true")
    args = ap.parse_args()
    rows = load_all(args.tag)
    if args.mesh:
        rows = [r for r in rows if r["mesh"] == args.mesh]
    print(markdown_table(rows) if args.markdown else table(rows))


if __name__ == "__main__":
    main()
