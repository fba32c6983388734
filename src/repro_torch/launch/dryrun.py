"""Multi-pod dry-run: trace every (arch x shape x mesh) cell's step once on
meta shards over a fake process group of 256 or 512 ranks, and record
each rank's memory, FLOPs, bytes and collective bytes.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k --mesh multi

Counterpart of `repro.launch.dryrun`, which lowers and compiles each cell
for 512 forced host devices.  Here `launch.mesh.fake_world` stands for
the ranks, the meta device for the data (nothing is allocated or
computed), and the plan's step runs once, eagerly, on DTensors whose
local shards are meta tensors.  (Not `FakeTensorMode`: DTensor's own
sharding propagation makes small tensors and reads them back, which a
fake mode refuses.)  Its records keep the reference's keys:

  status, n_devices
  lower_s    seconds to build the plan and distribute its meta inputs
  compile_s  seconds to trace the step (no compiler runs: eager tracing)
  memory     argument_size_in_bytes (this rank's shards of the inputs),
             output_size_in_bytes, peak_memory_in_bytes (the most bytes of
             local tensors alive at once during the step, arguments
             included)
  cost       "flops": this rank's matrix-product FLOPs, counted with
             `torch.utils.flop_counter`'s formulas on the local shards,
             replicated work included (a `FlopCounterMode` over the
             DTensors would count global shapes); "bytes accessed": the
             bytes every local op reads and writes
  collectives   operand bytes of each `_c10d_functional` op DTensor
             issues, by the reference's names (all-gather, all-reduce,
             reduce-scatter, all-to-all; and broadcast)
  bytes_by_op   result bytes by aten op, the 12 largest
  largest_output   the largest single result of an op but a view: its
             bytes, op and local shape
  global_logits_ops   for a train cell, the ops whose result has the
             global logits' shape (batch, seq, padded vocabulary): a rank
             that builds one holds every rank's logits
  whole_table_ops   the ops whose result has the embedding table's
             global shape (padded vocabulary, d_model): a rank that builds
             one holds the whole table (the train plan gathers it; the
             prefill and decode plans keep it on its vocabulary shards)
  global_expert_ops   for a MoE config, the ops whose result has the
             global shape of a layer's dispatch buffer (E + 1, C, d) or of
             every expert's outputs (E, C, d): a rank that builds one
             holds every expert's slots
  bytes_adjusted   result bytes of every op but views (the roofline's
             memory term)
  collective_shapes   [collective, mesh dim, input shape, result shape,
             calls] for each distinct collective
  bmm_shapes   [shape a, shape b, calls] for each distinct local `bmm`

The counts come from a dispatch mode below DTensor (`LocalCost`): it
lets DTensor's ops through and counts the ops on local tensors that
DTensor issues for them, but not the ops DTensor runs on fake tensors of
the global shape to infer its outputs' shapes.  There is no loop-body
correction: eager tracing runs every layer, where the reference's HLO
cost analysis counts a scan body once and corrects by re-lowering with
unroll=2, so the reference's `scan_sites` has no counterpart.

The plans use the reference's dry-run routes: attention "chunked" and
the SSM "jnp" (the CUDA kernels take raw pointers, not DTensors, and
refuse both).  Results go under build/dryrun/; reruns skip completed
cells (--force recomputes).
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
import weakref
from collections import defaultdict
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import ARCH_IDS, get_config
from ..models.moe import capacity
from . import sharding as shd
from .mesh import fake_world, make_production_mesh
from .shapes import SHAPES, ShapeSpec, applicability
from .steps import plan_decode, plan_prefill, plan_train

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"

#: `_c10d_functional` ops by the reference's (HLO) collective names
COLLECTIVE_NAMES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class LocalCost(TorchDispatchMode):
    """Counts one rank's work: every op on plain (local) tensors, which
    is what DTensor issues for its own ops.  A DTensor op is returned
    `NotImplemented`, so DTensor runs it and the mode sees its local ops."""

    def __init__(self, live_args=(), watch=None, axes=None):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_formulas = flop_registry
        self.flops = 0
        self.bytes_accessed = 0
        self.bytes_by_op: dict = defaultdict(int)
        self.collectives: dict = defaultdict(int)
        self.n_collectives = 0
        self.largest = dict(bytes=0, op=None, shape=None)
        # name -> shape, and name -> {op: results of that shape}
        self.watch = {name: tuple(shape) for name, shape in (watch or {}).items()}
        self.watched: dict = {name: defaultdict(int) for name in self.watch}
        self.axes = axes or {}  # process group name -> mesh dim name
        self.collective_shapes: dict = defaultdict(int)  # (collective, axis, in, out) -> calls
        self.bmm_shapes: dict = defaultdict(int)  # (shape a, shape b) -> calls
        self.live = 0
        self.peak = 0
        self._storages: dict = {}  # storage id -> [bytes, tensors alive]
        for t in live_args:
            self._track(t)

    def _track(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        key = storage._cdata
        entry = self._storages.get(key)
        if entry is None:
            entry = self._storages[key] = [storage.nbytes(), 0]
            self.live += entry[0]
            self.peak = max(self.peak, self.live)
        entry[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key) -> None:
        entry = self._storages[key]
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._storages[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types) or any(
                isinstance(m, FakeTensorMode) for m in _get_current_dispatch_mode_stack()):
            return out  # DTensor's shape inference on fake tensors: no rank's work
        name = func.overloadpacket.__name__
        ins = list(_tensors((args, kwargs)))
        outs = list(_tensors(out))
        if func.namespace == "_c10d_functional" and name in COLLECTIVE_NAMES:
            self.collectives[COLLECTIVE_NAMES[name]] += sum(_nbytes(t) for t in ins)
            self.n_collectives += 1
            group = next((a for a in reversed(args) if isinstance(a, str)), None)
            self.collective_shapes[(COLLECTIVE_NAMES[name], self.axes.get(group, group),
                                    tuple(ins[0].shape), tuple(outs[0].shape))] += 1
        if name == "bmm":
            self.bmm_shapes[tuple(tuple(t.shape) for t in ins[:2])] += 1
        formula = self._flop_formulas.get(func.overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if not (func.is_view or name in ("detach", "alias", "wait_tensor")):
            result = sum(_nbytes(t) for t in outs)
            self.bytes_by_op[name] += result
            for t in outs:
                if _nbytes(t) > self.largest["bytes"]:
                    self.largest = dict(bytes=_nbytes(t), op=name, shape=list(t.shape))
                for key, shape in self.watch.items():
                    if tuple(t.shape) == shape:
                        self.watched[key][name] += 1
            self.bytes_accessed += result + sum(_nbytes(t) for t in ins)
        for t in outs:
            self._track(t)
        return out


def _local_tensors(tree):
    from torch.distributed.tensor import DTensor

    return [t.to_local() if isinstance(t, DTensor) else t for t in _tensors(tree)]


def trace_cell(cfg, shape: ShapeSpec, mesh, remat: str = "none", rules=None, pin_cache: bool = False) -> dict:
    """The plan's step for `shape` traced once on DTensors of meta shards
    over `mesh` (a mesh of a fake world): this rank's memory, cost and
    collectives, as the reference's record keys."""
    t0 = time.perf_counter()
    if shape.kind == "train":
        fn, in_pl, _, inputs = plan_train(cfg, shape, mesh, remat=remat)
    elif shape.kind == "prefill":
        fn, in_pl, _, inputs = plan_prefill(cfg, shape, mesh, rules=rules)
    else:
        fn, in_pl, _, inputs = plan_decode(cfg, shape, mesh, rules=rules, pin_cache=pin_cache)
    args = shd.distribute(inputs, in_pl, mesh)
    t_lower = time.perf_counter() - t0
    t0 = time.perf_counter()
    watch = {"whole_table": (cfg.padded_vocab, cfg.d_model)}
    if shape.kind == "train":
        watch["global_logits"] = (shape.global_batch, shape.seq_len, cfg.padded_vocab)
    if cfg.moe is not None:
        seq = 1 if shape.kind == "decode" else shape.seq_len
        cap = capacity(cfg.moe, shape.global_batch * seq, seq)
        watch["expert_buffer"] = (cfg.moe.n_experts + 1, cap, cfg.d_model)
        watch["expert_outputs"] = (cfg.moe.n_experts, cap, cfg.d_model)
    axes = {m.get_group(i).group_name: dim for m in (mesh, shd.dtensor_mesh(mesh))
            for i, dim in enumerate(m.mesh_dim_names)}
    with LocalCost(_local_tensors(args), watch=watch, axes=axes) as cost:
        out = fn(*args)
    t_trace = time.perf_counter() - t0
    arg_bytes = shd.local_bytes(args)
    out_bytes = shd.local_bytes(out)
    adjusted = sum(cost.bytes_by_op.values())
    top = sorted(cost.bytes_by_op.items(), key=lambda kv: -kv[1])[:12]
    return dict(
        n_devices=mesh.size(),
        lower_s=round(t_lower, 2),
        compile_s=round(t_trace, 2),
        memory=dict(argument_size_in_bytes=arg_bytes, output_size_in_bytes=out_bytes,
                    peak_memory_in_bytes=cost.peak),
        cost={"flops": float(cost.flops), "bytes accessed": float(cost.bytes_accessed)},
        collectives=dict(cost.collectives),
        n_collectives=cost.n_collectives,
        bytes_by_op=dict(top),
        bytes_adjusted=int(adjusted),
        largest_output=cost.largest,
        global_logits_ops=dict(cost.watched.get("global_logits", {})),
        whole_table_ops=dict(cost.watched["whole_table"]),
        global_expert_ops={op: n for k in ("expert_buffer", "expert_outputs") for op, n in cost.watched.get(k, {}).items()},
        collective_shapes=[[*k, n] for k, n in cost.collective_shapes.items()],
        bmm_shapes=[[*k, n] for k, n in cost.bmm_shapes.items()],
    )


def cell_config(arch: str, moe_impl=None, mla_decode_impl=None, capacity_factor=None, ssm_chunk=None):
    """The config of a dry-run cell: the reference's dry-run routes
    (attention "chunked", SSM "jnp") and the §Perf knobs."""
    import dataclasses as _dc

    cfg = get_config(arch).replace(attn_impl="chunked", ssm_impl="jnp")
    if moe_impl:
        cfg = cfg.replace(moe_impl=moe_impl)
    if mla_decode_impl:
        cfg = cfg.replace(mla_decode_impl=mla_decode_impl)
    if capacity_factor is not None and cfg.moe is not None:
        cfg = cfg.replace(moe=_dc.replace(cfg.moe, capacity_factor=capacity_factor))
    if ssm_chunk is not None and cfg.ssm is not None:
        cfg = cfg.replace(ssm=_dc.replace(cfg.ssm, chunk=ssm_chunk))
    return cfg


def run_cell(arch: str, shape_name: str, mesh_kind: str, remat: str = "none",
             serve_rules: str = "train", moe_impl: str | None = None,
             mla_decode_impl: str | None = None, pin_cache: bool = False,
             capacity_factor: float | None = None, ssm_chunk: int | None = None,
             tag: str = "") -> dict:
    cfg = cell_config(arch, moe_impl, mla_decode_impl, capacity_factor, ssm_chunk)
    shape = SHAPES[shape_name]
    ok, reason = applicability(cfg, shape)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind, "tag": tag,
        "remat": remat, "serve_rules": serve_rules,
    }
    if not ok:
        rec.update(status="SKIP", reason=reason)
        return rec

    multi = mesh_kind == "multi"
    with fake_world(512 if multi else 256):
        mesh = make_production_mesh(multi_pod=multi)
        rules = None
        if shape.kind != "train" and serve_rules == "stationary":
            rules = shd.rules_serve_stationary(mesh)
        rec.update(status="OK", **trace_cell(cfg, shape, mesh, remat=remat, rules=rules, pin_cache=pin_cache))
    return rec


def _cell_path(arch, shape, mesh_kind, tag="") -> Path:
    suffix = f"__{tag}" if tag else ""
    return RESULTS_DIR / f"{arch}__{shape}__{mesh_kind}{suffix}.json"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS), default=None)
    ap.add_argument("--shape", choices=list(SHAPES), default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--remat", default="none", choices=["none", "full", "dots"])
    ap.add_argument("--serve-rules", default="train", choices=["train", "stationary"])
    ap.add_argument("--moe-impl", default=None, choices=[None, "gather", "dense"])
    ap.add_argument("--mla-decode-impl", default=None, choices=[None, "naive", "absorbed"])
    ap.add_argument("--pin-decode-cache", action="store_true")
    ap.add_argument("--capacity-factor", type=float, default=None)
    ap.add_argument("--ssm-chunk", type=int, default=None)
    ap.add_argument("--tag", default="", help="variant tag for §Perf iterations")
    args = ap.parse_args()

    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    n_ok = n_skip = n_fail = n_cached = 0
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                path = _cell_path(arch, shape, mesh_kind, args.tag)
                if path.exists() and not args.force:
                    prev = json.loads(path.read_text())
                    if prev.get("status") in ("OK", "SKIP"):
                        n_cached += 1
                        continue
                try:
                    rec = run_cell(
                        arch, shape, mesh_kind, remat=args.remat,
                        serve_rules=args.serve_rules, moe_impl=args.moe_impl,
                        mla_decode_impl=args.mla_decode_impl,
                        pin_cache=args.pin_decode_cache,
                        capacity_factor=args.capacity_factor,
                        ssm_chunk=args.ssm_chunk, tag=args.tag,
                    )
                except Exception as e:  # a failure here is a sharding bug
                    rec = {
                        "arch": arch, "shape": shape, "mesh": mesh_kind,
                        "tag": args.tag, "status": "FAIL",
                        "error": f"{type(e).__name__}: {e}",
                        "traceback": traceback.format_exc()[-2000:],
                    }
                path.write_text(json.dumps(rec, indent=1))
                st = rec["status"]
                n_ok += st == "OK"
                n_skip += st == "SKIP"
                n_fail += st == "FAIL"
                extra = ""
                if st == "OK":
                    fl = rec["cost"].get("flops", 0)
                    extra = f"flops={fl:.3e} trace={rec['compile_s']}s"
                elif st == "FAIL":
                    extra = rec["error"][:140]
                print(f"[{st}] {arch} x {shape} x {mesh_kind} {extra}", flush=True)
    print(f"done: ok={n_ok} skip={n_skip} fail={n_fail} cached={n_cached}")


if __name__ == "__main__":
    main()
