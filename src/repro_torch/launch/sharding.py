"""Logical axes -> mesh placements, with divisibility fallback.

Counterpart of `repro.launch.sharding`.  Parameters are declared with
logical axes ('fsdp', 'model', None) by `repro_torch.models.common.Init`;
activations and caches use ('batch', 'heads', ...).  A dim is sharded only
if its size divides the product of the target mesh axes; otherwise it
falls back to replication (this is how gemma's 8 query heads survive a
16-way model axis: the flattened q_dim 2048 shards instead, and the head
dim stays replicated).

Two rule sets:
  * TRAIN: FSDP ('fsdp' -> all batch axes) + TP ('model').
  * SERVE_STATIONARY: weights stationary, 'fsdp' dims replicated, so
    decode never regathers weights.

`resolve_spec` gives the reference's `PartitionSpec` entries as a plain
tuple (None, an axis name, or a tuple of names); `placements` turns that
tuple into one DTensor placement per dim of the mesh the DTensors live on
(`dtensor_mesh`).  On a single-pod mesh that is the mesh itself:
("data", "model") becomes `[Shard(0), Shard(1)]`.  A multi-pod mesh
(pod, data, model) is flattened to its (pod_data, model) view, since every
rule names "pod" and "data" together (the batch and the FSDP dims):
(("pod", "data"), "model") becomes `[Shard(0), Shard(1)]` there, laid out
pod-major as `PartitionSpec(("pod", "data"))` is.  Two reasons: DTensor
gathers a dim sharded over two mesh dims in two collectives, one per
dim, where GSPMD issues one over the 32 ranks; and DTensor's strategy
search grows with the mesh's dims (a reduced model's train step traced
in 8 s over (4, 2) and in minutes over (2, 2, 2) on torch 2.13).

`mesh` is a `DeviceMesh`, or anything with its `mesh_dim_names` and
`shape` (the rules and specs are pure Python).
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence

import torch

from .. import tree as tr

Tree = Any
Spec = tuple


def _sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axes_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = _sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def rules_train(mesh) -> dict:
    bd = ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)
    return {
        "batch": bd,
        "fsdp": bd,
        "model": ("model",),
        "heads": ("model",),
        "vocab": ("model",),
        "layers": None,
    }


def rules_serve_stationary(mesh) -> dict:
    r = rules_train(mesh)
    r["fsdp"] = None  # weights stationary: no per-step regather
    return r


def resolve_spec(axes: Sequence[Optional[str]], shape: Sequence[int], mesh, rules: dict) -> Spec:
    parts = []
    for dim, ax in zip(shape, axes):
        target = rules.get(ax) if ax is not None else None
        if target is None:
            parts.append(None)
            continue
        if isinstance(target, str):
            target = (target,)
        if dim % _axes_size(mesh, target) == 0:
            parts.append(target if len(target) > 1 else target[0])
        else:
            parts.append(None)  # divisibility fallback -> replicate
    return tuple(parts)


POD_DATA = ("pod", "data")


def _dtensor_dim_names(mesh) -> tuple:
    names = tuple(mesh.mesh_dim_names)
    if "pod" not in names:
        return names
    if names[:2] != POD_DATA:
        raise ValueError(f"a multi-pod mesh is (pod, data, ...), got {names}")
    return ("pod_data",) + names[2:]


def dtensor_mesh(mesh):
    """The DeviceMesh that DTensors over `mesh` live on: `mesh` itself, or
    a multi-pod mesh's (pod_data, model) view (pod-major, built once per
    mesh)."""
    if "pod" not in mesh.mesh_dim_names:
        return mesh
    flat = getattr(mesh, "_pod_data_view", None)
    if flat is None:
        from torch.distributed.device_mesh import DeviceMesh

        flat = DeviceMesh(mesh.device_type, mesh.mesh.reshape(-1, *mesh.shape[2:]),
                          mesh_dim_names=_dtensor_dim_names(mesh))
        mesh._pod_data_view = flat
    return flat


def placements(spec: Spec, mesh) -> list:
    """One DTensor placement per dim of `dtensor_mesh(mesh)`: `Shard(d)`
    where tensor dim d is sharded over that mesh dim, else `Replicate()`."""
    from torch.distributed.tensor import Replicate, Shard

    names = _dtensor_dim_names(mesh)
    out = [Replicate() for _ in names]
    for d, part in enumerate(spec):
        if part is None:
            continue
        parts = (part,) if isinstance(part, str) else tuple(part)
        if "pod_data" in names and parts == POD_DATA:
            parts = ("pod_data",)
        for name in parts:
            if name not in names:
                raise ValueError(f"{spec}: mesh axis {name!r} is not a dim of {names}")
            out[names.index(name)] = Shard(d)
    return out


def zip_map(fn, tree: Tree, other: Tree) -> Tree:
    """`fn(leaf, node)` over the tensor leaves of `tree`, with `node` the
    entry of `other` at the same place (an axes tuple or a placements
    list, which are leaves there)."""
    if isinstance(tree, dict):
        if set(tree) != set(other):
            raise ValueError(f"trees of different keys: {sorted(tree)} vs {sorted(other)}")
        return {k: zip_map(fn, tree[k], other[k]) for k in tree}
    if isinstance(tree, (list, tuple)):
        if len(tree) != len(other):
            raise ValueError(f"trees of different lengths: {len(tree)} vs {len(other)}")
        return type(tree)(zip_map(fn, t, o) for t, o in zip(tree, other))
    return fn(tree, other)


def tree_shardings(spec_tree: Tree, shape_tree: Tree, mesh, rules: dict) -> Tree:
    """A logical-axes tree and a tree of tensors of its structure -> a tree
    of placement lists."""
    return zip_map(lambda arr, axes: placements(resolve_spec(axes, arr.shape, mesh, rules), mesh),
                   shape_tree, spec_tree)


def param_shardings(specs: Tree, params: Tree, mesh, rules: dict) -> Tree:
    return tree_shardings(specs, params, mesh, rules)


def batch_sharding(mesh, shape: Sequence[int], rules: dict) -> list:
    """Leading-dim batch sharding with fallback for non-divisible batch."""
    bd = rules["batch"]
    if bd is not None and len(shape) and shape[0] % _axes_size(mesh, bd) == 0:
        return placements((bd if len(bd) > 1 else bd[0],) + (None,) * (len(shape) - 1), mesh)
    return replicated(mesh)


def replicated(mesh) -> list:
    return placements((), mesh)


def distribute(tree: Tree, placements_tree: Tree, mesh) -> Tree:
    """DTensors of `tree`'s tensors (real or meta) on `dtensor_mesh(mesh)`.
    Every rank holds the same full tensors (one seed), so each keeps its
    own shard and nothing is sent."""
    from torch.distributed.tensor import distribute_tensor

    def one(t, pl):
        if not isinstance(t, torch.Tensor):
            return t
        return distribute_tensor(t, dm, pl, src_data_rank=None)

    dm = dtensor_mesh(mesh)
    return zip_map(one, tree, placements_tree)


def local_bytes(tree: Tree) -> int:
    """Bytes of this rank's shards of a tree of DTensors (plain tensors
    count whole)."""
    from torch.distributed.tensor import DTensor

    locals_ = [t.to_local() if isinstance(t, DTensor) else t for t in tr.leaves(tree) if isinstance(t, torch.Tensor)]
    return sum(t.numel() * t.element_size() for t in locals_)
