"""Atomic checkpointing.

Layout:  <dir>/step_<N>/manifest.json + arrays.npz
Writes go to a tmp dir and are renamed into place (atomic on POSIX), so a
crash mid-save never corrupts the latest checkpoint — the restart path
(`latest_step`) only ever sees fully-renamed directories.  Retention keeps
the newest `keep` checkpoints.

Counterpart of `repro.checkpoint.checkpoint`, with its on-disk layout: the
arrays keyed by `jax.tree_util.keystr`-style paths (`repro_torch.tree`:
`['params']['layers'][0]['attn/wq']`), dtype names and shapes in the
manifest.  numpy has no bfloat16 or float8, so those leaves are stored as
their raw bits (uint16, uint8) under their own dtype names, as the
reference stores them, and read back through torch views.

`restore` targets a `like` tree: each value is loaded by its path and put
on `device` (None means the card) in the dtype of `like`'s leaf.  `like`
may live on the meta device: only its structure and dtypes are read.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from .. import tree as tr
from ..device import resolve_device

PyTree = Any

_STEP_RE = re.compile(r"^step_(\d+)$")

# npz cannot store bfloat16 or float8; round-trip them as raw bits: name ->
# (torch dtype, torch and numpy dtypes of its bits, numpy dtype stored)
_BITCAST = {
    "bfloat16": (torch.bfloat16, torch.int16, np.int16, np.uint16),
    "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8, np.uint8, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, torch.uint8, np.uint8, np.uint8),
}
_NAMES = {spec[0]: name for name, spec in _BITCAST.items()}


def _to_storage(leaf: torch.Tensor) -> tuple[str, np.ndarray]:
    """(dtype name, numpy array to store) of one tensor."""
    t = leaf.detach().cpu()
    name = _NAMES.get(t.dtype)
    if name is None:
        arr = t.numpy()
        return str(arr.dtype), arr
    _, bits, _, stored = _BITCAST[name]
    return name, t.contiguous().view(bits).numpy().view(stored)


def _from_storage(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name in _BITCAST:
        dtype, _, bits, _ = _BITCAST[dtype_name]
        return torch.from_numpy(arr.view(bits)).view(dtype)
    return torch.from_numpy(arr)


def save(directory: str | os.PathLike, state: PyTree, step: int, keep: int = 3) -> Path:
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step}"
    tmp = directory / f".tmp_step_{step}_{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    arrays = {}
    manifest = {"step": step, "time": time.time(), "keys": [], "dtypes": {}, "shapes": {}}
    for key, leaf in tr.leaves_with_path(state):
        name, arr = _to_storage(leaf)
        manifest["keys"].append(key)
        manifest["dtypes"][key] = name
        manifest["shapes"][key] = list(arr.shape)
        arrays[key] = arr
    np.savez(tmp / "arrays.npz", **arrays)
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic publish

    # retention
    steps = sorted(all_steps(directory))
    for old in steps[:-keep]:
        shutil.rmtree(directory / f"step_{old}", ignore_errors=True)
    return final


def all_steps(directory: str | os.PathLike) -> list[int]:
    directory = Path(directory)
    if not directory.exists():
        return []
    out = []
    for p in directory.iterdir():
        m = _STEP_RE.match(p.name)
        if m and (p / "manifest.json").exists():
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(directory: str | os.PathLike) -> int | None:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def restore(directory: str | os.PathLike, like: PyTree, step: int | None = None, device=None) -> PyTree:
    dev = resolve_device(device)
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = directory / f"step_{step}"
    manifest = json.loads((path / "manifest.json").read_text())
    out = []
    with np.load(path / "arrays.npz") as data:
        for key, leaf in tr.leaves_with_path(like):
            if key not in manifest["dtypes"]:
                raise KeyError(f"checkpoint {path} missing key {key}")
            value = _from_storage(data[key], manifest["dtypes"][key])
            out.append(value.to(device=dev, dtype=leaf.dtype))
    return tr.unflatten(like, out)
