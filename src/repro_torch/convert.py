"""Carry the reference's state into the port.

The planner's state is the distribution parameters, the sorted empirical
trace and the lowered policy tensors; the LM's is its parameter tree, and
the trainer's its parameters, AdamW moments and step.
These functions build the port's objects from the reference's numpy arrays
and fields, so a test can feed both packages exactly the same state
(policy-lowering parity and evaluator parity are then tested apart).
"""

from __future__ import annotations

import numpy as np

import torch

from .core import distributions
from .core.policy import MODE_TIME, LoweredPolicies

_FAMILIES = ("ShiftedExp", "Pareto", "Uniform", "Weibull")


def lowered_from_numpy(mode, k, t, r, keep, d, n: int | None = None) -> LoweredPolicies:
    """The port's `LoweredPolicies` from the arrays of a reference one.
    `n` defaults to the widest group (the unrestricted width when any cell
    is unrestricted); the host-side hints are derived as `lower_policies`
    derives them."""
    mode = np.asarray(mode, np.int32)
    k = np.asarray(k, np.int32)
    t = np.asarray(t, np.float32)
    r = np.asarray(r, np.int32)
    keep = np.asarray(keep, bool)
    d = np.asarray(d, np.int32)
    if mode.ndim != 2 or any(a.shape != mode.shape for a in (k, t, r, keep)):
        raise ValueError("mode, k, t, r and keep must share one (cells, stages) shape")
    if d.shape != mode.shape[:1]:
        raise ValueError("d must hold one group width per cell")
    n = int(d.max()) if n is None else int(n)
    return LoweredPolicies(
        n=n,
        n_stages=mode.shape[1],
        mode=mode,
        k=k,
        t=t,
        r=r,
        keep=keep,
        d=d,
        class_names=(None,) * mode.shape[0],
        r_max=int(r.max()),
        multi_stage=mode.shape[1] > 1,
        has_time=bool((mode == MODE_TIME).any()),
        has_group=bool((d != n).any()),
    )


def distribution_from_fields(family: str, **fields):
    """An analytic distribution by its family name and dataclass fields
    (`dataclasses.asdict` of a reference one), or `Empirical` from
    `samples=`."""
    if family == "Empirical":
        return empirical_from_numpy(np.sort(np.asarray(fields["samples"])))
    if family not in _FAMILIES:
        raise ValueError(f"unknown distribution family {family!r}")
    return getattr(distributions, family)(**{k: float(v) for k, v in fields.items()})


def empirical_from_numpy(sorted_samples) -> distributions.Empirical:
    """`Empirical` over an already sorted trace (the reference's `.sorted`)."""
    xs = np.asarray(sorted_samples)
    if xs.ndim != 1 or np.any(np.diff(xs) < 0):
        raise ValueError("empirical_from_numpy expects a sorted 1-D array")
    return distributions.Empirical(xs)


#: the reference's kernel route names that differ in the port
_IMPLS = {"pallas": "kernel"}


def impl_from_reference(name: str) -> str:
    """The port's name for a reference `attn_impl` / `ssm_impl`: "pallas"
    becomes "kernel", the others keep their names."""
    return _IMPLS.get(name, name)


def model_params_from_reference(params, cfg, device, dtype=None) -> dict:
    """The port's parameters from the reference's parameter tree, its
    leaves given as numpy arrays: `top`, `shared_attn` and `extra` key for
    key, and the stacked (L, ...) arrays of `layers` and `enc_layers` as
    one dict per layer.  Each tensor takes the dtype the port's own init
    gives it (`cfg.param_dtype`; float32 for the SSM's A_log, dt_bias and D
    and the MoE router), or `dtype` where one is given (the optimizer's
    float32 moments, which share the parameters' tree)."""
    from .models.lm import build_model

    like = build_model(cfg).init(device="meta")
    if set(params) != set(like):
        raise ValueError(f"sub-trees {sorted(params)} are not {sorted(like)}")

    def carry(arrays, shapes, where):
        if set(arrays) != set(shapes):
            raise ValueError(f"{where}: keys {sorted(arrays)} are not {sorted(shapes)}")
        out = {}
        for k, want in shapes.items():
            t = torch.from_numpy(np.array(arrays[k], dtype=np.float32))
            if tuple(t.shape) != tuple(want.shape):
                raise ValueError(f"{where}/{k}: shape {tuple(t.shape)}, expected {tuple(want.shape)}")
            out[k] = t.to(device=device, dtype=dtype or want.dtype)
        return out

    out = {}
    for name, shapes in like.items():
        if isinstance(shapes, dict):
            out[name] = carry(params[name], shapes, name)
            continue
        n_layers = len(shapes)
        if any(np.shape(v)[0] != n_layers for v in params[name].values()):
            raise ValueError(f"{name}: every stacked array must lead with {n_layers} layers")
        out[name] = [
            carry({k: v[i] for k, v in params[name].items()}, shapes[i], f"{name}[{i}]")
            for i in range(n_layers)
        ]
    return out


def train_state_from_reference(state, cfg, device) -> dict:
    """The port's trainer state from the reference's `{"params", "opt":
    {"m", "v"}, "step"}` (launch/train.py's), its leaves given as numpy
    arrays (a checkpoint of `repro.checkpoint.save` read with numpy, say):
    the parameters as `model_params_from_reference` carries them, the
    moments m and v in float32 on the same tree, and `step` an int32
    scalar."""
    return {
        "params": model_params_from_reference(state["params"], cfg, device),
        "opt": {k: model_params_from_reference(state["opt"][k], cfg, device, dtype=torch.float32)
                for k in ("m", "v")},
        "step": torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32, device=device),
    }
