"""Carry the reference's state into the port.

The system has no weights: its state is the distribution parameters, the
sorted empirical trace and the lowered policy tensors.  These functions
build the port's objects from the reference's numpy arrays and fields, so
a test can feed both packages exactly the same state (policy-lowering
parity and evaluator parity are then tested apart).
"""

from __future__ import annotations

import numpy as np

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
