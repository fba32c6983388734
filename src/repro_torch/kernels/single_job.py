"""The single-job evaluator's laws on shared draws: CUDA kernel and plain version.

Replaces no TPU kernel: the JAX package evaluates a chunk of single-job
laws with XLA-fused vmaps (`repro.fleet.vector`, `repro.core.simulate`).
The port's plain version is the chain of PyTorch operations it ran before
this kernel: `fleet.vector._masked_cells` for the single-fork program on
sorted draws (`ranked`), `core.simulate.lowered_eval_cells` for the lowered
algebra.  Those chains make dozens of passes over (laws, trials, jobs, n)
blocks, with int64 argsorts, gathers and scatters between them.

The kernel (`csrc/single_job.cu`) gives each (trial, job) row one block,
which evaluates every law of the chunk on it: the row's times are staged
in shared memory and, unless `ranked`, sorted once for all the laws where
they are shared (a stable block radix sort, ties in task order as
`torch.argsort(stable=True)` breaks them); each law's later stages sort its
current finishes again; with group selection (d < n) each order is sorted
once more, stably, by group, and each group keeps its own fork instant; a
stage with no stragglers (mode -1, or k >= d) is skipped; the cohorts are a
bit mask a task.  It writes one (T, C) a law.  T equals the chain's bit for
bit; C is a sum in another order (double inside the block, one float32
rounding), within float32 rounding of it.

Bound on an H100: x read once, and of cm the 32-byte sectors that hold a
column some law reads at a straggler's position (`chip_smoke.py`'s
`single_job_bytes`; PERF.md gives them at the benchmark's grids).  The
order statistics that the chains spent their passes on stay in shared
memory (14 + 4·S bytes a task), and the fresh columns a law reads come from
L1 and L2 after the first law of a block.

`single_job` takes the plain version only for tensors on the CPU.  For
CUDA tensors it launches the kernel or raises; `single_job.launches`
counts the launches.  `fits(n, n_stages)` says which sizes it takes:
1..`MAX_TASKS` tasks and 1..`MAX_STAGES` stages, at any group width.
"""

from __future__ import annotations

import math

import torch

#: the most tasks a row, and stages a law, the kernel takes
MAX_TASKS = 4096
MAX_STAGES = 8


def fits(n: int, n_stages: int) -> bool:
    """Whether the kernel takes rows of n tasks under laws of n_stages stages."""
    return 1 <= n <= MAX_TASKS and 1 <= n_stages <= MAX_STAGES


def single_job_plain(x, cm, mode, k, t, r, keep, d, ranked=False):
    """The chains the kernel replaces: `_masked_cells` on ranked x where
    every law is one quantile stage at full width (its k, r, keep),
    `lowered_eval_cells` otherwise."""
    from ..core.simulate import _masked_cells, lowered_eval_cells

    if ranked and bool(((mode[:, 0] == 0) & (d == x.shape[-1])).all()):
        return _masked_cells(x, cm[..., 0, :, :], k[:, 0], r[:, 0], keep[:, 0])
    return lowered_eval_cells(x, cm, mode, k, t, r, keep, d)


def _check(x, cm, mode, k, t, r, keep, d, ranked):
    want = {"x": torch.float32, "cm": torch.float32, "mode": torch.int32, "k": torch.int32,
            "t": torch.float32, "r": torch.int32, "keep": torch.bool, "d": torch.int32}
    given = {"x": x, "cm": cm, "mode": mode, "k": k, "t": t, "r": r, "keep": keep, "d": d}
    for name, v in given.items():
        if not torch.is_tensor(v):
            raise TypeError(f"single_job: {name} must be a tensor")
        if v.dtype != want[name]:
            raise TypeError(f"single_job: {name} must be {want[name]}, got {v.dtype}")
        if not v.is_contiguous():
            raise ValueError(f"single_job: {name} must be contiguous")
        if v.device != x.device:
            raise ValueError(f"single_job: {name} is on {v.device}, x on {x.device}")
    if mode.ndim != 2 or mode.shape[0] < 1 or mode.shape[1] < 1:
        raise ValueError(f"single_job: the laws' stages must be (L, S), got {tuple(mode.shape)}")
    for name in ("k", "t", "r", "keep"):
        if given[name].shape != mode.shape:
            raise ValueError(f"single_job: {name} is {tuple(given[name].shape)}, mode {tuple(mode.shape)}")
    L, S = mode.shape
    if d.shape != (L,):
        raise ValueError(f"single_job: d must be ({L},), one width a law, got {tuple(d.shape)}")
    if x.ndim < 2 or cm.ndim != x.ndim + 2:
        raise ValueError(f"single_job: x must be (1 or L, B..., n) and cm (1 or L, B..., S, n, r_cap), "
                         f"got {tuple(x.shape)} and {tuple(cm.shape)}")
    n = x.shape[-1]
    if x.shape[0] not in (1, L) or cm.shape[0] not in (1, L):
        raise ValueError(f"single_job: x and cm lead with 1 or L = {L}, got {x.shape[0]} and {cm.shape[0]}")
    if cm.shape[1:-3] != x.shape[1:-1] or cm.shape[-3:-1] != (S, n) or cm.shape[-1] < 1:
        raise ValueError(f"single_job: cm must be (1 or L, {tuple(x.shape[1:-1])}, {S}, {n}, r_cap), "
                         f"got {tuple(cm.shape)}")
    if ranked and S != 1:
        raise ValueError(f"single_job: ranked input is the single-fork program's, one stage; got S = {S}")


def single_job(x, cm, mode, k, t, r, keep, d, ranked=False):
    """(T, C) of L laws on shared (or per-law) draws, each (L, B...).

    x: (1 or L, B..., n) float32 task times, in ascending order along n
    where `ranked`; cm: (1 or L, B..., S, n, r_cap) float32, the fresh block
    running-min'd over its replica axis, aligned by completion rank; mode,
    k, r (int32), t (float32), keep (bool): the laws' lowered stages, (L,
    S); d (int32, (L,)): each law's group width, a divisor of n (n: no
    group selection).  `ranked` input is the single-fork program's: one
    stage (S = 1)."""
    _check(x, cm, mode, k, t, r, keep, d, ranked)
    dev = x.device
    if dev.type == "cpu":
        return single_job_plain(x, cm, mode, k, t, r, keep, d, ranked)
    if dev.type != "cuda":
        raise ValueError(f"single_job: unsupported device {dev}")
    L, S = mode.shape
    n, r_cap = x.shape[-1], cm.shape[-1]
    if not fits(n, S):
        raise ValueError(f"single_job: the kernel takes 1..{MAX_TASKS} tasks and 1..{MAX_STAGES} stages, "
                         f"got n = {n}, S = {S}")
    batch = tuple(x.shape[1:-1])
    R = math.prod(batch)
    if R >= 2**31:
        raise ValueError("single_job: fewer than 2**31 rows")
    T = torch.empty((L,) + batch, dtype=torch.float32, device=dev)
    C = torch.empty_like(T)
    if R == 0:
        return T, C
    from .build import load_library

    lib = load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.single_job_launch(
        x.data_ptr(), 0 if x.shape[0] == 1 else R * n, cm.data_ptr(),
        0 if cm.shape[0] == 1 else R * S * n * r_cap,
        mode.data_ptr(), k.data_ptr(), t.data_ptr(), r.data_ptr(), keep.data_ptr(), d.data_ptr(),
        L, R, S, n, r_cap, int(ranked), T.data_ptr(), C.data_ptr(),
        stream, dev.index if dev.index is not None else torch.cuda.current_device(),
    )
    if err != 0:
        raise RuntimeError(f"single_job: kernel launch failed with CUDA error {err}")
    single_job.launches += 1
    return T, C


single_job.launches = 0
