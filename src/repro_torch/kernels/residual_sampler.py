"""Residual-replica sampling (Algorithm 1, π_kill): CUDA kernel and plain version.

Replaces the TPU kernel `src/repro/kernels/residual_sampler.py::
residual_sample` (Pallas body `_kernel`).  For uniforms u (M, s, k) and a
sorted trace xs (n,): idx = clip(ceil(u·n) - 1, 0, n - 1), y = min over the
k = r+1 replicas of xs[idx] (eq. (7): F̄_Y = F̄_X^{r+1}), then per row the
max and the sum over s.  The kernel (`csrc/residual_sampler.cu`) keeps xs
in shared memory and reduces each row inside one block.

Bound on an H100: reading u once, M·s·k·4 bytes (40 MB, about 12 µs at
M=32768, s=103, k=3); the kernel is memory bound by design.

`residual_sample` takes the plain version only for tensors on the CPU.
For a CUDA tensor it launches the kernel or raises.
`residual_sample.launches` counts the kernel launches.
"""

from __future__ import annotations

import torch

#: shared memory one block may use on Hopper (227 KB), and the kernel's
#: own static reduction buffers
SMEM_LIMIT = 232448
_STATIC_SMEM = 64
#: resident blocks per SM the launch aims for (128 threads each)
_BLOCKS_PER_SM = 16


def residual_sample_plain(u, xs):
    """Empirical inverse transform, min over replicas, then per-row (max, sum)
    (the semantics of `kernels/ref.py::residual_sample_ref`)."""
    n = xs.shape[0]
    idx = torch.clamp(torch.ceil(u * n).to(torch.int32) - 1, 0, n - 1)
    y = xs[idx].amin(dim=-1)
    return y.amax(dim=-1), y.sum(dim=-1)


def _check(u, xs):
    for name, t in (("u", u), ("xs", xs)):
        if t.dtype != torch.float32:
            raise TypeError(f"residual_sample: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"residual_sample: {name} must be contiguous")
        if t.device != u.device:
            raise ValueError(f"residual_sample: {name} is on {t.device}, u on {u.device}")
    if u.ndim != 3 or min(u.shape) < 1:
        raise ValueError(f"residual_sample: u must be (M, s, k) with s, k >= 1, got {tuple(u.shape)}")
    if xs.ndim != 1 or xs.shape[0] < 1:
        raise ValueError(f"residual_sample: xs must be (n,) with n >= 1, got {tuple(xs.shape)}")


def residual_sample(u, xs):
    """u: (M, s, k) uniforms; xs: (n,) sorted.  Returns (max_y, sum_y), (M,)."""
    _check(u, xs)
    dev = u.device
    if dev.type == "cpu":
        return residual_sample_plain(u, xs)
    if dev.type != "cuda":
        raise ValueError(f"residual_sample: unsupported device {dev}")
    M, s, k = u.shape
    n = xs.shape[0]
    if n * 4 + _STATIC_SMEM > SMEM_LIMIT:
        raise ValueError(f"residual_sample: a trace of n={n} does not fit in shared memory")
    if u.numel() >= 2**31:
        raise ValueError("residual_sample: u must hold fewer than 2**31 values")
    max_y = torch.empty((M,), dtype=torch.float32, device=dev)
    sum_y = torch.empty((M,), dtype=torch.float32, device=dev)
    from .build import load_library

    lib = load_library()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = min(M, sms * _BLOCKS_PER_SM)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.residual_sample_launch(
        u.data_ptr(), xs.data_ptr(), M, s, k, n, max_y.data_ptr(), sum_y.data_ptr(),
        grid, stream, dev.index if dev.index is not None else torch.cuda.current_device(),
    )
    if err != 0:
        raise RuntimeError(f"residual_sample: kernel launch failed with CUDA error {err}")
    residual_sample.launches += 1
    return max_y, sum_y


residual_sample.launches = 0
