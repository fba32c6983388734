"""Multi-server Kiefer–Wolfowitz queue recursion: CUDA kernel and plain version.

Replaces the TPU kernel `src/repro/kernels/kw_queue.py::kw_queue` (Pallas
body `_kernel`).  A frontier evaluation runs (grid cells × trials)
independent FIFO G/G/c queues.  Job j takes the lowest-index slot idle at
its arrival, else the lowest-index slot among the earliest-freeing ones;
start = max(a, free), svc = s / speed[slot], finish = start + svc.

The kernel (`csrc/kw_queue.cu`) is segment-parallel: its first CUDA kernel
runs every segment of `SEGMENT_JOBS` jobs of every queue at once from all
slots idle (segment 0 from the true start), then re-runs each segment from
its predecessor's speculative end state until the two runs agree; the
second walks each queue's segments in order and re-runs only those whose
predecessor's speculation was wrong.  The result equals the plain version
bit for bit.  Bound on an H100: B·J·24 bytes (25 MB, 7.5 µs at B=512,
J=2048); both kernels are bound by chains of dependent steps, and `PERF.md`
records the gap.

`kw_queue` takes the plain version only for tensors on the CPU.  For a CUDA
tensor it launches the kernel or raises.  `kw_queue.launches` counts the
calls that launch it (two CUDA launches each, one when J <= SEGMENT_JOBS).
"""

from __future__ import annotations

import torch

#: largest slot count the kernel's register array holds
MAX_C = 32
#: jobs per segment of the kernel's first pass (L), the fastest of 32, 64,
#: 128 and 256 on the queues of a full-width `frontier` call (PERF.md)
SEGMENT_JOBS = 256


def kw_queue_plain(arrivals, services, speeds):
    """The recursion in plain PyTorch, one step per job over all queues
    (the semantics of the Pallas body and of `kernels/ref.py::kw_queue_ref`).
    arrivals, services: (B, J); speeds: (c,), sorted descending.  Returns
    (starts, finishes, scaled_services, slots), each (B, J); slots int32."""
    B, J = arrivals.shape
    c = speeds.shape[0]
    dev = arrivals.device
    lane = torch.arange(c, device=dev, dtype=torch.int32).expand(B, c)
    free = torch.zeros((B, c), dtype=arrivals.dtype, device=dev)
    starts = torch.empty_like(arrivals)
    fins = torch.empty_like(arrivals)
    svcs = torch.empty_like(arrivals)
    slots = torch.empty((B, J), dtype=torch.int32, device=dev)
    for j in range(J):
        aj = arrivals[:, j]
        first_idle = torch.where(free <= aj[:, None], lane, c).amin(dim=1)
        min_free = free.amin(dim=1, keepdim=True)
        soonest = torch.where(free == min_free, lane, c).amin(dim=1)
        slot = torch.where(first_idle < c, first_idle, soonest)
        sl = slot.long()
        start = torch.maximum(aj, free.gather(1, sl[:, None])[:, 0])
        svc = services[:, j] / speeds[sl]
        fin = start + svc
        free.scatter_(1, sl[:, None], fin[:, None])
        starts[:, j], fins[:, j], svcs[:, j], slots[:, j] = start, fin, svc, slot
    return starts, fins, svcs, slots


def _check(arrivals, services, speeds):
    for name, t in (("arrivals", arrivals), ("services", services), ("speeds", speeds)):
        if t.dtype != torch.float32:
            raise TypeError(f"kw_queue: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"kw_queue: {name} must be contiguous")
        if t.device != arrivals.device:
            raise ValueError(f"kw_queue: {name} is on {t.device}, arrivals on {arrivals.device}")
    if arrivals.ndim != 2 or services.shape != arrivals.shape:
        raise ValueError(
            f"kw_queue: arrivals and services must be one (B, J) shape, got "
            f"{tuple(arrivals.shape)} and {tuple(services.shape)}"
        )
    if speeds.ndim != 1 or speeds.shape[0] < 1:
        raise ValueError(f"kw_queue: speeds must be (c,) with c >= 1, got {tuple(speeds.shape)}")


def kw_queue(arrivals, services, speeds):
    """Batched G/G/c queues; see `kw_queue_plain` for the contract."""
    _check(arrivals, services, speeds)
    dev = arrivals.device
    if dev.type == "cpu":
        return kw_queue_plain(arrivals, services, speeds)
    if dev.type != "cuda":
        raise ValueError(f"kw_queue: unsupported device {dev}")
    B, J = arrivals.shape
    c = speeds.shape[0]
    if c > MAX_C:
        raise ValueError(f"kw_queue: the kernel holds at most {MAX_C} slots, got c={c}")
    if B * J >= 2**31:
        raise ValueError("kw_queue: B·J must stay below 2**31")
    starts = torch.empty_like(arrivals)
    fins = torch.empty_like(arrivals)
    svcs = torch.empty_like(arrivals)
    slots = torch.empty((B, J), dtype=torch.int32, device=dev)
    if B == 0 or J == 0:
        return starts, fins, svcs, slots
    from .build import load_library

    lib = load_library()
    L = SEGMENT_JOBS
    K = -(-J // L)
    # scratch: end states of the speculative and fixed-up runs; per-segment
    # sorted flags and fix-up records
    scratch = torch.empty((2, B, K, c), dtype=torch.float32, device=dev)
    flags = torch.empty((2, B, K), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.kw_queue_launch(
        arrivals.data_ptr(), services.data_ptr(), speeds.data_ptr(), B, J, c, L,
        scratch.data_ptr(), flags.data_ptr(),
        starts.data_ptr(), fins.data_ptr(), svcs.data_ptr(), slots.data_ptr(),
        stream, dev.index if dev.index is not None else torch.cuda.current_device(),
    )
    if err != 0:
        raise RuntimeError(f"kw_queue: kernel launch failed with CUDA error {err}")
    kw_queue.launches += 1
    return starts, fins, svcs, slots


kw_queue.launches = 0
