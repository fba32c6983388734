"""Multi-server Kiefer–Wolfowitz queue recursion: CUDA kernel and plain version.

Replaces the TPU kernel `src/repro/kernels/kw_queue.py::kw_queue` (Pallas
body `_kernel`).  A frontier evaluation runs (grid cells × trials)
independent FIFO G/G/c queues; each is sequential over its jobs, so the
kernel (`csrc/kw_queue.cu`) gives one thread to one queue and keeps the c
slot free times in registers.  Job j takes the lowest-index slot idle at
its arrival, else the lowest-index slot among the earliest-freeing ones;
start = max(a, free), svc = s / speed[slot], finish = start + svc.

Bound on an H100: B·J·24 bytes (25 MB, 7.5 µs at B=512, J=2048), but the
kernel is latency bound by the J dependent steps of each thread and by a
grid of only B threads; `PERF.md` records the gap.

`kw_queue` takes the plain version only for tensors on the CPU.  For a CUDA
tensor it launches the kernel or raises.  `kw_queue.launches` counts the
kernel launches.
"""

from __future__ import annotations

import torch

#: largest slot count the kernel's register array holds
MAX_C = 32


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
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.kw_queue_launch(
        arrivals.data_ptr(), services.data_ptr(), speeds.data_ptr(), B, J, c,
        starts.data_ptr(), fins.data_ptr(), svcs.data_ptr(), slots.data_ptr(),
        stream, dev.index if dev.index is not None else torch.cuda.current_device(),
    )
    if err != 0:
        raise RuntimeError(f"kw_queue: kernel launch failed with CUDA error {err}")
    kw_queue.launches += 1
    return starts, fins, svcs, slots


kw_queue.launches = 0
