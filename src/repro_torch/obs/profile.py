"""Wall-time / device-time / memory profiling of one call.

Counterpart of `repro.obs.profile`, rewritten for PyTorch.  The reference
lowers and compiles a `jax.jit` function, reads bytes-by-op from its
optimized HLO and asks the executable for its memory footprint.  Eager
PyTorch has no compiled executable to ask, so `kernel_profile` measures
the call itself:

  reference key           here
  ----------------------  ------------------------------------------------
  compile_s               compile_s: the first call (on the card the
                          kernel library's load plus the first launches)
  wall_s, wall_mean_s,    the same: best / mean of `repeats` steady-state
  repeats                 calls, CUDA events on the card, perf_counter on
                          the CPU
  hlo_bytes_total         device_ms_total: device ms summed over the
                          kernels of one call (torch.profiler)
  hlo_bytes_by_op         device_ms_by_kernel: the 10 kernels with the
                          most device ms in that call (on the CPU: the
                          operators with the most self CPU ms)
  temp_bytes,             peak_bytes: `torch.cuda.max_memory_allocated`
  argument_bytes,         over the first and the timed calls (the
  output_bytes,           process's live tensors included); absent on the
  generated_code_bytes    CPU, as the reference leaves the memory keys
                          out where a backend lacks them

The span names (`<name>:compile`, `<name>:exec`), the
`profile.<name>.runs` counter and the registry gauges keep the
reference's names, with `kernel_peak_bytes` in place of
`kernel_temp_bytes`.  Results land in three places at once: returned as a
plain dict, recorded as spans and a counter on a trace recorder (profiler
pid), and gauged into a metrics registry.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from ..device import resolve_device
from .registry import MetricsRegistry
from .trace import NULL_RECORDER, PID_PROFILER, NullRecorder, Recorder

__all__ = ["kernel_profile"]

_TOP_KERNELS = 10


def _device_ms_by_kernel(call, cuda: bool) -> dict:
    """{kernel name: device ms} of one `call()` under torch.profiler: CUDA
    kernels on the card (an aten operator's entry repeats the device time
    of the kernels it launched, so operators are left out), operators'
    self CPU time on the CPU."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        call()
        if cuda:
            torch.cuda.synchronize()

    def us(e):
        if not cuda:
            return e.self_cpu_time_total
        t = getattr(e, "self_device_time_total", None)
        return t if t is not None else getattr(e, "self_cuda_time_total", 0.0)

    out: dict = {}
    for e in prof.key_averages():
        if us(e) > 0 and not (cuda and e.key.startswith("aten::")):
            out[e.key] = out.get(e.key, 0.0) + us(e) / 1e3
    return out


def kernel_profile(
    fn,
    *args,
    name: str = "kernel",
    repeats: int = 3,
    recorder: Recorder | NullRecorder = NULL_RECORDER,
    registry: Optional[MetricsRegistry] = None,
    device=None,
    **kwargs,
) -> dict:
    """Time `fn(*args, **kwargs)` on `device` (None means the card): the
    first call, `repeats` steady-state calls, then one call under
    torch.profiler; returns the profile dict the module docstring lists."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"

    def call():
        return fn(*args, **kwargs)

    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    call()
    if cuda:
        torch.cuda.synchronize(dev)
    compile_s = time.perf_counter() - t0

    times = []
    for _ in range(max(1, repeats)):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            call()
            times.append(time.perf_counter() - t0)
    mem = {"peak_bytes": int(torch.cuda.max_memory_allocated(dev))} if cuda else {}

    by_kernel = _device_ms_by_kernel(call, cuda)
    prof = {
        "name": name,
        "compile_s": compile_s,
        "wall_s": min(times),
        "wall_mean_s": sum(times) / len(times),
        "repeats": len(times),
        "device_ms_total": sum(by_kernel.values()),
        "device_ms_by_kernel": dict(
            sorted(by_kernel.items(), key=lambda kv: -kv[1])[:_TOP_KERNELS]
        ),
        **mem,
    }

    if recorder.enabled:
        wall0 = compile_s  # lay exec spans after the compile span
        recorder.span(f"{name}:compile", "profile", 0.0, compile_s,
                      pid=PID_PROFILER,
                      args={"device_ms_total": prof["device_ms_total"], **mem})
        for i, t in enumerate(times):
            recorder.span(f"{name}:exec", "profile", wall0, t,
                          pid=PID_PROFILER, tid=0, args={"repeat": i})
            wall0 += t
        recorder.count(f"profile.{name}.runs", len(times))
    if registry is not None:
        registry.gauge("kernel_wall_s", {"kernel": name}).set(prof["wall_s"])
        registry.gauge("kernel_compile_s", {"kernel": name}).set(compile_s)
        if "peak_bytes" in mem:
            registry.gauge("kernel_peak_bytes", {"kernel": name}).set(mem["peak_bytes"])
    return prof
