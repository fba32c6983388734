#!/usr/bin/env python3
"""Run the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

from the root of a checkout, on a machine with one CUDA card and the CUDA
toolkit.  It imports only the port (`src/repro_torch`), never JAX or the
JAX package.  Phases, one JSON line each:

  device    the card (nvidia-smi name, power limit), torch and CUDA versions
  build     nvcc build of every kernel of the path (csrc/*.cu), in seconds
  kernels   each kernel against its plain PyTorch version on the card at the
            main path's shapes, with its time, its bound and the plain time
  frontier  `frontier` on the Job 1 trace at full width: n=1026 tasks,
            c=4 gang blocks, 2048 jobs × 16 trials, 8 policies × 4 loads
  policy_search  the controller's inner loop at the ρ=0.7 load
  trace_kill     `trace_kill_rollout` (π_kill, p=0.1, r=2) on the same trace

With `--profile`, one more `frontier` call runs under torch.profiler
(phase `profile`: device time by kernel, the device's idle share).  Then
the kernel table (`{"kernels": [...]}`), the card's name and power
limit, and last `{"ok": true, "device": {...}}`.  Any failed check raises
and the script exits nonzero without the last line; so does a machine
without a card.  The launch counts in the kernel table come from the main
path only (counters set to 0 just before `frontier`, read after
`trace_kill`); the comparison launches of the kernels phase are not in it.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, FP32 (non-tensor) op/s
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

FULL = dict(
    n=1026, c=4, n_jobs=2048, m_trials=16,
    kw_shape=(512, 2048), residual_shape=(32768, 103, 3),
    kernel_reps=20, plain_reps=3, mc_reps=4000,
)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int, device, flush=None, ahead=False) -> float:
    """Median time of `fn` in ms.  On the card: CUDA events around each
    call; with `ahead`, all calls are enqueued behind a sleep kernel so
    that the host's launch overhead leaves no gaps (for a single kernel;
    a plain version made of many small launches is timed as it runs).
    `flush` (a large buffer) is rewritten before each call so the inputs
    come from device memory, not L2."""
    if device.type != "cuda":
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))
    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    if ahead:
        torch.cuda._sleep(100_000_000)
    for start, end in pairs:
        if flush is not None:
            flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def job1_trace():
    from repro_torch.data.traces import load_trace

    x = load_trace("job1", seed=0)
    return x / np.mean(x)  # mean 1, as fleet.trace_workload normalises


def phase_kernels(torch, device, sizes) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    from repro_torch.kernels.kw_queue import kw_queue, kw_queue_plain
    from repro_torch.kernels.residual_sampler import residual_sample, residual_sample_plain

    g = torch.Generator(device=device).manual_seed(1234)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=device) if device.type == "cuda" else None
    B, J = sizes["kw_shape"]
    kw_cases = []
    for speeds in ([2.0, 1.0, 1.0, 0.5], [1.0]):
        sp = torch.tensor(speeds, device=device)
        services = 0.5 + torch.empty((B, J), device=device).exponential_(generator=g)
        lam = 0.7 * float(sp.sum()) / 1.5  # offered load 0.7 of the slots' speed
        arrivals = torch.cumsum(torch.empty((B, J), device=device).exponential_(generator=g) / lam, dim=1)
        got = kw_queue(arrivals, services, sp)
        want = kw_queue_plain(arrivals, services, sp)
        check(torch.equal(got[3], want[3]), f"kw_queue slots equal (c={len(speeds)})")
        err = 0.0
        for a, b in zip(got[:3], want[:3]):
            check(bool(torch.allclose(a, b, rtol=1e-5, atol=1e-5)), f"kw_queue floats (c={len(speeds)})")
            err = max(err, float((a - b).abs().max()))
        c = len(speeds)
        kw_cases.append(dict(
            B=B, J=J, c=c, max_abs_err=err,
            ms=time_ms(torch, lambda: kw_queue(arrivals, services, sp), sizes["kernel_reps"], device, flush, ahead=True),
            plain_ms=time_ms(torch, lambda: kw_queue_plain(arrivals, services, sp), sizes["plain_reps"], device),
            bound=bound(B * J * 24 + c * 4, B * J * (3 + 2 * c)),
        ))

    M, s, k = sizes["residual_shape"]
    xs = torch.sort(torch.as_tensor(job1_trace(), dtype=torch.float32, device=device)).values
    n = xs.shape[0]
    u = torch.rand((M, s, k), generator=g, device=device)
    mx, sm = residual_sample(u, xs)
    mx_p, sm_p = residual_sample_plain(u, xs)
    check(torch.equal(mx, mx_p), "residual_sample max exact")
    check(bool(torch.allclose(sm, sm_p, rtol=1e-5, atol=0.0)), "residual_sample sum rtol 1e-5")
    res_case = dict(
        M=M, s=s, k=k, n=n,
        max_abs_err=max(float((mx - mx_p).abs().max()), float((sm - sm_p).abs().max())),
        ms=time_ms(torch, lambda: residual_sample(u, xs), sizes["kernel_reps"], device, flush, ahead=True),
        plain_ms=time_ms(torch, lambda: residual_sample_plain(u, xs), sizes["kernel_reps"], device, flush),
        bound=bound(M * s * k * 4 + n * 4 + 2 * M * 4, M * s * (5 * k + 2)),
    )
    for case in (*kw_cases, res_case):
        case["bound_ms"], case["bound_by"] = case.pop("bound")
    emit("kernels", kw_queue=kw_cases, residual_sample=res_case,
         tolerance=dict(kw_queue="slots exact, floats rtol=atol=1e-5",
                        residual_sample="max exact, sum rtol 1e-5"))
    return dict(kw_queue=kw_cases[0] | {"max_abs_err": max(c["max_abs_err"] for c in kw_cases)},
                residual_sample=res_case)


POLICIES = (  # (p, r, keep): baseline, four keep and three kill policies
    (0.0, 0, True), (0.05, 1, True), (0.1, 1, True), (0.2, 1, True), (0.1, 2, True),
    (0.1, 1, False), (0.1, 2, False), (0.2, 1, False),
)
RHOS = (0.3, 0.5, 0.7, 0.85)


def frontier_inputs(sizes) -> dict:
    """The Job 1 trace, the policy grid, and λ = ρ·c / E[T_baseline], where
    E[T_baseline] = E[max of n trace draws] comes from a numpy Monte Carlo
    over the same type-1 gather the engine uses."""
    from repro_torch.core import Empirical, SingleForkPolicy

    n, c = sizes["n"], sizes["c"]
    x = job1_trace()
    emp = Empirical(x)
    xs32 = emp.sorted.numpy()
    rng = np.random.default_rng(7)
    u = rng.random((sizes["mc_reps"], n), dtype=np.float32)
    idx = np.clip(np.ceil(u * xs32.size).astype(np.int64) - 1, 0, xs32.size - 1)
    mx = xs32[idx].max(axis=1).astype(np.float64)
    et = float(mx.mean())
    return dict(
        x=x, emp=emp, et=et, et_sd=float(mx.std()), et_err=float(mx.std()) / math.sqrt(mx.size),
        policies=[SingleForkPolicy(*p) for p in POLICIES], lams=[rho * c / et for rho in RHOS],
    )


def main_path(torch, device, sizes) -> dict:
    """frontier + policy_search + trace_kill_rollout on the Job 1 trace."""
    from repro_torch.core import SingleForkPolicy
    from repro_torch.fleet import vector

    n, c, J, m = sizes["n"], sizes["c"], sizes["n_jobs"], sizes["m_trials"]
    inp = frontier_inputs(sizes)
    x, emp, et, et_sd, et_err = (inp[k] for k in ("x", "emp", "et", "et_sd", "et_err"))
    policies, lams, rhos = inp["policies"], inp["lams"], RHOS

    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rows = vector.frontier(emp, policies, lams, n, J, m_trials=m, c=c, seed=0, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else None
    check(len(rows) == len(policies) * len(lams), "one row per cell")
    for row in rows:
        check(all(math.isfinite(v) for v in row.values() if isinstance(v, float)), f"finite row {row['policy']}")
    base = [r for r in rows if r["policy"] == "baseline"]
    svc_err = et_sd / math.sqrt(m * J)
    for r in base:
        z = abs(r["mean_service"] - et) / math.hypot(et_err, svc_err)
        check(z < 5.0, f"baseline mean_service {r['mean_service']} vs E[max] {et} ({z:.2f} sigma)")
    for i, pol in enumerate(policies):
        soj = [r["mean_sojourn"] for r in rows[i * len(lams):(i + 1) * len(lams)]]
        check(all(a < b for a, b in zip(soj, soj[1:])), f"mean_sojourn rises with lambda for {pol.label()}")
    emit("frontier", cells=len(rows), n=n, c=c, n_jobs=J, m_trials=m, lams=lams,
         e_t_baseline=et, e_t_baseline_stderr=et_err, wall_s=wall, peak_bytes=peak,
         rows=[{k: r[k] for k in ("policy", "lam", "mean_sojourn", "mean_service", "mean_cost", "p99", "rho")} for r in rows])

    lam7 = lams[rhos.index(0.7)]
    t0 = time.perf_counter()
    search = vector.policy_search(emp, policies, lam7, n, n_jobs=J, m_trials=m, c=c, seed=0, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    ps_wall = time.perf_counter() - t0
    best = min(search, key=lambda r: r["mean_sojourn"])
    same = [r for r in rows if r["lam"] == lam7]
    rel = max(abs(a["mean_sojourn"] - b["mean_sojourn"]) / b["mean_sojourn"] for a, b in zip(search, same))
    check(all(math.isfinite(r["mean_sojourn"]) for r in search), "policy_search rows finite")
    emit("policy_search", lam=lam7, wall_s=ps_wall, argmin=best["label"],
         argmin_mean_sojourn=best["mean_sojourn"], max_rel_diff_vs_frontier=rel)

    kill = SingleForkPolicy(0.1, 2, False)
    t0 = time.perf_counter()
    res = vector.trace_kill_rollout(x, kill, lam7, n, J, m_trials=m, c=c, seed=0, device=device)
    summary = res.summary()
    tk_wall = time.perf_counter() - t0
    check(all(math.isfinite(v) for v in summary.values()), "trace_kill summary finite")
    cell = next(r for r in same if r["policy"] == kill.label())
    sd = float(res.service.std())
    z = abs(summary["mean_service"] - cell["mean_service"]) / (sd * math.sqrt(2.0 / (m * J)))
    check(z < 5.0, f"trace_kill mean_service {summary['mean_service']} vs frontier {cell['mean_service']} ({z:.2f} sigma)")
    emit("trace_kill", wall_s=tk_wall, mean_service=summary["mean_service"],
         frontier_mean_service=cell["mean_service"], sigma=z, mean_sojourn=summary["mean_sojourn"])
    return dict(frontier_wall_s=wall, peak_bytes=peak)


def phase_profile(torch, device, sizes) -> None:
    """One full-width `frontier` call under torch.profiler: device time by
    kernel and the device's idle share of the call's wall time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.fleet import vector

    inp = frontier_inputs(sizes)
    args = (inp["emp"], inp["policies"], inp["lams"], sizes["n"], sizes["n_jobs"])
    kw = dict(m_trials=sizes["m_trials"], c=sizes["c"], seed=0, device=device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        vector.frontier(*args, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)

    # kernels only: an aten op's entry repeats the device time of the
    # kernels it launched
    kernels = [e for e in prof.key_averages() if dev_us(e) > 0 and not e.key.startswith("aten::")]
    total_ms = sum(dev_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:12]
    emit("profile", wall_s=wall, device_ms=total_ms,
         idle_share=None if not kernels else 1.0 - total_ms / (wall * 1e3),
         top=[dict(name=e.key[:80], device_ms=dev_us(e) / 1e3, calls=e.count) for e in top])


def run(device_name: str, sizes: dict) -> dict:
    """Every phase but the device line; returns the kernel table."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.kw_queue import kw_queue
    from repro_torch.kernels.residual_sampler import residual_sample

    device = torch.device(device_name)
    if device.type == "cuda":
        t0 = time.perf_counter()
        lib = build.load_library()
        emit("build", seconds=time.perf_counter() - t0, library=Path(lib._name).name,
             sources=[str(p.relative_to(ROOT)) for p in build.sources()], flags=list(build.NVCC_FLAGS))
    measured = phase_kernels(torch, device, sizes)

    kw_queue.launches = 0
    residual_sample.launches = 0
    main_path(torch, device, sizes)
    launches = {"kw_queue": kw_queue.launches, "residual_sample": residual_sample.launches}
    if device.type == "cuda":
        for name, count in launches.items():
            check(count > 0, f"{name} launched on the main path")

    meta = {
        "kw_queue": ("src/repro_torch/csrc/kw_queue.cu", "src/repro/kernels/kw_queue.py:82"),
        "residual_sample": ("src/repro_torch/csrc/residual_sampler.cu", "src/repro/kernels/residual_sampler.py:39"),
    }
    return {"kernels": [
        dict(name=name, route="cuda", source=src, replaces=rep, launches=launches[name],
             max_abs_err=measured[name]["max_abs_err"], ms=measured[name]["ms"],
             plain_ms=measured[name]["plain_ms"], bound_ms=measured[name]["bound_ms"],
             bound_by=measured[name]["bound_by"], library_ms=None)
        for name, (src, rep) in meta.items()
    ]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails here, before any output, outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()
    emit("device", nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda,
         name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         allow_tf32={"matmul": False, "cudnn": False})
    table = run("cuda", FULL)
    if "--profile" in sys.argv[1:]:
        phase_profile(torch, torch.device("cuda"), FULL)
    print(json.dumps(table))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
