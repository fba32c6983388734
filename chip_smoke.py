#!/usr/bin/env python3
"""Run the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

from the root of a checkout, on a machine with one CUDA card and the CUDA
toolkit.  It imports only the port (`src/repro_torch`), never JAX or the
JAX package.  Phases, one JSON line each:

  device    the card (nvidia-smi name, power limit), torch and CUDA versions
  build     nvcc build of every kernel of the path (csrc/*.cu), in seconds
  kernels   each kernel against its plain PyTorch version on the card at the
            main path's shapes, with its time, its bound and the plain time;
            kw_queue at loads 0.7, 0.85 and 1.2 (saturated), c = 4 and 1
  frontier  `frontier` on the Job 1 trace at full width: n=1026 tasks,
            c=4 gang blocks, 2048 jobs × 16 trials, 8 policies × 4 loads
  policy_search  the controller's inner loop at the ρ=0.7 load
  trace_kill     `trace_kill_rollout` (π_kill, p=0.1, r=2) on the same trace
  serve     `repro_torch.launch.serve` at full width: Zamba2-1.2B in bf16
            with seed-0 weights, 2 batches x 8 requests of 1024 prompt
            tokens and 32 new tokens under `HedgedServer(adapt=True)`;
            then, on one request, every kernel call of a prefill against
            its plain version on the same inputs, prefill-then-decode
            consistency, and the prefill's logits with the kernels against
            those with the plain versions (gated in float32)

With `--profile`, one request's prefill and 8 decode steps (phase
`serve_profile`) and one more `frontier` call (phase `profile`) run under
torch.profiler: device time by kernel, the device's idle share.  Then
the kernel table (`{"kernels": [...]}`), the card's name and power
limit, and last `{"ok": true, "device": {...}}`.  Any failed check raises
and the script exits nonzero without the last line; so does a machine
without a card.  The launch counts in the kernel table come from the two
main paths only: kw_queue and residual_sample from the frontier path
(counters set to 0 just before `frontier`, read after `trace_kill`),
flash_attention and ssd_scan from the serve path (set to 0 just before it,
read just after); the comparison launches are not in them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, FP32 (non-tensor)
#: op/s, dense bf16 tensor-core op/s
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

#: (B, S, H, D, causal, dtype) of tests/test_kernels.py's FLASH_CASES and
#: (Bt, S, H, P, G, N, chunk, dtype) of its SSD_CASES
FLASH_CASES = (
    (2, 256, 4, 64, True, "float32"), (1, 512, 2, 128, True, "float32"),
    (2, 200, 4, 64, True, "float32"), (1, 128, 8, 64, False, "float32"),
    (2, 256, 4, 64, True, "bfloat16"), (1, 384, 4, 256, True, "bfloat16"),
    (1, 96, 2, 80, True, "float32"),
)
SSD_CASES = (
    (2, 256, 4, 32, 1, 16, 64, "float32"), (1, 128, 8, 64, 1, 64, 128, "float32"),
    (1, 100, 4, 16, 2, 8, 32, "float32"), (2, 192, 4, 32, 4, 16, 64, "float32"),
    (1, 256, 4, 64, 1, 128, 128, "bfloat16"),
)
#: bf16 shapes of the tensor-core kernels' other paths: ragged, non-causal,
#: D = 80 / 128; G > 1 with a ragged chunk, P = N = 128, one chunk
FLASH_BF16_CASES = (
    (2, 200, 4, 64, True, "bfloat16"), (1, 256, 4, 64, False, "bfloat16"),
    (1, 200, 2, 80, True, "bfloat16"), (2, 320, 2, 128, True, "bfloat16"),
)
SSD_BF16_CASES = (
    (1, 100, 4, 16, 2, 8, 32, "bfloat16"), (1, 300, 2, 128, 1, 128, 128, "bfloat16"),
    (1, 128, 8, 64, 1, 64, 128, "bfloat16"),
)

FULL = dict(
    n=1026, c=4, n_jobs=2048, m_trials=16,
    kw_shape=(512, 2048), kw_loads=(0.7, 0.85, 1.2), residual_shape=(32768, 103, 3),
    kernel_reps=20, plain_reps=3, mc_reps=4000,
    # one Zamba2-1.2B prefill of 1024 tokens: attention (B, S, H, D) and
    # SSM (Bt, S, H, P, G, N, chunk), both bf16
    flash_shape=(1, 1024, 32, 64), ssd_shape=(1, 1024, 64, 64, 1, 64, 128),
    flash_cases=FLASH_CASES + FLASH_BF16_CASES, ssd_cases=SSD_CASES + SSD_BF16_CASES,
    serve=dict(arch="zamba2-1.2b", reduced=False, requests=8, batches=2, prompt=1024, steps=32),
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


def bound(bytes_moved: float, ops: float, ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def job1_trace():
    from repro_torch.data.traces import load_trace

    x = load_trace("job1", seed=0)
    return x / np.mean(x)  # mean 1, as fleet.trace_workload normalises


def kw_inputs(torch, device, g, B, J, speeds, load):
    """(arrivals, services, speeds) of B queues of J jobs at offered `load`
    of the slots' speed: services 0.5 + Exp(1), Poisson arrivals."""
    sp = torch.tensor(speeds, device=device)
    services = 0.5 + torch.empty((B, J), device=device).exponential_(generator=g)
    lam = load * float(sp.sum()) / 1.5
    arrivals = torch.cumsum(torch.empty((B, J), device=device).exponential_(generator=g) / lam, dim=1)
    return arrivals, services, sp


def phase_kernels(torch, device, sizes) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    from repro_torch.kernels.kw_queue import kw_queue, kw_queue_plain
    from repro_torch.kernels.residual_sampler import residual_sample, residual_sample_plain

    g = torch.Generator(device=device).manual_seed(1234)
    # the loads after the first draw from their own generator, so that every
    # later kernel's inputs are those drawn after the first load's queues alone
    g_loads = torch.Generator(device=device).manual_seed(4321)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=device) if device.type == "cuda" else None
    B, J = sizes["kw_shape"]
    kw_cases = []
    for i, load in enumerate(sizes["kw_loads"]):
        for speeds in ([2.0, 1.0, 1.0, 0.5], [1.0]):
            arrivals, services, sp = kw_inputs(torch, device, g if i == 0 else g_loads, B, J, speeds, load)
            c = len(speeds)
            what = f"kw_queue (load {load}, c={c})"
            got = kw_queue(arrivals, services, sp)
            want = kw_queue_plain(arrivals, services, sp)
            check(torch.equal(got[3], want[3]), f"{what} slots equal")
            err = 0.0
            for a, b in zip(got[:3], want[:3]):
                check(bool(torch.allclose(a, b, rtol=1e-5, atol=1e-5)), f"{what} floats")
                err = max(err, float((a - b).abs().max()))
            kw_cases.append(dict(
                B=B, J=J, c=c, load=load, max_abs_err=err,
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
    flash = flash_kernel_cases(torch, device, sizes, g, flush)
    ssd = ssd_kernel_cases(torch, device, sizes, g, flush)
    for case in (*kw_cases, res_case, *flash, *ssd):
        if "bound" in case:
            case["bound_ms"], case["bound_by"] = case.pop("bound")
    emit("kernels", kw_queue=kw_cases, residual_sample=res_case, flash_attention=flash,
         ssd_scan=ssd,
         tolerance=dict(kw_queue="slots exact, floats rtol=atol=1e-5",
                        residual_sample="max exact, sum rtol 1e-5",
                        flash_attention="rtol=atol 2e-5 float32, 2e-2 bfloat16",
                        ssd_scan="rtol=atol 1e-3 float32; atol 2e-1, rtol 5e-2 bfloat16"))
    return dict(kw_queue=kw_cases[0] | {"max_abs_err": max(c["max_abs_err"] for c in kw_cases)},
                residual_sample=res_case, flash_attention=flash[0], ssd_scan=ssd[0])


def _close(torch, got, want, rtol, atol, what) -> float:
    got, want = got.float(), want.float()
    check(bool(torch.isfinite(got).all()), f"{what}: finite")
    check(bool(torch.allclose(got, want, rtol=rtol, atol=atol)), f"{what} within rtol={rtol}, atol={atol}")
    return float((got - want).abs().max())


def flash_kernel_cases(torch, device, sizes, g, flush) -> list:
    """flash_attention against its plain version: the serve shape (first,
    timed, with the bound and scaled_dot_product_attention's time), then
    `sizes["flash_cases"]` (FLASH_CASES and FLASH_BF16_CASES at full size)."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    B, S, H, D = sizes["flash_shape"]
    cases = []
    for i, (b, s, h, d, causal, dt) in enumerate(((B, S, H, D, True, "bfloat16"), *sizes["flash_cases"])):
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn((b, s, h, d), generator=g, device=device).to(dtype) for _ in range(3))
        tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
        err = _close(torch, flash_attention(q, k, v, causal=causal), flash_attention_plain(q, k, v, causal=causal),
                     tol, tol, f"flash_attention {(b, s, h, d, causal, dt)}")
        case = dict(shape=[b, s, h, d], causal=causal, dtype=dt, max_abs_err=err)
        if i == 0:
            elt = q.element_size()
            pairs = s * (s + 1) // 2 if causal else s * s
            case.update(
                ms=time_ms(torch, lambda: flash_attention(q, k, v, causal=causal), sizes["kernel_reps"], device, flush, ahead=True),
                plain_ms=time_ms(torch, lambda: flash_attention_plain(q, k, v, causal=causal), sizes["plain_reps"], device),
                library_ms=time_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=causal),
                    sizes["kernel_reps"], device, flush, ahead=True),
                bound=bound(4 * b * s * h * d * elt, 4 * b * h * d * pairs,
                            BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S),
            )
        cases.append(case)
    return cases


def ssd_kernel_cases(torch, device, sizes, g, flush) -> list:
    """ssd_scan against its plain version: the serve shape (first, timed,
    with the bound and the CUDA launches per call), then
    `sizes["ssd_cases"]` (SSD_CASES and SSD_BF16_CASES at full size)."""
    from repro_torch.kernels.ssd_scan import CUDA_LAUNCHES, ssd_scan, ssd_scan_plain

    cases = []
    for i, (bt, s, h, p, gr, n, q, dt) in enumerate(((*sizes["ssd_shape"], "bfloat16"), *sizes["ssd_cases"])):
        dtype = getattr(torch, dt)
        x = torch.randn((bt, s, h, p), generator=g, device=device).to(dtype)
        dts = torch.nn.functional.softplus(torch.randn((bt, s, h), generator=g, device=device))
        A = -torch.exp(torch.randn((h,), generator=g, device=device) * 0.3)
        Bm = torch.randn((bt, s, gr, n), generator=g, device=device).to(dtype)
        Cm = torch.randn((bt, s, gr, n), generator=g, device=device).to(dtype)
        Dv = torch.ones((h,), device=device)
        args = (x, dts, A, Bm, Cm, Dv)
        rtol, atol = (5e-2, 2e-1) if dtype == torch.bfloat16 else (1e-3, 1e-3)
        what = f"ssd_scan {(bt, s, h, p, gr, n, q, dt)}"
        y, hf = ssd_scan(*args, chunk=q)
        y_p, hf_p = ssd_scan_plain(*args, chunk=q)
        err = max(_close(torch, y, y_p, rtol, atol, what + " y"), _close(torch, hf, hf_p, rtol, atol, what + " h_final"))
        case = dict(shape=[bt, s, h, p, gr, n], chunk=q, dtype=dt, max_abs_err=err)
        if i == 0:
            elt = x.element_size()
            nc = -(-s // q)
            macs = bt * h * nc * (q * (q + 1) // 2 * (n + p) + 2 * q * p * n)
            case.update(
                ms=time_ms(torch, lambda: ssd_scan(*args, chunk=q), sizes["kernel_reps"], device, flush, ahead=True),
                plain_ms=time_ms(torch, lambda: ssd_scan_plain(*args, chunk=q), sizes["plain_reps"], device),
                library_ms=None, cuda_launches_per_call=CUDA_LAUNCHES[dtype],
                bound=bound(2 * bt * s * h * p * elt + 2 * bt * s * gr * n * elt + bt * s * h * 4
                            + 2 * h * 4 + bt * h * p * n * 4, 2 * macs,
                            BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S),
            )
        cases.append(case)
    return cases


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


def profiled(torch, fn, top_n: int = 12, named: tuple = ()) -> dict:
    """`fn()` once under torch.profiler: wall seconds, device ms summed over
    kernels, the device's idle share of the wall time, the top kernels, and
    the device ms and calls of every kernel whose name contains one of
    `named`."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)

    # kernels only: an aten op's entry repeats the device time of the
    # kernels it launched
    kernels = [e for e in prof.key_averages() if dev_us(e) > 0 and not e.key.startswith("aten::")]
    total_ms = sum(dev_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:top_n]
    return dict(wall_s=wall, device_ms=total_ms,
                idle_share=None if not kernels else 1.0 - total_ms / (wall * 1e3),
                launches=sum(e.count for e in kernels),
                top=[dict(name=e.key[:80], device_ms=dev_us(e) / 1e3, calls=e.count) for e in top],
                named=[dict(name=e.key[:80], device_ms=dev_us(e) / 1e3, calls=e.count)
                       for e in kernels if any(k in e.key for k in named)])


def phase_profile(torch, device, sizes) -> None:
    """One full-width `frontier` call under torch.profiler: device time by
    kernel (the KW queue's kernels by name), and the device's idle share of
    the call's wall time."""
    from repro_torch.fleet import vector

    inp = frontier_inputs(sizes)
    args = (inp["emp"], inp["policies"], inp["lams"], sizes["n"], sizes["n_jobs"])
    kw = dict(m_trials=sizes["m_trials"], c=sizes["c"], seed=0, device=device)
    emit("profile", **profiled(torch, lambda: vector.frontier(*args, **kw), named=("kw_",)))


def profile_serving(torch, model, params, tokens, steps: int) -> None:
    """One request's prefill, then `steps` decode steps, each under
    torch.profiler (phase `serve_profile`)."""
    S = tokens.shape[1]
    state = {}

    def prefill():
        logits, cache = model.prefill(params, {"tokens": tokens})
        state["cache"] = model.grow_cache(cache, S + steps)
        state["tok"] = torch.argmax(logits, dim=-1).to(torch.int32)

    def decode():
        for i in range(steps):
            logits, state["cache"] = model.decode_step(params, state["cache"], state["tok"], S + i)
            state["tok"] = torch.argmax(logits, dim=-1).to(torch.int32)

    emit("serve_profile", prefill=profiled(torch, prefill, 16), decode_steps=steps,
         decode=profiled(torch, decode, 16))


@contextlib.contextmanager
def routed_kernels(flash, ssd):
    """The model stack's kernel calls (`kernels.ops.flash_attention`,
    `ssd_scan`) go to `flash` and `ssd` while the block runs."""
    from repro_torch.kernels import ops

    saved = ops.flash_attention, ops.ssd_scan
    ops.flash_attention, ops.ssd_scan = flash, ssd
    try:
        yield
    finally:
        ops.flash_attention, ops.ssd_scan = saved


def checked_kernels(torch, errors: dict):
    """(flash, ssd) that launch the kernel and hold its result against the
    plain version on the same inputs, at the kernel tolerances, keeping
    the largest error of each."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain

    def flash(q, k, v, *, causal=True):
        out = flash_attention(q, k, v, causal=causal)
        tol = 2e-2 if q.dtype == torch.bfloat16 else 2e-5
        err = _close(torch, out, flash_attention_plain(q, k, v, causal=causal), tol, tol,
                     f"flash_attention on the prefill's inputs {tuple(q.shape)}")
        errors["flash_attention"] = max(errors.get("flash_attention", 0.0), err)
        return out

    def ssd(x, dt, A, B, C, D, *, chunk=128):
        y, h = ssd_scan(x, dt, A, B, C, D, chunk=chunk)
        y_p, h_p = ssd_scan_plain(x, dt, A, B, C, D, chunk=chunk)
        rtol, atol = (5e-2, 2e-1) if x.dtype == torch.bfloat16 else (1e-3, 1e-3)
        what = f"ssd_scan on the prefill's inputs {tuple(x.shape)}"
        err = max(_close(torch, y, y_p, rtol, atol, what + " y"), _close(torch, h, h_p, rtol, atol, what + " h"))
        errors["ssd_scan"] = max(errors.get("ssd_scan", 0.0), err)
        return y, h

    return flash, ssd


def _rel_err(torch, got, ref) -> float:
    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max() / ref.abs().max())


def prefill_checks(torch, model, params, tokens) -> dict:
    """One request's prefill with the kernels against the same prefill with
    their plain versions; prefill(S - 1) + decode_step against prefill(S)
    at the last position; and, for scale, the plain prefill against itself
    with the embedding table times (1 + eps·u), u ~ N(0, 1), eps the
    dtype's machine epsilon: max|Δ| / max|ref| each."""
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.ssd_scan import ssd_scan_plain

    S = tokens.shape[1]
    logits_k, _ = model.prefill(params, {"tokens": tokens})
    emb = params["top"]["embed"]
    g = torch.Generator(device=emb.device).manual_seed(7)
    noise = torch.finfo(emb.dtype).eps * torch.randn(emb.shape, generator=g, device=emb.device)
    nudged = {**params, "top": {**params["top"], "embed": (emb.float() * (1 + noise)).to(emb.dtype)}}
    del noise
    with routed_kernels(flash_attention_plain, ssd_scan_plain):
        logits_p, _ = model.prefill(params, {"tokens": tokens})
        logits_n, _ = model.prefill(nudged, {"tokens": tokens})
    del nudged
    _, cache = model.prefill(params, {"tokens": tokens[:, :-1]})
    logits_d, _ = model.decode_step(params, model.grow_cache(cache, S), tokens[:, -1], S - 1)
    return dict(kernels_vs_plain=_rel_err(torch, logits_k, logits_p),
                decode_vs_prefill=_rel_err(torch, logits_d, logits_k),
                plain_vs_plain_eps_embed=_rel_err(torch, logits_n, logits_p))


def phase_serve(torch, device, sizes, profile: bool = False) -> dict:
    """`repro_torch.launch.serve` as a user runs it, with the counters of
    its kernels set to 0 just before and read just after; then checks on
    one request's prefill.

    Prefill then decode is held to 0.05 in bfloat16, as served, and in
    float32 on the same weights cast up exactly.  The prefill's logits
    with the kernels against those with the plain versions are held to
    2e-2 in float32 only: through 38 random-weight layers the model in
    bfloat16 turns changes of a rounding into logit differences of 10-50%
    (PERF.md), so the bfloat16 number is reported, and in
    bfloat16 every kernel call of the prefill is held instead against its
    plain version on the same inputs, at the kernel tolerances."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.lm import build_model

    sv = sizes["serve"]
    argv = ["--arch", sv["arch"], "--requests", str(sv["requests"]), "--batches", str(sv["batches"]),
            "--prompt", str(sv["prompt"]), "--steps", str(sv["steps"]), "--seed", "0",
            "--device", str(device)] + (["--reduced"] if sv["reduced"] else [])
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ops.flash_attention.launches = 0
    ops.ssd_scan.launches = 0
    t0 = time.perf_counter()
    res = serve.run(serve.parse_args(argv), log=lambda line: emit("serve_log", line=line))
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": ops.flash_attention.launches, "ssd_scan": ops.ssd_scan.launches}
    peak = torch.cuda.max_memory_allocated() if cuda else None

    model, params, cfg = res.model, res.params, res.model.config
    served = sv["requests"] * sv["batches"]
    steps = sv["steps"]
    check(all(len(o) == steps for outs in res.outputs for o in outs), f"every request returned {steps} tokens")
    check(len(res.prefill_s) == served, f"{served} requests served")
    check(res.logits_finite, "every logit finite")
    if cuda:
        want = {"flash_attention": len(model._hybrid_segments()) * served, "ssd_scan": cfg.n_layers * served}
        check(launches == want, f"kernel launches on the serve path {launches} == {want}")

    tokens = torch.as_tensor(res.requests[0], dtype=torch.int32, device=device)[None, :]
    errors: dict = {}
    with routed_kernels(*checked_kernels(torch, errors)):
        model.prefill(params, {"tokens": tokens})
    bf16 = prefill_checks(torch, model, params, tokens)
    cfg32 = cfg.replace(param_dtype=torch.float32)
    params32 = {
        "top": {k: v.float() for k, v in params["top"].items()},
        "layers": [{k: v.float() for k, v in lp.items()} for lp in params["layers"]],
        **({"shared_attn": {k: v.float() for k, v in params["shared_attn"].items()}} if "shared_attn" in params else {}),
    }
    f32 = prefill_checks(torch, build_model(cfg32), params32, tokens)
    del params32
    if profile:
        profile_serving(torch, model, params, tokens, steps=8)
    check(f32["kernels_vs_plain"] < 2e-2, f"float32 prefill logits, kernels vs plain: {f32['kernels_vs_plain']:.3g} < 2e-2")
    for name, got in (("bfloat16", bf16), ("float32", f32)):
        check(got["decode_vs_prefill"] < 0.05,
              f"{name} prefill(S-1) + decode_step vs prefill(S): {got['decode_vs_prefill']:.3g} < 0.05")

    prefill_ms = [t * 1e3 for t in res.prefill_s]
    decode_ms_tok = [t * 1e3 / (steps - 1) for t in res.decode_s]
    emit("serve", arch=cfg.arch_id, params=cfg.param_count(), dtype=str(cfg.param_dtype),
         requests=served, prompt=sv["prompt"], steps=steps, wall_s=wall,
         prefill_ms=dict(first=prefill_ms[0], median=float(np.median(prefill_ms[1:] or prefill_ms))),
         decode_ms_per_token=dict(first=decode_ms_tok[0], median=float(np.median(decode_ms_tok[1:] or decode_ms_tok))),
         prefill_tokens_per_s=sv["prompt"] * served / sum(res.prefill_s),
         decode_tokens_per_s=(steps - 1) * served / sum(res.decode_s),
         tokens_per_s=steps * served / wall, peak_bytes=peak, launches=launches,
         batches=[dataclasses.asdict(st) for st in res.stats],
         final_policy=res.stats[-1].policy, controller_policy=res.server.controller.current_policy().label(),
         kernel_calls_vs_plain_max_abs_err=errors, bfloat16=bf16, float32=f32)
    return launches


def run(device_name: str, sizes: dict, profile: bool = False) -> dict:
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
    launches.update(phase_serve(torch, device, sizes, profile))
    if device.type == "cuda":
        for name, count in launches.items():
            check(count > 0, f"{name} launched on its main path")

    meta = {
        "kw_queue": ("src/repro_torch/csrc/kw_queue.cu", "src/repro/kernels/kw_queue.py:82"),
        "residual_sample": ("src/repro_torch/csrc/residual_sampler.cu", "src/repro/kernels/residual_sampler.py:39"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu", "src/repro/kernels/flash_attention.py:85"),
        "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu", "src/repro/kernels/ssd_scan.py:82"),
    }
    return {"kernels": [
        dict(name=name, route="cuda", source=src, replaces=rep, launches=launches[name],
             max_abs_err=measured[name]["max_abs_err"], ms=measured[name]["ms"],
             plain_ms=measured[name]["plain_ms"], bound_ms=measured[name]["bound_ms"],
             bound_by=measured[name]["bound_by"], library_ms=measured[name].get("library_ms"))
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
    profile = "--profile" in sys.argv[1:]
    table = run("cuda", FULL, profile)
    if profile:
        phase_profile(torch, torch.device("cuda"), FULL)
    print(json.dumps(table))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
