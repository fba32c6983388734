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
  frontier_hist  `frontier(tail="hist")` on the frontier's grid: p50 and p99
            against the exact rows and the order statistics next to the rank
  dag       `dag_frontier` at full width: a map → shuffle → reduce pipeline
            on the three stage traces (1026, 488 and 485 tasks, c=4 gang
            blocks each), 2048 jobs × 16 trials, 8 per-stage policy vectors
            × 4 loads; then each stage's kw_queue call on its own inputs
            (the sorted barrier releases) against kw_queue_plain
  dag_one_stage  the map stage alone against `frontier`, bit for bit
  dag_hist  `tail="hist"` against the exact rows and `dag_rollout`'s paths
  dag_search     `exhaustive_search` (27 vectors) against `coordinate_search`
  dag_general    a `delayed_relaunch` vector (the lowered evaluator), and
  dag_fault      `FaultSpec` q = 0 and 0.05 (the retry draws), at full width
  dag_event the port's event engine (`DagFleetSim`, host) against
            `dag_frontier` (card) on the two-stage grid of the reference's
            benchmarks/bench_dag.py: within 5σ on E[T], 0.1 on E[C]
  serve     `repro_torch.launch.serve` at full width: Zamba2-1.2B in bf16
            with seed-0 weights, 2 batches x 8 requests of 1024 prompt
            tokens and 32 new tokens under `HedgedServer(adapt=True)`;
            then, on one request, every kernel call of a prefill against
            its plain version on the same inputs, prefill-then-decode
            consistency, and the prefill's logits with the kernels against
            those with the plain versions (gated in float32)

With `--profile`, one request's prefill and 8 decode steps (phase
`serve_profile`), one more `frontier` call (phase `profile`), one more
full-width `dag_frontier` call (phase `dag_profile`) and the fault grid of
`dag_fault` (phase `dag_fault_profile`) run under torch.profiler: device
time by kernel, the device's idle share.  Then the kernel table
(`{"kernels": [...]}`), the card's name and power limit, and last
`{"ok": true, "device": {...}}`.  Any failed check raises
and the script exits nonzero without the last line; so does a machine
without a card.  The launch counts in the kernel table come from the three
main paths only: kw_queue and residual_sample from the frontier path
(counters set to 0 just before `frontier`, read after `frontier_hist`)
plus kw_queue from the DAG path (set to 0 just before `dag`, read after
`dag_event`), flash_attention and ssd_scan from the serve path (set to 0
just before it, read just after).  The calls made only to compare with
them (the kernels against their plain versions, the reference `frontier`
of `dag_one_stage`, the rollouts that give the order statistics, the
single-fork grid of `dag_general`) run under `uncounted` and are not in
the counts.
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
    # the map → shuffle → reduce pipeline: (stage trace, tasks), c gang blocks
    # each; the event oracle's grid is benchmarks/bench_dag.py's
    dag=dict(stages=(("map", 1026), ("shuffle", 488), ("reduce", 485)), c=4,
             n_jobs=2048, m_trials=16, event_jobs=400, event_trials=12),
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


@contextlib.contextmanager
def uncounted():
    """Launches of the block leave the kernels' launch counters as they
    were: for calls made only to compare a path with its reference."""
    from repro_torch.kernels.kw_queue import kw_queue
    from repro_torch.kernels.residual_sampler import residual_sample

    saved = kw_queue.launches, residual_sample.launches
    try:
        yield
    finally:
        kw_queue.launches, residual_sample.launches = saved


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

    # tail="hist" on the same grid; the order statistics of the ρ = 0.7
    # cells come from a one-stage DAG's rollout, whose paths are the
    # frontier cell's (the one-stage contract)
    from repro_torch.dag import JobDAG, StageSpec, dag_rollout

    t0 = time.perf_counter()
    hist = vector.frontier(emp, policies, lams, n, J, m_trials=m, c=c, seed=0, tail="hist", device=device)
    _sync(torch, device)
    hist_wall = time.perf_counter() - t0
    one = JobDAG([StageSpec("map", n, x, c=c)])
    r_cap = max(p.r for p in policies) + 1
    with uncounted():
        paths = [dag_rollout(one, lam7, J, m, policies=(pol,), seed=0, r_caps=(r_cap,), device=device)
                 for pol in policies]
    devs = hist_checks("frontier", hist, rows, [i * len(lams) + rhos.index(0.7) for i in range(len(policies))], paths)
    emit("frontier_hist", wall_s=hist_wall, exact_wall_s=wall, cells_with_order_stats=len(paths), **devs,
         evt_p999=[r["evt_p999"] for r in hist], p999=[r["p999"] for r in hist])
    return dict(frontier_wall_s=wall, peak_bytes=peak)


def hist_checks(what, hist_rows, exact_rows, cells, paths, rel_acc=None) -> dict:
    """`tail="hist"` rows against the exact rows of the same grid and seed.

    For each cell index in `cells`, with that cell's `dag_rollout` paths
    (the same draws as the grid's cell): the sketch's p_q reads the order
    statistic x_(k), k = floor(q·(N-1)), within rel_acc, and the exact
    row's p_q (`np.percentile`, linear) lies between x_(k) and x_(k+1); so
    they may differ by rel_acc·x_(k+1) plus the gap x_(k+1) - x_(k).  The
    cost_p50 and cost_p99 keys are held the same way to the order
    statistics of the cell's per-job cost, and the evt_* keys must be
    those refitted from the histogram of the cell's own sojourns, within
    rtol 1e-6.  Every row's tail keys must be finite."""
    from repro_torch.obs import DEFAULT_HIST, device_histogram, evt_keys, sketch_from_device

    rel_acc = DEFAULT_HIST.rel_acc if rel_acc is None else rel_acc
    for h in hist_rows:
        check(all(math.isfinite(h[k]) for k in ("p50", "p99", "p999", "cost_p50", "cost_p99")),
              f"{what} hist row finite")

    def order_stats(z, q):
        xs = np.sort(z.cpu().numpy().ravel())
        k = int(math.floor(q * (xs.size - 1)))
        return float(xs[k]), float(xs[min(k + 1, xs.size - 1)])

    worst = {}
    for q, key in ((0.5, "p50"), (0.99, "p99")):
        worst[key] = max(abs(h[key] - e[key]) / e[key] for h, e in zip(hist_rows, exact_rows))
        worst["cost_" + key] = 0.0
        for i, res in zip(cells, paths):
            lo, hi = order_stats(res.sojourn, q)
            h, e = hist_rows[i][key], exact_rows[i][key]
            check(lo * (1 - 1e-6) <= e <= hi * (1 + 1e-6), f"{what} cell {i}: exact {key} {e} within [{lo}, {hi}]")
            check(abs(h - e) <= rel_acc * hi + (hi - lo),
                  f"{what} cell {i}: hist {key} {h} vs exact {e} (rel_acc {rel_acc}, gap {hi - lo})")
            lo, hi = order_stats(res.total_cost, q)
            h = hist_rows[i]["cost_" + key]
            check(abs(h - lo) <= rel_acc * hi + (hi - lo),
                  f"{what} cell {i}: hist cost_{key} {h} vs order statistic {lo} (rel_acc {rel_acc}, gap {hi - lo})")
            worst["cost_" + key] = max(worst["cost_" + key], abs(h - lo) / lo)
    evt_dev = 0.0
    for i, res in zip(cells, paths):
        own = evt_keys(sketch_from_device(*(z.cpu().numpy() for z in device_histogram(res.sojourn))))
        for k, v in own.items():
            evt_dev = max(evt_dev, abs(hist_rows[i][k] - v) / abs(v))
    check(evt_dev <= 1e-6, f"{what}: evt keys refitted from the cells' own sojourns ({evt_dev:.3g})")
    return {**{f"max_rel_dev_{k}": v for k, v in worst.items()}, "max_rel_dev_evt_vs_own_sojourns": evt_dev}


#: per-stage candidates of the DAG phase: baseline, π_keep(0.1, 1),
#: π_kill(0.1, 1), π_keep(0.1, 2); the vectors index them per stage
DAG_CANDIDATES = ((0.0, 0, True), (0.1, 1, True), (0.1, 1, False), (0.1, 2, True))
DAG_VECTORS = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0), (1, 1, 1), (2, 2, 0), (3, 3, 0), (3, 3, 3))
#: benchmarks/bench_dag.py's grid for the event oracle: ShiftedExp(1, 1) map
#: of 8 tasks, ShiftedExp(0.5, 2) reduce of 4, c = 2 and 2, its 4 vectors
#: (p, r, keep) per stage, three loads
EVENT_VECTORS = (
    ((0.0, 0, True), (0.0, 0, True)), ((0.2, 1, True), (0.0, 0, True)),
    ((0.2, 1, True), (0.25, 1, True)), ((0.25, 1, False), (0.25, 1, True)),
)
EVENT_LAMS = (0.2, 0.3, 0.4)


def dag_inputs(sizes) -> dict:
    """The pipeline map → shuffle → reduce on the stage traces (mean 1),
    its policy vectors, and λ = ρ·c / max_s E[T_s], so that the baseline's
    bottleneck stage stands at each ρ; E[T_s] = E[max of n_s trace draws]
    by a numpy Monte Carlo over the engine's type-1 gather, as
    `frontier_inputs` does."""
    from repro_torch.core import Empirical, SingleForkPolicy
    from repro_torch.dag import JobDAG, StageSpec
    from repro_torch.data.traces import load_stage_trace

    d = sizes["dag"]
    c = d["c"]
    rng = np.random.default_rng(7)
    stages, et = [], []
    for name, n in d["stages"]:
        x = load_stage_trace(name)
        xs32 = Empirical(x).sorted.numpy()
        u = rng.random((sizes["mc_reps"], n), dtype=np.float32)
        idx = np.clip(np.ceil(u * xs32.size).astype(np.int64) - 1, 0, xs32.size - 1)
        et.append(float(xs32[idx].max(axis=1).astype(np.float64).mean()))
        stages.append(StageSpec(name, n, x, c=c))
    cands = [SingleForkPolicy(*p) for p in DAG_CANDIDATES]
    vectors = [tuple(cands[i] for i in v) for v in DAG_VECTORS]
    return dict(dag=JobDAG.pipeline(stages), et=et, cands=cands, vectors=vectors,
                lams=[rho * c / max(et) for rho in RHOS])


@contextlib.contextmanager
def captured_queue_calls(log: list):
    """While the block runs, every call of the fused engines' KW queue
    (`fleet.vector.batched_queue` → the kw_queue wrapper) appends its
    (arrivals, services, speeds) to `log`, then runs as it would."""
    from repro_torch.fleet import vector

    inner = vector.kw_queue_kernel

    def recorded(arrivals, services, speeds):
        log.append((arrivals, services, speeds))
        return inner(arrivals, services, speeds)

    vector.kw_queue_kernel = recorded
    try:
        yield
    finally:
        vector.kw_queue_kernel = inner


def stage_queue_checks(torch, calls) -> list:
    """Each stage's kw_queue call on the inputs the DAG gave it (barrier
    releases sorted stably, gang makespans in that order) against
    kw_queue_plain on the same tensors: slots equal, floats within
    rtol = atol = 1e-5 as in phase `kernels`."""
    from repro_torch.kernels.kw_queue import kw_queue, kw_queue_plain

    out = []
    with uncounted():
        for s, (arrivals, services, speeds) in enumerate(calls):
            what = f"kw_queue on the DAG's stage call {s} {tuple(arrivals.shape)}"
            check(bool((arrivals[:, 1:] >= arrivals[:, :-1]).all()), f"{what}: rows in FIFO order")
            got, want = kw_queue(arrivals, services, speeds), kw_queue_plain(arrivals, services, speeds)
            check(torch.equal(got[3], want[3]), f"{what}: slots equal")
            err = 0.0
            for a, b in zip(got[:3], want[:3]):
                check(bool(torch.allclose(a, b, rtol=1e-5, atol=1e-5)), f"{what}: floats")
                err = max(err, float((a - b).abs().max()))
            out.append(dict(rows=list(arrivals.shape), c=int(speeds.shape[0]), max_abs_err=err))
    return out


def _sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def _timed_call(torch, device, fn):
    """fn() with its wall seconds and peak device bytes."""
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    _sync(torch, device)
    wall = time.perf_counter() - t0
    return out, wall, torch.cuda.max_memory_allocated() if device.type == "cuda" else None


def _finite_rows(rows, what):
    for row in rows:
        check(all(math.isfinite(v) for v in row.values() if isinstance(v, float)), f"{what}: finite row {row['label']}")


def phase_dag(torch, device, sizes) -> None:
    """`dag_frontier` at full width on the three-stage pipeline, then the
    DAG path's checks: the one-stage contract, `tail="hist"`, the joint
    searches, the lowered evaluator, the fault path and the event oracle."""
    from repro_torch.core import delayed_relaunch
    from repro_torch.dag import JobDAG, StageSpec, coordinate_search, dag_frontier, dag_rollout, exhaustive_search
    from repro_torch.faults import FaultSpec
    from repro_torch.fleet import vector

    d = sizes["dag"]
    J, m, c = d["n_jobs"], d["m_trials"], d["c"]
    inp = dag_inputs(sizes)
    dag, vectors, lams, cands = inp["dag"], inp["vectors"], inp["lams"], inp["cands"]
    names = dag.names
    calls: list = []
    with captured_queue_calls(calls):
        rows, wall, peak = _timed_call(torch, device, lambda: dag_frontier(dag, vectors, lams, J, m_trials=m, seed=0, device=device))
    check(len(calls) == len(names), f"one KW queue call per stage ({len(calls)})")
    check(len(rows) == len(vectors) * len(lams), "one DAG row per cell")
    _finite_rows(rows, "dag")
    for i, vec in enumerate(vectors):
        soj = [r["mean_sojourn"] for r in rows[i * len(lams):(i + 1) * len(lams)]]
        check(all(a < b for a, b in zip(soj, soj[1:])), f"DAG mean_sojourn rises with lambda for {rows[i * len(lams)]['label']}")
    share_err = max(abs(sum(r[f"{nm}/share"] for nm in names) - 1.0) for r in rows)
    check(share_err <= 1e-5, f"critical-path shares sum to 1 ({share_err:.3g})")
    emit("dag", cells=len(rows), stages=[dict(name=s.name, n=s.n_tasks, c=s.c, e_t_baseline=e)
                                         for s, e in zip(dag.stages, inp["et"])],
         n_jobs=J, m_trials=m, lams=lams, wall_s=wall, peak_bytes=peak, share_sum_max_err=share_err,
         rows=[{k: r[k] for k in ("label", "lam", "mean_sojourn", "mean_cost", "p99", "rho",
                                  *(f"{nm}/share" for nm in names))} for r in rows])
    emit("dag_kw_queue", tolerance="slots exact, floats rtol=atol=1e-5",
         stages=[dict(stage=nm, **st) for nm, st in zip(names, stage_queue_checks(torch, calls))])
    del calls

    # the map stage alone: a one-stage DAG is the frontier, bit for bit
    mspec = dag.stages[0]
    one = JobDAG([StageSpec(mspec.name, mspec.n_tasks, mspec.dist, c=c)])
    a, one_wall, _ = _timed_call(torch, device, lambda: dag_frontier(one, [(p,) for p in cands], lams, J, m_trials=m, seed=0, device=device))
    with uncounted():
        b = vector.frontier(mspec.dist, cands, lams, mspec.n_tasks, J, m_trials=m, c=c, seed=0, device=device)
    pairs = [(k, k) for k in ("mean_sojourn", "mean_wait", "mean_service", "mean_cost", "sojourn_std_err", "p50", "p99", "p999")]
    pairs += [("map/rho", "rho_block"), ("map/service", "mean_service"), ("map/cost", "mean_cost"), ("map/sojourn", "mean_sojourn")]
    for ra, rb in zip(a, b):
        for ka, kb in pairs:
            check(ra[ka] == rb[kb], f"one-stage DAG {ka} {ra[ka]!r} == frontier {kb} {rb[kb]!r} ({rb['policy']}, lam {rb['lam']})")
        check(ra["map/share"] == 1.0, "one-stage share is 1")
    emit("dag_one_stage", cells=len(a), wall_s=one_wall, keys=[ka for ka, _ in pairs], bit_equal=True)

    # tail="hist"; order statistics of the ρ = 0.7 cells from dag_rollout
    i7 = RHOS.index(0.7)
    lam7 = lams[i7]
    hist, hist_wall, _ = _timed_call(torch, device, lambda: dag_frontier(dag, vectors, lams, J, m_trials=m, seed=0, tail="hist", device=device))
    r_caps = tuple(max(v[s].r for v in vectors) + 1 for s in range(len(names)))
    with uncounted():
        paths = [dag_rollout(dag, lam7, J, m, policies=v, seed=0, r_caps=r_caps, device=device) for v in vectors]
    devs = hist_checks("dag", hist, rows, [i * len(lams) + i7 for i in range(len(vectors))], paths)
    del paths
    emit("dag_hist", wall_s=hist_wall, cells_with_order_stats=len(vectors), **devs,
         evt_xi=[r["evt_xi"] for r in hist], evt_p999=[r["evt_p999"] for r in hist])

    # joint search at ρ = 0.7: all 27 vectors of {baseline, π_keep, π_kill}³
    # against coordinate ascent on the same seed
    three = cands[:3]
    ex, ex_wall, _ = _timed_call(torch, device, lambda: exhaustive_search(dag, three, lam7, n_jobs=J, m_trials=m, seed=0, device=device))
    co, co_wall, _ = _timed_call(torch, device, lambda: coordinate_search(dag, three, lam7, n_jobs=J, m_trials=m, seed=0, device=device))
    obj_ex, obj_co = ex["best"]["mean_sojourn"], co["best"]["mean_sojourn"]
    # the coordinate steps evaluate cells of the same grid on the same
    # draws; a mean over fewer cells may round differently on the card,
    # hence the 1e-6
    check(ex["n_cells"] == 27 and obj_ex <= obj_co * (1 + 1e-6),
          f"exhaustive {obj_ex} no worse than coordinate {obj_co}")
    emit("dag_search", lam=lam7, exhaustive=dict(best=ex["best"]["label"], mean_sojourn=obj_ex, cells=ex["n_cells"], wall_s=ex_wall),
         coordinate=dict(best=co["best"]["label"], mean_sojourn=obj_co, evals=co["n_evals"], sweeps=co["sweeps"],
                         converged=co["converged"], wall_s=co_wall))

    # the lowered evaluator: a delayed_relaunch map stage in a grid with
    # single-fork vectors; those cells keep their single-fork rows
    base, keep = cands[0], cands[1]
    single = [(base, base, base), (keep, keep, base)]
    mixed = single + [(delayed_relaunch(2.0, r=1, keep=True), base, base)]
    caps = (2, 2, 2)
    g_rows, g_wall, g_peak = _timed_call(torch, device, lambda: dag_frontier(dag, mixed, [lam7], J, m_trials=m, seed=0, r_caps=caps, device=device))
    with uncounted():
        s_rows = dag_frontier(dag, single, [lam7], J, m_trials=m, seed=0, r_caps=caps, device=device)
    _finite_rows(g_rows, "dag_general")
    g_dev = max(abs(ga[k] - sa[k]) / abs(sa[k]) for ga, sa in zip(g_rows, s_rows)
                for k in ("mean_sojourn", "mean_cost", "p99") + tuple(f"{nm}/share" for nm in names))
    check(g_dev <= 1e-6, f"single-fork cells of the lowered grid keep their rows ({g_dev:.3g})")
    emit("dag_general", lam=lam7, labels=[r["label"] for r in g_rows], wall_s=g_wall, peak_bytes=g_peak,
         single_fork_max_rel_dev=g_dev, mean_sojourn=[r["mean_sojourn"] for r in g_rows])

    # the fault path: q = 0 and 0.05 through the retry draws
    faults = [FaultSpec(q=0.0), FaultSpec(q=0.05)]
    f_rows, f_wall, f_peak = _timed_call(torch, device, lambda: dag_frontier(dag, single, [lam7], J, m_trials=m, seed=0, fault=faults, device=device))
    _finite_rows(f_rows, "dag_fault")
    free = {r["label"]: r for r in rows if r["lam"] == lam7}
    z = []
    for q0, q5 in zip(f_rows[::2], f_rows[1::2]):
        ref = free[q0["label"]]
        z.append(abs(q0["mean_sojourn"] - ref["mean_sojourn"]) / math.hypot(q0["sojourn_std_err"], ref["sojourn_std_err"]))
        check(z[-1] < 5.0, f"q=0 cell of the fault grid agrees with the fault-free row ({z[-1]:.2f} sigma)")
        check(q5["mean_service"] > q0["mean_service"], f"q=0.05 lengthens the service of {q0['label']}")
    emit("dag_fault", lam=lam7, qs=[0.0, 0.05], wall_s=f_wall, peak_bytes=f_peak, q0_vs_fault_free_sigma=z,
         mean_service=[r["mean_service"] for r in f_rows], mean_sojourn=[r["mean_sojourn"] for r in f_rows])
    phase_dag_event(torch, device, sizes)


def phase_dag_event(torch, device, sizes) -> None:
    """The port's event engine on the host against `dag_frontier` on the
    device, on benchmarks/bench_dag.py's grid, gated as that benchmark
    gates it: every cell's E[T] within 5 combined standard errors, E[C]
    within 0.1."""
    from repro_torch.core import ShiftedExp, SingleForkPolicy
    from repro_torch.dag import DagFleetConfig, DagFleetSim, JobDAG, dag_frontier, poisson_arrivals

    d = sizes["dag"]
    dag = JobDAG.map_reduce(8, 4, ShiftedExp(1.0, 1.0), ShiftedExp(0.5, 2.0), c_map=2, c_reduce=2)
    vectors = [tuple(SingleForkPolicy(*p) for p in v) for v in EVENT_VECTORS]
    t0 = time.perf_counter()
    event = []
    for vec in vectors:
        for lam in EVENT_LAMS:
            st = DagFleetSim(DagFleetConfig(dag, policies=vec)).run(
                poisson_arrivals(d["event_jobs"], lam, seed=int(lam * 1e3))).stats
            event.append((st.mean_sojourn, st.mean_cost, st.sojourn_std_err))
    event_s = time.perf_counter() - t0
    fused, fused_s, _ = _timed_call(torch, device, lambda: dag_frontier(
        dag, vectors, EVENT_LAMS, d["event_jobs"], m_trials=d["event_trials"], seed=17, r_caps=(2, 2), device=device))
    sigma = [abs(f["mean_sojourn"] - e[0]) / max(math.hypot(f["sojourn_std_err"], e[2]), 1e-12) for f, e in zip(fused, event)]
    cost = [abs(f["mean_cost"] - e[1]) for f, e in zip(fused, event)]
    check(max(sigma) <= 5.0 and max(cost) <= 0.1,
          f"fused DAG vs event engine: worst {max(sigma):.2f} sigma, cost {max(cost):.4f}")
    emit("dag_event", cells=len(fused), event_s=event_s, fused_s=fused_s, max_sojourn_sigma=max(sigma),
         max_cost_dev=max(cost), max_cost_rel_dev=max(c / e[1] for c, e in zip(cost, event)), sigma=sigma)


def profiled(torch, fn, top_n: int = 12, named: tuple = ()) -> dict:
    """`fn()` once under torch.profiler: wall seconds, device ms summed over
    kernels, the device's idle share of the wall time, the top kernels, the
    device ms and calls of every kernel whose name contains one of `named`,
    and those kernels' launches one by one in start order (`sequence`)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        us = getattr(e, "self_device_time_total", None)
        return us if us is not None else getattr(e, "self_cuda_time_total", 0.0)

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
                       for e in kernels if any(k in e.key for k in named)],
                sequence=[dict(name=e.name[:80], device_ms=dev_us(e) / 1e3) for e in sorted(
                    (e for e in prof.events() if dev_us(e) > 0 and any(k in e.name for k in named)),
                    key=lambda e: e.time_range.start)])


def phase_profile(torch, device, sizes) -> None:
    """One full-width `frontier` call under torch.profiler: device time by
    kernel (the KW queue's kernels by name), and the device's idle share of
    the call's wall time."""
    from repro_torch.fleet import vector

    inp = frontier_inputs(sizes)
    args = (inp["emp"], inp["policies"], inp["lams"], sizes["n"], sizes["n_jobs"])
    kw = dict(m_trials=sizes["m_trials"], c=sizes["c"], seed=0, device=device)
    emit("profile", **profiled(torch, lambda: vector.frontier(*args, **kw), named=("kw_",)))


def phase_dag_profile(torch, device, sizes) -> None:
    """One full-width `dag_frontier` call under torch.profiler (after a warm
    call): device time by kernel, launches, the idle share, and the
    kw_queue kernels' device time in each stage's call, in stage order
    (each call's launches begin with its `kw_segment_kernel`)."""
    from repro_torch.dag import dag_frontier

    inp = dag_inputs(sizes)
    d = sizes["dag"]

    def call():
        return dag_frontier(inp["dag"], inp["vectors"], inp["lams"], d["n_jobs"], m_trials=d["m_trials"],
                            seed=0, device=device)

    call()
    out = profiled(torch, call, named=("kw_",))
    per_stage: list = []
    for k in out["sequence"]:
        if "kw_segment" in k["name"]:
            per_stage.append(0.0)
        check(bool(per_stage), f"{k['name']} launched after a kw_segment_kernel")
        per_stage[-1] += k["device_ms"]
    check(len(per_stage) == len(inp["dag"].stages), f"one kw_queue call per stage in the profile ({len(per_stage)})")
    emit("dag_profile", **out, kw_queue_ms_per_stage=per_stage)

    # the fault grid of phase `dag_fault`, by kernel
    from repro_torch.core import SingleForkPolicy
    from repro_torch.faults import FaultSpec

    base, keep = (SingleForkPolicy(*p) for p in DAG_CANDIDATES[:2])
    emit("dag_fault_profile", **profiled(torch, lambda: dag_frontier(
        inp["dag"], [(base, base, base), (keep, keep, base)], [inp["lams"][RHOS.index(0.7)]], d["n_jobs"],
        m_trials=d["m_trials"], seed=0, fault=[FaultSpec(q=0.0), FaultSpec(q=0.05)], device=device)))


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
    paths = {"frontier": {"kw_queue": kw_queue.launches, "residual_sample": residual_sample.launches}}
    kw_queue.launches = 0
    phase_dag(torch, device, sizes)
    paths["dag"] = {"kw_queue": kw_queue.launches}
    paths["serve"] = phase_serve(torch, device, sizes, profile)
    emit("launches", **paths)
    launches: dict = {}
    for path, counts in paths.items():
        for name, count in counts.items():
            if device.type == "cuda":
                check(count > 0, f"{name} launched on the {path} path")
            launches[name] = launches.get(name, 0) + count

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
        phase_dag_profile(torch, torch.device("cuda"), FULL)
    print(json.dumps(table))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
