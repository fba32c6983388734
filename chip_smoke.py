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
            kw_queue at loads 0.7, 0.85 and 1.2 (saturated), c = 4 and 1;
            flash_attention at the prefill shapes of zamba2-1.2b, moonshot,
            stablelm-3b, gemma-2b and qwen3-32b (each on the Hopper kernel,
            timed beside scaled_dot_product_attention and the mma.sync
            kernel on the same inputs); ssd_scan at zamba2-1.2b's prefill
            shape and mamba2-2.7b's geometry at 1024 and 4096 tokens (each
            on the Hopper kernel, timed in turns with the mma_sync kernel on
            the same inputs, with the clusters the card holds at once);
            single_job at the benchmark's two grids (job1.frontier's 8
            single-fork laws, job1.general's 4 lowered laws) and phase
            paper's cross-family grid (9 laws, group widths 6 and 2; 2048
            jobs x 16 trials of 1026 tasks), T bit-equal and C within 1e-6
            of its PyTorch chains, timed in turns with them, beside the
            bytes its laws need (`single_job_bytes`);
            every case naming its kernel path
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
            (gate `dag_fused_vs_event_agreement`)
  fleet_gates  benchmarks/bench_fleet.py's single-stage lanes at its grids,
            seeds, thresholds and retry rules (600 jobs x 12 trials a cell),
            the fused engines on the card and the event oracle on the
            host, one line a lane: kw_queue at its gate's shape (96, 384,
            c=3) bit-equal to kw_queue_plain; `frontier` against
            `sweep_loop` (≥ 5x, 5σ); the recorder's overhead (≤ 1.05);
            hist tails; the algebra's single-fork twins and FaultSpec(q=0)
            bit for bit at that grid and at phase frontier's full width;
            one dispatch for a mixed-family grid; the chaos lane (≥ 5x,
            5σ, ≤ 1.05, availability); the re-plans padded and unpadded
            (printed); the event sweeps against the fused ones at c = 1
            and 3 (≥ 10x); shared cells at c = 1, c = 3 and heterogeneous
            (5σ); the EVT p999 from 4 against 40 trials; the blame of a
            planted slow class
  dag_gates bench_dag.py's `dag_fused_vs_event_speedup` (≥ 10x; phase
            dag_event's walls are its first round) and
            `dag_joint_dominates_uniform` (the exhaustive per-stage search
            strictly below the best uniform vector in E[T] and E[C])
  paper     the paper's evaluations at the reference benchmarks' grids and
            sizes (`PAPER_*`), held against the JAX package's numbers in
            tools/paper_reference.json (recorded on the CPU by
            tools/paper_reference.py), one line a grid with its wall time
            and largest distance: Figs. 3/5 (`simulate`, 2000 trials, n =
            50..800, four policies, ShiftedExp(1, 1) and Pareto(2, 2); 5σ,
            and each gap to Theorem 2/3 beside the reference's), Figs. 4/6
            and Corollary 1 (Theorem 1's quadrature and Theorem 3 on the
            host; float32 rounding and 1e-9), Figs. 7-10 (Algorithm 1 at 400
            replicates on the three trace jobs, p x r x keep/kill; 5σ), the
            cross-family table (`frontier` on the three stage traces through
            the kw_queue kernel; 5σ, the Pareto marks but near-ties) and
            Table 1 (eq. 19/20 on `bootstrap_evaluator(m=300)`: the
            reference's picks evaluated here within 5σ, the port's own picks
            beside them, its latency-sensitive pick faster than the baseline
            at no more cost)
  serve_moe `repro_torch.launch.serve --arch moonshot-v1-16b-a3b` at full
            width and depth (48 layers, 28.89 B parameters, bf16, seed-0
            weights), 2 batches x 4 requests of 1024 prompt tokens and 8
            new tokens under `HedgedServer(adapt=True)`: flash launches =
            48 x prefills, every flash call of one prefill against its
            plain version, the share of routed assignments the capacity
            factor 1.25 drops, the byte and FLOP bounds of a prefill and of
            a decode token; then, on the first 4 layers in float32, the
            prefill with the kernels against the plain versions and
            prefill-then-decode at the drop-free capacity
  configs   each of gemma-2b, stablelm-3b, whisper-small, deepseek-v2-236b
            (2 of its 60 layers), qwen3-32b and llava-next-34b at its
            published widths, one model on the card at a time: two
            requests of 1024 prompt tokens (plus whisper's 1500 encoder
            frames, llava's 576 patches) and 4 decode steps through
            `launch.serve.RequestFn`, flash launches = decoder layers x
            prefills, every flash call of a third request against its plain
            version, deepseek's absorbed MLA decode against the naive one
  serve     `repro_torch.launch.serve` at full width: Zamba2-1.2B in bf16
            with seed-0 weights, 2 batches x 8 requests of 1024 prompt
            tokens and 32 new tokens under `HedgedServer(adapt=True)`;
            then, on one request, every kernel call of a prefill against
            its plain version on the same inputs, prefill-then-decode
            consistency, and the prefill's logits with the kernels against
            those with the plain versions (gated in float32)
  fleet_adaptive  benchmarks/bench_fleet.py's regime-change drill
            (REGIME_SHIFT, 500 jobs of 16 tasks on 48 slots, c = 3) with
            `FleetConfig(adapt=True)` planning on the card: its gates
            `adaptive_reoptimized`, `adaptive_drift_fired` and
            `adaptive_beats_best_fixed` against the six fixed policies on the
            host, every re-plan's kw_queue call bit-equal to kw_queue_plain,
            the first re-plan's rows within 5σ of the same search on the CPU;
            then a line `fleet_gates` mapping each of BENCH_fleet.json's 26
            gates to the phase that holds it (or "printed", with the
            reason), its value here, and the reference's (its CPU times
            left out)
  fleet_serve  `FleetHedgedServer(adapt=True)` on phase serve's model: 40
            batches x 8 requests of 1024-token prompts (prefill plus one
            greedy token) on 32 replicas (c = 4) at ρ = 0.7, two priority
            classes with SLOs: values, kernel launches per prefill, the
            re-plans' kw_queue calls bit-equal, the sketch tails against
            np.percentile, the SLO report, the private trace's Chrome
            round trip
  serve_ssm `repro_torch.launch.serve --arch mamba2-2.7b` at full width and
            depth (64 layers, bf16, seed-0 weights), 2 batches x 2 requests
            of 4096 prompt tokens and 8 new tokens, after phase serve's
            model is freed: the checks of phase serve (ssd_scan launches =
            64 x prefills, all on the Hopper kernel, whose clusters of 8
            walk the 32 chunks in 4 groups; every kernel call of one
            prefill against its plain version; decode against prefill in
            bfloat16 and float32; kernels against plain in float32)
  train     `repro_torch.launch.train` on qwen2-0.5b at full width and
            depth (24 layers, 630.4 M parameters, bf16, float32 AdamW
            moments): 30 steps of 8 x 512 tokens in 8 shards on a Pareto(2,
            1) `SimCluster` (slow fraction 0.15, crashes 0.01, node loss
            0.002), `adapt_policy` on, a checkpoint every 10 steps into a
            temporary directory: the loss falls by more than 0.5, a re-plan
            ran on the card, the pool held; a fresh run restores step 30 bit
            for bit and one step from the step-20 checkpoint gives the
            step-21 loss; one literal-replica step against one global step;
            float32 gradients of 2 full-width layers on the card against the
            CPU; the flash and SSD kernels refuse autograd on the card; step
            ms, tokens/s, MFU, the gradient and AdamW alone, peak bytes.
            Training runs none of the four kernels (attention "chunked",
            the SSM "jnp", as the reference trains), so it adds no path to
            the kernel table's counts
  sharded_train  `launch.steps.plan_train`'s step on DTensors over a
            one-rank NCCL mesh (`launch.mesh.make_device_mesh`), qwen2-0.5b
            at full width and depth on phase train's 8 x 512 tokens, 3 steps
            beside 3 of `make_train_step` from one seed-0 state: every loss
            within 1e-6 relative, every parameter within one bf16 ulp of its
            own magnitude, the share of bit-equal leaves; both steps' ms,
            the collectives issued (count, bytes), peak bytes; the process
            group destroyed at the end
  dryrun    `launch.dryrun.run_cell("qwen2-0.5b", "train_4k", "single" |
            "multi")` on the card's host (256 and 512 fake ranks, meta
            shards): status OK, per-rank argument bytes equal to the rules'
            shards, collective bytes > 0, the largest op result (bytes, op,
            shape) below the global float32 logits' bytes and no op result
            of their shape, result bytes beside the gather loss's; then phase
            sharded_train's step on
            a (1, 1) fake mesh through `roofline.analyze_cell`, its compute
            and memory terms (predicted MFU) against the measured plain step
            (read MFU).  Neither phase launches one of the four kernels

The serving phases (`serve_moe`, `configs`, `serve`, `fleet_serve`,
`serve_ssm`) also hold every bf16 flash launch of their main paths, and
every checked call, to the Hopper (TMA and wgmma) kernel by
`flash_attention.launches_by_path`, and (`serve`, `fleet_serve`,
`serve_ssm`) every ssd_scan launch to its Hopper kernel by
`ssd_scan.launches_by_path`; the line `launches` carries those counts by
phase, and the kernel table their sums by path.

The profilers run after every timed phase: `obs.kernel_profile` over one
re-plan's search (phase `fleet_adaptive_profile`), the device kernels of
one scaled_dot_product_attention call at each timed flash shape (phase
`sdpa_kernels`: the yardstick of flash_attention's `library_ms`), one more
training step,
its gradient and its AdamW update under torch.profiler (phase
`train_profile`: launches, device ms by kernel), then, with `--profile`,
one request's prefill and 8 decode steps (phase `serve_profile`), the
same for moonshot-v1-16b-a3b with 4 decode steps (phase
`serve_moe_profile`), one more `frontier` call (phase `profile`), one more
full-width `dag_frontier` call (phase `dag_profile`) and the fault grid of
`dag_fault` (phase `dag_fault_profile`) run under torch.profiler: device
time by kernel, the device's idle share.  Then the kernel table
(`{"kernels": [...]}`), the card's name and power limit, and last
`{"ok": true, "device": {...}}`.  Any failed check raises
and the script exits nonzero without the last line; so does a machine
without a card.  The launch counts in the kernel table come from the
main paths only: kw_queue and residual_sample from the frontier path
(counters set to 0 just before `frontier`, read after `frontier_hist`)
plus kw_queue from the DAG path (set to 0 just before `dag`, read after
`dag_event`), from the gate lanes (set to 0 just before `fleet_gates`,
read after it, and again for `dag_gates` and for `paper`), flash_attention and ssd_scan from the serve path (set to 0
just before it, read just after), flash_attention from the MoE serve
path and from the configs path (each set to 0 just before its phase and
read just after), kw_queue from the controller's drill
(phase `fleet_adaptive`), kw_queue, flash_attention and ssd_scan from
fleet-backed serving (phase `fleet_serve`) and ssd_scan from the SSM serve
path (phase `serve_ssm`), each set to 0 just before its phase and read
just after; single_job's by the phase that launched them (the line
`launches`, key `single_job_by_phase`), and beside them the engines'
evaluator calls that kept the PyTorch chains on the card, with their n,
stages and laws (key `single_job_chain_by_phase`).  The calls made only to compare
with them (the kernels against their plain versions, the reference `frontier` of
`dag_one_stage`, the rollouts that give the order statistics, the
single-fork grid of `dag_general`, kw_queue at its gate's shape, the re-plans' queues against
kw_queue_plain, the first re-plan on the CPU, the profiled search, the
fresh request, the MoE model's checked prefills, drop count and float32
checks, each config's checked request and MLA check) run under
`uncounted` and are not in the counts.
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

sys.path.insert(0, str(ROOT / "src"))
#: H100 SXM peaks (NVIDIA data sheet, `repro_torch.launch.mesh`): HBM3
#: bytes/s, FP32 (non-tensor) op/s, dense bf16 tensor-core op/s
from repro_torch.launch.mesh import HBM_BW as HBM_BYTES_PER_S  # noqa: E402
from repro_torch.launch.mesh import PEAK_FLOPS_BF16 as BF16_OPS_PER_S  # noqa: E402
from repro_torch.launch.mesh import PEAK_FLOPS_FP32 as FP32_OPS_PER_S  # noqa: E402

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
#: head dim 16, the reduced configs' (examples/torch_hedged_serving.py serves
#: reduced qwen2-0.5b: one request's 12-token prefill), in both dtypes
FLASH_D16_CASES = ((1, 12, 4, 16, True, "bfloat16"), (2, 100, 4, 16, False, "float32"))
SSD_BF16_CASES = (
    (1, 100, 4, 16, 2, 8, 32, "bfloat16"), (1, 300, 2, 128, 1, 128, 128, "bfloat16"),
    (1, 128, 8, 64, 1, 64, 128, "bfloat16"),
)

#: The paper's evaluation grids, copied from the reference's benchmarks
#: (benchmarks/ imports JAX); phase `paper` runs them through the port and
#: holds them against tools/paper_reference.json, the reference's numbers
#: on the same grids (`python tools/paper_reference.py` on the CPU).
#: Figs. 3/5, bench_fig3_fig5.py:19-26, 29-37: (figure, distribution,
#: its parameters, the closed form of E[T]), n, π(p, r, keep), trials
PAPER_FIG35 = (("fig3", "ShiftedExp", (1.0, 1.0), "theorem2_latency"),
               ("fig5", "Pareto", (2.0, 2.0), "theorem3_latency"))
PAPER_FIG35_NS = (50, 100, 200, 400, 800)
PAPER_FIG35_POLICIES = ((0.1, 1, True), (0.1, 1, False), (0.1, 2, True), (0.1, 2, False))
PAPER_FIG35_M = 2000
#: Figs. 4/6, bench_fig4_fig6.py:19-20, 26-35: p grid, n, (r, keep) curves
#: (π_keep(p, 0) is the baseline and is skipped)
PAPER_FIG46 = (("fig4", "ShiftedExp", (1.0, 1.0)), ("fig6", "Pareto", (2.0, 2.0)))
PAPER_FIG46_P_GRID = tuple(float(p) for p in np.round(np.arange(0.05, 0.96, 0.05), 3))
PAPER_FIG46_N = 400
PAPER_FIG46_CURVES = ((0, False), (1, True), (1, False), (2, True), (2, False))
#: Corollary 1, bench_scaling.py:12-24: n, Pareto(α, 2), r, π_kill(0.2, r)
PAPER_SCALING_NS = (100, 200, 400, 800, 1600, 3200)
PAPER_SCALING_ALPHAS = (1.5, 2.0, 3.0)
PAPER_SCALING_RS = (0, 1, 2)
PAPER_SCALING_P = 0.2
#: Figs. 7-10, bench_trace.py:31, 112-124: p grid, r, bootstrap replicates
PAPER_TRACE_P_GRID = tuple(float(p) for p in np.round(np.arange(0.02, 0.52, 0.04), 3))
PAPER_TRACE_RS = (1, 2, 3)
PAPER_TRACE_M = 400
#: the cross-family table, bench_trace.py:36-48, 65-82: tasks a job, loads,
#: jobs, trials, seed (its policies: `paper_cross_policies`)
PAPER_CROSS_N = 10
PAPER_CROSS_LAMS = (0.08, 0.14)
PAPER_CROSS_JOBS = 300
PAPER_CROSS_TRIALS = 32
PAPER_CROSS_SEED = 7
#: Table 1, bench_table1.py:17, 20-24: p grid, bootstrap replicates, r_max, λ
PAPER_TABLE1_P_GRID = tuple(float(p) for p in np.round(np.arange(0.02, 0.42, 0.04), 3))
PAPER_TABLE1_M = 300
PAPER_TABLE1_R_MAX = 4
PAPER_TABLE1_LAM = 0.1
#: the agreement bound in combined standard errors (tests/test_frontier.py:44)
PAPER_SIGMAS = 5.0
#: Figs. 4/6's points are Theorem 1's float32 quadratures (`analytic_evaluator`)
#: in both packages, summed in different orders, and so is Theorem 3's
#: π_keep branch (its residual's expected maximum), so they agree to
#: float32 rounding (the port's tests hold Theorem 1 and Theorem 3's keep
#: branch at 2e-4, tests/test_torch_serving.py), not to 1e-9 as the closed
#: forms of Theorem 2 and of Theorem 3's π_kill branch (Corollary 1) do
PAPER_QUADRATURE_RTOL = 2e-4
PAPER_CLOSED_FORM_RTOL = 1e-9

FULL = dict(
    n=1026, c=4, n_jobs=2048, m_trials=16,
    kw_shape=(512, 2048), kw_loads=(0.7, 0.85, 1.2), residual_shape=(32768, 103, 3),
    kernel_reps=20, plain_reps=3, mc_reps=4000,
    # one Zamba2-1.2B prefill of 1024 tokens: attention (B, S, H, D) and
    # SSM (Bt, S, H, P, G, N, chunk), both bf16; then the attention of one
    # 1024-token prefill of moonshot-v1-16b-a3b, stablelm-3b, gemma-2b (its
    # one kv head expanded to 8) and qwen3-32b (timed too)
    flash_shapes=((1, 1024, 32, 64), (1, 1024, 16, 128), (1, 1024, 32, 80), (1, 1024, 8, 256),
                  (1, 1024, 64, 128)),
    # the SSM of one Zamba2-1.2B prefill, then mamba2-2.7b's geometry at 1024
    # tokens and at phase serve_ssm's 4096 (32 chunks: four groups of a
    # cluster of 8), all timed
    ssd_shapes=((1, 1024, 64, 64, 1, 64, 128), (1, 1024, 80, 64, 1, 128, 128), (1, 4096, 80, 64, 1, 128, 128)),
    flash_cases=FLASH_CASES + FLASH_BF16_CASES + FLASH_D16_CASES, ssd_cases=SSD_CASES + SSD_BF16_CASES,
    serve=dict(arch="zamba2-1.2b", reduced=False, requests=8, batches=2, prompt=1024, steps=32),
    # mamba2-2.7b at full width and depth (64 layers, bf16, 5.4 GB; float32
    # for the checks, 10.8 GB): 2 batches x 2 requests of 4096 prompt tokens
    # and 8 new tokens
    serve_ssm=dict(arch="mamba2-2.7b", reduced=False, requests=2, batches=2, prompt=4096, steps=8),
    # moonshot-v1-16b-a3b at full width and depth: 2 batches x 4 requests of
    # 1024 prompt tokens and 8 new tokens; the float32 checks on its first 4
    # layers (bf16 48 layers: 53.8 GiB; float32: 108 GiB)
    serve_moe=dict(arch="moonshot-v1-16b-a3b", reduced=False, requests=4, batches=2, prompt=1024, steps=8,
                   f32_layers=4),
    # the other six new configs at their published widths, full depth but
    # deepseek-v2-236b's (446 GiB in bf16; 2 of its 60 layers, 17 GB): two
    # counted requests of 1024 prompt tokens plus 4 decode steps (the second
    # timed warm), a third with every flash call checked
    configs=dict(archs=("gemma-2b", "stablelm-3b", "whisper-small", "deepseek-v2-236b", "qwen3-32b",
                        "llava-next-34b"), reduced=False, layers={"deepseek-v2-236b": 2}, prompt=1024, steps=5),
    # the map → shuffle → reduce pipeline: (stage trace, tasks), c gang blocks
    # each; the event oracle's grid is benchmarks/bench_dag.py's
    dag=dict(stages=(("map", 1026), ("shuffle", 488), ("reduce", 485)), c=4,
             n_jobs=2048, m_trials=16, event_jobs=400, event_trials=12),
    # benchmarks/bench_fleet.py's counts for its other lanes (:83-171, :250-1030):
    # 600 jobs x 12 trials a cell, 48 trials for a shared cell against 8, 6
    # and 4 event seeds (c = 1, c = 3, heterogeneous), 4 against 40 trials
    # for the EVT tail (600 jobs), 300 jobs for the availability table and the
    # blame drill, 192 jobs x 8 trials a re-plan, 3 attempts, 3 reps; a
    # recorder round lasts at least 0.5 s (see _obs_overhead)
    fleet_gates=dict(n_jobs=600, m_trials=12, agree_trials=48, seeds=dict(c1=8, c3=6, het=4),
                     tail_trials=(4, 40), tail_jobs=600, avail_jobs=300, blame_jobs=300, replan_jobs=192,
                     replan_trials=8, attempts=3, obs_reps=3, obs_round_s=0.5),
    # benchmarks/bench_dag.py's joint search: 256 jobs x 16 trials
    dag_gates=dict(n_jobs=256, m_trials=16),
    # benchmarks/bench_fleet.py's adaptive lane: REGIME_SHIFT, 500 jobs of 16
    # tasks on 48 slots (c = 3)
    fleet_adaptive=dict(n_jobs=500),
    # FleetHedgedServer on phase serve's model: 40 batches x 8 requests of
    # 1024-token prompts, prefill plus one greedy token, on 32 replicas
    # (c = 4) at rho = 0.7 under the baseline
    fleet_serve=dict(capacity=32, requests=8, batches=40, prompt=1024, steps=1, rho=0.7, mc_reps=20000),
    # launch/train.py on qwen2-0.5b at full width and depth (24 layers,
    # 630.4 M parameters, bf16): 30 steps of 8 x 512 tokens in 8 shards, a
    # checkpoint every 10; the card-vs-CPU gradients on 2 of its layers
    train=dict(arch="qwen2-0.5b", reduced=False, steps=30, batch=8, seq=512, n_tasks=8, checkpoint_every=10,
               warmup=2, optimizer_reps=5, check_layers=2),
    # plan_train's step on a one-rank NCCL mesh beside make_train_step, from
    # one state, on phase train's config and batch
    sharded_train=dict(arch="qwen2-0.5b", reduced=False, steps=3, batch=8, seq=512),
    # the dry-run's train_4k cell on 256 and 512 fake ranks, its prefill_32k
    # and decode_32k cells on 256, then phase sharded_train's step on a
    # (1, 1) fake mesh through the roofline
    dryrun=dict(arch="qwen2-0.5b", shape="train_4k", meshes=("single", "multi"),
                serve=("prefill_32k", "decode_32k")),
    # the paper's evaluations at the reference's grids and sizes, held
    # against tools/paper_reference.json's section "full"
    paper=dict(reference="full", fig35_ns=PAPER_FIG35_NS, fig35_m=PAPER_FIG35_M, fig46_p=PAPER_FIG46_P_GRID,
               scaling_ns=PAPER_SCALING_NS, trace_jobs=("job1", "job2", "job3"), trace_p=PAPER_TRACE_P_GRID,
               trace_m=PAPER_TRACE_M, cross_stages=("map", "reduce", "shuffle"), cross_jobs=PAPER_CROSS_JOBS,
               cross_trials=PAPER_CROSS_TRIALS, table1_jobs=("job1", "job2", "job3"), table1_p=PAPER_TABLE1_P_GRID,
               table1_m=PAPER_TABLE1_M),
)
#: phase `paper` at a rehearsal size (the CPU test), against the
#: reference file's section "small": every grid, fewer points and trials
PAPER_SMALL = dict(reference="small", fig35_ns=(50,), fig35_m=200, fig46_p=(0.1, 0.5), scaling_ns=(100, 200, 400),
                   trace_jobs=("job2",), trace_p=(0.1, 0.3), trace_m=64, cross_stages=("shuffle",), cross_jobs=60,
                   cross_trials=4, table1_jobs=("job2",), table1_p=(0.1, 0.3), table1_m=64)


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


#: every kw_queue kernel launch of the run, as (phase, B, J, c, path), and
#: a copy of the first inputs of each (B, J, c); `uncounted()` drops the
#: records of its block, `record_kw_launches` makes them
KW_LAUNCHES: list = []
KW_INPUTS: dict = {}
KW_PHASE = ["kernels"]


def record_kw_launches():
    """Wraps the kw_queue wrapper's `launch` (every kernel launch goes
    through it) so that each launch appends its shape and path, in phase
    KW_PHASE[0], to KW_LAUNCHES.  Returns the function that unwraps it."""
    from repro_torch.kernels import kw_queue as kwk

    inner = kwk.launch

    def recorded(arrivals, services, speeds, path, *args, **kwargs):
        B, J = arrivals.shape
        c = int(speeds.shape[0])
        KW_LAUNCHES.append((KW_PHASE[0], B, J, c, path))
        if (B, J, c) not in KW_INPUTS:
            KW_INPUTS[(B, J, c)] = (arrivals.clone(), services.clone(), speeds.clone())
        return inner(arrivals, services, speeds, path, *args, **kwargs)

    kwk.launch = recorded

    def unwrap():
        kwk.launch = inner

    return unwrap


#: every call of the engines' single-job evaluator (`cell_tc`) that kept
#: the PyTorch chains on a card, as (n, S, laws): `record_single_job_chain`
#: makes them, `uncounted()` drops the records of its block
SINGLE_CHAIN: list = []


def record_single_job_chain():
    """Wraps `cell_tc` where the engines call it (`fleet.vector`,
    `dag.rollout`) so that each call on a card that keeps the PyTorch
    chains (`fused_path` false: n or S beyond the single-job kernel)
    appends its (n, S, laws) to SINGLE_CHAIN.  Returns the function that
    unwraps it."""
    from repro_torch.dag import rollout
    from repro_torch.fleet import vector

    inner = vector.cell_tc

    def recorded(g, quantile, pol, qs, shape, n, r_cap, n_stages, *args, **kwargs):
        S = 1 if pol[0] is None else n_stages
        if g.device.type == "cuda" and not vector.fused_path(g.device, n, S):
            SINGLE_CHAIN.append((n, S, int(pol[1].shape[0])))
        return inner(g, quantile, pol, qs, shape, n, r_cap, n_stages, *args, **kwargs)

    vector.cell_tc = rollout.cell_tc = recorded

    def unwrap():
        vector.cell_tc = rollout.cell_tc = inner

    return unwrap


def kw_queue_shapes(records) -> list:
    """The distinct (phase, B, J, c) of kw_queue launch records, with their
    launches by path, in order of first launch."""
    classes: dict = {}
    for phase, B, J, c, path in records:
        entry = classes.setdefault((phase, B, J, c), dict(phase=phase, B=B, J=J, c=c, launches=0, by_path={}))
        entry["launches"] += 1
        entry["by_path"][path] = entry["by_path"].get(path, 0) + 1
    return list(classes.values())


@contextlib.contextmanager
def uncounted():
    """Launches of the block leave the kernels' launch counters (in all
    and by kernel path) and the kw_queue launch records as they were: for
    calls made only to compare a path with its reference."""
    from repro_torch.kernels import ops

    kernels = (ops.kw_queue, ops.residual_sample, ops.flash_attention, ops.ssd_scan, ops.single_job)
    saved = [k.launches for k in kernels]
    by_path = {k: dict(k.launches_by_path) for k in (ops.kw_queue, ops.flash_attention, ops.ssd_scan)}
    n_kw = len(KW_LAUNCHES)
    n_chain = len(SINGLE_CHAIN)
    try:
        yield
    finally:
        for k, n in zip(kernels, saved):
            k.launches = n
        for k, paths in by_path.items():
            k.launches_by_path = paths
        del KW_LAUNCHES[n_kw:]
        del SINGLE_CHAIN[n_chain:]


def reset_kw() -> None:
    """kw_queue's launch counters, in all and by kernel path, to 0."""
    from repro_torch.kernels import ops

    ops.kw_queue.launches = 0
    ops.kw_queue.launches_by_path = dict.fromkeys(ops.kw_queue.launches_by_path, 0)


def time_turns(torch, fns: dict, reps: int, device, flush=None) -> dict:
    """Each of `fns` timed by `time_ms` in turns (a, b, b, a): the mean of
    its two medians of `reps` calls, in ms."""
    order = [*fns, *reversed(list(fns))]
    samples: dict = {name: [] for name in fns}
    for name in order:
        samples[name].append(time_ms(torch, fns[name], reps, device, flush, ahead=True))
    return {name: float(np.mean(v)) for name, v in samples.items()}


def kw_paths_case(torch, device, args, reps, flush) -> dict:
    """kw_queue on `args` through its wrapper and through each kernel path,
    every output bit-equal to kw_queue_plain's (torch.equal on all four),
    then each path timed in turns on the same inputs (on the card); the
    byte bound, and path "tma"'s cut (`tma_plan`)."""
    from repro_torch.kernels import kw_queue as kwk

    arrivals, services, speeds = args
    B, J = arrivals.shape
    c = int(speeds.shape[0])
    what = f"kw_queue {(B, J, c)}"
    with uncounted():
        want = kwk.kw_queue_plain(*args)
        got = kwk.kw_queue(*args)
        for name, a, b in zip(("starts", "finishes", "services", "slots"), got, want):
            check(torch.equal(a, b), f"{what}: {name} bit-equal to kw_queue_plain")
        case = dict(B=B, J=J, c=c, max_abs_err=max(float((a.double() - b.double()).abs().max())
                                                    for a, b in zip(got, want)))
        if device.type == "cuda":
            path = kwk.kernel_path(B, J, c, all(t.data_ptr() % 16 == 0 for t in args[:2]))
            plan = kwk.tma_plan(B, J, c, kwk.n_sms(device))
            paths = [p for p in kwk.PATHS if p != "tma" or plan is not None]
            for p in paths:
                for name, a, b in zip(("starts", "finishes", "services", "slots"), kwk.launch(*args, p), want):
                    check(torch.equal(a, b), f"{what}: {p} path's {name} bit-equal to kw_queue_plain")
            ms = time_turns(torch, {p: (lambda p=p: kwk.launch(*args, p)) for p in paths}, reps, device, flush)
            case.update(path=path, ms=ms.get(path), two_launch_ms=ms["two_launch"], tma_ms=ms.get("tma"),
                        plan=None if plan is None else dict(L=plan.L, K=plan.K, R=plan.R, blocks=plan.blocks,
                                                           threads=plan.threads, smem=plan.smem))
    case["bound_ms"], case["bound_by"] = bound(B * J * 24 + c * 4, B * J * (3 + 2 * c))
    return case


def reset_flash() -> None:
    """flash_attention's launch counters, in all and by kernel path, to 0."""
    from repro_torch.kernels import ops

    ops.flash_attention.launches = 0
    ops.flash_attention.launches_by_path = dict.fromkeys(ops.flash_attention.launches_by_path, 0)


def reset_ssd() -> None:
    """ssd_scan's launch counters, in all and by kernel path, to 0."""
    from repro_torch.kernels import ops

    ops.ssd_scan.launches = 0
    ops.ssd_scan.launches_by_path = dict.fromkeys(ops.ssd_scan.launches_by_path, 0)


def hopper_only(want: int, kernel: str = "flash_attention") -> dict:
    """`kernel`'s (flash_attention's or ssd_scan's) launches by path when all
    `want` went through its Hopper (TMA and wgmma) kernel."""
    from repro_torch.kernels import ops

    return {p: (want if p == "wgmma_tma" else 0) for p in getattr(ops, kernel).launches_by_path}


def job1_trace():
    from repro_torch.data.traces import load_trace

    x = load_trace("job1", seed=0)
    return x / np.mean(x)  # mean 1, as fleet.trace_workload normalises


def single_job_grid(torch, device, sizes, kind, seed=20261018):
    """(the arguments of `single_job`, ranked) for a grid on Job 1's trace
    at sizes n, n_jobs, m_trials: the benchmark's (perfbench/traffic)
    "frontier", POLICIES, and "general", the baseline, delayed relaunch at 2
    (kill) and 3 (keep, r 1) and a two-stage fork; and "cross", phase
    paper's cross-family grid (`paper_cross_policies`) with group widths n
    // 171 and 2 (6 and 2 at n = 1026; the paper's 5 does not divide 1026).
    Drawn as the engine draws them (`fork_draws` or `policy_draws`, then
    `running_min`)."""
    from repro_torch import core as tcore
    from repro_torch.core.simulate import policy_draws, running_min
    from repro_torch.fleet import vector

    n, shape = sizes["n"], (sizes["m_trials"], sizes["n_jobs"])
    xs = torch.sort(torch.as_tensor(job1_trace(), dtype=torch.float32, device=device)).values
    q = lambda u: vector.emp_quantile(xs, u)  # noqa: E731
    if kind == "frontier":
        pols = [tcore.SingleForkPolicy(*p) for p in POLICIES]
    elif kind == "general":
        pols = [tcore.BASELINE, tcore.delayed_relaunch(2.0, r=0, keep=False),
                tcore.delayed_relaunch(3.0, r=1, keep=True), tcore.MultiForkPolicy(((0.4, 1, True), (0.1, 1, False)))]
    else:
        pols = [tcore.group_replication(0.2, 1, n // 171) if getattr(p.where, "d", None) == 5
                else tcore.group_replication(0.3, 1, 2) if getattr(p.where, "d", None) == 2 else p
                for p in map(tcore.as_fork_policy, paper_cross_policies(tcore))]
    lowered = tcore.lower_policies(pols, n)
    g = torch.Generator(device=device).manual_seed(seed)
    r_cap = lowered.r_max + 1
    if kind == "frontier":
        x, fresh = vector.fork_draws(g, q, shape, n, r_cap)
        cm = running_min(fresh)[None].unsqueeze(-3)
    else:
        x, fresh = policy_draws(g, q, shape, n, r_cap, lowered.n_stages)
        cm = running_min(fresh)[None]
    stages = tuple(torch.as_tensor(v, device=device) for v in (lowered.mode, lowered.k, lowered.t, lowered.r,
                                                                lowered.keep, lowered.d))
    return (x[None], cm) + stages, kind == "frontier"


def single_job_bytes(torch, args, ranked) -> int:
    """The bytes `single_job` has to move for its laws on shared draws: x
    read once, T and C written, and of cm (contiguous, 32-byte sectors of 8
    floats) every sector that holds a column some law reads at one of its
    stragglers' positions.  A quantile stage's stragglers are the positions
    whose rank within their group is >= k; a time stage's, where it is a
    law's first active stage, the positions whose group-sorted draw is > t,
    and at a later stage every position (more than it reads)."""
    x, cm, mode, k, t, r, keep, d = args
    L, S = mode.shape
    n = x.shape[-1]
    rows = x[0].numel() // n
    assert x.shape[0] == 1 and cm.shape[0] == 1, "shared draws"
    read = torch.zeros(cm.shape[1:], dtype=torch.bool, device=cm.device)
    pos = torch.arange(n, device=x.device)
    for law in range(L):
        dl = int(d[law])
        grouped = x[0] if ranked else torch.sort(x[0].unflatten(-1, (n // dl, dl)), dim=-1).values.flatten(-2)
        first = True
        for s in range(S):
            m, kl, rl = int(mode[law, s]), int(k[law, s]), int(r[law, s])
            if m == -1 or (m == 0 and kl >= dl):
                continue
            col = rl - 1 if bool(keep[law, s]) else rl
            if m == 0:
                strag = pos % dl >= kl
            elif first:
                strag = grouped > float(t[law, s])
            else:
                strag = torch.ones_like(pos, dtype=torch.bool)
            first = False
            if col >= 0:
                read[..., s, :, col] |= strag
    flat = read.reshape(-1)
    flat = torch.cat([flat, flat.new_zeros(-flat.numel() % 8)])
    sectors = int(flat.view(-1, 8).any(dim=1).sum())
    return x.numel() * 4 + sectors * 32 + 2 * L * rows * 4


def single_job_chains(torch, args, ranked, laws=4):
    """`single_job_plain` on `laws` laws at a time, as the engine chunks the
    chains (their per-law intermediates are about 4.5 GB a law at full
    size): (T, C) of every law."""
    from repro_torch.kernels.single_job import single_job_plain

    x, cm, rest = args[0], args[1], args[2:]
    parts = [single_job_plain(x, cm, *(v[i:i + laws] for v in rest), ranked=ranked)
             for i in range(0, rest[0].shape[0], laws)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def single_job_kernel_cases(torch, device, sizes, flush) -> list:
    """The single-job kernel against its chains (`single_job_plain`) at the
    benchmark's two grids and phase paper's cross-family grid (group
    selection): T bit-equal, C's largest relative gap within 1e-6, both
    timed in turns on the same inputs, and the byte bound
    (`single_job_bytes`)."""
    from repro_torch.kernels.single_job import single_job

    cases = []
    for kind in ("frontier", "general", "cross"):
        args, ranked = single_job_grid(torch, device, sizes, kind)
        with uncounted():
            T, C = single_job(*args, ranked=ranked)
        T_p, C_p = single_job_chains(torch, args, ranked)
        check(torch.equal(T, T_p), f"single_job {kind}: T bit-equal to the chain")
        gap = float(((C.double() - C_p.double()).abs() / C_p.double().abs()).max())
        check(gap <= 1e-6, f"single_job {kind}: C within 1e-6 of the chain ({gap:.3e})")
        err = float((C - C_p).abs().max())
        del T_p, C_p
        with uncounted():
            times = time_turns(torch, {"kernel": lambda: single_job(*args, ranked=ranked),
                                       "plain": lambda: single_job_chains(torch, args, ranked)},
                               sizes["kernel_reps"], device, flush)
        x, cm = args[:2]
        L, S = args[2].shape
        moved = single_job_bytes(torch, args, ranked)
        cases.append(dict(
            grid=kind, laws=L, stages=S, widths=sorted(set(args[-1].tolist())), rows=x[0].numel() // x.shape[-1],
            n=x.shape[-1], r_cap=cm.shape[-1], ranked=ranked, max_abs_err=err, C_max_rel_gap=gap,
            ms=times["kernel"], plain_ms=times["plain"], library_ms=None, bytes=moved,
            all_of_cm_ms=(x.numel() + cm.numel()) * 4 / HBM_BYTES_PER_S * 1e3, bound=bound(moved, 0),
        ))
        del args, x, cm, T, C
    return cases


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
            args = kw_inputs(torch, device, g if i == 0 else g_loads, B, J, speeds, load)
            case = kw_paths_case(torch, device, args, sizes["kernel_reps"], flush)
            case.update(load=load, plain_ms=time_ms(torch, lambda: kw_queue_plain(*args), sizes["plain_reps"], device))
            if device.type != "cuda":
                case["ms"] = time_ms(torch, lambda: kw_queue(*args), sizes["kernel_reps"], device)
            kw_cases.append(case)

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
    single = single_job_kernel_cases(torch, device, sizes, flush)
    for case in (res_case, *flash, *ssd, *single):
        if "bound" in case:
            case["bound_ms"], case["bound_by"] = case.pop("bound")
    emit("kernels", kw_queue=kw_cases, residual_sample=res_case, flash_attention=flash,
         ssd_scan=ssd, single_job=single,
         tolerance=dict(kw_queue="bit-equal (torch.equal on all four outputs), every kernel path",
                        residual_sample="max exact, sum rtol 1e-5",
                        flash_attention="rtol=atol 2e-5 float32, 2e-2 bfloat16",
                        ssd_scan="rtol=atol 1e-3 float32; atol 2e-1, rtol 5e-2 bfloat16",
                        single_job="T bit-equal, C rtol 1e-6"))
    return dict(kw_queue=kw_cases[0] | {"max_abs_err": max(c["max_abs_err"] for c in kw_cases)},
                residual_sample=res_case, flash_attention=flash[0], ssd_scan=ssd[0],
                single_job=single[0] | {"max_abs_err": max(c["max_abs_err"] for c in single)})


def _close(torch, got, want, rtol, atol, what) -> float:
    got, want = got.float(), want.float()
    check(bool(torch.isfinite(got).all()), f"{what}: finite")
    check(bool(torch.allclose(got, want, rtol=rtol, atol=atol)), f"{what} within rtol={rtol}, atol={atol}")
    return float((got - want).abs().max())


def flash_kernel_cases(torch, device, sizes, g, flush) -> list:
    """flash_attention against its plain version: the main paths' prefill
    shapes (first, causal bf16, timed, with the bound,
    scaled_dot_product_attention's time and, on the card, the mma.sync
    kernel's on the same inputs), then `sizes["flash_cases"]` (FLASH_CASES,
    FLASH_BF16_CASES and FLASH_D16_CASES at full size).  Each case names
    the kernel path that took it."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    timed = [(*shape, True, "bfloat16") for shape in sizes["flash_shapes"]]
    cases = []
    for i, (b, s, h, d, causal, dt) in enumerate((*timed, *sizes["flash_cases"])):
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn((b, s, h, d), generator=g, device=device).to(dtype) for _ in range(3))
        tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
        by_path = dict(flash_attention.launches_by_path)
        err = _close(torch, flash_attention(q, k, v, causal=causal), flash_attention_plain(q, k, v, causal=causal),
                     tol, tol, f"flash_attention {(b, s, h, d, causal, dt)}")
        path = [p for p, n in flash_attention.launches_by_path.items() if n != by_path[p]]
        case = dict(shape=[b, s, h, d], causal=causal, dtype=dt, max_abs_err=err, path=path[0] if path else "plain")
        if i < len(timed):
            elt = q.element_size()
            pairs = s * (s + 1) // 2 if causal else s * s
            if device.type == "cuda":
                check(path == ["wgmma_tma"], f"flash_attention {(b, s, h, d)} took the wgmma_tma kernel, not {path}")
                mma = fa.launch(q, k, v, causal, "mma_sync")
                case["mma_sync_max_abs_err"] = _close(torch, mma, flash_attention_plain(q, k, v, causal=causal), tol, tol,
                                                      f"flash_attention {(b, s, h, d)} on mma_sync")
                case["mma_sync_ms"] = time_ms(torch, lambda: fa.launch(q, k, v, causal, "mma_sync"),
                                              sizes["kernel_reps"], device, flush, ahead=True)
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


def ssd_args(torch, shape, dtype, g, device, carry=False) -> tuple:
    """ssd_scan's (x, dt, A, B, C, D) at `shape` (Bt, S, H, P, G, N) from
    `g`.  With `carry` the state outlives a chunk, as trained weights keep
    it: dt·A sums to about -1 over 128 steps and dt is gated by e^N(0, 1)
    over spans of 64 steps, so most chunks decay by 0.1 to 0.8, each by its
    own amount; without, a chunk decays by about e^-100."""
    bt, s, h, p, gr, n = shape
    x = torch.randn((bt, s, h, p), generator=g, device=device).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn((bt, s, h), generator=g, device=device))
    A = -torch.exp(torch.randn((h,), generator=g, device=device) * 0.3)
    B = torch.randn((bt, s, gr, n), generator=g, device=device).to(dtype)
    C = torch.randn((bt, s, gr, n), generator=g, device=device).to(dtype)
    if carry:
        gate = torch.randn((bt, -(-s // 64), h), generator=g, device=device).exp()
        dt, A = dt * gate.repeat_interleave(64, dim=1)[:, :s], A / 170.0
    return x, dt, A, B, C, torch.ones((h,), device=device)


def ssd_kernel_cases(torch, device, sizes, g, flush) -> list:
    """ssd_scan against its plain version: the main path's shapes
    (`sizes["ssd_shapes"]`, bf16, first, on inputs that carry the state
    across chunks (`ssd_args`), timed, with the bound, the CUDA
    launches per call and, on the card, the mma_sync kernel's error on the
    same inputs and both kernels' times, taken in turns), then
    `sizes["ssd_cases"]` (SSD_CASES and SSD_BF16_CASES at full size).  Each
    case names the kernel path that took it."""
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels.ssd_scan import CUDA_LAUNCHES, ssd_scan, ssd_scan_plain

    timed = [(*shape, "bfloat16") for shape in sizes["ssd_shapes"]]
    cases = []
    for i, (bt, s, h, p, gr, n, q, dt) in enumerate((*timed, *sizes["ssd_cases"])):
        dtype = getattr(torch, dt)
        args = ssd_args(torch, (bt, s, h, p, gr, n), dtype, g, device, carry=i < len(timed))
        x = args[0]
        rtol, atol = (5e-2, 2e-1) if dtype == torch.bfloat16 else (1e-3, 1e-3)
        what = f"ssd_scan {(bt, s, h, p, gr, n, q, dt)}"
        by_path = dict(ssd_scan.launches_by_path)
        y, hf = ssd_scan(*args, chunk=q)
        path = [k for k, c in ssd_scan.launches_by_path.items() if c != by_path[k]]
        y_p, hf_p = ssd_scan_plain(*args, chunk=q)
        err = max(_close(torch, y, y_p, rtol, atol, what + " y"), _close(torch, hf, hf_p, rtol, atol, what + " h_final"))
        case = dict(shape=[bt, s, h, p, gr, n], chunk=q, dtype=dt, max_abs_err=err, path=path[0] if path else "plain")
        if i < len(timed):
            elt = x.element_size()
            nc = -(-s // q)
            if nc > 1:  # a kernel that dropped the carried history would fail
                _, hf_last = ssd_scan_plain(*(t[:, (nc - 1) * q:] if t.dim() > 1 else t for t in args), chunk=q)
                check(not torch.allclose(hf_p, hf_last, rtol=rtol, atol=atol),
                      f"{what}: h_final carries the state of the chunks before the last")
            macs = bt * h * nc * (q * (q + 1) // 2 * (n + p) + 2 * q * p * n)
            if device.type == "cuda":
                check(path == ["wgmma_tma"], f"{what} took the wgmma_tma kernel, not {path}")
                y_m, hf_m = ssd.launch(*args, q, "mma_sync")
                case["mma_sync_max_abs_err"] = max(_close(torch, y_m, y_p, rtol, atol, what + " y on mma_sync"),
                                                   _close(torch, hf_m, hf_p, rtol, atol, what + " h_final on mma_sync"))
                # the two kernels in turns on the same inputs
                case.update(time_turns(torch, {"ms": lambda: ssd_scan(*args, chunk=q),
                                               "mma_sync_ms": lambda: ssd.launch(*args, q, "mma_sync")},
                                       sizes["kernel_reps"], device, flush))
                case["hopper_clusters"] = ssd.hopper_clusters(p, n, nc, device)
            else:
                case["ms"] = time_ms(torch, lambda: ssd_scan(*args, chunk=q), sizes["kernel_reps"], device)
            case.update(
                plain_ms=time_ms(torch, lambda: ssd_scan_plain(*args, chunk=q), sizes["plain_reps"], device),
                library_ms=None, cuda_launches_per_call=CUDA_LAUNCHES[case["path"]] if path else 0,
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


def stage_queue_checks(torch, calls, caller: str = "the DAG's stage") -> list:
    """Each kw_queue call captured from a path (for the DAG, on the inputs
    it gave a stage: barrier releases sorted stably, gang makespans in that
    order) against kw_queue_plain on the same tensors: slots equal, floats
    within rtol = atol = 1e-5 as in phase `kernels`."""
    from repro_torch.kernels.kw_queue import kw_queue, kw_queue_plain

    out = []
    with uncounted():
        for s, (arrivals, services, speeds) in enumerate(calls):
            what = f"kw_queue on {caller} call {s} {tuple(arrivals.shape)}"
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


def phase_dag(torch, device, sizes) -> dict:
    """`dag_frontier` at full width on the three-stage pipeline, then the
    DAG path's checks: the one-stage contract, `tail="hist"`, the joint
    searches, the lowered evaluator, the fault path and the event oracle
    (whose race and gate it returns, from `phase_dag_event`)."""
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
    return phase_dag_event(torch, device, sizes)


def phase_dag_event(torch, device, sizes) -> dict:
    """The port's event engine on the host against `dag_frontier` on the
    device, on benchmarks/bench_dag.py's grid, gated as that benchmark
    gates it: every cell's E[T] within 5 combined standard errors, E[C]
    within 0.1.  Returns the race (for phase dag_gates) and the gate."""
    race = dag_event_grid(torch, device, sizes)
    fused, event = race["fused"], race["event"]
    sigma = [abs(f["mean_sojourn"] - e[0]) / max(math.hypot(f["sojourn_std_err"], e[2]), 1e-12) for f, e in zip(fused, event)]
    cost = [abs(f["mean_cost"] - e[1]) for f, e in zip(fused, event)]
    gates: dict = {}
    hold(gates, "dag_fused_vs_event_agreement", "dag_event", max(sigma) <= 5.0 and max(cost) <= 0.1,
         dict(max_sojourn_sigma=max(sigma), max_cost_dev=max(cost), cells=len(fused)), device)
    emit("dag_event", cells=len(fused), event_s=race["event_s"], fused_s=race["fused_s"], max_sojourn_sigma=max(sigma),
         max_cost_dev=max(cost), max_cost_rel_dev=max(c / e[1] for c, e in zip(cost, event)), sigma=sigma)
    return dict(race=race, gates=gates)


#: benchmarks/bench_fleet.py:83-171, copied (that module imports JAX):
#: ShiftedExp(1, 1) tasks, 16 a job; every grid policy keeps its forks
#: within the n free slots of capacity n, so the event engine never
#: truncates replicas.  Policies are (p, r, keep).  The job and trial
#: counts (600 jobs, 12 trials, ...) are FULL["fleet_gates"]'s.
GATE_DIST = (1.0, 1.0)  # ShiftedExp(shift, rate)
GATE_N_TASKS = 16
GATE_LAMS = (0.05, 0.12, 0.2)
GATE_POLICIES = ((0.0, 0, True), (0.1, 1, True), (0.2, 1, False), (0.4, 1, True))
#: the fused frontier against the per-cell loop: 5 policies x 6 loads
GATE_FRONTIER_POLICIES = GATE_POLICIES + ((0.3, 2, False),)
GATE_FRONTIER_LAMS = (0.05, 0.08, 0.12, 0.16, 0.2, 0.24)
GATE_FRONTIER_SPEEDUP_FLOOR = 5.0
#: the chaos lane: (π × λ × q) on c = 2 gang blocks, retry budget 8; the
#: (r × q) availability table under a budget of 2
GATE_CHAOS_QS = (0.0, 0.1, 0.25)
GATE_CHAOS_LAMS = (0.05, 0.12)
GATE_CHAOS_BLOCKS = 2
GATE_CHAOS_ATTEMPTS = 8
GATE_CHAOS_SPEEDUP_FLOOR = 5.0
GATE_AVAIL_RS = (0, 1, 2)
GATE_AVAIL_QS = (0.0, 0.15, 0.3)
GATE_AVAIL_ATTEMPTS = 2
GATE_AVAIL_LAM = 0.12
#: the cross-family lane's loads (its policies are built in `gate_policies`)
GATE_CROSS_LAMS = (0.05, 0.12, 0.2)
#: the tail observatory: cells with ρ < 0.9; the blamed class 4x slow
GATE_TAIL_RHO_MAX = 0.9
GATE_BLAME_SLOW_SPEED = 0.25
GATE_BLAME_Q = 0.05
#: c > 1: 3 gang blocks, the loads x 3; the heterogeneous mix (4 fast, 2
#: slow at half speed) at λ = 0.45
GATE_C_BLOCKS = 3
GATE_C_LAMS = tuple(3 * lam for lam in GATE_LAMS)
GATE_HET_SLOW_SPEED = 0.5
GATE_HET_LAM = 0.45
#: the reference's seeds (its PRNGKeys) for the port's generators
GATE_SEEDS = dict(frontier=7, cross=23, chaos=29, tail=42, replan=11)
#: gates whose value is a ratio of wall times: held on the card, printed
#: elsewhere; the reference's value of these is a CPU time, not quoted
TIMING_GATES = ("frontier_fusion_speedup", "obs_frontier_overhead", "chaos_frontier_speedup",
                "chaos_obs_overhead", "adaptive_replan_latency", "vector_vs_event_speedup",
                "kw_vs_aligned_event_speedup", "dag_fused_vs_event_speedup")
#: the one gate printed and not held, and why
PRINTED_GATES = {
    "adaptive_replan_latency": "the reference's gate measures JAX re-tracing once per new "
    "candidate-grid size, which its padding avoids; the port runs eagerly, so the unpadded "
    "path has no compile to save and padding only adds device work (ROADMAP Queue 3)",
}
#: the gates phase fleet_adaptive holds (bench_fleet.py:874-930)
ADAPTIVE_GATES = ("adaptive_reoptimized", "adaptive_drift_fired", "adaptive_beats_best_fixed")
#: bench_dag.py:59-84: the joint search's candidates at λ = 0.55
GATE_DAG_SEARCH_LAM = 0.55
GATE_DAG_SEARCH_CANDS = ((0.0, 0, True), (0.05, 1, True), (0.1, 1, True), (0.1, 2, True),
                         (0.1, 1, False), (0.2, 1, True))
GATE_DAG_SPEEDUP_FLOOR = 10.0


def gate_policies() -> dict:
    """The lanes' policy grids as the port's policy objects."""
    from repro_torch.core import MultiForkPolicy, SingleForkPolicy, delayed_relaunch, group_replication

    single = [SingleForkPolicy(*p) for p in GATE_POLICIES]
    return dict(
        policies=single,
        frontier=[SingleForkPolicy(*p) for p in GATE_FRONTIER_POLICIES],
        # bench_fleet.py:141-149: every family of the algebra in one grid
        cross=single[:3] + [
            delayed_relaunch(2.0), delayed_relaunch(3.0, r=1, keep=True),
            group_replication(0.2, 1, GATE_N_TASKS // 4),
            MultiForkPolicy(((0.4, 1, True), (0.1, 1, False))),
        ],
    )


def hold(gates: dict, name: str, phase: str, ok: bool, value: dict, device) -> None:
    """Record gate `name` as held by `phase` with its `value`, and fail
    the script if it does not pass.  A timing gate is checked on the card
    only: elsewhere its ratio is printed."""
    checked = name not in TIMING_GATES or device.type == "cuda"
    gates[name] = dict(held=phase, passed=bool(ok), checked=checked, value=value)
    if checked:
        check(ok, f"gate {name}: {value}")


def _speedup(torch, device, attempts: int, floor: float, slow, fast) -> dict:
    """The reference's retry rule for a speedup gate: up to `attempts`
    rounds of slow() then fast(), keeping the best ratio, stopping once it
    reaches `floor`.  Returns the ratio, both walls of the best round and
    the last round's outputs."""
    best = dict(ratio=0.0)
    for _ in range(attempts):
        slow_out, slow_s, _ = _timed_call(torch, device, slow)
        fast_out, fast_s, _ = _timed_call(torch, device, fast)
        ratio = slow_s / max(fast_s, 1e-9)
        if ratio > best["ratio"]:
            best = dict(ratio=ratio, slow_s=slow_s, fast_s=fast_s)
        if best["ratio"] >= floor:
            break
    return dict(best, slow=slow_out, fast=fast_out)


def _obs_overhead(torch, device, attempts: int, reps: int, round_s: float, fn) -> dict:
    """The recorder's cost on fn: calls with the process-wide recorder off
    and on in turn, each timed alone, and the ratio of the on calls' median
    wall to the off calls'; the best of up to `attempts` rounds, stopping
    at 1.05 (bench_fleet.py:354-398's retry rule).  A round is `reps` calls
    a side, or as many more as one call's wall fits into `round_s`
    seconds.  The reference's ratio is of two blocks' totals, seconds long
    on its CPU; on the card a call takes 2-4 ms and the host's stalls move
    a ratio of totals by more than the 5% the gate allows, even at 0.5 s
    blocks (tools/obs_noise.py, PERF.md).  Every round's ratio and its
    ratio of totals are returned beside the best."""
    from repro_torch.obs import trace

    _, one_s, _ = _timed_call(torch, device, fn)
    reps = max(reps, math.ceil(round_s / max(one_s, 1e-9)))
    best, ratios, total_ratios = dict(ratio=float("inf")), [], []
    for _ in range(attempts):
        rec, walls = trace.Recorder(), {False: [], True: []}
        for i in range(2 * reps):
            on = bool(i % 2)
            if on:
                trace.enable(rec)
            try:
                t0 = time.perf_counter()
                fn()
                _sync(torch, device)
                walls[on].append(time.perf_counter() - t0)
            finally:
                trace.disable()
        off_s, on_s = float(np.median(walls[False])), float(np.median(walls[True]))
        ratios.append(on_s / max(off_s, 1e-9))
        total_ratios.append(sum(walls[True]) / max(sum(walls[False]), 1e-9))
        if ratios[-1] < best["ratio"]:
            best = dict(ratio=ratios[-1], on_median_s=on_s, off_median_s=off_s, reps=reps)
        if best["ratio"] <= 1.05:
            break
    return dict(best, ratios=ratios, total_ratios=total_ratios)


def _mismatches(rows, ref_rows, keys=("mean_sojourn", "mean_cost", "mean_wait", "p50", "p99")) -> int:
    return sum(1 for a, b in zip(rows, ref_rows) for k in keys if a[k] != b[k])


def _max_sigma(rows, ref_rows) -> float:
    return max(abs(a["mean_sojourn"] - b["mean_sojourn"])
               / max(math.hypot(a["sojourn_std_err"], b["sojourn_std_err"]), 1e-12)
               for a, b in zip(rows, ref_rows))


def gate_event_sweep(fg: dict, policies, lams, capacity=None, placement="pooled", fault_qs=None,
                     blocks=None) -> list:
    """bench_fleet.py's `_event_sweep` (and, with `fault_qs`, its
    `_event_chaos_sweep` on c = `blocks` aligned gang blocks): one host
    event run per (π, λ [, q]) cell on that lane's workload."""
    from repro_torch.core import ShiftedExp
    from repro_torch.fleet import FaultSpec, FleetConfig, FleetSim, poisson_workload

    dist, rows = ShiftedExp(*GATE_DIST), []
    for pol in policies:
        for lam in lams:
            for q in fault_qs or (None,):
                jobs = poisson_workload(fg["n_jobs"], rate=lam, n_tasks=GATE_N_TASKS, dist=dist, seed=int(lam * 1e3))
                if q is None:
                    cfg = FleetConfig(capacity=capacity, policy=pol, seed=0, placement=placement)
                else:
                    cfg = FleetConfig(capacity=blocks * GATE_N_TASKS, policy=pol, seed=0, placement="aligned",
                                      fault=FaultSpec(q=q, max_attempts=GATE_CHAOS_ATTEMPTS) if q > 0 else None)
                st = FleetSim(cfg).run(jobs).stats
                rows.append(dict(lam=lam, q=q, policy=pol.label(), mean_sojourn=st.mean_sojourn,
                                 mean_cost=st.mean_cost, sojourn_std_err=st.sojourn_std_err))
    return rows


def gate_shared_cell(torch, device, fg: dict, lam, policy, n_seeds: int, config_kwargs: dict,
                     rollout_kwargs: dict) -> dict:
    """bench_fleet.py's `_shared_cell_agreement`: the event engine's mean
    over `n_seeds` seeds against one `fleet_rollout` of `agree_trials`
    trials; σ combines the seeds' standard error (numpy's population std,
    as the reference) with the rollout's."""
    from repro_torch.core import ShiftedExp
    from repro_torch.fleet import FleetConfig, FleetSim, poisson_workload, vector

    dist, soj, cost = ShiftedExp(*GATE_DIST), [], []
    t0 = time.perf_counter()
    for seed in range(n_seeds):
        jobs = poisson_workload(fg["n_jobs"], rate=lam, n_tasks=GATE_N_TASKS, dist=dist, seed=seed)
        st = FleetSim(FleetConfig(policy=policy, seed=seed, **config_kwargs)).run(jobs).stats
        soj.append(st.mean_sojourn)
        cost.append(st.mean_cost)
    event_s = time.perf_counter() - t0
    res, fused_s, _ = _timed_call(torch, device, lambda: vector.fleet_rollout(
        dist, policy, lam, GATE_N_TASKS, fg["n_jobs"], fg["agree_trials"], seed=0, device=device, **rollout_kwargs))
    sigma = float(np.hypot(np.std(soj) / np.sqrt(n_seeds), res.sojourn_std_err))
    return dict(lam=lam, policy=policy.label(), seeds=n_seeds, event_mean_sojourn=float(np.mean(soj)),
                vector_mean_sojourn=res.mean_sojourn, event_mean_cost=float(np.mean(cost)),
                vector_mean_cost=res.mean_cost,
                sojourn_sigma=abs(float(np.mean(soj)) - res.mean_sojourn) / max(sigma, 1e-12),
                cost_dev=abs(float(np.mean(cost)) - res.mean_cost), event_s=event_s, vector_s=fused_s)


@contextlib.contextmanager
def counted_rollouts(log: list):
    """While the block runs, every `fleet.vector.fleet_rollout` call
    appends its λ to `log`: `sweep_loop` must be one rollout per cell."""
    from repro_torch.fleet import vector

    inner = vector.fleet_rollout

    def recorded(dist, policy, lam, *args, **kwargs):
        log.append(lam)
        return inner(dist, policy, lam, *args, **kwargs)

    vector.fleet_rollout = recorded
    try:
        yield
    finally:
        vector.fleet_rollout = inner


def kw_gate_inputs(torch, device):
    """bench_kernels.py:76-82's batch: 96 queues of 384 jobs on slots of
    speeds (1, 1, 0.5), gaps Exp(1)/0.5, services 1 + Exp(1)."""
    g = torch.Generator(device=device).manual_seed(3)
    B, J = 96, 384
    arrivals = torch.cumsum(torch.empty((B, J), device=device).exponential_(generator=g) / 0.5, dim=1)
    services = 1.0 + torch.empty((B, J), device=device).exponential_(generator=g)
    return arrivals, services, torch.tensor([1.0, 1.0, 0.5], device=device)


def phase_fleet_gates(torch, device, sizes) -> dict:
    """benchmarks/bench_fleet.py's single-stage lanes through the port's
    entry points on `device`, the event oracle on the host: the gates of
    BENCH_fleet.json that earlier phases do not hold, at the reference's
    grids, seeds, thresholds and retry rules (rows 1-18 and 20-21 of the
    gate table in PERF.md).  One JSON line per lane; returns the gates."""
    from repro_torch.core import ShiftedExp, SingleForkPolicy, as_fork_policy
    from repro_torch.faults import FaultSpec
    from repro_torch.fleet import FleetConfig, FleetPolicyController, FleetSim, MachineClass, poisson_workload, vector
    from repro_torch.kernels.kw_queue import kw_queue, kw_queue_plain
    from repro_torch.obs import StragglerBlame, trace

    fg = sizes["fleet_gates"]
    J, m, tries = fg["n_jobs"], fg["m_trials"], fg["attempts"]
    dist, n, pols = ShiftedExp(*GATE_DIST), GATE_N_TASKS, gate_policies()
    gates: dict = {}

    def lane(name, t0, **fields):
        emit("fleet_gates", lane=name, wall_s=time.perf_counter() - t0, **fields)

    def front(policies, lams, seed, **kw):
        return vector.frontier(dist, policies, lams, n, J, m_trials=m, seed=seed, device=device, **kw)

    # row 1: the kernel at the gate's own shape, bit for bit
    t0 = time.perf_counter()
    with uncounted():
        args = kw_gate_inputs(torch, device)
        got, want = kw_queue(*args), kw_queue_plain(*args)
    equal = [bool(torch.equal(a, b)) for a, b in zip(got, want)]
    err = max(float((a.double() - b.double()).abs().max()) for a, b in zip(got, want))
    hold(gates, "kw_queue_kernel_allclose", "kernels, fleet_gates", all(equal) and err <= 1e-5,
         dict(shape=[96, 384, 3], max_abs_err=err, bit_equal=equal), device)
    lane("kw_queue_kernel", t0, gates={"kw_queue_kernel_allclose": gates["kw_queue_kernel_allclose"]})

    # rows 2-3: the fused frontier against the per-cell loop
    t0 = time.perf_counter()
    fpols, flams, fseed = pols["frontier"], GATE_FRONTIER_LAMS, GATE_SEEDS["frontier"]
    front(fpols, flams, fseed)  # first calls: the allocator's pools, the libraries' handles
    rollouts: list = []
    with counted_rollouts(rollouts):
        vector.sweep_loop(dist, fpols, flams[:1], n, J, m_trials=m, seed=fseed, device=device)
        check(len(rollouts) == len(fpols), f"sweep_loop: one fleet_rollout per cell ({len(rollouts)})")
        rollouts.clear()
        race = _speedup(torch, device, tries, GATE_FRONTIER_SPEEDUP_FLOOR,
                        lambda: vector.sweep_loop(dist, fpols, flams, n, J, m_trials=m, seed=fseed, device=device),
                        lambda: front(fpols, flams, fseed))
    cells = len(fpols) * len(flams)
    check(len(rollouts) % cells == 0 and rollouts[:cells] == list(flams) * len(fpols),
          f"sweep_loop: one fleet_rollout per cell, policy-major ({len(rollouts)} calls)")
    fused, loop = race["fast"], race["slow"]
    hold(gates, "frontier_fusion_speedup", "fleet_gates", race["ratio"] >= GATE_FRONTIER_SPEEDUP_FLOOR,
         dict(speedup=race["ratio"], loop_s=race["slow_s"], fused_s=race["fast_s"], cells=cells,
              rollouts_per_loop=cells), device)
    dev = _max_sigma(fused, loop)
    hold(gates, "frontier_fusion_agreement", "fleet_gates", dev <= 5.0, dict(max_cell_sigma=dev, cells=cells), device)
    lane("frontier_fusion", t0, gates={k: gates[k] for k in ("frontier_fusion_speedup", "frontier_fusion_agreement")})

    # row 4: the recorder's cost on the fused frontier
    t0 = time.perf_counter()
    obs = _obs_overhead(torch, device, tries, fg["obs_reps"], fg["obs_round_s"], lambda: front(fpols, flams, fseed))
    hold(gates, "obs_frontier_overhead", "fleet_gates", obs["ratio"] <= 1.05, obs, device)
    lane("obs_frontier_overhead", t0, gates={"obs_frontier_overhead": gates["obs_frontier_overhead"]})

    # row 5: device-histogram tails against the exact keys
    t0 = time.perf_counter()
    hist, hist_s, _ = _timed_call(torch, device, lambda: front(fpols, flams, fseed, tail="hist"))
    hist_dev = max(abs(h["p99"] - f["p99"]) / max(f["p99"], 1e-12) for h, f in zip(hist, fused))
    hold(gates, "hist_tail_agreement", "fleet_gates", hist_dev <= 0.15,
         dict(max_p99_rel_dev=hist_dev, cells=len(hist), hist_s=hist_s, exact_s=race["fast_s"]), device)
    lane("hist_tail", t0, gates={"hist_tail_agreement": gates["hist_tail_agreement"]})

    # rows 6 and 8: the algebra's single-fork twins and a disabled
    # FaultSpec take the plain program, bit for bit, at the reference's
    # grid and at phase frontier's full width
    t0 = time.perf_counter()
    twins = front([as_fork_policy(p) for p in fpols], flams, fseed)
    q0 = front(fpols, flams, fseed, fault=FaultSpec(q=0.0))
    inp = frontier_inputs(sizes)
    wide = dict(n=sizes["n"], n_jobs=sizes["n_jobs"], m_trials=sizes["m_trials"], seed=0, c=sizes["c"], device=device)
    w_plain = vector.frontier(inp["emp"], inp["policies"], inp["lams"], **wide)
    w_twins = vector.frontier(inp["emp"], [as_fork_policy(p) for p in inp["policies"]], inp["lams"], **wide)
    w_q0 = vector.frontier(inp["emp"], inp["policies"], inp["lams"], fault=FaultSpec(q=0.0), **wide)
    for name, got_ref, got_wide in (("algebra_single_fork_bitwise", twins, w_twins), ("chaos_q0_bitwise", q0, w_q0)):
        hold(gates, name, "fleet_gates", _mismatches(got_ref, fused) == 0 and _mismatches(got_wide, w_plain) == 0,
             dict(mismatched_fields=_mismatches(got_ref, fused), cells=len(fused),
                  full_width=dict(mismatched_fields=_mismatches(got_wide, w_plain), cells=len(w_plain),
                                  n=sizes["n"], c=sizes["c"], n_jobs=sizes["n_jobs"], m_trials=sizes["m_trials"]),
                  keys=5), device)
    del inp
    lane("bitwise", t0, gates={k: gates[k] for k in ("algebra_single_fork_bitwise", "chaos_q0_bitwise")})

    # row 7: a grid mixing every family is one device dispatch
    t0 = time.perf_counter()
    front(pols["cross"], GATE_CROSS_LAMS, GATE_SEEDS["cross"])
    rec = trace.enable()
    try:
        cross, cross_s, _ = _timed_call(torch, device, lambda: front(pols["cross"], GATE_CROSS_LAMS, GATE_SEEDS["cross"]))
    finally:
        trace.disable()
    _finite_rows([dict(r, label=r["policy"]) for r in cross], "cross-family frontier")
    spans = rec.spans_named("frontier_dispatch")
    n_cross = len(pols["cross"]) * len(GATE_CROSS_LAMS)
    hold(gates, "cross_family_one_dispatch", "fleet_gates",
         len(spans) == 1 and spans[0].args["cells"] == n_cross,
         dict(dispatches=len(spans), cells=spans[0].args["cells"] if spans else 0, of=n_cross, wall_s=cross_s), device)
    lane("cross_family", t0, gates={"cross_family_one_dispatch": gates["cross_family_one_dispatch"]})

    # rows 9-11: the failure-aware (π × λ × q) frontier on c = 2 blocks
    t0 = time.perf_counter()
    chaos_pols = pols["policies"][:2]
    specs = tuple(FaultSpec(q=q, max_attempts=GATE_CHAOS_ATTEMPTS) for q in GATE_CHAOS_QS)

    def chaos():
        return front(chaos_pols, GATE_CHAOS_LAMS, GATE_SEEDS["chaos"], c=GATE_CHAOS_BLOCKS, fault=specs)

    chaos()
    race_c = _speedup(torch, device, tries, GATE_CHAOS_SPEEDUP_FLOOR,
                      lambda: gate_event_sweep(fg, chaos_pols, GATE_CHAOS_LAMS, fault_qs=GATE_CHAOS_QS,
                                               blocks=GATE_CHAOS_BLOCKS), chaos)
    hold(gates, "chaos_frontier_speedup", "fleet_gates", race_c["ratio"] >= GATE_CHAOS_SPEEDUP_FLOOR,
         dict(speedup=race_c["ratio"], event_s=race_c["slow_s"], fused_s=race_c["fast_s"], cells=len(race_c["fast"])),
         device)
    check([(r["lam"], r["q"]) for r in race_c["fast"]] == [(e["lam"], e["q"]) for e in race_c["slow"]],
          "chaos cells in the event sweep's order")
    dev_c = _max_sigma(race_c["fast"], race_c["slow"])
    hold(gates, "chaos_event_agreement", "fleet_gates", dev_c <= 5.0,
         dict(max_cell_sigma=dev_c, cells=len(race_c["fast"])), device)
    obs_c = _obs_overhead(torch, device, tries, fg["obs_reps"], fg["obs_round_s"], chaos)
    hold(gates, "chaos_obs_overhead", "fleet_gates", obs_c["ratio"] <= 1.05, obs_c, device)

    # row 12: replication buys back availability under a retry budget of 2
    avail = {}
    for r in GATE_AVAIL_RS:
        pol = SingleForkPolicy(0.95, r, False)
        for q in GATE_AVAIL_QS:
            jobs = poisson_workload(fg["avail_jobs"], rate=GATE_AVAIL_LAM, n_tasks=n, dist=dist, seed=17)
            rep = FleetSim(FleetConfig(capacity=4 * n, policy=pol, seed=17,
                                       fault=FaultSpec(q=q, max_attempts=GATE_AVAIL_ATTEMPTS) if q > 0 else None)).run(jobs)
            avail[f"r{r}_q{q}"] = 1.0 - rep.stats.failed_job_share
    hold(gates, "chaos_availability_replication", "fleet_gates",
         all(avail[f"r1_q{q}"] >= avail[f"r0_q{q}"] for q in GATE_AVAIL_QS if q > 0), dict(availability=avail), device)
    lane("chaos", t0, gates={k: gates[k] for k in ("chaos_frontier_speedup", "chaos_event_agreement",
                                                     "chaos_obs_overhead", "chaos_availability_replication")})

    # row 13: the controller's re-plans, padded against unpadded: printed
    t0 = time.perf_counter()
    samples = np.random.default_rng(0).exponential(1.0, 2048) + 0.5
    grid = FleetPolicyController(device=device)._candidates()
    r_cap = max(p.r for p in grid) + 1
    sizes_r = tuple(len(grid) - o for o in (0, 4, 9))
    walls = {}
    for padded in (True, False):
        def search(sz, seed, padded=padded):
            return vector.policy_search(samples, grid[:sz], lam=0.4, n=n, n_jobs=fg["replan_jobs"],
                                        m_trials=fg["replan_trials"], c=GATE_C_BLOCKS, seed=seed, device=device,
                                        pad_candidates=padded, r_cap=r_cap if padded else None)

        search(sizes_r[0], GATE_SEEDS["replan"])
        _, walls[padded], _ = _timed_call(torch, device, lambda: [search(sz, 13 + rep) for rep in range(2) for sz in sizes_r])
    gates["adaptive_replan_latency"] = dict(
        held="printed", passed=None, checked=False, reason=PRINTED_GATES["adaptive_replan_latency"],
        value=dict(padded_s=walls[True], unpadded_s=walls[False], sizes=list(sizes_r), repeats=2))
    lane("replan_latency", t0, gates={"adaptive_replan_latency": gates["adaptive_replan_latency"]})

    # rows 14-15: the event engine against the fused sweep, c = 1 and c = 3
    t0 = time.perf_counter()
    base = pols["policies"]
    vector.sweep(dist, base, GATE_LAMS, n, J, m_trials=m, device=device)
    race1 = _speedup(torch, device, tries, 10.0, lambda: gate_event_sweep(fg, base, GATE_LAMS, capacity=n),
                     lambda: vector.sweep(dist, base, GATE_LAMS, n, J, m_trials=m, device=device))
    hold(gates, "vector_vs_event_speedup", "fleet_gates", race1["ratio"] >= 10.0,
         dict(speedup=race1["ratio"], event_s=race1["slow_s"], vector_s=race1["fast_s"], cells=len(race1["fast"])),
         device)
    vector.sweep(dist, base, GATE_C_LAMS, n, J, m_trials=m, c=GATE_C_BLOCKS, device=device)
    race3 = _speedup(torch, device, tries, 10.0,
                     lambda: gate_event_sweep(fg, base, GATE_C_LAMS, capacity=GATE_C_BLOCKS * n, placement="aligned"),
                     lambda: vector.sweep(dist, base, GATE_C_LAMS, n, J, m_trials=m, c=GATE_C_BLOCKS, device=device))
    hold(gates, "kw_vs_aligned_event_speedup", "fleet_gates", race3["ratio"] >= 10.0,
         dict(speedup=race3["ratio"], event_s=race3["slow_s"], vector_s=race3["fast_s"], cells=len(race3["fast"]),
              c=GATE_C_BLOCKS), device)
    lane("sweep_race", t0, gates={k: gates[k] for k in ("vector_vs_event_speedup", "kw_vs_aligned_event_speedup")},
         sweep_sigma=dict(c1=_max_sigma(race1["fast"], race1["slow"]), c3=_max_sigma(race3["fast"], race3["slow"])))

    # rows 16-18: one shared cell against the event engine's seeds
    t0 = time.perf_counter()
    seeds = fg["seeds"]
    c3 = gate_shared_cell(torch, device, fg, GATE_C_LAMS[1], base[1], seeds["c3"],
                          dict(capacity=GATE_C_BLOCKS * n, placement="aligned"), dict(c=GATE_C_BLOCKS))
    hold(gates, "kw_event_agreement_c3", "fleet_gates", c3["sojourn_sigma"] <= 5.0 and c3["cost_dev"] <= 0.1, c3, device)
    mix = (MachineClass("fast", 4 * n, 1.0), MachineClass("slow", 2 * n, GATE_HET_SLOW_SPEED))
    het = gate_shared_cell(torch, device, fg, GATE_HET_LAM, base[1], seeds["het"],
                           dict(classes=mix, placement="aligned"), dict(classes=mix))
    hold(gates, "hetero_event_agreement", "fleet_gates", het["sojourn_sigma"] <= 5.0, dict(het, mix="4fast+2slow"),
         device)
    c1 = gate_shared_cell(torch, device, fg, 0.12, base[1], seeds["c1"], dict(capacity=n), {})
    hold(gates, "vector_event_agreement_c1", "fleet_gates", c1["sojourn_sigma"] <= 5.0 and c1["cost_dev"] <= 0.1, c1,
         device)
    lane("shared_cells", t0, gates={k: gates[k] for k in ("kw_event_agreement_c3", "hetero_event_agreement",
                                                         "vector_event_agreement_c1")})

    # row 20: the EVT p999 from few trials against raw Monte Carlo of many
    t0 = time.perf_counter()
    few, many = fg["tail_trials"]
    tj = fg["tail_jobs"]
    ref = vector.frontier(dist, fpols, flams, n, tj, m_trials=many, seed=GATE_SEEDS["tail"], device=device)
    evt = vector.frontier(dist, fpols, flams, n, tj, m_trials=few, seed=GATE_SEEDS["tail"], tail="hist", device=device)
    devs = [abs(e["evt_p999"] - r["p999"]) / max(r["p999"], 1e-12) for r, e in zip(ref, evt)
            if r["rho"] < GATE_TAIL_RHO_MAX and math.isfinite(e["evt_p999"])]
    check(len(devs) > 0, "tail_evt_p999: stable cells with a finite fit")
    med, top = float(np.median(devs)), float(np.max(devs))
    hold(gates, "tail_evt_p999", "fleet_gates", med <= 0.15 and top <= 0.6,
         dict(median_rel_dev=med, max_rel_dev=top, stable_cells=len(devs), trials=[few, many], n_jobs=tj), device)

    # row 21: counterfactual blame convicts a planted 4x-slow class
    classes = (MachineClass("fast", 2 * n, 1.0), MachineClass("slow", 2 * n, GATE_BLAME_SLOW_SPEED))
    jobs = poisson_workload(fg["blame_jobs"], rate=0.5, n_tasks=n, dist=dist, seed=21)
    rep = FleetSim(FleetConfig(classes=classes, placement="aligned", seed=21,
                               fault=FaultSpec(q=GATE_BLAME_Q, max_attempts=8))).run(jobs)
    ranking = StragglerBlame(quantile=0.9, min_samples=12).observe_records(rep.records).ranking()
    top_name = ranking[0].name if ranking else None
    hold(gates, "tail_blame_planted", "fleet_gates", top_name == "slow",
         dict(top=top_name, score=ranking[0].score if ranking else None,
              ranking=[(b.name, b.score) for b in ranking]), device)
    lane("tail", t0, gates={k: gates[k] for k in ("tail_evt_p999", "tail_blame_planted")})
    return gates


def dag_event_grid(torch, device, sizes) -> dict:
    """bench_dag.py's race: its two-stage grid on the host's event engine
    (`DagFleetSim`), then the same grid as one `dag_frontier` call on
    `device`.  Returns both rows and walls."""
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
    return dict(event=event, fused=fused, event_s=event_s, fused_s=fused_s)


def phase_dag_gates(torch, device, sizes, first_race=None) -> dict:
    """bench_dag.py's two gates that phase dag_event does not hold:
    `dag_fused_vs_event_speedup` (≥ 10x, best of 3 rounds; `first_race`,
    phase dag_event's walls, is the first round) and
    `dag_joint_dominates_uniform` (the exhaustive per-stage search at λ =
    0.55, 256 jobs x 16 trials, strictly below the best uniform vector in
    E[T] and in E[C], on the map → reduce demo of the stage traces)."""
    from repro_torch.core import SingleForkPolicy
    from repro_torch.dag import JobDAG, best_stable, dag_frontier, exhaustive_search, uniform_vectors
    from repro_torch.data.traces import load_stage_trace

    gates: dict = {}
    t0 = time.perf_counter()
    rounds = [first_race] if first_race else []
    while len(rounds) < 3 and not any(r["event_s"] / max(r["fused_s"], 1e-9) >= GATE_DAG_SPEEDUP_FLOOR
                                      for r in rounds):
        rounds.append(dag_event_grid(torch, device, sizes))
    best = max(rounds, key=lambda r: r["event_s"] / max(r["fused_s"], 1e-9))
    ratio = best["event_s"] / max(best["fused_s"], 1e-9)
    hold(gates, "dag_fused_vs_event_speedup", "dag_gates", ratio >= GATE_DAG_SPEEDUP_FLOOR,
         dict(speedup=ratio, event_s=best["event_s"], fused_s=best["fused_s"], rounds=len(rounds),
              cells=len(EVENT_VECTORS) * len(EVENT_LAMS)), device)
    emit("dag_gates", lane="dag_race", wall_s=time.perf_counter() - t0,
         gates={"dag_fused_vs_event_speedup": gates["dag_fused_vs_event_speedup"]})

    t0 = time.perf_counter()
    dg = sizes["dag_gates"]
    demo = JobDAG.map_reduce(8, 4, load_stage_trace("map"), load_stage_trace("reduce"), c_map=2, c_reduce=1)
    cands = [SingleForkPolicy(*p) for p in GATE_DAG_SEARCH_CANDS]
    lam = GATE_DAG_SEARCH_LAM
    ex, ex_s, _ = _timed_call(torch, device, lambda: exhaustive_search(
        demo, cands, lam=lam, n_jobs=dg["n_jobs"], m_trials=dg["m_trials"], seed=0, device=device))
    uni_rows = dag_frontier(demo, uniform_vectors(demo, cands), (lam,), dg["n_jobs"], m_trials=dg["m_trials"], seed=0,
                            r_caps=(3, 3), device=device)
    uniform, joint = best_stable(uni_rows), ex["best"]
    # the joint grid holds the uniform vectors on the same draws (a mean
    # over another number of cells may round differently on the card)
    same = next(r for r in ex["rows"] if r["label"] == uniform["label"])
    check(abs(same["mean_sojourn"] - uniform["mean_sojourn"]) <= 1e-6 * uniform["mean_sojourn"],
          f"the joint grid's uniform cell {same['mean_sojourn']} on the uniform grid's draws {uniform['mean_sojourn']}")
    keys = ("label", "mean_sojourn", "mean_cost", "sojourn_std_err", "rho")
    hold(gates, "dag_joint_dominates_uniform", "dag_gates",
         joint["mean_sojourn"] < uniform["mean_sojourn"] and joint["mean_cost"] < uniform["mean_cost"],
         dict(joint={k: joint[k] for k in keys}, uniform={k: uniform[k] for k in keys}, cells=ex["n_cells"],
              search_s=ex_s), device)
    emit("dag_gates", lane="joint_search", wall_s=time.perf_counter() - t0,
         gates={"dag_joint_dominates_uniform": gates["dag_joint_dominates_uniform"]})
    return gates


def paper_cross_policies(core) -> list:
    """bench_trace.py:39-48's CROSS_GRID, one representative a family, as
    `core`'s policies (the port's `repro_torch.core`, or the reference's
    `repro.core` in tools/paper_reference.py)."""
    return [
        core.BASELINE,
        core.SingleForkPolicy(0.1, 1, True),
        core.SingleForkPolicy(0.2, 1, False),
        core.SingleForkPolicy(0.3, 2, False),
        core.delayed_relaunch(2.0),
        core.delayed_relaunch(1.5, r=1, keep=True),
        core.group_replication(0.2, 1, 5),
        core.group_replication(0.3, 1, 2),
        core.MultiForkPolicy(((0.4, 1, True), (0.1, 1, False))),
    ]


def _dominates(b: dict, a: dict) -> bool:
    return (b["mean_cost"] <= a["mean_cost"] and b["mean_sojourn"] <= a["mean_sojourn"]
            and (b["mean_cost"] < a["mean_cost"] or b["mean_sojourn"] < a["mean_sojourn"]))


def pareto_front(rows) -> list:
    """bench_trace.py:51-62: indices of the rows not dominated in
    (mean_cost, mean_sojourn)."""
    return [i for i, a in enumerate(rows) if not any(_dominates(b, a) for b in rows)]


def curve_key(r: int, keep: bool) -> str:
    return f"r{r}_{'keep' if keep else 'kill'}"


def paper_reference(pp: dict) -> dict:
    """tools/paper_reference.json's section `pp["reference"]`, after
    checking that it was computed on `pp`'s grids and sizes."""
    doc = json.loads((ROOT / "tools" / "paper_reference.json").read_text())
    section = doc["sections"][pp["reference"]]
    want = json.loads(json.dumps({k: v for k, v in pp.items() if k != "reference"}))
    check(section["sizes"] == want, f"tools/paper_reference.json's {pp['reference']} sizes {section['sizes']} == {want}")
    return dict(section, commit=doc["commit"])


def _sigma(got: float, got_se: float, want: float, want_se: float) -> float:
    return abs(got - want) / max(math.hypot(got_se, want_se), 1e-12)


def _rel(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-300)


def _paper_grid(name: str, t0: float, **fields) -> dict:
    out = dict(grid=name, wall_s=time.perf_counter() - t0, **fields)
    emit("paper", **out)
    return out


def _estimate_row(est) -> dict:
    return dict(latency=est.latency, cost=est.cost, latency_se=est.latency_stderr, cost_se=est.cost_stderr)


def _held_estimate(got: dict, want: dict, what: str) -> float:
    """The larger of E[T]'s and E[C]'s distances in combined standard
    errors; fails past PAPER_SIGMAS."""
    worst = max(_sigma(got["latency"], got["latency_se"], want["latency"], want["latency_se"]),
                _sigma(got["cost"], got["cost_se"], want["cost"], want["cost_se"]))
    check(worst <= PAPER_SIGMAS, f"{what}: {got} against the reference's {want} ({worst:.2f} sigma)")
    return worst


def paper_fig35(core, device, pp, ref) -> dict:
    """Figs. 3/5: `simulate` at m trials for every n x policy on ShiftedExp(1,
    1) and Pareto(2, 2): E[T] and E[C] within 5σ of the reference's, the
    closed form the reference's (1e-9; Theorem 3's π_keep branch, a float32
    quadrature, to PAPER_QUADRATURE_RTOL), and each cell's relative gap to
    Theorem 2/3 beside the reference's own."""
    t0, worst, gaps, ref_gaps, cells = time.perf_counter(), 0.0, [], [], 0
    for fig, name, args, thm in PAPER_FIG35:
        dist = getattr(core, name)(*args)
        for p, r, keep in PAPER_FIG35_POLICIES:
            pol = core.SingleForkPolicy(p, r, keep)
            for n in pp["fig35_ns"]:
                want = ref["fig35"][fig][f"{curve_key(r, keep)}_p{p}_n{n}"]
                sim = core.simulate(dist, pol, n, m=pp["fig35_m"], seed=n, device=device)
                got = dict(latency=sim.mean_latency, cost=sim.mean_cost, latency_se=sim.latency_std_err,
                           cost_se=sim.cost_std_err)
                worst = max(worst, _held_estimate(got, want, f"{fig} {pol.label()} n={n}"))
                analytic = getattr(core, thm)(dist, pol, n)
                rtol = PAPER_QUADRATURE_RTOL if (thm, keep) == ("theorem3_latency", True) else PAPER_CLOSED_FORM_RTOL
                check(_rel(analytic, want["analytic"]) <= rtol,
                      f"{fig} {pol.label()} n={n}: {thm} {analytic} against {want['analytic']}")
                gaps.append(_rel(analytic, got["latency"]))
                ref_gaps.append(_rel(analytic, want["latency"]))
                cells += 1
    return _paper_grid("fig3_fig5", t0, cells=cells, max_sigma=worst, worst_gap_to_theorem=max(gaps),
                       reference_worst_gap_to_theorem=max(ref_gaps), mean_gap=float(np.mean(gaps)),
                       reference_mean_gap=float(np.mean(ref_gaps)))


def paper_fig46(core, pp, ref) -> dict:
    """Figs. 4/6 (Theorem 1 by quadrature, `analytic_evaluator`, on the host)
    and Corollary 1 (Theorem 3's closed form): every curve point within
    PAPER_QUADRATURE_RTOL of the reference's and every fitted exponent within
    PAPER_CLOSED_FORM_RTOL; the best E[T] speedup at the baseline's cost."""
    t0, worst, speedups = time.perf_counter(), 0.0, {}
    for fig, name, args in PAPER_FIG46:
        ev = core.analytic_evaluator(getattr(core, name)(*args), PAPER_FIG46_N)
        want = ref["fig46"][fig]
        base = ev(core.BASELINE)
        worst = max(worst, *(_rel(a, b) for a, b in zip(base, want["baseline"])))
        points = []
        for r, keep in PAPER_FIG46_CURVES:
            for e, w in zip(core.tradeoff_curve(ev, r, keep, pp["fig46_p"]), want["curves"][curve_key(r, keep)]):
                worst = max(worst, _rel(e.latency, w[1]), _rel(e.cost, w[2]))
                points.append((e.latency, e.cost))
        best = min((lat for lat, cost in points if cost <= base[1] * 1.001), default=base[0])
        speedups[fig] = dict(speedup=base[0] / best, reference=want["best_speedup_at_iso_cost"])
    check(worst <= PAPER_QUADRATURE_RTOL, f"Figs. 4/6: a point {worst:.2e} relative from the reference's")
    fits, worst_fit = [], 0.0
    for alpha in PAPER_SCALING_ALPHAS:
        dist = core.Pareto(alpha, 2.0)
        for r in PAPER_SCALING_RS:
            pol = core.SingleForkPolicy(PAPER_SCALING_P, r, False)
            first = 2.0 * PAPER_SCALING_P ** (-1.0 / alpha)  # bench_scaling.py:22, n-independent
            growth = [core.theorem3_latency(dist, pol, n) - first for n in pp["scaling_ns"]]
            slope = float(np.polyfit(np.log(pp["scaling_ns"]), np.log(growth), 1)[0])
            want = next(w for w in ref["scaling"] if w["alpha"] == alpha and w["r"] == r)
            worst_fit = max(worst_fit, _rel(slope, want["fitted"]))
            fits.append(dict(alpha=alpha, r=r, fitted=slope, theory=core.corollary1_exponent(alpha, r)))
    check(worst_fit <= PAPER_CLOSED_FORM_RTOL, f"Corollary 1: an exponent {worst_fit:.2e} relative from the reference's")
    return _paper_grid("fig4_fig6_corollary1", t0, max_rel=worst, max_rel_exponent=worst_fit,
                       best_speedup_at_iso_cost=speedups, exponents=fits)


def paper_trace(core, device, pp, ref) -> dict:
    """Figs. 7-10: Algorithm 1 (`estimate`) at m replicates on each
    synthesized trace job, over p x r x keep/kill and the baseline, within 5σ
    of the reference's; the headline latency cut and cost delta per job
    (bench_trace.py:133-137: π_keep(p, 1)'s fastest and cheapest points)."""
    from repro_torch.data.traces import synthesize_trace

    t0, worst, cells, heads = time.perf_counter(), 0.0, 0, {}
    for job in pp["trace_jobs"]:
        trace, want = synthesize_trace(job), ref["trace"][job]
        base = _estimate_row(core.estimate(trace, core.BASELINE, m=pp["trace_m"], seed=0, device=device))
        worst = max(worst, _held_estimate(base, want["baseline"], f"{job} baseline"))
        keep1 = []
        for r in PAPER_TRACE_RS:
            for keep in (True, False):
                for p, w in zip(pp["trace_p"], want["curves"][curve_key(r, keep)]):
                    got = _estimate_row(core.estimate(trace, core.SingleForkPolicy(p, r, keep), m=pp["trace_m"],
                                                      seed=1, device=device))
                    worst = max(worst, _held_estimate(got, w, f"{job} {curve_key(r, keep)} p={p}"))
                    cells += 1
                    if (r, keep) == (1, True):
                        keep1.append(got)
        heads[job] = dict(latency_cut=1.0 - min(e["latency"] for e in keep1) / base["latency"],
                          cost_delta=min(e["cost"] for e in keep1) / base["cost"] - 1.0,
                          reference=want["headline"])
    return _paper_grid("fig7_fig10", t0, cells=cells + len(pp["trace_jobs"]), max_sigma=worst, headline=heads)


def paper_cross(core, device, pp, ref) -> dict:
    """The cross-family table: one `frontier` call a stage trace over every
    family's representative and both loads, its queue through the kw_queue
    kernel (c = 1); mean_sojourn and mean_cost within 5σ by the rows'
    sojourn_std_err (the rows carry no cost error), and each Pareto mark the
    reference's unless the comparison that decides it is within 5σ (a
    near-tie, counted).  Each kw_queue call is captured and held against
    kw_queue_plain on the same inputs (uncounted)."""
    import torch

    from repro_torch.core import Empirical
    from repro_torch.data.traces import load_stage_trace
    from repro_torch.fleet import vector

    t0, worst, near, cells, marks, queues = time.perf_counter(), 0.0, [], 0, 0, []
    grid = paper_cross_policies(core)
    for stage in pp["cross_stages"]:
        calls: list = []
        with captured_queue_calls(calls):
            rows = vector.frontier(Empirical(load_stage_trace(stage)), grid, PAPER_CROSS_LAMS, PAPER_CROSS_N,
                                   pp["cross_jobs"], m_trials=pp["cross_trials"], seed=PAPER_CROSS_SEED, kernel=True,
                                   device=device)
        check(len(calls) == 1, f"{stage}: one kw_queue call ({len(calls)})")
        queues.extend(dict(stage=stage, **q) for q in stage_queue_checks(torch, calls, f"the {stage} frontier's"))
        del calls
        for lam in PAPER_CROSS_LAMS:
            cell = [r for r in rows if abs(r["lam"] - lam) < 1e-12]
            want = ref["cross"][stage][str(lam)]
            check([r["policy"] for r in cell] == [w["policy"] for w in want], f"{stage} λ={lam}: the rows' policies")
            for a, w in zip(cell, want):
                se = math.hypot(a["sojourn_std_err"], w["sojourn_std_err"])
                d = max(abs(a["mean_sojourn"] - w["mean_sojourn"]), abs(a["mean_cost"] - w["mean_cost"])) / se
                check(d <= PAPER_SIGMAS, f"{stage} λ={lam} {a['policy']}: {d:.2f} sigma from the reference")
                worst, cells = max(worst, d), cells + 1
            front = set(pareto_front(cell))
            for i, (a, w) in enumerate(zip(cell, want)):
                marks += 1
                if (i in front) == w["on_front"]:
                    continue
                # the rows b whose domination of a the two packages decide
                # differently: each must be within 5σ of a on E[T] or E[C]
                ref_dom = [j for j in range(len(want)) if j != i and _dominates(want[j], want[i])]
                got_dom = [j for j in range(len(cell)) if j != i and _dominates(cell[j], cell[i])]
                deciding = set(ref_dom) ^ set(got_dom)
                ties = [j for j in deciding if min(
                    abs(cell[j]["mean_sojourn"] - a["mean_sojourn"]), abs(cell[j]["mean_cost"] - a["mean_cost"]))
                    <= PAPER_SIGMAS * math.hypot(cell[j]["sojourn_std_err"], a["sojourn_std_err"])]
                check(deciding and len(ties) == len(deciding),
                      f"{stage} λ={lam} {a['policy']}: on the front {i in front}, the reference's {w['on_front']}")
                near.append(dict(stage=stage, lam=lam, policy=a["policy"], on_front=i in front))
    return _paper_grid("cross_family", t0, cells=cells, max_sigma=worst, pareto_marks=marks, near_ties=len(near),
                       near_tie_cells=near, kw_queue=queues,
                       kw_queue_max_abs_err=max((q["max_abs_err"] for q in queues), default=None))


def _pick(e) -> dict:
    return dict(p=e.policy.p, r=e.policy.r, keep=e.policy.keep, latency=e.latency, cost=e.cost)


def paper_table1(core, device, pp, ref) -> dict:
    """Table 1: eq. 19 (latency-sensitive) and eq. 20 (cost-sensitive, λ =
    0.1) on `bootstrap_evaluator(m)` per trace job.  The argmin flips on
    Monte Carlo noise, so the reference's picks and its baseline are
    evaluated again here (`estimate` with the evaluator's seed and m) and
    held within 5σ of the reference's numbers; the port's own picks are
    printed beside them, and its latency-sensitive pick must beat its
    baseline's E[T] at no more than its E[C] (the paper's claim)."""
    from repro_torch.data.traces import synthesize_trace

    t0, worst, jobs = time.perf_counter(), 0.0, {}
    for job in pp["table1_jobs"]:
        trace, want = synthesize_trace(job), ref["table1"][job]
        ev = core.bootstrap_evaluator(trace, m=pp["table1_m"], device=device)
        lat, base = core.optimize_latency_sensitive(ev, r_max=PAPER_TABLE1_R_MAX, p_grid=pp["table1_p"])
        cost, _ = core.optimize_cost_sensitive(ev, lam=PAPER_TABLE1_LAM, n=len(trace), r_max=PAPER_TABLE1_R_MAX,
                                               p_grid=pp["table1_p"])
        check(lat.latency < base.latency and lat.cost <= base.cost,
              f"{job}: the latency-sensitive pick {_pick(lat)} against the baseline {_pick(base)}")
        held = {}
        for key in ("baseline", "latency_sensitive", "cost_sensitive"):
            w = want[key]
            pol = core.SingleForkPolicy(w["p"], w["r"], w["keep"])
            got = _estimate_row(core.estimate(trace, pol, m=pp["table1_m"], seed=0, device=device))
            worst = max(worst, _held_estimate(got, w, f"{job} {key} {pol.label()}"))
            held[key] = dict(got, policy=pol.label())
        jobs[job] = dict(port=dict(latency_sensitive=_pick(lat), cost_sensitive=_pick(cost), baseline=_pick(base),
                                   latency_speedup=base.latency / lat.latency),
                         reference={k: dict(want[k]) for k in ("latency_sensitive", "cost_sensitive", "baseline")},
                         reference_picks_here=held)
    return _paper_grid("table1", t0, max_sigma=worst, jobs=jobs)


def phase_paper(torch, device, sizes) -> dict:
    """The paper's evaluations through the port (`sizes["paper"]`), one line
    a grid, against tools/paper_reference.json: Figs. 3/5, Figs. 4/6 with
    Corollary 1, Figs. 7-10, the cross-family table (kw_queue on the card)
    and Table 1."""
    from repro_torch import core

    pp = sizes["paper"]
    ref = paper_reference(pp)
    t0 = time.perf_counter()
    grids = [paper_fig35(core, device, pp, ref), paper_fig46(core, pp, ref), paper_trace(core, device, pp, ref),
             paper_cross(core, device, pp, ref), paper_table1(core, device, pp, ref)]
    emit("paper", seconds=time.perf_counter() - t0, reference_commit=ref["commit"],
         grids={g["grid"]: dict(wall_s=g["wall_s"], max_sigma=g.get("max_sigma"), max_rel=g.get("max_rel"))
                for g in grids})
    return {g["grid"]: g for g in grids}


def gate_map(gates: dict) -> dict:
    """Every gate of BENCH_fleet.json: where it is held, its value here,
    and the reference's detail (a CPU run: left out for the timing
    gates).  Fails if a gate of the file is neither held nor printed."""
    ref = {g["name"]: g for g in json.loads((ROOT / "BENCH_fleet.json").read_text())["gates"]}
    missing = sorted(set(ref) - set(gates))
    check(not missing, f"BENCH_fleet.json gates not held: {missing}")
    return {name: dict(gates[name], reference=None if name in TIMING_GATES else ref[name]["detail"],
                       reference_passed=ref[name]["passed"]) for name in ref}


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


def phase_sdpa_kernels(torch, device, sizes) -> None:
    """The yardstick of flash_attention's `library_ms`: the device kernels
    that one scaled_dot_product_attention call runs at each timed prefill
    shape, by torch.profiler (on the card only: the port never calls it)."""
    if device.type != "cuda":
        return
    g = torch.Generator(device=device).manual_seed(5)
    rows = []
    for b, s, h, d in sizes["flash_shapes"]:
        q, k, v = (torch.randn((b, h, s, d), generator=g, device=device).bfloat16() for _ in range(3))
        prof = profiled(torch, lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True))
        rows.append(dict(shape=[b, s, h, d], kernels=[t["name"] for t in prof["top"]]))
    emit("sdpa_kernels", shapes=rows)


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
    (each call's launches begin with its `kw_tma_kernel`, or on path
    "two_launch" its `kw_segment_kernel`)."""
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
        if "kw_segment" in k["name"] or "kw_tma" in k["name"]:
            per_stage.append(0.0)
        check(bool(per_stage), f"{k['name']} launched after a kw_tma_kernel or kw_segment_kernel")
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


def profile_serving(torch, model, params, tokens, steps: int, phase: str = "serve_profile") -> None:
    """One request's prefill, then `steps` decode steps, each under
    torch.profiler (phase `phase`)."""
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

    emit(phase, arch=model.config.arch_id, prefill=profiled(torch, prefill, 16), decode_steps=steps,
         decode=profiled(torch, decode, 16))


def phase_serve_moe_profile(torch, device, sizes) -> None:
    """phase `serve_moe`'s model (the same config, seed and first request)
    loaded again, then one prefill and 4 decode steps under torch.profiler,
    once warm (phase `serve_moe_profile`)."""
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.models.lm import build_model

    sv = sizes["serve_moe"]
    cfg = get_reduced(sv["arch"]) if sv["reduced"] else get_config(sv["arch"])
    model = build_model(cfg)
    params = model.init(seed=0, device=device)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, size=sv["prompt"])  # launch.serve's first request
    tokens = torch.as_tensor(prompt, dtype=torch.int32, device=device)[None, :]
    with uncounted():
        model.prefill(params, {"tokens": tokens})  # warm
        profile_serving(torch, model, params, tokens, steps=4, phase="serve_moe_profile")
    del model, params
    free_device(torch, device)


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
        before = dict(flash_attention.launches_by_path)
        out = flash_attention(q, k, v, causal=causal)
        if q.is_cuda and q.dtype == torch.bfloat16:
            check(flash_attention.launches_by_path == {**before, "wgmma_tma": before["wgmma_tma"] + 1},
                  f"flash_attention on the prefill's inputs {tuple(q.shape)} took the Hopper kernel")
        tol = 2e-2 if q.dtype == torch.bfloat16 else 2e-5
        err = _close(torch, out, flash_attention_plain(q, k, v, causal=causal), tol, tol,
                     f"flash_attention on the prefill's inputs {tuple(q.shape)}")
        errors["flash_attention"] = max(errors.get("flash_attention", 0.0), err)
        return out

    def ssd(x, dt, A, B, C, D, *, chunk=128):
        before = dict(ssd_scan.launches_by_path)
        y, h = ssd_scan(x, dt, A, B, C, D, chunk=chunk)
        if x.is_cuda and x.dtype == torch.bfloat16:
            check(ssd_scan.launches_by_path == {**before, "wgmma_tma": before["wgmma_tma"] + 1},
                  f"ssd_scan on the prefill's inputs {tuple(x.shape)} took the Hopper kernel")
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


def cast_params(params, dtype):
    """A copy of a parameter tree with every tensor in `dtype`."""
    from repro_torch import tree

    return tree.tree_map(lambda t: t.to(dtype), params)


def prefill_checks(torch, model, params, tokens, decode_model=None) -> dict:
    """One request's prefill with the kernels against the same prefill with
    their plain versions; prefill(S - 1) + decode_step against prefill(S)
    at the last position, both on `decode_model` (default `model`; a MoE's
    drop-free twin, since a capacity drop of the last token is a legitimate
    difference between the two); and, for scale, the plain prefill against
    itself with the embedding table times (1 + eps·u), u ~ N(0, 1), eps the
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
    dm = decode_model or model
    logits_full = logits_k if dm is model else dm.prefill(params, {"tokens": tokens})[0]
    _, cache = dm.prefill(params, {"tokens": tokens[:, :-1]})
    logits_d, _ = dm.decode_step(params, dm.grow_cache(cache, S), tokens[:, -1], S - 1)
    return dict(kernels_vs_plain=_rel_err(torch, logits_k, logits_p),
                decode_vs_prefill=_rel_err(torch, logits_d, logits_full),
                plain_vs_plain_eps_embed=_rel_err(torch, logits_n, logits_p))


def serve_argv(sv: dict, device) -> list:
    """`launch/serve.py`'s command line for a `sizes` entry, seed 0."""
    return ["--arch", sv["arch"], "--requests", str(sv["requests"]), "--batches", str(sv["batches"]),
            "--prompt", str(sv["prompt"]), "--steps", str(sv["steps"]), "--seed", "0",
            "--device", str(device)] + (["--reduced"] if sv["reduced"] else [])


def free_device(torch, device) -> None:
    """Return the freed models' memory to the card before the next one loads."""
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def phase_serve(torch, device, sizes, phase: str = "serve") -> tuple:
    """`repro_torch.launch.serve` as a user runs it, on `sizes[phase]`, with
    the counters of its kernels set to 0 just before and read just after;
    then checks on one request's prefill.  Phase `serve` serves the hybrid
    (Zamba2-1.2B), whose model phase `fleet_serve` reuses, after phases
    `serve_moe` (the moe family at full width and depth) and `configs`
    (the other new configs: dense, MLA + MoE, encdec, vlm) have each freed
    their models; phase `serve_ssm` (`phase_serve_ssm`) the pure SSM
    (mamba2-2.7b) at 4096-token prompts.

    Prefill then decode is held to 0.05 in bfloat16, as served, and in
    float32 on the same weights cast up exactly.  The prefill's logits
    with the kernels against those with the plain versions are held to
    2e-2 in float32 only: through 38 random-weight layers the hybrid in
    bfloat16 turns changes of a rounding into logit differences of 10-50%
    (PERF.md), so the bfloat16 number is reported, and in
    bfloat16 every kernel call of the prefill is held instead against its
    plain version on the same inputs, at the kernel tolerances.  Returns
    the kernel launches, the flash and SSD launches by kernel path, and
    the run."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.lm import build_model

    sv = sizes[phase]
    argv = serve_argv(sv, device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_flash()
    reset_ssd()
    t0 = time.perf_counter()
    res = serve.run(serve.parse_args(argv), log=lambda line: emit(f"{phase}_log", line=line))
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": ops.flash_attention.launches, "ssd_scan": ops.ssd_scan.launches}
    flash_paths = dict(ops.flash_attention.launches_by_path)
    ssd_paths = dict(ops.ssd_scan.launches_by_path)
    peak = torch.cuda.max_memory_allocated() if cuda else None

    model, params, cfg = res.model, res.params, res.model.config
    served = sv["requests"] * sv["batches"]
    steps = sv["steps"]
    check(all(len(o) == steps for outs in res.outputs for o in outs), f"every request returned {steps} tokens")
    check(len(res.prefill_s) == served, f"{served} requests served")
    check(res.logits_finite, "every logit finite")
    if cuda:
        attn = len(model._hybrid_segments()) if cfg.family == "hybrid" else 0  # the shared block's calls
        want = {"flash_attention": attn * served, "ssd_scan": cfg.n_layers * served}
        check(launches == want, f"kernel launches on the {phase} path {launches} == {want}")
        check(flash_paths == hopper_only(want["flash_attention"]),
              f"every flash launch of the {phase} path on the Hopper kernel: {flash_paths}")
        check(ssd_paths == hopper_only(want["ssd_scan"], "ssd_scan"),
              f"every ssd_scan launch of the {phase} path on the Hopper kernel: {ssd_paths}")

    tokens = torch.as_tensor(res.requests[0], dtype=torch.int32, device=device)[None, :]
    errors: dict = {}
    with routed_kernels(*checked_kernels(torch, errors)):
        model.prefill(params, {"tokens": tokens})
    bf16 = prefill_checks(torch, model, params, tokens)
    cfg32 = cfg.replace(param_dtype=torch.float32)
    params32 = cast_params(params, torch.float32)
    f32 = prefill_checks(torch, build_model(cfg32), params32, tokens)
    del params32
    check(f32["kernels_vs_plain"] < 2e-2, f"float32 prefill logits, kernels vs plain: {f32['kernels_vs_plain']:.3g} < 2e-2")
    for name, got in (("bfloat16", bf16), ("float32", f32)):
        check(got["decode_vs_prefill"] < 0.05,
              f"{name} prefill(S-1) + decode_step vs prefill(S): {got['decode_vs_prefill']:.3g} < 0.05")

    prefill_ms = [t * 1e3 for t in res.prefill_s]
    decode_ms_tok = [t * 1e3 / (steps - 1) for t in res.decode_s]
    emit(phase, arch=cfg.arch_id, params=cfg.param_count(), dtype=str(cfg.param_dtype),
         requests=served, prompt=sv["prompt"], steps=steps, wall_s=wall,
         prefill_ms=dict(first=prefill_ms[0], median=float(np.median(prefill_ms[1:] or prefill_ms))),
         decode_ms_per_token=dict(first=decode_ms_tok[0], median=float(np.median(decode_ms_tok[1:] or decode_ms_tok))),
         prefill_tokens_per_s=sv["prompt"] * served / sum(res.prefill_s),
         decode_tokens_per_s=(steps - 1) * served / sum(res.decode_s),
         tokens_per_s=steps * served / wall, peak_bytes=peak, launches=launches, flash_paths=flash_paths,
         ssd_paths=ssd_paths, batches=[dataclasses.asdict(st) for st in res.stats],
         final_policy=res.stats[-1].policy, controller_policy=res.server.controller.current_policy().label(),
         kernel_calls_vs_plain_max_abs_err=errors, bfloat16=bf16, float32=f32)
    return launches, flash_paths, ssd_paths, res


def phase_serve_ssm(torch, device, sizes) -> tuple:
    """Phase `serve` on `sizes["serve_ssm"]`: the pure SSM, mamba2-2.7b at
    full width and depth, serving 4096-token prompts (32 chunks of 128 a
    layer, on the Hopper ssd_scan's group walk), its model freed after.
    Returns its ssd_scan launches, in all and by kernel path."""
    launches, _, ssd_paths, res = phase_serve(torch, device, sizes, "serve_ssm")
    del res
    free_device(torch, device)
    return {"ssd_scan": launches["ssd_scan"]}, ssd_paths


@contextlib.contextmanager
def counted_drops(torch, device):
    """Counts, on the device, the MoE assignments the gather route keeps
    (`kept`) out of all it slots (`assignments`) while the block runs."""
    from repro_torch.models import moe

    saved = moe._slots
    acc = {"kept": torch.zeros((), dtype=torch.int64, device=device), "assignments": 0}

    def slots(ids_f, n_experts, cap):
        pos, keep = saved(ids_f, n_experts, cap)
        acc["kept"] += keep.sum()
        acc["assignments"] += keep.numel()
        return pos, keep

    moe._slots = slots
    try:
        yield acc
    finally:
        moe._slots = saved


def moe_bounds(cfg, params, S: int, cap: int) -> dict:
    """The least time the card could take for one prefill of S tokens and
    for one decode token at context S, of a MoE model without MLA: the
    larger of its bytes over the HBM rate and its bf16 products over the
    tensor-core peak.  Bytes: every weight read once (of the embedding
    table only the rows gathered), the KV cache written (prefill) or read
    (decode) once.  Operations: the products the code runs, the experts
    over every slot of the (E, C, d) buffer (C = `cap` at prefill; decode's
    C = 1 runs all E experts) and the unembedding over every position."""
    from repro_torch import tree

    m, emb = cfg.moe, params["top"]["embed"]
    elt = emb.element_size()
    d, L, V, H, D = cfg.d_model, cfg.n_layers, cfg.padded_vocab, cfg.n_heads, cfg.resolved_head_dim
    HD, KVD = H * D, cfg.n_kv_heads * D
    weights = sum(t.numel() * t.element_size() for t in tree.leaves(params)) - emb.numel() * elt
    cache = L * 2 * S * KVD * elt

    def ops(T, ctx_pairs, slots):
        per_layer = (2 * T * d * (2 * HD + 2 * KVD) + 4 * H * D * ctx_pairs + 2 * T * d * m.n_experts
                     + 6 * m.n_experts * slots * d * m.d_ff + 6 * T * d * m.n_shared * m.d_ff)
        return L * per_layer + 2 * T * d * V

    prefill_ops = ops(S, S * (S + 1) // 2, cap)
    pre = bound(weights + S * d * elt + cache, prefill_ops, BF16_OPS_PER_S)
    dec = bound(weights + d * elt + cache, ops(1, S, 1), BF16_OPS_PER_S)
    return dict(weight_bytes_read=weights, prefill_flop=prefill_ops, prefill_bound_ms=pre[0],
                prefill_bound_by=pre[1], decode_bound_ms_per_token=dec[0], decode_bound_by=dec[1])


def phase_serve_moe(torch, device, sizes) -> None:
    """`repro_torch.launch.serve` as a user runs it on moonshot-v1-16b-a3b
    (bf16, seed-0 weights, at its full width and depth on the card), with
    the kernels' counters set to 0 just before and read just after; then,
    under `uncounted`, every flash call of one bf16 prefill against its
    plain version, the share of routed assignments the published capacity
    factor (1.25) drops over every distinct request's prefill, and the
    float32 checks on the first `f32_layers` layers at full width (the
    float32 model does not fit on the card): the prefill with the kernels
    against the plain versions (< 2e-2) and prefill(S - 1) + decode_step
    against prefill(S) (< 0.05) at the drop-free capacity factor
    (n_experts).  The bf16 numbers of both are reported: routing is
    discontinuous, and in bf16 a changed rounding can move a token to
    another expert."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.lm import build_model

    sv = sizes["serve_moe"]
    cuda = device.type == "cuda"
    reset_flash()
    ops.ssd_scan.launches = 0
    res, wall, peak = _timed_call(torch, device, lambda: serve.run(
        serve.parse_args(serve_argv(sv, device)), log=lambda line: emit("serve_moe_log", line=line)))
    launches = {"flash_attention": ops.flash_attention.launches, "ssd_scan": ops.ssd_scan.launches}
    flash_paths = dict(ops.flash_attention.launches_by_path)
    prefill_ms = [t * 1e3 for t in res.prefill_s]
    decode_ms_tok = [t * 1e3 / (sv["steps"] - 1) for t in res.decode_s]

    model, params, cfg = res.model, res.params, res.model.config
    served, steps = sv["requests"] * sv["batches"], sv["steps"]
    check(cfg.moe is not None and cfg.mla is None, f"{cfg.arch_id} is a MoE model without MLA")
    check(all(len(o) == steps for outs in res.outputs for o in outs), f"every request returned {steps} tokens")
    check(len(res.prefill_s) == served, f"{served} requests served")
    check(res.logits_finite, "every logit finite")
    if cuda:
        want = {"flash_attention": cfg.n_layers * served, "ssd_scan": 0}
        check(launches == want, f"kernel launches on the MoE serve path {launches} == {want}")
        check(flash_paths == hopper_only(want["flash_attention"]),
              f"every flash launch of the MoE serve path on the Hopper kernel: {flash_paths}")

    tokens = [torch.as_tensor(r, dtype=torch.int32, device=device)[None, :] for r in res.requests]
    S = tokens[0].shape[1]
    errors: dict = {}
    free_moe = dataclasses.replace(cfg.moe, capacity_factor=float(cfg.moe.n_experts))
    L = min(sv["f32_layers"], cfg.n_layers)
    cut = cfg.replace(n_layers=L, param_dtype=torch.float32)
    with uncounted():
        with counted_drops(torch, device) as drops:
            with routed_kernels(*checked_kernels(torch, errors)):
                model.prefill(params, {"tokens": tokens[0]})
            for t in tokens[1:]:
                model.prefill(params, {"tokens": t})
        dropped = 1.0 - int(drops["kept"]) / drops["assignments"]
        bf16 = prefill_checks(torch, model, params, tokens[0], decode_model=build_model(cfg.replace(moe=free_moe)))
        cap = moe_mod.capacity(cfg.moe, S, S)
        bounds = moe_bounds(cfg, params, S, cap)
        # the bf16 model leaves the card before its float32 cut is checked
        params32 = cast_params({"top": params["top"], "layers": params["layers"][:L]}, torch.float32)
        stats, final_policy = res.stats, res.stats[-1].policy
        del res, model, params
        free_device(torch, device)
        left = torch.cuda.memory_allocated() if cuda else None
        f32 = prefill_checks(torch, build_model(cut), params32, tokens[0],
                             decode_model=build_model(cut.replace(moe=free_moe)))
        del params32
    if cuda:
        check("flash_attention" in errors, "the bf16 prefill's flash calls were checked")
    check(f32["kernels_vs_plain"] < 2e-2,
          f"float32 prefill logits ({L} layers), kernels vs plain: {f32['kernels_vs_plain']:.3g} < 2e-2")
    check(f32["decode_vs_prefill"] < 0.05,
          f"float32 prefill(S-1) + decode_step vs prefill(S) ({L} layers, drop-free): "
          f"{f32['decode_vs_prefill']:.3g} < 0.05")

    emit("serve_moe", arch=cfg.arch_id, params=cfg.param_count(), active_params=cfg.active_param_count(),
         n_layers=cfg.n_layers, dtype=str(cfg.param_dtype), requests=served, prompt=sv["prompt"], steps=steps,
         wall_s=wall, prefill_ms=dict(first=prefill_ms[0], median=float(np.median(prefill_ms[1:] or prefill_ms))),
         decode_ms_per_token=dict(first=decode_ms_tok[0],
                                  median=float(np.median(decode_ms_tok[1:] or decode_ms_tok))),
         peak_bytes=peak, launches=launches, flash_paths=flash_paths, capacity_factor=cfg.moe.capacity_factor,
         capacity=cap,
         dropped_share=dropped, dropped_over_prefills=len(tokens), bounds=bounds,
         kernel_calls_vs_plain_max_abs_err=errors, bfloat16=bf16,
         float32=dict(f32, n_layers=L, reduced=f"n_layers {cfg.n_layers} -> {L}", bytes_on_card_before=left),
         decode_vs_prefill_capacity_factor=free_moe.capacity_factor,
         batches=[dataclasses.asdict(st) for st in stats], final_policy=final_policy)
    free_device(torch, device)


def mla_decode_check(torch, model, params, prompt, device) -> dict:
    """An MLA model's decode_step on the naive route against the absorbed
    one, on one cache from prefill(S - 1): max|Δ| / max|ref| of the
    logits, in bf16 (reported) and in float32 (held to 1e-3: the two
    differ there by the order of their products)."""
    from repro_torch.models.lm import build_model

    tokens = torch.as_tensor(prompt, dtype=torch.int32, device=device)[None, :]
    S = tokens.shape[1]

    def absorbed_vs_naive(cfg, p):
        m = build_model(cfg)
        _, cache = m.prefill(p, {"tokens": tokens[:, :-1]})
        cache = m.grow_cache(cache, S)
        out = {impl: build_model(cfg.replace(mla_decode_impl=impl)).decode_step(p, cache, tokens[:, -1], S - 1)[0]
               for impl in ("naive", "absorbed")}
        return _rel_err(torch, out["absorbed"], out["naive"])

    cfg = model.config
    with uncounted():
        bf16 = absorbed_vs_naive(cfg, params)
        p32 = cast_params(params, torch.float32)
        f32 = absorbed_vs_naive(cfg.replace(param_dtype=torch.float32), p32)
        del p32
    check(f32 < 1e-3, f"{cfg.arch_id} float32 decode, absorbed vs naive: {f32:.3g} < 1e-3")
    return dict(absorbed_vs_naive_float32=f32, absorbed_vs_naive_bfloat16=bf16)


def serve_config(torch, device, cfg, cf: dict) -> dict:
    """One config served through `launch.serve.RequestFn` (seed-0 bf16
    weights, prompts and vision / encoder inputs from one seed-0 numpy
    generator): two requests on the counted path, then one with every flash
    call held against its plain version (uncounted)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import RequestFn
    from repro_torch.models.lm import build_model

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg)
    params = model.init(seed=0, device=device)
    _sync(torch, device)
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=cf["prompt"]) for _ in range(2)]
    serve_fn = RequestFn(model, params, cf["prompt"], cf["steps"], device, rng)
    before = ops.flash_attention.launches
    paths_before = dict(ops.flash_attention.launches_by_path)
    outs = [serve_fn(p) for p in prompts]
    launches = ops.flash_attention.launches - before
    flash_paths = {p: n - paths_before[p] for p, n in ops.flash_attention.launches_by_path.items()}
    want = 0 if cfg.mla is not None else cfg.n_layers * len(prompts)
    if cuda:
        check(launches == want, f"{cfg.arch_id}: flash launches {launches} == {want}")
        check(flash_paths == hopper_only(want), f"{cfg.arch_id}: every flash launch on the Hopper kernel: {flash_paths}")
    check(all(o.shape == (cf["steps"],) for o in outs), f"{cfg.arch_id}: {cf['steps']} tokens a request")
    errors: dict = {}
    with uncounted(), routed_kernels(*checked_kernels(torch, errors)):
        serve_fn(prompts[0])
    check(serve_fn.logits_finite, f"{cfg.arch_id}: every logit finite")
    if cuda:
        check(("flash_attention" in errors) == (want > 0), f"{cfg.arch_id}: every flash call checked")
    row = dict(arch=cfg.arch_id, family=cfg.family, params=cfg.param_count(), n_layers=cfg.n_layers,
               dtype=str(cfg.param_dtype), init_s=init_s, prompt=cf["prompt"], decode_steps=cf["steps"] - 1,
               prefill_ms=[t * 1e3 for t in serve_fn.prefill_s[:2]],
               decode_ms_per_token=[t * 1e3 / (cf["steps"] - 1) for t in serve_fn.decode_s[:2]],
               flash_launches=launches, flash_paths=flash_paths, kernel_calls_vs_plain_max_abs_err=errors,
               peak_bytes=torch.cuda.max_memory_allocated() if cuda else None)
    if cfg.mla is not None:
        row["mla_decode"] = mla_decode_check(torch, model, params, prompts[0], device)
    return row


def phase_configs(torch, device, sizes) -> None:
    """Each of `sizes["configs"]["archs"]` served at its published widths
    (`serve_config`), one model on the card at a time; depth cuts are
    named in the phase's `reduced` field."""
    from repro_torch.configs import get_config, get_reduced

    cf = sizes["configs"]
    reduced = {}
    for arch in cf["archs"]:
        cfg = get_reduced(arch) if cf["reduced"] else get_config(arch)
        if arch in cf["layers"]:
            reduced[arch] = f"n_layers {cfg.n_layers} -> {cf['layers'][arch]}"
            cfg = cfg.replace(n_layers=cf["layers"][arch])
        emit("configs", **serve_config(torch, device, cfg, cf), reduced=reduced.get(arch))
        free_device(torch, device)


@contextlib.contextmanager
def captured_searches(log: list):
    """While the block runs, every call of `fleet.vector.policy_search` (a
    controller's re-plan) appends its arguments, its rows and its wall
    seconds to `log`, then returns its rows as it would."""
    from repro_torch.fleet import vector

    inner = vector.policy_search

    def recorded(*args, **kwargs):
        t0 = time.perf_counter()
        rows = inner(*args, **kwargs)
        log.append(dict(args=args, kwargs=kwargs, rows=rows, wall_s=time.perf_counter() - t0))
        return rows

    vector.policy_search = recorded
    try:
        yield
    finally:
        vector.policy_search = inner


def queue_calls_bit_equal(torch, calls, what) -> dict:
    """Each captured kw_queue call against kw_queue_plain on its own
    inputs: all four outputs bit for bit."""
    from repro_torch.kernels.kw_queue import kw_queue, kw_queue_plain

    with uncounted():
        for i, (arrivals, services, speeds) in enumerate(calls):
            got, want = kw_queue(arrivals, services, speeds), kw_queue_plain(arrivals, services, speeds)
            for name, a, b in zip(("starts", "finishes", "services", "slots"), got, want):
                check(torch.equal(a, b), f"{what} kw_queue call {i} {tuple(arrivals.shape)}: {name} bit-equal")
    return dict(calls=len(calls), shapes=sorted({(*arrivals.shape, int(speeds.shape[0])) for arrivals, _, speeds in calls}),
                tolerance="all four outputs bit-equal")


def search_vs_cpu(search) -> float:
    """The largest |Δ mean_sojourn| / hypot(stderr) between a captured
    re-plan's rows and the same `policy_search` call on the CPU (another
    random stream, so the rows agree within the Monte Carlo error)."""
    from repro_torch.fleet import vector

    with uncounted():
        cpu = vector.policy_search(*search["args"], **{**search["kwargs"], "device": "cpu"})
    check([r["label"] for r in cpu] == [r["label"] for r in search["rows"]], "re-plan rows in candidate order")
    return max(abs(a["mean_sojourn"] - b["mean_sojourn"]) / math.hypot(a["sojourn_std_err"], b["sojourn_std_err"])
               for a, b in zip(search["rows"], cpu))


def _replan_walls(searches) -> dict:
    walls = [s["wall_s"] for s in searches]
    return dict(first=walls[0], median=float(np.median(walls[1:] or walls)), all=walls)


def phase_fleet_adaptive(torch, device, sizes) -> dict:
    """The regime-change drill of benchmarks/bench_fleet.py's adaptive lane
    with the load-aware controller planning on `device`: every re-plan's
    `policy_search` queues through kw_queue there.  The six fixed policies
    run on the host's event engine as that benchmark runs them.  Gates:
    `adaptive_reoptimized`, `adaptive_drift_fired`,
    `adaptive_beats_best_fixed`; each re-plan's kw_queue call bit-equal to
    kw_queue_plain; the first re-plan's rows within 5σ of the same search
    on the CPU.  Returns the first re-plan's search (for
    `phase_fleet_adaptive_profile`) and the three gates."""
    from repro_torch.fleet import REGIME_SHIFT, FleetConfig, FleetSim
    from repro_torch.kernels.kw_queue import kw_queue

    sc, n_jobs = REGIME_SHIFT, sizes["fleet_adaptive"]["n_jobs"]
    jobs = sc.workload(n_jobs)
    pre_jobs = jobs[: sc.shift_index(n_jobs)]
    t0 = time.perf_counter()
    fixed, best = [], None
    for pol in sc.fixed_grid:
        cfg = FleetConfig(capacity=sc.capacity, policy=pol, seed=sc.seed)
        fixed.append(dict(policy=pol.label(), pre_shift_sojourn=FleetSim(cfg).run(pre_jobs).stats.mean_sojourn,
                          full_sojourn=FleetSim(cfg).run(jobs).stats.mean_sojourn))
        if best is None or fixed[-1]["pre_shift_sojourn"] < best["pre_shift_sojourn"]:
            best = fixed[-1]
    fixed_s = time.perf_counter() - t0

    calls, searches = [], []
    before = kw_queue.launches
    with captured_queue_calls(calls), captured_searches(searches):
        rep, wall, peak = _timed_call(torch, device, lambda: FleetSim(FleetConfig(
            capacity=sc.capacity, adapt=True, seed=sc.seed, device=device)).run(jobs))
    launches = kw_queue.launches - before
    ctrl = rep.controller
    check(ctrl.device == device, f"the controller plans on {device}")
    gates = dict(zip(ADAPTIVE_GATES, (bool(ctrl.history), ctrl.n_drifts >= 1,
                                      rep.stats.mean_sojourn < best["full_sojourn"])))
    held: dict = {}
    for name, ok in gates.items():
        hold(held, name, "fleet_adaptive", ok, dict(replans=len(ctrl.history), drifts=ctrl.n_drifts,
                                                    adaptive_sojourn=rep.stats.mean_sojourn, best_fixed=best), device)
    check(len(searches) == len(ctrl.history), f"one search per re-plan ({len(searches)} vs {len(ctrl.history)})")
    check(len(calls) == len(searches), f"one kw_queue call per re-plan ({len(calls)})")
    if device.type == "cuda":
        check(launches == len(calls), f"every re-plan's queue launched kw_queue ({launches} of {len(calls)})")
    queues = queue_calls_bit_equal(torch, calls, "re-plan")
    sigma = search_vs_cpu(searches[0])
    check(sigma < 5.0, f"first re-plan on {device} vs the CPU: {sigma:.2f} sigma")
    emit("fleet_adaptive", n_jobs=n_jobs, n_tasks=sc.n_tasks, capacity=sc.capacity, c=sc.capacity // sc.n_tasks,
         wall_s=wall, fixed_grid_s=fixed_s, peak_bytes=peak, replans=len(ctrl.history), drifts=ctrl.n_drifts,
         triggers=[d.trigger for d in ctrl.history], adaptive_sojourn=rep.stats.mean_sojourn, best_fixed=best,
         fixed=fixed, gates=gates, replan_wall_s=_replan_walls(searches),
         replan_share_of_wall=sum(s["wall_s"] for s in searches) / wall, kw_queue_launches=launches,
         kw_queue=queues, first_replan_vs_cpu_sigma=sigma, final_policy=ctrl.current_policy().label())
    return searches[0], held


def phase_kw_queue_classes(torch, device, sizes, shapes) -> list:
    """kw_queue at each main-path shape class (B, J, c) of `shapes`, on the
    first inputs a main path gave it, and at the fleet gates' row 1 (96,
    384, c = 3, a comparison there): every kernel path bit-equal to
    kw_queue_plain, then path "tma" and path "two_launch" timed in turns
    on the same inputs (`kw_paths_case`), beside the byte bound."""
    flush = torch.empty(64 << 20, dtype=torch.float32, device=device) if device.type == "cuda" else None
    classes: dict = {}
    for e in shapes:
        entry = classes.setdefault((e["B"], e["J"], e["c"]), dict(phases={}, launches=0))
        entry["phases"][e["phase"]] = entry["phases"].get(e["phase"], 0) + e["launches"]
        entry["launches"] += e["launches"]
    classes.setdefault((96, 384, 3), dict(phases={"fleet_gates row 1 (a comparison)": 0}, launches=0))
    rows = []
    for (B, J, c), entry in classes.items():
        args = KW_INPUTS.get((B, J, c)) or kw_gate_inputs(torch, device)
        check(tuple(args[0].shape) + (int(args[2].shape[0]),) == (B, J, c), f"kw_queue inputs of {(B, J, c)}")
        rows.append(entry | kw_paths_case(torch, device, args, sizes["kernel_reps"], flush))
    emit("kw_queue_classes", classes=rows, tolerance="bit-equal (torch.equal on all four outputs)")
    return rows


def phase_fleet_adaptive_profile(torch, device, search) -> None:
    """`obs.kernel_profile` over one re-plan's `policy_search` call (the
    first of phase `fleet_adaptive`): compile_s, wall_s, device ms by
    kernel, peak bytes."""
    from repro_torch.fleet import vector
    from repro_torch.obs import kernel_profile

    with uncounted():
        prof = kernel_profile(lambda: vector.policy_search(*search["args"], **search["kwargs"]),
                              name="policy_search", repeats=5, device=device)
    emit("fleet_adaptive_profile", **prof)


def phase_fleet_serve(torch, device, sizes, served) -> dict:
    """`FleetHedgedServer` on phase serve's model and weights: batches of
    requests queue for a finite replica pool at ρ = 0.7 under the baseline,
    the load-aware controller re-plans on `device` through kw_queue, and
    every request's value is the model's prefill plus greedy token
    (`launch.serve.RequestFn`), computed after the simulation as the
    server does.  Returns the kernel launches of the served stream."""
    from repro_torch.core import BASELINE, Pareto, simulate
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import RequestFn
    from repro_torch.obs import SLO, load_chrome_trace, to_chrome_trace
    from repro_torch.runtime import FleetHedgedServer

    fs = sizes["fleet_serve"]
    model, params, cfg = served.model, served.params, served.model.config
    n, cap, nb = fs["requests"], fs["capacity"], fs["batches"]
    c = cap // n
    dist = Pareto(1.7, 0.040)  # launch.serve's default latency law
    base = simulate(dist, BASELINE, n, m=fs["mc_reps"], seed=0, device=device)
    lam = fs["rho"] * c / base.mean_latency
    rng = np.random.default_rng(1)
    batches = [[rng.integers(0, cfg.vocab, size=fs["prompt"]) for _ in range(n)] for _ in range(nb)]
    priorities = [i % 2 for i in range(nb)]
    slos = {0: SLO("interactive-p99", threshold=1.0, quantile=0.99, windows=(1.0, 4.0)),
            1: SLO("batch-p99", threshold=2.0, quantile=0.99, windows=(1.0, 4.0))}
    serve_fn = RequestFn(model, params, fs["prompt"], fs["steps"], device)
    server = FleetHedgedServer(capacity=cap, latency_dist=dist, serve_fn=serve_fn, adapt=True, seed=0, obs=True,
                               slos=slos, device=device)
    kernels = {"kw_queue": ops.kw_queue, "flash_attention": ops.flash_attention, "ssd_scan": ops.ssd_scan}
    before = {k: f.launches for k, f in kernels.items()}
    calls, searches = [], []
    with captured_queue_calls(calls), captured_searches(searches):
        (outcomes, stats), wall, peak = _timed_call(torch, device, lambda: server.serve_stream(
            batches, rate=lam, seed=0, priorities=priorities))
    launches = {k: f.launches - before[k] for k, f in kernels.items()}
    prefill_ms = [t * 1e3 for t in serve_fn.prefill_s]

    served_n = n * nb
    check(len(outcomes) == nb and not any(o.failed for o in outcomes), f"{nb} batches served")
    check(all(len(o.values) == n and all(v.shape == (fs["steps"],) for v in o.values) for o in outcomes),
          f"every batch has {n} values of {fs['steps']} tokens")
    check(len(prefill_ms) == served_n and serve_fn.logits_finite, f"{served_n} prefills, every logit finite")
    with uncounted():
        fresh = serve_fn(batches[0][0])
    check(np.array_equal(outcomes[0].values[0], fresh), "request 0's value equals a fresh call")
    if device.type == "cuda":
        want = {"flash_attention": len(model._hybrid_segments()) * served_n, "ssd_scan": cfg.n_layers * served_n}
        check({k: launches[k] for k in want} == want, f"kernel launches of the served stream {launches} vs {want}")
        check(ops.flash_attention.launches_by_path == hopper_only(want["flash_attention"]),
              f"every flash launch of the served stream on the Hopper kernel: {ops.flash_attention.launches_by_path}")
        check(ops.ssd_scan.launches_by_path == hopper_only(want["ssd_scan"], "ssd_scan"),
              f"every ssd_scan launch of the served stream on the Hopper kernel: {ops.ssd_scan.launches_by_path}")
        check(launches["kw_queue"] == len(calls) > 0, f"kw_queue launched by every re-plan ({launches['kw_queue']})")
    queues = queue_calls_bit_equal(torch, calls, "serving re-plan")
    ctrl = server.controller
    check(len(ctrl.history) >= 2 and len(searches) == len(ctrl.history), f"re-plans while serving: {len(ctrl.history)}")

    tails = server.tail_latencies()
    check(sorted(tails) == [0, 1], "tails for both priorities")
    tail_dev = {}
    for pri, t in tails.items():
        soj = np.array([o.sojourn for o, p in zip(outcomes, priorities) if p == pri])
        rel_acc = server.metrics.histogram("serve.sojourn", labels={"priority": str(pri)}).sketch.rel_acc
        for q, key in ((0.5, "p50"), (0.99, "p99")):
            # the sketch reads the sample of rank floor(q·(N-1)), which is
            # np.percentile's "lower" method
            want = float(np.percentile(soj, 100 * q, method="lower"))
            tail_dev[f"{pri}/{key}"] = abs(t[key] - want) / want
            check(tail_dev[f"{pri}/{key}"] <= rel_acc * (1 + 1e-9),
                  f"priority {pri} {key}: sketch {t[key]} vs np.percentile {want} (rel_acc {rel_acc})")
    report = server.slo_report()
    check(sorted(report) == [0, 1], "slo_report has both classes")
    rec = server._rec
    back = load_chrome_trace(json.loads(json.dumps(to_chrome_trace(rec))))
    check(len(back.spans) == len(rec.spans) > 0, "every span round-trips through the Chrome trace")
    for a, b in zip(rec.spans, back.spans):
        check((a.name, a.cat, a.pid, a.tid, a.args) == (b.name, b.cat, b.pid, b.tid, b.args)
              and math.isclose(a.ts, b.ts, rel_tol=1e-12, abs_tol=1e-12)
              and math.isclose(a.dur, b.dur, rel_tol=1e-12, abs_tol=1e-12), f"span {a.name} round-trips")
    emit("fleet_serve", arch=cfg.arch_id, capacity=cap, requests_per_batch=n, c=c, batches=nb, prompt=fs["prompt"],
         steps=fs["steps"], lam=lam, e_t_baseline=base.mean_latency, e_t_baseline_stderr=base.latency_std_err,
         wall_s=wall, prefill_ms=dict(first=prefill_ms[0], median=float(np.median(prefill_ms[1:]))),
         replan_wall_s=_replan_walls(searches), replans=len(ctrl.history), peak_bytes=peak, launches=launches,
         kw_queue=queues, final_policy=ctrl.current_policy().label(), mean_sojourn=stats.mean_sojourn,
         p99_sojourn=stats.p99_sojourn, tails=tails, tail_rel_dev_vs_np_percentile=tail_dev,
         slo={p: dict(burn_rates=r["burn_rates"], violation_frac=r["violation_frac"]) for p, r in report.items()},
         trace_spans=len(rec.spans))
    return launches


def train_argv(tr: dict, device, checkpoint_dir: str) -> list:
    """`launch/train.py`'s command line for a `sizes` entry, seed 0, with
    the defaults of its cluster: Pareto(2, 1) task times, slow fraction
    0.15, crash probability 0.01, node loss 0.002, `adapt_policy` on."""
    return ["--arch", tr["arch"], "--reduced" if tr["reduced"] else "--full", "--steps", str(tr["steps"]),
            "--batch", str(tr["batch"]), "--seq", str(tr["seq"]), "--n-tasks", str(tr["n_tasks"]),
            "--checkpoint-dir", checkpoint_dir, "--checkpoint-every", str(tr["checkpoint_every"]),
            "--log-every", "5", "--seed", "0", "--device", str(device)]


def _states_equal(torch, a, b) -> bool:
    from repro_torch import tree

    la, lb = tree.leaves_with_path(a), tree.leaves_with_path(b)
    return [k for k, _ in la] == [k for k, _ in lb] and all(
        x.dtype == y.dtype and torch.equal(x, y) for (_, x), (_, y) in zip(la, lb))


def train_checks_on_cpu(torch, device, tr: dict) -> dict:
    """One shard's gradients (1 x seq tokens) of the config cut to
    `check_layers` layers, in float32, on `device` against the port on the
    CPU, and the kernels' refusal of autograd on `device`.  Each leaf's
    max |Δ| over its max |g|; the key biases' gradients are zero in exact
    arithmetic (softmax ignores a shift shared by all keys), so theirs is
    measured against the largest gradient of the model."""
    from repro_torch import tree
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.data import SyntheticTokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models.lm import build_model

    cfg = (get_reduced(tr["arch"]) if tr["reduced"] else get_config(tr["arch"])).replace(
        n_layers=tr["check_layers"], param_dtype=torch.float32, attn_impl="chunked", ssm_impl="jnp")
    model = build_model(cfg)
    params_cpu = model.init(seed=0, device="cpu")
    params = tree.tree_map(lambda t: t.to(device), params_cpu)
    batch_cpu = SyntheticTokenPipeline(cfg, batch_size=1, seq_len=tr["seq"], seed=0, device="cpu").batch(0)
    batch = {k: v.to(device) for k, v in batch_cpu.items()}
    grad = value_and_grad(model.loss)
    (loss_cpu, _), g_cpu = grad(params_cpu, batch_cpu)
    (loss_dev, _), g_dev = grad(params, batch)
    top = max(float(g.abs().max()) for g in tree.leaves(g_cpu))
    rel, shift = {}, 0.0
    for (key, want), got in zip(tree.leaves_with_path(g_cpu), tree.leaves(g_dev)):
        err = float((got.cpu() - want).abs().max())
        if key.endswith("['attn/bk']"):
            shift = max(shift, err / top)
        else:
            rel[key] = err / float(want.abs().max())
    worst = max(rel, key=rel.get)
    check(rel[worst] < 1e-4, f"float32 gradients on {device} vs the CPU: {worst} {rel[worst]:.3g} < 1e-4")
    check(shift < 1e-6, f"key-bias gradients (zero in exact arithmetic) within 1e-6 of the largest: {shift:.3g}")
    loss_rel = abs(float(loss_dev) - float(loss_cpu)) / abs(float(loss_cpu))
    check(loss_rel < 1e-5, f"float32 loss on {device} vs the CPU: {loss_rel:.3g} < 1e-5")

    # the kernel routes have no backward: autograd through them raises
    refused = []
    with uncounted():
        try:
            value_and_grad(build_model(cfg.replace(attn_impl="kernel")).loss)(params, batch)
        except RuntimeError as e:
            refused.append(str(e))
        x = torch.randn(1, 64, 4, 16, device=device, requires_grad=True)
        dt, A, D = torch.rand(1, 64, 4, device=device), -torch.rand(4, device=device), torch.ones(4, device=device)
        Bm = torch.randn(1, 64, 1, 16, device=device)
        try:
            ops.ssd_scan(x, dt, A, Bm, Bm, D, chunk=32)
        except RuntimeError as e:
            refused.append(str(e))
    check(len(refused) == 2 and all("no backward pass" in e for e in refused),
          f"flash_attention and ssd_scan refuse autograd on {device}: {refused}")
    return dict(layers=cfg.n_layers, tokens=tr["seq"], grad_max_rel_err=rel[worst], grad_worst_leaf=worst,
                key_bias_grad_err_vs_largest=shift, loss_rel_err=loss_rel, kernels_refuse_autograd=refused)


def phase_train(torch, device, sizes):
    """`repro_torch.launch.train` as a user runs it: the straggler-aware
    trainer over the config at its published widths and depth (bf16
    parameters, float32 moments), a global batch of `batch` x `seq`
    tokens in `n_tasks` shards on a Pareto(2, 1) `SimCluster`, the
    controller re-planning on the card, a checkpoint every
    `checkpoint_every` steps into a temporary directory.  Then the checks:
    the loss falls by more than 0.5 (tests/test_system.py's gate), a re-plan
    ran, the pool held; a fresh run restores the last step bit for bit and
    one step from the step-20 checkpoint gives the run's step-21 loss; one
    step with literal replicas against one global step from the same state
    (atol = rtol = 2e-2, tests/test_runtime.py's bound for bf16); the
    gradients on the card against the CPU (`train_checks_on_cpu`).
    Training runs none of the four kernels (chunked attention, the "jnp"
    SSM): their counters must not move.  Returns the first run, whose
    trainer phase `train_profile` steps once more."""
    import tempfile

    from repro_torch import checkpoint as ckpt
    from repro_torch import tree
    from repro_torch.core import Pareto
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.runtime import SimCluster, StragglerAwareTrainer, TrainerConfig

    tr = sizes["train"]
    kernels = (ops.kw_queue, ops.residual_sample, ops.flash_attention, ops.ssd_scan)
    before = [k.launches for k in kernels]
    free_device(torch, device)
    log = lambda line: emit("train_log", line=line)
    seconds, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        seconds[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        argv = train_argv(tr, device, tmp)
        run1, wall, peak = _timed_call(torch, device, lambda: train.run(train.parse_args(argv), log=log))
        lap("run")
        trainer, pipe, cfg = run1.trainer, run1.pipeline, run1.pipeline.config
        losses = [r.loss for r in run1.reports]
        check(len(losses) == tr["steps"] and all(math.isfinite(x) for x in losses), f"{tr['steps']} finite losses")
        check(losses[-1] < losses[0] - 0.5, f"the loss fell by more than 0.5: {losses[0]:.4f} -> {losses[-1]:.4f}")
        ctrl = trainer.controller
        check(len(ctrl.history) >= 1 and ctrl.device.type == device.type,
              f"re-plans through the controller on {device}: {len(ctrl.history)}")
        check(trainer.cluster.n_alive >= tr["n_tasks"], f"the pool held {tr['n_tasks']} workers or more")
        check(ckpt.all_steps(tmp)[-3:] == [tr["steps"] - 2 * tr["checkpoint_every"],
                                            tr["steps"] - tr["checkpoint_every"], tr["steps"]], "checkpoints kept")

        # the optimizer alone, and the gradient alone, on the run's last state
        state = trainer.state
        batch = pipe.batch(tr["steps"])
        _, grads = trainer.grad_fn(state["params"], batch)
        opt_ms = time_ms(torch, lambda: trainer.update_fn(state, grads), tr["optimizer_reps"], device)
        grad_ms = time_ms(torch, lambda: trainer.grad_fn(state["params"], batch), tr["optimizer_reps"], device)
        leaves = list(zip(tree.leaves(state["params"]), tree.leaves(grads)))
        opt_bytes = sum(p.numel() * (2 * p.element_size() + g.element_size() + 16) for p, g in leaves)
        del grads
        free_device(torch, device)
        lap("timing")

        # restart: a fresh run restores the last checkpoint bit for bit
        run2 = train.run(train.parse_args(argv), log=log)
        check(run2.resumed == tr["steps"], f"a fresh trainer resumed at step {run2.resumed}")
        check(_states_equal(torch, run2.trainer.state, state), "the restored state is bit-equal to the run's")
        # one further step from the step-20 checkpoint
        resume = 2 * tr["checkpoint_every"]
        t2 = run2.trainer
        t2.state = ckpt.restore(tmp, state, step=resume, device=device)
        t2.step = resume
        rep21 = t2.train_step(pipe.batch(resume))
        want21 = run1.reports[resume].loss
        restart_rel = abs(rep21.loss - want21) / abs(want21)
        check(rep21.step == resume + 1 and restart_rel < 1e-3,
              f"step {resume + 1} from the step-{resume} checkpoint: loss {rep21.loss} vs {want21}")
        del run2, t2
        free_device(torch, device)
        lap("restart")

    # literal replicas: n shards of batch / n rows against the global batch
    def one_step(literal):
        t = StragglerAwareTrainer(
            SimCluster(2 * tr["n_tasks"], Pareto(2.0, 1.0), seed=0), trainer.grad_fn, trainer.update_fn, state,
            TrainerConfig(n_tasks=tr["n_tasks"], adapt_policy=False, literal_replicas=literal), device=device)
        t.step = tr["steps"]
        rep = t.train_step(batch)
        return rep, t.state["params"]

    rep_lit, p_lit = one_step(True)
    rep_glob, p_glob = one_step(False)
    lit_err, moved = 0.0, 0.0
    for a, b, p0 in zip(tree.leaves(p_lit), tree.leaves(p_glob), tree.leaves(state["params"])):
        a, b = a.float(), b.float()
        check(bool(((a - b).abs() <= 2e-2 + 2e-2 * b.abs()).all()), "literal replicas vs the global step: 2e-2")
        lit_err = max(lit_err, float((a - b).abs().max()))
        moved = max(moved, float((b - p0.float()).abs().max()))
    lit_loss_rel = abs(rep_lit.loss - rep_glob.loss) / abs(rep_glob.loss)
    del p_lit, p_glob
    free_device(torch, device)
    lap("literal")
    cpu = train_checks_on_cpu(torch, device, tr)
    lap("card_vs_cpu")
    check([k.launches for k in kernels] == before, "training launched none of the four kernels")

    tokens = tr["batch"] * tr["seq"]
    warm = tr["warmup"]
    step_ms = float(np.median(run1.step_ms[warm:]))
    every = tr["checkpoint_every"]
    save_ms = [run1.step_ms[i] - step_ms for i in range(every - 1, tr["steps"], every)]
    flops = 6 * run1.n_params * tokens
    bound_ms = flops / BF16_OPS_PER_S * 1e3
    emit("train", arch=cfg.arch_id, params=run1.n_params, layers=cfg.n_layers, d_model=cfg.d_model,
         padded_vocab=cfg.padded_vocab, dtype=str(cfg.param_dtype), batch=tr["batch"], seq=tr["seq"],
         n_tasks=tr["n_tasks"], steps=tr["steps"], wall_s=wall, peak_bytes=peak,
         step_ms=dict(median=step_ms, first=run1.step_ms[0], all=run1.step_ms),
         step_device_ms=None if run1.step_device_ms is None else dict(
             median=float(np.median(run1.step_device_ms[warm:])), all=run1.step_device_ms),
         checkpoint_save_ms=save_ms, seconds=seconds, tokens_per_s=tokens / (step_ms / 1e3), model_flops=flops, model_bound_ms=bound_ms,
         mfu=bound_ms / step_ms, grad_ms=grad_ms, optimizer_ms=opt_ms, optimizer_bytes=opt_bytes,
         optimizer_bound_ms=bound(opt_bytes, 0)[0], losses=losses, replans=len(ctrl.history),
         final_policy=trainer.policy.label(), controller_policy=ctrl.current_policy().label(),
         sim_latency_s=sum(r.latency for r in run1.reports), sim_cost=sum(r.cost for r in run1.reports),
         replicas=sum(r.n_replicas for r in run1.reports), lost_workers=sum(len(r.lost_workers) for r in run1.reports),
         pool=trainer.cluster.n_alive, restart=dict(resumed=tr["steps"], bit_equal=True, loss=rep21.loss,
                                                   want=want21, rel_err=restart_rel, bitwise=rep21.loss == want21),
         literal=dict(max_abs_param_diff=lit_err, max_abs_update=moved, loss_rel_err=lit_loss_rel),
         card_vs_cpu=cpu)
    return run1


def sharded_train_config(st: dict):
    """Phase sharded_train's config: the reference's training routes."""
    from repro_torch.configs import get_config, get_reduced

    return (get_reduced(st["arch"]) if st["reduced"] else get_config(st["arch"])).replace(
        attn_impl="chunked", ssm_impl="jnp")


def phase_sharded_train(torch, device, sizes) -> dict:
    """`launch.steps.plan_train`'s step on DTensors over a one-rank mesh
    (`launch.mesh.make_device_mesh`: NCCL on the card, gloo on the CPU)
    beside `make_train_step` on plain tensors, `steps` steps each from one
    seed-0 state on the pipeline's batches: every loss within 1e-6
    relative, every parameter within one bf16 ulp of its own magnitude
    (and the share of bit-equal leaves); the step ms of both (the first
    step of each left out), the collectives the sharded step issues (count
    and operand bytes, `dryrun.LocalCost` over its first step) and each
    side's peak bytes.  The process group is destroyed at the end.
    Returns the phase's figures for phase dryrun."""
    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.data import SyntheticTokenPipeline
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.launch.dryrun import LocalCost
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.models.lm import build_model
    from repro_torch.optim import AdamWConfig, adamw_init

    t_phase = time.perf_counter()
    st = sizes["sharded_train"]
    cfg = sharded_train_config(st)
    shape = ShapeSpec("sharded_train", st["seq"], st["batch"], "train")
    free_device(torch, device)
    mesh = make_device_mesh(None if device.type == "cuda" else str(device))
    try:
        fn, (st_pl, b_pl), _, _ = steps.plan_train(cfg, shape, mesh)
        plain = steps.make_train_step(cfg, AdamWConfig())
        params = build_model(cfg).init(seed=0, device=device)
        state = {"params": params, "opt": adamw_init(params), "step": torch.zeros((), dtype=torch.int32, device=device)}
        dstate = shd.distribute(state, st_pl, mesh)
        pipe = SyntheticTokenPipeline(cfg, batch_size=st["batch"], seq_len=st["seq"], seed=0, device=device)
        losses, plain_ms, sharded_ms, peaks = [], [], [], {"plain": 0, "sharded": 0}
        counted = None
        for i in range(st["steps"]):
            batch = pipe.batch(i)
            (state, m_plain), wall, peak = _timed_call(torch, device, lambda: plain(state, batch))
            plain_ms.append(wall * 1e3)
            peaks["plain"] = max(peaks["plain"], peak or 0)
            dbatch = shd.distribute(batch, b_pl, mesh)
            if i == 0:
                with LocalCost() as cost:
                    (dstate, m_sh), wall, peak = _timed_call(torch, device, lambda: fn(dstate, dbatch))
                counted = dict(count=cost.n_collectives, bytes=dict(cost.collectives))
            else:
                (dstate, m_sh), wall, peak = _timed_call(torch, device, lambda: fn(dstate, dbatch))
            sharded_ms.append(wall * 1e3)
            peaks["sharded"] = max(peaks["sharded"], peak or 0)
            losses.append((float(m_plain["loss"]), float(m_sh["loss"].full_tensor())))
        for i, (a, b) in enumerate(losses):
            check(math.isfinite(a) and abs(b - a) <= 1e-6 * abs(a),
                  f"sharded step {i + 1}'s loss {b!r} within 1e-6 relative of the plain step's {a!r}")
        worst, equal, n = 0.0, 0, 0
        for (key, want), got in zip(tree.leaves_with_path(state["params"]), tree.leaves(dstate["params"])):
            got = got.full_tensor()
            diff = (got.float() - want.float()).abs()
            # one bf16 ulp of each element's own magnitude: 2^(floor(log2|x|) - 7)
            ulp = torch.exp2(torch.floor(torch.log2(want.float().abs().clamp_min(1e-30))) - 7)
            check(bool((diff <= ulp).all()), f"sharded parameter {key} within one bf16 ulp of the plain step's")
            worst = max(worst, float(diff.max()))
            equal += bool(torch.equal(got, want))
            n += 1
        check(int(dstate["step"].full_tensor()) == st["steps"], "the sharded state's step count")
    finally:
        dist.destroy_process_group()
    check(not dist.is_initialized(), "the process group is destroyed")
    out = dict(arch=cfg.arch_id, layers=cfg.n_layers, d_model=cfg.d_model, batch=st["batch"], seq=st["seq"],
               steps=st["steps"], mesh=dict(shape=list(mesh.shape), names=list(mesh.mesh_dim_names),
                                            backend="nccl" if device.type == "cuda" else "gloo"),
               losses=losses, max_abs_param_diff=worst, bit_equal_leaves=equal, leaves=n,
               bit_equal_share=equal / n, plain_step_ms=plain_ms, sharded_step_ms=sharded_ms,
               plain_step_ms_median=float(np.median(plain_ms[1:] or plain_ms)),
               sharded_step_ms_median=float(np.median(sharded_ms[1:] or sharded_ms)),
               collectives=counted, peak_bytes=peaks, seconds=time.perf_counter() - t_phase)
    emit("sharded_train", **out)
    return out


def rule_argument_bytes(cfg, shape, mesh) -> int:
    """Bytes of one rank's shards of the plan's tensor inputs (`plan_train`:
    the state and the batch; `plan_prefill`: the parameters and the batch;
    `plan_decode`: the parameters, the cache and the tokens), from the
    train rules alone: each leaf's bytes over the product of the mesh axes
    its resolved spec shards it over."""
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.shapes import input_specs
    from repro_torch.launch.steps import abstract_state
    from repro_torch.models.lm import build_model

    rules = shd.rules_train(mesh)
    model = build_model(cfg)
    total = 0

    def add(t, spec):
        nonlocal total
        parts = [p for p in spec if p is not None]
        total += t.numel() * t.element_size() // math.prod(shd._axes_size(mesh, p) for p in parts)

    def add_tree(tree, axes):
        shd.zip_map(lambda t, ax: add(t, shd.resolve_spec(ax, t.shape, mesh, rules)), tree, axes)

    if shape.kind == "train":
        add_tree(*abstract_state(cfg))
    else:
        add_tree(model.init(device="meta"), model.param_axes())
    inputs = input_specs(cfg, shape)
    if shape.kind == "decode":
        add_tree(inputs["cache"], model.cache_axes(inputs["cache"]))
        inputs = {"tokens": inputs["tokens"]}
    bd = rules["batch"]
    for t in inputs.values():
        add(t, (bd,) if t.shape[0] % shd._axes_size(mesh, bd) == 0 else ())
    return total


#: result bytes a rank of qwen2-0.5b's train_4k cells read on the card's
#: torch 2.11 while the loss took the gold logit by a gather, whose
#: backward built the global logits (PERF.md)
DRYRUN_GATHER_LOSS_RESULT_BYTES = {"single": 7.07e12, "multi": 3.91e12}


def phase_dryrun(torch, sizes, sharded: dict) -> None:
    """The multi-pod dry-run on the card's host (`launch.dryrun.run_cell`):
    the config's `shape` cell on 256 fake ranks (16 x 16) and on 512 (2 x 16
    x 16): status OK, per-rank argument bytes equal to the rules' shards,
    collective bytes > 0.  Then its `serve` cells (prefill_32k, decode_32k)
    on 256: the same checks, and no rank builds the whole embedding table.
    Then phase sharded_train's step traced on a (1, 1) fake mesh and put
    through `roofline.analyze_cell`: its compute and memory terms against
    phase sharded_train's measured plain step (predicted against read
    MFU)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.mesh import fake_world, make_production_mesh
    from repro_torch.launch.shapes import SHAPES, ShapeSpec

    t_phase = time.perf_counter()
    dr = sizes["dryrun"]
    cells = {}
    for kind in dr["meshes"]:
        t0 = time.perf_counter()
        rec = dryrun.run_cell(dr["arch"], dr["shape"], kind)
        wall = time.perf_counter() - t0
        check(rec["status"] == "OK", f"dry-run {dr['arch']} x {dr['shape']} x {kind}: {rec['status']}")
        n = 512 if kind == "multi" else 256
        with fake_world(n):
            want = rule_argument_bytes(dryrun.cell_config(dr["arch"]), SHAPES[dr["shape"]],
                                       make_production_mesh(multi_pod=kind == "multi"))
        got = rec["memory"]["argument_size_in_bytes"]
        check(got == want, f"{kind}: per-rank argument bytes {got} == the rules' shards {want}")
        coll = sum(rec["collectives"].values())
        check(coll > 0, f"{kind}: collective bytes {coll} > 0 on {n} ranks")
        # the loss's backward stays on the vocabulary's shards: no op's
        # result as large as the global float32 logits
        shp = SHAPES[dr["shape"]]
        logits_bytes = shp.global_batch * shp.seq_len * dryrun.cell_config(dr["arch"]).padded_vocab * 4
        largest = rec["largest_output"]
        check(largest["bytes"] < logits_bytes and not rec["global_logits_ops"],
              f"{kind}: largest op result {largest} (ops of the global logits' shape: "
              f"{rec['global_logits_ops']}) against the global float32 logits' {logits_bytes} bytes")
        row = roofline.analyze_cell(rec)
        cells[kind] = dict(n_devices=rec["n_devices"], wall_s=wall, lower_s=rec["lower_s"], trace_s=rec["compile_s"],
                           memory=rec["memory"], cost=rec["cost"], collectives=rec["collectives"],
                           n_collectives=rec["n_collectives"], bytes_adjusted=rec["bytes_adjusted"],
                           largest_output=largest, global_logits_bytes=logits_bytes,
                           bytes_adjusted_gather_loss=DRYRUN_GATHER_LOSS_RESULT_BYTES.get(kind),
                           rule_argument_bytes=want, roofline=row)
    for name in dr.get("serve", ()):
        t0 = time.perf_counter()
        rec = dryrun.run_cell(dr["arch"], name, "single")
        wall = time.perf_counter() - t0
        check(rec["status"] == "OK", f"dry-run {dr['arch']} x {name} x single: {rec['status']}")
        with fake_world(256):
            want = rule_argument_bytes(dryrun.cell_config(dr["arch"]), SHAPES[name], make_production_mesh())
        got = rec["memory"]["argument_size_in_bytes"]
        check(got == want, f"{name}: per-rank argument bytes {got} == the rules' shards {want}")
        check(sum(rec["collectives"].values()) > 0, f"{name}: collective bytes > 0 on 256 ranks")
        # the serving plans keep the embedding table on its vocabulary shards
        check(not rec["whole_table_ops"], f"{name}: ops of the whole embedding table's shape: "
              f"{rec['whole_table_ops']}")
        cells[f"{name}/single"] = dict(n_devices=rec["n_devices"], wall_s=wall, lower_s=rec["lower_s"],
                                       trace_s=rec["compile_s"], memory=rec["memory"], cost=rec["cost"],
                                       collectives=rec["collectives"], n_collectives=rec["n_collectives"],
                                       bytes_adjusted=rec["bytes_adjusted"], largest_output=rec["largest_output"],
                                       rule_argument_bytes=want, roofline=roofline.analyze_cell(rec))

    st = sizes["sharded_train"]
    shape = ShapeSpec(f"train_{st['batch']}x{st['seq']}", st["seq"], st["batch"], "train")
    cfg = sharded_train_config(st)
    with fake_world(1):
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        rec = dryrun.trace_cell(cfg, shape, mesh)
    rec.update(arch=st["arch"], shape=shape.name, mesh="1x1")
    row = roofline.analyze_cell(rec, shape)
    step_s = sharded["plain_step_ms_median"] / 1e3
    predicted = dict(t_compute_s=row["t_compute_s"], t_memory_s=row["t_memory_s"],
                     t_collective_s=row["t_collective_s"], dominant=row["dominant"],
                     mfu=row["roofline_fraction"], model_flops=row["model_flops"], flops=rec["cost"]["flops"],
                     bytes_adjusted=rec["bytes_adjusted"], peak_bytes=rec["memory"]["peak_memory_in_bytes"],
                     trace_s=rec["compile_s"])
    emit("dryrun", arch=dr["arch"], shape=dr["shape"], seconds=time.perf_counter() - t_phase, cells=cells,
         one_rank=dict(shape=shape.name, predicted=predicted,
                       read=dict(step_s=step_s, mfu=row["model_flops"] / BF16_OPS_PER_S / step_s,
                                 sharded_step_s=sharded["sharded_step_ms_median"] / 1e3)))


def phase_train_profile(torch, device, run1) -> None:
    """Phase train's trainer under torch.profiler: one more step, then the
    same step's gradient and its AdamW update alone (launches, device ms
    by kernel, the device's idle share of the profiled wall time)."""
    trainer = run1.trainer
    trainer.cfg.checkpoint_dir = None
    batch = run1.pipeline.batch(trainer.step)
    if device.type != "cuda":  # torch.profiler's device trace needs the card
        trainer.train_step(batch)
        return
    step = profiled(torch, lambda: trainer.train_step(batch), top_n=16)
    box = {}

    def grad():
        box["grads"] = trainer.grad_fn(trainer.state["params"], batch)[1]

    grad_only = profiled(torch, grad, top_n=16)
    update_only = profiled(torch, lambda: trainer.update_fn(trainer.state, box["grads"]), top_n=8)
    emit("train_profile", arch=run1.pipeline.config.arch_id, step=step, grad=grad_only, update=update_only)


def run(device_name: str, sizes: dict, profile: bool = False) -> dict:
    """Every phase but the device line; returns the kernel table."""
    import torch

    from repro_torch.kernels import build, ops
    from repro_torch.kernels.residual_sampler import residual_sample
    from repro_torch.kernels.single_job import single_job

    device = torch.device(device_name)
    if device.type == "cuda":
        t0 = time.perf_counter()
        lib = build.load_library()
        emit("build", seconds=time.perf_counter() - t0, library=Path(lib._name).name,
             sources=[str(p.relative_to(ROOT)) for p in build.sources()], flags=list(build.NVCC_FLAGS))
    unwrap_kw = record_kw_launches()
    measured = phase_kernels(torch, device, sizes)
    kw_paths: dict = {}
    # single_job's main-path launches, and the evaluator's calls that kept
    # the chains on the card, by the phase that made them
    single_paths: dict = {}
    single_chain: dict = {}
    single_at = [single_job.launches, len(SINGLE_CHAIN)]
    unwrap_chain = record_single_job_chain()

    def single_read(name: str) -> None:
        single_paths[name] = single_job.launches - single_at[0]
        single_chain[name] = SINGLE_CHAIN[single_at[1]:]
        single_at[:] = [single_job.launches, len(SINGLE_CHAIN)]

    def kw_phase(name: str) -> None:
        """kw_queue's counters to 0; its launches recorded under `name`."""
        reset_kw()
        KW_PHASE[0] = name

    def kw_read(name: str) -> int:
        kw_paths[name] = dict(ops.kw_queue.launches_by_path)
        return ops.kw_queue.launches

    kw_phase("frontier")
    residual_sample.launches = 0
    main_path(torch, device, sizes)
    paths = {"frontier": {"kw_queue": kw_read("frontier"), "residual_sample": residual_sample.launches}}
    single_read("frontier")
    if device.type == "cuda":
        check(single_paths["frontier"] > 0, "single_job launched on the frontier path")
    kw_phase("dag")
    dag_event = phase_dag(torch, device, sizes)
    paths["dag"] = {"kw_queue": kw_read("dag")}
    single_read("dag")
    gates = dict(dag_event["gates"])
    kw_phase("fleet_gates")
    gates.update(phase_fleet_gates(torch, device, sizes))
    paths["fleet_gates"] = {"kw_queue": kw_read("fleet_gates")}
    single_read("fleet_gates")
    kw_phase("dag_gates")
    gates.update(phase_dag_gates(torch, device, sizes, dag_event["race"]))
    paths["dag_gates"] = {"kw_queue": kw_read("dag_gates")}
    single_read("dag_gates")
    del dag_event
    kw_phase("paper")
    phase_paper(torch, device, sizes)
    paths["paper"] = {"kw_queue": kw_read("paper")}
    single_read("paper")
    flash_paths = {}
    reset_flash()
    KW_PHASE[0] = "serve_moe"
    phase_serve_moe(torch, device, sizes)
    paths["serve_moe"] = {"flash_attention": ops.flash_attention.launches}
    flash_paths["serve_moe"] = dict(ops.flash_attention.launches_by_path)
    reset_flash()
    KW_PHASE[0] = "configs"
    phase_configs(torch, device, sizes)
    paths["configs"] = {"flash_attention": ops.flash_attention.launches}
    flash_paths["configs"] = dict(ops.flash_attention.launches_by_path)
    ssd_paths = {}
    KW_PHASE[0] = "serve"
    paths["serve"], flash_paths["serve"], ssd_paths["serve"], served = phase_serve(torch, device, sizes)
    kw_phase("fleet_adaptive")
    single_read("serving")
    first_replan, adaptive_gates = phase_fleet_adaptive(torch, device, sizes)
    paths["fleet_adaptive"] = {"kw_queue": kw_read("fleet_adaptive")}
    single_read("fleet_adaptive")
    gates.update(adaptive_gates)
    emit("fleet_gates", gates=gate_map(gates))
    kw_phase("fleet_serve")
    reset_flash()
    reset_ssd()
    phase_fleet_serve(torch, device, sizes, served)
    paths["fleet_serve"] = {k: getattr(ops, k).launches for k in ("kw_queue", "flash_attention", "ssd_scan")}
    kw_read("fleet_serve")
    single_read("fleet_serve")
    flash_paths["fleet_serve"] = dict(ops.flash_attention.launches_by_path)
    ssd_paths["fleet_serve"] = dict(ops.ssd_scan.launches_by_path)
    # one model on the card at a time: phase serve's goes unless --profile
    # profiles it below
    if not profile:
        served = None
    free_device(torch, device)
    KW_PHASE[0] = "serve_ssm"
    paths["serve_ssm"], ssd_paths["serve_ssm"] = phase_serve_ssm(torch, device, sizes)
    # every main-path kw_queue launch, by phase and shape: the records agree
    # with the counters, and on the card every launch took path "tma"
    shapes = kw_queue_shapes(KW_LAUNCHES)
    emit("kw_queue_shapes", classes=shapes)
    for phase, counts in paths.items():
        recorded = sum(e["launches"] for e in shapes if e["phase"] == phase)
        check(recorded == counts.get("kw_queue", 0), f"{phase}: {recorded} kw_queue launches recorded, "
                                                    f"{counts.get('kw_queue', 0)} counted")
    if device.type == "cuda":
        off = [e for e in shapes if set(e["by_path"]) != {"tma"}]
        check(not off, f"every main-path kw_queue launch took path tma: {off}")
    KW_PHASE[0] = "kw_queue_classes"
    phase_kw_queue_classes(torch, device, sizes, shapes)
    unwrap_kw()
    trained = phase_train(torch, device, sizes)
    kernels = (ops.kw_queue, ops.residual_sample, ops.flash_attention, ops.ssd_scan, ops.single_job)
    before = [k.launches for k in kernels]
    sharded = phase_sharded_train(torch, device, sizes)
    phase_dryrun(torch, sizes, sharded)
    check([k.launches for k in kernels] == before, "the sharded step and the dry-run launched none of the kernels")
    unwrap_chain()
    emit("launches", **paths, kw_queue_by_path=kw_paths, flash_attention_by_path=flash_paths,
         ssd_scan_by_path=ssd_paths, single_job_by_phase={k: v for k, v in single_paths.items() if v},
         single_job_chain_by_phase={k: [dict(n=n, stages=S, laws=L) for n, S, L in v]
                                    for k, v in single_chain.items() if v})
    # torch.profiler only after every timed phase, so that no timing
    # follows a profiler session
    phase_fleet_adaptive_profile(torch, device, first_replan)
    phase_sdpa_kernels(torch, device, sizes)
    phase_train_profile(torch, device, trained)
    del trained
    free_device(torch, device)
    if profile:
        tokens = torch.as_tensor(served.requests[0], dtype=torch.int32, device=device)[None, :]
        profile_serving(torch, served.model, served.params, tokens, steps=8)
    del served
    if profile:
        free_device(torch, device)
        phase_serve_moe_profile(torch, device, sizes)
    launches: dict = {}
    for path, counts in paths.items():
        for name, count in counts.items():
            if device.type == "cuda":
                check(count > 0, f"{name} launched on the {path} path")
            launches[name] = launches.get(name, 0) + count
    launches["single_job"] = sum(single_paths.values())

    meta = {
        "kw_queue": ("src/repro_torch/csrc/kw_queue.cu", "src/repro/kernels/kw_queue.py:82"),
        "residual_sample": ("src/repro_torch/csrc/residual_sampler.cu", "src/repro/kernels/residual_sampler.py:39"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu", "src/repro/kernels/flash_attention.py:85"),
        "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu", "src/repro/kernels/ssd_scan.py:82"),
        "single_job": ("src/repro_torch/csrc/single_job.cu", None),  # replaces no TPU kernel
    }
    by_path = {"kw_queue": kw_paths, "flash_attention": flash_paths, "ssd_scan": ssd_paths}
    table = {"kernels": [
        dict(name=name, route="cuda", source=src, replaces=rep, launches=launches[name],
             max_abs_err=measured[name]["max_abs_err"], ms=measured[name]["ms"],
             plain_ms=measured[name]["plain_ms"], bound_ms=measured[name]["bound_ms"],
             bound_by=measured[name]["bound_by"], library_ms=measured[name].get("library_ms"))
        for name, (src, rep) in meta.items()
    ]}
    for entry in table["kernels"]:
        if entry["name"] in by_path:  # main-path launches by kernel path, summed over the phases
            entry["launches_by_path"] = {}
            for counts in by_path[entry["name"]].values():
                for path, n in counts.items():
                    entry["launches_by_path"][path] = entry["launches_by_path"].get(path, 0) + n
    return table


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
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
