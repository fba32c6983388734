#!/usr/bin/env python3
"""Where a block of the Hopper ssd_scan kernel spends its time, on the card.

    python3 tools/ssd_trace.py [Bt,S,H,P,G,N ...]

(default: zamba2-1.2b's serve shape and mamba2-2.7b's, bf16, chunk 128).
It copies `src/repro_torch/csrc/ssd_scan.cu` into `build/ssd_trace/`, adds
`%globaltimer` stamps, taken by thread 0 of each warpgroup of every block,
builds that copy into a library of its own (the port's library is not
touched) and launches it on the "wgmma_tma" path at each shape.  One JSON
line a shape: the card, the launch's span from the first block's start to
the last block's end, the blocks' start times in µs after the first
(quantiles: the waves), the blocks' median duration, and per warpgroup
the median and 90th percentile in ns of each phase, in the group's order:
  scan      start -> dt loaded, cumsum and weights done
  tma_wait  -> x, B and C landed
  wx        -> the weighted x built (both groups)
  products  -> S = C·Bᵀ and (group 0 at P = 64) the state done
  store     -> the state stored, first cluster arrive
  wait1     -> (group 0) first cluster wait done (every block's state in
            place)
  intra_issue -> (group 0) S scaled and (S ⊙ L ⊙ dt)·x issued, the
            recurrence's first loads in flight
  recur_y   -> (group 0) the DSMEM recurrence and that product done,
            second cluster arrive
  intra     -> (group 1) (S ⊙ L ⊙ dt)·x done
  wait1     -> (group 1) first cluster wait done
  arrive2   -> (group 1) second cluster arrive
  h_wait    -> this block's h landed (chunks after the first)
  carried   -> C·hᵀ done
  out       -> y stored
  exit_wait -> the last cluster wait done (every block done with the states)
Only a card runs it; nvcc comes from the CUDA toolkit, as for the port.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "ssd_trace"
BLOCKS, SLOTS = 1024, 14  # traced blocks; stamps a warpgroup (the last: the SM)
SHAPES = ((1, 1024, 64, 64, 1, 64), (1, 1024, 80, 64, 1, 128))
PHASES = {  # the phases between successive stamps, by warpgroup
    0: ("scan", "tma_wait", "wx", "products", "store", "wait1", "intra_issue", "recur_y", "h_wait", "carried", "out",
        "exit_wait"),
    1: ("scan", "tma_wait", "wx", "products", "store", "intra", "wait1", "arrive2", "h_wait", "carried", "out",
        "exit_wait"),
}


def traced_source() -> str:
    """The kernel's source with the stamps added (fails if an anchor moved)."""
    src = (CSRC / "ssd_scan.cu").read_text()

    def sub(old: str, new: str) -> None:
        nonlocal src
        if src.count(old) != 1:
            raise RuntimeError(f"ssd_trace: anchor not found once in ssd_scan.cu: {old!r}")
        src = src.replace(old, new)

    sub("namespace {\n", "namespace {\n"
        f"__device__ unsigned long long g_stamps[{BLOCKS}][2][{SLOTS}];\n"
        "__device__ __forceinline__ unsigned long long stamp_now() {\n"
        "  unsigned long long c;\n"
        '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(c));\n'
        "  return c;\n}\n"
        "#define SSTAMP(k) do { const int blk_ = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z); "
        f"if (blk_ < {BLOCKS} && (threadIdx.x & 127) == 0) g_stamps[blk_][threadIdx.x >> 7][k] = stamp_now(); }} while (0)\n")
    sub("  if (tid == 0) {\n    hopper::prefetch_tensormap(&tm_x);",
        "  SSTAMP(0);\n  if ((threadIdx.x & 127) == 0 && blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z) < "
        f"{BLOCKS}) {{ unsigned sm_; asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(sm_)); "
        f"g_stamps[blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)][threadIdx.x >> 7][{SLOTS - 1}] = sm_; }}\n"
        "  if (tid == 0) {\n    hopper::prefetch_tensormap(&tm_x);")
    sub("  hopper::mbar_wait(bar, 0);\n", "  SSTAMP(1);\n  hopper::mbar_wait(bar, 0);\n  SSTAMP(2);\n")
    sub("  const int wg = __shfl_sync(", "  SSTAMP(3);\n  const int wg = __shfl_sync(")
    sub("  if constexpr (P == 128) hopper::named_bar_sync<1>(kHopThreads);\n",
        "  SSTAMP(4);\n  if constexpr (P == 128) hopper::named_bar_sync<1>(kHopThreads);\n")
    sub("  hopper::cluster_arrive();\n\n  // The recurrence", "  hopper::cluster_arrive();\n  SSTAMP(5);\n\n  // The recurrence")
    sub("    hopper::cluster_wait();\n#pragma unroll\n    for (int cc = 0; cc < kMaxCluster; ++cc)\n      dec[cc]",
        "    hopper::cluster_wait();\n    SSTAMP(6);\n#pragma unroll\n    for (int cc = 0; cc < kMaxCluster; ++cc)\n      dec[cc]")
    sub("  hopper::wgmma_commit();\n  if constexpr (wg == 0) {\n    if (e4_first",
        "  hopper::wgmma_commit();\n  if constexpr (wg == 0) SSTAMP(7);\n  if constexpr (wg == 0) {\n    if (e4_first")
    sub("  if constexpr (wg == 1) hopper::cluster_wait();\n  hopper::cluster_arrive_relaxed();\n",
        "  if constexpr (wg == 1) SSTAMP(6);\n  if constexpr (wg == 1) hopper::cluster_wait();\n  if constexpr (wg == 1) SSTAMP(7);\n"
        "  hopper::cluster_arrive_relaxed();\n  SSTAMP(8);\n")
    sub("  if (c > 0) {\n    hopper::mbar_wait(h_bar, 0);\n",
        "  if (c == 0) SSTAMP(9);\n  if (c > 0) {\n    hopper::mbar_wait(h_bar, 0);\n    SSTAMP(9);\n")
    sub("  // y = Y + exp(cs_i)·Z + D·x, rounded to bf16\n", "  SSTAMP(10);\n  // y = Y + exp(cs_i)·Z + D·x, rounded to bf16\n")
    sub("      *reinterpret_cast<uint32_t*>(yr + p) = tc::pack_bf16(v0, v1);\n    }\n  }\n  hopper::cluster_wait();\n}\n",
        "      *reinterpret_cast<uint32_t*>(yr + p) = tc::pack_bf16(v0, v1);\n    }\n  }\n  SSTAMP(11);\n"
        "  hopper::cluster_wait();\n  SSTAMP(12);\n}\n")
    src += ('\nextern "C" int read_stamps(void* dst) {\n'
            "  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_stamps, sizeof(g_stamps)));\n}\n"
            'extern "C" int clear_stamps() {\n'
            f"  static unsigned long long zeros[{BLOCKS} * 2 * {SLOTS}] = {{0}};\n"
            "  return static_cast<int>(cudaMemcpyToSymbol(g_stamps, zeros, sizeof(zeros)));\n}\n")
    return src


def build() -> ctypes.CDLL:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.build import NVCC_FLAGS, find_nvcc

    OUT.mkdir(parents=True, exist_ok=True)
    for header in CSRC.glob("*.cuh"):
        shutil.copy(header, OUT)
    (OUT / "ssd_scan.cu").write_text(traced_source())
    lib_path = OUT / "libssd_trace.so"
    subprocess.run([find_nvcc(), *NVCC_FLAGS, "-shared", str(OUT / "ssd_scan.cu"), "-o", str(lib_path)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_launch.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p, i]
    return lib


def quantiles(xs: list[float]) -> dict:
    xs = sorted(xs)
    return {f"p{q}": round(xs[min(len(xs) - 1, int(q / 100 * len(xs)))], 3) for q in (0, 10, 25, 50, 75, 90, 100)}


def summary(arr: list[int], n_blocks: int) -> dict:
    rows = [[arr[(b * 2 + w) * SLOTS:(b * 2 + w + 1) * SLOTS] for w in range(2)] for b in range(min(n_blocks, BLOCKS))]
    t0 = min(r[0][0] for r in rows)
    starts = [(r[0][0] - t0) / 1e3 for r in rows]
    ends = [(max(r[0][12], r[1][12]) - t0) / 1e3 for r in rows]
    per_group = {}
    for w in range(2):
        ph = {name: [] for name in PHASES[w]}
        for r in rows:
            s = r[w][:13]
            for k, name in enumerate(PHASES[w]):
                ph[name].append(s[k + 1] - s[k])
        per_group[f"group{w}"] = {name: dict(median=statistics.median(v), p90=sorted(v)[int(0.9 * len(v))])
                                  for name, v in ph.items()}
    sms = [r[0][SLOTS - 1] for r in rows]
    per_sm = {}
    for sm in sms:
        per_sm[sm] = per_sm.get(sm, 0) + 1
    return dict(span_us=round(max(ends), 3), start_us=quantiles(starts),
                duration_us=quantiles([e - s for s, e in zip(starts, ends)]),
                sms_used=len(per_sm), blocks_per_sm=quantiles(list(per_sm.values())), **per_group)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ssd_trace: no CUDA device; this tool runs on the card only", file=sys.stderr)
        return 2
    shapes = [tuple(int(x) for x in a.split(",")) for a in sys.argv[1:]] or list(SHAPES)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    lib = build()
    buf = (ctypes.c_ulonglong * (BLOCKS * 2 * SLOTS))()
    g = torch.Generator(device="cuda").manual_seed(0)
    for Bt, S, H, P, G, N in shapes:
        x = torch.randn((Bt, S, H, P), generator=g, device="cuda").bfloat16()
        dt = torch.nn.functional.softplus(torch.randn((Bt, S, H), generator=g, device="cuda"))
        A = -torch.exp(torch.randn((H,), generator=g, device="cuda") * 0.3)
        B, C = (torch.randn((Bt, S, G, N), generator=g, device="cuda").bfloat16() for _ in range(2))
        D = torch.ones((H,), device="cuda")
        y = torch.empty_like(x)
        hf = torch.empty((Bt, H, P, N), device="cuda")
        for _ in range(3):  # the last launch's stamps are read
            if lib.clear_stamps() != 0:
                raise RuntimeError("ssd_trace: clearing the stamps failed")
            err = lib.ssd_scan_launch(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
                                      D.data_ptr(), y.data_ptr(), hf.data_ptr(), None, Bt, S, H, P, G, N, 128, 2,
                                      torch.cuda.current_stream().cuda_stream, 0)
            if err != 0:
                raise RuntimeError(f"ssd_trace: launch failed with {err}")
            torch.cuda.synchronize()
        if lib.read_stamps(buf) != 0:
            raise RuntimeError("ssd_trace: reading the stamps failed")
        n_blocks = Bt * H * (-(-S // 128))
        print(json.dumps(dict(card=card, shape=[Bt, S, H, P, G, N], chunk=128, **summary(list(buf), n_blocks))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
