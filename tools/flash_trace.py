#!/usr/bin/env python3
"""Where a step of the Hopper flash_attention kernel spends its time, on
the card.

    python3 tools/flash_trace.py [B,S,H,D ...]

(default: the prefill shapes of zamba2-1.2b, moonshot-v1-16b-a3b and
qwen3-32b, causal bf16).  It copies `src/repro_torch/csrc/flash_attention.cu`
into `build/flash_trace/`, adds `%globaltimer` stamps to the consumer
warpgroups of the first blocks, builds that copy into a library of its own
(the port's library is not touched) and launches it on the "wgmma_tma"
path at each shape.  Every key step after a work item's first then has
five stamps, taken by thread 0 of the warpgroup: its turn at the tensor
cores taken, its products issued (Q·K_tᵀ and P·V of tile t-1) and the
turn passed, S ready, the softmax's source lines done, P·V done.  The
compiler may schedule softmax arithmetic on either side of the fourth
stamp, so "softmax" and "pv_wait" are read together.  One JSON line a
shape: the card, the time from the first stamp to each traced
warpgroup's first ready Q (`first_q_us`), and the median over the traced
steps of each phase in ns:
  issue     turn taken -> products issued (includes waiting for room in
            the tensor cores' queue)
  s_wait    issued -> S ready
  softmax   S ready -> the softmax's source lines done
  pv_wait   -> P·V done
  next      P·V done -> the next turn taken (rescale, pack, barriers)
  step      turn taken -> the next turn taken
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
OUT = ROOT / "build" / "flash_trace"
BLOCKS, SLOTS = 4, 400  # traced blocks; stamps a warpgroup
SHAPES = ((1, 1024, 32, 64), (1, 1024, 16, 128), (1, 1024, 64, 128))
PHASES = ("issue", "s_wait", "softmax", "pv_wait")


def traced_source() -> str:
    """The kernel's source with the stamps added (fails if an anchor moved)."""
    src = (CSRC / "flash_attention.cu").read_text()

    def sub(old: str, new: str) -> None:
        nonlocal src
        if src.count(old) != 1:
            raise RuntimeError(f"flash_trace: anchor not found once in flash_attention.cu: {old!r}")
        src = src.replace(old, new)

    sub("namespace {\n", "namespace {\n"
        f"__device__ unsigned long long g_stamps[{BLOCKS}][2][{SLOTS}];\n"
        "__device__ __forceinline__ unsigned long long stamp_now() {\n"
        "  unsigned long long c;\n"
        '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(c));\n'
        "  return c;\n}\n")
    sub("    int g = 0;  // position in the K and V rings, counted over the items\n    for (int r = 0;; ++r) {",
        "    int g = 0;  // position in the K and V rings, counted over the items\n    int n_stamps = 0;\n"
        f"#define STAMP() do {{ if (blk < {BLOCKS} && tid == 0 && n_stamps < {SLOTS}) "
        "g_stamps[blk][cw][n_stamps++] = stamp_now(); } while (0)\n    for (int r = 0;; ++r) {")
    sub("      hopper::mbar_wait(q_full, r & 1);\n",
        "      hopper::mbar_wait(q_full, r & 1);\n"
        f"      if (blk < {BLOCKS} && tid == 0 && n_stamps < {SLOTS}) "
        "g_stamps[blk][cw][n_stamps++] = stamp_now() | (1ull << 63);\n")
    sub("          take_turn(t);\n", "          take_turn(t);\n          STAMP();\n")
    sub("          pass_turn(t);\n", "          pass_turn(t);\n          STAMP();\n")
    sub("          hopper::wgmma_wait<1>();\n", "          hopper::wgmma_wait<1>();\n          STAMP();\n")
    sub("          softmax(t, corr);\n          hopper::wgmma_wait<0>();\n",
        "          softmax(t, corr);\n          STAMP();\n          hopper::wgmma_wait<0>();\n          STAMP();\n")
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
    (OUT / "flash_attention.cu").write_text(traced_source())
    lib_path = OUT / "libflash_trace.so"
    subprocess.run([find_nvcc(), *NVCC_FLAGS, "-shared", str(OUT / "flash_attention.cu"), "-o", str(lib_path)],
                   check=True)
    lib = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [p, p, p, p, i, i, i, i, i, ctypes.c_float, i, i, p, i]
    return lib


def summary(arr: list[int]) -> dict:
    """Per-phase medians over every traced step; an item's Q stamp carries
    the top bit, so the five-stamp records of each item are split apart."""
    flag = 1 << 63
    t0 = min(x & ~flag for x in arr if x > 0)
    first_q, recs = [], []
    for b in range(BLOCKS):
        for w in range(2):
            row = [x for x in arr[(b * 2 + w) * SLOTS:(b * 2 + w + 1) * SLOTS] if x > 0]
            items, cur = [], None
            for x in row:
                if x & flag:
                    cur = []
                    items.append(((x & ~flag) - t0, cur))
                elif cur is not None:
                    cur.append(x - t0)
            if items:
                first_q.append(items[0][0] / 1e3)
            for _, body in items:
                body = body[:5 * (len(body) // 5)]
                recs += [body[k:k + 6] for k in range(0, len(body), 5)]
    phases = {name: [] for name in (*PHASES, "next", "step")}
    for rec in recs:
        for name, a, c in zip(PHASES, rec, rec[1:5]):
            phases[name].append(c - a)
        if len(rec) == 6:
            phases["next"].append(rec[5] - rec[4])
            phases["step"].append(rec[5] - rec[0])
    return dict(first_q_us=first_q, steps_traced=len(recs),
                median_ns={k: statistics.median(v) if v else None for k, v in phases.items()})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_trace: no CUDA device; this tool runs on the card only", file=sys.stderr)
        return 2
    shapes = [tuple(int(x) for x in a.split(",")) for a in sys.argv[1:]] or list(SHAPES)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    lib = build()
    buf = (ctypes.c_ulonglong * (BLOCKS * 2 * SLOTS))()
    g = torch.Generator(device="cuda").manual_seed(0)
    for B, S, H, D in shapes:
        q, k, v = (torch.randn((B, S, H, D), generator=g, device="cuda").bfloat16() for _ in range(3))
        out = torch.empty_like(q)
        for _ in range(3):  # the last launch's stamps are read
            if lib.clear_stamps() != 0:
                raise RuntimeError("flash_trace: clearing the stamps failed")
            err = lib.flash_attention_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, S, H, D,
                                             1.0 / D**0.5, 1, 2, torch.cuda.current_stream().cuda_stream, 0)
            if err != 0:
                raise RuntimeError(f"flash_trace: launch failed with {err}")
            torch.cuda.synchronize()
        if lib.read_stamps(buf) != 0:
            raise RuntimeError("flash_trace: reading the stamps failed")
        print(json.dumps(dict(card=card, shape=[B, S, H, D], causal=True, **summary(list(buf)))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
