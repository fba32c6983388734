#!/usr/bin/env python3
"""Where a block of the Hopper ssd_scan kernel spends its time, on the card;
with `--ab`, the kernel against variants of its source, timed in turns.

    python3 tools/ssd_trace.py [Bt,S,H,P,G,N ...]
    python3 tools/ssd_trace.py --ab [--parent DIR] [Bt,S,H,P,G,N ...]

Inputs: `chip_smoke.ssd_args` with the state carried across chunks, bf16,
chunk 128.  Trace (default shapes: zamba2-1.2b's serve shape and
mamba2-2.7b's).
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
Past 8 chunks the cluster walks groups of 8 chunks: "scan" then runs from
the block's start to the last group's dt, and every later stamp is the
last group's.

A/B (`--ab`; default shapes: `chip_smoke.FULL["ssd_shapes"]`): copies of
the source, each built untraced into a library of its own under
`build/ssd_trace/<copy>/`: "as_is"; "walk", the launch's choice of kernel
replaced by the group walk for every call (the as-is kernel fixes one group
at compile time up to 8 chunks); with `--parent DIR`, "parent", the source
under DIR (a `git archive` of another commit unpacked there).  It prints
each Hopper kernel's registers and spills as ptxas reports them, then one
JSON line a shape: the card, each copy's error against `ssd_scan_plain`
(atol 2e-1, rtol 5e-2 must hold) and its time, all taken in turns on the
same inputs (`chip_smoke.time_turns`: L2 flushed, behind a sleep kernel).
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


#: the launch's choice of kernel, and what the "walk" copy puts in its place
CHOICE, FORCED = "  const bool walk = nc > K;\n", "  const bool walk = true;\n"


def patched(src: str, *pairs: tuple[str, str]) -> str:
    """`src` with each (old, new) replaced (fails if an anchor moved)."""
    for old, new in pairs:
        if src.count(old) != 1:
            raise RuntimeError(f"ssd_trace: anchor not found once in ssd_scan.cu: {old!r}")
        src = src.replace(old, new)
    return src


def traced_source() -> str:
    """The kernel's source with the stamps added (fails if an anchor moved)."""
    src = (CSRC / "ssd_scan.cu").read_text()

    def sub(old: str, new: str) -> None:
        nonlocal src
        src = patched(src, (old, new))

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
    sub("    hopper::mbar_wait(bar, grp & 1);\n", "    SSTAMP(1);\n    hopper::mbar_wait(bar, grp & 1);\n    SSTAMP(2);\n")
    sub("    const bool last = grp == n_groups - 1;\n", "    SSTAMP(3);\n    const bool last = grp == n_groups - 1;\n")
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
    sub("  if (c > 0) {\n    hopper::mbar_wait(h_bar, h_parity);\n",
        "  if (c == 0) SSTAMP(9);\n  if (c > 0) {\n    hopper::mbar_wait(h_bar, h_parity);\n    SSTAMP(9);\n")
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


def build(copies: dict) -> dict:
    """Each copy, {name: (source, directory of its .cuh headers)}, built
    into `OUT / name` by one nvcc each, all in parallel; prints the Hopper
    kernels' ptxas lines (where more than one copy is built) and returns the
    loaded libraries by name."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.build import NVCC_FLAGS, find_nvcc

    procs = {}
    for name, (src, headers) in copies.items():
        out = OUT / name
        out.mkdir(parents=True, exist_ok=True)
        for header in headers.glob("*.cuh"):
            shutil.copy(header, out)
        (out / "ssd_scan.cu").write_text(src)
        cmd = [find_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-shared", str(out / "ssd_scan.cu"), "-o",
               str(out / "libssd.so")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        err = proc.communicate()[1]
        if proc.returncode:
            raise RuntimeError(f"ssd_trace: nvcc failed on {name}:\n{err}")
        kernel = None
        for line in err.splitlines() if len(copies) > 1 else ():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1] if "ssd_scan_hopper_kernel" in line else None
            elif kernel and ("Used" in line or "spill stores" in line):
                tmpl = kernel[kernel.index("ILi"):kernel.index("EEEv") + 3]  # the template arguments, mangled
                print(json.dumps({"copy": name, "kernel": tmpl, "ptxas": line.split(":", 1)[-1].strip()}))
        lib = ctypes.CDLL(str(OUT / name / "libssd.so"))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ssd_scan_launch.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p, i]
        lib.ssd_scan_launch.restype = i
        libs[name] = lib
    return libs


def launcher(lib, args: tuple, y, hf, what: str):
    """A call of `lib`'s kernel on the "wgmma_tma" path, into y and hf."""
    import torch

    from repro_torch.kernels.ssd_scan import PATHS

    x, dt, A, B, C, D = args
    Bt, S, H, P = x.shape
    G, N = B.shape[2:]
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = lib.ssd_scan_launch(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
                                  D.data_ptr(), y.data_ptr(), hf.data_ptr(), None, Bt, S, H, P, G, N, 128,
                                  PATHS["wgmma_tma"], stream, x.device.index or 0)
        if err:
            raise RuntimeError(f"ssd_trace: {what} launch failed with {err}")

    return call


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


def ab(cs, shapes: list, parent: Path | None, card: str) -> None:
    """The --ab mode: one JSON line a shape."""
    import torch

    from repro_torch.kernels.ssd_scan import ssd_scan_plain

    src = (CSRC / "ssd_scan.cu").read_text()
    copies = {"as_is": (src, CSRC), "walk": (patched(src, (CHOICE, FORCED)), CSRC)}
    if parent is not None:
        pcsrc = parent / "src" / "repro_torch" / "csrc"
        copies["parent"] = ((pcsrc / "ssd_scan.cu").read_text(), pcsrc)
    libs = build(copies)
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    g = torch.Generator(device=dev).manual_seed(1234)
    for shape in shapes:
        args = cs.ssd_args(torch, shape, torch.bfloat16, g, dev, carry=True)
        y_p, h_p = ssd_scan_plain(*args, chunk=128)
        line = dict(card=card, shape=list(shape), chunks=-(-shape[1] // 128))
        fns = {}
        for name, lib in libs.items():
            y, hf = torch.empty_like(args[0]), torch.empty((shape[0], shape[2], shape[3], shape[5]), device=dev)
            call = launcher(lib, args, y, hf, name)
            try:
                call()
            except RuntimeError as e:  # a parent whose kernel does not take the shape
                if name != "parent":
                    raise
                line["parent"] = str(e)
                continue
            torch.cuda.synchronize()
            fns[f"{name}_ms"] = call
            line[f"{name}_max_abs_err"] = max(cs._close(torch, y, y_p, 5e-2, 2e-1, f"{name} y"),
                                              cs._close(torch, hf, h_p, 5e-2, 2e-1, f"{name} h_final"))
        line.update(cs.time_turns(torch, fns, 20, dev, flush))
        print(json.dumps(line), flush=True)


def main(argv: list[str]) -> int:
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("ssd_trace: no CUDA device; this tool runs on the card only", file=sys.stderr)
        return 2
    mode_ab = "--ab" in argv
    parent = None
    if "--parent" in argv:
        k = argv.index("--parent")
        parent = Path(argv[k + 1]).resolve()
        argv = argv[:k] + argv[k + 2:]
    argv = [a for a in argv if a != "--ab"]
    shapes = [tuple(int(x) for x in a.split(",")) for a in argv]
    card = cs.nvidia_smi()
    if mode_ab:
        ab(cs, shapes or [s[:6] for s in cs.FULL["ssd_shapes"]], parent, card)
        return 0
    lib = build({"traced": (traced_source(), CSRC)})["traced"]
    buf = (ctypes.c_ulonglong * (BLOCKS * 2 * SLOTS))()
    g = torch.Generator(device="cuda").manual_seed(0)
    for Bt, S, H, P, G, N in shapes or SHAPES:
        args = cs.ssd_args(torch, (Bt, S, H, P, G, N), torch.bfloat16, g, torch.device("cuda"), carry=True)
        call = launcher(lib, args, torch.empty_like(args[0]), torch.empty((Bt, H, P, N), device="cuda"), "traced")
        for _ in range(3):  # the last launch's stamps are read
            if lib.clear_stamps() != 0:
                raise RuntimeError("ssd_trace: clearing the stamps failed")
            call()
            torch.cuda.synchronize()
        if lib.read_stamps(buf) != 0:
            raise RuntimeError("ssd_trace: reading the stamps failed")
        n_blocks = Bt * H * min(-(-S // 128), 8)  # a cluster of at most 8 blocks a head
        print(json.dumps(dict(card=card, shape=[Bt, S, H, P, G, N], chunk=128, **summary(list(buf), n_blocks))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
