"""Multi-server Kiefer–Wolfowitz queue recursion: CUDA kernels and plain version.

Replaces the TPU kernel `src/repro/kernels/kw_queue.py::kw_queue` (Pallas
body `_kernel`).  A frontier evaluation runs (grid cells × trials)
independent FIFO G/G/c queues.  Job j takes the lowest-index slot idle at
its arrival, else the lowest-index slot among the earliest-freeing ones;
start = max(a, free), svc = s / speed[slot], finish = start + svc.

The kernels (`csrc/kw_queue.cu`) are segment-parallel: each queue's jobs
are cut into segments, each run from a guessed start state, and a segment
is re-run from its predecessor's end state until the two runs agree; the
result equals the plain version bit for bit.  `kernel_path` picks one of
two, and `kw_queue.launches_by_path` counts each:

- "tma" (J a multiple of 4, the six tensors 16-byte aligned, a block's
  rows fitting in shared memory: every main-path call): one CUDA launch,
  no scratch tensor.  A block holds whole rows, one thread a segment, with
  the segment length from `tma_plan` (B, J, c): enough chains for several
  warps on every SM.  Rows come in by TMA and stay in shared memory;
  segments re-run in rounds from their predecessors' new end states,
  passed in shared memory, and where rounds stop paying (a saturated
  queue) one thread a row walks the rest in order; the outputs leave by
  TMA stores.
- "two_launch" (unaligned rows and views, rows too long for shared
  memory): segments of `SEGMENT_JOBS` jobs, one thread each in one-warp
  blocks, then one thread a queue confirming the fix-ups in order, the
  end states passed through scratch tensors allocated here.

Bound on an H100: B·J·24 bytes (25 MB, 7.5 µs at B=512, J=2048).  What
sets the time is the chains of dependent steps: L speculated, then the
steps to agreement in each round, and at saturation J - 2L walked by one
thread a row; `PERF.md` records the times.

`kw_queue` takes the plain version only for tensors on the CPU.  For a CUDA
tensor it launches a kernel or raises.  `kw_queue.launches` counts the
calls that launch: one CUDA launch each on "tma", two on "two_launch" (one
when J <= SEGMENT_JOBS).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

#: largest slot count the kernels' register arrays hold
MAX_C = 32
#: path "two_launch": jobs per segment of its first kernel (L), the fastest
#: of 32, 64, 128 and 256 on the queues of a full-width `frontier` call
SEGMENT_JOBS = 256
#: the kernels, by the number `csrc/kw_queue.cu` knows them by
PATHS = {"two_launch": 0, "tma": 1}
#: path "tma": most threads (rows × segments) a block, shared memory a
#: block may use on Hopper (227 KB), most tiles a row group, and the tile
#: widths (jobs) a TMA box may take
TMA_THREADS = 256
TMA_SMEM_LIMIT = 232448
TMA_MAX_TILES = 64
TMA_TILE_JOBS = (256, 128, 64, 32)
#: the shortest segment, the most segments a row, and the warps of chains
#: an SM the segment length aims at: L is the shortest of 12, 20, 28, ...
#: (L / 4 odd, so that a warp's 16-byte reads of shared memory hit distinct
#: banks) with at most TMA_MAX_SEGMENTS segments a row and B·ceil(J / L)
#: chains within TMA_WARPS_PER_SM warps on every SM.  (On the card, rows
#: of 2048 jobs ran fastest at L = 28-36 for every B from 16 to 512, and
#: slowest at 12: more segments a row take more rounds; PERF.md.)
TMA_MIN_SEGMENT = 12
TMA_MAX_SEGMENTS = 80
TMA_WARPS_PER_SM = 12
#: rounds of parallel re-runs before the walk
TMA_MAX_ROUNDS = 8
#: SMs of an H100, for plans made without a card
H100_SMS = 132


@dataclass(frozen=True)
class TmaPlan:
    """How path "tma" cuts a (B, J) call: L jobs a segment, K segments a
    row, R rows a block, tiles of `tile` jobs, and the block's threads and
    shared memory (bytes)."""

    L: int
    K: int
    R: int
    tile: int
    tiles: int
    threads: int
    blocks: int
    smem: int


def tma_smem_bytes(R: int, K: int, c: int, tile: int, tiles: int) -> int:
    """A block's shared memory (`csrc/kw_queue.cu::TmaLayout`): six staged
    arrays of R rows × tiles·tile jobs, two states of c floats, a flag and a
    work-list entry a segment, a flag a row, two counts, an mbarrier a
    tile, 128 for alignment."""
    pairs = R * K
    walked = 6 * tiles * R * tile * 4 + 2 * pairs * c * 4 + pairs * 4 + R * 4 + pairs * 4
    return (walked + 8 + 7) // 8 * 8 + tiles * 8 + 128


def tma_plan(B: int, J: int, c: int, n_sm: int = H100_SMS, seg: int | None = None) -> TmaPlan | None:
    """Path "tma"'s cut of a call, or None where it does not take it (J not
    a multiple of 4, or one row too long for a block's shared memory).
    `seg` fixes L (a multiple of 4), raised by 8s until a row's segments fit
    in a block."""
    if J < 4 or J % 4 or not 1 <= c <= MAX_C:
        return None
    K = lambda L: -(-J // L)  # noqa: E731
    if seg is None:
        L = TMA_MIN_SEGMENT
        while L < J and (K(L) > TMA_MAX_SEGMENTS or B * K(L) > n_sm * TMA_WARPS_PER_SM * 32):
            L += 8
    else:
        if seg < 4 or seg % 4:
            raise ValueError(f"kw_queue: a segment of path tma is a multiple of 4 jobs, got {seg}")
        L = seg
        while K(L) > TMA_THREADS:
            L += 8
    k = K(L)
    tile = min(TMA_TILE_JOBS, key=lambda t: (-(-J // t) * t + 8 * -(-J // t), -t))
    tiles = -(-J // tile)
    if tiles > TMA_MAX_TILES:
        return None
    # rows a block: enough to fill a warp where there are more rows than SMs
    R = max(1, min(-(-32 // k), B // n_sm, TMA_THREADS // k, 256))
    while R > 1 and tma_smem_bytes(R, k, c, tile, tiles) > TMA_SMEM_LIMIT:
        R -= 1
    smem = tma_smem_bytes(R, k, c, tile, tiles)
    if smem > TMA_SMEM_LIMIT:
        return None
    return TmaPlan(L=L, K=k, R=R, tile=tile, tiles=tiles, threads=-(-R * k // 32) * 32,
                   blocks=-(-B // R), smem=smem)


def kernel_path(B: int, J: int, c: int, aligned: bool) -> str:
    """The kernel that takes a call: "tma" where `tma_plan` takes the shape
    and the six tensors start on 16-byte boundaries (a TMA map cannot
    describe another base, nor rows of another pitch), else "two_launch"."""
    return "tma" if aligned and tma_plan(B, J, c) is not None else "two_launch"



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
    if B == 0 or J == 0:
        return _outputs(arrivals)
    aligned = all(t.data_ptr() % 16 == 0 for t in (arrivals, services))
    path = kernel_path(B, J, c, aligned)
    out = launch(arrivals, services, speeds, path)
    kw_queue.launches += 1
    kw_queue.launches_by_path[path] += 1
    return out


def _outputs(arrivals):
    B, J = arrivals.shape
    return (torch.empty_like(arrivals), torch.empty_like(arrivals), torch.empty_like(arrivals),
            torch.empty((B, J), dtype=torch.int32, device=arrivals.device))


def n_sms(dev) -> int:
    """The card's SMs (`tma_plan`'s n_sm), read once a device."""
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SMS[dev]


_SMS: dict = {}


def launch(arrivals, services, speeds, path: str, seg: int | None = None, stats=None):
    """One call of the kernel `path` on checked CUDA tensors (B, J >= 1),
    uncounted (`kw_queue` picks the path and counts; a measurement may time
    another path on the same inputs).  `seg` fixes path "tma"'s segment
    length; `stats`, an int64 CUDA tensor of 8 per block of that path
    (`tma_plan(...).blocks`), takes each block's %globaltimer stamps (start,
    speculated, rounds done, walked, stored) and its rounds, re-runs in
    rounds and walked segments.  Returns (starts, finishes, scaled
    services, slots)."""
    from .build import load_library

    lib = load_library()
    dev = arrivals.device
    B, J = arrivals.shape
    c = speeds.shape[0]
    starts, fins, svcs, slots = out = _outputs(arrivals)
    stream = torch.cuda.current_stream(dev).cuda_stream
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if path == "tma":
        plan = tma_plan(B, J, c, n_sms(dev), seg)
        if plan is None:
            raise ValueError(f"kw_queue: path tma does not take (B, J, c) = ({B}, {J}, {c})")
        if stats is not None and (stats.dtype != torch.int64 or stats.numel() < 8 * plan.blocks
                                  or stats.device != dev):
            raise ValueError(f"kw_queue: stats must be int64 on {dev} with {8 * plan.blocks} elements")
        err = lib.kw_queue_tma_launch(
            arrivals.data_ptr(), services.data_ptr(), speeds.data_ptr(), B, J, c, plan.L, plan.R,
            int(math.log2(plan.tile)), TMA_MAX_ROUNDS,
            starts.data_ptr(), fins.data_ptr(), svcs.data_ptr(), slots.data_ptr(),
            None if stats is None else stats.data_ptr(), stream, index,
        )
    elif path == "two_launch":
        L = SEGMENT_JOBS
        K = -(-J // L)
        # scratch: end states of the speculative and fixed-up runs; per-segment
        # sorted flags and fix-up records
        scratch = torch.empty((2, B, K, c), dtype=torch.float32, device=dev)
        flags = torch.empty((2, B, K), dtype=torch.int32, device=dev)
        err = lib.kw_queue_launch(
            arrivals.data_ptr(), services.data_ptr(), speeds.data_ptr(), B, J, c, L,
            scratch.data_ptr(), flags.data_ptr(),
            starts.data_ptr(), fins.data_ptr(), svcs.data_ptr(), slots.data_ptr(), stream, index,
        )
    else:
        raise ValueError(f"kw_queue: no kernel path {path!r}")
    if err != 0:
        raise RuntimeError(f"kw_queue: {path} kernel launch failed with {_launch_error(err)}")
    return out


def _launch_error(err: int) -> str:
    """The launch's return code in words (CUDA runtime codes, then
    `csrc/hopper.cuh`'s own from 10000)."""
    if err == 10000:
        return "no cuTensorMapEncodeTiled entry point in libcuda"
    if 20000 <= err < 30000:
        return f"a tensor map libcuda refused (CUresult {err - 20000})"
    return f"CUDA error {err}"


kw_queue.launches = 0
kw_queue.launches_by_path = dict.fromkeys(PATHS, 0)
