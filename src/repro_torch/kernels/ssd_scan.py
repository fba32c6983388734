"""Mamba2 SSD chunked scan: CUDA kernels and plain version.

Replaces the TPU kernel `src/repro/kernels/ssd_scan.py::ssd_scan` (Pallas
body `_kernel`).  x: (Bt, S, H, P), dt: (Bt, S, H) float32, A, D: (H,)
float32, B, C: (Bt, S, G, N) in x's type.  Per chunk of `chunk` steps, with
cs = cumsum(dt·A): y = (C·Bᵀ ⊙ exp(cs_i - cs_j)[j<=i] ⊙ dt)·x + exp(cs)·C·h
+ D·x, and the state h (P × N, float32) is carried across chunks from
zero.  Returns y in x's type and h_final (Bt, H, P, N) float32, sums in
float32.

The kernels (`csrc/ssd_scan.cu`) index the group of B and C for each head
and mask the ragged last chunk, where the TPU wrapper made per-head copies
and padded.  `kernel_path` picks one of three, and
`ssd_scan.launches_by_path` counts each:

- "wgmma_tma" (bfloat16, chunk 128, P and N 64 or 128, x, B and C 16-byte
  aligned, any number of chunks: every main-path call): one CUDA launch of
  a Hopper kernel.  The blocks of a (batch row, head), min(chunks, 8) of
  them, form a thread block cluster that walks the chunks in groups of
  that many, a chunk a block; in each group every block loads its chunk's
  x, B and C by TMA, computes its chunk's own state and C·Bᵀ on `wgmma`,
  then the blocks exchange the states over distributed shared memory, and
  each carries the float32 state of the elements it owns into the next
  group: the chunk states never reach device memory, and no scratch
  tensor is allocated.
- "mma_sync" (bfloat16 otherwise: P = 16, N = 8, chunks other than 128,
  unaligned views): two CUDA launches, the chunks' own states into a
  float32 scratch tensor that this wrapper allocates, then each chunk's
  outputs after the recurrence over the states before it, on `mma.sync`.
- "cuda_core" (float32): one launch of a block per (batch row, head) that
  walks its chunks in order on the CUDA cores.

On both bfloat16 paths every product with a float32 operand takes it as
two bf16 parts, hi + lo.  Bound on an H100 at the serve shape (1, 1024,
64, 64), N = 64, chunk 128, bf16: about 18 MB moved, 5.5 µs at 3.35 TB/s
(see the source and PERF.md).

`ssd_scan` takes the plain version only for tensors on the CPU.  For a
CUDA tensor it launches the kernel or raises.  On every device it refuses
inputs that require grad while autograd records (the kernels have no
backward pass), DTensors and meta tensors.  `ssd_scan.launches` counts
the wrapper's calls that launched (each `CUDA_LAUNCHES[path]` kernels).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

#: shared memory one block may use on Hopper (227 KB)
SMEM_LIMIT = 232448
#: largest chunk, head dim P and state dim N the kernels take
MAX_CHUNK = 128
MAX_WIDTH = 128
_DTYPES = (torch.float32, torch.bfloat16)
#: the kernels, by the number `csrc/ssd_scan.cu` knows them by
PATHS = {"cuda_core": 0, "mma_sync": 1, "wgmma_tma": 2}
#: CUDA kernel launches per call of the wrapper, by kernel path
CUDA_LAUNCHES = {"cuda_core": 1, "mma_sync": 2, "wgmma_tma": 1}
#: P and N, and the chunk, the Hopper kernel takes
WGMMA_WIDTHS = (64, 128)
WGMMA_CHUNK = 128


def kernel_path(P: int, N: int, n_chunks: int, dtype: torch.dtype, aligned: bool, chunk: int = 128) -> str:
    """The kernel that takes a call: "cuda_core" for float32; for bfloat16,
    "wgmma_tma" where P and N are in `WGMMA_WIDTHS`, the chunk is
    `WGMMA_CHUNK` and x, B and C start on 16-byte boundaries (a TMA map
    cannot describe another base), whatever the number of chunks, else
    "mma_sync"."""
    if dtype == torch.float32:
        return "cuda_core"
    if dtype != torch.bfloat16:
        raise TypeError(f"ssd_scan: no kernel for {dtype}")
    hopper = (P in WGMMA_WIDTHS and N in WGMMA_WIDTHS and chunk == WGMMA_CHUNK
              and n_chunks >= 1 and aligned)
    return "wgmma_tma" if hopper else "mma_sync"


def ssd_scan_plain(x, dt, A, B, C, D, *, chunk: int = 128):
    """The chunked scan in plain float32 PyTorch: the TPU kernel's
    arithmetic over all chunks at once, with the state carried by a loop
    over chunks.  Returns (y in x's dtype, h_final float32)."""
    Bt, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    Q = chunk
    nc = -(-S // Q)
    pad = nc * Q - S
    xf, Bf, Cf, dtf = x.float(), B.float(), C.float(), dt.float()
    if pad:  # dt = 0 and x = 0: a step that neither decays nor adds
        xf = F.pad(xf, (0, 0, 0, 0, 0, pad))
        Bf = F.pad(Bf, (0, 0, 0, 0, 0, pad))
        Cf = F.pad(Cf, (0, 0, 0, 0, 0, pad))
        dtf = F.pad(dtf, (0, 0, 0, pad))
    rep = H // G
    xc = xf.reshape(Bt, nc, Q, H, P)
    Bc = Bf.reshape(Bt, nc, Q, G, N).repeat_interleave(rep, dim=3)
    Cc = Cf.reshape(Bt, nc, Q, G, N).repeat_interleave(rep, dim=3)
    dth = dtf.reshape(Bt, nc, Q, H).permute(0, 1, 3, 2)  # (Bt, nc, H, Q)
    cs = torch.cumsum(dth * A.float()[:, None], dim=-1)
    causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    L = torch.where(causal, torch.exp(cs[..., :, None] - cs[..., None, :]), 0.0)
    scores = torch.einsum("bcihn,bcjhn->bchij", Cc, Bc)
    y = torch.einsum("bchij,bcjhp->bcihp", scores * L * dth[..., None, :], xc)
    w = torch.exp(cs[..., -1:] - cs) * dth  # (Bt, nc, H, Q)
    states = torch.einsum("bchj,bcjhp,bcjhn->bchpn", w, xc, Bc)
    decay = torch.exp(cs[..., -1])  # (Bt, nc, H)
    h = torch.zeros((Bt, H, P, N), dtype=torch.float32, device=x.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * decay[:, c, :, None, None] + states[:, c]
    ch = torch.einsum("bcihn,bchpn->bcihp", Cc, torch.stack(h_prev, dim=1))
    y = y + ch * torch.exp(cs).permute(0, 1, 3, 2)[..., None] + xc * D.float()[:, None]
    return y.reshape(Bt, nc * Q, H, P)[:, :S].to(x.dtype), h


def _refuse_autograd(*tensors):
    """The kernel writes its outputs through raw pointers, so they carry no
    `grad_fn`: a backward through it would treat it as a constant.  Refuse
    on every device, the CPU included, so CPU tests see what the card does."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "ssd_scan: the kernel has no backward pass; train through "
            'ssm_impl="jnp" (the reference trains through its plain routes too)'
        )


def _refuse_sharded_or_meta(*tensors):
    """The kernel takes raw pointers to whole tensors on one device: a
    DTensor (a shard of a sharded plan) or a meta tensor (a dry-run) has
    none to give.  Refused on every device."""
    from torch.distributed.tensor import DTensor

    for t in tensors:
        if isinstance(t, DTensor) or t.device.type == "meta":
            kind = "a DTensor" if isinstance(t, DTensor) else "a meta tensor"
            raise ValueError(
                f"ssd_scan: the kernel takes plain tensors on a CUDA or CPU device, got {kind}; "
                'shard or trace through ssm_impl="jnp" (the sharding plans and the dry-run do)'
            )


def _check(x, dt, A, B, C, D, chunk):
    if x.dtype not in _DTYPES:
        raise TypeError(f"ssd_scan: x must be float32 or bfloat16, got {x.dtype}")
    for name, t in (("B", B), ("C", C)):
        if t.dtype != x.dtype:
            raise TypeError(f"ssd_scan: {name} is {t.dtype}, x is {x.dtype}")
    for name, t in (("dt", dt), ("A", A), ("D", D)):
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_scan: {name} must be float32, got {t.dtype}")
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C), ("D", D)):
        if not t.is_contiguous():
            raise ValueError(f"ssd_scan: {name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"ssd_scan: {name} is on {t.device}, x on {x.device}")
    if x.ndim != 4 or min(x.shape) < 1:
        raise ValueError(f"ssd_scan: x must be (Bt, S, H, P), got {tuple(x.shape)}")
    Bt, S, H, _ = x.shape
    if dt.shape != (Bt, S, H):
        raise ValueError(f"ssd_scan: dt must be {(Bt, S, H)}, got {tuple(dt.shape)}")
    if A.shape != (H,) or D.shape != (H,):
        raise ValueError(f"ssd_scan: A and D must be ({H},), got {tuple(A.shape)}, {tuple(D.shape)}")
    if B.ndim != 4 or B.shape != C.shape or B.shape[:2] != (Bt, S) or min(B.shape) < 1:
        raise ValueError(
            f"ssd_scan: B and C must be one (Bt, S, G, N) shape, got {tuple(B.shape)}, {tuple(C.shape)}"
        )
    if H % B.shape[2]:
        raise ValueError(f"ssd_scan: H={H} must be a multiple of G={B.shape[2]}")
    if chunk < 1:
        raise ValueError(f"ssd_scan: chunk must be at least 1, got {chunk}")


def ssd_scan(x, dt, A, B, C, D, *, chunk: int = 128):
    """Chunked SSD scan from a zero state; see `ssd_scan_plain`."""
    _refuse_sharded_or_meta(x, dt, A, B, C, D)
    _check(x, dt, A, B, C, D, chunk)
    _refuse_autograd(x, dt, A, B, C, D)
    dev = x.device
    if dev.type == "cpu":
        return ssd_scan_plain(x, dt, A, B, C, D, chunk=chunk)
    if dev.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {dev}")
    Bt, S, H, P = x.shape
    N = B.shape[3]
    if chunk > MAX_CHUNK or P > MAX_WIDTH or N > MAX_WIDTH:
        raise ValueError(
            f"ssd_scan: the kernel takes chunk, P and N up to {MAX_CHUNK}, got {chunk}, {P}, {N}"
        )
    if H > 65535 or Bt > 65535:
        raise ValueError("ssd_scan: Bt and H must be at most 65535")
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, B, C))
    path = kernel_path(P, N, -(-S // chunk), x.dtype, aligned, chunk)
    out = launch(x, dt, A, B, C, D, chunk, path)
    ssd_scan.launches += 1
    ssd_scan.launches_by_path[path] += 1
    return out


def smem_bytes(chunk: int, P: int, N: int, path: str) -> int:
    """Shared memory one block of the kernel `path` needs (0 where the
    path does not take the shape)."""
    from .build import load_library

    return int(load_library().ssd_scan_smem_bytes(chunk, P, N, PATHS[path]))


def launch(x, dt, A, B, C, D, chunk: int, path: str):
    """One call of the kernel `path` on checked CUDA tensors, uncounted
    (`ssd_scan` picks the path and counts; a measurement may time another
    path on the same inputs).  Returns (y, h_final)."""
    if (path == "cuda_core") != (x.dtype == torch.float32):
        raise TypeError(f"ssd_scan: the {path} kernel does not take {x.dtype}")
    Bt, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    smem = smem_bytes(chunk, P, N, path)
    if not 0 < smem <= SMEM_LIMIT:
        raise ValueError(
            f"ssd_scan: the {path} kernel does not take chunk={chunk}, P={P}, N={N} "
            f"({smem} bytes of shared memory, limit {SMEM_LIMIT})"
        )
    from .build import load_library

    lib = load_library()
    dev = x.device
    y = torch.empty_like(x)
    h_final = torch.empty((Bt, H, P, N), dtype=torch.float32, device=dev)
    # the chunk states and decays of the two-launch mma_sync path
    nc = -(-S // chunk)
    n_scratch = Bt * nc * H * (P * N + 1) if path == "mma_sync" else 0
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=dev)
    err = lib.ssd_scan_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(), D.data_ptr(),
        y.data_ptr(), h_final.data_ptr(), scratch.data_ptr(), Bt, S, H, P, G, N, chunk, PATHS[path],
        torch.cuda.current_stream(dev).cuda_stream,
        dev.index if dev.index is not None else torch.cuda.current_device(),
    )
    if err != 0:
        raise RuntimeError(f"ssd_scan: {path} kernel launch failed with {_launch_error(err)}")
    return y, h_final


def hopper_clusters(P: int, N: int, n_chunks: int, device=None) -> int:
    """Clusters of the wgmma_tma kernel for `n_chunks` chunks, each of
    min(n_chunks, 8) blocks, that the card holds at once
    (`cudaOccupancyMaxActiveClusters`)."""
    from .build import load_library

    dev = torch.device("cuda") if device is None else torch.device(device)
    n = load_library().ssd_scan_hopper_clusters(
        P, N, n_chunks, dev.index if dev.index is not None else torch.cuda.current_device())
    if n < 0:
        raise RuntimeError(f"ssd_scan: cluster occupancy query failed with CUDA error {-n}")
    return n


def _launch_error(err: int) -> str:
    """The launch's return code in words (`csrc/ssd_scan.cu`: CUDA runtime
    codes, then its own from 10000)."""
    if err == 10000:
        return "no cuTensorMapEncodeTiled entry point in libcuda"
    if 20000 <= err < 30000:
        return f"a tensor map libcuda refused (CUresult {err - 20000})"
    if err == 30000:
        return "a cluster of that many blocks that the card cannot schedule"
    return f"CUDA error {err}"


ssd_scan.launches = 0
ssd_scan.launches_by_path = dict.fromkeys(PATHS, 0)
