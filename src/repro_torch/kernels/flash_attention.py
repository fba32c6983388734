"""Online-softmax attention: CUDA kernels and plain version.

Replaces the TPU kernel `src/repro/kernels/flash_attention.py::
flash_attention` (Pallas body `_kernel`).  q, k, v are (B, S, H, D) with
the kv heads already expanded to H; scores are (q·k)/sqrt(D) in float32,
masked with NEG_INF = -2**30 (not -inf) where a key lies past the keys'
length or, with `causal`, after the query (positions count from 0 for both),
softmax in float32, and the output is stored in the inputs' type.

The kernels (`csrc/flash_attention.cu`) read the (B, S, H, D) layout by
strides and mask ragged ends themselves, so no transposed or padded copies
are made; with `causal` the loop over key tiles stops at the diagonal, and
the query tiles with the most key tiles start first.  `kernel_path` picks
one of three, and `flash_attention.launches_by_path` counts each:

- "wgmma_tma" (bfloat16, head dims 64, 80, 128 and 256, every input 16-byte
  aligned: every main-path call): a Hopper kernel in the shape of
  FlashAttention-3.  A producer warpgroup loads each work item's two 64-row
  query tiles and their K and V tiles by TMA into two-stage mbarrier
  rings; two consumer warpgroups run S = Q·Kᵀ and O += P·V on `wgmma`, P
  taken from registers, tile t's softmax overlapping tile t-1's P·V, the
  two groups taking turns at the tensor cores.  One block an SM works
  through its items; where all items fit on the SMs at once, each pairs
  the heaviest causal query tile left with the lightest.
- "mma_sync" (bfloat16 otherwise: head dim 16, the reduced configs', or a
  view that no TMA map can describe): FlashAttention-2-style
  tiles on `mma.sync`, operands copied by `cp.async` (element by element
  where the inputs are not 16-byte aligned).
- "cuda_core" (float32, whose 2e-5 tolerance rules out TF32 and bf16
  products): float32 products on the CUDA cores.

On both bfloat16 paths P is rounded to bf16 before P·V, as
FlashAttention-2/3 do (the TPU kernel keeps P in float32), and l sums the
float32 p.  Bound on an H100 at the serve shape (1, 1024, 32, 64), causal,
bf16: 16.8 MB moved, 5.0 µs at 3.35 TB/s, against 4.3 GFLOP, 4.3 µs at the
bf16 tensor-core rate.  On an NVIDIA H100 80GB HBM3 at 700.00 W the Hopper
kernel takes about 0.024 ms there and 0.022 ms at moonshot's (1, 1024, 16,
128), against 0.028 and 0.025 ms for scaled_dot_product_attention and 0.050
and 0.062 ms for the mma.sync kernel (PERF.md): a block's chain of key
steps and a fixed cost of launch and first loads set it, not the bound.

`flash_attention` takes the plain version only for tensors on the CPU.  For
a CUDA tensor it launches the kernel or raises.  On every device it refuses
inputs that require grad while autograd records (the kernel has no
backward pass), DTensors and meta tensors.  `flash_attention.launches`
counts the kernel launches of every path.
"""
from __future__ import annotations

import torch

NEG_INF = -(2.0**30)
#: head dims the kernels are compiled for
HEAD_DIMS = (16, 64, 80, 128, 256)
#: head dims the Hopper (TMA and wgmma) kernel is compiled for
WGMMA_HEAD_DIMS = (64, 80, 128, 256)
#: the kernels, by the number `csrc/flash_attention.cu` knows them by
PATHS = {"cuda_core": 0, "mma_sync": 1, "wgmma_tma": 2}
_DTYPES = (torch.float32, torch.bfloat16)


def kernel_path(head_dim: int, dtype: torch.dtype, aligned: bool) -> str:
    """The kernel that takes a call: "cuda_core" for float32; for bfloat16,
    "wgmma_tma" at head dims `WGMMA_HEAD_DIMS` when every input starts on a
    16-byte boundary (a TMA map cannot describe another base), else
    "mma_sync"."""
    if dtype == torch.float32:
        return "cuda_core"
    if dtype != torch.bfloat16:
        raise TypeError(f"flash_attention: no kernel for {dtype}")
    return "wgmma_tma" if head_dim in WGMMA_HEAD_DIMS and aligned else "mma_sync"


def flash_attention_plain(q, k, v, *, causal: bool = True):
    """Attention with the whole score matrix in float32 (the semantics of
    `kernels/ref.py::flash_attention_ref`).  q: (B, Sq, H, D); k, v:
    (B, Sk, H, D).  Returns (B, Sq, H, D) in q's dtype."""
    Sq, D = q.shape[1], q.shape[3]
    Sk = k.shape[1]
    scale = 1.0 / (D**0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        dev = q.device
        keep = torch.arange(Sk, device=dev)[None, :] <= torch.arange(Sq, device=dev)[:, None]
        s = torch.where(keep, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def _refuse_autograd(*tensors):
    """The kernel writes its outputs through raw pointers, so they carry no
    `grad_fn`: a backward through it would treat it as a constant.  Refuse
    on every device, the CPU included, so CPU tests see what the card does."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "flash_attention: the kernel has no backward pass; train through "
            'attn_impl="chunked" (the reference trains through its plain routes too)'
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
                f"flash_attention: the kernel takes plain tensors on a CUDA or CPU device, got {kind}; "
                'shard or trace through attn_impl="chunked" (the sharding plans and the dry-run do)'
            )


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in _DTYPES:
            raise TypeError(f"flash_attention: {name} must be float32 or bfloat16, got {t.dtype}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, q is {q.dtype}")
        if t.ndim != 4:
            raise ValueError(f"flash_attention: {name} must be (B, S, H, D), got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, q on {q.device}")
    if k.shape != v.shape or k.shape[0] != q.shape[0] or k.shape[2:] != q.shape[2:]:
        raise ValueError(
            f"flash_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
            "must share B, H and D, and k and v one shape"
        )
    if min(q.shape) < 1 or k.shape[1] < 1:
        raise ValueError("flash_attention: every dimension must be at least 1")


def flash_attention(q, k, v, *, causal: bool = True):
    """(B, Sq, H, D) attention; see `flash_attention_plain` for the contract."""
    _refuse_sharded_or_meta(q, k, v)
    _check(q, k, v)
    _refuse_autograd(q, k, v)
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    B, Sq, H, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernel takes head dims {HEAD_DIMS}, got {D}")
    if B > 65535 or H > 65535:
        raise ValueError("flash_attention: B and H must be at most 65535")
    path = kernel_path(D, q.dtype, all(t.data_ptr() % 16 == 0 for t in (q, k, v)))
    out = launch(q, k, v, causal, path)
    flash_attention.launches += 1
    flash_attention.launches_by_path[path] += 1
    return out


def launch(q, k, v, causal: bool, path: str):
    """One launch of the kernel `path` on checked CUDA tensors, uncounted
    (`flash_attention` picks the path and counts; a measurement may time
    another path on the same inputs)."""
    B, Sq, H, D = q.shape
    out = torch.empty_like(q)
    from .build import load_library

    lib = load_library()
    dev = q.device
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, k.shape[1], H, D,
        1.0 / (D**0.5), int(causal), PATHS[path], torch.cuda.current_stream(dev).cuda_stream,
        dev.index if dev.index is not None else torch.cuda.current_device(),
    )
    if err != 0:
        raise RuntimeError(f"flash_attention: {path} kernel launch failed with {_launch_error(err)}")
    return out


def _launch_error(err: int) -> str:
    """The launch's return code in words (`csrc/flash_attention.cu`: CUDA
    runtime codes, then its own from 10000)."""
    if err == 10000:
        return "no cuTensorMapEncodeTiled entry point in libcuda"
    if err >= 20000:
        return f"a tensor map libcuda refused (CUresult {err - 20000})"
    return f"CUDA error {err}"


flash_attention.launches = 0
flash_attention.launches_by_path = dict.fromkeys(PATHS, 0)
