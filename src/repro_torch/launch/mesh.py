"""Device meshes and the H100's roofline constants.

Counterpart of `repro.launch.mesh`.  Meshes are built by functions, never
at import.  The production and test meshes are `DeviceMesh`es of a fake
process group (`fake_world`): one process stands for every rank, and
DTensors over such a mesh carry their placements and issue their
collectives without moving data, which is what the dry-run needs (the
reference forces 512 host devices through `XLA_FLAGS` instead).
`make_device_mesh` is a real one-rank mesh on the card.

Constants of one NVIDIA H100 SXM (the roofline's; `chip_smoke.py` takes its
bounds from here too).  A 16-way mesh axis spans more than one 8-GPU
NVLink node, so the roofline's collective term divides by `NET_BW`, the
network port each GPU has, not by `NVLINK_BW`.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist

#: dense bf16 tensor-core FLOP/s (H100 SXM data sheet, without sparsity)
PEAK_FLOPS_BF16 = 989e12
#: float32 FLOP/s outside the tensor cores (H100 SXM data sheet)
PEAK_FLOPS_FP32 = 67e12
#: HBM3 bytes/s (H100 SXM data sheet)
HBM_BW = 3.35e12
#: NVLink 4 bytes/s in one direction (900 GB/s bidirectional, data sheet)
NVLINK_BW = 450e9
#: one 400 Gb/s NDR InfiniBand port per GPU, in bytes/s
NET_BW = 50e9


@contextlib.contextmanager
def fake_world(n: int):
    """A fake process group of `n` ranks (this process is rank 0) for the
    block's meshes; destroyed when the block ends, also when it raises."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already initialized")
    dist.init_process_group("fake", rank=0, world_size=n, store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh(shape, names, device_type: str = "cpu"):
    from torch.distributed.device_mesh import init_device_mesh

    n = math.prod(shape)
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(f"a mesh of {shape} needs a process group of {n} ranks (see fake_world)")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 single pod (256 ranks) or 2x16x16 (512 ranks, 2 pods), inside
    `fake_world(256 | 512)`."""
    if multi_pod:
        return _mesh((2, 16, 16), ("pod", "data", "model"))
    return _mesh((16, 16), ("data", "model"))


def make_test_mesh(*, multi_pod: bool = False):
    """2x4 or 2x2x2, for CI-scale sharding tests, inside `fake_world(8)`."""
    if multi_pod:
        return _mesh((2, 2, 2), ("pod", "data", "model"))
    return _mesh((2, 4), ("data", "model"))


def make_device_mesh(device=None):
    """A one-rank (data=1, model=1) mesh on a real process group: `None`
    means the card (NCCL over a `HashStore`), "cpu" gives gloo.  The caller
    ends it with `torch.distributed.destroy_process_group()`."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_device_mesh: no CUDA device; pass device='cpu' for gloo")
        dist.init_process_group("nccl", rank=0, world_size=1, store=dist.HashStore(),
                                device_id=torch.device("cuda", torch.cuda.current_device()))
    else:
        dist.init_process_group("gloo", rank=0, world_size=1, store=dist.HashStore())
    return _mesh((1, 1), ("data", "model"), dev.type)


def batch_axes(mesh) -> tuple:
    """Mesh axes the global batch is sharded over."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)
