"""repro_torch — the PyTorch/CUDA port of `repro` for NVIDIA Hopper.

The package mirrors `repro`'s subpackage layout (`core/`, `fleet/`,
`faults/`, `data/`, `kernels/`) and function names.  It imports torch,
numpy and scipy only: never jax, and nothing of `repro`.  Entry points take
`device=None`, which means the card (`"cuda"`); they raise when no card is
present unless the caller passes `device="cpu"`.
"""

from .device import resolve_device  # noqa: F401
