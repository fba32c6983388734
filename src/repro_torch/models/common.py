"""Shared model-building substrate, in PyTorch.

Counterpart of `repro.models.common`.  `Init` takes the place of the
reference's `Tape`: it draws every parameter from one seeded
`torch.Generator` with `_init_value`'s distributions (normal with std
1/sqrt(fan_in), "embed" normal with std 0.02, zeros, ones), into a flat
dict keyed by the reference's "scope/name" paths, and records each
parameter's logical sharding axes in `Init.specs`, as the reference's
`Tape` does.  `repro_torch.launch.sharding` resolves them to mesh
placements.

Logical axis vocabulary (resolved per mesh, with divisibility fallback):
  'batch'   -> ('pod','data')     activations leading dim
  'fsdp'    -> ('pod','data')     weight dim sharded FSDP-style
  'model'   -> 'model'            tensor-parallel weight/activation dim
  'heads'   -> 'model'            the heads dim of a cache
  'vocab'   -> 'model'
  None      -> replicated
(The reference's 'layers' axis has no counterpart: the port keeps a list
of per-layer dicts where the reference stacks them.)

Numerics follow the reference: norms in float32, then a cast back to the
input's dtype; rotary angles in float32.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


class Init:
    """Declares parameters under "/"-joined scopes, initialises them and
    records their logical axes.  With `generator=None` on the meta device,
    parameters get shapes and dtypes but no storage (the reference's
    `abstract=True`)."""

    def __init__(self, generator: Optional[torch.Generator], dtype=torch.bfloat16, device=None):
        self.generator = generator
        self.device = torch.device(device) if device is not None else generator.device
        self.dtype = dtype
        self.params: Dict[str, torch.Tensor] = {}
        self.specs: Dict[str, Tuple[Optional[str], ...]] = {}
        self._scope: list[str] = []

    def scope(self, name: str) -> "_Scope":
        return _Scope(self, name)

    def param(
        self,
        name: str,
        shape: Sequence[int],
        axes: Sequence[Optional[str]],
        init: str = "normal",
        scale: Optional[float] = None,
        dtype=None,
    ) -> torch.Tensor:
        full = "/".join(self._scope + [name])
        shape = tuple(int(s) for s in shape)
        axes = tuple(axes)
        if len(shape) != len(axes):
            raise ValueError(f"{full}: shape {shape} vs axes {axes}")
        if full in self.params:
            raise ValueError(f"duplicate param {full}")
        self.specs[full] = axes
        value = _init_value(self.generator, self.device, shape, init, scale, dtype or self.dtype)
        self.params[full] = value
        return value


class _Scope:
    def __init__(self, init: Init, name: str):
        self.init, self.name = init, name

    def __enter__(self):
        self.init._scope.append(self.name)
        return self.init

    def __exit__(self, *exc):
        self.init._scope.pop()


def _init_value(generator, dev, shape, init, scale, dtype):
    if init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=dev)
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=dev)
    if init == "normal":
        fan_in = shape[0] if len(shape) >= 2 else max(shape[-1], 1)
        std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    elif init == "embed":
        std = scale if scale is not None else 0.02
    else:
        raise ValueError(init)
    return (torch.randn(shape, generator=generator, device=dev) * std).to(dtype)


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------


def rms_norm(x, weight, eps: float = 1e-6, offset: float = 0.0):
    """RMSNorm in fp32 (offset=1.0 gives Gemma's (1+w) convention)."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (weight.float() + offset)).to(x.dtype)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def gelu(x):
    return F.gelu(x, approximate="tanh")


ACTIVATIONS: Dict[str, Callable] = {
    "silu": F.silu,
    "gelu": gelu,
    "relu": F.relu,
}


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exps)


def apply_rope(x, positions, theta: float = 10000.0, fraction: float = 1.0):
    """Rotate the first `fraction` of the head dim.  x: (..., S, H, D),
    positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    rot = int(d * fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    freqs = rope_frequencies(rot, theta, device=x.device)
    angles = positions[..., None].float() * freqs  # (..., S, rot/2)
    angles = angles[..., None, :]  # broadcast over heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x_rot.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), x_pass], dim=-1)


# ---------------------------------------------------------------------------
# vocab padding
# ---------------------------------------------------------------------------


def pad_vocab(vocab: int, multiple: int = 512) -> int:
    return ((vocab + multiple - 1) // multiple) * multiple
