"""Feed-forward blocks: gated (SwiGLU / GeGLU) and plain (GELU) MLPs.

Counterpart of `repro.models.mlp`; parameters are a flat dict keyed by the
reference's paths.
"""

from __future__ import annotations

import torch

from .common import ACTIVATIONS, Init


def init_gated_mlp(init: Init, d_model: int, d_ff: int, name: str = "mlp"):
    with init.scope(name):
        init.param("w_gate", (d_model, d_ff), ("fsdp", "model"))
        init.param("w_up", (d_model, d_ff), ("fsdp", "model"))
        init.param("w_down", (d_ff, d_model), ("model", "fsdp"))


def gated_mlp(params, x, act: str = "silu", name: str = "mlp"):
    g = torch.matmul(x, params[f"{name}/w_gate"])
    u = torch.matmul(x, params[f"{name}/w_up"])
    h = ACTIVATIONS[act](g) * u
    return torch.matmul(h, params[f"{name}/w_down"])


def init_plain_mlp(init: Init, d_model: int, d_ff: int, bias: bool = True, name: str = "mlp"):
    with init.scope(name):
        init.param("w_in", (d_model, d_ff), ("fsdp", "model"))
        init.param("w_out", (d_ff, d_model), ("model", "fsdp"))
        if bias:
            init.param("b_in", (d_ff,), ("model",), init="zeros")
            init.param("b_out", (d_model,), (None,), init="zeros")


def plain_mlp(params, x, act: str = "gelu", name: str = "mlp"):
    h = torch.matmul(x, params[f"{name}/w_in"])
    if f"{name}/b_in" in params:
        h = h + params[f"{name}/b_in"]
    h = ACTIVATIONS[act](h)
    y = torch.matmul(h, params[f"{name}/w_out"])
    if f"{name}/b_out" in params:
        y = y + params[f"{name}/b_out"]
    return y
