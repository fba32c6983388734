"""AdamW with global-norm clipping and cosine LR schedule.

Counterpart of `repro.optim.adamw`, on the port's trees (dicts and lists
of per-layer dicts; `repro_torch.tree`).  The arithmetic is the
reference's, element by element in float32: the norm of the gradients
upcast to float32, the moments in float32, and the new parameter
`(p.float() - lr * delta).to(p.dtype)`.  The update runs as
`torch._foreach_*` calls over all leaves at once, so a step launches a few
kernels per operation rather than one per leaf and operation.  `step` and
the learning rate stay tensors on the device: nothing waits on the host.

As in the reference, `m_dtype` is kept but not honoured: `adamw_init`
makes float32 moments whatever it says, and the update never casts them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from .. import tree as tr

PyTree = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    # the reference's §Perf knob for a bf16 first moment; unused there too
    m_dtype: Any = torch.float32


def cosine_schedule(cfg: AdamWConfig, step):
    """Linear warm-up, then cosine decay to `min_lr_ratio`: a float32 tensor
    of `step`'s shape, on its device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params: PyTree) -> PyTree:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": tr.tree_map(zeros, params), "v": tr.tree_map(zeros, params)}


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, opt_state, step):
    """Returns (new_params, new_opt_state, metrics {"grad_norm", "lr"})."""
    flat_p = tr.leaves(params)
    g32 = [g.float() for g in tr.leaves(grads)]
    m = tr.leaves(opt_state["m"])
    v = tr.leaves(opt_state["v"])
    # global-norm clip (fp32)
    gnorm = torch.sqrt(torch.sum(torch.stack(torch._foreach_norm(g32)) ** 2))
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = cosine_schedule(cfg, step)
    t = torch.as_tensor(step).to(torch.float32) + 1.0
    bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=t.device), t)
    bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=t.device), t)

    # fresh buffers from here on (`.float()` of a float32 leaf is the leaf
    # itself, and the caller's gradients and moments stay as they were)
    g32 = torch._foreach_mul(g32, scale)
    m_new = torch._foreach_mul(m, cfg.b1)
    torch._foreach_add_(m_new, torch._foreach_mul(g32, 1 - cfg.b1))
    gg = torch._foreach_mul(g32, 1 - cfg.b2)
    torch._foreach_mul_(gg, g32)
    del g32
    v_new = torch._foreach_mul(v, cfg.b2)
    torch._foreach_add_(v_new, gg)
    del gg
    delta = torch._foreach_div(m_new, bc1)  # mhat
    denom = torch._foreach_div(v_new, bc2)  # vhat
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, cfg.eps)
    torch._foreach_div_(delta, denom)
    del denom
    p32 = [p.float() for p in flat_p]
    torch._foreach_add_(delta, torch._foreach_mul(p32, cfg.weight_decay))
    torch._foreach_mul_(delta, lr)
    new_p = [q.to(p.dtype) for q, p in zip(torch._foreach_sub(p32, delta), flat_p)]
    return (
        tr.unflatten(params, new_p),
        {"m": tr.unflatten(opt_state["m"], m_new), "v": tr.unflatten(opt_state["v"], v_new)},
        {"grad_norm": gnorm, "lr": lr},
    )
