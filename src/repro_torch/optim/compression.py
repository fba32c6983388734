"""int8 gradient compression with error feedback (distributed-optimization
trick for cross-pod DP all-reduce; see DESIGN.md).

The straggler-aware executor all-reduces *compressed* gradients across pods
(DCN is the slow link); error feedback accumulates the quantization residual
locally so the scheme stays unbiased over time (EF-SGD).

Counterpart of `repro.optim.compression`: per leaf, scale = max(max|g32|,
1e-12) / 127 and q = clip(round(g32 / scale), -127, 127) as int8, with
`torch.round` rounding half to even as `jnp.round` does.
"""

from __future__ import annotations

import torch

from .. import tree as tr


def init_error_feedback(params):
    return tr.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


@torch.no_grad()
def compress_gradients(grads, error_feedback):
    """-> (int8 values, fp32 scales, new error feedback)."""

    def one(g, e):
        g32 = g.float() + e
        scale = torch.clamp(torch.max(torch.abs(g32)), min=1e-12) / 127.0
        q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
        err = g32 - q.float() * scale
        return q, scale, err

    out = [one(g, e) for g, e in zip(tr.leaves(grads), tr.leaves(error_feedback))]
    return tuple(tr.unflatten(grads, [o[i] for o in out]) for i in range(3))


def decompress_gradients(qs, scales):
    return tr.tree_map(lambda q, s: q.float() * s, qs, scales)
