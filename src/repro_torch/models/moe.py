"""Mixture-of-experts FFN (DeepSeek-V2 / Moonlight style), in PyTorch.

Counterpart of `repro.models.moe`.  Top-k routed experts plus optional
always-on shared experts; the router runs in float32 (its weight is
float32 whatever the model's dtype) with the Switch-style load-balance
loss.

Two dispatch routes, equal up to capacity drops:

  * "gather" — capacity-bounded scatter and gather: each assignment takes
    a slot of an (E, C, d) buffer by its position within its expert (a
    cumulative sum over the one-hot assignments, in token order, so the
    last tokens are the ones dropped), the experts run as batched products
    over the stacked buffer, and the results come back with the combine
    weights.  The production route.
  * "dense" — every expert on every token, masked combine.  The oracle.

The expert products are `torch.matmul` / `torch.bmm` over the stacked
(E, C, d) buffer, as the reference's einsums are outside any Pallas
kernel.  Nothing syncs the host: no boolean-mask indexing, no `.item()`.
A token's k contributions are contiguous (`tok_f` repeats each token k
times), so the combine is a sum over k in a fixed order where the
reference adds into a zero buffer.
"""

from __future__ import annotations

import dataclasses

import torch

from .common import ACTIVATIONS, Init


@dataclasses.dataclass(frozen=True)
class MoESpec:
    d_model: int
    d_ff: int  # per-expert hidden dim
    n_experts: int
    top_k: int
    n_shared: int = 0  # always-on shared experts (same d_ff each)
    capacity_factor: float = 1.25
    act: str = "silu"


def init_moe(init: Init, spec: MoESpec, name: str = "moe"):
    with init.scope(name):
        init.param("router", (spec.d_model, spec.n_experts), ("fsdp", None), dtype=torch.float32)
        init.param("w_gate", (spec.n_experts, spec.d_model, spec.d_ff), ("model", "fsdp", None))
        init.param("w_up", (spec.n_experts, spec.d_model, spec.d_ff), ("model", "fsdp", None))
        init.param("w_down", (spec.n_experts, spec.d_ff, spec.d_model), ("model", None, "fsdp"))
        if spec.n_shared:
            init.param("shared_gate", (spec.d_model, spec.n_shared * spec.d_ff), ("fsdp", "model"))
            init.param("shared_up", (spec.d_model, spec.n_shared * spec.d_ff), ("fsdp", "model"))
            init.param("shared_down", (spec.n_shared * spec.d_ff, spec.d_model), ("model", "fsdp"))


def _router(params, spec: MoESpec, x, name: str):
    """float32 router: returns (weights (B,S,k), ids (B,S,k), aux_loss)."""
    logits = torch.matmul(x.float(), params[f"{name}/router"])
    probs = torch.softmax(logits, dim=-1)
    weights, ids = torch.topk(probs, spec.top_k, dim=-1)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance loss: E * mean(frac_tokens * frac_probs)
    one_hot = _one_hot(ids[..., 0], spec.n_experts, torch.float32)  # top-1 assignment share
    frac_tokens = one_hot.mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    aux = spec.n_experts * torch.sum(frac_tokens * frac_probs)
    return weights, ids, aux


def _on_token_shards(x):
    """The router's input: on a DTensor, `x` with its sequence dim also split
    over the mesh dims that replicate it (where they divide it; a local
    slice), so that each rank routes its own tokens and the routing's
    gradient returns onto them; otherwise `x`."""
    if not torch.distributed.is_available():
        return x
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(x, DTensor):
        return x
    pl, parts = list(x.placements), 1
    for i, p in enumerate(pl):
        if p.is_replicate() and x.shape[1] % (parts * x.device_mesh.size(i)) == 0:
            pl[i], parts = Shard(1), parts * x.device_mesh.size(i)
    return x if parts == 1 else x.redistribute(x.device_mesh, pl)


def _shared_experts(params, spec: MoESpec, x, name: str):
    g = torch.matmul(x, params[f"{name}/shared_gate"])
    u = torch.matmul(x, params[f"{name}/shared_up"])
    h = ACTIVATIONS[spec.act](g) * u
    return torch.matmul(h, params[f"{name}/shared_down"])


def moe_ffn(params, spec: MoESpec, x, impl: str = "gather", name: str = "moe"):
    """x: (B,S,d) -> (y: (B,S,d), aux_loss scalar)."""
    weights, ids, aux = _router(params, spec, _on_token_shards(x), name)
    if impl == "dense":
        y = _dense_dispatch(params, spec, x, weights, ids, name)
    elif impl == "gather":
        y = _gather_dispatch(params, spec, x, weights, ids, name)
    else:
        raise ValueError(impl)
    if spec.n_shared:
        y = y + _shared_experts(params, spec, x, name)
    return y, aux


def _expert_ffn(params, spec: MoESpec, xe, name: str):
    """xe: (E, C, d) -> (E, C, d), batched over experts."""
    g = torch.bmm(xe, params[f"{name}/w_gate"])
    u = torch.bmm(xe, params[f"{name}/w_up"])
    h = ACTIVATIONS[spec.act](g) * u
    return torch.bmm(h, params[f"{name}/w_down"])


def _dense_dispatch(params, spec: MoESpec, x, weights, ids, name: str):
    """Oracle: run every expert on every token, combine by routed weight."""
    g = torch.einsum("bsd,edf->bsef", x, params[f"{name}/w_gate"])
    u = torch.einsum("bsd,edf->bsef", x, params[f"{name}/w_up"])
    h = ACTIVATIONS[spec.act](g) * u
    ye = torch.einsum("bsef,efd->bsed", h, params[f"{name}/w_down"])  # (B,S,E,d)
    combine = torch.sum(_one_hot(ids, spec.n_experts, x.dtype) * weights[..., None].to(x.dtype), dim=2)
    return torch.einsum("bsed,bse->bsd", ye, combine)


def capacity(spec: MoESpec, T: int, S: int) -> int:
    """Slots per expert for T tokens of sequences of length S: T at decode
    (S == 1: a token routes to at most k distinct experts, so T slots is the
    exact worst case and nothing drops), else capacity_factor·T·k/E."""
    if S == 1:
        return T
    return max(1, min(T, int(spec.capacity_factor * T * spec.top_k / spec.n_experts)))


def _one_hot(ids, n: int, dtype):
    """One-hot over the last axis by comparison (no host sync on the card)."""
    return (ids[..., None] == torch.arange(n, device=ids.device)).to(dtype)


def _slots(ids_f, n_experts: int, cap: int):
    """(position of each assignment within its expert, kept) for the
    flattened expert ids, in token order."""
    # (E, T·k), so that the count runs along the contiguous axis: over axis
    # 0 of (T·k, E) CUDA's scan walks each expert's column in sequence
    onehot = (torch.arange(n_experts, device=ids_f.device)[:, None] == ids_f[None, :]).to(torch.int32)
    pos = torch.cumsum(onehot, dim=1).gather(0, ids_f[None, :])[0] - 1
    return pos, pos < cap


def _expert_placements(x, w):
    """The placements of the (E, C, d) dispatch buffer for the expert
    products, or None unless both the tokens `x` and the expert weight `w`
    are DTensors: the weight's shards of the expert dim, and the capacity
    dim split over every other mesh dim (the data axes), so that a rank
    runs its experts on its share of the slots.  (Built as one global
    buffer, an `index_put` into replicated zeros, DTensor sharded the
    products' contraction dim instead and ran every expert, on every slot,
    on every rank.)"""
    if not torch.distributed.is_available():
        return None
    from torch.distributed.tensor import DTensor, Shard

    if not (isinstance(x, DTensor) and isinstance(w, DTensor)):
        return None
    return [Shard(0) if isinstance(p, Shard) and p.dim == 0 else Shard(1) for p in w.placements]


def _gather_dispatch(params, spec: MoESpec, x, weights, ids, name: str):
    """Capacity-bounded scatter -> batched expert products -> gather."""
    B, S, d = x.shape
    T, k, E = B * S, spec.top_k, spec.n_experts
    cap = capacity(spec, T, S)
    pl = _expert_placements(x, params[f"{name}/w_gate"])
    if pl is not None:
        return _sharded_dispatch(params, spec, x, weights, ids, name, cap, pl)
    xf = x.reshape(T, d)
    ids_f = ids.reshape(T * k)
    w_f = weights.reshape(T * k)
    tok_f = torch.arange(T * k, device=x.device) // k  # each token k times
    pos, keep = _slots(ids_f, E, cap)

    # scatter tokens into (E + 1, C, d): each kept (e, pos) slot is written
    # once; the overflow bucket E takes the dropped assignments
    e_idx = torch.where(keep, ids_f, E)
    p_idx = torch.where(keep, pos, 0)
    buf = torch.zeros((E + 1, cap, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((e_idx, p_idx), xf[tok_f], accumulate=True)  # out of place
    ye = _expert_ffn(params, spec, buf[:E], name)  # (E, C, d)

    # gather back with the combine weights; a token's k rows are contiguous
    y_tok = ye[torch.where(keep, ids_f, 0), p_idx]  # (T·k, d)
    y_tok = y_tok * (w_f * keep).to(x.dtype)[:, None]
    return y_tok.view(T, k, d).sum(dim=1).reshape(B, S, d)


def _sharded_dispatch(params, spec: MoESpec, x, weights, ids, name: str, cap: int, pl):
    """`_gather_dispatch` on DTensors, each rank building only its own
    part of the (E, C, d) buffer, on the placements `pl`
    (`_expert_placements`).  Every rank takes every token's row and
    routing (gathered over the batch axes: (T, d) and (T, k), where a
    global buffer and its gathered rows are (E + 1, C, d) and (T·k, d)),
    finds the slots that fall in its experts and its capacity range, and
    gathers their rows.  The expert products run on those shards, and each
    rank adds its slots' weighted outputs into a (T, d) partial sum that
    the residual stream's pin reduces (where a replicated result would
    gather every expert's output onto every rank).  Gradients come back as
    partial sums onto the tokens and the routing weights."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    B, S, d = x.shape
    T, k, E = B * S, spec.top_k, spec.n_experts
    mesh = x.device_mesh
    rep, part = [Replicate()] * mesh.ndim, [Partial()] * mesh.ndim

    def everywhere(t, grad=part):
        return t.redistribute(mesh, rep).to_local(grad_placements=grad)

    xf = everywhere(x.reshape(T, d))
    w_f = everywhere(weights.reshape(T * k))
    ids_f = everywhere(ids.reshape(T * k), grad=None)
    dev = xf.device
    pos, keep = _slots(ids_f, E, cap)
    (n_e, n_c, _), (e0, c0, _) = compute_local_shape_and_global_offset((E, cap, d), mesh, pl)
    mine = keep & (ids_f >= e0) & (ids_f < e0 + n_e) & (pos >= c0) & (pos < c0 + n_c)
    # each of the rank's slots: its token (T, a zero row, where no
    # assignment fills it) and its combine weight; the last entry takes
    # every assignment that is not the rank's
    slot = torch.where(mine, (ids_f - e0) * n_c + (pos - c0), n_e * n_c)
    tok_f = torch.arange(T * k, device=dev) // k
    slot_tok = torch.full((n_e * n_c + 1,), T, dtype=torch.long, device=dev).scatter(0, slot, tok_f)[:-1]
    slot_w = torch.zeros(n_e * n_c + 1, dtype=w_f.dtype, device=dev).scatter(0, slot, w_f * mine)[:-1]
    rows = torch.cat([xf, xf.new_zeros(1, d)])[slot_tok]
    xe = DTensor.from_local(rows.view(n_e, n_c, d), mesh, pl, shape=torch.Size((E, cap, d)),
                            stride=(cap * d, d, 1))
    ye = _expert_ffn(params, spec, xe, name).redistribute(mesh, pl).to_local()
    contrib = ye.reshape(n_e * n_c, d) * slot_w.to(x.dtype)[:, None]
    y = torch.zeros(T + 1, d, dtype=x.dtype, device=dev).index_add(0, slot_tok, contrib)[:T]
    y = DTensor.from_local(y, mesh, part, shape=torch.Size((T, d)), stride=(d, 1), grad_placements=rep)
    return y.reshape(B, S, d)
