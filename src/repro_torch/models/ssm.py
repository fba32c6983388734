"""Mamba2 block — SSD (state-space duality) form (arXiv:2405.21060), in
PyTorch.

Counterpart of `repro.models.ssm`.  Per head h with state size N:

    H_t = a_t · H_{t-1} + dt_t · B_t ⊗ x_t        H: (P, N)
    y_t = C_t · H_t + D · x_t                      a_t = exp(dt_t · A)

Prefill uses the chunked SSD algorithm: `ssm_full(impl="kernel")` calls
the hand-written CUDA scan (`repro_torch.kernels.ssd_scan`; its plain
version on the CPU), the port's counterpart of the reference's
impl="pallas"; impl="jnp" keeps the reference's pure-array route,
`ssd_chunked`, with its casts.  Decode carries (conv_state, ssm_state) and
costs O(P·N) per token.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .common import ACTIVATIONS, Init, rms_norm


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    d_model: int
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 128

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state

    @property
    def in_dim(self) -> int:
        return 2 * self.d_inner + 2 * self.n_groups * self.d_state + self.n_heads


def init_ssm(init: Init, spec: SSMSpec, name: str = "ssm"):
    with init.scope(name):
        init.param("w_in", (spec.d_model, spec.in_dim), ("fsdp", "model"))
        init.param("conv_w", (spec.d_conv, spec.conv_dim), (None, "model"))
        init.param("conv_b", (spec.conv_dim,), ("model",), init="zeros")
        init.param("A_log", (spec.n_heads,), ("model",), init="zeros", dtype=torch.float32)
        init.param("dt_bias", (spec.n_heads,), ("model",), init="zeros", dtype=torch.float32)
        init.param("D", (spec.n_heads,), ("model",), init="ones", dtype=torch.float32)
        init.param("out_norm", (spec.d_inner,), ("model",), init="ones")
        init.param("w_out", (spec.d_inner, spec.d_model), ("model", "fsdp"))


def _split_in(spec: SSMSpec, zxbcdt):
    d_in, gn = spec.d_inner, spec.n_groups * spec.d_state
    z = zxbcdt[..., :d_in]
    x = zxbcdt[..., d_in:2 * d_in]
    Bc = zxbcdt[..., 2 * d_in:2 * d_in + gn]
    Cc = zxbcdt[..., 2 * d_in + gn:2 * d_in + 2 * gn]
    dt = zxbcdt[..., 2 * d_in + 2 * gn:]
    return z, x, Bc, Cc, dt


def _causal_conv(x, w, b):
    """Depthwise causal conv along seq.  x: (B,S,C), w: (K,C)."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = 0
    for i in range(K):
        out = out + xp[:, i:i + S, :] * w[i]
    return out + b


def segsum(log_a):
    """L[i,j] = sum_{k=j+1..i} log_a_k for i>=j else -inf.  log_a: (..., Q)."""
    Q = log_a.shape[-1]
    cs = torch.cumsum(log_a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones(Q, Q, dtype=torch.bool, device=log_a.device).tril()
    return torch.where(mask, diff, -torch.inf)


def _placed_as(t, ref):
    """On DTensors, `t` on `ref`'s placements (both (batch, chunks, Q,
    heads, ...): the batch and head dims mean the same in each; a local
    slice where `t` is replicated), else `t`.  The SSD's products then run
    on the heads that dt's shards hold; left replicated (B and C repeat
    their groups over every head, and x comes out of the convolution
    unsplit), they ran every head on every rank of the model axis."""
    if not torch.distributed.is_available():
        return t
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor) and isinstance(ref, DTensor) and t.placements != ref.placements:
        return t.redistribute(ref.device_mesh, ref.placements)
    return t


def ssd_chunked(x, dt, A, B, C, D, chunk: int, h0=None):
    """Chunked SSD scan with the reference's casts to x's dtype.

    x: (Bt,S,H,P)  dt: (Bt,S,H)  A: (H,)  B,C: (Bt,S,G,N)  D: (H,)
    h0: optional initial state (Bt,H,P,N).
    Returns (y: (Bt,S,H,P), h_final: (Bt,H,P,N) float32).
    """
    Bt, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    Q = chunk
    S0 = S
    if S % Q:  # pad to a chunk multiple; dt=0 makes padding exact
        pad = Q - S % Q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
        S = x.shape[1]
    nc = S // Q
    rep = H // G
    dtype = x.dtype

    xc = x.reshape(Bt, nc, Q, H, P)
    dtc = dt.reshape(Bt, nc, Q, H).float()
    Bc = B.reshape(Bt, nc, Q, G, N).repeat_interleave(rep, dim=3)
    Cc = C.reshape(Bt, nc, Q, G, N).repeat_interleave(rep, dim=3)
    xc, Bc, Cc = (_placed_as(t, dtc) for t in (xc, Bc, Cc))

    log_a = dtc * A  # (Bt,nc,Q,H)
    log_a_h = log_a.permute(0, 1, 3, 2)  # (Bt,nc,H,Q)
    dt_h = dtc.permute(0, 1, 3, 2)
    Lmat = torch.exp(segsum(log_a_h))

    scores = torch.einsum("bnqhv,bnkhv->bnhqk", Cc, Bc).float()
    gated = scores * Lmat * dt_h[:, :, :, None, :]
    y_intra = torch.einsum("bnhqk,bnkhp->bnqhp", gated.to(dtype), xc)

    a_tail = torch.exp(torch.flip(torch.cumsum(torch.flip(log_a_h, (-1,)), dim=-1), (-1,)) - log_a_h)
    wgt = (a_tail * dt_h).to(dtype)
    chunk_states = torch.einsum("bnhk,bnkhv,bnkhp->bnhpv", wgt, Bc, xc)

    a_chunk = torch.exp(log_a_h.sum(dim=-1))  # (Bt,nc,H)
    h = torch.zeros((Bt, H, P, N), dtype=torch.float32, device=x.device) if h0 is None else h0.float()
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * a_chunk[:, c, :, None, None] + chunk_states[:, c].float()
    h_prev = torch.stack(h_prevs, dim=1)  # state entering each chunk

    a_pref = torch.exp(torch.cumsum(log_a_h, dim=-1))  # (Bt,nc,H,Q)
    y_inter = torch.einsum("bnqhv,bnhpv,bnhq->bnqhp", Cc, h_prev.to(dtype), a_pref.to(dtype))

    y = y_intra + y_inter + xc * D.to(dtype)[:, None]
    return y.reshape(Bt, S, H, P)[:, :S0], h


def ssm_full(params, spec: SSMSpec, x, name: str = "ssm", impl: str = "kernel"):
    """Prefill.  Returns (out, (conv_state, ssm_state))."""
    Bt, S, _ = x.shape
    zxbcdt = torch.matmul(x, params[f"{name}/w_in"])
    z, xs, Bc, Cc, dt_raw = _split_in(spec, zxbcdt)
    xbc = torch.cat([xs, Bc, Cc], dim=-1)
    conv_state = xbc[:, -(spec.d_conv - 1):, :]
    xbc = ACTIVATIONS["silu"](_causal_conv(xbc, params[f"{name}/conv_w"], params[f"{name}/conv_b"]))
    gn = spec.n_groups * spec.d_state
    H, P, G, N = spec.n_heads, spec.head_dim, spec.n_groups, spec.d_state
    xh = xbc[..., :spec.d_inner].reshape(Bt, S, H, P)
    Bh = xbc[..., spec.d_inner:spec.d_inner + gn].reshape(Bt, S, G, N)
    Ch = xbc[..., spec.d_inner + gn:].reshape(Bt, S, G, N)
    dt = F.softplus(dt_raw.float() + params[f"{name}/dt_bias"])
    A = -torch.exp(params[f"{name}/A_log"])

    if impl == "kernel":
        from ..kernels import ops as kops

        y, h_final = kops.ssd_scan(
            xh.contiguous(), dt.contiguous(), A, Bh.contiguous(), Ch.contiguous(),
            params[f"{name}/D"], chunk=spec.chunk,
        )
    elif impl == "jnp":
        y, h_final = ssd_chunked(xh, dt, A, Bh, Ch, params[f"{name}/D"], spec.chunk)
    else:
        raise ValueError(impl)

    y = y.reshape(Bt, S, spec.d_inner)
    y = y * ACTIVATIONS["silu"](z)
    y = rms_norm(y, params[f"{name}/out_norm"])
    out = torch.matmul(y, params[f"{name}/w_out"])
    return out, (conv_state, h_final)


def ssm_decode(params, spec: SSMSpec, x, conv_state, ssm_state, name: str = "ssm"):
    """One-token decode.  conv_state: (B, d_conv-1, conv_dim),
    ssm_state: (B,H,P,N)."""
    Bt = x.shape[0]
    zxbcdt = torch.matmul(x, params[f"{name}/w_in"])
    z, xs, Bc, Cc, dt_raw = _split_in(spec, zxbcdt)
    xbc_new = torch.cat([xs, Bc, Cc], dim=-1)
    window = torch.cat([conv_state, xbc_new], dim=1)  # (B,d_conv,·)
    w = params[f"{name}/conv_w"]
    conv_out = torch.sum(window * w[None], dim=1, keepdim=True) + params[f"{name}/conv_b"]
    xbc = ACTIVATIONS["silu"](conv_out)
    new_conv_state = window[:, 1:, :]

    gn = spec.n_groups * spec.d_state
    H, P, G, N = spec.n_heads, spec.head_dim, spec.n_groups, spec.d_state
    xh = xbc[..., :spec.d_inner].reshape(Bt, H, P)
    Bh = torch.repeat_interleave(xbc[..., spec.d_inner:spec.d_inner + gn].reshape(Bt, G, N), H // G, dim=1)
    Ch = torch.repeat_interleave(xbc[..., spec.d_inner + gn:].reshape(Bt, G, N), H // G, dim=1)
    dt = F.softplus(dt_raw[:, 0].float() + params[f"{name}/dt_bias"])  # (B,H)
    A = -torch.exp(params[f"{name}/A_log"])
    a = torch.exp(dt * A)

    h = ssm_state.float()
    h = h * a[..., None, None] + torch.einsum("bh,bhp,bhn->bhpn", dt, xh.float(), Bh.float())
    y = torch.einsum("bhn,bhpn->bhp", Ch.float(), h).to(x.dtype)
    y = y + xh * params[f"{name}/D"][None, :, None].to(x.dtype)
    y = y.reshape(Bt, 1, spec.d_inner)
    y = y * ACTIVATIONS["silu"](z)
    y = rms_norm(y, params[f"{name}/out_norm"])
    out = torch.matmul(y, params[f"{name}/w_out"])
    return out, new_conv_state, h
