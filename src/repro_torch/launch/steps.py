"""Step functions (train / prefill / decode) and the abstract train state.

Counterpart of the step functions of `repro.launch.steps`; its sharding
plans (`plan_train`, `plan_prefill`, `plan_decode`) wait for the port's
mesh.  Gradients come from `torch.autograd.grad` over the parameter
tree's leaves, each detached (a view: nothing is copied) and set to
require grad, so the caller's parameters never enter a graph; unused
parameters get zero gradients, as under `jax.grad`.

Rematerialization (`remat`), the reference's `jax.checkpoint` of the
loss: "none" keeps every activation; "full" is `torch.utils.checkpoint`
over the whole loss (the backward recomputes the forward); "dots" is
selective checkpointing that saves the outputs of the matrix products and
recomputes everything else (`checkpoint_dots`).
"""

from __future__ import annotations

import functools

import torch
from torch.utils import checkpoint as tckpt

from .. import tree as tr
from ..models.lm import ModelConfig, build_model
from ..optim import AdamWConfig, adamw_init, adamw_update

REMATS = ("none", "full", "dots")

#: the ops whose outputs "dots" saves: the matrix products that matmul and
#: einsum lower to
_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default}


def _save_dots(ctx, op, *args, **kwargs):
    if op in _DOTS:
        return tckpt.CheckpointPolicy.MUST_SAVE
    return tckpt.CheckpointPolicy.PREFER_RECOMPUTE


def remat_loss(loss_fn, remat: str = "none"):
    """`loss_fn(params, batch)` under the rematerialization `remat`."""
    if remat == "none":
        return loss_fn
    if remat == "full":
        return functools.partial(tckpt.checkpoint, loss_fn, use_reentrant=False)
    if remat == "dots":
        context = functools.partial(tckpt.create_selective_checkpoint_contexts, _save_dots)
        return functools.partial(tckpt.checkpoint, loss_fn, use_reentrant=False, context_fn=context)
    raise ValueError(f"remat must be one of {REMATS}, got {remat!r}")


def value_and_grad(loss_fn):
    """`loss_fn(params, batch) -> (loss, metrics)` to `(params, batch) ->
    ((loss, metrics), grads)`, the reference's `jax.value_and_grad(loss_fn,
    has_aux=True)`: grads has params' tree, and the loss and metrics are
    detached."""

    def fn(params, batch):
        live = [p.detach().requires_grad_() for p in tr.leaves(params)]
        with torch.enable_grad():
            loss, metrics = loss_fn(tr.unflatten(params, live), batch)
            grads = torch.autograd.grad(loss, live, materialize_grads=True)
        metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v for k, v in metrics.items()}
        return (loss.detach(), metrics), tr.unflatten(params, list(grads))

    return fn


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, remat: str = "none"):
    """train_step(state, batch) -> (new_state, metrics {loss, ce, aux,
    grad_norm, lr}); state = {"params", "opt": {"m", "v"}, "step"}."""
    grad = value_and_grad(remat_loss(build_model(cfg).loss, remat))

    def train_step(state, batch):
        (loss, metrics), grads = grad(state["params"], batch)
        new_params, new_opt, opt_metrics = adamw_update(
            opt_cfg, state["params"], grads, state["opt"], state["step"]
        )
        new_state = {"params": new_params, "opt": new_opt, "step": state["step"] + 1}
        return new_state, dict(metrics, loss=loss, **opt_metrics)

    return train_step


def make_prefill_step(cfg: ModelConfig):
    model = build_model(cfg)

    def prefill(params, batch):
        return model.prefill(params, batch)

    return prefill


def make_decode_step(cfg: ModelConfig):
    model = build_model(cfg)

    def decode(params, cache, tokens, position):
        return model.decode_step(params, cache, tokens, position)

    return decode


def abstract_state(cfg: ModelConfig) -> dict:
    """The train state on the meta device: shapes and dtypes, no storage.
    (The reference also returns each leaf's sharding axes; the port keeps
    none until its mesh.)"""
    params = build_model(cfg).init(device="meta")
    return {
        "params": params,
        "opt": adamw_init(params),
        "step": torch.zeros((), dtype=torch.int32, device="meta"),
    }
