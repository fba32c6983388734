"""Step functions (train / prefill / decode) and their mesh placements.

Counterpart of `repro.launch.steps`.  Gradients come from
`torch.autograd.grad` over the parameter tree's leaves, each detached (a
view: nothing is copied) and set to require grad, so the caller's
parameters never enter a graph; unused parameters get zero gradients, as
under `jax.grad`.

Rematerialization (`remat`), the reference's `jax.checkpoint` of the
loss: "none" keeps every activation; "full" is `torch.utils.checkpoint`
over the whole loss (the backward recomputes the forward); "dots" is
selective checkpointing that saves the outputs of the matrix products and
recomputes everything else (`checkpoint_dots`).

`plan_train` / `plan_prefill` / `plan_decode` return `(fn,
in_placements, out_placements, inputs)`: `inputs` are meta tensors of the
cell's shapes, `in_placements` a tree of DTensor placement lists in their
structure (`sharding.distribute` makes the DTensors), and `fn` runs the
step on those DTensors under `implicit_replication()` (the model makes
plain tensors, such as positions and masks, which then count as
replicated) and puts the outputs that `out_placements` names on their
placements, as the reference's `out_shardings` pin them.  The dry-run and
the sharded train step on the card both use them.
"""

from __future__ import annotations

import functools

import torch
from torch.utils import checkpoint as tckpt
from torch.utils._python_dispatch import TorchDispatchMode

from .. import tree as tr
from ..models.lm import ModelConfig, build_model
from ..optim import AdamWConfig, adamw_init, adamw_update
from . import sharding as shd
from .shapes import ShapeSpec, input_specs

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


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, remat: str = "none", loss_fn=None):
    """train_step(state, batch) -> (new_state, metrics {loss, ce, aux,
    grad_norm, lr}); state = {"params", "opt": {"m", "v"}, "step"}.
    `loss_fn(params, batch)` defaults to the model's loss (`plan_train`
    passes `sharded_loss`)."""
    grad = value_and_grad(remat_loss(loss_fn or build_model(cfg).loss, remat))

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


def abstract_state(cfg: ModelConfig):
    """(state on the meta device: shapes and dtypes, no storage; each
    leaf's logical sharding axes, in the state's structure)."""
    model = build_model(cfg)
    params = model.init(device="meta")
    axes = model.param_axes()
    state = {
        "params": params,
        "opt": adamw_init(params),
        "step": torch.zeros((), dtype=torch.int32, device="meta"),
    }
    state_axes = {"params": axes, "opt": {"m": axes, "v": axes}, "step": ()}
    return state, state_axes


# ---------------------------------------------------------------------------
# sharding plans
# ---------------------------------------------------------------------------


def state_shardings(cfg: ModelConfig, mesh, rules):
    """(placements tree of the train state, the meta state)."""
    state, axes = abstract_state(cfg)
    return shd.tree_shardings(axes, state, mesh, rules), state


def batch_shardings(batch_specs, mesh, rules):
    return {k: shd.batch_sharding(mesh, v.shape, rules) for k, v in batch_specs.items()}


def _on(tree, placements):
    """`tree`'s DTensors redistributed onto `placements` (a no-op where a
    leaf is there already)."""
    from torch.distributed.tensor import DTensor

    def one(t, pl):
        if isinstance(t, DTensor) and list(t.placements) != list(pl):
            return t.redistribute(t.device_mesh, pl)
        return t

    return shd.zip_map(one, tree, placements)


def _fsdp_gather(cfg: ModelConfig, params, mesh, whole_embed: bool = True):
    """params -> params on their compute placements: each parameter's
    'fsdp' shards gathered (the stationary rules), its 'model' dims left
    sharded, as FSDP gathers a layer's weights before it runs.  Under
    autograd, the gather's backward reduce-scatters the gradients back
    onto the batch axes.  With `whole_embed` (training) the embedding table
    is gathered whole: a lookup in a vocab-sharded table gives a
    `_MaskPartial` that DTensor cannot reduce-scatter into the residual
    stream in the backward.  Without it (prefill and decode, no backward)
    the table stays on its vocabulary shards, and the lookup's partial
    rows are all-reduced where the residual stream is pinned: (batch, seq,
    d) bytes instead of the whole table on every rank at every step."""
    compute = shd.param_shardings(build_model(cfg).param_axes(), params, mesh, shd.rules_serve_stationary(mesh))
    if whole_embed:
        compute["top"]["embed"] = shd.replicated(mesh)
    return lambda p: _on(p, compute)


class _Reshard(TorchDispatchMode):
    """A dispatch mode (above DTensor) that reshards where DTensor would
    refuse: an op whose sharding propagation fails (a view that would split
    a sharded dim unevenly, as reshaping a 14-head q_dim sharded 16 ways
    does) runs again with its DTensor inputs replicated, first on every
    tensor dim but the leading (batch) one, then on all of them.  GSPMD
    inserts such collectives by itself; DTensor asks the caller to."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        try:
            return func(*args, **kwargs)
        except RuntimeError as e:
            if _PROPAGATION_FAILED not in str(e):
                raise
        try:
            return func(*_replicated(args, keep_leading=True), **_replicated(kwargs, keep_leading=True))
        except RuntimeError as e:
            if _PROPAGATION_FAILED not in str(e):
                raise
        return func(*_replicated(args, keep_leading=False), **_replicated(kwargs, keep_leading=False))


_PROPAGATION_FAILED = "Sharding propagation failed"


def _replicated(tree, keep_leading: bool):
    """`tree` with each DTensor's shards replicated (but those of its
    leading dim, with `keep_leading`)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if isinstance(tree, DTensor):
        pl = [Replicate() if isinstance(p, Shard) and not (keep_leading and p.dim == 0) else p
              for p in tree.placements]
        return tree.redistribute(tree.device_mesh, pl) if pl != list(tree.placements) else tree
    if isinstance(tree, dict):
        return {k: _replicated(v, keep_leading) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_replicated(v, keep_leading) for v in tree)
    return tree


def _on_batch_axes(x, mesh, rules):
    """`x`'s placements with its leading dim on the batch axes and the rest
    replicated, or None where the batch axes do not divide that dim."""
    bd = rules["batch"]
    if not bd or x.ndim == 0 or x.shape[0] % shd._axes_size(mesh, bd):
        return None
    return shd.placements((bd if len(bd) > 1 else bd[0],) + (None,) * (x.ndim - 1), mesh)


def sharded_loss(cfg: ModelConfig, params, mesh, rules):
    """`Model.loss(params, batch)` for parameters on the rules' placements
    (`params`: any tree of the parameters' shapes): the residual stream
    pinned (`_pinned`) and the parameters gathered onto their compute
    placements inside the loss (`_fsdp_gather`), so that autograd carries
    the gradients back onto the parameters' own placements."""
    cfg = _pinned(cfg, mesh, rules)
    gather = _fsdp_gather(cfg, params, mesh)
    loss = build_model(cfg).loss
    return lambda p, batch: loss(gather(p), batch)


def _pinned(cfg: ModelConfig, mesh, rules) -> ModelConfig:
    """`cfg` with its residual stream pinned at every norm: the batch dim on
    the batch axes, everything else replicated (a row-parallel product's
    partial sums are reduced there, as in Megatron's tensor parallelism;
    left to DTensor's per-op choice, the stream drifts onto the model axis
    and the unembedding then all-reduces whole float32 logits)."""
    def pin(x):
        return x.redistribute(x.device_mesh, _on_batch_axes(x, mesh, rules) or shd.replicated(mesh))

    return cfg.replace(activation_constraint=pin)


def _replicated_step(fn):
    """`fn` on DTensors: plain tensors count as replicated, and ops that
    DTensor cannot shard are resharded (`_Reshard`)."""

    def run(*args):
        from torch.distributed.tensor.experimental import implicit_replication

        with implicit_replication(), _Reshard():
            return fn(*args)

    return run


def plan_train(cfg: ModelConfig, shape: ShapeSpec, mesh, remat: str = "none",
               opt_cfg: AdamWConfig | None = None):
    rules = shd.rules_train(mesh)
    st_shard, state = state_shardings(cfg, mesh, rules)
    loss = sharded_loss(cfg, state["params"], mesh, rules)
    step = make_train_step(cfg, opt_cfg or AdamWConfig(), remat=remat, loss_fn=loss)
    batch = input_specs(cfg, shape)
    b_shard = batch_shardings(batch, mesh, rules)

    @_replicated_step
    def fn(state, batch):
        new_state, metrics = step(state, batch)
        return _on(new_state, st_shard), metrics

    return fn, (st_shard, b_shard), (st_shard, None), (state, batch)


def _params_and_shardings(cfg: ModelConfig, mesh, rules):
    model = build_model(cfg)
    params = model.init(device="meta")
    return params, shd.param_shardings(model.param_axes(), params, mesh, rules)


def plan_prefill(cfg: ModelConfig, shape: ShapeSpec, mesh, rules=None):
    rules = rules or shd.rules_train(mesh)
    prefill = make_prefill_step(_pinned(cfg, mesh, rules))
    params, p_shard = _params_and_shardings(cfg, mesh, rules)
    gather = _fsdp_gather(cfg, params, mesh, whole_embed=False)
    batch = input_specs(cfg, shape)
    b_shard = batch_shardings(batch, mesh, rules)

    @_replicated_step
    def fn(params, batch):
        return prefill(gather(params), batch)

    return fn, (p_shard, b_shard), None, (params, batch)


def _decode_cache_constraint(mesh, rules):
    """The decode cache's layout pin: each leaf redistributed onto the batch
    axes on its leading (batch) dim, everything else replicated (a leaf
    whose batch the axes do not divide, or of batch 1, is left as it is)."""

    def constrain(x):
        pl = _on_batch_axes(x, mesh, rules) if x.shape[0] > 1 else None
        return x if pl is None else x.redistribute(x.device_mesh, pl)

    return constrain


def plan_decode(cfg: ModelConfig, shape: ShapeSpec, mesh, rules=None, pin_cache: bool = False):
    """The decode step at position `seq_len - 1` of a full-length cache.
    With `pin_cache`, the step takes its cache on the batch axes alone
    (`_decode_cache_constraint`, where the reference pins each layer's
    cache inside its layer scan); the new cache leaves on the input
    cache's placements either way (the reference's `out_shardings`)."""
    rules = rules or shd.rules_train(mesh)
    inputs = input_specs(cfg, shape)
    cache, tokens = inputs["cache"], inputs["tokens"]
    c_shard = shd.tree_shardings(build_model(cfg).cache_axes(cache), cache, mesh, rules)
    params, p_shard = _params_and_shardings(cfg, mesh, rules)
    gather = _fsdp_gather(cfg, params, mesh, whole_embed=False)
    decode = make_decode_step(_pinned(cfg, mesh, rules))
    t_shard = shd.batch_sharding(mesh, tokens.shape, rules)
    constrain = _decode_cache_constraint(mesh, rules) if pin_cache else None

    @_replicated_step
    def fn(params, cache, tokens, position):
        if constrain is not None:
            cache = shd.zip_map(lambda x, _: constrain(x), cache, cache)
        logits, new_cache = decode(gather(params), cache, tokens, position)
        return logits, _on(new_cache, c_shard)

    position = shape.seq_len - 1
    return fn, (p_shard, c_shard, t_shard, None), (None, c_shard), (params, cache, tokens, position)
