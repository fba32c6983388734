"""The port's training path (`Model.loss`, `launch.steps`, `launch.shapes`,
`runtime.trainer`, `launch.train`) against the JAX package, on the CPU.

Both packages get the same float32 weights (seeded random weights of a
reduced config, stacked into the reference's layout and carried back
into the port's by `convert.model_params_from_reference`) and the same batches (the reference's pipeline, as numpy).  Both
train through the reference's default routes, attention "chunked" and the
SSM "jnp".  Tolerances:
- `Model.loss` and its gradients, float32: the loss, ce and aux within
  rtol 1e-4, each gradient leaf within rtol 1e-4 and 1e-4 of its largest
  magnitude (summation orders differ), plus a floor of 1e-6 of the
  largest gradient of the model: the key biases' gradients are zero in
  exact arithmetic (a bias shared by every key shifts all scores of a
  query alike, and softmax ignores the shift), so both packages give
  rounding noise there;
- the reference's trainer tests (tests/test_runtime.py:70-157) on both
  packages, `adapt_policy=False`: the step reports' policy, replicas and
  lost workers equal and their latency and cost within rtol 1e-6 (one
  numpy stream times the cluster; the distributions' float32 quantiles
  round apart by an ulp), losses within rtol 1e-4.  Parameters after AdamW steps are compared
  only where the gradient is not that noise: AdamW's first steps move
  each element by about lr·sign(g), and the sign of noise is noise;
- inside the port: literal replicas against the global gradient within
  1e-5, a restart from a checkpoint bit for bit, and the gradients of
  the three remat modes bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.core import ShiftedExp as JShiftedExp
from repro.core import SingleForkPolicy as JSingleForkPolicy
from repro.data import SyntheticTokenPipeline as JPipeline
from repro.launch import shapes as jshapes
from repro.launch import steps as jsteps
from repro.models.lm import build_model as jbuild
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.runtime import SimCluster as JSimCluster
from repro.runtime import StragglerAwareTrainer as JTrainer
from repro.runtime import TrainerConfig as JTrainerConfig
from repro_torch import tree
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.convert import model_params_from_reference
from repro_torch.core import ShiftedExp, SingleForkPolicy
from repro_torch.kernels import ops
from repro_torch.launch import shapes, steps, train
from repro_torch.models.lm import build_model
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.runtime import SimCluster, StragglerAwareTrainer, TrainerConfig
from repro_torch.runtime.trainer import _split_batch

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The models here are tiny, so torch's intra-op threads buy nothing and,
    beside other test workers on the same cores, make these tests several
    times slower; the thread count is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch):
    """(reference config, port config): float32, the reference's routes."""
    jcfg = jget_reduced(arch).replace(param_dtype=jnp.float32)
    cfg = get_reduced(arch).replace(param_dtype=torch.float32, attn_impl="chunked", ssm_impl="jnp")
    return jcfg, cfg


def reference_tree(params) -> dict:
    """The reference's parameter tree, as numpy, from the port's: the same
    sub-trees and keys, with the per-layer dicts stacked along a leading
    (L, ...) axis."""
    out = {}
    for name, sub in params.items():
        if isinstance(sub, list):
            out[name] = {k: np.stack([layer[k].numpy() for layer in sub]) for k in sub[0]}
        else:
            out[name] = {k: v.numpy() for k, v in sub.items()}
    return out


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """(reference params, the same as numpy): seeded random float32
    weights, stacked into the reference's layout."""
    numpy_tree = reference_tree(build_model(_cfgs(arch)[1]).init(seed=0, device="cpu"))
    return jax.tree.map(jnp.asarray, numpy_tree), numpy_tree


@functools.lru_cache(maxsize=None)
def _jgrad(arch):
    """The reference's jitted `value_and_grad` of its loss, one per arch, so
    that the tests share its compilations."""
    return jax.jit(jax.value_and_grad(jbuild(_cfgs(arch)[0]).loss, has_aux=True))


@functools.lru_cache(maxsize=None)
def _jupdate(opt_cfg):
    """The reference trainer's jitted update_fn for `opt_cfg`."""

    @jax.jit
    def update_fn(state, grads):
        p, o, _ = jadamw_update(opt_cfg, state["params"], grads, state["opt"], state["step"])
        return {"params": p, "opt": o, "step": state["step"] + 1}

    return update_fn


def _port_params(arch):
    return model_params_from_reference(_weights(arch)[1], _cfgs(arch)[1], "cpu")


def _batch(arch, batch_size=2, seq_len=16, step=0):
    numpy_batch = {k: np.array(v) for k, v in JPipeline(jget_reduced(arch), batch_size, seq_len).batch(step).items()}
    port = {k: torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16) if v.dtype == jnp.bfloat16
            else torch.from_numpy(v) for k, v in numpy_batch.items()}
    return {k: jnp.asarray(v) for k, v in numpy_batch.items()}, port


#: leaves whose gradient is zero in exact arithmetic (see the docstring)
SHIFT_INVARIANT = ("attn/bk",)


def _grads_close(got_tree, jgrads, cfg, tol, skip=(), atol=0.0):
    want_tree = model_params_from_reference(jax.tree.map(np.asarray, jgrads), cfg, "cpu")
    floor = 1e-6 * max(float(w.abs().max()) for w in tree.leaves(want_tree))
    for (key, g), w in zip(tree.leaves_with_path(got_tree), tree.leaves(want_tree)):
        if any(key.endswith(f"['{name}']") for name in skip):
            continue
        w = w.numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=tol, atol=max(tol * np.abs(w).max(), floor, atol),
                                   err_msg=key)


# --------------------------------------------------------------- the loss


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "zamba2-1.2b", "moonshot-v1-16b-a3b", "llava-next-34b",
                                  "whisper-small"])
def test_loss_and_gradients_match_the_reference_float32(arch):
    _, cfg = _cfgs(arch)
    jbatch, batch = _batch(arch)
    (jloss, jmet), jgrads = _jgrad(arch)(_weights(arch)[0], jbatch)
    (loss, met), grads = steps.value_and_grad(build_model(cfg).loss)(_port_params(arch), batch)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=1e-4)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(met[k].numpy(), np.asarray(jmet[k], np.float32), rtol=1e-4, atol=1e-6)
    if cfg.moe is not None:
        assert float(met["aux"]) > 0
    assert not loss.requires_grad and all(not g.requires_grad for g in tree.leaves(grads))
    _grads_close(grads, jgrads, cfg, 1e-4)


def test_loss_masks_negative_labels_and_runs_over_the_padded_vocab():
    _, cfg = _cfgs("qwen2-0.5b")
    jbatch, batch = _batch("qwen2-0.5b")
    labels = batch["labels"].clone()
    labels[:, -5:] = -1
    jbatch = dict(jbatch, labels=jnp.asarray(labels.numpy()))
    batch = dict(batch, labels=labels)
    (jloss, _), _ = _jgrad("qwen2-0.5b")(_weights("qwen2-0.5b")[0], jbatch)
    loss, _ = build_model(cfg).loss(_port_params("qwen2-0.5b"), batch)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=1e-5)
    # the logsumexp covers the padded vocabulary's columns too
    assert cfg.padded_vocab > cfg.vocab
    logits, _, _ = build_model(cfg).forward(_port_params("qwen2-0.5b"), batch["tokens"])
    lse_vocab = torch.logsumexp(logits[..., :cfg.vocab].float(), -1)
    assert not torch.allclose(lse_vocab, torch.logsumexp(logits.float(), -1))


# ------------------------------------------------------------- step functions


def test_train_step_matches_the_reference_step():
    jcfg, cfg = _cfgs("qwen2-0.5b")
    jopt, opt = JAdamWConfig(lr=1e-2, warmup_steps=0), AdamWConfig(lr=1e-2, warmup_steps=0)
    jparams, _ = _weights("qwen2-0.5b")
    jstate = {"params": jparams, "opt": jadamw_init(jparams), "step": jnp.zeros((), jnp.int32)}
    params = _port_params("qwen2-0.5b")
    state = {"params": params, "opt": adamw_init(params), "step": torch.zeros((), dtype=torch.int32)}
    jbatch, batch = _batch("qwen2-0.5b")
    jnew, jmet = jax.jit(jsteps.make_train_step(jcfg, jopt))(jstate, jbatch)
    new, met = steps.make_train_step(cfg, opt)(state, batch)
    for k in ("loss", "ce", "grad_norm", "lr"):
        np.testing.assert_allclose(met[k].numpy(), np.asarray(jmet[k]), rtol=1e-4)
    assert int(new["step"]) == 1
    _grads_close(new["opt"]["m"], jnew["opt"]["m"], cfg, 1e-4)
    _grads_close(new["opt"]["v"], jnew["opt"]["v"], cfg, 1e-4)
    _grads_close(new["params"], jnew["params"], cfg, 1e-4, skip=SHIFT_INVARIANT, atol=2e-2 * 1e-2)
    # where the gradient is noise, the step moved each element by at most lr
    for p0, p1 in zip(tree.leaves(params), tree.leaves(new["params"])):
        assert float((p1 - p0).abs().max()) <= 1.01e-2 * (1 + 0.1 * float(p0.abs().max()))


def test_remat_modes_give_the_same_gradients():
    _, cfg = _cfgs("zamba2-1.2b")
    _, batch = _batch("zamba2-1.2b")
    params = _port_params("zamba2-1.2b")
    model = build_model(cfg)
    out = {r: steps.value_and_grad(steps.remat_loss(model.loss, r))(params, batch) for r in steps.REMATS}
    (loss, _), grads = out["none"]
    for r in ("full", "dots"):
        (loss_r, _), grads_r = out[r]
        assert torch.equal(loss, loss_r)
        for a, b in zip(tree.leaves(grads), tree.leaves(grads_r)):
            assert torch.equal(a, b), r
    with pytest.raises(ValueError, match="remat"):
        steps.remat_loss(model.loss, "some")


def test_prefill_and_decode_steps_are_the_models():
    _, cfg = _cfgs("qwen2-0.5b")
    _, batch = _batch("qwen2-0.5b")
    params = _port_params("qwen2-0.5b")
    model = build_model(cfg)
    logits, cache = steps.make_prefill_step(cfg)(params, batch)
    want, _ = model.prefill(params, batch)
    assert torch.equal(logits, want)
    cache = model.grow_cache(cache, 17)
    tok = torch.argmax(logits, -1).to(torch.int32)
    got, _ = steps.make_decode_step(cfg)(params, cache, tok, 16)
    want, _ = model.decode_step(params, cache, tok, 16)
    assert torch.equal(got, want)


def test_decode_specs_equal_a_full_length_prefills_cache():
    """A decode cell's cache stand-ins (a short meta prefill grown to the
    cell's length) have the leaves, shapes and dtypes of a meta prefill at
    the full length, for every config's family."""
    from repro_torch.models.lm import build_model

    for arch in ARCH_IDS:
        cfg = get_reduced(arch)
        S = shapes.SHORT_PREFILL + cfg.vision_patches + 9
        got = shapes.input_specs(cfg, shapes.ShapeSpec("d", S, 3, "decode"))["cache"]
        model = build_model(cfg.replace(attn_impl="chunked", ssm_impl="jnp"))
        _, want = model.prefill(model.init(device="meta"), shapes._batch(cfg, 3, S, labels=False))
        assert [(t.shape, t.dtype) for t in tree.leaves(got)] == [(t.shape, t.dtype) for t in tree.leaves(want)], arch
        assert all(t.device.type == "meta" for t in tree.leaves(got))


def test_input_specs_and_abstract_state_match_the_reference():
    for arch in ARCH_IDS:
        cfg, jcfg = get_config(arch), jget_config(arch)
        for name in ("train_4k", "prefill_32k"):
            got = shapes.input_specs(cfg, shapes.SHAPES[name])
            want = jshapes.input_specs(jcfg, jshapes.SHAPES[name])
            assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in got.items()} == {
                k: (v.shape, str(v.dtype)) for k, v in want.items()}, (arch, name)
            assert all(v.device.type == "meta" for v in got.values())
        for name, shape in shapes.SHAPES.items():
            assert shapes.applicability(cfg, shape) == jshapes.applicability(jcfg, jshapes.SHAPES[name])
    # decode: the cache from a meta prefill, per layer where the reference stacks
    tiny = shapes.ShapeSpec("tiny", 40, 3, "decode")
    for arch in ("qwen2-0.5b", "mamba2-2.7b"):
        got = shapes.input_specs(get_reduced(arch), tiny)
        want = jshapes.input_specs(jget_reduced(arch), jshapes.ShapeSpec("tiny", 40, 3, "decode"))
        n_layers = get_reduced(arch).n_layers
        assert len(got["cache"]) == n_layers
        for part, stacked in zip(got["cache"][0], want["cache"]):
            assert (n_layers, *part.shape) == stacked.shape and part.device.type == "meta"
        assert tuple(got["tokens"].shape) == (3,) and got["position"].shape == ()
    state, state_axes = steps.abstract_state(get_config("qwen2-0.5b"))
    assert state_axes["opt"]["m"] is state_axes["params"] and state_axes["step"] == ()
    leaves = tree.leaves(state)
    assert all(t.device.type == "meta" for t in leaves)
    n = get_config("qwen2-0.5b").param_count()
    assert sum(t.numel() for t in tree.leaves(state["opt"]["m"])) == n
    assert all(t.dtype == torch.float32 for t in tree.leaves(state["opt"]))


# ----------------------------------------------------------------- trainer


def _trainers(tmp_path, literal=False, policy=None, **cluster_kw):
    """tests/test_runtime.py's `_tiny_trainer` in both packages, float32,
    on the same weights: (reference trainer, port trainer)."""
    _, cfg = _cfgs("qwen2-0.5b")
    model = build_model(cfg)
    jparams, _ = _weights("qwen2-0.5b")
    params = _port_params("qwen2-0.5b")
    jopt_cfg = JAdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50)

    def jgrad_fn(params, batch):
        (loss, _), grads = _jgrad("qwen2-0.5b")(params, batch)
        return loss, grads

    loss_and_grad = steps.value_and_grad(model.loss)

    def grad_fn(params, batch):
        (loss, _), grads = loss_and_grad(params, batch)
        return loss, grads

    def update_fn(state, grads):
        p, o, _ = adamw_update(opt_cfg, state["params"], grads, state["opt"], state["step"])
        return {"params": p, "opt": o, "step": state["step"] + 1}

    pol = policy or (0.25, 1, True)

    def config(cls, pol_cls, sub):
        return cls(n_tasks=4, checkpoint_dir=str(tmp_path / sub) if tmp_path else None, checkpoint_every=2,
                   literal_replicas=literal, adapt_policy=False, initial_policy=pol_cls(*pol))

    jtrainer = JTrainer(JSimCluster(12, JShiftedExp(1.0, 1.0), seed=3, **cluster_kw), jgrad_fn, _jupdate(jopt_cfg),
                        {"params": jparams, "opt": jadamw_init(jparams), "step": jnp.zeros((), jnp.int32)},
                        config(JTrainerConfig, JSingleForkPolicy, "ref"))
    trainer = StragglerAwareTrainer(SimCluster(12, ShiftedExp(1.0, 1.0), seed=3, **cluster_kw), grad_fn,
                                    update_fn, {"params": params, "opt": adamw_init(params),
                                                "step": torch.zeros((), dtype=torch.int32)},
                                    config(TrainerConfig, SingleForkPolicy, "port"), device="cpu")
    return jtrainer, trainer


def _same_reports(jrep, rep):
    for field in ("step", "policy", "n_replicas", "lost_workers"):
        assert getattr(rep, field) == getattr(jrep, field), field
    for field in ("latency", "cost"):
        np.testing.assert_allclose(getattr(rep, field), getattr(jrep, field), rtol=1e-6, err_msg=field)
    np.testing.assert_allclose(rep.loss, jrep.loss, rtol=1e-4)


def test_literal_replicas_match_global_grad_in_both_packages():
    """Masked per-shard average == global-batch gradient (soundness of the
    compute-once shortcut), in each package, and the packages agree."""
    jbatch, batch = _batch("qwen2-0.5b", batch_size=8, seq_len=16)
    jlit, lit = _trainers(None, literal=True)
    jglob, glob = _trainers(None, literal=False)
    for a, b in ((jlit, jglob), (lit, glob)):
        _same_reports(a.train_step(jbatch if a is jlit else batch), b.train_step(jbatch if a is jlit else batch))
    _same_reports(jlit.history[0], lit.history[0])
    for a, b in zip(tree.leaves(lit.state["params"]), tree.leaves(glob.state["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-2, rtol=2e-2)


def test_literal_replica_average_equals_the_global_gradient_in_the_port():
    _, cfg = _cfgs("qwen2-0.5b")
    _, batch = _batch("qwen2-0.5b", batch_size=8, seq_len=16)
    params = _port_params("qwen2-0.5b")
    grad = steps.value_and_grad(build_model(cfg).loss)
    (loss, _), want = grad(params, batch)
    shards = _split_batch(batch, 4)
    assert [s["t"].shape[0] for s in _split_batch({"t": torch.zeros(10, 2)}, 4)] == [3, 3, 2, 2]
    outs = [grad(params, s) for s in shards]
    avg = tree.tree_map(lambda *gs: sum(gs) / 4, *[g for _, g in outs])
    np.testing.assert_allclose(float(sum(l for (l, _), _ in outs) / 4), float(loss), rtol=1e-5)
    for a, b in zip(tree.leaves(avg), tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5 * float(b.abs().max()))


def test_checkpoint_restart_resumes_in_both_packages(tmp_path):
    jtrainer, trainer = _trainers(tmp_path)
    for step in range(5):
        jb, b = _batch("qwen2-0.5b", 8, 16, step)
        _same_reports(jtrainer.train_step(jb), trainer.train_step(b))
    # fresh trainers restore the newest checkpoint (checkpoint_every=2 -> 4)
    jtrainer2, trainer2 = _trainers(tmp_path)
    assert jtrainer2.maybe_restore() == trainer2.maybe_restore() == 4
    jb, b = _batch("qwen2-0.5b", 8, 16, 4)
    _same_reports(jtrainer2.train_step(jb), trainer2.train_step(b))
    # the port's restart reproduces its uninterrupted run bit for bit
    assert trainer2.history[-1].loss == trainer.history[-1].loss
    for a, c in zip(tree.leaves(trainer.state), tree.leaves(trainer2.state)):
        assert a.dtype == c.dtype and torch.equal(a, c)


def test_elastic_pool_survives_node_loss_in_both_packages():
    jtrainer, trainer = _trainers(None, node_loss_prob=0.2)
    lost_total = 0
    for step in range(6):
        jb, b = _batch("qwen2-0.5b", 8, 16, step)
        rep = trainer.train_step(b)
        _same_reports(jtrainer.train_step(jb), rep)
        lost_total += len(rep.lost_workers)
    assert lost_total > 0  # failures actually occurred
    assert trainer.cluster.n_alive == jtrainer.cluster.n_alive >= trainer.cfg.n_tasks  # pool refilled


def test_train_main_trains_and_resumes_on_the_cpu(tmp_path, capsys):
    argv = ["--reduced", "--device", "cpu", "--batch", "4", "--seq", "16", "--checkpoint-dir", str(tmp_path),
            "--checkpoint-every", "3", "--log-every", "3"]
    train.main(argv + ["--steps", "6"])
    out = capsys.readouterr().out
    assert out.startswith("arch=qwen2-0.5b (reduced) params=")
    assert "step    6 loss" in out and "done: 6 steps" in out
    res = train.run(train.parse_args(argv + ["--steps", "9"]), log=lambda line: None)
    assert res.resumed == 6 and [r.step for r in res.reports] == [7, 8, 9]
    assert res.step_device_ms is None and len(res.step_ms) == 3
    assert res.trainer.device.type == "cpu" and res.trainer.controller.device.type == "cpu"
    assert build_model(res.pipeline.config).config.attn_impl == "chunked"
    assert res.pipeline.config.ssm_impl == "jnp"


# --------------------------------------------------------- kernel routes


def test_kernel_wrappers_refuse_autograd():
    q = torch.randn(1, 8, 2, 64, requires_grad=True)
    with pytest.raises(RuntimeError, match="flash_attention: the kernel has no backward pass"):
        ops.flash_attention(q, q, q)
    Bt, S, H, P, G, N = 1, 10, 4, 8, 2, 4
    x = torch.randn(Bt, S, H, P)
    dt, A, D = torch.rand(Bt, S, H), -torch.rand(H), torch.ones(H)
    B, C = torch.randn(Bt, S, G, N), torch.randn(Bt, S, G, N)
    A_grad = A.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="ssd_scan: the kernel has no backward pass"):
        ops.ssd_scan(x, dt, A_grad, B, C, D)
    # serving builds no graph: no grad, or grad mode off, runs as before
    with torch.no_grad():
        ops.flash_attention(q, q, q)
        ops.ssd_scan(x, dt, A_grad, B, C, D)
    ops.flash_attention(q.detach(), q.detach(), q.detach())
    ops.ssd_scan(x, dt, A, B, C, D)
    # and a model on the kernel routes refuses to be differentiated
    for arch, kw in (("qwen2-0.5b", {"attn_impl": "kernel"}), ("mamba2-2.7b", {"ssm_impl": "kernel"})):
        _, cfg = _cfgs(arch)
        cfg = cfg.replace(**kw)
        params = build_model(cfg).init(seed=0, device="cpu")
        _, batch = _batch(arch)
        with pytest.raises(RuntimeError, match="no backward pass"):
            steps.value_and_grad(build_model(cfg).loss)(params, batch)
        build_model(cfg).prefill(params, batch)
