"""The port's token pipeline, AdamW, gradient compression and checkpoints
(`repro_torch.data.pipeline`, `optim`, `checkpoint`, and
`convert.train_state_from_reference`) against the JAX package, on the CPU.

Inputs are drawn from numpy seeds and fed to both packages.  Tolerances:
- the pipeline: tokens, labels and the bfloat16 vlm / encdec extras
  bit-equal (one numpy generator, one rounding);
- AdamW in float32 over 5 steps: parameters, m, v, grad_norm and lr within
  rtol 1e-6, each leaf's elements also within 1e-6 of its largest
  magnitude (the same float32 arithmetic per element, but the global norm
  sums in another order, so the clip's scale can differ by an ulp, and m
  and v then by an ulp of the leaf's scale where b1·m and (1-b1)·g
  cancel); the cosine schedule over its whole step range within rtol 1e-6;
- compression: int8 values equal, scales and error feedback within 1e-7;
- checkpoints: bit-exact round trips (bfloat16 included), the reference's
  on-disk layout (keys, dtype names, shapes, stored bits), and a reference
  checkpoint carried into the port bit-equal.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro import optim as joptim
from repro.configs import get_reduced as jget_reduced
from repro.data import SyntheticTokenPipeline as JPipeline
from repro.data import make_batch_specs as jmake_batch_specs
from repro_torch import checkpoint as ckpt
from repro_torch import optim, tree
from repro_torch.configs import get_reduced
from repro_torch.convert import train_state_from_reference
from repro_torch.data import SyntheticTokenPipeline, make_batch_specs
from repro_torch.models.lm import build_model


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The models here are tiny, so torch's intra-op threads buy nothing and,
    beside other test workers on the same cores, make these tests several
    times slower; the thread count is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    """A torch or jax leaf as numpy (bfloat16 through float32, exactly)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x, np.float32) if x.dtype == jnp.bfloat16 else np.asarray(x)


# ---------------------------------------------------------------- pipeline


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "llava-next-34b", "whisper-small"])
def test_pipeline_is_bit_equal_to_the_reference(arch):
    jp = JPipeline(jget_reduced(arch), batch_size=4, seq_len=24, seed=3)
    pp = SyntheticTokenPipeline(get_reduced(arch), batch_size=4, seq_len=24, seed=3, device="cpu")
    for step in (0, 7):
        want, got = jp.batch(step), pp.batch(step)
        assert sorted(want) == sorted(got)
        for k in want:
            assert got[k].dtype == {"int32": torch.int32, "bfloat16": torch.bfloat16}[str(want[k].dtype)]
            assert tuple(got[k].shape) == want[k].shape
            np.testing.assert_array_equal(_np(got[k]), _np(want[k]))
    for i in range(2):
        for k, v in jp.shard(7, i, 2).items():
            np.testing.assert_array_equal(_np(pp.shard(7, i, 2)[k]), _np(v))
    specs, jspecs = make_batch_specs(get_reduced(arch), 4, 24), jmake_batch_specs(jget_reduced(arch), 4, 24)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in specs.items()} == {
        k: (v.shape, str(v.dtype)) for k, v in jspecs.items()}
    assert all(v.device.type == "meta" for v in specs.values())


# ------------------------------------------------------------------- AdamW


def _tree(rng, scale=1.0):
    """One tree in both packages' layout: a dict, and a list of dicts."""
    shapes = {"top": {"w": (8, 16), "b": (16,)}, "layers": [{"a": (4, 3)}, {"a": (4, 3)}]}
    return tree.tree_map(lambda s: (rng.standard_normal(s) * scale).astype(np.float32), shapes)


def _both(numpy_tree):
    return tree.tree_map(torch.from_numpy, numpy_tree), jax.tree.map(jnp.asarray, numpy_tree)


def _close(got_tree, want_tree, rtol, atol=0.0, leaf_rtol=0.0):
    """Leaf by leaf within rtol, atol and leaf_rtol · max |leaf|."""
    got, want = tree.leaves(got_tree), jax.tree.leaves(want_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = _np(w)
        np.testing.assert_allclose(_np(g), w, rtol=rtol, atol=max(atol, leaf_rtol * np.abs(w).max()))


@pytest.mark.parametrize("grad_scale", [0.01, 10.0])  # clip inactive, then active
def test_adamw_five_steps_match_the_reference(grad_scale):
    rng = np.random.default_rng(0)
    cfg = optim.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=8, weight_decay=0.1, clip_norm=1.0)
    jcfg = joptim.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=8, weight_decay=0.1, clip_norm=1.0)
    params, jparams = _both(_tree(rng))
    opt, jopt = optim.adamw_init(params), joptim.adamw_init(jparams)
    for step in range(5):
        grads, jgrads = _both(_tree(rng, grad_scale))
        params, opt, met = optim.adamw_update(cfg, params, grads, opt, torch.tensor(step, dtype=torch.int32))
        jparams, jopt, jmet = joptim.adamw_update(jcfg, jparams, jgrads, jopt, jnp.asarray(step, jnp.int32))
        for got, want in ((params, jparams), (opt["m"], jopt["m"]), (opt["v"], jopt["v"])):
            _close(got, want, 1e-6, leaf_rtol=1e-6)
        for k in ("grad_norm", "lr"):
            assert met[k].dtype == torch.float32
            np.testing.assert_allclose(_np(met[k]), _np(jmet[k]), rtol=1e-6)
        assert all(t.dtype == torch.float32 for t in tree.leaves(opt))


def test_adamw_leaves_its_inputs_untouched_and_keeps_bf16_params():
    rng = np.random.default_rng(1)
    params, _ = _both(_tree(rng))
    params = tree.tree_map(lambda p: p.to(torch.bfloat16), params)
    grads, _ = _both(_tree(rng, 10.0))
    opt = optim.adamw_init(params)
    before = [t.clone() for t in tree.leaves((params, grads, opt))]
    new_p, new_opt, _ = optim.adamw_update(optim.AdamWConfig(warmup_steps=0), params, grads, opt, torch.tensor(0))
    assert all(torch.equal(a, b) for a, b in zip(before, tree.leaves((params, grads, opt))))
    assert all(p.dtype == torch.bfloat16 for p in tree.leaves(new_p))
    assert all(t.dtype == torch.float32 for t in tree.leaves(new_opt))
    assert optim.AdamWConfig().m_dtype == torch.float32  # kept, and ignored as in the reference


def test_cosine_schedule_matches_the_reference_over_its_range():
    for warm, total in ((10, 100), (0, 50), (1, 30)):
        cfg = optim.AdamWConfig(lr=1e-3, warmup_steps=warm, total_steps=total, min_lr_ratio=0.1)
        jcfg = joptim.AdamWConfig(lr=1e-3, warmup_steps=warm, total_steps=total, min_lr_ratio=0.1)
        steps = np.arange(0, total + 20, dtype=np.int32)
        got = optim.cosine_schedule(cfg, torch.from_numpy(steps))
        np.testing.assert_allclose(got.numpy(), np.asarray(joptim.cosine_schedule(jcfg, jnp.asarray(steps))),
                                   rtol=1e-6)


# ------------------------------------------------------------- compression


def test_compression_matches_the_reference_over_error_feedback_steps():
    rng = np.random.default_rng(2)
    grads0, _ = _both(_tree(rng))
    ef, jef = optim.init_error_feedback(grads0), joptim.init_error_feedback(jax.tree.map(jnp.asarray, _tree(rng)))
    for _ in range(4):
        grads, jgrads = _both(_tree(rng, 3.0))
        q, s, ef = optim.compress_gradients(grads, ef)
        jq, js, jef = joptim.compress_gradients(jgrads, jef)
        for a, b in zip(tree.leaves(q), jax.tree.leaves(jq)):
            assert a.dtype == torch.int8
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        _close(s, js, 1e-7, 1e-7)
        _close(ef, jef, 1e-7, 1e-7)
        _close(optim.decompress_gradients(q, s), joptim.decompress_gradients(jq, js), 1e-7, 1e-7)


def test_round_is_half_to_even_as_in_the_reference():
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5], np.float32)
    np.testing.assert_array_equal(torch.round(torch.from_numpy(x)).numpy(), np.asarray(jnp.round(x)))


# ------------------------------------------------------------- checkpoints


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {
            "w": torch.randn(8, 16, generator=g).to(torch.bfloat16),
            "b": torch.arange(16, dtype=torch.float32),
            "layers": [{"a": torch.randn(3, generator=g)}, {"a": torch.randn(3, generator=g)}],
        },
        "opt": {"m": torch.ones(8, 16)},
        "step": torch.tensor(7, dtype=torch.int32),
    }


def test_roundtrip_bitexact(tmp_path):
    state = _state()
    ckpt.save(tmp_path, state, step=7)
    like = tree.tree_map(torch.zeros_like, state)
    restored = ckpt.restore(tmp_path, like, device="cpu")
    for a, b in zip(tree.leaves(state), tree.leaves(restored)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)
    # `like` on the meta device gives structure and dtypes only
    meta = ckpt.restore(tmp_path, tree.tree_map(lambda t: t.to("meta"), state), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(state), tree.leaves(meta)))


def test_checkpoint_layout_is_the_references(tmp_path):
    """The same state saved by both packages: one manifest (keys, dtype
    names, shapes) and the same stored arrays; each package reads the
    other's."""
    state = _state(1)
    jstate = jax.tree.map(lambda t: jnp.asarray(_np(t), jnp.bfloat16 if t.dtype == torch.bfloat16 else None), state)
    ckpt.save(tmp_path / "port", state, step=3)
    jckpt.save(tmp_path / "ref", jstate, step=3)
    manifests = [json.loads((tmp_path / d / "step_3" / "manifest.json").read_text()) for d in ("port", "ref")]
    for k in ("keys", "dtypes", "shapes"):
        assert manifests[0][k] == manifests[1][k]
    assert manifests[0]["dtypes"]["['params']['w']"] == "bfloat16"
    assert "['params']['layers'][1]['a']" in manifests[0]["keys"]
    with np.load(tmp_path / "port/step_3/arrays.npz") as a, np.load(tmp_path / "ref/step_3/arrays.npz") as b:
        for key in manifests[0]["keys"]:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])
    from_ref = ckpt.restore(tmp_path / "ref", state, device="cpu")
    from_port = jckpt.restore(tmp_path / "port", jstate)
    for a, b, c in zip(tree.leaves(state), tree.leaves(from_ref), jax.tree.leaves(from_port)):
        assert torch.equal(a, b)
        np.testing.assert_array_equal(_np(a), _np(c))


def test_latest_and_retention(tmp_path):
    state = _state()
    for step in (1, 2, 3, 4, 5):
        ckpt.save(tmp_path, state, step=step, keep=2)
    assert ckpt.latest_step(tmp_path) == 5
    assert ckpt.all_steps(tmp_path) == [4, 5]
    assert ckpt.latest_step(tmp_path / "none") is None


def test_atomicity_tmpdirs_cleaned(tmp_path):
    ckpt.save(tmp_path, _state(), step=1)
    assert not [p for p in tmp_path.iterdir() if p.name.startswith(".tmp")]
    # a tmp dir left by a crash is never taken for a checkpoint
    (tmp_path / ".tmp_step_9_1").mkdir()
    assert ckpt.all_steps(tmp_path) == [1]


def test_restore_missing_key_fails(tmp_path):
    ckpt.save(tmp_path, {"a": torch.ones(3)}, step=1)
    with pytest.raises(KeyError):
        ckpt.restore(tmp_path, {"a": torch.ones(3), "b": torch.ones(2)}, device="cpu")


def test_restore_without_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path / "empty", {"a": torch.ones(1)}, device="cpu")


def test_reference_train_state_checkpoint_carries_into_the_port_bit_equal(tmp_path):
    """launch/train.py's state, saved by `repro.checkpoint`, read back with
    numpy and carried into the port by `train_state_from_reference`."""
    rng = np.random.default_rng(4)
    like = build_model(get_reduced("qwen2-0.5b")).init(device="meta")  # bfloat16 parameters
    # the reference's layout: layers stacked along a leading (L, ...) axis
    shapes = {name: ({k: (len(sub), *sub[0][k].shape) for k in sub[0]} if isinstance(sub, list)
                     else {k: tuple(t.shape) for k, t in sub.items()}) for name, sub in like.items()}
    draw = lambda dtype: jax.tree.map(lambda s: jnp.asarray(rng.standard_normal(s), dtype), shapes,
                                      is_leaf=lambda s: isinstance(s, tuple))
    jparams = draw(jnp.bfloat16)
    jopt = {"m": draw(jnp.float32), "v": draw(jnp.float32)}
    jstate = {"params": jparams, "opt": jopt, "step": jnp.asarray(11, jnp.int32)}
    jckpt.save(tmp_path, jstate, step=11)
    numpy_state = jax.tree.map(np.asarray, jckpt.restore(tmp_path, jstate))
    state = train_state_from_reference(numpy_state, get_reduced("qwen2-0.5b"), "cpu")

    assert int(state["step"]) == 11 and state["step"].dtype == torch.int32
    assert [(k, t.dtype) for k, t in tree.leaves_with_path(state["params"])] == [
        (k, t.dtype) for k, t in tree.leaves_with_path(like)]
    for k in ("m", "v"):
        assert all(t.dtype == torch.float32 for t in tree.leaves(state["opt"][k]))
    for name, sub in (("params", jparams), ("m", jopt["m"]), ("v", jopt["v"])):
        port = state["params"] if name == "params" else state["opt"][name]
        for key, leaf in sub.items():
            if isinstance(port[key], list):  # stacked (L, ...) layers
                for i, layer in enumerate(port[key]):
                    for k2, arr in leaf.items():
                        np.testing.assert_array_equal(_np(layer[k2]), _np(arr[i]))
            else:
                for k2, arr in leaf.items():
                    np.testing.assert_array_equal(_np(port[key][k2]), _np(arr))
    # and the port's own checkpoint of it round-trips bit for bit
    ckpt.save(tmp_path / "port", state, step=11)
    back = ckpt.restore(tmp_path / "port", state, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(state), tree.leaves(back)))
