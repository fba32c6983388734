"""The port's sharding layer (the models' logical axes, `launch.sharding`,
`launch.steps`' plans, `launch.dryrun`, `launch.roofline`) against the JAX
package's, on the CPU.

- Specs, pure Python: for all ten configs at their published widths, on
  tests/test_sharding.py's `FakeMesh` (2 x 16 x 16) and on a 16 x 16
  stand-in, under both rule sets, every parameter's axes and resolved spec
  equal the reference's, the reference's leading "layers" entry dropped
  (the port keeps a list per layer where the reference stacks).  Cache
  axes likewise, for a reduced config of each family.
- Bytes: one rank's shards of `plan_train`'s state for qwen3-32b on both
  production meshes (256 and 512 fake ranks) equal, to the byte, the sum
  the reference's specs give.
- A mini dry-run of reduced configs on the 2 x 4 and 2 x 2 x 2 test
  meshes, a train and a prefill cell each: every cell traces, and FLOPs
  per rank x ranks cover the unsharded step's count; no collective
  gathers whole vocabulary rows of the logits (the loss's logsumexp is
  reduced across the vocabulary's shards); deepseek-v2-236b's expert
  products run E / model-ranks experts on a rank, forward and backward,
  and no rank builds every expert's buffer; qwen3-32b's prefill splits
  its heads (per-rank FLOPs no more than the reference's); the serving
  cells never build the whole embedding table; a decode cell's argument
  bytes equal the reference's specs' shards; one decode plan with its
  cache pinned.  The prefill plan on a one-rank mesh gives the plain
  prefill bit for bit.
- Numbers: a 2-rank gloo run (spawned processes) of the sharded loss, its
  gradients and `plan_train`'s step with the vocabulary sharded over
  "model", against the unsharded step in float32: the losses and the
  gradient norm within 1e-6 relative, each gradient leaf within 1e-6 of
  the model's largest gradient (a fake process group computes no values,
  so this is the check of the sharded arithmetic).  An 8-rank gloo run on
  the 2 x 4 test mesh holds the two DTensor repairs' values the same way:
  the CE and its gradient over vocabulary-sharded logits, and a MoE
  layer's output and gradients with the experts on "model".

No process group outlives its test (the `world` fixture), since xdist
keeps its workers alive between files.  The gloo ranks and the mini
dry-runs run in spawned processes beside the module's other tests (the
`spawned` fixture); their tests read the results.
"""

import dataclasses
import functools
import json
import math

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.launch import shapes as jshapes
from repro.launch import sharding as jshd
from repro.launch import steps as jsteps
from repro.models.lm import build_model as jbuild
from repro_torch import tree
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.launch import dryrun, roofline, shapes, steps
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import fake_world, make_production_mesh, make_test_mesh
from repro_torch.models.lm import build_model
from repro_torch.optim import AdamWConfig


class FakeMesh:  # tests/test_sharding.py's
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}


class FakeMesh2D:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


@dataclasses.dataclass(frozen=True)
class Stand:
    """The port's stand-in: a DeviceMesh's names and shape, no devices."""

    mesh_dim_names: tuple
    shape: tuple


MESHES = {
    "multi": (FakeMesh(), Stand(("pod", "data", "model"), (2, 16, 16))),
    "single": (FakeMesh2D(), Stand(("data", "model"), (16, 16))),
}
RULES = {
    "train": (jshd.rules_train, shd.rules_train),
    "stationary": (jshd.rules_serve_stationary, shd.rules_serve_stationary),
}


def _is_axes(x):
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


@pytest.fixture
def world():
    """`fake_world` for the test's meshes; fails the test if a process
    group outlives it (and destroys that group)."""
    assert not dist.is_initialized()
    yield fake_world
    if dist.is_initialized():
        dist.destroy_process_group()
        pytest.fail("a process group outlived its test")


# ------------------------------------------------------------------ specs


@functools.lru_cache(maxsize=None)
def _trees(arch: str):
    """(reference abstract params, reference specs, port meta params, port
    axes) of the config at its published widths."""
    jparams, jspecs = jbuild(jget_config(arch)).init(jax.random.PRNGKey(0), abstract=True)
    model = build_model(get_config(arch))
    return jparams, jspecs, model.init(device="meta"), model.param_axes()


def _pairs(arch):
    """(key, ref shape, ref axes, port shape, port axes, stacked) for every
    parameter, the reference's per-layer leaves once per port layer."""
    jparams, jspecs, params, axes = _trees(arch)
    assert set(jspecs) == set(axes), arch
    out = []
    for group in axes:
        if isinstance(axes[group], list):
            for i, (lp, la) in enumerate(zip(params[group], axes[group])):
                assert set(la) == set(jspecs[group]), (arch, group)
                for k in la:
                    out.append((f"{group}[{i}]/{k}", jparams[group][k].shape, jspecs[group][k],
                                tuple(lp[k].shape), la[k], True))
            assert len(axes[group]) == jparams[group][next(iter(la))].shape[0]
        else:
            assert set(axes[group]) == set(jspecs[group]), (arch, group)
            for k in axes[group]:
                out.append((f"{group}/{k}", jparams[group][k].shape, jspecs[group][k],
                            tuple(params[group][k].shape), axes[group][k], False))
    return out


@pytest.mark.parametrize("rule_set", sorted(RULES))
@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_reference(arch, mesh_kind, rule_set):
    jmesh, mesh = MESHES[mesh_kind]
    jrules, rules = RULES[rule_set][0](jmesh), RULES[rule_set][1](mesh)
    pairs = _pairs(arch)
    assert len(pairs) == len(tree.leaves(_trees(arch)[2]))
    for key, jshape, jaxes, shape, axes, stacked in pairs:
        want = tuple(jshd.resolve_spec(jaxes, jshape, jmesh, jrules))
        if stacked:
            assert jaxes[0] == "layers" and want[0] is None, key
            jaxes, jshape, want = jaxes[1:], jshape[1:], want[1:]
        assert axes == tuple(jaxes) and shape == tuple(jshape), key
        assert shd.resolve_spec(axes, shape, mesh, rules) == want, key


CACHE_ARCHS = ("qwen2-0.5b", "moonshot-v1-16b-a3b", "deepseek-v2-236b", "mamba2-2.7b", "zamba2-1.2b",
               "whisper-small", "llava-next-34b")


def _strip(axes):
    return axes[1:] if axes and axes[0] == "layers" else axes


@pytest.mark.parametrize("arch", CACHE_ARCHS)
def test_cache_axes_equal_the_reference(arch):
    cfg = get_reduced(arch)
    cache = shapes.input_specs(cfg, shapes.ShapeSpec("d", 40, 2, "decode"))["cache"]
    jcfg = jget_reduced(arch)
    jcache = jshapes.input_specs(jcfg, jshapes.ShapeSpec("d", 40, 2, "decode"))["cache"]
    ref = jbuild(jcfg).cache_axes(jcache)
    got = build_model(cfg).cache_axes(cache)
    if cfg.family == "hybrid":
        segs, attns = ref
        want = ([[tuple(_strip(a) for a in seg)] * len(port) for seg, port in zip(segs, cache[0])],
                [tuple(_strip(a) for a in kv) for kv in attns])
    elif cfg.family == "encdec":
        want = tuple([tuple(_strip(a) for a in part)] * len(c) for part, c in zip(ref, cache))
    else:
        want = [tuple(_strip(a) for a in ref)] * len(cache)
    assert got == want
    # every leaf's axes match its rank
    shd.zip_map(lambda t, ax: (len(ax) == t.ndim) or pytest.fail(f"{arch}: {ax} vs {tuple(t.shape)}"), cache, got)


def test_resolve_divisibility_fallback():
    """tests/test_sharding.py's cases, on the port."""
    mesh = MESHES["multi"][1]
    rules = {"model": ("model",), "fsdp": ("pod", "data"), "batch": ("pod", "data")}
    assert shd.resolve_spec(("fsdp", "model"), (64, 160), mesh, rules) == (("pod", "data"), "model")
    assert shd.resolve_spec(("model",), (8,), mesh, rules)[0] is None
    assert shd.resolve_spec((None, "model"), (10, 56), mesh, rules)[1] is None
    assert shd.resolve_spec(("batch",), (1,), mesh, rules)[0] is None
    stat = dict(rules, fsdp=None)
    assert shd.resolve_spec(("fsdp",), (64,), mesh, stat)[0] is None
    assert shd.rules_serve_stationary(mesh)["fsdp"] is None


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard

    single, multi = MESHES["single"][1], MESHES["multi"][1]
    assert shd.placements(("data", "model"), single) == [Shard(0), Shard(1)]
    assert shd.placements(("model", None, "data"), single) == [Shard(2), Shard(0)]
    assert shd.placements((None, None), single) == shd.replicated(single) == [Replicate(), Replicate()]
    # a multi-pod mesh's DTensors live on its (pod_data, model) view
    assert shd.placements((("pod", "data"), "model"), multi) == [Shard(0), Shard(1)]
    assert shd.batch_sharding(multi, (64, 7), shd.rules_train(multi)) == [Shard(0), Replicate()]
    assert shd.batch_sharding(multi, (1, 7), shd.rules_train(multi)) == [Replicate(), Replicate()]
    with pytest.raises(ValueError, match="not a dim"):
        shd.placements(("data",), multi)


def test_init_param_checks_its_axes():
    from repro_torch.models.common import Init

    init = Init(torch.Generator().manual_seed(0), dtype=torch.float32, device="cpu")
    with init.scope("blk"):
        init.param("w", (4, 6), ("fsdp", "model"))
        with pytest.raises(ValueError, match=r"blk/v: shape \(4,\) vs axes \('fsdp', 'model'\)"):
            init.param("v", (4,), ("fsdp", "model"))
    assert init.specs == {"blk/w": ("fsdp", "model")}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_repairs_keep_the_unsharded_values_bit_for_bit(monkeypatch, dtype):
    """`Model.loss` takes the gold logit as a one-hot sum that stays on the
    vocabulary's shards, and the MoE dispatch accumulates out of place
    (both for DTensor); on plain tensors the values are those of the forms
    they replaced, bit for bit, and so are the loss's gradients."""
    from repro_torch.data import SyntheticTokenPipeline

    cfg = get_reduced("moonshot-v1-16b-a3b").replace(param_dtype=dtype, attn_impl="chunked")
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    batch = SyntheticTokenPipeline(cfg, batch_size=2, seq_len=16, seed=0, device="cpu").batch(0)
    _, metrics = model.loss(params, batch)
    logits = model.forward(params, batch["tokens"])[0]
    # the loss's form before: logsumexp without keepdim, the gold logit indexed at once
    lg, labels = logits.float(), batch["labels"]
    mask, safe = (labels >= 0).float(), torch.clamp(labels, min=0).long()
    gold = torch.gather(lg, -1, safe[..., None])[..., 0]
    ce = torch.sum((torch.logsumexp(lg, dim=-1) - gold) * mask) / torch.clamp(torch.sum(mask), min=1.0)
    assert torch.equal(metrics["ce"], ce)
    # the gather form, the gold logit kept 3-D until `lse - gold`: the same
    # values and the same gradient with respect to the logits
    lg = logits.detach().float().requires_grad_()
    lse = torch.logsumexp(lg, dim=-1, keepdim=True)
    ce = torch.sum((lse - torch.gather(lg, -1, safe[..., None]))[..., 0] * mask) / torch.clamp(torch.sum(mask), min=1.0)
    (want,) = torch.autograd.grad(ce, lg)
    assert torch.equal(metrics["ce"], ce.detach())
    lg2 = logits.detach().float().requires_grad_()
    monkeypatch.setattr(model, "forward", lambda *a, **k: (lg2, None, 0.0))
    (got,) = torch.autograd.grad(model.loss(params, batch)[1]["ce"], lg2)
    assert torch.equal(got, want)
    monkeypatch.undo()
    # the dispatch's form before: in-place accumulation into the zero buffer
    monkeypatch.setattr(torch.Tensor, "index_put", lambda self, *a, **k: self.clone().index_put_(*a, **k))
    assert torch.equal(model.forward(params, batch["tokens"])[0], logits)


# ------------------------------------------------------------------ bytes


def _reference_state_bytes(jcfg, jmesh) -> int:
    state, axes = jsteps.abstract_state(jcfg)
    rules = jshd.rules_train(jmesh)

    def one(ax, arr):
        spec = jshd.resolve_spec(ax, arr.shape, jmesh, rules)
        div = math.prod(jshd._axes_size(jmesh, p) for p in spec if p is not None)
        return math.prod(arr.shape) * np.dtype(arr.dtype).itemsize // div

    return sum(jax.tree.leaves(jax.tree.map(one, axes, state, is_leaf=_is_axes)))


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
def test_train_state_bytes_per_rank_equal_the_reference_shards(world, mesh_kind):
    multi = mesh_kind == "multi"
    with world(512 if multi else 256):
        mesh = make_production_mesh(multi_pod=multi)
        _, (st_pl, _), _, (state, _) = steps.plan_train(get_config("qwen3-32b"), shapes.SHAPES["train_4k"], mesh)
        got = shd.local_bytes(shd.distribute(state, st_pl, mesh))
    assert got == _reference_state_bytes(jget_config("qwen3-32b"), MESHES[mesh_kind][0])


# ------------------------------------------------------------- dry-run


def _unsharded_flops(cfg, shape) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    batch = shapes.input_specs(cfg, shape)
    with FlopCounterMode(display=False) as counter:
        if shape.kind == "train":
            state, _ = steps.abstract_state(cfg)
            steps.make_train_step(cfg, AdamWConfig())(state, batch)
        else:
            steps.make_prefill_step(cfg)(build_model(cfg).init(device="meta"), batch)
    return counter.get_total_flops()


MINI_ARCHS = ("qwen3-32b", "deepseek-v2-236b", "zamba2-1.2b")
MINI_KINDS = ("train", "prefill")
#: the mini dry-run's decode cell: qwen3-32b on 2 x 2 x 2, its cache pinned
#: (its 2 kv heads split over "model", so the pin moves them)
MINI_DECODE = shapes.ShapeSpec("d", 32, 8, "decode")


def _mini_dryrun_worker(multi: bool, out: str) -> None:
    """The mini dry-run's cells of one test mesh, in a spawned process (a
    cold trace costs 7-20 s on torch 2.13, most of it DTensor planning
    each `_StridedShard` redistribution by graph search; a prefill cell
    after its train cell under a second): each record, keyed
    "arch/kind", with the unsharded step's FLOPs and whether a process
    group outlived the cell."""
    torch.set_num_threads(1)
    recs = {}
    for arch in MINI_ARCHS:
        cfg = get_reduced(arch).replace(vocab=512, attn_impl="chunked", ssm_impl="jnp")
        for kind in MINI_KINDS:
            shape = shapes.ShapeSpec("t", 32, 8, kind)
            with fake_world(8):
                rec = dryrun.trace_cell(cfg, shape, make_test_mesh(multi_pod=multi))
            recs[f"{arch}/{kind}"] = dict(rec, unsharded_flops=_unsharded_flops(cfg, shape),
                                          group_outlived=dist.is_initialized())
    if multi:
        cfg = get_reduced("qwen3-32b").replace(vocab=512, attn_impl="chunked")
        with fake_world(8):
            rec = dryrun.trace_cell(cfg, MINI_DECODE, make_test_mesh(multi_pod=True), pin_cache=True)
        recs["qwen3-32b/decode"] = dict(rec, group_outlived=dist.is_initialized())
    with open(out, "w") as f:
        json.dump(recs, f)


@pytest.mark.parametrize("multi", [False, True], ids=["2x4", "2x2x2"])
@pytest.mark.parametrize("arch", MINI_ARCHS)
def test_mini_dryrun_on_the_test_meshes(spawned, arch, multi):
    rec = _results(*spawned[f"dryrun_{multi}"])[f"{arch}/train"]
    assert not rec["group_outlived"] and rec["n_devices"] == 8
    assert rec["cost"]["flops"] * 8 >= rec["unsharded_flops"] > 0
    assert sum(rec["collectives"].values()) > 0 and rec["n_collectives"] > 0
    assert rec["memory"]["peak_memory_in_bytes"] >= rec["memory"]["argument_size_in_bytes"] > 0
    # no rank builds a tensor of the global logits' shape (8, 32, 512): the
    # loss's backward stays on the vocabulary's shards
    assert rec["global_logits_ops"] == {}
    assert 0 < rec["largest_output"]["bytes"] <= rec["memory"]["peak_memory_in_bytes"]
    shape = shapes.ShapeSpec("t", 32, 8, "train")
    row = roofline.analyze_cell(dict(rec, arch=arch, shape="t", mesh="test"), shape)
    assert row["dominant"] in ("compute", "memory", "collective") and row["useful_ratio"] > 0


@pytest.mark.parametrize("multi", [False, True], ids=["2x4", "2x2x2"])
@pytest.mark.parametrize("arch", MINI_ARCHS)
def test_mini_dryrun_prefill_cells_on_the_test_meshes(spawned, arch, multi):
    rec = _results(*spawned[f"dryrun_{multi}"])[f"{arch}/prefill"]
    assert not rec["group_outlived"] and rec["n_devices"] == 8
    assert rec["cost"]["flops"] * 8 >= rec["unsharded_flops"] > 0
    assert rec["memory"]["peak_memory_in_bytes"] >= rec["memory"]["argument_size_in_bytes"] > 0
    assert 0 < rec["largest_output"]["bytes"] <= rec["memory"]["peak_memory_in_bytes"]
    # no rank builds the whole embedding table (the prefill plan keeps it on
    # its vocabulary shards and all-reduces the looked-up rows)
    assert rec["whole_table_ops"] == {}
    shape = shapes.ShapeSpec("t", 32, 8, "prefill")
    row = roofline.analyze_cell(dict(rec, arch=arch, shape="t", mesh="test"), shape)
    assert row["dominant"] in ("compute", "memory", "collective") and row["useful_ratio"] > 0


def _mesh_sizes(multi: bool) -> tuple:
    """(ranks a batch row is split over, ranks the vocabulary is split
    over) on a test mesh under the train rules."""
    return (4, 2) if multi else (2, 4)


@pytest.mark.parametrize("multi", [False, True], ids=["2x4", "2x2x2"])
@pytest.mark.parametrize("arch", MINI_ARCHS)
@pytest.mark.parametrize("kind", MINI_KINDS)
def test_no_collective_gathers_the_vocabulary(spawned, kind, arch, multi):
    """No rank receives whole vocabulary rows of the logits: no all-gather
    or all-to-all on the model axis takes a vocabulary shard (last dim V /
    model ranks) of at least a rank's logits shard's size (B / batch ranks
    x S x V / model ranks), in whatever view: DTensor gathers the shard
    along dim 0 and then reassembles it into (B / batch ranks, S, V).
    (`torch.logsumexp` over the sharded logits did, in the loss's forward
    and backward.)  The literal test, a result whose last dim is V = 512,
    would also match the chunked attention's 512-wide key blocks."""
    rec = _results(*spawned[f"dryrun_{multi}"])[f"{arch}/{kind}"]
    rows, parts = _mesh_sizes(multi)
    shard = (8 // rows) * 32 * (512 // parts)
    gathered = [c for c in rec["collective_shapes"] if c[0] in ("all-gather", "all-to-all") and c[1] == "model"
                and c[2] and c[2][-1] == 512 // parts and math.prod(c[2]) >= shard]
    assert gathered == [], gathered
    assert rec["collective_shapes"] and all(c[1] in ("data", "pod_data", "model") for c in rec["collective_shapes"])


#: `tools/dryrun_flops_ratio.py --package jax`: the reference's per-rank
#: FLOPs against an even 8-way split (XLA's cost analysis) on the mini
#: dry-run's deepseek-v2-236b cells
REFERENCE_MOE_FLOPS_RATIO = {("train", False): 1.2566, ("train", True): 1.3558,
                             ("prefill", False): 1.2403, ("prefill", True): 1.4800}


@pytest.mark.parametrize("multi", [False, True], ids=["2x4", "2x2x2"])
@pytest.mark.parametrize("kind", MINI_KINDS)
def test_moe_experts_run_on_their_shards(spawned, kind, multi):
    """deepseek-v2-236b: every `_expert_ffn` product on a rank, forward
    and backward, runs E / model ranks of the 8 experts (2 on 2 x 4) on C /
    batch ranks of the capacity C = 256 (all tokens) slots: the products
    with an operand or result of the expert weights' (d, f) or (f, d)
    trailing dims (no other product of the cell has them), each of
    2 (E / model) (C / batch) d f FLOPs.  No rank builds the global (E + 1,
    C, d) dispatch buffer or the (E, C, d) outputs of every expert.  The
    rank's FLOPs against an even 8-way split of the unsharded step are no
    more than the reference's on the same cell (the reference's XLA count
    takes in elementwise work too)."""
    from repro_torch.models import moe

    rec = _results(*spawned[f"dryrun_{multi}"])[f"deepseek-v2-236b/{kind}"]
    spec = get_reduced("deepseek-v2-236b").moe
    cap, (d, f) = moe.capacity(spec, 8 * 32, 32), (spec.d_model, spec.d_ff)
    rows, parts = _mesh_sizes(multi)

    def weight_like(shape):
        return tuple(shape[1:]) in ((d, f), (f, d))

    experts = [(a, b) for a, b, _ in rec["bmm_shapes"]
               if weight_like(a) or weight_like(b) or weight_like((a[0], a[1], b[2]))]
    assert len(experts) >= 2 and cap == 256, rec["bmm_shapes"]
    assert {a[0] for a, _ in experts} == {spec.n_experts // parts}, experts
    assert {a[0] * a[1] * a[2] * b[2] for a, b in experts} == {spec.n_experts // parts * cap // rows * d * f}, experts
    # no rank builds the whole dispatch buffer or every expert's outputs:
    # each builds its own slots and adds their outputs into a partial sum
    assert rec["global_expert_ops"] == {}, rec["global_expert_ops"]
    ratio = rec["cost"]["flops"] * 8 / rec["unsharded_flops"]
    print(f"deepseek-v2-236b {kind} {'2x2x2' if multi else '2x4'}: per-rank FLOPs {ratio:.2f}x an even split")
    assert 1.0 <= ratio <= REFERENCE_MOE_FLOPS_RATIO[kind, multi]


#: `tools/dryrun_flops_ratio.py --package jax`: the reference's per-rank
#: FLOPs against an even 8-way split on qwen3-32b's mini prefill cell, 2 x 4
REFERENCE_DENSE_PREFILL_FLOPS_RATIO = 1.5931


def test_dense_prefill_splits_its_heads_over_the_model_axis(spawned):
    """qwen3-32b's prefill on 2 x 4: the chunked attention runs each rank's
    own heads (its 4 query heads split 4 ways, its 2 kv heads replicated),
    so the rank's FLOPs against an even split of the unsharded step are no
    more than the reference's (the attention ran every head on every rank
    of the model axis: 2.66x)."""
    rec = _results(*spawned["dryrun_False"])["qwen3-32b/prefill"]
    ratio = rec["cost"]["flops"] * 8 / rec["unsharded_flops"]
    print(f"qwen3-32b prefill 2x4: per-rank FLOPs {ratio:.2f}x an even split")
    assert 1.0 <= ratio <= REFERENCE_DENSE_PREFILL_FLOPS_RATIO
    # each attention product holds B / 2 rows of 4 / 4 heads
    assert {a[0] for a, b, _ in rec["bmm_shapes"] if a[1] == 32 and 512 in (a[2], b[2])} == {4 * 1}


def test_prefill_plan_on_a_one_rank_mesh_is_the_plain_prefill_bit_for_bit():
    """`plan_prefill` on a one-rank gloo mesh (the attention on its shards,
    the embedding table on its vocabulary shards, the residual stream
    pinned) gives the plain prefill's last logits and cache bit for bit."""
    from repro_torch.launch.mesh import make_device_mesh

    cfg = get_reduced("qwen3-32b").replace(vocab=512, attn_impl="chunked", param_dtype=torch.float32)
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 24), generator=torch.Generator().manual_seed(2),
                                     dtype=torch.int32)}
    want = model.prefill(params, batch)
    mesh = make_device_mesh("cpu")
    try:
        fn, in_pl, _, _ = steps.plan_prefill(cfg, shapes.ShapeSpec("p", 24, 2, "prefill"), mesh)
        got = fn(*shd.distribute((params, batch), in_pl, mesh))
    finally:
        dist.destroy_process_group()
    pairs = list(zip(tree.leaves(got), tree.leaves(want)))
    assert len(pairs) == 1 + 2 * cfg.n_layers
    for g, w in pairs:
        assert torch.equal(g.full_tensor(), w)


class FakeMesh3:  # the 2 x 2 x 2 test mesh's names and sizes, for the reference's rules
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 2, "model": 2}


def test_mini_dryrun_decode_cell(spawned):
    """The mini dry-run's decode cell (qwen3-32b, cache pinned, 2 x 2 x 2):
    a rank's argument bytes equal, to the byte, the shards that the
    reference's specs give its parameters, cache and tokens (the port's
    position is a Python int); the pin gathers each layer's k and v
    shards off the model axis, (B / 4, S, kv heads / 2, D) each; and no
    rank builds the whole embedding table."""
    rec = _results(*spawned["dryrun_True"])["qwen3-32b/decode"]
    assert not rec["group_outlived"] and rec["n_devices"] == 8
    jcfg = jget_reduced("qwen3-32b").replace(vocab=512)
    jmesh, rules = FakeMesh3(), jshd.rules_train(FakeMesh3())
    jparams, jspecs = jbuild(jcfg).init(jax.random.PRNGKey(0), abstract=True)
    inputs = jshapes.input_specs(jcfg, jshapes.ShapeSpec("d", MINI_DECODE.seq_len, MINI_DECODE.global_batch,
                                                         "decode"))

    def shard_bytes(ax, arr):
        spec = jshd.resolve_spec(ax, arr.shape, jmesh, rules)
        div = math.prod(jshd._axes_size(jmesh, p) for p in spec if p is not None)
        return math.prod(arr.shape) * np.dtype(arr.dtype).itemsize // div

    leaves = [(jspecs, jparams), (jbuild(jcfg).cache_axes(inputs["cache"]), inputs["cache"]),
              (("batch",), inputs["tokens"])]
    want = sum(sum(jax.tree.leaves(jax.tree.map(shard_bytes, ax, tr, is_leaf=_is_axes))) for ax, tr in leaves)
    assert rec["memory"]["argument_size_in_bytes"] == want
    cfg = get_reduced("qwen3-32b")
    kv = [MINI_DECODE.global_batch // 4, MINI_DECODE.seq_len, cfg.n_kv_heads // 2, cfg.head_dim]
    assert ["all-gather", "model", kv, [2 * kv[0], *kv[1:]], 2 * cfg.n_layers] in rec["collective_shapes"]
    assert rec["whole_table_ops"] == {}


def test_decode_plan_pins_its_cache(world):
    from torch.distributed.tensor import DTensor

    cfg = get_reduced("qwen3-32b").replace(vocab=512, attn_impl="chunked")
    shape = shapes.ShapeSpec("d", 64, 8, "decode")
    with world(8):
        mesh = make_test_mesh(multi_pod=True)
        fn, (p_pl, c_pl, t_pl, _), (_, c_out), inputs = steps.plan_decode(cfg, shape, mesh, pin_cache=True)
        assert c_out is c_pl
        args = shd.distribute(inputs, (p_pl, c_pl, t_pl, None), mesh)
        with dryrun.LocalCost() as cost:
            logits, cache = fn(*args)
        assert tuple(logits.shape) == (8, cfg.padded_vocab)
        shd.zip_map(lambda t, pl: isinstance(t, DTensor) and list(t.placements) == list(pl)
                    or pytest.fail("cache placements"), cache, c_pl)
    # the pin moves the cache off the model axis and back: collectives
    assert cost.collectives.get("all-gather", 0) > 0


# ------------------------------------------------------- 2 ranks on gloo


GLOO_ARCHS = ("qwen2-0.5b", "moonshot-v1-16b-a3b")


def _gloo_worker(rank: int, store: str, out: str) -> None:
    """One rank of the 2-rank check: mesh (data=1, model=2), so the
    vocabulary (and every 'model' dim that divides) is sharded 2 ways.
    Each gradient leaf's error is taken against the model's largest
    gradient (as the repo compares gradients): leaf by leaf, float32
    rounding of the split sums reaches about 1.2e-6 of a leaf's own
    largest element."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.data import SyntheticTokenPipeline
    from repro_torch.optim import adamw_init

    torch.set_num_threads(1)  # the ranks run beside the module's other tests
    dist.init_process_group("gloo", rank=rank, world_size=2, init_method=f"file://{store}")
    results = {}
    try:
        mesh = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
        for arch in GLOO_ARCHS:
            cfg = get_reduced(arch).replace(param_dtype=torch.float32, attn_impl="chunked", ssm_impl="jnp")
            model = build_model(cfg)
            params = model.init(seed=0, device="cpu")
            batch = SyntheticTokenPipeline(cfg, batch_size=2, seq_len=16, seed=0, device="cpu").batch(0)
            rules = shd.rules_train(mesh)
            p_pl = shd.param_shardings(model.param_axes(), params, mesh, rules)
            dparams = shd.distribute(params, p_pl, mesh)
            dbatch = shd.distribute(batch, steps.batch_shardings(batch, mesh, rules), mesh)

            # the loss and its gradients
            grad = steps._replicated_step(steps.value_and_grad(steps.sharded_loss(cfg, params, mesh, rules)))
            (loss, _), grads = grad(dparams, dbatch)
            (want, _), wgrads = steps.value_and_grad(model.loss)(params, batch)
            top = max(float(g.abs().max()) for g in tree.leaves(wgrads))
            errs = [float((g.full_tensor() - w).abs().max()) for g, w in zip(tree.leaves(grads), tree.leaves(wgrads))]

            # plan_train's step against make_train_step
            fn, (st_pl, b_pl), _, _ = steps.plan_train(cfg, shapes.ShapeSpec("t", 16, 2, "train"), mesh)
            state = {"params": params, "opt": adamw_init(params), "step": torch.zeros((), dtype=torch.int32)}
            new, metrics = fn(shd.distribute(state, st_pl, mesh), shd.distribute(batch, b_pl, mesh))
            _, wmetrics = steps.make_train_step(cfg, AdamWConfig())(state, batch)
            rel = lambda a, b: abs(float(a.full_tensor()) - float(b)) / abs(float(b))
            results[arch] = dict(
                vocab_sharded=p_pl["top"]["unembed"][1].is_shard(1), loss_rel=rel(loss, want),
                grad_rel=max(errs) / top, step_loss_rel=rel(metrics["loss"], wmetrics["loss"]),
                grad_norm_rel=rel(metrics["grad_norm"], wmetrics["grad_norm"]), step=int(new["step"].full_tensor()))
        if rank == 0:
            with open(out, "w") as f:
                json.dump(results, f)
    finally:
        dist.destroy_process_group()


def _ce_and_grad(model, logits, labels):
    """`model.loss`'s CE with the model's forward replaced by `logits`, and
    its gradient with respect to them."""
    model.forward = lambda *a, **k: (logits, None, 0.0)
    ce = model.loss(None, {"tokens": labels, "labels": labels})[1]["ce"]
    return ce, torch.autograd.grad(ce, logits)[0]


def test_loss_on_a_one_rank_mesh_is_the_plain_loss_bit_for_bit():
    """Where no mesh dim of more than one rank shards the vocabulary (the
    one-rank mesh of chip_smoke.py's phase sharded_train, held bit-equal
    to the plain step), the loss takes `torch.logsumexp` as on plain
    tensors: the CE and its gradient bit for bit (the reduced stable form
    rounds differently)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import make_device_mesh

    model = build_model(get_reduced("qwen2-0.5b").replace(vocab=512, param_dtype=torch.float32))
    g = torch.Generator().manual_seed(1)
    logits = 4 * torch.randn(2, 8, model.config.padded_vocab, generator=g)
    labels = torch.randint(0, model.config.vocab, (2, 8), generator=g)
    want = _ce_and_grad(model, logits.clone().requires_grad_(), labels)
    mesh = make_device_mesh("cpu")
    try:
        got = steps._replicated_step(functools.partial(_ce_and_grad, model))(
            distribute_tensor(logits, mesh, [Shard(0), Shard(2)]).requires_grad_(),
            distribute_tensor(labels, mesh, [Shard(0), Replicate()]))
    finally:
        dist.destroy_process_group()
    assert torch.equal(got[0].to_local(), want[0]) and torch.equal(got[1].to_local(), want[1])


def _mesh8_worker(rank: int, store: str, out: str) -> None:
    """One rank of the 2 x 4 test mesh on gloo (8 spawned ranks): the two
    DTensor repairs' values against plain tensors in float32.
    - The loss over vocabulary-sharded logits (Shard(0), Shard(2)),
      through `Model.loss` with the model's forward replaced by the
      logits: the CE and its gradient with respect to the logits.
    - One MoE layer of reduced moonshot-v1-16b-a3b on its compute
      placements (the experts on "model", the tokens on "data"): the
      output, and the gradients of the input and of the expert weights.
    Errors are taken against the largest element of the plain value."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models import moe

    torch.set_num_threads(1)
    dist.init_process_group("gloo", rank=rank, world_size=8, init_method=f"file://{store}")
    res = {}
    try:
        mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
        g = torch.Generator().manual_seed(0)
        err = lambda got, want: float((got.full_tensor() - want).abs().max() / want.abs().max())

        cfg = get_reduced("qwen2-0.5b").replace(vocab=512, param_dtype=torch.float32)
        model = build_model(cfg)
        logits = 4 * torch.randn(8, 16, cfg.padded_vocab, generator=g)
        labels = torch.randint(0, cfg.vocab, (8, 16), generator=g)
        labels[:, :3] = -1
        loss = functools.partial(_ce_and_grad, model)
        ce, want = loss(logits.clone().requires_grad_(), labels)
        dce, got = steps._replicated_step(loss)(
            distribute_tensor(logits, mesh, [Shard(0), Shard(2)]).requires_grad_(),
            distribute_tensor(labels, mesh, [Shard(0), Replicate()]))
        res["ce_rel"] = abs(float(dce.full_tensor()) - float(ce)) / abs(float(ce))
        res["ce_grad_rel"] = err(got, want)

        mcfg = get_reduced("moonshot-v1-16b-a3b").replace(param_dtype=torch.float32)
        layer = next(lp for lp in build_model(mcfg).init(seed=0, device="cpu")["layers"] if "moe/w_gate" in lp)
        lp = {k: v.clone().requires_grad_() for k, v in layer.items() if k.startswith("moe/")}
        x = torch.randn(8, 16, mcfg.d_model, generator=g).requires_grad_()
        r = torch.randn(x.shape, generator=g)

        def ffn(lp, x, r):  # the output and three gradients of <y, r>
            y, _ = moe.moe_ffn(lp, mcfg.moe, x)
            return y, torch.autograd.grad((y * r).sum(), [x, lp["moe/w_gate"], lp["moe/w_down"]])

        y, wants = ffn(lp, x, r)
        on_model = {"moe/w_gate": 0, "moe/w_up": 0, "moe/w_down": 0, "moe/shared_gate": 1, "moe/shared_up": 1,
                    "moe/shared_down": 0}
        dlp = {k: distribute_tensor(v.detach(), mesh, [Replicate(), Shard(on_model[k]) if k in on_model else Replicate()])
               .requires_grad_() for k, v in lp.items()}
        dx = distribute_tensor(x.detach(), mesh, [Shard(0), Replicate()]).requires_grad_()
        dy, gots = steps._replicated_step(ffn)(dlp, dx, distribute_tensor(r, mesh, [Shard(0), Replicate()]))
        res["moe_y_rel"] = err(dy, y.detach())
        res["moe_grad_rel"] = max(err(a, b) for a, b in zip(gots, wants))
        res["expert_placements"] = [str(p) for p in gots[1].placements]
        if rank == 0:
            with open(out, "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module", autouse=True)
def spawned(tmp_path_factory):
    """The module's spawned processes, started when its first test starts
    so that they run beside its other tests: the two gloo ranks, the eight
    of the 2 x 4 mesh, and one mini dry-run worker per test mesh.  Each entry is (processes, result
    file); they are killed at the module's end if still alive."""
    tmp = tmp_path_factory.mktemp("spawned")
    ctx = torch.multiprocessing.get_context("spawn")
    jobs = {"gloo": ([ctx.Process(target=_gloo_worker, args=(r, str(tmp / "store"), str(tmp / "gloo.json")))
                      for r in range(2)], tmp / "gloo.json"),
            "mesh8": ([ctx.Process(target=_mesh8_worker, args=(r, str(tmp / "store8"), str(tmp / "mesh8.json")))
                       for r in range(8)], tmp / "mesh8.json")}
    for multi in (False, True):
        out = tmp / f"dryrun_{multi}.json"
        jobs[f"dryrun_{multi}"] = ([ctx.Process(target=_mini_dryrun_worker, args=(multi, str(out)))], out)
    for procs, _ in jobs.values():
        for p in procs:
            p.start()
    yield jobs
    for procs, _ in jobs.values():
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()


def _results(procs, out) -> dict:
    """The result file of spawned processes, once they have all exited 0
    (300 s at most)."""
    for p in procs:
        p.join(timeout=300)
    assert not any(p.is_alive() for p in procs), "a spawned process did not finish in 300 s"
    assert [p.exitcode for p in procs] == [0] * len(procs)
    return json.loads(out.read_text())


@pytest.mark.parametrize("arch", GLOO_ARCHS)
def test_two_gloo_ranks_equal_the_unsharded_step(spawned, arch):
    res = _results(*spawned["gloo"])[arch]
    assert res["vocab_sharded"] and res["step"] == 1
    for key in ("loss_rel", "grad_rel", "step_loss_rel", "grad_norm_rel"):
        assert res[key] <= 1e-6, (key, res)


def test_repairs_hold_their_values_on_the_2x4_mesh(spawned):
    res = _results(*spawned["mesh8"])
    for key in ("ce_rel", "ce_grad_rel", "moe_y_rel", "moe_grad_rel"):
        assert res[key] <= 1e-6, (key, res)
    # the experts' gradient stays on their shards, a partial sum over the
    # data ranks, each of which ran the experts on its share of the slots
    assert res["expert_placements"] == ["P(sum)", "S(0)"]
