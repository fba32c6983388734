"""Guards on the port's boundaries: it never imports JAX or the JAX package,
its entry points never fall back quietly to the CPU, and its kernel
wrappers refuse inputs their kernels do not take."""

import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import ShiftedExp, SingleForkPolicy
from repro_torch.core.bootstrap import estimate
from repro_torch.fleet import vector
from repro_torch.kernels import ops

ROOT = Path(__file__).resolve().parents[1]
MODULES = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))


def test_every_port_module_imports_without_jax_or_repro():
    code = (
        "import importlib, sys\n"
        f"for name in {MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
    )
    env = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}{os.pathsep}{ROOT}"}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(MODULES) >= 20


def test_no_source_line_imports_jax_or_repro():
    pattern = re.compile(r"^\s*(import jax|from jax|import repro\b|from repro\b|from repro\.)")
    files = [*sorted((ROOT / "src" / "repro_torch").rglob("*.py")), ROOT / "chip_smoke.py",
             *sorted((ROOT / "examples").glob("torch_*.py"))]
    assert len(files) > 60 and ROOT / "examples" / "torch_dag_pipeline.py" in files
    hits = [f"{f}:{i}" for f in files for i, line in enumerate(f.read_text().splitlines(), 1)
            if pattern.match(line)]
    assert not hits


def test_entry_points_default_to_the_card_and_never_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dist, pol, kill = ShiftedExp(1.0, 1.0), SingleForkPolicy(0.1, 1, True), SingleForkPolicy(0.1, 1, False)
    x = np.random.default_rng(0).exponential(1.0, 50) + 1.0
    calls = [
        lambda: vector.frontier(dist, [pol], (0.1,), 8, 20, m_trials=2),
        lambda: vector.trace_kill_rollout(x, kill, 0.1, 8, 20, 2),
        lambda: vector.policy_search(x, [pol], 0.1, 8, n_jobs=20, m_trials=2),
        lambda: vector.fleet_rollout(dist, pol, 0.1, 8, 20, 2),
        lambda: estimate(x, pol, m=10),
        lambda: vector.frontier(dist, [pol], (0.1,), 8, 20, m_trials=2, device="cuda"),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()



def test_dag_and_controller_entry_points_default_to_the_card_and_never_fall_back(monkeypatch):
    from repro_torch import dag
    from repro_torch.fleet import FleetConfig, FleetPolicyController, FleetSim

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    two = dag.JobDAG.map_reduce(4, 2, ShiftedExp(1.0, 1.0), ShiftedExp(0.5, 2.0))
    pol = SingleForkPolicy(0.25, 1, True)
    calls = [
        lambda: dag.dag_frontier(two, [two.policies()], (0.1,), 20, m_trials=2),
        lambda: dag.dag_rollout(two, 0.1, 20, 2),
        lambda: dag.exhaustive_search(two, [pol], 0.1, n_jobs=20, m_trials=2),
        lambda: dag.coordinate_search(two, [pol], 0.1, n_jobs=20, m_trials=2),
        lambda: FleetPolicyController(),
        lambda: FleetSim(FleetConfig(capacity=8, adapt=True)),
        lambda: dag.dag_frontier(two, [two.policies()], (0.1,), 20, m_trials=2, device="cuda"),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    # the host-side event engine needs no card, and the CPU paths run
    rep = dag.DagFleetSim(dag.DagFleetConfig(two)).run(dag.poisson_arrivals(5, 0.2))
    assert len(rep.jobs) == 5
    assert dag.dag_frontier(two, [two.policies()], (0.1,), 20, m_trials=2, device="cpu")
    assert FleetPolicyController(device="cpu").device.type == "cpu"


@pytest.mark.parametrize("example", ["torch_fleet_frontier.py", "torch_dag_pipeline.py"])
def test_examples_default_to_the_card_and_never_fall_back(example):
    """Without --device an example wants the card: on a machine without
    one it exits with the port's error before any work."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, str(ROOT / "examples" / example), "--quick"], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "CUDA is not available" in out.stderr, out.stderr[-2000:]
    assert not out.stdout


def test_frontier_hist_tail_is_ported():
    rows = vector.frontier(ShiftedExp(1.0, 1.0), [SingleForkPolicy(0.1, 1, True)], (0.1,), 8, 20,
                           m_trials=2, tail="hist", device="cpu")
    assert {"cost_p99", "evt_xi", "evt_p999", "evt_p9999"} <= set(rows[0])

def test_kw_queue_wrapper_refuses_what_the_kernel_does_not_take():
    a = torch.cumsum(torch.rand(4, 16), dim=1)
    s = torch.rand(4, 16) + 0.5
    sp = torch.ones(2)
    with pytest.raises(TypeError, match="float32"):
        ops.kw_queue(a.double(), s, sp)
    with pytest.raises(TypeError, match="float32"):
        ops.kw_queue(a, s, sp.to(torch.float16))
    with pytest.raises(ValueError, match="contiguous"):
        ops.kw_queue(a.t().contiguous().t(), s, sp)
    with pytest.raises(ValueError, match="shape"):
        ops.kw_queue(a, s[:, :8].contiguous(), sp)
    with pytest.raises(ValueError, match="shape"):
        ops.kw_queue(a[0], s[0], sp)
    with pytest.raises(ValueError, match="speeds"):
        ops.kw_queue(a, s, torch.ones(1, 2))
    with pytest.raises(ValueError, match="device"):
        ops.kw_queue(a.to("meta"), s.to("meta"), sp.to("meta"))


def test_residual_sample_wrapper_refuses_what_the_kernel_does_not_take():
    u = torch.rand(5, 7, 3)
    xs = torch.sort(torch.rand(20)).values
    with pytest.raises(TypeError, match="float32"):
        ops.residual_sample(u.double(), xs)
    with pytest.raises(ValueError, match="contiguous"):
        ops.residual_sample(u.transpose(0, 1), xs)
    with pytest.raises(ValueError, match="contiguous"):
        ops.residual_sample(u, torch.rand(40)[::2])
    with pytest.raises(ValueError, match=r"\(M, s, k\)"):
        ops.residual_sample(u[0], xs)
    with pytest.raises(ValueError, match=r"\(n,\)"):
        ops.residual_sample(u, xs[None])
    with pytest.raises(ValueError, match="device"):
        ops.residual_sample(u.to("meta"), xs.to("meta"))


def test_serving_entry_points_default_to_the_card_and_never_fall_back(monkeypatch):
    from repro_torch.configs import get_reduced
    from repro_torch.core import OnlinePolicyController, optimize
    from repro_torch.launch import serve
    from repro_torch.models.lm import build_model
    from repro_torch.runtime import HedgedServer, SimCluster

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.random.default_rng(0).exponential(1.0, 50) + 1.0
    calls = [
        lambda: serve.run(serve.parse_args(["--reduced", "--batches", "1", "--requests", "2"])),
        lambda: build_model(get_reduced("zamba2-1.2b")).init(),
        lambda: HedgedServer(SimCluster(8, ShiftedExp(1.0, 1.0)), lambda r: r),
        lambda: OnlinePolicyController(),
        lambda: optimize.bootstrap_evaluator(x, m=10)(SingleForkPolicy(0.1, 1, True)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_fleet_serving_and_profile_entry_points_default_to_the_card(monkeypatch):
    from repro_torch.core import ShiftedExp as SE
    from repro_torch.dag import JobDAG
    from repro_torch.obs import kernel_profile
    from repro_torch.runtime import FleetHedgedServer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    two = JobDAG.map_reduce(4, 2, SE(1.0, 1.0), SE(0.5, 2.0))
    calls = [
        lambda: FleetHedgedServer(capacity=8, latency_dist=SE(1.0, 1.0), serve_fn=lambda r: r),
        lambda: FleetHedgedServer(capacity=8, latency_dist=SE(1.0, 1.0), serve_fn=lambda r: r, adapt=False),
        lambda: FleetHedgedServer(dag=two, serve_fn=lambda r: r),
        lambda: kernel_profile(lambda x: x + 1, torch.ones(3)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    srv = FleetHedgedServer(capacity=8, latency_dist=SE(1.0, 1.0), serve_fn=lambda r: r, device="cpu")
    assert srv.device.type == "cpu" and srv.controller.device.type == "cpu"
    assert "peak_bytes" not in kernel_profile(lambda x: x + 1, torch.ones(3), repeats=1, device="cpu")


def test_flash_attention_wrapper_refuses_what_the_kernel_does_not_take():
    q = torch.randn(1, 8, 2, 64)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(TypeError, match="is torch.bfloat16, q is torch.float32"):
        ops.flash_attention(q, q.to(torch.bfloat16), q)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(1, 2), q.transpose(1, 2), q.transpose(1, 2))
    with pytest.raises(ValueError, match=r"\(B, S, H, D\)"):
        ops.flash_attention(q[0], q[0], q[0])
    with pytest.raises(ValueError, match="must share B, H and D"):
        ops.flash_attention(q, torch.randn(1, 8, 2, 32), torch.randn(1, 8, 2, 32))
    with pytest.raises(ValueError, match="must share B, H and D"):
        ops.flash_attention(q, q, torch.randn(1, 9, 2, 64))
    with pytest.raises(ValueError, match="device"):
        ops.flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))


def test_ssd_scan_wrapper_refuses_what_the_kernel_does_not_take():
    Bt, S, H, P, G, N = 1, 10, 4, 8, 2, 4
    x = torch.randn(Bt, S, H, P)
    dt, A, D = torch.rand(Bt, S, H), -torch.rand(H), torch.ones(H)
    B, C = torch.randn(Bt, S, G, N), torch.randn(Bt, S, G, N)
    ok = (x, dt, A, B, C, D)

    def bad(i, t):
        return tuple(t if j == i else a for j, a in enumerate(ok))

    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.ssd_scan(*bad(0, x.double()))
    with pytest.raises(TypeError, match="B is torch.bfloat16"):
        ops.ssd_scan(*bad(3, B.to(torch.bfloat16)))
    with pytest.raises(TypeError, match="dt must be float32"):
        ops.ssd_scan(*bad(1, dt.to(torch.bfloat16)))
    with pytest.raises(ValueError, match="contiguous"):
        ops.ssd_scan(*bad(0, x.transpose(2, 3).contiguous().transpose(2, 3)))
    with pytest.raises(ValueError, match="dt must be"):
        ops.ssd_scan(*bad(1, dt[:, :5].contiguous()))
    with pytest.raises(ValueError, match="A and D"):
        ops.ssd_scan(*bad(2, A[:3].contiguous()))
    with pytest.raises(ValueError, match="one \\(Bt, S, G, N\\) shape"):
        ops.ssd_scan(*bad(4, torch.randn(Bt, S, G, N + 1)))
    with pytest.raises(ValueError, match="multiple of G"):
        ops.ssd_scan(x, dt, A, torch.randn(Bt, S, 3, N), torch.randn(Bt, S, 3, N), D)
    with pytest.raises(ValueError, match="chunk"):
        ops.ssd_scan(*ok, chunk=0)
    with pytest.raises(ValueError, match="device"):
        ops.ssd_scan(*(t.to("meta") for t in ok))


def test_training_entry_points_default_to_the_card_and_never_fall_back(monkeypatch, tmp_path):
    from repro_torch import checkpoint
    from repro_torch.configs import get_reduced
    from repro_torch.data import SyntheticTokenPipeline
    from repro_torch.launch import train
    from repro_torch.runtime import SimCluster, StragglerAwareTrainer, TrainerConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    checkpoint.save(tmp_path, {"a": torch.ones(2)}, step=1)
    calls = [
        lambda: train.main(["--reduced", "--steps", "1"]),
        lambda: StragglerAwareTrainer(SimCluster(8, ShiftedExp(1.0, 1.0)), None, None, {}, TrainerConfig()),
        lambda: SyntheticTokenPipeline(get_reduced("qwen2-0.5b"), batch_size=2, seq_len=8),
        lambda: checkpoint.restore(tmp_path, {"a": torch.zeros(2)}),
        lambda: SyntheticTokenPipeline(get_reduced("qwen2-0.5b"), batch_size=2, seq_len=8, device="cuda"),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert checkpoint.restore(tmp_path, {"a": torch.zeros(2)}, device="cpu")["a"].tolist() == [1.0, 1.0]
    trainer = StragglerAwareTrainer(SimCluster(8, ShiftedExp(1.0, 1.0)), None, None, {}, TrainerConfig(),
                                    device="cpu")
    assert trainer.device.type == "cpu" and trainer.controller.device.type == "cpu"


def test_launch_modules_import_without_jax_or_a_process_group():
    """Every module of `repro_torch.launch` (the dry-run and the roofline
    included) imports without jax or the JAX package, and starts no process
    group at import."""
    names = [m for m in MODULES if m.startswith("repro_torch.launch.")]
    assert {f"repro_torch.launch.{m}" for m in ("mesh", "sharding", "dryrun", "hlo_profile", "roofline", "steps")} <= set(names)
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_flash_and_ssd_wrappers_refuse_dtensors_and_meta_tensors():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.launch.mesh import fake_world

    q = torch.randn(1, 8, 2, 64)
    Bt, S, H, P, G, N = 1, 10, 4, 8, 2, 4
    ssd = (torch.randn(Bt, S, H, P), torch.rand(Bt, S, H), -torch.rand(H), torch.randn(Bt, S, G, N),
           torch.randn(Bt, S, G, N), torch.ones(H))
    for route, call, args in (('attn_impl="chunked"', ops.flash_attention, (q, q, q)),
                              ('ssm_impl="jnp"', ops.ssd_scan, ssd)):
        with pytest.raises(ValueError, match=f"got a meta tensor; shard or trace through {route}"):
            call(*(t.to("meta") for t in args))
        with fake_world(1):
            mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("model",))
            dargs = [distribute_tensor(t, mesh, [Replicate()]) for t in args]
            with pytest.raises(ValueError, match=f"got a DTensor; shard or trace through {route}"):
                call(*dargs)
        assert not torch.distributed.is_initialized()
