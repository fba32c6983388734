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
    files = [*sorted((ROOT / "src" / "repro_torch").rglob("*.py")), ROOT / "chip_smoke.py"]
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
