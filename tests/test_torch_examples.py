"""The port's examples run end to end on the CPU, each in a subprocess
with its own timeout and `--device cpu`: `examples/torch_dag_pipeline.py`
at its full size, the others with `--quick`.  Each asserts its own
demonstrations (agreement within 5σ, the joint search's strict
domination, the event engine's cross-check, the optimizers' picks
against the baseline, the chaos ladder's contract, the controller
against the best fixed policy, every served request's tokens); here they
must exit 0 and print what they showed.

The DAG example runs at its full size (256 jobs x 16 trials, about 6 s
on one CPU core): at `--quick` size (128 x 8) the best uniform policy
is a near-tie between two vectors, and the strict E[C] domination holds
for 7 of 10 seeds in the port and in the reference alike, not for seed 0
in the port (ROADMAP Queue 3).
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _run(*argv: str) -> str:
    # one thread an example: beside the suite's other workers, torch's
    # default of a thread a core made the examples 10-16x slower
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, *argv, "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_fleet_frontier_example_quick_on_the_cpu():
    out = _run(str(ROOT / "examples" / "torch_fleet_frontier.py"), "--quick")
    assert "agreement on every shared cell" in out
    assert "not run on cpu" in out  # the CUDA kernel's comparison needs the card
    assert "best policy" in out


def test_dag_pipeline_example_on_the_cpu():
    out = _run(str(ROOT / "examples" / "torch_dag_pipeline.py"))
    for line in ("strict domination", "coordinate ascent", "critical-path shares", "event-engine ground truth",
                 "500 dag_job rows"):
        assert line in out, line


def test_quickstart_example_quick_on_the_cpu():
    out = _run(str(ROOT / "examples" / "torch_quickstart.py"), "--quick")
    for line in ("closed form", "quadrature", "monte-carlo", "vs baseline", "algorithm 1", "optimizer"):
        assert line in out, line


def test_trace_policy_search_example_quick_on_the_cpu():
    out = _run(str(ROOT / "examples" / "torch_trace_policy_search.py"), "--quick")
    for line in ("=== job2: 488 tasks", "mapreduce r=1 keep", "latency-sensitive", "cost-sensitive",
                 "every pick beats the baseline"):
        assert line in out, line


def test_fleet_sim_example_quick_on_the_cpu():
    out = _run(str(ROOT / "examples" / "torch_fleet_sim.py"), "--quick")
    for line in ("naive replication inflates E[C]", "fused lambda x policy frontier", "capacity planning",
                 "fast/slow mix", "event-engine cross-check"):
        assert line in out, line


def test_fleet_chaos_example_quick_on_the_cpu():
    out = _run(str(ROOT / "examples" / "torch_fleet_chaos.py"), "--quick")
    for line in ("during outage", "chaos counters", "availability", "inside the outage window only",
                 "chaos drill passed"):
        assert line in out, line


def test_fleet_adaptive_example_quick_on_the_cpu():
    out = _run(str(ROOT / "examples" / "torch_fleet_adaptive.py"), "--quick")
    for line in ("best pre-shift fixed policy", "adaptive controller (plans on cpu)", "drift", "adaptive beats",
                 "SLO burn", "#1 slow", "torch_fleet_dashboard.html"):
        assert line in out, line


def test_hedged_serving_example_quick_on_the_cpu():
    out = _run(str(ROOT / "examples" / "torch_hedged_serving.py"), "--quick")
    for line in ("reduced qwen2-0.5b", "plain-1", "hedged-1", "requests served",
                 "the CPU runs its plain version"):
        assert line in out, line


@pytest.mark.parametrize("example", ["torch_fleet_frontier.py", "torch_dag_pipeline.py", "torch_quickstart.py",
                                     "torch_trace_policy_search.py", "torch_fleet_sim.py", "torch_fleet_chaos.py",
                                     "torch_fleet_adaptive.py", "torch_hedged_serving.py"])
def test_examples_document_how_to_run_them(example):
    doc = (ROOT / "examples" / example).read_text()
    assert f"python examples/{example}" in doc and "--device cpu" in doc and "--quick" in doc
