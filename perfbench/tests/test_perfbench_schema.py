"""The last line's schema, on the CPU past the look for a card, and the
refusal without one."""

import json
import os
import subprocess
import sys

import pytest

import pbtest
from bench import spec

BENCH = spec.benchmark()


@pytest.mark.parametrize("name", pbtest.CELLS)
def test_end_to_end_line(name):
    rc, line, err = pbtest.run_tiny(name)
    assert rc == 0 and line is not None
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    want = {m["name"]: m["unit"] for m in BENCH["end_to_end"]}
    assert {k: v["unit"] for k, v in line["metrics"].items()} == want
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for k, v in line["checks"].items():
        assert v["value"] <= v["limit"], k
    tail = err.strip().splitlines()[-4:]
    assert [t.split()[1] for t in tail] == list(line["checks"])


@pytest.mark.parametrize("name", pbtest.CELLS)
def test_traced_line(name):
    rc, line, _ = pbtest.run_tiny(name, trace=True)
    assert rc == 0 and line["correct"] is True
    assert set(line["device"]) >= {"busy_s", "window_s"} and line["device"]["window_s"] > 0
    assert list(line)[-2:] == ["breakdown", "checks"]
    assert len(line["breakdown"]["device_ops"]) <= 10 and len(line["breakdown"]["idle_gaps"]) <= 10
    names = {m["name"] for m in spec.per_layer(BENCH, name)}
    assert set(line["metrics"]) <= names


def test_run_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, str(pbtest.HERE / "run.py"), "--workload", "job1.frontier",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=pbtest.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_one_short_run_on_the_card(tmp_path):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run([sys.executable, str(pbtest.HERE / "run.py"), "--workload", "job1.frontier",
                          "--seed", str(2**35 + 1), "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, timeout=900, cwd=pbtest.ROOT,
                         env=dict(os.environ, TMPDIR=str(tmp_path)))
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
