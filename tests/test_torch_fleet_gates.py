"""`chip_smoke.py`'s gate phases (`fleet_gates`, `dag_gates`) rehearsed on
the CPU, and the port's lanes held against the JAX package.

- Every gate of BENCH_fleet.json is held by a named phase of
  `chip_smoke.py` or printed there with its reason.
- `phase_fleet_gates` and `phase_dag_gates` on the CPU at a reduced size:
  600 jobs become 200 (the event engine on the host sets the time), the
  seeds and trials fewer; the grids, seeds, thresholds and the EVT lane's
  600 jobs x (4, 40) trials are the reference's.  Every gate is returned
  and passes; the timing ratios are printed, not checked, off the card.
- One chaos cell's job records from the port's `FleetSim` equal the
  reference's within rtol 1e-5 on the same workload and seed.
- One shared c = 3 cell of `fleet_rollout` against
  `repro.fleet.vector.fleet_rollout` within 5 combined standard errors
  (the draws are torch's, not threefry's).
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.fleet as jfleet
from repro_torch import core as tcore
from repro_torch import fleet as tfleet
from repro_torch.fleet import vector

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

BENCH_GATES = [g["name"] for g in json.loads((ROOT / "BENCH_fleet.json").read_text())["gates"]]
CPU = torch.device("cpu")
SIZES = dict(
    n=32, c=2, n_jobs=64, m_trials=2, mc_reps=100,
    dag=dict(stages=(("map", 32),), c=2, n_jobs=64, m_trials=2, event_jobs=150, event_trials=6),
    fleet_gates=dict(n_jobs=200, m_trials=12, agree_trials=24, seeds=dict(c1=4, c3=3, het=2), tail_trials=(4, 40),
                     tail_jobs=600, avail_jobs=150, blame_jobs=200, replan_jobs=64, replan_trials=2, attempts=1,
                     obs_reps=1, obs_round_s=0.0),
    dag_gates=dict(n_jobs=256, m_trials=16),
)


@pytest.fixture(scope="module")
def rehearsed():
    """The gates both phases return on the CPU."""
    torch.manual_seed(0)
    gates = chip_smoke.phase_fleet_gates(torch, CPU, SIZES)
    gates.update(chip_smoke.phase_dag_gates(torch, CPU, SIZES))
    return gates


def test_every_bench_fleet_gate_is_held_or_printed():
    src = (ROOT / "chip_smoke.py").read_text()
    assert len(BENCH_GATES) == 26
    for name in BENCH_GATES:
        assert f'"{name}"' in src, name
    assert set(chip_smoke.PRINTED_GATES) == {"adaptive_replan_latency"}
    assert set(chip_smoke.TIMING_GATES) | set(chip_smoke.ADAPTIVE_GATES) <= set(BENCH_GATES)
    # the closing map fails on a gate that no phase holds
    with pytest.raises(RuntimeError, match="not held"):
        chip_smoke.gate_map({})


def test_gate_phases_rehearsed_on_the_cpu_return_every_gate(rehearsed):
    held_elsewhere = {"dag_fused_vs_event_agreement": "dag_event",
                      **{g: "fleet_adaptive" for g in chip_smoke.ADAPTIVE_GATES}}
    assert set(rehearsed) | set(held_elsewhere) == set(BENCH_GATES)
    stand_ins = {g: dict(held=phase, passed=True, checked=True, value={}) for g, phase in held_elsewhere.items()}
    mapped = chip_smoke.gate_map({**rehearsed, **stand_ins})
    assert list(mapped) == BENCH_GATES
    for name, g in rehearsed.items():
        if name in chip_smoke.PRINTED_GATES:
            assert g["held"] == "printed" and g["passed"] is None and g["reason"]
            assert g["value"]["padded_s"] > 0 and g["value"]["unpadded_s"] > 0
        elif name in chip_smoke.TIMING_GATES:
            assert not g["checked"] and g["held"] in ("fleet_gates", "dag_gates")
            assert mapped[name]["reference"] is None  # a CPU time, not quoted
        else:
            assert g["checked"] and g["passed"], (name, g)
            assert mapped[name]["reference"]
    assert rehearsed["algebra_single_fork_bitwise"]["value"]["full_width"]["mismatched_fields"] == 0
    assert rehearsed["chaos_q0_bitwise"]["value"]["mismatched_fields"] == 0
    assert rehearsed["tail_blame_planted"]["value"]["top"] == "slow"


def test_chaos_cell_event_rows_equal_the_reference():
    """One cell of the chaos lane (π_keep(0.1, 1), λ = 0.12, q = 0.1, c = 2
    aligned, retry budget 8): the port's job records are the reference's."""

    def run(m, fl):
        jobs = fl.poisson_workload(150, rate=0.12, n_tasks=16, dist=m.ShiftedExp(1.0, 1.0), seed=120)
        return fl.FleetSim(fl.FleetConfig(capacity=32, policy=m.SingleForkPolicy(0.1, 1, True), seed=0,
                                          placement="aligned", fault=fl.FaultSpec(q=0.1, max_attempts=8))).run(jobs)

    ref, got = run(jcore, jfleet), run(tcore, tfleet)
    rows = lambda rep: np.array([[r.arrival, r.start, r.finish, r.cost, r.n_replicas] for r in rep.records])
    np.testing.assert_allclose(rows(got), rows(ref), rtol=1e-5, atol=1e-6)
    assert got.n_retries == ref.n_retries > 0
    assert got.stats.sojourn_std_err == pytest.approx(ref.stats.sojourn_std_err, rel=1e-5)


def test_shared_c3_cell_agrees_with_the_reference_rollout():
    from repro.fleet import vector as jvector

    pol = (0.1, 1, True)
    ref = jvector.fleet_rollout(jcore.ShiftedExp(1.0, 1.0), jcore.SingleForkPolicy(*pol), 0.36, 16, 200, 24, c=3)
    got = vector.fleet_rollout(tcore.ShiftedExp(1.0, 1.0), tcore.SingleForkPolicy(*pol), 0.36, 16, 200, 24, c=3,
                               device="cpu")
    sigma = np.hypot(ref.sojourn_std_err, got.sojourn_std_err)
    assert abs(got.mean_sojourn - ref.mean_sojourn) <= 5 * sigma
    assert abs(got.mean_cost - ref.mean_cost) <= 0.1


@pytest.mark.parametrize("n", [2, 7, 100, 7200, 32768])
def test_exact_percentiles_equal_numpys(n):
    """The frontier's exact tail keys come from a sort where the sojourns
    lie (`vector.exact_percentiles`): bit-equal to `np.percentile`'s linear
    rule, row by row, ties included."""
    x = np.random.default_rng(n).exponential(1.0, (4, n)).astype(np.float32)
    x[1] = np.round(x[1], 1)  # ties
    got = vector.exact_percentiles(torch.from_numpy(x))
    want = np.percentile(x, (50.0, 99.0, 99.9), axis=1)
    assert got.shape == want.shape == (3, 4)
    np.testing.assert_array_equal(got, want)
