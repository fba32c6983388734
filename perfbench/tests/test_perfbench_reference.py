"""The comparison that decides `correct`, on the CPU at a tiny size: the
port against the plain reference (held), the reference in bfloat16 in the
program's place (the control: fails), and the harness driven with the
timed path broken underneath (fails)."""

import pytest
import torch

import pbtest
import calibrate
from bench import check, spec


def _limits(name):
    bench = spec.benchmark()
    return spec.traffic(spec.workload(bench, name)["traffic"])["check"]["limits"]


@pytest.mark.parametrize("name", pbtest.CELLS)
def test_port_holds_and_control_fails(name):
    limits = _limits(name)
    recs = calibrate.readings(name, [2**34 + 11, 2**34 + 12], 2, "cpu", pbtest.TINY)
    for r in recs:
        assert check.held(r["program"], limits), r["program"]
        assert not check.held(r["control"], limits), r["control"]
        # the control fails in the evaluator and in the queue, not only in the rows
        assert r["control"]["T_gap"] > limits["T_gap"] and r["control"]["queue_gap"] > limits["queue_gap"]


def _answer_altered(monkeypatch):
    from repro_torch.fleet import vector

    inner = vector._masked_cells

    def altered(*args):
        T, C = inner(*args)
        T = T.clone()
        T[0, 0, 0] *= 1.001  # one job's makespan, where it is produced
        return T, C

    monkeypatch.setattr(vector, "_masked_cells", altered)
    inner_low = vector.lowered_eval_cells

    def altered_low(*args):
        T, C = inner_low(*args)
        T = T.clone()
        T[0, 0, 0] *= 1.001
        return T, C

    monkeypatch.setattr(vector, "lowered_eval_cells", altered_low)


def _half_batch(monkeypatch):
    from repro_torch.fleet import vector

    inner = vector._cell_stats

    def half(arrivals, T, C, *rest):
        m = T.shape[1] // 2
        return inner(arrivals[:, :m], T[:, :m], C[:, :m], *rest)

    monkeypatch.setattr(vector, "_cell_stats", half)


def _state_unchanged(monkeypatch):
    from repro_torch.fleet import vector

    def no_queue(arrivals, services, speeds):
        # every slot stays free: no job ever waits
        return arrivals, arrivals + services, services, torch.zeros_like(arrivals, dtype=torch.int32)

    monkeypatch.setattr(vector, "kw_queue_kernel", no_queue)


def _one_finish_altered(monkeypatch):
    from repro_torch.fleet import vector

    inner = vector.kw_queue_kernel

    def one_late(arrivals, services, speeds):
        starts, fins, svc, slots = inner(arrivals, services, speeds)
        fins = fins.clone()
        fins.view(-1)[-1] += services.reshape(-1)[-1]  # one job of one row placed behind itself
        return starts, fins, svc, slots

    monkeypatch.setattr(vector, "kw_queue_kernel", one_late)


FAULTS = {"answer_altered": _answer_altered, "half_batch": _half_batch, "state_unchanged": _state_unchanged,
          "one_finish_altered": _one_finish_altered}


@pytest.mark.parametrize("name", pbtest.CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_timed_path_reads_incorrect(name, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    rc, line, err = pbtest.run_tiny(name)
    assert rc == 0 and line is not None
    assert line["correct"] is False, line["checks"]
    assert "FAILED" in err
