"""kw_queue's roofline share: bytes from the shapes at the queue layer's
boundary, time from the kernels the program's kw_queue.cu defines."""

import pytest

import pbtest  # noqa: F401
from bench import peaks, spec, timeline

ROOF = spec.metric_module("kw_queue_roofline_pct")


class FakeView:
    def __init__(self, calls, ops):
        self.calls, self._ops = calls, ops

    def op_seconds(self):
        return dict(self._ops)

    def kernel_names(self, source):
        return timeline.kernel_names(source)


def test_bytes_of_a_frontier_call():
    # (512, 2048, 4): two float32 arrays read, three float32 and one int32
    # written, the speeds read once: 25 MB, 7.5 us at 3.35 TB/s
    b = peaks.kw_queue_bytes(512, 2048, 4)
    assert b == 4 * 512 * 2048 * 6 + 16
    assert peaks.bound_s(b) == pytest.approx(7.512e-6, rel=1e-3)


def test_kernel_names_come_from_the_cuda_source():
    names = FakeView([], {}).kernel_names("csrc/kw_queue.cu")
    assert {"kw_tma_kernel", "kw_segment_kernel", "kw_fixup_kernel"} <= set(names)


def test_share_over_frontier_calls():
    calls = [("queue", "batched_queue", [(32, 16, 2048), (32, 16, 2048), (12,)], {"kernel": False}),
             ("queue", "batched_queue", [(32, 16, 2048), (32, 16, 2048), (12,)], {}),
             ("queue", "batched_queue", [(8, 4, 2048), (8, 4, 2048), (1,)], {}),  # c = 1: no kernel
             ("stats", "_cell_stats", [(32, 16, 2048)], {})]
    ops = {"void kw_tma_kernel<12, true>(CUtensorMap, ...)": 2 * 50e-6, "void at::native::sort": 1.0}
    got = ROOF.read(FakeView(calls, ops))
    want = 100 * 2 * peaks.kw_queue_bytes(512, 2048, 12) / 3.35e12 / 100e-6
    assert got == pytest.approx(want)
    assert 0 < got < 100


def test_nothing_to_read_gives_none():
    assert ROOF.read(FakeView([], {"void at::native::sort": 1.0})) is None
