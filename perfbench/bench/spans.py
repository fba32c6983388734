"""The program's own sections, for the per-layer metrics that read them.

The port records, with a recorder enabled, one root section
`frontier_dispatch` a planner query and the sections of its layers inside
it (`repro_torch.obs.trace`, `Recorder.section`): each span's `args` carry
its `id`, its `parent` and its `query` (the root's id), and while a
profiler runs each section is also a range of its name in the profiler's
trace (an event of cat "cpu_op").  The readers take host times and counts
from the recorder's spans, and device times from the trace: the operations
launched inside a section's ranges, credited as `bench/timeline.py`
credits them to the `pb.*` ranges.

`install()` enables the program's default recorder where none is, so the
warm-up and the traced queries record, and keeps the events of the trace
that the harness loads (`timeline.load`, left as it is otherwise).  The
readers call it when they are loaded, which happens in `--trace 1` runs
only, so untraced runs keep recording off.

A program that records no such sections (one from before they existed)
leaves every reading None.
"""

from __future__ import annotations

import bisect

from . import timeline

ROOT = "frontier_dispatch"
#: the trace's category of a program's range
RANGE_CAT = "cpu_op"
#: the events of the last trace the harness loaded
_trace: dict = {}


def install() -> None:
    """Enable a recorder in the program, unless one is enabled already, and
    keep the events of the traces the harness loads."""
    from repro_torch import obs

    if obs.get_recorder() is obs.NULL_RECORDER:
        obs.enable(obs.Recorder())
    if not getattr(timeline.load, "keeps_events", False):
        load = timeline.load

        def keeping(prof):
            events = load(prof)
            _trace["events"] = events
            return events

        keeping.keeps_events = True
        timeline.load = keeping


def queries(n: int) -> list:
    """The last `n` queries the program recorded, oldest first: for each,
    {span name: [its spans]}, the root included.  Empty where the program
    recorded fewer than `n` roots with ids."""
    from repro_torch import obs

    rec = obs.get_recorder()
    roots = [s for s in rec.spans_named(ROOT) if s.args and s.args.get("query") is not None]
    if n <= 0 or len(roots) < n:
        return []
    ids = {s.args["id"]: {} for s in roots[-n:]}
    for s in rec.spans:
        by_name = ids.get((s.args or {}).get("query"))
        if by_name is not None:
            by_name.setdefault(s.name, []).append(s)
    return list(ids.values())


def per_query(view, value):
    """The mean over the traced queries of `value(spans by name)`, or None
    where a query lacks what it reads (`value` raises KeyError or returns
    None)."""
    got = []
    for q in queries(view.n_queries):
        try:
            v = value(q)
        except KeyError:
            return None
        if v is None:
            return None
        got.append(v)
    return sum(got) / len(got) if got else None


class _Ranges:
    """One thread's ranges of one name, which do not overlap."""

    def __init__(self, spans):
        self.spans = sorted(spans)
        self.starts = [a for a, _ in self.spans]

    def holds(self, ts) -> bool:
        i = bisect.bisect_right(self.starts, ts) - 1
        return i >= 0 and ts <= self.spans[i][1]


def device_ms(view, names, less=()):
    """Device ms a query of the operations launched inside the program's
    ranges named `names` and outside those named `less`, over the traced
    window; on the CPU, where operations run as they are called, the
    ranges' own host time.  None where the trace holds no range of `names`
    (or no trace was kept)."""
    events = _trace.get("events")
    if events is None or view.n_queries <= 0:
        return None
    ranges: dict = {}  # (name, tid) -> [(start, end)]
    for e in events:
        if e.get("cat") == RANGE_CAT and e.get("name") in names + less and view.w0 <= e["ts"] <= view.w1:
            ranges.setdefault((e["name"], e.get("tid")), []).append((e["ts"], e["ts"] + e["dur"]))
    if not any(name in names for name, _ in ranges):
        return None
    if not view.device:  # the CPU: the ranges' own time
        us = sum(b - a for (name, _), spans in ranges.items() for a, b in spans if name in names)
        us -= sum(b - a for (name, _), spans in ranges.items() for a, b in spans if name in less)
        return us / 1e3 / view.n_queries
    inside = {key: _Ranges(spans) for key, spans in ranges.items()}
    launches = {}
    for e in events:
        if e.get("cat") in timeline.LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = e
    us = 0.0
    for e in events:
        if e.get("cat") not in timeline.DEVICE_CATS or "dur" not in e:
            continue
        a, b = max(e["ts"], view.w0), min(e["ts"] + e["dur"], view.w1)
        launch = launches.get(e.get("args", {}).get("correlation"))
        if b <= a or launch is None:
            continue
        tid, ts = launch.get("tid"), launch["ts"]

        def within(group):
            return any(inside[(n, tid)].holds(ts) for n in group if (n, tid) in inside)

        if within(names) and not within(less):
            us += b - a
    return us / 1e3 / view.n_queries
