"""Span recorder: the one sink every instrumented layer emits into.

A copy of `repro.obs.trace` for the port.

The design constraint is the fused engines: instrumentation in
`fleet/vector.py` / the event engine sits on paths that execute millions
of times per bench run, so the disabled configuration must cost one
attribute load and a falsy check — no allocation, no string formatting,
no dict building.  Hence the recorder *protocol* is two classes:

  * `Recorder`     — enabled; appends spans/instants/counter samples to
    plain lists and aggregates counters.  Sim time in, seconds.
  * `NullRecorder` — `enabled = False` and every method a no-op.  Call
    sites either hold a NullRecorder or guard with `if rec.enabled:`
    before building event payloads, which keeps arg construction off the
    hot path too.

A module-level current recorder (default Null) serves call sites that are
not threaded a recorder explicitly: `obs.enable()` swaps in a live
`Recorder`, `obs.disable()` swaps the Null back.  Sim components accept a
recorder at construction (`FleetConfig(obs=...)`) and fall back to the
module-level one, so both "flip the global flag" and "give this sim its
own trace" work.

Span/instant pids partition the trace into Perfetto "processes":
scheduler lifecycle rows, controller decisions, serving, kernel
profiling, and one row per DAG stage.  `repro_torch.obs.export` turns a
Recorder into Chrome trace-event JSON.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

__all__ = [
    "Span", "Instant", "CounterSample", "Recorder", "NullRecorder",
    "NULL_RECORDER", "enable", "disable", "get_recorder",
    "PID_FLEET", "PID_CONTROLLER", "PID_SERVING", "PID_PROFILER",
    "PID_DAG_BASE",
]

# Perfetto process ids — one per instrumented subsystem.
PID_FLEET = 1        # scheduler job lifecycle (queue/service spans per job)
PID_CONTROLLER = 2   # FleetPolicyController decision timeline
PID_SERVING = 3      # FleetHedgedServer batch stream
PID_PROFILER = 4     # kernel wall-time / compile profiling
PID_DAG_BASE = 10    # stage i of a DAG sim gets pid PID_DAG_BASE + i


@dataclasses.dataclass
class Span:
    """A completed duration event ("X" in Chrome trace format)."""

    name: str
    cat: str
    ts: float          # start, sim seconds (or wall seconds for profiling)
    dur: float         # duration, same unit
    pid: int = PID_FLEET
    tid: int = 0
    args: Optional[dict] = None


@dataclasses.dataclass
class Instant:
    """A point event ("i"): fork fired, drift flush, barrier release, ..."""

    name: str
    cat: str
    ts: float
    pid: int = PID_FLEET
    tid: int = 0
    args: Optional[dict] = None


@dataclasses.dataclass
class CounterSample:
    """A sampled time series ("C"): queue depth, busy slots, ρ̂, ..."""

    name: str
    ts: float
    value: float
    pid: int = PID_FLEET


class Recorder:
    """Collects spans, instants, counter samples, and aggregate counters."""

    enabled = True

    def __init__(self):
        self.spans: list[Span] = []
        self.instants: list[Instant] = []
        self.samples: list[CounterSample] = []
        self.counters: dict[str, float] = {}
        self.process_names: dict[int, str] = {
            PID_FLEET: "fleet.scheduler",
            PID_CONTROLLER: "fleet.controller",
            PID_SERVING: "runtime.serving",
            PID_PROFILER: "obs.profiler",
        }
        self.thread_names: dict[tuple[int, int], str] = {}

    # ------------------------------------------------------------- emission
    def span(self, name: str, cat: str, ts: float, dur: float, *,
             pid: int = PID_FLEET, tid: int = 0,
             args: Optional[Mapping] = None) -> None:
        self.spans.append(Span(name, cat, float(ts), float(dur), pid, tid,
                               dict(args) if args else None))

    def instant(self, name: str, cat: str, ts: float, *,
                pid: int = PID_FLEET, tid: int = 0,
                args: Optional[Mapping] = None) -> None:
        self.instants.append(Instant(name, cat, float(ts), pid, tid,
                                     dict(args) if args else None))

    def counter_sample(self, name: str, ts: float, value: float, *,
                       pid: int = PID_FLEET) -> None:
        self.samples.append(CounterSample(name, float(ts), float(value), pid))

    def count(self, name: str, amount: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + amount

    def name_process(self, pid: int, name: str) -> None:
        self.process_names[pid] = name

    def name_thread(self, pid: int, tid: int, name: str) -> None:
        self.thread_names[(pid, tid)] = name

    # ------------------------------------------------------------- queries
    def spans_named(self, name: str) -> list[Span]:
        return [s for s in self.spans if s.name == name]

    def clear(self) -> None:
        self.spans.clear()
        self.instants.clear()
        self.samples.clear()
        self.counters.clear()

    def __len__(self) -> int:
        return len(self.spans) + len(self.instants) + len(self.samples)

    def __repr__(self) -> str:
        return (f"Recorder(spans={len(self.spans)}, "
                f"instants={len(self.instants)}, samples={len(self.samples)}, "
                f"counters={len(self.counters)})")


class NullRecorder:
    """Disabled recorder: every emission is a no-op.

    Hot paths hold one of these (or check `.enabled`) so disabled
    instrumentation costs a single falsy attribute read.
    """

    enabled = False

    def span(self, *a, **k) -> None:
        pass

    def instant(self, *a, **k) -> None:
        pass

    def counter_sample(self, *a, **k) -> None:
        pass

    def count(self, *a, **k) -> None:
        pass

    def name_process(self, *a, **k) -> None:
        pass

    def name_thread(self, *a, **k) -> None:
        pass

    def spans_named(self, name: str) -> list:
        return []

    def clear(self) -> None:
        pass

    def __len__(self) -> int:
        return 0

    def __repr__(self) -> str:
        return "NullRecorder()"


#: the shared disabled recorder — safe to hand to any number of components
NULL_RECORDER = NullRecorder()

_current: Recorder | NullRecorder = NULL_RECORDER


def enable(recorder: Optional[Recorder] = None) -> Recorder:
    """Install (and return) the process-wide recorder.  Components that
    were not handed an explicit recorder emit here from now on."""
    global _current
    _current = recorder if recorder is not None else Recorder()
    return _current


def disable() -> None:
    """Swap the process-wide recorder back to the shared NullRecorder."""
    global _current
    _current = NULL_RECORDER


def get_recorder() -> Recorder | NullRecorder:
    """The process-wide recorder (NullRecorder unless `enable()` was called)."""
    return _current


def resolve_recorder(obs) -> Optional[Recorder]:
    """Interpret the `obs=` config convention shared by FleetConfig /
    DagFleetConfig / FleetHedgedServer:

      None / False -> None (components defer to the process-wide recorder)
      True         -> a fresh private Recorder
      a Recorder (or anything recorder-shaped) -> itself
    """
    if obs is None or obs is False:
        return None
    if obs is True:
        return Recorder()
    return obs
