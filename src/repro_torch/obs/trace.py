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

`Recorder.section` (the port's own) times a layer of the program on the
profiler pid, where the spans above carry sim time: its spans stamp the
Unix-epoch clock (`time.time_ns()`, in seconds), the clock torch.profiler's
Chrome export reaches as `ts + baseTimeNanoseconds / 1000`, and, while a
profiler runs, open a range of the same name (an operator event, cat
"cpu_op", of `torch._C._profiler._RecordFunctionFast`: about 1.6 µs a
range under the profiler, where `torch.profiler.record_function` takes
about 15), so the profiler's trace shows them beside the kernels.  Each carries
`args` `id`, `parent` (the enclosing open section, or None) and `query`
(the id of the enclosing root section, e.g. one `frontier_dispatch` call,
or None outside a root).  A section records host time only and never
touches the device: a section's device time is that of the operations
launched inside its range in a profiler's trace.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Mapping, Optional

import torch

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


_profiler_enabled = torch._C._autograd._profiler_enabled
_Range = torch._C._profiler._RecordFunctionFast


class _Section:
    """One `Recorder.section`: a context manager, kept by the recorder once
    closed and made a `Span` when the recorder's spans are read (see the
    module docstring)."""

    __slots__ = ("rec", "name", "cat", "args", "root", "id", "parent", "query", "_rf", "_t0", "_t1")

    def __init__(self, rec, name, cat, root, args):
        self.rec, self.name, self.cat, self.root, self.args = rec, name, cat, root, args

    def note(self, **args) -> None:
        """Add args to the span (values known only once it is open)."""
        self.args.update(args)

    def __enter__(self) -> "_Section":
        rec = self.rec
        stack = rec._open
        self.id = next(rec._ids)
        outer = stack[-1] if stack else None
        self.parent = None if outer is None else outer.id
        self.query = self.id if self.root else None if outer is None else outer.query
        stack.append(self)
        self._rf = None
        if _profiler_enabled():
            # the profiler stamps the range's start inside the call that
            # opens it (the span starts in the middle of that call) and its
            # end inside the call that closes it (the span ends right after)
            self._rf = _Range(self.name)
            t = time.time_ns()
            self._rf.__enter__()
            self._t0 = (t + time.time_ns()) // 2
        else:
            self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        if self._rf is not None:
            self._rf.__exit__(*exc)
        self._t1 = time.time_ns()
        rec, self.rec = self.rec, None  # a closed section holds no recorder
        rec._open.pop()
        rec._closed.append(self)
        return False

    def span(self) -> Span:
        """The closed section as a span."""
        args, t0, t1 = self.args, self._t0, self._t1
        args["id"], args["parent"], args["query"] = self.id, self.parent, self.query
        return Span(self.name, self.cat, t0 / 1e9, (t1 - t0) / 1e9, PID_PROFILER, 0, args)


class _NullSection:
    """The disabled section: one shared instance, entered and left for
    nothing."""

    __slots__ = ()

    def note(self, **args) -> None:
        pass

    def __enter__(self) -> "_NullSection":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SECTION = _NullSection()


class Recorder:
    """Collects spans, instants, counter samples, and aggregate counters."""

    enabled = True

    def __init__(self):
        self._spans: list[Span] = []
        self.instants: list[Instant] = []
        self.samples: list[CounterSample] = []
        self.counters: dict[str, float] = {}
        self._open: list[_Section] = []
        # closed sections not yet made spans: made when the spans are read
        self._closed: list[_Section] = []
        self._ids = itertools.count(1)
        self.process_names: dict[int, str] = {
            PID_FLEET: "fleet.scheduler",
            PID_CONTROLLER: "fleet.controller",
            PID_SERVING: "runtime.serving",
            PID_PROFILER: "obs.profiler",
        }
        self.thread_names: dict[tuple[int, int], str] = {}

    @property
    def spans(self) -> list[Span]:
        """Every span in the order it closed, closed sections included."""
        if self._closed:
            self._spans.extend(s.span() for s in self._closed)
            self._closed.clear()
        return self._spans

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

    def section(self, name: str, cat: str, *, root: bool = False, **args) -> _Section:
        """A context manager timing the code it encloses as a span on the
        profiler pid, with `args` (see the module docstring).  `root`
        starts a query: every section opened inside it shares its id as
        `query`."""
        return _Section(self, name, cat, root, args)

    # ------------------------------------------------------------- queries
    def spans_named(self, name: str) -> list[Span]:
        return [s for s in self.spans if s.name == name]

    def clear(self) -> None:
        self.spans.clear()
        self.instants.clear()
        self.samples.clear()
        self.counters.clear()
        self._closed.clear()

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

    def section(self, *a, **k) -> _NullSection:
        return _NULL_SECTION

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
