"""Chrome trace-event JSON export (Perfetto / chrome://tracing loadable).

A copy of `repro.obs.export` for the port.

Maps the recorder's primitives onto the trace-event format:

  Span          -> "X" complete event (ts + dur)
  Instant       -> "i" instant event (scope "t": thread-scoped marker)
  CounterSample -> "C" counter event
  process/thread names -> "M" metadata events

Sim time is seconds; trace-event `ts`/`dur` are microseconds, so
everything is scaled by 1e6 on the way out.  The result is the JSON
object form ({"traceEvents": [...]}), which both Perfetto and
chrome://tracing accept.
"""

from __future__ import annotations

import json
import os
from typing import Union

from .trace import Recorder

__all__ = ["to_chrome_trace", "write_chrome_trace", "load_chrome_trace"]

_US = 1e6  # sim seconds -> trace microseconds


def to_chrome_trace(recorder: Recorder) -> dict:
    """Render a recorder as a Chrome trace-event JSON object."""
    events: list[dict] = []
    for pid, name in sorted(recorder.process_names.items()):
        events.append({
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": name},
        })
    for (pid, tid), name in sorted(recorder.thread_names.items()):
        events.append({
            "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": name},
        })
    for s in recorder.spans:
        ev = {
            "name": s.name, "cat": s.cat, "ph": "X",
            "ts": s.ts * _US, "dur": s.dur * _US,
            "pid": s.pid, "tid": s.tid,
        }
        if s.args:
            ev["args"] = s.args
        events.append(ev)
    for i in recorder.instants:
        ev = {
            "name": i.name, "cat": i.cat, "ph": "i", "s": "t",
            "ts": i.ts * _US, "pid": i.pid, "tid": i.tid,
        }
        if i.args:
            ev["args"] = i.args
        events.append(ev)
    for c in recorder.samples:
        events.append({
            "name": c.name, "cat": "counter", "ph": "C",
            "ts": c.ts * _US, "pid": c.pid, "tid": 0,
            "args": {c.name: c.value},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, recorder: Recorder) -> str:
    """Serialize to `path`; returns the path for convenience."""
    with open(path, "w") as fh:
        json.dump(to_chrome_trace(recorder), fh)
    return path


def load_chrome_trace(source: Union[str, dict]) -> Recorder:
    """Inverse of `to_chrome_trace` (path or already-parsed object):
    rebuilds a Recorder, un-scaling microseconds back to seconds.  Used by
    the round-trip tests and handy for post-hoc analysis of CI artifacts."""
    if isinstance(source, (str, os.PathLike)):
        with open(source) as fh:
            obj = json.load(fh)
    else:
        obj = source
    rec = Recorder()
    rec.process_names = {}
    for ev in obj["traceEvents"]:
        ph = ev["ph"]
        if ph == "M":
            if ev["name"] == "process_name":
                rec.name_process(ev["pid"], ev["args"]["name"])
            elif ev["name"] == "thread_name":
                rec.name_thread(ev["pid"], ev["tid"], ev["args"]["name"])
        elif ph == "X":
            rec.span(ev["name"], ev.get("cat", ""), ev["ts"] / _US,
                     ev["dur"] / _US, pid=ev["pid"], tid=ev["tid"],
                     args=ev.get("args"))
        elif ph == "i":
            rec.instant(ev["name"], ev.get("cat", ""), ev["ts"] / _US,
                        pid=ev["pid"], tid=ev["tid"], args=ev.get("args"))
        elif ph == "C":
            (name, value), = ev["args"].items()
            rec.counter_sample(name, ev["ts"] / _US, value, pid=ev["pid"])
    return rec
