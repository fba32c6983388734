"""Reading the profiler's trace of the traced queries.

The trace is torch.profiler's Chrome export (CUPTI underneath).  Device
operations are its `kernel`, `gpu_memcpy` and `gpu_memset` events; each
carries the correlation id of the host call that launched it, and the
launch is credited to the innermost `pb.<layer>` range open on that host
thread at the time (`bench.hooks`).  Busy time is the union of the device
operations over the window, which runs from the first traced query's
start to the last one's end.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
TOP = 10


def load(prof) -> list:
    """The trace's events, exported to a temporary file that is removed."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    return data["traceEvents"] if isinstance(data, dict) else data


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def kernel_names(source: str) -> list:
    """The `__global__` functions a CUDA source of the program defines
    (`source` relative to the `repro_torch` package)."""
    import repro_torch

    text = (Path(repro_torch.__file__).resolve().parent / source).read_text()
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)", text)


class _Ranges:
    """Nested host ranges of one thread: the innermost open at a time."""

    def __init__(self, events):
        self.ev = sorted(events, key=lambda e: (e["ts"], -e["dur"]))
        self.starts = [e["ts"] for e in self.ev]

    def innermost(self, ts):
        i = bisect.bisect_right(self.starts, ts)
        best = None
        for e in reversed(self.ev[max(0, i - 400):i]):
            if e["ts"] <= ts <= e["ts"] + e["dur"]:
                if best is None or e["dur"] < best["dur"]:
                    best = e
        return best


class View:
    """What a per-layer metric reads: device time per layer and per
    operation, busy and window seconds, the wrapped calls' arguments, the
    window's peak memory."""

    def __init__(self, events: list, n_queries: int, calls: list, peak_bytes: int):
        self.n_queries = n_queries
        self.calls = calls
        self.peak_bytes = peak_bytes
        queries = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == "pb.query"]
        self.w0 = min(e["ts"] for e in queries)
        self.w1 = max(e["ts"] + e["dur"] for e in queries)
        self.window_s = (self.w1 - self.w0) / 1e6
        launches = {}
        for e in events:
            if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
                launches[e["args"]["correlation"]] = e
        notes: dict = {}
        ops: dict = {}
        for e in events:
            cat = e.get("cat")
            if cat == "user_annotation" and str(e.get("name", "")).startswith("pb."):
                notes.setdefault(e.get("tid"), []).append(e)
            elif cat == "cpu_op":
                ops.setdefault(e.get("tid"), []).append(e)
        self._notes = {tid: _Ranges(v) for tid, v in notes.items()}
        self._ops = {tid: _Ranges(v) for tid, v in ops.items()}
        self.device = []  # (name, start us, end us, layer)
        for e in events:
            if e.get("cat") not in DEVICE_CATS or "dur" not in e:
                continue
            a, b = max(e["ts"], self.w0), min(e["ts"] + e["dur"], self.w1)
            if b <= a:
                continue
            layer = None
            launch = launches.get(e.get("args", {}).get("correlation"))
            if launch is not None and launch.get("tid") in self._notes:
                note = self._notes[launch["tid"]].innermost(launch["ts"])
                layer = note["name"][3:] if note is not None else None
            self.device.append((e["name"], a, b, layer))
        merged = _merge([(a, b) for _, a, b, _ in self.device])
        self.busy_s = sum(b - a for a, b in merged) / 1e6
        self._merged = merged
        self._main = max(notes, key=lambda t: len(notes[t])) if notes else None

    def layer_ms(self, layer: str):
        """Device ms a query of the kernels credited to `layer`, or None
        where no wrapped call of the layer ran."""
        if not self.device or not any(c[0] == layer for c in self.calls):
            return None
        us = sum(b - a for _, a, b, lay in self.device if lay == layer)
        return us / 1e3 / self.n_queries

    def op_seconds(self) -> dict:
        out: dict = {}
        for name, a, b, _ in self.device:
            out[name] = out.get(name, 0.0) + (b - a) / 1e6
        return out

    def kernel_names(self, source: str) -> list:
        return kernel_names(source)

    def breakdown(self) -> dict:
        ops = sorted(self.op_seconds().items(), key=lambda kv: -kv[1])[:TOP]
        edges = [self.w0] + [x for ab in self._merged for x in ab] + [self.w1]
        gaps = []
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                gaps.append((self._label((a + b) / 2), (b - a) / 1e6))
        gaps.sort(key=lambda g: -g[1])
        return dict(device_ops=[[n[:120], s] for n, s in ops], idle_gaps=[[n, s] for n, s in gaps[:TOP]])

    def _label(self, ts) -> str:
        """What the host was doing at `ts`: the innermost layer range and
        the innermost operator open on the main thread."""
        if self._main is None:
            return "host"
        note = self._notes[self._main].innermost(ts)
        op = self._ops[self._main].innermost(ts) if self._main in self._ops else None
        layer = note["name"][3:] if note is not None else "between queries"
        return f"{layer}: {op['name'][:60]}" if op is not None else f"{layer}: python"
