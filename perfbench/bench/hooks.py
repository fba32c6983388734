"""Wrappers around the port's functions where their callers bind them.

A binding is (module, function name).  Its wrapper calls the function as
it was and, as asked:

* in a traced run, opens `torch.profiler.record_function("pb.<layer>")`
  around the call, so the kernels it launches can be credited to the
  layer, and records the shapes of its tensor arguments (`calls`);
* while `capturing` is set, keeps what it returned under its capture key,
  for the comparison with the reference after the window.

If a bound name no longer exists (a later rename), the binding is skipped
and listed in `missing`; the metric that needs it then reads nothing.
"""

from __future__ import annotations

import importlib

import torch


def _scalar(a):
    return a if isinstance(a, (int, float, bool, str, type(None))) else type(a).__name__


class Hooks:
    def __init__(self, trace: bool):
        self.trace = trace
        self.bindings: dict = {}  # (module, name) -> {"layer": str|None, "capture": str|None}
        self.installed: list = []
        self.missing: list = []
        self.capturing = False
        self.captured: dict = {}
        self.calls: list = []  # (layer, name, args: shapes of tensors, else scalars; scalar kwargs)

    def bind(self, module: str, name: str, layer: str | None = None, capture: str | None = None) -> None:
        b = self.bindings.setdefault((module, name), {"layer": None, "capture": None})
        for key, val in (("layer", layer), ("capture", capture)):
            if val is not None:
                if b[key] not in (None, val):
                    raise ValueError(f"{module}.{name} bound to {key} {b[key]!r} and {val!r}")
                b[key] = val

    def install(self) -> None:
        for (module, name), b in self.bindings.items():
            mod = importlib.import_module(module)
            fn = getattr(mod, name, None)
            if not callable(fn):
                self.missing.append(f"{module}.{name}")
                continue
            setattr(mod, name, self._wrap(fn, name, b["layer"] if self.trace else None, b["capture"]))
            self.installed.append((mod, name, fn))

    def uninstall(self) -> None:
        for mod, name, fn in reversed(self.installed):
            setattr(mod, name, fn)
        self.installed.clear()

    def _wrap(self, fn, name, layer, capture):
        hooks = self

        def wrapper(*args, **kwargs):
            if layer is None:
                out = fn(*args, **kwargs)
            else:
                hooks.calls.append((layer, name, [tuple(a.shape) if torch.is_tensor(a) else _scalar(a) for a in args],
                                    {k: _scalar(v) for k, v in kwargs.items()}))
                with torch.profiler.record_function(f"pb.{layer}"):
                    out = fn(*args, **kwargs)
            if capture is not None and hooks.capturing:
                hooks.captured.setdefault(capture, []).append(out)
            return out

        wrapper.__wrapped__ = fn
        return wrapper
