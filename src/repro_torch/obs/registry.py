"""Metrics registry: counters, gauges, and sketch-backed histograms.

A copy of `repro.obs.registry` for the port.

One flat namespace of metrics keyed by (name, labels) — labels are a
frozen dict rendered Prometheus-style (`sojourn{class="gpu",tenant="a"}`).
Histograms delegate tail estimation to `QuantileSketch`, so a registry
holding per-class/per-tenant latency histograms reports live p50/p99/p999
without ever retaining a sample array, and shard registries merge into a
fleet-wide view with `MetricsRegistry.merge`.
"""

from __future__ import annotations

from typing import Mapping, Optional

from .sketch import QuantileSketch

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]


def _label_key(labels: Optional[Mapping[str, object]]):
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _render_labels(key) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


class Counter:
    """Monotonically increasing count (events, bytes, vetoes, ...)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        self.value += amount

    def snapshot(self) -> dict:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-write-wins instantaneous value (queue depth, ρ̂, VMEM bytes)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = float("nan")

    def set(self, value: float) -> None:
        self.value = float(value)

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Sketch-backed distribution; observe() is O(1), tails are live."""

    __slots__ = ("sketch",)

    def __init__(self, rel_acc: float = 0.01):
        self.sketch = QuantileSketch(rel_acc)

    def observe(self, value: float) -> None:
        self.sketch.add(value)

    def observe_many(self, values) -> None:
        self.sketch.add_many(values)

    @property
    def count(self) -> float:
        return self.sketch.count

    def quantile(self, q: float) -> float:
        return self.sketch.quantile(q)

    def snapshot(self) -> dict:
        return {"type": "histogram", **self.sketch.summary()}


class MetricsRegistry:
    """Flat (name, labels) -> metric map with lazy creation.

    `counter`/`gauge`/`histogram` return the existing instrument for the
    key or create it; type clashes on a key raise.
    """

    def __init__(self, rel_acc: float = 0.01):
        self.rel_acc = rel_acc
        self._metrics: dict[tuple, object] = {}

    def _get(self, name: str, labels, factory, cls):
        key = (name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            m = factory()
            self._metrics[key] = m
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name}{_render_labels(key[1])} is {type(m).__name__}, "
                f"not {cls.__name__}"
            )
        return m

    def counter(self, name: str, labels: Optional[Mapping] = None) -> Counter:
        return self._get(name, labels, Counter, Counter)

    def gauge(self, name: str, labels: Optional[Mapping] = None) -> Gauge:
        return self._get(name, labels, Gauge, Gauge)

    def histogram(self, name: str, labels: Optional[Mapping] = None,
                  rel_acc: Optional[float] = None) -> Histogram:
        acc = self.rel_acc if rel_acc is None else rel_acc
        return self._get(name, labels, lambda: Histogram(acc), Histogram)

    # ------------------------------------------------------------- queries
    def collect(self, name: Optional[str] = None) -> dict[str, dict]:
        """Snapshot of every metric (optionally filtered by name), keyed by
        the rendered `name{labels}` string."""
        out = {}
        for (n, lk), m in sorted(self._metrics.items()):
            if name is not None and n != name:
                continue
            out[n + _render_labels(lk)] = m.snapshot()
        return out

    def labels_for(self, name: str) -> list[tuple]:
        return [lk for (n, lk) in self._metrics if n == name]

    def merge(self, other: "MetricsRegistry") -> "MetricsRegistry":
        """Fold another registry in: counters add, gauges last-write-wins,
        histograms sketch-merge. Returns self."""
        for key, m in other._metrics.items():
            mine = self._metrics.get(key)
            if mine is None:
                if isinstance(m, Histogram):
                    h = Histogram(m.sketch.rel_acc)
                    h.sketch.merge(m.sketch)
                    self._metrics[key] = h
                elif isinstance(m, Counter):
                    c = Counter()
                    c.value = m.value
                    self._metrics[key] = c
                else:
                    g = Gauge()
                    g.value = m.value
                    self._metrics[key] = g
            elif isinstance(mine, Histogram):
                mine.sketch.merge(m.sketch)
            elif isinstance(mine, Counter):
                mine.value += m.value
            else:
                mine.value = m.value
        return self

    def render(self) -> str:
        """Human-readable dump, one metric per line."""
        lines = []
        for key, snap in self.collect().items():
            if snap["type"] == "histogram":
                lines.append(
                    f"{key} count={snap['count']:g} mean={snap['mean']:.4g} "
                    f"p50={snap['p50']:.4g} p99={snap['p99']:.4g} "
                    f"p999={snap['p999']:.4g}"
                )
            else:
                lines.append(f"{key} {snap['value']:g}")
        return "\n".join(lines)

    def __len__(self) -> int:
        return len(self._metrics)
