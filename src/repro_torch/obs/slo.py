"""SLO objects and multi-window error-budget burn rates over sketches.

A copy of `repro.obs.slo` for the port.

The serving path's contract is a tail quantile — "99.9% of batches finish
within 30 s" — and the operational question is not "what is p999 right
now" but "how fast am I spending the error budget".  An `SLO` pins
(quantile, threshold); the budget is the allowed violation mass
1 - quantile; the *burn rate* over a window is

    burn(w) = observed violation fraction in w / (1 - quantile)

so burn = 1 means exactly on budget, burn = 10 means the budget for the
period is gone in a tenth of it.  Multi-window evaluation (the SRE
fast/slow alerting pattern) separates a transient spike (short window
burns, long window calm) from a sustained regression (every window
burns).

Windows are served by `WindowedSketch`: sim time is discretized into
bucket_s-wide sub-sketches kept in a bounded ring, and a window query
merges the covered sub-sketches — merges are *exact* for γ-bucket
sketches, so a window estimate equals the sketch of exactly those
observations, with O(windows) memory independent of stream length.
`SLOTracker` binds one SLO to one windowed sketch; the serving layer
(`FleetHedgedServer`) keeps one tracker per priority class and emits the
burn rates as registry gauges and Chrome-trace instants.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional, Sequence

from .sketch import QuantileSketch, merge_all

__all__ = ["SLO", "WindowedSketch", "SLOTracker", "trackers_for"]


@dataclasses.dataclass(frozen=True)
class SLO:
    """One latency objective: quantile of values must stay <= threshold."""

    name: str
    threshold: float
    quantile: float = 0.999
    windows: tuple = (64.0, 256.0, 1024.0)  # sim-seconds, short → long

    def __post_init__(self):
        if not 0.0 < self.quantile < 1.0:
            raise ValueError("quantile must be in (0, 1)")
        if self.threshold <= 0:
            raise ValueError("threshold must be > 0")
        if not self.windows or any(w <= 0 for w in self.windows):
            raise ValueError("need at least one positive window")

    @property
    def budget(self) -> float:
        """Allowed violation fraction (the error budget per unit mass)."""
        return 1.0 - self.quantile


class WindowedSketch:
    """Time-bucketed quantile sketches with exact window merges.

    Values observed at sim time t land in the sub-sketch for bucket
    floor(t / bucket_s); only the most recent `n_buckets` sub-sketches are
    retained (older ones age out), plus one lifetime sketch that never
    ages.  `sketch_over(window_s, now)` merges the sub-sketches covering
    (now - window_s, now] — exact, because γ-bucket merges are exact.
    """

    def __init__(self, bucket_s: float, n_buckets: int = 64,
                 rel_acc: float = 0.01):
        if bucket_s <= 0:
            raise ValueError("bucket_s must be > 0")
        if n_buckets < 1:
            raise ValueError("need at least one bucket")
        self.bucket_s = float(bucket_s)
        self.n_buckets = int(n_buckets)
        self.rel_acc = float(rel_acc)
        self._ring: "OrderedDict[int, QuantileSketch]" = OrderedDict()
        self.lifetime = QuantileSketch(rel_acc=rel_acc)
        self._t_last = 0.0

    def observe(self, t: float, value: float) -> None:
        t = float(t)
        self._t_last = max(self._t_last, t)
        idx = int(t // self.bucket_s)
        sk = self._ring.get(idx)
        if sk is None:
            sk = QuantileSketch(rel_acc=self.rel_acc)
            self._ring[idx] = sk
            while len(self._ring) > self.n_buckets:
                self._ring.popitem(last=False)  # oldest bucket ages out
        sk.add(value)
        self.lifetime.add(value)

    @property
    def now(self) -> float:
        """Latest observation time seen (the default window anchor)."""
        return self._t_last

    def sketch_over(self, window_s: float,
                    now: Optional[float] = None) -> QuantileSketch:
        """Fresh sketch of every observation in (now - window_s, now]."""
        now = self._t_last if now is None else float(now)
        lo = int((now - window_s) // self.bucket_s)
        hi = int(now // self.bucket_s)
        parts = [sk for idx, sk in self._ring.items() if lo < idx <= hi]
        if not parts:
            return QuantileSketch(rel_acc=self.rel_acc)
        return merge_all(parts)

    def coverage(self, window_s: float) -> float:
        """Fraction of the requested window the retained ring can serve
        (long windows on a small ring are silently partial otherwise)."""
        return min(1.0, self.n_buckets * self.bucket_s / window_s)


class SLOTracker:
    """One SLO bound to one windowed sketch: observe, then ask for burn.

    The ring is sized so the longest SLO window is fully covered at
    `buckets_per_window` resolution of the shortest.
    """

    def __init__(self, slo: SLO, rel_acc: float = 0.01,
                 buckets_per_window: int = 8):
        self.slo = slo
        bucket_s = min(slo.windows) / buckets_per_window
        n_buckets = int(max(slo.windows) / bucket_s) + 2
        self.window_sketch = WindowedSketch(bucket_s, n_buckets, rel_acc)
        self.n_violations = 0.0

    def observe(self, t: float, value: float) -> None:
        self.window_sketch.observe(t, value)
        if value > self.slo.threshold:
            self.n_violations += 1.0

    def burn_rate(self, window_s: float, now: Optional[float] = None) -> float:
        """Error-budget burn over one window (0 when the window is empty:
        no traffic spends no budget)."""
        sk = self.window_sketch.sketch_over(window_s, now)
        if sk.count == 0:
            return 0.0
        return sk.exceed_fraction(self.slo.threshold) / self.slo.budget

    def burn_rates(self, now: Optional[float] = None) -> dict:
        return {w: self.burn_rate(w, now) for w in self.slo.windows}

    def burning(self, factor: float = 1.0,
                now: Optional[float] = None) -> bool:
        """Multi-window alert: every window burning past `factor` — a
        sustained regression, not a one-bucket blip."""
        rates = self.burn_rates(now)
        return all(r > factor for r in rates.values())

    def report(self, now: Optional[float] = None) -> dict:
        """JSON-ready status: per-window burn plus lifetime compliance."""
        life = self.window_sketch.lifetime
        total = life.count
        viol_frac = (self.n_violations / total) if total else 0.0
        return {
            "slo": self.slo.name,
            "threshold": self.slo.threshold,
            "quantile": self.slo.quantile,
            "budget": self.slo.budget,
            "count": total,
            "violation_frac": viol_frac,
            "budget_remaining": max(0.0, 1.0 - viol_frac / self.slo.budget),
            "attained_quantile_value": (
                life.quantile(self.slo.quantile) if total else float("nan")
            ),
            "burn_rates": {
                str(w): self.burn_rate(w, now) for w in self.slo.windows
            },
            "burning": self.burning(now=now),
        }


def trackers_for(slos, priorities: Sequence[int],
                 rel_acc: float = 0.01) -> dict:
    """Normalize the serving-layer `slos` argument to {priority: tracker}.

    `slos` is one SLO (applied to every priority class seen) or a mapping
    {priority: SLO} (classes without an entry are untracked).
    """
    out: dict = {}
    if slos is None:
        return out
    if isinstance(slos, SLO):
        for p in sorted({int(p) for p in priorities}):
            out[p] = SLOTracker(slos, rel_acc=rel_acc)
        return out
    for p, slo in slos.items():
        if not isinstance(slo, SLO):
            raise TypeError(f"slos[{p!r}] must be an SLO, got {type(slo)}")
        out[int(p)] = SLOTracker(slo, rel_acc=rel_acc)
    return out
