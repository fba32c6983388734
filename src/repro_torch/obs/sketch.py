"""Mergeable streaming quantile sketch (DDSketch-style log buckets).

A numpy copy of `repro.obs.sketch` (the port keeps its own copy rather
than importing the JAX package).  Values land in geometric buckets
x ∈ [γ^k, γ^(k+1)) with γ = (1+α)/(1-α) for a relative-accuracy target α,
so any reported quantile is within α relative error of a value whose rank
is exact; the bucket map is a plain {k: count} dict, so two sketches over
the same γ merge exactly by adding counts; exact min/max/sum/count ride
along.  `from_bincounts` rebuilds a sketch from a fixed-size histogram
over the same γ-buckets.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional, Sequence

import numpy as np

__all__ = ["QuantileSketch", "merge_all"]

#: values at or below this are counted in the zero bucket (log undefined)
_ZERO_EPS = 1e-12


class QuantileSketch:
    """Streaming quantiles with bounded relative error and exact merge."""

    __slots__ = ("rel_acc", "gamma", "_log_gamma", "_store", "zero_count",
                 "count", "total", "_min", "_max")

    def __init__(self, rel_acc: float = 0.01):
        if not 0.0 < rel_acc < 1.0:
            raise ValueError("rel_acc must be in (0, 1)")
        self.rel_acc = float(rel_acc)
        self.gamma = (1.0 + rel_acc) / (1.0 - rel_acc)
        self._log_gamma = math.log(self.gamma)
        self._store: dict[int, float] = {}
        self.zero_count = 0.0
        self.count = 0.0
        self.total = 0.0
        self._min = math.inf
        self._max = -math.inf

    # ------------------------------------------------------------- inserts
    def key(self, x: float) -> int:
        """Bucket index: x ∈ [γ^k, γ^(k+1)) -> k."""
        return math.floor(math.log(x) / self._log_gamma)

    def bucket_value(self, k: int) -> float:
        """Representative value of bucket k: the γ-midpoint 2γ^k/(1+1/γ),
        which is within rel_acc relative error of every x in the bucket."""
        return 2.0 * math.exp(k * self._log_gamma) / (1.0 + 1.0 / self.gamma)

    def add(self, x: float, weight: float = 1.0) -> None:
        x = float(x)
        if x != x:
            raise ValueError("cannot add NaN")
        if x < 0:
            raise ValueError("sketch tracks nonnegative latencies/costs")
        if weight <= 0:
            return
        if x <= _ZERO_EPS:
            self.zero_count += weight
        else:
            k = self.key(x)
            self._store[k] = self._store.get(k, 0.0) + weight
        self.count += weight
        self.total += x * weight
        self._min = min(self._min, x)
        self._max = max(self._max, x)

    def add_many(self, xs: Iterable[float]) -> None:
        xs = np.asarray(list(xs) if not isinstance(xs, np.ndarray) else xs,
                        dtype=np.float64).ravel()
        if xs.size == 0:
            return
        if np.any(np.isnan(xs)) or np.any(xs < 0):
            raise ValueError("sketch tracks nonnegative, non-NaN values")
        pos = xs[xs > _ZERO_EPS]
        self.zero_count += xs.size - pos.size
        if pos.size:
            keys = np.floor(np.log(pos) / self._log_gamma).astype(np.int64)
            uniq, cnt = np.unique(keys, return_counts=True)
            for k, c in zip(uniq.tolist(), cnt.tolist()):
                self._store[k] = self._store.get(k, 0.0) + c
        self.count += xs.size
        self.total += float(xs.sum())
        self._min = min(self._min, float(xs.min()))
        self._max = max(self._max, float(xs.max()))

    # -------------------------------------------------------------- merges
    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """In-place exact merge (same γ required); returns self."""
        if abs(other.rel_acc - self.rel_acc) > 1e-12:
            raise ValueError(
                f"cannot merge sketches with rel_acc {self.rel_acc} vs {other.rel_acc}"
            )
        for k, c in other._store.items():
            self._store[k] = self._store.get(k, 0.0) + c
        self.zero_count += other.zero_count
        self.count += other.count
        self.total += other.total
        self._min = min(self._min, other._min)
        self._max = max(self._max, other._max)
        return self

    def copy(self) -> "QuantileSketch":
        s = QuantileSketch(self.rel_acc)
        s._store = dict(self._store)
        s.zero_count = self.zero_count
        s.count = self.count
        s.total = self.total
        s._min = self._min
        s._max = self._max
        return s

    # ------------------------------------------------------------ queries
    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else float("nan")

    @property
    def min(self) -> float:
        return self._min if self.count else float("nan")

    @property
    def max(self) -> float:
        return self._max if self.count else float("nan")

    def quantile(self, q: float) -> float:
        """Value at quantile q ∈ [0, 1], within rel_acc relative error of a
        sample at that rank (exact-extreme clamped)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("q must be in [0, 1]")
        if self.count == 0:
            return float("nan")
        return self.quantiles((q,))[0]

    def quantiles(self, qs: Sequence[float]) -> list[float]:
        """Many quantiles in ONE pass over the (sorted) bucket keys."""
        if self.count == 0:
            return [float("nan")] * len(qs)
        order = np.argsort(qs, kind="stable")
        ranks = [q * (self.count - 1) for q in qs]
        out = [0.0] * len(qs)
        items = sorted(self._store.items())
        cum = self.zero_count
        it = iter(items)
        cur: Optional[tuple] = next(it, None)
        val = 0.0  # zero bucket first
        for oi in order:
            r = ranks[oi]
            while cum <= r and cur is not None:
                k, c = cur
                cum += c
                val = self.bucket_value(k)
                cur = next(it, None)
            out[oi] = min(max(val, self._min), self._max)
        return out

    def summary(self) -> dict:
        p50, p99, p999 = self.quantiles((0.5, 0.99, 0.999))
        return dict(count=self.count, mean=self.mean, min=self.min,
                    max=self.max, p50=p50, p99=p99, p999=p999)

    def exceed_fraction(self, x: float) -> float:
        """Fraction of observed weight strictly above x (the SLO-violation
        query).  Bucket-resolved: the bucket containing x contributes
        nothing, so the answer is exact up to one γ-bucket of blur around
        x — a relative-accuracy contract matching `quantile`'s."""
        if self.count == 0:
            return float("nan")
        if x < 0:
            return 1.0
        if x >= self._max:
            return 0.0
        if x <= _ZERO_EPS:
            return (self.count - self.zero_count) / self.count
        kx = self.key(x)
        above = sum(c for k, c in self._store.items() if k > kx)
        return above / self.count

    # ------------------------------------------- device-histogram ingestion
    @classmethod
    def from_bincounts(
        cls,
        counts,
        key0: int,
        rel_acc: float,
        vmin: Optional[float] = None,
        vmax: Optional[float] = None,
        total: Optional[float] = None,
    ) -> "QuantileSketch":
        """Rebuild a sketch from a fixed-size device bincount.

        `counts[i]` is the weight of γ-bucket `key0 + i` — exactly the
        layout `repro.obs.device.device_histogram` accumulates in-program
        (out-of-range values clamped into the edge bins; pass the exact
        in-program `vmin`/`vmax` so quantile clamping stays truthful).
        """
        s = cls(rel_acc)
        counts = np.asarray(counts, dtype=np.float64).ravel()
        for i, c in enumerate(counts.tolist()):
            if c > 0:
                s._store[key0 + i] = c
        s.count = float(counts.sum())
        if s.count:
            s._min = float(vmin) if vmin is not None else s.bucket_value(
                key0 + int(np.flatnonzero(counts > 0)[0])
            ) / s.gamma
            s._max = float(vmax) if vmax is not None else s.bucket_value(
                key0 + int(np.flatnonzero(counts > 0)[-1])
            ) * s.gamma
            s.total = float(total) if total is not None else float("nan")
        return s

    def __len__(self) -> int:
        return len(self._store) + (1 if self.zero_count else 0)

    def __repr__(self) -> str:
        return (f"QuantileSketch(rel_acc={self.rel_acc}, count={self.count:g}, "
                f"bins={len(self)})")


def merge_all(sketches: Sequence[QuantileSketch]) -> QuantileSketch:
    """Fold a sequence of sketches into a fresh one (exact, associative)."""
    if not sketches:
        raise ValueError("need at least one sketch")
    out = sketches[0].copy()
    for s in sketches[1:]:
        out.merge(s)
    return out
