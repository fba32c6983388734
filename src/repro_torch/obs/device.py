"""Device-side histogram accumulation for the fused engines, in PyTorch.

Counterpart of `repro.obs.device`.  The fused frontier and DAG engines
evaluate (cells × trials × jobs) sojourns on the device; moving that tensor
to the host only to read p50/p99/p999 off it costs more than the rest of a
large sweep.  Instead each cell's values are counted into a fixed-size
log-spaced histogram on the device and only (n_bins + 3) numbers per cell
(the counts, min, max and sum) reach the host.  The bin edges are the SAME
geometric buckets `QuantileSketch` uses (bucket k covers [γ^k, γ^(k+1))),
so `sketch_from_device` rebuilds the sketch with no second quantization
and its quantiles carry the sketch's rel_acc guarantee for every value
inside [lo, hi).  Values outside the range clamp into the edge bins; the
exact min and max ride along, so quantiles clamp truthfully at the ends.

All cells of a batch are counted by ONE `torch.bincount` over
`cell * n_bins + bin`, not a loop over cells.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .sketch import QuantileSketch

__all__ = [
    "HistSpec",
    "DEFAULT_HIST",
    "cell_histograms",
    "device_histogram",
    "sketch_from_device",
]


@dataclasses.dataclass(frozen=True)
class HistSpec:
    """A device histogram's layout: γ-buckets starting at `lo`, `n_bins` of
    them, with the sketch's relative accuracy."""

    lo: float = 1e-3
    n_bins: int = 512
    rel_acc: float = 0.02

    @property
    def gamma(self) -> float:
        return (1.0 + self.rel_acc) / (1.0 - self.rel_acc)

    @property
    def log_gamma(self) -> float:
        return math.log(self.gamma)

    @property
    def key0(self) -> int:
        """γ-bucket index of the first bin (sketch key alignment)."""
        return math.floor(math.log(self.lo) / self.log_gamma)

    @property
    def hi(self) -> float:
        """Upper edge of the last bin."""
        return math.exp((self.key0 + self.n_bins) * self.log_gamma)


#: 512 bins at 2% relative accuracy span 1e-3 .. ~8.6e5, wide enough for
#: every sojourn and cost scale in the repo
DEFAULT_HIST = HistSpec()


def cell_histograms(x: torch.Tensor, spec: HistSpec = DEFAULT_HIST):
    """Per-cell histograms of `x`, shaped (cells, ...), over spec's γ-buckets.

    Returns (counts (cells, n_bins) float32, agg (cells, 3) float32 holding
    each cell's min, max and sum), on x's device.  The bin of a value is
    floor(log(x) / log γ) - key0 in float32, as in the reference; a value
    within an ulp of an edge may land in the neighbouring bin there, since
    the two frameworks' `log` may differ by one ulp.  Counts are float32,
    as in the reference: exact up to 2^24 values per cell (a full-width
    cell holds m·J = 32768).
    """
    cells = x.shape[0]
    flat = x.reshape(cells, -1)
    safe = torch.clamp(flat, min=1e-30)  # log of exact zeros clamps to bin 0
    idx = torch.floor(torch.log(safe) / spec.log_gamma).to(torch.int64) - spec.key0
    idx = torch.clamp(idx, 0, spec.n_bins - 1)
    idx += torch.arange(cells, device=x.device)[:, None] * spec.n_bins
    counts = torch.bincount(idx.reshape(-1), minlength=cells * spec.n_bins)
    agg = torch.stack([flat.amin(dim=1), flat.amax(dim=1), flat.sum(dim=1)], dim=1)
    return counts.to(torch.float32).reshape(cells, spec.n_bins), agg


def device_histogram(x: torch.Tensor, spec: HistSpec = DEFAULT_HIST):
    """Histogram of `x` (any shape) over spec's γ-buckets: (counts[n_bins]
    float32, vmin, vmax, total), the payload that replaces the raw samples
    off the device."""
    counts, agg = cell_histograms(x.reshape(1, -1), spec)
    return counts[0], agg[0, 0], agg[0, 1], agg[0, 2]


def sketch_from_device(counts, vmin, vmax, total, spec: HistSpec = DEFAULT_HIST) -> QuantileSketch:
    """Host-side sketch over a `device_histogram` payload (no requantize)."""
    if torch.is_tensor(counts):
        counts = counts.cpu().numpy()
    return QuantileSketch.from_bincounts(
        counts, key0=spec.key0, rel_acc=spec.rel_acc,
        vmin=float(vmin), vmax=float(vmax), total=float(total),
    )
