"""Per-machine(-class) straggler blame: who is dragging the tail?

A numpy copy of `repro.obs.blame` for the port.

Clone-timing analyses (Aktaş & Soljanin, arXiv:1710.00748) and the
delayed-relaunch line of work presume an online signal naming *which*
machines straggle — replicating everywhere because one pool is slow
wastes exactly the budget the paper's policies are tuned to spend well.
`StragglerBlame` produces that signal from the telemetry the scheduler
already emits (each `JobRecord` carries its `machine_class` and sojourn):

  * **counterfactual tail score** — for each machine m, recompute the
    fleet tail quantile with m's jobs *removed*; the blame score is the
    relative tail reduction (p_q(all) - p_q(without m)) / p_q(all).  A
    machine only earns blame if deleting it actually shortens the tail,
    which is robust to machines that are merely busy (their removal
    leaves the tail where it was);
  * **rolling drift** — per-machine, a half-split Kolmogorov–Smirnov
    statistic over the retained window flags a machine whose *own*
    latency law moved (thermal throttling, a bad disk, a noisy
    neighbor), as opposed to one that was always slow;
  * bounded memory — per-machine reservoirs of the most recent `window`
    sojourns, nothing proportional to stream length.

The controller (`fleet.adaptive.FleetPolicyController`) feeds completed
jobs in via `observe`, logs a `blame` decision event whenever a machine
crosses `min_score`, and — with `blame_target=True` — escalates the
blamed class's per-class policy to a replicating one: the attribution
becomes a replication-*targeting* signal, not just a report.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional, Sequence

import numpy as np

__all__ = ["BlameScore", "StragglerBlame"]


def _ks(a: np.ndarray, b: np.ndarray) -> float:
    """Two-sample KS statistic (local copy: obs must not import fleet)."""
    a = np.sort(a)
    b = np.sort(b)
    grid = np.concatenate([a, b])
    cdf_a = np.searchsorted(a, grid, side="right") / a.size
    cdf_b = np.searchsorted(b, grid, side="right") / b.size
    return float(np.max(np.abs(cdf_a - cdf_b)))


@dataclasses.dataclass
class BlameScore:
    """One machine's straggler attribution at a point in time."""

    name: str
    n: int                    # sojourns retained for this machine
    mean: float               # its mean sojourn
    p_q: float                # its own tail quantile
    share: float              # its fraction of retained jobs
    tail_delta: float         # fleet p_q(all) - p_q(without this machine)
    score: float              # tail_delta / p_q(all), clamped to [0, 1]
    ks: float = float("nan")  # half-split drift statistic (nan: too few)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class StragglerBlame:
    """Streaming counterfactual blame over per-machine sojourn windows."""

    def __init__(self, quantile: float = 0.99, window: int = 2048,
                 min_samples: int = 32, drift_threshold: float = 1.63):
        if not 0.0 < quantile < 1.0:
            raise ValueError("quantile must be in (0, 1)")
        self.quantile = quantile
        self.window = int(window)
        self.min_samples = int(min_samples)
        # KS c(α)·√((m+n)/mn) scaling, same convention as fleet.adaptive
        self.drift_threshold = float(drift_threshold)
        self._by_machine: dict[str, deque] = {}
        self.n_seen = 0

    # ------------------------------------------------------------ ingestion
    def observe(self, machine: str, sojourn: float) -> None:
        """One completed job's sojourn attributed to one machine (class)."""
        d = self._by_machine.get(machine)
        if d is None:
            d = self._by_machine[machine] = deque(maxlen=self.window)
        d.append(float(sojourn))
        self.n_seen += 1

    def observe_records(self, records: Sequence) -> "StragglerBlame":
        """Batch ingestion of scheduler `JobRecord`s (or anything with
        `.machine_class`, `.sojourn`, `.failed`).  Failed/shed records
        carry no served latency and are skipped."""
        for r in records:
            if getattr(r, "failed", False):
                continue
            self.observe(r.machine_class, r.sojourn)
        return self

    # -------------------------------------------------------------- queries
    @property
    def machines(self) -> list[str]:
        return sorted(self._by_machine)

    def drift(self, machine: str) -> float:
        """Half-split KS over this machine's window, scaled by the KS
        critical factor — > 1 means its own latency law moved."""
        xs = np.asarray(self._by_machine.get(machine, ()), dtype=np.float64)
        if xs.size < 2 * self.min_samples:
            return float("nan")
        half = xs.size // 2
        a, b = xs[:half], xs[half:]
        crit = self.drift_threshold * np.sqrt(
            (a.size + b.size) / (a.size * b.size)
        )
        return _ks(a, b) / crit

    def ranking(self) -> list[BlameScore]:
        """Counterfactual blame, most-blamed first.

        With fewer than two machines (or too few samples anywhere) the
        counterfactual is undefined and the ranking is empty — blame is a
        *comparative* statement."""
        names = [n for n, d in self._by_machine.items()
                 if len(d) >= self.min_samples]
        if len(names) < 2:
            return []
        pools = {n: np.asarray(self._by_machine[n], dtype=np.float64)
                 for n in names}
        all_x = np.concatenate(list(pools.values()))
        p_all = float(np.quantile(all_x, self.quantile))
        total = all_x.size
        out = []
        for n in names:
            rest = np.concatenate([pools[m] for m in names if m != n])
            p_without = float(np.quantile(rest, self.quantile))
            delta = p_all - p_without
            score = min(max(delta / p_all, 0.0), 1.0) if p_all > 0 else 0.0
            out.append(BlameScore(
                name=n,
                n=int(pools[n].size),
                mean=float(pools[n].mean()),
                p_q=float(np.quantile(pools[n], self.quantile)),
                share=pools[n].size / total,
                tail_delta=delta,
                score=score,
                ks=self.drift(n),
            ))
        out.sort(key=lambda s: s.score, reverse=True)
        return out

    def blamed(self, min_score: float = 0.1) -> Optional[str]:
        """The top-ranked machine, if its score clears `min_score`."""
        ranking = self.ranking()
        if ranking and ranking[0].score >= min_score:
            return ranking[0].name
        return None

    def drifted(self) -> dict[str, float]:
        """Machines whose own law moved: {name: scaled KS > 1}."""
        out = {}
        for n in self.machines:
            d = self.drift(n)
            if d == d and d > 1.0:
                out[n] = d
        return out

    def summary(self) -> dict:
        """JSON-ready snapshot (dashboard / bench artifacts)."""
        return {
            "quantile": self.quantile,
            "n_seen": self.n_seen,
            "ranking": [s.as_dict() for s in self.ranking()],
            "drifted": self.drifted(),
        }

    def __repr__(self) -> str:
        return (f"StragglerBlame(q={self.quantile}, machines="
                f"{len(self._by_machine)}, seen={self.n_seen})")
