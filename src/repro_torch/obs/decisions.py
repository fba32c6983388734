"""Structured decision log for the adaptive controller.

A copy of `repro.obs.decisions` for the port.

`FleetPolicyController` makes four kinds of decisions worth auditing —
re-plans (which policy won and why), drift flushes (the service-time
reservoir discarded on a KS shift, trigger="ks", or the attempt-outcome
window halved on a failure-rate shift, trigger="failure_rate"), ε-greedy
explorations (a deliberately suboptimal probe), and ρ-guard vetoes
(candidates rejected for saturating the fleet).  Until now
those were visible only as an ad-hoc list comprehension over
`controller.history` inside `bench_fleet`; `DecisionLog` makes them a
first-class, filterable, export-ready record that also lands on the trace
timeline (as instants on the controller pid) so Perfetto shows decision
markers aligned with the job spans they affected.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from .trace import PID_CONTROLLER, Recorder, NullRecorder, get_recorder

__all__ = ["DecisionEvent", "DecisionLog",
           "KIND_REPLAN", "KIND_DRIFT", "KIND_EXPLORE", "KIND_VETO",
           "KIND_BLAME"]

KIND_REPLAN = "replan"
KIND_DRIFT = "drift"
KIND_EXPLORE = "explore"
KIND_VETO = "veto"
#: straggler attribution surfaced by the controller (repro_torch.obs.blame):
#: label names the blamed machine class, args carry the score/ranking
KIND_BLAME = "blame"


@dataclasses.dataclass
class DecisionEvent:
    """One controller decision, with the state that justified it."""

    t: float                  # sim time of the decision
    kind: str                 # replan | drift | explore | veto
    label: str                # chosen policy label (or vetoed candidate)
    trigger: str = ""         # periodic | ks | failure_rate | probe | ...
    lam_hat: float = float("nan")   # arrival-rate estimate at decision time
    rho: float = float("nan")       # predicted utilization of the choice
    ks_stat: float = float("nan")   # drift statistic (KS, or |Δq̂| for
    #                                 failure_rate drift events)
    n_samples: int = 0              # samples backing the estimate
    n_vetoed: int = 0               # candidates the ρ-guard rejected
    args: Optional[dict] = None     # anything extra (per-class labels, ...)

    def render(self) -> str:
        bits = [f"t={self.t:9.2f}", f"{self.kind:7s}", self.label]
        if self.trigger:
            bits.append(f"trigger={self.trigger}")
        if self.lam_hat == self.lam_hat:
            bits.append(f"lam_hat={self.lam_hat:.3f}")
        if self.rho == self.rho:
            bits.append(f"rho={self.rho:.3f}")
        if self.ks_stat == self.ks_stat:
            bits.append(f"ks={self.ks_stat:.3f}")
        if self.n_vetoed:
            bits.append(f"vetoed={self.n_vetoed}")
        return "  ".join(bits)


class DecisionLog:
    """Append-only decision record, mirrored onto a trace recorder.

    Every `log()` appends a `DecisionEvent` and, when the recorder is
    enabled, drops an instant on the controller pid so the decision shows
    up as a marker in the exported trace.  `recorder=None` (default)
    resolves the process-wide recorder at each log, so a controller built
    before `obs.enable()` still lands on the timeline.
    """

    def __init__(self, recorder: Optional[Recorder | NullRecorder] = None):
        self.events: list[DecisionEvent] = []
        self.recorder = recorder

    def log(self, event: DecisionEvent) -> DecisionEvent:
        self.events.append(event)
        rec = self.recorder if self.recorder is not None else get_recorder()
        if rec.enabled:
            args = {"label": event.label, "trigger": event.trigger}
            if event.lam_hat == event.lam_hat:
                args["lam_hat"] = round(event.lam_hat, 6)
            if event.rho == event.rho:
                args["rho"] = round(event.rho, 6)
            if event.ks_stat == event.ks_stat:
                args["ks_stat"] = round(event.ks_stat, 6)
            if event.n_vetoed:
                args["n_vetoed"] = event.n_vetoed
            if event.args:
                args.update(event.args)
            rec.instant(event.kind, "decision", event.t,
                        pid=PID_CONTROLLER, args=args)
        return event

    # ------------------------------------------------------------- queries
    def of_kind(self, kind: str) -> list[DecisionEvent]:
        return [e for e in self.events if e.kind == kind]

    @property
    def n_replans(self) -> int:
        return len(self.of_kind(KIND_REPLAN))

    @property
    def n_drifts(self) -> int:
        return len(self.of_kind(KIND_DRIFT))

    @property
    def n_explorations(self) -> int:
        return len(self.of_kind(KIND_EXPLORE))

    @property
    def n_vetoes(self) -> int:
        return sum(e.n_vetoed for e in self.events)

    def timeline(self) -> list[dict]:
        """JSON-ready rows (bench artifacts, CI uploads)."""
        return [dataclasses.asdict(e) for e in self.events]

    def render(self) -> str:
        return "\n".join(e.render() for e in self.events)

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self):
        return iter(self.events)
