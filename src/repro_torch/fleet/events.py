"""Event-heap core of the discrete-event fleet engine.

A copy of `repro.fleet.events` for the port.

A plain binary heap of (time, seq, Event) with two properties the scheduler
relies on:

  * deterministic total order — ties in time break by insertion sequence
    (FIFO), so a fleet run is reproducible given the workload seed;
  * O(1) lazy cancellation — cancelling a copy marks its finish event dead;
    dead events are skipped at pop time instead of being removed from the
    middle of the heap (the classic priority-queue-with-delete idiom).

The engine is deliberately tiny: `kind` is a free-form string and `data` an
arbitrary payload, so scheduler.py owns all semantics.

Multi-scheduler simulations (the DAG engine: one `FleetScheduler` per
stage, one global clock) share a single heap through `OwnedHeap` views:
each view tags the events it pushes with its owner, so the driver popping
from the shared heap can route every event back to the scheduler whose
state machine it belongs to — barrier releases across stages then
interleave in true global time order instead of per-stage order.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Optional

__all__ = ["Event", "EventHeap", "OwnedHeap"]


@dataclasses.dataclass
class Event:
    time: float
    seq: int  # insertion order; breaks time ties FIFO
    kind: str
    data: Any = None
    cancelled: bool = False
    owner: Any = None  # routing tag on shared heaps (see OwnedHeap)

    def cancel(self) -> None:
        self.cancelled = True


class EventHeap:
    def __init__(self) -> None:
        self._heap: list[tuple[float, int, Event]] = []
        self._seq = 0
        self._live = 0
        # obs hook: a `repro_torch.obs` Recorder counting heap traffic
        # (events.pushed / popped / cancelled).  None (default) keeps the
        # engine's hot loop at a single attribute check per operation.
        self.recorder = None

    def __len__(self) -> int:
        return self._live

    def __bool__(self) -> bool:
        return self._live > 0

    def push(self, time: float, kind: str, data: Any = None) -> Event:
        if time < 0 or time != time:  # negative or NaN
            raise ValueError(f"bad event time {time!r}")
        ev = Event(time=float(time), seq=self._seq, kind=kind, data=data)
        self._seq += 1
        self._live += 1
        heapq.heappush(self._heap, (ev.time, ev.seq, ev))
        if self.recorder is not None:
            self.recorder.count("events.pushed")
        return ev

    def cancel(self, ev: Event) -> None:
        """Lazy-delete: the event stays heaped but will be skipped.

        The payload is dropped immediately — a lazily-cancelled event can
        sit in the heap until its original fire time, and under chaos
        (mass crash-kills) cancelled copy_done events dominate, so keeping
        `data` alive would pin every killed copy's job state.  When dead
        entries outnumber live ones the heap is compacted in place.
        """
        if not ev.cancelled:
            ev.cancel()
            ev.data = None
            self._live -= 1
            if self.recorder is not None:
                self.recorder.count("events.cancelled")
            if len(self._heap) > 64 and self._live * 2 < len(self._heap):
                self._compact()

    def _compact(self) -> None:
        """Rebuild the heap from live entries only (O(live))."""
        self._heap = [entry for entry in self._heap if not entry[2].cancelled]
        heapq.heapify(self._heap)
        if self.recorder is not None:
            self.recorder.count("events.compactions")

    def pop(self) -> Optional[Event]:
        """Next live event in (time, seq) order; None when drained."""
        while self._heap:
            _, _, ev = heapq.heappop(self._heap)
            if ev.cancelled:
                continue
            self._live -= 1
            if self.recorder is not None:
                self.recorder.count("events.popped")
            return ev
        return None

    def peek_time(self) -> Optional[float]:
        while self._heap and self._heap[0][2].cancelled:
            heapq.heappop(self._heap)
        return self._heap[0][0] if self._heap else None


class OwnedHeap:
    """A scheduler's view of a shared `EventHeap`: pushes are tagged with
    `owner` so the driver that pops from the shared heap knows which
    scheduler's `handle()` each event belongs to.  Covers the heap surface
    a driven `FleetScheduler` uses (push / cancel / truthiness / len) —
    popping is the DRIVER's job on the underlying shared heap: a shared
    heap holds every scheduler's events, so `pop` here raises rather than
    hand one scheduler another's event (e.g. `FleetScheduler.run()` called
    directly on a DAG stage scheduler would otherwise admit foreign-stage
    jobs into the wrong pool and silently corrupt both schedulers).
    """

    def __init__(self, heap: EventHeap, owner: Any):
        self.heap = heap
        self.owner = owner

    def push(self, time: float, kind: str, data: Any = None) -> Event:
        ev = self.heap.push(time, kind, data)
        ev.owner = self.owner
        return ev

    def cancel(self, ev: Event) -> None:
        self.heap.cancel(ev)

    def pop(self) -> Optional[Event]:
        raise RuntimeError(
            "this scheduler shares its event heap with others and cannot be "
            "run standalone; drive it through the owning driver (e.g. "
            "DagFleetScheduler.run), which pops the shared heap and routes "
            "events by owner"
        )

    def peek_time(self) -> Optional[float]:
        return self.heap.peek_time()

    def __len__(self) -> int:
        return len(self.heap)

    def __bool__(self) -> bool:
        return bool(self.heap)
