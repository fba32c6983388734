"""Capacity-aware fleet scheduler: the discrete-event heart of repro_torch.fleet.

A copy of `repro.fleet.scheduler`.  It runs on the host with numpy's
generators, so for the same seed it draws the same uniforms as the
reference; service times come from the port's float32 quantile transforms
(`_host_quantile`), which take distributions on the CPU only.

Semantics (DESIGN.md §9):

  * the fleet has `capacity` identical worker slots; every running task
    copy occupies one slot from launch until first-finisher cancellation;
  * jobs queue for admission — a job starts only when `n_tasks` slots are
    free (gang scheduling: a parallel job cannot run partially).  FIFO is
    strict head-of-line; "priority" picks the lowest `priority` value among
    queued jobs but still blocks behind an unfittable head only if nothing
    fits (backfilling smaller/urgent jobs is exactly what the knob is for);
  * replication follows the job's single-/multi-fork policy via the same
    `num_stragglers` fork-point rule as the single-job executor: when
    (1-p)n of a job's tasks are done, each straggler gets r fresh copies
    (keep) or is killed and relaunched with r+1 copies.  Replicas are
    launched *best effort* — only as many as free slots allow (a kill
    always nets at least one fresh copy: the cancel frees a slot first);
  * `relaunch_delay` postpones the fork by a fixed delay after the trigger
    ("delayed relaunch", Aktaş-Peng-Soljanin 2017): copies keep running
    during the delay and the kill, if any, happens at the delayed instant;
  * `preempt_replicas=True` lets admission cancel *speculative* copies
    (never the last live copy of a task) newest-first to free slots for a
    queued job's originals — replication yields to throughput when tight;
  * cost follows Definition 2: every copy is billed wall-clock from launch
    to first-finisher (or cancellation), summed per job and divided by n.

Heterogeneous machine classes (`workload.MachineClass`): the pool may be a
sequence of classes, each with a slot count and a speed multiplier; a copy
launched on class k runs for duration/speed_k wall-clock.  Two placement
modes:

  * `placement="pooled"` (default) — copies are placed on individual slots,
    fastest class first; a job's originals may span classes.  This is the
    general work-conserving engine.
  * `placement="aligned"` — gang-block placement: an admitted job reserves
    `n_tasks` slots in ONE class until it finishes, and its replicas only
    draw from its own reservation.  A job is admitted when some class has a
    free gang block (fastest such class wins).  This mode is by
    construction the exact discrete-event realization of the vectorized
    Kiefer–Wolfowitz G/G/c model (`repro_torch.fleet.vector`), which is why the
    agreement tests run it: the fast path's oracle has the same semantics,
    not merely similar statistics.

An optional policy provider supplies the policy for jobs that don't pin
one.  The scheduler speaks the provider hook (`observe_arrival`,
`policy_for(job, machine_class)`, `record_task_time`,
`record_job_complete`): pass a `fleet.adaptive.FleetPolicyController` for
load-aware closed-loop control, or a legacy `core.adaptive.
OnlinePolicyController` (adapted automatically via `as_policy_provider`).
Providers additionally implementing `record_task_failure` are told about
every failed attempt (so the fleet controller can re-plan on failure-rate
drift, not just service-distribution drift).

Chaos semantics (`fault=repro_torch.faults.FaultSpec`, DESIGN.md §15):

  * task-failure laws: each copy attempt fails with probability q
    (discovered only when the attempt would have completed — the copy
    burns its full drawn duration), or races a fail-time draw against its
    service draw (`fail_dist`), failing early with partial work billed;
  * retries: a failed copy is relaunched with a fresh service draw after
    capped exponential backoff, up to `max_attempts` per copy lineage;
    retries that find no free slot wait and are drained BEFORE new
    admissions.  A task whose every lineage exhausts its budget makes the
    job terminally `failed` (failure="max_attempts");
  * machine faults: `machine_down` kills the newest running copies on the
    victim class first (each killed copy fails through the same retry
    path) and shrinks the free ledger; `machine_up` restores it.  Per-class
    free/busy/reserved ledgers stay conserved throughout — downed slots are
    accounted in `down_by_class`, never double-freed;
  * deadlines: a job with `Job.deadline` is killed (failure="timeout") at
    arrival + deadline whether queued or running;
  * load shedding: with `shed_rho` set, arrivals of priority >=
    `shed_min_priority` are rejected up front (failure="shed") while the
    estimated gang-occupancy ρ̂ = λ̂·Ê[service]·n̄ / surviving weighted
    slots exceeds the threshold — graceful degradation instead of an
    unbounded queue when capacity is down.

All of it is strictly opt-in: with `fault=None` (or a spec with nothing
enabled), no deadline/shed knobs, the scheduler consumes the exact same
RNG stream and emits the exact same event sequence as before — q=0 runs
reproduce the historical engine event for event.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from ..core.policy import (
    BASELINE,
    AnySlot,
    AtQuantile,
    GroupSelect,
    OnClass,
    SingleForkPolicy,
    as_fork_policy,
    num_stragglers,
)

from ..core.distributions import Empirical
from ..faults.model import FaultSpec
from ..obs import trace as _trace

from .adaptive import as_policy_provider
from .events import Event, EventHeap
from .workload import Job, MachineClass

__all__ = ["FleetScheduler", "JobRecord"]


def _host_quantile(dist, u):
    """`dist.quantile(u)` for numpy uniforms (an array or a float), as
    float64 numpy on the host.  A distribution whose samples lie on the
    card is refused rather than copied back at every draw."""
    if isinstance(dist, Empirical) and dist.sorted.device.type != "cpu":
        raise ValueError(
            "the event engine runs on the host: give it distributions on the "
            f"CPU (an Empirical's samples are on {dist.sorted.device})"
        )
    return np.asarray(dist.quantile(u), dtype=np.float64)


@dataclasses.dataclass
class JobRecord:
    """Per-job outcome; the unit the fleet metrics aggregate over."""

    job_id: int
    arrival: float
    start: float  # admission instant
    finish: float  # last task completion
    n_tasks: int
    cost: float  # Definition 2: sum of copy runtimes / n
    n_replicas: int  # fresh copies actually launched
    n_preempted: int  # copies cancelled by admission preemption
    policy: str
    machine_class: str = "default"  # class of the first original copy
    n_attempts: int = 0  # total copy launches (originals + replicas + retries)
    failed: bool = False  # terminal failure (never completed)
    failure: str = ""  # "" | "max_attempts" | "timeout" | "shed"

    @property
    def sojourn(self) -> float:
        return self.finish - self.arrival

    @property
    def wait(self) -> float:
        return self.start - self.arrival

    @property
    def service(self) -> float:
        return self.finish - self.start


@dataclasses.dataclass
class _Copy:
    start: float
    event: Event  # its copy_done event (cancel via heap)
    fresh: bool  # replica (vs original)
    cls: int = 0  # machine-class index the copy's slot belongs to
    live: bool = True
    attempts: int = 1  # which attempt of its lineage this copy is
    will_fail: bool = False  # fault verdict, drawn at launch


class _Task:
    __slots__ = ("done", "copies", "retry_events")

    def __init__(self):
        self.done = False
        self.copies: list[_Copy] = []
        self.retry_events: list[Event] = []  # heap-pending retry launches

    @property
    def live_copies(self) -> list[_Copy]:
        return [c for c in self.copies if c.live]


class _RunningJob:
    def __init__(self, job: Job, t_start: float, plan: "_PolicyPlan", durations: np.ndarray):
        self.job = job
        self.t_start = t_start
        self.plan = plan
        self.stages = plan.stages  # ((kind, val, r, keep), ...) in firing order
        self.next_stage = 0
        self.durations = durations  # base original-copy durations (telemetry)
        self.n_done = 0
        self.tasks = [_Task() for _ in range(job.n_tasks)]
        self.cost = 0.0
        self.n_replicas = 0
        self.n_preempted = 0
        self.n_attempts = 0  # every copy launch, retries included
        self.fork_pending = False
        self.home_class = 0  # reservation class (aligned) / first-copy class
        self.classes_used: set = set()  # class indices any copy landed on
        self.n_live = 0  # live copies (bounds replicas in aligned mode)
        # (n, d) group selection: per-group completion counts and a fired
        # flag per group (group forks are single-stage and independent)
        self.group_width = plan.group_width(job.n_tasks)
        if self.group_width is not None:
            n_groups = job.n_tasks // self.group_width
            self.group_done = [0] * n_groups
            self.group_fired = [False] * n_groups


@dataclasses.dataclass(frozen=True)
class _PolicyPlan:
    """A policy normalized for the event engine: the same lowering contract
    as `core.policy.lower_policies`, in event-machine form.  `stages` hold
    ("q", p, r, keep) | ("t", t, r, keep) triggers in firing order; `d`
    is the (n, d) group width (None = unrestricted); `klass` pins
    placement to one machine class by name (OnClass)."""

    stages: tuple
    d: Optional[int] = None
    klass: Optional[str] = None

    def group_width(self, n_tasks: int) -> Optional[int]:
        """Resolved group width for an n-task job (None = global forks)."""
        if self.d is None or self.d >= n_tasks:
            return None  # d = n is exactly the unrestricted fork
        if n_tasks % self.d:
            raise ValueError(
                f"group width d={self.d} must divide n_tasks={n_tasks}"
            )
        return self.d


def _policy_plan(policy) -> _PolicyPlan:
    if policy is None:
        return _PolicyPlan(stages=())
    fp = as_fork_policy(policy)
    stages = tuple(
        ("q", w.p, r, keep) if isinstance(w, AtQuantile) else ("t", w.t, r, keep)
        for w, r, keep in fp.stages
    )
    # drop degenerate no-op stages (keep with r=0 at a quantile is baseline)
    stages = tuple(s for s in stages if not (s[0] == "q" and s[3] and s[2] == 0))
    if isinstance(fp.where, GroupSelect):
        return _PolicyPlan(stages=stages, d=fp.where.d)
    if isinstance(fp.where, OnClass):
        return _PolicyPlan(stages=stages, klass=fp.where.name)
    assert isinstance(fp.where, AnySlot)
    return _PolicyPlan(stages=stages)


class FleetScheduler:
    def __init__(
        self,
        capacity: Optional[int] = None,
        default_policy: SingleForkPolicy = BASELINE,
        discipline: str = "fifo",
        relaunch_delay: float = 0.0,
        preempt_replicas: bool = False,
        fork_overhead: float = 0.0,
        controller=None,  # policy provider (see as_policy_provider)
        seed: int = 0,
        classes: Optional[Sequence[MachineClass]] = None,
        placement: str = "pooled",
        recorder=None,  # repro_torch.obs Recorder; None = the process-wide one
        obs_pid: int = _trace.PID_FLEET,
        fault: Optional[FaultSpec] = None,  # chaos spec (None = no faults)
        shed_rho: Optional[float] = None,  # load-shed ρ̂ threshold (None = off)
        shed_min_priority: int = 1,  # only shed priorities >= this
    ):
        if classes is None:
            if capacity is None:
                raise ValueError("need either capacity or machine classes")
            classes = (MachineClass("default", int(capacity), 1.0),)
        self.classes = tuple(classes)
        if len({k.name for k in self.classes}) != len(self.classes):
            raise ValueError("machine-class names must be unique")
        if any(k.name == "mixed" for k in self.classes):
            raise ValueError('"mixed" is reserved for jobs whose copies span classes')
        total = sum(k.slots for k in self.classes)
        if capacity is not None and capacity != total:
            raise ValueError(
                f"capacity={capacity} disagrees with class slots summing to {total}; "
                "pass one or the other"
            )
        if total < 1:
            raise ValueError("capacity must be >= 1")
        if discipline not in ("fifo", "priority"):
            raise ValueError(f"unknown discipline {discipline!r}")
        if placement not in ("pooled", "aligned"):
            raise ValueError(f"unknown placement {placement!r}")
        if placement == "aligned" and preempt_replicas:
            # aligned admission is reservation-gated; cancelling another
            # job's speculation can never free a reservation, so the knob
            # would silently do nothing
            raise ValueError("preempt_replicas has no effect under aligned placement")
        self.capacity = total
        self.placement = placement
        # class indices, fastest first (stable: declaration order on ties) —
        # shared placement preference with the vectorized fast path
        self._class_order = sorted(
            range(len(self.classes)), key=lambda i: -self.classes[i].speed
        )
        self.default_policy = default_policy
        self.discipline = discipline
        self.relaunch_delay = relaunch_delay
        self.preempt_replicas = preempt_replicas
        self.fork_overhead = fork_overhead
        self.controller = as_policy_provider(controller)
        if self.controller is not None and hasattr(self.controller, "bind_fleet"):
            self.controller.bind_fleet(self.classes)
        # obs: an explicit recorder pins this scheduler's trace sink; None
        # defers to the process-wide recorder at each emission, so
        # `obs.enable()` lights up schedulers built earlier too.  Every
        # emit site guards on `rec.enabled` first — the disabled path adds
        # one attribute read per event.
        self._recorder = recorder
        self.obs_pid = obs_pid
        # decorrelated from workload generators that may share `seed`
        self.rng = np.random.default_rng((0x5C4ED, seed))
        # chaos: a spec with nothing enabled is identical to no spec, and a
        # disabled spec must not even create the fault RNG — the q=0 path's
        # contract is bitwise identity with the historical engine (same
        # self.rng consumption, same event sequence)
        self.fault = fault if (fault is not None and fault.enabled) else None
        self.fault_rng = (
            np.random.default_rng((0xFA17, seed)) if self.fault is not None else None
        )
        if shed_rho is not None and not shed_rho > 0:
            raise ValueError(f"shed_rho must be > 0, got {shed_rho}")
        self.shed_rho = shed_rho
        self.shed_min_priority = shed_min_priority
        # multi-scheduler drivers (the DAG engine) observe completions here
        # and may swap `heap` for an OwnedHeap view of a shared heap before
        # any event is pushed
        self.job_done_hook = None  # Callable[[JobRecord], None]
        # run state
        self.heap = EventHeap()
        self.queue: list[Job] = []
        self.running: dict[int, _RunningJob] = {}
        self.free_by_class = [k.slots for k in self.classes]
        self.reserved = [0] * len(self.classes)  # aligned-mode gang holds
        self.records: list[JobRecord] = []
        # fault state: downed slots per class, retries waiting for a slot,
        # repair durations (per-class MTTR), total slot-seconds of downtime
        self.down_by_class = [0] * len(self.classes)
        self.repairs_by_class: list[list[float]] = [[] for _ in self.classes]
        self.down_time = 0.0  # integral of down slots over time (slot-seconds)
        self._retry_waiting: list[tuple] = []  # (job_id, task_id, attempts)
        self._arrivals_pending = 0  # crash renewal stops when work drains
        # failure / degradation counters (mirrored to obs when enabled)
        self.n_task_failures = 0
        self.n_crash_kills = 0
        self.n_retries = 0
        self.n_failed = 0
        self.n_timeouts = 0
        self.n_shed = 0
        # shed estimator state (only fed when shed_rho is set)
        self._arrival_times: list[float] = []
        self._svc_sum = 0.0
        self._ntask_sum = 0.0
        self._done_jobs = 0
        # instrumentation (conservation + utilization)
        self.max_busy = 0
        self.busy_time = 0.0  # integral of busy slots over time (copy-seconds)
        self.busy_by_class = [0.0] * len(self.classes)
        self.now = 0.0

    @property
    def free(self) -> int:
        return sum(self.free_by_class)

    def _rec(self):
        """The trace sink for this scheduler (explicit, else process-wide)."""
        return self._recorder if self._recorder is not None else _trace.get_recorder()

    # ------------------------------------------------------------------ run
    def run(self, jobs: Sequence[Job]) -> list[JobRecord]:
        """Simulate to completion of every job; returns per-job records."""
        ids = [j.job_id for j in jobs]
        if len(set(ids)) != len(ids):
            raise ValueError("job_ids must be unique (running state is keyed by id)")
        rec = self._rec()
        if rec.enabled:
            self.heap.recorder = rec
        for job in jobs:
            self.heap.push(job.arrival, "arrive", job)
            if job.deadline is not None:
                self.heap.push(job.arrival + job.deadline, "deadline", job)
        self._arrivals_pending = len(jobs)
        if self.fault is not None:
            self._schedule_chaos()
        while self.heap:
            ev = self.heap.pop()
            if ev is None:
                break
            self.handle(ev)
        if self.queue:  # every queued job must eventually fit
            stuck = [j.job_id for j in self.queue]
            raise RuntimeError(
                f"jobs {stuck} can never be admitted "
                f"(n_tasks > capacity={self.capacity}?)"
            )
        if self.running or self._retry_waiting:  # no-job-lost invariant
            raise RuntimeError(
                f"heap drained with {len(self.running)} running jobs and "
                f"{len(self._retry_waiting)} waiting retries — a job was lost"
            )
        self.records.sort(key=lambda r: r.job_id)
        return self.records

    def handle(self, ev: Event) -> None:
        """Advance this scheduler's state machine by one event.

        Extracted from `run` so a multi-scheduler driver (the DAG engine's
        per-stage pools on one shared heap) can interleave several
        schedulers' events in global time order and route each popped event
        to its owner.
        """
        assert ev.time >= self.now - 1e-9, "event time went backwards"
        self.now = ev.time
        if ev.kind == "arrive":
            if self._arrivals_pending:
                self._arrivals_pending -= 1
            if self.controller is not None:
                self.controller.observe_arrival(self.now)
            shed = False
            if self.shed_rho is not None:
                self._arrival_times.append(self.now)
                if len(self._arrival_times) > 32:
                    del self._arrival_times[0]
                shed = self._should_shed(ev.data)
            if shed:
                self._shed_job(ev.data)
            else:
                self.queue.append(ev.data)
                self._try_admit()
        elif ev.kind == "copy_done":
            self._on_copy_done(ev)
            self._try_admit()
        elif ev.kind == "fork":
            self._on_fork(ev)
            self._try_admit()  # a kill stage can net-free slots
        elif ev.kind == "retry":
            self._on_retry(ev)
            self._try_admit()
        elif ev.kind == "machine_down":
            self._on_machine_down(ev)
            self._try_admit()
        elif ev.kind == "machine_up":
            self._on_machine_up(ev)
            self._try_admit()  # restored slots admit waiting work
        elif ev.kind == "deadline":
            self._on_deadline(ev)
            self._try_admit()  # a killed job frees its slots
        else:  # pragma: no cover
            raise RuntimeError(f"unknown event kind {ev.kind}")
        rec = self._rec()
        if rec.enabled:
            # sampled after every event: together these draw the queue-depth
            # and busy-slot time series under the job spans in Perfetto
            rec.counter_sample("queue_depth", self.now, len(self.queue),
                               pid=self.obs_pid)
            rec.counter_sample("busy_slots", self.now,
                               self.capacity - self.free, pid=self.obs_pid)

    # ------------------------------------------------------------ admission
    def _next_queued(self) -> Optional[Job]:
        if not self.queue:
            return None
        if self.discipline == "fifo":
            return self.queue[0]
        # priority: most urgent first; FIFO among equals (arrival order is
        # list order since arrivals push in time order)
        return min(self.queue, key=lambda j: j.priority)

    def _class_index(self, name: str) -> int:
        for i, k in enumerate(self.classes):
            if k.name == name:
                return i
        raise ValueError(f"unknown machine class {name!r} "
                         f"(have {[k.name for k in self.classes]})")

    def _job_restrict(self, job: Job) -> Optional[int]:
        """OnClass placement restriction for a job, as a class index.

        Resolved from the job's pinned policy or the scheduler default —
        provider-learned policies arrive after admission and cannot move a
        job between classes, so a provider must not recommend OnClass."""
        policy = job.policy if job.policy is not None else self.default_policy
        klass = _policy_plan(policy).klass
        return None if klass is None else self._class_index(klass)

    def _aligned_class(self, job: Job) -> Optional[int]:
        """Fastest class with a free `n_tasks` gang block (aligned mode)."""
        restrict = self._job_restrict(job)
        for i in self._class_order:
            if restrict is not None and i != restrict:
                continue
            up = self.classes[i].slots - self.down_by_class[i]
            if up - self.reserved[i] >= job.n_tasks:
                return i
        return None

    def _can_admit(self, job: Job) -> bool:
        if self.placement == "aligned":
            return self._aligned_class(job) is not None
        restrict = self._job_restrict(job)
        if restrict is not None:
            return self.free_by_class[restrict] >= job.n_tasks
        return self.free >= job.n_tasks

    def _try_admit(self) -> None:
        if self._retry_waiting:
            self._drain_retries()  # failed work re-enters before new work
        while True:
            job = self._next_queued()
            if job is None:
                return
            restrict = self._job_restrict(job)
            if restrict is not None:
                max_gang = self.classes[restrict].slots
            elif self.placement == "aligned":
                max_gang = max(k.slots for k in self.classes)
            else:
                max_gang = self.capacity
            if job.n_tasks > max_gang:
                raise RuntimeError(
                    f"job {job.job_id} needs {job.n_tasks} slots > "
                    f"{'largest class' if self.placement == 'aligned' else 'capacity'} "
                    f"{max_gang}"
                )
            if not self._can_admit(job) and self.preempt_replicas:
                self._preempt_for(job.n_tasks - self.free)
            if not self._can_admit(job):
                if self.discipline == "priority":
                    # try the next-most-urgent job that fits (backfill)
                    fit = [j for j in self.queue if self._can_admit(j)]
                    if fit:
                        job = min(fit, key=lambda j: j.priority)
                    else:
                        return
                else:
                    return  # FIFO head-of-line blocking
            self.queue.remove(job)
            self._start_job(job)

    def _preempt_for(self, needed: int) -> None:
        """Cancel speculative copies (never a task's last) newest-first —
        but only if that actually frees enough slots to admit; hedging is
        never sacrificed for an admission that still cannot happen."""
        victims: list[tuple[float, _RunningJob, _Copy]] = []
        for rjob in self.running.values():
            for task in rjob.tasks:
                if task.done:
                    continue
                live = task.live_copies
                # keep the oldest live copy; the rest are speculative
                for c in sorted(live, key=lambda c: c.start)[1:]:
                    victims.append((c.start, rjob, c))
        if len(victims) < needed:
            return
        victims.sort(key=lambda v: v[0], reverse=True)  # newest first
        for _, rjob, copy in victims[:needed]:
            self._cancel_copy(rjob, copy)
            rjob.n_preempted += 1
        rec = self._rec()
        if rec.enabled:
            rec.instant("preempt", "scheduler", self.now, pid=self.obs_pid,
                        args={"n_victims": needed})
            rec.count("preemptions", needed)

    def _start_job(self, job: Job) -> None:
        policy = job.policy
        if policy is None:
            policy = self.default_policy
            if self.controller is not None:
                # the provider hook: None = "no recommendation yet", so the
                # configured default serves until the controller has learned
                # one.  Aligned placement knows the serving class up front,
                # letting a class-aware provider pick a per-class policy.
                cls_hint = None
                if self.placement == "aligned":
                    cls = self._aligned_class(job)
                    if cls is not None:
                        cls_hint = self.classes[cls].name
                learned = self.controller.policy_for(job, machine_class=cls_hint)
                if learned is not None:
                    if _policy_plan(learned).klass is not None:
                        raise ValueError(
                            "policy providers cannot recommend OnClass "
                            "policies: admission already placed the job"
                        )
                    policy = learned
        plan = _policy_plan(policy)
        n = job.n_tasks
        durations = _host_quantile(job.dist, self.rng.random(n))
        rjob = _RunningJob(job, self.now, plan, durations)
        rjob.restrict = self._job_restrict(job)
        rjob.policy_label = policy.label() if hasattr(policy, "label") else "multifork"
        if self.placement == "aligned":
            cls = self._aligned_class(job)
            assert cls is not None, "admitted a job with no free gang block"
            rjob.home_class = cls
            self.reserved[cls] += n
        self.running[job.job_id] = rjob
        for i in range(n):
            self._launch_copy(rjob, i, float(durations[i]), fresh=False)
        if self.placement == "pooled":
            # aligned mode's home_class is the reservation ledger key and
            # stays authoritative; pooled mode derives it for reporting
            rjob.home_class = rjob.tasks[0].copies[0].cls
        rec = self._rec()
        if rec.enabled:
            rec.instant("admit", "scheduler", self.now, pid=self.obs_pid,
                        tid=job.job_id,
                        args={"n_tasks": n, "policy": rjob.policy_label,
                              "class": self.classes[rjob.home_class].name})
        # degenerate n=1 fork stages can trigger at 0 completions
        self._maybe_schedule_fork(rjob)

    # -------------------------------------------------------------- copies
    def _pick_class(self, rjob: _RunningJob) -> int:
        """Slot class for the next copy: the job's reservation (aligned) or
        the fastest class with a free slot (pooled)."""
        if self.placement == "aligned":
            assert self.free_by_class[rjob.home_class] > 0, "reservation over-committed"
            return rjob.home_class
        for i in self._class_order:
            if rjob.restrict is not None and i != rjob.restrict:
                continue
            if self.free_by_class[i] > 0:
                return i
        raise AssertionError("launch with no free slot")

    def _launch_copy(
        self, rjob: _RunningJob, task_id: int, duration: float, fresh: bool,
        attempts: int = 1,
    ):
        """Launch one copy; `duration` is the base execution draw, stretched
        by the slot's class speed (overheads folded in by the caller scale
        too: a slow machine is slow at forking as well).

        With task faults enabled the copy's fate is drawn NOW from the
        decorrelated fault RNG: under the q law it fails with probability q
        at what would have been its completion; under the fail-dist law a
        fail-time draw races the service draw and an early loss truncates
        the copy (partial work still billed)."""
        assert self.free > 0, "launch with no free slot"
        cls = self._pick_class(rjob)
        self.free_by_class[cls] -= 1
        busy = self.capacity - self.free - sum(self.down_by_class)
        self.max_busy = max(self.max_busy, busy)
        will_fail, run_for = False, duration
        if self.fault is not None and self.fault.task_faults:
            if self.fault.q > 0.0:
                will_fail = bool(self.fault_rng.random() < self.fault.q)
            else:
                f = float(_host_quantile(self.fault.fail_dist, self.fault_rng.random()))
                if f < duration:
                    will_fail, run_for = True, f
        wall = run_for / self.classes[cls].speed
        ev = self.heap.push(self.now + wall, "copy_done", (rjob.job.job_id, task_id))
        copy = _Copy(start=self.now, event=ev, fresh=fresh, cls=cls,
                     attempts=attempts, will_fail=will_fail)
        rjob.tasks[task_id].copies.append(copy)
        rjob.classes_used.add(cls)
        rjob.n_live += 1
        rjob.n_attempts += 1
        ev.data = (rjob.job.job_id, task_id, copy)
        if fresh:
            rjob.n_replicas += 1
        return copy

    def _bill_copy(self, rjob: _RunningJob, copy: _Copy) -> None:
        """Shared settle path: bill wall-clock since launch, free the slot."""
        copy.live = False
        elapsed = self.now - copy.start
        rjob.cost += elapsed
        rjob.n_live -= 1
        self.busy_time += elapsed
        self.busy_by_class[copy.cls] += elapsed
        self.free_by_class[copy.cls] += 1

    def _cancel_copy(self, rjob: _RunningJob, copy: _Copy) -> None:
        """Stop a running copy now: bill its runtime, free its slot."""
        if not copy.live:
            return
        self.heap.cancel(copy.event)
        self._bill_copy(rjob, copy)

    def _on_copy_done(self, ev: Event) -> None:
        job_id, task_id, copy = ev.data
        rjob = self.running.get(job_id)
        if rjob is None or not copy.live:
            return
        if copy.will_fail:
            # the attempt burned its slot and died; retry its lineage
            self._fail_copy(rjob, task_id, copy, crash=False)
            return
        task = rjob.tasks[task_id]
        assert not task.done, "finish event for a completed task survived"
        task.done = True
        # winner billed to now; siblings cancelled (their bill also to now)
        self._bill_copy(rjob, copy)
        for c in task.live_copies:
            self._cancel_copy(rjob, c)
        if task.retry_events:
            # backoff-pending relaunches of this task are moot now
            for rev in task.retry_events:
                self.heap.cancel(rev)
            task.retry_events.clear()
        rjob.n_done += 1
        if rjob.group_width is not None:
            rjob.group_done[task_id // rjob.group_width] += 1
        if self.controller is not None:
            # simulation knows the true original duration even when a
            # replica won (same telemetry the single-job executor reports);
            # tagged with the class that served the task's first copy
            self.controller.record_task_time(
                float(rjob.durations[task_id]),
                machine_class=self.classes[task.copies[0].cls].name,
            )
        self._maybe_schedule_fork(rjob)
        if rjob.n_done == rjob.job.n_tasks:
            self._finish_job(rjob)

    def _maybe_schedule_fork(self, rjob: _RunningJob) -> None:
        if rjob.group_width is not None:
            # (n, d) group selection: each d-task group forks independently
            # at its own local quantile threshold (single-stage by contract)
            if not rjob.stages:
                return
            kind, p, r, keep = rjob.stages[0]
            d = rjob.group_width
            thr = d - num_stragglers(d, p)
            for g in range(len(rjob.group_done)):
                if rjob.group_fired[g] or rjob.group_done[g] < thr:
                    continue
                rjob.group_fired[g] = True
                self.heap.push(
                    self.now + self.relaunch_delay, "fork", (rjob.job.job_id, 0, g)
                )
            return
        if rjob.fork_pending or rjob.next_stage >= len(rjob.stages):
            return
        kind, val, r, keep = rjob.stages[rjob.next_stage]
        if kind == "q":
            thr = rjob.job.n_tasks - num_stragglers(rjob.job.n_tasks, val)
            if rjob.n_done < thr:
                return
            when = self.now + self.relaunch_delay
        else:
            # wall-clock trigger: fires at t after job start even with no
            # completions; a late check (all stages due) still fires once
            when = max(self.now, rjob.t_start + val) + self.relaunch_delay
        rjob.fork_pending = True
        self.heap.push(when, "fork", (rjob.job.job_id, rjob.next_stage, None))

    def _on_fork(self, ev: Event) -> None:
        job_id, stage_idx, group = ev.data
        rjob = self.running.get(job_id)
        if rjob is None:
            return  # job finished during the relaunch delay
        if group is not None:
            d = rjob.group_width
            kind, val, r, keep = rjob.stages[0]
            stragglers = [
                i for i in range(group * d, (group + 1) * d) if not rjob.tasks[i].done
            ]
        else:
            if stage_idx != rjob.next_stage:
                return  # stale stage (a newer trigger superseded this one)
            kind, val, r, keep = rjob.stages[stage_idx]
            rjob.next_stage += 1
            rjob.fork_pending = False
            stragglers = [i for i, t in enumerate(rjob.tasks) if not t.done]
        rec = self._rec()
        if rec.enabled:
            rec.instant("fork", "scheduler", self.now, pid=self.obs_pid,
                        tid=job_id,
                        args={"stage": stage_idx, "r": r, "keep": keep,
                              "n_stragglers": len(stragglers)})
            rec.count("forks")
        want = r if keep else r + 1
        for i in stragglers:
            task = rjob.tasks[i]
            if not keep:
                for c in task.live_copies:
                    self._cancel_copy(rjob, c)
            if self.placement == "aligned":
                # replicas draw from the job's own gang reservation only —
                # capped by physically-up slots (a crash can temporarily
                # eat into reserved capacity; without faults the min() is
                # always the reservation remainder)
                budget = min(
                    rjob.job.n_tasks - rjob.n_live,
                    self.free_by_class[rjob.home_class],
                )
            elif rjob.restrict is not None:
                budget = self.free_by_class[rjob.restrict]
            else:
                budget = self.free
            n_fresh = min(want, budget)
            if n_fresh:
                fresh = _host_quantile(rjob.job.dist, self.rng.random(n_fresh))
                for dur in fresh:
                    self._launch_copy(rjob, i, float(dur) + self.fork_overhead, fresh=True)
            if not task.live_copies and not self._task_retry_pending(job_id, i, task):
                # killed with zero slots anywhere (can't happen: the kill
                # freed one) — guard so a task is never silently lost.  A
                # task whose lineage is in retry backoff is not lost.
                raise RuntimeError(f"task {i} of job {job_id} left with no copy")
        # a later stage may already be due (its threshold <= current n_done)
        self._maybe_schedule_fork(rjob)

    # ---------------------------------------------------------------- chaos
    def _schedule_chaos(self) -> None:
        """Seed the heap with the fault spec's machine-level events:
        deterministic outage windows up front, and the first crash of each
        (process × class) Poisson stream (renewed in `_on_machine_down`
        while work remains, so the heap still drains)."""
        f = self.fault
        if f.schedule is not None:
            for o in f.schedule.outages:
                cls = None if o.klass is None else self._class_index(o.klass)
                self.heap.push(o.time, "machine_down",
                               (cls, o.n_slots, o.duration, None))
        for pi, proc in enumerate(f.crashes):
            for ci, k in enumerate(self.classes):
                if proc.klass is not None and k.name != proc.klass:
                    continue
                gap = float(self.fault_rng.exponential(proc.mtbf / k.slots))
                self.heap.push(gap, "machine_down", (ci, proc.n_slots, None, pi))

    def _work_remaining(self) -> bool:
        return bool(
            self._arrivals_pending or self.running or self.queue
            or self._retry_waiting
        )

    def _on_machine_down(self, ev: Event) -> None:
        cls, n, duration, proc_idx = ev.data
        if duration is None:  # stochastic crash: repair time drawn now
            proc = self.fault.crashes[proc_idx]
            duration = float(self.fault_rng.exponential(proc.mttr))
        # an outage with no class pinned takes slots fastest-class-first
        targets = [cls] if cls is not None else list(self._class_order)
        remaining = n
        for ci in targets:
            if remaining <= 0:
                break
            avail = self.classes[ci].slots - self.down_by_class[ci]
            take = min(remaining, avail)
            if take > 0:
                self._take_down(ci, take, duration)
                remaining -= take
        if proc_idx is not None and self._work_remaining():
            proc = self.fault.crashes[proc_idx]
            gap = float(
                self.fault_rng.exponential(proc.mtbf / self.classes[cls].slots)
            )
            self.heap.push(self.now + gap, "machine_down",
                           (cls, proc.n_slots, None, proc_idx))

    def _take_down(self, ci: int, take: int, duration: float) -> None:
        """Take `take` slots of class ci down for `duration`: free slots go
        first; the shortfall kills the NEWEST running copies on the class
        (each through the failure/retry path), so the oldest work — most
        likely to be near completion — survives an outage."""
        need_kill = take - self.free_by_class[ci]
        if need_kill > 0:
            victims = []
            for rjob in self.running.values():
                for ti, task in enumerate(rjob.tasks):
                    for c in task.copies:
                        if c.live and c.cls == ci:
                            victims.append((c.start, c.event.seq, rjob, ti, c))
            victims.sort(key=lambda v: (v[0], v[1]), reverse=True)
            for _, _, rjob, ti, c in victims[:need_kill]:
                if c.live:  # a cascade (job failure) may have settled it
                    self._fail_copy(rjob, ti, c, crash=True)
        assert self.free_by_class[ci] >= take, "outage broke slot conservation"
        self.free_by_class[ci] -= take
        self.down_by_class[ci] += take
        self.down_time += take * duration
        self.repairs_by_class[ci].append(duration)
        self.heap.push(self.now + duration, "machine_up", (ci, take))
        rec = self._rec()
        if rec.enabled:
            rec.count("machines_down", take)
            rec.instant("machine_down", "scheduler", self.now, pid=self.obs_pid,
                        args={"class": self.classes[ci].name, "n_slots": take,
                              "mttr": round(duration, 6)})
            rec.counter_sample("slots_down", self.now,
                               sum(self.down_by_class), pid=self.obs_pid)

    def _on_machine_up(self, ev: Event) -> None:
        ci, n = ev.data
        self.down_by_class[ci] -= n
        self.free_by_class[ci] += n
        assert self.down_by_class[ci] >= 0, "repair exceeded downed slots"
        rec = self._rec()
        if rec.enabled:
            rec.count("machines_up", n)
            rec.counter_sample("slots_down", self.now,
                               sum(self.down_by_class), pid=self.obs_pid)

    # -------------------------------------------------------------- retries
    def _fail_copy(self, rjob: _RunningJob, task_id: int, copy: _Copy,
                   crash: bool) -> None:
        """One attempt died (task fault at completion, or crash kill now):
        bill its partial work, then either schedule its lineage's relaunch
        under the capped exponential backoff or — budget exhausted with no
        surviving sibling — fail the whole job."""
        if crash:
            self.heap.cancel(copy.event)  # its finish will never happen
        self._bill_copy(rjob, copy)
        self.n_task_failures += 1
        if crash:
            self.n_crash_kills += 1
        rec = self._rec()
        if rec.enabled:
            rec.count("task_failures")
            if crash:
                rec.count("crash_kills")
        if self.controller is not None and hasattr(
            self.controller, "record_task_failure"
        ):
            self.controller.record_task_failure(
                machine_class=self.classes[copy.cls].name
            )
        task = rjob.tasks[task_id]
        if task.done:
            return  # a sibling already finished the task; nothing to retry
        if copy.attempts < self.fault.max_attempts:
            delay = self.fault.attempt_delay(copy.attempts)
            rev = self.heap.push(
                self.now + delay, "retry",
                (rjob.job.job_id, task_id, copy.attempts + 1),
            )
            task.retry_events.append(rev)
            self.n_retries += 1
            if rec.enabled:
                rec.count("retries")
        elif not task.live_copies and not self._task_retry_pending(
            rjob.job.job_id, task_id, task
        ):
            self._fail_job(rjob, "max_attempts")

    def _task_retry_pending(self, job_id: int, task_id: int, task: _Task) -> bool:
        if task.retry_events:
            return True
        return any(w[0] == job_id and w[1] == task_id for w in self._retry_waiting)

    def _retry_slot_free(self, rjob: _RunningJob) -> bool:
        if self.placement == "aligned":
            return (
                rjob.n_live < rjob.job.n_tasks
                and self.free_by_class[rjob.home_class] > 0
            )
        if rjob.restrict is not None:
            return self.free_by_class[rjob.restrict] > 0
        return self.free > 0

    def _launch_retry(self, rjob: _RunningJob, task_id: int, attempts: int) -> None:
        # a fresh service draw from the fault RNG — the base stream stays
        # byte-identical with the no-fault run
        dur = float(_host_quantile(rjob.job.dist, self.fault_rng.random()))
        self._launch_copy(rjob, task_id, dur, fresh=False, attempts=attempts)

    def _on_retry(self, ev: Event) -> None:
        job_id, task_id, attempts = ev.data
        rjob = self.running.get(job_id)
        if rjob is None:
            return  # job finished or failed during the backoff
        task = rjob.tasks[task_id]
        try:
            task.retry_events.remove(ev)
        except ValueError:
            pass
        if task.done:
            return
        if self._retry_slot_free(rjob):
            self._launch_retry(rjob, task_id, attempts)
        else:
            # no slot (outage / full reservation): wait; drained ahead of
            # new admissions on every slot-freeing event
            self._retry_waiting.append((job_id, task_id, attempts))

    def _drain_retries(self) -> None:
        still = []
        for item in self._retry_waiting:
            job_id, task_id, attempts = item
            rjob = self.running.get(job_id)
            if rjob is None or rjob.tasks[task_id].done:
                continue
            if self._retry_slot_free(rjob):
                self._launch_retry(rjob, task_id, attempts)
            else:
                still.append(item)
        self._retry_waiting = still

    # -------------------------------------------- degradation (shed/timeout)
    def _should_shed(self, job: Job) -> bool:
        """Shed when the estimated gang-occupancy ρ̂ — arrival rate ×
        mean service time × mean gang width over surviving weighted slots —
        exceeds `shed_rho`.  Needs 8 arrivals and 8 completions of history;
        priorities below `shed_min_priority` are never shed."""
        if job.priority < self.shed_min_priority:
            return False
        if len(self._arrival_times) < 8 or self._done_jobs < 8:
            return False
        span = self._arrival_times[-1] - self._arrival_times[0]
        if span <= 0:
            return False
        lam_hat = (len(self._arrival_times) - 1) / span
        mean_svc = self._svc_sum / self._done_jobs
        mean_gang = self._ntask_sum / self._done_jobs
        surviving = sum(
            (k.slots - self.down_by_class[i]) * k.speed
            for i, k in enumerate(self.classes)
        )
        if surviving <= 0:
            return True
        return lam_hat * mean_svc * mean_gang / surviving > self.shed_rho

    def _shed_job(self, job: Job) -> None:
        self.n_shed += 1
        self._record_unstarted(job, "shed")
        rec = self._rec()
        if rec.enabled:
            rec.count("jobs_shed")
            rec.instant("shed", "scheduler", self.now, pid=self.obs_pid,
                        tid=job.job_id)

    def _on_deadline(self, ev: Event) -> None:
        job = ev.data
        rjob = self.running.get(job.job_id)
        if rjob is not None:
            self.n_timeouts += 1
            self._fail_job(rjob, "timeout")
            return
        for i, queued in enumerate(self.queue):
            if queued.job_id == job.job_id:
                del self.queue[i]
                self.n_timeouts += 1
                self._record_unstarted(job, "timeout")
                return
        # already terminal (completed, failed, or shed) — nothing to kill

    def _record_unstarted(self, job: Job, reason: str) -> None:
        """Terminal record for a job killed before any copy launched."""
        record = JobRecord(
            job_id=job.job_id,
            arrival=job.arrival,
            start=self.now,
            finish=self.now,
            n_tasks=job.n_tasks,
            cost=0.0,
            n_replicas=0,
            n_preempted=0,
            policy="-",
            machine_class="unplaced",
            n_attempts=0,
            failed=True,
            failure=reason,
        )
        self.records.append(record)
        self.n_failed += 1
        rec = self._rec()
        if rec.enabled:
            rec.count("jobs_failed")
        if self.controller is not None:
            self.controller.record_job_complete(
                n_tasks=job.n_tasks, machine_class="unplaced", now=self.now
            )
        if self.job_done_hook is not None:
            self.job_done_hook(record)

    def _fail_job(self, rjob: _RunningJob, reason: str) -> None:
        """Terminal failure of a running job: settle every live copy and
        pending retry, release the reservation, record `failed`."""
        job = rjob.job
        for task in rjob.tasks:
            for c in task.live_copies:
                self._cancel_copy(rjob, c)
            if task.retry_events:
                for rev in task.retry_events:
                    self.heap.cancel(rev)
                task.retry_events.clear()
        if self._retry_waiting:
            self._retry_waiting = [
                w for w in self._retry_waiting if w[0] != job.job_id
            ]
        del self.running[job.job_id]
        if self.placement == "aligned":
            self.reserved[rjob.home_class] -= job.n_tasks
        cls_name = ("mixed" if len(rjob.classes_used) > 1
                    else self.classes[rjob.home_class].name)
        record = JobRecord(
            job_id=job.job_id,
            arrival=job.arrival,
            start=rjob.t_start,
            finish=self.now,
            n_tasks=job.n_tasks,
            cost=rjob.cost / job.n_tasks,
            n_replicas=rjob.n_replicas,
            n_preempted=rjob.n_preempted,
            policy=getattr(rjob, "policy_label", "?"),
            machine_class=cls_name,
            n_attempts=rjob.n_attempts,
            failed=True,
            failure=reason,
        )
        self.records.append(record)
        self.n_failed += 1
        rec = self._rec()
        if rec.enabled:
            rec.count("jobs_failed")
            rec.instant("job_failed", "scheduler", self.now, pid=self.obs_pid,
                        tid=job.job_id, args={"reason": reason,
                                              "n_attempts": rjob.n_attempts})
        if self.controller is not None:
            self.controller.record_job_complete(
                n_tasks=job.n_tasks, machine_class=cls_name, now=self.now
            )
        if self.job_done_hook is not None:
            self.job_done_hook(record)

    # --------------------------------------------------------------- finish
    def _finish_job(self, rjob: _RunningJob) -> None:
        job = rjob.job
        del self.running[job.job_id]
        if self.placement == "aligned":
            self.reserved[rjob.home_class] -= job.n_tasks
        # pooled placement may scatter a job's copies across classes: such a
        # job belongs to no single class and is attributed to "mixed" so
        # per-class job shares still sum to 1 (metrics asserts this)
        if len(rjob.classes_used) > 1:
            cls_name = "mixed"
        else:
            cls_name = self.classes[rjob.home_class].name
        rec = JobRecord(
            job_id=job.job_id,
            arrival=job.arrival,
            start=rjob.t_start,
            finish=self.now,
            n_tasks=job.n_tasks,
            cost=rjob.cost / job.n_tasks,
            n_replicas=rjob.n_replicas,
            n_preempted=rjob.n_preempted,
            policy=getattr(rjob, "policy_label", "?"),
            machine_class=cls_name,
            n_attempts=rjob.n_attempts,
        )
        self.records.append(rec)
        if self.shed_rho is not None:
            self._svc_sum += rec.service
            self._ntask_sum += job.n_tasks
            self._done_jobs += 1
        trec = self._rec()
        if trec.enabled:
            # the job-lifecycle spans: "job" is the parent (arrival→finish),
            # "queue" + "service" nest inside it and telescope exactly to
            # the sojourn — the trace IS the latency decomposition
            tid = job.job_id
            args = {"n_tasks": job.n_tasks, "policy": rec.policy,
                    "cost": round(rec.cost, 6), "n_replicas": rec.n_replicas,
                    "class": cls_name}
            trec.span("job", "scheduler", rec.arrival, rec.sojourn,
                      pid=self.obs_pid, tid=tid, args=args)
            if rec.wait > 0:
                trec.span("queue", "scheduler", rec.arrival, rec.wait,
                          pid=self.obs_pid, tid=tid)
            trec.span("service", "scheduler", rec.start, rec.service,
                      pid=self.obs_pid, tid=tid)
            trec.count("jobs_completed")
            trec.count("replicas_launched", rec.n_replicas)
        if self.controller is not None:
            # sojourn rides along so providers can attribute the finished
            # job's latency to its machine class (straggler blame)
            self.controller.record_job_complete(
                n_tasks=job.n_tasks, machine_class=cls_name, now=self.now,
                sojourn=rec.sojourn,
            )
        if self.job_done_hook is not None:
            # barrier hook: the DAG driver releases successor stages here
            self.job_done_hook(rec)
