"""Vectorized fleet rollouts: the fused latency–cost frontier engine in PyTorch.

Counterpart of `repro.fleet.vector`.  In the gang-aligned regime (capacity
c·n task slots split into c gang blocks) a fleet is a FIFO G/G/c queue
whose per-job service time is the single-job makespan T(π) and whose
per-job cost is C(π).  The engine evaluates a whole (λ × π [× q]) grid on
one shared set of common-random-number draws:

  draws → single-job (T, C) per law → queue per (cell, trial) → stats

(T, C) does not depend on λ: the cells of one lowered policy row (and q)
share a law (`cell_laws`), evaluated once on the draws and gathered to its
cells on the device.

  * `masked_single_fork` evaluates single-fork cells with a dynamic fork
    point (k, r, keep enter as per-cell tensors, not shapes);
    `core.simulate.lowered_eval_cells` evaluates any other lowered policy;
    on a card the engine's laws go through the CUDA kernel
    `kernels.single_job` instead, where n and S fit it (`fused_path`);
  * `batched_queue` runs every (cell, trial) queue: c > 1 (or
    `kernel=True`) through the CUDA Kiefer–Wolfowitz kernel
    `kernels.kw_queue`, c = 1 through the closed-form `lindley`;
  * `trace_kill_rollout` draws π_kill residuals through the CUDA kernel
    `kernels.residual_sampler` (eq. (7): F̄_Y = F̄_X^{r+1}).

Where JAX fused the vmap over cells under XLA, this module writes the cell
axis out and evaluates laws in chunks sized to a fixed memory budget
(`CELL_CHUNK_BYTES`), all over the ONE shared draw set; the chunk size does
not change any result.  Cell padding (`pad_cells`) existed in JAX only to
avoid recompiles: the port evaluates only the real cells and keeps the
argument for signature parity.  `r_cap` still sets the fresh-draw width,
so it changes the random stream exactly as in the reference.

Every entry point takes `seed` in place of JAX's `key` and `device=None`
(the card; pass `device="cpu"` for the plain PyTorch path).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from functools import partial
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.distributions import Distribution, Empirical
from ..core.policy import SingleForkPolicy, lower_policies, num_stragglers
from ..core.simulate import (
    _cell,
    _masked_cells,
    lowered_eval_cells,
    policy_draws,
    running_min,
    single_fork_batch,
)
from ..device import generator as _generator
from ..device import resolve_device
from ..kernels.kw_queue import kw_queue as kw_queue_kernel
from ..kernels.kw_queue import kw_queue_plain
from ..kernels.residual_sampler import residual_sample
from ..kernels.single_job import fits as single_job_fits
from ..kernels.single_job import single_job
from ..obs.device import DEFAULT_HIST, HistSpec, cell_histograms, sketch_from_device
from ..obs.evtail import evt_keys
from ..obs.trace import get_recorder
from .workload import MachineClass

__all__ = [
    "VectorFleetResult",
    "as_quantile_source",
    "batched_queue",
    "cell_bucket",
    "emp_quantile",
    "fleet_rollout",
    "fork_draws",
    "frontier",
    "kw_queue",
    "lindley",
    "masked_single_fork",
    "policy_search",
    "retry_draws",
    "retry_transform",
    "sweep",
    "sweep_loop",
    "trace_kill_rollout",
]

#: device memory one chunk of laws may take for its single-job evaluation
CELL_CHUNK_BYTES = 4 << 30

@dataclasses.dataclass
class VectorFleetResult:
    sojourn: torch.Tensor  # (m_trials, n_jobs)
    wait: torch.Tensor  # (m_trials, n_jobs)
    service: torch.Tensor  # (m_trials, n_jobs) per-job T (slot-speed scaled)
    cost: torch.Tensor  # (m_trials, n_jobs) per-job C (slot-speed scaled)
    utilization: torch.Tensor  # (m_trials,)
    slot: Optional[torch.Tensor] = None  # (m_trials, n_jobs) serving job slot
    class_utilization: Optional[torch.Tensor] = None  # (m_trials, n_classes)
    class_names: Optional[tuple] = None

    @property
    def mean_sojourn(self) -> float:
        return float(self.sojourn.mean())

    @property
    def mean_wait(self) -> float:
        return float(self.wait.mean())

    @property
    def mean_service(self) -> float:
        return float(self.service.mean())

    @property
    def mean_cost(self) -> float:
        return float(self.cost.mean())

    @property
    def sojourn_std_err(self) -> float:
        """Std error over per-trial means (trials are independent)."""
        per_trial = self.sojourn.mean(dim=1)
        m = per_trial.shape[0]
        return float(per_trial.std(correction=0) / math.sqrt(max(m - 1, 1)))

    def percentile(self, q: float) -> float:
        return float(np.percentile(self.sojourn.cpu().numpy(), q))

    def summary(self) -> dict:
        per_trial = self.sojourn.mean(dim=1)
        m = per_trial.shape[0]
        vals = torch.stack(
            [
                self.sojourn.mean(),
                self.wait.mean(),
                self.service.mean(),
                self.cost.mean(),
                self.utilization.mean(),
                per_trial.std(correction=0) / math.sqrt(max(m - 1, 1)),
            ]
        ).cpu().numpy()
        pcts = exact_percentiles(self.sojourn.reshape(1, -1))[:, 0]
        out = dict(zip(_SUMMARY_KEYS, (float(v) for v in (*vals[:5], *pcts, vals[5]))))
        if self.class_utilization is not None and self.class_names is not None:
            per_class = self.class_utilization.mean(dim=0).cpu().numpy()
            for name, u in zip(self.class_names, per_class):
                out[f"util_{name}"] = float(u)
        return out


_SUMMARY_KEYS = (
    "mean_sojourn",
    "mean_wait",
    "mean_service",
    "mean_cost",
    "utilization",
    "p50",
    "p99",
    "p999",
    "sojourn_std_err",
)


def lindley(arrivals, services):
    """Gang-serial (c = 1) queue: start_j = max(arrival_j, finish_{j-1}),
    in closed form — finish_j = P_j + max_{k<=j}(A_k - P_{k-1}) with P the
    service prefix sum — over the last axis.  Returns (starts, finishes)."""
    csum = torch.cumsum(services, dim=-1)
    finishes = csum + torch.cummax(arrivals - (csum - services), dim=-1).values
    return finishes - services, finishes


def kw_queue(arrivals, services, speeds):
    """Kiefer–Wolfowitz FIFO G/G/c recursion with per-slot speeds for ONE
    queue, as a plain per-job loop (the reference's `lax.scan`).  Job j
    takes the fastest slot idle at its arrival, else the earliest-freeing
    slot (ties toward lower index).  The engine never calls it: batches of
    queues go through `batched_queue`.  Returns (starts, finishes,
    scaled_services, slots), each (n_jobs,)."""
    outs = kw_queue_plain(arrivals[None], services[None], speeds)
    return tuple(z[0] for z in outs)


def _queue_stats(arrivals, services, costs, n):
    """c = 1 stats over a (trials, jobs) batch."""
    starts, finishes = lindley(arrivals, services)
    sojourn = finishes - arrivals
    wait = starts - arrivals
    makespan = finishes[..., -1] - arrivals[..., 0]
    util = costs.sum(dim=-1) * n / (n * torch.clamp(makespan, min=1e-12))
    return sojourn, wait, util


def _kw_stats(arrivals, starts, finishes, svc, slots, costs, speeds, slot_class, class_slots, n):
    """Per-trial G/G/c stats from an already-run queue, over (trials, jobs):
    a job's (T, C) stretch by its slot's speed, utilization aggregates busy
    copy-seconds per class.  The per-slot sums are float atomics on CUDA,
    so `class_utilization` may vary in its last bits from run to run."""
    sojourn = finishes - arrivals
    wait = starts - arrivals
    sl = slots.long()
    cost = costs / speeds[sl]
    makespan = finishes.amax(dim=-1) - arrivals[..., 0]
    denom = torch.clamp(makespan, min=1e-12)
    busy = cost * n
    c = speeds.shape[0]
    slot_busy = torch.zeros(busy.shape[:-1] + (c,), device=busy.device).scatter_add_(-1, sl, busy)
    class_busy = torch.zeros(
        busy.shape[:-1] + class_slots.shape, device=busy.device
    ).index_add_(-1, slot_class.long(), slot_busy)
    util = busy.sum(dim=-1) / (c * n * denom)
    class_util = class_busy / (class_slots * denom[..., None])
    return sojourn, wait, svc, cost, util, slots, class_util


def _queue_kw_batch(arrivals, T, C, speeds, slot_class, class_slots, n, kernel=False):
    """Queue every trial of already-sampled (T, C) through `batched_queue`."""
    starts, fins, svc, slots = batched_queue(arrivals, T, speeds, kernel=kernel)
    return _kw_stats(arrivals, starts, fins, svc, slots, C, speeds, slot_class, class_slots, n)


@functools.lru_cache(maxsize=256)
def _slot_arrays_cached(n: int, c: Optional[int], classes: Optional[tuple]):
    if classes is None:
        if c is None or c == 1:
            return None
        if c < 1:
            raise ValueError("c (job slots) must be >= 1")
        return (
            torch.ones((c,)),
            torch.zeros((c,), dtype=torch.int32),
            torch.tensor([float(c * n)]),
            ("default",),
        )
    ordered = sorted(classes, key=lambda k: -k.speed)  # stable on ties
    speeds, slot_class, class_slots = [], [], []
    for i, k in enumerate(ordered):
        if k.slots % n:
            raise ValueError(
                f"class {k.name!r}: slots={k.slots} must be a multiple of "
                f"n_tasks={n} for the gang-aligned fast path"
            )
        speeds += [k.speed] * (k.slots // n)
        slot_class += [i] * (k.slots // n)
        class_slots.append(float(k.slots))
    if c is not None and c != len(speeds):
        raise ValueError(f"c={c} disagrees with classes providing {len(speeds)} job slots")
    if not speeds:
        raise ValueError("classes provide no job slots")
    return (
        torch.tensor(speeds, dtype=torch.float32),
        torch.tensor(slot_class, dtype=torch.int32),
        torch.tensor(class_slots, dtype=torch.float32),
        tuple(k.name for k in ordered),
    )


def _slot_arrays(n: int, c: Optional[int], classes: Optional[Sequence[MachineClass]], device):
    """Resolve (c, classes) into per-job-slot arrays for the KW recursion:
    (speeds, slot_class, class_slots, names) with job slots ordered fastest
    first, on `device` — or None when the plain c=1 Lindley path applies.
    The geometry is cached on the hashable (n, c, classes)."""
    if classes is not None:
        classes = tuple(classes)
    slot = _slot_arrays_cached(n, c, classes)
    if slot is None:
        return None
    return tuple(z.to(device) for z in slot[:3]) + (slot[3],)


def _c1_slot_arrays(n: int, device):
    """One unit-speed gang block: the geometry policy_search/frontier use
    when no c / classes are given."""
    return (
        torch.ones((1,), device=device),
        torch.zeros((1,), dtype=torch.int32, device=device),
        torch.tensor([float(n)], device=device),
        ("default",),
    )


def _arrivals(generator, shape):
    """Unit-rate Poisson arrival times (cumsum of Exp(1) gaps) over `shape`."""
    gaps = torch.empty(shape, device=generator.device).exponential_(generator=generator)
    return torch.cumsum(gaps, dim=-1)


def fleet_rollout(
    dist: Distribution,
    policy: SingleForkPolicy,
    lam: float,
    n: int,
    n_jobs: int,
    m_trials: int = 32,
    seed: int = 0,
    c: Optional[int] = None,
    classes: Optional[Sequence[MachineClass]] = None,
    kernel: bool = False,
    device=None,
) -> VectorFleetResult:
    """m_trials independent fleets of n_jobs Poisson(λ) arrivals.

    `c` is the number of concurrent gang blocks (capacity = c·n slots);
    `classes` optionally splits capacity into heterogeneous pools.  c=1
    without classes takes the closed-form Lindley path; anything else runs
    the Kiefer–Wolfowitz queue (`batched_queue`); `kernel=True` routes the
    c=1 case through the queue kernel too.
    """
    if lam <= 0:
        raise ValueError("arrival rate lam must be > 0")
    dev = resolve_device(device)
    g = _generator(seed, dev)
    arrivals = _arrivals(g, (m_trials, n_jobs)) / lam
    s = num_stragglers(n, policy.p)
    T, C = single_fork_batch(g, dist, n, s, policy.r, policy.keep, shape=(m_trials, n_jobs))
    slot = _slot_arrays(n, c, classes, dev)
    if slot is None and kernel:
        slot = _c1_slot_arrays(n, dev)
    if slot is None:
        sojourn, wait, util = _queue_stats(arrivals, T, C, n)
        return VectorFleetResult(sojourn=sojourn, wait=wait, service=T, cost=C, utilization=util)
    speeds, slot_class, class_slots, names = slot
    sojourn, wait, T, C, util, slots, class_util = _queue_kw_batch(
        arrivals, T, C, speeds, slot_class, class_slots, n, kernel=kernel
    )
    return VectorFleetResult(
        sojourn=sojourn, wait=wait, service=T, cost=C, utilization=util, slot=slots,
        class_utilization=class_util, class_names=names,
    )


# --------------------------------------------------------------------------
# fused frontier engine: (λ × π) cross-products on one shared draw set
# --------------------------------------------------------------------------


def emp_quantile(xs, u):
    """Inverse-transform gather through the sorted empirical sample (type-1
    inverse, identical to `core.distributions.Empirical.quantile`)."""
    m = xs.shape[0]
    idx = torch.clamp(torch.ceil(u * m).to(torch.int32) - 1, 0, m - 1)
    return xs[idx]


def batched_queue(arrivals, services, speeds, kernel: bool = False):
    """FIFO G/G/c queues over any batch: each (..., n_jobs) row is one queue
    with `speeds.shape[0]` job slots.  c > 1, or `kernel=True`, runs every
    row through ONE call of the Kiefer–Wolfowitz kernel (`kernels.kw_queue`:
    CUDA on a card, its plain version on the CPU); c = 1 otherwise is the
    closed-form Lindley recursion.  Returns (starts, finishes,
    scaled_services, slots), each with the input shape.  Rows must be in
    arrival (FIFO) order."""
    batch = arrivals.shape[:-1]
    J = arrivals.shape[-1]
    c = speeds.shape[0]
    queued = kernel or c > 1
    rec = get_recorder()
    with rec.section("queue", "engine", rows=math.prod(batch), jobs=J, c=c,
                     path="kw_queue" if queued else "lindley"):
        if queued:
            outs = kw_queue_kernel(
                arrivals.reshape(-1, J).contiguous(),
                services.reshape(-1, J).contiguous(),
                speeds.contiguous(),
            )
            return tuple(z.reshape(batch + (J,)) for z in outs)
        svc = services / speeds[0]
        starts, fins = lindley(arrivals, svc)
        return starts, fins, svc, torch.zeros(arrivals.shape, dtype=torch.int32, device=arrivals.device)


def masked_single_fork(x_sorted, fresh, k, r, keep):
    """Single-fork (T, C) with a *dynamic* fork point (Definitions 1–2).

    `x_sorted`: (..., n) sorted original task-time draws; `fresh`:
    (..., n, r_cap) fresh replica draws with r_cap >= r+1.  k = n - s, r
    and keep are 0-d tensors (or ints/bools) for one cell, or (C,) tensors
    for C cells on the same draws, which adds a leading C dimension to the
    result.  Stragglers are selected by an `iota >= k` mask and the fresh
    columns by a gather into the running min over the replica axis.
    Returns (T, C) with the batch shape of x_sorted[..., 0].
    """
    dev = x_sorted.device
    k, r = (torch.as_tensor(v, dtype=torch.int32, device=dev) for v in (k, r))
    keep = torch.as_tensor(keep, dtype=torch.bool, device=dev)
    one = k.ndim == 0
    k, r, keep = (v.reshape(-1) for v in (k, r, keep))
    cm = running_min(fresh)
    T, C = _masked_cells(x_sorted[None], cm[None], k, r, keep)
    return (T[0], C[0]) if one else (T, C)


def retry_draws(generator, quantile, shape, attempts: int):
    """Shared-CRN draw pair for the geometric-retry transform: per logical
    draw, `attempts` candidate service times and `attempts-1` fate
    uniforms.  They carry no q, so a (λ × q × π) grid shares ONE pair."""
    dev = generator.device
    x = quantile(torch.rand(tuple(shape) + (attempts,), generator=generator, device=dev))
    v = torch.rand(tuple(shape) + (attempts - 1,), generator=generator, device=dev)
    return x, v


def retry_transform(x, v, q):
    """Effective busy time of a copy under the q failure law: attempt k+1
    runs iff attempts 1..k all failed (v < q each), so the duration is
    x[..., 0] + Σ_k alive_k · x[..., k+1] with alive = cumprod(v < q).
    `q` is a float or a tensor that broadcasts against v (a leading cell
    dimension gives one result per cell).  `alive` is the running product
    of the 0/1 failure flags, taken as attempts - 2 elementwise products:
    exact, so the values of `torch.cumprod`, whose scan along this short
    last axis took 85% of a full-width DAG fault grid's device time on the
    card (PERF.md, PR 15)."""
    fail = (v < q).to(x.dtype)
    alive = torch.empty_like(fail)
    alive[..., 0] = fail[..., 0]
    for j in range(1, fail.shape[-1]):
        torch.mul(alive[..., j - 1], fail[..., j], out=alive[..., j])
    return x[..., 0] + (alive * x[..., 1:]).sum(dim=-1)


def fork_draws(generator, quantile, shape, n: int, r_cap: int):
    """The common-random-number draw pair `masked_single_fork` consumes:
    (x_sorted: shape+(n,), fresh: shape+(n, r_cap)).  `quantile` is an
    analytic distribution's `.quantile` or `partial(emp_quantile, xs)`."""
    dev = generator.device
    x_sorted = torch.sort(
        quantile(torch.rand(tuple(shape) + (n,), generator=generator, device=dev)), dim=-1
    ).values
    fresh = quantile(torch.rand(tuple(shape) + (n, r_cap), generator=generator, device=dev))
    return x_sorted, fresh


#: stats computed per cell, in stack order; the percentile keys are added
#: host-side from the returned sojourns
_FRONTIER_KEYS = (
    "mean_sojourn",
    "mean_wait",
    "mean_service",
    "mean_cost",
    "utilization",
    "sojourn_std_err",
    "rho",
    "rho_work",
    "rho_block",
)


def _chunks(n_cells: int, chunk: int):
    for i in range(0, n_cells, chunk):
        yield slice(i, min(i + chunk, n_cells))


def fused_path(device, n: int, n_stages: int) -> bool:
    """Whether `cell_tc` evaluates its laws with the single-job kernel
    (`kernels.single_job`): on a card, where it takes n tasks and n_stages
    stages (`single_job.fits`), at any group width.  Otherwise the PyTorch
    chains run (`_masked_cells`, `lowered_eval_cells`)."""
    return torch.device(device).type == "cuda" and single_job_fits(n, n_stages)


def cell_chunk_size(m_trials, n_jobs, n, r_cap, n_stages, general, attempts=None, device="cpu") -> int:
    """Laws per chunk under `CELL_CHUNK_BYTES`, from what each law of a
    chunk allocates on the path that evaluates it on `device`
    (`fused_path`): the (law, trial, job, task) intermediates of the
    PyTorch chains or, on the single-job kernel, its (T, C); with
    `attempts`, each law's retry-transformed draws besides."""
    fused = fused_path(device, n, n_stages if general else 1)
    elems = m_trials * n_jobs * n
    if fused:
        per_cell = m_trials * n_jobs * 4 * 2
    elif general:
        # argsorts and permutations are int64; cohorts grow per stage
        per_cell = elems * (4 * (12 + 4 * n_stages + 2 * r_cap) + 8 * 4)
    else:
        per_cell = elems * 4 * (8 + 2 * r_cap)
    if attempts is not None:
        per_cell += elems * 4 * attempts * (1 + r_cap * n_stages)
    return max(1, CELL_CHUNK_BYTES // per_cell)


def _cell_stats(arrivals, T, C, lams, speeds, slot_class, class_slots, n, kernel):
    """Queue every (cell, trial) and reduce each cell to its stats row.

    arrivals, T, C: (cells, m, J).  Returns (stats (cells, 9 + classes),
    sojourn (cells, m, J), cost (cells, m, J) scaled by each job's slot
    speed)."""
    c = speeds.shape[0]
    starts, fins, svc, slots = batched_queue(arrivals, T, speeds, kernel=kernel)
    soj = fins - arrivals
    wait = starts - arrivals
    sl = slots.long()
    cost = C / speeds[sl]
    makespan = fins.amax(dim=-1) - arrivals[..., 0]  # (cells, m)
    denom = torch.clamp(makespan, min=1e-12)
    busy = cost * n  # copy-seconds per job (Definition 2)
    total_busy = busy.sum(dim=-1)
    util = (total_busy / (c * n * denom)).mean(dim=-1)
    if c == 1:
        class_util = (total_busy[..., None] / (class_slots * denom[..., None])).mean(dim=1)
    else:
        # float atomics on CUDA: util_<class> varies in its last bits
        slot_busy = torch.zeros(busy.shape[:-1] + (c,), device=busy.device).scatter_add_(-1, sl, busy)
        class_busy = torch.zeros(
            busy.shape[:-1] + class_slots.shape, device=busy.device
        ).index_add_(-1, slot_class.long(), slot_busy)
        class_util = (class_busy / (class_slots * denom[..., None])).mean(dim=1)
    per_trial = soj.mean(dim=-1)
    m = per_trial.shape[1]
    # rho_work: copy-seconds offered vs served; rho_block: gang-block
    # occupancy, the bound that governs the aligned/KW queue
    rho_work = lams * C.mean(dim=(1, 2)) / speeds.sum()
    rho_block = lams * T.mean(dim=(1, 2)) / speeds.sum()
    base = torch.stack(
        [
            soj.mean(dim=(1, 2)),
            wait.mean(dim=(1, 2)),
            svc.mean(dim=(1, 2)),
            cost.mean(dim=(1, 2)),
            util,
            per_trial.std(dim=1, correction=0) / math.sqrt(max(m - 1, 1)),
            torch.maximum(rho_work, rho_block),
            rho_work,
            rho_block,
        ],
        dim=1,
    )
    return torch.cat([base, class_util], dim=1), soj, cost


def cell_tc(g, quantile, pol, qs, shape, n, r_cap, n_stages, attempts, chunk, law_of_cell=None):
    """Single-job (T, C) of every cell, each (cells, *shape), on ONE shared
    draw set taken from the generator `g` (the reference's per-cell vmap).

    `pol` is (modes, ks, ts, rs, keeps, ds) of lowered (laws, S) tensors,
    one row a distinct single-job law, with modes None for a grid wholly in
    the single-stage-quantile / full-width domain, which takes the
    single-fork evaluator — the host-side program selection of the
    reference — and ts and ds None there.
    `qs` (one per law, with the retry-draw width `attempts`) runs every
    draw through the geometric-retry transform with its law's q before the
    evaluator; None takes the fault-free programs.
    `law_of_cell` (cells,) gives each cell's law (`cell_laws`); None means
    every cell is its own law.  The draws do not depend on the laws; each
    law is evaluated once on them, `chunk` laws at a time (None: as many as
    `cell_chunk_size` allows), which changes no result, and each cell takes
    its law's (T, C).  The frontier draws once per grid; the DAG engine
    once per stage.  On a card, where n and n_stages fit (`fused_path`),
    each chunk is one launch of the single-job kernel
    (`kernels.single_job`) on the same draws; elsewhere the chains run.
    With a recorder enabled it records the sections `evaluator` (args
    `cells`, `laws`), `evaluator.draws` and one `evaluator.chunk` a chunk
    (its `cells` are the laws it evaluates, its `path` "fused", "masked" or
    "lowered"), and adds the laws it evaluates to the counter
    `evaluator.cells`."""
    modes, ks, ts, rs, keeps, ds = pol
    n_laws = ks.shape[0]
    single = modes is None
    S = 1 if single else n_stages
    fused = fused_path(g.device, n, S)
    if chunk is None:
        chunk = cell_chunk_size(shape[0], math.prod(shape[1:]), n, r_cap, S, not single,
                                attempts if qs is not None else None, g.device)
    rec = get_recorder()
    rec.count("evaluator.cells", n_laws)
    if fused:
        # the single-fork program is one quantile stage at full width
        stages = (torch.zeros_like(ks)[:, None], ks[:, None], torch.full((n_laws, 1), math.inf, device=ks.device),
                  rs[:, None], keeps[:, None], torch.full_like(ks, n)) if single else pol
        path = "fused"
    else:
        path = "masked" if single else "lowered"
    n_cells = n_laws if law_of_cell is None else law_of_cell.shape[0]
    with rec.section("evaluator", "engine", cells=n_cells, laws=n_laws):
        with rec.section("evaluator.draws", "engine"):
            if qs is None:
                if single:
                    x, fresh = fork_draws(g, quantile, shape, n, r_cap)
                else:
                    x, fresh = policy_draws(g, quantile, shape, n, r_cap, n_stages)
                cm = running_min(fresh)[None]
                x = x[None]
                del fresh
            else:
                fresh_shape = tuple(shape) + ((n, r_cap) if single else (n_stages, n, r_cap))
                xr, xv = retry_draws(g, quantile, tuple(shape) + (n,), attempts)
                fr, fv = retry_draws(g, quantile, fresh_shape, attempts)
        parts = []
        for sl in _chunks(n_laws, chunk):
            with rec.section("evaluator.chunk", "engine", cells=sl.stop - sl.start, path=path):
                if qs is not None:
                    x = retry_transform(xr, xv, _cell(qs[sl], xv.ndim + 1))
                    cm = running_min(retry_transform(fr, fv, _cell(qs[sl], fv.ndim + 1)))
                    if single and not fused:  # the kernel sorts each law's draws itself
                        x = torch.sort(x, dim=-1).values
                if fused:
                    parts.append(single_job(x, cm.unsqueeze(-3) if single else cm, *(v[sl] for v in stages),
                                            ranked=single and qs is None))
                elif single:
                    parts.append(_masked_cells(x, cm, ks[sl], rs[sl], keeps[sl]))
                else:
                    parts.append(
                        lowered_eval_cells(x, cm, modes[sl], ks[sl], ts[sl], rs[sl], keeps[sl], ds[sl])
                    )
        T, C = torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
        if law_of_cell is not None:
            T, C = T.index_select(0, law_of_cell), C.index_select(0, law_of_cell)
        return T, C


def _frontier_cells(
    g, xs, pol, lams, qs, law_of_cell, speeds, slot_class, class_slots, dist, n, n_jobs, m_trials,
    r_cap, n_stages, attempts, kernel, chunk,
):
    """Every (policy, λ [, q]) cell on one shared set of draws (the
    reference's `_frontier_jit`, or `_frontier_faulty_jit` when `qs` is
    given): the draws, then the arrivals, from the one generator `g`.
    Returns the stats rows on the host (section `stats`), and the
    sojourns and costs where they lie."""
    quantile = dist.quantile if dist is not None else partial(emp_quantile, xs)
    shape = (m_trials, n_jobs)
    T, C = cell_tc(g, quantile, pol, qs, shape, n, r_cap, n_stages, attempts, chunk, law_of_cell)
    with get_recorder().section("stats", "engine"):
        arrivals = _arrivals(g, shape)[None] / lams[:, None, None]
        stats, soj, cost = _cell_stats(arrivals, T, C, lams, speeds, slot_class, class_slots, n, kernel)
        return stats.cpu().numpy(), soj, cost  # waits for the device


def as_quantile_source(dist_or_samples, device=None):
    """Normalize the frontier's first argument: (analytic_dist | None, xs).

    Analytic distributions enter through their quantile transform;
    `Empirical` instances and raw sample arrays through the empirical
    gather over the sorted float32 samples `xs` on `device`."""
    dev = resolve_device(device)
    if isinstance(dist_or_samples, Empirical):
        return None, dist_or_samples.sorted.to(dev)
    if isinstance(dist_or_samples, Distribution):
        return dist_or_samples, torch.zeros((1,), device=dev)
    samples = dist_or_samples
    if not torch.is_tensor(samples):
        samples = torch.as_tensor(np.asarray(samples))
    xs = torch.sort(samples.to(device=dev, dtype=torch.float32).reshape(-1)).values
    if xs.shape[0] < 2:
        raise ValueError("need at least 2 samples to drive the empirical path")
    return None, xs


def cell_bucket(n_cells: int) -> int:
    """Next power-of-two bucket (>= 8), the reference's compile-sharing pad
    size.  The port evaluates only the real cells and never pads."""
    b = 8
    while b < n_cells:
        b *= 2
    return b


def _hist_spec(tail) -> Optional[HistSpec]:
    """`tail` as the histogram layout of the hist path (None: exact)."""
    if isinstance(tail, HistSpec):
        return tail
    if tail == "exact":
        return None
    if tail == "hist":
        return DEFAULT_HIST
    raise ValueError(f'tail must be "exact", "hist", or a HistSpec, got {tail!r}')


def exact_percentiles(rows, qs=(50.0, 99.0, 99.9)) -> np.ndarray:
    """`np.percentile`'s linear rule over each row of `rows` (rows, N):
    the rows sorted where they lie, the two order statistics around
    q·(N-1) brought to the host and interpolated there with numpy's own
    arithmetic, so the keys equal `np.percentile`'s bit for bit.  The
    reference brings every sojourn to the host and calls `np.percentile`
    there; sorting where the rows lie moves two numbers a key instead.
    Returns (len(qs), rows)."""
    n = rows.shape[-1]
    pos = np.asarray(qs, dtype=np.float64) / 100.0 * (n - 1)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, n - 1)
    idx = torch.as_tensor(np.concatenate([lo, hi]), device=rows.device)
    picked = torch.sort(rows, dim=-1).values[:, idx].cpu().numpy().T
    a, b, t = picked[: len(qs)], picked[len(qs):], (pos - lo)[:, None]
    diff = b - a  # in the rows' dtype, then float64 with t: numpy's `_lerp`
    return np.where(t >= 0.5, b - diff * (1.0 - t), a + diff * t)


def _tail_keys(soj, cost, hist):
    """The percentile keys of every cell from its (cells, m, J) sojourns and
    costs: (pcts (3, cells), cost_pcts, evt rows).  Exact: `np.percentile`'s
    rule over each cell's sojourns (`exact_percentiles`; cost_pcts and evt
    None).  Hist:
    both are counted into γ-bucket histograms on the device and only
    (n_bins + 3) numbers per cell reach the host; the sketches rebuilt there
    give the quantiles and the EVT tail keys (`obs.evtail.evt_keys`)."""
    n_cells = soj.shape[0]
    if hist is None:
        return exact_percentiles(soj.reshape(n_cells, -1)), None, None
    s_counts, s_agg, c_counts, c_agg = (
        z.cpu().numpy() for pair in (cell_histograms(soj, hist), cell_histograms(cost, hist)) for z in pair
    )
    pcts = np.empty((3, n_cells))
    cost_pcts = np.empty((3, n_cells))
    cell_evt = []
    for i in range(n_cells):
        sk = sketch_from_device(s_counts[i], *s_agg[i], spec=hist)
        pcts[:, i] = sk.quantiles((0.5, 0.99, 0.999))
        # the sketch carries the whole tail shape, so each row also gets a
        # GPD fitted on its exceedance buckets (evt_xi / evt_p999 /
        # evt_p9999), past what the m·J sample resolves
        cell_evt.append(evt_keys(sk))
        ck = sketch_from_device(c_counts[i], *c_agg[i], spec=hist)
        cost_pcts[:, i] = ck.quantiles((0.5, 0.99, 0.999))
    return pcts, cost_pcts, cell_evt


def cell_laws(lowered, cell_qs=None):
    """Group a grid's cells by their single-job (T, C) law: its distinct
    lowered policy rows, with q on the faulty path, each keyed by its bit
    pattern (the float columns and q as float32 bits).  (T, C) does not
    depend on λ, so cells that differ only in λ share a law.  Returns
    (reps, law_of_cell): the first cell of each law, in order of first
    appearance, and each cell's law as an int64 array, or None where no law
    repeats (every cell is its own law)."""
    cols = [lowered.mode, lowered.k, lowered.t.view(np.int32), lowered.r,
            lowered.keep.astype(np.int32), lowered.d[:, None]]
    if cell_qs is not None:
        cols.append(np.asarray(cell_qs, dtype=np.float32).view(np.int32)[:, None])
    rows = np.ascontiguousarray(np.concatenate(cols, axis=1))
    keys = rows.view(np.dtype((np.void, rows.itemsize * rows.shape[1]))).reshape(-1)
    _, first, inverse = np.unique(keys, return_index=True, return_inverse=True)
    if first.size == keys.size:
        return np.arange(keys.size), None
    order = np.argsort(first)
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    return first[order], rank[inverse.reshape(-1)]


def _law_tensors(lowered, cell_qs, general, device):
    """What `cell_tc` takes for a grid's distinct laws (`cell_laws`):
    (pol, qs, law_of_cell) on `device`.  `pol` holds the lowered rows of the
    laws (the single-fork program's (k, r, keep) columns unless `general`),
    `qs` each law's q (None off the faulty path), `law_of_cell` each cell's
    law (None where no law repeats)."""
    reps, law_of_cell = cell_laws(lowered, cell_qs)

    def t(v):
        return torch.as_tensor(v, device=device)

    if general:
        pol = tuple(t(v[reps]) for v in (lowered.mode, lowered.k, lowered.t, lowered.r, lowered.keep, lowered.d))
    else:
        pol = (None, t(lowered.k[reps, 0]), None, t(lowered.r[reps, 0]), t(lowered.keep[reps, 0]), None)
    qs = None
    if cell_qs is not None:
        qs = torch.tensor([float(cell_qs[i]) for i in reps], dtype=torch.float32, device=device)
    return pol, qs, None if law_of_cell is None else t(law_of_cell)


def _eval_cells(
    dist_or_samples,
    cell_policies: Sequence,
    cell_lams: Sequence[float],
    n: int,
    n_jobs: int,
    m_trials: int,
    seed: int,
    c: Optional[int],
    classes: Optional[Sequence[MachineClass]],
    kernel: bool,
    r_cap: Optional[int],
    pad_cells: bool,
    tail="exact",
    cell_qs: Optional[Sequence[float]] = None,
    attempts: Optional[int] = None,
    device=None,
    cell_chunk: Optional[int] = None,
) -> list[dict]:
    """Shared engine behind `frontier` and `policy_search`: one stats dict
    per (policy, λ) cell, all cells on one shared draw set.  `cell_qs` (one
    per cell, with the retry-draw width `attempts`) routes the grid through
    the faulty program.  Each distinct (T, C) law of the grid (`cell_laws`)
    is evaluated once; `cell_chunk` sets the laws evaluated together
    (default: as many as `CELL_CHUNK_BYTES` allows); it changes no result.
    `pad_cells` is the reference's compile-sharing pad and is ignored: only
    the real cells are evaluated.  `tail="exact"` computes the percentile
    keys from a sort on the rows' device (`exact_percentiles`, bit-equal
    to the reference's host-side `np.percentile`); `tail="hist"` (or a
    `HistSpec`) from histograms counted on the device, and adds the
    cost_p* and evt_* keys.

    With a recorder enabled (`obs.enable()`), each call is one root section
    `frontier_dispatch` (args `cells`, `laws`, `m_trials`, `n_jobs`, `tail`,
    `chunk`) up to its last row, holding `frontier.prepare` and
    `frontier.rows` (cat "host"), `evaluator` (`cell_tc`), `stats` (with
    `batched_queue`'s `queue`) and `tails`; it adds its cells to the
    counter `frontier.cells` and its distinct (T, C) laws to
    `evaluator.laws` (the evaluator adds the laws it evaluates to
    `evaluator.cells`)."""
    rec = get_recorder()
    dev = resolve_device(device)
    with rec.section("frontier_dispatch", "engine", root=True, cells=len(cell_policies),
                     m_trials=m_trials, n_jobs=n_jobs) as root:
        with rec.section("frontier.prepare", "host"):
            if not cell_policies:
                raise ValueError("need at least one candidate policy")
            if any(lam <= 0 for lam in cell_lams):
                raise ValueError("arrival rate lam must be > 0")
            hist = _hist_spec(tail)
            dist, xs = as_quantile_source(dist_or_samples, dev)
            slot = _slot_arrays(n, c, classes, dev)
            speeds, slot_class, class_slots, names = slot if slot is not None else _c1_slot_arrays(n, dev)

            n_cells = len(cell_policies)
            lowered = lower_policies(list(cell_policies), n)
            if any(name is not None for name in lowered.class_names):
                raise ValueError(
                    "class-restricted (OnClass) placement changes queue geometry, "
                    "not the single-job law — model the class mix via `classes=`"
                )
            r_max = lowered.r_max
            if r_cap is None:
                r_cap = r_max + 1
            elif r_cap < r_max + 1:
                raise ValueError(f"r_cap={r_cap} < r_max+1={r_max + 1}")
            if (lowered.k < 0).any() or (lowered.k > n).any() or (lowered.r < 0).any():
                raise ValueError("lowered fork indices must lie in [0, n] and replica counts >= 0")
            lams = torch.tensor([float(lam) for lam in cell_lams], dtype=torch.float32, device=dev)
            if cell_qs is not None:
                if len(cell_qs) != n_cells:
                    raise ValueError("need one q per cell")
                if attempts is None or attempts < 1:
                    raise ValueError("cell_qs needs attempts >= 1")
            # grids wholly in the single-stage-quantile/full-width domain take the
            # single-fork evaluator; anything else the general lowered evaluator
            general = lowered.multi_stage or lowered.has_time or lowered.has_group
            # each distinct (T, C) law is evaluated once; cells take theirs
            pol, qs, law_of_cell = _law_tensors(lowered, cell_qs, general, dev)
            if cell_chunk is None:
                cell_chunk = cell_chunk_size(
                    m_trials, n_jobs, n, r_cap, lowered.n_stages, general, attempts if cell_qs else None, dev
                )
            if rec.enabled:
                n_laws = pol[1].shape[0]
                root.note(tail="exact" if hist is None else "hist", chunk=cell_chunk, laws=n_laws)
                rec.count("frontier.cells", n_cells)
                rec.count("evaluator.laws", n_laws)
        stats, soj, cost = _frontier_cells(
            _generator(seed, dev), xs, pol, lams, qs, law_of_cell, speeds, slot_class, class_slots, dist,
            n, n_jobs, m_trials, r_cap, lowered.n_stages, attempts, kernel, cell_chunk,
        )
        with rec.section("tails", "engine"):
            pcts, cost_pcts, cell_evt = _tail_keys(soj, cost, hist)
        with rec.section("frontier.rows", "host"):
            rows = []
            nk = len(_FRONTIER_KEYS)
            for i, (pol_i, lam) in enumerate(zip(cell_policies, cell_lams)):
                row = stats[i]
                d = dict(lam=float(lam), policy=pol_i.label(),
                         **dict(zip(_FRONTIER_KEYS, map(float, row[:nk]))))
                if cell_qs is not None:
                    d["q"] = float(cell_qs[i])
                d["p50"], d["p99"], d["p999"] = (float(pcts[j, i]) for j in range(3))
                if hist is not None:
                    d["cost_p50"], d["cost_p99"], d["cost_p999"] = (float(cost_pcts[j, i]) for j in range(3))
                    d.update(cell_evt[i])
                if slot is not None:  # mirror VectorFleetResult.summary(): per-class util
                    for name, u in zip(names, row[nk:]):
                        d[f"util_{name}"] = float(u)
                rows.append(d)
    return rows


def _fault_qs(fault):
    """Normalize `frontier`'s fault argument to (qs, attempts): one
    `FaultSpec` or a sequence of them, q law with immediate relaunch only."""
    from ..faults.model import FaultSpec

    specs = [fault] if isinstance(fault, FaultSpec) else list(fault)
    if not specs:
        raise ValueError("need at least one FaultSpec")
    qs = []
    attempts = None
    for f in specs:
        if not isinstance(f, FaultSpec):
            raise TypeError(f"fault entries must be FaultSpec, got {type(f)}")
        if f.fail_dist is not None:
            raise ValueError(
                "the fused engines model the q failure law only; fail_dist "
                "runs exactly on the event engine"
            )
        if f.machine_faults:
            raise ValueError(
                "machine crashes run exactly on the event engine; for a fused "
                "grid fold the crash hazard into q via "
                "repro_torch.faults.effective_fail_prob"
            )
        if f.backoff_base != 0.0:
            raise ValueError(
                "the fused retry transform models immediate relaunch "
                "(backoff_base == 0); nonzero backoff runs on the event engine"
            )
        if attempts is None:
            attempts = f.max_attempts
        elif f.max_attempts != attempts:
            raise ValueError(
                "all FaultSpecs in one fused grid must share max_attempts "
                "(it is the retry-draw width)"
            )
        qs.append(float(f.q))
    return qs, attempts


def frontier(
    dist_or_samples,
    policies: Sequence,
    lams,
    n: int,
    n_jobs: int,
    m_trials: int = 32,
    seed: int = 0,
    c: Optional[int] = None,
    classes: Optional[Sequence[MachineClass]] = None,
    kernel: bool = False,
    r_cap: Optional[int] = None,
    pad_cells: bool = True,
    tail="exact",
    fault=None,
    device=None,
) -> list[dict]:
    """Latency–cost frontier: the whole (policy × λ) cross-product on one
    shared set of common-random-number draws.

    `dist_or_samples` is an analytic `Distribution`, an `Empirical`, or a
    raw sample array.  Rows come back policy-major: the `_SUMMARY_KEYS`
    plus `rho` / `rho_work` / `rho_block` and per-class `util_*` when c > 1
    or classes are given.  `policies` may mix any algebra families.
    `r_cap` pins the fresh-draw width (and so the random stream);
    `pad_cells` is accepted for parity and changes nothing; `kernel=True`
    sends the c = 1 queue through the queue kernel as well.

    `fault` — a `FaultSpec` or a sequence of them — adds a q axis: cells =
    policies × λs × faults (q fastest) and rows gain a "q" key.  A single
    disabled spec (q=0) takes the fault-free program, so its rows equal
    fault=None bit for bit.  `tail="hist"` (or an `obs.HistSpec`) takes
    the percentile keys from histograms counted on the device and adds
    cost_p50/cost_p99/cost_p999 and the EVT keys evt_xi/evt_p999/evt_p9999.
    """
    policies = list(policies)
    lams = [float(lam) for lam in lams]
    if not lams:
        raise ValueError("need at least one arrival rate")
    cell_policies = [pol for pol in policies for _ in lams]
    cell_lams = lams * len(policies)
    cell_qs = attempts = None
    if fault is not None:
        qs, attempts = _fault_qs(fault)
        if len(qs) == 1 and qs[0] == 0.0:
            rows = _eval_cells(
                dist_or_samples, cell_policies, cell_lams, n, n_jobs, m_trials,
                seed, c, classes, kernel, r_cap, pad_cells, tail=tail, device=device,
            )
            for row in rows:
                row["q"] = 0.0
            return rows
        cell_policies = [pol for pol in cell_policies for _ in qs]
        cell_lams = [lam for lam in cell_lams for _ in qs]
        cell_qs = qs * (len(policies) * len(lams))
    return _eval_cells(
        dist_or_samples, cell_policies, cell_lams, n, n_jobs, m_trials, seed,
        c, classes, kernel, r_cap, pad_cells, tail=tail,
        cell_qs=cell_qs, attempts=attempts, device=device,
    )


def sweep(
    dist: Distribution,
    policies,
    lams,
    n: int,
    n_jobs: int,
    m_trials: int = 32,
    seed: int = 0,
    c: Optional[int] = None,
    classes: Optional[Sequence[MachineClass]] = None,
    kernel: bool = False,
    device=None,
) -> list[dict]:
    """Load × policy frontier, one summary row per (λ, π) cell: a thin
    wrapper over `frontier`."""
    return frontier(
        dist, policies, lams, n, n_jobs, m_trials, seed=seed, c=c, classes=classes,
        kernel=kernel, device=device,
    )


def sweep_loop(
    dist: Distribution,
    policies,
    lams,
    n: int,
    n_jobs: int,
    m_trials: int = 32,
    seed: int = 0,
    c: Optional[int] = None,
    classes: Optional[Sequence[MachineClass]] = None,
    device=None,
) -> list[dict]:
    """Per-cell sweep: one `fleet_rollout` per (λ, π) cell, the baseline the
    fused `frontier` is checked against.  One seed per λ, shared by every
    policy at that λ (common random numbers at fixed load)."""
    lams = list(lams)
    lam_seeds = [int(s) for s in np.random.SeedSequence(seed).generate_state(len(lams))]
    rows = []
    for policy in policies:
        for lam, lam_seed in zip(lams, lam_seeds):
            res = fleet_rollout(
                dist, policy, lam, n, n_jobs, m_trials, seed=lam_seed, c=c,
                classes=classes, device=device,
            )
            rows.append(dict(lam=float(lam), policy=policy.label(), **res.summary()))
    return rows


# --------------------------------------------------------------------------
# fused empirical policy search: the adaptive controller's inner loop
# --------------------------------------------------------------------------


def policy_search(
    samples,
    candidates: Sequence,
    lam: float,
    n: int,
    n_jobs: int = 192,
    m_trials: int = 8,
    seed: int = 0,
    c: Optional[int] = None,
    classes: Optional[Sequence[MachineClass]] = None,
    kernel: bool = False,
    r_cap: Optional[int] = None,
    pad_candidates: bool = True,
    tail="exact",
    fault=None,
    device=None,
) -> list[dict]:
    """Score candidate policies on an empirical trace at an estimated load.

    Per-job (T, C) under each candidate are bootstrap-resampled from
    `samples` and pushed through the G/G/c queue at rate `lam`, so a policy
    is judged by its fleet sojourn.  It is the frontier engine at one λ,
    over shared draws.  Returns one dict per candidate: the policy, its
    label, the frontier keys.  `fault` (one `FaultSpec`, q law) scores the
    candidates under the geometric-retry transform.
    """
    if lam <= 0:
        raise ValueError("arrival rate lam must be > 0")
    candidates = list(candidates)
    cell_qs = attempts = None
    if fault is not None:
        qs, attempts = _fault_qs(fault)
        if len(qs) != 1:
            raise ValueError("policy_search takes a single FaultSpec")
        if qs[0] == 0.0:
            cell_qs = attempts = None
        else:
            cell_qs = qs * len(candidates)
    rows = _eval_cells(
        samples, candidates, [float(lam)] * len(candidates), n, n_jobs, m_trials,
        seed, c, classes, kernel, r_cap, pad_candidates, tail=tail,
        cell_qs=cell_qs, attempts=attempts, device=device,
    )
    out = []
    for pol, row in zip(candidates, rows):
        row.pop("policy", None)
        row.pop("lam", None)
        out.append(dict(policy=pol, label=pol.label(), **row))
    return out


# --------------------------------------------------------------------------
# trace-driven π_kill path through the residual sampler kernel
# --------------------------------------------------------------------------


def trace_kill_rollout(
    samples,
    policy: SingleForkPolicy,
    lam: float,
    n: int,
    n_jobs: int,
    m_trials: int = 32,
    seed: int = 0,
    c: Optional[int] = None,
    classes: Optional[Sequence[MachineClass]] = None,
    kernel: bool = False,
    device=None,
) -> VectorFleetResult:
    """Fleet rollout where task times bootstrap an empirical trace, π_kill.

    Original draws are the empirical inverse-transform gather; the
    straggler residuals (min over r+1 fresh draws, eq. (7)) run through
    `kernels.residual_sampler` — one call of shape (m_trials·n_jobs, s, r+1)
    covers the whole fleet.  The queue runs as in `fleet_rollout`.
    """
    if policy.keep and not policy.is_baseline:
        raise ValueError("the residual-sampler fast path models π_kill only")
    if lam <= 0:
        raise ValueError("arrival rate lam must be > 0")
    dev = resolve_device(device)
    g = _generator(seed, dev)

    emp = Empirical(samples)
    xs = emp.sorted.to(dev)
    s = num_stragglers(n, policy.p)
    r = policy.r
    M = m_trials * n_jobs

    u0 = torch.rand((M, n), generator=g, device=dev)
    x_sorted = torch.sort(emp_quantile(xs, u0), dim=1).values
    if s == 0:  # baseline: no residual phase, nothing for the kernel to do
        T = x_sorted[:, -1].reshape(m_trials, n_jobs)
        C = (x_sorted.sum(dim=1) / n).reshape(m_trials, n_jobs)
    else:
        k = n - s
        t1 = x_sorted[:, k - 1]
        iota = torch.arange(n, device=dev)
        c1 = torch.where(iota[None, :] < k, x_sorted, 0.0).sum(dim=1) + s * t1
        u = torch.rand((M, s, r + 1), generator=g, device=dev)
        max_y, sum_y = residual_sample(u, xs)
        T = (t1 + max_y).reshape(m_trials, n_jobs)
        C = ((c1 + (r + 1) * sum_y) / n).reshape(m_trials, n_jobs)

    arrivals = _arrivals(g, (m_trials, n_jobs)) / lam
    slot = _slot_arrays(n, c, classes, dev)
    if slot is None and kernel:
        slot = _c1_slot_arrays(n, dev)
    if slot is None:
        sojourn, wait, util = _queue_stats(arrivals, T, C, n)
        return VectorFleetResult(sojourn=sojourn, wait=wait, service=T, cost=C, utilization=util)
    speeds, slot_class, class_slots, names = slot
    sojourn, wait, T, C, util, slots, class_util = _queue_kw_batch(
        arrivals, T, C, speeds, slot_class, class_slots, n, kernel=kernel
    )
    return VectorFleetResult(
        sojourn=sojourn, wait=wait, service=T, cost=C, utilization=util, slot=slots,
        class_utilization=class_util, class_names=names,
    )
