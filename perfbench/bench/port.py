"""The system under test: the port's planner entry for a cell, called with
the inputs the benchmark made and nothing else."""

from __future__ import annotations


def _policy(spec):
    from repro_torch.core import MultiForkPolicy, SingleForkPolicy, delayed_relaunch

    (kind, val), = spec.items()
    if kind == "single":
        return SingleForkPolicy(float(val[0]), int(val[1]), bool(val[2]))
    if kind == "delayed":
        return delayed_relaunch(float(val[0]), r=int(val[1]), keep=bool(val[2]))
    if kind == "multi":
        return MultiForkPolicy(tuple((float(p), int(r), bool(k)) for p, r, k in val))
    raise ValueError(f"unknown policy kind {kind!r}")


def entry(model, device):
    """`query(seed) -> rows`: one call of `repro_torch.fleet.vector.frontier`
    on the cell's whole grid, exact tails, its rows on the host when it
    returns."""
    from repro_torch.fleet import vector

    policies = [_policy(p) for p in model.policies]

    def query(seed):
        return vector.frontier(model.samples, policies, model.lams, model.n, model.n_jobs,
                               m_trials=model.m_trials, seed=seed, c=model.c, tail="exact", device=device)
    return query
