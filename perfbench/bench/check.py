"""The comparison that decides `correct`: the program's outputs of a sampled
query against the plain reference on the same inputs, at three layers.

* `T_gap`, `C_gap`: the evaluator's per-cell (T, C) of every job, the
  largest relative gap;
* `queue_gap`: the queue's finish of every job, the largest gap over the
  mean T of its cell;
* `rows_gap`: the rows' statistics, the largest relative gap over every
  key of every cell.

Each number is held to its limit from the traffic file; `PERF.md` gives
the readings each limit was set from.
"""

from __future__ import annotations

import math

import torch

from . import reference

NUMBERS = ("T_gap", "C_gap", "queue_gap", "rows_gap")


def _rel_max(got, want) -> float:
    g, w = got.double(), want.double()
    return float(((g - w).abs() / w.abs().clamp(min=1e-30)).max())


def gaps(rows: list, tc, fin, ref: dict) -> dict:
    """The four numbers for one query: `rows` the program's rows, `tc` its
    (T, C), `fin` its queue finishes (None where it kept none), `ref`
    `reference.query`'s result on the same query."""
    inf = dict.fromkeys(NUMBERS, math.inf)
    if tc is None or fin is None or len(rows) != len(ref["rows"]):
        return inf
    (T, C), Tr = tc, ref["T"]
    if T.shape != Tr.shape or C.shape != Tr.shape or fin.shape != ref["fin"].shape:
        return inf
    scale = Tr.double().mean(dim=(1, 2))[:, None, None]
    out = dict(T_gap=_rel_max(T, Tr), C_gap=_rel_max(C, ref["C"]),
               queue_gap=float(((fin.double() - ref["fin"].double()).abs() / scale).max()), rows_gap=0.0)
    for got, want in zip(rows, ref["rows"]):
        for k in reference.ROW_KEYS:
            a, b = got.get(k), want[k]
            out["rows_gap"] = max(out["rows_gap"], math.inf if a is None else abs(a - b) / max(abs(b), 1e-30))
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}


def finite_rows(rows: list) -> bool:
    return all(math.isfinite(v) for row in rows for v in row.values() if isinstance(v, float))


def worst(readings: list) -> dict:
    """The largest reading of each number over the checked queries."""
    return {k: max((r[k] for r in readings), default=math.inf) for k in NUMBERS}


def held(values: dict, limits: dict) -> bool:
    return all(values[k] <= limits[k] for k in NUMBERS)


def program_outputs(captured: dict) -> tuple:
    """(T, C) and the queue's finishes of one query, from what the hooks
    kept: None where a capture point did not fire exactly once."""
    tc, queue = captured.get("tc", []), captured.get("queue", [])
    return (tuple(tc[0]) if len(tc) == 1 else None), (queue[0][1] if len(queue) == 1 else None)


def free(captured: dict) -> None:
    captured.clear()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
