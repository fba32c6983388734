"""evaluator_distinct_pct: the share of the cells the evaluator evaluates
that are distinct single-job (T, C) laws: 100 x the `laws` of each
query's `frontier_dispatch` root (what the program adds to its counter
`evaluator.laws`) over the `cells` of the query's `evaluator.chunk`
sections (what the evaluator adds to `evaluator.cells`).  (T, C) does not
depend on the load, so the rest is the evaluator run again; an evaluator
that runs each law once reads 100."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from bench import spans  # noqa: E402

WRAPS = ()
spans.install()


def _pct(q):
    (root,) = q["frontier_dispatch"]
    return 100.0 * root.args["laws"] / sum(s.args["cells"] for s in q["evaluator.chunk"])


def read(view):
    return spans.per_query(view, _pct)
