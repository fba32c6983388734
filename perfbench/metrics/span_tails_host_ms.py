"""span_tails_host_ms: host ms a query of the program's `tails` section
(`_tail_keys`: the exact tails' percentile sort and its copy to the
host), by the host clock."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from bench import spans  # noqa: E402

WRAPS = ()
spans.install()


def _tails_ms(q):
    return 1e3 * sum(s.dur for s in q["tails"])


def read(view):
    return spans.per_query(view, _tails_ms)
