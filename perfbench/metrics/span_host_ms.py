"""span_host_ms: host ms a query of the program's sections of cat "host"
(`frontier.prepare`: the checks, the inputs and the policies' lowering
and copy to the device; `frontier.rows`: the rows built on the host),
by the host clock."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from bench import spans  # noqa: E402

WRAPS = ()
spans.install()


def _host_ms(q):
    return 1e3 * sum(s.dur for group in q.values() for s in group if s.cat == "host")


def read(view):
    return spans.per_query(view, _host_ms)
