"""span_stats_ms: device ms a query of the operations launched inside the
program's `stats` section (the arrivals, `_cell_stats` and the stats' copy
to the host) but not its `queue` section, and inside its `tails` section
(`_tail_keys`)."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from bench import spans  # noqa: E402

WRAPS = ()
spans.install()


def read(view):
    return spans.device_ms(view, ("stats", "tails"), less=("queue",))
