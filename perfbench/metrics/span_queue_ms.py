"""span_queue_ms: device ms a query of the operations launched inside the
program's `queue` section (`batched_queue`: the kw_queue kernel, or the
Lindley recursion at c = 1)."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from bench import spans  # noqa: E402

WRAPS = ()
spans.install()


def read(view):
    return spans.device_ms(view, ("queue",))
