"""span_evaluator_ms: device ms a query of the operations launched inside
the program's `evaluator` section (`cell_tc`: the draws, the running
minimum and every chunk's evaluation), from the profiler's trace."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from bench import spans  # noqa: E402

WRAPS = ()
spans.install()


def read(view):
    return spans.device_ms(view, ("evaluator",))
