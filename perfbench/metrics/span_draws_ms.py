"""span_draws_ms: device ms a query of the operations launched inside the
program's `evaluator.draws` section: the shared draws (`fork_draws` /
`policy_draws` / `retry_draws`) and their running minimum, once a query
whatever the number of cells."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from bench import spans  # noqa: E402

WRAPS = ()
spans.install()


def read(view):
    return spans.device_ms(view, ("evaluator.draws",))
