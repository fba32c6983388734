"""span_eval_chunks_ms: device ms a query of the operations launched inside
the program's `evaluator.chunk` sections: each chunk's evaluation of its
cells on the shared draws (`_masked_cells` or `lowered_eval_cells`)."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from bench import spans  # noqa: E402

WRAPS = ()
spans.install()


def read(view):
    return spans.device_ms(view, ("evaluator.chunk",))
