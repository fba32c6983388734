"""kw_queue_roofline_pct: the kw_queue kernels' share of their byte bound.

Bytes come from the shapes at the queue layer's boundary (`batched_queue`'s
arrivals and speeds), counted by `bench.peaks.kw_queue_bytes` for each call
that takes the kernel (c > 1 or `kernel=True`).  Time is the device time of
the kernels that the program's `csrc/kw_queue.cu` defines.  Nothing to read
(no such kernel ran): None."""

import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from bench import peaks  # noqa: E402

LAYER = "queue"
WRAPS = (("repro_torch.fleet.vector", "batched_queue"),)


def _shape_of_call(name, args, kwargs):
    """(rows, jobs, c, takes the kernel) of one queue call, or None."""
    if name != "batched_queue" or len(args) < 3:
        return None
    rows, c = args[0], args[2][0]
    kernel = bool(args[3]) if len(args) > 3 else bool(kwargs.get("kernel", False))
    J = rows[-1]
    B = 1
    for d in rows[:-1]:
        B *= d
    return B, J, c, kernel or c > 1


def read(view):
    names = view.kernel_names("csrc/kw_queue.cu")
    pat = re.compile(r"\b(" + "|".join(map(re.escape, names)) + r")\b") if names else None
    secs = sum(s for op, s in view.op_seconds().items() if pat is not None and pat.search(op))
    total = 0
    for layer, name, args, kwargs in view.calls:
        call = _shape_of_call(name, args, kwargs)
        if layer == LAYER and call is not None and call[3]:
            total += peaks.kw_queue_bytes(*call[:3])
    if secs <= 0 or total <= 0:
        return None
    return 100.0 * peaks.bound_s(total) / secs
