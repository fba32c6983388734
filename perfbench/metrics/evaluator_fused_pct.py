"""evaluator_fused_pct: the share of the laws the evaluator evaluates that
the single-job kernel evaluates: 100 x the `cells` of a query's
`evaluator.chunk` sections whose `path` is "fused" (one launch of
`repro_torch.kernels.single_job` each) over the `cells` of all its
`evaluator.chunk` sections.  A query whose laws all go through the kernel
reads 100; one whose laws all run on the PyTorch chains ("masked",
"lowered") reads 0.  A program that records no such sections reads
nothing."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from bench import spans  # noqa: E402

WRAPS = ()
spans.install()


def _pct(q):
    chunks = q["evaluator.chunk"]
    fused = sum(s.args["cells"] for s in chunks if s.args.get("path") == "fused")
    return 100.0 * fused / sum(s.args["cells"] for s in chunks)


def read(view):
    return spans.per_query(view, _pct)
