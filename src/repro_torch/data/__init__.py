"""Task execution-time traces (a copy of `repro.data.traces`, numpy only) and
the synthetic token pipeline (`repro.data.pipeline`, in PyTorch)."""

from .pipeline import SyntheticTokenPipeline, make_batch_specs  # noqa: F401
from .traces import STAGE_TRACES, TRACE_JOBS, load_stage_trace, load_trace, synthesize_trace  # noqa: F401
