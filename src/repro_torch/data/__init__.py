"""Task execution-time traces (a copy of `repro.data.traces`, numpy only)."""

from .traces import STAGE_TRACES, TRACE_JOBS, load_stage_trace, load_trace, synthesize_trace  # noqa: F401
