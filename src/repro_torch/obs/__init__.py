"""Observability, ported so far: the streaming quantile sketch
(`sketch.QuantileSketch`) that `runtime.serving.HedgedServer` keeps its
latency tails in.  The rest of `repro.obs` is ROADMAP Queue 1 items 1
and 6."""

from .sketch import QuantileSketch, merge_all  # noqa: F401
