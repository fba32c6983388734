"""repro_torch.obs — observability for the port: every module of
`repro.obs`.

  * `sketch`    — mergeable streaming quantile sketch (numpy copy);
  * `registry`  — counters / gauges / sketch-backed histograms with labels
    (copy);
  * `trace`     — span recorder + NullRecorder, the process-wide recorder;
    `export` renders Chrome trace-event JSON for Perfetto (copies; a file
    written by either package loads in the other);
  * `decisions` — the adaptive controller's decision log (copy);
  * `device`    — γ-bucket histograms counted on the device for the fused
    engines' `tail="hist"` path (PyTorch);
  * `profile`   — wall time with CUDA events, device time by kernel from
    torch.profiler and peak device memory of one call (PyTorch);
  * `evtail`    — peaks-over-threshold GPD tails fitted on sketch buckets
    (numpy copy);
  * `slo`       — SLO objects + multi-window error-budget burn rates (copy);
  * `blame`     — per-class straggler attribution (copy);
  * `dashboard` — single-file HTML / terminal report over all of it (copy).
"""

from .blame import BlameScore, StragglerBlame  # noqa: F401
from .decisions import (  # noqa: F401
    KIND_BLAME,
    KIND_DRIFT,
    KIND_EXPLORE,
    KIND_REPLAN,
    KIND_VETO,
    DecisionEvent,
    DecisionLog,
)
from .dashboard import render_dashboard, render_text, write_dashboard  # noqa: F401
from .device import (  # noqa: F401
    DEFAULT_HIST,
    HistSpec,
    cell_histograms,
    device_histogram,
    sketch_from_device,
)
from .evtail import (  # noqa: F401
    EVTail,
    GPDFit,
    domain_of_fit,
    evt_keys,
    fit_gpd,
    gpd_params_of,
)
from .export import load_chrome_trace, to_chrome_trace, write_chrome_trace  # noqa: F401
from .profile import kernel_profile  # noqa: F401
from .registry import Counter, Gauge, Histogram, MetricsRegistry  # noqa: F401
from .sketch import QuantileSketch, merge_all  # noqa: F401
from .slo import SLO, SLOTracker, WindowedSketch, trackers_for  # noqa: F401
from .trace import (  # noqa: F401
    NULL_RECORDER,
    PID_CONTROLLER,
    PID_DAG_BASE,
    PID_FLEET,
    PID_PROFILER,
    PID_SERVING,
    NullRecorder,
    Recorder,
    disable,
    enable,
    get_recorder,
    resolve_recorder,
)

__all__ = [
    "QuantileSketch", "merge_all",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "Recorder", "NullRecorder", "NULL_RECORDER",
    "enable", "disable", "get_recorder", "resolve_recorder",
    "PID_FLEET", "PID_CONTROLLER", "PID_SERVING", "PID_PROFILER",
    "PID_DAG_BASE",
    "DecisionEvent", "DecisionLog",
    "KIND_REPLAN", "KIND_DRIFT", "KIND_EXPLORE", "KIND_VETO", "KIND_BLAME",
    "HistSpec", "DEFAULT_HIST", "cell_histograms", "device_histogram",
    "sketch_from_device",
    "to_chrome_trace", "write_chrome_trace", "load_chrome_trace",
    "kernel_profile",
    "EVTail", "GPDFit", "fit_gpd", "evt_keys", "domain_of_fit",
    "gpd_params_of",
    "SLO", "SLOTracker", "WindowedSketch", "trackers_for",
    "BlameScore", "StragglerBlame",
    "render_dashboard", "render_text", "write_dashboard",
]
