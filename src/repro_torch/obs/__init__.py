"""repro_torch.obs — observability for the port, ported so far:

  * `sketch`    — mergeable streaming quantile sketch (numpy copy);
  * `trace`     — span recorder + NullRecorder, the process-wide recorder;
  * `device`    — γ-bucket histograms counted on the device for the fused
    engines' `tail="hist"` path (PyTorch);
  * `evtail`    — peaks-over-threshold GPD tails fitted on sketch buckets
    (numpy copy);
  * `decisions`, `blame` — the adaptive controller's decision log and
    per-class straggler blame (copies; `fleet.adaptive` needs them).

The rest of `repro.obs` (registry, export, slo, dashboard, profile) is
ROADMAP Queue 1 item 6.
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
from .sketch import QuantileSketch, merge_all  # noqa: F401
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
    "Recorder", "NullRecorder", "NULL_RECORDER",
    "enable", "disable", "get_recorder", "resolve_recorder",
    "PID_FLEET", "PID_CONTROLLER", "PID_SERVING", "PID_PROFILER",
    "PID_DAG_BASE",
    "DecisionEvent", "DecisionLog",
    "KIND_REPLAN", "KIND_DRIFT", "KIND_EXPLORE", "KIND_VETO", "KIND_BLAME",
    "HistSpec", "DEFAULT_HIST", "cell_histograms", "device_histogram",
    "sketch_from_device",
    "EVTail", "GPDFit", "fit_gpd", "evt_keys", "domain_of_fit",
    "gpd_params_of",
    "BlameScore", "StragglerBlame",
]
