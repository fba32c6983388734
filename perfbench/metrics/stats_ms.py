"""stats_ms: device ms a query of the kernels launched inside the stats and
tails layer: the frontier's `_cell_stats` (less the queue it calls) and
`_tail_keys`."""

LAYER = "stats"
WRAPS = (("repro_torch.fleet.vector", "_cell_stats"), ("repro_torch.fleet.vector", "_tail_keys"))


def read(view):
    return view.layer_ms(LAYER)
