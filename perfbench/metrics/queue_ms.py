"""queue_ms: device ms a query of the kernels launched inside the queue
layer: `batched_queue` where the frontier's `_cell_stats` binds it."""

LAYER = "queue"
WRAPS = (("repro_torch.fleet.vector", "batched_queue"),)


def read(view):
    return view.layer_ms(LAYER)
