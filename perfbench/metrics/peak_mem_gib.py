"""peak_mem_gib: `torch.cuda.max_memory_allocated()` over the traced
window, after `reset_peak_memory_stats()` at its start, in GiB."""

WRAPS = ()


def read(view):
    return view.peak_bytes / 2**30 if view.peak_bytes else None
