"""device_idle_pct: the share of the traced window in which no operation
ran on the device (the profiler's timeline, the union of kernels, copies
and sets over the window from the first traced query's start to the last
one's end)."""

WRAPS = ()


def read(view):
    if view.window_s <= 0 or view.busy_s <= 0:
        return None
    return 100.0 * (1.0 - view.busy_s / view.window_s)
