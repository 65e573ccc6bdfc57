"""The device's idle share of the traced window: 1 - the union of the
device's operations (torch.profiler) over the window's seconds, in %.
Nothing where the trace holds no device operation."""


def read(rec):
    if rec["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
