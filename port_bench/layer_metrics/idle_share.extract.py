"""Percent of the traced pass in which the device ran nothing: 1 − the
union of its kernels, copies and memsets over the traced window (device
trace)."""


def read(r):
    window, busy = r.summary.get("window_s", 0.0), r.summary.get("busy_s", 0.0)
    if window <= 0 or busy <= 0:
        return None
    return 100.0 * (1.0 - busy / window)
