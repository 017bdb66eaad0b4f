"""Percent of the profiled window in which no kernel, copy or set ran on
the device: 1 - (the union of the device intervals) / the window."""


def read(run):
    s = run.summary
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
