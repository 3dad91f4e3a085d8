"""The share of a step in which the device does nothing: 1 - (device busy
time per step in the traced stretch) / (the window's step time). Busy is
the sum of the device events' durations (one stream). The window's step
time is taken untraced: the profiler slows the host that launches the
work several times over, but not the kernels, so the traced stretch's own
wall would count the profiler's cost as idle time."""

UNIT = "%"
LAYER = "device"


def read(rec):
    t = rec["trace"]
    if not t or not t["steps"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["steps"] / rec["window"]["step_s"])
