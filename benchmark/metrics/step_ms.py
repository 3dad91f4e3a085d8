"""Wall time per design update over the window: its host-clock length
over the steps completed in it."""

UNIT = "ms/step"
LAYER = "driver"


def read(rec):
    return rec["window"]["step_s"] * 1e3
