"""Process start to window open: imports, problem assembly, kernel
library load (and build on a checkout's first run), warm-up steps, graph
captures."""

UNIT = "s"
LAYER = "driver"


def read(rec):
    return rec["setup_s"]
