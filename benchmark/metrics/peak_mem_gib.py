"""The card's peak allocated memory over the run, read from the caching
allocator by the benchmark when the window closes."""

UNIT = "GiB"
LAYER = "device"


def read(rec):
    return rec["peak_bytes"] / 2 ** 30
