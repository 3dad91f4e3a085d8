"""Share of its bound that the fp32 fine apply (``csrc/fine_stream.cu``'s
float instance) reaches over the traced stretch: the sum over its
launches of the least time the card could take (the bytes of u, young and
f at the configuration's fine grid against 3.35 TB/s, or its operations
against 67 TFLOP/s) over the sum of their device times."""

from benchmark.harness import costs

UNIT = "%"
LAYER = "kernels"
KERNEL = "apply_k_fine_stream_kernel<float"


def read(rec):
    t = rec["trace"]
    if not t:
        return None
    times = [s for name, _, s in t["device"] if KERNEL in name]
    if not times:
        return None
    bound_s = costs.fine_bound_ms(rec["config"]["grid"], "float32") * 1e-3
    return 100.0 * bound_s * len(times) / sum(times)
