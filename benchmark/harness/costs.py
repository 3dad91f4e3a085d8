"""The yardstick's arithmetic: peaks of one NVIDIA H100 SXM and the work of
the kernels and steps the per-layer metrics hold against them.

Frozen copies: ``bound`` and ``fine_cost`` are ``chip_smoke.py``'s (its
data-sheet peaks and its byte and operation counts of one fine apply),
taken on element counts instead of a ``Grid``; the MLP count is from the
shapes of the north-star network.
"""

from __future__ import annotations

from typing import Sequence, Tuple

# H100 SXM data sheet, dense, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12, "bfloat16": 989e12}
BYTES = {"float32": 4, "float64": 8, "bfloat16": 2}


def bound(nbytes: float, flops: float, dtype: str) -> Tuple[float, str]:
    """(least ms the card could take, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fine_cost(dims: Sequence[int], dtype: str) -> Tuple[float, float]:
    """(bytes, operations) of one fine apply of a degree-1 grid of ``dims``
    elements: u, young and f once each; the operations of the kernels'
    reflection-basis design (the two transforms, in 3-D the lower node
    plane's carried from the previous element; 2^N N x N blocks; the young
    scale fused with the carried forces)."""
    b = BYTES[dtype]
    N = len(dims)
    ne, nn = 1, 1
    for d in dims:
        ne *= d
        nn *= d + 1
    npe = 2 ** N
    d = npe * N
    L = N
    flops = ne * (2 * d * L - (d if N == 3 else 0) + 2 * npe * N * N + 2 * d)
    return 2 * N * nn * b + ne * b, flops


def fine_bound_ms(dims: Sequence[int], dtype: str = "float32") -> float:
    return bound(*fine_cost(dims, dtype), dtype)[0]


def mlp_step_flops(points: int, embedding: int, neurons: int, layers: int,
                   out: int = 1) -> float:
    """Model FLOPs of one training step of the Fourier-feature MLP over
    ``points`` coordinates: forward 2NP, weight gradients 2NP, activation
    gradients of every layer but the first (its input, the Fourier
    encoding, is fixed) 2N(P - P1). No recomputation is credited, and the
    encode itself (2 N 3 E) is left out."""
    sizes = [2 * embedding] + [neurons] * (layers - 1) + [out]
    per_layer = [sizes[i] * sizes[i + 1] for i in range(layers)]
    P = sum(per_layer)
    return 2.0 * points * P * 2 + 2.0 * points * (P - per_layer[0])
