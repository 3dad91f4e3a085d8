"""Device time of the MLP's kernels over the device's busy time in the
traced stretch. The MLP's kernels are those launched by an op that is, or
runs inside, one of the network's own ops: its products (``aten::matmul``,
``aten::mm``, ``aten::addmm``, with the bf16 casts autocast puts under
them), its activations (``aten::relu`` and ``aten::threshold_backward``)
and the Fourier encode (``aten::sin``, ``aten::cos``); in forward,
checkpoint recompute and backward alike. Products inside a factorization
(the coarsest level's Cholesky) are not the MLP's."""

UNIT = "%"
LAYER = "model"
OPS = ("aten::matmul", "aten::mm", "aten::addmm", "aten::relu", "aten::threshold_backward",
       "aten::sin", "aten::cos")


def read(rec):
    t = rec["trace"]
    if not t or t["busy_s"] <= 0:
        return None
    s = 0.0
    for op, parents, sec in t["launched"]:
        chain = [op] + parents
        if any(c in OPS for c in chain) and not any("linalg" in c or "cholesky" in c
                                                    for c in chain):
            s += sec
    return 100.0 * s / t["busy_s"]
