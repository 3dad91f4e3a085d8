"""The neural step's model FLOPs (from the network's shapes and the grid's
point count) over the window's step time times the card's bf16 dense
peak, 989 TFLOP/s."""

from benchmark.harness import costs

UNIT = "%"
LAYER = "neural step"


def read(rec):
    n, grid = rec["config"]["network"], rec["config"]["grid"]
    points = grid[0] * grid[1] * grid[2]
    flops = costs.mlp_step_flops(points, n["embedding_size"], n["n_neurons"], n["n_layers"])
    return 100.0 * flops / (rec["window"]["step_s"] * costs.PEAK_FLOPS["bfloat16"])
