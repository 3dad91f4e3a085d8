from benchmark.harness import costs


def test_fine_cost_matches_the_kernel_table():
    nbytes, flops = costs.fine_cost((192, 96, 96), "float32")
    assert round(nbytes / 1e6, 1) == 50.7
    ms, by = costs.bound(nbytes, flops, "float32")
    assert by == "bytes" and round(ms, 4) == 0.0151
    nbytes, _ = costs.fine_cost((256, 128, 128), "float32")
    assert round(nbytes / 1e6, 1) == 119.4
    assert round(costs.fine_bound_ms((256, 128, 128)), 4) == 0.0356


def test_mlp_step_flops_of_the_north_star():
    f = costs.mlp_step_flops(192 * 96 * 96, 1024, 512, 4)
    assert f == 2 * 1769472 * 1573376 * 2 + 2 * 1769472 * (1573376 - 2048 * 512)
    assert round(f / 1e13, 4) == 1.2993
