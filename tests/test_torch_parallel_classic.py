"""The sharded classic driver and the multi-rank dry run of ndr_tpu_torch,
on the CPU over gloo ranks.

``ground_truth_topopt(shards=2)`` (slabs) and ``shards=(2, 2)`` (pencils)
on the bridge at 16x8x8, mgl=1, 4 OC steps, tol 1e-6, in float64: every
rank's history agrees with the JAX package's unsharded one to 1e-4 (the
criterion of ``tests/test_parallel.py``'s sharded OC test), and the ranks
agree with each other exactly. The JAX history is computed while the
ranks run. ``dryrun_multichip(2)`` runs its neural and classic steps.
"""

import concurrent.futures

import jax.numpy as jnp
import numpy as np
import pytest

from ndr_tpu.io.problem import load_problem as j_load_problem
from ndr_tpu.training.classic import ground_truth_topopt as j_ground_truth_topopt
from ndr_tpu_torch.io.problem import load_problem
from ndr_tpu_torch.parallel import checks, dryrun, launch
from ndr_tpu_torch.training.classic import ground_truth_topopt

BRIDGE = "problems/3d/bridge.json"
KW = dict(dims=(16, 8, 8), num_levels=1, iters=4, tol=1e-6)
SHARDS = [2, (2, 2)]


@pytest.fixture(scope="module")
def runs():
    """{shards: every rank's sharded_classic result}, JAX's history, and
    every rank's dry-run result (all ranks run while JAX runs)."""
    with concurrent.futures.ThreadPoolExecutor(len(SHARDS) + 1) as pool:
        futures = {shards: pool.submit(
            launch.spawn, checks.sharded_classic,
            int(np.prod(shards)), device="cpu", threads=1,
            kwargs=dict(shards=shards, prob_path=BRIDGE, dtype="float64", **KW))
            for shards in SHARDS}
        dry = pool.submit(dryrun.dryrun_multichip, 2, device="cpu", backend="gloo",
                          echo=False)
        ref = j_ground_truth_topopt(j_load_problem(BRIDGE), dims=KW["dims"],
                                    max_iter=KW["iters"],
                                    multigrid_levels=KW["num_levels"], tol=KW["tol"],
                                    dtype=jnp.float64, log=lambda s: None)
        return ({s: f.result() for s, f in futures.items()}, np.asarray(ref.history),
                dry.result())


@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_classic_matches_jax_unsharded(runs, shards):
    results, ref, _ = runs
    hist = np.asarray(results[shards][0]["history"])
    assert len(hist) == len(ref) == KW["iters"]
    assert np.abs(hist - ref).max() / np.abs(ref).max() < 1e-4
    for res in results[shards][1:]:
        np.testing.assert_array_equal(res["history"], hist)
    res = results[shards][0]
    assert "sharded MGPCG" in res["log"] and "(gloo)" in res["log"]
    assert all(0 < n < 100 for n in res["cg_iters"])
    # plain torch ops on the CPU (use_kernels "auto"): no kernel launched
    assert not any(res["launches"].values())


@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_halo_traffic(runs, shards):
    """One level-0 apply: one exchange per sharded axis, each rank sending
    one u plane and one young plane per neighbour along x, one force
    plane per neighbour along y."""
    results, _, _ = runs
    for res in results[shards]:
        halo = res["halo_per_apply"]
        assert halo["fp32 apply"]["exchanges"] == (1 if shards == 2 else 2)
        assert halo["float64 residual"]["bytes"] == 2 * halo["fp32 apply"]["bytes"] > 0


def test_shards_without_a_process_group_raise():
    with pytest.raises(ValueError, match="needs 2 ranks"):
        ground_truth_topopt(load_problem(BRIDGE), dims=(8, 4, 4), max_iter=1,
                            multigrid_levels=1, shards=2, device="cpu",
                            log=lambda s: None)


def test_dryrun_multichip_on_cpu(runs):
    results = runs[2]
    assert len(results) == 2 and results[0]["route"] == "gloo"
    for res in results:
        assert res["compliance"] > 0 and 0 < res["cg_iters"] < 100
        assert abs(res["classic 2-D"] - res["classic 1-D"]) < 5e-3 * res["classic 1-D"]
