"""The port's edge-list solve (core.snapshot.pack_edge_arrays +
solver.kernels.solve_tick, the BatchSolver's lane part for resources
wider than DENSE_MAX_K) against the JAX package's on the same seeded
edge lists, every lane kind, at f64 and f32.

Bit-identical: the per-resource sums are segment sums over consecutive
edges, which the port's torch.segment_reduce and XLA's sorted
segment_sum on the CPU both add in edge order from 0, and every
elementwise expression is the same.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401

from doorman_tpu.core.snapshot import ResourceSpec as JSpec
from doorman_tpu.core.snapshot import pack_edge_arrays as j_pack
from doorman_tpu.solver.kernels import solve_tick as j_solve_tick
from doorman_tpu_torch.core.snapshot import ResourceSpec as TSpec
from doorman_tpu_torch.core.snapshot import pack_edge_arrays as t_pack
from doorman_tpu_torch.solver.fairshare import local_segment_sum
from doorman_tpu_torch.solver.kernels import solve_tick

LANE_KINDS = (0, 1, 2, 3, 4, 7, 8, 9)


def _world(rng, dt, n_res):
    counts = rng.integers(1, 80, n_res)
    counts[2] = 0  # a resource with no leases
    rid = np.repeat(np.arange(n_res), counts).astype(np.int32)
    n = len(rid)
    wants = rng.integers(0, 100, n).astype(dt)
    has = (rng.random(n) * 60).astype(dt)
    sub = rng.integers(1, 4, n).astype(dt)
    specs = [
        (f"r{i}", float(counts[i] * (20 if i % 2 else 70) + 5),
         LANE_KINDS[i % len(LANE_KINDS)], i == 5, float(rng.random() * 40))
        for i in range(n_res)
    ]
    return specs, rid, wants, has, sub


@pytest.mark.parametrize("n_res", [16, 21])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_solve_tick_matches_the_reference_bit_for_bit(seed, dtype, n_res):
    """16 resources fill the resource bucket (the padding edges then
    share the last real resource's segment); 21 leave padding
    segments."""
    dt = np.float64 if dtype == "f64" else np.float32
    specs, rid, wants, has, sub = _world(
        np.random.default_rng(seed), dt, n_res
    )
    js = j_pack([JSpec(*s) for s in specs], rid, wants, has, sub, dtype=dt)
    ts = t_pack([TSpec(*s) for s in specs], rid, wants, has, sub, dtype=dt,
                to_device=torch.from_numpy)
    assert ts.num_edges == js.num_edges == len(rid)
    ref = np.asarray(j_solve_tick(js.edges, js.resources))
    got = solve_tick(ts.edges, ts.resources).numpy()
    assert got.dtype == dt
    np.testing.assert_array_equal(got, ref)
    assert (got[len(rid):] == 0).all()
    # Without the packer's lengths the counts come from the ids.
    ts.edges.lengths = None
    assert np.array_equal(solve_tick(ts.edges, ts.resources).numpy(), ref)


def test_segment_sum_adds_in_edge_order():
    v = torch.tensor([1e16, 1.0, -1e16, 3.0, 5.0], dtype=torch.float64)
    segsum = local_segment_sum(torch.tensor([0, 0, 0, 2, 2]), 3)
    assert segsum(v).tolist() == [0.0, 0.0, 8.0]
