"""The port's plain lane solve (doorman_tpu_torch.solver.dense.solve_dense)
against the JAX package's (doorman_tpu.solver.dense.solve_dense, jitted as
the resident tick runs it), on the same seeded numpy inputs, every lane.

Tolerances, by what can differ:
  * rows up to 32 lanes: EXACT at f64 and f32 on any values — the port
    adds such rows left to right, the order XLA's CPU reduction uses,
    and every elementwise expression is the reference's;
  * wider rows (K = 128): the two libraries sum in different orders.
    Integer-valued demand keeps every sum exact, so the grants are
    EXACT there too;
  * PROPORTIONAL_TOPUP rows: XLA contracts some of this lane's
    multiply-adds into fused multiply-adds, and which ones depends on
    its fusion of the whole program (the port fuses the one it forms in
    the resident tick, `topped`, which tests/test_torch_resident.py
    holds exactly); so these rows, and fractional demand at K = 128,
    are held to rtol 1e-12 (f64) / F32_PARITY_REL_BOUND (f32) relative
    to max(capacity, max wants) of the row — the f32 bound the
    reference holds its own kernels to.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
import tests._torch_threads  # noqa: F401

from doorman_tpu.solver.dense import DenseBatch as JBatch
from doorman_tpu.solver.dense import solve_dense as j_solve_dense
from doorman_tpu_torch.algorithms.tick import F32_PARITY_REL_BOUND
from doorman_tpu_torch.solver.carry import tables_from_numpy
from doorman_tpu_torch.solver.dense import solve_dense
from doorman_tpu_torch.solver.lanes import ITERATIVE_KINDS

LANE_KINDS = np.array([0, 1, 2, 3, 4, 7, 8, 9], np.int32)
TOPUP = 4
DTYPES = {"f64": (np.float64, torch.float64), "f32": (np.float32, torch.float32)}
_j_solve = jax.jit(j_solve_dense)


def world(seed, R, K, integer, kinds=LANE_KINDS):
    rng = np.random.default_rng(seed)
    n = rng.integers(1, K + 1, R)
    act = np.arange(K)[None, :] < n[:, None]
    if integer:
        wants = rng.integers(0, 100, (R, K)).astype(np.float64)
        has = rng.integers(0, 50, (R, K)).astype(np.float64)
    else:
        wants = rng.random((R, K)) * 100
        has = rng.random((R, K)) * 50
    sub = rng.integers(1, 4, (R, K)).astype(np.float64)
    # Capacity around the row's demand: under- and overloaded rows.
    cap = np.floor(rng.random(R) * 80 * n) + 5
    kind = rng.choice(kinds, R).astype(np.int32)
    learn = rng.random(R) < 0.1
    statc = rng.integers(1, 60, R).astype(np.float64)
    return wants * act, has * act, sub * act, act, cap, kind, learn, statc


def ref_solve(tabs, np_dtype):
    w, h, s, act, cap, kind, learn, statc = tabs
    f = lambda x: jnp.asarray(x.astype(np_dtype))  # noqa: E731
    return np.asarray(_j_solve(JBatch(
        wants=f(w), has=f(h), subclients=f(s), active=jnp.asarray(act),
        capacity=f(cap), algo_kind=jnp.asarray(kind),
        learning=jnp.asarray(learn), static_capacity=f(statc),
    )))


def port_batch(tabs, t_dtype):
    return tables_from_numpy(*tabs, device="cpu", dtype=t_dtype)[0]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("integer", [True, False], ids=["int", "frac"])
@pytest.mark.parametrize("K", [16, 128])
def test_port_solve_dense_matches_jax(dtype, integer, K):
    np_dtype, t_dtype = DTYPES[dtype]
    tabs = world(7 + K + integer, 600, K, integer)
    want = ref_solve(tabs, np_dtype)
    got = solve_dense(port_batch(tabs, t_dtype)).numpy()
    w, cap, kind = tabs[0], tabs[4], tabs[5]
    # Which rows must match bit for bit (see the module docstring).
    exact = kind != TOPUP
    if K > 32 and not integer:
        exact[:] = False
    np.testing.assert_array_equal(got[exact], want[exact])
    scale = np.maximum(cap, w.max(axis=1))[:, None]
    bound = 1e-12 if dtype == "f64" else F32_PARITY_REL_BOUND
    err = np.abs(got.astype(np.float64) - want) / scale
    assert err.max() <= bound, (err.max(), bound)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_lane_fast_paths_equal_the_full_solve(dtype):
    """`lanes=` (skip absent lanes) and `lane_rows=` (each iterative fill
    restricted to its own rows) are byte-identical to the full solve."""
    _np_dtype, t_dtype = DTYPES[dtype]
    present = np.array([2, 3, 8, 9], np.int32)
    tabs = world(3, 300, 16, integer=False, kinds=present)
    batch = port_batch(tabs, t_dtype)
    full = solve_dense(batch)
    kind = tabs[5]
    lanes = frozenset(int(k) for k in np.unique(kind))
    lane_rows = {
        k: torch.from_numpy(np.nonzero(kind == k)[0].astype(np.int32))
        for k in ITERATIVE_KINDS & lanes
    }
    assert torch.equal(solve_dense(batch, lanes=lanes), full)
    assert torch.equal(
        solve_dense(batch, lanes=lanes, lane_rows=lane_rows), full
    )
    fair = lane_rows[3]
    assert torch.equal(solve_dense(batch, lanes=lanes, fair_rows=fair), full)


def test_learning_rows_replay_has_and_inactive_lanes_are_zero():
    tabs = world(5, 200, 8, integer=True)
    w, h, s, act, cap, kind, learn, statc = tabs
    got = solve_dense(port_batch(tabs, torch.float64)).numpy()
    np.testing.assert_array_equal(got[learn], h[learn])
    assert (got[~act] == 0).all()
