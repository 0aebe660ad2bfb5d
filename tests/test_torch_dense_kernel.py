"""The plain versions of the port's kernels K1 and K2 against the JAX
package's Pallas kernels, run in interpret mode on the CPU as the JAX
package's own tests run them (solve_dense_pallas / fused_tick_pallas
with interpret=True), on the same seeded numpy inputs.

K1 (solve_dense_k1 on CPU tensors = solve_dense): integer-valued demand
keeps every sum exact, so every row but PROPORTIONAL_TOPUP's must match
the Pallas grants bit for bit; top-up rows (XLA fuses some of their
multiply-adds) and fractional demand are held to F32_PARITY_REL_BOUND
(f32) / rtol 1e-12 (f64) relative to max(capacity, max wants) of the row.

K2 (fused_tick_k2 on CPU tensors = fused_tick_plain): its grants are
K1's; its changed flags and advanced prev table equal the Pallas
kernel's exactly on every row whose grants agree, for prev in the solve
dtype and in bfloat16 (the download dtype of a bf16 delivery).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401

from doorman_tpu.solver.dense import DenseBatch as JBatch
from doorman_tpu.solver.pallas_dense import fused_tick_pallas, solve_dense_pallas
from doorman_tpu_torch.algorithms.tick import F32_PARITY_REL_BOUND
from doorman_tpu_torch.solver.carry import tables_from_numpy
from doorman_tpu_torch.solver.dense_cuda import (
    LAUNCHES,
    fused_tick_k2,
    solve_dense_k1,
)
from tests.test_torch_lanes import DTYPES, TOPUP, world

R, K = 48, 40


def _jbatch(tabs, np_dtype):
    w, h, s, act, cap, kind, learn, statc = tabs
    f = lambda x: jnp.asarray(x.astype(np_dtype))  # noqa: E731
    return JBatch(
        wants=f(w), has=f(h), subclients=f(s), active=jnp.asarray(act),
        capacity=f(cap), algo_kind=jnp.asarray(kind),
        learning=jnp.asarray(learn), static_capacity=f(statc),
    )


def _check_grants(got, want, tabs, dtype, integer):
    w, cap, kind = tabs[0], tabs[4], tabs[5]
    exact = (kind != TOPUP) if integer else np.zeros(len(kind), bool)
    np.testing.assert_array_equal(got[exact], want[exact])
    scale = np.maximum(cap, w.max(axis=1))[:, None]
    bound = 1e-12 if dtype == "f64" else F32_PARITY_REL_BOUND
    err = np.abs(got.astype(np.float64) - want.astype(np.float64)) / scale
    assert err.max() <= bound, (err.max(), bound)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("integer", [True, False], ids=["int", "frac"])
def test_k1_plain_matches_pallas_interpret(dtype, integer):
    np_dtype, t_dtype = DTYPES[dtype]
    tabs = world(21 + integer, R, K, integer)
    want = np.asarray(solve_dense_pallas(_jbatch(tabs, np_dtype), interpret=True))
    before = dict(LAUNCHES)
    batch = tables_from_numpy(*tabs, device="cpu", dtype=t_dtype)[0]
    got = solve_dense_k1(batch).numpy()
    assert LAUNCHES == before  # CPU tensors never count a kernel launch
    _check_grants(got, want, tabs, dtype, integer)
    # The row-gather form solves the selected rows in the given order.
    rows = torch.arange(R - 1, -1, -2, dtype=torch.int32)
    np.testing.assert_array_equal(
        solve_dense_k1(batch, rows=rows).numpy(), got[rows.numpy()]
    )


@pytest.mark.parametrize("prev_dtype", ["solve", "bf16"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_k2_plain_matches_pallas_interpret(dtype, prev_dtype):
    np_dtype, t_dtype = DTYPES[dtype]
    tabs = world(33, R, K, integer=True)
    rng = np.random.default_rng(5)
    prev_np = rng.integers(0, 30, (R, K)).astype(np.float64)
    # A few rows already at their grants: unchanged even when delivered.
    jb = _jbatch(tabs, np_dtype)
    k1 = np.asarray(solve_dense_pallas(jb, interpret=True)).astype(np.float64)
    prev_np[::4] = k1[::4]
    deliv = rng.random(R) < 0.6
    jprev_dtype = jnp.bfloat16 if prev_dtype == "bf16" else np_dtype
    t_prev_dtype = torch.bfloat16 if prev_dtype == "bf16" else t_dtype
    jgets, jprev, jchanged = fused_tick_pallas(
        jb, jnp.asarray(prev_np).astype(jprev_dtype),
        jnp.asarray(deliv.astype(np_dtype)), interpret=True,
    )
    jgets = np.asarray(jgets)
    jprev = np.asarray(jprev.astype(jnp.float64))
    jchanged = np.asarray(jchanged)

    batch, prev = tables_from_numpy(
        *tabs, prev_np, device="cpu", dtype=t_dtype, prev_dtype=t_prev_dtype,
    )
    gets, prev_new, changed = fused_tick_k2(batch, prev, torch.from_numpy(deliv))
    gets = gets.numpy()
    _check_grants(gets, jgets, tabs, dtype, integer=True)
    np.testing.assert_array_equal(gets, solve_dense_k1(batch).numpy())
    same = (gets == jgets).all(axis=1)
    assert same.sum() >= R // 2
    np.testing.assert_array_equal(changed.numpy()[same], jchanged[same])
    np.testing.assert_array_equal(
        prev_new.double().numpy()[same], jprev[same]
    )
    # The epilogue's definition, on the port's own grants.
    out = torch.from_numpy(gets).to(t_prev_dtype)
    d = torch.from_numpy(deliv)
    assert torch.equal(changed, d & (out != prev).any(dim=1))
    assert torch.equal(prev_new, torch.where(d[:, None], out, prev))
    assert changed.any() and not changed.all()
