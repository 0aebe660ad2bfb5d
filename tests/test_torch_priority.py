"""The port's priority solve against the JAX package's on the CPU: the
banded water-fill (K3's plain version, and K3's wrapper on CPU tensors)
against doorman_tpu's `_alloc_banded` and its Pallas kernel in interpret
mode, `solve_priority` with and without capacity groups, and the numpy
oracle copy. Inputs are made with numpy from a seed and handed to both.

Tolerances: the banded water-fill is held to 1e-12 (f64) and
F32_PARITY_REL_BOUND (f32) of max(capacity, max wants) per row, the
reduction-order bound of the lane solve, for integer and fractional
demand alike. Integer demand is not bit-identical past the first
overloaded band: that band's shares are level * weight, fractional, and
the capacity left to the next band is their sum, which XLA's fused
reduction adds in another order than the port (a few grants in a
thousand differ by an ulp or two). With groups, the theta bisection turns an ulp of usage into
a different feasible theta, so grants are held to 1e-9 (f64) and 1e-5
(f32) of the row's capacity — the reference's own kernel-vs-XLA bound
(tests/test_pallas_priority.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
import tests._torch_threads  # noqa: F401

from doorman_tpu.algorithms import priority as j_oracle
from doorman_tpu.solver import priority as jp
from doorman_tpu.solver.pallas_priority import alloc_banded_pallas
from doorman_tpu_torch.algorithms import priority as t_oracle
from doorman_tpu_torch.algorithms.tick import F32_PARITY_REL_BOUND
from doorman_tpu_torch.solver import dense_cuda
from doorman_tpu_torch.solver import priority as tp
from doorman_tpu_torch.solver.lanes import rowsum
from doorman_tpu_torch.solver.priority_cuda import alloc_banded_k3

jax.config.update("jax_enable_x64", True)

DTYPES = {"f64": (np.float64, torch.float64), "f32": (np.float32, torch.float32)}


def _tables(rng, R=12, K=32, G=3, num_bands=4, integer=True):
    active = np.zeros((R, K), bool)
    for r in range(R):
        active[r, : rng.integers(1, K + 1)] = True
    if integer:
        wants = rng.integers(0, 100, (R, K)).astype(np.float64)
        capacity = rng.integers(50, 800, R).astype(np.float64)
    else:
        wants = rng.random((R, K)) * 100
        capacity = rng.random(R) * 750 + 50
    wants *= active
    weights = (rng.integers(1, 4, (R, K)) * active).astype(np.float64)
    band = (rng.integers(0, num_bands, (R, K)) * active).astype(np.int32)
    group = rng.choice(np.arange(-1, G), R).astype(np.int32)
    group_cap = rng.integers(100, 1200, G).astype(np.float64)
    return dict(wants=wants, weights=weights, band=band, active=active,
                capacity=capacity, group=group, group_cap=group_cap)


def _cast(t, dt):
    return {k: (v.astype(dt) if v.dtype == np.float64 else v)
            for k, v in t.items()}


def _j_batch(t):
    return jp.PriorityBatch(**{k: jnp.asarray(v) for k, v in t.items()})


def _t_batch(t):
    return tp.PriorityBatch(**{k: torch.from_numpy(v) for k, v in t.items()})


def _row_scale(t):
    return np.maximum(t["capacity"], (t["wants"] * t["active"]).max(1))[:, None]


def _alloc_args(t):
    return (t["wants"] * t["active"], t["weights"] * t["active"], t["band"],
            t["active"], t["capacity"])


@pytest.mark.parametrize("integer", [True, False], ids=["int", "frac"])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("K", [32, 64])
def test_alloc_banded_matches_the_reference_and_its_pallas_kernel(
    K, dtype, integer
):
    dt, _tdt = DTYPES[dtype]
    t = _cast(_tables(np.random.default_rng(K), R=37, K=K, integer=integer),
              dt)
    args = _alloc_args(t)
    ref = np.asarray(jp._alloc_banded(*(jnp.asarray(a) for a in args), 4))
    got = tp._alloc_banded(*(torch.from_numpy(np.ascontiguousarray(a))
                             for a in args), 4).numpy()
    assert got.dtype == dt
    bound = 1e-12 if dtype == "f64" else F32_PARITY_REL_BOUND
    scale = _row_scale(t)
    assert (np.abs(got.astype(np.float64) - ref) / scale).max() <= bound
    if dtype == "f32":
        pallas = np.asarray(alloc_banded_pallas(
            *(jnp.asarray(a) for a in args), 4, interpret=True
        ))
        assert (np.abs(got.astype(np.float64) - pallas) / scale).max() <= bound


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_k3_wrapper_on_cpu_tensors_is_the_plain_version(dtype):
    dt, _tdt = DTYPES[dtype]
    t = _cast(_tables(np.random.default_rng(5), R=20, K=64, integer=False), dt)
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in _alloc_args(t)]
    dense_cuda.reset_launches()
    plain = tp._alloc_banded(*args, 4)
    gets, totals = alloc_banded_k3(*args, 4, totals=True)
    assert torch.equal(alloc_banded_k3(*args, 4), plain)
    assert torch.equal(gets, plain)
    assert torch.equal(totals, rowsum(plain))
    assert dense_cuda.LAUNCHES["k3"] == 0


def test_k3_refuses_a_row_wider_than_shared_memory():
    """No width is refused any more: a row wider than the block layout's
    shared memory goes to the cluster layout (priority_cuda.k3_layout),
    and `_check` passes it."""
    from doorman_tpu_torch.solver import priority_cuda

    def tables(K, dtype):
        z = torch.zeros((1, K), dtype=dtype)
        return (z, z, torch.zeros((1, K), dtype=torch.int32),
                torch.zeros((1, K), dtype=torch.bool),
                torch.zeros(1, dtype=dtype))

    priority_cuda._check(*tables(4096, torch.float64))
    priority_cuda._check(*tables(8192, torch.float64))
    assert priority_cuda.k3_layout(4096, 8) == "block"
    assert priority_cuda.k3_layout(8192, 8) == "cluster"
    assert priority_cuda.k3_smem_bytes(4096, 8) == 188_928


def _assert_grouped_close(got, ref, t, dtype):
    rel = 1e-9 if dtype == "f64" else 1e-5
    scale = np.maximum(t["capacity"], 1.0)[:, None]
    assert (np.abs(got.astype(np.float64) - ref) / scale).max() <= rel


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "k3"])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_solve_priority_matches_the_reference(seed, dtype, use_kernel):
    dt, _tdt = DTYPES[dtype]
    t = _cast(_tables(np.random.default_rng(seed)), dt)
    ref = np.asarray(jp.solve_priority(_j_batch(t), num_bands=4))
    got = tp.solve_priority(_t_batch(t), 4, use_kernel=use_kernel).numpy()
    assert got.dtype == dt
    _assert_grouped_close(got, ref, t, dtype)
    assert (got[~t["active"]] == 0).all()


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_solve_priority_without_groups_is_one_banded_pass(dtype):
    dt, _tdt = DTYPES[dtype]
    t = _cast(_tables(np.random.default_rng(4)), dt)
    t["group"] = np.full_like(t["group"], -1)
    t["group_cap"] = np.zeros(0, dt)
    ref = np.asarray(jp.solve_priority(_j_batch(t), num_bands=4))
    got = tp.solve_priority(_t_batch(t), 4).numpy()
    bound = 1e-12 if dtype == "f64" else F32_PARITY_REL_BOUND
    assert (np.abs(got.astype(np.float64) - ref) / _row_scale(t)).max() <= bound
    for r in range(len(t["capacity"])):
        a = t["active"][r]
        np.testing.assert_allclose(
            got[r, a],
            t_oracle.priority_alloc(t["capacity"][r], t["wants"][r, a],
                                    t["weights"][r, a], t["band"][r, a]),
            rtol=1e-9 if dtype == "f64" else 1e-5, atol=1e-6 if dtype == "f64"
            else 1e-3,
        )


def test_solve_priority_is_deterministic_and_respects_group_caps():
    t = _tables(np.random.default_rng(9), R=20, G=4)
    b = _t_batch(t)
    got = tp.solve_priority(b, 4)
    assert torch.equal(got, tp.solve_priority(b, 4))
    per_resource = got.numpy().sum(axis=1)
    for g in range(len(t["group_cap"])):
        usage = per_resource[t["group"] == g].sum()
        assert usage <= t["group_cap"][g] * (1 + 1e-9) + 1e-6
    assert (per_resource <= t["capacity"] + 1e-6).all()


def _one_row(wants, weights, bands, capacity, group=-1, group_cap=(),
             dt=np.float64):
    n = len(wants)
    return dict(
        wants=np.asarray([wants], dt), weights=np.asarray([weights], dt),
        band=np.asarray([bands], np.int32), active=np.ones((1, n), bool),
        capacity=np.asarray([capacity], dt),
        group=np.asarray([group], np.int32),
        group_cap=np.asarray(group_cap, dt),
    )


@pytest.mark.parametrize("case", [
    "single_band_fair_share", "higher_band_first", "band0_over_capacity",
    "zero_weight", "all_weights_zero",
])
def test_solve_priority_cases_of_the_reference(case):
    """tests/test_priority_solver.py's single-resource cases, through both
    packages' batched solves and the oracle."""
    rng = np.random.default_rng(0)
    t, want = {
        "single_band_fair_share": lambda: (
            lambda w, s: (_one_row(w, s, np.zeros(20, int), 300.0), None)
        )(rng.integers(0, 100, 20).astype(float),
          rng.integers(1, 4, 20).astype(float)),
        "higher_band_first": lambda: (
            _one_row([50, 50, 80, 80], [1] * 4, [0, 0, 1, 1], 120.0),
            [50, 50, 10, 10]),
        "band0_over_capacity": lambda: (
            _one_row([50, 50, 80, 80], [1] * 4, [0, 0, 1, 1], 60.0),
            [30, 30, 0, 0]),
        "zero_weight": lambda: (
            _one_row([60, 60], [1, 0], [0, 0], 100.0), [60, 0]),
        "all_weights_zero": lambda: (
            _one_row([60, 60], [0, 0], [0, 0], 100.0), [0, 0]),
    }[case]()
    got = tp.solve_priority(_t_batch(t), 2).numpy()[0]
    ref = np.asarray(jp.solve_priority(_j_batch(t), num_bands=2))[0]
    oracle = t_oracle.priority_alloc(
        t["capacity"][0], t["wants"][0], t["weights"][0], t["band"][0]
    )
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(got, oracle, rtol=1e-12, atol=1e-12)
    if want is not None:
        np.testing.assert_allclose(got, want)


def test_group_cap_binds_and_uncoupled_rows_ignore_groups():
    def rows(group):
        return dict(
            wants=np.full((2, 4), 50.0), weights=np.ones((2, 4)),
            band=np.zeros((2, 4), np.int32), active=np.ones((2, 4), bool),
            capacity=np.array([100.0, 100.0]),
            group=np.asarray(group, np.int32), group_cap=np.array([120.0]),
        )
    got = tp.solve_priority(_t_batch(rows([0, 0])), 1).numpy()
    assert got.sum() == pytest.approx(120.0, rel=1e-6)
    np.testing.assert_allclose(got[0], got[1])
    t = rows([0, -1])
    t["group_cap"] = np.array([80.0])
    got = tp.solve_priority(_t_batch(t), 1).numpy()
    assert got[0].sum() == pytest.approx(80.0, rel=1e-6)
    assert got[1].sum() == pytest.approx(100.0, rel=1e-6)
    ref = np.asarray(jp.solve_priority(_j_batch(t), num_bands=1))
    np.testing.assert_allclose(got, ref, rtol=1e-12)


def test_heavily_overcapped_group_f32():
    """theta* far below the f32 bisection's absolute granularity: the
    multiplicative refinement keeps the group at its cap to f32 relative
    precision."""
    t = _one_row([2.5e5] * 4, [1] * 4, [0] * 4, 1e6, group=0,
                 group_cap=[1e-2], dt=np.float32)
    got = tp.solve_priority(_t_batch(t), 1).numpy()
    assert got.dtype == np.float32
    assert got.sum() == pytest.approx(1e-2, rel=1e-4)
    ref = np.asarray(jp.solve_priority(_j_batch(t), num_bands=1))
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_alloc_evaluations_count_the_banded_passes():
    assert tp.alloc_evaluations(torch.float32, True) == 38
    assert tp.alloc_evaluations(torch.float64, True) == 66
    assert tp.alloc_evaluations(torch.float32, False) == 1
    assert tp._theta_iters(torch.float64) == jp._theta_iters(jnp.float64)
    assert tp._theta_iters(torch.float32) == jp._theta_iters(jnp.float32)
    assert tp.THETA_ITERS == t_oracle.THETA_ITERS == j_oracle.THETA_ITERS


@pytest.mark.parametrize("seed", [0, 1])
def test_oracle_copy_matches_the_reference_oracle(seed):
    rng = np.random.default_rng(seed)
    t = _tables(rng)
    a = t["active"]
    args = (
        t["capacity"],
        [t["wants"][r, a[r]] for r in range(len(a))],
        [t["weights"][r, a[r]] for r in range(len(a))],
        [t["band"][r, a[r]] for r in range(len(a))],
        t["group"], t["group_cap"],
    )
    got = t_oracle.grouped_priority_alloc(*args)
    ref = j_oracle.grouped_priority_alloc(*args)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(
        t_oracle.band_waterfill(90.0, args[1][0], args[2][0]),
        j_oracle.band_waterfill(90.0, args[1][0], args[2][0]),
    )
    # The batched solve against the oracle, as the reference's own test.
    got = tp.solve_priority(_t_batch(t), 4).numpy()
    for r in range(len(a)):
        np.testing.assert_allclose(got[r, a[r]], ref[r], rtol=1e-9, atol=1e-6)
