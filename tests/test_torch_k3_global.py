"""K3's global layout on the CPU: the choice of layout, and the order in
which the layout adds, held against the plain version and the JAX
package.

K3 (csrc/dense_solve.cu `banded_fill_global_kernel`) runs a row wider
than shared memory as one block of T threads (T = K rounded up to a
warp, at most kGlobalThreads = 1,024: `launch_k3_global`) reading the row
from global memory in every pass. Thread t adds its own elements
t, t + T, t + 2T, ... left to right from 0; the warp adds across its 32
lanes with an xor butterfly (offsets 16, 8, 4, 2, 1); then every thread
adds the warp partials in warp order, starting from warp 0's. The card
alone runs the kernel; here `global_rowsum` repeats that order in
PyTorch and `global_alloc_banded` is the plain `_alloc_banded` with
every row sum taken in it, at small widths and T. Both it and a grouped
`solve_priority` whose every evaluation uses it are held against the
plain version and doorman_tpu's `_alloc_banded` / `solve_priority`
(plain XLA on the CPU) on seeded tables: the banded fill within
F32_PARITY_REL_BOUND (f32) / 1e-12 (f64) of max(capacity, max wants),
the theta bisection within 1e-5 (f32) / 1e-9 (f64) of capacity — the
port's existing bounds, which the warp layout's order also meets.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401

from doorman_tpu.solver import priority as jp
from doorman_tpu_torch.algorithms.tick import F32_PARITY_REL_BOUND
from doorman_tpu_torch.solver import dense_cuda, priority_cuda
from doorman_tpu_torch.solver import priority as tp
from doorman_tpu_torch.solver.lanes import expand_rows, rowmax, waterfill_level
from tests.test_torch_k3_layout import (
    DTYPES,
    _alloc_args,
    _cast,
    _row_scale,
    _tables,
)

# (K, T): rows several blocks of threads wide, and one just past a block.
ORDERS = [(100, 32), (300, 64), (1000, 128), (97, 96)]
SEEDS = [0, 1, 2]


def global_rowsum(x: torch.Tensor, T: int) -> torch.Tensor:
    """Per-row sum of [R, K] in the global layout's order with T
    threads."""
    R, K = x.shape
    n = -(-K // T)
    padded = torch.zeros((R, n * T), dtype=x.dtype)
    padded[:, :K] = x
    parts = padded.view(R, n, T)
    acc = torch.zeros((R, T), dtype=x.dtype)
    for i in range(n):
        acc = acc + parts[:, i]
    lane = torch.arange(T)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[:, lane ^ o]
    total = acc[:, 0]
    for w in range(1, T // 32):
        total = total + acc[:, 32 * w]
    return total


def global_alloc_banded(wants, weights, band, active, capacity, num_bands,
                        T):
    """solver.priority._alloc_banded with its row sums in the global
    layout's order."""
    zero = torch.zeros((), dtype=wants.dtype)

    def rsum(v):
        return global_rowsum(v, T)

    gets = torch.zeros_like(wants)
    remaining = capacity
    for rank in range(num_bands):
        m = active & (band == rank)
        w = torch.where(m, wants, zero)
        wt = torch.where(m, weights, zero)
        level = waterfill_level(w, wt, m, remaining, rsum, rowmax, expand_rows)
        fits = expand_rows(rsum(w) <= remaining)
        share = torch.where(fits, w, torch.minimum(w, expand_rows(level) * wt))
        share = torch.where(m, share, zero)
        gets = gets + share
        remaining = torch.maximum(remaining - rsum(share), zero)
    return gets


@pytest.mark.parametrize("K,T", ORDERS)
def test_global_rowsum_order(K, T):
    """Each warp's butterfly leaves one value on all 32 lanes, and the
    sum is within rounding of torch's."""
    x = torch.from_numpy(np.random.default_rng(K).random((8, K)) * 100)
    got = global_rowsum(x, T)
    np.testing.assert_allclose(got, x.sum(1), rtol=1e-13)
    n = -(-K // T)
    padded = torch.zeros((8, n * T), dtype=x.dtype)
    padded[:, :K] = x
    acc = padded.view(8, n, T).sum(1)
    lane = torch.arange(T)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[:, lane ^ o]
    warps = acc.view(8, T // 32, 32)
    assert (warps == warps[:, :, :1]).all()
    # One warp: the butterfly alone.
    one = torch.from_numpy(np.random.default_rng(1).random((3, 32)))
    from tests.test_torch_k3_layout import warp_rowsum

    assert torch.equal(global_rowsum(one, 32), warp_rowsum(one))


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("K,T", ORDERS)
def test_global_order_banded_fill_matches_the_reference(K, T, seed, dtype):
    dt, _tdt = DTYPES[dtype]
    t = _cast(_tables(np.random.default_rng(seed), R=16, K=K), dt)
    args = _alloc_args(t)
    ref = np.asarray(jp._alloc_banded(*(jnp.asarray(a) for a in args), 4))
    targs = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    got = global_alloc_banded(*targs, 4, T).numpy()
    plain = tp._alloc_banded(*targs, 4).numpy()
    assert got.dtype == dt
    bound = 1e-12 if dtype == "f64" else F32_PARITY_REL_BOUND
    scale = _row_scale(t)
    assert (np.abs(got.astype(np.float64) - ref) / scale).max() <= bound
    assert (np.abs(got.astype(np.float64) - plain) / scale).max() <= bound
    assert (got[0] == 0).all() and (got[1] == 0).all()
    assert (got[~t["active"]] == 0).all()


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("seed", SEEDS)
def test_global_order_grouped_solve_matches_the_reference(
    seed, dtype, monkeypatch
):
    """solve_priority with every banded evaluation in the global order
    (through the K3 wrapper's seam, one call per evaluation, as one
    launch each on the card) against the JAX package's grouped solve."""
    dt, tdt = DTYPES[dtype]
    K, T = 300, 64
    t = _cast(_tables(np.random.default_rng(200 + seed), R=24, K=K), dt)
    calls = []

    def global_k3(wants, weights, band, active, eff_cap, num_bands,
                  totals=False):
        calls.append(1)
        gets = global_alloc_banded(wants, weights, band, active, eff_cap,
                                   num_bands, T)
        return (gets, global_rowsum(gets, T)) if totals else gets

    monkeypatch.setattr(priority_cuda, "alloc_banded_k3", global_k3)
    batch = tp.PriorityBatch(**{k: torch.from_numpy(v) for k, v in t.items()})
    got = tp.solve_priority(batch, 4, use_kernel=True).numpy()
    assert len(calls) == tp.alloc_evaluations(tdt, True)
    ref = np.asarray(jp.solve_priority(
        jp.PriorityBatch(**{k: jnp.asarray(v) for k, v in t.items()}),
        num_bands=4,
    ))
    rel = 1e-9 if dtype == "f64" else 1e-5
    scale = np.maximum(t["capacity"], 1.0)[:, None]
    assert (np.abs(got.astype(np.float64) - ref) / scale).max() <= rel
    per_resource = got.astype(np.float64).sum(1)
    for g, cap in enumerate(t["group_cap"]):
        usage = per_resource[t["group"] == g].sum()
        assert usage <= cap * (1 + rel)


@pytest.mark.parametrize("itemsize,first", [(4, 16_384), (8, 8_192)])
def test_k3_layout_picks_global_from_the_first_refused_bucket(itemsize,
                                                              first):
    """The BatchSolver rounds K up to a power of two: the first bucket
    the block layout cannot stage is 16,384 at f32 and 8,192 at f64."""
    assert priority_cuda.k3_layout(first // 2, itemsize) == "block"
    assert priority_cuda.k3_layout(first, itemsize) == "global"
    assert priority_cuda.k3_layout(1 << 20, itemsize) == "global"
    widest = (priority_cuda.SMEM_LIMIT - 64 * itemsize) // (5 * itemsize + 6)
    assert priority_cuda.k3_layout(widest, itemsize) == "block"
    assert priority_cuda.k3_layout(widest + 1, itemsize) == "global"


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_check_passes_any_width(dtype):
    for K in (8, 4096, 8192, 16_384, 1 << 17):
        z = torch.zeros((1, K), dtype=dtype)
        priority_cuda._check(z, z, torch.zeros((1, K), dtype=torch.int32),
                             torch.zeros((1, K), dtype=torch.bool),
                             torch.zeros(1, dtype=dtype))
    z = torch.zeros((1, 16), dtype=dtype)
    with pytest.raises(ValueError, match="band"):
        priority_cuda._check(z, z, torch.zeros((1, 16), dtype=torch.int64),
                             torch.zeros((1, 16), dtype=torch.bool),
                             torch.zeros(1, dtype=dtype))


def test_wide_rows_on_cpu_tensors_take_the_plain_version():
    t = _cast(_tables(np.random.default_rng(9), R=4, K=16_384), np.float32)
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in _alloc_args(t)]
    dense_cuda.reset_launches()
    assert torch.equal(priority_cuda.alloc_banded_k3(*args, 4),
                       tp._alloc_banded(*args, 4))
    assert dense_cuda.LAUNCHES["k3"] == 0
    assert dense_cuda.K3_LAYOUT_LAUNCHES == {"warp": 0, "block": 0,
                                             "global": 0}
