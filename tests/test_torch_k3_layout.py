"""K3's two layouts on the CPU: the order in which the warp-per-row
layout adds, held against the JAX package, and the choice of layout.

K3 (csrc/dense_solve.cu) runs rows of up to 256 lanes as one warp per
row: lane l holds elements l + 32 v for v < V (V = ceil(K / 32) rounded
up to 1, 2, 4 or 8), adds its own V values left to right, then the warp
adds across lanes with an xor butterfly (offsets 16, 8, 4, 2, 1). Wider
rows keep the block-per-row layout, whose order is another. The card
alone runs the kernel; here `warp_rowsum` repeats that order in
PyTorch, and `warp_alloc_banded` is the plain `_alloc_banded` with every
row sum taken in it. Both it and a grouped `solve_priority` whose every
evaluation uses it are held against doorman_tpu's `_alloc_banded` and
`solve_priority` (plain XLA on the CPU) on seeded tables at the widths
the warp layout takes, so the new order is shown not to move the
banded fill beyond F32_PARITY_REL_BOUND (f32) / 1e-12 (f64) of
max(capacity, max wants), nor the theta bisection beyond 1e-5 (f32) /
1e-9 (f64) of capacity: the port's existing bounds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
import tests._torch_threads  # noqa: F401

from doorman_tpu.solver import priority as jp
from doorman_tpu_torch.algorithms.tick import F32_PARITY_REL_BOUND
from doorman_tpu_torch.solver import dense_cuda, priority_cuda
from doorman_tpu_torch.solver import priority as tp
from doorman_tpu_torch.solver.lanes import (
    expand_rows,
    rowmax,
    rowsum,
    waterfill_level,
)

DTYPES = {"f64": (np.float64, torch.float64), "f32": (np.float32, torch.float32)}
WARP_WIDTHS = [100, 128, 256]
SEEDS = [0, 1, 2]


def _lanes_per_thread(K):
    return next(V for V in (1, 2, 4, 8) if 32 * V >= K)


def warp_rowsum(x: torch.Tensor) -> torch.Tensor:
    """Per-row sum of [R, K] in the warp layout's order: each lane's
    left-to-right partial over its elements l + 32 v (lanes past K add
    zeros), then the xor butterfly, after which every lane holds the
    same value."""
    R, K = x.shape
    V = _lanes_per_thread(K)
    padded = torch.zeros((R, 32 * V), dtype=x.dtype)
    padded[:, :K] = x
    parts = padded.view(R, V, 32)
    acc = torch.zeros((R, 32), dtype=x.dtype)
    for v in range(V):
        acc = acc + parts[:, v]
    lane = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[:, lane ^ o]
    return acc[:, 0]


def warp_alloc_banded(wants, weights, band, active, capacity, num_bands):
    """solver.priority._alloc_banded with its row sums in the warp
    layout's order."""
    zero = torch.zeros((), dtype=wants.dtype)
    gets = torch.zeros_like(wants)
    remaining = capacity
    for rank in range(num_bands):
        m = active & (band == rank)
        w = torch.where(m, wants, zero)
        wt = torch.where(m, weights, zero)
        level = waterfill_level(
            w, wt, m, remaining, warp_rowsum, rowmax, expand_rows
        )
        fits = expand_rows(warp_rowsum(w) <= remaining)
        share = torch.where(
            fits, w, torch.minimum(w, expand_rows(level) * wt)
        )
        share = torch.where(m, share, zero)
        gets = gets + share
        remaining = torch.maximum(remaining - warp_rowsum(share), zero)
    return gets


def _tables(rng, R, K, G=3, num_bands=4):
    """Seeded priority tables with the rows a kernel gets wrong first:
    an all-inactive row, a row of capacity 0, rows whose bands 1 and 3
    have no member, and rows in which every band overflows."""
    n = rng.integers(1, K + 1, R)
    n[4:6] = K
    active = np.arange(K)[None, :] < n[:, None]
    wants = rng.random((R, K)) * 100 * active
    capacity = rng.random(R) * 40 * active.sum(1) + 5
    weights = (rng.integers(1, 4, (R, K)) * active).astype(np.float64)
    band = (rng.integers(0, num_bands, (R, K)) * active).astype(np.int32)
    active[0] = False
    wants[0] = weights[0] = band[0] = 0
    capacity[1] = 0.0
    band[2:4] = (band[2:4] // 2) * 2  # ranks 0 and 2 only
    capacity[4:6] = wants[4:6].min(1) / 2  # below any one client's wants
    group = rng.choice(np.arange(-1, G), R).astype(np.int32)
    per_group = [capacity[group == g].sum() for g in range(G)]
    group_cap = np.asarray(per_group) * rng.uniform(0.2, 0.8, G)
    return dict(wants=wants, weights=weights, band=band, active=active,
                capacity=capacity, group=group, group_cap=group_cap)


def _cast(t, dt):
    return {k: (v.astype(dt) if v.dtype == np.float64 else v)
            for k, v in t.items()}


def _alloc_args(t):
    return (t["wants"], t["weights"], t["band"], t["active"], t["capacity"])


def _row_scale(t):
    return np.maximum(t["capacity"], (t["wants"] * t["active"]).max(1))[:, None]


@pytest.mark.parametrize("K", [8, 100, 128, 256])
def test_warp_rowsum_leaves_one_value_on_every_lane(K):
    """The property the kernel's uniform branches rest on, and the sum
    itself within rounding of torch's."""
    x = torch.from_numpy(np.random.default_rng(K).random((16, K)) * 100)
    V = _lanes_per_thread(K)
    padded = torch.zeros((16, 32 * V), dtype=x.dtype)
    padded[:, :K] = x
    acc = padded.view(16, V, 32).sum(1)
    lane = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[:, lane ^ o]
        partner = acc[:, lane ^ o]
        assert torch.equal(acc, partner)
    assert (acc == acc[:, :1]).all()
    np.testing.assert_allclose(warp_rowsum(x), x.sum(1), rtol=1e-14)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("K", WARP_WIDTHS)
def test_warp_order_banded_fill_matches_the_reference(K, seed, dtype):
    dt, _tdt = DTYPES[dtype]
    t = _cast(_tables(np.random.default_rng(seed), R=24, K=K), dt)
    args = _alloc_args(t)
    ref = np.asarray(jp._alloc_banded(*(jnp.asarray(a) for a in args), 4))
    targs = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    got = warp_alloc_banded(*targs, 4).numpy()
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
@pytest.mark.parametrize("K", WARP_WIDTHS)
def test_warp_order_grouped_solve_matches_the_reference(
    K, seed, dtype, monkeypatch
):
    """solve_priority with every banded evaluation in the warp order
    (through the K3 wrapper's seam, one call per evaluation, as one
    launch each on the card) against the JAX package's grouped solve."""
    dt, tdt = DTYPES[dtype]
    t = _cast(_tables(np.random.default_rng(100 + seed), R=24, K=K), dt)
    calls = []

    def warp_k3(wants, weights, band, active, eff_cap, num_bands,
                totals=False):
        calls.append(1)
        gets = warp_alloc_banded(wants, weights, band, active, eff_cap,
                                 num_bands)
        return (gets, warp_rowsum(gets)) if totals else gets

    monkeypatch.setattr(priority_cuda, "alloc_banded_k3", warp_k3)
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


@pytest.mark.parametrize("K", [1, 8, 32, 100, 128, 255, 256, 257, 4096, 8930])
def test_k3_layout_is_warp_up_to_256_lanes_and_block_above(K):
    """At f32 the block layout stages every row up to 8,930 lanes (the
    cluster layout above it: tests/test_torch_k3_cluster.py)."""
    assert priority_cuda.k3_layout(K, 4) == ("warp" if K <= 256 else "block")


def test_block_layout_keeps_its_shared_memory_limit():
    """The block layout stages a row in shared memory up to SMEM_LIMIT;
    a wider row goes to the cluster layout, which `_check` admits."""
    def tables(K, dtype):
        z = torch.zeros((1, K), dtype=dtype)
        return (z, z, torch.zeros((1, K), dtype=torch.int32),
                torch.zeros((1, K), dtype=torch.bool),
                torch.zeros(1, dtype=dtype))

    assert priority_cuda.k3_smem_bytes(4096, 8) == 188_928
    assert priority_cuda.k3_layout(4096, 8) == "block"
    assert priority_cuda.k3_layout(8192, 8) == "cluster"
    # The widest f32 row the block layout stages: 26 K + 256 bytes.
    assert priority_cuda.k3_smem_bytes(8930, 4) <= priority_cuda.SMEM_LIMIT
    assert priority_cuda.k3_smem_bytes(8931, 4) > priority_cuda.SMEM_LIMIT
    assert priority_cuda.k3_layout(8930, 4) == "block"
    assert priority_cuda.k3_layout(8931, 4) == "cluster"
    for K, dtype in ((4096, torch.float64), (8192, torch.float64),
                     (8930, torch.float32), (8931, torch.float32)):
        priority_cuda._check(*tables(K, dtype))


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("K", [100, 128, 256, 300])
def test_k3_wrapper_on_cpu_tensors_is_the_plain_version_at_either_layout(
    K, dtype
):
    dt, _tdt = DTYPES[dtype]
    t = _cast(_tables(np.random.default_rng(K), R=16, K=K), dt)
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in _alloc_args(t)]
    dense_cuda.reset_launches()
    plain = tp._alloc_banded(*args, 4)
    gets, totals = priority_cuda.alloc_banded_k3(*args, 4, totals=True)
    assert torch.equal(priority_cuda.alloc_banded_k3(*args, 4), plain)
    assert torch.equal(gets, plain)
    assert torch.equal(totals, rowsum(plain))
    assert dense_cuda.LAUNCHES["k3"] == 0


def test_ptxas_report_is_read_per_kernel_entry():
    text = (
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_Z4warpIfLi8EE' for "
        "'sm_90a'\n"
        "ptxas info    : Function properties for _Z4warpIfLi8EE\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
        "loads\n"
        "ptxas info    : Used 56 registers, used 0 barriers, 436 bytes "
        "cmem[0]\n"
        "ptxas info    : Compiling entry function '_Z5blockIdE' for "
        "'sm_90a'\n"
        "    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill "
        "loads\n"
        "ptxas info    : Used 40 registers, 436 bytes cmem[0]\n"
    )
    assert dense_cuda.ptxas_usage(text) == {
        "_Z4warpIfLi8EE": {"registers": 56, "spill_stores": 0,
                           "spill_loads": 0},
        "_Z5blockIdE": {"registers": 40, "spill_stores": 12,
                        "spill_loads": 16},
    }
