"""K3's cluster layout on the CPU: its plan, and the order in which it
adds, held against the plain version and the JAX package.

K3 (csrc/dense_solve.cu `banded_fill_cluster_kernel`) runs a row wider
than shared memory as one cluster of C blocks of T threads
(`priority_cuda.k3_cluster_plan`). Block r owns the lanes [r * chunk,
(r + 1) * chunk) of the row (chunk = `k3_cluster_chunk(K, C)`, lanes
past K never visited), and every sum runs in one fixed order: each
thread adds its own lanes r * chunk + t, + T, ... left to right from 0,
the warp adds across its 32 lanes with an xor butterfly (offsets 16, 8,
4, 2, 1), the warp partials are added in warp order, and the block
partials in rank order 0..C-1. The bisection decides three steps a pass
from the sums at the seven midpoints those steps can form, and the
grants are written once, from each band's (fits, level). The card alone
runs the kernel; here `cluster_rowsum` repeats that order in PyTorch and
`cluster_alloc_banded` the kernel's band loop with every row sum taken
in it, at small widths, C and T. Both it and a grouped `solve_priority`
whose every evaluation uses it are held against the plain version and
doorman_tpu's `_alloc_banded` / `solve_priority` (plain XLA on the CPU)
on seeded tables: the banded fill within F32_PARITY_REL_BOUND (f32) /
1e-12 (f64) of max(capacity, max wants), the theta bisection within
1e-5 (f32) / 1e-9 (f64) of capacity — the bounds the other layouts'
orders meet.
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
    bisect_iters,
    expand_rows,
    rowmax,
    waterfill_level,
)
from tests.test_torch_k3_global import global_alloc_banded, global_rowsum
from tests.test_torch_k3_layout import (
    DTYPES,
    _alloc_args,
    _cast,
    _row_scale,
    _tables,
)

# (K, C, T): several blocks of several warps; a last block with one lane
# (129 over 2 blocks of 128); more blocks than the row has chunks (300
# over 16: blocks 3-15 own no lane); one block (the global layout's
# order).
ORDERS = [(300, 4, 64), (1000, 8, 64), (2000, 16, 32), (129, 2, 96),
          (300, 16, 32), (1000, 1, 128)]
SEEDS = [0, 1, 2]


def cluster_rowsum(x: torch.Tensor, C: int, T: int) -> torch.Tensor:
    """Per-row sum of [R, K] in the cluster layout's order, C blocks of
    T threads. Lanes past K enter as zeros, which leave every partial as
    it is (a partial that starts at +0 is never -0)."""
    R, K = x.shape
    chunk = priority_cuda.k3_cluster_chunk(K, C)
    n = -(-chunk // T)
    row = torch.zeros((R, C * chunk), dtype=x.dtype)
    row[:, :K] = x
    blocks = torch.zeros((R, C, n * T), dtype=x.dtype)
    blocks[:, :, :chunk] = row.view(R, C, chunk)
    parts = blocks.view(R, C, n, T)
    acc = torch.zeros((R, C, T), dtype=x.dtype)
    for i in range(n):
        acc = acc + parts[:, :, i]
    lane = torch.arange(T)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[:, :, lane ^ o]
    block = acc[:, :, 0]
    for w in range(1, T // 32):
        block = block + acc[:, :, 32 * w]
    total = block[:, 0]
    for r in range(1, C):
        total = total + block[:, r]
    return total


def cluster_level(w, wt, m, cap, rsum):
    """The kernel's water level of a band that overflows `cap`: the max
    ratio, the bisection three steps a pass (the sums at the seven
    midpoints p[1..7] between p[0] = lo and p[8] = hi, then the three
    steps taken from them), the two snaps."""
    dt = w.dtype
    zero = torch.zeros((), dtype=dt)
    tiny = torch.tensor(torch.finfo(dt).tiny, dtype=dt)
    ratio = torch.where(wt > 0, w / torch.maximum(wt, tiny), zero)
    max_ratio = rowmax(torch.where(m, ratio, torch.tensor(-np.inf, dtype=dt)))
    max_ratio = torch.where(torch.isfinite(max_ratio), max_ratio, zero)
    lo = torch.zeros_like(cap)
    hi = torch.maximum(max_ratio, zero)
    iters = bisect_iters(dt)
    assert iters % 3 == 0
    rows = torch.arange(w.shape[0])
    for _ in range(iters // 3):
        p = [lo] + [None] * 7 + [hi]
        for h in (4, 2, 1):
            for i in range(h, 8, 2 * h):
                p[i] = (p[i - h] + p[i + h]) * 0.5
        pts = torch.stack(p, 1)  # [R, 9]
        sums = torch.stack(
            [rsum(torch.minimum(w, expand_rows(p[k]) * wt))
             for k in range(1, 8)], 1)  # [R, 7]
        i = torch.full_like(rows, 4)
        for h in (4, 2, 1):
            need_more = sums[rows, i - 1] < cap
            at = pts[rows, i]
            lo = torch.where(need_more, at, lo)
            hi = torch.where(need_more, hi, at)
            i = i + torch.where(need_more, h // 2, -(h // 2))
    level = hi
    for _ in range(2):
        sat = w <= expand_rows(level) * wt
        sat_w = rsum(torch.where(sat, w, zero))
        unsat = rsum(torch.where(sat, zero, wt))
        exact = torch.where(unsat > 0,
                            (cap - sat_w) / torch.maximum(unsat, tiny), level)
        level = torch.maximum(exact, zero)
    return level


def cluster_alloc_banded(wants, weights, band, active, capacity, num_bands,
                         C, T):
    """The kernel's band loop with its row sums in the cluster layout's
    order: per band the sum (and max ratio), for a band that overflows
    the level and the taken share (a band that fits takes its band sum),
    then every grant written once from its band's (fits, level)."""
    zero = torch.zeros((), dtype=wants.dtype)

    def rsum(v):
        return cluster_rowsum(v, C, T)

    remaining = capacity
    bands = []
    for rank in range(num_bands):
        m = active & (band == rank)
        w = torch.where(m, wants, zero)
        wt = torch.where(m, weights, zero)
        sumw = rsum(w)
        fits = sumw <= remaining
        level = torch.where(fits, zero,
                            cluster_level(w, wt, m, remaining, rsum))
        share = torch.where(m, torch.minimum(w, expand_rows(level) * wt), zero)
        taken = torch.where(fits, sumw, rsum(share))
        remaining = torch.maximum(remaining - taken, zero)
        bands.append((m, fits, level))
    gets = torch.zeros_like(wants)
    for m, fits, level in bands:
        share = torch.where(expand_rows(fits), wants,
                            torch.minimum(wants, expand_rows(level) * weights))
        gets = torch.where(m, share, gets)
    return gets


@pytest.mark.parametrize("K,C,T", ORDERS)
def test_cluster_rowsum_order(K, C, T):
    """Within rounding of torch's sum; one block adds as the global
    layout adds; every block's butterfly leaves one value on its warp."""
    x = torch.from_numpy(np.random.default_rng(K + C).random((8, K)) * 100)
    got = cluster_rowsum(x, C, T)
    np.testing.assert_allclose(got, x.sum(1), rtol=1e-13)
    assert torch.equal(cluster_rowsum(x, 1, T), global_rowsum(x, T))
    chunk = priority_cuda.k3_cluster_chunk(K, C)
    assert C * chunk >= K and chunk % priority_cuda.CLUSTER_ALIGN == 0
    # Block r's partial is the global order over its chunk alone.
    row = torch.zeros((8, C * chunk), dtype=x.dtype)
    row[:, :K] = x
    parts = [global_rowsum(row[:, r * chunk:(r + 1) * chunk], T)
             for r in range(C)]
    want = parts[0]
    for p in parts[1:]:
        want = want + p
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("seed", SEEDS)
def test_three_steps_a_pass_equal_the_binary_search(seed, dtype):
    """The seven midpoints of a pass are the binary search's own
    (lo + hi) * 0.5 values, so the kernel's level equals the plain level
    finder's, bit for bit, with the same sums."""
    dt, _tdt = DTYPES[dtype]
    K, C, T = 1000, 8, 64
    t = _cast(_tables(np.random.default_rng(50 + seed), R=16, K=K), dt)
    wants, weights, band, active, cap = (
        torch.from_numpy(np.ascontiguousarray(a)) for a in _alloc_args(t))
    m = active & (band == 0)
    zero = torch.zeros((), dtype=wants.dtype)
    w = torch.where(m, wants, zero)
    wt = torch.where(m, weights, zero)
    cap = cap * 0.2  # every row with members overflows

    def rsum(v):
        return cluster_rowsum(v, C, T)

    over = rsum(w) > cap
    assert int(over.sum()) >= 10
    got = cluster_level(w, wt, m, cap, rsum)
    want = waterfill_level(w, wt, m, cap, rsum, rowmax, expand_rows)
    assert torch.equal(got[over], want[over])


@pytest.mark.parametrize("bands", [1, 4])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("K,C,T", ORDERS)
def test_cluster_order_banded_fill_matches_the_reference(K, C, T, seed,
                                                         dtype, bands):
    dt, _tdt = DTYPES[dtype]
    t = _cast(_tables(np.random.default_rng(seed), R=16, K=K), dt)
    args = _alloc_args(t)
    ref = np.asarray(jp._alloc_banded(*(jnp.asarray(a) for a in args), bands))
    targs = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    got = cluster_alloc_banded(*targs, bands, C, T).numpy()
    plain = tp._alloc_banded(*targs, bands).numpy()
    assert got.dtype == dt
    bound = 1e-12 if dtype == "f64" else F32_PARITY_REL_BOUND
    scale = _row_scale(t)
    assert (np.abs(got.astype(np.float64) - ref) / scale).max() <= bound
    assert (np.abs(got.astype(np.float64) - plain) / scale).max() <= bound
    assert (got[0] == 0).all() and (got[1] == 0).all()
    assert (got[~t["active"]] == 0).all()
    if bands == 1:
        assert (got[t["band"] != 0] == 0).all()


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("K,T", [(300, 64), (1000, 128)])
def test_one_block_cluster_is_the_global_layout(K, T, dtype):
    """C = 1: the same sums in the same order as the global layout, the
    bisection's three steps a pass equal to its one, and a grant written
    once equal to one accumulated over the bands (0 + share == share)."""
    dt, _tdt = DTYPES[dtype]
    t = _cast(_tables(np.random.default_rng(K), R=16, K=K), dt)
    targs = [torch.from_numpy(np.ascontiguousarray(a)) for a in _alloc_args(t)]
    assert torch.equal(cluster_alloc_banded(*targs, 4, 1, T),
                       global_alloc_banded(*targs, 4, T))


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("seed", SEEDS)
def test_cluster_order_grouped_solve_matches_the_reference(
    seed, dtype, monkeypatch
):
    """solve_priority with every banded evaluation in the cluster order
    (through the K3 wrapper's seam, one call per evaluation, as one
    launch each on the card) against the JAX package's grouped solve."""
    dt, tdt = DTYPES[dtype]
    K, C, T = 300, 4, 32
    t = _cast(_tables(np.random.default_rng(300 + seed), R=24, K=K), dt)
    calls = []

    def cluster_k3(wants, weights, band, active, eff_cap, num_bands,
                   totals=False):
        calls.append(1)
        gets = cluster_alloc_banded(wants, weights, band, active, eff_cap,
                                    num_bands, C, T)
        return (gets, cluster_rowsum(gets, C, T)) if totals else gets

    monkeypatch.setattr(priority_cuda, "alloc_banded_k3", cluster_k3)
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


# (K, itemsize, rows, C, staged): the first cluster bucket at each item
# size, the wide priority cell's 131,072 and one 1,048,576-lane row, at
# one row, at a few and at many, on a card of 132 SMs holding one block
# an SM.
PLANS = [
    (16_384, 4, 1, 16, True), (16_384, 4, 32, 4, True),
    (16_384, 4, 1000, 3, True), (131_072, 4, 8, 16, True),
    (131_072, 4, 32, 8, True), (1_048_576, 4, 1, 16, False),
    (1_048_576, 4, 32, 4, False), (8_192, 8, 1, 16, True),
    (8_192, 8, 32, 4, True), (131_072, 8, 8, 16, True),
    (1_048_576, 8, 1, 16, False),
]


def _cost(K, C, rows, held):
    return -(-rows // held) * priority_cuda.k3_cluster_chunk(K, C)


@pytest.mark.parametrize("K,itemsize,rows,C,staged", PLANS)
def test_k3_cluster_plan(K, itemsize, rows, C, staged):
    """Of the cluster sizes up to 16 whose blocks can stage their chunk
    (wants and weights as T and a band byte a lane, after the reduction
    scratch) — of all where none can — the fewest lanes a block times
    waves of `rows` clusters, the fewer blocks on a tie."""
    assert priority_cuda.k3_layout(K, itemsize) == "cluster"
    smem = priority_cuda.k3_cluster_smem_bytes(K, C, staged, itemsize)
    assert priority_cuda.k3_cluster_plan(K, itemsize, 4, rows, 132) == (
        C, staged, smem)
    red = priority_cuda.CLUSTER_RED_SLOTS * itemsize
    chunk = priority_cuda.k3_cluster_chunk(K, C)
    assert smem == (red + chunk * (2 * itemsize + 1) if staged else red)
    assert smem <= priority_cuda.SMEM_LIMIT
    for c in range(1, 17):
        fits = priority_cuda.k3_cluster_smem_bytes(
            K, c, True, itemsize) <= priority_cuda.SMEM_LIMIT
        assert fits <= staged  # staged wherever any size stages
        if fits == staged:
            assert (_cost(K, c, rows, 132 // c), c) >= (
                _cost(K, C, rows, 132 // C), C)
    # The reduction scratch: the warp partials, two parity slots and the
    # result, seven values each.
    warps = priority_cuda.CLUSTER_THREADS // 32
    assert priority_cuda.CLUSTER_RED_SLOTS >= (warps + 3) * 7
    # Band ranks past a byte: read from global memory at any width.
    C2, staged2, smem2 = priority_cuda.k3_cluster_plan(K, itemsize, 256, rows,
                                                       132)
    assert not staged2 and smem2 == red
    assert all((_cost(K, c, rows, 132 // c), c) >= (
        _cost(K, C2, rows, 132 // C2), C2) for c in range(1, 17))


# Clusters of C blocks an H100 80GB HBM3 holds at once, staged or
# streamed, at 512 threads and one block an SM (cudaOccupancyMaxActive
# Clusters as chip_smoke.py prints it): 7 from 10 blocks up.
H100_HELD = {**{c: 7 for c in range(10, 17)}, 9: 9, 8: 15, 7: 15, 6: 17,
             5: 22, 4: 30, 3: 44, 2: 66, 1: 132}

# (K, itemsize, rows, C, staged) on that card: the wide priority cell's 8
# equal rows in one wave of 9 blocks at f32; at f64 only 10 or more
# blocks stage them, and 16 in two waves do the least a block; one 1M
# row over 16 blocks, 8 of them in one wave of 9.
RESIDENT = [
    (131_072, 4, 8, 9, True), (131_072, 8, 8, 16, True),
    (1_048_576, 4, 1, 16, False), (1_048_576, 4, 8, 9, False),
    (16_384, 4, 8, 9, True),
]


@pytest.mark.parametrize("K,itemsize,rows,C,staged", RESIDENT)
def test_k3_cluster_plan_counts_waves_on_the_card(K, itemsize, rows, C,
                                                  staged):
    """With the card's own count of resident clusters, C minimises the
    lanes a block times the waves the rows take."""
    asked = []

    def resident(c, s):
        asked.append(s)
        return H100_HELD[c]

    plan = priority_cuda.k3_cluster_plan(K, itemsize, 4, rows, 132, resident)
    assert plan == (C, staged, priority_cuda.k3_cluster_smem_bytes(
        K, C, staged, itemsize))
    assert set(asked) == {staged}


def test_k3_cluster_plan_with_no_cluster_resident_takes_the_fewest_blocks():
    """A card that holds no cluster of any size: the plan with the fewest
    blocks, whose launch the wrapper then refuses (it raises when the
    card holds no cluster of the plan)."""
    assert priority_cuda.k3_cluster_plan(
        131_072, 4, 4, 8, 132, lambda c, s: 0)[:2] == (6, True)
    assert priority_cuda.k3_cluster_plan(
        1 << 20, 4, 4, 8, 132, lambda c, s: 0)[:2] == (1, False)


@pytest.mark.parametrize("itemsize,widest", [(4, 411_648), (8, 217_088)])
def test_k3_cluster_plan_stages_up_to_sixteen_chunks(itemsize, widest):
    """16 blocks stage a row while its chunk of ceil(K / 16) lanes,
    rounded to 128, fits beside the scratch: up to 411,648 lanes at f32
    and 217,088 at f64; wider rows stream."""
    assert priority_cuda.k3_cluster_plan(widest, itemsize)[:2] == (16, True)
    assert priority_cuda.k3_cluster_plan(widest + 1, itemsize)[:2] == (
        16, False)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_cluster_widths_on_cpu_tensors_take_the_plain_version(dtype):
    dt, tdt = DTYPES[dtype]
    K = 16_384 if dtype == "f32" else 8_192
    assert priority_cuda.k3_layout(K, torch.empty((), dtype=tdt)
                                   .element_size()) == "cluster"
    t = _cast(_tables(np.random.default_rng(11), R=3, K=K), dt)
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in _alloc_args(t)]
    dense_cuda.reset_launches()
    gets, totals = priority_cuda.alloc_banded_k3(*args, 4, totals=True)
    assert torch.equal(gets, tp._alloc_banded(*args, 4))
    assert dense_cuda.LAUNCHES["k3"] == 0
    assert dense_cuda.K3_LAYOUT_LAUNCHES == {"warp": 0, "block": 0,
                                             "cluster": 0}


@pytest.mark.parametrize("entry,label", [
    ("_ZN12_GLOBAL__N_126banded_fill_cluster_kernelIfLb1EEEvPKT_S3_PKiPKh"
     "S3_PS1_S8_S8_Piii", "K3 cluster f32 staged"),
    ("_ZN12_GLOBAL__N_126banded_fill_cluster_kernelIfLb0EEEvPKT_S3_PKiPKh"
     "S3_PS1_S8_S8_Piii", "K3 cluster f32 streamed"),
    ("_ZN12_GLOBAL__N_126banded_fill_cluster_kernelIdLb1EEEvPKT_S3_PKiPKh"
     "S3_PS1_S8_S8_Piii", "K3 cluster f64 staged"),
    ("_ZN12_GLOBAL__N_126banded_fill_cluster_kernelIdLb0EEEvPKT_S3_PKiPKh"
     "S3_PS1_S8_S8_Piii", "K3 cluster f64 streamed"),
    ("_ZN12_GLOBAL__N_125banded_fill_global_kernelIdEEvPKT_S3_PKiPKhS3_PS1_"
     "S8_ii", "K3 global f64"),
])
def test_ptxas_names_the_cluster_entries(entry, label):
    assert dense_cuda.entry_label(entry) == label
