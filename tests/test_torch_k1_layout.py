"""K1/K2's two layouts on the CPU: the order in which the warp-per-row
layout adds, held against the JAX package, and the choice of layout.

K1 and K2 (csrc/dense_solve.cu) run rows of up to 256 lanes as one warp
per row: lane l holds elements l + 32 v for v < V (V = ceil(K / 32)
rounded up to 1, 2, 4 or 8), reduces its own V values left to right,
then the warp reduces across lanes with an xor butterfly (offsets 16, 8,
4, 2, 1). Wider rows keep the block-per-row layout. The card alone runs
the kernels; here `warp_solve_dense` is the plain lane solve with every
row sum taken in that order (`warp_rowsum`, shared with K3's test) and
every row max too (`warp_rowmax`). It is held against doorman_tpu's
`solve_dense` (plain XLA on the CPU) and `solve_dense_pallas` in
interpret mode on seeded tables at the widths the warp layout takes,
and K2's epilogue in that order against `fused_tick_pallas` in
interpret mode, so the new order is shown not to move the grants beyond
F32_PARITY_REL_BOUND (f32) / 1e-12 (f64) of max(capacity, max wants),
the port's existing bounds.
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
from doorman_tpu.solver.pallas_dense import fused_tick_pallas, solve_dense_pallas
from doorman_tpu_torch.algorithms.tick import F32_PARITY_REL_BOUND
from doorman_tpu_torch.solver import dense_cuda
from doorman_tpu_torch.solver.carry import tables_from_numpy
from doorman_tpu_torch.solver.dense import (
    delivered_delta,
    fused_tick_plain,
    solve_dense,
)
from doorman_tpu_torch.solver.lanes import expand_rows, solve_lanes
from tests.test_torch_k3_layout import _lanes_per_thread, warp_rowsum

DTYPES = {"f64": (np.float64, torch.float64), "f32": (np.float32, torch.float32)}
WARP_WIDTHS = [8, 100, 128, 256]
SEEDS = [0, 1, 2]
# Every lane kind, and one (5) without a lane here, which solves to 0.
KINDS = np.array([0, 1, 2, 3, 4, 5, 7, 8, 9], np.int32)
_j_solve = jax.jit(j_solve_dense)


def warp_rowmax(x: torch.Tensor) -> torch.Tensor:
    """Per-row max of [R, K] in the warp layout's order: each lane's
    left-to-right max over its elements l + 32 v starting from -inf
    (lanes past K hold -inf), then the xor butterfly."""
    R, K = x.shape
    V = _lanes_per_thread(K)
    padded = torch.full((R, 32 * V), float("-inf"), dtype=x.dtype)
    padded[:, :K] = x
    parts = padded.view(R, V, 32)
    acc = torch.full((R, 32), float("-inf"), dtype=x.dtype)
    for v in range(V):
        acc = torch.maximum(acc, parts[:, v])
    lane = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        acc = torch.maximum(acc, acc[:, lane ^ o])
    return acc[:, 0]


def warp_solve_dense(batch) -> torch.Tensor:
    """solver.dense.solve_dense with its row sums and maxes in the warp
    layout's order."""
    return solve_lanes(
        batch.wants, batch.has, batch.subclients, batch.active,
        batch.capacity, batch.algo_kind, batch.learning,
        batch.static_capacity, segsum=warp_rowsum, segmax=warp_rowmax,
        expand=expand_rows,
    )


def _tables(rng, R, K, integer=False):
    """Seeded lane tables: every kind, capacities that leave rows both
    fitting and overflowing, about one learning row in ten, row 0
    wholly inactive and row 1 full."""
    n = rng.integers(1, K + 1, R)
    n[1] = K
    act = np.arange(K)[None, :] < n[:, None]
    act[0] = False
    if integer:
        wants = rng.integers(0, 100, (R, K)).astype(np.float64)
        has = rng.integers(0, 50, (R, K)).astype(np.float64)
    else:
        wants = rng.random((R, K)) * 100
        has = rng.random((R, K)) * 50
    sub = rng.integers(1, 4, (R, K)).astype(np.float64)
    cap = np.floor(rng.random(R) * 80 * n) + 5
    kind = KINDS[(np.arange(R) + rng.integers(0, len(KINDS))) % len(KINDS)]
    learn = rng.random(R) < 0.1
    statc = rng.integers(1, 60, R).astype(np.float64)
    return wants * act, has * act, sub * act, act, cap, kind, learn, statc


def _jbatch(tabs, np_dtype):
    w, h, s, act, cap, kind, learn, statc = tabs
    f = lambda x: jnp.asarray(x.astype(np_dtype))  # noqa: E731
    return JBatch(
        wants=f(w), has=f(h), subclients=f(s), active=jnp.asarray(act),
        capacity=f(cap), algo_kind=jnp.asarray(kind),
        learning=jnp.asarray(learn), static_capacity=f(statc),
    )


def _rel(got, want, tabs):
    scale = np.maximum(tabs[4], tabs[0].max(axis=1))[:, None]
    return (np.abs(got.astype(np.float64) - want.astype(np.float64))
            / scale).max()


def _bound(dtype):
    return 1e-12 if dtype == "f64" else F32_PARITY_REL_BOUND


@pytest.mark.parametrize("K", WARP_WIDTHS)
def test_warp_rowmax_leaves_one_value_on_every_lane(K):
    x = torch.from_numpy(np.random.default_rng(K).random((16, K)) * 100)
    V = _lanes_per_thread(K)
    padded = torch.full((16, 32 * V), float("-inf"), dtype=x.dtype)
    padded[:, :K] = x
    acc = padded.view(16, V, 32).amax(1)
    lane = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        acc = torch.maximum(acc, acc[:, lane ^ o])
    assert (acc == acc[:, :1]).all()
    assert torch.equal(warp_rowmax(x), x.amax(1))


@pytest.mark.parametrize("ref", ["xla", "pallas"])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("K", WARP_WIDTHS)
def test_warp_order_lane_solve_matches_the_reference(K, seed, dtype, ref):
    np_dtype, t_dtype = DTYPES[dtype]
    tabs = _tables(np.random.default_rng(seed), R=27, K=K)
    jb = _jbatch(tabs, np_dtype)
    want = np.asarray(
        _j_solve(jb) if ref == "xla" else solve_dense_pallas(jb, interpret=True)
    )
    batch = tables_from_numpy(*tabs, device="cpu", dtype=t_dtype)[0]
    got = warp_solve_dense(batch).numpy()
    assert got.dtype == np_dtype
    assert _rel(got, want, tabs) <= _bound(dtype)
    assert _rel(got, solve_dense(batch).numpy(), tabs) <= _bound(dtype)
    assert (got[0] == 0).all() and (got[~tabs[3]] == 0).all()
    # The table has rows of every kind, fitting and overflowing.
    over = (tabs[0].sum(1) > tabs[4])
    assert set(KINDS) == set(tabs[5].tolist())
    assert over.any() and not over.all()


@pytest.mark.parametrize("dtype,prev", [
    ("f32", "f32"), ("f32", "bf16"), ("f64", "f64"), ("f64", "bf16"),
])
@pytest.mark.parametrize("K", WARP_WIDTHS)
def test_warp_order_k2_epilogue_matches_pallas(K, dtype, prev):
    """changed and prev_new from grants in the warp order against
    fused_tick_pallas (interpret mode), exact on every row whose grants
    agree bit for bit — integer demand keeps most sums exact in any
    order — and the grants within the parity bound on every row."""
    np_dtype, t_dtype = DTYPES[dtype]
    p_torch = torch.bfloat16 if prev == "bf16" else t_dtype
    p_jax = jnp.bfloat16 if prev == "bf16" else np_dtype
    rng = np.random.default_rng(40 + K)
    tabs = _tables(rng, R=27, K=K, integer=True)
    jb = _jbatch(tabs, np_dtype)
    k1 = np.asarray(solve_dense_pallas(jb, interpret=True)).astype(np.float64)
    prev_np = rng.integers(0, 30, k1.shape).astype(np.float64)
    prev_np[::3] = k1[::3]  # delivered rows among them stay unchanged
    deliv = rng.random(k1.shape[0]) < 0.6
    jgets, jprev, jchanged = fused_tick_pallas(
        jb, jnp.asarray(prev_np).astype(p_jax),
        jnp.asarray(deliv.astype(np_dtype)), interpret=True,
    )
    jgets = np.asarray(jgets)
    jprev = np.asarray(jprev.astype(jnp.float64))
    jchanged = np.asarray(jchanged)

    batch, prev_t = tables_from_numpy(
        *tabs, prev_np, device="cpu", dtype=t_dtype, prev_dtype=p_torch,
    )
    gets = warp_solve_dense(batch)
    prev_new, changed = delivered_delta(gets, prev_t, torch.from_numpy(deliv))
    assert _rel(gets.numpy(), jgets, tabs) <= _bound(dtype)
    same = (gets.numpy() == jgets).all(axis=1)
    assert same.sum() >= len(same) * 3 // 4
    np.testing.assert_array_equal(changed.numpy()[same], jchanged[same])
    np.testing.assert_array_equal(prev_new.double().numpy()[same], jprev[same])
    assert changed.any() and not changed.all()


@pytest.mark.parametrize("K", [1, 8, 32, 100, 128, 255, 256, 257, 4096])
def test_k1_layout_is_warp_up_to_256_lanes_and_block_above(K):
    assert dense_cuda.k1_layout(K) == ("warp" if K <= 256 else "block")
    # One bound for every kernel's two layouts.
    assert dense_cuda.k1_layout(K) == (
        "warp" if K <= dense_cuda.WARP_MAX_K else "block")


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("K", [128, 300])
def test_k1_k2_wrappers_on_cpu_tensors_are_the_plain_version(K, dtype):
    _np_dtype, t_dtype = DTYPES[dtype]
    rng = np.random.default_rng(K)
    tabs = _tables(rng, R=18, K=K)
    prev_np = rng.integers(0, 30, (18, K)).astype(np.float64)
    batch, prev = tables_from_numpy(
        *tabs, prev_np, device="cpu", dtype=t_dtype,
    )
    deliv = torch.from_numpy(rng.random(18) < 0.5)
    dense_cuda.reset_launches()
    plain = solve_dense(batch)
    assert torch.equal(dense_cuda.solve_dense_k1(batch), plain)
    rows = torch.tensor([5, 0, 17, 5], dtype=torch.int32)
    assert torch.equal(dense_cuda.solve_dense_k1(batch, rows=rows),
                       plain[rows.long()])
    for got, want in zip(dense_cuda.fused_tick_k2(batch, prev, deliv),
                         fused_tick_plain(batch, prev, deliv)):
        assert torch.equal(got, want)
    assert dense_cuda.LAUNCHES == {"k1": 0, "k2": 0, "k3": 0}


def test_ptxas_report_names_every_layout_of_every_kernel():
    entries = {
        "_ZN12_GLOBAL__N_118dense_solve_kernelIffLb0EEEvNS_6InputsEPKiPT_"
        "PKT0_PKhPS6_Phi": "K1 block f32",
        "_ZN12_GLOBAL__N_118dense_solve_kernelId13__nv_bfloat16Lb1EEEvNS_6"
        "InputsEPKiPT_PKT0_PKhPS7_Phi": "K2 block f64/bf16",
        "_ZN12_GLOBAL__N_123dense_solve_warp_kernelIddLb0ELi8EEEvNS_6Inputs"
        "EPKiPT_PKT0_PKhPS6_Phii": "K1 warp f64 V=8",
        "_ZN12_GLOBAL__N_123dense_solve_warp_kernelIffLb1ELi4EEEvNS_6Inputs"
        "EPKiPT_PKT0_PKhPS6_Phii": "K2 warp f32/f32 V=4",
        "_ZN12_GLOBAL__N_123dense_solve_warp_kernelIfDF16bLb1ELi1EEEvNS_6"
        "InputsEPKiPT_PKT0_PKhPS7_Phii": "K2 warp f32/bf16 V=1",
        "_ZN12_GLOBAL__N_123banded_fill_warp_kernelIfLi2EEEvPKT_S3_PKiPKhS3_"
        "PS1_S8_iii": "K3 warp f32 V=2",
        "_ZN12_GLOBAL__N_118banded_fill_kernelIdEEvPKT_S3_PKiPKhS3_PS1_S8_ii"
        "i": "K3 block f64",
    }
    text = "ptxas info    : 0 bytes gmem\n"
    for i, e in enumerate(entries):
        text += (
            f"ptxas info    : Compiling entry function '{e}' for 'sm_90a'\n"
            f"ptxas info    : Function properties for {e}\n"
            f"    0 bytes stack frame, {i} bytes spill stores, 0 bytes "
            "spill loads\n"
            f"ptxas info    : Used {40 + i} registers, 436 bytes cmem[0]\n"
        )
    usage = dense_cuda.ptxas_usage(text)
    assert list(usage) == list(entries)
    for i, (e, label) in enumerate(entries.items()):
        assert dense_cuda.entry_label(e) == label
        assert usage[e] == {"registers": 40 + i, "spill_stores": i,
                            "spill_loads": 0}
    assert dense_cuda.entry_label("_Z6helperv") is None
