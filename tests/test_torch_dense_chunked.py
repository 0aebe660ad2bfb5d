"""The port's chunked solve (solver.dense.solve_chunked, the wide
resources' two-level layout) on the CPU.

  * tests/test_dense_chunked.py's three cases on the port: one chunk per
    resource equals the dense solve exactly; a resource over several
    chunk rows against the numpy oracle for each lane kind, the
    portfolio kinds 5-8 added (MAX_MIN_FAIR, BALANCED_FAIRNESS and
    PROPORTIONAL_FAIRNESS carry AlgoKind values 7-9); a learning
    segment replays has;
  * the port's solve_chunked against the JAX package's on the same
    seeded inputs, at f64 and f32: bit-identical. Both add a chunk row
    left to right at these widths (up to SEQUENTIAL_ROW_MAX lanes; XLA's
    CPU row reduction does too) and a segment's row totals in row order
    from 0 (XLA's sorted segment_sum on the CPU is a scatter-add in
    index order; torch.segment_reduce adds each segment in order), and
    every elementwise expression is the same.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401

from doorman_tpu.solver.dense import ChunkedDenseBatch as JChunked
from doorman_tpu.solver.dense import solve_chunked_jit
from doorman_tpu_torch.algorithms.tick import oracle_row
from doorman_tpu_torch.solver.dense import (
    ChunkedDenseBatch,
    DenseBatch,
    chunked_reduces,
    solve_chunked,
    solve_dense,
)

# Every lane kind the chunked solve carries (AlgoKind values).
LANE_KINDS = (0, 1, 2, 3, 4, 7, 8, 9)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def random_dense(rng, R=16, K=8):
    n = rng.integers(1, K + 1, R)
    act = np.arange(K)[None, :] < n[:, None]
    wants = rng.random((R, K)) * 100 * act
    has = rng.random((R, K)) * 50 * act
    sub = (rng.integers(1, 4, (R, K)) * act).astype(np.float64)
    cap = rng.random(R) * 400 + 10
    kind = rng.choice(np.array(LANE_KINDS, np.int32), R)
    statc = rng.random(R) * 40
    learning = np.zeros(R, bool)
    return wants, has, sub, act, cap, kind, learning, statc


def test_single_chunk_matches_dense_exactly():
    rng = np.random.default_rng(5)
    wants, has, sub, act, cap, kind, learning, statc = random_dense(rng)
    fields = dict(
        wants=_t(wants), has=_t(has), subclients=_t(sub), active=_t(act),
        capacity=_t(cap), algo_kind=_t(kind), learning=_t(learning),
        static_capacity=_t(statc),
    )
    a = solve_dense(DenseBatch(**fields))
    b = solve_chunked(ChunkedDenseBatch(
        row_seg=torch.arange(16, dtype=torch.int32), **fields
    ))
    assert torch.equal(a, b)


@pytest.mark.parametrize("kind", LANE_KINDS)
def test_multi_chunk_matches_oracle(kind):
    """One resource of 37 clients over 5 chunk rows of width 8, plus a
    padding row mapped to a padding segment. rtol 1e-9 / atol 1e-12 at
    f64: the oracle adds its clients in another order."""
    rng = np.random.default_rng(kind + 10)
    n, K = 37, 8
    R = 6  # 5 data rows + 1 padding row
    wants_f = rng.random(n) * 100
    has_f = rng.random(n) * 50
    sub_f = rng.integers(1, 4, n).astype(float)
    cap = 600.0
    statc = 30.0
    wants = np.zeros((R, K))
    has = np.zeros((R, K))
    sub = np.zeros((R, K))
    act = np.zeros((R, K), bool)
    rows = np.arange(n) // K
    lanes = np.arange(n) % K
    wants[rows, lanes] = wants_f
    has[rows, lanes] = has_f
    sub[rows, lanes] = sub_f
    act[rows, lanes] = True
    batch = ChunkedDenseBatch(
        wants=_t(wants), has=_t(has), subclients=_t(sub), active=_t(act),
        row_seg=_t(np.array([0, 0, 0, 0, 0, 1], np.int32)),
        capacity=_t(np.array([cap, 0.0])),
        algo_kind=_t(np.array([kind, 0], np.int32)),
        learning=_t(np.zeros(2, bool)),
        static_capacity=_t(np.array([statc, 0.0])),
    )
    gets = solve_chunked(batch).numpy()
    expected = oracle_row(kind, cap, statc, wants_f, has_f, sub_f)
    np.testing.assert_allclose(
        gets[rows, lanes], expected, rtol=1e-9, atol=1e-12
    )
    # Padding row and inactive lanes produce zeros.
    assert (gets[5] == 0).all()
    assert gets[4, 5:].sum() == 0


def test_learning_segment_replays_has():
    rng = np.random.default_rng(2)
    wants, has, sub, act, cap, kind, _, statc = random_dense(rng, R=4)
    learning = np.array([True, False, True, False])
    batch = ChunkedDenseBatch(
        wants=_t(wants), has=_t(has), subclients=_t(sub), active=_t(act),
        row_seg=torch.arange(4, dtype=torch.int32), capacity=_t(cap),
        algo_kind=_t(kind), learning=_t(learning), static_capacity=_t(statc),
    )
    gets = solve_chunked(batch).numpy()
    np.testing.assert_array_equal(gets[0], has[0] * act[0])
    np.testing.assert_array_equal(gets[2], has[2] * act[2])


def _segmented_tables(rng, dt, K):
    """Eight segments of 1-6 chunk rows each, every lane kind once, one
    learning segment, and three padding rows on a padding segment."""
    n_chunks = rng.integers(1, 7, len(LANE_KINDS))
    row_seg = np.concatenate([
        np.repeat(np.arange(len(LANE_KINDS)), n_chunks),
        np.full(3, len(LANE_KINDS)),
    ]).astype(np.int32)
    R, S = len(row_seg), len(LANE_KINDS) + 1
    act = rng.random((R, K)) < 0.85
    act[row_seg == S - 1] = False
    wants = rng.integers(0, 100, (R, K)) * act
    has = rng.random((R, K)) * 60 * act
    sub = rng.integers(1, 4, (R, K)) * act
    per_seg = np.bincount(row_seg, weights=act.sum(1), minlength=S)
    # Half the segments overloaded, half fitting.
    cap = per_seg * np.where(np.arange(S) % 2, 20.0, 70.0) + 5
    cap[-1] = 0.0
    kind = np.array(LANE_KINDS + (0,), np.int32)
    learning = np.zeros(S, bool)
    learning[3] = True
    statc = rng.random(S) * 40
    f = dict(wants=wants, has=has, subclients=sub, capacity=cap,
             static_capacity=statc)
    out = {k: v.astype(dt) for k, v in f.items()}
    out.update(active=act, row_seg=row_seg, algo_kind=kind, learning=learning)
    return out


@pytest.mark.parametrize("K", [8, 32])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_solve_chunked_matches_the_reference_bit_for_bit(seed, dtype, K):
    dt = np.float64 if dtype == "f64" else np.float32
    t = _segmented_tables(np.random.default_rng(seed), dt, K)
    ref = np.asarray(solve_chunked_jit(
        JChunked(**{k: jnp.asarray(v) for k, v in t.items()})
    ))
    got = solve_chunked(ChunkedDenseBatch(
        **{k: _t(v) for k, v in t.items()}
    )).numpy()
    assert got.dtype == dt
    np.testing.assert_array_equal(got, ref)
    # The lengths the resident solver passes give the same bits.
    lengths = torch.bincount(_t(t["row_seg"]).long(), minlength=9)
    again = solve_chunked(ChunkedDenseBatch(
        lengths=lengths, **{k: _t(v) for k, v in t.items()}
    ))
    assert torch.equal(again, torch.from_numpy(got))


def test_chunked_segment_sum_adds_row_totals_in_row_order():
    """The segment sum is the left-to-right sum of each segment's row
    totals from 0; an empty segment sums to 0 and maxes to -inf."""
    v = torch.tensor([[1e16], [1.0], [-1e16], [3.0], [5.0]],
                     dtype=torch.float64)
    row_seg = torch.tensor([0, 0, 0, 2, 2])
    segsum, segmax = chunked_reduces(row_seg, 3)
    assert segsum(v).tolist() == [0.0, 0.0, 8.0]
    assert segmax(v).tolist() == [1e16, float("-inf"), 5.0]
