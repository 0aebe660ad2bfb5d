"""The vectorised reference against the frozen scalar oracles, on tiny
hand-worked lanes and on random rows of every kind, and the gap that
judges the grants."""

import numpy as np
import pytest
import torch

from portbench.reference import judge, oracles, vector

LANE_KINDS = (0, 1, 2, 3)


def _targets(kind, cap, wants, sub=None, active=None):
    wants = np.atleast_2d(np.asarray(wants, np.float64))
    sub = np.ones_like(wants) if sub is None else np.atleast_2d(sub)
    active = np.ones(wants.shape, bool) if active is None else np.atleast_2d(
        active)
    return vector.lane_targets(
        torch.tensor([kind] * len(wants)), torch.tensor(cap, dtype=torch.float64
                                                         ).reshape(-1),
        torch.tensor(wants), torch.tensor(sub, dtype=torch.float64),
        torch.tensor(active)).numpy()


def test_hand_worked_lanes():
    # capacity 100, wants 10 / 50 / 90 (150 in all: overloaded)
    w = [10.0, 50.0, 90.0]
    assert np.allclose(_targets(0, [100.0], w), [w])  # no algorithm
    assert np.allclose(_targets(1, [30.0], w), [[10, 30, 30]])  # static
    # proportional share settles on wants x 100/150
    assert np.allclose(_targets(2, [100.0], w), [[10 / 1.5, 50 / 1.5, 60]])
    # fair share: 10 saturates, the rest split 90 evenly
    assert np.allclose(_targets(3, [100.0], w), [[10, 45, 45]])
    # demand that fits is granted whole on every lane
    for k in LANE_KINDS:
        assert np.allclose(_targets(k, [1000.0], w), [w])


def _settle(kind, cap, wants, sub):
    """The chained lanes' ticks from has 0 until they stop moving."""
    has = np.zeros_like(wants)
    for _ in range(50):
        has = oracles.proportional_snapshot(cap, wants, has)
    return has


@pytest.mark.parametrize("kind", LANE_KINDS)
def test_random_rows_match_oracles(kind):
    rng = np.random.default_rng(kind)
    R, K = 40, 12
    cap = rng.choice([50.0, 300.0, 900.0], R)
    wants = rng.integers(0, 100, (R, K)).astype(np.float64)
    sub = rng.integers(1, 4, (R, K)).astype(np.float64)
    active = rng.random((R, K)) < 0.85
    active[:, 0] = True
    got = _targets(kind, cap, wants, sub, active)
    for r in range(R):
        m = active[r]
        if kind == 2:
            want = _settle(kind, cap[r], wants[r, m], sub[r, m])
        else:
            want = oracles.oracle_row(kind, cap[r], cap[r], wants[r, m],
                                      np.zeros(m.sum()), sub[r, m])
        np.testing.assert_allclose(got[r, m], want, rtol=1e-12, atol=1e-9)
        assert (got[r, ~m] == 0).all()


def test_grant_gap_is_relative_to_the_rows_scale():
    wants = np.array([[10.0, 20.0], [1.0, 2.0]])
    cap = np.array([10.0, 40.0])
    ref = np.array([[5.0, 5.0], [1.0, 2.0]])
    got = ref.copy()
    assert judge.grant_gap(got, ref, wants, cap) == 0.0
    got[0, 0] += 0.2  # 0.2 of a row whose largest wants are 20
    assert judge.grant_gap(got, ref, wants, cap) == pytest.approx(0.01)
    got[1, 1] += 0.2  # 0.2 of a row whose capacity is 40
    assert judge.grant_gap(got, ref, wants, cap) == pytest.approx(0.01)
    got[1, 1] += 0.4
    assert judge.grant_gap(got, ref, wants, cap) == pytest.approx(0.015)
    got[1, 0] = np.nan  # a lease that never came back
    assert judge.grant_gap(got, ref, wants, cap) == np.inf


def test_leases_off_counts_missing_doubled_and_changed():
    sent = np.array([1.0, 2.0, 3.0, 4.0])
    assert judge.leases_off(np.ones(4, np.int64), sent.copy(), sent) == 0
    found = np.array([1, 0, 2, 1])
    stored = np.array([1.0, np.nan, 3.0, 4.5])
    assert judge.leases_off(found, stored, sent) == 3


def test_bfloat16_control_is_caught():
    """At the cell's shape: 1,000 clients wanting 15 +- 5 of a capacity
    of 5,000."""
    rng = np.random.default_rng(3)
    R, K = 8, 1000
    kind = np.full(R, 2)
    cap = np.full(R, 5000.0)
    wants = 15.0 + 5.0 * rng.uniform(-1.0, 1.0, (R, K))
    sub = np.ones_like(wants)
    ref = judge.lane_reference(kind, cap, wants, sub)
    low = judge.lane_reference(kind, cap, wants, sub, dtype=torch.bfloat16)
    f32 = judge.lane_reference(kind, cap, wants, sub, dtype=torch.float32)
    assert judge.grant_gap(ref, ref, wants, cap) == 0.0
    # bfloat16's 2**-8 on grants of ~5 (and on the sum of wants) over a
    # capacity of 5,000: some 1e-6; float32's 2**-24: some 1e-9
    assert judge.grant_gap(low, ref, wants, cap) > 1e-6
    assert judge.grant_gap(f32, ref, wants, cap) < 1e-8
