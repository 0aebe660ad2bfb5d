"""The port's SubscriptionMatcher (doorman_tpu_torch/server/match.py)
against the reference's (doorman_tpu/server/match.py), on the CPU.

  * one seeded sequence of add, remove and match through four matchers —
    the reference's host mirror and its jitted path (JAX on the CPU), the
    port's host mirror and its torch path on CPU tensors: the port's two
    and the reference's host mirror return the same pair set after every
    step. The reference's jitted path returns that set too, plus, where
    its padding wraps (below), the watchers of row rpad - 1;
  * the reference's own cases (tests/test_stream_match.py), each run on
    both packages: slot reuse, idempotent remove, scatters within the
    extent headroom with no repack, a repack on overflow, no padding in
    the output, the phase laps, the status keys, and the bucket
    boundaries n = 1, 64 and 257;
  * the torch match lands its pairs with one device->host copy, counted
    as the one host sync, and nothing else reads the device.

The reference's jitted match builds its row mask with
`.at[changed].set(True, mode="drop")`; JAX normalises the -1 padding of
`changed` to rpad - 1 before the drop, so whenever the changed list is
padded the watchers of rid rpad - 1 (a row that exists only when the
highest subscribed rid is rpad - 1) ride every match. The port drops the
padding (ROADMAP C).
"""

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401

from doorman_tpu.server.match import SubscriptionMatcher as JMatcher
from doorman_tpu_torch.server.match import SubscriptionMatcher as TMatcher
from doorman_tpu_torch.server.match import _pow2
from doorman_tpu_torch.utils import dispatch as tdispatch


def pairs_set(pairs):
    return {(int(a), int(b)) for a, b in pairs}


def expected(matcher, changed):
    out = set()
    for rid in changed:
        for slot in matcher._members.get(rid, ()):
            out.add((slot, rid))
    return out


def _wrap_leak(matcher, changed):
    """The pairs the reference's jitted match adds by wrapping its -1
    padding onto row rpad - 1 (empty when nothing is padded or that row
    has no watchers)."""
    work = [r for r in changed if matcher._members.get(r)]
    if not work or len(work) == _pow2(len(work)):
        return set()
    last = matcher._rpad - 1
    return {(s, last) for s in matcher._members.get(last, ())}


def test_seeded_sequence_matches_the_reference():
    rng = np.random.default_rng(9)
    jh, jd = JMatcher(use_device=False), JMatcher()
    th, td = (TMatcher(use_device=False, device="cpu"),
              TMatcher(device="cpu"))
    matchers = (jh, jd, th, td)
    live = []
    leaked = 0
    # Rows from a pool of 40 of the rids up to 255 (255 among them), then
    # from a pool that also holds rids up to 600: subscriptions land both
    # in the extents' headroom (point scatters) and on new rows
    # (repacks), and the packed table crosses the rpad = 256 bucket.
    pools = (
        np.append(rng.choice(255, 39, replace=False), 255),
        np.append(rng.choice(600, 40, replace=False), 255),
    )
    for step in range(160):
        op = rng.random()
        pool = pools[step >= 80]
        if op < 0.55 or not live:
            rids = sorted(set(int(r) for r in rng.choice(
                pool, rng.integers(1, 4))))
            slots = {m.add(rids) for m in matchers}
            assert len(slots) == 1
            live.append(slots.pop())
        elif op < 0.75:
            slot = live.pop(int(rng.integers(len(live))))
            for m in matchers:
                m.remove(slot)
        else:
            changed = sorted(set(int(r) for r in np.concatenate([
                rng.choice(pool, rng.integers(1, 12)),
                rng.integers(0, 600, 3),
            ])))
            want = expected(jh, changed)
            assert pairs_set(jh.match(changed)) == want
            assert pairs_set(th.match(changed)) == want
            got = td.match(changed)
            assert pairs_set(got) == want and len(got) == len(want)
            ref = pairs_set(jd.match(changed))
            leak = _wrap_leak(jd, changed)
            assert want <= ref <= want | leak
            leaked += len(ref - want)
        for r in (0, 7, 255, 599):
            assert len({m.watchers(r) for m in matchers}) == 1
    assert td.status()["device"] and td.rebuilds > 1 and td.scatters > 0
    assert jd.status() == {**td.status(), "matched_total": jd.matched_total}
    assert leaked > 0  # the sequence reaches the reference's wrap


def test_reference_wraps_its_padding_onto_the_last_row():
    """Rids 0..255 watched: rpad is 256, so the reference's padded match
    of row 0 also returns row 255's watcher; the port's does not."""
    jd, td = JMatcher(), TMatcher(device="cpu")
    for m in (jd, td):
        for rid in range(256):
            m.add([rid])
    assert pairs_set(td.match([0])) == {(0, 0)}
    assert pairs_set(jd.match([0])) == {(0, 0), (255, 255)}


IMPLS = {"ref": JMatcher, "port": TMatcher}


@pytest.fixture(params=sorted(IMPLS))
def make(request):
    cls = IMPLS[request.param]

    def build(**kw):
        if request.param == "port":
            kw.setdefault("device", "cpu")
        return cls(**kw)

    return build


@pytest.mark.parametrize("case", [
    "host_mirror_slot_reuse", "remove_idempotent", "device_vs_host_churn",
    "no_padding", "phase_laps", "status_shape",
])
def test_reference_cases(make, case):
    if case == "host_mirror_slot_reuse":
        m = make(use_device=False)
        s0 = m.add([1, 2, 3])
        s1 = m.add([2])
        s2 = m.add([3, 7])
        assert pairs_set(m.match([2])) == {(s0, 2), (s1, 2)}
        assert pairs_set(m.match([7])) == {(s2, 7)}
        assert pairs_set(m.match([1, 3])) == {(s0, 1), (s0, 3), (s2, 3)}
        assert len(m.match([99])) == 0
        assert m.watchers(2) == 2
        m.remove(s1)
        assert pairs_set(m.match([2])) == {(s0, 2)}
        s3 = m.add([2])
        assert s3 == s1
        assert pairs_set(m.match([2])) == {(s0, 2), (s3, 2)}
    elif case == "remove_idempotent":
        m = make(use_device=False)
        s0 = m.add([4, 5])
        m.add([5])
        m.remove(s0)
        m.remove(s0)
        assert pairs_set(m.match([4, 5])) == {(1, 5)}
        assert m.watchers(4) == 0
    elif case == "device_vs_host_churn":
        dm, hm = make(), make(use_device=False)
        for i in range(12):
            rids = [i % 5, 5 + (i % 3)]
            assert dm.add(rids) == hm.add(rids)
        changed = [1, 6, 9]
        got = pairs_set(dm.match(changed))
        assert got == pairs_set(hm.match(changed)) == expected(hm, changed)
        rebuilds_before = dm.rebuilds
        for slot in (2, 5):  # churn within the extent headroom
            dm.remove(slot)
            hm.remove(slot)
        assert dm.add([1, 6]) == hm.add([1, 6])
        got = pairs_set(dm.match(changed))
        assert got == pairs_set(hm.match(changed)) == expected(hm, changed)
        assert dm.rebuilds == rebuilds_before, "headroom churn repacked"
        assert dm.scatters >= 1, "no incremental scatter happened"
        for _ in range(20):  # overflow one row's extent: a repack
            assert dm.add([6]) == hm.add([6])
        got = pairs_set(dm.match([6]))
        assert got == pairs_set(hm.match([6]))
        assert dm.rebuilds > rebuilds_before
        assert len(got) == dm.watchers(6)
    elif case == "no_padding":
        m = make()
        for i in range(5):
            m.add([100 + i])
        pairs = m.match([100, 103])
        assert pairs.shape == (2, 2) and pairs.dtype == np.int32
        assert pairs_set(pairs) == {(0, 100), (3, 103)}
        assert m.match([999]).shape == (0, 2)  # host-known M == 0
    elif case == "phase_laps":
        m = make()
        m.add([1])
        m.add([1])
        assert len(m.match([1])) == 2
        assert m.phase_s["match"] > 0.0
        assert m.status()["device"]
        assert m.phase_s["download"] > 0.0 and m.phase_s["staging"] > 0.0
    else:
        m = make(use_device=False)
        m.add([1, 2])
        m.match([1])
        st = m.status()
        assert sorted(st) == sorted([
            "slots", "rows", "packed_size", "matched_total", "rebuilds",
            "scatters", "device",
        ])
        assert st["slots"] == 1 and st["rows"] == 2
        assert st["matched_total"] == 1
        assert st["device"] is False


@pytest.mark.parametrize("n", [1, 64, 257])
def test_scales_across_bucket_boundaries(make, n):
    m = make()
    for i in range(n):
        m.add([i % 7])
    changed = list(range(7))
    pairs = m.match(changed)
    assert len(pairs) == n
    assert pairs_set(pairs) == expected(m, changed)


def test_match_lands_once_and_reads_nothing_else(monkeypatch):
    """One host sync a match (the pairs' landing, one .cpu() copy); no
    .item(), .tolist(), truth test or torch.nonzero reads the device to
    decide a shape. Dispatches: the changed list's placement and the
    match; churn within the headroom adds the point scatter and its two
    placements; the first match places the table (two)."""
    m = TMatcher(device="cpu")
    for i in range(40):
        m.add([i % 9, 20 + i % 4])
    copies = []
    real_cpu = torch.Tensor.cpu

    def counted_cpu(self, *a, **k):
        copies.append(tuple(self.shape))
        return real_cpu(self, *a, **k)

    def refuse(*_a, **_k):
        raise AssertionError("the match read the device")

    monkeypatch.setattr(torch.Tensor, "cpu", counted_cpu)
    for name in ("item", "tolist", "__bool__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch, "nonzero", refuse)
    before = tdispatch.snapshot()
    assert pairs_set(m.match([3, 21])) == expected(m, [3, 21])
    first = tdispatch.delta(before)
    before = tdispatch.snapshot()
    assert len(m.match([3, 21, 50])) == len(expected(m, [3, 21]))
    steady = tdispatch.delta(before)
    m.remove(5)
    m.add([3])
    before = tdispatch.snapshot()
    assert pairs_set(m.match([3])) == expected(m, [3])
    churn = tdispatch.delta(before)
    assert first == {"dispatches": 4, "host_syncs": 1}
    assert steady == {"dispatches": 2, "host_syncs": 1}
    assert churn == {"dispatches": 5, "host_syncs": 1}
    assert m.scatters == 1
    caps = [_pow2(len(expected(m, c))) for c in ([3, 21], [3, 21], [3])]
    assert copies == [(cap, 2) for cap in caps]


def test_matcher_defaults_to_cuda_and_runs_on_cpu_only_when_asked():
    """The matcher is an entry point of the port: with no `device` it
    targets the card, so a construction without a GPU raises unless the
    caller asks for "cpu"."""
    if torch.cuda.is_available():
        assert TMatcher()._device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TMatcher()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TMatcher(use_device=False)
    assert TMatcher(device="cpu")._device == torch.device("cpu")
