"""The native store's bulk aggregate read (StoreEngine.sums, one locked
dm_sums_many call for many resources) and the store digest's bulk path
(doorman_tpu_torch.obs.flightrec.digest_stores): the rows equal each
store's own dm_sums read, and the digest's bytes equal the per-store
path's and the reference's (doorman_tpu.obs.flightrec.store_digest)."""

import numpy as np
import pytest

import tests.conftest  # noqa: F401

from doorman_tpu.obs.flightrec import store_digest as reference_digest
from doorman_tpu_torch import native
from doorman_tpu_torch.core.store import LeaseStore
from doorman_tpu_torch.obs.flightrec import digest_stores, store_digest

pytestmark = pytest.mark.skipif(
    not native.native_available(), reason="native engine unavailable"
)

# Aggregates whose round(..., 6) is decided by a 7th decimal of 5, very
# large and very small values, and zero.
EDGE_VALUES = (
    0.0, 5e-7, 1.5e-6, 2.5e-7, 1.2345675, 0.1234565, 2.0000005,
    1e-12, 3.3e-9, 123456789012.3456785, 9.87654321e15, 1e20,
    4999.9999995, 0.0000015, 7.0,
)


class Res:
    """The digest's view of a resource: a capacity and a store."""

    def __init__(self, store, capacity):
        self.store, self.capacity = store, capacity


class Wrapped:
    """A store read one accessor at a time: the digest's per-store
    path, whatever the store beneath."""

    def __init__(self, store):
        self._store = store

    @property
    def sum_has(self):
        return self._store.sum_has

    @property
    def sum_wants(self):
        return self._store.sum_wants

    def __len__(self):
        return len(self._store)


class Plain:
    """Fixed aggregates, for the reference's digest."""

    def __init__(self, sum_has, sum_wants, n):
        self.sum_has, self.sum_wants, self._n = sum_has, sum_wants, n

    def __len__(self):
        return self._n


def _populate(engine, n_res, seed, prefix="r"):
    """n_res stores with 0-4 leases each; has and wants draw on
    EDGE_VALUES and on random values. Returns the stores and the
    (rid, cid) of every lease."""
    rng = np.random.default_rng(seed)
    stores = [engine.store(f"{prefix}{i:05d}") for i in range(n_res)]
    rids, cids, has, wants = [], [], [], []
    for i, s in enumerate(stores):
        for c in range(i % 5):
            rids.append(s._rid)
            cids.append(engine.client_handle(f"c{c}"))
            pick = rng.random()
            if pick < 0.5:
                has.append(EDGE_VALUES[rng.integers(len(EDGE_VALUES))])
                wants.append(EDGE_VALUES[rng.integers(len(EDGE_VALUES))])
            else:
                has.append(float(rng.random() * 100))
                wants.append(float(rng.integers(0, 10**7)) / 10**7)
    n = len(rids)
    rng_exp = np.where(np.arange(n) % 3 == 0, 50.0, 1e9)
    engine.bulk_assign(
        np.asarray(rids, np.int32), np.asarray(cids, np.int64),
        rng_exp, np.full(n, 5.0), np.asarray(has), np.asarray(wants),
        np.asarray([1 + k % 3 for k in range(n)], np.int32),
    )
    return stores, list(zip(rids, cids))


def _resources(stores, seed):
    rng = np.random.default_rng(seed + 1)
    caps = [
        EDGE_VALUES[i % len(EDGE_VALUES)] if i % 2 else
        float(rng.integers(1, 10**6)) / 1000
        for i in range(len(stores))
    ]
    return {s.id: Res(s, cap) for s, cap in zip(stores, caps)}


@pytest.mark.parametrize(
    "stage", ["fresh", "bulk_refresh", "release", "clean_all"]
)
def test_sums_equal_each_store_row_for_row(stage):
    engine = native.StoreEngine(clock=lambda: 100.0)
    stores, leases = _populate(engine, 64, seed=7)
    if stage == "bulk_refresh":
        rids, cids = (np.asarray(c) for c in zip(*leases[::2]))
        done = engine.bulk_refresh(
            rids, cids, np.full(len(rids), 1e9), np.full(len(rids), 5.0),
            np.linspace(0.0, 3.0000005, len(rids)),
        )
        assert done == len(rids)
    elif stage == "release":
        for s in stores[1::3]:
            s.release("c0")
    elif stage == "clean_all":
        assert engine.clean_all(100.0) > 0  # every third lease expired
    rids = [s._rid for s in stores]
    got = engine.sums(rids)
    assert got.shape == (len(stores), 4) and got.dtype == np.float64
    for s, row in zip(stores, got):
        assert row.tolist() == s._sums().tolist(), s.id
        assert row[3] == len(s) and row[0] == s.sum_has
    # The rows follow the order asked, repeats included.
    order = [rids[5], rids[0], rids[5]]
    assert engine.sums(order).tolist() == got[[5, 0, 5]].tolist()


def test_sums_of_invalid_rids_and_of_none():
    engine = native.StoreEngine()
    stores, _ = _populate(engine, 8, seed=3)
    got = engine.sums([-1, stores[4]._rid, 10**6])
    assert got[0].tolist() == [0.0] * 4 and got[2].tolist() == [0.0] * 4
    assert got[1].tolist() == stores[4]._sums().tolist()
    empty = engine.sums([])
    assert empty.shape == (0, 4) and empty.dtype == np.float64


def test_bulk_digest_equals_the_per_store_path_over_many_stores():
    engine = native.StoreEngine(clock=lambda: 100.0)
    stores, _ = _populate(engine, 1200, seed=11)
    resources = _resources(stores, seed=11)
    bulk, took_bulk = digest_stores(resources)
    wrapped = {rid: Res(Wrapped(r.store), r.capacity)
               for rid, r in resources.items()}
    per_store, took_per = digest_stores(wrapped)
    assert (took_bulk, took_per) == (True, False)
    assert bulk == per_store == store_digest(resources)
    # Moves with the stores: an expiry sweep changes both alike.
    engine.clean_all(100.0)
    after, _ = digest_stores(resources)
    assert after != bulk and after == digest_stores(wrapped)[0]


def test_bulk_digest_equals_the_reference_digest():
    engine = native.StoreEngine()
    stores, _ = _populate(engine, 1000, seed=5)
    resources = _resources(stores, seed=5)
    plain = {
        rid: Res(Plain(r.store.sum_has, r.store.sum_wants, len(r.store)),
                 r.capacity)
        for rid, r in resources.items()
    }
    digest, bulk = digest_stores(resources)
    assert bulk and digest == reference_digest(plain)


@pytest.mark.parametrize("mix", ["python_store", "two_engines"])
def test_mixed_stores_take_the_per_store_path(mix):
    engine = native.StoreEngine()
    stores, _ = _populate(engine, 40, seed=9)
    resources = _resources(stores, seed=9)
    if mix == "python_store":
        py = LeaseStore("p0", clock=lambda: 0.0)
        py.assign("c0", 60.0, 5.0, 1.2345675, 0.1234565, 2)
        resources["p0"] = Res(py, 4999.9999995)
    else:
        other = native.StoreEngine()
        more, _ = _populate(other, 10, seed=10, prefix="q")
        resources.update(_resources(more, seed=10))
    wrapped = {rid: Res(Wrapped(r.store), r.capacity)
               for rid, r in resources.items()}
    digest, bulk = digest_stores(resources)
    assert not bulk
    assert digest == digest_stores(wrapped)[0]
    # The native stores alone still read in one call.
    native_only = {rid: r for rid, r in resources.items()
                   if getattr(r.store, "_engine", None) is engine}
    assert digest_stores(native_only)[1]


def test_no_resources_digest_the_empty_list():
    assert digest_stores({}) == (reference_digest({}), False)
