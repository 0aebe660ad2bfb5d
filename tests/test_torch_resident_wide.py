"""The port's WideResidentSolver (device="cpu", chunk width 8) on the CPU.

  * tests/test_resident_wide.py's nine cases on the port, against the
    port's BatchSolver (its dense lane part) as ground truth: tick for
    tick through demand churn, releases, new clients and a learning
    flip; the rotation's fixpoint; the chunk-version guard; a capacity
    cut delivered within one tick; growth past the allocated chunks;
    the expiry sweep; the idle fast path; the chunk boundary; the
    drain / remove / pack interleaving. allclose, not byte-equal, as in
    the reference: the two-level chunk reduction re-associates the
    dense row's sums (RTOL 1e-9, ATOL 1e-9 at f64, the reference's).
  * the port's solver against the JAX package's, tick for tick, on the
    same seeded store operations against each package's own native
    store, fused and fused + scoped: the stores of record hold
    IDENTICAL leases after every tick (both add a chunk row left to
    right and a segment's row totals in row order, and the fused
    scatters, the scope closure and the delivery set are the same).
"""

import numpy as np
import pytest

import tests.conftest  # noqa: F401

from doorman_tpu import native as jnative
from doorman_tpu.core.resource import Resource as JResource
from doorman_tpu.proto import doorman_pb2 as jpb
from doorman_tpu.solver.resident_wide import WideResidentSolver as JWide
from doorman_tpu_torch import native
from doorman_tpu_torch.core.resource import Resource
from doorman_tpu_torch.proto import doorman_pb2 as pb
from doorman_tpu_torch.solver.batch import BatchSolver
from doorman_tpu_torch.solver.resident_wide import WideResidentSolver

pytestmark = pytest.mark.skipif(
    not (native.native_available() and jnative.native_available()),
    reason="native engine unavailable",
)

KINDS = [
    pb.Algorithm.NO_ALGORITHM,
    pb.Algorithm.STATIC,
    pb.Algorithm.PROPORTIONAL_SHARE,
    pb.Algorithm.FAIR_SHARE,
]

RTOL = 1e-9  # two-level float reassociation, f64
# Near-zero grants carry ABSOLUTE reassociation noise at the resource's
# capacity scale (caps here reach 500: one reassociated f64 sum leaves
# O(cap * eps * depth) ~ 1e-12), so the absolute floor sits at 1e-9.
ATOL = 1e-9


def make_world(clock, n_res=4, n_clients=21, seed=3, engine_mod=native,
               resource_cls=Resource, proto=pb):
    """Resources wider than the test chunk width (8), so each spans
    several chunk rows."""
    rng = np.random.default_rng(seed)
    engine = engine_mod.StoreEngine(clock=clock)
    resources = []
    for r in range(n_res):
        tpl = proto.ResourceTemplate(
            identifier_glob=f"res{r}",
            capacity=float(rng.integers(50, 500)),
            algorithm=proto.Algorithm(
                kind=int(KINDS[r % len(KINDS)]),
                lease_length=60,
                refresh_interval=5,
            ),
        )
        res = resource_cls(
            f"res{r}", tpl, clock=clock, store_factory=engine.store
        )
        resources.append(res)
        for c in range(n_clients):
            res.store.assign(
                f"c{r}_{c}", 60.0, 5.0, 0.0,
                float(rng.integers(1, 100)), 1,
            )
    return engine, resources


def all_leases(resources):
    out = {}
    for res in resources:
        for client, lease in res.store.items():
            out[(res.id, client)] = (
                lease.has, lease.wants, lease.subclients,
            )
    return out


def assert_close(a, b, msg=""):
    assert a.keys() == b.keys(), f"membership diverged {msg}"
    for key in a:
        np.testing.assert_allclose(
            a[key], b[key], rtol=RTOL, atol=ATOL,
            err_msg=f"{msg} lease {key}",
        )


def churn(resources, step, rng):
    res = resources[step % len(resources)]
    i = resources.index(res)
    res.store.assign(
        f"c{i}_0", 60.0, 5.0, res.store.get(f"c{i}_0").has,
        float(rng.integers(1, 200)), 1,
    )
    if step % 3 == 1:
        res2 = resources[(step * 7) % len(resources)]
        res2.store.release(f"c{resources.index(res2)}_1")
    if step % 3 == 2:
        res3 = resources[(step * 5) % len(resources)]
        res3.store.assign(
            f"new{step}_{resources.index(res3)}", 60.0, 5.0, 0.0,
            float(rng.integers(1, 50)), 2,
        )


def test_wide_matches_batch_solver_tick_for_tick():
    t = [1000.0]
    clock = lambda: t[0]
    eng_a, res_a = make_world(clock)
    eng_b, res_b = make_world(clock)
    wide = WideResidentSolver(
        eng_a, dtype=np.float64, clock=clock, device="cpu", rotate_ticks=1,
        chunk_width=8,
    )
    batch = BatchSolver(dtype=np.float64, clock=clock, device="cpu")
    rng_a, rng_b = (np.random.default_rng(99) for _ in range(2))
    for step in range(8):
        churn(res_a, step, rng_a)
        churn(res_b, step, rng_b)
        if step == 4:
            res_a[2].learning_mode_end = t[0] + 100
            res_b[2].learning_mode_end = t[0] + 100
        wide.step(res_a, config_epoch=1 if step >= 4 else 0)
        batch.tick(res_b)
        assert_close(
            all_leases(res_a), all_leases(res_b), f"tick {step}"
        )
        t[0] += 1.0


def test_wide_rotation_converges_to_batch_fixpoint():
    """rotate_ticks>1: wants-driven movement rides the rotation; with
    demand frozen the stores must reach the batch fixpoint."""
    t = [500.0]
    clock = lambda: t[0]
    eng_a, res_a = make_world(clock, seed=11)
    eng_b, res_b = make_world(clock, seed=11)
    wide = WideResidentSolver(
        eng_a, dtype=np.float64, clock=clock, device="cpu", rotate_ticks=4,
        chunk_width=8,
    )
    batch = BatchSolver(dtype=np.float64, clock=clock, device="cpu")
    for _ in range(12):
        wide.step(res_a)
        batch.tick(res_b)
        t[0] += 1.0
    assert_close(all_leases(res_a), all_leases(res_b))


def test_chunk_version_guard_skips_only_the_stale_chunk():
    """A mid-flight membership change must skip exactly the chunks whose
    slot order moved — other chunks of the SAME resource still apply."""
    t = [100.0]
    clock = lambda: t[0]
    engine, resources = make_world(clock, n_res=1, n_clients=21)
    wide = WideResidentSolver(
        engine, dtype=np.float64, clock=clock, device="cpu", rotate_ticks=1,
        chunk_width=8,
    )
    wide.step(resources)  # settle: 3 chunks
    # A chunk-1 client's demand moves, so this tick's solve produces a
    # NEW grant for it (res0 is NO_ALGORITHM: grant == wants) — the
    # applied chunk must visibly write it.
    old_has = resources[0].store.get("c0_9").has
    resources[0].store.assign("c0_9", 60.0, 5.0, old_has, 999.0, 1)
    handle = wide.dispatch(resources)
    # Release c0_1 (slot 1, chunk 0); last slot 20 is chunk 2.
    resources[0].store.release("c0_1")
    before = all_leases(resources)
    applied = wide.collect(handle)
    after = all_leases(resources)
    # Chunks 0 and 2 skipped, chunk 1 applied — and its write is real.
    assert applied == 1
    assert after[("res0", "c0_9")][0] == 999.0
    assert before[("res0", "c0_9")][0] == old_has != 999.0
    for c in list(range(0, 8)) + list(range(16, 21)):
        key = ("res0", f"c0_{c}")
        if key in after:
            assert after[key] == before[key], f"stale chunk wrote {key}"
    # The re-marked slots re-deliver next tick.
    wide.step(resources)
    t[0] += 1.0
    wide.step(resources)
    assert wide.ticks >= 3


def make_prop_world(clock, n_clients=21, cap=1000.0, wants=100.0):
    """One oversubscribed PROPORTIONAL_SHARE resource spanning chunks."""
    engine = native.StoreEngine(clock=clock)
    tpl = pb.ResourceTemplate(
        identifier_glob="res0",
        capacity=cap,
        algorithm=pb.Algorithm(
            kind=pb.Algorithm.PROPORTIONAL_SHARE,
            lease_length=60,
            refresh_interval=5,
        ),
    )
    res = Resource("res0", tpl, clock=clock, store_factory=engine.store)
    for c in range(n_clients):
        res.store.assign(f"c0_{c}", 60.0, 5.0, 0.0, wants, 1)
    return engine, [res]


def test_capacity_cut_reaches_store_within_one_tick():
    """A config-epoch bump (capacity cut) delivers ALL the resource's
    chunks the very next tick — not after the rotation."""
    t = [50.0]
    clock = lambda: t[0]
    engine, resources = make_prop_world(clock)
    wide = WideResidentSolver(
        engine, dtype=np.float64, clock=clock, device="cpu", rotate_ticks=64,
        chunk_width=8,
    )
    for _ in range(3):
        wide.step(resources)
        t[0] += 1.0
    sum_before = resources[0].store.sum_has
    # Capacity cut via template mutation + epoch bump.
    resources[0].template.capacity = 10.0
    wide.step(resources, config_epoch=1)
    sum_after = resources[0].store.sum_has
    assert sum_after <= 10.0 + 1e-9, (
        f"cut not delivered same-tick: sum_has {sum_before} -> {sum_after}"
    )


def test_growth_past_allocated_chunks_rebuilds():
    t = [10.0]
    clock = lambda: t[0]
    engine, resources = make_world(clock, n_res=1, n_clients=16, seed=5)
    wide = WideResidentSolver(
        engine, dtype=np.float64, clock=clock, device="cpu", rotate_ticks=1,
        chunk_width=8,
    )
    wide.step(resources)
    assert wide._R == 2
    # Grow past 2 chunks x 8 slots.
    for c in range(16, 20):
        resources[0].store.assign(f"g{c}", 60.0, 5.0, 0.0, 5.0, 1)
    wide.step(resources)
    assert wide._R == 3
    # Grants still correct vs a fresh batch world.
    eng_b = native.StoreEngine(clock=clock)
    res_b = Resource(
        "res0", resources[0].template, clock=clock,
        store_factory=eng_b.store,
    )
    for client, lease in resources[0].store.items():
        res_b.store.assign(
            client, 60.0, 5.0, 0.0, lease.wants, lease.subclients
        )
    BatchSolver(dtype=np.float64, clock=clock, device="cpu").tick([res_b])
    wide.step(resources)
    a = {c: l.has for c, l in resources[0].store.items()}
    b = {c: l.has for c, l in res_b.store.items()}
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=RTOL, err_msg=k)


def test_expiry_sweep_flows_through():
    """Expired leases vanish from the store AND from the device table
    (the swept slots re-upload as inactive)."""
    t = [0.0]
    clock = lambda: t[0]
    engine, resources = make_prop_world(clock)
    wide = WideResidentSolver(
        engine, dtype=np.float64, clock=clock, device="cpu", rotate_ticks=1,
        chunk_width=8,
    )
    # Short-lease client that will lapse.
    resources[0].store.assign("short", 5.0, 5.0, 0.0, 50.0, 1)
    wide.step(resources)
    assert resources[0].store.has_client("short")
    t[0] = 10.0  # past the 5s lease
    wide.step(resources)
    assert not resources[0].store.has_client("short")
    # The freed share redistributes; totals stay capped.
    wide.step(resources)
    cap = resources[0].template.capacity
    assert resources[0].store.sum_has <= cap * (1 + 1e-9)


def test_idle_fast_path_engages():
    t = [1.0]
    clock = lambda: t[0]
    engine, resources = make_world(clock, n_res=2, n_clients=21, seed=13)
    wide = WideResidentSolver(
        engine, dtype=np.float64, clock=clock, device="cpu", rotate_ticks=2,
        chunk_width=8,
    )
    for _ in range(12):
        wide.step(resources)
        t[0] += 1.0
    assert wide.idle_ticks > 0
    # Any write resumes real ticks.
    resources[0].store.assign("c0_0", 60.0, 5.0, 0.0, 123.0, 1)
    idle_before = wide.idle_ticks
    wide.step(resources)
    assert wide.idle_ticks == idle_before


def test_boundary_width_exact_multiple():
    """Population exactly chunk_width and chunk_width+1: the chunk map
    sizes correctly on both sides of the boundary."""
    t = [1.0]
    clock = lambda: t[0]
    for n, want_chunks in ((8, 1), (9, 2)):
        engine = native.StoreEngine(clock=clock)
        tpl = pb.ResourceTemplate(
            identifier_glob="res",
            capacity=100.0,
            algorithm=pb.Algorithm(
                kind=pb.Algorithm.PROPORTIONAL_SHARE,
                lease_length=60, refresh_interval=5,
            ),
        )
        res = Resource("res", tpl, clock=clock, store_factory=engine.store)
        for c in range(n):
            res.store.assign(f"c{c}", 60.0, 5.0, 0.0, 20.0, 1)
        wide = WideResidentSolver(
            engine, dtype=np.float64, clock=clock, device="cpu", rotate_ticks=1,
            chunk_width=8,
        )
        wide.step([res])
        assert wide._R == want_chunks, (n, wide._R)
        assert res.store.sum_has == pytest.approx(
            min(100.0, 20.0 * n), rel=1e-9
        )


def test_drain_remove_pack_interleaving_converges():
    """The documented one-tick UPLOAD inconsistency window: a
    swap-remove landing between dispatch's slot drain and its
    pack_slots read pairs the new occupant's wants with the old
    occupant's device lanes for that solve. The chunk-version guard
    (read before the pack) must block the skewed chunks' write-back,
    and the re-marked slots must re-deliver a consistent solve — the
    stores converge to the batch fixpoint within the following ticks.
    """
    t = [200.0]
    clock = lambda: t[0]
    eng_a, res_a = make_world(clock, n_res=1, n_clients=21, seed=7)
    eng_b, res_b = make_world(clock, n_res=1, n_clients=21, seed=7)
    wide = WideResidentSolver(
        eng_a, dtype=np.float64, clock=clock, device="cpu", rotate_ticks=1,
        chunk_width=8,
    )
    batch = BatchSolver(dtype=np.float64, clock=clock, device="cpu")
    wide.step(res_a)
    batch.tick(res_b)
    t[0] += 1.0

    # Wants-only churn dirties c0_5's slot (level 1)...
    old_has = res_a[0].store.get("c0_5").has
    res_a[0].store.assign("c0_5", 60.0, 5.0, old_has, 777.0, 1)

    # ... and the swap-remove lands BETWEEN the drain and the pack:
    # the first pack_slots of this dispatch releases c0_5, so the
    # drained slot index now holds the swapped-in occupant.
    orig_pack = eng_a.pack_slots
    fired = []

    def racing_pack(rid, slots):
        if not fired:
            fired.append(True)
            res_a[0].store.release("c0_5")
        return orig_pack(rid, slots)

    eng_a.pack_slots = racing_pack
    try:
        handle = wide.dispatch(res_a)
    finally:
        eng_a.pack_slots = orig_pack
    wide.collect(handle)
    assert fired, "the interleaved release never raced the pack"

    # Mirror world: same net operations, batch ground truth.
    old_has_b = res_b[0].store.get("c0_5").has
    res_b[0].store.assign("c0_5", 60.0, 5.0, old_has_b, 777.0, 1)
    res_b[0].store.release("c0_5")

    for _ in range(3):
        t[0] += 1.0
        wide.step(res_a)
        batch.tick(res_b)
    assert_close(all_leases(res_a), all_leases(res_b))


@pytest.mark.parametrize("scoped", [True, False], ids=["scoped", "fused"])
def test_port_wide_matches_reference_tick_for_tick(scoped):
    t = [1000.0]
    clock = lambda: t[0]  # noqa: E731
    eng_j, res_j = make_world(clock, n_res=5, seed=21, engine_mod=jnative,
                              resource_cls=JResource, proto=jpb)
    eng_t, res_t = make_world(clock, n_res=5, seed=21)
    ref = JWide(eng_j, dtype=np.float64, clock=clock, rotate_ticks=3,
                chunk_width=8, scoped=scoped)
    port = WideResidentSolver(eng_t, dtype=np.float64, clock=clock,
                              rotate_ticks=3, chunk_width=8, scoped=scoped,
                              device="cpu")
    rng_j, rng_t = (np.random.default_rng(99) for _ in range(2))
    modes = []
    for step in range(14):
        churn(res_j, step, rng_j)
        churn(res_t, step, rng_t)
        if step == 5:
            res_j[2].learning_mode_end = t[0] + 3
            res_t[2].learning_mode_end = t[0] + 3
        if step == 9:  # growth past the allocated chunks: a rebuild
            for c in range(12):
                for res in (res_j[1], res_t[1]):
                    res.store.assign(f"g{c}", 60.0, 5.0, 0.0, 7.0 + c, 1)
        epoch = 1 if step >= 5 else 0
        ref.step(res_j, config_epoch=epoch)
        port.step(res_t, config_epoch=epoch)
        assert all_leases(res_j) == all_leases(res_t), f"tick {step}"
        assert port.last_solve_mode == ref.last_solve_mode
        assert port.last_scope == ref.last_scope
        modes.append(port.last_solve_mode)
        t[0] += 1.0
    assert port._R == ref._R and port.ticks == ref.ticks
    if scoped:
        assert modes.count("scoped") >= 8, modes
    else:
        assert set(modes) == {"full"}
