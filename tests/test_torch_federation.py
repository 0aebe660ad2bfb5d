"""Federation on the port (doorman_tpu_torch/federation/ and the server's
federation seams), held against the JAX package.

  * the reference's ten non-chaos cases (tests/test_federation.py) on
    port servers, on both lease stores where a server ticks: the pinned
    stable hash, the router, shard_lock_key, the discovery cache, the
    sharded-vs-single-root parity over churn, the partition freeze /
    decay / re-offer, the persist namespaces and the per-shard warm
    takeover, the aggregation adapter against a per-band sum, the
    federated intermediate's per-shard fan-out and the federated client;
  * cross-package parity: stable_shard and ShardRouter equal on 1,000
    seeded ids at 2, 3, 4 and 8 shards; the StraddleReconciler's shares
    bit-identical over a seeded sequence of summaries for every lane,
    partition and expiry included; the reference's FederatedRoots and
    the port's on one fake clock with the same requests (grants, shares,
    summaries and the flight record's federation beat equal at f64);
    the aggregation adapter against the reference's on seeded tables
    (exact on integer wants; float wants within the order bound below;
    f32 and f64); a port FederatedIntermediate over reference shard
    roots and a reference one over port roots over loopback gRPC, with
    the per-shard upstream request bytes equal;
  * the port's adapter against `band_aggregates` of the native store,
    and a mastership change on one shard wiping only its own shares.

Float-wants tolerance: the adapter sums K nonnegative terms a band; XLA's
CPU reduce and torch's sum may order the additions differently, and two
orders of a nonnegative sum differ by at most 2 (K - 1) u of the sum
(u the unit roundoff of the table's dtype). Integer-valued wants sum
exactly in either order.

Subnormals: XLA's CPU backend flushes subnormal results to zero and
torch's CPU ops keep them, so where a lane's exact result is subnormal
(a BALANCED_FAIRNESS row solved at capacity 0 grants 1.1e-308) the
reference stores 0.0. The FederatedRoots comparison maps values below
the smallest normal f64 to 0.0 on both sides (`_ftz`) and is exact
otherwise.

The port runs with device="cpu" (the kernels' plain versions), f64
unless stated.
"""

import asyncio
import math
import random

import grpc
import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401

from doorman_tpu import federation as jfed
from doorman_tpu import native as jnative
from doorman_tpu.algorithms import Request as JRequest
from doorman_tpu.proto import doorman_pb2 as jpb
from doorman_tpu.server.config import parse_yaml_config as j_parse
from doorman_tpu.server.election import TrivialElection as JElection
from doorman_tpu.server.server import CapacityServer as JServer
from doorman_tpu_torch import federation as tfed
from doorman_tpu_torch import native as tnative
from doorman_tpu_torch.algorithms import Request
from doorman_tpu_torch.algorithms.kinds import AlgoKind
from doorman_tpu_torch.federation import (
    AggregationTickAdapter,
    FederatedClient,
    FederatedIntermediate,
    FederatedRoots,
    ShardDiscovery,
    ShardRouter,
    stable_shard,
)
from doorman_tpu_torch.persist import (
    MemoryBackend,
    PersistManager,
    parse_backend,
)
from doorman_tpu_torch.proto import doorman_pb2 as pb
from doorman_tpu_torch.proto.grpc_api import CapacityStub
from doorman_tpu_torch.server.config import parse_yaml_config
from doorman_tpu_torch.server.election import TrivialElection, shard_lock_key
from doorman_tpu_torch.server.server import CapacityServer

NATIVE = pytest.param(
    True, id="native-store",
    marks=pytest.mark.skipif(
        not (jnative.native_available() and tnative.native_available()),
        reason="native engine unavailable",
    ),
)
STORES = [pytest.param(False, id="python-store"), NATIVE]


def run(coro):
    return asyncio.run(coro)


TINY = float(np.finfo(np.float64).tiny)


def _ftz(x):
    """XLA's CPU flush-to-zero applied to a float, or elementwise to a
    tuple / list / dict of them (the module docstring)."""
    if isinstance(x, float):
        return 0.0 if abs(x) < TINY else x
    if isinstance(x, (tuple, list)):
        return type(x)(_ftz(v) for v in x)
    if isinstance(x, dict):
        return {k: _ftz(v) for k, v in x.items()}
    return x


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


# ----------------------------------------------------------------------
# Router
# ----------------------------------------------------------------------


def test_stable_shard_is_pinned_across_processes():
    assert stable_shard("res0", 2) == 1
    assert stable_shard("res1", 2) == 0
    assert stable_shard("res0", 4) == 1
    assert stable_shard("solo-a", 4) == 3
    assert all(
        stable_shard("gamma", 8) == stable_shard("gamma", 8)
        for _ in range(10)
    )


def test_router_overrides_straddle_and_split():
    router = ShardRouter(
        4, overrides={"pinned": 2}, straddle=["shared"]
    )
    assert router.shard_of("pinned") == 2
    assert router.owners("pinned") == (2,)
    assert router.owners("shared") == (0, 1, 2, 3)
    assert router.is_straddling("shared")
    split = router.split(["res0", "res1", "pinned", "res0"])
    assert split[2] == ["pinned"]
    assert split[stable_shard("res0", 4)].count("res0") == 2
    with pytest.raises(ValueError):
        ShardRouter(4, overrides={"x": 7})
    with pytest.raises(ValueError):
        ShardRouter(0)


def test_shard_lock_key():
    assert shard_lock_key("/doorman/master", 3) == "/doorman/master/shard3"
    assert shard_lock_key("/doorman/master/", 0) == "/doorman/master/shard0"
    assert shard_lock_key("/doorman/master", -1) == "/doorman/master"


@pytest.mark.parametrize("n_shards", [2, 3, 4, 8])
def test_router_equals_the_reference_on_seeded_ids(n_shards):
    rng = np.random.default_rng(n_shards)
    ids = [
        f"r{int(i)}-{''.join(rng.choice(list('abcxyz'), 3))}"
        for i in rng.integers(0, 10**9, 1000)
    ]
    overrides = {ids[i]: int(i % n_shards) for i in range(0, 60, 7)}
    straddle = ids[100:110]
    ref = jfed.ShardRouter(n_shards, overrides=overrides, straddle=straddle)
    port = ShardRouter(n_shards, overrides=overrides, straddle=straddle)
    assert [stable_shard(i, n_shards) for i in ids] == [
        jfed.stable_shard(i, n_shards) for i in ids
    ]
    for rid in ids:
        assert port.shard_of(rid) == ref.shard_of(rid)
        assert port.owners(rid) == ref.owners(rid)
        assert port.is_straddling(rid) == ref.is_straddling(rid)
    assert port.split(ids) == ref.split(ids)
    assert port.status() == ref.status()


# ----------------------------------------------------------------------
# Discovery
# ----------------------------------------------------------------------


def test_discovery_cache_ttl_and_invalidate_on_redirect():
    clock = FakeClock()
    calls = []

    async def resolver(shard, seeds):
        calls.append(shard)
        return f"master{shard}:{len(calls)}"

    disc = ShardDiscovery(
        {0: "seed0", 1: ["seed1a", "seed1b"]},
        ttl=10.0, jitter=0.2, clock=clock,
        rng=random.Random(7), resolver=resolver,
    )

    async def body():
        addr = await disc.master(0)
        for _ in range(50):
            assert await disc.master(0) == addr
        assert calls == [0]
        assert disc.hits == 50
        clock.advance(10.0 * 0.79)
        await disc.master(0)
        assert calls == [0]
        clock.advance(10.0 * 0.42)
        await disc.master(0)
        assert calls == [0, 0]
        disc.note_master(0, "flipped:1")
        assert await disc.master(0) == "flipped:1"
        assert calls == [0, 0]
        disc.invalidate(0)
        await disc.master(1)
        await disc.master(0)
        assert calls == [0, 0, 1, 0]

    run(body())


def test_discovery_status_equals_the_reference_on_one_clock():
    """The same seeded jitter, resolutions, redirects and invalidations
    give the same cache deadlines and counters in both packages."""

    async def resolver(shard, seeds):
        return f"{seeds[0]}:m"

    async def drive(mod):
        clock = FakeClock()
        disc = mod.ShardDiscovery(
            {0: "a", 1: ["b", "c"], 2: "d"}, ttl=5.0, jitter=0.3,
            clock=clock, rng=random.Random(11), resolver=resolver,
        )
        for step in range(40):
            await disc.master(step % 3)
            if step % 7 == 3:
                disc.note_master(step % 3, f"x{step}")
            if step % 11 == 5:
                disc.invalidate((step + 1) % 3)
            clock.advance(0.9)
        return disc.status()

    assert run(drive(tfed)) == run(drive(jfed))


def test_discovery_resolves_over_grpc_through_a_standby():
    """The gRPC resolver walks the seeds: a master seed resolves to
    itself, a standby seed to the master address it reports, and a
    shard with no reachable seed raises ShardResolveError."""

    async def body():
        master = CapacityServer(
            "m", TrivialElection(), minimum_refresh_interval=0.0,
            device="cpu", flightrec_capacity=0,
        )
        mport = await master.start(0, host="127.0.0.1")
        await master.load_config(parse_yaml_config(ROOT_CONFIG_YAML))
        standby = CapacityServer(
            "s", TrivialElection(), minimum_refresh_interval=0.0,
            device="cpu", flightrec_capacity=0,
        )
        sport = await standby.start(0, host="127.0.0.1")
        standby.current_master = f"127.0.0.1:{mport}"
        try:
            disc = ShardDiscovery({
                0: f"127.0.0.1:{mport}", 1: f"127.0.0.1:{sport}",
                2: ["127.0.0.1:1"],
            })
            assert await disc.master(0) == f"127.0.0.1:{mport}"
            assert await disc.master(1) == f"127.0.0.1:{mport}"
            with pytest.raises(tfed.ShardResolveError):
                await disc.master(2)
            with pytest.raises(tfed.ShardResolveError):
                await disc.master(3)
        finally:
            await master.stop()
            await standby.stop()

    run(body())


# ----------------------------------------------------------------------
# Parity: federated == single root, over churn with straddling
# ----------------------------------------------------------------------

PARITY_TEMPLATES = (
    ("strad-none", pb.Algorithm.NO_ALGORITHM, 100.0),
    ("strad-static", pb.Algorithm.STATIC, 7.0),
    ("strad-prop", pb.Algorithm.PROPORTIONAL_SHARE, 400.0),
    ("strad-fair", pb.Algorithm.FAIR_SHARE, 300.0),
    ("solo-a", pb.Algorithm.PROPORTIONAL_SHARE, 50.0),
    ("solo-b", pb.Algorithm.PROPORTIONAL_SHARE, 64.0),
)

PARITY_SCHEDULE = (
    ("strad-none", "n0", 0, (10.0, 35.0, 20.0)),
    ("strad-none", "n1", 1, (50.0, 5.0, 40.0)),
    ("strad-static", "t0", 0, (3.0, 11.0, 5.0)),
    ("strad-static", "t1", 1, (9.0, 2.0, 13.0)),
    ("strad-prop", "p0", 0, (100.0, 40.0, 100.0)),
    ("strad-prop", "p1", 0, (150.0, 90.0, 150.0)),
    ("strad-prop", "p2", 1, (250.0, 500.0, 250.0)),
    ("strad-prop", "p3", 1, (300.0, 70.0, 300.0)),
    ("strad-fair", "f0", 0, (50.0, 500.0, 50.0)),
    ("strad-fair", "f1", 0, (100.0, 20.0, 100.0)),
    ("strad-fair", "f2", 1, (150.0, 60.0, 150.0)),
    ("strad-fair", "f3", 1, (200.0, 10.0, 200.0)),
    ("solo-a", "sa", None, (30.0, 80.0, 45.0)),
    ("solo-b", "sb", None, (64.0, 10.0, 128.0)),
)

ROUNDS_PER_PHASE = 6


def _parity_repo(pbmod=pb, templates=PARITY_TEMPLATES):
    repo = pbmod.ResourceRepository()
    for rid, kind, capacity, *variant in templates:
        tpl = repo.resources.add()
        tpl.identifier_glob = rid
        tpl.capacity = capacity
        tpl.algorithm.kind = kind
        tpl.algorithm.lease_length = 600
        tpl.algorithm.refresh_interval = 1
        tpl.algorithm.learning_mode_duration = 0
        if variant:
            param = tpl.algorithm.parameters.add()
            param.name, param.value = "variant", variant[0]
    tpl = repo.resources.add()
    tpl.identifier_glob = "*"
    tpl.capacity = 1.0
    tpl.algorithm.kind = pbmod.Algorithm.PROPORTIONAL_SHARE
    tpl.algorithm.lease_length = 600
    tpl.algorithm.refresh_interval = 1
    tpl.algorithm.learning_mode_duration = 0
    return repo


async def _make_batch_server(name, clock, shard=None, native=False,
                             flightrec=0, templates=PARITY_TEMPLATES):
    server = CapacityServer(
        name, TrivialElection(), mode="batch",
        minimum_refresh_interval=0.0, clock=clock, shard=shard,
        flightrec_capacity=flightrec, native_store=native, device="cpu",
    )
    await server.load_config(_parity_repo(pb, templates))
    await asyncio.sleep(0)
    return server


async def _make_ref_batch_server(name, clock, shard=None, native=False,
                                 flightrec=0, templates=PARITY_TEMPLATES):
    server = JServer(
        name, JElection(), mode="batch",
        minimum_refresh_interval=0.0, clock=clock, shard=shard,
        flightrec_capacity=flightrec, native_store=native,
    )
    await server.load_config(_parity_repo(jpb, templates))
    await asyncio.sleep(0)
    return server


@pytest.mark.parametrize("native", STORES)
def test_sharded_vs_single_root_parity_over_churn(native):
    async def body():
        clock = FakeClock()
        router = ShardRouter(
            2,
            straddle=[r for r, *_ in PARITY_TEMPLATES if r.startswith("strad")],
        )
        root = await _make_batch_server("root", clock, native=native)
        shards = {
            0: await _make_batch_server("shard0", clock, 0, native),
            1: await _make_batch_server("shard1", clock, 1, native),
        }
        fed = FederatedRoots(router, shards, share_ttl=30.0, clock=clock)
        has = {"root": {}, "fed": {}}
        try:
            fed.reconcile_once()
            for phase in range(3):
                for _ in range(ROUNDS_PER_PHASE):
                    for rid, client, placement, wants in PARITY_SCHEDULE:
                        w = wants[phase]
                        lease, _ = root._decide(
                            rid,
                            Request(
                                client,
                                has["root"].get((rid, client), 0.0),
                                w,
                            ),
                        )
                        has["root"][(rid, client)] = lease.has
                        shard = (
                            placement
                            if placement is not None
                            else router.shard_of(rid)
                        )
                        lease, _ = shards[shard]._decide(
                            rid,
                            Request(
                                client,
                                has["fed"].get((rid, client), 0.0),
                                w,
                            ),
                        )
                        has["fed"][(rid, client)] = lease.has
                    await root.tick_once()
                    for server in shards.values():
                        await server.tick_once()
                    fed.reconcile_once()
                    clock.advance(1.0)
                    for rid, kind, capacity in PARITY_TEMPLATES:
                        if kind not in (
                            pb.Algorithm.PROPORTIONAL_SHARE,
                            pb.Algorithm.FAIR_SHARE,
                        ) or not rid.startswith("strad"):
                            continue
                        total = sum(
                            s.resources[rid].store.sum_has
                            for s in shards.values()
                            if rid in s.resources
                        )
                        assert total <= capacity + 1e-6, (
                            phase, rid, total,
                        )
            for rid, client, placement, wants in PARITY_SCHEDULE:
                shard = (
                    placement
                    if placement is not None
                    else router.shard_of(rid)
                )
                got_root = root.resources[rid].store.get(client).has
                got_fed = (
                    shards[shard].resources[rid].store.get(client).has
                )
                if rid == "strad-fair":
                    assert (
                        abs(got_fed - got_root)
                        <= math.ulp(max(got_root, 1.0))
                    ), (rid, client, got_root, got_fed)
                else:
                    assert got_fed == got_root, (
                        rid, client, got_root, got_fed,
                    )
            assert has["root"][("strad-prop", "p0")] == 50.0
        finally:
            await root.stop()
            for server in shards.values():
                await server.stop()

    run(body())


# ----------------------------------------------------------------------
# Straddle reconciliation under partition (library level)
# ----------------------------------------------------------------------


@pytest.mark.parametrize("native", STORES)
def test_partition_freezes_share_then_decays_and_reoffers(native):
    async def body():
        clock = FakeClock()
        router = ShardRouter(2, straddle=["strad-prop"])
        shards = {
            0: await _make_batch_server("s0", clock, 0, native),
            1: await _make_batch_server("s1", clock, 1, native),
        }
        fed = FederatedRoots(router, shards, share_ttl=2.0, clock=clock)
        try:
            async def round_once(demands):
                for shard, client, w in demands:
                    shards[shard]._decide(
                        "strad-prop", Request(client, 0.0, w)
                    )
                for server in shards.values():
                    await server.tick_once()
                fed.reconcile_once()
                clock.advance(1.0)

            fed.reconcile_once()
            for _ in range(4):
                await round_once(
                    [(0, "a", 300.0), (1, "b", 500.0)]
                )
            rec = fed._reconcilers["strad-prop"]
            rec.lease_length = 3.0
            share0 = shards[0]._straddle_shares["strad-prop"]
            share1 = shards[1]._straddle_shares["strad-prop"]
            assert abs(share0 - 150.0) < 1e-9
            assert abs(share1 - 250.0) < 1e-9

            fed.blocked = {1}
            frozen_total = []
            for _ in range(3):
                await round_once([(0, "a", 300.0), (1, "b", 500.0)])
                frozen_total.append(
                    shards[0]._straddle_shares["strad-prop"]
                )
            assert all(abs(v - 150.0) < 1e-9 for v in frozen_total)
            assert shards[1].resources["strad-prop"].capacity == 0.0
            assert (
                shards[0]._straddle_shares["strad-prop"]
                + shards[1]._straddle_shares["strad-prop"]
                <= 400.0 + 1e-9
            )

            for _ in range(6):
                await round_once([(0, "a", 300.0)])
            assert (
                shards[0]._straddle_shares["strad-prop"] > 150.0 + 1e-9
            )
            assert (
                shards[0]._straddle_shares["strad-prop"] <= 400.0 + 1e-9
            )

            fed.blocked = set()
            for _ in range(4):
                await round_once([(0, "a", 300.0), (1, "b", 500.0)])
            assert (
                abs(shards[0]._straddle_shares["strad-prop"] - 150.0)
                < 1e-9
            )
            assert (
                abs(shards[1]._straddle_shares["strad-prop"] - 250.0)
                < 1e-9
            )
        finally:
            for server in shards.values():
                await server.stop()

    run(body())


# ----------------------------------------------------------------------
# Per-shard persistence namespaces + warm takeover
# ----------------------------------------------------------------------


def test_parse_backend_namespace_scopes_file_layout(tmp_path):
    root = str(tmp_path / "persist")
    b0 = parse_backend(f"file:{root}", namespace="shard0")
    b1 = parse_backend(f"file:{root}", namespace="shard1")
    b0.write_snapshot(b"zero")
    b1.write_snapshot(b"one")
    assert b0.read_snapshot() == b"zero"
    assert b1.read_snapshot() == b"one"
    assert (tmp_path / "persist" / "shard0" / "snapshot.bin").exists()
    assert (tmp_path / "persist" / "shard1" / "snapshot.bin").exists()
    with pytest.raises(ValueError):
        parse_backend(f"file:{root}", namespace="../evil")


@pytest.mark.parametrize("native", STORES)
def test_per_shard_warm_takeover_restores_only_the_shard(native):
    async def body():
        clock = FakeClock()
        backends = {0: MemoryBackend(), 1: MemoryBackend()}

        async def make(name, shard, backend):
            server = CapacityServer(
                name, TrivialElection(), mode="immediate",
                minimum_refresh_interval=0.0, clock=clock, shard=shard,
                persist=PersistManager(
                    backend, snapshot_interval=1.0,
                    flush_interval=1.0, clock=clock,
                ),
                flightrec_capacity=0, native_store=native, device="cpu",
            )
            await server.load_config(_parity_repo())
            await asyncio.sleep(0)
            return server

        a0 = await make("shard0-a", 0, backends[0])
        b1 = await make("shard1-a", 1, backends[1])
        try:
            a0._decide("solo-a", Request("c0", 0.0, 30.0))
            b1._decide("solo-b", Request("c1", 0.0, 40.0))
            clock.advance(2.0)
            a0.persist_step()
            b1.persist_step()
            await a0._on_is_master(False)
            a1 = await make("shard0-b", 0, backends[0])
            assert a1.last_restore is not None
            assert a1.last_restore["mode"] == "warm"
            assert a1.last_restore["leases_restored"] == 1
            assert "solo-a" in a1.resources
            assert "solo-b" not in a1.resources
            assert a1.resources["solo-a"].store.get("c0").has == 30.0
            assert b1.resources["solo-b"].store.get("c1").has == 40.0
            await a1.stop()
        finally:
            await a0.stop()
            await b1.stop()

    run(body())


# ----------------------------------------------------------------------
# The straddle reconciler against the reference
# ----------------------------------------------------------------------

LANE_KINDS = (
    AlgoKind.NO_ALGORITHM, AlgoKind.STATIC, AlgoKind.PROPORTIONAL_SHARE,
    AlgoKind.PROPORTIONAL_TOPUP, AlgoKind.FAIR_SHARE, AlgoKind.MAX_MIN_FAIR,
    AlgoKind.BALANCED_FAIRNESS, AlgoKind.PROPORTIONAL_FAIRNESS,
)


def _seeded_summaries(rng, n_shards, integer):
    """Per-shard breakpoint curves of a few clients each, as the two
    packages' ShardSummary constructor arguments."""
    out = {}
    for shard in range(n_shards):
        n = int(rng.integers(0, 6))
        wants = rng.integers(0, 200, n).astype(float)
        if not integer:
            wants = wants + rng.random(n)
        weights = rng.integers(1, 4, n).astype(float)
        by_ratio = {}
        for w, s in zip(wants, weights):
            acc = by_ratio.setdefault(float(w / s), [0.0, 0.0])
            acc[0] += float(w)
            acc[1] += float(s)
        out[shard] = dict(
            shard=shard, wants=float(wants.sum()),
            has=float(rng.integers(0, 100)), weight=float(weights.sum()),
            breakpoints=tuple(
                (r, by_ratio[r][0], by_ratio[r][1]) for r in sorted(by_ratio)
            ),
        )
    return out


@pytest.mark.parametrize("kind", LANE_KINDS, ids=lambda k: k.name)
def test_reconciler_shares_are_bit_identical_to_the_reference(kind):
    rng = np.random.default_rng(int(kind) + 40)
    n_shards = 3
    kw = dict(share_ttl=3.0, lease_length=2.0)
    ref = jfed.StraddleReconciler("strad", 500.0, int(kind), **kw)
    port = tfed.StraddleReconciler("strad", 500.0, int(kind), **kw)
    now = 100.0
    for beat in range(60):
        args = _seeded_summaries(rng, n_shards, integer=beat % 2 == 0)
        # A partition that starts at beat 20 and heals at beat 40: the
        # blocked shard's share freezes, lapses past ttl + lease length,
        # and is re-offered; a shard that reports nothing some beats.
        unreachable = {1} if 20 <= beat < 40 else set()
        if beat % 9 == 4:
            unreachable.add(2)
        live = [s for s in range(n_shards) if rng.random() < 0.9]
        got_ref = ref.reconcile(
            {s: jfed.ShardSummary(**args[s]) for s in live}, now,
            unreachable=unreachable,
        )
        got_port = port.reconcile(
            {s: tfed.ShardSummary(**args[s]) for s in live}, now,
            unreachable=unreachable,
        )
        assert got_port == got_ref, (beat, got_port, got_ref)
        assert port.last == ref.last
        assert port.status() == ref.status()
        if kind in (AlgoKind.PROPORTIONAL_SHARE, AlgoKind.FAIR_SHARE,
                    AlgoKind.MAX_MIN_FAIR, AlgoKind.BALANCED_FAIRNESS,
                    AlgoKind.PROPORTIONAL_FAIRNESS,
                    AlgoKind.PROPORTIONAL_TOPUP):
            assert sum(st["value"] for st in port.status()[
                "shares"].values()) <= 500.0 * (1 + 1e-12)
        now += float(rng.choice([0.5, 1.0, 2.5]))


def test_priority_bands_straddling_is_refused_in_both():
    for mod in (tfed, jfed):
        with pytest.raises(ValueError):
            mod.StraddleReconciler(
                "p", 10.0, int(AlgoKind.PRIORITY_BANDS), share_ttl=1.0
            )


# ----------------------------------------------------------------------
# FederatedRoots against the reference's
# ----------------------------------------------------------------------

# Every reconcilable lane straddles; the pointwise lanes too (full
# capacity on every shard); two resources route whole.
ROOTS_TEMPLATES = PARITY_TEMPLATES + (
    ("strad-maxmin", pb.Algorithm.FAIR_SHARE, 180.0, "maxmin"),
    ("strad-bal", pb.Algorithm.FAIR_SHARE, 240.0, "balanced"),
    ("strad-pf", pb.Algorithm.PROPORTIONAL_SHARE, 210.0, "logutil"),
    ("strad-topup", pb.Algorithm.PROPORTIONAL_SHARE, 260.0, "topup"),
)
ROOTS_STRADDLE = [r for r, *_ in ROOTS_TEMPLATES if r.startswith("strad")]


def _roots_schedule(rng, rounds):
    """(round, resource, client, placement, wants) over seeded churn."""
    clients = [
        (rid, f"{rid[-3:]}{i}", i % 2 if rid.startswith("strad") else None)
        for rid, *_ in ROOTS_TEMPLATES for i in range(4)
    ]
    out = []
    for rnd in range(rounds):
        for rid, client, placement in clients:
            if rnd and rng.random() < 0.4:
                continue
            out.append((rnd, rid, client, placement,
                        float(rng.integers(1, 160))))
    return out


@pytest.mark.parametrize("native", STORES)
def test_federated_roots_equal_the_reference(native):
    """The reference's FederatedRoots over reference shard servers and
    the port's over port shard servers, one fake clock, the same
    requests: installed shares, every grant, every shard's summaries and
    the flight record's federation beat equal; a partition on the way."""

    async def body():
        clock = FakeClock()
        mk = dict(native=native, flightrec=64, templates=ROOTS_TEMPLATES)
        ref_shards = {
            s: await _make_ref_batch_server(f"shard{s}", clock, s, **mk)
            for s in (0, 1)
        }
        port_shards = {
            s: await _make_batch_server(f"shard{s}", clock, s, **mk)
            for s in (0, 1)
        }
        ref = jfed.FederatedRoots(
            jfed.ShardRouter(2, straddle=ROOTS_STRADDLE), ref_shards,
            share_ttl=4.0, clock=clock,
        )
        port = FederatedRoots(
            ShardRouter(2, straddle=ROOTS_STRADDLE), port_shards,
            share_ttl=4.0, clock=clock,
        )
        has = ({}, {})
        try:
            assert port.reconcile_once() == ref.reconcile_once()
            schedule = _roots_schedule(np.random.default_rng(5), 14)
            for rnd in range(14):
                if rnd == 6:
                    ref.blocked = port.blocked = {1}
                if rnd == 10:
                    ref.blocked = port.blocked = set()
                for _r, rid, client, placement, wants in (
                    e for e in schedule if e[0] == rnd
                ):
                    shard = (
                        placement if placement is not None
                        else port.router.shard_of(rid)
                    )
                    for i, (shards, req) in enumerate((
                        (ref_shards, JRequest), (port_shards, Request),
                    )):
                        lease, _ = shards[shard]._decide(
                            rid, req(client, has[i].get((rid, client), 0.0),
                                     wants),
                        )
                        has[i][(rid, client)] = lease.has
                for shards in (ref_shards, port_shards):
                    for server in shards.values():
                        await server.tick_once()
                installed = (ref.reconcile_once(), port.reconcile_once())
                assert installed[1] == installed[0], rnd
                assert _ftz(has[1]) == _ftz(has[0]), rnd
                for s in (0, 1):
                    for rid in ROOTS_STRADDLE:
                        a = ref_shards[s].resources.get(rid)
                        b = port_shards[s].resources.get(rid)
                        assert (a is None) == (b is None)
                        if a is None:
                            continue
                        assert b.capacity == a.capacity, (rnd, s, rid)
                        assert _ftz(sorted(b.store.dump_rows())) == _ftz(
                            sorted(a.store.dump_rows())
                        ), (rnd, s, rid)
                        got = dict(tfed.summarize_resource(
                            b, s, kind=b._decide_kind
                        ).__dict__)
                        want = dict(jfed.summarize_resource(
                            a, s, kind=a._decide_kind
                        ).__dict__)
                        # `has` (never read by the share math) sums the
                        # rows' grants, subnormal ones included.
                        assert abs(got.pop("has") - want.pop("has")) <= (
                            len(b.store) * TINY
                        )
                        assert got == want, (rnd, s, rid)
                    assert (
                        port_shards[s].status()["federation"]
                        == ref_shards[s].status()["federation"]
                    )
                clock.advance(1.0)
            assert port.straddle_capacities() == ref.straddle_capacities()
            assert port.status() == ref.status()
            for s in (0, 1):
                recs = (ref_shards[s].flightrec.snapshot(),
                        port_shards[s].flightrec.snapshot())
                assert len(recs[0]) == len(recs[1]) == 14
                for a, b in zip(*recs):
                    for key in ("shard", "straddle_updates",
                                "upstream_rpcs", "straddle_capacity"):
                        assert a.get(key) == b.get(key), (s, key)
                    if native:
                        assert set(a) == set(b), (sorted(a), sorted(b))
        finally:
            for shards in (ref_shards, port_shards):
                for server in shards.values():
                    await server.stop()

    run(body())


@pytest.mark.parametrize("native", STORES)
def test_mastership_change_wipes_only_its_own_shard_shares(native):
    """Two shard roots in one process, each with its own store engine:
    one shard losing mastership drops its shares (and only its own), as
    the reference's does; both packages' federation blocks agree."""

    async def body():
        clock = FakeClock()
        out = {}
        for name, make, froots, router in (
            ("ref", _make_ref_batch_server, jfed.FederatedRoots,
             jfed.ShardRouter),
            ("port", _make_batch_server, FederatedRoots, ShardRouter),
        ):
            shards = {
                s: await make(f"shard{s}", clock, s, native)
                for s in (0, 1)
            }
            fed = froots(
                router(2, straddle=["strad-prop", "strad-fair"]), shards,
                share_ttl=30.0, clock=clock,
            )
            try:
                fed.reconcile_once()
                engines = {id(s._store_engine) for s in shards.values()}
                if native:
                    assert len(engines) == 2
                await shards[0]._on_is_master(False)
                out[name] = [s.status()["federation"] for s in
                             shards.values()]
                assert shards[0]._straddle_shares == {}
                assert shards[0].fed_stats["straddle_capacity"] == 0.0
                assert shards[1]._straddle_shares == {
                    "strad-fair": 150.0, "strad-prop": 200.0,
                }
            finally:
                for server in shards.values():
                    await server.stop()
        assert out["port"] == out["ref"]

    run(body())


# ----------------------------------------------------------------------
# Aggregation adapter (the device-backed intermediate tick)
# ----------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
def test_aggregation_adapter_matches_store_aggregation(dtype):
    rng = np.random.default_rng(3)
    agg = AggregationTickAdapter(dtype=dtype, device="cpu")
    expect = {}
    for r in range(9):
        n = int(rng.integers(1, 40))
        wants = rng.integers(0, 50, n).astype(np.float64)
        weights = rng.integers(1, 4, n).astype(np.float64)
        bands = rng.integers(0, 3, n).astype(np.int32)
        agg.update(f"res{r}", wants, weights, bands)
        rows = {}
        for w, s, b in zip(wants, weights, bands):
            acc = rows.setdefault(int(b), [0.0, 0.0])
            acc[0] += w
            acc[1] += s
        expect[f"res{r}"] = sorted(
            (b, w, int(round(s))) for b, (w, s) in rows.items() if w > 0
        )
    out = agg.step()
    assert set(out) == {r for r in expect if expect[r]}
    for rid, bands in out.items():
        got = [(b, w, c) for b, w, c in bands]
        want = expect[rid]
        assert [b for b, *_ in got] == [b for b, *_ in want]
        for (gb, gw, gc), (wb, ww, wc) in zip(got, want):
            assert gw == ww and gc == wc, (rid, got, want)
    assert agg.phase_s["aggregate"] > 0.0
    assert agg.ticks == 1

    agg.update("res0", [5.0], [1.0], [7])
    out = agg.step()
    assert out["res0"] == [(7, 5.0, 1)]
    assert out.get("res1") == expect["res1"]
    assert agg.ticks == 2


def _agg_tables(rng, n_res, integer, priorities=(0, 1, 5, 10)):
    tables = {}
    for r in range(n_res):
        n = int(rng.integers(0, 150))
        wants = rng.integers(0, 60, n).astype(np.float64)
        if not integer:
            wants = wants * rng.random(n)
        tables[f"res{r}"] = (
            wants,
            rng.integers(1, 5, n).astype(np.float64),
            rng.choice(priorities, n).astype(np.int32),
        )
    return tables


def _order_bound(dtype, k, value):
    """Two summation orders of k nonnegative terms differ by at most
    2 (k - 1) u of the sum (the module docstring)."""
    return 2.0 * max(k - 1, 1) * np.finfo(dtype).eps / 2.0 * abs(value)


@pytest.mark.parametrize("integer", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
def test_aggregation_adapter_equals_the_reference(dtype, integer):
    """The port's adapter and the reference's over the same seeded
    tables and the same dirty updates (a rebuild, a scatter of a few
    rows, a new band, a row wider than the slot pad, an idle step):
    equal band lists and client counts, and equal wants on integer
    demand; float demand within the order bound."""
    rng = np.random.default_rng(17 + integer)
    ref = jfed.AggregationTickAdapter(dtype=dtype)
    port = AggregationTickAdapter(dtype=dtype, device="cpu")
    tables = _agg_tables(rng, 40, integer)
    steps = [tables]
    for step in range(4):
        moved = {}
        for rid in rng.choice(sorted(tables), 6, replace=False):
            w, s, b = _agg_tables(rng, 1, integer)["res0"]
            moved[str(rid)] = (w, s, b)
        if step == 1:
            moved["res-new"] = _agg_tables(rng, 1, integer)["res0"]
        if step == 2:
            moved["res3"] = (np.full(70, 2.0), np.ones(70),
                             np.full(70, 7, np.int32))
        if step == 3:
            moved["res-wide"] = _agg_tables(rng, 1, integer)["res0"]
            n = 200
            moved["res-wide"] = (
                rng.integers(0, 9, n).astype(np.float64),
                np.ones(n), rng.choice((0, 1, 5, 10), n).astype(np.int32),
            )
        steps.append(moved)
    steps.append({})
    for step, rows in enumerate(steps):
        for rid, (w, s, b) in rows.items():
            ref.update(rid, w, s, b)
            port.update(rid, w, s, b)
        got, want = port.step(), ref.step()
        assert sorted(got) == sorted(want), step
        for rid in want:
            assert [(b, c) for b, _w, c in got[rid]] == [
                (b, c) for b, _w, c in want[rid]
            ], (step, rid)
            for (_b, gw, _c), (_b2, ww, _c2) in zip(got[rid], want[rid]):
                if integer:
                    assert gw == ww, (step, rid, gw, ww)
                else:
                    k = port._wants_h.shape[1]
                    assert abs(gw - ww) <= _order_bound(dtype, k, ww), (
                        step, rid, gw, ww,
                    )
    assert port.ticks == ref.ticks == len(steps)
    assert set(port.phase_s) == set(ref.phase_s)


@pytest.mark.skipif(not tnative.native_available(),
                    reason="native engine unavailable")
def test_aggregation_adapter_equals_native_band_aggregates():
    """The device sums of the port's adapter equal the native store's
    own C aggregation (`band_aggregates`) on the same leases, f64,
    integer wants: exact."""
    rng = np.random.default_rng(23)
    engine = tnative.StoreEngine()
    agg = AggregationTickAdapter(dtype=np.float64, device="cpu")
    stores = {}
    for r in range(30):
        store = engine.store(f"r{r}")
        for c in range(int(rng.integers(1, 120))):
            store.assign(
                f"c{c}", 60.0, 1.0, 0.0, float(rng.integers(0, 40)),
                int(rng.integers(1, 4)), priority=int(
                    rng.choice((0, 1, 5, 10))),
            )
        stores[f"r{r}"] = store
        rows = store.dump_rows()
        agg.update(f"r{r}", [x[4] for x in rows],
                   [max(float(x[5]), 1.0) for x in rows],
                   [x[6] for x in rows])
    out = agg.step()
    for rid, store in stores.items():
        want = [
            (p, w, n) for p, w, n in sorted(store.band_aggregates())
            if w > 0
        ]
        assert out.get(rid, []) == want, rid


def test_aggregation_adapter_is_on_the_asked_device():
    agg = AggregationTickAdapter(dtype=np.float32, device="cpu")
    agg.update("r", [1.0, 2.0], [1.0, 1.0], [0, 5])
    agg.step()
    assert agg.device.type == "cpu"
    assert agg._wants_d.device.type == "cpu"
    assert agg._wants_d.dtype.itemsize == 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            AggregationTickAdapter()


# ----------------------------------------------------------------------
# Federated intermediate end to end (loopback gRPC)
# ----------------------------------------------------------------------

ROOT_CONFIG_YAML = """
resources:
- identifier_glob: "*"
  capacity: 100
  algorithm: {kind: PROPORTIONAL_SHARE, lease_length: 60,
              refresh_interval: 1, learning_mode_duration: 0}
"""


def capacity_request(client_id, resource_id, wants, priority=0, pbmod=pb):
    req = pbmod.GetCapacityRequest(client_id=client_id)
    rr = req.resource.add()
    rr.resource_id = resource_id
    rr.wants = wants
    rr.priority = priority
    return req


async def _port_roots(clock=None, **kw):
    roots, addrs = {}, {}
    for shard in (0, 1):
        server = CapacityServer(
            f"root{shard}", TrivialElection(),
            minimum_refresh_interval=0.0, shard=shard,
            flightrec_capacity=0, device="cpu",
            **({"clock": clock} if clock else {}), **kw,
        )
        port = await server.start(0, host="127.0.0.1")
        await server.load_config(parse_yaml_config(ROOT_CONFIG_YAML))
        await asyncio.sleep(0)
        server.current_master = f"127.0.0.1:{port}"
        roots[shard] = server
        addrs[shard] = f"127.0.0.1:{port}"
    return roots, addrs


async def _ref_roots(clock=None):
    roots, addrs = {}, {}
    for shard in (0, 1):
        server = JServer(
            f"root{shard}", JElection(),
            minimum_refresh_interval=0.0, shard=shard,
            flightrec_capacity=0,
            **({"clock": clock} if clock else {}),
        )
        port = await server.start(0, host="127.0.0.1")
        await server.load_config(j_parse(ROOT_CONFIG_YAML))
        await asyncio.sleep(0)
        server.current_master = f"127.0.0.1:{port}"
        roots[shard] = server
        addrs[shard] = f"127.0.0.1:{port}"
    return roots, addrs


INTER_KINDS = [
    pytest.param("immediate", False, id="immediate-python"),
    pytest.param("batch", True, id="batch-native", marks=NATIVE.marks),
]


@pytest.mark.parametrize("mode,native", INTER_KINDS)
def test_federated_intermediate_fans_out_per_shard(mode, native):
    async def body():
        roots, addrs = await _port_roots()
        router = ShardRouter(2)
        assert router.shard_of("res1") == 0
        assert router.shard_of("res0") == 1

        async def resolver(shard, seeds):
            return addrs[shard]

        discovery = ShardDiscovery(
            {0: addrs[0], 1: addrs[1]}, resolver=resolver
        )
        inter = FederatedIntermediate(
            "inter", TrivialElection(),
            router=router, discovery=discovery,
            minimum_refresh_interval=0.0,
            flightrec_capacity=0, device="cpu", mode=mode,
            native_store=native,
        )
        port = await inter.start(0, host="127.0.0.1", tick_loop=False)
        await asyncio.sleep(0)
        inter.current_master = f"127.0.0.1:{port}"
        for t in inter._tasks:
            t.cancel()
        inter._tasks.clear()
        try:
            inter.became_master_at -= 1000
            async with grpc.aio.insecure_channel(
                f"127.0.0.1:{port}"
            ) as ch:
                stub = CapacityStub(ch)
                grants = {}
                for _ in range(40):
                    for rid in ("res0", "res1"):
                        res = inter.resources.get(rid)
                        if res is not None:
                            res.learning_mode_end = 0.0
                    o0 = await stub.GetCapacity(
                        capacity_request("ca", "res0", 40.0)
                    )
                    o1 = await stub.GetCapacity(
                        capacity_request("cb", "res1", 30.0)
                    )
                    grants = {
                        "res0": o0.response[0].gets.capacity,
                        "res1": o1.response[0].gets.capacity,
                    }
                    await inter._perform_parent_requests(0)
                    if mode == "batch":
                        await inter.tick_once()
                    if grants == {"res0": 40.0, "res1": 30.0}:
                        break
                assert grants == {"res0": 40.0, "res1": 30.0}, grants

            assert "res0" in roots[1].resources
            assert "res0" not in roots[0].resources
            assert "res1" in roots[0].resources
            assert "res1" not in roots[1].resources
            assert inter.fed_stats["upstream_rpcs"] >= 2
            assert inter.aggregator.ticks >= 1
            assert inter.aggregator.phase_s["aggregate"] > 0.0
            assert inter.status()["federation"]["upstream_rpcs"] >= 2
        finally:
            await inter.stop()
            for server in roots.values():
                await server.stop()

    run(body())


def test_federated_intermediate_failed_shard_as_the_reference():
    """A root shard that is down, port and reference side by side (each
    over its own package's roots, one fake clock): the failed shard's
    discovery entry is invalidated, the retry number moves, the live
    shard's resource is re-granted, and the dead shard's resource falls
    to the default template's capacity 0 at once in both packages (the
    merged template load re-templates every resource; the reference's
    docstring says it keeps its expiring lease). With every shard down
    the exchange backs off."""

    async def drive(name):
        clock = FakeClock()
        if name == "port":
            roots, addrs = await _port_roots(clock)
            mod, req, kw = tfed, Request, {"device": "cpu"}
            inter_cls, elect = FederatedIntermediate, TrivialElection
        else:
            roots, addrs = await _ref_roots(clock)
            mod, req, kw = jfed, JRequest, {}
            inter_cls, elect = jfed.FederatedIntermediate, JElection

        async def resolver(shard, seeds):
            return addrs[shard]

        discovery = mod.ShardDiscovery(
            {0: addrs[0], 1: addrs[1]}, resolver=resolver, clock=clock,
            rng=random.Random(1),
        )
        inter = inter_cls(
            "inter", elect(), router=mod.ShardRouter(2),
            discovery=discovery, minimum_refresh_interval=0.0,
            flightrec_capacity=0, clock=clock, **kw,
        )
        await inter.start(0, host="127.0.0.1")
        for t in inter._tasks:
            t.cancel()
        inter._tasks.clear()
        seen = []
        try:
            inter.became_master_at -= 1000
            for rid, client, wants in (("res0", "ca", 40.0),
                                       ("res1", "cb", 30.0)):
                inter._decide(rid, req(client, 0.0, wants))
                inter.resources[rid].learning_mode_end = 0.0

            def caps():
                return {rid: (r.capacity, r.parent_expiry)
                        for rid, r in sorted(inter.resources.items())}

            seen.append((await inter._perform_parent_requests(0), caps()))
            await roots[1].stop()
            seen.append((await inter._perform_parent_requests(0), caps()))
            assert 1 not in discovery.status()["cache"]
            await roots[0].stop()
            seen.append((await inter._perform_parent_requests(3), caps()))
            seen.append(dict(inter.fed_stats))
        finally:
            await inter.stop()
            for server in roots.values():
                await server.stop()
        return seen

    port, ref = run(drive("port")), run(drive("ref"))
    assert port == ref
    (_ok, caps0), ((_i1, retry1), caps1), ((i2, retry2), _c2) = port[:3]
    assert caps0["res0"][0] == 40.0 and caps0["res1"][0] == 30.0
    assert retry1 == 1
    assert caps1["res1"][0] == 30.0
    assert caps1["res0"] == (0.0, None)
    assert retry2 == 4 and i2 > 0


def _inter_requests(rng, rounds):
    out = []
    for _ in range(rounds):
        for c in range(8):
            for r in range(6):
                if rng.random() < 0.5:
                    continue
                out.append((f"c{c}", f"res{r}", float(rng.integers(1, 50)),
                            int(rng.choice((0, 1, 5)))))
        out.append(None)  # an exchange
    return out


def test_intermediates_over_loopback_equal_across_packages():
    """A port FederatedIntermediate over reference shard roots beside a
    reference FederatedIntermediate over port shard roots, one fake
    clock, the same client requests: the per-shard upstream requests
    are byte-equal, every grant the roots store for the band sub-leases
    is equal, and the intermediates' re-templated capacities and client
    answers are equal."""

    async def body():
        clock = FakeClock()
        ref_roots, ref_addrs = await _ref_roots(clock)
        port_roots, port_addrs = await _port_roots(clock)
        inters = {}
        for name, mod, addrs, cls_kw in (
            ("port", tfed, ref_addrs, {"device": "cpu"}),
            ("ref", jfed, port_addrs, {}),
        ):
            async def resolver(shard, seeds, addrs=addrs):
                return addrs[shard]

            inter = (FederatedIntermediate if mod is tfed
                     else jfed.FederatedIntermediate)(
                "inter",
                TrivialElection() if mod is tfed else JElection(),
                router=mod.ShardRouter(2),
                discovery=mod.ShardDiscovery(
                    dict(addrs), resolver=resolver, clock=clock,
                    rng=random.Random(3),
                ),
                minimum_refresh_interval=0.0, flightrec_capacity=0,
                clock=clock, **cls_kw,
            )
            await inter.start(0, host="127.0.0.1")
            for t in inter._tasks:
                t.cancel()
            inter._tasks.clear()
            inter.became_master_at -= 1000
            inters[name] = inter
        try:
            rng = np.random.default_rng(9)
            exchanges = 0
            for item in _inter_requests(rng, 5):
                if item is None:
                    built = {
                        n: {s: r.SerializeToString() for s, r in
                            i._build_shard_requests().items()}
                        for n, i in inters.items()
                    }
                    assert built["port"] == built["ref"]
                    assert len(built["port"]) == 2
                    for inter in inters.values():
                        await inter._perform_parent_requests(0)
                    exchanges += 1
                    for s in (0, 1):
                        a, b = ref_roots[s], port_roots[s]
                        assert sorted(a.resources) == sorted(b.resources)
                        for rid in a.resources:
                            assert sorted(
                                a.resources[rid].store.dump_rows()
                            ) == sorted(b.resources[rid].store.dump_rows())
                    for rid, res in inters["ref"].resources.items():
                        got = inters["port"].resources[rid]
                        assert got.capacity == res.capacity, rid
                    clock.advance(1.0)
                    continue
                client, rid, wants, prio = item
                outs = []
                for name, pbmod in (("port", pb), ("ref", jpb)):
                    inter = inters[name]
                    res = inter.resources.get(rid)
                    if res is not None:
                        res.learning_mode_end = 0.0
                    out = await inter.GetCapacity(
                        capacity_request(client, rid, wants, prio, pbmod),
                        None,
                    )
                    outs.append(out.SerializeToString())
                assert outs[0] == outs[1], item
            assert exchanges == 5
            assert inters["port"].fed_stats == inters["ref"].fed_stats
        finally:
            for inter in inters.values():
                await inter.stop()
            for roots in (ref_roots, port_roots):
                for server in roots.values():
                    await server.stop()

    run(body())


# ----------------------------------------------------------------------
# Federated client fan-out
# ----------------------------------------------------------------------


def test_federated_client_fans_refreshes_to_owning_shards():
    async def body():
        roots, addrs = await _port_roots()
        router = ShardRouter(2, straddle=["shared"])
        resolutions = []

        async def resolver(shard, seeds):
            resolutions.append(shard)
            return addrs[shard]

        discovery = ShardDiscovery(
            {0: addrs[0], 1: addrs[1]}, resolver=resolver
        )
        client = FederatedClient(
            router, discovery, client_id="fc0", background=False,
            minimum_refresh_interval=0.0, max_retries=0,
        )
        try:
            await client.resource("res1", 30.0)
            await client.resource("res0", 40.0)
            await client.resource("shared", 10.0, shard=0)
            with pytest.raises(ValueError):
                await client.resource("res2", 5.0, shard=1)
            assert await client.refresh_once()
            assert client.current_capacity("res1") == 30.0
            assert client.current_capacity("res0") == 40.0
            assert client.current_capacity("shared") == 10.0
            assert sorted(resolutions) == [0, 1]
            await client.refresh_once()
            assert sorted(resolutions) == [0, 1]
            assert "res1" in roots[0].resources
            assert "res1" not in roots[1].resources
            assert "res0" in roots[1].resources
            assert "shared" in roots[0].resources
            assert set(client.status()["shards"]) == {0, 1}
        finally:
            await client.close()
            for server in roots.values():
                await server.stop()

    run(body())
