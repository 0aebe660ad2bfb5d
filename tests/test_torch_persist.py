"""Persistence of the port (doorman_tpu_torch/persist/): snapshot/journal
round-trip, crash replay, expiry-aware compaction, warm master takeover —
the port's counterpart of every case in tests/test_persist.py, run
against the port's modules and server (device="cpu").

Beside them, cross-package cases, the JAX package run on the CPU as its
own tests run it:

  * both packages' servers, same id, one fake clock, the same seeded
    leases: `encode(take_snapshot(...))` gives the same bytes (Python
    and native store);
  * a snapshot and a journal written by either package restore into the
    other with equal `dump_rows()` (both stores);
  * after a warm restore from one backend, the reference's batch server
    and the port's (device="cpu", f64, native store) tick from the
    restored state: their stores hold equal rows after every tick, the
    bound tests/test_torch_server.py holds them to.
"""

import asyncio
import json

import numpy as np
import pytest

import tests.conftest  # noqa: F401

from doorman_tpu_torch.core.lease import Lease
from doorman_tpu_torch.persist import PersistManager
from doorman_tpu_torch.persist import journal as journal_mod
from doorman_tpu_torch.persist import snapshot as snapshot_mod
from doorman_tpu_torch.persist.backend import (
    FileBackend,
    MemoryBackend,
    parse_backend,
)
from doorman_tpu_torch.persist.restore import learning_end_for
from doorman_tpu_torch.persist.snapshot import SnapshotError
from doorman_tpu_torch.server.config import parse_yaml_config
from doorman_tpu_torch.server.election import TrivialElection
from doorman_tpu_torch.server.server import CapacityServer

CONFIG = """
resources:
- identifier_glob: "*"
  capacity: 100
  algorithm: {kind: PROPORTIONAL_SHARE, lease_length: 30,
              refresh_interval: 1, learning_mode_duration: 10}
"""


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


# ---------------------------------------------------------------------------
# Backends
# ---------------------------------------------------------------------------


def test_file_backend_snapshot_atomic_and_journal(tmp_path):
    b = FileBackend(str(tmp_path / "persist"))
    assert b.read_snapshot() is None
    b.write_snapshot(b"snap-1")
    b.write_snapshot(b"snap-2")
    assert b.read_snapshot() == b"snap-2"

    assert b.read_journal() == []
    b.append_journal([b"one", b"two"])
    b.append_journal([b"three"])
    assert b.read_journal() == [b"one", b"two", b"three"]
    b.reset_journal([b"four"])
    assert b.read_journal() == [b"four"]
    b.reset_journal()
    assert b.read_journal() == []


def test_file_backend_surfaces_torn_tail(tmp_path):
    b = FileBackend(str(tmp_path))
    b.append_journal([b'[1,0,"d"]', b'[2,0,"d"]'])
    with open(b._journal_path, "ab") as f:
        f.write(b'[3,0,"d')  # crash mid-append: no newline, torn JSON
    lines = b.read_journal()
    assert lines[-1] == b'[3,0,"d'  # surfaced raw ...
    recs = journal_mod.read_records(lines)
    assert [r.seq for r in recs] == [1, 2]  # ... and dropped by the parser


def test_parse_backend_specs(tmp_path):
    assert isinstance(
        parse_backend(f"file:{tmp_path}/p"), FileBackend
    )
    with pytest.raises(ValueError):
        parse_backend("file")
    with pytest.raises(ValueError):
        parse_backend("s3:bucket")
    with pytest.raises(ValueError):
        parse_backend("etcd:/doorman/persist")  # no endpoints


# ---------------------------------------------------------------------------
# Snapshot framing
# ---------------------------------------------------------------------------


def _sample_snapshot():
    return snapshot_mod.MasterSnapshot(
        server_id="s0",
        taken_at=123.5,
        became_master_at=100.0,
        config_epoch=7,
        seq=42,
        resources=[
            snapshot_mod.ResourceSnapshot(
                id="r0",
                learning_mode_end=110.0,
                rows=[("c0", 150.0, 1.0, 10.0, 20.0, 1, 0),
                      ("c1", 151.0, 1.0, 30.0, 30.0, 2, 1)],
            )
        ],
        server_bands=[("r0", "child", [0, 1])],
    )


def test_snapshot_round_trip():
    snap = _sample_snapshot()
    data = snapshot_mod.encode(snap)
    again = snapshot_mod.decode(data)
    assert again == snap
    # Canonical: encoding the decoded snapshot is a fixpoint.
    assert snapshot_mod.encode(again) == data


def test_snapshot_rejects_corruption():
    data = snapshot_mod.encode(_sample_snapshot())
    flipped = data[:-5] + bytes([data[-5] ^ 0x01]) + data[-4:]
    with pytest.raises(SnapshotError):
        snapshot_mod.decode(flipped)
    with pytest.raises(SnapshotError):
        snapshot_mod.decode(data[: len(data) // 2])  # truncated payload
    header, _, body = data.partition(b"\n")
    env = json.loads(header)
    env["format"] = 99
    with pytest.raises(SnapshotError):
        snapshot_mod.decode(
            json.dumps(env).encode() + b"\n" + body
        )


# ---------------------------------------------------------------------------
# Journal: replay after a mid-interval crash, compaction
# ---------------------------------------------------------------------------


def _lease(expiry, has=5.0, wants=10.0):
    return Lease(expiry=expiry, refresh_interval=1.0, has=has,
                 wants=wants, subclients=1, priority=0)


def test_journal_replay_after_mid_interval_crash(tmp_path):
    b = FileBackend(str(tmp_path))
    j = journal_mod.Journal(b)
    j.record_assign(1.0, "r0", "c0", _lease(100.0))
    j.record_assign(2.0, "r0", "c1", _lease(101.0))
    j.flush()
    j.record_assign(3.0, "r0", "c2", _lease(102.0))
    # CRASH: the third record was never flushed. A new writer process
    # reads back only the flushed prefix.
    recs = journal_mod.read_records(b.read_journal())
    assert [(r.resource, r.client) for r in recs] == [
        ("r0", "c0"), ("r0", "c1")
    ]
    # Replayed leases carry their exact values.
    assert recs[0].lease == _lease(100.0)


def test_journal_sequence_regression_fences_stale_suffix():
    b = MemoryBackend()
    b.append_journal([b'[5,1.0,"d"]', b'[3,2.0,"d"]', b'[6,3.0,"d"]'])
    recs = journal_mod.read_records(b.read_journal())
    # Stop at the first regression — everything after is suspect.
    assert [r.seq for r in recs] == [5]


def test_journal_compaction_is_expiry_aware():
    b = MemoryBackend()
    j = journal_mod.Journal(b)
    j.record_assign(1.0, "r0", "dead", _lease(50.0))      # expires
    j.record_assign(2.0, "r0", "live", _lease(500.0, has=1.0))
    j.record_assign(3.0, "r0", "live", _lease(500.0, has=2.0))  # superseded
    j.record_assign(4.0, "r0", "gone", _lease(500.0))
    j.record_release(5.0, "r0", "gone")
    j.record_down(6.0)
    j.flush()
    before, after = j.compact(now=100.0)
    assert before == 6
    recs = journal_mod.read_records(b.read_journal())
    kinds = [(r.kind, r.client) for r in recs]
    # Kept: the live client's LAST assign, the release (the snapshot
    # underneath might still carry "gone"), the step-down marker.
    assert kinds == [
        ("a", "live"), ("r", "gone"), ("d", "")
    ]
    assert recs[0].lease.has == 2.0
    assert after == 3
    # Seqs survive compaction untouched (snapshot fencing still works).
    assert [r.seq for r in recs] == [3, 5, 6]


# ---------------------------------------------------------------------------
# Warm takeover end to end (server-level)
# ---------------------------------------------------------------------------


def _mk_server(backend, clock, *, server_id="s0", native=False,
               snapshot_interval=5.0):
    persist = PersistManager(
        backend, snapshot_interval=snapshot_interval,
        flush_interval=1.0, clock=clock,
    )
    return CapacityServer(
        server_id, TrivialElection(), mode="immediate",
        clock=clock, native_store=native, persist=persist, device="cpu",
    )


def _decide(server, resource, client, wants, has=0.0):
    from doorman_tpu_torch.algorithms import Request

    lease, _ = server._decide(resource, Request(client, has, wants, 1))
    return lease


async def _configured(server):
    await server.load_config(parse_yaml_config(CONFIG))
    return server


def _store_rows(server, rid):
    return sorted(server.resources[rid].store.dump_rows())


@pytest.mark.parametrize("native", [False, True])
def test_snapshot_restore_round_trip_byte_identical(native):
    if native:
        from doorman_tpu_torch import native as native_mod

        if not native_mod.native_available():
            pytest.skip("native store engine unavailable")

    async def run():
        clock = FakeClock()
        backend = MemoryBackend()
        s0 = await _configured(_mk_server(backend, clock, native=native))
        # Out of learning mode: decide real grants.
        s0.resources = {}
        s0.became_master_at = clock.t - 1000.0
        for i in range(5):
            _decide(s0, "r0", f"c{i}", wants=10.0 * (i + 1))
        clock.advance(1.0)
        s0.persist_step()  # flush + first snapshot
        want = _store_rows(s0, "r0")
        assert len(want) == 5

        clock.advance(1.0)
        s1 = await _configured(
            _mk_server(backend, clock, server_id="s1", native=native)
        )
        assert s1.last_restore is not None
        assert s1.last_restore["mode"] == "warm"
        assert s1.last_restore["leases_restored"] == 5
        # Byte-identical store state: every lease row round-trips,
        # including absolute expiry stamps.
        assert _store_rows(s1, "r0") == want
        await s0.stop()
        await s1.stop()

    asyncio.run(run())


def test_journal_covers_post_snapshot_deltas_and_releases():
    async def run():
        clock = FakeClock()
        backend = MemoryBackend()
        s0 = await _configured(_mk_server(backend, clock))
        s0.resources = {}
        s0.became_master_at = clock.t - 1000.0
        _decide(s0, "r0", "c0", wants=10.0)
        _decide(s0, "r0", "c1", wants=20.0)
        s0.persist_step()  # snapshot covers c0, c1
        # Post-snapshot deltas ride the journal only:
        _decide(s0, "r0", "c2", wants=30.0)
        _decide(s0, "r0", "c0", wants=15.0)  # demand change
        s0.resources["r0"].release("c1")
        s0._persist.record_release("r0", "c1")
        s0._persist.journal.flush()  # crash before the next snapshot
        want = _store_rows(s0, "r0")

        clock.advance(1.0)
        s1 = await _configured(_mk_server(backend, clock, server_id="s1"))
        assert s1.last_restore["mode"] == "warm"
        assert _store_rows(s1, "r0") == want
        assert not s1.resources["r0"].store.has_client("c1")
        await s0.stop()
        await s1.stop()

    asyncio.run(run())


def test_restore_drops_expired_and_clamps_overcommit():
    async def run():
        clock = FakeClock()
        backend = MemoryBackend()
        s0 = await _configured(_mk_server(backend, clock))
        s0.resources = {}
        s0.became_master_at = clock.t - 1000.0
        res = s0.resources  # noqa: F841
        r = s0.get_or_create_resource("r0")
        # Hand-build grants that will overcommit a capacity cut and one
        # lease that expires before the takeover.
        r.store.assign("big", 30.0, 1.0, 80.0, 80.0, 1)
        r.store.assign("small", 30.0, 1.0, 40.0, 40.0, 1)
        r.store.assign("lapsing", 2.0, 1.0, 10.0, 10.0, 1)
        for c in ("big", "small", "lapsing"):
            s0._persist.record_assign("r0", c, r.store.get(c))
        s0.persist_step()

        clock.advance(5.0)  # "lapsing" is now expired
        s1 = await _configured(_mk_server(backend, clock, server_id="s1"))
        info = s1.last_restore["resources"]["r0"]
        assert s1.last_restore["leases_dropped_expired"] == 1
        assert info["clamped"] is True
        store = s1.resources["r0"].store
        assert not store.has_client("lapsing")
        # Restored grants never exceed capacity (120 -> scaled to 100).
        assert store.sum_has == pytest.approx(100.0)
        assert store.get("big").has == pytest.approx(80.0 * 100.0 / 120.0)
        await s0.stop()
        await s1.stop()

    asyncio.run(run())


def test_corrupt_snapshot_falls_back_to_cold():
    async def run():
        clock = FakeClock()
        backend = MemoryBackend()
        s0 = await _configured(_mk_server(backend, clock))
        s0.resources = {}
        s0.became_master_at = clock.t - 1000.0
        _decide(s0, "r0", "c0", wants=10.0)
        s0.persist_step()
        backend._snapshot = b"garbage" + backend._snapshot[10:]

        clock.advance(1.0)
        s1 = await _configured(_mk_server(backend, clock, server_id="s1"))
        assert s1.last_restore["mode"] == "cold_error"
        assert s1.resources == {}  # exactly the reference's cold wipe
        await s0.stop()
        await s1.stop()

    asyncio.run(run())


def test_learning_mode_semantics():
    # Clean step-down: journal complete -> skip outright.
    end, kind = learning_end_for(
        age=500.0, clean_down=True, duration=10.0, became_master_at=1000.0
    )
    assert (end, kind) == (0.0, "skip")
    # Crash with fresh state -> shorten to exactly the staleness.
    end, kind = learning_end_for(
        age=3.0, clean_down=False, duration=10.0, became_master_at=1000.0
    )
    assert (end, kind) == (1003.0, "shorten")
    # Stale beyond the window -> the cold path.
    end, kind = learning_end_for(
        age=30.0, clean_down=False, duration=10.0, became_master_at=1000.0
    )
    assert (end, kind) == (1010.0, "cold")  # the full window, no more
    # No learning window configured: nothing to skip.
    assert learning_end_for(
        age=0.0, clean_down=False, duration=0.0, became_master_at=1000.0
    ) == (0.0, "skip")


def test_warm_takeover_skips_learning_after_clean_step_down():
    async def run():
        clock = FakeClock()
        backend = MemoryBackend()
        s0 = await _configured(_mk_server(backend, clock))
        s0.resources = {}
        s0.became_master_at = clock.t - 1000.0
        _decide(s0, "r0", "c0", wants=10.0)
        s0.persist_step()
        # Clean step-down writes the terminal marker.
        await s0._on_is_master(False)

        clock.advance(3.0)
        s1 = await _configured(_mk_server(backend, clock, server_id="s1"))
        assert s1.last_restore["clean_down"] is True
        info = s1.last_restore["resources"]["r0"]
        assert info["learning"] == "skip"
        assert not s1.resources["r0"].in_learning_mode
        await s0.stop()
        await s1.stop()

    asyncio.run(run())


def test_crash_takeover_shortens_learning():
    async def run():
        clock = FakeClock()
        backend = MemoryBackend()
        s0 = await _configured(_mk_server(backend, clock))
        s0.resources = {}
        s0.became_master_at = clock.t - 1000.0
        _decide(s0, "r0", "c0", wants=10.0)
        s0.persist_step()
        # NO step-down marker: s0 just dies.

        clock.advance(4.0)
        s1 = await _configured(_mk_server(backend, clock, server_id="s1"))
        info = s1.last_restore["resources"]["r0"]
        assert info["learning"] == "shorten"
        res = s1.resources["r0"]
        assert res.in_learning_mode
        # Learning covers exactly the 4s staleness, not the full 10s.
        assert res.learning_mode_end == pytest.approx(clock.t + 4.0)
        await s0.stop()
        await s1.stop()

    asyncio.run(run())


def test_server_bands_rebuilt_from_restore():
    async def run():
        from doorman_tpu_torch.server.server import _band_key

        clock = FakeClock()
        backend = MemoryBackend()
        s0 = await _configured(_mk_server(backend, clock))
        s0.resources = {}
        s0.became_master_at = clock.t - 1000.0
        r = s0.get_or_create_resource("r0")
        bkey = _band_key("downstream", 1)
        r.store.assign(bkey, 30.0, 1.0, 5.0, 5.0, 3, priority=1)
        s0._persist.record_assign("r0", bkey, r.store.get(bkey))
        s0._server_bands[("r0", "downstream")] = {1}
        s0.persist_step()

        clock.advance(1.0)
        s1 = await _configured(_mk_server(backend, clock, server_id="s1"))
        assert s1._server_bands == {("r0", "downstream"): {1}}
        await s0.stop()
        await s1.stop()

    asyncio.run(run())


def test_persist_obs_spans_and_metrics():
    """Snapshot/restore land `persist.*` spans on the tracer and move
    the default-registry gauges/histograms."""
    from doorman_tpu_torch.obs import metrics as metrics_mod
    from doorman_tpu_torch.obs import trace as trace_mod

    async def run():
        tracer = trace_mod.default_tracer()
        tracer.enable(capacity=4096)
        tracer.clear()
        try:
            clock = FakeClock()
            backend = MemoryBackend()
            s0 = await _configured(_mk_server(backend, clock))
            s0.resources = {}
            s0.became_master_at = clock.t - 1000.0
            _decide(s0, "r0", "c0", wants=10.0)
            s0.persist_step()
            clock.advance(1.0)
            s1 = await _configured(
                _mk_server(backend, clock, server_id="s1")
            )
            names = {s.name for s in tracer.snapshot()}
            assert "persist.snapshot" in names
            assert "persist.restore" in names
            assert tracer.open_spans() == []

            reg = metrics_mod.default_registry()
            assert reg.gauge(
                "doorman_persist_snapshot_bytes", labels=("server",)
            ).value("s0") > 0
            assert reg.histogram(
                "doorman_persist_restore_seconds"
            ).count() >= 1
            assert reg.counter(
                "doorman_persist_restores_total",
                labels=("server", "mode"),
            ).value("s1", "warm") >= 1
            await s0.stop()
            await s1.stop()
        finally:
            tracer.disable()
            tracer.clear()

    asyncio.run(run())


# ---------------------------------------------------------------------------
# Etcd backend over the real HTTP dialect (fake etcd)
# ---------------------------------------------------------------------------


def test_etcd_backend_chunked_round_trip():
    from doorman_tpu_torch.persist.backend import EtcdBackend
    from doorman_tpu_torch.server.etcd import EtcdGateway
    from tests.fake_etcd import FakeEtcd

    fake = FakeEtcd()
    fake.start()
    try:
        gw = EtcdGateway([fake.address])
        b = EtcdBackend(gw, "/doorman/persist", chunk_bytes=8)
        assert b.read_snapshot() is None
        data = b"0123456789abcdefXYZ"  # 3 chunks at 8 bytes
        b.write_snapshot(data)
        assert b.read_snapshot() == data
        b.write_snapshot(b"gen2")  # supersede + prune gen 1
        assert b.read_snapshot() == b"gen2"
        assert gw.get_prefix("/doorman/persist/snap/00000001/") == []

        b.append_journal([b"r1", b"r2"])
        b.append_journal([b"r3"])
        assert b.read_journal() == [b"r1", b"r2", b"r3"]
        # A fresh backend instance recovers the append cursor.
        b2 = EtcdBackend(gw, "/doorman/persist", chunk_bytes=8)
        b2.append_journal([b"r4"])
        assert b2.read_journal() == [b"r1", b"r2", b"r3", b"r4"]
        b2.reset_journal([b"fresh"])
        assert b2.read_journal() == [b"fresh"]
    finally:
        fake.stop()


def test_etcd_gateway_prefix_helpers():
    from doorman_tpu_torch.server.etcd import prefix_range_end

    assert prefix_range_end("/a/b/") == b"/a/b0"
    assert prefix_range_end(b"\xff") == b"\x00"
    assert prefix_range_end(b"a\xff") == b"b"


# ---------------------------------------------------------------------------
# Cross-package: the reference and the port read each other's state
# ---------------------------------------------------------------------------

XCONFIG = """
resources:
  - identifier_glob: fair*
    capacity: 120
    algorithm: {kind: FAIR_SHARE, lease_length: 60, refresh_interval: 5,
                learning_mode_duration: 0}
  - identifier_glob: prop*
    capacity: 90
    algorithm: {kind: PROPORTIONAL_SHARE, lease_length: 60,
                refresh_interval: 5, learning_mode_duration: 0}
  - identifier_glob: maxmin*
    capacity: 100
    algorithm: {kind: FAIR_SHARE, lease_length: 60, refresh_interval: 5,
                learning_mode_duration: 0,
                parameters: [{name: variant, value: maxmin}]}
  - identifier_glob: static*
    capacity: 15
    algorithm: {kind: STATIC, lease_length: 60, refresh_interval: 5,
                learning_mode_duration: 0}
  - identifier_glob: "*"
    capacity: 1000
    algorithm: {kind: NO_ALGORITHM, lease_length: 60, refresh_interval: 5,
                learning_mode_duration: 0}
"""
# No STATIC resource: its template capacity is each client's grant, and
# restore clamps any resource whose restored grants sum past its
# capacity (both packages alike), so a STATIC row does not restore as
# written.
XRESOURCES = ("fair0", "prop0", "maxmin0", "free0")


class _Package:
    """One package's persistence and server entry points."""

    def __init__(self, name):
        self.name = name
        if name == "ref":
            from doorman_tpu import native
            from doorman_tpu import persist
            from doorman_tpu.algorithms import Request
            from doorman_tpu.persist import backend, snapshot
            from doorman_tpu.server import config
            from doorman_tpu.server.election import TrivialElection as El
            from doorman_tpu.server.server import CapacityServer

            self.kw = {}
        else:
            from doorman_tpu_torch import native
            from doorman_tpu_torch import persist
            from doorman_tpu_torch.algorithms import Request
            from doorman_tpu_torch.persist import backend, snapshot
            from doorman_tpu_torch.server import config
            from doorman_tpu_torch.server.election import (
                TrivialElection as El,
            )
            from doorman_tpu_torch.server.server import CapacityServer

            self.kw = {"device": "cpu"}
        self.native, self.persist, self.Request = native, persist, Request
        self.backend, self.snapshot, self.config = backend, snapshot, config
        self.Election, self.Server = El, CapacityServer

    def server(self, sid, clock, directory=None, *, native=False,
               mode="immediate", backend=None, **kw):
        if backend is None:
            backend = (self.backend.FileBackend(str(directory))
                       if directory is not None
                       else self.backend.MemoryBackend())
        pm = self.persist.PersistManager(
            backend, snapshot_interval=5.0, flush_interval=1.0, clock=clock,
        )
        return self.Server(sid, self.Election(), mode=mode, clock=clock,
                           native_store=native, persist=pm,
                           **{**self.kw, **kw})

    def decide(self, server, rid, client, wants, has=0.0):
        lease, _ = server._decide(rid, self.Request(client, has, wants, 1))
        return lease


def _packages(native):
    pk = {n: _Package(n) for n in ("ref", "port")}
    if native and not all(p.native.native_available() for p in pk.values()):
        pytest.skip("native store engine unavailable")
    return pk


async def _seeded(pkg, server, clock, seed=7):
    """Config, then seeded decides out of learning mode, a release and a
    band sub-lease: every kind of row a snapshot carries."""
    await server.load_config(pkg.config.parse_yaml_config(XCONFIG))
    server.resources = {}
    server.became_master_at = clock.t - 1000.0
    rng = np.random.default_rng(seed)
    for rid in XRESOURCES:
        for c in range(6):
            pkg.decide(server, rid, f"c{c}",
                       wants=float(rng.integers(1, 60)))
    res = server.resources["prop0"]
    res.release("c2")
    server._persist.record_release("prop0", "c2")
    bkey = f"down\x01band\x011"
    res.store.assign(bkey, 60.0, 5.0, 4.0, 8.0, 3, priority=1)
    server._persist.record_assign("prop0", bkey, res.store.get(bkey))
    server._server_bands[("prop0", "down")] = {1}
    return server


def _rows(server):
    return {rid: sorted(res.store.dump_rows())
            for rid, res in server.resources.items()}


@pytest.mark.parametrize("native", [False, True])
def test_snapshot_bytes_equal_across_packages(native):
    """Both packages' servers, same id and clock, the same seeded leases:
    `encode(take_snapshot(...))` is the same bytes, config epoch
    included."""
    pk = _packages(native)

    async def run():
        clock = FakeClock()
        out = {}
        for name, pkg in pk.items():
            s = await _seeded(pkg, pkg.server("s0", clock, native=native),
                              clock)
            snap = pkg.snapshot.take_snapshot(s, s._persist.journal.seq)
            out[name] = (pkg.snapshot.encode(snap), snap, _rows(s))
            await s.stop()
        return out

    out = asyncio.run(run())
    ref, port = out["ref"], out["port"]
    assert port[2] == ref[2]
    assert port[1].config_epoch == ref[1].config_epoch
    assert port[1].seq == ref[1].seq > 0
    assert port[0] == ref[0]


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_snapshot_and_journal_restore_across_packages(tmp_path, writer,
                                                       reader, native):
    """One package snapshots, journals past the snapshot and steps down;
    the other restores the same directory warm with equal rows."""
    pk = _packages(native)

    async def run():
        clock = FakeClock()
        w, r = pk[writer], pk[reader]
        s0 = await _seeded(w, w.server("s0", clock, tmp_path, native=native),
                           clock)
        s0.persist_step()  # flush + snapshot
        # Deltas past the snapshot ride the journal only.
        w.decide(s0, "fair0", "late", wants=11.0)
        w.decide(s0, "prop0", "c0", wants=3.0)
        s0.resources["maxmin0"].release("c1")
        s0._persist.record_release("maxmin0", "c1")
        s0.persist_step()  # flush (no snapshot inside the interval)
        want = _rows(s0)
        bands = dict(s0._server_bands)
        await s0._on_is_master(False)  # the step-down marker

        clock.advance(2.0)
        s1 = r.server("s1", clock, tmp_path, native=native)
        await s1.load_config(r.config.parse_yaml_config(XCONFIG))
        info = s1.last_restore
        assert info["mode"] == "warm" and info["clean_down"] is True
        assert info["records_applied"] >= 3
        assert info["leases_restored"] == sum(len(v) for v in want.values())
        assert _rows(s1) == want
        assert s1._server_bands == bands
        assert all(not res.in_learning_mode
                   for res in s1.resources.values())
        await s0.stop()
        await s1.stop()

    asyncio.run(run())


def test_batch_ticks_from_a_restored_state_match_the_reference(tmp_path):
    """A state written by the reference (a snapshot, journal deltas, a
    clean step-down) restored warm into the reference's batch server and
    the port's (device="cpu", f64, native store); both then tick with
    the same churn: their stores hold equal rows after every tick."""
    pk = _packages(True)

    async def run():
        clock = FakeClock()
        ref = pk["ref"]
        s0 = await _seeded(ref, ref.server("s0", clock, tmp_path / "w"),
                           clock)
        s0.persist_step()
        ref.decide(s0, "fair0", "late", wants=30.0)
        s0.persist_step()
        await s0._on_is_master(False)
        await s0.stop()
        snap = (tmp_path / "w").iterdir()
        files = {p.name: p.read_bytes() for p in snap}
        servers = []
        for name, pkg in pk.items():
            d = tmp_path / name
            d.mkdir()
            for fname, data in files.items():
                (d / fname).write_bytes(data)
            s = pkg.server(f"b-{name}", clock, d, native=True, mode="batch",
                           solver_dtype="f64", tick_interval=1000.0,
                           flightrec_capacity=0)
            await s.load_config(pkg.config.parse_yaml_config(XCONFIG))
            assert s.last_restore["mode"] == "warm"
            servers.append((pkg, s))
        assert _rows(servers[0][1]) == _rows(servers[1][1])
        rng = [np.random.default_rng(3) for _ in servers]
        for tick in range(5):
            clock.advance(1.0)
            for (pkg, s), g in zip(servers, rng):
                for c in range(3):
                    pkg.decide(s, XRESOURCES[tick % 4], f"c{c}",
                               wants=float(g.integers(1, 60)))
                await s.tick_once()
            rows = [_rows(s) for _, s in servers]
            assert rows[0] == rows[1], f"tick {tick}"
        assert all(s._ticks_done >= 4 for _, s in servers)
        for _, s in servers:
            await s.stop()

    asyncio.run(run())
