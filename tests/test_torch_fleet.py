"""The fleet on the port (doorman_tpu_torch/fleet/, cmd/fleet.py and the
server's epoch-aware redirect), held against the JAX package.

The ten non-chaos cases of tests/test_fleet.py, each run on both
packages with the same inputs and compared:

  * routing epochs: the same move diffs, no-op and stranded-override
    rejections;
  * the beat codec: byte-equal wire aggregates, each package decoding
    the other's;
  * BeatCore: the same shares, freezes and re-offers on one schedule;
  * the autoscaler: the same decisions;
  * the live 2 -> 3 reshard: a port FleetController over port batch
    servers and the reference's over reference servers, one fake clock,
    f64, integer demand: equal installed shares, grants, has-sums,
    redirect tables, stale-refresh answers and redirect counts every
    round, on both lease stores;
  * apply_epoch re-homes exactly the moved routes in both;
  * a stale-epoch client chasing the redirect over loopback gRPC;
  * `cmd.fleet --smoke` as a subprocess, its shards batch-mode servers
    on the native store with --device cpu.

The port runs with device="cpu" (the kernels' plain versions). Every wait
on a process or a channel is bounded.
"""

import asyncio
import json
import subprocess
import sys
from pathlib import Path

import pytest

import tests.conftest  # noqa: F401

from doorman_tpu import federation as jfed
from doorman_tpu import fleet as jfleet
from doorman_tpu import native as jnative
from doorman_tpu.algorithms import Request as JRequest
from doorman_tpu.client.client import Client as JClient
from doorman_tpu.federation.reconcile import ShardSummary as JSummary
from doorman_tpu.proto import doorman_pb2 as jpb
from doorman_tpu.server.config import parse_yaml_config as j_parse
from doorman_tpu.server.election import TrivialElection as JElection
from doorman_tpu.server.server import CapacityServer as JServer
from doorman_tpu_torch import federation as tfed
from doorman_tpu_torch import fleet as tfleet
from doorman_tpu_torch import native as tnative
from doorman_tpu_torch.algorithms import Request
from doorman_tpu_torch.client.client import Client
from doorman_tpu_torch.federation.reconcile import ShardSummary
from doorman_tpu_torch.fleet import supervisor as tsup
from doorman_tpu_torch.proto import doorman_pb2 as pb
from doorman_tpu_torch.server.config import parse_yaml_config
from doorman_tpu_torch.server.election import TrivialElection
from doorman_tpu_torch.server.server import CapacityServer

ROOT = Path(__file__).resolve().parent.parent

NATIVE = pytest.param(
    True, id="native-store",
    marks=pytest.mark.skipif(
        not (jnative.native_available() and tnative.native_available()),
        reason="native engine unavailable",
    ),
)
STORES = [pytest.param(False, id="python-store"), NATIVE]
# Each package: (fleet, federation, proto, Request, ShardSummary).
PACKAGES = {
    "ref": (jfleet, jfed, jpb, JRequest, JSummary),
    "port": (tfleet, tfed, pb, Request, ShardSummary),
}


def run(coro):
    return asyncio.run(coro)


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


CONFIG = """
resources:
- identifier_glob: strad
  capacity: 120
  algorithm: {kind: PROPORTIONAL_SHARE, lease_length: 60,
              refresh_interval: 1, learning_mode_duration: 0}
- identifier_glob: "*"
  capacity: 100
  algorithm: {kind: PROPORTIONAL_SHARE, lease_length: 60,
              refresh_interval: 1, learning_mode_duration: 0}
"""


async def _make_batch_server(pkg, name, clock, shard=None, native=False):
    if pkg == "port":
        server = CapacityServer(
            name, TrivialElection(), mode="batch",
            minimum_refresh_interval=0.0, clock=clock, shard=shard,
            flightrec_capacity=0, native_store=native, device="cpu",
        )
        await server.load_config(parse_yaml_config(CONFIG))
    else:
        server = JServer(
            name, JElection(), mode="batch",
            minimum_refresh_interval=0.0, clock=clock, shard=shard,
            flightrec_capacity=0, native_store=native,
        )
        await server.load_config(j_parse(CONFIG))
    await asyncio.sleep(0)
    return server


def _rid_that(pred):
    for i in range(200):
        rid = f"ord-{i}"
        if pred(rid):
            return rid
    raise AssertionError("no resource id matched the predicate")


STAY = _rid_that(
    lambda r: tfed.stable_shard(r, 2) == tfed.stable_shard(r, 3))
MOVE = _rid_that(
    lambda r: tfed.stable_shard(r, 2) != tfed.stable_shard(r, 3))


# ----------------------------------------------------------------------
# Routing epochs
# ----------------------------------------------------------------------


def _epoch_arc(fleet_mod, ids):
    """advance 2 -> 3 -> 2 over tracked ids, the no-op refusal and the
    stranded override: every change record and refusal, as data."""
    er = fleet_mod.EpochRouter(2, straddle=["strad"], resources=ids)
    out = [er.epoch, er.advance(3).as_log()]
    with pytest.raises(ValueError, match="no-op"):
        er.advance(3)
    out.append(er.advance(2).as_log())
    out.append(er.status())
    pinned = fleet_mod.EpochRouter(3, overrides={"pinned": 2})
    with pytest.raises(ValueError) as exc:
        pinned.advance(2)
    out += [str(exc.value), pinned.epoch]
    return out


def test_epoch_router_move_diff_and_noop():
    er = tfleet.EpochRouter(2, straddle=["strad"], resources=[STAY, MOVE])
    assert er.epoch == 0
    change = er.advance(3)
    assert er.epoch == 1 and change.epoch == 1
    assert change.n_from == 2 and change.n_to == 3
    assert change.added == (2,) and change.removed == ()
    moved = {rid: (old, new) for rid, old, new in change.moved}
    assert moved[MOVE] == (tfed.stable_shard(MOVE, 2),
                           tfed.stable_shard(MOVE, 3))
    assert STAY not in moved and "strad" not in moved
    with pytest.raises(ValueError, match="no-op"):
        er.advance(3)
    back = er.advance(2)
    assert back.added == () and back.removed == (2,)
    assert {rid: (new, old) for rid, old, new in back.moved} == moved
    ids = [f"r{i}" for i in range(300)]
    assert _epoch_arc(tfleet, ids) == _epoch_arc(jfleet, ids)


def test_epoch_router_rejects_stranded_override():
    for fleet_mod in (tfleet, jfleet):
        er = fleet_mod.EpochRouter(3, overrides={"pinned": 2})
        with pytest.raises(ValueError):
            er.advance(2)
        assert er.epoch == 0


# ----------------------------------------------------------------------
# The beat codec
# ----------------------------------------------------------------------


def test_shard_server_id_round_trip():
    for fleet_mod in (tfleet, jfleet):
        assert fleet_mod.shard_server_id(3) == "fleet-shard-3"
        assert fleet_mod.parse_shard_server_id("fleet-shard-3") == 3
        assert fleet_mod.parse_shard_server_id("some-intermediate") is None
        assert fleet_mod.parse_shard_server_id("fleet-shard-x") is None


def test_beat_codec_is_byte_equal_and_decodes_across_packages():
    fields = dict(shard=1, wants=58.0, has=41.5, weight=7.0,
                  breakpoints=((4.0, 8.0, 2.0), (10.0, 50.0, 5.0)))
    port_req = tfleet.encode_summary(ShardSummary(**fields), "strad")
    ref_req = jfleet.encode_summary(JSummary(**fields), "strad")
    assert [(b.priority, b.num_clients, b.wants) for b in port_req.wants] \
        == [(0, 2, 8.0), (1, 5, 50.0)]
    assert port_req.SerializeToString() == ref_req.SerializeToString()
    # Each package decodes the other's bytes to the same summary.
    from_ref = tfleet.decode_summary(
        pb.ServerCapacityResourceRequest.FromString(
            ref_req.SerializeToString()), 1)
    from_port = jfleet.decode_summary(
        jpb.ServerCapacityResourceRequest.FromString(
            port_req.SerializeToString()), 1)
    assert from_ref == ShardSummary(**fields)
    assert from_port.__dict__ == from_ref.__dict__


# ----------------------------------------------------------------------
# BeatCore: push-mode freeze -> decay -> re-offer
# ----------------------------------------------------------------------


def _beat_core_arc(pkg):
    fleet_mod, _fed, pbmod, _req, summary_cls = PACKAGES[pkg]
    clock = FakeClock()
    core = fleet_mod.BeatCore(
        lambda rid: (100.0, pbmod.Algorithm.PROPORTIONAL_SHARE, 5.0),
        expected=[0, 1], share_ttl=2.0, stale_after=2.0, clock=clock,
    )

    def report(shard, wants, has):
        return core.offer(shard, "strad", summary_cls(
            shard=shard, wants=wants, has=has, weight=1.0,
            breakpoints=((wants, wants, 1.0),),
        ))

    trace = []
    has = {0: 0.0, 1: 0.0}
    for _ in range(4):
        for shard in (0, 1):
            share, expiry = report(shard, 80.0, has[shard])
            assert expiry == clock() + 2.0
            has[shard] = min(80.0, share)
            trace.append((shard, share))
        clock.advance(1.0)
    assert has[0] == has[1] == pytest.approx(50.0)
    frozen = has[1]
    reoffered_at = None
    for step in range(12):
        clock.advance(1.0)
        share, _ = report(0, 80.0, has[0])
        trace.append((0, share, dict(core.has_sums())))
        assert share + frozen <= 100.0 + 1e-9 or share > 60.0
        if share > 60.0 and reoffered_at is None:
            reoffered_at = step
        has[0] = min(80.0, share)
        if reoffered_at is None:
            assert core.has_sums()["strad"] <= 100.0 + 1e-9
    assert reoffered_at is not None and reoffered_at >= 6
    assert has[0] == pytest.approx(80.0)
    core.set_expected([0])
    trace.append(report(0, 80.0, has[0]))
    return trace, reoffered_at, core.status(), core.straddle_capacities()


def test_beat_core_freezes_silent_shard_then_reoffers():
    assert _beat_core_arc("port") == _beat_core_arc("ref")


# ----------------------------------------------------------------------
# Autoscaler
# ----------------------------------------------------------------------


def _verdict(status, margin=0.0):
    return {"slo": "x", "status": status, "margin": margin}


def _grow_arc(fleet_mod):
    a = fleet_mod.Autoscaler(min_shards=2, max_shards=4, step=1,
                             hysteresis=3, cooldown=6, shrink_margin=0.1)
    out = [a.observe(t, [_verdict("fail")], 2) for t in (0, 1, 2)]
    out += [a.observe(t, [_verdict("fail")], 3) for t in range(3, 9)]
    out += [a.observe(t, [_verdict("fail")], 4) for t in range(14, 20)]
    return out, a.status()


def _shrink_arc(fleet_mod):
    a = fleet_mod.Autoscaler(min_shards=1, max_shards=4, step=1,
                             hysteresis=2, cooldown=0, shrink_margin=0.1)
    seq = [("pass", 0.05), ("pass", 0.05), ("pass", 0.5), ("fail", 0.0),
           ("pass", 0.5), ("pass", 0.5)]
    out = [a.observe(t, [_verdict(s, m)], 3) for t, (s, m) in
           enumerate(seq)]
    out += [a.observe(t, [_verdict("no_data")], 2) for t in (6, 7)]
    return out, a.status()


def test_autoscaler_hysteresis_and_cooldown():
    got, status = _grow_arc(tfleet)
    assert got == [None, None, 3] + [None] * 5 + [4] + [None] * 6
    assert [d["reason"] for d in status["decisions"]] == [
        "grow:fail-streak", "grow:fail-streak"]
    assert (got, status) == _grow_arc(jfleet)


def test_autoscaler_shrink_needs_margin_and_flip_resets_streak():
    got, status = _shrink_arc(tfleet)
    assert got == [None] * 5 + [2, None, None]
    assert status["decisions"][-1]["reason"] == "shrink:margin-streak"
    assert (got, status) == _shrink_arc(jfleet)


# ----------------------------------------------------------------------
# THE acceptance arc: live reshard 2 -> 3 under churn, port vs reference
# ----------------------------------------------------------------------

RESHARD_TICK = 6
TOTAL = 16


def _capacity_request(pbmod, client_id, rid, wants, has):
    req = pbmod.GetCapacityRequest(client_id=client_id)
    rr = req.resource.add()
    rr.resource_id = rid
    rr.wants = wants
    rr.has.capacity = has
    return req


async def _reshard_arc(pkg, native):
    """The reference's acceptance arc on one package; returns every
    round's observable state."""
    fleet_mod, fed_mod, pbmod, req_cls, _s = PACKAGES[pkg]
    clock = FakeClock()
    servers = {
        i: await _make_batch_server(pkg, f"s{i}", clock, shard=i,
                                    native=native)
        for i in range(3)
    }
    fleet = fleet_mod.FleetController(
        servers, straddle=["strad"], active=2,
        addrs={i: f"addr-{i}" for i in range(3)},
        share_ttl=2.0, clock=clock,
    )
    fleet.note_resources([STAY, MOVE])
    grants = {}
    rounds = []

    def decide(shard, rid, client, wants):
        lease, _ = servers[shard]._decide(
            rid, req_cls(client, grants.get((rid, client), 0.0), wants),
        )
        grants[(rid, client)] = lease.has
        return lease.has

    old = fed_mod.stable_shard(MOVE, 2)
    new = fed_mod.stable_shard(MOVE, 3)
    try:
        for tick in range(TOTAL):
            state = {"tick": tick}
            if tick == RESHARD_TICK:
                change = fleet.reshard(3)
                assert fleet.active == 3 and fleet.epoch == 1
                moved = {r for r, _o, _n in change.moved}
                assert MOVE in moved and STAY not in moved
                assert servers[old]._fleet_routing[MOVE] == f"addr-{new}"
                assert MOVE not in servers[new]._fleet_routing
                state["change"] = change.as_log()
            installed = fleet.reconcile_once()
            assert set(installed["strad"]) == set(range(fleet.active))
            state["installed"] = installed
            decide(0, "strad", "c-a", 100.0)
            decide(1, "strad", "c-b", 80.0)
            if tick > RESHARD_TICK:
                decide(2, "strad", "c-new", 50.0)
            healthy = decide(fed_mod.stable_shard(STAY, 2), STAY,
                             "c-stay", 25.0)
            assert healthy == 25.0
            owner = fleet.router.shard_of(MOVE)
            assert decide(owner, MOVE, "c-move", 40.0) == 40.0
            if tick >= RESHARD_TICK:
                # A client still on the old router refreshes the old
                # owner: a mastership redirect to the new owner.
                resp = await servers[old].GetCapacity(
                    _capacity_request(pbmod, "c-stale", MOVE, 40.0, 40.0),
                    None,
                )
                assert resp.mastership.master_address == f"addr-{new}"
                assert len(resp.response) == 0
                state["stale"] = resp.SerializeToString()
            for server in servers.values():
                await server.tick_once()
            clock.advance(1.0)
            total = sum(
                s.resources["strad"].store.sum_has
                for s in servers.values() if "strad" in s.resources
            )
            assert total <= 120.0 + 1e-6, (tick, total)
            state.update(
                grants=dict(grants),
                has_sum=total,
                routing={i: (s._fleet_epoch, dict(s._fleet_routing))
                         for i, s in servers.items()},
                redirects={i: s.fed_stats["fleet_redirects"]
                           for i, s in servers.items()},
                shares={i: dict(s._straddle_shares)
                        for i, s in servers.items()},
                rows={i: {rid: sorted(res.store.dump_rows())
                          for rid, res in sorted(s.resources.items())}
                      for i, s in servers.items()},
            )
            rounds.append(state)
        assert grants[("strad", "c-new")] > 0.0
        assert servers[new].resources[MOVE].store.get("c-move").has == 40.0
        assert servers[old].fed_stats["fleet_redirects"] == (
            TOTAL - RESHARD_TICK)
        return rounds, fleet.status(), fleet.straddle_capacities()
    finally:
        for server in servers.values():
            await server.stop()


@pytest.mark.parametrize("native", STORES)
def test_live_reshard_2_to_3_equals_the_reference(native):
    """Pointwise fed_capacity_sum through the handoff, byte-unchanged
    healthy grants, the moved client's continuity and the old owner's
    redirect table, in both packages; and every round equal across them:
    installed shares, grants, Σ has, routing tables, stale-refresh
    answers, redirect counts and every store row."""
    port = run(_reshard_arc("port", native))
    ref = run(_reshard_arc("ref", native))
    assert len(port[0]) == len(ref[0]) == TOTAL
    for got, want in zip(port[0], ref[0]):
        assert got == want, got["tick"]
    assert port[1:] == ref[1:]


# ----------------------------------------------------------------------
# Discovery under a shard-count change
# ----------------------------------------------------------------------


async def _apply_epoch_arc(pkg):
    import random

    fleet_mod, fed_mod, *_ = PACKAGES[pkg]
    clock = FakeClock()
    resolved = []

    async def resolver(shard, seeds):
        resolved.append(shard)
        return f"addr-{shard}"

    disc = fed_mod.ShardDiscovery(
        {i: f"seed-{i}" for i in range(3)}, ttl=1e6, jitter=0.0,
        clock=clock, rng=random.Random(7), resolver=resolver,
    )
    er = fleet_mod.EpochRouter(2, straddle=["strad"], resources=[STAY, MOVE])
    fed = fed_mod.FederatedClient(
        er.router, disc, client_id="fed-c", background=False,
        clock=clock, minimum_refresh_interval=0.0,
    )
    try:
        res_stay = await fed.resource(STAY, 10.0)
        res_move = await fed.resource(MOVE, 20.0)
        res_strad = await fed.resource(
            "strad", 5.0, shard=fed_mod.stable_shard(MOVE, 2))
        clients_before = dict(fed._clients)
        base = len(resolved)
        change = er.advance(3)
        out = await fed.apply_epoch(
            er.router, [r for r, _o, _n in change.moved])
        assert out["rehomed"] == [MOVE]
        new_owner = fed_mod.stable_shard(MOVE, 3)
        assert fed._clients[new_owner].resources[MOVE] is res_move
        for shard, client in clients_before.items():
            assert fed._clients[shard] is client
        assert res_stay._client is clients_before[
            fed_mod.stable_shard(STAY, 2)]
        assert res_strad._client.resources["strad"] is res_strad
        assert len(resolved) - base <= 1
        out2 = await fed.apply_epoch(er.router, [MOVE])
        assert out2["rehomed"] == []
        return out, out2, resolved, sorted(fed._clients)
    finally:
        await fed.close()


def test_apply_epoch_rehomes_exactly_the_moved_routes(monkeypatch):
    # The shard addresses are never dialed: bound the close's release
    # RPC (10 s a shard client by default) to keep the case short.
    monkeypatch.setattr(Client, "RELEASE_TIMEOUT", 0.5)
    monkeypatch.setattr(JClient, "RELEASE_TIMEOUT", 0.5)
    assert run(_apply_epoch_arc("port")) == run(_apply_epoch_arc("ref"))


async def _stale_refresh_arc(pkg):
    if pkg == "port":
        mk = lambda name: CapacityServer(  # noqa: E731
            name, TrivialElection(), mode="immediate",
            minimum_refresh_interval=0.0, device="cpu")
        cfg, client_cls = parse_yaml_config(CONFIG), Client
    else:
        mk = lambda name: JServer(  # noqa: E731
            name, JElection(), mode="immediate",
            minimum_refresh_interval=0.0)
        cfg, client_cls = j_parse(CONFIG), JClient
    old, new = mk("old-owner"), mk("new-owner")
    old_port = await old.start(0, host="127.0.0.1")
    new_port = await new.start(0, host="127.0.0.1")
    for server, port in ((old, old_port), (new, new_port)):
        await server.load_config(cfg)
        await asyncio.sleep(0)
        server.current_master = f"127.0.0.1:{port}"
    client = client_cls(f"127.0.0.1:{old_port}", "stale-client",
                        minimum_refresh_interval=0.0)
    client.conn.max_retries = 3
    try:
        res = await client.resource("moved-rid", wants=25.0)
        assert await asyncio.wait_for(client.refresh_once(), 10)
        assert res.current_capacity() == 25.0
        assert "moved-rid" in old.resources
        old.set_fleet_routing(1, {"moved-rid": f"127.0.0.1:{new_port}"})
        old.set_fleet_routing(0, {})  # out of order: ignored
        assert old._fleet_routing == {
            "moved-rid": f"127.0.0.1:{new_port}"}
        ok = await asyncio.wait_for(client.refresh_once(), 10)
        if not ok:
            assert await asyncio.wait_for(client.refresh_once(), 10)
        assert old.fed_stats["fleet_redirects"] >= 1
        assert res.current_capacity() == 25.0
        assert new.resources["moved-rid"].store.get(
            "stale-client").has == 25.0
        return (old.fed_stats["fleet_redirects"], old._fleet_epoch,
                res.current_capacity(), client.conn.current_master
                == f"127.0.0.1:{new_port}")
    finally:
        await client.close()
        await old.stop()
        await new.stop()


def test_stale_epoch_refresh_chases_redirect_to_new_owner():
    """Loopback gRPC: a client with the OLD router refreshing the old
    owner gets the fleet's mastership redirect and chases to the new
    owner, which carries the reported grant across; the same counts and
    answers in both packages."""
    port = run(_stale_refresh_arc("port"))
    assert port[3], "the port client did not chase to the new owner"
    assert port == run(_stale_refresh_arc("ref"))


# ----------------------------------------------------------------------
# The supervisor and the fleet head binary
# ----------------------------------------------------------------------


def test_supervisor_spawns_the_port_server_on_the_asked_device(
    monkeypatch, tmp_path
):
    """The port's supervisor starts `doorman_tpu_torch.cmd.server` with
    --device cuda unless asked otherwise, and carries the mode and the
    store; it sets no JAX platform."""
    seen = []

    class FakePopen:
        def __init__(self, argv, **kw):
            seen.append((argv, kw["env"]))
            self.pid = 1
            self.returncode = None

        def poll(self):
            return self.returncode

    monkeypatch.setattr(tsup.subprocess, "Popen", FakePopen)
    sup = tsup.FleetSupervisor(str(tmp_path / "cfg.yml"))
    sup.spawn(0, 2)
    sup_cpu = tsup.FleetSupervisor(
        str(tmp_path / "cfg.yml"), mode="batch", native_store=True,
        device="cpu", beat_addr="127.0.0.1:1", straddle=["r0"])
    sup_cpu.spawn(1, 2)
    (argv0, env0), (argv1, _env1) = seen
    assert argv0[1:3] == ["-m", "doorman_tpu_torch.cmd.server"]
    assert argv0[argv0.index("--device") + 1] == "cuda"
    assert argv0[argv0.index("--mode") + 1] == "immediate"
    assert "--native-store" not in argv0
    assert not any("jax" in a for a in argv0)
    assert str(ROOT) in env0["PYTHONPATH"].split(":")
    assert argv1[argv1.index("--device") + 1] == "cpu"
    assert argv1[argv1.index("--mode") + 1] == "batch"
    assert "--native-store" in argv1
    assert argv1[argv1.index("--shard") + 1] == "1/2"
    assert argv1[argv1.index("--fleet-straddle") + 1] == "r0"
    # The parser of the binary accepts every flag the supervisor passes.
    from doorman_tpu_torch.cmd import server as t_cmd

    t_cmd.make_parser().parse_args(argv1[3:])


@pytest.mark.skipif(not tnative.native_available(),
                    reason="native engine unavailable")
def test_fleet_smoke_runs_real_shard_processes_on_the_cpu(tmp_path):
    """`cmd.fleet --smoke` with three real batch-mode, native-store port
    shards (--device cpu): the verdict is ok, Σ has within capacity on
    every beat round through the live 2 -> 3 reshard, every shard served
    on the asked device and ticked."""
    out = tmp_path / "verdict.json"
    proc = subprocess.run(
        [sys.executable, "-m", "doorman_tpu_torch.cmd.fleet", "--smoke",
         "--mode", "batch", "--native-store", "--device", "cpu",
         "--rounds", "6", "--timeout", "90", "--out", str(out),
         "--log-dir", str(tmp_path / "logs")],
        cwd=ROOT, capture_output=True, text=True, timeout=150,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    verdict = json.loads(out.read_text())
    assert verdict["ok"] and verdict["reshard_to"] == 3
    assert len(verdict["rounds"]) == 12
    assert all(r["has_sum"] <= 120.0 + 1e-6 for r in verdict["rounds"])
    assert {r["phase"] for r in verdict["rounds"]} == {"pre", "handoff"}
    logs = verdict["shard_logs"]
    assert sorted(logs) == ["0", "1", "2"]
    for shard in logs.values():
        assert shard["device"] == "cpu" and shard["ticks"] > 0, logs
        assert shard["rc"] == 0, logs
