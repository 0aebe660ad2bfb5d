"""Election tests of the port: the TTL-lock state machine (reference
election.go:89-172) driven over the in-memory KV with fault injection,
and server failover behavior (state wipe + learning mode on
re-election) — the port's counterpart of every case in
tests/test_election.py, run against doorman_tpu_torch/server/election.py.

Beside them, cross-package cases: the mastership edge writes the same
`election.transition` trace instants and the same
`doorman_server_mastership_transitions` series in both packages, and
`shard_lock_key` names the same keys.
"""

import asyncio

import pytest

import tests.conftest  # noqa: F401

from doorman_tpu_torch.server.election import (
    InMemoryKV,
    KVElection,
    TrivialElection,
)


def run(coro):
    return asyncio.run(coro)


class Recorder:
    def __init__(self):
        self.is_master_events = []
        self.current_events = []
        self.master_changed = asyncio.Event()
        self.current_changed = asyncio.Event()

    async def on_is_master(self, is_master):
        self.is_master_events.append(is_master)
        self.master_changed.set()

    async def on_current(self, current):
        self.current_events.append(current)
        self.current_changed.set()

    async def wait_master_change(self, timeout=5):
        await asyncio.wait_for(self.master_changed.wait(), timeout)
        self.master_changed.clear()


def test_trivial_election_wins_immediately():
    async def body():
        rec = Recorder()
        await TrivialElection().run("me", rec.on_is_master, rec.on_current)
        assert rec.is_master_events == [True]
        assert rec.current_events == ["me"]

    run(body())


def test_kv_election_single_candidate_wins():
    async def body():
        kv = InMemoryKV()
        election = KVElection(kv, "/lock", ttl=0.3)
        rec = Recorder()
        await election.run("a", rec.on_is_master, rec.on_current)
        await rec.wait_master_change()
        assert rec.is_master_events == [True]
        assert await kv.get("/lock") == "a"
        await election.stop()

    run(body())


def test_kv_election_second_candidate_loses():
    async def body():
        kv = InMemoryKV()
        e1 = KVElection(kv, "/lock", ttl=0.5)
        e2 = KVElection(kv, "/lock", ttl=0.5)
        r1, r2 = Recorder(), Recorder()
        await e1.run("a", r1.on_is_master, r1.on_current)
        await r1.wait_master_change()
        await e2.run("b", r2.on_is_master, r2.on_current)
        await asyncio.sleep(0.3)
        assert r2.is_master_events == []  # b never wins while a renews
        assert await kv.get("/lock") == "a"
        await e1.stop()
        await e2.stop()

    run(body())


def test_kv_election_failover_on_expiry():
    async def body():
        kv = InMemoryKV()
        e1 = KVElection(kv, "/lock", ttl=0.3)
        r1 = Recorder()
        await e1.run("a", r1.on_is_master, r1.on_current)
        await r1.wait_master_change()
        assert r1.is_master_events == [True]

        # Fault injection: the lock vanishes (as if etcd expired it) and a
        # rival takes it; a's next renewal fails => mastership lost.
        kv.expire("/lock")
        assert await kv.acquire("/lock", "b", 10.0)
        await r1.wait_master_change()
        assert r1.is_master_events == [True, False]
        await e1.stop()

    run(body())


def test_server_failover_wipes_state_and_relearns():
    async def body():
        from doorman_tpu_torch.server.config import parse_yaml_config
        from doorman_tpu_torch.server.server import CapacityServer

        server = CapacityServer("s1", TrivialElection(), device="cpu")
        await server.load_config(
            parse_yaml_config(
                """
resources:
- identifier_glob: "*"
  capacity: 100
  algorithm: {kind: PROPORTIONAL_SHARE, lease_length: 60, refresh_interval: 1}
"""
            )
        )
        await server._on_is_master(True)
        res = server.get_or_create_resource("r")
        res.store.assign("c1", 60, 1, 10.0, 10.0, 1)
        assert server.resources

        # Losing mastership wipes all lease state (server.go:438-455).
        await server._on_is_master(False)
        assert server.resources == {}
        assert not server.is_master

        # Winning again restarts learning mode from the new
        # became_master_at.
        await server._on_is_master(True)
        res = server.get_or_create_resource("r")
        assert res.in_learning_mode

    run(body())


# ---------------------------------------------------------------------------
# Cross-package: the mastership edge's observability
# ---------------------------------------------------------------------------

FLIP_CONFIG = """
resources:
- identifier_glob: "*"
  capacity: 100
  algorithm: {kind: PROPORTIONAL_SHARE, lease_length: 60, refresh_interval: 1}
"""


class FakeClock:
    def __init__(self, t=5000.0):
        self.t = t

    def __call__(self):
        return self.t


def _transitions(registry, server_id):
    counter = registry.counter(
        "doorman_server_mastership_transitions",
        "Mastership transitions observed, by the state entered.",
        labels=("server", "to"),
    )
    return {to: counter.value(server_id, to) for to in ("master", "standby")}


def _instants(tracer):
    return [
        (s.name, s.cat, s.ph, dict(s.args))
        for s in tracer.snapshot()
        if s.name == "election.transition"
    ]


@pytest.mark.parametrize("native", [False, True])
def test_mastership_transitions_match_the_reference(native):
    """Both packages' servers on one fake clock, each flipped master ->
    standby -> master: the same counter series in each default registry
    and the same trace instants in each default tracer."""
    from doorman_tpu.obs import metrics as j_metrics
    from doorman_tpu.obs import trace as j_trace
    from doorman_tpu.server.config import parse_yaml_config as j_parse
    from doorman_tpu.server.election import TrivialElection as JElection
    from doorman_tpu.server.server import CapacityServer as JServer
    from doorman_tpu_torch import native as t_native
    from doorman_tpu_torch.obs import metrics as t_metrics
    from doorman_tpu_torch.obs import trace as t_trace
    from doorman_tpu_torch.server.config import parse_yaml_config as t_parse
    from doorman_tpu_torch.server.server import CapacityServer as TServer

    if native and not t_native.native_available():
        pytest.skip("native engine unavailable")
    sid = f"flip-{'native' if native else 'python'}"
    clock = FakeClock()
    tracers = (j_trace.default_tracer(), t_trace.default_tracer())
    regs = (j_metrics.default_registry(), t_metrics.default_registry())
    before = [_transitions(r, sid) for r in regs]

    async def body():
        ref = JServer(sid, JElection(), clock=clock, native_store=native)
        port = TServer(sid, TrivialElection(), clock=clock,
                       native_store=native, device="cpu")
        await ref.load_config(j_parse(FLIP_CONFIG))  # -> master
        await port.load_config(t_parse(FLIP_CONFIG))
        for is_master in (False, True):
            clock.t += 1.0
            await ref._on_is_master(is_master)
            await port._on_is_master(is_master)
        assert ref.mastership_epoch == port.mastership_epoch == 3
        assert ref.is_master and port.is_master
        await ref.stop()
        await port.stop()

    for tr in tracers:
        tr.enable(capacity=4096)
        tr.clear()
    try:
        asyncio.run(body())
        ref_i, port_i = (_instants(tr) for tr in tracers)
    finally:
        for tr in tracers:
            tr.disable()
            tr.clear()
    want = [("election.transition", "election", "i",
             {"server": sid, "is_master": m}) for m in (True, False, True)]
    assert ref_i == want
    assert port_i == ref_i
    after = [_transitions(r, sid) for r in regs]
    moved = [{k: a[k] - b[k] for k in a} for a, b in zip(after, before)]
    assert moved[0] == {"master": 2.0, "standby": 1.0}
    assert moved[1] == moved[0]


@pytest.mark.parametrize("shard", [-1, 0, 3])
def test_shard_lock_key_matches_the_reference(shard):
    from doorman_tpu.server.election import shard_lock_key as j_key
    from doorman_tpu_torch.server.election import shard_lock_key as t_key

    for lock in ("/doorman/master", "/doorman/master/"):
        assert t_key(lock, shard) == j_key(lock, shard)
