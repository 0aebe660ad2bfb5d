"""The port's obs package against the reference's on the same inputs.

* the same registry operations give byte-equal Prometheus text;
* the same span sequence gives the same Chrome-trace events, apart from
  timestamps and ids;
* a batch server on the native store (the reference's and the port's on
  device="cpu", same config, fake clock and requests) gives flight
  records with equal keys and equal digest, resources, tick, epoch and
  solve_mode, and a status() that carries every key of the reference's;
* the shadow audit at f64 flags exactly the injected resource at the
  same tick in both packages, and at f32 both auditors flag the same set
  of resources (the f64 oracle against f32 grants: this records the
  shared behaviour, it does not bless it);
* SLO verdicts and history tier queries are equal on the same records.
"""

import asyncio
import json

import numpy as np
import pytest

import tests.conftest  # noqa: F401

from doorman_tpu import native as jnative
from doorman_tpu.obs import history as j_history
from doorman_tpu.obs import metrics as j_metrics
from doorman_tpu.obs import phases as j_phases
from doorman_tpu.obs import slo as j_slo
from doorman_tpu.obs import trace as j_trace
from doorman_tpu.proto import doorman_pb2 as jpb
from doorman_tpu.server.config import parse_yaml_config as j_parse
from doorman_tpu.server.election import TrivialElection as JElection
from doorman_tpu.server.server import CapacityServer as JServer
from doorman_tpu_torch import native as tnative
from doorman_tpu_torch.obs import history as t_history
from doorman_tpu_torch.obs import metrics as t_metrics
from doorman_tpu_torch.obs import phases as t_phases
from doorman_tpu_torch.obs import slo as t_slo
from doorman_tpu_torch.obs import trace as t_trace
from doorman_tpu_torch.proto import doorman_pb2 as tpb
from doorman_tpu_torch.server.config import parse_yaml_config as t_parse
from doorman_tpu_torch.server.election import TrivialElection as TElection
from doorman_tpu_torch.server.server import CapacityServer as TServer

needs_native = pytest.mark.skipif(
    not (jnative.native_available() and tnative.native_available()),
    reason="native engine unavailable",
)

# The eight scalar lanes, overloaded so grants bind.
CONFIG = """
resources:
- identifier_glob: r-none
  capacity: 100
  algorithm: {kind: NO_ALGORITHM, lease_length: 60, refresh_interval: 1,
              learning_mode_duration: 0}
- identifier_glob: r-static
  capacity: 100
  algorithm: {kind: STATIC, lease_length: 60, refresh_interval: 1,
              learning_mode_duration: 0,
              parameters: [{name: static_capacity, value: "12.5"}]}
- identifier_glob: r-prop
  capacity: 100
  algorithm: {kind: PROPORTIONAL_SHARE, lease_length: 60,
              refresh_interval: 1, learning_mode_duration: 0}
- identifier_glob: r-topup
  capacity: 100
  algorithm: {kind: PROPORTIONAL_SHARE, lease_length: 60,
              refresh_interval: 1, learning_mode_duration: 0,
              parameters: [{name: variant, value: topup}]}
- identifier_glob: r-fair
  capacity: 100
  algorithm: {kind: FAIR_SHARE, lease_length: 60, refresh_interval: 1,
              learning_mode_duration: 0}
- identifier_glob: r-maxmin
  capacity: 100
  algorithm: {kind: FAIR_SHARE, lease_length: 60, refresh_interval: 1,
              learning_mode_duration: 0,
              parameters: [{name: variant, value: maxmin}]}
- identifier_glob: r-balanced
  capacity: 100
  algorithm: {kind: FAIR_SHARE, lease_length: 60, refresh_interval: 1,
              learning_mode_duration: 0,
              parameters: [{name: variant, value: balanced}]}
- identifier_glob: "*"
  capacity: 100
  algorithm: {kind: PROPORTIONAL_SHARE, lease_length: 60,
              refresh_interval: 1, learning_mode_duration: 0}
"""
RIDS = ("r-none", "r-static", "r-prop", "r-topup", "r-fair", "r-maxmin",
        "r-balanced", "r-other")
CLIENTS = tuple(f"c{i}" for i in range(5))


# ----------------------------------------------------------------------
# Metrics and trace export
# ----------------------------------------------------------------------


def _registry_ops(mod):
    reg = mod.Registry()
    c = reg.counter("doorman_requests", "Requests.", labels=("method",))
    g = reg.gauge("doorman_level", "A level.")
    h = reg.histogram("doorman_seconds", "Durations.", labels=("phase",),
                      buckets=(0.001, 0.01, 0.1, 1.0))
    rng = np.random.default_rng(7)
    for i in range(200):
        c.inc(("GetCapacity", "Release", 'quo"te\n')[i % 3])
        h.observe(float(rng.exponential(0.05)), ("solve", "apply")[i % 2])
        g.set(float(rng.random()))
    reg.counter("doorman_plain", "No labels.").inc(by=3)
    return reg.expose()


def test_same_registry_operations_give_byte_equal_prometheus_text():
    assert _registry_ops(j_metrics) == _registry_ops(t_metrics)


def _span_events(mod):
    tr = mod.Tracer(capacity=64).enable()
    with tr.span("server.tick", cat="tick", args={"server": "s"}):
        tr.instant("audit.divergence", cat="audit", args={"resource": "r"})
        with tr.span("fused", cat="phase:resident"):
            pass
        tr.add_complete("apply", ts_us=1.0, dur_us=2.0,
                        cat="phase:resident")
    with pytest.raises(ValueError):
        with tr.span("server.GetCapacity", cat="server"):
            raise ValueError("x")
    doc = tr.chrome_trace()
    json.loads(tr.chrome_json())
    out = []
    for ev in doc["traceEvents"]:
        ev = {k: v for k, v in ev.items() if k not in ("ts", "dur")}
        if "args" in ev:
            ev["args"] = {
                k: v for k, v in ev["args"].items()
                if k not in ("span_id", "trace_id", "parent_id")
            }
        out.append(ev)
    return sorted(out, key=lambda e: json.dumps(e, sort_keys=True))


def test_same_span_sequence_gives_equal_chrome_events():
    ref, port = _span_events(j_trace), _span_events(t_trace)
    assert ref == port
    assert {e["name"] for e in port} >= {
        "server.tick", "fused", "apply", "audit.divergence",
        "server.GetCapacity",
    }
    assert t_trace.KNOWN_SPAN_NAMES == j_trace.KNOWN_SPAN_NAMES
    assert t_trace.KNOWN_INSTANT_NAMES == j_trace.KNOWN_INSTANT_NAMES


# ----------------------------------------------------------------------
# Servers side by side
# ----------------------------------------------------------------------


def _request(pb, client, wants, has):
    req = pb.GetCapacityRequest(client_id=client)
    for rid in RIDS:
        r = req.resource.add()
        r.resource_id, r.priority = rid, 1
        r.wants = wants[rid]
        if (client, rid) in has:
            r.has.capacity = has[(client, rid)]
    return req


@pytest.fixture(autouse=True)
def _no_leftover_shard_bytes():
    """Both packages' process-wide per-shard byte snapshots start empty:
    a JAX mesh placement earlier in the same process (the mesh tests, the
    reference's mesh-resident solvers) leaves `shard_bytes` behind, and
    the reference's flight record copies it into every tick record while
    the port's stays empty."""
    j_phases._last_shard_bytes.clear()
    t_phases._last_shard_bytes.clear()
    yield


async def _pair(dtype="f64", **kw):
    """The reference's and the port's batch servers on the native store,
    one fake clock, started and configured (both master)."""
    t = [5000.0]
    clock = lambda: t[0]  # noqa: E731
    ref = JServer("srv", JElection(), mode="batch", native_store=True,
                  solver_dtype=dtype, clock=clock, tick_interval=1000.0,
                  minimum_refresh_interval=0.0, **kw)
    port = TServer("srv", TElection(), mode="batch", native_store=True,
                   solver_dtype=dtype, clock=clock, tick_interval=1000.0,
                   minimum_refresh_interval=0.0, device="cpu", **kw)
    for s in (ref, port):
        await s.start(0, host="127.0.0.1")
    await ref.load_config(j_parse(CONFIG))
    await port.load_config(t_parse(CONFIG))
    await asyncio.sleep(0)
    assert ref.is_master and port.is_master
    return ref, port, t


async def _drive(ref, port, t, ticks, quiet=0, seed=3):
    """The same requests into both servers, a tick of each after every
    round; each client's has is what its own server answered. Then
    `quiet` ticks with no request, so the stores reach their fixpoint."""
    rng = np.random.default_rng(seed)
    has = ({}, {})
    for step in range(ticks + quiet):
        for client in CLIENTS if step < ticks else ():
            if step and rng.random() < 0.5:
                continue  # a quiet client this round
            wants = {rid: float(rng.integers(1, 60)) for rid in RIDS}
            for i, (s, pb) in enumerate(((ref, jpb), (port, tpb))):
                out = await s.GetCapacity(
                    _request(pb, client, wants, has[i]), None
                )
                for r in out.response:
                    has[i][(client, r.resource_id)] = r.gets.capacity
        for s in (ref, port):
            await s.tick_once()
        t[0] += 1.0


@needs_native
def test_flight_records_and_status_keys_equal_the_reference():
    async def body():
        ref, port, t = await _pair()
        try:
            await _drive(ref, port, t, ticks=8)
            recs = ref.flightrec.snapshot(), port.flightrec.snapshot()
            assert len(recs[0]) == len(recs[1]) == 8
            for a, b in zip(*recs):
                assert set(a) == set(b), (sorted(a), sorted(b))
                for key in ("digest", "resources", "tick", "epoch",
                            "solve_mode", "seq"):
                    assert a.get(key) == b.get(key), key
            assert set(ref.status()) <= set(port.status())
            st = port.status()
            assert st["backend"] == "cpu"
            assert st["flightrec"]["head_seq"] == 8
            for key in ("persist", "admission", "frontend", "federation",
                        "mesh", "last_restore", "slo"):
                assert st[key] is None, key
            assert set(st["solve_scope"]) == {"narrow", "wide"}
            assert sorted(st["resources"]) == sorted(RIDS)
            assert st["tick_phase_total_ms"]["fused"] > 0.0
            assert port.resource_lease_status("r-fair") is not None
            assert port.resource_lease_status("nope") is None
        finally:
            await ref.stop()
            await port.stop()

    asyncio.run(body())


async def _audited_pair(dtype, ticks, quiet):
    ref, port, t = await _pair(dtype, audit_sample=2, audit_inline=True)
    await _drive(ref, port, t, ticks, quiet)
    return ref, port


def _flagged(server):
    return [(d["rid"], d["tick"], d["clients"], d["has"], d["expected"])
            for d in server.shadow_audit.details]


@needs_native
def test_audit_at_f64_flags_the_injected_resource_in_both():
    async def body():
        ref, port = await _audited_pair("f64", ticks=6, quiet=8)
        try:
            for s in (ref, port):
                assert s.shadow_audit.samples >= 4
                assert s.shadow_audit.divergences == 0
            # One delivered grant off by 1% on a converged row, then two
            # aligned samples: confirmed at the second.
            for s in (ref, port):
                store = s.resources["r-fair"].store
                store.regrant("c0", store.get("c0").has * 1.01)
                aud = s.shadow_audit
                aud.maybe_sample(100, None, s.resources)
                aud.maybe_sample(102, None, s.resources)
            assert _flagged(ref) == _flagged(port)
            (flag,) = _flagged(port)
            assert flag[0] == "r-fair" and flag[1] == 102
            assert flag[2] == ["c0"]
            rec = port.flightrec.snapshot()[-1]
            assert rec["error"].startswith("audit.divergence: r-fair")
            assert port.flightrec.last_dump["reason"] == "audit_divergence"
        finally:
            await ref.stop()
            await port.stop()

    asyncio.run(body())


@needs_native
def test_audit_at_f32_flags_the_same_resources_in_both():
    async def body():
        ref, port = await _audited_pair("f32", ticks=6, quiet=8)
        try:
            flagged = [sorted({f[0] for f in _flagged(s)})
                       for s in (ref, port)]
            assert flagged[0] == flagged[1]
            assert (ref.shadow_audit.divergences
                    == port.shadow_audit.divergences == len(flagged[1]))
        finally:
            await ref.stop()
            await port.stop()

    asyncio.run(body())


# ----------------------------------------------------------------------
# History and SLOs on the same records
# ----------------------------------------------------------------------


def _records(n=300, seed=5):
    rng = np.random.default_rng(seed)
    return [
        {"t": 1000.0 + i, "tick": i, "wall_ms": float(rng.gamma(2.0, 4.0)),
         "dispatches": int(rng.integers(2, 5)),
         "solve_mode": ("scoped", "full")[int(rng.random() < 0.1)]}
        for i in range(n)
    ]


def _history_queries(mod, d):
    clock = iter(range(10_000)).__next__
    hs = mod.HistoryStore(str(d), ring=512, component="srv",
                          clock=lambda: float(clock()))
    for rec in _records(150):
        hs.append(dict(rec))
    hs.close()
    hs = mod.HistoryStore(str(d), ring=512, component="srv",
                          clock=lambda: float(clock()))
    for rec in _records(150, seed=6):
        hs.append(dict(rec))
    out = {
        "raw": hs.records(start=200, end=260, fields=["wall_ms"]),
        "tiers": {f: hs.records(tier=f) for f in sorted(hs._tiers)},
        "series": hs.series("wall_ms"),
        "delta": hs.run_delta("wall_ms", q=0.9),
        "status": {k: v for k, v in hs.status().items() if k != "dir"},
    }
    hs.close()
    return out


def test_history_tier_queries_equal_the_reference(tmp_path):
    ref = _history_queries(j_history, tmp_path / "ref")
    port = _history_queries(t_history, tmp_path / "port")
    assert ref == port
    assert port["tiers"] and port["delta"]["run"] == 2


def _slo_verdicts(mod, metrics_mod):
    reg = metrics_mod.Registry()
    h = reg.histogram("doorman_server_requests_durations", "d",
                      labels=("method",))
    rng = np.random.default_rng(9)
    for _ in range(500):
        h.observe(float(rng.exponential(0.02)), "GetCapacity")
    ticks = [r["wall_ms"] for r in _records()]
    specs = mod.server_slos()
    specs += [mod.audit_divergence_spec(), mod.detector_anomaly_spec()]
    inputs = mod.SloInputs(
        registry=reg, samples={"tick_ms": ticks},
        scalars={"audit_divergence": 1.0, "detector_anomalies": 0.0},
        band_tallies={0: {"admitted": 90, "shed": 10, "fast_fail": 0}},
    )
    return mod.SloEngine(specs).evaluate(inputs)


def test_slo_verdicts_equal_the_reference():
    ref = _slo_verdicts(j_slo, j_metrics)
    port = _slo_verdicts(t_slo, t_metrics)
    assert ref == port
    status = {v["slo"]: v["status"] for v in port}
    assert status["audit_divergence"] == "fail"
    assert "no_data" not in {status["tick_budget_p50_ms"],
                             status["get_capacity_p99_ms"]}


@needs_native
def test_audit_flags_the_unwritten_store_at_tick_0_in_both():
    """A tick pipeline deeper than 1 applies nothing on its first ticks,
    so the auditor samples tick 0 more than once over stores no tick has
    written yet, and both packages flag the same resources there (every
    grant 0): the auditor's behaviour, shared, not a grant fault."""
    async def body():
        ref, port, t = await _pair(tick_pipeline_depth=3, audit_sample=2,
                                   audit_inline=True)
        try:
            for s in (ref, port):
                # Leases loaded in bulk with nothing granted yet (as a
                # snapshot load does), then two ticks: neither applies.
                engine = s._store_engine
                res = [s.get_or_create_resource(rid) for rid in RIDS]
                rids = np.repeat([r.store._rid for r in res], len(CLIENTS))
                cids = np.array([engine.client_handle(c) for _ in res
                                 for c in CLIENTS], np.int64)
                n = len(rids)
                engine.bulk_assign(
                    rids.astype(np.int32), cids, np.full(n, t[0] + 60.0),
                    np.full(n, 1.0), np.zeros(n),
                    np.arange(n, dtype=np.float64) % 37 + 1.0,
                    np.ones(n, np.int32),
                )
                for _ in range(2):
                    await s.tick_once()
            flags = [_flagged(s) for s in (ref, port)]
            assert flags[0] == flags[1] and flags[1]
            for rid, tick, _clients, has, _expected in flags[1]:
                assert tick == 0 and not any(has), rid
            assert port._ticks_done == ref._ticks_done == 0
        finally:
            await ref.stop()
            await port.stop()

    asyncio.run(body())
