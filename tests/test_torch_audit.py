"""The port's shadow-oracle audit (doorman_tpu_torch/obs/audit.py), the
cases of tests/test_audit.py against the port: the fixpoint property
across every scalar lane, the two-strike confirmation rule, the
iterative-lane ulp bound, the skip set, and the live server's divergence
blast (counter + flight-recorder dump + failing SLO gate).
"""

import asyncio

import numpy as np
import pytest

import tests.conftest  # noqa: F401

from doorman_tpu_torch.algorithms.kinds import AlgoKind
from doorman_tpu_torch.algorithms.tick import oracle_row
from doorman_tpu_torch.core.resource import Resource
from doorman_tpu_torch.obs.audit import (
    ITERATIVE_LANES,
    ITERATIVE_REL_BOUND,
    ShadowAuditor,
)
from doorman_tpu_torch.proto import doorman_pb2 as pb

# (kind, capacity, static, wants, sub) per scalar lane — overloaded so
# grants actually bind, subclients non-uniform so weighted lanes weight.
LANES = [
    (AlgoKind.NO_ALGORITHM, 100.0, 0.0),
    (AlgoKind.STATIC, 100.0, 12.5),
    (AlgoKind.PROPORTIONAL_SHARE, 100.0, 0.0),
    (AlgoKind.PROPORTIONAL_TOPUP, 100.0, 0.0),
    (AlgoKind.FAIR_SHARE, 100.0, 0.0),
    (AlgoKind.MAX_MIN_FAIR, 100.0, 0.0),
    (AlgoKind.BALANCED_FAIRNESS, 100.0, 0.0),
    (AlgoKind.PROPORTIONAL_FAIRNESS, 100.0, 0.0),
]
WANTS = np.array([20.0, 30.0, 60.0, 45.0], np.float64)
SUB = np.array([1.0, 2.0, 1.0, 3.0], np.float64)


def converged_entry(kind, capacity=100.0, static=0.0, *, iters=500):
    """Iterate the oracle to its fixpoint: the delivered steady state a
    healthy server's store holds between wants changes."""
    has = np.zeros_like(WANTS)
    for _ in range(iters):
        nxt = oracle_row(int(kind), capacity, static, WANTS, has, SUB)
        if np.array_equal(nxt, has):
            break
        has = nxt
    return {
        "rid": f"r-{int(kind)}",
        "tick": 0,
        "kind": int(kind),
        "capacity": float(capacity),
        "static": float(static),
        "clients": [f"c{i}" for i in range(len(WANTS))],
        "has": has.copy(),
        "wants": WANTS.copy(),
        "sub": SUB.copy(),
    }


def mk_auditor(**kw):
    kw.setdefault("inline", True)
    kw.setdefault("clock", lambda: 0.0)
    return ShadowAuditor(sample=kw.pop("sample", 4), **kw)


# ---------------------------------------------------------------------
# sampling predicate
# ---------------------------------------------------------------------


def test_should_sample_period_and_transition():
    aud = mk_auditor(sample=4)
    assert aud.should_sample(0, "scoped")  # tick % 4 == 0
    assert not aud.should_sample(1, "scoped")
    assert aud.should_sample(2, "full")  # solve-mode transition
    assert not aud.should_sample(3, "full")
    assert aud.should_sample(4, "full")


def test_sample_interval_must_be_positive():
    with pytest.raises(ValueError):
        ShadowAuditor(sample=0)


# ---------------------------------------------------------------------
# the fixpoint property, lane by lane
# ---------------------------------------------------------------------


@pytest.mark.parametrize("kind,capacity,static", LANES,
                         ids=lambda v: getattr(v, "name", None))
def test_fixpoint_is_clean_at_convergence(kind, capacity, static):
    """At a converged row the audit comparison is silent — even across
    two samples with identical digests (the two-strike rule never gets
    strike one)."""
    aud = mk_auditor()
    entry = converged_entry(kind, capacity, static)
    aud._compare([entry])
    aud._compare([entry])
    assert aud.divergences == 0 and aud.details == []


def test_two_strike_flags_stable_corruption_once():
    aud = mk_auditor()
    entry = converged_entry(AlgoKind.FAIR_SHARE)
    entry["has"][0] *= 0.75  # a silently-scaled grant, digest-stable
    aud._compare([entry])  # strike one: pending, not flagged
    assert aud.divergences == 0
    aud._compare([entry])  # identical digest -> confirmed
    assert aud.divergences == 1
    aud._compare([entry])  # already flagged: counted once
    aud._compare([entry])
    assert aud.divergences == 1
    (detail,) = aud.details
    assert detail["rid"] == entry["rid"] and detail["rows"] == [0]
    assert detail["has"][0] == pytest.approx(detail["expected"][0] * 0.75)


def test_moving_inputs_never_flag():
    """A converging or delivery-lagged row changes `has` between
    samples, so its digest moves — strike one never becomes two."""
    aud = mk_auditor()
    base = converged_entry(AlgoKind.FAIR_SHARE)
    for i in range(1, 6):
        entry = dict(base)
        entry["has"] = base["has"] * (1.0 - 0.01 * i)  # still wrong...
        aud._compare([entry])  # ...but differently wrong each sample
    assert aud.divergences == 0


def test_clean_sample_resets_the_strike():
    aud = mk_auditor()
    good = converged_entry(AlgoKind.FAIR_SHARE)
    bad = dict(good)
    bad["has"] = good["has"].copy()
    bad["has"][1] *= 0.5
    aud._compare([bad])  # strike one
    aud._compare([good])  # healed: pending cleared
    aud._compare([bad])  # strike one again, not confirmation
    assert aud.divergences == 0
    aud._compare([bad])
    assert aud.divergences == 1


def test_iterative_lane_gets_ulp_slack():
    kind = AlgoKind.MAX_MIN_FAIR
    assert kind in ITERATIVE_LANES
    aud = mk_auditor()
    entry = converged_entry(kind)
    # One-ulp reassociation noise: inside the bound, never flagged.
    entry["has"] = entry["has"] * (1.0 + np.finfo(np.float64).eps)
    aud._compare([entry])
    aud._compare([entry])
    assert aud.divergences == 0
    # A real divergence dwarfs the bound and is still caught.
    entry2 = converged_entry(kind)
    entry2["has"][0] *= 1.0 + 1e6 * ITERATIVE_REL_BOUND
    aud._compare([entry2])
    aud._compare([entry2])
    assert aud.divergences == 1


def test_exact_lanes_flag_single_bit_drift():
    aud = mk_auditor()
    entry = converged_entry(AlgoKind.FAIR_SHARE)
    entry["has"][2] = np.nextafter(entry["has"][2], np.inf)
    aud._compare([entry])
    aud._compare([entry])
    assert aud.divergences == 1


# ---------------------------------------------------------------------
# snapshot: what gets audited
# ---------------------------------------------------------------------


def _template(kind, capacity=100.0, variant=None):
    algo = pb.Algorithm(kind=kind, lease_length=60, refresh_interval=1)
    if variant:
        p = algo.parameters.add()
        p.name = "variant"
        p.value = variant
    return pb.ResourceTemplate(
        identifier_glob="*", capacity=capacity, algorithm=algo
    )


def test_snapshot_skips_learning_empty_and_bandless_lanes():
    clock = lambda: 1000.0  # noqa: E731
    audited = Resource(
        "r-live", _template(pb.Algorithm.FAIR_SHARE), clock=clock
    )
    audited.store.assign("c0", 60, 1, 0.0, 40.0, 1)
    learning = Resource(
        "r-learning", _template(pb.Algorithm.FAIR_SHARE),
        learning_mode_end=2000.0, clock=clock,
    )
    learning.store.assign("c0", 60, 1, 0.0, 40.0, 1)
    empty = Resource(
        "r-empty", _template(pb.Algorithm.FAIR_SHARE), clock=clock
    )
    bands = Resource(
        "r-bands", _template(pb.Algorithm.PRIORITY_BANDS), clock=clock
    )
    bands.store.assign("c0", 60, 1, 0.0, 40.0, 1)
    aud = mk_auditor()
    snap = aud.snapshot(
        {
            "r-live": audited,
            "r-learning": learning,
            "r-empty": empty,
            "r-bands": bands,
        },
        tick=7,
    )
    assert [e["rid"] for e in snap] == ["r-live"]
    assert snap[0]["kind"] == int(AlgoKind.FAIR_SHARE)
    assert snap[0]["tick"] == 7
    assert snap[0]["wants"].tolist() == [40.0]


def test_snapshot_resolves_variant_lanes():
    clock = lambda: 1000.0  # noqa: E731
    res = Resource(
        "r-maxmin",
        _template(pb.Algorithm.FAIR_SHARE, variant="maxmin"),
        clock=clock,
    )
    res.store.assign("c0", 60, 1, 0.0, 40.0, 1)
    aud = mk_auditor()
    (entry,) = aud.snapshot({"r-maxmin": res}, tick=0)
    assert entry["kind"] == int(AlgoKind.MAX_MIN_FAIR)


# ---------------------------------------------------------------------
# executor path
# ---------------------------------------------------------------------


def test_executor_path_matches_inline():
    hits = []
    aud = ShadowAuditor(
        sample=1, inline=False, on_divergence=hits.append,
        clock=lambda: 0.0,
    )
    entry = converged_entry(AlgoKind.FAIR_SHARE)
    entry["has"][0] *= 0.75
    # Feed pre-built entries through _compare via the executor the way
    # maybe_sample does, then drain before asserting.
    aud._executor.submit(aud._compare_safe, [dict(entry, has=entry["has"].copy())])
    aud._executor.submit(aud._compare_safe, [dict(entry, has=entry["has"].copy())])
    aud.drain()
    assert aud.divergences == 1 and len(hits) == 1
    aud.close()
    assert aud.inline  # post-close comparisons run on the caller

    st = aud.status()
    assert st["divergences"] == 1 and len(st["details"]) == 1


def test_on_divergence_hook_failure_is_contained():
    def boom(detail):
        raise RuntimeError("hook crashed")

    aud = mk_auditor(on_divergence=boom)
    entry = converged_entry(AlgoKind.FAIR_SHARE)
    entry["has"][0] *= 0.75
    aud._compare([entry])
    aud._compare([entry])  # hook raises; the audit keeps counting
    assert aud.divergences == 1


# ---------------------------------------------------------------------
# the live server: clean eight-lane run, then the divergence blast
# ---------------------------------------------------------------------

EIGHT_LANE_CONFIG = """
resources:
- identifier_glob: "r-none"
  capacity: 100
  algorithm: {kind: NO_ALGORITHM, lease_length: 60, refresh_interval: 1,
              learning_mode_duration: 0}
- identifier_glob: "r-static"
  capacity: 12.5
  algorithm: {kind: STATIC, lease_length: 60, refresh_interval: 1,
              learning_mode_duration: 0}
- identifier_glob: "r-prop"
  capacity: 100
  algorithm: {kind: PROPORTIONAL_SHARE, lease_length: 60,
              refresh_interval: 1, learning_mode_duration: 0}
- identifier_glob: "r-topup"
  capacity: 100
  algorithm: {kind: PROPORTIONAL_SHARE, lease_length: 60,
              refresh_interval: 1, learning_mode_duration: 0,
              parameters: [{name: variant, value: topup}]}
- identifier_glob: "r-fair"
  capacity: 100
  algorithm: {kind: FAIR_SHARE, lease_length: 60, refresh_interval: 1,
              learning_mode_duration: 0}
- identifier_glob: "r-maxmin"
  capacity: 100
  algorithm: {kind: FAIR_SHARE, lease_length: 60, refresh_interval: 1,
              learning_mode_duration: 0,
              parameters: [{name: variant, value: maxmin}]}
- identifier_glob: "r-balanced"
  capacity: 100
  algorithm: {kind: FAIR_SHARE, lease_length: 60, refresh_interval: 1,
              learning_mode_duration: 0,
              parameters: [{name: variant, value: balanced}]}
- identifier_glob: "r-logutil"
  capacity: 100
  algorithm: {kind: PROPORTIONAL_SHARE, lease_length: 60,
              refresh_interval: 1, learning_mode_duration: 0,
              parameters: [{name: variant, value: logutil}]}
- identifier_glob: "*"
  capacity: 100
  algorithm: {kind: PROPORTIONAL_SHARE, lease_length: 60,
              refresh_interval: 1, learning_mode_duration: 0}
"""

RIDS = ["r-none", "r-static", "r-prop", "r-topup", "r-fair", "r-maxmin",
        "r-balanced", "r-logutil"]


async def _eight_lane_server(ticks):
    from doorman_tpu_torch.client import Client
    from doorman_tpu_torch.server.config import parse_yaml_config
    from doorman_tpu_torch.server.election import TrivialElection
    from doorman_tpu_torch.server.server import CapacityServer

    server = CapacityServer(
        "audit-server", TrivialElection(), mode="batch",
        minimum_refresh_interval=0.0, audit_sample=2, audit_inline=True,
        device="cpu",
    )
    port = await server.start(0, host="127.0.0.1")
    await server.load_config(parse_yaml_config(EIGHT_LANE_CONFIG))
    await asyncio.sleep(0)
    clients = []
    for i, wants in enumerate([20.0, 30.0, 60.0]):
        c = await Client.connect(
            f"127.0.0.1:{port}", f"c{i}", minimum_refresh_interval=0.0
        )
        for rid in RIDS:
            await c.resource(rid, wants=wants)
        clients.append(c)
    # Drive until `ticks` solves have APPLIED: the resident lane
    # pipelines dispatch, so the first tick_once stages without
    # landing and the audit hook (keyed on applied ticks) would
    # otherwise see one fewer aligned sample than the loop count.
    for _ in range(ticks + 4):
        if server._ticks_done >= ticks:
            break
        await server.tick_once()
        for c in clients:
            await c.refresh_once()
    assert server._ticks_done >= ticks
    return server, clients


async def _teardown(server, clients):
    for c in clients:
        await c.close()
    await server.stop()


def test_clean_run_all_eight_lanes_zero_divergences():
    async def body():
        server, clients = await _eight_lane_server(12)
        try:
            st = server.shadow_audit.status()
            assert st["samples"] >= 6
            # All eight lanes minus the skip set were actually compared.
            assert st["compared_resources"] >= 6 * len(RIDS)
            assert st["divergences"] == 0 and st["details"] == []
            verdicts = {v["slo"]: v for v in server.evaluate_slos()}
            assert verdicts["audit_divergence"]["status"] == "pass"
        finally:
            await _teardown(server, clients)

    asyncio.run(body())


def test_forced_corruption_fires_the_blast():
    """Silently scale one delivered grant: the auditor confirms within
    two samples and the blast lands — counter, flight-recorder dump,
    standing SLO failure."""
    from doorman_tpu_torch.obs import metrics as metrics_mod

    async def body():
        server, clients = await _eight_lane_server(8)
        try:
            assert server.shadow_audit.divergences == 0
            store = server.resources["r-fair"].store
            store.regrant("c0", store.get("c0").has * 0.75)
            # Two aligned samples confirm (tick numbers divisible by K).
            aud = server.shadow_audit
            aud.maybe_sample(100, None, server.resources)
            aud.maybe_sample(102, None, server.resources)
            assert aud.divergences == 1
            (detail,) = aud.details
            assert detail["rid"] == "r-fair" and "c0" in detail["clients"]
            counter = metrics_mod.default_registry().counter(
                "doorman_audit_divergence", "", labels=("server", "resource")
            )
            assert counter.value("audit-server", "r-fair") == 1
            assert server.flightrec.last_dump is not None
            verdicts = {v["slo"]: v for v in server.evaluate_slos()}
            assert verdicts["audit_divergence"]["status"] == "fail"
        finally:
            await _teardown(server, clients)

    asyncio.run(body())
