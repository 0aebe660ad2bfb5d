"""Every shipped chaos plan on the port (doorman_tpu_torch/chaos/), held
against the JAX package.

The port's ChaosRunner runs each of the 16 plans with device="cpu" (the
kernels' plain versions); the reference's runs the same plan, its
restore log made deterministic (tests/_chaos_ref.py). Then:

  * parity: the same `log_sha256`, and the whole verdict equal under
    `json.dumps(sort_keys=True)`. No field is excepted: the verdict is
    built from the virtual clock, the seeded switchboard and the
    stores' digests, and the port's copies of those produce the same
    bytes on the CPU;
  * the cases of tests/test_chaos_smoke.py, each on the port's
    verdicts: invariants, reconvergence inside the budget, and the arc
    each plan was written to provoke (failover without split brain, the
    streaming leg, warm restores per fairness lane, bottom-up shedding,
    the etcd hiccup, tick errors from the dead device, the intermediate
    partition, SLO blocks, the audit catching the corrupted grant, the
    frontend crash and stall), with the replays that pin determinism.
"""

import asyncio
import json

import pytest

import tests.conftest  # noqa: F401
import tests._torch_threads  # noqa: F401

from doorman_tpu.chaos import get_plan as j_get_plan
from doorman_tpu.chaos.plans import PLANS as J_PLANS
from doorman_tpu_torch.chaos import ChaosRunner, get_plan
from doorman_tpu_torch.chaos.plans import PLANS
from tests._chaos_ref import RefChaosRunner as JChaosRunner


def run_plan(name):
    return asyncio.run(ChaosRunner(get_plan(name), device="cpu").run())


def _canonical(verdict):
    return json.dumps(verdict, sort_keys=True)


@pytest.fixture(scope="module")
def both():
    """{name: (reference verdict, port verdict)} for every plan."""
    return {
        name: (
            asyncio.run(JChaosRunner(j_get_plan(name)).run()),
            run_plan(name),
        )
        for name in PLANS
    }


@pytest.fixture(scope="module")
def verdicts(both):
    return {name: pair[1] for name, pair in both.items()}


def test_the_port_ships_the_reference_plans():
    assert list(PLANS) == list(J_PLANS)
    for name in PLANS:
        assert get_plan(name).to_json() == j_get_plan(name).to_json()


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_verdict_equals_the_reference(both, name):
    ref, port = both[name]
    assert port["log_sha256"] == ref["log_sha256"]
    assert port["event_log"] == ref["event_log"]
    assert _canonical(port) == _canonical(ref)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_upholds_invariants(verdicts, name):
    v = verdicts[name]
    assert v["violations"] == [], v["event_log"]
    assert v["ok"], v
    assert v["converged_after_heal_ticks"] is not None
    assert (
        v["converged_after_heal_ticks"]
        <= get_plan(name).reconverge_ticks
    )


def _kinds(v):
    return [e[1] for e in v["event_log"]]


def _masters_timeline(v):
    return [(e[0], e[2]) for e in v["event_log"] if e[1] == "master"]


def test_master_flap_fails_over_without_split_brain(verdicts):
    v = verdicts["master_flap"]
    timeline = _masters_timeline(v)
    assert timeline[0][1] == ["s0"]
    assert [] in [m for _, m in timeline]
    assert ["s1"] in [m for _, m in timeline]


def test_master_flap_streaming_leg(verdicts):
    """Establish with the snapshot push, silent at steady state, a
    terminal redirect and poll fallback at the flip, re-establishment
    once a master answers."""
    v = verdicts["master_flap"]
    flap_tick = next(
        e[0] for e in v["event_log"] if e[1] == "fault"
    )
    streams = [e for e in v["event_log"] if e[1] == "stream"]
    assert streams, "no streaming leg in master_flap"
    by_tick = {e[0]: e[3] for e in streams}
    assert by_tick[0] == "establish" and streams[0][4] == 1
    for e in streams:
        if 0 < e[0] < flap_tick:
            assert "poll" not in e[3], f"steady-state poll at {e}"
    assert any(
        "redirect" in ev and "poll" in ev
        for t, ev in by_tick.items() if t >= flap_tick
    ), "no redirect+poll fallback at the flip"
    assert any(
        e[3] == "establish" and e[0] > flap_tick and e[4] >= 1
        for e in streams
    ), "stream never re-established after the flap"


def test_master_flap_warm_restores_instead_of_relearning(verdicts):
    v = verdicts["master_flap_warm"]
    plan = get_plan("master_flap_warm")
    restores = [e for e in v["event_log"] if e[1] == "restore"]
    assert [e[3] for e in restores] == ["cold_empty", "warm"]
    warm = restores[-1]
    server, mode, leases, clean_down, learning = warm[2:]
    assert server == "s1" and leases == len(plan.setup["wants"])
    assert clean_down is True
    assert learning == [["r0", "skip"]]
    assert plan.reconverge_ticks < plan.setup["learning_mode_duration"]
    assert (
        v["converged_after_heal_ticks"] <= plan.reconverge_ticks
    )
    assert warm[0] < v["heal_tick"]


WARM_VARIANTS = sorted(n for n in PLANS if n.startswith("master_flap_warm_"))


@pytest.mark.parametrize("name", WARM_VARIANTS)
def test_master_flap_warm_arc_per_fairness_lane(verdicts, name):
    v = verdicts[name]
    plan = get_plan(name)
    restores = [e for e in v["event_log"] if e[1] == "restore"]
    assert [e[3] for e in restores] == ["cold_empty", "warm"]
    warm = restores[-1]
    server, _mode, leases, clean_down, learning = warm[2:]
    assert server == "s1" and leases == len(plan.setup["wants"])
    assert clean_down is True
    assert learning == [["r0", "skip"]]
    assert v["converged_after_heal_ticks"] <= plan.reconverge_ticks
    assert warm[0] < v["heal_tick"]


def test_master_flap_warm_variant_logs_deterministic(verdicts):
    name = "master_flap_warm_maxmin"
    again = run_plan(name)
    assert again["event_log"] == verdicts[name]["event_log"]
    assert again["converged_after_heal_ticks"] == (
        verdicts[name]["converged_after_heal_ticks"]
    )


def test_client_storm_sheds_bottom_up_with_top_band_floor(verdicts):
    v = verdicts["client_storm"]
    plan = get_plan("client_storm")
    storm_tick = plan.events[0].at_tick
    tallies = v["admission"]["s0"]
    assert tallies["GetCapacity/2"]["shed"] == 0
    assert tallies["GetCapacity/0"]["shed"] > tallies["GetCapacity/1"]["shed"] > 0
    assert tallies["ReleaseCapacity/0"]["shed"] == 0
    assert tallies["ReleaseCapacity/0"]["admitted"] >= 20
    storm = [e for e in v["event_log"] if e[1] == "storm"]
    assert len(storm) == plan.events[0].duration_ticks
    assert 0 < storm[0][2] < plan.events[0].params["clients"]
    assert storm[-1][2] == 0
    adm = [e for e in v["event_log"] if e[1] == "admission"]
    assert all(e[4] == 0 for e in adm if e[0] < storm_tick)
    assert all(e[4] == 0 for e in adm[-3:])
    assert v["converged_after_heal_ticks"] == 0


def test_etcd_brownout_survives_single_hiccup_then_relearns(verdicts):
    v = verdicts["etcd_brownout"]
    plan = get_plan("etcd_brownout")
    hiccup_tick = plan.events[0].at_tick
    brownout_tick = plan.events[2].at_tick
    changes = _masters_timeline(v)
    assert all(t != hiccup_tick for t, _ in changes[1:])
    assert (brownout_tick, []) in changes
    assert changes[-1][1] == ["s0"]


def test_device_tunnel_outage_degrades_to_tick_errors(verdicts):
    """The dead device reaches the port's resident tick through the
    server's `_resident_step` seam: three tick errors, no violation."""
    v = verdicts["device_tunnel_outage"]
    errors = [e for e in v["event_log"] if e[1] == "tick_error"]
    assert len(errors) == 3
    assert all("chaos: device backend unreachable" in e[3] for e in errors)


def test_intermediate_partition_degrades_then_heals(verdicts):
    v = verdicts["intermediate_partition"]
    kinds = _kinds(v)
    assert "degraded" in kinds and "converged" in kinds
    degraded_tick = next(e[0] for e in v["event_log"] if e[1] == "degraded")
    assert degraded_tick < v["heal_tick"]


@pytest.mark.parametrize("name", sorted(PLANS))
def test_verdicts_carry_slo_and_flightrec(verdicts, name):
    v = verdicts[name]
    slo_v = {x["slo"]: x for x in v["slo"]["verdicts"]}
    recon = slo_v[f"{name}:reconverge_ticks"]
    assert recon["status"] == "pass"
    assert recon["observed"] == v["converged_after_heal_ticks"]
    assert recon["target"] == get_plan(name).reconverge_ticks
    assert all("delta_vs_prev" in x for x in v["slo"]["verdicts"])
    assert v["slo"]["ok"]
    assert v["flightrec_dump"] is None


def test_grant_corruption_caught_by_shadow_audit(verdicts):
    """A shrunk grant that no structural invariant sees is confirmed by
    the port's fixpoint audit within 2K ticks of the fault."""
    v = verdicts["grant_corruption"]
    plan = get_plan("grant_corruption")
    fault_tick = plan.events[0].at_tick
    sample_k = plan.setup["audit_sample"]
    assert v["violations"] == [] and v["ok"]
    audit = v["audit"]["s0"]
    assert audit["divergences"] == 1
    detail = audit["details"][0]
    assert detail["rid"] == "r0" and detail["clients"] == ["c0"]
    factor = plan.events[0].params["factor"]
    assert detail["has"][0] == pytest.approx(
        detail["expected"][0] * factor
    )
    entries = [e for e in v["event_log"] if e[1] == "audit_divergence"]
    assert entries == [[detail["tick"], "audit_divergence", "s0", 1]]
    assert fault_tick < detail["tick"] <= fault_tick + 2 * sample_k
    det = v["detect"]
    assert det["per_field"]["audit_divergence"] > 0
    assert all(
        d["field"] == "audit_divergence" and d["value"] >= 1.0
        for d in det["detections"]
    )


def test_grant_corruption_verdict_is_byte_stable(verdicts):
    again = run_plan("grant_corruption")
    v = verdicts["grant_corruption"]
    assert again["event_log"] == v["event_log"]
    assert again["log_sha256"] == v["log_sha256"]
    assert again["audit"] == v["audit"]
    assert again["detect"] == v["detect"]


def test_clean_plan_pins_audit_silence(verdicts):
    v = verdicts["device_tunnel_outage"]
    audit = v["audit"]["s0"]
    assert audit["divergences"] == 0 and audit["details"] == []
    assert audit["samples"] > 0
    assert v["detect"] is not None
    assert v["detect"]["anomalies"] == 0
    assert verdicts["master_flap"]["audit"] is None


def test_client_storm_slo_embeds_per_band_tallies(verdicts):
    v = verdicts["client_storm"]
    slo_v = {x["slo"]: x for x in v["slo"]["verdicts"]}
    floor = slo_v["client_storm:top_band_goodput"]
    assert floor["status"] == "pass" and floor["observed"] == 1.0
    per_band = floor["detail"]["per_band"]
    assert per_band["0"]["shed"] > 0
    assert per_band[str(floor["detail"]["band"])]["shed"] == 0
    adm = v["admission"]["s0"]
    for band, counts in per_band.items():
        key = f"GetCapacity/{band}"
        assert adm[key]["admitted"] == counts["admitted"]
        assert adm[key]["shed"] == counts["shed"]


def test_frontend_worker_crash_resets_to_redirect_and_reestablishes(verdicts):
    v = verdicts["frontend_worker_crash"]
    crash = next(e for e in v["event_log"] if e[1] == "worker_crash")
    tick, _, server, worker, dropped = crash
    assert server == "s0" and worker == 0
    assert dropped > 0, "the crash must actually drop streams"
    redirects = [
        e for e in v["event_log"]
        if e[1] == "stream" and e[0] == tick and "redirect" in e[3]
    ]
    assert len(redirects) == dropped
    reestablished = {
        e[2] for e in v["event_log"]
        if e[1] == "stream" and tick < e[0] < v["heal_tick"]
        and "establish" in e[3]
    }
    assert reestablished == {e[2] for e in redirects}
    restore = next(e for e in v["event_log"] if e[1] == "worker_restore")
    assert restore[0] == v["heal_tick"] and restore[3] == worker
    fe = v["frontend"]["s0"]
    assert fe["crashes"] == 1 and fe["restores"] == 1
    assert fe["held"] == get_plan("frontend_worker_crash").setup["streams"]
    assert fe["live"] == [0, 1]
    w0 = fe["per_worker"][0]
    assert w0["reader"]["laps"] == 0


def test_frontend_ring_stall_laps_loudly_on_resume(verdicts):
    v = verdicts["frontend_ring_stall"]
    stall = next(e for e in v["event_log"] if e[1] == "ring_stall")
    resume = next(e for e in v["event_log"] if e[1] == "ring_resume")
    assert stall[0] == get_plan("frontend_ring_stall").events[0].at_tick
    assert resume[0] == v["heal_tick"]
    pump = next(
        e for e in v["event_log"]
        if e[1] == "frontend_pump" and e[0] == resume[0]
    )
    assert pump[4] >= 1
    redirected = {
        e[2] for e in v["event_log"]
        if e[1] == "stream" and e[0] == resume[0] and "redirect" in e[3]
    }
    assert redirected
    all_redirected = {
        e[2] for e in v["event_log"]
        if e[1] == "stream" and "redirect" in e[3]
    }
    assert all_redirected == redirected, (
        "streams outside the stalled worker were reset"
    )
    last_q = v["ticks"] - (v["ticks"] - v["heal_tick"]) // 2
    assert not [
        e for e in v["event_log"]
        if e[1] == "stream" and e[0] >= last_q and "redirect" in e[3]
    ]
    fe = v["frontend"]["s0"]
    assert fe["held"] == get_plan("frontend_ring_stall").setup["streams"]
    assert fe["stalled"] == []


def test_frontend_crash_log_is_deterministic(verdicts):
    again = run_plan("frontend_worker_crash")
    assert again["log_sha256"] == verdicts["frontend_worker_crash"]["log_sha256"]
    assert again["frontend"] == verdicts["frontend_worker_crash"]["frontend"]
