"""The chaos harness's plans, regressions and the federation and fleet
arcs on the port (doorman_tpu_torch/chaos/, cmd/chaos.py), held against
the JAX package.

  * the cases of tests/test_chaos_plan.py: plan JSON round trips (and
    equal to the reference's bytes), save / load, the rejected kinds and
    warmup events, and a replayed plan's equal event log;
  * the cases of tests/test_chaos_regressions.py on the port: one etcd
    keepalive hiccup is not a lost mastership, the stale port,
    `wait_for_backend`'s retry classification, and an injected
    ResidentOverflow clearing both resident handles through the
    server's `_resident_step` / `_resident_wide_step` seams;
  * the seams themselves: `run_tick` calls them through the instance;
  * the restore log: the port's runner logs a warm restore whose
    summary took a logged one's id, which the reference drops;
  * tests/test_federation.py's two shard_partition cases and
    tests/test_fleet.py's fleet-plan case, over the port's shard roots,
    each verdict equal to the reference's;
  * `cmd.chaos --device cpu` as a subprocess: the reference's verdict
    on stdout, the tick device on stderr.

The port runs with device="cpu" (the kernels' plain versions).
"""

import asyncio
import importlib.util
import json
import pathlib
import subprocess
import sys

import pytest

import tests.conftest  # noqa: F401
import tests._torch_threads  # noqa: F401

from doorman_tpu.chaos import FaultPlan as JFaultPlan
from doorman_tpu.chaos import get_plan as j_get_plan
from doorman_tpu_torch.chaos import (
    ChaosEtcdGateway,
    ChaosRunner,
    FaultEvent,
    FaultPlan,
    FaultState,
    PortInjector,
    SolverInjector,
    backend_probe_argv,
    get_plan,
)
from doorman_tpu_torch.chaos.plans import PLANS
from doorman_tpu_torch.server.election import EtcdKV, KVElection
from doorman_tpu_torch.utils.backend import wait_for_backend
from tests._chaos_ref import RefChaosRunner as JChaosRunner
from tests.fake_etcd import FakeEtcd

REPO = pathlib.Path(__file__).resolve().parent.parent


def _port_run(plan):
    runner = ChaosRunner(plan, device="cpu")
    return asyncio.run(runner.run()), runner


def _ref_run(plan):
    return asyncio.run(JChaosRunner(plan).run())


# ----------------------------------------------------------------------
# Plans (tests/test_chaos_plan.py)
# ----------------------------------------------------------------------


def test_plan_json_round_trip_is_byte_identical():
    for name in PLANS:
        plan = get_plan(name)
        text = plan.to_json()
        again = FaultPlan.from_json(text)
        assert again == plan
        assert again.to_json() == text
        # The replay artifact is one format: the reference loads the
        # port's bytes and writes them back unchanged.
        assert text == j_get_plan(name).to_json()
        assert JFaultPlan.from_json(text).to_json() == text


def test_plan_save_load(tmp_path):
    plan = get_plan("master_flap")
    path = tmp_path / "plan.json"
    plan.save(str(path))
    assert FaultPlan.load(str(path)) == plan
    assert JFaultPlan.load(str(path)).to_json() == plan.to_json()


def test_unknown_fault_kind_rejected():
    with pytest.raises(ValueError):
        FaultEvent(at_tick=0, kind="gremlins")


def test_event_inside_warmup_rejected():
    with pytest.raises(ValueError):
        FaultPlan(
            name="bad", seed=0, setup={},
            events=[FaultEvent(at_tick=1, kind="kv_drop")],
            warmup_ticks=5,
        )


def test_same_seed_and_plan_replays_identical_event_log():
    plan = get_plan("master_flap")
    v1, _ = _port_run(plan)
    v2, _ = _port_run(FaultPlan.from_json(plan.to_json()))
    assert v1["event_log"] == v2["event_log"]
    assert v1["log_sha256"] == v2["log_sha256"]
    assert v1["ok"] and v2["ok"]
    assert v1["log_sha256"] == _ref_run(j_get_plan("master_flap"))[
        "log_sha256"]


# ----------------------------------------------------------------------
# Regressions (tests/test_chaos_regressions.py)
# ----------------------------------------------------------------------


def _load_drive_common():
    spec = importlib.util.spec_from_file_location(
        "_drive_common", REPO / "tools" / "drives" / "_common.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_election_renewal_retry_survives_one_etcd_hiccup():
    """One dropped /v3/lease/keepalive round-trip through the port's
    ChaosEtcdGateway is retried inside the renewal window, not read as
    mastership loss."""
    plan = FaultPlan(
        name="renewal_hiccup",
        seed=0,
        setup={"election_ttl": 1.5},
        events=[
            FaultEvent(
                at_tick=0, kind="etcd_drop", target="etcd",
                duration_ticks=1,
                params={"calls": 1,
                        "path_prefix": "/v3/lease/keepalive"},
            )
        ],
        warmup_ticks=0,
        total_ticks=1,
    )
    fake = FakeEtcd()
    fake.start()
    state = FaultState(plan.seed)

    async def body():
        ttl = plan.setup["election_ttl"]
        gw = ChaosEtcdGateway([fake.address], state)
        election = KVElection(
            EtcdKV([fake.address], gateway=gw), "/chaos-lock", ttl=ttl
        )
        events = []
        won = asyncio.Event()

        async def on_is_master(is_master):
            events.append(is_master)
            if is_master:
                won.set()

        async def on_current(_):
            pass

        await election.run("candidate", on_is_master, on_current)
        await asyncio.wait_for(won.wait(), 10)
        for ev in plan.events_at(0):
            state.start(ev)
        await asyncio.sleep(1.5 * ttl)
        assert events == [True], "one etcd hiccup read as mastership loss"
        assert fake.value("/chaos-lock") == "candidate"
        # The hiccup was consumed: the budgeted drop really fired.
        assert state.active("etcd_drop", "etcd") is None
        await election.stop()

    try:
        asyncio.run(body())
    finally:
        fake.stop()


def test_stale_port_detected_by_ensure_ports_free():
    plan = FaultPlan(
        name="stale_port",
        seed=0,
        setup={},
        events=[FaultEvent(at_tick=0, kind="port_bind",
                           duration_ticks=0)],
        warmup_ticks=0,
        total_ticks=1,
    )
    common = _load_drive_common()
    ports = PortInjector()
    try:
        bound = [ports.bind() for ev in plan.events_at(0)]
        assert bound
        with pytest.raises(SystemExit):
            common.ensure_ports_free(bound[0])
    finally:
        ports.release_all()
    common.ensure_ports_free(bound[0])


def test_backend_probe_rides_out_transient_blip():
    state = FaultState(0)
    state.start(FaultEvent(
        at_tick=0, kind="backend_probe_fail", duration_ticks=10,
        params={"calls": 1, "mode": "tunnel_down"},
    ))
    reason = wait_for_backend(
        attempts=2, per_timeout_s=0.5,
        probe_argv=lambda: backend_probe_argv(state),
    )
    assert reason is None


def test_backend_probe_fails_fast_on_unretryable_breakage():
    state = FaultState(0)
    state.start(FaultEvent(
        at_tick=0, kind="backend_probe_fail", duration_ticks=10,
        params={"mode": "unretryable"},
    ))
    reason = wait_for_backend(
        attempts=3, per_timeout_s=30.0,
        probe_argv=lambda: backend_probe_argv(state),
    )
    assert reason is not None and "ModuleNotFoundError" in reason


OVERFLOW_CONFIG = (
    "resources:\n"
    "- identifier_glob: \"*\"\n"
    "  capacity: 100\n"
    "  algorithm: {kind: PROPORTIONAL_SHARE, lease_length: 60,\n"
    "              refresh_interval: 1, learning_mode_duration: 0}\n"
)


def test_resident_overflow_clears_both_resident_handles():
    """An injected ResidentOverflow, raised from the port server's
    `_resident_step` seam, takes the BatchSolver fallback and drops BOTH
    in-flight handles: a surviving wide handle would be collected next
    tick and overwrite the fallback's fresher grants."""
    from doorman_tpu_torch.algorithms import Request
    from doorman_tpu_torch.server.config import parse_yaml_config
    from doorman_tpu_torch.server.election import TrivialElection
    from doorman_tpu_torch.server.server import CapacityServer
    from doorman_tpu_torch.solver.batch import DENSE_MAX_K

    plan_event = FaultEvent(
        at_tick=0, kind="resident_overflow", target="s0",
        duration_ticks=1, params={"calls": 1},
    )

    async def body():
        state = FaultState(0)
        server = CapacityServer(
            "s0", TrivialElection(), mode="batch",
            native_store=True, minimum_refresh_interval=0.0,
            device="cpu",
        )
        SolverInjector(state, "s0").install(server)
        await server.load_config(parse_yaml_config(OVERFLOW_CONFIG))
        await asyncio.sleep(0)
        for c, w in [("a", 60.0), ("b", 50.0)]:
            server._decide("narrow0", Request(c, 0.0, w, 1, priority=1))
        wide = server.get_or_create_resource("wide0")
        for i in range(DENSE_MAX_K + 8):
            wide.store.assign(f"w{i}", 60.0, 1.0, 0.0, 1.0, 1)
        await server.tick_once()
        await server.tick_once()
        assert len(server._resident_pipe) > 0
        assert len(server._resident_wide_pipe) > 0
        state.start(plan_event)
        await server.tick_once()  # overflow -> BatchSolver fallback
        assert state.active("resident_overflow", "s0") is None
        assert len(server._resident_pipe) == 0
        assert len(server._resident_wide_pipe) == 0, (
            "fallback tick left a stale wide handle collectable"
        )
        await server.stop()

    asyncio.run(body())


def test_run_tick_calls_the_resident_seams_through_the_instance():
    """`_resident_step` and `_resident_wide_step` exist on the port's
    server as on the reference's, and the tick reaches them through
    `self`: an instance-level wrap sees every narrow and wide step, and
    the grants equal an unwrapped twin's."""
    from doorman_tpu_torch.algorithms import Request
    from doorman_tpu_torch.server.config import parse_yaml_config
    from doorman_tpu_torch.server.election import TrivialElection
    from doorman_tpu_torch.server.server import CapacityServer
    from doorman_tpu_torch.solver.batch import DENSE_MAX_K

    async def drive(wrap):
        server = CapacityServer(
            "s0", TrivialElection(), mode="batch",
            native_store=True, minimum_refresh_interval=0.0,
            device="cpu", clock=lambda: 1_000_000.0,
        )
        calls = []
        if wrap:
            for attr in ("_resident_step", "_resident_wide_step"):
                orig = getattr(server, attr)

                def step(solver, resources, epoch, _o=orig, _a=attr):
                    calls.append((_a, sorted(r.id for r in resources)))
                    return _o(solver, resources, epoch)

                setattr(server, attr, step)
        await server.load_config(parse_yaml_config(OVERFLOW_CONFIG))
        for c, w in [("a", 60.0), ("b", 50.0)]:
            server._decide("narrow0", Request(c, 0.0, w, 1, priority=1))
        wide = server.get_or_create_resource("wide0")
        for i in range(DENSE_MAX_K + 8):
            wide.store.assign(f"w{i}", 60.0 + i, 1.0, 0.0, 1.0, 1)
        for _ in range(4):
            await server.tick_once()
        rows = {rid: res.store.dump_rows()
                for rid, res in sorted(server.resources.items())}
        await server.stop()
        return calls, rows

    calls, wrapped = asyncio.run(drive(True))
    _, plain = asyncio.run(drive(False))
    assert calls == [
        ("_resident_step", ["narrow0"]),
        ("_resident_wide_step", ["wide0"]),
    ] * 4
    assert repr(wrapped) == repr(plain)


def test_restore_log_survives_a_reused_id(monkeypatch):
    """Every summary gets one id here, as when a summary freed at a
    mastership flip hands its id to the next: the reference's runner
    then drops the warm restore from its log, the port's logs both."""
    import types

    import doorman_tpu.chaos.runner as jrunner
    import doorman_tpu_torch.chaos.runner as trunner

    def logged(runner):
        server = types.SimpleNamespace(last_restore=None)
        runner.servers = {"s1": server}
        for tick, mode in enumerate(["cold_empty", "warm"]):
            server.last_restore = {
                "mode": mode, "leases_restored": tick, "clean_down": True,
                "resources": {"r0": {"learning": "skip"}},
            }
            runner._log_restores(tick)
        return [e[3] for e in runner.log if e[1] == "restore"]

    for mod in (jrunner, trunner):
        monkeypatch.setattr(mod, "id", lambda obj: 1, raising=False)
    plan = get_plan("master_flap_warm")
    assert logged(jrunner.ChaosRunner(j_get_plan(plan.name))) == [
        "cold_empty"]
    assert logged(ChaosRunner(plan, device="cpu")) == ["cold_empty", "warm"]


# ----------------------------------------------------------------------
# Federation and fleet plans over port shard roots
# (tests/test_federation.py, tests/test_fleet.py)
# ----------------------------------------------------------------------


def test_shard_partition_emits_federation_partition_instant():
    from doorman_tpu_torch.obs import trace as trace_mod

    tracer = trace_mod.default_tracer()
    tracer.enable()
    try:
        verdict, _ = _port_run(get_plan("shard_partition"))
        assert verdict["ok"]
        marks = [
            e for e in tracer.snapshot() if e.name == "federation.partition"
        ]
        assert marks, "partition onset never hit the trace timeline"
        assert marks[0].args["shards"] == [1]
    finally:
        tracer.disable()
        tracer.clear()


def test_shard_partition_plan_arc_and_determinism():
    v1, runner = _port_run(get_plan("shard_partition"))
    v2, _ = _port_run(get_plan("shard_partition"))
    assert v1["ok"], v1["event_log"]
    assert v1["violations"] == []
    assert v1["log_sha256"] == v2["log_sha256"]
    assert v1["log_sha256"] == _ref_run(j_get_plan("shard_partition"))[
        "log_sha256"]
    # The roots really are the port's shard servers.
    assert sorted(
        s.shard for n, s in runner.servers.items() if n.startswith("s")
    ) == [0, 1, 2]
    assert all(
        type(s).__module__.startswith("doorman_tpu_torch.")
        for s in runner.servers.values()
    )

    log = v1["event_log"]
    assert [e for e in log if e[1] == "master"][0][2] == [
        "s0", "s1", "s2",
    ]
    straddles = [e for e in log if e[1] == "straddle"]
    assert [[0, 22.5], [1, 22.5], [2, 45.0]] in [e[3] for e in straddles]
    fault_tick = next(e[0] for e in log if e[1] == "fault")
    during = [e[3] for e in straddles if e[0] >= fault_tick][0]
    assert during == [[0, 22.5], [2, 45.0]]
    assert any(e[1] == "degraded" for e in log)
    assert v1["converged_after_heal_ticks"] is not None


@pytest.mark.parametrize(
    "name", ["fleet_reshard_live", "fleet_reshard_partition"]
)
def test_fleet_chaos_plans_hold_and_are_deterministic(name):
    v, runner = _port_run(get_plan(name))
    assert v["ok"], v["violations"]
    assert v["violations"] == []
    epochs = [e for e in runner.log if e[1] == "fleet_epoch"]
    assert epochs, "plan must actually publish routing epochs"
    again, _ = _port_run(get_plan(name))
    assert again["log_sha256"] == v["log_sha256"]
    assert v["log_sha256"] == _ref_run(j_get_plan(name))["log_sha256"]


# ----------------------------------------------------------------------
# The CLI
# ----------------------------------------------------------------------


def test_cmd_chaos_runs_a_batch_plan_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "doorman_tpu_torch.cmd.chaos",
         "--plan", "device_tunnel_outage", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=240,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    verdict = json.loads(out.stdout)
    ref = _ref_run(j_get_plan("device_tunnel_outage"))
    assert verdict["log_sha256"] == ref["log_sha256"]
    assert verdict["ok"]
    assert "tick device cpu, batch ticks" in out.stderr


def test_cmd_chaos_lists_and_saves_plans(tmp_path):
    from doorman_tpu_torch.cmd import chaos as cmd_chaos

    args = cmd_chaos.make_parser().parse_args(["--list"])
    assert args.device == "cuda"
    path = tmp_path / "plan.json"
    args = cmd_chaos.make_parser().parse_args(
        ["--save-plan", "grant_corruption", str(path)]
    )
    assert asyncio.run(cmd_chaos.run(args)) == 0
    assert path.read_text() == j_get_plan("grant_corruption").to_json()
