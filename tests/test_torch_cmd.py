"""The port's command-line tools: the server binary's observability flags
and debug pages (the reference's defaults; /metrics and /debug/status
answering on a loopback port while a batch server on the native store
ticks), the shell's cases of tests/test_cmd.py (Multiclient, eval_line)
against a port server, and the offline history tool (`cmd.obs`:
status / query / delta) over a history that a port server wrote across
two runs."""

import asyncio
import json
import urllib.request

import pytest

import tests.conftest  # noqa: F401

from doorman_tpu.cmd import server as j_cmd
from doorman_tpu_torch import native
from doorman_tpu_torch.cmd import client as client_cmd
from doorman_tpu_torch.cmd import obs as obs_cmd
from doorman_tpu_torch.cmd import server as t_cmd
from doorman_tpu_torch.cmd.shell import Multiclient, eval_line
from doorman_tpu_torch.obs import trace as trace_mod

CONFIG = """
resources:
- identifier_glob: "*"
  capacity: 90
  algorithm: {kind: FAIR_SHARE, lease_length: 60, refresh_interval: 1,
              learning_mode_duration: 0}
"""

OBS_FLAGS = ("debug_port", "profile_dir", "profile_ticks", "trace",
             "trace_buffer", "flightrec_buffer", "flightrec_dir",
             "history_dir", "history_buffer", "audit_sample", "detect")


def fetch(port, path):
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}{path}", timeout=10
    ) as resp:
        return resp.status, resp.read().decode()


async def _start_serve(argv):
    """Run serve() as a task; (task, server, debug) once bound and
    master."""
    args = t_cmd.make_parser().parse_args(argv)
    started = asyncio.get_running_loop().create_future()
    task = asyncio.create_task(t_cmd.serve(
        args, on_started=lambda s, d: started.set_result((s, d))
    ))
    server, debug = await asyncio.wait_for(started, 10)
    await asyncio.wait_for(server.wait_until_configured(), 10)
    for _ in range(100):
        if server.is_master:
            break
        await asyncio.sleep(0.05)
    server.current_master = f"127.0.0.1:{server.port}"
    return task, server, debug


async def _stop(task):
    task.cancel()
    try:
        await task
    except (asyncio.CancelledError, Exception):
        pass


def test_obs_flags_have_the_reference_defaults():
    ref, port = j_cmd.make_parser(), t_cmd.make_parser()
    for dest in OBS_FLAGS:
        assert port.get_default(dest) == ref.get_default(dest), dest


@pytest.mark.skipif(not native.native_available(),
                    reason="native engine unavailable")
def test_batch_native_server_serves_metrics_and_status(tmp_path):
    """What chip_smoke.py's obs phase checks on the card, here on the
    CPU: the tick-phase histograms of the resident component and the
    GetCapacity request count on /metrics, the backend on
    /debug/status, the flight recorder and the tracer's spans."""
    cfg = tmp_path / "cfg.yml"
    cfg.write_text(CONFIG)

    async def body():
        task, server, debug = await _start_serve([
            "--config", f"file:{cfg}", "--port", "0", "--host",
            "127.0.0.1", "--debug-port", "0", "--device", "cpu",
            "--mode", "batch", "--native-store", "--tick-interval", "0.05",
            "--trace", "--trace-buffer", "4096",
        ])
        try:
            addr = f"127.0.0.1:{server.port}"
            for i in range(3):
                rc = await client_cmd.run(client_cmd.make_parser().parse_args(
                    ["--server", addr, "--client-id", f"c{i}", "r0", "30"]
                ))
                assert rc == 0
            # Idle ticks before the first request also write flight
            # records: wait for ticks that applied grants (the status
            # page names the backend only after one).
            for _ in range(200):
                if server.flightrec.head_seq >= 3 and server._ticks_done:
                    break
                await asyncio.sleep(0.05)
            loop = asyncio.get_running_loop()
            status, text = await loop.run_in_executor(
                None, fetch, debug.port, "/metrics"
            )
            assert status == 200
            assert ('doorman_tick_phase_seconds_count{component="resident",'
                    'phase="fused"}') in text
            assert 'doorman_server_requests_count{method="GetCapacity"} 3' \
                in text
            status, page = await loop.run_in_executor(
                None, fetch, debug.port, "/debug/status"
            )
            assert status == 200 and "backend: cpu" in page
            assert "flight recorder: head seq" in page
            status, page = await loop.run_in_executor(
                None, fetch, debug.port, "/debug/traces?format=chrome"
            )
            names = {e["name"] for e in json.loads(page)["traceEvents"]}
            assert {"server.GetCapacity", "server.tick", "fused"} <= names
        finally:
            await _stop(task)
            trace_mod.default_tracer().disable()
            trace_mod.default_tracer().clear()

    asyncio.run(body())


def test_shell_commands_against_a_port_server(tmp_path):
    cfg = tmp_path / "cfg.yml"
    cfg.write_text(CONFIG)

    async def body():
        task, server, _ = await _start_serve([
            "--config", f"file:{cfg}", "--port", "0", "--host",
            "127.0.0.1", "--debug-port", "-1", "--device", "cpu",
            "--minimum-refresh-interval", "0",
        ])
        try:
            mc = Multiclient(f"127.0.0.1:{server.port}")
            out = await eval_line(mc, "get alice r0 50")
            assert "alice: r0 = " in out
            out = await eval_line(mc, "get bob r0 60")
            assert "bob: r0 = " in out
            out = await eval_line(mc, "show all")
            assert "alice" in out and "bob" in out
            assert await eval_line(mc, "master")
            assert "unknown command" in (await eval_line(mc, "frobnicate"))
            out = await eval_line(mc, "release alice r0")
            assert "released" in out
            assert not server.resources["r0"].store.has_client("alice")
            await mc.close()
        finally:
            await _stop(task)

    asyncio.run(body())


def _obs(argv, out_path):
    args = obs_cmd.make_parser().parse_args(argv + ["--out", str(out_path)])
    rc = obs_cmd.run(args)
    return rc, json.loads(out_path.read_text())


def test_obs_tool_reads_a_history_a_port_server_wrote(tmp_path):
    cfg = tmp_path / "cfg.yml"
    cfg.write_text(CONFIG)
    hist = str(tmp_path / "hist")

    async def one_run(ticks):
        task, server, _ = await _start_serve([
            "--config", f"file:{cfg}", "--port", "0", "--host",
            "127.0.0.1", "--debug-port", "-1", "--device", "cpu",
            "--mode", "batch", "--tick-interval", "3600",
            "--history-dir", hist,
        ])
        try:
            from doorman_tpu_torch.algorithms import Request

            server._decide("r0", Request("c1", 0.0, 30.0, 1))
            for _ in range(ticks):
                await server.tick_once()
            return server.history.run
        finally:
            await _stop(task)

    assert asyncio.run(one_run(5)) == 1
    assert asyncio.run(one_run(4)) == 2
    rc, st = _obs(["status", "--history-dir", hist], tmp_path / "s.json")
    assert rc == 0 and st["runs"] == [1, 2] and st["segments"] == 2
    rc, view = _obs(
        ["query", "--history-dir", hist, "--start", "2", "--end", "6",
         "--field", "wall_ms"],
        tmp_path / "q.json",
    )
    assert rc == 0
    assert [r["hseq"] for r in view["records"]] == [2, 3, 4, 5, 6]
    assert all("wall_ms" in r for r in view["records"])
    rc, delta = _obs(["delta", "--history-dir", hist, "--field", "wall_ms"],
                     tmp_path / "d.json")
    assert rc == 0
    assert delta["run"] == 2 and delta["previous_run"] == 1
    assert delta["samples"] == 4 and delta["previous_samples"] == 5


# ----------------------------------------------------------------------
# --shard i/N (federated root shards)
# ----------------------------------------------------------------------


@pytest.mark.parametrize(
    "spec,want", [("0/1", 0), ("2/4", 2), ("7/8", 7), ("", None)]
)
def test_shard_flag_parses_i_of_n(spec, want):
    assert t_cmd.parse_shard(spec) == want
    args = t_cmd.make_parser().parse_args(["--shard", spec])
    assert args.shard == spec == j_cmd.make_parser().parse_args(
        ["--shard", spec]
    ).shard


@pytest.mark.parametrize("spec", ["4/4", "-1/2", "1/0", "x", "1", "a/b"])
def test_shard_flag_rejects_what_the_reference_rejects(spec, tmp_path):
    """A malformed --shard exits with status 2 before anything starts,
    in both packages' serve()."""
    cfg = tmp_path / "cfg.yml"
    cfg.write_text(CONFIG)
    argv = ["--shard", spec, "--config", f"file:{cfg}", "--port", "0",
            "--debug-port", "-1"]
    for cmd, extra in ((t_cmd, ["--device", "cpu"]), (j_cmd, [])):
        with pytest.raises(SystemExit) as exc:
            asyncio.run(cmd.serve(cmd.make_parser().parse_args(
                argv + extra
            )))
        assert exc.value.code == 2, cmd


def test_shard_flag_suffixes_the_lock_and_namespaces_persist(tmp_path):
    """--shard 1/2 with --master-election-lock and --persist file:: the
    server campaigns for <lock>/shard1 on etcd, journals and snapshots
    under <dir>/shard1 only, and carries shard 1 in status()."""
    from doorman_tpu_torch.algorithms import Request
    from doorman_tpu_torch.server.etcd import EtcdGateway
    from tests.fake_etcd import FakeEtcd

    fake = FakeEtcd()
    fake.start()
    cfg = tmp_path / "cfg.yml"
    cfg.write_text(CONFIG)
    state = tmp_path / "state"

    async def body():
        task, server, _ = await _start_serve([
            "--shard", "1/2", "--config", f"file:{cfg}",
            "--etcd-endpoints", fake.address, "--master-election-lock",
            "/fed/lock", "--master-delay", "2", "--persist",
            f"file:{state}", "--snapshot-interval", "1", "--port", "0",
            "--host", "127.0.0.1", "--debug-port", "-1", "--device",
            "cpu", "--server-id", "shard1-a",
        ])
        try:
            assert server.is_master
            assert fake.value("/fed/lock/shard1") == "shard1-a"
            assert fake.value("/fed/lock") is None
            assert server.shard == 1
            assert server.status()["federation"] == {
                "shard": 1, "straddle_shares": {}, "straddle_updates": 0,
                "straddle_capacity": 0.0, "upstream_rpcs": 0,
                "fleet_redirects": 0,
            }
            server.became_master_at -= 60.0
            server._decide("r0", Request("c0", 0.0, 30.0, 1))
            server.persist_step()
            assert sorted(p.name for p in state.iterdir()) == ["shard1"]
            assert any((state / "shard1").iterdir())
        finally:
            await _stop(task)
            EtcdGateway([fake.address]).put("/fed/lock", "")

    try:
        asyncio.run(body())
    finally:
        fake.stop()


ADMISSION_FLAGS = ("admission", "coalesce_window", "admission_max_rps",
                   "fuse_admission", "frontend_workers",
                   "frontend_ring_bytes")


def test_admission_and_frontend_flags_have_the_reference_defaults():
    ref, port = j_cmd.make_parser(), t_cmd.make_parser()
    for dest in ADMISSION_FLAGS:
        assert port.get_default(dest) == ref.get_default(dest), dest


@pytest.mark.parametrize("argv,warning", [
    (["--fuse-admission"], "has no effect without --admission"),
    (["--fuse-admission", "--admission"],
     "has no effect without --native-store"),
])
def test_fuse_admission_warns_without_its_write_path(
    argv, warning, tmp_path, caplog
):
    """--fuse-admission without --admission (the reference's warning)
    or without --native-store is loud, not fatal: the server starts."""
    cfg = tmp_path / "cfg.yml"
    cfg.write_text(CONFIG)

    async def body():
        task, server, _ = await _start_serve([
            "--config", f"file:{cfg}", "--port", "0", "--host",
            "127.0.0.1", "--debug-port", "-1", "--device", "cpu",
            "--mode", "batch", *argv,
        ])
        try:
            assert server._fuse_admission
            assert (server._admission is not None) == (
                "--admission" in argv)
        finally:
            await _stop(task)

    with caplog.at_level("WARNING"):
        asyncio.run(body())
    assert any(warning in r.getMessage() for r in caplog.records)


def test_admission_flag_gates_get_capacity(tmp_path):
    """--admission with --admission-max-rps: the binary sheds past the
    budget with RESOURCE_EXHAUSTED and the retry-after trailer, and
    /debug/status's admission block counts it."""
    import grpc

    from doorman_tpu_torch.admission import RETRY_AFTER_KEY
    from doorman_tpu_torch.proto import doorman_pb2 as pb
    from doorman_tpu_torch.proto.grpc_api import CapacityStub

    cfg = tmp_path / "cfg.yml"
    cfg.write_text(CONFIG)

    async def body():
        task, server, _ = await _start_serve([
            "--config", f"file:{cfg}", "--port", "0", "--host",
            "127.0.0.1", "--debug-port", "-1", "--device", "cpu",
            "--admission", "--coalesce-window", "0.002",
            "--admission-max-rps", "0.5",
        ])
        try:
            assert server._admission.coalesce_window == 0.002
            shed = 0
            async with grpc.aio.insecure_channel(
                f"127.0.0.1:{server.port}"
            ) as ch:
                stub = CapacityStub(ch)
                for i in range(4):
                    req = pb.GetCapacityRequest(client_id=f"c{i}")
                    rr = req.resource.add()
                    rr.resource_id = "r0"
                    rr.wants = 5.0
                    try:
                        await stub.GetCapacity(req)
                    except grpc.aio.AioRpcError as e:
                        assert e.code() == (
                            grpc.StatusCode.RESOURCE_EXHAUSTED)
                        assert any(k == RETRY_AFTER_KEY for k, _ in
                                   e.trailing_metadata() or ())
                        shed += 1
            assert shed >= 1
            st = server.status()["admission"]
            assert st["tallies"]["GetCapacity/0"]["shed"] == shed
        finally:
            await _stop(task)

    asyncio.run(body())


def test_frontend_workers_flag_needs_stream_push(tmp_path):
    cfg = tmp_path / "cfg.yml"
    cfg.write_text(CONFIG)
    args = t_cmd.make_parser().parse_args([
        "--config", f"file:{cfg}", "--port", "0", "--host", "127.0.0.1",
        "--debug-port", "-1", "--device", "cpu", "--frontend-workers", "2",
    ])
    with pytest.raises(SystemExit):
        asyncio.run(t_cmd.serve(args))
