"""The port's flight recorder (doorman_tpu_torch.obs.flightrec), the
cases of tests/test_flightrec.py against the port: ring semantics, dumps
(JSON + Chrome overlay), server integration (per-tick records,
tick-exception auto-dump, /debug/slo and /debug/flightrec endpoints).
The reference's chaos-determinism cases wait for the chaos harness's
port (ROADMAP A.6); tests/test_torch_obs_parity.py holds the port's
tick records against the reference's instead."""

import asyncio
import json
import os
import urllib.request

import tests.conftest  # noqa: F401

from doorman_tpu_torch.obs.debug import DebugServer
from doorman_tpu_torch.obs.flightrec import FlightRecorder, store_digest
from doorman_tpu_torch.server.config import parse_yaml_config
from doorman_tpu_torch.server.election import TrivialElection
from doorman_tpu_torch.server.server import CapacityServer

CONFIG = """
resources:
- identifier_glob: "*"
  capacity: 100
  algorithm: {kind: PROPORTIONAL_SHARE, lease_length: 60,
              refresh_interval: 1, learning_mode_duration: 0}
"""


def fetch(port, path):
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}{path}", timeout=5
    ) as resp:
        return resp.status, resp.read().decode()


# ----------------------------------------------------------------------
# Ring semantics
# ----------------------------------------------------------------------


def test_ring_bounds_and_sequence():
    fr = FlightRecorder(4, component="t", dump_dir="")
    assert fr.occupancy == 0 and fr.head_seq == 0
    for i in range(10):
        fr.record(t=float(i), tick=i)
    assert fr.head_seq == 10
    assert fr.occupancy == 4
    assert [r["seq"] for r in fr.snapshot()] == [7, 8, 9, 10]
    st = fr.status()
    assert st["head_seq"] == 10 and st["capacity"] == 4
    assert st["last_dump"] is None


def test_view_is_side_effect_free_and_dump_writes_files(tmp_path):
    fr = FlightRecorder(
        8, component="t", clock=lambda: 123.0, dump_dir=str(tmp_path)
    )
    for i in range(3):
        fr.record(t=float(i), tick=i, wall_ms=2.0,
                  phases={"solve": 1.5, "apply": 0.5})
    view = fr.view("peek")
    assert len(view["records"]) == 3
    assert fr.last_dump is None and not list(tmp_path.iterdir())

    dump = fr.dump("tick_exception")
    assert dump["reason"] == "tick_exception"
    assert [r["tick"] for r in dump["records"]] == [0, 1, 2]
    assert fr.last_dump["reason"] == "tick_exception"
    names = sorted(p.name for p in tmp_path.iterdir())
    assert len(names) == 2
    assert names[0].endswith(".json") and names[1].endswith(".trace.json")
    # Both artifacts parse; the overlay carries the tick events.
    on_disk = json.loads((tmp_path / names[0]).read_text())
    assert on_disk["records"] == dump["records"]
    overlay = json.loads((tmp_path / names[1]).read_text())
    ticks = [e for e in overlay["traceEvents"]
             if e.get("name") == "tick" and e.get("ph") == "X"]
    assert len(ticks) == 3


def test_chrome_overlay_counters_and_instants():
    fr = FlightRecorder(8, component="t", dump_dir="")
    fr.record(t=0.0, tick=0, wall_ms=3.0, phases={"solve": 3.0},
              admission_level=0.5, shed_by_band={"0": 7})
    fr.record(t=1.0, tick=1, error="RuntimeError: boom")
    overlay = json.loads(fr.chrome_overlay())
    names = [e["name"] for e in overlay["traceEvents"]]
    assert "admission_level" in names and "shed_by_band" in names
    assert "solve" in names and "error" in names


def test_store_digest_tracks_grant_mass():
    class Store:
        def __init__(self, has):
            self.sum_has, self.sum_wants = has, 10.0

        def __len__(self):
            return 1

    class Res:
        def __init__(self, has):
            self.capacity, self.store = 100.0, Store(has)

    a = store_digest({"r0": Res(5.0)})
    assert a == store_digest({"r0": Res(5.0)})  # stable
    assert a != store_digest({"r0": Res(6.0)})  # moves with grants
    assert len(a) == 16


# ----------------------------------------------------------------------
# Server integration
# ----------------------------------------------------------------------


def test_server_records_ticks_and_serves_debug_pages(tmp_path):
    async def body():
        server = CapacityServer(
            "fr-server", TrivialElection(), mode="batch",
            tick_interval=3600.0,  # ticks driven manually below
            minimum_refresh_interval=0.0,
            flightrec_capacity=16, flightrec_dir=str(tmp_path), device="cpu",
        )
        await server.start(0, host="127.0.0.1")
        await server.load_config(parse_yaml_config(CONFIG))
        await asyncio.sleep(0)
        from doorman_tpu_torch.algorithms import Request

        server._decide("r0", Request("c1", 0.0, 30.0, 1))
        await server.tick_once()
        await server.tick_once()

        recs = server.flightrec.snapshot()
        assert len(recs) == 2
        assert recs[-1]["tick"] == 2
        assert recs[-1]["wall_ms"] >= 0.0
        assert recs[-1]["resources"] == 1
        assert len(recs[-1]["digest"]) == 16
        assert recs[-1]["epoch"] >= 1  # TrivialElection's one flip

        st = server.status()
        assert st["flightrec"]["head_seq"] == 2
        assert st["flightrec"]["occupancy"] == 2
        assert st["slo"] is None  # not evaluated yet

        verdicts = {v["slo"]: v for v in server.evaluate_slos()}
        assert verdicts["tick_budget_p50_ms"]["status"] in (
            "pass", "fail"  # measured either way — never no_data
        )
        assert verdicts["top_band_goodput"]["status"] == "no_data"
        assert server.status()["slo"]["verdicts"]

        debug = DebugServer(host="127.0.0.1")
        debug.add_server(server, asyncio.get_running_loop())
        dport = debug.start()
        loop = asyncio.get_running_loop()

        status, page = await loop.run_in_executor(
            None, fetch, dport, "/debug"
        )
        assert "/debug/slo" in page and "/debug/flightrec" in page

        status, body_ = await loop.run_in_executor(
            None, fetch, dport, "/debug/slo?format=json"
        )
        assert status == 200
        slo_json = json.loads(body_)["fr-server"]
        assert {v["slo"] for v in slo_json["verdicts"]} >= {
            "tick_budget_p50_ms", "get_capacity_p99_ms"
        }

        status, body_ = await loop.run_in_executor(
            None, fetch, dport, "/debug/flightrec?format=json"
        )
        assert status == 200
        dump = json.loads(body_)["fr-server"]
        assert [r["tick"] for r in dump["records"]] == [1, 2]

        status, body_ = await loop.run_in_executor(
            None, fetch, dport, "/debug/flightrec?format=chrome"
        )
        assert status == 200
        assert json.loads(body_)["traceEvents"]

        for path in ("/debug/slo", "/debug/flightrec", "/debug/status"):
            status, page = await loop.run_in_executor(
                None, fetch, dport, path
            )
            assert status == 200, path
        # The status overview carries the satellite surfaces.
        _, page = await loop.run_in_executor(
            None, fetch, dport, "/debug/status"
        )
        assert "flight recorder: head seq" in page
        assert "last SLO verdict" in page

        debug.stop()
        await server.stop()

    asyncio.run(body())


def test_tick_exception_auto_dumps(tmp_path):
    async def body():
        server = CapacityServer(
            "fr-crash", TrivialElection(), mode="batch",
            tick_interval=3600.0, minimum_refresh_interval=0.0,
            flightrec_capacity=8, flightrec_dir=str(tmp_path), device="cpu",
        )
        await server.start(0, host="127.0.0.1")
        await server.load_config(parse_yaml_config(CONFIG))
        await asyncio.sleep(0)
        from doorman_tpu_torch.algorithms import Request

        server._decide("r0", Request("c1", 0.0, 30.0, 1))
        await server.tick_once()  # one healthy record

        async def boom():
            raise RuntimeError("device tunnel died")

        server._tick_once_locked = boom
        try:
            await server.tick_once()
            raise AssertionError("tick_once must re-raise")
        except RuntimeError:
            pass

        assert server.flightrec.last_dump["reason"] == "tick_exception"
        recs = server.flightrec.snapshot()
        assert "RuntimeError: device tunnel died" in recs[-1]["error"]
        dumped = [
            p for p in os.listdir(tmp_path)
            if "tick_exception" in p and p.endswith(".json")
            and not p.endswith(".trace.json")
        ]
        assert len(dumped) == 1
        on_disk = json.loads((tmp_path / dumped[0]).read_text())
        # The dump replays the healthy tick AND the failing one.
        assert len(on_disk["records"]) == 2
        await server.stop()

    asyncio.run(body())


def test_flightrec_disabled_is_clean():
    async def body():
        server = CapacityServer(
            "fr-off", TrivialElection(), mode="batch",
            tick_interval=3600.0, minimum_refresh_interval=0.0,
            flightrec_capacity=0, device="cpu",
        )
        await server.start(0, host="127.0.0.1")
        await server.load_config(parse_yaml_config(CONFIG))
        await asyncio.sleep(0)
        from doorman_tpu_torch.algorithms import Request

        server._decide("r0", Request("c1", 0.0, 30.0, 1))
        await server.tick_once()
        assert server.flightrec is None
        assert server.status()["flightrec"] is None
        # SLO evaluation still works; the tick stream is just absent.
        verdicts = {v["slo"]: v for v in server.evaluate_slos()}
        assert verdicts["tick_budget_p50_ms"]["status"] == "no_data"
        await server.stop()

    asyncio.run(body())
