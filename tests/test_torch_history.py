"""The port's durable flight-record history
(doorman_tpu_torch/obs/history.py), the cases of tests/test_history.py
against the port: ring + decimated tiers, checksummed segments with
torn-tail tolerance, restart-spanning run deltas, the /debug/history
route, and the cmd.obs round trips.

The decimation-boundary and torn-tail tests are the contract pins:
bucket edges are exact (bucket b of factor F
covers hseq in [b*F, (b+1)*F), the partial tail stays pending), and a
half-written final line after a crash costs exactly the torn records —
never the segment, never the store.
"""

import asyncio
import json
import os
import urllib.request

import tests.conftest  # noqa: F401

from doorman_tpu_torch.obs.history import SEGMENT_PREFIX, HistoryStore


def mk(dir=None, **kw):
    kw.setdefault("ring", 64)
    kw.setdefault("tiers", (5,))
    kw.setdefault("clock", lambda: 1000.0)
    return HistoryStore(dir, **kw)


def segs(d):
    return sorted(
        n for n in os.listdir(d)
        if n.startswith(SEGMENT_PREFIX) and n.endswith(".log")
    )


# ---------------------------------------------------------------------
# in-memory: ring + tiers
# ---------------------------------------------------------------------


def test_append_stamps_hseq_and_run_and_ring_wraps():
    hs = mk(ring=4)
    for i in range(6):
        assert hs.append({"v": i}) == i + 1
    recs = hs.records()
    # Ring holds the most recent 4, each stamped with hseq and run.
    assert [r["v"] for r in recs] == [2, 3, 4, 5]
    assert [r["hseq"] for r in recs] == [3, 4, 5, 6]
    assert all(r["run"] == 1 for r in recs)
    assert hs.head_hseq == 6


def test_tier_bucket_boundaries_are_exact():
    """Bucket b of factor F aggregates exactly hseq in [b*F, (b+1)*F),
    and every aggregate matches a sequential host recomputation."""
    hs = mk(tiers=(5,))
    values = [float(i * i % 17) for i in range(23)]
    for v in values:
        hs.append({"v": v})
    by_hseq = {i + 1: values[i] for i in range(len(values))}
    buckets = hs.records(tier=5)
    # hseq runs 1..23: bucket starts 0 (hseq 1-4), 5, 10, 15 are
    # finalized; the partial tail (hseq 20-23) stays pending.
    assert [b["hseq"] for b in buckets] == [0, 5, 10, 15]
    for b in buckets:
        members = [
            by_hseq[h]
            for h in range(b["hseq"], b["hseq"] + 5)
            if h in by_hseq
        ]
        assert b["n"] == len(members)
        f = b["fields"]["v"]
        assert f["min"] == min(members)
        assert f["max"] == max(members)
        assert f["last"] == members[-1]
        # Sequential sum/n — the same association order _TierBucket
        # accumulated in, so equality is exact, not approximate.
        acc = 0.0
        for m in members:
            acc += m
        assert f["mean"] == acc / len(members)


def test_partial_tail_emits_only_when_next_bucket_opens():
    hs = mk(tiers=(5,))
    for i in range(9):  # hseq 1..9: bucket 0 complete, bucket 5 partial
        hs.append({"v": float(i)})
    assert [b["hseq"] for b in hs.records(tier=5)] == [0]
    hs.append({"v": 9.0})  # hseq 10 opens bucket 10 -> bucket 5 emits
    assert [b["hseq"] for b in hs.records(tier=5)] == [0, 5]


def test_records_range_and_projection():
    hs = mk()
    for i in range(10):
        hs.append({"v": i, "w": -i})
    rows = hs.records(start=4, end=6, fields=["v"])
    assert [r["hseq"] for r in rows] == [4, 5, 6]
    assert all(set(r) == {"hseq", "run", "v"} for r in rows)


def test_series_reads_raw_and_tier_aggregates():
    hs = mk(tiers=(5,))
    for i in range(10):
        hs.append({"v": float(i)})
    assert hs.series("v") == [float(i) for i in range(10)]
    # hseq starts at 1: bucket 0 covers hseq 1-4 (values 0..3), bucket 5
    # covers hseq 5-9 (values 4..8); the tail (hseq 10) stays pending.
    assert hs.series("v", tier=5, agg="max") == [3.0, 8.0]
    assert hs.series("v", tier=5, agg="mean") == [1.5, 6.0]
    assert hs.series("missing") == []


# ---------------------------------------------------------------------
# durability: segments, torn tails, runs
# ---------------------------------------------------------------------


def test_reopen_replays_and_bumps_run(tmp_path):
    d = str(tmp_path)
    hs = mk(d)
    for i in range(5):
        hs.append({"v": i})
    hs.close()
    again = mk(d)
    assert [r["v"] for r in again.records()] == [0, 1, 2, 3, 4]
    assert again.run == 2
    assert again.head_hseq == 5
    # Appends continue the hseq line in a FRESH segment (a torn tail
    # is never appended to).
    before = segs(d)
    again.append({"v": 5})
    assert again.records()[-1]["hseq"] == 6
    assert len(segs(d)) == len(before) + 1
    again.close()


def test_torn_tail_costs_only_the_torn_record(tmp_path):
    d = str(tmp_path)
    hs = mk(d)
    for i in range(5):
        hs.append({"v": i})
    hs.close()
    path = os.path.join(d, segs(d)[0])
    lines = open(path, "rb").readlines()
    # A crash mid-write: the final line is half there.
    with open(path, "wb") as f:
        f.writelines(lines[:-1])
        f.write(lines[-1][: len(lines[-1]) // 2])
    again = mk(d)
    assert [r["v"] for r in again.records()] == [0, 1, 2, 3]
    assert again.run == 2
    again.close()


def test_corruption_stops_replay_of_that_segment_only(tmp_path):
    d = str(tmp_path)
    hs = mk(d)
    for i in range(3):
        hs.append({"v": i})
    hs.close()
    # Run 2 writes its own segment.
    hs2 = mk(d)
    hs2.append({"v": 100})
    hs2.close()
    first, second = segs(d)[:2]
    path = os.path.join(d, first)
    lines = open(path, "rb").readlines()
    lines[1] = b"xxxxxxxx corrupted-line\n"  # bit rot mid-segment
    open(path, "wb").writelines(lines)
    again = mk(d)
    # Segment 1 replays only up to the corruption; segment 2 is intact.
    assert [r["v"] for r in again.records()] == [0, 100]
    assert again.run == 3
    again.close()


def test_segment_rotation_and_retention(tmp_path):
    d = str(tmp_path)
    hs = mk(d, segment_records=2, max_segments=2)
    for i in range(12):
        hs.append({"v": i})
    hs.close()
    assert len(segs(d)) <= 3  # cap + the in-progress segment


def test_run_delta_spans_restarts(tmp_path):
    d = str(tmp_path)
    hs = mk(d)
    for _ in range(5):
        hs.append({"wall_ms": 10.0})
    assert hs.run_delta("wall_ms") is None  # one run: no delta yet
    hs.close()
    again = mk(d)
    for _ in range(5):
        again.append({"wall_ms": 20.0})
    delta = again.run_delta("wall_ms")
    assert delta is not None
    assert delta["run"] == 2 and delta["previous_run"] == 1
    assert delta["current"] == 20.0 and delta["previous"] == 10.0
    assert delta["delta"] == 10.0 and delta["ratio"] == 2.0
    assert delta["samples"] == 5 and delta["previous_samples"] == 5
    again.close()


def test_runs_and_status(tmp_path):
    d = str(tmp_path)
    hs = mk(d)
    hs.append({"v": 1})
    hs.close()
    again = mk(d)
    again.append({"v": 2})
    assert again.runs() == [1, 2]
    st = again.status()
    assert st["run"] == 2 and st["segments"] == 2
    assert st["ring"] == 2 and st["head_hseq"] == 2
    again.close()


def test_append_never_raises_on_disk_trouble(tmp_path):
    d = str(tmp_path)
    hs = mk(d)
    hs.append({"v": 1})
    # Yank the directory out from under the store: the tick loop's
    # appends must keep working in-memory.
    hs.close()
    for n in segs(d):
        os.remove(os.path.join(d, n))
    os.rmdir(d)
    assert hs.append({"v": 2}) == 2
    assert [r["v"] for r in hs.records()] == [1, 2]


# ---------------------------------------------------------------------
# export surfaces
# ---------------------------------------------------------------------


def test_view_and_chrome_export():
    hs = mk()
    for i in range(3):
        hs.append({"v": i, "wall_ms": 1.0 + i})
    view = hs.view(fields=["v"])
    assert view["run"] == 1 and view["tier"] == 0
    assert [r["v"] for r in view["records"]] == [0, 1, 2]
    trace = json.loads(hs.chrome())
    assert trace["traceEvents"], "chrome export is empty"


# ---------------------------------------------------------------------
# cmd.obs round trips
# ---------------------------------------------------------------------


def _obs(args_list, out_path):
    from doorman_tpu_torch.cmd.obs import make_parser, run

    args = make_parser().parse_args(args_list + ["--out", str(out_path)])
    rc = run(args)
    return rc, out_path.read_text() if out_path.exists() else ""


def test_cmd_obs_round_trips(tmp_path):
    d = str(tmp_path / "hist")
    hs = mk(d)
    for i in range(7):
        hs.append({"wall_ms": 5.0 + i, "tick": i})
    hs.close()
    hs2 = mk(d)
    for i in range(7):
        hs2.append({"wall_ms": 9.0 + i, "tick": i})
    hs2.close()

    rc, text = _obs(["status", "--history-dir", d], tmp_path / "s.json")
    assert rc == 0
    st = json.loads(text)
    assert st["runs"] == [1, 2] and st["segments"] == 2

    rc, text = _obs(
        ["query", "--history-dir", d, "--start", "3", "--end", "5",
         "--field", "wall_ms"],
        tmp_path / "q.json",
    )
    assert rc == 0
    view = json.loads(text)
    assert [r["hseq"] for r in view["records"]] == [3, 4, 5]
    assert all("wall_ms" in r for r in view["records"])

    rc, text = _obs(
        ["delta", "--history-dir", d, "--field", "wall_ms"],
        tmp_path / "d.json",
    )
    assert rc == 0
    delta = json.loads(text)
    assert delta["run"] == 2 and delta["previous_run"] == 1
    assert delta["delta"] == 4.0

    rc, text = _obs(["export", "--history-dir", d], tmp_path / "t.json")
    assert rc == 0
    assert json.loads(text)["traceEvents"]

    rc, text = _obs(
        ["detect", "--history-dir", d, "--field", "wall_ms"],
        tmp_path / "a.json",
    )
    assert rc == 0
    report = json.loads(text)
    assert set(report) == {"anomalies", "detections", "per_field"}


def test_cmd_obs_delta_needs_two_runs(tmp_path):
    d = str(tmp_path / "hist")
    hs = mk(d)
    hs.append({"wall_ms": 5.0})
    hs.close()
    rc, text = _obs(
        ["delta", "--history-dir", d, "--field", "wall_ms"],
        tmp_path / "d.json",
    )
    assert rc == 1
    assert "error" in json.loads(text)


# ---------------------------------------------------------------------
# the live server: /debug/history and restart-spanning SLO windows
# ---------------------------------------------------------------------

CONFIG = """
resources:
- identifier_glob: "*"
  capacity: 100
  algorithm: {kind: FAIR_SHARE, lease_length: 60, refresh_interval: 1,
              learning_mode_duration: 0}
"""


def _fetch(port, path):
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}{path}", timeout=5
    ) as resp:
        return resp.status, resp.read().decode()


async def _run_server_ticks(history_dir, ticks, *, debug_probe=None):
    from doorman_tpu_torch.server.config import parse_yaml_config
    from doorman_tpu_torch.server.election import TrivialElection
    from doorman_tpu_torch.server.server import CapacityServer

    server = CapacityServer(
        "hist-server", TrivialElection(), mode="batch",
        minimum_refresh_interval=0.0, history_dir=history_dir,
        audit_sample=2, audit_inline=True, detect=True, device="cpu",
    )
    port = await server.start(0, host="127.0.0.1")
    await server.load_config(parse_yaml_config(CONFIG))
    await asyncio.sleep(0)
    from doorman_tpu_torch.client import Client

    client = await Client.connect(
        f"127.0.0.1:{port}", "client-1", minimum_refresh_interval=0.0
    )
    await client.resource("r0", wants=40)
    for _ in range(ticks):
        await server.tick_once()
        await client.refresh_once()
    out = {}
    if debug_probe is not None:
        out = await debug_probe(server)
    verdicts = server.evaluate_slos()
    samples = len(server.history.series("wall_ms"))
    run = server.history.run
    delta = server.history.run_delta("wall_ms")
    await client.close()
    await server.stop()
    return {
        "verdicts": verdicts,
        "samples": samples,
        "run": run,
        "delta": delta,
        **out,
    }


def test_server_history_survives_restart_and_feeds_slos(tmp_path):
    d = str(tmp_path / "server-hist")
    first = asyncio.run(_run_server_ticks(d, 6))
    assert first["run"] == 1 and first["samples"] >= 6
    assert first["delta"] is None
    second = asyncio.run(_run_server_ticks(d, 6))
    # Generation 2 sees both lifetimes: the SLO window and the
    # trajectory delta span the restart.
    assert second["run"] == 2
    # The window holds run 1's samples PLUS this generation's: strictly
    # more than either lifetime alone could supply.
    assert second["samples"] >= first["samples"] + 6
    assert second["delta"] is not None
    assert second["delta"]["run"] == 2
    assert second["delta"]["previous_run"] == 1
    # The audit gate rode along and stayed clean.
    by_name = {v["slo"]: v for v in second["verdicts"]}
    assert by_name["audit_divergence"]["status"] == "pass"
    assert by_name["detector_anomalies"]["status"] in ("pass", "fail")


def test_debug_history_route(tmp_path):
    from doorman_tpu_torch.obs import DebugServer, Registry

    async def probe(server):
        debug = DebugServer(host="127.0.0.1", registry=Registry())
        debug.add_server(server, asyncio.get_running_loop())
        dport = debug.start()
        loop = asyncio.get_running_loop()
        try:
            status, text = await loop.run_in_executor(
                None, _fetch, dport, "/debug/history?format=json"
            )
            assert status == 200
            body = json.loads(text)
            view = body["hist-server"]
            assert view["run"] == 1
            assert len(view["records"]) == 4
            assert all("wall_ms" in r for r in view["records"])

            status, text = await loop.run_in_executor(
                None, _fetch, dport,
                "/debug/history?format=json&start=2&end=3",
            )
            assert [
                r["hseq"] for r in json.loads(text)["hist-server"]["records"]
            ] == [2, 3]

            status, text = await loop.run_in_executor(
                None, _fetch, dport, "/debug/history?format=chrome"
            )
            assert status == 200 and json.loads(text)["traceEvents"]

            status, text = await loop.run_in_executor(
                None, _fetch, dport, "/debug/history"
            )
            assert status == 200 and "hist-server" in text
        finally:
            debug.stop()
        return {}

    asyncio.run(_run_server_ticks(str(tmp_path / "h"), 4, debug_probe=probe))
