"""The tree cell (`loadtest-tree5-1m.random_change_tree`): its
configuration states each cut with its source value, the layout places
the clients as it says, the cell runs at a test's size on the CPU
(sound, it is correct; with a fault under the timed path it is not), and
each new reader takes its spans from hand-built lists (a missing span
reads None)."""

import copy
import json
import subprocess
import sys

import numpy as np
import pytest

from portbench import harness
from portbench.gen import deploy
from portbench.layouts import tree

CELL = "loadtest-tree5-1m.random_change_tree"
READERS = ("parent_exchange_ms_per_tick", "server_capacity_ms_per_tick",
           "epoch_tick_ms", "tree_tick_ms_per_tick")
# loadtest-1m's readers the tree's runs feed too; the last two read the
# card's trace, which a run on the CPU lacks.
SHARED = ("tick_ms_p95", "unlapped_ms_per_tick", "ingest_ms_per_tick",
          "store_ms_per_tick", "engine_ms_per_tick", "k1_roofline",
          "device_idle_pct.tick")


def _entry():
    bench = harness.load_benchmark()
    (entry,) = [c for c in bench["configs"] if c["name"] == "loadtest-tree5-1m"]
    return bench, entry, harness.load_config(bench, entry["name"])


def test_configuration_states_each_cut_and_assumption():
    bench, entry, cfg = _entry()
    assert cfg["layout"] == "tree"
    assert set(entry["reduced"]) == set(cfg["source_values"])
    for key in entry["reduced"]:
        assert key in cfg, key
    assert {"placement_of_clients", "exchange_stagger"} <= set(cfg["assumed"])
    # The root loads the load test's templates as they stand, and every
    # server is loadtest-1m's (its parent aside).
    base = harness.load_config(bench, "loadtest-1m")
    assert cfg["templates"] == base["templates"]
    assert cfg["server"] == base["server"]
    assert cfg["resources"] * cfg["clients"] == 1_000_000
    (cell,) = [w for w in bench["workloads"] if w["name"] == CELL]
    assert cell["chips"] == 1 and cell["config"] == entry["name"]
    for name in READERS:
        (m,) = [m for m in bench["per_layer"] if m["name"] == name]
        assert m["workloads"] == [CELL] and m["moves"] == "refreshes_per_s"
    for name in SHARED:
        (m,) = [m for m in bench["per_layer"] if m["name"] == name]
        assert m["workloads"] == ["loadtest-1m.random_change", CELL]


def test_placement_spreads_each_resource_over_the_datacenters():
    _bench, _entry_, cfg = _entry()
    place = tree.placement(cfg)
    assert place.regions == ["region-0", "region-1", "region-2"]
    assert len(place.dcs) == 9 and place.dcs[4] == "dc-1.1"
    assert list(place.region_of_dc) == [0, 0, 0, 1, 1, 1, 2, 2, 2]
    assert [len(place.clients_of(d)) for d in range(9)] == [112] + [111] * 8
    assert set(place.clients_of(4)) == set(range(4, 1000, 9))
    with pytest.raises(ValueError):
        tree.placement(dict(cfg, clients_per_dc=[111] * 9))
    mix = {"recipe": {"function": "random_change", "base": 15.0,
                      "change": 5.0, "interval_s": 60.0}}
    dep = deploy.layout(cfg).build(dict(cfg, resources=3), mix, 7)
    assert dep.wants.shape == (3, 1000) and dep.place.dcs == place.dcs
    assert (dep.capacity == 5000.0).all() and (dep.kind == 2).all()


def _small(resources=6, clients=27):
    _bench, _entry_, cfg = _entry()
    templates = copy.deepcopy(cfg["templates"])
    for t in templates:
        t["capacity"] = t["capacity"] * clients / cfg["clients"]
    return {"resources": resources, "clients": clients,
            "templates": templates,
            "clients_per_dc": [len(range(d, clients, 9)) for d in range(9)]}


def _run(trace=False, seconds=1.0, seed=4_000_000_023):
    return harness.run_cell(CELL, seed, seconds, trace, t0=0.0, device="cpu",
                            config_over=_small())


def test_traced_run_on_the_cpu_reads_every_new_metric():
    out = _run(trace=True)
    assert out["correct"], out["check"]
    on_host = READERS + SHARED[:-2]
    assert set(on_host) <= set(out["metrics"]), out["metrics"]
    for name in on_host:
        assert out["metrics"][name]["value"] > 0, name
    # The laps lie within the ticks and the flush.
    phases = out["metrics"]["store_ms_per_tick"]["value"] + \
        out["metrics"]["engine_ms_per_tick"]["value"]
    assert phases < out["metrics"]["tree_tick_ms_per_tick"]["value"]
    diag = out["diag"]
    # 12 intermediates, each once every 5 iterations.
    assert abs(diag["exchanges"] - 12 * diag["iterations"] / 5) <= 12
    assert diag["solves"]["dc"]["full:config-epoch"] > 0
    json.dumps(out)


def _skip_exchanges(monkeypatch):
    from doorman_tpu_torch.server.server import CapacityServer

    async def no_exchange(self, retry_number):
        return 5.0, 0

    monkeypatch.setattr(CapacityServer, "_perform_parent_requests",
                        no_exchange)


def _halve_installs(monkeypatch):
    """Every intermediate installs half the capacity its parent granted."""
    from doorman_tpu_torch.server.server import CapacityServer

    load = CapacityServer.load_config

    async def halved(self, repo, expiry_times=None):
        if self.parent_addr and expiry_times:
            for t in repo.resources:
                if t.identifier_glob != "*":
                    t.capacity /= 2
        return await load(self, repo, expiry_times)

    monkeypatch.setattr(CapacityServer, "load_config", halved)


@pytest.mark.parametrize("fault", [_skip_exchanges, _halve_installs])
def test_fault_turns_correct_false(fault, monkeypatch):
    fault(monkeypatch)
    out = _run()
    assert not out["correct"], out["check"]


def _span(name, at_ms, ms, **args):
    return {"name": name, "t_s": at_ms / 1e3, "dur_s": ms / 1e3,
            "args": args}


def test_readers_on_hand_built_spans():
    run = {"ticks": 4, "dc_servers": ["dc-0.0", "dc-0.1"], "program_spans": [
        _span("server.parent_exchange", 0.0, 300.0, server="dc-0.0"),
        # The region's handler, inside the datacenter's exchange.
        _span("server.GetServerCapacity", 100.0, 60.0, server="region-0"),
        _span("server.parent_exchange", 400.0, 100.0, server="region-0"),
        # The root's handler, ending after the region's exchange.
        _span("server.GetServerCapacity", 450.0, 60.0, server="root"),
        _span("server.tick", 600.0, 10.0, server="dc-0.0",
              solve="full:config-epoch"),
        _span("server.tick", 610.0, 20.0, server="dc-0.1",
              solve="full:config-epoch"),
        _span("server.tick", 630.0, 5.0, server="dc-0.1", solve="scoped"),
        _span("server.tick", 635.0, 7.0, server="root",
              solve="full:config-epoch"),
    ]}
    read = {n: harness.load_metric(n).read for n in READERS}
    # (300 + 100 - 60) / 4: only the handler inside an exchange is left out.
    assert read["parent_exchange_ms_per_tick"](run) == pytest.approx(85.0)
    assert read["server_capacity_ms_per_tick"](run) == pytest.approx(30.0)
    # Only the datacenters' config-epoch ticks.
    assert read["epoch_tick_ms"](run) == pytest.approx(15.0)
    assert read["tree_tick_ms_per_tick"](run) == pytest.approx(10.5)
    # A run of a program without the spans, or an untraced one.
    quiet = dict(run, program_spans=[_span("server.tick", 0.0, 5.0,
                                           server="dc-0.0")])
    assert read["parent_exchange_ms_per_tick"](quiet) is None
    assert read["server_capacity_ms_per_tick"](quiet) is None
    assert read["epoch_tick_ms"](quiet) is None
    for name in READERS:
        assert read[name](dict(run, program_spans=None)) is None
        assert read[name]({}) is None


def test_tree_modules_load_nothing_forbidden():
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(harness.ROOT)!r})\n"
        "from portbench.reference import tree\n"
        "ref = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('doorman_tpu_torch', 'doorman_tpu'))\n"
        "from portbench import harness\n"
        "from portbench.cells import tree_refresh\n"
        "from portbench.layouts import tree as layout\n"
        "print(json.dumps([ref, harness.forbidden_modules()]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(harness.ROOT))
    assert out.returncode == 0, out.stderr
    ref, found = json.loads(out.stdout.strip().splitlines()[-1])
    assert ref == [] and found == []


def test_grant_gap_scales_by_each_datacenters_row():
    from portbench.reference import tree as ref_tree

    wants = np.array([[10.0, 20.0, 30.0, 40.0]])
    dc_of, region_of = np.array([0, 1, 0, 1]), np.array([0, 0])
    cap = np.array([50.0])
    ref = ref_tree.tree_grants(cap, wants, dc_of, region_of)
    # DC 0 holds 40 of the 100 wanted: the region grants it 20, DC 1 30.
    np.testing.assert_allclose(ref.region, [[20.0, 30.0]])
    held = ref_tree.as_held(ref)
    held.clients = ref.clients.copy()
    held.clients[0, 1] += 0.3  # DC 1's scale: max(30, 40)
    got = ref_tree.judge(held, ref, wants, cap, dc_of, region_of)
    assert got["grant_gap"] == pytest.approx(0.3 / 40.0)
    assert got["overgrant"] == pytest.approx(0.3 / 30.0)
    assert got["hop_gap"] == 0.0
