"""The capacity tree at scale on the port (the benchmark's
`loadtest-tree5-1m` cell, upstream's scenario-five tree: a root, three
regions, nine datacenters), here at 12 resources of 27 clients on the
CPU:

  * the tree driven the cell's way (portbench/cells/tree_refresh.py:
    refreshes on the datacenters, staggered parent exchanges, the
    regions' and the root's ticks, the demand then held still) holds
    portbench/reference/tree.py's grants within the cell's limits, at
    f32 and f64, and the reference in bfloat16 put in its place fails
    every limit;
  * the reference's three-level split equals the flat proportional
    share when every level is oversubscribed, and grants every client
    its wants when the demand fits;
  * `start(updater_loop=False)` leaves the exchanges to the caller;
  * the exchange's spans (`server.parent_exchange` over
    `server.band_aggregate`, `server.parent_refresh` and
    `server.parent_install`), the serving side's `lines` / `bands`, the
    tick's `solve`, and the counters of exchanges and bands.
"""

import asyncio
import copy
import time

import grpc
import numpy as np
import pytest
import torch

import tests._torch_threads  # noqa: F401

from doorman_tpu_torch import native
from doorman_tpu_torch.algorithms import Request
from doorman_tpu_torch.obs import metrics as metrics_mod
from doorman_tpu_torch.obs import trace as trace_mod
from doorman_tpu_torch.proto import doorman_pb2 as pb
from doorman_tpu_torch.proto.grpc_api import (
    CapacityServicer,
    add_capacity_servicer,
)
from doorman_tpu_torch.server.config import parse_yaml_config
from doorman_tpu_torch.server.election import TrivialElection
from doorman_tpu_torch.server.server import CapacityServer

from portbench import harness
from portbench.reference import tree as ref_tree

CELL = "loadtest-tree5-1m.random_change_tree"
RESOURCES, CLIENTS = 12, 27

needs_native = pytest.mark.skipif(
    not native.native_available(), reason="native engine unavailable"
)


def _small(dtype):
    """The cell's configuration at RESOURCES x CLIENTS (3 clients on each
    datacenter), each capacity cut with its clients so that demand still
    runs at three times the capacity."""
    cfg = harness.load_config(harness.load_benchmark(), "loadtest-tree5-1m")
    templates = copy.deepcopy(cfg["templates"])
    for t in templates:
        t["capacity"] = t["capacity"] * CLIENTS / cfg["clients"]
    return {"resources": RESOURCES, "clients": CLIENTS,
            "templates": templates, "clients_per_dc": [3] * 9,
            "server": {"solver_dtype": dtype}}


@needs_native
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_tree_holds_the_references_grants_and_the_control_does_not(dtype):
    out = harness.run_cell(CELL, 4_000_000_021, 1.0, False, t0=0.0,
                           device="cpu", config_over=_small(dtype),
                           control=True)
    check = out["check"]
    assert out["correct"], check
    assert check["leases_off"]["value"] == 0
    assert set(check) == {"leases_off", "grant_gap", "hop_gap", "overgrant"}
    diag = out["diag"]
    assert diag["exchanges"] > 0 and diag["exchange_failures"] == 0
    assert diag["solves"]["dc"].get("full:config-epoch", 0) > 0
    assert diag["bands_served"] > 0
    # Every limit caught by the control, each on its own.
    for name, value in out["control"].items():
        assert value > check[name]["limit"], (name, out["control"])


def _flat(capacity, wants):
    return wants * (capacity / wants.sum(1))[:, None]


def test_three_levels_split_as_one_when_every_level_is_oversubscribed():
    rng = np.random.default_rng(5)
    R, C = 20, 45
    wants = 15.0 + 5.0 * rng.uniform(-1.0, 1.0, (R, C))
    cap = np.full(R, 5000.0 * C / 1000.0)
    dc_of, region_of = np.arange(C) % 9, np.arange(9) // 3
    got = ref_tree.tree_grants(cap, wants, dc_of, region_of)
    np.testing.assert_allclose(got.clients, _flat(cap, wants), rtol=1e-12)
    np.testing.assert_allclose(got.root.sum(1), cap, rtol=1e-12)
    np.testing.assert_allclose(got.region.sum(1), cap, rtol=1e-12)
    # Demand that fits at the root fits at every level: every client is
    # granted its wants.
    fits = ref_tree.tree_grants(wants.sum(1) * 1.5, wants, dc_of, region_of)
    np.testing.assert_allclose(fits.clients, wants, rtol=1e-12)
    np.testing.assert_allclose(fits.root, fits.region_wants, rtol=1e-12)


def test_bfloat16_reference_moves_every_number():
    rng = np.random.default_rng(6)
    wants = 15.0 + 5.0 * rng.uniform(-1.0, 1.0, (8, 1000))
    cap = np.full(8, 5000.0)
    dc_of, region_of = np.arange(1000) % 9, np.arange(9) // 3
    ref = ref_tree.tree_grants(cap, wants, dc_of, region_of)
    low = ref_tree.tree_grants(cap, wants, dc_of, region_of,
                               dtype=torch.bfloat16)
    same = ref_tree.judge(ref_tree.as_held(ref), ref, wants, cap, dc_of,
                          region_of)
    assert same["grant_gap"] == same["hop_gap"] == 0.0
    assert same["overgrant"] < 1e-12
    moved = ref_tree.judge(ref_tree.as_held(low), ref, wants, cap, dc_of,
                           region_of)
    assert min(moved.values()) > 1e-4, moved


# ----------------------------------------------------------------------
# The updater switch, the exchange's spans and counters
# ----------------------------------------------------------------------


class Parent(CapacityServicer):
    """Grants every requested resource 10 (mode "ok"), only the first one
    ("partial"), aborts the RPC ("fail"), or answers an algorithm the
    config validation refuses ("bad")."""

    def __init__(self):
        self.mode = "ok"
        self.requests = 0

    async def GetServerCapacity(self, request, context):
        self.requests += 1
        if self.mode == "fail":
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, "refused")
        out = pb.GetServerCapacityResponse()
        granted = request.resource
        if self.mode == "partial":
            granted = granted[:1]
        for r in granted:
            pr = out.response.add(resource_id=r.resource_id)
            pr.gets.capacity = 10.0
            pr.gets.expiry_time = 2_000_000_000
            pr.gets.refresh_interval = 5
            pr.algorithm.kind = pb.Algorithm.PROPORTIONAL_SHARE
            pr.algorithm.lease_length = 1 if self.mode == "bad" else 60
            pr.algorithm.refresh_interval = 5
        return out


async def _parent():
    stub = Parent()
    server = grpc.aio.server()
    add_capacity_servicer(server, stub)
    port = server.add_insecure_port("127.0.0.1:0")
    await server.start()
    return stub, server, f"127.0.0.1:{port}"


async def _intermediate(addr, updater_loop=True, **kw):
    mid = CapacityServer("mid", TrivialElection(), parent_addr=addr,
                         minimum_refresh_interval=0.0, device="cpu", **kw)
    await mid.start(0, host="127.0.0.1", updater_loop=updater_loop)
    mid.became_master_at -= 3600.0
    for rid, wants in (("a", 30.0), ("b", 12.0)):
        mid._decide(rid, Request("c1", 0.0, wants, 1))
    return mid


@pytest.mark.parametrize("updater_loop", [True, False])
def test_updater_loop_switch(updater_loop):
    """The updater's first exchange comes a second after start; without
    it the intermediate never calls its parent on its own."""

    async def body():
        stub, parent, addr = await _parent()
        mid = await _intermediate(addr, updater_loop=updater_loop)
        try:
            # The updater's first exchange comes DEFAULT_INTERVAL (1 s)
            # after start: wait past it, and longer for it to land.
            deadline = time.monotonic() + (10.0 if updater_loop else 1.6)
            while time.monotonic() < deadline and not stub.requests:
                await asyncio.sleep(0.05)
            seen = stub.requests
            assert mid.config is not None  # the default template loaded
            if not updater_loop:
                assert await mid._perform_parent_requests(0) == (5.0, 0)
            return seen, mid.resources["a"].capacity
        finally:
            await mid.stop()
            await parent.stop(None)

    seen, capacity = asyncio.run(body())
    assert (seen > 0) is updater_loop
    assert capacity == 10.0


@pytest.fixture
def tracer():
    """The process-global tracer, enabled for the test and restored
    after."""
    tr = trace_mod.default_tracer()
    tr.clear()
    tr.enable()
    yield tr
    tr.disable()
    tr.clear()


def _exchanges(outcome):
    return metrics_mod.default_registry().counter(
        "doorman_server_parent_exchanges",
        labels=("server", "outcome")).value("mid", outcome)


@pytest.mark.parametrize("mode,outcome", [
    ("ok", "ok"), ("partial", "ok"), ("fail", "rpc_error"),
    ("bad", "config_error")])
def test_exchange_spans_and_counter(tracer, mode, outcome):
    before = _exchanges(outcome)

    async def body():
        stub, parent, addr = await _parent()
        stub.mode = mode
        mid = await _intermediate(addr, updater_loop=False)
        try:
            return await mid._perform_parent_requests(0)
        finally:
            await mid.stop()
            await parent.stop(None)

    _interval, retry = asyncio.run(body())
    assert (retry == 0) is (outcome == "ok")
    spans = {e.name: e for e in tracer.snapshot() if e.ph == "X"}
    top = spans["server.parent_exchange"]
    assert top.args["outcome"] == outcome and top.args["server"] == "mid"
    agg = spans["server.band_aggregate"]
    assert agg.args["resources"] == 2 and agg.args["bands"] == 2
    refresh = spans["server.parent_refresh"]
    for child in (agg, refresh):
        assert child.parent_id == top.span_id
    if mode == "fail":
        assert "server.parent_install" not in spans
    else:
        install = spans["server.parent_install"]
        assert install.parent_id == top.span_id
        # The granted resources' templates and the default "*".
        granted = 1 if mode == "partial" else 2
        assert install.args["templates"] == granted + 1
        assert ("error" in install.args) is (mode == "bad")
        if mode != "bad":
            # A granted resource takes its own template by exact id; the
            # one left out falls to the "*" glob.
            assert install.args["exact"] == granted
            assert install.args["globbed"] == 2 - granted
    assert tracer.open_spans() == []
    assert _exchanges(outcome) == before + 1


ROOT_CONFIG = """
resources:
- identifier_glob: "*"
  capacity: 100
  algorithm: {kind: PROPORTIONAL_SHARE, lease_length: 60, refresh_interval: 5,
              learning_mode_duration: 0}
"""


@needs_native
def test_serving_side_and_tick_spans_name_their_work(tracer):
    """A batch root on the native store serving an intermediate: the
    handler span counts the request's lines and the bands it decided
    (and the registry too), under the intermediate's RPC span; each
    tick names its solve as its flight record does (none before the
    engine has landed a tick)."""
    bands0 = metrics_mod.default_registry().counter(
        "doorman_server_capacity_bands", labels=("server",)).value("root")

    async def body():
        root = CapacityServer("root", TrivialElection(), mode="batch",
                              native_store=True, device="cpu",
                              minimum_refresh_interval=0.0)
        port = await root.start(0, host="127.0.0.1", tick_loop=False)
        await root.load_config(parse_yaml_config(ROOT_CONFIG))
        mid = await _intermediate(f"127.0.0.1:{port}", updater_loop=False,
                                  mode="batch", native_store=True)
        try:
            await mid.tick_once()
            await mid.tick_once()
            await mid._perform_parent_requests(0)
            await root.tick_once()
            await mid.tick_once()
        finally:
            await mid.stop()
            await root.stop()
        return {s.id: [r.get("solve_mode") for r in s.flightrec.snapshot()]
                for s in (root, mid)}

    recorded = asyncio.run(body())
    spans = [e for e in tracer.snapshot() if e.ph == "X"]
    (serve,) = [e for e in spans if e.name == "server.GetServerCapacity"]
    assert serve.args["lines"] == 2 and serve.args["bands"] == 2
    (refresh,) = [e for e in spans if e.name == "server.parent_refresh"]
    assert serve.parent_id == refresh.span_id
    bands = metrics_mod.default_registry().counter(
        "doorman_server_capacity_bands", labels=("server",)).value("root")
    assert bands == bands0 + 2
    solves = [(e.args["server"], e.args["solve"]) for e in spans
              if e.name == "server.tick"]
    assert solves == [("mid", None), ("mid", "scoped"), ("root", None),
                      ("mid", "full:config-epoch")]
    for sid, modes in recorded.items():
        assert modes == [m for s, m in solves if s == sid]
    assert tracer.open_spans() == []
