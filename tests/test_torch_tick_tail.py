"""The unmeshed resident tick: the port's one tick tail run as a
one-shard mesh (device="cpu", K1's plain version).

An unmeshed solver keeps the accounting of a single-device tick:

  * each tick laps the same phases in the same order — sweep, (rebuild),
    drain, config, pack, staging, then "fused" on a fused tick or
    "upload" and "solve" on a round-trip tick; collect laps download,
    apply and, with delta tracking, delta;
  * a fused tick places one staged buffer, launches once and lands one
    slab; a round-trip tick places each staged block on its own;
  * the store contents tick for tick, the delivery set, the scope and
    the solve mode are pinned by a digest per tick;
  * no per-shard accounting: no shard byte gauges, no shard trace
    instants, no shard bytes in the flight record, and `mesh` is None.

The staging's bf16 wire-format test (engine.bf16_exact) is held to a
torch round trip and to the JAX package's predicate.
"""

import asyncio
import hashlib

import numpy as np
import pytest

import tests.conftest  # noqa: F401

from doorman_tpu_torch import native as tnative
from doorman_tpu_torch.core.resource import Resource as TResource
from doorman_tpu_torch.obs import phases as phases_mod
from doorman_tpu_torch.solver.resident import ResidentDenseSolver
from doorman_tpu_torch.solver.resident_wide import WideResidentSolver
from doorman_tpu_torch.utils import dispatch as dispatch_mod
from tests.test_engine import conformance_churn
from tests.test_torch_resident import all_leases
from tests.test_torch_resident import make_world as narrow_world
from tests.test_torch_resident_wide import make_world as wide_world

pytestmark = pytest.mark.skipif(
    not tnative.native_available(), reason="native engine unavailable"
)

HEAD = ["sweep", "drain", "config", "pack", "staging"]
FUSED = HEAD + ["fused"]
ROUND = HEAD + ["upload", "solve"]
REBUILD = ["sweep", "rebuild"]


def _solver(kind, engine, clock, fused, scoped):
    make = dict(dtype=np.float64, clock=clock, rotate_ticks=2, fused=fused,
                scoped=scoped, device="cpu")
    if kind == "wide":
        return WideResidentSolver(engine, chunk_width=8, **make)
    solver = ResidentDenseSolver(engine, **make)
    if kind == "narrow-tracked":
        solver.enable_delta_tracking()
    return solver


def _digest(solver, resources):
    """The tick's visible outcome: every lease, the solve mode, the
    scope and the fused-window tallies."""
    leases = sorted(all_leases(resources).items())
    blob = repr((leases, solver.last_solve_mode, solver.last_full_reason,
                 sorted(solver.last_scope.items()),
                 sorted(solver.last_fused.items())))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _run_ticks(kind, fused, scoped, monkeypatch):
    """Six ticks of the shared churn stream (a config epoch bump on the
    fourth): per tick (dispatch laps, dispatch counter deltas, collect
    laps, collect counter deltas, digest)."""
    laps = []
    real_lap = phases_mod.PhaseRecorder.lap

    def lap(self, phase):
        laps.append(phase)
        return real_lap(self, phase)

    monkeypatch.setattr(phases_mod.PhaseRecorder, "lap", lap)
    t = [1000.0]
    clock = lambda: t[0]  # noqa: E731
    if kind == "wide":
        engine, res = wide_world(clock)
    else:
        engine, res = narrow_world(clock, tnative, TResource)
    solver = _solver(kind, engine, clock, fused, scoped)
    rng = np.random.default_rng(5)
    ticks = []
    for step in range(6):
        conformance_churn(res, step, rng)
        epoch = 1 if step >= 3 else 0
        laps.clear()
        before = dispatch_mod.snapshot()
        handle = solver.dispatch(res, epoch)
        d_disp = dispatch_mod.delta(before)
        d_laps = list(laps)
        laps.clear()
        before = dispatch_mod.snapshot()
        solver.collect(handle)
        c_disp = dispatch_mod.delta(before)
        ticks.append((d_laps, (d_disp["dispatches"], d_disp["host_syncs"]),
                      list(laps), (c_disp["dispatches"], c_disp["host_syncs"]),
                      _digest(solver, res)))
        t[0] += 1.0
    return solver, ticks


# The single-device tails' accounting, tick by tick: the first tick
# rebuilds (it places every table and config column), and every tick's
# collect lands one slab. Dispatches of the first tick and of the rest.
DISPATCHES = {
    ("narrow", True): (10, 2), ("narrow", False): (13, 5),
    ("narrow-tracked", True): (11, 2), ("narrow-tracked", False): (14, 5),
    ("wide", True): (12, 2), ("wide", False): (19, 9),
}


def _expected(kind, fused):
    tail = FUSED if fused else ROUND
    collect = ["download", "apply"] + (
        ["delta"] if kind == "narrow-tracked" else [])
    first, rest = DISPATCHES[(kind, fused)]
    return [(REBUILD + tail[1:] if i == 0 else tail,
             (first if i == 0 else rest, 0), collect, (0, 1))
            for i in range(6)]


# Each tick's `_digest`.
DIGESTS = {
    ('narrow', True, True): (
        '24d9436e6e9ddedf', 'c99408f47c2dceaa', '7a8a67f8c9b006fc',
        '57a0e06832bdb64b', 'c249eeafe63f383e', '33e3c5e243ffff8d',
    ),
    ('narrow', True, False): (
        '2cfbe0a10cd235ca', '88f70d2615875c6f', 'c9a65b19fbf86349',
        '4437a8167d278a4a', 'f934b67050dd7c93', 'c54188c09444fa5f',
    ),
    ('narrow', False, True): (
        '7914a23f2c92a08a', 'e6050e37008309dc', '05e5a8abb6384a94',
        'f0511e553f9b1ba5', 'eaadbdd0308e218d', 'b712d1f016ab032b',
    ),
    ('narrow', False, False): (
        '2cfbe0a10cd235ca', '88f70d2615875c6f', 'c9a65b19fbf86349',
        '4437a8167d278a4a', 'f934b67050dd7c93', 'c54188c09444fa5f',
    ),
    ('narrow-tracked', True, True): (
        '24d9436e6e9ddedf', 'c99408f47c2dceaa', '7a8a67f8c9b006fc',
        '57a0e06832bdb64b', 'c249eeafe63f383e', '33e3c5e243ffff8d',
    ),
    ('narrow-tracked', True, False): (
        '2cfbe0a10cd235ca', '88f70d2615875c6f', 'c9a65b19fbf86349',
        '4437a8167d278a4a', 'f934b67050dd7c93', 'c54188c09444fa5f',
    ),
    ('narrow-tracked', False, True): (
        '7914a23f2c92a08a', 'e6050e37008309dc', '05e5a8abb6384a94',
        'f0511e553f9b1ba5', 'eaadbdd0308e218d', 'b712d1f016ab032b',
    ),
    ('narrow-tracked', False, False): (
        '2cfbe0a10cd235ca', '88f70d2615875c6f', 'c9a65b19fbf86349',
        '4437a8167d278a4a', 'f934b67050dd7c93', 'c54188c09444fa5f',
    ),
    ('wide', True, True): (
        '352257e59f4c9e06', '1afd683b79f8ed4d', '5c6198144cf3965b',
        'c7c164b9a7d8f6ab', '46a4329635fa2ec2', 'acc1a77b259c72f4',
    ),
    ('wide', True, False): (
        'f525209d8bcee974', '2926434038855102', 'c29e36d635519174',
        '2a186b1cdfdcfe66', '6161945e6bb5303c', 'df219f54e7adb672',
    ),
    ('wide', False, True): (
        'cb5590bfd4a3d9b0', '4c64f0f788dddbf5', 'c1f4e13d817caa4c',
        'b721f5f938784d14', '9c19bd95538033f0', 'ead60df96d2ca8cd',
    ),
    ('wide', False, False): (
        'f525209d8bcee974', '2926434038855102', 'c29e36d635519174',
        '2a186b1cdfdcfe66', '6161945e6bb5303c', 'df219f54e7adb672',
    ),
}


@pytest.mark.parametrize("scoped", [True, False], ids=["scoped", "full"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "round-trip"])
@pytest.mark.parametrize("kind", ["narrow", "narrow-tracked", "wide"])
def test_unmeshed_tick_laps_and_dispatches(kind, fused, scoped,
                                           monkeypatch):
    solver, ticks = _run_ticks(kind, fused, scoped, monkeypatch)
    assert [tick[:4] for tick in ticks] == _expected(kind, fused)
    assert tuple(tick[4] for tick in ticks) == DIGESTS[(kind, fused, scoped)]
    assert solver.mesh is None
    if fused and scoped:
        assert solver.solve_modes["scoped"] >= 2
    else:
        assert solver.solve_modes["scoped"] == 0


def _shard_gauges():
    """Every shard byte and skew gauge a resident solver could set."""
    per, skew = phases_mod._shard_metrics()
    comps = ("resident", "resident_wide")
    dirs = ("upload", "download")
    return (
        {(c, d, str(s)): per.value(c, d, str(s))
         for c in comps for d in dirs for s in range(8)},
        {(c, d): skew.value(c, d) for c in comps for d in dirs},
    )


@pytest.mark.parametrize("kind", ["narrow", "wide"])
def test_unmeshed_solver_publishes_no_shard_series(kind, monkeypatch):
    """Unmeshed ticks (scoped, full and round-trip) leave the shard byte
    gauges, the shard trace instants and the flight record's shard bytes
    as they were; `mesh` stays None and no per-shard launch tally
    exists."""
    from doorman_tpu_torch.obs import trace as trace_mod

    monkeypatch.setattr(phases_mod, "_last_shard_bytes", {})
    before = _shard_gauges()
    tracer = trace_mod.default_tracer()
    was_enabled = tracer.enabled
    tracer.enable()
    tracer.clear()
    try:
        for fused in (True, False):
            _run_ticks(kind, fused, True, monkeypatch)
        names = {s.name for s in tracer.snapshot()}
    finally:
        if not was_enabled:
            tracer.disable()
    assert not any(n.startswith("shard.") for n in names), names
    assert phases_mod.last_shard_bytes() == {}
    assert _shard_gauges() == before
    t = [1000.0]
    engine, res = (wide_world(lambda: t[0]) if kind == "wide"
                   else narrow_world(lambda: t[0], tnative, TResource))
    solver = _solver(kind, engine, lambda: t[0], True, True)
    assert solver.mesh is None
    assert solver.shard_launches is None


def test_unmeshed_server_flight_record_has_no_shard_bytes(monkeypatch):
    """An unmeshed batch server's flight records carry no shard bytes,
    and status() reports no mesh."""
    from doorman_tpu_torch.algorithms import Request
    from doorman_tpu_torch.server.config import parse_yaml_config
    from doorman_tpu_torch.server.election import TrivialElection
    from doorman_tpu_torch.server.server import CapacityServer

    monkeypatch.setattr(phases_mod, "_last_shard_bytes", {})
    config = """
resources:
- identifier_glob: "*"
  capacity: 500
  algorithm: {kind: FAIR_SHARE, lease_length: 60, refresh_interval: 1,
              learning_mode_duration: 0}
"""

    async def body():
        server = CapacityServer(
            "srv_one", TrivialElection(), mode="batch", tick_interval=3600.0,
            minimum_refresh_interval=0.0, native_store=True, device="cpu",
        )
        await server.start(0, host="127.0.0.1")
        try:
            await server.load_config(parse_yaml_config(config))
            for i in range(8):
                server._decide("narrow", Request(f"n{i}", 0.0, 7.0, 1))
            for _ in range(3):
                await server.tick_once()
            records = server.flightrec.snapshot()
            assert server.status()["mesh"] is None
            assert server._resident is not None
            assert server._resident.mesh is None
        finally:
            await server.stop()
        return records

    records = asyncio.run(body())
    assert records
    assert any("dispatches" in r for r in records)
    assert not any("shard_bytes" in r for r in records)


def _bf16_cases(dtype):
    """Edge values and random bit patterns, half of them with their low
    16 bits cleared (bf16-exact as float32)."""
    rng = np.random.default_rng(11)
    edges = [
        np.arange(256.0), [1.0 / 3.0], [257.0], [np.nan], [np.inf, -np.inf],
        [-0.0], [1e-40], [2.0 ** -133], [2.0 ** -134], [3.0e38], [1e39],
        [1.0, 2.5, -6.0],
    ]
    with np.errstate(over="ignore", invalid="ignore"):
        cases = [np.asarray(e, dtype) for e in edges]
        for i in range(200):
            bits = rng.integers(0, 2 ** 32, 6, dtype=np.uint64).astype(
                np.uint32)
            if i % 2:
                bits &= np.uint32(0xFFFF0000)
            cases.append(bits.view(np.float32).astype(dtype))
    cases.append(rng.uniform(10, 20, (3, 4, 6)).astype(dtype)[:, ::2])
    return cases


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_bf16_exact_matches_the_round_trip_and_the_reference(dtype):
    """The staging's wire-format test equals a bf16 round trip through
    torch and the JAX package's own predicate, value class by value
    class (NaN, infinities, signed zero, subnormals, float64 beyond
    float32's range)."""
    import warnings

    import torch

    from doorman_tpu.solver.engine import bf16_exact as ref_exact
    from doorman_tpu_torch.solver.engine import bf16_exact

    assert not bf16_exact(np.zeros(0, dtype))
    seen = set()
    for arr in _bf16_cases(dtype):
        t = torch.from_numpy(np.ascontiguousarray(arr))
        want = bool((t.to(torch.bfloat16).to(t.dtype) == t).all())
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            ref = ref_exact(arr)
        assert bf16_exact(arr) == want == ref, arr
        seen.add(want)
    assert seen == {True, False}
