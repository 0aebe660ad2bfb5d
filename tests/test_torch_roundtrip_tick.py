"""The round-trip tick (fused=False, `--no-fused-tick`) of the port's
resident solvers on the CPU (device="cpu", K1's plain version).

  * against the port's own fused tick, store for store after every
    tick of a churn stream that mixes bf16-exact and non-exact wants:
    byte-identical, narrow (untracked and delta-tracked, with equal
    changed-rid streams) and wide, at f64 and f32 (as the reference's
    tests/test_fused_tick.py:67 pins its own two tails), and both again
    on an 8-shard CPU mesh (the reference's mesh legs there);
  * against the JAX package's round-trip tick, tick for tick on each
    package's own native store: identical stores, the same solve mode
    and changed rids (f64, the reference's parity dtype);
  * the phase vocabulary (a round-trip tick laps "upload" and "solve",
    never "fused") and the "round-trip" full-solve reason;
  * flipping `fused_tick` on a live solver, stores still identical.
"""

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401

from doorman_tpu import native as jnative
from doorman_tpu.core.resource import Resource as JResource
from doorman_tpu.proto import doorman_pb2 as jpb
from doorman_tpu.solver.resident import ResidentDenseSolver as JNarrow
from doorman_tpu.solver.resident_wide import WideResidentSolver as JWide
from doorman_tpu_torch import native as tnative
from doorman_tpu_torch.core.resource import Resource as TResource
from doorman_tpu_torch.parallel import make_mesh
from doorman_tpu_torch.solver.engine import PHASES
from doorman_tpu_torch.solver.resident import ResidentDenseSolver
from doorman_tpu_torch.solver.resident_wide import WideResidentSolver
from tests.test_engine import conformance_churn
from tests.test_torch_resident import all_leases
from tests.test_torch_resident import make_world as narrow_world
from tests.test_torch_resident_wide import make_world as wide_world

pytestmark = pytest.mark.skipif(
    not (jnative.native_available() and tnative.native_available()),
    reason="native engine unavailable",
)

DTYPES = {"f64": np.float64, "f32": np.float32}


def _world(path, clock, port=True):
    path = path.removesuffix("_mesh")
    if path == "narrow":
        if port:
            return narrow_world(clock, tnative, TResource)
        return narrow_world(clock, jnative, JResource)
    if port:
        return wide_world(clock)
    return wide_world(clock, engine_mod=jnative, resource_cls=JResource,
                      proto=jpb)


def _port_solver(path, engine, clock, fused, dtype=np.float64):
    # "_mesh" paths shard the tables over an 8-shard CPU mesh.
    on = dict(device="cpu")
    if path.endswith("_mesh"):
        on = dict(mesh=make_mesh(devices=[torch.device("cpu")] * 8))
    if path.startswith("narrow"):
        return ResidentDenseSolver(engine, dtype=dtype, clock=clock,
                                   rotate_ticks=2, fused=fused, **on)
    return WideResidentSolver(engine, dtype=dtype, clock=clock,
                              rotate_ticks=2, chunk_width=8, fused=fused,
                              **on)


CASES = [
    ("narrow", False, "f64"), ("narrow", True, "f64"), ("wide", False, "f64"),
    ("narrow", False, "f32"), ("narrow", True, "f32"), ("wide", False, "f32"),
    ("narrow_mesh", True, "f64"), ("wide_mesh", False, "f32"),
]


@pytest.mark.parametrize(
    "path,track,dtype", CASES,
    ids=[f"{p}-{'tracked' if t else 'untracked'}-{d}" for p, t, d in CASES],
)
def test_round_trip_matches_fused_byte_for_byte(path, track, dtype):
    t = [1000.0]
    clock = lambda: t[0]  # noqa: E731
    eng_a, res_a = _world(path, clock)
    eng_b, res_b = _world(path, clock)
    dt = DTYPES[dtype]
    rt = _port_solver(path, eng_a, clock, fused=False, dtype=dt)
    fused = _port_solver(path, eng_b, clock, fused=True, dtype=dt)
    assert fused.fused_tick and not rt.fused_tick
    if track:
        assert rt.enable_delta_tracking() and fused.enable_delta_tracking()
    rng_a, rng_b = (np.random.default_rng(17) for _ in range(2))
    changed = 0
    for step in range(10):
        conformance_churn(res_a, step, rng_a)
        conformance_churn(res_b, step, rng_b)
        if step == 4:
            # A learning-mode flip: the config epoch bump drives a
            # full delivery through both tails.
            res_a[2].learning_mode_end = t[0] + 2.5
            res_b[2].learning_mode_end = t[0] + 2.5
        epoch = 1 if step >= 4 else 0
        rt.step(res_a, epoch)
        fused.step(res_b, epoch)
        a, b = all_leases(res_a), all_leases(res_b)
        assert a.keys() == b.keys(), f"{path} step {step}"
        for key in a:
            assert a[key] == b[key], f"{path} step {step} lease {key}"
        assert rt.last_solve_mode == "full"
        if track:
            got = sorted(rt.take_changed_rids())
            assert got == sorted(fused.take_changed_rids()), f"step {step}"
            changed += len(got)
        t[0] += 1.0
    assert fused.solve_modes["scoped"] >= 3
    assert rt.solve_modes == {"scoped": 0, "full": 10}
    assert changed > 0 or not track


@pytest.mark.parametrize("path", ["narrow", "wide"])
def test_port_round_trip_matches_reference_tick_for_tick(path):
    t = [1000.0]
    clock = lambda: t[0]  # noqa: E731
    eng_j, res_j = _world(path, clock, port=False)
    eng_t, res_t = _world(path, clock)
    if path == "narrow":
        ref = JNarrow(eng_j, dtype=np.float64, clock=clock, rotate_ticks=2,
                      fused=False)
    else:
        ref = JWide(eng_j, dtype=np.float64, clock=clock, rotate_ticks=2,
                    chunk_width=8, fused=False)
    port = _port_solver(path, eng_t, clock, fused=False)
    track = path == "narrow"
    if track:
        assert ref.enable_delta_tracking() and port.enable_delta_tracking()
    rng_j, rng_t = (np.random.default_rng(29) for _ in range(2))
    for step in range(10):
        conformance_churn(res_j, step, rng_j)
        conformance_churn(res_t, step, rng_t)
        if step == 5:
            res_j[1].learning_mode_end = t[0] + 2.5
            res_t[1].learning_mode_end = t[0] + 2.5
        epoch = 1 if step >= 5 else 0
        ref.step(res_j, epoch)
        port.step(res_t, epoch)
        assert all_leases(res_j) == all_leases(res_t), f"{path} tick {step}"
        assert port.last_solve_mode == ref.last_solve_mode == "full"
        assert port.last_full_reason == ref.last_full_reason
        if track:
            assert sorted(ref.take_changed_rids()) == sorted(
                port.take_changed_rids()
            ), f"tick {step}: changed-rid streams diverged"
        t[0] += 1.0
    assert port.ticks == ref.ticks == 10


@pytest.mark.parametrize("path", ["narrow", "wide"])
def test_round_trip_phase_vocabulary_and_full_reason(path):
    """Round-trip ticks lap "upload" and "solve" and never "fused"; fused
    ticks the reverse (reference tests/test_fused_tick.py:149). Every
    round-trip tick solves the full table for the reason "round-trip",
    which ranks before every other but "disabled", the first tick's
    rebuild included (reference solver/engine.py:829-832)."""
    assert {"upload", "solve", "fused"} <= set(PHASES)
    t = [1000.0]
    clock = lambda: t[0]  # noqa: E731
    eng_a, res_a = _world(path, clock)
    eng_b, res_b = _world(path, clock)
    rt = _port_solver(path, eng_a, clock, fused=False)
    fused = _port_solver(path, eng_b, clock, fused=True)
    reasons = []
    for solver, res in ((rt, res_a), (fused, res_b)):
        for step in range(3):
            client = next(iter(dict(res[0].store.items())))
            res[0].store.assign(client, 60.0, 5.0,
                                res[0].store.get(client).has, 5.0 + step, 1)
            solver.step(res, 0)
            if solver is rt:
                reasons.append(rt.last_full_reason)
            t[0] += 1.0
    assert reasons == ["round-trip"] * 3
    assert rt.scope_status()["full_ticks"] == 3
    assert rt.phase_s["upload"] > 0.0 and rt.phase_s["solve"] > 0.0
    assert rt.phase_s["fused"] == 0.0
    assert fused.phase_s["fused"] > 0.0
    assert fused.phase_s["upload"] == fused.phase_s["solve"] == 0.0
    assert set(rt.phase_s) == set(fused.phase_s) == set(PHASES)


@pytest.mark.parametrize("path", ["narrow", "wide"])
def test_fused_toggle_switches_the_tail_and_keeps_stores_identical(path):
    """Flipping fused_tick on a live solver (reference
    tests/test_fused_tick.py:217): the next tick runs the other tail,
    and both stores stay identical to a solver that never flipped."""
    t = [1000.0]
    clock = lambda: t[0]  # noqa: E731
    eng_a, res_a = _world(path, clock)
    eng_b, res_b = _world(path, clock)
    ref = _port_solver(path, eng_a, clock, fused=False)
    toggled = _port_solver(path, eng_b, clock, fused=True)
    rng_a, rng_b = (np.random.default_rng(31) for _ in range(2))
    for step in range(8):
        conformance_churn(res_a, step, rng_a)
        conformance_churn(res_b, step, rng_b)
        if step == 3:
            toggled.fused_tick = False
        if step == 6:
            toggled.fused_tick = True
        fused_before = toggled.phase_s["fused"]
        ref.step(res_a, 0)
        toggled.step(res_b, 0)
        assert all_leases(res_a) == all_leases(res_b), f"step {step}"
        ran_fused = toggled.phase_s["fused"] > fused_before
        assert ran_fused == (step < 3 or step >= 6), f"step {step}"
        t[0] += 1.0
    assert toggled.fused_tick
