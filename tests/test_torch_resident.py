"""The port's ResidentDenseSolver (device="cpu") against the JAX package's,
tick for tick, on identically filled native stores.

Both packages keep their own native engine; each world is filled with
the same seeded population and churned by the same seeded stream
(tests.test_engine.conformance_churn: bf16-exact and non-exact wants,
releases, new clients, a learning-mode flip with a config-epoch bump).
After every tick the stores must hold IDENTICAL leases (exact float
equality: the port's plain solve adds rows left to right at these
widths, as XLA's CPU reduction does) and the delta-tracking changed-rid
streams must be equal — for the scoped tick (also with the window-time
pack cache attached), the full fused tick and the tracked full tick —
and the scoped and tracked full ticks again on an 8-shard mesh against
the JAX package's mesh solver. f64, the reference's parity dtype.
"""

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
import tests._torch_threads  # noqa: F401

from doorman_tpu import native as jnative
from doorman_tpu.core.resource import Resource as JResource
from doorman_tpu.proto import doorman_pb2 as pb
from doorman_tpu.solver.resident import ResidentDenseSolver as JSolver
from doorman_tpu_torch import native as tnative
from doorman_tpu_torch.core.resource import Resource as TResource
from doorman_tpu_torch.solver.carry import tables_from_numpy
from doorman_tpu_torch.solver.dense import solve_dense
from doorman_tpu_torch.solver.resident import ResidentDenseSolver as TSolver
from tests.test_engine import conformance_churn

pytestmark = pytest.mark.skipif(
    not (jnative.native_available() and tnative.native_available()),
    reason="native engine unavailable",
)

KINDS = (0, 1, 2, 3, 4)  # wire kinds; variants add the portfolio lanes
VARIANTS = (None, None, "topup", "maxmin", "balanced", "logutil")


def _template(r, rng):
    kind = KINDS[r % len(KINDS)]
    variant = VARIANTS[r % len(VARIANTS)]
    params = []
    if variant == "topup" or variant == "logutil":
        kind = int(pb.Algorithm.PROPORTIONAL_SHARE)
        params = [pb.NamedParameter(name="variant", value=variant)]
    elif variant in ("maxmin", "balanced"):
        kind = int(pb.Algorithm.FAIR_SHARE)
        params = [pb.NamedParameter(name="variant", value=variant)]
    if kind == int(pb.Algorithm.PRIORITY_BANDS):
        kind = int(pb.Algorithm.FAIR_SHARE)
    return pb.ResourceTemplate(
        identifier_glob=f"res{r}",
        capacity=float(rng.integers(50, 500)),
        algorithm=pb.Algorithm(
            kind=kind, lease_length=60, refresh_interval=5,
            parameters=params,
        ),
    )


def make_world(clock, engine_mod, resource_cls, n_res=12, n_clients=9,
               seed=3):
    rng = np.random.default_rng(seed)
    engine = engine_mod.StoreEngine(clock=clock)
    resources = []
    for r in range(n_res):
        res = resource_cls(
            f"res{r}", _template(r, rng), clock=clock,
            store_factory=engine.store,
        )
        resources.append(res)
        for c in range(n_clients):
            res.store.assign(
                f"c{r}_{c}", 60.0, 5.0, 0.0, float(rng.integers(1, 100)), 1,
            )
    return engine, resources


def all_leases(resources):
    return {
        (res.id, client): (lease.has, lease.wants, lease.subclients)
        for res in resources
        for client, lease in res.store.items()
    }


MODES = {
    "scoped": dict(scoped=True, track=True),
    "scoped_staged": dict(scoped=True, track=False, staged=True),
    "full_fused": dict(scoped=False, track=False),
    "full_tracked": dict(scoped=False, track=True),
    # The mesh legs: the port's 8-shard CPU mesh against the JAX
    # package's 8 virtual CPU devices (per-shard rotation on both).
    "scoped_mesh": dict(scoped=True, track=True, mesh=True),
    "full_tracked_mesh": dict(scoped=False, track=True, mesh=True),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_port_resident_matches_reference_tick_for_tick(mode):
    cfg = MODES[mode]
    t = [1000.0]
    clock = lambda: t[0]  # noqa: E731
    eng_j, res_j = make_world(clock, jnative, JResource)
    eng_t, res_t = make_world(clock, tnative, TResource)
    if cfg.get("mesh"):
        from doorman_tpu.parallel import make_mesh as jmake_mesh
        from doorman_tpu_torch.parallel import make_mesh

        on_j = dict(mesh=jmake_mesh())
        on_t = dict(mesh=make_mesh(devices=[torch.device("cpu")] * 8))
    else:
        on_j, on_t = {}, dict(device="cpu")
    ref = JSolver(eng_j, dtype=np.float64, clock=clock, rotate_ticks=2,
                  scoped=cfg["scoped"], **on_j)
    port = TSolver(eng_t, dtype=np.float64, clock=clock, rotate_ticks=2,
                   scoped=cfg["scoped"], **on_t)
    if cfg["track"]:
        assert ref.enable_delta_tracking() and port.enable_delta_tracking()
    if cfg.get("staged"):
        # Window-time pack cache: rows are pre-packed right after the
        # writes and the tick serves them from the cache.
        ref.attach_staging()
        port.attach_staging()
    rng_j, rng_t = (np.random.default_rng(17) for _ in range(2))
    modes = []
    for step in range(12):
        conformance_churn(res_j, step, rng_j)
        conformance_churn(res_t, step, rng_t)
        if cfg.get("staged") and step:
            ref.stage_rids([r.store._rid for r in res_j[::2]])
            assert port.stage_rids([r.store._rid for r in res_t[::2]]) == 6
        if step == 5:
            res_j[2].learning_mode_end = t[0] + 2.5
            res_t[2].learning_mode_end = t[0] + 2.5
        epoch = 1 if step >= 5 else 0
        ref.step(res_j, epoch)
        port.step(res_t, epoch)
        a, b = all_leases(res_j), all_leases(res_t)
        assert a == b, f"{mode} step {step}: stores diverged"
        if cfg["track"]:
            assert sorted(ref.take_changed_rids()) == sorted(
                port.take_changed_rids()
            ), f"{mode} step {step}: changed-rid streams diverged"
        assert port.last_solve_mode == ref.last_solve_mode
        modes.append(port.last_solve_mode)
        t[0] += 1.0
    if cfg["scoped"]:
        assert modes.count("scoped") >= 5, modes
    else:
        assert "scoped" not in modes


def test_carried_tables_solve_like_the_reference():
    """The reference solver's resident tables, carried into port tensors
    by tables_from_numpy, solve to the reference's own next grants."""
    import jax

    t = [1000.0]
    clock = lambda: t[0]  # noqa: E731
    eng_j, res_j = make_world(clock, jnative, JResource, seed=5)
    ref = JSolver(eng_j, dtype=np.float64, clock=clock, rotate_ticks=1)
    ref.step(res_j)
    cfg = ref._config
    tabs = [jax.device_get(x) for x in (
        ref._wants, ref._has, ref._sub, ref._act, cfg.cap_d, cfg.kind_d,
        cfg.learn_d, cfg.statc_d,
    )]
    batch, _ = tables_from_numpy(*tabs, device="cpu", dtype=torch.float64)
    got = solve_dense(batch).numpy()
    from doorman_tpu.solver.dense import DenseBatch, solve_dense as jsolve

    want = np.asarray(jsolve(DenseBatch(
        wants=ref._wants, has=ref._has, subclients=ref._sub,
        active=ref._act, capacity=cfg.cap_d, algo_kind=cfg.kind_d,
        learning=cfg.learn_d, static_capacity=cfg.statc_d,
    )))
    np.testing.assert_array_equal(got, want)
