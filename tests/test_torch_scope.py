"""The scoped tick's frontier (the rows still in scope after quiet ticks)
in the port's server against the reference's, on the CPU.

Both servers run batch mode on the native store with a depth-3 tick
pipeline, are filled with the same seeded leases, take the same 5%
demand churn for a number of ticks and then quiet ticks with no writes.

- Narrow rows (24 clients, where the port's row sums add in XLA's CPU
  order): the frontier is the same set, tick for tick, and the stores
  hold identical grants.
- Wide rows (100 clients, where the two row-sum orders differ): both
  servers keep rows in scope for good, and only rows of the two lanes
  that clamp a grant by the free capacity `cap - (sum(has) - has)`
  (PROPORTIONAL_SHARE and its top-up variant). An overloaded row's
  grant sits exactly on that clamp, so the rounding of sum(has) moves it
  by an ulp each tick in either package and at either dtype: the
  reference's own has-chain behaviour, not a fault of the port.

Run with `-s` to see the frontier sizes.
"""

import asyncio

import numpy as np
import pytest

import tests.conftest  # noqa: F401

from doorman_tpu import native as jnative
from doorman_tpu.server.config import parse_yaml_config as j_parse
from doorman_tpu.server.election import TrivialElection as JElection
from doorman_tpu.server.server import CapacityServer as JServer
from doorman_tpu_torch import native as tnative
from doorman_tpu_torch.server.config import parse_yaml_config as t_parse
from doorman_tpu_torch.server.election import TrivialElection as TElection
from doorman_tpu_torch.server.server import CapacityServer as TServer

pytestmark = pytest.mark.skipif(
    not (jnative.native_available() and tnative.native_available()),
    reason="native engine unavailable",
)

N_RES = 60
CHURN_TICKS = 12
QUIET_TICKS = 10
FREE_CLAMP_KINDS = {2, 4}  # PROPORTIONAL_SHARE, PROPORTIONAL_TOPUP (solve kinds)

# (glob prefix, wire kind, variant)
LANES = (
    ("prop", "PROPORTIONAL_SHARE", None),
    ("topup", "PROPORTIONAL_SHARE", "topup"),
    ("fair", "FAIR_SHARE", None),
    ("maxmin", "FAIR_SHARE", "maxmin"),
    ("static", "STATIC", None),
)
CAPS = (800.0, 1_500.0, 5_000.0)


def _config():
    lines = ["resources:"]
    for prefix, kind, variant in LANES:
        for t, cap in enumerate(CAPS):
            params = (
                f", parameters: [{{name: variant, value: {variant}}}]"
                if variant else ""
            )
            lines.append(
                f"  - identifier_glob: '{prefix}.t{t}.*'\n"
                f"    capacity: {cap}\n"
                f"    algorithm: {{kind: {kind}, lease_length: 3600,"
                f" refresh_interval: 5, learning_mode_duration: 0{params}}}"
            )
    lines.append(
        "  - identifier_glob: '*'\n    capacity: 1000\n"
        "    algorithm: {kind: NO_ALGORITHM, lease_length: 3600,"
        " refresh_interval: 5, learning_mode_duration: 0}"
    )
    return "\n".join(lines) + "\n"


async def _run(server_cls, election_cls, parse, n_clients, dtype, **kw):
    t = [5000.0]
    server = server_cls(
        "x", election_cls(), mode="batch", native_store=True,
        solver_dtype=dtype, fused_tick=True, scoped_solve=True,
        tick_pipeline_depth=3, tick_interval=1.0, clock=lambda: t[0], **kw,
    )
    await server.load_config(parse(_config()))
    rng = np.random.default_rng(1)
    ids = [
        f"{LANES[i % len(LANES)][0]}.t{(i // len(LANES)) % len(CAPS)}.r{i}"
        for i in range(N_RES)
    ]
    resources = [server.get_or_create_resource(r) for r in ids]
    engine = server._store_engine
    rids = np.repeat([r.store._rid for r in resources], n_clients)
    cids = np.array([engine.client_handle(f"c{i}.{c}")
                     for i in range(N_RES) for c in range(n_clients)])
    n = len(rids)
    engine.bulk_assign(
        rids, cids, np.full(n, t[0] + 3600.0), np.full(n, 5.0), np.zeros(n),
        rng.integers(0, 100, n).astype(np.float64), np.ones(n, np.int32),
    )
    rids = rids.reshape(N_RES, n_clients)
    cids = cids.reshape(N_RES, n_clients)
    frontier = []
    for tick in range(CHURN_TICKS + QUIET_TICKS):
        if tick < CHURN_TICKS:
            pick = rng.choice(N_RES, N_RES // 20, replace=False)
            m = len(pick) * n_clients
            engine.bulk_refresh(
                rids[pick].ravel(), cids[pick].ravel(),
                np.full(m, t[0] + 3600.0), np.full(m, 5.0),
                rng.integers(0, 100, m).astype(np.float64),
            )
        await server.tick_once()
        t[0] += 1.0
        frontier.append(len(server._resident._scope))
    await asyncio.get_running_loop().run_in_executor(
        None, server._resident_pipe.flush
    )
    solver = server._resident
    final = set(solver._scope.ids().tolist())
    kinds = {int(solver._config.kind_h[i]) for i in final}
    grants = {(r.id, c): lease.has
              for r in resources for c, lease in r.store.items()}
    await server.stop()
    return frontier, final, kinds, grants


def _both(n_clients, dtype):
    async def go():
        ref = await _run(JServer, JElection, j_parse, n_clients, dtype,
                         flightrec_capacity=0)
        port = await _run(TServer, TElection, t_parse, n_clients, dtype,
                          device="cpu")
        return ref, port

    ref, port = asyncio.run(go())
    print(f"\n{n_clients} clients {dtype}: frontier per tick "
          f"reference {ref[0]}, port {port[0]}")
    return ref, port


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_narrow_rows_scope_frontier_equals_the_reference(dtype):
    ref, port = _both(24, dtype)
    assert port[0] == ref[0], "frontier sizes diverged"
    assert port[1] == ref[1], "final frontier sets differ"
    assert port[3] == ref[3], "stores diverged"
    # The quiet ticks bring the frontier down from every row to a few
    # free-clamp rows.
    assert ref[0][-1] < N_RES // 4, ref[0]
    assert ref[2] <= FREE_CLAMP_KINDS, ref[2]


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_wide_rows_keep_only_free_clamp_lanes_in_scope(dtype):
    ref, port = _both(100, dtype)
    for name, (_sizes, final, kinds, _g) in (("reference", ref),
                                             ("port", port)):
        assert final, f"{name}: frontier empty (nothing to explain)"
        assert kinds <= FREE_CLAMP_KINDS, f"{name}: frontier lanes {kinds}"
