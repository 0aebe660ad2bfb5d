"""The port's BatchSolver lane part (device="cpu") against the JAX
package's BatchSolver, tick for tick, on identically filled native
stores: the dense part (every resource within DENSE_MAX_K clients, one
[R, K] row each; kernel K1's plain version) and the edge-list part
(DENSE_MAX_K patched below the widest resource, the layout a resident
overflow tick runs), at f64 and f32.

Every lane kind (the portfolio lanes included), bf16-exact and inexact
wants, releases, new clients and a learning-mode flip
(tests.test_engine.conformance_churn). The grant maps and the stores of
record must be IDENTICAL after every tick: the dense rows add left to
right at these widths as XLA's CPU reduction does, the edge list's
segment sums add in edge order as XLA's sorted segment_sum does.
"""

import numpy as np
import pytest

import tests.conftest  # noqa: F401

import doorman_tpu.solver.batch as j_batch
import doorman_tpu_torch.solver.batch as t_batch
from doorman_tpu import native as jnative
from doorman_tpu.core.resource import Resource as JResource
from doorman_tpu_torch import native as tnative
from doorman_tpu_torch.core.resource import Resource as TResource
from tests.test_engine import conformance_churn
from tests.test_torch_resident import all_leases, make_world

pytestmark = pytest.mark.skipif(
    not (jnative.native_available() and tnative.native_available()),
    reason="native engine unavailable",
)

LAYOUTS = {"dense": 4096, "edges": 5}  # DENSE_MAX_K; the worlds hold 9-11


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_port_batch_lane_part_matches_reference(layout, dtype, monkeypatch):
    monkeypatch.setattr(j_batch, "DENSE_MAX_K", LAYOUTS[layout])
    monkeypatch.setattr(t_batch, "DENSE_MAX_K", LAYOUTS[layout])
    dt = np.float64 if dtype == "f64" else np.float32
    t = [1000.0]
    clock = lambda: t[0]  # noqa: E731
    _ej, res_j = make_world(clock, jnative, JResource)
    _et, res_t = make_world(clock, tnative, TResource)
    ref = j_batch.BatchSolver(dtype=dt, clock=clock)
    port = t_batch.BatchSolver(dtype=dt, clock=clock, device="cpu")
    rng_j, rng_t = (np.random.default_rng(31) for _ in range(2))
    for step in range(8):
        conformance_churn(res_j, step, rng_j)
        conformance_churn(res_t, step, rng_t)
        if step == 3:
            res_j[4].learning_mode_end = t[0] + 2
            res_t[4].learning_mode_end = t[0] + 2
        snap = port.prepare(res_t)
        assert (snap.dense is not None) == (layout == "dense")
        assert (snap.edges is not None) == (layout == "edges")
        assert snap.priority_part is None
        gets = port.solve(snap)
        got = port.apply(res_t, snap, gets)
        want = ref.tick(res_j)
        assert got == want, f"tick {step}"
        assert all_leases(res_t) == all_leases(res_j), f"tick {step}"
        t[0] += 1.0
    assert port.ticks == 8
    assert set(port.phase_s) == {"pack", "bands", "solve", "apply"}


def test_python_store_lane_pack_ticks_like_the_reference():
    """A lane resource on the Python lease store packs into the edge
    list (core.snapshot.pack_snapshot) and its grants land in the store
    through regrant, as the reference's BatchSolver does: the same
    grants, and the lease's expiry untouched."""
    from doorman_tpu.core.store import LeaseStore as JLeaseStore
    from doorman_tpu.proto import doorman_pb2 as jpb
    from doorman_tpu_torch.core.store import LeaseStore
    from doorman_tpu_torch.proto import doorman_pb2 as pb

    def world(res_cls, store_cls, proto):
        tpl = proto.ResourceTemplate(
            identifier_glob="r", capacity=10.0,
            algorithm=proto.Algorithm(kind=proto.Algorithm.FAIR_SHARE,
                                      lease_length=60, refresh_interval=5),
        )
        res = res_cls("r", tpl, clock=lambda: 100.0,
                      store_factory=lambda rid: store_cls(
                          rid, clock=lambda: 100.0))
        for c, wants in enumerate((3.0, 8.0, 6.5)):
            res.store.assign(f"c{c}", 60.0, 5.0, 0.0, wants, 1)
        return res

    res = world(TResource, LeaseStore, pb)
    ref = world(JResource, JLeaseStore, jpb)
    solver = t_batch.BatchSolver(dtype=np.float64, device="cpu")
    got = solver.tick([res])
    want = j_batch.BatchSolver(dtype=np.float64).tick([ref])
    assert got == want and len(got["r"]) == 3
    snap = solver.last_snapshot
    assert snap.engine is None and snap.dense is None
    assert snap.keys() == [("r", "c0"), ("r", "c1"), ("r", "c2")]
    for c, lease in res.store.items():
        assert lease.has == got["r"][c] and lease.expiry == 160.0
