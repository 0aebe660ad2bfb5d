"""The generator and the layout: a deployment from its configuration,
and the refresh plan's counts, phases and recipe changes."""

import json

import numpy as np
import pytest

from portbench import harness
from portbench.gen import deploy, traffic
from portbench.layouts import templates

MIX = {"kind": "refresh", "warm_iterations": 2,
       "recipe": {"function": "random_change", "base": 15.0, "change": 5.0,
                  "interval_s": 60.0}}


def _cfg(resources=6, clients=10):
    cfg = harness.load_config(harness.load_benchmark(), "loadtest-1m")
    return harness.merge(cfg, {"resources": resources, "clients": clients})


def test_templates_match_as_upstream_does():
    ts = [{"identifier_glob": "fair"}, {"identifier_glob": "proportional*"},
          {"identifier_glob": "*"}, {"identifier_glob": "proportional-7"}]
    assert templates.match(ts, "fair") is ts[0]
    assert templates.match(ts, "proportional-3") is ts[1]
    assert templates.match(ts, "proportional-7") is ts[3]  # exact first
    assert templates.match(ts, "other") is ts[2]


def test_deployment_follows_its_configuration():
    cfg = _cfg()
    dep = deploy.layout(cfg).build(cfg, MIX, 5)
    assert dep.ids[0] == "proportional-0000" and dep.n == 6
    assert (dep.kind == 2).all() and (dep.capacity == 5000.0).all()
    assert dep.lease_length == 60.0 and dep.refresh_interval == 5.0
    assert dep.wants.shape == (6, 10)
    assert (dep.wants >= 10.0).all() and (dep.wants <= 20.0).all()
    doc = json.loads(dep.document)
    assert [t["identifier_glob"] for t in doc["resources"]] == [
        "fair", "proportional*", "*"]
    assert all(t["algorithm"]["learning_mode_duration"] == 0
               for t in doc["resources"])
    again = deploy.layout(cfg).build(cfg, MIX, 5)
    assert (again.wants == dep.wants).all()


def _plan(seed, n=3600):
    initial = traffic.population_wants(MIX, seed, n)
    return initial, traffic.RefreshPlan(initial, MIX, seed, 5.0, 1.0)


@pytest.mark.parametrize("seed", [0, 2**31 + 11, 4_000_000_017])
def test_every_lease_refreshes_once_per_interval(seed):
    _initial, plan = _plan(seed)
    assert (plan.F, plan.M, plan.P) == (5, 12, 120)
    seen = np.concatenate(plan.members)
    assert sorted(seen) == list(range(3600))
    assert [len(m) for m in plan.members] == [720] * 5


def test_a_twelfth_of_each_iterations_wants_change():
    initial, plan = _plan(1)
    state = initial.copy()
    for i in range(2 * plan.P):
        m = plan.members[i % plan.F]
        wants = plan.pool[i % plan.P]
        assert (wants != state[m]).sum() == 60  # 720 / 12
        state[m] = wants
        np.testing.assert_array_equal(plan.state(i), state)
    # the same sizes for every seed; other leases and draws
    _i2, other = _plan(2)
    assert [len(m) for m in other.members] == [len(m) for m in plan.members]
    assert not all((a == b).all() for a, b in zip(other.members,
                                                  plan.members))


def test_bound_handles_follow_the_members():
    _initial, plan = _plan(3, n=60)
    rid = np.arange(6, dtype=np.int32) + 100
    cids = np.arange(60, dtype=np.int64).reshape(6, 10) + 1000
    plan.bind(rid, cids)
    rids, cids_0, wants = plan.batch(0)
    np.testing.assert_array_equal(cids_0, plan.members[0] + 1000)
    np.testing.assert_array_equal(rids, plan.members[0] // 10 + 100)
    assert len(wants) == len(rids) == plan.size(0)


def test_intervals_must_divide():
    with pytest.raises(ValueError):
        traffic.RefreshPlan(np.ones(10), MIX, 0, 5.0, 2.0)
