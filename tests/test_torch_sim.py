"""The discrete-event simulator on the port (doorman_tpu_torch/sim/),
held against the JAX package's (doorman_tpu/sim/).

  * every case of tests/test_sim.py on the port: the scheduler's
    mechanics and the scenario-level regressions (utilization, the
    lease-expiry outage of scenario 3, recovery from mishaps in
    scenario 7, the simulated hour's fidelity bounds);
  * each scenario's Reporter summary and varz counters equal to the
    reference's on the same run length and seed;
  * `python -m doorman_tpu_torch.sim all --run-for 30` as a subprocess:
    seven summary lines, equal to the reference's CLI's.

The simulator is host code: it runs no device work.
"""

import json
import pathlib
import subprocess
import sys

import pytest

import tests.conftest  # noqa: F401
import tests._torch_threads  # noqa: F401

from doorman_tpu.sim.scenarios import run_scenario as j_run_scenario
from doorman_tpu_torch.sim.core import Sim
from doorman_tpu_torch.sim.scenarios import SCENARIOS, run_scenario

ROOT = pathlib.Path(__file__).resolve().parent.parent


class TestScheduler:
    def test_absolute_and_relative_ordering(self):
        sim = Sim()
        order = []
        sim.scheduler.add_absolute(10, lambda: order.append("a"))
        sim.scheduler.add_absolute(5, lambda: order.append("b"))
        sim.scheduler.add_relative(7, lambda: order.append("c"))
        sim.scheduler.loop(20)
        assert order == ["b", "c", "a"]
        assert sim.clock.get_time() == 20

    def test_threads_reschedule(self):
        sim = Sim()
        runs = []

        class T:
            def thread_continue(self):
                runs.append(sim.clock.get_time())
                return 10.0

        sim.scheduler.add_thread(T(), 0.0)
        sim.scheduler.loop(35)
        assert runs == [0.0, 10.0, 20.0, 30.0]

    def test_finalizers_run(self):
        sim = Sim()
        done = []
        sim.scheduler.add_finalizer(lambda: done.append(True))
        sim.scheduler.loop(1)
        assert done == [True]

    def test_action_scheduling_action_same_time(self):
        sim = Sim()
        order = []

        def outer():
            order.append("outer")
            sim.scheduler.add_absolute(
                sim.clock.get_time(), lambda: order.append("inner")
            )

        sim.scheduler.add_absolute(5, outer)
        sim.scheduler.loop(10)
        assert order == ["outer", "inner"]


class TestScenarios:
    def test_scenario_one_converges(self):
        sim, reporter = run_scenario("1", run_for=300)
        s = reporter.summary()
        # 5 clients wanting ~110 each against capacity 500: overload, and
        # nearly all capacity is handed out after learning.
        assert s["utilization"] > 0.85
        assert s["overage_events"] == 0

    @pytest.mark.parametrize(
        "name", ["1_fair", "1_maxmin", "1_balanced", "1_logutil"]
    )
    def test_scenario_one_converges_per_fairness_lane(self, name):
        """The scenario-one convergence arc holds for every
        fairness-portfolio lane: high utilization after learning,
        never an overage (balanced fairness may leave a little more
        slack by design — the insensitivity truncation — so its floor
        is the only relaxed one)."""
        sim, reporter = run_scenario(name, run_for=300)
        s = reporter.summary()
        floor = 0.75 if name == "1_balanced" else 0.85
        assert s["utilization"] > floor, (name, s)
        assert s["overage_events"] == 0, (name, s)

    def test_scenario_two_master_loss_before_expiry(self):
        sim, reporter = run_scenario("2", run_for=300)
        # Re-election at T=140 lands within the 60s lease: clients keep
        # their grants and utilization stays high.
        assert reporter.summary()["utilization"] > 0.85
        assert sim.varz.counter("client.lease_expired").value == 0

    def test_scenario_three_lease_expiry_outage(self):
        sim, reporter = run_scenario("3", run_for=300)
        # Re-election at T=190 is past lease expiry: leases lapse.
        assert sim.varz.counter("client.lease_expired").value > 0
        # And the outage dents utilization relative to scenario 2.
        _, r2 = run_scenario("2", run_for=300)
        assert (
            reporter.summary()["utilization"]
            < r2.summary()["utilization"]
        )

    def test_scenario_four_two_level_tree(self):
        sim, reporter = run_scenario("4", run_for=300)
        assert reporter.summary()["utilization"] > 0.8

    def test_scenario_five_three_level_tree(self):
        sim, reporter = run_scenario("5", run_for=300)
        # Reference quotes 96.8% for this topology (doc/design.md:787).
        assert reporter.summary()["utilization"] > 0.9
        assert len(sim.clients) == 45

    def test_scenario_six_demand_spike(self):
        sim, reporter = run_scenario("6", run_for=300)
        s = reporter.summary()
        assert s["utilization"] > 0.85
        # The two spiking clients dominate after T=150 but never push the
        # total over capacity.
        assert s["overage_events"] == 0

    def test_scenario_seven_mishaps_recover(self):
        sim, reporter = run_scenario("7", run_for=900)
        s = reporter.summary()
        # Mishaps (master loss, elections, spikes) happened...
        mishaps = sum(
            c.value for c in sim.varz.counters() if c.name.startswith("mishap.")
        )
        assert mishaps > 0
        # ...and the system still hands out most of the capacity on
        # average (reference quotes 96.6% over an hour with mishaps).
        assert s["utilization"] > 0.8

    def test_scenario_seven_hour_fidelity(self):
        """Full-fidelity parity run: the reference's simulated hour with
        weighted mishaps (doc/design.md:787-799 quotes 96.6% utilization,
        14 shortfalls, max 530.24 = 106%, avg overage 509.99 = 102%).
        The run is deterministic given the seed, so the bounds pin the
        behavior, not luck; doc/parity.md quotes the measured numbers."""
        sim, reporter = run_scenario("7")  # default duration: 3600s
        s = reporter.summary()
        assert s["samples"] >= 600  # ~an hour of 5s samples, post-warmup
        assert s["utilization"] >= 0.96, s
        # Shortfall statistics in the reference's neighborhood: a
        # handful of events, magnitude a few percent over capacity.
        assert 1 <= s["overage_events"] <= 25, s
        assert s["max_overage"] <= 500 * 1.15, s
        assert 500 < s["avg_overage"] <= 500 * 1.05, s
        # The weighted mishap mix (election 1/15, spike 10/15,
        # lose_master 4/15 — reference scenario_seven.py:54-78 under
        # py2 dict order) is what the hour actually exercised.
        m = {
            c.name: c.value
            for c in sim.varz.counters()
            if c.name.startswith("mishap.")
        }
        assert m.get("mishap.spike", 0) > m.get("mishap.lose_master", 0)
        assert m.get("mishap.lose_master", 0) > m.get("mishap.election", 0)

    def test_deterministic_given_seed(self):
        _, r1 = run_scenario("1", run_for=120, seed=7)
        _, r2 = run_scenario("1", run_for=120, seed=7)
        assert r1.summary() == r2.summary()


def _sim_cli(package):
    out = subprocess.run(
        [sys.executable, "-m", f"{package}.sim", "all", "--run-for", "30"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr[-500:]
    return [
        json.loads(line) for line in out.stdout.splitlines()
        if line.startswith("{")
    ]


def test_cli_all_runs_every_scenario():
    """`python -m doorman_tpu_torch.sim all` is the counterpart of the
    reference's run_all_scenarios.sh: one JSON summary line per
    scenario, all seven of them."""
    lines = _sim_cli("doorman_tpu_torch")
    assert [line["scenario"] for line in lines] == list("1234567")


def test_cli_all_summaries_equal_the_reference():
    """The port's `sim all --run-for 30` prints the reference's seven
    summary lines, key for key."""
    assert _sim_cli("doorman_tpu_torch") == _sim_cli("doorman_tpu")


# ----------------------------------------------------------------------
# Parity with the reference: the same scenario, run length and seed give
# the same Reporter summary and the same varz counters.
# ----------------------------------------------------------------------


def _counters(sim):
    return {c.name: c.value for c in sim.varz.counters()}


@pytest.mark.parametrize("name,run_for,seed", [
    ("1", 300, 0), ("2", 300, 0), ("3", 300, 0), ("4", 300, 0),
    ("5", 300, 0), ("6", 300, 0), ("7", 900, 0), ("1", 120, 7),
])
def test_summary_equals_the_reference(name, run_for, seed):
    sim, reporter = run_scenario(name, run_for=run_for, seed=seed)
    j_sim, j_reporter = j_run_scenario(name, run_for=run_for, seed=seed)
    assert reporter.summary() == j_reporter.summary()
    assert _counters(sim) == _counters(j_sim)
    assert sim.clock.get_time() == j_sim.clock.get_time()


@pytest.mark.parametrize("name", ["1_fair", "1_maxmin", "1_balanced",
                                  "1_logutil"])
def test_fairness_lane_summary_equals_the_reference(name):
    _, reporter = run_scenario(name, run_for=300)
    _, j_reporter = j_run_scenario(name, run_for=300)
    assert reporter.summary() == j_reporter.summary()


def test_registry_equals_the_reference():
    from doorman_tpu.sim.scenarios import SCENARIOS as J_SCENARIOS
    from doorman_tpu.sim.scenarios import registry_lines as j_lines
    from doorman_tpu_torch.sim.scenarios import registry_lines

    assert sorted(SCENARIOS) == sorted(J_SCENARIOS)
    assert registry_lines(SCENARIOS) == j_lines(J_SCENARIOS)
