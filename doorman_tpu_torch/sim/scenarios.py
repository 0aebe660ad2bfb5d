"""The seven reference scenarios (capability parity with reference
simulation/scenario_*.py), parameterized by a Sim context.

1: convergence — one root job x3 tasks, 5 clients with fluctuating demand.
2: master loss at T=120, re-election at T=140 (before lease expiry).
3: master loss at T=120, re-election at T=190 (after lease expiry).
4: two-level tree (root + one DC job).
5: three-level tree — root, 3 regions x 3 DCs x 5 clients = 45 clients.
6: demand spike to 1000 on two clients at T=150.
7: scenario 5 plus a random mishap every 60s for a simulated hour.
"""

from __future__ import annotations

from typing import Callable, Dict

from doorman_tpu_torch.sim.core import Sim
from doorman_tpu_torch.sim.model import ServerJob, SimClient
from doorman_tpu_torch.sim.reporter import Reporter


def scenario_one(sim: Sim, reporter: Reporter) -> None:
    """Convergence: one root job x3 tasks, 5 clients, fluctuating demand."""
    job = ServerJob(sim, "root", 0, 3)
    for _ in range(5):
        c = SimClient(sim, "client", job)
        c.add_resource("resource0", 0, 110, 0.1, 10)
    reporter.schedule("resource0")
    reporter.set_filename("scenario_one")


def _master_loss(sim: Sim, reporter: Reporter, reelect_at: float) -> None:
    job = ServerJob(sim, "root", 0, 3)
    for _ in range(5):
        c = SimClient(sim, "client", job)
        c.add_resource("resource0", 0, 110, 0.1, 10)
    sim.scheduler.add_absolute(120, job.lose_master)
    sim.scheduler.add_absolute(reelect_at, job.trigger_master_election)
    reporter.schedule("resource0")


def scenario_two(sim: Sim, reporter: Reporter) -> None:
    """Master loss at T=120, re-election at T=140 (before lease expiry)."""
    # Re-election before the 60s leases expire: clients keep capacity.
    _master_loss(sim, reporter, reelect_at=140)
    reporter.set_filename("scenario_two")


def scenario_three(sim: Sim, reporter: Reporter) -> None:
    """Master loss at T=120, re-election at T=190 (after lease expiry)."""
    # Re-election after lease expiry: clients drop to zero, then recover.
    _master_loss(sim, reporter, reelect_at=190)
    reporter.set_filename("scenario_three")


def scenario_four(sim: Sim, reporter: Reporter) -> None:
    """Two-level tree: root plus one DC job."""
    root = ServerJob(sim, "root", 0, 3)
    dc = ServerJob(sim, "dc", 1, 3, root)
    for _ in range(5):
        c = SimClient(sim, "client", dc)
        c.add_resource("resource0", 0, 110, 0.1, 10)
    reporter.schedule("resource0")
    reporter.set_filename("scenario_four")


def scenario_five(sim: Sim, reporter: Reporter, num_clients: int = 5) -> None:
    """Three-level tree: root, 3 regions x 3 DCs x 5 clients each."""
    root = ServerJob(sim, "root", 0, 3)
    for i in range(1, 4):
        region = ServerJob(sim, f"region:{i}", 1, 3, root)
        for j in range(1, 4):
            dc = ServerJob(sim, f"dc:{i}:{j}", 2, 3, region)
            for _ in range(num_clients):
                c = SimClient(sim, f"client:{i}:{j}", dc)
                c.add_resource("resource0", 0, 15, 0.1, 10)
    reporter.schedule("resource0")
    reporter.set_filename("scenario_five")


def scenario_six(sim: Sim, reporter: Reporter) -> None:
    """Demand spike to 1000 on two clients at T=150."""
    job = ServerJob(sim, "root", 0, 3)
    clients = []
    for _ in range(5):
        c = SimClient(sim, "client", job)
        c.add_resource("resource0", 0, 50, 0.1, 10)
        clients.append(c)

    def spike():
        for c in clients[:2]:
            c.set_wants("resource0", 1000.0)

    sim.scheduler.add_absolute(150, spike)
    reporter.schedule("resource0")
    reporter.set_filename("scenario_six")


def scenario_seven(sim: Sim, reporter: Reporter) -> None:
    """Scenario 5 plus a random mishap every 60s for a simulated hour."""
    scenario_five(sim, reporter)
    reporter.set_filename("scenario_seven")

    def spike_client():
        client = sim.random_client()
        client.set_wants(
            "resource0", client.get_wants("resource0") + 100
        )
        sim.varz.counter("mishap.spike").inc()

    def trigger_election():
        sim.random_server_job().trigger_master_election()
        sim.varz.counter("mishap.election").inc()

    def lose_master():
        job = sim.random_server_job()
        delay = sim.random.randint(0, 60)
        job.lose_master()
        sim.scheduler.add_relative(delay, job.trigger_master_election)
        sim.varz.counter("mishap.lose_master").inc()

    def random_mishap():
        sim.scheduler.add_relative(60, random_mishap)
        # The reference's weighted pick, reproduced exactly
        # (scenario_seven.py:54-78): m = randint(0, 14) walked against
        # the weight map {5: spike, 10: election, 15: lose_master} in
        # Python 2 dict iteration order — which for these small-int
        # keys is [10, 5, 15] (hash slots 2, 5, 7) — picking the entry
        # once the cumulative weight reaches m. Effective distribution:
        # election 1/15, spike 10/15, lose_master 4/15. Spikes dominate
        # the reference's mishap hour; a uniform pick would inject ~5x
        # more master elections and misstate recovery behavior.
        m = sim.random.randint(0, 14)
        n = 0
        for weight, mishap in (
            (10, trigger_election),
            (5, spike_client),
            (15, lose_master),
        ):
            if n >= m:
                mishap()
                return
            n += weight

    sim.scheduler.add_absolute(60, random_mishap)


def _scenario_one_lane(wire_kind: str, variant: "str | None"):
    """scenario_one re-pointed at a fairness-portfolio lane: the same
    convergence arc (5 clients, fluctuating demand, one 110-capacity
    pool in overload) must hold whichever lane apportions it — the
    sim-side half of the per-algorithm scenario diversity."""
    from doorman_tpu_torch.proto import doorman_pb2 as pb
    from doorman_tpu_torch.sim.model import SimConfig

    def scenario(sim: Sim, reporter: Reporter) -> None:
        config = SimConfig.portfolio(
            getattr(pb.Algorithm, wire_kind), variant
        )
        job = ServerJob(sim, "root", 0, 3, config=config)
        for _ in range(5):
            c = SimClient(sim, "client", job)
            c.add_resource("resource0", 0, 110, 0.1, 10)
        reporter.schedule("resource0")
        reporter.set_filename(f"scenario_one_{variant or 'fair'}")

    scenario.__doc__ = (
        f"Scenario-one convergence arc on the {variant or 'fair'} lane."
    )
    return scenario


SCENARIOS: Dict[str, Callable[[Sim, Reporter], None]] = {
    "1": scenario_one,
    "2": scenario_two,
    "3": scenario_three,
    "4": scenario_four,
    "5": scenario_five,
    "6": scenario_six,
    "7": scenario_seven,
    # The fairness portfolio over the scenario-one convergence arc.
    "1_fair": _scenario_one_lane("FAIR_SHARE", None),
    "1_maxmin": _scenario_one_lane("FAIR_SHARE", "maxmin"),
    "1_balanced": _scenario_one_lane("FAIR_SHARE", "balanced"),
    "1_logutil": _scenario_one_lane("PROPORTIONAL_SHARE", "logutil"),
}

DEFAULT_DURATION: Dict[str, float] = {"7": 3600.0}


def registry_lines(registry: "Dict[str, Callable]") -> "list":
    """[(name, one-line doc), ...] for a scenario registry — what a
    CLI's --list-scenarios prints. The one-liner is the factory
    docstring's first line (the registry convention shared by the sim
    and workload scenario libraries)."""
    import inspect

    return [
        (name, (inspect.getdoc(fn) or "").splitlines()[0]
         if inspect.getdoc(fn) else "")
        for name, fn in sorted(registry.items())
    ]


def run_scenario(name: str, run_for: float | None = None, seed: int = 0,
                 write_csv: bool = False):
    """Run one scenario; returns (sim, reporter) for inspection."""
    sim = Sim(seed=seed)
    reporter = Reporter(sim)
    scenario = SCENARIOS[str(name)]
    scenario(sim, reporter)
    if not write_csv:
        reporter.set_filename(None)
    duration = run_for if run_for is not None else DEFAULT_DURATION.get(
        str(name), 300.0
    )
    sim.scheduler.loop(duration)
    return sim, reporter
