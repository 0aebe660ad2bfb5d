"""Shipped fault plans: the standing chaos regression suite.

Each plan is small enough to run in the tier-1 smoke suite (tens of
virtual ticks, milliseconds-to-seconds of wall clock on CPU) and is the
replay artifact for its scenario — `python -m doorman_tpu_torch.cmd.chaos
--plan master_flap` runs one by name, `--save-plan` dumps the JSON for
editing. Timelines below are in ticks (1 virtual second each).

Port of doorman_tpu/chaos/plans.py: a copy apart from import paths.
"""

from __future__ import annotations

from typing import Dict

from doorman_tpu_torch.chaos.plan import FaultEvent, FaultPlan


def master_flap() -> FaultPlan:
    """Two candidates; the master's etcd view browns out past the lock
    TTL. Expect: step-down without split-brain, the standby wins after
    the lock lapses, clients chase the redirect once the old master's
    watcher heals, allocation returns to baseline via learning mode.
    The streaming leg: one WatchCapacity subscriber rides along — its
    stream must terminate with a mastership redirect at the flip, the
    client must fall back to polling (the lease-window invariants hold
    for it like any polling client), and it must re-establish a stream
    once a master is back."""
    return FaultPlan(
        name="master_flap",
        seed=1,
        setup={
            "servers": 2,
            "clients": 3,
            "wants": [20.0, 30.0, 60.0],
            # The streaming leg (runner: stream_step per tick; servers
            # get stream_push + a per-tick fanout beat).
            "streams": 1,
            "stream_wants": [15.0],
            "capacity": 100,
            "mode": "immediate",
            "lease_length": 60,
            "refresh_interval": 1,
            "learning_mode_duration": 3,
            "election_ttl": 3.0,
        },
        events=[
            FaultEvent(at_tick=7, kind="kv_drop", target="s0",
                       duration_ticks=5),
        ],
        warmup_ticks=7,
        total_ticks=24,
        reconverge_ticks=8,
    )


def etcd_brownout() -> FaultPlan:
    """One master, three phases: a single dropped renewal round-trip
    (must be survived by the transient-retry tolerance), one spurious
    NOT_MASTER on the client link (one failed refresh, lease retained),
    then a sustained brownout past the TTL (mastership lost, lock
    lapses, the same server re-wins and relearns)."""
    return FaultPlan(
        name="etcd_brownout",
        seed=2,
        setup={
            "servers": 1,
            "clients": 3,
            "wants": [15.0, 25.0, 40.0],
            "capacity": 60,
            "mode": "immediate",
            "lease_length": 60,
            "refresh_interval": 1,
            "learning_mode_duration": 3,
            "election_ttl": 3.0,
        },
        events=[
            FaultEvent(at_tick=7, kind="kv_drop", target="s0",
                       duration_ticks=1, params={"calls": 1}),
            FaultEvent(at_tick=8, kind="grpc_not_master",
                       target="link:s0", duration_ticks=1,
                       params={"calls": 1}),
            FaultEvent(at_tick=9, kind="kv_drop", target="s0",
                       duration_ticks=4),
        ],
        warmup_ticks=7,
        total_ticks=20,
        reconverge_ticks=6,
    )


def device_tunnel_outage() -> FaultPlan:
    """Batch server on the resident tick path: the device solve dies
    mid-rotation for three ticks (tick errors, not crashes — stores
    keep serving last solved grants), then a ResidentOverflow forces
    the BatchSolver fallback, then one slow solve. Allocation never
    deviates from baseline. The shadow audit rides along as the CLEAN
    pin: across tick errors, the fallback and the slow solve, the
    sampled oracle replay must report ZERO divergences (the
    grant_corruption plan is the dirty twin that must report some)."""
    return FaultPlan(
        name="device_tunnel_outage",
        seed=3,
        setup={
            "servers": 1,
            "clients": 4,
            "wants": [10.0, 20.0, 30.0, 40.0],
            "capacity": 80,
            "mode": "batch",
            "native_store": True,
            "lease_length": 60,
            "refresh_interval": 1,
            "learning_mode_duration": 0,
            "election_ttl": 3.0,
            "audit_sample": 3,
        },
        events=[
            FaultEvent(at_tick=7, kind="solver_error", target="s0",
                       duration_ticks=3),
            FaultEvent(at_tick=10, kind="resident_overflow", target="s0",
                       duration_ticks=1, params={"calls": 1}),
            FaultEvent(at_tick=11, kind="solver_slow", target="s0",
                       duration_ticks=1,
                       params={"calls": 1, "seconds": 0.02}),
        ],
        warmup_ticks=7,
        total_ticks=20,
        reconverge_ticks=6,
    )


def intermediate_partition() -> FaultPlan:
    """Root + intermediate + clients on the intermediate: the
    intermediate<->root hop partitions for longer than the parent lease,
    so the intermediate's capacity decays to zero (clients degrade, no
    overcommit), then heals and re-leases from the root."""
    return FaultPlan(
        name="intermediate_partition",
        seed=4,
        setup={
            "servers": 1,
            "intermediate": True,
            "clients": 3,
            "wants": [10.0, 20.0, 30.0],
            "capacity": 90,
            "mode": "immediate",
            "lease_length": 6,
            "refresh_interval": 1,
            "learning_mode_duration": 0,
            "election_ttl": 3.0,
        },
        events=[
            FaultEvent(at_tick=6, kind="grpc_drop", target="link:s0",
                       duration_ticks=9),
        ],
        warmup_ticks=6,
        total_ticks=24,
        reconverge_ticks=6,
    )


def master_flap_warm(
    name: str = "master_flap_warm",
    algorithm: "str | None" = None,
    variant: "str | None" = None,
) -> FaultPlan:
    """master_flap with persistence enabled (a shared snapshot+journal
    backend): the master's etcd view browns out past the lock TTL, it
    steps down CLEANLY (terminal journal marker), and the standby that
    wins the lock restores the full lease table instead of relearning.
    Expect: a `restore` event with mode=warm and a complete journal,
    learning mode skipped for the restored resource (the cold path
    would relearn for `learning_mode_duration` = 10 ticks), restored
    grants never above capacity (the `restore_capacity` invariant), and
    reconvergence within 2 ticks of the heal — the budget that makes
    warm takeover observable: it is 1/5th of the learning window the
    cold path would need before serving real grants again.

    `algorithm`/`variant` parametrize the scenario over the fairness
    portfolio (PLANS ships one per lane): the restore/learning-mode
    decisions and the reconvergence SLO are algorithm-independent
    CONTRACTS, so every lane must meet the same budgets — and each
    parametrization's event log is pinned deterministic per kind by
    tests/test_chaos_smoke.py."""
    setup_extra = {}
    if algorithm is not None:
        setup_extra["algorithm"] = algorithm
    if variant is not None:
        setup_extra["algorithm_variant"] = variant
    return FaultPlan(
        name=name,
        seed=5,
        setup=setup_extra | {
            "servers": 2,
            "clients": 3,
            "wants": [20.0, 30.0, 60.0],
            "capacity": 100,
            "mode": "immediate",
            "lease_length": 60,
            "refresh_interval": 1,
            # Long enough that a cold takeover visibly eats the plan's
            # reconvergence budget; the warm path must not need it.
            "learning_mode_duration": 10,
            "election_ttl": 3.0,
            "persist": True,
            "snapshot_interval": 3.0,
        },
        events=[
            FaultEvent(at_tick=13, kind="kv_drop", target="s0",
                       duration_ticks=5),
        ],
        # The initial (cold, empty-backend) learning window is 10 ticks;
        # the baseline snapshot must land after it.
        warmup_ticks=13,
        total_ticks=26,
        reconverge_ticks=2,
    )


def client_storm() -> FaultPlan:
    """A refresh storm from a swarm of low-band clients against an
    admission-enabled master. Three baseline clients sit in three
    priority bands on a PRIORITY_BANDS resource; at the storm tick, 20
    extra band-0 clients start hammering refreshes every tick — an
    offered load ~8x the controller's max_rps budget. Expect: the
    hard per-window cap sheds most of the swarm in its very first
    window (before the AIMD level has a boundary to move at), the
    level then collapses and band probabilities extinguish bottom-up
    (band 0 first, band 1 next, the top band NEVER — the goodput-floor
    invariant), baseline allocations ride through byte-unchanged (shed
    refreshes retain leases; the admitted slice of the swarm only gets
    band-0 leftovers under PRIORITY_BANDS), the swarm's releases at
    heal all pass (releases-never-shed), and post-heal additive
    recovery readmits every band with ticks to spare inside the
    reconverge budget."""
    return FaultPlan(
        name="client_storm",
        seed=6,
        setup={
            "servers": 1,
            "clients": 3,
            "wants": [20.0, 30.0, 40.0],
            # Wire priorities: c0 is the top band the floor protects.
            "priorities": [2, 1, 0],
            "capacity": 100,
            "algorithm": "PRIORITY_BANDS",
            "mode": "immediate",
            "lease_length": 60,
            "refresh_interval": 1,
            "learning_mode_duration": 0,
            "election_ttl": 3.0,
            # One admit window per tick; 10 rps against 3 rps of
            # baseline traffic — the swarm alone trips the budget.
            "admission": {"max_rps": 10.0, "window": 1.0},
        },
        events=[
            FaultEvent(at_tick=8, kind="client_storm",
                       duration_ticks=6,
                       params={"clients": 20, "wants": 10.0,
                               "priority": 0}),
        ],
        warmup_ticks=8,
        total_ticks=28,
        reconverge_ticks=12,
    )


def shard_partition() -> FaultPlan:
    """Federated root tier: three shards (per-shard election locks, one
    master each), one straddling resource r0 (capacity 90) whose shares
    reconcile POP-style every tick, one client per shard (wants
    30/30/60: overloaded, so shares sit at the demand-proportional
    22.5/22.5/45). At the fault tick, shard s1 partitions from the
    reconciler: its share stops renewing, coasts to its ttl, then the
    shard decays to ZERO capacity — its client degrades (the plan's
    `degraded` marker). Blast radius is the invariant: the other
    shards' clients ride through byte-unchanged (shard_blast_radius),
    and Σ shard grants never exceeds 90 on any tick, because the lost
    shard's frozen share stays charged against the pool through its
    drain window (fed_capacity_sum — POP's reconciliation safety).
    At heal the reconciler reaches s1 again, re-grants its share, and
    the allocation reconverges to baseline within budget."""
    return FaultPlan(
        name="shard_partition",
        seed=7,
        setup={
            "servers": 3,
            "federated": {
                "shards": 3,
                "straddle": ["r0"],
                "share_ttl": 2.0,
                "client_shards": [0, 1, 2],
            },
            "clients": 3,
            "wants": [30.0, 30.0, 60.0],
            "capacity": 90,
            # Batch mode re-solves every store row each tick, so a
            # share shrink lands on ALL of a shard's grants the very
            # next tick — the pointwise capacity-sum bound needs no
            # refresh-ordering slack.
            "mode": "batch",
            "lease_length": 60,
            "refresh_interval": 1,
            "learning_mode_duration": 0,
            "election_ttl": 3.0,
        },
        events=[
            FaultEvent(at_tick=8, kind="shard_partition", target="s1",
                       duration_ticks=6),
        ],
        warmup_ticks=8,
        total_ticks=26,
        reconverge_ticks=6,
    )


def fleet_reshard_live() -> FaultPlan:
    """Live resharding 2→3→2 over a provisioned pool of four shards.

    The fleet controller serves the straddling r0 (capacity 120) from
    an ACTIVE set of two shards; one client per active shard (wants
    30/20 — underloaded, so the steady state is wants-granted). At tick
    8 the active set grows to three: the new shard enters the beat
    with an empty summary and receives an even slack split — nothing
    restarts, no rows move. At tick 16 it shrinks back: shard 2 leaves
    the active set, its share freezes (charged against the pool) and
    drains through expiry + lease length. The acceptance is lease
    continuity: both clients' grants are byte-unchanged through BOTH
    handoffs, and Σ shard grants ≤ 120 holds pointwise on every tick
    (fed_capacity_sum) — the frozen-share drain is exactly what makes
    the shrink direction safe. Batch mode, so share changes land on
    all of a shard's grants the very next tick."""
    return FaultPlan(
        name="fleet_reshard_live",
        seed=17,
        setup={
            "servers": 4,
            "federated": {
                "fleet": True,
                "active": 2,
                "straddle": ["r0"],
                "share_ttl": 2.0,
                "client_shards": [0, 1],
            },
            "clients": 2,
            "wants": [30.0, 20.0],
            "capacity": 120,
            "mode": "batch",
            "lease_length": 60,
            "refresh_interval": 1,
            "learning_mode_duration": 0,
            "election_ttl": 3.0,
        },
        events=[
            FaultEvent(at_tick=8, kind="fleet_reshard",
                       duration_ticks=0, params={"to": 3}),
            FaultEvent(at_tick=16, kind="fleet_reshard",
                       duration_ticks=0, params={"to": 2}),
        ],
        warmup_ticks=8,
        total_ticks=26,
        reconverge_ticks=4,
    )


def fleet_reshard_partition() -> FaultPlan:
    """A reshard landing in the middle of a shard partition.

    Three provisioned shards, two active, one client on each (wants
    30/30 against capacity 90). Shard 1 partitions from the beat at
    tick 8; while its share is still frozen, the fleet grows to three
    at tick 10 — the reconciler must split the UNFROZEN remainder
    between the live shards, keeping s1's frozen share charged, so
    Σ grants ≤ 90 holds pointwise through the overlap of partition and
    reshard. s1's client degrades as its shard's capacity decays (the
    plan's degraded marker); s0's client rides through byte-unchanged
    (shard_blast_radius). At heal the beat reaches s1 again, re-grants
    its share, and allocations reconverge within budget."""
    return FaultPlan(
        name="fleet_reshard_partition",
        seed=18,
        setup={
            "servers": 3,
            "federated": {
                "fleet": True,
                "active": 2,
                "straddle": ["r0"],
                "share_ttl": 2.0,
                "client_shards": [0, 1],
            },
            "clients": 2,
            "wants": [30.0, 30.0],
            "capacity": 90,
            "mode": "batch",
            "lease_length": 60,
            "refresh_interval": 1,
            "learning_mode_duration": 0,
            "election_ttl": 3.0,
        },
        events=[
            FaultEvent(at_tick=8, kind="shard_partition", target="s1",
                       duration_ticks=6),
            FaultEvent(at_tick=10, kind="fleet_reshard",
                       duration_ticks=0, params={"to": 3}),
        ],
        warmup_ticks=8,
        total_ticks=28,
        reconverge_ticks=8,
    )


def grant_corruption() -> FaultPlan:
    """The shadow-oracle audit's proving ground: a batch server under
    steady overload (FAIR_SHARE, wants 110 vs capacity 100, so the
    waterfill output is constant) has one row of its solve output
    silently scaled by 0.75 for nine ticks. The corruption shrinks a
    grant, so every structural invariant (capacity conservation,
    has <= wants, band floors) still passes — only the bit-identity
    audit can see it. With the auditor sampling every 3 ticks inline,
    the corrupted store value is constant across consecutive samples,
    the two-strike identical-digest rule confirms at the second sample,
    and the divergence lands within 2K ticks of the fault —
    deterministically, byte-stable across replays. After heal the
    solve output reverts and allocation reconverges within budget; the
    verdict's audit block pins the divergence count and the offending
    resource."""
    return FaultPlan(
        name="grant_corruption",
        seed=11,
        setup={
            "servers": 1,
            "clients": 3,
            "wants": [20.0, 30.0, 60.0],
            "capacity": 100,
            # Has-independent lane: under constant overload the
            # waterfill's output never moves, so the corrupted store
            # value is digest-stable across audit samples.
            "algorithm": "FAIR_SHARE",
            # Python-store batch path: prepare -> solve -> apply over
            # every resource each tick, so the corrupted solve output
            # lands in the store the same tick (no delivery lag to
            # reason about) and the audit sees it immediately.
            "mode": "batch",
            "native_store": False,
            "lease_length": 60,
            "refresh_interval": 1,
            "learning_mode_duration": 0,
            "election_ttl": 3.0,
            # Shadow audit every 3 ticks, comparisons inline so the
            # event log is byte-stable.
            "audit_sample": 3,
        },
        events=[
            FaultEvent(at_tick=10, kind="grant_corrupt", target="s0",
                       duration_ticks=9,
                       params={"row": 0, "factor": 0.75}),
        ],
        warmup_ticks=8,
        total_ticks=32,
        reconverge_ticks=8,
    )


def frontend_worker_crash() -> FaultPlan:
    """Serving-plane crash arc: a batch master with an inline frontend
    pool (2 listener workers over per-worker push rings) serves four
    WatchCapacity stream clients next to three refresh clients. At the
    fault tick, worker 0 dies for four ticks: every stream it held ends
    with a mastership redirect THAT TICK (reset-to-redirect — never a
    silent lapse), the dead worker's stream shards reassign to the
    survivor, and the clients' next stream_step chases the redirect and
    re-establishes — landing on worker 1, where pushes resume. At heal
    the worker restarts with a FRESH ring cursor (no frame replay;
    resume rides the push-seq contract) and new establishments home
    back to it. Base allocations ride through byte-unchanged — the
    serving plane is fanout only, the tick process never stopped
    deciding — and the event log (crash, redirects, re-establishes,
    restore) replays byte-identically."""
    return FaultPlan(
        name="frontend_worker_crash",
        seed=12,
        setup={
            "servers": 1,
            "clients": 3,
            "wants": [20.0, 30.0, 60.0],
            "capacity": 100,
            "mode": "batch",
            "lease_length": 60,
            "refresh_interval": 1,
            "learning_mode_duration": 0,
            "election_ttl": 3.0,
            "streams": 4,
            "stream_shards": 4,
            "frontend_workers": 2,
        },
        events=[
            FaultEvent(at_tick=8, kind="worker_crash", target="s0",
                       duration_ticks=4, params={"worker": 0}),
        ],
        warmup_ticks=8,
        total_ticks=24,
        reconverge_ticks=8,
    )


def frontend_ring_stall() -> FaultPlan:
    """Serving-plane stall arc: same topology as the crash plan, but
    worker 0's ring pump freezes for ten ticks over a deliberately tiny
    ring (256 bytes). The tick edge keeps publishing (appends never
    block — backpressure is the reader's problem, frontend/ring.py), so
    the frozen reader is lapped; at resume the pump detects the lap and
    resets EVERY stream the worker held to a redirect — the loud
    failure mode the ring is designed for, instead of silently missing
    pushes. Clients chase the redirect and re-establish; the survivor's
    streams never notice."""
    return FaultPlan(
        name="frontend_ring_stall",
        seed=13,
        setup={
            "servers": 1,
            "clients": 3,
            "wants": [20.0, 30.0, 60.0],
            "capacity": 100,
            "mode": "batch",
            "lease_length": 60,
            "refresh_interval": 1,
            "learning_mode_duration": 0,
            "election_ttl": 3.0,
            "streams": 4,
            "stream_shards": 4,
            "frontend_workers": 2,
            # Small enough that a ten-tick stall laps the frozen reader
            # (beats + per-tick lease-refresh pushes), but with headroom
            # for a healthy tick's establishment snapshots.
            "frontend_ring": 512,
        },
        events=[
            FaultEvent(at_tick=8, kind="ring_stall", target="s0",
                       duration_ticks=10, params={"worker": 0}),
        ],
        warmup_ticks=8,
        total_ticks=28,
        reconverge_ticks=8,
    )


def _warm_variant(name, algorithm, variant):
    def build():
        return master_flap_warm(
            name=name, algorithm=algorithm, variant=variant
        )

    return build


PLANS: Dict[str, "callable"] = {
    "master_flap": master_flap,
    "master_flap_warm": master_flap_warm,
    # The warm-takeover arc across the fairness portfolio: same faults,
    # same reconvergence budget, one plan per algorithm lane
    # (FAIR_SHARE rides the plain fair-share plan below).
    "master_flap_warm_fair": _warm_variant(
        "master_flap_warm_fair", "FAIR_SHARE", None
    ),
    "master_flap_warm_maxmin": _warm_variant(
        "master_flap_warm_maxmin", "FAIR_SHARE", "maxmin"
    ),
    "master_flap_warm_balanced": _warm_variant(
        "master_flap_warm_balanced", "FAIR_SHARE", "balanced"
    ),
    "master_flap_warm_logutil": _warm_variant(
        "master_flap_warm_logutil", "PROPORTIONAL_SHARE", "logutil"
    ),
    "client_storm": client_storm,
    "etcd_brownout": etcd_brownout,
    "fleet_reshard_live": fleet_reshard_live,
    "fleet_reshard_partition": fleet_reshard_partition,
    "frontend_worker_crash": frontend_worker_crash,
    "frontend_ring_stall": frontend_ring_stall,
    "grant_corruption": grant_corruption,
    "device_tunnel_outage": device_tunnel_outage,
    "intermediate_partition": intermediate_partition,
    "shard_partition": shard_partition,
}


def get_plan(name: str) -> FaultPlan:
    try:
        return PLANS[name]()
    except KeyError:
        raise KeyError(
            f"unknown plan {name!r}; shipped plans: {sorted(PLANS)}"
        ) from None
