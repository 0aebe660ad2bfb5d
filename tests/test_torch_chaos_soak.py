"""Long chaos soaks on the port (marked slow, as
tests/test_chaos_soak.py is; tier-1 runs tests/test_torch_chaos_smoke.py
instead).

The shipped plans stretched to several fault/heal cycles and a longer
post-heal tail, on the port's ChaosRunner with device="cpu": every
invariant holds across repeated injections, determinism survives the
longer trajectory, and each stretched run's log equals the reference's.
"""

import asyncio
import dataclasses

import pytest

import tests.conftest  # noqa: F401
import tests._torch_threads  # noqa: F401

from doorman_tpu.chaos import get_plan as j_get_plan
from doorman_tpu_torch.chaos import ChaosRunner, get_plan
from doorman_tpu_torch.chaos.plans import PLANS

pytestmark = pytest.mark.slow
from tests._chaos_ref import RefChaosRunner as JChaosRunner


def _stretched(get, name, cycles=3):
    """Repeat the plan's fault burst `cycles` times, spaced a full
    heal-plus-reconverge apart, with a long settled tail."""
    plan = get(name)
    span = (plan.heal_tick - plan.warmup_ticks) + plan.reconverge_ticks + 4
    events = []
    for c in range(cycles):
        for ev in plan.events:
            events.append(dataclasses.replace(
                ev, at_tick=ev.at_tick + c * span
            ))
    last_heal = max(ev.at_tick + ev.duration_ticks for ev in events)
    return dataclasses.replace(
        plan,
        events=events,
        total_ticks=last_heal + plan.reconverge_ticks + 6,
    )


def _port(plan):
    return asyncio.run(ChaosRunner(plan, device="cpu").run())


@pytest.mark.parametrize("name", sorted(PLANS))
def test_soak_repeated_fault_cycles(name):
    verdict = _port(_stretched(get_plan, name))
    assert verdict["violations"] == [], verdict["event_log"]
    assert verdict["ok"], verdict
    ref = asyncio.run(JChaosRunner(_stretched(j_get_plan, name)).run())
    assert verdict["log_sha256"] == ref["log_sha256"]


def test_soak_determinism():
    plan = _stretched(get_plan, "master_flap")
    assert _port(plan)["log_sha256"] == _port(plan)["log_sha256"]
