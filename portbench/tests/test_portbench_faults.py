"""A whole run at a size a test can hold (the port's plain versions on
the CPU), past the harness's look for a card: sound, it is correct; with
the control (the reference in bfloat16 put in the program's place) and
with each fault the cell can have planted under the timed path, the
comparison turns `correct` false. (The exchange between chips is not a
fault this one-chip cell can have.)"""

import copy
import json

import numpy as np
import pytest
import torch

from portbench import harness

CELL = "loadtest-1m.random_change"


def _tiny():
    """The cell's configuration at 8 resources of 40 clients, each
    capacity cut with its clients so that demand still runs at three
    times the capacity."""
    bench = harness.load_benchmark()
    cfg = harness.load_config(bench, "loadtest-1m")
    templates = copy.deepcopy(cfg["templates"])
    clients = 40
    for t in templates:
        t["capacity"] = t["capacity"] * clients / cfg["clients"]
    return {"resources": 8, "clients": clients, "templates": templates}


def _run(control=False, seconds=1.5, trace=False, device="cpu",
         seed=4_000_000_017):
    return harness.run_cell(CELL, seed, seconds, trace, t0=0.0,
                            device=device, config_over=_tiny(),
                            control=control)


def test_sound_run_is_correct_and_control_is_not():
    out = _run(control=True)
    assert out["correct"], out["check"]
    assert out["attempted"] > 0 and out["failed"] == 0
    limits = {k: v["limit"] for k, v in out["check"].items()}
    assert any(v > limits[k] for k, v in out["control"].items()), out
    json.dumps(out)  # the result line is JSON


def _unchanged(monkeypatch):
    from doorman_tpu_torch.server.server import CapacityServer

    async def tick_once(self):
        return None

    monkeypatch.setattr(CapacityServer, "tick_once", tick_once)


def _half(monkeypatch):
    """Half of every solve's rows left out: their grants come back 0."""
    from doorman_tpu_torch.solver import resident

    def cut(fn):
        def wrapped(*a, **k):
            out = fn(*a, **k).clone()
            out[out.shape[0] // 2:] = 0
            return out
        return wrapped

    monkeypatch.setattr(resident, "solve_dense_k1",
                        cut(resident.solve_dense_k1))


def _altered(monkeypatch):
    """One grant of every solve altered where it is produced."""
    from doorman_tpu_torch.solver import resident

    def bump(fn):
        def wrapped(*a, **k):
            out = fn(*a, **k).clone()
            out[0, 0] += 1.0
            return out
        return wrapped

    monkeypatch.setattr(resident, "solve_dense_k1",
                        bump(resident.solve_dense_k1))


FAULTS = {"state_unchanged": _unchanged, "half_left_out": _half,
          "answer_altered": _altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_turns_correct_false(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = _run()
    assert not out["correct"], out["check"]


@pytest.mark.card
def test_cell_on_the_card():
    """The kernels' path at a test's size (run on a machine with a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = _run(seconds=2.0, trace=True, device="cuda", seed=4_000_000_019)
    assert out["correct"], out["check"]
    assert out["device"]["busy_s"] > 0
    assert np.isfinite(out["metrics"]["k1_roofline"]["value"])
