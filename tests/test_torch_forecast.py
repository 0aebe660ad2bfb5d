"""The seasonal forecaster in the port (doorman_tpu_torch/workload/
forecast.py), against the reference on the CPU.

The port's step is torch ops on an explicit device; here it runs on
device="cpu". It must equal, bit for bit (f32 words compared as
uint32), the port's numpy oracle, the reference's numpy `host_step` and
the reference's jitted JAX step (JAX on the CPU), on seeded streams —
the gains are dyadic, so every product is exact and no tolerance is
needed. Mirrors tests/test_forecast.py's invariants on the port: the
constant fixpoint, the observed envelope, the dyadic-gain check, the
status accounting and the warm start. The engines: "auto" and "device"
resolve to the card and raise without a GPU unless device="cpu" is
passed (the reference's "auto" drops to the host without jax; the port
does not drop on its own).
"""

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401

from doorman_tpu.workload import forecast as jfc
from doorman_tpu_torch.workload import forecast as fc

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st

    HAVE_HYPOTHESIS = True
except ImportError:  # pragma: no cover - optional dependency
    HAVE_HYPOTHESIS = False


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _stream(series, ticks, seed, lo=0.0, hi=100.0):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, (ticks, series)).astype(np.float32)


def flash_crowd_rates(ticks=60, period=16):
    """The flash-crowd scenario's predictive config
    (doorman_tpu/workload/scenarios.py:260-289): two bands, 6 band-1
    base clients at 10/s each, a 24-client band-0 crowd for 4 ticks
    every `period` ticks from tick 8."""
    xs = np.zeros((ticks, 2), np.float32)
    xs[:, 1] = 60.0
    for t in range(ticks):
        if t >= 8 and (t - 8) % period < 4:
            xs[t, 0] = 240.0
    return xs


@pytest.mark.parametrize("series,period,alpha,beta,seed", [
    (4, 8, 0.5, 0.25, 42),
    (2, 16, 0.25, 0.5, 1),
    (7, 3, 1.0, 0.0, 9),
    (1, 1, 0.125, 1.0, 3),
])
def test_device_step_is_bit_identical_to_the_host_oracle(
    series, period, alpha, beta, seed
):
    xs = _stream(series, 200, seed)
    host = fc.SeasonalForecaster(series, period, alpha=alpha, beta=beta,
                                 engine="host")
    dev = fc.SeasonalForecaster(series, period, alpha=alpha, beta=beta,
                                engine="device", device="cpu")
    for t in range(xs.shape[0]):
        h = host.observe(xs[t])
        d = dev.observe(xs[t])
        assert h.dtype == np.float32 and d.dtype == np.float32
        np.testing.assert_array_equal(_bits(h), _bits(d),
                                      err_msg=f"tick {t}")
    for a, b in zip(host.state(), dev.state()):
        np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("case", ["uniform", "flash_crowd"])
def test_device_step_equals_the_reference_host_step_and_jax_step(case):
    """Three implementations, one stream: the port's torch step, the
    reference's numpy oracle and the reference's jitted JAX step."""
    if case == "uniform":
        series, period, alpha, beta = 3, 6, 0.5, 0.25
        xs = _stream(series, 120, 17, lo=-20.0, hi=500.0)
    else:
        series, period, alpha, beta = 2, 16, 0.25, 0.5
        xs = flash_crowd_rates()
    port = fc.SeasonalForecaster(series, period, alpha=alpha, beta=beta,
                                 engine="device", device="cpu")
    ref_host = jfc.SeasonalForecaster(series, period, alpha=alpha,
                                      beta=beta, engine="host")
    ref_jax = jfc.SeasonalForecaster(series, period, alpha=alpha,
                                     beta=beta, engine="device")
    for t in range(xs.shape[0]):
        p = port.observe(xs[t])
        h = ref_host.observe(xs[t])
        j = ref_jax.observe(xs[t])
        np.testing.assert_array_equal(_bits(p), _bits(h),
                                      err_msg=f"tick {t}")
        np.testing.assert_array_equal(_bits(p), _bits(j),
                                      err_msg=f"tick {t}")
    for a, b in zip(port.state(), ref_host._state):
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_host_step_equals_the_reference_oracle():
    state_t = fc.init_state(5, 7)
    state_j = jfc.init_state(5, 7)
    xs = _stream(5, 50, 23)
    for t in range(xs.shape[0]):
        state_t, ft = fc.host_step(state_t, xs[t], t % 7, (t + 1) % 7,
                                   0.5, 0.25)
        state_j, fj = jfc.host_step(state_j, xs[t], t % 7, (t + 1) % 7,
                                    0.5, 0.25)
        np.testing.assert_array_equal(_bits(ft), _bits(fj))
    for a, b in zip(state_t, state_j):
        np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("engine", ["host", "device"])
def test_constant_traffic_is_an_exact_fixpoint(engine):
    f = fc.SeasonalForecaster(2, 4, engine=engine, device="cpu")
    x = np.asarray([7.0, 0.0], np.float32)
    for _ in range(40):
        out = f.observe(x)
    np.testing.assert_array_equal(out, x)


def test_forecast_stays_inside_the_observed_envelope():
    rng = np.random.default_rng(3)
    f = fc.SeasonalForecaster(3, 5, engine="device", device="cpu")
    lo = np.full(3, np.inf, np.float32)
    hi = np.full(3, -np.inf, np.float32)
    for _ in range(200):
        x = rng.uniform(-50.0, 50.0, 3).astype(np.float32)
        lo, hi = np.minimum(lo, x), np.maximum(hi, x)
        out = f.observe(x)
        assert (out >= lo).all() and (out <= hi).all()


def test_non_dyadic_gains_are_rejected():
    with pytest.raises(ValueError, match="power of two"):
        fc.SeasonalForecaster(1, 4, alpha=0.3, device="cpu")
    with pytest.raises(ValueError, match="power of two"):
        fc.SeasonalForecaster(1, 4, beta=0.75, device="cpu")
    with pytest.raises(ValueError, match="engine"):
        fc.SeasonalForecaster(1, 4, engine="gpu", device="cpu")
    fc.SeasonalForecaster(1, 4, alpha=0.125, beta=1.0, device="cpu")


def test_status_and_tick_accounting():
    f = fc.SeasonalForecaster(2, 4, engine="device", device="cpu")
    for t in range(9):
        f.observe(np.asarray([float(t), 1.0], np.float32))
    s = f.status()
    assert s["ticks_observed"] == 9 and s["period"] == 4
    assert s["engine"] == "device" and s["device"] == "cpu" and s["seen"]
    h = fc.SeasonalForecaster(2, 4, engine="host")
    for t in range(9):
        h.observe(np.asarray([float(t), 1.0], np.float32))
    hs = h.status()
    assert {k: v for k, v in hs.items() if k not in ("engine", "device")} \
        == {k: v for k, v in s.items() if k not in ("engine", "device")}
    with pytest.raises(ValueError, match="rates"):
        f.observe(np.zeros(3, np.float32))


@pytest.mark.parametrize("engine", ["auto", "device"])
def test_device_engines_run_on_cuda_and_on_the_cpu_only_when_asked(engine):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            fc.SeasonalForecaster(2, 4, engine=engine)
    f = fc.SeasonalForecaster(2, 4, engine=engine, device="cpu")
    assert f.engine == "device" and f.device == torch.device("cpu")
    # The host oracle needs no device at all.
    assert fc.SeasonalForecaster(2, 4, engine="host").device is None


if HAVE_HYPOTHESIS:

    @settings(max_examples=40, deadline=None)
    @given(
        xs=st.lists(
            st.floats(min_value=0.0, max_value=1e6, allow_nan=False,
                      allow_infinity=False, width=32),
            min_size=1, max_size=60,
        ),
        period=st.integers(min_value=1, max_value=12),
    )
    def test_envelope_and_oracle_hold_for_any_stream(xs, period):
        dev = fc.SeasonalForecaster(1, period, engine="device",
                                    device="cpu")
        host = fc.SeasonalForecaster(1, period, engine="host")
        seen = []
        for x in xs:
            seen.append(np.float32(x))
            arr = np.asarray([x], np.float32)
            out = dev.observe(arr)
            np.testing.assert_array_equal(_bits(out),
                                          _bits(host.observe(arr)))
            assert min(seen) <= out[0] <= max(seen)

    @settings(max_examples=40, deadline=None)
    @given(
        x=st.floats(min_value=0.0, max_value=1e6, allow_nan=False,
                    allow_infinity=False, width=32),
        period=st.integers(min_value=1, max_value=8),
        ticks=st.integers(min_value=1, max_value=40),
    )
    def test_constant_fixpoint_holds_for_any_rate(x, period, ticks):
        f = fc.SeasonalForecaster(1, period, engine="device",
                                  device="cpu")
        arr = np.asarray([x], np.float32)
        out = arr
        for _ in range(ticks):
            out = f.observe(arr)
        np.testing.assert_array_equal(out, arr)


def test_warm_start_is_bit_identical_to_online_feeding():
    from doorman_tpu_torch.obs.history import HistoryStore

    hist = HistoryStore(ring=64, clock=lambda: 0.0)
    offered = [0.0, 3.0, 17.0, 4.0, 9.0, 9.0, 2.0, 30.0]
    for i, v in enumerate(offered):
        hist.append({"tick": i, "offered": v})
    warm = fc.SeasonalForecaster(2, 4, engine="device", device="cpu")
    fed = warm.warm_start(hist, interval=2.0)
    assert fed == len(offered) == warm.ticks_observed
    live = fc.SeasonalForecaster(2, 4, engine="host")
    for v in offered:
        live.observe(np.full(2, np.float32(v / 2.0), np.float32))
    for w, l in zip(warm.state(), live.state()):
        np.testing.assert_array_equal(_bits(w), _bits(l))
    nxt = np.asarray([5.0, 6.0], np.float32)
    np.testing.assert_array_equal(_bits(warm.observe(nxt)),
                                  _bits(live.observe(nxt)))


def test_warm_start_accepts_scalars_and_skips_missing_fields():
    f = fc.SeasonalForecaster(1, 2, engine="device", device="cpu")
    fed = f.warm_start([1.0, {"offered": 2.0}, {"other": 9.0}, 3.0])
    assert fed == 3
    assert f.ticks_observed == 3


def test_forecast_feeds_the_controller_seam():
    """The forecaster's output is what `AimdController.set_forecast`
    reads: the flash crowd's second cycle is forecast above the budget
    one tick before it arrives."""
    from doorman_tpu_torch.admission.controller import AimdController

    xs = flash_crowd_rates()
    f = fc.SeasonalForecaster(2, 16, alpha=0.25, beta=0.5,
                              engine="device", device="cpu")
    forecasts = [f.observe(x) for x in xs]
    # The forecast made at tick 23 is for tick 24, the crowd's second
    # arrival: the band-0 season has learned it.
    assert forecasts[23][0] > forecasts[22][0]
    ctl = AimdController(window=1.0, clock=lambda: 0.0, max_rps=12.0)
    ctl.set_forecast(float(forecasts[23].sum()))
    assert ctl.status()["forecast_rps"] == round(
        float(forecasts[23].sum()), 3)
