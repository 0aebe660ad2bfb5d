"""k1_roofline: the least time the published peaks (3.35 TB/s, 67
TFLOP/s f32) allow for the K1 work the window's ticks needed (every lane
row each iteration refreshed, counted by the frozen `_bytes` / `_ops`),
over the profiler's device time of K1 and K2 in the window."""

from portbench.measure import roofline

LABELS = ("K1", "K2")


def _parts(run):
    tr, work = run.get("trace"), run.get("k1_work")
    if not tr or not work:
        return None
    device_s = sum(tr["kernels"].get(k, {}).get("sum_s", 0.0) for k in LABELS)
    if device_s <= 0:
        return None
    return roofline.bound_s(*work), device_s


def read(run):
    parts = _parts(run)
    return None if parts is None else 100.0 * parts[0][0] / parts[1]


def note(run):
    parts = _parts(run)
    return None if parts is None else f"bound by {parts[0][1]}"
