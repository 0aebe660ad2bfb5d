"""device_idle_pct.tick: 100 less the share of the window in which the
card ran a kernel, a copy or a memset (the union of their intervals in
the profiler's trace), in the churn cells."""


def read(run):
    tr = run.get("trace")
    if not tr or tr["busy_s"] <= 0 or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
