"""tick_ms_p95: the 95th percentile of the host clock around each
`tick_once` of the window, over all of them."""

from portbench.measure import stats


def read(run):
    v = stats.percentile(run.get("tick_walls", ()), 0.95)
    return None if v is None else v * 1e3
