"""refreshes_per_s: every refresh the window re-apportioned (ingested,
ticked and flushed into the store) over all of the window's seconds."""

from portbench.measure import stats


def read(run):
    if "refreshes" not in run:
        return None
    return stats.rate(run["refreshes"], run["window_s"])
