"""tree_tick_ms_per_tick: every server's `server.tick` (the datacenters',
the regions' and the root's), summed over the window, per iteration."""

from portbench.measure import spans


def read(run):
    return spans.ms_per_iteration(run, "server.tick")
