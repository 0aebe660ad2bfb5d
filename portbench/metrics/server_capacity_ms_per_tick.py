"""server_capacity_ms_per_tick: the root's and the regions'
GetServerCapacity handlers (`server.GetServerCapacity`: a decide per
downstream server and band), summed over the window, per iteration."""

from portbench.measure import spans


def read(run):
    return spans.ms_per_iteration(run, "server.GetServerCapacity")
