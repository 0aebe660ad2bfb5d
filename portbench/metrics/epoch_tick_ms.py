"""epoch_tick_ms: the mean `server.tick` of the datacenters' ticks that
solved their whole table because an install moved the config epoch
(arg `solve` "full:config-epoch"), over the window."""

from portbench.measure import spans

SOLVE = "full:config-epoch"


def read(run):
    dcs = set(run.get("dc_servers") or ())
    xs = spans.durations(run, "server.tick", lambda a: (
        a.get("solve") == SOLVE and a.get("server") in dcs))
    return sum(xs) / len(xs) * 1e3 if xs else None
