"""unlapped_ms_per_tick: host time a tick spends outside every solver
lap: the window's tick walls (and its closing flush) less the sum of all
`phase_s` laps, per tick. The flight recorder's digest and the tick's
other bookkeeping land here."""


def read(run):
    if not run.get("ticks"):
        return None
    walls = sum(run["tick_walls"]) + run["flush_s"]
    return (walls - sum(run["phases"].values())) / run["ticks"] * 1e3
