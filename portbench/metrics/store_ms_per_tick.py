"""store_ms_per_tick: the native store's share of a tick: the resident
engine's sweep, drain, pack and apply laps (`phase_s`) over the window,
per tick."""

STORE = ("sweep", "drain", "pack", "apply")


def read(run):
    if not run.get("ticks"):
        return None
    return sum(run["phases"].get(k, 0.0) for k in STORE) / run["ticks"] * 1e3
