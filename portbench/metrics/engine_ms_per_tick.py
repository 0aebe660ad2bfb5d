"""engine_ms_per_tick: the resident solver engine's share of a tick
(solver/engine.py, resident.py): its config, rebuild, staging, fused,
upload, solve, download and delta laps over the window, per tick."""

ENGINE = ("config", "rebuild", "staging", "fused", "upload", "solve",
          "download", "delta")


def read(run):
    if not run.get("ticks"):
        return None
    return sum(run["phases"].get(k, 0.0) for k in ENGINE) / run["ticks"] * 1e3
