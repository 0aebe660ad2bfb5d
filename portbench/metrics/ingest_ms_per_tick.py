"""ingest_ms_per_tick: mean host time of one iteration's `bulk_refresh`
(the native store taking the batch of refreshes)."""


def read(run):
    xs = run.get("ingest_s")
    if not xs:
        return None
    return sum(xs) / len(xs) * 1e3
