"""Offline history tooling: query and export a server's durable
flight-record history (obs/history.py) without the server.

    python -m doorman_tpu_torch.cmd.obs status --history-dir DIR
    python -m doorman_tpu_torch.cmd.obs query  --history-dir DIR \
        [--start N] [--end N] [--tier F] [--field wall_ms ...] [--out F]
    python -m doorman_tpu_torch.cmd.obs export --history-dir DIR --out trace.json
    python -m doorman_tpu_torch.cmd.obs delta  --history-dir DIR \
        --field wall_ms [--q 0.5]
    python -m doorman_tpu_torch.cmd.obs detect --history-dir DIR \
        [--field wall_ms ...] [--threshold Z]

`query` prints records (raw ring or a decimated tier) as JSON; `export`
writes the Chrome-trace overlay (drop into Perfetto next to a live
/debug/traces capture); `delta` prints the restart-spanning run delta
for one field (the TrajectoryComparator question — "did this deploy
make ticks slower?" — answered from segments alone); `detect` replays
the history through the anomaly detector (obs/detect.py) and prints
its machine-readable report. The store is opened read-mostly: opening
bumps the run counter in memory but writes nothing until an append, so
pointing this tool at a live server's directory is safe.
"""

from __future__ import annotations

import argparse
import json
import sys

from doorman_tpu_torch.utils import flagenv


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="doorman-obs",
        description="query/export a durable flight-record history",
    )
    sub = p.add_subparsers(dest="command", required=True)

    def common(sp):
        sp.add_argument("--history-dir", required=True,
                        help="the server's --history-dir")
        sp.add_argument("--ring", type=int, default=65536,
                        help="raw records to hold while reading "
                             "(bound memory on huge histories)")
        sp.add_argument("--out", default="",
                        help="write output here instead of stdout")

    sp = sub.add_parser("status", help="store summary: runs, "
                                       "occupancy, segments, tiers")
    common(sp)

    sp = sub.add_parser("query", help="records as JSON")
    common(sp)
    sp.add_argument("--start", type=int, default=None,
                    help="lowest hseq to include")
    sp.add_argument("--end", type=int, default=None,
                    help="highest hseq to include")
    sp.add_argument("--tier", type=int, default=0,
                    help="0 = raw ring; else a decimation factor "
                         "(default tiers: 10, 100)")
    sp.add_argument("--field", action="append", default=None,
                    help="project to these fields (repeatable)")

    sp = sub.add_parser("export", help="Chrome-trace overlay of the "
                                       "raw ring (Perfetto-loadable)")
    common(sp)

    sp = sub.add_parser("delta", help="restart-spanning run delta "
                                      "for one field")
    common(sp)
    sp.add_argument("--field", required=True)
    sp.add_argument("--q", type=float, default=0.5,
                    help="quantile to compare across runs")

    sp = sub.add_parser("detect", help="replay the history through "
                                       "the anomaly detector")
    common(sp)
    sp.add_argument("--field", action="append", default=None,
                    help="fields to watch (default: the server set)")
    sp.add_argument("--threshold", type=float, default=6.0)
    sp.add_argument("--window", type=int, default=64)
    return p


def _open(args):
    from doorman_tpu_torch.obs.history import HistoryStore

    return HistoryStore(args.history_dir, ring=args.ring, component="cli")


def _emit(args, text: str) -> None:
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
            if not text.endswith("\n"):
                f.write("\n")
    else:
        sys.stdout.write(text)
        if not text.endswith("\n"):
            sys.stdout.write("\n")


def run(args: argparse.Namespace) -> int:
    store = _open(args)
    try:
        if args.command == "status":
            st = store.status()
            st["runs"] = store.runs()
            _emit(args, json.dumps(st, indent=2, default=str))
            return 0
        if args.command == "query":
            view = store.view(
                start=args.start,
                end=args.end,
                tier=args.tier,
                fields=args.field,
            )
            _emit(args, json.dumps(view, indent=1, default=str))
            return 0
        if args.command == "export":
            _emit(args, store.chrome())
            return 0
        if args.command == "delta":
            delta = store.run_delta(args.field, q=args.q)
            if delta is None:
                _emit(args, json.dumps({
                    "field": args.field,
                    "error": "need data from two runs "
                             "(has this history survived a restart?)",
                }, indent=2))
                return 1
            _emit(args, json.dumps(delta, indent=2))
            return 0
        if args.command == "detect":
            from doorman_tpu_torch.obs.detect import (
                DEFAULT_FIELDS,
                AnomalyDetector,
            )

            report = AnomalyDetector.scan_records(
                store.records(),
                tuple(args.field) if args.field else DEFAULT_FIELDS,
                threshold=args.threshold,
                window=args.window,
            )
            _emit(args, json.dumps(report, indent=2, default=str))
            return 0
        raise AssertionError(f"unhandled command {args.command!r}")
    finally:
        store.close()


def main(argv=None) -> None:
    parser = make_parser()
    flagenv.populate(parser)
    args = parser.parse_args(argv)
    raise SystemExit(run(args))


if __name__ == "__main__":
    main()
