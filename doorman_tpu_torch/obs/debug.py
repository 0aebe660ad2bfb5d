"""Debug HTTP server: /debug/status, /debug/resources, /debug/traces,
/metrics, /healthz — with a /debug index listing every route.

Capability parity with the reference's composable status page
(go/status/status.go:129-192 — named template "parts" contributed by any
subsystem, rendered on one page) and the per-lease resource table
(go/cmd/doorman/resourcez.go:62-172 — all resources, or one resource's
leases with ?resource=<id>).

The page handlers run on a plain threaded HTTP server; state is read from
the owning asyncio loop via run_coroutine_threadsafe when one is attached,
so reads are atomic with respect to the RPC handlers.
"""

from __future__ import annotations

import asyncio
import html
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional
from urllib.parse import parse_qs, urlparse

from doorman_tpu_torch.obs import metrics as metrics_mod
from doorman_tpu_torch.obs import trace as trace_mod

__all__ = ["DebugServer", "add_status_part", "status_parts"]

# Every route the handler serves, with a one-line description — the
# /debug index page renders this, so a new route only needs one entry
# here to be discoverable.
ROUTES = (
    ("/debug/status", "server overview: mastership, resources, config, "
                      "tick phase totals"),
    ("/debug/resources", "per-lease tables (?resource=<id> for one)"),
    ("/debug/requests", "recent RPC samples (?limit=N)"),
    ("/debug/admission", "admission control: AIMD level, per-band "
                         "admit probabilities, shed tallies, coalescing "
                         "windows (?format=json)"),
    ("/debug/frontend", "serving-plane pool: worker liveness, held "
                        "streams, ring publish/pump counters, control "
                        "surface tallies (?format=json)"),
    ("/debug/traces", "span tracer summary; ?format=chrome downloads a "
                      "Perfetto-loadable trace"),
    ("/debug/slo", "SLO verdicts per server (tick budget, RPC p99, "
                   "top-band goodput floor, restore staleness); "
                   "?format=json"),
    ("/debug/flightrec", "per-tick flight recorder: ring summary; "
                         "?format=json dumps the last N tick records, "
                         "?format=chrome the overlay trace"),
    ("/debug/history", "durable flight-record history: run/occupancy "
                       "summary; ?format=json dumps records "
                       "(&tier=F for a decimated tier, &start=/&end= "
                       "by hseq), ?format=chrome the overlay trace"),
    ("/debug/vars", "expvar-style JSON snapshot"),
    ("/metrics", "Prometheus text exposition"),
    ("/healthz", "liveness probe"),
)

_parts_lock = threading.Lock()
_parts: Dict[str, Callable[[], str]] = {}  # guarded-by: _parts_lock
# doorman: allow[seeded-determinism] process uptime is wall-clock by design
_start_time = time.time()


def add_status_part(name: str, fragment: Callable[[], str]) -> None:
    """Contribute a named HTML fragment to /debug/status
    (reference status.go:129-158). The callable runs at page-render time."""
    with _parts_lock:
        _parts[name] = fragment


def status_parts() -> List[str]:
    with _parts_lock:
        items = sorted(_parts.items())
    out = []
    for name, fragment in items:
        try:
            out.append(f"<h2>{html.escape(name)}</h2>\n{fragment()}")
        except Exception as e:  # one broken part must not kill the page
            out.append(
                f"<h2>{html.escape(name)}</h2>\n"
                f"<pre>error rendering part: {html.escape(str(e))}</pre>"
            )
    return out


_PAGE = """<!DOCTYPE html>
<html><head><title>{title}</title>
<style>
body {{ font-family: monospace; margin: 2em; }}
table {{ border-collapse: collapse; }}
th, td {{ border: 1px solid #999; padding: 2px 8px; text-align: left; }}
th {{ background: #eee; }}
.master {{ color: #070; }} .notmaster {{ color: #a00; }}
</style></head>
<body><h1>{title}</h1>
{body}
</body></html>"""


def _fmt_ts(ts: float) -> str:
    if ts <= 0:
        return "-"
    return time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(ts))


class DebugServer:
    """Serves the debug pages for zero or more CapacityServers."""

    def __init__(self, host: str = "", port: int = 0,
                 registry: Optional[metrics_mod.Registry] = None):
        self.registry = registry or metrics_mod.default_registry()
        self._servers: List[tuple] = []  # (capacity_server, loop-or-None)
        handler = self._make_handler()
        self._httpd = ThreadingHTTPServer((host or "", port), handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def add_server(self, server,
                   loop: Optional[asyncio.AbstractEventLoop] = None) -> None:
        """Expose a CapacityServer on the pages (resourcez.go:54). If a
        loop is given, its state is snapshotted on that loop."""
        self._servers.append((server, loop))

    def start(self) -> int:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="debug-http", daemon=True
        )
        self._thread.start()
        return self.port

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # ------------------------------------------------------------------

    def _call(self, loop, fn):
        """Run fn on the server's asyncio loop (atomic w.r.t. RPC handlers)
        when one is attached and running; else directly."""
        return metrics_mod.call_on_loop(loop, fn)

    def _snapshot(self, server, loop) -> dict:
        return self._call(loop, server.status)

    def _statuses(self) -> List[dict]:
        return [self._snapshot(s, l) for s, l in self._servers]

    def _status_page(self) -> str:
        sections = []
        for st in self._statuses():
            cls = "master" if st["is_master"] else "notmaster"
            rows = "".join(
                f"<tr><td>{html.escape(rid)}</td>"
                f"<td>{r['capacity']:g}</td>"
                f"<td>{html.escape(r['algorithm'])}</td>"
                f"<td>{r['sum_has']:g}</td>"
                f"<td>{r['sum_wants']:g}</td>"
                f"<td>{r['count']}</td>"
                f"<td>{'yes' if r['in_learning_mode'] else 'no'}</td></tr>"
                for rid, r in sorted(st["resources"].items())
            )
            sections.append(
                f"<h2>server {html.escape(st['id'])}</h2>"
                f"<p class={cls!r}>is_master: {st['is_master']}</p>"
                f"<p>current master: "
                f"{html.escape(st['current_master'] or '(unknown)')}<br>"
                f"election: {html.escape(st['election'])}<br>"
                f"mode: {html.escape(st['mode'])} | "
                f"backend: {html.escape(st.get('backend') or '(no tick yet)')} | "
                f"ticks: {st.get('ticks', 0)} "
                f"(idle: {st.get('idle_ticks', 0)}) | "
                f"last tick: {st.get('last_tick_ms', 0):g} ms</p>"
                + self._status_obs_line(st)
                + (
                    "<p>tick phases (total ms): "
                    + html.escape(
                        ", ".join(
                            f"{k}={v:g}"
                            for k, v in st["tick_phase_total_ms"].items()
                        )
                    )
                    + "</p>"
                    if st.get("tick_phase_total_ms")
                    else ""
                )
                + f"<table><tr><th>resource</th><th>capacity</th>"
                f"<th>algorithm</th><th>has</th>"
                f"<th>wants</th><th>subclients</th><th>learning</th></tr>"
                f"{rows}</table>"
                f"<h3>config</h3><pre>{html.escape(st['config'])}</pre>"
            )
        # doorman: allow[seeded-determinism] uptime display, wall-clock by design
        uptime = time.time() - _start_time
        body = (
            f"<p>uptime: {uptime:.0f}s</p>"
            + "".join(sections)
            + "".join(status_parts())
            + "<p><a href='/debug'>index</a> | "
            "<a href='/debug/resources'>resources</a> | "
            "<a href='/debug/requests'>requests</a> | "
            "<a href='/debug/traces'>traces</a> | "
            "<a href='/debug/slo'>slo</a> | "
            "<a href='/debug/flightrec'>flightrec</a> | "
            "<a href='/metrics'>metrics</a> | "
            "<a href='/debug/vars'>vars</a></p>"
        )
        return _PAGE.format(title="/debug/status", body=body)

    @staticmethod
    def _status_obs_line(st: dict) -> str:
        """Flight-recorder head/occupancy and the last SLO verdict on
        the status overview (the satellite surface: one glance says
        whether the black box is rolling and whether the SLOs hold)."""
        parts = []
        fr = st.get("flightrec")
        if fr:
            last = fr.get("last_dump")
            parts.append(
                f"flight recorder: head seq {fr.get('head_seq', 0)}, "
                f"ring {fr.get('occupancy', 0)}/{fr.get('capacity', 0)}"
                + (
                    f", last dump {html.escape(str(last.get('reason')))}"
                    if last
                    else ""
                )
                + " (<a href='/debug/flightrec'>flightrec</a>)"
            )
        slo = st.get("slo")
        if slo:
            failed = [
                v["slo"]
                for v in slo.get("verdicts", [])
                if v.get("status") == "fail"
            ]
            parts.append(
                "last SLO verdict: "
                + (
                    "pass"
                    if slo.get("ok")
                    else "FAIL (" + html.escape(", ".join(failed)) + ")"
                )
                + " (<a href='/debug/slo'>slo</a>)"
            )
        dispatch = st.get("dispatch")
        if dispatch:
            # The fused-tick launch-tax counters (cumulative; per-tick
            # deltas ride the flight recorder as dispatches/host_syncs).
            parts.append(
                f"fused tick: {'on' if st.get('fused_tick') else 'OFF'}"
                f" | dispatches: {dispatch.get('dispatches', 0)}"
                f", host syncs: {dispatch.get('host_syncs', 0)}"
            )
        scope = st.get("solve_scope") or {}
        live = {k: v for k, v in scope.items() if v}
        if live:
            # The churn-proportional solve at a glance: per path, the
            # last tick's mode (with the forced-full reason when the
            # scope escalated) and the compact scope it covered.
            def _fmt(name, s):
                mode = s.get("last_mode", "?")
                if mode == "full" and s.get("last_full_reason"):
                    mode = f"full:{s['last_full_reason']}"
                return (
                    f"{name} {mode}"
                    f" {s.get('last_scope_rows', 0)}r"
                    f"/{s.get('last_scope_resources', 0)}res"
                    f" frontier={s.get('frontier', 0)}"
                )
            parts.append(
                "solve scope: "
                + ("on" if st.get("scoped_solve") else "OFF")
                + " | "
                + ", ".join(_fmt(k, v) for k, v in sorted(live.items()))
            )
        return f"<p>{' | '.join(parts)}</p>" if parts else ""

    def _index_page(self) -> str:
        rows = "".join(
            f"<tr><td><a href={path!r}>{html.escape(path)}</a></td>"
            f"<td>{html.escape(desc)}</td></tr>"
            for path, desc in ROUTES
        )
        return _PAGE.format(
            title="/debug",
            body=f"<table><tr><th>route</th><th>what</th></tr>{rows}"
                 f"</table>",
        )

    def _traces_page(self) -> str:
        """Span tracer summary: per-(category, name) counts and totals,
        leaked (unclosed) spans, and the Chrome-export download link."""
        tracer = trace_mod.default_tracer()
        events = tracer.snapshot()
        by_key: Dict[tuple, List[float]] = {}
        for ev in events:
            by_key.setdefault((ev.cat, ev.name), []).append(ev.dur or 0.0)
        rows = "".join(
            f"<tr><td>{html.escape(cat or 'default')}</td>"
            f"<td>{html.escape(name)}</td>"
            f"<td>{len(durs)}</td>"
            f"<td>{sum(durs) / 1000.0:.3f}</td>"
            f"<td>{max(durs) / 1000.0:.3f}</td></tr>"
            for (cat, name), durs in sorted(by_key.items())
        )
        open_spans = tracer.open_spans()
        leaked = (
            "<p>open spans: "
            + html.escape(
                ", ".join(s.name for s in open_spans) or "(none)"
            )
            + "</p>"
        )
        state = "enabled" if tracer.enabled else "disabled"
        body = (
            f"<p>tracer {state}; {len(events)} spans buffered "
            f"(ring capacity {tracer.capacity})</p>"
            + leaked
            + "<table><tr><th>category</th><th>span</th><th>count</th>"
            "<th>total ms</th><th>max ms</th></tr>"
            + rows
            + "</table>"
            "<p><a href='/debug/traces?format=chrome'>download Chrome "
            "trace</a> — open at https://ui.perfetto.dev or "
            "chrome://tracing</p>"
        )
        return _PAGE.format(title="/debug/traces", body=body)

    def _requests_page(self, limit: int) -> str:
        """Recent-RPC samples per server (the reference exposes gRPC's
        /debug/requests sampling on its debug port,
        doc/loadtest/README.md:322-324)."""
        sections = []
        for server, _loop in self._servers:
            log_ = getattr(server, "request_log", None)
            if log_ is None:
                continue
            rows = "".join(
                f"<tr><td>{_fmt_ts(s.when)}</td>"
                f"<td>{html.escape(s.method)}</td>"
                f"<td>{html.escape(s.caller)}</td>"
                f"<td>{html.escape(', '.join(s.resources))}</td>"
                f"<td>{s.wants:g}</td>"
                f"<td>{s.duration * 1000:.2f}</td>"
                f"<td>{'ERROR' if s.error else 'ok'}</td></tr>"
                for s in log_.snapshot(limit)
            )
            sections.append(
                f"<h2>{html.escape(server.id)}</h2>"
                f"<table><tr><th>when</th><th>method</th><th>caller</th>"
                f"<th>resources</th><th>wants</th><th>ms</th>"
                f"<th>outcome</th></tr>{rows}</table>"
            )
        if not sections:
            sections.append("<p>no request samples</p>")
        return _PAGE.format(
            title="/debug/requests", body="".join(sections)
        )

    def _admission_statuses(self) -> Dict[str, Optional[dict]]:
        """server id -> admission status dict (None when the server has
        no admission front-end), snapshotted on each owning loop."""
        out: Dict[str, Optional[dict]] = {}
        for server, loop in self._servers:
            adm = getattr(server, "_admission", None)
            out[server.id] = (
                self._call(loop, adm.status) if adm is not None else None
            )
        return out

    def _admission_page(self) -> str:
        sections = []
        for sid, st in self._admission_statuses().items():
            if st is None:
                sections.append(
                    f"<h2>server {html.escape(sid)}</h2>"
                    "<p>admission control disabled</p>"
                )
                continue
            ctl = st.get("controller") or {}
            bands = ctl.get("bands", {})
            band_rows = "".join(
                f"<tr><td>{html.escape(b)}</td><td>{p:g}</td></tr>"
                for b, p in sorted(
                    bands.items(), key=lambda kv: -int(kv[0])
                )
            )
            tally_rows = "".join(
                f"<tr><td>{html.escape(key)}</td>"
                f"<td>{v['admitted']}</td><td>{v['shed']}</td>"
                f"<td>{v['fast_fail']}</td></tr>"
                for key, v in sorted(st.get("tallies", {}).items())
            )
            co = st.get("coalescer") or {}
            sections.append(
                f"<h2>server {html.escape(sid)}</h2>"
                f"<p>level: {ctl.get('level', 1.0):g} | "
                f"pressure: {ctl.get('pressure', 0.0):g} | "
                f"offered rps: "
                f"{ctl.get('offered_rps_last_window', 0.0):g} | "
                f"windows: {ctl.get('windows', 0)} "
                f"(overloaded: {ctl.get('overloaded_windows', 0)})</p>"
                f"<p>latency ewma: {ctl.get('latency_ewma_s', 0.0):g}s | "
                f"queue ewma: {ctl.get('queue_ewma', 0.0):g} | "
                f"tick lag ewma: {ctl.get('tick_lag_ewma', 0.0):g}</p>"
                f"<p>coalescing: window {co.get('window_s', 0.0):g}s, "
                f"{co.get('flushes', 0)} flushes, "
                f"{co.get('coalesced_requests', 0)} coalesced requests, "
                f"max occupancy {co.get('max_occupancy', 0)}</p>"
                "<table><tr><th>band</th><th>admit probability</th></tr>"
                f"{band_rows}</table>"
                "<table><tr><th>method/band</th><th>admitted</th>"
                f"<th>shed</th><th>fast-fail</th></tr>{tally_rows}</table>"
            )
        if not sections:
            sections.append("<p>no servers</p>")
        return _PAGE.format(
            title="/debug/admission", body="".join(sections)
        )

    def _frontend_statuses(self) -> Dict[str, Optional[dict]]:
        """server id -> serving-plane pool status (None when no
        frontend pool is attached), snapshotted on each owning loop
        (the inline pool's status reads live ring control words)."""
        out: Dict[str, Optional[dict]] = {}
        for server, loop in self._servers:
            pool = getattr(server, "_frontend", None)
            out[server.id] = (
                self._call(loop, pool.status)
                if pool is not None else None
            )
        return out

    def _frontend_page(self) -> str:
        sections = []
        for sid, st in self._frontend_statuses().items():
            if st is None:
                sections.append(
                    f"<h2>server {html.escape(sid)}</h2>"
                    "<p>no frontend pool attached</p>"
                )
                continue
            pub = st.get("publisher") or {}
            live = st.get("live", [])
            parts = [
                f"mode: {html.escape(str(st.get('mode', '?')))}",
                f"workers live: {len(live)}/{st.get('workers', 0)}",
                f"published: {pub.get('published_frames', 0)} frames"
                f" / {pub.get('published_bytes', 0)} bytes"
                f" ({pub.get('terminals', 0)} terminals)",
            ]
            if "held" in st:
                parts.append(f"held: {st['held']}")
            if "crashes" in st:
                parts.append(
                    f"crashes: {st['crashes']} "
                    f"(restores: {st.get('restores', 0)})"
                )
            if st.get("public_addr"):
                parts.append(
                    "public: " + html.escape(str(st["public_addr"]))
                )
            body = [f"<h2>server {html.escape(sid)}</h2>"
                    f"<p>{' | '.join(parts)}</p>"]
            per_worker = st.get("per_worker") or []
            if per_worker:
                # Inline pool: the in-process worker cores expose the
                # full pump/stall counters.
                rows = "".join(
                    f"<tr><td>{w.get('worker')}</td>"
                    f"<td>{w.get('held', 0)}</td>"
                    f"<td>{w.get('frames', 0)}</td>"
                    f"<td>{w.get('pushes', 0)}</td>"
                    f"<td>{w.get('terminals', 0)}</td>"
                    f"<td>{w.get('stalls', 0)}</td>"
                    f"<td>{w.get('desyncs', 0)}</td>"
                    f"<td>{w.get('parked', 0)}</td></tr>"
                    for w in per_worker
                )
                body.append(
                    "<table><tr><th>worker</th><th>held</th>"
                    "<th>frames</th><th>pushes</th><th>terminals</th>"
                    "<th>stalls</th><th>desyncs</th><th>parked</th>"
                    f"</tr>{rows}</table>"
                )
            control = st.get("control") or {}
            if control:
                # Process pool: the control surface's view (heartbeats
                # are the workers' own reports).
                held_rows = "".join(
                    f"<tr><td>{html.escape(w)}</td><td>{n}</td></tr>"
                    for w, n in sorted(
                        (control.get("worker_held") or {}).items()
                    )
                )
                body.append(
                    f"<p>establishments: "
                    f"{control.get('establishments', 0)} | drops: "
                    f"{control.get('drops', 0)} | heartbeats: "
                    f"{control.get('heartbeats', 0)}</p>"
                    "<table><tr><th>worker</th><th>held (last "
                    f"heartbeat)</th></tr>{held_rows}</table>"
                )
            sections.append("".join(body))
        if not sections:
            sections.append("<p>no servers</p>")
        return _PAGE.format(
            title="/debug/frontend", body="".join(sections)
        )

    def _slo_statuses(self) -> Dict[str, Optional[dict]]:
        """server id -> last_slo dict (a fresh evaluation per request;
        None when the server has no SLO support), each snapshotted on
        its owning loop."""
        out: Dict[str, Optional[dict]] = {}
        for server, loop in self._servers:
            if not hasattr(server, "evaluate_slos"):
                out[getattr(server, "id", "?")] = None
                continue

            def evaluate(server=server):
                server.evaluate_slos(registry=self.registry)
                return server.last_slo

            out[server.id] = self._call(loop, evaluate)
        return out

    def _slo_page(self) -> str:
        sections = []
        for sid, st in self._slo_statuses().items():
            if st is None:
                sections.append(
                    f"<h2>server {html.escape(sid)}</h2>"
                    "<p>no SLO support</p>"
                )
                continue
            rows = ""
            for v in st.get("verdicts", []):
                observed = v.get("observed")
                obs_txt = "-" if observed is None else f"{observed:g}"
                rows += (
                    f"<tr><td>{html.escape(v['slo'])}</td>"
                    f"<td>{html.escape(v['status'])}</td>"
                    f"<td>{obs_txt}</td>"
                    f"<td>{v['kind']} {v['target']:g}</td>"
                    f"<td>{html.escape(v.get('unit', ''))}</td>"
                    f"<td>{html.escape(v.get('description', ''))}</td>"
                    "</tr>"
                )
            ok = st.get("ok")
            cls = "master" if ok else "notmaster"
            sections.append(
                f"<h2>server {html.escape(sid)}</h2>"
                f"<p class={cls!r}>overall: "
                f"{'pass' if ok else 'FAIL'}</p>"
                "<table><tr><th>slo</th><th>status</th><th>observed</th>"
                f"<th>target</th><th>unit</th><th>what</th></tr>{rows}"
                "</table>"
            )
        if not sections:
            sections.append("<p>no servers</p>")
        return _PAGE.format(title="/debug/slo", body="".join(sections))

    def _flightrec_views(self) -> Dict[str, Optional[dict]]:
        """server id -> on-demand flight-recorder view (no side
        effects), snapshotted on each owning loop."""
        out: Dict[str, Optional[dict]] = {}
        for server, loop in self._servers:
            fr = getattr(server, "flightrec", None)
            out[getattr(server, "id", "?")] = (
                self._call(loop, fr.view) if fr is not None else None
            )
        return out

    def _flightrec_chrome(self) -> str:
        """Overlay trace of the first server with a recorder."""
        for server, loop in self._servers:
            fr = getattr(server, "flightrec", None)
            if fr is not None:
                records = self._call(loop, fr.snapshot)
                return fr.chrome_overlay(records)
        return json.dumps({"traceEvents": []})

    def _flightrec_page(self) -> str:
        sections = []
        for server, loop in self._servers:
            fr = getattr(server, "flightrec", None)
            sid = getattr(server, "id", "?")
            if fr is None:
                sections.append(
                    f"<h2>server {html.escape(sid)}</h2>"
                    "<p>flight recorder disabled</p>"
                )
                continue
            st = fr.status()
            last = st.get("last_dump")
            last_txt = (
                f"{last['reason']} at head seq {last['head_seq']} "
                f"({last['records']} records)"
                if last
                else "(none)"
            )
            recent = self._call(loop, fr.snapshot)[-5:]
            recent_rows = "".join(
                f"<tr><td>{r.get('seq')}</td><td>{r.get('tick', '-')}</td>"
                f"<td>{r.get('wall_ms', '-')}</td>"
                f"<td>{html.escape(str(r.get('digest', '-')))}</td>"
                f"<td>{html.escape(str(r.get('error', '')))}</td></tr>"
                for r in recent
            )
            sections.append(
                f"<h2>server {html.escape(sid)}</h2>"
                f"<p>head seq: {st['head_seq']} | occupancy: "
                f"{st['occupancy']}/{st['capacity']} | last dump: "
                f"{html.escape(last_txt)}</p>"
                "<table><tr><th>seq</th><th>tick</th><th>wall ms</th>"
                f"<th>digest</th><th>error</th></tr>{recent_rows}</table>"
                "<p><a href='/debug/flightrec?format=json'>dump JSON</a>"
                " | <a href='/debug/flightrec?format=chrome'>overlay "
                "trace</a></p>"
            )
        if not sections:
            sections.append("<p>no servers</p>")
        return _PAGE.format(
            title="/debug/flightrec", body="".join(sections)
        )

    def _history_views(
        self,
        start: Optional[int] = None,
        end: Optional[int] = None,
        tier: int = 0,
    ) -> Dict[str, Optional[dict]]:
        """server id -> history view (records by hseq range/tier).
        The store is thread-safe, so no loop hop is needed."""
        out: Dict[str, Optional[dict]] = {}
        for server, _loop in self._servers:
            hs = getattr(server, "history", None)
            out[getattr(server, "id", "?")] = (
                hs.view(start=start, end=end, tier=tier)
                if hs is not None
                else None
            )
        return out

    def _history_chrome(self) -> str:
        """Overlay trace of the first server with a history store."""
        for server, _loop in self._servers:
            hs = getattr(server, "history", None)
            if hs is not None:
                return hs.chrome()
        return json.dumps({"traceEvents": []})

    def _history_page(self) -> str:
        sections = []
        for server, _loop in self._servers:
            hs = getattr(server, "history", None)
            sid = getattr(server, "id", "?")
            if hs is None:
                sections.append(
                    f"<h2>server {html.escape(sid)}</h2>"
                    "<p>history disabled (--history-dir)</p>"
                )
                continue
            st = hs.status()
            tier_txt = ", ".join(
                f"x{f}: {n} buckets" for f, n in sorted(
                    st["tiers"].items(), key=lambda kv: int(kv[0])
                )
            )
            recent = hs.records()[-5:]
            recent_rows = "".join(
                f"<tr><td>{r.get('hseq')}</td><td>{r.get('run')}</td>"
                f"<td>{r.get('tick', '-')}</td>"
                f"<td>{r.get('wall_ms', '-')}</td>"
                f"<td>{html.escape(str(r.get('solve_mode', '-')))}</td>"
                f"<td>{r.get('audit_divergence', '-')}</td></tr>"
                for r in recent
            )
            sections.append(
                f"<h2>server {html.escape(sid)}</h2>"
                f"<p>run: {st['run']} | head hseq: {st['head_hseq']} | "
                f"ring: {st['ring']}/{st['ring_capacity']} | segments: "
                f"{st['segments']} ({html.escape(str(st['dir']))}) | "
                f"tiers: {html.escape(tier_txt or '(none)')}</p>"
                "<table><tr><th>hseq</th><th>run</th><th>tick</th>"
                "<th>wall ms</th><th>solve mode</th>"
                f"<th>audit div</th></tr>{recent_rows}</table>"
                "<p><a href='/debug/history?format=json'>dump JSON</a>"
                " | <a href='/debug/history?format=chrome'>overlay "
                "trace</a></p>"
            )
        if not sections:
            sections.append("<p>no servers</p>")
        return _PAGE.format(
            title="/debug/history", body="".join(sections)
        )

    def _resources_page(self, only: Optional[str]) -> str:
        sections = []
        for (server, loop), st in zip(self._servers, self._statuses()):
            for rid in sorted(st["resources"]):
                if only is not None and rid != only:
                    continue
                lease_st = self._call(
                    loop, lambda: server.resource_lease_status(rid)
                )
                if lease_st is None:
                    continue
                rows = "".join(
                    f"<tr><td>{html.escape(cs.client_id)}</td>"
                    f"<td>{cs.lease.has:g}</td>"
                    f"<td>{cs.lease.wants:g}</td>"
                    f"<td>{cs.lease.subclients}</td>"
                    f"<td>{_fmt_ts(cs.lease.expiry)}</td></tr>"
                    for cs in lease_st.leases
                )
                sections.append(
                    f"<h2>{html.escape(rid)} @ {html.escape(st['id'])}</h2>"
                    f"<p>sum_has: {lease_st.sum_has:g} / "
                    f"sum_wants: {lease_st.sum_wants:g}</p>"
                    f"<table><tr><th>client</th><th>has</th><th>wants</th>"
                    f"<th>subclients</th><th>expires</th></tr>"
                    f"{rows}</table>"
                )
        if not sections:
            sections.append("<p>no resources</p>")
        return _PAGE.format(
            title="/debug/resources", body="".join(sections)
        )

    def _vars(self) -> str:
        """expvar-style JSON snapshot (the reference blank-imports expvar,
        doorman_server.go:43-45)."""
        return json.dumps(
            {
                # doorman: allow[seeded-determinism] wall-clock uptime
                "uptime_seconds": time.time() - _start_time,
                "servers": self._statuses(),
            },
            indent=2,
            default=str,
        )

    def _make_handler(self):
        debug = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def do_GET(self):
                url = urlparse(self.path)
                try:
                    if url.path == "/metrics":
                        body, ctype = (
                            debug.registry.expose(),
                            "text/plain; version=0.0.4",
                        )
                    elif url.path in ("/", "/debug/status"):
                        body, ctype = debug._status_page(), "text/html"
                    elif url.path in ("/debug", "/debug/"):
                        body, ctype = debug._index_page(), "text/html"
                    elif url.path == "/debug/traces":
                        q = parse_qs(url.query)
                        if q.get("format", [""])[0] == "chrome":
                            body, ctype = (
                                trace_mod.default_tracer().chrome_json(),
                                "application/json",
                            )
                        else:
                            body, ctype = debug._traces_page(), "text/html"
                    elif url.path == "/debug/resources":
                        q = parse_qs(url.query)
                        only = q.get("resource", [None])[0]
                        body, ctype = (
                            debug._resources_page(only),
                            "text/html",
                        )
                    elif url.path == "/debug/admission":
                        q = parse_qs(url.query)
                        if q.get("format", [""])[0] == "json":
                            body, ctype = (
                                json.dumps(
                                    debug._admission_statuses(),
                                    indent=2, default=str,
                                ),
                                "application/json",
                            )
                        else:
                            body, ctype = (
                                debug._admission_page(),
                                "text/html",
                            )
                    elif url.path == "/debug/frontend":
                        q = parse_qs(url.query)
                        if q.get("format", [""])[0] == "json":
                            body, ctype = (
                                json.dumps(
                                    debug._frontend_statuses(),
                                    indent=2, default=str,
                                ),
                                "application/json",
                            )
                        else:
                            body, ctype = (
                                debug._frontend_page(),
                                "text/html",
                            )
                    elif url.path == "/debug/slo":
                        q = parse_qs(url.query)
                        if q.get("format", [""])[0] == "json":
                            body, ctype = (
                                json.dumps(
                                    debug._slo_statuses(),
                                    indent=2, default=str,
                                ),
                                "application/json",
                            )
                        else:
                            body, ctype = debug._slo_page(), "text/html"
                    elif url.path == "/debug/flightrec":
                        q = parse_qs(url.query)
                        fmt = q.get("format", [""])[0]
                        if fmt == "json":
                            body, ctype = (
                                json.dumps(
                                    debug._flightrec_views(),
                                    indent=1, default=str,
                                ),
                                "application/json",
                            )
                        elif fmt == "chrome":
                            body, ctype = (
                                debug._flightrec_chrome(),
                                "application/json",
                            )
                        else:
                            body, ctype = (
                                debug._flightrec_page(),
                                "text/html",
                            )
                    elif url.path == "/debug/history":
                        q = parse_qs(url.query)
                        fmt = q.get("format", [""])[0]
                        if fmt == "json":

                            def _int(key):
                                try:
                                    return int(q[key][0])
                                except (KeyError, ValueError):
                                    return None

                            body, ctype = (
                                json.dumps(
                                    debug._history_views(
                                        start=_int("start"),
                                        end=_int("end"),
                                        tier=_int("tier") or 0,
                                    ),
                                    indent=1, default=str,
                                ),
                                "application/json",
                            )
                        elif fmt == "chrome":
                            body, ctype = (
                                debug._history_chrome(),
                                "application/json",
                            )
                        else:
                            body, ctype = (
                                debug._history_page(),
                                "text/html",
                            )
                    elif url.path == "/debug/requests":
                        q = parse_qs(url.query)
                        try:
                            limit = max(0, int(q.get("limit", ["100"])[0]))
                        except ValueError:
                            limit = 100
                        body, ctype = (
                            debug._requests_page(limit),
                            "text/html",
                        )
                    elif url.path == "/debug/vars":
                        body, ctype = debug._vars(), "application/json"
                    elif url.path == "/healthz":
                        body, ctype = "ok\n", "text/plain"
                    else:
                        self.send_error(404)
                        return
                except Exception as e:
                    self.send_error(500, str(e))
                    return
                data = body.encode()
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        return Handler
