"""What the drivers share: the server as a configuration states it, the
profiler around the window, and the read-back of the store."""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import numpy as np

from portbench.measure import trace as trace_mod


def host_threads(cfg: dict) -> None:
    """The configuration's `torch_threads`: the intra-op threads of the
    process's host-side torch work (one process, few threads, so that a
    run's speed depends less on what else the host runs)."""
    import torch

    torch.set_num_threads(int(cfg["torch_threads"]))


def build_port(device: str) -> float:
    """Build or load the port's native store and, on the card, its CUDA
    kernels (both cached in the port's `_build/`); returns the seconds
    it took, which set-up includes (a checkout's first run compiles)."""
    t = time.perf_counter()
    from doorman_tpu_torch import native

    if not native.native_available():
        raise RuntimeError("the port's native store did not build")
    if device != "cpu":
        from doorman_tpu_torch.solver import dense_cuda

        dense_cuda.build()
    return time.perf_counter() - t


def make_server(cfg: dict, device: str):
    """The configuration's CapacityServer: every option as its file
    states it, with the binary's request instrumentation where it says
    so (cmd/server.py wires it whenever the debug port is on, the
    default)."""
    from doorman_tpu_torch.obs.metrics import Registry, instrument_server
    from doorman_tpu_torch.server.election import TrivialElection
    from doorman_tpu_torch.server.server import CapacityServer

    opts = dict(cfg["server"])
    opts["device"] = device
    server = CapacityServer(cfg.get("server_id", "portbench"),
                            TrivialElection(), **opts)
    if cfg.get("instrument_requests"):
        instrument_server(server, Registry())
    return server


def phase_totals(server) -> dict:
    """Cumulative seconds of every lap the server's solvers keep
    (status()'s `phase_s`)."""
    return dict(server.status()["phase_s"])


def phase_delta(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0.0) for k, v in after.items()
            if v - before.get(k, 0.0) > 0}


class Profiler:
    """torch.profiler (host ops and, on the card, kernels and copies)
    around the window, with the program's own span tracer on (the
    server's tick and RPC spans, the solvers' phase laps), whose spans
    name the idle gaps; `summary` is the reduced trace. `window_start`
    is the perf_counter reading taken as the window opened."""

    SPANS = 1 << 20  # the tracer's ring: every span of a window

    def __init__(self, on: bool, idle_label: str):
        self.on = on
        self.idle_label = idle_label
        self.summary = None
        self.window_start = None
        self._prof = None

    def start(self):
        if not self.on:
            return
        import torch
        from doorman_tpu_torch.obs import trace as program_trace

        program_trace.default_tracer().clear()
        program_trace.default_tracer().enable(capacity=self.SPANS)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()

    def stop(self):
        if self._prof is None:
            return
        import torch
        from doorman_tpu_torch.obs import trace as program_trace

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()
        tracer = program_trace.default_tracer()
        zero = program_trace.perf_to_us(0.0)
        spans = [((sp.ts - zero) / 1e6, (sp.ts + sp.dur - zero) / 1e6,
                  f"{sp.cat}/{sp.name}" if sp.cat else sp.name)
                 for sp in tracer.snapshot() if sp.ph == "X"]
        tracer.disable()
        tracer.clear()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self._prof.export_chrome_trace(path)
            self.summary = trace_mod.read_trace(
                path, self.idle_label, spans=spans,
                window_start_s=self.window_start)
        self._prof = None


@contextlib.contextmanager
def span(name: str, on: bool):
    """A harness span in the profiler's trace (`portbench.<name>`)."""
    if not on:
        yield
        return
    import torch

    with torch.profiler.record_function(f"portbench.{name}"):
        yield


def device_block(device: str) -> dict:
    """The result's `device` object: the card's name and count and the
    peak of device memory (read before the reference runs)."""
    import torch

    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}


def lease_index(cids: np.ndarray) -> np.ndarray:
    """handle -> lease index ([R, clients] client handles, resource-major)."""
    flat = cids.ravel()
    inv = np.full(int(flat.max()) + 1, -1, np.int64)
    inv[flat] = np.arange(len(flat))
    return inv


def now() -> float:
    return time.perf_counter()


class HostLoad:
    """What the host did around the window, for the result's `diag`:
    this process's CPU seconds against the wall, Python's collections."""

    def __init__(self):
        import gc

        self._gc = gc
        self.t = time.perf_counter()
        self.cpu = os.times()
        self.collections = [g["collections"] for g in gc.get_stats()]

    def done(self) -> dict:
        wall = time.perf_counter() - self.t
        cpu = os.times()
        used = (cpu.user - self.cpu.user) + (cpu.system - self.cpu.system)
        return {
            "wall_s": wall, "cpu_s": used,
            "gc_collections": [g["collections"] - c for g, c in zip(
                self._gc.get_stats(), self.collections)],
        }


def wall_quantiles_ms(walls) -> list:
    """[p10, p50, p90, max] of a list of seconds, in ms."""
    if not len(walls):
        return []
    a = np.sort(np.asarray(walls)) * 1e3
    return [float(np.percentile(a, q)) for q in (10, 50, 90)] + [float(a[-1])]
