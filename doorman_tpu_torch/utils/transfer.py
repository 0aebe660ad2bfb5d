"""Host<->device transfers of the resident tick.

Upload: every staged block of a tick is packed on the host into one
uint8 buffer, copied into pinned memory and sent with ONE asynchronous
host-to-device copy (`place`). Download: the tick's delivery slab is
copied device-to-host on a dedicated copy stream, ordered after the
compute stream by an event, into pinned memory (`start_download`); the
collect side waits on the copy's own event (`land`). With up to three
ticks in flight (engine.PipelinedTicker), tick N's download overlaps the
staging and solve of the ticks after it.

On the CPU both ends are plain copies. Every placement counts one
dispatch and every landing one host sync (utils.dispatch).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from doorman_tpu_torch.utils import dispatch as dispatch_mod

_streams: Dict[torch.device, "torch.cuda.Stream"] = {}
_streams_lock = threading.Lock()


def place(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """One host->device transfer of a numpy array (a private copy on the
    CPU, so later host writes to `arr` never reach the table)."""
    dispatch_mod.count_dispatch()
    src = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cpu":
        return src.clone()
    pinned = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
    pinned.copy_(src)
    # The pinned block is held by torch's host allocator until the copy
    # it fed has completed, so dropping the reference here is safe.
    return pinned.to(device, non_blocking=True)


def _copy_stream(device: torch.device) -> "torch.cuda.Stream":
    with _streams_lock:
        s = _streams.get(device)
        if s is None:
            s = _streams[device] = torch.cuda.Stream(device=device)
        return s


@dataclass
class Download:
    """An in-flight device->host copy: the pinned host tensor it lands
    in, the event that marks it complete (None on the CPU), and the
    device tensor it reads (kept alive until landed)."""

    host: torch.Tensor
    done: "torch.cuda.Event | None" = None
    source: "torch.Tensor | None" = None


def start_download(t: torch.Tensor) -> Download:
    """Start copying `t` to the host on the copy stream."""
    if t.device.type == "cpu":
        return Download(host=t)
    stream = _copy_stream(t.device)
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(t.device))
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    with torch.cuda.stream(stream):
        stream.wait_event(ready)
        host.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    t.record_stream(stream)
    return Download(host=host, done=done, source=t)


def land(d: Download) -> np.ndarray:
    """Wait for a download and return it as a float64 numpy array."""
    dispatch_mod.count_host_sync()
    if d.done is not None:
        d.done.synchronize()
    d.source = None
    host = d.host
    if host.dtype == torch.bfloat16:
        host = host.float()
    return host.numpy().astype(np.float64)
