"""Config sources: blocking "next config version" abstraction.

Capability parity with reference go/configuration/configuration.go: a
Source is an async callable returning the next version of the raw config
bytes — LocalFile re-reads on SIGHUP (with an initial self-signal so the
first call returns immediately, configuration.go:31-53), Etcd gets then
watches a key (configuration.go:56-105), and parse_source dispatches on a
"file:" / "etcd:" prefix (configuration.go:109-121).

The etcd source speaks the v3 HTTP/JSON gateway through the shared
client in server/etcd.py — the same API generation the election lock
uses — in an executor thread, and raises a clear error at construction
if the endpoint list is empty.

Host-only (standard library, server/etcd.py and utils/backoff.py): a
copy of the JAX package's module, import paths aside.
"""

from __future__ import annotations

import asyncio
import logging
import signal
import weakref
from typing import Awaitable, Callable, List, Optional

from doorman_tpu_torch.server.etcd import EtcdGateway
from doorman_tpu_torch.utils.backoff import MIN_BACKOFF, MAX_BACKOFF, backoff

log = logging.getLogger(__name__)

# A Source, awaited repeatedly, blocks until a new config version exists
# and returns its bytes (configuration.go:21-29).
Source = Callable[[], Awaitable[bytes]]


# All live file sources share one SIGHUP handler that wakes every one of
# them — a per-source add_signal_handler would silently clobber the
# previous source's handler. Each event is woken via its OWN loop
# (call_soon_threadsafe): the handler runs on the main thread's loop, but
# a source may live on a loop in another thread, and Event.set() is not
# thread-safe. WeakKeyDictionary so abandoned sources get collected.
_sighup_events: "weakref.WeakKeyDictionary[asyncio.Event, asyncio.AbstractEventLoop]" = (
    weakref.WeakKeyDictionary()
)


def _on_sighup() -> None:
    for event, loop in list(_sighup_events.items()):
        try:
            loop.call_soon_threadsafe(event.set)
        except RuntimeError:
            pass  # that source's loop already closed; wake the rest


def local_file(path: str,
               loop: Optional[asyncio.AbstractEventLoop] = None) -> Source:
    """Re-reads `path` every time SIGHUP arrives; the first call reads
    immediately (the reference self-sends SIGHUP at setup,
    configuration.go:36)."""
    event = asyncio.Event()
    event.set()  # initial read
    loop = loop or asyncio.get_event_loop()
    _sighup_events[event] = loop
    try:
        loop.add_signal_handler(signal.SIGHUP, _on_sighup)
    except (NotImplementedError, RuntimeError, ValueError):
        # Non-unix platform, or the loop runs off the main thread
        # (add_signal_handler raises ValueError there).
        log.warning("SIGHUP reload unavailable; config loads once")

    async def source() -> bytes:
        await event.wait()
        event.clear()
        return await asyncio.get_event_loop().run_in_executor(
            None, lambda: open(path, "rb").read()
        )

    return source


def etcd(key: str, endpoints: List[str]) -> Source:
    """Gets `key`, then blocks on a watch for each subsequent version,
    retrying with backoff on errors (configuration.go:56-105)."""
    gateway = EtcdGateway(endpoints)
    state = {"last": None, "retries": 0}

    async def source() -> bytes:
        loop = asyncio.get_event_loop()
        while True:
            watch_ok = True
            if state["last"] is not None:
                watch_ok = await loop.run_in_executor(
                    None, gateway.wait_for_change, key
                )
            try:
                value = await loop.run_in_executor(None, gateway.get, key)
            except Exception:
                log.exception("etcd get %r failed", key)
                value = None
            if value is not None and value != state["last"]:
                state["last"] = value
                state["retries"] = 0
                return value
            # Missing key, broken watch, or unchanged value: sleep instead
            # of busy-reloading the same config. Only actual errors (no
            # value, or a watch that could not be established) escalate
            # the backoff — a healthy idle key keeps the minimum sleep, so
            # a real change is still picked up within one watch cycle.
            await asyncio.sleep(
                backoff(MIN_BACKOFF, MAX_BACKOFF, state["retries"])
            )
            if value is None or not watch_ok:
                state["retries"] += 1

    return source


def parse_source(text: str, etcd_endpoints: Optional[List[str]] = None,
                 loop: Optional[asyncio.AbstractEventLoop] = None) -> Source:
    """Dispatch on "file:<path>" or "etcd:<key>" (configuration.go:109)."""
    kind, sep, path = text.partition(":")
    if not sep:
        raise ValueError(f"config source needs a 'file:'/'etcd:' prefix: "
                         f"{text!r}")
    if kind == "file":
        return local_file(path, loop=loop)
    if kind == "etcd":
        return etcd(path, etcd_endpoints or [])
    raise ValueError(f"unknown config source kind {kind!r} in {text!r}")
