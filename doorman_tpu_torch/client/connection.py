"""Master-aware gRPC connection (port of doorman_tpu/client/connection.py,
TLS arguments included).

Capability parity with reference go/connection/connection.go:128-227: an RPC
is retried with exponential backoff on transport errors; a response carrying
a `mastership` field means "not the master" — reconnect to the indicated
master (immediately) or retry after backoff when the master is unknown.
Shared by the client library and by intermediate servers talking to their
parent.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Awaitable, Callable, Optional, TypeVar

import grpc

from doorman_tpu_torch.proto.grpc_api import CapacityStub
from doorman_tpu_torch.utils.backoff import MAX_BACKOFF, MIN_BACKOFF, backoff

log = logging.getLogger(__name__)


T = TypeVar("T")

_NON_RETRIABLE = frozenset(
    {
        grpc.StatusCode.INVALID_ARGUMENT,
        grpc.StatusCode.UNIMPLEMENTED,
        grpc.StatusCode.PERMISSION_DENIED,
        grpc.StatusCode.UNAUTHENTICATED,
        # The server's admission control explicitly shed this RPC with
        # a retry-after hint in trailing metadata; hammering retries
        # inside one execute() call would defeat the shedding — the
        # caller owns the pacing (client.py honors the hint with
        # jitter).
        grpc.StatusCode.RESOURCE_EXHAUSTED,
    }
)


class Connection:
    """A channel to "the current master", starting from a seed address."""

    def __init__(
        self,
        addr: str,
        *,
        minimum_refresh_interval: float = 5.0,
        max_retries: Optional[int] = None,
        grpc_options: Optional[list] = None,
        tls: bool = False,
        tls_ca: Optional[str] = None,
    ):
        """`tls=True` dials with TLS using the system roots; `tls_ca` (a
        PEM file path) pins the root certificate and implies TLS — the
        client side of the server's --tls-cert/--tls-key
        (doorman_server.go:164-168 dial options)."""
        self.addr = addr
        self.current_master = ""
        self.minimum_refresh_interval = minimum_refresh_interval
        self.max_retries = max_retries
        self._grpc_options = grpc_options
        self._credentials: Optional[grpc.ChannelCredentials] = None
        if tls or tls_ca:
            root_certificates = None
            if tls_ca:
                with open(tls_ca, "rb") as f:
                    root_certificates = f.read()
            self._credentials = grpc.ssl_channel_credentials(
                root_certificates=root_certificates
            )
        self._channel: Optional[grpc.aio.Channel] = None
        self.stub: Optional[CapacityStub] = None
        # Mastership-redirect observer: called with the new master's
        # address every time this connection follows a redirect. The
        # federated discovery cache hooks it (invalidate-on-redirect:
        # a flip observed on a live connection updates the cache at RPC
        # speed instead of triggering a Discovery round). Observer
        # errors never break the chase.
        self.on_redirect: Optional[Callable[[str], None]] = None

    def __str__(self) -> str:
        return self.current_master

    async def _connect(self, addr: str) -> None:
        await self.close()
        log.info("connecting to %s", addr)
        if self._credentials is not None:
            self._channel = grpc.aio.secure_channel(
                addr, self._credentials, options=self._grpc_options
            )
        else:
            self._channel = grpc.aio.insecure_channel(
                addr, options=self._grpc_options
            )
        self.stub = CapacityStub(self._channel)
        self.current_master = addr

    async def close(self) -> None:
        if self._channel is not None:
            await self._channel.close()
            self._channel = None
            self.stub = None
            self.current_master = ""

    async def ensure(self) -> None:
        """Dial if no channel is open (stream mode establishes its
        WatchCapacity call directly on the stub instead of through
        execute(), which is shaped around unary request/response)."""
        if self._channel is None:
            await self._connect(self.addr)

    async def redirect(self, addr: str) -> None:
        """Reconnect to an indicated master — the stream-mode analog of
        execute()'s mastership chase (a terminal WatchCapacityResponse
        carries the address instead of a unary mastership field)."""
        await self._connect(addr)
        self._note_redirect(addr)

    def _note_redirect(self, addr: str) -> None:
        if self.on_redirect is None:
            return
        try:
            self.on_redirect(addr)
        except Exception:
            log.exception("on_redirect observer failed")

    async def execute(
        self, call: Callable[[CapacityStub], Awaitable[T]]
    ) -> T:
        """Run `call` against the current master, following mastership
        redirects and backing off on errors. Raises the last error once
        max_retries is exhausted (the reference retries forever; pass
        max_retries=None for that behavior)."""
        retries = 0
        last_error: Optional[Exception] = None
        while self.max_retries is None or retries <= self.max_retries:
            if retries > 0:
                await asyncio.sleep(backoff(MIN_BACKOFF, MAX_BACKOFF, retries))
            retries += 1

            sleepless_redirects = 0
            while True:
                if self._channel is None:
                    try:
                        await self._connect(self.addr)
                    except Exception as e:  # dial errors retry with backoff
                        last_error = e
                        break
                try:
                    out = await call(self.stub)
                except grpc.aio.AioRpcError as e:
                    if e.code() in _NON_RETRIABLE:
                        # Deterministic failure (bad request, unimplemented):
                        # retrying the identical call can never succeed.
                        raise
                    last_error = e
                    await self.close()
                    break
                except Exception as e:
                    last_error = e
                    await self.close()
                    break

                if not out.HasField("mastership"):
                    # The server processed the request: it is the master.
                    return out

                mastership = out.mastership
                if not mastership.HasField("master_address") or (
                    mastership.master_address == ""
                ):
                    log.warning(
                        "%s is not the master and does not know who is",
                        self.current_master,
                    )
                    last_error = MasterUnknown(self.current_master)
                    break

                # Redirect: reconnect to the indicated master and retry
                # immediately (bounded, in case two servers point at each
                # other).
                sleepless_redirects += 1
                if sleepless_redirects > 5:
                    last_error = MasterUnknown(mastership.master_address)
                    break
                await self._connect(mastership.master_address)
                self._note_redirect(mastership.master_address)

        raise last_error if last_error is not None else MasterUnknown(self.addr)


class MasterUnknown(ConnectionError):
    """No master is currently known/reachable."""
