"""Master election (the port carries the trivial election only).

Mirrors doorman_tpu/server/election.py's `Election` contract; the
etcd-backed KVElection is not ported yet.
"""

from __future__ import annotations

import abc
from typing import Awaitable, Callable

IsMasterCallback = Callable[[bool], Awaitable[None]]
CurrentMasterCallback = Callable[[str], Awaitable[None]]


class Election(abc.ABC):
    """A master election. `run` starts campaigning and returns immediately;
    outcomes are delivered through the callbacks (mirrors the reference's
    IsMaster()/Current() channels)."""

    @abc.abstractmethod
    async def run(
        self,
        id: str,
        on_is_master: IsMasterCallback,
        on_current: CurrentMasterCallback,
    ) -> None:
        ...

    async def stop(self) -> None:
        pass


class TrivialElection(Election):
    """The participant immediately wins (reference election.go:51-73)."""

    def __str__(self) -> str:
        return "no election, acting as the master"

    async def run(self, id, on_is_master, on_current) -> None:
        await on_is_master(True)
        await on_current(id)
