"""The shed decision and the retry-after contract (port of
doorman_tpu/admission/policy.py; only what the stream registry needs).

A shed request is answered `RESOURCE_EXHAUSTED` with the pacing hint in
trailing metadata under ``doorman-retry-after`` (seconds, decimal): the
admission path's analog of a lease's `refresh_interval`, carried in
metadata because a non-OK gRPC status cannot carry a response message.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["RETRY_AFTER_KEY", "Shed"]

# gRPC trailing-metadata key carrying the retry-after hint (seconds).
RETRY_AFTER_KEY = "doorman-retry-after"


@dataclass(frozen=True)
class Shed:
    """A decision to refuse one request."""

    reason: str
    retry_after: float
    band: int
    kind: str  # "overload" | "deadline" | "stream_cap"
