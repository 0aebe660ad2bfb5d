"""Bucket sizing shared by the dense layouts (the port keeps only this
helper of doorman_tpu.core.snapshot)."""

from __future__ import annotations


def _bucket(n: int, minimum: int = 64) -> int:
    """Round up to the next power of two (>= minimum) to bound the
    number of distinct table widths."""
    size = minimum
    while size < n:
        size *= 2
    return size
