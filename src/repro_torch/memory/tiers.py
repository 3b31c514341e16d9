"""Tier errors (the tier classes wait for the resilient-serving slice)."""

from __future__ import annotations


class CapacityError(RuntimeError):
    """Raised when a pool or tier cannot place what it is asked to."""
