"""Explicit random streams: nothing here seeds a global generator."""

from __future__ import annotations


def fold_in(seed: int, data: int) -> int:
    """A 63-bit seed for the stream (seed, data), the counterpart of
    jax.random.fold_in: distinct pairs give distinct seeds for
    0 <= data < 2**32 and 0 <= seed < 2**31."""
    return ((seed & 0x7FFFFFFF) << 32) | (data & 0xFFFFFFFF)


def debugger_is_active() -> bool:
    """True when a trace-based debugger is attached (the reference's gate on
    experiment logging)."""
    import sys

    return sys.gettrace() is not None
