"""Comparisons the entries' checks make."""

from __future__ import annotations

import numpy as np


def differing(got, want: bytes) -> int:
    """Bytes in which ``got`` differs from ``want``; all of them if ``got`` is
    missing or of another length."""
    if got is None or len(got) != len(want):
        return len(want)
    return int(np.count_nonzero(np.frombuffer(got, np.uint8) != np.frombuffer(want, np.uint8)))
