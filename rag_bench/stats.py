"""Percentiles as the benchmark takes them (Python's ``statistics``)."""

from __future__ import annotations

import statistics
from typing import List


def percentile(values: List[float], q: int) -> float:
    """The ``q``-th percentile, ``statistics.quantiles(..., n=100,
    method="inclusive")``; the value itself for one value."""
    return float(statistics.quantiles(values, n=100, method="inclusive")[q - 1]) \
        if len(values) > 1 else float(values[0])
