"""In-process serving metrics: request counters + latency quantiles.

SURVEY.md §5 observability: "add QPS/p50 counters — they are the baseline
metric". Ring-buffered latencies per endpoint family, reported by
GET /metrics. No Prometheus dependency (matches the reference's
no-external-telemetry stance); the payload is scrape-friendly JSON.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict, deque
from typing import Any, Dict

_WINDOW = 2048


class MetricsRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._latencies: Dict[str, deque] = defaultdict(
            lambda: deque(maxlen=_WINDOW)
        )
        self._counts: Dict[str, int] = defaultdict(int)
        self._errors: Dict[str, int] = defaultdict(int)
        self._started = time.time()

    def observe(self, family: str, seconds: float, error: bool = False) -> None:
        with self._lock:
            self._counts[family] += 1
            if error:
                self._errors[family] += 1
            self._latencies[family].append(seconds)

    def snapshot(self) -> Dict[str, Any]:
        import numpy as np

        with self._lock:
            out: Dict[str, Any] = {
                "uptime_s": round(time.time() - self._started, 1),
                "endpoints": {},
            }
            for family, count in self._counts.items():
                lats = np.asarray(self._latencies[family], dtype=np.float64)
                entry: Dict[str, Any] = {
                    "count": count,
                    "errors": self._errors.get(family, 0),
                }
                if lats.size:
                    entry.update(
                        p50_ms=round(float(np.percentile(lats, 50)) * 1e3, 3),
                        p95_ms=round(float(np.percentile(lats, 95)) * 1e3, 3),
                        p99_ms=round(float(np.percentile(lats, 99)) * 1e3, 3),
                        window=int(lats.size),
                    )
                out["endpoints"][family] = entry
            return out

    def reset(self) -> None:
        with self._lock:
            self._latencies.clear()
            self._counts.clear()
            self._errors.clear()
            self._started = time.time()


registry = MetricsRegistry()
