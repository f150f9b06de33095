"""Structured metrics out of every pipeline stage (SURVEY.md §5).

The reference's observability is Serial.printf plus counters folded into
scheduling (playback.cpp:97-101,125-130). anet's stages already return
metrics as data (FrameResult.confidence/snr_db, StreamCarry counters,
BerPoint); this registry is the host-side aggregation point: thread-safe
counters/gauges with a JSON-able snapshot — the `network_get_state` surface
generalized.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Union

Number = Union[int, float]


class MetricsRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Number] = {}
        self._gauges: Dict[str, Number] = {}
        self._created = time.time()

    def count(self, name: str, delta: Number = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + delta

    def gauge(self, name: str, value: Number) -> None:
        with self._lock:
            self._gauges[name] = value

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "uptime_s": round(time.time() - self._created, 3),
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
            }
