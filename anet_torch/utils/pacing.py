"""Leaky-bucket flow control.

Capability parity with the reference transmitter's pacing (LeakyBucket.kt +
MulticastAudioOutput.kt:79-96): the bucket models the receiver-side queue
occupancy in milliseconds of audio — capacity 1200 ms, draining at 1000
ms of audio per wall-clock second — so the sender never runs more than
~1.2 s ahead of playback.

Two clocks:
- wall clock (default): `wait_for_capacity` sleeps, for live streaming;
- `SimulatedClock`: virtual time for deterministic tests and for the
  channel/consumer simulation (SURVEY.md §2.4 — "retained as a simulation
  model"), where pacing behavior is studied without real-time waits.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Callable, Optional

from anet_torch import constants


class SimulatedClock:
    """Deterministic virtual clock: now() advances only via advance()/sleep()."""

    def __init__(self, start: float = 0.0) -> None:
        self._now = start

    def now(self) -> float:
        return self._now

    def advance(self, seconds: float) -> None:
        self._now += seconds

    def sleep(self, seconds: float) -> None:
        before = self._now
        self.advance(seconds)
        if seconds > 0 and self._now == before:
            # a wait below the clock's float resolution still moves time:
            # else a LeakyBucket whose overshoot rounds to such a wait would
            # sleep on it forever
            self._now = math.nextafter(before, math.inf)


class LeakyBucket:
    """Continuous-drain token bucket.

    Units are caller-defined (the transmitter uses milliseconds of audio).
    `try_put` returns 0.0 on success or the wait (in seconds) needed before
    the content would fit; `wait_for_capacity` blocks (sleeping on the
    configured clock) until the put succeeds.
    """

    def __init__(
        self,
        capacity: float = constants.PACING_BUCKET_CAPACITY_MS,
        drain_per_second: float = constants.PACING_DRAIN_MS_PER_S,
        now: Optional[Callable[[], float]] = None,
        sleep: Optional[Callable[[float], None]] = None,
    ) -> None:
        if capacity <= 0 or drain_per_second <= 0:
            raise ValueError("capacity and drain rate must be positive")
        self.capacity = capacity
        self.drain_per_second = drain_per_second
        self._now = now or time.monotonic
        self._sleep = sleep or time.sleep
        self._level = 0.0
        self._last = self._now()
        self._lock = threading.Lock()

    @classmethod
    def simulated(
        cls,
        clock: SimulatedClock,
        capacity: float = constants.PACING_BUCKET_CAPACITY_MS,
        drain_per_second: float = constants.PACING_DRAIN_MS_PER_S,
    ) -> "LeakyBucket":
        return cls(capacity, drain_per_second, now=clock.now, sleep=clock.sleep)

    @property
    def level(self) -> float:
        with self._lock:
            self._drain()
            return self._level

    def _drain(self) -> None:
        t = self._now()
        self._level = max(0.0, self._level - (t - self._last) * self.drain_per_second)
        self._last = t

    def try_put(self, amount: float) -> float:
        """Add ``amount`` if it fits; else return seconds to wait (>0)."""
        if amount > self.capacity:
            raise ValueError(
                f"amount {amount} exceeds bucket capacity {self.capacity}"
            )
        with self._lock:
            self._drain()
            if self._level + amount <= self.capacity:
                self._level += amount
                return 0.0
            return (self._level + amount - self.capacity) / self.drain_per_second

    def wait_for_capacity(self, amount: float) -> None:
        """Block until ``amount`` fits, then add it (LeakyBucket.kt:57-64)."""
        while True:
            wait = self.try_put(amount)
            if wait <= 0.0:
                return
            self._sleep(wait)
