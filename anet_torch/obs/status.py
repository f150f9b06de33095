"""Status indicator: system state -> human-visible pattern.

The LED module analog (led.cpp:16-97): a tiny observability UI that polls
the other modules' states on an interval (100 ms reaction time,
led.hpp:2) and renders a pattern. On a host there is no GPIO LED, so the
pattern is a short glyph string surfaced via callback/logging — same
state machine:

    disconnected -> red blink   ("(R)  _  (R)  _")
    connected    -> solid green ("(G)(G)(G)")
    config mode  -> blue blink  ("(B)  _  (B)  _")
    panic        -> fast red    ("(R)(R)(R)!")
"""

from __future__ import annotations

import enum
import threading
from typing import Callable, Dict, Optional


class SystemState(enum.Enum):
    DISCONNECTED = "disconnected"
    CONNECTED = "connected"
    STREAMING = "streaming"
    CONFIG = "config"
    PANIC = "panic"


PATTERNS: Dict[SystemState, str] = {
    SystemState.DISCONNECTED: "(R) _ (R) _",
    SystemState.CONNECTED: "(G)(G)(G)",
    SystemState.STREAMING: "(G)(G)(G)",
    SystemState.CONFIG: "(B) _ (B) _",
    SystemState.PANIC: "(R)(R)(R)!",
}


class StatusIndicator:
    """Polls a state provider and notifies on changes (led.cpp:75-97)."""

    def __init__(
        self,
        state_provider: Callable[[], SystemState],
        on_change: Optional[Callable[[SystemState, str], None]] = None,
        poll_interval_s: float = 0.1,  # led.hpp:2 reaction time
    ) -> None:
        self._provider = state_provider
        self._on_change = on_change
        self._interval = poll_interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.state: Optional[SystemState] = None

    @property
    def pattern(self) -> str:
        return PATTERNS[self.state] if self.state else ""

    def poll_once(self) -> SystemState:
        new = self._provider()
        if new != self.state:
            self.state = new
            if self._on_change:
                self._on_change(new, PATTERNS[new])
        return new

    def start(self) -> "StatusIndicator":
        if self._thread is not None:
            raise RuntimeError("indicator already started")
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="anet-status"
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — indicator must never kill the app
                pass

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
            self._thread = None
