"""Connection-recovery state machine.

Parity with the firmware WiFi recovery policy (network.cpp:157-199,437-446;
constants network.hpp:7-8): on loss, up to 10 immediate retries, then a
1000 ms cooldown before the next burst — repeating forever (or until a
bound, for testability). Generalized so any connect callable can be driven
by it (anet uses it to re-establish transmitter->receiver sessions).
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional, TypeVar

from anet_torch import constants

logger = logging.getLogger("anet_torch.net.reconnect")

T = TypeVar("T")


class ReconnectPolicy:
    def __init__(
        self,
        max_immediate_retries: int = constants.RECONNECT_MAX_IMMEDIATE_RETRIES,
        cooldown_s: float = constants.RECONNECT_COOLDOWN_MS / 1000.0,
        sleep: Callable[[float], None] = time.sleep,
    ) -> None:
        self.max_immediate_retries = max_immediate_retries
        self.cooldown_s = cooldown_s
        self._sleep = sleep
        self.attempts = 0
        self.cooldowns = 0

    def run(
        self,
        connect: Callable[[], T],
        max_cooldowns: Optional[int] = None,
        should_continue: Callable[[], bool] = lambda: True,
    ) -> T:
        """Call ``connect`` until it succeeds.

        Bursts of ``max_immediate_retries`` attempts separated by cooldown
        sleeps; ``max_cooldowns`` bounds the total (None = forever, the
        firmware behavior); ``should_continue`` allows cooperative abort.
        Raises the last error when bounded out.
        """
        last_error: Optional[BaseException] = None
        cooldowns_done = 0
        while should_continue():
            for retry in range(self.max_immediate_retries):
                self.attempts += 1
                try:
                    return connect()
                except Exception as e:  # noqa: BLE001
                    last_error = e
                    logger.debug(
                        "connect attempt %d/%d failed: %s",
                        retry + 1,
                        self.max_immediate_retries,
                        e,
                    )
            if max_cooldowns is not None and cooldowns_done >= max_cooldowns:
                break
            cooldowns_done += 1
            self.cooldowns += 1
            logger.info(
                "retries exhausted; cooling down %.1f s (cooldown #%d)",
                self.cooldown_s,
                cooldowns_done,
            )
            self._sleep(self.cooldown_s)
        if last_error is not None:
            raise last_error
        raise RuntimeError("reconnect aborted before any attempt")
