"""Receiver module runtime.

Parity with the firmware's boot/module convention (main.cpp:9-21,
hardware/README.md:10-14): every subsystem is a module with an initialize
hook, brought up in registration order; a fatal error anywhere panics the
runtime with a diagnosable state instead of the firmware's infinite red
blink (runtime.cpp:5-24). `status()` aggregates per-module state — the
network_get_state surface (network.cpp:590-605) generalized to every
module, consumed by the status indicator (anet_torch.obs.status, the LED analog).
"""

from __future__ import annotations

import abc
import logging
import threading
import time
from typing import Dict, List, Optional

logger = logging.getLogger("anet_torch.rx")


class PanicError(RuntimeError):
    """Fatal runtime error; carries the state dump (panic() analog)."""

    def __init__(self, message: str, state: Optional[Dict] = None) -> None:
        super().__init__(message)
        self.state = state or {}


class Module(abc.ABC):
    """One receiver subsystem (network / playback / config / status)."""

    name: str = "module"

    @abc.abstractmethod
    def initialize(self, runtime: "ReceiverRuntime") -> None:
        """Bring the module up; spawn threads as needed."""

    def shutdown(self) -> None:
        """Best-effort teardown (no firmware analog — power-off there)."""

    def status(self) -> Dict:
        """Structured state snapshot for the status surface."""
        return {}


class ReceiverRuntime:
    """Ordered module bring-up + aggregated status + panic handling."""

    def __init__(self) -> None:
        self._modules: List[Module] = []
        self._started = False
        self._panicked: Optional[str] = None
        self._start_time: Optional[float] = None
        self._lock = threading.Lock()

    def register(self, module: Module) -> "ReceiverRuntime":
        if self._started:
            raise RuntimeError("cannot register modules after start")
        self._modules.append(module)
        return self

    def start(self) -> "ReceiverRuntime":
        """Initialize modules in registration order (main.cpp:16-20)."""
        with self._lock:
            if self._started:
                raise RuntimeError("runtime already started")
            self._start_time = time.monotonic()
            for module in self._modules:
                try:
                    logger.info("initializing module %s", module.name)
                    module.initialize(self)
                except Exception as e:  # noqa: BLE001
                    self.panic(f"module {module.name} failed to initialize: {e}")
            self._started = True
        return self

    def panic(self, message: str) -> None:
        """Fatal: capture state, tear down, raise (runtime.cpp:5 analog)."""
        state = self.status()
        self._panicked = message
        logger.critical("PANIC: %s | state=%s", message, state)
        for module in reversed(self._modules):
            try:
                module.shutdown()
            except Exception:  # noqa: BLE001
                pass
        raise PanicError(message, state)

    def stop(self) -> None:
        for module in reversed(self._modules):
            try:
                module.shutdown()
            except Exception:  # noqa: BLE001
                logger.exception("module %s shutdown failed", module.name)
        self._started = False

    def status(self) -> Dict:
        """Aggregated structured state (network_get_state analog)."""
        return {
            "started": self._started,
            "panicked": self._panicked,
            "uptime_s": (
                round(time.monotonic() - self._start_time, 3)
                if self._start_time
                else 0.0
            ),
            "modules": {m.name: m.status() for m in self._modules},
        }

    def __enter__(self) -> "ReceiverRuntime":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def format_hex(data: bytes, max_bytes: int = 64) -> str:
    """Debug hex dump (runtime.cpp:28-41 / Main.kt:26-42 analog)."""
    shown = data[:max_bytes]
    hex_part = " ".join(f"{b:02x}" for b in shown)
    suffix = f" ... (+{len(data) - max_bytes}B)" if len(data) > max_bytes else ""
    return hex_part + suffix
