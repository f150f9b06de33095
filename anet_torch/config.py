"""Typed JSON configuration with presence-gated loading.

Parity with the firmware config module (config.cpp:115-145): configuration
lives in a JSON file; consumers that need it BLOCK until it exists (the
event-group gating of config_await_and_get_wifi), then get a typed struct.
The wifi.json {ssid, psk} analog here is the receiver's identity/transport
config; modem/channel configs already JSON-round-trip on their own
dataclasses (ModemConfig / ChannelConfig).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import threading
import time
from typing import Callable, Optional

from anet_torch import constants

logger = logging.getLogger("anet_torch.config")


@dataclasses.dataclass(frozen=True)
class ReceiverConfig:
    """Receiver identity + transport parameters (wifi.json analog)."""

    device_name: str = "anet-receiver"
    udp_discovery_port: int = constants.UDP_DISCOVERY_PORT
    tcp_audio_port: int = constants.TCP_AUDIO_PORT
    max_encoded_frame_size: int = constants.MAX_ENCODED_FRAME_SIZE
    max_decoded_frame_size: int = constants.MAX_DECODED_FRAME_SIZE
    queue_depth: int = constants.RX_FRAME_QUEUE_DEPTH
    mac_address: Optional[int] = None  # None -> derive from hostname

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "ReceiverConfig":
        return cls(**json.loads(text))

    def resolved_mac(self) -> int:
        """MAC-derived device id (network.cpp:363-368 uses the real MAC)."""
        if self.mac_address is not None:
            return self.mac_address
        import socket
        import zlib

        host = socket.gethostname().encode()
        return 0x0200_0000_0000 | (zlib.crc32(host) & 0xFFFF_FFFF)


class ConfigTimeout(TimeoutError):
    pass


def await_and_load(
    path: str,
    timeout_s: Optional[float] = None,
    poll_interval_s: float = 0.1,
) -> ReceiverConfig:
    """Block until the config file exists and parses, then return it.

    A writer that creates the file and fills it afterwards is read half
    written in between: a parse failure (json.JSONDecodeError, or the
    ValueError, KeyError or TypeError that ReceiverConfig.from_json raises
    on a partial file) polls again, as a missing file does. Past the
    deadline a missing file raises ConfigTimeout and one that never parsed
    its last parse error. The firmware blocks forever on the config event
    group (config.cpp:117-126); pass timeout_s=None for the same behavior,
    or a bound for testability.
    """
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    while True:
        try:
            with open(path, "r", encoding="utf-8") as fh:
                return ReceiverConfig.from_json(fh.read())
        except FileNotFoundError:
            if deadline is not None and time.monotonic() > deadline:
                raise ConfigTimeout(f"config file {path} did not appear in {timeout_s}s") from None
        except (ValueError, KeyError, TypeError):  # json.JSONDecodeError is a ValueError
            if deadline is not None and time.monotonic() > deadline:
                raise
        time.sleep(poll_interval_s)


class ConfigMode:
    """Host analog of the firmware's config task (config.cpp:16-45).

    On the device, a button ISR notifies the config task, which raises the
    "config interface active" bit while the configuration interface is up;
    the LED module renders that bit as the blue-blink pattern
    (led.cpp:37-41). Here the trigger is a POSIX signal (or a direct
    ``enter()`` call): while the latch is ``active``, status providers
    should report ``SystemState.CONFIG``; a worker thread runs ``apply``
    (typically: await + reload the config file, push the new identity) and
    the bit drops when it returns — or on error, which is logged, never
    raised into the app (the indicator contract).
    """

    def __init__(self, apply: Callable[[], None]) -> None:
        self._apply = apply
        self._active = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def active(self) -> bool:
        return self._active.is_set()

    def enter(self) -> bool:
        """Raise the config bit and start the apply worker. Returns False
        (no-op) if config mode is already active — repeated button presses
        don't stack config tasks (config.cpp's single task)."""
        if self._active.is_set():
            return False
        self._active.set()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="anet-config-mode"
        )
        self._thread.start()
        return True

    def _run(self) -> None:
        try:
            self._apply()
        except Exception:  # noqa: BLE001 — config failure must not kill the app
            logger.exception("config apply failed")
        finally:
            self._active.clear()

    def wait(self, timeout_s: Optional[float] = None) -> bool:
        """Block until the current apply finishes (for tests/shutdown)."""
        t = self._thread
        if t is None:
            return True
        t.join(timeout=timeout_s)
        return not t.is_alive()

    def install_signal_handler(self, signum: Optional[int] = None) -> None:
        """Route a signal (default SIGHUP — the unix 'reconfigure' idiom,
        standing in for the device's config button) to ``enter()``. Must be
        called from the main thread."""
        import signal as _signal

        sig = _signal.SIGHUP if signum is None else signum
        _signal.signal(sig, lambda *_: self.enter())
