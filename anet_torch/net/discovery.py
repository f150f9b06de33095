"""UDP discovery: client (transmitter side) and responder (receiver side).

Client parity with the reference transmitter (discovery.kt:23-97): send
BroadcastMessage{magic, discovery_request} to every non-loopback interface
broadcast address, collect valid discovery_response datagrams until the
timeout.

Responder parity with the firmware task (network.cpp:449-494): bind UDP
58765, validate magic + request tag, reply with this receiver's identity
card. The validation + reply loop runs in the native core
(anet_discovery_responder_run) when available, in Python otherwise —
same datagrams either way.
"""

from __future__ import annotations

import dataclasses
import socket
import threading
import time
from typing import List, Optional

from anet_torch import constants
from anet_torch.net import native
from anet_torch.proto import BroadcastMessage, DiscoveryResponse
from anet_torch.proto.wire import WireError


@dataclasses.dataclass(frozen=True)
class DiscoveredReceiver:
    """A receiver that answered discovery (discovery.kt:99 parity)."""

    address: str
    port: int
    response: DiscoveryResponse

    @property
    def device_name(self) -> str:
        return self.response.device_name


def _broadcast_targets(interfaces: Optional[List[tuple]] = None) -> List[str]:
    """Directed broadcast addresses of all non-loopback interfaces, plus
    the limited broadcast address (discovery.kt:33-40 enumerates every
    interface's real (address, netmask); 255.255.255.255 covers receivers
    on the same link regardless of subnetting).

    ``interfaces`` overrides enumeration for tests: (addr, netmask) pairs
    as from native.list_interfaces()."""
    targets = {"255.255.255.255", "127.255.255.255"}
    if interfaces is None:
        interfaces = native.list_interfaces()
    for addr, netmask in interfaces:
        try:
            targets.add(native.broadcast_address(addr, netmask))
        except OSError:
            continue
    if not interfaces:
        # Enumeration unavailable: fall back to the historical /24 guess
        # from the host's primary address.
        try:
            host = socket.gethostbyname(socket.gethostname())
            if not host.startswith("127."):
                targets.add(native.broadcast_address(host, "255.255.255.0"))
        except OSError:
            pass
    return sorted(targets)


def discover_receivers(
    timeout_s: float = constants.DISCOVERY_TIMEOUT_S,
    port: int = constants.UDP_DISCOVERY_PORT,
    targets: Optional[List[str]] = None,
) -> List[DiscoveredReceiver]:
    """Broadcast a discovery request and collect responses until timeout.

    The reference enforces the timeout with a watchdog thread that closes
    the socket (discovery.kt:51-59); here a socket timeout bounds each
    receive and a deadline bounds the loop — same observable behavior.
    """
    request = BroadcastMessage(
        constants.MAGIC_WORD, discovery_request=True
    ).encode()
    found: List[DiscoveredReceiver] = []
    seen = set()
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as sock:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_BROADCAST, 1)
        sock.bind(("", 0))
        for target in targets if targets is not None else _broadcast_targets():
            try:
                sock.sendto(request, (target, port))
            except OSError:
                continue  # interface may not support broadcast
        deadline = time.monotonic() + timeout_s
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return found
            sock.settimeout(remaining)
            try:
                datagram, peer = sock.recvfrom(4096)
            except socket.timeout:
                return found
            except OSError:
                return found
            try:
                msg = BroadcastMessage.decode(datagram)
            except WireError:
                continue  # not ours (magic/port clash, discovery.kt:87)
            if not msg.has_valid_magic or msg.discovery_response is None:
                continue
            if peer in seen:
                continue
            seen.add(peer)
            found.append(
                DiscoveredReceiver(
                    address=peer[0], port=peer[1], response=msg.discovery_response
                )
            )


class DiscoveryResponder:
    """Receiver-side discovery answering service.

    Runs the reply loop on a daemon thread — in the native core when the
    compiled library is present, else in Python. `stop()` is prompt (the
    loop polls a stop flag between bounded receives, mirroring the
    firmware task's cancellable blocking receive).
    """

    RESPONSE_BUF_BYTES = 512  # comfortably above the max ip.proto response

    def __init__(
        self,
        identity: DiscoveryResponse,
        port: int = constants.UDP_DISCOVERY_PORT,
        use_native: Optional[bool] = None,
    ) -> None:
        import ctypes

        self.identity = identity
        self.port = port
        if use_native is None:
            use_native = native.available()
        self._use_native = use_native
        self._thread: Optional[threading.Thread] = None
        # Stable, caller-owned response buffer: the native loop reads
        # (buffer, *length) per datagram, so identity updates rewrite the
        # buffer in place — no restart, and no dangling pointer into a
        # reassigned Python bytes object. Created here (not in the thread)
        # so a stop() racing a fresh start() can always signal the loop.
        self._resp_buf = ctypes.create_string_buffer(self.RESPONSE_BUF_BYTES)
        self._resp_len = ctypes.c_int32(0)
        self._stop_flag = ctypes.c_int32(0)
        self._py_stop = threading.Event()
        self._error: Optional[int] = None
        self._write_response(identity)

    def _write_response(self, identity: DiscoveryResponse) -> None:
        encoded = BroadcastMessage(
            constants.MAGIC_WORD, discovery_response=identity
        ).encode()
        if len(encoded) > self.RESPONSE_BUF_BYTES:
            raise ValueError("discovery response exceeds the responder buffer")
        # bytes first, then length: the native loop reads length atomically
        self._resp_buf[: len(encoded)] = encoded
        self._resp_len.value = len(encoded)
        self._response = encoded  # python-loop path reads this

    def start(self) -> "DiscoveryResponder":
        if self._thread is not None:
            raise RuntimeError("responder already started")
        self._stop_flag.value = 0
        self._py_stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True, name="anet-discovery")
        self._thread.start()
        time.sleep(0.05)  # let the socket bind before callers broadcast
        return self

    def update_identity(self, identity: DiscoveryResponse) -> None:
        """Refresh the advertised identity (e.g. currently_streaming flips).

        Both loops pick the new response up on the next datagram: the
        Python loop re-reads self._response; the native loop re-reads the
        shared (buffer, length) pair. No restart, no answering gap.
        """
        self.identity = identity
        self._write_response(identity)

    def _run(self) -> None:
        if self._use_native:
            import ctypes

            lib = native.load()
            rc = lib.anet_discovery_responder_run(
                self.port,
                constants.MAGIC_WORD,
                ctypes.cast(self._resp_buf, ctypes.c_char_p),
                ctypes.byref(self._resp_len),
                ctypes.byref(self._stop_flag),
                100,
            )
            if rc != 0:
                self._error = rc
            return
        # Pure-Python loop
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as sock:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            try:
                sock.bind(("", self.port))
            except OSError as e:
                self._error = -e.errno
                return
            sock.settimeout(0.1)
            while not self._py_stop.is_set():
                try:
                    datagram, peer = sock.recvfrom(2048)
                except socket.timeout:
                    continue
                if native.validate_discovery_request(datagram, constants.MAGIC_WORD):
                    sock.sendto(self._response, peer)

    def stop(self) -> None:
        if self._stop_flag is not None:
            self._stop_flag.value = 1
        self._py_stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def __enter__(self) -> "DiscoveryResponder":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
