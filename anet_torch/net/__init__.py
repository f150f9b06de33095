"""Host-edge networking: discovery, capability negotiation, framed TCP audio.

The wire behavior matches the reference system (ip.proto over UDP 58765 /
TCP 58764 with varint-delimited framing), so an anet transmitter can drive
reference receivers and vice versa. The modem data plane never touches these
sockets (SURVEY.md §5) — this package is the ingest/egress edge.

The hot byte-path (streaming delimited framing, datagram validation) runs
in a small C++ core (anet_torch/net/csrc, built on first use), mirroring the reference's
native firmware layer; pure-Python fallbacks keep everything working
without it.
"""

from anet_torch.net.discovery import (
    DiscoveredReceiver,
    DiscoveryResponder,
    discover_receivers,
)
from anet_torch.net.native import NativeFramer, available as native_available, broadcast_address
from anet_torch.net.server import AudioStreamServer
from anet_torch.net.session import RemoteAudioReceiver, SessionError

__all__ = [
    "AudioStreamServer",
    "DiscoveredReceiver",
    "DiscoveryResponder",
    "NativeFramer",
    "RemoteAudioReceiver",
    "SessionError",
    "broadcast_address",
    "discover_receivers",
    "native_available",
]
