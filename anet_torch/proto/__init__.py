"""The ip.proto wire contract, implemented from scratch in pure Python.

Wire-compatible with both reference codecs: protobuf-java's
``writeDelimitedTo`` (transmitter side) and nanopb's ``pb_decode_delimited``
(receiver firmware side). Schema source: the reference
system's protocol/ip.proto.
"""

from anet_torch.proto.messages import (
    AudioData,
    BroadcastMessage,
    DiscoveryResponse,
    ReceiverError,
    ReceiverInformation,
    ToReceiver,
    ToTransmitter,
)
from anet_torch.proto.framing import (
    DelimitedDecoder,
    encode_delimited,
    read_delimited,
    write_delimited,
)
from anet_torch.proto.wire import WireError, decode_varint, encode_varint

__all__ = [
    "AudioData",
    "BroadcastMessage",
    "DiscoveryResponse",
    "ReceiverError",
    "ReceiverInformation",
    "ToReceiver",
    "ToTransmitter",
    "DelimitedDecoder",
    "encode_delimited",
    "read_delimited",
    "write_delimited",
    "WireError",
    "decode_varint",
    "encode_varint",
]
