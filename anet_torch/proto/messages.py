"""The seven ip.proto messages as typed dataclasses with strict proto2 codecs.

Schema contract (field numbers, types, required-ness, oneofs) mirrors
the reference system's protocol/ip.proto:9-65. Encoding writes fields in ascending
field-number order, matching what protobuf-java and nanopb emit, so byte
streams are reproducible across all three implementations.

proto2 strictness implemented here (and verified in tests):
- ``required`` fields must be present on decode and on encode.
- oneof: at most one member set; on decode, last-seen member wins (protobuf
  merge semantics).
- nanopb string caps: device_name / opus_version limited to 128 bytes
  (protobuf_ip.options:1-2 in the reference firmware), enforced on encode so
  we never emit a frame the firmware would reject.
- AudioData payload capped at MAX_ENCODED_FRAME_SIZE = 4096 on decode,
  mirroring the firmware's frame-cap check (network.cpp:24,223).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from anet_torch import constants
from anet_torch.proto import wire
from anet_torch.proto.wire import WT_LEN, WT_VARINT, WireError


def _require(present: bool, message: str, field: str) -> None:
    if not present:
        raise WireError(f"{message}: missing required field '{field}'")


def _as_varint(value: object, message: str, field: str) -> int:
    if not isinstance(value, int):
        raise WireError(f"{message}.{field}: expected varint wire type")
    return value


def _as_bytes(value: object, message: str, field: str) -> bytes:
    if not isinstance(value, bytes):
        raise WireError(f"{message}.{field}: expected length-delimited wire type")
    return value


def _as_utf8(value: object, message: str, field: str) -> str:
    """Decode a string field; bad UTF-8 is a wire error, not a crash —
    discovery must survive arbitrary LAN datagrams."""
    raw = _as_bytes(value, message, field)
    try:
        return raw.decode("utf-8")
    except UnicodeDecodeError as e:
        raise WireError(f"{message}.{field}: invalid UTF-8: {e}") from None


def _check_string(text: str, limit: int, message: str, field: str) -> bytes:
    raw = text.encode("utf-8")
    if len(raw) > limit:
        raise WireError(
            f"{message}.{field}: {len(raw)} bytes exceeds nanopb cap {limit}"
        )
    return raw


@dataclass(frozen=True)
class DiscoveryResponse:
    """Receiver identity/capability card (ip.proto:20-27)."""

    protocol_version: int
    mac_address: int
    device_name: str
    currently_streaming: bool
    opus_version: str

    def encode(self) -> bytes:
        out = bytearray()
        out += wire.encode_varint_field(
            1, wire.check_uint32(self.protocol_version, "protocol_version")
        )
        out += wire.encode_varint_field(
            2, wire.check_uint64(self.mac_address, "mac_address")
        )
        out += wire.encode_len_field(
            3,
            _check_string(
                self.device_name,
                constants.MAX_DEVICE_NAME_BYTES,
                "DiscoveryResponse",
                "device_name",
            ),
        )
        out += wire.encode_varint_field(4, 1 if self.currently_streaming else 0)
        out += wire.encode_len_field(
            5,
            _check_string(
                self.opus_version,
                constants.MAX_OPUS_VERSION_BYTES,
                "DiscoveryResponse",
                "opus_version",
            ),
        )
        return bytes(out)

    @classmethod
    def decode(cls, data: bytes) -> "DiscoveryResponse":
        protocol_version = mac_address = None
        device_name = opus_version = None
        currently_streaming = None
        for field, wtype, value in wire.iter_fields(data):
            if field == 1 and wtype == WT_VARINT:
                protocol_version = _as_varint(value, "DiscoveryResponse", "protocol_version")
            elif field == 2 and wtype == WT_VARINT:
                mac_address = _as_varint(value, "DiscoveryResponse", "mac_address")
            elif field == 3 and wtype == WT_LEN:
                device_name = _as_utf8(value, "DiscoveryResponse", "device_name")
            elif field == 4 and wtype == WT_VARINT:
                currently_streaming = bool(value)
            elif field == 5 and wtype == WT_LEN:
                opus_version = _as_utf8(value, "DiscoveryResponse", "opus_version")
        _require(protocol_version is not None, "DiscoveryResponse", "protocol_version")
        _require(mac_address is not None, "DiscoveryResponse", "mac_address")
        _require(device_name is not None, "DiscoveryResponse", "device_name")
        _require(currently_streaming is not None, "DiscoveryResponse", "currently_streaming")
        _require(opus_version is not None, "DiscoveryResponse", "opus_version")
        return cls(protocol_version, mac_address, device_name, currently_streaming, opus_version)


@dataclass(frozen=True)
class BroadcastMessage:
    """UDP discovery datagram (ip.proto:9-18).

    oneof message: exactly one of discovery_request / discovery_response.
    """

    magic_word: int
    discovery_request: Optional[bool] = None
    discovery_response: Optional[DiscoveryResponse] = None

    def __post_init__(self) -> None:
        if (self.discovery_request is not None) and (self.discovery_response is not None):
            raise WireError("BroadcastMessage: oneof 'message' has two members set")

    @property
    def has_valid_magic(self) -> bool:
        return self.magic_word == constants.MAGIC_WORD

    def encode(self) -> bytes:
        out = bytearray()
        out += wire.encode_varint_field(
            1, wire.check_uint32(self.magic_word, "magic_word")
        )
        if self.discovery_request is not None:
            out += wire.encode_varint_field(2, 1 if self.discovery_request else 0)
        elif self.discovery_response is not None:
            out += wire.encode_len_field(3, self.discovery_response.encode())
        return bytes(out)

    @classmethod
    def decode(cls, data: bytes) -> "BroadcastMessage":
        magic_word = None
        request: Optional[bool] = None
        response: Optional[DiscoveryResponse] = None
        for field, wtype, value in wire.iter_fields(data):
            if field == 1 and wtype == WT_VARINT:
                magic_word = _as_varint(value, "BroadcastMessage", "magic_word")
            elif field == 2 and wtype == WT_VARINT:
                request, response = bool(value), None  # oneof: last wins
            elif field == 3 and wtype == WT_LEN:
                request, response = None, DiscoveryResponse.decode(
                    _as_bytes(value, "BroadcastMessage", "discovery_response")
                )
        _require(magic_word is not None, "BroadcastMessage", "magic_word")
        return cls(magic_word, request, response)


@dataclass(frozen=True)
class AudioData:
    """One encoded audio frame (ip.proto:63-65)."""

    opus_encoded_frame: bytes

    def encode(self) -> bytes:
        return wire.encode_len_field(1, self.opus_encoded_frame)

    @classmethod
    def decode(cls, data: bytes, max_frame_size: int = constants.MAX_ENCODED_FRAME_SIZE) -> "AudioData":
        frame = None
        for field, wtype, value in wire.iter_fields(data):
            if field == 1 and wtype == WT_LEN:
                frame = _as_bytes(value, "AudioData", "opus_encoded_frame")
        _require(frame is not None, "AudioData", "opus_encoded_frame")
        if len(frame) > max_frame_size:
            raise WireError(
                f"AudioData frame of {len(frame)} bytes exceeds cap {max_frame_size}"
            )
        return cls(frame)


@dataclass(frozen=True)
class ToReceiver:
    """Transmitter -> receiver TCP message (ip.proto:32-36)."""

    audio_data: Optional[AudioData] = None

    def encode(self) -> bytes:
        if self.audio_data is None:
            return b""
        return wire.encode_len_field(1, self.audio_data.encode())

    @classmethod
    def decode(cls, data: bytes, max_frame_size: int = constants.MAX_ENCODED_FRAME_SIZE) -> "ToReceiver":
        audio: Optional[AudioData] = None
        for field, wtype, value in wire.iter_fields(data):
            if field == 1 and wtype == WT_LEN:
                audio = AudioData.decode(
                    _as_bytes(value, "ToReceiver", "audio_data"), max_frame_size
                )
        return cls(audio)


@dataclass(frozen=True)
class ReceiverInformation:
    """Hello / capability negotiation payload (ip.proto:48-54)."""

    discovery_data: DiscoveryResponse
    max_encoded_frame_size: int
    max_decoded_frame_size: int

    def encode(self) -> bytes:
        out = bytearray()
        out += wire.encode_len_field(1, self.discovery_data.encode())
        out += wire.encode_varint_field(
            2, wire.check_uint32(self.max_encoded_frame_size, "max_encoded_frame_size")
        )
        out += wire.encode_varint_field(
            3, wire.check_uint32(self.max_decoded_frame_size, "max_decoded_frame_size")
        )
        return bytes(out)

    @classmethod
    def decode(cls, data: bytes) -> "ReceiverInformation":
        discovery = max_enc = max_dec = None
        for field, wtype, value in wire.iter_fields(data):
            if field == 1 and wtype == WT_LEN:
                discovery = DiscoveryResponse.decode(
                    _as_bytes(value, "ReceiverInformation", "discovery_data")
                )
            elif field == 2 and wtype == WT_VARINT:
                max_enc = _as_varint(value, "ReceiverInformation", "max_encoded_frame_size")
            elif field == 3 and wtype == WT_VARINT:
                max_dec = _as_varint(value, "ReceiverInformation", "max_decoded_frame_size")
        _require(discovery is not None, "ReceiverInformation", "discovery_data")
        _require(max_enc is not None, "ReceiverInformation", "max_encoded_frame_size")
        _require(max_dec is not None, "ReceiverInformation", "max_decoded_frame_size")
        return cls(discovery, max_enc, max_dec)


@dataclass(frozen=True)
class ReceiverError:
    """Receiver -> transmitter quality feedback (ip.proto:56-61).

    Designed-but-never-sent in the reference (TODO at playback.cpp:94);
    anet implements the feedback loop for real — see anet_torch.rx.playback.
    """

    audio_underflow: bool
    audio_decode_error: bool

    def encode(self) -> bytes:
        out = bytearray()
        out += wire.encode_varint_field(1, 1 if self.audio_underflow else 0)
        out += wire.encode_varint_field(2, 1 if self.audio_decode_error else 0)
        return bytes(out)

    @classmethod
    def decode(cls, data: bytes) -> "ReceiverError":
        underflow = decode_error = None
        for field, wtype, value in wire.iter_fields(data):
            if field == 1 and wtype == WT_VARINT:
                underflow = bool(value)
            elif field == 2 and wtype == WT_VARINT:
                decode_error = bool(value)
        _require(underflow is not None, "ReceiverError", "audio_underflow")
        _require(decode_error is not None, "ReceiverError", "audio_decode_error")
        return cls(underflow, decode_error)


@dataclass(frozen=True)
class ToTransmitter:
    """Receiver -> transmitter TCP message (ip.proto:41-46)."""

    receiver_information: Optional[ReceiverInformation] = None
    error: Optional[ReceiverError] = None

    def __post_init__(self) -> None:
        if (self.receiver_information is not None) and (self.error is not None):
            raise WireError("ToTransmitter: oneof 'message' has two members set")

    def encode(self) -> bytes:
        if self.receiver_information is not None:
            return wire.encode_len_field(1, self.receiver_information.encode())
        if self.error is not None:
            return wire.encode_len_field(2, self.error.encode())
        return b""

    @classmethod
    def decode(cls, data: bytes) -> "ToTransmitter":
        info: Optional[ReceiverInformation] = None
        error: Optional[ReceiverError] = None
        for field, wtype, value in wire.iter_fields(data):
            if field == 1 and wtype == WT_LEN:
                info, error = ReceiverInformation.decode(
                    _as_bytes(value, "ToTransmitter", "receiver_information")
                ), None
            elif field == 2 and wtype == WT_LEN:
                info, error = None, ReceiverError.decode(
                    _as_bytes(value, "ToTransmitter", "error")
                )
        return cls(info, error)
