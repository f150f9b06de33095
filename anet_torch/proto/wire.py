"""Protobuf wire-format primitives (proto2 semantics).

Hand-written, minimal, and strict: only what the ip.proto contract needs
(varints, length-delimited fields, required-field enforcement). The framing
must agree byte-for-byte with protobuf-java (reference transmitter,
protobuf_async.kt:42-114) and nanopb (reference firmware, pb_decode_delimited
at network.cpp:411); golden tests cross-validate against the stock
google.protobuf runtime.
"""

from __future__ import annotations

from typing import Iterator, Tuple

# Wire types (protobuf encoding spec)
WT_VARINT = 0
WT_I64 = 1
WT_LEN = 2
WT_I32 = 5

_MAX_VARINT_BYTES = 10  # 64-bit varint


class WireError(ValueError):
    """Malformed or contract-violating bytes on the wire."""


def encode_varint(value: int) -> bytes:
    """Encode a non-negative integer as a base-128 varint."""
    if value < 0:
        raise WireError(f"varint must be non-negative, got {value}")
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def decode_varint(data: bytes, pos: int = 0) -> Tuple[int, int]:
    """Decode a varint at ``pos``; returns (value, next_pos).

    Enforces the 10-byte limit so a corrupt stream cannot loop forever —
    the same guarantee nanopb's stream reader provides on the firmware side.
    """
    result = 0
    shift = 0
    start = pos
    while True:
        if pos >= len(data):
            raise WireError("truncated varint")
        if pos - start >= _MAX_VARINT_BYTES:
            raise WireError("varint exceeds 10 bytes")
        byte = data[pos]
        result |= (byte & 0x7F) << shift
        pos += 1
        if not byte & 0x80:
            return result, pos
        shift += 7


def encode_tag(field_number: int, wire_type: int) -> bytes:
    return encode_varint((field_number << 3) | wire_type)


def decode_tag(data: bytes, pos: int) -> Tuple[int, int, int]:
    """Returns (field_number, wire_type, next_pos)."""
    key, pos = decode_varint(data, pos)
    return key >> 3, key & 0x7, pos


def encode_len_field(field_number: int, payload: bytes) -> bytes:
    return encode_tag(field_number, WT_LEN) + encode_varint(len(payload)) + payload


def encode_varint_field(field_number: int, value: int) -> bytes:
    return encode_tag(field_number, WT_VARINT) + encode_varint(value)


def skip_field(data: bytes, pos: int, wire_type: int) -> int:
    """Advance past an unknown field (forward compatibility)."""
    if wire_type == WT_VARINT:
        _, pos = decode_varint(data, pos)
        return pos
    if wire_type == WT_LEN:
        length, pos = decode_varint(data, pos)
        end = pos + length
        if end > len(data):
            raise WireError("truncated length-delimited field")
        return end
    if wire_type == WT_I64:
        if pos + 8 > len(data):
            raise WireError("truncated fixed64 field")
        return pos + 8
    if wire_type == WT_I32:
        if pos + 4 > len(data):
            raise WireError("truncated fixed32 field")
        return pos + 4
    raise WireError(f"unsupported wire type {wire_type}")


def iter_fields(data: bytes) -> Iterator[Tuple[int, int, bytes | int]]:
    """Yield (field_number, wire_type, value) over a serialized message.

    Varint fields yield ints; length-delimited fields yield the raw payload
    bytes. Unknown wire types raise.
    """
    pos = 0
    while pos < len(data):
        field, wtype, pos = decode_tag(data, pos)
        if field == 0:
            raise WireError("field number 0 is invalid")
        if wtype == WT_VARINT:
            value, pos = decode_varint(data, pos)
            yield field, wtype, value
        elif wtype == WT_LEN:
            length, pos = decode_varint(data, pos)
            end = pos + length
            if end > len(data):
                raise WireError("truncated length-delimited field")
            yield field, wtype, data[pos:end]
            pos = end
        else:
            # ip.proto uses only varint and length-delimited fields; tolerate
            # (skip) fixed-width fields from future schema revisions.
            pos = skip_field(data, pos, wtype)


_U32_MAX = (1 << 32) - 1
_U64_MAX = (1 << 64) - 1


def check_uint32(value: int, name: str) -> int:
    if not 0 <= value <= _U32_MAX:
        raise WireError(f"{name} out of uint32 range: {value}")
    return value


def check_uint64(value: int, name: str) -> int:
    if not 0 <= value <= _U64_MAX:
        raise WireError(f"{name} out of uint64 range: {value}")
    return value
