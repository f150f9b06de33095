"""Varint length-delimited message framing over byte streams.

Equivalent wire behavior to the reference's two framing implementations:
protobuf-java ``writeDelimitedTo``/``parseDelimitedFrom`` (used by the
transmitter via protobuf_async.kt:82-114) and nanopb
``pb_encode_delimited``/``pb_decode_delimited`` (used by the firmware at
network.cpp:394,411). Frame = varint(len(payload)) ++ payload.

Three consumption styles are provided:
- blocking file-like streams (``read_delimited`` / ``write_delimited``),
- an incremental push decoder (``DelimitedDecoder``) for non-blocking and
  asyncio transports — the host edge feeds socket bytes through it,
- asyncio StreamReader/StreamWriter coroutines.
"""

from __future__ import annotations

import asyncio
from typing import BinaryIO, Callable, Iterator, List, Optional, TypeVar

from anet_torch.proto.wire import WireError, decode_varint, encode_varint

T = TypeVar("T")

# Sanity cap on a single delimited frame. The largest legal ip.proto message
# is a ToReceiver carrying a 4096-byte AudioData plus tag/length overhead;
# 1 MiB leaves generous headroom while still bounding memory on corrupt input.
MAX_DELIMITED_FRAME_BYTES = 1 << 20


def encode_delimited(payload: bytes) -> bytes:
    """Serialize one frame: varint length prefix + payload bytes."""
    return encode_varint(len(payload)) + payload


def write_delimited(stream: BinaryIO, payload: bytes) -> None:
    stream.write(encode_delimited(payload))


def read_delimited(stream: BinaryIO, max_bytes: int = MAX_DELIMITED_FRAME_BYTES) -> Optional[bytes]:
    """Read one delimited frame from a blocking stream.

    Returns None on clean EOF at a frame boundary; raises WireError on a
    truncated frame or an over-cap length.
    """
    length = 0
    shift = 0
    for i in range(10):
        byte = stream.read(1)
        if not byte:
            if i == 0:
                return None  # clean EOF between frames
            raise WireError("EOF inside varint length prefix")
        b = byte[0]
        length |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            break
    else:
        raise WireError("length prefix varint exceeds 10 bytes")
    if length > max_bytes:
        raise WireError(f"delimited frame of {length} bytes exceeds cap {max_bytes}")
    chunks: List[bytes] = []
    remaining = length
    while remaining:
        chunk = stream.read(remaining)
        if not chunk:
            raise WireError("EOF inside delimited frame payload")
        chunks.append(chunk)
        remaining -= len(chunk)
    return b"".join(chunks)


class DelimitedDecoder:
    """Incremental (push-style) delimited-frame decoder.

    Feed arbitrary byte chunks; complete frames come out. This is the host-
    edge analog of the firmware's streaming ``pb_istream`` over recv()
    (network.cpp:262-305): framing state survives across arbitrarily
    fragmented reads.

    >>> dec = DelimitedDecoder()
    >>> dec.feed(encode_delimited(b"abc")[:2])
    []
    >>> dec.feed(encode_delimited(b"abc")[2:])
    [b'abc']
    """

    def __init__(self, max_bytes: int = MAX_DELIMITED_FRAME_BYTES) -> None:
        self._buf = bytearray()
        # Frames are consumed by advancing a read offset with lazy
        # compaction — deleting the buffer front per frame would memmove
        # the whole remainder once per frame (quadratic when many frames
        # are buffered). Same scheme as the native framer.
        self._pos = 0
        self._max_bytes = max_bytes

    def feed(self, data: bytes) -> List[bytes]:
        self._buf += data
        frames: List[bytes] = []
        while True:
            frame = self._try_pop()
            if frame is None:
                break
            frames.append(frame)
        # compact the consumed prefix once per feed
        if self._pos:
            del self._buf[: self._pos]
            self._pos = 0
        return frames

    def _try_pop(self) -> Optional[bytes]:
        buf = self._buf
        length = 0
        shift = 0
        pos = self._pos
        while True:
            if pos >= len(buf):
                return None  # need more bytes for the length prefix
            if pos - self._pos >= 10:
                raise WireError("length prefix varint exceeds 10 bytes")
            b = buf[pos]
            length |= (b & 0x7F) << shift
            shift += 7
            pos += 1
            if not b & 0x80:
                break
        if length > self._max_bytes:
            raise WireError(f"delimited frame of {length} bytes exceeds cap {self._max_bytes}")
        end = pos + length
        if len(buf) < end:
            return None  # need more payload bytes
        frame = bytes(buf[pos:end])
        self._pos = end
        return frame

    @property
    def pending_bytes(self) -> int:
        """Bytes buffered but not yet forming a complete frame."""
        return len(self._buf) - self._pos


def iter_delimited(data: bytes) -> Iterator[bytes]:
    """Split a fully-buffered byte string into its delimited frames."""
    pos = 0
    while pos < len(data):
        length, pos = decode_varint(data, pos)
        end = pos + length
        if end > len(data):
            raise WireError("truncated delimited frame")
        yield data[pos:end]
        pos = end


async def read_delimited_async(
    reader: asyncio.StreamReader, max_bytes: int = MAX_DELIMITED_FRAME_BYTES
) -> Optional[bytes]:
    """Read one delimited frame from an asyncio stream (None on clean EOF)."""
    length = 0
    shift = 0
    for i in range(10):
        try:
            byte = await reader.readexactly(1)
        except asyncio.IncompleteReadError:
            if i == 0:
                return None
            raise WireError("EOF inside varint length prefix") from None
        b = byte[0]
        length |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            break
    else:
        raise WireError("length prefix varint exceeds 10 bytes")
    if length > max_bytes:
        raise WireError(f"delimited frame of {length} bytes exceeds cap {max_bytes}")
    try:
        return await reader.readexactly(length)
    except asyncio.IncompleteReadError:
        raise WireError("EOF inside delimited frame payload") from None


async def read_delimited_message(
    reader: asyncio.StreamReader,
    parse: Callable[[bytes], T],
    max_bytes: int = MAX_DELIMITED_FRAME_BYTES,
) -> Optional[T]:
    """Read + parse one delimited message (analog of readSingleDelimited,
    protobuf_async.kt:82-108)."""
    frame = await read_delimited_async(reader, max_bytes)
    return None if frame is None else parse(frame)


def write_delimited_async(writer: asyncio.StreamWriter, payload: bytes) -> None:
    """Queue one delimited frame on an asyncio writer (await drain() to
    apply backpressure, analog of writeSingleDelimited, protobuf_async.kt:110)."""
    writer.write(encode_delimited(payload))
