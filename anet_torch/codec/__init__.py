"""Audio codec layer: Opus encode/decode + frame chunking.

Capability parity with the reference's L1 codec layer (SURVEY.md §1):
the transmitter's JNA-wrapped encoder (OpusEncoder.kt) and the firmware's
vendored fixed-point decoder (playback.cpp:118) both become thin ctypes
bindings over the system libopus — no vendored code, same wire-compatible
Opus packets.
"""

from anet_torch.codec.ring import ByteRingBuffer, RingBufferError
from anet_torch.codec.errors import OpusError
from anet_torch.codec.opus import (
    AudioFormat,
    AudioFormatNotSupportedError,
    OpusDecoder,
    OpusEncoder,
    SUPPORTED_FRAME_DURATIONS_MS,
    SUPPORTED_SAMPLE_RATES,
    opus_available,
    opus_version,
)

__all__ = [
    "AudioFormat",
    "AudioFormatNotSupportedError",
    "ByteRingBuffer",
    "OpusDecoder",
    "OpusEncoder",
    "OpusError",
    "RingBufferError",
    "SUPPORTED_FRAME_DURATIONS_MS",
    "SUPPORTED_SAMPLE_RATES",
    "opus_available",
    "opus_version",
]
