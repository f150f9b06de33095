"""Opus encoder/decoder over the system libopus via ctypes.

Behavioral parity with the reference encoder wrapper (OpusEncoder.kt):
- format validation: signed 16-bit little-endian PCM, 1-2 channels,
  sample rate in {8, 12, 16, 24, 48} kHz (OpusEncoder.kt:22-41,195);
- encoder setup: bitrate 92 kbps, complexity 10, SIGNAL_MUSIC, max
  bandwidth mapped from the sample rate (OpusEncoder.kt:51-64);
- input buffered in a ring buffer and chopped into whole frames
  (OpusEncoder.kt:85-110); `final()` zero-pads the tail to a full frame
  (OpusEncoder.kt:116-127);
- mutable frame duration in {2.5, 5, 10, 20, 40, 60} ms and mutable
  max_encoded_frame_size, renegotiated per receiver set
  (OpusEncoder.kt:70-80, MulticastAudioOutput.kt:123-131).

And with the firmware decoder (playback.cpp:67-74,116-122): a decoder
fixed at 48 kHz stereo, recreated per stream, one frame per packet.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
from typing import List, Optional

from anet_torch import constants
from anet_torch.codec.errors import OpusError, check
from anet_torch.codec.ring import ByteRingBuffer

SUPPORTED_SAMPLE_RATES = constants.SUPPORTED_SAMPLE_RATES_HZ
SUPPORTED_FRAME_DURATIONS_MS = constants.SUPPORTED_FRAME_DURATIONS_MS

# --- libopus C constants -----------------------------------------------------
_OPUS_APPLICATION_AUDIO = 2049
_OPUS_SET_BITRATE = 4002
_OPUS_SET_MAX_BANDWIDTH = 4004
_OPUS_SET_COMPLEXITY = 4010
_OPUS_SET_SIGNAL = 4024
_OPUS_GET_LOOKAHEAD = 4027
_OPUS_SIGNAL_MUSIC = 3002
_BANDWIDTH_BY_RATE = {
    8_000: 1101,  # narrowband
    12_000: 1102,  # mediumband
    16_000: 1103,  # wideband
    24_000: 1104,  # superwideband
    48_000: 1105,  # fullband
}


class AudioFormatNotSupportedError(ValueError):
    """The AudioFormatNotSupportedException analog."""


@dataclasses.dataclass(frozen=True)
class AudioFormat:
    """PCM format card (the javax.sound AudioFormat surface anet consumes)."""

    sample_rate_hz: int = 48_000
    channels: int = 2
    bits_per_sample: int = 16
    little_endian: bool = True
    signed: bool = True

    def validate_for_opus(self) -> None:
        if not self.signed:
            raise AudioFormatNotSupportedError("PCM must be signed")
        if not self.little_endian:
            raise AudioFormatNotSupportedError("PCM must be little-endian")
        if self.bits_per_sample != 16:
            raise AudioFormatNotSupportedError(
                f"only 16-bit PCM supported, got {self.bits_per_sample}"
            )
        if self.channels not in (1, 2):
            raise AudioFormatNotSupportedError(
                f"only mono/stereo supported, got {self.channels} channels"
            )
        if self.sample_rate_hz not in SUPPORTED_SAMPLE_RATES:
            raise AudioFormatNotSupportedError(
                f"sample rate {self.sample_rate_hz} not in {SUPPORTED_SAMPLE_RATES}"
            )

    @property
    def bytes_per_frame(self) -> int:
        """Bytes per PCM frame (one sample across channels)."""
        return self.channels * self.bits_per_sample // 8


_lib: Optional[ctypes.CDLL] = None
_lib_error: Optional[str] = None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_error
    if _lib is not None or _lib_error is not None:
        return _lib
    name = ctypes.util.find_library("opus") or "libopus.so.0"
    try:
        lib = ctypes.CDLL(name)
    except OSError as e:
        _lib_error = f"libopus not loadable: {e}"
        return None
    lib.opus_encoder_create.restype = ctypes.c_void_p
    lib.opus_encoder_create.argtypes = [
        ctypes.c_int32,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.opus_encoder_destroy.argtypes = [ctypes.c_void_p]
    lib.opus_encode.restype = ctypes.c_int32
    lib.opus_encode.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int16),
        ctypes.c_int,
        ctypes.c_char_p,
        ctypes.c_int32,
    ]
    lib.opus_decoder_create.restype = ctypes.c_void_p
    lib.opus_decoder_create.argtypes = [
        ctypes.c_int32,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.opus_decoder_destroy.argtypes = [ctypes.c_void_p]
    lib.opus_decode.restype = ctypes.c_int
    lib.opus_decode.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int16),
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.opus_get_version_string.restype = ctypes.c_char_p
    _lib = lib
    return _lib


def opus_available() -> bool:
    return _load() is not None


def opus_version() -> str:
    """opus_get_version_string() — sent in DiscoveryResponse.opus_version
    (ip.proto:26, network.cpp:372)."""
    lib = _load()
    if lib is None:
        return "libopus unavailable"
    return lib.opus_get_version_string().decode("ascii")


class OpusEncoder:
    """Buffering Opus encoder with whole-frame chunking."""

    def __init__(
        self,
        fmt: AudioFormat = AudioFormat(),
        bitrate_bps: int = constants.DEFAULT_OPUS_BITRATE_BPS,
        frame_duration_ms: float = constants.DEFAULT_FRAME_DURATION_MS,
        max_encoded_frame_size: int = constants.MAX_ENCODED_FRAME_SIZE,
        complexity: int = 10,
    ) -> None:
        fmt.validate_for_opus()
        lib = _load()
        if lib is None:
            raise OpusError(-5, _lib_error or "libopus unavailable")
        self.format = fmt
        err = ctypes.c_int(0)
        self._enc = lib.opus_encoder_create(
            fmt.sample_rate_hz, fmt.channels, _OPUS_APPLICATION_AUDIO, ctypes.byref(err)
        )
        check(err.value, "opus_encoder_create")
        self._lib = lib
        self.bitrate_bps = bitrate_bps
        self._ctl(_OPUS_SET_BITRATE, bitrate_bps)
        self._ctl(_OPUS_SET_COMPLEXITY, complexity)
        self._ctl(_OPUS_SET_SIGNAL, _OPUS_SIGNAL_MUSIC)
        self._ctl(_OPUS_SET_MAX_BANDWIDTH, _BANDWIDTH_BY_RATE[fmt.sample_rate_hz])
        self._frame_duration_ms = None  # set via property below
        self._max_encoded = max_encoded_frame_size
        # Ring sized for the largest (60 ms) frame, like OpusEncoder.kt:85.
        max_frame_bytes = int(
            fmt.sample_rate_hz * 0.06
        ) * fmt.bytes_per_frame
        self._ring = ByteRingBuffer(2 * max_frame_bytes)
        self.frame_duration_ms = frame_duration_ms

    # --- negotiable parameters (MulticastAudioOutput.kt:123-131) -------------

    @property
    def frame_duration_ms(self) -> float:
        return self._frame_duration_ms

    @frame_duration_ms.setter
    def frame_duration_ms(self, value: float) -> None:
        if value not in SUPPORTED_FRAME_DURATIONS_MS:
            raise ValueError(
                f"frame duration {value} ms not in {SUPPORTED_FRAME_DURATIONS_MS}"
            )
        self._frame_duration_ms = float(value)

    @property
    def max_encoded_frame_size(self) -> int:
        return self._max_encoded

    @max_encoded_frame_size.setter
    def max_encoded_frame_size(self, value: int) -> None:
        if value <= 0:
            raise ValueError("max_encoded_frame_size must be positive")
        self._max_encoded = value

    @property
    def samples_per_frame(self) -> int:
        return int(self.format.sample_rate_hz * self._frame_duration_ms / 1000)

    @property
    def bytes_per_encoder_frame(self) -> int:
        return self.samples_per_frame * self.format.bytes_per_frame

    def decoded_frame_bytes_at_48k_stereo(self) -> int:
        """Decoded size of one frame at the receiver's fixed 48k/16/stereo
        format — the quantity negotiated against max_decoded_frame_size
        (MulticastAudioOutput.kt:127-130)."""
        return int(48_000 * self._frame_duration_ms / 1000) * 4

    # --- streaming encode ----------------------------------------------------

    def submit(self, pcm: bytes) -> List[bytes]:
        """Buffer PCM bytes; encode and return all whole frames available."""
        out: List[bytes] = []
        pos = 0
        while pos < len(pcm):
            space = self._ring.remaining_write
            take = min(space, len(pcm) - pos)
            self._ring.put(pcm[pos : pos + take])
            pos += take
            out.extend(self._drain_whole_frames())
        return out

    def final(self) -> List[bytes]:
        """Zero-pad the buffered tail to a whole frame and encode it
        (OpusEncoder.kt:116-127)."""
        rem = self._ring.remaining_read
        if rem == 0:
            return []
        pad = (-rem) % self.bytes_per_encoder_frame
        self._ring.put(b"\x00" * pad)
        return self._drain_whole_frames()

    def _drain_whole_frames(self) -> List[bytes]:
        frames: List[bytes] = []
        fb = self.bytes_per_encoder_frame
        while self._ring.remaining_read >= fb:
            frames.append(self._encode_one(self._ring.get(fb)))
        return frames

    def _encode_one(self, pcm: bytes) -> bytes:
        n_samples = self.samples_per_frame
        pcm_arr = (ctypes.c_int16 * (len(pcm) // 2)).from_buffer_copy(pcm)
        buf = ctypes.create_string_buffer(self._max_encoded)
        n = check(
            self._lib.opus_encode(
                self._enc, pcm_arr, n_samples, buf, self._max_encoded
            ),
            "opus_encode",
        )
        return buf.raw[:n]

    def _ctl(self, request: int, value: int) -> None:
        fn = self._lib.opus_encoder_ctl
        fn.restype = ctypes.c_int
        check(fn(ctypes.c_void_p(self._enc), request, ctypes.c_int32(value)),
              f"opus_encoder_ctl({request})")

    def set_bitrate(self, bitrate_bps: int) -> None:
        """Live bitrate change (quality downgrade/upgrade between frames)."""
        if not 500 <= bitrate_bps <= 512_000:
            raise ValueError(f"bitrate {bitrate_bps} out of Opus range")
        self._ctl(_OPUS_SET_BITRATE, bitrate_bps)
        self.bitrate_bps = bitrate_bps

    @property
    def lookahead_samples(self) -> int:
        fn = self._lib.opus_encoder_ctl
        fn.restype = ctypes.c_int
        out = ctypes.c_int32(0)
        check(
            fn(ctypes.c_void_p(self._enc), _OPUS_GET_LOOKAHEAD, ctypes.byref(out)),
            "OPUS_GET_LOOKAHEAD",
        )
        return out.value

    def close(self) -> None:
        if getattr(self, "_enc", None):
            self._lib.opus_encoder_destroy(self._enc)
            self._enc = None

    def __del__(self) -> None:  # best-effort
        try:
            self.close()
        except Exception:
            pass


class OpusDecoder:
    """Receiver-side decoder, fixed 48 kHz 16-bit stereo (playback.cpp:9)."""

    MAX_FRAME_SAMPLES = int(48_000 * 0.06)  # 60 ms

    def __init__(self) -> None:
        lib = _load()
        if lib is None:
            raise OpusError(-5, _lib_error or "libopus unavailable")
        self._lib = lib
        err = ctypes.c_int(0)
        self._dec = lib.opus_decoder_create(48_000, 2, ctypes.byref(err))
        check(err.value, "opus_decoder_create")
        self._pcm = (ctypes.c_int16 * (self.MAX_FRAME_SAMPLES * 2))()

    def decode(self, packet: bytes) -> bytes:
        """One Opus packet -> PCM bytes (48k, 16-bit LE, stereo interleaved).

        Raises OpusError on a corrupt packet — the caller translates that
        into ReceiverError.audio_decode_error feedback (anet_torch.rx.playback).
        """
        n = check(
            self._lib.opus_decode(
                self._dec, packet, len(packet), self._pcm, self.MAX_FRAME_SAMPLES, 0
            ),
            "opus_decode",
        )
        return ctypes.string_at(self._pcm, n * 2 * 2)

    def close(self) -> None:
        if getattr(self, "_dec", None):
            self._lib.opus_decoder_destroy(self._dec)
            self._dec = None

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass
