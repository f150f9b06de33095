"""Audio file ingest + PCM format conversion.

The javax.sound AudioSystem analog (Main.kt:15, MulticastAudioOutput.kt:
38-45,98-114): read WAV / AIFF / AU containers (everything the
reference's AudioSystem.getAudioInputStream opens for it), normalize
arbitrary PCM to an Opus-supported format — 16-bit signed LE, 1-2
channels, rate in {8,12,16,24,48} kHz, falling back to 48 kHz stereo
like the reference. AIFF and AU are parsed first-party (the stdlib
aifc/sunau modules are deprecated for removal); resampling is a
polyphase windowed-sinc (Kaiser), not linear interpolation.

A copy of ``anet/tx/audio.py``: numpy-only, and the port imports nothing
of the JAX package. The format card is ``anet_torch.codec.opus.AudioFormat``.
"""

from __future__ import annotations

import math
import struct
import wave
from typing import Tuple

import numpy as np

from anet_torch.codec.opus import AudioFormat, SUPPORTED_SAMPLE_RATES


def read_wav(path: str) -> Tuple[np.ndarray, AudioFormat]:
    """WAV file -> (int16 samples [n, channels], format card)."""
    with wave.open(path, "rb") as wav:
        channels = wav.getnchannels()
        rate = wav.getframerate()
        width = wav.getsampwidth()
        raw = wav.readframes(wav.getnframes())
    if width == 2:
        samples = np.frombuffer(raw, np.int16)
    elif width == 1:  # 8-bit WAV is unsigned
        samples = ((np.frombuffer(raw, np.uint8).astype(np.int16) - 128) << 8).astype(
            np.int16
        )
    elif width == 4:
        samples = (np.frombuffer(raw, np.int32) >> 16).astype(np.int16)
    elif width == 3:  # 24-bit packed
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        val = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        val = np.where(val >= 1 << 23, val - (1 << 24), val)
        samples = (val >> 8).astype(np.int16)
    else:
        raise ValueError(f"unsupported WAV sample width {width}")
    samples = samples.reshape(-1, channels)
    return samples, AudioFormat(sample_rate_hz=rate, channels=channels)


def _pcm_int16_from_bytes(raw: bytes, width: int, big_endian: bool) -> np.ndarray:
    """Signed PCM of 1/2/3/4-byte width -> int16 (AIFF/AU are big-endian)."""
    if width == 2:
        return np.frombuffer(raw, ">i2" if big_endian else "<i2").astype(np.int16)
    if width == 1:  # AIFF/AU 8-bit is SIGNED (unlike WAV)
        return (np.frombuffer(raw, np.int8).astype(np.int16) << 8).astype(np.int16)
    if width == 4:
        v = np.frombuffer(raw, ">i4" if big_endian else "<i4")
        return (v >> 16).astype(np.int16)
    if width == 3:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        if big_endian:
            b = b[:, ::-1]
        val = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        val = np.where(val >= 1 << 23, val - (1 << 24), val)
        return (val >> 8).astype(np.int16)
    raise ValueError(f"unsupported sample width {width}")


def _read_extended80(raw: bytes) -> int:
    """80-bit IEEE extended float (AIFF sample rate) -> int Hz."""
    sign_exp, mant = struct.unpack(">HQ", raw)
    exp = sign_exp & 0x7FFF
    if exp == 0 and mant == 0:
        return 0
    value = mant * 2.0 ** (exp - 16383 - 63)
    return int(round(-value if sign_exp & 0x8000 else value))


def read_aiff(path: str) -> Tuple[np.ndarray, AudioFormat]:
    """AIFF/AIFC file -> (int16 samples [n, channels], format card).

    First-party chunk parser (the stdlib ``aifc`` module is removed in
    Python 3.13): FORM/AIFF container, COMM for geometry (channel count,
    sample width, 80-bit extended-float rate), SSND for data. AIFC is
    accepted for the uncompressed codecs ('NONE' big-endian, 'sowt'
    little-endian); compressed AIFC is rejected explicitly.
    """
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 12 or data[:4] != b"FORM" or data[8:12] not in (b"AIFF", b"AIFC"):
        raise ValueError(f"{path}: not an AIFF file")
    is_aifc = data[8:12] == b"AIFC"
    comm = ssnd = None
    little = False
    pos = 12
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        (size,) = struct.unpack(">I", data[pos + 4 : pos + 8])
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"COMM":
            channels, _frames, bits = struct.unpack(">hIh", body[:8])
            rate = _read_extended80(body[8:18])
            if is_aifc and len(body) >= 22:
                codec = body[18:22]
                if codec == b"sowt":
                    little = True
                elif codec != b"NONE":
                    raise ValueError(
                        f"{path}: compressed AIFC ({codec!r}) not supported"
                    )
            comm = (channels, bits, rate)
        elif cid == b"SSND":
            (offset, _blocksize) = struct.unpack(">II", body[:8])
            ssnd = body[8 + offset :]
        pos += 8 + size + (size & 1)  # chunks are word-aligned
    if comm is None or ssnd is None:
        raise ValueError(f"{path}: missing COMM or SSND chunk")
    channels, bits, rate = comm
    width = (bits + 7) // 8
    n_bytes = len(ssnd) - len(ssnd) % (width * channels)
    samples = _pcm_int16_from_bytes(ssnd[:n_bytes], width, big_endian=not little)
    return samples.reshape(-1, channels), AudioFormat(
        sample_rate_hz=rate, channels=channels
    )


# mu-law expansion per ITU-T G.711 (AU encoding 1); bias 0x84, the
# standard 8-segment companding table as closed form.
def _mulaw_to_int16(u: np.ndarray) -> np.ndarray:
    u = (~u.astype(np.int32)) & 0xFF
    sign = u & 0x80
    exponent = (u >> 4) & 0x07
    mantissa = u & 0x0F
    magnitude = ((mantissa << 3) + 0x84) << exponent
    magnitude = magnitude - 0x84
    return np.where(sign, -magnitude, magnitude).astype(np.int16)


def read_au(path: str) -> Tuple[np.ndarray, AudioFormat]:
    """Sun AU (.au/.snd) file -> (int16 samples [n, channels], format card).

    First-party header parser (the stdlib ``sunau`` module is removed in
    Python 3.13): '.snd' magic, big-endian header, linear PCM 8/16/24/32
    and G.711 mu-law payloads.
    """
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 24 or data[:4] != b".snd":
        raise ValueError(f"{path}: not an AU file")
    offset, size, encoding, rate, channels = struct.unpack(">IIIII", data[4:24])
    payload = data[offset:]
    if size not in (0xFFFFFFFF, 0):
        payload = payload[:size]
    widths = {2: 1, 3: 2, 4: 3, 5: 4}
    if encoding == 1:  # 8-bit G.711 mu-law
        samples = _mulaw_to_int16(np.frombuffer(payload, np.uint8))
    elif encoding in widths:
        w = widths[encoding]
        payload = payload[: len(payload) - len(payload) % (w * channels)]
        samples = _pcm_int16_from_bytes(payload, w, big_endian=True)
    else:
        raise ValueError(f"{path}: unsupported AU encoding {encoding}")
    return samples.reshape(-1, channels), AudioFormat(
        sample_rate_hz=rate, channels=channels
    )


def read_audio(path: str) -> Tuple[np.ndarray, AudioFormat]:
    """Open any supported container (the AudioSystem.getAudioInputStream
    analog, Main.kt:15): sniff the magic bytes — WAV (RIFF), AIFF (FORM),
    AU (.snd) — falling back to WAV for a helpful stdlib error."""
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == b"FORM":
        return read_aiff(path)
    if magic == b".snd":
        return read_au(path)
    return read_wav(path)


def nearest_supported_rate(rate: int) -> int:
    """Smallest supported rate >= rate, else 48 kHz (the reference converts
    up rather than losing bandwidth, fallback MulticastAudioOutput.kt:158)."""
    for candidate in SUPPORTED_SAMPLE_RATES:
        if candidate >= rate:
            return candidate
    return 48_000


def convert(
    samples: np.ndarray, fmt: AudioFormat, target: AudioFormat
) -> np.ndarray:
    """Convert int16 [n, ch] PCM between formats (rate + channel count)."""
    out = samples
    if fmt.channels != target.channels:
        if fmt.channels == 1:
            out = np.repeat(out, target.channels, axis=1)
        else:
            # Mix every source channel down (dropping channels would
            # silently discard content), then spread across the targets.
            mono = out.mean(axis=1, dtype=np.int32).astype(np.int16)[:, None]
            out = np.repeat(mono, target.channels, axis=1)
    if fmt.sample_rate_hz != target.sample_rate_hz:
        out = resample_sinc(out, fmt.sample_rate_hz, target.sample_rate_hz)
    return out


_RESAMPLE_TAPS = 32  # filter taps per polyphase branch
_RESAMPLE_BETA = 9.0  # Kaiser beta: ~90 dB stopband design point


def resample_sinc(
    samples: np.ndarray, in_rate: int, out_rate: int
) -> np.ndarray:
    """Polyphase windowed-sinc (Kaiser) sample-rate conversion.

    int16 [n, ch] at ``in_rate`` -> int16 [round(n*out/in), ch] at
    ``out_rate``. The reference delegates this to AudioSystem's converter
    (MulticastAudioOutput.kt:98-114); this is the proper-filter analog:
    upsample by L, lowpass at min(pi/L, pi/M) with a Kaiser-windowed sinc,
    downsample by M (L/M = out/in reduced), evaluated directly in
    polyphase form so the zero-stuffed signal never materializes.
    Computed per phase as strided slice-dots — pure vectorized numpy.
    """
    if in_rate == out_rate:
        return samples
    n_in, ch = samples.shape
    g = math.gcd(in_rate, out_rate)
    up, down = out_rate // g, in_rate // g
    n_out = int(round(n_in * out_rate / in_rate))

    taps = _RESAMPLE_TAPS
    n_filt = taps * up
    # Cutoff in the upsampled domain (rate in_rate*up): half the narrower
    # Nyquist, pulled in 9% for transition band.
    cutoff = 0.5 / max(up, down) * 0.91
    t = np.arange(n_filt, dtype=np.float64) - (n_filt - 1) / 2.0
    h = 2 * cutoff * np.sinc(2 * cutoff * t) * np.kaiser(n_filt, _RESAMPLE_BETA)
    h *= up / h.sum()  # unity passband gain (each phase sums to ~1)

    x = samples.astype(np.float64)
    # Center the filter: output m taps x at positions floor((m*down - d)/up)
    # backwards for `taps` samples; pad both ends so every index is valid.
    half = (n_filt - 1) // 2
    pad_l = taps
    pad_r = taps + 2
    xp = np.concatenate(
        [np.zeros((pad_l, ch)), x, np.zeros((pad_r, ch))], axis=0
    )
    out = np.zeros((n_out, ch), np.float64)
    m = np.arange(n_out, dtype=np.int64)
    # position of output m in the upsampled stream, filter centered at half
    up_pos = m * down + half
    base = up_pos // up  # newest input sample index under the filter
    phase = up_pos % up
    # Group outputs by phase: all outputs of one phase share filter
    # coefficients h[phase::up] and read input windows strided by `down`.
    for p in range(up):
        sel = np.nonzero(phase == p)[0]
        if sel.size == 0:
            continue
        hb = h[p::up][::-1]  # [taps] — reversed: convolution
        b = base[sel] - (taps - 1) + pad_l  # window start in xp
        # all windows for this phase: consecutive starts differ by a
        # constant stride, so a single as_strided view covers them
        if sel.size > 1:
            stride = int(b[1] - b[0])
            win = np.lib.stride_tricks.as_strided(
                xp[b[0] :],
                shape=(sel.size, taps, ch),
                strides=(stride * xp.strides[0], xp.strides[0], xp.strides[1]),
            )
        else:
            win = xp[b[0] : b[0] + taps][None]
        out[sel] = np.einsum("mtc,t->mc", win, hb)
    return np.clip(np.round(out), -32768, 32767).astype(np.int16)


def normalize_for_opus(samples: np.ndarray, fmt: AudioFormat) -> Tuple[np.ndarray, AudioFormat]:
    """Return (samples, format) in an Opus-supported format, converting if
    needed (fallback target: source-rate-rounded-up, stereo preserved)."""
    try:
        fmt.validate_for_opus()
        return samples, fmt
    except Exception:
        target = AudioFormat(
            sample_rate_hz=nearest_supported_rate(fmt.sample_rate_hz),
            channels=min(fmt.channels, 2),
        )
        return convert(samples, fmt, target), target


def pcm_bytes(samples: np.ndarray) -> bytes:
    """int16 [n, ch] -> interleaved little-endian bytes."""
    return samples.astype("<i2").tobytes()
