"""Demo: the full stack — Opus audio carried over the acoustic modem.

This composes every layer of the framework the way the north star
describes: real audio is Opus-encoded (the reference's codec), wrapped in
the reference's wire protocol (varint-delimited ToReceiver messages), and
then — where the reference hands bytes to TCP — modulated onto an OFDM
acoustic carrier, pushed through a noisy/echoey simulated room, recovered
by the streaming receiver, unwrapped, and Opus-decoded back to audio.

    WAV -> OpusEncoder -> ip.proto framing -> OFDM modulation
        -> channel (AWGN + echo) -> streaming receiver -> ip.proto parse
        -> OpusDecoder -> WAV

Run:  python -m anet_torch.examples.opus_over_sound [--snr 14] [--out received.wav] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys
import wave

import numpy as np
import torch

from anet_torch.channel import ChannelConfig, apply_channel
from anet_torch.codec import AudioFormat, OpusDecoder, OpusEncoder
from anet_torch.dsp import ofdm
from anet_torch.examples import CHUNK, add_device_argument, lay_out, parse_device, unwrap, wire_frames
from anet_torch.models import get_model
from anet_torch.stream import StreamResult, receive_stream

SAMPLE_RATE = 48_000
FRAME_MS = 20.0  # Opus frame duration
LEAD = 1000  # silence before the first frame
TAPS = (1.0, 0.0, 0.0, 0.25, 0.0, 0.1)  # the room's two echoes
SEED = 0


def melody(seconds: float) -> np.ndarray:
    """int16 [n]: three gated tones, a little melody at SAMPLE_RATE."""
    t = np.arange(int(SAMPLE_RATE * seconds))
    return sum(
        0.2 * 32767 * np.sin(2 * np.pi * f * t / SAMPLE_RATE)
        * (np.sin(2 * np.pi * 2.0 * t / SAMPLE_RATE + p) > 0)
        for f, p in ((330, 0.0), (415, 2.1), (494, 4.2))
    ).astype(np.int16)


def encode(mono: np.ndarray) -> tuple[list[bytes], int]:
    """(Opus frames of FRAME_MS, the encoder's bit rate) of ``mono`` played
    on both channels."""
    enc = OpusEncoder(AudioFormat(SAMPLE_RATE, 2), frame_duration_ms=FRAME_MS)
    stereo = np.repeat(mono, 2).tobytes()
    return enc.submit(stereo) + enc.final(), enc.bitrate_bps


def build_capture(cfg, padded: torch.Tensor, device) -> torch.Tensor:
    """float32 [N]: the frames of ``padded`` (uint8 [F, L]) OFDM-transmitted
    on ``device``, one OFDM symbol of silence after each, LEAD samples
    before the first, padded to whole chunks."""
    waves = ofdm.transmit(cfg, padded, device=device)
    return lay_out(waves, cfg.symbol_samples, LEAD)


def pass_channel(capture: torch.Tensor, snr_db: float, gen: torch.Generator) -> torch.Tensor:
    """AWGN at ``snr_db`` plus two echoes, 3 and 5 samples late."""
    return apply_channel(gen, capture, ChannelConfig(snr_db=snr_db, multipath_taps=TAPS),
                         device=capture.device)


def receive(cfg, dirty: torch.Tensor, frame_len: int) -> StreamResult:
    """The streaming receiver's default call: float32, always searching."""
    return receive_stream(cfg, dirty, CHUNK, frame_len, device=dirty.device)


def decode(frames: list[bytes]) -> bytes:
    """The interleaved 16-bit stereo PCM of Opus ``frames``."""
    dec = OpusDecoder()
    return b"".join(dec.decode(f) for f in frames)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--snr", type=float, default=14.0)
    ap.add_argument("--seconds", type=float, default=1.2)
    ap.add_argument("--out", default=None, help="write recovered audio here")
    ap.add_argument("--model", default="ofdm-coded",
                    help="modem preset carrying the stream (e.g. ofdm-turbo)")
    add_device_argument(ap)
    args = ap.parse_args(argv)
    device = parse_device(ap, args)

    # --- source audio: a little melody, Opus-encoded at 20 ms frames -------
    opus_frames, bitrate = encode(melody(args.seconds))
    print(f"source: {args.seconds:.1f} s of audio -> {len(opus_frames)} Opus frames "
          f"({sum(map(len, opus_frames))} bytes at {bitrate} bps)")

    # --- wire framing + modem transmit -------------------------------------
    cfg = get_model(args.model).config
    padded = wire_frames(opus_frames)
    capture = build_capture(cfg, padded, device)
    air_seconds = capture.shape[0] / cfg.sample_rate_hz
    print(f"modem: {padded.shape[0]} PHY frames ({padded.shape[1]} B payloads) -> "
          f"{air_seconds:.1f} s on the air ({args.model})")

    # --- the room -----------------------------------------------------------
    gen = torch.Generator(device=device).manual_seed(SEED)
    dirty = pass_channel(capture, args.snr, gen)
    print(f"channel: {args.snr} dB AWGN + two echoes")

    # --- streaming receive + unwrap + Opus decode ---------------------------
    res = receive(cfg, dirty, padded.shape[1])
    n_ok = int(res.carry.frames_ok)
    print(f"receiver: {n_ok}/{padded.shape[0]} frames ok, "
          f"{int(res.carry.decode_errors)} decode errors")
    if n_ok != padded.shape[0]:
        print("FAILED: lost frames", file=sys.stderr)
        return 1
    recovered = unwrap(res)
    pcm = decode(recovered)
    x = np.frombuffer(pcm, np.int16).astype(np.float64)
    rms = float(np.sqrt(np.mean(x**2)))
    print(f"decoded: {len(recovered)} Opus frames -> "
          f"{len(pcm)} PCM bytes ({len(pcm)/4/SAMPLE_RATE:.2f} s), rms={rms:.0f}")
    if args.out:
        with wave.open(args.out, "wb") as w:
            w.setnchannels(2)
            w.setsampwidth(2)
            w.setframerate(SAMPLE_RATE)
            w.writeframes(pcm)
        print(f"wrote {args.out}")
    ok = len(recovered) == len(opus_frames) and rms > 1000
    print("full stack roundtrip:", "OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
