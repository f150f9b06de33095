"""Demo: send a file through the acoustic modem, end to end.

Splits a file into wire-framed chunks (varint-delimited ToReceiver/AudioData
— the exact bytes the reference system puts on TCP), modulates each as one
PHY frame into a single audio capture, pushes the capture through a rough
simulated channel, then recovers every file chunk with the streaming
receiver and reassembles the file byte-identically.

Run:  python -m anet_torch.examples.file_over_sound [path] [--snr 8] [--model mfsk16-fast] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys

import torch

from anet_torch.channel import ChannelConfig, apply_channel
from anet_torch.dsp.pipeline import transmit
from anet_torch.examples import CHUNK, add_device_argument, lay_out, parse_device, unwrap, wire_frames
from anet_torch.models import get_model
from anet_torch.stream import StreamResult, receive_stream

CHUNK_PAYLOAD = 256  # file bytes per PHY frame (wire framing adds a few)
GAP_SYMBOLS = 8  # silence after each frame
LEAD = 1000  # silence before the first frame
TAPS = (1.0, 0.0, 0.25)  # the room's echo
SEED = 0


def file_chunks(data: bytes) -> list[bytes]:
    return [data[i : i + CHUNK_PAYLOAD] for i in range(0, len(data), CHUNK_PAYLOAD)]


def build_capture(cfg, padded: torch.Tensor, device) -> torch.Tensor:
    """float32 [N]: the frames of ``padded`` (uint8 [F, L]) transmitted on
    ``device``, GAP_SYMBOLS symbols of silence after each, LEAD samples
    before the first, padded to whole chunks."""
    waves = transmit(cfg, padded, device=device)
    return lay_out(waves, cfg.samples_per_symbol * GAP_SYMBOLS, LEAD)


def pass_channel(capture: torch.Tensor, snr_db: float, gen: torch.Generator) -> torch.Tensor:
    """AWGN at ``snr_db`` plus a quarter-amplitude echo two samples late."""
    return apply_channel(gen, capture, ChannelConfig(snr_db=snr_db, multipath_taps=TAPS),
                         device=capture.device)


def receive(cfg, dirty: torch.Tensor, frame_len: int) -> StreamResult:
    """The streaming receiver's default call: float32, always searching."""
    return receive_stream(cfg, dirty, CHUNK, frame_len, device=dirty.device)


def recover(result: StreamResult) -> bytes:
    """The file bytes of every integrity-verified frame, in order."""
    return b"".join(unwrap(result))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("path", nargs="?", default=__file__)
    ap.add_argument("--snr", type=float, default=8.0)
    ap.add_argument("--model", default="mfsk16-fast")
    add_device_argument(ap)
    args = ap.parse_args(argv)
    device = parse_device(ap, args)

    model = get_model(args.model)
    cfg = model.config
    with open(args.path, "rb") as f:
        data = f.read()
    if not data:
        print("input file is empty; nothing to send")
        return 0
    padded = wire_frames(file_chunks(data))
    capture = build_capture(cfg, padded, device)
    seconds = capture.shape[0] / cfg.sample_rate_hz
    print(
        f"{len(data)} bytes -> {padded.shape[0]} PHY frames -> "
        f"{capture.shape[0]} samples ({seconds:.1f} s of audio at "
        f"{cfg.sample_rate_hz} Hz, {model.name})"
    )

    gen = torch.Generator(device=device).manual_seed(SEED)
    dirty = pass_channel(capture, args.snr, gen)
    print(f"channel: {args.snr} dB AWGN + echo")

    res = receive(cfg, dirty, padded.shape[1])
    n_ok = int(res.carry.frames_ok)
    print(
        f"receiver: {int(res.carry.frames_detected)} frames detected, "
        f"{n_ok} ok, {int(res.carry.decode_errors)} decode errors"
    )
    if n_ok != padded.shape[0]:
        print("FAILED: not all frames recovered", file=sys.stderr)
        return 1
    ok = recover(res) == data
    print("file reassembled byte-identical:", ok)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
