"""Demo: adaptive modulation — probe the channel, pick the preset, transfer.

The link-adaptation loop the reference's README promises ("react to
receiver quality feedback") taken to its modem conclusion:

  1. PROBE   — send one frame on the most robust preset (fsk2-robust);
               any channel that works at all decodes it.
  2. MEASURE — normalize the probe's demod SNR estimate to waveform scale
               (anet_torch.dsp.family.waveform_snr_db).
  3. ADAPT   — suggest_model() picks the fastest preset whose measured
               operating threshold fits, with a safety margin.
  4. TRANSFER— send the bulk payload on the chosen preset and verify it
               decodes byte-identically.

Run:  python -m anet_torch.examples.adaptive_modem [--snr 9] [--bytes 600] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from anet_torch.channel import awgn
from anet_torch.dsp.family import frame_samples, transmit_fn, waveform_snr_db
from anet_torch.dsp.pipeline import ReceiveResult, receive_frame
from anet_torch.examples import CHUNK, add_device_argument, lay_out, parse_device
from anet_torch.models import ModemModel, get_model, net_bit_rate_bps, suggest_model
from anet_torch.stream import StreamResult, receive_stream

PROBE_MODEL = "fsk2-robust"
PROBE_LEN = 16  # probe payload bytes: 0, 1, ..., 15
PROBE_PAD = 500  # silence on either side of the probe
PER = 256  # bulk payload bytes per PHY frame
GAP = 400  # silence after each bulk frame
LEAD = 800  # silence before the first bulk frame


def probe_capture(device) -> torch.Tensor:
    """float32 [N]: the probe frame on PROBE_MODEL between PROBE_PAD zeros."""
    cfg = get_model(PROBE_MODEL).config
    wave = transmit_fn(cfg, device)(torch.arange(PROBE_LEN, dtype=torch.uint8))
    return torch.nn.functional.pad(wave, (PROBE_PAD, PROBE_PAD))


def probe(capture: torch.Tensor, snr_db: float, gen: torch.Generator) -> ReceiveResult:
    """The probe through AWGN at ``snr_db``, then the one-shot receiver."""
    dirty = awgn(gen, capture, snr_db, device=capture.device)
    return receive_frame(get_model(PROBE_MODEL).config, dirty, PROBE_LEN, device=capture.device)


def measure(rx: ReceiveResult) -> float:
    """The probe's SNR estimate on the waveform scale suggest_model takes."""
    return float(waveform_snr_db(get_model(PROBE_MODEL).config, rx.frame.snr_db))


def bulk_payload(n_bytes: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, n_bytes, dtype=np.uint8)


def build_capture(cfg, payload: np.ndarray, device) -> torch.Tensor:
    """float32 [N]: ``payload`` in zero-padded PER-byte frames transmitted
    on ``device``, GAP zeros after each, LEAD before the first, one frame's
    length of zeros after the last, padded to whole chunks."""
    n_frames = -(-len(payload) // PER)
    padded = np.zeros(n_frames * PER, np.uint8)
    padded[: len(payload)] = payload
    waves = transmit_fn(cfg, device)(torch.from_numpy(padded.reshape(n_frames, PER)))
    return lay_out(waves, GAP, LEAD, tail=frame_samples(cfg, PER))


def receive(cfg, dirty: torch.Tensor) -> StreamResult:
    """The streaming receiver's default call on the bulk capture."""
    return receive_stream(cfg, dirty, CHUNK, PER, device=dirty.device)


def recover(result: StreamResult, n_bytes: int) -> np.ndarray:
    """The first ``n_bytes`` of the payloads of every detected frame."""
    detected = result.steps.detected.cpu().numpy()
    payloads = result.steps.frame.payload.cpu().numpy()
    return payloads[detected].reshape(-1)[:n_bytes]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--snr", type=float, default=9.0, help="true channel SNR (dB)")
    ap.add_argument("--bytes", type=int, default=600, help="bulk payload size")
    ap.add_argument("--seed", type=int, default=0)
    add_device_argument(ap)
    args = ap.parse_args(argv)
    if args.bytes < 1:
        ap.error("--bytes must be >= 1")
    device = parse_device(ap, args)

    # --- 1. probe on the most robust preset --------------------------------
    probe_model = get_model(PROBE_MODEL)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    probe_rx = probe(probe_capture(device), args.snr, gen)
    if not bool(probe_rx.frame.ok):
        print(f"probe failed at {args.snr} dB — channel unusable", file=sys.stderr)
        return 1
    print(f"probe: {probe_model.name} decoded ok "
          f"(air rate {probe_model.config.bit_rate_bps:.0f} bps)")

    # --- 2. measure ----------------------------------------------------------
    measured = measure(probe_rx)
    print(f"measure: waveform snr ~ {measured:.1f} dB (true: {args.snr:.1f} dB)")

    # --- 3. adapt ------------------------------------------------------------
    chosen: ModemModel = suggest_model(measured)
    speedup = net_bit_rate_bps(chosen) / net_bit_rate_bps(probe_model)
    print(f"adapt: {chosen.name} ({net_bit_rate_bps(chosen):.0f} bps net, "
          f"{speedup:.0f}x the probe rate)")

    # --- 4. transfer -----------------------------------------------------------
    payload = bulk_payload(args.bytes, args.seed)
    cfg = chosen.config
    n_frames = -(-len(payload) // PER)
    cap = build_capture(cfg, payload, device)
    dirty = awgn(torch.Generator(device=device).manual_seed(args.seed + 1), cap, args.snr, device=device)
    t0 = time.perf_counter()
    res = receive(cfg, dirty)
    n_ok = int(res.carry.frames_ok)
    dt = time.perf_counter() - t0
    air_s = cap.shape[0] / cfg.sample_rate_hz
    print(f"transfer: {n_ok}/{n_frames} frames ok over a {args.snr} dB channel "
          f"({air_s:.1f} s on the air, decoded in {dt:.1f} s)")
    if n_ok != n_frames:
        print("FAILED: lost frames — threshold margin too thin?", file=sys.stderr)
        return 1
    ok = np.array_equal(recover(res, len(payload)), payload)
    print("adaptive transfer:", "OK (byte-identical)" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
