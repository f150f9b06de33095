"""The modem's demos, each the composition of the host edge (the ip.proto
wire framing, the Opus codec) with the data plane (TX, the channel, the
streaming receiver):

- ``file_over_sound``: a file, cut into wire-framed chunks, over
  mfsk16-fast and back byte for byte;
- ``adaptive_modem``: probe the channel on fsk2-robust, measure its SNR,
  pick the fastest preset that fits, transfer on it;
- ``opus_over_sound``: Opus audio in wire frames over ofdm-coded.

Run one as ``python -m anet_torch.examples.<name> [--device cpu]``: they
run on the card (``--device cuda``, the default); where there is none,
``cuda`` is a usage error and nothing falls back to the CPU unless
``--device cpu`` is given. Each module's legs are plain functions on
tensors; its ``main`` calls them in order. This module holds the legs they
share."""

from __future__ import annotations

import argparse

import torch

from anet_torch._device import resolve_device
from anet_torch.proto import AudioData, ToReceiver, encode_delimited
from anet_torch.proto.framing import iter_delimited

CHUNK = 1024  # samples the streaming receiver takes a step


def add_device_argument(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="torch device the modem runs on (default cuda; cpu runs the plain versions)")


def parse_device(ap: argparse.ArgumentParser, args) -> torch.device:
    """``args.device`` resolved; no card for ``cuda`` is a usage error
    (exit 2) carrying resolve_device's message."""
    try:
        return resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))


def wire_frames(messages) -> torch.Tensor:
    """uint8 [F, L]: each message as the reference transport puts it on TCP
    (``ToReceiver(audio_data=AudioData(m))``, varint-delimited), zero-padded
    to the longest, L."""
    wire = [encode_delimited(ToReceiver(audio_data=AudioData(m)).encode()) for m in messages]
    out = torch.zeros(len(wire), max(map(len, wire)), dtype=torch.uint8)
    for i, w in enumerate(wire):
        out[i, : len(w)] = torch.frombuffer(bytearray(w), dtype=torch.uint8)
    return out


def lay_out(waves: torch.Tensor, gap: int, lead: int, tail: int = 0) -> torch.Tensor:
    """One capture [N] of frames [F, T] back to back: ``lead`` zeros, each
    frame followed by ``gap`` zeros, ``tail`` zeros, then zeros to a whole
    number of chunks."""
    f = waves.shape[0]
    body = torch.cat([waves, waves.new_zeros(f, gap)], dim=-1).reshape(-1)
    n = lead + body.shape[0] + tail
    capture = waves.new_zeros(n + (-n) % CHUNK)
    capture[lead : lead + body.shape[0]] = body
    return capture


def unwrap(result) -> list[bytes]:
    """The AudioData frames of every integrity-verified step of a
    StreamResult over one capture, in time order."""
    ok = result.steps.frame.ok.cpu().numpy()
    payloads = result.steps.frame.payload.cpu().numpy()
    frames = []
    for i in ok.nonzero()[0]:
        inner = next(iter_delimited(bytes(payloads[i])))  # strips the length prefix + pad
        frames.append(ToReceiver.decode(inner).audio_data.opus_encoded_frame)
    return frames
