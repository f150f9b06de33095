"""Modulation-family dispatch (mirrors ``anet.dsp.family``). The port has
the MFSK family only; an OFDM config raises until the OFDM slice lands."""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from anet_torch.dsp.params import ModemConfig


def _require_mfsk(config) -> None:
    if not isinstance(config, ModemConfig):
        raise NotImplementedError(
            f"{type(config).__name__}: only MFSK (ModemConfig) is ported; OFDM "
            "arrives with the OFDM slice (ROADMAP: ofdm_track_decide_fused)"
        )


def transmit_fn(config, device="cuda") -> Callable:
    """payload uint8[..., N] -> frame waveforms on ``device``."""
    from anet_torch.dsp.pipeline import transmit

    _require_mfsk(config)
    return lambda p: transmit(config, p, device=device)


def aligned_demod_fn(config, payload_len: int, compute_dtype=torch.float32, device="cuda") -> Callable:
    """Symbol-aligned batch-major frame waveform -> FrameResult."""
    from anet_torch.dsp.frame import demodulate_frame

    _require_mfsk(config)
    return lambda w: demodulate_frame(
        config, w, payload_len, compute_dtype=compute_dtype, device=device
    )


def aligned_demod_dynamic_fn(
    config, max_payload_len: int, compute_dtype=torch.float32, device="cuda"
) -> Callable:
    """Symbol-aligned max-length window -> DynamicFrameResult (payload
    length read from the frame header)."""
    from anet_torch.dsp.frame import demodulate_frame_dynamic

    _require_mfsk(config)
    return lambda w: demodulate_frame_dynamic(
        config, w, max_payload_len, compute_dtype=compute_dtype, device=device
    )


def frame_samples(config, payload_len: int) -> int:
    from anet_torch.dsp.frame import frame_num_samples

    _require_mfsk(config)
    return frame_num_samples(config, payload_len)


def preamble_template(config, device="cuda") -> torch.Tensor:
    from anet_torch.dsp.sync import preamble_waveform

    _require_mfsk(config)
    return preamble_waveform(config, device=device).float()


def geometry(
    config, payload_len: int, compute_dtype=torch.float32, device="cuda"
) -> Tuple[int, torch.Tensor, Callable]:
    """(frame_samples, preamble_template, aligned_demod_fn) in one call."""
    return (
        frame_samples(config, payload_len),
        preamble_template(config, device),
        aligned_demod_fn(config, payload_len, compute_dtype, device),
    )
