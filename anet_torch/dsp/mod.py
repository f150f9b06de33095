"""MFSK modulator: symbols -> waveform (mirrors ``anet.dsp.mod``)."""

from __future__ import annotations

import math

import torch

from anet_torch.dsp.bits import gray_encode
from anet_torch.dsp.params import ModemConfig


def _tone_freqs(config: ModemConfig, device) -> torch.Tensor:
    return torch.tensor(config.tone_freqs_hz, dtype=torch.float32, device=device)


def synthesize_tones(
    config: ModemConfig, tone_indices: torch.Tensor, dtype=torch.float32
) -> torch.Tensor:
    """Waveform for a sequence of tone indices, on their device.

    Args:
      tone_indices: int tensor [..., S] of tone numbers in [0, num_tones).
    Returns:
      float tensor [..., S * samples_per_symbol].

    Block-phase (every symbol starts at phase 0, the demod basis matches it
    exactly) or continuous-phase (CPFSK: phase = cumulative sum of per-sample
    increments), per ``config.phase_continuous``. Phases are ALWAYS float32
    with one rounding to ``dtype`` at the end: phases reach ~1e2 radians, and
    a bf16 phase corrupts the sinusoids outright.
    """
    sps = config.samples_per_symbol
    dev = tone_indices.device
    freqs = _tone_freqs(config, dev)[tone_indices.long()]  # [..., S]
    t = torch.arange(sps, dtype=torch.float32, device=dev) / config.sample_rate_hz
    if config.phase_continuous:
        f_per_sample = freqs.repeat_interleave(sps, dim=-1)  # [..., S*sps]
        dphi = 2.0 * math.pi * f_per_sample / config.sample_rate_hz
        phase = torch.cumsum(dphi, dim=-1) - dphi  # phase at sample start
        wave = torch.sin(phase)
    else:
        phase = 2.0 * math.pi * freqs[..., :, None] * t  # [..., S, sps]
        wave = torch.sin(phase).reshape(*freqs.shape[:-1], freqs.shape[-1] * sps)
    return (config.amplitude * wave).to(dtype)


def modulate_symbols(
    config: ModemConfig, symbols: torch.Tensor, dtype=torch.float32
) -> torch.Tensor:
    """Gray-map data symbols onto tones and synthesize."""
    return synthesize_tones(config, gray_encode(symbols), dtype=dtype)
