"""MFSK demodulator: waveform -> tone energies -> symbols (mirrors
``anet.dsp.demod``).

The per-symbol single-bin DFT energy over a symbol window is a product
with a [sps, 2M] cos/sin basis followed by a square-and-add:

    energies[s, m] = (x_s . cos_m)^2 + (x_s . sin_m)^2

With orthogonal tone spacing the basis columns are orthogonal over a symbol
window, so inter-tone leakage is zero at perfect timing.
"""

from __future__ import annotations

import math

import torch

from anet_torch._device import resolve_device
from anet_torch.dsp.bits import gray_decode
from anet_torch.dsp.params import ModemConfig


def demod_basis(config: ModemConfig, dtype=torch.float32, device="cuda") -> torch.Tensor:
    """The filterbank basis: [samples_per_symbol, 2 * num_tones].

    Columns 0..M-1 are cos(2*pi*f_m*t), columns M..2M-1 are sin(2*pi*f_m*t).
    Phases are ALWAYS float32 and only the final basis is rounded to
    ``dtype``: a bf16 phase carries up to ~0.5 rad of error (88% of bf16
    basis entries were wrong when the phase itself was bf16)."""
    dev = resolve_device(device)
    sps = config.samples_per_symbol
    t = torch.arange(sps, dtype=torch.float32, device=dev)[:, None] / config.sample_rate_hz
    freqs = torch.tensor(config.tone_freqs_hz, dtype=torch.float32, device=dev)[None, :]
    phase = 2.0 * math.pi * freqs * t  # [sps, M]
    basis = torch.cat([torch.cos(phase), torch.sin(phase)], dim=1)
    return basis.to(dtype)


def tone_energies(
    config: ModemConfig, samples: torch.Tensor, *, compute_dtype=torch.float32
) -> torch.Tensor:
    """Per-symbol per-tone energies, float32 [..., S, num_tones].

    ``samples`` is a symbol-aligned waveform [..., S * samples_per_symbol].
    Inputs round to ``compute_dtype`` (as the reference's matmul operands
    do); the product itself runs in float32."""
    sps = config.samples_per_symbol
    m = config.num_tones
    s = samples.shape[-1] // sps
    windows = samples[..., : s * sps].reshape(*samples.shape[:-1], s, sps)
    windows = windows.to(compute_dtype).float()
    basis = demod_basis(config, dtype=compute_dtype, device=samples.device).float()
    iq = windows @ basis  # [..., S, 2M]
    i, q = iq[..., :m], iq[..., m:]
    return i * i + q * q


def decide_symbols(config: ModemConfig, energies: torch.Tensor) -> torch.Tensor:
    """Hard decision: argmax tone (first index on ties), Gray-decoded."""
    tone = torch.argmax(energies, dim=-1).to(torch.int32)
    return gray_decode(tone, config.bits_per_symbol)


def demodulate_symbols(
    config: ModemConfig, samples: torch.Tensor, *, compute_dtype=torch.float32
) -> tuple[torch.Tensor, torch.Tensor]:
    """Waveform -> (data symbols int32 [..., S], confidence float32 [..., S]):
    the hard decisions and, per symbol, the winning tone's energy over the
    total, a normalized confidence in (0, 1]."""
    energies = tone_energies(config, samples, compute_dtype=compute_dtype)
    symbols = decide_symbols(config, energies)
    confidence = energies.amax(-1) / energies.sum(-1).clamp_min(1e-20)
    return symbols, confidence


def bit_llrs(config: ModemConfig, energies: torch.Tensor) -> torch.Tensor:
    """Per-bit soft decisions from tone energies [..., S, M] (max-log
    approximation): for data bit k of a symbol (MSB-first, as
    unpack_symbols), the maximum energy over the tones whose Gray-decoded
    value has bit k = 1 minus the maximum over those with bit k = 0.
    Positive = bit 1; unnormalized. Returns float32 [..., S * bits_per_symbol]
    in transmitted bit order."""
    m = config.num_tones
    bps = config.bits_per_symbol
    dev = energies.device
    data_vals = gray_decode(torch.arange(m, dtype=torch.int32, device=dev), bps)
    shifts = torch.arange(bps - 1, -1, -1, dtype=torch.int32, device=dev)
    bit_of_tone = ((data_vals[:, None] >> shifts[None, :]) & 1).bool()  # [M, bps]
    e_b = energies.float()[..., None]  # [..., S, M, 1]
    neg_inf = torch.tensor(float("-inf"), dtype=torch.float32, device=dev)
    max_one = torch.where(bit_of_tone, e_b, neg_inf).amax(-2)  # [..., S, bps]
    max_zero = torch.where(~bit_of_tone, e_b, neg_inf).amax(-2)
    llrs = max_one - max_zero
    return llrs.reshape(*energies.shape[:-2], energies.shape[-2] * bps)


def estimate_snr_db(config: ModemConfig, energies: torch.Tensor) -> torch.Tensor:
    """Per-stream SNR estimate from the filterbank output (dB): winning-bin
    energy over the mean of the losing bins, aggregated over symbols."""
    m = config.num_tones
    best = energies.amax(-1)
    rest = (energies.sum(-1) - best) / (m - 1)
    sig = best.mean(-1)
    noise = rest.mean(-1).clamp_min(1e-20)
    return 10.0 * torch.log10((sig / noise - 1.0).clamp_min(1e-6))
