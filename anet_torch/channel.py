"""Channel simulator: AWGN, multipath, dropouts, clipping, gain and clock
drift (mirrors ``anet.channel``).

The fault-injection layer: impairments are injected into the signal path,
and the receiver's verdicts (FrameResult) measure the damage. Every
impairment is plain tensor work batched over leading axes; ``apply_channel``
runs the physically ordered chain drift -> multipath -> gain -> dropout ->
AWGN -> clip, as the reference's.

Randomness: the reference's ``jax.random`` keys become an explicit
``torch.Generator`` on the samples' device, so a seed reproduces a run on
one device. The streams differ from ``jax.random``'s, so the random
impairments match the reference in distribution, not sample by sample.
Every function takes ``device=`` (default ``"cuda"``) for the samples.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

import torch

from anet_torch._device import as_tensor

__all__ = [
    "ChannelConfig",
    "awgn",
    "apply_channel",
    "clip",
    "dropout",
    "multipath",
    "sample_rate_drift",
    "snr_scale",
]


def snr_scale(signal_power, snr_db) -> torch.Tensor:
    """Noise standard deviation achieving ``snr_db`` against ``signal_power``."""
    noise_power = signal_power / (10.0 ** (snr_db / 10.0))
    return torch.sqrt(torch.as_tensor(noise_power))


def awgn(gen: torch.Generator, samples, snr_db, device="cuda") -> torch.Tensor:
    """Additive white Gaussian noise at a target SNR, drawn from ``gen``.

    SNR is measured against the actual mean power of ``samples`` along the
    last axis, so the same snr_db is the same operating point whatever the
    amplitude. ``snr_db`` may be batched: one value per stream of the
    leading axes (how a BER sweep spreads an SNR grid)."""
    x = as_tensor(samples, device)
    power = (x * x).mean(-1, keepdim=True)
    sigma = snr_scale(power, torch.as_tensor(snr_db, dtype=x.dtype, device=x.device)[..., None])
    noise = torch.randn(x.shape, generator=gen, dtype=x.dtype, device=x.device)
    return x + sigma * noise


def multipath(samples, taps, device="cuda") -> torch.Tensor:
    """Convolve with an echo impulse response (causal FIR, same length out).
    ``taps`` is a short 1-D response, tap 0 the direct path (e.g. [1.0, 0,
    0, 0.5]: one echo 3 samples later at half amplitude)."""
    x = as_tensor(samples, device)
    taps = as_tensor(taps, x.device, x.dtype)
    k, n = taps.shape[-1], x.shape[-1]
    padded = torch.nn.functional.pad(x, (k - 1, 0))
    # y[t] = sum_j taps[j] x[t - j]: one scaled shifted view a tap, summed
    # in tap order (no [..., n, k] stack of the views)
    out = taps[0] * x
    for j in range(1, k):
        out = out + taps[j] * padded[..., k - 1 - j : k - 1 - j + n]
    return out


def dropout(gen: torch.Generator, samples, drop_rate: float, burst_samples: int, device="cuda") -> torch.Tensor:
    """Zero out bursts of samples (the packet-loss or underflow analog):
    each non-overlapping ``burst_samples`` block drops i.i.d. with
    probability ``drop_rate``, the draws from ``gen``."""
    x = as_tensor(samples, device)
    n = x.shape[-1]
    n_blocks = -(-n // burst_samples)
    u = torch.rand((*x.shape[:-1], n_blocks), generator=gen, device=x.device)
    keep = (u >= drop_rate).to(x.dtype)
    return x * keep.repeat_interleave(burst_samples, dim=-1)[..., :n]


def clip(samples, level: float, device="cuda") -> torch.Tensor:
    """Hard-limit the waveform (speaker or ADC saturation)."""
    return as_tensor(samples, device).clamp(-level, level)


def sample_rate_drift(samples, ppm, device="cuda") -> torch.Tensor:
    """Resample by a small rate offset: the receiver's clock runs ``ppm``
    fast, so it samples at positions i (1 + ppm 1e-6). Linear
    interpolation, the same length out (the tail clamps to the last
    sample), bit-equal to the reference: the factor 1 + ppm 1e-6 is formed
    in double and rounded to float32 once, positions are float32.

    ``ppm`` is a float, as the reference takes it, or a tensor of one value
    per stream of the leading axes (each row drifted by its own offset)."""
    x = as_tensor(samples, device)
    n = x.shape[-1]
    scale = (1.0 + torch.as_tensor(ppm, dtype=torch.float64, device=x.device) * 1e-6).float()
    pos = torch.arange(n, dtype=torch.float32, device=x.device) * scale[..., None]
    base = pos.floor().clamp(0, n - 2)
    frac = pos - base
    idx = base.long().expand(*x.shape[:-1], n)
    return x.gather(-1, idx) * (1.0 - frac) + x.gather(-1, idx + 1) * frac


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    """Composite channel; JSON round trip both ways with the reference's.

    snr_db=None disables noise; multipath_taps=None disables echoes;
    drop_rate=0 disables dropouts; clip_level=None disables clipping."""

    snr_db: Optional[float] = 10.0
    multipath_taps: Optional[Tuple[float, ...]] = None
    gain: float = 1.0
    drop_rate: float = 0.0
    drop_burst_samples: int = 256
    clip_level: Optional[float] = None
    drift_ppm: float = 0.0

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "ChannelConfig":
        raw = json.loads(text)
        if raw.get("multipath_taps") is not None:
            raw["multipath_taps"] = tuple(raw["multipath_taps"])
        return cls(**raw)


def apply_channel(
    gen: torch.Generator, samples, config: ChannelConfig, snr_db=None, device="cuda"
) -> torch.Tensor:
    """Run the whole impairment chain on ``device``, random draws from
    ``gen``: the dropout mask before the noise, as the reference splits its
    key. ``snr_db`` overrides config.snr_db (possibly batched, for sweeps)."""
    out = as_tensor(samples, device)
    if config.drift_ppm:
        out = sample_rate_drift(out, config.drift_ppm, out.device)
    if config.multipath_taps is not None:
        out = multipath(out, config.multipath_taps, out.device)
    if config.gain != 1.0:
        out = out * config.gain
    if config.drop_rate > 0.0:
        out = dropout(gen, out, config.drop_rate, config.drop_burst_samples, out.device)
    effective_snr = config.snr_db if snr_db is None else snr_db
    if effective_snr is not None:
        out = awgn(gen, out, effective_snr, out.device)
    if config.clip_level is not None:
        out = clip(out, config.clip_level, out.device)
    return out
