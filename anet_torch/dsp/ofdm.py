"""OFDM modem family (mirrors ``anet.dsp.ofdm``): QPSK, 16-QAM or 64-QAM
subcarriers over a real (audio) channel.

A second modulation family beside MFSK, sharing the whole frame stack
(header/CRC/FEC through anet_torch.dsp.frame.frame_result_from_bits) and the
matched-filter sync. Where MFSK trades rate for robustness, OFDM packs ~10x
the bit rate into the same band and equalizes multipath with one complex
tap per carrier.

Signal construction (all real-valued, audio-band):
- sparse-carrier inverse DFT (a product, see _synth_basis) with the
  constellation on carriers [first_carrier, first_carrier + n_carriers)
  and a cyclic prefix per symbol;
- frame = preamble (``preamble_repeats`` identical known symbols) + one
  pilot symbol (known QPSK pattern: the per-carrier channel estimate) +
  data symbols;
- receive: locate by matched filter, strip the CP, sparse-carrier DFT (a
  product, see _analysis_basis), equalize by the pilot-derived channel,
  then the equalizer's back half: the decision-directed clock fit with its
  identity gate, derotation, max-log LLRs and the error-vector power, all
  one kernel (anet_torch.kernels.ofdm_track_decide_fused: CUDA on the card,
  its plain version on the CPU), then the shared frame parser.

Every receiver here takes the route of the JAX package's
``_equalized_llrs_fused``; that package's default jnp tracker route and its
``ANET_OFDM_FUSED`` switch are not carried over. ``_phase_track`` is kept as
the plain version's fit.
"""

from __future__ import annotations

import dataclasses
import json
import math
from functools import lru_cache
from typing import NamedTuple, Tuple

import numpy as np
import torch

from anet_torch._device import as_tensor, resolve_device
from anet_torch.dsp.frame import (
    DynamicFrameResult,
    FrameResult,
    data_section_air_bits_array,
    data_section_coded_bits,
    frame_result_from_bits,
    frame_result_from_bits_dynamic,
)
from anet_torch.dsp.sync import (
    aligned_gather,
    correlate_template,
    normalized_match_quality,
    sliding_window_energy,
)


@dataclasses.dataclass(frozen=True)
class OfdmConfig:
    """Static OFDM parameters (a copy of ``anet.dsp.ofdm.OfdmConfig``;
    ``from_json`` reads that class's ``to_json`` output unchanged).

    Defaults: 48 kHz audio, 256-point FFT (187.5 Hz carrier spacing), 96
    QPSK carriers spanning 3.0-20.8 kHz, 64-sample cyclic prefix (1.3 ms of
    echo tolerance) -> 192 bits per 6.67 ms symbol = 28.8 kbps channel rate.
    """

    sample_rate_hz: int = 48_000
    n_fft: int = 256
    cp_len: int = 64
    first_carrier: int = 16
    n_carriers: int = 96
    # Bits per carrier: 2 = QPSK (default), 4 = 16-QAM (double rate,
    # ~7 dB more SNR required), 6 = 64-QAM (triple rate, ~13 dB more).
    bits_per_carrier: int = 2
    preamble_repeats: int = 2  # identical symbols in the preamble
    amplitude: float = 0.5
    # 3-tap smoothing of the pilot channel estimate across carriers.
    pilot_smoothing: bool = True
    # Sample-clock drift compensation: a preamble-seeded slope, refined by
    # the decision-directed fit of _phase_track (see there).
    clock_tracking: bool = True
    # FEC surface shared with ModemConfig (see frame_result_from_bits)
    fec: str = "none"
    fec_interleave: int = 0

    def __post_init__(self) -> None:
        if self.fec not in ("none", "conv"):
            raise ValueError(f"fec must be 'none' or 'conv', got {self.fec!r}")
        if self.fec_interleave < 0:
            raise ValueError("fec_interleave must be >= 0")
        if self.n_fft & (self.n_fft - 1):
            raise ValueError("n_fft must be a power of two")
        if not 0 < self.cp_len < self.n_fft:
            raise ValueError("cp_len must be in (0, n_fft)")
        if self.first_carrier < 1:
            raise ValueError("first_carrier must be >= 1 (DC is unusable)")
        if self.first_carrier + self.n_carriers > self.n_fft // 2:
            raise ValueError("carriers exceed the real-signal Nyquist bin")
        if self.bits_per_carrier not in (2, 4, 6):
            raise ValueError(
                "bits_per_carrier must be 2 (QPSK), 4 (16-QAM), or 6 (64-QAM)"
            )

    # --- geometry ------------------------------------------------------------

    @property
    def symbol_samples(self) -> int:
        return self.n_fft + self.cp_len

    @property
    def bits_per_symbol(self) -> int:
        return self.bits_per_carrier * self.n_carriers

    @property
    def bit_rate_bps(self) -> float:
        return self.bits_per_symbol * self.sample_rate_hz / self.symbol_samples

    @property
    def carrier_freqs_hz(self) -> Tuple[float, ...]:
        df = self.sample_rate_hz / self.n_fft
        return tuple((self.first_carrier + k) * df for k in range(self.n_carriers))

    @property
    def preamble_samples(self) -> int:
        return self.preamble_repeats * self.symbol_samples

    def coded_bits_for_data_bits(self, n_bits: int) -> int:
        if self.fec == "conv":
            from anet_torch.dsp.fec import conv_encoded_bits, interleaved_bits

            return interleaved_bits(conv_encoded_bits(n_bits), self.fec_interleave)
        return n_bits

    def data_symbols_for_payload(self, payload_len: int) -> int:
        bits = data_section_coded_bits(self, payload_len)
        return -(-bits // self.bits_per_symbol)

    def frame_num_samples(self, payload_len: int) -> int:
        # preamble + pilot + data symbols
        return self.preamble_samples + self.symbol_samples * (
            1 + self.data_symbols_for_payload(payload_len)
        )

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "OfdmConfig":
        return cls(**json.loads(text))


# --- deterministic known sequences (protocol constants) ----------------------


@lru_cache(maxsize=16)
def _pn_qpsk_np(n_carriers: int, seed: int, n_symbols: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    phases = rng.integers(0, 4, (n_symbols, n_carriers))
    return np.exp(1j * (np.pi / 2 * phases + np.pi / 4)).astype(np.complex64)


def _pn_qpsk(config: OfdmConfig, seed: int, n_symbols: int = 1, device="cuda") -> torch.Tensor:
    """Known unit-modulus QPSK sequence, [n_symbols, n_carriers] complex64,
    from numpy's generator, so both packages make the same one."""
    return torch.as_tensor(
        _pn_qpsk_np(config.n_carriers, seed, n_symbols), device=resolve_device(device)
    )


def pilot_carriers(config: OfdmConfig, device="cuda") -> torch.Tensor:
    """The known pilot symbol's carrier values (seeded by the magic word)."""
    return _pn_qpsk(config, 0x2C5DA044, device=device)[0]


def preamble_carriers(config: OfdmConfig, device="cuda") -> torch.Tensor:
    return _pn_qpsk(config, 0x2C5DA044 ^ 0xFFFF, device=device)[0]


# --- synthesis ---------------------------------------------------------------


@lru_cache(maxsize=16)
def _synth_basis(
    n_fft: int, cp_len: int, first_carrier: int, n_carriers: int
) -> tuple[np.ndarray, np.ndarray]:
    """Sparse-carrier inverse-DFT bases, CP folded in: [C, cp_len + n_fft].

    Only ``n_carriers`` of the n_fft/2 bins are ever nonzero, so synthesis
    is a [.., C] x [C, symbol] product instead of a full irfft. The cyclic
    prefix is the same cosines evaluated cp_len samples early (cos/sin are
    N-periodic): the basis rows start at t = -cp_len."""
    t = np.arange(-cp_len, n_fft, dtype=np.float64)
    m = first_carrier + np.arange(n_carriers, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(m, t) / n_fft  # [C, cp+N]
    a = (2.0 / n_fft) * np.cos(ang)
    b = -(2.0 / n_fft) * np.sin(ang)
    return a.astype(np.float32), b.astype(np.float32)


def _symbols_to_waveform(config: OfdmConfig, carriers: torch.Tensor) -> torch.Tensor:
    """complex [..., S, n_carriers] -> real float32 [..., S * symbol_samples]:
    time[t] = (2/N) sum_m (Re X_m cos(2 pi m t / N) - Im X_m sin(...)), one
    float32 product per quadrature."""
    shape = carriers.shape[:-1]
    a_np, b_np = _synth_basis(config.n_fft, config.cp_len, config.first_carrier, config.n_carriers)
    dev = carriers.device
    with_cp = carriers.real @ torch.as_tensor(a_np, device=dev) + carriers.imag @ torch.as_tensor(
        b_np, device=dev
    )  # [..., S, cp+N]
    flat = with_cp.reshape(*shape[:-1], shape[-1] * config.symbol_samples)
    # Unit-QPSK carriers give RMS sqrt(2C)/N; scale so the waveform RMS is
    # amplitude/4, which with OFDM's ~12 dB peak-to-average ratio makes
    # `amplitude` about the typical peak level.
    scale = (config.amplitude / 4.0) * config.n_fft / math.sqrt(2.0 * config.n_carriers)
    return flat * scale


def preamble_waveform(config: OfdmConfig, device="cuda") -> torch.Tensor:
    """The known preamble template: preamble_repeats identical symbols."""
    one = _symbols_to_waveform(config, preamble_carriers(config, device)[None, :])
    return one.repeat(config.preamble_repeats)


_SQRT2 = math.sqrt(2.0)


def bits_to_qpsk(bits: torch.Tensor) -> torch.Tensor:
    """0/1 [..., 2K] -> complex64 [..., K]; Gray map, (b0, b1) -> (I, Q)."""
    pairs = bits.reshape(*bits.shape[:-1], bits.shape[-1] // 2, 2).float()
    return torch.complex((1.0 - 2.0 * pairs[..., 0]) / _SQRT2, (1.0 - 2.0 * pairs[..., 1]) / _SQRT2)


# Gray-mapped 4-PAM amplitudes per axis for 16-QAM: bit pair (sign, inner)
# 00 -> -3, 01 -> -1, 11 -> +1, 10 -> +3, unit average symbol power overall.
_QAM16_SCALE = 1.0 / math.sqrt(10.0)


def _pam4(b_sign: torch.Tensor, b_inner: torch.Tensor) -> torch.Tensor:
    sign = 2.0 * b_sign.float() - 1.0  # 0 -> -1, 1 -> +1
    mag = 3.0 - 2.0 * b_inner.float()  # 0 -> 3, 1 -> 1
    return sign * mag * _QAM16_SCALE


def bits_to_qam16(bits: torch.Tensor) -> torch.Tensor:
    """0/1 [..., 4K] -> complex64 [..., K]; Gray per axis, (b0, b1) -> I,
    (b2, b3) -> Q."""
    quads = bits.reshape(*bits.shape[:-1], bits.shape[-1] // 4, 4)
    return torch.complex(_pam4(quads[..., 0], quads[..., 1]), _pam4(quads[..., 2], quads[..., 3]))


# Gray-mapped 8-PAM amplitudes per axis for 64-QAM: bit triple
# (sign, mid, inner) -> reflected-Gray amplitude; unit average symbol power.
#   (0,00) -> -7  (0,01) -> -5  (0,11) -> -3  (0,10) -> -1
#   (1,10) -> +1  (1,11) -> +3  (1,01) -> +5  (1,00) -> +7
_QAM64_SCALE = 1.0 / math.sqrt(42.0)


def _pam8(b_sign: torch.Tensor, b_mid: torch.Tensor, b_inner: torch.Tensor) -> torch.Tensor:
    sign = 2.0 * b_sign.float() - 1.0  # 0 -> -1, 1 -> +1
    m = b_mid.to(torch.int32)
    # Gray-decode (mid, inner): 00 -> 0, 01 -> 1, 11 -> 2, 10 -> 3
    v = 2 * m + (m ^ b_inner.to(torch.int32))
    mag = 7.0 - 2.0 * v.float()  # 7, 5, 3, 1
    return sign * mag * _QAM64_SCALE


def bits_to_qam64(bits: torch.Tensor) -> torch.Tensor:
    """0/1 [..., 6K] -> complex64 [..., K]; Gray per axis, (b0, b1, b2) -> I,
    (b3, b4, b5) -> Q."""
    six = bits.reshape(*bits.shape[:-1], bits.shape[-1] // 6, 6)
    return torch.complex(
        _pam8(six[..., 0], six[..., 1], six[..., 2]), _pam8(six[..., 3], six[..., 4], six[..., 5])
    )


def bits_to_carriers(config: OfdmConfig, bits: torch.Tensor) -> torch.Tensor:
    if config.bits_per_carrier == 6:
        return bits_to_qam64(bits)
    if config.bits_per_carrier == 4:
        return bits_to_qam16(bits)
    return bits_to_qpsk(bits)


def _pam4_llrs(a: torch.Tensor, weight: torch.Tensor):
    """Max-log LLRs for one Gray 4-PAM axis (positive = bit 1); ``a`` is the
    equalized amplitude (unit constellation scale), ``weight`` the
    per-carrier channel reliability."""
    return a * weight, (2.0 * _QAM16_SCALE - a.abs()) * weight


def _pam8_llrs(a: torch.Tensor, weight: torch.Tensor):
    """Max-log LLRs for one Gray 8-PAM axis (positive = bit 1): sign at 0,
    mid bit at |a| = 4 (bit 1 inside), inner bit at |a| = 2 and 6 (bit 1
    between), in unit-constellation scale."""
    mag = a.abs()
    return (
        a * weight,
        (4.0 * _QAM64_SCALE - mag) * weight,
        (2.0 * _QAM64_SCALE - (mag - 4.0 * _QAM64_SCALE).abs()) * weight,
    )


def transmit(config: OfdmConfig, payload, device="cuda") -> torch.Tensor:
    """payload uint8[..., N] -> frame waveform float32[..., frame_samples] on
    ``device``; the MFSK frame's byte layout and coding
    (anet_torch.dsp.frame.data_section_air_bits_array)."""
    payload = as_tensor(payload, device, torch.uint8)
    bits = data_section_air_bits_array(config, payload)
    s_data = config.data_symbols_for_payload(payload.shape[-1])
    pad = s_data * config.bits_per_symbol - bits.shape[-1]
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    lead = bits.shape[:-1]
    carriers = bits_to_carriers(config, bits).reshape(*lead, s_data, config.n_carriers)
    pilot = pilot_carriers(config, payload.device).expand(*lead, 1, config.n_carriers)
    data_wave = _symbols_to_waveform(config, torch.cat([pilot, carriers], dim=-2))
    pre = preamble_waveform(config, payload.device).expand(*lead, config.preamble_samples)
    return torch.cat([pre, data_wave], dim=-1)


# --- demodulation ------------------------------------------------------------


def _timing_bias(config: OfdmConfig) -> int:
    """FFT-window advance into the cyclic prefix, in samples: a window
    ``bias`` samples early is a pure cyclic shift (a per-carrier rotation
    identical on every symbol, cancelled by the pilot-relative equalizer)
    and buys ``bias`` samples of margin against late timing, at the cost of
    as much echo margin."""
    return config.cp_len // 4


@lru_cache(maxsize=16)
def _analysis_basis(n_fft: int, first_carrier: int, n_carriers: int, bias: int) -> np.ndarray:
    """Sparse-carrier DFT basis [n_fft, 2 * n_carriers] (Re | Im columns):
    W[t, m] = e^{-2 pi i m (t - bias) / N}, the forward DFT restricted to the
    active carriers with the early-window rotation folded in."""
    t = np.arange(n_fft, dtype=np.float64) - bias
    m = first_carrier + np.arange(n_carriers, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(t, m) / n_fft  # [N, C]
    return np.concatenate([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)


def _basis_tensor(config: OfdmConfig, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(
        _analysis_basis(config.n_fft, config.first_carrier, config.n_carriers, _timing_bias(config)),
        device=device,
    )


def _extract_carriers(config: OfdmConfig, samples: torch.Tensor, n_symbols: int) -> torch.Tensor:
    """Symbol-aligned real samples [..., T] -> complex64 carriers [..., S,
    n_carriers]. bf16 samples are widened to float32 before the float32
    product (the basis is never rounded to the samples' dtype)."""
    bias = _timing_bias(config)
    ss = config.symbol_samples
    sym = samples[..., : n_symbols * ss].reshape(*samples.shape[:-1], n_symbols, ss)
    no_cp = sym[..., config.cp_len - bias : ss - bias].float()
    spec = no_cp @ _basis_tensor(config, samples.device)  # [..., S, 2C]
    c = config.n_carriers
    return torch.complex(spec[..., :c], spec[..., c:])


def _nearest_odd(a: torch.Tensor, max_level: float) -> torch.Tensor:
    """Quantize to the nearest odd integer in [-max_level, max_level] (round
    half to even, as jnp.round)."""
    return (2.0 * torch.round((a - 1.0) / 2.0) + 1.0).clamp(-max_level, max_level)


def _hard_decision(config: OfdmConfig, z: torch.Tensor) -> torch.Tensor:
    """Nearest constellation point (unit average power) for z_eq estimates."""
    re, im = z.real, z.imag
    if config.bits_per_carrier == 6:
        s = _QAM64_SCALE
        return torch.complex(_nearest_odd(re / s, 7.0) * s, _nearest_odd(im / s, 7.0) * s)
    if config.bits_per_carrier == 4:
        s = _QAM16_SCALE
        return torch.complex(_nearest_odd(re / s, 3.0) * s, _nearest_odd(im / s, 3.0) * s)
    amp = 1.0 / _SQRT2
    return torch.complex(
        torch.where(re >= 0, amp, -amp).float(), torch.where(im >= 0, amp, -amp).float()
    )


def _slope_from_preamble(config: OfdmConfig, y0: torch.Tensor, y1: torch.Tensor) -> torch.Tensor:
    """The gated phase slope from the carriers [..., C] of two repeated
    preamble symbols (the body of preamble_phase_slope)."""
    r = y1 * y0.conj()  # [..., C], phase = c*m
    # coarse: adjacent-carrier differential (wrap-free, short baseline)
    d = r[..., 1:] * r[..., :-1].conj()
    c0 = torch.angle(d.sum(-1)).float()
    # refine: fit the residual phases through the origin against the full
    # absolute-carrier baseline
    m = (config.first_carrier + torch.arange(config.n_carriers, device=r.device)).float()
    ang = -(c0[..., None] * m)
    phi = torch.angle(r * torch.polar(torch.ones_like(ang), ang))
    w = r.abs()
    num = (w * m * phi).sum(-1)
    den = (w * m * m).sum(-1).clamp_min(1e-20)
    c = c0 + num / den
    # Wrap gate: the weighted residual coherence is >= 0.91 on every sound
    # estimate and ~0 when the coarse slope wrapped; a zeroed seed makes the
    # tracker a no-op for that frame.
    resid = phi - (num / den)[..., None] * m
    coh = (w * torch.cos(resid)).sum(-1) / w.sum(-1).clamp_min(1e-20)
    gate = ((coh - 0.5) / 0.3).clamp(0.0, 1.0)
    return (c * gate).float()


def preamble_phase_slope(config: OfdmConfig, samples: torch.Tensor) -> torch.Tensor:
    """Decision-free clock-drift slope from the repeated preamble symbols
    (Schmidl-Cox structure): a sample-clock offset delta rotates carrier m of
    the second copy by 2 pi m delta L / N relative to the first, so the
    slope c (radians per carrier index per symbol) is the phase slope of
    Y2 conj(Y1). Returns float32 [...], 0 when the preamble has no repeat."""
    if config.preamble_repeats < 2:
        return torch.zeros(samples.shape[:-1], dtype=torch.float32, device=samples.device)
    y = _extract_carriers(config, samples[..., : config.preamble_samples], config.preamble_repeats)
    return _slope_from_preamble(config, y[..., 0, :], y[..., 1, :])


def estimate_drift_ppm(config: OfdmConfig, samples: torch.Tensor) -> torch.Tensor:
    """Sample-clock offset estimate (ppm) from an aligned frame's preamble."""
    c = preamble_phase_slope(config, samples)
    return c * config.n_fft / (2.0 * math.pi * config.symbol_samples) * 1e6


def _phase_track(
    config: OfdmConfig,
    z_eq: torch.Tensor,
    weights: torch.Tensor,
    slope0: torch.Tensor,
    with_coherence: bool = False,
):
    """Per-symbol derotation phasors [..., S, C] for clock-drift
    compensation (the plain form of the kernel's fit).

    Data symbol s (0-based, pilot = -1) carries phase c*(s+1)*m at absolute
    carrier m. The single parameter c is fitted to all points at once, twice:
    derotate by the current c (the preamble seed first), hard-decide, and
    update c by the weighted least-squares ratio sum((s+1)m Im u) /
    sum(((s+1)m)^2 max(Re u, 0)) with u = w z conj(d). Then the identity
    gate: the fitted rotation is kept only where the weighted decision
    coherence of the rotated points beats that of the unrotated ones (a
    poison preamble seed at low SNR otherwise locks the fit onto its own
    rotation); ties keep the identity. ``weights`` broadcasts against z_eq
    ([..., 1, C]). With ``with_coherence`` also returns float32 [..., 2]:
    the tracked and the unrotated coherence."""
    m = (config.first_carrier + torch.arange(config.n_carriers, device=z_eq.device)).float()
    sym = torch.arange(1, z_eq.shape[-2] + 1, device=z_eq.device, dtype=torch.float32)
    phase = sym[:, None] * m[None, :]  # [S, C], (s+1)*m
    c = slope0.float()[..., None, None]

    def rotation(c):
        ang = -(c * phase)
        return torch.polar(torch.ones_like(ang), ang)

    for _ in range(2):
        zc = z_eq * rotation(c)
        u = weights * zc * _hard_decision(config, zc).conj()
        num = (phase * u.imag).sum((-2, -1))
        den = (phase * phase * u.real.clamp_min(0.0)).sum((-2, -1)).clamp_min(1e-20)
        c = c + (num / den)[..., None, None]

    rot = rotation(c)

    def coherence(z):
        u = weights * z * _hard_decision(config, z).conj()
        return u.real.sum((-2, -1)) / u.abs().sum((-2, -1)).clamp_min(1e-20)

    coh1, coh0 = coherence(z_eq * rot), coherence(z_eq)
    keep = (coh1 > coh0)[..., None, None]
    rot = torch.where(keep, rot, torch.ones((), dtype=rot.dtype, device=rot.device))
    if with_coherence:
        return rot, torch.stack([coh1, coh0], dim=-1)
    return rot


def _evm_to_metrics(evm2: torch.Tensor):
    """(confidence, snr_db) from the error-vector power."""
    snr_db = 10.0 * torch.log10((1.0 / evm2.clamp_min(1e-9)).clamp_min(1e-6))
    return 1.0 / (1.0 + evm2), snr_db


def _equalize(config: OfdmConfig, carriers: torch.Tensor):
    """Pilot + data carriers [.., 1 + S, C] -> (z_eq complex64 [.., S, C],
    h_pow float32 [.., C]): the channel estimate from the pilot (smoothed
    across carriers, edges repeated), one-tap equalization. Elementwise
    results keep the carriers' memory layout, so time-major [S, C, B]
    carriers viewed as [B, S, C] give time-major z_eq."""
    h = carriers[..., 0, :] * pilot_carriers(config, carriers.device).conj()
    if config.pilot_smoothing:
        h_pad = torch.cat([h[..., :1], h, h[..., -1:]], dim=-1)
        h = 0.25 * h_pad[..., :-2] + 0.5 * h_pad[..., 1:-1] + 0.25 * h_pad[..., 2:]
    z = carriers[..., 1:, :] * h.conj()[..., None, :]  # matched equalization
    h_pow = (h.abs() ** 2).clamp_min(1e-12)
    hp = h_pow[..., None, :]
    return torch.complex(z.real / hp, z.imag / hp), h_pow  # unit-constellation estimates


def _llrs_from_carriers(
    config: OfdmConfig, carriers: torch.Tensor, slope0: torch.Tensor, evm_symbols: int
):
    """Pilot + data carriers [.., 1 + S, C] -> (bits uint8, llrs float32
    [.., S*C*bpc], evm2 float32 [..]): _equalize, then
    ofdm_track_decide_fused (which reads z_eq by strides)."""
    from anet_torch.kernels import ofdm_track_decide_fused

    z_eq, h_pow = _equalize(config, carriers)
    llrs, evm2 = ofdm_track_decide_fused(config, z_eq, h_pow, slope0, evm_symbols=evm_symbols)
    return (llrs > 0).to(torch.uint8), llrs, evm2


def _equalized_llrs_fused(config: OfdmConfig, samples: torch.Tensor, s_data: int, evm_symbols: int):
    """Aligned frame waveforms [..., T] -> (bits, llrs, evm2) for ``s_data``
    symbols, the EVM over the first ``evm_symbols``: carrier extraction and
    channel estimate in PyTorch (product-dominated), then the kernel."""
    carriers = _extract_carriers(config, samples[..., config.preamble_samples :], 1 + s_data)
    if config.clock_tracking:
        slope0 = preamble_phase_slope(config, samples)
    else:
        slope0 = torch.zeros(samples.shape[:-1], dtype=torch.float32, device=samples.device)
    return _llrs_from_carriers(config, carriers, slope0, evm_symbols)


def demodulate_frame(config: OfdmConfig, samples, payload_len: int, *, device="cuda") -> FrameResult:
    """Aligned frame waveform [..., T] (starting at the preamble) ->
    FrameResult, on ``device``."""
    samples = as_tensor(samples, device)
    s_data = config.data_symbols_for_payload(payload_len)
    bits, llrs, evm2 = _equalized_llrs_fused(config, samples, s_data, s_data)
    confidence, snr_db = _evm_to_metrics(evm2)
    return frame_result_from_bits(
        config, bits, payload_len, llrs=llrs, confidence=confidence, snr_db=snr_db
    )


def demodulate_frame_dynamic(
    config: OfdmConfig, samples, max_payload_len: int, *, device="cuda"
) -> DynamicFrameResult:
    """Aligned max-length frame window -> payload + header-declared length.
    Quality metrics use the overhead-only symbol span, the only region
    guaranteed to carry signal at any declared length. Uncoded only, as
    frame_result_from_bits_dynamic."""
    samples = as_tensor(samples, device)
    s_data = config.data_symbols_for_payload(max_payload_len)
    s_min = config.data_symbols_for_payload(0)
    bits, _, evm2 = _equalized_llrs_fused(config, samples, s_data, s_min)
    confidence, snr_db = _evm_to_metrics(evm2)
    return frame_result_from_bits_dynamic(
        config, bits, max_payload_len, confidence=confidence, snr_db=snr_db
    )


class OfdmReceiveResult(NamedTuple):
    frame: FrameResult
    offset: torch.Tensor  # int32[...] located frame start
    quality: torch.Tensor  # float32[...] sync match quality


def receive_frame(config: OfdmConfig, capture, payload_len: int, *, device="cuda") -> OfdmReceiveResult:
    """Locate (matched filter, quality normalized by the exact window energy
    at every lag) and demodulate one OFDM frame in a capture [..., N]."""
    capture = as_tensor(capture, device)
    t = config.frame_num_samples(payload_len)
    n = capture.shape[-1]
    if n < t:
        raise ValueError(f"capture of {n} samples cannot hold a {t}-sample frame")
    template = preamble_waveform(config, capture.device)
    corr = correlate_template(capture, template, method="auto")
    energy = sliding_window_energy(capture, template.shape[-1])
    quality = normalized_match_quality(corr, energy, (template * template).sum())
    offset = torch.argmax(quality, dim=-1)
    best_q = torch.gather(quality, -1, offset[..., None])[..., 0]
    start = offset.clamp(0, n - t)
    frame = demodulate_frame(config, aligned_gather(capture, start, t), payload_len, device=capture.device)
    return OfdmReceiveResult(frame=frame, offset=offset.to(torch.int32), quality=best_q)


# --- time-major receive pipeline ---------------------------------------------
#
# [T, B] variants: the stream batch is the minor dimension, so the split
# into [S, symbol_samples, B] is a view, the sparse-carrier DFT is one
# batched product over that view (the samples are never transposed), and
# the equalizer works on [S, C, B] carriers viewed as [B, S, C]; the kernel
# reads them by strides and writes batch-major LLRs for the shared parser.


def _extract_carriers_tm(config: OfdmConfig, samples_tm: torch.Tensor, n_symbols: int) -> torch.Tensor:
    """[T', B] symbol-aligned real samples -> complex64 [S, n_carriers, B]."""
    bias = _timing_bias(config)
    ss = config.symbol_samples
    b = samples_tm.shape[-1]
    sym = samples_tm[: n_symbols * ss].reshape(n_symbols, ss, b)
    no_cp = sym[:, config.cp_len - bias : ss - bias, :].float()  # [S, N, B]
    w_t = _basis_tensor(config, samples_tm.device).T.contiguous()  # [2C, N]
    spec = torch.bmm(w_t.expand(n_symbols, -1, -1), no_cp)  # [S, 2C, B]
    c = config.n_carriers
    return torch.complex(spec[:, :c], spec[:, c:])


def _preamble_phase_slope_tm(config: OfdmConfig, samples_tm: torch.Tensor) -> torch.Tensor:
    """preamble_phase_slope for [T, B] input; returns [B] slopes."""
    if config.preamble_repeats < 2:
        return torch.zeros(samples_tm.shape[-1], dtype=torch.float32, device=samples_tm.device)
    y = _extract_carriers_tm(config, samples_tm[: config.preamble_samples], config.preamble_repeats)
    return _slope_from_preamble(config, y[0].T, y[1].T)  # [B, C] views


def demodulate_frame_tm(config: OfdmConfig, samples_tm, payload_len: int, *, device="cuda") -> FrameResult:
    """demodulate_frame for TIME-MAJOR [T, B] input; returns the same
    batch-major FrameResult."""
    samples_tm = as_tensor(samples_tm, device)
    s_data = config.data_symbols_for_payload(payload_len)
    body = samples_tm[config.preamble_samples :]
    carriers = _extract_carriers_tm(config, body, 1 + s_data).permute(2, 0, 1)  # [B, 1+S, C] view
    if config.clock_tracking:
        slope0 = _preamble_phase_slope_tm(config, samples_tm)
    else:
        slope0 = torch.zeros(samples_tm.shape[-1], dtype=torch.float32, device=samples_tm.device)
    bits, llrs, evm2 = _llrs_from_carriers(config, carriers, slope0, s_data)
    confidence, snr_db = _evm_to_metrics(evm2)
    return frame_result_from_bits(
        config, bits, payload_len, llrs=llrs, confidence=confidence, snr_db=snr_db
    )
