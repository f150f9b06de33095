"""Modem model presets: named, tuned configurations of the signal chain.

The registry, presets and operating thresholds of ``anet/models/__init__.py``,
copied so that ``anet_torch`` imports nothing of ``anet``, and its helpers:
the link-adaptation rule (``net_bit_rate_bps``, ``suggest_model``) and the
blind capture classifier (``classify_capture``: one matched filter a preset,
then a header check of the tied leaders), which runs on the card by default.

- ``fsk2-robust``   — binary FSK, low rate, maximum noise margin.
- ``mfsk4-voice``   — 4-FSK in the voice band (300-3400 Hz).
- ``mfsk8-audible`` — 8-FSK mid-band, balanced rate/robustness.
- ``mfsk16-fast``   — the flagship: 16-FSK, 3 kbps, full audio band.
- ``mfsk16-ultra``  — 16-FSK at 1500 baud (6 kbps).
- ``mfsk4-coded`` / ``mfsk4-coded-stream`` — 4-FSK with K=7 convolutional
  coding; the second has no interleaver, so its frames can declare their
  own length (variable-length streaming).
- ``mfsk32-dense``  — 32-FSK wideband, highest rate, needs high SNR.
- ``ofdm-fast``     — 96-carrier QPSK OFDM, 28.8 kbps.
- ``ofdm-coded`` / ``ofdm-turbo`` / ``ofdm-max`` — coded OFDM (K=7 soft
  Viterbi, depth-32 interleaver) on QPSK, 16-QAM and 64-QAM carriers.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import torch

from anet_torch._device import as_tensor
from anet_torch.dsp.ofdm import OfdmConfig
from anet_torch.dsp.params import ModemConfig


class ModemModel(NamedTuple):
    name: str
    config: ModemConfig
    description: str


_REGISTRY: Dict[str, ModemModel] = {}


def register(model: ModemModel) -> ModemModel:
    if model.name in _REGISTRY:
        raise ValueError(f"model '{model.name}' already registered")
    _REGISTRY[model.name] = model
    return model


def get_model(name: str) -> ModemModel:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown modem model '{name}'; available: {sorted(_REGISTRY)}"
        ) from None


def list_models() -> List[ModemModel]:
    return [_REGISTRY[k] for k in sorted(_REGISTRY)]


# Measured operating thresholds: the lowest waveform SNR (dB, AWGN) at
# which each preset's frame error rate is ~0 (the JAX package's docs/BER.md
# sweeps). The link-adaptation rule picks the fastest preset whose
# threshold fits.
OPERATING_SNR_DB = {
    "fsk2-robust": -6.0,
    "mfsk4-voice": 2.0,
    "mfsk4-coded": -4.0,
    # same code/geometry as mfsk4-coded minus the interleaver: identical
    # AWGN threshold (the interleaver only helps bursts)
    "mfsk4-coded-stream": -4.0,
    "mfsk8-audible": 1.0,
    "mfsk16-fast": 0.0,
    "mfsk16-ultra": 6.0,
    "mfsk32-dense": 0.0,
    "ofdm-fast": 14.0,
    "ofdm-coded": 4.0,
    "ofdm-turbo": 10.0,
    "ofdm-max": 18.0,
}


def net_bit_rate_bps(model: ModemModel) -> float:
    """Payload bit rate after FEC overhead."""
    rate = model.config.bit_rate_bps
    if getattr(model.config, "fec", "none") == "conv":
        rate /= 2.0
    return rate


def suggest_model(snr_db: float, margin_db: float = 2.0) -> ModemModel:
    """Link adaptation: the fastest preset whose measured operating
    threshold fits the reported SNR minus a safety margin; the most robust
    preset when nothing fits. Feed it a waveform-scale SNR: pass a
    FrameResult.snr_db through anet_torch.dsp.family.waveform_snr_db
    first."""
    usable = [
        m for m in list_models()
        if OPERATING_SNR_DB.get(m.name, float("inf")) <= snr_db - margin_db
    ]
    if not usable:
        return min(list_models(), key=lambda m: OPERATING_SNR_DB.get(m.name, 1e9))
    return max(usable, key=net_bit_rate_bps)


register(
    ModemModel(
        "fsk2-robust",
        ModemConfig(
            sample_rate_hz=48_000,
            symbol_rate_hz=375,
            num_tones=2,
            base_freq_hz=1_500.0,
            tone_spacing_multiple=2,
            preamble_symbols=48,
        ),
        "Binary FSK, 375 bps, wide tone spacing and long preamble for "
        "maximum noise/multipath margin.",
    )
)

register(
    ModemModel(
        "mfsk4-voice",
        ModemConfig(
            sample_rate_hz=8_000,
            symbol_rate_hz=250,
            num_tones=4,
            base_freq_hz=800.0,
            preamble_symbols=32,
        ),
        "4-FSK inside the 300-3400 Hz voice band at 8 kHz sampling; "
        "survives telephone-grade channels at 500 bps.",
    )
)

register(
    ModemModel(
        "mfsk8-audible",
        ModemConfig(
            sample_rate_hz=24_000,
            symbol_rate_hz=500,
            num_tones=8,
            base_freq_hz=2_000.0,
            preamble_symbols=32,
        ),
        "8-FSK mid-band at 24 kHz sampling, 1.5 kbps; the balanced default "
        "for loudspeaker-to-microphone links.",
    )
)

register(
    ModemModel(
        "mfsk16-fast",
        ModemConfig(),  # the framework default: 16-FSK @ 750 baud, 3 kbps
        "Flagship 16-FSK at 48 kHz, 3 kbps, tones 3.0-14.25 kHz; the "
        "benchmark configuration.",
    )
)

register(
    ModemModel(
        "mfsk16-ultra",
        ModemConfig(
            symbol_rate_hz=1_500,
            num_tones=16,
            base_freq_hz=1_200.0,
            preamble_symbols=24,
        ),
        "16-FSK at 1500 baud (6 kbps); for clean, wideband channels.",
    )
)

register(
    ModemModel(
        "mfsk4-coded",
        ModemConfig(
            sample_rate_hz=48_000,
            symbol_rate_hz=1_500,
            num_tones=4,
            base_freq_hz=3_000.0,
            preamble_symbols=32,
            fec="conv",
            fec_interleave=24,
        ),
        "4-FSK with rate-1/2 K=7 convolutional coding (soft Viterbi) and a "
        "depth-24 block interleaver; 1.5 kbps net, ~4 dB coding gain at the "
        "frame-error cliff plus burst-error immunity.",
    )
)

register(
    ModemModel(
        "mfsk4-coded-stream",
        ModemConfig(
            sample_rate_hz=48_000,
            symbol_rate_hz=1_500,
            num_tones=4,
            base_freq_hz=3_000.0,
            preamble_symbols=32,
            fec="conv",
            fec_interleave=1,
        ),
        "mfsk4-coded without the block interleaver: the robust rung for "
        "VARIABLE-LENGTH streaming — a depth-d interleaver's geometry "
        "depends on the section length the header declares, so dynamic "
        "coded frames (stream.receive_stream_dynamic, fec='conv') need "
        "interleave-free framing; same AWGN coding gain, no burst "
        "dispersion.",
    )
)

register(
    ModemModel(
        "mfsk32-dense",
        ModemConfig(
            symbol_rate_hz=600,
            num_tones=32,
            base_freq_hz=2_400.0,
            preamble_symbols=24,
        ),
        "32-FSK, 3 kbps in 600 baud; dense tone packing trades SNR margin "
        "for spectral efficiency.",
    )
)


register(
    ModemModel(
        "ofdm-fast",
        OfdmConfig(),
        "96-carrier QPSK OFDM at 48 kHz: 28.8 kbps in 3.0-20.8 kHz with a "
        "1.3 ms cyclic prefix; per-carrier equalization absorbs room echo.",
    )
)

register(
    ModemModel(
        "ofdm-coded",
        OfdmConfig(fec="conv", fec_interleave=32),
        "Coded OFDM (rate-1/2 K=7 soft Viterbi + depth-32 interleaver): "
        "14.4 kbps net, rides out deep carrier fades and bursts.",
    )
)


register(
    ModemModel(
        "ofdm-max",
        OfdmConfig(bits_per_carrier=6, fec="conv", fec_interleave=32),
        "64-QAM coded OFDM: 86.4 kbps on the air, 43.2 kbps net with soft "
        "Viterbi + interleaving; the highest-rate preset (~18 dB), headroom "
        "for two simultaneous high-quality Opus streams.",
    )
)


register(
    ModemModel(
        "ofdm-turbo",
        OfdmConfig(bits_per_carrier=4, fec="conv", fec_interleave=32),
        "16-QAM coded OFDM: 57.6 kbps on the air, 28.8 kbps net with soft "
        "Viterbi + interleaving (~10 dB); enough for a real-time 24 kbps "
        "Opus stream over sound.",
    )
)


class Classification(NamedTuple):
    """One candidate's score from classify_capture."""

    name: str
    quality: float  # normalized preamble-match quality in [0, 1]
    offset: int  # sample index of the best preamble match
    header_ok: bool | None  # tie-break verdict; None = not attempted


def classify_capture(samples, candidates=None, payload_len=None, device="cuda") -> List[Classification]:
    """Identify which modem preset a capture [N] (one stream) carries, on
    ``device``.

    Every preset transmits a preset-specific preamble, so classification is
    one matched filter a candidate (sync.correlate_template with
    ``method="auto"``: the block-Toeplitz product on the card, the FFT on
    the CPU), ranked by Cauchy-Schwarz-normalized quality. The OFDM presets
    share one preamble, so the tied leaders (quality within 0.05 of the
    best) are told apart by demodulating the frame at the detected offset
    and checking its header gate (magic word + header CRC): with
    ``payload_len`` every candidate can be checked, without it only the
    uncoded ones (their length is read from the header). Among the tied
    leaders a verified header outranks raw quality.

    ``candidates``: model names to consider (default: every registered
    preset whose preamble fits in the capture). Returns the
    Classifications best first; verdicts are filled for the tied leaders
    only."""
    from anet_torch.dsp import family
    from anet_torch.dsp.sync import correlate_template, normalized_match_quality, sliding_window_energy

    x = as_tensor(samples, device).float()
    names = candidates or [m.name for m in list_models()]
    scored = []
    for name in names:
        cfg = get_model(name).config
        tmpl = family.preamble_template(cfg, x.device)
        k = int(tmpl.shape[-1])
        if x.shape[-1] <= k:
            continue
        corr = correlate_template(x, tmpl, method="auto")
        q = normalized_match_quality(corr, sliding_window_energy(x, k), (tmpl * tmpl).sum())
        off = int(torch.argmax(q))
        scored.append((name, float(q[off]), off))
    scored.sort(key=lambda t: -t[1])
    if not scored:
        return []
    best_q = scored[0][1]
    leaders = [t for t in scored if best_q - t[1] <= 0.05]
    verdicts = {name: _validate_header(name, x, off, payload_len) for name, _, off in leaders}
    leaders.sort(key=lambda t: (verdicts[t[0]] is not True, -t[1]))
    rest = [t for t in scored if best_q - t[1] > 0.05]
    return [Classification(name, q, off, verdicts.get(name)) for name, q, off in leaders + rest]


def _validate_header(name, x: torch.Tensor, offset: int, payload_len):
    """True/False if a demodulation at ``offset`` of the capture ``x`` [N]
    could check the header gate, None if this candidate cannot be checked
    (a coded one without a payload length, a frame running past the
    capture, or a geometry its receiver refuses with ValueError)."""
    from anet_torch.dsp import family

    cfg = get_model(name).config
    n = int(x.shape[-1])
    try:
        if payload_len is not None:
            t = family.frame_samples(cfg, payload_len)
            if offset + t > n:
                return None
            frame = family.aligned_demod_fn(cfg, payload_len, device=x.device)(x[None, offset : offset + t])
        else:
            if getattr(cfg, "fec", "none") != "none":
                return None  # coded headers need the payload length
            max_len = 64
            t = family.frame_samples(cfg, max_len)
            if offset + t > n:
                return None
            frame = family.aligned_demod_dynamic_fn(cfg, max_len, device=x.device)(x[None, offset : offset + t])
    except ValueError:
        return None
    return bool(frame.magic_ok[0]) and bool(frame.header_crc_ok[0])
