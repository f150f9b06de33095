"""Modem model presets: named, tuned configurations of the signal chain.

The registry, presets and operating thresholds of ``anet/models/__init__.py``,
copied so that ``anet_torch`` imports nothing of ``anet`` (its compute
helpers, the capture classifier and ``suggest_model``, are not ported yet).

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
