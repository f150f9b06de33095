"""Modem model presets: named, tuned configurations of the signal chain.

The MFSK part of ``anet/models/__init__.py`` (registry and presets), copied
so that ``anet_torch`` imports nothing of ``anet``. The OFDM presets
(``ofdm-fast``, ``ofdm-coded``, ``ofdm-turbo``, ``ofdm-max``) arrive with the
OFDM slice of the port.

- ``fsk2-robust``   — binary FSK, low rate, maximum noise margin.
- ``mfsk4-voice``   — 4-FSK in the voice band (300-3400 Hz).
- ``mfsk8-audible`` — 8-FSK mid-band, balanced rate/robustness.
- ``mfsk16-fast``   — the flagship: 16-FSK, 3 kbps, full audio band.
- ``mfsk16-ultra``  — 16-FSK at 1500 baud (6 kbps).
- ``mfsk4-coded`` / ``mfsk4-coded-stream`` — 4-FSK with K=7 convolutional
  coding; the second has no interleaver, so its frames can declare their
  own length (variable-length streaming).
- ``mfsk32-dense``  — 32-FSK wideband, highest rate, needs high SNR.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

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
