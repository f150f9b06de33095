"""Modem configuration.

A copy of ``anet/dsp/params.py``: a frozen, hashable dataclass from which
all shapes and trig constants derive. ``from_json`` reads the JAX package's
``to_json`` output unchanged, so both packages share one geometry.

The tone plan uses orthogonal MFSK: tone spacing is an integer multiple of
the symbol rate, so each tone completes an integer number of cycles per
symbol window and the demod filterbank columns are exactly orthogonal over
one symbol. This is the well-conditioned regime SURVEY.md §7.3 asks for
("keep decision/threshold logic in well-conditioned forms").
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModemConfig:
    """Static modem parameters.

    Attributes:
      sample_rate_hz: DAC/ADC rate. The reference's envelope is 8/12/16/24/48
        kHz (OpusEncoder.kt:195); 48 kHz is the receiver's fixed decode rate.
      symbol_rate_hz: symbols per second; must divide sample_rate_hz.
      num_tones: MFSK order M (power of two; 2 = binary FSK).
      base_freq_hz: frequency of tone 0.
      tone_spacing_multiple: tone spacing as a multiple of symbol_rate_hz
        (1 = minimum orthogonal spacing).
      preamble_symbols: length of the alternating sync preamble, in symbols.
      amplitude: peak amplitude of the synthesized waveform.
      phase_continuous: if True, synthesis keeps phase continuous across
        symbol boundaries (CPFSK, lower spectral splatter); if False each
        symbol starts at phase 0 (exactly matches the demod basis).
    """

    sample_rate_hz: int = 48_000
    symbol_rate_hz: int = 750
    num_tones: int = 16
    base_freq_hz: float = 3_000.0
    tone_spacing_multiple: int = 1
    preamble_symbols: int = 32
    amplitude: float = 0.8
    phase_continuous: bool = False
    # Forward error correction for the frame data section:
    #   "none" — raw Gray-coded MFSK (the default; integrity via CRC only)
    #   "conv" — rate-1/2 K=7 convolutional code with Viterbi decoding
    #            (~5 dB coding gain, half the net bit rate)
    fec: str = "none"
    # Block-interleaver depth for coded frames (0/1 = off). Spreads channel
    # bursts into isolated errors the convolutional decoder can fix.
    fec_interleave: int = 0

    def __post_init__(self) -> None:
        if self.fec not in ("none", "conv"):
            raise ValueError(f"fec must be 'none' or 'conv', got {self.fec!r}")
        if self.fec_interleave < 0:
            raise ValueError("fec_interleave must be >= 0")
        if self.sample_rate_hz % self.symbol_rate_hz != 0:
            raise ValueError(
                f"symbol_rate_hz={self.symbol_rate_hz} must divide "
                f"sample_rate_hz={self.sample_rate_hz}"
            )
        if self.num_tones < 2 or self.num_tones & (self.num_tones - 1):
            raise ValueError(f"num_tones must be a power of two >= 2, got {self.num_tones}")
        if self.preamble_symbols < 2:
            raise ValueError("preamble_symbols must be >= 2")
        nyquist = self.sample_rate_hz / 2
        if self.max_tone_freq_hz >= nyquist:
            raise ValueError(
                f"top tone {self.max_tone_freq_hz} Hz >= Nyquist {nyquist} Hz"
            )

    # --- derived geometry ----------------------------------------------------

    @property
    def samples_per_symbol(self) -> int:
        return self.sample_rate_hz // self.symbol_rate_hz

    @property
    def bits_per_symbol(self) -> int:
        return self.num_tones.bit_length() - 1

    @property
    def tone_spacing_hz(self) -> float:
        return float(self.tone_spacing_multiple * self.symbol_rate_hz)

    @property
    def tone_freqs_hz(self) -> Tuple[float, ...]:
        return tuple(
            self.base_freq_hz + k * self.tone_spacing_hz for k in range(self.num_tones)
        )

    @property
    def max_tone_freq_hz(self) -> float:
        return self.base_freq_hz + (self.num_tones - 1) * self.tone_spacing_hz

    @property
    def bit_rate_bps(self) -> float:
        """Channel (coded) bit rate; halve for net rate under fec='conv'."""
        return self.symbol_rate_hz * self.bits_per_symbol

    def coded_bits_for_data_bits(self, n_bits: int) -> int:
        """Bits on the air (after coding + interleaver padding)."""
        if self.fec == "conv":
            from anet_torch.dsp.fec import conv_encoded_bits, interleaved_bits

            return interleaved_bits(
                conv_encoded_bits(n_bits), self.fec_interleave
            )
        return n_bits

    @property
    def preamble_samples(self) -> int:
        return self.preamble_symbols * self.samples_per_symbol

    def symbols_for_bits(self, num_bits: int) -> int:
        return -(-num_bits // self.bits_per_symbol)

    def symbols_for_bytes(self, num_bytes: int) -> int:
        return self.symbols_for_bits(8 * num_bytes)

    # --- config round-trip (the wifi.json analog, SURVEY.md §5 config) -------

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "ModemConfig":
        return cls(**json.loads(text))


# Sanity: the defaults describe a real, reasonably fast audio-band modem.
assert math.log2(ModemConfig().num_tones) == 4
