"""Signal chain of the port: bits, CRC, modulation, sync, demodulation,
framing, and the OFDM family (mirrors ``anet.dsp``, whose public names it
exports in the same order)."""

from anet_torch.dsp.params import ModemConfig
from anet_torch.dsp.bits import (
    bits_to_bytes,
    bytes_to_bits,
    gray_decode,
    gray_encode,
    pack_symbols,
    unpack_symbols,
)
from anet_torch.dsp.mod import modulate_symbols, synthesize_tones
from anet_torch.dsp.demod import decide_symbols, demodulate_symbols, tone_energies
from anet_torch.dsp.sync import locate_preamble, preamble_waveform
from anet_torch.dsp.frame import (
    FrameResult,
    frame_num_symbols,
    modulate_frame,
    demodulate_frame,
)
from anet_torch.dsp import family, ofdm
from anet_torch.dsp.clock import demodulate_symbols_tracked, estimate_drift_ppm
from anet_torch.dsp.fec import (
    conv_encode,
    crc32_device,
    interleave,
    viterbi_decode,
    viterbi_decode_soft,
)
from anet_torch.dsp.pipeline import (
    loopback,
    receive_frame,
    receive_frame_tracked,
    transmit,
)

__all__ = [
    "ModemConfig",
    "bits_to_bytes",
    "bytes_to_bits",
    "gray_decode",
    "gray_encode",
    "pack_symbols",
    "unpack_symbols",
    "modulate_symbols",
    "synthesize_tones",
    "decide_symbols",
    "demodulate_symbols",
    "tone_energies",
    "locate_preamble",
    "preamble_waveform",
    "FrameResult",
    "frame_num_symbols",
    "modulate_frame",
    "demodulate_frame",
    "family",
    "ofdm",
    "demodulate_symbols_tracked",
    "estimate_drift_ppm",
    "conv_encode",
    "crc32_device",
    "interleave",
    "viterbi_decode",
    "viterbi_decode_soft",
    "loopback",
    "receive_frame",
    "receive_frame_tracked",
    "transmit",
]
