"""PHY framing: payload bytes <-> modulated frame waveform (mirrors the
fixed-length part of ``anet.dsp.frame``, uncoded and coded).

Frame layout (all multi-byte fields big-endian):

    [ preamble: config.preamble_symbols PN tones ]
    [ magic word        4 B ]  0x2C5DA044 — same magic as the wire protocol
    [ payload length    2 B ]  uint16, <= MAX_ENCODED_FRAME_SIZE (4096)
    [ header CRC        2 B ]  low 16 bits of CRC-32 over the 6 bytes above
    [ payload           N B ]
    [ payload CRC       4 B ]  CRC-32 over the payload

With ``config.fec == "conv"`` the data section is convolutionally encoded
and block-interleaved before it goes on the air (anet_torch.dsp.fec); the
receiver deinterleaves per-bit LLRs and runs the soft Viterbi decoder. The
(coded) data section is Gray-mapped onto MFSK symbols, zero-bit padded up
to a whole symbol. Unsigned 32-bit fields are held in int64 tensors
(torch's uint32 support is partial).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from anet_torch import constants
from anet_torch._device import as_tensor
from anet_torch.dsp.bits import (
    bits_to_bytes,
    bytes_to_bits,
    gray_decode,
    pack_symbols,
    unpack_symbols,
)
from anet_torch.dsp.demod import (
    bit_llrs,
    decide_symbols,
    demod_basis,
    estimate_snr_db,
    tone_energies,
)
from anet_torch.dsp.fec import crc32_device, crc32_host, parity_to_u32
from anet_torch.dsp.mod import modulate_symbols, synthesize_tones
from anet_torch.dsp.params import ModemConfig
from anet_torch.dsp.sync import preamble_tone_indices

HEADER_BYTES = 8
TRAILER_BYTES = 4
OVERHEAD_BYTES = HEADER_BYTES + TRAILER_BYTES


def data_section_bytes(payload_len: int) -> int:
    return OVERHEAD_BYTES + payload_len


def data_section_coded_bits(config: ModemConfig, payload_len: int) -> int:
    """Bits on the air for the data section (after optional FEC)."""
    return config.coded_bits_for_data_bits(8 * data_section_bytes(payload_len))


def data_symbols_for_payload(config: ModemConfig, payload_len: int) -> int:
    return config.symbols_for_bits(data_section_coded_bits(config, payload_len))


def frame_num_symbols(config: ModemConfig, payload_len: int) -> int:
    """Total symbols including preamble."""
    return config.preamble_symbols + data_symbols_for_payload(config, payload_len)


def frame_num_samples(config: ModemConfig, payload_len: int) -> int:
    return frame_num_symbols(config, payload_len) * config.samples_per_symbol


def _header_np(payload_len: int) -> np.ndarray:
    """The 8 header bytes — static given payload_len, so built host-side."""
    if not 0 <= payload_len <= constants.MAX_ENCODED_FRAME_SIZE:
        raise ValueError(
            f"payload_len {payload_len} outside [0, {constants.MAX_ENCODED_FRAME_SIZE}]"
        )
    head = constants.MAGIC_WORD.to_bytes(4, "big") + payload_len.to_bytes(2, "big")
    hcrc = crc32_host(head) & 0xFFFF
    return np.frombuffer(head + hcrc.to_bytes(2, "big"), dtype=np.uint8).copy()


def _u32_to_be_bytes(value: torch.Tensor) -> torch.Tensor:
    """int64[...] holding uint32 values -> uint8[..., 4] big-endian."""
    shifts = torch.tensor([24, 16, 8, 0], dtype=torch.int64, device=value.device)
    return ((value[..., None] >> shifts) & 0xFF).to(torch.uint8)


def _be_bytes_to_u32(data: torch.Tensor) -> torch.Tensor:
    """uint8[..., 4] -> int64[...] in [0, 2^32)."""
    shifts = torch.tensor([24, 16, 8, 0], dtype=torch.int64, device=data.device)
    return (data.to(torch.int64) << shifts).sum(-1)


def _be16(data: torch.Tensor) -> torch.Tensor:
    """uint8[..., 2] -> int64[...] big-endian."""
    return (data[..., 0].to(torch.int64) << 8) | data[..., 1].to(torch.int64)


def _parse_header(header: torch.Tensor):
    """The 8 header bytes -> (magic, declared length, header_crc_ok)."""
    magic = _be_bytes_to_u32(header[..., :4])
    length = _be16(header[..., 4:6])
    hcrc_calc = crc32_device(header[..., :6]) & 0xFFFF
    return magic, length, hcrc_calc == _be16(header[..., 6:8])


def data_section_air_bits_array(config, payload: torch.Tensor) -> torch.Tensor:
    """payload uint8[..., N] -> on-air data-section bits uint8[..., bits]:
    header + payload + CRC-32, MSB-first, then the config's FEC and
    interleaver."""
    n = payload.shape[-1]
    header = torch.as_tensor(_header_np(n), device=payload.device).expand(
        *payload.shape[:-1], HEADER_BYTES
    )
    crc = crc32_device(payload)
    section = torch.cat([header, payload.to(torch.uint8), _u32_to_be_bytes(crc)], dim=-1)
    bits = bytes_to_bits(section)
    if config.fec == "conv":
        from anet_torch.dsp.fec import conv_encode, interleave

        bits = interleave(conv_encode(bits), config.fec_interleave)
    return bits


def frame_data_symbols(config: ModemConfig, payload: torch.Tensor) -> torch.Tensor:
    """payload uint8[..., N] -> data-section symbols int32[..., S_data]."""
    bits = data_section_air_bits_array(config, payload)
    pad = (-bits.shape[-1]) % config.bits_per_symbol
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    return pack_symbols(bits, config.bits_per_symbol)


def modulate_frame(
    config: ModemConfig, payload, dtype=torch.float32, device="cuda"
) -> torch.Tensor:
    """payload uint8[..., N] -> frame waveform float[..., frame_num_samples],
    on ``device``."""
    payload = as_tensor(payload, device, torch.uint8)
    data_syms = frame_data_symbols(config, payload)
    pre = preamble_tone_indices(config, payload.device).expand(
        *payload.shape[:-1], config.preamble_symbols
    )
    preamble_wave = synthesize_tones(config, pre, dtype=dtype)
    data_wave = modulate_symbols(config, data_syms, dtype=dtype)
    return torch.cat([preamble_wave, data_wave], dim=-1)


class FrameResult(NamedTuple):
    """Demodulated frame + integrity verdicts (all batched alike)."""

    payload: torch.Tensor  # uint8[..., N]
    magic_ok: torch.Tensor  # bool[...]
    length_ok: torch.Tensor  # bool[...]
    header_crc_ok: torch.Tensor  # bool[...]
    payload_crc_ok: torch.Tensor  # bool[...]
    ok: torch.Tensor  # bool[...]
    confidence: torch.Tensor  # float32[...] mean winning-tone energy ratio
    snr_db: torch.Tensor  # float32[...] filterbank SNR estimate


def _snr_db(sig: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    return 10.0 * torch.log10((sig / noise.clamp_min(1e-20) - 1.0).clamp_min(1e-6))


def demodulate_frame(
    config: ModemConfig,
    samples,
    payload_len: int,
    *,
    compute_dtype=torch.float32,
    device="cuda",
) -> FrameResult:
    """Symbol-aligned batch-major frame waveform [..., T] -> payload +
    verdicts, through the plain filterbank. ``samples`` must start exactly
    at the frame start and hold frame_num_samples(config, payload_len)."""
    samples = as_tensor(samples, device)
    data = samples[..., config.preamble_symbols * config.samples_per_symbol :]
    energies = tone_energies(config, data, compute_dtype=compute_dtype)
    symbols = decide_symbols(config, energies)
    return frame_result_from_decisions(config, symbols, energies, payload_len)


def demodulate_frame_tm(
    config: ModemConfig,
    samples_tm,
    payload_len: int,
    *,
    compute_dtype=torch.bfloat16,
    device="cuda",
) -> FrameResult:
    """demodulate_frame for TIME-MAJOR whole frames [T, B] (the stream batch
    in the minor dimension): the aligned receiver.

    When the window holds exactly the frame's symbols and bits_per_symbol is
    1, 2 or 4 (whole bytes per 8-symbol word), the full-fusion kernel
    (anet_torch.kernels.decide_frame_tm) reads the data rows in place at the
    preamble offset (no copy of the data section), decides, packs and
    checksums; only KB-scale tensors reach frame_result_from_packed. Other
    uncoded windows take the plain filterbank on the CPU; on the card they
    need the decisions-only kernel (decide_tones_tm), which is still to be
    ported.

    Coded configs (fec='conv') need every tone's energy for the soft
    decisions: they take the [2M, sps] x [S, sps, B] filterbank product
    (operands in ``compute_dtype``, float32 accumulation and result), keep
    the energies time-major [S, M, B] and transpose them once for the LLRs.
    """
    from anet_torch.kernels import decide_frame_tm

    samples_tm = as_tensor(samples_tm, device)
    sps = config.samples_per_symbol
    m = config.num_tones
    pre = config.preamble_symbols * sps
    s = (samples_tm.shape[0] - pre) // sps
    if (
        config.fec != "conv"
        and config.bits_per_symbol in (1, 2, 4)
        and m <= 16
        and s == data_symbols_for_payload(config, payload_len)
    ):
        words, crc_counts, qual, n_sym = decide_frame_tm(
            config, samples_tm.to(compute_dtype), payload_len, preamble_offset=pre
        )
        return frame_result_from_packed(config, words, crc_counts, qual, n_sym, payload_len)
    if samples_tm.is_cuda and config.fec != "conv":
        raise NotImplementedError(
            "this window needs decide_tones_tm, not yet ported (ROADMAP queue 2)"
        )
    b = samples_tm.shape[1]
    w = samples_tm[pre : pre + s * sps].reshape(s, sps, b).to(compute_dtype)
    basis_t = demod_basis(config, dtype=compute_dtype, device=samples_tm.device).T  # [2M, sps]
    e = _filterbank_energies_tm(basis_t, w, m)  # [S, M, B]
    tone = torch.argmax(e, dim=1).to(torch.int32)  # [S, B]
    best, total = e.amax(1), e.sum(1)
    llrs = bit_llrs(config, e.permute(2, 0, 1)) if config.fec == "conv" else None
    # quality reduces over the symbol (major) axis while still time-major;
    # only [B] vectors and the [S, B] decisions transpose
    confidence = (best / total.clamp_min(1e-20)).mean(0)
    snr_db = _snr_db(best.mean(0), ((total - best) / (m - 1)).mean(0))
    symbols = gray_decode(tone.T, config.bits_per_symbol)  # [B, S]
    bits = unpack_symbols(symbols, config.bits_per_symbol)
    return frame_result_from_bits(
        config, bits, payload_len, llrs=llrs, confidence=confidence, snr_db=snr_db
    )


def _filterbank_energies_tm(basis_t: torch.Tensor, w: torch.Tensor, m: int) -> torch.Tensor:
    """basis_t [2M, sps] x w [S, sps, B] -> energies float32 [S, M, B].
    The product accumulates in float32 and returns float32 whatever the
    operands' dtype: on the card a low-precision product asks for a float32
    result (the operands stay in their dtype); on the CPU the operands are
    widened first, which gives the same products."""
    if w.is_cuda and w.dtype != torch.float32:
        iq = torch.bmm(basis_t.expand(w.shape[0], -1, -1), w, out_dtype=torch.float32)
    else:
        iq = torch.einsum("mk,skb->smb", basis_t.float(), w.float())
    return iq[:, :m] ** 2 + iq[:, m:] ** 2


def frame_result_from_tone_decisions(
    config: ModemConfig,
    tone: torch.Tensor,
    best: torch.Tensor,
    total: torch.Tensor,
    payload_len: int,
) -> FrameResult:
    """Parse + verify from reduced decisions: winning tone index plus
    best/total energies, all [..., S] batch-major — the contract of the
    demod kernels (demod_at_fused / demod_probe_fused). Uncoded only: the
    FEC's soft decisions need every tone's energy."""
    if config.fec == "conv":
        raise ValueError("coded configs need full energies (use frame_result_from_decisions)")
    m = config.num_tones
    confidence = (best / total.clamp_min(1e-20)).mean(-1)
    rest = (total - best) / (m - 1)
    snr_db = _snr_db(best.mean(-1), rest.mean(-1))
    symbols = gray_decode(tone.to(torch.int32), config.bits_per_symbol)
    bits = unpack_symbols(symbols, config.bits_per_symbol)
    return frame_result_from_bits(config, bits, payload_len, confidence=confidence, snr_db=snr_db)


def frame_result_from_packed(
    config: ModemConfig,
    words: torch.Tensor,
    crc_counts: torch.Tensor,
    qual: torch.Tensor,
    n_symbols: int,
    payload_len: int,
) -> FrameResult:
    """Parse + verify from decide_frame_tm's outputs: packed decision words
    [n_tiles, B] (TM_SYMBOL_TILE Gray-decoded symbols per int32, MSB-first),
    f32 CRC bit counts [64, B] (header in rows 0..31, payload in 32..63;
    parity taken here) and quality sums [8, B] (conf/best/total in rows
    0..2). Words are widened to int64 and masked, so a negative int32 word
    still yields its four bytes."""
    from anet_torch.kernels import TM_SYMBOL_TILE, _frame_crc_tables

    m = config.num_tones
    bps = config.bits_per_symbol
    nb = TM_SYMBOL_TILE * bps  # bits per word; whole bytes (bps in {1, 2, 4})
    n_bytes = data_section_bytes(payload_len)
    w = words.T.to(torch.int64) & 0xFFFFFFFF  # [B, n_tiles]
    bpw = nb // 8
    shifts = torch.arange(bpw - 1, -1, -1, dtype=torch.int64, device=w.device) * 8
    by = ((w[..., None] >> shifts) & 0xFF).to(torch.uint8)
    section = by.reshape(*w.shape[:-1], w.shape[-1] * bpw)[..., :n_bytes]

    magic_ok = _be_bytes_to_u32(section[..., :4]) == constants.MAGIC_WORD
    length_ok = _be16(section[..., 4:6]) == payload_len
    _, c_hdr, c_pay = _frame_crc_tables(payload_len, words.shape[0], nb)
    counts = crc_counts.T  # [B, 64]
    hdr_raw = parity_to_u32(counts[..., :32]) ^ c_hdr
    pay_raw = parity_to_u32(counts[..., 32:]) ^ c_pay
    header_crc_ok = (hdr_raw & 0xFFFF) == _be16(section[..., 6:8])
    payload_crc_ok = pay_raw == _be_bytes_to_u32(section[..., HEADER_BYTES + payload_len :])

    qt = qual.T  # [B, 8]
    confidence = qt[..., 0] / n_symbols
    sig = qt[..., 1] / n_symbols
    noise = (qt[..., 2] - qt[..., 1]) / n_symbols / (m - 1)
    ok = magic_ok & length_ok & header_crc_ok & payload_crc_ok
    return FrameResult(
        payload=section[..., HEADER_BYTES : HEADER_BYTES + payload_len],
        magic_ok=magic_ok,
        length_ok=length_ok,
        header_crc_ok=header_crc_ok,
        payload_crc_ok=payload_crc_ok,
        ok=ok,
        confidence=confidence,
        snr_db=_snr_db(sig, noise),
    )


def frame_result_from_decisions(
    config: ModemConfig,
    symbols: torch.Tensor,
    energies: torch.Tensor,
    payload_len: int,
) -> FrameResult:
    """Parse + verify the data section from decided symbols and their
    filterbank energies [..., S, M]; the FEC's soft decisions come from the
    energies."""
    bits = unpack_symbols(symbols, config.bits_per_symbol)
    llrs = bit_llrs(config, energies) if config.fec == "conv" else None
    best = energies.amax(-1)
    total = energies.sum(-1)
    confidence = (best / total.clamp_min(1e-20)).mean(-1)
    snr_db = estimate_snr_db(config, energies)
    return frame_result_from_bits(
        config, bits, payload_len, llrs=llrs, confidence=confidence, snr_db=snr_db
    )


def frame_result_from_bits(
    config,
    bits: torch.Tensor,
    payload_len: int,
    *,
    llrs: torch.Tensor | None = None,
    confidence: torch.Tensor,
    snr_db: torch.Tensor,
) -> FrameResult:
    """Frame parse: demodulated bits (and, for soft FEC, per-bit LLRs) ->
    payload + verdicts. A coded config deinterleaves the soft values and
    runs the Viterbi decoder; without LLRs the hard bits stand in as +-1."""
    n_bytes = data_section_bytes(payload_len)
    if config.fec == "conv":
        from anet_torch.dsp.fec import conv_encoded_bits, deinterleave, viterbi_decode_soft

        soft = llrs if llrs is not None else bits.to(torch.float32) * 2.0 - 1.0
        air = soft[..., : data_section_coded_bits(config, payload_len)]
        coded = deinterleave(air, config.fec_interleave, conv_encoded_bits(8 * n_bytes))
        bits = viterbi_decode_soft(coded, 8 * n_bytes)
    section = bits_to_bytes(bits[..., : n_bytes * 8])
    payload = section[..., HEADER_BYTES : HEADER_BYTES + payload_len]
    trailer = section[..., HEADER_BYTES + payload_len :]
    magic, length, header_crc_ok = _parse_header(section[..., :HEADER_BYTES])
    magic_ok = magic == constants.MAGIC_WORD
    length_ok = length == payload_len
    payload_crc_ok = crc32_device(payload) == _be_bytes_to_u32(trailer)
    ok = magic_ok & length_ok & header_crc_ok & payload_crc_ok
    return FrameResult(
        payload=payload,
        magic_ok=magic_ok,
        length_ok=length_ok,
        header_crc_ok=header_crc_ok,
        payload_crc_ok=payload_crc_ok,
        ok=ok,
        confidence=confidence,
        snr_db=snr_db,
    )
