"""PHY framing: payload bytes <-> modulated frame waveform (mirrors
``anet.dsp.frame``: fixed and variable frame length, uncoded and coded).

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


def data_section_coded_bits(config, payload_len: int) -> int:
    """Bits on the air for the data section (after optional FEC), for
    either family."""
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
    interleaver (either family: only ``fec`` and ``fec_interleave`` are
    read)."""
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
    use_pallas: bool | None = None,
    device="cuda",
) -> FrameResult:
    """Symbol-aligned batch-major frame waveform [..., T] -> payload +
    verdicts. ``samples`` must start exactly at the frame start and hold
    frame_num_samples(config, payload_len).

    ``use_pallas`` picks the filterbank. None (the default) and True take
    the kernel anet_torch.kernels.tone_energies_fused (the reference's
    ``use_pallas=True``), which reads the data section in place past the
    preamble; on the CPU its plain version. False takes the reference's
    other route, the plain product demod.tone_energies, by the caller's
    choice."""
    from anet_torch.kernels import tone_energies_fused

    samples = as_tensor(samples, device)
    data = samples[..., config.preamble_symbols * config.samples_per_symbol :]
    if use_pallas is False:
        energies = tone_energies(config, data, compute_dtype=compute_dtype)
    else:
        energies = tone_energies_fused(config, data, compute_dtype=compute_dtype)
    symbols = decide_symbols(config, energies)
    return frame_result_from_decisions(config, symbols, energies, payload_len)


def demodulate_frame_tm(
    config: ModemConfig,
    samples_tm,
    payload_len: int,
    *,
    compute_dtype=torch.bfloat16,
    use_pallas: bool | None = None,
    device="cuda",
) -> FrameResult:
    """demodulate_frame for TIME-MAJOR whole frames [T, B] (the stream batch
    in the minor dimension): the aligned receiver.

    When the window holds exactly the frame's symbols and bits_per_symbol is
    1, 2 or 4 (whole bytes per 8-symbol word), the full-fusion kernel
    (anet_torch.kernels.decide_frame_tm) reads the data rows in place at the
    preamble offset (no copy of the data section), decides, packs and
    checksums; only KB-scale tensors reach frame_result_from_packed. Other
    uncoded windows (an oversized window, 3 or 5 bits a symbol) take the
    decisions-only kernel (anet_torch.kernels.decide_tones_tm), which decides
    every symbol present, so confidence and snr_db then average over the
    whole window and not over the frame's own symbols alone.

    Coded configs (fec='conv') need every tone's energy for the soft
    decisions: they take the [2M, sps] x [S, sps, B] filterbank product
    (operands in ``compute_dtype``, float32 accumulation and result), keep
    the energies time-major [S, M, B] and transpose them once for the LLRs.

    ``use_pallas`` None (the default) or True takes the kernels above;
    False takes that plain product for every config, by the caller's choice
    (the reference's route off its TPU).

    ``compute_dtype=torch.int8`` is the quantized-ingest path: an int8
    capture (quantized once at the edge, e.g. round(x * 127 / max|x|)) goes
    to the int8 instantiation of decide_frame_tm with the x127 integer
    basis; energies carry a uniform scale, so decisions, verdicts and the
    confidence and SNR ratios are those of the float path. It takes exactly
    one frame of an uncoded config with bits_per_symbol in {1, 2, 4} and at
    most 16 tones, and raises ValueError otherwise, as the reference does
    (its decisions-only fallback for an oversized window would meet an int8
    basis truncated to zero, so this raises there too).
    """
    from anet_torch.kernels import decide_frame_tm, decide_tones_tm

    samples_tm = as_tensor(samples_tm, device)
    sps = config.samples_per_symbol
    m = config.num_tones
    pre = config.preamble_symbols * sps
    s = (samples_tm.shape[0] - pre) // sps
    exact = s == data_symbols_for_payload(config, payload_len)
    kernel = use_pallas is not False
    if compute_dtype == torch.int8:
        if (config.fec == "conv" or not kernel or config.bits_per_symbol not in (1, 2, 4) or m > 16
                or not exact):
            raise ValueError(
                "int8 compute is the full-fusion kernel's quantized-ingest path only "
                "(uncoded, bps in {1,2,4}, <=16 tones, one whole frame, use_pallas not False)"
            )
        if samples_tm.dtype != torch.int8:
            raise ValueError(
                f"int8 compute takes an int8 capture, got {samples_tm.dtype}: quantize it "
                "once at the edge (a cast would truncate the waveform to zero)"
            )
    if kernel and config.fec != "conv" and config.bits_per_symbol in (1, 2, 4) and m <= 16 and exact:
        words, crc_counts, qual, n_sym = decide_frame_tm(
            config, samples_tm.to(compute_dtype), payload_len, preamble_offset=pre
        )
        return frame_result_from_packed(config, words, crc_counts, qual, n_sym, payload_len)
    b = samples_tm.shape[1]
    llrs = None
    if config.fec == "conv" or not kernel:
        w = samples_tm[pre : pre + s * sps].reshape(s, sps, b).to(compute_dtype)
        basis_t = demod_basis(config, dtype=compute_dtype, device=samples_tm.device).T  # [2M, sps]
        e = _filterbank_energies_tm(basis_t, w, m)  # [S, M, B]
        tone = torch.argmax(e, dim=1).to(torch.int32)  # [S, B]
        best, total = e.amax(1), e.sum(1)
        if config.fec == "conv":
            llrs = bit_llrs(config, e.permute(2, 0, 1))
    else:
        tone, best, total = decide_tones_tm(config, samples_tm[pre:].to(compute_dtype))
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
    payload + verdicts, for either family (a ModemConfig or an OfdmConfig;
    only ``fec``, ``fec_interleave`` and ``coded_bits_for_data_bits`` are
    read). A coded config deinterleaves the soft values and runs the Viterbi
    decoder; without LLRs the hard bits stand in as +-1."""
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


# --- variable-length frames: the payload length comes from the header --------


class DynamicFrameResult(NamedTuple):
    """Demodulated frame whose payload length came from the header. Shapes
    are static at the configured maximum; ``payload`` is zero-padded past
    ``payload_len``."""

    payload: torch.Tensor  # uint8[..., max_payload_len], zero-padded
    payload_len: torch.Tensor  # int32[...] header-declared length (clipped)
    magic_ok: torch.Tensor  # bool[...]
    length_ok: torch.Tensor  # bool[...] declared length <= configured max
    header_crc_ok: torch.Tensor  # bool[...]
    payload_crc_ok: torch.Tensor  # bool[...]
    ok: torch.Tensor  # bool[...]
    confidence: torch.Tensor  # float32[...]
    snr_db: torch.Tensor  # float32[...]


def frame_result_from_bits_dynamic(
    config,
    bits: torch.Tensor,
    max_payload_len: int,
    *,
    confidence: torch.Tensor,
    snr_db: torch.Tensor,
) -> DynamicFrameResult:
    """Variable-length frame parse of uncoded (hard-decision) bits, for
    either family: the payload length is read from the demodulated header
    of a max-length window. Coded configs decode through
    frame_result_from_llrs_dynamic."""
    if config.fec != "none":
        raise ValueError(
            "hard-bit dynamic parse requires fec='none'; coded configs "
            "decode through frame_result_from_llrs_dynamic"
        )
    return _parse_dynamic_section(bits, max_payload_len, confidence=confidence, snr_db=snr_db)


HEADER_PROBE_DATA_BITS = 96  # header's 64 bits + 32 bits of traceback margin


def frame_result_from_llrs_dynamic(
    config,
    llrs: torch.Tensor,
    max_payload_len: int,
    *,
    confidence: torch.Tensor,
    snr_db: torch.Tensor,
) -> DynamicFrameResult:
    """Variable-length CODED frame parse: soft LLRs of a max-length window
    in, payload + declared length out, in two trellis passes.

    1. Header probe: the convolutional code is sequential, so the first
       HEADER_PROBE_DATA_BITS data bits decode from the static LLR prefix
       alone (an unflushed 102-step trellis; the 32-bit margin past the
       header covers the traceback's convergence). It yields the declared
       length, used only as a mask hint.
    2. Masked full trellis: LLRs past the declared coded length are zeroed
       and ONE max-length Viterbi decodes the section. Zero LLRs tie every
       branch metric, so the path metrics freeze past the true tail flush,
       state 0 stays the strict minimum through the padding, and the decode
       of the real span is the ML decode of the true-length trellis. That
       holds only with the trellis kernel's tie rule (j = 1 wins when
       strictly smaller) and its (pm + a) + b order, which viterbi_trellis
       and its plain version share with the reference kernel.

    Needs fec='conv' with fec_interleave == 1: a block interleaver's
    geometry depends on the section length the header declares."""
    if config.fec != "conv":
        raise ValueError("frame_result_from_llrs_dynamic needs fec='conv'")
    if config.fec_interleave > 1:
        raise ValueError(
            "dynamic coded frames need fec_interleave == 1: a block "
            "interleaver's geometry depends on the section length the "
            "header declares (use the mfsk4-coded-stream preset)"
        )
    from anet_torch.dsp.fec import CONV_TAIL_BITS, conv_encoded_bits, viterbi_decode_soft

    n_probe = HEADER_PROBE_DATA_BITS
    probe_bits = viterbi_decode_soft(llrs[..., : conv_encoded_bits(n_probe)], n_probe)
    probe_hdr = bits_to_bytes(probe_bits[..., : HEADER_BYTES * 8])
    probe_len = _be16(probe_hdr[..., 4:6]).clamp(0, max_payload_len)

    n_bytes_max = data_section_bytes(max_payload_len)
    coded_len = 2 * (8 * (OVERHEAD_BYTES + probe_len) + CONV_TAIL_BITS)
    lane = torch.arange(llrs.shape[-1], device=llrs.device)
    zero = torch.zeros((), dtype=llrs.dtype, device=llrs.device)
    masked = torch.where(lane < coded_len[..., None], llrs, zero)
    bits = viterbi_decode_soft(masked, 8 * n_bytes_max)
    return _parse_dynamic_section(bits, max_payload_len, confidence=confidence, snr_db=snr_db)


def _parse_dynamic_section(
    bits: torch.Tensor,
    max_payload_len: int,
    *,
    confidence: torch.Tensor,
    snr_db: torch.Tensor,
) -> DynamicFrameResult:
    """Shared dynamic-length parse of decoded section bits (uncoded path and
    post-Viterbi coded path): the payload CRC runs over exactly the declared
    length (crc32_device(length=)) and the 4 trailer bytes are gathered at
    their per-frame offset."""
    n_bytes = data_section_bytes(max_payload_len)
    section = bits_to_bytes(bits[..., : n_bytes * 8])

    magic, length, header_crc_ok = _parse_header(section[..., :HEADER_BYTES])
    magic_ok = magic == constants.MAGIC_WORD
    length_ok = length <= max_payload_len
    plen = length.clamp(0, max_payload_len)

    body = section[..., HEADER_BYTES : HEADER_BYTES + max_payload_len]
    mask = torch.arange(max_payload_len, device=bits.device) < plen[..., None]
    payload = torch.where(mask, body, torch.zeros((), dtype=body.dtype, device=bits.device))
    crc_calc = crc32_device(body, length=plen)
    trailer_idx = HEADER_BYTES + plen[..., None] + torch.arange(4, device=bits.device)
    trailer = torch.gather(section, -1, trailer_idx)
    payload_crc_ok = crc_calc == _be_bytes_to_u32(trailer)

    ok = magic_ok & length_ok & header_crc_ok & payload_crc_ok
    return DynamicFrameResult(
        payload=payload,
        payload_len=plen.to(torch.int32),
        magic_ok=magic_ok,
        length_ok=length_ok,
        header_crc_ok=header_crc_ok,
        payload_crc_ok=payload_crc_ok,
        ok=ok,
        confidence=confidence,
        snr_db=snr_db,
    )


def dynamic_frame_result_from_tone_decisions(
    config: ModemConfig,
    tone: torch.Tensor,
    best: torch.Tensor,
    total: torch.Tensor,
    max_payload_len: int,
) -> DynamicFrameResult:
    """Variable-length parse from reduced decisions [..., S] (the contract
    of demod_at_fused): the dynamic twin of frame_result_from_tone_decisions.
    Quality metrics use only the overhead-symbol span, the only span
    guaranteed to carry signal at any payload length. Uncoded only."""
    if config.fec != "none":
        raise ValueError("dynamic payload length requires fec='none'")
    m = config.num_tones
    s_min = data_symbols_for_payload(config, 0)  # overhead-only span
    b = best[..., :s_min]
    t = total[..., :s_min]
    confidence = (b / t.clamp_min(1e-20)).mean(-1)
    snr_db = _snr_db(b.mean(-1), ((t - b) / (m - 1)).mean(-1))
    symbols = gray_decode(tone.to(torch.int32), config.bits_per_symbol)
    bits = unpack_symbols(symbols, config.bits_per_symbol)
    return frame_result_from_bits_dynamic(
        config, bits, max_payload_len, confidence=confidence, snr_db=snr_db
    )


def _overhead_quality(config: ModemConfig, energies: torch.Tensor):
    """(confidence, snr_db) over the overhead-symbol span of [..., S, M]
    energies."""
    e = energies[..., : data_symbols_for_payload(config, 0), :]
    confidence = (e.amax(-1) / e.sum(-1).clamp_min(1e-20)).mean(-1)
    return confidence, estimate_snr_db(config, e)


def dynamic_frame_result_from_energies(
    config: ModemConfig,
    energies: torch.Tensor,
    max_payload_len: int,
) -> DynamicFrameResult:
    """Variable-length CODED parse from full tone energies [..., S, M] (the
    output of demod_at_energies_fused): soft LLRs feed the header probe and
    the masked trellis; quality over the overhead-symbol span."""
    confidence, snr_db = _overhead_quality(config, energies)
    llrs = bit_llrs(config, energies)[..., : data_section_coded_bits(config, max_payload_len)]
    return frame_result_from_llrs_dynamic(
        config, llrs, max_payload_len, confidence=confidence, snr_db=snr_db
    )


def demodulate_frame_dynamic(
    config: ModemConfig,
    samples,
    max_payload_len: int,
    *,
    compute_dtype=torch.float32,
    device="cuda",
) -> DynamicFrameResult:
    """Symbol-aligned max-length frame window [..., T] -> payload + declared
    length, through the plain filterbank. ``samples`` must be
    frame_num_samples(config, max_payload_len) long; a capture holding a
    shorter frame just includes trailing noise, which the masked CRC
    ignores."""
    samples = as_tensor(samples, device)
    data = samples[..., config.preamble_symbols * config.samples_per_symbol :]
    energies = tone_energies(config, data, compute_dtype=compute_dtype)
    if config.fec == "conv":
        return dynamic_frame_result_from_energies(config, energies, max_payload_len)
    confidence, snr_db = _overhead_quality(config, energies)
    bits = unpack_symbols(decide_symbols(config, energies), config.bits_per_symbol)
    return frame_result_from_bits_dynamic(
        config, bits, max_payload_len, confidence=confidence, snr_db=snr_db
    )


def dynamic_frame_samples(config, payload_len):
    """frame_num_samples for a per-frame payload length, for either family:
    an int32 tensor for a tensor, an int for an int. The streaming receiver
    advances its dedupe cursor by it. A coded config has no interleaver pad
    term here: the dynamic coded path requires fec_interleave == 1."""
    from anet_torch.dsp.family import is_ofdm
    from anet_torch.dsp.fec import CONV_TAIL_BITS

    if isinstance(payload_len, torch.Tensor):
        payload_len = payload_len.to(torch.int32)
    n_bits = 8 * (OVERHEAD_BYTES + payload_len)
    if config.fec == "conv":
        n_bits = 2 * (n_bits + CONV_TAIL_BITS)
    syms = (n_bits + config.bits_per_symbol - 1) // config.bits_per_symbol
    if is_ofdm(config):
        return config.preamble_samples + (1 + syms) * config.symbol_samples
    return (config.preamble_symbols + syms) * config.samples_per_symbol
