"""CRC-32 and FEC of the frame (mirrors ``anet.dsp.fec``).

Polynomial and parameters match zlib's CRC-32 (reflected 0xEDB88320, init
and xor-out 0xFFFFFFFF), so host-side checks use the stdlib and the device
form is tested against it. The FEC is the rate-1/2 K=7 convolutional code
(polynomials 171/133 octal, zero tail flush) behind a rectangular block
interleaver, decoded by a batched Viterbi search over the 64-state trellis:
hard-decision or soft-decision on per-bit LLRs (anet_torch.dsp.demod.bit_llrs).

Device formulation for a static length: CRC-32 is linear over GF(2), so the
checksum is one bit-matrix product, crc = (bits @ P_N) mod 2 ^ crc(0^N),
with P_N the per-position bit-contribution table. The product runs in
float64, where the bit counts are exact and no TF32 rounding can apply.
A per-message length (variable-length frames) needs no scan over the bytes
either: see crc32_device.
"""

from __future__ import annotations

import zlib
from functools import lru_cache

import numpy as np
import torch

from anet_torch.dsp.bits import bytes_to_bits

CONV_K = 7
CONV_POLY1 = 0o171  # 1111001
CONV_POLY2 = 0o133  # 1011011
CONV_STATES = 1 << (CONV_K - 1)  # 64
CONV_TAIL_BITS = CONV_K - 1  # zero-flush so the trellis ends in state 0


def conv_encoded_bits(n_data_bits: int) -> int:
    """Coded length for a data-bit count (tail-flushed, rate 1/2)."""
    return 2 * (n_data_bits + CONV_TAIL_BITS)


def interleaved_bits(n_bits: int, depth: int) -> int:
    """On-air bit count after padding to a whole depth x rows block."""
    if depth <= 1:
        return n_bits
    rows = -(-n_bits // depth)
    return rows * depth


def interleave(bits: torch.Tensor, depth: int) -> torch.Tensor:
    """Rectangular block interleaver: [..., n] -> [..., rows*depth], written
    row-major, read column-major, zero-padded to a full block. Consecutive
    on-air bits land ``depth`` apart after deinterleaving, so a channel
    burst becomes isolated single errors for the convolutional decoder."""
    if depth <= 1:
        return bits
    n = bits.shape[-1]
    rows = -(-n // depth)
    pad = rows * depth - n
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    block = bits.reshape(*bits.shape[:-1], rows, depth)
    return block.transpose(-1, -2).reshape(*bits.shape[:-1], rows * depth)


def deinterleave(bits: torch.Tensor, depth: int, n_bits: int) -> torch.Tensor:
    """Inverse of interleave; returns the first ``n_bits`` (pad dropped).
    A pure permutation: works on hard bits and on float LLRs alike."""
    if depth <= 1:
        return bits[..., :n_bits]
    total = bits.shape[-1]
    rows = total // depth
    block = bits.reshape(*bits.shape[:-1], depth, rows)
    out = block.transpose(-1, -2).reshape(*bits.shape[:-1], total)
    return out[..., :n_bits]


@lru_cache(maxsize=1)
def _conv_tables():
    """(outputs[64, 2, 2], predecessors[64, 2]) transition tables.

    outputs[s, b] = the two coded bits emitted when input bit ``b`` enters
    with shift-register state ``s`` (the last K-1 input bits, newest in the
    LSB). predecessors[ns, j] = the two states that can transition into
    ``ns`` (its input bit is ns & 1 by construction)."""
    outputs = np.zeros((CONV_STATES, 2, 2), np.int32)
    for s in range(CONV_STATES):
        for b in range(2):
            reg = (s << 1) | b  # K bits: state history + new bit
            outputs[s, b, 0] = bin(reg & CONV_POLY1).count("1") & 1
            outputs[s, b, 1] = bin(reg & CONV_POLY2).count("1") & 1
    preds = np.zeros((CONV_STATES, 2), np.int32)
    for ns in range(CONV_STATES):
        # ns = ((s << 1) | b) & 63  =>  s = (ns >> 1) | (h << 5), h in {0,1}
        preds[ns, 0] = ns >> 1
        preds[ns, 1] = (ns >> 1) | (1 << (CONV_K - 2))
    return outputs, preds


def conv_encode(bits: torch.Tensor) -> torch.Tensor:
    """0/1 uint8 [..., n] -> coded 0/1 uint8 [..., 2*(n + 6)]: each output
    bit is the parity of a 7-bit sliding window AND'ed with its polynomial
    (the register's MSB is the oldest bit)."""
    n = bits.shape[-1]
    padded = torch.nn.functional.pad(bits.to(torch.int32), (CONV_K - 1, CONV_TAIL_BITS))
    windows = padded.unfold(-1, CONV_K, 1)  # [..., n + 6, 7], oldest..newest
    taps = torch.tensor(
        [[(poly >> (CONV_K - 1 - k)) & 1 for poly in (CONV_POLY1, CONV_POLY2)] for k in range(CONV_K)],
        dtype=torch.int32, device=bits.device,
    )  # [7, 2]
    out = (windows[..., None] * taps).sum(-2) & 1  # [..., n + 6, 2]
    return out.reshape(*bits.shape[:-1], 2 * (n + CONV_TAIL_BITS)).to(torch.uint8)


@lru_cache(maxsize=1)
def _branch_signs() -> np.ndarray:
    """[64, 4] per-state +-1 branch-metric signs of the trellis kernel:
    columns are (-e[j=0,bit0], -e[j=0,bit1], -e[j=1,bit0], -e[j=1,bit1])
    where e is the signed expected coded pair of the transition into each
    state through predecessor j (bm_j = signs . rx, a negative correlation)."""
    outputs_np, preds_np = _conv_tables()
    exp = np.zeros((CONV_STATES, 2, 2), np.int32)
    for ns in range(CONV_STATES):
        for j in range(2):
            exp[ns, j] = outputs_np[preds_np[ns, j], ns & 1]
    e = (2 * exp - 1).astype(np.float32)  # [64, j, pair]
    return -e.reshape(CONV_STATES, 4)


def viterbi_decode(coded: torch.Tensor, n_data_bits: int) -> torch.Tensor:
    """Hard-decision Viterbi: coded 0/1 [..., 2*(n+6)] -> 0/1 uint8 [..., n]."""
    return _viterbi(coded.to(torch.float32) * 2.0 - 1.0, n_data_bits)


def viterbi_decode_soft(llrs: torch.Tensor, n_data_bits: int) -> torch.Tensor:
    """Soft-decision Viterbi: per-coded-bit LLRs [..., 2*(n+6)] -> bits.
    ``llrs`` positive = bit 1 (the bit_llrs convention)."""
    return _viterbi(llrs.to(torch.float32), n_data_bits)


def _viterbi(soft: torch.Tensor, n_data_bits: int) -> torch.Tensor:
    """Shared trellis search; ``soft`` is signed (+ = bit 1) per coded bit.
    Reshapes to per-stream pairs [N, total, 2] and runs
    anet_torch.kernels.viterbi_trellis: the CUDA kernel for tensors on the
    card, its plain version for tensors on the CPU."""
    from anet_torch.kernels import viterbi_trellis

    batch_shape = soft.shape[:-1]
    total = n_data_bits + CONV_TAIL_BITS
    pairs = soft[..., : 2 * total].reshape(-1, total, 2).contiguous()
    signs = torch.as_tensor(_branch_signs(), device=soft.device)
    bits = viterbi_trellis(signs, pairs)  # uint8 [N, total]
    return bits.reshape(*batch_shape, total)[..., :n_data_bits]


def crc32_host(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


def crc32_bytes_be(crc: int) -> bytes:
    """A CRC-32 value as its 4 big-endian bytes (the frame trailer's order)."""
    return int(crc).to_bytes(4, "big")


@lru_cache(maxsize=1)
def _crc32_table() -> np.ndarray:
    table = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0xEDB88320 if c & 1 else c >> 1
        table[i] = c
    return table


def crc32_device(data: torch.Tensor, length: torch.Tensor | None = None) -> torch.Tensor:
    """CRC-32 of uint8[..., N] along the last axis, as int64 in [0, 2^32).

    ``length is None`` (static length, the framing hot path): one bit-matrix
    product (_crc32_matmul).

    ``length`` given (int tensor of the batch shape): only the first
    ``length`` bytes of each message count; the rest is padding. The
    reference runs a masked scan over the byte axis here. CRC-32 is affine
    over GF(2), so the same value comes without a scan: with M the message
    zeroed past ``length``, the linear part of the N-byte checksum,
    L_N(M) = (bits(M) @ P_N) mod 2, is the linear part of the wanted
    checksum advanced through N - length zero bytes. Undoing that advance is
    a 32 x 32 bit matrix picked per message from a table indexed by
    N - length, and the affine constant crc(0^length) comes from a second
    table. Bit-equal to zlib.crc32 over exactly ``length`` bytes for every
    length in 0..N (lengths outside are clipped, as the scan's mask does)."""
    if length is None:
        return _crc32_matmul(data)
    n = data.shape[-1]
    dev = data.device
    plen = length.to(device=dev, dtype=torch.int64).clamp(0, n)
    unadvance_np, const_np = _crc32_length_tables(n)
    if n == 0:
        return torch.full(data.shape[:-1], int(const_np[0]), dtype=torch.int64, device=dev)
    keep = torch.arange(n, device=dev) < plen[..., None]
    masked = torch.where(keep, data, torch.zeros((), dtype=data.dtype, device=dev))
    p = torch.as_tensor(_crc32_bit_table(n)[0], dtype=torch.float64, device=dev)
    raw = parity_to_u32(bytes_to_bits(masked).to(torch.float64) @ p)  # L_N(M)
    raw_bits = ((raw[..., None] >> torch.arange(32, device=dev)) & 1).to(torch.float32)
    images = torch.as_tensor(unadvance_np, device=dev)[n - plen].to(torch.float32)  # [..., 32, 32]
    linear = parity_to_u32((raw_bits[..., :, None] * images).sum(-2))
    return linear ^ torch.as_tensor(const_np, device=dev)[plen]


@lru_cache(maxsize=8)
def _crc32_length_tables(n_bytes: int) -> tuple[np.ndarray, np.ndarray]:
    """Tables of the per-message-length CRC over messages padded to n bytes:
    (unadvance uint8 [n + 1, 32, 32], const int64 [n + 1]).

    unadvance[k, j, b] is bit b of A^-k(e_j): the register state whose
    advance through k zero bytes is the single bit j (A, one zero byte, is
    s -> table[s & 0xFF] ^ (s >> 8); its inverse finds the byte index from
    the top byte of the result, which is distinct for each table entry).
    const[p] = crc32 of p zero bytes."""
    table = _crc32_table().astype(np.uint64)
    by_top = np.zeros(256, np.uint64)
    by_top[(table >> np.uint64(24)).astype(np.int64)] = np.arange(256, dtype=np.uint64)
    states = np.zeros((n_bytes + 1, 32), np.uint64)
    states[0] = np.uint64(1) << np.arange(32, dtype=np.uint64)
    for k in range(1, n_bytes + 1):
        r = states[k - 1]
        i = by_top[(r >> np.uint64(24)).astype(np.int64)]
        states[k] = (((r ^ table[i.astype(np.int64)]) << np.uint64(8)) | i) & np.uint64(0xFFFFFFFF)
    bitpos = np.arange(32, dtype=np.uint64)
    unadvance = ((states[..., None] >> bitpos) & np.uint64(1)).astype(np.uint8)
    const = np.zeros(n_bytes + 1, np.int64)
    crc = 0
    for p in range(n_bytes + 1):
        const[p] = crc & 0xFFFFFFFF
        crc = zlib.crc32(b"\x00", crc)
    return unadvance, const


@lru_cache(maxsize=64)
def _crc32_bit_table(n_bytes: int) -> tuple[np.ndarray, int]:
    """(P, const) for the linear CRC formulation over an n-byte message.

    P[j, b] = bit b of the CRC contribution of message bit j (MSB-first
    within each byte, matching bytes_to_bits), computed with zero init and
    no xor-out; const = crc32 of the all-zero message (which absorbs the
    0xFFFFFFFF init and xor-out affine parts). Columns are built
    back-to-front: the contribution of a bit one byte earlier is its
    successor's state advanced through one zero byte."""
    table = _crc32_table()
    cols = np.zeros((n_bytes, 8), dtype=np.uint64)
    if n_bytes:
        for k in range(8):
            msg = bytes([0x80 >> k])
            cols[n_bytes - 1, k] = (~zlib.crc32(msg, 0xFFFFFFFF)) & 0xFFFFFFFF
        for i in range(n_bytes - 2, -1, -1):
            s = cols[i + 1]
            cols[i] = table[(s & 0xFF).astype(np.int64)] ^ (s >> 8)
    flat = cols.reshape(-1)
    bitpos = np.arange(32, dtype=np.uint64)
    p = ((flat[:, None] >> bitpos[None, :]) & 1).astype(np.float32)  # [8N, 32]
    const = zlib.crc32(b"\x00" * n_bytes) & 0xFFFFFFFF
    return p, const


def parity_to_u32(counts: torch.Tensor) -> torch.Tensor:
    """Bit counts [..., 32] (bit b in column b) -> the int64 word of their
    parities. Exact for counts below 2^24 (f32) or 2^53 (f64)."""
    parity = counts.to(torch.int64) & 1
    weights = 1 << torch.arange(32, dtype=torch.int64, device=counts.device)
    return (parity * weights).sum(-1)


def _crc32_matmul(data: torch.Tensor) -> torch.Tensor:
    """One-matmul CRC-32 for static-length messages (see crc32_device)."""
    n = data.shape[-1]
    p_np, const = _crc32_bit_table(n)
    if n == 0:
        return torch.full(data.shape[:-1], const, dtype=torch.int64, device=data.device)
    bits = bytes_to_bits(data).to(torch.float64)  # [..., 8N]
    p = torch.as_tensor(p_np, dtype=torch.float64, device=data.device)
    return parity_to_u32(bits @ p) ^ const
