"""CRC-32 of the frame (mirrors the CRC part of ``anet.dsp.fec``).

Polynomial and parameters match zlib's CRC-32 (reflected 0xEDB88320, init
and xor-out 0xFFFFFFFF), so host-side checks use the stdlib and the device
form is tested against it. The convolutional code and its Viterbi decoder
arrive with the coded slice of the port; only their bit-count arithmetic is
here, because ``ModemConfig`` reads it.

Device formulation for a static length: CRC-32 is linear over GF(2), so the
checksum is one bit-matrix product, crc = (bits @ P_N) mod 2 ^ crc(0^N),
with P_N the per-position bit-contribution table. The product runs in
float64, where the bit counts are exact and no TF32 rounding can apply.
"""

from __future__ import annotations

import zlib
from functools import lru_cache

import numpy as np
import torch

from anet_torch.dsp.bits import bytes_to_bits

CONV_K = 7
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


def crc32_host(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


@lru_cache(maxsize=1)
def _crc32_table() -> np.ndarray:
    table = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0xEDB88320 if c & 1 else c >> 1
        table[i] = c
    return table


def crc32_device(data: torch.Tensor) -> torch.Tensor:
    """CRC-32 of uint8[..., N] along the last axis, as int64 in [0, 2^32):
    one bit-matrix product (_crc32_matmul). The per-message ``length`` form
    of the reference arrives with the variable-length slice."""
    return _crc32_matmul(data)


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
