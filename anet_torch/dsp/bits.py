"""Bit/byte/symbol packing utilities (mirrors ``anet.dsp.bits``).

Conventions (fixed so all implementations agree):
- Bytes unpack MSB-first (bit 7 first).
- Symbols pack bits MSB-first: for bits_per_symbol=4, bits [b3 b2 b1 b0]
  form symbol value b3*8 + b2*4 + b1*2 + b0.
- Symbols are Gray-coded onto tone indices so adjacent-tone demod errors
  cost one bit.
"""

from __future__ import annotations

import torch


def bytes_to_bits(data: torch.Tensor) -> torch.Tensor:
    """uint8[..., N] -> uint8[..., N*8] of 0/1, MSB-first per byte."""
    data = data.to(torch.uint8)
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=data.device)
    bits = (data[..., :, None] >> shifts) & 1
    return bits.reshape(*data.shape[:-1], data.shape[-1] * 8)


def bits_to_bytes(bits: torch.Tensor) -> torch.Tensor:
    """uint8[..., N*8] of 0/1 -> uint8[..., N], MSB-first per byte."""
    n_bytes = bits.shape[-1] // 8
    grouped = bits.reshape(*bits.shape[:-1], n_bytes, 8).to(torch.int32)
    weights = 1 << torch.arange(7, -1, -1, dtype=torch.int32, device=bits.device)
    return (grouped * weights).sum(-1).to(torch.uint8)


def pack_symbols(bits: torch.Tensor, bits_per_symbol: int) -> torch.Tensor:
    """0/1 bits[..., S*k] -> int32 symbols[..., S], MSB-first within a symbol.

    The bit count must already be a multiple of bits_per_symbol."""
    s = bits.shape[-1] // bits_per_symbol
    grouped = bits.reshape(*bits.shape[:-1], s, bits_per_symbol).to(torch.int32)
    weights = 1 << torch.arange(
        bits_per_symbol - 1, -1, -1, dtype=torch.int32, device=bits.device
    )
    return (grouped * weights).sum(-1, dtype=torch.int32)


def unpack_symbols(symbols: torch.Tensor, bits_per_symbol: int) -> torch.Tensor:
    """int symbols[..., S] -> 0/1 uint8 bits[..., S*k], MSB-first."""
    shifts = torch.arange(
        bits_per_symbol - 1, -1, -1, dtype=torch.int32, device=symbols.device
    )
    bits = (symbols.to(torch.int32)[..., :, None] >> shifts) & 1
    return bits.reshape(
        *symbols.shape[:-1], symbols.shape[-1] * bits_per_symbol
    ).to(torch.uint8)


def gray_encode(value: torch.Tensor) -> torch.Tensor:
    """Binary -> Gray: g = b ^ (b >> 1)."""
    return value ^ (value >> 1)


def gray_decode(gray: torch.Tensor, bits_per_symbol: int) -> torch.Tensor:
    """Gray -> binary via log2 prefix-XOR steps."""
    value = gray
    shift = 1
    while shift < bits_per_symbol:
        value = value ^ (value >> shift)
        shift <<= 1
    return value
