"""Preamble synchronization: detection + timing estimation (mirrors
``anet.dsp.sync``).

The preamble is a fixed PN tone pattern. The correlation is the
block-Toeplitz matched filter (``method="matmul"``): the lag axis is tiled
into blocks of B lags, and each block is one row of a
``[n_blocks, K+B-1] x [K+B-1, B]`` product against a banded template
matrix. It is the plain version of the streaming search.
"""

from __future__ import annotations

import numpy as np
import torch

from anet_torch._device import resolve_device
from anet_torch.dsp.mod import synthesize_tones
from anet_torch.dsp.params import ModemConfig

_LANE = 128  # samples per energy block of the blockwise quality


def preamble_tone_indices(config: ModemConfig, device="cuda") -> torch.Tensor:
    """Fixed pseudo-noise tone pattern for the preamble.

    The seed is a protocol constant (derived from the wire magic word) and
    the generator is numpy's, so both ends, and both packages, generate the
    identical pattern."""
    rng = np.random.default_rng(0x2C5DA044)
    pattern = rng.integers(0, config.num_tones, config.preamble_symbols)
    return torch.as_tensor(pattern, dtype=torch.int32, device=resolve_device(device))


def preamble_waveform(config: ModemConfig, dtype=torch.float32, device="cuda") -> torch.Tensor:
    """The known preamble template, [preamble_samples]."""
    return synthesize_tones(config, preamble_tone_indices(config, device), dtype=dtype)


def banded_template(template: torch.Tensor, n_rows: int, block: int) -> torch.Tensor:
    """Banded Toeplitz template matrix [n_rows, block]: T[p, j] = t[p - j]
    inside the band, 0 outside."""
    k = template.shape[-1]
    p = torch.arange(n_rows, device=template.device)[:, None]
    j = torch.arange(block, device=template.device)[None, :]
    idx = p - j
    band = (idx >= 0) & (idx < k)
    vals = template[idx.clamp(0, k - 1)]
    return torch.where(band, vals, torch.zeros((), dtype=template.dtype, device=template.device))


def correlate_template(
    samples: torch.Tensor,
    template: torch.Tensor,
    method: str = "matmul",
    block: int | None = None,
) -> torch.Tensor:
    """Valid-mode cross-correlation of [..., N] samples with a [K] template:
    float32 [..., N - K + 1]. Operands are widened to float32 first (the
    reference's f32 accumulation of bf16 operands)."""
    n = samples.shape[-1]
    k = template.shape[-1]
    if k > n:
        raise ValueError(f"template ({k}) longer than capture ({n})")
    if method != "matmul":
        raise ValueError(f"only method='matmul' is ported, got {method!r}")
    return _correlate_matmul(samples.float(), template.float(), block)


def _correlate_matmul(
    samples: torch.Tensor, template: torch.Tensor, block: int | None = None
) -> torch.Tensor:
    """Valid-mode correlation as a block-Toeplitz product.

    For a block of B consecutive lags starting at m*B:
      corr[mB + j] = sum_k x[mB + j + k] * t[k]   (j in [0, B))
    which is one row of Y @ T with Y[m, p] = x[m*B + p] (overlapped rows)
    and T the banded template (banded_template)."""
    n = samples.shape[-1]
    k = template.shape[-1]
    out_len = n - k + 1
    if block is None:
        block = min(512, max(128, 1 << (out_len - 1).bit_length()))
    b = block
    n_blocks = -(-out_len // b)
    w = k + b - 1  # overlapped row width
    r = -(-w // b)  # shifted reshapes needed to cover a row
    pad = (n_blocks + r) * b - n
    x = torch.nn.functional.pad(samples, (0, max(pad, 0)))
    xr = x.reshape(*x.shape[:-1], n_blocks + r, b)
    y = torch.cat([xr[..., s : s + n_blocks, :] for s in range(r)], dim=-1)[..., :w]
    corr = y @ banded_template(template, w, b)
    return corr.reshape(*samples.shape[:-1], n_blocks * b)[..., :out_len]


def blockwise_match_quality(
    seg: torch.Tensor, corr: torch.Tensor, k: int, template_energy
) -> torch.Tensor:
    """Normalized match quality with the window energy at 128-lag
    granularity: square once, sum per 128-sample block (relative to
    ``seg``'s start), slide over ceil(k/128)+1 blocks (a superset of every
    window starting in the block, so quality only ever under-reports), and
    apply one scale per block of lags.

    ``corr`` is the valid-lag correlation [.., out_len] of ``seg`` with a
    k-sample template. Squares round to ``seg``'s dtype, as the reference's
    do; sums are float32."""
    out_len = corr.shape[-1]
    out_pad = -out_len % _LANE
    if out_pad:
        corr = torch.nn.functional.pad(corr, (0, out_pad))
    nb_out = (out_len + out_pad) // _LANE
    kb = -(-k // _LANE) + 1  # blocks per window: superset of any start
    need = (nb_out - 1 + kb + 1) * _LANE
    sq = (seg * seg).float()
    pad = need - sq.shape[-1]
    if pad > 0:
        sq = torch.nn.functional.pad(sq, (0, pad))
    blocks = sq[..., :need].reshape(*sq.shape[:-1], need // _LANE, _LANE).sum(-1)
    csum = torch.cumsum(blocks, dim=-1)
    csum = torch.cat([torch.zeros_like(csum[..., :1]), csum], dim=-1)
    win = csum[..., kb : kb + nb_out] - csum[..., :nb_out]  # [.., nb_out]
    te = torch.as_tensor(template_energy, dtype=torch.float32, device=seg.device)
    scale = torch.rsqrt(te * torch.maximum(win, 1e-4 * te))
    q = corr.abs().reshape(*corr.shape[:-1], nb_out, _LANE) * scale[..., None]
    return q.reshape(corr.shape)[..., :out_len]


def gather_span(buffer: torch.Tensor, start: torch.Tensor, size: int) -> torch.Tensor:
    """out[..., i] = buffer[..., start[...] + i], reading zeros past either
    end of the buffer (the reference's zero-padded span reads)."""
    length = buffer.shape[-1]
    idx = start.to(torch.int64)[..., None] + torch.arange(size, device=buffer.device)
    inside = (idx >= 0) & (idx < length)
    vals = torch.gather(buffer, -1, idx.clamp(0, length - 1))
    return torch.where(inside, vals, torch.zeros((), dtype=buffer.dtype, device=buffer.device))


def preamble_quality_probe(
    buffer: torch.Tensor,
    start: torch.Tensor,
    template: torch.Tensor,
    template_energy,
    n_lags: int = 5,
    compute_dtype=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Normalized preamble match quality at ``n_lags`` consecutive lags
    around per-stream ``start``: the frame-lock verify/refine probe.

    Returns ``(q, st0)``: q[..., o] is the quality at buffer index st0 + o
    with st0 = clip(start - n_lags//2, 0, length - k - n_lags + 1). One
    window energy per stream, summed over the row-aligned span
    [128*(st0//128), 128*(st0//128 + ceil((k+n_lags-1)/128) + 1)): a
    superset of every probed window, as in blockwise_match_quality."""
    k = template.shape[-1]
    length = buffer.shape[-1]
    st0 = (start.to(torch.int64) - n_lags // 2).clamp(0, length - k - n_lags + 1)
    t_c = template.to(compute_dtype) if compute_dtype else template
    te = torch.as_tensor(template_energy, dtype=torch.float32, device=buffer.device)
    buf_c = buffer.to(compute_dtype) if compute_dtype else buffer
    span_rows = -(-(k + n_lags - 1) // _LANE) + 1
    span = gather_span(buf_c, st0 // _LANE * _LANE, span_rows * _LANE).float()
    energy = (span * span).sum(-1)
    wins = gather_span(buf_c, st0, k + n_lags - 1).float()
    corr = wins.unfold(-1, k, 1) @ t_c.float()  # [..., n_lags]
    q = corr.abs() * torch.rsqrt(te * torch.maximum(energy, 1e-4 * te))[..., None]
    return q, st0.to(torch.int32)
