"""Preamble synchronization: detection + timing estimation (mirrors
``anet.dsp.sync``).

The preamble is a fixed PN tone pattern. Three correlation backends, as
the reference's:

- ``matmul``: the block-Toeplitz matched filter. The lag axis is tiled into
  blocks of B lags, and each block is one row of a
  ``[n_blocks, K+B-1] x [K+B-1, B]`` product against a banded template
  matrix. It is the plain version of the streaming search and of
  correlate_fused, and the one-shot locators' correlation on the card.
- ``fft``: rfft, multiply, irfft (``torch.fft``: cuFFT on the card, as the
  reference's route is ``jnp.fft`` and no kernel); the default, and what
  ``auto`` takes on the CPU, as the reference's does.
- ``direct``: the materialized sliding windows; the golden model for tests.

``auto`` (the one-shot locators and the capture classifier) is the FFT for
a tensor on the CPU and the block-Toeplitz product on the card.
"""

from __future__ import annotations

from typing import NamedTuple

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


class SyncResult(NamedTuple):
    """Timing estimate for one stream (all fields batched alike)."""

    offset: torch.Tensor  # int32: sample index where the preamble starts
    frac: torch.Tensor  # float32: sub-sample refinement in (-0.5, 0.5)
    quality: torch.Tensor  # float32: normalized correlation in [0, 1]


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
    method: str = "fft",
    fft_len: int | None = None,
    block: int | None = None,
) -> torch.Tensor:
    """Valid-mode cross-correlation of [..., N] samples with a [K] template:
    float32 [..., N - K + 1]. Operands are widened to float32 first (the
    reference's f32 accumulation of bf16 operands).

    ``method`` is ``"fft"`` (the default), ``"matmul"`` (``block`` its
    lag-tile width), ``"direct"`` or ``"auto"`` (the FFT for a tensor on the
    CPU, the block-Toeplitz product on the card). ``fft_len`` is the FFT
    size, next_pow2(N + K - 1) by default (no circular wraparound); callers
    that read only the valid lags may pass next_pow2(N), whose aliased
    contributions land outside them."""
    n = samples.shape[-1]
    k = template.shape[-1]
    if k > n:
        raise ValueError(f"template ({k}) longer than capture ({n})")
    if method == "auto":
        method = "fft" if samples.device.type == "cpu" else "matmul"
    if method not in ("fft", "matmul", "direct"):
        raise ValueError(f"method must be fft, matmul, direct or auto, got {method!r}")
    x, t = samples.float(), template.float()
    if method == "direct":
        return x.unfold(-1, k, 1) @ t
    if method == "matmul":
        return _correlate_matmul(x, t, block)
    if fft_len is None:
        fft_len = _next_pow2(n + k - 1)
    elif fft_len < n:
        raise ValueError(f"fft_len {fft_len} shorter than the capture ({n})")
    spec_x = torch.fft.rfft(x, n=fft_len, dim=-1)
    spec_t = torch.fft.rfft(t, n=fft_len)
    corr = torch.fft.irfft(spec_x * spec_t.conj(), n=fft_len, dim=-1)
    return corr[..., : n - k + 1]


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


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
        block = min(512, max(128, _next_pow2(out_len)))
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


def sliding_window_energy(samples: torch.Tensor, k: int) -> torch.Tensor:
    """Energy of every k-sample window: [..., N] -> float32 [..., N - k + 1],
    as differences of a prefix sum of the squared samples. Squares round to
    the samples' dtype, as the reference's do; the prefix sum is float32."""
    csum = torch.cumsum((samples * samples).float(), dim=-1)
    csum = torch.nn.functional.pad(csum, (1, 0))
    return csum[..., k:] - csum[..., : csum.shape[-1] - k]


def normalized_match_quality(
    corr: torch.Tensor, window_energy: torch.Tensor, template_energy
) -> torch.Tensor:
    """Cauchy-Schwarz-normalized correlation quality in [0, 1]. The window
    energy is floored at -40 dB of the template energy so near-silent
    windows cannot report spurious quality. Shared by the one-shot locators."""
    te = torch.as_tensor(template_energy, dtype=torch.float32, device=corr.device)
    return corr.abs() / torch.sqrt(te * torch.maximum(window_energy, 1e-4 * te))


def gather_span(buffer: torch.Tensor, start: torch.Tensor, size: int) -> torch.Tensor:
    """out[..., i] = buffer[..., start[...] + i], reading zeros past either
    end of the buffer (the reference's zero-padded span reads)."""
    length = buffer.shape[-1]
    idx = start.to(torch.int64)[..., None] + torch.arange(size, device=buffer.device)
    inside = (idx >= 0) & (idx < length)
    vals = torch.gather(buffer, -1, idx.clamp(0, length - 1))
    return torch.where(inside, vals, torch.zeros((), dtype=buffer.dtype, device=buffer.device))


def aligned_gather(
    buffer: torch.Tensor,
    start: torch.Tensor,
    size: int,
    compute_dtype=None,
    mode: str = "auto",
    start_bound: int | None = None,
) -> torch.Tensor:
    """Slice ``size`` samples at per-stream offsets: out[..., i] =
    buffer[..., start[...] + i], in the buffer's dtype. Callers guarantee
    0 <= start and start + size <= buffer length; positions outside the
    buffer read as zero.

    The reference's ``dma`` and ``onehot`` modes are two XLA formulations of
    this one gather, chosen by ``auto`` for the TPU; here all three are
    gather_span. ``mode="roll"`` is the kernel
    (anet_torch.kernels.gather_rows_fused), as in the reference an explicit
    mode and not in ``auto``. A ``compute_dtype`` other than float32 rounds
    the samples to it on the way (the reference's selection products run in
    that dtype); ``roll`` moves them untouched. ``start_bound`` (the
    largest start the caller can pass) is accepted and ignored: in the
    reference it is a TPU DMA hint that only lets its forms skip a pad copy,
    and the gathers here read by index."""
    if mode not in ("auto", "dma", "onehot", "roll"):
        raise ValueError(f"mode must be auto/dma/onehot/roll, got {mode!r}")
    if start.dim() == 0:
        return buffer.narrow(-1, int(start), size)
    if mode == "roll":
        from anet_torch.kernels import gather_rows_fused

        return gather_rows_fused(buffer, start, size)
    out = gather_span(buffer, start, size)
    if compute_dtype is not None and compute_dtype != torch.float32:
        out = out.to(compute_dtype).to(buffer.dtype)
    return out


def _local_energy(samples: torch.Tensor, k: int, offset: torch.Tensor) -> torch.Tensor:
    """Energy of the k-sample window at ``offset`` (float32 prefix sum)."""
    csum = torch.cumsum((samples * samples).float(), dim=-1)
    csum = torch.nn.functional.pad(csum, (1, 0))
    off = offset.to(torch.int64)[..., None]
    return (torch.gather(csum, -1, off + k) - torch.gather(csum, -1, off))[..., 0]


def locate_preamble(
    config: ModemConfig, samples: torch.Tensor, method: str = "auto"
) -> SyncResult:
    """Find the preamble start in a capture [..., N] (N >= preamble
    samples): integer offset of the correlation peak, a parabolic sub-sample
    refinement, and the normalized quality at the peak (1.0 = perfect
    match), normalized by the exact window energy there."""
    template = preamble_waveform(config, device=samples.device)
    abs_corr = correlate_template(samples, template, method=method).abs()
    offset = torch.argmax(abs_corr, dim=-1)
    n_corr = abs_corr.shape[-1]

    def at(idx):
        return torch.gather(abs_corr, -1, idx.clamp(0, n_corr - 1)[..., None])[..., 0]

    center, left, right = at(offset), at(offset - 1), at(offset + 1)
    denom = left - 2.0 * center + right
    frac = torch.where(denom.abs() > 1e-12, 0.5 * (left - right) / denom, torch.zeros_like(denom))
    t_energy = (template * template).sum()
    window_energy = _local_energy(samples, template.shape[-1], offset)
    return SyncResult(
        offset=offset.to(torch.int32),
        frac=frac.clamp(-0.5, 0.5),
        quality=normalized_match_quality(center, window_energy, t_energy),
    )


def preamble_quality_probe(
    buffer: torch.Tensor,
    start: torch.Tensor,
    template: torch.Tensor,
    template_energy,
    n_lags: int = 5,
    compute_dtype=None,
    mode: str = "auto",
    start_bound: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Normalized preamble match quality at ``n_lags`` consecutive lags
    around per-stream ``start``: the frame-lock verify/refine probe.

    Returns ``(q, st0)``: q[..., o] is the quality at buffer index st0 + o
    with st0 = clip(start - n_lags//2, 0, length - k - n_lags + 1). One
    window energy per stream, summed over the row-aligned span
    [128*(st0//128), 128*(st0//128 + ceil((k+n_lags-1)/128) + 1)): a
    superset of every probed window, as in blockwise_match_quality.

    ``start_bound`` (a non-negative int) is the largest ``start`` the caller
    can pass, as the reference takes it: the probe then reads only the head
    of the buffer that a bounded start reaches. The spans are gathered by
    index, so the bound changes no value.

    ``mode="fused"`` takes the probe kernel (kernels.probe_at_fused, on the
    buffer cast to ``compute_dtype``), whose one window energy is summed
    over the st0-ALIGNED span [st0, st0 + 128 * (ceil((k + n_lags - 1) /
    128) + 1)) instead, a superset as well; any other mode, ``"auto"``
    included, is the row-aligned form above, as in the reference."""
    k = template.shape[-1]
    length = buffer.shape[-1]
    st0 = (start.to(torch.int64) - n_lags // 2).clamp(0, length - k - n_lags + 1)
    t_c = template.to(compute_dtype) if compute_dtype else template
    te = torch.as_tensor(template_energy, dtype=torch.float32, device=buffer.device)
    if start_bound is not None and (
        isinstance(start_bound, bool) or not isinstance(start_bound, int) or start_bound < 0
    ):
        raise ValueError(f"start_bound must be a non-negative int, got {start_bound!r}")
    if mode == "fused":
        from anet_torch.kernels import probe_at_fused

        buf_c = buffer.to(compute_dtype) if compute_dtype else buffer
        q = probe_at_fused(
            buf_c.reshape(-1, length), st0.reshape(-1).to(torch.int32), t_c, te, n_lags
        )
        return q.reshape(*st0.shape, n_lags), st0.to(torch.int32)
    span_rows = -(-(k + n_lags - 1) // _LANE) + 1
    if start_bound is not None:
        # a start at most the bound reads rows [0, bound_row + span_rows + 1)
        bound0 = min(start_bound, length - k - n_lags + 1)
        head = (bound0 // _LANE + span_rows + 1) * _LANE
        if head < length:
            buffer = buffer[..., :head]
    span = gather_span(buffer, st0 // _LANE * _LANE, span_rows * _LANE)
    wins = gather_span(buffer, st0, k + n_lags - 1)
    if compute_dtype:  # cast after the gathers: elementwise, so the same values
        span, wins = span.to(compute_dtype), wins.to(compute_dtype)
    span, wins = span.float(), wins.float()
    energy = (span * span).sum(-1)
    corr = wins.unfold(-1, k, 1) @ t_c.float()  # [..., n_lags]
    q = corr.abs() * torch.rsqrt(te * torch.maximum(energy, 1e-4 * te))[..., None]
    return q, st0.to(torch.int32)
