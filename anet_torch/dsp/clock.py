"""Symbol-clock recovery: fractional-delay timing and drift tracking
(mirrors ``anet.dsp.clock``).

Transmitter and receiver sample clocks differ by a static sub-sample offset
plus a slow rate drift, so symbol windows slide out of alignment over a
frame and the orthogonal filterbank starts leaking between tones. The
tracker walks the frame symbol by symbol with the (float) sample position of
the current symbol window as its state; each step

  1. gathers the on-time window at the fractional position, and the early
     (-delta) and late (+delta) ones (linear interpolation: two gathers and
     a lerp),
  2. computes their filterbank energies,
  3. decides the symbol from the on-time energies,
  4. nudges timing toward the energy peak with the bounded early/late error
     e = (E_late - E_early) / (E_late + E_early) of the winning tone (a
     decision-directed Gardner-style gate).

Sequential over symbols, parallel over streams. No kernel backs it: the
three windows of a step are one gather of [..., 3, sps] and one product
with the [sps, 2M] basis, and the loop runs a fixed number of steps without
reading anything to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from anet_torch.dsp.bits import gray_decode
from anet_torch.dsp.demod import demod_basis
from anet_torch.dsp.params import ModemConfig


class TrackedDemodResult(NamedTuple):
    symbols: torch.Tensor  # int32 [..., S] decided data symbols
    energies: torch.Tensor  # float32 [..., S, M] on-time energies
    timing: torch.Tensor  # float32 [..., S] sample position per symbol
    timing_error: torch.Tensor  # float32 [..., S] early/late error signal


def _gather_window(samples: torch.Tensor, t0: torch.Tensor, sps: int) -> torch.Tensor:
    """Fractionally delayed float32 windows [..., J, sps] of ``samples``
    [..., N] starting at the float32 positions ``t0`` [..., J]: sample
    indices clipped to [0, N - 2], then s0 * (1 - frac) + s1 * frac. Any
    sample dtype widens to float32 exactly (bf16, int8) before the lerp, as
    the reference's type promotion does."""
    base = torch.floor(t0)
    frac = (t0 - base)[..., None]
    n = samples.shape[-1]
    idx = (base.to(torch.int64)[..., None] + torch.arange(sps, device=samples.device)).clamp(0, n - 2)
    flat = idx.reshape(*idx.shape[:-2], -1)
    s0 = torch.gather(samples, -1, flat).reshape(idx.shape).float()
    s1 = torch.gather(samples, -1, flat + 1).reshape(idx.shape).float()
    return s0 * (1.0 - frac) + s1 * frac


def demodulate_symbols_tracked(
    config: ModemConfig,
    samples: torch.Tensor,
    num_symbols: int,
    start_pos: torch.Tensor | float = 0.0,
    *,
    loop_gain: float = 0.35,
    delta: float = 2.0,
    compute_dtype=torch.float32,
) -> TrackedDemodResult:
    """Demodulate ``num_symbols`` with decision-directed timing tracking.

    ``samples`` [..., N] must extend at least num_symbols * sps + delta + 2
    past ``start_pos``, the float32 (batched or scalar) position of symbol
    0 (integer offset plus the preamble sync's sub-sample refinement).
    ``loop_gain`` is the proportional timing correction (samples per unit
    error per symbol); the loop is second order: a rate accumulator (gain
    loop_gain / 16) absorbs constant clock drift with no steady-state lag,
    so +-1000 ppm tracks cleanly. ``delta`` is the early/late spacing in
    samples. Windows round to ``compute_dtype`` (as the reference's matmul
    operands do); the products run in float32."""
    sps = config.samples_per_symbol
    m = config.num_tones
    dev = samples.device
    basis = demod_basis(config, dtype=compute_dtype, device=dev).float()  # [sps, 2M]
    batch_shape = samples.shape[:-1]
    t = torch.as_tensor(start_pos, dtype=torch.float32, device=dev).expand(batch_shape).clone()
    rate = torch.zeros_like(t)
    rate_gain = loop_gain / 16.0
    # on time, early, late: t + 0 == t and t + (-delta) == t - delta exactly
    shifts = torch.tensor([0.0, -delta, delta], dtype=torch.float32, device=dev)
    tones, energies, timing, errors = [], [], [], []
    for _ in range(num_symbols):
        win = _gather_window(samples, t[..., None] + shifts, sps).to(compute_dtype).float()
        iq = win @ basis  # [..., 3, 2M]
        e = iq[..., :m] * iq[..., :m] + iq[..., m:] * iq[..., m:]  # [..., 3, M]
        e_on = e[..., 0, :]
        tone = torch.argmax(e_on, dim=-1)  # first index on ties
        idx = tone[..., None, None].expand(*tone.shape, 2, 1)
        win_el = torch.gather(e[..., 1:, :], -1, idx)[..., 0]  # [..., 2]: early, late
        early, late = win_el[..., 0], win_el[..., 1]
        err = (late - early) / (late + early).clamp_min(1e-20)
        tones.append(tone)
        energies.append(e_on)
        timing.append(t)
        errors.append(err)
        rate = rate + rate_gain * err
        t = t + sps + rate + loop_gain * err
    symbols = gray_decode(torch.stack(tones, -1).to(torch.int32), config.bits_per_symbol)
    return TrackedDemodResult(
        symbols=symbols,
        energies=torch.stack(energies, -2),
        timing=torch.stack(timing, -1),
        timing_error=torch.stack(errors, -1),
    )


def tracked_frame_result(
    config: ModemConfig,
    samples: torch.Tensor,
    payload_len: int,
    start_pos,
    *,
    loop_gain: float = 0.35,
    compute_dtype=torch.float32,
):
    """Tracked demod and frame parse in one step (shared by the one-shot and
    the streaming receivers): (FrameResult, TrackedDemodResult) of the data
    section starting at ``start_pos``. ``samples`` must extend past
    start_pos + data samples by the tracker's probe margin (delta + 2);
    stretched frames (a slow RX clock) need more tail room."""
    from anet_torch.dsp.frame import data_symbols_for_payload, frame_result_from_decisions

    tracked = demodulate_symbols_tracked(
        config,
        samples,
        data_symbols_for_payload(config, payload_len),
        start_pos=start_pos,
        loop_gain=loop_gain,
        compute_dtype=compute_dtype,
    )
    frame = frame_result_from_decisions(config, tracked.symbols, tracked.energies, payload_len)
    return frame, tracked


def estimate_drift_ppm(config: ModemConfig, result: TrackedDemodResult) -> torch.Tensor:
    """Clock drift from the tracked timing trajectory: the least-squares
    slope of (timing[i] - i * sps) over the symbol index, in parts per
    million of the sample clock (float32 [...])."""
    sps = config.samples_per_symbol
    s = result.timing.shape[-1]
    idx = torch.arange(s, dtype=torch.float32, device=result.timing.device)
    residual = result.timing - result.timing[..., :1] - idx * sps
    idx_c = idx - idx.mean()
    slope = (residual * idx_c).sum(-1) / (idx_c * idx_c).sum()
    return slope / sps * 1e6
