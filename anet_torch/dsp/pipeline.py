"""End-to-end single-frame pipeline (mirrors ``anet.dsp.pipeline``).

transmit(): payload bytes -> frame waveform.
receive_frame(): unaligned capture -> preamble sync -> aligned demod ->
payload + verdicts + sync metrics; receive_frame_dynamic() reads the payload
length from the frame's header; receive_frame_tracked() demodulates the data
section with the symbol-clock tracker (anet_torch.dsp.clock). Batched via
leading axes. The aligned and streaming receivers are in
``anet_torch.dsp.frame`` and ``anet_torch.stream``."""

from __future__ import annotations

from typing import NamedTuple

import torch

from anet_torch._device import as_tensor
from anet_torch.dsp.frame import (
    DynamicFrameResult,
    FrameResult,
    demodulate_frame,
    frame_num_samples,
    modulate_frame,
)
from anet_torch.dsp.params import ModemConfig
from anet_torch.dsp.sync import (
    SyncResult,
    aligned_gather,
    correlate_template,
    locate_preamble,
    normalized_match_quality,
    sliding_window_energy,
)


def transmit(
    config: ModemConfig, payload, dtype=torch.float32, device="cuda"
) -> torch.Tensor:
    """payload uint8[..., N] -> waveform float[..., frame_num_samples] on
    ``device``."""
    return modulate_frame(config, payload, dtype=dtype, device=device)


class ReceiveResult(NamedTuple):
    frame: FrameResult
    sync: SyncResult


def receive_frame(
    config: ModemConfig,
    capture,
    payload_len: int,
    *,
    sync_method: str = "auto",
    compute_dtype=torch.float32,
    device="cuda",
) -> ReceiveResult:
    """Locate and demodulate one frame inside a longer capture [..., N],
    N >= frame_num_samples(config, payload_len). The preamble may start
    anywhere such that the whole frame fits; timing is recovered by
    matched-filter correlation (anet_torch.dsp.sync)."""
    capture = as_tensor(capture, device)
    t = frame_num_samples(config, payload_len)
    n = capture.shape[-1]
    if n < t:
        raise ValueError(f"capture of {n} samples cannot hold a {t}-sample frame")
    sync = locate_preamble(config, capture, method=sync_method)
    # Clamp so the gathered window stays in bounds even on a bogus lock.
    start = sync.offset.clamp(0, n - t)
    aligned = aligned_gather(capture, start, t)
    frame = demodulate_frame(
        config, aligned, payload_len, compute_dtype=compute_dtype, device=capture.device
    )
    return ReceiveResult(frame=frame, sync=sync)


class TrackedReceiveResult(NamedTuple):
    frame: FrameResult
    sync: SyncResult
    drift_ppm: torch.Tensor  # float32 [...] estimated RX clock drift
    timing_error_rms: torch.Tensor  # float32 [...] residual tracker error


def receive_frame_tracked(
    config: ModemConfig,
    capture,
    payload_len: int,
    *,
    sync_method: str = "auto",
    loop_gain: float = 0.35,
    compute_dtype=torch.float32,
    device="cuda",
) -> TrackedReceiveResult:
    """receive_frame with symbol-clock recovery (anet_torch.dsp.clock).

    Locates the preamble (integer offset and sub-sample refinement), then
    demodulates the data section with the decision-directed timing tracker,
    so frames survive TX/RX sample-clock drift that breaks the block
    demodulator. Also returns the estimated drift in ppm and the RMS of the
    tracker's timing error."""
    from anet_torch.dsp.clock import estimate_drift_ppm, tracked_frame_result

    capture = as_tensor(capture, device)
    t = frame_num_samples(config, payload_len)
    n = capture.shape[-1]
    if n < t:
        raise ValueError(f"capture of {n} samples cannot hold a {t}-sample frame")
    sync = locate_preamble(config, capture, method=sync_method)
    start = sync.offset.clamp(0, n - t).float() + sync.frac + config.preamble_samples
    frame, tracked = tracked_frame_result(
        config, capture, payload_len, start, loop_gain=loop_gain, compute_dtype=compute_dtype
    )
    return TrackedReceiveResult(
        frame=frame,
        sync=sync,
        drift_ppm=estimate_drift_ppm(config, tracked),
        timing_error_rms=torch.sqrt((tracked.timing_error**2).mean(-1)),
    )


class DynamicReceiveResult(NamedTuple):
    frame: DynamicFrameResult
    offset: torch.Tensor  # int32[...] located frame start
    quality: torch.Tensor  # float32[...] sync match quality


def receive_frame_dynamic(
    config,
    capture,
    max_payload_len: int,
    *,
    compute_dtype=torch.float32,
    device="cuda",
) -> DynamicReceiveResult:
    """Locate and demodulate one variable-length frame: the payload length
    is read from the frame header (a max-length window is demodulated, the
    CRC runs over the declared length); the caller only bounds it.
    ``capture`` [..., N] must be at least frame_samples(config,
    max_payload_len) long; pad short captures with zeros. Coded configs need
    fec_interleave == 1 (frame.frame_result_from_llrs_dynamic). The match
    quality is normalized by the exact window energy at every lag."""
    from anet_torch.dsp.family import (
        aligned_demod_dynamic_fn,
        frame_samples,
        preamble_template,
    )

    capture = as_tensor(capture, device)
    t = frame_samples(config, max_payload_len)
    n = capture.shape[-1]
    if n < t:
        raise ValueError(f"capture of {n} samples cannot hold a {t}-sample max-length frame")
    template = preamble_template(config, capture.device)
    corr = correlate_template(capture, template, method="auto")
    energy = sliding_window_energy(capture, template.shape[-1])
    quality = normalized_match_quality(corr, energy, (template * template).sum())
    offset = torch.argmax(quality, dim=-1)
    best_q = torch.gather(quality, -1, offset[..., None])[..., 0]
    start = offset.clamp(0, n - t)
    aligned = aligned_gather(capture, start, t)
    frame = aligned_demod_dynamic_fn(config, max_payload_len, compute_dtype, capture.device)(aligned)
    return DynamicReceiveResult(frame=frame, offset=offset.to(torch.int32), quality=best_q)


def loopback(
    config: ModemConfig, payload, pad_before: int = 0, pad_after: int = 0, device="cuda"
) -> ReceiveResult:
    """transmit -> (optional silence padding) -> receive. Debug/test helper."""
    wave = transmit(config, payload, device=device)
    if pad_before or pad_after:
        wave = torch.nn.functional.pad(wave, (pad_before, pad_after))
    return receive_frame(config, wave, payload.shape[-1], device=device)
