"""Streaming receiver: chunked demodulation with an explicit carry (mirrors
``anet.stream``: fixed and variable frame length, uncoded and coded, with or
without the symbol-clock tracker, and the capture-resident lock scan).

A capture is processed as fixed-size chunks; the carry holds everything the
receiver remembers between chunks: a sliding sample buffer, the dedupe
cursor, the frame lock (predicted next start, clock-drift estimate) and the
counters frames detected / ok / decode errors. Each step appends one chunk
and examines the "just completed" window: frame starts whose frame end
arrived within the new chunk, so every frame is considered exactly once.
At most one frame is detected per chunk; chunk_size <= one frame length
guarantees none is skipped.

The entry points take any leading batch shape, as the reference's: a
capture or chunk [..., N] and a carry of batch shape ``(...)``, ``()`` for
one stream (the carry the reference's CLI checkpoints). They flatten the
batch axes into one, which the steps and the kernels take, and restore them
on every output.

``lock=True`` is frame-lock mode: once a frame decodes, the next one is
expected one frame later, so a locked stream verifies the prediction with an
n-lag probe (which also servos out +-2 samples of clock drift) and the
every-lag search runs only when some stream needs acquiring. On the card
the uncoded locked step is one merged kernel (demod_probe_fused) plus, on
acquisition, the search kernel (sync_search_fused) and the align+demod
kernel (demod_at_fused); the JAX package's ``lax.cond`` around the search
is a Python ``if`` on one host read per chunk here.

Coded configs (``fec='conv'``) need every tone's energy for the soft
decisions, so their step is unmerged: the probe kernel (probe_at_fused,
for a bfloat16 buffer as in the reference; float32 and int8 buffers take
the plain row-aligned probe) and, on acquisition, the search kernel; then
the energies kernel (demod_at_energies_fused) at the chosen start, the
max-log LLRs, the deinterleaver and the Viterbi kernel (viterbi_trellis).

Outside the reference's gate of its fused routes (128 % sps != 0:
mfsk8-audible, mfsk32-dense, custom modems at sps 40 or 480), both step
kinds slice the aligned window in ``compute_dtype`` and demodulate it with
the batch-major receiver, whose filterbank is tone_energies_fused, as the
reference does wherever it does not fuse; the locked step is then the
unmerged one. Within it the align+demod kernels take every tone count
(sps 4, 8 and 16, and past 16 tones at sps 64 and 128, on their
runtime-geometry walk). _fused_demod picks the route from the config
before any launch.

Variable-length frames (``stream_step_dynamic`` /
``receive_stream_dynamic``) read each frame's length from its header: the
geometry is sized for the maximum payload, every candidate is demodulated
over a max-length window (demod_at_fused, or demod_at_energies_fused for
coded configs with fec_interleave == 1) and parsed by the dynamic frame
parse. Three front halves: the every-lag search (one candidate a chunk),
frame lock (the probe kernel; the next start comes from the declared
length), and ``max_frames_per_chunk > 1``, which needs the quality at every
lag and so runs correlate_fused.

OFDM configs (``ofdm-fast`` and the coded presets) take the same front
halves (the search kernel, and in lock mode the probe kernel
probe_at_fused), then gather the aligned window (sync.aligned_gather) and
run the OFDM receiver on it, whose equalizer is the kernel
ofdm_track_decide_fused (and, coded, viterbi_trellis). Their clock drift is
tracked within each frame by the receiver, so ``track=True`` raises
ValueError for them, as in the reference; variable-length OFDM streams are
uncoded only.

int8 sliding buffers (``init_carry(dtype=torch.int8)``) hold the samples
quantized once at the append edge with the fixed scale INT8_STREAM_SCALE
(``quantize_int8``); a float capture quantizes up front, an int8 capture
passes through. Every receiver takes them, fixed and variable length, MFSK
and OFDM, as the reference's. The MFSK steps hand the int8 buffer itself to
the align+demod kernels (demod_probe_fused, demod_at_fused,
demod_at_energies_fused take int8) and cast only the search's segment and
the unmerged lock step's probe spans (sync.preamble_quality_probe: an int8
buffer never takes probe_at_fused) to ``compute_dtype``, exact for int8
values; the OFDM steps gather the window cast to ``compute_dtype``.
Every quality and decision is a ratio in buffer units, so the scale cancels.

``track=True`` (fixed-length MFSK, not with ``lock``) demodulates each
candidate with the symbol-clock tracker (anet_torch.dsp.clock), so frames
survive TX/RX sample-rate drift: the carry buffers ``2 * sps`` samples of
tail margin past the frame (_track_margin) and a frame is examined once that
margin has arrived. The tracker is plain PyTorch (no kernel backs it); the
search in front of it is sync_search_fused.

``resident=True`` (with ``lock=True``) is the capture-resident lock scan
(_receive_stream_resident): the whole capture is padded once and the probe,
the search and demod_at_fused read it in place at absolute positions, so no
sliding buffer is copied chunk by chunk; the frames and the final carry are
the carry path's. It measured slower than the carry path on an H100, so
``resident=None`` keeps the carry path (receive_stream).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from anet_torch._device import as_tensor, resolve_device
from anet_torch.dsp.family import preamble_template
from anet_torch.dsp.frame import DynamicFrameResult, FrameResult

__all__ = [
    "DynamicStreamStepOutput",
    "INT8_STREAM_SCALE",
    "StreamCarry",
    "StreamCheckpoint",
    "StreamResult",
    "StreamStepOutput",
    "carry_from_numpy",
    "carry_to_numpy",
    "init_carry",
    "load_carry",
    "quantize_int8",
    "receive_stream",
    "receive_stream_dynamic",
    "save_carry",
    "stream_step",
    "stream_step_dynamic",
]

# Candidate threshold for the normalized preamble correlation. Kept low:
# the demodulated-header gate (magic + CRC, 48 bits) rejects false locks.
DEFAULT_DETECT_THRESHOLD = 0.45

# Frame-lock clock-drift servo: a start offset of up to DRIFT_MAX_OBS
# samples relative to the previous frame's nominal end is clock drift and
# folds into the per-stream estimate (an EMA with gain DRIFT_EMA); larger
# gaps are real TX pauses.
DRIFT_MAX_OBS = 64
DRIFT_EMA = 0.5
# Dedupe-cursor slack: admits a compressed back-to-back successor (fast RX
# clock) while still rejecting a re-detection of the same frame.
DEDUPE_SLACK = DRIFT_MAX_OBS
PROBE_LAGS = 5  # frame-lock probe lags: +-2 samples of clock-drift servo

# int8 sliding-buffer quantization: round(x * SCALE) clipped to +-127, once
# per chunk at the append edge. The scale is fixed (not a per-chunk maximum)
# because a demod span straddles chunk boundaries. 32 covers +-3.97 of
# waveform amplitude against the transmitter's +-1 tones; the 1/64-LSB
# quantization noise sits ~36 dB under a unit tone.
INT8_STREAM_SCALE = 32.0
_BUFFER_DTYPES = (torch.float32, torch.bfloat16, torch.int8)


def quantize_int8(samples: torch.Tensor) -> torch.Tensor:
    """Float waveform samples in the int8 stream-buffer format:
    round(x * INT8_STREAM_SCALE) (half to even) clipped to +-127."""
    x = torch.round(samples.float() * INT8_STREAM_SCALE)
    return x.clamp(-127.0, 127.0).to(torch.int8)


def _ingest_cast(samples: torch.Tensor, buffer_dtype) -> torch.Tensor:
    """Samples in the sliding buffer's dtype: float samples entering an int8
    buffer quantize (a plain cast would truncate the +-1-scale waveform to
    zero); int8 samples pass through; otherwise a plain cast."""
    if buffer_dtype == torch.int8 and samples.dtype != torch.int8:
        return quantize_int8(samples)
    return samples.to(buffer_dtype)


def _demod_buffer(buffer: torch.Tensor, compute_dtype) -> torch.Tensor:
    """The buffer the align+demod kernels read: an int8 buffer as it is
    (their int8 instantiation), a float one cast to ``compute_dtype``."""
    return buffer if buffer.dtype == torch.int8 else buffer.to(compute_dtype)


class StreamCarry(NamedTuple):
    """Everything the streaming receiver remembers between chunks."""

    buffer: torch.Tensor  # [..., L] sliding sample window
    samples_seen: torch.Tensor  # int32 [...] — absolute sample count consumed
    last_frame_end: torch.Tensor  # int32 [...] — absolute end of last accepted frame
    frames_detected: torch.Tensor  # int32 [...]
    frames_ok: torch.Tensor  # int32 [...]
    decode_errors: torch.Tensor  # int32 [...] — preamble locked but integrity failed
    locked: torch.Tensor  # bool [...] — frame-lock mode: next frame start predicted
    next_start: torch.Tensor  # int32 [...] — absolute predicted start of next frame
    drift: torch.Tensor  # float32 [...] — clock-drift estimate, samples per frame


class StreamStepOutput(NamedTuple):
    """Per-chunk emission (stacked over chunks by receive_stream)."""

    frame: FrameResult
    detected: torch.Tensor  # bool — a frame completed in this chunk
    quality: torch.Tensor  # float32 — best sync quality in the window
    frame_start: torch.Tensor  # int32 — absolute sample index of frame start


class StreamResult(NamedTuple):
    carry: StreamCarry
    steps: StreamStepOutput


class StreamCheckpoint(NamedTuple):
    """A saved receiver state: the carry plus any capture tail short of a
    whole chunk (prepend it to the next capture on resume)."""

    carry: StreamCarry
    pending: np.ndarray  # float32 [..., r], r < chunk_size


def _require_supported(config, track: bool) -> None:
    from anet_torch.dsp.family import is_ofdm

    if is_ofdm(config) and track:
        raise ValueError(
            "track=True is the MFSK time-domain tracker; OFDM clock drift is "
            "handled per frame by OfdmConfig.clock_tracking (default on)"
        )


def _require_buffer_dtype(dtype) -> None:
    if dtype not in _BUFFER_DTYPES:
        raise ValueError(f"sliding buffers are float32, bfloat16 or int8, not {dtype}")


def _require_float_compute(compute_dtype) -> None:
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(
            f"compute_dtype must be float32 or bfloat16, got {compute_dtype}; for int8 "
            "buffers pass init_carry(..., dtype=torch.int8) as the carry"
        )


def _track_margin(config, track: bool) -> int:
    """Extra tail samples buffered past the nominal frame end when clock
    tracking: a slow RX clock stretches frames past frame_samples, and the
    tracker's probes read a few samples beyond the last symbol. Two symbol
    periods cover about +-2000 ppm over the longest frames plus the probe
    span. OFDM configs get none (track=True raises for them)."""
    from anet_torch.dsp.family import is_ofdm

    if not track or is_ofdm(config):
        return 0
    return 2 * config.samples_per_symbol


def _buffer_len(config, chunk_size: int, payload_len: int, track: bool = False) -> int:
    """Physical carry-buffer length: frame + chunk + tracking margin plus,
    for MFSK, the JAX package's zero tail pad for its span DMAs
    (demod_at_buffer_pad), so both packages build the same geometry and
    checkpoints move freely."""
    from anet_torch.dsp.family import frame_samples, is_ofdm
    from anet_torch.dsp.frame import data_symbols_for_payload
    from anet_torch.kernels import demod_at_buffer_pad

    live = frame_samples(config, payload_len) + chunk_size + _track_margin(config, track)
    if not is_ofdm(config) and 128 % config.samples_per_symbol == 0:
        n_symbols = data_symbols_for_payload(config, payload_len)
        live += demod_at_buffer_pad(config, n_symbols, chunk_size, live)
    return live


def _check_carry_geometry(
    config, carry: StreamCarry, chunk_size: int, payload_len: int, track: bool = False
) -> None:
    """Reject a carry built for a different chunk/payload/track geometry.
    Any length in [frame + chunk + margin, _buffer_len] is accepted:
    everything past the live window is zero tail pad, carried through
    untouched."""
    from anet_torch.dsp.family import frame_samples

    length = carry.buffer.shape[-1]
    expected = _buffer_len(config, chunk_size, payload_len, track)
    legacy = frame_samples(config, payload_len) + chunk_size + _track_margin(config, track)
    if not (legacy <= length <= expected):
        raise ValueError(
            f"carry buffer {length} != expected {expected} (or legacy {legacy}) "
            f"for frame {frame_samples(config, payload_len)} + chunk {chunk_size}; "
            "init_carry with the same chunk_size/payload_len/track"
        )


def init_carry(
    config,
    chunk_size: int,
    payload_len: int,
    batch_shape: Tuple[int, ...] = (),
    track: bool = False,
    dtype=torch.float32,
    device="cuda",
) -> StreamCarry:
    """Fresh stream state for ``batch_shape`` streams on ``device``: any
    leading shape, ``()`` for one stream, as the reference's. ``dtype`` is
    the sliding buffer's storage dtype (float32, bfloat16, or int8: chunks
    quantize at the append edge);
    receive_stream defaults it to its compute_dtype. ``track`` must match
    the receive calls: the tracking margin changes the buffer geometry."""
    _require_supported(config, track)
    _require_buffer_dtype(dtype)
    batch_shape = tuple(batch_shape)
    dev = resolve_device(device)
    length = _buffer_len(config, chunk_size, payload_len, track)
    zi = torch.zeros(batch_shape, dtype=torch.int32, device=dev)
    return StreamCarry(
        buffer=torch.zeros(*batch_shape, length, dtype=dtype, device=dev),
        samples_seen=zi,
        last_frame_end=zi,
        frames_detected=zi,
        frames_ok=zi,
        decode_errors=zi,
        locked=torch.zeros(batch_shape, dtype=torch.bool, device=dev),
        next_start=zi,
        drift=torch.zeros(batch_shape, dtype=torch.float32, device=dev),
    )


def _flatten_carry(carry: StreamCarry) -> Tuple[StreamCarry, Tuple[int, ...]]:
    """(the carry with its leading batch axes flattened into one, those
    axes): the steps and the kernels below the entry points take [B, ...]."""
    batch_shape = tuple(carry.samples_seen.shape)
    n = len(batch_shape)
    return StreamCarry(*(f.reshape((-1, *f.shape[n:])) for f in carry)), batch_shape


def _unflatten(tree, batch_shape: Tuple[int, ...], axis: int = 0):
    """A carry or step output (NamedTuples of tensors, nested) with the flat
    batch axis at ``axis`` of every tensor restored to ``batch_shape``."""
    if isinstance(tree, torch.Tensor):
        return tree.reshape((*tree.shape[:axis], *batch_shape, *tree.shape[axis + 1 :]))
    return type(tree)(*(_unflatten(f, batch_shape, axis) for f in tree))


def _flat_chunk(chunk: torch.Tensor, batch_shape: Tuple[int, ...]) -> torch.Tensor:
    """A chunk [..., chunk_size] as [B, chunk_size]; its batch axes must be
    the carry's."""
    if tuple(chunk.shape[:-1]) != batch_shape:
        raise ValueError(
            f"chunk batch shape {tuple(chunk.shape[:-1])} != the carry's {batch_shape}"
        )
    return chunk.reshape(-1, chunk.shape[-1])


def _drift_round(drift: torch.Tensor) -> torch.Tensor:
    """The integer prediction offset implied by the drift estimate
    (round half to even, as jnp.round)."""
    return torch.round(drift).to(torch.int32)


def _drift_update(carry: StreamCarry, detected: torch.Tensor, start_abs: torch.Tensor) -> torch.Tensor:
    """Fold this frame's observed start offset into the drift estimate:
    only detections continuing a chain (last_frame_end > 0) within
    DRIFT_MAX_OBS samples of the previous nominal end update it."""
    obs = (start_abs - carry.last_frame_end).to(torch.float32)
    valid = detected & (carry.last_frame_end > 0) & (obs.abs() <= DRIFT_MAX_OBS)
    return torch.where(valid, carry.drift + DRIFT_EMA * (obs - carry.drift), carry.drift)


def _slide_buffer(carry: StreamCarry, chunk: torch.Tensor, t_frame: int, margin: int):
    """Slide the carry buffer one chunk. Returns (buffer, samples_seen, w0,
    buffer_abs0): [w0, w0 + chunk_size) are the just-completed frame starts,
    and buffer_abs0 is the absolute index of buffer[0]. Any length past
    frame + chunk + margin is zero tail pad, carried through untouched."""
    chunk_size = chunk.shape[-1]
    length = carry.buffer.shape[-1]
    live = t_frame + chunk_size + margin
    if length < live:
        raise ValueError(
            f"carry buffer {length} < frame {t_frame} + chunk {chunk_size} + margin {margin}"
        )
    buffer = torch.cat(
        [
            carry.buffer[..., chunk_size:live],
            _ingest_cast(chunk, carry.buffer.dtype),
            carry.buffer[..., live:],
        ],
        dim=-1,
    )
    samples_seen = carry.samples_seen + chunk_size
    buffer_abs0 = samples_seen - live
    w0 = 1  # = live - t_frame - chunk_size - margin + 1
    return buffer, samples_seen, w0, buffer_abs0


def _template_energy(t_c: torch.Tensor) -> torch.Tensor:
    return (t_c.float() ** 2).sum()


@functools.lru_cache(maxsize=16)
def _templates(config, compute_dtype, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the preamble template in float32, the same in ``compute_dtype``),
    made once per config, dtype and device: the same tensors every chunk,
    so the kernels make their template operands (the search's words, the
    int8 probe's taps) once."""
    template = preamble_template(config, device)
    return template, template.to(compute_dtype)


def _search_best(carry, chunk, t_frame: int, template, t_c, margin: int, compute_dtype):
    """Slide + every-lag preamble search (sync_search_fused) with the
    template in ``compute_dtype`` (``t_c``), returning the per-stream best:
    (buffer, samples_seen, w0, buffer_abs0, best_q, best_rel)."""
    from anet_torch.kernels import sync_search_fused

    chunk_size = chunk.shape[-1]
    k = template.shape[-1]
    buffer, samples_seen, w0, buffer_abs0 = _slide_buffer(carry, chunk, t_frame, margin)
    seg = buffer[..., w0 : w0 + chunk_size + k - 1].to(compute_dtype)
    best_q, best_rel = sync_search_fused(seg, t_c, chunk_size, (template * template).sum())
    return buffer, samples_seen, w0, buffer_abs0, best_q, best_rel


def _find_candidate(carry, chunk, t_frame, template, t_c, margin, detect_threshold, compute_dtype):
    """Slide, search, and nominate at most one candidate frame start per
    chunk: (buffer, samples_seen, start_idx, start_abs, best_q, candidate)."""
    buffer, samples_seen, w0, buffer_abs0, best_q, best_rel = _search_best(
        carry, chunk, t_frame, template, t_c, margin, compute_dtype
    )
    start_idx = w0 + best_rel
    start_abs = buffer_abs0 + start_idx
    no_overlap = start_abs >= carry.last_frame_end - DEDUPE_SLACK
    candidate = (best_q >= detect_threshold) & no_overlap
    return buffer, samples_seen, start_idx, start_abs, best_q, candidate


def _lock_prediction(carry, buffer_abs0, w0: int, chunk_size: int):
    """(pred_idx, in_win, mid_flight): the stored prediction as a buffer
    index; whether it lies in this chunk's window; whether it lies beyond it
    (the stream keeps its lock without a candidate this chunk)."""
    pred_idx = carry.next_start - buffer_abs0
    in_win = carry.locked & (pred_idx >= w0) & (pred_idx < w0 + chunk_size)
    mid_flight = carry.locked & (pred_idx >= w0 + chunk_size)
    return pred_idx, in_win, mid_flight


def _probe_base(probe_at: torch.Tensor, buffer_len: int, k: int) -> torch.Tensor:
    """First of the PROBE_LAGS lags probed around ``probe_at``, kept inside
    the buffer (sync.preamble_quality_probe's st0)."""
    return (probe_at - PROBE_LAGS // 2).clamp(0, buffer_len - k - PROBE_LAGS + 1)


def _probe_kernel_supported(carry: StreamCarry) -> bool:
    """The probe kernel (probe_at_fused) serves the unmerged lock step when
    the buffer is on the card (and bfloat16: _probe_kernel_dtype)."""
    return carry.buffer.is_cuda


def _probe_kernel_dtype(buffer: torch.Tensor) -> bool:
    """The reference takes its probe kernel for bfloat16 buffers only: its
    energy span is st0-aligned. float32 and int8 buffers take
    sync.preamble_quality_probe, whose span is row-aligned, so their
    quality (and the lock gate on it) is the reference's."""
    return buffer.dtype == torch.bfloat16


def _find_candidate_locked(carry, chunk, t_frame, t_c, t_energy, detect_threshold, compute_dtype):
    """Unmerged frame-lock front half with the template in ``compute_dtype``
    (``t_c``) and its energy (``t_energy``, a tensor on the buffer's device:
    _lock_template's, made once): probe the predicted next start (on the
    card and for a bfloat16 buffer the probe kernel probe_at_fused, which
    reads the energy on the card, else sync.preamble_quality_probe, as the
    reference routes them) and search every lag only when some stream needs
    acquiring, the one host read of a chunk. Returns (buffer, samples_seen,
    start_idx, start_abs, quality, candidate, mid_flight)."""
    from anet_torch.dsp.sync import preamble_quality_probe
    from anet_torch.kernels import probe_at_fused, sync_search_fused

    chunk_size = chunk.shape[-1]
    k = t_c.shape[-1]
    buffer, samples_seen, w0, buffer_abs0 = _slide_buffer(carry, chunk, t_frame, 0)
    length = t_frame + chunk_size
    pred_idx, in_win, mid_flight = _lock_prediction(carry, buffer_abs0, w0, chunk_size)
    probe_at = pred_idx.clamp(0, length - t_frame)
    if _probe_kernel_supported(carry) and _probe_kernel_dtype(buffer):
        st0 = _probe_base(probe_at, buffer.shape[-1], k)
        q5 = probe_at_fused(buffer, st0, t_c, t_energy, n_lags=PROBE_LAGS)
    else:
        q5, st0 = preamble_quality_probe(
            buffer, probe_at, t_c, t_energy, n_lags=PROBE_LAGS, compute_dtype=compute_dtype
        )
    probe_q = q5.amax(-1)
    probe_off = torch.argmax(q5, dim=-1).to(torch.int32)
    pred_valid = in_win & (probe_q >= detect_threshold)

    if bool((~(pred_valid | mid_flight)).any()):  # one host read per chunk
        seg = buffer[..., w0 : w0 + chunk_size + k - 1].to(compute_dtype)
        best_q, best_rel = sync_search_fused(seg, t_c, chunk_size, t_energy)
    else:
        best_q = torch.zeros_like(probe_q)
        best_rel = torch.zeros_like(probe_off)

    start_idx = torch.where(pred_valid, st0 + probe_off, w0 + best_rel)
    start_abs = buffer_abs0 + start_idx
    quality = torch.where(pred_valid, probe_q, best_q)
    searched_ok = (best_q >= detect_threshold) & (
        (buffer_abs0 + w0 + best_rel) >= carry.last_frame_end - DEDUPE_SLACK
    )
    candidate = pred_valid | (~mid_flight & searched_ok)
    return buffer, samples_seen, start_idx, start_abs, quality, candidate, mid_flight


def _merged_lock_supported(config, carry: StreamCarry) -> bool:
    """The merged probe + demod kernel serves the uncoded locked step when
    the buffer is on the card, within the reference's gate of its fused
    routes (kernels._demod_at_geometry: 128 % sps == 0, where the kernels
    take every tone count). (A coded frame's soft decisions need every
    tone's energy, which the merged kernel does not write; OFDM has no
    merged kernel.)"""
    from anet_torch.dsp.family import is_ofdm
    from anet_torch.kernels import _demod_at_geometry

    return (
        carry.buffer.is_cuda
        and not is_ofdm(config)
        and config.fec == "none"
        and _demod_at_geometry(config)
    )


def _fused_demod(config) -> bool:
    """Whether the stream steps demodulate a candidate with the align+demod
    kernels, which read the buffer at the start (demod_at_fused, or
    demod_at_energies_fused for coded frames): MFSK within the reference's
    gate of its fused routes (kernels._demod_at_geometry: 128 % sps == 0),
    from the config alone, never from a launch's error. Otherwise the
    aligned window is sliced in ``compute_dtype`` and demodulated by
    aligned_demod_fn / aligned_demod_dynamic_fn: the OFDM receiver, or the
    batch-major MFSK one (its filterbank tone_energies_fused), as the
    reference does wherever it does not fuse."""
    from anet_torch.dsp.family import is_ofdm
    from anet_torch.kernels import _demod_at_geometry

    return not is_ofdm(config) and _demod_at_geometry(config)


def _next_carry(carry, buffer, samples_seen, detected, frame, start_abs, t_frame, lock, mid_flight):
    """The carry after a step: dedupe cursor, counters and (in lock mode)
    the lock, drift estimate and predicted next start."""
    if lock:
        locked_new = detected | mid_flight
        drift_new = _drift_update(carry, detected, start_abs)
        next_start_new = torch.where(
            detected, start_abs + t_frame + _drift_round(drift_new), carry.next_start
        )
    else:
        locked_new, next_start_new, drift_new = carry.locked, carry.next_start, carry.drift
    return StreamCarry(
        buffer=buffer,
        samples_seen=samples_seen,
        last_frame_end=torch.where(detected, start_abs + t_frame, carry.last_frame_end),
        frames_detected=carry.frames_detected + detected.to(torch.int32),
        frames_ok=carry.frames_ok + frame.ok.to(torch.int32),
        decode_errors=carry.decode_errors + (detected & ~frame.ok).to(torch.int32),
        locked=locked_new,
        next_start=next_start_new.to(torch.int32),
        drift=drift_new,
    )


@functools.lru_cache(maxsize=16)
def _lock_template(config, compute_dtype, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the preamble template in ``compute_dtype``, its energy) of the
    locked steps, made once per config, dtype and device."""
    t_c = _templates(config, compute_dtype, device)[1]
    return t_c, _template_energy(t_c)


def _locked_step_merged(
    config, carry, chunk, payload_len, detect_threshold, compute_dtype, t_frame
) -> Tuple[StreamCarry, StreamStepOutput]:
    """The locked stream step on the card: ONE merged kernel
    (demod_probe_fused) probes the predicted start, servos the drift and
    demodulates there; on acquisition (any stream unlocked, expired, or
    failing its probe) the search kernel (sync_search_fused) and one
    align+demod (demod_at_fused) at the searched starts run as well.
    Decoded frames are identical to _find_candidate_locked's path. An int8
    buffer goes to both demod kernels as it is; only the search's segment
    is cast to ``compute_dtype``."""
    from anet_torch.dsp.frame import data_symbols_for_payload, frame_result_from_tone_decisions
    from anet_torch.kernels import demod_at_fused, demod_probe_fused, sync_search_fused

    chunk_size = chunk.shape[-1]
    t_c, t_energy = _lock_template(config, compute_dtype, carry.buffer.device)
    k = t_c.shape[-1]
    n_symbols = data_symbols_for_payload(config, payload_len)
    buffer, samples_seen, w0, buffer_abs0 = _slide_buffer(carry, chunk, t_frame, 0)
    buf_d = _demod_buffer(buffer, compute_dtype)
    length = t_frame + chunk_size
    pred_idx, in_win, mid_flight = _lock_prediction(carry, buffer_abs0, w0, chunk_size)
    probe_at = pred_idx.clamp(0, length - t_frame)
    st0 = _probe_base(probe_at, buffer.shape[-1], k)
    cmax, probe_off, energy, tone_p, best_p, total_p = demod_probe_fused(
        config, buf_d, st0, n_symbols, t_c, n_lags=PROBE_LAGS
    )
    probe_q = cmax * torch.rsqrt(t_energy * torch.maximum(energy, 1e-4 * t_energy))
    refined_idx = st0 + probe_off
    pred_valid = in_win & (probe_q >= detect_threshold)

    if bool((~(pred_valid | mid_flight)).any()):  # one host read per chunk
        seg = buffer[..., w0 : w0 + chunk_size + k - 1].to(compute_dtype)
        bq, br = sync_search_fused(seg, t_c, chunk_size, t_energy)
        sel_idx = torch.where(pred_valid, refined_idx, w0 + br)
        tone_s, best_s, total_s = demod_at_fused(config, buf_d, sel_idx, n_symbols)
    else:
        bq = torch.zeros_like(probe_q)
        br = torch.zeros_like(probe_off)
        tone_s = torch.zeros_like(tone_p)
        best_s = torch.zeros_like(best_p)
        total_s = torch.zeros_like(total_p)
    start_idx = torch.where(pred_valid, refined_idx, w0 + br)
    start_abs = buffer_abs0 + start_idx
    quality = torch.where(pred_valid, probe_q, bq)
    searched_ok = (bq >= detect_threshold) & (
        (buffer_abs0 + w0 + br) >= carry.last_frame_end - DEDUPE_SLACK
    )
    candidate = pred_valid | (~mid_flight & searched_ok)

    pv = pred_valid[..., None]
    frame = frame_result_from_tone_decisions(
        config,
        torch.where(pv, tone_p, tone_s),
        torch.where(pv, best_p, best_s),
        torch.where(pv, total_p, total_s),
        payload_len,
    )
    detected = candidate & frame.magic_ok & frame.header_crc_ok
    frame = frame._replace(ok=frame.ok & detected)
    new_carry = _next_carry(
        carry, buffer, samples_seen, detected, frame, start_abs, t_frame, True, mid_flight
    )
    out = StreamStepOutput(
        frame=frame, detected=detected, quality=quality, frame_start=start_abs.to(torch.int32)
    )
    return new_carry, out


def stream_step(
    config,
    carry: StreamCarry,
    chunk: torch.Tensor,
    payload_len: int,
    detect_threshold: float = DEFAULT_DETECT_THRESHOLD,
    compute_dtype=torch.float32,
    track: bool = False,
    lock: bool = False,
) -> Tuple[StreamCarry, StreamStepOutput]:
    """Consume one chunk [..., chunk_size] (on the carry's device, its batch
    axes the carry's); maybe emit one frame per stream.

    ``track=True`` demodulates each candidate frame with the symbol-clock
    tracker (MFSK only: sequential over symbols, so slower, but frames
    survive TX/RX sample-rate drift; the carry must come from
    init_carry(track=True)). ``lock=True`` enables frame-lock mode (see the
    module docstring): decoded frames are identical to the always-search
    mode; per-chunk ``quality`` comes from the probe while locked and
    ``frame_start`` can differ by the +-2-sample drift servo. The two do not
    compose (ValueError). A detection counts only if the demodulated header
    validates (magic word + header CRC)."""
    flat, batch_shape = _flatten_carry(carry)
    new_carry, out = _stream_step(
        config, flat, _flat_chunk(chunk, batch_shape), payload_len, detect_threshold,
        compute_dtype, track, lock,
    )
    return _unflatten(new_carry, batch_shape), _unflatten(out, batch_shape)


def _stream_step(
    config, carry, chunk, payload_len: int, detect_threshold, compute_dtype, track: bool, lock: bool
) -> Tuple[StreamCarry, StreamStepOutput]:
    """stream_step on a flat batch: carry fields [B, ...], chunk [B, chunk_size]."""
    from anet_torch.dsp.demod import decide_symbols
    from anet_torch.dsp.family import aligned_demod_fn, frame_samples
    from anet_torch.dsp.frame import (
        data_symbols_for_payload,
        frame_result_from_decisions,
        frame_result_from_tone_decisions,
    )
    from anet_torch.kernels import demod_at_energies_fused, demod_at_fused

    _require_supported(config, track)
    if lock and track:
        raise ValueError(
            "lock=True does not compose with track=True (the clock tracker "
            "already re-times each frame)"
        )
    _require_float_compute(compute_dtype)
    chunk_size = chunk.shape[-1]
    t_frame = frame_samples(config, payload_len)
    template, t_c = _templates(config, compute_dtype, carry.buffer.device)
    _check_carry_geometry(config, carry, chunk_size, payload_len, track)
    if lock and _merged_lock_supported(config, carry):
        return _locked_step_merged(
            config, carry, chunk, payload_len, detect_threshold, compute_dtype, t_frame
        )
    margin = _track_margin(config, track)
    mid_flight = None
    if lock:
        t_energy = _lock_template(config, compute_dtype, carry.buffer.device)[1]
        buffer, samples_seen, start_idx, start_abs, best_q, candidate, mid_flight = (
            _find_candidate_locked(carry, chunk, t_frame, t_c, t_energy, detect_threshold, compute_dtype)
        )
    else:
        buffer, samples_seen, start_idx, start_abs, best_q, candidate = _find_candidate(
            carry, chunk, t_frame, template, t_c, margin, detect_threshold, compute_dtype
        )
    if track:
        from anet_torch.dsp.clock import tracked_frame_result

        # the window includes the margin tail: slow-clock frames stretch past
        # t_frame; an int8 slice widens exactly in the tracker's lerp
        aligned = _batched_dynamic_slice(buffer, start_idx, t_frame + margin, compute_dtype)
        frame, _ = tracked_frame_result(
            config, aligned, payload_len, float(config.preamble_samples), compute_dtype=compute_dtype
        )
    elif not _fused_demod(config):
        # the aligned window, then the OFDM receiver (its equalizer kernel),
        # or, where the align+demod kernels do not take the geometry, the
        # batch-major MFSK receiver (an int8 slice widens exactly)
        demod = aligned_demod_fn(config, payload_len, compute_dtype, carry.buffer.device)
        frame = demod(_batched_dynamic_slice(buffer, start_idx, t_frame, compute_dtype))
    else:
        n_symbols = data_symbols_for_payload(config, payload_len)
        if config.fec == "conv":
            # soft FEC decisions need every tone's energy, not just the
            # winner: energies -> LLRs -> deinterleave -> Viterbi, as the
            # aligned coded receiver; only the gather of the aligned frame
            # disappears
            energies = demod_at_energies_fused(
                config, _demod_buffer(buffer, compute_dtype), start_idx, n_symbols
            )
            frame = frame_result_from_decisions(
                config, decide_symbols(config, energies), energies, payload_len
            )
        else:
            tone, best, total = demod_at_fused(
                config, _demod_buffer(buffer, compute_dtype), start_idx, n_symbols
            )
            frame = frame_result_from_tone_decisions(config, tone, best, total, payload_len)
    detected = candidate & frame.magic_ok & frame.header_crc_ok
    frame = frame._replace(ok=frame.ok & detected)
    new_carry = _next_carry(
        carry, buffer, samples_seen, detected, frame, start_abs, t_frame, lock, mid_flight
    )
    out = StreamStepOutput(
        frame=frame, detected=detected, quality=best_q, frame_start=start_abs.to(torch.int32)
    )
    return new_carry, out


def _stack_steps(steps):
    """Stack per-chunk outputs along a leading chunk axis (the scan layout
    of the JAX package's StreamResult.steps)."""
    frame = type(steps[0].frame)(*(torch.stack(f) for f in zip(*(s.frame for s in steps))))
    rest = (torch.stack(f) for f in list(zip(*steps))[1:])
    return type(steps[0])(frame, *rest)


def _capture_chunks(capture, chunk_size: int, device):
    """The capture as a [..., N] tensor on ``device`` and its chunk count."""
    capture = as_tensor(capture, device)
    if capture.dim() == 0:
        raise ValueError("capture must be [..., N], got a scalar")
    n = capture.shape[-1]
    if n == 0 or n % chunk_size:
        raise ValueError(f"capture length {n} not a positive multiple of chunk_size {chunk_size}")
    return capture, n // chunk_size


def _resume_or_init(
    config, carry, capture, chunk_size: int, payload_len: int, compute_dtype, track: bool = False
):
    """The caller's carry (checked to lie with the capture and to have its
    batch axes) or a fresh one with a ``compute_dtype`` buffer, its batch
    axes flattened into one (_flatten_carry)."""
    _require_float_compute(compute_dtype)
    batch_shape = tuple(capture.shape[:-1])
    if carry is None:
        carry = init_carry(
            config, chunk_size, payload_len, batch_shape, track, dtype=compute_dtype,
            device=capture.device,
        )
    elif carry.buffer.device != capture.device:
        raise ValueError(f"carry lies on {carry.buffer.device}, capture on {capture.device}")
    flat, carry_shape = _flatten_carry(carry)
    if carry_shape != batch_shape:
        raise ValueError(f"carry batch shape {carry_shape} != the capture's {batch_shape}")
    return flat


def receive_stream(
    config,
    capture,
    chunk_size: int,
    payload_len: int,
    detect_threshold: float = DEFAULT_DETECT_THRESHOLD,
    carry: StreamCarry | None = None,
    compute_dtype=torch.float32,
    track: bool = False,
    lock: bool = False,
    resident: bool | None = None,
    device="cuda",
) -> StreamResult:
    """Run a capture [..., N] through the receiver chunk by chunk on
    ``device``, emitting every frame found.

    N must be a multiple of chunk_size (pad with zeros host-side). ``carry``
    resumes a previous state (checkpoint/resume; it must lie on ``device``
    and have the capture's batch axes); a fresh one is built if None, with a
    ``compute_dtype`` buffer. The capture is cast to the buffer's dtype
    once, up front: into an int8 carry a float capture quantizes
    (quantize_int8) and an int8 capture passes through. Returns the final
    carry and the per-chunk outputs stacked along a leading chunk axis
    (steps.detected is [num_chunks, ...]).

    ``track=True`` demodulates every candidate with the symbol-clock tracker
    (stream_step); ``lock=True`` is frame-lock mode. ``resident=True``
    (needs ``lock=True``) takes the capture-resident lock scan
    (_receive_stream_resident): the same frames and final carry without
    sliding the capture through the carry buffer. It needs a CUDA device,
    uncoded MFSK whose sps the kernels take, bfloat16 compute and no
    tracking (ValueError otherwise; the JAX package likewise refuses every
    backend but its TPU). A caller's carry is then read for its counters and
    lock only: its buffer is taken as all-zero history (init_carry's state,
    or a warm-lock seed), so resuming a mid-stream checkpoint needs
    ``resident=False``. ``resident=None`` (auto) is the carry path: the JAX
    package's auto rule takes the resident scan on its TPU backend only, and
    on an H100 (80GB HBM3, 700 W) the resident scan measured slower than the
    carry path in one run at the locked stream's geometry (mfsk16-fast,
    payload 256, B = 8,192, 7 chunks, bf16; ``python -m
    anet_torch.profile_stream mfsk16-fast resident``): device time 26.7
    against 20.1 ms warm and 32.0 against 26.3 ms cold, wall 49.6-59.9
    against 44.3-59.4 ms warm and 78.8-93.5 against 57.2-58.0 ms cold. Its
    pad copy and its plain row-aligned probe cost more device time than the
    slide's copies it saves."""
    _require_supported(config, track)
    capture, num_chunks = _capture_chunks(capture, chunk_size, device)
    batch_shape = tuple(capture.shape[:-1])
    if resident:
        if not lock:
            raise ValueError("resident=True requires lock=True")
        if not _resident_supported(config, compute_dtype, track, capture.device):
            raise ValueError(
                "resident=True needs the fused-demod geometry: a CUDA device, uncoded "
                "MFSK with 128 % samples_per_symbol == 0, bfloat16 compute, no tracking"
            )
        if carry is not None:
            carry = _resume_or_init(config, carry, capture, chunk_size, payload_len, compute_dtype)
        res = _receive_stream_resident(
            config, capture.reshape(-1, capture.shape[-1]), chunk_size, payload_len,
            detect_threshold, compute_dtype, carry,
        )
        return StreamResult(
            carry=_unflatten(res.carry, batch_shape), steps=_unflatten(res.steps, batch_shape, 1)
        )
    carry = _resume_or_init(config, carry, capture, chunk_size, payload_len, compute_dtype, track)
    cap = _ingest_cast(capture, carry.buffer.dtype).reshape(-1, num_chunks, chunk_size)
    steps = []
    for i in range(num_chunks):
        carry, out = _stream_step(
            config, carry, cap[:, i], payload_len, detect_threshold, compute_dtype, track, lock
        )
        steps.append(out)
    return StreamResult(
        carry=_unflatten(carry, batch_shape), steps=_unflatten(_stack_steps(steps), batch_shape, 1)
    )


def _resident_supported(config, compute_dtype, track: bool, device: torch.device) -> bool:
    """The capture-resident lock scan needs the align+demod kernel
    (demod_at_fused) on the card: a CUDA device, uncoded MFSK within the
    JAX package's gate (kernels._demod_at_geometry: 128 % sps == 0, every
    tone count), bfloat16 compute, and no symbol-clock tracking."""
    from anet_torch.dsp.family import is_ofdm
    from anet_torch.kernels import _demod_at_geometry

    return (
        device.type == "cuda"
        and not is_ofdm(config)
        and config.fec == "none"
        and _demod_at_geometry(config)
        and compute_dtype == torch.bfloat16
        and not track
    )


def _receive_stream_resident(
    config,
    capture: torch.Tensor,
    chunk_size: int,
    payload_len: int,
    detect_threshold: float,
    compute_dtype,
    carry: StreamCarry | None,
) -> StreamResult:
    """Capture-resident frame-lock scan of a flat capture [B, N] (the JAX
    package's _receive_stream_resident, line for line).

    The chunked carry models a receiver that sees one chunk at a time; with
    the whole capture in hand, sliding it chunk by chunk through a carry
    buffer only copies. Here the capture is padded once (t_frame zeros of
    history on the left, the zero-initialized carry buffer's state, and the
    JAX package's demod span pad on the right, the total rounded to 128):
    padded index p = stream-absolute index + t_frame, and buffer index b of
    step i is padded index i * chunk_size + b. Each chunk then probes the
    predicted starts on a window slice of the padded capture (the plain
    row-aligned sync.preamble_quality_probe, as the JAX package's scan:
    never probe_at_fused or demod_probe_fused), searches its
    just-completed starts with sync_search_fused on a strided view when
    some stream needs acquiring (the one host read of a chunk, in place of
    ``lax.cond``), and demodulates every stream with demod_at_fused on the
    whole padded capture. Candidate windows, dedupe, probe clipping and the
    lock updates are _find_candidate_locked's. The returned carry
    materializes the sliding buffer (the capture's tail), so
    checkpoint/resume continues on the carry path.

    ``carry`` None starts fresh; a given carry (flat, on the capture's
    device) supplies counters and lock, and its buffer is taken as zeros.
    Positions and starts stay below 2**31; every flat index into the padded
    capture (B * length, about 2.4e9 at B = 8,192 and 7 chunks) is 64-bit in
    the plain versions' gathers and in the kernels. receive_stream's auto
    rule does not take this path: see its docstring for the measurement."""
    from anet_torch.dsp.family import frame_samples
    from anet_torch.dsp.frame import data_symbols_for_payload, frame_result_from_tone_decisions
    from anet_torch.dsp.sync import preamble_quality_probe
    from anet_torch.kernels import demod_at_buffer_pad, demod_at_fused, sync_search_fused

    b, n = capture.shape
    num_chunks = n // chunk_size
    dev = capture.device
    t_frame = frame_samples(config, payload_len)
    if chunk_size > t_frame:
        raise ValueError("resident scan needs chunk_size <= frame length")
    t_c, t_energy = _lock_template(config, compute_dtype, dev)
    k = t_c.shape[-1]
    n_symbols = data_symbols_for_payload(config, payload_len)
    if carry is None:
        zi = torch.zeros(b, dtype=torch.int32, device=dev)
        carry = StreamCarry(
            buffer=None, samples_seen=zi, last_frame_end=zi, frames_detected=zi, frames_ok=zi,
            decode_errors=zi, locked=torch.zeros(b, dtype=torch.bool, device=dev), next_start=zi,
            drift=torch.zeros(b, dtype=torch.float32, device=dev),
        )
    else:
        _check_carry_geometry(config, carry, chunk_size, payload_len)

    # One pad: t_frame zeros on the left, the demod span pad on the right (its
    # start bound covers probe-refined starts, whose window clip can land
    # about 4 * 128 past n), rounded to 128.
    bound_p = n + 512
    right = demod_at_buffer_pad(config, n_symbols, start_bound=bound_p, live_length=t_frame + n)
    right = max(right, k + 4 * 128)
    right += (-(t_frame + n + right)) % 128
    xcap = torch.empty(b, t_frame + n + right, dtype=compute_dtype, device=dev)
    xcap[:, :t_frame] = 0
    xcap[:, t_frame : t_frame + n] = capture
    xcap[:, t_frame + n :] = 0
    wlen = chunk_size + k + 4 * 128  # probe window: every clipped probe position of a step

    c = carry
    steps = []
    for i in range(num_chunks):
        w0p = i * chunk_size + 1  # padded index of the window's first start
        pred_p = c.next_start + t_frame  # stored drift-adjusted
        in_win = c.locked & (pred_p >= w0p) & (pred_p < w0p + chunk_size)
        mid_flight = c.locked & (pred_p >= w0p + chunk_size)

        # probe on a window slice (positions outside it belong to streams
        # whose probe result is ignored)
        base0 = max(w0p - 128, 0)
        win = xcap[:, base0 : base0 + wlen]
        probe_at = (pred_p - base0).clamp(0, chunk_size + 256)
        q5, st0w = preamble_quality_probe(
            win, probe_at, t_c, t_energy, n_lags=PROBE_LAGS, compute_dtype=compute_dtype,
            start_bound=chunk_size + 256,
        )
        st0_p = base0 + st0w
        probe_q = q5.amax(-1)
        probe_off = torch.argmax(q5, dim=-1).to(torch.int32)
        pred_valid = in_win & (probe_q >= detect_threshold)

        if bool((~(pred_valid | mid_flight)).any()):  # one host read per chunk
            seg = xcap[:, w0p : w0p + chunk_size + k - 1]
            best_q, best_rel = sync_search_fused(seg, t_c, chunk_size, t_energy)
        else:
            best_q = torch.zeros_like(probe_q)
            best_rel = torch.zeros_like(probe_off)

        start_p = torch.where(pred_valid, st0_p + probe_off, w0p + best_rel)
        start_abs = start_p - t_frame
        quality = torch.where(pred_valid, probe_q, best_q)
        searched_ok = (best_q >= detect_threshold) & (
            (w0p + best_rel - t_frame) >= c.last_frame_end - DEDUPE_SLACK
        )
        candidate = pred_valid | (~mid_flight & searched_ok)

        tone, best, total = demod_at_fused(config, xcap, start_p, n_symbols)
        frame = frame_result_from_tone_decisions(config, tone, best, total, payload_len)
        detected = candidate & frame.magic_ok & frame.header_crc_ok
        frame = frame._replace(ok=frame.ok & detected)
        c = _next_carry(
            c, c.buffer, c.samples_seen + chunk_size, detected, frame, start_abs, t_frame, True,
            mid_flight,
        )
        steps.append(StreamStepOutput(
            frame=frame, detected=detected, quality=quality, frame_start=start_abs.to(torch.int32)
        ))

    # the sliding buffer the carry path would hold now: the capture's last
    # frame + chunk samples, then the zero tail pad
    live = t_frame + chunk_size
    buffer = torch.zeros(b, _buffer_len(config, chunk_size, payload_len), dtype=compute_dtype, device=dev)
    buffer[:, :live] = xcap[:, n + t_frame - live : n + t_frame]
    return StreamResult(carry=c._replace(buffer=buffer), steps=_stack_steps(steps))


def _slide_and_quality(carry, chunk, t_frame: int, template, t_c, margin: int, compute_dtype):
    """Slide the buffer one chunk and score EVERY just-completed frame
    start: (buffer, samples_seen, w0, buffer_abs0, quality), quality float32
    [B, chunk_size], the blockwise-normalized preamble match at starts
    [w0, w0 + chunk_size). The correlation at every lag is the kernel
    correlate_fused. This materializing form serves the multi-candidate
    dynamic step, which masks the quality array between picks;
    single-candidate callers use _search_best."""
    from anet_torch.dsp.sync import blockwise_match_quality
    from anet_torch.kernels import correlate_fused

    chunk_size = chunk.shape[-1]
    k = template.shape[-1]
    buffer, samples_seen, w0, buffer_abs0 = _slide_buffer(carry, chunk, t_frame, margin)
    seg = buffer[..., w0 : w0 + chunk_size + k - 1].to(compute_dtype)
    corr = correlate_fused(seg, t_c, chunk_size)
    quality = blockwise_match_quality(seg, corr, k, (template * template).sum())
    return buffer, samples_seen, w0, buffer_abs0, quality


def _batched_dynamic_slice(buffer, start, size: int, compute_dtype=None):
    """Slice ``size`` samples at per-stream starts (sync.aligned_gather)."""
    from anet_torch.dsp.sync import aligned_gather

    return aligned_gather(buffer, start, size, compute_dtype)


class DynamicStreamStepOutput(NamedTuple):
    """Per-chunk emission of the variable-length stream receiver."""

    frame: DynamicFrameResult
    detected: torch.Tensor  # bool — a frame completed in this chunk
    quality: torch.Tensor  # float32 — best sync quality in the window
    frame_start: torch.Tensor  # int32 — absolute sample index of frame start


def stream_step_dynamic(
    config,
    carry: StreamCarry,
    chunk: torch.Tensor,
    max_payload_len: int,
    detect_threshold: float = DEFAULT_DETECT_THRESHOLD,
    compute_dtype=torch.float32,
    max_frames_per_chunk: int = 1,
    lock: bool = False,
) -> Tuple[StreamCarry, DynamicStreamStepOutput]:
    """stream_step with the payload length read from each frame's header:
    one chunk [..., chunk_size], its batch axes the carry's.

    Geometry (buffer size, detection latency) is sized for
    ``max_payload_len`` (init_carry with payload_len = max_payload_len);
    short frames decode as soon as a max-length window past their start is
    buffered, and the dedupe cursor advances by each frame's declared
    length. Coded configs need fec_interleave == 1 (the header probe +
    masked trellis of frame.frame_result_from_llrs_dynamic).

    ``max_frames_per_chunk`` = K: how many non-overlapping candidates to
    extract per chunk. Candidates are extracted best-quality-first and
    masked against each accepted frame's actual extent, so a step's K
    emissions are in quality order, not time order. With K > 1 every field
    of the step output gains a leading axis of size K. A frame whose header
    declares a length above ``max_payload_len`` is skipped (its gate fails
    ``length_ok``).

    ``lock=True`` (K = 1 only) is frame lock for dynamic frames: the
    CRC-protected header declares each frame's length, so the next start is
    ``start + dynamic_frame_samples(length)``. Locked streams verify the
    prediction with the probe (+-2-sample servo); the every-lag search runs
    only when some stream needs acquiring, after one host read per chunk.

    Every MFSK candidate at the align+demod kernels' geometry (sps 32, 64
    or 128, at most 16 tones) is demodulated by them whatever the buffer's
    dtype (demod_at_fused for uncoded, demod_at_energies_fused for coded
    configs; an int8 buffer goes to their int8 instantiation as it is), as
    in stream_step; at any other geometry, and for OFDM (uncoded only), the
    candidate's max-length window is gathered in ``compute_dtype`` and
    demodulated by the batch-major receiver (_fused_demod)."""
    flat, batch_shape = _flatten_carry(carry)
    new_carry, out = _stream_step_dynamic(
        config, flat, _flat_chunk(chunk, batch_shape), max_payload_len, detect_threshold,
        compute_dtype, max_frames_per_chunk, lock,
    )
    return (
        _unflatten(new_carry, batch_shape),
        _unflatten(out, batch_shape, 0 if max_frames_per_chunk == 1 else 1),
    )


def _stream_step_dynamic(
    config, carry, chunk, max_payload_len: int, detect_threshold, compute_dtype,
    max_frames_per_chunk: int, lock: bool,
) -> Tuple[StreamCarry, DynamicStreamStepOutput]:
    """stream_step_dynamic on a flat batch: carry fields [B, ...], chunk
    [B, chunk_size]; with K > 1 candidates the outputs are [K, B, ...]."""
    from anet_torch.dsp.family import aligned_demod_dynamic_fn, frame_samples
    from anet_torch.dsp.frame import (
        data_symbols_for_payload,
        dynamic_frame_result_from_energies,
        dynamic_frame_result_from_tone_decisions,
        dynamic_frame_samples,
    )
    from anet_torch.kernels import demod_at_energies_fused, demod_at_fused

    _require_supported(config, False)
    chunk_size = chunk.shape[-1]
    t_max = frame_samples(config, max_payload_len)
    template, t_c = _templates(config, compute_dtype, carry.buffer.device)
    _check_carry_geometry(config, carry, chunk_size, max_payload_len)
    mid_flight = candidate1 = quality = None
    if lock:
        if max_frames_per_chunk != 1:
            raise ValueError(
                "lock=True needs max_frames_per_chunk=1 (a locked stream predicts "
                "exactly one next frame; use chunk_size <= the minimum frame length "
                "so at most one frame completes per chunk)"
            )
        # Same locked front half as the fixed-length path: the window
        # geometry only depends on the MAX frame length; the prediction
        # itself came from the previous frame's declared length.
        t_energy = _lock_template(config, compute_dtype, carry.buffer.device)[1]
        buffer, samples_seen, best1_idx, _, best1_q, candidate1, mid_flight = (
            _find_candidate_locked(carry, chunk, t_max, t_c, t_energy, detect_threshold, compute_dtype)
        )
        w0 = 1
        buffer_abs0 = samples_seen - (t_max + chunk_size)
        best1_rel = best1_idx - w0
    elif max_frames_per_chunk == 1:
        buffer, samples_seen, w0, buffer_abs0, best1_q, best1_rel = _search_best(
            carry, chunk, t_max, template, t_c, 0, compute_dtype
        )
    else:
        buffer, samples_seen, w0, buffer_abs0, quality = _slide_and_quality(
            carry, chunk, t_max, template, t_c, 0, compute_dtype
        )
    buf_d = _demod_buffer(buffer, compute_dtype)
    fused = _fused_demod(config)

    def demod_at(start_idx):
        """Max-window demod + dynamic parse at a buffer index."""
        if not fused:  # the OFDM receiver, or the batch-major MFSK one on the slice
            window = _batched_dynamic_slice(buffer, start_idx, t_max, compute_dtype)
            return aligned_demod_dynamic_fn(config, max_payload_len, compute_dtype, buffer.device)(window)
        n_sym_max = data_symbols_for_payload(config, max_payload_len)
        if config.fec == "conv":
            energies = demod_at_energies_fused(config, buf_d, start_idx, n_sym_max)
            return dynamic_frame_result_from_energies(config, energies, max_payload_len)
        tone, best, total = demod_at_fused(config, buf_d, start_idx, n_sym_max)
        return dynamic_frame_result_from_tone_decisions(config, tone, best, total, max_payload_len)

    rel_grid = torch.arange(chunk_size, dtype=torch.int32, device=buffer.device)
    last_end = carry.last_frame_end
    detected_n = torch.zeros_like(carry.frames_detected)
    ok_n = torch.zeros_like(carry.frames_ok)
    err_n = torch.zeros_like(carry.decode_errors)
    accepted = []  # (start_abs, end_abs, detected) of this chunk's slots so far
    outs = []
    for slot in range(max_frames_per_chunk):
        if quality is None:
            best_rel, best_q = best1_rel, best1_q
        else:
            best_rel = torch.argmax(quality, dim=-1).to(torch.int32)  # first index on ties
            best_q = quality.amax(-1)
        start_idx = w0 + best_rel
        start_abs = buffer_abs0 + start_idx
        if candidate1 is not None:
            # lock mode: probe-validated prediction or searched candidate,
            # dedupe already applied by _find_candidate_locked
            candidate = candidate1
        else:
            candidate = (best_q >= detect_threshold) & (
                start_abs >= carry.last_frame_end - DEDUPE_SLACK
            )
        frame = demod_at(start_idx)
        # The header gate (magic + CRC, 48 bits) also vouches for the
        # declared length, so the dedupe cursor can trust it.
        detected = candidate & frame.magic_ok & frame.header_crc_ok & frame.length_ok
        t_actual = dynamic_frame_samples(config, frame.payload_len)
        end_abs = start_abs + t_actual
        # Exact interval check against every frame already accepted this
        # chunk: candidates come in QUALITY order, so this one may precede
        # an accepted frame in time; its end must then clear that start.
        for a_start, a_end, a_det in accepted:
            clear = torch.where(start_abs < a_start, end_abs <= a_start, start_abs >= a_end)
            detected = detected & (clear | ~a_det)
        frame = frame._replace(ok=frame.ok & detected)
        accepted.append((start_abs, end_abs, detected))
        last_end = torch.maximum(last_end, torch.where(detected, end_abs, carry.last_frame_end))
        detected_n = detected_n + detected.to(torch.int32)
        ok_n = ok_n + frame.ok.to(torch.int32)
        err_n = err_n + (detected & ~frame.ok).to(torch.int32)
        outs.append(
            DynamicStreamStepOutput(
                frame=frame, detected=detected, quality=best_q,
                frame_start=start_abs.to(torch.int32),
            )
        )
        if slot + 1 < max_frames_per_chunk:
            # Mask this frame's extent (when accepted) and the picked lag
            # itself, then go again for the next-best candidate. Window
            # position r is absolute start buffer_abs0 + w0 + r, so the
            # extent [start_abs, end_abs) is lags [best_rel, best_rel + t_actual).
            rel = rel_grid[None, :]
            covered = detected[:, None] & (rel >= best_rel[:, None]) & (
                rel < (best_rel + t_actual)[:, None]
            )
            quality = quality.masked_fill(covered | (rel == best_rel[:, None]), float("-inf"))

    if lock:
        # a detection (re)locks the stream with the next start predicted
        # from the DECLARED length; a mid-flight prediction keeps its lock;
        # everything else re-acquires by full search next chunk
        start0, end0, det0 = accepted[0]
        locked_new = det0 | mid_flight
        drift_new = _drift_update(carry, det0, start0)
        next_start_new = torch.where(det0, end0 + _drift_round(drift_new), carry.next_start)
    else:
        locked_new, next_start_new, drift_new = carry.locked, carry.next_start, carry.drift
    new_carry = StreamCarry(
        buffer=buffer,
        samples_seen=samples_seen,
        last_frame_end=last_end.to(torch.int32),
        frames_detected=carry.frames_detected + detected_n,
        frames_ok=carry.frames_ok + ok_n,
        decode_errors=carry.decode_errors + err_n,
        locked=locked_new,
        next_start=next_start_new.to(torch.int32),
        drift=drift_new,
    )
    if max_frames_per_chunk == 1:
        return new_carry, outs[0]
    return new_carry, _stack_steps(outs)


def receive_stream_dynamic(
    config,
    capture,
    chunk_size: int,
    max_payload_len: int,
    detect_threshold: float = DEFAULT_DETECT_THRESHOLD,
    carry: StreamCarry | None = None,
    compute_dtype=torch.float32,
    max_frames_per_chunk: int = 1,
    lock: bool = False,
    device="cuda",
) -> StreamResult:
    """receive_stream with per-frame payload lengths from the headers, on
    ``device``.

    The capture [..., N] must extend a max-length frame past the last frame
    start (pad with zeros): detection fires once a full max window is
    buffered. The capture is cast to the carry buffer's dtype once, up
    front, as receive_stream casts it: into an int8 carry a float capture
    quantizes (quantize_int8) and an int8 capture passes through.
    ``max_frames_per_chunk`` = K > 1 decodes up to K
    non-overlapping frames per chunk (see stream_step_dynamic); the steps
    then carry a per-chunk candidate axis: steps.detected is
    [num_chunks, K, ...]. ``lock=True`` is dynamic frame lock: use chunk_size
    <= the minimum expected frame length so at most one frame completes per
    chunk."""
    _require_supported(config, False)
    capture, num_chunks = _capture_chunks(capture, chunk_size, device)
    batch_shape = tuple(capture.shape[:-1])
    carry = _resume_or_init(config, carry, capture, chunk_size, max_payload_len, compute_dtype)
    cap = _ingest_cast(capture, carry.buffer.dtype).reshape(-1, num_chunks, chunk_size)
    steps = []
    for i in range(num_chunks):
        carry, out = _stream_step_dynamic(
            config, carry, cap[:, i], max_payload_len, detect_threshold, compute_dtype,
            max_frames_per_chunk, lock,
        )
        steps.append(out)
    axis = 1 if max_frames_per_chunk == 1 else 2
    return StreamResult(
        carry=_unflatten(carry, batch_shape), steps=_unflatten(_stack_steps(steps), batch_shape, axis)
    )


_CARRY_DTYPES = {
    "buffer": None,  # from buffer_dtype
    "samples_seen": torch.int32,
    "last_frame_end": torch.int32,
    "frames_detected": torch.int32,
    "frames_ok": torch.int32,
    "decode_errors": torch.int32,
    "locked": torch.bool,
    "next_start": torch.int32,
    "drift": torch.float32,
}


def carry_to_numpy(carry: StreamCarry) -> dict:
    """The carry as numpy arrays in the JAX package's checkpoint layout:
    the buffer widened to float32 (npz has no bfloat16; lossless, int8
    included) and its dtype name under ``buffer_dtype``."""
    fields = {k: v.detach().cpu().numpy() for k, v in carry._asdict().items() if k != "buffer"}
    fields["buffer"] = carry.buffer.detach().float().cpu().numpy()
    fields["buffer_dtype"] = np.asarray(str(carry.buffer.dtype).removeprefix("torch."))
    return fields


def carry_from_numpy(fields: dict, device="cuda") -> StreamCarry:
    """Inverse of carry_to_numpy; also reads a checkpoint written by the JAX
    package's ``anet.stream.save_carry``. Lock fields missing from older
    checkpoints default to unlocked."""
    dev = resolve_device(device)
    missing = [f for f in StreamCarry._fields if f not in fields and f not in ("locked", "next_start", "drift")]
    if missing:
        raise ValueError(f"not a stream checkpoint (missing {missing})")
    buffer_dtype = torch.float32
    if "buffer_dtype" in fields:
        name = str(np.asarray(fields["buffer_dtype"]))
        buffer_dtype = getattr(torch, name, None)
        _require_buffer_dtype(buffer_dtype)
    out = {}
    for name, dtype in _CARRY_DTYPES.items():
        if name in fields:
            out[name] = torch.as_tensor(np.asarray(fields[name]), device=dev).to(dtype or buffer_dtype)
    shape = out["samples_seen"].shape
    out.setdefault("locked", torch.zeros(shape, dtype=torch.bool, device=dev))
    out.setdefault("next_start", torch.zeros(shape, dtype=torch.int32, device=dev))
    out.setdefault("drift", torch.zeros(shape, dtype=torch.float32, device=dev))
    return StreamCarry(**out)


def save_carry(path, carry: StreamCarry, pending=None) -> None:
    """Checkpoint stream state to an .npz file in the JAX package's layout
    (anet.stream.save_carry), so either package resumes the other's.
    ``pending`` holds trailing samples short of a whole chunk."""
    fields = carry_to_numpy(carry)
    fields["pending"] = (
        np.zeros(0, np.float32) if pending is None else np.asarray(pending, np.float32)
    )
    np.savez_compressed(path, **fields)


def load_carry(path, device="cuda") -> StreamCheckpoint:
    """Restore a checkpoint written by save_carry (either package's) onto
    ``device``."""
    with np.load(path) as z:
        fields = {name: z[name] for name in z.files}
    pending = fields.pop("pending", np.zeros(0, np.float32))
    return StreamCheckpoint(carry=carry_from_numpy(fields, device), pending=pending)
