"""Scale-out (mirrors ``anet.parallel``): meshes, sharded demod, BER sweeps,
and one long capture split along time with a halo exchange.

The reference lays streams out over a ``jax.sharding.Mesh`` under
``shard_map``: one call takes the whole input and returns every chunk's
outputs and the global counters in global order. The port keeps that
single-controller form. A ``Mesh`` here is an array of positions, each a
``torch.device``; a position may repeat a device, so several positions share
one card (or the CPU in the tests). Each sharded call runs its positions one
after another in Python, each on its own device's tensors: on a multi-card
host the launches of different cards overlap until a chunk's host read. The
halo ``ppermute`` becomes a ``.to(device)`` of the left neighbour's last
samples; ``psum`` and ``pmax`` become sums and maxima over the positions'
counters, gathered on the mesh's first device.

A sharded function takes its input as one tensor (or array) or as the tuple
``shard_streams`` makes; every placement goes through ``resolve_device``, so
a mesh of CUDA positions raises when CUDA is absent.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from anet_torch._device import as_tensor, resolve_device
from anet_torch.channel import ChannelConfig, apply_channel
from anet_torch.dsp import family
from anet_torch.dsp.frame import FrameResult
from anet_torch.stream import (
    DEFAULT_DETECT_THRESHOLD,
    StreamStepOutput,
    init_carry,
    receive_stream,
    receive_stream_dynamic,
)

__all__ = [
    "make_mesh",
    "make_mesh_2d",
    "shard_streams",
    "sharded_demodulate",
    "BerPoint",
    "ber_sweep",
    "ShardedResume",
    "sharded_receive_long_capture",
    "sharded_receive_long_capture_dynamic",
    "sharded_receive_capture_grid",
    "sharded_receive_capture_grid_dynamic",
]

STREAM_AXIS = "streams"
TIME_AXIS = "time"


class Mesh:
    """Positions laid out on named axes (the role of ``jax.sharding.Mesh``).

    ``devices`` is a numpy object array of ``torch.device``, one axis per
    name; ``shape`` maps each axis name to its size."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        flat = np.empty(arr.size, dtype=object)
        flat[:] = [torch.device(d) for d in arr.reshape(-1)]
        self.devices = flat.reshape(arr.shape)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names) or self.devices.size == 0:
            raise ValueError(
                f"mesh of shape {self.devices.shape} needs one axis name per axis, "
                f"got {self.axis_names}"
            )

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={sorted({str(d) for d in self.devices.flat})})"


def _available(device, n: int) -> list:
    """``n`` positions for ``device``: the first ``n`` cards for a CUDA
    device (fewer if fewer exist), ``n`` positions on the device otherwise."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(min(n, torch.cuda.device_count()))]
    return [dev] * n


def make_mesh_2d(
    n_stream_devices: int,
    n_time_devices: int,
    axis_names: "tuple[str, str]" = (STREAM_AXIS, TIME_AXIS),
    device="cuda",
) -> Mesh:
    """2-D mesh: independent streams on one axis, time segments of each
    stream on the other (the DP x CP composition for capture farms), one
    card a position; ``device="cpu"`` puts every position on the CPU."""
    total = n_stream_devices * n_time_devices
    available = _available(device, total)
    if len(available) < total:
        raise ValueError(
            f"mesh {n_stream_devices}x{n_time_devices} needs {total} devices, "
            f"have {len(available)}"
        )
    return Mesh(
        np.asarray(available, dtype=object).reshape(n_stream_devices, n_time_devices),
        axis_names,
    )


def make_mesh(
    n_devices: Optional[int] = None, axis_name: str = STREAM_AXIS, device="cuda"
) -> Mesh:
    """1-D mesh over the first ``n_devices`` cards (default: all); with
    ``device="cpu"``, ``n_devices`` positions on the CPU (default 1)."""
    if n_devices is None:
        n_devices = torch.cuda.device_count() if resolve_device(device).type == "cuda" else 1
    return Mesh(np.asarray(_available(device, n_devices), dtype=object), (axis_name,))


def _positions(devices) -> list:
    """The devices of a mesh (or of one of its rows) as a flat list,
    each resolved (raises for CUDA positions when CUDA is absent)."""
    return [resolve_device(d) for d in np.asarray(devices, dtype=object).reshape(-1)]


def _extent(x, dim: int) -> int:
    """Size along ``dim`` of a tensor or array, or of a shard_streams tuple
    concatenated along its leading axis."""
    if isinstance(x, (tuple, list)):
        return sum(p.shape[dim] for p in x) if dim in (0, -x[0].ndim) else x[0].shape[dim]
    return x.shape[dim]


def _split(x, devices: list, dim: int) -> list:
    """``x`` as len(devices) equal parts along ``dim``, part i on
    devices[i]. A shard_streams tuple with one part a position (split along
    ``dim``) is taken as it is; any other tuple is joined first."""
    n = len(devices)
    if isinstance(x, (tuple, list)):
        parts = [p if isinstance(p, torch.Tensor) else as_tensor(p, devices[0]) for p in x]
        if len(parts) == n and dim in (0, -parts[0].dim()) and len({p.shape[dim] for p in parts}) == 1:
            return [p.to(d) for p, d in zip(parts, devices)]
        x = torch.cat([p.to(devices[0]) for p in parts], 0)
    elif not isinstance(x, torch.Tensor):
        x = as_tensor(x, devices[0])
    if x.shape[dim] % n:
        raise ValueError(f"axis {dim} of length {x.shape[dim]} does not split into {n} equal parts")
    return [p.to(d) for p, d in zip(x.tensor_split(n, dim), devices)]


def _cat(trees: list, dim: int, device):
    """NamedTuples of tensors (nested) joined field by field along ``dim``
    on ``device``."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([t.to(device) for t in trees], dim)
    return type(first)(*(_cat(list(fields), dim, device) for fields in zip(*trees)))


def _map(tree, fn):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return type(tree)(*(_map(f, fn) for f in tree))


def _rows(mesh: Mesh) -> list:
    """Each row's first position: where shard_streams puts the row's part."""
    return _positions(mesh.devices.reshape(mesh.devices.shape[0], -1)[:, 0])


def shard_streams(mesh: Mesh, arr) -> tuple:
    """Split the leading (stream/batch) axis over the mesh's first axis: one
    tensor a row of positions, each on the row's first device."""
    return tuple(_split(arr, _rows(mesh), 0))


def sharded_demodulate(
    config,
    mesh: Mesh,
    waves,
    payload_len: int,
    compute_dtype=torch.float32,
) -> FrameResult:
    """Demodulate a batch of aligned frames [B, T], the batch split over the
    mesh's positions (B a multiple of their count). No position depends on
    another: each runs the family's aligned demodulator (MFSK with
    ``compute_dtype``; OFDM widens to float32) on its part, and the results
    are joined on the first position's device in batch order."""
    devices = _positions(mesh.devices)
    outs = [
        family.aligned_demod_fn(config, payload_len, compute_dtype, device=d)(w)
        for w, d in zip(_split(waves, devices, 0), devices)
    ]
    return _cat(outs, 0, devices[0])


class BerPoint(NamedTuple):
    """Aggregated error statistics for one sweep grid point."""

    snr_db: torch.Tensor  # float32 [G]
    bit_errors: torch.Tensor  # int32 [G] — across all frames/positions
    total_bits: torch.Tensor  # int32 [G]
    frame_errors: torch.Tensor  # int32 [G] — integrity-failed frames
    total_frames: torch.Tensor  # int32 [G]

    @property
    def ber(self) -> torch.Tensor:
        return self.bit_errors / self.total_bits.clamp_min(1)

    @property
    def fer(self) -> torch.Tensor:
        return self.frame_errors / self.total_frames.clamp_min(1)


def ber_sweep(
    config,
    mesh: Mesh,
    gen: torch.Generator,
    snr_grid_db: Sequence[float],
    frames_per_point: int,
    payload_len: int = 64,
    channel: ChannelConfig = ChannelConfig(),
    compute_dtype=torch.float32,
) -> BerPoint:
    """TX -> channel -> RX error-rate sweep over the mesh's positions.

    Each position draws ``frames_per_point / positions`` streams a grid
    point, laid out [per_position, G, payload_len]: random payloads,
    transmitted, impaired with ``channel`` at each point's SNR (a [G] SNR
    broadcast over the streams, each stream's signal power its own),
    demodulated; bit errors (popcount of the byte XOR) and failed frames are
    summed per point over streams and positions. ``gen`` seeds one
    generator a position on its device (the explicit form of the
    reference's ``jax.random.split(key, n_dev)``), so the draws differ from
    the reference's but their statistics do not.

    ``frames_per_point`` must be a multiple of the mesh size."""
    devices = _positions(mesh.devices)
    n_dev = len(devices)
    g = len(snr_grid_db)
    if frames_per_point % n_dev:
        raise ValueError(
            f"frames_per_point={frames_per_point} must be a multiple of mesh size {n_dev}"
        )
    per_dev = frames_per_point // n_dev
    seeds = torch.randint(0, 2**62, (n_dev,), generator=gen, device=gen.device).tolist()
    bit_errors = torch.zeros(g, dtype=torch.int32, device=devices[0])
    frame_errors = torch.zeros(g, dtype=torch.int32, device=devices[0])
    for seed, d in zip(seeds, devices):
        dev_gen = torch.Generator(device=d).manual_seed(seed)
        payloads = torch.randint(
            0, 256, (per_dev, g, payload_len), generator=dev_gen, device=d, dtype=torch.uint8
        )
        waves = family.transmit_fn(config, d)(payloads)  # [per_dev, G, T]
        snrs = torch.as_tensor(snr_grid_db, dtype=torch.float32, device=d)
        dirty = apply_channel(dev_gen, waves, channel, snr_db=snrs, device=d)
        res = family.aligned_demod_fn(config, payload_len, compute_dtype, d)(dirty)
        bit_err = _popcount8(res.payload ^ payloads).sum((0, 2), dtype=torch.int32)
        bit_errors += bit_err.to(devices[0])
        frame_errors += (~res.ok).sum(0, dtype=torch.int32).to(devices[0])
    total_frames = torch.full((g,), per_dev * n_dev, dtype=torch.int32, device=devices[0])
    return BerPoint(
        snr_db=torch.as_tensor(snr_grid_db, dtype=torch.float32, device=devices[0]),
        bit_errors=bit_errors,
        total_bits=total_frames * (payload_len * 8),
        frame_errors=frame_errors,
        total_frames=total_frames,
    )


def _popcount8(x: torch.Tensor) -> torch.Tensor:
    """Per-byte popcount of a uint8 tensor (int32 out)."""
    x = x.to(torch.int32)
    x = x - ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    return (x + (x >> 4)) & 0x0F


class ShardedResume(NamedTuple):
    """Checkpoint of a sharded receive, for continuing the SAME logical
    stream across successive sharded calls.

    ``tail`` is the stream's last ``halo`` samples (one demodulator memory),
    which becomes position 0's left context next call; ``last_frame_end`` is
    the global dedupe cursor — for dynamic-length streams it reflects the
    ACTUAL length of the last accepted frame, so a frame straddling the
    super-step boundary is not re-detected by the next call. Counters are
    cumulative. Serialize with np.savez like stream.save_carry."""

    tail: torch.Tensor  # float32 [halo] (1-D) or [B, halo] (grid)
    samples_seen: torch.Tensor  # int32 scalar — total samples consumed
    last_frame_end: torch.Tensor  # int32 — global ([] or [B])
    frames_detected: torch.Tensor  # int32 — cumulative global
    frames_ok: torch.Tensor  # int32
    decode_errors: torch.Tensor  # int32


class ShardedStreamResult(NamedTuple):
    steps: StreamStepOutput  # per-chunk outputs, chunk axis global-ordered
    frames_detected: torch.Tensor  # int32 scalar — global
    frames_ok: torch.Tensor  # int32 scalar — global
    decode_errors: torch.Tensor  # int32 scalar — global
    resume: Optional[ShardedResume] = None  # continue-the-stream checkpoint


def _segment_geometry(config, n, n_dev, chunk_size, payload_len):
    t_frame = family.frame_samples(config, payload_len)
    seg = n // n_dev
    if n % n_dev or seg % chunk_size:
        raise ValueError(
            f"capture length {n} must split into {n_dev} segments of whole "
            f"{chunk_size}-sample chunks"
        )
    halo = t_frame + chunk_size  # stream buffer length
    if seg < halo:
        raise ValueError(
            f"per-device segment of {seg} samples is shorter than the "
            f"demodulator memory ({halo}); use fewer devices or a longer capture"
        )
    return seg, halo


def _resume_inputs(resume, halo, device, batch_shape=()):
    """(tail, samples_base, cursor, counter-triple) on ``device`` for a
    fresh or resumed sharded receive; validates the halo geometry on
    resume."""
    zi = torch.zeros(batch_shape, dtype=torch.int32, device=device)
    if resume is None:
        zero = zi.sum(dtype=torch.int32)
        return (
            torch.zeros(batch_shape + (halo,), dtype=torch.float32, device=device),
            zero,
            zi,
            (zero, zero, zero),
        )
    if tuple(resume.tail.shape) != batch_shape + (halo,):
        raise ValueError(
            f"resume.tail shape {tuple(resume.tail.shape)} != expected "
            f"{batch_shape + (halo,)}; same config/chunk/payload required"
        )

    def on(x, dtype=torch.int32):
        x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
        return x.to(device, dtype)

    return (
        on(resume.tail, torch.float32),
        on(resume.samples_seen),
        on(resume.last_frame_end),
        (on(resume.frames_detected), on(resume.frames_ok), on(resume.decode_errors)),
    )


def _halo_carry(config, chunk_size, payload_len, left, samples_seen, last_frame_end, device):
    """A float32 stream carry on ``device`` whose buffer is the left halo
    (frame + chunk samples, no tail pad) and whose clock and dedupe cursor
    are the given ones: a position's view of the stream at its segment's
    start."""
    batch_shape = tuple(left.shape[:-1])
    carry = init_carry(
        config, chunk_size, payload_len, batch_shape, dtype=torch.float32, device=device
    )
    return carry._replace(
        buffer=left.to(device, torch.float32),
        samples_seen=torch.as_tensor(samples_seen).to(device, torch.int32).expand(batch_shape).clone(),
        last_frame_end=torch.as_tensor(last_frame_end).to(device, torch.int32).expand(batch_shape).clone(),
    )


def _scan_segments(receive, config, segs, devices, seg, halo, chunk_size, payload_len, tail0, seen0, cursor0):
    """Run each time segment of one row of positions through ``receive``
    (a carry -> StreamResult call), position i's left halo the last ``halo``
    samples of segment i - 1 (``tail0`` for position 0), its clock
    ``seen0 + i * seg`` and its dedupe cursor ``cursor0`` at position 0 and
    0 elsewhere. Returns the positions' StreamResults in ring order."""
    results = []
    for i, (part, d) in enumerate(zip(segs, devices)):
        left = tail0 if i == 0 else segs[i - 1][..., -halo:]
        carry = _halo_carry(
            config, chunk_size, payload_len, left, seen0 + i * seg,
            cursor0 if i == 0 else torch.zeros_like(cursor0), d,
        )
        results.append(receive(part, carry, d))
    return results


def _totals(results, first, base_counts):
    """Global counters: every position's carry counters summed (psum) onto
    ``first``, plus the resumed base."""
    return tuple(
        base + sum(getattr(r.carry, f).sum(dtype=torch.int32).to(first) for r in results)
        for f, base in zip(("frames_detected", "frames_ok", "decode_errors"), base_counts)
    )


def _long_capture(receive, config, mesh, capture, chunk_size, payload_len, resume):
    """The 1-D time-sharded scan shared by the fixed- and dynamic-length
    receivers."""
    devices = _positions(mesh.devices)
    n = _extent(capture, -1)
    seg, halo = _segment_geometry(config, n, len(devices), chunk_size, payload_len)
    tail0, seen0, cursor0, base_counts = _resume_inputs(resume, halo, devices[0])
    segs = _split(capture, devices, -1)
    results = _scan_segments(
        receive, config, segs, devices, seg, halo, chunk_size, payload_len, tail0, seen0, cursor0
    )
    det, ok, err = _totals(results, devices[0], base_counts)
    cursor = torch.stack([r.carry.last_frame_end.to(devices[0]) for r in results]).amax(0)  # pmax
    steps = _cat([r.steps for r in results], 0, devices[0])
    new_resume = ShardedResume(
        tail=segs[-1][-halo:].to(devices[0], torch.float32),
        samples_seen=seen0 + n,
        last_frame_end=cursor,
        frames_detected=det,
        frames_ok=ok,
        decode_errors=err,
    )
    return ShardedStreamResult(
        steps=steps, frames_detected=det, frames_ok=ok, decode_errors=err, resume=new_resume
    )


def sharded_receive_long_capture(
    config,
    mesh: Mesh,
    capture,
    chunk_size: int,
    payload_len: int,
    detect_threshold: float = DEFAULT_DETECT_THRESHOLD,
    resume: Optional[ShardedResume] = None,
    lock: bool = False,
) -> ShardedStreamResult:
    """Split ONE long capture along time across the mesh's positions (the
    CP analog).

    Each position scans a contiguous time segment; its left halo — the last
    frame + chunk samples of the previous position's segment, exactly the
    demodulator's memory — is copied to its device (the reference's
    ``ppermute`` ring). A frame is attributed to the position where its
    *end* falls, so boundary frames are found exactly once.

    ``capture``: float [N]; N must divide evenly into mesh-size segments of
    whole chunks. ``resume``: the previous call's ``result.resume`` to
    continue the same logical stream (position 0 then seeds its left halo
    and dedupe cursor from it instead of zeros, and counters accumulate).
    ``lock``: frame-lock mode per segment — each position pays one search
    to acquire, then probe-verifies predictions; decoded frames are
    identical either way."""

    def receive(part, carry, d):
        return receive_stream(
            config, part, chunk_size, payload_len, detect_threshold, carry, lock=lock, device=d
        )

    return _long_capture(receive, config, mesh, capture, chunk_size, payload_len, resume)


def _grid(receive, config, mesh, captures, chunk_size, payload_len, batch_dim, resume, cursor_out):
    """The 2-D (streams x time) scan shared by the fixed- and dynamic-length
    grids. ``batch_dim``: the stream axis of a position's steps;
    ``cursor_out``: whether the result carries a resume (the dynamic
    grid's)."""
    s_axis, t_axis = mesh.axis_names
    n_s, n_t = mesh.shape[s_axis], mesh.shape[t_axis]
    b, n = _extent(captures, 0), _extent(captures, -1)
    if b % n_s:
        raise ValueError(f"B={b} must divide by the stream-axis size {n_s}")
    seg, halo = _segment_geometry(config, n, n_t, chunk_size, payload_len)
    b_local = b // n_s
    first = _positions(mesh.devices)[0]
    tail0, seen0, cursor0, base_counts = _resume_inputs(resume, halo, first, (b,))
    rows = _split(captures, _rows(mesh), 0)
    results, row_steps, cursors = [], [], []
    for s, row in enumerate(rows):
        devices = _positions(mesh.devices[s])
        lo = s * b_local
        row_results = _scan_segments(
            receive, config, _split(row, devices, -1), devices, seg, halo, chunk_size,
            payload_len, tail0[lo : lo + b_local], seen0, cursor0[lo : lo + b_local],
        )
        results += row_results
        # steps [chunks_local, (K,) b_local, ...] -> [b_local, chunks_local, (K,) ...],
        # the time positions joined along the chunk axis
        row_steps.append(
            _cat([_map(r.steps, lambda x: x.movedim(batch_dim, 0)) for r in row_results], 1, first)
        )
        cursors.append(torch.stack([r.carry.last_frame_end.to(first) for r in row_results]).amax(0))
    det, ok, err = _totals(results, first, base_counts)
    new_resume = None
    if cursor_out:
        new_resume = ShardedResume(
            tail=torch.cat([r[:, -halo:].to(first, torch.float32) for r in rows]),
            samples_seen=seen0 + n,
            last_frame_end=torch.cat(cursors),
            frames_detected=det,
            frames_ok=ok,
            decode_errors=err,
        )
    return ShardedStreamResult(
        steps=_cat(row_steps, 0, first), frames_detected=det, frames_ok=ok, decode_errors=err,
        resume=new_resume,
    )


def sharded_receive_capture_grid(
    config,
    mesh: Mesh,
    captures,
    chunk_size: int,
    payload_len: int,
    detect_threshold: float = DEFAULT_DETECT_THRESHOLD,
    lock: bool = False,
) -> ShardedStreamResult:
    """A BATCH of long captures over a 2-D mesh: streams x time.

    Independent captures split over the ``streams`` axis (no communication),
    and each capture's timeline splits over the ``time`` axis with the
    one-frame halo copied ring-wise WITHIN each stream row (zeros at the
    first time position).

    ``captures``: float [B, N]; B must divide by the stream-axis size, and
    N by time_axis_size * chunk_size. Counters are global (summed over both
    axes); per-chunk step outputs come back [B, total_chunks, ...]."""
    s_axis, t_axis = mesh.axis_names
    n_s, n_t = mesh.shape[s_axis], mesh.shape[t_axis]
    b, n = _extent(captures, 0), _extent(captures, -1)
    t_frame = family.frame_samples(config, payload_len)
    seg = n // n_t
    if b % n_s or n % n_t or seg % chunk_size:
        raise ValueError(
            f"captures [B={b}, N={n}] must split into [{n_s} x {n_t}] shards "
            f"of whole {chunk_size}-sample chunks"
        )
    halo = t_frame + chunk_size
    if seg < halo:
        raise ValueError(
            f"per-device time segment of {seg} samples is shorter than the "
            f"demodulator memory ({halo}); use fewer time devices or longer captures"
        )

    def receive(part, carry, d):
        return receive_stream(
            config, part, chunk_size, payload_len, detect_threshold, carry, lock=lock, device=d
        )

    return _grid(receive, config, mesh, captures, chunk_size, payload_len, 1, None, False)


def sharded_receive_long_capture_dynamic(
    config,
    mesh: Mesh,
    capture,
    chunk_size: int,
    max_payload_len: int,
    detect_threshold: float = DEFAULT_DETECT_THRESHOLD,
    max_frames_per_chunk: int = 1,
    resume: Optional[ShardedResume] = None,
) -> ShardedStreamResult:
    """sharded_receive_long_capture with per-frame payload lengths read
    from each frame's header.

    The halo/attribution geometry is sized for ``max_payload_len`` (a frame
    is attributed to the position where its max-length detection window
    completes — one position exactly, so boundary frames are found once).
    The dedupe cursor honors each frame's ACTUAL header length: within a
    position through the stream carry, across positions by construction (a
    frame's actual extent never reaches past its attribution point, start +
    t_max), and across super-steps through ``resume.last_frame_end``. Coded
    configs stream with fec_interleave == 1."""

    def receive(part, carry, d):
        return receive_stream_dynamic(
            config, part, chunk_size, max_payload_len, detect_threshold, carry,
            max_frames_per_chunk=max_frames_per_chunk, device=d,
        )

    return _long_capture(receive, config, mesh, capture, chunk_size, max_payload_len, resume)


def sharded_receive_capture_grid_dynamic(
    config,
    mesh: Mesh,
    captures,
    chunk_size: int,
    max_payload_len: int,
    detect_threshold: float = DEFAULT_DETECT_THRESHOLD,
    max_frames_per_chunk: int = 1,
    resume: Optional[ShardedResume] = None,
) -> ShardedStreamResult:
    """sharded_receive_capture_grid with header-declared frame lengths: the
    DP x CP composition for a farm of variable-length streams.

    Streams split over the ``streams`` axis, each stream's timeline over
    the ``time`` axis with a max-frame halo copied ring-wise within its
    row. The dedupe cursor is per stream (the maximum over the time axis
    only) and honors actual header lengths; across super-steps it continues
    via ``resume.last_frame_end`` ([B])."""

    def receive(part, carry, d):
        return receive_stream_dynamic(
            config, part, chunk_size, max_payload_len, detect_threshold, carry,
            max_frames_per_chunk=max_frames_per_chunk, device=d,
        )

    batch_dim = 1 if max_frames_per_chunk == 1 else 2
    return _grid(
        receive, config, mesh, captures, chunk_size, max_payload_len, batch_dim, resume, True
    )
