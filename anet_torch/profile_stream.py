"""Where the time of the port's streaming and aligned receivers goes, on one GPU.

    python -m anet_torch.profile_stream [model] [path]

``path`` is one of

- ``lock`` (the default): the fixed-length locked stream of chip_smoke.py
  (payload 256, one 1000-sample gap then 6 back-to-back frames, bf16), warm
  and cold, then the time-major aligned receiver at 16,384 frames (8,192
  for a coded or an OFDM model);
- ``lock-int8``: the same locked stream on an int8 carry (the capture
  quantized once with stream.quantize_int8, bf16 compute), warm and cold,
  then the int8 aligned receiver (uncoded MFSK: frames quantized to x127
  over the batch's maximum, demodulate_frame_tm with int8 compute);
- ``dynamic``: the variable-length always-search stream with two
  candidates a chunk (chip_smoke.py's stream-dynamic: payloads 64, 64, 256,
  128, 64, 64 back to back, chunk of two shortest frames);
- ``dynamic-lock``: the variable-length locked stream (payloads 64, 256,
  128, 64, 256, 128, chunk of one shortest frame), warm and cold; a coded
  model needs fec_interleave == 1 (mfsk4-coded-stream).
- ``dynamic-lock-int8``: the same locked stream on an int8 carry
  (init_carry(dtype=torch.int8)): the bf16 capture quantizes at ingest
  (quantize_int8), bf16 compute, warm and cold (chip_smoke.py's
  stream-dynamic-int8 on an MFSK model).
- ``aligned-bm``: the batch-major aligned receiver of chip_smoke.py on
  16,384 bf16 frames (uncoded MFSK): demodulate_frame with bfloat16
  compute (the filterbank tone_energies_fused, then the plain decisions
  and parse), then decide_tones_fused on the data sections read in place
  and frame_result_from_tone_decisions ("aligned-bm-decide").
- ``tracked``: the symbol-clock tracker of chip_smoke.py (uncoded MFSK):
  receive_frame_tracked on 2,048 float32 captures of 38,400 samples, each
  frame at a random start below 1,500 and drifted by 700-1,000 ppm either
  way (drift_rows) at 14 dB, then receive_stream(track=True) on the locked
  stream's capture (8,192 streams) drifted alike;
- ``resident``: the fixed-length locked stream of ``lock`` (bf16, uncoded
  MFSK), warm and cold, through the carry route (resident=False) and the
  capture-resident scan (resident=True) in turns, in one process;
- ``demo``: the demos' stream call (anet_torch.examples: float32, always
  searching, chunk 1,024, one capture with no batch axis) on the first
  DEMO_CHUNKS chunks of a demo's capture: for an MFSK model the file
  demo's (a 16 KiB seeded file in 264-byte wire frames, an echo, 8 dB),
  for an OFDM model the Opus demo's (Opus-sized 230-byte messages in
  238-byte wire frames, two echoes, 14 dB).

``model`` is mfsk16-fast unless named; the OFDM presets (ofdm-fast, and for
``lock`` and ``lock-int8`` the coded ones) run the same paths but
``aligned-bm``, ``tracked`` and ``resident``, which take the MFSK presets
only (``aligned-bm`` and ``resident`` the uncoded ones); the aligned run of
``lock-int8`` stays bf16 for a coded or an OFDM model (int8 aligned compute
is uncoded MFSK only). Each run happens once to warm up,
then once under torch.profiler, and prints the device time of each kernel
(the top 12, then every hand-written kernel of ``kernels/csrc`` below
them), the sum of device time, the wall time of the run, the
device's busy share (device time over wall time; kernels do not overlap on
one stream) and the host reads of the run (``aten::_local_scalar_dense``
calls: each waits for the card), then the same device time by the operator that launched it
(the top 10 ATen operators; the hand-written kernels launch outside any).
Needs CUDA.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from anet_torch.channel import sample_rate_drift
from anet_torch.dsp import family
from anet_torch.dsp import frame as tframe
from anet_torch.dsp import ofdm
from anet_torch.kernels.build import build_all
from anet_torch.models import get_model
from anet_torch.stream import init_carry, quantize_int8, receive_stream, receive_stream_dynamic

PAYLOAD, GAP0, N_FRAMES = 256, 1000, 6
STREAM_B, ALIGNED_B = 8192, 16384
DYNAMIC_LENS = (64, 64, 256, 128, 64, 64)  # two shortest frames complete in one chunk, twice
DYNAMIC_LOCK_LENS = (64, 256, 128, 64, 256, 128)
DRIFT_PPM = (700.0, 1000.0)  # |clock offset| of the tracked paths' rows
DRIFT_SNR_DB = 14.0
ROWS = 1024  # rows a pass of drift_rows: bounds its temporaries at full width
DEMO_CHUNKS = 512  # chunks of the demo path's run


def back_to_back_capture(cfg, lens, max_len: int, chunk: int, batch: int, gen, dev):
    """(capture bf16 [batch, N], payloads): GAP0 zeros, one frame per entry
    of ``lens`` back to back with random payloads from ``gen``, then at least
    one max-length frame of zeros, N a whole number of chunks."""
    frames = [int(tframe.dynamic_frame_samples(cfg, n)) for n in lens]
    total = GAP0 + sum(frames) + family.frame_samples(cfg, max_len)
    total = -(-total // chunk) * chunk
    cap = torch.zeros(batch, total, dtype=torch.bfloat16, device=dev)
    transmit = family.transmit_fn(cfg, dev)
    sent, pos = [], GAP0
    for n, t in zip(lens, frames):
        pay = torch.randint(0, 256, (batch, n), generator=gen, device=dev, dtype=torch.uint8)
        cap[:, pos : pos + t] = transmit(pay).to(torch.bfloat16)
        sent.append(pay)
        pos += t
    return cap, sent


def drift_rows(x: torch.Tensor, ppm: torch.Tensor, rows: int = ROWS) -> torch.Tensor:
    """Each row of float32 ``x`` [B, N] as a receiver whose clock runs
    ppm[b] parts per million fast samples it (channel.sample_rate_drift with
    a per-row offset), ``rows`` rows a pass to bound the temporaries."""
    out = torch.empty_like(x)
    for r0 in range(0, x.shape[0], rows):
        out[r0 : r0 + rows] = sample_rate_drift(x[r0 : r0 + rows], ppm[r0 : r0 + rows], x.device)
    return out


def drifted_clock_ppm(batch: int, gen, dev) -> torch.Tensor:
    """float32 [batch] clock offsets, |ppm| uniform in DRIFT_PPM, sign at
    random."""
    low, high = DRIFT_PPM
    mag = low + (high - low) * torch.rand(batch, generator=gen, device=dev)
    sign = torch.randint(0, 2, (batch,), generator=gen, device=dev) * 2 - 1
    return mag * sign


def add_noise(x: torch.Tensor, signal: torch.Tensor, gen) -> torch.Tensor:
    """x plus white noise at DRIFT_SNR_DB against each row's ``signal``
    power (float32 [B])."""
    sigma = (signal.reshape(-1, 1) * 10 ** (-DRIFT_SNR_DB / 10)).sqrt()
    return x + sigma * torch.randn(x.shape, generator=gen, device=x.device)


def drifted_oneshot_captures(cfg, batch: int, n: int, gen, dev):
    """(payloads uint8 [batch, 256], float32 captures [batch, n], ppm
    [batch]): each frame at a random start below 1,500 (room for a frame
    stretched by 1,000 ppm and the tracker's probes), drifted by
    drifted_clock_ppm, white noise at DRIFT_SNR_DB against the frame's
    power."""
    pay = torch.randint(0, 256, (batch, PAYLOAD), generator=gen, device=dev, dtype=torch.uint8)
    waves = family.transmit_fn(cfg, dev)(pay)
    starts = torch.randint(0, 1500, (batch,), generator=gen, device=dev)
    cap = torch.zeros(batch, n, device=dev)
    cap.scatter_(1, starts[:, None] + torch.arange(waves.shape[1], device=dev), waves)
    ppm = drifted_clock_ppm(batch, gen, dev)
    cap = add_noise(drift_rows(cap, ppm), (waves * waves).mean(-1), gen)
    return pay, cap, ppm


def drifted_stream_capture(cfg, batch: int, gen, dev):
    """(bf16 capture [batch, N], payloads uint8 [N_FRAMES, batch, 256], ppm
    [batch], chunk): the locked stream's layout (GAP0 zeros, N_FRAMES
    back-to-back frames, chunk = frame // 128 * 128), each row drifted by
    drifted_clock_ppm and noised at DRIFT_SNR_DB in float32, ROWS rows a
    pass."""
    t_frame = family.frame_samples(cfg, PAYLOAD)
    chunk = t_frame // 128 * 128
    total = -(-(GAP0 + N_FRAMES * t_frame) // chunk) * chunk
    transmit = family.transmit_fn(cfg, dev)
    sent = torch.randint(0, 256, (N_FRAMES, batch, PAYLOAD), generator=gen, device=dev, dtype=torch.uint8)
    ppm = drifted_clock_ppm(batch, gen, dev)
    cap = torch.empty(batch, total, dtype=torch.bfloat16, device=dev)
    for r0 in range(0, batch, ROWS):
        r1 = min(r0 + ROWS, batch)
        x = torch.zeros(r1 - r0, total, device=dev)
        power = torch.zeros(r1 - r0, device=dev)
        for i in range(N_FRAMES):
            w = transmit(sent[i, r0:r1])
            x[:, GAP0 + i * t_frame : GAP0 + (i + 1) * t_frame] = w
            power += (w * w).mean(-1) / N_FRAMES
        cap[r0:r1] = add_noise(drift_rows(x, ppm[r0:r1]), power, gen).to(torch.bfloat16)
        del x
    return cap, sent, ppm, chunk


def warm_lock_carry(cfg, chunk: int, payload_len: int, batch: int, dev, dtype=torch.bfloat16):
    """A fresh carry (bf16 unless ``dtype`` says otherwise) whose lock is
    seeded at the first frame (GAP0)."""
    carry = init_carry(cfg, chunk, payload_len, (batch,), dtype=dtype, device=dev)
    return carry._replace(
        locked=torch.ones_like(carry.locked), next_start=torch.full_like(carry.next_start, GAP0)
    )


def report(label: str, fn) -> None:
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side rows only: an ATen op's own row repeats its kernels' time
    rows = [
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    device_us = sum(e.self_device_time_total for e in rows)
    # host reads: every copy of a tensor's value to the host (float(), bool(), .item())
    reads = sum(e.count for e in prof.key_averages() if e.key == "aten::_local_scalar_dense")
    print(f"{label}: wall {wall * 1e3:.3f} ms, device {device_us / 1e3:.3f} ms, "
          f"busy share {device_us / 1e6 / wall:.3f}, host reads {reads}")
    # the top 12, then the port's own kernels (csrc/, anonymous namespace) below them
    own = [e for e in rows[12:] if e.key.removeprefix("void ").startswith("(anonymous namespace)::")]
    for e in rows[:12] + own:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")
    # host-side rows: self device time = the kernels an operator launched itself
    ops = [
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CPU and e.self_device_time_total > 0
    ]
    ops.sort(key=lambda e: e.self_device_time_total, reverse=True)
    print("  by operator:")
    for e in ops[:10]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:60]}")


def profile_lock(cfg, model: str, gen, dev, int8: bool = False) -> None:
    is_ofdm = family.is_ofdm(cfg)
    aligned_b = ALIGNED_B if cfg.fec == "none" and not is_ofdm else STREAM_B
    t_frame = family.frame_samples(cfg, PAYLOAD)
    chunk = t_frame // 128 * 128
    total = -(-(GAP0 + N_FRAMES * t_frame) // chunk) * chunk
    b = STREAM_B
    transmit = family.transmit_fn(cfg, dev)
    dtype = torch.int8 if int8 else torch.bfloat16
    ingest = quantize_int8 if int8 else (lambda w: w.to(torch.bfloat16))
    cap = torch.zeros(b, total, dtype=dtype, device=dev)
    for i in range(N_FRAMES):
        pay = torch.randint(0, 256, (b, PAYLOAD), generator=gen, device=dev, dtype=torch.uint8)
        cap[:, GAP0 + i * t_frame : GAP0 + (i + 1) * t_frame] = ingest(transmit(pay))

    def run(carry):
        res = receive_stream(cfg, cap, chunk, PAYLOAD, carry=carry, compute_dtype=torch.bfloat16,
                             lock=True, resident=False, device=dev)
        assert int(res.carry.frames_ok.sum()) == b * N_FRAMES

    label = "stream-int8" if int8 else "stream"
    print(f"{model} {label}: B {b}, {total // chunk} chunks of {chunk}")
    report(f"{label} warm-lock", lambda: run(warm_lock_carry(cfg, chunk, PAYLOAD, b, dev, dtype)))
    cold = (lambda: init_carry(cfg, chunk, PAYLOAD, (b,), dtype=dtype, device=dev)) if int8 else (lambda: None)
    report(f"{label} cold", lambda: run(cold()))
    del cap
    torch.cuda.empty_cache()
    pay = torch.randint(0, 256, (aligned_b, PAYLOAD), generator=gen, device=dev, dtype=torch.uint8)
    if int8 and cfg.fec == "none" and not is_ofdm:
        x = transmit(pay)
        x_tm = torch.round(x.T * (127.0 / x.abs().max())).to(torch.int8).contiguous()
        report(f"aligned-int8 B {aligned_b}", lambda: int(tframe.demodulate_frame_tm(
            cfg, x_tm, PAYLOAD, compute_dtype=torch.int8, device=dev).ok.sum()))
        return
    x_tm = transmit(pay).to(torch.bfloat16).T.contiguous()
    demod_tm = ofdm.demodulate_frame_tm if is_ofdm else tframe.demodulate_frame_tm
    report(f"aligned B {aligned_b}", lambda: int(demod_tm(cfg, x_tm, PAYLOAD, device=dev).ok.sum()))


def profile_dynamic(cfg, model: str, lock: bool, gen, dev, int8: bool = False) -> None:
    lens = DYNAMIC_LOCK_LENS if lock else DYNAMIC_LENS
    t_min = int(tframe.dynamic_frame_samples(cfg, min(lens)))
    chunk = (t_min if lock else 2 * t_min) // 128 * 128
    b = STREAM_B
    cap, _ = back_to_back_capture(cfg, lens, PAYLOAD, chunk, b, gen, dev)
    dtype = torch.int8 if int8 else torch.bfloat16

    def run(carry):
        res = receive_stream_dynamic(
            cfg, cap, chunk, PAYLOAD, carry=carry, compute_dtype=torch.bfloat16,
            max_frames_per_chunk=1 if lock else 2, lock=lock, device=dev,
        )
        assert int(res.carry.frames_ok.sum()) == b * len(lens)

    label = "stream-dynamic" + ("-lock" if lock else "") + ("-int8" if int8 else "")
    print(f"{model} {label}: B {b}, {cap.shape[1] // chunk} chunks of {chunk}, payloads {lens}")
    if lock:
        cold = (lambda: init_carry(cfg, chunk, PAYLOAD, (b,), dtype=dtype, device=dev)) if int8 else (lambda: None)
        report(f"{label} warm", lambda: run(warm_lock_carry(cfg, chunk, PAYLOAD, b, dev, dtype)))
        report(f"{label} cold", lambda: run(cold()))
    else:
        report("stream-dynamic (2 candidates a chunk)", lambda: run(None))


def profile_tracked(cfg, model: str, gen, dev) -> None:
    from anet_torch.dsp.pipeline import receive_frame_tracked

    if family.is_ofdm(cfg):
        raise ValueError(f"tracked takes an MFSK model, got {model}")
    b = 2048
    pay, cap, _ = drifted_oneshot_captures(cfg, b, 38400, gen, dev)

    def oneshot():
        res = receive_frame_tracked(cfg, cap, PAYLOAD, device=dev)
        assert int(res.frame.ok.sum()) == b and torch.equal(res.frame.payload, pay)

    print(f"{model} oneshot-tracked: B {b}, float32 captures of {cap.shape[1]}")
    report("oneshot-tracked (receive_frame_tracked)", oneshot)
    del cap
    torch.cuda.empty_cache()
    cap, _, _, chunk = drifted_stream_capture(cfg, STREAM_B, gen, dev)

    def stream():
        res = receive_stream(cfg, cap, chunk, PAYLOAD, compute_dtype=torch.bfloat16, track=True, device=dev)
        assert int(res.carry.frames_ok.sum()) == STREAM_B * N_FRAMES

    print(f"{model} stream-tracked: B {STREAM_B}, {cap.shape[1] // chunk} chunks of {chunk}")
    report("stream-tracked (receive_stream track=True)", stream)


def profile_resident(cfg, model: str, gen, dev) -> None:
    if cfg.fec != "none" or family.is_ofdm(cfg):
        raise ValueError(f"resident takes an uncoded MFSK model, got {model}")
    t_frame = family.frame_samples(cfg, PAYLOAD)
    chunk = t_frame // 128 * 128
    total = -(-(GAP0 + N_FRAMES * t_frame) // chunk) * chunk
    b = STREAM_B
    transmit = family.transmit_fn(cfg, dev)
    cap = torch.zeros(b, total, dtype=torch.bfloat16, device=dev)
    for i in range(N_FRAMES):
        pay = torch.randint(0, 256, (b, PAYLOAD), generator=gen, device=dev, dtype=torch.uint8)
        cap[:, GAP0 + i * t_frame : GAP0 + (i + 1) * t_frame] = transmit(pay).to(torch.bfloat16)

    def run(carry, resident):
        res = receive_stream(cfg, cap, chunk, PAYLOAD, carry=carry, compute_dtype=torch.bfloat16,
                             lock=True, resident=resident, device=dev)
        assert int(res.carry.frames_ok.sum()) == b * N_FRAMES

    print(f"{model} stream carry route / resident scan: B {b}, {total // chunk} chunks of {chunk}")
    for run_name, carry in (("warm-lock", lambda: warm_lock_carry(cfg, chunk, PAYLOAD, b, dev)),
                            ("cold", lambda: None)):
        for route, resident in (("carry", False), ("resident", True), ("resident", True), ("carry", False)):
            report(f"stream {run_name} {route}", lambda: run(carry(), resident))
            torch.cuda.empty_cache()


def profile_aligned_bm(cfg, model: str, gen, dev) -> None:
    from anet_torch import kernels

    if cfg.fec != "none" or family.is_ofdm(cfg):
        raise ValueError(f"aligned-bm takes an uncoded MFSK model, got {model}")
    b, pre = ALIGNED_B, cfg.preamble_samples
    pay = torch.randint(0, 256, (b, PAYLOAD), generator=gen, device=dev, dtype=torch.uint8)
    x = family.transmit_fn(cfg, dev)(pay).to(torch.bfloat16)

    def demodulate():
        res = tframe.demodulate_frame(cfg, x, PAYLOAD, compute_dtype=torch.bfloat16, device=dev)
        assert int(res.ok.sum()) == b

    def decide():
        tone, best, total = kernels.decide_tones_fused(cfg, x[:, pre:], compute_dtype=torch.bfloat16)
        res = tframe.frame_result_from_tone_decisions(cfg, tone, best, total, PAYLOAD)
        assert int(res.ok.sum()) == b

    print(f"{model} aligned-bm: B {b}, bf16 frames of {x.shape[1]}")
    report("aligned-bm (demodulate_frame)", demodulate)
    report("aligned-bm-decide (decide_tones_fused + frame_result_from_tone_decisions)", decide)


PATHS = ("lock", "lock-int8", "dynamic", "dynamic-lock", "dynamic-lock-int8", "aligned-bm", "tracked", "resident",
         "demo")


def profile_demo(cfg, model: str, gen, dev) -> None:
    from anet_torch.examples import CHUNK, file_over_sound, opus_over_sound, wire_frames

    rng = np.random.default_rng(0)
    if family.is_ofdm(cfg):
        padded = wire_frames([rng.bytes(230) for _ in range(-(-DEMO_CHUNKS * CHUNK // cfg.frame_num_samples(238)))])
        dirty = opus_over_sound.pass_channel(opus_over_sound.build_capture(cfg, padded, dev), 14.0, gen)
    else:
        padded = wire_frames(file_over_sound.file_chunks(rng.bytes(16384)))
        dirty = file_over_sound.pass_channel(file_over_sound.build_capture(cfg, padded, dev), 8.0, gen)
    dirty = dirty[: DEMO_CHUNKS * CHUNK]
    report(
        f"{model} demo stream ({dirty.shape[0] // CHUNK} chunks of {CHUNK}, {padded.shape[1]}-byte frames, "
        "float32, always searching)",
        lambda: receive_stream(cfg, dirty, CHUNK, padded.shape[1], device=dev),
    )


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("profile_stream: needs a CUDA device", file=sys.stderr)
        return 2
    model = argv[0] if argv else "mfsk16-fast"
    path = argv[1] if len(argv) > 1 else "lock"
    if path not in PATHS:
        print(f"profile_stream: path must be one of {', '.join(PATHS)}, got {path!r}", file=sys.stderr)
        return 2
    build_all()
    dev = torch.device("cuda")
    cfg = get_model(model).config
    gen = torch.Generator(device=dev).manual_seed(0)
    if path in ("lock", "lock-int8"):
        profile_lock(cfg, model, gen, dev, int8=path == "lock-int8")
    elif path == "aligned-bm":
        profile_aligned_bm(cfg, model, gen, dev)
    elif path == "tracked":
        profile_tracked(cfg, model, gen, dev)
    elif path == "resident":
        profile_resident(cfg, model, gen, dev)
    elif path == "demo":
        profile_demo(cfg, model, gen, dev)
    else:
        profile_dynamic(cfg, model, path != "dynamic", gen, dev, int8=path == "dynamic-lock-int8")
    return 0


if __name__ == "__main__":
    sys.exit(main())
