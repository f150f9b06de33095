"""Where the time of the port's locked streaming receiver goes, on one GPU.

    python -m anet_torch.profile_stream [model]

Builds the chip_smoke.py stream capture of ``model`` (mfsk16-fast unless
named, e.g. mfsk4-coded; payload 256, one 1000-sample gap then 6
back-to-back frames, bf16), runs the warm-locked receive once to warm up,
then once under torch.profiler, and prints the device time of each kernel
(the top 12), the sum of device time, the wall time of the run and the
device's busy share (device time over wall time; kernels do not overlap on
one stream), then the same device time by the operator that launched it
(the top 10 ATen operators; the hand-written kernels launch outside any). Also runs the aligned receiver the same way, at 16,384 frames
(8,192 for a coded model). Needs CUDA.
"""

from __future__ import annotations

import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from anet_torch.dsp import frame as tframe
from anet_torch.dsp.pipeline import transmit
from anet_torch.kernels.build import build_all
from anet_torch.models import get_model
from anet_torch.stream import init_carry, receive_stream

PAYLOAD, GAP0, N_FRAMES = 256, 1000, 6
STREAM_B, ALIGNED_B = 8192, 16384


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
    print(f"{label}: wall {wall * 1e3:.3f} ms, device {device_us / 1e3:.3f} ms, "
          f"busy share {device_us / 1e6 / wall:.3f}")
    for e in rows[:12]:
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


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("profile_stream: needs a CUDA device", file=sys.stderr)
        return 2
    build_all()
    dev = torch.device("cuda")
    model = argv[0] if argv else "mfsk16-fast"
    cfg = get_model(model).config
    aligned_b = ALIGNED_B if cfg.fec == "none" else STREAM_B
    gen = torch.Generator(device=dev).manual_seed(0)
    t_frame = tframe.frame_num_samples(cfg, PAYLOAD)
    chunk = t_frame // 128 * 128
    total = -(-(GAP0 + N_FRAMES * t_frame) // chunk) * chunk
    b = STREAM_B
    cap = torch.zeros(b, total, dtype=torch.bfloat16, device=dev)
    for i in range(N_FRAMES):
        pay = torch.randint(0, 256, (b, PAYLOAD), generator=gen, device=dev, dtype=torch.uint8)
        cap[:, GAP0 + i * t_frame : GAP0 + (i + 1) * t_frame] = transmit(cfg, pay, device=dev).to(torch.bfloat16)

    def warm_run():
        carry = init_carry(cfg, chunk, PAYLOAD, (b,), dtype=torch.bfloat16, device=dev)
        carry = carry._replace(
            locked=torch.ones_like(carry.locked), next_start=torch.full_like(carry.next_start, GAP0)
        )
        res = receive_stream(cfg, cap, chunk, PAYLOAD, carry=carry, compute_dtype=torch.bfloat16,
                             lock=True, device=dev)
        assert int(res.carry.frames_ok.sum()) == b * N_FRAMES

    def cold_run():
        res = receive_stream(cfg, cap, chunk, PAYLOAD, compute_dtype=torch.bfloat16, lock=True, device=dev)
        assert int(res.carry.frames_ok.sum()) == b * N_FRAMES

    print(f"{model} stream: B {b}, {total // chunk} chunks of {chunk}")
    report("stream warm-lock", warm_run)
    report("stream cold", cold_run)
    del cap
    torch.cuda.empty_cache()
    pay = torch.randint(0, 256, (aligned_b, PAYLOAD), generator=gen, device=dev, dtype=torch.uint8)
    x_tm = transmit(cfg, pay, device=dev).to(torch.bfloat16).T.contiguous()
    report(f"aligned B {aligned_b}", lambda: int(tframe.demodulate_frame_tm(cfg, x_tm, PAYLOAD, device=dev).ok.sum()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
