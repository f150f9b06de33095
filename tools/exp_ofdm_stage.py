"""Times the OFDM equalizer's block route with and without its first pass's
points kept in shared memory, on one card.

    python tools/exp_ofdm_stage.py

``tools/exp_ofdm_stage.cu`` includes ``anet_torch/kernels/csrc/ofdm_track.cu``
and adds the staging variant of ``ofdm_track_block_kernel`` (each warp keeps
its first symbols' points in shared memory from the first pass; the later
passes read them there). This script builds it into ``build/`` with the
kernels' nvcc flags, and at every shape of ``time_search.OFDM_SHAPES`` that
the block route takes in some layout (S >= 25), B = 1,024 and 8,192, both
layouts (batch-major, and the time-major receiver's [B, S, C] view of [S, C,
B] points), calls the block route's entry (``st0``) and the variant's
(``st1``) on the same drifted, tracked points: first once each, their LLRs,
error powers and coherences bit-equal or the script fails; then timed in
turns st0, st1, st1, st0, each turn 20 launches between two CUDA events
(ms a launch). Prints a JSON line a shape, then the card's ``nvidia-smi``
name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from anet_torch._native_build import Compile, hashed_path  # noqa: E402
from anet_torch.kernels import build  # noqa: E402
from anet_torch.kernels.time_search import OFDM_SHAPES  # noqa: E402
from anet_torch.models import get_model  # noqa: E402

SOURCE = ROOT / "tools" / "exp_ofdm_stage.cu"
REPS = 20


def library() -> Path:
    inputs = (SOURCE, build.CSRC / "ofdm_track.cu", *sorted(build.CSRC.glob("*.cuh")))
    out = hashed_path(build.BUILD_DIR, "libexp_ofdm_stage", inputs, build.NVCC_FLAGS)
    if not out.exists():
        error = Compile(build.nvcc_path(), build.NVCC_FLAGS, SOURCE, out).finish()
        if error is not None:
            raise RuntimeError(f"exp_ofdm_stage.cu: nvcc {error}")
    return out


def points(cfg, b: int, s_n: int, gen):
    """QPSK points rotated by a clock drift of 100-150 ppm either way, noise,
    channel powers in [0.5, 1.5], the slope seeded within 5% (as
    time_search's)."""
    c_n = cfg.n_carriers
    sign = lambda: torch.randint(0, 2, (b, s_n, c_n), generator=gen, device="cuda").float() * 2 - 1
    ppm = (torch.rand(b, generator=gen, device="cuda") * 50 + 100) * (
        torch.randint(0, 2, (b,), generator=gen, device="cuda").float() * 2 - 1)
    slope = ppm * (2 * np.pi * 1e-6 * cfg.symbol_samples / cfg.n_fft)
    m = cfg.first_carrier + torch.arange(c_n, device="cuda")
    z = torch.complex(sign(), sign()) * 0.7071067811865476
    for s in range(s_n):
        ang = slope[:, None] * (s + 1) * m
        z[:, s] *= torch.polar(torch.ones_like(ang), ang)
    z += 0.05 * torch.complex(torch.randn(z.shape, generator=gen, device="cuda"),
                              torch.randn(z.shape, generator=gen, device="cuda"))
    h = torch.rand(b, c_n, generator=gen, device="cuda") + 0.5
    slope0 = slope * (1 + 0.05 * (torch.rand(b, generator=gen, device="cuda") * 2 - 1))
    return z, h, slope0


def launcher(fn, cfg, z: torch.Tensor, h: torch.Tensor, slope0: torch.Tensor):
    """A call of entry ``fn`` on these points, and its outputs."""
    b, s_n, c_n = z.shape
    zr = torch.view_as_real(z)
    llrs = torch.empty(b, s_n * c_n * cfg.bits_per_carrier, device="cuda")
    evm2 = torch.empty(b, device="cuda")
    coh = torch.zeros(b, 2, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    args = (zr.data_ptr(), *(st // 2 for st in zr.stride()[:3]), h.data_ptr(), *h.stride(),
            slope0.data_ptr(), b, s_n, c_n, cfg.bits_per_carrier, cfg.first_carrier, 1, s_n,
            llrs.data_ptr(), evm2.data_ptr(), coh.data_ptr(), stream)

    def call():
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"launch failed: cudaError {err}")

    return call, (llrs, evm2, coh)


def time_turn(call) -> float:
    call()
    a, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(REPS):
        call()
    e.record()
    e.synchronize()
    return a.elapsed_time(e) / REPS


def main() -> int:
    if not torch.cuda.is_available():
        print("exp_ofdm_stage: needs a CUDA card", file=sys.stderr)
        return 1
    argtypes = build.SIGNATURES["ofdm_track_block"][1]
    entries = {}
    for name, symbol in (("st0", "anet_ofdm_track_block"), ("st1", "exp_ofdm_track_block_stage")):
        fn = getattr(ctypes.CDLL(str(library())), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        entries[name] = fn
    gen = torch.Generator(device="cuda").manual_seed(28)
    for model, s_n in OFDM_SHAPES:
        if s_n < 25:
            continue
        cfg = get_model(model).config
        for b in (1024, 8192):
            z, h, slope0 = points(cfg, b, s_n, gen)
            layouts = (("batch-major", z, h),
                       ("time-major", z.permute(1, 2, 0).contiguous().permute(2, 0, 1), h.T.contiguous().T))
            for layout, zl, hl in layouts:
                calls, outs = {}, {}
                for name, fn in entries.items():
                    calls[name], outs[name] = launcher(fn, cfg, zl, hl, slope0)
                    calls[name]()
                torch.cuda.synchronize()
                if not all(torch.equal(a, b_) for a, b_ in zip(outs["st0"], outs["st1"])):
                    raise AssertionError(f"{model} S {s_n} B {b} {layout}: staging changed the bits")
                times = {"st0": [], "st1": []}
                for name in ("st0", "st1", "st1", "st0"):
                    times[name].append(time_turn(calls[name]))
                row = {"model": model, "S": s_n, "B": b, "layout": layout}
                row.update({f"{k} ms": sorted(round(t, 4) for t in v) for k, v in times.items()})
                print(json.dumps(row), flush=True)
                del calls, outs
            del z, h, slope0, layouts
            torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
