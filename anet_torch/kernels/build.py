"""Builds the CUDA sources in ``csrc/`` with nvcc and loads them with ctypes.

Each ``csrc/<name>.cu`` compiles, on first use, into its own shared library
``build/anet_torch_kernels/lib<name>-<hash>.so`` at the root of the
checkout, where ``<hash>`` covers the source and every shared header
(``csrc/*.cuh``: ``common``, ``search_core``, ``demod_core``), so an
edited source or header rebuilds and an unchanged one loads at once
(``anet_torch/_native_build.py`` names, compiles and publishes it). The sources have
a plain C interface (no PyTorch headers), which keeps each build to seconds;
``build_all`` starts one nvcc per source, all at once.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from anet_torch._native_build import Compile, hashed_path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "anet_torch_kernels"
SOURCES = (
    "decide_frame_tm", "sync_search", "demod_at", "demod_probe",
    "viterbi", "demod_at_energies",
    "correlate", "gather_rows", "ofdm_track",
    "tone_energies", "search_blockmax", "frame_tm_any", "filterbank_any", "demod_at_any",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signature of each entry point: (symbol, argtypes), or (symbol, argtypes,
# source) for an entry point of another source's library than its own name
SIGNATURES = {
    "decide_frame_tm": (
        "anet_decide_frame_tm",
        [_P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    ),
    "sync_search": (
        "anet_sync_search",
        [_P, _I, _I, _L, _I, _P, _I, _I, _I, _I, _P, ctypes.c_float, _P, _P, _P, _P, _P],
    ),
    "demod_at": (
        "anet_demod_at",
        [_P, _I, _I, ctypes.c_longlong, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    ),
    "demod_probe": (
        "anet_demod_probe",
        [_P, _I, _I, _L, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    ),
    "viterbi": ("anet_viterbi", [_P, _P, _I, _I, _P, _P, _P]),
    "demod_at_energies": (
        "anet_demod_at_energies",
        [_P, _I, _I, ctypes.c_longlong, _P, _I, _I, _I, _I, _P, _P, _P],
    ),
    "demod_at_any": (
        "anet_demod_at_any",
        [_P, _I, _I, ctypes.c_longlong, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    ),
    "demod_at_energies_any": (
        "anet_demod_at_energies_any",
        [_P, _I, _I, ctypes.c_longlong, _P, _I, _I, _I, _I, _P, _P, _P], "demod_at_any",
    ),
    # demod_at_any.cu's instantiation's occupancy at a geometry
    "demod_at_any_occupancy": ("anet_demod_at_any_occupancy", [_I, _I, _I, _I, _I, _P], "demod_at_any"),
    "probe_at": (
        "anet_probe_at",
        [_P, _I, _I, _L, _P, _P, _I, _I, _I, _P, ctypes.c_float, _P, _P], "demod_probe",
    ),
    "correlate": (
        "anet_correlate",
        [_P, _I, _I, ctypes.c_longlong, _I, _P, _I, _I, _I, _I, _P, _P],
    ),
    "decide_tones_tm_mma": (
        "anet_decide_tones_tm_mma", [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P], "decide_frame_tm",
    ),
    "decide_frame_tm_any": (
        "anet_decide_frame_tm_any",
        [_P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P], "frame_tm_any",
    ),
    "decide_tones_tm_any": (
        "anet_decide_tones_tm_any", [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P], "frame_tm_any",
    ),
    "gather_rows": (
        "anet_gather_rows",
        [_P, _I, _I, ctypes.c_longlong, _P, _I, _P, _P],
    ),
    "ofdm_track": (
        "anet_ofdm_track",
        [_P, _L, _L, _L, _P, _L, _L, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    ),
    "ofdm_track_block": (
        "anet_ofdm_track_block",
        [_P, _L, _L, _L, _P, _L, _L, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P], "ofdm_track",
    ),
    "tone_energies_any": (
        "anet_tone_energies_any", [_P, _I, _I, _L, _I, _I, _I, _P, _P, _P], "filterbank_any",
    ),
    "decide_tones_any": (
        "anet_decide_tones_any", [_P, _I, _I, _L, _I, _I, _I, _P, _P, _P, _P, _P], "filterbank_any",
    ),
    "tone_energies_any_f32": (
        "anet_tone_energies_any_f32", [_P, _I, _I, _L, _I, _I, _I, _P, _P, _P], "filterbank_any",
    ),
    "decide_tones_any_f32": (
        "anet_decide_tones_any_f32", [_P, _I, _I, _L, _I, _I, _I, _P, _P, _P, _P, _P], "filterbank_any",
    ),
    "tone_energies_mma": (
        "anet_tone_energies_mma", [_P, _I, _L, _P, _I, _I, _I, _P, _P, _P], "tone_energies",
    ),
    "decide_tones_mma": (
        "anet_decide_tones_mma", [_P, _I, _L, _P, _I, _I, _I, _P, _P, _P, _P, _P], "tone_energies",
    ),
    "tone_energies_mma_f32": (
        "anet_tone_energies_mma_f32", [_P, _I, _I, _L, _P, _I, _I, _I, _P, _P, _P], "tone_energies",
    ),
    "decide_tones_mma_f32": (
        "anet_decide_tones_mma_f32", [_P, _I, _I, _L, _P, _I, _I, _I, _P, _P, _P, _P, _P], "tone_energies",
    ),
    "search_blockmax": (
        "anet_search_blockmax",
        [_P, _I, _I, _L, _I, _P, _I, _I, _I, _I, _P, ctypes.c_float, _P, _P],
    ),
    # the slab kernels' occupancy at a launch's geometry (search_core.cuh slab_occupancy)
    "sync_search_slab_occupancy": ("anet_sync_search_slab_occupancy", [_I, _I, _I, _I, _I, _P], "sync_search"),
    "search_blockmax_slab_occupancy": (
        "anet_search_blockmax_slab_occupancy", [_I, _I, _I, _I, _I, _P], "search_blockmax",
    ),
    "correlate_slab_occupancy": ("anet_correlate_slab_occupancy", [_I, _I, _I, _I, _I, _P], "correlate"),
}

_loaded: dict[str, ctypes._CFuncPtr] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return str(path)


def library_path(name: str) -> Path:
    return hashed_path(BUILD_DIR, f"lib{name}", (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))), NVCC_FLAGS)


def build_all(names=SOURCES, seconds: dict | None = None) -> list[Path]:
    """Compile every library of ``names`` not built yet, one nvcc process per
    source, all started together; raise with nvcc's output if any fails.
    ``seconds``, where given, gets each compiled source's wall seconds from
    the common start to its nvcc's end."""
    t0 = time.perf_counter()
    jobs = []
    for name in names:
        out = library_path(name)
        if not out.exists():
            jobs.append((name, Compile(nvcc_path(), NVCC_FLAGS, CSRC / f"{name}.cu", out)))

    def finish(job):  # a thread each, so every end is timed as it comes
        return job.finish(), time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=max(1, len(jobs))) as pool:
        ends = list(pool.map(finish, (job for _, job in jobs)))
    failures = []
    for (name, _), (error, dt) in zip(jobs, ends):
        if seconds is not None:
            seconds[name] = dt
        if error is not None:
            failures.append(f"{name}: nvcc {error}")
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return [library_path(n) for n in names]


def entry(name: str):
    """The ctypes function of entry point ``name``, its library built on
    first use."""
    fn = _loaded.get(name)
    if fn is None:
        symbol, argtypes, *source = SIGNATURES[name]
        path = library_path(source[0] if source else name)
        if not path.exists():
            build_all()
        fn = getattr(ctypes.CDLL(str(path)), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    return fn
