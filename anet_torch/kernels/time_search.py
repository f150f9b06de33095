"""Times kernels of one or more checkouts on one card, in turns: by default
the acquisition search's two kernels.

    python -m anet_torch.kernels.time_search [--model NAME] [--kernels LIST] [CHECKOUT ...]

Each CHECKOUT (default: this one) is a directory that holds an
``anet_torch`` package, for example a ``git archive`` of another commit
unpacked under ``build/``. Each is timed in a process of its own, in the
order given: name parent, change, change, parent to compare two within one
call. A process builds that checkout's sources of the kernels asked for,
then times them on B = 8,192 streams of noise, CUDA events, median of 5
after a warm-up, and prints one JSON line: the checkout, the model, the
card's ``nvidia-smi`` name and power limit, and the times in ms. LIST is a
comma-separated subset of:

- ``search`` (the default): ``sync_search_fused`` and
  ``sync_search_blockmax`` at the locked stream path's geometry of the
  model (mfsk16-fast: out_len the frame at payload 256 rounded down to 128
  samples, 36,352, and the 2,048-sample preamble; mfsk4-coded: 70,144 and
  1,024; ofdm-fast: 4,736 and 640) for each (segment, template) dtype pair,
  and ``sync_search_fused`` again with the template energy a float32
  scalar on the card, as the stream passes it (``... te on the card``: a
  checkout whose wrapper reads it to the host waits for the card there);
- ``correlate``: ``correlate_fused`` at the variable-length stream's
  geometry of the model (out_len two shortest frames of payload 64, 23,552
  for mfsk16-fast, and the preamble) for each dtype pair;
- ``viterbi``: ``viterbi_trellis`` on T = 2,150 steps (mfsk4-coded's
  trellis at payload 256).
- ``demod``: ``demod_at_fused`` at the uncoded stream's geometry
  (mfsk16-fast, payload 256: 536 symbols of 64 samples, 16 tones, buffer
  76,288) and ``demod_at_energies_fused`` at the coded one (mfsk4-coded:
  2,160 symbols of 32 samples, 4 tones, buffer 143,872), each on
  bfloat16, int8 (``quantize_int8``) and float32 buffers of noise, starts
  random in the chunk, each with its ``device`` column as ``frame`` has
  (float32: the split kernels ``demod_at_mma_f32`` and
  ``demod_at_energies_mma_f32``, or an older checkout's CUDA-core
  ``demod_at_f32`` and ``demod_at_energies_f32``). These ignore
  ``--model``.
- ``probe``: ``demod_probe_fused`` at the uncoded locked stream's geometry
  (mfsk16-fast, payload 256: buffer 76,288, the 2,048-sample preamble, 5
  lags, 536 symbols of 64 samples) on bfloat16 and int8 buffers with the
  bfloat16 template the locked step passes, and on float32 buffers with
  the float32 template, probe bases random in the chunk, each with its
  ``device`` column (the probe and the demod kernel: for float32 the
  three-term split ``demod_at_mma_f32``, or an older checkout's CUDA-core
  ``demod_f32``, so a parent checkout and this one time alike). It
  ignores ``--model``.
- ``frame``: ``decide_frame_tm`` at the aligned receiver's geometry
  (mfsk16-fast, payload 256: whole time-major frames of 36,352 rows, the
  data section from row 2,048, 536 symbols of 64 samples, 16 tones) on
  B = 16,384 streams of bfloat16, int8 and float32 noise (int8: round(x *
  127 / max|x|)), and bfloat16, int8 and float32 at B = 16,383 (``...
  ragged``: rows off 16 bytes, read element by element or, float32, by
  4-byte copies). Beside each time, which holds the wrapper's host work
  where that outlasts the kernel, it gives the kernel's own device time
  (``... device``: ``torch.profiler``, the mean of 5 calls over the kernel
  rows whose name holds ``frame_tm``: the split's ``frame_tm_mma_f32`` and
  an older checkout's CUDA-core ``frame_tm_f32`` alike; null when the
  trace holds no kernel row). It ignores ``--model``.
- ``bm``: ``tone_energies_fused`` and ``decide_tones_fused`` at the
  batch-major aligned receiver's geometry (mfsk16-fast, payload 256: the
  data sections of B = 16,384 bfloat16 frames of 36,352 samples of noise,
  read in place past the 2,048-sample preamble, 536 symbols of 64
  samples, 16 tones): bfloat16 compute (``... bfloat16``), float32 compute
  on the same bf16 rows (``... float32 compute``) and on those rows widened
  to float32 (``... float32 compute, float32 rows``), and bfloat16 compute
  on frames of 36,353 samples (``... bfloat16 ragged``: an odd pitch, so
  the rows pass through every residue mod 16 bytes), each with its
  ``device`` column as ``frame`` has. It ignores ``--model``.
- ``probe_at``: ``probe_at_fused`` at the locked streams' geometries
  (mfsk4-coded, payload 256: buffer 143,872, the 1,024-sample preamble;
  mfsk16-fast: buffer 76,288, the 2,048-sample preamble; 5 lags) on
  bfloat16 buffers with the bfloat16 template and its energy as the
  locked step passes them (a float32 scalar on the card), on float32
  buffers with the float32 template, and on bfloat16 buffers one sample
  longer (``... bfloat16 ragged``: rows off 16 bytes), probe bases random
  in the chunk, each with its ``device`` column. It ignores ``--model``.
- ``ofdm``: ``ofdm_track_decide_fused``, tracked, on ofdm-fast at payload
  256 (12 symbols x 96 carriers) with B = 8,192 batch-major streams and
  the same points time-major (``... time-major``: the [B, S, C] view of
  [S, C, B] points and of [C, B] channel powers, as
  ``ofdm.demodulate_frame_tm`` passes them), and on ofdm-max (8 symbols,
  64-QAM) at B = 2,048, each on the route the checkout picks; then at
  every shape of ``OFDM_SHAPES`` (the presets' frames of 256, 1,024 and
  4,096 bytes, S = 12 to 343, S = 302, and S = 19-37 about the routes'
  boundary), B = 1,024 and 8,192, both layouts, each route forced (``...
  S <s> B <b> <layout> <route>``): ``staged`` where a stream fits in a
  block's shared memory, and the checkout's other route, ``block``
  (``global`` in a checkout from before it). Points rotated by a clock
  drift of 100-150 ppm,
  the slope seeded within 5%, each with its ``device`` column (the
  profiler's rows whose name holds ``ofdm_track``). It ignores
  ``--model``.
- ``ofdm_frames``: the aligned OFDM receivers on B = 1,024 frames of
  4,096 bytes at 16 dB (chip_smoke.py's aligned-ofdm-long, ofdm-coded, 343
  data symbols, and aligned-ofdm-4k, ofdm-fast, 172):
  ``family.aligned_demod_fn`` batch-major and ``ofdm.demodulate_frame_tm``
  on the same frames time-major (``aligned <model> 4096 <layout>``, every
  frame ok with its payload or the process fails), each with the
  equalizer's device time in it (``... equalizer device``). It ignores
  ``--model``.
- ``tones_tm``: ``decide_tones_tm`` at the oversized aligned window's
  geometry (mfsk16-fast, payload 256: the data section of a frame plus 8
  symbols, 544 symbols of 64 samples, 16 tones) on B = 16,384 streams of
  bfloat16 and float32 noise, and both at B = 16,383 (``... ragged``: rows
  off 16 bytes); then at the aligned paths of mfsk8-audible (715 symbols
  of 48 samples, 8 tones) and mfsk32-dense (429 of 80, 32 tones), payload
  256, B = 16,384, bfloat16 and float32 (``decide_tones_tm <preset>
  <dtype>``); each with its ``device`` column (rows whose name holds
  ``decide_tones_tm`` or ``frame_tm``: an older checkout's CUDA-core
  float32 kernel, this one's ``frame_tm_mma`` and ``frame_tm_mma_f32``,
  and ``frame_tm_generic``, the CUDA-core body a checkout from before
  the walk took the presets runs there, alike; ``frame_tm_any`` builds
  where the checkout has it). It ignores ``--model``.
- ``filterbank_any``: ``tone_energies_fused`` and ``decide_tones_fused``
  at custom geometries off tone_energies.cu's compile-time walks (sps 40
  with 8 tones, B = 4,096; sps 40 with 16, B = 8,192; sps 160 with 64, B =
  2,048; sps 1,920 with 16, B = 256; payload 256's data symbols of noise, read in place past the
  preamble), bfloat16 compute on bf16 rows, float32 compute on bf16 and on
  float32 rows (``<wrapper> <geometry> <compute> compute, <rows> rows``),
  each with its ``device`` column (rows whose name holds ``filterbank_any``
  or ``any_geometry``: this checkout's tensor-core walk, or an older
  checkout's CUDA-core body, so a parent and this one time alike); null
  where the CUDA-core body refuses the geometry (past 1,536 samples a
  symbol); any other error is raised. It ignores ``--model``.
- ``frame_tm_any``: the time-major pair off decide_frame_tm.cu's walk
  (``TM_ANY_SHAPES``: decide_frame_tm on whole frames of noise at sps 40
  with 16 tones, chip_smoke.py's aligned-custom modem, and at sps 80 with
  16, B = 16,384, and at sps 1,920 with 16, B = 256; decide_tones_tm on
  the data sections at sps 96 with 32 tones and sps 40 with 8, B =
  16,384; payload 256's data symbols; bfloat16, int8 x127 and float32 as
  listed), each with its ``device`` column (rows whose name holds
  ``frame_tm_any`` or, in a checkout from before it, ``frame_tm_generic``,
  so a parent and this one time alike). It ignores ``--model``.
- ``demod_at_any``: the align+demod kernels' two walks. ``demod_at_fused``,
  ``demod_at_energies_fused`` and ``demod_probe_fused`` (5 lags; the
  bfloat16 template, float32 for a float32 buffer) at each shape of
  ``AT_ANY_SHAPES``, payload 256's data symbols, B = 8,192, starts random
  below 1,000, on bfloat16, int8 (``quantize_int8``) and float32 buffers of
  noise: at mfsk16-fast (536 symbols of 64 samples, 16 tones) both on
  demod_at.cu's compile-time walk (``<wrapper> <shape> <dtype> walk``) and
  on csrc/demod_at_any.cu forced (``... any``: ``kernels._demod_at_operands``
  replaced by one that returns the runtime-geometry route whatever the
  geometry), and at stream-sps16-int8's and stream-resident-m32's modems
  (sps 16 with 4 tones, sps 128 with 32), where only the runtime-geometry
  walk runs; each with its ``device`` column (rows whose name holds the
  route's kernel: ``demod_at_mma``, ``demod_at_energies_mma`` or
  ``demod_at_any_kernel``, the probe's ``probe_kernel`` besides). It
  ignores ``--model``.
- ``probe_long``: the probes past a block's shared memory (demod_probe.cu's
  direct kernels, ``DIRECT``): ``probe_at_fused`` and ``demod_probe_fused``
  (5 lags) with sps 480's 15,360-sample preamble (``SLOW_MODEM``) as a
  bfloat16 template, on a bfloat16 buffer of B = 1,024 streams of noise
  (15,360 + 4,096 + 4 symbols of 64 samples), starts random below 4,000;
  ``demod_probe_fused`` at mfsk16-fast's geometry with a 240-symbol
  preamble of that length (its demod on demod_at.cu's walk, 4 data
  symbols). Each with its ``device`` column (rows whose name holds
  ``probe_at_kernel``, or ``probe_kernel``: the probe alone) and its
  ``bound`` (each stream's probe span, 128 (ceil((k + 4) / 128) + 1)
  samples from st0 aligned down to 128, and the taps read once, the
  outputs written once, over 3.35 TB/s). It ignores ``--model``.
- ``search_long``: ``sync_search_fused``, ``sync_search_blockmax`` and
  ``correlate_fused`` at templates of 15,360 and 61,440 samples (sps 480's
  and sps 1,920's preambles; ``LONG_TEMPLATES``), out_len 36,352, B = 256,
  every (segment, template) dtype pair, each with its ``device`` column
  and, where the checkout has ``kernels.search_slab_occupancy``, the slab
  kernel's ``occupancy`` (blocks an SM, registers, spills, slabs); null
  where a checkout refuses the template (one from before the slab route).
  Then ``sync_search_fused`` at stream-slow-f32's own shape
  (``SLOW_SHAPE``: k 15,360, float32 x float32, B = 1,024, out_len
  272,640), the same columns. It ignores ``--model``.
- ``gather``: ``gather_rows_fused`` at the one-shot receiver's geometry
  (mfsk16-fast, payload 256: size 36,352 out of 76,288-sample rows) on B =
  8,192 bfloat16, int8 (``quantize_int8``) and float32 buffers of noise,
  starts random in the row, each with its ``device`` column; null for a
  dtype the checkout's kernel refuses. It ignores ``--model``.

Segments are strided views from sample 1, as the stream passes them. The
inputs come from one seed, so every checkout times the same data. Needs a
card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

KERNELS = {  # a name of --kernels -> the csrc sources it builds
    "search": ("sync_search", "search_blockmax"),
    "correlate": ("correlate",),
    "viterbi": ("viterbi",),
    "demod": ("demod_at", "demod_at_energies"),
    "probe": ("demod_probe", "demod_at"),
    "frame": ("decide_frame_tm",),
    "bm": ("tone_energies",),
    "probe_at": ("demod_probe", "probe_at"),  # probe_at.cu: checkouts that still have it
    "ofdm": ("ofdm_track",),
    "ofdm_frames": ("ofdm_track", "viterbi"),
    "tones_tm": ("decide_tones_tm", "decide_frame_tm", "frame_tm_generic", "frame_tm_any"),
    "gather": ("gather_rows",),
    "filterbank_any": ("tone_energies", "filterbank_any"),  # filterbank_any.cu: checkouts that have it
    # the time-major pair off its walk: frame_tm_any.cu, or a parent's frame_tm_generic.cu
    "frame_tm_any": ("frame_tm_generic", "frame_tm_any"),
    "search_long": ("sync_search", "search_blockmax", "correlate"),
    "demod_at_any": ("demod_at", "demod_at_energies", "demod_probe", "demod_at_any"),
    "probe_long": ("demod_probe", "demod_at"),
}
FRAME_B = 16384  # the aligned receiver's batch (chip_smoke.py ALIGNED_B)
# (preset, data symbols): its frames of 256, 1,024 and 4,096 bytes, S = 302, and
# ofdm-coded streams about the routes' boundary (the staged route's 12 warps an SM
# end at S = 24, its 8 at 37)
OFDM_SHAPES = (
    ("ofdm-fast", 12), ("ofdm-coded", 19), ("ofdm-coded", 24), ("ofdm-coded", 25), ("ofdm-max", 29),
    ("ofdm-coded", 37), ("ofdm-fast", 44), ("ofdm-coded", 87), ("ofdm-max", 115), ("ofdm-fast", 172),
    ("ofdm-coded", 302), ("ofdm-coded", 343),
)
DEMOD_MODELS = {"demod_at_fused": "mfsk16-fast", "demod_at_energies_fused": "mfsk4-coded"}
VIT_STEPS = 2150  # mfsk4-coded: 8 x 268 data-section bits + the 6-bit tail flush
# (label, sample rate, baud, tones, base Hz, B) of the custom geometries of --kernels filterbank_any
ANY_SHAPES = (
    ("sps40-m8", 48_000, 1200, 8, 600.0, 4096),
    ("sps40-m16", 48_000, 1200, 16, 600.0, 8192),  # chip_smoke.py's stream-custom-f32 modem
    ("sps160-m64", 48_000, 300, 64, 150.0, 2048),
    ("sps1920-m16", 48_000, 25, 16, 1000.0, 256),
)
# (label, wrapper, sample rate, baud, tones, base Hz, B, dtypes) of --kernels frame_tm_any
TM_ANY_SHAPES = (
    ("sps40-m16", "decide_frame_tm", 48_000, 1200, 16, 600.0, 16384, ("bfloat16", "int8", "float32")),
    ("sps96-m32", "decide_tones_tm", 48_000, 500, 32, 250.0, 16384, ("bfloat16", "float32")),
    ("sps40-m8", "decide_tones_tm", 48_000, 1200, 8, 600.0, 16384, ("bfloat16", "float32")),
    ("sps80-m16", "decide_frame_tm", 48_000, 600, 16, 300.0, 16384, ("bfloat16", "int8", "float32")),
    ("sps1920-m16", "decide_frame_tm", 48_000, 25, 16, 1000.0, 256, ("bfloat16", "int8", "float32")),
)
# (label, sample rate, baud, tones, base Hz, routes) of --kernels demod_at_any: the
# preset on both walks, then chip_smoke.py's stream-sps16-int8 and
# stream-resident-m32 modems on the runtime-geometry walk
AT_ANY_SHAPES = (
    ("mfsk16-fast", 48_000, 750, 16, 3_000.0, ("walk", "any")),
    ("sps16-m4", 48_000, 3_000, 4, 3_000.0, ("any",)),
    ("sps128-m32", 48_000, 375, 32, 3_000.0, ("any",)),
)
LONG_TEMPLATES = (15_360, 61_440)  # sps 480's and sps 1,920's 32-symbol preambles
LONG_OUT_LEN, LONG_B = 36_352, 256
# (sample rate, baud, tones, base Hz) of sps 480, whose preamble --kernels probe_long probes
SLOW_MODEM = (48_000, 100, 16, 600.0)
# (k, out_len, B) of stream-slow-f32's search (chip_smoke.py phase_search_slow):
# sps 480's preamble, its chunk's lags, its batch
SLOW_SHAPE = (15_360, 272_640, 1024)

_CHILD = r"""
import json, sys
import numpy as np
import torch

sys.path.insert(0, {root!r})
from anet_torch import kernels
from anet_torch.dsp import family, fec
from anet_torch.kernels.build import CSRC, build_all
from anet_torch.models import get_model

kinds = {kinds!r}
build_all(tuple(s for s in {sources!r} if (CSRC / (s + ".cu")).exists()))  # the sources this checkout has
cfg = get_model({model!r}).config
b = 8192
tpl = family.preamble_template(cfg, "cuda").float()
k = tpl.shape[-1]
gen = torch.Generator(device="cuda").manual_seed(0)
PAIRS = ((torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32), (torch.float32, torch.float32))


def time_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        z.record()
        z.synchronize()
        times.append(a.elapsed_time(z))
    return float(np.median(times))


def device_ms(fn, key, reps=5):
    # the device time a call of the kernels whose name holds ``key`` (or one
    # of the keys of a tuple); None when the trace holds no such kernel
    # (never a time nobody measured)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    keys = key if isinstance(key, tuple) else (key,)
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and any(k in e.key for k in keys)]
    if not rows:
        return None
    return sum(e.self_device_time_total for e in rows) / reps / 1e3


def pairs(chunk):
    # (label, strided segment view from sample 1, template) per dtype pair
    buf = torch.randn(b, chunk + k + 127, generator=gen, device="cuda")
    for seg_dtype, tpl_dtype in PAIRS:
        yield (f"{{str(seg_dtype)[6:]}}/{{str(tpl_dtype)[6:]}}",
               buf.to(seg_dtype)[:, 1 : 1 + chunk + k - 1], tpl.to(tpl_dtype))
        torch.cuda.empty_cache()


out = {{}}
if "search" in kinds:
    chunk = family.frame_samples(cfg, 256) // 128 * 128
    for pair, seg, t in pairs(chunk):
        te = float((t.float() ** 2).sum())
        out["sync_search_fused " + pair] = time_ms(lambda: kernels.sync_search_fused(seg, t, chunk, te))
        out["sync_search_blockmax " + pair] = time_ms(lambda: kernels.sync_search_blockmax(seg, t, chunk, te))
        te_dev = (t.float() ** 2).sum()
        out["sync_search_fused " + pair + " te on the card"] = time_ms(
            lambda: kernels.sync_search_fused(seg, t, chunk, te_dev))
if "correlate" in kinds:
    chunk = 2 * family.frame_samples(cfg, 64)
    for pair, seg, t in pairs(chunk):
        out["correlate_fused " + pair] = time_ms(lambda: kernels.correlate_fused(seg, t, chunk))
if "viterbi" in kinds:
    rx = torch.randn(b, {vit_steps}, 2, generator=gen, device="cuda")
    signs = torch.as_tensor(fec._branch_signs(), device="cuda")
    out["viterbi_trellis"] = time_ms(lambda: kernels.viterbi_trellis(signs, rx))
if "demod" in kinds:
    from anet_torch.dsp.frame import data_symbols_for_payload
    from anet_torch.stream import _buffer_len, quantize_int8

    for name, model in {demod_models!r}.items():
        c = get_model(model).config
        chunk = family.frame_samples(c, 256)
        n_sym = data_symbols_for_payload(c, 256)
        x = torch.randn(b, _buffer_len(c, chunk, 256), generator=gen, device="cuda")
        starts = torch.randint(3, chunk - 4, (b,), generator=gen, device="cuda").int()
        fn = getattr(kernels, name)
        for label, make in (("bfloat16", lambda: x.to(torch.bfloat16)), ("int8", lambda: quantize_int8(x)),
                            ("float32", lambda: x)):
            buf = make()
            call = lambda: fn(c, buf, starts, n_sym)
            out[f"{{name}} {{label}}"] = time_ms(call)
            key = name.removesuffix("_fused") + ("_f32" if label == "float32" else "_mma")
            if label == "float32":  # an older checkout's CUDA-core body, or the split kernel
                key = (key, key.replace("_f32", "_mma_f32"))
            out[f"{{name}} {{label}} device"] = device_ms(call, key)
            del buf
            torch.cuda.empty_cache()
        del x
        torch.cuda.empty_cache()
if "probe" in kinds:
    from anet_torch.dsp.frame import data_symbols_for_payload
    from anet_torch.stream import _buffer_len, quantize_int8

    c = get_model("mfsk16-fast").config
    chunk = family.frame_samples(c, 256)
    n_sym = data_symbols_for_payload(c, 256)
    t32 = family.preamble_template(c, "cuda").float()
    x = torch.randn(b, _buffer_len(c, chunk, 256), generator=gen, device="cuda")
    st0 = torch.randint(3, chunk - 4, (b,), generator=gen, device="cuda").int()
    for label, make, t in (("bfloat16", lambda: x.to(torch.bfloat16), t32.to(torch.bfloat16)),
                           ("int8", lambda: quantize_int8(x), t32.to(torch.bfloat16)),
                           ("float32", lambda: x, t32)):
        buf = make()
        call = lambda: kernels.demod_probe_fused(c, buf, st0, n_sym, t, n_lags=5)
        out[f"demod_probe_fused {{label}}"] = time_ms(call)
        # float32: an older checkout's CUDA-core demod_f32 (demod_probe.cu), or demod_at.cu's split kernel
        demod = ("demod_f32", "demod_at_mma_f32") if label == "float32" else ("demod_at_mma",)
        out[f"demod_probe_fused {{label}} device"] = device_ms(call, ("probe_kernel", *demod))
        del buf
        torch.cuda.empty_cache()
if "frame" in kinds:
    c = get_model("mfsk16-fast").config
    t_frame = family.frame_samples(c, 256)
    x = torch.randn(t_frame, {frame_b}, generator=gen, device="cuda")
    x8 = lambda v: torch.round(v * (127.0 / x.abs().max())).to(torch.int8)
    for label, make in (("bfloat16", lambda: x.to(torch.bfloat16)), ("int8", lambda: x8(x)),
                        ("float32", lambda: x),
                        ("bfloat16 ragged", lambda: x[:, 1:].to(torch.bfloat16).contiguous()),
                        ("int8 ragged", lambda: x8(x[:, 1:]).contiguous()),
                        ("float32 ragged", lambda: x[:, 1:].contiguous())):
        xs = make()
        call = lambda: kernels.decide_frame_tm(c, xs, 256, preamble_offset=c.preamble_samples)
        out[f"decide_frame_tm {{label}}"] = time_ms(call)
        out[f"decide_frame_tm {{label}} device"] = device_ms(call, "frame_tm")
        del xs
        torch.cuda.empty_cache()
    del x
if "bm" in kinds:
    c = get_model("mfsk16-fast").config
    t_frame, pre = family.frame_samples(c, 256), c.preamble_samples
    x = torch.randn({frame_b}, t_frame + 1, generator=gen, device="cuda").to(torch.bfloat16)
    for label, make, dtype in (("bfloat16", lambda: x[:, 1:].contiguous(), torch.bfloat16),
                               ("float32 compute", lambda: x[:, 1:].contiguous(), torch.float32),
                               ("float32 compute, float32 rows", lambda: x[:, 1:].float(), torch.float32),
                               ("bfloat16 ragged", lambda: x, torch.bfloat16)):
        xs = make()
        rows = xs[:, xs.shape[1] - t_frame + pre :]  # the data sections, read in place
        for name, key in (("tone_energies_fused", "tone_energies"), ("decide_tones_fused", "decide_tones")):
            call = lambda: getattr(kernels, name)(c, rows, compute_dtype=dtype)
            out[f"{{name}} {{label}}"] = time_ms(call)
            out[f"{{name}} {{label}} device"] = device_ms(call, key)
        del xs, rows
        torch.cuda.empty_cache()
    del x
if "probe_at" in kinds:
    from anet_torch.stream import _buffer_len

    for model in ("mfsk4-coded", "mfsk16-fast"):
        c = get_model(model).config
        chunk = family.frame_samples(c, 256)
        length = _buffer_len(c, chunk, 256)
        t32 = family.preamble_template(c, "cuda").float()
        t16 = t32.to(torch.bfloat16)
        x = torch.randn(b, length + 1, generator=gen, device="cuda")
        st0 = torch.randint(3, chunk - 4, (b,), generator=gen, device="cuda").int()
        for label, make, t in (("bfloat16", lambda: x[:, :length].contiguous().to(torch.bfloat16), t16),
                               ("float32", lambda: x[:, :length].contiguous(), t32),
                               ("bfloat16 ragged", lambda: x.to(torch.bfloat16), t16)):
            buf = make()
            te = (t.float() ** 2).sum()  # as stream._lock_template makes it
            call = lambda: kernels.probe_at_fused(buf, st0, t, te, n_lags=5)
            out[f"probe_at_fused {{model}} {{label}}"] = time_ms(call)
            out[f"probe_at_fused {{model}} {{label}} device"] = device_ms(call, "probe_at_kernel")
            del buf
            torch.cuda.empty_cache()
        del x
if "ofdm" in kinds:
    def ofdm_points(c, bb, s_n):
        # QPSK (or the preset's QAM) points rotated by a clock drift of
        # 100-150 ppm either way, noise, channel powers in [0.5, 1.5], the
        # slope seeded within 5%; made a symbol at a time (long frames)
        c_n = c.n_carriers
        sign = lambda: torch.randint(0, 2, (bb, s_n, c_n), generator=gen, device="cuda").float() * 2 - 1
        ppm = (torch.rand(bb, generator=gen, device="cuda") * 50 + 100) * (
            torch.randint(0, 2, (bb,), generator=gen, device="cuda").float() * 2 - 1)
        slope = ppm * (2 * np.pi * 1e-6 * c.symbol_samples / c.n_fft)
        m = c.first_carrier + torch.arange(c_n, device="cuda")
        z = torch.complex(sign(), sign()) * 0.7071067811865476
        for s in range(s_n):
            ang = slope[:, None] * (s + 1) * m
            z[:, s] *= torch.polar(torch.ones_like(ang), ang)
        z += 0.05 * torch.complex(torch.randn(z.shape, generator=gen, device="cuda"),
                                  torch.randn(z.shape, generator=gen, device="cuda"))
        h = torch.rand(bb, c_n, generator=gen, device="cuda") + 0.5
        slope0 = slope * (1 + 0.05 * (torch.rand(bb, generator=gen, device="cuda") * 2 - 1))
        return z, h, slope0

    def time_major(z, h):
        return z.permute(1, 2, 0).contiguous().permute(2, 0, 1), h.T.contiguous().T

    # the main shapes, each on the route the checkout picks
    for model, bb in (("ofdm-fast", 8192), ("ofdm-max", 2048)):
        c = get_model(model).config
        z, h, slope0 = ofdm_points(c, bb, c.data_symbols_for_payload(256))
        layouts = [("batch-major", lambda: (z, h))]
        if model == "ofdm-fast":
            layouts.append(("time-major", lambda: time_major(z, h)))
        for label, make in layouts:
            zl, hl = make()
            call = lambda: kernels.ofdm_track_decide_fused(c, zl, hl, slope0)
            out[f"ofdm_track_decide_fused {{model}} {{label}}"] = time_ms(call)
            out[f"ofdm_track_decide_fused {{model}} {{label}} device"] = device_ms(call, "ofdm_track")
            del zl, hl
            torch.cuda.empty_cache()
        del z, h
    # the presets' 256-, 1,024- and 4,096-byte frames, S = 302 (the
    # longest the staged route holds at 96 carriers) and S = 19-37, B =
    # 1,024 and 8,192, both layouts, each route forced: "staged" where a
    # stream fits in a block's shared memory, and the checkout's other
    # route ("block"; "global" before it)
    other = "block" if "ofdm_track_decide_fused:block" in kernels.launch_counts else "global"
    route_fn = kernels._ofdm_track_route
    for model, s_n in {ofdm_shapes!r}:
        c = get_model(model).config
        fits = s_n * c.n_carriers * 8 + c.n_carriers * 4 <= kernels.OFDM_STAGE_BYTES
        for bb in (1024, 8192):
            z, h, slope0 = ofdm_points(c, bb, s_n)
            for label, make in (("batch-major", lambda: (z, h)), ("time-major", lambda: time_major(z, h))):
                zl, hl = make()
                call = lambda: kernels.ofdm_track_decide_fused(c, zl, hl, slope0)
                for route in ("staged", other) if fits else (other,):
                    kernels._ofdm_track_route = lambda *shapes, route=route, **layout: route
                    key = f"ofdm_track_decide_fused {{model}} S {{s_n}} B {{bb}} {{label}} {{route}}"
                    out[key] = time_ms(call)
                    out[key + " device"] = device_ms(call, "ofdm_track")
                kernels._ofdm_track_route = route_fn
                del zl, hl
                torch.cuda.empty_cache()
            del z, h, slope0
            torch.cuda.empty_cache()
if "ofdm_frames" in kinds:
    from anet_torch.dsp import ofdm

    for model in ("ofdm-coded", "ofdm-fast"):
        c = get_model(model).config
        pay = torch.randint(0, 256, (1024, 4096), generator=gen, device="cuda", dtype=torch.uint8)
        x = family.transmit_fn(c, "cuda")(pay)
        x = x + ((x * x).mean(-1, keepdim=True) * 10 ** -1.6).sqrt() * torch.randn(x.shape, generator=gen, device="cuda")
        x_tm = x.T.contiguous()
        aligned = family.aligned_demod_fn(c, 4096, device="cuda")
        for label, call in (("batch-major", lambda: aligned(x)),
                            ("time-major", lambda: ofdm.demodulate_frame_tm(c, x_tm, 4096, device="cuda"))):
            res = call()
            if not (bool(res.ok.all()) and torch.equal(res.payload, pay)):
                raise SystemExit(f"{{model}} {{label}}: frames lost")
            del res
            out[f"aligned {{model}} 4096 {{label}}"] = time_ms(call)
            out[f"aligned {{model}} 4096 {{label}} equalizer device"] = device_ms(call, "ofdm_track")
        del x, x_tm, pay
        torch.cuda.empty_cache()
if "tones_tm" in kinds:
    c = get_model("mfsk16-fast").config
    rows = family.frame_samples(c, 256) - c.preamble_samples + 8 * c.samples_per_symbol
    x = torch.randn(rows, {frame_b}, generator=gen, device="cuda")
    for label, make in (("bfloat16", lambda: x.to(torch.bfloat16)), ("float32", lambda: x),
                        ("bfloat16 ragged", lambda: x[:, 1:].to(torch.bfloat16).contiguous()),
                        ("float32 ragged", lambda: x[:, 1:].contiguous())):
        xs = make()
        call = lambda: kernels.decide_tones_tm(c, xs)
        out[f"decide_tones_tm {{label}}"] = time_ms(call)
        out[f"decide_tones_tm {{label}} device"] = device_ms(call, ("decide_tones_tm", "frame_tm"))
        del xs
        torch.cuda.empty_cache()
    del x
    for preset in ("mfsk8-audible", "mfsk32-dense"):
        c = get_model(preset).config
        x = torch.randn(family.frame_samples(c, 256) - c.preamble_samples, {frame_b}, generator=gen, device="cuda")
        for label, make in (("bfloat16", lambda: x.to(torch.bfloat16)), ("float32", lambda: x)):
            xs = make()
            call = lambda: kernels.decide_tones_tm(c, xs)
            out[f"decide_tones_tm {{preset}} {{label}}"] = time_ms(call)
            out[f"decide_tones_tm {{preset}} {{label}} device"] = device_ms(call, ("decide_tones_tm", "frame_tm"))
            del xs
            torch.cuda.empty_cache()
        del x
if "filterbank_any" in kinds:
    from anet_torch.dsp.frame import data_symbols_for_payload
    from anet_torch.dsp.params import ModemConfig

    for label, rate, baud, m, base, bb in {any_shapes!r}:
        c = ModemConfig(sample_rate_hz=rate, symbol_rate_hz=baud, num_tones=m, base_freq_hz=base)
        pre, sps = c.preamble_samples, c.samples_per_symbol
        x = torch.randn(bb, pre + data_symbols_for_payload(c, 256) * sps, generator=gen, device="cuda")
        for compute, rows_dtype in ((torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16),
                                    (torch.float32, torch.float32)):
            rows = x.to(rows_dtype)[:, pre:]  # the data sections, read in place
            for name in ("tone_energies_fused", "decide_tones_fused"):
                call = lambda: getattr(kernels, name)(c, rows, compute_dtype=compute)
                key = f"{{name}} {{label}} {{str(compute)[6:]}} compute, {{str(rows_dtype)[6:]}} rows"
                try:
                    call()
                except RuntimeError:
                    if sps <= 1536:  # only the CUDA-core body of older checkouts refuses, past 1,536
                        raise
                    out[key] = out[key + " device"] = None
                    continue
                out[key] = time_ms(call)
                out[key + " device"] = device_ms(call, ("filterbank_any", "any_geometry"))
            del rows
            torch.cuda.empty_cache()
        del x
        torch.cuda.empty_cache()
if "frame_tm_any" in kinds:
    from anet_torch.dsp.frame import data_symbols_for_payload
    from anet_torch.dsp.params import ModemConfig

    for label, wrapper, rate, baud, m, base, bb, dtypes in {tm_any_shapes!r}:
        c = ModemConfig(sample_rate_hz=rate, symbol_rate_hz=baud, num_tones=m, base_freq_hz=base)
        pre, sps, n_sym = c.preamble_samples, c.samples_per_symbol, data_symbols_for_payload(c, 256)
        x = torch.randn(pre + n_sym * sps, bb, generator=gen, device="cuda")
        for dtype in dtypes:
            if dtype == "int8":
                xs = torch.round(x * (127.0 / x.abs().max())).to(torch.int8)
            else:
                xs = x.to(getattr(torch, dtype))
            if wrapper == "decide_frame_tm":  # whole frames, the data section from the preamble's end
                call = lambda: kernels.decide_frame_tm(c, xs, 256, preamble_offset=pre)
            else:  # the data sections
                xs = xs[pre:].contiguous()
                call = lambda: kernels.decide_tones_tm(c, xs)
            key = f"{{wrapper}} {{label}} {{dtype}}"
            out[key] = time_ms(call)
            out[key + " device"] = device_ms(call, ("frame_tm_any", "frame_tm_generic"))
            del xs
            torch.cuda.empty_cache()
        del x
        torch.cuda.empty_cache()
if "demod_at_any" in kinds:
    from anet_torch.dsp.frame import data_symbols_for_payload
    from anet_torch.dsp.params import ModemConfig
    from anet_torch.stream import quantize_int8

    walk_operands = kernels._demod_at_operands

    def forced(name, kind, config, dtype, device):  # demod_at_any.cu whatever the geometry
        return kind + "_any", "at_any", kernels._demod_at_any_basis(config, dtype, device)

    for label, rate, baud, m, base, routes in {at_any_shapes!r}:
        c = ModemConfig(sample_rate_hz=rate, symbol_rate_hz=baud, num_tones=m, base_freq_hz=base)
        n_sym = data_symbols_for_payload(c, 256)
        x = torch.randn(b, 1000 + c.preamble_samples + n_sym * c.samples_per_symbol + 128, generator=gen,
                        device="cuda")
        starts = torch.randint(0, 1000, (b,), generator=gen, device="cuda").int()
        t32 = family.preamble_template(c, "cuda").float()
        for dtype, make, t in (("bfloat16", lambda: x.to(torch.bfloat16), t32.to(torch.bfloat16)),
                               ("int8", lambda: quantize_int8(x), t32.to(torch.bfloat16)),
                               ("float32", lambda: x, t32)):
            buf = make()
            for route in routes:
                kernels._demod_at_operands = walk_operands if route == "walk" else forced
                decide = "demod_at_mma" if route == "walk" else "demod_at_any_kernel"
                energies = "demod_at_energies_mma" if route == "walk" else "demod_at_any_kernel"
                for name, call, dev_key in (
                    ("demod_at_fused", lambda: kernels.demod_at_fused(c, buf, starts, n_sym), decide),
                    ("demod_at_energies_fused", lambda: kernels.demod_at_energies_fused(c, buf, starts, n_sym),
                     energies),
                    ("demod_probe_fused", lambda: kernels.demod_probe_fused(c, buf, starts, n_sym, t, n_lags=5),
                     ("probe_kernel", decide)),
                ):
                    key = f"{{name}} {{label}} {{dtype}} {{route}}"
                    out[key] = time_ms(call)
                    out[key + " device"] = device_ms(call, dev_key)
                torch.cuda.empty_cache()
            kernels._demod_at_operands = walk_operands
            del buf
            torch.cuda.empty_cache()
        del x
        torch.cuda.empty_cache()
if "search_long" in kinds:
    PAIRS4 = PAIRS + ((torch.float32, torch.bfloat16),)
    for kl in {long_templates!r}:
        t = torch.randn(kl, generator=gen, device="cuda")
        buf = torch.randn({long_b}, {long_out_len} + kl + 127, generator=gen, device="cuda")
        for seg_dtype, tpl_dtype in PAIRS4:
            seg = buf.to(seg_dtype)[:, 1 : {long_out_len} + kl]
            tp = t.to(tpl_dtype)
            te = float((tp.float() ** 2).sum())
            label = f"k {{kl}} {{str(seg_dtype)[6:]}}/{{str(tpl_dtype)[6:]}}"
            for name, call, dev_key in (
                ("sync_search_fused", lambda: kernels.sync_search_fused(seg, tp, {long_out_len}, te), "search_"),
                ("sync_search_blockmax", lambda: kernels.sync_search_blockmax(seg, tp, {long_out_len}, te), "blockmax_"),
                ("correlate_fused", lambda: kernels.correlate_fused(seg, tp, {long_out_len}), "correlate_"),
            ):
                try:
                    call()
                except RuntimeError as e:
                    # only a checkout without the slab route refuses a template past shared
                    # memory, with cudaErrorInvalidValue; any other failure is this one's
                    if not str(e).endswith("cudaError 1"):
                        raise
                    out[f"{{name}} {{label}}"] = out[f"{{name}} {{label}} device"] = None
                    continue
                out[f"{{name}} {{label}}"] = time_ms(call)
                out[f"{{name}} {{label}} device"] = device_ms(call, dev_key)
                if hasattr(kernels, "search_slab_occupancy"):
                    out[f"{{name}} {{label}} occupancy"] = kernels.search_slab_occupancy(
                        name, seg_dtype, tpl_dtype, kl, {long_out_len})
            del seg
            torch.cuda.empty_cache()
        del buf
    # stream-slow-f32's own search: float32 x float32 at its chunk's lags
    kl, n, bb = {slow_shape!r}
    t = torch.randn(kl, generator=gen, device="cuda")
    buf = torch.randn(bb, n + kl + 127, generator=gen, device="cuda")
    seg = buf[:, 1 : n + kl]
    te = float((t ** 2).sum())
    label = f"sync_search_fused stream-slow-f32 (k {{kl}} float32/float32, B {{bb}}, out_len {{n}})"
    call = lambda: kernels.sync_search_fused(seg, t, n, te)
    out[label] = time_ms(call)
    out[label + " device"] = device_ms(call, "search_")
    if hasattr(kernels, "search_slab_occupancy"):
        out[label + " occupancy"] = kernels.search_slab_occupancy(
            "sync_search_fused", torch.float32, torch.float32, kl, n)
    del seg, buf
    torch.cuda.empty_cache()
if "probe_long" in kinds:
    import dataclasses

    from anet_torch.dsp.params import ModemConfig

    rate, baud, m, base = {slow_modem!r}
    tp = family.preamble_template(ModemConfig(sample_rate_hz=rate, symbol_rate_hz=baud, num_tones=m,
                                              base_freq_hz=base), "cuda").to(torch.bfloat16)
    kl, bb, n_sym, n_lags = tp.shape[-1], 1024, 4, 5
    c = get_model("mfsk16-fast").config
    c = dataclasses.replace(c, preamble_symbols=kl // c.samples_per_symbol)
    buf = torch.randn(bb, kl + 4096 + n_sym * c.samples_per_symbol, generator=gen, device="cuda").to(torch.bfloat16)
    st0 = torch.randint(0, 4000, (bb,), generator=gen, device="cuda").int()
    te = float((tp.float() ** 2).sum())
    span = 128 * (-(-(kl + n_lags - 1) // 128) + 1)  # each stream's probe span from st0 // 128 * 128
    for name, call, dev_key, out_bytes in (
        ("probe_at_fused", lambda: kernels.probe_at_fused(buf, st0, tp, te, n_lags=n_lags), "probe_at_kernel",
         4 * n_lags),
        ("demod_probe_fused", lambda: kernels.demod_probe_fused(c, buf, st0, n_sym, tp, n_lags=n_lags),
         "probe_kernel", 12),
    ):
        key = f"{{name}} k {{kl}} bfloat16 B {{bb}}"
        out[key] = time_ms(call)
        out[key + " device"] = device_ms(call, dev_key)
        out[key + " bound"] = (bb * (span * 2 + out_bytes) + kl * 4) / 3.35e12 * 1e3
    del buf
    torch.cuda.empty_cache()
if "gather" in kinds:
    from anet_torch.stream import _buffer_len, quantize_int8

    c = get_model("mfsk16-fast").config
    size = family.frame_samples(c, 256)
    length = _buffer_len(c, size, 256)
    x = torch.randn(b, length, generator=gen, device="cuda")
    starts = torch.randint(0, length - size + 1, (b,), generator=gen, device="cuda").int()
    for label, make in (("bfloat16", lambda: x.to(torch.bfloat16)), ("int8", lambda: quantize_int8(x)),
                        ("float32", lambda: x)):
        buf = make()
        call = lambda: kernels.gather_rows_fused(buf, starts, size)
        try:
            call()
        except TypeError:  # a checkout whose kernel refuses this dtype: nothing to time
            out[f"gather_rows_fused {{label}}"] = out[f"gather_rows_fused {{label}} device"] = None
        else:
            out[f"gather_rows_fused {{label}}"] = time_ms(call)
            out[f"gather_rows_fused {{label}} device"] = device_ms(call, "gather_rows_kernel")
        del buf
        torch.cuda.empty_cache()
    del x
print(json.dumps(out))
"""


def time_checkout(root: Path, model: str, kinds: tuple[str, ...] = ("search",)) -> dict:
    """The timings of the checkout at ``root``, from a process of its own."""
    sources = tuple(dict.fromkeys(s for kind in kinds for s in KERNELS[kind]))  # one nvcc a source
    child = _CHILD.format(root=str(root), model=model, kinds=kinds, sources=sources, vit_steps=VIT_STEPS,
                          demod_models=DEMOD_MODELS, frame_b=FRAME_B, ofdm_shapes=OFDM_SHAPES, any_shapes=ANY_SHAPES,
                          tm_any_shapes=TM_ANY_SHAPES, long_templates=LONG_TEMPLATES, long_b=LONG_B,
                          long_out_len=LONG_OUT_LEN, at_any_shapes=AT_ANY_SHAPES, slow_shape=SLOW_SHAPE,
                          slow_modem=SLOW_MODEM)
    run = subprocess.run([sys.executable, "-c", child], cwd=root, capture_output=True, text=True)
    if run.returncode != 0:
        raise RuntimeError(f"{root}: exit {run.returncode}\n{run.stderr[-4000:]}")
    return json.loads(run.stdout.strip().splitlines()[-1])


def main(argv: list[str]) -> int:
    model, kinds = "mfsk16-fast", ("search",)
    while argv[:1] in (["--model"], ["--kernels"]):
        if argv[0] == "--model":
            model = argv[1]
        else:
            kinds = tuple(argv[1].split(","))
            unknown = set(kinds) - set(KERNELS)
            if unknown:
                raise SystemExit(f"unknown --kernels {sorted(unknown)}: choose from {sorted(KERNELS)}")
        argv = argv[2:]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    for root in argv or [str(Path(__file__).resolve().parents[2])]:
        row = {"checkout": root, "model": model, "card": smi,
               "ms": time_checkout(Path(root).resolve(), model, kinds)}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
