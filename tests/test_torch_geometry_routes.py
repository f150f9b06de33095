"""The geometries outside the align+demod kernels' and decide_frame_tm's
tensor-core walk (samples_per_symbol other than 32, 64 and 128, or more
than 16 tones: the presets mfsk8-audible and mfsk32-dense, and custom
configs), anet_torch against the JAX package on the CPU.

- Three predicates pick the routes. kernels._tensor_core_geometry (sps 32,
  64 or 128, at most 16 tones) picks the align+demod kernels' compile-time
  walk (kernels._demod_at_operands; their runtime-geometry walk, csrc/
  demod_at_any.cu, elsewhere within the reference's gate, 128 % sps == 0,
  kernels._demod_at_geometry, which also picks the stream steps' route,
  stream._fused_demod; ValueError naming sps outside it) and
  decide_frame_tm's (kernels._tm_operands);
  kernels._filterbank_tensor_core_geometry (sps 32, 48, 64, 80 or 128, at
  most 32 tones) the batch-major filterbank's (kernels._filterbank_operands)
  and decide_tones_tm's, whose tensor-core routes take both presets: their
  basis operands and launch code, the card's calls replaced by recorders.
- The stream receivers on both presets (float32 and int8 carries, searching
  and locked; the variable-length receiver) equal anet's, and never call
  the align+demod wrappers.
- The aligned time-major receiver on both presets equals anet's with its
  Pallas decide_tones_tm in interpret mode; decide_frame_tm's plain version
  equals anet's interpreted decide_frame_tm at two custom geometries.
- The runtime-geometry walk's (csrc/frame_tm_any.cu) basis operand and
  launch code, the card's calls replaced by recorders; its launches count
  under their own key.
"""

import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import anet.kernels as jk
from anet import stream as jstream
from anet.dsp import frame as jframe
from anet.dsp.params import ModemConfig as JModemConfig
from anet.models import get_model as jget_model

import anet_torch.stream as tstream
from anet_torch import kernels as tk
from anet_torch.dsp import family as tfamily
from anet_torch.dsp import frame as tframe
from anet_torch.dsp.frame import data_symbols_for_payload
from anet_torch.dsp.params import ModemConfig
from anet_torch.models import get_model, list_models

PRESETS = ("mfsk8-audible", "mfsk32-dense")
PAY = 16
B = 4
CPU = torch.device("cpu")
FRAME_FIELDS = ("payload", "magic_ok", "length_ok", "header_crc_ok", "payload_crc_ok", "ok")


def _custom(sps: int, m: int, cls=ModemConfig):
    """A config of ``sps`` samples and ``m`` tones a symbol at 48 kHz, tones
    from half the symbol rate (the top tone below Nyquist needs m <= sps / 2)."""
    rate = 48_000 // sps
    return cls(sample_rate_hz=48_000, symbol_rate_hz=rate, num_tones=m, base_freq_hz=rate / 2)


# every MFSK preset, and sps 4 .. 160 with 2 .. 64 tones wherever a config exists
GEOMETRIES = {m.name: m.config for m in list_models() if hasattr(m.config, "num_tones")}
GEOMETRIES.update({
    f"sps{sps}-m{m}": _custom(sps, m)
    for sps in (4, 8, 16, 24, 32, 48, 64, 80, 96, 128, 160) for m in (2, 4, 8, 16, 32, 64) if m <= sps // 2
})
TM_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_one_predicate_picks_every_route(name):
    """_tensor_core_geometry holds at sps 32, 64 and 128 with at most 16
    tones: the align+demod kernels' compile-time walk there (entry
    ``demod_at`` / ``demod_at_energies``, route "mma", or "split" for
    float32, _demod_at_basis). Elsewhere within the reference's gate,
    _demod_at_geometry (128 % sps == 0: sps 4, 8, 16, and 32 or 64 tones at
    sps 64 and 128), their runtime-geometry walk (demod_at_any.cu: entries
    ``*_any``, route "at_any" counted under ``demod_at_any``,
    _demod_at_any_basis); outside it _demod_at_operands raises ValueError
    naming sps, where the reference's _demod_at_setup raises. The stream
    steps fuse within the gate and slice outside it, and decide_frame_tm
    takes the walk at _tensor_core_geometry ("mma" or "split" by dtype) and
    the runtime-geometry walk elsewhere (frame_tm_any.cu: entry
    ``decide_frame_tm_any``, route "tm_any", or "tm_any_split" for
    float32). The batch-major filterbank and decide_tones_tm follow the
    wider predicate, _filterbank_tensor_core_geometry (sps 32, 48, 64, 80
    or 128, at most 32 tones): their compile-time walks there; elsewhere
    their runtime-geometry walks (frame_tm_any.cu's ``decide_tones_tm_any``;
    filterbank_any.cu: entries ``*_any`` / ``*_any_f32``, routes "any" /
    "any_split" by the compute dtype), both with _filterbank_any_basis. No
    geometry is left without a route."""
    cfg = GEOMETRIES[name]
    sps = cfg.samples_per_symbol
    fast = tk._tensor_core_geometry(cfg)
    assert fast == (sps in (32, 64, 128) and cfg.num_tones <= 16)
    gate = 128 % sps == 0
    assert tk._demod_at_geometry(cfg) == gate
    for kind in ("demod_at", "demod_at_energies"):
        for key, dt in TM_DTYPES.items():
            if not gate:
                with pytest.raises(ValueError, match=re.escape(f"128 % samples_per_symbol == 0, got samples_per_symbol {sps}")):
                    tk._demod_at_operands("k", kind, cfg, dt, CPU)
                continue
            entry, route, basis = tk._demod_at_operands("k", kind, cfg, dt, CPU)
            if fast:
                assert (entry, route) == (kind, "split" if key == "f32" else "mma")
                assert basis is tk._demod_at_basis(cfg, dt, CPU)
            else:
                assert (entry, route) == (f"{kind}_any", "at_any")
                assert tk.OFF_WALK_KEYS[route] == "demod_at_any"
                assert basis is tk._demod_at_any_basis(cfg, dt, CPU)
    assert tstream._fused_demod(cfg) == gate
    walk = cfg.samples_per_symbol in (32, 48, 64, 80, 128) and cfg.num_tones <= 32
    assert tk._filterbank_tensor_core_geometry(cfg) == walk
    for key, dt in TM_DTYPES.items():
        kinds = ["decide_frame_tm"] if key == "int8" else ["decide_tones_tm", "decide_frame_tm"]
        for kind in kinds:
            if kind == "decide_frame_tm" and cfg.num_tones > 16:
                continue  # past the reference's bound: the wrapper raises
            entry, route, basis = tk._tm_operands(kind, cfg, dt, CPU)
            if fast if kind == "decide_frame_tm" else walk:
                assert route == ("split" if key == "f32" else "mma")
                assert entry == (kind if kind == "decide_frame_tm" else f"{kind}_mma")
            else:
                assert (entry, route) == (f"{kind}_any", "tm_any_split" if key == "f32" else "tm_any")
                assert basis is tk._filterbank_any_basis(cfg, dt, CPU)
    for compute in (torch.float32, torch.bfloat16):
        entry, route, basis = tk._filterbank_operands("tone_energies", cfg, compute, CPU)
        f32 = compute == torch.float32
        if walk:
            assert (entry, route) == (("tone_energies_mma_f32", "split") if f32 else ("tone_energies_mma", "mma"))
        else:
            assert (entry, route) == (("tone_energies_any_f32", "any_split") if f32 else ("tone_energies_any", "any"))
            assert basis is tk._filterbank_any_basis(cfg, compute, CPU)


@pytest.mark.parametrize("dtype", list(TM_DTYPES))
@pytest.mark.parametrize("geometry", [*PRESETS, "sps48-m4", "sps160-m64", "sps24-m2"])
def test_tm_any_basis_layout(geometry, dtype):
    """csrc/frame_tm_any.cu's basis (kernels._filterbank_any_basis for the
    samples' dtype), unpacked as the kernel reads it: per group of 32
    tones the interleaved columns (2c the cos of the group's tone c, 2c +
    1 its sin) of _plain_basis's entries over k-steps of 16 samples (32
    for int8, its x127 integers a byte each), zero rows past sps and zero
    columns past the group's tones; float32 as three bf16 terms summing to
    the entries exactly. Made once a config, dtype and device."""
    from test_torch_frame_tm_any import unpack_any_basis

    cfg, dt = GEOMETRIES[geometry], TM_DTYPES[dtype]
    m, sps = cfg.num_tones, cfg.samples_per_symbol
    basis = tk._filterbank_any_basis(cfg, dt, CPU)
    assert basis is tk._filterbank_any_basis(cfg, dt, CPU) and basis.dtype == torch.int32
    cols = unpack_any_basis(cfg, dt, basis)  # [groups, rows, 8 nt], float64
    gm = min(m, tk.FILTERBANK_GROUP)
    plain = tk._plain_basis(cfg, dt, CPU).double().numpy()
    assert cols.shape[1] >= sps and not cols[:, sps:].any()
    for grp in range(m // gm):
        np.testing.assert_array_equal(cols[grp, :sps, 0 : 2 * gm : 2], plain[:, grp * gm : (grp + 1) * gm])
        np.testing.assert_array_equal(cols[grp, :sps, 1 : 2 * gm : 2], plain[:, m + grp * gm : m + (grp + 1) * gm])
        assert not cols[grp, :, 2 * gm :].any()


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("geometry", [*PRESETS, "sps48-m16", "sps80-m8", "sps64-m32", "sps128-m32", "m24"])
def test_filterbank_mma_basis_layout(geometry, dtype):
    """The batch-major filterbank's tensor-core B operand off the other
    walks' geometry (sps 48 and 80, 17-32 tones: 8 n8 tiles),
    _demod_mma_basis (bfloat16 compute) and _demod_split_basis (float32
    compute: three terms), read back as csrc/demod_core.cuh's fragments
    read them, is the interleaved basis of _plain_basis's entries (the
    terms summing to the float32 ones exactly), zero columns past the tone
    count. ModemConfig takes only powers of two, so 24 tones ("m24", sps
    48) packs a basis of 24 tones' columns through _mma_fragments."""
    from test_torch_kernels_ref import _unpack_demod_mma_basis

    if geometry == "m24":
        cfg = type("Geometry", (), {"num_tones": 24, "samples_per_symbol": 48})()
        plain = torch.from_numpy(np.random.default_rng(24).standard_normal((48, 48)).astype(np.float32))
    else:
        cfg = GEOMETRIES[geometry]
        plain = tk._plain_basis(cfg, TM_DTYPES[dtype], CPU)
    m, sps = cfg.num_tones, cfg.samples_per_symbol
    n = tk._demod_mma_tiles(m)
    assert n == {8: 2, 16: 4, 24: 8, 32: 8}[m]
    if geometry == "m24" and dtype == "bf16":
        plain = plain.to(torch.bfloat16).float()
        terms = [tk._mma_fragments(cfg, plain, torch.bfloat16)]
    elif geometry == "m24":
        terms = [tk._mma_fragments(cfg, t, torch.bfloat16) for t in tk._split_terms(plain)]
    elif dtype == "bf16":
        terms = [tk._demod_mma_basis(cfg, torch.bfloat16, CPU)]
    else:
        split = tk._demod_split_basis(cfg, CPU)
        assert split.shape == (3, sps // 16, n, 2, 32)
        terms = list(split)
    assert all(t.dtype == torch.int32 and t.shape == (sps // 16, n, 2, 32) for t in terms)
    b = sum(_unpack_demod_mma_basis(t, torch.bfloat16).double() for t in terms)
    assert b.shape == (sps, 8 * n)
    assert torch.equal(b[:, 0 : 2 * m : 2], plain[:, :m].double())
    assert torch.equal(b[:, 1 : 2 * m : 2], plain[:, m:].double())
    assert not bool(b[:, 2 * m :].any())


def _record_launches(monkeypatch) -> list:
    """The card's calls of the time-major launch code replaced by recorders;
    each checked launch counted as the wrapper counts it (its route's key),
    into zeroed launch_counts."""
    calls = []
    monkeypatch.setattr(tk, "_entry", lambda key: lambda *args: calls.append((key, args)) or 0)
    monkeypatch.setattr(tk, "_stream_handle", lambda dev: 0)
    monkeypatch.setattr(tk, "_check_cuda_input", lambda name, t, what, int8=False: tk._KERNEL_DTYPES[t.dtype])
    monkeypatch.setattr(tk, "launch_counts", dict.fromkeys(tk.launch_counts, 0))

    def checked(err, name, dtype=None, route=None):
        calls.append(("checked", name, route))
        tk._count_launch(name, dtype, route)

    monkeypatch.setattr(tk, "_check_launch", checked)
    return calls


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("geometry", ["sps24-m8", "sps96-m32", "sps160-m64"])
def test_decide_tones_tm_any_launch(monkeypatch, geometry, dtype):
    """decide_tones_tm off its walk's geometry (sps 24, 96, 160; 64 tones):
    the entry decide_tones_tm_any of the frame_tm_any library with the
    arguments of the walk's entry (data, dtype code, B, sps, tones,
    symbols, basis, outputs) and _filterbank_any_basis; one launch counted
    under the runtime-geometry walk's key, frame_tm_any, none under
    decide_tones_tm's."""
    from anet_torch.kernels import build

    cfg, dt = GEOMETRIES[geometry], TM_DTYPES[dtype]
    sps = cfg.samples_per_symbol
    x = torch.randn(5 * sps + 3, 7).to(dt)
    calls = _record_launches(monkeypatch)
    tone, best, total = tk._decide_tones_tm_launch(cfg, x)
    (key, args), checked = calls
    route = "tm_any_split" if dt == torch.float32 else "tm_any"
    assert checked == ("checked", "decide_tones_tm", route) and key == "decide_tones_tm_any"
    assert build.SIGNATURES[key][2] == "frame_tm_any" and "frame_tm_any" in build.SOURCES
    assert "frame_tm_generic" not in build.SOURCES
    assert build.SIGNATURES[key][1] == build.SIGNATURES["decide_tones_tm_mma"][1]
    assert {k: v for k, v in tk.launch_counts.items() if v} == {
        "frame_tm_any" + (":f32" if dt == torch.float32 else ""): 1
    }
    basis = tk._filterbank_any_basis(cfg, dt, CPU)
    assert args == (x.data_ptr(), tk._KERNEL_DTYPES[dt], 7, sps, cfg.num_tones, 5, basis.data_ptr(),
                    tone.data_ptr(), best.data_ptr(), total.data_ptr(), 0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("geometry", [*PRESETS, "sps48-m4", "sps80-m16", "sps64-m32"])
def test_decide_tones_tm_walk_launch(monkeypatch, geometry, dtype):
    """decide_tones_tm on its walk's wider geometry (sps 48 and 80, up to
    32 tones: both presets; 17-32 tones as 8 n-tiles at sps 64 too): the
    tensor-core entry of the decide_frame_tm library, route "mma" for
    bfloat16 and "split" for float32 data, with _demod_at_basis (8 n-tiles
    past 16 tones); one launch counted under decide_tones_tm's key (":f32"
    for float32), none under frame_tm_any's."""
    from anet_torch.kernels import build

    cfg, dt = GEOMETRIES[geometry], TM_DTYPES[dtype]
    sps = cfg.samples_per_symbol
    x = torch.randn(5 * sps + 3, 7).to(dt)
    calls = _record_launches(monkeypatch)
    tone, best, total = tk._decide_tones_tm_launch(cfg, x)
    (key, args), checked = calls
    route = "split" if dt == torch.float32 else "mma"
    assert checked == ("checked", "decide_tones_tm", route) and key == "decide_tones_tm_mma"
    assert build.SIGNATURES[key][2] == "decide_frame_tm"
    assert {k: v for k, v in tk.launch_counts.items() if v} == {
        "decide_tones_tm" + (":f32" if dt == torch.float32 else ""): 1
    }
    basis = tk._demod_at_basis(cfg, dt, CPU)
    n = tk._demod_mma_tiles(cfg.num_tones)
    assert basis.shape == ((3,) if dt == torch.float32 else ()) + (sps // 16, n, 2, 32)
    assert args == (x.data_ptr(), tk._KERNEL_DTYPES[dt], 7, sps, cfg.num_tones, 5, basis.data_ptr(),
                    tone.data_ptr(), best.data_ptr(), total.data_ptr(), 0)


@pytest.mark.parametrize("dtype", list(TM_DTYPES))
@pytest.mark.parametrize("geometry", ["sps48-m4", "sps80-m16", "sps24-m2"])
def test_decide_frame_tm_any_launch(monkeypatch, geometry, dtype):
    """decide_frame_tm off the walk's geometry: the entry
    decide_frame_tm_any with the walk's arguments, _filterbank_any_basis
    for the samples' dtype and the packed-word CRC masks; one launch under
    frame_tm_any's key for the dtype. Past the reference's bounds it still
    raises: more than 16 tones, or bits a symbol outside {1, 2, 4}."""
    from anet_torch.kernels import build

    cfg, dt = GEOMETRIES[geometry], TM_DTYPES[dtype]
    pre, sps, bps = 3, cfg.samples_per_symbol, cfg.bits_per_symbol
    s = data_symbols_for_payload(cfg, PAY)
    n_tiles = -(-s // tk.TM_SYMBOL_TILE)
    x = torch.randn(pre + s * sps, 5).to(dt)
    calls = _record_launches(monkeypatch)
    words, crc, qual, n_sym = tk._decide_frame_tm_launch(cfg, x, PAY, pre)
    (key, args), checked = calls
    route = "tm_any_split" if dt == torch.float32 else "tm_any"
    assert checked == ("checked", "decide_frame_tm", route) and key == "decide_frame_tm_any"
    assert build.SIGNATURES[key][1] == build.SIGNATURES["decide_frame_tm"][1]
    assert build.SIGNATURES[key][2] == "frame_tm_any"
    assert {k: v for k, v in tk.launch_counts.items() if v} == {
        "frame_tm_any" + {"f32": ":f32", "bf16": "", "int8": ":int8"}[dtype]: 1
    }
    assert n_sym == s and words.shape == (n_tiles, 5) and not crc.any() and not qual.any()
    basis = tk._filterbank_any_basis(cfg, dt, CPU)
    masks = tk._frame_crc_masks(PAY, n_tiles, bps, CPU)
    assert args == (x.data_ptr(), tk._KERNEL_DTYPES[dt], 5, pre, sps, cfg.num_tones, s, n_tiles, bps,
                    basis.data_ptr(), masks.data_ptr(), words.data_ptr(), crc.data_ptr(), qual.data_ptr(), 0)
    for bad in (GEOMETRIES["mfsk32-dense"], GEOMETRIES["mfsk8-audible"]):  # 32 tones; 3 bits a symbol
        t = pre + data_symbols_for_payload(bad, PAY) * bad.samples_per_symbol
        with pytest.raises(ValueError):
            tk._decide_frame_tm_launch(bad, torch.zeros(t, 5, dtype=dt), PAY, pre)


# --- the receivers on both presets against anet ------------------------------


def _no_fused_kernels(monkeypatch) -> None:
    """The align+demod wrappers raise if called: these geometries take the
    slice and the batch-major receiver."""

    def refuse(*args, **kwargs):
        raise AssertionError("an align+demod kernel was called off its geometry")

    for name in ("demod_at_fused", "demod_at_energies_fused", "demod_probe_fused"):
        monkeypatch.setattr(tk, name, refuse)


def _stream_capture(cfg, seed: int, lens, chunk: int):
    """([B, N] float32 capture, payloads [frames] of [B, n]): a different
    gap before each stream's first frame, the frames back to back, a frame
    of silence, whole chunks, low noise."""
    rng = np.random.default_rng(seed)
    tx = tfamily.transmit_fn(cfg, device="cpu")
    waves, sent = [], []
    for n in lens:
        pay = rng.integers(0, 256, (B, n), dtype=np.uint8)
        sent.append(pay)
        waves.append(tx(pay).numpy())
    body = np.concatenate(waves, -1)
    t_max = tfamily.frame_samples(cfg, max(lens))
    n = -(-(400 + 64 * B + body.shape[1] + t_max) // chunk) * chunk
    cap = np.zeros((B, n), np.float32)
    for i in range(B):
        g = 150 + 64 * i
        cap[i, g : g + body.shape[1]] = body[i]
    return cap + 0.05 * rng.standard_normal(cap.shape).astype(np.float32), sent


def _assert_same_stream(got, want, n_frames: int):
    det = got.steps.detected.numpy()
    np.testing.assert_array_equal(det, np.asarray(want.steps.detected))
    for f in FRAME_FIELDS + (("payload_len",) if hasattr(got.steps.frame, "payload_len") else ()):
        np.testing.assert_array_equal(
            getattr(got.steps.frame, f).numpy()[det], np.asarray(getattr(want.steps.frame, f))[det], f
        )
    np.testing.assert_array_equal(got.steps.frame.ok.numpy(), np.asarray(want.steps.frame.ok))
    np.testing.assert_array_equal(got.steps.frame_start.numpy()[det], np.asarray(want.steps.frame_start)[det])
    for f in ("frames_detected", "frames_ok", "decode_errors", "next_start", "locked", "last_frame_end"):
        np.testing.assert_array_equal(getattr(got.carry, f).numpy(), np.asarray(getattr(want.carry, f)), f)
    np.testing.assert_allclose(
        got.steps.frame.confidence.numpy()[det], np.asarray(want.steps.frame.confidence)[det], rtol=1e-4
    )
    assert int(got.carry.frames_ok.sum()) == B * n_frames


@pytest.mark.parametrize("compute", ["bf16", "f32"])
@pytest.mark.parametrize("geometry", [*PRESETS, "sps40-m4"])
def test_filterbank_launch_off_the_other_walks(monkeypatch, geometry, compute):
    """Both filterbank wrappers' launch code, the card's calls replaced by
    recorders: at both presets (sps 48 with 8 tones, sps 80 with 32) each
    compute dtype takes the tensor-core entry, ``*_mma`` with
    _demod_mma_basis for bfloat16 compute and ``*_mma_f32`` with
    _demod_split_basis for float32, and counts under the wrapper's own key
    (":f32" for float32 compute), never filterbank_any's; a custom sps-40
    config takes filterbank_any.cu's runtime-geometry entry, ``*_any``
    (bfloat16 compute) or ``*_any_f32`` (float32), with the rows, their
    dtype code, R and pitch and _filterbank_any_basis, counted under
    filterbank_any (":f32" for float32 compute)."""
    cfg, cdt = _custom(40, 4) if geometry == "sps40-m4" else GEOMETRIES[geometry], TM_DTYPES[compute]
    sps, n_sym = cfg.samples_per_symbol, 5
    rows = torch.randn(3, n_sym * sps + 7).to(cdt)
    calls = _record_launches(monkeypatch)
    suffix = ":f32" if cdt == torch.float32 else ""
    for kind, n_out in (("tone_energies", 1), ("decide_tones", 3)):
        calls.clear()
        monkeypatch.setattr(tk, "launch_counts", dict.fromkeys(tk.launch_counts, 0))
        tk._filterbank_launch(f"{kind}_fused", kind, cfg, rows, cdt, lambda lead, s, dev: tuple(
            torch.empty(*lead, s) for _ in range(n_out)))
        (key, args), (_, name, route) = calls
        counted = {k: v for k, v in tk.launch_counts.items() if v}
        if geometry == "sps40-m4":
            f32 = cdt == torch.float32
            assert (key, route) == ((f"{kind}_any_f32", "any_split") if f32 else (f"{kind}_any", "any"))
            assert name == f"{kind}_fused" and counted == {f"filterbank_any{suffix}": 1}
            assert args[:4] == (rows.data_ptr(), tk._KERNEL_DTYPES[cdt], 3, rows.stride(0))
            assert args[4:8] == (n_sym, sps, cfg.num_tones, tk._filterbank_any_basis(cfg, cdt, CPU).data_ptr())
            continue
        mma = cdt == torch.bfloat16
        assert (key, route) == ((f"{kind}_mma", "mma") if mma else (f"{kind}_mma_f32", "split"))
        assert name == f"{kind}_fused" and counted == {f"{kind}_fused{suffix}": 1}
        basis = tk._demod_mma_basis(cfg, torch.bfloat16, CPU) if mma else tk._demod_split_basis(cfg, CPU)
        n_head = 4 if mma else 5
        assert args[n_head : n_head + 4] == (n_sym, sps, cfg.num_tones, basis.data_ptr())



@pytest.mark.parametrize("lock", [False, True], ids=["search", "lock"])
@pytest.mark.parametrize("carry", ["f32", "int8"])
@pytest.mark.parametrize("name", PRESETS)
def test_receive_stream_matches_anet(monkeypatch, name, carry, lock):
    """receive_stream at B = 4, payload 16, a float32 or an int8 carry
    (the capture quantized at ingest), searching or in frame lock: every
    frame decoded, detections, payloads, verdicts, frame starts and
    counters equal to anet's, confidence rtol 1e-4; no align+demod
    wrapper called."""
    cfg, jcfg = get_model(name).config, jget_model(name).config
    _no_fused_kernels(monkeypatch)
    chunk = tfamily.frame_samples(cfg, PAY) // 128 * 128
    cap, _ = _stream_capture(cfg, 11 + len(name) + 2 * lock, (PAY,) * 3, chunk)
    int8 = carry == "int8"
    tc = tstream.init_carry(cfg, chunk, PAY, (B,), dtype=torch.int8, device="cpu") if int8 else None
    jc = jstream.init_carry(jcfg, chunk, PAY, (B,), dtype=jnp.int8) if int8 else None
    got = tstream.receive_stream(cfg, cap, chunk, PAY, lock=lock, carry=tc, device="cpu")
    want = jstream.receive_stream(jcfg, jnp.asarray(cap), chunk, PAY, lock=lock, carry=jc)
    _assert_same_stream(got, want, 3)
    np.testing.assert_array_equal(got.carry.buffer.numpy(), np.asarray(want.carry.buffer))


@pytest.mark.parametrize("name", PRESETS)
def test_receive_stream_dynamic_matches_anet(monkeypatch, name):
    """receive_stream_dynamic in frame lock at B = 4 with header-declared
    lengths 8, 16 and 12 (maximum 16): every frame decoded, declared
    lengths, payloads, verdicts, frame starts and counters equal to
    anet's; no align+demod wrapper called."""
    cfg, jcfg = get_model(name).config, jget_model(name).config
    _no_fused_kernels(monkeypatch)
    lens = (8, 16, 12)
    chunk = tfamily.frame_samples(cfg, min(lens)) // 128 * 128
    cap, sent = _stream_capture(cfg, 29 + len(name), lens, chunk)
    got = tstream.receive_stream_dynamic(cfg, cap, chunk, PAY, lock=True, device="cpu")
    want = jstream.receive_stream_dynamic(jcfg, jnp.asarray(cap), chunk, PAY, lock=True)
    _assert_same_stream(got, want, len(lens))
    det = got.steps.detected.numpy()
    np.testing.assert_array_equal(got.steps.frame.payload_len.numpy().T[det.T].reshape(B, -1),
                                  np.tile(np.array(lens), (B, 1)))
    payloads = got.steps.frame.payload.numpy().transpose(1, 0, 2)[det.T].reshape(B, len(lens), -1)
    for j, n in enumerate(lens):  # each stream's frames in time order, as sent
        np.testing.assert_array_equal(payloads[:, j, :n], sent[j])


@pytest.mark.parametrize("name", PRESETS)
def test_demodulate_frame_tm_matches_anet(monkeypatch, name):
    """The aligned time-major receiver on both presets at its default bf16
    compute (3 and 5 bits a symbol: the decisions kernel decide_tones_tm,
    here its plain version) against anet's demodulate_frame_tm with its
    Pallas decide_tones_tm in interpret mode: payloads and verdicts equal,
    every frame decoded, confidence rtol 1e-5."""
    cfg, jcfg = get_model(name).config, jget_model(name).config
    tdt, jdt = torch.bfloat16, jnp.bfloat16
    monkeypatch.setattr(jk, "decide_tones_tm", functools.partial(jk.decide_tones_tm, interpret=True))
    rng = np.random.default_rng(5 + len(name))
    payload = rng.integers(0, 256, (B, PAY), dtype=np.uint8)
    x = tfamily.transmit_fn(cfg, device="cpu")(payload).numpy()
    x_tm = np.ascontiguousarray((x + 0.3 * rng.standard_normal(x.shape).astype(np.float32)).T)
    got = tframe.demodulate_frame_tm(cfg, torch.from_numpy(x_tm).to(tdt), PAY, compute_dtype=tdt, device="cpu")
    want = jframe.demodulate_frame_tm(jcfg, jnp.asarray(x_tm).astype(jdt), PAY, compute_dtype=jdt,
                                      use_pallas=True, interpret=True)
    for f in FRAME_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), f)
    np.testing.assert_array_equal(got.payload.numpy(), payload)
    assert bool(got.ok.all())
    np.testing.assert_allclose(got.confidence.numpy(), np.asarray(want.confidence), rtol=1e-5)


@pytest.mark.parametrize("geometry", ["sps48-m4", "sps80-m16"])
def test_decide_frame_tm_ref_matches_anet_off_the_walk(geometry):
    """decide_frame_tm's plain version at two custom geometries the walk
    does not take (sps 48 with 4 tones and 2 bits, sps 80 with 16 tones
    and 4 bits) against anet's decide_frame_tm in interpret mode: words and
    CRC counts equal, quality sums rtol 1e-5."""
    sps, m = {"sps48-m4": (48, 4), "sps80-m16": (80, 16)}[geometry]
    cfg, jcfg = _custom(sps, m), _custom(sps, m, JModemConfig)
    rng = np.random.default_rng(sps + m)
    payload = rng.integers(0, 256, (B, PAY), dtype=np.uint8)
    x = tfamily.transmit_fn(cfg, device="cpu")(payload).numpy()
    x_tm = np.ascontiguousarray((x + 0.3 * rng.standard_normal(x.shape).astype(np.float32)).T)
    pre = cfg.preamble_symbols * sps
    got = tk.decide_frame_tm_ref(cfg, torch.from_numpy(x_tm), PAY, preamble_offset=pre)
    want = jk.decide_frame_tm(jcfg, jnp.asarray(x_tm), PAY, compute_dtype=jnp.float32, interpret=True,
                              preamble_offset=pre)
    assert got[3] == int(want[3])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2][:3].numpy(), np.asarray(want[2])[:3], rtol=1e-5)
    res = tframe.frame_result_from_packed(cfg, *got, PAY)
    np.testing.assert_array_equal(res.payload.numpy(), payload)
    assert bool(res.ok.all())
