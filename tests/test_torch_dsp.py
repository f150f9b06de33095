"""anet_torch's signal-chain modules against the JAX package, on the CPU:
constants, configs, bits, CRC-32, synthesis, the demod basis and the
preamble correlation/quality functions. Inputs are made with numpy from a
seed and handed to both packages."""

import dataclasses
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import anet.constants as jconst
from anet.dsp import bits as jbits
from anet.dsp import demod as jdemod
from anet.dsp import fec as jfec
from anet.dsp import frame as jframe
from anet.dsp import mod as jmod
from anet.dsp import sync as jsync
from anet.dsp.params import ModemConfig as JModemConfig
from anet.models import get_model as jget_model
from anet.models import list_models as jlist_models

import anet_torch.constants as tconst
from anet_torch.dsp import bits as tbits
from anet_torch.dsp import demod as tdemod
from anet_torch.dsp import fec as tfec
from anet_torch.dsp import frame as tframe
from anet_torch.dsp import mod as tmod
from anet_torch.dsp import sync as tsync
from anet_torch.dsp.params import ModemConfig
from anet_torch.models import get_model, list_models

CPU = "cpu"
MFSK = [m.name for m in jlist_models() if isinstance(m.config, JModemConfig)]


def _t(x):
    return torch.as_tensor(np.array(x))


def test_constants_equal():
    names = [n for n in dir(jconst) if n.isupper()]
    assert names
    for n in names:
        assert getattr(tconst, n) == getattr(jconst, n), n


@pytest.mark.parametrize("name", MFSK)
def test_presets_and_json_roundtrip(name):
    jcfg = jget_model(name).config
    cfg = get_model(name).config
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert ModemConfig.from_json(jcfg.to_json()) == cfg
    assert cfg.to_json() == jcfg.to_json()
    assert cfg.coded_bits_for_data_bits(1000) == jcfg.coded_bits_for_data_bits(1000)
    assert [m.name for m in list_models()] == [m.name for m in jlist_models()]  # OFDM presets too


@pytest.mark.parametrize("bps", [1, 2, 3, 4, 5])
def test_bits_symbols_gray(bps):
    rng = np.random.default_rng(bps)
    data = rng.integers(0, 256, (3, 15), dtype=np.uint8)
    jb = np.asarray(jbits.bytes_to_bits(jnp.asarray(data)))
    tb = tbits.bytes_to_bits(_t(data)).numpy()
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tbits.bits_to_bytes(_t(tb)).numpy(), data)
    sym_bits = jb[:, : jb.shape[1] // bps * bps]
    js = np.asarray(jbits.pack_symbols(jnp.asarray(sym_bits), bps))
    ts = tbits.pack_symbols(_t(sym_bits), bps).numpy()
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(
        tbits.unpack_symbols(_t(ts), bps).numpy(),
        np.asarray(jbits.unpack_symbols(jnp.asarray(js), bps)),
    )
    vals = np.arange(1 << bps, dtype=np.int32)
    g = tbits.gray_encode(_t(vals)).numpy()
    np.testing.assert_array_equal(g, np.asarray(jbits.gray_encode(jnp.asarray(vals))))
    np.testing.assert_array_equal(tbits.gray_decode(_t(g), bps).numpy(), vals)


@pytest.mark.parametrize("n", [0, 1, 6, 64, 267])
def test_crc32_host_device_zlib(n):
    rng = np.random.default_rng(n)
    data = rng.integers(0, 256, (4, n), dtype=np.uint8)
    want = np.array([zlib.crc32(r.tobytes()) for r in data], np.int64)
    np.testing.assert_array_equal(tfec.crc32_device(_t(data)).numpy(), want)
    np.testing.assert_array_equal(
        np.asarray(jfec.crc32_device(jnp.asarray(data))).astype(np.int64), want
    )
    assert [tfec.crc32_host(r.tobytes()) for r in data] == list(want)
    p_t, c_t = tfec._crc32_bit_table(n)
    p_j, c_j = jfec._crc32_bit_table(n)
    np.testing.assert_array_equal(p_t, p_j)
    assert c_t == c_j


@pytest.mark.parametrize("phase_continuous", [False, True])
def test_synthesize_tones_matches_jax(phase_continuous):
    cfg = dataclasses.replace(get_model("mfsk16-fast").config, phase_continuous=phase_continuous)
    jcfg = dataclasses.replace(jget_model("mfsk16-fast").config, phase_continuous=phase_continuous)
    rng = np.random.default_rng(7)
    tones = rng.integers(0, 16, (2, 12)).astype(np.int32)
    got = tmod.synthesize_tones(cfg, _t(tones)).numpy()
    want = np.asarray(jmod.synthesize_tones(jcfg, jnp.asarray(tones)))
    # block phase: f32 sin ulps. CPFSK: the phase is a float32 running sum
    # (~1.4e3 rad after 768 samples, ulp ~1.2e-4), summed in another order
    # by each package, so the sinusoids differ by about that much.
    atol = 1e-3 if phase_continuous else 1e-5
    np.testing.assert_allclose(got, want, atol=atol)
    syms = rng.integers(0, 16, (2, 12)).astype(np.int32)
    np.testing.assert_allclose(
        tmod.modulate_symbols(cfg, _t(syms)).numpy(),
        np.asarray(jmod.modulate_symbols(jcfg, jnp.asarray(syms))),
        atol=atol,
    )


@pytest.mark.parametrize("name", ["mfsk16-fast", "fsk2-robust", "mfsk8-audible", "mfsk32-dense"])
def test_modulate_frame_matches_jax(name):
    rng = np.random.default_rng(11)
    pay = rng.integers(0, 256, (2, 40), dtype=np.uint8)
    got = tframe.modulate_frame(get_model(name).config, pay, device=CPU).numpy()
    want = np.asarray(jframe.modulate_frame(jget_model(name).config, jnp.asarray(pay)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_array_equal(
        tsync.preamble_tone_indices(get_model(name).config, CPU).numpy(),
        np.asarray(jsync.preamble_tone_indices(jget_model(name).config)),
    )


@pytest.mark.parametrize("name", ["mfsk16-fast", "fsk2-robust", "mfsk32-dense"])
def test_demod_basis_matches_jax(name):
    got = tdemod.demod_basis(get_model(name).config, device=CPU).numpy()
    want = np.asarray(jdemod.demod_basis(jget_model(name).config))
    np.testing.assert_allclose(got, want, atol=1e-6)


def _signal(rng, b, n, k_start):
    """Noise with a preamble planted at per-stream k_start."""
    cfg = get_model("mfsk16-fast").config
    tpl = np.asarray(jsync.preamble_waveform(jget_model("mfsk16-fast").config))
    x = 0.1 * rng.standard_normal((b, n)).astype(np.float32)
    for i, s in enumerate(k_start):
        x[i, s : s + tpl.size] += tpl
    return cfg, tpl, x


def test_correlate_and_blockwise_quality_match_jax():
    rng = np.random.default_rng(3)
    _, tpl, x = _signal(rng, 3, 4096 + 2047, [5, 1000, 3000])
    k = tpl.size
    te = float(np.sum(tpl * tpl))
    cj = np.asarray(jsync.correlate_template(jnp.asarray(x), jnp.asarray(tpl), method="matmul"))
    ct = tsync.correlate_template(_t(x), _t(tpl), method="matmul").numpy()
    scale = np.abs(cj).max()
    np.testing.assert_allclose(ct, cj, rtol=1e-4, atol=1e-4 * scale)
    qj = np.asarray(jsync.blockwise_match_quality(jnp.asarray(x), jnp.asarray(cj), k, te))
    qt = tsync.blockwise_match_quality(_t(x), _t(ct), k, te).numpy()
    np.testing.assert_allclose(qt, qj, rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(qt.argmax(-1), [5, 1000, 3000])


def test_preamble_quality_probe_matches_jax():
    rng = np.random.default_rng(4)
    starts = [124 + 2, 125 + 2, 126 + 2, 127 + 2, 300, 2]
    _, tpl, x = _signal(rng, len(starts), 8192, starts)
    te = float(np.sum(tpl * tpl))
    st = np.asarray(starts, np.int32)
    qj, st0j = jsync.preamble_quality_probe(jnp.asarray(x), jnp.asarray(st), jnp.asarray(tpl), te)
    qt, st0t = tsync.preamble_quality_probe(_t(x), _t(st), _t(tpl), te)
    np.testing.assert_array_equal(st0t.numpy(), np.asarray(st0j))
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(qt.numpy().argmax(-1), np.asarray(qj).argmax(-1))


@pytest.mark.parametrize("method", ["fft", "direct", "matmul", "auto"])
def test_correlate_template_methods_match_jax(method):
    """Every backend of correlate_template against the reference's on the
    same signal, within 1e-4 of the correlation's scale; ``auto`` is the
    FFT on the CPU in both packages."""
    rng = np.random.default_rng(11)
    _, tpl, x = _signal(rng, 2, 3000, [17, 900])
    cj = np.asarray(jsync.correlate_template(jnp.asarray(x), jnp.asarray(tpl), method=method))
    ct = tsync.correlate_template(_t(x), _t(tpl), method=method)
    assert ct.dtype == torch.float32 and ct.shape == cj.shape == (2, 3000 - tpl.size + 1)
    scale = np.abs(cj).max()
    np.testing.assert_allclose(ct.numpy(), cj, rtol=1e-4, atol=1e-4 * scale)
    np.testing.assert_array_equal(np.abs(ct.numpy()).argmax(-1), [17, 900])
    if method == "auto":
        fft = tsync.correlate_template(_t(x), _t(tpl), method="fft")
        assert torch.equal(ct, fft)


def test_correlate_template_fft_len_and_errors():
    """The FFT size: the default next_pow2(N + K - 1); next_pow2(N) aliases
    only outside the valid lags; shorter than N raises, as the reference;
    the default method is the FFT; bf16 operands widen to float32."""
    rng = np.random.default_rng(12)
    _, tpl, x = _signal(rng, 1, 2500, [300])
    xt, tt = _t(x), _t(tpl)
    full = tsync.correlate_template(xt, tt, method="fft")
    short = tsync.correlate_template(xt, tt, method="fft", fft_len=4096)
    cj = np.asarray(jsync.correlate_template(jnp.asarray(x), jnp.asarray(tpl), method="fft", fft_len=4096))
    scale = float(full.abs().max())
    np.testing.assert_allclose(short.numpy(), full.numpy(), atol=1e-4 * scale)
    np.testing.assert_allclose(short.numpy(), cj, atol=1e-4 * scale)
    assert torch.equal(tsync.correlate_template(xt, tt), full)
    for corr in (tsync.correlate_template, jsync.correlate_template):
        arr, t = (xt, tt) if corr is tsync.correlate_template else (jnp.asarray(x), jnp.asarray(tpl))
        with pytest.raises(ValueError, match="fft_len 2048 shorter than the capture"):
            corr(arr, t, method="fft", fft_len=2048)
        with pytest.raises(ValueError, match="longer than capture"):
            corr(arr[..., :100], t)
    bf = tsync.correlate_template(xt.to(torch.bfloat16), tt.to(torch.bfloat16), method="direct")
    want = np.asarray(jsync.correlate_template(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(tpl).astype(jnp.bfloat16), method="direct"))
    assert bf.dtype == torch.float32
    np.testing.assert_allclose(bf.numpy(), want.astype(np.float32), rtol=1e-2, atol=1e-2 * scale)


def test_preamble_quality_probe_fused_mode_matches_jax(interpret_tpu_kernels):
    """mode="fused" (probe_at_fused's st0-aligned span; its plain version
    on the CPU) against the reference's fused mode, whose Pallas kernel
    runs in interpret mode: st0 equal, quality rtol 1e-4; the default mode
    keeps the row-aligned span, which differs by a few percent."""
    rng = np.random.default_rng(13)
    starts = [124 + 2, 127 + 2, 300, 2, 1000]
    _, tpl, x = _signal(rng, len(starts), 8192, starts)
    te = float(np.sum(tpl * tpl))
    st = np.asarray(starts, np.int32)
    qt, st0t = tsync.preamble_quality_probe(_t(x), _t(st), _t(tpl), te, mode="fused", start_bound=1000)
    qa, _ = tsync.preamble_quality_probe(_t(x), _t(st), _t(tpl), te)
    interpret_tpu_kernels()
    qj, st0j = jsync.preamble_quality_probe(
        jnp.asarray(x), jnp.asarray(st), jnp.asarray(tpl), te, mode="fused", start_bound=1000
    )
    np.testing.assert_array_equal(st0t.numpy(), np.asarray(st0j))
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(qt.numpy().argmax(-1), np.asarray(qj).argmax(-1))
    assert qt.shape == (len(starts), 5) and not torch.equal(qt, qa)
    np.testing.assert_array_equal(qt.argmax(-1).numpy(), qa.argmax(-1).numpy())


def test_aligned_gather_takes_start_bound():
    """start_bound is accepted and changes nothing (a TPU DMA hint in the
    reference); the values are the reference's with the same bound."""
    rng = np.random.default_rng(14)
    buf = rng.standard_normal((3, 1024)).astype(np.float32)
    starts = np.array([0, 129, 500], np.int32)
    got = tsync.aligned_gather(_t(buf), _t(starts), 300, start_bound=500)
    assert torch.equal(got, tsync.aligned_gather(_t(buf), _t(starts), 300))
    want = jsync.aligned_gather(jnp.asarray(buf), jnp.asarray(starts), 300, start_bound=500)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _noisy_frames(name, b, pay, noise, seed):
    cfg, jcfg = get_model(name).config, jget_model(name).config
    rng = np.random.default_rng(seed)
    p = rng.integers(0, 256, (b, pay), dtype=np.uint8)
    w = tframe.modulate_frame(cfg, p, device=CPU).numpy()
    return cfg, jcfg, p, w + noise * rng.standard_normal(w.shape).astype(np.float32)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name", ["mfsk16-fast", "mfsk4-coded"])
def test_demodulate_frame_use_pallas_matches_jax(name, use_pallas):
    """demodulate_frame(use_pallas=) and demodulate_frame_tm(use_pallas=)
    (False: the plain products; True: the kernels' plain versions on the
    CPU) against the reference's route off its TPU: payloads and verdicts
    equal, confidence and snr_db rtol 1e-4; the default (None) is the
    kernel route."""
    cfg, jcfg, p, w = _noisy_frames(name, 5, 24, 0.3, 15 + use_pallas)
    got = tframe.demodulate_frame(cfg, w, 24, use_pallas=use_pallas, device=CPU)
    want = jframe.demodulate_frame(jcfg, jnp.asarray(w), 24)
    tm = tframe.demodulate_frame_tm(cfg, np.ascontiguousarray(w.T), 24, compute_dtype=torch.float32,
                                    use_pallas=use_pallas, device=CPU)
    jtm = jframe.demodulate_frame_tm(jcfg, jnp.asarray(w.T), 24, compute_dtype=jnp.float32, use_pallas=False)
    for g, wnt in ((got, want), (tm, jtm)):
        np.testing.assert_array_equal(g.payload.numpy(), np.asarray(wnt.payload))
        for f in ("magic_ok", "length_ok", "header_crc_ok", "payload_crc_ok", "ok"):
            np.testing.assert_array_equal(getattr(g, f).numpy(), np.asarray(getattr(wnt, f)), f)
        np.testing.assert_allclose(g.confidence.numpy(), np.asarray(wnt.confidence), rtol=1e-4)
        np.testing.assert_allclose(g.snr_db.numpy(), np.asarray(wnt.snr_db), rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(got.payload.numpy(), p)
    default = tframe.demodulate_frame(cfg, w, 24, device=CPU)
    assert torch.equal(default.payload, got.payload)


def test_demodulate_frame_tm_use_pallas_false_refuses_int8():
    cfg = get_model("mfsk16-fast").config
    x8 = np.zeros((tframe.frame_num_samples(cfg, 4), 2), np.int8)
    with pytest.raises(ValueError, match="quantized-ingest"):
        tframe.demodulate_frame_tm(cfg, x8, 4, compute_dtype=torch.int8, use_pallas=False, device=CPU)
    with pytest.raises(ValueError, match="quantized-ingest"):
        jframe.demodulate_frame_tm(jget_model("mfsk16-fast").config, jnp.asarray(x8), 4,
                                   compute_dtype=jnp.int8, use_pallas=False)


@pytest.mark.parametrize("name", ["mfsk16-fast", "fsk2-robust", "mfsk32-dense"])
def test_demodulate_symbols_matches_jax(name):
    cfg, jcfg = get_model(name).config, jget_model(name).config
    rng = np.random.default_rng(16)
    x = rng.standard_normal((3, 20 * cfg.samples_per_symbol)).astype(np.float32)
    sym, conf = tdemod.demodulate_symbols(cfg, _t(x))
    jsym, jconf = jdemod.demodulate_symbols(jcfg, jnp.asarray(x))
    assert sym.dtype == torch.int32 and sym.shape == (3, 20)
    np.testing.assert_array_equal(sym.numpy(), np.asarray(jsym))
    np.testing.assert_allclose(conf.numpy(), np.asarray(jconf), rtol=1e-5)


def test_crc32_bytes_be_and_waveform_snr_db_match_jax():
    from anet.dsp import family as jfamily
    from anet_torch.dsp import family as tfamily

    for crc in (0, 1, 0xDEADBEEF, 0xFFFFFFFF, zlib.crc32(b"anet")):
        assert tfec.crc32_bytes_be(crc) == jfec.crc32_bytes_be(crc)
    for name in ("mfsk16-fast", "fsk2-robust", "mfsk4-coded", "ofdm-fast", "ofdm-max"):
        cfg, jcfg = get_model(name).config, jget_model(name).config
        for snr in (-3.0, 0.0, 12.5, 40.0):
            np.testing.assert_allclose(tfamily.waveform_snr_db(cfg, snr), jfamily.waveform_snr_db(jcfg, snr),
                                       rtol=1e-12)
        vec = tfamily.waveform_snr_db(cfg, torch.tensor([1.0, 20.0]))
        want = np.asarray(jfamily.waveform_snr_db(jcfg, jnp.asarray([1.0, 20.0])))
        np.testing.assert_allclose(vec.numpy(), want, rtol=1e-6)


def test_dsp_exports_match_jax():
    import anet.dsp
    import anet_torch.dsp

    assert anet_torch.dsp.__all__ == anet.dsp.__all__
    for name in anet_torch.dsp.__all__:
        assert getattr(anet_torch.dsp, name) is not None, name


def test_demodulate_frame_use_pallas_routes(monkeypatch):
    """use_pallas=False never reaches a kernel wrapper; None and True take
    tone_energies_fused (batch-major) and decide_frame_tm (time-major)."""
    from anet_torch import kernels as tk

    calls = dict.fromkeys(("tone_energies_fused", "decide_frame_tm", "decide_tones_tm"), 0)
    for name in calls:
        fn = getattr(tk, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(tk, name, counted)
    cfg, _, p, w = _noisy_frames("mfsk16-fast", 2, 8, 0.1, 17)
    for flag, n in ((False, 0), (None, 1), (True, 1)):
        calls.update(dict.fromkeys(calls, 0))
        a = tframe.demodulate_frame(cfg, w, 8, use_pallas=flag, device=CPU)
        b = tframe.demodulate_frame_tm(cfg, np.ascontiguousarray(w.T), 8, use_pallas=flag, device=CPU)
        assert calls == {"tone_energies_fused": n, "decide_frame_tm": n, "decide_tones_tm": 0}, flag
        np.testing.assert_array_equal(a.payload.numpy(), p)
        np.testing.assert_array_equal(b.payload.numpy(), p)
