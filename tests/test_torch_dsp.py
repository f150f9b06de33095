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
