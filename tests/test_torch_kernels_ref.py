"""The plain versions of anet_torch's four kernels against the JAX Pallas
kernels they replace, run in interpret mode on the CPU in float32. The CUDA
kernels against these plain versions: test_torch_kernels_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import anet.kernels as jk
from anet import stream as jstream
from anet.dsp import family as jfamily
from anet.dsp.frame import data_symbols_for_payload as j_data_symbols
from anet.dsp.sync import preamble_waveform as j_preamble
from anet.models import get_model as jget_model

from anet_torch import kernels as tk
from anet_torch import stream as tstream
from anet_torch.dsp.frame import data_symbols_for_payload
from anet_torch.dsp.pipeline import transmit
from anet_torch.models import get_model

NAME = "mfsk16-fast"
CFG, JCFG = get_model(NAME).config, jget_model(NAME).config
PAY = 64
CHUNK = 4096


def _frames(rng, b, pay=PAY, noise=0.3):
    """[T, B] f32 time-major frames at operating noise."""
    payload = rng.integers(0, 256, (b, pay), dtype=np.uint8)
    w = transmit(CFG, payload, device="cpu").numpy()
    w = w + noise * rng.standard_normal(w.shape).astype(np.float32)
    return np.ascontiguousarray(w.T)


def _buffer(rng, starts, length, noise=0.02):
    """[B, length] f32 stream buffers with a frame planted at each start."""
    pay = rng.integers(0, 256, (len(starts), PAY), dtype=np.uint8)
    w = transmit(CFG, pay, device="cpu").numpy()
    buf = noise * rng.standard_normal((len(starts), length)).astype(np.float32)
    for i, s in enumerate(starts):
        n = min(w.shape[1], length - s)  # frames may run past a short buffer
        buf[i, s : s + n] += w[i, :n]
    return buf


@pytest.mark.parametrize("pay", [64, 65])  # 65: s_pad > 0 (154 symbols, 20 words)
def test_decide_frame_tm_ref_matches_pallas(pay):
    rng = np.random.default_rng(pay)
    x = _frames(rng, 4, pay)
    pre = CFG.preamble_samples
    words, crc, qual, s = tk.decide_frame_tm_ref(CFG, torch.from_numpy(x), pay, preamble_offset=pre)
    jw, jc, jq, js = jk.decide_frame_tm(
        JCFG, jnp.asarray(x), pay, compute_dtype=jnp.float32, interpret=True, preamble_offset=pre
    )
    assert s == js
    assert (s % tk.TM_SYMBOL_TILE != 0) == (pay == 65)
    np.testing.assert_array_equal(words.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(crc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(qual.numpy(), np.asarray(jq), rtol=1e-5)


def test_frame_crc_tables_match():
    for pay, n_tiles, nb in [(64, 19, 32), (65, 20, 32), (8, 10, 16), (256, 67, 32)]:
        p_t, ch_t, cp_t = tk._frame_crc_tables(pay, n_tiles, nb)
        p_j, ch_j, cp_j = jk._frame_crc_tables(pay, n_tiles, nb)
        np.testing.assert_array_equal(p_t, p_j)
        assert (ch_t, cp_t) == (ch_j, cp_j)


def test_sync_search_ref_matches_pallas():
    rng = np.random.default_rng(5)
    k = CFG.preamble_samples
    seg = _buffer(rng, [3, 1500, 4000], CHUNK + k - 1)
    tpl = j_preamble(JCFG)
    te = float(jnp.sum(tpl * tpl))
    q, i = tk.sync_search_fused_ref(torch.from_numpy(seg), torch.from_numpy(np.array(tpl)), CHUNK, te)
    jq, ji = jk.sync_search_fused(jnp.asarray(seg), tpl, CHUNK, te, interpret=True)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(i.numpy(), [3, 1500, 4000])
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=1e-5)


def test_demod_at_ref_matches_pallas():
    rng = np.random.default_rng(6)
    n_sym = data_symbols_for_payload(CFG, PAY)
    length = tstream._buffer_len(CFG, CHUNK, PAY)
    starts = np.array([1, 700, 4095], np.int32)
    buf = _buffer(rng, starts, length, noise=0.3)
    t, b, tot = tk.demod_at_fused_ref(CFG, torch.from_numpy(buf), torch.from_numpy(starts), n_sym)
    jt, jb, jtot = jk.demod_at_fused(
        JCFG, jnp.asarray(buf), jnp.asarray(starts), n_sym, start_bound=CHUNK, interpret=True
    )
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-5)
    np.testing.assert_allclose(tot.numpy(), np.asarray(jtot), rtol=1e-5)


def test_demod_probe_ref_matches_pallas_at_row_residues():
    """Probe bases st0 at residues 122..127 and 0..2 mod 128: for lo0 > 123
    the reference kernel's servo window crosses its 128-lane rows (commit
    b0f8f7b); the plain version indexes directly and must agree."""
    rng = np.random.default_rng(7)
    n_sym = data_symbols_for_payload(CFG, PAY)
    starts = np.array([124, 125, 126, 127, 128, 129, 256, 257, 258, 320], np.int32)
    length = tstream._buffer_len(CFG, CHUNK, PAY)
    buf = _buffer(rng, starts, length)
    tpl = np.array(j_preamble(JCFG))
    st0 = starts - 2 + np.array([0, 1, -1, 0, 2, -2, 0, 1, 0, 0], np.int32)
    got = tk.demod_probe_fused_ref(CFG, torch.from_numpy(buf), torch.from_numpy(st0), n_sym, torch.from_numpy(tpl))
    want = jk.demod_probe_fused(
        JCFG, jnp.asarray(buf), jnp.asarray(st0), n_sym, jnp.asarray(tpl),
        start_bound=int(starts.max()), interpret=True,
    )
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[1].numpy(), starts - st0)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    for i in (0, 2, 4, 5):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), rtol=1e-5)


@pytest.mark.parametrize("name", ["mfsk16-fast", "mfsk4-voice", "fsk2-robust", "mfsk16-ultra"])
@pytest.mark.parametrize("chunk,pay", [(4096, 64), (36352, 256), (1024, 7)])
def test_buffer_geometry_matches_jax(name, chunk, pay):
    cfg, jcfg = get_model(name).config, jget_model(name).config
    assert tstream._buffer_len(cfg, chunk, pay) == jstream._buffer_len(jcfg, chunk, pay)
    n_sym = data_symbols_for_payload(cfg, pay)
    assert n_sym == j_data_symbols(jcfg, pay)
    live = jfamily.frame_samples(jcfg, pay) + chunk
    assert tk.demod_at_buffer_pad(cfg, n_sym, chunk, live) == jk.demod_at_buffer_pad(
        jcfg, n_sym, chunk, live
    )
