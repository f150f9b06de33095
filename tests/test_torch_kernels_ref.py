"""The plain versions of anet_torch's kernels against the JAX Pallas
kernels they replace, run in interpret mode on the CPU (float32; the coded
path's three and the variable-length slice's three also in bfloat16). The
CUDA kernels against these plain versions: test_torch_kernels_cuda.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import anet.kernels as jk
from anet import stream as jstream
from anet.dsp import family as jfamily
from anet.dsp import fec as jfec
from anet.dsp.frame import data_symbols_for_payload as j_data_symbols
from anet.dsp.sync import preamble_waveform as j_preamble
from anet.models import get_model as jget_model

from anet_torch import kernels as tk
from anet_torch import stream as tstream
from anet_torch.dsp import fec as tfec
from anet_torch.dsp.frame import data_symbols_for_payload
from anet_torch.dsp.params import ModemConfig
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


@pytest.mark.parametrize("bps", [1, 2, 4])
@pytest.mark.parametrize("pay", [1, 7, 64, 256])
def test_frame_crc_masks_count_the_bits(bps, pay):
    """The packed-word CRC masks of the tensor-core decide_frame_tm
    (kernels._frame_crc_mask_table): for random words, the sum over tiles
    of popc(word & mask[tile, c]) equals _frame_crc_rows' P.T @ bits and
    the counts of anet.kernels._frame_crc_tables in its bit-major tile
    order."""
    from anet_torch.dsp.frame import data_section_bytes

    rng = np.random.default_rng(16 * pay + bps)
    sb, nb = tk.TM_SYMBOL_TILE, tk.TM_SYMBOL_TILE * bps
    n_tiles = -(-(-(-8 * data_section_bytes(pay) // bps)) // sb)
    b = 5
    words = rng.integers(0, 2**nb, (n_tiles, b), dtype=np.uint64).astype(np.uint32)
    masks = tk._frame_crc_mask_table(pay, n_tiles, bps)
    assert masks.shape == (n_tiles, 64) and masks.dtype == np.uint32
    anded = (words[:, None, :] & masks[:, :, None]).astype("<u4")  # [tile, c, b]
    got = np.unpackbits(anded.view(np.uint8).reshape(n_tiles, 64, b, 4), axis=-1).sum((0, -1))

    pos = np.arange(nb)
    bits = ((words[:, None, :] >> (nb - 1 - pos)[None, :, None].astype(np.uint32)) & 1).reshape(n_tiles * nb, b)
    p = tk._frame_crc_rows(pay, n_tiles * nb)[0].astype(np.int64)
    np.testing.assert_array_equal(got, p.T @ bits.astype(np.int64))
    # anet's bit-major order: row k * sb + s of tile i is message bit (i sb + s) bps + k
    p_j = np.asarray(jk._frame_crc_tables(pay, n_tiles, nb)[0]).astype(np.int64)
    k, s = np.divmod(np.arange(nb), sb)
    bits_j = bits.reshape(n_tiles, nb, b)[:, s * bps + k].reshape(n_tiles * nb, b)
    np.testing.assert_array_equal(got, p_j.T @ bits_j.astype(np.int64))


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
    # data starts (start + 2,048) at every residue mod 16, the tensor-core
    # kernel's funnel-shift cases, besides the spread ones
    starts = np.array([1, 700, 4095] + [1000 + r for r in range(16)], np.int32)
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


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("n_lags", [1, 8])
def test_demod_probe_ref_matches_pallas_n_lags(n_lags, dtype):
    """The plain version against the Pallas kernel (interpret mode) at the
    servo window's smallest and largest widths, on the buffers the locked
    step hands it (bf16, or the int8 carry, with a bf16 template), probe
    bases at residues 0, 5 and 124..127 mod 128 and one probe window
    running past the buffer's end: offsets and tones exact; bf16: cmax,
    energy, best and total rtol 1e-5 (float32 sums in another order); int8:
    the energy exact, cmax rtol 1e-6 (one float32 rounding of an exact
    integer sum, times the same scale), best and total rtol 1e-5."""
    rng = np.random.default_rng(50 + n_lags)
    n_sym = data_symbols_for_payload(CFG, PAY)
    length = tstream._buffer_len(CFG, CHUNK, PAY)
    lag = n_lags // 2  # the planted frame's lag in the window
    st0 = np.array([128, 133, 252, 253, 254, 255, 3000, length - 1000], np.int32)
    buf = _buffer(rng, st0 + lag, length, noise=0.05)
    tpl = np.array(j_preamble(JCFG), np.float32)
    if dtype == "int8":
        tbuf = tstream.quantize_int8(torch.from_numpy(buf))
        jbuf = jnp.asarray(tbuf.numpy())
    else:
        tbuf = torch.from_numpy(buf).to(torch.bfloat16)
        jbuf = jnp.asarray(buf).astype(jnp.bfloat16)
    got = tk.demod_probe_fused_ref(
        CFG, tbuf, torch.from_numpy(st0), n_sym, torch.from_numpy(tpl).to(torch.bfloat16), n_lags=n_lags
    )
    want = jk.demod_probe_fused(
        JCFG, jbuf, jnp.asarray(st0), n_sym, jnp.asarray(tpl).astype(jnp.bfloat16), n_lags=n_lags,
        start_bound=int(st0.max()) + n_lags, interpret=True,
    )
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[1].numpy()[:-1], lag)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    if dtype == "int8":
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6)
    else:
        for i in (0, 2):
            np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), rtol=1e-5)
    for i in (4, 5):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), rtol=1e-5)


def test_probe_operands_hand_the_int8_scale_to_the_kernel():
    """The probe kernel's template operands: for an int8 buffer the taps
    and cmax scale cached per template tensor (the same tensors every
    chunk), the scale a float32 scalar whose address the kernel reads,
    equal to the factor the plain version scales cmax by; for bf16 and
    float32 buffers the template rounded to the buffer's dtype and no
    scale."""
    tpl = torch.from_numpy(np.array(j_preamble(JCFG), np.float32)).to(torch.bfloat16)
    taps, scale = tk._probe_operands(tpl, torch.int8, torch.device("cpu"))
    again = tk._probe_operands(tpl, torch.int8, torch.device("cpu"))
    assert again[0] is taps and again[1] is scale
    want_taps, want_scale = tk._probe_template(tpl, torch.int8)
    assert taps.dtype == torch.float32 and taps.is_contiguous() and torch.equal(taps, want_taps)
    assert scale.dtype == torch.float32 and scale.numel() == 1 and float(scale) == float(want_scale)
    for dtype in (torch.bfloat16, torch.float32):
        taps, scale = tk._probe_operands(tpl, dtype, torch.device("cpu"))
        assert scale is None and taps.dtype == torch.float32 and taps.is_contiguous()
        assert torch.equal(taps, tpl.to(dtype).float())


CODED, JCODED = get_model("mfsk4-coded").config, jget_model("mfsk4-coded").config
_DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.mark.parametrize("n,t_steps,noise", [(1, 23, 0.0), (5, 102, 0.4), (3, 207, 1.2), (130, 48, 0.7)])
def test_viterbi_trellis_ref_matches_pallas(n, t_steps, noise):
    """The plain trellis against the Pallas kernel pair in interpret mode:
    every decided bit (data and tail) equal, at trellis lengths that are no
    multiple of the reference's 24-step tile and batches that are no
    multiple of its 128 lanes."""
    rng = np.random.default_rng(t_steps)
    data = rng.integers(0, 2, (n, t_steps - tfec.CONV_TAIL_BITS), dtype=np.uint8)
    coded = np.asarray(jfec.conv_encode(jnp.asarray(data)))
    rx = (coded * 2.0 - 1.0 + rng.normal(0, noise, coded.shape)).astype(np.float32)
    rx = rx.reshape(n, t_steps, 2)
    signs = tfec._branch_signs()
    got = tk.viterbi_trellis_ref(torch.from_numpy(signs), torch.from_numpy(rx))
    assert got.dtype == torch.uint8 and got.shape == (n, t_steps)
    want = jk.viterbi_trellis(
        jnp.asarray(jfec._branch_signs()), jnp.moveaxis(jnp.asarray(rx), 0, -1), interpret=True
    )  # int32 [T, N]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).T)
    if noise < 1.0:
        np.testing.assert_array_equal(got.numpy()[:, : data.shape[1]], data)
        assert not got.numpy()[:, data.shape[1] :].any()  # the zero tail
    # the wrapper takes the plain version for a CPU tensor
    assert torch.equal(tk.viterbi_trellis(torch.from_numpy(signs), torch.from_numpy(rx)), got)


@pytest.mark.parametrize("t_steps", [1, 31, 32, 33])
def test_viterbi_trellis_ref_matches_pallas_around_a_word(t_steps):
    """Trellis lengths around the CUDA kernel's 32-step decision words (a
    lone step, one short of a word, a whole word, one past it) on random
    soft pairs, 37 streams: every bit equal to the Pallas pair's in
    interpret mode."""
    rng = np.random.default_rng(1000 + t_steps)
    rx = rng.normal(0, 1.0, (37, t_steps, 2)).astype(np.float32)
    signs = tfec._branch_signs()
    got = tk.viterbi_trellis_ref(torch.from_numpy(signs), torch.from_numpy(rx))
    want = jk.viterbi_trellis(jnp.asarray(signs), jnp.moveaxis(jnp.asarray(rx), 0, -1), interpret=True)
    assert got.shape == (37, t_steps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).T)


def test_viterbi_trellis_ref_all_ties():
    signs = torch.from_numpy(tfec._branch_signs())
    got = tk.viterbi_trellis_ref(signs, torch.zeros(2, 40, 2))
    assert not got.any()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("cfgs", ["mfsk4-coded", "mfsk16-fast"])
def test_demod_at_energies_ref_matches_pallas(cfgs, dtype):
    """Energies f32 [B, S, M] at starts on the 128-sample row residues
    124..127 and past them, and at data starts of every residue mod 16.
    Tolerance: 1e-5 of the largest energy (float32 sums in another order;
    bf16 products are exact in float32)."""
    cfg, jcfg = get_model(cfgs).config, jget_model(cfgs).config
    tdt, jdt = _DTYPES[dtype]
    rng = np.random.default_rng(len(cfgs))
    pay = 24
    n_sym = data_symbols_for_payload(cfg, pay)
    length = tstream._buffer_len(cfg, CHUNK, pay)
    starts = np.array([0, 124, 125, 126, 127, 128, 1000, 4095] + [2000 + r for r in range(16)], np.int32)
    payload = rng.integers(0, 256, (len(starts), pay), dtype=np.uint8)
    w = transmit(cfg, payload, device="cpu").numpy()
    buf = 0.3 * rng.standard_normal((len(starts), length)).astype(np.float32)
    for i, s in enumerate(starts):
        buf[i, s : s + w.shape[1]] += w[i]
    got = tk.demod_at_energies_fused_ref(
        cfg, torch.from_numpy(buf).to(tdt), torch.from_numpy(starts), n_sym
    )
    want = jk.demod_at_energies_fused(
        jcfg, jnp.asarray(buf).astype(jdt), jnp.asarray(starts), n_sym,
        start_bound=CHUNK, interpret=True,
    )
    assert got.dtype == torch.float32 and got.shape == (len(starts), n_sym, cfg.num_tones)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * float(want.max()))
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))
    # the wrapper takes the plain version for a CPU tensor
    again = tk.demod_at_energies_fused(cfg, torch.from_numpy(buf).to(tdt), torch.from_numpy(starts), n_sym)
    assert torch.equal(again, got)


def test_demod_at_energies_ref_reads_zeros_past_the_end():
    n_sym = data_symbols_for_payload(CODED, 8)
    buf = torch.ones(1, 4096)
    start = torch.tensor([4096 - CODED.preamble_samples - 3 * CODED.samples_per_symbol])
    e = tk.demod_at_energies_fused_ref(CODED, buf, start, n_sym)
    assert bool((e[0, :3].sum(-1) > 0).all()) and not bool(e[0, 3:].any())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("cfgs", ["mfsk4-coded", "mfsk16-fast"])
def test_probe_at_ref_matches_pallas(cfgs, dtype):
    """Quality f32 [B, 5] with probe bases at the row residues 122..127 and
    0..2, on planted preambles and on noise. Tolerance: rtol 1e-4 (float32
    sums in another order, one rsqrt)."""
    cfg, jcfg = get_model(cfgs).config, jget_model(cfgs).config
    tdt, jdt = _DTYPES[dtype]
    rng = np.random.default_rng(len(cfgs) + 1)
    tpl = np.array(j_preamble(jcfg))
    k = tpl.shape[-1]
    length = 4 * k + 512
    pos = np.array([124, 125, 126, 127, 128, 129, 130, 256 + 2, 2048 + 37, 700], np.int32)
    sig = 0.02 * rng.standard_normal((len(pos) + 2, length)).astype(np.float32)
    for i, p in enumerate(pos):
        sig[i, p : p + k] += tpl
    sig[-2:] = rng.standard_normal((2, length)).astype(np.float32)  # noise only
    st0 = np.concatenate([pos - 2 + np.array([0, 1, -1, 0, 2, -2, 0, 1, 0, 0]), [500, 900]]).astype(np.int32)
    t_t = torch.from_numpy(tpl).to(tdt)
    te = float((t_t.float() ** 2).sum())
    got = tk.probe_at_fused_ref(torch.from_numpy(sig).to(tdt), torch.from_numpy(st0), t_t, te)
    want = jk.probe_at_fused(
        jnp.asarray(sig).astype(jdt), jnp.asarray(st0), jnp.asarray(tpl).astype(jdt), te, interpret=True
    )
    assert got.dtype == torch.float32 and got.shape == (len(st0), 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-7)
    np.testing.assert_array_equal(got.numpy()[: len(pos)].argmax(-1), pos - st0[: len(pos)])
    assert float(got[: len(pos)].amax(-1).min()) > 0.95 and float(got[-2:].max()) < 0.2
    again = tk.probe_at_fused(torch.from_numpy(sig).to(tdt), torch.from_numpy(st0), t_t, te)
    assert torch.equal(again, got)


def test_probe_at_ref_energy_span_is_st0_aligned():
    """The window energy covers [st0, st0 + 128 * pw_e), not the row-aligned
    span of sync.preamble_quality_probe: a spike just before st0 changes the
    jnp-form probe's quality and leaves this one's alone."""
    from anet_torch.dsp.sync import preamble_quality_probe

    tpl = torch.from_numpy(np.array(j_preamble(JCFG)))
    k = tpl.shape[-1]
    te = float((tpl**2).sum())
    buf = torch.zeros(2, 4 * k)
    buf[:, 300 : 300 + k] = tpl
    buf[1, 290] = 50.0  # in the row-aligned span [256, ...), before st0 = 298
    st0 = torch.tensor([298, 298])
    q = tk.probe_at_fused_ref(buf, st0, tpl, te)
    assert torch.equal(q[0], q[1]) and float(q[0, 2]) > 0.99
    q_rows, _ = preamble_quality_probe(buf, st0 + 2, tpl, te)
    assert float(q_rows[1, 2]) < 0.9 * float(q_rows[0, 2])


@pytest.mark.parametrize("name", ["mfsk16-fast", "mfsk4-voice", "fsk2-robust", "mfsk16-ultra", "mfsk4-coded"])
@pytest.mark.parametrize("chunk,pay", [(4096, 64), (36352, 256), (1024, 7), (70144, 256)])
def test_buffer_geometry_matches_jax(name, chunk, pay):
    cfg, jcfg = get_model(name).config, jget_model(name).config
    assert tstream._buffer_len(cfg, chunk, pay) == jstream._buffer_len(jcfg, chunk, pay)
    n_sym = data_symbols_for_payload(cfg, pay)
    assert n_sym == j_data_symbols(jcfg, pay)
    live = jfamily.frame_samples(jcfg, pay) + chunk
    assert tk.demod_at_buffer_pad(cfg, n_sym, chunk, live) == jk.demod_at_buffer_pad(
        jcfg, n_sym, chunk, live
    )


# --- the variable-length slice: correlate, time-major decisions, row gather ---


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("b,n,k,out_len", [
    (3, 5000, 2048, 2048), (2, 2600, 513, 2048), (1, 4096, 100, 3500), (2, 5100, 2047, 3001),
])
def test_correlate_fused_ref_matches_pallas(b, n, k, out_len, dtype):
    """Every lag float32 [B, out_len] against the Pallas correlator in
    interpret mode, at the reference's own three shapes (lag-tile and stream
    padding; the second reads past the end of seg, as zeros) and at the
    CUDA kernel's ragged edges (k 2,047, no multiple of 16; out_len 3,001,
    no multiple of its 128-lag rows). Tolerance:
    1e-5 of the output's scale sqrt(k) (float32 sums of k products in
    another order; bf16 products are exact in float32)."""
    tdt, jdt = _DTYPES[dtype]
    rng = np.random.default_rng(n)
    seg = rng.normal(size=(b, n)).astype(np.float32)
    tpl = rng.normal(size=(k,)).astype(np.float32)
    seg_t, tpl_t = torch.from_numpy(seg).to(tdt), torch.from_numpy(tpl).to(tdt)
    got = tk.correlate_fused_ref(seg_t, tpl_t, out_len)
    want = jk.correlate_fused(jnp.asarray(seg).astype(jdt), jnp.asarray(tpl).astype(jdt), out_len, interpret=True)
    assert got.dtype == torch.float32 and got.shape == (b, out_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5 * np.sqrt(k) * 4)
    direct = np.stack([np.correlate(r, tpl_t.float().numpy().astype(np.float64), "valid") for r in
                       np.pad(seg_t.float().numpy().astype(np.float64), ((0, 0), (0, max(0, out_len + k - 1 - n))))])
    np.testing.assert_allclose(got.numpy(), direct[:, :out_len], rtol=1e-4, atol=1e-3)
    # the wrapper takes the plain version for a CPU tensor
    assert torch.equal(tk.correlate_fused(seg_t, tpl_t, out_len), got)


@pytest.mark.parametrize("name,s,b,extra,dtype", [
    ("mfsk16-fast", 21, 3, 17, "f32"), ("mfsk16-fast", 21, 3, 17, "bf16"),
    ("mfsk4-coded", 33, 5, 0, "f32"), ("mfsk4-coded", 33, 5, 0, "bf16"),
    ("mfsk16-fast", 8, 130, 63, "f32"),
])
def test_decide_tones_tm_ref_matches_pallas(name, s, b, extra, dtype):
    """(tone, best, total) [S, B] at symbol counts that are no multiple of the
    reference's 8-symbol tile, batches that are no multiple of its 128
    lanes, and a trailing partial symbol (dropped). Tones equal; energies
    rtol 1e-5 (float32 sums in another order). The two-lane-tile batch runs
    in float32 only: XLA's CPU runtime has no bf16 x bf16 -> f32 product at
    that tile."""
    cfg, jcfg = get_model(name).config, jget_model(name).config
    tdt, jdt = _DTYPES[dtype]
    rng = np.random.default_rng(s * b)
    sps = cfg.samples_per_symbol
    tones = rng.integers(0, cfg.num_tones, (b, s))
    from anet_torch.dsp.mod import synthesize_tones

    x = synthesize_tones(cfg, torch.from_numpy(tones).int()).numpy()
    x = np.pad(x + 0.5 * rng.standard_normal(x.shape).astype(np.float32), ((0, 0), (0, extra)))
    x_tm = np.ascontiguousarray(x.T)
    got = tk.decide_tones_tm_ref(cfg, torch.from_numpy(x_tm).to(tdt))
    want = jk.decide_tones_tm(jcfg, jnp.asarray(x_tm).astype(jdt), compute_dtype=jdt, interpret=True)
    assert got[0].dtype == torch.int32 and got[0].shape == (s, b) and x_tm.shape[0] == s * sps + extra
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[0].numpy(), tones.T)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)
    again = tk.decide_tones_tm(cfg, torch.from_numpy(x_tm).to(tdt))
    assert all(torch.equal(a, g) for a, g in zip(again, got))


def test_decide_tones_tm_ref_ties_go_to_the_first_tone():
    tone, best, total = tk.decide_tones_tm_ref(CFG, torch.zeros(3 * CFG.samples_per_symbol, 2))
    assert not tone.any() and not best.any() and not total.any()


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_gather_rows_ref_matches_pallas(dtype):
    """out[b, i] = buffer[b, start[b] + i] against the Pallas roll-align
    kernel in interpret mode, bit-equal, at starts on both sides of its
    128-sample rows (residues 0, 1, 63, 126, 127), the last fitting start
    included, a size that is whole rows and one that is not. int8: a
    quantized buffer (tstream.quantize_int8), moved as it is."""
    tdt, jdt = {**_DTYPES, "int8": (torch.int8, jnp.int8)}[dtype]
    rng = np.random.default_rng(1415)
    length = 3000
    buf = rng.standard_normal((20, length)).astype(np.float32)
    if dtype == "int8":
        buf = tstream.quantize_int8(torch.from_numpy(buf)).numpy()  # clips at +-127
        assert np.abs(buf).max() == 127 and np.unique(buf).size > 100
    buf_t = torch.from_numpy(buf).to(tdt)
    for size in (1000, 1024):
        starts = np.array([0, 1, 63, 126, 127, 128, 129, 255, 256, 257, 383, 384, 511, 640 + 127, 1000,
                           1151, 1152, 1279, 1500, length - size], np.int32)
        got = tk.gather_rows_fused_ref(buf_t, torch.from_numpy(starts), size)
        want = jk.gather_rows_fused(jnp.asarray(buf).astype(jdt), jnp.asarray(starts), size, interpret=True)
        assert got.dtype == tdt and got.shape == (20, size)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
        rows = np.stack([buf_t.float().numpy()[i, s : s + size] for i, s in enumerate(starts)])
        np.testing.assert_array_equal(got.float().numpy(), rows)
        assert torch.equal(tk.gather_rows_fused(buf_t, torch.from_numpy(starts), size), got)


@pytest.mark.parametrize("dtype", [
    torch.int8, torch.uint8, torch.bool, torch.float16, torch.bfloat16, torch.int16, torch.float32, torch.int32,
    torch.float64, torch.int64, torch.complex64,
], ids=str)
def test_gather_rows_launch_takes_every_element_width(monkeypatch, dtype):
    """gather_rows_fused's launch code, the card's calls replaced by
    recorders: any dtype of 1, 2 or 4 bytes reaches the kernel with its
    element size (the kernel only moves bits), the batch flattened and the
    output made in the buffer's dtype, one launch counted (an int8 one
    under "gather_rows_fused:int8"); an 8-byte dtype raises TypeError and
    launches nothing."""
    calls = []
    monkeypatch.setattr(tk, "_entry", lambda key: lambda *args: calls.append((key, args)) or 0)
    monkeypatch.setattr(tk, "_stream_handle", lambda dev: 0)
    monkeypatch.setattr(tk, "_check_on_card", lambda name, t, what: None)
    buf = torch.zeros(2, 3, 50, dtype=dtype)
    st = torch.tensor([[0, 5, -2], [10, 45, 3]])
    before = dict(tk.launch_counts)
    if dtype.itemsize not in (1, 2, 4):
        with pytest.raises(TypeError, match="1-, 2- or 4-byte"):
            tk._gather_rows_launch(buf, st, 20)
        assert not calls and tk.launch_counts == before
        return
    out = tk._gather_rows_launch(buf, st, 20)
    ((key, args),) = calls
    assert key == "gather_rows" and args[:4] == (buf.data_ptr(), dtype.itemsize, 6, 50)
    assert args[5:] == (20, out.data_ptr(), 0) and out.shape == (2, 3, 20) and out.dtype == dtype
    key = "gather_rows_fused:int8" if dtype == torch.int8 else "gather_rows_fused"
    assert {n: tk.launch_counts[n] - before[n] for n in before if tk.launch_counts[n] != before[n]} == {key: 1}


def test_gather_rows_ref_reads_zeros_outside_the_buffer():
    """Beyond the callers' contract (0 <= start, start + size <= L) the
    kernel and its plain version read zeros, on either side."""
    buf = torch.arange(1, 11, dtype=torch.float32).repeat(2, 1)
    got = tk.gather_rows_fused_ref(buf, torch.tensor([8, -2]), 4)
    assert got.tolist() == [[9.0, 10.0, 0.0, 0.0], [0.0, 0.0, 1.0, 2.0]]


@pytest.mark.parametrize("n_data,real", [(8 * 60, 8 * 20), (200, 200)])
def test_viterbi_trellis_ref_masked_tail_matches_pallas(n_data, real):
    """The masked trellis of the variable-length coded parse: LLRs past the
    real frame's tail flush are zero, so hundreds of steps tie every branch
    metric. Every decided bit equals the Pallas kernel's in interpret mode,
    the real span decodes to the sent data and the padded span to zeros:
    the tie rule and the (pm + a) + b order are the reference kernel's."""
    rng = np.random.default_rng(n_data + real)
    t_steps = n_data + tfec.CONV_TAIL_BITS
    data = rng.integers(0, 2, (6, real), dtype=np.uint8)
    coded = np.asarray(jfec.conv_encode(jnp.asarray(data)))  # tail-flushed at `real`
    rx = np.zeros((6, 2 * t_steps), np.float32)
    rx[:, : coded.shape[1]] = coded * 2.0 - 1.0 + rng.normal(0, 0.7, coded.shape)
    rx = rx.reshape(6, t_steps, 2)
    signs = tfec._branch_signs()
    got = tk.viterbi_trellis_ref(torch.from_numpy(signs), torch.from_numpy(rx))
    want = jk.viterbi_trellis(jnp.asarray(signs), jnp.moveaxis(jnp.asarray(rx), 0, -1), interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).T)
    np.testing.assert_array_equal(got.numpy()[:, :real], data)
    # past the tail flush the frozen metrics trace back through state 0
    assert not got.numpy()[:, real + 2 * tfec.CONV_TAIL_BITS :].any()


def test_viterbi_trellis_ref_header_probe_matches_pallas():
    """The 102-step unflushed header probe (conv_encoded_bits(96) = 204 LLRs
    cut from a longer coded section): every bit equals the Pallas kernel's,
    and the header's 64 bits decode although the trellis does not end in
    state 0."""
    from anet_torch.dsp.frame import HEADER_PROBE_DATA_BITS

    rng = np.random.default_rng(96)
    data = rng.integers(0, 2, (9, 400), dtype=np.uint8)
    coded = np.asarray(jfec.conv_encode(jnp.asarray(data)))
    n_llrs = tfec.conv_encoded_bits(HEADER_PROBE_DATA_BITS)
    assert n_llrs == 204
    rx = (coded[:, :n_llrs] * 2.0 - 1.0 + rng.normal(0, 0.5, (9, n_llrs))).astype(np.float32)
    got = tfec.viterbi_decode_soft(torch.from_numpy(rx), HEADER_PROBE_DATA_BITS)
    pairs = jnp.moveaxis(jnp.asarray(rx.reshape(9, 102, 2)), 0, -1)
    want = jk.viterbi_trellis(jnp.asarray(tfec._branch_signs()), pairs, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).T[:, :HEADER_PROBE_DATA_BITS])
    np.testing.assert_array_equal(got.numpy()[:, :64], data[:, :64])


@pytest.mark.parametrize("name,dtype", [
    ("mfsk16-fast", "f32"), ("mfsk16-fast", "bf16"), ("mfsk4-coded", "f32"), ("mfsk4-coded", "bf16"),
])
def test_batch_major_filterbank_refs_match_pallas(name, dtype):
    """tone_energies_fused_ref and decide_tones_fused_ref against the
    batch-major Pallas kernels on [2, 3, S * sps + extra] samples (leading
    batch axes, a trailing partial symbol dropped): tones and every
    energy's argmax equal, energies rtol 1e-5 (float32 sums in another
    order); the wrappers take the plain versions for CPU tensors."""
    cfg, jcfg = get_model(name).config, jget_model(name).config
    tdt, jdt = _DTYPES[dtype]
    rng = np.random.default_rng(len(name) + len(dtype))
    s, sps = 21, cfg.samples_per_symbol
    tones = rng.integers(0, cfg.num_tones, (6, s))
    from anet_torch.dsp.mod import synthesize_tones

    x = synthesize_tones(cfg, torch.from_numpy(tones).int()).numpy()
    x = x + 0.5 * rng.standard_normal(x.shape).astype(np.float32)
    x = np.pad(x, ((0, 0), (0, sps // 2))).reshape(2, 3, s * sps + sps // 2)
    xt = torch.from_numpy(x)
    e = tk.tone_energies_fused_ref(cfg, xt, compute_dtype=tdt)
    x_j = jnp.asarray(x[..., : s * sps])  # the reference needs whole symbols
    je = np.asarray(jk.tone_energies_fused(jcfg, x_j, compute_dtype=jdt, interpret=True))
    assert e.shape == (2, 3, s, cfg.num_tones) and je.shape == e.shape
    np.testing.assert_array_equal(e.argmax(-1).numpy().reshape(6, s), tones)
    np.testing.assert_array_equal(e.argmax(-1).numpy(), je.argmax(-1))
    np.testing.assert_allclose(e.numpy(), je, rtol=1e-5, atol=1e-5 * float(je.max()))
    got = tk.decide_tones_fused_ref(cfg, xt, compute_dtype=tdt)
    want = jk.decide_tones_fused(jcfg, x_j, compute_dtype=jdt, interpret=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)
    assert torch.equal(tk.tone_energies_fused(cfg, xt, compute_dtype=tdt), e)
    assert all(torch.equal(a, g) for a, g in zip(tk.decide_tones_fused(cfg, xt, compute_dtype=tdt), got))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_sync_search_blockmax_ref_matches_pallas(dtype):
    """Block maxima of the search quality against the Pallas kernel
    (rtol 1e-5); their maximum is sync_search_fused's best quality and
    their first argmax holds its lag."""
    tdt, jdt = _DTYPES[dtype]
    rng = np.random.default_rng(55)
    k = CFG.preamble_samples
    seg = _buffer(rng, [3, 1500, 4000, 130], CHUNK + k - 1)
    tpl = np.array(j_preamble(JCFG), np.float32)
    te = float(np.sum(tpl.astype(np.float64) ** 2))
    seg_t, tpl_t = torch.from_numpy(seg).to(tdt), torch.from_numpy(tpl).to(tdt)
    got = tk.sync_search_blockmax_ref(seg_t, tpl_t, CHUNK, te)
    want = jk.sync_search_blockmax(
        jnp.asarray(seg).astype(jdt), jnp.asarray(tpl).astype(jdt), CHUNK, te, interpret=True
    )
    assert got.shape == (4, CHUNK // 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    bq, bi = tk.sync_search_fused_ref(seg_t, tpl_t, CHUNK, te)
    np.testing.assert_array_equal(got.amax(-1).numpy(), bq.numpy())
    np.testing.assert_array_equal(got.argmax(-1).numpy(), bi.numpy() // 128)
    np.testing.assert_array_equal(bi.numpy(), [3, 1500, 4000, 130])
    assert torch.equal(tk.sync_search_blockmax(seg_t, tpl_t, CHUNK, te), got)
    with pytest.raises(ValueError, match="multiple of 128"):
        tk.sync_search_blockmax(seg_t, tpl_t, CHUNK - 1, te)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_search_template_energy_as_tensor_or_float(dtype):
    """Both searches take the template energy as a float or as a float32
    scalar tensor (how the stream passes it), with bit-equal results; the
    launch operand of a tensor is a float32 scalar tensor passed by address
    and no value (the card reads it there: no host read), of a float the
    value and a null pointer."""
    tdt, _ = _DTYPES[dtype]
    rng = np.random.default_rng(56)
    k = CFG.preamble_samples
    seg = torch.from_numpy(_buffer(rng, [3, 1500, 4000, 130], CHUNK + k - 1)).to(tdt)
    tpl = torch.from_numpy(np.array(j_preamble(JCFG), np.float32)).to(tdt)
    te_t = (tpl.float() ** 2).sum()
    te_f = float(te_t)
    q, i = tk.sync_search_fused(seg, tpl, CHUNK, te_f)
    q_t, i_t = tk.sync_search_fused(seg, tpl, CHUNK, te_t)
    assert torch.equal(q, q_t) and torch.equal(i, i_t)
    bm = tk.sync_search_blockmax(seg, tpl, CHUNK, te_f)
    assert torch.equal(bm, tk.sync_search_blockmax(seg, tpl, CHUNK, te_t))
    assert torch.equal(bm.amax(-1), q)

    te, val = tk._energy_operand("search", te_t, te_t.device)
    assert te is te_t and val == 0.0 and tk._address(te) == te_t.data_ptr()
    assert tk._energy_operand("search", te_f, te_t.device) == (None, te_f) and tk._address(None) is None
    te, val = tk._energy_operand("search", te_t.double(), te_t.device)
    assert te.dtype == torch.float32 and te.dim() == 0 and float(te) == te_f and val == 0.0
    with pytest.raises(ValueError, match="scalar"):
        tk._energy_operand("search", te_t.expand(2), te_t.device)


@pytest.mark.parametrize(
    "name,dtype",
    [("mfsk16-fast", "bf16"), ("mfsk16-fast", "f32"), ("mfsk4-coded", "f32"),
     ("mfsk32-dense", "f32"), ("mfsk8-audible", "bf16")],
)
def test_demodulate_frame_use_kernel_matches_anet(name, dtype, monkeypatch):
    """demodulate_frame (its filterbank tone_energies_fused) against anet's
    demodulate_frame(use_pallas=True), its kernel in interpret mode:
    payloads and verdicts equal, confidence rtol 1e-5; and the decisions
    kernel's composition frame_result_from_tone_decisions(decide_tones_fused)
    against anet's for the uncoded configs. mfsk32-dense (32 tones) and
    mfsk8-audible (48 samples a symbol) are the geometries of the kernels'
    plain per-symbol form on the card."""
    import functools

    from anet.dsp import frame as jframe

    from anet_torch.dsp import frame as tframe

    cfg, jcfg = get_model(name).config, jget_model(name).config
    tdt, jdt = _DTYPES[dtype]
    monkeypatch.setattr(jk, "tone_energies_fused", functools.partial(jk.tone_energies_fused, interpret=True))
    rng = np.random.default_rng(3 + len(name))
    pay = 32
    payload = rng.integers(0, 256, (4, pay), dtype=np.uint8)
    x = transmit(cfg, payload, device="cpu").numpy()
    x = x + 0.3 * rng.standard_normal(x.shape).astype(np.float32)
    got = tframe.demodulate_frame(cfg, torch.from_numpy(x), pay, compute_dtype=tdt, device="cpu")
    want = jframe.demodulate_frame(jcfg, jnp.asarray(x), pay, compute_dtype=jdt, use_pallas=True)
    np.testing.assert_array_equal(got.payload.numpy(), np.asarray(want.payload))
    np.testing.assert_array_equal(got.payload.numpy(), payload)
    for f in ("magic_ok", "length_ok", "header_crc_ok", "payload_crc_ok", "ok"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), f)
    np.testing.assert_allclose(got.confidence.numpy(), np.asarray(want.confidence), rtol=1e-5)
    if cfg.fec != "none":
        return
    data = x[:, cfg.preamble_samples :]
    t = tframe.frame_result_from_tone_decisions(
        cfg, *tk.decide_tones_fused(cfg, torch.from_numpy(data), compute_dtype=tdt), pay
    )
    j = jframe.frame_result_from_tone_decisions(
        jcfg, *jk.decide_tones_fused(jcfg, jnp.asarray(data), compute_dtype=jdt, interpret=True), pay
    )
    np.testing.assert_array_equal(t.payload.numpy(), np.asarray(j.payload))
    np.testing.assert_array_equal(t.ok.numpy(), np.asarray(j.ok))
    np.testing.assert_allclose(t.confidence.numpy(), np.asarray(j.confidence), rtol=1e-5)


_FILTERBANK_PRESETS = {  # name: (the compile-time walk's geometry, the runtime walk's basis words)
    "mfsk16-fast": (True, None),
    "mfsk4-coded": (True, None),
    "mfsk32-dense": (True, None),
    "mfsk8-audible": (True, None),
    "sps40-m4": (False, 3 * 1 * 64),  # a custom config off every compile-time walk: 3 k-steps, 1 n-tile
}


def _filterbank_config(name):
    """The preset ``name``, or the custom sps-40 config of 4 tones."""
    if name == "sps40-m4":
        return ModemConfig(sample_rate_hz=48_000, symbol_rate_hz=1200, num_tones=4, base_freq_hz=600.0)
    return get_model(name).config


@pytest.mark.parametrize("compute", ["float32", "bf16"])
@pytest.mark.parametrize("name", list(_FILTERBANK_PRESETS))
def test_filterbank_basis_layout(name, compute):
    """The filterbank kernels' basis. At sps 32/48/64/80/128 and at most
    32 tones, tensor-core B fragments: bfloat16 compute, one term, which
    reads back as the interleaved basis with the plain bf16 basis's
    entries; float32 compute, the three bf16 terms of the float32 basis
    (_demod_split_basis), which read back as terms summing to the plain
    float32 basis's entries. Elsewhere (sps 40) filterbank_any.cu's
    _filterbank_any_basis: bfloat16 compute its one term, float32 compute
    b0 then b1 and b2, three times the words (its layout:
    tests/test_torch_filterbank_any.py::test_any_basis_layout)."""
    cfg = _filterbank_config(name)
    fast, shape = _FILTERBANK_PRESETS[name]
    dt = {"float32": torch.float32, "bf16": torch.bfloat16}[compute]
    m, cpu = cfg.num_tones, torch.device("cpu")
    plain = tk._plain_basis(cfg, dt, "cpu")
    entry, route, basis = tk._filterbank_operands("tone_energies", cfg, dt, cpu)
    assert route == (("any" if dt == torch.bfloat16 else "any_split") if not fast
                     else "mma" if dt == torch.bfloat16 else "split")
    if route == "mma":
        assert entry == "tone_energies_mma" and basis is tk._demod_mma_basis(cfg, dt, cpu)
        b = _unpack_demod_mma_basis(basis, dt)
    elif route == "split":
        assert entry == "tone_energies_mma_f32" and basis is tk._demod_split_basis(cfg, cpu)
        b = sum(_unpack_demod_mma_basis(w, torch.bfloat16).double() for w in basis)
        plain = plain.double()
    if fast:
        assert torch.equal(b[:, 0 : 2 * m : 2], plain[:, :m]) and torch.equal(b[:, 1 : 2 * m : 2], plain[:, m:])
        return
    assert entry == ("tone_energies_any" if dt == torch.bfloat16 else "tone_energies_any_f32")
    assert basis is tk._filterbank_any_basis(cfg, dt, cpu)
    assert basis.dtype == torch.int32 and basis.is_contiguous()
    assert basis.shape == (shape * (1 if dt == torch.bfloat16 else 3),)


def _record_filterbank_calls(monkeypatch) -> list:
    """Replace the card's calls of the filterbank wrappers' launch code by
    recorders: each entry call appends (entry, its arguments), each launch
    check ("checked", the kernel's name, the dtype it counts by, the
    route). Nothing is launched or counted."""
    calls = []
    monkeypatch.setattr(tk, "_entry", lambda key: lambda *args: calls.append((key, args)) or 0)
    monkeypatch.setattr(tk, "_stream_handle", lambda dev: 0)
    monkeypatch.setattr(tk, "_check_cuda_input", lambda name, t, what: tk._KERNEL_DTYPES[t.dtype])
    monkeypatch.setattr(tk, "_check_launch",
                        lambda err, name, dtype, route: calls.append(("checked", name, dtype, route)))
    return calls


@pytest.mark.parametrize("rows", ["float32", "bf16"])
@pytest.mark.parametrize("compute", ["float32", "bf16"])
@pytest.mark.parametrize("name", list(_FILTERBANK_PRESETS))
def test_filterbank_route_follows_the_compute_dtype(monkeypatch, name, compute, rows):
    """Which C entry each filterbank call takes, with which operands, for
    the four MFSK presets and a custom sps-40 config x compute dtype x
    rows dtype, through the
    wrappers' launch code with the card's calls replaced by recorders (so
    nothing is launched): at the fast geometry bfloat16 compute takes the
    tensor-core entry ``*_mma`` (rows, R, row pitch, the cached int32 zero
    starts) with _demod_mma_basis, and float32 compute the tensor-core
    entry ``*_mma_f32`` (rows, dtype code, R, row pitch, the zero starts)
    with the three-term _demod_split_basis, bfloat16 and float32 rows read
    as they are; any other geometry filterbank_any.cu's entries (rows,
    dtype code, R, row pitch), ``*_any`` for bfloat16 compute and
    ``*_any_f32`` for float32, with _filterbank_any_basis. The launch is
    checked with the compute dtype, so float32 compute counts under
    ``:f32``, and its route, so the runtime-geometry routes count under
    their own key. Rows are a strided view past the preamble of [2, 3]
    frames."""
    from anet_torch.kernels import build

    cfg = _filterbank_config(name)
    fast, _ = _FILTERBANK_PRESETS[name]
    cdt, rdt = ({"float32": torch.float32, "bf16": torch.bfloat16}[v] for v in (compute, rows))
    sps, m, pre, cpu = cfg.samples_per_symbol, cfg.num_tones, cfg.preamble_samples, torch.device("cpu")
    s = 5
    frames = torch.randn(2, 3, pre + s * sps + 7).to(rdt)  # a partial symbol past the last whole one
    data = frames[..., pre:]
    calls = _record_filterbank_calls(monkeypatch)
    before = dict(tk.launch_counts)
    route = ("any" if cdt == torch.bfloat16 else "any_split") if not fast else "mma" if cdt == torch.bfloat16 else "split"
    for kind, n_out in (("tone_energies", 1), ("decide_tones", 3)):
        calls.clear()
        outs = tk._filterbank_launch(kind + "_fused", kind, cfg, data, cdt, lambda lead, n, dev: tuple(
            torch.empty(*lead, n, dtype=torch.float32) for _ in range(n_out)))
        (key, args), checked = calls
        assert checked == ("checked", kind + "_fused", cdt, route)
        assert all(o.shape == (2, 3, s) for o in outs)
        sig = build.SIGNATURES[key]
        n_head = {"mma": 4, "split": 5, "any": 4, "any_split": 4}[route]
        source = "tone_energies" if fast else "filterbank_any"
        assert (*sig[2:], key)[0] == source and len(sig[1]) == len(args) == n_head + 4 + n_out + 1
        basis_ptr, out_ptrs = args[n_head + 3], args[n_head + 4 : n_head + 4 + n_out]
        assert args[n_head : n_head + 3] == (s, sps, m) and out_ptrs == tuple(o.data_ptr() for o in outs)
        assert args[-1] == 0
        row_dtype = torch.bfloat16 if cdt == torch.bfloat16 else rdt
        r, pitch = args[1:3] if route == "mma" else args[2:4]
        assert r == 6
        if row_dtype == rdt:  # the view past the preamble, read in place
            assert args[0] == data.data_ptr() and pitch == frames.shape[-1]
        else:  # cast: a copy of the data sections
            assert pitch == data.shape[-1]
        if route != "mma":
            assert args[1] == tk._KERNEL_DTYPES[row_dtype]
        if fast:
            assert args[n_head - 1] == tk._zero_starts(6, cpu).data_ptr()
            assert not bool(tk._zero_starts(6, cpu).any()) and tk._zero_starts(6, cpu).dtype == torch.int32
        if route == "mma":
            assert key == kind + "_mma"
            assert basis_ptr == tk._demod_mma_basis(cfg, torch.bfloat16, cpu).data_ptr()
        elif route == "split":  # the float32 basis's three terms, never the bf16-rounded one alone
            assert key == kind + "_mma_f32"
            assert basis_ptr == tk._demod_split_basis(cfg, cpu).data_ptr()
        else:
            assert key == kind + ("_any" if route == "any" else "_any_f32")
            assert basis_ptr == tk._filterbank_any_basis(cfg, cdt, cpu).data_ptr()
    assert tk.launch_counts == before


def test_filterbank_mma_route_rows(monkeypatch):
    """The tensor-core route's rows: one zero-start vector per (R, device),
    made once; overlapping rows (a pitch shorter than a row's symbols)
    become contiguous, whose pitch is the row length."""
    cpu = torch.device("cpu")
    assert tk._zero_starts(7, cpu) is tk._zero_starts(7, cpu)
    sps = CFG.samples_per_symbol
    calls = _record_filterbank_calls(monkeypatch)
    over = torch.randn(4 * sps * 3).to(torch.bfloat16).as_strided((3, 4 * sps), (2 * sps, 1))  # rows overlap by half
    tk._filterbank_launch("decide_tones_fused", "decide_tones", CFG, over, torch.bfloat16,
                          lambda lead, n, dev: tuple(torch.empty(*lead, n) for _ in range(3)))
    (key, args), _ = calls
    assert key == "decide_tones_mma" and args[1:3] == (3, 4 * sps) and args[0] != over.data_ptr()


_DEMOD_MMA_CONFIGS = {  # every preset tone count (2, 4, 16) at sps 32/64/128, and 8 tones
    name: get_model(name).config
    for name in ("fsk2-robust", "mfsk4-coded", "mfsk4-voice", "mfsk16-fast", "mfsk16-ultra")
}
_DEMOD_MMA_CONFIGS["mfsk8-sps64"] = dataclasses.replace(CFG, num_tones=8)


def _unpack_demod_mma_basis(words: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The [sps, 8 n] matrix the B fragments of csrc/demod_core.cuh hold:
    register r of lane (g, i) at k-step s and n8 tile t holds rows
    k = (32 s + 16 r + 4 i) / elem + e, column 8 t + g, element e in the
    word's low bytes first."""
    ks, n = words.shape[:2]
    per = 4 // torch.empty((), dtype=dtype).element_size()  # elements a word
    e = words.reshape(ks, n, 2, 8, 4).contiguous().view(dtype).reshape(ks, n, 2, 8, 4, per).float()
    return e.permute(0, 2, 4, 5, 1, 3).reshape(ks * 8 * per, n * 8)  # [s, r, i, e] x [t, g]


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("name", list(_DEMOD_MMA_CONFIGS))
def test_demod_mma_basis_packing(name, dtype):
    """The align+demod kernels' tensor-core B operand, read back as the
    kernels' fragments read it, is the interleaved basis (column 2c the cos
    of tone c, 2c + 1 its sin, zero columns up to the n8 tiles of the tone
    count) with the same entries as _kernel_basis's, and as anet's
    demod_basis rounded to bf16, or round(basis * 127) for int8 samples."""
    from anet.dsp.demod import demod_basis as j_demod_basis
    from anet.dsp.params import ModemConfig as JModemConfig

    cfg = _DEMOD_MMA_CONFIGS[name]
    tdt = {"bf16": torch.bfloat16, "int8": torch.int8}[dtype]
    m, sps, cpu = cfg.num_tones, cfg.samples_per_symbol, torch.device("cpu")
    words = tk._demod_mma_basis(cfg, tdt, cpu)
    n = tk._demod_mma_tiles(m)
    assert words.dtype == torch.int32 and words.shape == (sps * tdt.itemsize // 32, n, 2, 32)
    assert n == {2: 1, 4: 1, 8: 2, 16: 4}[m]
    basis = _unpack_demod_mma_basis(words, tdt)
    assert basis.shape == (sps, 8 * n)
    kb = tk._kernel_basis(cfg, tdt, cpu)
    assert torch.equal(basis[:, 0 : 2 * m : 2], kb[:, :m]) and torch.equal(basis[:, 1 : 2 * m : 2], kb[:, 16 : 16 + m])
    assert not bool(basis[:, 2 * m :].any())
    jb = j_demod_basis(JModemConfig(**dataclasses.asdict(cfg)), dtype=jnp.float32)
    want = np.round(np.asarray(jb) * 127) if tdt == torch.int8 else np.asarray(jb.astype(jnp.bfloat16)).astype(np.float32)
    np.testing.assert_array_equal(torch.cat([basis[:, 0 : 2 * m : 2], basis[:, 1 : 2 * m : 2]], 1).numpy(), want)
    assert tk._demod_at_basis(cfg, tdt, cpu) is words


def test_demod_at_basis_float32_takes_the_cuda_core_columns():
    """float32 buffers: both align+demod sources, demod_at.cu
    (demod_at_fused, demod_probe_fused's demod) and demod_at_energies.cu
    (demod_at_energies_fused), take the three-term split of the float32
    basis (_demod_split_basis, the CUDA-core columns _kernel_basis of
    float32 as three bf16 terms), never the bf16-rounded fragments alone,
    and no CUDA-core [sps, 32] float32 operand is left on their route. No
    one-term float32 fragments exist."""
    cpu = torch.device("cpu")
    split = tk._demod_split_basis(CFG, cpu)
    assert tk._demod_at_basis(CFG, torch.float32, cpu) is split
    assert not hasattr(tk, "_demod_energies_basis")
    ks, n = CFG.samples_per_symbol // 16, tk._demod_mma_tiles(CFG.num_tones)
    assert split.dtype == torch.int32 and split.shape == (3, ks, n, 2, 32)
    terms = sum(_unpack_demod_mma_basis(split[i], torch.bfloat16).double() for i in range(3))
    m, cols = CFG.num_tones, tk._kernel_basis(CFG, torch.float32, cpu).double()
    np.testing.assert_array_equal(terms[:, 0 : 2 * m : 2].numpy(), cols[:, :m].numpy())
    np.testing.assert_array_equal(terms[:, 1 : 2 * m : 2].numpy(), cols[:, 16 : 16 + m].numpy())
    for dt in (torch.bfloat16, torch.int8):
        assert tk._demod_at_basis(CFG, dt, cpu) is tk._demod_mma_basis(CFG, dt, cpu)
    with pytest.raises(TypeError):
        tk._demod_mma_basis(CFG, torch.float32, cpu)


def test_sass_mix_parses_cuobjdump_output():
    """The SASS instruction mix counts opcodes per function, without their
    predicates and modifiers, and skips the encoding lines."""
    from anet_torch.kernels.sass_mix import parse_sass

    sass = """
	code for sm_90a
		Function : _Z6kernelIaEvPKT_
	.headerflags	@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                   /* 0x00000a00ff017b82 */
                                                                            /* 0x000fe40000000800 */
        /*0010*/              @!P0 LDG.E.S8 R2, desc[UR4][R2.64] ;         /* 0x0000000402028981 */
        /*0020*/              @UP0 I2FP.F32.S32 R3, R2 ;                   /* 0x0000000200037245 */
        /*0030*/                   I2FP.F32.S32 R4, R2 ;                   /* 0x0000000200047245 */
		Function : _Z6kernelIfEvPKT_
        /*0000*/                   EXIT ;                                  /* 0x000000000000794d */
"""
    got = [(name, dict(ops)) for name, ops in parse_sass(sass)]
    assert got == [
        ("_Z6kernelIaEvPKT_", {"LDC": 1, "LDG": 1, "I2FP": 2}),
        ("_Z6kernelIfEvPKT_", {"EXIT": 1}),
    ]


def test_sass_mix_counts_global_loads_and_stores_by_width():
    """Beside the opcode counts, each function's global loads and stores
    are counted by their whole opcode, so a 16-byte access (LDG.E.128)
    shows apart from a byte one (LDG.E.U8); other opcodes are not."""
    from anet_torch.kernels.sass_mix import global_ops, parse_sass

    sass = """
		Function : _Z6gatherIhEvPKhPh
        /*0000*/              @!P0 LDG.E.128.CONSTANT R4, desc[UR4][R2.64] ;
        /*0010*/                   LDG.E.U8 R8, desc[UR4][R6.64] ;
        /*0020*/                   STG.E.128 desc[UR4][R2.64], R4 ;
        /*0030*/              @P1 STG.E.128 desc[UR4][R2.64+0x200], R4 ;
        /*0040*/                   SHF.R.W.U32 R4, R4, R8, R5 ;
		Function : _Z4nonev
        /*0000*/                   EXIT ;
"""
    assert global_ops(sass) == [{"LDG.E.128.CONSTANT": 1, "LDG.E.U8": 1, "STG.E.128": 2}, {}]
    assert [dict(ops) for _, ops in parse_sass(sass)] == [{"LDG": 2, "STG": 2, "SHF": 1}, {"EXIT": 1}]


def test_sass_mix_reads_resource_usage():
    """Each function's registers a thread and stack bytes, from the lines
    ``cuobjdump --dump-resource-usage`` prints, keyed by the mangled name
    that ``-sass`` prints too."""
    from anet_torch.kernels.sass_mix import resource_usage

    text = """
Fatbin elf code:
================
arch = sm_90a
		Function _Z6kernelIaEvPKT_:
		REG:128 STACK:0 SHARED:0 LOCAL:0 CONSTANT[0]:600 TEXTURE:0 SURFACE:0 SAMPLER:0
		Function _Z4nonev:
		REG:40 STACK:80 SHARED:1024 LOCAL:0 CONSTANT[0]:560 TEXTURE:0 SURFACE:0 SAMPLER:0
"""
    assert resource_usage(text) == {"_Z6kernelIaEvPKT_": (128, 0), "_Z4nonev": (40, 80)}


def test_sass_mix_counts_loops_off_the_slow_path(monkeypatch):
    """``sass_mix --loops``: each innermost loop (a backward branch and its
    target) of at least LOOP_MIN instructions, with its static count and
    the count without the blocks a branch after sincosf's |x| >= 105615
    test skips (the slow argument reduction), which is what a trip
    issues; a smaller loop inside the slow block is no loop of its own."""
    from anet_torch.kernels import sass_mix

    monkeypatch.setattr(sass_mix, "LOOP_MIN", 4)
    sass = """
		Function : _Z6kernelv
        /*0000*/                   MOV R1, R2 ;
        /*0010*/                   FMUL R3, R1, R1 ;
        /*0020*/                   FSETP.GE.AND P2, PT, |R3|, 105615, PT ;
        /*0030*/              @!P2 BRA 0x70 ;
        /*0040*/                   IMAD R4, R4, R4, RZ ;
        /*0050*/                   IMAD R5, R5, R5, RZ ;
        /*0060*/              @P1 BRA 0x40 ;
        /*0070*/                   FADD R6, R6, R3 ;
        /*0080*/              @P0 BRA 0x10 ;
        /*0090*/                   EXIT ;
		Function : _Z4nonev
        /*0000*/                   EXIT ;
"""
    assert sass_mix.loops(sass) == [[[0x10, 0x80, 8, 5]], []]


def _band_from_words(words: torch.Tensor, k: int) -> torch.Tensor:
    """The [16 * steps, 128] band, one per half (hi, lo), that the search
    kernels' B fragments read from the template words: entry (p, n) of step
    p // 16 and n8 tile n // 8 is the half (p % 2) of the word that lane
    (g = n % 8, i = (p % 8) // 2) loads for H(16 s - 8 j + 8 (p % 16 // 8)),
    word 64 + i - g // 2 + e / 2 of copy g % 2 (csrc/search_core.cuh
    product())."""
    steps = -(-(k + 127) // 16)
    halves = words.view(torch.bfloat16).float()  # [P, 2, 2W], the word's low half first
    p = torch.arange(16 * steps)[:, None]
    n = torch.arange(128)[None, :]
    g, i, kk = n % 8, (p % 8) // 2, p % 16
    e = 16 * (p // 16) - 8 * (n // 8) + 8 * (kk // 8)
    word = 64 + i - g // 2 + e // 2
    assert int(word.min()) >= 0 and int(word.max()) + 8 < words.shape[-1]  # + the next step's reads
    return halves[:, g % 2, 2 * word + kk % 2]


@pytest.mark.parametrize("k", [512, 1024, 2047, 2048, 6144])
def test_search_template_words_expand_to_the_band(k):
    """The search kernels' template operand (built once a template by the
    wrapper) read as the kernels' B fragments read it: for a bfloat16
    template exactly anet.dsp.sync.banded_template's band of the same
    template, over the (k + 127) rows the product runs padded to 16; for a
    float32 one a hi band equal to the band of its bf16 rounding and a lo
    band with which it rebuilds the float32 band within 2**-16 relative."""
    from anet.dsp.sync import banded_template

    rng = np.random.default_rng(k)
    t = rng.standard_normal(k).astype(np.float32)
    rows = 16 * -(-(k + 127) // 16)
    t16 = torch.from_numpy(t).to(torch.bfloat16)
    band16 = np.asarray(banded_template(jnp.asarray(t16.float().numpy()), rows, 128))
    words = tk._search_template_words(t16)
    assert words.dtype == torch.int32 and words.shape[:2] == (1, 2) and words.shape[-1] % 32 == 16
    np.testing.assert_array_equal(_band_from_words(words, k)[0].numpy(), band16)

    words32 = tk._search_template_words(torch.from_numpy(t))
    assert words32.shape[:2] == (2, 2)
    hi, lo = _band_from_words(words32, k)
    np.testing.assert_array_equal(hi.numpy(), band16)
    band32 = np.asarray(banded_template(jnp.asarray(t), rows, 128))
    np.testing.assert_allclose((hi + lo).numpy(), band32, rtol=2.0**-16, atol=0)
    assert np.count_nonzero(band32) == 128 * k


# --- the launch code of probe_at_fused and ofdm_track_decide_fused ------------


def _record_launches(monkeypatch) -> list:
    """Replace the card's calls of a wrapper's launch code by recorders, as
    _record_filterbank_calls does, for the wrappers that check their inputs
    with _check_buffer_and_starts (int8 keyword) and _check_launch."""
    calls = []
    monkeypatch.setattr(tk, "_entry", lambda key: lambda *args: calls.append((key, args)) or 0)
    monkeypatch.setattr(tk, "_stream_handle", lambda dev: 0)
    monkeypatch.setattr(tk, "_check_cuda_input", lambda name, t, what, int8=False: tk._KERNEL_DTYPES[t.dtype])
    monkeypatch.setattr(tk, "_check_launch",
                        lambda err, name, dtype=None, route=None: calls.append(("checked", name)))
    return calls


_ROUTE_SUFFIX = {"f32": ":f32", "bf16": "", "int8": ":int8"}  # the launch count key of each dtype's route


def _record_counted_launches(monkeypatch) -> list:
    """_record_launches, with each checked launch also counted as the
    wrapper counts it (_count_launch) into zeroed launch_counts."""
    calls = _record_launches(monkeypatch)
    monkeypatch.setattr(tk, "launch_counts", dict.fromkeys(tk.launch_counts, 0))

    def checked(err, name, dtype=None, route=None):
        calls.append(("checked", name))
        tk._count_launch(name, dtype, route)

    monkeypatch.setattr(tk, "_check_launch", checked)
    return calls


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", ["mfsk16-fast", "mfsk4-coded", "fsk2-robust", "mfsk16-ultra"])
def test_decide_tones_tm_launch_routes_by_dtype(monkeypatch, name, dtype):
    """decide_tones_tm's launch code, the card's calls replaced by
    recorders: both dtypes go to the tensor-core entry of the
    decide_frame_tm library (data, dtype code, B, sps, tones, symbols),
    bfloat16 data with _demod_mma_basis's B fragments, float32 data with
    _demod_split_basis's three bf16 terms, which sum to _kernel_basis's
    float32 columns, never the bf16-rounded ones. A trailing partial symbol
    is dropped; one launch checked a call."""
    from anet_torch.kernels import build

    cfg = get_model(name).config
    tdt = _DTYPES[dtype][0]
    cpu = torch.device("cpu")
    sps = cfg.samples_per_symbol
    x = torch.randn(5 * sps + 3, 7).to(tdt)
    calls = _record_counted_launches(monkeypatch)
    tone, best, total = tk._decide_tones_tm_launch(cfg, x)
    (key, args), checked = calls
    assert checked == ("checked", "decide_tones_tm")
    assert {k: v for k, v in tk.launch_counts.items() if v} == {"decide_tones_tm" + _ROUTE_SUFFIX[dtype]: 1}
    assert tone.shape == best.shape == total.shape == (5, 7)
    assert tone.dtype == torch.int32 and best.dtype == total.dtype == torch.float32
    outs = (tone.data_ptr(), best.data_ptr(), total.data_ptr(), 0)
    assert key == "decide_tones_tm_mma" and build.SIGNATURES[key][2] == "decide_frame_tm"
    assert len(args) == len(build.SIGNATURES[key][1])
    basis = tk._demod_at_basis(cfg, tdt, cpu)
    assert args == (x.data_ptr(), tk._KERNEL_DTYPES[tdt], 7, sps, cfg.num_tones, 5, basis.data_ptr(), *outs)
    if tdt == torch.bfloat16:
        assert basis is tk._demod_mma_basis(cfg, torch.bfloat16, cpu)
    else:
        _assert_split_basis_of_float32_columns(cfg, basis)


def _assert_split_basis_of_float32_columns(cfg, basis: torch.Tensor) -> None:
    """``basis`` is _demod_split_basis (three bf16 terms, [3, ks, n, 2, 32])
    and its terms sum to _kernel_basis's float32 columns, which differ from
    the bf16-rounded ones."""
    from test_torch_filterbank_split import _unpack

    cpu = torch.device("cpu")
    m, sps = cfg.num_tones, cfg.samples_per_symbol
    assert basis is tk._demod_split_basis(cfg, cpu)
    assert basis.shape == (3, sps // 16, tk._demod_mma_tiles(m), 2, 32)
    iq = sum(_unpack(w).double() for w in basis)  # [sps, 8 n]: cos of tone c at 2c, sin at 2c + 1
    cols = tk._kernel_basis(cfg, torch.float32, cpu).double()
    assert torch.equal(iq[:, 0 : 2 * m : 2], cols[:, :m]) and torch.equal(iq[:, 1 : 2 * m : 2], cols[:, 16 : 16 + m])
    assert not torch.equal(cols, tk._kernel_basis(cfg, torch.bfloat16, cpu).double())


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("name", ["mfsk16-fast", "fsk2-robust", "mfsk16-ultra"])
def test_decide_frame_tm_launch_routes_by_dtype(monkeypatch, name, dtype):
    """decide_frame_tm's launch code, the card's calls replaced by
    recorders: every dtype goes to the one entry of its library (data,
    dtype code, B, preamble offset, sps, tones, symbols, tiles, bits a
    symbol), float32 frames with _demod_split_basis's three bf16 terms
    (summing to _kernel_basis's float32 columns), bfloat16 and int8 ones
    with _demod_mma_basis; the CRC counts come from the packed-word masks
    of _frame_crc_masks for every dtype. The launch is checked under the
    name, and so counted under "decide_frame_tm:f32" for float32 frames."""
    from anet_torch.kernels import build

    cfg = get_model(name).config
    tdt = {**_DTYPES, "int8": (torch.int8, jnp.int8)}[dtype][0]
    cpu = torch.device("cpu")
    pre, pay = 3, 7
    s = data_symbols_for_payload(cfg, pay)
    n_tiles = -(-s // tk.TM_SYMBOL_TILE)
    x = torch.randn(pre + s * cfg.samples_per_symbol, 5).to(tdt)
    calls = _record_counted_launches(monkeypatch)
    words, crc, qual, n_sym = tk._decide_frame_tm_launch(cfg, x, pay, pre)
    (key, args), checked = calls
    assert checked == ("checked", "decide_frame_tm") and key == "decide_frame_tm"
    assert {k: v for k, v in tk.launch_counts.items() if v} == {"decide_frame_tm" + _ROUTE_SUFFIX[dtype]: 1}
    assert n_sym == s and words.shape == (n_tiles, 5) and crc.shape == (64, 5) and qual.shape == (8, 5)
    assert not crc.any() and not qual.any()  # zeroed: the blocks add into them
    assert len(args) == len(build.SIGNATURES[key][1])
    basis = tk._demod_at_basis(cfg, tdt, cpu)
    masks = tk._frame_crc_masks(pay, n_tiles, cfg.bits_per_symbol, cpu)
    assert args == (x.data_ptr(), tk._KERNEL_DTYPES[tdt], 5, pre, cfg.samples_per_symbol, cfg.num_tones, s,
                    n_tiles, cfg.bits_per_symbol, basis.data_ptr(), masks.data_ptr(), words.data_ptr(),
                    crc.data_ptr(), qual.data_ptr(), 0)
    if tdt == torch.float32:
        _assert_split_basis_of_float32_columns(cfg, basis)
    else:
        assert basis is tk._demod_mma_basis(cfg, tdt, cpu)


def _no_host_reads(monkeypatch):
    """Make every read of a tensor's value to the host raise."""

    def refuse(*args, **kwargs):
        raise AssertionError("a tensor's value was read to the host")

    for attr in ("__float__", "__int__", "__bool__", "item", "tolist"):
        monkeypatch.setattr(torch.Tensor, attr, refuse)


def _demod_at_args(cfg, buf, st, n_sym, basis, outs):
    """demod_at.cu's entry arguments for ``buf`` at starts ``st``."""
    return (buf.data_ptr(), tk._KERNEL_DTYPES[buf.dtype], buf.shape[0], buf.shape[1], st.data_ptr(),
            cfg.preamble_samples, cfg.samples_per_symbol, n_sym, cfg.num_tones, basis.data_ptr(),
            *(o.data_ptr() for o in outs), 0)


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("name", ["mfsk16-fast", "mfsk4-coded", "fsk2-robust"])
def test_demod_at_launch_takes_the_split_basis_for_float32(monkeypatch, name, dtype):
    """demod_at_fused's launch code, the card's calls replaced by
    recorders: one call of the "demod_at" entry (its C signature's
    arguments) with the three-term split (_demod_split_basis, int32 [3, ks,
    n, 2, 32]) for a float32 buffer and _demod_mma_basis for bfloat16 and
    int8; one launch checked with the buffer's dtype, so float32 counts
    under "demod_at_fused:f32"."""
    from anet_torch.kernels import build

    cfg = get_model(name).config
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}[dtype]
    cpu = torch.device("cpu")
    buf = torch.zeros(3, 4096, dtype=tdt)
    st = torch.tensor([0, 5, -7], dtype=torch.int32)
    calls = []
    monkeypatch.setattr(tk, "_entry", lambda key: lambda *args: calls.append((key, args)) or 0)
    monkeypatch.setattr(tk, "_stream_handle", lambda dev: 0)
    monkeypatch.setattr(tk, "_check_cuda_input", lambda name, t, what, int8=False: tk._KERNEL_DTYPES[t.dtype])
    monkeypatch.setattr(tk, "_check_launch", lambda err, name, dtype=None: calls.append(("checked", name, dtype)))
    outs = tk._demod_at_launch(cfg, buf, st, 9)
    (key, args), checked = calls
    basis = tk._demod_split_basis(cfg, cpu) if tdt == torch.float32 else tk._demod_mma_basis(cfg, tdt, cpu)
    assert key == "demod_at" and len(args) == len(build.SIGNATURES[key][1])
    assert args == _demod_at_args(cfg, buf, st, 9, basis, outs)
    assert checked == ("checked", "demod_at_fused", tdt)
    if tdt == torch.float32:
        ks, n = cfg.samples_per_symbol // 16, tk._demod_mma_tiles(cfg.num_tones)
        assert basis.dtype == torch.int32 and basis.shape == (3, ks, n, 2, 32)


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("name", ["mfsk16-fast", "mfsk4-coded", "fsk2-robust"])
def test_demod_at_energies_launch_takes_the_split_basis_for_float32(monkeypatch, name, dtype):
    """demod_at_energies_fused's launch code, the card's calls replaced by
    recorders: one call of the "demod_at_energies" entry (its C signature's
    arguments) with demod_at_fused's basis, the three-term split for a
    float32 buffer and _demod_mma_basis for bfloat16 and int8; float32
    [B, n_symbols, M] energies; one launch checked with the buffer's dtype,
    so float32 counts under "demod_at_energies_fused:f32"."""
    from anet_torch.kernels import build

    cfg = get_model(name).config
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}[dtype]
    cpu = torch.device("cpu")
    buf = torch.zeros(3, 4096, dtype=tdt)
    st = torch.tensor([0, 5, -7], dtype=torch.int32)
    calls = []
    monkeypatch.setattr(tk, "_entry", lambda key: lambda *args: calls.append((key, args)) or 0)
    monkeypatch.setattr(tk, "_stream_handle", lambda dev: 0)
    monkeypatch.setattr(tk, "_check_cuda_input", lambda name, t, what, int8=False: tk._KERNEL_DTYPES[t.dtype])
    monkeypatch.setattr(tk, "_check_launch", lambda err, name, dtype=None: calls.append(("checked", name, dtype)))
    energies = tk._demod_at_energies_launch(cfg, buf, st, 9)
    (key, args), checked = calls
    assert energies.dtype == torch.float32 and energies.shape == (3, 9, cfg.num_tones)
    assert key == "demod_at_energies" and len(args) == len(build.SIGNATURES[key][1])
    assert args[-2:] == (energies.data_ptr(), 0)
    assert args[:-2] == _demod_at_args(cfg, buf, st, 9, tk._demod_at_basis(cfg, tdt, cpu), ())[:-1]
    assert checked == ("checked", "demod_at_energies_fused", tdt)
    if tdt == torch.float32:
        assert args[9] == tk._demod_split_basis(cfg, cpu).data_ptr()


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_demod_probe_launch_goes_to_demod_at_for_every_dtype(monkeypatch, dtype):
    """demod_probe_fused's launch code, the card's calls replaced by
    recorders: the "demod_probe" entry, then the "demod_at" entry (no entry
    of its own for float32) at the probe's refined starts, with the
    three-term split (int32 [3, ks, n, 2, 32]) for a float32 buffer and
    _demod_mma_basis for bfloat16 and int8; one count under the buffer's
    key of demod_probe_fused, none under demod_at_fused's."""
    from anet_torch.kernels import build

    tdt = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}[dtype]
    cpu = torch.device("cpu")
    tpl = torch.from_numpy(np.array(j_preamble(JCFG), np.float32)).to(torch.bfloat16)
    k, n_sym = tpl.shape[-1], 11
    buf = torch.zeros(3, 3 * k, dtype=tdt)
    st0 = torch.tensor([0, 130, -3], dtype=torch.int32)
    calls = []
    monkeypatch.setattr(tk, "launch_counts", dict.fromkeys(tk.launch_counts, 0))
    monkeypatch.setattr(tk, "_entry", lambda key: lambda *args: calls.append((key, args)) or 0)
    monkeypatch.setattr(tk, "_stream_handle", lambda dev: 0)
    monkeypatch.setattr(tk, "_check_cuda_input", lambda name, t, what, int8=False: tk._KERNEL_DTYPES[t.dtype])
    cmax, off, energy, tone, best, total = tk._demod_probe_launch(CFG, buf, st0, n_sym, tpl, 5)
    (probe, p_args), (demod, d_args) = calls
    assert (probe, demod) == ("demod_probe", "demod_at")
    assert "demod_probe_f32" not in build.SIGNATURES
    assert len(p_args) == len(build.SIGNATURES[probe][1]) and len(d_args) == len(build.SIGNATURES[demod][1])
    assert p_args[:3] == (buf.data_ptr(), tk._KERNEL_DTYPES[tdt], 3) and p_args[4] == st0.data_ptr()
    assert p_args[10:13] == (cmax.data_ptr(), off.data_ptr(), energy.data_ptr())
    start_ptr = p_args[13]  # the refined starts the probe writes and the demod reads
    basis = tk._demod_split_basis(CFG, cpu) if tdt == torch.float32 else tk._demod_mma_basis(CFG, tdt, cpu)
    assert d_args[:4] == (buf.data_ptr(), tk._KERNEL_DTYPES[tdt], 3, 3 * k) and d_args[4] == start_ptr
    assert d_args[5:] == (CFG.preamble_samples, CFG.samples_per_symbol, n_sym, CFG.num_tones, basis.data_ptr(),
                          tone.data_ptr(), best.data_ptr(), total.data_ptr(), 0)
    if tdt == torch.float32:
        assert basis.dtype == torch.int32 and basis.shape == (3, CFG.samples_per_symbol // 16, 4, 2, 32)
    key = {torch.float32: "demod_probe_fused:f32", torch.int8: "demod_probe_fused:int8"}.get(tdt, "demod_probe_fused")
    assert {n: c for n, c in tk.launch_counts.items() if c} == {key: 1}


@pytest.mark.parametrize("te_kind", ["tensor", "float"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_probe_at_launch_makes_taps_once_and_passes_te_by_address(monkeypatch, dtype, te_kind):
    """probe_at_fused's launch code, the card's calls replaced by
    recorders: the float32 taps (the template rounded to the buffer's
    dtype) are made once per template tensor, and again only for a template
    changed in place; a tensor template energy goes to the kernel by its
    address with no read of its value (every host read made to raise), a
    float by value with a null address; the span rows are
    ceil((k + n_lags - 1) / 128) + 1; one launch checked a call."""
    tdt = _DTYPES[dtype][0]
    cpu = torch.device("cpu")
    tpl = torch.from_numpy(np.array(j_preamble(JCODED), np.float32)).to(tdt)
    k = tpl.shape[-1]
    buf = torch.randn(3, 4 * k).to(tdt)
    st0 = torch.tensor([0, 130, 2 * k], dtype=torch.int32)
    te = tstream._template_energy(tpl) if te_kind == "tensor" else 1234.5
    made = []
    real_template = tk._probe_template
    monkeypatch.setattr(tk, "_probe_template", lambda t, d: made.append(d) or real_template(t, d))
    calls = _record_launches(monkeypatch)
    if te_kind == "tensor":
        _no_host_reads(monkeypatch)
    for n_lags in (5, 5, 8):
        calls.clear()
        q = tk._probe_at_launch(buf, st0, tpl, te, n_lags)
        (key, args), checked = calls
        assert key == "probe_at" and checked == ("checked", "probe_at_fused")
        assert q.shape == (3, n_lags) and q.dtype == torch.float32 and args[11] == q.data_ptr()
        assert args[:4] == (buf.data_ptr(), tk._KERNEL_DTYPES[tdt], 3, 4 * k) and args[4] == st0.data_ptr()
        assert args[6:9] == (k, n_lags, -(-(k + n_lags - 1) // 128) + 1) and args[12] == 0
        taps = tk._probe_operands(tpl, tdt, cpu)[0]
        assert args[5] == taps.data_ptr()
        if te_kind == "tensor":
            assert args[9] == te.data_ptr() and args[10] == 0.0
        else:
            assert args[9] is None and args[10] == te
    assert made == [tdt]
    assert torch.equal(taps, tpl.to(tdt).float()) and taps.dtype == torch.float32 and taps.is_contiguous()
    changed = tpl.clone()
    tk._probe_operands(changed, tdt, cpu)
    changed.mul_(0.5)
    second = tk._probe_operands(changed, tdt, cpu)[0]
    assert made == [tdt] * 3 and torch.equal(second, changed.to(tdt).float())


def _ofdm_inputs(cfg, b, s, seed=0):
    """(z_eq complex64 [b, s, C], h_pow float32 [b, C], slope0 float32 [b])
    of random points, contiguous."""
    rng = np.random.default_rng(seed)
    c = cfg.n_carriers
    z = (rng.standard_normal((b, s, c)) + 1j * rng.standard_normal((b, s, c))).astype(np.complex64)
    h = rng.uniform(0.5, 1.5, (b, c)).astype(np.float32)
    return torch.from_numpy(z), torch.from_numpy(h), torch.from_numpy(rng.uniform(-1e-3, 1e-3, b).astype(np.float32))


@pytest.mark.parametrize("layout", ["batch-major", "time-major", "strided-h"])
def test_ofdm_launch_passes_strides_unchanged(monkeypatch, layout):
    """ofdm_track_decide_fused's launch code, the card's calls replaced by
    recorders: z_eq and h_pow reach the kernel as the tensors they are,
    their own addresses and strides (complex elements for z_eq, floats for
    h_pow): the time-major receiver's [B, S, C] view of [S, C, B] carriers
    as (1, C B, B) and its h_pow view as (1, B), a strided h_pow as its
    strides, nothing copied; then B, S, C, bits per carrier, the first
    carrier, tracking, the EVM rows and the outputs."""
    cfg = get_model("ofdm-max").config
    b, s, c = 5, 8, cfg.n_carriers
    z, h, slope0 = _ofdm_inputs(cfg, b, s)
    if layout == "time-major":
        z = z.permute(1, 2, 0).contiguous().permute(2, 0, 1)
        h = h.T.contiguous().T
    elif layout == "strided-h":
        h = torch.repeat_interleave(h, 2, dim=-1)[:, 1::2]
    calls = _record_launches(monkeypatch)
    llrs, evm2, coh = tk._ofdm_track_launch(cfg, z, h, slope0, 6, True)
    (key, args), checked = calls
    assert key == "ofdm_track" and checked == ("checked", "ofdm_track_decide_fused")
    assert args[0] == z.data_ptr() and args[1:4] == z.stride()
    assert args[4] == h.data_ptr() and args[5:7] == h.stride()
    if layout == "time-major":
        assert z.stride() == (1, c * b, b) and h.stride() == (1, b)
    assert args[8:15] == (b, s, c, 6, cfg.first_carrier, 1, 6)
    assert args[15:18] == (llrs.data_ptr(), evm2.data_ptr(), coh.data_ptr()) and args[18] == 0
    assert llrs.shape == (b, s * c * 6) and llrs.is_contiguous() and evm2.shape == (b,) and coh.shape == (b, 2)
    calls.clear()
    tk._ofdm_track_launch(dataclasses.replace(cfg, clock_tracking=False), z, h, slope0, None, False)
    (key, args), _ = calls
    assert args[13:15] == (0, s) and args[17] is None


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", ["mfsk4-coded", "ofdm-fast", "mfsk16-fast"])
def test_lock_template_energy_is_cached_and_bit_equal(name, dtype):
    """The locked steps' template energy is made once per config, compute
    dtype and device (stream._lock_template): the same float32 scalar
    tensor every call, bit-equal to _template_energy of the template."""
    cfg, tdt, cpu = get_model(name).config, _DTYPES[dtype][0], torch.device("cpu")
    t_c, te = tstream._lock_template(cfg, tdt, cpu)
    again = tstream._lock_template(cfg, tdt, cpu)
    assert again[0] is t_c and again[1] is te
    assert t_c is tstream._templates(cfg, tdt, cpu)[1]
    want = tstream._template_energy(t_c)
    assert te.dtype == torch.float32 and te.dim() == 0 and torch.equal(te, want)
    assert te.view(torch.int32).item() == want.view(torch.int32).item()


def test_locked_coded_step_hands_the_cached_energy_to_the_probe(monkeypatch):
    """The unmerged locked step (a bf16 mfsk4-coded carry, the card's branch
    driven on the CPU) hands probe_at_fused the cached template and energy
    tensors of _lock_template on every chunk: nothing recomputed a chunk."""
    cfg = CODED
    seen = []
    real = tk.probe_at_fused

    def recorded(buffer, st0, template, template_energy, n_lags=5):
        seen.append((template, template_energy))
        return real(buffer, st0, template, template_energy, n_lags)

    monkeypatch.setattr(tstream, "_probe_kernel_supported", lambda carry: True)
    monkeypatch.setattr(tk, "probe_at_fused", recorded)
    pay = 32
    tx = transmit(cfg, np.random.default_rng(2).integers(0, 256, (2, pay), dtype=np.uint8), device="cpu")
    t_frame = tx.shape[-1]
    cap = torch.zeros(2, 3 * CHUNK + 2 * t_frame)
    cap[:, 300 : 300 + t_frame] = tx
    cap[:, 300 + t_frame : 300 + 2 * t_frame] = tx
    carry = tstream.init_carry(cfg, CHUNK, pay, (2,), dtype=torch.bfloat16, device="cpu")
    cap = cap[:, : cap.shape[1] // CHUNK * CHUNK]
    res = tstream.receive_stream(cfg, cap, CHUNK, pay, lock=True, carry=carry, compute_dtype=torch.bfloat16,
                                 device="cpu")
    assert int(res.carry.frames_ok.sum()) >= 2 and len(seen) == cap.shape[1] // CHUNK
    t_c, te = tstream._lock_template(cfg, torch.bfloat16, torch.device("cpu"))
    assert all(t is t_c and e is te for t, e in seen)
