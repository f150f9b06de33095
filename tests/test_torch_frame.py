"""Transmit and aligned receive, anet_torch against the JAX package on the
CPU: the same payloads and the same numpy noise go through both
transmitters and both time-major receivers (demodulate_frame_tm). Payloads
and the five verdicts must be bit-equal; confidence and snr_db agree with
JAX and with a float64 numpy computation of the same quantities. The coded
path (mfsk4-coded: convolutional code, interleaver, soft Viterbi) goes
through the same comparison, batch-major and time-major."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anet.dsp import frame as jframe
from anet.dsp import pipeline as jpipeline
from anet.dsp.demod import demod_basis as j_basis
from anet.models import get_model as jget_model

from anet_torch.dsp import frame as tframe
from anet_torch.dsp import pipeline as tpipeline
from anet_torch.dsp.family import geometry, transmit_fn
from anet_torch.kernels import decide_frame_tm
from anet_torch.models import get_model

NAME = "mfsk16-fast"
CFG, JCFG = get_model(NAME).config, jget_model(NAME).config
PAY = 64
VERDICTS = ("magic_ok", "length_ok", "header_crc_ok", "payload_crc_ok", "ok")


def _capture(noise, seed=0, b=4):
    """(payloads, time-major waveforms [T, B]) with the last frame's payload
    corrupted on the air: three payload symbols come from another frame, so
    its payload CRC fails while its header stays intact."""
    rng = np.random.default_rng(seed)
    pay = rng.integers(0, 256, (b, PAY), dtype=np.uint8)
    other = rng.integers(0, 256, (1, PAY), dtype=np.uint8)
    w = np.array(jpipeline.transmit(JCFG, jnp.asarray(pay)))
    wt = tpipeline.transmit(CFG, pay, device="cpu").numpy()
    np.testing.assert_allclose(wt, w, atol=1e-5)
    wo = np.asarray(jpipeline.transmit(JCFG, jnp.asarray(other)))
    sps = CFG.samples_per_symbol
    lo = CFG.preamble_samples + 20 * sps  # past the 8 header bytes (16 symbols)
    w[-1, lo : lo + 3 * sps] = wo[0, lo : lo + 3 * sps]
    w = w + noise * rng.standard_normal(w.shape).astype(np.float32)
    return pay, np.ascontiguousarray(w.T)


def _f64_quality(x_tm):
    """confidence and snr_db in float64 numpy, from the waveforms alone."""
    sps, m = CFG.samples_per_symbol, CFG.num_tones
    pre = CFG.preamble_samples
    basis = np.asarray(j_basis(JCFG), np.float64)
    data = x_tm[pre:].astype(np.float64)
    s = data.shape[0] // sps
    win = data[: s * sps].reshape(s, sps, -1)
    iq = np.einsum("skb,km->smb", win, basis)
    e = iq[:, :m] ** 2 + iq[:, m:] ** 2
    best, total = e.max(1), e.sum(1)
    conf = (best / total).mean(0)
    noise = ((total - best) / (m - 1)).mean(0)
    snr = 10 * np.log10(best.mean(0) / noise - 1.0)
    return conf, snr


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("noise", [0.0, 0.3])
def test_aligned_receiver_matches_jax(noise, use_pallas):
    pay, x = _capture(noise)
    got = tframe.demodulate_frame_tm(CFG, x, PAY, compute_dtype=torch.float32, device="cpu")
    want = jframe.demodulate_frame_tm(
        JCFG, jnp.asarray(x), PAY, compute_dtype=jnp.float32,
        use_pallas=use_pallas, interpret=use_pallas,
    )
    np.testing.assert_array_equal(got.payload.numpy(), np.asarray(want.payload))
    for v in VERDICTS:
        np.testing.assert_array_equal(getattr(got, v).numpy(), np.asarray(getattr(want, v)), v)
    assert got.ok.numpy().tolist() == [True, True, True, False]
    assert not bool(got.payload_crc_ok[-1]) and bool(got.header_crc_ok[-1])
    np.testing.assert_array_equal(got.payload.numpy()[:3], pay[:3])
    np.testing.assert_allclose(got.confidence.numpy(), np.asarray(want.confidence), rtol=1e-5)
    # clean frames have ~zero noise bins: snr clamps the same way in both
    np.testing.assert_allclose(got.snr_db.numpy(), np.asarray(want.snr_db), atol=1e-3)
    if noise:
        conf64, snr64 = _f64_quality(x)
        np.testing.assert_allclose(got.confidence.numpy(), conf64, rtol=1e-5)
        np.testing.assert_allclose(np.asarray(want.confidence), conf64, rtol=1e-5)
        np.testing.assert_allclose(got.snr_db.numpy(), snr64, atol=1e-3)
        np.testing.assert_allclose(np.asarray(want.snr_db), snr64, atol=1e-3)


def test_bf16_aligned_receiver_matches_jax():
    pay, x = _capture(0.3, seed=2)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = tframe.demodulate_frame_tm(CFG, xb, PAY, device="cpu")
    want = jframe.demodulate_frame_tm(
        JCFG, jnp.asarray(x).astype(jnp.bfloat16), PAY, use_pallas=True, interpret=True
    )
    np.testing.assert_array_equal(got.payload.numpy(), np.asarray(want.payload))
    for v in VERDICTS:
        np.testing.assert_array_equal(getattr(got, v).numpy(), np.asarray(getattr(want, v)), v)
    np.testing.assert_allclose(got.confidence.numpy(), np.asarray(want.confidence), rtol=1e-5)


def test_batch_major_receiver_and_family():
    pay, x = _capture(0.3, seed=3)
    t_frame, tpl, demod = geometry(CFG, PAY, device="cpu")
    assert t_frame == x.shape[0] and tpl.shape == (CFG.preamble_samples,)
    got = demod(np.ascontiguousarray(x.T))
    want = jframe.demodulate_frame(JCFG, jnp.asarray(x.T), PAY)
    np.testing.assert_array_equal(got.payload.numpy(), np.asarray(want.payload))
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(want.ok))
    np.testing.assert_allclose(got.confidence.numpy(), np.asarray(want.confidence), rtol=1e-5)
    np.testing.assert_allclose(got.snr_db.numpy(), np.asarray(want.snr_db), atol=1e-3)
    w = transmit_fn(CFG, device="cpu")(pay)
    assert w.shape == (4, t_frame)


def test_packed_parse_takes_negative_words():
    """A word whose top bit is set (negative int32) still yields its bytes."""
    pay = np.full((1, PAY), 0xFF, np.uint8)
    x = np.ascontiguousarray(tpipeline.transmit(CFG, pay, device="cpu").numpy().T)
    words, crc, qual, s = decide_frame_tm(
        CFG, torch.from_numpy(x), PAY, preamble_offset=CFG.preamble_samples
    )
    assert int((words < 0).sum()) > 0
    res = tframe.frame_result_from_packed(CFG, words, crc, qual, s, PAY)
    assert bool(res.ok.all()) and bool((res.payload == 0xFF).all())


def test_oversized_window_takes_plain_filterbank_on_cpu():
    """A window one symbol longer than the frame skips the full-fusion
    kernel (whose quality sums cover exactly the frame's symbols) and takes
    the plain filterbank over every symbol present, as JAX's golden path
    does."""
    pay, x = _capture(0.3, seed=4)
    x = np.concatenate([x, np.zeros((CFG.samples_per_symbol, x.shape[1]), np.float32)])
    got = tframe.demodulate_frame_tm(CFG, x, PAY, compute_dtype=torch.float32, device="cpu")
    want = jframe.demodulate_frame_tm(JCFG, jnp.asarray(x), PAY, compute_dtype=jnp.float32)
    np.testing.assert_array_equal(got.payload.numpy(), np.asarray(want.payload))
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(want.ok))
    np.testing.assert_allclose(got.confidence.numpy(), np.asarray(want.confidence), rtol=1e-5)
    np.testing.assert_allclose(got.snr_db.numpy(), np.asarray(want.snr_db), atol=1e-3)


# --- the coded path: mfsk4-coded ----------------------------------------------

CODED = "mfsk4-coded"
CCFG, JCCFG = get_model(CODED).config, jget_model(CODED).config
CPAY = 32


def test_coded_geometry_matches_jax():
    """Payload 256 on mfsk4-coded: the JAX package's own numbers."""
    from anet import stream as jstream
    from anet_torch import stream as tstream

    assert CCFG.samples_per_symbol == 32 and CCFG.fec == "conv" and CCFG.fec_interleave == 24
    assert tframe.frame_num_samples(CCFG, 256) == jframe.frame_num_samples(JCCFG, 256) == 70144
    assert tframe.data_symbols_for_payload(CCFG, 256) == jframe.data_symbols_for_payload(JCCFG, 256) == 2160
    assert tframe.data_section_coded_bits(CCFG, 256) == jframe.data_section_coded_bits(JCCFG, 256) == 4320
    assert tstream._buffer_len(CCFG, 70144, 256) == jstream._buffer_len(JCCFG, 70144, 256) == 143872


def _coded_capture(noise, seed=0, b=4):
    """(payloads, batch-major waveforms [B, T]): the last frame's data
    section is another frame's from a third of the way in, so its header
    decodes or not as the code decides and its payload CRC fails."""
    rng = np.random.default_rng(seed)
    pay = rng.integers(0, 256, (b, CPAY), dtype=np.uint8)
    other = rng.integers(0, 256, (1, CPAY), dtype=np.uint8)
    w = np.array(jpipeline.transmit(JCCFG, jnp.asarray(pay)))
    wo = np.asarray(jpipeline.transmit(JCCFG, jnp.asarray(other)))
    lo = CCFG.preamble_samples + (w.shape[1] - CCFG.preamble_samples) // 3 // 32 * 32
    w[-1, lo:] = wo[0, lo:]
    return pay, w + noise * rng.standard_normal(w.shape).astype(np.float32)


def test_coded_transmit_matches_jax():
    rng = np.random.default_rng(5)
    pay = rng.integers(0, 256, (3, CPAY), dtype=np.uint8)
    bits = tframe.data_section_air_bits_array(CCFG, torch.from_numpy(pay))
    jbits = jframe.data_section_air_bits_array(JCCFG, jnp.asarray(pay))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
    syms = tframe.frame_data_symbols(CCFG, torch.from_numpy(pay))
    np.testing.assert_array_equal(syms.numpy(), np.asarray(jframe.frame_data_symbols(JCCFG, jnp.asarray(pay))))
    w = tpipeline.transmit(CCFG, pay, device="cpu")
    assert w.shape == (3, tframe.frame_num_samples(CCFG, CPAY))
    # float32 rounding of the synthesized tones
    np.testing.assert_allclose(w.numpy(), np.asarray(jpipeline.transmit(JCCFG, jnp.asarray(pay))), atol=1e-5)


def _assert_coded_result(got, want, pay, kernels):
    """Against JAX's Pallas trellis (which adds a candidate's terms in the
    port's order) every payload byte is equal, the undecodable frame's
    included; against the jnp scan (which adds them in another order, so
    near-ties of an undecodable frame may part) the frames that decode."""
    keep = slice(None) if kernels else got.ok.numpy()
    np.testing.assert_array_equal(got.payload.numpy()[keep], np.asarray(want.payload)[keep])
    for v in VERDICTS:
        np.testing.assert_array_equal(getattr(got, v).numpy(), np.asarray(getattr(want, v)), v)
    assert got.ok.numpy().tolist() == [True, True, True, False]
    np.testing.assert_array_equal(got.payload.numpy()[:3], pay[:3])
    # float32 sums in another order
    np.testing.assert_allclose(got.confidence.numpy(), np.asarray(want.confidence), rtol=1e-5)
    np.testing.assert_allclose(got.snr_db.numpy(), np.asarray(want.snr_db), atol=1e-3)


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("noise", [0.0, 0.6])
def test_coded_batch_major_receiver_matches_jax(noise, kernels, interpret_tpu_kernels):
    """demodulate_frame on mfsk4-coded at operating noise, against JAX's
    jnp path and against JAX with its Pallas kernels in interpret mode."""
    pay, x = _coded_capture(noise)
    got = tframe.demodulate_frame(CCFG, x, CPAY, device="cpu")
    if kernels:
        interpret_tpu_kernels()
    want = jframe.demodulate_frame(JCCFG, jnp.asarray(x), CPAY)
    _assert_coded_result(got, want, pay, kernels)
    demod = geometry(CCFG, CPAY, device="cpu")[2]
    np.testing.assert_array_equal(demod(x).payload.numpy(), got.payload.numpy())


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("noise", [0.0, 0.6])
def test_coded_aligned_receiver_matches_jax(noise, dtype, kernels, interpret_tpu_kernels):
    """demodulate_frame_tm on mfsk4-coded: the filterbank product branch,
    LLRs from the transposed energies, deinterleaver and soft Viterbi."""
    tdt, jdt = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    pay, x = _coded_capture(noise, seed=1)
    x_tm = np.ascontiguousarray(x.T)
    got = tframe.demodulate_frame_tm(CCFG, x_tm, CPAY, compute_dtype=tdt, device="cpu")
    if kernels:
        interpret_tpu_kernels()
    want = jframe.demodulate_frame_tm(JCCFG, jnp.asarray(x_tm), CPAY, compute_dtype=jdt)
    _assert_coded_result(got, want, pay, kernels)


def test_coded_tone_decisions_parse_refuses_like_jax():
    """frame_result_from_tone_decisions has only the winning tones; the soft
    decisions need every tone's energy, so both packages refuse a coded
    config there, and frame_result_from_bits decodes hard bits as +-1."""
    pay, x = _coded_capture(0.3, seed=2)
    n_sym = tframe.data_symbols_for_payload(CCFG, CPAY)
    from anet_torch.kernels import demod_at_fused

    tone, best, total = demod_at_fused(CCFG, torch.from_numpy(x), torch.zeros(4, dtype=torch.int32), n_sym)
    with pytest.raises(ValueError, match="full energies"):
        tframe.frame_result_from_tone_decisions(CCFG, tone, best, total, CPAY)
    with pytest.raises(ValueError, match="full energies"):
        jframe.frame_result_from_tone_decisions(
            JCCFG, jnp.asarray(tone.numpy()), jnp.asarray(best.numpy()), jnp.asarray(total.numpy()), CPAY
        )
    bits = (tone[..., None] >> torch.tensor([1, 0])) & 1  # 4-FSK Gray decode is g ^ (g >> 1)
    bits = bits ^ torch.stack([torch.zeros_like(tone), tone >> 1], -1)
    bits = bits.reshape(4, -1).to(torch.uint8)
    zero = torch.zeros(4)
    got = tframe.frame_result_from_bits(CCFG, bits, CPAY, confidence=zero, snr_db=zero)
    want = jframe.frame_result_from_bits(
        JCCFG, jnp.asarray(bits.numpy()), CPAY, confidence=jnp.zeros(4), snr_db=jnp.zeros(4)
    )
    np.testing.assert_array_equal(got.payload.numpy(), np.asarray(want.payload))
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(want.ok))
    assert got.ok.numpy().tolist() == [True, True, True, False]


# --- variable-length frames: the length comes from the header -----------------

DCODED = "mfsk4-coded-stream"  # fec_interleave == 1
DCFG, JDCFG = get_model(DCODED).config, jget_model(DCODED).config
MAX = 48
DYN_FIELDS = ("payload", "payload_len") + VERDICTS


def _dynamic_windows(cfg, jcfg, lens, noise, seed):
    """(payloads, [B, T_max] max-length windows): one frame per entry of
    ``lens`` at the window's start, noise everywhere; the last frame's
    trailer is hit, so its payload CRC fails while its header stands."""
    rng = np.random.default_rng(seed)
    t_max = jframe.frame_num_samples(jcfg, MAX)
    pays = [rng.integers(0, 256, n, dtype=np.uint8) for n in lens]
    x = np.zeros((len(lens), t_max), np.float32)
    for i, p in enumerate(pays):
        w = tpipeline.transmit(cfg, p, device="cpu").numpy()  # held equal to JAX's above
        x[i, : len(w)] = w
        if i == len(lens) - 1:
            span = (6 if cfg.fec == "none" else 80) * cfg.samples_per_symbol  # a burst the code cannot mend
            x[i, len(w) - span : len(w)] = x[i, cfg.preamble_samples : cfg.preamble_samples + span]
    return pays, x + noise * rng.standard_normal(x.shape).astype(np.float32)


def _assert_dynamic_equal(got, want, pays, tol=1e-4):
    for f in DYN_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), f)
    assert got.payload_len.dtype == torch.int32 and got.payload.dtype == torch.uint8
    assert got.ok.numpy().tolist() == [True] * (len(pays) - 1) + [False]
    assert bool(got.header_crc_ok.all()) and not bool(got.payload_crc_ok[-1])
    for i, p in enumerate(pays[:-1]):
        assert int(got.payload_len[i]) == len(p)
        np.testing.assert_array_equal(got.payload.numpy()[i, : len(p)], p)
        assert not got.payload.numpy()[i, len(p) :].any()
    # float32 sums in another order
    np.testing.assert_allclose(got.confidence.numpy(), np.asarray(want.confidence), rtol=tol)
    np.testing.assert_allclose(got.snr_db.numpy(), np.asarray(want.snr_db), rtol=tol, atol=1e-3)


@pytest.mark.parametrize("noise", [0.0, 0.3])
def test_demodulate_frame_dynamic_matches_jax(noise):
    """Uncoded max-length windows holding frames of payload 0, 1, 20, 48 and
    a corrupted 30: payloads, declared lengths and verdicts bit-equal;
    confidence and snr_db (over the overhead symbols) rtol 1e-4."""
    pays, x = _dynamic_windows(CFG, JCFG, (0, 1, 20, MAX, 30), noise, 7)
    got = tframe.demodulate_frame_dynamic(CFG, x, MAX, device="cpu")
    want = jax.jit(lambda w: jframe.demodulate_frame_dynamic(JCFG, w, MAX))(jnp.asarray(x))
    _assert_dynamic_equal(got, want, pays)
    assert isinstance(got, tframe.DynamicFrameResult)
    assert tframe.DynamicFrameResult._fields == jframe.DynamicFrameResult._fields


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("noise", [0.0, 0.6])
def test_coded_demodulate_frame_dynamic_matches_jax(noise, kernels, interpret_tpu_kernels):
    """The same on mfsk4-coded-stream (header probe + masked trellis): at
    operating noise against JAX's jnp scan, and against JAX with its Pallas
    trellis in interpret mode, where every payload byte is equal."""
    pays, x = _dynamic_windows(DCFG, JDCFG, (0, 1, 20, MAX, 30), noise, 8)
    got = tframe.demodulate_frame_dynamic(DCFG, x, MAX, device="cpu")
    if kernels:
        interpret_tpu_kernels()
    want = jax.jit(lambda w: jframe.demodulate_frame_dynamic(JDCFG, w, MAX))(jnp.asarray(x))
    _assert_dynamic_equal(got, want, pays)


def test_dynamic_parse_functions_match_jax():
    """frame_result_from_bits_dynamic, dynamic_frame_result_from_tone_decisions
    and dynamic_frame_result_from_energies against their JAX twins on the
    same decisions and energies."""
    from anet.dsp.demod import tone_energies as j_tone_energies

    pays, x = _dynamic_windows(CFG, JCFG, (5, MAX, 17), 0.3, 9)
    e = np.asarray(j_tone_energies(JCFG, jnp.asarray(x[:, CFG.preamble_samples :])))
    tone, best, total = e.argmax(-1).astype(np.int32), e.max(-1), e.sum(-1)
    got = tframe.dynamic_frame_result_from_tone_decisions(
        CFG, torch.from_numpy(tone), torch.from_numpy(best), torch.from_numpy(total), MAX
    )
    want = jax.jit(lambda *a: jframe.dynamic_frame_result_from_tone_decisions(JCFG, *a, MAX))(
        jnp.asarray(tone), jnp.asarray(best), jnp.asarray(total)
    )
    _assert_dynamic_equal(got, want, pays)
    bits = np.array(jframe.unpack_symbols(jframe.decide_symbols(JCFG, jnp.asarray(e)), 4))
    zero = np.zeros(3, np.float32)
    got = tframe.frame_result_from_bits_dynamic(
        CFG, torch.from_numpy(bits), MAX, confidence=torch.from_numpy(zero), snr_db=torch.from_numpy(zero)
    )
    want = jax.jit(lambda b, z: jframe.frame_result_from_bits_dynamic(JCFG, b, MAX, confidence=z, snr_db=z))(
        jnp.asarray(bits), jnp.asarray(zero)
    )
    _assert_dynamic_equal(got, want, pays)

    pays, x = _dynamic_windows(DCFG, JDCFG, (5, MAX, 17), 0.5, 10)
    e = np.array(j_tone_energies(JDCFG, jnp.asarray(x[:, DCFG.preamble_samples :])))
    got = tframe.dynamic_frame_result_from_energies(DCFG, torch.from_numpy(e), MAX)
    want = jax.jit(lambda v: jframe.dynamic_frame_result_from_energies(JDCFG, v, MAX))(jnp.asarray(e))
    _assert_dynamic_equal(got, want, pays)


def test_dynamic_parse_refusals_match_jax():
    zero = torch.zeros(1)
    bits = torch.zeros(1, 8 * (12 + MAX), dtype=torch.uint8)
    with pytest.raises(ValueError, match="fec='none'"):
        tframe.frame_result_from_bits_dynamic(DCFG, bits, MAX, confidence=zero, snr_db=zero)
    with pytest.raises(ValueError, match="fec='none'"):
        jframe.frame_result_from_bits_dynamic(
            JDCFG, jnp.asarray(bits.numpy()), MAX, confidence=jnp.zeros(1), snr_db=jnp.zeros(1)
        )
    with pytest.raises(ValueError, match="needs fec='conv'"):
        tframe.frame_result_from_llrs_dynamic(CFG, torch.zeros(1, 2000), MAX, confidence=zero, snr_db=zero)
    # a block interleaver's geometry depends on the declared length
    for fn, cfg, arr in ((tframe, CCFG, torch.zeros(1, 2000)), (jframe, JCCFG, jnp.zeros((1, 2000)))):
        with pytest.raises(ValueError, match="fec_interleave == 1"):
            fn.frame_result_from_llrs_dynamic(cfg, arr, MAX, confidence=arr[:, 0], snr_db=arr[:, 0])
    with pytest.raises(ValueError, match="requires fec='none'"):
        tframe.dynamic_frame_result_from_tone_decisions(DCFG, bits[:, :10].int(), zero, zero, MAX)


@pytest.mark.parametrize("name", ["mfsk16-fast", "mfsk4-coded-stream", "fsk2-robust", "mfsk8-audible"])
def test_dynamic_frame_samples_matches_jax(name):
    """Per-frame sample counts for tensors and ints; equal to the static
    frame_num_samples wherever the dynamic coded path is allowed."""
    cfg, jcfg = get_model(name).config, jget_model(name).config
    lens = np.array([0, 1, 7, 64, 255, 256], np.int32)
    got = tframe.dynamic_frame_samples(cfg, torch.from_numpy(lens))
    want = jframe.dynamic_frame_samples(jcfg, jnp.asarray(lens))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for n in lens.tolist():
        assert tframe.dynamic_frame_samples(cfg, n) == tframe.frame_num_samples(cfg, n)
    assert isinstance(tframe.dynamic_frame_samples(cfg, 5), int)
    assert tframe.HEADER_PROBE_DATA_BITS == jframe.HEADER_PROBE_DATA_BITS


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_oversized_window_matches_jax_decide_tones_kernel(dtype):
    """A window 8 symbols longer than the frame goes through decide_tones_tm
    (its plain version here) against JAX's Pallas kernel in interpret mode:
    payloads and verdicts equal, and confidence / snr_db average over every
    symbol of the window, not the frame's own (against numpy float64)."""
    tdt, jdt = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    pay, x = _capture(0.3, seed=5)
    rng = np.random.default_rng(55)
    x = np.concatenate([x, rng.standard_normal((8 * CFG.samples_per_symbol, x.shape[1])).astype(np.float32)])
    xt = torch.from_numpy(x).to(tdt)
    got = tframe.demodulate_frame_tm(CFG, xt, PAY, compute_dtype=tdt, device="cpu")
    want = jframe.demodulate_frame_tm(
        JCFG, jnp.asarray(x).astype(jdt), PAY, compute_dtype=jdt, use_pallas=True, interpret=True
    )
    np.testing.assert_array_equal(got.payload.numpy(), np.asarray(want.payload))
    for v in VERDICTS:
        np.testing.assert_array_equal(getattr(got, v).numpy(), np.asarray(getattr(want, v)), v)
    assert got.ok.numpy().tolist() == [True, True, True, False]
    np.testing.assert_allclose(got.confidence.numpy(), np.asarray(want.confidence), rtol=1e-5)
    np.testing.assert_allclose(got.snr_db.numpy(), np.asarray(want.snr_db), atol=1e-3)
    if dtype == "f32":
        conf64, snr64 = _f64_quality(x)
        np.testing.assert_allclose(got.confidence.numpy(), conf64, rtol=1e-5)
        np.testing.assert_allclose(got.snr_db.numpy(), snr64, atol=1e-3)
        exact = tframe.demodulate_frame_tm(CFG, x[: -8 * CFG.samples_per_symbol], PAY, compute_dtype=tdt, device="cpu")
        assert float((exact.confidence - got.confidence).abs().min()) > 1e-3  # the window's noise symbols count
