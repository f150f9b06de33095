"""The OFDM family of anet_torch against the JAX package on the CPU: the
config and presets, TX, the receiver's front (carrier extraction, the
preamble slope) under sample-clock drift, the plain version of the
equalizer kernel against the Pallas kernel in interpret mode, the aligned
(batch- and time-major), dynamic and one-shot receivers against both of the
reference's routes, and the family dispatch. The same numpy inputs go
through both packages.

Tolerances. Waveforms rtol 1e-5, atol 1e-6 (float32 products summed in
another order). Payloads, ``ok`` and the other verdicts equal; confidence
rtol 1e-4, snr_db rtol and atol 1e-3 (the reference's own, for its two
routes). The equalizer's identity gate compares two coherences that differ
in the last digits on a clean-clock frame, so another summation order may
flip it: LLRs are compared (rtol 1e-4, atol 1e-4 of their scale) on the
streams whose gate agrees, every stream whose LLRs part must have its two
coherences within GATE_EPS, and drifted streams (|ppm| >= 100) may not part
at all."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import anet.kernels as jkernels
from anet.channel import ChannelConfig, apply_channel, awgn
from anet.dsp import family as jfamily
from anet.dsp import ofdm as jofdm
from anet.models import OPERATING_SNR_DB as J_SNR
from anet.models import get_model as jget_model

from anet_torch import kernels as tk
from anet_torch.dsp import family as tfamily
from anet_torch.dsp import ofdm as tofdm
from anet_torch.models import OPERATING_SNR_DB, get_model

PRESETS = ("ofdm-fast", "ofdm-coded", "ofdm-turbo", "ofdm-max")
CFG, JCFG = tofdm.OfdmConfig(), jofdm.OfdmConfig()
GATE_EPS = 1e-4  # |coh(tracked) - coh(unrotated)| below which a gate may flip
LLR_RTOL = 1e-4
QPSK_AMP = 0.7071067811865476


def _pair(**kw):
    return tofdm.OfdmConfig(**kw), jofdm.OfdmConfig(**kw)


CASES = {  # the cases of the reference's fused-kernel test (tests/test_ofdm.py:503)
    "qpsk": (dict(), 16.0),
    "qpsk-untracked": (dict(clock_tracking=False), 16.0),
    "qam16": (dict(bits_per_carrier=4), 24.0),
    "qam64-coded": (dict(bits_per_carrier=6, fec="conv", fec_interleave=32), 26.0),
}


@functools.lru_cache(maxsize=None)
def _jit(fn, *static):
    """One compiled program per reference function (its configs static)."""
    return jax.jit(fn, static_argnums=static)


def resample_ppm(x, ppm):
    """Band-limited resample of a waveform to a receiver clock ``ppm`` parts
    per million off: the DFT interpolant evaluated at t * (1 + ppm 1e-6)."""
    x = np.asarray(x, np.float64)
    n = len(x)
    coef = np.fft.rfft(x)
    coef[1:-1] *= 2
    t = np.arange(int(n / (1 + ppm * 1e-6))) * (1 + ppm * 1e-6)
    freqs = np.arange(len(coef))
    out = np.empty(len(t))
    for i in range(0, len(t), 2048):
        out[i : i + 2048] = (np.exp(2j * np.pi * np.outer(t[i : i + 2048], freqs) / n) @ coef).real / n
    return out.astype(np.float32)


def _drifted(jcfg, pays, ppms, snr_db, seed, length=None):
    """[B, T] float32 frames, each resampled to its ppm, cut or padded to
    ``length`` (default the frame), with AWGN at ``snr_db`` from JAX."""
    w = np.asarray(_jit(jofdm.transmit, 0)(jcfg, jnp.asarray(pays)))
    t = length or w.shape[-1]
    rows = [np.pad(r, (0, max(0, t - len(r))))[:t] for r in (resample_ppm(x, p) for x, p in zip(w, ppms))]
    return np.array(_jit(awgn)(jax.random.PRNGKey(seed), jnp.asarray(np.stack(rows)), snr_db))


@functools.lru_cache(maxsize=None)
def _case_frames(case):
    """(config pair, payloads, ppms, frames [3, T]) of one of CASES: three
    128-byte frames at +150, 0 and -150 ppm (all at 0 untracked)."""
    kw, snr = CASES[case]
    cfg, jcfg = _pair(**kw)
    pays = np.random.default_rng(31).integers(0, 256, (3, 128), np.uint8)
    ppms = np.array((150, 0, -150) if cfg.clock_tracking else (0, 0, 0))
    return cfg, jcfg, pays, ppms, _drifted(jcfg, pays, ppms, snr, seed=9, length=cfg.frame_num_samples(128))


def _assert_frames(got, want, det=None):
    np.testing.assert_array_equal(got.payload.numpy(), np.asarray(want.payload))
    for f in ("magic_ok", "length_ok", "header_crc_ok", "payload_crc_ok", "ok"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), f)
    np.testing.assert_allclose(got.confidence.numpy(), np.asarray(want.confidence), rtol=1e-4)
    np.testing.assert_allclose(got.snr_db.numpy(), np.asarray(want.snr_db), rtol=1e-3, atol=1e-3)


def test_config_json_presets_and_thresholds():
    for name in PRESETS:
        cfg, jcfg = get_model(name).config, jget_model(name).config
        assert tofdm.OfdmConfig.from_json(jcfg.to_json()) == cfg
        assert jofdm.OfdmConfig.from_json(cfg.to_json()) == jcfg
        assert get_model(name).description == jget_model(name).description
        assert cfg.bit_rate_bps == jcfg.bit_rate_bps and cfg.carrier_freqs_hz == jcfg.carrier_freqs_hz
        for n in (0, 1, 64, 256, 4096):
            assert cfg.frame_num_samples(n) == jcfg.frame_num_samples(n)
            assert cfg.data_symbols_for_payload(n) == jcfg.data_symbols_for_payload(n)
    assert OPERATING_SNR_DB == J_SNR
    for bad, match in ((dict(n_fft=200), "power of two"), (dict(cp_len=0), "cp_len"),
                       (dict(first_carrier=64), "Nyquist"), (dict(bits_per_carrier=3), "bits_per_carrier"),
                       (dict(fec="turbo"), "fec")):
        with pytest.raises(ValueError, match=match):
            tofdm.OfdmConfig(**bad)


@pytest.mark.parametrize("kw", [
    dict(), dict(fec="conv", fec_interleave=32), dict(bits_per_carrier=4),
    dict(bits_per_carrier=4, fec="conv", fec_interleave=32), dict(bits_per_carrier=6),
    dict(bits_per_carrier=6, fec="conv", fec_interleave=32),
], ids=["qpsk", "qpsk-coded", "qam16", "qam16-coded", "qam64", "qam64-coded"])
def test_transmit_matches_jax(kw):
    cfg, jcfg = _pair(**kw)
    pays = np.random.default_rng(cfg.bits_per_carrier).integers(0, 256, (3, 40), np.uint8)
    np.testing.assert_allclose(
        tofdm.transmit(cfg, pays, device="cpu").numpy(),
        np.asarray(_jit(jofdm.transmit, 0)(jcfg, jnp.asarray(pays))),
        rtol=1e-5, atol=1e-6,
    )
    np.testing.assert_allclose(
        tofdm.preamble_waveform(cfg, device="cpu").numpy(), np.asarray(jofdm.preamble_waveform(jcfg)),
        rtol=1e-5, atol=1e-6,
    )
    bits = np.random.default_rng(1).integers(0, 2, (2, 12 * cfg.bits_per_carrier), np.uint8)
    np.testing.assert_array_equal(
        tofdm.bits_to_carriers(cfg, torch.from_numpy(bits)).numpy(),
        np.asarray(jofdm.bits_to_carriers(jcfg, jnp.asarray(bits))),
    )


@pytest.mark.parametrize("ppm", [-150, 0, 150])
def test_front_matches_jax_under_drift(ppm):
    """_extract_carriers, preamble_phase_slope (with its wrap gate) and
    estimate_drift_ppm on one drifted, noisy frame."""
    pays = np.random.default_rng(24).integers(0, 256, (2, 128), np.uint8)
    x = _drifted(JCFG, pays, (ppm, ppm), 20.0, seed=abs(ppm) + 1)
    n_sym = 1 + CFG.data_symbols_for_payload(128)
    body = x[..., CFG.preamble_samples :]
    got = tofdm._extract_carriers(CFG, torch.from_numpy(body), n_sym).numpy()
    want = np.asarray(_jit(jofdm._extract_carriers, 0, 2)(JCFG, jnp.asarray(body), n_sym))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    slope = tofdm.preamble_phase_slope(CFG, torch.from_numpy(x)).numpy()
    want = np.asarray(_jit(jofdm.preamble_phase_slope, 0)(JCFG, jnp.asarray(x)))
    np.testing.assert_allclose(slope, want, atol=1e-7)
    est = tofdm.estimate_drift_ppm(CFG, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(est, np.asarray(_jit(jofdm.estimate_drift_ppm, 0)(JCFG, jnp.asarray(x))), atol=1e-2)
    assert np.all(np.abs(est - ppm) < max(30.0, 0.15 * abs(ppm)))


def test_front_wrap_gate_zeroes_a_wrapped_seed():
    """A preamble of noise alone: the slope's coherence falls below the gate
    in both packages, so both seeds are zero."""
    x = np.random.default_rng(5).standard_normal((4, CFG.preamble_samples)).astype(np.float32)
    got = tofdm.preamble_phase_slope(CFG, torch.from_numpy(x)).numpy()
    assert not got.any()
    np.testing.assert_allclose(got, np.asarray(_jit(jofdm.preamble_phase_slope, 0)(JCFG, jnp.asarray(x))), atol=1e-6)


def _equalizer_inputs(cfg, x, s_data):
    """(z_eq, h_pow, slope0) of the port's front on frames x, as numpy."""
    x = torch.from_numpy(x)
    carriers = tofdm._extract_carriers(cfg, x[..., cfg.preamble_samples :], 1 + s_data)
    z_eq, h_pow = tofdm._equalize(cfg, carriers)
    return z_eq.numpy(), h_pow.numpy(), tofdm.preamble_phase_slope(cfg, x).numpy()


def _assert_llrs_by_gate(got, want, coh, drifted):
    """LLRs within tolerance on every stream whose gate agrees; a stream
    whose LLRs part must be a near-tie of the gate, and no drifted stream
    may part."""
    scale = np.abs(want).max()
    close = np.isclose(got, want, rtol=LLR_RTOL, atol=LLR_RTOL * scale).all(-1)
    parted = ~close
    assert not (parted & drifted).any(), "the gate flipped on a drifted stream"
    assert (np.abs(coh[parted, 0] - coh[parted, 1]) < GATE_EPS).all(), coh[parted]
    return close


LONG_SYMBOLS = 303  # one data symbol past what ofdm_track.cu's staged route holds at 96 carriers
LAST_STAGED = 37  # the longest stream the staged route takes at 96 carriers (kernels._ofdm_track_route)


def _long_points(cfg, s_data):
    """(z_eq complex64 [3, S, C], h_pow [3, C], slope0 [3], ppms [3]) of
    three QPSK streams of S data symbols as the equalizer sees them: points
    rotated by the drift phase c (s + 1) m of +150, 0 and -150 ppm, noise
    at 16 dB, channel powers in [0.5, 1.5], slope0 within 5% of c. The
    points themselves: a frame of S = 303 symbols is some 3,600 bytes,
    whose band-limited resampling would take this test minutes."""
    rng = np.random.default_rng(303)
    c_n = cfg.n_carriers
    ppms = np.array((150.0, 0.0, -150.0))
    d = (rng.choice((-1.0, 1.0), (3, s_data, c_n)) + 1j * rng.choice((-1.0, 1.0), (3, s_data, c_n))) * QPSK_AMP
    slope = ppms * 2 * np.pi * 1e-6 * cfg.symbol_samples / cfg.n_fft
    ang = slope[:, None, None] * np.arange(1, s_data + 1)[None, :, None] * (cfg.first_carrier + np.arange(c_n))
    sigma = 10 ** (-16.0 / 20) / np.sqrt(2)
    z = d * np.exp(1j * ang) + sigma * (rng.standard_normal(d.shape) + 1j * rng.standard_normal(d.shape))
    h = rng.uniform(0.5, 1.5, (3, c_n))
    return (z.astype(np.complex64), h.astype(np.float32),
            (slope * rng.uniform(0.95, 1.05, 3)).astype(np.float32), ppms)


@pytest.mark.parametrize("case", [*CASES, "qpsk-s303"])
def test_track_decide_ref_matches_pallas(case):
    """ofdm_track_decide_fused_ref against the Pallas kernel in interpret
    mode on the same z_eq / h_pow / slope0 (drifted frames at +-150 ppm and
    a clean-clock one), with the EVM over all and over the first 3 symbols.
    "qpsk-s303": three streams of 303 data symbols (_long_points), past the
    staged route's shared memory on the card."""
    if case == "qpsk-s303":
        cfg, jcfg = _pair()
        s_data = LONG_SYMBOLS
        z_eq, h_pow, slope0, ppms = _long_points(cfg, s_data)
        assert tk._ofdm_track_route(s_data, cfg.n_carriers) == "block"
    else:
        cfg, jcfg, _, ppms, x = _case_frames(case)
        s_data = cfg.data_symbols_for_payload(128)
        z_eq, h_pow, slope0 = _equalizer_inputs(cfg, x, s_data)
    for evm_symbols in (None, 3):
        llrs, evm2, coh = tk.ofdm_track_decide_fused_ref(
            cfg, torch.from_numpy(z_eq), torch.from_numpy(h_pow), torch.from_numpy(slope0),
            evm_symbols=evm_symbols, with_coherence=True,
        )
        want_llrs, want_evm2 = jkernels.ofdm_track_decide_fused(
            jcfg, jnp.asarray(z_eq), jnp.asarray(h_pow), jnp.asarray(slope0),
            evm_symbols=evm_symbols, interpret=True,
        )
        assert llrs.shape == (3, s_data * cfg.bits_per_symbol)
        close = _assert_llrs_by_gate(llrs.numpy(), np.asarray(want_llrs), coh.numpy(), np.abs(ppms) >= 100)
        np.testing.assert_allclose(evm2.numpy()[close], np.asarray(want_evm2)[close], rtol=1e-4)
        if not cfg.clock_tracking:
            assert not coh.any()


@pytest.mark.parametrize("s_data", [12, 29, LAST_STAGED, LAST_STAGED + 1, 302, 303])
def test_track_route_from_the_shapes(monkeypatch, s_data):
    """ofdm_track_decide_fused's route from S and C alone, before the
    launch, by the staged route's warps an SM, the same in both layouts: at
    96 carriers the staged route keeps OFDM_STAGED_MIN_WARPS (8) or more up
    to S = LAST_STAGED (a 256-byte ofdm-fast frame's 12 and a 1,024-byte
    ofdm-max frame's 29 among them) and takes the stream there; past it the
    block route takes it, as at 302 (the longest stream the staged route
    could hold, 232,320 bytes of points and weights) and 303 (past the
    232,448 bytes a block can hold). The launch code, the card's calls
    replaced by recorders, passes the route as the C entry it calls in
    either layout (ofdm_track or ofdm_track_block, one library, one
    signature), the strides as they are, and counts the block route under
    its own key."""
    from anet_torch.kernels import build

    cfg = CFG
    c_n = cfg.n_carriers
    assert tk._ofdm_staged_warps(303, c_n) == 0 and tk._ofdm_staged_warps(302, c_n) == 1
    assert tk._ofdm_track_route(s_data, 1) == "staged"
    assert build.SIGNATURES["ofdm_track_block"][1] == build.SIGNATURES["ofdm_track"][1]
    assert build.SIGNATURES["ofdm_track_block"][2] == "ofdm_track"
    want = "staged" if s_data <= LAST_STAGED else "block"
    assert tk._ofdm_track_route(s_data, c_n) == want
    assert (tk._ofdm_staged_warps(s_data, c_n) >= tk.OFDM_STAGED_MIN_WARPS) == (want == "staged")
    z = torch.zeros(2, s_data, c_n, dtype=torch.complex64)
    for time_major in (False, True):
        calls = []
        monkeypatch.setattr(tk, "_entry", lambda key: lambda *args: calls.append((key, args)) or 0)
        monkeypatch.setattr(tk, "_stream_handle", lambda dev: 0)
        monkeypatch.setattr(tk, "launch_counts", dict.fromkeys(tk.launch_counts, 0))
        zl = z.permute(1, 2, 0).contiguous().permute(2, 0, 1) if time_major else z
        llrs, evm2 = tk._ofdm_track_launch(cfg, zl, torch.ones(2, c_n), torch.zeros(2), None, False)
        ((key, args),) = calls
        assert key == ("ofdm_track" if want == "staged" else "ofdm_track_block")
        assert args[1:4] == ((1, 2 * c_n, 2) if time_major else (s_data * c_n, c_n, 1))
        assert args[8:11] == (2, s_data, c_n) and args[15] == llrs.data_ptr()
        key = "ofdm_track_decide_fused" + (":block" if want == "block" else "")
        assert {k: v for k, v in tk.launch_counts.items() if v} == {key: 1}


def test_phase_track_matches_jax():
    """The plain fit (_phase_track) against the reference's jnp tracker: the
    phasors agree on every stream whose gate agrees."""
    cfg, jcfg = CFG, JCFG
    pays = np.random.default_rng(3).integers(0, 256, (4, 128), np.uint8)
    ppms = np.array((120, -150, 0, 0))
    x = _drifted(jcfg, pays, ppms, 14.0, seed=4, length=cfg.frame_num_samples(128))
    z_eq, h_pow, slope0 = _equalizer_inputs(cfg, x, cfg.data_symbols_for_payload(128))
    rot, coh = tofdm._phase_track(
        cfg, torch.from_numpy(z_eq), torch.from_numpy(h_pow)[:, None, :], torch.from_numpy(slope0),
        with_coherence=True,
    )
    want = np.asarray(
        _jit(jofdm._phase_track, 0)(jcfg, jnp.asarray(z_eq), jnp.asarray(h_pow)[:, None, :], jnp.asarray(slope0))
    )
    got = rot.numpy()
    same = np.isclose(got, want, atol=1e-4).all((-2, -1))
    assert same[np.abs(ppms) >= 100].all()
    assert (np.abs(coh.numpy()[~same, 0] - coh.numpy()[~same, 1]) < GATE_EPS).all()


@pytest.mark.parametrize("case", list(CASES))
def test_demodulate_frame_matches_both_jax_routes(case, monkeypatch):
    """The port's receiver (always the kernel's route; its plain version
    here) against the reference's default jnp tracker and against its fused
    route with the Pallas kernel in interpret mode."""
    cfg, jcfg, pays, _, x = _case_frames(case)
    got = tofdm.demodulate_frame(cfg, x, 128, device="cpu")
    assert got.ok.all()
    np.testing.assert_array_equal(got.payload.numpy(), pays)
    _assert_frames(got, _jit(jofdm.demodulate_frame, 0, 2)(jcfg, jnp.asarray(x), 128))
    monkeypatch.setattr(jofdm, "_use_fused_track", lambda: True)
    monkeypatch.setattr(
        jkernels, "ofdm_track_decide_fused", functools.partial(jkernels.ofdm_track_decide_fused, interpret=True)
    )
    fused = jax.jit(lambda x: jofdm.demodulate_frame(jcfg, x, 128))  # traced anew, under the patch
    _assert_frames(got, fused(jnp.asarray(x)))


def test_demodulate_frame_dynamic_matches_jax():
    """Header-declared length and the overhead-span EVM."""
    rng = np.random.default_rng(33)
    pays = rng.integers(0, 256, (2, 64), np.uint8)
    w = np.asarray(_jit(jofdm.transmit, 0)(JCFG, jnp.asarray(pays)))
    cap = np.zeros((2, CFG.frame_num_samples(200)), np.float32)
    cap[:, : w.shape[-1]] = w
    x = np.array(_jit(awgn)(jax.random.PRNGKey(11), jnp.asarray(cap), 18.0))
    got = tofdm.demodulate_frame_dynamic(CFG, x, 200, device="cpu")
    want = _jit(jofdm.demodulate_frame_dynamic, 0, 2)(JCFG, jnp.asarray(x), 200)
    assert got.ok.all() and got.payload_len.tolist() == [64, 64]
    np.testing.assert_array_equal(got.payload_len.numpy(), np.asarray(want.payload_len))
    _assert_frames(got, want)
    coded = get_model("ofdm-coded").config
    with pytest.raises(ValueError, match="fec='none'"):
        tofdm.demodulate_frame_dynamic(coded, np.zeros((1, coded.frame_num_samples(200)), np.float32), 200,
                                       device="cpu")


@pytest.mark.parametrize("case", ["qpsk", "qpsk-untracked", "qam64-coded"])
def test_demodulate_frame_tm_matches_batch_major_and_jax(case):
    """The time-major twin: the same frames [T, B] decode as the batch-major
    receiver does (its kernel reads the [S, C, B] carriers by strides), and
    as the reference's time-major receiver."""
    cfg, jcfg, pays, _, x = _case_frames(case)
    x_tm = np.ascontiguousarray(x.T)
    got = tofdm.demodulate_frame_tm(cfg, x_tm, 128, device="cpu")
    bm = tofdm.demodulate_frame(cfg, x, 128, device="cpu")
    assert got.ok.all()
    np.testing.assert_array_equal(got.payload.numpy(), pays)
    np.testing.assert_array_equal(got.payload.numpy(), bm.payload.numpy())
    np.testing.assert_allclose(got.confidence.numpy(), bm.confidence.numpy(), rtol=1e-4)
    _assert_frames(got, _jit(jofdm.demodulate_frame_tm, 0, 2)(jcfg, jnp.asarray(x_tm), 128))


def test_receive_frame_with_offset_and_noise_matches_jax():
    rng = np.random.default_rng(8)
    pays = rng.integers(0, 256, (3, 100), np.uint8)
    w = np.asarray(_jit(jofdm.transmit, 0)(JCFG, jnp.asarray(pays)))
    offsets = np.array([0, 777, 1501])
    cap = np.zeros((3, w.shape[-1] + 1600), np.float32)
    for i, o in enumerate(offsets):
        cap[i, o : o + w.shape[-1]] = w[i]
    x = np.array(_jit(awgn)(jax.random.PRNGKey(6), jnp.asarray(cap), 16.0))
    got = tofdm.receive_frame(CFG, x, 100, device="cpu")
    want = _jit(jofdm.receive_frame, 0, 2)(JCFG, jnp.asarray(x), 100)
    np.testing.assert_array_equal(got.offset.numpy(), offsets)
    np.testing.assert_array_equal(got.offset.numpy(), np.asarray(want.offset))
    np.testing.assert_allclose(got.quality.numpy(), np.asarray(want.quality), rtol=1e-4)
    _assert_frames(got.frame, want.frame)
    with pytest.raises(ValueError, match="cannot hold"):
        tofdm.receive_frame(CFG, x[:, :1000], 100, device="cpu")


def test_tracking_never_corrupts_clean_clock_low_snr():
    """The reference's regression (tests/test_ofdm.py:345) on the port: at
    4-8 dB on the reference's channel, every clean-clock ofdm-coded frame
    that decodes with tracking off decodes with it on."""
    cfg, jcfg = get_model("ofdm-coded").config, jget_model("ofdm-coded").config
    cfg_off = dataclasses.replace(cfg, clock_tracking=False)
    pays = np.random.default_rng(3).integers(0, 256, (24, 64), np.uint8)
    w = _jit(jofdm.transmit, 0)(jcfg, jnp.asarray(pays))
    channel = jax.jit(lambda w, snr: apply_channel(jax.random.PRNGKey(7), w, ChannelConfig(), snr_db=snr))
    for snr in (4.0, 6.0, 8.0):
        dirty = np.array(channel(w, jnp.full((), snr)))
        ok_off = tofdm.demodulate_frame(cfg_off, dirty, 64, device="cpu").ok.numpy()
        ok_on = tofdm.demodulate_frame(cfg, dirty, 64, device="cpu").ok.numpy()
        assert ok_off.all(), f"setup: untracked should be clean at {snr} dB"
        assert ok_on.all(), f"tracking corrupted {int((~ok_on).sum())} clean-clock frames at {snr} dB"


def test_family_dispatch():
    pays = np.random.default_rng(2).integers(0, 256, (2, 30), np.uint8)
    w = tfamily.transmit_fn(CFG, device="cpu")(pays)
    np.testing.assert_array_equal(w.numpy(), tofdm.transmit(CFG, pays, device="cpu").numpy())
    t, tpl, demod = tfamily.geometry(CFG, 30, device="cpu")
    assert t == jfamily.frame_samples(JCFG, 30) == w.shape[-1]
    np.testing.assert_allclose(tpl.numpy(), np.asarray(jfamily.preamble_template(JCFG)), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(demod(w).payload.numpy(), pays)
    dyn = tfamily.aligned_demod_dynamic_fn(CFG, 64, device="cpu")(
        np.pad(w.numpy(), ((0, 0), (0, CFG.frame_num_samples(64) - t)))
    )
    assert dyn.ok.all() and dyn.payload_len.tolist() == [30, 30]
    assert tfamily.is_ofdm(CFG) and not tfamily.is_ofdm(get_model("mfsk16-fast").config)
    with pytest.raises(NotImplementedError, match="OFDM"):
        tfamily.is_ofdm(object())
