"""The model helpers, anet_torch.models against anet.models on the CPU:
net_bit_rate_bps and suggest_model over a grid of SNRs and margins (equal),
and classify_capture on one capture of each of four presets (one OFDM, whose
presets share a preamble and need the header check), with and without
``payload_len``: names and order, offsets and header verdicts equal, quality
within 1e-4 (both packages correlate by FFT on the CPU and sum the window
energy as a float32 prefix sum, in another order)."""

import numpy as np
import pytest

from anet import models as jm

from anet_torch import models as tm
from anet_torch.dsp import family as tfamily

PAY = 8
N = 32768  # one length for every capture: fsk2-robust's frame at PAY is 26,624 samples
CLASSIFIED = ("mfsk16-fast", "mfsk4-coded", "fsk2-robust", "ofdm-fast")


def test_net_bit_rate_and_suggest_model_match_jax():
    assert [m.name for m in tm.list_models()] == [m.name for m in jm.list_models()]
    for m, jmodel in zip(tm.list_models(), jm.list_models()):
        assert tm.net_bit_rate_bps(m) == jm.net_bit_rate_bps(jmodel), m.name
    assert tm.OPERATING_SNR_DB == jm.OPERATING_SNR_DB
    for snr in np.arange(-12.0, 30.0, 0.5):
        for margin in (0.0, 1.0, 2.0, 3.5, 6.0):
            got = tm.suggest_model(float(snr), margin)
            assert got.name == jm.suggest_model(float(snr), margin).name, (snr, margin)
            assert isinstance(got, tm.ModemModel)
        assert tm.suggest_model(float(snr)).name == jm.suggest_model(float(snr)).name


def _capture(name, seed):
    """(float32 capture [N], frame start): one PAY-byte frame at a random
    start, white noise 26 dB under an MFSK tone (0.05; 0.01 for OFDM, whose
    rms is a quarter of its amplitude)."""
    cfg = tm.get_model(name).config
    rng = np.random.default_rng(seed)
    pay = rng.integers(0, 256, (1, PAY), dtype=np.uint8)
    w = tfamily.transmit_fn(cfg, device="cpu")(pay).numpy()[0]
    off = int(rng.integers(100, 2000))
    cap = np.zeros(N, np.float32)
    cap[off : off + w.shape[0]] = w
    noise = 0.01 if tfamily.is_ofdm(cfg) else 0.05
    return cap + noise * rng.standard_normal(N).astype(np.float32), off


@pytest.mark.parametrize("name", CLASSIFIED)
def test_classify_capture_matches_jax(name):
    cap, off = _capture(name, len(name))
    for payload_len in (PAY, None):
        got = tm.classify_capture(cap, payload_len=payload_len, device="cpu")
        want = jm.classify_capture(cap, payload_len=payload_len)
        assert all(isinstance(c, tm.Classification) for c in got)
        assert [(c.name, c.offset, c.header_ok) for c in got] == [
            (c.name, c.offset, c.header_ok) for c in want
        ], payload_len
        np.testing.assert_allclose([c.quality for c in got], [c.quality for c in want], atol=1e-4)
        assert got[0].offset == off
        if payload_len is not None:  # every leader checked: the sent preset is named first
            assert got[0].name == name and got[0].header_ok is True


def test_classify_capture_candidates_and_short_capture():
    cap, off = _capture("mfsk16-fast", 3)
    got = tm.classify_capture(cap, candidates=["mfsk8-audible", "mfsk16-fast"], payload_len=PAY, device="cpu")
    want = jm.classify_capture(cap, candidates=["mfsk8-audible", "mfsk16-fast"], payload_len=PAY)
    assert [(c.name, c.offset, c.header_ok) for c in got] == [(c.name, c.offset, c.header_ok) for c in want]
    assert [c.name for c in got][0] == "mfsk16-fast"
    assert tm.classify_capture(cap[:100], device="cpu") == jm.classify_capture(cap[:100]) == []
