"""The one-shot receivers, anet_torch against the JAX package on the CPU:
locate_preamble, aligned_gather in its four modes, receive_frame,
receive_frame_dynamic and loopback on captures whose frame starts at an
unknown sample. Offsets, payloads, declared lengths and verdicts bit-equal;
quality, frac, confidence and snr_db within the stated tolerances, quality
also against a float64 numpy computation (a float32 prefix sum over tens of
thousands of squared samples loses digits)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anet.dsp import pipeline as jpipeline
from anet.dsp import sync as jsync
from anet.models import get_model as jget_model

from anet_torch.dsp import pipeline as tpipeline
from anet_torch.dsp import sync as tsync
from anet_torch.dsp.frame import frame_num_samples
from anet_torch.models import get_model

NAME = "mfsk16-fast"
CFG, JCFG = get_model(NAME).config, jget_model(NAME).config
DCODED = "mfsk4-coded-stream"
DCFG, JDCFG = get_model(DCODED).config, jget_model(DCODED).config
PAY, MAX = 40, 48
VERDICTS = ("magic_ok", "length_ok", "header_crc_ok", "payload_crc_ok", "ok")


def _captures(cfg, lens, starts, total, noise, seed):
    """(payloads, [B, total] captures): frame i of payload length lens[i]
    planted at starts[i], noise everywhere. The waveforms are the port's,
    which test_torch_frame.py holds equal to the JAX package's."""
    rng = np.random.default_rng(seed)
    pays = [rng.integers(0, 256, n, dtype=np.uint8) for n in lens]
    cap = noise * rng.standard_normal((len(lens), total)).astype(np.float32)
    for i, (p, s) in enumerate(zip(pays, starts)):
        w = tpipeline.transmit(cfg, p, device="cpu").numpy()
        cap[i, s : s + len(w)] += w
    return pays, cap


def _jit(fn, *static, **kw):
    """The JAX function with its config and lengths closed over, jitted: one
    compile instead of an eager dispatch per operation."""
    return jax.jit(lambda x: fn(*static[:1], x, *static[1:], **kw))


def _quality_f64(cap, tpl, offsets):
    """|corr| / sqrt(te * max(window energy, 1e-4 te)) at the given lags, in
    float64."""
    cap, tpl = cap.astype(np.float64), np.asarray(tpl, np.float64)
    k, te = len(tpl), float((np.asarray(tpl, np.float64) ** 2).sum())
    out = []
    for row, o in zip(cap, offsets):
        win = row[o : o + k]
        out.append(abs(win @ tpl) / np.sqrt(te * max(float(win @ win), 1e-4 * te)))
    return np.array(out)


STARTS = (0, 1, 127, 128, 777, 1999)


@pytest.mark.parametrize("method", ["auto", "matmul"])
def test_locate_preamble_matches_jax(method):
    """Offsets equal the planted starts and JAX's; quality rtol 1e-4 against
    JAX (whose "auto" is an FFT correlation on the CPU, the port's the
    product) and against float64; frac within 1e-4 absolute (a quotient of
    small differences of the float32 correlation)."""
    total = frame_num_samples(CFG, PAY) + 2100
    _, cap = _captures(CFG, (PAY,) * len(STARTS), STARTS, total, 0.2, 1)
    got = tsync.locate_preamble(CFG, torch.from_numpy(cap), method=method)
    want = _jit(jsync.locate_preamble, JCFG, method=method)(jnp.asarray(cap))
    assert isinstance(got, tsync.SyncResult) and got._fields == want._fields
    assert got.offset.dtype == torch.int32
    np.testing.assert_array_equal(got.offset.numpy(), STARTS)
    np.testing.assert_array_equal(got.offset.numpy(), np.asarray(want.offset))
    np.testing.assert_allclose(got.quality.numpy(), np.asarray(want.quality), rtol=1e-4)
    q64 = _quality_f64(cap, np.asarray(jsync.preamble_waveform(JCFG)), STARTS)
    np.testing.assert_allclose(got.quality.numpy(), q64, rtol=1e-4)
    np.testing.assert_allclose(got.frac.numpy(), np.asarray(want.frac), atol=1e-4)
    assert float(got.frac.abs().max()) <= 0.5 and float(got.quality.min()) > 0.9


def test_sync_energy_functions_match_jax_and_float64():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 40000)).astype(np.float32)
    k = 2048
    got = tsync.sliding_window_energy(torch.from_numpy(x), k)
    want = jsync.sliding_window_energy(jnp.asarray(x), k)
    assert got.shape == (3, 40000 - k + 1) and got.dtype == torch.float32
    c64 = np.concatenate([np.zeros((3, 1)), np.cumsum(x.astype(np.float64) ** 2, -1)], -1)
    e64 = c64[:, k:] - c64[:, :-k]
    # a float32 prefix sum reaching 4e4 carries ~4e-3 of absolute error into
    # each window energy of ~2e3: rtol 1e-4 of the energy with that floor
    np.testing.assert_allclose(got.numpy(), e64, rtol=1e-4, atol=0.05)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=0.05)
    off = np.array([0, 17, 40000 - k], np.int32)
    loc = tsync._local_energy(torch.from_numpy(x), k, torch.from_numpy(off))
    np.testing.assert_allclose(loc.numpy(), e64[np.arange(3), off], rtol=1e-4)
    np.testing.assert_allclose(
        loc.numpy(), np.asarray(jsync._local_energy(jnp.asarray(x), k, jnp.asarray(off))), rtol=1e-4
    )
    corr = rng.standard_normal((3, 50)).astype(np.float32) * 100
    energy = np.abs(rng.standard_normal((3, 50))).astype(np.float32) * 1000
    energy[0, :5] = 0.0  # the -40 dB floor
    q = tsync.normalized_match_quality(torch.from_numpy(corr), torch.from_numpy(energy), 1024.0)
    jq = jsync.normalized_match_quality(jnp.asarray(corr), jnp.asarray(energy), jnp.float32(1024.0))
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["auto", "dma", "onehot", "roll"])
def test_aligned_gather_modes_match_jax(mode, dtype):
    """out[b, i] = buffer[b, start[b] + i] bit-equal to JAX in every mode
    (roll: the Pallas kernel in interpret mode), starts on both sides of
    the 128-sample rows and the last one that fits."""
    tdt, jdt = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    rng = np.random.default_rng(3)
    length, size = 2000, 700
    buf = rng.standard_normal((8, length)).astype(np.float32)
    starts = np.array([0, 1, 127, 128, 129, 640, 1000, length - size], np.int32)
    bt = torch.from_numpy(buf).to(tdt)
    got = tsync.aligned_gather(bt, torch.from_numpy(starts), size, mode=mode)
    if mode == "roll":
        from anet.kernels import gather_rows_fused

        want = gather_rows_fused(jnp.asarray(buf).astype(jdt), jnp.asarray(starts), size, interpret=True)
    else:
        want = jsync.aligned_gather(jnp.asarray(buf).astype(jdt), jnp.asarray(starts), size, mode=mode)
    assert got.dtype == tdt and got.shape == (8, size)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    rows = np.stack([bt.float().numpy()[i, s : s + size] for i, s in enumerate(starts)])
    np.testing.assert_array_equal(got.float().numpy(), rows)


def test_aligned_gather_compute_dtype_scalar_start_and_bad_mode():
    rng = np.random.default_rng(4)
    buf = rng.standard_normal((3, 900)).astype(np.float32)
    starts = np.array([5, 130, 400], np.int32)
    got = tsync.aligned_gather(torch.from_numpy(buf), torch.from_numpy(starts), 256, torch.bfloat16)
    want = jsync.aligned_gather(jnp.asarray(buf), jnp.asarray(starts), 256, jnp.bfloat16, mode="dma")
    assert got.dtype == torch.float32  # bf16-rounded samples in the buffer's dtype
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    one = tsync.aligned_gather(torch.from_numpy(buf), torch.tensor(7), 100)
    np.testing.assert_array_equal(one.numpy(), buf[:, 7:107])
    for gather, arr, st in ((tsync.aligned_gather, torch.from_numpy(buf), torch.from_numpy(starts)),
                            (jsync.aligned_gather, jnp.asarray(buf), jnp.asarray(starts))):
        with pytest.raises(ValueError, match="auto/dma/onehot/roll"):
            gather(arr, st, 10, mode="lanes")
    with pytest.raises(ValueError, match="method must be fft, matmul, direct or auto"):
        tsync.correlate_template(torch.zeros(1, 100), torch.zeros(10), method="lanes")


@pytest.mark.parametrize("noise", [0.0, 0.3])
def test_receive_frame_matches_jax(noise):
    total = frame_num_samples(CFG, PAY) + 2100
    pays, cap = _captures(CFG, (PAY,) * len(STARTS), STARTS, total, noise, 5)
    got = tpipeline.receive_frame(CFG, cap, PAY, device="cpu")
    want = _jit(jpipeline.receive_frame, JCFG, PAY)(jnp.asarray(cap))
    assert isinstance(got, tpipeline.ReceiveResult)
    np.testing.assert_array_equal(got.sync.offset.numpy(), STARTS)
    np.testing.assert_array_equal(got.sync.offset.numpy(), np.asarray(want.sync.offset))
    np.testing.assert_array_equal(got.frame.payload.numpy(), np.stack(pays))
    np.testing.assert_array_equal(got.frame.payload.numpy(), np.asarray(want.frame.payload))
    for v in VERDICTS:
        np.testing.assert_array_equal(getattr(got.frame, v).numpy(), np.asarray(getattr(want.frame, v)), v)
    assert bool(got.frame.ok.all())
    np.testing.assert_allclose(got.sync.quality.numpy(), np.asarray(want.sync.quality), rtol=1e-4)
    np.testing.assert_allclose(got.frame.confidence.numpy(), np.asarray(want.frame.confidence), rtol=1e-4)
    if noise:
        np.testing.assert_allclose(got.frame.snr_db.numpy(), np.asarray(want.frame.snr_db), rtol=1e-4)
    with pytest.raises(ValueError, match="cannot hold"):
        tpipeline.receive_frame(CFG, cap[:, :1000], PAY, device="cpu")


@pytest.mark.parametrize("model", [NAME, DCODED])
def test_receive_frame_dynamic_matches_jax(model):
    """Frames of payload 0, 1, 17, 48 and 30 at unknown starts, lengths read
    from the headers; uncoded and coded (header probe + masked trellis).
    quality also against float64 at the located lag."""
    cfg, jcfg = get_model(model).config, jget_model(model).config
    lens, starts = (0, 1, 17, MAX, 30), (3, 128, 500, 1999, 1000)
    total = frame_num_samples(cfg, MAX) + 2100
    pays, cap = _captures(cfg, lens, starts, total, 0.3, 6)
    got = tpipeline.receive_frame_dynamic(cfg, cap, MAX, device="cpu")
    want = _jit(jpipeline.receive_frame_dynamic, jcfg, MAX)(jnp.asarray(cap))
    assert isinstance(got, tpipeline.DynamicReceiveResult) and got.offset.dtype == torch.int32
    np.testing.assert_array_equal(got.offset.numpy(), starts)
    np.testing.assert_array_equal(got.offset.numpy(), np.asarray(want.offset))
    np.testing.assert_array_equal(got.frame.payload_len.numpy(), lens)
    for f in ("payload", "payload_len") + VERDICTS:
        np.testing.assert_array_equal(getattr(got.frame, f).numpy(), np.asarray(getattr(want.frame, f)), f)
    assert bool(got.frame.ok.all())
    for i, p in enumerate(pays):
        np.testing.assert_array_equal(got.frame.payload.numpy()[i, : len(p)], p)
    np.testing.assert_allclose(got.quality.numpy(), np.asarray(want.quality), rtol=1e-4)
    q64 = _quality_f64(cap, np.asarray(jsync.preamble_waveform(jcfg)), starts)
    np.testing.assert_allclose(got.quality.numpy(), q64, rtol=1e-4)
    np.testing.assert_allclose(got.frame.confidence.numpy(), np.asarray(want.frame.confidence), rtol=1e-4)
    np.testing.assert_allclose(got.frame.snr_db.numpy(), np.asarray(want.frame.snr_db), rtol=1e-4)


def test_receive_frame_dynamic_refusals():
    from anet_torch.dsp.family import aligned_demod_dynamic_fn

    with pytest.raises(ValueError, match="cannot hold"):
        tpipeline.receive_frame_dynamic(CFG, np.zeros((1, 500), np.float32), MAX, device="cpu")
    coded = get_model("mfsk4-coded").config  # depth-24 interleaver
    cap = np.zeros((1, frame_num_samples(coded, MAX) + 100), np.float32)
    with pytest.raises(ValueError, match="fec_interleave == 1"):
        tpipeline.receive_frame_dynamic(coded, cap, MAX, device="cpu")
    with pytest.raises(ValueError, match="cannot hold"):  # the tracked receiver's own refusal
        tpipeline.receive_frame_tracked(CFG, np.zeros((1, 500), np.float32), MAX, device="cpu")
    with pytest.raises(NotImplementedError, match="OFDM"):
        aligned_demod_dynamic_fn(object(), MAX)


def test_loopback_matches_jax():
    rng = np.random.default_rng(7)
    pay = rng.integers(0, 256, (2, 24), dtype=np.uint8)
    got = tpipeline.loopback(CFG, pay, pad_before=321, pad_after=100, device="cpu")
    want = _jit(jpipeline.loopback, JCFG, pad_before=321, pad_after=100)(jnp.asarray(pay))
    np.testing.assert_array_equal(got.sync.offset.numpy(), [321, 321])
    np.testing.assert_array_equal(got.sync.offset.numpy(), np.asarray(want.sync.offset))
    np.testing.assert_array_equal(got.frame.payload.numpy(), pay)
    assert bool(got.frame.ok.all()) and bool(np.asarray(want.frame.ok).all())
