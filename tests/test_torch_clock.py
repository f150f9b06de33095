"""The symbol-clock tracker, anet_torch against the JAX package on the CPU.

Captures are made with numpy from a seed, drifted with the reference's
``anet.channel.sample_rate_drift`` and handed to both packages as numpy, on
the small 4-FSK config of test_clock.py (sps 32) at 0, +-400 and 1000 ppm.

Tolerances: symbols, payloads and every verdict equal. The tracker's
state is a float32 position fed back through its own energies, so the
packages' float32 products (the same terms summed in another order) part
by a few ulp a step: energies within rtol 1e-4 in float32; in bf16 a ulp of
position can flip one window sample's bf16 rounding, a few 1e-5 of an
energy, so rtol 1e-3 there. Timing within 1e-3 samples over a frame of
several hundred steps; the early/late error (a ratio in [-1, 1]) within
1e-4 absolute (1e-3 in bf16); the drift estimate, a slope of those timings,
within 0.05 ppm and the RMS timing error within 1e-5. The one-shot receiver
locates the preamble with ``sync_method="matmul"`` in both packages, so
both start the tracker from the same sub-sample position (frac within
1e-4, as test_torch_pipeline.py holds it). The single-stream test runs its
reference op by op, as a caller of
``anet.dsp.pipeline.receive_frame_tracked`` does: under ``jax.jit`` XLA
fuses the lerp and the loop updates, and the last positions of its
payload-384 frame (near 5e4 samples, where a float32 ulp is 0.004) part by
a few ulp. The shorter runs (payload 128, 120 symbols, the streams) compare
with the jitted reference within the tolerances above."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anet import stream as jstream
from anet.channel import sample_rate_drift
from anet.dsp import ModemConfig as JModemConfig
from anet.dsp import clock as jclock
from anet.dsp import pipeline as jpipeline
from anet.dsp.mod import modulate_symbols as jmodulate_symbols
from anet.dsp.ofdm import OfdmConfig as JOfdmConfig

import anet_torch.stream as tstream
from anet_torch.dsp import clock as tclock
from anet_torch.dsp import pipeline as tpipeline
from anet_torch.dsp.ofdm import OfdmConfig
from anet_torch.dsp.params import ModemConfig

JCFG = JModemConfig(symbol_rate_hz=1500, num_tones=4, preamble_symbols=16)
CFG = ModemConfig.from_json(JCFG.to_json())
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
E_RTOL = {"float32": 1e-4, "bfloat16": 1e-3}
ERR_ATOL = {"float32": 1e-4, "bfloat16": 1e-3}
T_ATOL = 1e-3


def _jit(fn, *static, **kw):
    """The reference's ``fn`` with its leading and keyword arguments bound,
    jitted: one compile instead of one per primitive."""
    return jax.jit(functools.partial(fn, *static, **kw))


def _noise(rng, x, snr_db):
    """x plus white noise at ``snr_db`` against x's mean power (numpy)."""
    sigma = np.sqrt(np.mean(x * x) * 10 ** (-snr_db / 10))
    return (x + sigma * rng.standard_normal(x.shape)).astype(np.float32)


def _drift(x, ppm):
    return np.asarray(sample_rate_drift(jnp.asarray(x), ppm), np.float32)


def _capture(payload_len, ppm, seed, snr_db=15.0):
    """(payload, drifted capture [N]): 300 zeros, the frame, 2,500 zeros."""
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 256, payload_len, np.uint8)
    wave = np.asarray(jpipeline.transmit(JCFG, jnp.asarray(payload)), np.float32)
    cap = np.concatenate([np.zeros(300, np.float32), wave, np.zeros(2500, np.float32)])
    return payload, _noise(rng, _drift(cap, ppm), snr_db)


def _assert_tracked(got: tclock.TrackedDemodResult, want, dtype: str):
    np.testing.assert_array_equal(got.symbols.numpy(), np.asarray(want.symbols))
    np.testing.assert_allclose(got.energies.numpy(), np.asarray(want.energies), rtol=E_RTOL[dtype], atol=1e-6)
    np.testing.assert_allclose(got.timing.numpy(), np.asarray(want.timing), rtol=0, atol=T_ATOL)
    np.testing.assert_allclose(
        got.timing_error.numpy(), np.asarray(want.timing_error), rtol=0, atol=ERR_ATOL[dtype]
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_window_matches_jax(dtype):
    """Fractional windows at positions inside, below 0 and past the end
    (clipped to [0, N - 2]) equal the reference's lerp."""
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 300)).astype(np.float32)
    x = np.asarray(jnp.asarray(x).astype(jdt).astype(jnp.float32))
    pos = np.array([[0.25, -3.5, 17.0, 299.9], [150.75, 268.5, 1.0, 280.125]], np.float32)
    got = tclock._gather_window(torch.from_numpy(x).to(tdt), torch.from_numpy(pos), 32)
    want = [
        np.asarray(jclock._gather_window(jnp.asarray(x[b]).astype(jdt), jnp.asarray(pos[b, j]), 32))
        for b in range(2) for j in range(4)
    ]
    np.testing.assert_array_equal(got.reshape(8, 32).numpy(), np.stack(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ppm", [0.0, 400.0, -400.0, 1000.0])
def test_demodulate_symbols_tracked_matches_jax(ppm, dtype):
    """120 random symbols drifted by ``ppm``, at 20 dB, from a fractional
    start, in a batch of two (the second a clean copy)."""
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(int(ppm) % 997 + 7)
    syms = rng.integers(0, CFG.num_tones, 120)
    wave = np.asarray(jmodulate_symbols(JCFG, jnp.asarray(syms)), np.float32)
    padded = np.concatenate([np.zeros(5, np.float32), wave, np.zeros(96, np.float32)])
    x = np.stack([_noise(rng, _drift(padded, ppm), 20.0), _drift(padded, ppm)])
    start = np.array([5.25, 4.75], np.float32)
    got = tclock.demodulate_symbols_tracked(
        CFG, torch.from_numpy(x), 120, torch.from_numpy(start), compute_dtype=tdt
    )
    want = _jit(jclock.demodulate_symbols_tracked, JCFG, num_symbols=120, compute_dtype=jdt)(
        jnp.asarray(x), start_pos=jnp.asarray(start)
    )
    _assert_tracked(got, want, dtype)
    np.testing.assert_array_equal(got.symbols.numpy(), np.stack([syms, syms]))
    np.testing.assert_allclose(
        tclock.estimate_drift_ppm(CFG, got).numpy(), np.asarray(jclock.estimate_drift_ppm(JCFG, want)),
        rtol=0, atol=0.05,
    )


def test_drift_rows_matches_sample_rate_drift():
    """profile_stream.drift_rows (chip_smoke.py's drift on the card) is the
    reference channel's sample_rate_drift a row at a time, bit for bit, the
    extrapolated tail included."""
    from anet_torch.profile_stream import drift_rows

    rng = np.random.default_rng(9)
    x = rng.standard_normal((5, 3000)).astype(np.float32)
    ppm = np.array([0.0, 700.0, -700.0, 1000.0, -1000.0])
    got = drift_rows(torch.from_numpy(x), torch.from_numpy(ppm), rows=2).numpy()
    want = np.stack([_drift(x[i], float(p)) for i, p in enumerate(ppm)])
    np.testing.assert_array_equal(got, want)


def test_estimate_drift_ppm_matches_jax():
    """The least-squares slope of a given trajectory, batched [2, 3]."""
    rng = np.random.default_rng(5)
    s = 200
    timing = (np.arange(s) * 32 * (1 + rng.uniform(-1e-3, 1e-3, (2, 3, 1))) + rng.normal(0, 0.1, (2, 3, s)))
    timing = timing.astype(np.float32)
    zeros = np.zeros((2, 3, s), np.float32)
    got = tclock.estimate_drift_ppm(
        CFG, tclock.TrackedDemodResult(*(torch.from_numpy(a) for a in (zeros, zeros, timing, zeros)))
    )
    want = jclock.estimate_drift_ppm(
        JCFG, jclock.TrackedDemodResult(*(jnp.asarray(a) for a in (zeros, zeros, timing, zeros)))
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-3)


def _assert_receive(got, want):
    np.testing.assert_array_equal(got.sync.offset.numpy(), np.asarray(want.sync.offset))
    np.testing.assert_allclose(got.sync.frac.numpy(), np.asarray(want.sync.frac), atol=1e-4)
    for f in ("payload", "ok", "magic_ok", "header_crc_ok", "payload_crc_ok"):
        np.testing.assert_array_equal(getattr(got.frame, f).numpy(), np.asarray(getattr(want.frame, f)), f)
    np.testing.assert_allclose(got.frame.confidence.numpy(), np.asarray(want.frame.confidence), rtol=1e-4)
    np.testing.assert_allclose(got.drift_ppm.numpy(), np.asarray(want.drift_ppm), rtol=0, atol=0.05)
    np.testing.assert_allclose(
        got.timing_error_rms.numpy(), np.asarray(want.timing_error_rms), rtol=0, atol=1e-5
    )


@pytest.mark.parametrize("ppm", [0.0, 400.0, -400.0, 1000.0])
def test_receive_frame_tracked_matches_jax(ppm):
    """One stream, payload 384: the tracked receiver equals the reference's
    (payload, verdicts, drift estimate); with drift, the port's block
    receiver loses the frame the tracker keeps, and the estimate has the
    offset's opposite sign within 15% + 30 ppm (test_clock.py's bound)."""
    payload, cap = _capture(384, ppm, seed=int(ppm) % 97)
    got = tpipeline.receive_frame_tracked(CFG, cap, 384, sync_method="matmul", device="cpu")
    want = jpipeline.receive_frame_tracked(JCFG, jnp.asarray(cap), 384, sync_method="matmul")
    assert isinstance(got, tpipeline.TrackedReceiveResult) and got._fields == want._fields
    _assert_receive(got, want)
    assert bool(got.frame.ok)
    np.testing.assert_array_equal(got.frame.payload.numpy(), payload)
    est = float(got.drift_ppm)
    if ppm:
        assert not bool(tpipeline.receive_frame(CFG, cap, 384, device="cpu").frame.ok)
        assert est * ppm < 0 and abs(abs(est) - abs(ppm)) < 0.15 * abs(ppm) + 30
    else:
        assert abs(est) < 50 and float(got.timing_error_rms) < 0.1


def test_receive_frame_tracked_batch_of_three_matches_jax():
    """Three streams at 0, +500 and -500 ppm in one [3, N] batch, bf16
    compute."""
    caps, payloads = [], []
    for seed, ppm in enumerate((0.0, 500.0, -500.0)):
        p, c = _capture(128, ppm, seed)
        payloads.append(p)
        caps.append(c)
    n = min(c.shape[-1] for c in caps)
    batch = np.stack([c[:n] for c in caps])
    got = tpipeline.receive_frame_tracked(
        CFG, batch, 128, sync_method="matmul", compute_dtype=torch.bfloat16, device="cpu"
    )
    want = _jit(
        jpipeline.receive_frame_tracked, JCFG, payload_len=128, sync_method="matmul", compute_dtype=jnp.bfloat16
    )(jnp.asarray(batch))
    _assert_receive(got, want)
    assert bool(got.frame.ok.all())
    np.testing.assert_array_equal(got.frame.payload.numpy(), np.stack(payloads))


STREAM_PAY = 64
STREAM_CHUNK = 1024


def _stream_capture(ppm, seed=0):
    """(payloads, capture [N]): test_clock.py's two frames after gaps of 900
    and 2,400 samples, payload 64, drifted by ``ppm``, at 14 dB."""
    rng = np.random.default_rng(seed)
    payloads = [rng.integers(0, 256, STREAM_PAY, dtype=np.uint8) for _ in range(2)]
    parts = []
    for g, p in zip((900, 2400), payloads):
        parts += [np.zeros(g, np.float32), np.asarray(jpipeline.transmit(JCFG, jnp.asarray(p)), np.float32)]
    cap = np.concatenate(parts + [np.zeros(3000, np.float32)])
    cap = np.concatenate([cap, np.zeros((-len(cap)) % STREAM_CHUNK, np.float32)])
    return payloads, _noise(rng, _drift(cap, ppm), 14.0)


def _assert_stream(got, want, dtype):
    """Detections, verdicts, frame starts and the final carry equal; payloads
    and the header verdicts where a frame was detected (an undetected
    window's bits depend on the last digits of its energies)."""
    det = got.steps.detected.numpy()
    np.testing.assert_array_equal(det, np.asarray(want.steps.detected))
    np.testing.assert_array_equal(got.steps.frame.ok.numpy(), np.asarray(want.steps.frame.ok))
    for f in ("payload", "magic_ok", "header_crc_ok", "payload_crc_ok"):
        np.testing.assert_array_equal(
            getattr(got.steps.frame, f).numpy()[det], np.asarray(getattr(want.steps.frame, f))[det], f
        )
    np.testing.assert_array_equal(got.steps.frame_start.numpy(), np.asarray(want.steps.frame_start))
    np.testing.assert_allclose(
        got.steps.frame.confidence.numpy()[det], np.asarray(want.steps.frame.confidence)[det],
        rtol=E_RTOL[dtype],
    )
    for f in tstream.StreamCarry._fields:
        g, w = getattr(got.carry, f), np.asarray(getattr(want.carry, f))
        np.testing.assert_array_equal(g.float().numpy(), w.astype(np.float32), f)


@pytest.mark.parametrize("ppm,dtype", [(500.0, "float32"), (-500.0, "bfloat16")])
def test_stream_track_matches_jax(ppm, dtype):
    """receive_stream(track=True) as test_clock.py's streaming test builds
    it (payload 64): every frame decodes with its payload, detections,
    verdicts, frame starts and the final carry equal the reference's."""
    tdt, jdt = DTYPES[dtype]
    payloads, cap = _stream_capture(ppm)
    got = tstream.receive_stream(CFG, cap, STREAM_CHUNK, STREAM_PAY, compute_dtype=tdt, track=True, device="cpu")
    want = _jit(
        jstream.receive_stream, JCFG, chunk_size=STREAM_CHUNK, payload_len=STREAM_PAY, compute_dtype=jdt, track=True
    )(jnp.asarray(cap))
    _assert_stream(got, want, dtype)
    assert int(got.carry.frames_ok) == 2
    det = got.steps.detected.numpy()
    np.testing.assert_array_equal(got.steps.frame.payload.numpy()[det], np.stack(payloads))


def test_stream_track_int8_carry_matches_jax():
    """An int8 tracked carry (the capture quantized at the ingest edge, bf16
    compute): the slice widens exactly, so frames equal the reference's."""
    payloads, cap = _stream_capture(-400.0, seed=2)
    carry = tstream.init_carry(CFG, STREAM_CHUNK, STREAM_PAY, track=True, dtype=torch.int8, device="cpu")
    jcarry = jstream.init_carry(JCFG, STREAM_CHUNK, STREAM_PAY, track=True, dtype=jnp.int8)
    got = tstream.receive_stream(
        CFG, cap, STREAM_CHUNK, STREAM_PAY, carry=carry, compute_dtype=torch.bfloat16, track=True, device="cpu"
    )
    want = _jit(
        jstream.receive_stream, JCFG, chunk_size=STREAM_CHUNK, payload_len=STREAM_PAY,
        compute_dtype=jnp.bfloat16, track=True,
    )(jnp.asarray(cap), carry=jcarry)
    _assert_stream(got, want, "bfloat16")
    assert int(got.carry.frames_ok) == 2


def test_tracked_carry_geometry_and_checkpoints_cross_packages():
    """A tracked carry is 2 * sps longer than the live window of an
    untracked one, as the reference builds it, and moves between the
    packages: the first half of a drifted stream in the reference, the rest
    in the port from its checkpoint, ends where the port alone ends."""
    for batch_shape in ((), (2,)):
        got = tstream.init_carry(CFG, STREAM_CHUNK, STREAM_PAY, batch_shape, track=True, device="cpu")
        want = jstream.init_carry(JCFG, STREAM_CHUNK, STREAM_PAY, batch_shape, track=True)
        assert tuple(got.buffer.shape) == want.buffer.shape
        assert tstream._buffer_len(CFG, STREAM_CHUNK, STREAM_PAY, True) == jstream._buffer_len(
            JCFG, STREAM_CHUNK, STREAM_PAY, True
        )
    assert tstream._track_margin(CFG, True) == jstream._track_margin(JCFG, True) == 2 * CFG.samples_per_symbol
    _, cap = _stream_capture(500.0, seed=4)
    half = cap.shape[-1] // STREAM_CHUNK // 2 * STREAM_CHUNK
    first = _jit(jstream.receive_stream, JCFG, chunk_size=STREAM_CHUNK, payload_len=STREAM_PAY, track=True)(
        jnp.asarray(cap[:half])
    )
    fields = {k: np.asarray(v) for k, v in first.carry._asdict().items()}
    carry = tstream.carry_from_numpy(fields, device="cpu")
    back = tstream.carry_to_numpy(carry)
    for k, v in fields.items():
        np.testing.assert_array_equal(back[k], v, k)
    rest = tstream.receive_stream(
        CFG, cap[half:], STREAM_CHUNK, STREAM_PAY, carry=carry, track=True, device="cpu"
    )
    whole = tstream.receive_stream(CFG, cap, STREAM_CHUNK, STREAM_PAY, track=True, device="cpu")
    for f in tstream.StreamCarry._fields:
        assert torch.equal(getattr(rest.carry, f), getattr(whole.carry, f)), f
    assert int(whole.carry.frames_ok) == 2
    # an untracked carry does not take the tracked geometry's live window
    with pytest.raises(ValueError, match="track"):
        tstream.receive_stream(
            CFG, cap[half:], STREAM_CHUNK, STREAM_PAY, track=True, device="cpu",
            carry=tstream.init_carry(CFG, STREAM_CHUNK, STREAM_PAY, track=False, device="cpu")._replace(
                buffer=torch.zeros(STREAM_CHUNK + 64)
            ),
        )


def test_track_refusals_match_jax():
    """lock=True with track=True, and OFDM with track=True, raise
    ValueError in both packages."""
    cap = np.zeros(2 * STREAM_CHUNK, np.float32)
    with pytest.raises(ValueError, match="lock=True does not compose"):
        tstream.receive_stream(CFG, cap, STREAM_CHUNK, STREAM_PAY, track=True, lock=True, device="cpu")
    with pytest.raises(ValueError, match="lock=True does not compose"):
        jstream.receive_stream(JCFG, jnp.asarray(cap), STREAM_CHUNK, STREAM_PAY, track=True, lock=True)
    carry = tstream.init_carry(CFG, STREAM_CHUNK, STREAM_PAY, track=True, device="cpu")
    with pytest.raises(ValueError, match="lock=True does not compose"):
        tstream.stream_step(
            CFG, carry, torch.zeros(STREAM_CHUNK), STREAM_PAY, track=True, lock=True
        )
    ocap = np.zeros(4800 * 2, np.float32)
    with pytest.raises(ValueError, match="MFSK"):
        tstream.receive_stream(OfdmConfig(), ocap, 480, 16, track=True, device="cpu")
    with pytest.raises(ValueError, match="MFSK"):
        jstream.receive_stream(JOfdmConfig(), jnp.asarray(ocap), 480, 16, track=True)
