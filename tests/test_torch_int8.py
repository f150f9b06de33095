"""int8 quantized ingest in anet_torch against the JAX package on the CPU:
quantize_int8, the int8 plain versions of decide_frame_tm, demod_at_fused,
demod_at_energies_fused and demod_probe_fused against the Pallas kernels'
int8 path in interpret mode, receive_stream on an int8 carry (search and
frame lock, through the card's kernels' plain versions) against anet under
the interpret fixture, the int8 aligned receiver demodulate_frame_tm, and
int8 checkpoints moving both ways.

Tolerances: tones, servo offsets, words, CRC counts and payloads exact (the
I/Q sums are exact integers in both packages); cmax rtol 1e-6 (one float32
rounding of an exact integer sum, times the same scale); energies and their
sums rtol 1e-5 (I*I + Q*Q may be fused into one rounding by XLA, and sums
over tones and symbols run in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import anet.kernels as jk
from anet import stream as jstream
from anet.dsp import family as jfamily
from anet.dsp import frame as jframe
from anet.dsp.sync import preamble_waveform as j_preamble
from anet.models import get_model as jget_model

from anet_torch import kernels as tk
from anet_torch import stream as tstream
from anet_torch.dsp import frame as tframe
from anet_torch.dsp.frame import data_symbols_for_payload
from anet_torch.dsp.pipeline import transmit
from anet_torch.models import get_model

NAME = "mfsk16-fast"
CFG, JCFG = get_model(NAME).config, jget_model(NAME).config
CODED = "mfsk4-coded"
CCFG, JCCFG = get_model(CODED).config, jget_model(CODED).config
PAY = 64
CHUNK = 4096
RTOL_E = 1e-5


def _buffer8(rng, cfg, starts, length, noise=0.05):
    """[B, length] int8 stream buffers (quantize_int8 of a float capture)
    with a frame planted at each start."""
    pay = rng.integers(0, 256, (len(starts), PAY), dtype=np.uint8)
    w = transmit(cfg, pay, device="cpu").numpy()
    buf = noise * rng.standard_normal((len(starts), length)).astype(np.float32)
    for i, s in enumerate(starts):
        n = min(w.shape[1], length - s)
        buf[i, s : s + n] += w[i, :n]
    return np.array(jstream.quantize_int8(jnp.asarray(buf)))


def test_quantize_int8_matches_anet():
    edges = np.array([0.0, 1.0, -1.0, 3.96, -3.97, 100.0, -100.0, 1 / 32.0, 1 / 64.0, 3 / 64.0], np.float32)
    rng = np.random.default_rng(1)
    x = np.concatenate([edges, 2.0 * rng.standard_normal(4096).astype(np.float32)])
    got = tstream.quantize_int8(torch.from_numpy(x))
    want = np.asarray(jstream.quantize_int8(jnp.asarray(x)))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[:8], [0, 32, -32, 127, -127, 127, -127, 1])
    assert tstream.INT8_STREAM_SCALE == jstream.INT8_STREAM_SCALE == 32.0
    # the ingest cast: float quantizes into an int8 buffer, int8 passes through
    assert torch.equal(tstream._ingest_cast(torch.from_numpy(x), torch.int8), got)
    assert torch.equal(tstream._ingest_cast(got, torch.int8), got)


@pytest.mark.parametrize("pay", [64, 65])
def test_decide_frame_tm_int8_ref_matches_pallas(pay):
    """Time-major int8 frames quantized as the bench does (x127 over the
    batch's maximum): words and CRC counts exact, quality sums rtol 1e-5."""
    rng = np.random.default_rng(pay + 8)
    payload = rng.integers(0, 256, (5, pay), dtype=np.uint8)
    w = transmit(CFG, payload, device="cpu").numpy()
    w = w + 0.3 * rng.standard_normal(w.shape).astype(np.float32)
    x8 = np.round(w.T * (127.0 / np.abs(w).max())).astype(np.int8)
    pre = CFG.preamble_samples
    words, crc, qual, s = tk.decide_frame_tm_ref(CFG, torch.from_numpy(x8), pay, preamble_offset=pre)
    jw, jc, jq, js = jk.decide_frame_tm(
        JCFG, jnp.asarray(x8), pay, compute_dtype=jnp.int8, interpret=True, preamble_offset=pre
    )
    assert s == js
    np.testing.assert_array_equal(words.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(crc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(qual.numpy(), np.asarray(jq), rtol=RTOL_E)


@pytest.mark.parametrize("name", [NAME, CODED])
def test_demod_at_int8_refs_match_pallas(name):
    """demod_at_fused and demod_at_energies_fused on int8 buffers: tones
    and every energy's argmax exact, energies and sums rtol 1e-5."""
    cfg, jcfg = get_model(name).config, jget_model(name).config
    rng = np.random.default_rng(len(name))
    n_sym = data_symbols_for_payload(cfg, PAY)
    length = tstream._buffer_len(cfg, CHUNK, PAY)
    starts = np.array([0, 127, 128, 1000, 4095], np.int32)
    buf = _buffer8(rng, cfg, starts, length, noise=0.3)
    tb, ts = torch.from_numpy(buf), torch.from_numpy(starts)
    t, b, tot = tk.demod_at_fused_ref(cfg, tb, ts, n_sym)
    jt, jb, jtot = jk.demod_at_fused(
        jcfg, jnp.asarray(buf), jnp.asarray(starts), n_sym, start_bound=CHUNK, interpret=True
    )
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=RTOL_E)
    np.testing.assert_allclose(tot.numpy(), np.asarray(jtot), rtol=RTOL_E)
    e = tk.demod_at_energies_fused_ref(cfg, tb, ts, n_sym)
    je = np.asarray(jk.demod_at_energies_fused(
        jcfg, jnp.asarray(buf), jnp.asarray(starts), n_sym, start_bound=CHUNK, interpret=True
    ))
    np.testing.assert_array_equal(e.argmax(-1).numpy(), je.argmax(-1))
    np.testing.assert_allclose(e.numpy(), je, rtol=RTOL_E, atol=RTOL_E * float(je.max()) * 1e-3)
    # the energies are those of the decisions form
    np.testing.assert_array_equal(e.argmax(-1).numpy(), t.numpy())


def test_demod_probe_int8_ref_matches_pallas_at_row_residues():
    """The merged probe + demod on an int8 buffer with the bf16 template
    the locked step hands it: servo offsets and tones exact (the reference
    sums the correlation in int32, the plain version in float64), cmax
    rtol 1e-6, the window energy exact, best and total rtol 1e-5."""
    rng = np.random.default_rng(71)
    n_sym = data_symbols_for_payload(CFG, PAY)
    starts = np.array([124, 125, 126, 127, 128, 129, 256, 3000], np.int32)
    length = tstream._buffer_len(CFG, CHUNK, PAY)
    buf = _buffer8(rng, CFG, starts, length)
    st0 = starts - 2 + np.array([0, 1, -1, 0, 2, -2, 0, 1], np.int32)
    tpl = np.array(j_preamble(JCFG), np.float32)
    got = tk.demod_probe_fused_ref(
        CFG, torch.from_numpy(buf), torch.from_numpy(st0), n_sym, torch.from_numpy(tpl).to(torch.bfloat16)
    )
    want = jk.demod_probe_fused(
        JCFG, jnp.asarray(buf), jnp.asarray(st0), n_sym, jnp.asarray(tpl).astype(jnp.bfloat16),
        start_bound=int(starts.max()), interpret=True,
    )
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[1].numpy(), starts - st0)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for i in (4, 5):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), rtol=RTOL_E)


def test_probe_template_quantization_matches_anet():
    """The int8 probe's template: round(t * 127 / max|t|), and the factor
    that scales cmax back, as the reference's wrapper computes them."""
    tpl = torch.from_numpy(np.asarray(j_preamble(JCFG), np.float32)).to(torch.bfloat16)
    taps, scale = tk._probe_template(tpl, torch.int8)
    tf = jnp.asarray(tpl.float().numpy())
    tmax = jnp.maximum(jnp.max(jnp.abs(tf)), 1e-20)
    np.testing.assert_array_equal(taps.numpy(), np.asarray(jnp.round(tf * (127.0 / tmax))))
    assert float(scale) == float(tmax / 127.0)
    assert tk._probe_template(tpl, torch.bfloat16)[1] is None


def test_int8_probe_taps_made_once_per_template():
    """The locked step hands demod_probe_fused one template tensor a
    config, dtype and device (stream._lock_template), and the int8 taps are
    quantized once for it; a template changed in place is quantized again.
    The taps are _probe_template's."""
    t_c, te = tstream._lock_template(CFG, torch.bfloat16, torch.device("cpu"))
    assert tstream._lock_template(CFG, torch.bfloat16, torch.device("cpu"))[0] is t_c
    assert float(te) == float((t_c.float() ** 2).sum())
    cpu = torch.device("cpu")
    taps, scale = tk._probe_operands(t_c, torch.int8, cpu)
    again = tk._probe_operands(t_c, torch.int8, cpu)
    assert again[0] is taps and again[1] is scale
    want = tk._probe_template(t_c, torch.int8)
    assert torch.equal(taps, want[0]) and torch.equal(scale, want[1])
    changed = t_c.clone()
    first = tk._probe_operands(changed, torch.int8, cpu)[0]
    changed.mul_(0.5)
    second = tk._probe_operands(changed, torch.int8, cpu)[0]
    assert second is not first and torch.equal(second, tk._probe_template(changed, torch.int8)[0])


def _capture(rng, gaps_per_stream, noise=0.05):
    """[B, N] f32 capture: per stream, each frame after its leading gap."""
    b, n_frames = len(gaps_per_stream), len(gaps_per_stream[0])
    t_frame = jfamily.frame_samples(JCFG, PAY)
    pays = rng.integers(0, 256, (b * n_frames, PAY), dtype=np.uint8)
    waves = np.asarray(jax.jit(jfamily.transmit_fn(JCFG))(jnp.asarray(pays))).reshape(b, n_frames, t_frame)
    caps = [
        np.concatenate([x for i, g in enumerate(gaps) for x in (np.zeros(g, np.float32), waves[s, i])])
        for s, gaps in enumerate(gaps_per_stream)
    ]
    length = -(-(max(map(len, caps)) + t_frame + CHUNK) // CHUNK) * CHUNK
    out = np.zeros((b, length), np.float32)
    for s, c in enumerate(caps):
        out[s, : len(c)] = c
    return out + noise * rng.standard_normal(out.shape).astype(np.float32)


@pytest.mark.parametrize("lock", [False, True])
def test_receive_stream_int8_matches_anet_kernels(interpret_tpu_kernels, monkeypatch, lock):
    """receive_stream on an int8 carry with bf16 compute, the float capture
    quantized at ingest: the card's branches (search: sync_search_fused on
    the bf16 segment + demod_at_fused on the int8 buffer; lock: the merged
    step, demod_probe_fused on the int8 buffer) through the plain versions,
    against anet's step with its Pallas kernels in interpret mode.
    Detections, payloads, verdicts, frame starts and the carry's counters
    equal; quality rtol 1e-5."""
    rng = np.random.default_rng(0x18 + lock)
    cap = _capture(rng, [[450, 0, 0], [127 + 1024, 5, 1]])
    if lock:
        monkeypatch.setattr(tstream, "_merged_lock_supported", lambda config, carry: True)
    carry8 = tstream.init_carry(CFG, CHUNK, PAY, (2,), dtype=torch.int8, device="cpu")
    got = tstream.receive_stream(
        CFG, cap, CHUNK, PAY, lock=lock, carry=carry8, compute_dtype=torch.bfloat16, device="cpu"
    )
    assert got.carry.buffer.dtype == torch.int8
    interpret_tpu_kernels()
    jcarry8 = jstream.init_carry(JCFG, CHUNK, PAY, (2,), dtype=jnp.int8)
    want = jstream.receive_stream(
        JCFG, jnp.asarray(cap), CHUNK, PAY, lock=lock, carry=jcarry8,
        compute_dtype=jnp.bfloat16, resident=False,
    )
    det = got.steps.detected.numpy()
    np.testing.assert_array_equal(det, np.asarray(want.steps.detected))
    np.testing.assert_array_equal(got.steps.frame.payload.numpy()[det], np.asarray(want.steps.frame.payload)[det])
    np.testing.assert_array_equal(got.steps.frame.ok.numpy(), np.asarray(want.steps.frame.ok))
    np.testing.assert_array_equal(got.steps.frame_start.numpy()[det], np.asarray(want.steps.frame_start)[det])
    for f in ("frames_detected", "frames_ok", "decode_errors", "next_start", "locked", "last_frame_end"):
        np.testing.assert_array_equal(getattr(got.carry, f).numpy(), np.asarray(getattr(want.carry, f)), f)
    np.testing.assert_array_equal(got.carry.buffer.numpy(), np.asarray(want.carry.buffer))
    np.testing.assert_allclose(got.steps.quality.numpy(), np.asarray(want.steps.quality), rtol=RTOL_E, atol=1e-7)
    np.testing.assert_allclose(
        got.steps.frame.confidence.numpy()[det], np.asarray(want.steps.frame.confidence)[det], rtol=RTOL_E
    )
    assert int(got.carry.frames_ok.sum()) == 2 * 3


def test_receive_stream_int8_capture_passes_through():
    """An int8 capture (quantized once at the edge) enters an int8 carry
    unchanged: the same result as the float capture it came from."""
    rng = np.random.default_rng(5)
    cap = _capture(rng, [[300, 0], [4000, 2]])
    runs = []
    for c in (cap, tstream.quantize_int8(torch.from_numpy(cap))):
        carry8 = tstream.init_carry(CFG, CHUNK, PAY, (2,), dtype=torch.int8, device="cpu")
        runs.append(tstream.receive_stream(CFG, c, CHUNK, PAY, lock=True, carry=carry8, device="cpu"))
    a, b = runs
    assert torch.equal(a.carry.buffer, b.carry.buffer)
    assert torch.equal(a.steps.frame.payload, b.steps.frame.payload)
    assert int(a.carry.frames_ok.sum()) == 4
    with pytest.raises(ValueError, match="compute_dtype"):
        tstream.receive_stream(CFG, cap, CHUNK, PAY, compute_dtype=torch.int8, device="cpu")


def test_demodulate_frame_tm_int8_matches_anet(monkeypatch):
    """The int8 aligned receiver (quantized-ingest decide_frame_tm) against
    anet's, whose Pallas kernel runs in interpret mode: payloads and
    verdicts equal, confidence and SNR rtol 1e-5; and its refusals."""
    rng = np.random.default_rng(0x1A)
    payload = rng.integers(0, 256, (6, PAY), dtype=np.uint8)
    w = transmit(CFG, payload, device="cpu").numpy()
    w = w + 0.2 * rng.standard_normal(w.shape).astype(np.float32)
    x8 = np.round(w.T * (127.0 / np.abs(w).max())).astype(np.int8)
    got = tframe.demodulate_frame_tm(CFG, x8, PAY, compute_dtype=torch.int8, device="cpu")
    want = jframe.demodulate_frame_tm(
        JCFG, jnp.asarray(x8), PAY, compute_dtype=jnp.int8, use_pallas=True, interpret=True
    )
    np.testing.assert_array_equal(got.payload.numpy(), np.asarray(want.payload))
    np.testing.assert_array_equal(got.payload.numpy(), payload)
    for f in ("magic_ok", "length_ok", "header_crc_ok", "payload_crc_ok", "ok"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), f)
    np.testing.assert_allclose(got.confidence.numpy(), np.asarray(want.confidence), rtol=RTOL_E)
    np.testing.assert_allclose(got.snr_db.numpy(), np.asarray(want.snr_db), rtol=RTOL_E, atol=1e-4)
    # the float path decides alike (the scale cancels in every ratio)
    f32 = tframe.demodulate_frame_tm(CFG, np.ascontiguousarray(w.T), PAY, compute_dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(f32.payload.numpy(), got.payload.numpy())
    with pytest.raises(ValueError, match="int8 capture"):
        tframe.demodulate_frame_tm(CFG, np.ascontiguousarray(w.T), PAY, compute_dtype=torch.int8, device="cpu")
    with pytest.raises(ValueError, match="quantized-ingest"):
        tframe.demodulate_frame_tm(CFG, np.pad(x8, ((0, 64), (0, 0))), PAY, compute_dtype=torch.int8, device="cpu")
    xc = np.zeros((tframe.frame_num_samples(CCFG, PAY), 2), np.int8)
    with pytest.raises(ValueError, match="quantized-ingest"):
        tframe.demodulate_frame_tm(CCFG, xc, PAY, compute_dtype=torch.int8, device="cpu")
    with pytest.raises(ValueError, match="quantized-ingest"):
        jframe.demodulate_frame_tm(JCCFG, jnp.asarray(xc), PAY, compute_dtype=jnp.int8, use_pallas=True)


def test_int8_checkpoints_cross_both_ways(tmp_path):
    """An int8 carry written by anet mid-capture resumes in anet_torch and
    the other way round: buffers bit-equal, dtype kept, and the resumed run
    decodes what the uninterrupted run decodes."""
    rng = np.random.default_rng(0x8C)
    cap = _capture(rng, [[450, 0, 0], [2000, 3, 0]])
    half = (cap.shape[1] // CHUNK // 2) * CHUNK
    full = tstream.receive_stream(
        CFG, cap, CHUNK, PAY, lock=True, carry=tstream.init_carry(CFG, CHUNK, PAY, (2,), dtype=torch.int8, device="cpu"),
        device="cpu",
    )
    # anet -> anet_torch
    j1 = jstream.receive_stream(
        JCFG, jnp.asarray(cap[:, :half]), CHUNK, PAY, lock=True,
        carry=jstream.init_carry(JCFG, CHUNK, PAY, (2,), dtype=jnp.int8),
    )
    jstream.save_carry(tmp_path / "j.npz", j1.carry)
    ck = tstream.load_carry(tmp_path / "j.npz", device="cpu")
    assert ck.carry.buffer.dtype == torch.int8
    np.testing.assert_array_equal(ck.carry.buffer.numpy(), np.asarray(j1.carry.buffer))
    t2 = tstream.receive_stream(CFG, cap[:, half:], CHUNK, PAY, lock=True, carry=ck.carry, device="cpu")
    assert torch.equal(t2.carry.buffer, full.carry.buffer)
    assert torch.equal(t2.carry.frames_ok, full.carry.frames_ok)
    # anet_torch -> anet
    t1 = tstream.receive_stream(
        CFG, cap[:, :half], CHUNK, PAY, lock=True,
        carry=tstream.init_carry(CFG, CHUNK, PAY, (2,), dtype=torch.int8, device="cpu"), device="cpu",
    )
    tstream.save_carry(tmp_path / "t.npz", t1.carry)
    jck = jstream.load_carry(tmp_path / "t.npz")
    assert jck.carry.buffer.dtype == jnp.int8
    np.testing.assert_array_equal(np.asarray(jck.carry.buffer), t1.carry.buffer.numpy())
    j2 = jstream.receive_stream(JCFG, jnp.asarray(cap[:, half:]), CHUNK, PAY, lock=True, carry=jck.carry)
    np.testing.assert_array_equal(np.asarray(j2.carry.frames_ok), full.carry.frames_ok.numpy())
    assert int(full.carry.frames_ok.sum()) == 6


def test_coded_stream_int8_carry_decodes():
    """The coded locked stream on an int8 carry: the probe reads a bf16
    copy (exact for int8 values), demod_at_energies_fused the int8 buffer;
    every frame decodes to the payloads the float carry gives."""
    rng = np.random.default_rng(0xC8)
    b, n_frames, cpay = 2, 2, 32
    t_frame = jfamily.frame_samples(JCCFG, cpay)
    pays = rng.integers(0, 256, (b * n_frames, cpay), dtype=np.uint8)
    waves = transmit(CCFG, pays, device="cpu").numpy().reshape(b, n_frames, t_frame)
    length = -(-(600 + n_frames * t_frame + t_frame + CHUNK) // CHUNK) * CHUNK
    cap = 0.1 * rng.standard_normal((b, length)).astype(np.float32)
    for s in range(b):
        for i in range(n_frames):
            cap[s, 600 + i * t_frame : 600 + (i + 1) * t_frame] += waves[s, i]
    carry8 = tstream.init_carry(CCFG, CHUNK, cpay, (b,), dtype=torch.int8, device="cpu")
    got = tstream.receive_stream(CCFG, cap, CHUNK, cpay, lock=True, carry=carry8, compute_dtype=torch.bfloat16, device="cpu")
    ref = tstream.receive_stream(CCFG, cap, CHUNK, cpay, lock=True, device="cpu")
    det = got.steps.detected
    assert torch.equal(det, ref.steps.detected)
    assert torch.equal(got.steps.frame.payload[det], ref.steps.frame.payload[det])
    assert int(got.carry.frames_ok.sum()) == b * n_frames


def test_int8_refusals():
    """int8 carries serve every receiver (OFDM and variable-length ones
    included); other buffer dtypes are refused; the int8 dtype survives the
    numpy layout."""
    ocfg = get_model("ofdm-fast").config
    assert tstream.init_carry(ocfg, CHUNK, PAY, (1,), dtype=torch.int8, device="cpu").buffer.dtype == torch.int8
    carry8 = tstream.init_carry(CFG, CHUNK, PAY, (1,), dtype=torch.int8, device="cpu")
    cap = np.zeros((1, CHUNK), np.float32)
    res = tstream.receive_stream_dynamic(CFG, cap, CHUNK, PAY, carry=carry8, device="cpu")
    assert res.carry.buffer.dtype == torch.int8 and not bool(res.steps.detected.any())
    with pytest.raises(ValueError, match="float32, bfloat16 or int8"):
        tstream.init_carry(CFG, CHUNK, PAY, (1,), dtype=torch.float16, device="cpu")
    fields = tstream.carry_to_numpy(carry8)
    assert str(fields["buffer_dtype"]) == "int8"
    assert tstream.carry_from_numpy(fields, device="cpu").buffer.dtype == torch.int8
