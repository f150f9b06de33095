"""The variable-length streaming receiver, anet_torch against the JAX
package on the CPU: receive_stream_dynamic / stream_step_dynamic with one
candidate a chunk, with two (the quality-order extraction over
correlate_fused's every-lag output) and in frame lock, uncoded
(mfsk16-fast) and coded (mfsk4-coded-stream: header probe + masked
trellis), and on ofdm-fast (the gathered max-length window through the
OFDM receiver). The same numpy captures go through both. Payloads, declared
lengths, verdicts, detections, frame starts of every slot, counters,
``locked`` and ``next_start`` bit-equal; quality, confidence, snr_db and
drift rtol 1e-4 (float32 sums in another order). The card's branch runs
through the plain versions against JAX's Pallas kernels in interpret mode,
and checkpoints cross between the packages mid-capture."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anet import stream as jstream
from anet.dsp import family as jfamily
from anet.models import get_model as jget_model

import anet_torch.stream as tstream
from anet_torch.dsp import family as tfamily
from anet_torch.dsp import frame as tframe
from anet_torch.dsp.pipeline import transmit
from anet_torch.models import get_model

MAX = 48
MODELS = {
    name: (get_model(name).config, jget_model(name).config) for name in ("mfsk16-fast", "mfsk4-coded-stream")
}
OFDM = "ofdm-fast"
ALL_MODELS = {**MODELS, OFDM: (get_model(OFDM).config, jget_model(OFDM).config)}
FRAME_FIELDS = ("payload_len", "magic_ok", "length_ok", "header_crc_ok", "payload_crc_ok", "ok")
# the layouts of the full-size smoke run, scaled to a 48-byte maximum
TWO_A_CHUNK = (8, 8, 48, 24, 8, 8)
LOCKED = (8, 48, 24, 8, 48, 24)


def _capture(cfg, rng, lens, chunk, b=2, gap0=1000, noise=0.02, gaps=None):
    """([B, N] f32 capture, payloads per frame): gap0 zeros, the frames back
    to back (or after ``gaps``), a max-length frame of zeros, whole chunks.
    The waveforms are the port's, which test_torch_frame.py and
    test_torch_ofdm.py hold equal to the JAX package's."""
    t_max = tfamily.frame_samples(cfg, MAX)
    tx = tfamily.transmit_fn(cfg, device="cpu")
    parts, sent = [np.zeros((b, gap0), np.float32)], []
    for i, n in enumerate(lens):
        pay = rng.integers(0, 256, (b, n), dtype=np.uint8)
        sent.append(pay)
        if gaps:
            parts.append(np.zeros((b, gaps[i]), np.float32))
        parts.append(tx(pay).numpy())
    parts.append(np.zeros((b, t_max + 300), np.float32))
    cap = np.concatenate(parts, -1)
    cap = np.concatenate([cap, np.zeros((b, -cap.shape[1] % chunk), np.float32)], -1)
    return cap + noise * rng.standard_normal(cap.shape).astype(np.float32), sent


def _chunk(jcfg, lens, frames_per_chunk=1):
    return frames_per_chunk * jfamily.frame_samples(jcfg, min(lens)) // 128 * 128


def _assert_same(got, want, tol=1e-4, snr_atol=1e-3):
    det = got.steps.detected.numpy()
    np.testing.assert_array_equal(det, np.asarray(want.steps.detected))
    np.testing.assert_array_equal(got.steps.frame_start.numpy(), np.asarray(want.steps.frame_start))
    for f in FRAME_FIELDS:
        np.testing.assert_array_equal(
            getattr(got.steps.frame, f).numpy()[det], np.asarray(getattr(want.steps.frame, f))[det], f
        )
    np.testing.assert_array_equal(got.steps.frame.ok.numpy(), np.asarray(want.steps.frame.ok))
    np.testing.assert_array_equal(
        got.steps.frame.payload.numpy()[det], np.asarray(want.steps.frame.payload)[det]
    )
    np.testing.assert_allclose(got.steps.quality.numpy(), np.asarray(want.steps.quality), rtol=tol, atol=1e-6)
    for f in ("confidence", "snr_db"):
        np.testing.assert_allclose(
            getattr(got.steps.frame, f).numpy()[det], np.asarray(getattr(want.steps.frame, f))[det],
            rtol=tol, atol=snr_atol if f == "snr_db" else 0, err_msg=f,
        )
    for f in ("samples_seen", "frames_detected", "frames_ok", "decode_errors", "next_start", "locked",
              "last_frame_end"):
        np.testing.assert_array_equal(getattr(got.carry, f).numpy(), np.asarray(getattr(want.carry, f)), f)
    np.testing.assert_allclose(got.carry.drift.numpy(), np.asarray(want.carry.drift), rtol=tol, atol=1e-6)


def _assert_frames(res, lens, sent):
    """Every frame sent came out once, in time order, with its length."""
    b = res.steps.detected.shape[-1]
    det = res.steps.detected.reshape(-1, b).numpy()
    start = res.steps.frame_start.reshape(-1, b).numpy()
    plen = res.steps.frame.payload_len.reshape(-1, b).numpy()
    payload = res.steps.frame.payload.reshape(-1, b, MAX).numpy()
    for s in range(b):
        rows = np.nonzero(det[:, s])[0]
        rows = rows[np.argsort(start[rows, s])]
        assert plen[rows, s].tolist() == list(lens)
        for r, n, pay in zip(rows, lens, sent):
            np.testing.assert_array_equal(payload[r, s, :n], pay[s])
            assert not payload[r, s, n:].any()
    assert res.carry.frames_ok.tolist() == [len(lens)] * b and not res.carry.decode_errors.any()


@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("mode", ["search", "two-a-chunk", "lock"])
def test_receive_stream_dynamic_matches_jax(model, mode):
    cfg, jcfg = MODELS[model]
    rng = np.random.default_rng(len(model) + len(mode))
    lens = {"search": (8, 48, 24), "two-a-chunk": TWO_A_CHUNK, "lock": LOCKED}[mode]
    k = 2 if mode == "two-a-chunk" else 1
    chunk = _chunk(jcfg, lens, k)
    gaps = (0, 700, 1100) if mode == "search" else None  # one candidate a chunk needs frames apart
    cap, sent = _capture(cfg, rng, lens, chunk, gaps=gaps)
    kw = dict(max_frames_per_chunk=k, lock=mode == "lock")
    want = jstream.receive_stream_dynamic(jcfg, jnp.asarray(cap), chunk, MAX, **kw)
    got = tstream.receive_stream_dynamic(cfg, cap, chunk, MAX, device="cpu", **kw)
    n_chunks = cap.shape[1] // chunk
    assert got.steps.detected.shape == ((n_chunks, 2, 2) if k == 2 else (n_chunks, 2))
    assert got.steps.frame.payload.shape == got.steps.detected.shape + (MAX,)
    assert isinstance(got.steps, tstream.DynamicStreamStepOutput)
    assert isinstance(got.steps.frame, tframe.DynamicFrameResult)
    _assert_same(got, want)
    _assert_frames(got, lens, sent)
    if k == 2:  # two frames completed in one chunk at least once
        assert bool((got.steps.detected.sum(1) == 2).any())
    if mode == "lock":
        assert bool(got.carry.locked.any()) or int(got.carry.next_start.max()) > 0


def test_dynamic_lock_follows_slips_and_gaps_like_jax():
    """Frame lock across a 2-sample slip (the servo), a long gap (the lock
    expires and the search re-acquires) and a frame declaring more than the
    maximum (skipped: its gate fails length_ok)."""
    cfg, jcfg = MODELS["mfsk16-fast"]
    rng = np.random.default_rng(77)
    lens = (8, 24, 8, 48)
    chunk = _chunk(jcfg, lens)
    cap, sent = _capture(cfg, rng, lens, chunk, b=3, gaps=(0, 2, 3 * chunk + 5, 1))
    big = transmit(cfg, rng.integers(0, 256, (1, MAX + 4), dtype=np.uint8), device="cpu").numpy()
    tail = cap.shape[1] - jfamily.frame_samples(jcfg, MAX) - 300
    cap = np.concatenate([cap[:, :tail], np.repeat(big, 3, 0), cap[:, tail:]], -1)
    cap = np.concatenate([cap, np.zeros((3, -cap.shape[1] % chunk), np.float32)], -1)
    for lock in (True, False):
        want = jstream.receive_stream_dynamic(jcfg, jnp.asarray(cap), chunk, MAX, lock=lock)
        got = tstream.receive_stream_dynamic(cfg, cap, chunk, MAX, lock=lock, device="cpu")
        _assert_same(got, want)
        _assert_frames(got, lens, sent)


@pytest.mark.parametrize("model", list(MODELS))
def test_stream_step_dynamic_matches_jax_step_by_step(model):
    """One step at a time with K = 2: every field of every slot's emission
    and the carry after each chunk."""
    cfg, jcfg = MODELS[model]
    rng = np.random.default_rng(5)
    chunk = _chunk(jcfg, TWO_A_CHUNK, 2)
    cap, _ = _capture(cfg, rng, TWO_A_CHUNK, chunk)
    jc = jstream.init_carry(jcfg, chunk, MAX, (2,))
    tc = tstream.init_carry(cfg, chunk, MAX, (2,), device="cpu")
    assert tc.buffer.shape == jc.buffer.shape
    step = jax.jit(functools.partial(jstream.stream_step_dynamic, jcfg, max_payload_len=MAX, max_frames_per_chunk=2))
    for i in range(cap.shape[1] // chunk):
        piece = cap[:, i * chunk : (i + 1) * chunk]
        jc, jout = step(carry=jc, chunk=jnp.asarray(piece))
        tc, tout = tstream.stream_step_dynamic(cfg, tc, torch.from_numpy(piece), MAX, max_frames_per_chunk=2)
        assert tout.detected.shape == (2, 2)
        np.testing.assert_array_equal(tout.detected.numpy(), np.asarray(jout.detected))
        np.testing.assert_array_equal(tout.frame_start.numpy(), np.asarray(jout.frame_start))
        np.testing.assert_allclose(tout.quality.numpy(), np.asarray(jout.quality), rtol=1e-4, atol=1e-6)
        np.testing.assert_array_equal(tc.last_frame_end.numpy(), np.asarray(jc.last_frame_end))
        np.testing.assert_array_equal(tc.buffer.numpy(), np.asarray(jc.buffer))
    assert tc.frames_ok.tolist() == [6, 6]


@pytest.mark.parametrize("mode", ["two-a-chunk", "lock"])
@pytest.mark.parametrize("model", list(MODELS))
def test_dynamic_card_branch_matches_jax_kernels(interpret_tpu_kernels, monkeypatch, model, mode):
    """The card's branch of the dynamic step (correlate_fused for two
    candidates a chunk, probe_at_fused in lock, then demod_at_fused or
    demod_at_energies_fused + two viterbi_trellis passes) run through the
    plain versions on the CPU, against JAX's step with its Pallas kernels in
    interpret mode; bf16 buffers. Quality rtol 1e-3 (bf16 inputs, float32
    sums in another order; the probe kernel's energy span)."""
    import anet.kernels as jk
    from anet_torch import kernels as tk

    cfg, jcfg = MODELS[model]
    rng = np.random.default_rng(0xD1 + len(model))
    lock = mode == "lock"
    lens = LOCKED[:3] if lock else TWO_A_CHUNK[:3]  # interpret mode is slow: three frames
    k = 1 if lock else 2
    chunk = _chunk(jcfg, lens, k)
    cap, sent = _capture(cfg, rng, lens, chunk, gap0=127, noise=0.05)
    calls = dict.fromkeys(("correlate_fused", "probe_at_fused", "demod_at_fused", "demod_at_energies_fused",
                           "viterbi_trellis"), 0)

    def counted(name):
        fn = getattr(tk, name)

        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)

        return wrapper

    for name in calls:
        monkeypatch.setattr(tk, name, counted(name))
    monkeypatch.setattr(tstream, "_probe_kernel_supported", lambda carry: True)
    got = tstream.receive_stream_dynamic(
        cfg, torch.from_numpy(cap).to(torch.bfloat16), chunk, MAX, compute_dtype=torch.bfloat16,
        max_frames_per_chunk=k, lock=lock, device="cpu",
    )
    n = cap.shape[1] // chunk
    coded = cfg.fec == "conv"
    assert calls == {
        "correlate_fused": 0 if lock else n, "probe_at_fused": n if lock else 0,
        "demod_at_fused": 0 if coded else k * n, "demod_at_energies_fused": k * n if coded else 0,
        "viterbi_trellis": 2 * k * n if coded else 0,
    }
    interpret_tpu_kernels()
    monkeypatch.setattr(jk, "correlate_fused", functools.partial(jk.correlate_fused, interpret=True))
    want = jstream.receive_stream_dynamic(
        jcfg, jnp.asarray(cap).astype(jnp.bfloat16), chunk, MAX, compute_dtype=jnp.bfloat16,
        max_frames_per_chunk=k, lock=lock,
    )
    _assert_same(got, want, tol=1e-3)
    _assert_frames(got, lens, sent)


def test_kernel_route_equals_gather_and_demodulate_pair():
    """demod_at_fused + dynamic_frame_result_from_tone_decisions (the step's
    route) against _batched_dynamic_slice + demodulate_frame_dynamic (the
    one-shot receiver's): the same frames."""
    cfg, jcfg = MODELS["mfsk16-fast"]
    rng = np.random.default_rng(12)
    cap, sent = _capture(cfg, rng, (17,), 128, b=4, gap0=0, noise=0.2)
    t_max = tframe.frame_num_samples(cfg, MAX)
    buf = torch.from_numpy(np.pad(cap, ((0, 0), (300, 0))))
    starts = torch.tensor([300, 300, 300, 300 + 3 * cfg.samples_per_symbol])  # the last: three symbols late
    from anet_torch.kernels import demod_at_fused

    tone, best, total = demod_at_fused(cfg, buf, starts, tframe.data_symbols_for_payload(cfg, MAX))
    a = tframe.dynamic_frame_result_from_tone_decisions(cfg, tone, best, total, MAX)
    aligned = tstream._batched_dynamic_slice(buf, starts, t_max)
    b = tframe.demodulate_frame_dynamic(cfg, aligned, MAX, device="cpu")
    assert a.ok.tolist() == b.ok.tolist() == [True, True, True, False]
    assert torch.equal(a.payload[a.ok], b.payload[b.ok]) and torch.equal(a.payload_len, b.payload_len)
    np.testing.assert_array_equal(a.payload[0, :17].numpy(), sent[0][0])


@pytest.mark.parametrize("model,mode", [
    ("mfsk16-fast", "two-a-chunk"), ("mfsk16-fast", "lock"), ("mfsk4-coded-stream", "lock"), (OFDM, "lock"),
])
def test_dynamic_checkpoint_crosses_both_ways(tmp_path, model, mode):
    """A dynamic-stream checkpoint written by anet.stream.save_carry
    mid-capture resumes in anet_torch.stream.receive_stream_dynamic with the
    frames of one uninterrupted JAX run, and the port's own checkpoint
    resumes in JAX."""
    _dynamic_checkpoint_crosses(tmp_path, model, mode)


@pytest.mark.parametrize("model", ["mfsk16-fast", OFDM])
def test_int8_dynamic_checkpoint_crosses_both_ways(tmp_path, model):
    """The same crossings in frame lock from int8 carries: the buffer's
    int8 dtype and values survive both ways."""
    _dynamic_checkpoint_crosses(tmp_path, model, "lock", int8=True)


def _dynamic_checkpoint_crosses(tmp_path, model, mode, int8=False):
    cfg, jcfg = ALL_MODELS[model]
    rng = np.random.default_rng(21)
    lock = mode == "lock"
    lens = LOCKED if lock else TWO_A_CHUNK
    k = 1 if lock else 2
    chunk = _chunk(jcfg, lens, k)
    cap, sent = _capture(cfg, rng, lens, chunk)
    kw = dict(max_frames_per_chunk=k, lock=lock)
    n0 = cap.shape[1] // chunk // 2
    cut = n0 * chunk

    def jcarry():
        return jstream.init_carry(jcfg, chunk, MAX, (2,), dtype=jnp.int8) if int8 else None

    full = jstream.receive_stream_dynamic(jcfg, jnp.asarray(cap), chunk, MAX, carry=jcarry(), **kw)
    first = jstream.receive_stream_dynamic(jcfg, jnp.asarray(cap[:, :cut]), chunk, MAX, carry=jcarry(), **kw)
    assert 0 < int(np.asarray(first.carry.frames_ok).sum()) < 2 * len(lens)  # mid-capture
    jstream.save_carry(tmp_path / "jax.npz", first.carry)
    ckpt = tstream.load_carry(tmp_path / "jax.npz", device="cpu")
    assert ckpt.carry.buffer.dtype == (torch.int8 if int8 else torch.float32)
    rest = tstream.receive_stream_dynamic(cfg, cap[:, cut:], chunk, MAX, carry=ckpt.carry, device="cpu", **kw)
    det = rest.steps.detected.numpy()
    np.testing.assert_array_equal(det, np.asarray(full.steps.detected)[n0:])
    np.testing.assert_array_equal(rest.steps.frame_start.numpy(), np.asarray(full.steps.frame_start)[n0:])
    np.testing.assert_array_equal(
        rest.steps.frame.payload.numpy()[det], np.asarray(full.steps.frame.payload)[n0:][det]
    )
    np.testing.assert_array_equal(
        rest.steps.frame.payload_len.numpy()[det], np.asarray(full.steps.frame.payload_len)[n0:][det]
    )
    for f in tstream.StreamCarry._fields:
        np.testing.assert_allclose(
            getattr(rest.carry, f).float().numpy(), np.asarray(getattr(full.carry, f)).astype(np.float32),
            rtol=1e-6, atol=1e-6, err_msg=f,
        )
    # the other way: the port checkpoints, JAX resumes
    carry = tstream.init_carry(cfg, chunk, MAX, (2,), dtype=torch.int8, device="cpu") if int8 else None
    mid = tstream.receive_stream_dynamic(cfg, cap[:, :cut], chunk, MAX, carry=carry, device="cpu", **kw)
    tstream.save_carry(tmp_path / "torch.npz", mid.carry)
    back = jstream.load_carry(tmp_path / "torch.npz")
    assert back.carry.buffer.dtype == (jnp.int8 if int8 else jnp.float32)
    tail = jstream.receive_stream_dynamic(jcfg, jnp.asarray(cap[:, cut:]), chunk, MAX, carry=back.carry, **kw)
    np.testing.assert_array_equal(np.asarray(tail.steps.detected), np.asarray(full.steps.detected)[n0:])
    np.testing.assert_array_equal(
        np.asarray(tail.steps.frame.payload)[det], np.asarray(full.steps.frame.payload)[n0:][det]
    )
    for f in ("frames_ok", "next_start", "last_frame_end"):
        np.testing.assert_array_equal(np.asarray(getattr(tail.carry, f)), np.asarray(getattr(full.carry, f)), f)
    assert np.asarray(full.carry.frames_ok).tolist() == [len(lens)] * 2


@pytest.mark.parametrize("mode", ["two-a-chunk", "lock"])
@pytest.mark.parametrize("batch_shape", [(), (2, 3)], ids=["scalar", "2x3"])
def test_receive_stream_dynamic_batch_shapes_match_jax(batch_shape, mode):
    """A 1-D capture (batch shape ()) and a [2, 3, N] one through both
    packages, two candidates a chunk (the candidate axis after the chunk
    axis, before the batch axes) and in frame lock: every field with the
    reference's shape; detections, frame starts, lengths, payloads,
    verdicts and the carry equal."""
    cfg, jcfg = MODELS["mfsk16-fast"]
    rng = np.random.default_rng(41 + len(batch_shape))
    lock = mode == "lock"
    lens = LOCKED if lock else TWO_A_CHUNK
    k = 1 if lock else 2
    chunk = _chunk(jcfg, lens, k)
    b = int(np.prod(batch_shape))
    cap, _ = _capture(cfg, rng, lens, chunk, b=b)
    cap = cap.reshape(*batch_shape, cap.shape[-1])
    kw = dict(max_frames_per_chunk=k, lock=lock)
    want = jstream.receive_stream_dynamic(jcfg, jnp.asarray(cap), chunk, MAX, **kw)
    got = tstream.receive_stream_dynamic(cfg, cap, chunk, MAX, device="cpu", **kw)
    n_chunks = cap.shape[-1] // chunk
    assert tuple(got.steps.detected.shape) == (n_chunks, *((k,) if k > 1 else ()), *batch_shape)
    for f in tstream.StreamCarry._fields:
        assert tuple(getattr(got.carry, f).shape) == np.shape(getattr(want.carry, f)), f
    for f in ("detected", "quality", "frame_start"):
        assert tuple(getattr(got.steps, f).shape) == np.shape(getattr(want.steps, f)), f
    for f in got.steps.frame._fields:
        assert tuple(getattr(got.steps.frame, f).shape) == np.shape(getattr(want.steps.frame, f)), f
    _assert_same(got, want)
    np.testing.assert_array_equal(got.carry.buffer.numpy(), np.asarray(want.carry.buffer))
    assert int(got.carry.frames_ok.sum()) == len(lens) * b


def test_scalar_dynamic_checkpoint_crosses_both_ways(tmp_path):
    """A dynamic-lock checkpoint of batch shape () written by
    anet.stream.save_carry mid-capture resumes in the port with the frames
    of one uninterrupted JAX run, and the port's resumes in anet."""
    cfg, jcfg = MODELS["mfsk16-fast"]
    rng = np.random.default_rng(23)
    chunk = _chunk(jcfg, LOCKED)
    cap, _ = _capture(cfg, rng, LOCKED, chunk, b=1)
    cap = cap[0]
    n0 = cap.shape[-1] // chunk // 2
    cut = n0 * chunk
    full = jstream.receive_stream_dynamic(jcfg, jnp.asarray(cap), chunk, MAX, lock=True)
    first = jstream.receive_stream_dynamic(jcfg, jnp.asarray(cap[:cut]), chunk, MAX, lock=True)
    assert 0 < int(first.carry.frames_ok) < len(LOCKED)
    jstream.save_carry(tmp_path / "jax.npz", first.carry)
    ckpt = tstream.load_carry(tmp_path / "jax.npz", device="cpu")
    assert ckpt.carry.samples_seen.shape == () and ckpt.carry.buffer.dim() == 1
    rest = tstream.receive_stream_dynamic(cfg, cap[cut:], chunk, MAX, carry=ckpt.carry, lock=True, device="cpu")
    det = rest.steps.detected.numpy()
    np.testing.assert_array_equal(det, np.asarray(full.steps.detected)[n0:])
    np.testing.assert_array_equal(
        rest.steps.frame.payload.numpy()[det], np.asarray(full.steps.frame.payload)[n0:][det]
    )
    for f in tstream.StreamCarry._fields:
        np.testing.assert_allclose(
            getattr(rest.carry, f).float().numpy(), np.asarray(getattr(full.carry, f)).astype(np.float32),
            rtol=1e-6, atol=1e-6, err_msg=f,
        )
    mid = tstream.receive_stream_dynamic(cfg, cap[:cut], chunk, MAX, lock=True, device="cpu")
    tstream.save_carry(tmp_path / "torch.npz", mid.carry)
    back = jstream.load_carry(tmp_path / "torch.npz")
    tail = jstream.receive_stream_dynamic(jcfg, jnp.asarray(cap[cut:]), chunk, MAX, carry=back.carry, lock=True)
    np.testing.assert_array_equal(np.asarray(tail.steps.detected), np.asarray(full.steps.detected)[n0:])
    np.testing.assert_array_equal(
        np.asarray(tail.steps.frame.payload)[det], np.asarray(full.steps.frame.payload)[n0:][det]
    )
    for f in ("frames_ok", "next_start", "last_frame_end"):
        np.testing.assert_array_equal(np.asarray(getattr(tail.carry, f)), np.asarray(getattr(full.carry, f)), f)
    assert int(full.carry.frames_ok) == len(LOCKED)


@pytest.mark.parametrize("mode", ["search", "lock"])
def test_ofdm_receive_stream_dynamic_matches_jax(mode):
    """ofdm-fast frames of three lengths (the reference's
    test_stream_dynamic_ofdm, here against the JAX package step for step):
    lengths from the headers, payloads, verdicts and counters equal."""
    cfg, jcfg = ALL_MODELS[OFDM]
    rng = np.random.default_rng(9 + len(mode))
    lens = (8, 48, 24)
    chunk = _chunk(jcfg, lens)
    gaps = (0, 700, 1100) if mode == "search" else None
    cap, sent = _capture(cfg, rng, lens, chunk, gaps=gaps, noise=0.01)
    kw = dict(lock=mode == "lock")
    want = jstream.receive_stream_dynamic(jcfg, jnp.asarray(cap), chunk, MAX, **kw)
    got = tstream.receive_stream_dynamic(cfg, cap, chunk, MAX, device="cpu", **kw)
    _assert_same(got, want)
    _assert_frames(got, lens, sent)


def test_dynamic_stream_refusals():
    cfg, _ = MODELS["mfsk16-fast"]
    cap = np.zeros((1, 2048), np.float32)
    with pytest.raises(ValueError, match="max_frames_per_chunk=1"):
        tstream.receive_stream_dynamic(cfg, cap, 1024, MAX, lock=True, max_frames_per_chunk=2, device="cpu")
    with pytest.raises(ValueError, match="multiple of chunk_size"):
        tstream.receive_stream_dynamic(cfg, cap, 1000, MAX, device="cpu")
    coded = get_model("mfsk4-coded").config  # depth-24 interleaver
    with pytest.raises(ValueError, match="fec_interleave == 1"):
        tstream.receive_stream_dynamic(coded, cap, 1024, MAX, device="cpu")
    other = tstream.init_carry(cfg, 1024, 4 * MAX, (1,), device="cpu")
    with pytest.raises(ValueError, match="carry buffer"):
        tstream.receive_stream_dynamic(cfg, cap, 1024, MAX, carry=other, device="cpu")
    with pytest.raises(NotImplementedError, match="OFDM"):
        tstream.receive_stream_dynamic(object(), cap, 1024, MAX, device="cpu")


# int8 carries: the port's MFSK dynamic step hands the int8 buffer to the
# align+demod kernels (their int8 instantiation's plain version on the CPU:
# the x127 integer basis), the reference demodulates it by its gather + demod
# golden pair in compute_dtype; the OFDM step gathers the window in
# compute_dtype in both. Decisions, lengths, verdicts, detections and frame
# starts are equal; snr_db is held within 0.1 dB: the integer basis's rounding
# leaks about -45 dB of a tone into the others, which shows only where the
# noise is that low (about 43 dB in-bin here: 0.062 dB at most).
INT8_SNR_ATOL = 0.1


@pytest.mark.parametrize("model,mode", [
    ("mfsk16-fast", "search"), ("mfsk16-fast", "two-a-chunk"), ("mfsk16-fast", "lock"),
    ("mfsk4-coded-stream", "lock"), (OFDM, "lock"),
])
def test_int8_receive_stream_dynamic_matches_jax(model, mode, monkeypatch):
    """receive_stream_dynamic on int8 carries in both packages, the float
    capture quantized at ingest, with the card's probe route taken
    (_probe_kernel_supported patched): an int8 buffer never reaches
    probe_at_fused, and the MFSK align+demod kernels get the int8 buffer as
    it is. Everything _assert_same holds, snr_db within INT8_SNR_ATOL."""
    from anet_torch import kernels as tk

    cfg, jcfg = ALL_MODELS[model]
    rng = np.random.default_rng(0x18D + len(model) + len(mode))
    lens = {"search": (8, 48, 24), "two-a-chunk": TWO_A_CHUNK, "lock": LOCKED}[mode]
    k = 2 if mode == "two-a-chunk" else 1
    chunk = _chunk(jcfg, lens, k)
    gaps = (0, 700, 1100) if mode == "search" else None
    cap, sent = _capture(cfg, rng, lens, chunk, gaps=gaps, noise=0.01 if model == OFDM else 0.02)
    probes, demod_dtypes = [], []
    monkeypatch.setattr(tstream, "_probe_kernel_supported", lambda carry: True)
    monkeypatch.setattr(tk, "probe_at_fused", lambda *a, **kw: probes.append(a))
    for name in ("demod_at_fused", "demod_at_energies_fused"):
        fn = getattr(tk, name)

        def recorded(config, buffer, *a, _fn=fn):
            demod_dtypes.append(buffer.dtype)
            return _fn(config, buffer, *a)

        monkeypatch.setattr(tk, name, recorded)
    kw = dict(max_frames_per_chunk=k, lock=mode == "lock")
    carry8 = tstream.init_carry(cfg, chunk, MAX, (2,), dtype=torch.int8, device="cpu")
    got = tstream.receive_stream_dynamic(cfg, cap, chunk, MAX, carry=carry8, device="cpu", **kw)
    want = jstream.receive_stream_dynamic(
        jcfg, jnp.asarray(cap), chunk, MAX, carry=jstream.init_carry(jcfg, chunk, MAX, (2,), dtype=jnp.int8), **kw
    )
    assert not probes and got.carry.buffer.dtype == torch.int8
    n_chunks = cap.shape[1] // chunk
    assert demod_dtypes == ([] if model == OFDM else [torch.int8] * (k * n_chunks))
    _assert_same(got, want, snr_atol=INT8_SNR_ATOL)
    np.testing.assert_array_equal(got.carry.buffer.numpy(), np.asarray(want.carry.buffer))
    _assert_frames(got, lens, sent)


def test_float_capture_quantizes_into_int8_dynamic_carry():
    """A float32 capture entering an int8 dynamic carry is quantized
    (quantize_int8), not truncated by a plain cast: the same buffer and
    frames as the int8 capture it quantizes to, every frame decoded."""
    cfg, jcfg = MODELS["mfsk16-fast"]
    rng = np.random.default_rng(0xF8)
    lens = LOCKED[:3]
    chunk = _chunk(jcfg, lens)
    cap, sent = _capture(cfg, rng, lens, chunk)
    runs = []
    for c in (cap, tstream.quantize_int8(torch.from_numpy(cap))):
        carry8 = tstream.init_carry(cfg, chunk, MAX, (2,), dtype=torch.int8, device="cpu")
        runs.append(tstream.receive_stream_dynamic(cfg, c, chunk, MAX, carry=carry8, lock=True, device="cpu"))
    a, b = runs
    assert torch.equal(a.carry.buffer, b.carry.buffer)
    assert torch.equal(a.steps.detected, b.steps.detected)
    assert torch.equal(a.steps.frame.payload, b.steps.frame.payload)
    _assert_frames(a, lens, sent)
