"""The streaming receiver, anet_torch against the JAX package on the CPU:
always-search and frame-lock modes on the layouts of test_stream_lock.py
(contiguous, random gaps, 1-2-sample slips); the card's merged lock step
driven through the plain versions against JAX's merged step under the
interpret fixture; and checkpoints crossing between the packages. The same
for the coded path on mfsk4-coded (soft Viterbi, depth-24 interleaver): its
card branch is the unmerged lock step (probe_at_fused,
demod_at_energies_fused, viterbi_trellis). And for the OFDM family on
ofdm-fast: the same front halves, then the gathered window through the OFDM
receiver (ofdm_track_decide_fused)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anet import stream as jstream
from anet.dsp import family as jfamily
from anet.models import get_model as jget_model

import anet_torch.stream as tstream
from anet_torch.models import get_model

NAME = "mfsk16-fast"
CFG, JCFG = get_model(NAME).config, jget_model(NAME).config
PAY = 64
T_FRAME = jfamily.frame_samples(JCFG, PAY)
CHUNK = 4096
CODED = "mfsk4-coded"
CCFG, JCCFG = get_model(CODED).config, jget_model(CODED).config
CPAY = 32
CT_FRAME = jfamily.frame_samples(JCCFG, CPAY)
OFDM = "ofdm-fast"
OCFG, JOCFG = get_model(OFDM).config, jget_model(OFDM).config
OPAY = 224  # a 4,160-sample frame, longer than a chunk: one frame completes a chunk at most


def _capture(rng, gaps_per_stream, noise=0.05, jcfg=JCFG, pay=PAY):
    """[B, N] f32 capture: per stream, each frame after its leading gap."""
    b, n_frames = len(gaps_per_stream), len(gaps_per_stream[0])
    t_frame = jfamily.frame_samples(jcfg, pay)
    pays = rng.integers(0, 256, (b * n_frames, pay), dtype=np.uint8)
    waves = np.asarray(jax.jit(jfamily.transmit_fn(jcfg))(jnp.asarray(pays)))
    waves = waves.reshape(b, n_frames, t_frame)
    caps = [
        np.concatenate([x for i, g in enumerate(gaps) for x in (np.zeros(g, np.float32), waves[s, i])])
        for s, gaps in enumerate(gaps_per_stream)
    ]
    length = -(-(max(map(len, caps)) + t_frame + CHUNK) // CHUNK) * CHUNK
    out = np.zeros((b, length), np.float32)
    for s, c in enumerate(caps):
        out[s, : len(c)] = c
    return out + noise * rng.standard_normal(out.shape).astype(np.float32)


def _layout(name, rng, b=3, n_frames=4):
    if name == "contiguous":
        return [[450] + [0] * (n_frames - 1) for _ in range(b)]
    if name == "random_gaps":
        return [[int(g) for g in rng.integers(0, 3 * CHUNK, n_frames)] for _ in range(b)]
    return [[777] + [int(g) for g in rng.integers(1, 3, n_frames - 1)] for _ in range(b)]


def _assert_same(got, want, frame_start=True):
    det = got.steps.detected.numpy()
    np.testing.assert_array_equal(det, np.asarray(want.steps.detected))
    np.testing.assert_array_equal(
        got.steps.frame.payload.numpy()[det], np.asarray(want.steps.frame.payload)[det]
    )
    np.testing.assert_array_equal(got.steps.frame.ok.numpy(), np.asarray(want.steps.frame.ok))
    if frame_start:
        np.testing.assert_array_equal(
            got.steps.frame_start.numpy()[det], np.asarray(want.steps.frame_start)[det]
        )
    for f in ("frames_detected", "frames_ok", "decode_errors", "next_start", "locked", "last_frame_end"):
        np.testing.assert_array_equal(
            getattr(got.carry, f).numpy(), np.asarray(getattr(want.carry, f)), f
        )
    np.testing.assert_allclose(got.carry.drift.numpy(), np.asarray(want.carry.drift), atol=1e-6)


@pytest.mark.parametrize("lock", [False, True])
@pytest.mark.parametrize("layout", ["contiguous", "random_gaps", "slip"])
def test_receive_stream_matches_jax(layout, lock):
    rng = np.random.default_rng(sum(map(ord, layout)))
    gaps = _layout(layout, rng)
    cap = _capture(rng, gaps)
    want = jstream.receive_stream(JCFG, jnp.asarray(cap), CHUNK, PAY, lock=lock)
    got = tstream.receive_stream(CFG, cap, CHUNK, PAY, lock=lock, device="cpu")
    _assert_same(got, want)
    assert int(got.carry.frames_ok.sum()) == 3 * 4
    assert got.steps.frame.payload.shape == (cap.shape[1] // CHUNK, 3, PAY)


@pytest.mark.parametrize("lock", [False, True])
@pytest.mark.parametrize("layout", ["contiguous", "random_gaps", "slip"])
def test_coded_receive_stream_matches_jax(layout, lock):
    """mfsk4-coded through both packages' CPU paths: detections, payloads,
    verdicts, frame starts and carry counters bit-equal."""
    rng = np.random.default_rng(sum(map(ord, layout)) + 1)
    gaps = _layout(layout, rng, b=2, n_frames=3)
    cap = _capture(rng, gaps, noise=0.3, jcfg=JCCFG, pay=CPAY)
    want = jstream.receive_stream(JCCFG, jnp.asarray(cap), CHUNK, CPAY, lock=lock)
    got = tstream.receive_stream(CCFG, cap, CHUNK, CPAY, lock=lock, device="cpu")
    _assert_same(got, want)
    for v in ("magic_ok", "length_ok", "header_crc_ok", "payload_crc_ok"):
        det = got.steps.detected.numpy()
        np.testing.assert_array_equal(
            getattr(got.steps.frame, v).numpy()[det], np.asarray(getattr(want.steps.frame, v))[det], v
        )
    assert int(got.carry.frames_ok.sum()) == 2 * 3
    assert got.steps.frame.payload.shape == (cap.shape[1] // CHUNK, 2, CPAY)
    det = got.steps.detected.numpy()
    np.testing.assert_allclose(
        got.steps.frame.confidence.numpy()[det], np.asarray(want.steps.frame.confidence)[det], rtol=1e-4
    )


@pytest.mark.parametrize("lock", [False, True])
def test_coded_card_branch_matches_jax_kernels(interpret_tpu_kernels, monkeypatch, lock):
    """The coded stream's card branch (probe_at_fused when locked, then
    demod_at_energies_fused and viterbi_trellis) run through the plain
    versions on the CPU, against JAX's step with its Pallas kernels in
    interpret mode; bf16 buffers, frame starts at the row residues.
    Quality: rtol 1e-3 (bf16 inputs, float32 sums in another order)."""
    rng = np.random.default_rng(0xC0DE + lock)
    gaps = [[g, 0, 0] for g in (124, 125, 126, 127, 2)]
    cap = _capture(rng, gaps, noise=0.1, jcfg=JCCFG, pay=CPAY)
    calls = {"probe": 0, "energies": 0, "viterbi": 0}
    from anet_torch import kernels as tk

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(tstream, "_probe_kernel_supported", lambda carry: True)
    monkeypatch.setattr(tk, "probe_at_fused", counted("probe", tk.probe_at_fused))
    monkeypatch.setattr(tk, "demod_at_energies_fused", counted("energies", tk.demod_at_energies_fused))
    monkeypatch.setattr(tk, "viterbi_trellis", counted("viterbi", tk.viterbi_trellis))
    got = tstream.receive_stream(
        CCFG, torch.from_numpy(cap).to(torch.bfloat16), CHUNK, CPAY, lock=lock,
        compute_dtype=torch.bfloat16, device="cpu",
    )
    n_chunks = cap.shape[1] // CHUNK
    assert calls == {"probe": n_chunks if lock else 0, "energies": n_chunks, "viterbi": n_chunks}
    interpret_tpu_kernels()
    want = jstream.receive_stream(
        JCCFG, jnp.asarray(cap).astype(jnp.bfloat16), CHUNK, CPAY, lock=lock,
        compute_dtype=jnp.bfloat16, resident=False,
    )
    _assert_same(got, want)
    assert int(got.carry.frames_ok.sum()) == 5 * 3
    np.testing.assert_allclose(
        got.steps.quality.numpy(), np.asarray(want.steps.quality), rtol=1e-3, atol=1e-6
    )


def test_merged_lock_never_serves_coded_configs():
    carry = tstream.init_carry(CCFG, CHUNK, CPAY, (1,), device="cpu")
    assert not tstream._merged_lock_supported(CCFG, carry)
    assert not tstream._probe_kernel_supported(carry)


def test_merged_lock_step_matches_jax_kernels(interpret_tpu_kernels, monkeypatch):
    """The card's lock path (_locked_step_merged: demod_probe_fused, and on
    acquisition sync_search_fused + demod_at_fused) run through the plain
    versions on the CPU, against JAX's merged step with its Pallas kernels
    in interpret mode; bf16 buffers, frame starts at the row residues."""
    rng = np.random.default_rng(0x7E5)
    gaps = [[g, 0, 0] for g in (124, 125, 126, 127, 2)]
    cap = _capture(rng, gaps, noise=0.02)
    calls = []
    real = tstream._locked_step_merged
    monkeypatch.setattr(tstream, "_merged_lock_supported", lambda config, carry: True)
    monkeypatch.setattr(
        tstream, "_locked_step_merged", lambda *a, **k: calls.append(1) or real(*a, **k)
    )
    got = tstream.receive_stream(
        CFG, torch.from_numpy(cap).to(torch.bfloat16), CHUNK, PAY, lock=True,
        compute_dtype=torch.bfloat16, device="cpu",
    )
    assert len(calls) == cap.shape[1] // CHUNK
    interpret_tpu_kernels()
    want = jstream.receive_stream(
        JCFG, jnp.asarray(cap).astype(jnp.bfloat16), CHUNK, PAY, lock=True,
        compute_dtype=jnp.bfloat16, resident=False,
    )
    _assert_same(got, want)
    assert int(got.carry.frames_ok.sum()) == 5 * 3
    np.testing.assert_allclose(
        got.steps.quality.numpy(), np.asarray(want.steps.quality), rtol=1e-3, atol=1e-6
    )


def _checkpoint_crosses(tmp_path, lock, CFG, JCFG, PAY, b, noise=0.05, batch_shape=None, int8=False):
    """The crossings of a capture of ``b`` streams (shaped ``batch_shape``,
    default (b,)) cut in the middle; with ``int8`` every run starts from an
    int8 carry (the float capture quantized at ingest)."""
    rng = np.random.default_rng(11)
    cap = _capture(rng, _layout("random_gaps", rng, b=b), noise=noise, jcfg=JCFG, pay=PAY)
    shape = batch_shape if batch_shape is not None else (b,)
    cap = cap.reshape(*shape, cap.shape[-1])
    cut = (cap.shape[-1] // CHUNK // 2) * CHUNK

    def jcarry():
        return jstream.init_carry(JCFG, CHUNK, PAY, shape, dtype=jnp.int8) if int8 else None

    full = jstream.receive_stream(JCFG, jnp.asarray(cap), CHUNK, PAY, lock=lock, carry=jcarry())
    first = jstream.receive_stream(JCFG, jnp.asarray(cap[..., :cut]), CHUNK, PAY, lock=lock, carry=jcarry())
    path = tmp_path / "jax.npz"
    jstream.save_carry(path, first.carry)
    ckpt = tstream.load_carry(path, device="cpu")
    assert ckpt.carry.buffer.dtype == (torch.int8 if int8 else torch.float32)
    rest = tstream.receive_stream(CFG, cap[..., cut:], CHUNK, PAY, lock=lock, carry=ckpt.carry, device="cpu")
    n0 = cut // CHUNK
    np.testing.assert_array_equal(rest.steps.detected.numpy(), np.asarray(full.steps.detected)[n0:])
    det = rest.steps.detected.numpy()
    np.testing.assert_array_equal(
        rest.steps.frame.payload.numpy()[det], np.asarray(full.steps.frame.payload)[n0:][det]
    )
    for f in tstream.StreamCarry._fields:
        np.testing.assert_array_equal(
            getattr(rest.carry, f).float().numpy(), np.asarray(getattr(full.carry, f)).astype(np.float32), f
        )
    # the other way: the port checkpoints, JAX resumes
    carry = tstream.init_carry(CFG, CHUNK, PAY, shape, dtype=torch.int8, device="cpu") if int8 else None
    mid = tstream.receive_stream(CFG, cap[..., :cut], CHUNK, PAY, lock=lock, carry=carry, device="cpu")
    path2 = tmp_path / "torch.npz"
    tstream.save_carry(path2, mid.carry, pending=np.zeros(3, np.float32))
    back = jstream.load_carry(path2)
    assert back.pending.shape == (3,) and back.carry.buffer.dtype == (jnp.int8 if int8 else jnp.float32)
    tail = jstream.receive_stream(JCFG, jnp.asarray(cap[..., cut:]), CHUNK, PAY, lock=lock, carry=back.carry)
    np.testing.assert_array_equal(np.asarray(tail.carry.frames_ok), np.asarray(full.carry.frames_ok))
    np.testing.assert_array_equal(np.asarray(tail.carry.next_start), np.asarray(full.carry.next_start))
    np.testing.assert_array_equal(np.asarray(tail.steps.detected), np.asarray(full.steps.detected)[n0:])
    np.testing.assert_array_equal(
        np.asarray(tail.steps.frame.payload)[det], np.asarray(full.steps.frame.payload)[n0:][det]
    )
    return full


@pytest.mark.parametrize("lock", [False, True])
def test_jax_checkpoint_resumes_in_port(tmp_path, lock):
    """A checkpoint written by anet.stream.save_carry mid-capture resumes in
    anet_torch with the results of one uninterrupted JAX run; and the port's
    own checkpoint resumes in JAX."""
    _checkpoint_crosses(tmp_path, lock, CFG, JCFG, PAY, 3)


@pytest.mark.parametrize("lock", [False, True])
def test_coded_checkpoint_crosses_both_ways(tmp_path, lock):
    """The same on mfsk4-coded: a coded carry written by anet mid-capture
    resumes in anet_torch, and the other way round."""
    full = _checkpoint_crosses(tmp_path, lock, CCFG, JCCFG, CPAY, 2)
    assert int(np.asarray(full.carry.frames_ok).sum()) == 2 * 4


@pytest.mark.parametrize("lock", [False, True])
def test_scalar_checkpoint_crosses_both_ways(tmp_path, lock):
    """One stream with batch shape (), as anet's modem-stream-rx CLI builds
    its carry: a checkpoint of shape () written by anet.stream.save_carry
    resumes in anet_torch with the frames of one uninterrupted JAX run, and
    the port's resumes in anet."""
    full = _checkpoint_crosses(tmp_path, lock, CFG, JCFG, PAY, 1, batch_shape=())
    assert np.asarray(full.carry.frames_ok).shape == () and int(full.carry.frames_ok) == 4


def _assert_same_shapes(got, want):
    """Every field of the carry and of the stacked steps has the
    reference's shape."""
    for f in tstream.StreamCarry._fields:
        assert tuple(getattr(got.carry, f).shape) == np.shape(getattr(want.carry, f)), f
    for f in ("detected", "quality", "frame_start"):
        assert tuple(getattr(got.steps, f).shape) == np.shape(getattr(want.steps, f)), f
    for f in got.steps.frame._fields:
        assert tuple(getattr(got.steps.frame, f).shape) == np.shape(getattr(want.steps.frame, f)), f


@pytest.mark.parametrize("lock", [False, True])
@pytest.mark.parametrize("batch_shape", [(), (2, 3)], ids=["scalar", "2x3"])
def test_receive_stream_batch_shapes_match_jax(batch_shape, lock):
    """A 1-D capture (batch shape ()) and a [2, 3, N] one through both
    packages: every output and carry field with the reference's shape;
    detections, payloads, verdicts, frame starts and the carry equal."""
    rng = np.random.default_rng(31 + len(batch_shape))
    b = int(np.prod(batch_shape))
    cap = _capture(rng, _layout("random_gaps", rng, b=b, n_frames=3))
    cap = cap.reshape(*batch_shape, cap.shape[-1])
    want = jstream.receive_stream(JCFG, jnp.asarray(cap), CHUNK, PAY, lock=lock)
    got = tstream.receive_stream(CFG, cap, CHUNK, PAY, lock=lock, device="cpu")
    _assert_same_shapes(got, want)
    _assert_same(got, want)
    np.testing.assert_array_equal(got.carry.buffer.numpy(), np.asarray(want.carry.buffer))
    assert int(got.carry.frames_ok.sum()) == 3 * b


def test_stream_step_keeps_batch_shape():
    """stream_step on a [2, 3] carry: outputs [2, 3], equal to the same
    streams stepped as one flat batch of 6; a chunk of other batch axes
    raises."""
    rng = np.random.default_rng(5)
    cap = _capture(rng, _layout("contiguous", rng, b=6, n_frames=2))[:, : 2 * CHUNK]
    flat = tstream.init_carry(CFG, CHUNK, PAY, (6,), device="cpu")
    shaped = tstream.init_carry(CFG, CHUNK, PAY, (2, 3), device="cpu")
    for i in range(2):
        piece = torch.from_numpy(cap[:, i * CHUNK : (i + 1) * CHUNK])
        flat, fout = tstream.stream_step(CFG, flat, piece, PAY)
        shaped, sout = tstream.stream_step(CFG, shaped, piece.reshape(2, 3, CHUNK), PAY)
        assert sout.detected.shape == (2, 3) and sout.frame.payload.shape == (2, 3, PAY)
        assert torch.equal(sout.frame.payload.reshape(6, PAY), fout.frame.payload)
        assert torch.equal(sout.frame_start.reshape(6), fout.frame_start)
    for a, b in zip(shaped, flat):
        assert torch.equal(a.reshape(b.shape), b)
    with pytest.raises(ValueError, match="batch shape"):
        tstream.stream_step(CFG, shaped, piece, PAY)


def test_init_carry_default_shapes_match_jax():
    """init_carry() with no batch_shape: one stream, batch shape (), the
    reference's shapes and dtypes field by field."""
    got = tstream.init_carry(CFG, CHUNK, PAY, device="cpu")
    want = jstream.init_carry(JCFG, CHUNK, PAY)
    for f in tstream.StreamCarry._fields:
        g, w = getattr(got, f), np.asarray(getattr(want, f))
        assert tuple(g.shape) == w.shape, f
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), f
    assert got.buffer.dim() == 1


def test_carry_numpy_roundtrip_keeps_bf16():
    carry = tstream.init_carry(CFG, CHUNK, PAY, (2,), dtype=torch.bfloat16, device="cpu")
    carry = carry._replace(buffer=carry.buffer + torch.tensor(0.3, dtype=torch.bfloat16))
    fields = tstream.carry_to_numpy(carry)
    assert str(fields["buffer_dtype"]) == "bfloat16" and fields["buffer"].dtype == np.float32
    back = tstream.carry_from_numpy(fields, device="cpu")
    assert back.buffer.dtype == torch.bfloat16 and torch.equal(back.buffer, carry.buffer)
    for f in tstream.StreamCarry._fields:
        assert getattr(back, f).dtype == getattr(carry, f).dtype


def test_int8_carries_run_for_ofdm_and_variable_length():
    """An int8 carry for an OFDM config builds, and an int8 variable-length
    MFSK stream runs and decodes (the fixed-length MFSK receivers took int8
    carries before; now every receiver does, as the reference's)."""
    ocarry = tstream.init_carry(OCFG, CHUNK, OPAY, (1,), dtype=torch.int8, device="cpu")
    assert ocarry.buffer.dtype == torch.int8
    assert ocarry.buffer.shape == (1, tstream._buffer_len(OCFG, CHUNK, OPAY))
    rng = np.random.default_rng(0x5A)
    cap = _capture(rng, [[300, 0]], noise=0.05)
    carry8 = tstream.init_carry(CFG, CHUNK, PAY, (1,), dtype=torch.int8, device="cpu")
    res = tstream.receive_stream_dynamic(CFG, cap, CHUNK, PAY, carry=carry8, lock=True, device="cpu")
    assert res.carry.buffer.dtype == torch.int8
    assert int(res.carry.frames_ok.sum()) == 2 and not bool(res.carry.decode_errors.any())
    np.testing.assert_array_equal(res.steps.frame.payload_len.numpy()[res.steps.detected.numpy()], [PAY, PAY])


@pytest.mark.parametrize("lock", [False, True])
@pytest.mark.parametrize("layout", ["contiguous", "random_gaps"])
def test_ofdm_receive_stream_matches_jax(layout, lock):
    """ofdm-fast through both packages' CPU paths (the reference's
    test_lock_ofdm_equals_search layout and random gaps): detections,
    payloads, verdicts, frame starts and counters equal; confidence rtol
    1e-4."""
    rng = np.random.default_rng(31 + lock + len(layout))
    cap = _capture(rng, _layout(layout, rng, b=2, n_frames=3), noise=0.01, jcfg=JOCFG, pay=OPAY)
    want = jstream.receive_stream(JOCFG, jnp.asarray(cap), CHUNK, OPAY, lock=lock)
    got = tstream.receive_stream(OCFG, cap, CHUNK, OPAY, lock=lock, device="cpu")
    _assert_same(got, want)
    assert int(got.carry.frames_ok.sum()) == 2 * 3
    det = got.steps.detected.numpy()
    np.testing.assert_allclose(
        got.steps.frame.confidence.numpy()[det], np.asarray(want.steps.frame.confidence)[det], rtol=1e-4
    )


def test_ofdm_card_branch_matches_jax_kernels(interpret_tpu_kernels, monkeypatch):
    """The locked OFDM stream's card branch (probe_at_fused, the search on
    acquisition, the gather, ofdm_track_decide_fused) through the plain
    versions on the CPU, against JAX's step with its Pallas kernels in
    interpret mode; bf16 buffers."""
    from anet_torch import kernels as tk

    rng = np.random.default_rng(0x0FD)
    cap = _capture(rng, [[g, 0, 0] for g in (126, 127, 2)], noise=0.01, jcfg=JOCFG, pay=OPAY)
    calls = {"probe_at_fused": 0, "ofdm_track_decide_fused": 0}

    def counted(name):
        fn = getattr(tk, name)

        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)

        return wrapper

    monkeypatch.setattr(tstream, "_probe_kernel_supported", lambda carry: True)
    for name in calls:
        monkeypatch.setattr(tk, name, counted(name))
    got = tstream.receive_stream(
        OCFG, torch.from_numpy(cap).to(torch.bfloat16), CHUNK, OPAY, lock=True,
        compute_dtype=torch.bfloat16, device="cpu",
    )
    n_chunks = cap.shape[1] // CHUNK
    assert calls == {"probe_at_fused": n_chunks, "ofdm_track_decide_fused": n_chunks}
    interpret_tpu_kernels()
    want = jstream.receive_stream(
        JOCFG, jnp.asarray(cap).astype(jnp.bfloat16), CHUNK, OPAY, lock=True,
        compute_dtype=jnp.bfloat16, resident=False,
    )
    _assert_same(got, want)
    assert int(got.carry.frames_ok.sum()) == 3 * 3
    np.testing.assert_allclose(
        got.steps.quality.numpy(), np.asarray(want.steps.quality), rtol=1e-3, atol=1e-6
    )


def test_ofdm_checkpoint_crosses_both_ways(tmp_path):
    """An OFDM lock-mode carry (no demod tail pad: the same geometry in both
    packages) written by anet mid-capture resumes in anet_torch, and the
    other way round."""
    assert tstream._buffer_len(OCFG, CHUNK, OPAY) == jstream._buffer_len(JOCFG, CHUNK, OPAY)
    full = _checkpoint_crosses(tmp_path, True, OCFG, JOCFG, OPAY, 2, noise=0.01)
    assert int(np.asarray(full.carry.frames_ok).sum()) == 2 * 4


@pytest.mark.parametrize("lock", [False, True])
def test_ofdm_int8_receive_stream_matches_jax(lock, monkeypatch):
    """ofdm-fast on int8 carries in both packages (the float capture
    quantized at ingest; the window gathered in compute_dtype), with the
    card's probe route taken (_probe_kernel_supported patched): an int8
    buffer never reaches probe_at_fused, as the reference probes it with
    its row-aligned plain probe. Detections, payloads, verdicts, frame
    starts, counters and buffers equal; confidence rtol 1e-4."""
    from anet_torch import kernels as tk

    rng = np.random.default_rng(0x08F + lock)
    cap = _capture(rng, _layout("random_gaps", rng, b=2, n_frames=3), noise=0.01, jcfg=JOCFG, pay=OPAY)
    probes = []
    monkeypatch.setattr(tstream, "_probe_kernel_supported", lambda carry: True)
    monkeypatch.setattr(tk, "probe_at_fused", lambda *a, **k: probes.append(a))
    carry8 = tstream.init_carry(OCFG, CHUNK, OPAY, (2,), dtype=torch.int8, device="cpu")
    got = tstream.receive_stream(OCFG, cap, CHUNK, OPAY, lock=lock, carry=carry8, device="cpu")
    want = jstream.receive_stream(
        JOCFG, jnp.asarray(cap), CHUNK, OPAY, lock=lock,
        carry=jstream.init_carry(JOCFG, CHUNK, OPAY, (2,), dtype=jnp.int8),
    )
    assert not probes and got.carry.buffer.dtype == torch.int8
    _assert_same(got, want)
    np.testing.assert_array_equal(got.carry.buffer.numpy(), np.asarray(want.carry.buffer))
    assert int(got.carry.frames_ok.sum()) == 2 * 3
    det = got.steps.detected.numpy()
    np.testing.assert_allclose(
        got.steps.frame.confidence.numpy()[det], np.asarray(want.steps.frame.confidence)[det], rtol=1e-4
    )


def test_ofdm_int8_checkpoint_crosses_both_ways(tmp_path):
    """An int8 OFDM lock-mode carry written by anet mid-capture resumes in
    anet_torch, and the other way round, dtype and buffer kept."""
    full = _checkpoint_crosses(tmp_path, True, OCFG, JOCFG, OPAY, 2, noise=0.01, int8=True)
    assert int(np.asarray(full.carry.frames_ok).sum()) == 2 * 4


def test_ofdm_stream_refusals_and_routes():
    """OFDM never takes the merged MFSK kernel; track=True raises ValueError
    (the reference's word: OFDM tracks its clock in the receiver)."""
    carry = tstream.init_carry(OCFG, CHUNK, OPAY, (1,), device="cpu")
    assert not tstream._merged_lock_supported(OCFG, carry)
    cap = np.zeros((1, CHUNK), np.float32)
    with pytest.raises(ValueError, match="clock_tracking"):
        tstream.receive_stream(OCFG, cap, CHUNK, OPAY, track=True, device="cpu")
