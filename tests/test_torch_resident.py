"""The capture-resident lock scan (stream._receive_stream_resident) on the
CPU, where its kernels run their plain versions: against the port's own
carry path and against the JAX package's carry path with bf16 compute
(``anet.stream.receive_stream(lock=True)``; test_stream_lock.py pins the
JAX package's resident scan to that path), on mfsk16-fast (payload 64,
chunk 4,096) with bf16 captures. Frames (detections, payloads, verdicts,
frame starts), the final carry's buffer and every counter are equal; so are
a warm-lock seed's and a checkpoint's continuation. Also the probe's
``start_bound`` and the ``resident`` refusals."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anet import stream as jstream
from anet.dsp import family as jfamily
from anet.dsp import sync as jsync
from anet.models import get_model as jget_model

import anet_torch.stream as tstream
from anet_torch.dsp import sync as tsync
from anet_torch.dsp.params import ModemConfig
from anet_torch.models import get_model

NAME = "mfsk16-fast"
CFG, JCFG = get_model(NAME).config, jget_model(NAME).config
PAY = 64
T_FRAME = jfamily.frame_samples(JCFG, PAY)
CHUNK = 4096
B, N_FRAMES = 3, 5
LENGTH = 32 * CHUNK  # every layout's capture: one compile of the reference's scan


def _capture(layout: str, seed: int) -> np.ndarray:
    """bf16-valued float32 capture [B, LENGTH]: per stream, each frame after
    its gap (450 then back to back, or random gaps up to three chunks), in
    white noise of 0.05."""
    rng = np.random.default_rng(seed)
    if layout == "contiguous":
        gaps = [[450] + [0] * (N_FRAMES - 1) for _ in range(B)]
    else:
        gaps = [[int(g) for g in rng.integers(0, 3 * CHUNK, N_FRAMES)] for _ in range(B)]
    pays = rng.integers(0, 256, (B * N_FRAMES, PAY), dtype=np.uint8)
    waves = np.asarray(jax.jit(jfamily.transmit_fn(JCFG))(jnp.asarray(pays))).reshape(B, N_FRAMES, T_FRAME)
    out = np.zeros((B, LENGTH), np.float32)
    for s in range(B):
        pos = 0
        for i, g in enumerate(gaps[s]):
            pos += g
            out[s, pos : pos + T_FRAME] = waves[s, i]
            pos += T_FRAME
    out += 0.05 * rng.standard_normal(out.shape).astype(np.float32)
    return np.asarray(jnp.asarray(out).astype(jnp.bfloat16).astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def _jax_lock_stream():
    return jax.jit(functools.partial(
        jstream.receive_stream, JCFG, chunk_size=CHUNK, payload_len=PAY, lock=True,
        compute_dtype=jnp.bfloat16,
    ))


def _bf16(cap: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(cap).to(torch.bfloat16)


def _assert_same(got, want):
    """Frames and the final carry equal, ``want`` from either package."""
    w = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32 if a.dtype == jnp.bfloat16 else None), want)
    det = got.steps.detected.numpy()
    np.testing.assert_array_equal(det, np.asarray(w.steps.detected))
    np.testing.assert_array_equal(got.steps.frame.ok.numpy(), np.asarray(w.steps.frame.ok))
    for f in ("payload", "magic_ok", "header_crc_ok", "payload_crc_ok"):
        np.testing.assert_array_equal(
            getattr(got.steps.frame, f).numpy()[det], np.asarray(getattr(w.steps.frame, f))[det], f
        )
    np.testing.assert_array_equal(got.steps.frame_start.numpy()[det], np.asarray(w.steps.frame_start)[det])
    for f in tstream.StreamCarry._fields:
        np.testing.assert_array_equal(
            getattr(got.carry, f).float().numpy(), np.asarray(getattr(w.carry, f), np.float32), f
        )


def _to_numpy(result):
    """A port StreamResult as numpy (bf16 widened), for _assert_same."""
    return jax.tree_util.tree_map(lambda t: t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy(), result)


@pytest.mark.parametrize("layout", ["contiguous", "random_gaps"])
def test_resident_equals_carry_path_and_jax(layout):
    cap = _capture(layout, seed=sum(map(ord, layout)))
    got = tstream._receive_stream_resident(CFG, _bf16(cap), CHUNK, PAY, 0.45, torch.bfloat16, None)
    carry_path = tstream.receive_stream(
        CFG, _bf16(cap), CHUNK, PAY, lock=True, compute_dtype=torch.bfloat16, device="cpu"
    )
    want = _jax_lock_stream()(jnp.asarray(cap).astype(jnp.bfloat16))
    _assert_same(got, _to_numpy(carry_path))
    _assert_same(got, want)
    assert int(got.carry.frames_ok.sum()) == B * N_FRAMES
    assert got.carry.buffer.dtype == torch.bfloat16
    assert got.carry.buffer.shape == (B, tstream._buffer_len(CFG, CHUNK, PAY))


def test_resident_warm_lock_seed_and_checkpoint_resume():
    """A warm-lock seed (the lock set at the first frame) gives the carry
    path's frames; the resident scan's final carry resumes on the carry
    path of either package as if one carry path had run throughout."""
    cap = _capture("contiguous", seed=99)
    seed = tstream.init_carry(CFG, CHUNK, PAY, (B,), dtype=torch.bfloat16, device="cpu")
    seed = seed._replace(locked=torch.ones_like(seed.locked), next_start=torch.full_like(seed.next_start, 450))
    got = tstream._receive_stream_resident(CFG, _bf16(cap), CHUNK, PAY, 0.45, torch.bfloat16, seed)
    want = tstream.receive_stream(
        CFG, _bf16(cap), CHUNK, PAY, carry=seed, lock=True, compute_dtype=torch.bfloat16, device="cpu"
    )
    _assert_same(got, _to_numpy(want))
    assert int(got.carry.frames_ok.sum()) == B * N_FRAMES
    # the warm seed skipped the search on the first frame's chunk
    first = int(np.argmax(got.steps.detected.numpy()[:, 0]))
    assert float(got.steps.quality[first, 0]) > 0.9

    half = LENGTH // 2
    head = tstream._receive_stream_resident(CFG, _bf16(cap[:, :half]), CHUNK, PAY, 0.45, torch.bfloat16, None)
    whole = tstream.receive_stream(CFG, _bf16(cap), CHUNK, PAY, lock=True, compute_dtype=torch.bfloat16, device="cpu")
    tail = tstream.receive_stream(
        CFG, _bf16(cap[:, half:]), CHUNK, PAY, carry=head.carry, lock=True, compute_dtype=torch.bfloat16,
        device="cpu",
    )
    for f in tstream.StreamCarry._fields:
        assert torch.equal(getattr(tail.carry, f), getattr(whole.carry, f)), f
    fields = tstream.carry_to_numpy(head.carry)
    jcarry = jstream.StreamCarry(**{
        f: jnp.asarray(fields[f]).astype(jnp.bfloat16) if f == "buffer" else jnp.asarray(fields[f])
        for f in jstream.StreamCarry._fields
    })
    jtail = jstream.receive_stream(
        JCFG, jnp.asarray(cap[:, half:]).astype(jnp.bfloat16), CHUNK, PAY, carry=jcarry, lock=True,
        compute_dtype=jnp.bfloat16,
    )
    for f in ("frames_detected", "frames_ok", "decode_errors", "last_frame_end", "next_start", "locked"):
        np.testing.assert_array_equal(getattr(whole.carry, f).numpy(), np.asarray(getattr(jtail.carry, f)), f)


@pytest.mark.parametrize("bound", [0, 300, 4096 + 256])
def test_probe_start_bound_equals_unbounded(bound):
    """preamble_quality_probe(start_bound=...) reads the head a bounded
    start reaches and gives the unbounded call's values bit for bit, and
    the reference's bounded call's (st0 equal, quality within rtol 1e-4 +
    1e-7 absolute: noise windows' 2,048-term sums cancel)."""
    rng = np.random.default_rng(bound)
    buf = rng.standard_normal((4, 6 * CHUNK)).astype(np.float32)
    starts = np.minimum(rng.integers(0, bound + 1, 4), bound).astype(np.int32)
    tpl = tsync.preamble_waveform(CFG, device="cpu").to(torch.bfloat16)
    te = float((tpl.float() ** 2).sum())
    b = torch.from_numpy(buf).to(torch.bfloat16)
    st = torch.from_numpy(starts)
    q0, s0 = tsync.preamble_quality_probe(b, st, tpl, te, compute_dtype=torch.bfloat16)
    q1, s1 = tsync.preamble_quality_probe(b, st, tpl, te, compute_dtype=torch.bfloat16, start_bound=bound)
    assert torch.equal(q0, q1) and torch.equal(s0, s1)
    jq, js = jsync.preamble_quality_probe(
        jnp.asarray(buf).astype(jnp.bfloat16), jnp.asarray(starts), jnp.asarray(tpl.float().numpy()).astype(jnp.bfloat16),
        te, compute_dtype=jnp.bfloat16, start_bound=bound,
    )
    np.testing.assert_array_equal(s1.numpy(), np.asarray(js))
    # the reference's quality: 2,048-term float32 sums in another order
    np.testing.assert_allclose(q1.numpy(), np.asarray(jq), rtol=1e-4, atol=1e-7)
    with pytest.raises(ValueError, match="start_bound"):
        tsync.preamble_quality_probe(b, st, tpl, te, start_bound=-1)


def test_resident_refusals():
    """resident=True needs lock=True and the card's geometry: the CPU, a
    coded config, float32 compute and tracking raise ValueError, as the JAX
    package refuses every backend but its TPU; so does a geometry outside
    the JAX package's gate, 128 % sps != 0 (mfsk8-audible, sps 48), while
    every one inside it is taken, at any tone count (sps 16 with 4 tones,
    sps 128 with 32: the align+demod kernels' runtime-geometry walk);
    resident=None on the CPU is the carry path."""
    cap = _capture("contiguous", seed=5)[:, : 8 * CHUNK]
    with pytest.raises(ValueError, match="requires lock=True"):
        tstream.receive_stream(CFG, cap, CHUNK, PAY, resident=True, compute_dtype=torch.bfloat16, device="cpu")
    with pytest.raises(ValueError, match="fused-demod geometry"):
        tstream.receive_stream(
            CFG, cap, CHUNK, PAY, lock=True, resident=True, compute_dtype=torch.bfloat16, device="cpu"
        )
    with pytest.raises(ValueError, match="requires lock=True"):
        jstream.receive_stream(JCFG, jnp.asarray(cap), CHUNK, PAY, resident=True)
    with pytest.raises(ValueError, match="fused-demod geometry"):
        jstream.receive_stream(JCFG, jnp.asarray(cap), CHUNK, PAY, lock=True, resident=True)
    cuda = torch.device("cuda")
    coded = get_model("mfsk4-coded").config
    assert tstream._resident_supported(CFG, torch.bfloat16, False, cuda)
    assert not tstream._resident_supported(CFG, torch.bfloat16, False, torch.device("cpu"))
    assert not tstream._resident_supported(coded, torch.bfloat16, False, cuda)
    assert not tstream._resident_supported(CFG, torch.float32, False, cuda)
    assert not tstream._resident_supported(CFG, torch.bfloat16, True, cuda)
    for cfg, taken in ((ModemConfig(48_000, 3_000, num_tones=4), True),
                       (ModemConfig(48_000, 375, num_tones=32), True),
                       (get_model("mfsk8-audible").config, False)):
        assert tstream._resident_supported(cfg, torch.bfloat16, False, cuda) == taken
    auto = tstream.receive_stream(CFG, cap, CHUNK, PAY, lock=True, compute_dtype=torch.bfloat16, device="cpu")
    carry_path = tstream.receive_stream(
        CFG, cap, CHUNK, PAY, lock=True, resident=False, compute_dtype=torch.bfloat16, device="cpu"
    )
    _assert_same(auto, _to_numpy(carry_path))
