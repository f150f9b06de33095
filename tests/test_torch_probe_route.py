"""The lock probe's route by buffer dtype, anet_torch against the JAX
package on the CPU. The reference takes its probe kernel (probe_at_fused,
whose window energy spans from the first probed lag) for bfloat16 buffers
only, and probes float32 and int8 buffers with
sync.preamble_quality_probe (the energy over the row-aligned span). The
card's branch is driven here with _probe_kernel_supported patched to True:
for float32 and int8 carries it must still take the plain row-aligned
probe, call probe_at_fused no time, and emit the reference's quality
(rtol 1e-5: float32 sums in another order) and the same detections, frame
starts and verdicts. Locked streams (3 streams x 3 frames) with a float32 carry on mfsk4-coded,
ofdm-fast and the variable-length lock receiver, and an int8 carry (bf16
compute) on mfsk4-coded."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anet import stream as jstream
from anet.dsp import family as jfamily
from anet.models import get_model as jget_model

import anet_torch.stream as tstream
from anet_torch import kernels as tk
from anet_torch.dsp import family as tfamily
from anet_torch.models import get_model

CHUNK = 4096
RTOL = 1e-5
# (model, payload bytes, carry dtype, compute dtype, variable-length
# receiver, noise): ofdm-fast decodes no frame at noise 0.05, and an
# unlocked stream never reaches the probe's gate
CASES = {
    "coded-f32": ("mfsk4-coded", 32, torch.float32, torch.float32, False, 0.3),
    "ofdm-f32": ("ofdm-fast", 224, torch.float32, torch.float32, False, 0.03),
    "dynamic-f32": ("mfsk16-fast", 48, torch.float32, torch.float32, True, 0.3),
    "coded-int8": ("mfsk4-coded", 32, torch.int8, torch.bfloat16, False, 0.3),
}
JDTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16, torch.int8: jnp.int8}


def _capture(rng, jcfg, pay, gaps, noise):
    """[B, N] f32 capture: per stream, each frame after its leading gap,
    then zeros to whole chunks past one more frame."""
    b, n_frames = len(gaps), len(gaps[0])
    t_frame = jfamily.frame_samples(jcfg, pay)
    pays = rng.integers(0, 256, (b * n_frames, pay), dtype=np.uint8)
    waves = np.asarray(jax.jit(jfamily.transmit_fn(jcfg))(jnp.asarray(pays))).reshape(b, n_frames, t_frame)
    caps = [
        np.concatenate([x for i, g in enumerate(gs) for x in (np.zeros(g, np.float32), waves[s, i])])
        for s, gs in enumerate(gaps)
    ]
    length = -(-(max(map(len, caps)) + t_frame + CHUNK) // CHUNK) * CHUNK
    out = np.zeros((b, length), np.float32)
    for s, c in enumerate(caps):
        out[s, : len(c)] = c
    return out + noise * rng.standard_normal(out.shape).astype(np.float32)


def _dynamic_capture(rng, cfg, lens, chunk, b, noise, gap0=127, max_pay=48):
    """[B, N] f32 capture of the variable-length receiver: gap0 zeros, the
    frames back to back, a max-length frame of zeros, whole chunks."""
    tx = tfamily.transmit_fn(cfg, device="cpu")
    parts = [np.zeros((b, gap0), np.float32)]
    parts += [tx(rng.integers(0, 256, (b, n), dtype=np.uint8)).numpy() for n in lens]
    parts.append(np.zeros((b, tfamily.frame_samples(cfg, max_pay) + 300), np.float32))
    cap = np.concatenate(parts, -1)
    cap = np.concatenate([cap, np.zeros((b, -cap.shape[1] % chunk), np.float32)], -1)
    return cap + noise * rng.standard_normal(cap.shape).astype(np.float32)


@pytest.mark.parametrize("case", list(CASES))
def test_lock_probe_takes_reference_route(monkeypatch, case):
    model, pay, dtype, compute, dynamic, noise = CASES[case]
    cfg, jcfg = get_model(model).config, jget_model(model).config
    rng = np.random.default_rng(0x9B0 + len(case))
    calls = {"probe_at_fused": 0}
    real = tk.probe_at_fused

    def counted(*a, **k):
        calls["probe_at_fused"] += 1
        return real(*a, **k)

    monkeypatch.setattr(tstream, "_probe_kernel_supported", lambda carry: True)
    monkeypatch.setattr(tk, "probe_at_fused", counted)
    if dynamic:
        lens = (8, 48, 24)
        chunk = jfamily.frame_samples(jcfg, min(lens)) // 128 * 128
        cap = _dynamic_capture(rng, cfg, lens, chunk, 3, noise)
        got = tstream.receive_stream_dynamic(cfg, cap, chunk, 48, lock=True, device="cpu")
        want = jstream.receive_stream_dynamic(jcfg, jnp.asarray(cap), chunk, 48, lock=True)
    else:
        cap = _capture(rng, jcfg, pay, [[450 + 131 * s, 0, 0] for s in range(3)], noise)
        carry = tstream.init_carry(cfg, CHUNK, pay, (3,), dtype=dtype, device="cpu")
        jcarry = jstream.init_carry(jcfg, CHUNK, pay, (3,), dtype=JDTYPES[dtype])
        got = tstream.receive_stream(
            cfg, cap, CHUNK, pay, lock=True, carry=carry, compute_dtype=compute, device="cpu"
        )
        want = jstream.receive_stream(
            jcfg, jnp.asarray(cap), CHUNK, pay, lock=True, carry=jcarry, compute_dtype=JDTYPES[compute]
        )
        assert got.carry.buffer.dtype == dtype
    assert calls == {"probe_at_fused": 0}
    # every frame decodes, so every stream locked after its first
    assert np.asarray(want.carry.frames_ok).tolist() == [3] * 3
    det = got.steps.detected.numpy()
    np.testing.assert_array_equal(det, np.asarray(want.steps.detected))
    np.testing.assert_array_equal(got.steps.frame_start.numpy()[det], np.asarray(want.steps.frame_start)[det])
    np.testing.assert_array_equal(got.steps.frame.ok.numpy(), np.asarray(want.steps.frame.ok))
    for f in ("frames_detected", "frames_ok", "next_start", "locked", "last_frame_end"):
        np.testing.assert_array_equal(getattr(got.carry, f).numpy(), np.asarray(getattr(want.carry, f)), f)
    np.testing.assert_allclose(got.steps.quality.numpy(), np.asarray(want.steps.quality), rtol=RTOL, atol=1e-7)
