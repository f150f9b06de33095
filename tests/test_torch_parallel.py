"""The scale-out layer, anet_torch.parallel on 8 CPU positions against
anet.parallel on JAX's 8 virtual CPU devices, at the sizes of
test_stream_parallel.py (ModemConfig(symbol_rate_hz=1500, num_tones=4,
preamble_symbols=16), payload 32, chunk 512) on the same numpy captures.

The sharded receivers' detections, frame starts, payloads, verdicts,
counters and resume state are held bit-equal; quality rtol 1e-3 and
confidence rtol 1e-4 (float32 sums in another order, the port's stream
tests' tolerances), snr_db atol 1e-3 dB. ber_sweep draws its payloads and
noise from torch generators, so it is held to the reference's totals, to
its extremes and within a binomial tolerance at a middle point."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anet import parallel as jpar
from anet.dsp import ModemConfig as JModemConfig
from anet.models import get_model as jget_model

from anet_torch import parallel as tpar
from anet_torch.channel import apply_channel, ChannelConfig
from anet_torch.dsp import family as tfamily
from anet_torch.dsp.frame import frame_num_samples
from anet_torch.dsp.params import ModemConfig
from anet_torch.models import get_model
from anet_torch.stream import receive_stream, receive_stream_dynamic

KW = dict(symbol_rate_hz=1500, num_tones=4, preamble_symbols=16)
CFG, JCFG = ModemConfig(**KW), JModemConfig(**KW)
PAY = 32
CHUNK = 512
MAX_DYN = 32
N_POS = 8
FRAME_FIELDS = ("ok", "magic_ok", "length_ok", "header_crc_ok", "payload_crc_ok")


@pytest.fixture(scope="module")
def mesh():
    return tpar.make_mesh(N_POS, device="cpu")


def _tx(cfg, payload):
    return tfamily.transmit_fn(cfg, device="cpu")(np.asarray(payload)).numpy()


def _place(total, placements, seed, cfg=CFG, noise=0.08):
    """A [total]-sample float32 capture with frames at (start, payload)
    placements plus seeded white noise; returns (capture, placements)."""
    rng = np.random.default_rng(seed)
    cap = np.zeros(total, np.float32)
    for start, p in placements:
        w = _tx(cfg, p)
        assert start + len(w) <= total
        cap[start : start + len(w)] = w
    return cap + noise * rng.standard_normal(total).astype(np.float32)


def _gapped(gaps, seed, align, cfg=CFG, pay=PAY):
    """Frames after the given gaps, 4,000 samples of tail, whole ``align``
    blocks: (capture, starts, payloads)."""
    rng = np.random.default_rng(seed)
    t = tfamily.frame_samples(cfg, pay)
    starts, pos = [], 0
    for g in gaps:
        pos += g
        starts.append(pos)
        pos += t
    total = -(-(pos + 4000) // align) * align
    payloads = [rng.integers(0, 256, pay, dtype=np.uint8) for _ in gaps]
    return _place(total, list(zip(starts, payloads)), seed + 100, cfg), starts, payloads


def _assert_steps(got, want, dynamic=False):
    det = got.detected.numpy()
    np.testing.assert_array_equal(det, np.asarray(want.detected))
    np.testing.assert_array_equal(got.frame_start.numpy()[det], np.asarray(want.frame_start)[det])
    np.testing.assert_array_equal(got.frame.payload.numpy()[det], np.asarray(want.frame.payload)[det])
    np.testing.assert_array_equal(got.frame.ok.numpy(), np.asarray(want.frame.ok))
    for f in FRAME_FIELDS + (("payload_len",) if dynamic else ()):
        np.testing.assert_array_equal(
            getattr(got.frame, f).numpy()[det], np.asarray(getattr(want.frame, f))[det], f
        )
    np.testing.assert_allclose(got.quality.numpy(), np.asarray(want.quality), rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(
        got.frame.confidence.numpy()[det], np.asarray(want.frame.confidence)[det], rtol=1e-4
    )
    np.testing.assert_allclose(
        got.frame.snr_db.numpy()[det], np.asarray(want.frame.snr_db)[det], atol=1e-3
    )


def _assert_result(got, want, dynamic=False):
    _assert_steps(got.steps, want.steps, dynamic)
    for f in ("frames_detected", "frames_ok", "decode_errors"):
        assert int(getattr(got, f)) == int(getattr(want, f)), f
    assert (got.resume is None) == (want.resume is None)
    if want.resume is not None:
        for f in ShardedResumeFields:
            g, w = getattr(got.resume, f).numpy(), np.asarray(getattr(want.resume, f))
            assert g.shape == w.shape, f
            np.testing.assert_array_equal(g, w, f)


ShardedResumeFields = tpar.ShardedResume._fields


# --- meshes ------------------------------------------------------------------


def test_meshes_match_jax_layout(mesh):
    assert mesh.devices.size == jpar.make_mesh().devices.size == N_POS
    assert mesh.axis_names == jpar.make_mesh().axis_names == (tpar.STREAM_AXIS,)
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert tpar.make_mesh(device="cpu").devices.size == 1
    for n_s, n_t in ((4, 2), (2, 4)):
        got, want = tpar.make_mesh_2d(n_s, n_t, device="cpu"), jpar.make_mesh_2d(n_s, n_t)
        assert got.shape == dict(want.shape) == {"streams": n_s, "time": n_t}
        assert got.devices.shape == want.devices.shape
    assert tpar.Mesh([torch.device("cpu")] * 3, ("x",)).shape == {"x": 3}


def test_make_mesh_2d_refuses_more_cards_than_exist(monkeypatch):
    with pytest.raises(ValueError) as want:
        jpar.make_mesh_2d(4, 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    with pytest.raises(ValueError) as got:
        tpar.make_mesh_2d(4, 4)
    assert str(got.value) == str(want.value) == "mesh 4x4 needs 16 devices, have 8"
    assert tpar.make_mesh().devices.size == 8
    assert tpar.make_mesh(3).devices.tolist() == [torch.device("cuda", i) for i in range(3)]


def test_shard_streams_splits_the_leading_axis(mesh):
    x = np.arange(16 * 5, dtype=np.float32).reshape(16, 5)
    parts = tpar.shard_streams(mesh, x)
    assert len(parts) == N_POS and all(p.shape == (2, 5) for p in parts)
    np.testing.assert_array_equal(torch.cat(parts).numpy(), x)
    grid = tpar.shard_streams(tpar.make_mesh_2d(4, 2, device="cpu"), x)
    assert [p.shape for p in grid] == [(4, 5)] * 4


# --- sharded demod and the BER sweep ------------------------------------------


@pytest.mark.parametrize("family", ["mfsk", "ofdm"])
@pytest.mark.parametrize("sharded_input", [False, True])
def test_sharded_demodulate_matches_jax(mesh, family, sharded_input):
    cfg, jcfg = (CFG, JCFG) if family == "mfsk" else (get_model("ofdm-fast").config, jget_model("ofdm-fast").config)
    rng = np.random.default_rng(0)
    payloads = rng.integers(0, 256, (16, PAY), np.uint8)
    waves = _tx(cfg, payloads)
    sigma = 0.1 * np.sqrt((waves**2).mean())  # 20 dB
    waves = waves + sigma * rng.standard_normal(waves.shape).astype(np.float32)
    want = jpar.sharded_demodulate(jcfg, jpar.make_mesh(), jpar.shard_streams(jpar.make_mesh(), jnp.asarray(waves)), PAY)
    got = tpar.sharded_demodulate(cfg, mesh, tpar.shard_streams(mesh, waves) if sharded_input else waves, PAY)
    assert got.payload.shape == (16, PAY)
    for f in ("payload",) + FRAME_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), f)
    assert bool(got.ok.all())
    np.testing.assert_array_equal(got.payload.numpy(), payloads)
    np.testing.assert_allclose(got.confidence.numpy(), np.asarray(want.confidence), rtol=1e-4)
    np.testing.assert_allclose(got.snr_db.numpy(), np.asarray(want.snr_db), atol=1e-3)


def test_popcount8_counts_every_byte():
    x = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    want = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1)
    np.testing.assert_array_equal(tpar._popcount8(x).numpy(), want)
    np.testing.assert_array_equal(np.asarray(jpar._popcount8(jnp.arange(256, dtype=jnp.uint8))), want)


SWEEP_GRID = [-14.0, -8.0, -2.0, 40.0]
SWEEP_FRAMES = 64


@pytest.fixture(scope="module")
def sweeps(mesh):
    got = tpar.ber_sweep(CFG, mesh, torch.Generator().manual_seed(0), SWEEP_GRID, SWEEP_FRAMES, PAY)
    want = jpar.ber_sweep(JCFG, jpar.make_mesh(), jax.random.PRNGKey(0), SWEEP_GRID, SWEEP_FRAMES, PAY)
    return got, want


def test_ber_sweep_totals_and_extremes_match_jax(sweeps):
    got, want = sweeps
    np.testing.assert_array_equal(got.total_frames.numpy(), np.asarray(want.total_frames))
    np.testing.assert_array_equal(got.total_bits.numpy(), np.asarray(want.total_bits))
    assert got.total_bits.tolist() == [SWEEP_FRAMES * PAY * 8] * len(SWEEP_GRID)
    np.testing.assert_array_equal(got.snr_db.numpy(), np.asarray(want.snr_db))
    for pt in (got, want):
        ber, fer = np.asarray(pt.ber), np.asarray(pt.fer)
        assert int(np.asarray(pt.bit_errors)[-1]) == 0 and int(np.asarray(pt.frame_errors)[-1]) == 0
        assert fer[0] == 1.0
        # the reference test's monotone-and-extremes assertions
        assert ber[0] > ber[1] > ber[2]
        assert ber[0] > 0.2 and ber[2] < 0.05


def test_ber_sweep_middle_point_agrees_with_jax(mesh):
    """FER at a point on the waterfall: frames are the independent unit, so
    each package's FER is a binomial proportion over its frames; the two
    agree within 4 standard errors of their difference."""
    grid, frames = [-1.0], 256
    got = tpar.ber_sweep(CFG, mesh, torch.Generator().manual_seed(1), grid, frames, PAY)
    want = jpar.ber_sweep(JCFG, jpar.make_mesh(), jax.random.PRNGKey(1), grid, frames, PAY)
    p_got, p_want = float(got.fer[0]), float(np.asarray(want.fer)[0])
    p = (p_got + p_want) / 2
    assert 0.05 < p < 0.95, p
    assert abs(p_got - p_want) <= 4 * np.sqrt(2 * p * (1 - p) / frames), (p_got, p_want)


def test_ber_sweep_ofdm_family(mesh):
    ocfg = get_model("ofdm-fast").config
    pt = tpar.ber_sweep(ocfg, mesh, torch.Generator().manual_seed(0), [4.0, 30.0], 16, 32)
    assert pt.total_bits.tolist() == [16 * 32 * 8] * 2
    assert float(pt.ber[0]) > 0.02 and float(pt.ber[1]) == 0.0


def test_sweep_channel_noise_power_per_row():
    """apply_channel with a [G] SNR on [streams, G, T] waves (the sweep's one
    batched call) gives every row the noise power of its point against its
    own signal power, within 4 sqrt(2 / T) (the relative spread of a
    chi-square over T samples)."""
    rng = np.random.default_rng(5)
    snr = torch.tensor([-6.0, 0.0, 6.0, 12.0])
    waves = torch.as_tensor(_tx(CFG, rng.integers(0, 256, (8, 4, PAY), np.uint8)))
    waves = waves * torch.linspace(0.25, 2.0, 8)[:, None, None]  # unequal row powers
    noisy = apply_channel(torch.Generator().manual_seed(3), waves, ChannelConfig(), snr_db=snr, device="cpu")
    t = waves.shape[-1]
    measured = ((noisy - waves) ** 2).mean(-1)
    target = (waves**2).mean(-1) / 10.0 ** (snr / 10.0)
    rel = (measured / target - 1).abs()
    assert float(rel.max()) < 4 * np.sqrt(2 / t), float(rel.max())


def test_ber_sweep_validates_divisibility(mesh):
    with pytest.raises(ValueError) as want:
        jpar.ber_sweep(JCFG, jpar.make_mesh(), jax.random.PRNGKey(0), [0.0], frames_per_point=3)
    with pytest.raises(ValueError) as got:
        tpar.ber_sweep(CFG, mesh, torch.Generator(), [0.0], frames_per_point=3)
    assert str(got.value) == str(want.value)


# --- one long capture split along time ----------------------------------------


@pytest.mark.parametrize(
    "layout,lock",
    [("boundary", False), ("boundary", True), ("back_to_back", False), ("back_to_back", True)],
)
def test_long_capture_matches_jax(mesh, layout, lock):
    gaps = [9000, 8200, 7900, 9500, 8700] if layout == "boundary" else [9000, 0, 0, 0, 7000, 0]
    cap, starts, payloads = _gapped(gaps, seed=len(gaps), align=N_POS * CHUNK)
    want = jpar.sharded_receive_long_capture(JCFG, jpar.make_mesh(), jnp.asarray(cap), CHUNK, PAY, lock=lock)
    got = tpar.sharded_receive_long_capture(CFG, mesh, cap, CHUNK, PAY, lock=lock)
    _assert_result(got, want)
    assert int(got.frames_ok) == len(gaps) and int(got.decode_errors) == 0
    det = got.steps.detected.numpy()
    if not lock:
        assert got.steps.frame_start.numpy()[det].tolist() == starts
    np.testing.assert_array_equal(got.steps.frame.payload.numpy()[det], np.stack(payloads))
    # the unsharded receiver finds the same frames
    local = receive_stream(CFG, cap, CHUNK, PAY, lock=lock, device="cpu")
    np.testing.assert_array_equal(local.steps.detected.numpy(), det)
    assert int(local.carry.frames_ok) == int(got.frames_ok)


def test_long_capture_takes_shard_streams_tuple(mesh):
    cap, _, _ = _gapped([9000, 9100, 9200], seed=3, align=N_POS * CHUNK)
    a = tpar.sharded_receive_long_capture(CFG, mesh, cap, CHUNK, PAY)
    b = tpar.sharded_receive_long_capture(CFG, mesh, tpar.shard_streams(mesh, cap), CHUNK, PAY)
    _assert_result(a, b)
    assert int(a.frames_ok) == 3


def test_long_capture_resume_across_super_steps_matches_jax(mesh):
    t_frame = frame_num_samples(CFG, PAY)
    seg = -(-(t_frame + CHUNK) // CHUNK) * CHUNK
    half = N_POS * seg
    gap2 = half - (700 + t_frame) - t_frame // 2  # the second frame straddles the super-steps
    cap, starts, _ = _gapped([700, gap2, 900], seed=11, align=2 * half)
    cap = cap[: 2 * half]
    assert starts[1] == half - t_frame // 2
    jmesh = jpar.make_mesh()
    j1 = jpar.sharded_receive_long_capture(JCFG, jmesh, jnp.asarray(cap[:half]), CHUNK, PAY)
    j2 = jpar.sharded_receive_long_capture(JCFG, jmesh, jnp.asarray(cap[half:]), CHUNK, PAY, resume=j1.resume)
    r1 = tpar.sharded_receive_long_capture(CFG, mesh, cap[:half], CHUNK, PAY)
    r2 = tpar.sharded_receive_long_capture(CFG, mesh, cap[half:], CHUNK, PAY, resume=r1.resume)
    _assert_result(r1, j1)
    _assert_result(r2, j2)
    one = tpar.sharded_receive_long_capture(CFG, mesh, cap, CHUNK, PAY)
    assert int(r2.frames_ok) == int(one.frames_ok) == 3
    assert int(r2.frames_detected) == int(one.frames_detected)
    assert int(r2.resume.samples_seen) == 2 * half
    # a resume from the reference continues in the port alike
    jr = jpar.ShardedResume(*(np.asarray(f) for f in j1.resume))
    _assert_result(tpar.sharded_receive_long_capture(CFG, mesh, cap[half:], CHUNK, PAY, resume=jr), j2)


def test_ofdm_long_capture_matches_jax(mesh):
    """test_ofdm.py's OFDM long capture: 3 frames, chunk 256, 16 dB."""
    cfg, jcfg = get_model("ofdm-fast").config, jget_model("ofdm-fast").config
    rng = np.random.default_rng(1)
    p, chunk = 64, 256
    payloads = [rng.integers(0, 256, p, dtype=np.uint8) for _ in range(3)]
    parts = []
    for g, pay in zip((4000, 5100, 4700), payloads):
        parts += [np.zeros(g, np.float32), _tx(cfg, pay)]
    cap = np.concatenate(parts + [np.zeros(4000, np.float32)])
    cap = np.concatenate([cap, np.zeros((-len(cap)) % (N_POS * chunk), np.float32)])
    power = float((cap**2).sum() / sum(len(_tx(cfg, q)) for q in payloads))
    cap = cap + np.sqrt(power / 10**1.6) * rng.standard_normal(len(cap)).astype(np.float32)
    want = jpar.sharded_receive_long_capture(jcfg, jpar.make_mesh(), jnp.asarray(cap), chunk, p)
    got = tpar.sharded_receive_long_capture(cfg, mesh, cap, chunk, p)
    _assert_result(got, want)
    assert int(got.frames_ok) == 3


def test_coded_long_capture_matches_jax(mesh):
    """mfsk4-coded (soft Viterbi, depth-24 interleaver) split over 8
    positions, one frame across a position boundary."""
    cfg, jcfg = get_model("mfsk4-coded").config, jget_model("mfsk4-coded").config
    p, chunk = 16, 2048
    t = tfamily.frame_samples(cfg, p)
    seg = -(-(t + chunk) // chunk) * chunk
    rng = np.random.default_rng(7)
    placements = [(300, rng.integers(0, 256, p, np.uint8)), (2 * seg - t // 2, rng.integers(0, 256, p, np.uint8))]
    cap = _place(N_POS * seg, placements, 8, cfg, noise=0.2)
    want = jpar.sharded_receive_long_capture(jcfg, jpar.make_mesh(), jnp.asarray(cap), chunk, p)
    got = tpar.sharded_receive_long_capture(cfg, mesh, cap, chunk, p)
    _assert_result(got, want)
    assert int(got.frames_ok) == 2


# --- the 2-D grid --------------------------------------------------------------


def _grid_captures(b, n_frames_gaps, seed):
    rng = np.random.default_rng(seed)
    caps = []
    for i in range(b):
        cap, _, _ = _gapped([g + 137 * i for g in n_frames_gaps], seed=seed + i, align=1)
        caps.append(cap)
    n = -(-max(map(len, caps)) // (2 * CHUNK)) * (2 * CHUNK)
    out = 0.08 * rng.standard_normal((b, n)).astype(np.float32)
    for i, c in enumerate(caps):
        out[i, : len(c)] = c
    return out


@pytest.mark.parametrize("lock", [False, True])
def test_grid_matches_jax(lock):
    """4 x 2 mesh, 8 streams, the second frame of each across the time
    boundary."""
    captures = _grid_captures(8, [800, 9000], seed=0)
    want = jpar.sharded_receive_capture_grid(JCFG, jpar.make_mesh_2d(4, 2), jnp.asarray(captures), CHUNK, PAY, lock=lock)
    got = tpar.sharded_receive_capture_grid(CFG, tpar.make_mesh_2d(4, 2, device="cpu"), captures, CHUNK, PAY, lock=lock)
    assert got.steps.detected.shape == (8, captures.shape[1] // CHUNK)
    _assert_result(got, want)
    assert int(got.frames_ok) == 16 and got.resume is None
    local = receive_stream(CFG, captures, CHUNK, PAY, lock=lock, device="cpu")
    np.testing.assert_array_equal(local.steps.detected.numpy().T, got.steps.detected.numpy())


# --- header-declared lengths -----------------------------------------------------


def _dyn_placements(seg, half, seed):
    rng = np.random.default_rng(seed)
    t_max = tfamily.frame_samples(CFG, MAX_DYN)
    spots = [(2 * seg + 11, 16), (half - t_max // 2, MAX_DYN), (half + 3 * seg + 77, 5), (half + 5 * seg + 40, 4)]
    return [(s, rng.integers(0, 256, n, dtype=np.uint8)) for s, n in spots]


@pytest.mark.parametrize("k", [1, 2])
def test_dynamic_long_capture_with_resume_matches_jax(mesh, k):
    t_max = tfamily.frame_samples(CFG, MAX_DYN)
    seg = -(-(t_max + CHUNK) // CHUNK) * CHUNK
    half = N_POS * seg
    placements = _dyn_placements(seg, half, 9)
    cap = _place(2 * half, placements, 9)
    jmesh = jpar.make_mesh()
    kw = dict(max_frames_per_chunk=k)
    j1 = jpar.sharded_receive_long_capture_dynamic(JCFG, jmesh, jnp.asarray(cap[:half]), CHUNK, MAX_DYN, **kw)
    j2 = jpar.sharded_receive_long_capture_dynamic(
        JCFG, jmesh, jnp.asarray(cap[half:]), CHUNK, MAX_DYN, resume=j1.resume, **kw
    )
    r1 = tpar.sharded_receive_long_capture_dynamic(CFG, mesh, cap[:half], CHUNK, MAX_DYN, **kw)
    r2 = tpar.sharded_receive_long_capture_dynamic(CFG, mesh, cap[half:], CHUNK, MAX_DYN, resume=r1.resume, **kw)
    _assert_result(r1, j1, dynamic=True)
    _assert_result(r2, j2, dynamic=True)
    assert int(r2.frames_ok) == len(placements)
    got = {}
    for r in (r1, r2):
        det = r.steps.detected.numpy().reshape(-1)
        starts = r.steps.frame_start.numpy().reshape(-1)
        lens = r.steps.frame.payload_len.numpy().reshape(-1)
        pays = r.steps.frame.payload.numpy().reshape(-1, MAX_DYN)
        got.update({int(starts[i]): pays[i, : lens[i]].tobytes() for i in np.nonzero(det)[0]})
    assert got == {s: p.tobytes() for s, p in placements}
    local = receive_stream_dynamic(CFG, cap, CHUNK, MAX_DYN, max_frames_per_chunk=k, device="cpu")
    assert int(local.carry.frames_ok) == len(placements)


@pytest.mark.parametrize("resumed", [False, True])
def test_grid_dynamic_matches_jax(resumed):
    """2 x 4 mesh of variable-length streams, frames across the time
    boundaries; then a second super-step resumed from the first."""
    t_max = tfamily.frame_samples(CFG, MAX_DYN)
    seg = -(-(t_max + CHUNK) // CHUNK) * CHUNK
    total = 4 * seg
    rng = np.random.default_rng(20)
    caps = []
    for b, spots in enumerate(
        [[(100, 12), (2 * seg - t_max // 3, MAX_DYN)], [(seg + 313, 1), (4 * seg - t_max // 2, 24)]]
    ):
        placed = [(s, rng.integers(0, 256, n, dtype=np.uint8)) for s, n in spots]
        caps.append(_place(2 * total, placed + [(total + 2600 + 97 * b, rng.integers(0, 256, 9, np.uint8))], 20 + b))
    captures = np.stack(caps)
    jmesh, tmesh = jpar.make_mesh_2d(2, 4), tpar.make_mesh_2d(2, 4, device="cpu")
    j = jpar.sharded_receive_capture_grid_dynamic(JCFG, jmesh, jnp.asarray(captures[:, :total]), CHUNK, MAX_DYN)
    r = tpar.sharded_receive_capture_grid_dynamic(CFG, tmesh, captures[:, :total], CHUNK, MAX_DYN)
    if resumed:
        j = jpar.sharded_receive_capture_grid_dynamic(
            JCFG, jmesh, jnp.asarray(captures[:, total:]), CHUNK, MAX_DYN, resume=j.resume
        )
        r = tpar.sharded_receive_capture_grid_dynamic(CFG, tmesh, captures[:, total:], CHUNK, MAX_DYN, resume=r.resume)
    _assert_result(r, j, dynamic=True)
    assert r.resume.tail.shape == (2, t_max + CHUNK)
    assert int(r.frames_ok) == (6 if resumed else 3)  # stream 1's 24-byte frame straddles the two


# --- refusals --------------------------------------------------------------------


def _raises_alike(jcall, tcall):
    with pytest.raises(ValueError) as want:
        jcall()
    with pytest.raises(ValueError) as got:
        tcall()
    assert str(got.value) == str(want.value)
    return str(got.value)


def test_sharded_receivers_refuse_like_jax(mesh):
    jmesh = jpar.make_mesh()
    short = np.zeros(N_POS * CHUNK, np.float32)
    msg = _raises_alike(
        lambda: jpar.sharded_receive_long_capture(JCFG, jmesh, jnp.asarray(short), CHUNK, PAY),
        lambda: tpar.sharded_receive_long_capture(CFG, mesh, short, CHUNK, PAY),
    )
    assert "demodulator memory" in msg
    ragged = np.zeros(N_POS * CHUNK * 20 + 8, np.float32)
    msg = _raises_alike(
        lambda: jpar.sharded_receive_long_capture_dynamic(JCFG, jmesh, jnp.asarray(ragged), CHUNK, MAX_DYN),
        lambda: tpar.sharded_receive_long_capture_dynamic(CFG, mesh, ragged, CHUNK, MAX_DYN),
    )
    assert "whole" in msg
    good = np.zeros(N_POS * CHUNK * 20, np.float32)
    jres = jpar.sharded_receive_long_capture(JCFG, jmesh, jnp.asarray(good), CHUNK, PAY)
    tres = tpar.sharded_receive_long_capture(CFG, mesh, good, CHUNK, PAY)
    msg = _raises_alike(
        lambda: jpar.sharded_receive_long_capture(JCFG, jmesh, jnp.asarray(good), CHUNK, PAY + 8, resume=jres.resume),
        lambda: tpar.sharded_receive_long_capture(CFG, mesh, good, CHUNK, PAY + 8, resume=tres.resume),
    )
    assert "resume.tail shape" in msg
    grid = np.zeros((3, N_POS * CHUNK * 20), np.float32)
    _raises_alike(
        lambda: jpar.sharded_receive_capture_grid(JCFG, jpar.make_mesh_2d(2, 4), jnp.asarray(grid), CHUNK, PAY),
        lambda: tpar.sharded_receive_capture_grid(CFG, tpar.make_mesh_2d(2, 4, device="cpu"), grid, CHUNK, PAY),
    )
    _raises_alike(
        lambda: jpar.sharded_receive_capture_grid_dynamic(
            JCFG, jpar.make_mesh_2d(2, 4), jnp.asarray(grid), CHUNK, MAX_DYN
        ),
        lambda: tpar.sharded_receive_capture_grid_dynamic(
            CFG, tpar.make_mesh_2d(2, 4, device="cpu"), grid, CHUNK, MAX_DYN
        ),
    )


def test_exports_match_jax():
    assert tpar.__all__ == jpar.__all__
    for name in tpar.__all__ + ["Mesh", "STREAM_AXIS", "TIME_AXIS", "ShardedStreamResult"]:
        assert hasattr(tpar, name), name
