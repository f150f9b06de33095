"""The port's demos (anet_torch.examples) against the JAX package's on the
CPU: the same wire payloads and captures through both packages' legs, and
each demo run as a module with ``--device cpu``.

- TX: the demos' captures (the reference's construction on its own TX
  output) within the TX tolerances of test_torch_frame.py (MFSK: atol
  1e-5) and test_torch_ofdm.py (OFDM: rtol 1e-5, atol 1e-6).
- The streaming receiver, the demos' default call (float32, always
  searching, chunk 1,024, one capture with no batch axis), on one dirty
  capture made with numpy (the reference's TX output, the demo's echo,
  numpy AWGN at the demo's SNR): per-chunk ``detected``, ``frame.ok`` and
  ``frame.payload`` bit-equal to ``anet.stream.receive_stream``, the
  counters equal, and every message back. A 1 KiB file on mfsk16-fast
  (264-byte wire frames) and 0.4 s of Opus-sized frames on ofdm-coded
  (20 frames of the 230 bytes a 20 ms frame takes at the encoder's
  default 92 kb/s; seeded bytes, so libopus is not needed).
- The adaptive probe: the same ``receive_frame`` verdict, snr_db within
  rtol 1e-4 (test_torch_pipeline.py's) and the same ``suggest_model``
  choice from ``waveform_snr_db``.
- The modules as subprocesses: their verdict lines and exit codes, and
  ``--device cuda`` without a card a usage error with resolve_device's
  message.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anet import stream as jstream
from anet.dsp import family as jfamily
from anet.dsp import ofdm as jofdm
from anet.dsp import pipeline as jpipeline
from anet.models import get_model as jget_model
from anet.models import suggest_model as jsuggest_model
from anet.proto import AudioData as JAudioData
from anet.proto import ToReceiver as JToReceiver
from anet.proto import encode_delimited as jencode_delimited

from anet_torch.codec import opus_available
from anet_torch.dsp import pipeline as tpipeline
from anet_torch.examples import CHUNK, unwrap, wire_frames
from anet_torch.examples import adaptive_modem, file_over_sound, opus_over_sound
from anet_torch.models import get_model, suggest_model
from anet_torch.stream import receive_stream

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILE_MODEL, OPUS_MODEL = "mfsk16-fast", "ofdm-coded"
OPUS_STAND_IN = 230  # bytes of a 20 ms Opus frame at 92 kb/s
MFSK_ATOL = 1e-5
OFDM_RTOL, OFDM_ATOL = 1e-5, 1e-6
SNR_RTOL = 1e-4
needs_opus = pytest.mark.skipif(not opus_available(), reason="libopus not present")


def _file_bytes(n=1024, seed=3):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


def _opus_stand_ins(n_frames=20, seed=4):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, OPUS_STAND_IN, dtype=np.uint8).tobytes() for _ in range(n_frames)]


def _reference_padded(messages):
    """The reference demos' wire frames: anet.proto, zero-padded."""
    wire = [jencode_delimited(JToReceiver(audio_data=JAudioData(m)).encode()) for m in messages]
    padded = np.zeros((len(wire), max(map(len, wire))), np.uint8)
    for i, w in enumerate(wire):
        padded[i, : len(w)] = np.frombuffer(w, np.uint8)
    return padded


def _reference_layout(waves, gap, lead, tail=0):
    """The reference demos' capture: lead zeros, each frame then gap zeros,
    tail zeros, padded to whole chunks."""
    parts = [np.zeros(lead, np.float32)]
    for w in np.asarray(waves, np.float32):
        parts += [w, np.zeros(gap, np.float32)]
    cap = np.concatenate(parts + [np.zeros(tail, np.float32)])
    return np.concatenate([cap, np.zeros((-len(cap)) % CHUNK, np.float32)])


def _numpy_channel(x, snr_db, taps, seed):
    """The demo's echo (a causal FIR) and AWGN at ``snr_db`` of the echoed
    signal's power, in numpy."""
    y = np.convolve(x.astype(np.float64), np.asarray(taps, np.float64))[: len(x)]
    sigma = np.sqrt(np.mean(y * y) / 10.0 ** (snr_db / 10.0))
    y = y + sigma * np.random.default_rng(seed).standard_normal(len(y))
    return y.astype(np.float32)


FILE_CAPTURE, OPUS_CAPTURE = {}, {}


def _file_case():
    """(padded [4, 264], the reference's capture) of the 1 KiB file."""
    if not FILE_CAPTURE:
        padded = _reference_padded(file_over_sound.file_chunks(_file_bytes()))
        jcfg = jget_model(FILE_MODEL).config
        waves = jpipeline.transmit(jcfg, jnp.asarray(padded))
        cap = _reference_layout(waves, jcfg.samples_per_symbol * file_over_sound.GAP_SYMBOLS, file_over_sound.LEAD)
        FILE_CAPTURE.update(padded=padded, capture=cap)
    return FILE_CAPTURE["padded"], FILE_CAPTURE["capture"]


def _opus_case():
    if not OPUS_CAPTURE:
        padded = _reference_padded(_opus_stand_ins())
        jcfg = jget_model(OPUS_MODEL).config
        waves = jofdm.transmit(jcfg, jnp.asarray(padded))
        cap = _reference_layout(waves, jcfg.symbol_samples, opus_over_sound.LEAD)
        OPUS_CAPTURE.update(padded=padded, capture=cap)
    return OPUS_CAPTURE["padded"], OPUS_CAPTURE["capture"]


def test_wire_frames_match_the_reference_framing():
    """264-byte frames for 256-byte chunks (the last chunk shorter, zero
    padded), byte-equal to anet.proto's."""
    messages = file_over_sound.file_chunks(_file_bytes(1000))
    got = wire_frames(messages)
    assert got.dtype == torch.uint8 and got.shape == (4, 264)
    np.testing.assert_array_equal(got.numpy(), _reference_padded(messages))
    got = wire_frames(_opus_stand_ins(3))
    np.testing.assert_array_equal(got.numpy(), _reference_padded(_opus_stand_ins(3)))


def test_file_capture_matches_reference():
    padded, want = _file_case()
    got = file_over_sound.build_capture(get_model(FILE_MODEL).config, torch.from_numpy(padded), "cpu")
    assert got.dtype == torch.float32 and got.shape == want.shape and got.shape[0] % CHUNK == 0
    np.testing.assert_allclose(got.numpy(), want, atol=MFSK_ATOL)


def test_opus_capture_matches_reference():
    padded, want = _opus_case()
    got = opus_over_sound.build_capture(get_model(OPUS_MODEL).config, torch.from_numpy(padded), "cpu")
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=OFDM_RTOL, atol=OFDM_ATOL)


def test_adaptive_captures_match_reference():
    """The probe (fsk2-robust, 16 bytes between 500 zeros) and the bulk
    capture on ofdm-coded (300 bytes as two 256-byte frames, transmitted
    one frame at a time as the reference demo does)."""
    jprobe = jget_model(adaptive_modem.PROBE_MODEL).config
    want = np.asarray(jfamily.transmit_fn(jprobe)(jnp.asarray(np.arange(16, dtype=np.uint8))))
    want = np.concatenate([np.zeros(500, np.float32), want, np.zeros(500, np.float32)])
    np.testing.assert_allclose(adaptive_modem.probe_capture("cpu").numpy(), want, atol=MFSK_ATOL)

    payload = adaptive_modem.bulk_payload(300, 0)
    jcfg = jget_model(OPUS_MODEL).config
    tx = jfamily.transmit_fn(jcfg)
    frames = [np.concatenate([payload[i : i + 256], np.zeros(max(0, i + 256 - 300), np.uint8)])
              for i in range(0, 300, 256)]
    waves = [np.asarray(tx(jnp.asarray(f))) for f in frames]
    want = _reference_layout(waves, 400, 800, jfamily.frame_samples(jcfg, 256))
    got = adaptive_modem.build_capture(get_model(OPUS_MODEL).config, payload, "cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=OFDM_RTOL, atol=OFDM_ATOL)


def _same_stream(model, padded, capture, snr_db, taps, seed):
    """Both packages' receive_stream on one numpy dirty capture: per-chunk
    detected, ok and payload bit-equal, counters equal. Returns the port's
    result."""
    dirty = _numpy_channel(capture, snr_db, taps, seed)
    frame_len = padded.shape[1]
    want = jstream.receive_stream(jget_model(model).config, jnp.asarray(dirty), CHUNK, frame_len)
    got = receive_stream(get_model(model).config, torch.from_numpy(dirty), CHUNK, frame_len, device="cpu")
    n_chunks = len(dirty) // CHUNK
    assert got.steps.detected.shape == (n_chunks,) and got.steps.frame.payload.shape == (n_chunks, frame_len)
    np.testing.assert_array_equal(got.steps.detected.numpy(), np.asarray(want.steps.detected))
    np.testing.assert_array_equal(got.steps.frame.ok.numpy(), np.asarray(want.steps.frame.ok))
    np.testing.assert_array_equal(got.steps.frame.payload.numpy(), np.asarray(want.steps.frame.payload))
    for f in ("frames_detected", "frames_ok", "decode_errors"):
        assert int(getattr(got.carry, f)) == int(getattr(want.carry, f)), f
    assert int(got.carry.frames_ok) == len(padded)
    return got


def test_file_stream_matches_reference():
    padded, capture = _file_case()
    got = _same_stream(FILE_MODEL, padded, capture, 8.0, file_over_sound.TAPS, seed=10)
    assert file_over_sound.recover(got) == _file_bytes()


def test_opus_stream_matches_reference():
    padded, capture = _opus_case()
    got = _same_stream(OPUS_MODEL, padded, capture, 14.0, opus_over_sound.TAPS, seed=11)
    assert unwrap(got) == _opus_stand_ins()


@pytest.mark.parametrize("snr_db,seed", [(9.0, 0), (9.0, 1), (2.0, 2), (-12.0, 3)])
def test_adaptive_probe_matches_reference(snr_db, seed):
    """The probe on one numpy capture: the same verdict, snr_db within
    SNR_RTOL, the same preset from waveform_snr_db."""
    jprobe = jget_model(adaptive_modem.PROBE_MODEL).config
    clean = np.asarray(jfamily.transmit_fn(jprobe)(jnp.asarray(np.arange(16, dtype=np.uint8))))
    clean = np.concatenate([np.zeros(500, np.float32), clean, np.zeros(500, np.float32)])
    dirty = _numpy_channel(clean, snr_db, (1.0,), seed)
    want = jpipeline.receive_frame(jprobe, jnp.asarray(dirty), 16)
    got = tpipeline.receive_frame(get_model(adaptive_modem.PROBE_MODEL).config, dirty, 16, device="cpu")
    assert bool(got.frame.ok) == bool(want.frame.ok) == (snr_db > 0)
    np.testing.assert_allclose(float(got.frame.snr_db), float(want.frame.snr_db), rtol=SNR_RTOL)
    measured = adaptive_modem.measure(got)
    want_measured = float(jfamily.waveform_snr_db(jprobe, want.frame.snr_db))
    np.testing.assert_allclose(measured, want_measured, rtol=SNR_RTOL, atol=1e-4)
    assert suggest_model(measured).name == jsuggest_model(want_measured).name
    if snr_db == 9.0:
        assert suggest_model(measured).name == "ofdm-coded"


@needs_opus
def test_opus_source_matches_reference():
    """The melody and its Opus frames equal the reference demo's (the same
    libopus through both packages' codecs)."""
    from anet.codec import AudioFormat, OpusEncoder

    sr, seconds = 48_000, 0.2
    t = np.arange(int(sr * seconds))
    want = sum(
        0.2 * 32767 * np.sin(2 * np.pi * f * t / sr) * (np.sin(2 * np.pi * 2.0 * t / sr + p) > 0)
        for f, p in ((330, 0.0), (415, 2.1), (494, 4.2))
    ).astype(np.int16)
    mono = opus_over_sound.melody(seconds)
    np.testing.assert_array_equal(mono, want)
    enc = OpusEncoder(AudioFormat(sr, 2), frame_duration_ms=20.0)
    want_frames = enc.submit(np.repeat(want, 2).tobytes()) + enc.final()
    frames, bitrate = opus_over_sound.encode(mono)
    assert frames == want_frames and bitrate == enc.bitrate_bps == 92_000


def _run(module, *args, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", f"anet_torch.examples.{module}", *args],
        capture_output=True, text=True, timeout=timeout, cwd=ROOT,
    )


def test_file_over_sound_script(tmp_path):
    path = tmp_path / "k1.bin"
    path.write_bytes(_file_bytes())
    r = _run("file_over_sound", str(path), "--device", "cpu")
    assert r.returncode == 0, r.stderr
    assert r.stdout.splitlines() == [
        "1024 bytes -> 4 PHY frames -> 152576 samples (3.2 s of audio at 48000 Hz, mfsk16-fast)",
        "channel: 8.0 dB AWGN + echo",
        "receiver: 4 frames detected, 4 ok, 0 decode errors",
        "file reassembled byte-identical: True",
    ]


def test_adaptive_modem_script_good_channel():
    r = _run("adaptive_modem", "--device", "cpu", "--snr", "9", "--bytes", "300")
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert lines[0] == "probe: fsk2-robust decoded ok (air rate 375 bps)"
    assert lines[2] == "adapt: ofdm-coded (14400 bps net, 38x the probe rate)"
    assert lines[3].startswith("transfer: 2/2 frames ok over a 9.0 dB channel")
    assert lines[4] == "adaptive transfer: OK (byte-identical)"


def test_adaptive_modem_script_unusable_channel():
    r = _run("adaptive_modem", "--device", "cpu", "--snr", "-12")
    assert r.returncode == 1
    assert "channel unusable" in r.stderr and r.stdout == ""


@needs_opus
def test_opus_over_sound_script(tmp_path):
    out = tmp_path / "received.wav"
    r = _run("opus_over_sound", "--device", "cpu", "--seconds", "0.1", "--out", str(out))
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert lines[0].startswith("source: 0.1 s of audio -> 5 Opus frames (")
    assert lines[3] == "receiver: 5/5 frames ok, 0 decode errors"
    assert lines[4].startswith("decoded: 5 Opus frames -> 19200 PCM bytes (0.10 s)")
    assert lines[-1] == "full stack roundtrip: OK"
    assert out.stat().st_size == 44 + 19200


@pytest.mark.parametrize("module", ["file_over_sound", "adaptive_modem", "opus_over_sound"])
def test_demo_without_a_card_refuses_cuda(module):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = _run(module, "--device", "cuda", timeout=60)
    assert r.returncode == 2 and r.stdout == ""
    assert "CUDA is not available; pass device='cpu'" in r.stderr
