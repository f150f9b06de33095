"""The port's codec, pacing and audio conversion (anet_torch.codec,
anet_torch.utils, anet_torch.tx.audio) against the reference.

Mirrors of tests/test_codec_utils.py (ring buffer, format validation, Opus
through the system libopus, skipped without it, and the leaky bucket) and
of tests/test_tx_audio.py (readers, resampling, conversion, error
aggregation, the paced sink), run on the port's modules; then the two
packages side by side on seeded numpy inputs: LeakyBucket under a
SimulatedClock, ByteRingBuffer, adjust_volume, resample_sinc, convert and
normalize_for_opus give equal outputs, and Opus frames encoded by one
package decode in the other.
"""

import dataclasses
import time
import wave

import numpy as np
import pytest

from anet_torch import constants
from anet_torch.codec import (
    AudioFormat,
    AudioFormatNotSupportedError,
    ByteRingBuffer,
    OpusDecoder,
    OpusEncoder,
    RingBufferError,
    opus_available,
    opus_version,
)
from anet_torch.tx.audio import (
    convert,
    nearest_supported_rate,
    normalize_for_opus,
    pcm_bytes,
    read_aiff,
    read_au,
    read_audio,
    read_wav,
    resample_sinc,
)
from anet_torch.utils import LeakyBucket, SimulatedClock
from anet_torch.utils.errors import CombinedError, do_all_and_raise_combined

needs_opus = pytest.mark.skipif(not opus_available(), reason="libopus not present")


# --- ring buffer (ByteRingBufferTest.kt parity) ------------------------------

def test_ring_fresh_state():
    rb = ByteRingBuffer(16)
    assert rb.remaining_read == 0
    assert rb.remaining_write == 16


def test_ring_overflow_raises():
    rb = ByteRingBuffer(4)
    rb.put(b"abcd")
    with pytest.raises(RingBufferError, match="overflow"):
        rb.put(b"e")


def test_ring_underflow_raises():
    rb = ByteRingBuffer(4)
    rb.put(b"ab")
    with pytest.raises(RingBufferError, match="underflow"):
        rb.get(3)


def test_ring_wraparound_roundtrip():
    rb = ByteRingBuffer(8)
    rb.put(b"abcdef")
    assert rb.get(4) == b"abcd"
    rb.put(b"ghijkl")  # wraps
    assert rb.get(8) == b"efghijkl"
    assert rb.remaining_read == 0


def test_ring_exact_fill():
    rb = ByteRingBuffer(5)
    rb.put(b"12345")
    assert rb.remaining_write == 0
    assert rb.get(5) == b"12345"


def test_ring_peek_does_not_consume():
    rb = ByteRingBuffer(8)
    rb.put(b"abc")
    assert rb.peek(2) == b"ab"
    assert rb.get(3) == b"abc"


# --- format validation (OpusEncoder.kt:22-41) --------------------------------

@pytest.mark.parametrize(
    "fmt,msg",
    [
        (AudioFormat(sample_rate_hz=44_100), "sample rate"),
        (AudioFormat(channels=3), "mono/stereo"),
        (AudioFormat(bits_per_sample=24), "16-bit"),
        (AudioFormat(little_endian=False), "little-endian"),
        (AudioFormat(signed=False), "signed"),
    ],
)
def test_format_validation(fmt, msg):
    with pytest.raises(AudioFormatNotSupportedError, match=msg):
        fmt.validate_for_opus()


# --- opus round trip ---------------------------------------------------------

@needs_opus
def test_opus_version_string():
    assert "libopus" in opus_version()


@needs_opus
def test_opus_encode_decode_roundtrip():
    enc = OpusEncoder(AudioFormat(48_000, 2))
    t = np.arange(int(48_000 * 0.3))
    pcm = (0.3 * 32767 * np.sin(2 * np.pi * 440 * t / 48_000)).astype(np.int16)
    stereo = np.repeat(pcm, 2).tobytes()
    frames = enc.submit(stereo) + enc.final()
    assert frames, "no frames encoded"
    assert all(len(f) <= constants.MAX_ENCODED_FRAME_SIZE for f in frames)
    # 300 ms at 60 ms frames -> 5 frames
    assert len(frames) == 5
    dec = OpusDecoder()
    pcm_out = b"".join(dec.decode(f) for f in frames)
    # decoded at 48k stereo 16-bit: 5 frames x 11520 bytes
    assert len(pcm_out) == 5 * constants.MAX_DECODED_FRAME_SIZE
    x = np.frombuffer(pcm_out, np.int16).astype(np.float32)
    assert np.sqrt(np.mean(x**2)) > 1000  # not silence


@needs_opus
def test_opus_frame_duration_negotiation():
    enc = OpusEncoder(AudioFormat(48_000, 2))
    assert enc.frame_duration_ms == 60.0
    assert enc.decoded_frame_bytes_at_48k_stereo() == 11_520
    enc.frame_duration_ms = 20.0
    assert enc.samples_per_frame == 960
    assert enc.decoded_frame_bytes_at_48k_stereo() == 3_840
    with pytest.raises(ValueError, match="frame duration"):
        enc.frame_duration_ms = 25.0


@needs_opus
def test_opus_final_pads_partial_frame():
    enc = OpusEncoder(AudioFormat(48_000, 1), frame_duration_ms=20.0)
    # 10 ms of mono audio = half a frame
    pcm = np.zeros(480, np.int16).tobytes()
    assert enc.submit(pcm) == []
    frames = enc.final()
    assert len(frames) == 1


@needs_opus
def test_opus_decoder_rejects_garbage():
    from anet_torch.codec import OpusError

    dec = OpusDecoder()
    with pytest.raises(OpusError):
        dec.decode(b"\xde\xad\xbe\xef" * 10)


# --- leaky bucket (LeakyBucket.kt parity, simulated clock) -------------------

def test_bucket_fills_and_drains():
    clock = SimulatedClock()
    b = LeakyBucket.simulated(clock, capacity=1200.0, drain_per_second=1000.0)
    assert b.try_put(1200.0) == 0.0
    wait = b.try_put(60.0)
    assert wait == pytest.approx(0.06)
    clock.advance(0.06)
    assert b.try_put(60.0) == 0.0


def test_bucket_wait_for_capacity_sleeps_virtual_time():
    clock = SimulatedClock()
    b = LeakyBucket.simulated(clock, capacity=100.0, drain_per_second=100.0)
    b.wait_for_capacity(100.0)
    t0 = clock.now()
    b.wait_for_capacity(50.0)  # needs 0.5 s of drain
    assert clock.now() - t0 == pytest.approx(0.5)


def test_bucket_rejects_oversized_put():
    b = LeakyBucket(capacity=10.0, drain_per_second=1.0)
    with pytest.raises(ValueError, match="exceeds bucket capacity"):
        b.try_put(11.0)


def test_bucket_models_receiver_queue():
    """Steady-state pacing: pushing 60 ms frames through the default bucket
    settles at ~1x real time (MulticastAudioOutput.kt:79-86 rationale)."""
    clock = SimulatedClock()
    b = LeakyBucket.simulated(clock)  # 1200 ms cap, 1000 ms/s drain
    t0 = clock.now()
    for _ in range(100):
        b.wait_for_capacity(60.0)
    elapsed = clock.now() - t0
    # 100 x 60 ms = 6 s of audio; bucket allows 1.2 s ahead -> >= 4.8 s wall
    assert 4.7 <= elapsed <= 6.0


# --- audio ingest and conversion (mirror of tests/test_tx_audio.py) ---------

def _write_wav(path, samples, rate, width, channels):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(samples)


@pytest.mark.parametrize("width", [1, 2, 3, 4])
def test_read_wav_bit_depths(tmp_path, width):
    """8/16/24/32-bit WAVs all normalize to int16."""
    n = 1000
    ref = (0.5 * 32767 * np.sin(2 * np.pi * 440 * np.arange(n) / 8000)).astype(
        np.int16
    )
    if width == 1:
        raw = ((ref.astype(np.int32) >> 8) + 128).astype(np.uint8).tobytes()
    elif width == 2:
        raw = ref.tobytes()
    elif width == 3:
        v = (ref.astype(np.int32) << 8) & 0xFFFFFF
        raw = b"".join(int(x).to_bytes(3, "little", signed=False) for x in v)
    else:
        raw = (ref.astype(np.int32) << 16).tobytes()
    path = tmp_path / f"w{width}.wav"
    _write_wav(path, raw, 8000, width, 1)
    samples, fmt = read_wav(str(path))
    assert fmt.sample_rate_hz == 8000 and fmt.channels == 1
    assert samples.shape == (n, 1)
    # amplitude preserved within quantization of the narrower width
    tol = {1: 300, 2: 0, 3: 2, 4: 0}[width]
    assert abs(int(samples[:, 0].max()) - int(ref.max())) <= tol


def test_read_wav_unsupported_width(tmp_path):
    # hand-craft a WAV header claiming 5-byte samples is awkward; emulate by
    # patching the reader path instead: wave module itself rejects width 5,
    # so just assert our error for an empty unsupported case via monkey use.
    import anet_torch.tx.audio as audio

    with pytest.raises(ValueError, match="unsupported WAV sample width"):
        # simulate: call the width dispatch directly through a fake
        class FakeWav:
            def getnchannels(self):
                return 1

            def getframerate(self):
                return 8000

            def getsampwidth(self):
                return 5

            def readframes(self, n):
                return b""

            def getnframes(self):
                return 0

            def __enter__(self):
                return self

            def __exit__(self, *a):
                return False

        orig = audio.wave.open
        audio.wave.open = lambda *a, **k: FakeWav()
        try:
            audio.read_wav("whatever.wav")
        finally:
            audio.wave.open = orig


def _extended80(rate: float) -> bytes:
    """Encode a sample rate as an 80-bit IEEE extended float (AIFF COMM)."""
    import math

    if rate == 0:
        return b"\x00" * 10
    mant, exp = math.frexp(rate)  # rate = mant * 2**exp, mant in [0.5, 1)
    return __import__("struct").pack(">HQ", 16382 + exp, int(mant * (1 << 64)))


def _write_aiff(path, samples_be: bytes, rate, width, channels, form=b"AIFF",
                codec=b""):
    import struct

    n_frames = len(samples_be) // (width * channels)
    comm = struct.pack(">hIh", channels, n_frames, width * 8) + _extended80(rate)
    comm += codec
    ssnd = struct.pack(">II", 0, 0) + samples_be
    body = (
        form
        + b"COMM" + struct.pack(">I", len(comm)) + comm + (b"\x00" * (len(comm) & 1))
        + b"SSND" + struct.pack(">I", len(ssnd)) + ssnd
    )
    path.write_bytes(b"FORM" + struct.pack(">I", len(body)) + body)


def test_read_aiff_16bit():
    import tempfile, pathlib

    n = 500
    ref = (10000 * np.sin(2 * np.pi * 440 * np.arange(n) / 44100)).astype(np.int16)
    stereo = np.stack([ref, -ref], axis=1)
    with tempfile.TemporaryDirectory() as d:
        p = pathlib.Path(d) / "t.aiff"
        _write_aiff(p, stereo.astype(">i2").tobytes(), 44100, 2, 2)
        samples, fmt = read_aiff(str(p))
    assert fmt.sample_rate_hz == 44100 and fmt.channels == 2
    assert np.array_equal(samples, stereo)
    # read_audio dispatches on the FORM magic
    with tempfile.TemporaryDirectory() as d:
        p = pathlib.Path(d) / "t.bin"
        _write_aiff(p, stereo.astype(">i2").tobytes(), 44100, 2, 2)
        s2, f2 = read_audio(str(p))
    assert np.array_equal(s2, samples)


def test_read_aifc_sowt_little_endian():
    import tempfile, pathlib

    ref = np.arange(-100, 100, dtype=np.int16)[:, None]
    with tempfile.TemporaryDirectory() as d:
        p = pathlib.Path(d) / "t.aifc"
        _write_aiff(p, ref.astype("<i2").tobytes(), 8000, 2, 1,
                    form=b"AIFC", codec=b"sowt")
        samples, fmt = read_aiff(str(p))
    assert fmt.sample_rate_hz == 8000
    assert np.array_equal(samples, ref)


def test_read_aifc_compressed_rejected():
    import tempfile, pathlib

    with tempfile.TemporaryDirectory() as d:
        p = pathlib.Path(d) / "t.aifc"
        _write_aiff(p, b"\x00\x00", 8000, 2, 1, form=b"AIFC", codec=b"ulaw")
        with pytest.raises(ValueError, match="compressed AIFC"):
            read_aiff(str(p))


def _write_au(path, payload: bytes, encoding, rate, channels):
    import struct

    path.write_bytes(
        b".snd" + struct.pack(">IIIII", 24, len(payload), encoding, rate, channels)
        + payload
    )


def test_read_au_16bit_and_mulaw():
    import tempfile, pathlib

    n = 400
    ref = (8000 * np.sin(2 * np.pi * 300 * np.arange(n) / 8000)).astype(np.int16)
    with tempfile.TemporaryDirectory() as d:
        p = pathlib.Path(d) / "t.au"
        _write_au(p, ref.astype(">i2").tobytes(), 3, 8000, 1)
        samples, fmt = read_au(str(p))
        assert fmt.sample_rate_hz == 8000 and fmt.channels == 1
        assert np.array_equal(samples[:, 0], ref)
        # mu-law: encode with the reference G.711 compressor, decode ours
        def mulaw_encode(x):
            x = x.astype(np.int32)
            sign = np.where(x < 0, 0x80, 0)
            mag = np.minimum(np.abs(x), 32635) + 0x84
            exp = (np.floor(np.log2(mag)) - 7).astype(np.int32)
            mant = (mag >> (exp + 3)) & 0x0F
            return (~(sign | (exp << 4) | mant)) & 0xFF
        enc = mulaw_encode(ref).astype(np.uint8)
        p2 = pathlib.Path(d) / "m.au"
        _write_au(p2, enc.tobytes(), 1, 8000, 1)
        dec, fmt2 = read_au(str(p2))
        # mu-law is 8-bit companded: ~6% worst-case error at these levels
        err = np.abs(dec[:, 0].astype(np.int32) - ref.astype(np.int32))
        assert err.max() <= 0.06 * 32768
        assert read_audio(str(p2))[1].sample_rate_hz == 8000


def test_resample_sinc_passband_and_stopband():
    """8 kHz -> 48 kHz upsampling: the tone passes at unity, its images
    (the VERDICT's measured-stopband ask) are below -60 dB."""
    n = 8000
    f0 = 1000.0
    x = (20000 * np.sin(2 * np.pi * f0 * np.arange(n) / 8000)).astype(np.int16)
    y = resample_sinc(x[:, None], 8000, 48000)[:, 0].astype(np.float64)
    assert y.shape[0] == 6 * n
    # discard filter edges, window, and measure the spectrum
    core = y[2000:-2000]
    win = np.hanning(core.size)
    spec = np.abs(np.fft.rfft(core * win))
    freqs = np.fft.rfftfreq(core.size, 1 / 48000)
    peak_bin = np.argmax(spec)
    assert abs(freqs[peak_bin] - f0) < 5.0
    # passband gain ~1 (within 0.5 dB)
    assert abs(20 * np.log10(np.max(np.abs(core)) / 20000)) < 0.5
    # stopband: all energy 300 Hz away from the tone (images at 7k, 9k,
    # 15k, 17k... for an 8k->48k zero-stuff) must sit below -60 dBc
    mask = np.abs(freqs - f0) > 300
    stop_db = 20 * np.log10(spec[mask].max() / spec[peak_bin])
    assert stop_db < -60.0, f"stopband only {stop_db:.1f} dBc"


def test_resample_sinc_fractional_ratio():
    """44.1 kHz -> 48 kHz (L=160/M=147): tone frequency preserved."""
    n = 44100 // 2
    f0 = 997.0
    x = (10000 * np.sin(2 * np.pi * f0 * np.arange(n) / 44100)).astype(np.int16)
    y = resample_sinc(x[:, None], 44100, 48000)[:, 0].astype(np.float64)
    assert y.shape[0] == int(round(n * 48000 / 44100))
    core = y[1000:-1000]
    spec = np.abs(np.fft.rfft(core * np.hanning(core.size)))
    freqs = np.fft.rfftfreq(core.size, 1 / 48000)
    assert abs(freqs[np.argmax(spec)] - f0) < 5.0
    # round-trip energy sanity: amplitude preserved within 1%
    assert abs(np.max(np.abs(core)) / 10000 - 1) < 0.01


def test_nearest_supported_rate():
    assert nearest_supported_rate(8000) == 8000
    assert nearest_supported_rate(11025) == 12000
    assert nearest_supported_rate(44100) == 48000
    assert nearest_supported_rate(96000) == 48000


def test_convert_resample_and_channels():
    n = 4410
    mono = (1000 * np.sin(2 * np.pi * 100 * np.arange(n) / 44100)).astype(np.int16)
    samples = mono[:, None]
    out = convert(
        samples,
        AudioFormat(44_100, 1),
        AudioFormat(48_000, 2),
    )
    assert out.shape[1] == 2
    assert abs(out.shape[0] - int(n * 48_000 / 44_100)) <= 1
    assert np.array_equal(out[:, 0], out[:, 1])  # mono upmix duplicates


def test_convert_multichannel_downmix_uses_all_channels():
    quad = np.zeros((100, 4), np.int16)
    quad[:, 3] = 4000  # content only in the last channel
    out = convert(quad, AudioFormat(48_000, 4), AudioFormat(48_000, 2))
    assert out.shape == (100, 2)
    assert int(out[0, 0]) == 1000  # mixed down, not dropped


def test_normalize_for_opus_converts_unsupported():
    samples = np.zeros((441, 1), np.int16)
    out, fmt = normalize_for_opus(samples, AudioFormat(44_100, 1))
    assert fmt.sample_rate_hz == 48_000
    assert abs(out.shape[0] - 480) <= 1
    # already-supported formats pass through untouched
    s2, f2 = normalize_for_opus(samples, AudioFormat(48_000, 1))
    assert s2 is samples and f2.sample_rate_hz == 48_000


def test_pcm_bytes_little_endian():
    assert pcm_bytes(np.asarray([[256]], np.int16)) == b"\x00\x01"


def test_do_all_and_raise_combined():
    ran = []
    with pytest.raises(CombinedError) as exc:
        do_all_and_raise_combined(
            [
                lambda: ran.append(1),
                lambda: (_ for _ in ()).throw(ValueError("a")),
                lambda: ran.append(2),
                lambda: (_ for _ in ()).throw(KeyError("b")),
            ]
        )
    assert ran == [1, 2]  # every action ran despite failures
    assert len(exc.value.errors) == 2
    # no errors -> no raise
    do_all_and_raise_combined([lambda: None])


def test_paced_sink_write_blocks_at_capacity():
    from anet_torch.rx.playback import BufferSink, PacedSink

    sink = PacedSink(BufferSink(), capacity_seconds=0.05)
    bps = 48_000 * 2 * 2
    t0 = time.monotonic()
    # 0.2 s of audio into a 0.05 s buffer: writes must block ~0.15 s total
    for _ in range(4):
        sink.write(b"\x00" * (bps // 20))  # 50 ms each
    elapsed = time.monotonic() - t0
    assert elapsed >= 0.10  # real-time pacing kicked in
    # write() drains to capacity BEFORE depositing its chunk (like
    # i2s_write), so at most capacity + one chunk is buffered afterwards
    assert sink.buffered_seconds <= 0.05 + 0.05 + 0.01


# --- the port against the reference ------------------------------------------

import anet.codec as jcodec  # noqa: E402
from anet.rx import playback as jplayback  # noqa: E402
from anet.tx import audio as jaudio  # noqa: E402
from anet.utils import pacing as jpacing  # noqa: E402

import anet_torch.codec as tcodec  # noqa: E402
from anet_torch.rx import playback as tplayback  # noqa: E402
from anet_torch.utils import pacing as tpacing  # noqa: E402


class _Spin(Exception):
    pass


def _bucket_trace(mod, seed):
    """Every try_put's answer and the level after it, over seeded puts and
    clock steps on a simulated clock, and the clock after blocking puts; a
    blocking put that sleeps 1,000 times without fitting ends the trace
    with "spin"."""
    rng = np.random.default_rng(seed)
    clock = mod.SimulatedClock(start=0.0)
    sleeps = [0]

    def sleep(seconds):
        sleeps[0] += 1
        if sleeps[0] > 1000:
            raise _Spin
        clock.sleep(seconds)

    bucket = mod.LeakyBucket(1200.0, 1000.0, now=clock.now, sleep=sleep)
    out = []
    for _ in range(300):
        amount = float(rng.choice([2.5, 5.0, 10.0, 20.0, 40.0, 60.0, rng.uniform(0, 200)]))
        if rng.random() < 0.3:
            sleeps[0] = 0
            try:
                bucket.wait_for_capacity(amount)
            except _Spin:
                return out + [("spin", clock.now())]
            out.append(("wait", clock.now(), bucket.level))
        else:
            out.append(("try", bucket.try_put(amount), bucket.level))
        clock.advance(float(rng.exponential(0.02)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_leaky_bucket_equal_to_reference(seed):
    """Equal answers, levels and clocks step for step. The reference's
    blocking put spins for good once the bucket's overshoot rounds to a wait
    below the simulated clock's float resolution (a few seconds into a
    sustained trace); the port's SimulatedClock.sleep moves time by at
    least one ulp, so its put fits there and the trace goes on."""
    want = _bucket_trace(jpacing, seed)
    got = _bucket_trace(tpacing, seed)
    assert all(event[0] != "spin" for event in got)
    if want[-1][0] == "spin":
        n = len(want) - 1
        assert got[:n] == want[:n]
        assert got[n][0] == "wait" and got[n][1] > want[n][1]
    else:
        assert got == want


def test_simulated_clock_sleep_always_moves_time():
    """The repair the port carries: a positive sleep below the clock's
    resolution still advances it (the reference's does not)."""
    for mod, moves in ((tpacing, True), (jpacing, False)):
        clock = mod.SimulatedClock(start=64.8638335171926)
        clock.sleep(6.8e-15)
        assert (clock.now() > 64.8638335171926) is moves
        clock.sleep(0.0)
        clock.sleep(0.25)
        assert clock.now() >= 64.8638335171926 + 0.25


def _ring_trace(ring_cls, err_cls, seed):
    rng = np.random.default_rng(seed)
    rb = ring_cls(int(rng.integers(1, 64)))
    out = []
    for _ in range(400):
        op = rng.integers(0, 4)
        n = int(rng.integers(0, rb.capacity + 3))
        try:
            if op == 0:
                rb.put(rng.integers(0, 256, n, dtype=np.uint8).tobytes())
                out.append(("put", n))
            elif op == 1:
                out.append(("get", rb.get(n)))
            elif op == 2:
                out.append(("peek", rb.peek(n)))
            else:
                rb.clear()
                out.append(("clear",))
        except err_cls as e:
            out.append(("error", str(e)))
        out.append((rb.remaining_read, rb.remaining_write))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_byte_ring_buffer_equal_to_reference(seed):
    assert _ring_trace(ByteRingBuffer, RingBufferError, seed) == _ring_trace(
        jcodec.ByteRingBuffer, jcodec.RingBufferError, seed
    )


@pytest.mark.parametrize("volume", [0.0, 0.37, 0.5, 1.0, 1.5, 4.0])
def test_adjust_volume_equal_to_reference(volume):
    pcm = np.random.default_rng(5).integers(-32768, 32768, 4096).astype("<i2").tobytes()
    assert tplayback.adjust_volume(pcm, volume) == jplayback.adjust_volume(pcm, volume)


@pytest.mark.parametrize(
    "in_rate,out_rate,channels",
    [(44_100, 48_000, 2), (48_000, 16_000, 1), (22_050, 24_000, 2), (8_000, 48_000, 1), (96_000, 48_000, 2)],
)
def test_resample_and_convert_equal_to_reference(in_rate, out_rate, channels):
    rng = np.random.default_rng(in_rate + out_rate)
    samples = rng.integers(-20000, 20000, (in_rate // 20, channels)).astype(np.int16)
    got = resample_sinc(samples, in_rate, out_rate)
    want = jaudio.resample_sinc(samples, in_rate, out_rate)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    for target_ch in (1, 2):
        got = convert(samples, AudioFormat(in_rate, channels), AudioFormat(out_rate, target_ch))
        want = jaudio.convert(samples, jcodec.AudioFormat(in_rate, channels), jcodec.AudioFormat(out_rate, target_ch))
        assert np.array_equal(got, want)


@pytest.mark.parametrize(
    "rate,channels,bits",
    [(48_000, 2, 16), (44_100, 2, 16), (11_025, 1, 16), (96_000, 6, 16), (16_000, 2, 16), (48_000, 3, 16), (48_000, 2, 24)],
)
def test_normalize_for_opus_equal_to_reference(rate, channels, bits):
    samples = np.random.default_rng(rate + channels).integers(-30000, 30000, (rate // 25, channels)).astype(np.int16)
    got, got_fmt = normalize_for_opus(samples, AudioFormat(rate, channels, bits))
    want, want_fmt = jaudio.normalize_for_opus(samples, jcodec.AudioFormat(rate, channels, bits))
    assert np.array_equal(got, want)
    assert dataclasses.asdict(got_fmt) == dataclasses.asdict(want_fmt)
    assert pcm_bytes(got) == jaudio.pcm_bytes(want)
    assert nearest_supported_rate(rate) == jaudio.nearest_supported_rate(rate)


def test_audio_format_has_one_home():
    """The readers, the conversion and the encoder share the codec's format
    card, as in the reference."""
    import anet_torch.tx.audio as taudio
    import anet_torch.tx.session as tsession

    assert taudio.AudioFormat is AudioFormat is tsession.AudioFormat
    assert taudio.SUPPORTED_SAMPLE_RATES == jaudio.SUPPORTED_SAMPLE_RATES
    assert AudioFormat(44_100, 2).bytes_per_frame == jcodec.AudioFormat(44_100, 2).bytes_per_frame == 4


@needs_opus
@pytest.mark.parametrize("direction", ["port->reference", "reference->port"])
def test_opus_frames_cross_decode(direction):
    """Opus packets of one package's encoder decode in the other's decoder to
    the PCM that the encoding package's own decoder gives (both wrap the one
    system libopus)."""
    t = np.arange(48_000 // 5)
    pcm = (0.3 * 32767 * np.sin(2 * np.pi * 440 * t / 48_000)).astype(np.int16)
    raw = np.repeat(pcm, 2).astype("<i2").tobytes()
    enc_mod, dec_mod = jcodec, tcodec
    if direction == "port->reference":
        enc_mod, dec_mod = dec_mod, enc_mod
    enc = enc_mod.OpusEncoder(enc_mod.AudioFormat(48_000, 2))
    packets = enc.submit(raw) + enc.final()
    enc.close()
    assert packets
    a, b = enc_mod.OpusDecoder(), dec_mod.OpusDecoder()
    assert [a.decode(p) for p in packets] == [b.decode(p) for p in packets]
    a.close()
    b.close()
    assert opus_version() == jcodec.opus_version()
