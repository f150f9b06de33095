"""The port's modem CLI (python -m anet_torch.cli ... --device cpu) against
the reference's (anet.cli) on the same files: modem-tx writes the same WAV
bytes, modem-rx and modem-stream-rx print the same lines, write the same
payload bytes and checkpoints that load in both packages, models prints the
same table, sweep the same keys and bit counts, and every exit code is the
reference's. Also the port's audio readers (anet_torch.tx.audio) against
anet.tx.audio on WAV, AIFF and AU files."""

import json
import re
import struct
import wave

import numpy as np
import pytest
import torch

import anet.cli as jcli
from anet import stream as jstream
from anet.tx import audio as jaudio

import anet_torch.cli as tcli
from anet_torch.tx import audio as taudio
from anet_torch import stream as tstream


def _run(capsys, argv, device=True):
    """(the port's rc and stdout lines, the reference's) for one argv."""
    capsys.readouterr()
    rc_t = tcli.main(argv + (["--device", "cpu"] if device else []))
    out_t = capsys.readouterr().out.splitlines()
    rc_j = jcli.main(argv)
    out_j = capsys.readouterr().out.splitlines()
    return (rc_t, out_t), (rc_j, out_j)


def _same(capsys, argv, device=True):
    got, want = _run(capsys, argv, device)
    assert got == want
    return got


# an SNR as the CLIs print it, to one decimal: float32 sums in another
# order (the int8 stream's estimate parts from the reference's by up to
# 0.006 dB) can round it to the neighbouring digit
_SNR = re.compile(r"(snr[= ~]+)(-?[0-9]+\.[0-9])")


def _assert_lines(got, want):
    """Equal (rc, lines) pairs, each printed SNR within one printed digit."""
    assert got[0] == want[0]
    assert [_SNR.sub(r"\1X", l) for l in got[1]] == [_SNR.sub(r"\1X", l) for l in want[1]]
    g = [float(v) for l in got[1] for _, v in _SNR.findall(l)]
    w = [float(v) for l in want[1] for _, v in _SNR.findall(l)]
    np.testing.assert_allclose(g, w, atol=0.1 + 1e-9)


def _payload_file(tmp_path, n, seed, name="msg.bin"):
    path = tmp_path / name
    path.write_bytes(bytes(np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)))
    return path


def _tx_both(capsys, tmp_path, payload, out, extra=()):
    """modem-tx through both CLIs; returns the port's output path after
    checking the two files are byte-identical."""
    a, b = tmp_path / f"t_{out}", tmp_path / f"j_{out}"
    assert tcli.main(["modem-tx", str(payload), "--out", str(a), *extra, "--device", "cpu"]) == 0
    assert jcli.main(["modem-tx", str(payload), "--out", str(b), *extra]) == 0
    out_t, out_j = capsys.readouterr().out.splitlines()
    assert out_t.replace(str(a), "OUT") == out_j.replace(str(b), "OUT")
    assert a.read_bytes() == b.read_bytes()
    return a


@pytest.mark.parametrize(
    "model,extra",
    [("mfsk16-fast", ()), ("mfsk4-coded", ()), ("mfsk16-fast", ("--fec", "conv")), ("ofdm-fast", ())],
)
def test_modem_tx_writes_identical_wavs(tmp_path, capsys, model, extra):
    payload = _payload_file(tmp_path, 48, 1)
    wav = _tx_both(capsys, tmp_path, payload, "cap.wav", ("--model", model, *extra))
    with wave.open(str(wav)) as w:
        assert w.getnchannels() == 1 and w.getsampwidth() == 2


def test_modem_tx_raw_floats_match(tmp_path, capsys):
    payload = _payload_file(tmp_path, 48, 2)
    a, b = tmp_path / "a.f32", tmp_path / "b.f32"
    assert tcli.main(["modem-tx", str(payload), "--out", str(a), "--device", "cpu"]) == 0
    assert jcli.main(["modem-tx", str(payload), "--out", str(b)]) == 0
    np.testing.assert_allclose(np.fromfile(a, np.float32), np.fromfile(b, np.float32), atol=1e-6)
    big = _payload_file(tmp_path, 4097, 3, "big.bin")
    _same(capsys, ["modem-tx", str(big), "--out", str(a)])  # over the wire cap: rc 1


def _noisy_wav(tmp_path, wav, name, pad=(700, 900), snr_db=14.0, seed=4):
    """The WAV's frame padded with silence and white noise at ``snr_db``,
    written as a float32 capture (.f32)."""
    with wave.open(str(wav)) as w:
        x = np.frombuffer(w.readframes(w.getnframes()), "<i2").astype(np.float32) / 32768.0
    rng = np.random.default_rng(seed)
    sigma = np.sqrt((x**2).mean() / 10 ** (snr_db / 10))
    cap = np.concatenate([np.zeros(pad[0], np.float32), x, np.zeros(pad[1], np.float32)])
    cap = (cap + sigma * rng.standard_normal(len(cap))).astype(np.float32)
    path = tmp_path / name
    cap.tofile(path)
    return path


@pytest.mark.parametrize(
    "model,tx_extra,rx_extra",
    [
        ("mfsk16-fast", (), ("--len", "40")),
        ("mfsk16-fast", (), ("--max-len", "64")),
        ("mfsk16-fast", (), ("--len", "40", "--track")),
        ("mfsk16-fast", ("--fec", "conv"), ("--len", "40", "--fec", "conv")),
        ("mfsk8-audible", (), ("--len", "40", "--model", "auto")),
        ("ofdm-fast", (), ("--len", "40")),
    ],
)
def test_modem_rx_matches_reference(tmp_path, capsys, model, tx_extra, rx_extra):
    payload = _payload_file(tmp_path, 40, 5)
    wav = _tx_both(capsys, tmp_path, payload, "cap.wav", ("--model", model, *tx_extra))
    snr = 24.0 if model.startswith("ofdm") else 6.0
    for cap in (wav, _noisy_wav(tmp_path, wav, "cap.f32", snr_db=snr)):
        argv = ["modem-rx", str(cap), *rx_extra] + ([] if "--model" in rx_extra else ["--model", model])
        got, want = _run_with_out(capsys, argv)
        assert got[0] == 0
        _assert_lines(got, want)
        assert (tmp_path / "t.bin").read_bytes() == payload.read_bytes()


def _run_with_out(capsys, argv, extra_t=("--device", "cpu")):
    """Both CLIs on ``argv`` with ``--out`` files t.bin (the port's) and
    j.bin beside the argv's first file: ((rc, lines), (rc, lines)) with the
    out path written as OUT, after checking the two files hold the same
    bytes."""
    import pathlib

    base = pathlib.Path(argv[1]).parent
    runs = []
    for main, tag, extra in ((tcli.main, "t", list(extra_t)), (jcli.main, "j", [])):
        out = base / f"{tag}.bin"
        capsys.readouterr()
        rc = main(argv + ["--out", str(out)] + extra)
        runs.append((rc, capsys.readouterr().out.replace(str(out), "OUT").splitlines()))
    assert (base / "t.bin").read_bytes() == (base / "j.bin").read_bytes()
    return tuple(runs)


def test_modem_rx_failures_match_reference(tmp_path, capsys):
    noise = tmp_path / "noise.f32"
    np.random.default_rng(0).normal(0, 1, 60_000).astype(np.float32).tofile(noise)
    got = _same(capsys, ["modem-rx", str(noise), "--len", "64"])
    assert got[0] == 2 and "ok=False" in got[1][0]
    assert _same(capsys, ["modem-rx", str(tmp_path / "missing.f32"), "--len", "64"])[0] == 1
    assert _same(capsys, ["modem-stream-rx", str(tmp_path / "missing.f32"), "--len", "64"])[0] == 1
    coded = ["modem-rx", str(noise), "--model", "mfsk4-coded"]
    assert _same(capsys, coded)[0] == 2  # no --len on a coded model
    assert _same(capsys, ["modem-rx", str(noise), "--track"])[0] == 2


def test_cli_refuses_cuda_without_a_card(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    payload = _payload_file(tmp_path, 8, 6)
    assert tcli.main(["modem-tx", str(payload), "--out", str(tmp_path / "c.wav")]) == 1
    assert "CUDA is not available" in capsys.readouterr().err
    assert not (tmp_path / "c.wav").exists()


STREAM_PAY = 48


def _stream_capture(tmp_path, capsys, n_frames=3, lens=None, name="stream.wav", seed=7):
    """A WAV capture of frames from the port's modem-tx (each a fresh
    payload, of ``lens`` bytes or STREAM_PAY), after seeded gaps, with white
    noise at 16 dB, in 16-bit PCM; returns (path, payload bytes in order)."""
    rng = np.random.default_rng(seed)
    parts, sent = [], b""
    for i in range(n_frames):
        n = STREAM_PAY if lens is None else lens[i]
        payload = _payload_file(tmp_path, n, seed * 10 + i, f"p{i}.bin")
        sent += payload.read_bytes()
        f32 = tmp_path / f"f{i}.f32"
        assert tcli.main(["modem-tx", str(payload), "--out", str(f32), "--device", "cpu"]) == 0
        parts += [np.zeros(int(rng.integers(300, 3000)), np.float32), np.fromfile(f32, np.float32)]
    capsys.readouterr()
    x = np.concatenate(parts + [np.zeros(2500, np.float32)])
    sigma = np.sqrt((x**2).mean() / 10**1.6)
    x = x + sigma * rng.standard_normal(len(x)).astype(np.float32)
    path = tmp_path / name
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(48_000)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())
    return path, sent


@pytest.mark.parametrize(
    "extra",
    [
        ("--len", str(STREAM_PAY)),
        ("--len", str(STREAM_PAY), "--lock"),
        ("--len", str(STREAM_PAY), "--lock", "--int8"),
        ("--len", str(STREAM_PAY), "--track"),
        ("--max-len", "64"),
        ("--max-len", "64", "--lock", "--chunk", "512"),
    ],
)
def test_modem_stream_rx_matches_reference(tmp_path, capsys, extra):
    dynamic = "--len" not in extra
    cap, sent = _stream_capture(tmp_path, capsys, lens=(16, 48, 64) if dynamic else None)
    got, want = _run_with_out(capsys, ["modem-stream-rx", str(cap), *extra])
    assert got[0] == 0
    _assert_lines(got, want)
    lines = got[1]
    assert lines[-2 if "link:" in lines[-1] else -1].startswith("total: 3 detected, 3 ok")
    assert (tmp_path / "t.bin").read_bytes() == sent


@pytest.mark.parametrize("extra", [("--len", str(STREAM_PAY), "--lock"), ("--max-len", "64")])
def test_modem_stream_rx_checkpoints_cross_packages(tmp_path, capsys, extra):
    """--save-state on the first half, --resume on the second: each package
    resumes its own checkpoint and the other's, with the same lines and
    bytes, and the whole run's payloads come back."""
    dynamic = "--len" not in extra
    cap, sent = _stream_capture(tmp_path, capsys, lens=(16, 48, 64) if dynamic else None)
    with wave.open(str(cap)) as w:
        x = np.frombuffer(w.readframes(w.getnframes()), "<i2").astype(np.float32) / 32768.0
    half = len(x) // 2 + 333  # not a whole number of chunks: the checkpoint holds the rest
    first, second = tmp_path / "a.f32", tmp_path / "b.f32"
    x[:half].tofile(first)
    x[half:].tofile(second)
    st_t, st_j = tmp_path / "t.npz", tmp_path / "j.npz"
    assert tcli.main(["modem-stream-rx", str(first), *extra, "--save-state", str(st_t), "--out",
                      str(tmp_path / "t1.bin"), "--device", "cpu"]) in (0, 2)
    lines_t = capsys.readouterr().out.replace(str(st_t), "ST").replace("t1.bin", "X1").splitlines()
    assert jcli.main(["modem-stream-rx", str(first), *extra, "--save-state", str(st_j), "--out",
                      str(tmp_path / "j1.bin")]) in (0, 2)
    lines_j = capsys.readouterr().out.replace(str(st_j), "ST").replace("j1.bin", "X1").splitlines()
    _assert_lines((0, lines_t), (0, lines_j))
    ck_t, ck_j = tstream.load_carry(st_t, device="cpu"), jstream.load_carry(str(st_j))
    for f in tstream.StreamCarry._fields:
        np.testing.assert_array_equal(getattr(ck_t.carry, f).numpy(), np.asarray(getattr(ck_j.carry, f)), f)
    np.testing.assert_array_equal(ck_t.pending, np.asarray(ck_j.pending))
    assert len(ck_t.pending) > 0
    # each package resumes the other's checkpoint
    for mine, theirs in ((st_t, st_j), (st_j, st_t)):
        outs = []
        for main, st, tag in ((tcli.main, mine, "t"), (jcli.main, theirs, "j")):
            argv = ["modem-stream-rx", str(second), *extra, "--resume", str(st), "--out", str(tmp_path / f"{tag}2.bin")]
            rc = main(argv + (["--device", "cpu"] if main is tcli.main else []))
            text = capsys.readouterr().out
            outs.append((rc, text.replace(str(st), "ST").replace(f"{tag}2.bin", "X2").splitlines()))
        _assert_lines(*outs)
        assert outs[0][0] == 0
        whole = (tmp_path / "t1.bin").read_bytes() + (tmp_path / "t2.bin").read_bytes()
        assert whole == sent
        assert (tmp_path / "t2.bin").read_bytes() == (tmp_path / "j2.bin").read_bytes()


def test_models_match_reference(capsys):
    assert _same(capsys, ["models"], device=False)[0] == 0
    for argv in (["models", "--snr", "-8"], ["models", "--snr", "16", "--margin", "1"]):
        assert _same(capsys, argv, device=False)[0] == 0


def test_sweep_keys_and_bits_match_reference(capsys):
    argv = ["sweep", "--snr-points", "2", "--snr-min", "-12", "--frames", "16", "--payload", "16",
            "--model", "mfsk4-voice"]
    (rc_t, out_t), (rc_j, out_j) = _run(capsys, argv)
    assert rc_t == rc_j == 0
    got, want = [json.loads(l) for l in out_t], [json.loads(l) for l in out_j]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"model", "snr_db", "ber", "fer", "bits"}
        assert (g["model"], g["snr_db"], g["bits"]) == (w["model"], w["snr_db"], w["bits"])
    # --echo: coded OFDM still sweeps clean at high SNR
    argv = ["sweep", "--model", "ofdm-coded", "--snr-points", "1", "--snr-min", "14", "--frames", "8",
            "--payload", "32", "--echo", "0.25", "--device", "cpu"]
    assert tcli.main(argv) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["fer"] == 0.0


# --- the audio readers ----------------------------------------------------------------


def _extended80(rate: int) -> bytes:
    import math

    mant, exp = math.frexp(rate)
    return struct.pack(">HQ", 16382 + exp, int(mant * (1 << 64)))


def _audio_files(tmp_path):
    rng = np.random.default_rng(9)
    pcm = rng.integers(-32768, 32767, (500, 2), dtype=np.int16)
    files = []
    for width in (1, 2, 3, 4):
        path = tmp_path / f"w{width}.wav"
        raw = rng.integers(0, 256, 500 * 2 * width, dtype=np.uint8).tobytes()
        with wave.open(str(path), "wb") as w:
            w.setnchannels(2)
            w.setsampwidth(width)
            w.setframerate(44_100)
            w.writeframes(raw)
        files.append(path)
    for form, codec, width, data in (
        (b"AIFF", b"", 2, pcm.astype(">i2").tobytes()),
        (b"AIFC", b"sowt", 2, pcm.astype("<i2").tobytes()),
        (b"AIFF", b"", 3, rng.integers(0, 256, 500 * 2 * 3, dtype=np.uint8).tobytes()),
    ):
        comm = struct.pack(">hIh", 2, 500, width * 8) + _extended80(22_050) + codec
        ssnd = struct.pack(">II", 0, 0) + data
        body = (form + b"COMM" + struct.pack(">I", len(comm)) + comm + b"\x00" * (len(comm) & 1)
                + b"SSND" + struct.pack(">I", len(ssnd)) + ssnd)
        path = tmp_path / f"a{len(files)}.aiff"
        path.write_bytes(b"FORM" + struct.pack(">I", len(body)) + body)
        files.append(path)
    for encoding, data in ((3, pcm.astype(">i2").tobytes()), (1, rng.integers(0, 256, 1000, dtype=np.uint8).tobytes()),
                           (5, rng.integers(0, 256, 4000, dtype=np.uint8).tobytes())):
        path = tmp_path / f"u{encoding}.au"
        path.write_bytes(b".snd" + struct.pack(">IIIII", 24, len(data), encoding, 8_000, 1) + data)
        files.append(path)
    return files


def test_audio_readers_match_reference(tmp_path):
    files = _audio_files(tmp_path)
    assert len(files) == 10
    for path in files:
        for name in ("read_audio",) + {".wav": ("read_wav",), ".aiff": ("read_aiff",), ".au": ("read_au",)}[path.suffix]:
            got, got_fmt = getattr(taudio, name)(str(path))
            want, want_fmt = getattr(jaudio, name)(str(path))
            assert got.dtype == want.dtype == np.int16
            np.testing.assert_array_equal(got, want)
            assert got_fmt.__dict__ == want_fmt.__dict__
    bad = tmp_path / "c.aiff"
    comm = struct.pack(">hIh", 1, 1, 16) + _extended80(8_000) + b"ulaw"
    body = b"AIFC" + b"COMM" + struct.pack(">I", len(comm)) + comm
    bad.write_bytes(b"FORM" + struct.pack(">I", len(body)) + body)
    for mod in (taudio, jaudio):
        with pytest.raises(ValueError, match="compressed AIFC"):
            mod.read_aiff(str(bad))
