"""The network commands of the port's CLI (python -m anet_torch.cli
discover | tx | rx) against the reference's (anet.cli): the same flags and
defaults, the same output lines and exit codes. tx streams a WAV file to an
in-process receiver of the port (skipped without libopus, as the
reference's Opus tests are); rx runs in a subprocess on a config file with
UDP port 48875 and TCP port 0 and stops on SIGINT. Every subprocess wait
has its own timeout."""

import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
import wave
from pathlib import Path

import numpy as np
import pytest

import anet.cli as jcli

import anet_torch.cli as tcli
from anet_torch.codec import opus_available
from anet_torch.config import ReceiverConfig
from anet_torch.rx.playback import BufferSink
from anet_torch.rx.receiver import AnetReceiver

ROOT = Path(__file__).resolve().parents[1]
TX_UDP_PORT = 48873  # the in-process receiver's discovery port
RX_UDP_PORT = 48875  # the rx subprocess's (from its config file)
NET_COMMANDS = ("discover", "tx", "rx")

needs_opus = pytest.mark.skipif(not opus_available(), reason="libopus not present")


def _subcommands(parser):
    action = next(a for a in parser._actions if a.dest == "command")
    return action.choices


def _flags(subparser):
    return [
        (tuple(a.option_strings), a.dest, a.default, a.type, a.nargs, a.const, a.required)
        for a in subparser._actions
    ]


def test_help_lists_the_reference_commands_but_bench():
    out = subprocess.run(
        [sys.executable, "-m", "anet_torch.cli", "--help"], cwd=ROOT,
        capture_output=True, text=True, timeout=60,
    )
    assert out.returncode == 0
    want = set(_subcommands(jcli.build_parser())) - {"bench"}
    assert set(_subcommands(tcli.build_parser())) == want
    for name in want:
        assert name in out.stdout


@pytest.mark.parametrize("name", NET_COMMANDS)
def test_network_commands_take_the_reference_flags(name):
    got = _flags(_subcommands(tcli.build_parser())[name])
    want = _flags(_subcommands(jcli.build_parser())[name])
    assert got == want
    assert not any(dest == "device" for _, dest, *_ in got)


def test_cli_discover_empty(capsys):
    rc = tcli.main(["discover", "--timeout", "0.2"])
    # no receivers on the discovery port here -> exit 1; if one is around, 0 is fine
    assert rc in (0, 1)
    if rc == 1:
        assert capsys.readouterr().err.strip() == "no receivers found"


def _tone_wav(path, seconds=0.5, rate=48_000):
    t = np.arange(int(seconds * rate))
    pcm = (0.3 * 32767 * np.sin(2 * np.pi * 440 * t / rate)).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(np.repeat(pcm, 2).astype("<i2").tobytes())


def _masked(lines):
    """Output lines with the underflow count (timing-dependent) masked."""
    import re

    return [re.sub(r"underflows=\d+", "underflows=N", line) for line in lines]


@needs_opus
def test_cli_tx_streams_a_file_to_a_receiver(tmp_path, capsys):
    wav = tmp_path / "tone.wav"
    _tone_wav(wav)
    outputs = {}
    for name in ("port", "reference"):
        sink = BufferSink(buffered_seconds=0.05)
        cfg = ReceiverConfig(device_name="cli-rx", tcp_audio_port=0, udp_discovery_port=TX_UDP_PORT)
        with AnetReceiver(sink, cfg) as rx:
            port = str(rx.network.server.bound_port)
            argv = ["tx", str(wav), "127.0.0.1", "--port", port, "--unpaced"]
            if name == "port":
                out = subprocess.run(
                    [sys.executable, "-m", "anet_torch.cli", *argv], cwd=ROOT,
                    capture_output=True, text=True, timeout=60,
                )
                rc, lines = out.returncode, out.stdout.splitlines()
            else:
                capsys.readouterr()
                rc = jcli.main(argv)
                lines = capsys.readouterr().out.splitlines()
            deadline = time.monotonic() + 3
            while rx.pipeline.frames_played < 9 and time.monotonic() < deadline:
                time.sleep(0.02)
            snap = rx.metrics_snapshot()
        assert rc == 0
        assert snap["counters"]["frames_received"] == 9  # every frame of 0.5 s at 60 ms, padded
        assert snap["gauges"]["frames_played"] == 9
        assert snap["counters"].get("decode_errors_fed_back", 0) == 0
        outputs[name] = _masked(lines)
    assert outputs["port"] == outputs["reference"]
    assert outputs["port"][0] == "connected to 127.0.0.1: frame=60.0 ms, max_encoded=4096 B"
    assert outputs["port"][1] == "127.0.0.1: sent=9 underflows=N decode_errors=0"


def test_cli_tx_missing_file_and_refused_connection(tmp_path, capsys):
    rc = tcli.main(["tx", str(tmp_path / "absent.wav"), "127.0.0.1", "--port", "9"])
    assert rc == 1 and capsys.readouterr().err.startswith("anet_torch: error:")
    if not opus_available():
        return
    wav = tmp_path / "tone.wav"
    _tone_wav(wav, seconds=0.1)
    import socket

    with socket.socket() as s:  # a port that nothing listens on
        s.bind(("127.0.0.1", 0))
        free = str(s.getsockname()[1])
    rc = tcli.main(["tx", str(wav), "127.0.0.1", "--port", free, "--unpaced"])
    assert rc == 1 and "connection error" in capsys.readouterr().err


def _read_lines(stream, sink):
    for line in stream:
        sink.put(line.rstrip("\n"))
    sink.put(None)


def test_cli_rx_runs_until_sigint(tmp_path):
    cfg_path = tmp_path / "rx.json"
    cfg_path.write_text(
        ReceiverConfig(device_name="cli-rx-sub", tcp_audio_port=0, udp_discovery_port=RX_UDP_PORT).to_json()
    )
    out_wav = tmp_path / "out.wav"
    proc = subprocess.Popen(
        [sys.executable, "-m", "anet_torch.cli", "rx", "--config", str(cfg_path),
         "--out", str(out_wav), "--status-interval", "0.2"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONUNBUFFERED": "1"},
    )
    lines: "queue.Queue" = queue.Queue()
    reader = threading.Thread(target=_read_lines, args=(proc.stdout, lines), daemon=True)
    reader.start()
    seen = []
    try:
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            try:
                line = lines.get(timeout=max(0.1, deadline - time.monotonic()))
            except queue.Empty:
                break
            if line is None:
                break
            seen.append(line)
            if line.startswith("{"):  # the first status line
                break
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=20)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    reader.join(timeout=10)
    while True:
        try:
            line = lines.get_nowait()
        except queue.Empty:
            break
        if line is not None:
            seen.append(line)
    assert rc == 0, proc.stderr.read()
    up = [l for l in seen if l.startswith("receiver 'cli-rx-sub' up: ")]
    assert up and up[0].startswith(f"receiver 'cli-rx-sub' up: udp:{RX_UDP_PORT} tcp:")
    status = json.loads(next(l for l in seen if l.startswith("{")))
    assert {"counters", "gauges", "modules"} <= set(status)
    assert status["modules"]["network"]["streaming"] is False
    assert seen[-1] == f"wrote {out_wav}"
    assert out_wav.exists()
