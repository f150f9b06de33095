"""anet_torch and chip_smoke.py stand alone: importing every module of the
port imports neither JAX nor the JAX package, and no entry point quietly
runs on the CPU when CUDA is absent."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import anet_torch

ROOT = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax_and_no_anet():
    modules = sorted(
        m.name for m in pkgutil.walk_packages(anet_torch.__path__, "anet_torch.")
    )
    assert {
        "anet_torch.kernels.build", "anet_torch.stream", "anet_torch.dsp.clock", "anet_torch.parallel",
        "anet_torch.cli", "anet_torch.tx.audio",
        "anet_torch.proto", "anet_torch.codec", "anet_torch.net", "anet_torch.net.native",
        "anet_torch.tx", "anet_torch.rx", "anet_torch.obs", "anet_torch.obs.profiling",
        "anet_torch.utils", "anet_torch.config",
        "anet_torch.examples", "anet_torch.examples.file_over_sound",
        "anet_torch.examples.adaptive_modem", "anet_torch.examples.opus_over_sound",
    } <= set(modules)
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r} + ['anet_torch', 'chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'anet'))\n"
        "assert not bad, bad\n"
        "print('isolated', len(sys.modules))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert "isolated" in out.stdout


def _entry_points():
    from anet_torch import channel, parallel
    from anet_torch.dsp import frame, ofdm, pipeline
    from anet_torch.dsp.sync import preamble_waveform
    from anet_torch.models import classify_capture, get_model
    from anet_torch.stream import init_carry, receive_stream, receive_stream_dynamic

    cfg = get_model("mfsk16-fast").config
    ocfg = get_model("ofdm-fast").config
    pay = np.zeros((1, 4), np.uint8)
    t_ofdm = ocfg.frame_num_samples(4)
    t_mfsk = frame.frame_num_samples(cfg, 4)
    cards = parallel.Mesh([torch.device("cuda")] * 2, (parallel.STREAM_AXIS,))
    grid = parallel.Mesh([[torch.device("cuda")] * 2] * 2, (parallel.STREAM_AXIS, parallel.TIME_AXIS))
    long = np.zeros(2 * 32768, np.float32)
    return {
        "ofdm.pilot_carriers": lambda: ofdm.pilot_carriers(ocfg),
        "ofdm.preamble_carriers": lambda: ofdm.preamble_carriers(ocfg),
        "parallel.make_mesh": lambda: parallel.make_mesh(),
        "parallel.make_mesh_2d": lambda: parallel.make_mesh_2d(1, 1),
        "parallel.shard_streams": lambda: parallel.shard_streams(cards, np.zeros((2, 4), np.float32)),
        "parallel.sharded_demodulate": lambda: parallel.sharded_demodulate(
            cfg, cards, np.zeros((2, t_mfsk), np.float32), 4
        ),
        "parallel.ber_sweep": lambda: parallel.ber_sweep(cfg, cards, torch.Generator(), [0.0], 2, 4),
        "parallel.sharded_receive_long_capture": lambda: parallel.sharded_receive_long_capture(
            cfg, cards, long, 1024, 4
        ),
        "parallel.sharded_receive_long_capture_dynamic": lambda: parallel.sharded_receive_long_capture_dynamic(
            cfg, cards, long, 1024, 4
        ),
        "parallel.sharded_receive_capture_grid": lambda: parallel.sharded_receive_capture_grid(
            cfg, grid, np.zeros((2, 65536), np.float32), 1024, 4
        ),
        "parallel.sharded_receive_capture_grid_dynamic": lambda: parallel.sharded_receive_capture_grid_dynamic(
            cfg, grid, np.zeros((2, 65536), np.float32), 1024, 4
        ),
        "ofdm.transmit": lambda: ofdm.transmit(ocfg, pay),
        "ofdm.preamble_waveform": lambda: ofdm.preamble_waveform(ocfg),
        "ofdm.demodulate_frame": lambda: ofdm.demodulate_frame(ocfg, np.zeros((1, t_ofdm), np.float32), 4),
        "ofdm.demodulate_frame_tm": lambda: ofdm.demodulate_frame_tm(ocfg, np.zeros((t_ofdm, 1), np.float32), 4),
        "ofdm.demodulate_frame_dynamic": lambda: ofdm.demodulate_frame_dynamic(
            ocfg, np.zeros((1, t_ofdm), np.float32), 4
        ),
        "ofdm.receive_frame": lambda: ofdm.receive_frame(ocfg, np.zeros((1, 8192), np.float32), 4),
        "ofdm.receive_stream": lambda: receive_stream(ocfg, np.zeros((1, 1024), np.float32), 1024, 4),
        "transmit": lambda: pipeline.transmit(cfg, pay),
        "demodulate_frame_tm": lambda: frame.demodulate_frame_tm(cfg, np.zeros((4096, 1), np.float32), 4),
        "demodulate_frame_tm(int8)": lambda: frame.demodulate_frame_tm(
            cfg, np.zeros((t_mfsk, 1), np.int8), 4, compute_dtype=torch.int8
        ),
        "demodulate_frame": lambda: frame.demodulate_frame(cfg, np.zeros((1, t_mfsk), np.float32), 4),
        "demodulate_frame(bf16)": lambda: frame.demodulate_frame(
            cfg, np.zeros((1, t_mfsk), np.float32), 4, compute_dtype=torch.bfloat16
        ),
        "init_carry(int8)": lambda: init_carry(cfg, 1024, 4, dtype=torch.int8),
        "preamble_waveform": lambda: preamble_waveform(cfg),
        "init_carry": lambda: init_carry(cfg, 1024, 4),
        "receive_stream": lambda: receive_stream(cfg, np.zeros((1, 1024), np.float32), 1024, 4),
        "receive_stream_dynamic": lambda: receive_stream_dynamic(cfg, np.zeros((1, 1024), np.float32), 1024, 4),
        "demodulate_frame_dynamic": lambda: frame.demodulate_frame_dynamic(cfg, np.zeros((1, 4096), np.float32), 4),
        "receive_frame": lambda: pipeline.receive_frame(cfg, np.zeros((1, 8192), np.float32), 4),
        "receive_frame_dynamic": lambda: pipeline.receive_frame_dynamic(cfg, np.zeros((1, 8192), np.float32), 4),
        "receive_frame_tracked": lambda: pipeline.receive_frame_tracked(cfg, np.zeros((1, 8192), np.float32), 4),
        "receive_stream(track)": lambda: receive_stream(cfg, np.zeros((1, 1024), np.float32), 1024, 4, track=True),
        "loopback": lambda: pipeline.loopback(cfg, pay),
        "classify_capture": lambda: classify_capture(np.zeros(8192, np.float32)),
        "channel.apply_channel": lambda: channel.apply_channel(
            torch.Generator(), np.zeros((1, 64), np.float32), channel.ChannelConfig()
        ),
        "channel.sample_rate_drift": lambda: channel.sample_rate_drift(np.zeros((1, 64), np.float32), 50.0),
        "channel.multipath": lambda: channel.multipath(np.zeros((1, 64), np.float32), (1.0, 0.5)),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_default_to_cuda_and_raise_without_it(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _entry_points()[name]()


def test_chip_smoke_refuses_without_cuda(monkeypatch, capsys):
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo,
    the script exits non-zero and prints no result."""
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True, text=True,
        timeout=120, env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""},
    )
    assert out.returncode != 0
    assert "anet_torch" in out.stderr
    assert '"ok"' not in out.stdout
