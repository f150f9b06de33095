"""The port's receiver runtime, playback pipeline, transmitter session,
config and observability (anet_torch.rx, .tx, .config, .obs); and a whole
session across the two packages.

A mirror of tests/test_rx_tx.py on the port's modules (its Opus tests
skipped without libopus, as the reference's are), on UDP ports of its own
(48868-48872; tests/test_rx_tx.py binds 48766-48767). Then, over loopback
and both ways, one package's MulticastAudioOutput streams 0.5 s of a 440 Hz
tone to the other's AnetReceiver: 9 frames, underflow fed back, the
metrics snapshot, and the same PCM in the sink as a session within one
package gives. The device_trace test runs the port's torch.profiler hook
and reads the trace file it writes; a config file written by either
package loads in the other.
"""

import os
import threading
import time

import numpy as np
import pytest

from anet_torch import constants
from anet_torch.codec import AudioFormat, opus_available
from anet_torch.config import ConfigMode, ConfigTimeout, ReceiverConfig, await_and_load
from anet_torch.obs.metrics import MetricsRegistry
from anet_torch.obs.status import StatusIndicator, SystemState
from anet_torch.rx.playback import BufferSink, PlaybackPipeline
from anet_torch.rx.runtime import Module, PanicError, ReceiverRuntime, format_hex

needs_opus = pytest.mark.skipif(not opus_available(), reason="libopus not present")

# the port's own UDP ports: tests/test_rx_tx.py binds 48766 and 48767
APPLY_CONFIG_UDP_PORT = 48868
E2E_UDP_PORT = 48869
INTEROP_UDP_PORTS = {"port": 48871, "reference": 48872}


class FakeDecoder:
    """Deterministic decoder: frame bytes -> frame bytes doubled."""

    def __init__(self):
        self.closed = False

    def decode(self, frame: bytes) -> bytes:
        if frame == b"BAD":
            raise RuntimeError("synthetic decode failure")
        return frame * 2

    def close(self):
        self.closed = True


def make_pipeline(sink=None, **kw):
    sink = sink or BufferSink(buffered_seconds=0.05)
    return PlaybackPipeline(sink, decoder_factory=FakeDecoder, **kw), sink


# --- playback ---------------------------------------------------------------

def test_playback_decodes_in_order():
    pipe, sink = make_pipeline()
    pipe.start()
    for i in range(10):
        assert pipe.queue_frame(bytes([i]) * 4)
    deadline = time.monotonic() + 2
    while pipe.frames_played < 10 and time.monotonic() < deadline:
        time.sleep(0.01)
    pipe.stop()
    assert sink.data == b"".join(bytes([i]) * 8 for i in range(10))
    assert pipe.status()["frames_played"] == 10


def test_playback_underflow_detected_and_fed_back():
    events = []
    pipe, sink = make_pipeline(feedback=lambda u, d: events.append((u, d)))
    pipe.start()
    pipe.queue_frame(b"x")
    deadline = time.monotonic() + 2
    while pipe.underflows < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    pipe.stop()
    assert pipe.underflows == 1
    assert sink.paused_count == 1
    assert (True, False) in events
    # resumed counting after recovery is possible: playing flag off
    assert pipe.status()["playing"] is False


def test_playback_decode_error_skips_frame():
    events = []
    pipe, sink = make_pipeline(feedback=lambda u, d: events.append((u, d)))
    pipe.start()
    pipe.queue_frame(b"ok1")
    pipe.queue_frame(b"BAD")
    pipe.queue_frame(b"ok2")
    deadline = time.monotonic() + 2
    while pipe.frames_played < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    pipe.stop()
    assert pipe.decode_errors == 1
    assert (False, True) in events
    assert sink.data == b"ok1ok1ok2ok2"


def test_playback_queue_overflow_drops():
    pipe, _ = make_pipeline(queue_depth=4)
    # consumer not started: queue fills
    for _ in range(4):
        assert pipe.queue_frame(b"f", timeout_s=0.01)
    assert not pipe.queue_frame(b"f", timeout_s=0.01)
    assert pipe.frames_dropped == 1


def test_playback_mute_gates_output():
    pipe, sink = make_pipeline()
    pipe.mute()
    pipe.start()
    pipe.queue_frame(b"quiet")
    time.sleep(0.2)
    pipe.unmute()
    pipe.queue_frame(b"loud")
    deadline = time.monotonic() + 2
    while pipe.frames_played < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    pipe.stop()
    assert sink.data == b"loudloud"


def test_adjust_volume_matches_firmware_cast():
    """Truncation toward zero per sample (playback.cpp:58-64)."""
    import numpy as np

    from anet_torch.rx.playback import adjust_volume

    pcm = np.array([100, -100, 32767, -32768, 1, -1, 0], dtype="<i2").tobytes()
    half = np.frombuffer(adjust_volume(pcm, 0.5), dtype="<i2")
    assert half.tolist() == [50, -50, 16383, -16384, 0, 0, 0]
    # unity volume is the identity (no copy, no rounding)
    assert adjust_volume(pcm, 1.0) == pcm
    # amplification clamps instead of wrapping (beyond the firmware, which
    # never amplifies)
    loud = np.frombuffer(adjust_volume(pcm, 4.0), dtype="<i2")
    assert loud.tolist() == [400, -400, 32767, -32768, 4, -4, 0]


def test_playback_volume_scales_output():
    import numpy as np

    pipe, sink = make_pipeline()
    pipe.volume = 0.5
    pipe.start()
    pcm_in = np.array([1000, -2000], dtype="<i2").tobytes()
    pipe.queue_frame(pcm_in)
    deadline = time.monotonic() + 2
    while pipe.frames_played < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    pipe.stop()
    # FakeDecoder doubles the frame bytes, then volume halves each sample
    out = np.frombuffer(sink.data, dtype="<i2")
    assert out.tolist() == [500, -1000, 500, -1000]
    assert pipe.status()["volume"] == 0.5
    with pytest.raises(ValueError):
        pipe.volume = -0.1


def test_start_new_stream_recreates_decoder():
    pipe, _ = make_pipeline()
    pipe.start_new_stream()
    first = pipe._decoder
    pipe.start_new_stream()
    assert pipe._decoder is not first
    assert first.closed


# --- runtime ----------------------------------------------------------------

class Recorder(Module):
    def __init__(self, name, log, fail=False):
        self.name = name
        self._log = log
        self._fail = fail

    def initialize(self, runtime):
        if self._fail:
            raise RuntimeError("boom")
        self._log.append(f"init:{self.name}")

    def shutdown(self):
        self._log.append(f"down:{self.name}")

    def status(self):
        return {"up": True}


def test_runtime_init_order_and_shutdown_reverse():
    log = []
    rt = ReceiverRuntime().register(Recorder("a", log)).register(Recorder("b", log))
    rt.start()
    assert rt.status()["modules"] == {"a": {"up": True}, "b": {"up": True}}
    rt.stop()
    assert log == ["init:a", "init:b", "down:b", "down:a"]


def test_runtime_panic_on_module_failure():
    log = []
    rt = (
        ReceiverRuntime()
        .register(Recorder("good", log))
        .register(Recorder("bad", log, fail=True))
    )
    with pytest.raises(PanicError, match="bad"):
        rt.start()
    assert "down:good" in log  # teardown ran


def test_format_hex():
    assert format_hex(b"\x01\xff") == "01 ff"
    assert "+4B" in format_hex(bytes(8), max_bytes=4)


# --- config -----------------------------------------------------------------

def test_config_roundtrip_and_mac(tmp_path):
    cfg = ReceiverConfig(device_name="kitchen", mac_address=0xAABB)
    path = tmp_path / "rx.json"
    path.write_text(cfg.to_json())
    loaded = await_and_load(str(path), timeout_s=1)
    assert loaded == cfg
    assert loaded.resolved_mac() == 0xAABB
    # derived MAC is stable and has the locally-administered bit
    derived = ReceiverConfig().resolved_mac()
    assert derived == ReceiverConfig().resolved_mac()
    assert derived >> 40 == 0x02


def test_config_await_blocks_until_present(tmp_path):
    path = tmp_path / "late.json"

    def write_later():
        time.sleep(0.3)
        path.write_text(ReceiverConfig(device_name="late").to_json())

    threading.Thread(target=write_later, daemon=True).start()
    cfg = await_and_load(str(path), timeout_s=3)
    assert cfg.device_name == "late"


def test_config_await_timeout(tmp_path):
    with pytest.raises(ConfigTimeout):
        await_and_load(str(tmp_path / "never.json"), timeout_s=0.2)


def test_config_await_reads_a_file_written_after_it_was_created(tmp_path):
    """A writer that creates the file, sleeps, then writes it: the empty
    file does not parse, so await_and_load polls on until it does."""
    path = tmp_path / "two_step.json"
    path.touch()

    def write_later():
        time.sleep(0.3)
        path.write_text(ReceiverConfig(device_name="two-step").to_json())

    threading.Thread(target=write_later, daemon=True).start()
    cfg = await_and_load(str(path), timeout_s=3, poll_interval_s=0.02)
    assert cfg.device_name == "two-step"


@pytest.mark.parametrize("text,error", [('{"device_name": "hal', ValueError), ('{"nope": 1}', TypeError)])
def test_config_await_raises_the_parse_error_past_the_deadline(tmp_path, text, error):
    """A file that never parses (half-written JSON, or a field the config
    does not have) raises its last parse error at the deadline, after
    polling until then."""
    path = tmp_path / "bad.json"
    path.write_text(text)
    t0 = time.monotonic()
    with pytest.raises(error):
        await_and_load(str(path), timeout_s=0.2, poll_interval_s=0.02)
    assert time.monotonic() - t0 >= 0.2


# --- obs --------------------------------------------------------------------

def test_status_indicator_transitions():
    states = iter(
        [SystemState.DISCONNECTED, SystemState.DISCONNECTED, SystemState.STREAMING]
    )
    changes = []
    ind = StatusIndicator(lambda: next(states), on_change=lambda s, p: changes.append((s, p)))
    ind.poll_once()
    ind.poll_once()
    ind.poll_once()
    assert [s for s, _ in changes] == [SystemState.DISCONNECTED, SystemState.STREAMING]
    assert changes[0][1] == "(R) _ (R) _"
    assert changes[1][1] == "(G)(G)(G)"


def test_config_mode_latch():
    """ConfigMode is the config task's bit (config.cpp:16-45): enter()
    raises it for the duration of the apply worker, repeated presses don't
    stack, and the bit drops when apply returns."""
    gate = threading.Event()
    cm = ConfigMode(lambda: gate.wait(2.0))
    assert not cm.active
    assert cm.enter()
    assert cm.active
    assert not cm.enter()  # second button press: no second config task
    gate.set()
    assert cm.wait(2.0)
    assert not cm.active


def test_config_mode_apply_failure_clears_bit():
    def boom():
        raise RuntimeError("bad config")

    cm = ConfigMode(boom)
    assert cm.enter()
    assert cm.wait(2.0)
    assert not cm.active  # error logged, bit dropped — app stays alive


def test_receiver_apply_config_updates_identity():
    """A reloaded config propagates to the live discovery identity — the
    host analog of the firmware's post-config identity (the firmware
    reboots; anet pushes in place, receiver.apply_config)."""
    import dataclasses

    from anet_torch.rx.receiver import AnetReceiver

    sink = BufferSink(buffered_seconds=0.05)
    cfg = ReceiverConfig(
        device_name="before", tcp_audio_port=0, udp_discovery_port=APPLY_CONFIG_UDP_PORT
    )
    with AnetReceiver(sink, cfg) as rx:
        assert rx.network.identity().device_name == "before"
        rx.apply_config(dataclasses.replace(cfg, device_name="after"))
        assert rx.network.identity().device_name == "after"
        assert rx.network.responder.identity.device_name == "after"


def test_metrics_registry():
    m = MetricsRegistry()
    m.count("frames")
    m.count("frames", 2)
    m.gauge("snr_db", 12.5)
    snap = m.snapshot()
    assert snap["counters"] == {"frames": 3}
    assert snap["gauges"] == {"snr_db": 12.5}


# --- full tx -> rx over localhost -------------------------------------------

@needs_opus
def test_end_to_end_transmit_receive_with_feedback():
    from anet_torch.rx.receiver import AnetReceiver
    from anet_torch.tx import MulticastAudioOutput, pcm_bytes

    sink = BufferSink(buffered_seconds=0.05)
    cfg = ReceiverConfig(device_name="e2e-rx", tcp_audio_port=0, udp_discovery_port=E2E_UDP_PORT)
    with AnetReceiver(sink, cfg) as rx:
        port = rx.network.server.bound_port
        out = MulticastAudioOutput(AudioFormat(48_000, 2), paced=False)
        out.add_receiver("127.0.0.1", port)
        # negotiation picked 60 ms frames (default caps)
        assert out.encoder.frame_duration_ms == 60.0
        t = np.arange(24_000)
        pcm = (0.3 * 32767 * np.sin(2 * np.pi * 440 * t / 48_000)).astype(np.int16)
        stereo = np.repeat(pcm, 2).reshape(-1, 2)
        stream = out.as_output_stream()
        stream.write(pcm_bytes(stereo))
        stream.close()  # flush -> final padded frame
        deadline = time.monotonic() + 3
        while rx.pipeline.frames_played < 9 and time.monotonic() < deadline:
            time.sleep(0.02)
        stats = out.stats(out.receivers[0])
        assert stats.frames_sent == 9  # 0.5 s + pad at 60 ms frames
        # end-of-stream starvation must surface as underflow feedback
        while stats.underflows_reported < 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert stats.underflows_reported >= 1
        # the observability surface saw the whole session: ingest counters,
        # feedback events, and live gauges in one snapshot
        snap = rx.metrics_snapshot()
        assert snap["counters"]["frames_received"] == 9
        assert snap["counters"]["bytes_received"] > 0
        assert snap["counters"]["underflows_fed_back"] >= 1
        assert snap["gauges"]["frames_played"] == 9
        assert snap["gauges"]["streams_served"] == 1
        assert "playback" in snap["modules"] and "network" in snap["modules"]
        out.close()
    assert len(sink.data) == 9 * constants.MAX_DECODED_FRAME_SIZE


@needs_opus
def test_negotiation_shrinks_frame_for_small_receiver():
    from anet_torch.net.server import AudioStreamServer
    from anet_torch.proto import DiscoveryResponse
    from anet_torch.tx import MulticastAudioOutput

    ident = DiscoveryResponse(1, 1, "tiny", False, "libopus")
    # decode buffer fits only 20 ms @ 48k stereo (3840 B)
    with AudioStreamServer(
        ident, frame_sink=lambda f: None, port=0, max_decoded_frame_size=4000
    ) as server:
        out = MulticastAudioOutput(AudioFormat(48_000, 2), paced=False)
        out.add_receiver("127.0.0.1", server.bound_port)
        assert out.encoder.frame_duration_ms == 20.0
        out.close()


@needs_opus
def test_adaptive_quality_downgrade_and_restore():
    """Underflow feedback lowers the bitrate; sustained clean frames restore
    it — the reaction the reference promised (hardware/README.md:35) but
    never built."""
    from anet_torch.tx.session import QUALITY_LADDER_BPS, MulticastAudioOutput

    out = MulticastAudioOutput(
        AudioFormat(48_000, 1), paced=False, upgrade_after_clean_frames=3
    )
    assert out.bitrate_bps == QUALITY_LADDER_BPS[0]
    out._degrade_quality()
    out._degrade_quality()
    assert out.bitrate_bps == QUALITY_LADDER_BPS[2]
    # three clean fan-outs step back one rung
    for _ in range(3):
        out._maybe_upgrade_quality()
    assert out.bitrate_bps == QUALITY_LADDER_BPS[1]
    # the ladder floors at the bottom rung
    for _ in range(10):
        out._degrade_quality()
    assert out.bitrate_bps == QUALITY_LADDER_BPS[-1]
    out.encoder.close()


def test_stage_timer_and_device_trace(tmp_path):
    from anet_torch.obs.profiling import StageTimer, device_trace

    timer = StageTimer()
    with timer.stage("demod"):
        time.sleep(0.01)
    with timer.stage("demod"):
        time.sleep(0.01)
    s = timer.summary()["demod"]
    assert s["count"] == 2 and s["mean_ms"] >= 9
    # trace context must not blow up on CPU
    import torch

    with device_trace(str(tmp_path / "trace")):
        _ = torch.ones(8).sum()


@needs_opus
def test_multicast_fanout_two_receivers():
    """The reference's core feature: one transmitter, N receivers, every
    frame reaching all of them, negotiation taking the min of all caps
    (MulticastAudioOutput.kt:88-96,123-131)."""
    from anet_torch.net.server import AudioStreamServer
    from anet_torch.proto import DiscoveryResponse
    from anet_torch.tx import MulticastAudioOutput, pcm_bytes

    ident = lambda n: DiscoveryResponse(1, 1, n, False, "libopus")
    got_a, got_b = [], []
    with AudioStreamServer(ident("a"), frame_sink=got_a.append, port=0) as sa, \
         AudioStreamServer(ident("b"), frame_sink=got_b.append, port=0,
                           max_decoded_frame_size=8000) as sb:
        out = MulticastAudioOutput(AudioFormat(48_000, 2), paced=False)
        out.add_receiver("127.0.0.1", sa.bound_port)
        assert out.encoder.frame_duration_ms == 60.0
        out.add_receiver("127.0.0.1", sb.bound_port)
        # receiver b's 8000-byte decode buffer fits only 40 ms (7680 B)
        assert out.encoder.frame_duration_ms == 40.0
        t = np.arange(9600)
        pcm = (0.25 * 32767 * np.sin(2 * np.pi * 500 * t / 48_000)).astype(np.int16)
        stereo = np.repeat(pcm, 2).reshape(-1, 2)
        out.write(pcm_bytes(stereo))
        out.flush()  # 0.2 s at 40 ms -> 5 frames
        deadline = time.monotonic() + 3
        while (len(got_a) < 5 or len(got_b) < 5) and time.monotonic() < deadline:
            time.sleep(0.02)
        out.close()
    assert len(got_a) == len(got_b) == 5
    assert got_a == got_b  # identical encoded frames fan out to every sink


@needs_opus
def test_fanout_survives_one_dead_receiver():
    """A dead sink is pruned; the stream continues to the rest."""
    from anet_torch.net.server import AudioStreamServer
    from anet_torch.proto import DiscoveryResponse
    from anet_torch.tx import MulticastAudioOutput, pcm_bytes

    got = []
    ident = DiscoveryResponse(1, 1, "alive", False, "libopus")
    with AudioStreamServer(ident, frame_sink=got.append, port=0) as server:
        victim = AudioStreamServer(ident, frame_sink=lambda f: None, port=0).start()
        out = MulticastAudioOutput(AudioFormat(48_000, 1), paced=False)
        out.add_receiver("127.0.0.1", server.bound_port)
        out.add_receiver("127.0.0.1", victim.bound_port)
        assert len(out.receivers) == 2
        victim.stop()  # receiver dies mid-session
        pcm = np.zeros(48_000, np.int16).reshape(-1, 1)  # 1 s of audio
        out.write(pcm_bytes(pcm))
        out.flush()
        deadline = time.monotonic() + 3
        while len(got) < 17 and time.monotonic() < deadline:
            time.sleep(0.02)
        # the dead receiver was pruned, the live one got the whole stream
        assert len(out.receivers) == 1
        assert len(got) == 17  # 1 s at 60 ms frames + final pad
        out.close()


@needs_opus
def test_dead_receiver_reconnects_and_session_resumes():
    """Kill a receiver mid-stream, restart it, and observe the session resume
    without operator action — the firmware recovery behavior
    (network.cpp:437-446, retry bursts + cooldown per network.hpp:7-8),
    which the reference transmitter itself never had."""
    from anet_torch.net.server import AudioStreamServer
    from anet_torch.proto import DiscoveryResponse
    from anet_torch.tx import MulticastAudioOutput, pcm_bytes

    ident = lambda n: DiscoveryResponse(1, 1, n, False, "libopus")
    got_stable, got_flaky = [], []
    with AudioStreamServer(ident("stable"), frame_sink=got_stable.append, port=0) as stable:
        flaky = AudioStreamServer(ident("flaky"), frame_sink=got_flaky.append, port=0).start()
        flaky_port = flaky.bound_port
        out = MulticastAudioOutput(
            AudioFormat(48_000, 1), paced=False, reconnect_cooldown_s=0.05
        )
        out.add_receiver("127.0.0.1", stable.bound_port)
        out.add_receiver("127.0.0.1", flaky_port)
        frame_ms = out.encoder.frame_duration_ms
        n = int(48 * frame_ms)  # one frame of mono samples
        pcm = pcm_bytes(np.zeros(n, np.int16).reshape(-1, 1))
        out.write(pcm)
        flaky.stop()  # receiver dies mid-session
        # drive sends until the dead sink is detected and dropped
        deadline = time.monotonic() + 5
        while len(out.receivers) > 1 and time.monotonic() < deadline:
            out.write(pcm)
            time.sleep(0.01)
        assert len(out.receivers) == 1
        # receiver comes back on the same endpoint (SO_REUSEADDR)
        flaky2 = AudioStreamServer(
            ident("flaky"), frame_sink=got_flaky.append, port=flaky_port
        ).start()
        try:
            # the background ReconnectPolicy re-establishes the session
            while len(out.receivers) < 2 and time.monotonic() < deadline:
                time.sleep(0.02)
            assert len(out.receivers) == 2, "reconnect did not rejoin the fan-out"
            before = len(got_flaky)
            for _ in range(3):
                out.write(pcm)
            while len(got_flaky) < before + 3 and time.monotonic() < deadline:
                time.sleep(0.02)
            assert len(got_flaky) >= before + 3  # frames flow to the revived sink
            # accumulated stats survived the outage (same endpoint, same counter)
            revived = [r for r in out.receivers if r.port == flaky_port][0]
            assert out.stats(revived).frames_sent > 3
        finally:
            out.close()
            flaky2.stop()
    assert len(got_stable) > len(got_flaky)  # the stable sink never missed a frame


@needs_opus
def test_duplicate_endpoint_rejected():
    """Attaching the same (host, port) twice would double-send audio and
    alias the endpoint stats that reconnect continuity uses — rejected."""
    from anet_torch.net.server import AudioStreamServer
    from anet_torch.proto import DiscoveryResponse
    from anet_torch.tx import MulticastAudioOutput

    ident = DiscoveryResponse(1, 1, "once", False, "libopus")
    with AudioStreamServer(ident, frame_sink=lambda f: None, port=0) as server:
        out = MulticastAudioOutput(AudioFormat(48_000, 1), paced=False)
        out.add_receiver("127.0.0.1", server.bound_port)
        with pytest.raises(ValueError, match="already attached"):
            out.add_receiver("127.0.0.1", server.bound_port)
        assert len(out.receivers) == 1
        out.close()


@needs_opus
def test_reconnect_threads_pruned():
    """Finished reconnect threads are pruned when the next one is
    scheduled, so a flaky network cannot grow the thread list (and
    close()'s join set) without bound (ADVICE round 2)."""
    from anet_torch.net.server import AudioStreamServer
    from anet_torch.proto import DiscoveryResponse
    from anet_torch.tx import MulticastAudioOutput, pcm_bytes

    ident = DiscoveryResponse(1, 1, "prune", False, "libopus")
    server = AudioStreamServer(ident, frame_sink=lambda f: None, port=0).start()
    out = MulticastAudioOutput(
        AudioFormat(48_000, 1), paced=False, reconnect_cooldown_s=30.0
    )
    out.add_receiver("127.0.0.1", server.bound_port)
    # plant finished threads as if earlier outages had come and gone
    done = [threading.Thread(target=lambda: None) for _ in range(4)]
    for t in done:
        t.start()
        t.join()
    out._reconnect_threads.extend(done)
    frame_ms = out.encoder.frame_duration_ms
    pcm = pcm_bytes(np.zeros(int(48 * frame_ms), np.int16).reshape(-1, 1))
    server.stop()
    deadline = time.monotonic() + 5
    while out.receivers and time.monotonic() < deadline:
        out.write(pcm)  # eventually fails -> _drop_dead -> prune + spawn
        time.sleep(0.01)
    assert not out.receivers
    alive_only = [t for t in out._reconnect_threads if t in done]
    assert not alive_only, "finished reconnect threads were not pruned"
    assert len(out._reconnect_threads) <= 1  # just the live reconnect
    out.close()


@needs_opus
def test_total_loss_surfaced_while_reconnecting():
    """When the LAST receiver dies under auto_reconnect, audio is dropped
    (not queued) while the background reconnect runs; the caller sees it
    via frames_dropped and a single on_no_receivers callback per episode
    instead of silence (ADVICE round 2)."""
    from anet_torch.net.server import AudioStreamServer
    from anet_torch.proto import DiscoveryResponse
    from anet_torch.tx import MulticastAudioOutput, pcm_bytes

    ident = DiscoveryResponse(1, 1, "only", False, "libopus")
    episodes = []
    server = AudioStreamServer(ident, frame_sink=lambda f: None, port=0).start()
    out = MulticastAudioOutput(
        AudioFormat(48_000, 1),
        paced=False,
        reconnect_cooldown_s=30.0,  # keep the endpoint down for the test
        on_no_receivers=lambda: episodes.append(time.monotonic()),
    )
    out.add_receiver("127.0.0.1", server.bound_port)
    frame_ms = out.encoder.frame_duration_ms
    pcm = pcm_bytes(np.zeros(int(48 * frame_ms), np.int16).reshape(-1, 1))
    server.stop()
    deadline = time.monotonic() + 5
    while out.receivers and time.monotonic() < deadline:
        out.write(pcm)
        time.sleep(0.01)
    assert not out.receivers
    before = out.frames_dropped
    for _ in range(3):
        out.write(pcm)  # silently dropped, but counted + surfaced
    assert out.frames_dropped >= before + 3
    assert len(episodes) == 1  # one callback per total-loss episode
    out.close()


# --- across the two packages --------------------------------------------------

import dataclasses  # noqa: E402
import glob  # noqa: E402
import json  # noqa: E402

import anet.codec as jcodec  # noqa: E402
import anet.config as jconfig  # noqa: E402
import anet.rx.playback as jplayback  # noqa: E402
import anet.rx.receiver as jreceiver  # noqa: E402
import anet.tx as jtx  # noqa: E402

import anet_torch.codec as tcodec  # noqa: E402
import anet_torch.config as tconfig  # noqa: E402
import anet_torch.rx.playback as tplayback  # noqa: E402
import anet_torch.rx.receiver as treceiver  # noqa: E402
import anet_torch.tx as ttx  # noqa: E402

RX = {"port": (tconfig, tplayback, treceiver), "reference": (jconfig, jplayback, jreceiver)}
TX = {"port": (tcodec, ttx), "reference": (jcodec, jtx)}


def _session(tx_pkg, rx_pkg):
    """0.5 s of a 440 Hz stereo tone from tx_pkg's MulticastAudioOutput to
    rx_pkg's AnetReceiver (the assertions of the reference's end-to-end
    test); returns the PCM the receiver's sink holds."""
    config, playback, receiver = RX[rx_pkg]
    codec, tx = TX[tx_pkg]
    sink = playback.BufferSink(buffered_seconds=0.05)
    cfg = config.ReceiverConfig(
        device_name=f"{rx_pkg}-rx", tcp_audio_port=0, udp_discovery_port=INTEROP_UDP_PORTS[rx_pkg]
    )
    with receiver.AnetReceiver(sink, cfg) as rx:
        port = rx.network.server.bound_port
        out = tx.MulticastAudioOutput(codec.AudioFormat(48_000, 2), paced=False)
        out.add_receiver("127.0.0.1", port)
        assert out.encoder.frame_duration_ms == 60.0
        t = np.arange(24_000)
        pcm = (0.3 * 32767 * np.sin(2 * np.pi * 440 * t / 48_000)).astype(np.int16)
        stream = out.as_output_stream()
        stream.write(tx.pcm_bytes(np.repeat(pcm, 2).reshape(-1, 2)))
        stream.close()
        deadline = time.monotonic() + 3
        while rx.pipeline.frames_played < 9 and time.monotonic() < deadline:
            time.sleep(0.02)
        stats = out.stats(out.receivers[0])
        assert stats.frames_sent == 9
        while stats.underflows_reported < 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert stats.underflows_reported >= 1
        assert stats.decode_errors_reported == 0
        snap = rx.metrics_snapshot()
        assert snap["counters"]["frames_received"] == 9
        assert snap["counters"]["bytes_received"] > 0
        assert snap["counters"]["underflows_fed_back"] >= 1
        assert snap["gauges"]["frames_played"] == 9
        assert snap["gauges"]["streams_served"] == 1
        assert "playback" in snap["modules"] and "network" in snap["modules"]
        out.close()
    assert len(sink.data) == 9 * constants.MAX_DECODED_FRAME_SIZE
    return sink.data


@needs_opus
def test_opus_session_interop_both_ways():
    """Port transmitter -> reference receiver and reference transmitter ->
    port receiver; both sinks hold the PCM of a session within the port."""
    within = _session("port", "port")
    assert _session("port", "reference") == within
    assert _session("reference", "port") == within


@pytest.mark.parametrize("writer,reader", [("port", "reference"), ("reference", "port")])
def test_config_file_crosses_packages(tmp_path, writer, reader):
    wcfg, rcfg = RX[writer][0], RX[reader][0]
    cfg = wcfg.ReceiverConfig(device_name="kitchen", tcp_audio_port=0, mac_address=0xAABB, queue_depth=12)
    path = tmp_path / "rx.json"
    path.write_text(cfg.to_json())
    loaded = rcfg.await_and_load(str(path), timeout_s=1)
    assert dataclasses.asdict(loaded) == dataclasses.asdict(cfg)
    assert loaded.to_json() == cfg.to_json()
    assert rcfg.ReceiverConfig().resolved_mac() == wcfg.ReceiverConfig().resolved_mac()


def test_config_mode_sighup_enters_config_mode():
    """install_signal_handler routes SIGHUP to enter(): the config bit rises
    while apply runs and drops when it returns."""
    import signal

    gate = threading.Event()
    cm = ConfigMode(lambda: gate.wait(2.0))
    previous = signal.getsignal(signal.SIGHUP)
    try:
        cm.install_signal_handler()
        os.kill(os.getpid(), signal.SIGHUP)
        deadline = time.monotonic() + 2
        while not cm.active and time.monotonic() < deadline:
            time.sleep(0.01)
        assert cm.active
        gate.set()
        assert cm.wait(2.0)
        assert not cm.active
    finally:
        signal.signal(signal.SIGHUP, previous)


def test_device_trace_writes_a_trace_naming_the_ops_run(tmp_path):
    """The trace is a torch.profiler chrome trace (.pt.trace.json, what
    TensorBoard and Perfetto read) under log_dir, and names an op that ran
    inside the context; StageTimer counts the stage around it."""
    import torch

    from anet_torch.obs.profiling import StageTimer, device_trace

    timer = StageTimer()
    log_dir = tmp_path / "trace"
    with device_trace(str(log_dir)), timer.stage("cumsum"):
        torch.arange(64, dtype=torch.float32).cumsum(0)
    files = glob.glob(str(log_dir / "*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(open(files[0]).read())["traceEvents"]}
    assert "aten::cumsum" in names
    assert timer.summary()["cumsum"]["count"] == 1


HOST_EDGE_MODULES = [
    "utils", "utils.errors", "utils.pacing",
    "proto", "proto.wire", "proto.messages", "proto.framing",
    "codec", "codec.errors", "codec.ring", "codec.opus",
    "net", "net.native", "net.discovery", "net.server", "net.session", "net.reconnect",
    "tx", "tx.audio", "tx.session",
    "rx", "rx.runtime", "rx.playback", "rx.receiver",
    "config", "obs", "obs.metrics", "obs.status", "obs.profiling",
]
# what the port's native loader adds: it builds its library from source
NATIVE_BUILD_NAMES = {"build", "build_error", "library_path"}


def _public(module):
    import inspect

    names = set(getattr(module, "__all__", ()))
    for name, obj in vars(module).items():
        if not name.startswith("_") and (inspect.isclass(obj) or inspect.isfunction(obj)):
            if getattr(obj, "__module__", None) == module.__name__:
                names.add(name)
    return names


@pytest.mark.parametrize("name", HOST_EDGE_MODULES)
def test_public_names_equal_to_reference(name):
    import importlib

    ref = importlib.import_module(f"anet.{name}")
    port = importlib.import_module(f"anet_torch.{name}")
    extra = NATIVE_BUILD_NAMES if name == "net.native" else set()
    assert _public(port) == _public(ref) | extra
    assert getattr(port, "__all__", None) == getattr(ref, "__all__", None)
