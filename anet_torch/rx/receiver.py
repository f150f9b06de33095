"""The assembled receiver: config -> playback -> network -> status.

The main.cpp analog (main.cpp:9-21): modules brought up in dependency
order on a ReceiverRuntime. The network module serves discovery + audio;
frames flow into the playback pipeline's bounded queue; underflow and
decode errors flow BACK to the transmitter as ReceiverError (the loop the
reference designed but never wired, ip.proto:56-61).
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

from anet_torch.codec import opus_version
from anet_torch.config import ReceiverConfig
from anet_torch.net.discovery import DiscoveryResponder
from anet_torch.net.server import AudioStreamServer
from anet_torch.obs.metrics import MetricsRegistry
from anet_torch.proto import DiscoveryResponse
from anet_torch.rx.playback import PlaybackPipeline, PlaybackSink
from anet_torch.rx.runtime import Module, ReceiverRuntime

logger = logging.getLogger("anet_torch.rx.receiver")


class PlaybackModule(Module):
    name = "playback"

    def __init__(self, pipeline: PlaybackPipeline) -> None:
        self.pipeline = pipeline

    def initialize(self, runtime: ReceiverRuntime) -> None:
        self.pipeline.start()

    def shutdown(self) -> None:
        self.pipeline.stop()

    def status(self) -> Dict:
        return self.pipeline.status()


class NetworkModule(Module):
    """Discovery responder + audio server (the network.cpp analog)."""

    name = "network"

    def __init__(
        self,
        config: ReceiverConfig,
        pipeline: PlaybackPipeline,
        streaming_flag_in_discovery: bool = True,
        frame_sink=None,
    ) -> None:
        self.config = config
        self.pipeline = pipeline
        self._frame_sink = frame_sink or pipeline.queue_frame
        self._streaming = False
        self._streaming_in_discovery = streaming_flag_in_discovery
        self.responder: Optional[DiscoveryResponder] = None
        self.server: Optional[AudioStreamServer] = None

    def identity(self) -> DiscoveryResponse:
        """This receiver's card. Unlike the firmware (which hardcodes
        currently_streaming=false with a TODO, network.cpp:372), the flag
        is real."""
        return DiscoveryResponse(
            protocol_version=1,
            mac_address=self.config.resolved_mac(),
            device_name=self.config.device_name,
            currently_streaming=self._streaming if self._streaming_in_discovery else False,
            opus_version=opus_version(),
        )

    def initialize(self, runtime: ReceiverRuntime) -> None:
        self.server = AudioStreamServer(
            identity=self.identity(),
            frame_sink=self._frame_sink,
            on_new_stream=self._on_new_stream,
            on_stream_end=self._on_stream_end,
            port=self.config.tcp_audio_port,
            max_encoded_frame_size=self.config.max_encoded_frame_size,
            max_decoded_frame_size=self.config.max_decoded_frame_size,
        ).start()
        self.responder = DiscoveryResponder(
            self.identity(), port=self.config.udp_discovery_port
        ).start()

    def _on_new_stream(self) -> None:
        self._streaming = True
        self.pipeline.start_new_stream()
        if self.responder is not None:
            self.responder.update_identity(self.identity())

    def _on_stream_end(self) -> None:
        self._streaming = False
        if self.responder is not None:
            self.responder.update_identity(self.identity())

    def send_feedback(self, underflow: bool, decode_error: bool) -> None:
        if self.server is not None:
            self.server.send_error(underflow, decode_error)

    def shutdown(self) -> None:
        if self.responder is not None:
            self.responder.stop()
        if self.server is not None:
            self.server.stop()

    def status(self) -> Dict:
        return {
            "streaming": self._streaming,
            "streams_served": self.server.streams_served if self.server else 0,
            "decode_errors": self.server.decode_errors if self.server else 0,
            "audio_port": (
                self.server.bound_port if self.server else self.config.tcp_audio_port
            ),
        }


class AnetReceiver:
    """Turn-key receiver (discovery + audio server + playback to a sink)."""

    def __init__(
        self,
        sink: PlaybackSink,
        config: Optional[ReceiverConfig] = None,
        metrics: Optional[MetricsRegistry] = None,
    ) -> None:
        self.config = config or ReceiverConfig()
        self.metrics = metrics or MetricsRegistry()
        self.pipeline = PlaybackPipeline(
            sink,
            queue_depth=self.config.queue_depth,
            feedback=self._feedback,
        )
        self.network = NetworkModule(
            self.config, self.pipeline, frame_sink=self._ingest_frame
        )
        self.runtime = (
            ReceiverRuntime()
            .register(PlaybackModule(self.pipeline))
            .register(self.network)
        )

    def _ingest_frame(self, frame: bytes) -> bool:
        """Network -> playback handoff, counted (network.cpp:409-430's
        per-frame path; the counters generalize network_get_state)."""
        self.metrics.count("frames_received")
        self.metrics.count("bytes_received", len(frame))
        ok = self.pipeline.queue_frame(frame)
        if not ok:
            self.metrics.count("frames_dropped_queue_full")
        return ok

    def _feedback(self, underflow: bool, decode_error: bool) -> None:
        if underflow:
            self.metrics.count("underflows_fed_back")
        if decode_error:
            self.metrics.count("decode_errors_fed_back")
        self.network.send_feedback(underflow, decode_error)

    def start(self) -> "AnetReceiver":
        self.runtime.start()
        return self

    def stop(self) -> None:
        self.runtime.stop()

    def apply_config(self, new_config: ReceiverConfig) -> None:
        """Apply a reloaded configuration to the live receiver (the config
        task's hand-off, config.cpp:16-45; the firmware reboots to apply —
        here identity updates propagate in place). Live-applicable fields:
        device_name / mac_address, pushed to the discovery responder so the
        next DiscoveryResponse carries them. Transport fields (ports, frame
        caps, queue depth) keep their bound values until restart, exactly
        like the firmware's post-reboot semantics."""
        self.config = new_config
        self.network.config = new_config
        if self.network.responder is not None:
            self.network.responder.update_identity(self.network.identity())

    def status(self) -> Dict:
        return self.runtime.status()

    def metrics_snapshot(self) -> Dict:
        """One coherent observability snapshot: host counters (frames,
        bytes, feedback events) plus live gauges sampled from every module
        — the receiver-state surface the firmware spreads across
        network_get_state (network.cpp:590-605), the LED poll, and
        Serial.printf counters, in one JSON-able dict."""
        ps = self.pipeline.status()
        ns = self.network.status()
        self.metrics.gauge("queued_frames", ps["queued_frames"])
        self.metrics.gauge("avg_decode_ms", ps["avg_decode_ms"])
        self.metrics.gauge("frames_played", ps["frames_played"])
        self.metrics.gauge("streaming", int(ns["streaming"]))
        self.metrics.gauge("streams_served", ns["streams_served"])
        snap = self.metrics.snapshot()
        snap["modules"] = self.status()["modules"]
        return snap

    def __enter__(self) -> "AnetReceiver":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
