"""Transmitter session orchestrator: one encoder, many receivers.

Parity with MulticastAudioOutput.kt:18-159:
- owns the Opus encoder and the receiver set;
- on every receiver-set change, renegotiates (MulticastAudioOutput.kt:
  123-131): frame duration = the LARGEST supported duration whose decoded
  bytes fit the SMALLEST receiver decode buffer; max encoded frame size =
  the minimum across receivers;
- paces sends with the leaky bucket modeling receiver queue occupancy in
  ms of audio (capacity 1200 ms, drain 1000 ms/s — :79-86);
- fans each encoded frame to every receiver (:88-96), aggregating per-
  receiver failures so one dead sink doesn't stall the rest;
- a dead receiver is re-established in the background with the firmware's
  recovery policy (network.cpp:437-446, constants network.hpp:7-8): bursts
  of immediate retries separated by cooldowns, forever, rejoining the
  fan-out set on success with its accumulated stats;
- exposes a blocking file-like adapter whose flush() emits the final
  padded frame (:133-155).

Beyond the reference: receivers deliver ReceiverError feedback (underflow/
decode error) into per-receiver counters the application can read.

Silent-drop window: with ``auto_reconnect=True`` (the default) and
``reconnect_max_cooldowns=None`` (retry forever — the firmware's policy),
``write()`` does NOT raise while the last receiver is down; frames are
counted in ``frames_dropped`` and discarded until a reconnect lands, the
same way the hardware keeps consuming its input stream while the WiFi
link is re-established. Callers streaming finite content that must not be
lost should either pass ``on_no_receivers`` (called once per total-loss
episode), watch ``frames_dropped``, or bound the retry with
``reconnect_max_cooldowns`` (write() then raises CombinedError once the
last reconnect gives up).
"""

from __future__ import annotations

import dataclasses
import io
import logging
import threading
from typing import Dict, List, Optional, Set, Tuple

from anet_torch import constants
from anet_torch.codec import AudioFormat, OpusEncoder
from anet_torch.net.reconnect import ReconnectPolicy
from anet_torch.net.session import RemoteAudioReceiver, SessionError
from anet_torch.proto import ReceiverError
from anet_torch.utils import LeakyBucket
from anet_torch.utils.errors import CombinedError

logger = logging.getLogger("anet_torch.tx")


@dataclasses.dataclass
class ReceiverStats:
    frames_sent: int = 0
    underflows_reported: int = 0
    decode_errors_reported: int = 0


# Bitrate ladder for the quality-downgrade reaction: each repeated underflow
# report steps one rung down; sustained clean streaming steps back up.
QUALITY_LADDER_BPS = (92_000, 64_000, 48_000, 32_000, 24_000)


class MulticastAudioOutput:
    def __init__(
        self,
        fmt: AudioFormat = AudioFormat(),
        bitrate_bps: int = constants.DEFAULT_OPUS_BITRATE_BPS,
        pacing: Optional[LeakyBucket] = None,
        paced: bool = True,
        adaptive_quality: bool = True,
        upgrade_after_clean_frames: int = 500,
        auto_reconnect: bool = True,
        reconnect_cooldown_s: float = constants.RECONNECT_COOLDOWN_MS / 1000.0,
        reconnect_max_cooldowns: Optional[int] = None,
        on_no_receivers=None,
    ) -> None:
        self.encoder = OpusEncoder(fmt, bitrate_bps=bitrate_bps)
        self._pacing = pacing if pacing is not None else (LeakyBucket() if paced else None)
        self._receivers: List[RemoteAudioReceiver] = []
        self._stats: Dict[RemoteAudioReceiver, ReceiverStats] = {}
        self._lock = threading.Lock()
        # background session recovery (network.cpp:437-446 behavior)
        self._auto_reconnect = auto_reconnect
        self._reconnect_cooldown_s = reconnect_cooldown_s
        self._reconnect_max_cooldowns = reconnect_max_cooldowns
        self._endpoints: Dict[RemoteAudioReceiver, Tuple[str, int]] = {}
        self._endpoint_stats: Dict[Tuple[str, int], ReceiverStats] = {}
        self._reconnecting: Set[Tuple[str, int]] = set()
        self._reconnect_threads: List[threading.Thread] = []
        self._closing = threading.Event()
        # total-loss surface (see module docstring: silent-drop window)
        self._on_no_receivers = on_no_receivers
        self._in_total_loss = False
        self.frames_dropped = 0
        # quality-downgrade reaction (hardware/README.md:35 promised this;
        # the reference never built either end of the loop — anet does)
        self._adaptive = adaptive_quality
        self._ladder_pos = 0
        self._clean_frames = 0
        self._upgrade_after = upgrade_after_clean_frames
        self._quality_lock = threading.Lock()
        # Serializes every libopus call on this encoder: feedback threads
        # change the bitrate (opus_encoder_ctl) while the send thread may be
        # inside opus_encode, and libopus encoders are not thread-safe.
        self._encoder_lock = threading.Lock()

    # --- receiver management -------------------------------------------------

    def add_receiver(self, host: str, port: int = constants.TCP_AUDIO_PORT) -> RemoteAudioReceiver:
        """Connect + negotiate + join the fan-out set
        (MulticastAudioOutput.kt:58-70).

        An endpoint can be attached once: a duplicate (host, port) would
        double-send every frame and alias the per-endpoint stats that
        reconnect continuity depends on, so it is rejected."""
        with self._lock:
            attached = set(self._endpoints.values())
        if (host, port) in attached or (host, port) in self._reconnecting:
            raise ValueError(f"receiver {host}:{port} is already attached")
        stats = self._endpoint_stats.setdefault((host, port), ReceiverStats())
        receiver = self._connect_endpoint(host, port, stats)
        self._attach(receiver, stats)
        return receiver

    def _connect_endpoint(
        self, host: str, port: int, stats: ReceiverStats
    ) -> RemoteAudioReceiver:
        def on_feedback(err: ReceiverError) -> None:
            if err.audio_underflow:
                stats.underflows_reported += 1
            if err.audio_decode_error:
                stats.decode_errors_reported += 1
            logger.warning("receiver %s reported %s", host, err)
            if err.audio_underflow or err.audio_decode_error:
                self._degrade_quality()

        return RemoteAudioReceiver(host, port, on_feedback=on_feedback).connect()

    def _attach(self, receiver: RemoteAudioReceiver, stats: ReceiverStats) -> None:
        with self._lock:
            self._receivers.append(receiver)
            self._stats[receiver] = stats
            self._endpoints[receiver] = (receiver.host, receiver.port)
            self._on_receivers_changed()

    def remove_receiver(self, receiver: RemoteAudioReceiver) -> None:
        """Deliberate removal: leaves the fan-out set and is NOT resurrected."""
        with self._lock:
            self._endpoint_stats.pop(self._endpoints.pop(receiver, None), None)
            if receiver in self._receivers:
                self._receivers.remove(receiver)
                receiver.close()
                if self._receivers:
                    self._on_receivers_changed()

    # --- session recovery (network.cpp:182-199,437-446 behavior) -------------

    def _drop_dead(self, receiver: RemoteAudioReceiver) -> None:
        """A send failed: leave the set now, rejoin via background reconnect."""
        with self._lock:
            endpoint = self._endpoints.pop(receiver, None)
            if receiver in self._receivers:
                self._receivers.remove(receiver)
                receiver.close()
                if self._receivers:
                    self._on_receivers_changed()
            if (
                endpoint is None
                or not self._auto_reconnect
                or self._closing.is_set()
                or endpoint in self._reconnecting
            ):
                return
            self._reconnecting.add(endpoint)
            # prune finished reconnect threads so a flaky network does not
            # grow the list (and close()'s join set) without bound
            self._reconnect_threads = [
                t for t in self._reconnect_threads if t.is_alive()
            ]
            thread = threading.Thread(
                target=self._reconnect_loop,
                args=(endpoint,),
                daemon=True,
                name=f"anet-reconnect-{endpoint[0]}:{endpoint[1]}",
            )
            self._reconnect_threads.append(thread)
        thread.start()

    def _reconnect_loop(self, endpoint: Tuple[str, int]) -> None:
        host, port = endpoint
        stats = self._endpoint_stats.setdefault(endpoint, ReceiverStats())
        policy = ReconnectPolicy(cooldown_s=self._reconnect_cooldown_s)
        try:
            receiver = policy.run(
                lambda: self._connect_endpoint(host, port, stats),
                max_cooldowns=self._reconnect_max_cooldowns,
                should_continue=lambda: not self._closing.is_set(),
            )
        except Exception as e:  # noqa: BLE001 — bounded out or aborted
            logger.warning(
                "giving up on %s:%d after %d attempts: %s",
                host, port, policy.attempts, e,
            )
            with self._lock:
                self._reconnecting.discard(endpoint)
            return
        with self._lock:
            self._reconnecting.discard(endpoint)
            if self._closing.is_set():
                receiver.close()
                return
        logger.info(
            "receiver %s:%d re-established after %d attempts", host, port, policy.attempts
        )
        self._attach(receiver, stats)

    @property
    def receivers(self) -> List[RemoteAudioReceiver]:
        with self._lock:
            return list(self._receivers)

    def stats(self, receiver: RemoteAudioReceiver) -> ReceiverStats:
        return self._stats[receiver]

    def _on_receivers_changed(self) -> None:
        """Renegotiate frame geometry (MulticastAudioOutput.kt:123-131)."""
        if not self._receivers:
            return
        min_decode_buf = min(r.max_decoded_frame_size for r in self._receivers)
        chosen = None
        for duration in sorted(constants.SUPPORTED_FRAME_DURATIONS_MS, reverse=True):
            decoded = int(48_000 * duration / 1000) * 4  # 48k 16-bit stereo
            if decoded <= min_decode_buf:
                chosen = duration
                break
        if chosen is None:
            raise ValueError(
                f"no supported frame duration fits the smallest receiver "
                f"buffer of {min_decode_buf} bytes"
            )
        self.encoder.frame_duration_ms = chosen
        self.encoder.max_encoded_frame_size = min(
            r.max_encoded_frame_size for r in self._receivers
        )
        logger.info(
            "negotiated frame=%.1f ms, max_encoded=%d B across %d receivers",
            chosen,
            self.encoder.max_encoded_frame_size,
            len(self._receivers),
        )

    # --- data plane ----------------------------------------------------------

    def write(self, pcm: bytes) -> None:
        """Encode + pace + fan out (writeAudio, MulticastAudioOutput.kt:72)."""
        with self._encoder_lock:
            frames = self.encoder.submit(pcm)
        self._send_frames(frames)

    def flush(self) -> None:
        """Emit the zero-padded final frame (:150-153)."""
        with self._encoder_lock:
            frames = self.encoder.final()
        self._send_frames(frames)

    def _send_frames(self, frames: List[bytes]) -> None:
        for frame in frames:
            if self._pacing is not None:
                self._pacing.wait_for_capacity(self.encoder.frame_duration_ms)
            self._fan_out(frame)
            self._maybe_upgrade_quality()

    # --- adaptive quality (the reaction the reference promised but never
    # built: receiver trouble -> lower bitrate; sustained health -> restore)

    @property
    def bitrate_bps(self) -> int:
        return self.encoder.bitrate_bps

    def _degrade_quality(self) -> None:
        if not self._adaptive:
            return
        with self._quality_lock:
            self._clean_frames = 0
            if self._ladder_pos + 1 < len(QUALITY_LADDER_BPS):
                self._ladder_pos += 1
                new_rate = QUALITY_LADDER_BPS[self._ladder_pos]
                with self._encoder_lock:
                    self.encoder.set_bitrate(new_rate)
                logger.warning("quality downgraded to %d bps", new_rate)

    def _maybe_upgrade_quality(self) -> None:
        if not self._adaptive:
            return
        with self._quality_lock:
            self._clean_frames += 1
            if self._ladder_pos > 0 and self._clean_frames >= self._upgrade_after:
                self._clean_frames = 0
                self._ladder_pos -= 1
                new_rate = QUALITY_LADDER_BPS[self._ladder_pos]
                with self._encoder_lock:
                    self.encoder.set_bitrate(new_rate)
                logger.info("quality restored to %d bps", new_rate)

    def _fan_out(self, frame: bytes) -> None:
        """Send one frame to every receiver; drop the dead (scheduling their
        background reconnect), keep going."""
        targets = self.receivers
        dead: List[RemoteAudioReceiver] = []
        errors: List[BaseException] = []
        for receiver in targets:
            try:
                receiver.send_frame(frame)
                self._stats[receiver].frames_sent += 1
            except (SessionError, OSError) as e:
                errors.append(e)
                dead.append(receiver)
        for receiver in dead:
            logger.warning("receiver %s died; reconnecting in background", receiver.host)
            self._drop_dead(receiver)
        if not self.receivers:
            if errors and not self._reconnecting:
                raise CombinedError(errors)  # nobody left, nobody coming back
            # total loss while reconnecting: audio is dropped, not queued
            # (module docstring) — count it and tell the caller once
            self.frames_dropped += 1
            if not self._in_total_loss:
                self._in_total_loss = True
                logger.warning(
                    "no receivers; dropping audio while reconnecting"
                )
                if self._on_no_receivers is not None:
                    self._on_no_receivers()
        else:
            self._in_total_loss = False

    def close(self) -> None:
        self._closing.set()
        for receiver in self.receivers:
            receiver.close()
        with self._lock:
            self._receivers.clear()
        for thread in self._reconnect_threads:
            thread.join(timeout=2.0)
        self.encoder.close()

    # --- OutputStream adapter (:133-155) -------------------------------------

    def as_output_stream(self) -> "MulticastOutputStream":
        return MulticastOutputStream(self)


class MulticastOutputStream(io.RawIOBase):
    """Blocking file-like adapter; flush() emits the final padded frame."""

    def __init__(self, output: MulticastAudioOutput) -> None:
        self._output = output

    def writable(self) -> bool:
        return True

    def write(self, data) -> int:
        self._output.write(bytes(data))
        return len(data)

    def flush(self) -> None:
        self._output.flush()

    def close(self) -> None:
        if not self.closed:
            self.flush()
        super().close()
