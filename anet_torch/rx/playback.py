"""Playback pipeline: bounded frame queue -> decode -> sink, with underflow
detection and quality feedback.

Parity with the firmware playback module (playback.cpp:80-194):
- bounded queue of encoded frames, depth 40 (playback.cpp:76,152);
- a consumer thread waits for the next frame with an ADAPTIVE timeout:
  the sink's buffered-audio drain time minus a running average of decode
  time (playback.cpp:90, avg update :125-130) — measurement as control
  input;
- a timeout while playing is an UNDERFLOW: pause the sink, count it,
  notify, then wait indefinitely for the stream to resume
  (playback.cpp:92-113);
- per-stream decoder reset (playback_start_new_stream, :67-74);
- mute/unmute gates output (:46-56);
- volume scaling of decoded 16-bit PCM (adjust_volume, :58-64).

Beyond the reference: underflow and decode errors are DELIVERED to the
transmitter via the feedback callback (the TODO at playback.cpp:94) instead
of only being counted, and decode errors skip the frame rather than
abort()ing the process.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Callable, Dict, Optional, Protocol

from anet_torch import constants

logger = logging.getLogger("anet_torch.rx.playback")

FeedbackFn = Callable[[bool, bool], None]  # (underflow, decode_error)


def adjust_volume(pcm: bytes, volume: float) -> bytes:
    """Scale 16-bit interleaved PCM by ``volume``
    (playback_adjust_volume_16bit_dual_channel, playback.cpp:58-64).

    Matches the firmware helper's per-sample ``(int16)((double)s * volume)``
    — truncation toward zero — with the products clamped to the int16
    range (the firmware's cast is undefined there; it is only ever called
    with attenuating volumes, where the two agree)."""
    import numpy as np

    if volume == 1.0:
        return pcm
    samples = np.frombuffer(pcm, dtype="<i2").astype(np.float64) * float(volume)
    out = np.clip(np.trunc(samples), -32768, 32767).astype("<i2")
    return out.tobytes()


class PlaybackSink(Protocol):
    """Where decoded PCM goes (the I2S DMA analog)."""

    def write(self, pcm: bytes) -> None: ...

    def pause(self) -> None: ...

    def resume(self) -> None: ...

    @property
    def buffered_seconds(self) -> float:
        """Audio currently buffered downstream (DMA drain time analog)."""
        ...


class BufferSink:
    """Collects PCM in memory; models a fixed downstream buffer.

    Default buffered_seconds mirrors the firmware's 8 x 720-byte I2S DMA
    geometry (playback.cpp:11-13): 5760 bytes at 48 kHz 16-bit stereo =
    30 ms.
    """

    def __init__(self, buffered_seconds: float = 0.03) -> None:
        self.chunks: list[bytes] = []
        self.paused_count = 0
        self._buffered = buffered_seconds

    def write(self, pcm: bytes) -> None:
        self.chunks.append(pcm)

    def pause(self) -> None:
        self.paused_count += 1

    def resume(self) -> None:
        pass

    @property
    def buffered_seconds(self) -> float:
        return self._buffered

    @property
    def data(self) -> bytes:
        return b"".join(self.chunks)


class WavSink:
    """Writes decoded PCM to a WAV file (48 kHz 16-bit stereo)."""

    def __init__(self, path: str, buffered_seconds: float = 0.03) -> None:
        import wave

        self._wav = wave.open(path, "wb")
        self._wav.setnchannels(constants.DECODE_CHANNELS)
        self._wav.setsampwidth(constants.DECODE_BITS_PER_SAMPLE // 8)
        self._wav.setframerate(constants.DECODE_SAMPLE_RATE_HZ)
        self._buffered = buffered_seconds

    def write(self, pcm: bytes) -> None:
        self._wav.writeframes(pcm)

    def pause(self) -> None:
        pass

    def resume(self) -> None:
        pass

    @property
    def buffered_seconds(self) -> float:
        return self._buffered

    def close(self) -> None:
        self._wav.close()


class PacedSink:
    """Wraps a sink with a real-time DAC drain model.

    The firmware's consumer is paced by the blocking I2S DMA write
    (playback.cpp:132-142): when the 8 x 720-byte DMA ring is full,
    i2s_write blocks until the DAC drains it, and `buffered_seconds` is
    whatever sits in the ring. A file or memory sink returns instantly,
    which would let the consumer outrun the frame cadence and report
    phantom underflows — this wrapper restores the DAC-clock semantics:
    write() blocks while more than ``capacity_seconds`` of audio is
    buffered, and ``buffered_seconds`` reflects the simulated drain.
    """

    def __init__(
        self,
        inner,
        capacity_seconds: float = 0.24,  # ~4 x 60 ms frames of slack
        sample_rate_hz: int = constants.DECODE_SAMPLE_RATE_HZ,
        bytes_per_second: Optional[int] = None,
    ) -> None:
        self.inner = inner
        self.capacity_seconds = capacity_seconds
        self._bps = bytes_per_second or (
            sample_rate_hz * constants.DECODE_CHANNELS * constants.DECODE_BITS_PER_SAMPLE // 8
        )
        self._written_s = 0.0
        self._epoch: Optional[float] = None  # drain clock start
        self._paused_at: Optional[float] = None

    def _drained_s(self) -> float:
        if self._epoch is None:
            return 0.0
        end = self._paused_at if self._paused_at is not None else time.monotonic()
        return max(0.0, end - self._epoch)

    @property
    def buffered_seconds(self) -> float:
        return max(0.0, self._written_s - self._drained_s())

    def write(self, pcm: bytes) -> None:
        if self._epoch is None:
            self._epoch = time.monotonic()
        over = self.buffered_seconds - self.capacity_seconds
        if over > 0:
            time.sleep(over)  # i2s_write blocking on a full DMA ring
        self._written_s += len(pcm) / self._bps
        self.inner.write(pcm)

    def pause(self) -> None:
        if self._paused_at is None:
            self._paused_at = time.monotonic()
        self.inner.pause()

    def resume(self) -> None:
        if self._paused_at is not None:
            # the DAC was stopped, so nothing drained while paused: shift
            # the epoch instead. A pause before the first write leaves
            # _epoch unset — there is nothing to shift yet.
            if self._epoch is not None:
                self._epoch += time.monotonic() - self._paused_at
            self._paused_at = None
        self.inner.resume()


class PlaybackPipeline:
    """Bounded-queue decode/playback consumer."""

    def __init__(
        self,
        sink: PlaybackSink,
        decoder_factory: Optional[Callable[[], object]] = None,
        queue_depth: int = constants.RX_FRAME_QUEUE_DEPTH,
        feedback: Optional[FeedbackFn] = None,
    ) -> None:
        if decoder_factory is None:
            from anet_torch.codec import OpusDecoder

            decoder_factory = OpusDecoder
        self.sink = sink
        self._decoder_factory = decoder_factory
        self._decoder = None
        self._decoder_lock = threading.Lock()
        self._queue: "queue.Queue[bytes]" = queue.Queue(maxsize=queue_depth)
        self._feedback = feedback
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._playing = False
        self._muted = False
        self._volume = 1.0
        # running average decode time, seeded pessimistically like the
        # firmware (playback.cpp:115: starts at 0; we seed 1 ms)
        self._avg_decode_s = 0.001
        # counters (metrics surface)
        self.underflows = 0
        self.decode_errors = 0
        self.frames_played = 0
        self.frames_dropped = 0

    # --- producer side (network thread) --------------------------------------

    def queue_frame(self, encoded: bytes, timeout_s: float = 0.25) -> bool:
        """Enqueue one encoded frame (playback_queue_audio, :174-191).

        Returns False (and counts a drop) if the queue stays full past the
        timeout — the reference logs an error in the same situation.
        """
        try:
            self._queue.put(encoded, timeout=timeout_s)
            return True
        except queue.Full:
            self.frames_dropped += 1
            logger.warning("playback queue full; dropping frame")
            return False

    def start_new_stream(self) -> None:
        """Fresh decoder for a new stream (playback.cpp:67-74)."""
        with self._decoder_lock:
            old, self._decoder = self._decoder, self._decoder_factory()
            if old is not None and hasattr(old, "close"):
                old.close()

    # --- consumer ------------------------------------------------------------

    def start(self) -> "PlaybackPipeline":
        if self._thread is not None:
            raise RuntimeError("pipeline already started")
        if self._decoder is None:
            self.start_new_stream()
        self._thread = threading.Thread(
            target=self._consume_loop, daemon=True, name="anet-playback"
        )
        self._thread.start()
        return self

    def _consume_loop(self) -> None:
        while not self._stop.is_set():
            timeout = None
            if self._playing:
                # DMA-drain-aware wait (playback.cpp:90): we can afford to
                # wait only as long as the sink still has audio, minus the
                # time a decode will take.
                timeout = max(0.001, self.sink.buffered_seconds - self._avg_decode_s)
            try:
                frame = self._queue.get(timeout=timeout)
            except queue.Empty:
                # underflow (playback.cpp:92-108)
                self._playing = False
                self.underflows += 1
                self.sink.pause()
                logger.warning(
                    "audio underflow #%d (avg decode %.2f ms)",
                    self.underflows,
                    self._avg_decode_s * 1e3,
                )
                if self._feedback:
                    self._feedback(True, False)
                continue
            if frame is None:  # sentinel from stop()
                return
            t0 = time.perf_counter()
            try:
                with self._decoder_lock:
                    pcm = self._decoder.decode(frame)
            except Exception as e:  # noqa: BLE001 — decode error path
                self.decode_errors += 1
                logger.warning("frame decode error: %s", e)
                if self._feedback:
                    self._feedback(False, True)
                continue
            dt = time.perf_counter() - t0
            # 7/8 running average like the firmware (playback.cpp:125-130)
            self._avg_decode_s = 0.875 * self._avg_decode_s + 0.125 * dt
            if not self._playing:
                self.sink.resume()
                self._playing = True
            if not self._muted:
                self.sink.write(adjust_volume(pcm, self._volume))
            self.frames_played += 1

    # --- controls ------------------------------------------------------------

    def mute(self) -> None:
        self._muted = True

    def unmute(self) -> None:
        self._muted = False

    @property
    def volume(self) -> float:
        """Output gain applied to decoded PCM (1.0 = unity; see
        adjust_volume)."""
        return self._volume

    @volume.setter
    def volume(self, value: float) -> None:
        if not (0.0 <= value):
            raise ValueError(f"volume must be >= 0, got {value}")
        self._volume = float(value)

    def stop(self) -> None:
        self._stop.set()
        try:
            self._queue.put_nowait(None)  # wake the consumer
        except queue.Full:
            pass
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def status(self) -> Dict:
        return {
            "playing": self._playing,
            "muted": self._muted,
            "volume": self._volume,
            "queued_frames": self._queue.qsize(),
            "frames_played": self.frames_played,
            "frames_dropped": self.frames_dropped,
            "underflows": self.underflows,
            "decode_errors": self.decode_errors,
            "avg_decode_ms": round(self._avg_decode_s * 1e3, 3),
        }
