"""Transmitter-side TCP session to one receiver.

Parity with RemoteAudioReceiver.kt:17-71: connect to the receiver's audio
port, read one varint-delimited ToTransmitter hello (must be
receiver_information — capability negotiation), then stream delimited
ToReceiver/AudioData frames no larger than the negotiated cap.

Beyond the reference: the session keeps reading after the hello and
surfaces ReceiverError feedback (underflow / decode-error) through a
callback — the loop the reference designed but never built (ip.proto:56-61,
transmitter never reads post-hello).
"""

from __future__ import annotations

import socket
import threading
from typing import Callable, Optional

from anet_torch import constants
from anet_torch.proto import (
    AudioData,
    ReceiverError,
    ReceiverInformation,
    ToReceiver,
    ToTransmitter,
    encode_delimited,
)
from anet_torch.proto.framing import DelimitedDecoder
from anet_torch.proto.wire import WireError

FeedbackCallback = Callable[[ReceiverError], None]


class SessionError(ConnectionError):
    pass


class RemoteAudioReceiver:
    """One connected receiver (thread-safe frame sends)."""

    def __init__(
        self,
        host: str,
        port: int = constants.TCP_AUDIO_PORT,
        connect_timeout_s: float = 5.0,
        on_feedback: Optional[FeedbackCallback] = None,
    ) -> None:
        self.host = host
        self.port = port
        self.on_feedback = on_feedback
        self._sock: Optional[socket.socket] = None
        self._info: Optional[ReceiverInformation] = None
        self._send_lock = threading.Lock()
        self._reader: Optional[threading.Thread] = None
        self._closed = threading.Event()
        self._connect_timeout_s = connect_timeout_s

    # --- lifecycle -----------------------------------------------------------

    def connect(self) -> "RemoteAudioReceiver":
        """TCP connect + hello (RemoteAudioReceiver.kt:48-70)."""
        sock = socket.create_connection(
            (self.host, self.port), timeout=self._connect_timeout_s
        )
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            hello = self._read_one_message(sock)
        except Exception:
            sock.close()
            raise
        if hello is None or hello.receiver_information is None:
            sock.close()
            raise SessionError(
                f"receiver {self.host} sent no receiver_information hello"
            )
        self._info = hello.receiver_information
        self._sock = sock
        sock.settimeout(None)
        self._reader = threading.Thread(
            target=self._feedback_loop, daemon=True, name=f"anet-feedback-{self.host}"
        )
        self._reader.start()
        return self

    def _read_one_message(self, sock: socket.socket) -> Optional[ToTransmitter]:
        decoder = DelimitedDecoder()
        sock.settimeout(self._connect_timeout_s)
        while True:
            chunk = sock.recv(4096)
            if not chunk:
                return None
            frames = decoder.feed(chunk)
            if frames:
                # keep any extra buffered frames for the feedback loop
                self._pending_frames = frames[1:]
                self._decoder = decoder
                return ToTransmitter.decode(frames[0])

    # --- negotiated capabilities ---------------------------------------------

    @property
    def info(self) -> ReceiverInformation:
        if self._info is None:
            raise SessionError("not connected")
        return self._info

    @property
    def max_encoded_frame_size(self) -> int:
        return self.info.max_encoded_frame_size

    @property
    def max_decoded_frame_size(self) -> int:
        return self.info.max_decoded_frame_size

    # --- data plane ----------------------------------------------------------

    def send_frame(self, encoded_frame: bytes) -> None:
        """Wrap + send one encoded audio frame (RemoteAudioReceiver.kt:29-40).

        Enforces the negotiated max encoded size like the reference (:30).
        """
        if self._sock is None:
            raise SessionError("not connected")
        if len(encoded_frame) > self.max_encoded_frame_size:
            raise ValueError(
                f"frame of {len(encoded_frame)} bytes exceeds negotiated cap "
                f"{self.max_encoded_frame_size}"
            )
        payload = ToReceiver(audio_data=AudioData(encoded_frame)).encode()
        data = encode_delimited(payload)
        with self._send_lock:
            try:
                self._sock.sendall(data)
            except OSError as e:
                raise SessionError(f"send to {self.host} failed: {e}") from e

    # --- feedback plane (implemented ReceiverError loop) ---------------------

    def _feedback_loop(self) -> None:
        decoder = getattr(self, "_decoder", DelimitedDecoder())
        pending = list(getattr(self, "_pending_frames", []))
        sock = self._sock
        while not self._closed.is_set() and sock is not None:
            for frame in pending:
                self._handle_feedback(frame)
            pending = []
            try:
                chunk = sock.recv(4096)
            except OSError:
                return
            if not chunk:
                return
            try:
                pending = decoder.feed(chunk)
            except WireError:
                return

    def _handle_feedback(self, frame: bytes) -> None:
        try:
            msg = ToTransmitter.decode(frame)
        except WireError:
            return
        if msg.error is not None and self.on_feedback is not None:
            self.on_feedback(msg.error)

    def close(self) -> None:
        self._closed.set()
        if self._sock is not None:
            try:
                # shutdown (not just close) so the FIN goes out immediately
                # even while the feedback thread blocks in recv on this
                # socket — a bare close defers while the fd is in use and
                # the receiver would never see the stream end.
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._sock.close()
            finally:
                self._sock = None

    def __enter__(self) -> "RemoteAudioReceiver":
        return self.connect()

    def __exit__(self, *exc) -> None:
        self.close()
