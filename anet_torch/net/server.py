"""Receiver-side TCP audio server.

Parity with the firmware's audio stream server (network.cpp:380-434,
496-516): listen on TCP 58764, serve ONE transmitter at a time; per client
send a delimited ToTransmitter hello advertising this receiver's caps,
reset the decode pipeline for the new stream, then stream-decode delimited
ToReceiver messages and hand each encoded frame to the sink. Any framing/
decode error closes the client and re-enters accept (network.cpp:432-434).

Beyond the reference: `send_error()` actually delivers the ReceiverError
feedback the firmware left as a TODO (playback.cpp:94).
"""

from __future__ import annotations

import socket
import threading
from typing import Callable, Optional

from anet_torch import constants
from anet_torch.net import native
from anet_torch.proto import (
    DiscoveryResponse,
    ReceiverError,
    ReceiverInformation,
    ToReceiver,
    ToTransmitter,
    encode_delimited,
)
from anet_torch.proto.framing import DelimitedDecoder
from anet_torch.proto.wire import WireError

FrameSink = Callable[[bytes], None]


class AudioStreamServer:
    def __init__(
        self,
        identity: DiscoveryResponse,
        frame_sink: FrameSink,
        on_new_stream: Optional[Callable[[], None]] = None,
        on_stream_end: Optional[Callable[[], None]] = None,
        port: int = constants.TCP_AUDIO_PORT,
        max_encoded_frame_size: int = constants.MAX_ENCODED_FRAME_SIZE,
        max_decoded_frame_size: int = constants.MAX_DECODED_FRAME_SIZE,
        use_native_framer: Optional[bool] = None,
    ) -> None:
        self.identity = identity
        self.frame_sink = frame_sink
        self.on_new_stream = on_new_stream
        self.on_stream_end = on_stream_end
        self.port = port
        self.max_encoded_frame_size = max_encoded_frame_size
        self.max_decoded_frame_size = max_decoded_frame_size
        self._use_native = (
            native.available() if use_native_framer is None else use_native_framer
        )
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._server_sock: Optional[socket.socket] = None
        self._client: Optional[socket.socket] = None
        self._client_lock = threading.Lock()
        self.streams_served = 0
        self.decode_errors = 0

    @property
    def bound_port(self) -> int:
        """Actual port (useful when constructed with port=0 for tests)."""
        if self._server_sock is None:
            raise RuntimeError("server not started")
        return self._server_sock.getsockname()[1]

    def start(self) -> "AudioStreamServer":
        if self._thread is not None:
            raise RuntimeError("server already started")
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind(("", self.port))
        sock.listen(1)  # one transmitter at a time (network.cpp:510)
        sock.settimeout(0.2)
        self._server_sock = sock
        self._thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="anet-audio-server"
        )
        self._thread.start()
        return self

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                client, _ = self._server_sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                self._serve_client(client)
            finally:
                with self._client_lock:
                    self._client = None
                try:
                    client.close()
                except OSError:
                    pass
                if self.on_stream_end is not None:
                    self.on_stream_end()

    def _serve_client(self, client: socket.socket) -> None:
        """Hello + stream loop for one transmitter (network.cpp:380-434)."""
        client.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        hello = ToTransmitter(
            receiver_information=ReceiverInformation(
                discovery_data=self.identity,
                max_encoded_frame_size=self.max_encoded_frame_size,
                max_decoded_frame_size=self.max_decoded_frame_size,
            )
        )
        try:
            client.sendall(encode_delimited(hello.encode()))
        except OSError:
            return
        with self._client_lock:
            self._client = client
        if self.on_new_stream is not None:
            self.on_new_stream()  # playback_start_new_stream analog
        self.streams_served += 1

        framer = (
            native.NativeFramer(max_frame=1 << 20)
            if self._use_native
            else DelimitedDecoder()
        )
        try:
            client.settimeout(0.2)
        except OSError:
            return  # stop() closed the client between registration and here
        while not self._stop.is_set():
            try:
                chunk = client.recv(65536)
            except socket.timeout:
                continue
            except OSError:
                return
            if not chunk:
                return  # transmitter hung up; back to accept
            try:
                frames = framer.feed(chunk)
                for frame in frames:
                    msg = ToReceiver.decode(frame, self.max_encoded_frame_size)
                    if msg.audio_data is not None:
                        self.frame_sink(msg.audio_data.opus_encoded_frame)
            except WireError:
                # decode error: drop the client, re-accept (network.cpp:432)
                self.decode_errors += 1
                self.send_error(audio_underflow=False, audio_decode_error=True)
                return

    def send_error(self, audio_underflow: bool, audio_decode_error: bool) -> bool:
        """Send ReceiverError feedback to the connected transmitter.

        The implemented version of the firmware's TODO (playback.cpp:94).
        Returns False if no transmitter is connected.
        """
        with self._client_lock:
            client = self._client
        if client is None:
            return False
        msg = ToTransmitter(
            error=ReceiverError(
                audio_underflow=audio_underflow,
                audio_decode_error=audio_decode_error,
            )
        )
        try:
            client.sendall(encode_delimited(msg.encode()))
            return True
        except OSError:
            return False

    def stop(self) -> None:
        self._stop.set()
        if self._server_sock is not None:
            try:
                self._server_sock.close()
            except OSError:
                pass
        with self._client_lock:
            if self._client is not None:
                try:
                    self._client.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    self._client.close()
                except OSError:
                    pass
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def __enter__(self) -> "AudioStreamServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
