"""The port's host networking (anet_torch.net): native core, discovery,
sessions, recovery; and its interoperation with the reference (anet.net).

A mirror of tests/test_net.py on the port's modules, on UDP ports of its
own (48865-48870 and 48874; tests/test_net.py binds 48765-48768) and TCP
port 0.
Where the reference skips its native tests because its committed library
is missing, the port's native core is built from anet_torch/net/csrc at
first use, and the tests assert the build succeeded wherever g++ exists.
Then, over loopback and both ways: the port's discover_receivers finds the
reference's DiscoveryResponder (native and Python) and the reverse, and a
transmitter session of one package negotiates with and streams raw frames
to the audio server of the other, with ReceiverError feedback flowing back.
"""

import random
import shutil
import socket
import threading
import time

import pytest

from anet_torch import constants
from anet_torch.net import native
from anet_torch.net.discovery import DiscoveryResponder, discover_receivers
from anet_torch.net.reconnect import ReconnectPolicy
from anet_torch.net.server import AudioStreamServer
from anet_torch.net.session import RemoteAudioReceiver, SessionError
from anet_torch.proto import (
    ToTransmitter,
    AudioData,
    BroadcastMessage,
    DiscoveryResponse,
    ToReceiver,
    encode_delimited,
)
from anet_torch.proto.framing import DelimitedDecoder
from anet_torch.proto.wire import WireError

TEST_UDP_PORT = 48865  # the port's own: tests/test_net.py binds 48765 and 48768

NO_RESPONDER_UDP_PORT = 48866
LIVE_FLAG_UDP_PORT = 48867
INTEROP_UDP_PORT = 48870
HOSTILE_UDP_PORT = 48874


def _gxx() -> bool:
    return shutil.which("g++") is not None


@pytest.fixture
def needs_native():
    """The reference skips its native tests when its committed library is
    missing; the port builds its own from source, so where g++ exists the
    build must have succeeded."""
    if not _gxx():
        pytest.skip("no g++: the native core cannot be built")
    assert native.available(), native.build_error()


def ident(name="test-rx"):
    return DiscoveryResponse(1, 0x0200DEADBEEF, name, False, "libopus 1.3.1")


# --- native core -------------------------------------------------------------

def test_native_framer_matches_python_decoder(needs_native):
    frames_in = [bytes([i]) * (1 + i * 31 % 900) for i in range(40)]
    stream = b"".join(encode_delimited(f) for f in frames_in)
    for chunk in (1, 3, 17, 1000, len(stream)):
        nf = native.NativeFramer()
        pf = DelimitedDecoder()
        got_n, got_p = [], []
        for i in range(0, len(stream), chunk):
            piece = stream[i : i + chunk]
            got_n += nf.feed(piece)
            got_p += pf.feed(piece)
        assert got_n == got_p == frames_in
        assert nf.pending_bytes == 0


def test_native_framer_rejects_corrupt_stream(needs_native):
    nf = native.NativeFramer(max_frame=100)
    with pytest.raises(WireError):
        nf.feed(b"\xff" * 64)  # huge length prefix


@pytest.mark.parametrize(
    "ip,mask,expected",
    [
        # the firmware's own on-device test vectors (test/network.cpp:5-43)
        ("192.168.178.21", "255.255.255.0", "192.168.178.255"),
        ("172.16.5.9", "255.255.0.0", "172.16.255.255"),
        ("10.1.2.3", "255.0.0.0", "10.255.255.255"),
        ("192.168.160.1", "255.255.224.0", "192.168.191.255"),
    ],
)
def test_broadcast_address_math(ip, mask, expected):
    assert native.broadcast_address(ip, mask) == expected


def test_list_interfaces_native_and_fallback_agree():
    """Both enumeration paths (getifaddrs in the C++ core, ioctl fallback)
    must report the same up/broadcast/non-loopback IPv4 interfaces."""
    native_list = native.list_interfaces()
    saved = native._lib, native._load_failed
    try:
        native._lib, native._load_failed = None, True
        fallback_list = native.list_interfaces()
    finally:
        native._lib, native._load_failed = saved
    if native.available():
        assert sorted(native_list) == sorted(fallback_list)
    for addr, mask in native_list:
        assert not addr.startswith("127.")
        # the netmask parses and produces a directed broadcast
        assert native.broadcast_address(addr, mask)


def test_broadcast_targets_multihomed_non24():
    """A multi-homed host with non-/24 masks probes every interface's REAL
    directed broadcast (discovery.kt:33-40) — the old behavior guessed a
    single /24 from gethostbyname and missed receivers on a /16 LAN."""
    from anet_torch.net.discovery import _broadcast_targets

    targets = _broadcast_targets(
        [("10.2.3.4", "255.255.0.0"), ("192.168.160.1", "255.255.224.0")]
    )
    assert "10.2.255.255" in targets  # /16 directed broadcast, not 10.2.3.255
    assert "192.168.191.255" in targets  # /19
    assert "255.255.255.255" in targets  # limited broadcast always included


def test_validate_discovery_request():
    good = BroadcastMessage(constants.MAGIC_WORD, discovery_request=True).encode()
    assert native.validate_discovery_request(good, constants.MAGIC_WORD)
    bad_magic = BroadcastMessage(0x123, discovery_request=True).encode()
    assert not native.validate_discovery_request(bad_magic, constants.MAGIC_WORD)
    response = BroadcastMessage(
        constants.MAGIC_WORD, discovery_response=ident()
    ).encode()
    assert not native.validate_discovery_request(response, constants.MAGIC_WORD)
    assert not native.validate_discovery_request(b"\xff\xfe\x00", constants.MAGIC_WORD)
    assert not native.validate_discovery_request(b"", constants.MAGIC_WORD)


# Length prefixes that narrow to a negative int (0xFFFFFFFA is -6: the
# reference's validator, anet/net/csrc/anet_net.cpp:208, casts before its
# bounds check and steps back to the datagram's start for good), a 64-bit
# one, and truncated fixed-width fields.
HOSTILE_DATAGRAMS = [
    bytes.fromhex("1afaffffff0f"),
    bytes.fromhex("1affffffff0f"),
    bytes.fromhex("1a80808080f0ffffffff01"),
    b"\x09\x01\x02",
    b"\x0d\x01",
]


def _python_discovery_check(datagram):
    """The port's Python check (native.validate_discovery_request's
    fallback): the full codec, then magic word and request."""
    try:
        msg = BroadcastMessage.decode(datagram)
    except WireError:
        return False
    return msg.magic_word == constants.MAGIC_WORD and msg.discovery_request is True


def _mutations(base, rng, count):
    corpus = [base[:cut] for cut in range(len(base) + 1)]
    for _ in range(count):
        b = bytearray(base)
        for _ in range(rng.randrange(1, 4)):
            b[rng.randrange(len(b))] ^= 1 << rng.randrange(8)
        corpus.append(bytes(b) + bytes(rng.randrange(256) for _ in range(rng.randrange(0, 4))))
    return corpus


def _discovery_corpus(kind):
    rng = random.Random(0x4E)
    magic = BroadcastMessage(constants.MAGIC_WORD, discovery_request=False).encode()[:-2]
    if kind == "malformed":
        from test_torch_proto import _malformed_corpus

        return _malformed_corpus()
    if kind == "request-mutations":
        return _mutations(BroadcastMessage(constants.MAGIC_WORD, discovery_request=True).encode(), rng, 3000)
    if kind == "response-then-request":
        # a discovery_response, then a request field: the oneof's last member
        # wins, but only where the response itself decodes
        response = DiscoveryResponse(1, 0xA1B2C3D4E5F6, "k\u00fc\u20ac\U0001f600", True, "libopus 1.3.1")
        base = BroadcastMessage(constants.MAGIC_WORD, discovery_response=response).encode()
        return _mutations(base + b"\x10\x01", rng, 3000)
    # hostile: bad lengths, field number 0, values past 64 bits, a surrogate
    return HOSTILE_DATAGRAMS + [
        magic + b"\x10\x01\x00\x01",
        magic + b"\x10" + b"\x80" * 9 + b"\x02",
        magic[:1] + b"\x80" * 9 + b"\x02" + b"\x10\x01",
        magic + b"\x10\x01" + b"\x80" * 9 + b"\x7f\x01",
        magic + b"\x1a\x02\xed\xa0\x10\x01",
        magic + b"\x10\x01\x0a\x00",
    ]


@pytest.mark.parametrize("kind", ["malformed", "request-mutations", "response-then-request", "hostile"])
def test_native_discovery_check_equals_python_check(needs_native, kind):
    """The native check accepts exactly the datagrams the Python codec
    accepts as a discovery request with our magic word."""
    corpus = _discovery_corpus(kind)
    got = [native.validate_discovery_request(d, constants.MAGIC_WORD) for d in corpus]
    want = [_python_discovery_check(d) for d in corpus]
    for d, g, w in zip(corpus, got, want):
        assert g == w, d.hex()
    if kind != "malformed":
        assert any(want) and not all(want)  # the corpus reaches both answers


@pytest.mark.parametrize("use_native", [True, False])
def test_responder_answers_after_hostile_datagrams(use_native):
    """Both responder loops drop a datagram with a hostile length prefix and
    go on answering; the reference's native check spins on the first one."""
    if use_native:
        if not _gxx():
            pytest.skip("no g++: the native core cannot be built")
        assert native.available(), native.build_error()
    with DiscoveryResponder(ident(), port=HOSTILE_UDP_PORT, use_native=use_native):
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.settimeout(0.3)
            for datagram in HOSTILE_DATAGRAMS:
                s.sendto(datagram, ("127.0.0.1", HOSTILE_UDP_PORT))
            with pytest.raises(socket.timeout):
                s.recvfrom(2048)
        found = discover_receivers(timeout_s=0.7, port=HOSTILE_UDP_PORT, targets=["127.0.0.1"])
    assert [r.device_name for r in found] == ["test-rx"]


# --- discovery ---------------------------------------------------------------

@pytest.mark.parametrize("use_native", [True, False])
def test_discovery_roundtrip(use_native):
    if use_native:
        if not _gxx():
            pytest.skip("no g++: the native core cannot be built")
        assert native.available(), native.build_error()
    with DiscoveryResponder(ident(), port=TEST_UDP_PORT, use_native=use_native):
        found = discover_receivers(
            timeout_s=0.7, port=TEST_UDP_PORT, targets=["127.0.0.1"]
        )
    assert len(found) == 1
    assert found[0].device_name == "test-rx"
    assert found[0].response.opus_version == "libopus 1.3.1"


def test_discovery_ignores_wrong_magic_datagrams():
    with DiscoveryResponder(ident(), port=TEST_UDP_PORT, use_native=False):
        # a stranger's datagram on the same port must get no reply
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.settimeout(0.4)
            s.sendto(
                BroadcastMessage(0x999, discovery_request=True).encode(),
                ("127.0.0.1", TEST_UDP_PORT),
            )
            with pytest.raises(socket.timeout):
                s.recvfrom(2048)


def test_discovery_timeout_no_responders():
    found = discover_receivers(timeout_s=0.3, port=NO_RESPONDER_UDP_PORT, targets=["127.0.0.1"])
    assert found == []


# --- audio session -----------------------------------------------------------

def make_server(sink, **kw):
    return AudioStreamServer(ident(), frame_sink=sink, port=0, **kw)


def test_stream_hello_negotiation_and_frames():
    got = []
    with make_server(got.append) as server:
        rx = RemoteAudioReceiver("127.0.0.1", server.bound_port).connect()
        assert rx.max_encoded_frame_size == constants.MAX_ENCODED_FRAME_SIZE
        assert rx.max_decoded_frame_size == constants.MAX_DECODED_FRAME_SIZE
        frames = [bytes([i]) * (10 + i) for i in range(30)]
        for f in frames:
            rx.send_frame(f)
        deadline = time.monotonic() + 2
        while len(got) < 30 and time.monotonic() < deadline:
            time.sleep(0.01)
        rx.close()
    assert got == frames


def test_session_enforces_negotiated_cap():
    with make_server(lambda f: None, max_encoded_frame_size=100) as server:
        rx = RemoteAudioReceiver("127.0.0.1", server.bound_port).connect()
        assert rx.max_encoded_frame_size == 100
        with pytest.raises(ValueError, match="negotiated cap"):
            rx.send_frame(b"x" * 101)
        rx.close()


def test_server_decode_error_resets_and_reaccepts():
    """Garbage on the stream drops the client; the server then serves a new
    one (network.cpp:432-434 semantics)."""
    got = []
    with make_server(got.append) as server:
        sock = socket.create_connection(("127.0.0.1", server.bound_port))
        DelimitedDecoder().feed(sock.recv(4096))  # swallow hello
        sock.sendall(b"\xff" * 64)  # corrupt length prefix
        time.sleep(0.3)
        sock.close()
        assert server.decode_errors == 1
        # new client works fine
        rx = RemoteAudioReceiver("127.0.0.1", server.bound_port).connect()
        rx.send_frame(b"ok")
        deadline = time.monotonic() + 2
        while not got and time.monotonic() < deadline:
            time.sleep(0.01)
        rx.close()
    assert got == [b"ok"]
    assert server.streams_served == 2


def test_receiver_error_feedback_reaches_transmitter():
    feedback = []
    with make_server(lambda f: None) as server:
        rx = RemoteAudioReceiver(
            "127.0.0.1", server.bound_port, on_feedback=feedback.append
        ).connect()
        deadline = time.monotonic() + 2
        while not server.send_error(True, False) and time.monotonic() < deadline:
            time.sleep(0.01)
        while not feedback and time.monotonic() < deadline:
            time.sleep(0.01)
        rx.close()
    assert feedback and feedback[0].audio_underflow is True


def test_session_requires_hello():
    """A server that sends no hello must be rejected (RemoteAudioReceiver.kt:67)."""
    silent = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    silent.bind(("127.0.0.1", 0))
    silent.listen(1)
    port = silent.getsockname()[1]
    accepted = []

    def accept_and_close():
        c, _ = silent.accept()
        accepted.append(c)
        time.sleep(0.2)
        c.close()

    t = threading.Thread(target=accept_and_close, daemon=True)
    t.start()
    with pytest.raises((SessionError, OSError, WireError)):
        RemoteAudioReceiver("127.0.0.1", port, connect_timeout_s=0.5).connect()
    silent.close()


# --- reconnect policy --------------------------------------------------------

def test_reconnect_retries_then_cooldown():
    sleeps = []
    attempts = []

    def connect():
        attempts.append(1)
        if len(attempts) < 13:
            raise ConnectionError("nope")
        return "ok"

    policy = ReconnectPolicy(sleep=sleeps.append)
    assert policy.run(connect) == "ok"
    # 10 immediate retries, cooldown, then success on the 13th attempt
    assert len(attempts) == 13
    assert sleeps == [1.0]
    assert policy.cooldowns == 1


def test_reconnect_bounded_gives_up():
    policy = ReconnectPolicy(max_immediate_retries=2, sleep=lambda s: None)

    def connect():
        raise ConnectionError("always down")

    with pytest.raises(ConnectionError, match="always down"):
        policy.run(connect, max_cooldowns=3)
    assert policy.attempts == 8  # 2 x (3 cooldowns + 1)


def test_server_serves_one_client_at_a_time():
    """Serial accept semantics (network.cpp:496-516): while one transmitter
    streams, a second connection gets no hello until the first leaves."""
    got = []
    with make_server(got.append) as server:
        first = RemoteAudioReceiver("127.0.0.1", server.bound_port).connect()
        second_sock = socket.create_connection(("127.0.0.1", server.bound_port))
        second_sock.settimeout(0.4)
        with pytest.raises(socket.timeout):
            second_sock.recv(1)  # no hello while the first client is served
        first.close()
        # after the first leaves, the queued client gets its hello
        second_sock.settimeout(2.0)
        data = second_sock.recv(4096)
        assert data, "second client never got a hello"
        from anet_torch.proto.framing import DelimitedDecoder as _DD

        frames = _DD().feed(data)
        assert frames and ToTransmitter.decode(frames[0]).receiver_information
        second_sock.close()
    assert server.streams_served == 2


def test_discovery_reports_live_streaming_flag():
    """currently_streaming in discovery responses tracks the actual stream
    state (the firmware hardcodes false with a TODO, network.cpp:372)."""
    from anet_torch.config import ReceiverConfig
    from anet_torch.rx.playback import BufferSink
    from anet_torch.rx.receiver import AnetReceiver

    cfg = ReceiverConfig(
        device_name="live-flag", tcp_audio_port=0, udp_discovery_port=LIVE_FLAG_UDP_PORT
    )
    with AnetReceiver(BufferSink(), cfg) as rx:
        port = rx.network.server.bound_port

        def query():
            found = discover_receivers(
                timeout_s=0.6, port=LIVE_FLAG_UDP_PORT, targets=["127.0.0.1"]
            )
            assert found, "responder did not answer"
            return found[0].response.currently_streaming

        assert query() is False
        session = RemoteAudioReceiver("127.0.0.1", port).connect()
        deadline = time.monotonic() + 2
        while not query() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert query() is True
        session.close()
        deadline = time.monotonic() + 2
        while query() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert query() is False


def test_native_framer_large_frames_beyond_drain_buffer(needs_native):
    """Frames larger than one drain batch must all surface from a single
    feed (regression: early exit stranded buffered frames)."""
    big = [bytes([i]) * 700_000 for i in range(3)]  # 2.1 MB > 1 MiB out buf
    stream = b"".join(encode_delimited(f) for f in big)
    nf = native.NativeFramer(max_frame=1 << 21)
    got = nf.feed(stream)
    assert [len(f) for f in got] == [700_000] * 3
    assert nf.pending_bytes == 0


def test_paced_sink_pause_before_first_write():
    """pause()/resume() before any write must not raise (regression: killed
    the playback consumer thread)."""
    from anet_torch.rx.playback import BufferSink, PacedSink

    sink = PacedSink(BufferSink())
    sink.pause()
    sink.resume()
    assert sink.buffered_seconds == 0.0
    sink.write(b"\x00" * 19200)  # 0.1 s
    assert sink.buffered_seconds > 0.05


def test_server_soak_many_frames_and_reconnects():
    """Stability: thousands of frames and repeated reconnects through the
    native framer path without drops or leaks."""
    counts = []
    with make_server(lambda f: counts.append(len(f))) as server:
        for session in range(3):
            rx = RemoteAudioReceiver("127.0.0.1", server.bound_port).connect()
            for i in range(1000):
                rx.send_frame(bytes([session]) * (1 + (i * 7) % 1500))
            rx.close()
            deadline = time.monotonic() + 5
            while len(counts) < (session + 1) * 1000 and time.monotonic() < deadline:
                time.sleep(0.01)
        assert len(counts) == 3000
        assert server.streams_served == 3
        assert server.decode_errors == 0


# --- interoperation with the reference over loopback -------------------------

import dataclasses  # noqa: E402

import anet.net as jnet  # noqa: E402
import anet.proto as jproto  # noqa: E402
from anet.net import native as jnative  # noqa: E402

import anet_torch.net as tnet  # noqa: E402
import anet_torch.proto as tproto  # noqa: E402

PACKAGES = {"port": (tnet, tproto, native), "reference": (jnet, jproto, jnative)}
DIRECTIONS = [("port", "reference"), ("reference", "port")]


def _need_native(name):
    """The port's core must be built where g++ exists; the reference's is a
    committed library, skipped as its own tests skip when it does not load."""
    if name == "port":
        if not _gxx():
            pytest.skip("no g++: the native core cannot be built")
        assert native.available(), native.build_error()
    elif not jnative.available():
        pytest.skip("the reference's libanet_net.so does not load")


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("responder,seeker", DIRECTIONS)
def test_discovery_interop(responder, seeker, use_native):
    """One package's discover_receivers finds the other's DiscoveryResponder
    (native C++ loop or Python thread) and reads its identity intact."""
    rnet, rproto, _ = PACKAGES[responder]
    snet, _, _ = PACKAGES[seeker]
    if use_native:
        _need_native(responder)
    card = rproto.DiscoveryResponse(1, 0x0200CAFEF00D, f"{responder}-rx", True, "libopus 1.3.1")
    with rnet.DiscoveryResponder(card, port=INTEROP_UDP_PORT, use_native=use_native):
        found = snet.discover_receivers(timeout_s=0.7, port=INTEROP_UDP_PORT, targets=["127.0.0.1"])
    assert len(found) == 1
    assert found[0].address == "127.0.0.1"
    assert dataclasses.asdict(found[0].response) == dataclasses.asdict(card)


@pytest.mark.parametrize("server_pkg,client_pkg", DIRECTIONS)
def test_session_interop_hello_frames_and_feedback(server_pkg, client_pkg):
    """A transmitter session of one package against the other's audio
    server: the hello's capabilities (a non-default cap too) negotiate, raw
    AudioData frames arrive in order and intact, and ReceiverError feedback
    reaches the transmitter."""
    snet, sproto, _ = PACKAGES[server_pkg]
    cnet, _, _ = PACKAGES[client_pkg]
    card = sproto.DiscoveryResponse(1, 0x0200DEADBEEF, "interop", False, "libopus 1.3.1")
    got, feedback = [], []
    with snet.AudioStreamServer(card, frame_sink=got.append, port=0, max_encoded_frame_size=3000) as server:
        rx = cnet.RemoteAudioReceiver("127.0.0.1", server.bound_port, on_feedback=feedback.append).connect()
        assert rx.max_encoded_frame_size == 3000
        assert rx.max_decoded_frame_size == constants.MAX_DECODED_FRAME_SIZE
        assert dataclasses.asdict(rx.info.discovery_data) == dataclasses.asdict(card)
        frames = [bytes([i]) * (1 + i * 97 % 3000) for i in range(40)]
        for f in frames:
            rx.send_frame(f)
        with pytest.raises(ValueError, match="negotiated cap"):
            rx.send_frame(b"x" * 3001)
        deadline = time.monotonic() + 3
        while len(got) < len(frames) and time.monotonic() < deadline:
            time.sleep(0.01)
        while not server.send_error(False, True) and time.monotonic() < deadline:
            time.sleep(0.01)
        while not feedback and time.monotonic() < deadline:
            time.sleep(0.01)
        rx.close()
    assert got == frames
    assert feedback and (feedback[0].audio_underflow, feedback[0].audio_decode_error) == (False, True)
    assert server.streams_served == 1 and server.decode_errors == 0


@pytest.mark.parametrize("ip,mask", [("192.168.178.21", "255.255.255.0"), ("192.168.160.1", "255.255.224.0")])
def test_broadcast_address_equal_to_reference(ip, mask):
    assert native.broadcast_address(ip, mask) == jnative.broadcast_address(ip, mask)


def test_native_library_built_from_source_into_build_dir():
    """No committed binary: the library sits under build/anet_torch_net/
    with a hash of the source and flags in its name."""
    if not _gxx():
        pytest.skip("no g++: the native core cannot be built")
    assert native.available(), native.build_error()
    path = native.library_path()
    assert path.exists() and path.parent.name == "anet_torch_net" and path.parent.parent.name == "build"
    assert path.name.startswith("libanet_net-") and path.suffix == ".so"
    assert not list((native.SOURCE.parent).glob("*.so"))
