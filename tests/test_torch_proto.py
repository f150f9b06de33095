"""The port's wire codec (anet_torch.proto) against google.protobuf, nanopb
and the reference (anet.proto).

Mirrors of tests/test_proto_wire.py (golden compatibility with the stock
google.protobuf runtime through tests/golden/anet_testschema_pb2.py) and of
tests/test_nanopb_cross.py (the nanopb harness, skipped where it cannot be
built, and the committed nanopb vectors), run on the port's modules; then
the two packages against each other: every message encoded from the same
fields gives the same bytes (hypothesis over the fields, boundary varints
and strings at the nanopb caps), each package decodes the other's bytes to
equal fields, both raise WireError on the same malformed inputs, and the
framers (the port's native C++ NativeFramer and both Python
DelimitedDecoders) cut the same frames from the same byte stream fed in
random splits.
"""

import io
import sys
from pathlib import Path

import pytest

from anet_torch import constants
from anet_torch.proto import (
    AudioData,
    BroadcastMessage,
    DelimitedDecoder,
    DiscoveryResponse,
    ReceiverError,
    ReceiverInformation,
    ToReceiver,
    ToTransmitter,
    WireError,
    decode_varint,
    encode_delimited,
    encode_varint,
    read_delimited,
    write_delimited,
)
from anet_torch.proto.framing import iter_delimited

sys.path.insert(0, str(Path(__file__).parent / "golden"))
import anet_testschema_pb2 as pb  # noqa: E402


def ref_discovery() -> DiscoveryResponse:
    return DiscoveryResponse(
        protocol_version=constants.PROTOCOL_VERSION,
        mac_address=0xA1B2C3D4E5F6,
        device_name="living-room",
        currently_streaming=False,
        opus_version="libopus 1.3.1",
    )


def pb_discovery() -> "pb.DiscoveryResponse":
    return pb.DiscoveryResponse(
        protocol_version=constants.PROTOCOL_VERSION,
        mac_address=0xA1B2C3D4E5F6,
        device_name="living-room",
        currently_streaming=False,
        opus_version="libopus 1.3.1",
    )


# --- varints -----------------------------------------------------------------

@pytest.mark.parametrize(
    "value,expected",
    [
        (0, b"\x00"),
        (1, b"\x01"),
        (127, b"\x7f"),
        (128, b"\x80\x01"),
        (300, b"\xac\x02"),
        (constants.MAGIC_WORD, bytes.fromhex("c4c0f6e202")),
        ((1 << 64) - 1, b"\xff" * 9 + b"\x01"),
    ],
)
def test_varint_roundtrip(value, expected):
    assert encode_varint(value) == expected
    decoded, pos = decode_varint(expected)
    assert decoded == value and pos == len(expected)


def test_varint_rejects_overlong():
    with pytest.raises(WireError):
        decode_varint(b"\x80" * 11)
    with pytest.raises(WireError):
        decode_varint(b"\x80\x80")  # truncated


# --- message byte-compat vs google.protobuf ----------------------------------

def test_broadcast_request_bytes_match_protobuf():
    ours = BroadcastMessage(constants.MAGIC_WORD, discovery_request=True)
    theirs = pb.BroadcastMessage(magic_word=constants.MAGIC_WORD, discovery_request=True)
    assert ours.encode() == theirs.SerializeToString()
    # decode their bytes with our codec
    back = BroadcastMessage.decode(theirs.SerializeToString())
    assert back.has_valid_magic and back.discovery_request is True
    assert back.discovery_response is None


def test_discovery_response_bytes_match_protobuf():
    assert ref_discovery().encode() == pb_discovery().SerializeToString()
    back = DiscoveryResponse.decode(pb_discovery().SerializeToString())
    assert back == ref_discovery()


def test_broadcast_response_nested():
    ours = BroadcastMessage(constants.MAGIC_WORD, discovery_response=ref_discovery())
    theirs = pb.BroadcastMessage(magic_word=constants.MAGIC_WORD)
    theirs.discovery_response.CopyFrom(pb_discovery())
    assert ours.encode() == theirs.SerializeToString()
    assert BroadcastMessage.decode(ours.encode()).discovery_response == ref_discovery()


def test_receiver_information_hello_bytes():
    """The firmware hello (network.cpp:380-404): caps 4096/11520."""
    ours = ToTransmitter(
        receiver_information=ReceiverInformation(
            discovery_data=ref_discovery(),
            max_encoded_frame_size=constants.MAX_ENCODED_FRAME_SIZE,
            max_decoded_frame_size=constants.MAX_DECODED_FRAME_SIZE,
        )
    )
    theirs = pb.ToTransmitter()
    theirs.receiver_information.discovery_data.CopyFrom(pb_discovery())
    theirs.receiver_information.max_encoded_frame_size = constants.MAX_ENCODED_FRAME_SIZE
    theirs.receiver_information.max_decoded_frame_size = constants.MAX_DECODED_FRAME_SIZE
    assert ours.encode() == theirs.SerializeToString()
    back = ToTransmitter.decode(theirs.SerializeToString())
    assert back.receiver_information.max_encoded_frame_size == 4096
    assert back.receiver_information.max_decoded_frame_size == 11520


def test_receiver_error_bytes():
    ours = ToTransmitter(error=ReceiverError(audio_underflow=True, audio_decode_error=False))
    theirs = pb.ToTransmitter()
    theirs.error.audio_underflow = True
    theirs.error.audio_decode_error = False
    assert ours.encode() == theirs.SerializeToString()
    assert ToTransmitter.decode(ours.encode()).error.audio_underflow is True


def test_audio_frame_bytes():
    payload = bytes(range(256)) * 4
    ours = ToReceiver(audio_data=AudioData(payload))
    theirs = pb.ToReceiver()
    theirs.audio_data.opus_encoded_frame = payload
    assert ours.encode() == theirs.SerializeToString()
    assert ToReceiver.decode(theirs.SerializeToString()).audio_data.opus_encoded_frame == payload


# --- proto2 strictness -------------------------------------------------------

def test_required_field_missing_raises():
    with pytest.raises(WireError, match="magic_word"):
        BroadcastMessage.decode(b"")
    with pytest.raises(WireError, match="protocol_version"):
        DiscoveryResponse.decode(b"")


def test_oneof_double_set_rejected():
    with pytest.raises(WireError, match="oneof"):
        BroadcastMessage(
            constants.MAGIC_WORD, discovery_request=True, discovery_response=ref_discovery()
        )


def test_oneof_last_wins_on_decode():
    # request followed by response on the wire: response wins (merge semantics)
    data = (
        BroadcastMessage(constants.MAGIC_WORD, discovery_request=True).encode()
        + BroadcastMessage(0, discovery_response=ref_discovery()).encode()[2:]
    )
    # construct manually: magic + request field + response field
    from anet_torch.proto import wire as w

    data = (
        w.encode_varint_field(1, constants.MAGIC_WORD)
        + w.encode_varint_field(2, 1)
        + w.encode_len_field(3, ref_discovery().encode())
    )
    msg = BroadcastMessage.decode(data)
    assert msg.discovery_request is None
    assert msg.discovery_response == ref_discovery()


def test_frame_cap_enforced_like_firmware():
    """The firmware rejects frames > 4096 bytes (network.cpp:24,223)."""
    big = ToReceiver(audio_data=AudioData(b"\x00" * 4097)).encode()
    with pytest.raises(WireError, match="exceeds cap"):
        ToReceiver.decode(big)
    ok = ToReceiver(audio_data=AudioData(b"\x00" * 4096)).encode()
    assert len(ToReceiver.decode(ok).audio_data.opus_encoded_frame) == 4096


def test_nanopb_string_cap_enforced_on_encode():
    """device_name/opus_version capped at 127 usable bytes: nanopb's
    max_size:128 (protobuf_ip.options:1-2) includes the NUL terminator —
    the real pb_decode rejects a 128-byte string with "string overflow"
    (verified against the actual codec in tests/test_nanopb_cross.py)."""
    with pytest.raises(WireError, match="nanopb cap"):
        DiscoveryResponse(1, 0, "x" * 128, False, "v").encode()
    DiscoveryResponse(1, 0, "x" * 127, False, "v").encode()  # max passes


def test_unknown_fields_skipped():
    from anet_torch.proto import wire as w

    data = ref_discovery().encode() + w.encode_varint_field(99, 7) + w.encode_len_field(100, b"zz")
    assert DiscoveryResponse.decode(data) == ref_discovery()


# --- delimited framing -------------------------------------------------------

def test_delimited_matches_protobuf_java_writeDelimitedTo():
    """google.protobuf's SerializeDelimited* shares the varint-prefix format
    with protobuf-java writeDelimitedTo (AsyncProtobufTest.kt:39 pattern)."""
    from google.protobuf.internal.encoder import _VarintBytes

    msg = pb_discovery()
    java_style = _VarintBytes(msg.ByteSize()) + msg.SerializeToString()
    assert encode_delimited(ref_discovery().encode()) == java_style


def test_delimited_stream_roundtrip():
    buf = io.BytesIO()
    frames = [b"", b"a", b"hello world", bytes(300)]
    for f in frames:
        write_delimited(buf, f)
    buf.seek(0)
    out = []
    while (f := read_delimited(buf)) is not None:
        out.append(f)
    assert out == frames


def test_delimited_truncation_detected():
    data = encode_delimited(b"hello")[:-2]
    buf = io.BytesIO(data)
    with pytest.raises(WireError):
        read_delimited(buf)


def test_incremental_decoder_fragmented_feed():
    """Framing state must survive arbitrary fragmentation — the same property
    the firmware's recv-backed pb_istream has (network.cpp:262-305)."""
    stream = b"".join(
        encode_delimited(ToReceiver(audio_data=AudioData(bytes([i]) * (i + 1))).encode())
        for i in range(20)
    )
    for chunk_size in (1, 2, 3, 7, 64, len(stream)):
        dec = DelimitedDecoder()
        frames = []
        for i in range(0, len(stream), chunk_size):
            frames += dec.feed(stream[i : i + chunk_size])
        assert len(frames) == 20
        assert dec.pending_bytes == 0
        for i, frame in enumerate(frames):
            assert ToReceiver.decode(frame).audio_data.opus_encoded_frame == bytes([i]) * (i + 1)


def test_decoder_rejects_oversized_frame():
    dec = DelimitedDecoder(max_bytes=10)
    with pytest.raises(WireError, match="exceeds cap"):
        dec.feed(encode_varint(11))


def test_iter_delimited():
    data = encode_delimited(b"a") + encode_delimited(b"bc")
    assert list(iter_delimited(data)) == [b"a", b"bc"]


# --- asyncio framing ---------------------------------------------------------

def test_asyncio_delimited_roundtrip():
    """The protobuf_async.kt analog: coroutine read/write of delimited
    messages over an in-memory asyncio transport (the fake-channel test
    pattern from AsyncProtobufTest.kt:53)."""
    import asyncio

    from anet_torch.proto.framing import (
        read_delimited_async,
        read_delimited_message,
        write_delimited_async,
    )

    async def scenario():
        reader = asyncio.StreamReader()
        # loop the bytes straight back into the reader
        class Loopback:
            def write(self, data):
                reader.feed_data(data)

        writer = Loopback()
        hello = ToTransmitter(
            receiver_information=ReceiverInformation(
                discovery_data=ref_discovery(),
                max_encoded_frame_size=4096,
                max_decoded_frame_size=11520,
            )
        )
        write_delimited_async(writer, hello.encode())
        for i in range(5):
            write_delimited_async(
                writer, ToReceiver(audio_data=AudioData(bytes([i]) * 99)).encode()
            )
        reader.feed_eof()
        first = await read_delimited_message(reader, ToTransmitter.decode)
        assert first.receiver_information.max_encoded_frame_size == 4096
        frames = []
        while (raw := await read_delimited_async(reader)) is not None:
            frames.append(ToReceiver.decode(raw).audio_data.opus_encoded_frame)
        assert frames == [bytes([i]) * 99 for i in range(5)]
        # clean EOF at a boundary -> None
        assert await read_delimited_async(reader) is None

    asyncio.run(scenario())


def test_asyncio_truncated_stream_raises():
    import asyncio

    from anet_torch.proto.framing import read_delimited_async

    async def scenario():
        reader = asyncio.StreamReader()
        reader.feed_data(encode_delimited(b"hello world")[:-3])
        reader.feed_eof()
        with pytest.raises(WireError, match="EOF inside"):
            await read_delimited_async(reader)

    asyncio.run(scenario())


# --- robustness: arbitrary bytes never crash the codec -----------------------

def test_decoder_never_crashes_on_random_bytes():
    """Every decode path must raise WireError (or succeed) on arbitrary
    input — never UnicodeDecodeError, IndexError, or similar. The host edge
    feeds these decoders raw LAN datagrams."""
    import random

    rng = random.Random(0xA044)
    decoders = [
        BroadcastMessage.decode,
        DiscoveryResponse.decode,
        ToReceiver.decode,
        ToTransmitter.decode,
        AudioData.decode,
        ReceiverError.decode,
    ]
    corpus = [bytes(rng.randrange(256) for _ in range(rng.randrange(0, 80)))
              for _ in range(300)]
    # plus mutated valid messages (bit flips in real encodings)
    valid = BroadcastMessage(
        constants.MAGIC_WORD, discovery_response=ref_discovery()
    ).encode()
    for _ in range(200):
        b = bytearray(valid)
        for _ in range(rng.randrange(1, 4)):
            b[rng.randrange(len(b))] ^= 1 << rng.randrange(8)
        corpus.append(bytes(b))
    for data in corpus:
        for dec in decoders:
            try:
                dec(data)
            except WireError:
                pass  # the one sanctioned failure mode


def test_framer_never_crashes_on_random_streams():
    import random

    rng = random.Random(7)
    for _ in range(50):
        dec = DelimitedDecoder(max_bytes=4096)
        stream = bytes(rng.randrange(256) for _ in range(rng.randrange(1, 400)))
        try:
            for i in range(0, len(stream), 13):
                dec.feed(stream[i : i + 13])
        except WireError:
            pass


# --- nanopb (mirror of tests/test_nanopb_cross.py) ---------------------------

from test_nanopb_cross import run_harness  # noqa: E402

HARNESS_DIR = Path(__file__).resolve().parents[1] / "tools" / "nanopb_harness"


@pytest.fixture(scope="session")
def harness(tmp_path_factory):
    """Build the nanopb harness and return its path, or skip where the
    reference tree or a C toolchain is absent. The build goes to a
    directory of this session's own: tests/test_nanopb_cross.py builds into
    tools/nanopb_harness/build, and the two files may run at once on
    different workers."""
    import shutil
    import subprocess

    if shutil.which("make") is None or (shutil.which("cc") is None and shutil.which("gcc") is None):
        pytest.skip("no C compiler")
    out = tmp_path_factory.mktemp("nanopb_harness")
    build = subprocess.run(
        ["make", "-C", str(HARNESS_DIR), f"BUILD={out}"], capture_output=True, text=True, timeout=120
    )
    binary = out / "nanopb_harness"
    if build.returncode != 0 or not binary.exists():
        pytest.skip(f"harness not built (the reference tree is absent?): {build.stderr[-300:]}")
    return binary

GOLDEN = Path(__file__).resolve().parent / "golden"

DISCOVERY = DiscoveryResponse(
    protocol_version=1,
    mac_address=0xAABBCCDDEEFF,
    device_name="anet cross-validation receiver",
    currently_streaming=False,
    opus_version="libopus 1.3.1",
)
HELLO = ToTransmitter(
    receiver_information=ReceiverInformation(
        discovery_data=DISCOVERY,
        max_encoded_frame_size=constants.MAX_ENCODED_FRAME_SIZE,
        max_decoded_frame_size=constants.MAX_DECODED_FRAME_SIZE,
    )
)


def test_nanopb_decodes_anet_audio_stream(harness):
    """Frame-for-frame: anet-emitted delimited ToReceiver messages decode
    in the loop a real receiver runs (network.cpp:409-430)."""
    frames = [bytes([i % 256] * n) for i, n in enumerate([1, 57, 1275, 4096])]
    stream = b"".join(
        encode_delimited(ToReceiver(audio_data=AudioData(f)).encode()) for f in frames
    )
    lines = run_harness(harness, "decode-toreceiver", stdin=stream).decode().splitlines()
    assert lines[-1] == f"eof frames={len(frames)}"
    for f, line in zip(frames, lines):
        assert line == f"frame len={len(f)} data={f.hex()}"


def test_nanopb_enforces_frame_cap_on_anet_bytes(harness):
    """A frame over MAX_ENCODED_FRAME_SIZE kills the connection mid-stream
    (network.cpp:24,223) — frames before it decode, the oversize errors."""
    ok = encode_delimited(ToReceiver(audio_data=AudioData(b"x" * 100)).encode())
    # anet refuses to BUILD an oversize frame (part of the same contract),
    # so craft the raw bytes by hand
    from anet_torch.proto import wire

    oversize = wire.encode_len_field(1, wire.encode_len_field(1, b"z" * 4097))
    stream = ok + encode_delimited(oversize)
    out = run_harness(harness, "decode-toreceiver", stdin=stream).decode()
    lines = out.splitlines()
    assert lines[0].startswith("frame len=100")
    # nanopb reports the cap rejection as "callback failed" (the callback's
    # own errmsg is dropped on the early-return path, pb_decode.c
    # decode_callback_field) — the contract is that the frame is REFUSED
    # and the connection dies, which the firmware logs the same way.
    assert lines[1].startswith("error frames=1")


def test_nanopb_decodes_anet_hello_and_error(harness):
    out = run_harness(
        harness,
        "decode-totransmitter",
        stdin=encode_delimited(HELLO.encode())
        + encode_delimited(ToTransmitter(error=ReceiverError(True, False)).encode()),
    ).decode()
    lines = out.splitlines()
    assert lines[0] == (
        "receiver_information protocol_version=1 mac=187723572702975 "
        "name=anet cross-validation receiver streaming=0 "
        "opus=libopus 1.3.1 max_enc=4096 max_dec=11520"
    )
    assert lines[1] == "receiver_error underflow=1 decode_error=0"
    assert lines[2] == "eof msgs=2"


def test_nanopb_rejects_128_byte_string(harness):
    """nanopb's max_size:128 includes the NUL: a 128-byte device name is
    'string overflow' to the real codec (pb_decode.c pb_dec_string), so
    anet caps at 127 — and a hand-crafted 128-byte one must fail."""
    from anet_torch.proto import wire

    with pytest.raises(WireError):
        DiscoveryResponse(1, 0, "x" * 128, False, "v").encode()
    body = (
        wire.encode_varint_field(1, 1)
        + wire.encode_varint_field(2, 0)
        + wire.encode_len_field(3, b"x" * 128)
        + wire.encode_varint_field(4, 0)
        + wire.encode_len_field(5, b"v")
    )
    hello = wire.encode_len_field(
        1,
        wire.encode_len_field(1, body)
        + wire.encode_varint_field(2, 4096)
        + wire.encode_varint_field(3, 11520),
    )
    out = run_harness(harness, "decode-totransmitter", stdin=encode_delimited(hello))
    assert b"string overflow" in out
    # the 127-byte maximum passes both codecs
    ok = ToTransmitter(
        receiver_information=ReceiverInformation(
            DiscoveryResponse(1, 0, "n" * 127, False, "v"), 1, 1
        )
    )
    out = run_harness(
        harness, "decode-totransmitter", stdin=encode_delimited(ok.encode())
    ).decode()
    assert "name=" + "n" * 127 in out


def test_nanopb_decodes_anet_broadcast(harness):
    req = BroadcastMessage(magic_word=constants.MAGIC_WORD, discovery_request=True)
    out = run_harness(harness, "decode-broadcast", stdin=req.encode()).decode()
    assert out.startswith("magic=2c5da044 which=2 request=1")
    resp = BroadcastMessage(
        magic_word=constants.MAGIC_WORD, discovery_response=DISCOVERY
    )
    out = run_harness(harness, "decode-broadcast", stdin=resp.encode()).decode()
    assert "name=anet cross-validation receiver" in out
    assert "mac=187723572702975" in out


# --- real nanopb bytes -> anet ------------------------------------------------


def test_anet_decodes_nanopb_hello(harness):
    data = run_harness(
        harness,
        "encode-hello",
        "1",
        str(0xAABBCCDDEEFF),
        "esp32 loudspeaker",
        "0",
        "libopus 1.3.1",
        "4096",
        "11520",
    )
    payloads = list(iter_delimited(data))
    assert len(payloads) == 1
    msg = ToTransmitter.decode(payloads[0])
    ri = msg.receiver_information
    assert ri is not None
    assert ri.discovery_data.device_name == "esp32 loudspeaker"
    assert ri.discovery_data.mac_address == 0xAABBCCDDEEFF
    assert ri.max_encoded_frame_size == 4096
    assert ri.max_decoded_frame_size == 11520


def test_anet_decodes_nanopb_audio_and_error(harness):
    frames = [b"\x00", b"opus" * 300, b"q" * 4096]
    stdin = b"".join(len(f).to_bytes(4, "big") + f for f in frames)
    data = run_harness(harness, "encode-audio", stdin=stdin)
    decoded = [ToReceiver.decode(p).audio_data.opus_encoded_frame
               for p in iter_delimited(data)]
    assert decoded == frames

    err = run_harness(harness, "encode-error", "0", "1")
    msg = ToTransmitter.decode(next(iter(iter_delimited(err))))
    assert msg.error == ReceiverError(audio_underflow=False, audio_decode_error=True)


def test_anet_decodes_nanopb_broadcast(harness):
    req = run_harness(harness, "encode-broadcast-request")
    msg = BroadcastMessage.decode(req)
    assert msg.magic_word == constants.MAGIC_WORD and msg.discovery_request
    resp = run_harness(
        harness, "encode-broadcast-response", "1", "42", "dev", "1", "opus"
    )
    msg = BroadcastMessage.decode(resp)
    assert msg.discovery_response.device_name == "dev"
    assert msg.discovery_response.currently_streaming is True


# --- committed golden vectors (run everywhere) ------------------------------


def test_golden_nanopb_vectors_decode():
    """Bytes emitted by the real nanopb encoder (checked in; regenerate
    with tools/nanopb_harness/gen_goldens.sh) parse in anet."""
    hello = (GOLDEN / "nanopb_hello.bin").read_bytes()
    msg = ToTransmitter.decode(next(iter(iter_delimited(hello))))
    assert msg.receiver_information.discovery_data.device_name == "esp32 loudspeaker"
    assert msg.receiver_information.max_encoded_frame_size == 4096

    audio = (GOLDEN / "nanopb_audio.bin").read_bytes()
    frames = [ToReceiver.decode(p).audio_data.opus_encoded_frame
              for p in iter_delimited(audio)]
    assert [len(f) for f in frames] == [1, 1200, 4096]

    bc = (GOLDEN / "nanopb_broadcast_response.bin").read_bytes()
    msg = BroadcastMessage.decode(bc)
    assert msg.magic_word == constants.MAGIC_WORD
    assert msg.discovery_response.device_name == "esp32 loudspeaker"


# --- the port against the reference ------------------------------------------

import dataclasses  # noqa: E402
import random  # noqa: E402

from hypothesis import HealthCheck, given, settings, strategies as st  # noqa: E402

import anet.proto as jproto  # noqa: E402
from anet.proto import framing as jframing, wire as jwire  # noqa: E402

import anet_torch.proto as tproto  # noqa: E402
from anet_torch.net import native  # noqa: E402
from anet_torch.proto import framing as tframing, wire as twire  # noqa: E402

_U32_EDGES = [0, 1, 127, 128, 16383, 16384, (1 << 31) - 1, (1 << 32) - 1]
_U64_EDGES = _U32_EDGES + [1 << 32, (1 << 63) - 1, 1 << 63, (1 << 64) - 1]
u32 = st.one_of(st.sampled_from(_U32_EDGES + [-1, 1 << 32]), st.integers(0, (1 << 32) - 1))
u64 = st.one_of(st.sampled_from(_U64_EDGES + [-1, 1 << 64]), st.integers(0, (1 << 64) - 1))
# strings about the nanopb cap (127 usable bytes), multi-byte characters too
capped = st.one_of(
    st.text(max_size=140),
    st.integers(120, 130).map(lambda n: "x" * n),
    st.integers(60, 66).map(lambda n: "é" * n),
)
frame_bytes = st.one_of(
    st.binary(max_size=64),
    st.integers(4090, 4100).map(lambda n: b"\x5a" * n),
)


def _discovery_spec():
    return st.tuples(st.just("DiscoveryResponse"), st.fixed_dictionaries({
        "protocol_version": u32, "mac_address": u64, "device_name": capped,
        "currently_streaming": st.booleans(), "opus_version": capped,
    }))


def _audio_spec():
    return st.tuples(st.just("AudioData"), st.fixed_dictionaries({"opus_encoded_frame": frame_bytes}))


def _info_spec():
    return st.tuples(st.just("ReceiverInformation"), st.fixed_dictionaries({
        "discovery_data": _discovery_spec(), "max_encoded_frame_size": u32,
        "max_decoded_frame_size": u32,
    }))


def _error_spec():
    return st.tuples(st.just("ReceiverError"), st.fixed_dictionaries({
        "audio_underflow": st.booleans(), "audio_decode_error": st.booleans(),
    }))


message_spec = st.one_of(
    _discovery_spec(),
    _audio_spec(),
    _info_spec(),
    _error_spec(),
    st.tuples(st.just("BroadcastMessage"), st.one_of(
        st.fixed_dictionaries({"magic_word": u32, "discovery_request": st.booleans()}),
        st.fixed_dictionaries({"magic_word": u32, "discovery_response": _discovery_spec()}),
        st.fixed_dictionaries({"magic_word": u32}),
    )),
    st.tuples(st.just("ToReceiver"), st.one_of(
        st.just({}), st.fixed_dictionaries({"audio_data": _audio_spec()}),
    )),
    st.tuples(st.just("ToTransmitter"), st.one_of(
        st.just({}),
        st.fixed_dictionaries({"receiver_information": _info_spec()}),
        st.fixed_dictionaries({"error": _error_spec()}),
    )),
)


def _build(pkg, spec):
    """The message of ``spec`` (class name, fields; nested specs for nested
    messages) built from package ``pkg``'s classes."""
    name, fields = spec
    kwargs = {
        k: _build(pkg, v) if isinstance(v, tuple) else v for k, v in fields.items()
    }
    return getattr(pkg, name)(**kwargs)


def _outcome(fn, *args):
    """("ok", value) or ("WireError", message): the same for both packages
    when they agree (each package raises its own WireError class)."""
    try:
        value = fn(*args)
    except (jwire.WireError, twire.WireError) as e:
        return ("WireError", str(e))
    if dataclasses.is_dataclass(value):
        value = (type(value).__name__, dataclasses.asdict(value))
    return ("ok", value)


@settings(max_examples=300, deadline=None, database=None, suppress_health_check=[HealthCheck.too_slow])
@given(spec=message_spec)
def test_encoding_byte_equal_to_reference(spec):
    got = _outcome(lambda: _build(tproto, spec).encode())
    want = _outcome(lambda: _build(jproto, spec).encode())
    assert got == want
    if got[0] != "ok":
        return
    data = got[1]
    name = spec[0]
    # each package decodes the other's bytes to equal fields
    decoded = _outcome(getattr(tproto, name).decode, data)
    assert decoded == _outcome(getattr(jproto, name).decode, data)
    if decoded[0] == "ok":  # (an AudioData past the 4,096-byte cap encodes but is refused)
        assert decoded[1] == (name, dataclasses.asdict(_build(jproto, spec)))
    assert tframing.encode_delimited(data) == jframing.encode_delimited(data)


@pytest.mark.parametrize("value", _U64_EDGES + [1 << 64, 1 << 70])
def test_varint_byte_equal_to_reference(value):
    enc = twire.encode_varint(value)
    assert enc == jwire.encode_varint(value)
    got = _outcome(twire.decode_varint, enc)
    assert got == _outcome(jwire.decode_varint, enc)
    # up to 10 bytes (64 bits and a little past) the value comes back
    assert got == (("ok", (value, len(enc))) if len(enc) <= 10 else ("WireError", "varint exceeds 10 bytes"))


_DECODERS = [
    "BroadcastMessage", "DiscoveryResponse", "ToReceiver", "ToTransmitter",
    "AudioData", "ReceiverError", "ReceiverInformation",
]


def _malformed_corpus():
    rng = random.Random(0x18)
    corpus = [bytes(rng.randrange(256) for _ in range(rng.randrange(0, 80))) for _ in range(300)]
    valid = [
        jproto.BroadcastMessage(constants.MAGIC_WORD, discovery_response=jproto.DiscoveryResponse(
            1, 0xA1B2C3D4E5F6, "living-room", True, "libopus 1.3.1")).encode(),
        jproto.ToTransmitter(receiver_information=jproto.ReceiverInformation(
            jproto.DiscoveryResponse(1, 7, "n" * 127, False, "v"), 4096, 11520)).encode(),
        jproto.ToReceiver(jproto.AudioData(b"q" * 300)).encode(),
    ]
    for v in valid:
        corpus += [v[:cut] for cut in range(len(v))]  # every truncation
        for _ in range(150):  # bit flips
            b = bytearray(v)
            for _ in range(rng.randrange(1, 4)):
                b[rng.randrange(len(b))] ^= 1 << rng.randrange(8)
            corpus.append(bytes(b))
    # hand-made: overlong and 65-bit varints, field 0, fixed-width fields,
    # bad UTF-8, an AudioData past the frame cap, a wrong wire type
    corpus += [
        b"\x80" * 11, b"\x08" + b"\x80" * 9 + b"\x02", b"\x00\x01", b"\x0d\x01\x02\x03\x04",
        b"\x09" + b"\x00" * 8, b"\x1a\x02\xff\xfe", b"\x0a\x82\x20" + b"z" * 4098,
        b"\x0a\x03\x0a\x01x", b"\x08\x01\x12\x01x", b"\x0b",
    ]
    return corpus


@pytest.mark.parametrize("name", _DECODERS)
def test_decode_outcomes_equal_to_reference_on_malformed_input(name):
    """Both packages accept the same inputs with equal fields and raise
    WireError with the same message on the rest."""
    for data in _malformed_corpus():
        got = _outcome(getattr(tproto, name).decode, data)
        assert got == _outcome(getattr(jproto, name).decode, data), data.hex()


def _gxx():
    import shutil

    return shutil.which("g++") is not None


def _feed_all(framer, pieces):
    """Frames of each feed until the first WireError; ("error", index)."""
    out = []
    for i, piece in enumerate(pieces):
        try:
            out.append(framer.feed(piece))
        except (jwire.WireError, twire.WireError):
            return out, ("error", i)
    return out, framer.pending_bytes


def _framers(max_frame):
    assert native.available(), native.build_error()
    return [
        native.NativeFramer(max_frame=max_frame),
        tframing.DelimitedDecoder(max_bytes=max_frame),
        jframing.DelimitedDecoder(max_bytes=max_frame),
    ]


stream_parts = st.lists(
    st.one_of(
        st.binary(max_size=300).map(tframing.encode_delimited),  # whole frames
        st.binary(min_size=1, max_size=12),  # garbage
        st.sampled_from([b"\x80" * 9 + b"\x02", b"\x80" * 10, b"\xff" * 9 + b"\x01", b"\x00"]),
    ),
    max_size=20,
)


@settings(max_examples=200, deadline=None, database=None)
@given(parts=stream_parts, cuts=st.lists(st.integers(0, 4000), max_size=12))
def test_framers_cut_the_same_frames(parts, cuts):
    if not _gxx():
        pytest.skip("no g++: the native framer is not built")
    stream = b"".join(parts)
    bounds = sorted({min(c, len(stream)) for c in cuts} | {0, len(stream)})
    pieces = [stream[a:b] for a, b in zip(bounds, bounds[1:])] or [b""]
    results = [_feed_all(f, pieces) for f in _framers(256)]
    assert results[0] == results[1] == results[2]


@pytest.mark.parametrize("split", [1, 3, 17, 1000])
def test_framers_agree_on_valid_streams(split):
    if not _gxx():
        pytest.skip("no g++: the native framer is not built")
    frames = [bytes([i]) * (i * 37 % 700) for i in range(60)]
    stream = b"".join(tframing.encode_delimited(f) for f in frames)
    pieces = [stream[i : i + split] for i in range(0, len(stream), split)]
    results = [_feed_all(f, pieces) for f in _framers(1 << 20)]
    assert results[0] == results[1] == results[2]
    assert sum(results[0][0], []) == frames


def test_native_framer_rejects_a_length_past_64_bits_like_the_python_framers():
    """A 10-byte length prefix whose value reaches 2^64 is a corrupt stream
    to the Python framers (its value exceeds every cap); the port's C++
    framer says so too (it used to truncate the value to 64 bits and cut a
    frame of the truncated length), and a prefix of ten continuation bytes
    waits for the 11th byte in all three."""
    if not _gxx():
        pytest.skip("no g++: the native framer is not built")
    for data, want in [
        (b"\x80" * 9 + b"\x02abc", ("error", 0)),
        (b"\x80" * 10, 10),
        (b"\x80" * 11, ("error", 0)),
        (b"\x80" * 9 + b"\x00", 0),  # a non-minimal zero: an empty frame
    ]:
        for framer in _framers(300):
            assert _feed_all(framer, [data])[1] == want


def test_golden_nanopb_vectors_decode_alike():
    for name in ("nanopb_hello.bin", "nanopb_audio.bin"):
        data = (GOLDEN / name).read_bytes()
        assert list(tframing.iter_delimited(data)) == list(jframing.iter_delimited(data))
        for payload in tframing.iter_delimited(data):
            kind = "ToTransmitter" if "hello" in name else "ToReceiver"
            got = _outcome(getattr(tproto, kind).decode, payload)
            assert got[0] == "ok"
            assert got == _outcome(getattr(jproto, kind).decode, payload)
    bc = (GOLDEN / "nanopb_broadcast_response.bin").read_bytes()
    got = _outcome(tproto.BroadcastMessage.decode, bc)
    assert got[0] == "ok" and got == _outcome(jproto.BroadcastMessage.decode, bc)
    # and the port's re-encoding of what it decoded gives nanopb's bytes back
    assert tproto.BroadcastMessage.decode(bc).encode() == bc
