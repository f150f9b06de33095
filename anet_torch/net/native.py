"""ctypes loader for the native networking core (libanet_net.so).

Every facility has a pure-Python fallback (anet_torch.proto.framing etc.),
so the framework works without the compiled library; the native path exists
because the reference's equivalent layer is native (SURVEY.md §2.3) and
because high-rate host ingest shouldn't burn Python cycles per byte.

Build: on first use, ``csrc/anet_net.cpp`` compiles with
``g++ -O2 -fPIC -shared -std=c++17 -pthread`` into
``build/anet_torch_net/libanet_net-<hash>.so`` at the root of the checkout,
where ``<hash>`` covers the source and the flags, so an edited source
rebuilds and an unchanged one loads at once (``anet_torch/_native_build.py``,
which the CUDA kernels' build shares). Without ``g++`` the library is
unavailable and the fallbacks serve; a failed build keeps the compiler's
output in ``build_error()``.
"""

from __future__ import annotations

import ctypes
import shutil
from pathlib import Path
from typing import List, Optional

from anet_torch._native_build import Compile, hashed_path

SOURCE = Path(__file__).resolve().parent / "csrc" / "anet_net.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "anet_torch_net"
CXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17", "-pthread")

_lib: Optional[ctypes.CDLL] = None
_load_failed = False
_build_error: Optional[str] = None


def library_path() -> Path:
    return hashed_path(BUILD_DIR, "libanet_net", (SOURCE,), CXX_FLAGS)


def build() -> Optional[Path]:
    """The built library, compiled now if it is not there yet; None when
    there is no ``g++`` or the build failed (see ``build_error()``)."""
    global _build_error
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        _build_error = "g++ not found"
        return None
    error = Compile(cxx, CXX_FLAGS, SOURCE, out).finish(timeout=300)
    if error is not None:
        _build_error = f"g++ {error}"
        return None
    return out


def build_error() -> Optional[str]:
    """Why the library was not built or did not load (None if it did)."""
    return _build_error


def load() -> Optional[ctypes.CDLL]:
    """Load (and memoize) the native library, building it on first use;
    None if unavailable."""
    global _lib, _load_failed, _build_error
    if _lib is not None or _load_failed:
        return _lib
    path = build()
    if path is None:
        _load_failed = True
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        _build_error = f"{path}: {e}"
        _load_failed = True
        return None
    lib.anet_framer_new.restype = ctypes.c_void_p
    lib.anet_framer_new.argtypes = [ctypes.c_uint64]
    lib.anet_framer_free.argtypes = [ctypes.c_void_p]
    lib.anet_framer_feed.restype = ctypes.c_int
    lib.anet_framer_feed.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.anet_framer_next.restype = ctypes.c_int
    lib.anet_framer_next.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.anet_framer_pending.restype = ctypes.c_int
    lib.anet_framer_pending.argtypes = [ctypes.c_void_p]
    lib.anet_framer_drain.restype = ctypes.c_int
    lib.anet_framer_drain.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int,
    ]
    lib.anet_encode_delimited.restype = ctypes.c_int
    lib.anet_encode_delimited.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.anet_validate_discovery_request.restype = ctypes.c_int
    lib.anet_validate_discovery_request.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_uint32,
    ]
    lib.anet_discovery_responder_run.restype = ctypes.c_int
    lib.anet_discovery_responder_run.argtypes = [
        ctypes.c_uint16, ctypes.c_uint32, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
    ]
    lib.anet_broadcast_address.restype = ctypes.c_uint32
    lib.anet_broadcast_address.argtypes = [ctypes.c_uint32, ctypes.c_uint32]
    lib.anet_list_interfaces.restype = ctypes.c_int
    lib.anet_list_interfaces.argtypes = [
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_int,
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


class NativeFramer:
    """Incremental delimited-frame decoder backed by the C++ core.

    Same contract as anet_torch.proto.framing.DelimitedDecoder.feed().
    """

    MAX_FRAMES_PER_DRAIN = 4096

    def __init__(self, max_frame: int = 1 << 20) -> None:
        lib = load()
        if lib is None:
            raise RuntimeError(f"libanet_net.so not available: {_build_error or 'load failed'}")
        self._lib = lib
        self._h = lib.anet_framer_new(max_frame)
        self._out = ctypes.create_string_buffer(max(max_frame, 1 << 20))
        self._lens = (ctypes.c_int32 * self.MAX_FRAMES_PER_DRAIN)()
        self._max = max_frame

    def feed(self, data: bytes) -> List[bytes]:
        from anet_torch.proto.wire import WireError

        if self._lib.anet_framer_feed(self._h, data, len(data)) != 0:
            raise WireError("framer poisoned by earlier corrupt stream")
        frames: List[bytes] = []
        while True:
            # One FFI call extracts a whole batch of frames, packed
            # back-to-back — per-frame calls would dominate the cost.
            n = self._lib.anet_framer_drain(
                self._h,
                self._out,
                len(self._out),
                self._lens,
                self.MAX_FRAMES_PER_DRAIN,
            )
            if n == -2:
                raise WireError("corrupt delimited stream (bad varint or oversized frame)")
            if n <= 0:
                return frames
            view = memoryview(self._out)
            offset = 0
            for i in range(n):
                length = self._lens[i]
                frames.append(bytes(view[offset : offset + length]))
                offset += length
            # Loop until a drain returns 0: a partial batch can also mean
            # the output buffer filled (large frames), with more complete
            # frames still buffered — returning early would strand them.

    @property
    def pending_bytes(self) -> int:
        return self._lib.anet_framer_pending(self._h)

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.anet_framer_free(self._h)
            self._h = None

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass


def broadcast_address(ip: str, netmask: str) -> str:
    """Directed broadcast address for an interface (native or Python)."""
    import socket
    import struct

    ip_i = struct.unpack("!I", socket.inet_aton(ip))[0]
    mask_i = struct.unpack("!I", socket.inet_aton(netmask))[0]
    lib = load()
    if lib is not None:
        out = lib.anet_broadcast_address(ip_i, mask_i)
    else:
        out = (ip_i & mask_i) | (~mask_i & 0xFFFFFFFF)
    return socket.inet_ntoa(struct.pack("!I", out & 0xFFFFFFFF))


def list_interfaces() -> List[tuple]:
    """(address, netmask) of every usable IPv4 interface: up, non-loopback,
    broadcast-capable — the set the reference transmitter probes
    (discovery.kt:33-40). Native getifaddrs when the library is present;
    SIOCGIFCONF/SIOCGIFNETMASK ioctls otherwise (Linux); [] if neither
    works (the caller falls back to 255.255.255.255 + a /24 guess)."""
    import socket
    import struct

    lib = load()
    if lib is not None:
        cap = 64
        addrs = (ctypes.c_uint32 * cap)()
        masks = (ctypes.c_uint32 * cap)()
        n = lib.anet_list_interfaces(addrs, masks, cap)
        if n >= 0:
            return [
                (
                    socket.inet_ntoa(struct.pack("!I", addrs[i])),
                    socket.inet_ntoa(struct.pack("!I", masks[i])),
                )
                for i in range(n)
            ]
    # ioctl fallback (Linux): walk named interfaces, query address+netmask.
    try:
        import fcntl
    except ImportError:
        return []
    SIOCGIFADDR, SIOCGIFNETMASK, SIOCGIFFLAGS = 0x8915, 0x891B, 0x8913
    IFF_UP, IFF_LOOPBACK, IFF_BROADCAST = 0x1, 0x8, 0x2
    out = []
    try:
        names = [name for _, name in socket.if_nameindex()]
    except OSError:
        return []
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        for name in names:
            ifreq = struct.pack("256s", name.encode()[:15])
            try:
                flags = struct.unpack_from("H", fcntl.ioctl(s, SIOCGIFFLAGS, ifreq), 16)[0]
                if not (flags & IFF_UP) or (flags & IFF_LOOPBACK) or not (flags & IFF_BROADCAST):
                    continue
                addr = socket.inet_ntoa(fcntl.ioctl(s, SIOCGIFADDR, ifreq)[20:24])
                mask = socket.inet_ntoa(fcntl.ioctl(s, SIOCGIFNETMASK, ifreq)[20:24])
            except OSError:
                continue  # interface without an IPv4 address
            out.append((addr, mask))
    return out


def validate_discovery_request(datagram: bytes, magic: int) -> bool:
    """True iff datagram is a well-formed discovery request with our magic."""
    lib = load()
    if lib is not None:
        return bool(
            lib.anet_validate_discovery_request(datagram, len(datagram), magic)
        )
    # Pure-Python fallback via the full codec.
    from anet_torch.proto import BroadcastMessage
    from anet_torch.proto.wire import WireError

    try:
        msg = BroadcastMessage.decode(datagram)
    except WireError:
        return False
    return msg.magic_word == magic and msg.discovery_request is True
