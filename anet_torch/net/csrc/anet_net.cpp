// anet native host-edge networking core.
//
// Host-edge equivalent of the reference firmware's native network layer
// (hardware/src/network.cpp): where the ESP32 runs nanopb streaming decode
// over lwIP sockets, the anet host edge runs this small C++ core under
// Python orchestration. Exposed as a plain C ABI for ctypes; Python falls
// back to pure-Python implementations when the library is absent.
//
// Components (reference parity noted per function):
//  - incremental varint-delimited framer  (pb_decode_delimited streaming,
//    network.cpp:262-305,411)
//  - delimited encoder                    (pb_encode_delimited, network.cpp:394)
//  - BroadcastMessage discovery-request validation (network.cpp:474-484)
//  - blocking UDP discovery responder loop (network_task_discovery,
//    network.cpp:449-494)
//  - broadcast address math               (network_get_broadcast_address,
//    network.cpp:58-64)
//
// Build: anet_torch/net/native.py compiles it on first use
// (g++ -O2 -fPIC -shared -std=c++17 -pthread) into build/anet_torch_net/.

#include <arpa/inet.h>
#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <ifaddrs.h>
#include <net/if.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <unistd.h>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// varints
// ---------------------------------------------------------------------------

// Encode v as a base-128 varint into out (cap >= 10). Returns bytes written.
int anet_varint_encode(uint64_t v, uint8_t* out) {
  int n = 0;
  do {
    uint8_t byte = v & 0x7F;
    v >>= 7;
    out[n++] = v ? (byte | 0x80) : byte;
  } while (v);
  return n;
}

// Decode a varint from buf[0..len). Returns bytes consumed, 0 if more input
// is needed, -1 on malformed: an 11th byte, or a 10th byte that carries the
// value past 64 bits. *value receives the result. These are the rules of
// the Python decoders (anet_torch.proto): one waits for the 11th byte
// before it calls a prefix too long, and a value of 2^64 or more exceeds
// every frame cap, so the framers agree byte for byte on any stream.
int anet_varint_decode(const uint8_t* buf, int len, uint64_t* value) {
  uint64_t result = 0;
  int shift = 0;
  for (int i = 0; i < len; ++i) {
    if (i >= 10) return -1;
    if (i == 9 && buf[i] > 1 && !(buf[i] & 0x80)) return -1;
    result |= (uint64_t)(buf[i] & 0x7F) << shift;
    if (!(buf[i] & 0x80)) {
      *value = result;
      return i + 1;
    }
    shift += 7;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// incremental delimited framer
// ---------------------------------------------------------------------------

struct AnetFramer {
  std::vector<uint8_t> buf;
  size_t pos = 0;  // read offset: frames are consumed by advancing this,
                   // compacting lazily — per-frame front-erasure would be
                   // quadratic in the buffered byte count
  size_t max_frame;
  bool corrupt = false;
};

void* anet_framer_new(uint64_t max_frame) {
  AnetFramer* f = new AnetFramer();
  f->max_frame = (size_t)max_frame;
  return f;
}

void anet_framer_free(void* h) { delete (AnetFramer*)h; }

// Append raw stream bytes. Returns 0, or -1 if the framer is poisoned.
int anet_framer_feed(void* h, const uint8_t* data, int len) {
  AnetFramer* f = (AnetFramer*)h;
  if (f->corrupt) return -1;
  f->buf.insert(f->buf.end(), data, data + len);
  return 0;
}

// Extract the next complete frame into out (capacity out_cap).
// Returns frame length >= 0, -1 if no complete frame buffered yet,
// -2 on corrupt stream (oversized frame / bad varint), -3 if out_cap too
// small (frame stays buffered).
int anet_framer_next(void* h, uint8_t* out, int out_cap) {
  AnetFramer* f = (AnetFramer*)h;
  if (f->corrupt) return -2;
  const uint8_t* base = f->buf.data() + f->pos;
  size_t avail = f->buf.size() - f->pos;
  uint64_t flen;
  int consumed = anet_varint_decode(base, (int)avail, &flen);
  if (consumed == 0) return -1;
  if (consumed < 0 || flen > f->max_frame) {
    f->corrupt = true;
    return -2;
  }
  if (avail < (size_t)consumed + flen) return -1;
  if ((int)flen > out_cap) return -3;
  memcpy(out, base + consumed, flen);
  f->pos += (size_t)consumed + flen;
  // Compact once the consumed prefix dominates the buffer.
  if (f->pos > 4096 && f->pos * 2 > f->buf.size()) {
    f->buf.erase(f->buf.begin(), f->buf.begin() + f->pos);
    f->pos = 0;
  }
  return (int)flen;
}

// Batch extraction: pull every complete frame in one call (amortizes the
// FFI boundary). Frames are written back-to-back into out; lens[i] receives
// each frame's length. Returns the frame count, -2 on corrupt stream.
// Stops early when out_cap or max_frames is reached (remaining frames stay
// buffered for the next call).
int anet_framer_drain(void* h, uint8_t* out, int out_cap, int32_t* lens,
                      int max_frames) {
  AnetFramer* f = (AnetFramer*)h;
  if (f->corrupt) return -2;
  int count = 0;
  int used = 0;
  while (count < max_frames) {
    const uint8_t* base = f->buf.data() + f->pos;
    size_t avail = f->buf.size() - f->pos;
    uint64_t flen;
    int consumed = anet_varint_decode(base, (int)avail, &flen);
    if (consumed == 0) break;
    if (consumed < 0 || flen > f->max_frame) {
      f->corrupt = true;
      return count ? count : -2;  // surface already-extracted frames first
    }
    if (avail < (size_t)consumed + flen) break;
    if (used + (int)flen > out_cap) break;
    memcpy(out + used, base + consumed, flen);
    lens[count++] = (int32_t)flen;
    used += (int)flen;
    f->pos += (size_t)consumed + flen;
  }
  if (f->pos > 4096 && f->pos * 2 > f->buf.size()) {
    f->buf.erase(f->buf.begin(), f->buf.begin() + f->pos);
    f->pos = 0;
  }
  return count;
}

// Bytes buffered but not yet forming a complete frame.
int anet_framer_pending(void* h) {
  AnetFramer* f = (AnetFramer*)h;
  return (int)(f->buf.size() - f->pos);
}

// Encode payload as a delimited frame. Returns total length or -1 if cap
// is too small.
int anet_encode_delimited(const uint8_t* payload, int len, uint8_t* out,
                          int out_cap) {
  uint8_t prefix[10];
  int pn = anet_varint_encode((uint64_t)len, prefix);
  if (pn + len > out_cap) return -1;
  memcpy(out, prefix, pn);
  memcpy(out + pn, payload, len);
  return pn + len;
}

// ---------------------------------------------------------------------------
// discovery datagram validation (protobuf wire subset)
// ---------------------------------------------------------------------------

// The checks below follow the port's Python codec rule for rule
// (anet_torch.proto.wire.iter_fields and the decode of BroadcastMessage and
// DiscoveryResponse), so the native check and the Python one accept the
// same datagrams: a varint of at most 10 bytes whose value may pass 64 bits,
// field number 0 refused, wire types 0, 1, 2 and 5 only, every length
// bounded by the bytes left, required fields present, strings valid UTF-8.

// Read a varint of at most 10 bytes from buf[0..len). Returns bytes
// consumed, 0 when it is truncated or longer. *wide is set when the value
// needs more than 64 bits (*value then holds its low 64).
static int read_varint(const uint8_t* buf, int len, uint64_t* value,
                       bool* wide) {
  uint64_t result = 0;
  *wide = false;
  for (int i = 0; i < len && i < 10; ++i) {
    result |= (uint64_t)(buf[i] & 0x7F) << (7 * i);
    if (i == 9 && (buf[i] & 0x7E)) *wide = true;
    if (!(buf[i] & 0x80)) {
      *value = result;
      return i + 1;
    }
  }
  return 0;
}

struct FieldReader {
  const uint8_t* buf;
  int len;
  int pos;
};

struct Field {
  uint64_t number;  // UINT64_MAX when the key passes 64 bits
  uint32_t wtype;
  uint64_t value;   // varint fields
  bool wide;        // varint value past 64 bits
  const uint8_t* payload;  // length-delimited fields
  int payload_len;
};

// Next field of the message: 1 with *f filled, 0 at its end, -1 where the
// Python codec raises WireError. Fixed-width fields are skipped.
static int next_field(FieldReader* r, Field* f) {
  while (r->pos < r->len) {
    uint64_t key;
    bool wide;
    int c = read_varint(r->buf + r->pos, r->len - r->pos, &key, &wide);
    if (c == 0) return -1;
    r->pos += c;
    f->number = wide ? UINT64_MAX : key >> 3;
    f->wtype = (uint32_t)(key & 7);
    if (f->number == 0) return -1;
    int left = r->len - r->pos;
    if (f->wtype == 0) {
      c = read_varint(r->buf + r->pos, left, &f->value, &f->wide);
      if (c == 0) return -1;
      r->pos += c;
      return 1;
    }
    if (f->wtype == 2) {
      uint64_t l;
      c = read_varint(r->buf + r->pos, left, &l, &wide);
      // Bound the 64-bit length by the bytes left before narrowing it.
      if (c == 0 || wide || l > (uint64_t)(left - c)) return -1;
      f->payload = r->buf + r->pos + c;
      f->payload_len = (int)l;
      r->pos += c + (int)l;
      return 1;
    }
    if (f->wtype == 1 && left >= 8) {
      r->pos += 8;
    } else if (f->wtype == 5 && left >= 4) {
      r->pos += 4;
    } else {
      return -1;  // truncated fixed-width field or unsupported wire type
    }
  }
  return 0;
}

// Strict UTF-8, as Python's decoder takes it: no overlong forms, no
// surrogates, nothing past U+10FFFF.
static bool valid_utf8(const uint8_t* s, int n) {
  int i = 0;
  while (i < n) {
    uint8_t b = s[i];
    int need;
    uint32_t cp, least;
    if (b < 0x80) {
      ++i;
      continue;
    } else if ((b & 0xE0) == 0xC0) {
      need = 1; cp = b & 0x1F; least = 0x80;
    } else if ((b & 0xF0) == 0xE0) {
      need = 2; cp = b & 0x0F; least = 0x800;
    } else if ((b & 0xF8) == 0xF0) {
      need = 3; cp = b & 0x07; least = 0x10000;
    } else {
      return false;
    }
    if (n - i - 1 < need) return false;
    for (int k = 1; k <= need; ++k) {
      if ((s[i + k] & 0xC0) != 0x80) return false;
      cp = (cp << 6) | (s[i + k] & 0x3F);
    }
    if (cp < least || cp > 0x10FFFF || (cp >= 0xD800 && cp <= 0xDFFF)) {
      return false;
    }
    i += need + 1;
  }
  return true;
}

// 1 if buf[0..len) decodes as a DiscoveryResponse: fields 1, 2 and 4 as
// varints, 3 and 5 as UTF-8 strings, all five present.
static int valid_discovery_response(const uint8_t* buf, int len) {
  FieldReader r{buf, len, 0};
  Field f;
  unsigned seen = 0;
  int rc;
  while ((rc = next_field(&r, &f)) == 1) {
    if (f.number < 1 || f.number > 5) continue;
    bool is_string = f.number == 3 || f.number == 5;
    if (f.wtype != (is_string ? 2u : 0u)) continue;
    if (is_string && !valid_utf8(f.payload, f.payload_len)) return 0;
    seen |= 1u << f.number;
  }
  return rc == 0 && seen == 0x3E;
}

// Returns 1 if buf is a BroadcastMessage{magic_word==magic,
// discovery_request=true}; 0 otherwise. Mirrors the firmware's check
// (network.cpp:474-484): magic word + which_message == discovery_request,
// the oneof's last member winning.
int anet_validate_discovery_request(const uint8_t* buf, int len,
                                    uint32_t magic) {
  FieldReader r{buf, len, 0};
  Field f;
  bool magic_seen = false;
  bool magic_ok = false;
  bool request = false;
  int rc;
  while ((rc = next_field(&r, &f)) == 1) {
    if (f.number == 1 && f.wtype == 0) {
      magic_seen = true;
      magic_ok = !f.wide && f.value == magic;
    } else if (f.number == 2 && f.wtype == 0) {
      request = f.wide || f.value != 0;
    } else if (f.number == 3 && f.wtype == 2) {
      if (!valid_discovery_response(f.payload, f.payload_len)) return 0;
      request = false;
    }
  }
  return (rc == 0 && magic_seen && magic_ok && request) ? 1 : 0;
}

// ---------------------------------------------------------------------------
// discovery responder loop
// ---------------------------------------------------------------------------

// Blocking loop: bind UDP :port, answer every valid discovery request with
// the current contents of `response` (a prebuilt BroadcastMessage built by
// the Python side). `response` is a stable caller-owned buffer and
// `*response_len` its current length — the caller may rewrite both between
// datagrams (write bytes first, then the length) to update the advertised
// identity without restarting the loop. Polls *stop every poll_ms.
// Returns 0 on clean stop, negative errno-style codes on socket errors.
int anet_discovery_responder_run(uint16_t port, uint32_t magic,
                                 const uint8_t* response,
                                 const volatile int32_t* response_len,
                                 volatile int32_t* stop, int poll_ms) {
  int sock = socket(AF_INET, SOCK_DGRAM, 0);
  if (sock < 0) return -errno;
  int one = 1;
  setsockopt(sock, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  struct timeval tv;
  tv.tv_sec = poll_ms / 1000;
  tv.tv_usec = (poll_ms % 1000) * 1000;
  setsockopt(sock, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));

  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = INADDR_ANY;
  addr.sin_port = htons(port);
  if (bind(sock, (sockaddr*)&addr, sizeof(addr)) < 0) {
    int err = -errno;
    close(sock);
    return err;
  }

  uint8_t buf[2048];
  while (!*stop) {
    sockaddr_in peer{};
    socklen_t plen = sizeof(peer);
    ssize_t n = recvfrom(sock, buf, sizeof(buf), 0, (sockaddr*)&peer, &plen);
    if (n < 0) {
      if (errno == EAGAIN || errno == EWOULDBLOCK || errno == EINTR) continue;
      close(sock);
      return -errno;
    }
    if (anet_validate_discovery_request(buf, (int)n, magic)) {
      sendto(sock, response, *response_len, 0, (sockaddr*)&peer, plen);
    }
  }
  close(sock);
  return 0;
}

// ---------------------------------------------------------------------------
// broadcast address math (network.cpp:58-64 / test/network.cpp parity)
// ---------------------------------------------------------------------------

uint32_t anet_broadcast_address(uint32_t ip_host_order,
                                uint32_t netmask_host_order) {
  return (ip_host_order & netmask_host_order) | ~netmask_host_order;
}

// ---------------------------------------------------------------------------
// interface enumeration (discovery.kt:33-40 parity)
// ---------------------------------------------------------------------------

// List every usable IPv4 interface for directed-broadcast discovery: up,
// broadcast-capable, non-loopback, with an address and a netmask. Writes
// up to `cap` (address, netmask) pairs in host byte order. Returns the
// number written, or -errno when getifaddrs itself fails. The reference
// transmitter walks NetworkInterface.getNetworkInterfaces() the same way
// (discovery.kt:33-40: skip loopback/down, take each InterfaceAddress's
// broadcast); anet computes the broadcast from (addr, mask) so the caller
// can also log the subnet it is probing.
int anet_list_interfaces(uint32_t* addrs, uint32_t* masks, int cap) {
  struct ifaddrs* head = nullptr;
  if (getifaddrs(&head) != 0) return -errno;
  int n = 0;
  for (struct ifaddrs* ifa = head; ifa && n < cap; ifa = ifa->ifa_next) {
    if (!ifa->ifa_addr || !ifa->ifa_netmask) continue;
    if (ifa->ifa_addr->sa_family != AF_INET) continue;
    if (!(ifa->ifa_flags & IFF_UP)) continue;
    if (ifa->ifa_flags & IFF_LOOPBACK) continue;
    if (!(ifa->ifa_flags & IFF_BROADCAST)) continue;
    addrs[n] = ntohl(((sockaddr_in*)ifa->ifa_addr)->sin_addr.s_addr);
    masks[n] = ntohl(((sockaddr_in*)ifa->ifa_netmask)->sin_addr.s_addr);
    ++n;
  }
  freeifaddrs(head);
  return n;
}

}  // extern "C"
