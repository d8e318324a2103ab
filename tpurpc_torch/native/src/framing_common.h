// Shared wire-framing helpers for the native client and server
// (tpurpc_client.cc / tpurpc_server.cc). The authoritative format doc is
// tpurpc_torch/rpc/frame.py: 8-byte preface "TPURPC\x01\x00", little-endian
// frames [u8 type][u8 flags][u32 stream_id][u32 length][payload], metadata
// as u16 count + (u16 klen, key, u32 vlen, value) entries.
#ifndef TPURPC_FRAMING_COMMON_H
#define TPURPC_FRAMING_COMMON_H

#include <errno.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <sys/socket.h>

#include <mutex>
#include <string>
#include <utility>
#include <vector>

namespace tpr_wire {

constexpr uint8_t kHeaders = 1, kMessage = 2, kTrailers = 3, kRst = 4,
                  kPing = 5, kPong = 6, kGoaway = 7,
                  // rendezvous control ladder (frame.py RDV_*): frame type
                  // = canonical op + 7 (OP_OFFER=1 .. OP_RELEASE=4)
                  kRdvOffer = 8, kRdvClaim = 9, kRdvComplete = 10,
                  kRdvRelease = 11,
                  // one framed wakeup for a parked ctrl-ring consumer; the
                  // fd readiness IS the wake — the frame body is ignored
                  kCtrlKick = 12;
constexpr uint8_t kFlagEndStream = 0x01, kFlagMore = 0x02,
                  kFlagNoMessage = 0x04,
                  // gzip-compressed message (Python peers only): the native
                  // loop does not link a decompressor, so receivers REJECT
                  // the flag loudly instead of delivering garbled bytes
                  kFlagCompressed = 0x08,
                  // on kRst only: the stream was REFUSED at admission — no
                  // handler ran, the caller may replay on a fresh connection
                  // (h2 REFUSED_STREAM semantics; the machine-readable form
                  // of the old "connection draining" detail wording —
                  // frame.py FLAG_REFUSED is the Python mirror)
                  kFlagRefused = 0x10;
constexpr size_t kMaxFramePayload = 1u << 20;
// Unary requests at or below this ship HEADERS+MESSAGE as ONE buffered
// write (one syscall / ring message); larger ones take the fragmenting
// send path (a single MESSAGE frame above kMaxFramePayload is a framing
// violation that kills the connection). Shared by the blocking and CQ
// unary fast paths so the cutoff can't drift between them.
constexpr size_t kSmallUnaryMax = 64u << 10;
inline const char kMagic[] = "TPURPC\x01\x00";  // 8 bytes incl trailing NUL

inline void put_u16(std::string &out, uint16_t v) {
  out.push_back(static_cast<char>(v & 0xff));
  out.push_back(static_cast<char>(v >> 8));
}
inline void put_u32(std::string &out, uint32_t v) {
  for (int i = 0; i < 4; i++)
    out.push_back(static_cast<char>((v >> (8 * i)) & 0xff));
}
inline uint16_t get_u16(const uint8_t *p) {
  return static_cast<uint16_t>(p[0] | (p[1] << 8));
}
inline uint32_t get_u32(const uint8_t *p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (uint32_t(p[3]) << 24);
}

inline std::string encode_metadata(
    const std::vector<std::pair<std::string, std::string>> &md) {
  std::string out;
  put_u16(out, static_cast<uint16_t>(md.size()));
  for (const auto &kv : md) {
    put_u16(out, static_cast<uint16_t>(kv.first.size()));
    out += kv.first;
    put_u32(out, static_cast<uint32_t>(kv.second.size()));
    out += kv.second;
  }
  return out;
}

inline bool decode_metadata(
    const uint8_t *buf, size_t len,
    std::vector<std::pair<std::string, std::string>> *out) {
  if (len < 2) return false;
  size_t off = 2;
  uint16_t count = get_u16(buf);
  for (uint16_t i = 0; i < count; i++) {
    if (off + 2 > len) return false;
    uint16_t klen = get_u16(buf + off);
    off += 2;
    if (off + klen + 4 > len) return false;
    std::string key(reinterpret_cast<const char *>(buf + off), klen);
    off += klen;
    uint32_t vlen = get_u32(buf + off);
    off += 4;
    if (off + vlen > len) return false;
    out->emplace_back(
        std::move(key),
        std::string(reinterpret_cast<const char *>(buf + off), vlen));
    off += vlen;
  }
  return true;
}

inline bool fd_write_all(int fd, const void *buf, size_t len) {
  const char *p = static_cast<const char *>(buf);
  while (len > 0) {
    ssize_t n = ::send(fd, p, len, MSG_NOSIGNAL);
    if (n <= 0) {
      if (n < 0 && errno == EINTR) continue;
      return false;
    }
    p += n;
    len -= static_cast<size_t>(n);
  }
  return true;
}

inline bool fd_read_exact(int fd, void *buf, size_t len) {
  char *p = static_cast<char *>(buf);
  while (len > 0) {
    ssize_t n = ::recv(fd, p, len, 0);
    if (n <= 0) {
      if (n < 0 && errno == EINTR) continue;
      return false;
    }
    p += n;
    len -= static_cast<size_t>(n);
  }
  return true;
}

// Transport-generic frame IO: T needs write_all(ptr,len)/read_exact(ptr,len)
// with the usual all-or-nothing contract. This is the seam that lets one
// framing loop ride either a TCP fd or the shm ring transport
// (ring_transport.h) — the grpc_endpoint-vtable idea (endpoint.cc:33-54) at
// native-app scale. (The former fd_-prefixed frame helpers were these exact
// bodies specialized to an fd; callers now go through the templates.)
inline void build_frame_header(std::string &hdr, uint8_t type, uint8_t flags,
                               uint32_t sid, size_t len) {
  hdr.push_back(static_cast<char>(type));
  hdr.push_back(static_cast<char>(flags));
  put_u32(hdr, sid);
  put_u32(hdr, static_cast<uint32_t>(len));
}

template <typename T>
inline bool t_send_frame_locked(T &t, uint8_t type, uint8_t flags,
                                uint32_t sid, const void *payload,
                                size_t len) {
  std::string hdr;
  build_frame_header(hdr, type, flags, sid, len);
  return t.write_all(hdr.data(), hdr.size()) &&
         (len == 0 || t.write_all(payload, len));
}

// Ring-transport specialization: header+payload as one gathered ring
// message, one notify (R = tpr_ring::RingTransport or anything with
// write_gather).
template <typename R>
inline bool ring_send_frame_locked(R &ring, uint8_t type, uint8_t flags,
                                   uint32_t sid, const void *payload,
                                   size_t len) {
  std::string hdr;
  build_frame_header(hdr, type, flags, sid, len);
  return ring.write_gather(hdr.data(), hdr.size(), payload, len);
}

// Parse a 10-byte frame header and read the payload — shared by the
// blocking and deadline-bounded frame readers so the header layout and
// the sanity bound live in exactly one place.
template <typename T>
inline bool t_finish_frame(T &t, const uint8_t hdr[10], uint8_t *type,
                           uint8_t *flags, uint32_t *sid,
                           std::vector<uint8_t> *payload) {
  *type = hdr[0];
  *flags = hdr[1];
  *sid = get_u32(hdr + 2);
  uint32_t len = get_u32(hdr + 6);
  if (len > kMaxFramePayload + 65536) return false;
  payload->resize(len);
  return len == 0 || t.read_exact(payload->data(), len);
}

template <typename T>
inline bool t_read_frame(T &t, uint8_t *type, uint8_t *flags, uint32_t *sid,
                         std::vector<uint8_t> *payload) {
  uint8_t hdr[10];
  if (!t.read_exact(hdr, sizeof hdr)) return false;
  return t_finish_frame(t, hdr, type, flags, sid, payload);
}

// GRPC_PLATFORM_TYPE dispatch for native apps (iomgr_internal.cc:36-61
// analog): any of the ring platforms means "bootstrap the shm ring over
// the connected socket"; TCP (or unset) keeps plain fd framing.
inline bool platform_wants_ring() {
  const char *p = getenv("TPURPC_PLATFORM_TYPE");
  if (!p) p = getenv("GRPC_PLATFORM_TYPE");
  if (!p) return false;
  return strcmp(p, "RDMA_BP") == 0 || strcmp(p, "RDMA_BPEV") == 0 ||
         strcmp(p, "RDMA_EVENT") == 0;
}

inline uint64_t ring_size_from_env() {
  const char *p = getenv("TPURPC_RING_BUFFER_SIZE_KB");
  if (!p) p = getenv("GRPC_RDMA_RING_BUFFER_SIZE_KB");
  uint64_t kb = p ? strtoull(p, nullptr, 10) : 4096;
  if (kb == 0) kb = 4096;
  uint64_t bytes = kb * 1024;
  // power-of-two, >= 4096 (config.py ring_buffer_size rule)
  uint64_t size = 4096;
  while (size < bytes) size <<= 1;
  return size;
}

}  // namespace tpr_wire

#endif  // TPURPC_FRAMING_COMMON_H
