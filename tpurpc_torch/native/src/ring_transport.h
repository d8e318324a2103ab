// Ring transport for native (C/C++) tpurpc apps: the same one-sided-write
// shm data plane Python endpoints ride (tpurpc_torch/core/pair.py), implemented
// against the C ring ops in ring.cc — so GRPC_PLATFORM_TYPE=RDMA_BP|BPEV|
// EVENT works for a pure-native process with no Python anywhere.
//
// Protocol parity (the authoritative impl is tpurpc_torch/core/pair.py):
// - bootstrap: "TRB1" magic + u32 length + JSON Address blob each way over
//   the connected TCP fd (pair.py _send_blob/_recv_blob; the reference's
//   exchange_data, rdma_bp_posix.cc:640-692). Address keys: tag, domain,
//   ring_size, ring, status, caps. domain must be "shm" on both sides.
// - data: seq-stamped header/footer framed ring messages (ring.cc ops),
//   credits published as a one-sided u64 store of the consumer head into
//   the peer's status page (+0) after >= capacity/4 consumed
//   (RingReader.PUBLISH_DIVISOR), peer_exit at +8.
// - events: the bootstrap socket stays alive as the notify channel carrying
//   single-byte tokens 'd' (data), 'c' (credit), 'x' (exit). This side
//   advertises NO "waitflag" capability, so the Python peer always sends
//   notify bytes (the asymmetric-peer contract, pair.py Address.caps), and
//   this side always sends them too — correctness first; the native app
//   path is event-driven (the EVENT discipline), not spinning.
//
// Thread model matches the fd transport: one reader thread calls
// read_exact(); any thread calls write_all() under the caller's write lock.
#ifndef TPURPC_RING_TRANSPORT_H
#define TPURPC_RING_TRANSPORT_H

#include <fcntl.h>
#include <poll.h>
#include <sys/mman.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <random>
#include <string>
#include <thread>

#include "framing_common.h"

// C ring ops (ring.cc)
extern "C" {
uint64_t tpr_ring_read_into(uint8_t *ring, uint64_t cap, uint64_t *head,
                            uint64_t *msg_len, uint64_t *msg_read,
                            uint8_t *dst, uint64_t dst_len,
                            uint64_t *consumed, uint64_t *seq);
uint64_t tpr_ring_writev(uint8_t *ring, uint64_t cap, uint64_t *tail,
                         uint64_t remote_head, const uint8_t *const *segs,
                         const uint64_t *lens, uint32_t nsegs, uint64_t *seq);
uint64_t tpr_ring_max_payload(uint64_t cap);
uint64_t tpr_ring_reserve(uint8_t *ring, uint64_t cap, uint64_t tail,
                          uint64_t remote_head, uint64_t payload_len,
                          uint8_t **p1, uint64_t *l1,
                          uint8_t **p2, uint64_t *l2);
void tpr_ring_commit(uint8_t *ring, uint64_t cap, uint64_t *tail,
                     uint64_t payload_len, uint64_t *seq);
int tpr_ring_has_message(const uint8_t *ring, uint64_t cap, uint64_t head,
                         uint64_t msg_len, uint64_t seq);
void tpr_store_u64_seqcst(uint8_t *addr, uint64_t val);
uint64_t tpr_load_u64_fenced(const uint8_t *addr);
}

namespace tpr_ring {

constexpr size_t kStatusBytes = 128;
constexpr size_t kStatusHeadOff = 0;
constexpr size_t kStatusExitOff = 8;
constexpr uint64_t kReservedBytes = 24;  // header + footer + align gap
constexpr int kPublishDivisor = 4;       // RingReader.PUBLISH_DIVISOR

// ---------------------------------------------------------------------------
// POSIX shm region (the ShmDomain analog)
// ---------------------------------------------------------------------------

struct ShmRegion {
  std::string name;  // no leading slash (Python SharedMemory convention)
  uint8_t *base = nullptr;
  size_t len = 0;
  bool owner = false;

  bool create(size_t nbytes) {
    std::random_device rd;
    char buf[48];
    snprintf(buf, sizeof buf, "tpr_%08x%08x", rd(), rd());
    name = buf;
    std::string path = "/" + name;
    int fd = ::shm_open(path.c_str(), O_CREAT | O_EXCL | O_RDWR, 0600);
    if (fd < 0) return false;
    if (::ftruncate(fd, (off_t)nbytes) != 0) {
      ::close(fd);
      ::shm_unlink(path.c_str());
      return false;
    }
    base = static_cast<uint8_t *>(::mmap(nullptr, nbytes,
                                         PROT_READ | PROT_WRITE, MAP_SHARED,
                                         fd, 0));
    ::close(fd);
    if (base == MAP_FAILED) {
      base = nullptr;
      ::shm_unlink(path.c_str());
      return false;
    }
    memset(base, 0, nbytes);
    len = nbytes;
    owner = true;
    return true;
  }

  bool open(const std::string &handle_name, size_t nbytes) {
    name = handle_name;
    std::string path = "/" + name;
    int fd = ::shm_open(path.c_str(), O_RDWR, 0600);
    if (fd < 0) return false;
    base = static_cast<uint8_t *>(::mmap(nullptr, nbytes,
                                         PROT_READ | PROT_WRITE, MAP_SHARED,
                                         fd, 0));
    ::close(fd);
    if (base == MAP_FAILED) {
      base = nullptr;
      return false;
    }
    len = nbytes;
    owner = false;
    return true;
  }

  void close() {
    if (base) ::munmap(base, len);
    base = nullptr;
    if (owner && !name.empty()) ::shm_unlink(("/" + name).c_str());
    name.clear();
  }
};

// ---------------------------------------------------------------------------
// Minimal JSON helpers for the Address blob (we control both producers;
// the fields are flat string/int/list-of-string)
// ---------------------------------------------------------------------------

inline bool json_find_string(const std::string &j, const char *key,
                             std::string *out) {
  std::string pat = std::string("\"") + key + "\":";
  size_t p = j.find(pat);
  if (p == std::string::npos) return false;
  p += pat.size();
  while (p < j.size() && (j[p] == ' ')) ++p;
  if (p >= j.size() || j[p] != '"') return false;
  size_t q = j.find('"', p + 1);
  if (q == std::string::npos) return false;
  *out = j.substr(p + 1, q - p - 1);
  return true;
}

inline bool json_find_u64(const std::string &j, const char *key,
                          uint64_t *out) {
  std::string pat = std::string("\"") + key + "\":";
  size_t p = j.find(pat);
  if (p == std::string::npos) return false;
  p += pat.size();
  while (p < j.size() && j[p] == ' ') ++p;
  char *end = nullptr;
  unsigned long long v = strtoull(j.c_str() + p, &end, 10);
  if (end == j.c_str() + p) return false;
  *out = v;
  return true;
}

// ---------------------------------------------------------------------------
// The transport
// ---------------------------------------------------------------------------

// The wakeup disciplines (SURVEY §2.3): RDMA_BP/BPEV busy-poll the ring
// words for a bounded slice before blocking in poll() — the reference's
// pollable_epoll spin (ev_epollex_rdma_bp_linux.cc:1020-1110), bounded by
// GRPC_RDMA_BUSY_POLLING_TIMEOUT_US (default 500us, README:17-25);
// RDMA_EVENT never spins. A single-hart host never spins either: the peer
// can't run while we burn the core, so spinning only delays its wakeup
// (the Python poller makes the same call — poller.py).
inline int spin_budget_us_from_env() {
  const char *p = getenv("TPURPC_PLATFORM_TYPE");
  if (!p) p = getenv("GRPC_PLATFORM_TYPE");
  if (!p || strcmp(p, "RDMA_EVENT") == 0) return 0;
  const char *t = getenv("TPURPC_BUSY_POLLING_TIMEOUT_US");
  if (!t) t = getenv("GRPC_RDMA_BUSY_POLLING_TIMEOUT_US");
  if (t) {  // explicit knob wins, single-hart or not (operator's call)
    long v = strtol(t, nullptr, 10);
    return v > 0 ? (int)v : 0;
  }
  if (std::thread::hardware_concurrency() <= 1) return 0;
  return 500;
}

struct RingTransport {
  int notify_fd = -1;          // the bootstrap socket, kept as event channel
  ShmRegion recv_ring, status;        // ours (peer writes into them)
  ShmRegion peer_ring, peer_status;   // peer's (we write into them)
  uint64_t ring_size = 0;       // our recv ring capacity
  uint64_t peer_ring_size = 0;  // peer's recv ring capacity (we send into it)

  // reader state (our ring)
  uint64_t head = 0, msg_len = 0, msg_read = 0, consumed = 0, rseq = 0;
  uint64_t published_head = 0;
  // writer state (peer ring)
  uint64_t tail = 0, wseq = 0, remote_head = 0;
  // wakeup discipline (BP/BPEV spin slice; 0 = EVENT / single-hart)
  int spin_us = spin_budget_us_from_env();

  std::atomic<bool> alive{false};
  std::atomic<bool> peer_exited{false};  // reader + writer threads both touch
  std::mutex notify_mu;  // serializes notify-token sends

  // -- bootstrap -----------------------------------------------------------

  // Client side: full TRB1 exchange on a fresh socket. Server side: pass
  // preread_magic=true when the listener already consumed the 4 magic
  // bytes while sniffing the protocol. timeout_ms bounds the handshake
  // (pair.py BOOTSTRAP_TIMEOUT_S: a peer that connects but never speaks
  // must produce an error, not a hang); <=0 keeps the 20s default.
  bool bootstrap(int fd, uint64_t my_ring_size, bool preread_magic,
                 std::string *err, int timeout_ms = 0) {
    notify_fd = fd;
    ring_size = my_ring_size;
    struct timeval tv;
    tv.tv_sec = timeout_ms > 0 ? timeout_ms / 1000 : 20;
    tv.tv_usec = timeout_ms > 0 ? (timeout_ms % 1000) * 1000 : 0;
    setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof tv);
    setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof tv);
    bool ok = bootstrap_inner(fd, preread_magic, err);
    tv.tv_sec = 0;
    tv.tv_usec = 0;  // back to blocking for the notify channel
    setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof tv);
    setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof tv);
    return ok;
  }

  bool bootstrap_inner(int fd, bool preread_magic, std::string *err) {
    if (!recv_ring.create(ring_size) || !status.create(kStatusBytes)) {
      *err = "shm alloc failed";
      return false;
    }
    char tag[16];
    std::random_device rd;
    snprintf(tag, sizeof tag, "%08x", rd());
    char blob[512];
    int blen = snprintf(
        blob, sizeof blob,
        "{\"tag\": \"%s\", \"domain\": \"shm\", \"ring_size\": %llu, "
        "\"ring\": \"shm:%s\", \"status\": \"shm:%s\", \"caps\": []}",
        tag, (unsigned long long)ring_size, recv_ring.name.c_str(),
        status.name.c_str());
    // send: TRB1 + u32 len + blob
    char hdr[8] = {'T', 'R', 'B', '1'};
    uint32_t ln = (uint32_t)blen;
    memcpy(hdr + 4, &ln, 4);
    if (!tpr_wire::fd_write_all(fd, hdr, 8) ||
        !tpr_wire::fd_write_all(fd, blob, (size_t)blen)) {
      *err = "bootstrap send failed";
      return false;
    }
    // recv peer blob
    if (!preread_magic) {
      char magic[4];
      if (!tpr_wire::fd_read_exact(fd, magic, 4) ||
          memcmp(magic, "TRB1", 4) != 0) {
        *err = "bad bootstrap magic from peer (platform mismatch?)";
        return false;
      }
    }
    uint32_t plen = 0;
    if (!tpr_wire::fd_read_exact(fd, &plen, 4) || plen > (1u << 16)) {
      *err = "bootstrap length read failed";
      return false;
    }
    std::string pblob(plen, '\0');
    if (!tpr_wire::fd_read_exact(fd, pblob.data(), plen)) {
      *err = "bootstrap blob read failed";
      return false;
    }
    std::string domain, ring_h, status_h;
    uint64_t prs = 0;
    if (!json_find_string(pblob, "domain", &domain) ||
        !json_find_string(pblob, "ring", &ring_h) ||
        !json_find_string(pblob, "status", &status_h) ||
        !json_find_u64(pblob, "ring_size", &prs)) {
      *err = "malformed peer address blob";
      return false;
    }
    if (domain != "shm") {
      *err = "domain mismatch: peer offers '" + domain + "', this app is shm";
      return false;
    }
    if (ring_h.rfind("shm:", 0) != 0 || status_h.rfind("shm:", 0) != 0) {
      *err = "peer handles not shm";
      return false;
    }
    peer_ring_size = prs;
    if (!peer_ring.open(ring_h.substr(4), peer_ring_size) ||
        !peer_status.open(status_h.substr(4), kStatusBytes)) {
      *err = "mapping peer shm failed";
      return false;
    }
    alive.store(true);
    return true;
  }

  // -- byte-stream contract (same as the fd helpers) -----------------------

  bool write_all(const void *buf, size_t len) {
    const uint8_t *p = static_cast<const uint8_t *>(buf);
    while (len > 0 && alive.load()) {
      fold_credits();
      uint64_t writable = writable_now();
      if (writable == 0) {
        if (peer_gone()) return false;
        if (spin_for_credits()) continue;  // BP/BPEV: credits mid-spin
        if (!wait_event(100)) continue;  // slice + re-check (lost-notify safe)
        continue;
      }
      uint64_t n = len < writable ? len : writable;
      const uint8_t *segs[1] = {p};
      uint64_t lens[1] = {n};
      uint64_t got = tpr_ring_writev(peer_ring.base, peer_ring_size, &tail,
                                     remote_head, segs, lens, 1, &wseq);
      if (got == ~0ULL) continue;  // raced our own budget math
      p += got;
      len -= got;
      notify('d');
    }
    return len == 0;
  }

  // Whole-frame gather send: header + payload as ONE ring message with ONE
  // notify token — the per-RPC hot path (two write_all calls would cost two
  // framed messages and two notify syscalls). Falls back to sequential
  // write_all when the frame exceeds a single message's capacity.
  bool write_gather(const void *a, size_t alen, const void *b, size_t blen) {
    uint64_t total = alen + blen;
    uint64_t max_msg = peer_ring_size > kReservedBytes
                           ? peer_ring_size - kReservedBytes
                           : 0;
    if (total > max_msg)
      return write_all(a, alen) && (blen == 0 || write_all(b, blen));
    while (alive.load()) {
      fold_credits();
      if (writable_now() >= total) {
        const uint8_t *segs[2] = {static_cast<const uint8_t *>(a),
                                  static_cast<const uint8_t *>(b)};
        uint64_t lens[2] = {alen, blen};
        uint64_t got = tpr_ring_writev(peer_ring.base, peer_ring_size, &tail,
                                       remote_head, segs, lens,
                                       blen ? 2 : 1, &wseq);
        if (got != ~0ULL) {
          notify('d');
          return true;
        }
      }
      if (peer_gone()) return false;
      if (!spin_for_credits()) wait_event(100);
    }
    return false;
  }

  bool read_exact(void *buf, size_t len) {
    return read_exact_deadline(buf, len, nullptr) == 1;
  }

  // -- zero-copy send lease (SendZerocopy analog, pair.cc:793-941) ---------
  // Reserve ONE message's payload span in the peer ring (blocking for
  // credits like write_gather); the producer fills the returned (<=2,
  // wrap-split) segments in place — serialization targets the ring, no
  // staging copy — then commit_lease publishes (footer+header stamps) and
  // notifies. The caller must serialize reserve->commit against all other
  // sends on this transport (the channel write lock).
  bool reserve_lease(uint64_t payload_len, uint8_t **p1, uint64_t *l1,
                     uint8_t **p2, uint64_t *l2) {
    // can-NEVER-fit gate (same bound tpr_ring_reserve enforces, from the
    // same ring.cc home) — without it the credit loop below would wait
    // forever on a payload no amount of credits can grant
    if (payload_len == 0 ||
        payload_len > tpr_ring_max_payload(peer_ring_size))
      return false;
    while (alive.load()) {
      fold_credits();
      if (tpr_ring_reserve(peer_ring.base, peer_ring_size, tail, remote_head,
                           payload_len, p1, l1, p2, l2))
        return true;
      if (peer_gone()) return false;
      if (!spin_for_credits()) wait_event(100);
    }
    return false;
  }

  void commit_lease(uint64_t payload_len) {
    tpr_ring_commit(peer_ring.base, peer_ring_size, &tail, payload_len,
                    &wseq);
    notify('d');
  }

  // -- shared-poller (epoll) primitives ------------------------------------
  // The server's shared poller multiplexes many connections on one thread:
  // it epolls event_fd() (level-triggered), drains tokens, then pumps
  // read_some() until the ring is dry — no blocking read_exact on the
  // poller thread (the reference Poller's role, poller.cc:52-106).

  int event_fd() const { return notify_fd; }

  // Nonblocking drain of queued notify tokens. Returns -1 when the peer
  // closed the event channel (connection over), else the token count.
  // ALSO wakes any wait_event parkers: tokens are not addressed to a
  // particular waiter, so whoever drains them must publish "something
  // happened" to every blocked thread (see wait_event's epoch).
  int drain_tokens() {
    if (!epoll_tid_set.load(std::memory_order_acquire)) {
      // record the epoll loop's identity: ITS wait_event calls (a
      // callback handler blocking for response credits runs on this very
      // thread) must keep polling the fd — nobody else will — while
      // foreign threads park on ev_cv
      std::lock_guard<std::mutex> lk(ev_mu);
      epoll_tid = std::this_thread::get_id();
      epoll_tid_set.store(true, std::memory_order_release);
    }
    char tokens[256];
    int total = 0;
    while (true) {
      ssize_t n = ::recv(notify_fd, tokens, sizeof tokens, MSG_DONTWAIT);
      if (n == 0) {  // peer closed
        peer_exited = true;
        wake_waiters();
        return -1;
      }
      if (n < 0) break;  // EAGAIN: drained
      for (ssize_t i = 0; i < n; ++i)
        if (tokens[i] == 'x') peer_exited = true;
      total += static_cast<int>(n);
      if (n < static_cast<ssize_t>(sizeof tokens)) break;
    }
    if (total > 0) wake_waiters();
    return total;
  }

  void wake_waiters() {
    {
      std::lock_guard<std::mutex> lk(ev_mu);
      ++ev_epoch;
    }
    ev_cv.notify_all();
  }

  // Nonblocking ring read: up to `max` framing-stream bytes into buf.
  // Returns bytes read (0 = nothing available), or -1 when the stream is
  // over (peer gone with an empty ring, or corruption).
  ssize_t read_some(void *buf, size_t max) {
    uint64_t got = tpr_ring_read_into(recv_ring.base, ring_size, &head,
                                      &msg_len, &msg_read,
                                      static_cast<uint8_t *>(buf), max,
                                      &consumed, &rseq);
    if (got == ~0ULL) return -1;  // corruption
    if (got) {
      publish_credits_if_due();
      return static_cast<ssize_t>(got);
    }
    if (!alive.load() || ring_empty_and_peer_gone()) return -1;
    return 0;
  }

  // Deadline-aware read for the inline-pump discipline: 1 = filled,
  // -1 = dead, 0 = deadline passed with ZERO bytes consumed — the stream
  // is intact, so a frame-header read can be abandoned cleanly at a frame
  // boundary. Once any byte is consumed the deadline is ignored (the unit
  // must complete; peers write whole frames as one ring message on the
  // hot path, so the remainder is already in the ring).
  int read_exact_deadline(
      void *buf, size_t len,
      const std::chrono::steady_clock::time_point *deadline) {
    uint8_t *p = static_cast<uint8_t *>(buf);
    const size_t want = len;
    while (len > 0) {
      uint64_t got = tpr_ring_read_into(recv_ring.base, ring_size, &head,
                                        &msg_len, &msg_read, p, len,
                                        &consumed, &rseq);
      if (got == ~0ULL) return -1;  // corruption
      p += got;
      len -= got;
      publish_credits_if_due();
      if (len == 0) break;
      if (!alive.load()) return -1;
      if (ring_empty_and_peer_gone()) return -1;  // clean EOF
      int wait_ms = 100;
      if (deadline != nullptr && len == want) {
        auto now = std::chrono::steady_clock::now();
        if (now >= *deadline) return 0;
        auto rem = std::chrono::duration_cast<std::chrono::milliseconds>(
                       *deadline - now).count();
        if (rem < wait_ms) wait_ms = rem < 1 ? 1 : static_cast<int>(rem);
      }
      if (spin_for_message()) continue;  // BP/BPEV: data landed mid-spin
      wait_event(wait_ms);
    }
    return 1;
  }

  // Bounded busy-poll on the ring's header word (the BP/BPEV hot loop).
  // True = a message appeared; false = slice expired (caller blocks).
  bool spin_for_message() {
    if (spin_us <= 0) return false;
    auto end = std::chrono::steady_clock::now() +
               std::chrono::microseconds(spin_us);
    while (std::chrono::steady_clock::now() < end) {
      if (tpr_ring_has_message(recv_ring.base, ring_size, head, msg_len,
                               rseq))
        return true;
      if (!alive.load() || peer_exited.load()) return false;
#if defined(__x86_64__) || defined(__i386__)
      __builtin_ia32_pause();
#endif
    }
    return false;
  }

  void shutdown() {
    // graceful: tell the peer (exit word + token), then unblock our reader
    if (peer_status.base) {
      tpr_store_u64_seqcst(peer_status.base + kStatusExitOff, 1);
      notify('x');
    }
    alive.store(false);
    if (notify_fd >= 0) ::shutdown(notify_fd, SHUT_RDWR);
  }

  void close() {
    alive.store(false);
    recv_ring.close();
    status.close();
    peer_ring.close();
    peer_status.close();
  }

  // -- internals -----------------------------------------------------------

  void fold_credits() {
    uint64_t h = tpr_load_u64_fenced(status.base + kStatusHeadOff);
    if (h > remote_head && h <= tail) remote_head = h;
  }

  uint64_t writable_now() const {
    uint64_t used = tail - remote_head;
    return used + kReservedBytes >= peer_ring_size
               ? 0
               : peer_ring_size - used - kReservedBytes;
  }

  // Bounded busy-poll on the peer-published credit word (write twin of
  // spin_for_message; the reference's writer watches remote_head the same
  // way, pair.cc:294-301).
  bool spin_for_credits() {
    if (spin_us <= 0) return false;
    auto end = std::chrono::steady_clock::now() +
               std::chrono::microseconds(spin_us);
    while (std::chrono::steady_clock::now() < end) {
      fold_credits();
      if (writable_now() > 0) return true;
      if (!alive.load() || peer_gone()) return false;
#if defined(__x86_64__) || defined(__i386__)
      __builtin_ia32_pause();
#endif
    }
    return false;
  }

  bool peer_gone() {
    return tpr_load_u64_fenced(status.base + kStatusExitOff) != 0 ||
           peer_exited || !alive.load();
  }

  bool ring_empty_and_peer_gone() {
    if (!peer_gone()) return false;
    // peer exited, but drain whatever it wrote before leaving
    return !tpr_ring_has_message(recv_ring.base, ring_size, head, msg_len,
                                 rseq) &&
           msg_len == 0;
  }

  void publish_credits_if_due(bool force = false) {
    if (!peer_status.base) return;
    if (force || consumed >= ring_size / kPublishDivisor) {
      consumed = 0;
      if (head != published_head) {
        published_head = head;
        tpr_store_u64_seqcst(peer_status.base + kStatusHeadOff, head);
        notify('c');
      }
    }
  }

  void notify(char token) {
    std::lock_guard<std::mutex> lk(notify_mu);
    if (notify_fd < 0) return;
    ::send(notify_fd, &token, 1, MSG_NOSIGNAL | MSG_DONTWAIT);
    // EAGAIN => tokens already queued: the peer has wakeups pending
  }

  // Block up to timeout_ms for a notify token (or peer close). Returns true
  // if an event arrived (possibly drained by ANOTHER thread).
  //
  // Multiple threads legally block here at once — a reader waiting for
  // data and a writer waiting for credits share ONE notify fd, and the
  // tokens are not addressed. Two threads racing poll()+recv() on the fd
  // STEAL each other's wakeups: the reader can drain the writer's 'c'
  // credit token, re-check its (empty) ring, and sleep again, leaving the
  // writer to burn its full timeout while the peer has already returned
  // credits — measured as bulk sends moving exactly one ring per 100 ms
  // slice (~0.07 GB/s; 6-8x off). So: ONE thread polls the fd; everyone
  // else parks on a condition variable that the drainer (this poller, or
  // the server's epoll loop via drain_tokens) bumps for every drain.
  bool wait_event(int timeout_ms) {
    auto deadline = std::chrono::steady_clock::now() +
                    std::chrono::milliseconds(timeout_ms);
    std::unique_lock<std::mutex> lk(ev_mu);
    uint64_t e = ev_epoch;
    for (;;) {
      // Is the fd owned by a shared epoll loop, and is this a FOREIGN
      // thread? Then a recv() here would steal 'd' tokens the
      // level-triggered epoll needs to pump requests (they'd sit unread in
      // the ring) — park for the owner's drain instead. The epoll thread
      // ITSELF (a callback handler blocking for response credits) keeps
      // polling: its pump_conn continuation drains the ring either way,
      // and nobody else would read the fd while it is blocked here.
      bool foreign = epoll_owned.load() &&
                     !(epoll_tid_set.load() &&
                       epoll_tid == std::this_thread::get_id());
      if (foreign) {
        ev_cv.wait_until(lk, deadline, [&] { return ev_epoch != e; });
        return ev_epoch != e;
      }
      if (ev_polling) {
        // Parked waiters also wake when the polling thread STANDS DOWN
        // (ev_polling -> false, e.g. its own timeout): one of them must
        // take over the fd poll, or queued tokens sit unread while every
        // parked waiter sleeps out its full timeout (ADVICE r5 — a
        // bounded re-run of the wake-latency bug this machinery fixed).
        ev_cv.wait_until(lk, deadline,
                         [&] { return ev_epoch != e || !ev_polling; });
        if (ev_epoch != e) return true;
        if (std::chrono::steady_clock::now() >= deadline) return false;
        continue;  // poller stood down with time left: take over the fd
      }
      ev_polling = true;
      lk.unlock();
      auto remain = std::chrono::duration_cast<std::chrono::milliseconds>(
                        deadline - std::chrono::steady_clock::now())
                        .count();
      if (remain < 0) remain = 0;
      struct pollfd pfd = {notify_fd, POLLIN, 0};
      int r = ::poll(&pfd, 1, static_cast<int>(remain));
      bool got = false;
      if (r > 0) {
        char tokens[64];
        ssize_t n = ::recv(notify_fd, tokens, sizeof tokens, MSG_DONTWAIT);
        if (n == 0) {  // peer closed the event channel: connection over
          peer_exited = true;
          got = true;
        } else if (n > 0) {
          for (ssize_t i = 0; i < n; ++i)
            if (tokens[i] == 'x') peer_exited = true;
          got = true;
        }
      }
      lk.lock();
      ev_polling = false;
      if (got) ++ev_epoch;
      bool advanced = ev_epoch != e;
      lk.unlock();
      ev_cv.notify_all();  // hand the fd off + deliver the drain
      return advanced;
    }
  }

  std::mutex ev_mu;
  std::condition_variable ev_cv;
  uint64_t ev_epoch = 0;   // bumped on every token drain (any drainer)
  bool ev_polling = false; // a thread owns the poll on notify_fd
  //: set when a shared epoll poller adopts this transport's fd
  //: (tpurpc_server.cc Poller::add): from then on only drain_tokens (the
  //: epoll loop) and the epoll thread's own wait_event calls touch the
  //: fd; foreign wait_event callers park on ev_cv
  std::atomic<bool> epoll_owned{false};
  std::thread::id epoll_tid{};           // ev_mu; valid once epoll_tid_set
  std::atomic<bool> epoll_tid_set{false};
};

}  // namespace tpr_ring

#endif  // TPURPC_RING_TRANSPORT_H
