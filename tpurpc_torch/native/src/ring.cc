// tpurpc native data plane: framed-ring hot ops behind a C ABI (ctypes-loaded).
//
// Same wire format as tpurpc_torch/core/ring.py (which re-derives the math of the
// reference's src/core/lib/ibverbs/ring_buffer.{h,cc}, then diverges on
// completion detection):
//
//   [8B header = lo32 payload len | hi32 seq32][payload, padded to 8B]
//   [8B footer = seq64 ^ kFooterSalt]
//
// where seq is the per-ring monotone message counter (seq32 = its low 32
// bits). The reference detects completion by keeping the consumed region
// zero (reader memsets what it eats, ring_buffer.cc:122-191); that is a
// full extra memory pass over every byte. Stamping each message with a
// never-repeating sequence makes stale bytes self-evidently stale instead:
// a message is complete iff header.seq32 == expected && footer == expected
// seq64 pattern — 96 bits of freshness, no zeroing. (The peer writes every
// ring byte either way; this is not a trust boundary.)
//
// capacity is a power of two >= 64; offsets are monotonically increasing
// 64-bit counters masked on access; no 8B word ever straddles the wrap.
//
// Memory model: one producer process writes, one consumer process reads over
// shared memory. Stores are ordered payload -> footer -> header with a
// release fence before the header store; the reader issues an acquire fence
// after observing a matching header+footer. (The reference gets placement
// order from a single RDMA WRITE; shm needs the fences spelled out.)

#include <atomic>
#include <cstdint>
#include <cstring>
#include <ctime>

#include <sched.h>

#if defined(__x86_64__) || defined(__i386__)
#include <immintrin.h>
#define TPR_PAUSE() _mm_pause()
#else
#define TPR_PAUSE() std::atomic_thread_fence(std::memory_order_seq_cst)
#endif

namespace {

constexpr uint64_t kAlign = 8;
constexpr uint64_t kHeader = 8;
constexpr uint64_t kFooter = 8;
constexpr uint64_t kFooterSalt = 0xA5C3F00D5EEDFACEULL;
constexpr uint64_t kReserved = kHeader + kFooter + kAlign;

inline uint64_t footer_stamp(uint64_t seq) { return seq ^ kFooterSalt; }
inline uint64_t header_stamp(uint64_t len, uint64_t seq) {
  return (len & 0xFFFFFFFFULL) | (seq << 32);
}

inline uint64_t align_up(uint64_t n) { return (n + kAlign - 1) & ~(kAlign - 1); }
inline uint64_t msg_span(uint64_t len) { return kHeader + align_up(len) + kFooter; }

inline uint64_t load_word(const uint8_t* ring, uint64_t mask, uint64_t off) {
  uint64_t w;
  std::memcpy(&w, ring + (off & mask), sizeof(w));
  return w;
}

inline void store_word(uint8_t* ring, uint64_t mask, uint64_t off, uint64_t w) {
  std::memcpy(ring + (off & mask), &w, sizeof(w));
}

// Copy a logical span out of the ring (<=2 physical segments at the wrap).
void copy_out(const uint8_t* ring, uint64_t cap, uint64_t mask, uint64_t off,
              uint8_t* dst, uint64_t n) {
  uint64_t p = off & mask;
  uint64_t first = cap - p;
  if (n <= first) {
    std::memcpy(dst, ring + p, n);
  } else {
    std::memcpy(dst, ring + p, first);
    std::memcpy(dst + first, ring, n - first);
  }
}

void copy_in(uint8_t* ring, uint64_t cap, uint64_t mask, uint64_t off,
             const uint8_t* src, uint64_t n) {
  uint64_t p = off & mask;
  uint64_t first = cap - p;
  if (n <= first) {
    std::memcpy(ring + p, src, n);
  } else {
    std::memcpy(ring + p, src, first);
    std::memcpy(ring, src + first, n - first);
  }
}

// Complete-message scan at `off` for sequence number `seq`: payload length,
// 0 if none/incomplete. A seq32 match with an implausible length is treated
// as stale bytes, NOT corruption: after 2^32 messages the 32-bit stamp laps,
// and old payload bytes (e.g. zeros, whose hi-word matches any seq ≡ 0
// mod 2^32 — including the all-zero fresh ring at seq 0) may transiently
// mimic a stamped header until the writer's real header lands. The 64-bit
// footer stamp still gates actual completion.
uint64_t message_at(const uint8_t* ring, uint64_t cap, uint64_t mask,
                    uint64_t off, uint64_t seq) {
  uint64_t hdr = load_word(ring, mask, off);
  if ((hdr >> 32) != (seq & 0xFFFFFFFFULL)) return 0;  // stale or in-flight
  uint64_t len = hdr & 0xFFFFFFFFULL;
  if (len == 0 || len > cap - kReserved) return 0;  // stale lookalike
  uint64_t footer = load_word(ring, mask, off + kHeader + align_up(len));
  if (footer != footer_stamp(seq)) return 0;  // body still in flight
  std::atomic_thread_fence(std::memory_order_acquire);
  return len;
}

}  // namespace

extern "C" {

int tpr_abi_version() { return 7; }

// --- waiter-advertisement protocol (the futex-style sleep handshake) --------
//
// The reference's BP mode costs ZERO syscalls per send: the receiver discovers
// data by polling the ring, and only the EVENT/BPEV sleep path needs a wake
// (write-with-imm / completion channel, rdma_event_posix.cc). Our analog: a
// waiter publishes "I am blocked on the notify fd" in its own status region
// before sleeping; the peer reads that word after its data/credit store and
// sends the 1-byte notify ONLY when someone is actually asleep.
//
// Correctness is the classic Dekker/futex argument and needs StoreLoad
// ordering on both sides, which x86's TSO does NOT give for free:
//   waiter:  store waiting=1 (seq_cst = full fence) ; load ring state
//   sender:  store data      ; full fence           ; load waiting
// If the waiter missed the data, its waiting store is ordered before the
// sender's fenced load, so the sender sees waiting=1 and kicks. If the sender
// saw waiting=0, the waiter's store came later, so its ring re-check (after
// its own fence) sees the data and never blocks. Lost wakeups are impossible.

void tpr_store_u64_seqcst(uint8_t* addr, uint64_t val) {
  __atomic_store_n(reinterpret_cast<uint64_t*>(addr), val, __ATOMIC_SEQ_CST);
  // The waiter's subsequent ring/credit re-checks are PLAIN loads issued from
  // Python; a seq_cst store alone does not forbid them from hoisting above it
  // on aarch64 (stlr only orders against ldar). The explicit fence buys the
  // StoreLoad edge the proof needs on every architecture (x86: the xchg the
  // store compiles to was already a full barrier; the extra mfence is noise
  // on the sleep path).
  std::atomic_thread_fence(std::memory_order_seq_cst);
}

uint64_t tpr_load_u64_fenced(const uint8_t* addr) {
  std::atomic_thread_fence(std::memory_order_seq_cst);
  return __atomic_load_n(reinterpret_cast<const uint64_t*>(addr),
                         __ATOMIC_SEQ_CST);
}

// Total drainable payload bytes (all complete messages + pending remainder).
// `seq` is the expected sequence of the FIRST unparsed message at/after head.
uint64_t tpr_ring_readable(const uint8_t* ring, uint64_t cap, uint64_t head,
                           uint64_t msg_len, uint64_t msg_read,
                           uint64_t seq) {
  uint64_t mask = cap - 1;
  uint64_t total = 0;
  uint64_t off = head;
  if (msg_len) {  // in-progress message carries `seq`; the next one is seq+1
    total += msg_len - msg_read;
    off += msg_span(msg_len);
    ++seq;
  }
  uint64_t scanned = 0;
  while (scanned < cap) {
    uint64_t ln = message_at(ring, cap, mask, off, seq);
    if (ln == 0 || ln == ~0ULL) break;
    total += ln;
    uint64_t sp = msg_span(ln);
    off += sp;
    scanned += sp;
    ++seq;
  }
  return total;
}

// Drain up to dst_len payload bytes. Returns bytes read, or ~0 on corruption.
// head/msg_len/msg_read/consumed/seq are caller state, updated in place.
// No zeroing of consumed spans: freshness comes from the seq stamps.
uint64_t tpr_ring_read_into(uint8_t* ring, uint64_t cap, uint64_t* head,
                            uint64_t* msg_len, uint64_t* msg_read,
                            uint8_t* dst, uint64_t dst_len,
                            uint64_t* consumed, uint64_t* seq) {
  uint64_t mask = cap - 1;
  uint64_t total = 0;
  while (total < dst_len) {
    if (*msg_len == 0) {
      uint64_t ln = message_at(ring, cap, mask, *head, *seq);
      if (ln == ~0ULL) return ~0ULL;
      if (ln == 0) break;
      *msg_len = ln;
      *msg_read = 0;
    }
    uint64_t want = dst_len - total;
    uint64_t left = *msg_len - *msg_read;
    uint64_t n = want < left ? want : left;
    copy_out(ring, cap, mask, *head + kHeader + *msg_read, dst + total, n);
    *msg_read += n;
    total += n;
    if (*msg_read == *msg_len) {
      uint64_t sp = msg_span(*msg_len);
      *head += sp;
      *consumed += sp;
      *msg_len = 0;
      *msg_read = 0;
      ++*seq;
    }
  }
  return total;
}

// Gather-encode one message at *tail (payload -> footer -> fence -> header),
// stamped with *seq. Returns payload bytes written, or ~0 if it doesn't fit
// the writable span.
uint64_t tpr_ring_writev(uint8_t* ring, uint64_t cap, uint64_t* tail,
                         uint64_t remote_head,
                         const uint8_t* const* segs, const uint64_t* lens,
                         uint32_t nsegs, uint64_t* seq) {
  uint64_t mask = cap - 1;
  uint64_t payload = 0;
  for (uint32_t i = 0; i < nsegs; ++i) payload += lens[i];
  if (payload == 0) return 0;
  uint64_t used = *tail - remote_head;
  uint64_t writable = used + kReserved >= cap ? 0 : cap - used - kReserved;
  if (payload > writable) return ~0ULL;
  uint64_t off = *tail + kHeader;
  for (uint32_t i = 0; i < nsegs; ++i) {
    copy_in(ring, cap, mask, off, segs[i], lens[i]);
    off += lens[i];
  }
  store_word(ring, mask, *tail + kHeader + align_up(payload),
             footer_stamp(*seq));
  std::atomic_thread_fence(std::memory_order_release);
  store_word(ring, mask, *tail, header_stamp(payload, *seq));
  *tail += msg_span(payload);
  ++*seq;
  return payload;
}

// --- zero-copy send lease (VERDICT r4 next #6) ------------------------------
// The reference's SendZerocopy (pair.cc:793-941) posts the CALLER's pinned
// buffer to the NIC, so no CPU staging copy happens before the wire. A shm
// ring's analog: let the producer BUILD the payload directly in the peer
// ring — reserve one message's span, hand back its (<=2, wrap) physical
// segments, and publish only at commit. Between the two the reader cannot
// see the message (its header word still fails the seq check), so the
// producer may fill the span at leisure. Claims must be serialized by the
// caller (the channel's write lock) — reserve does not advance *tail;
// commit does, so two concurrent reserves would claim the same span.

// Largest payload one message can ever carry in a ring of `cap` bytes —
// the ONE home of the bound both reserve-side prechecks and this file's
// own math use (a drifted duplicate would make reserve_lease spin forever
// on a payload tpr_ring_reserve can never grant).
uint64_t tpr_ring_max_payload(uint64_t cap) {
  return cap > kReserved ? cap - kReserved : 0;
}

uint64_t tpr_ring_reserve(uint8_t* ring, uint64_t cap, uint64_t tail,
                          uint64_t remote_head, uint64_t payload_len,
                          uint8_t** p1, uint64_t* l1,
                          uint8_t** p2, uint64_t* l2) {
  uint64_t mask = cap - 1;
  if (payload_len == 0 || payload_len > cap - kReserved) return 0;
  uint64_t used = tail - remote_head;
  uint64_t writable = used + kReserved >= cap ? 0 : cap - used - kReserved;
  if (payload_len > writable) return 0;
  uint64_t p = (tail + kHeader) & mask;
  uint64_t first = cap - p;
  if (payload_len <= first) {
    *p1 = ring + p;
    *l1 = payload_len;
    *p2 = nullptr;
    *l2 = 0;
  } else {
    *p1 = ring + p;
    *l1 = first;
    *p2 = ring;
    *l2 = payload_len - first;
  }
  return 1;
}

void tpr_ring_commit(uint8_t* ring, uint64_t cap, uint64_t* tail,
                     uint64_t payload_len, uint64_t* seq) {
  uint64_t mask = cap - 1;
  store_word(ring, mask, *tail + kHeader + align_up(payload_len),
             footer_stamp(*seq));
  std::atomic_thread_fence(std::memory_order_release);
  store_word(ring, mask, *tail, header_stamp(payload_len, *seq));
  *tail += msg_span(payload_len);
  ++*seq;
}

// Fused fast-path send (the per-RPC hot loop of pair.py's send(), one call
// instead of ~10 Python-level steps): fold the peer-published credit head
// from our status page, gather-encode the segments as chunked ring messages
// under the credit budget, then decide — with the fenced load the sleep
// protocol requires — whether the peer needs a notify byte.
//
//   status_addr:      our status page (peer one-sided-writes credits at +0)
//   peer_rxwait_addr: peer's status page read-waiter word, or null (then
//                     *notify_out is always 1 when bytes were written)
//   chunk_size:       max payload per ring message (send_chunk_size)
//
// Returns payload bytes accepted — possibly a PARTIAL total (0 = fully
// stalled for credits); the caller resumes the remainder via its byte
// cursor. *tail / *seq / *remote_head update in place. Never returns ~0ULL.
uint64_t tpr_send_fast(uint8_t* ring, uint64_t cap, uint64_t* tail,
                       uint64_t* seq, const uint8_t* status_addr,
                       uint64_t* remote_head,
                       const uint8_t* peer_rxwait_addr,
                       const uint8_t* const* segs, const uint64_t* lens,
                       uint32_t nsegs, uint64_t chunk_size,
                       int* notify_out) {
  // fold credits (pair.cc:294-301 reading mirrored remote_head; monotone)
  uint64_t head = __atomic_load_n(
      reinterpret_cast<const uint64_t*>(status_addr), __ATOMIC_ACQUIRE);
  if (head > *remote_head && head <= *tail) *remote_head = head;

  uint64_t total = 0;
  uint32_t si = 0;
  uint64_t so = 0;
  const uint8_t* chunk_ptrs[64];
  uint64_t chunk_lens[64];
  while (si < nsegs) {
    uint64_t used = *tail - *remote_head;
    uint64_t writable = used + kReserved >= cap ? 0 : cap - used - kReserved;
    uint64_t budget = writable < chunk_size ? writable : chunk_size;
    if (budget == 0) break;
    // assemble one chunk's worth of (sub)segments
    uint32_t n = 0;
    uint64_t take_total = 0;
    while (si < nsegs && take_total < budget && n < 64) {
      uint64_t avail = lens[si] - so;
      uint64_t take = budget - take_total < avail ? budget - take_total : avail;
      if (take) {
        chunk_ptrs[n] = segs[si] + so;
        chunk_lens[n] = take;
        ++n;
      }
      take_total += take;
      so += take;
      if (so == lens[si]) {
        ++si;
        so = 0;
      }
    }
    if (take_total == 0) break;
    uint64_t got = tpr_ring_writev(ring, cap, tail, *remote_head,
                                   chunk_ptrs, chunk_lens, n, seq);
    if (got == ~0ULL) break;  // unreachable (budget uses writev's own math);
                              // defensively: report what IS on the wire —
                              // the caller resumes from the returned total
    total += got;
  }
  // Notify only a sleeping peer (fenced load AFTER the data stores — the
  // producer half of the sleep protocol; see tpr_store_u64_seqcst).
  if (total == 0) {
    *notify_out = 0;
  } else if (peer_rxwait_addr == nullptr) {
    *notify_out = 1;
  } else {
    std::atomic_thread_fence(std::memory_order_seq_cst);
    *notify_out = __atomic_load_n(
        reinterpret_cast<const uint64_t*>(peer_rxwait_addr),
        __ATOMIC_SEQ_CST) != 0;
  }
  return total;
}

// Has a complete message? (poller fast check; 1 = yes, 0 = no, -1 corruption)
int tpr_ring_has_message(const uint8_t* ring, uint64_t cap, uint64_t head,
                         uint64_t msg_len, uint64_t seq) {
  if (msg_len) return 1;
  uint64_t ln = message_at(ring, cap, cap - 1, head, seq);
  if (ln == ~0ULL) return -1;
  return ln != 0 ? 1 : 0;
}

namespace {
inline uint64_t now_ns() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return uint64_t(ts.tv_sec) * 1000000000ULL + uint64_t(ts.tv_nsec);
}
}  // namespace

// GIL-free spin-waits (loaded via CDLL, not PyDLL): the busy window of the
// BP/BPEV disciplines runs here at native speed without starving other
// Python threads. Mirrors the reference's busy-poll loops
// (ev_epollex_rdma_bp_linux.cc:1020-1110 scanning pairs for HasMessage,
// pair.cc:407-411 waitDataWrites spinning the CQ). Callers bound each call
// by timeout_us and re-check full pair state between calls.

// Spin until a complete message sits at `head` (1), corruption (-1), or
// timeout (0). The watched words live in this side's OWN receive ring, whose
// lifetime the caller pins for the duration of the call.
int tpr_ring_wait_message(const uint8_t* ring, uint64_t cap, uint64_t head,
                          uint64_t seq, uint64_t timeout_us) {
  uint64_t mask = cap - 1;
  uint64_t deadline = now_ns() + timeout_us * 1000ULL;
  for (;;) {
    uint64_t ln = message_at(ring, cap, mask, head, seq);
    if (ln == ~0ULL) return -1;
    if (ln != 0) return 1;
    for (int i = 0; i < 64; ++i) TPR_PAUSE();
    // sched_yield per lap (GRPC_RDMA_POLLING_YIELD, rdma_utils.h:75-80):
    // ~100ns on an idle multicore; on an oversubscribed host it hands the
    // core to the producer we are waiting on instead of burning the slice.
    sched_yield();
    if (now_ns() >= deadline) return 0;
  }
}

// Spin until the u64 at `addr` differs from `old` (returns 1) or timeout (0).
// Used by credit-stalled writers watching their own status buffer's
// remote-head word (the peer one-sided-writes credits there), and for the
// peer_exit word.
int tpr_spin_u64_change(const uint8_t* addr, uint64_t old_val,
                        uint64_t timeout_us) {
  uint64_t deadline = now_ns() + timeout_us * 1000ULL;
  for (;;) {
    uint64_t w;
    std::memcpy(&w, addr, sizeof(w));
    if (w != old_val) {
      std::atomic_thread_fence(std::memory_order_acquire);
      return 1;
    }
    for (int i = 0; i < 64; ++i) TPR_PAUSE();
    sched_yield();
    if (now_ns() >= deadline) return 0;
  }
}

}  // extern "C"
