// Native rendezvous + ctrl rings (see tpr_rdv.h for the role overview).
// Byte layouts mirror tpurpc_torch/core/rendezvous.py and tpurpc_torch/core/ctrlring.py
// exactly — a Python peer and this C plane read each other's structs.
#include "tpr_rdv.h"

#include <pthread.h>
#include <sched.h>

#include "tpr_obs.h"

#include <algorithm>
#include <cstring>
#include <random>
#include <thread>

namespace tpr_rdv {

std::atomic<uint64_t> g_counters[kNumCounters] = {};

// -- env ---------------------------------------------------------------------

static bool env_off(const char *name) {
  const char *v = getenv(name);
  if (!v) return false;
  return strcmp(v, "0") == 0 || strcasecmp(v, "off") == 0 ||
         strcasecmp(v, "false") == 0;
}

bool enabled() { return !env_off("TPURPC_RENDEZVOUS"); }
bool ctrl_enabled() { return !env_off("TPURPC_CTRL_RING"); }

static uint64_t env_u64(const char *name, uint64_t dflt) {
  const char *v = getenv(name);
  if (!v) return dflt;
  char *end = nullptr;
  unsigned long long n = strtoull(v, &end, 10);
  return end == v ? dflt : (uint64_t)n;
}

uint64_t min_bytes() {
  uint64_t kb = env_u64("TPURPC_RENDEZVOUS_MIN_KB", 256);
  if (kb < 1) kb = 1;
  return kb * 1024;
}

uint64_t pool_budget() {
  uint64_t mb = env_u64("TPURPC_RENDEZVOUS_POOL_MB", 256);
  if (mb < 1) mb = 1;
  return mb << 20;
}

double claim_timeout_s() {
  const char *v = getenv("TPURPC_RENDEZVOUS_CLAIM_TIMEOUT_S");
  if (!v) return 5.0;
  char *end = nullptr;
  double d = strtod(v, &end);
  return end == v ? 5.0 : d;
}

uint32_t ctrl_slots() {
  uint64_t n = env_u64("TPURPC_CTRL_RING_SLOTS", 64);
  if (n < 8) n = 8;
  return (uint32_t)n;
}

uint64_t size_class(uint64_t nbytes) {
  uint64_t c = kMinClass;
  while (c < nbytes) c <<= 1;
  return c;
}

// -- little helpers ----------------------------------------------------------

static uint64_t rd_u64(const uint8_t *p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;
}
static uint32_t rd_u32(const uint8_t *p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}
static uint16_t rd_u16(const uint8_t *p) {
  uint16_t v;
  memcpy(&v, p, 2);
  return v;
}
static void put_u64(std::string &s, uint64_t v) {
  s.append(reinterpret_cast<const char *>(&v), 8);
}
static void put_u16s(std::string &s, uint16_t v) {
  s.append(reinterpret_cast<const char *>(&v), 2);
}
static void put_u32s(std::string &s, uint32_t v) {
  s.append(reinterpret_cast<const char *>(&v), 4);
}

static void fill_nonce(uint8_t *out) {
  static std::mutex mu;
  std::lock_guard<std::mutex> lk(mu);
  static std::mt19937_64 gen{std::random_device{}()};
  for (size_t i = 0; i < kNonceBytes; i += 8) {
    uint64_t r = gen();
    memcpy(out + i, &r, 8);
  }
}

static unsigned long self_tid() {
  return (unsigned long)pthread_self();
}

// TPURPC_RDV_DEBUG=1: stderr trace of the control ladder (dev aid only;
// the getenv is cached, flip it before process start)
static bool dbg_on() {
  static int v = -1;
  if (v < 0) {
    const char *e = getenv("TPURPC_RDV_DEBUG");
    v = (e && *e && strcmp(e, "0") != 0) ? 1 : 0;
  }
  return v == 1;
}
#define RDV_DBG(...)                                  \
  do {                                                \
    if (dbg_on()) {                                   \
      fprintf(stderr, "[rdv %s %lu] ", name_.c_str(), self_tid()); \
      fprintf(stderr, __VA_ARGS__);                   \
      fputc('\n', stderr);                           \
    }                                                 \
  } while (0)

// ---------------------------------------------------------------------------
// Landing pool: process-wide, shm regions pooled by size class under the
// byte budget. Region layout (offset 0 — the mmap base is page-aligned, so
// the 64 B alignment contract holds for free):
//   [payload: cls bytes][nonce: 16][doorbell: 8]
// The budget accounting constant (cls + 64 + 16 + 8) matches the Python
// pool's so the two planes exhaust comparably under one knob.
// ---------------------------------------------------------------------------

struct PoolRegion {
  tpr_ring::ShmRegion shm;
  uint64_t cls = 0;
  uint8_t nonce[kNonceBytes];

  // Consumer-freed count, read by the sender through its window — the
  // zero-frame "region reusable" signal. Release so the payload reads
  // that precede the free can't sink past the publish; the sender's
  // acquire read pairs with it.
  void doorbell_store(uint64_t v) {
    __atomic_store_n(reinterpret_cast<uint64_t *>(shm.base + cls +
                                                  kNonceBytes),
                     v, __ATOMIC_RELEASE);
  }
};

class Pool {
 public:
  static Pool &inst() {
    static Pool p;
    return p;
  }

  // Static-destruction sweep of the recycle cache: regions parked in the
  // free buckets are process-lifetime reuse capital, but they must still
  // unmap+unlink at exit (shm objects outlive the process otherwise, and
  // LeakSanitizer rightly flags the cached PoolRegions).
  ~Pool() {
    for (auto &kv : free_)
      for (PoolRegion *pr : kv.second) {
        pr->shm.close();
        delete pr;
      }
  }

  PoolRegion *lease(uint64_t cls) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      auto it = free_.find(cls);
      if (it != free_.end() && !it->second.empty()) {
        PoolRegion *pr = it->second.back();
        it->second.pop_back();
        pr->doorbell_store(0);  // fresh lease: no consumer history
        return pr;
      }
      uint64_t alloc = cls + 64 + kNonceBytes + 8;
      if (allocated_ + alloc > pool_budget()) return nullptr;
      allocated_ += alloc;
    }
    PoolRegion *pr = new PoolRegion();
    pr->cls = cls;
    if (!pr->shm.create(cls + kNonceBytes + 8)) {
      std::lock_guard<std::mutex> lk(mu_);
      allocated_ -= cls + 64 + kNonceBytes + 8;
      delete pr;
      return nullptr;
    }
    fill_nonce(pr->nonce);
    memcpy(pr->shm.base + cls, pr->nonce, kNonceBytes);
    return pr;
  }

  void recycle(PoolRegion *pr) {
    std::lock_guard<std::mutex> lk(mu_);
    free_[pr->cls].push_back(pr);
  }

  // Death-path quarantine: destroy, never re-lease — a straggling peer
  // window may still land a late one-sided write, which must hit the
  // orphaned shm object (its mapping stays valid on the writer's side
  // until IT closes), never a region re-leased to a new transfer.
  void discard(PoolRegion *pr) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      allocated_ -= pr->cls + 64 + kNonceBytes + 8;
    }
    pr->shm.close();
    delete pr;
  }

 private:
  std::mutex mu_;
  std::map<uint64_t, std::vector<PoolRegion *>> free_;
  uint64_t allocated_ = 0;
};

// ---------------------------------------------------------------------------
// Receiver-side lease (RegionLease mirror). Settlement state is shared
// between the delivering dispatch thread, whichever thread drops the last
// consumer reference (settle()), and the link's death path — hence the
// per-lease mutex and the single recycled transition.
// ---------------------------------------------------------------------------

struct Lease {
  std::mutex mu;
  uint64_t id = 0, cls = 0;
  PoolRegion *pr = nullptr;
  bool standing = false, pregrant = false;
  uint64_t delivered = 0, freed = 0;
  bool retired = false, discard = false, recycled = false;

  // The ONE recycle rule: back to the pool exactly once, when no further
  // delivery can happen AND no delivered buffer is still referenced.
  bool maybe_recycle_locked() {
    if (recycled) return false;
    bool done = retired || (delivered > 0 && !standing);
    if (done && freed == delivered) {
      recycled = true;
      return true;
    }
    return false;
  }

  void on_freed(uint64_t gen) {
    bool rec, disc, ring;
    {
      std::lock_guard<std::mutex> lk(mu);
      freed = std::max(freed, gen);
      rec = maybe_recycle_locked();
      disc = discard;
      ring = standing && !retired;
    }
    if (rec) {
      if (disc)
        Pool::inst().discard(pr);
      else
        Pool::inst().recycle(pr);
      pr = nullptr;
    } else if (ring) {
      pr->doorbell_store(gen);
    }
  }

  void release(bool disc) {
    bool rec, d;
    {
      std::lock_guard<std::mutex> lk(mu);
      retired = true;
      if (disc) discard = true;
      rec = maybe_recycle_locked();
      d = discard;
    }
    if (rec) {
      if (d)
        Pool::inst().discard(pr);
      else
        Pool::inst().recycle(pr);
      pr = nullptr;
    }
  }
};

// -- settle registry ---------------------------------------------------------

namespace {
struct SettleEntry {
  std::shared_ptr<Lease> lease;
  uint64_t gen;
};
std::mutex g_settle_mu;
std::unordered_map<const void *, SettleEntry> g_settle;
}  // namespace

bool settle(const void *ptr) {
  SettleEntry e;
  {
    std::lock_guard<std::mutex> lk(g_settle_mu);
    auto it = g_settle.find(ptr);
    if (it == g_settle.end()) return false;
    e = it->second;
    g_settle.erase(it);
  }
  e.lease->on_freed(e.gen);
  return true;
}

bool is_delivery(const void *ptr) {
  std::lock_guard<std::mutex> lk(g_settle_mu);
  return g_settle.count(ptr) != 0;
}

// -- sender-side claim -------------------------------------------------------

struct Claim {
  uint64_t lease_id = 0;
  std::string kind, handle;
  uint64_t offset = 0, capacity = 0;
  uint8_t nonce[kNonceBytes];
  bool standing = false;
  uint64_t used = 0;
  bool inflight = false;
};

// -- wire codecs (rendezvous.py _pack_*/_unpack_*) ---------------------------

static std::string pack_offer(uint64_t req, uint64_t nbytes) {
  std::string s;
  put_u64(s, req);
  put_u64(s, nbytes);
  s += "shm";  // kinds csv: the domains this sender can open windows of
  return s;
}

static std::string pack_claim_refused(uint64_t req) {
  std::string s;
  put_u64(s, req);
  put_u64(s, 0);
  s.push_back('\0');  // ok = 0
  return s;
}

static std::string pack_claim(uint64_t req, const Lease &lease) {
  std::string s;
  put_u64(s, req);
  put_u64(s, lease.id);
  s.push_back('\x01');                  // ok
  put_u64(s, 0);                        // offset (C regions: base-aligned)
  put_u64(s, lease.cls);                // capacity
  s.append(reinterpret_cast<const char *>(lease.pr->nonce), kNonceBytes);
  s.push_back(lease.standing ? '\x01' : '\0');
  s.push_back('\x03');                  // klen
  s += "shm";
  s += "shm:" + lease.pr->shm.name;     // Python-attachable handle
  return s;
}

static std::string pack_complete(uint64_t lease_id, uint64_t nbytes,
                                 uint8_t flags) {
  std::string s;
  put_u64(s, lease_id);
  put_u64(s, nbytes);
  s.push_back((char)flags);
  return s;
}

static std::string pack_release(uint64_t lease_id, uint64_t req) {
  std::string s;
  put_u64(s, lease_id);
  put_u64(s, req);
  return s;
}

// ---------------------------------------------------------------------------
// Link
// ---------------------------------------------------------------------------

// per-process link ordinal: makes every link's flight tags unique, so the
// per-link protocol machine keys (tag, lease)/(tag, req) never collide
// across links whose lease/req counters both start at 1
static std::atomic<uint64_t> g_link_ord{1};

Link::Link(const char *name) : name_(name ? name : "") {
  if (tpr_obs::enabled()) {
    uint64_t ord = g_link_ord.fetch_add(1, std::memory_order_relaxed);
    char tb[44];
    snprintf(tb, sizeof tb, "nrdv:%s#%llu", name_.c_str(),
             (unsigned long long)ord);
    otag_rdv_ = tpr_obs::tag_for(tb);
    snprintf(tb, sizeof tb, "nctrl:%s#%llu", name_.c_str(),
             (unsigned long long)ord);
    otag_ctrl_ = tpr_obs::tag_for(tb);
  }
  if (!enabled() || !ctrl_enabled()) return;
  // consumer-owned receive ring, advertised in our hello
  uint32_t nslots = ctrl_slots();
  size_t nbytes = kCtrlHdrBytes + (size_t)nslots * kCtrlSlotBytes;
  if (!rx_.shm.create(nbytes)) return;
  rx_.nslots = nslots;
  fill_nonce(rx_.nonce);
  uint8_t *b = rx_.shm.base;
  memcpy(b + 0, &kCtrlMagic, 4);
  uint32_t ver = kCtrlVersion, sb = kCtrlSlotBytes;
  memcpy(b + 4, &ver, 4);
  memcpy(b + 8, &nslots, 4);
  memcpy(b + 12, &sb, 4);
  // cons_head = 0 (fresh region is zeroed); parked = 1: nobody polls
  // until a dispatch loop adopts us (the producer kicks the first record)
  uint32_t parked = 1;
  memcpy(b + kParkedOff, &parked, 4);
  memcpy(b + kCtrlNonceOff, rx_.nonce, kNonceBytes);
  rx_inited_ = true;
}

Link::~Link() { close(); }

std::string Link::hello_payload() {
  std::string s(kHelloPayload, kHelloPayloadLen);
  if (!rx_inited_ || !ctrl_enabled()) return s;
  // _BLOB_LEN + _DESC(nslots, slot_bytes, nbytes, nonce, klen) + kind + handle
  std::string desc;
  put_u32s(desc, rx_.nslots);
  put_u32s(desc, kCtrlSlotBytes);
  put_u64(desc, (uint64_t)rx_.shm.len);
  desc.append(reinterpret_cast<const char *>(rx_.nonce), kNonceBytes);
  desc.push_back('\x03');
  desc += "shm";
  desc += "shm:" + rx_.shm.name;
  put_u16s(s, (uint16_t)desc.size());
  s += desc;
  return s;
}

bool Link::maybe_hello(const uint8_t *payload, size_t len) {
  if (len < kHelloPayloadLen ||
      memcmp(payload, kHelloPayload, kHelloPayloadLen) != 0)
    return false;
  negotiated.store(true);
  // trailing blob: the peer's receive-ring descriptor
  const uint8_t *blob = payload + kHelloPayloadLen;
  size_t blen = len - kHelloPayloadLen;
  if (blen < 2 + 33 || !ctrl_enabled() || ctrl_tx_open_.load()) return true;
  uint16_t dlen = rd_u16(blob);
  if ((size_t)dlen + 2 > blen) return true;
  const uint8_t *d = blob + 2;
  uint32_t nslots = rd_u32(d);
  uint32_t slot_bytes = rd_u32(d + 4);
  uint64_t nbytes = rd_u64(d + 8);
  uint8_t nonce[kNonceBytes];
  memcpy(nonce, d + 16, kNonceBytes);
  uint8_t klen = d[32];
  if (slot_bytes != kCtrlSlotBytes || nslots == 0 ||
      33u + klen >= dlen || nbytes > (64u << 20))
    return true;
  std::string kind(reinterpret_cast<const char *>(d + 33), klen);
  std::string handle(reinterpret_cast<const char *>(d + 33 + klen),
                     dlen - 33 - klen);
  if (kind != "shm" || handle.rfind("shm:", 0) != 0) return true;
  std::lock_guard<std::mutex> lk(tx_mu_);
  if (ctrl_tx_open_.load() || closed_.load()) return true;
  if (!tx_.shm.open(handle.substr(4), nbytes)) return true;
  // verify the descriptor resolves to the advertised memory
  uint8_t *b = tx_.shm.base;
  if (rd_u32(b) != kCtrlMagic || rd_u32(b + 4) != kCtrlVersion ||
      rd_u32(b + 8) != nslots || rd_u32(b + 12) != kCtrlSlotBytes ||
      memcmp(b + kCtrlNonceOff, nonce, kNonceBytes) != 0) {
    tx_.shm.close();
    return true;
  }
  tx_.nslots = nslots;
  tx_.seq = 0;
  ctrl_tx_open_.store(true);
  obs_adopted_.store(true, std::memory_order_relaxed);
  TPR_OBS(tpr_obs::kEvCtrlAdopt, otag_ctrl_, nslots, kCtrlSlotBytes);
  return true;
}

// -- control send ------------------------------------------------------------

void Link::ctrl_send(uint8_t op, uint32_t sid, const std::string &payload,
                     bool ring_ok) {
  if (ring_ok && ctrl_tx_open_.load() &&
      payload.size() <= kMaxCtrlPayload) {
    int r = 0;
    {
      std::lock_guard<std::mutex> lk(tx_mu_);
      if (ctrl_tx_open_.load()) {
        uint8_t *b = tx_.shm.base;
        uint64_t head = __atomic_load_n(
            reinterpret_cast<uint64_t *>(b + kConsHeadOff),
            __ATOMIC_ACQUIRE);
        if (tx_.seq - head >= tx_.nslots) {
          if (!tx_.stalled) {
            tx_.stalled = true;  // full: degrade framed, never overwrite
            TPR_OBS(tpr_obs::kEvCtrlStallBegin, otag_ctrl_,
                    tx_.seq - head, 0);
          }
        } else {
          if (tx_.stalled) {
            tx_.stalled = false;
            TPR_OBS(tpr_obs::kEvCtrlStallEnd, otag_ctrl_, 0, 0);
          }
          uint8_t *slot = b + kCtrlHdrBytes +
                          (tx_.seq % tx_.nslots) * kCtrlSlotBytes;
          // payload and fields FIRST...
          memcpy(slot + kCtrlSlotHdrBytes, payload.data(), payload.size());
          uint64_t fseq = frames_sent.load(std::memory_order_relaxed);
          memcpy(slot + 8, &fseq, 8);
          memcpy(slot + 16, &sid, 4);
          uint16_t ln = (uint16_t)payload.size();
          memcpy(slot + 20, &ln, 2);
          slot[22] = op;
          slot[23] = 0;
          // ...the stamp LAST (release): a consumer that observes it
          // observes a whole record
          __atomic_store_n(reinterpret_cast<uint64_t *>(slot),
                           tx_.seq + 1, __ATOMIC_RELEASE);
          tx_.seq++;
          // parked is read strictly AFTER the stamp store (the seq_cst
          // fence forbids the StoreLoad reorder): either the consumer's
          // park-then-redrain sees our record, or we see its parked flag
          // and kick — the lost-wakeup race has no third leg
          __atomic_thread_fence(__ATOMIC_SEQ_CST);
          uint32_t parked = __atomic_load_n(
              reinterpret_cast<uint32_t *>(b + kParkedOff),
              __ATOMIC_RELAXED);
          r = parked ? 2 : 1;
        }
      }
    }
    if (r) {
      RDV_DBG("ctrl_send op=%u sid=%u ring r=%d fseq=%llu", op, sid, r,
              (unsigned long long)frames_sent.load());
      count(kCtrCtrlPosts);
      tpr_obs::metric_add(tpr_obs::kMetCtrlPosts);
      if (r == 2) ctrl_kick();
      return;
    }
  }
  // framed fallback: one control frame (type = op + 7)
  RDV_DBG("ctrl_send op=%u sid=%u FRAMED (tx_open=%d len=%zu)", op, sid,
          (int)ctrl_tx_open_.load(), payload.size());
  count(kCtrCtrlFrames);
  tpr_obs::metric_add(tpr_obs::kMetCtrlFrames);
  if (send_frame) send_frame((uint8_t)(op + 7), sid, payload);
}

void Link::ctrl_kick() {
  count(kCtrCtrlKicks);
  tpr_obs::metric_add(tpr_obs::kMetCtrlKicks);
  if (send_frame) send_frame(12 /* kCtrlKick */, 0, std::string());
}

// -- ctrl consumer -----------------------------------------------------------

int Link::ctrl_drain() {
  if (!rx_inited_) return 0;
  // test seam (native_rdv_smoke's frozen-consumer stall): records age in
  // the ring, the Python producer's backlog gauge feeds the watchdog
  if (getenv("TPURPC_TEST_FREEZE_NCTRL")) return 0;
  if (!rx_mu_.try_lock()) return 0;
  int n = 0;
  uint8_t *b = rx_.shm.base;
  for (;;) {
    uint8_t *slot = b + kCtrlHdrBytes +
                    (rx_.head % rx_.nslots) * kCtrlSlotBytes;
    // stamp first, acquire: pairs with the producer's release store so
    // the field/payload reads below see a whole record
    uint64_t stamp = __atomic_load_n(reinterpret_cast<uint64_t *>(slot),
                                     __ATOMIC_ACQUIRE);
    if (stamp != rx_.head + 1) break;
    uint64_t fseq = rd_u64(slot + 8);
    if (fseq > frames_dispatched.load(std::memory_order_acquire)) {
      RDV_DBG("drain DEFER fseq=%llu dispatched=%llu head=%llu",
              (unsigned long long)fseq,
              (unsigned long long)frames_dispatched.load(),
              (unsigned long long)rx_.head);
      break;  // ordered after frames still in flight
    }
    uint32_t sid = rd_u32(slot + 16);
    uint16_t ln = rd_u16(slot + 20);
    uint8_t op = slot[22];
    uint8_t payload[kMaxCtrlPayload];
    if (ln > kMaxCtrlPayload) ln = kMaxCtrlPayload;
    memcpy(payload, slot + kCtrlSlotHdrBytes, ln);
    rx_.head++;
    on_op(op, sid, payload, ln);
    ++n;
  }
  uint64_t head_now = rx_.head;
  if (n) {
    // ONE cons_head publish per drained batch (release: our payload
    // reads can't sink past the producer's licence to reuse the slots)
    __atomic_store_n(reinterpret_cast<uint64_t *>(b + kConsHeadOff),
                     (uint64_t)rx_.head, __ATOMIC_RELEASE);
  }
  rx_mu_.unlock();
  if (n) {
    count(kCtrCtrlRecords, (uint64_t)n);
    tpr_obs::metric_add(tpr_obs::kMetCtrlDrainBatches);
    tpr_obs::metric_add(tpr_obs::kMetCtrlDrainRecords, (uint64_t)n);
    std::lock_guard<std::mutex> lk(ewma_mu_);
    ewma_ = ewma_ + 0.5 * (1.0 - ewma_);  // _EWMA_HIT
    if (!mode_hot_) {
      mode_hot_ = true;
      uint32_t v = 0;
      __atomic_store_n(reinterpret_cast<uint32_t *>(b + kParkedOff), v,
                       __ATOMIC_RELEASE);
      if (obs_adopted_.load(std::memory_order_relaxed))
        TPR_OBS(tpr_obs::kEvCtrlSpin, otag_ctrl_, head_now, 0);
    }
  }
  return n;
}

bool Link::ctrl_hot() {
  std::lock_guard<std::mutex> lk(ewma_mu_);
  return mode_hot_;
}

void Link::ctrl_decay() {
  std::lock_guard<std::mutex> lk(ewma_mu_);
  ewma_ *= 0.7;  // _EWMA_MISS
  if (ewma_ < 0.1) mode_hot_ = false;
}

void Link::ctrl_park() {
  if (!rx_inited_) return;
  bool was_hot;
  {
    std::lock_guard<std::mutex> lk(ewma_mu_);
    was_hot = mode_hot_;
    mode_hot_ = false;
  }
  if (was_hot && obs_adopted_.load(std::memory_order_relaxed)) {
    uint64_t h;
    {
      std::lock_guard<std::mutex> lk(rx_mu_);
      h = rx_.head;
    }
    TPR_OBS(tpr_obs::kEvCtrlPark, otag_ctrl_, h, 0);
  }
  uint32_t v = 1;
  __atomic_store_n(reinterpret_cast<uint32_t *>(rx_.shm.base + kParkedOff),
                   v, __ATOMIC_RELEASE);
  // the mandatory re-drain: ordered AFTER the parked store (seq_cst
  // fence) so a record stamped concurrently is either seen here or its
  // producer sees parked=1 and kicks
  __atomic_thread_fence(__ATOMIC_SEQ_CST);
  ctrl_drain();
}

// -- dispatch ----------------------------------------------------------------

bool Link::on_frame(uint8_t type, uint32_t sid, const uint8_t *p,
                    size_t len) {
  if (type >= 8 && type <= 11) {
    on_op((uint8_t)(type - 7), sid, p, len);
    return true;
  }
  if (type == 12) {  // CTRL_KICK: the wake is the fd readiness itself
    ctrl_drain();
    return true;
  }
  return false;
}

void Link::on_op(uint8_t op, uint32_t sid, const uint8_t *p, size_t len) {
  switch (op) {
    case kOpOffer:
      on_offer(sid, p, len);
      break;
    case kOpClaim:
      on_claim(p, len);
      break;
    case kOpComplete:
      on_complete(sid, p, len);
      break;
    case kOpRelease:
      on_release(p, len);
      break;
    default:
      break;  // malformed control degrades, never kills the connection
  }
}

// -- sender role -------------------------------------------------------------

void Link::set_dispatch_thread() { dispatch_tid_.store(self_tid()); }

bool Link::eligible(size_t total) const {
  return negotiated.load() && !closed_.load() && enabled() &&
         total >= min_bytes() && total <= kMaxTransfer &&
         self_tid() != dispatch_tid_.load();
}

uint8_t *Link::window_base(const std::string &handle, size_t nbytes) {
  if (handle.rfind("shm:", 0) != 0) return nullptr;
  std::lock_guard<std::mutex> lk(mu_);
  if (closed_.load()) return nullptr;
  auto it = windows_.find(handle);
  if (it != windows_.end()) return it->second.base;
  tpr_ring::ShmRegion win;
  if (!win.open(handle.substr(4), nbytes)) return nullptr;
  uint8_t *base = win.base;
  windows_.emplace(handle, win);
  return base;
}

bool Link::pin_windows() {
  window_pins_.fetch_add(1, std::memory_order_seq_cst);
  if (closed_.load(std::memory_order_seq_cst)) {
    window_pins_.fetch_sub(1, std::memory_order_seq_cst);
    return false;
  }
  return true;
}

void Link::unpin_windows() {
  window_pins_.fetch_sub(1, std::memory_order_seq_cst);
}

bool Link::standing_free(const std::shared_ptr<Claim> &c) {
  if (!pin_windows()) return false;
  uint8_t *base = window_base(
      c->handle, c->offset + c->capacity + kNonceBytes + 8);
  bool free_now = false;
  if (base) {
    uint64_t freed = __atomic_load_n(
        reinterpret_cast<uint64_t *>(base + c->offset + c->capacity +
                                     kNonceBytes),
        __ATOMIC_ACQUIRE);
    free_now = freed == c->used;
  }
  unpin_windows();
  return free_now;
}

std::shared_ptr<Claim> Link::take_grant(uint64_t cls, size_t total) {
  std::vector<std::shared_ptr<Claim>> bucket;
  {
    std::lock_guard<std::mutex> lk(mu_);
    if (closed_.load()) return nullptr;
    auto it = grants_.find(cls);
    if (it != grants_.end()) bucket = it->second;
  }
  for (auto &c : bucket) {
    if (c->capacity < total) continue;
    if (!c->standing) {
      std::lock_guard<std::mutex> lk(mu_);
      auto it = grants_.find(cls);
      if (it != grants_.end()) {
        auto pos = std::find(it->second.begin(), it->second.end(), c);
        if (pos != it->second.end()) {
          it->second.erase(pos);
          return c;  // one-shot: consumed
        }
      }
      continue;
    }
    {
      std::lock_guard<std::mutex> lk(mu_);
      if (c->inflight) continue;
      c->inflight = true;
    }
    if (standing_free(c)) return c;
    std::lock_guard<std::mutex> lk(mu_);
    c->inflight = false;
  }
  return nullptr;
}

bool Link::has_standing(uint64_t cls, size_t total) {
  std::lock_guard<std::mutex> lk(mu_);
  auto it = grants_.find(cls);
  if (it == grants_.end()) return false;
  for (auto &c : it->second)
    if (c->standing && c->capacity >= total) return true;
  return false;
}

void Link::drop_grant(const std::shared_ptr<Claim> &c) {
  std::lock_guard<std::mutex> lk(mu_);
  c->inflight = false;
  auto it = grants_.find(size_class(c->capacity));
  if (it != grants_.end()) {
    auto pos = std::find(it->second.begin(), it->second.end(), c);
    if (pos != it->second.end()) it->second.erase(pos);
  }
}

std::shared_ptr<Claim> Link::rdv_claim(uint32_t sid, size_t total,
                                       uint64_t cls) {
  (void)cls;
  uint64_t req;
  auto pr = std::make_shared<PendingReq>();
  {
    std::lock_guard<std::mutex> lk(mu_);
    if (closed_.load()) return nullptr;
    req = next_req_++;
    reqs_[req] = pr;
  }
  RDV_DBG("rdv_claim OFFER req=%llu total=%zu", (unsigned long long)req,
          total);
  TPR_OBS(tpr_obs::kEvRdvOffer, otag_rdv_, req, total);
  tpr_obs::metric_add(tpr_obs::kMetRdvWaits);
  uint64_t wait_t0 = tpr_obs::now_ns();
  ctrl_send(kOpOffer, sid, pack_offer(req, total));
  auto dl = std::chrono::steady_clock::now() +
            std::chrono::duration_cast<std::chrono::steady_clock::duration>(
                std::chrono::duration<double>(claim_timeout_s()));
  if (pump) {
    // inline-pump transports: the waiting sender drives the reader itself
    pump([&] {
      std::lock_guard<std::mutex> lk(mu_);
      return pr->state != 0 || closed_.load();
    }, dl);
  } else {
    std::unique_lock<std::mutex> lk(mu_);
    cv_.wait_until(lk, dl,
                   [&] { return pr->state != 0 || closed_.load(); });
  }
  int state;
  std::shared_ptr<Claim> claim;
  {
    std::lock_guard<std::mutex> lk(mu_);
    reqs_.erase(req);
    state = pr->state;
    claim = pr->claim;
  }
  tpr_obs::metric_add(tpr_obs::kMetRdvWaitNs,
                      tpr_obs::now_ns() - wait_t0);
  if (state == 0) {
    RDV_DBG("rdv_claim TIMEOUT req=%llu", (unsigned long long)req);
    // timed out: abandon the offer — a claim crossing this release finds
    // no pending request and is released by on_claim's unknown-req path
    TPR_OBS(tpr_obs::kEvRdvRelease, otag_rdv_, 0, req);
    ctrl_send(kOpRelease, 0, pack_release(0, req));
    return nullptr;
  }
  if (state == 1 && claim)
    TPR_OBS(tpr_obs::kEvRdvClaim, otag_rdv_, req, claim->lease_id);
  return state == 1 ? claim : nullptr;
}

bool Link::rdv_write(const std::shared_ptr<Claim> &c, const uint8_t *data,
                     size_t total) {
  // pinned for the whole deref span: the bulk memcpy runs without mu_, and
  // a concurrent close() (transport death seen by the pumping thread)
  // would otherwise munmap the window mid-copy — observed as a SEGV, or
  // worse, a silent 1 MiB scribble over whatever mapping reused the range
  if (!pin_windows()) return false;
  bool ok = false;
  uint8_t *base = window_base(
      c->handle, c->offset + c->capacity + kNonceBytes + 8);
  // anti-mixup nonce: the claimed handle must resolve to the memory the
  // receiver advertised, never a recycled name
  if (base != nullptr &&
      memcmp(base + c->offset + c->capacity, c->nonce, kNonceBytes) == 0) {
    if (tpr_obs::enabled()) {
      uint64_t t0 = tpr_obs::now_ns();
      memcpy(base + c->offset, data, total);  // the one-sided placement
      tpr_obs::metric_add(tpr_obs::kMetRdvSendBusyNs,
                          tpr_obs::now_ns() - t0);
      tpr_obs::metric_add(tpr_obs::kMetRdvSendBytes, total);
    } else {
      memcpy(base + c->offset, data, total);  // the one-sided placement
    }
    count(kCtrRdvBytesSent, total);
    ok = true;
  }
  unpin_windows();
  return ok;
}

void Link::rdv_complete(const std::shared_ptr<Claim> &c, uint32_t sid,
                        uint8_t flags, size_t total) {
  {
    std::lock_guard<std::mutex> lk(mu_);
    c->used++;
    c->inflight = false;
  }
  if (!c->standing) {
    // solicited transfers are edges worth recording; standing-region
    // reuse is steady-state traffic and stays silent (the flight
    // recorder's edges-not-traffic contract — rendezvous.py's rule)
    TPR_OBS(tpr_obs::kEvRdvWrite, otag_rdv_, c->lease_id, total);
    TPR_OBS(tpr_obs::kEvRdvComplete, otag_rdv_, c->lease_id, total);
  }
  // shm windows are synchronous (the memcpy returned ⇒ bytes visible), so
  // the COMPLETE may ride the ring
  ctrl_send(kOpComplete, sid, pack_complete(c->lease_id, total, flags));
}

void Link::rdv_release(const std::shared_ptr<Claim> &c) {
  TPR_OBS(tpr_obs::kEvRdvRelease, otag_rdv_, c->lease_id, 0);
  ctrl_send(kOpRelease, 0, pack_release(c->lease_id, 0));
}

bool Link::send_message(uint32_t sid, uint8_t flags, const uint8_t *data,
                        size_t total) {
  uint64_t cls = size_class(total);
  auto claim = take_grant(cls, total);
  if (!claim && has_standing(cls, total)) {
    // every standing region's doorbell is behind — the consumer is
    // mid-batch. A bounded yield-poll (draining our ctrl ring for
    // pregrant top-ups as we go) almost always turns up a freed region
    // in a few slices, cheaper than a solicited-claim round trip.
    auto dl = std::chrono::steady_clock::now() +
              std::chrono::milliseconds(2);
    while (!claim && std::chrono::steady_clock::now() < dl) {
      ctrl_drain();
      sched_yield();
      claim = take_grant(cls, total);
    }
  }
  if (!claim) claim = rdv_claim(sid, total, cls);
  if (!claim) {
    count(kCtrRdvFallback);
    tpr_obs::metric_add(tpr_obs::kMetRdvFallbacks);
    TPR_OBS(tpr_obs::kEvRdvFallback, otag_rdv_, total, 0);
    return false;
  }
  if (!rdv_write(claim, data, total)) {
    drop_grant(claim);
    rdv_release(claim);
    count(kCtrRdvFallback);
    tpr_obs::metric_add(tpr_obs::kMetRdvFallbacks);
    TPR_OBS(tpr_obs::kEvRdvFallback, otag_rdv_, total, 1);
    return false;
  }
  rdv_complete(claim, sid, flags, total);
  count(kCtrRdvSent);
  return true;
}

// -- receiver role -----------------------------------------------------------

void Link::on_offer(uint32_t sid, const uint8_t *p, size_t len) {
  if (len < 16) return;
  uint64_t req = rd_u64(p);
  uint64_t nbytes = rd_u64(p + 8);
  TPR_OBS(tpr_obs::kEvRdvOffer, otag_rdv_, req, nbytes);
  std::string kinds(reinterpret_cast<const char *>(p + 16), len - 16);
  bool shm_ok = false;
  size_t pos = 0;
  while (pos <= kinds.size()) {
    size_t comma = kinds.find(',', pos);
    std::string k = kinds.substr(
        pos, comma == std::string::npos ? std::string::npos : comma - pos);
    if (k == "shm") shm_ok = true;
    if (comma == std::string::npos) break;
    pos = comma + 1;
  }
  std::shared_ptr<Lease> lease;
  if (shm_ok && enabled() && nbytes <= kMaxTransfer && !closed_.load()) {
    PoolRegion *pr = Pool::inst().lease(size_class(nbytes));
    if (pr) {
      lease = std::make_shared<Lease>();
      lease->pr = pr;
      lease->cls = pr->cls;
    }
  }
  if (!lease) {
    count(kCtrRdvRefused);
    ctrl_send(kOpClaim, sid, pack_claim_refused(req));
    return;
  }
  {
    std::lock_guard<std::mutex> lk(mu_);
    if (closed_.load()) {
      lease->release(false);
      return;
    }
    lease->id = next_lease_++;
    leases_[lease->id] = lease;
    req_lease_[req] = lease->id;
  }
  RDV_DBG("on_offer req=%llu -> CLAIM lease=%llu cls=%llu standing=%d",
          (unsigned long long)req, (unsigned long long)lease->id,
          (unsigned long long)lease->cls, (int)lease->standing);
  TPR_OBS(tpr_obs::kEvRdvClaim, otag_rdv_, req, lease->id);
  ctrl_send(kOpClaim, sid, pack_claim(req, *lease));
}

void Link::on_claim(const uint8_t *p, size_t len) {
  if (len < 17) return;
  uint64_t req = rd_u64(p);
  uint64_t lease_id = rd_u64(p + 8);
  uint8_t ok = p[16];
  RDV_DBG("on_claim req=%llu lease=%llu ok=%d",
          (unsigned long long)req, (unsigned long long)lease_id, (int)ok);
  std::shared_ptr<Claim> claim;
  if (ok) {
    // _CLAIM_REG: offset, capacity, nonce, standing; then klen, kind, handle
    if (len < 17 + 33 + 1) return;
    claim = std::make_shared<Claim>();
    claim->lease_id = lease_id;
    claim->offset = rd_u64(p + 17);
    claim->capacity = rd_u64(p + 25);
    memcpy(claim->nonce, p + 33, kNonceBytes);
    claim->standing = p[49] != 0;
    uint8_t klen = p[50];
    if (51u + klen > len) return;
    claim->kind.assign(reinterpret_cast<const char *>(p + 51), klen);
    claim->handle.assign(reinterpret_cast<const char *>(p + 51 + klen),
                         len - 51 - klen);
    if (claim->kind != "shm" || claim->capacity == 0 ||
        claim->capacity > kMaxTransfer)
      return;
  }
  if (req == 0) {
    // unsolicited pre-grant: cache for the next same-class send
    if (claim) {
      std::lock_guard<std::mutex> lk(mu_);
      if (!closed_.load())
        grants_[claim->capacity].push_back(claim);
    }
    return;
  }
  {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = reqs_.find(req);
    if (it != reqs_.end()) {
      it->second->state = claim ? 1 : 2;
      it->second->claim = claim;
      cv_.notify_all();
      claim = nullptr;  // ownership passed to the waiter
    }
  }
  if (wake) wake();
  // the sender already gave up (timeout crossed the claim on the wire):
  // hand the region straight back
  if (claim) ctrl_send(kOpRelease, 0, pack_release(claim->lease_id, 0));
}

void Link::on_complete(uint32_t sid, const uint8_t *p, size_t len) {
  if (len < 17) return;
  uint64_t lease_id = rd_u64(p);
  uint64_t nbytes = rd_u64(p + 8);
  uint8_t flags = p[16];
  RDV_DBG("on_complete lease=%llu nbytes=%llu",
          (unsigned long long)lease_id, (unsigned long long)nbytes);
  std::shared_ptr<Lease> lease;
  {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = leases_.find(lease_id);
    if (it == leases_.end()) return;  // crossed a release — drop
    lease = it->second;
    if (!lease->standing) {
      // one-shot lease: consumed by this completion; standing leases
      // stay claimed (the doorbell carries further reuse)
      leases_.erase(it);
      for (auto r = req_lease_.begin(); r != req_lease_.end();) {
        if (r->second == lease_id)
          r = req_lease_.erase(r);
        else
          ++r;
      }
    }
  }
  uint64_t gen = 0;
  bool violation = false;
  {
    std::lock_guard<std::mutex> lg(lease->mu);
    if (lease->retired || (lease->delivered && !lease->standing) ||
        nbytes > lease->cls ||
        (lease->standing && lease->delivered != lease->freed)) {
      // oversized complete, or reuse while the previous delivery is
      // still aliased — refuse rather than hand out a second alias
      violation = true;
    } else {
      lease->delivered++;
      gen = lease->delivered;
    }
  }
  if (violation) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      leases_.erase(lease_id);
      if (lease->pregrant) {
        auto pg = pregrants_out_.find(lease->cls);
        if (pg != pregrants_out_.end() && pg->second > 0) pg->second--;
      }
    }
    lease->release(true);  // a confused sender may write again: discard
    return;
  }
  uint8_t *base = lease->pr->shm.base;
  {
    std::lock_guard<std::mutex> lk(g_settle_mu);
    g_settle[base] = SettleEntry{lease, gen};
  }
  count(kCtrRdvRecv);
  count(kCtrRdvBytesRecv, nbytes);
  if (!lease->pregrant)
    TPR_OBS(tpr_obs::kEvRdvComplete, otag_rdv_, lease_id, nbytes);
  uint64_t cls = lease->cls;
  if (deliver) {
    if (tpr_obs::enabled()) {
      uint64_t t0 = tpr_obs::now_ns();
      deliver(sid, flags, base, (size_t)nbytes);
      tpr_obs::metric_add(tpr_obs::kMetRdvRecvBusyNs,
                          tpr_obs::now_ns() - t0);
      tpr_obs::metric_add(tpr_obs::kMetRdvRecvBytes, nbytes);
    } else {
      deliver(sid, flags, base, (size_t)nbytes);
    }
  } else {
    settle(base);  // no consumer wired: drop, ring the doorbell
  }
  maybe_pregrant(cls);
}

void Link::maybe_pregrant(uint64_t cls) {
  // RDMAbox discipline: keep STANDING regions granted for the classes the
  // peer is actively streaming, topped up to kPregrantDepth — a standing
  // grant costs one claim frame EVER; reuse rides the doorbell word.
  for (;;) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      if (closed_.load() || pregrants_out_[cls] >= kPregrantDepth) return;
    }
    PoolRegion *pr = Pool::inst().lease(cls);
    if (!pr) return;
    auto lease = std::make_shared<Lease>();
    lease->pr = pr;
    lease->cls = cls;
    lease->standing = true;
    lease->pregrant = true;
    {
      std::lock_guard<std::mutex> lk(mu_);
      if (closed_.load()) {
        lease->release(false);
        return;
      }
      lease->id = next_lease_++;
      leases_[lease->id] = lease;
      pregrants_out_[cls]++;
    }
    count(kCtrPregrants);
    ctrl_send(kOpClaim, 0, pack_claim(0, *lease));
  }
}

void Link::on_release(const uint8_t *p, size_t len) {
  if (len < 16) return;
  uint64_t lease_id = rd_u64(p);
  uint64_t req = rd_u64(p + 8);
  std::shared_ptr<Lease> lease;
  {
    std::lock_guard<std::mutex> lk(mu_);
    if (!lease_id && req) {
      auto it = req_lease_.find(req);
      if (it != req_lease_.end()) {
        lease_id = it->second;
        req_lease_.erase(it);
      }
    }
    auto it = leases_.find(lease_id);
    if (it != leases_.end()) {
      lease = it->second;
      leases_.erase(it);
      if (lease->pregrant) {
        auto pg = pregrants_out_.find(lease->cls);
        if (pg != pregrants_out_.end() && pg->second > 0) pg->second--;
      }
    }
  }
  if (lease) {
    TPR_OBS(tpr_obs::kEvRdvRelease, otag_rdv_, lease_id, req);
    lease->release(false);
  }
}

// -- lifecycle ---------------------------------------------------------------

void Link::close() {
  std::vector<std::shared_ptr<Lease>> leases;
  std::vector<tpr_ring::ShmRegion> wins;
  {
    std::lock_guard<std::mutex> lk(mu_);
    if (closed_.exchange(true)) return;
    for (auto &kv : leases_) leases.push_back(kv.second);
    leases_.clear();
    req_lease_.clear();
    pregrants_out_.clear();
    grants_.clear();
    for (auto &kv : windows_) wins.push_back(kv.second);
    windows_.clear();
    cv_.notify_all();
  }
  if (wake) wake();
  for (auto &lease : leases) {
    // DISCARD, don't pool: the peer (or a straggling sender on this
    // dying connection) may still hold a window and land a late write —
    // it must hit orphaned memory, never a re-leased region; teardown is
    // an EDGE (once per connection death), so every claimed region's
    // release is recorded — standing grants included
    TPR_OBS(tpr_obs::kEvRdvRelease, otag_rdv_, lease->id, 0);
    lease->release(true);
  }
  // Straggling senders may still be inside rdv_write's memcpy with a raw
  // window pointer (pinned): wait for every pin to drain before the
  // munmap. Bounded — a pin only spans a memcpy or one doorbell load.
  int pins = window_pins_.load(std::memory_order_seq_cst);
  if (pins != 0) {
    uint64_t t0 = tpr_obs::now_ns();
    TPR_OBS(tpr_obs::kEvPinWaitBegin, otag_rdv_, pins, 0);
    tpr_obs::metric_add(tpr_obs::kMetPinWaits);
    while (window_pins_.load(std::memory_order_seq_cst) != 0)
      std::this_thread::sleep_for(std::chrono::milliseconds(1));
    uint64_t waited = tpr_obs::now_ns() - t0;
    tpr_obs::metric_add(tpr_obs::kMetPinWaitNs, waited);
    TPR_OBS(tpr_obs::kEvPinWaitEnd, otag_rdv_, waited, 0);
  }
  for (auto &w : wins) w.close();
  {
    std::lock_guard<std::mutex> lk(tx_mu_);
    if (ctrl_tx_open_.exchange(false)) tx_.shm.close();
  }
  {
    std::lock_guard<std::mutex> lk(rx_mu_);
    if (rx_inited_) {
      rx_inited_ = false;
      rx_.shm.close();  // a late producer store hits the orphaned mapping
    }
  }
}

}  // namespace tpr_rdv

// -- C ABI: the process-wide ledger the shim and tests read ------------------

extern "C" {

void tpr_rdv_counters(uint64_t *out, int n) {
  for (int i = 0; i < n && i < tpr_rdv::kNumCounters; i++)
    out[i] = tpr_rdv::g_counters[i].load(std::memory_order_relaxed);
}

void tpr_rdv_counters_reset(void) {
  for (auto &c : tpr_rdv::g_counters) c.store(0, std::memory_order_relaxed);
}

}  // extern "C"
