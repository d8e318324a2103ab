// tpurpc-xray: shm flight ring + metrics table (layout and protocol in
// tpr_obs.h; the Python-side decoder is tpurpc_torch/obs/native_obs.py).
#include "tpr_obs.h"

#include <pthread.h>
#include <sched.h>
#include <string.h>
#include <time.h>

#include <mutex>

#include "ring_transport.h"

namespace tpr_obs {

namespace {

bool env_off(const char *name) {
  const char *v = getenv(name);
  if (!v) return false;
  return strcmp(v, "0") == 0 || strcasecmp(v, "off") == 0 ||
         strcasecmp(v, "false") == 0;
}

uint32_t ring_capacity() {
  const char *v = getenv("TPURPC_NATIVE_OBS_BUFFER");
  if (v && *v) {
    char *end = nullptr;
    unsigned long n = strtoul(v, &end, 10);
    if (end != v && n >= 64) return (uint32_t)n;
  }
  return 4096;
}

struct State {
  tpr_ring::ShmRegion shm;
  uint32_t capacity = 0;
  uint64_t *ticket = nullptr;    // header word
  uint32_t *tag_count = nullptr; // header word
  uint64_t *metrics = nullptr;
  uint8_t *tags = nullptr;
  uint64_t *seq = nullptr;
  uint64_t *recs = nullptr;      // capacity * 4 words
};

std::mutex g_init_mu;   // init / intern / reset only — never on emit
State *g_state = nullptr;  // set once under g_init_mu, read lock-free
bool g_init_done = false;

State *build_state() {
  uint32_t cap = ring_capacity();
  uint32_t metrics_off = kHdrBytes;
  uint32_t tags_off = metrics_off + (uint32_t)kNumMetrics * 8;
  uint32_t seq_off = tags_off + kTagCap * kTagBytes;
  uint32_t rec_off = seq_off + cap * 8;
  size_t nbytes = (size_t)rec_off + (size_t)cap * kRecordBytes;
  State *st = new State();
  if (!st->shm.create(nbytes)) {
    delete st;
    return nullptr;
  }
  uint8_t *b = st->shm.base;
  uint32_t ver = kObsVersion, tag_cap = kTagCap,
           nmet = (uint32_t)kNumMetrics, rb = kRecordBytes,
           magic = kObsMagic;
  memcpy(b + kHdrMagic, &magic, 4);
  memcpy(b + kHdrVersion, &ver, 4);
  memcpy(b + kHdrCapacity, &cap, 4);
  memcpy(b + kHdrTagCap, &tag_cap, 4);
  memcpy(b + kHdrMetricsCap, &nmet, 4);
  memcpy(b + kHdrRecordBytes, &rb, 4);
  memcpy(b + kHdrMetricsOff, &metrics_off, 4);
  memcpy(b + kHdrTagsOff, &tags_off, 4);
  memcpy(b + kHdrSeqOff, &seq_off, 4);
  memcpy(b + kHdrRecOff, &rec_off, 4);
  st->capacity = cap;
  st->ticket = reinterpret_cast<uint64_t *>(b + kHdrTicket);
  st->tag_count = reinterpret_cast<uint32_t *>(b + kHdrTagCount);
  st->metrics = reinterpret_cast<uint64_t *>(b + metrics_off);
  st->tags = b + tags_off;
  st->seq = reinterpret_cast<uint64_t *>(b + seq_off);
  st->recs = reinterpret_cast<uint64_t *>(b + rec_off);
  return st;
}

// Lock-free fast path: after the one guarded init, readers see either
// nullptr (off / failed) or a fully built State through the acquire load.
State *state() {
  if (__atomic_load_n(&g_init_done, __ATOMIC_ACQUIRE))
    return __atomic_load_n(&g_state, __ATOMIC_RELAXED);
  std::lock_guard<std::mutex> lk(g_init_mu);
  if (!g_init_done) {
    if (!env_off("TPURPC_NATIVE_OBS"))
      __atomic_store_n(&g_state, build_state(), __ATOMIC_RELAXED);
    __atomic_store_n(&g_init_done, true, __ATOMIC_RELEASE);
  }
  return g_state;
}

}  // namespace

bool enabled() { return state() != nullptr; }

uint64_t now_ns() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (uint64_t)ts.tv_sec * 1000000000ull + (uint64_t)ts.tv_nsec;
}

uint16_t tag_for(const char *name) {
  State *st = state();
  if (!st || !name) return 0;
  size_t len = strlen(name);
  if (len > kTagBytes - 2) len = kTagBytes - 2;
  std::lock_guard<std::mutex> lk(g_init_mu);
  uint32_t n = __atomic_load_n(st->tag_count, __ATOMIC_RELAXED);
  for (uint32_t i = 0; i < n && i < kTagCap; i++) {
    uint8_t *slot = st->tags + (size_t)i * kTagBytes;
    uint16_t slen;
    memcpy(&slen, slot, 2);
    if (slen == len && memcmp(slot + 2, name, len) == 0)
      return (uint16_t)(i + 1);
  }
  if (n >= kTagCap) {
    metric_add(kMetTagOverflow);
    return 0;  // degrade to the anonymous tag, never an error
  }
  uint8_t *slot = st->tags + (size_t)n * kTagBytes;
  memcpy(slot + 2, name, len);
  uint16_t slen = (uint16_t)len;
  memcpy(slot, &slen, 2);
  // count publishes AFTER the name bytes: a concurrent reader that sees
  // slot i < count sees a whole name
  __atomic_store_n(st->tag_count, n + 1, __ATOMIC_RELEASE);
  return (uint16_t)(n + 1);
}

void emit(uint16_t code, uint16_t tag, int64_t a1, int64_t a2) {
  State *st = state();
  if (!st) return;
  uint64_t ticket = __atomic_fetch_add(st->ticket, 1, __ATOMIC_RELAXED);
  uint32_t slot = (uint32_t)(ticket % st->capacity);
  uint64_t *r = st->recs + (size_t)slot * 4;
  // Claim the slot: wait for the previous-lap tenant (ticket - capacity)
  // to have published. Without this, a writer that lags a FULL ring lap
  // behind a wrapping peer could interleave word stores on the same slot
  // and the later stamp would mask the tear from readers (both stamps are
  // nonzero and stable). The wait only ever fires in that one-lap-behind
  // case — the hot path is a single acquire load that matches.
  uint64_t prev = ticket < st->capacity ? 0 : ticket - st->capacity + 1;
  for (int spins = 0;
       __atomic_load_n(st->seq + slot, __ATOMIC_ACQUIRE) != prev;) {
    if (++spins > 128) sched_yield();
  }
  // seq 0 marks the slot in-progress; a reader that loaded the old stamp
  // and races our word stores fails its recheck
  __atomic_store_n(st->seq + slot, 0, __ATOMIC_RELEASE);
  uint64_t w1 = (uint64_t)code | ((uint64_t)tag << 16) |
                ((uint64_t)(uint32_t)(unsigned long)pthread_self() << 32);
  __atomic_store_n(r + 0, now_ns(), __ATOMIC_RELAXED);
  __atomic_store_n(r + 1, w1, __ATOMIC_RELAXED);
  __atomic_store_n(r + 2, (uint64_t)a1, __ATOMIC_RELAXED);
  __atomic_store_n(r + 3, (uint64_t)a2, __ATOMIC_RELAXED);
  __atomic_store_n(st->seq + slot, ticket + 1, __ATOMIC_RELEASE);
  __atomic_fetch_add(st->metrics + kMetEmitted, 1, __ATOMIC_RELAXED);
}

void metric_add(MetricIdx i, uint64_t n) {
  State *st = state();
  if (!st) return;
  __atomic_fetch_add(st->metrics + i, n, __ATOMIC_RELAXED);
}

void metric_store(MetricIdx i, uint64_t v) {
  State *st = state();
  if (!st) return;
  __atomic_store_n(st->metrics + i, v, __ATOMIC_RELAXED);
}

uint64_t metric_get(MetricIdx i) {
  State *st = state();
  if (!st) return 0;
  return __atomic_load_n(st->metrics + i, __ATOMIC_RELAXED);
}

}  // namespace tpr_obs

// -- C ABI -------------------------------------------------------------------

using tpr_obs::State;

extern "C" {

int tpr_obs_enabled(void) { return tpr_obs::enabled() ? 1 : 0; }

const char *tpr_obs_shm_name(void) {
  State *st = tpr_obs::state();
  return st ? st->shm.name.c_str() : "";
}

uint32_t tpr_obs_layout_version(void) { return tpr_obs::kObsVersion; }

uint32_t tpr_obs_capacity(void) {
  State *st = tpr_obs::state();
  return st ? st->capacity : 0;
}

void tpr_obs_counters(uint64_t *out, int n) {
  State *st = tpr_obs::state();
  for (int i = 0; i < n && i < (int)tpr_obs::kNumMetrics; i++)
    out[i] = st ? __atomic_load_n(st->metrics + i, __ATOMIC_RELAXED) : 0;
}

int tpr_obs_read(uint8_t *out, int max_records) {
  State *st = tpr_obs::state();
  if (!st || !out || max_records <= 0) return 0;
  int n = 0;
  for (uint32_t slot = 0; slot < st->capacity && n < max_records; slot++) {
    uint64_t s1 = __atomic_load_n(st->seq + slot, __ATOMIC_ACQUIRE);
    if (s1 == 0) continue;
    uint64_t w[4];
    const uint64_t *r = st->recs + (size_t)slot * 4;
    for (int k = 0; k < 4; k++)
      w[k] = __atomic_load_n(r + k, __ATOMIC_RELAXED);
    // acquire recheck: pairs with the writer's closing release store, so
    // a stable stamp proves the four word loads saw one whole record
    uint64_t s2 = __atomic_load_n(st->seq + slot, __ATOMIC_ACQUIRE);
    if (s2 != s1) continue;  // torn: a writer wrapped onto this slot
    memcpy(out + (size_t)n * tpr_obs::kRecordBytes, w, sizeof w);
    n++;
  }
  return n;
}

int tpr_obs_tag_name(uint32_t tag, char *out, int cap) {
  State *st = tpr_obs::state();
  if (!st || !out || cap <= 0 || tag == 0 ||
      tag > tpr_obs::kTagCap)
    return 0;
  uint32_t n = __atomic_load_n(st->tag_count, __ATOMIC_ACQUIRE);
  if (tag > n) return 0;
  uint8_t *slot = st->tags + (size_t)(tag - 1) * tpr_obs::kTagBytes;
  uint16_t slen;
  memcpy(&slen, slot, 2);
  int w = slen < cap - 1 ? slen : cap - 1;
  memcpy(out, slot + 2, w);
  out[w] = '\0';
  return w;
}

uint16_t tpr_obs_tag_for(const char *name) { return tpr_obs::tag_for(name); }

void tpr_obs_emit(uint16_t code, uint16_t tag, int64_t a1, int64_t a2) {
  tpr_obs::emit(code, tag, a1, a2);
}

void tpr_obs_reset(void) {
  State *st = tpr_obs::state();
  if (!st) return;
  // test isolation only — callers quiesce emitters first (the Python
  // flight recorder's reset() makes the same promise)
  std::lock_guard<std::mutex> lk(tpr_obs::g_init_mu);
  for (uint32_t i = 0; i < st->capacity; i++)
    __atomic_store_n(st->seq + i, 0, __ATOMIC_RELAXED);
  for (int i = 0; i < (int)tpr_obs::kNumMetrics; i++)
    __atomic_store_n(st->metrics + i, 0, __ATOMIC_RELAXED);
  // The tag table must reset too: a long-lived process interning a fresh
  // nconn:/nctrl:/nrdv: set per connection would exhaust the kTagCap slots
  // across many reset() generations and every later entity would collapse
  // into the anonymous tag.
  memset(st->tags, 0, (size_t)tpr_obs::kTagCap * tpr_obs::kTagBytes);
  __atomic_store_n(st->tag_count, 0u, __ATOMIC_RELAXED);
  __atomic_store_n(st->ticket, 0, __ATOMIC_RELEASE);
}

void tpr_obs_postfork(void) {
  std::lock_guard<std::mutex> lk(tpr_obs::g_init_mu);
  State *old = tpr_obs::g_state;
  if (old) {
    // the region belongs to the parent: unmap, never unlink
    old->shm.owner = false;
    old->shm.close();
    delete old;
  }
  State *fresh = nullptr;
  if (!tpr_obs::env_off("TPURPC_NATIVE_OBS"))
    fresh = tpr_obs::build_state();
  __atomic_store_n(&tpr_obs::g_state, fresh, __ATOMIC_RELAXED);
  __atomic_store_n(&tpr_obs::g_init_done, true, __ATOMIC_RELEASE);
}

}  // extern "C"
