// tpurpc-xray: the native plane's shared-memory observability surface.
//
// The C loop is the fastest plane and must not become the blindest one:
// this module gives it the SAME two instruments the Python plane already
// answers to — a flight recorder of transport EDGES (obs/flight.py's 32 B
// record shape, CLOCK_MONOTONIC stamps, interned entity tags) and a
// fixed-slot metrics table (the tpr_rdv_counters ledger generalized to
// counter/byte/busy_ns slots) — both living in ONE shm region so Python
// maps them with zero ctypes calls on the read path and the C writers pay
// zero syscalls and zero locks on the hot path.
//
// Region layout (all offsets little-endian, 64 B header):
//
//   [header 64 B]
//   [metrics   : kNumMetrics u64 atomic slots]
//   [tag table : tag_cap slots x kTagBytes (u16 len + name bytes)]
//   [seq words : capacity u64 atomic slots]
//   [records   : capacity x 32 B  (<Q t_ns><H code><H tag><I tid><q a1><q a2>)]
//
// Writer protocol (seqlock per slot, global order from one ticket word):
//   ticket = header.write_ticket.fetch_add(1, relaxed)
//   slot   = ticket % capacity
//   wait until seq[slot] == prior lap's stamp (claims the slot: a writer
//                                 lagging a FULL ring lap behind a
//                                 wrapping peer must not interleave)
//   seq[slot] = 0                (release: slot now in-progress)
//   record words stored relaxed  (4 x u64 — atomic words, never a memcpy,
//                                 so a racing reader is a detected torn
//                                 read, not UB)
//   seq[slot] = ticket + 1       (release: record whole and ordered)
//
// Reader protocol (Python's mmap decoder and tpr_obs_read both):
//   s1 = seq[slot] (acquire); skip if 0
//   copy the 4 words; s2 = seq[slot]; skip if s2 != s1
// A wrap during the copy moves seq by >= capacity, so the recheck catches
// it; ticket order (s1 - 1) is the global emission order.
//
// Event codes REUSE obs/flight.py's stable ints for every edge the Python
// plane also records (rdv offer/claim/write/complete/release, ctrl
// adopt/spin/park/stall, conn connect/dead) so the protocol machines in
// analysis/protocol.py replay the C plane UNMODIFIED; native-only edges
// (pin-wait, delivery-stall, rdv-fallback) take new appended codes.
//
// Emission discipline (the `tpr-obs` lint rule, analysis/lint.py): every
// site goes through TPR_OBS(kEv<Name>, <pre-interned tag>, a1, a2) — a
// static code constant, a tag interned ONCE at connect time (never
// tpr_obs::tag_for(...) in the call), pure integer args, no string
// literals. Events are edges, not traffic.
#ifndef TPURPC_TPR_OBS_H
#define TPURPC_TPR_OBS_H

#include <stdint.h>

namespace tpr_obs {

constexpr uint32_t kObsMagic = 0x54505258;  // 'TPRX'
constexpr uint32_t kObsVersion = 1;
constexpr uint32_t kRecordBytes = 32;
constexpr uint32_t kTagBytes = 48;  // u16 len + up to 46 name bytes
constexpr uint32_t kTagCap = 256;

// header field offsets (ABI for the Python decoder)
constexpr uint32_t kHdrMagic = 0;
constexpr uint32_t kHdrVersion = 4;
constexpr uint32_t kHdrCapacity = 8;
constexpr uint32_t kHdrTagCap = 12;
constexpr uint32_t kHdrMetricsCap = 16;
constexpr uint32_t kHdrRecordBytes = 20;
constexpr uint32_t kHdrTicket = 24;     // u64 atomic
constexpr uint32_t kHdrMetricsOff = 32;
constexpr uint32_t kHdrTagsOff = 36;
constexpr uint32_t kHdrSeqOff = 40;
constexpr uint32_t kHdrRecOff = 44;
constexpr uint32_t kHdrTagCount = 48;   // u32 atomic
constexpr uint32_t kHdrBytes = 64;

// -- event codes -------------------------------------------------------------
// Shared codes mirror tpurpc_torch/obs/flight.py EXACTLY (append-only ABI there);
// native-only codes are appended past the Python plane's current tail and
// registered in flight.EVENT_NAMES by the same PR that adds them here.
enum EventCode : uint16_t {
  kEvPeerDeath = 15,
  kEvConnConnect = 17,
  kEvConnDead = 18,
  kEvRdvOffer = 33,
  kEvRdvClaim = 34,
  kEvRdvWrite = 35,
  kEvRdvComplete = 36,
  kEvRdvRelease = 37,
  kEvCtrlAdopt = 56,
  kEvCtrlSpin = 57,
  kEvCtrlPark = 58,
  kEvCtrlStallBegin = 59,
  kEvCtrlStallEnd = 60,
  // native-only (machine-free: protocol machines ignore unknown codes)
  kEvPinWaitBegin = 70,    // close() waiting on window pins; a1 = pins held
  kEvPinWaitEnd = 71,      // a1 = waited ns
  kEvDlvStallBegin = 72,   // delivery-shard backlog crossed high water; a1 = depth
  kEvDlvStallEnd = 73,     // backlog drained below low water; a1 = depth
  kEvRdvFallback = 74,     // eligible send fell back framed; a1 = bytes,
                           // a2 = reason (0 no claim, 1 write failed)
};

// -- metrics table -----------------------------------------------------------
// Fixed-slot ABI like tpr_rdv's CounterIdx: the INDEX is the contract
// (tpurpc_torch/obs/native_obs.py mirrors these names in the same order and the
// registry scrapes them as native_* series). Append-only.
enum MetricIdx {
  kMetRdvSendBytes = 0,   // one-sided bytes placed by rdv_write
  kMetRdvSendBusyNs,      // ns inside the placement memcpy
  kMetRdvRecvBytes,       // region bytes delivered to the stream layer
  kMetRdvRecvBusyNs,      // ns inside deliver()
  kMetRdvWaitNs,          // ns senders spent waiting on solicited claims
  kMetRdvWaits,           // solicited claim waits begun
  kMetRdvFallbacks,       // eligible sends that fell back framed
  kMetCtrlDrainBatches,   // non-empty ctrl_drain passes
  kMetCtrlDrainRecords,   // records drained across those passes
  kMetCtrlKicks,          // framed kicks sent to a parked consumer
  kMetCtrlPosts,          // records placed in the peer's ring
  kMetCtrlFrames,         // control ops that went framed (ring miss/cold)
  kMetPinWaits,           // close() paths that found pins held
  kMetPinWaitNs,          // ns close() spent waiting for pins to drain
  kMetDlvEnqueued,        // delivery-shard items enqueued
  kMetDlvDrained,         // delivery-shard items delivered
  kMetDlvStalls,          // backlog high-water crossings
  kMetDlvDepth,           // gauge: current delivery backlog
  kMetConnUp,             // connections established (native plane)
  kMetConnDown,           // connections died
  kMetEmitted,            // flight records emitted (wraps overwrite)
  kMetTagOverflow,        // tag interns refused (table full -> tag 0)
  kNumMetrics,
};

// TPURPC_NATIVE_OBS=0 turns the whole plane off (read once at first use):
// emit/metric/tag_for become no-ops and no shm region is created. The
// tpr_rdv_counters ledger ABI is untouched either way.
bool enabled();

// Intern `name` to a small int once per entity lifetime (connect time).
// Returns 0 (the anonymous tag) on overflow or when the plane is off —
// never an error.
uint16_t tag_for(const char *name);

// The hot path: one ticket fetch_add + one acquire load (the slot claim,
// which only ever spins when a peer writer lags a full ring lap) + four
// relaxed word stores bracketed by two release stores. Never allocates,
// never takes a lock, never syscalls (clock_gettime is vDSO). No-op when
// the plane is off.
void emit(uint16_t code, uint16_t tag, int64_t a1, int64_t a2);

void metric_add(MetricIdx i, uint64_t n = 1);
void metric_store(MetricIdx i, uint64_t v);  // gauges
uint64_t metric_get(MetricIdx i);

uint64_t now_ns();  // CLOCK_MONOTONIC (== Python time.monotonic_ns())

}  // namespace tpr_obs

// The ONE emission spelling (the tpr-obs lint rule keys on it).
#define TPR_OBS(code, tag, a1, a2) \
  ::tpr_obs::emit((uint16_t)(code), (uint16_t)(tag), (int64_t)(a1), \
                  (int64_t)(a2))

// -- C ABI (tpurpc_torch/obs/native_obs.py binds these) ----------------------------
extern "C" {
int tpr_obs_enabled(void);
// Forces lazy init; returns the shm object name (no leading slash, the
// Python SharedMemory convention -> /dev/shm/<name>) or "" when off.
const char *tpr_obs_shm_name(void);
uint32_t tpr_obs_layout_version(void);
uint32_t tpr_obs_capacity(void);
void tpr_obs_counters(uint64_t *out, int n);
// Seqlock-consistent snapshot of whole records (32 B each) into out;
// returns the record count. Torn/in-progress slots are skipped.
int tpr_obs_read(uint8_t *out, int max_records);
int tpr_obs_tag_name(uint32_t tag, char *out, int cap);
uint16_t tpr_obs_tag_for(const char *name);
void tpr_obs_emit(uint16_t code, uint16_t tag, int64_t a1, int64_t a2);
void tpr_obs_reset(void);
// Forked child: drop the inherited mapping (without unlinking the
// parent's region) and start a fresh one, so a shard's evidence is its
// own. Python's postfork hooks call this when the lib is loaded.
void tpr_obs_postfork(void);
}

#endif  // TPURPC_TPR_OBS_H
