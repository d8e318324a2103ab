// Native rendezvous + ctrl-ring plane (ROADMAP item 6): the C loop's side
// of the OFFER/CLAIM/COMPLETE/RELEASE zero-copy bulk ladder and the 128 B
// descriptor ctrl rings. The AUTHORITATIVE protocol lives in
// tpurpc_torch/core/rendezvous.py and tpurpc_torch/core/ctrlring.py — every struct
// layout, constant and ordering rule here is a byte-exact mirror of those
// two files (cross-plane interop is the acceptance bar; see
// ARCHITECTURE.md §27 for the shared layouts and the load/store contract).
//
// One tpr_rdv::Link hangs off each framed connection (client channel or
// adopted server conn) and carries BOTH roles:
//
//  - sender: eligible payloads (>= TPURPC_RENDEZVOUS_MIN_KB, negotiated
//    link) OFFER, wait for the peer's CLAIM (or reuse a STANDING grant on
//    its doorbell word — RDMAbox's pre-registered-buffer discipline,
//    arXiv:2104.12197), memcpy into the claimed shm window, COMPLETE.
//    Every failure returns false and the caller sends framed — fallback,
//    never a hang.
//  - receiver: OFFERs lease landing regions from a process-wide shm pool,
//    CLAIMs advertise them, COMPLETEs deliver the region bytes zero-copy
//    through the conn's OwnedBuf path; tpr_rdv::settle() is the single
//    "consumer is done with the pointer" entry (tpr_srv_buf_free and the
//    OwnedBuf destructor both route region pointers here).
//
// Control ops prefer the peer's ctrl ring (CtrlTx) and fall back framed;
// our own receive ring (CtrlRx) is drained by the conn's dispatch thread
// with the stamp-acquire / cons_head-release / parked-seqcst ordering
// documented at the member functions.
#ifndef TPURPC_TPR_RDV_H
#define TPURPC_TPR_RDV_H

#include <stdint.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <functional>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

#include "ring_transport.h"

namespace tpr_rdv {

// canonical control ops (rendezvous.py OP_*); frame type = op + 7
constexpr uint8_t kOpOffer = 1, kOpClaim = 2, kOpComplete = 3,
                  kOpRelease = 4;
// PING payload prefix that negotiates the ladder (rendezvous.py
// HELLO_PAYLOAD); the ctrl-ring descriptor blob rides behind it
constexpr char kHelloPayload[] = "\x00tpurpc-rdv1";
constexpr size_t kHelloPayloadLen = 12;

constexpr uint64_t kMinClass = 64 * 1024;      // _MIN_CLASS
constexpr uint64_t kMaxTransfer = 1ull << 30;  // _MAX_TRANSFER
constexpr size_t kNonceBytes = 16;
constexpr int kPregrantDepth = 4;              // _PREGRANT_DEPTH

// ctrl ring layout (ctrlring.py): 64 B header + nslots * 128 B slots
constexpr uint32_t kCtrlMagic = 0x54504352;  // 'TPCR'
constexpr uint32_t kCtrlVersion = 1;
constexpr uint32_t kCtrlSlotBytes = 128;
constexpr uint32_t kCtrlHdrBytes = 64;
constexpr uint32_t kCtrlSlotHdrBytes = 24;  // stamp, frame_seq, sid, len, op
constexpr uint32_t kMaxCtrlPayload = kCtrlSlotBytes - kCtrlSlotHdrBytes;
constexpr size_t kConsHeadOff = 16;
constexpr size_t kParkedOff = 24;
constexpr size_t kCtrlNonceOff = 32;

// -- env gates (read live, same knobs as the Python plane) -------------------
bool enabled();                 // TPURPC_RENDEZVOUS (default on)
uint64_t min_bytes();           // TPURPC_RENDEZVOUS_MIN_KB (default 256) KiB
uint64_t pool_budget();         // TPURPC_RENDEZVOUS_POOL_MB (default 256) MiB
double claim_timeout_s();       // TPURPC_RENDEZVOUS_CLAIM_TIMEOUT_S (5)
bool ctrl_enabled();            // TPURPC_CTRL_RING (default on)
uint32_t ctrl_slots();          // TPURPC_CTRL_RING_SLOTS (default 64, min 8)
uint64_t size_class(uint64_t nbytes);  // pow2 >= nbytes, floor 64 KiB

// -- process-global counters (the ledger the shim/tests read) ----------------
// Indices are ABI for tpr_rdv_counters (native_client.py binds them).
enum CounterIdx {
  kCtrRdvSent = 0,       // sender: messages moved via rendezvous
  kCtrRdvRecv,           // receiver: messages delivered from a region
  kCtrRdvFallback,       // sender: eligible messages that fell back framed
  kCtrRdvBytesSent,      // sender: one-sided bytes placed (the rdma_write)
  kCtrRdvBytesRecv,      // receiver: region bytes delivered
  kCtrRdvRefused,        // receiver: offers refused (budget/limit)
  kCtrCtrlPosts,         // producer: records placed in the peer's ring
  kCtrCtrlKicks,         // producer: framed kicks sent (parked consumer)
  kCtrCtrlRecords,       // consumer: records drained from our ring
  kCtrCtrlFrames,        // control ops that went FRAMED (ring miss/cold)
  kCtrHostCopyBytes,     // framed kMessage payload bytes on negotiated conns
  kCtrPregrants,         // receiver: standing pre-grants issued
  kNumCounters,
};
extern std::atomic<uint64_t> g_counters[kNumCounters];
inline void count(CounterIdx i, uint64_t n = 1) {
  g_counters[i].fetch_add(n, std::memory_order_relaxed);
}

// -- settle registry ---------------------------------------------------------
// A delivered region pointer must be settled EXACTLY once when its last
// consumer is done. Returns true when ptr was a registered rdv delivery
// (handled: doorbell rung / region recycled); false means the pointer is a
// plain malloc buffer and the caller should free() it.
bool settle(const void *ptr);
// True if ptr is a live rdv delivery (OwnedBuf adoption asks before free).
bool is_delivery(const void *ptr);

struct Lease;   // receiver-side region lease (tpr_rdv.cc)
struct Claim;   // sender-side view of a peer's claim (tpr_rdv.cc)

// -- the per-connection link -------------------------------------------------
class Link {
 public:
  explicit Link(const char *name);
  ~Link();

  // Wiring the owning connection provides before any traffic flows.
  // send_frame queues ONE framed control frame (types 8..12) on the
  // connection (under its write lock, bumping frames_sent); deliver hands
  // a completed rdv payload to the stream layer — `data` points into the
  // landing region and MUST be settle()d exactly once; wake pokes the
  // conn-level cv so claim waiters parked on it re-check.
  std::function<bool(uint8_t type, uint32_t sid, const std::string &p)>
      send_frame;
  std::function<void(uint32_t sid, uint8_t flags, uint8_t *data,
                     size_t len)> deliver;
  std::function<void()> wake;
  // Optional claim-wait pump for inline-read transports (no reader
  // thread): run the conn's frame pump until pred() or the deadline.
  std::function<void(const std::function<bool()> &pred,
                     std::chrono::steady_clock::time_point dl)> pump;

  // Frame accounting for the ctrl-ring ordering gate: the conn bumps
  // frames_sent for EVERY frame it queues (the producer stamps it into
  // posted records) and frames_dispatched for every frame it dispatches
  // (our consumer leaves a record in place until the frames it must order
  // after have been dispatched). Both count ALL frame types.
  std::atomic<uint64_t> frames_sent{0};
  std::atomic<uint64_t> frames_dispatched{0};

  std::atomic<bool> negotiated{false};

  // -- negotiation -----------------------------------------------------------
  // The hello PING payload this side sends right after the preface:
  // HELLO_PAYLOAD + our receive ring's descriptor blob (empty blob when
  // ctrl rings are off or shm is unavailable).
  std::string hello_payload();
  // Called for every received PING. True when the payload was a capability
  // hello (the caller still echoes the PONG): arms rendezvous and opens
  // the peer's ctrl ring from the trailing blob.
  bool maybe_hello(const uint8_t *payload, size_t len);

  // -- dispatch --------------------------------------------------------------
  // Frame types 8..12 from the conn's frame loop. Returns true when the
  // frame was a control frame this link consumed. Never throws; malformed
  // control payloads degrade to refused/ignored transfers.
  bool on_frame(uint8_t type, uint32_t sid, const uint8_t *p, size_t len);
  void on_op(uint8_t op, uint32_t sid, const uint8_t *p, size_t len);

  // -- sender role -----------------------------------------------------------
  // The frame-dispatch thread must never block on a claim (the claim's
  // own delivery runs there): the conn records it once known.
  void set_dispatch_thread();
  bool eligible(size_t total) const;
  // Move one whole MESSAGE payload via rendezvous. True = placed and
  // COMPLETE sent (the framed path must NOT also send it); false = fall
  // back framed (refused, timeout, write failure) — never an exception,
  // never a hang.
  bool send_message(uint32_t sid, uint8_t flags, const uint8_t *data,
                    size_t total);

  // -- ctrl-ring consumer face ----------------------------------------------
  bool ctrl_armed() const { return ctrl_tx_open_.load(); }
  bool ctrl_rx_ready() const { return rx_inited_; }
  // Drain every ready record in one pass (one cons_head publish per
  // batch); records gated on frames_dispatched stay in place. Safe from
  // any thread (try-lock; concurrent drainers skip). Updates the hot/cold
  // EWMA: hits heat, empty probes decay.
  int ctrl_drain();
  // The drain-EWMA hot/cold discipline (read_frame_polled's): hot conns
  // keep polling the ring off short fd-poll slices; a cold consumer parks
  // (parked=1, then ONE mandatory re-drain closes the lost-wakeup race —
  // the producer reads parked strictly after its stamp store).
  bool ctrl_hot();
  void ctrl_park();
  void ctrl_decay();  // one empty poll slice: miss-decay the EWMA

  // -- lifecycle -------------------------------------------------------------
  // Connection death: discard-quarantine every claimed region (a
  // straggling peer window must land in orphaned memory, never a region
  // re-leased to a new transfer), wake every claim waiter, close rings.
  void close();
  bool is_closed() const { return closed_.load(); }

 private:
  friend struct Lease;
  // control send: ring first (when armed and ring_ok), framed fallback
  void ctrl_send(uint8_t op, uint32_t sid, const std::string &payload,
                 bool ring_ok = true);
  void ctrl_kick();

  // sender internals
  std::shared_ptr<Claim> take_grant(uint64_t cls, size_t total);
  bool has_standing(uint64_t cls, size_t total);
  bool standing_free(const std::shared_ptr<Claim> &c);
  void drop_grant(const std::shared_ptr<Claim> &c);
  std::shared_ptr<Claim> rdv_claim(uint32_t sid, size_t total, uint64_t cls);
  uint8_t *window_base(const std::string &handle, size_t nbytes);
  // Window pin: raw window pointers escape mu_ for the bulk memcpy and
  // doorbell reads, so close() must not munmap while any pin is held.
  // pin_windows() orders the increment BEFORE the closed_ check (seq_cst
  // both sides): either the pinner sees closed_ and backs out, or close()
  // sees the pin and waits for it to drain before unmapping.
  bool pin_windows();
  void unpin_windows();
  bool rdv_write(const std::shared_ptr<Claim> &c, const uint8_t *data,
                 size_t total);
  void rdv_complete(const std::shared_ptr<Claim> &c, uint32_t sid,
                    uint8_t flags, size_t total);
  void rdv_release(const std::shared_ptr<Claim> &c);

  // receiver internals
  void on_offer(uint32_t sid, const uint8_t *p, size_t len);
  void on_claim(const uint8_t *p, size_t len);
  void on_complete(uint32_t sid, const uint8_t *p, size_t len);
  void on_release(const uint8_t *p, size_t len);
  void maybe_pregrant(uint64_t cls);

  std::string name_;
  mutable std::mutex mu_;
  std::condition_variable cv_;
  std::atomic<bool> closed_{false};
  // tpurpc-xray flight tags, interned ONCE at link construction (the
  // tpr-obs static-tag discipline); obs_adopted_ gates spin/park/stall
  // emission so the ctrl-ring machine never sees a flip before ADOPT
  uint16_t otag_rdv_ = 0, otag_ctrl_ = 0;
  std::atomic<bool> obs_adopted_{false};
  std::atomic<unsigned long> dispatch_tid_{0};
  std::atomic<int> window_pins_{0};  // senders inside a window deref

  // sender state (mu_)
  uint64_t next_req_ = 1;
  struct PendingReq {
    int state = 0;  // 0 pending, 1 claimed, 2 refused
    std::shared_ptr<Claim> claim;
  };
  std::unordered_map<uint64_t, std::shared_ptr<PendingReq>> reqs_;
  std::map<uint64_t, std::vector<std::shared_ptr<Claim>>> grants_;
  // open peer-region windows, keyed by handle. Never evicted before link
  // close: a mid-copy eviction would munmap under a writer, and the
  // peer's pool bounds the distinct handles one link can see.
  std::unordered_map<std::string, tpr_ring::ShmRegion> windows_;

  // receiver state (mu_)
  uint64_t next_lease_ = 1;
  std::unordered_map<uint64_t, std::shared_ptr<Lease>> leases_;
  std::unordered_map<uint64_t, uint64_t> req_lease_;
  std::map<uint64_t, int> pregrants_out_;

  // ctrl rings
  struct CtrlRx {
    tpr_ring::ShmRegion shm;
    uint32_t nslots = 0;
    uint64_t head = 0;
    uint8_t nonce[kNonceBytes];
  } rx_;
  bool rx_inited_ = false;
  std::mutex rx_mu_;  // drain try-lock
  struct CtrlTx {
    tpr_ring::ShmRegion shm;
    uint32_t nslots = 0;
    uint64_t seq = 0;
    bool stalled = false;  // ring-full edge
  } tx_;
  std::atomic<bool> ctrl_tx_open_{false};
  std::mutex tx_mu_;
  // consumer hot/cold EWMA (read_frame_polled's constants)
  std::mutex ewma_mu_;
  double ewma_ = 0.0;
  bool mode_hot_ = false;
};

}  // namespace tpr_rdv

#endif  // TPURPC_TPR_RDV_H
