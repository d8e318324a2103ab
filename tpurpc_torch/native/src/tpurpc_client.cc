// tpurpc C client implementation — native app API over the tpurpc framing.
//
// Wire format (authoritative doc: tpurpc_torch/rpc/frame.py): 8-byte preface
// "TPURPC\x01\x00", then little-endian frames
//   [u8 type][u8 flags][u32 stream_id][u32 length][payload]
// with the gRPC-subset frame vocabulary (HEADERS/MESSAGE/TRAILERS/RST/
// PING/PONG/GOAWAY) the reference's chttp2 layer provides (frame_*.cc).
// One reader thread per channel demuxes to per-call mailboxes — the
// collapsed analog of grpc's pollset/completion-queue machinery
// (completion_queue.cc:393) for a blocking app API.

#include "../include/tpurpc/client.h"

#include "framing_common.h"
#include "ring_transport.h"
#include "tpr_obs.h"
#include "tpr_rdv.h"

#include <arpa/inet.h>
#include <fcntl.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <string.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdio>
#include <cstdlib>
#include <deque>
#include <map>
#include <mutex>
#include <set>
#include <string>
#include <thread>
#include <vector>

namespace {

using namespace tpr_wire;
using Clock = std::chrono::steady_clock;

// One queued completion. Value type: owns copies of everything it carries,
// so events stay valid after the originating call is destroyed.
struct CqEvent {
  int type = 0;
  void *tag = nullptr;
  int ok = 0;
  bool has_data = false;
  std::string data;
  int status = 0;
  std::string details;
};

// (cq, event) pairs collected — and pushed — under ch->mu, so completions
// reach the queue in the order they were generated (a push after releasing
// ch->mu could interleave with a racing canceller's terminal events,
// delivering a RECV after its call's FINISH). Lock nesting is strictly
// one-way: ch->mu → cq->mu; nothing takes ch->mu while holding cq->mu
// (tpr_cq_next releases cq->mu before its expiry RST).
using CqDeliveries = std::vector<std::pair<tpr_cq *, CqEvent>>;

struct Call {
  uint32_t stream_id = 0;
  tpr_channel *ch = nullptr;
  std::deque<std::string> messages;   // complete reassembled messages
  std::string partial;                // FLAG_MORE fragment accumulator
  bool trailers_seen = false;
  int status_code = TPR_UNKNOWN;
  std::string status_details;
  bool refused = false;  // kRst|kFlagRefused: admission refusal, no handler
  Clock::time_point deadline{};
  bool has_deadline = false;
  bool cancelled = false;
  int internal_users = 0;  // threads inside rst_and_finish_locally's send
  // CQ-async state (tags guarded by ch->mu; cq_pins by cq->mu; `done` is
  // atomic so the cq's deadline scan can read it without ch->mu).
  tpr_cq *cq = nullptr;
  std::deque<void *> recv_tags;
  bool finish_armed = false;
  void *finish_tag = nullptr;
  bool unary_armed = false;
  void *unary_tag = nullptr;
  std::atomic<bool> done{false};
  int cq_pins = 0;  // tpr_cq_next threads holding this call across an expiry
};

}  // namespace

struct tpr_cq {
  std::mutex mu;
  std::condition_variable cv;
  std::deque<CqEvent> q;
  bool shut = false;
  // CQ calls with a deadline, scanned lazily by tpr_cq_next (the puller
  // doubles as the timer thread — grpc's cq-driven timer check shape).
  std::set<tpr_call *> timed_calls;
};

namespace {

// Under ch->mu: match queued messages with pending recv tags, and emit the
// terminal completions once trailers are in. Called at every delivery point
// (reader loop, die(), local RST, op arming).
void drain_cq_locked(Call &c, CqDeliveries *out) {
  if (c.cq == nullptr) return;
  while (!c.recv_tags.empty() && !c.messages.empty()) {
    CqEvent ev;
    ev.type = TPR_EV_RECV;
    ev.tag = c.recv_tags.front();
    ev.ok = 1;
    ev.has_data = true;
    ev.data = std::move(c.messages.front());
    c.messages.pop_front();
    c.recv_tags.pop_front();
    out->emplace_back(c.cq, std::move(ev));
  }
  if (!c.trailers_seen) return;
  c.done.store(true);
  while (!c.recv_tags.empty()) {  // end of stream: ok=0, no message
    CqEvent ev;
    ev.type = TPR_EV_RECV;
    ev.tag = c.recv_tags.front();
    c.recv_tags.pop_front();
    out->emplace_back(c.cq, std::move(ev));
  }
  if (c.finish_armed) {
    CqEvent ev;
    ev.type = TPR_EV_FINISH;
    ev.tag = c.finish_tag;
    ev.ok = 1;
    ev.status = c.status_code;
    ev.details = c.status_details;
    c.finish_armed = false;
    out->emplace_back(c.cq, std::move(ev));
  }
  if (c.unary_armed) {  // response + status in ONE completion
    CqEvent ev;
    ev.type = TPR_EV_FINISH;
    ev.tag = c.unary_tag;
    ev.ok = 1;
    ev.status = c.status_code;
    ev.details = c.status_details;
    if (!c.messages.empty()) {
      ev.has_data = true;
      ev.data = std::move(c.messages.front());
      c.messages.pop_front();
    }
    c.unary_armed = false;
    out->emplace_back(c.cq, std::move(ev));
  }
}

void cq_push(CqDeliveries *evs) {
  // Batch consecutive events for the same cq (the overwhelmingly common
  // case) under one lock acquisition + one notify — the caller holds
  // ch->mu, so per-event churn here would serialize the whole channel.
  size_t i = 0;
  while (i < evs->size()) {
    tpr_cq *cq = (*evs)[i].first;
    {
      std::lock_guard<std::mutex> lk(cq->mu);
      for (; i < evs->size() && (*evs)[i].first == cq; ++i)
        cq->q.push_back(std::move((*evs)[i].second));
    }
    cq->cv.notify_all();
  }
  evs->clear();
}

}  // namespace

struct tpr_call {
  Call c;
};

struct tpr_channel {
  int fd = -1;
  // Ring data plane (GRPC_PLATFORM_TYPE=RDMA_*): frames ride the shm ring;
  // the socket stays as the bootstrap/notify channel inside the transport.
  tpr_ring::RingTransport *ring = nullptr;
  std::mutex write_mu;                 // serializes whole frames (FrameWriter analog)
  std::mutex mu;                       // guards streams / pong / alive
  std::condition_variable cv;          // signaled on any delivery
  std::map<uint32_t, tpr_call *> streams;
  uint32_t next_stream_id = 1;         // odd, client-initiated (h2 convention)
  bool draining = false;               // GOAWAY seen: no new calls (mu)
  std::atomic<bool> alive{true};
  uint64_t pong_count = 0;
  std::thread reader;
  bool inline_read = false;  // no reader thread; waiters pump (ring only)
  bool pumping = false;      // a thread is inside the transport (mu)
  // zero-copy send lease state. write_mu is HELD from a successful
  // tpr_call_send_reserve until commit/abort; lease_active is atomic and
  // lease_owner records the holder so misuse (same-thread re-reserve,
  // commit from a thread that isn't the owner) returns -1 instead of
  // deadlocking on the non-recursive mutex / unlocking a foreign lock.
  std::atomic<bool> lease_active{false};
  std::thread::id lease_owner{};
  uint64_t lease_len = 0;
  // rendezvous + ctrl-ring side of this channel (tpr_rdv.h); armed only if
  // the peer's hello PING negotiates the ladder
  tpr_rdv::Link *link = nullptr;
  // tpurpc-xray conn-lifecycle flight tag (interned once at create);
  // dead_emitted keeps the death edge an EDGE across die()/destructor
  uint16_t otag_conn = 0;
  std::atomic<bool> dead_emitted{false};

  ~tpr_channel() {
    if (otag_conn && !dead_emitted.exchange(true)) {
      TPR_OBS(tpr_obs::kEvConnDead, otag_conn, 1, 0);  // graceful teardown
      tpr_obs::metric_add(tpr_obs::kMetConnDown);
    }
    alive.store(false);
    if (link) link->close();  // wake claim waiters before the reader join
    if (ring) ring->shutdown();
    if (fd >= 0) ::shutdown(fd, SHUT_RDWR);
    if (reader.joinable()) reader.join();
    delete link;  // after the join: the reader drains/dispatches into it
    link = nullptr;
    if (ring) {
      ring->close();
      delete ring;
    }
    if (fd >= 0) ::close(fd);
  }

  bool write_all(const void *buf, size_t len) {
    return ring ? ring->write_all(buf, len)
                : tpr_wire::fd_write_all(fd, buf, len);
  }

  bool send_frame(uint8_t type, uint8_t flags, uint32_t sid,
                  const void *payload, size_t len) {
    std::lock_guard<std::mutex> lk(write_mu);
    if (!alive.load()) return false;
    bool ok = ring  // one gathered ring message + one notify per frame
                  ? ring_send_frame_locked(*ring, type, flags, sid, payload,
                                           len)
                  : t_send_frame_locked(*this, type, flags, sid, payload,
                                        len);
    // EVERY frame actually written counts (ctrl-ring records stamp this
    // value as their ordering gate; an overcount would strand records)
    if (ok && link) link->frames_sent.fetch_add(1, std::memory_order_release);
    return ok;
  }

  bool read_exact(void *buf, size_t len) {
    return ring ? ring->read_exact(buf, len)
                : tpr_wire::fd_read_exact(fd, buf, len);
  }

  void die() {
    if (otag_conn && !dead_emitted.exchange(true)) {
      TPR_OBS(tpr_obs::kEvConnDead, otag_conn, 0, 0);
      tpr_obs::metric_add(tpr_obs::kMetConnDown);
    }
    if (link) link->close();  // fail rdv waiters; quarantine leases
    CqDeliveries evs;
    {
      std::lock_guard<std::mutex> lk(mu);
      // Sweep + notify even when alive was already false: the *first*
      // flipper may have been ~tpr_channel, which doesn't sweep — an app
      // thread parked in a deadline-less tpr_call_recv/finish must still be
      // failed and woken, or it hangs on (then uses) a destroyed channel.
      alive.store(false);
      for (auto &kv : streams) {
        Call &c = kv.second->c;
        if (!c.trailers_seen) {
          c.trailers_seen = true;
          c.status_code = TPR_UNAVAILABLE;
          c.status_details = "connection lost";
        }
        drain_cq_locked(c, &evs);
      }
      cq_push(&evs);  // under mu: keeps cq ordering = generation ordering
    }
    cv.notify_all();
  }

  // Dispatch one frame. Returns 0 when the connection should end (last
  // in-flight call on a GOAWAY'd connection), else 1. Called with mu NOT
  // held (takes it itself), from the reader thread or an inline pumper.
  int process_frame(uint8_t type, uint8_t flags, uint32_t sid,
                    std::vector<uint8_t> &payload) {
    size_t len = payload.size();

    // Rendezvous / ctrl-ring control plane rides its own frame types —
    // routed before the stream demux (they address leases, not streams).
    if (type >= kRdvOffer && type <= kCtrlKick) {
      if (link) link->on_frame(type, sid, payload.data(), len);
      return 1;
    }
    if (type == kPing) {
      // hello negotiation piggybacks on PING (maybe_hello no-ops on
      // ordinary keepalive pings); always echo PONG regardless
      if (link) link->maybe_hello(payload.data(), len);
      send_frame(kPong, 0, 0, payload.data(), payload.size());
      return 1;
    }
    if (type == kPong) {
      {
        std::lock_guard<std::mutex> lk(mu);
        pong_count++;
      }
      cv.notify_all();
      return 1;
    }
    if (type == kGoaway) {
      // Graceful drain (server max_connection_age): stop admitting new
      // calls but keep reading so in-flight calls finish; the connection
      // dies when the last one completes (below) or at socket EOF.
      std::lock_guard<std::mutex> lk(mu);
      draining = true;
      return streams.empty() ? 0 : 1;
    }

    if (type == kMessage && (flags & kFlagCompressed)) {
      // Per-stream rejection, mirroring the native server's UNIMPLEMENTED
      // trailer: fail only the addressed stream (frames for unknown or
      // finished streams are simply ignored) instead of tearing down the
      // whole multiplexed connection and every unrelated in-flight call.
      // The details text must keep "compressed messages unsupported" as a
      // substring — the Python channel's compression negotiation keys on
      // it (tpurpc_torch/rpc/frame.py COMPRESSED_UNSUPPORTED_SENTINEL). The
      // teardown sequence below intentionally mirrors the kTrailers/kRst
      // branch tail; keep the two in sync (cq ordering under mu, draining
      // rule).
      CqDeliveries cq_evs;
      std::unique_lock<std::mutex> lk(mu);
      auto it = streams.find(sid);
      if (it == streams.end()) return 1;  // late frame for a finished call
      Call &c = it->second->c;
      c.status_code = TPR_UNIMPLEMENTED;
      c.status_details =
          "compressed messages unsupported by the native client";
      c.trailers_seen = true;
      streams.erase(it);
      drain_cq_locked(c, &cq_evs);
      cq_push(&cq_evs);  // under mu: keeps cq ordering = generation ordering
      bool drained = draining && streams.empty();
      lk.unlock();
      cv.notify_all();
      // RST so the server stops streaming into the locally-dead stream.
      std::vector<std::pair<std::string, std::string>> rst_md;
      rst_md.emplace_back(":status", std::to_string(TPR_UNIMPLEMENTED));
      rst_md.emplace_back(":message", "compressed messages unsupported");
      std::string rst_payload = encode_metadata(rst_md);
      send_frame(kRst, 0, sid, rst_payload.data(), rst_payload.size());
      return drained ? 0 : 1;
    }
    // Framed bulk on a rendezvous-negotiated connection = a host landing
    // copy the rdv path would have avoided; the ledger keeps that honest.
    if (type == kMessage && link && link->negotiated.load())
      tpr_rdv::count(tpr_rdv::kCtrHostCopyBytes, len);
    CqDeliveries cq_evs;
    std::unique_lock<std::mutex> lk(mu);
    auto it = streams.find(sid);
    if (it == streams.end()) return 1;  // late frame for a finished call
    Call &c = it->second->c;
    if (type == kMessage) {
      if (!(flags & kFlagNoMessage))
        c.partial.append(reinterpret_cast<char *>(payload.data()), len);
      if (!(flags & kFlagMore) && !(flags & kFlagNoMessage)) {
        c.messages.push_back(std::move(c.partial));
        c.partial.clear();
      }
      if (flags & kFlagEndStream) {
        // server half-closed without trailers: tolerate, finish as OK
        c.trailers_seen = true;
        c.status_code = TPR_OK;
        streams.erase(it);
      }
    } else if (type == kHeaders) {
      // initial metadata: stored nowhere yet (API exposes trailers only)
    } else if (type == kTrailers || type == kRst) {
      std::vector<std::pair<std::string, std::string>> md;
      decode_metadata(payload.data(), len, &md);
      if (type == kRst && (flags & kFlagRefused)) c.refused = true;
      c.status_code = TPR_UNKNOWN;
      for (auto &kv : md) {
        if (kv.first == ":status") c.status_code = atoi(kv.second.c_str());
        else if (kv.first == ":message") c.status_details = kv.second;
      }
      c.trailers_seen = true;
      streams.erase(it);
    }
    drain_cq_locked(c, &cq_evs);
    cq_push(&cq_evs);  // under mu: keeps cq ordering = generation ordering
    bool drained = draining && streams.empty();
    lk.unlock();
    cv.notify_all();
    return drained ? 0 : 1;
  }

  // Bounded single-frame read for the hot ctrl-polling mode: 1 = frame,
  // 0 = nothing within ~1ms, -1 = transport dead. For TCP the 1ms bound is
  // on frame START (poll); once the header begins the read blocks to the
  // frame boundary — fine, the bytes are already in flight.
  int read_frame_slice(uint8_t *type, uint8_t *flags, uint32_t *sid,
                       std::vector<uint8_t> *payload) {
    if (ring) {
      auto dl = Clock::now() + std::chrono::milliseconds(1);
      return read_frame_dl(&dl, type, flags, sid, payload);
    }
    struct pollfd pfd;
    pfd.fd = fd;
    pfd.events = POLLIN;
    pfd.revents = 0;
    int pr = ::poll(&pfd, 1, 1);
    if (pr == 0) return 0;
    if (pr < 0) return errno == EINTR ? 0 : -1;
    return t_read_frame(*this, type, flags, sid, payload) ? 1 : -1;
  }

  void read_loop() {
    if (link) link->set_dispatch_thread();
    std::vector<uint8_t> payload;
    uint8_t type, flags;
    uint32_t sid;
    while (alive.load()) {
      int r;
      if (link && link->ctrl_rx_ready() && link->ctrl_hot()) {
        // hot discipline: poll the ctrl ring between 1ms frame slices —
        // steady-state bulk needs no frames and no fd kicks at all
        if (link->ctrl_drain() == 0) {
          link->ctrl_decay();
          if (!link->ctrl_hot()) link->ctrl_park();
        }
        r = read_frame_slice(&type, &flags, &sid, &payload);
        if (r == 0) continue;
      } else {
        // cold/parked: block on the fd; a parked producer sends CTRL_KICK
        r = t_read_frame(*this, &type, &flags, &sid, &payload) ? 1 : -1;
      }
      if (r < 0) break;
      // ctrl records whose ordering gate has been reached must land before
      // the frame they precede (Python pre-commit drain analog)
      if (link) link->ctrl_drain();
      int cont = process_frame(type, flags, sid, payload);
      if (link) {
        link->frames_dispatched.fetch_add(1, std::memory_order_release);
        // re-drain AFTER the dispatch count advances: a record gated on
        // exactly this frame deferred in the pre-dispatch drain, and the
        // producer may have posted it while we were unparked — without
        // this pass it would strand until the next (possibly never)
        // frame arrives (observed as 5s claim timeouts)
        link->ctrl_drain();
      }
      if (cont == 0) break;
    }
    die();
  }

  // One frame read whose HEADER wait is bounded by `dl` (frame-boundary
  // abandon; ring only). 1 = frame delivered, 0 = deadline, -1 = dead.
  int read_frame_dl(const Clock::time_point *dl, uint8_t *type,
                    uint8_t *flags, uint32_t *sid,
                    std::vector<uint8_t> *payload) {
    uint8_t hdr[10];
    int r = ring->read_exact_deadline(hdr, sizeof hdr, dl);
    if (r <= 0) return r;
    return t_finish_frame(*ring, hdr, type, flags, sid, payload) ? 1 : -1;
  }

  // Inline-read discipline (TPURPC_NATIVE_INLINE_READ=1, ring platforms):
  // the WAITING thread pumps the transport itself — the reference's
  // pollset_work model (grpc_completion_queue_next → pollable_epoll,
  // SURVEY §3.4) — eliminating the reader→caller thread wakeup from every
  // round trip. One pumper at a time; others park on cv and inherit the
  // pump when it is released. Returns false only when `dl` passed without
  // pred becoming true.
  template <typename Pred>
  bool pump_until(std::unique_lock<std::mutex> &lk, Pred pred,
                  const Clock::time_point *dl) {
    std::vector<uint8_t> payload;
    uint8_t type, flags;
    uint32_t sid;
    while (!pred()) {
      if (!alive.load()) return true;  // terminal state; caller decodes it
      // Own-deadline check BEFORE (re)taking the pump: a pumper servicing
      // another stream's continuous traffic never hits the header-wait
      // timeout inside read_exact_deadline, so without this check its
      // deadline could be starved for as long as frames keep arriving.
      if (dl != nullptr && Clock::now() >= *dl) return false;
      if (pumping) {
        // another thread is inside the transport; wait for its dispatch
        if (dl != nullptr) {
          if (cv.wait_until(lk, *dl) == std::cv_status::timeout && !pred())
            return false;
        } else {
          cv.wait(lk);
        }
        continue;
      }
      pumping = true;
      lk.unlock();
      if (link) link->ctrl_drain();  // inline pumpers service the ring too
      int r;
      if (link && link->ctrl_rx_ready() && link->ctrl_hot()) {
        // read_loop's hot/cold ctrl discipline, inline-pumper edition: a
        // pumper must never commit to a blocking read while the ctrl ring
        // is unparked — a producer that read parked=0 skips the CTRL_KICK,
        // so a record posted behind this read would strand until some
        // unrelated frame arrives (the defer-then-block lost wakeup,
        // observed as 5s claim timeouts). Poll in 1ms slices while hot;
        // park before blocking for real.
        auto slice = Clock::now() + std::chrono::milliseconds(1);
        const Clock::time_point *sdl =
            (dl != nullptr && *dl < slice) ? dl : &slice;
        r = read_frame_dl(sdl, &type, &flags, &sid, &payload);
        if (r == 0 && link->ctrl_drain() == 0) {
          link->ctrl_decay();
          if (!link->ctrl_hot()) link->ctrl_park();
        }
      } else {
        r = read_frame_dl(dl, &type, &flags, &sid, &payload);
      }
      int cont = 1;
      if (r == 1) {
        if (link) link->ctrl_drain();
        cont = process_frame(type, flags, sid, payload);
        if (link) {
          link->frames_dispatched.fetch_add(1, std::memory_order_release);
          link->ctrl_drain();  // lift the gate for records on THIS frame
        }
      }
      lk.lock();
      pumping = false;
      cv.notify_all();  // deliver wakeups + hand off the pump
      if (r < 0 || cont == 0) {
        lk.unlock();
        die();
        lk.lock();
      }
      // r == 0: a slice or deadline expired at a frame boundary — loop;
      // the own-deadline check at the top returns false when `dl` truly
      // passed (slice expiries with dl unset just keep pumping).
    }
    return true;
  }
};

// ---------------------------------------------------------------------------

// RST the stream and record a local terminal status. Servers do NOT
// acknowledge an RST with trailers (tpurpc_torch/rpc/server.py cancels the
// context and goes quiet), so the call must finish locally — otherwise a
// deadline-less Finish() after Cancel() would wait forever. A real trailers
// frame that raced in first wins.
static void rst_and_finish_locally(tpr_call *c, int code,
                                   const char *details) {
  tpr_channel *ch = c->c.ch;
  uint32_t sid;
  {
    std::lock_guard<std::mutex> lk(ch->mu);
    if (c->c.cancelled || c->c.trailers_seen) return;
    c->c.cancelled = true;
    c->c.internal_users++;  // pins `c` across the unlocked send below —
    sid = c->c.stream_id;   // tpr_call_destroy waits for users to drain
  }
  std::vector<std::pair<std::string, std::string>> md;
  md.emplace_back(":status", std::to_string(TPR_CANCELLED));
  md.emplace_back(":message", details);
  std::string payload = encode_metadata(md);
  ch->send_frame(kRst, 0, sid, payload.data(), payload.size());
  CqDeliveries evs;
  {
    std::lock_guard<std::mutex> lk(ch->mu);
    ch->streams.erase(sid);
    if (!c->c.trailers_seen) {
      c->c.trailers_seen = true;
      c->c.status_code = code;
      c->c.status_details = details;
    }
    drain_cq_locked(c->c, &evs);
    cq_push(&evs);  // under mu: keeps cq ordering = generation ordering
    c->c.internal_users--;
  }
  ch->cv.notify_all();
}

// CQ deadline expiry: terminate + DELIVER FIRST, then best-effort RST.
// rst_and_finish_locally won't do here — its cancelled/trailers_seen guard
// early-returns when a concurrent tpr_call_cancel won the race, and that
// canceller can sit wedged in its RST send indefinitely (peer stopped
// reading), which would strand the armed finish/unary tag forever. The
// blocking API bounds the same race with a 5 s wait (tpr_call_finish);
// the CQ path must not lose the completion at all. Setting the terminal
// status before the RST is safe: a real trailers frame racing in later
// finds trailers_seen set and drain emits nothing twice. The trailing RST
// send can block only if the socket buffer is full of the app's own
// wedged bulk writes — the same bounded exposure the blocking cancel has.
static void cq_expire(tpr_call *c, int code, const char *details) {
  tpr_channel *ch = c->c.ch;
  uint32_t sid = 0;
  bool send_rst = false;
  {
    std::lock_guard<std::mutex> lk(ch->mu);
    if (!c->c.trailers_seen) {
      c->c.trailers_seen = true;
      c->c.status_code = code;
      c->c.status_details = details;
      send_rst = !c->c.cancelled;  // a racing cancel already ships an RST
      c->c.cancelled = true;       // make later cancels no-ops
      sid = c->c.stream_id;
      ch->streams.erase(sid);
      CqDeliveries evs;
      drain_cq_locked(c->c, &evs);
      cq_push(&evs);
    }
  }
  ch->cv.notify_all();
  if (send_rst) {
    std::vector<std::pair<std::string, std::string>> md;
    md.emplace_back(":status", std::to_string(TPR_CANCELLED));
    md.emplace_back(":message", details);
    std::string payload = encode_metadata(md);
    ch->send_frame(kRst, 0, sid, payload.data(), payload.size());
  }
}


extern "C" {

tpr_channel *tpr_channel_create(const char *host, int port, int timeout_ms) {
  // env-derived default discipline (TPURPC_NATIVE_INLINE_READ)
  const char *inl = getenv("TPURPC_NATIVE_INLINE_READ");
  return tpr_channel_create2(host, port, timeout_ms,
                             (inl != nullptr && inl[0] == '1')
                                 ? TPR_CHANNEL_INLINE_READ
                                 : 0);
}

tpr_channel *tpr_channel_create2(const char *host, int port, int timeout_ms,
                                 int flags) {
  struct addrinfo hints {};
  hints.ai_family = AF_UNSPEC;
  hints.ai_socktype = SOCK_STREAM;
  char portbuf[16];
  snprintf(portbuf, sizeof portbuf, "%d", port);
  struct addrinfo *res = nullptr;
  if (getaddrinfo(host, portbuf, &hints, &res) != 0 || res == nullptr)
    return nullptr;
  int fd = -1;
  for (struct addrinfo *ai = res; ai; ai = ai->ai_next) {
    fd = ::socket(ai->ai_family, ai->ai_socktype | SOCK_NONBLOCK,
                  ai->ai_protocol);
    if (fd < 0) continue;
    int rc = ::connect(fd, ai->ai_addr, ai->ai_addrlen);
    if (rc != 0 && errno == EINPROGRESS) {
      struct pollfd pfd {fd, POLLOUT, 0};
      if (::poll(&pfd, 1, timeout_ms > 0 ? timeout_ms : -1) == 1) {
        int err = 0;
        socklen_t len = sizeof err;
        getsockopt(fd, SOL_SOCKET, SO_ERROR, &err, &len);
        rc = err == 0 ? 0 : -1;
      } else {
        rc = -1;  // timeout
      }
    }
    if (rc == 0) {
      int fl = fcntl(fd, F_GETFL);
      fcntl(fd, F_SETFL, fl & ~O_NONBLOCK);  // back to blocking for IO
      break;
    }
    ::close(fd);
    fd = -1;
  }
  freeaddrinfo(res);
  if (fd < 0) return nullptr;
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);

  auto *ch = new tpr_channel();
  ch->fd = fd;
  if (platform_wants_ring()) {
    // the reference's defining property: app code unchanged, the byte pipe
    // under it swapped by env (endpoint.cc:33-54) — now for native apps too
    auto *rt = new tpr_ring::RingTransport();
    std::string err;
    if (!rt->bootstrap(fd, ring_size_from_env(), /*preread_magic=*/false,
                       &err, timeout_ms)) {
      fprintf(stderr, "tpurpc: ring bootstrap failed: %s\n", err.c_str());
      rt->close();
      delete rt;
      delete ch;
      return nullptr;
    }
    ch->ring = rt;
  }
  if (!ch->write_all(kMagic, 8)) {
    delete ch;
    return nullptr;
  }
  if (tpr_rdv::enabled()) {
    // Rendezvous link: send_frame goes through ch->send_frame (which also
    // does the frames_sent accounting); deliver copies the landing region
    // into the call mailbox then settles the lease. The client API's recv
    // copies out of a std::string anyway, so the zero-landing-copy win is
    // a server-side property; the client-side rdv win is skipping framed
    // fragmentation + per-frame wakeups on send.
    ch->link = new tpr_rdv::Link("cli");
    ch->link->send_frame = [ch](uint8_t type, uint32_t sid,
                                const std::string &payload) {
      return ch->send_frame(type, 0, sid, payload.data(), payload.size());
    };
    ch->link->deliver = [ch](uint32_t sid, uint8_t dflags, uint8_t *data,
                             size_t len) {
      CqDeliveries evs;
      {
        std::unique_lock<std::mutex> lk(ch->mu);
        auto it = ch->streams.find(sid);
        if (it != ch->streams.end()) {
          Call &c = it->second->c;
          c.messages.emplace_back(reinterpret_cast<char *>(data), len);
          if (dflags & kFlagEndStream) {
            c.trailers_seen = true;
            c.status_code = TPR_OK;
            ch->streams.erase(it);
          }
          drain_cq_locked(c, &evs);
          cq_push(&evs);
        }
      }
      ch->cv.notify_all();
      tpr_rdv::settle(data);  // recycle the lease; `data` is region memory
    };
    ch->link->wake = [ch] { ch->cv.notify_all(); };
    if (!ch->send_frame(kPing, 0, 0, ch->link->hello_payload().data(),
                        ch->link->hello_payload().size())) {
      delete ch;
      return nullptr;
    }
  }
  // Inline-read (opt-in, ring platforms): the lowest-latency blocking
  // discipline — callers pump the transport themselves, no reader thread.
  // CQ async ops need the reader and refuse on such channels.
  ch->inline_read =
      ch->ring != nullptr && (flags & TPR_CHANNEL_INLINE_READ) != 0;
  if (ch->inline_read && ch->link) {
    // no reader thread: rdv claim waiters pump the transport themselves
    ch->link->pump = [ch](const std::function<bool()> &pred,
                          Clock::time_point dl) {
      std::unique_lock<std::mutex> lk(ch->mu);
      ch->pump_until(lk, [&] { return pred(); }, &dl);
    };
  }
  if (!ch->inline_read)
    ch->reader = std::thread([ch] { ch->read_loop(); });
  if (tpr_obs::enabled()) {
    static std::atomic<uint64_t> conn_ord{1};
    char tb[44];
    snprintf(tb, sizeof tb, "nconn:cli#%llu",
             (unsigned long long)conn_ord.fetch_add(
                 1, std::memory_order_relaxed));
    ch->otag_conn = tpr_obs::tag_for(tb);
    TPR_OBS(tpr_obs::kEvConnConnect, ch->otag_conn, 0, 0);
    tpr_obs::metric_add(tpr_obs::kMetConnUp);
  }
  return ch;
}

static void abort_lease_if_owned(tpr_channel *ch);  // defined with the lease API

void tpr_channel_destroy(tpr_channel *ch) {
  // Last-resort abandoned-lease recovery before ~tpr_channel joins the
  // reader (which a wedged write_mu could deadlock behind a sender).
  abort_lease_if_owned(ch);
  delete ch;
}

int64_t tpr_channel_ping(tpr_channel *ch, int timeout_ms) {
  uint64_t before;
  {
    std::lock_guard<std::mutex> lk(ch->mu);
    before = ch->pong_count;
  }
  auto t0 = Clock::now();
  if (!ch->send_frame(kPing, 0, 0, "p", 1)) return -1;
  std::unique_lock<std::mutex> lk(ch->mu);
  auto pred = [&] { return ch->pong_count > before || !ch->alive.load(); };
  bool ok;
  if (ch->inline_read) {
    auto dl = t0 + std::chrono::milliseconds(timeout_ms);
    ok = ch->pump_until(lk, pred, &dl);
  } else {
    ok = ch->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms), pred);
  }
  if (!ok || ch->pong_count <= before) return -1;
  return std::chrono::duration_cast<std::chrono::microseconds>(Clock::now() - t0)
      .count();
}

// Internal: register a stream + build its HEADERS payload (shared by the
// normal and buffered start paths — one copy of the draining gate,
// stream-id allocation, deadline setup, and :path/:timeout-us metadata).
static tpr_call *register_call(tpr_channel *ch, const char *method,
                               const char *const *metadata, size_t n_md,
                               int timeout_ms, std::string *hdr_payload) {
  if (!ch->alive.load()) return nullptr;
  auto *call = new tpr_call();
  {
    std::lock_guard<std::mutex> lk(ch->mu);
    if (ch->draining) {  // GOAWAY'd: the app must open a fresh channel
      delete call;
      return nullptr;
    }
    call->c.stream_id = ch->next_stream_id;
    ch->next_stream_id += 2;
    call->c.ch = ch;
    if (timeout_ms > 0) {
      call->c.has_deadline = true;
      call->c.deadline = Clock::now() + std::chrono::milliseconds(timeout_ms);
    }
    ch->streams[call->c.stream_id] = call;
  }
  std::vector<std::pair<std::string, std::string>> md;
  md.emplace_back(":path", method);
  if (timeout_ms > 0)
    md.emplace_back(":timeout-us", std::to_string(int64_t(timeout_ms) * 1000));
  for (size_t i = 0; i + 1 < 2 * n_md; i += 2)
    md.emplace_back(metadata[i], metadata[i + 1]);
  *hdr_payload = encode_metadata(md);
  return call;
}

static void unregister_call(tpr_channel *ch, tpr_call *call) {
  std::lock_guard<std::mutex> lk(ch->mu);
  ch->streams.erase(call->c.stream_id);
  delete call;
}

// Internal: ship HEADERS + the whole request MESSAGE (END_STREAM) for a
// registered call as one buffered write (one syscall / ring message).
static bool ship_buffered(tpr_channel *ch, tpr_call *call,
                          const std::string &hdr_payload, const uint8_t *req,
                          size_t req_len) {
  std::string buf;
  buf.reserve(20 + hdr_payload.size() + req_len);
  build_frame_header(buf, kHeaders, 0, call->c.stream_id,
                     hdr_payload.size());
  buf += hdr_payload;
  build_frame_header(buf, kMessage, kFlagEndStream, call->c.stream_id,
                     req_len);
  buf.append(reinterpret_cast<const char *>(req), req_len);
  std::lock_guard<std::mutex> lk(ch->write_mu);
  bool ok =
      ch->alive.load() &&
      (ch->ring ? ch->ring->write_gather(buf.data(), buf.size(), nullptr, 0)
                : tpr_wire::fd_write_all(ch->fd, buf.data(), buf.size()));
  // this path bypasses send_frame; it ships TWO frames in one write
  if (ok && ch->link)
    ch->link->frames_sent.fetch_add(2, std::memory_order_release);
  return ok;
}

// Internal: register a call and ship HEADERS + the whole request MESSAGE
// (END_STREAM) as one buffered write. Small-unary fast path only.
static tpr_call *tpr_call_start_buffered(tpr_channel *ch, const char *method,
                                         int timeout_ms, const uint8_t *req,
                                         size_t req_len) {
  std::string hdr_payload;
  tpr_call *call = register_call(ch, method, nullptr, 0, timeout_ms,
                                 &hdr_payload);
  if (!call) return nullptr;
  if (!ship_buffered(ch, call, hdr_payload, req, req_len)) {
    unregister_call(ch, call);
    return nullptr;
  }
  return call;
}

tpr_call *tpr_call_start(tpr_channel *ch, const char *method,
                         const char *const *metadata, size_t n_md,
                         int timeout_ms) {
  std::string payload;
  tpr_call *call = register_call(ch, method, metadata, n_md, timeout_ms,
                                 &payload);
  if (!call) return nullptr;
  if (!ch->send_frame(kHeaders, 0, call->c.stream_id, payload.data(),
                      payload.size())) {
    unregister_call(ch, call);
    return nullptr;
  }
  return call;
}

int tpr_call_send(tpr_call *c, const uint8_t *data, size_t len, int end_stream) {
  tpr_channel *ch = c->c.ch;
  // Rendezvous ladder first: on a negotiated native connection, payloads
  // at/above the threshold one-sided-write into a leased landing region —
  // no framed fragmentation, and in steady state no control frames either
  // (the COMPLETE rides the ctrl ring). Any failure falls through framed.
  if (ch->link && ch->link->eligible(len) &&
      ch->link->send_message(c->c.stream_id,
                             end_stream ? kFlagEndStream : 0, data, len))
    return 0;
  // fragment at the frame bound with MORE on all but the last piece
  size_t off = 0;
  do {
    size_t n = len - off;
    bool last = n <= kMaxFramePayload;
    if (!last) n = kMaxFramePayload;
    uint8_t flags = 0;
    if (!last) flags |= kFlagMore;
    if (last && end_stream) flags |= kFlagEndStream;
    if (!ch->send_frame(kMessage, flags, c->c.stream_id, data + off, n))
      return -1;
    off += n;
  } while (off < len);
  return 0;
}

static int send_reserve_flagged(tpr_call *c, size_t len, uint8_t fflags,
                                uint8_t **p1, size_t *l1,
                                uint8_t **p2, size_t *l2) {
  // Zero-copy send (the reference's SendZerocopy shape, pair.cc:793-941,
  // recast for a shm ring): reserve ONE message's span in the peer ring so
  // the producer SERIALIZES INTO THE TRANSPORT — the staging buffer and
  // its memcpy disappear. The 10-byte frame header is written here; the
  // caller fills the returned payload segments then commits. write_mu is
  // HELD between reserve and commit/abort: commit promptly from the same
  // thread, and issue no other sends in between (they would deadlock).
  tpr_channel *ch = c->c.ch;
  if (ch->ring == nullptr || len == 0 || len > kMaxFramePayload) return -1;
  // BEFORE taking write_mu: the holder of an uncommitted lease already
  // owns the lock, so a same-thread re-reserve must fail fast here — the
  // lock() below would self-deadlock a non-recursive mutex (and another
  // thread's reserve would block, which is just normal send serialization)
  if (ch->lease_active.load()) return -1;
  ch->write_mu.lock();
  if (!ch->alive.load() || ch->lease_active.load()) {
    ch->write_mu.unlock();
    return -1;
  }
  uint64_t total = 10 + (uint64_t)len;
  uint8_t *q1;
  uint64_t m1;
  uint8_t *q2;
  uint64_t m2;
  if (!ch->ring->reserve_lease(total, &q1, &m1, &q2, &m2)) {
    ch->write_mu.unlock();
    return -1;
  }
  std::string hdr;
  build_frame_header(hdr, kMessage, fflags, c->c.stream_id, len);
  // header may straddle the wrap split
  size_t h1 = hdr.size() < m1 ? hdr.size() : (size_t)m1;
  memcpy(q1, hdr.data(), h1);
  if (h1 < hdr.size()) memcpy(q2, hdr.data() + h1, hdr.size() - h1);
  if (m1 > hdr.size()) {
    *p1 = q1 + hdr.size();
    *l1 = (size_t)(m1 - hdr.size());
    *p2 = q2;
    *l2 = (size_t)m2;
  } else {
    *p1 = q2 + (hdr.size() - m1);
    *l1 = (size_t)(m2 - (hdr.size() - m1));
    *p2 = nullptr;
    *l2 = 0;
  }
  ch->lease_owner = std::this_thread::get_id();
  ch->lease_len = total;
  ch->lease_active.store(true);
  return 0;
}

int tpr_call_send_reserve(tpr_call *c, size_t len, int end_stream,
                          uint8_t **p1, size_t *l1,
                          uint8_t **p2, size_t *l2) {
  return send_reserve_flagged(c, len, end_stream ? kFlagEndStream : 0,
                              p1, l1, p2, l2);
}

int tpr_call_send_reserve2(tpr_call *c, size_t len, int flags,
                           uint8_t **p1, size_t *l1,
                           uint8_t **p2, size_t *l2) {
  // Fragment-aware lease: TPR_RESERVE_MORE marks this frame as a non-final
  // fragment of one message (kFlagMore), so a producer can gather a payload
  // LARGER than kMaxFramePayload through several leases and the peer still
  // reassembles ONE message — the zero-copy analog of tpr_call_send's
  // fragmentation loop. TPR_RESERVE_END_STREAM only makes sense on the
  // final fragment (callers pass it with MORE clear).
  uint8_t f = 0;
  if (flags & TPR_RESERVE_END_STREAM) f |= kFlagEndStream;
  if (flags & TPR_RESERVE_MORE) f |= kFlagMore;
  return send_reserve_flagged(c, len, f, p1, l1, p2, l2);
}

// Only the RESERVING thread may finish a lease: a stranger "committing"
// would publish a half-filled message to the peer and unlock a mutex it
// never locked (both UB). The owner-id gate turns that misuse into -1.
static bool lease_owned_by_me(tpr_channel *ch) {
  return ch->lease_active.load() &&
         ch->lease_owner == std::this_thread::get_id();
}

// Abandoned-lease recovery (ADVICE r5): a caller that throws between
// reserve and commit/abort (ctypes exception mid-fill) would otherwise
// leave write_mu locked forever, wedging every send on the channel. The
// destroy paths call this so same-thread cleanup (the normal Python
// exception unwind: reserve → raise → call/channel destroy) releases the
// lease. Reserve never advanced the tail, so the span is simply reused.
// Only the owning thread can recover — unlocking a foreign thread's mutex
// is UB — which matches the failure mode: the thread that abandoned the
// lease is the one running the unwind.
static void abort_lease_if_owned(tpr_channel *ch) {
  if (lease_owned_by_me(ch)) {
    ch->lease_active.store(false);
    ch->write_mu.unlock();
  }
}

int tpr_call_send_commit(tpr_call *c) {
  tpr_channel *ch = c->c.ch;
  if (!lease_owned_by_me(ch)) return -1;
  ch->ring->commit_lease(ch->lease_len);
  // the lease published one MESSAGE frame outside send_frame
  if (ch->link)
    ch->link->frames_sent.fetch_add(1, std::memory_order_release);
  ch->lease_active.store(false);
  ch->write_mu.unlock();
  return 0;
}

int tpr_call_send_abort(tpr_call *c) {
  // Un-publish: reserve never advanced the tail, so the span is simply
  // reused by the next send. Releases the channel's send path.
  tpr_channel *ch = c->c.ch;
  if (!lease_owned_by_me(ch)) return -1;
  ch->lease_active.store(false);
  ch->write_mu.unlock();
  return 0;
}

int tpr_call_writes_done(tpr_call *c) {
  return c->c.ch->send_frame(kMessage, kFlagEndStream | kFlagNoMessage,
                             c->c.stream_id, nullptr, 0)
             ? 0
             : -1;
}

static bool wait_event(tpr_call *c, std::unique_lock<std::mutex> &lk) {
  tpr_channel *ch = c->c.ch;
  auto ready = [&] {
    return !c->c.messages.empty() || c->c.trailers_seen || !ch->alive.load();
  };
  if (ch->inline_read)
    return ch->pump_until(lk, ready,
                          c->c.has_deadline ? &c->c.deadline : nullptr);
  if (c->c.has_deadline)
    return ch->cv.wait_until(lk, c->c.deadline, ready);
  ch->cv.wait(lk, ready);
  return true;
}

int tpr_call_recv(tpr_call *c, uint8_t **data, size_t *len) {
  tpr_channel *ch = c->c.ch;
  std::unique_lock<std::mutex> lk(ch->mu);
  while (true) {
    if (!c->c.messages.empty()) {
      std::string &m = c->c.messages.front();
      *len = m.size();
      *data = static_cast<uint8_t *>(malloc(m.size() ? m.size() : 1));
      memcpy(*data, m.data(), m.size());
      c->c.messages.pop_front();
      return 1;
    }
    if (c->c.trailers_seen) return 0;
    if (!ch->alive.load()) return -1;
    if (!wait_event(c, lk)) return -1;  // deadline
  }
}

int tpr_call_finish(tpr_call *c, char *details, size_t cap) {
  tpr_channel *ch = c->c.ch;
  std::unique_lock<std::mutex> lk(ch->mu);
  while (!c->c.trailers_seen) {
    if (!ch->alive.load()) {
      c->c.trailers_seen = true;
      c->c.status_code = TPR_UNAVAILABLE;
      c->c.status_details = "connection lost";
      break;
    }
    if (!wait_event(c, lk)) {  // client-side deadline
      lk.unlock();
      rst_and_finish_locally(c, TPR_DEADLINE_EXCEEDED,
                             "deadline exceeded (client)");
      lk.lock();
      // If a concurrent cancel won the race, rst_and_finish_locally
      // early-returned without a terminal status; the racing thread sets
      // trailers_seen right after its RST send completes — wait for it,
      // BOUNDED: that thread can itself be stuck in send() on a peer that
      // stopped reading, and a deadline-exceeded call must never hang.
      ch->cv.wait_for(lk, std::chrono::seconds(5), [&] {
        return c->c.trailers_seen || !ch->alive.load();
      });
      if (!c->c.trailers_seen) {
        c->c.trailers_seen = true;
        c->c.status_code = TPR_DEADLINE_EXCEEDED;
        c->c.status_details = "deadline exceeded (client)";
      }
      break;
    }
  }
  if (details && cap > 0) {
    size_t n = c->c.status_details.size();
    if (n >= cap) n = cap - 1;
    memcpy(details, c->c.status_details.data(), n);
    details[n] = '\0';
  }
  return c->c.status_code;
}

void tpr_call_cancel(tpr_call *c) {
  rst_and_finish_locally(c, TPR_CANCELLED, "cancelled by client");
}

void tpr_call_destroy(tpr_call *c) {
  tpr_channel *ch = c->c.ch;
  // An exception between send_reserve and commit unwinds through here:
  // free the channel's send path before anything that could block on it.
  abort_lease_if_owned(ch);
  if (c->c.cq != nullptr) {
    // Unhook from the queue's deadline scan first: a tpr_cq_next thread may
    // be mid-expiry holding `c` (cq_pins) — wait for it, bounded, with the
    // same leak-over-UAF policy as internal_users below.
    tpr_cq *cq = c->c.cq;
    std::unique_lock<std::mutex> lk(cq->mu);
    cq->timed_calls.erase(c);
    cq->cv.wait_for(lk, std::chrono::seconds(30),
                    [&] { return c->c.cq_pins == 0; });
    if (c->c.cq_pins != 0) return;  // pathological: leak beats corruption
  }
  {
    std::unique_lock<std::mutex> lk(ch->mu);
    ch->streams.erase(c->c.stream_id);
    // A cancel/deadline thread may still be inside its (possibly stuck)
    // RST send holding `c`; freeing now would be a use-after-free when it
    // resumes. Wait for it to drain — bounded: if the send is wedged past
    // any reasonable socket stall, deliberately leak the call object (a
    // leak on a pathological connection beats heap corruption).
    bool drained = ch->cv.wait_for(lk, std::chrono::seconds(30), [&] {
      return c->c.internal_users == 0;
    });
    if (!drained) return;  // leak: racer still holds `c`
  }
  delete c;
}

void tpr_buf_free(uint8_t *data) { free(data); }

int tpr_unary_call_ex(tpr_channel *ch, const char *method, const uint8_t *req,
                      size_t req_len, uint8_t **resp, size_t *resp_len,
                      char *details, size_t details_cap, int timeout_ms,
                      int *preexec) {
  // *preexec==1 marks the three early returns below — the ONLY failures
  // where the complete request provably never left this process (admission
  // refusal, or fd_write_all/ring write returning false, which leaves at
  // least the trailing END_STREAM byte unsent so no unary handler can have
  // run). Everything past the send is 0: a handler may have executed.
  if (preexec) *preexec = 0;
  tpr_call *c;
  if (req_len <= kSmallUnaryMax) {
    // small-unary fast path: HEADERS + MESSAGE|END_STREAM leave in ONE
    // write (one syscall / one ring message+notify). Two separate writes
    // cost a second wakeup on both sides — measured as the native unary
    // path LOSING to the Python client (which batches) on loopback.
    c = tpr_call_start_buffered(ch, method, timeout_ms, req, req_len);
    if (!c) {
      if (details && details_cap)
        snprintf(details, details_cap, "channel dead or send failed");
      if (preexec) *preexec = 1;
      return TPR_UNAVAILABLE;
    }
  } else {
    c = tpr_call_start(ch, method, nullptr, 0, timeout_ms);
    if (!c) {
      if (details && details_cap)
        snprintf(details, details_cap, "channel dead");
      if (preexec) *preexec = 1;
      return TPR_UNAVAILABLE;
    }
    if (tpr_call_send(c, req, req_len, /*end_stream=*/1) != 0) {
      tpr_call_destroy(c);
      if (details && details_cap)
        snprintf(details, details_cap, "send failed");
      if (preexec) *preexec = 1;
      return TPR_UNAVAILABLE;
    }
  }
  uint8_t *data = nullptr;
  size_t len = 0;
  int got = tpr_call_recv(c, &data, &len);
  int code = tpr_call_finish(c, details, details_cap);
  // Admission refusal (kRst|kFlagRefused, e.g. a max_age GOAWAY race): the
  // SERVER certifies no handler ran, so the failure is replay-safe even
  // though the request left this process. finish() returned, so the RST was
  // fully processed before this read (no torn state).
  if (preexec && code != TPR_OK && c->c.refused) *preexec = 1;
  if (code == TPR_OK && got == 1) {
    *resp = data;
    *resp_len = len;
  } else if (got == 1) {
    tpr_buf_free(data);
  } else if (code == TPR_OK) {
    code = TPR_INTERNAL;  // OK status but no response message
    if (details && details_cap) snprintf(details, details_cap, "no response");
  }
  tpr_call_destroy(c);
  return code;
}

int tpr_unary_call(tpr_channel *ch, const char *method, const uint8_t *req,
                   size_t req_len, uint8_t **resp, size_t *resp_len,
                   char *details, size_t details_cap, int timeout_ms) {
  return tpr_unary_call_ex(ch, method, req, req_len, resp, resp_len, details,
                           details_cap, timeout_ms, nullptr);
}

/* -- completion-queue async API ------------------------------------------- */

tpr_cq *tpr_cq_create(void) { return new tpr_cq(); }

void tpr_cq_shutdown(tpr_cq *cq) {
  {
    std::lock_guard<std::mutex> lk(cq->mu);
    cq->shut = true;
  }
  cq->cv.notify_all();
}

void tpr_cq_destroy(tpr_cq *cq) { delete cq; }

static void fill_event(tpr_event *ev, CqEvent &e) {
  ev->type = e.type;
  ev->tag = e.tag;
  ev->ok = e.ok;
  ev->data = nullptr;
  ev->len = 0;
  if (e.has_data) {
    ev->len = e.data.size();
    ev->data = static_cast<uint8_t *>(malloc(e.data.size() ? e.data.size() : 1));
    memcpy(ev->data, e.data.data(), e.data.size());
  }
  ev->status = e.status;
  size_t n = e.details.size();
  if (n >= sizeof ev->details) n = sizeof ev->details - 1;
  memcpy(ev->details, e.details.data(), n);
  ev->details[n] = '\0';
}

int tpr_cq_next(tpr_cq *cq, tpr_event *ev, int timeout_ms) {
  const bool bounded = timeout_ms > 0;
  const auto overall = Clock::now() + std::chrono::milliseconds(
                                          bounded ? timeout_ms : 0);
  std::unique_lock<std::mutex> lk(cq->mu);
  while (true) {
    // Deadline enforcement FIRST, even with events queued: on a busy queue
    // the early return would otherwise starve expiries indefinitely — the
    // puller is the timer thread, so expiry latency must be bounded by one
    // cq_next call, not by traffic quiescence.
    tpr_call *expired = nullptr;
    auto earliest = Clock::time_point::max();
    const auto now = Clock::now();
    for (auto it = cq->timed_calls.begin(); it != cq->timed_calls.end();) {
      tpr_call *tc = *it;
      if (tc->c.done.load()) {  // finished normally; drop from the scan
        it = cq->timed_calls.erase(it);
        continue;
      }
      if (tc->c.deadline <= now) {
        expired = tc;
        break;
      }
      if (tc->c.deadline < earliest) earliest = tc->c.deadline;
      ++it;
    }
    if (expired != nullptr) {
      expired->c.cq_pins++;  // pins `expired` across the unlocked expiry
      lk.unlock();
      cq_expire(expired, TPR_DEADLINE_EXCEEDED, "deadline exceeded (client)");
      lk.lock();
      expired->c.cq_pins--;
      cq->timed_calls.erase(expired);
      cq->cv.notify_all();  // a destroy may be waiting for the pin drain
      continue;             // cq_expire queued this call's completions
    }
    if (!cq->q.empty()) {
      fill_event(ev, cq->q.front());
      cq->q.pop_front();
      return 1;
    }
    if (cq->shut) {
      memset(ev, 0, sizeof *ev);
      ev->type = TPR_EV_SHUTDOWN;
      return -1;
    }
    if (bounded && Clock::now() >= overall) return 0;
    auto wake = earliest;
    if (bounded && overall < wake) wake = overall;
    if (wake == Clock::time_point::max())
      cq->cv.wait(lk);
    else
      cq->cv.wait_until(lk, wake);
  }
}

tpr_call *tpr_call_start_cq(tpr_channel *ch, const char *method,
                            const char *const *metadata, size_t n_md,
                            int timeout_ms, tpr_cq *cq) {
  if (ch->inline_read) return nullptr;  // CQ needs the reader thread
  {
    std::lock_guard<std::mutex> lk(cq->mu);
    if (cq->shut) return nullptr;
  }
  std::string payload;
  tpr_call *call = register_call(ch, method, metadata, n_md, timeout_ms,
                                 &payload);
  if (call == nullptr) return nullptr;
  {
    std::lock_guard<std::mutex> lk(ch->mu);
    call->c.cq = cq;  // before HEADERS leave: the reader reads it under mu
  }
  if (!ch->send_frame(kHeaders, 0, call->c.stream_id, payload.data(),
                      payload.size())) {
    unregister_call(ch, call);
    return nullptr;
  }
  if (call->c.has_deadline) {
    // Notify: an already-parked tpr_cq_next must recompute its wake time
    // around the new deadline or it sleeps through the expiry.
    std::lock_guard<std::mutex> lk(cq->mu);
    cq->timed_calls.insert(call);
    cq->cv.notify_all();
  }
  return call;
}

// A shut queue refuses new ops (client.h contract): once tpr_cq_next has
// returned -1 the app may destroy the queue, so accepting a late op would
// let a future delivery write into freed memory.
static bool cq_refused(tpr_cq *cq) {
  std::lock_guard<std::mutex> lk(cq->mu);
  return cq->shut;
}

int tpr_call_recv_cq(tpr_call *c, void *tag) {
  if (c->c.cq == nullptr || cq_refused(c->c.cq)) return -1;
  tpr_channel *ch = c->c.ch;
  CqDeliveries evs;
  {
    std::lock_guard<std::mutex> lk(ch->mu);
    c->c.recv_tags.push_back(tag);
    drain_cq_locked(c->c, &evs);  // may complete immediately
    cq_push(&evs);
  }
  return 0;
}

int tpr_call_finish_cq(tpr_call *c, void *tag) {
  if (c->c.cq == nullptr || cq_refused(c->c.cq)) return -1;
  tpr_channel *ch = c->c.ch;
  CqDeliveries evs;
  {
    std::lock_guard<std::mutex> lk(ch->mu);
    if (c->c.finish_armed) return -1;  // at most one finish op per call
    c->c.finish_armed = true;
    c->c.finish_tag = tag;
    drain_cq_locked(c->c, &evs);
    cq_push(&evs);
  }
  return 0;
}

tpr_call *tpr_unary_call_cq(tpr_channel *ch, const char *method,
                            const uint8_t *req, size_t req_len,
                            int timeout_ms, tpr_cq *cq, void *tag) {
  if (ch->inline_read) return nullptr;  // CQ needs the reader thread
  {
    std::lock_guard<std::mutex> lk(cq->mu);
    if (cq->shut) return nullptr;
  }
  std::string hdr_payload;
  tpr_call *call = register_call(ch, method, nullptr, 0, timeout_ms,
                                 &hdr_payload);
  if (call == nullptr) return nullptr;
  bool timed = call->c.has_deadline;
  {
    // Arm BEFORE the request leaves: the response may race back and be
    // delivered by the reader in the gap after the send returns. Also pin
    // the call (internal_users) — once the completion is deliverable, a
    // puller thread may legally tpr_call_destroy it before this thread
    // runs again, and destroy must wait for us (it already waits for the
    // cancel path's pin on the same counter).
    std::lock_guard<std::mutex> lk(ch->mu);
    call->c.cq = cq;
    call->c.unary_armed = true;
    call->c.unary_tag = tag;
    call->c.internal_users++;
  }
  if (timed) {
    // Register before bytes leave (never touch `call` after the send
    // succeeds); notify so an already-parked tpr_cq_next recomputes its
    // wake time around the new deadline.
    std::lock_guard<std::mutex> lk(cq->mu);
    cq->timed_calls.insert(call);
    cq->cv.notify_all();
  }
  bool shipped;
  if (req_len <= kSmallUnaryMax) {
    shipped = ship_buffered(ch, call, hdr_payload, req, req_len);
  } else {
    shipped = ch->send_frame(kHeaders, 0, call->c.stream_id,
                             hdr_payload.data(), hdr_payload.size()) &&
              tpr_call_send(call, req, req_len, /*end_stream=*/1) == 0;
  }
  bool handed_off;
  {
    std::unique_lock<std::mutex> lk(ch->mu);
    call->c.internal_users--;
    // On failure: if die() already delivered the UNAVAILABLE completion,
    // hand the call back so the app's event handling destroys it;
    // otherwise suppress delivery and tear the call down ourselves.
    handed_off = shipped || (call->c.trailers_seen && !call->c.unary_armed);
    if (!handed_off) call->c.unary_armed = false;
  }
  ch->cv.notify_all();  // a destroy may be waiting on the pin drain
  if (handed_off) return call;
  if (timed) {
    // Mirror tpr_call_destroy's unhook for a call the app never saw: a
    // cq_next thread may hold it pinned mid-expiry.
    std::unique_lock<std::mutex> lk(cq->mu);
    cq->timed_calls.erase(call);
    cq->cv.wait_for(lk, std::chrono::seconds(30),
                    [&] { return call->c.cq_pins == 0; });
    if (call->c.cq_pins != 0) return nullptr;  // leak beats corruption
  }
  unregister_call(ch, call);
  return nullptr;
}

}  // extern "C"
