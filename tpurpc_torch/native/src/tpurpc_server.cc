// tpurpc C server implementation — native app servers over the framing.
//
// Wire format: tpurpc_torch/rpc/frame.py via framing_common.h.
//
// Threading model (round 4, replacing thread-per-connection): connections
// are multiplexed over a FIXED set of poller threads — the role of the
// reference's Poller (src/core/lib/ibverbs/poller.cc:52-106, which
// round-robins up to 4096 pairs over N background threads). Each poller
// owns an epoll set of its connections' event fds (the TCP data fd, or the
// ring's notify fd) and parses frames INCREMENTALLY per connection, so one
// thread serves any number of connections and a 128-connection fan-in
// costs 1 poller + handler threads, not 128 readers. The accept loop only
// accepts; a short-lived thread per NEW connection runs the (blocking,
// bounded) protocol sniff + ring bootstrap, then hands the connection to a
// poller and exits.
//
// Call dispatch is unchanged: frames demux to per-stream call objects
// (tpurpc Python channels multiplex concurrent calls over one connection);
// callback-API handlers run inline on the poller thread; handler-API calls
// run on a thread each (they block in tpr_srv_recv). The reference's
// equivalent machinery is src/cpp/server/ + surface/server.cc's
// registered-method dispatch, collapsed to tpurpc scale.

#include "../include/tpurpc/server.h"

#include "ring_transport.h"

#include <arpa/inet.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <pthread.h>
#include <sched.h>
#include <sys/epoll.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdio>
#include <cstdlib>
#include <deque>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include "framing_common.h"
#include "tpr_obs.h"
#include "tpr_rdv.h"

using namespace tpr_wire;

namespace {
using Clock = std::chrono::steady_clock;
struct Conn;
}  // namespace

// Message accumulator backed by malloc from the start, so tpr_srv_recv can
// hand ownership straight to the handler (the tpr_srv_buf_free contract is
// free()) with ZERO copy — the old std::string deque paid a malloc+memcpy
// per delivered message, one full extra pass on the bulk path.
struct OwnedBuf {
  uint8_t *p = nullptr;
  size_t len = 0;
  size_t cap = 0;
  // true when p points into a rendezvous landing region (tpr_rdv): NOT a
  // malloc chunk — disposal must settle() (ring the doorbell / recycle),
  // never free(). tpr_srv_buf_free consults the same registry, so the
  // handler-facing contract is unchanged either way.
  bool ext = false;

  // move-only: a raw-owning struct that the compiler lets you copy is a
  // double free waiting for a maintainer (the container moves below are
  // the only ownership transfers)
  OwnedBuf() = default;
  OwnedBuf(const OwnedBuf &) = delete;
  OwnedBuf &operator=(const OwnedBuf &) = delete;
  OwnedBuf(OwnedBuf &&o) noexcept
      : p(o.p), len(o.len), cap(o.cap), ext(o.ext) {
    o.p = nullptr;
    o.len = o.cap = 0;
    o.ext = false;
  }
  OwnedBuf &operator=(OwnedBuf &&o) noexcept {
    if (this != &o) {
      dispose();
      p = o.p;
      len = o.len;
      cap = o.cap;
      ext = o.ext;
      o.p = nullptr;
      o.len = o.cap = 0;
      o.ext = false;
    }
    return *this;
  }
  ~OwnedBuf() { dispose(); }

  void dispose() {
    if (p == nullptr) return;
    if (!ext || !tpr_rdv::settle(p)) free(p);
    p = nullptr;
  }

  // take ownership of an existing buffer: a malloc chunk (rdv=false) or a
  // delivered landing-region pointer (rdv=true)
  void adopt(uint8_t *buf, size_t n, bool rdv) {
    dispose();
    p = buf;
    len = cap = n;
    ext = rdv;
  }

  void append(const uint8_t *src, size_t n) {
    if (n == 0) return;  // empty message: memcpy(NULL,..,0) is still UB
    if (len + n > cap) {
      // 64-byte-aligned storage (freeable with free(), so the
      // tpr_srv_buf_free contract is unchanged): the tensor codec lays
      // leaves out on 64-byte offsets, so an aligned message base is what
      // lets the Python binding's dlpack import alias the receive buffer
      // into a torch.Tensor with zero copy — glibc's mmap'd malloc chunks sit
      // at 16 mod 64 and force a 4 MiB landing copy per message.
      // aligned_alloc can't mremap-grow like realloc, so fragmented
      // messages (a MORE first fragment) reserve 8x the fragment upfront:
      // one allocation covers the whole message for anything ≤ 8 frames,
      // and the doubling copy is the rare tail, not the steady state.
      size_t want = cap ? cap * 2 : (n > 4096 ? n * 8 : 4096);
      while (want < len + n) want *= 2;
      uint8_t *np = static_cast<uint8_t *>(aligned_alloc(64, want));
      if (np == nullptr) abort();  // OOM: same fate as the old path's
      if (len) memcpy(np, p, len);  // uncaught bad_alloc, without the UB
      free(p);
      p = np;
      cap = want;
    }
    memcpy(p + len, src, n);
    len += n;
  }

  // hand the malloc'd buffer to the caller (who frees with free())
  uint8_t *release(size_t *out_len) {
    uint8_t *out = p ? p : static_cast<uint8_t *>(malloc(1));
    *out_len = len;
    p = nullptr;
    len = cap = 0;
    return out;
  }

  void reset() { *this = OwnedBuf(); }
};

struct tpr_server_call {
  Conn *conn = nullptr;
  uint32_t stream_id = 0;
  std::string method;
  int64_t deadline_us = INT64_MAX;  // absolute, vs Clock epoch
  std::string details;
  //: every request header except :path/:timeout-us (exposed to handlers —
  //: the invocation_metadata a language-level server needs)
  std::vector<std::pair<std::string, std::string>> md;
  //: queued initial metadata; shipped as a HEADERS frame before the first
  //: response message
  std::vector<std::pair<std::string, std::string>> initial_md;
  bool initial_md_sent = false;
  //: custom trailing metadata appended to the final trailers
  std::vector<std::pair<std::string, std::string>> trailing_md;

  // reader/poller-filled state, guarded by conn->mu
  std::deque<OwnedBuf> pending;  // complete messages (malloc-backed)
  OwnedBuf partial;              // MORE-fragment accumulator
  bool half_closed = false;      // client END_STREAM seen
  bool cancelled = false;        // RST / connection death

  // callback-API calls: handled inline on the poller thread (no thread,
  // no pending queue — each complete message goes straight to the cb)
  int (*inline_cb)(tpr_server_call *, const uint8_t *, size_t, void *) =
      nullptr;
  void *inline_ud = nullptr;

};

namespace {

struct Poller;

struct Conn {
  int fd = -1;
  // non-null when this connection bootstrapped the shm ring data plane
  // (client opened with the TRB1 magic): frames ride the ring, the fd
  // stays inside the transport as the notify channel
  tpr_ring::RingTransport *ring = nullptr;
  std::mutex write_mu;             // serializes whole frames
  std::mutex mu;                   // guards streams + call state
  std::condition_variable cv;      // signaled on any delivery
  std::map<uint32_t, tpr_server_call *> streams;
  std::atomic<bool> alive{true};
  std::atomic<bool> fd_closed{false};
  std::atomic<int> handler_threads{0};
  // rendezvous + ctrl-ring side of this connection (tpr_rdv.h); created at
  // bootstrap, armed only if the peer's hello negotiates
  tpr_rdv::Link *link = nullptr;
  // tpurpc-xray conn tag, interned once when bootstrap succeeds (the
  // tpr-obs static-tag discipline); 0 = plane off or never bootstrapped
  uint16_t otag_conn = 0;
  // delivery-shard items in flight for this conn: reap must wait for zero
  // (an item holds a raw Conn*)
  std::atomic<int> delivery_refs{0};
  //: teardown ran (streams failed, fd closed)
  std::atomic<bool> finished{false};
  //: safe to free: set only after the conn's poller can no longer hold a
  //: stale epoll event for it (end of the batch that finished it), or by
  //: non-poller finishers — reap requires it (frees must not race a
  //: same-batch duplicate event's `finished` load)
  std::atomic<bool> reapable{false};
  Poller *poller = nullptr;  // the poller serving this conn (post-bootstrap)

  // -- incremental frame parse (poller-thread-owned) -----------------------
  uint8_t hdr[10];
  size_t got = 0;            // bytes of the CURRENT unit (header or payload)
  bool in_payload = false;
  uint8_t f_type = 0, f_flags = 0;
  uint32_t f_sid = 0;
  size_t f_len = 0;
  std::vector<uint8_t> payload;

  ~Conn() {
    delete link;  // ~Link closes: discards leases, unmaps rings/windows
    if (ring) {
      ring->close();
      delete ring;
    }
  }

  int event_fd() const { return ring ? ring->event_fd() : fd; }

  bool write_all(const void *buf, size_t len) {
    return ring ? ring->write_all(buf, len) : fd_write_all(fd, buf, len);
  }

  bool read_exact(void *buf, size_t len) {
    return ring ? ring->read_exact(buf, len) : fd_read_exact(fd, buf, len);
  }

  // Nonblocking byte-stream read for the poller: >0 bytes, 0 would-block,
  // -1 dead. TCP uses MSG_DONTWAIT (the fd itself stays blocking so
  // handler-thread WRITES keep their simple semantics).
  ssize_t read_some(void *buf, size_t max) {
    if (ring) return ring->read_some(buf, max);
    ssize_t n = ::recv(fd, buf, max, MSG_DONTWAIT);
    if (n > 0) return n;
    if (n == 0) return -1;  // EOF
    return (errno == EAGAIN || errno == EWOULDBLOCK || errno == EINTR) ? 0
                                                                       : -1;
  }

  bool send_frame(uint8_t type, uint8_t flags, uint32_t sid,
                  const void *payload_, size_t len) {
    std::lock_guard<std::mutex> lk(write_mu);
    if (fd_closed.load()) return false;
    bool ok = ring  // one gathered ring message + one notify per frame
                  ? ring_send_frame_locked(*ring, type, flags, sid,
                                           payload_, len)
                  : t_send_frame_locked(*this, type, flags, sid, payload_,
                                        len);
    // EVERY frame actually written counts (ctrl-ring records stamp this
    // value as their ordering gate; an overcount would strand records)
    if (ok && link) link->frames_sent.fetch_add(1, std::memory_order_release);
    return ok;
  }

  void send_trailers(uint32_t sid, int code, const std::string &details,
                     const std::vector<std::pair<std::string, std::string>>
                         *extra_md = nullptr) {
    std::vector<std::pair<std::string, std::string>> md;
    md.emplace_back(":status", std::to_string(code));
    if (!details.empty()) md.emplace_back(":message", details);
    if (extra_md)
      for (const auto &kv : *extra_md) md.push_back(kv);
    std::string payload_ = encode_metadata(md);
    send_frame(kTrailers, kFlagEndStream, sid, payload_.data(),
               payload_.size());
  }

  void finish_call_trailers(tpr_server_call *call, int code) {
    send_trailers(call->stream_id, code, call->details,
                  call->trailing_md.empty() ? nullptr : &call->trailing_md);
  }

  void close_fd() {
    // write_mu excludes a concurrent send_frame mid-write on the dying fd;
    // the flag (checked under write_mu) prevents double close / fd reuse.
    std::lock_guard<std::mutex> lk(write_mu);
    if (!fd_closed.exchange(true)) {
      if (ring) ring->shutdown();  // exit word + notify before fd close
      ::close(fd);
    }
  }

  void shutdown_fd() {
    // Same discipline as close_fd: the check and the shutdown must be one
    // critical section, or a racing close_fd can recycle the fd number
    // between them and this shutdown() hits an unrelated descriptor.
    std::lock_guard<std::mutex> lk(write_mu);
    if (!fd_closed.load()) {
      if (ring) ring->shutdown();
      ::shutdown(fd, SHUT_RDWR);
    }
  }
};

// One epoll loop serving N connections (the reference Poller role). Conns
// are added via a locked pending list + wake pipe (epoll_ctl from another
// thread is safe, but the add must also trigger an initial pump — ring
// data that landed during bootstrap sends no further notify token).
struct Poller {
  int epfd = -1;
  int wake_r = -1, wake_w = -1;
  std::thread th;
  std::mutex add_mu;
  std::vector<Conn *> pending_add;
  std::atomic<bool> running{true};
  tpr_server *srv = nullptr;

  bool init() {
    epfd = ::epoll_create1(0);
    if (epfd < 0) return false;
    int p[2];
    if (::pipe(p) != 0) return false;
    wake_r = p[0];
    wake_w = p[1];
    ::fcntl(wake_r, F_SETFL, O_NONBLOCK);  // drain loop must never block
    struct epoll_event ev = {};
    ev.events = EPOLLIN;
    ev.data.ptr = nullptr;  // null = wake pipe
    ::epoll_ctl(epfd, EPOLL_CTL_ADD, wake_r, &ev);
    return true;
  }

  void add(Conn *c) {
    // From adoption on, this epoll loop is the fd's only reader: blocked
    // writers (handler responses waiting for credits) must park on the
    // transport cv, not steal request tokens out of epoll's mouth
    // (ring_transport.h wait_event epoll_owned).
    if (c->ring) c->ring->epoll_owned.store(true);
    {
      std::lock_guard<std::mutex> lk(add_mu);
      pending_add.push_back(c);
    }
    char b = 'a';
    (void)!::write(wake_w, &b, 1);
  }

  void wake() {
    char b = 'w';
    (void)!::write(wake_w, &b, 1);
  }

  void stop_and_join() {
    running.store(false);
    wake();
    if (th.joinable()) th.join();
    if (epfd >= 0) ::close(epfd);
    if (wake_r >= 0) ::close(wake_r);
    if (wake_w >= 0) ::close(wake_w);
  }

  void loop();  // defined after tpr_server (needs dispatch)
};

}  // namespace

struct tpr_server {
  int listen_fd = -1;
  int port = 0;
  std::atomic<bool> running{false};
  std::thread accept_thread;
  std::map<std::string, std::pair<tpr_handler_fn, void *>> handlers;
  std::map<std::string, std::pair<tpr_msg_cb, void *>> cb_handlers;
  tpr_handler_fn default_handler = nullptr;  // unknown-method fallback
  void *default_ud = nullptr;
  std::mutex conns_mu;
  std::vector<Conn *> conns;
  std::vector<Poller *> pollers;
  std::atomic<size_t> next_poller{0};
  std::atomic<int> bootstrap_threads{0};

  // -- delivery shard (tentpole 3): decode/materialization off the poller --
  // On negotiated connections (and when enabled — TPURPC_NATIVE_DELIVERY,
  // auto = on with >= 2 cores) completed messages, half-closes and RSTs go
  // through ONE FIFO drained by a dedicated thread, so the poller does
  // nothing but land bytes and publish. Rendezvous deliveries ride the same
  // queue, which is what keeps framed and rdv messages of one stream in
  // order. Items pin their Conn via delivery_refs (reap waits for zero).
  struct DeliveryItem {
    Conn *c;
    uint32_t sid;
    uint8_t flags;
    uint8_t *data;  // malloc (rdv=false) or landing region (rdv=true)
    size_t len;
    bool rdv;
    bool rst;
  };
  std::thread delivery_th;
  std::mutex dq_mu;
  std::condition_variable dq_cv;
  std::deque<DeliveryItem> dq;
  std::atomic<bool> delivery_on{false};
  bool dq_stop = false;
  // tpurpc-xray delivery-shard backlog tracking (both under dq_mu): the
  // stall edge fires on a high-water crossing, clears below low water, so
  // a busy-but-draining queue emits nothing
  uint16_t otag_dlv = 0;
  bool dlv_stalled = false;
  static constexpr size_t kDlvHighWater = 64;
  static constexpr size_t kDlvLowWater = 8;

  static bool delivery_from_env() {
    const char *v = getenv("TPURPC_NATIVE_DELIVERY");
    if (v) {
      if (strcmp(v, "0") == 0 || strcasecmp(v, "off") == 0 ||
          strcasecmp(v, "false") == 0)
        return false;
      if (strcasecmp(v, "auto") != 0) return true;
    }
    // the measured reason the memcpy gate was inapplicable on 1 core: a
    // shard there just adds a handoff to the only hart
    return std::thread::hardware_concurrency() >= 2;
  }

  static void dispose_payload(uint8_t *data, bool rdv) {
    if (data == nullptr) return;
    if (!rdv || !tpr_rdv::settle(data)) free(data);
  }

  void enqueue_delivery(Conn *c, uint32_t sid, uint8_t flags, uint8_t *data,
                        size_t len, bool rdv, bool rst = false) {
    c->delivery_refs.fetch_add(1);
    {
      std::lock_guard<std::mutex> lk(dq_mu);
      dq.push_back(DeliveryItem{c, sid, flags, data, len, rdv, rst});
      size_t depth = dq.size();
      tpr_obs::metric_add(tpr_obs::kMetDlvEnqueued);
      tpr_obs::metric_store(tpr_obs::kMetDlvDepth, depth);
      if (depth >= kDlvHighWater && !dlv_stalled && otag_dlv) {
        dlv_stalled = true;
        tpr_obs::metric_add(tpr_obs::kMetDlvStalls);
        TPR_OBS(tpr_obs::kEvDlvStallBegin, otag_dlv, depth, 0);
      }
    }
    dq_cv.notify_one();
  }

  // The single delivery entry: runs on the shard when enabled, inline on
  // the poller otherwise. data==nullptr is a pure marker (half-close/RST).
  void deliver_msg(Conn *c, uint32_t sid, uint8_t flags, uint8_t *data,
                   size_t len, bool rdv, bool rst) {
    if (c->finished.load()) {  // conn tore down with this item in flight
      dispose_payload(data, rdv);
      return;
    }
    std::unique_lock<std::mutex> lk(c->mu);
    auto it = c->streams.find(sid);
    if (it == c->streams.end()) {
      lk.unlock();
      dispose_payload(data, rdv);
      return;
    }
    tpr_server_call *call = it->second;
    if (rst) {
      if (call->inline_cb) {
        c->streams.erase(it);
        lk.unlock();
        delete call;
      } else {
        call->cancelled = true;
        lk.unlock();
        c->cv.notify_all();
      }
      return;
    }
    if (call->inline_cb) {
      lk.unlock();
      int code = 0;
      if (data != nullptr) {
        // the cb borrows the buffer (region or malloc) for the call only
        code = call->inline_cb(call, data, len, call->inline_ud);
        dispose_payload(data, rdv);
      }
      if (code < 0) code = 13;
      if (code != 0 || (flags & kFlagEndStream)) {
        {
          std::lock_guard<std::mutex> lk2(c->mu);
          c->streams.erase(sid);
        }
        c->finish_call_trailers(call, code);
        delete call;
      }
      return;
    }
    if (data != nullptr) {
      OwnedBuf b;
      b.adopt(data, len, rdv);
      call->pending.push_back(std::move(b));
    }
    if (flags & kFlagEndStream) call->half_closed = true;
    lk.unlock();
    c->cv.notify_all();
  }

  void delivery_loop() {
    for (;;) {
      DeliveryItem item;
      {
        std::unique_lock<std::mutex> lk(dq_mu);
        dq_cv.wait(lk, [&] { return dq_stop || !dq.empty(); });
        if (dq.empty()) return;  // stop requested and fully drained
        item = dq.front();
        dq.pop_front();
        size_t depth = dq.size();
        tpr_obs::metric_store(tpr_obs::kMetDlvDepth, depth);
        if (dlv_stalled && depth <= kDlvLowWater) {
          dlv_stalled = false;
          TPR_OBS(tpr_obs::kEvDlvStallEnd, otag_dlv, depth, 0);
        }
      }
      deliver_msg(item.c, item.sid, item.flags, item.data, item.len,
                  item.rdv, item.rst);
      tpr_obs::metric_add(tpr_obs::kMetDlvDrained);
      item.c->delivery_refs.fetch_sub(1);
    }
  }

  static int poller_count_from_env() {
    const char *v = getenv("TPURPC_SERVER_POLLERS");
    if (!v) v = getenv("GRPC_RDMA_POLLER_THREAD_NUM");
    int n = v ? atoi(v) : 1;
    if (n < 1) n = 1;
    if (n > 64) n = 64;
    return n;
  }

  void run_handler(Conn *c, tpr_server_call *call) {
    auto it = handlers.find(call->method);
    int code;
    if (it != handlers.end()) {
      code = it->second.first(call, it->second.second);
    } else if (default_handler != nullptr) {
      code = default_handler(call, default_ud);
    } else {
      code = 12;  // UNIMPLEMENTED
      call->details = "unknown method " + call->method;
    }
    bool was_cancelled;
    {
      std::lock_guard<std::mutex> lk(c->mu);
      was_cancelled = call->cancelled;
      c->streams.erase(call->stream_id);
    }
    if (!was_cancelled) c->finish_call_trailers(call, code);
    delete call;
    c->handler_threads.fetch_sub(1);
  }

  // Protocol sniff + preface, mirroring the Python listener (peek_protocol,
  // endpoint.py): ring clients open with the 4-byte TRB1 bootstrap magic;
  // plain framing clients send the 8-byte TPURPC preface. Runs BLOCKING on
  // the short-lived bootstrap thread (bounded by the client's handshake).
  // `preread` replays sniff bytes an adopting caller already consumed.
  bool accept_preface(Conn *c, const uint8_t *preread, size_t preread_len) {
    char magic[8];
    size_t have = preread_len < 4 ? preread_len : 4;
    if (have) memcpy(magic, preread, have);
    if (have < 4 && !fd_read_exact(c->fd, magic + have, 4 - have))
      return false;
    if (memcmp(magic, "TRB1", 4) == 0) {
      auto *rt = new tpr_ring::RingTransport();
      std::string err;
      if (!rt->bootstrap(c->fd, tpr_wire::ring_size_from_env(),
                         /*preread_magic=*/true, &err)) {
        fprintf(stderr, "tpurpc server: ring bootstrap failed: %s\n",
                err.c_str());
        rt->close();
        delete rt;
        return false;
      }
      c->ring = rt;
      // the framing preface now rides the ring byte stream
      return c->read_exact(magic, 8) && memcmp(magic, kMagic, 8) == 0;
    }
    return fd_read_exact(c->fd, magic + 4, 4) &&
           memcmp(magic, kMagic, 8) == 0;
  }

  // Dispatch one complete frame for `c`. Mirrors the pre-rework
  // serve_conn body; returns false when the connection must end.
  bool on_frame(Conn *c, uint8_t type, uint8_t flags, uint32_t sid,
                std::vector<uint8_t> &payload) {
    if (type >= kRdvOffer && type <= kCtrlKick) {
      // rendezvous/ctrl control ladder: the link consumes these (framed
      // fallback ops, or a kick for our parked ring)
      if (c->link) c->link->on_frame(type, sid, payload.data(),
                                     payload.size());
      return true;
    }
    if (type == kPing) {
      // capability hello rides the PING payload; the echo below doubles
      // as the hello ack either way
      if (c->link) c->link->maybe_hello(payload.data(), payload.size());
      c->send_frame(kPong, 0, 0, payload.data(), payload.size());
      return true;
    }
    if (type == kMessage && c->link && c->link->negotiated.load()) {
      // framed message bytes on a rendezvous-capable conn = host landing
      // copies the ladder did NOT absorb (the ledger the smoke checks)
      tpr_rdv::count(tpr_rdv::kCtrHostCopyBytes, payload.size());
    }
    if (type == kHeaders) {
      std::vector<std::pair<std::string, std::string>> md;
      if (!decode_metadata(payload.data(), payload.size(), &md)) return false;
      auto *call = new tpr_server_call();
      call->conn = c;
      call->stream_id = sid;
      for (auto &kv : md) {
        if (kv.first == ":path") {
          call->method = kv.second;
        } else if (kv.first == ":timeout-us") {
          call->deadline_us =
              std::chrono::duration_cast<std::chrono::microseconds>(
                  Clock::now().time_since_epoch()).count() +
              atoll(kv.second.c_str());
        } else {
          call->md.emplace_back(kv.first, kv.second);
        }
      }
      bool duplicate;
      {
        std::lock_guard<std::mutex> lk(c->mu);
        duplicate = c->streams.count(sid) != 0;
        if (!duplicate) c->streams[sid] = call;
      }
      if (duplicate) {
        // duplicate HEADERS on an active sid: protocol violation —
        // overwriting would orphan one call's frame routing forever
        c->send_trailers(sid, 13, "duplicate stream id");  // INTERNAL
        delete call;
        return true;
      }
      auto cb_it = cb_handlers.find(call->method);
      if (cb_it != cb_handlers.end()) {
        // callback API: no thread — messages dispatch inline below
        call->inline_cb = cb_it->second.first;
        call->inline_ud = cb_it->second.second;
        if (flags & kFlagEndStream) {  // empty call: trailers now
          {
            std::lock_guard<std::mutex> lk2(c->mu);
            c->streams.erase(sid);
          }
          c->finish_call_trailers(call, 0);
          delete call;
        }
        return true;
      }
      c->handler_threads.fetch_add(1);
      std::thread([this, c, call] { run_handler(c, call); }).detach();
      return true;
    }
    // frame for an existing stream
    if (type == kMessage && (flags & kFlagCompressed)) {
      // loud protocol rejection: this loop has no decompressor, and
      // delivering gzip bytes as the message would corrupt the app
      std::unique_lock<std::mutex> lk(c->mu);
      auto it = c->streams.find(sid);
      if (it != c->streams.end()) {
        tpr_server_call *call = it->second;
        // Erase the stream NOW in both branches: a fragmented compressed
        // message delivers kFlagCompressed on every fragment, and later
        // fragments must fall into the finished/unknown drop instead of
        // re-sending these trailers. The details text must keep
        // "compressed messages unsupported" as a substring — the Python
        // channel's compression negotiation keys on it
        // (tpurpc_torch/rpc/frame.py COMPRESSED_UNSUPPORTED_SENTINEL).
        c->streams.erase(it);
        if (call->inline_cb) {
          lk.unlock();
          c->send_trailers(sid, 12 /*UNIMPLEMENTED*/,
                           "compressed messages unsupported here");
          delete call;
        } else {
          call->cancelled = true;  // handler exits; run_handler frees
          lk.unlock();
          c->send_trailers(sid, 12 /*UNIMPLEMENTED*/,
                           "compressed messages unsupported here");
          c->cv.notify_all();
        }
      }
      return true;
    }
    std::unique_lock<std::mutex> lk(c->mu);
    auto it = c->streams.find(sid);
    if (it == c->streams.end()) return true;  // finished/unknown: drop
    tpr_server_call *call = it->second;
    if (delivery_on.load() && c->link && c->link->negotiated.load() &&
        (type == kMessage || type == kRst)) {
      // Shard routing: on negotiated conns the poller only LANDS bytes —
      // completed messages, half-closes and RSTs flow through the delivery
      // FIFO, which is also where rendezvous completions surface, so the
      // two kinds of message stay in their arrival order and no inline cb
      // ever runs concurrently on two threads for one call. (The fragment
      // accumulator stays poller-owned; touching it under c->mu here
      // excludes the shard's erase-then-delete.)
      if (type == kRst) {
        lk.unlock();
        enqueue_delivery(c, sid, flags, nullptr, 0, false, /*rst=*/true);
        return true;
      }
      const bool has_payload = !(flags & kFlagNoMessage);
      const bool complete = has_payload && !(flags & kFlagMore);
      uint8_t *buf = nullptr;
      size_t blen = 0;
      bool have_msg = false;
      if (has_payload) {
        if (complete && call->partial.len == 0) {
          blen = payload.size();
          buf = static_cast<uint8_t *>(malloc(blen ? blen : 1));
          if (buf == nullptr) abort();  // OOM: accumulator path's fate too
          if (blen) memcpy(buf, payload.data(), blen);
          have_msg = true;
        } else {
          call->partial.append(payload.data(), payload.size());
          if (complete) {
            buf = call->partial.release(&blen);
            have_msg = true;
          }
        }
      }
      lk.unlock();
      if (have_msg)
        enqueue_delivery(c, sid, flags, buf, blen, /*rdv=*/false);
      else if (flags & kFlagEndStream)  // pure half-close marker
        enqueue_delivery(c, sid, flags, nullptr, 0, /*rdv=*/false);
      return true;
    }
    if (call->inline_cb) {
      // reactor path: complete messages run the cb ON THIS THREAD;
      // teardown is immediate at RST/half-close/nonzero-return. Only the
      // poller touches inline calls, so the lock is released first.
      lk.unlock();
      bool finished = false;
      bool rst = false;
      int code = 0;
      if (type == kRst) {
        finished = rst = true;  // cancelled: client left, no trailers
      } else if (type == kMessage) {
        const bool has_payload = !(flags & kFlagNoMessage);
        const bool complete = has_payload && !(flags & kFlagMore);
        if (complete && call->partial.len == 0) {
          // common case: whole message in one frame — feed the cb the
          // frame buffer directly, no accumulator alloc/copy
          code = call->inline_cb(call, payload.data(), payload.size(),
                                 call->inline_ud);
        } else {
          if (has_payload)
            call->partial.append(payload.data(), payload.size());
          if (complete) {
            code = call->inline_cb(call, call->partial.p,
                                   call->partial.len, call->inline_ud);
            call->partial.reset();
          }
        }
        // negative returns are app errors, not a protocol escape hatch:
        // map them to INTERNAL so the client always gets trailers
        if (code < 0) code = 13;
        if (code != 0 || (flags & kFlagEndStream)) finished = true;
      }
      if (finished) {
        {
          std::lock_guard<std::mutex> lk2(c->mu);
          c->streams.erase(sid);
        }
        if (!rst) c->finish_call_trailers(call, code);
        delete call;
      }
      return true;
    }
    if (type == kRst) {
      call->cancelled = true;
    } else if (type == kMessage) {
      if (!(flags & kFlagNoMessage))
        call->partial.append(payload.data(), payload.size());
      if (!(flags & kFlagMore) && !(flags & kFlagNoMessage))
        call->pending.push_back(std::move(call->partial));
      if (flags & kFlagEndStream) call->half_closed = true;
    }
    lk.unlock();
    c->cv.notify_all();
    return true;
  }

  // Pump complete frames currently available on `c` (nonblocking), up to
  // a per-event budget so one saturating sender cannot starve the other
  // connections sharing this poller thread (fairness; the reference's
  // Poller round-robins its slot array for the same reason,
  // poller.cc:52-106). Returns: -1 connection over, 0 drained dry,
  // 1 budget exhausted with data still pending (caller must re-pump —
  // the tokens that announced the remaining frames were already drained,
  // so no further epoll event is guaranteed).
  int pump_conn(Conn *c) {
    int budget = 256;
    while (true) {
      uint8_t *dst;
      size_t want;
      if (!c->in_payload) {
        dst = c->hdr + c->got;
        want = sizeof c->hdr - c->got;
      } else {
        dst = c->payload.data() + c->got;
        want = c->f_len - c->got;
      }
      if (want) {
        ssize_t n = c->read_some(dst, want);
        if (n < 0) return -1;
        if (n == 0) return 0;  // dry: wait for the next event
        c->got += static_cast<size_t>(n);
        if (c->got < (c->in_payload ? c->f_len : sizeof c->hdr)) continue;
      }
      if (!c->in_payload) {
        // header complete: parse (t_finish_frame's header layout)
        c->f_type = c->hdr[0];
        c->f_flags = c->hdr[1];
        c->f_sid = get_u32(c->hdr + 2);
        c->f_len = get_u32(c->hdr + 6);
        if (c->f_len > kMaxFramePayload + 65536) return -1;
        c->payload.resize(c->f_len);
        c->in_payload = true;
        c->got = 0;
        if (c->f_len != 0) continue;  // go read the payload bytes
      }
      // frame complete
      c->in_payload = false;
      c->got = 0;
      // ctrl-ring records ordered BEFORE this frame (frame_seq gate)
      // drain first — the Python reader's pre-commit drain; this is what
      // makes ring-borne COMPLETEs land before the TRAILERS behind them
      if (c->link) c->link->ctrl_drain();
      bool frame_ok =
          on_frame(c, c->f_type, c->f_flags, c->f_sid, c->payload);
      if (c->link) {
        c->link->frames_dispatched.fetch_add(1, std::memory_order_release);
        // re-drain now that the count covers this frame: a record gated
        // on it deferred above and would otherwise strand until the next
        // frame (the defer-then-block lost wakeup)
        c->link->ctrl_drain();
      }
      if (!frame_ok) return -1;
      if (--budget == 0) return 1;
    }
  }

  // Connection teardown (poller thread, or destroy): fail streams, wake
  // handlers. The Conn itself is freed by reap once handler threads drain.
  void finish_conn(Conn *c) {
    if (c->finished.exchange(true)) return;
    if (c->otag_conn) {  // the exchange above makes this once-only
      TPR_OBS(tpr_obs::kEvConnDead, c->otag_conn, 0, 0);
      tpr_obs::metric_add(tpr_obs::kMetConnDown);
    }
    // discard-quarantine claimed regions, wake claim waiters (handler
    // threads blocked in a rendezvous claim exit via the framed-fallback
    // path, whose send then fails cleanly on the closed fd)
    if (c->link) c->link->close();
    {
      std::lock_guard<std::mutex> lk(c->mu);
      for (auto &kv : c->streams) kv.second->cancelled = true;
    }
    c->cv.notify_all();
    c->close_fd();
    // Inline (callback-API) calls have no handler thread to free them:
    // whatever still sits in the map with no handler owner is reaped here.
    // Handler-API calls are freed by run_handler (which erases them from
    // the map first), so anything left in the map after handlers DRAIN is
    // poller-owned. With live handler threads, leave the map alone — the
    // reap path frees stragglers once handler_threads hits zero.
    if (c->handler_threads.load() == 0 && c->delivery_refs.load() == 0) {
      std::lock_guard<std::mutex> lk(c->mu);
      for (auto &kv : c->streams) delete kv.second;
      c->streams.clear();
    }
    c->alive.store(false);
  }

  void reap_dead_conns() {
    std::lock_guard<std::mutex> lk(conns_mu);
    for (auto it = conns.begin(); it != conns.end();) {
      Conn *c = *it;
      if (c->reapable.load() && c->handler_threads.load() == 0 &&
          c->delivery_refs.load() == 0) {
        {
          std::lock_guard<std::mutex> lk2(c->mu);
          for (auto &kv : c->streams) delete kv.second;
          c->streams.clear();
        }
        delete c;
        it = conns.erase(it);
      } else {
        ++it;
      }
    }
  }

  // Bootstrap (sniff + optional ring handshake) then hand to a poller.
  void bootstrap_conn(Conn *c, std::vector<uint8_t> preread) {
    bool ok = accept_preface(c, preread.data(), preread.size());
    if (!ok || !running.load()) {
      finish_conn(c);
      c->reapable.store(true);  // never reached a poller: no stale events
    } else {
      // rendezvous/ctrl-ring link: wired before the conn can dispatch a
      // frame. The hello PING (capability + our ring descriptor) goes out
      // right after the preface; an un-negotiated peer just echoes PONG
      // and stays on the framed path, byte-identical to before.
      c->link = new tpr_rdv::Link("srv");
      c->link->send_frame = [c](uint8_t type, uint32_t sid,
                                const std::string &p) {
        return c->send_frame(type, 0, sid, p.data(), p.size());
      };
      c->link->deliver = [this, c](uint32_t sid, uint8_t flags,
                                   uint8_t *data, size_t len) {
        if (delivery_on.load())
          enqueue_delivery(c, sid, flags, data, len, /*rdv=*/true);
        else
          deliver_msg(c, sid, flags, data, len, /*rdv=*/true, false);
      };
      c->link->wake = [c] { c->cv.notify_all(); };
      if (tpr_obs::enabled()) {
        static std::atomic<uint64_t> g_conn_ord{1};
        char tb[44];
        snprintf(tb, sizeof tb, "nconn:srv#%llu",
                 (unsigned long long)g_conn_ord.fetch_add(1));
        c->otag_conn = tpr_obs::tag_for(tb);
        TPR_OBS(tpr_obs::kEvConnConnect, c->otag_conn, 0, 0);
        tpr_obs::metric_add(tpr_obs::kMetConnUp);
      }
      std::string hello = c->link->hello_payload();
      c->send_frame(kPing, 0, 0, hello.data(), hello.size());
      Poller *p = pollers[next_poller.fetch_add(1) % pollers.size()];
      c->poller = p;
      p->add(c);
    }
    bootstrap_threads.fetch_sub(1);
  }

  void start_conn(int fd, const uint8_t *preread, size_t preread_len) {
    // Bound growth for BOTH intake paths: adopted fds never pass through
    // accept_loop, and without this an adoption-churn workload accumulates
    // every dead conn's ring mappings (measured: ~1 GB RSS over 240
    // churned ring connections).
    reap_dead_conns();
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
    auto *c = new Conn();
    c->fd = fd;
    {
      std::lock_guard<std::mutex> lk(conns_mu);
      conns.push_back(c);
    }
    bootstrap_threads.fetch_add(1);
    std::vector<uint8_t> pre(preread, preread + preread_len);
    std::thread([this, c, pre = std::move(pre)]() mutable {
      bootstrap_conn(c, std::move(pre));
    }).detach();
  }

  void accept_loop() {
    while (running.load()) {
      struct sockaddr_in peer {};
      socklen_t plen = sizeof peer;
      int fd = ::accept(listen_fd, reinterpret_cast<sockaddr *>(&peer), &plen);
      if (fd < 0) {
        if (errno == EINTR) continue;
        return;  // listener closed
      }
      start_conn(fd, nullptr, 0);  // start_conn reaps (both intake paths)
    }
  }
};

namespace {

void Poller::loop() {
  constexpr int kMaxEvents = 64;
  struct epoll_event evs[kMaxEvents];
  // Conns whose last pump hit the fairness budget with data still pending:
  // re-pumped every iteration (their announcing tokens are already
  // consumed, so no further epoll event is guaranteed). While any are hot
  // the epoll_wait runs nonblocking so fresh events interleave fairly.
  std::vector<Conn *> hot;
  // every conn this poller serves (for the ctrl-ring hot-poll sweep)
  std::vector<Conn *> managed;
  while (running.load()) {
    // drain-EWMA hot/cold (read_frame_polled's discipline): while any
    // link's ring is hot, poll on ~1 ms slices instead of the 200 ms
    // block — steady-state bulk then needs zero fd kicks
    bool ctrl_hot_any = false;
    for (Conn *mc : managed) {
      if (!mc->finished.load() && mc->link && mc->link->ctrl_hot()) {
        ctrl_hot_any = true;
        break;
      }
    }
    int n = ::epoll_wait(epfd, evs, kMaxEvents,
                         !hot.empty() ? 0 : (ctrl_hot_any ? 1 : 200));
    if (!running.load()) return;
    // adopt pending conns FIRST, with an unconditional initial pump: ring
    // bytes that landed during bootstrap may carry no further token
    std::vector<Conn *> fresh;
    {
      std::lock_guard<std::mutex> lk(add_mu);
      fresh.swap(pending_add);
    }
    std::vector<Conn *> finished_this_batch;
    auto end_conn = [&](Conn *c) {
      ::epoll_ctl(epfd, EPOLL_CTL_DEL, c->event_fd(), nullptr);
      srv->finish_conn(c);
      finished_this_batch.push_back(c);
    };
    auto after_pump = [&](Conn *c, int r) {
      if (r < 0) {
        end_conn(c);
      } else if (r == 1) {
        hot.push_back(c);  // budget hit: data pending, owe a re-pump
      }
    };
    for (Conn *c : fresh) {
      struct epoll_event ev = {};
      ev.events = EPOLLIN;
      ev.data.ptr = c;
      if (::epoll_ctl(epfd, EPOLL_CTL_ADD, c->event_fd(), &ev) != 0) {
        end_conn(c);
        continue;
      }
      managed.push_back(c);
      // this thread is the conn's frame-dispatch hart: it must never
      // block in a claim wait (the claim it waits for dispatches here)
      if (c->link) c->link->set_dispatch_thread();
      after_pump(c, srv->pump_conn(c));
    }
    std::vector<Conn *> rehot;
    rehot.swap(hot);
    for (Conn *c : rehot) {
      if (c->finished.load()) continue;
      after_pump(c, srv->pump_conn(c));
    }
    for (int i = 0; i < n; ++i) {
      Conn *c = static_cast<Conn *>(evs[i].data.ptr);
      if (c == nullptr) {  // wake pipe (nonblocking): drain
        char buf[64];
        while (::read(wake_r, buf, sizeof buf) > 0) {
        }
        continue;
      }
      if (c->finished.load()) continue;  // stale event post-teardown
      if (c->ring) {
        // tokens first (level-triggered fd would re-fire otherwise),
        // then drain the ring. A closed notify channel still gets its
        // ring remnants served before teardown (the peer's final frames
        // race its close, exactly like the old blocking path).
        int t = c->ring->drain_tokens();
        int r = srv->pump_conn(c);
        if (t < 0 && r != 1) r = -1;  // keep pumping remnants while hot
        after_pump(c, r);
      } else {
        after_pump(c, srv->pump_conn(c));
      }
    }
    // ctrl-ring sweep: drain hot links; an empty probe decays the EWMA,
    // and a link that just went cold PARKS (parked=1 + one mandatory
    // re-drain, closing the lost-wakeup race — the producer reads parked
    // strictly after its stamp store). Kicks then wake us via the fd.
    for (Conn *c : managed) {
      if (c->finished.load() || !c->link || !c->link->ctrl_rx_ready())
        continue;
      if (c->link->ctrl_hot() && c->link->ctrl_drain() == 0) {
        c->link->ctrl_decay();
        if (!c->link->ctrl_hot()) c->link->ctrl_park();
      }
    }
    // A conn can land in `hot` (budget hit) and THEN be finished by a later
    // epoll event in the same batch; it stays in `hot` across iterations, so
    // if the reaper freed it between batches the next rehot pass would read
    // freed memory. Purge finished conns from `hot` before making anything
    // reapable — only then is no poller-local pointer left to them.
    hot.erase(std::remove_if(hot.begin(), hot.end(),
                             [](Conn *c) { return c->finished.load(); }),
              hot.end());
    managed.erase(std::remove_if(managed.begin(), managed.end(),
                                 [](Conn *c) { return c->finished.load(); }),
                  managed.end());
    // only AFTER the batch (no stale event can reference them) may the
    // reaper free these conns
    for (Conn *c : finished_this_batch) c->reapable.store(true);
  }
}

}  // namespace

// ---------------------------------------------------------------------------

extern "C" {

tpr_server *tpr_server_create(int port) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
  struct sockaddr_in addr {};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::bind(fd, reinterpret_cast<sockaddr *>(&addr), sizeof addr) != 0 ||
      ::listen(fd, 512) != 0) {
    ::close(fd);
    return nullptr;
  }
  socklen_t alen = sizeof addr;
  getsockname(fd, reinterpret_cast<sockaddr *>(&addr), &alen);
  auto *s = new tpr_server();
  s->listen_fd = fd;
  s->port = ntohs(addr.sin_port);
  return s;
}

int tpr_server_port(tpr_server *s) { return s->port; }

void tpr_server_register(tpr_server *s, const char *method, tpr_handler_fn fn,
                         void *ud) {
  s->handlers[method] = {fn, ud};
}

void tpr_server_register_callback(tpr_server *s, const char *method,
                                  tpr_msg_cb on_msg, void *ud) {
  s->cb_handlers[method] = {on_msg, ud};
}

void tpr_server_register_default(tpr_server *s, tpr_handler_fn fn, void *ud) {
  s->default_handler = fn;
  s->default_ud = ud;
}

// GRPC_RDMA_AFFINITY / TPURPC_AFFINITY: pin poller i to core i % ncores.
// The reference PARSES this knob but never consumes it (rdma_utils.h:72-73
// is_affinity has zero call sites); here it actually pins — on multicore
// hosts a wandering poller pays cache/TLB refills every migration, the
// cost the round-5 scalability profile measured as per-RPC cycle growth.
static bool affinity_from_env() {
  const char *v = getenv("TPURPC_AFFINITY");
  if (!v) v = getenv("GRPC_RDMA_AFFINITY");
  return v != nullptr && (v[0] == '1' || strcmp(v, "true") == 0);
}

int tpr_server_start(tpr_server *s) {
  s->running.store(true);
  int np = tpr_server::poller_count_from_env();
  bool pin = affinity_from_env();
  // Pin within the process's ALLOWED set, not raw core ids: under a
  // cpuset/taskset restriction (cores 60-63, say) CPU_SET(i % ncores)
  // would target forbidden cores and the knob would silently no-op in
  // exactly the containerized deployments that need it.
  std::vector<int> allowed;
  if (pin) {
    cpu_set_t proc_set;
    CPU_ZERO(&proc_set);
    if (sched_getaffinity(0, sizeof proc_set, &proc_set) == 0) {
      for (int c = 0; c < CPU_SETSIZE; ++c)
        if (CPU_ISSET(c, &proc_set)) allowed.push_back(c);
    }
  }
  for (int i = 0; i < np; ++i) {
    auto *p = new Poller();
    if (!p->init()) {
      delete p;
      return -1;
    }
    p->srv = s;
    p->th = std::thread([p] { p->loop(); });
    if (pin && !allowed.empty()) {
      cpu_set_t set;
      CPU_ZERO(&set);
      CPU_SET(allowed[i % allowed.size()], &set);
      // best effort: a denied setaffinity is not an error
      pthread_setaffinity_np(p->th.native_handle(), sizeof set, &set);
    }
    s->pollers.push_back(p);
  }
  s->delivery_on.store(tpr_server::delivery_from_env());
  if (s->delivery_on.load()) {
    if (tpr_obs::enabled()) s->otag_dlv = tpr_obs::tag_for("ndlv:srv");
    s->delivery_th = std::thread([s] { s->delivery_loop(); });
  }
  s->accept_thread = std::thread([s] { s->accept_loop(); });
  return 0;
}

int tpr_server_adopt_fd(tpr_server *s, int fd, const uint8_t *preread,
                        size_t preread_len) {
  if (!s->running.load() || preread_len > 4) return -1;
  s->start_conn(fd, preread, preread_len);
  return 0;
}

void tpr_server_destroy(tpr_server *s) {
  s->running.store(false);
  ::shutdown(s->listen_fd, SHUT_RDWR);
  ::close(s->listen_fd);
  if (s->accept_thread.joinable()) s->accept_thread.join();
  // bootstrap threads hold Conn pointers; their sniffs are bounded (the
  // fd shutdowns below kick any that are mid-handshake)
  {
    std::lock_guard<std::mutex> lk(s->conns_mu);
    for (Conn *c : s->conns) c->shutdown_fd();
  }
  while (s->bootstrap_threads.load() > 0)
    std::this_thread::sleep_for(std::chrono::milliseconds(1));
  for (Poller *p : s->pollers) {
    p->stop_and_join();
    delete p;
  }
  s->pollers.clear();
  {
    std::lock_guard<std::mutex> lk(s->conns_mu);
    for (Conn *c : s->conns) {
      s->finish_conn(c);
      while (c->handler_threads.load() > 0)
        std::this_thread::sleep_for(std::chrono::milliseconds(1));
    }
  }
  // All producers (pollers, handlers) are quiet: drain and stop the
  // delivery shard BEFORE freeing conns — queued items hold raw Conn*.
  if (s->delivery_th.joinable()) {
    {
      std::lock_guard<std::mutex> lk(s->dq_mu);
      s->dq_stop = true;
    }
    s->dq_cv.notify_all();
    s->delivery_th.join();
  }
  {
    std::lock_guard<std::mutex> lk(s->conns_mu);
    for (Conn *c : s->conns) {
      {
        std::lock_guard<std::mutex> lk2(c->mu);
        for (auto &kv : c->streams) delete kv.second;
        c->streams.clear();
      }
      delete c;
    }
    s->conns.clear();
  }
  delete s;
}

int tpr_srv_recv(tpr_server_call *c, uint8_t **data, size_t *len) {
  Conn *conn = c->conn;
  std::unique_lock<std::mutex> lk(conn->mu);
  while (true) {
    if (!c->pending.empty()) {
      // zero-copy handoff: the accumulator is malloc-backed from the
      // start, so the handler takes the buffer itself (frees with
      // tpr_srv_buf_free == free(), the unchanged contract)
      *data = c->pending.front().release(len);
      c->pending.pop_front();
      return 1;
    }
    if (c->cancelled) return -1;
    if (c->half_closed) return 0;
    conn->cv.wait(lk);
  }
}

static void flush_initial_md(tpr_server_call *c) {
  if (c->initial_md_sent) return;
  c->initial_md_sent = true;
  if (c->initial_md.empty()) return;
  std::string payload = encode_metadata(c->initial_md);
  c->conn->send_frame(kHeaders, 0, c->stream_id, payload.data(),
                      payload.size());
}

int tpr_srv_send(tpr_server_call *c, const uint8_t *data, size_t len) {
  flush_initial_md(c);
  // Bulk ladder: eligible payloads on a negotiated link move by one
  // one-sided write into a claimed landing region + one COMPLETE record —
  // zero framed MESSAGE bytes. ANY failure returns false and the framed
  // loop below carries the message instead (fallback, never a hang).
  tpr_rdv::Link *link = c->conn->link;
  if (link && link->eligible(len) &&
      link->send_message(c->stream_id, 0, data, len))
    return 0;
  size_t off = 0;
  do {
    size_t n = len - off;
    bool last = n <= kMaxFramePayload;
    if (!last) n = kMaxFramePayload;
    uint8_t flags = last ? 0 : kFlagMore;
    if (!c->conn->send_frame(kMessage, flags, c->stream_id, data + off, n))
      return -1;
    off += n;
  } while (off < len);
  return 0;
}

const char *tpr_srv_method(tpr_server_call *c) { return c->method.c_str(); }

int64_t tpr_srv_deadline_us(tpr_server_call *c) {
  if (c->deadline_us == INT64_MAX) return INT64_MAX;
  int64_t now = std::chrono::duration_cast<std::chrono::microseconds>(
                    Clock::now().time_since_epoch()).count();
  int64_t left = c->deadline_us - now;
  return left > 0 ? left : 0;
}

void tpr_srv_set_details(tpr_server_call *c, const char *details) {
  c->details = details ? details : "";
}

size_t tpr_srv_metadata_count(tpr_server_call *c) { return c->md.size(); }

int tpr_srv_metadata_get(tpr_server_call *c, size_t i, const char **key,
                         const char **val) {
  if (i >= c->md.size()) return -1;
  *key = c->md[i].first.c_str();
  *val = c->md[i].second.c_str();
  return 0;
}

void tpr_srv_send_initial_md(tpr_server_call *c, const char *key,
                             const char *val) {
  if (!c->initial_md_sent)
    c->initial_md.emplace_back(key ? key : "", val ? val : "");
}

void tpr_srv_add_trailing_md(tpr_server_call *c, const char *key,
                             const char *val) {
  c->trailing_md.emplace_back(key ? key : "", val ? val : "");
}

int tpr_srv_cancelled(tpr_server_call *c) {
  std::lock_guard<std::mutex> lk(c->conn->mu);
  return c->cancelled ? 1 : 0;
}

void tpr_srv_buf_free(uint8_t *data) {
  // a delivered rendezvous region settles (doorbell/recycle); everything
  // else keeps the original free() contract
  if (!tpr_rdv::settle(data)) free(data);
}

}  // extern "C"
