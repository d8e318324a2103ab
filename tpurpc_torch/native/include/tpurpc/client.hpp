// tpurpc C++ application API — RAII wrapper over the C client (client.h).
//
// The shape intentionally mirrors the reference's C++ surface
// (include/grpcpp/: grpc::CreateChannel / Stub / ClientReaderWriter) at the
// scale tpurpc needs: blocking calls, raw-bytes payloads (serialize with
// protobuf or tpurpc codegen above this layer).
//
//   tpurpc::Channel ch("127.0.0.1", 50051);
//   auto [status, reply] = ch.UnaryCall("/pkg.Svc/Method", request_bytes);
//   if (status.ok()) use(reply);
//
//   tpurpc::ClientCall call = ch.StartCall("/pkg.Svc/Chat");
//   call.Write("hello");
//   call.WritesDone();
//   std::string msg;
//   while (call.Read(&msg)) consume(msg);
//   tpurpc::Status st = call.Finish();
#ifndef TPURPC_CLIENT_HPP
#define TPURPC_CLIENT_HPP

#include <cstdint>
#include <stdexcept>
#include <string>
#include <utility>
#include <vector>

#include "client.h"

namespace tpurpc {

struct Status {
  int code = TPR_OK;
  std::string details;
  bool ok() const { return code == TPR_OK; }
};

class ClientCall {
 public:
  ClientCall(ClientCall &&o) noexcept : call_(o.call_) { o.call_ = nullptr; }
  ClientCall &operator=(ClientCall &&o) noexcept {
    if (call_) tpr_call_destroy(call_);
    call_ = o.call_;
    o.call_ = nullptr;
    return *this;
  }
  ClientCall(const ClientCall &) = delete;
  ClientCall &operator=(const ClientCall &) = delete;
  ~ClientCall() {
    if (call_) tpr_call_destroy(call_);
  }

  bool Write(const std::string &msg, bool end_stream = false) {
    return tpr_call_send(call_,
                         reinterpret_cast<const uint8_t *>(msg.data()),
                         msg.size(), end_stream ? 1 : 0) == 0;
  }
  bool WritesDone() { return tpr_call_writes_done(call_) == 0; }

  // Blocking read; false at end-of-stream or error (Finish() tells which).
  bool Read(std::string *out) {
    uint8_t *data = nullptr;
    size_t len = 0;
    int r = tpr_call_recv(call_, &data, &len);
    if (r != 1) return false;
    out->assign(reinterpret_cast<char *>(data), len);
    tpr_buf_free(data);
    return true;
  }

  Status Finish() {
    char buf[1024];
    Status st;
    st.code = tpr_call_finish(call_, buf, sizeof buf);
    st.details = buf;
    return st;
  }

  void Cancel() { tpr_call_cancel(call_); }

 private:
  friend class Channel;
  explicit ClientCall(tpr_call *c) : call_(c) {}
  tpr_call *call_;
};

class Channel {
 public:
  Channel(const std::string &host, int port, int connect_timeout_ms = 10000)
      : ch_(tpr_channel_create(host.c_str(), port, connect_timeout_ms)) {
    if (!ch_) throw std::runtime_error("tpurpc: connect failed");
  }
  ~Channel() {
    if (ch_) tpr_channel_destroy(ch_);
  }
  Channel(const Channel &) = delete;
  Channel &operator=(const Channel &) = delete;

  // Round-trip latency in microseconds; throws on a dead channel.
  int64_t PingUs(int timeout_ms = 5000) {
    int64_t us = tpr_channel_ping(ch_, timeout_ms);
    if (us < 0) throw std::runtime_error("tpurpc: ping failed");
    return us;
  }

  ClientCall StartCall(
      const std::string &method,
      const std::vector<std::pair<std::string, std::string>> &metadata = {},
      int timeout_ms = 0) {
    std::vector<const char *> flat;
    flat.reserve(metadata.size() * 2);
    for (const auto &kv : metadata) {
      flat.push_back(kv.first.c_str());
      flat.push_back(kv.second.c_str());
    }
    tpr_call *c = tpr_call_start(ch_, method.c_str(),
                                 flat.empty() ? nullptr : flat.data(),
                                 metadata.size(), timeout_ms);
    if (!c) throw std::runtime_error("tpurpc: call start failed");
    return ClientCall(c);
  }

  std::pair<Status, std::string> UnaryCall(const std::string &method,
                                           const std::string &request,
                                           int timeout_ms = 0) {
    uint8_t *resp = nullptr;
    size_t resp_len = 0;
    char details[1024] = {0};
    Status st;
    st.code = tpr_unary_call(
        ch_, method.c_str(), reinterpret_cast<const uint8_t *>(request.data()),
        request.size(), &resp, &resp_len, details, sizeof details, timeout_ms);
    st.details = details;
    std::string body;
    if (st.ok() && resp) {
      body.assign(reinterpret_cast<char *>(resp), resp_len);
      tpr_buf_free(resp);
    }
    return {st, body};
  }

 private:
  tpr_channel *ch_;
};

}  // namespace tpurpc

#endif  // TPURPC_CLIENT_HPP
