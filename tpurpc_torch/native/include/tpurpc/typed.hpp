// Typed (protobuf) wrappers over the tpurpc native call objects — the
// runtime support header for code the tpurpc protoc plugin generates with
// --tpurpc_out=cpp:DIR (see tpurpc/codegen/plugin.py). The reference's
// analog is the grpc++ codegen support layer (include/grpcpp/impl/codegen/)
// under stubs emitted by src/compiler/cpp_generator.cc.
//
// Message types must provide protobuf's SerializeAsString / ParseFromArray
// (any google::protobuf::MessageLite does).
#ifndef TPURPC_TYPED_HPP
#define TPURPC_TYPED_HPP

#include <string>
#include <utility>

#include "client.hpp"
#include "server.h"

namespace tpurpc {

// Client side: a typed view of a streaming call. W = request message type,
// R = response message type.
template <typename W, typename R>
class TypedCall {
 public:
  explicit TypedCall(ClientCall &&c) : call_(std::move(c)) {}

  bool Write(const W &msg, bool end_stream = false) {
    return call_.Write(msg.SerializeAsString(), end_stream);
  }
  bool WritesDone() { return call_.WritesDone(); }

  // Blocking typed read; false at end-of-stream, error, or parse failure
  // (Finish() distinguishes; a parse failure sets parse_error()).
  bool Read(R *out) {
    std::string raw;
    if (!call_.Read(&raw)) return false;
    if (!out->ParseFromArray(raw.data(), static_cast<int>(raw.size()))) {
      parse_error_ = true;
      return false;
    }
    return true;
  }

  Status Finish() {
    Status st = call_.Finish();
    if (st.ok() && parse_error_) {
      st.code = TPR_INTERNAL;
      st.details = "response message parse failed";
    }
    return st;
  }
  void Cancel() { call_.Cancel(); }
  bool parse_error() const { return parse_error_; }

 private:
  ClientCall call_;
  bool parse_error_ = false;
};

// Server side: a typed view of the handler's call object. R = request
// message type (Read), W = response message type (Write).
template <typename R, typename W>
class ServerCall {
 public:
  explicit ServerCall(tpr_server_call *c) : c_(c) {}

  // Next request message; false at client half-close / cancel / bad parse.
  bool Read(R *out) {
    uint8_t *data = nullptr;
    size_t len = 0;
    if (tpr_srv_recv(c_, &data, &len) != 1) return false;
    bool ok = out->ParseFromArray(data, static_cast<int>(len));
    tpr_srv_buf_free(data);
    if (!ok) parse_error_ = true;
    return ok;
  }

  bool Write(const W &msg) {
    std::string raw = msg.SerializeAsString();
    return tpr_srv_send(c_, reinterpret_cast<const uint8_t *>(raw.data()),
                        raw.size()) == 0;
  }

  void SetDetails(const std::string &d) { tpr_srv_set_details(c_, d.c_str()); }
  int64_t DeadlineRemainingUs() const { return tpr_srv_deadline_us(c_); }
  bool parse_error() const { return parse_error_; }
  tpr_server_call *raw() { return c_; }

 private:
  tpr_server_call *c_;
  bool parse_error_ = false;
};

}  // namespace tpurpc

#endif  // TPURPC_TYPED_HPP
