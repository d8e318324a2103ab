// tpurpc C++ server API — RAII wrapper over server.h; counterpart of
// client.hpp. Mirrors the reference's sync-server shape (ServerBuilder +
// service methods, src/cpp/server/server_builder.cc) at tpurpc scale:
//
//   tpurpc::Server srv(0);                       // ephemeral port
//   srv.AddMethod("/pkg.Svc/Echo",
//                 [](tpurpc::ServerCall &call) {
//                   std::string msg;
//                   while (call.Read(&msg)) call.Write("echo:" + msg);
//                   return 0;                    // OK
//                 });
//   srv.Start();
//   int port = srv.port();
#ifndef TPURPC_SERVER_HPP
#define TPURPC_SERVER_HPP

#include <cstdint>
#include <functional>
#include <memory>
#include <stdexcept>
#include <string>
#include <vector>

#include "server.h"

namespace tpurpc {

class ServerCall {
 public:
  explicit ServerCall(tpr_server_call *c) : c_(c) {}

  // Next request; false at client half-close (or cancellation — check
  // cancelled() to distinguish).
  bool Read(std::string *out) {
    uint8_t *data = nullptr;
    size_t len = 0;
    int r = tpr_srv_recv(c_, &data, &len);
    if (r != 1) {
      cancelled_ = (r < 0);
      return false;
    }
    out->assign(reinterpret_cast<char *>(data), len);
    tpr_srv_buf_free(data);
    return true;
  }

  bool Write(const std::string &msg) {
    return tpr_srv_send(c_, reinterpret_cast<const uint8_t *>(msg.data()),
                        msg.size()) == 0;
  }

  std::string method() const { return tpr_srv_method(c_); }
  int64_t deadline_us() const { return tpr_srv_deadline_us(c_); }
  bool cancelled() const { return cancelled_; }
  void SetDetails(const std::string &d) { tpr_srv_set_details(c_, d.c_str()); }

 private:
  tpr_server_call *c_;
  bool cancelled_ = false;
};

class Server {
 public:
  using Handler = std::function<int(ServerCall &)>;

  explicit Server(int port) : srv_(tpr_server_create(port)) {
    if (!srv_) throw std::runtime_error("tpurpc: bind failed");
  }
  ~Server() {
    if (srv_) tpr_server_destroy(srv_);
  }
  Server(const Server &) = delete;
  Server &operator=(const Server &) = delete;

  void AddMethod(const std::string &method, Handler h) {
    handlers_.push_back(std::make_unique<Handler>(std::move(h)));
    tpr_server_register(srv_, method.c_str(), &Server::trampoline,
                        handlers_.back().get());
  }

  void Start() { tpr_server_start(srv_); }
  int port() const { return tpr_server_port(srv_); }

 private:
  static int trampoline(tpr_server_call *c, void *ud) {
    ServerCall call(c);
    return (*static_cast<Handler *>(ud))(call);
  }

  tpr_server *srv_;
  std::vector<std::unique_ptr<Handler>> handlers_;
};

}  // namespace tpurpc

#endif  // TPURPC_SERVER_HPP
