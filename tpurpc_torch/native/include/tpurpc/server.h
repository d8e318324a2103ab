/* tpurpc C server API — native app servers over the tpurpc framing.
 *
 * Counterpart of client.h; together they are the app-facing native surface
 * the reference provides as src/cpp/server (ServerBuilder / sync service,
 * SURVEY.md §1 L7). Scope: blocking handlers, all four call shapes
 * expressed through one call object (read-until-end / write-many /
 * finish-with-status).
 *
 * Threading (round 4, the reference Poller model — ibverbs/poller.cc:52-106,
 * capacity 4096 pairs over N threads): connections are MULTIPLEXED over a
 * small fixed set of poller threads (TPURPC_SERVER_POLLERS /
 * GRPC_RDMA_POLLER_THREAD_NUM, default 1) that epoll every connection's
 * event fd and parse frames incrementally — NOT a thread per connection,
 * so the server holds hundreds of concurrent ring/TCP connections with
 * bounded threads. Callback-API (`tpr_server_register_callback`) handlers
 * run inline on the poller thread; handler-API (`tpr_server_register`)
 * calls still get a dedicated thread each (they block in tpr_srv_recv).
 */
#ifndef TPURPC_SERVER_H
#define TPURPC_SERVER_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct tpr_server tpr_server;
typedef struct tpr_server_call tpr_server_call;

/* Handler: drive the call via tpr_srv_recv/tpr_srv_send, then return the
 * status code to send in trailers (0 = OK). `ud` is the registration's
 * user data pointer. */
typedef int (*tpr_handler_fn)(tpr_server_call *call, void *ud);

/* Create a server bound to 127.0.0.1:port (port 0 = ephemeral; actual port
 * via tpr_server_port). NULL on bind failure. */
tpr_server *tpr_server_create(int port);
int tpr_server_port(tpr_server *s);

/* Register a handler for an exact :path. Must precede tpr_server_start. */
void tpr_server_register(tpr_server *s, const char *method, tpr_handler_fn fn,
                         void *ud);

/* -- callback (reactor) API --------------------------------------------
 *
 * The reference ships sync, CQ-async, AND callback server APIs
 * (src/cpp/server/server_callback.cc); this is tpurpc's callback shape.
 * `on_msg` fires ON THE CONNECTION READER THREAD once per complete request
 * message — no per-call thread, no handoff: the low-latency path for
 * message-echo/transform services. Reply synchronously with tpr_srv_send.
 * Contract: return 0 to continue; a positive return ends the call NOW with
 * that status code (negative returns are coerced to INTERNAL(13) — the
 * client always gets trailers). At client half-close the call ends OK.
 * Handlers must not block: they stall every stream on the connection
 * (exactly like gRPC callback reactors). */
typedef int (*tpr_msg_cb)(tpr_server_call *call, const uint8_t *data,
                          size_t len, void *ud);
void tpr_server_register_callback(tpr_server *s, const char *method,
                                  tpr_msg_cb on_msg, void *ud);

/* Fallback handler for methods with no exact registration (runs on its own
 * thread, like tpr_server_register handlers). The seam a language-level
 * server uses for DYNAMIC method resolution (grpcio generic handlers):
 * the trampoline looks the path up in the language registry per call.
 * Without a default, unknown methods get UNIMPLEMENTED trailers. */
void tpr_server_register_default(tpr_server *s, tpr_handler_fn fn, void *ud);

/* Start the accept loop (background thread). */
int tpr_server_start(tpr_server *s);

/* Stop accepting, close connections, join threads, free. */
void tpr_server_destroy(tpr_server *s);

/* Adopt an ALREADY-ACCEPTED connected socket: the server takes ownership
 * of `fd`, sniffs the protocol (ring bootstrap magic vs framing preface)
 * and serves it exactly like an accepted connection. `preread` replays
 * bytes the caller already consumed from the socket (<= 4; pass NULL/0
 * when the caller peeked instead). This is the seam a language-level
 * server (tpurpc_torch/rpc/server.py) uses to put its accepted connections on
 * the native data plane. Requires tpr_server_start to have run. Returns
 * 0 on success, -1 on refusal (server stopping / preread too long). */
int tpr_server_adopt_fd(tpr_server *s, int fd, const uint8_t *preread,
                        size_t preread_len);

/* -- inside a handler -- */

/* Next request message: 1 = got one (*data/*len set, free with
 * tpr_srv_buf_free), 0 = client half-closed, -1 = connection error/cancel. */
int tpr_srv_recv(tpr_server_call *c, uint8_t **data, size_t *len);

/* Send one response message. */
int tpr_srv_send(tpr_server_call *c, const uint8_t *data, size_t len);

/* The call's :path (valid for the handler's duration). */
const char *tpr_srv_method(tpr_server_call *c);

/* Remaining time before the client's deadline, in microseconds;
 * INT64_MAX when the call has no deadline. */
int64_t tpr_srv_deadline_us(tpr_server_call *c);

/* Set the trailers' :message detail (optional, before returning). */
void tpr_srv_set_details(tpr_server_call *c, const char *details);

/* Request metadata (every header the client sent except :path/:timeout-us).
 * Pointers are valid for the handler's duration. */
size_t tpr_srv_metadata_count(tpr_server_call *c);
int tpr_srv_metadata_get(tpr_server_call *c, size_t i, const char **key,
                         const char **val);

/* Queue initial metadata (sent as a HEADERS frame before the first
 * response message; no-op after the first send). */
void tpr_srv_send_initial_md(tpr_server_call *c, const char *key,
                             const char *val);

/* Add a custom trailing-metadata pair to the final trailers. */
void tpr_srv_add_trailing_md(tpr_server_call *c, const char *key,
                             const char *val);

/* 1 when the client cancelled (RST) or the connection died. */
int tpr_srv_cancelled(tpr_server_call *c);

void tpr_srv_buf_free(uint8_t *data);

#ifdef __cplusplus
}
#endif

#endif /* TPURPC_SERVER_H */
