/* tpurpc C client API — the app-facing native surface (SURVEY.md §1 L7).
 *
 * The reference ships a full C++ application API (src/cpp/ + include/grpcpp/,
 * 14,328 LoC) above its C core surface (src/core/lib/surface/). tpurpc's
 * equivalent is deliberately small: a blocking C API over the tpurpc native
 * framing (tpurpc_torch/rpc/frame.py documents the wire format), speaking TCP to
 * any tpurpc server — including ring-platform and TPU-platform listeners,
 * whose accept loops protocol-sniff the preface (tpurpc_torch/rpc/server.py).
 * A header-only C++ RAII wrapper lives in tpurpc/client.hpp.
 *
 * Concurrency model: one background reader thread per channel demuxes frames
 * to calls (the moral equivalent of grpc's completion-queue plumbing,
 * completion_queue.cc:393, collapsed to blocking calls); any number of app
 * threads may run calls on one channel concurrently.
 *
 * All functions return 0 / a valid pointer on success unless noted.
 * Status codes match gRPC's numbering (tpurpc_torch/rpc/status.py).
 */
#ifndef TPURPC_CLIENT_H
#define TPURPC_CLIENT_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct tpr_channel tpr_channel;
typedef struct tpr_call tpr_call;

/* -- status codes (grpc numbering) -- */
enum {
  TPR_OK = 0,
  TPR_CANCELLED = 1,
  TPR_UNKNOWN = 2,
  TPR_DEADLINE_EXCEEDED = 4,
  TPR_UNIMPLEMENTED = 12,
  TPR_INTERNAL = 13,
  TPR_UNAVAILABLE = 14
};

/* Connect a channel. timeout_ms bounds the TCP connect. NULL on failure.
 *
 * TPURPC_NATIVE_INLINE_READ=1 (ring platforms only): the lowest-latency
 * blocking discipline — no reader thread; the thread waiting in recv/
 * finish/ping pumps the transport itself (the reference's pollset_work
 * model), saving a thread wakeup per round trip. Deadlines are enforced
 * at frame boundaries. CQ async ops need the reader thread and return
 * NULL on such channels. Trade-off: with NO call in flight nothing reads
 * the transport, so an idle inline channel does not answer server
 * keepalive PINGs or observe GOAWAY until the next call — pair it with
 * call-per-connection or always-busy usage, not server-side keepalive
 * reaping. */
tpr_channel *tpr_channel_create(const char *host, int port, int timeout_ms);

/* Flag-taking variant. TPR_CHANNEL_INLINE_READ selects the inline-read
 * discipline explicitly (per channel, overriding the
 * TPURPC_NATIVE_INLINE_READ env default): blocking callers pump the
 * transport themselves — the lowest-latency discipline on ring
 * platforms (no reader-thread wakeup per RTT), at the price of the CQ
 * async API refusing on such channels (it needs the reader thread).
 * Ignored on TCP transports (a blocking fd read can't be caller-pumped
 * across concurrent streams). */
#define TPR_CHANNEL_INLINE_READ 1
tpr_channel *tpr_channel_create2(const char *host, int port, int timeout_ms,
                                 int flags);
void tpr_channel_destroy(tpr_channel *ch);

/* Round-trip a PING frame; returns microseconds, or -1 on failure. */
int64_t tpr_channel_ping(tpr_channel *ch, int timeout_ms);

/* Start a call. metadata: flat array of 2*n_md C strings (k,v,k,v,...);
 * timeout_ms <= 0 means no deadline. NULL when the channel is dead or the
 * server sent GOAWAY (max_connection_age drain) — in-flight calls still
 * complete, but new calls need a fresh tpr_channel_create. */
tpr_call *tpr_call_start(tpr_channel *ch, const char *method,
                         const char *const *metadata, size_t n_md,
                         int timeout_ms);

/* Send one request message. end_stream half-closes after this message. */
int tpr_call_send(tpr_call *c, const uint8_t *data, size_t len,
                  int end_stream);

/* Half-close without a message (client finished sending). */
int tpr_call_writes_done(tpr_call *c);

/* Receive the next response message. Returns 1 with *data/*len set (caller
 * frees with tpr_buf_free), 0 at end of the response stream (trailers seen),
 * -1 on transport error / deadline. */
int tpr_call_recv(tpr_call *c, uint8_t **data, size_t *len);

/* Block until trailers; returns the status code. details (optional) receives
 * the status message, NUL-terminated, truncated to cap. */
int tpr_call_finish(tpr_call *c, char *details, size_t cap);

/* Zero-copy send lease (ring transports only) — the reference's
 * SendZerocopy shape (pair.cc:793-941) for a shm ring: reserve `len`
 * payload bytes of ONE message directly in the transport ring, so the
 * producer serializes in place and the staging-buffer memcpy disappears.
 * On 0, the frame header is already written and (p1,l1)(+(p2,l2) at a
 * ring wrap) are the payload span to fill; then call
 * tpr_call_send_commit (publish + notify) or tpr_call_send_abort
 * (release without publishing). The channel's send path is LOCKED from a
 * successful reserve until commit/abort: commit promptly, same thread,
 * no other sends in between. -1 = not eligible (no ring, len 0 or over
 * one frame, channel dead, lease already held) — use tpr_call_send. */
int tpr_call_send_reserve(tpr_call *c, size_t len, int end_stream,
                          uint8_t **p1, size_t *l1,
                          uint8_t **p2, size_t *l2);

/* Fragment-aware reserve: flags is a bitmask. TPR_RESERVE_MORE marks this
 * frame as a non-final fragment of one logical message (the peer keeps
 * accumulating until a frame without it), letting a producer gather a
 * message LARGER than one frame through several reserve/commit leases.
 * TPR_RESERVE_END_STREAM half-closes after the final fragment. */
#define TPR_RESERVE_END_STREAM 1
#define TPR_RESERVE_MORE 2
int tpr_call_send_reserve2(tpr_call *c, size_t len, int flags,
                           uint8_t **p1, size_t *l1,
                           uint8_t **p2, size_t *l2);
int tpr_call_send_commit(tpr_call *c);
int tpr_call_send_abort(tpr_call *c);

/* Cancel: RST the stream. Safe at any point before finish. */
void tpr_call_cancel(tpr_call *c);

/* Destroy a finished/cancelled call object. */
void tpr_call_destroy(tpr_call *c);

void tpr_buf_free(uint8_t *data);

/* Convenience: full unary round trip. Returns the status code; on TPR_OK,
 * *resp/*resp_len carry the response (caller frees). */
int tpr_unary_call(tpr_channel *ch, const char *method, const uint8_t *req,
                   size_t req_len, uint8_t **resp, size_t *resp_len,
                   char *details, size_t details_cap, int timeout_ms);

/* Like tpr_unary_call, plus a machine-readable replay-safety verdict:
 * *preexec is set to 1 iff the failure provably happened BEFORE the complete
 * request could have reached a server handler (admission refusal on a
 * dead/draining channel, or a request-send failure that left END_STREAM
 * unsent), and 0 otherwise — including every failure after the request was
 * fully shipped, where a handler MAY have executed and a caller replay would
 * double-execute. Callers deciding whether to transparently retry MUST use
 * this flag, never the human-readable details text (tpurpc_torch/rpc/channel.py
 * _native_call consumes it as RpcError._tpurpc_preexec). */
int tpr_unary_call_ex(tpr_channel *ch, const char *method, const uint8_t *req,
                      size_t req_len, uint8_t **resp, size_t *resp_len,
                      char *details, size_t details_cap, int timeout_ms,
                      int *preexec);

/* ---------------------------------------------------------------------------
 * Completion-queue async API — the reference's CQ-based async client shape
 * (grpc_completion_queue_next, completion_queue.cc:393; CompletionQueue::Next
 * in include/grpcpp/). Ops are tagged; completions surface as events pulled
 * by any number of app threads via tpr_cq_next. Sends remain direct calls
 * (they complete into the kernel/ring buffer synchronously; the blocking is
 * bounded by transport backpressure, as in the reference's write path) —
 * receive/finish, the genuinely asynchronous halves, are tag-driven.
 *
 * Deadlines on CQ calls are enforced lazily inside tpr_cq_next (the thread
 * pulling events doubles as the timer thread, like grpc's cq-driven timer
 * checks): an expired call is RST'd and its pending ops complete with
 * TPR_DEADLINE_EXCEEDED.
 */

typedef struct tpr_cq tpr_cq;

enum {
  TPR_EV_SHUTDOWN = 0, /* queue shut down and drained */
  TPR_EV_RECV = 1,     /* a tpr_call_recv_cq op completed */
  TPR_EV_FINISH = 2,   /* a tpr_call_finish_cq / tpr_unary_call_cq completed */
};

typedef struct {
  int type;      /* TPR_EV_* */
  void *tag;     /* the tag passed when the op was started */
  int ok;        /* RECV: 1 = data/len hold a message (caller frees),
                  *       0 = end of response stream (no message).
                  * FINISH: always 1. */
  uint8_t *data; /* RECV with ok=1, or unary FINISH response; else NULL */
  size_t len;
  int status;         /* FINISH: gRPC status code */
  char details[256];  /* FINISH: status details, NUL-terminated */
} tpr_event;

tpr_cq *tpr_cq_create(void);

/* Pull the next completion. Returns 1 and fills *ev on an event; 0 on
 * timeout (timeout_ms <= 0 means wait forever); -1 when the queue is shut
 * down and fully drained (ev->type = TPR_EV_SHUTDOWN). */
int tpr_cq_next(tpr_cq *cq, tpr_event *ev, int timeout_ms);

/* Begin shutdown: wakes waiters; tpr_cq_next keeps returning queued events
 * until drained, then -1. New ops on the queue are refused (best-effort:
 * as in grpc, STARTING an op concurrently with shutdown is undefined —
 * the app must stop issuing ops before calling shutdown, and must not
 * destroy the queue while an op-arming call is still executing). */
void tpr_cq_shutdown(tpr_cq *cq);

/* Destroy a shut-down queue. Undelivered RECV payloads are freed. All
 * calls started against this queue must be destroyed BEFORE the queue
 * (tpr_call_destroy unhooks the call from the queue's deadline scan). */
void tpr_cq_destroy(tpr_cq *cq);

/* Start a call whose recv/finish ops complete on `cq`. Same semantics as
 * tpr_call_start otherwise. Sends use the normal tpr_call_send /
 * tpr_call_writes_done. */
tpr_call *tpr_call_start_cq(tpr_channel *ch, const char *method,
                            const char *const *metadata, size_t n_md,
                            int timeout_ms, tpr_cq *cq);

/* Request the next response message; completes as a TPR_EV_RECV event.
 * Multiple outstanding recv ops on one call complete in order. Returns 0,
 * or -1 if the call is not a CQ call. */
int tpr_call_recv_cq(tpr_call *c, void *tag);

/* Request the terminal status; completes as TPR_EV_FINISH once trailers
 * (or a local terminal condition) arrive. At most one per call. */
int tpr_call_finish_cq(tpr_call *c, void *tag);

/* Async unary: small requests ship HEADERS+request in one buffered write
 * (large ones fragment); ONE TPR_EV_FINISH completion carries response
 * bytes (ok path) AND status — the reference's
 * AsyncResponseReader::Finish(response, status, tag) shape.
 * Returns the call (destroy after the completion) or NULL on refusal. */
tpr_call *tpr_unary_call_cq(tpr_channel *ch, const char *method,
                            const uint8_t *req, size_t req_len,
                            int timeout_ms, tpr_cq *cq, void *tag);

#ifdef __cplusplus
} /* extern "C" */
#endif

#endif /* TPURPC_CLIENT_H */
