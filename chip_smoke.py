#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpurpc_torch``) on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``
(``python3 chip_smoke.py --kernels`` runs phases 1 and 2 only and ends with
the kernels line and the card's name and power limit;
``python3 chip_smoke.py --ctrl-profile TURNS`` builds the kernels, runs
phase 15 (a) alone in TURNS turns and ends with its summary, a JSON line;
``python3 chip_smoke.py --pump-profile TURNS`` builds the kernels, runs
phase 3, then phase 17 (a) alone in TURNS turns and ends with its
summary, a JSON line; ``python3 chip_smoke.py --native-echo TURNS`` runs
phase 22 (b) alone in TURNS turns and ends with its summary, a JSON line).
Phases, each of which fails the run (non-zero exit, no result line) on any
error:

1. build the CUDA kernels from ``tpurpc_torch/csrc`` (one nvcc per source,
   started together) and print ptxas's registers, shared memory and spills;
2. hold each kernel against its plain PyTorch version on the card, byte for
   byte, on a 16 MiB ring at the main path's span size, at odd offsets and
   sizes, and at every start residue mod 16, wrapped and unwrapped. Then
   time each kernel, its plain version and its one-call PyTorch yardstick
   at the main span, 16-byte aligned and skewed (``DeviceTimer``: R
   launches back to back over rotating cold buffer sets behind a leading
   sleep; ROUNDS rounds in turns), and each wrapper's host cost per call;
3. drive the main path: a tpurpc_torch ``Server`` on the device-ring
   platform (``GRPC_PLATFORM_TYPE=TPU``) serving full-width ResNet-50 (1000
   classes, random weights from a seed, float32, TF32 off) through
   ``add_tensor_method(..., device=True)``; 8 requests of float32
   [8,224,224,3] through ``TensorClient.call`` over loopback. Every reply is
   checked against the same model run directly on the same input, both
   kernels must have launched on the path (the 4th and 7th requests wrap the
   16 MiB ring), the ring must never move, and unwrapped views must be
   ledgered ``zero_copy``. The model alone and the device landing alone are
   then timed at the request's shape, to split a request's latency;
4. fan-in serving, as ``bench.py``'s serving leg runs it, on the port's
   default (TCP) platform: a device serialization check (one D2H out, one
   H2D back, bytes equal to the codec's), then (a) full-width ResNet-50 in
   bfloat16 behind ``FanInBatcher(max_batch=8, max_delay_s=0.005,
   fixed_bucket=True, transfer_dtype=torch.bfloat16)`` on a
   ``Server(max_workers=64)``, 8 clients, each its own connection and a
   pipeline of depth 4 (``TensorClient.pipeline``), 16 single-image float32
   [1,224,224,3] requests each; (b) the same in float32 (TF32 off) through
   ``serve_torch(batching=True, max_batch=8)`` (depth-aware flush); (c)
   ``serve_torch(batching=True, batch_shards=2)`` with 32 requests. Every
   reply is checked against the same model run directly on its image,
   padded with zero rows to the bucket shape [8,224,224,3]; batches must
   stack rows across connections. Skipped under ``--kernels``;
5. the bulk stream, as ``bench.py``'s headline Sink stream runs it: a
   client streams float32 [1024,1024] tensors (4 MiB; a different tensor
   for each message index, made from a seed, beside its index as an int64
   [1] leaf) to a ``stream_stream`` tensor method on ``Server(max_workers=
   8)``, which keeps up to 3 messages in flight, reduces each on the card
   (its float64 sum and its values at 64 seeded positions) and replies once
   at the end of the stream. The legs measure the Python plane on purpose
   (``native_dataplane=False``, ``duplex(native=False)``; phase 22 takes
   the native one). Each of three legs gets a fresh server and
   channel, 2 warm-up messages, then 5 timed rounds of 64: (a) rendezvous
   on ``RDMA_BPEV``, each message landed on the host and moved to the card
   by ``to_torch``; (b) the same with ``TPURPC_RENDEZVOUS=0`` (framed);
   (c) rendezvous on the device-ring platform (``TPU``, a 16 MiB
   ``HbmRing``, ``device=True``), each message's ring view reduced before
   the next is pulled. Every round's sums, sampled values and indices are
   checked against numpy's on the client; (a) and (c) must move every
   timed payload by rendezvous (64 transfers a round, no fallback), (a)
   with under 64 KiB of host copies a round; (c) must launch both kernels
   every round (the index leaf makes the spans drift across the ring, so
   about one message in four wraps it). GB/s is the median of the fastest
   3 rounds. Also timed: one 4 MiB ``to_torch`` from a landing region, and
   the card's busy share over one profiled round of (a). Skipped under
   ``--kernels``;
6. the MoE transformer of ``examples/sharded_inference.py`` on a one-rank
   mesh (``build_mesh(1)``) behind fan-in batching, at
   ``TransformerConfig()``'s defaults (vocab 256, d_model 128, 8 heads x
   16, d_ff 256, 4 layers, 2 experts, capacity factor 2.0, 2 microbatches;
   821,376 parameters, random from a seed), 128-token sequences: (a) a
   seeded int32 [8,128] batch on the card against the same module on the
   CPU (float32, TF32 off, within 1e-4 of max(1, max |logit|)), and one
   forward's host clock, device ms and launches in float32 and bf16; (b)
   ``FanInBatcher(make_serve_fn(model), max_batch=8, max_delay_s=0.005,
   fixed_bucket=True)`` on a ``Server``, method "Generate", 8 clients x a
   depth-4 pipeline x 16 int32 [1,128] requests, each reply against the
   direct run of its own tokens and nearer it than any other request's;
   requests/s, tokens/s, p50/p99, batches, the card's busy share; (c) the
   same in bf16 (the same weights cast, within 2^-6); (d) a token at or
   above vocab (NaN rows, as the reference's gather gives) and a negative
   one (wrapped), each against the CPU run of the same tokens, then an
   ordinary request: the CUDA context still serves. Skipped under
   ``--kernels``;
7. training: ``TransformerConfig()`` at the same full width and depth
   (821,376 parameters, random from a seed), float32 with TF32 off, on the
   one-rank mesh: 10 steps of ``build_train_step(cfg, mesh, lr=3e-3)``
   (``torch.optim.AdamW`` with ``optax.adamw``'s defaults) on a seeded
   int32 [8,128] batch with next-token targets. Each step's loss and the
   final parameters are held against the same 10 steps on the CPU from the
   same weights, and the loss must fall below 0.8x its first value. Then
   the same 10 steps once more from the same weights, each part (forward
   and loss, backward, optimizer step) in its own ``torch.profiler``
   window: per step and part, host ms (synchronized), device ms and
   launches. Skipped under ``--kernels``;
8. generation serving with ``ToyDecodeModel``'s state on the card (an
   int64 [B,3] tensor; one device-to-host copy of the tokens a step): (a)
   colocated, as ``bench.py``'s ``_gen_bench`` runs it:
   ``serve_generation(max_batch=8, max_waiting=8, batch_shed_depth=4)``
   with a 1 ms step stand-in, 8 closed-loop streaming clients alternating
   interactive and batch, seeded prompts of 2-64 tokens, 24 tokens a
   stream; tokens/s, TTFT p50/p99, sheds per class, decode steps and rows
   a step, then one step of 8 rows (opaque and paged) under
   ``torch.profiler``; (b) disaggregated, as ``_disagg_bench`` runs it: a
   prefill tier ships KV over block grants into a decode tier, 4 clients
   x 3 streams of 48 tokens; the bytes shipped must equal 16 B per entry;
   a repeated 64-token prompt must score a prefix hit and ship one entry;
   a live stream is migrated between two decode servers (worst
   inter-token gap against the median). Every stream is held token for
   token to ``reference_decode``. Skipped under ``--kernels``;
9. fleet serving, each fleet's workers spawned processes with their own
   CUDA contexts on the card: (a) ``serve_torch_sharded`` of 2 workers on
   one port (``SO_REUSEPORT``), each phase 6's float32 transformer (seed 0,
   TF32 off) behind its own batcher (max_batch 8, 5 ms), phase 6's traffic
   (8 clients x depth 4 x 16 int32 [1,128] requests), every reply against
   the direct run in this process; requests/s, p50/p99 and requests per
   worker (a pid leaf in each reply); then ``drain``: a health Watch held
   on each worker sees NOT_SERVING, every worker reports drained, and
   ``stop`` reaps both. (b) a handoff fleet (round robin) of 2 device-ring
   ResNet-50 workers on phase 3's ring environment: one channel on each,
   phase 3's 8 requests on each, every reply against the direct run; the
   two pids differ and each worker launched each kernel at least twice
   (its 4th and 7th requests wrap). (c) two ``serve_torch`` transformer
   servers and one client ``Channel`` over both with ``lb_policy=
   "least_loaded"``: 8 threads x 16 calls, each server's share, the last
   parsed load reports, every reply against the direct run, and no
   ``tpurpc-load`` key in the app's metadata. Skipped under ``--kernels``;
10. the gRPC wire plane (HTTP/2), on the port's default (TCP) platform;
   the card's machine has no grpcio, so the port's own ``H2Channel``
   drives it: (a) ``serve_torch`` of phase 6's float32 transformer (seed
   0, TF32 off, padded to the [8,128] bucket as in phase 9) behind its
   batcher (max_batch 8, 5 ms) on one port, with 8 threads, each its own
   ``H2Channel``, making 16 closed-loop ``TensorClient.call("Generate")``
   calls of int32 [1,128], and at the same time one native ``Channel``
   pipeline of depth 4 running phase 6's first 16 requests; every reply
   bit-equal to the direct run; requests/s and p50/p99 for each kind of
   client, then the same traffic once more under ``torch.profiler`` for the
   card's busy share. (b) phase 5's 4 MiB messages in one
   ``stream_stream`` call over ``H2Channel``, each landed on the card by
   ``to_torch`` and reduced as phase 5 (a) does: once with rendezvous
   negotiated through ``SETTINGS_TPURPC_RDV`` (every timed message sent
   one-sided, no fallback) and once with ``TPURPC_RENDEZVOUS=0`` (DATA
   frames under flow control); every round exact, GB/s a round. (c)
   ``drain()`` during a tail of (a)'s traffic: each ``H2Channel`` sees the
   GOAWAY, the calls the server took finish with bit-equal replies, the
   rest are refused before the server takes them, and no taken call fails.
   Skipped under ``--kernels``;
11. the call plane on phase 3's device-ring path (``GRPC_PLATFORM_TYPE=
   TPU``, a 16 MiB ``HbmRing``, ``add_tensor_method(..., device=True)``),
   phase 3's ResNet-50 weights, requests and tolerance, through
   ``TensorClient.call``; every reply against the direct run: (a) one
   server behind a ``FaultInjector`` aborting 30 % of attempts
   UNAVAILABLE (seeded), the channel's retryPolicy (5 attempts) and
   retryThrottling (10 tokens, ratio 0.5) delivered by a registered
   resolver's service config: every call succeeds, the server sees the
   attempts and the throttle holds the tokens that the seeded abort
   sequence gives, the kernels launch exactly as in phase 3 (an aborted
   attempt lands nothing) and the ring comes back whole; (b) two
   device-ring servers behind ``round_robin``, the second delayed 1.0 s
   by a ``FaultInjector``, a hedgingPolicy (2 attempts, 50 ms) from the
   ``grpc.service_config`` option: no call waits on the slow replica, the
   fast server answers all, and once every slow handler that started is
   done (a hedge loser cancelled before its request arrived never starts)
   both rings are back to capacity; hedges fired and each server's
   launches (counted around its own landings) are printed; (c) two plain servers, 16
   sequential calls, the first server drained after the 4th reply: no
   call fails and the drained server serves none after; the client's
   FLAG_REFUSED replays and draining redials are counted. Latency p50/p99
   per part, on the host clock. Skipped under ``--kernels``;
12. TLS on the device-ring path, with the test-only PKI of
   ``tests/torch_tls/``: (a) phase 3's ResNet-50 weights and 8 requests on
   ``GRPC_PLATFORM_TYPE=TPU`` with a 16 MiB ``HbmRing``, once through a
   plaintext port and once through ``add_secure_port`` with
   ``ssl_server_credentials(..., require_client_auth=True)`` from a
   ``secure_channel`` with the client's certificate: the ring's bootstrap
   and notify channel ride the TLS socket; the mTLS replies must be
   bit-equal to the plaintext ones (and within phase 3's tolerance of the
   direct run), both kernels must launch as in phase 3 (measured at the
   server), the ring must come back to capacity, and every handler's
   ``auth_context()`` must hold ``ssl`` and the client's URI SAN; p50/p99
   of both runs are printed. (c) a channel trusting only a second CA, an
   insecure channel and a TLS channel without a client certificate must
   each fail UNAVAILABLE on the same port, with neither kernel launched
   and the ring unmoved. (d) on the same server over the mTLS channel: the
   health service, reflection's ListServices (the tensor and health
   services named) and channelz ``GetServer``, whose counts must be the
   calls the phase made there. (b) on the default (TCP) platform, phase
   10's transformer behind its batcher on one server with a plaintext and
   a TLS port: 16 sequential calls through an ``H2Channel`` on each, ALPN
   ``h2`` selected, replies bit-equal to each other and to the direct run,
   requests/s of each, no kernel launched (h2 decodes on the host). Skipped
   under ``--kernels``;
13. the asyncio surface on the device-ring path (``GRPC_PLATFORM_TYPE=
   TPU``, a 16 MiB ``HbmRing``), phase 3's ResNet-50 weights, 8 requests
   and tolerance: an ``aio.Server`` whose async handlers do what
   ``add_tensor_method(..., device=True)`` does (land the request with
   ``decode_tree_to_ring`` on a worker thread, await the forward, serialize
   the reply off the card with ``tree_from_device``, then release the
   leases; ``AioRingServer``), called through an ``aio`` channel: after
   one call of the first request that dials the connection, (a) the 8
   requests at once (``asyncio.gather``), then one after another; (b)
   the same 8 in one ``stream_stream`` call, each landing releasing the
   previous message's leases. Every reply must be bit-equal to the same
   request's through phase 3's sync device path on a server in the same
   process (and within phase 3's tolerance of the direct run), (a) must
   launch both kernels as phase 3 does and every part as its landings
   wrap the ring (counted by the wrappers and at the server), the ring
   must come back to capacity after each part, and at least two handlers
   must have been in flight on the loop at once. Prints (a)'s p50/p99 on
   the host clock, the wall time of the 8 calls together against in
   sequence, and requests/s. The protoc plugin (``tpurpc_torch/codegen``)
   is not driven here: the card's machine has neither protoc nor
   protobuf. Skipped under ``--kernels``;
14. look-aside LB and xDS EDS over two device-ring backends, A and B
   (``GRPC_PLATFORM_TYPE=TPU``, 16 MiB ``HbmRing``s, phase 3's ResNet-50
   weights and 8 requests, each server a ``CallPlaneServer``); every
   request is first served directly by each backend. (a) a
   ``LoadBalancerServicer`` on a server of its own names A, and a
   ``Channel`` over A and B (``round_robin``) with ``enable_lookaside(...,
   wire="grpclb")`` sends the 8 requests, all of which must run on A; the
   balancer then names B and the next 8 must run on B; then the balancer's
   server stops, the channel must fall back to its resolver's list, and 8
   more calls must all succeed, 4 on each. (b) an ``XdsServicer`` on the v3
   ADS stream, ``GRPC_XDS_BOOTSTRAP_CONFIG`` set for this part only, and
   ``xds_channel("xds:///resnet50")``: 8 calls on A, an EDS update to B, 8
   on B, then the control plane stops and 8 more must run on B. In both
   parts every reply must be bit-equal to the same request served directly
   by the backend that ran it (and within phase 3's tolerance of the direct
   run), each server's launches (counted at the server) must equal what
   its rings' offsets give, and every ring must come back to capacity.
   Prints the time from each update to the channel's move and to the end
   of the first handler that ran on B, the fallback's time, and p50/p99
   per part.
   Skipped under ``--kernels``;
15. the head of the transport: the timer wheel, the descriptor-ring
   control plane, compression on the framed wire and the ``tcp_window``
   domain. (a) phase 5's legs (a) and (c), the descriptor ring on and off
   in turns (``TPURPC_CTRL_RING``: on, off, off, on), 3 timed rounds of 64
   each: every round's sums and samples as phase 5, every payload by
   rendezvous with no fallback, with the ring on no control op framed by
   either side (each link's ``ctrl_frames``) and at least one ring post a
   message, with it off no post; leg (c)'s launches in each round must
   equal what its landings' offsets in the server's ring give (the ring's
   tail read before and after the round), the same in every turn. Prints
   each round's GB/s, and per state the median and quartiles over the
   rounds after each turn's first, the server's host ms per message, the
   links' counts, and the turn pairs the ring won. (b) phase 3's 8
   requests on ``TPU``, each with an int64 index of the images' byte size
   beside them, sent once with ``compression="gzip"`` and once without,
   each to a fresh ``CallPlaneServer``: the replies bit-equal, each within
   phase 3's tolerance of the model run directly, the launches (measured
   at the server) equal, the ring whole after each run; then 32 MiB of
   zeros,
   gzipped, to a server with an 8 MiB receive limit must fail
   RESOURCE_EXHAUSTED and launch nothing. Prints the bytes the client's
   endpoint wrote and p50/p99, each way. (c) a spawned server process on
   the card (``GRPC_PLATFORM_TYPE=TPU``, a 16 MiB ring, cuDNN
   deterministic) serves phase 3's 8 requests from this process, once with
   ``TPURPC_RING_DOMAIN=shm`` and once with ``tcp_window``: the replies
   bit-equal across the two, within phase 3's tolerance of the direct run,
   the server's launches equal to what its ring's offsets give, the ring
   whole. Prints p50/p99 on each domain. (d) phase 4's 128 pipelined calls
   (8 clients at depth 4, float32 ResNet-50 through ``serve_torch(batching=
   True)``) run without deadlines and then with one each, sampling
   ``threading.active_count()`` every millisecond: the peaks may differ by
   at most 8 threads (each deadline is an entry on the timer wheel, not a
   thread); then one pipelined call with a 0.2 s deadline on a held
   handler must fail DEADLINE_EXCEEDED at most 0.1 s after it.
   Skipped under ``--kernels``;
16. the connection lifecycle, all on ``TPU`` with phase 3's model and
   requests (each reply checked against the model run directly, or
   bit-equal to an earlier reply of the same request). Each part's
   launches (the wrappers' counts set to 0 just before it) must equal what
   its landings' offsets give (every ``HbmRing`` landing recorded). (a) 64
   channels, each its own connection, a 16 MiB device ring and 1 MiB host
   rings, one call each, then a live channel's 16
   calls; then ``TPURPC_PAIR_PARK_S=0.5`` until every end of the 64 is
   parked (a predicate with its own timeout), the host rings moved from
   leased to free in ``RingPool``, a parked end's resident estimate its
   stub; parking off again, the live channel's 16 calls with the fleet
   parked, then 8 of the 64 call 3 times each: the first call wakes the
   pair and lands at the tail the ring had before the park, the ring never
   moves, every reply bit-equal to the channel's first, and the woken ends
   lease rings again. Prints the live channel's p50 with the fleet parked
   and with parking off. (b) 8 calls through ``inproc_channel`` (no ring:
   0 launches), bit-equal to (a)'s, and 8 inline unary echoes over the
   device-ring platform. (c) ``get_state`` IDLE → CONNECTING → READY,
   ``channel_ready_future``, the p50 of 16 pings; a server with a 1 s max
   connection age serves 16 calls spread over 3 s on at least 3
   connections with no failure; a channel with keepalive 200/1000 ms idle
   for 2 s keeps its connection. (d) 32 channels dial one server at once
   (default ``accept_burst``): all answer bit-equal, none shed; then with
   ``TPURPC_ADMISSION_MAX_INFLIGHT=4`` and every slot held, new dials are
   shed before any handshake (counted at the listener), and once released
   the held calls and new dials complete. The phase must launch both
   kernels. Skipped under ``--kernels``;
17. the inline pump, all on ``TPU`` with phase 3's model, requests and
   replies: a client ring connection has no reader thread, its callers
   read it. Each part's launches (the wrappers' counts set to 0 just
   before it) must equal what its landings' offsets give. (a) phase 3's
   path in 6 turns, a fresh channel each, dialed with
   ``TPURPC_INLINE_PUMP`` ``auto`` or ``0``: 2 warm-up and 32 timed calls a
   turn, every reply bit-equal to phase 3's, a pump-mode connection with no
   reader thread and a reader-mode one with it; prints p50/p99 per turn
   and the median per mode. (b) 64 calls through a ``PipelinedUnary`` of
   depth 16 on one pump-mode connection: every reply bit-equal, one
   servicing thread while calls are in flight, none 1 s after the window
   drains. (c) phase 15 (a)'s device-ring leg (descriptor ring on), the
   pump on and off in 4 turns: every payload by rendezvous with no control
   op framed, launches per round as the ring's offsets give; prints the
   GB/s medians. (d) an idle pump-mode connection must read the server's
   GOAWAY (1.25 s max age) within 1 s of its sending; keepalive 200/1000 ms
   keeps an idle connection 2 s with at least 2 PONGs; prints the p50 of
   32 pings. (e) 8 threads make 16 calls each on one pump-mode
   connection: every reply bit-equal, none past its deadline. Skipped
   under ``--kernels``;
18. the pipelined drain migration and the observability core, all on
   ``TPU`` with phase 3's model, requests and replies. (a) two device-ring
   servers behind one ``round_robin`` channel, a ``PipelinedUnary`` of
   depth 4 and 32 calls; server A drains after reply 8 (its GOAWAY held,
   at most 2 s, until a refused call has replayed): no call fails, every
   reply is bit-equal to phase 3's, A admits nothing after its drain, the
   replays counted at the client (every attempt opens its stream through
   ``_MultiCallable._start``) are at least 1, and each server's measured
   launches equal what its ring's offsets give, both kernels launched.
   (b) the obs plane's readings of (a): ``pipeline_call_us`` counted every
   call, ``srv_calls{method,0}`` every handler run, the flight ring holds
   the drain's two edges and each connection's ``conn-connect``, the
   watchdog tripped 0 times, and the rolling p99 and both load reports'
   p99 are above 0; then one device-ring call with
   ``TPURPC_TRACE_SAMPLE=1`` leaves ``client-send``, ``wire``,
   ``dispatch`` and ``respond`` in order, the server's two inside
   ``wire``. (c) what the plane costs phase 3's path: 20 alternating
   turns of 16 calls, the plane at its defaults (lens sampler running)
   and every switch off (watchdog, tail capture, lens, profiling); prints
   each side's p50, the turn pairs the defaults won and the profiler's
   ``dispatch`` share. A reading, not a gate. Skipped under
   ``--kernels``;
19. the other planes' observability hooks, all on ``TPU`` with phase 3's
   model, requests and replies. (a) 64 device-ring calls of phase 3's
   request under the stage profiler at its default rate: prints each
   stage's share of the attributed samples and thread ms per call, then
   the idle, unattributed and outside-the-package shares; the transport's
   stages together must draw samples. (b) phase 5's device-ring stream
   (2 warm-up and 16 messages): prints each lens hop's bytes, busy ms and
   GB/s; the ``hbm`` hop's bytes, ``hbm_place_bytes`` and
   ``hbm_place_msgs`` must equal the payload bytes and leaves landed at
   the server, and ``ring_scatter``'s launches what the landings' offsets
   give. (c) one rendezvous transfer's offer, claim, write and complete
   under one link's tag, and a 1.5 s handler on the device ring diagnosed
   ``device-infer``. (d) the hooks' cost: phase 3's path in 20 alternating
   turns of 8 calls, the plane at its defaults and every switch off (as
   18 (c)), and one counted turn: flight emits, counter adds and
   histogram records per call. (e) 16 calls over one ``H2Channel``:
   ``srv_calls{method,0}`` reads 16, ``h2_server_connections`` 1 while
   the channel is open and 0 after. Skipped under ``--kernels``;
20. history, alerting and the scrape plane, all on ``TPU`` with phase 3's
   model, requests and replies. (a) 64 device-ring calls between two
   ``GET /metrics`` on the serving port: the text parses as Prometheus
   exposition and the deltas of the copy ledger, ``hbm_place_msgs``/
   ``hbm_place_bytes``, ``srv_calls`` and ``srv_call_us_count`` equal what
   the calls did; ``/debug/history`` holds ``hbm_ring_occupancy_bytes`` and
   ``ring_*`` series on a fine tier of ``TPURPC_TSDB_FINE_S`` = 0.05 s;
   ``/healthz?json=1`` answers 200 with JSON; prints one sample tick's
   host time (median of 50), one ``/metrics`` render's (median of 20) and
   phase 3's p50 in 8 alternating turns of 8 calls with ``TPURPC_TSDB=0``
   and at the default (a reading, not a gate). (b) a latency objective on
   the method (250 ms, 50 %, windows 0.8 s / 1.6 s at 1.2x); slow calls
   whose handler spends 1.2 s in synchronized ResNet-50 forwards on the
   card trip the watchdog at ``device-infer`` (``/debug/diagnose`` ranks it
   first, ``/healthz`` 503 ``watchdog-stall``) until the alert fires
   (``ok → pending → firing``, ``/healthz`` 503 ``slo-firing``); one bundle
   lands under a temporary ``TPURPC_BUNDLE_DIR``, ``tpurpc_torch.tools.
   bundle`` renders it and ``diagnose_bundle`` ranks the live top cause;
   fast calls resolve the alert (``slo-firing`` then ``slo-resolved``);
   every reply bit-equal to phase 3's. (c) phase 9's two spawned
   device-ring workers report non-zero scrape ports; after 4 requests on
   each, the serving port's aggregated ``/metrics`` carries each shard's
   ``hbm_place_bytes`` and call count and its ``/debug/flight`` both
   ``shard-start`` events; a ``FleetCollector`` polls both workers; when
   one worker is killed its series leave the aggregate and the collector
   marks it stale. Skipped under ``--kernels``;
21. the generation plane's observability, with ``ToyDecodeModel``'s state
   on the card. (a) phase 8 (a)'s traffic, its clients alternating two
   accounts sent as ``tpurpc-account``: ``/debug/seq`` on the serving port
   gives each account the tokens its streams received and one sequence
   per completed stream (sheds apart), and attributes at least 95 % of
   the step time; ``gen_ttft_us`` counts one per stream and ``gen_itl_us``
   tokens minus streams; every stream's flight edges run ``seq-submit ->
   gen-join -> seq-first-token -> gen-retire``; ``/healthz?json=1``
   carries the scheduler's ``gen`` line; the stage profiler, stopped
   before, runs from ``Server.start`` and ``/debug/profile`` holds
   ``decode_step`` samples. Then tokens/s in 8 alternating turns with
   ``TPURPC_ODYSSEY=0`` and at the default (a reading, not a gate). (b) a
   spawned ``tpurpc_torch.tools.odyssey_smoke --prefill`` child (its model
   on the card) ships KV over block grants to two decode servers here;
   one traced stream of 48 tokens from a 192-token prompt migrates after
   its 6th token: every token equals ``reference_decode``; the journey
   over decode A and the child has 2 clock-anchored lanes and
   ``seq-ship``, ``seq-decode`` and ``seq-migrate`` spans of the one
   trace id; the source ledger settles ``migrated`` with 1 migration and
   16 bytes shipped per entry (handoff and hop), the target's ledger
   ``retire`` with the hop's bytes; decode A's ``/healthz?json=1`` carries
   its ``gen`` and ``kv`` lines. (c) one decode step of a full batch held
   1.2 s in synchronized steps on the card: the watchdog names
   ``decode-step`` and ``/debug/diagnose`` ranks it first; an ITL
   objective (p99 under 100 ms for 50 % of the samples, phase 20 (b)'s
   windows) goes ``ok -> pending -> firing`` and resolves after fast
   rounds, read from the evaluator's transition history. Each part's
   launches (expected 0) must equal what its device-ring landings give.
   Skipped under ``--kernels``;
22. the native plane (the C core built from ``tpurpc_torch/native/`` at
   first use into ``tpurpc_torch/build/native/``): every ring connection
   of a ``RDMA_BPEV`` server is adopted by ``NativeDataplane``, and the
   calls run inside the library. (a) phase 6's float32 transformer (int32
   [8,128] buckets, on the card) behind such a server, called through a
   ``TensorClient`` over a port ``Channel`` (the native fast unary path,
   one call at a time) and through ``NativeChannel`` with
   ``pipeline(depth=8)``, against the Python plane
   (``native_dataplane=False``, ``TPURPC_NATIVE_FAST_UNARY=0``) in
   alternating turns: every reply bit-equal to the first Python-plane
   reply of its request; prints requests/s per plane and turn and the
   card's busy share in one profiled native window. (b) 64-byte unary
   echoes (``inline=True`` handlers) in 10 alternating turns of 200 calls
   over the Python ring plane, the native fast path and TCP: p50 and p99
   per leg, in this process and then alone in a fresh one
   (``--native-echo 10``). (c) a stream of
   4 MiB float32 tensors, ``duplex(native=True)`` against
   ``native=False`` in alternating turns, each tensor moved to the card
   and summed there: the sums equal on both planes; GB/s per turn; then
   the same tensors as unary calls on the native path. The phase fails if
   the library does not build or load, if a server adopts nothing, or if
   a call meant for the native plane reached the Python plane: the
   adopted count, the Python plane's connection and call counts and the
   library's ledger (``rdv_counters()`` deltas: the unary bulk requests
   rendezvous, the stream's writes ride the send lease and count as the
   C loop's host copies) say so. Skipped under ``--kernels``;
23. print the kernels line, the card's name and power limit, and last the
   one-line result JSON.
"""

import argparse
import json
import os
import subprocess
import sys
import threading
import time

SEED = 0
RING = 16 << 20
BATCH, SIZE = 8, 224
SPAN = BATCH * SIZE * SIZE * 3 * 4   # 4,816,896 bytes: one request's images
REQUESTS = 8
HBM_BYTES_PER_MS = 3.35e12 / 1e3      # H100 SXM memory bandwidth, bytes/ms
#: the timed spans: one request across the wrap, 16-byte aligned as the
#: smoke's traffic lands it, and skewed as a landing after an odd-sized leaf;
#: and 32 bytes across the wrap, whose time is a launch's fixed cost
SPANS = {"aligned": (RING - SPAN // 3, SPAN),
         "skewed": (RING - SPAN // 3 + 3, SPAN + 5),
         "tiny": (RING - 16, 32)}
R = 200          # launches per timed run
SETS = 8         # rotating buffer sets: 8 x (16 MiB + SPAN) = 173 MB
ROUNDS = 5
ORDER = ("kernel", "plain", "library", "library", "plain", "kernel")
HOST_CALLS = 1000
#: reply vs direct model run: same weights, same input, same card, float32
#: with TF32 off — they differ only by cuDNN's choice of algorithm per call
#: shape. Phase 4 takes it of the direct run's largest |logit|, phase 3 of
#: the larger of that and 1
REPLY_TOL = 1e-3
#: card vs CPU on one 64x64 image: float32 both, sums in another order
CPU_TOL = 1e-3
#: phase 4: bench.py's serving leg — 8 clients, one connection and a
#: pipeline of depth 4 each, single-image float32 requests (602,112 bytes)
CLIENTS, DEPTH, PER_CLIENT = 8, 4, 16
MAX_BATCH = 8
SHARD_PER_CLIENT = 4           # (c): 32 requests over 2 batcher shards
#: workers: a request parks one inside the batcher until its batch is done,
#: so fewer than CLIENTS x DEPTH would keep batches from filling
WORKERS = 64
#: bf16 reply vs the same bf16 model run directly on the card at the same
#: call shape [8,224,224,3]: the same kernels, the image at another row.
#: The replies have come out bit-equal (0.0); one bf16 rounding landing the
#: other way in a convolution would move the logits by a bf16 ulp or two
#: (2^-8..2^-7 of their largest); 2^-6 allows that and no more. The scale
#: is the direct run's largest |logit| (about 0.056 with random weights,
#: where the head's bias dominates), so a neighbour's logits, which differ
#: from an image's own by far less than the scale, can pass this check:
#: _check_replies also holds each reply nearest to its own image's run.
BF16_TOL = 2 ** -6
BF16_TOP1_MISS = 2
SER_SHAPE = (1024, 1024)       # serialization check: a 4 MiB float32 tensor
#: environment that phase 3 sets and phase 4 restores
RING_ENV = ("GRPC_PLATFORM_TYPE", "TPURPC_HBM_RING_SIZE_KB")
#: phase 5: bench.py's headline stream — float32 [1024,1024] (4 MiB)
SINK_SHAPE = (1024, 1024)
SINK_WARM, SINK_ROUNDS, SINK_MSGS = 2, 5, 64
SINK_INFLIGHT = 3      # bench.py's consume keeps 3 messages in flight
SINK_WORKERS = 8
SINK_SAMPLES = 64
#: the reference's own bound on a rendezvous stream's host copies
#: (tests/test_rendezvous.py): the control and reply frames only
SINK_COPY_BOUND = 64 * 1024
#: a message's float64 sum on the card vs numpy's: the same float32 terms
#: added in another order, so within 1e-9 of the sum of their magnitudes
#: (float64 rounding over 2^20 terms is below 2^20 x 2^-53 of it)
SINK_SUM_TOL = 1e-9
SINK_ENV = ("GRPC_PLATFORM_TYPE", "TPURPC_RENDEZVOUS",
            "TPURPC_HBM_RING_SIZE_KB", "TPURPC_CTRL_RING")
#: phase 6: the MoE transformer at TransformerConfig()'s defaults (vocab
#: 256, d_model 128, 8 heads x 16, d_ff 256, 4 layers, 2 experts, capacity
#: factor 2.0, 2 microbatches: 821,376 parameters), 128-token sequences
TF_SEQ = 128
TF_PARAMS = 821_376
#: card vs CPU, float32 with TF32 off: the same arithmetic, sums in another
#: order; of max(1, max |logit|). Also the limit of a float32 reply against
#: the direct run of its own tokens on the card
TF_TOL = 1e-4
#: a bf16 reply against the bf16 direct run of its own tokens on the card,
#: of max(1, max |logit|): one bf16 rounding landing the other way moves a
#: logit by 2^-8 of it; 2^-6 allows a few and no routing flip
TF_BF16_TOL = 2 ** -6
#: (d): a token at or above vocab (the reference gathers a NaN row) and a
#: negative one (it wraps), at this position of an otherwise seeded row
TF_OOR, TF_OOR_POS = (300, -1), 17
#: phase 7: 10 AdamW steps at lr 3e-3 on [8,128] tokens, as the reference's
#: test trains (tests/test_transformer.py:58), the loss below 0.8x its first
TRAIN_STEPS, TRAIN_LR, TRAIN_FALL = 10, 3e-3, 0.8
#: card vs CPU, float32 with TF32 off, from the same weights. The two runs
#: are the same arithmetic in another order until a token whose router
#: margin is inside that rounding takes the other expert; from then on
#: they train different models. Readings (NVIDIA H100 80GB HBM3, 700 W):
#: steps 1-8 within 6.9e-7 of the CPU's loss, relative, with every one of
#: the 4,096 tokens routed alike in every layer; at step 9 one token took
#: the other expert (its margin on the CPU 1.1e-5) and the loss moved
#: 1.1e-5, at step 10 six, 1.1e-4. Parameters after 10 steps: largest
#: |diff| 1.1e-3, median at most 1.4e-5. Limits: the first
#: TRAIN_EXACT_STEPS steps' losses (the forward, then one update) within
#: TRAIN_EXACT_TOL; every step's within TRAIN_LOSS_TOL; each parameter's
#: median |diff| at most TRAIN_MEDIAN and none above 2 x lr a step (Adam
#: divides each gradient entry by its RMS, so an entry whose gradient is
#: near 0 and rounds to the other sign on one device moves by up to lr one
#: way there and lr the other here)
TRAIN_EXACT_STEPS, TRAIN_EXACT_TOL = 2, 1e-6
TRAIN_LOSS_TOL = 1e-3
TRAIN_MEDIAN = 1e-4
#: phase 8 (a): bench.py's _gen_bench — ToyDecodeModel with a 1 ms step
#: stand-in behind serve_generation(max_batch=8, max_waiting=8,
#: batch_shed_depth=4); 8 closed-loop clients, alternating interactive and
#: batch, each GEN_STREAMS streams of 24 tokens from seeded prompts of
#: 2-64 tokens. Every token is held exactly to reference_decode
GEN_STEP_S, GEN_TOKENS = 0.001, 24
GEN_CLIENTS, GEN_STREAMS, GEN_PROMPT = 8, 8, (2, 64)
#: phase 8 (b): bench.py's _disagg_bench — 4 clients x 3 streams of 48
#: tokens from 24-token prompts, the same stand-in; a live stream of 400
#: tokens migrated after its 40th
GEN_DIS_CLIENTS, GEN_DIS_TOKENS, GEN_DIS_PROMPT = 4, 48, 24
GEN_MIG_TOKENS, GEN_MIG_AT = 400, 40
#: phase 9: worker processes of each fleet
FLEET_WORKERS = 2
#: phase 10 (a): closed-loop HTTP/2 clients, each its own H2Channel, and
#: the calls each makes; beside them one native pipeline (depth DEPTH) of
#: phase 6's first PER_CLIENT requests. (c): calls each h2 client makes
#: before the drain starts
H2_CLIENTS, H2_CALLS, H2_DRAIN_AFTER = 8, 16, 4
#: H2Channel's details of a call the server never took: the channel had
#: read the GOAWAY (draining, or closed with no call left), or the stream
#: was above the last one the GOAWAY named, or refused by RST_STREAM
#: REFUSED_STREAM (7). A taken call that fails reads "connection: ..."
H2_REFUSED = ("channel draining: ", "channel dead: server sent GOAWAY",
              "stream refused: ", "stream reset by server (h2 error 7)")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# -- phase 1 -----------------------------------------------------------------

def build_kernels():
    from tpurpc_torch.ops import _build

    secs, logs = _build.build(verbose=True)
    print(f"build: {secs:.2f} s for {sorted(_build.KERNELS)}", flush=True)
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if ("ptxas info" in line and "Used" in line) or "spill" in line:
                print(f"  {name}: {line.strip()}")


# -- phase 2 -----------------------------------------------------------------

class DeviceTimer:
    """Device time per launch, with the wrapper's host cost left out.

    One timed run is R launches back to back, each on the next of SETS
    buffer sets (SETS x (RING + SPAN) bytes > twice the 50 MB L2, so every
    launch finds its bytes cold), between two CUDA events. A
    ``torch.cuda._sleep`` enqueued before the first event keeps the card
    busy while the host enqueues the R launches, so the card runs them
    without a gap. The sleep is checked, not assumed: the host's enqueue
    of the R launches must end before the sleep does, or the run is made
    again with a sleep twice as long."""

    def __init__(self):
        import torch

        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        cycles = 20_000_000
        torch.cuda._sleep(cycles)                      # clocks up
        a.record()
        torch.cuda._sleep(cycles)
        b.record()
        b.synchronize()
        self.cycles_per_ms = cycles / a.elapsed_time(b)
        self.cover = 0.0    # largest enqueue / sleep over the timed runs

    def _enqueue(self, fn, sets) -> float:
        t = time.perf_counter()
        for i in range(R):
            fn(sets[i % len(sets)])
        return (time.perf_counter() - t) * 1e3

    def ms(self, fn, sets) -> float:
        import torch

        sleep_ms = 2 * self._enqueue(fn, sets) + 1.0   # untimed pass sizes it
        torch.cuda.synchronize()
        for _ in range(4):
            pre, start, end = (torch.cuda.Event(enable_timing=True)
                               for _ in range(3))
            pre.record()
            torch.cuda._sleep(int(sleep_ms * self.cycles_per_ms))
            start.record()
            enqueue_ms = self._enqueue(fn, sets)
            end.record()
            end.synchronize()
            slept = pre.elapsed_time(start)
            if enqueue_ms < slept:
                self.cover = max(self.cover, enqueue_ms / slept)
                return start.elapsed_time(end) / R
            sleep_ms *= 2
        fail(f"the host's enqueue of {R} launches outlasted a "
             f"{sleep_ms / 2:.2f} ms sleep four times")


def host_us(fn, s) -> float:
    """Host µs per call of ``fn`` over HOST_CALLS calls: enqueue only, one
    synchronize after the clock stops. The card needs less time per call
    than the host takes, so the queue never fills and the clock reads the
    wrapper's host cost alone."""
    import torch

    for _ in range(20):
        fn(s)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn(s)
    us = (time.perf_counter() - t) * 1e6 / HOST_CALLS
    torch.cuda.synchronize()
    return us


def _variants(name: str, start: int, n: int, dev):
    """kernel, plain version and one-call yardstick of one kernel at one
    span, each a function of a buffer set."""
    import torch

    from tpurpc_torch.ops.ring_scatter import ring_scatter, ring_scatter_plain
    from tpurpc_torch.ops.ring_window import ring_window, ring_window_plain

    p = start % RING
    first = min(n, RING - p)
    if name == "ring_scatter":
        idx = (start + torch.arange(n, device=dev)) % RING

        def library(s):
            s["ring"].index_copy_(0, idx, s["payload"][n])

        return {"kernel": lambda s: ring_scatter(s["ring"], s["payload"][n],
                                                 start),
                "plain": lambda s: ring_scatter_plain(s["ring"],
                                                      s["payload"][n], start),
                "library": library}

    def kernel(s):
        s["out"] = ring_window(s["ring"], start, n)

    def plain(s):
        s["out"] = ring_window_plain(s["ring"], start, n)

    def library(s):
        s["out"] = torch.cat([s["ring"][p:p + first], s["ring"][:n - first]])

    return {"kernel": kernel, "plain": plain, "library": library}


def time_kernels(dev, g):
    """Phase 2's timing: each kernel, its plain version and its one-call
    yardstick at the aligned and the skewed main span, in turns (ORDER) for
    ROUNDS rounds; and each wrapper's host cost per call."""
    import statistics

    import torch

    n_max = max(n for _, n in SPANS.values())
    sets = []
    for _ in range(SETS):
        payload = torch.randint(0, 256, (n_max,), dtype=torch.uint8,
                                device=dev, generator=g)
        sets.append({"ring": torch.randint(0, 256, (RING,), dtype=torch.uint8,
                                           device=dev, generator=g),
                     "payload": {n: payload[:n] for _, n in SPANS.values()},
                     "out": None})
    timer = DeviceTimer()
    out = {}
    for name in ("ring_scatter", "ring_window"):
        res = out[name] = {}
        for span, (start, n) in SPANS.items():
            fns = _variants(name, start, n, dev)
            samples = {v: [] for v in fns}
            hosts = {"host_us": [], "plain_host_us": []}
            for _ in range(ROUNDS):
                for v in ORDER:
                    samples[v].append(timer.ms(fns[v], sets))
                if span == "aligned":
                    hosts["host_us"].append(host_us(fns["kernel"], sets[0]))
                    hosts["plain_host_us"].append(host_us(fns["plain"],
                                                          sets[0]))
            samples = {f"{span}_{v}": xs for v, xs in samples.items()}
            for key, xs in (*samples.items(), *hosts.items()):
                if xs:
                    res[key] = (statistics.median(xs), min(xs), max(xs))
        for s in sets:
            s["out"] = None
        for key, (med, lo, hi) in sorted(res.items()):
            if key.endswith("host_us"):
                print(f"  {name} {key}: median {med:.3f} us per call, min "
                      f"{lo:.3f}, max {hi:.3f}", flush=True)
                continue
            start, n = SPANS[key.split("_")[0]]
            print(f"  {name} {key}: median {med:.5f} ms, min {lo:.5f}, max "
                  f"{hi:.5f} (max/min {hi / lo:.3f}); bound "
                  f"{2 * n / HBM_BYTES_PER_MS:.5f} ms (start {start}, "
                  f"{n} bytes)", flush=True)
    print(f"timing: {R} launches per run over {SETS} buffer sets, "
          f"{ROUNDS} rounds of {'/'.join(ORDER)}; the host's enqueue took "
          f"at most {timer.cover:.3f} of the leading sleep", flush=True)
    return out


def check_kernels(dev):
    import torch

    from tpurpc_torch.ops.ring_scatter import ring_scatter, ring_scatter_plain
    from tpurpc_torch.ops.ring_window import ring_window, ring_window_plain

    g = torch.Generator(device=dev).manual_seed(SEED)
    ring = torch.randint(0, 256, (RING,), dtype=torch.uint8, device=dev,
                         generator=g)
    cases = [(0, SPAN), (RING - SPAN // 3, SPAN), (RING - SPAN, SPAN),
             (3, 1001), (RING - 7, 13), (RING - 1, 2), (RING - 1, 1),
             (0, RING), (12345, RING), (RING - 4093, SPAN + 5),
             (SPAN + 1, 4 * 4096 + 3), (RING - 17, 33)]
    # every start residue mod 16, unwrapped and across the wrap
    cases += [(RING - 6144 + r, n) for r in range(16) for n in (4099, 8197)]
    err = {"ring_scatter": 0, "ring_window": 0}
    for start, n in cases:
        payload = torch.randint(0, 256, (n,), dtype=torch.uint8, device=dev,
                                generator=g)
        a, b = ring.clone(), ring.clone()
        ring_scatter(a, payload, start)
        ring_scatter_plain(b, payload, start)
        d = (a.int() - b.int()).abs().max().item()
        check(d == 0, f"ring_scatter != plain at start={start} n={n}")
        err["ring_scatter"] = max(err["ring_scatter"], d)
        w = ring_window(ring, start, n)
        wp = ring_window_plain(ring, start, n)
        check(w.shape == wp.shape, f"ring_window shape at head={start} n={n}")
        d = (w.int() - wp.int()).abs().max().item()
        check(d == 0, f"ring_window != plain at head={start} n={n}")
        err["ring_window"] = max(err["ring_window"], d)
    torch.cuda.synchronize()
    print(f"kernels: {len(cases)} cases byte-equal to their plain versions",
          flush=True)
    return err, time_kernels(dev, g)


# -- phase 3 -----------------------------------------------------------------

def host_ms(fn, reps: int = 5, dev=None) -> float:
    """Mean host-clock time of ``fn`` followed by a synchronize of ``dev``
    (default: the current card)."""
    import torch

    def sync():
        if dev is None:
            torch.cuda.synchronize()
        else:
            _sync(dev)

    for _ in range(2):
        fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        sync()
    return (time.perf_counter() - t0) * 1e3 / reps


def main_path(dev):
    import numpy as np
    import torch

    from tpurpc_torch.models.resnet import make_infer_fn, resnet50
    from tpurpc_torch.ops import ring_scatter as rs_mod
    from tpurpc_torch.ops import ring_window as rw_mod
    from tpurpc_torch.rpc.channel import Channel
    from tpurpc_torch.rpc.server import Server
    from tpurpc_torch.torchshim.service import TensorClient, add_tensor_method
    from tpurpc_torch.tpu import ledger
    from tpurpc_torch.tpu.hbm_ring import HbmRing
    from tpurpc_torch.utils import config

    os.environ["GRPC_PLATFORM_TYPE"] = "TPU"
    os.environ["TPURPC_TORCH_DEVICE"] = str(dev)
    os.environ["TPURPC_HBM_RING_SIZE_KB"] = str(RING >> 10)
    config.set_config(None)

    torch.manual_seed(SEED)
    model = resnet50().to(dev)
    infer = make_infer_fn(model)

    # reference on a small input: the same weights on the CPU
    small = torch.from_numpy(np.random.default_rng(SEED + 1).standard_normal(
        (1, 64, 64, 3)).astype(np.float32))
    on_card = infer(small.to(dev)).cpu()
    cpu_model = resnet50()
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    on_cpu = make_infer_fn(cpu_model)(small)
    scale = on_cpu.abs().max().item()
    d = (on_card - on_cpu).abs().max().item()
    check(torch.isfinite(on_card).all().item(), "non-finite logits on card")
    check(d <= CPU_TOL * max(1.0, scale),
          f"card vs CPU logits differ by {d} (scale {scale})")
    print(f"model: ResNet-50 card vs CPU max |diff| {d:.3g} (scale "
          f"{scale:.3g})", flush=True)
    infer(torch.zeros(BATCH, SIZE, SIZE, 3, device=dev))  # warm cuDNN
    torch.cuda.synchronize()

    def classify(tree):
        logits = infer(tree["images"])
        return {"logits": logits, "top1": logits.argmax(dim=1)}

    srv = Server(max_workers=4)
    add_tensor_method(srv, "Classify", classify, device=True)
    srv.start()
    port = srv.add_insecure_port("127.0.0.1:0")
    ch = Channel(f"127.0.0.1:{port}")
    client = TensorClient(ch)
    rng = np.random.default_rng(SEED)
    images = [rng.standard_normal((BATCH, SIZE, SIZE, 3)).astype(np.float32)
              for _ in range(REQUESTS)]
    try:
        rs_mod.launches = 0
        rw_mod.launches = 0
        lat = []
        replies = []
        with ledger.track() as w:
            t0 = time.perf_counter()
            for x in images:
                t = time.perf_counter()
                replies.append(client.call("Classify",
                                           {"images": torch.from_numpy(x)}))
                lat.append((time.perf_counter() - t) * 1e3)
            wall = time.perf_counter() - t0
        launches = {"ring_scatter": rs_mod.launches,
                    "ring_window": rw_mod.launches}
        ring = srv._connections[0].endpoint.device_ring
        stats = ring.stats()
    finally:
        ch.close()
        srv.stop()

    for i, (x, r) in enumerate(zip(images, replies)):
        want = infer(torch.from_numpy(x).to(dev)).cpu()
        got = r["logits"]
        check(got.shape == (BATCH, 1000), f"reply {i} logits shape {got.shape}")
        check(torch.isfinite(got).all().item(), f"reply {i} non-finite")
        d = (got - want).abs().max().item()
        check(d <= REPLY_TOL * max(1.0, want.abs().max().item()),
              f"reply {i} logits differ from direct run by {d}")
        check(torch.equal(r["top1"], want.argmax(dim=1)),
              f"reply {i} top1 differs from direct run")
    check(launches["ring_scatter"] > 0, "ring_scatter never launched on path")
    check(launches["ring_window"] > 0, "ring_window never launched on path")
    check(ring.buf.data_ptr() == ring._base_ptr, "device ring moved")
    check(stats["head"] == stats["tail"] and stats["live_spans"] == 0,
          f"ring credit not returned: {stats}")
    wraps = sum(1 for k in range(REQUESTS)
                if (k * SPAN) % RING + SPAN > RING)
    check(w["zero_copy_ops"] == REQUESTS - wraps
          and w["zero_copy"] == (REQUESTS - wraps) * SPAN,
          f"unwrapped views not ledgered zero_copy: {w.delta}")
    print(f"main path: {REQUESTS} ResNet-50 requests of float32 "
          f"[{BATCH},{SIZE},{SIZE},3], {wraps} wrapped; launches {launches}",
          flush=True)
    p50 = sorted(lat)[len(lat) // 2]
    print("latency ms: " + " ".join(f"{v:.2f}" for v in lat), flush=True)
    print(f"requests/s: {REQUESTS / wall:.3f} (p50 {p50:.2f} ms)", flush=True)

    # where a request's time goes: the model alone and the device landing
    # alone (staging copy, landing write, view) at the request's shape
    x = torch.from_numpy(images[0]).to(dev)
    model_ms = host_ms(lambda: infer(x))
    ring2 = HbmRing(RING, device=dev)
    payload = images[0].reshape(-1).view(np.uint8)

    def land():
        off, n = ring2.place(payload)
        ring2.view(off, n, dtype=torch.float32,
                   shape=(BATCH, SIZE, SIZE, 3)).release()

    land_ms = host_ms(land)
    print(f"breakdown ms: request p50 {p50:.2f} = model {model_ms:.2f} + "
          f"device landing {land_ms:.2f} + rest (codec, transport, framing, "
          f"reply) {p50 - model_ms - land_ms:.2f}", flush=True)
    _PHASE3.update(infer=infer, images=images, replies=replies)
    return launches


# -- phase 4 -----------------------------------------------------------------

def check_serialization(dev):
    """``serialize_from_device`` of a CUDA tensor: one D2H into pinned
    memory, bytes equal to the codec's encoding of its CPU copy; and
    ``deserialize_to_device`` gives it back with one H2D."""
    import torch

    from tpurpc_torch.torchshim import codec
    from tpurpc_torch.tpu import ledger
    from tpurpc_torch.tpu.serialize import (deserialize_to_device,
                                            serialize_from_device)

    g = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn(SER_SHAPE, device=dev, generator=g)
    n = x.numel() * x.element_size()
    with ledger.track() as w:
        segs = serialize_from_device(x)
    buf = b"".join(bytes(memoryview(s).cast("B")) for s in segs)
    check(buf == codec.encode_tensor_bytes(x.cpu()),
          "serialize_from_device bytes differ from the codec's")
    check(w["dma_d2h_ops"] == 1 and w["dma_d2h"] == n and w["host_copy"] == 0,
          f"serialize_from_device ledger: {w.delta}")
    with ledger.track() as w2:
        y, end = deserialize_to_device(buf, device=dev)
    check(end == len(buf) and y.device == x.device and torch.equal(y, x),
          "deserialize_to_device did not give the tensor back")
    check(w2["dma_h2d_ops"] == 1 and w2["dma_h2d"] == n,
          f"deserialize_to_device ledger: {w2.delta}")
    print(f"serialize: float32 {list(SER_SHAPE)} ({n} bytes) out in one "
          f"D2H, back in one H2D, bytes equal to the codec's", flush=True)


def drive_clients(port: int, images, per_client: int, batcher,
                  method: str = "Infer", key: str = "x",
                  call_timeout: "float | None" = 300):
    """CLIENTS pipelined clients, each its own Channel and a depth-DEPTH
    pipeline, as bench.py's serving leg: one warm call each, then, from a
    common start, ``per_client`` requests each (client c sends
    ``images[c * per_client:(c + 1) * per_client]``, each as the leaf
    ``key`` of a call to ``method``). Returns the replies,
    each request's latency in ms (``call_async`` to completion), the wall
    time in s of the timed part, and the batcher's (rows_run, batches_run)
    at the start (None without a batcher in this process): every warm call
    has completed by then. Each pipelined call has the deadline
    ``call_timeout`` (None: none)."""
    import threading

    import numpy as np
    import torch

    from tpurpc_torch.rpc.channel import Channel
    from tpurpc_torch.torchshim.service import TensorClient

    n = CLIENTS * per_client
    replies, lat = [None] * n, [None] * n
    errors = []
    start = threading.Barrier(CLIENTS + 1, timeout=300)
    done = threading.Barrier(CLIENTS + 1, timeout=600)

    def client(c):
        try:
            with Channel(f"127.0.0.1:{port}") as ch:
                cli = TensorClient(ch, depth=DEPTH)
                warm = np.zeros_like(images[0])
                cli.call(method, {key: torch.from_numpy(warm)}, timeout=300)
                pl = cli.pipeline(method)
                start.wait()
                inflight = []
                for i in range(c * per_client, (c + 1) * per_client):
                    while len(inflight) >= DEPTH:
                        j, fut = inflight.pop(0)
                        replies[j] = fut.result(timeout=300)
                    t0 = time.perf_counter()
                    fut = pl.call_async({key: torch.from_numpy(images[i])},
                                        timeout=call_timeout)
                    fut.add_done_callback(
                        lambda _f, i=i, t0=t0: lat.__setitem__(
                            i, (time.perf_counter() - t0) * 1e3))
                    inflight.append((i, fut))
                for j, fut in inflight:
                    replies[j] = fut.result(timeout=300)
        except Exception as exc:  # surfaced after the join
            errors.append(f"client {c}: {exc!r}")
            start.abort()
        finally:
            try:
                done.wait()
            except threading.BrokenBarrierError:
                pass

    ts = [threading.Thread(target=client, args=(c,), daemon=True)
          for c in range(CLIENTS)]
    for t in ts:
        t.start()
    try:
        start.wait()
    except threading.BrokenBarrierError:
        pass
    t0 = time.perf_counter()
    before = (None if batcher is None
              else (batcher.rows_run, batcher.batches_run))
    try:
        done.wait()
    except threading.BrokenBarrierError:
        pass
    wall = time.perf_counter() - t0
    for t in ts:
        t.join(60)
    check(not errors, "; ".join(errors))
    deadline = time.monotonic() + 10   # done-callbacks run after result()
    while None in lat and time.monotonic() < deadline:
        time.sleep(0.01)
    check(not any(t.is_alive() for t in ts), "a client did not finish")
    check(all(r is not None for r in replies) and None not in lat,
          "a request got no reply")
    return replies, lat, wall, before


def _direct(infer, image, dev):
    """The model run directly on one image (or one request's leaf), padded
    with zero rows to the bucket shape (phase 4: [MAX_BATCH,224,224,3]): row
    0 of the logits, on the host."""
    import torch

    row = torch.from_numpy(image)
    x = torch.zeros((MAX_BATCH, *row.shape[1:]), dtype=row.dtype)
    x[:1] = row
    return infer(x.to(dev))[:1].float().cpu()


def _check_replies(label, replies, images, infer, dev, tol, top1_min,
                   floor=0.0):
    """Each reply against the direct run of its own image, within ``tol``
    of that run's largest |logit| (or of ``floor``, if larger), and
    strictly nearer to it than to the direct run of any other image of the
    run (so a reply delivered to the wrong caller, or rows split off by
    one, fails). Returns (max |diff| / scale, the least distance to another
    image's run / scale, top-1 agreements; None when ``top1_min`` is)."""
    import torch

    wants = torch.cat([_direct(infer, img, dev) for img in images])
    for i, r in enumerate(replies):
        got = r["logits"]
        check(got.shape == wants[i:i + 1].shape and got.dtype == torch.float32,
              f"{label} reply {i}: logits {tuple(got.shape)} {got.dtype}")
        check(bool(torch.isfinite(got).all()), f"{label} reply {i} non-finite")
    got = torch.cat([r["logits"] for r in replies]).flatten(1)
    wants = wants.flatten(1)
    scale = wants.abs().amax(dim=1).clamp(min=floor)
    # dist[i, j]: max |diff| of reply i against image j's direct run
    dist = torch.stack([(g - wants).abs().amax(dim=1) for g in got])
    own = dist.diagonal()
    others = dist + torch.diag(torch.full_like(own, float("inf")))
    nearest_other = others.amin(dim=1)
    for i in range(len(replies)):
        check(own[i] <= tol * scale[i], f"{label} reply {i} differs from the "
              f"direct run by {own[i].item()} (scale {scale[i].item()}, "
              f"tolerance {tol} x scale)")
        check(own[i] < nearest_other[i], f"{label} reply {i} is no nearer its "
              f"own image's run ({own[i].item()}) than image "
              f"{others[i].argmin().item()}'s ({nearest_other[i].item()})")
    agree = None
    if top1_min is not None:
        agree = int((got.argmax(1) == wants.argmax(1)).sum())
        check(agree >= top1_min, f"{label}: top-1 agrees on {agree} of "
              f"{len(replies)} replies, want at least {top1_min}")
    return ((own / scale).max().item(), (nearest_other / scale).min().item(),
            agree)


def _stats(label, batcher, before, replies, lat, wall, card,
           unit="images"):
    """Check that every request ran once and batches stacked rows across
    connections; print and return (requests/s, batches, mean rows, p50,
    p99)."""
    import numpy as np

    rows = batcher.rows_run - before[0]
    batches = batcher.batches_run - before[1]
    n = len(replies)
    check(rows == n, f"{label}: rows_run {rows} != requests {n}")
    check(batches < n, f"{label}: {batches} batches for {n} requests: no "
          f"stacking across connections")
    p50, p99 = np.percentile(lat, [50, 99])
    print(f"{label}: {n} requests from {CLIENTS} clients at depth {DEPTH}: "
          f"{batches} batches, mean rows {rows / batches}, {unit}/s "
          f"{n / wall}, latency ms p50 {p50} p99 {p99} ({card})", flush=True)
    return n / wall, batches, rows / batches, p50, p99


def fanin_serving(dev, card: str, saved_env: dict) -> None:
    import numpy as np
    import torch

    from tpurpc_torch.models.resnet import make_infer_fn, resnet50
    from tpurpc_torch.rpc.server import Server
    from tpurpc_torch.torchshim.service import (FanInBatcher,
                                                add_tensor_method,
                                                serve_torch)
    from tpurpc_torch.utils import config

    for key, val in saved_env.items():   # off phase 3's device-ring platform
        if val is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = val
    config.set_config(None)
    print(f"fan-in platform: {config.get_config().platform.value}",
          flush=True)
    check_serialization(dev)

    rng = np.random.default_rng(SEED)
    images = [rng.standard_normal((1, SIZE, SIZE, 3)).astype(np.float32)
              for _ in range(CLIENTS * PER_CLIENT)]

    # (a) bench configuration: bf16 ResNet-50 behind a fixed-bucket batcher
    torch.manual_seed(SEED)
    infer16 = make_infer_fn(resnet50(dtype=torch.bfloat16).to(dev))
    x8 = torch.zeros(MAX_BATCH, SIZE, SIZE, 3, device=dev)
    infer16(x8)
    torch.cuda.synchronize()
    batcher = FanInBatcher(lambda t: {"logits": infer16(t["x"])},
                           max_batch=MAX_BATCH, max_delay_s=0.005,
                           fixed_bucket=True, transfer_dtype=torch.bfloat16,
                           device=dev)
    srv = Server(max_workers=WORKERS)
    add_tensor_method(srv, "Infer", batcher)
    srv.start()
    port = srv.add_insecure_port("127.0.0.1:0")
    try:
        replies, lat, wall, before = drive_clients(port, images, PER_CLIENT,
                                                   batcher)
    finally:
        srv.stop()
        batcher.close()
    worst, apart, agree = _check_replies(
        "bf16", replies, images, infer16, dev, BF16_TOL,
        len(replies) - BF16_TOP1_MISS)
    _stats("fan-in bf16", batcher, before, replies, lat, wall, card)
    model_ms = host_ms(lambda: infer16(x8))
    scale = max(r["logits"].abs().max().item() for r in replies)
    top1 = len({r["logits"].argmax().item() for r in replies})
    print(f"fan-in bf16: replies vs direct runs max |diff| / scale {worst}, "
          f"nearest other image's run {apart} x scale (scale up to {scale}); "
          f"top-1 equal on {agree} of {len(replies)} ({top1} distinct "
          f"classes); the bf16 model alone "
          f"at [{MAX_BATCH},{SIZE},{SIZE},3] {model_ms} ms by host clock "
          f"({card})", flush=True)
    bf16_logits = [r["logits"] for r in replies]

    # (b) exactness: float32 (TF32 off) through serve_torch, depth-aware
    # flush, buckets by power of two; (c) the same over two batcher shards
    torch.manual_seed(SEED)   # the same weights as the bf16 model's
    infer32 = make_infer_fn(resnet50().to(dev))
    infer32(x8)
    shapes = []

    def classify(t):
        shapes.append(int(t["x"].shape[0]))
        return {"logits": infer32(t["x"])}

    for label, shards, per_client in (("fan-in float32", 1, PER_CLIENT),
                                      ("fan-in float32 2 shards", 2,
                                       SHARD_PER_CLIENT)):
        shapes.clear()
        srv, port, batcher = serve_torch(
            classify, name="Infer", batching=True, max_batch=MAX_BATCH,
            max_workers=WORKERS, batch_shards=shards)
        sub = images[:CLIENTS * per_client]
        try:
            replies, lat, wall, before = drive_clients(port, sub, per_client,
                                                       batcher)
        finally:
            srv.stop()
            batcher.close()
        worst, apart, _ = _check_replies(label, replies, sub, infer32, dev,
                                         REPLY_TOL, len(replies))
        _stats(label, batcher, before, replies, lat, wall, card)
        print(f"{label}: dispatched batch sizes {sorted(set(shapes))}; "
              f"replies vs direct runs max |diff| / scale {worst}, nearest "
              f"other image's run {apart} x scale", flush=True)
        if shards == 1:
            gap = max((a - r["logits"]).abs().max().item()
                      for a, r in zip(bf16_logits, replies))
            print(f"bf16 vs float32 replies, same weights: max |diff| {gap}",
                  flush=True)


# -- phase 5 -----------------------------------------------------------------

def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def sink_payloads(shape=SINK_SHAPE, msgs=SINK_MSGS):
    """The client's messages and what the server must find in them: for
    message i, float32 ``base + i`` (base from the seed), its float64 sum
    by numpy, the sum of its magnitudes, and its values at the sampled
    flat positions."""
    import numpy as np

    rng = np.random.default_rng(SEED + 5)
    base = rng.standard_normal(shape).astype(np.float32)
    idx = np.sort(rng.choice(base.size, SINK_SAMPLES, replace=False))
    xs = [base + np.float32(i) for i in range(msgs)]
    sums = np.array([x.astype(np.float64).sum() for x in xs])
    mags = np.array([np.abs(x.astype(np.float64)).sum() for x in xs])
    samples = np.stack([x.reshape(-1)[idx] for x in xs])
    return xs, idx, sums, mags, samples


def _sink_consume(dev, idx, device_ring: bool, stages: dict):
    """bench.py's Sink on the card: each message's float64 sum and its
    values at ``idx``, one reply at the end of the stream. Host-landed, a
    message moves to the card by ``to_torch`` and up to SINK_INFLIGHT wait
    to be reduced; from the device ring, a message's view is reduced (on
    the ring's stream) before the next message is pulled, whose decode
    returns the view's ring credit. ``stages`` gathers the handler's host
    seconds: ``pull`` (waiting for and decoding the next message — on the
    device ring, its landing too), ``h2d`` (``to_torch``), ``reduce``."""
    from collections import deque

    import torch

    from tpurpc_torch.torchshim.codec import to_torch

    idx_dev = torch.as_tensor(idx, device=dev)

    def consume(trees):
        seen, sums, samples = [], [], []
        inflight = deque()
        clock = time.perf_counter

        def retire(x):
            t = clock()
            sums.append(x.double().sum())
            samples.append(x.reshape(-1)[idx_dev])
            stages["reduce"] += clock() - t

        it = iter(trees)
        while True:
            t = clock()
            tree = next(it, None)
            stages["pull"] += clock() - t
            if tree is None:
                break
            # hold no alias of the message while waiting for the next: a
            # landing region recycles (its doorbell rings) when the last dies
            seen.append(tree.pop("i").clone())
            x = tree.pop("x")
            if device_ring:
                retire(x)
                continue
            t = clock()
            inflight.append(to_torch(x, dev))
            x = None
            stages["h2d"] += clock() - t
            if len(inflight) > SINK_INFLIGHT:
                retire(inflight.popleft())
        while inflight:
            retire(inflight.popleft())
        yield {"i": torch.cat(seen).cpu(),
               "sums": torch.stack(sums).cpu(),
               "samples": torch.stack(samples).cpu()}

    return consume


def _check_sink(label, reply, n, want):
    import numpy as np

    _, _, sums, mags, samples = want
    got_i = reply["i"].numpy()
    check(got_i.tolist() == list(range(n)),
          f"{label}: the server saw message indices {got_i.tolist()[:8]}...")
    got = reply["sums"].numpy()
    err = np.abs(got - sums[:n])
    check(bool((err <= SINK_SUM_TOL * mags[:n]).all()),
          f"{label}: sums differ from numpy's by up to "
          f"{(err / mags[:n]).max()} of the magnitudes")
    check(np.array_equal(reply["samples"].numpy(), samples[:n]),
          f"{label}: sampled values differ from numpy's")
    return float((err / mags[:n]).max())


def device_events(prof) -> list:
    """A trace's kernels and copies (device events, not the host ops that
    launched them, whose device time would count them twice)."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def device_busy_ms(prof) -> float:
    """Summed device time (ms) of every kernel and copy in a trace."""
    return sum(e.self_device_time_total for e in device_events(prof)) / 1e3


def sink_leg(label, dev, card, want, env, device_ring=False,
             rounds=SINK_ROUNDS, profile=False, on_link=None, h2=False):
    """One leg of phase 5 on a fresh server and channel: warm-up, then
    ``rounds`` timed rounds of the stream. Returns per-round records and
    the leg's GB/s. ``on_link(link)`` sees the client's rendezvous link
    after the warm-up (``sink_profile.py`` times its sends). ``h2``: the
    client is an ``H2Channel`` (phase 10 (b)). With ``device_ring`` each
    record holds the server's device rings' tails before and after its
    round (``ring_tails``)."""
    import torch

    from tpurpc_torch.ops import ring_scatter as rs_mod
    from tpurpc_torch.ops import ring_window as rw_mod
    from tpurpc_torch.rpc.channel import Channel
    from tpurpc_torch.rpc.server import Server
    from tpurpc_torch.torchshim.service import TensorClient, add_tensor_method
    from tpurpc_torch.tpu import ledger
    from tpurpc_torch.utils import config
    from tpurpc_torch.wire.h2_client import H2Channel

    xs, idx = want[0], want[1]
    for key in SINK_ENV:
        os.environ.pop(key, None)
    os.environ.update(env)
    config.set_config(None)
    tensors = [torch.from_numpy(x) for x in xs]
    n = len(xs)

    def gen(k):
        for i in range(k):
            yield {"i": torch.tensor([i]), "x": tensors[i]}

    stages = {"pull": 0.0, "h2d": 0.0, "reduce": 0.0}
    # the Python plane, on purpose: its ledger and links are what the leg
    # reads (the native plane's are phase 22's)
    srv = Server(max_workers=SINK_WORKERS, native_dataplane=False)
    add_tensor_method(srv, "Sink",
                      _sink_consume(dev, idx, device_ring, stages),
                      kind="stream_stream", device=device_ring)
    srv.start()
    port = srv.add_insecure_port("127.0.0.1:0")
    out = []
    try:
        with (H2Channel if h2 else Channel)(f"127.0.0.1:{port}") as ch:
            cli = TensorClient(ch)
            warm = list(cli.duplex("Sink", gen(SINK_WARM), timeout=300,
                                   native=False))
            _check_sink(f"{label} warm-up", warm[-1], SINK_WARM, want)
            link = ch.rdv if h2 else ch._conn.rdv
            if on_link is not None:
                on_link(link)
            for r in range(rounds + int(profile)):
                prof = None
                if r == rounds:   # one more round, profiled, not timed
                    prof = torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA])
                    prof.__enter__()
                s0 = link.stats() if link is not None else None
                sv0 = _link_delta(srv)
                tails0 = _device_ring_tails(srv) if device_ring else None
                rs_mod.launches = 0
                rw_mod.launches = 0
                for key in stages:
                    stages[key] = 0.0
                with ledger.track() as w:
                    t0 = time.perf_counter()
                    replies = list(cli.duplex("Sink", gen(n), timeout=300,
                                              native=False))
                    dt = time.perf_counter() - t0
                launches = {"ring_scatter": rs_mod.launches,
                            "ring_window": rw_mod.launches}
                tails = (None if tails0 is None else
                         list(zip(tails0, _device_ring_tails(srv))))
                err = _check_sink(f"{label} round {r}", replies[-1], n, want)
                if prof is not None:
                    prof.__exit__(None, None, None)
                    busy = device_busy_ms(prof)
                    print(f"{label}: one profiled round, card busy {busy} ms "
                          f"of {dt * 1e3} ms ({busy / (dt * 1e3)}) ({card})",
                          flush=True)
                    break
                rec = {"s": dt, "gbps": n * xs[0].nbytes / dt / 1e9,
                       "ledger": {k: w[k] for k in ("rdma_write",
                                                    "host_copy",
                                                    "dma_h2d", "dma_d2d")},
                       "launches": launches, "sum_err": err,
                       "ring_tails": tails,
                       "server_ms": {k: v * 1e3 / n
                                     for k, v in stages.items()}}
                if link is not None:
                    s1 = link.stats()
                    rec["link"] = {k: s1[k] - s0[k] for k in LINK_KEYS}
                    rec["srv_link"] = _link_delta(srv, sv0)
                out.append(rec)
                print(f"{label} round {r}: {rec['gbps']:.4f} GB/s, ledger "
                      f"{rec['ledger']}, link {rec.get('link')}, server's "
                      f"links {rec.get('srv_link')}, launches "
                      f"{launches}, server host ms per message "
                      f"{rec['server_ms']}", flush=True)
    finally:
        srv.stop()
    gbps = sorted((rec["gbps"] for rec in out), reverse=True)
    kept = gbps[:max(1, (len(gbps) + 1) // 2)]   # the fastest 3 of 5
    print(f"{label}: GB/s median of the fastest {len(kept)} "
          f"{kept[len(kept) // 2]} (min {gbps[-1]}, max {gbps[0]}) over "
          f"{len(out)} rounds of {n} x {xs[0].nbytes} bytes; sums within "
          f"{max(r['sum_err'] for r in out)} of the magnitudes ({card})",
          flush=True)
    return out, kept[len(kept) // 2]


#: a rendezvous link's counters that a round's record keeps: transfers,
#: fallbacks, control ops framed and control ops posted into the peer's
#: descriptor ring
LINK_KEYS = ("sent", "received", "fallbacks", "ctrl_frames", "ctrl_posts")


def _device_ring_tails(srv) -> list:
    """The tails (absolute bytes ever placed) of the device rings of a
    server's connections, in the connections' order."""
    return [c.endpoint.device_ring.stats()["tail"]
            for c in list(srv._connections)
            if getattr(c.endpoint, "_hbm", None) is not None]


def _landing_launches(first: int, tail: int, leaves, ring: int) -> dict:
    """The kernel launches that messages of ``leaves`` (their leaves' byte
    sizes, in the codec's order) give, landed back to back from absolute
    offset ``first`` up to ``tail`` of a ring of ``ring`` bytes, each by
    one ``place_many``: a ``ring_scatter`` for each message whose landing
    wraps, a ``ring_window`` for each leaf whose view wraps."""
    span = sum(leaves)
    check((tail - first) % span == 0, f"the ring advanced {tail - first} "
          f"bytes, not a whole number of {span}-byte messages")
    got = {"ring_scatter": 0, "ring_window": 0}
    for k in range((tail - first) // span):
        pos = first + k * span
        got["ring_scatter"] += pos % ring + span > ring
        for n in leaves:
            got["ring_window"] += pos % ring + n > ring
            pos += n
    return got


def _link_delta(srv, before=None) -> dict:
    """The summed counters of a server's connections' rendezvous links, or
    their change since ``before``."""
    tot = {k: 0 for k in LINK_KEYS}
    for conn in list(srv._connections):
        link = getattr(conn, "rdv", None)
        if link is not None:
            st = link.stats()
            for k in LINK_KEYS:
                tot[k] += st[k]
    if before is None:
        return tot
    return {k: tot[k] - before[k] for k in LINK_KEYS}


def landing_to_torch_ms(dev, x) -> float:
    """Host-clock ms of one ``to_torch`` of a tensor decoded from a
    rendezvous landing region (synchronized; mean of 5)."""
    from tpurpc_torch.core import rendezvous as rdv
    from tpurpc_torch.torchshim import codec

    desc, payload = codec.encode_tensor_descriptor(x)
    lease = rdv.landing_pool("shm").lease(len(payload), 0)
    try:
        off = lease.pr.offset
        lease.pr.region.buf[off:off + len(payload)] = payload
        body = lease.deliver(len(payload))
        t = codec.decode_tensor_external(desc, body)
        del body
        ms = host_ms(lambda: codec.to_torch(t, dev))
        got = codec.to_torch(t, dev)
        _sync(dev)
        check(bool((got.cpu() == t).all()), "to_torch of a landing region")
        del t, got
    finally:
        lease.release()
    return ms


def sink_stream(dev, card, want=None, rounds=SINK_ROUNDS, ring=RING):
    """Phase 5: the three legs. Returns leg (c)'s launches per round."""
    saved = {k: os.environ.get(k) for k in SINK_ENV}
    want = want or sink_payloads()
    try:
        a, _ = sink_leg("sink (a) rendezvous, host-landed", dev, card,
                        want, {"GRPC_PLATFORM_TYPE": "RDMA_BPEV"},
                        rounds=rounds, profile=dev.type == "cuda")
        for r, rec in enumerate(a):
            check(rec["link"]["sent"] == len(want[0])
                  and rec["link"]["fallbacks"] == 0,
                  f"sink (a) round {r}: not every payload rode rendezvous: "
                  f"{rec['link']}")
            check(rec["ledger"]["host_copy"] < SINK_COPY_BOUND,
                  f"sink (a) round {r}: host_copy {rec['ledger']}")
        sink_leg("sink (b) framed", dev, card, want,
                 {"GRPC_PLATFORM_TYPE": "RDMA_BPEV", "TPURPC_RENDEZVOUS": "0"},
                 rounds=rounds)
        c, _ = sink_leg("sink (c) rendezvous, device ring", dev, card,
                        want, {"GRPC_PLATFORM_TYPE": "TPU",
                               "TPURPC_HBM_RING_SIZE_KB": str(ring >> 10)},
                        device_ring=True, rounds=rounds)
        for r, rec in enumerate(c):
            check(rec["link"]["sent"] == len(want[0])
                  and rec["link"]["fallbacks"] == 0,
                  f"sink (c) round {r}: not every payload rode rendezvous: "
                  f"{rec['link']}")
            check(min(rec["launches"].values()) >= 1,
                  f"sink (c) round {r}: a kernel never launched: "
                  f"{rec['launches']}")
    finally:
        for key, val in saved.items():
            if val is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = val
    ms = landing_to_torch_ms(dev, want[0][0])
    print(f"sink: one to_torch of {want[0][0].nbytes} bytes from a landing "
          f"region {ms} ms by host clock ({card})", flush=True)
    return [rec["launches"] for rec in c]


# -- phase 6 -----------------------------------------------------------------

def _profiled_forward(fn):
    """Launches, device ms and the 4 costliest kernels (ms, count, name) of
    one call of ``fn`` (already warm) under ``torch.profiler``, as
    ``fanin_profile.py`` reads them."""
    import torch

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = device_events(prof)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:4]
    return (sum(e.count for e in events), device_busy_ms(prof),
            [(e.self_device_time_total / 1e3, e.count, e.key[:60])
             for e in top])


def _forward_parts(dev, card, cfg, mesh, model):
    """The float32 forward's two largest parts alone, at the path's shapes:
    one layer's ring attention and MoE block on one microbatch (a forward
    runs each n_layers x n_micro times). Host clock, and on a card device
    ms and launches."""
    import torch

    from tpurpc_torch.parallel.moe import MoEParams, moe_block
    from tpurpc_torch.parallel.ring_attention import ring_attention_block

    mb = MAX_BATCH // cfg.n_micro
    per_forward = cfg.n_layers * cfg.n_micro
    g = torch.Generator().manual_seed(SEED)
    q, k, v = (torch.randn((mb, cfg.n_heads, TF_SEQ, cfg.head_dim),
                           generator=g).to(dev) for _ in range(3))
    x = torch.randn((mb * TF_SEQ, cfg.d_model), generator=g).to(dev)
    moe = MoEParams(model.router[0], model.w_in[0], model.w_out[0])
    parts = {
        f"ring attention [{mb},{cfg.n_heads},{TF_SEQ},{cfg.head_dim}]":
            lambda: ring_attention_block(q, k, v, mesh, causal=True),
        f"MoE block [{mb * TF_SEQ},{cfg.d_model}]":
            lambda: moe_block(moe, x, mesh,
                              capacity_factor=cfg.capacity_factor)}
    with torch.inference_mode():
        for name, fn in parts.items():
            ms = host_ms(fn, reps=10, dev=dev)
            dev_part = "device time and launches not measured"
            if dev.type == "cuda":
                launches, device_ms, _ = _profiled_forward(fn)
                dev_part = f"device {device_ms} ms, {launches} launches"
            print(f"transformer (a) float32 {name}, x{per_forward} a "
                  f"forward: host clock {ms} ms, {dev_part} ({card})",
                  flush=True)


def _tf_serve(label, serve, dev, rows, per_client, card, check_fn):
    """One fan-in run of ``serve`` behind FanInBatcher(max_batch=8,
    max_delay_s=0.005, fixed_bucket=True) on a Server, method "Generate":
    CLIENTS pipelined clients send ``rows`` (int32 [1,TF_SEQ] each). The
    replies go to ``check_fn``; then, on a card, the same run once more
    under ``torch.profiler`` for the card's busy share of its window."""
    import torch

    from tpurpc_torch.rpc.server import Server
    from tpurpc_torch.torchshim.service import FanInBatcher, add_tensor_method

    out = {}
    for profiled in ((False, True) if dev.type == "cuda" else (False,)):
        batcher = FanInBatcher(serve, max_batch=MAX_BATCH, max_delay_s=0.005,
                               fixed_bucket=True, device=dev)
        srv = Server(max_workers=WORKERS)
        add_tensor_method(srv, "Generate", batcher)
        srv.start()
        port = srv.add_insecure_port("127.0.0.1:0")
        prof = None
        try:
            if profiled:
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
                prof.__enter__()
            t0 = time.perf_counter()
            replies, lat, wall, before = drive_clients(
                port, rows, per_client, batcher, method="Generate",
                key="tokens")
            window = time.perf_counter() - t0
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
            srv.stop()
            batcher.close()
        if profiled:
            busy = device_busy_ms(prof)
            out["busy"] = busy / (window * 1e3)
            print(f"{label} (profiled run): card busy {busy} ms of "
                  f"{window * 1e3} ms ({out['busy']}) ({card})", flush=True)
            continue
        check_fn(replies)
        rps, batches, mean_rows, p50, p99 = _stats(
            label, batcher, before, replies, lat, wall, card,
            unit="requests")
        stage_ms = {k: v * 1e3 / batcher.batches_run
                    for k, v in batcher.stage_s.items()}
        out.update(replies=replies, rps=rps, batches=batches,
                   mean_rows=mean_rows, p50=p50, p99=p99, stage_ms=stage_ms)
        print(f"{label}: tokens scored/s {rps * TF_SEQ}; batcher host ms per "
              f"batch over all {batcher.batches_run} (warm-up included): "
              + ", ".join(f"{k} {v}" for k, v in stage_ms.items())
              + f" ({card})", flush=True)
    return out


def transformer_serving(dev, card, per_client=PER_CLIENT, cfg=None):
    """Phase 6: the MoE transformer of ``examples/sharded_inference.py`` on
    a one-rank mesh (``build_mesh(1)``), behind fan-in batching.

    Random weights from ``init_params`` with a generator seeded SEED;
    float32 with TF32 off, and bf16 (the same weights cast). (a) a seeded
    int32 [8,128] batch on the card against the same module on the CPU, and
    the forward's host clock, device ms and launches; (b) float32 and (c)
    bf16 fan-in serving of 8 clients x depth 4 x ``per_client`` int32
    [1,128] requests, each reply against the direct run of its own tokens
    (padded with zero rows to the bucket [8,128]) and strictly nearer it
    than any other request's; (d) a token at or above vocab and a negative
    one, each alone in its batch, against the CPU run of the same tokens,
    then an ordinary request.

    Why a reply can be checked row by row: with 2 experts and capacity
    factor 2.0 every expert has T slots (T = the microbatch's tokens), so
    no token is ever dropped, and each row's logits depend on its own
    tokens alone, whatever else shares its batch. (A NaN row from an
    out-of-range token is the exception: the dense dispatch spreads it over
    its microbatch, as in the reference; (d) sends such a request alone.)
    """
    import dataclasses

    import numpy as np
    import torch

    from tpurpc_torch.models.transformer import (Transformer,
                                                 TransformerConfig,
                                                 make_serve_fn)
    from tpurpc_torch.parallel import build_mesh
    from tpurpc_torch.rpc.channel import Channel
    from tpurpc_torch.rpc.server import Server
    from tpurpc_torch.torchshim.service import (FanInBatcher, TensorClient,
                                                add_tensor_method)
    from tpurpc_torch.utils import config

    config.set_config(None)
    cfg = TransformerConfig()
    cpu = torch.device("cpu")
    mesh = build_mesh(1, device=dev)
    model32 = Transformer(cfg, mesh,
                          generator=torch.Generator().manual_seed(SEED))
    ref32 = Transformer(cfg, build_mesh(1, device=cpu),
                        generator=torch.Generator().manual_seed(SEED))
    model16 = Transformer(dataclasses.replace(cfg, dtype=torch.bfloat16),
                          mesh)
    model16.load_state_dict(model32.state_dict())
    n_params = sum(p.numel() for p in model32.parameters())
    if cfg == TransformerConfig():
        check(n_params == TF_PARAMS, f"transformer: {n_params} parameters, "
              f"want {TF_PARAMS}")
    print(f"transformer: {cfg}, {n_params} parameters, mesh {mesh.sizes} on "
          f"{mesh.device}, platform {config.get_config().platform.value}",
          flush=True)
    serve32, serve16 = make_serve_fn(model32), make_serve_fn(model16)
    on_cpu = make_serve_fn(ref32)

    def fwd32(x):
        return serve32({"tokens": x})["logits"]

    def fwd16(x):
        return serve16({"tokens": x})["logits"]

    def fwd_cpu(x):
        return on_cpu({"tokens": x})["logits"]

    # (a) the direct run, card against CPU, and its cost
    rng = np.random.default_rng(SEED + 6)
    batch = torch.from_numpy(rng.integers(
        0, cfg.vocab, (MAX_BATCH, TF_SEQ)).astype(np.int32))
    a_card, a_cpu = fwd32(batch.to(dev)).cpu(), fwd_cpu(batch)
    check(a_card.shape == (MAX_BATCH, TF_SEQ, cfg.vocab)
          and a_card.dtype == torch.float32, f"transformer (a): logits "
          f"{tuple(a_card.shape)} {a_card.dtype}")
    check(bool(torch.isfinite(a_card).all()), "transformer (a): non-finite")
    scale = max(1.0, a_cpu.abs().max().item())
    err = (a_card - a_cpu).abs().max().item() / scale
    check(err <= TF_TOL, f"transformer (a): card vs CPU max |diff| {err} of "
          f"max(1, scale), tolerance {TF_TOL}")
    print(f"transformer (a): int32 [{MAX_BATCH},{TF_SEQ}] on the card vs the "
          f"CPU: max |diff| / max(1, max |logit|) {err} (scale {scale})",
          flush=True)
    x = batch.to(dev)
    for name, fwd in (("float32", fwd32), ("bf16", fwd16)):
        ms = host_ms(lambda: fwd(x), reps=10, dev=dev)
        dev_part = "device time and launches not measured"
        if dev.type == "cuda":
            launches, device_ms, top = _profiled_forward(lambda: fwd(x))
            dev_part = (f"device {device_ms} ms, {launches} launches; "
                        "costliest: " + "; ".join(
                            f"{t} ms x{c} {k}" for t, c, k in top))
        print(f"transformer (a) {name} forward at [{MAX_BATCH},{TF_SEQ}]: "
              f"host clock {ms} ms, {dev_part} ({card})", flush=True)
    _forward_parts(dev, card, cfg, mesh, model32)

    rows = [rng.integers(0, cfg.vocab, (1, TF_SEQ)).astype(np.int32)
            for _ in range(CLIENTS * per_client)]

    # (b) float32 fan-in; (c) bf16, the same weights cast
    def check32(replies):
        worst, apart, _ = _check_replies(
            "transformer (b) float32", replies, rows, fwd32, dev, TF_TOL,
            None, floor=1.0)
        print(f"transformer (b) float32: replies vs direct runs max |diff| / "
              f"max(1, scale) {worst}, nearest other request's run {apart} x "
              f"it", flush=True)

    def check16(replies):
        worst, apart, _ = _check_replies(
            "transformer (c) bf16", replies, rows, fwd16, dev, TF_BF16_TOL,
            None, floor=1.0)
        print(f"transformer (c) bf16: replies vs bf16 direct runs max |diff| "
              f"/ max(1, scale) {worst} (bit-equal: {worst == 0.0}), nearest "
              f"other request's run {apart} x it", flush=True)

    b = _tf_serve("transformer (b) float32", serve32, dev, rows, per_client,
                  card, check32)
    c = _tf_serve("transformer (c) bf16", serve16, dev, rows, per_client,
                  card, check16)
    gap = max((r32["logits"] - r16["logits"]).abs().max().item()
              for r32, r16 in zip(b["replies"], c["replies"]))
    print(f"transformer: bf16 vs float32 replies, same weights: max |diff| "
          f"{gap}", flush=True)

    # (d) out-of-range tokens, each alone in its batch, then an ordinary one
    reqs = []
    for tok in TF_OOR:
        r = rows[0].copy()
        r[0, TF_OOR_POS] = tok
        reqs.append(r)
    reqs.append(rows[1])
    batcher = FanInBatcher(serve32, max_batch=MAX_BATCH, max_delay_s=0.005,
                           fixed_bucket=True, device=dev)
    srv = Server(max_workers=WORKERS)
    add_tensor_method(srv, "Generate", batcher)
    srv.start()
    port = srv.add_insecure_port("127.0.0.1:0")
    try:
        with Channel(f"127.0.0.1:{port}") as ch:
            cli = TensorClient(ch)
            replies = [cli.call("Generate", {"tokens": torch.from_numpy(r)},
                                timeout=300)["logits"] for r in reqs]
    finally:
        srv.stop()
        batcher.close()
    check(batcher.batches_run == len(reqs), f"transformer (d): "
          f"{batcher.batches_run} batches for {len(reqs)} lone requests")
    readings = []
    for r, got in zip(reqs, replies):
        want = _direct(fwd_cpu, r, cpu)
        nan = torch.isnan(want)
        check(got.shape == want.shape and torch.equal(torch.isnan(got), nan),
              f"transformer (d) token {r[0, TF_OOR_POS]}: NaN positions "
              f"differ from the CPU run's ({int(torch.isnan(got).sum())} vs "
              f"{int(nan.sum())})")
        fin = ~nan
        err = 0.0
        if fin.any():
            err = ((got[fin] - want[fin]).abs().max().item()
                   / max(1.0, want[fin].abs().max().item()))
        check(err <= TF_TOL, f"transformer (d) token {r[0, TF_OOR_POS]}: "
              f"{err} of max(1, scale) from the CPU run")
        readings.append((int(r[0, TF_OOR_POS]), int(nan.sum()), err))
    check(readings[0][1] == replies[0].numel(),
          f"transformer (d): token {TF_OOR[0]} did not give a NaN reply")
    check(readings[1][1] == 0 and readings[2][1] == 0,
          "transformer (d): a wrapped or ordinary token gave NaN")
    print("transformer (d): " + "; ".join(
        f"token {t} at {TF_OOR_POS}: {n} NaN logits, finite ones {e} of "
        f"max(1, scale) from the CPU run" for t, n, e in readings[:2])
        + f"; the following ordinary request {readings[2][2]} from it",
        flush=True)
    again = (fwd32(batch.to(dev)).cpu() - a_cpu).abs().max().item() / scale
    check(again <= TF_TOL, f"transformer (d): (a)'s batch, run again on the "
          f"card, is {again} of max(1, scale) from the CPU run")
    return {"b": b, "c": c, "d": readings}


def _train_run(model, tokens, targets, parts=None):
    """TRAIN_STEPS steps of ``build_train_step`` on ``model``: each step's
    loss and host ms (synchronized). With ``parts`` (a dict), each step runs
    as the step's parts instead (zero_grad, forward and loss, backward,
    optimizer), each in its own profiler window on a card, and ``parts``
    gets per part its host ms, device ms and launches a step."""
    import torch

    from tpurpc_torch.models import transformer as tfm

    dev, cfg = model.mesh.device, model.cfg
    train_step, make_optimizer = tfm.build_train_step(cfg, model.mesh,
                                                      lr=TRAIN_LR)
    loss_fn = tfm.build_loss_fn(cfg, model.mesh)
    opt = make_optimizer(model)
    losses, ms = [], []

    def timed(name, fn):
        prof = None
        if dev.type == "cuda":
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        host = (time.perf_counter() - t0) * 1e3
        if prof is not None:
            prof.__exit__(None, None, None)
            events = device_events(prof)
            dev_ms, n = device_busy_ms(prof), sum(e.count for e in events)
        else:
            dev_ms = n = "not measured"
        parts.setdefault(name, []).append((host, dev_ms, n))
        return out

    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        if parts is None:
            loss = train_step(model, opt, tokens, targets)
        else:
            opt.zero_grad()
            loss = timed("forward", lambda: loss_fn(model, tokens, targets))
            timed("backward", lambda: tfm.backward(model, loss))
            timed("optimizer", opt.step)
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss.detach()))
    return losses, ms


def _train_check(label, losses, model, want_losses, want_params):
    """Print ``losses`` and ``model``'s parameters against the CPU run's,
    then fail on any reading past its limit."""
    diffs = [abs(a - b) / abs(b) for a, b in zip(losses, want_losses)]
    params = {}
    for name, p in model.named_parameters():
        d = (p.detach().cpu() - want_params[name]).abs()
        params[name] = (d.max().item(), d.median().item())
    print(f"training {label}: losses {losses}; relative diff from the CPU "
          f"run per step {diffs}; parameters after {TRAIN_STEPS} steps, "
          f"|diff| max / median: " + "; ".join(
              f"{k} {m} / {med}" for k, (m, med) in params.items()),
          flush=True)
    check(max(diffs[:TRAIN_EXACT_STEPS]) <= TRAIN_EXACT_TOL,
          f"training {label}: the first {TRAIN_EXACT_STEPS} steps' losses are "
          f"{diffs[:TRAIN_EXACT_STEPS]} from the CPU run's, relative; "
          f"tolerance {TRAIN_EXACT_TOL}")
    check(max(diffs) <= TRAIN_LOSS_TOL, f"training {label}: a step's loss "
          f"is {max(diffs)} from the CPU run's, relative; tolerance "
          f"{TRAIN_LOSS_TOL}")
    for name, (most, median) in params.items():
        check(most <= 2 * TRAIN_LR * TRAIN_STEPS and median <= TRAIN_MEDIAN,
              f"training {label}: parameter {name} after {TRAIN_STEPS} "
              f"steps differs from the CPU run's: largest |diff| {most}, "
              f"median {median}")
    check(losses[-1] < TRAIN_FALL * losses[0], f"training {label}: loss "
          f"{losses[0]} -> {losses[-1]}, not below {TRAIN_FALL}x")


def transformer_training(dev, card) -> None:
    """Phase 7: train ``TransformerConfig()`` on the one-rank mesh on the
    card, against the same steps on the CPU from the same weights."""
    import numpy as np
    import torch

    from tpurpc_torch.models.transformer import Transformer, TransformerConfig
    from tpurpc_torch.parallel import build_mesh

    cfg = TransformerConfig()
    cpu = torch.device("cpu")

    def model_on(d):
        return Transformer(cfg, build_mesh(1, device=d),
                           generator=torch.Generator().manual_seed(SEED))

    tokens = np.random.default_rng(SEED).integers(
        0, cfg.vocab, (MAX_BATCH, TF_SEQ)).astype(np.int32)
    tokens = torch.from_numpy(tokens)
    targets = torch.roll(tokens, -1, dims=1)
    ref = model_on(cpu)
    n_params = sum(p.numel() for p in ref.parameters())
    check(n_params == TF_PARAMS, f"training: {n_params} parameters, want "
          f"{TF_PARAMS}")
    t0 = time.perf_counter()
    want, _ = _train_run(ref, tokens, targets)
    cpu_s = time.perf_counter() - t0
    want_params = {k: v.detach() for k, v in ref.named_parameters()}
    print(f"training: {cfg}, {n_params} parameters, [{MAX_BATCH},{TF_SEQ}] "
          f"tokens, next-token targets, lr {TRAIN_LR}; CPU run: losses "
          f"{want} ({cpu_s} s)", flush=True)

    tok, tgt = tokens.to(dev), targets.to(dev)
    model = model_on(dev)
    losses, ms = _train_run(model, tok, tgt)
    _train_check(f"(a) on {dev}", losses, model, want, want_params)
    print(f"training (a): host ms per step (synchronized) {ms} ({card})",
          flush=True)

    parts = {}
    model = model_on(dev)
    losses, _ = _train_run(model, tok, tgt, parts=parts)
    _train_check("(b), by parts under the profiler", losses, model, want,
                 want_params)
    for name, rows in parts.items():
        print(f"training (b) {name}, per step: host ms (profiled) "
              f"{[r[0] for r in rows]}; device ms {[r[1] for r in rows]}; "
              f"launches {[r[2] for r in rows]} ({card})", flush=True)


def _gen_prompts(rng, n: int, lo: int = GEN_PROMPT[0],
                 hi: int = GEN_PROMPT[1]) -> list:
    return [[int(t) for t in rng.integers(0, 251, int(rng.integers(lo,
                                                                   hi + 1)))]
            for _ in range(n)]


def _check_stream(label, pairs, prompt, n):
    from tpurpc_torch.torchshim.generate import reference_decode

    check([i for i, _ in pairs] == list(range(n)),
          f"{label}: indices {[i for i, _ in pairs][:8]}... not 0..{n - 1}")
    check([t for _, t in pairs] == reference_decode(prompt, n),
          f"{label}: tokens of prompt {prompt[:6]}... differ from "
          "reference_decode")


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(len(xs) * q))]


def _profiled_step(label, model, dev, card, paged: bool) -> None:
    """One warm decode step of the batch under ``torch.profiler``: host ms
    (synchronized), device ms and launches."""
    import numpy as np
    import torch

    from tpurpc_torch.serving.kv import HostKv

    prompts = _gen_prompts(np.random.default_rng(SEED + 8), MAX_BATCH)
    if paged:
        kvs = [HostKv() for _ in prompts]
        toks = model.prefill_paged(prompts, kvs)

        def step():
            return model.step_paged(kvs, toks)
    else:
        states, toks = model.prefill(prompts)

        def step():
            return model.step(states, toks)
    ms = host_ms(step, reps=20, dev=dev)
    dev_part = "device ms and launches not measured"
    if dev.type == "cuda":
        launches, device_ms, top = _profiled_forward(step)
        dev_part = (f"device {device_ms} ms in {launches} launches "
                    f"(costliest: {top})")
    print(f"generation: one {label} step of {MAX_BATCH} rows: host clock "
          f"{ms} ms, {dev_part} ({card})", flush=True)


def _warm(model) -> None:
    """One prefill and step of each contract, before any timed window: the
    first calls on a card pay for lazy CUDA set-up and the power tables."""
    from tpurpc_torch.serving.kv import HostKv

    states, toks = model.prefill([[1, 2]])
    model.step(states, toks)
    kv = HostKv()
    model.step_paged([kv], model.prefill_paged([[1, 2]], [kv]))


def _colocated(dev, card, accounts=None, inspect=None,
               profile=True) -> dict:
    """Phase 8 (a): bench.py's _gen_bench posture with the step model on
    the card: GEN_CLIENTS closed-loop streaming clients, alternating
    interactive and batch, GEN_STREAMS streams each of GEN_TOKENS tokens
    from seeded prompts; a shed client honors its pushback and retries.

    Phase 21 (a) reuses it: client ``i`` sends ``accounts[i % n]`` as
    ``tpurpc-account``, the returned ``by_account`` counts what each
    account's streams received (its warm-up stream included), and
    ``inspect(port, sched)`` runs after the traffic, before the server
    stops."""
    import threading

    import numpy as np

    from tpurpc_torch.rpc.channel import Channel
    from tpurpc_torch.rpc.status import RpcError, StatusCode
    from tpurpc_torch.serving import GenerationClient, serve_generation
    from tpurpc_torch.torchshim.generate import ToyDecodeModel

    model = ToyDecodeModel(device=dev, step_delay_s=GEN_STEP_S)
    check(model.device == dev, f"step model on {model.device}, not {dev}")
    _warm(model)
    srv, port, sched = serve_generation(model, max_batch=MAX_BATCH,
                                        max_waiting=8, batch_shed_depth=4)
    rng = np.random.default_rng(SEED + 80)
    work = [_gen_prompts(rng, GEN_STREAMS) for _ in range(GEN_CLIENTS)]
    lock = threading.Lock()
    stats = {"tokens": 0, "sheds": {"interactive": 0, "batch": 0},
             "ttft_ms": {"interactive": [], "batch": []}, "errors": []}
    by_account = {a: {"tokens": 0, "streams": 0, "sheds": 0}
                  for a in accounts or ()}
    start = threading.Barrier(GEN_CLIENTS + 1)

    def client(i, slo):
        acct = accounts[i % len(accounts)] if accounts else None
        mine = by_account.get(acct, {"tokens": 0, "streams": 0, "sheds": 0})
        try:
            with Channel(f"127.0.0.1:{port}") as ch:
                gen = GenerationClient(ch, account=acct)
                # dial outside the timed window, as bench.py's clients do
                warm = list(gen.generate([1], max_tokens=1, timeout=60))
                with lock:
                    mine["tokens"] += len(warm)
                    mine["streams"] += 1
                start.wait(60)
                for prompt in work[i]:
                    while True:
                        t0 = time.perf_counter()
                        try:
                            it = gen.generate_with_meta(
                                prompt, max_tokens=GEN_TOKENS, slo=slo,
                                timeout=60)
                            pairs = [next(it)]
                            ttft = (time.perf_counter() - t0) * 1e3
                            pairs += list(it)
                        except RpcError as exc:
                            if exc.code() is not StatusCode.UNAVAILABLE:
                                raise
                            with lock:
                                stats["sheds"][slo] += 1
                                mine["sheds"] += 1
                            md = dict(exc.trailing_metadata() or ())
                            pb = int(md.get("tpurpc-pushback-ms", 25))
                            time.sleep(min(pb, 200) / 1e3)
                            continue
                        _check_stream(f"generation (a) client {i}", pairs,
                                      prompt, GEN_TOKENS)
                        with lock:
                            stats["tokens"] += len(pairs)
                            stats["ttft_ms"][slo].append(ttft)
                            mine["tokens"] += len(pairs)
                            mine["streams"] += 1
                        break
        except BaseException as exc:  # noqa: BLE001 - reported below
            with lock:
                stats["errors"].append(f"client {i}: {exc!r}")

    threads = [threading.Thread(target=client, args=(
        i, "interactive" if i % 2 == 0 else "batch"), daemon=True)
        for i in range(GEN_CLIENTS)]
    try:
        for t in threads:
            t.start()
        start.wait(60)
        steps0, rows0, prefills0 = sched.steps, sched.rows_stepped, \
            model.prefills
        t0 = time.perf_counter()
        for t in threads:
            t.join(300)
        wall = time.perf_counter() - t0
        steps = sched.steps - steps0
        rows = sched.rows_stepped - rows0
        if inspect is not None and not any(t.is_alive() for t in threads):
            inspect(port, sched)
    finally:
        srv.stop(grace=0)
        sched.close()
    check(not any(t.is_alive() for t in threads), "generation (a): a client "
          "did not finish")
    check(not stats["errors"], "; ".join(stats["errors"]))
    want = GEN_CLIENTS * GEN_STREAMS * GEN_TOKENS
    check(stats["tokens"] == want,
          f"generation (a): {stats['tokens']} tokens, want {want}")
    check(model.device.type == dev.type and steps > 0,
          "generation (a): no decode step ran on the device")
    ttft = stats["ttft_ms"]["interactive"] + stats["ttft_ms"]["batch"]
    out = {"tokens_per_s": stats["tokens"] / wall,
           "ttft_p50": _pct(ttft, 0.5), "ttft_p99": _pct(ttft, 0.99),
           "sheds": dict(stats["sheds"]), "steps": steps,
           "rows_per_step": rows / max(1, steps), "by_account": by_account}
    print(f"generation (a) colocated: {GEN_CLIENTS} clients x "
          f"{GEN_STREAMS} streams x {GEN_TOKENS} tokens, every stream "
          f"exact: {out['tokens_per_s']} tokens/s, TTFT p50 "
          f"{out['ttft_p50']} ms p99 {out['ttft_p99']} ms (interactive p99 "
          f"{_pct(stats['ttft_ms']['interactive'], 0.99)}, batch p99 "
          f"{_pct(stats['ttft_ms']['batch'], 0.99)}), sheds {out['sheds']}, "
          f"{steps} decode steps, {out['rows_per_step']} rows a step, "
          f"{model.prefills - prefills0} prefills, wall {wall} s ({card})",
          flush=True)
    if profile:
        _profiled_step("opaque", ToyDecodeModel(device=dev), dev, card,
                       False)
        _profiled_step("paged", ToyDecodeModel(device=dev), dev, card, True)
    return out


def _disaggregated(dev, card) -> dict:
    """Phase 8 (b): bench.py's _disagg_bench posture with the step models
    on the card: a prefill tier ships KV over block grants into a decode
    tier; GEN_DIS_CLIENTS clients x 3 streams of GEN_DIS_TOKENS tokens,
    then a repeated prompt (a prefix hit ships one entry), then one live
    stream migrated between two decode servers."""
    import threading

    import numpy as np

    from tpurpc_torch.rpc.channel import Channel
    from tpurpc_torch.serving import (DisaggClient, migrate, serve_decode,
                                      serve_prefill)
    from tpurpc_torch.torchshim.generate import ToyDecodeModel
    from tpurpc_torch.tpu import ledger

    decode_model = ToyDecodeModel(device=dev, step_delay_s=GEN_STEP_S)
    d_srv, d_port, d_sched, d_state = serve_decode(
        decode_model, max_batch=MAX_BATCH, kv_blocks=512, block_bytes=1024)
    b_srv, b_port, b_sched, b_state = serve_decode(
        ToyDecodeModel(device=dev, step_delay_s=GEN_STEP_S), name="migB",
        kv_blocks=256, block_bytes=1024)
    d_addr, b_addr = f"127.0.0.1:{d_port}", f"127.0.0.1:{b_port}"
    d_ch, b_ch = Channel(d_addr), Channel(b_addr)
    prefill_model = ToyDecodeModel(device=dev)
    for m in (decode_model, prefill_model):
        _warm(m)
    p_srv, p_port, p_state = serve_prefill(prefill_model, d_ch, d_addr)
    chans, clis = [], []

    def client_of():
        ch = Channel(f"127.0.0.1:{p_port}")
        chans.append(ch)
        cli = DisaggClient(ch, d_addr)
        clis.append(cli)
        return cli

    out = {}
    try:
        rng = np.random.default_rng(SEED + 81)
        work = [_gen_prompts(rng, 3, GEN_DIS_PROMPT, GEN_DIS_PROMPT)
                for _ in range(GEN_DIS_CLIENTS)]
        errors, ttfts, lock = [], [], threading.Lock()
        dialed = threading.Barrier(GEN_DIS_CLIENTS + 1)
        start = threading.Barrier(GEN_DIS_CLIENTS + 1)

        def client(i, cli):
            try:
                # dial both tiers outside the timed window
                list(cli.generate([1], max_tokens=2, timeout=60))
                dialed.wait(60)
                start.wait(60)
                for prompt in work[i]:
                    t0 = time.perf_counter()
                    it = cli.generate_with_meta(prompt,
                                                max_tokens=GEN_DIS_TOKENS,
                                                timeout=60)
                    pairs = [next(it)]
                    ttft = (time.perf_counter() - t0) * 1e3
                    pairs += list(it)
                    _check_stream(f"generation (b) client {i}", pairs,
                                  prompt, GEN_DIS_TOKENS)
                    with lock:
                        ttfts.append(ttft)
            except BaseException as exc:  # noqa: BLE001 - reported below
                with lock:
                    errors.append(f"client {i}: {exc!r}")

        threads = [threading.Thread(target=client, args=(i, client_of()),
                                    daemon=True)
                   for i in range(GEN_DIS_CLIENTS)]
        for t in threads:
            t.start()
        dialed.wait(60)
        shipped0 = p_state.shipped_bytes
        with ledger.track() as w:
            start.wait(60)
            t0 = time.perf_counter()
            for t in threads:
                t.join(300)
            wall = time.perf_counter() - t0
        check(not any(t.is_alive() for t in threads),
              "generation (b): a client did not finish")
        check(not errors, "; ".join(errors))
        entries = sum(len(p) + 1 for ps in work for p in ps)
        shipped = p_state.shipped_bytes - shipped0
        check(w["rdma_write"] == shipped == 16 * entries,
              f"generation (b): shipped {w['rdma_write']} bytes (prefill "
              f"counted {shipped}), want 16 x {entries}")
        n_tok = GEN_DIS_CLIENTS * 3 * GEN_DIS_TOKENS
        out.update(tokens_per_s=n_tok / wall, ttft_p50=_pct(ttfts, 0.5),
                   shipped=w["rdma_write"], entries=entries)
        print(f"generation (b) disaggregated: {GEN_DIS_CLIENTS} clients x 3 "
              f"streams x {GEN_DIS_TOKENS} tokens, every stream exact: "
              f"{out['tokens_per_s']} tokens/s, TTFT p50 {out['ttft_p50']} "
              f"ms, KV shipped {w['rdma_write']} bytes = 16 x {entries} "
              f"entries over block grants (rdma_write ops "
              f"{w['rdma_write_ops']}, host_copy {w['host_copy']} bytes), "
              f"wall {wall} s ({card})", flush=True)

        # a repeated prompt: the second time only the first sample ships
        cli = clis[0]
        hot = [int(t) for t in rng.integers(0, 251, 64)]
        hits0 = d_state.mgr.prefix_hits
        for k in range(2):
            shipped0 = p_state.shipped_bytes
            pairs = list(cli.generate_with_meta(hot, max_tokens=4,
                                                timeout=60))
            _check_stream("generation (b) repeated prompt", pairs, hot, 4)
        check(d_state.mgr.prefix_hits - hits0 == 1,
              "generation (b): the repeated prompt scored no prefix hit")
        check(p_state.shipped_bytes - shipped0 == 16,
              f"generation (b): the prefix hit shipped "
              f"{p_state.shipped_bytes - shipped0} bytes, want 16")
        print("generation (b): repeated 64-token prompt: 1 prefix hit, "
              "16 bytes shipped (one entry)", flush=True)

        # live migration between two decode servers
        stamps, pairs, mig_err = [], [], []
        prompt = [5] * 8

        def stream():
            try:
                for pair in cli.generate_with_meta(
                        prompt, max_tokens=GEN_MIG_TOKENS, timeout=60):
                    pairs.append(pair)
                    stamps.append(time.perf_counter())
            except BaseException as exc:  # noqa: BLE001 - reported below
                mig_err.append(repr(exc))

        t = threading.Thread(target=stream, daemon=True)
        t.start()
        deadline = time.monotonic() + 60
        while len(stamps) < GEN_MIG_AT and time.monotonic() < deadline \
                and t.is_alive():
            time.sleep(0.001)
        moved = migrate(d_state, b_ch, b_addr)
        t.join(120)
        check(not mig_err and not t.is_alive(),
              f"generation (b): the migrated stream failed: {mig_err}")
        check(moved == (1, 0), f"generation (b): migrate gave {moved}")
        check(b_sched.tokens_out > 0, "generation (b): the peer never "
              "stepped the migrated sequence")
        _check_stream("generation (b) migrated stream", pairs, prompt,
                      GEN_MIG_TOKENS)
        gaps = sorted((b - a) * 1e3 for a, b in zip(stamps, stamps[1:]))
        out.update(blackout=gaps[-1], median_gap=_pct(gaps, 0.5))
        print(f"generation (b): one live stream of {GEN_MIG_TOKENS} tokens "
              f"migrated after {GEN_MIG_AT}, exact: worst inter-token gap "
              f"{gaps[-1]} ms against a median {out['median_gap']} ms; the "
              f"peer emitted {b_sched.tokens_out} tokens ({card})",
              flush=True)
    finally:
        for c in clis:
            c.close()
        for ch in chans:
            ch.close()
        p_srv.stop(grace=0)
        p_state.close()
        for srv, sched, state in ((d_srv, d_sched, d_state),
                                  (b_srv, b_sched, b_state)):
            srv.stop(grace=0)
            sched.close()
            state.close()
            state.mgr.close()
        d_ch.close()
        b_ch.close()
    return out


def generation_serving(dev, card) -> dict:
    """Phase 8: generation serving with the step model's state on the
    card, (a) colocated and (b) disaggregated (docstring of this file)."""
    return {"colocated": _colocated(dev, card),
            "disaggregated": _disaggregated(dev, card)}


# -- phase 9 -----------------------------------------------------------------
#
# The worker builds below run in spawned shard workers, which import this
# file as ``__mp_main__`` and find them by name: they are module-level, and
# the file's top level does no work. Each runs on the config's device
# (``TPURPC_TORCH_DEVICE``, set by phase 3 to the card), with TF32 off.

def _worker_device():
    import torch

    from tpurpc_torch.utils.config import resolve_device

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return resolve_device()


def _fleet_transformer(dev):
    """Phase 6's float32 model: ``TransformerConfig()``, seed SEED, on a
    one-rank mesh on ``dev``; its serve fn padded with zero rows to the
    bucket [MAX_BATCH,128] (serve_torch_sharded's batcher pads to powers of
    two, the microbatches need an even count, and phase 6's direct run pads
    to MAX_BATCH), each reply row beside the serving process's pid."""
    import torch

    from tpurpc_torch.models.transformer import (Transformer,
                                                 TransformerConfig,
                                                 make_serve_fn)
    from tpurpc_torch.parallel import build_mesh

    model = Transformer(TransformerConfig(), build_mesh(1, device=dev),
                        generator=torch.Generator().manual_seed(SEED))
    serve = make_serve_fn(model)
    pid = os.getpid()

    def fn(tree):
        tokens = torch.as_tensor(tree["tokens"])
        b = tokens.shape[0]
        padded = tokens.new_zeros((max(b, MAX_BATCH), *tokens.shape[1:]))
        padded[:b] = tokens
        logits = serve({"tokens": padded})["logits"][:b]
        return {"logits": logits,
                "pid": torch.full((b,), pid, dtype=torch.int64,
                                  device=logits.device)}

    return fn


def fleet_transformer_fn():
    """Phase 9 (a)'s ``build_fn``: the transformer on this worker's card."""
    return _fleet_transformer(_worker_device())


def _kernel_check(dev) -> None:
    """Both kernels once, across a wrap, against their plain versions;
    raises on a difference. Its launches do not count: the counters are
    zeroed after it."""
    import torch

    from tpurpc_torch.ops import ring_scatter as rs_mod
    from tpurpc_torch.ops import ring_window as rw_mod

    g = torch.Generator().manual_seed(SEED)
    ring = torch.randint(0, 256, (4096,), dtype=torch.uint8, generator=g)
    payload = torch.randint(0, 256, (1001,), dtype=torch.uint8, generator=g)
    want = rs_mod.ring_scatter_plain(ring.clone(), payload, 3500)
    got = rs_mod.ring_scatter(ring.to(dev), payload.to(dev), 3500).cpu()
    if not torch.equal(got, want):
        raise RuntimeError("ring_scatter differs from its plain version")
    if not torch.equal(rw_mod.ring_window(got.to(dev), 3500, 1001).cpu(),
                       rw_mod.ring_window_plain(want, 3500, 1001)):
        raise RuntimeError("ring_window differs from its plain version")
    rs_mod.launches = rw_mod.launches = 0


def fleet_ring_build(shard_id: int):
    """Phase 9 (b)'s worker: phase 3's ResNet-50 (float32, seed SEED) on
    this worker's card behind ``add_tensor_method("Call", device=True)``,
    and "Stats" (JSON: pid, shard, launches, the card's name). A worker
    whose card or kernels fail raises here, which its supervisor reports
    as ``fatal``."""
    import torch

    from tpurpc_torch.models.resnet import make_infer_fn, resnet50
    from tpurpc_torch.ops import ring_scatter as rs_mod
    from tpurpc_torch.ops import ring_window as rw_mod
    from tpurpc_torch.rpc.server import (Server,
                                         unary_unary_rpc_method_handler)
    from tpurpc_torch.rpc.shard import shard_identity
    from tpurpc_torch.torchshim.service import add_tensor_method

    dev = _worker_device()
    if dev.type == "cuda":
        _kernel_check(dev)
    torch.manual_seed(SEED)
    infer = make_infer_fn(resnet50().to(dev))
    infer(torch.zeros(BATCH, SIZE, SIZE, 3, device=dev))  # warm cuDNN

    def classify(tree):
        logits = infer(tree["images"])
        return {"logits": logits, "top1": logits.argmax(dim=1)}

    def stats(req, ctx):
        return json.dumps({
            "pid": os.getpid(), "shard": shard_identity()[0],
            "launches": {"ring_scatter": rs_mod.launches,
                         "ring_window": rw_mod.launches},
            "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu")}).encode()

    srv = Server(max_workers=4)
    add_tensor_method(srv, "Call", classify, device=True)
    srv.add_method("/tpurpc.Tensor/Stats",
                   unary_unary_rpc_method_handler(stats))
    return srv


def _set_env(env: dict) -> None:
    from tpurpc_torch.utils import config

    for key, val in env.items():
        if val is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = val
    config.set_config(None)


def _pinned_channels(port, n, pid_of):
    """Dial channels to a reuseport fleet until ``n`` distinct workers
    hold one each (the kernel picks the worker per connection); returns
    {pid: channel}."""
    from tpurpc_torch.rpc.channel import Channel

    pinned = {}
    for _ in range(64):
        ch = Channel(f"127.0.0.1:{port}")
        pid = pid_of(ch)
        if pid in pinned:
            ch.close()
        else:
            pinned[pid] = ch
        if len(pinned) == n:
            return pinned
    for ch in pinned.values():
        ch.close()
    fail(f"fleet: 64 connections reached {len(pinned)} of {n} workers")


def _fleet_fanin(dev, card, per_client, fwd32) -> dict:
    """(a): serve_torch_sharded of 2 transformer workers behind reuseport,
    phase 6's traffic, then a drain seen by a Watch on each worker."""
    import threading
    from collections import Counter

    import numpy as np
    import torch

    from tpurpc_torch.rpc import health
    from tpurpc_torch.torchshim.service import (TensorClient,
                                                serve_torch_sharded)

    rng = np.random.default_rng(SEED + 9)
    rows = [rng.integers(0, 256, (1, TF_SEQ)).astype(np.int32)
            for _ in range(CLIENTS * per_client)]
    t0 = time.perf_counter()
    sup = serve_torch_sharded(fleet_transformer_fn, workers=FLEET_WORKERS,
                              name="Generate", batching=True,
                              max_batch=MAX_BATCH, max_delay_s=0.005,
                              listener="reuseport")
    pinned = {}
    try:
        up = time.perf_counter() - t0
        pids = [sup.worker_pid(i) for i in range(FLEET_WORKERS)]
        print(f"fleet (a): {FLEET_WORKERS} transformer workers up in {up} s "
              f"(spawn, import, model), pids {pids}", flush=True)
        replies, lat, wall, _ = drive_clients(
            sup.port, rows, per_client, None, method="Generate",
            key="tokens")
        worst, apart, _ = _check_replies(
            "fleet (a)", replies, rows, fwd32, dev, TF_TOL, None, floor=1.0)
        served = Counter(int(r["pid"][0]) for r in replies)
        check(set(served) <= set(pids), f"fleet (a): replies from pids "
              f"{sorted(served)}, workers {pids}")
        p50, p99 = np.percentile(lat, [50, 99])
        n = len(replies)
        print(f"fleet (a): {n} requests from {CLIENTS} clients at depth "
              f"{DEPTH}: requests/s {n / wall}, latency ms p50 {p50} p99 "
              f"{p99}; replies vs direct runs max |diff| / max(1, scale) "
              f"{worst}, nearest other request's run {apart} x it; served "
              f"per worker {[served.get(p, 0) for p in pids]} ({card})",
              flush=True)

        def pid_of(ch):
            zero = torch.zeros((1, TF_SEQ), dtype=torch.int32)
            out = TensorClient(ch).call("Generate", {"tokens": zero},
                                        timeout=300)
            return int(out["pid"][0])

        pinned = _pinned_channels(sup.port, FLEET_WORKERS, pid_of)
        seen = {pid: [] for pid in pinned}

        def watch(ch, pid):
            try:
                for msg in ch.unary_stream(f"/{health.SERVICE_NAME}/Watch")(
                        health.encode_request(""), timeout=60):
                    seen[pid].append(health.decode_response(msg))
                    if seen[pid][-1] is health.ServingStatus.NOT_SERVING:
                        return
            except Exception as exc:  # surfaced by the check below
                seen[pid].append(repr(exc))

        threads = [threading.Thread(target=watch, args=(ch, pid),
                                    daemon=True)
                   for pid, ch in pinned.items()]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 30
        while not all(seen.values()) and time.monotonic() < deadline:
            time.sleep(0.01)
        check(all(v[:1] == [health.ServingStatus.SERVING]
                  for v in seen.values()), f"fleet (a): watches before the "
              f"drain {seen}")
        sup.drain(linger=5.0)
        for t in threads:
            t.join(60)
        check(not any(t.is_alive() for t in threads),
              "fleet (a): a Watch did not see the drain")
        check(all(v[-1] is health.ServingStatus.NOT_SERVING
                  for v in seen.values()), f"fleet (a): watches {seen}")
        deadline = time.monotonic() + 30
        while len(sup.drained_workers()) < FLEET_WORKERS and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        check(sup.drained_workers() == list(range(FLEET_WORKERS)),
              f"fleet (a): drained {sup.drained_workers()}")
        print("fleet (a): drain: every worker's health Watch went SERVING "
              "-> NOT_SERVING, every worker reported drained", flush=True)
    finally:
        for ch in pinned.values():
            ch.close()
        sup.stop()
    check(sup.alive_workers() == [] and all(
        w.proc.exitcode is not None for w in sup._workers),
        "fleet (a): stop left a worker running")
    return {"rps": n / wall, "p50": p50, "p99": p99,
            "served": [served.get(p, 0) for p in pids]}


def _fleet_ring(dev, card, requests) -> dict:
    """(b): a handoff fleet of 2 device-ring ResNet-50 workers on phase
    3's ring environment; one channel on each (round robin), phase 3's
    requests on each, every reply against the direct run."""
    import threading

    import numpy as np
    import torch

    from tpurpc_torch.models.resnet import make_infer_fn, resnet50
    from tpurpc_torch.rpc.channel import Channel
    from tpurpc_torch.rpc.shard import ShardedServer
    from tpurpc_torch.torchshim.service import TensorClient

    torch.manual_seed(SEED)
    infer = make_infer_fn(resnet50().to(dev))
    rng = np.random.default_rng(SEED)
    images = [rng.standard_normal((BATCH, SIZE, SIZE, 3)).astype(np.float32)
              for _ in range(requests)]
    t0 = time.perf_counter()
    sup = ShardedServer(fleet_ring_build, workers=FLEET_WORKERS,
                        listener="handoff", handoff_policy="round_robin")
    sup.start(ready_timeout=600)
    chans = []
    try:
        print(f"fleet (b): {FLEET_WORKERS} ResNet-50 device-ring workers up "
              f"in {time.perf_counter() - t0} s", flush=True)
        stats, replies, lat = [], {}, {}
        for _ in range(FLEET_WORKERS):   # dialed in turn: round robin
            ch = Channel(f"127.0.0.1:{sup.port}")
            chans.append(ch)
            stats.append(json.loads(bytes(ch.unary_unary(
                "/tpurpc.Tensor/Stats")(b"", timeout=300))))
        errors = []

        def client(k, ch):
            cli = TensorClient(ch)
            replies[k], lat[k] = [], []
            try:
                for x in images:
                    t = time.perf_counter()
                    replies[k].append(cli.call(
                        "Call", {"images": torch.from_numpy(x)}, timeout=300))
                    lat[k].append((time.perf_counter() - t) * 1e3)
            except Exception as exc:
                errors.append(f"client {k}: {exc!r}")

        ts = [threading.Thread(target=client, args=(k, ch), daemon=True)
              for k, ch in enumerate(chans)]
        t0 = time.perf_counter()
        for t in ts:
            t.start()
        for t in ts:
            t.join(600)
        wall = time.perf_counter() - t0
        check(not errors and not any(t.is_alive() for t in ts),
              f"fleet (b): {errors or 'a client did not finish'}")
        after = [json.loads(bytes(ch.unary_unary("/tpurpc.Tensor/Stats")(
            b"", timeout=300))) for ch in chans]
    finally:
        for ch in chans:
            ch.close()
        sup.stop()
    check(sup.alive_workers() == [], "fleet (b): stop left a worker running")
    for k in replies:
        for i, (x, r) in enumerate(zip(images, replies[k])):
            want = infer(torch.from_numpy(x).to(dev)).cpu()
            got = r["logits"]
            check(got.shape == (BATCH, 1000) and bool(
                torch.isfinite(got).all()), f"fleet (b) {k}/{i}: logits "
                f"{tuple(got.shape)}")
            d = (got - want).abs().max().item()
            check(d <= REPLY_TOL * max(1.0, want.abs().max().item()),
                  f"fleet (b) {k}/{i}: logits differ from the direct run by "
                  f"{d}")
            check(torch.equal(r["top1"], want.argmax(dim=1)),
                  f"fleet (b) {k}/{i}: top1 differs from the direct run")
    pids = [s["pid"] for s in after]
    check([s["shard"] for s in stats] == list(range(FLEET_WORKERS))
          and [s["pid"] for s in stats] == pids
          and len(set(pids)) == FLEET_WORKERS,
          f"fleet (b): round robin put channels on {stats} / {after}")
    launches = {name: [s["launches"][name] for s in after]
                for name in ("ring_scatter", "ring_window")}
    if dev.type == "cuda":
        for name, counts in launches.items():
            check(all(c >= 2 for c in counts), f"fleet (b): {name} launched "
                  f"{counts} times in the workers, want at least 2 each")
    wraps = sum(1 for k in range(requests) if (k * SPAN) % RING + SPAN > RING)
    every = [v for k in sorted(lat) for v in lat[k]]
    p50, p99 = (float(v) for v in np.percentile(every, [50, 99]))
    n = FLEET_WORKERS * requests
    for k in sorted(lat):
        print(f"fleet (b) connection {k} latency ms: "
              + " ".join(f"{v:.2f}" for v in lat[k]), flush=True)
    print(f"fleet (b): {n} ResNet-50 requests of float32 "
          f"[{BATCH},{SIZE},{SIZE},3] over {FLEET_WORKERS} connections, one "
          f"per worker, {wraps} wrapped each; requests/s {n / wall}, p50 "
          f"{p50} ms, p99 {p99} ms; pids {pids}; launches per worker "
          f"{launches}; cards {[s['device'] for s in after]} ({card})",
          flush=True)
    return {"launches": launches, "rps": n / wall, "p50": p50, "p99": p99}


def _fleet_least_loaded(dev, card, per_client, fwd32) -> dict:
    """(c): two serve_torch transformer servers, one least_loaded channel
    over both; CLIENTS threads x ``per_client`` calls on it."""
    import threading

    import numpy as np
    import torch

    from tpurpc_torch.rpc.channel import Channel
    from tpurpc_torch.torchshim import codec
    from tpurpc_torch.torchshim.service import TensorClient, serve_torch

    fns = [_fleet_transformer(dev) for _ in range(2)]
    servers = [serve_torch(fn, name="Generate", batching=True,
                           max_batch=MAX_BATCH, max_delay_s=0.005)
               for fn in fns]
    rng = np.random.default_rng(SEED + 10)
    rows = [rng.integers(0, 256, (1, TF_SEQ)).astype(np.int32)
            for _ in range(CLIENTS * per_client)]
    replies = [None] * len(rows)
    errors = []
    ch = Channel(f"ipv4:127.0.0.1:{servers[0][1]},127.0.0.1:"
                 f"{servers[1][1]}", lb_policy="least_loaded")
    try:
        cli = TensorClient(ch)
        warm = torch.zeros((1, TF_SEQ), dtype=torch.int32)
        for _ in range(4):
            cli.call("Generate", {"tokens": warm}, timeout=300)
        before = [b.rows_run for _s, _p, b in servers]

        def client(c):
            try:
                for i in range(c * per_client, (c + 1) * per_client):
                    replies[i] = cli.call(
                        "Generate", {"tokens": torch.from_numpy(rows[i])},
                        timeout=300)
            except Exception as exc:
                errors.append(f"client {c}: {exc!r}")

        ts = [threading.Thread(target=client, args=(c,), daemon=True)
              for c in range(CLIENTS)]
        t0 = time.perf_counter()
        for t in ts:
            t.start()
        for t in ts:
            t.join(600)
        wall = time.perf_counter() - t0
        check(not errors and not any(t.is_alive() for t in ts),
              f"fleet (c): {errors or 'a client did not finish'}")
        shares = [b.rows_run - r0 for (_s, _p, b), r0 in zip(servers, before)]
        snap = ch._policy.snapshot()
        raw, call = ch.unary_unary("/tpurpc.Tensor/Generate").with_call(
            codec.encode_tree_bytes({"tokens": warm}), timeout=300)
        keys = [k for k, _v in call.trailing_metadata() or ()]
    finally:
        ch.close()
        for srv, _p, batcher in servers:
            srv.stop()
            batcher.close()
    check("tpurpc-load" not in keys, f"fleet (c): the load report reached "
          f"the app's trailing metadata {keys}")
    check(sum(shares) == len(rows), f"fleet (c): {shares} rows for "
          f"{len(rows)} calls")
    check(all(snap["reported"]), f"fleet (c): reports {snap}")
    worst, apart, _ = _check_replies(
        "fleet (c)", replies, rows, fwd32, dev, TF_TOL, None, floor=1.0)
    n = len(rows)
    print(f"fleet (c): {n} calls from {CLIENTS} threads on one least_loaded "
          f"channel over 2 serve_torch servers: share {shares}, requests/s "
          f"{n / wall}; last parsed reports: load EWMA {snap['load']}, p99 "
          f"{snap['p99_ms']}, ejected {snap['ejected']}; replies vs direct "
          f"runs max |diff| / max(1, scale) {worst}; no tpurpc-load key in "
          f"the app's metadata ({card})", flush=True)
    return {"shares": shares, "rps": n / wall, "load": snap["load"]}


def fleet_serving(dev, card, per_client=PER_CLIENT,
                  ring_requests=REQUESTS) -> dict:
    """Phase 9: fleet serving (docstring of this file). Returns each
    leg's readings; ``["b"]["launches"]`` holds each kernel's launches in
    each worker of (b)."""
    fwd32 = _fleet_transformer(dev)
    tcp = {k: None for k in RING_ENV}
    tcp["TPURPC_TORCH_DEVICE"] = str(dev)
    _set_env(tcp)

    def direct(x):
        return fwd32({"tokens": x})["logits"]

    a = _fleet_fanin(dev, card, per_client, direct)
    ring = {"GRPC_PLATFORM_TYPE": "TPU", "TPURPC_HBM_RING_SIZE_KB":
            str(RING >> 10), "TPURPC_TORCH_DEVICE": str(dev)}
    _set_env(ring)
    try:
        b = _fleet_ring(dev, card, ring_requests)
    finally:
        _set_env(tcp)
    c = _fleet_least_loaded(dev, card, per_client, direct)
    return {"a": a, "b": b, "c": c}


# -- phase 10 ----------------------------------------------------------------

def _h2_fanin(port, h2_rows, native_rows):
    """(a)'s traffic on one port: H2_CLIENTS threads, each its own
    H2Channel and ``len(h2_rows) // H2_CLIENTS`` closed-loop calls, and one
    native Channel pipeline of depth DEPTH over ``native_rows``, all from a
    common start after one warm call each. Returns the replies and
    latencies (ms) of each kind and the wall time (s)."""
    import threading

    import torch

    from tpurpc_torch.rpc.channel import Channel
    from tpurpc_torch.torchshim.service import TensorClient
    from tpurpc_torch.wire.h2_client import H2Channel

    per = len(h2_rows) // H2_CLIENTS
    out = {"h2": [None] * len(h2_rows), "native": [None] * len(native_rows)}
    lat = {"h2": [None] * len(h2_rows), "native": [None] * len(native_rows)}
    errors = []
    start = threading.Barrier(H2_CLIENTS + 2, timeout=300)
    zero = torch.zeros((1, TF_SEQ), dtype=torch.int32)

    def h2_client(c):
        try:
            with H2Channel(f"127.0.0.1:{port}") as ch:
                cli = TensorClient(ch)
                cli.call("Generate", {"tokens": zero}, timeout=300)
                start.wait()
                for i in range(c * per, (c + 1) * per):
                    t0 = time.perf_counter()
                    out["h2"][i] = cli.call(
                        "Generate", {"tokens": torch.from_numpy(h2_rows[i])},
                        timeout=300)
                    lat["h2"][i] = (time.perf_counter() - t0) * 1e3
        except Exception as exc:  # surfaced after the join
            errors.append(f"h2 client {c}: {exc!r}")
            start.abort()

    def native_client():
        try:
            with Channel(f"127.0.0.1:{port}") as ch:
                cli = TensorClient(ch, depth=DEPTH)
                cli.call("Generate", {"tokens": zero}, timeout=300)
                pl = cli.pipeline("Generate")
                start.wait()
                t0s = [time.perf_counter()] * len(native_rows)
                futs = []
                for i, r in enumerate(native_rows):
                    if len(futs) >= DEPTH:
                        j, f = futs.pop(0)
                        out["native"][j] = f.result(timeout=300)
                        lat["native"][j] = (time.perf_counter() - t0s[j]) * 1e3
                    t0s[i] = time.perf_counter()
                    futs.append((i, pl.call_async(
                        {"tokens": torch.from_numpy(r)}, timeout=300)))
                for j, f in futs:
                    out["native"][j] = f.result(timeout=300)
                    lat["native"][j] = (time.perf_counter() - t0s[j]) * 1e3
        except Exception as exc:
            errors.append(f"native client: {exc!r}")
            start.abort()

    ts = [threading.Thread(target=h2_client, args=(c,), daemon=True)
          for c in range(H2_CLIENTS)]
    ts.append(threading.Thread(target=native_client, daemon=True))
    for t in ts:
        t.start()
    try:
        start.wait()
    except threading.BrokenBarrierError:
        pass
    t0 = time.perf_counter()
    for t in ts:
        t.join(600)
    wall = time.perf_counter() - t0
    check(not errors, "h2 (a): " + "; ".join(errors))
    check(not any(t.is_alive() for t in ts), "h2 (a): a client did not finish")
    for kind in out:
        check(None not in out[kind] and None not in lat[kind],
              f"h2 (a): a {kind} request got no reply")
    return out, lat, wall


def _h2_drain(srv, port, rows, direct, dev) -> dict:
    """(c): H2_CLIENTS closed-loop H2Channel clients on ``srv``; once each
    has made H2_DRAIN_AFTER calls, and while calls are in flight,
    ``srv.drain()``. Each client calls on until a call is refused before
    the server took it (H2_REFUSED); any other failure fails the phase.
    Every taken call's reply is held bit-equal to the direct run."""
    import threading

    import torch

    from tpurpc_torch.rpc.status import RpcError, StatusCode
    from tpurpc_torch.torchshim.service import TensorClient
    from tpurpc_torch.wire.h2_client import H2Channel

    done = {c: [] for c in range(H2_CLIENTS)}
    refused, errors, goaway = [], [], []
    reached = threading.Semaphore(0)

    def client(c):
        try:
            with H2Channel(f"127.0.0.1:{port}") as ch:
                cli = TensorClient(ch)
                for k in range(64 * len(rows)):
                    i = (c + k * H2_CLIENTS) % len(rows)
                    try:
                        rep = cli.call("Generate", {
                            "tokens": torch.from_numpy(rows[i])}, timeout=300)
                    except RpcError as exc:
                        if (exc.code() is StatusCode.UNAVAILABLE
                                and exc.details().startswith(H2_REFUSED)):
                            refused.append(exc.details())
                            # a stream refused by RST (the server's drain
                            # flag is up before its GOAWAY is written)
                            # comes ahead of the GOAWAY on the wire
                            deadline = time.monotonic() + 10
                            while (not (ch._goaway or ch._dead)
                                   and time.monotonic() < deadline):
                                time.sleep(0.01)
                            goaway.append(ch._goaway or ch._dead)
                            return
                        raise
                    done[c].append((i, rep))
                    if len(done[c]) == H2_DRAIN_AFTER:
                        reached.release()
                raise AssertionError("never refused: the drain did not reach "
                                     "this channel")
        except Exception as exc:  # surfaced after the join
            errors.append(f"h2 drain client {c}: {exc!r}")
            reached.release()

    ts = [threading.Thread(target=client, args=(c,), daemon=True)
          for c in range(H2_CLIENTS)]
    for t in ts:
        t.start()
    for _ in range(H2_CLIENTS):
        reached.acquire(timeout=300)
    deadline = time.monotonic() + 10
    while srv.inflight_requests() == 0 and time.monotonic() < deadline:
        time.sleep(0.0005)
    t0 = time.perf_counter()
    inflight = srv.inflight_requests()
    drained = srv.drain(linger=30.0)
    drain_s = time.perf_counter() - t0
    for t in ts:
        t.join(120)
    check(not errors, "h2 (c): " + "; ".join(errors))
    check(not any(t.is_alive() for t in ts), "h2 (c): a client hung")
    check(inflight > 0, "h2 (c): no call was in flight when the drain began")
    check(drained, "h2 (c): drain() reported streams still in flight")
    check(len(refused) == H2_CLIENTS, f"h2 (c): {len(refused)} of "
          f"{H2_CLIENTS} clients saw the drain: {refused}")
    check(all(g and "GOAWAY" in g for g in goaway),
          f"h2 (c): a channel refused without a GOAWAY: {goaway}")
    taken = [(i, rep) for c in done for i, rep in done[c]]
    wants = {}
    for i, rep in taken:
        if i not in wants:
            wants[i] = _direct(direct, rows[i], dev)
        diff = (rep["logits"] - wants[i]).abs().max().item()
        check(diff == 0.0, f"h2 (c): a taken call's reply is {diff} from "
              f"the direct run")
    return {"taken": len(taken), "refused": len(refused),
            "inflight": inflight, "drain_s": drain_s, "kinds": sorted(
                {d.split(":")[0] for d in refused})}


def h2_serving(dev, card, per_client=PER_CLIENT, h2_calls=H2_CALLS,
               sink_msgs=SINK_MSGS, sink_rounds=SINK_ROUNDS) -> dict:
    """Phase 10: the gRPC wire plane (docstring of this file)."""
    import numpy as np
    import torch

    from tpurpc_torch.torchshim.service import serve_torch
    from tpurpc_torch.utils import config

    config.set_config(None)
    fn = _fleet_transformer(dev)

    def direct(x):
        return fn({"tokens": x})["logits"]

    rng = np.random.default_rng(SEED + 6)     # phase 6's draws
    rng.integers(0, 256, (MAX_BATCH, TF_SEQ))
    native_rows = [rng.integers(0, 256, (1, TF_SEQ)).astype(np.int32)
                   for _ in range(per_client)]
    rng = np.random.default_rng(SEED + 10)
    h2_rows = [rng.integers(0, 256, (1, TF_SEQ)).astype(np.int32)
               for _ in range(H2_CLIENTS * h2_calls)]

    srv, port, batcher = serve_torch(fn, name="Generate", batching=True,
                                     max_batch=MAX_BATCH, max_delay_s=0.005,
                                     max_workers=WORKERS)
    res = {}
    try:
        # (a), once for the readings, once under the profiler
        out, lat, wall = _h2_fanin(port, h2_rows, native_rows)
        for kind, rows in (("h2", h2_rows), ("native", native_rows)):
            worst, apart, _ = _check_replies(
                f"h2 (a) {kind}", out[kind], rows, direct, dev, 0.0, None,
                floor=1.0)
            p50, p99 = np.percentile(lat[kind], [50, 99])
            res[kind] = {"rps": len(rows) / wall, "p50": p50, "p99": p99}
            print(f"h2 (a) {kind}: {len(rows)} requests ("
                  + (f"{H2_CLIENTS} H2Channel clients x {h2_calls} closed-loop"
                     if kind == "h2" else f"one native pipeline at depth "
                     f"{DEPTH}") + f"): requests/s {len(rows) / wall}, "
                  f"latency ms p50 {p50} p99 {p99}; replies vs direct runs "
                  f"max |diff| / max(1, scale) {worst} (bit-equal), nearest "
                  f"other request's run {apart} x it ({card})", flush=True)
        print(f"h2 (a): both kinds together {len(h2_rows) + len(native_rows)}"
              f" requests in {wall} s: {batcher.batches_run} batches, "
              f"{batcher.rows_run} rows (warm-ups included) ({card})",
              flush=True)
        if dev.type == "cuda":
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            with prof:
                t0 = time.perf_counter()
                _h2_fanin(port, h2_rows, native_rows)
                window = time.perf_counter() - t0
            busy = device_busy_ms(prof)
            res["busy"] = busy / (window * 1e3)
            print(f"h2 (a) profiled run: card busy {busy} ms of "
                  f"{window * 1e3} ms ({res['busy']}) ({card})", flush=True)
        else:
            print("h2 (a): the card's busy share not measured (no card)",
                  flush=True)
        # (c) the drain, on the same server
        res["c"] = _h2_drain(srv, port, h2_rows[:H2_CLIENTS * H2_DRAIN_AFTER
                                                * 2], direct, dev)
        print(f"h2 (c): drain with {res['c']['inflight']} calls in flight "
              f"took {res['c']['drain_s']} s; {res['c']['taken']} taken calls"
              f" all bit-equal, {res['c']['refused']} refused before the "
              f"server took them ({res['c']['kinds']}), none failed",
              flush=True)
    finally:
        srv.stop()
        batcher.close()
    # (b) bulk over h2, with rendezvous and without, on the TCP platform
    want = sink_payloads(msgs=sink_msgs)
    saved = {k: os.environ.get(k) for k in SINK_ENV}
    try:
        res["b_rdv"], _ = sink_leg("h2 (b) rendezvous", dev, card, want, {},
                                   rounds=sink_rounds, h2=True)
        for r, rec in enumerate(res["b_rdv"]):
            check(rec["link"]["sent"] == sink_msgs
                  and rec["link"]["fallbacks"] == 0,
                  f"h2 (b) round {r}: not every message rode rendezvous: "
                  f"{rec['link']}")
        res["b_framed"], _ = sink_leg(
            "h2 (b) DATA frames", dev, card, want,
            {"TPURPC_RENDEZVOUS": "0"}, rounds=sink_rounds, h2=True)
        check(all("link" not in rec for rec in res["b_framed"]),
              "h2 (b) DATA frames: a rendezvous link was armed")
    finally:
        _set_env(saved)
    return res


# -- phase 11 ----------------------------------------------------------------

def retry_arithmetic(seed, requests, fraction, max_attempts, throttle):
    """(attempts, aborts, tokens) that ``requests`` sequential calls give
    against a ``FaultInjector`` seeded ``seed`` (one draw an attempt, an
    abort below ``fraction``) under a retry policy of ``max_attempts`` and
    a retry throttle ``{"maxTokens", "tokenRatio"}``: a retryable failure
    costs a token, a success refunds ``tokenRatio``, a retry needs more
    than half the bucket. Fails if the sequence would fail a call."""
    import random

    rng = random.Random(seed)
    cap = float(throttle["maxTokens"])
    tokens = cap
    attempts = aborts = 0
    for i in range(requests):
        for k in range(max_attempts):
            attempts += 1
            if rng.random() >= fraction:
                tokens = min(cap, tokens + throttle["tokenRatio"])
                break
            aborts += 1
            tokens = max(0.0, tokens - 1.0)
            check(k + 1 < max_attempts and tokens > cap / 2,
                  f"call plane: the seeded aborts would fail request {i}")
    return attempts, aborts, tokens


def _ring_wraps(tail: int, span: int, ring: int, first: int = 0) -> int:
    """Landings of ``span`` bytes that wrapped a ring of ``ring`` bytes,
    out of those landed back to back from absolute offset ``first`` up to
    ``tail``."""
    return sum(1 for k in range((tail - first) // span)
               if (first + k * span) % ring + span > ring)


class CallPlaneServer:
    """A started device-ring server of ``fn`` (``Classify``, device mode)
    behind a counting interceptor, placed first so that it sees every
    attempt (``seen``), then ``interceptors``, then a meter.

    ``entered`` gets one entry per handler that started (and ``auth`` its
    context's ``auth_context()``), ``done`` one per handler that finished:
    the host clock (``time.perf_counter()``) at which it did.
    With ``credentials`` (``ssl_server_credentials``'s result) the port is
    a TLS one. An attempt cancelled before its request has
    arrived is seen but never starts: the server skips its handler. ``launched`` holds this
    server's own kernel launches, measured: the meter, innermost, takes
    :attr:`landing` (one lock for every such server) before the request
    lands, and the handler reads the wrappers' counts and lets the lock go
    once the tree has landed. So only landings are serialized, never the
    model, and no other server's landing falls into the window."""

    landing = threading.Lock()

    def __init__(self, fn, interceptors=(), max_workers=16, credentials=None,
                 max_receive_message_length=None):
        from tpurpc_torch.ops import ring_scatter as rs_mod
        from tpurpc_torch.ops import ring_window as rw_mod
        from tpurpc_torch.rpc.interceptors import ServerInterceptor
        from tpurpc_torch.rpc.server import RpcMethodHandler, Server
        from tpurpc_torch.torchshim.service import add_tensor_method

        self.seen, self.entered, self.done, self.auth = [], [], [], []
        self.launched = {"ring_scatter": 0, "ring_window": 0}
        held = threading.local()
        seen, entered, launched = self.seen, self.entered, self.launched
        auth = self.auth

        def let_go():
            before = getattr(held, "before", None)
            if before is None:
                return
            held.before = None
            launched["ring_scatter"] += rs_mod.launches - before[0]
            launched["ring_window"] += rw_mod.launches - before[1]
            CallPlaneServer.landing.release()

        def wrap(handler, behavior):
            return RpcMethodHandler(handler.kind, behavior,
                                    handler.request_deserializer,
                                    handler.response_serializer)

        class Count(ServerInterceptor):
            def intercept_service(self, continuation, details):
                seen.append(details.method)
                handler = continuation(details)
                if handler is None:
                    return None
                inner = handler.behavior

                def counted(raw, ctx):
                    entered.append(1)
                    auth.append(ctx.auth_context())
                    return inner(raw, ctx)

                return wrap(handler, counted)

        class Meter(ServerInterceptor):
            def intercept_service(self, continuation, details):
                handler = continuation(details)
                if handler is None:
                    return None
                inner = handler.behavior

                def metered(raw, ctx):
                    CallPlaneServer.landing.acquire()
                    held.before = (rs_mod.launches, rw_mod.launches)
                    try:
                        return inner(raw, ctx)
                    finally:
                        let_go()        # the landing failed: fn never ran

                return wrap(handler, metered)

        def run(tree):
            let_go()
            out = fn(tree)
            self.done.append(time.perf_counter())
            return out

        self.server = Server(
            max_workers=max_workers,
            interceptors=[Count(), *interceptors, Meter()],
            max_receive_message_length=max_receive_message_length)
        add_tensor_method(self.server, "Classify", run, device=True)
        self.server.start()
        self.port = (self.server.add_insecure_port("127.0.0.1:0")
                     if credentials is None else
                     self.server.add_secure_port("127.0.0.1:0", credentials))

    def ring(self):
        conns = list(self.server._connections)
        check(len(conns) == 1, f"call plane: {len(conns)} server connections")
        return conns[0].endpoint.device_ring


def _cp_calls(ch, images, label, after=None):
    """Sequential ``TensorClient.call``s of every image; each call's host
    ms. ``after(i)`` runs after reply i."""
    import torch

    from tpurpc_torch.torchshim.service import TensorClient

    client = TensorClient(ch)
    replies, lat = [], []
    for i, x in enumerate(images):
        t = time.perf_counter()
        try:
            replies.append(client.call("Classify",
                                       {"images": torch.from_numpy(x)},
                                       timeout=60))
        except Exception as exc:
            fail(f"{label}: call {i} failed: {exc!r}")
        lat.append((time.perf_counter() - t) * 1e3)
        if after is not None:
            after(i)
    return replies, lat


def _cp_check(label, replies, wants):
    import torch

    worst = 0.0
    for i, (r, want) in enumerate(zip(replies, wants)):
        got = r["logits"]
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"{label} reply {i}: logits {tuple(got.shape)} or non-finite")
        scale = max(1.0, want.abs().max().item())
        d = (got - want).abs().max().item()
        check(d <= REPLY_TOL * scale, f"{label} reply {i} differs from the "
              f"direct run by {d} (scale {scale})")
        check(torch.equal(r["top1"], want.argmax(dim=1)),
              f"{label} reply {i} top1 differs from the direct run")
        worst = max(worst, d / scale)
    return worst


def call_plane(dev, card, size=SIZE, ring=RING, requests=REQUESTS) -> dict:
    """Phase 11: the call plane on the device-ring path (docstring of this
    file). Returns each part's kernel launches, and (b)'s per server."""
    import random

    import numpy as np
    import torch

    from tpurpc_torch.models.resnet import make_infer_fn, resnet50
    from tpurpc_torch.ops import ring_scatter as rs_mod
    from tpurpc_torch.ops import ring_window as rw_mod
    from tpurpc_torch.core.endpoint import EndpointError
    from tpurpc_torch.rpc import channel as chmod
    from tpurpc_torch.rpc.channel import Channel
    from tpurpc_torch.rpc.interceptors import FaultConfig, FaultInjector
    from tpurpc_torch.rpc.resolver import _RESOLVERS, register_resolver
    from tpurpc_torch.rpc.status import RpcError, StatusCode

    t_phase = time.perf_counter()
    saved = {k: os.environ.get(k) for k in RING_ENV}
    _set_env({"GRPC_PLATFORM_TYPE": "TPU", "TPURPC_TORCH_DEVICE": str(dev),
              "TPURPC_HBM_RING_SIZE_KB": str(ring >> 10)})
    torch.manual_seed(SEED)                  # phase 3's weights
    infer = make_infer_fn(resnet50().to(dev))

    def classify(tree):
        logits = infer(tree["images"])
        return {"logits": logits, "top1": logits.argmax(dim=1)}

    rng = np.random.default_rng(SEED)        # phase 3's requests
    images = [rng.standard_normal((BATCH, size, size, 3)).astype(np.float32)
              for _ in range(requests)]
    wants = [infer(torch.from_numpy(x).to(dev)).cpu() for x in images]
    span = images[0].nbytes
    wraps = _ring_wraps(requests * span, span, ring)
    check(wraps > 0, f"call plane: no request wraps the {ring}-byte ring")
    res = {}

    def launches():
        return {"ring_scatter": rs_mod.launches,
                "ring_window": rw_mod.launches}

    def per_server(label, rigs, total):
        """Each server's measured launches; together they are all of
        ``total``, the wrappers' counts over the part."""
        per = [rig.launched for rig in rigs]
        check({k: sum(p[k] for p in per) for k in total} == total,
              f"{label}: the servers' launches {per} do not add up to the "
              f"part's {total}")
        return per

    # (a) retries from a delivered service config
    retry = {"maxAttempts": 5, "initialBackoff": "0.01s",
             "maxBackoff": "0.1s", "backoffMultiplier": 2,
             "retryableStatusCodes": ["UNAVAILABLE"]}
    throttle = {"maxTokens": 10, "tokenRatio": 0.5}
    cfg = {"methodConfig": [{"name": [{"service": "tpurpc.Tensor"}],
                             "retryPolicy": retry}],
           "retryThrottling": throttle}
    attempts, aborts, tokens = retry_arithmetic(SEED, requests, 0.3,
                                                retry["maxAttempts"], throttle)
    check(aborts > 0, "call plane (a): the seeded injector aborts nothing")
    fi = FaultInjector({"*": FaultConfig(abort_code=StatusCode.UNAVAILABLE,
                                         abort_fraction=0.3)},
                       rng=random.Random(SEED))
    rig = CallPlaneServer(classify, [fi])
    register_resolver("smoke11",
                      lambda rest: ([("127.0.0.1", rig.port)], cfg))
    try:
        with Channel("smoke11:///a") as ch:
            rs_mod.launches = rw_mod.launches = 0
            replies, lat = _cp_calls(ch, images, "call plane (a)")
            res["a"] = launches()
            left = ch._service_config.retry_throttle.tokens()
            stats = rig.ring().stats()
    finally:
        _RESOLVERS.pop("smoke11", None)
        rig.server.stop()
    worst = _cp_check("call plane (a)", replies, wants)
    per_server("call plane (a)", [rig], res["a"])
    check(len(rig.seen) == attempts, f"call plane (a): the server saw "
          f"{len(rig.seen)} attempts, the seeded abort sequence gives "
          f"{attempts}")
    check(len(rig.done) == requests,
          f"call plane (a): {len(rig.done)} handlers ran")
    check(left == tokens, f"call plane (a): throttle tokens {left}, the "
          f"bucket's arithmetic gives {tokens}")
    check(res["a"] == {"ring_scatter": wraps, "ring_window": wraps},
          f"call plane (a): launches {res['a']}, phase 3 gives {wraps} each "
          f"(an aborted attempt must land nothing)")
    check(stats["tail"] == requests * span and stats["live_spans"] == 0
          and stats["writable"] == stats["capacity"],
          f"call plane (a): ring {stats}")
    p50, p99 = np.percentile(lat, [50, 99])
    print(f"call plane (a): {requests} ResNet-50 calls, retry policy and "
          f"throttle from a registered resolver's service config; the "
          f"FaultInjector (abort 0.3, seed {SEED}) aborted {aborts}: "
          f"{len(rig.seen)} attempts, all calls ok, throttle tokens {left}; "
          f"replies vs direct run max |diff| / max(1, scale) {worst}; "
          f"launches {res['a']}; latency ms p50 {p50} p99 {p99} ({card})",
          flush=True)

    # (b) hedging across two device-ring servers, the second slow
    hedge = {"maxAttempts": 2, "hedgingDelay": "0.05s",
             "nonFatalStatusCodes": ["UNAVAILABLE"]}
    hcfg = {"methodConfig": [{"name": [{"service": "tpurpc.Tensor"}],
                              "hedgingPolicy": hedge}]}
    slow_fi = FaultInjector({"*": FaultConfig(delay_s=1.0,
                                              delay_fraction=1.0)})
    rigs = [CallPlaneServer(classify), CallPlaneServer(classify, [slow_fi])]
    target = "ipv4:" + ",".join(f"127.0.0.1:{r.port}" for r in rigs)
    try:
        rs_mod.launches = rw_mod.launches = 0
        with Channel(target, lb_policy="round_robin",
                     options=[("grpc.service_config",
                               json.dumps(hcfg))]) as ch:
            replies, lat = _cp_calls(ch, images, "call plane (b)")
            # a loser's handler starts, if at all, when its request has
            # arrived, moments after the call's end at the latest; it then
            # sleeps 1.0 s, lands and runs the model. A loser cancelled
            # before its request arrived never starts.
            slow, t_end = rigs[1], time.monotonic()
            while ((time.monotonic() < t_end + 1.5
                    or len(slow.done) < len(slow.entered))
                   and time.monotonic() < t_end + 30):
                time.sleep(0.01)
            check(len(slow.done) == len(slow.entered), f"call plane (b): the "
                  f"slow server finished {len(slow.done)} of the "
                  f"{len(slow.entered)} handlers that started")
            stats = [r.ring().stats() for r in rigs]
            res["b"] = launches()
    finally:
        for r in rigs:
            r.server.stop()
    worst = _cp_check("call plane (b)", replies, wants)
    check(max(lat) < 1000.0, f"call plane (b): a call took {max(lat)} ms: "
          f"it waited on the slow replica")
    check(len(rigs[0].done) == requests, f"call plane (b): the fast server "
          f"finished {len(rigs[0].done)} handlers, want {requests}")
    for k, st in enumerate(stats):
        check(st["live_spans"] == 0 and st["writable"] == st["capacity"],
              f"call plane (b): server {k}'s ring not back: {st}")
    res["b_per_server"] = per_server("call plane (b)", rigs, res["b"])
    for k, (st, got) in enumerate(zip(stats, res["b_per_server"])):
        want = _ring_wraps(st["tail"], span, ring)
        check(got == {"ring_scatter": want, "ring_window": want},
              f"call plane (b): server {k} launched {got}, its ring's "
              f"{st['tail'] // span} landings wrap {want} times")
    hedges = len(rigs[0].seen) + len(rigs[1].seen) - requests
    p50, p99 = np.percentile(lat, [50, 99])
    print(f"call plane (b): {requests} calls, round_robin over two "
          f"device-ring servers, the second delayed 1.0 s, hedgingPolicy "
          f"{hedge} from the grpc.service_config option: attempts fast "
          f"{len(rigs[0].seen)} slow {len(rigs[1].seen)} (handlers started "
          f"{len(rigs[1].entered)}, the rest cancelled before their request "
          f"arrived), hedges fired {hedges}; all answered by the fast server, slowest call "
          f"{max(lat)} ms; replies vs direct run {worst}; slow handlers done, "
          f"both rings back to capacity; launches {res['b']}, per server "
          f"(measured) {res['b_per_server']}; latency ms p50 {p50} p99 "
          f"{p99} ({card})", flush=True)

    # (c) drain migration, the replays counted at the client. Stop-gap:
    # the channel has no replay counter yet (ROADMAP A4), so the part wraps
    # two of its methods for the part's length and puts them back after.
    replays = {"refused": 0, "redial": 0}
    lock = threading.Lock()
    once = chmod.UnaryUnary._call_once
    open_stream = chmod._Connection.open_stream

    def counted_once(self, *a, **kw):
        try:
            return once(self, *a, **kw)
        except RpcError as exc:
            if getattr(exc, "_tpurpc_refused", False):
                with lock:
                    replays["refused"] += 1
            raise

    def counted_open(self):
        try:
            return open_stream(self)
        except EndpointError:
            if self.draining:
                with lock:
                    replays["redial"] += 1
            raise

    rigs = [CallPlaneServer(classify), CallPlaneServer(classify)]
    target = "ipv4:" + ",".join(f"127.0.0.1:{r.port}" for r in rigs)
    calls = 2 * requests
    drained_at = []

    def drain_after(i):
        if i == 3:
            drained_at.append(len(rigs[0].done))
            check(rigs[0].server.drain(linger=10.0),
                  "call plane (c): drain missed its linger")

    chmod.UnaryUnary._call_once = counted_once
    chmod._Connection.open_stream = counted_open
    try:
        rs_mod.launches = rw_mod.launches = 0
        with Channel(target, lb_policy="round_robin") as ch:
            replies, lat = _cp_calls(ch, images + images, "call plane (c)",
                                     after=drain_after)
        res["c"] = launches()
    finally:
        chmod.UnaryUnary._call_once = once
        chmod._Connection.open_stream = open_stream
        for r in rigs:
            r.server.stop()
    worst = _cp_check("call plane (c)", replies, wants + wants)
    per_c = per_server("call plane (c)", rigs, res["c"])
    first, second = len(rigs[0].done), len(rigs[1].done)
    check(first == drained_at[0] and first + second == calls,
          f"call plane (c): the drained server served {first - drained_at[0]}"
          f" calls after the drain ({first} + {second} of {calls})")
    p50, p99 = np.percentile(lat, [50, 99])
    print(f"call plane (c): {calls} calls, round_robin over two servers, "
          f"the first drained after reply 4: none failed, served "
          f"{first}/{second}, the drained one none after; replays at the "
          f"client {replays} (FLAG_REFUSED replays, draining redials); "
          f"replies vs direct run {worst}; launches {res['c']}, per server "
          f"(measured) {per_c}; latency ms p50 {p50} p99 {p99} ({card})",
          flush=True)
    res["replays"] = replays
    _set_env(saved)
    print(f"call plane: phase 11 took {time.perf_counter() - t_phase} s "
          f"({card})", flush=True)
    return res


# -- phase 12 ----------------------------------------------------------------

#: phase 12: the test-only PKI (``tests/torch_tls/make_pki.py`` writes it):
#: the CA, the server's key and certificate (localhost, 127.0.0.1), the
#: client's (SAN URI CLIENT_URI), and a second CA that signs nothing here
PKI_FILES = {"ca": "ca.pem", "srv_key": "server.key", "srv_cert": "server.pem",
             "cli_key": "client.key", "cli_cert": "client.pem",
             "other_ca": "other_ca.pem"}
CLIENT_URI = b"spiffe://tpurpc.test/client"
#: (b): sequential calls over each of the two H2Channels
TLS_H2_CALLS = 16


def tls_pki() -> dict:
    """The test PKI's PEM files as bytes, read from the checkout."""
    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "torch_tls")
    out = {}
    for key, name in PKI_FILES.items():
        with open(os.path.join(here, name), "rb") as f:
            out[key] = f.read()
    return out


def _tls_refusals(port, pki, x) -> list:
    """(c): three clients the mTLS port must refuse, each with one
    ``TensorClient.call``; returns each one's status code name."""
    import torch

    from tpurpc_torch.rpc import (insecure_channel, secure_channel,
                                  ssl_channel_credentials)
    from tpurpc_torch.rpc.status import RpcError
    from tpurpc_torch.torchshim.service import TensorClient

    codes = []
    for label, ch in (
            ("a channel trusting only the other CA", secure_channel(
                f"localhost:{port}",
                ssl_channel_credentials(root_certificates=pki["other_ca"]))),
            ("an insecure channel", insecure_channel(f"127.0.0.1:{port}")),
            ("no client certificate", secure_channel(
                f"localhost:{port}",
                ssl_channel_credentials(root_certificates=pki["ca"])))):
        with ch:
            try:
                TensorClient(ch).call("Classify",
                                      {"images": torch.from_numpy(x)},
                                      timeout=10)
            except RpcError as exc:
                codes.append((label, exc.code().name, exc.details()[:80]))
                continue
        fail(f"tls (c): {label} was served by the mTLS port")
    return codes


def _h2_tls_calls(port, rows, credentials=None):
    """(b): sequential ``TensorClient.call("Generate")`` of every row over
    one ``H2Channel``; the replies, the wall time (s) and the ALPN
    protocol the handshake selected (None in plaintext)."""
    import torch

    from tpurpc_torch.torchshim.service import TensorClient
    from tpurpc_torch.wire.h2_client import H2Channel

    host = "localhost" if credentials is not None else "127.0.0.1"
    with H2Channel(f"{host}:{port}", credentials=credentials) as ch:
        sock = ch._ep._sock
        alpn = (sock.selected_alpn_protocol()
                if hasattr(sock, "selected_alpn_protocol") else None)
        cli = TensorClient(ch)
        cli.call("Generate", {"tokens": torch.zeros((1, TF_SEQ),
                                                    dtype=torch.int32)},
                 timeout=300)
        t0 = time.perf_counter()
        out = [cli.call("Generate", {"tokens": torch.from_numpy(r)},
                        timeout=300) for r in rows]
        wall = time.perf_counter() - t0
    return out, wall, alpn


def tls_plane(dev, card, size=SIZE, ring=RING, requests=REQUESTS,
              h2_calls=TLS_H2_CALLS) -> dict:
    """Phase 12: TLS and mTLS on the device-ring path, the h2 plane over
    TLS, refusals, and reflection and channelz on the mTLS server
    (docstring of this file). Returns each part's kernel launches."""
    import numpy as np
    import torch

    from tpurpc_torch.models.resnet import make_infer_fn, resnet50
    from tpurpc_torch.ops import ring_scatter as rs_mod
    from tpurpc_torch.ops import ring_window as rw_mod
    from tpurpc_torch.rpc import (add_health_servicer, enable_channelz,
                                  enable_server_reflection, insecure_channel,
                                  secure_channel, ssl_channel_credentials,
                                  ssl_server_credentials)
    from tpurpc_torch.rpc.channelz_v1 import SERVICE as CZ_SERVICE
    from tpurpc_torch.rpc.reflection import V1_SERVICE
    from tpurpc_torch.torchshim.service import serve_torch
    from tpurpc_torch.wire.protowire import fields, ld, vf

    t_phase = time.perf_counter()
    pki = tls_pki()
    saved = {k: os.environ.get(k) for k in RING_ENV}
    _set_env({"GRPC_PLATFORM_TYPE": "TPU", "TPURPC_TORCH_DEVICE": str(dev),
              "TPURPC_HBM_RING_SIZE_KB": str(ring >> 10)})
    torch.manual_seed(SEED)                  # phase 3's weights
    infer = make_infer_fn(resnet50().to(dev))

    def classify(tree):
        logits = infer(tree["images"])
        return {"logits": logits, "top1": logits.argmax(dim=1)}

    rng = np.random.default_rng(SEED)        # phase 3's requests
    images = [rng.standard_normal((BATCH, size, size, 3)).astype(np.float32)
              for _ in range(requests)]
    wants = [infer(torch.from_numpy(x).to(dev)).cpu() for x in images]
    span = images[0].nbytes
    wraps = _ring_wraps(requests * span, span, ring)
    check(wraps > 0, f"tls: no request wraps the {ring}-byte ring")
    res = {}

    def launches():
        return {"ring_scatter": rs_mod.launches,
                "ring_window": rw_mod.launches}

    # (a) the same requests in plaintext, then over mTLS
    plain = CallPlaneServer(classify)
    try:
        with insecure_channel(f"127.0.0.1:{plain.port}") as ch:
            rs_mod.launches = rw_mod.launches = 0
            plain_replies, plain_lat = _cp_calls(ch, images, "tls (a) plain")
            res["a_plaintext"] = launches()
            plain_stats = plain.ring().stats()
    finally:
        plain.server.stop()
    creds = ssl_server_credentials([(pki["srv_key"], pki["srv_cert"])],
                                   root_certificates=pki["ca"],
                                   require_client_auth=True)
    rig = CallPlaneServer(classify, credentials=creds)
    add_health_servicer(rig.server)
    enable_server_reflection(rig.server)
    enable_channelz(rig.server)
    mutual = ssl_channel_credentials(root_certificates=pki["ca"],
                                     private_key=pki["cli_key"],
                                     certificate_chain=pki["cli_cert"])
    ch = secure_channel(f"localhost:{rig.port}", mutual)
    try:
        rs_mod.launches = rw_mod.launches = 0
        replies, lat = _cp_calls(ch, images, "tls (a) mTLS")
        res["a"] = launches()
        tls_ring = rig.ring()
        stats = tls_ring.stats()
        ep = rig.server._connections[0].endpoint
        notify_tls = hasattr(ep.pair.notify_sock, "getpeercert")
        worst = _cp_check("tls (a) mTLS", replies, wants)
        _cp_check("tls (a) plain", plain_replies, wants)
        for i, (p, t) in enumerate(zip(plain_replies, replies)):
            check(torch.equal(p["logits"], t["logits"])
                  and torch.equal(p["top1"], t["top1"]),
                  f"tls (a): reply {i} over mTLS is not bit-equal to the "
                  f"plaintext run's")
        check(res["a"] == {"ring_scatter": wraps, "ring_window": wraps}
              and rig.launched == res["a"]
              and res["a_plaintext"] == res["a"],
              f"tls (a): launches mTLS {res['a']} (measured at the server "
              f"{rig.launched}), plaintext {res['a_plaintext']}; the "
              f"{requests} landings wrap {wraps} times")
        for label, st in (("mTLS", stats), ("plaintext", plain_stats)):
            check(st["tail"] == requests * span and st["live_spans"] == 0
                  and st["writable"] == st["capacity"],
                  f"tls (a): the {label} server's ring not back: {st}")
        check(notify_tls, "tls (a): the ring's notify socket is not TLS")
        check(len(rig.auth) == requests and all(
            a.get("transport_security_type") == [b"ssl"]
            and a.get("x509_subject_alternative_name") == [CLIENT_URI]
            for a in rig.auth), f"tls (a): the handlers' auth_context "
              f"{rig.auth[:1]} lacks ssl or the client's SAN")
        p50, p99 = np.percentile(lat, [50, 99])
        q50, q99 = np.percentile(plain_lat, [50, 99])
        print(f"tls (a): {requests} ResNet-50 calls on the device ring over "
              f"mTLS (the ring's notify channel a TLS socket), replies "
              f"bit-equal to the plaintext run's, vs direct run max |diff| / "
              f"max(1, scale) {worst}; launches {res['a']} (measured at the "
              f"server {rig.launched}; plaintext {res['a_plaintext']}); ring "
              f"back to capacity; auth_context {rig.auth[0]}; latency ms "
              f"mTLS p50 {p50} p99 {p99}, plaintext p50 {q50} p99 {q99} "
              f"({card})", flush=True)

        # (c) refusals on the same port leave the card untouched
        before = (launches(), tls_ring.stats())
        codes = _tls_refusals(rig.port, pki, images[0])
        res["c"] = {k: launches()[k] - before[0][k] for k in before[0]}
        after = tls_ring.stats()
        check(all(code == "UNAVAILABLE" for _, code, _ in codes),
              f"tls (c): refusals {codes}")
        check(res["c"] == {"ring_scatter": 0, "ring_window": 0}
              and after == before[1] and after["live_spans"] == 0
              and after["writable"] == after["capacity"],
              f"tls (c): a refused client moved the card: launches "
              f"{res['c']}, ring {before[1]} -> {after}")
        check(len(rig.server._connections) == 1, f"tls (c): "
              f"{len(rig.server._connections)} connections on the server")
        print("tls (c): refused " + "; ".join(
            f"{label}: {code} ({det})" for label, code, det in codes)
              + f"; launches {res['c']}, the ring unmoved and at capacity "
              f"({card})", flush=True)

        # (d) introspection on the same server, over the mTLS channel
        health = ch.unary_unary("/grpc.health.v1.Health/Check")(b"",
                                                                  timeout=10)
        refl = ch.stream_stream(f"/{V1_SERVICE}/ServerReflectionInfo")
        reply = [bytes(r) for r in refl(iter([ld(7, b"")]), timeout=10)]
        names = [bytes(v3).decode()
                 for f, _, v in fields(reply[0]) if f == 6
                 for f2, _, v2 in fields(bytes(v)) if f2 == 1
                 for f3, _, v3 in fields(bytes(v2)) if f3 == 1]
        check("tpurpc.Tensor" in names and "grpc.health.v1.Health" in names,
              f"tls (d): reflection lists {names}")
        made = requests + 2                 # Classify, Check, reflection
        counters = rig.server.call_counters
        deadline = time.monotonic() + 10
        while (counters.succeeded + counters.failed < made
               and time.monotonic() < deadline):
            time.sleep(0.01)
        got = bytes(ch.unary_unary(f"/{CZ_SERVICE}/GetServer")(
            vf(1, rig.server._channelz_id), timeout=10))
        data = next(bytes(v2) for f, _, v in fields(got) if f == 1
                    for f2, _, v2 in fields(bytes(v)) if f2 == 2)
        nums = {f: v for f, _, v in fields(data) if f in (2, 3, 4)}
        started, ok, failed = (nums.get(2, 0), nums.get(3, 0),
                               nums.get(4, 0))
        # GetServer counts itself started while it runs
        check(started - 1 == ok + failed == made and failed == 0,
              f"tls (d): channelz GetServer reads started {started}, "
              f"succeeded {ok}, failed {failed}; the phase made {made} calls "
              f"before it on this server")
        print(f"tls (d): health {bytes(health)!r}; reflection lists {names}; "
              f"channelz GetServer: calls started {started} (GetServer "
              f"itself in flight), succeeded {ok}, failed {failed}: the "
              f"{made} calls the phase made, the refused clients none "
              f"({card})", flush=True)
    finally:
        ch.close()
        rig.server.stop()
    _set_env(saved)

    # (b) the h2 plane over TLS on the TCP platform
    _set_env({"GRPC_PLATFORM_TYPE": None, "TPURPC_HBM_RING_SIZE_KB": None})
    fn = _fleet_transformer(dev)
    rng = np.random.default_rng(SEED + 10)    # phase 10's h2 rows
    rows = [rng.integers(0, 256, (1, TF_SEQ)).astype(np.int32)
            for _ in range(h2_calls)]
    srv, port, batcher = serve_torch(fn, name="Generate", batching=True,
                                     max_batch=MAX_BATCH, max_delay_s=0.005,
                                     max_workers=WORKERS)
    tls_port = srv.add_secure_port("127.0.0.1:0", ssl_server_credentials(
        [(pki["srv_key"], pki["srv_cert"])]))
    try:
        rs_mod.launches = rw_mod.launches = 0
        plain_out, plain_wall, plain_alpn = _h2_tls_calls(port, rows)
        out, wall, alpn = _h2_tls_calls(
            tls_port, rows, ssl_channel_credentials(
                root_certificates=pki["ca"]))
        res["b"] = launches()
    finally:
        srv.stop()
        batcher.close()
    _set_env(saved)
    check(alpn == "h2" and plain_alpn is None,
          f"tls (b): ALPN {alpn!r} (plaintext {plain_alpn!r})")
    for i, (p, t) in enumerate(zip(plain_out, out)):
        check(torch.equal(p["logits"], t["logits"]),
              f"tls (b): reply {i} over TLS is not bit-equal to plaintext's")

    def direct(x):
        return fn({"tokens": x})["logits"]

    worst, _, _ = _check_replies("tls (b)", out, rows, direct, dev, 0.0,
                                 None, floor=1.0)
    check(res["b"] == {"ring_scatter": 0, "ring_window": 0},
          f"tls (b): h2 over TLS launched {res['b']}")
    print(f"tls (b): {h2_calls} sequential Generate calls over an H2Channel "
          f"with TLS (ALPN {alpn}) and over a plaintext one, on one server: "
          f"replies bit-equal to each other and to the direct run ({worst}); "
          f"requests/s TLS {h2_calls / wall}, plaintext "
          f"{h2_calls / plain_wall}; launches {res['b']} ({card})",
          flush=True)
    print(f"tls: phase 12 took {time.perf_counter() - t_phase} s ({card})",
          flush=True)
    return res


# -- phase 13 ----------------------------------------------------------------

def _release(leases) -> None:
    for lease in leases:
        lease.release()
    leases.clear()


class AioRingServer:
    """An ``aio.Server`` of ``fn`` on the device ring (start it with ``await
    rig.server.start()``), with two async handlers that do what
    ``add_tensor_method(..., device=True)`` does: ``Classify`` (unary) and
    ``ClassifyStream`` (stream_stream) under ``/tpurpc.Tensor/``.

    A handler lands each request in its connection's ring with
    ``decode_tree_to_ring`` on a worker thread (a wait for ring credit
    must not stall the loop the other handlers run on), awaits the forward
    there, serializes the reply off the device (``tree_from_device``) and
    only then releases the leases. The stream's handler releases a
    message's leases when it lands the next one, and the last when the
    stream ends. The worker pool has a thread for each server worker, so
    no handler waits on another for a thread.

    ``most`` is the most handlers in flight on the loop at once.
    ``launched`` holds the kernel launches of this server's landings: each
    landing takes :attr:`landing` and reads the wrappers' counts around
    itself."""

    landing = threading.Lock()

    def __init__(self, fn, max_workers=16):
        from concurrent.futures import ThreadPoolExecutor

        from tpurpc_torch.rpc import aio
        from tpurpc_torch.torchshim import codec
        from tpurpc_torch.torchshim.service import TENSOR_SERVICE

        self.fn = fn
        self.inflight = self.most = 0
        self.launched = {"ring_scatter": 0, "ring_window": 0}
        self._count = threading.Lock()
        self._pool = ThreadPoolExecutor(max_workers=max_workers,
                                        thread_name_prefix="aio-ring")
        self.server = aio.Server(max_workers=max_workers)
        encoded = lambda body: body  # noqa: E731  replies leave encoded
        self.server.add_method(
            f"/{TENSOR_SERVICE}/Classify",
            aio.unary_unary_rpc_method_handler(
                self._unary, codec.raw_view, encoded))
        self.server.add_method(
            f"/{TENSOR_SERVICE}/ClassifyStream",
            aio.stream_stream_rpc_method_handler(
                self._stream, codec.raw_view, encoded))
        self.port = self.server.add_insecure_port("127.0.0.1:0")

    async def stop(self) -> None:
        await self.server.stop()
        self._pool.shutdown(wait=False)

    def ring(self):
        conns = list(self.server._sync._connections)
        check(len(conns) == 1, f"aio: {len(conns)} server connections")
        return conns[0].endpoint.device_ring

    def _land(self, ring, raw, held):
        from tpurpc_torch.ops import ring_scatter as rs_mod
        from tpurpc_torch.ops import ring_window as rw_mod
        from tpurpc_torch.tpu.endpoint import decode_tree_to_ring

        if ring is None:
            raise RuntimeError("aio: the connection has no device ring")
        _release(held)
        with AioRingServer.landing:
            before = (rs_mod.launches, rw_mod.launches)
            tree, leases = decode_tree_to_ring(ring, raw)
            self.launched["ring_scatter"] += rs_mod.launches - before[0]
            self.launched["ring_window"] += rw_mod.launches - before[1]
        held.extend(leases)
        return tree

    async def _serve_one(self, ring, raw, held):
        import asyncio

        from tpurpc_torch.tpu.serialize import tree_from_device

        loop = asyncio.get_running_loop()
        tree = await loop.run_in_executor(self._pool, self._land, ring, raw,
                                          held)
        out = await loop.run_in_executor(self._pool, self.fn, tree)
        return await loop.run_in_executor(self._pool, tree_from_device, out)

    def _enter(self) -> None:
        with self._count:
            self.inflight += 1
            self.most = max(self.most, self.inflight)

    def _leave(self) -> None:
        with self._count:
            self.inflight -= 1

    async def _unary(self, raw, ctx):
        self._enter()
        held = []
        try:
            return await self._serve_one(ctx.device_ring, raw, held)
        finally:
            _release(held)
            self._leave()

    async def _stream(self, req_aiter, ctx):
        self._enter()
        held = []
        try:
            async for raw in req_aiter:
                yield await self._serve_one(ctx.device_ring, raw, held)
        finally:
            _release(held)
            self._leave()


async def _aio_drive(rig, images, timeout=120.0) -> dict:
    """Phase 13's client on one ``aio`` channel: a first call that dials
    the connection (``warm``), then (a) every request at once
    (``asyncio.gather``), then one after another; (b) all of them in one
    ``stream_stream`` call. Per part: replies, host ms per call, wall s,
    the kernels' launches and the ring's state after it."""
    import asyncio

    import torch

    from tpurpc_torch.ops import ring_scatter as rs_mod
    from tpurpc_torch.ops import ring_window as rw_mod
    from tpurpc_torch.rpc import aio
    from tpurpc_torch.torchshim import codec
    from tpurpc_torch.torchshim.service import TENSOR_SERVICE

    await rig.server.start()
    out = {}

    def launches():
        return {"ring_scatter": rs_mod.launches,
                "ring_window": rw_mod.launches}

    def part(name, replies, lat, wall, before):
        now = launches()
        out[name] = {"replies": replies, "lat": lat, "wall": wall,
                     "launches": {k: now[k] - before[k] for k in now},
                     "stats": rig.ring().stats()}

    try:
        async with aio.insecure_channel(f"127.0.0.1:{rig.port}") as ch:
            call = ch.unary_unary(f"/{TENSOR_SERVICE}/Classify",
                                  codec.tree_serializer,
                                  codec.tree_deserializer)

            async def timed(x, lat, i):
                t = time.perf_counter()
                reply = await call({"images": torch.from_numpy(x)},
                                   timeout=timeout)
                lat[i] = (time.perf_counter() - t) * 1e3
                return reply

            for name, batch in (("warm", images[:1]), ("a", images),
                                ("a_sequential", images)):
                lat = [0.0] * len(batch)
                before = launches()
                t0 = time.perf_counter()
                if name == "a":
                    replies = await asyncio.gather(
                        *[timed(x, lat, i) for i, x in enumerate(batch)])
                else:
                    replies = [await timed(x, lat, i)
                               for i, x in enumerate(batch)]
                part(name, list(replies), lat, time.perf_counter() - t0,
                     before)

            async def trees():
                for x in images:
                    yield {"images": torch.from_numpy(x)}

            before = launches()
            t0 = time.perf_counter()
            replies = [r async for r in ch.stream_stream(
                f"/{TENSOR_SERVICE}/ClassifyStream", codec.tree_serializer,
                codec.tree_deserializer)(trees(), timeout=timeout)]
            part("b", replies, [], time.perf_counter() - t0, before)
    finally:
        await rig.stop()
    return out


def aio_plane(dev, card, size=SIZE, ring=RING, requests=REQUESTS) -> dict:
    """Phase 13: the asyncio surface on the device-ring path (docstring of
    this file). Returns each part's kernel launches."""
    import asyncio

    import numpy as np
    import torch

    from tpurpc_torch.models.resnet import make_infer_fn, resnet50
    from tpurpc_torch.ops import ring_scatter as rs_mod
    from tpurpc_torch.ops import ring_window as rw_mod
    from tpurpc_torch.rpc import insecure_channel

    t_phase = time.perf_counter()
    saved = {k: os.environ.get(k) for k in RING_ENV}
    _set_env({"GRPC_PLATFORM_TYPE": "TPU", "TPURPC_TORCH_DEVICE": str(dev),
              "TPURPC_HBM_RING_SIZE_KB": str(ring >> 10)})
    torch.manual_seed(SEED)                  # phase 3's weights
    infer = make_infer_fn(resnet50().to(dev))

    def classify(tree):
        logits = infer(tree["images"])
        return {"logits": logits, "top1": logits.argmax(dim=1)}

    rng = np.random.default_rng(SEED)        # phase 3's requests
    images = [rng.standard_normal((BATCH, size, size, 3)).astype(np.float32)
              for _ in range(requests)]
    wants = [infer(torch.from_numpy(x).to(dev)).cpu() for x in images]
    span = images[0].nbytes
    wraps = _ring_wraps(requests * span, span, ring)   # phase 3's launches
    check(wraps > 0, f"aio: no request wraps the {ring}-byte ring")

    # phase 3's sync device path on a server in this process
    sync = CallPlaneServer(classify)
    try:
        with insecure_channel(f"127.0.0.1:{sync.port}") as ch:
            sync_replies, _ = _cp_calls(ch, images, "aio: the sync path")
    finally:
        sync.server.stop()

    rig = AioRingServer(classify)
    rs_mod.launches = rw_mod.launches = 0
    try:
        got = asyncio.run(_aio_drive(rig, images))
    except Exception as exc:
        fail(f"aio: {exc!r}")
    res = {name: got[name]["launches"] for name in got}
    _set_env(saved)

    first = 0                                # the ring's tail before a part
    for name, n in (("warm", 1), ("a", requests), ("a_sequential", requests),
                    ("b", requests)):
        replies = got[name]["replies"]
        check(len(replies) == n, f"aio ({name}): {len(replies)} replies of "
              f"{n}")
        got[name]["worst"] = _cp_check(f"aio ({name})", replies, wants[:n])
        for i, (s, r) in enumerate(zip(sync_replies, replies)):
            check(torch.equal(s["logits"], r["logits"])
                  and torch.equal(s["top1"], r["top1"]),
                  f"aio ({name}): reply {i} is not bit-equal to the sync "
                  f"device path's")
        want = _ring_wraps(first + n * span, span, ring, first)
        st = got[name]["stats"]
        check(res[name] == {"ring_scatter": want, "ring_window": want},
              f"aio ({name}): launches {res[name]}; the landings from "
              f"{first} wrap {want} times")
        first += n * span
        check(st["tail"] == first and st["live_spans"] == 0
              and st["writable"] == st["capacity"],
              f"aio ({name}): the ring not back: {st}")
    check(res["a"] == {"ring_scatter": wraps, "ring_window": wraps},
          f"aio (a): launches {res['a']}, phase 3 gives {wraps} each")
    total = {k: sum(res[n][k] for n in res) for k in res["a"]}
    check(rig.launched == total, f"aio: launches measured at the server "
          f"{rig.launched}, by the wrappers {total}")
    check(rig.most >= 2, f"aio: at most {rig.most} handler in flight: the "
          f"handlers did not overlap on the loop")
    a, seq, b = got["a"], got["a_sequential"], got["b"]
    p50, p99 = np.percentile(a["lat"], [50, 99])
    print(f"aio (a): {requests} ResNet-50 calls of float32 [{BATCH},{size},"
          f"{size},3] at once through an aio channel into async handlers on "
          f"the device ring, replies bit-equal to the sync device path's, vs "
          f"direct run max |diff| / max(1, scale) {a['worst']}; launches "
          f"{res['a']} (phase 3 gives {wraps} each); at most {rig.most} "
          f"handlers in flight on the loop; latency ms p50 {p50} p99 {p99}; "
          f"wall s together {a['wall']} against {seq['wall']} in sequence "
          f"(sequential launches {res['a_sequential']}); requests/s "
          f"together {requests / a['wall']}, in sequence "
          f"{requests / seq['wall']}; the ring back to capacity ({card})",
          flush=True)
    print(f"aio (b): the same {requests} requests in one stream_stream call, "
          f"replies bit-equal to the sync path's; launches {res['b']}; "
          f"{b['wall']} s, requests/s {requests / b['wall']}; the ring back "
          f"to capacity ({card})", flush=True)
    print(f"aio: phase 13 took {time.perf_counter() - t_phase} s ({card})",
          flush=True)
    return res


# -- phase 14 ----------------------------------------------------------------

#: phase 14: the most a watcher may take to apply a balancer's or control
#: plane's update, or to fall back, before the part fails
LB_WAIT_S = 30.0
#: phase 14: the name the balancer lists and the cluster the control plane
#: assigns
LB_NAME = "resnet50"
XDS_ENV = ("GRPC_XDS_BOOTSTRAP", "GRPC_XDS_BOOTSTRAP_CONFIG")


def _await_addrs(ch, want, label) -> float:
    """Seconds until the channel's membership is ``want`` (polled each
    millisecond); fails the run after LB_WAIT_S."""
    t0 = time.perf_counter()
    while ch._addrs != want:
        check(time.perf_counter() - t0 < LB_WAIT_S, f"{label}: the channel's "
              f"addresses {ch._addrs} never became {want}")
        time.sleep(0.001)
    return time.perf_counter() - t0


def _lb_leg(ch, rigs, rings, images, label):
    """``_cp_calls`` of every image through ``ch``: the replies, the index
    of the rig that served each (the one whose ``done`` grew) and each
    call's host ms. The rigs' rings are recorded while the channel's
    connections are open."""
    by, last = [], [len(r.done) for r in rigs]

    def served(i):
        now = [len(r.done) for r in rigs]
        ran = [k for k in range(len(rigs)) if now[k] > last[k]]
        check(len(ran) == 1, f"{label}: call {i} ran on servers {ran}")
        by.append(ran[0])
        last[:] = now

    replies, lat = _cp_calls(ch, images, label, after=served)
    rings.seen()
    return replies, by, lat


class _Rings:
    """Every device ring of each rig's connections, by identity (the ring
    objects are held, so an identity is never reused): ``seen`` records
    them, ``whole`` checks that each is back to capacity, and ``wraps``
    adds up what ``_ring_wraps`` gives for each ring first seen since
    ``mark``."""

    def __init__(self, rigs, span, ring):
        self.rigs, self.span, self.ring = rigs, span, ring
        self.rings = [{} for _ in rigs]
        self.before = [set() for _ in rigs]

    def seen(self) -> None:
        for k, rig in enumerate(self.rigs):
            for conn in list(rig.server._connections):
                # the ring a connection has made, if any: ``device_ring``
                # would make one (again, after the connection closed)
                r = getattr(conn.endpoint, "_hbm", None)
                if r is not None:
                    self.rings[k][id(r)] = r

    def mark(self) -> None:
        self.seen()
        self.before = [set(rings) for rings in self.rings]

    def whole(self, label) -> None:
        self.seen()
        for k, rings in enumerate(self.rings):
            for r in rings.values():
                st = r.stats()
                check(st["live_spans"] == 0
                      and st["writable"] == st["capacity"],
                      f"{label}: a ring of server {'AB'[k]} not back: {st}")

    def wraps(self) -> list:
        self.seen()
        return [sum(_ring_wraps(r.stats()["tail"], self.span, self.ring)
                    for i, r in rings.items() if i not in before)
                for rings, before in zip(self.rings, self.before)]


def _lb_part(label, rigs, images, direct, wants, legs, rings, launches):
    """Checks the legs of one part and prints them. ``legs`` is a list of
    (name, (replies, by, lat), the servers each call must have run on (a
    set), the count each of them must have served or None). Returns each
    server's launches, measured at the server."""
    import numpy as np
    import torch

    lat_all = []
    for name, (replies, by, lat), allowed, share in legs:
        check(set(by) <= allowed, f"{label} {name}: calls ran on servers "
              f"{sorted(set(by))}, want {sorted(allowed)}")
        if share is not None:
            counts = [by.count(k) for k in sorted(allowed)]
            check(counts == share, f"{label} {name}: served {counts}, want "
                  f"{share}")
        for i, (r, k) in enumerate(zip(replies, by)):
            d = direct[k][i]
            check(torch.equal(r["logits"], d["logits"])
                  and torch.equal(r["top1"], d["top1"]),
                  f"{label} {name}: reply {i} is not bit-equal to the same "
                  f"request served directly by server {'AB'[k]}")
        _cp_check(f"{label} {name}", replies, wants)
        lat_all += lat
    per = [dict(r.launched) for r in rigs]
    total = {n: sum(p[n] for p in per) for n in launches}
    check(total == launches, f"{label}: the servers' launches {per} do not "
          f"add up to the part's {launches}")
    want = rings.wraps()
    for k, p in enumerate(per):
        check(p == {"ring_scatter": want[k], "ring_window": want[k]},
              f"{label}: server {'AB'[k]} launched {p}, its rings' landings "
              f"wrap {want[k]} times")
    rings.whole(label)
    check(sum(want) > 0, f"{label}: no landing wrapped a ring")
    p50, p99 = np.percentile(lat_all, [50, 99])
    return per, p50, p99


def lookaside_plane(dev, card, size=SIZE, ring=RING,
                    requests=REQUESTS) -> dict:
    """Phase 14: look-aside LB and xDS EDS over device-ring backends
    (docstring of this file). Returns each part's launches per server."""
    import numpy as np
    import torch

    from tpurpc_torch.models.resnet import make_infer_fn, resnet50
    from tpurpc_torch.ops import ring_scatter as rs_mod
    from tpurpc_torch.ops import ring_window as rw_mod
    from tpurpc_torch.rpc import (Channel, LoadBalancerServicer, Server,
                                  enable_lookaside, insecure_channel)
    from tpurpc_torch.rpc.xds import XdsServicer, xds_channel

    t_phase = time.perf_counter()
    saved = {k: os.environ.get(k) for k in RING_ENV}
    _set_env({"GRPC_PLATFORM_TYPE": "TPU", "TPURPC_TORCH_DEVICE": str(dev),
              "TPURPC_HBM_RING_SIZE_KB": str(ring >> 10)})
    torch.manual_seed(SEED)                  # phase 3's weights
    infer = make_infer_fn(resnet50().to(dev))

    def classify(tree):
        logits = infer(tree["images"])
        return {"logits": logits, "top1": logits.argmax(dim=1)}

    rng = np.random.default_rng(SEED)        # phase 3's requests
    images = [rng.standard_normal((BATCH, size, size, 3)).astype(np.float32)
              for _ in range(requests)]
    wants = [infer(torch.from_numpy(x).to(dev)).cpu() for x in images]
    span = images[0].nbytes
    rigs = [CallPlaneServer(classify), CallPlaneServer(classify)]
    addr = [("127.0.0.1", r.port) for r in rigs]
    hp = [f"{h}:{p}" for h, p in addr]
    rings = _Rings(rigs, span, ring)
    res, lines = {}, []

    def launches():
        return {"ring_scatter": rs_mod.launches,
                "ring_window": rw_mod.launches}

    def zero():
        rs_mod.launches = rw_mod.launches = 0
        for rig in rigs:
            rig.launched.update(ring_scatter=0, ring_window=0)
        rings.mark()

    try:
        # the same requests served directly by each backend
        direct = []
        for k, rig in enumerate(rigs):
            with insecure_channel(hp[k]) as ch:
                replies, _ = _cp_calls(ch, images,
                                       f"lookaside: direct to {'AB'[k]}")
                rings.seen()
            direct.append(replies)

        # (a) grpclb: a balancer names A, then B, then stops
        bal_srv = Server(max_workers=4)
        balancer = LoadBalancerServicer()
        balancer.attach(bal_srv)
        bal_port = bal_srv.add_insecure_port("127.0.0.1:0")
        bal_srv.start()
        balancer.set_servers(LB_NAME, [hp[0]])
        legs, times = [], {}
        try:
            zero()
            with Channel("ipv4:" + ",".join(hp),
                         lb_policy="round_robin") as ch:
                watcher = enable_lookaside(ch, f"127.0.0.1:{bal_port}",
                                           LB_NAME, wire="grpclb")
                try:
                    times["first_list_s"] = _await_addrs(
                        ch, [addr[0]], "lookaside (a)")
                    legs.append(("on A", _lb_leg(ch, rigs, rings, images,
                                                 "lookaside (a) on A"),
                                 {0}, None))
                    n_b = len(rigs[1].done)
                    t_update = time.perf_counter()
                    balancer.set_servers(LB_NAME, [hp[1]])
                    times["switch_s"] = _await_addrs(ch, [addr[1]],
                                                     "lookaside (a)")
                    legs.append(("on B", _lb_leg(ch, rigs, rings, images,
                                                 "lookaside (a) on B"),
                                 {1}, None))
                    times["first_on_b_s"] = rigs[1].done[n_b] - t_update
                    t_stop = time.perf_counter()
                    bal_srv.stop(grace=0)
                    times["stop_s"] = time.perf_counter() - t_stop
                    times["fallback_s"] = _await_addrs(ch, addr,
                                                       "lookaside (a)")
                    legs.append(("fallback", _lb_leg(
                        ch, rigs, rings, images, "lookaside (a) fallback"),
                        {0, 1}, [requests // 2, requests - requests // 2]))
                finally:
                    watcher.stop()
            res["a"] = launches()
        finally:
            bal_srv.stop(grace=0)
        per, p50, p99 = _lb_part("lookaside (a)", rigs, images, direct,
                                 wants, legs, rings, res["a"])
        res["a_per_server"] = per
        lines.append(
            f"lookaside (a): grpclb (grpc.lb.v1) balancer on its own server, "
            f"a channel over A and B (round_robin) moved by enable_lookaside: "
            f"{requests} ResNet-50 calls on A, {requests} on B, then the "
            f"balancer stopped and {requests} over the fallback list served "
            f"{[legs[2][1][1].count(k) for k in (0, 1)]}; every reply "
            f"bit-equal to the same request served directly by its server; "
            f"the balancer's first list applied in {times['first_list_s']} "
            f"s; A -> B: the channel's membership moved {times['switch_s']} "
            f"s after set_servers, the first request served by B "
            f"finished its handler {times['first_on_b_s']} s after it; the "
            f"balancer's stop(grace=0) took {times['stop_s']} s and the "
            f"fallback applied {times['fallback_s']} s after it; launches "
            f"{res['a']}, per server (measured) {per}, as the rings' offsets "
            f"give; every ring back to capacity; latency ms p50 {p50} p99 "
            f"{p99} ({card})")

        # (b) xDS EDS over the v3 ADS stream
        xds = XdsServicer()
        cp = Server(max_workers=4)
        xds.attach(cp)
        cp_port = cp.add_insecure_port("127.0.0.1:0")
        cp.start()
        xds.set_endpoints(LB_NAME, [hp[0]])
        saved_xds = {k: os.environ.get(k) for k in XDS_ENV}
        legs, times = [], {}
        try:
            _set_env({"GRPC_XDS_BOOTSTRAP": None,
                      "GRPC_XDS_BOOTSTRAP_CONFIG": json.dumps(
                          {"xds_servers": [{"server_uri":
                                            f"127.0.0.1:{cp_port}"}],
                           "node": {"id": "chip-smoke"}})})
            zero()
            ch, watcher = xds_channel(f"xds:///{LB_NAME}")
            try:
                check(ch._addrs == [addr[0]], f"xds (b): the channel starts "
                      f"on {ch._addrs}, the assignment names {addr[0]}")
                legs.append(("on A", _lb_leg(ch, rigs, rings, images,
                                             "xds (b) on A"), {0}, None))
                n_b = len(rigs[1].done)
                t_update = time.perf_counter()
                xds.set_endpoints(LB_NAME, [hp[1]])
                times["switch_s"] = _await_addrs(ch, [addr[1]], "xds (b)")
                legs.append(("on B", _lb_leg(ch, rigs, rings, images,
                                             "xds (b) on B"), {1}, None))
                times["first_on_b_s"] = rigs[1].done[n_b] - t_update
                cp.stop(grace=0)
                time.sleep(0.5)          # the watcher sees the stream end
                check(ch._addrs == [addr[1]], f"xds (b): the control plane's "
                      f"loss moved the channel to {ch._addrs}")
                legs.append(("after the control plane", _lb_leg(
                    ch, rigs, rings, images, "xds (b) after the control plane"),
                    {1}, None))
                check(ch._addrs == [addr[1]], f"xds (b): the channel left "
                      f"its last assignment: {ch._addrs}")
                versions = list(watcher.applied_versions)
            finally:
                watcher.stop()
                ch.close()
            res["b"] = launches()
        finally:
            cp.stop(grace=0)
            _set_env(saved_xds)
        check(versions, "xds (b): the watcher applied no update")
        per, p50, p99 = _lb_part("xds (b)", rigs, images, direct, wants,
                                 legs, rings, res["b"])
        res["b_per_server"] = per
        lines.append(
            f"xds (b): XdsServicer on the v3 ADS stream, xds_channel("
            f"'xds:///{LB_NAME}') from GRPC_XDS_BOOTSTRAP_CONFIG: "
            f"{requests} ResNet-50 calls on A, an EDS update to B, "
            f"{requests} on B, the control plane stopped and {requests} more "
            f"on B (the last assignment kept); applied versions {versions}; "
            f"every reply bit-equal to the same request served directly by "
            f"its server; A -> B: the membership moved {times['switch_s']} s "
            f"after set_endpoints, the first request served by B "
            f"finished its handler {times['first_on_b_s']} s after it; launches {res['b']}, per "
            f"server (measured) {per}, as the rings' offsets give; every "
            f"ring back to capacity; latency ms p50 {p50} p99 {p99} ({card})")
    finally:
        for rig in rigs:
            rig.server.stop()
        _set_env(saved)
    for line in lines:
        print(line, flush=True)
    print(f"lookaside: phase 14 took {time.perf_counter() - t_phase} s "
          f"({card})", flush=True)
    return res


# -- phase 15 ----------------------------------------------------------------

#: phase 15 (a): phase 5's legs (a) and (c), the descriptor ring on ("1")
#: and off ("0") in turns that repeat this pattern, CTRL_ROUNDS timed
#: rounds of 64 each
CTRL_PATTERN = ("1", "0", "0", "1")
CTRL_TURNS = 4
CTRL_ROUNDS = 3
#: (b): the receive limit of the server that takes the inflating request,
#: and that request's one leaf (zeros: a few KiB once gzipped)
GZ_LIMIT = 8 << 20
GZ_BOMB = 32 << 20
#: (c): how long the spawned server may take to print its port, and the
#: environment the part sets (and restores) for its client
TCPW_START_S = 180
TCPW_ENV = ("GRPC_PLATFORM_TYPE", "TPURPC_RING_DOMAIN",
            "TPURPC_HBM_RING_SIZE_KB", "TPURPC_TORCH_DEVICE",
            "TPURPC_TCPW_BIND")
#: (d): a pipelined call whose deadline expires, and how late it may fail
DEADLINE_S, DEADLINE_LATE_S = 0.2, 0.1
#: (d): the most threads 128 calls with deadlines may run beyond the same
#: calls without (the wheel's thread and run_blocking's pool of 4)
THREAD_SLACK = 8


def _ctrl_summary(turns) -> dict:
    """One leg's turns in one ring state, each turn's first round left out
    (every turn's slowest: its standing grants and caches warm up): the
    median and quartiles of GB/s, and the median of the server's host ms
    per message by stage."""
    import numpy as np

    recs = [rec for recs in turns for rec in recs[1:]]
    gbps = [rec["gbps"] for rec in recs]
    return {"gbps_median": float(np.median(gbps)),
            "gbps_q1": float(np.percentile(gbps, 25)),
            "gbps_q3": float(np.percentile(gbps, 75)),
            "server_ms": {k: float(np.median([rec["server_ms"][k]
                                              for rec in recs]))
                          for k in recs[0]["server_ms"]},
            "rounds": len(recs)}


def _ctrl_turns(dev, card, want, rounds, ring,
                turns=CTRL_TURNS) -> dict:
    """Phase 15 (a): phase 5's legs (a) and (c), the descriptor ring on and
    off in ``turns`` turns of CTRL_PATTERN. Checks every round; prints per
    leg and state every round's GB/s, the median and quartiles over the
    rounds after each turn's first, the server's host ms per message, the
    links' counts, and in how many turn pairs (an on turn and the off turn
    beside it) the ring's median won. Returns leg (c)'s launches per round,
    by ring state, and the summary."""
    import numpy as np

    n = len(want[0])
    check(rounds >= 2, f"transport (a): {rounds} rounds a turn, want at "
          f"least 2 (each turn's first is left out of the summary)")
    # a message's leaves in the codec's order: its index (int64) and its
    # payload
    leaves = (8, want[0][0].nbytes)
    legs = (("a", {"GRPC_PLATFORM_TYPE": "RDMA_BPEV"}, False),
            ("c", {"GRPC_PLATFORM_TYPE": "TPU",
                   "TPURPC_HBM_RING_SIZE_KB": str(ring >> 10)}, True))
    got = {(leg, on): [] for leg, _, _ in legs for on in ("1", "0")}
    order = {leg: [] for leg, _, _ in legs}   # (state, recs) by turn
    saved = {k: os.environ.get(k) for k in SINK_ENV}
    try:
        for turn in range(turns):
            on = CTRL_PATTERN[turn % len(CTRL_PATTERN)]
            for leg, env, device_ring in legs:
                label = (f"transport (a) leg {leg}, ring "
                         f"{'on' if on == '1' else 'off'}, turn {turn}")
                recs, _ = sink_leg(label, dev, card, want,
                                   dict(env, TPURPC_CTRL_RING=on),
                                   device_ring=device_ring, rounds=rounds)
                for r, rec in enumerate(recs):
                    cl, sl = rec["link"], rec["srv_link"]
                    check(cl["sent"] == n and cl["fallbacks"] == 0,
                          f"{label} round {r}: not every payload rode "
                          f"rendezvous: {cl}")
                    if on == "1":
                        check(cl["ctrl_frames"] == 0
                              and sl["ctrl_frames"] == 0
                              and cl["ctrl_posts"] >= n,
                              f"{label} round {r}: control ops framed with "
                              f"the ring on: client {cl}, server {sl}")
                    else:
                        check(cl["ctrl_posts"] == 0 and sl["ctrl_posts"] == 0
                              and cl["ctrl_frames"] >= n,
                              f"{label} round {r}: ring posts with the ring "
                              f"off: client {cl}, server {sl}")
                    if device_ring:
                        # the round's landings, by the server's rings'
                        # offsets, give its launches whatever the control
                        # plane does
                        tails = rec["ring_tails"]
                        check(len(tails) == 1 and tails[0][1] - tails[0][0]
                              == n * sum(leaves),
                              f"{label} round {r}: the server's rings "
                              f"advanced {tails}, want one ring by "
                              f"{n} messages of {leaves} bytes")
                        want_l = _landing_launches(*tails[0], leaves, ring)
                        check(rec["launches"] == want_l
                              and min(want_l.values()) >= 1,
                              f"{label} round {r}: launched "
                              f"{rec['launches']}, the landings from "
                              f"{tails[0][0]} to {tails[0][1]} give "
                              f"{want_l}")
                got[(leg, on)].append(recs)
                order[leg].append((on, recs))
    finally:
        _set_env(saved)
    # the same spans land at the same offsets of a fresh ring in every
    # turn: the launches per round must not depend on the control plane
    per_turn = [[rec["launches"] for rec in recs]
                for on in ("1", "0") for recs in got[("c", on)]]
    check(all(t == per_turn[0] for t in per_turn),
          f"transport (a): leg c's launches per round differ between "
          f"turns: {per_turn}")
    summary = {}
    for leg, runs in order.items():
        out = {}
        for on in ("1", "0"):
            state = "on" if on == "1" else "off"
            turns_on = got[(leg, on)]
            recs = [rec for rs in turns_on for rec in rs]
            cl = {k: sum(rec["link"][k] for rec in recs) for k in LINK_KEYS}
            sl = {k: sum(rec["srv_link"][k] for rec in recs)
                  for k in LINK_KEYS}
            out[state] = _ctrl_summary(turns_on)
            rounds_gbps = [[round(rec["gbps"], 4) for rec in rs]
                           for rs in turns_on]
            print(f"transport (a) leg {leg}, ring {state}: GB/s by turn "
                  f"{rounds_gbps}; after each turn's first round "
                  f"{out[state]}; over "
                  f"{len(recs)} rounds of {n} client link {cl}, server "
                  f"links {sl} ({card})", flush=True)
        # turn pairs: each on turn against the off turn beside it in the
        # pattern (turns 0/1, 3/2, 4/5, 7/6, ...)
        won = pairs = 0
        for i in range(0, len(runs) - 1, 2):
            a, b = runs[i], runs[i + 1]
            on_run, off_run = (a, b) if a[0] == "1" else (b, a)
            m_on = np.median([r["gbps"] for r in on_run[1][1:]])
            m_off = np.median([r["gbps"] for r in off_run[1][1:]])
            pairs += 1
            won += int(m_on > m_off)
        out["pairs"], out["ring_won"] = pairs, won
        summary[leg] = out
        print(f"transport (a) leg {leg}: the ring's median won {won} of "
              f"{pairs} turn pairs; on/off median GB/s "
              f"{out['on']['gbps_median'] / out['off']['gbps_median']} "
              f"({card})", flush=True)
    return {"1": [rec["launches"] for recs in got[("c", "1")]
                  for rec in recs],
            "0": [rec["launches"] for recs in got[("c", "0")]
                  for rec in recs],
            "summary": summary}


def _gz_requests(requests, size):
    """Phase 3's requests, each with a compressible leaf beside its images:
    an int64 index of the images' byte size."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED)        # phase 3's requests
    images = [rng.standard_normal((BATCH, size, size, 3)).astype(np.float32)
              for _ in range(requests)]
    index = torch.arange(images[0].nbytes // 8, dtype=torch.int64)
    return images, [{"images": torch.from_numpy(x), "index": index}
                    for x in images]


def _counting_writes(ch) -> list:
    """Count the bytes the channel's connection writes to its endpoint
    (dials the connection)."""
    conn = ch._connection()
    ep = conn.writer._ep
    real, wrote = ep.write, [0]

    def write(data):
        segs = ([data] if isinstance(data, (bytes, bytearray, memoryview))
                else data)
        wrote[0] += sum(memoryview(s).nbytes for s in segs)
        return real(data)

    ep.write = write
    return wrote


def _gz_part(dev, card, classify, size, requests, wants) -> dict:
    """Phase 15 (b): compression onto the device ring, then a request that
    inflates past the receive limit. ``wants``: the requests' logits from
    the model run directly. Returns the launches each way."""
    import numpy as np
    import torch

    from tpurpc_torch.ops import ring_scatter as rs_mod
    from tpurpc_torch.ops import ring_window as rw_mod
    from tpurpc_torch.rpc.channel import Channel
    from tpurpc_torch.rpc.status import RpcError, StatusCode
    from tpurpc_torch.torchshim.service import TensorClient
    from tpurpc_torch.tpu import ledger

    _, reqs = _gz_requests(requests, size)
    res = {}
    for way in ("identity", "gzip"):
        rig = CallPlaneServer(classify)
        try:
            with Channel(f"127.0.0.1:{rig.port}",
                         compression=None if way == "identity" else way) as ch:
                wrote = _counting_writes(ch)
                cli = TensorClient(ch)
                replies, lat = [], []
                with ledger.track() as w:
                    for i, req in enumerate(reqs):
                        t = time.perf_counter()
                        try:
                            replies.append(cli.call("Classify", req,
                                                    timeout=120))
                        except Exception as exc:
                            fail(f"transport (b) {way}: call {i} failed: "
                                 f"{exc!r}")
                        lat.append((time.perf_counter() - t) * 1e3)
                st = rig.ring().stats()
        finally:
            rig.server.stop()
        check(st["live_spans"] == 0 and st["writable"] == st["capacity"],
              f"transport (b) {way}: the ring is not whole: {st}")
        res[way] = {"replies": replies, "launched": dict(rig.launched),
                    "p50": float(np.percentile(lat, 50)),
                    "p99": float(np.percentile(lat, 99)),
                    "wrote": wrote[0], "rdma_write": w["rdma_write"],
                    "stats": st,
                    "worst": _cp_check(f"transport (b) {way}", replies,
                                       wants)}
    a, b = res["identity"], res["gzip"]
    for i, (x, y) in enumerate(zip(a["replies"], b["replies"])):
        check(torch.equal(x["logits"], y["logits"])
              and torch.equal(x["top1"], y["top1"]),
              f"transport (b): reply {i} with gzip is not bit-equal")
    check(a["launched"] == b["launched"]
          and min(a["launched"].values()) >= 1,
          f"transport (b): launches {a['launched']} without and "
          f"{b['launched']} with gzip")
    for way, r in res.items():
        print(f"transport (b) {way}: client endpoint wrote {r['wrote']} "
              f"bytes, rendezvous wrote {r['rdma_write']}; p50 "
              f"{r['p50']:.2f} ms, p99 {r['p99']:.2f} ms over {requests} "
              f"requests of {reqs[0]['images'].nbytes} + "
              f"{reqs[0]['index'].nbytes} bytes; launches {r['launched']}; "
              f"replies within {r['worst']} of the direct run's scale; "
              f"ring {r['stats']} ({card})", flush=True)

    # a request that inflates past the receive limit: refused at
    # reassembly, before any tensor reaches the ring
    rig = CallPlaneServer(classify, max_receive_message_length=GZ_LIMIT)
    before = (rs_mod.launches, rw_mod.launches)
    try:
        with Channel(f"127.0.0.1:{rig.port}", compression="gzip") as ch:
            wrote = _counting_writes(ch)
            try:
                TensorClient(ch).call(
                    "Classify", {"images": torch.zeros(GZ_BOMB // 4)},
                    timeout=60)
                code = StatusCode.OK
            except RpcError as exc:
                code = exc.code()
    finally:
        rig.server.stop()
    after = (rs_mod.launches, rw_mod.launches)
    check(code is StatusCode.RESOURCE_EXHAUSTED,
          f"transport (b): a {GZ_BOMB}-byte request past a {GZ_LIMIT}-byte "
          f"limit ended {code}")
    check(after == before and rig.launched == {"ring_scatter": 0,
                                               "ring_window": 0},
          f"transport (b): the refused request launched {after} - {before}")
    print(f"transport (b): {GZ_BOMB} bytes of zeros, {wrote[0]} bytes on "
          f"the wire, refused {code.name} past a {GZ_LIMIT}-byte limit, "
          f"no launch ({card})", flush=True)
    return {way: r["launched"] for way, r in res.items()}


def tcpw_ring_server(conn, env: dict, size: int) -> None:
    """Phase 15 (c)'s server process (spawned): phase 3's ResNet-50 on the
    card (``TPURPC_TORCH_DEVICE``) behind a device-ring server on ``env``'s
    platform and domain, cuDNN in its deterministic mode, warmed at
    [BATCH, size, size, 3]. Sends its port, serves until told to stop,
    then sends its launches and its rings' tails."""
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    os.environ.update(env)
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    from tpurpc_torch.models.resnet import make_infer_fn, resnet50
    from tpurpc_torch.ops import ring_scatter as rs_mod
    from tpurpc_torch.ops import ring_window as rw_mod
    from tpurpc_torch.rpc.server import Server
    from tpurpc_torch.torchshim.service import add_tensor_method
    from tpurpc_torch.utils.config import get_config

    dev = torch.device(get_config().device)
    torch.manual_seed(SEED)                  # phase 3's weights
    infer = make_infer_fn(resnet50().to(dev))
    infer(torch.zeros(BATCH, size, size, 3, device=dev))
    _sync(dev)

    def classify(tree):
        logits = infer(tree["images"])
        return {"logits": logits, "top1": logits.argmax(dim=1)}

    srv = Server(max_workers=4)
    add_tensor_method(srv, "Classify", classify, device=True)
    srv.start()
    port = srv.add_insecure_port("127.0.0.1:0")
    rs_mod.launches = rw_mod.launches = 0
    conn.send({"port": port, "domain": get_config().ring_domain})
    conn.recv()                              # the client is done
    rings = [c.endpoint.device_ring.stats() for c in list(srv._connections)
             if getattr(c.endpoint, "_hbm", None) is not None]
    conn.send({"launches": {"ring_scatter": rs_mod.launches,
                            "ring_window": rw_mod.launches},
               "rings": rings})
    srv.stop()


def _tcpw_part(dev, card, wants, images, ring) -> dict:
    """Phase 15 (c): phase 3's requests from this process into a spawned
    server's device ring over ``shm`` and over ``tcp_window``. Returns the
    server's launches on each domain."""
    import multiprocessing as mp

    import numpy as np
    import torch

    from tpurpc_torch.rpc.channel import Channel
    from tpurpc_torch.torchshim.service import TensorClient

    ctx = mp.get_context("spawn")
    res = {}
    saved = {k: os.environ.get(k) for k in TCPW_ENV}
    try:
        for domain in ("shm", "tcp_window"):
            # the record servers of both processes listen on the loopback
            env = {"GRPC_PLATFORM_TYPE": "TPU", "TPURPC_RING_DOMAIN": domain,
                   "TPURPC_HBM_RING_SIZE_KB": str(ring >> 10),
                   "TPURPC_TORCH_DEVICE": str(dev),
                   "TPURPC_TCPW_BIND": "127.0.0.1"}
            _set_env(env)
            here, there = ctx.Pipe()
            t0 = time.perf_counter()
            proc = ctx.Process(target=tcpw_ring_server,
                               args=(there, env, images[0].shape[1]),
                               daemon=True)
            proc.start()
            try:
                check(here.poll(TCPW_START_S), f"transport (c) {domain}: the "
                      f"server process printed no port in {TCPW_START_S} s")
                hello = here.recv()
                start_s = time.perf_counter() - t0
                check(hello["domain"] == domain,
                      f"transport (c): the server runs on {hello['domain']}")
                with Channel(f"127.0.0.1:{hello['port']}") as ch:
                    pair = getattr(ch._connection().endpoint, "pair", None)
                    check(pair is not None and pair.domain.kind == domain,
                          f"transport (c) {domain}: the client's pair is on "
                          f"{None if pair is None else pair.domain.kind}")
                    cli = TensorClient(ch)
                    replies, lat = [], []
                    for i, x in enumerate(images):
                        t = time.perf_counter()
                        try:
                            replies.append(cli.call(
                                "Classify", {"images": torch.from_numpy(x)},
                                timeout=120))
                        except Exception as exc:
                            fail(f"transport (c) {domain}: call {i} "
                                 f"failed: {exc!r}")
                        lat.append((time.perf_counter() - t) * 1e3)
                    # the report reads the rings of the server's open
                    # connections: ask for it before this one closes
                    here.send("stop")
                    check(here.poll(60), f"transport (c) {domain}: no "
                          f"report")
                    report = here.recv()
            finally:
                proc.join(30)
                if proc.is_alive():
                    proc.kill()
                    proc.join(10)
            check(proc.exitcode == 0, f"transport (c) {domain}: the server "
                  f"process exited {proc.exitcode}")
            span = images[0].nbytes
            wraps = sum(_ring_wraps(st["tail"], span, ring)
                        for st in report["rings"])
            check(report["launches"] == {"ring_scatter": wraps,
                                         "ring_window": wraps}
                  and wraps > 0,
                  f"transport (c) {domain}: the server launched "
                  f"{report['launches']}, its ring's landings wrap {wraps} "
                  f"times")
            for st in report["rings"]:
                check(st["live_spans"] == 0
                      and st["writable"] == st["capacity"],
                      f"transport (c) {domain}: the ring is not whole: {st}")
            worst = _cp_check(f"transport (c) {domain}", replies, wants)
            res[domain] = {"replies": replies, "lat": lat,
                           "launches": report["launches"], "start": start_s,
                           "worst": worst}
    finally:
        _set_env(saved)
    for i, (x, y) in enumerate(zip(res["shm"]["replies"],
                                   res["tcp_window"]["replies"])):
        check(torch.equal(x["logits"], y["logits"])
              and torch.equal(x["top1"], y["top1"]),
              f"transport (c): reply {i} over tcp_window is not bit-equal to "
              f"the same request's over shm")
    for domain, r in res.items():
        print(f"transport (c) {domain}: p50 "
              f"{float(np.percentile(r['lat'], 50)):.2f} ms, p99 "
              f"{float(np.percentile(r['lat'], 99)):.2f} ms over "
              f"{len(r['lat'])} requests; the server launched "
              f"{r['launches']}; replies within {r['worst']} of the direct "
              f"run's scale; the server process started in {r['start']:.2f} "
              f"s ({card})", flush=True)
    return {domain: r["launches"] for domain, r in res.items()}


class _ThreadPeak:
    """Samples ``threading.active_count()`` every millisecond while on."""

    def __init__(self):
        self.peak = 0
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            self.peak = max(self.peak, threading.active_count())
            time.sleep(0.001)

    def __enter__(self):
        self._t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join(5)


def _wheel_part(dev, card) -> dict:
    """Phase 15 (d): phase 4's 128 pipelined calls (float32, ``serve_torch``
    as its (b)) without deadlines, then with one each, counting the threads
    alive; then one call whose deadline expires."""
    import numpy as np
    import torch

    from tpurpc_torch.models.resnet import make_infer_fn, resnet50
    from tpurpc_torch.rpc.channel import Channel
    from tpurpc_torch.rpc.server import Server, unary_unary_rpc_method_handler
    from tpurpc_torch.rpc.status import RpcError
    from tpurpc_torch.torchshim.service import serve_torch

    saved = {k: os.environ.get(k) for k in RING_ENV}
    _set_env({"GRPC_PLATFORM_TYPE": None, "TPURPC_HBM_RING_SIZE_KB": None})
    rng = np.random.default_rng(SEED)        # phase 4's images
    images = [rng.standard_normal((1, SIZE, SIZE, 3)).astype(np.float32)
              for _ in range(CLIENTS * PER_CLIENT)]
    torch.manual_seed(SEED)
    infer32 = make_infer_fn(resnet50().to(dev))
    infer32(torch.zeros(MAX_BATCH, SIZE, SIZE, 3, device=dev))
    res = {}
    try:
        srv, port, batcher = serve_torch(
            lambda t: {"logits": infer32(t["x"])}, name="Infer",
            batching=True, max_batch=MAX_BATCH, max_workers=WORKERS)
        try:
            # a first run starts the server's pool threads; then the same
            # calls without deadlines and with them, each counted
            drive_clients(port, images, PER_CLIENT, batcher, call_timeout=None)
            for label, timeout in (("no deadline", None), ("deadline", 300.0)):
                with _ThreadPeak() as tp:
                    replies, lat, wall, _ = drive_clients(
                        port, images, PER_CLIENT, batcher,
                        call_timeout=timeout)
                check(all(r is not None and r["logits"].shape[0] >= 1
                          for r in replies),
                      f"transport (d) {label}: a reply is missing")
                res[label] = {"peak": tp.peak, "p50": float(
                    np.percentile(lat, 50)), "wall": wall}
        finally:
            srv.stop()
            batcher.close()

        gate = threading.Event()

        def held(req, ctx):
            gate.wait(30)
            return bytes(req)

        srv = Server(max_workers=2)
        srv.add_method("/transport.S/Held",
                       unary_unary_rpc_method_handler(held))
        srv.start()
        port = srv.add_insecure_port("127.0.0.1:0")
        try:
            with Channel(f"127.0.0.1:{port}") as ch:
                pipe = ch.unary_unary("/transport.S/Held").pipeline(4)
                t0 = time.perf_counter()
                fut = pipe.call_async(b"late", timeout=DEADLINE_S)
                try:
                    fut.result(timeout=30)
                    code = "OK"
                except RpcError as exc:
                    code = exc.code().name
                late = time.perf_counter() - t0 - DEADLINE_S
        finally:
            gate.set()
            srv.stop()
    finally:
        _set_env(saved)
    plain, timed = res["no deadline"], res["deadline"]
    check(timed["peak"] - plain["peak"] <= THREAD_SLACK,
          f"transport (d): {timed['peak']} threads with deadlines against "
          f"{plain['peak']} without")
    check(code == "DEADLINE_EXCEEDED" and late <= DEADLINE_LATE_S,
          f"transport (d): a {DEADLINE_S} s deadline ended {code} {late} s "
          f"after it")
    print(f"transport (d): {CLIENTS * PER_CLIENT} pipelined calls, peak "
          f"threads {plain['peak']} without deadlines and {timed['peak']} "
          f"with (p50 {plain['p50']:.2f} and {timed['p50']:.2f} ms, wall "
          f"{plain['wall']:.3f} and {timed['wall']:.3f} s); a {DEADLINE_S} s "
          f"deadline failed {code} {late * 1e3:.2f} ms after it ({card})",
          flush=True)
    return {"peak": (plain["peak"], timed["peak"]), "late_s": late}


def transport_plane(dev, card, size=SIZE, ring=RING, requests=REQUESTS,
                    sink_rounds=CTRL_ROUNDS, want=None) -> dict:
    """Phase 15: the head of the transport (docstring of this file).
    Returns each part's launches."""
    import numpy as np
    import torch

    from tpurpc_torch.models.resnet import make_infer_fn, resnet50

    t_phase = time.perf_counter()
    res = {"a": _ctrl_turns(dev, card, want or sink_payloads(), sink_rounds,
                            ring)}
    print(f"transport: (a) took {time.perf_counter() - t_phase} s",
          flush=True)
    saved = {k: os.environ.get(k) for k in RING_ENV}
    _set_env({"GRPC_PLATFORM_TYPE": "TPU", "TPURPC_TORCH_DEVICE": str(dev),
              "TPURPC_HBM_RING_SIZE_KB": str(ring >> 10)})
    try:
        torch.manual_seed(SEED)                  # phase 3's weights
        infer = make_infer_fn(resnet50().to(dev))

        def classify(tree):
            logits = infer(tree["images"])
            return {"logits": logits, "top1": logits.argmax(dim=1)}

        images, _ = _gz_requests(requests, size)
        wants = [infer(torch.from_numpy(x).to(dev)).cpu() for x in images]
        res["b"] = _gz_part(dev, card, classify, size, requests, wants)
    finally:
        _set_env(saved)
    res["c"] = _tcpw_part(dev, card, wants, images, ring)
    res["d"] = _wheel_part(dev, card)
    print(f"transport: phase 15 took {time.perf_counter() - t_phase} s "
          f"({card})", flush=True)
    return res


# -- phase 16 ----------------------------------------------------------------

#: phase 16 (a): the parked fleet, the channels woken from it, the calls of
#: each woken channel (its 4th landing wraps its 16 MiB ring), the idle time
#: before a pair parks, the live channel's calls, and the host ring size
#: (128 pair ends of 1 MiB + a status page fit the RingPool's 256 MiB cap)
LC_FLEET, LC_WOKEN, LC_WAKE_CALLS = 64, 8, 3
LC_PARK_S, LC_LIVE_CALLS, LC_HOST_RING_KB = "0.5", 16, 1024
LC_PARK_WAIT_S = 60.0
#: (c): max connection age, its calls and their spread; keepalive knobs and
#: the idle spell it must survive
LC_AGE_MS, LC_AGE_CALLS, LC_AGE_SPREAD_S = 1000, 16, 3.0
LC_KA_TIME_MS, LC_KA_TIMEOUT_MS, LC_KA_IDLE_S = 200, 1000, 2.0
#: (d): channels that dial at once, and the admission gate's bound
LC_BURST, LC_MAX_INFLIGHT = 32, 4
LC_ENV = RING_ENV + ("TPURPC_PAIR_PARK_S", "TPURPC_RING_BUFFER_SIZE_KB",
                     "TPURPC_MAX_CONNECTION_AGE_MS", "TPURPC_KEEPALIVE_TIME_MS",
                     "TPURPC_KEEPALIVE_TIMEOUT_MS",
                     "TPURPC_ADMISSION_MAX_INFLIGHT")


class _Landings:
    """Records every device-ring landing while on (``HbmRing.place`` and
    ``place_many``): each ring's capacity, the landing's offset and its
    leaves' sizes, from which :meth:`launches` gives what the offsets give
    (a ``ring_scatter`` for a landing that wraps, a ``ring_window`` for a
    leaf whose view wraps)."""

    def __enter__(self):
        from tpurpc_torch.tpu.hbm_ring import HbmRing

        self._cls = HbmRing
        self._orig = (HbmRing.place, HbmRing.place_many)
        place, place_many = self._orig
        recs, lock = [], threading.Lock()
        self.recs = recs

        def rec_place(ring, payload, timeout=None):
            off, n = place(ring, payload, timeout=timeout)
            if n:
                with lock:
                    recs.append((id(ring), ring.capacity, off, (n,)))
            return off, n

        def rec_many(ring, payloads, timeout=None):
            spans = place_many(ring, payloads, timeout=timeout)
            if spans and sum(n for _, n in spans):
                with lock:
                    recs.append((id(ring), ring.capacity, spans[0][0],
                                 tuple(n for _, n in spans)))
            return spans

        HbmRing.place, HbmRing.place_many = rec_place, rec_many
        return self

    def __exit__(self, *exc):
        self._cls.place, self._cls.place_many = self._orig

    def launches(self) -> dict:
        got = {"ring_scatter": 0, "ring_window": 0}
        for _, cap, off, leaves in self.recs:
            got["ring_scatter"] += off % cap + sum(leaves) > cap
            for n in leaves:
                got["ring_window"] += off % cap + n > cap
                off += n
        return got


def _raise_nofile() -> str:
    """Raise this process's soft open-file limit to its hard limit: the
    parked fleet holds 128 pair ends, each with a notify socket, wake
    pipes, selectors and shared-memory mappings."""
    import resource

    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft != hard:
        resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
    return f"RLIMIT_NOFILE {soft} -> {hard}"


def _conn_of(srv, ch):
    """The server connection behind the channel's live connection."""
    local = ch._conn.endpoint.local_address
    for conn in list(srv._connections):
        if conn.endpoint.peer == local:
            return conn
    fail(f"lifecycle: no server connection for {local}")


def _lc_call(label, client, x, timeout=60):
    import torch

    try:
        return client.call("Classify", {"images": torch.from_numpy(x)},
                           timeout=timeout)
    except Exception as exc:
        fail(f"{label}: call failed: {exc!r}")


def _bit_equal(label, got, want) -> None:
    import torch

    check(all(torch.equal(got[k], want[k]) for k in ("logits", "top1")),
          f"{label}: reply not bit-equal to the reference reply")


def _await(pred, timeout, label):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return time.monotonic() - (deadline - timeout)
        time.sleep(0.01)
    fail(f"{label}: not within {timeout} s")


def _parked_fleet(dev, card, classify, images, wants, fleet, woken,
                  live_calls) -> dict:
    """Phase 16 (a): returns the first replies by image, the part's
    launches, and the figures."""
    import numpy as np

    from tpurpc_torch.core.pair import STATUS_BYTES, RingPool
    from tpurpc_torch.core.poller import Poller
    from tpurpc_torch.rpc.channel import Channel
    from tpurpc_torch.torchshim.service import TensorClient

    host_ring = LC_HOST_RING_KB << 10
    per_end = host_ring + STATUS_BYTES
    _set_env({"TPURPC_PAIR_PARK_S": "0",
              "TPURPC_RING_BUFFER_SIZE_KB": str(LC_HOST_RING_KB)})
    rig = CallPlaneServer(classify)
    chans = [Channel(f"127.0.0.1:{rig.port}") for _ in range(fleet + 1)]
    live, fleet_chs = chans[-1], chans[:-1]
    res = {}
    try:
        first = []
        for i, ch in enumerate(fleet_chs):
            first.append(_lc_call(f"lifecycle (a) fleet call {i}",
                                  TensorClient(ch),
                                  images[i % len(images)]))
        _cp_check("lifecycle (a) fleet", first,
                  [wants[i % len(images)] for i in range(fleet)])
        lat_off = []
        for k in range(live_calls):
            t = time.perf_counter()
            _lc_call("lifecycle (a) live, parking off",
                     TensorClient(live), images[k % len(images)])
            lat_off.append((time.perf_counter() - t) * 1e3)
        pairs = ([ch._conn.endpoint.pair for ch in fleet_chs]
                 + [_conn_of(rig.server, ch).endpoint.pair
                    for ch in fleet_chs])
        before = RingPool.get().stats()
        # parking on: the poller's sweeps park the idle fleet
        _set_env({"TPURPC_PAIR_PARK_S": LC_PARK_S})
        # a pair's flag goes up a moment before the poller's parked set
        # takes it: wait for both
        t_park = _await(lambda: all(p._parked for p in pairs)
                        and Poller.get().parked_count() >= 2 * fleet,
                        LC_PARK_WAIT_S, "lifecycle (a): the fleet parked")
        parked_n = Poller.get().parked_count()
        # parking off again: a woken pair stays awake, so the pool's
        # counts after the wakes are the wakes' alone
        _set_env({"TPURPC_PAIR_PARK_S": "0"})
        mid = RingPool.get().stats()
        stub = {p.resident_bytes_est() for p in pairs}
        check(stub == {256}, f"lifecycle (a): parked residents {stub}")
        check(before["leased_bytes"] - mid["leased_bytes"]
              >= 2 * fleet * per_end
              and mid["free_bytes"] - before["free_bytes"]
              >= 2 * fleet * per_end,
              f"lifecycle (a): RingPool before {before}, parked {mid}: "
              f"{2 * fleet} ends of {per_end} bytes not moved to free")
        wake = fleet_chs[:woken]
        rings = [_conn_of(rig.server, ch).endpoint.device_ring
                 for ch in wake]
        kept = [(r.buf.data_ptr(), r.stats()["tail"]) for r in rings]
        lat_on = []
        for k in range(live_calls):
            t = time.perf_counter()
            _lc_call("lifecycle (a) live, fleet parked",
                     TensorClient(live), images[k % len(images)])
            lat_on.append((time.perf_counter() - t) * 1e3)
        wake_ms = []
        for i, (ch, ring, (ptr, tail)) in enumerate(zip(wake, rings,
                                                         kept)):
            x = images[i % len(images)]
            for c in range(LC_WAKE_CALLS):
                t = time.perf_counter()
                got = _lc_call(f"lifecycle (a) woken channel {i}",
                               TensorClient(ch), x)
                if c == 0:
                    wake_ms.append((time.perf_counter() - t) * 1e3)
                    check(ring.buf.data_ptr() == ptr
                          and ring.stats()["tail"] == tail + x.nbytes,
                          f"lifecycle (a) woken channel {i}: ring at "
                          f"{ring.buf.data_ptr()} tail "
                          f"{ring.stats()['tail']}, was {ptr} tail "
                          f"{tail} (a landing of {x.nbytes})")
                _bit_equal(f"lifecycle (a) woken channel {i} call {c}",
                           got, first[i])
            ends = (ch._conn.endpoint.pair,
                    _conn_of(rig.server, ch).endpoint.pair)
            check(not any(p._parked for p in ends),
                  f"lifecycle (a) woken channel {i}: an end still "
                  f"parked")
        after = RingPool.get().stats()
        check(all(p.parked_epochs >= 1 for p in pairs)
              and sum(not p._parked for p in pairs) == 2 * woken,
              f"lifecycle (a): {sum(not p._parked for p in pairs)} "
              f"fleet ends awake after {woken} channels called")
        check(after["leased_bytes"] - mid["leased_bytes"]
              >= 2 * woken * per_end,
              f"lifecycle (a): RingPool parked {mid}, after the wakes "
              f"{after}: the woken ends leased no rings")
    finally:
        for ch in chans:
            ch.close()
        rig.server.stop()
        _set_env({"TPURPC_PAIR_PARK_S": "0"})
    p50_off, p50_on = np.percentile(lat_off, 50), np.percentile(lat_on, 50)
    res.update(first=first[:len(images)], p50_off=p50_off, p50_on=p50_on,
               pool={"before": before, "parked": mid, "after": after},
               park_s=t_park)
    print(f"lifecycle (a): {fleet} device-ring channels (one call each, a "
          f"{RING >> 20} MiB HbmRing per connection, {LC_HOST_RING_KB} KiB "
          f"host rings) parked on both ends {t_park:.3f} s after parking "
          f"was switched on at {LC_PARK_S} s (parked set {parked_n}); "
          f"RingPool before {before}, parked {mid}, after {woken} wakes "
          f"{after}; a parked end's resident {stub}; the woken channels' "
          f"first calls {np.round(wake_ms, 2).tolist()} ms, each ring kept "
          f"its address and tail, every reply bit-equal to the channel's "
          f"first; a live channel's {live_calls} calls p50 {p50_on:.2f} ms "
          f"with the fleet parked, {p50_off:.2f} ms with parking off "
          f"({card})", flush=True)
    return res


def _inproc_part(dev, card, classify, images, first, requests) -> dict:
    """Phase 16 (b): the tensor method through ``inproc_channel``, then an
    inline unary echo over the device ring."""
    import numpy as np

    from tpurpc_torch.ops import ring_scatter as rs_mod
    from tpurpc_torch.ops import ring_window as rw_mod
    from tpurpc_torch.rpc.channel import Channel
    from tpurpc_torch.rpc.server import (Server, inproc_channel,
                                         unary_unary_rpc_method_handler)
    from tpurpc_torch.torchshim.service import TensorClient, add_tensor_method

    srv = Server(max_workers=4)
    add_tensor_method(srv, "Classify", classify, device=True)
    srv.start()
    rs_mod.launches = rw_mod.launches = 0
    lat = []
    try:
        ch = inproc_channel(srv)
        try:
            client = TensorClient(ch)
            for i in range(requests):
                t = time.perf_counter()
                got = _lc_call(f"lifecycle (b) inproc call {i}", client,
                               images[i % len(images)])
                lat.append((time.perf_counter() - t) * 1e3)
                _bit_equal(f"lifecycle (b) inproc call {i}", got,
                           first[i % len(images)])
        finally:
            ch.close()
    finally:
        srv.stop()
    launched = {"ring_scatter": rs_mod.launches,
                "ring_window": rw_mod.launches}
    check(launched == {"ring_scatter": 0, "ring_window": 0},
          f"lifecycle (b): the inproc leg launched {launched}")
    rng = np.random.default_rng(SEED)
    blobs = [rng.integers(0, 256, 1 << 16, dtype=np.uint8).tobytes()
             for _ in range(requests)]
    srv = Server(max_workers=2)
    srv.add_method("/lifecycle.S/Echo", unary_unary_rpc_method_handler(
        lambda r, c: bytes(r), inline=True))
    srv.start()
    port = srv.add_insecure_port("127.0.0.1:0")
    try:
        with Channel(f"127.0.0.1:{port}") as ch:
            echo = ch.unary_unary("/lifecycle.S/Echo")
            for i, b in enumerate(blobs):
                got = echo(b, timeout=30)
                check(bytes(got) == b,
                      f"lifecycle (b): inline echo {i} not bit-equal")
            kind = type(ch._conn.endpoint).__name__
    finally:
        srv.stop()
    p50 = float(np.percentile(lat, 50))
    print(f"lifecycle (b): {requests} ResNet-50 calls through inproc_channel"
          f" (a passthru endpoint pair, host decode): replies bit-equal to "
          f"(a)'s over the device ring, p50 {p50:.2f} ms, launches "
          f"{launched}; {requests} inline unary echoes of 64 KiB over a "
          f"{kind} bit-equal ({card})", flush=True)
    return {"p50": p50}


def _lifecycle_part(dev, card, classify, images, first) -> dict:
    """Phase 16 (c): connectivity, ping, max connection age and keepalive
    on the device ring."""
    import numpy as np

    from tpurpc_torch.rpc.channel import Channel, channel_ready_future
    from tpurpc_torch.rpc.status import ChannelConnectivity as CC
    from tpurpc_torch.torchshim.service import TensorClient

    res = {}
    rig = CallPlaneServer(classify)
    try:
        with Channel(f"127.0.0.1:{rig.port}") as ch:
            states = [ch.get_state().name,
                      ch.get_state(try_to_connect=True).name]
            _await(lambda: ch.get_state() is CC.READY, 30,
                   "lifecycle (c): READY")
            states.append(ch.get_state().name)
            channel_ready_future(ch).result(timeout=30)
            check(states == ["IDLE", "CONNECTING", "READY"],
                  f"lifecycle (c): states {states}")
            rtts = [ch.ping(timeout=5) * 1e3 for _ in range(16)]
            res["ping_p50_ms"] = float(np.percentile(rtts, 50))
            got = _lc_call("lifecycle (c) after ping", TensorClient(ch),
                           images[0])
            _bit_equal("lifecycle (c) after ping", got, first[0])
    finally:
        rig.server.stop()

    # max connection age: the server GOAWAYs each connection after 1 s
    _set_env({"TPURPC_MAX_CONNECTION_AGE_MS": str(LC_AGE_MS)})
    rig = CallPlaneServer(classify)
    conns, lat = [], []
    try:
        with Channel(f"127.0.0.1:{rig.port}") as ch:
            client = TensorClient(ch)
            gap = LC_AGE_SPREAD_S / LC_AGE_CALLS
            for i in range(LC_AGE_CALLS):
                t = time.perf_counter()
                got = _lc_call(f"lifecycle (c) max age call {i}", client,
                               images[i % len(images)])
                lat.append((time.perf_counter() - t) * 1e3)
                _bit_equal(f"lifecycle (c) max age call {i}", got,
                           first[i % len(images)])
                conn = ch._conn
                if not conns or conns[-1] is not conn:
                    conns.append(conn)
                time.sleep(gap)
    finally:
        rig.server.stop()
        _set_env({"TPURPC_MAX_CONNECTION_AGE_MS": None})
    check(len(conns) >= 3, f"lifecycle (c): {len(conns)} connections over "
          f"{LC_AGE_SPREAD_S} s at a {LC_AGE_MS} ms max age: the client "
          f"redialed {len(conns) - 1} times, want at least 2")
    res["age_conns"] = len(conns)

    # keepalive: an idle channel keeps its one connection
    _set_env({"TPURPC_KEEPALIVE_TIME_MS": str(LC_KA_TIME_MS),
              "TPURPC_KEEPALIVE_TIMEOUT_MS": str(LC_KA_TIMEOUT_MS)})
    rig = CallPlaneServer(classify)
    try:
        with Channel(f"127.0.0.1:{rig.port}") as ch:
            client = TensorClient(ch)
            _lc_call("lifecycle (c) keepalive", client, images[0])
            conn = ch._conn
            time.sleep(LC_KA_IDLE_S)
            got = _lc_call("lifecycle (c) keepalive after idle", client,
                           images[0])
            _bit_equal("lifecycle (c) keepalive after idle", got, first[0])
            check(ch._conn is conn and conn.alive and conn.pong_count >= 1,
                  f"lifecycle (c): keepalive lost the connection (same "
                  f"{ch._conn is conn}, alive {conn.alive}, pongs "
                  f"{conn.pong_count})")
            res["ka_pongs"] = conn.pong_count
    finally:
        rig.server.stop()
        _set_env({"TPURPC_KEEPALIVE_TIME_MS": None,
                  "TPURPC_KEEPALIVE_TIMEOUT_MS": None})
    p50 = float(np.percentile(lat, 50))
    print(f"lifecycle (c): states {states}, channel_ready_future resolved; "
          f"16 pings p50 {res['ping_p50_ms']:.3f} ms; max age {LC_AGE_MS} "
          f"ms: {LC_AGE_CALLS} calls over {LC_AGE_SPREAD_S} s on "
          f"{len(conns)} connections, none failed, every reply bit-equal, "
          f"p50 {p50:.2f} ms; keepalive "
          f"{LC_KA_TIME_MS}/{LC_KA_TIMEOUT_MS} ms: idle {LC_KA_IDLE_S} s "
          f"kept its connection ({res['ka_pongs']} PONGs) ({card})",
          flush=True)
    return res


def _burst_part(dev, card, classify, images, first) -> dict:
    """Phase 16 (d): a burst of dials to one device-ring server, then
    admission pushback at the accept path."""
    import torch

    from tpurpc_torch.rpc.channel import Channel
    from tpurpc_torch.rpc.server import Server, unary_unary_rpc_method_handler
    from tpurpc_torch.rpc.status import RpcError
    from tpurpc_torch.torchshim.service import TensorClient

    res = {}
    rig = CallPlaneServer(classify)
    chans = [Channel(f"127.0.0.1:{rig.port}") for _ in range(LC_BURST)]
    got, errs = [None] * LC_BURST, []
    start = threading.Barrier(LC_BURST)

    def dial(i):
        try:
            start.wait(30)
            got[i] = TensorClient(chans[i]).call(
                "Classify", {"images": torch.from_numpy(
                    images[i % len(images)])}, timeout=120)
        except Exception as exc:
            errs.append(f"{i}: {exc!r}")

    try:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=dial, args=(i,))
                   for i in range(LC_BURST)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(180)
        wall = time.perf_counter() - t0
        listener = rig.server._listeners[0]
        shed, burst = listener.shed, listener.max_burst
    finally:
        for ch in chans:
            ch.close()
        rig.server.stop()
    check(not errs, f"lifecycle (d): burst calls failed: {errs[:4]}")
    for i in range(LC_BURST):
        _bit_equal(f"lifecycle (d) burst call {i}", got[i],
                   first[i % len(images)])
    check(shed == 0, f"lifecycle (d): the burst shed {shed} dials")

    # admission: a gate of LC_MAX_INFLIGHT, every slot held on an event
    _set_env({"TPURPC_ADMISSION_MAX_INFLIGHT": str(LC_MAX_INFLIGHT)})
    gate = threading.Event()
    entered = []

    def held(req, ctx):
        entered.append(1)
        gate.wait(60)
        return bytes(req)

    srv = Server(max_workers=LC_MAX_INFLIGHT + 4)
    srv.add_method("/lifecycle.S/Held", unary_unary_rpc_method_handler(held))
    srv.start()
    port = srv.add_insecure_port("127.0.0.1:0")
    holders = [Channel(f"127.0.0.1:{port}") for _ in range(LC_MAX_INFLIGHT)]
    outs = [None] * LC_MAX_INFLIGHT
    extra = []

    def hold(i):
        try:
            outs[i] = bytes(holders[i].unary_unary("/lifecycle.S/Held")(
                b"held%d" % i, timeout=120))
        except Exception as exc:
            outs[i] = repr(exc)

    try:
        threads = [threading.Thread(target=hold, args=(i,))
                   for i in range(LC_MAX_INFLIGHT)]
        for t in threads:
            t.start()
        _await(lambda: len(entered) == LC_MAX_INFLIGHT, 30,
               "lifecycle (d): the held calls entered")
        refused = 0
        for k in range(LC_MAX_INFLIGHT):
            ch = Channel(f"127.0.0.1:{port}")
            extra.append(ch)
            try:
                ch.unary_unary("/lifecycle.S/Held")(b"late", timeout=10)
            except RpcError as exc:
                refused += exc.code().name == "UNAVAILABLE"
        shed_n = srv._listeners[0].shed
        gate.set()
        for t in threads:
            t.join(60)
        after = []
        for k in range(LC_MAX_INFLIGHT):
            with Channel(f"127.0.0.1:{port}") as ch:
                after.append(bytes(ch.unary_unary("/lifecycle.S/Held")(
                    b"after%d" % k, timeout=30)))
    finally:
        gate.set()
        for ch in holders + extra:
            ch.close()
        srv.stop()
        _set_env({"TPURPC_ADMISSION_MAX_INFLIGHT": None})
    check(outs == [b"held%d" % i for i in range(LC_MAX_INFLIGHT)],
          f"lifecycle (d): held calls {outs}")
    check(refused == LC_MAX_INFLIGHT and shed_n >= LC_MAX_INFLIGHT,
          f"lifecycle (d): {refused} dials refused, {shed_n} shed at "
          f"accept, want {LC_MAX_INFLIGHT} each")
    check(after == [b"after%d" % k for k in range(LC_MAX_INFLIGHT)],
          f"lifecycle (d): calls after the release {after}")
    res.update(shed=shed_n, max_burst=burst, wall=wall)
    print(f"lifecycle (d): {LC_BURST} channels dialed one device-ring server "
          f"at once: all bootstrapped and answered bit-equal in {wall:.3f} s "
          f"(largest accept burst {burst}, shed {shed}); with "
          f"TPURPC_ADMISSION_MAX_INFLIGHT="
          f"{LC_MAX_INFLIGHT} and every slot held, {refused} new dials "
          f"refused UNAVAILABLE, {shed_n} shed before any handshake; after "
          f"the release the held calls and {LC_MAX_INFLIGHT} new dials "
          f"completed ({card})", flush=True)
    return res


def lifecycle_plane(dev, card, size=SIZE, ring=RING, requests=REQUESTS,
                    fleet=LC_FLEET, woken=LC_WOKEN,
                    live_calls=LC_LIVE_CALLS) -> dict:
    """Phase 16: the connection lifecycle (docstring of this file).
    Returns each part's launches; (a), (c) and (d) are checked against what
    their landings' ring offsets give."""
    import numpy as np
    import torch

    from tpurpc_torch.models.resnet import make_infer_fn, resnet50
    from tpurpc_torch.ops import ring_scatter as rs_mod
    from tpurpc_torch.ops import ring_window as rw_mod

    t_phase = time.perf_counter()
    print(f"lifecycle: {_raise_nofile()}", flush=True)
    saved = {k: os.environ.get(k) for k in LC_ENV}
    _set_env({"GRPC_PLATFORM_TYPE": "TPU", "TPURPC_TORCH_DEVICE": str(dev),
              "TPURPC_HBM_RING_SIZE_KB": str(ring >> 10)})
    res = {}
    try:
        torch.manual_seed(SEED)                  # phase 3's weights
        infer = make_infer_fn(resnet50().to(dev))

        def classify(tree):
            logits = infer(tree["images"].to(dev))
            return {"logits": logits, "top1": logits.argmax(dim=1)}

        rng = np.random.default_rng(SEED)        # phase 3's requests
        images = [rng.standard_normal((BATCH, size, size, 3)).astype(
            np.float32) for _ in range(requests)]
        wants = [infer(torch.from_numpy(x).to(dev)).cpu() for x in images]

        def part(name, fn, *args):
            """Run one part with the wrappers' counts set to 0 just
            before; its launches must be what its landings' ring offsets
            give."""
            t = time.perf_counter()
            with _Landings() as land:
                rs_mod.launches = rw_mod.launches = 0
                out = fn(*args)
                got = {"ring_scatter": rs_mod.launches,
                       "ring_window": rw_mod.launches}
            want = land.launches()
            check(got == want, f"lifecycle ({name}): launched {got}, the "
                  f"{len(land.recs)} landings' ring offsets give {want}")
            out["launches"] = got
            print(f"lifecycle: ({name}) took {time.perf_counter() - t} s",
                  flush=True)
            return out

        res["a"] = part("a", _parked_fleet, dev, card, classify, images,
                        wants, fleet, woken, live_calls)
        first = res["a"]["first"]
        res["b"] = part("b", _inproc_part, dev, card, classify, images,
                        first, requests)
        res["c"] = part("c", _lifecycle_part, dev, card, classify, images,
                        first)
        res["d"] = part("d", _burst_part, dev, card, classify, images,
                        first)
    finally:
        _set_env(saved)
    total = {k: sum(res[p]["launches"][k] for p in "abcd")
             for k in ("ring_scatter", "ring_window")}
    check(min(total.values()) >= 1, f"lifecycle: phase 16 launched {total}")
    print(f"lifecycle: phase 16 took {time.perf_counter() - t_phase} s, "
          f"launches {total} ({card})", flush=True)
    return res


# -- phase 17 ----------------------------------------------------------------

#: phase 17 (a): TPURPC_INLINE_PUMP for each turn's fresh channel, and each
#: turn's warm-up and timed calls
PUMP_PATTERN = ("auto", "0", "0", "auto", "auto", "0")
PUMP_WARM, PUMP_CALLS = 2, 32
#: (b): pipelined calls and the window
PUMP_PIPE_CALLS, PUMP_PIPE_DEPTH = 64, 16
#: (b): how long after the window drains the servicing thread may linger
PUMP_LINGER_S = 1.0
#: (c): phase 15 (a)'s device-ring leg, the pump on and off in turns
PUMP_SINK_PATTERN = ("auto", "0", "0", "auto")
#: (d): the server's max connection age (off the backup pump's 0.5 s grid
#: from the dial, so the GOAWAY lands between two ticks), the most an idle
#: pump-mode connection may take to read it (two backup intervals), and
#: keepalive time, timeout and the idle spell it must survive
PUMP_AGE_MS, PUMP_GOAWAY_S = 1250, 1.0
PUMP_KA_TIME_MS, PUMP_KA_TIMEOUT_MS, PUMP_KA_IDLE_S = 200, 1000, 2.0
PUMP_PINGS = 32
#: (e): threads on one connection, and the calls each makes
PUMP_THREADS, PUMP_THREAD_CALLS = 8, 16
PUMP_ENV = LC_ENV + ("TPURPC_INLINE_PUMP", "TPURPC_CTRL_RING")

#: phase 3's model, requests and replies, kept for phase 17's bit-equality
_PHASE3: dict = {}


def _pump_mode_of(label, conn, want_pump: bool) -> None:
    thread = getattr(conn, "_thread", None)
    reader = thread is not None and thread.is_alive()
    check(conn._pump_mode is want_pump and reader is not want_pump,
          f"{label}: pump mode {conn._pump_mode}, reader thread {reader}; "
          f"want pump mode {want_pump}")


def _dial_in_mode(port, mode):
    """A fresh channel whose connection is dialed with TPURPC_INLINE_PUMP
    set to ``mode`` (read once, at the connection's construction), the
    variable restored right after the dial."""
    from tpurpc_torch.rpc.channel import Channel

    saved = os.environ.get("TPURPC_INLINE_PUMP")
    _set_env({"TPURPC_INLINE_PUMP": mode})
    try:
        ch = Channel(f"127.0.0.1:{port}")
        ch._subchannels[0].get()
    finally:
        _set_env({"TPURPC_INLINE_PUMP": saved})
    return ch


def _pump_turns(dev, card, classify, images, first, calls,
                pattern=PUMP_PATTERN) -> dict:
    """Phase 17 (a): phase 3's path, one fresh channel a turn, the pump on
    (``auto``) and off (``0``) in ``pattern``'s turns. Each turn's
    launches must be what its landings' offsets give."""
    import numpy as np

    from tpurpc_torch.ops import ring_scatter as rs_mod
    from tpurpc_torch.ops import ring_window as rw_mod
    from tpurpc_torch.torchshim.service import TensorClient

    rig = CallPlaneServer(classify)
    turns, per_turn = [], []
    try:
        for turn, mode in enumerate(pattern):
            label = f"pump (a) turn {turn}, TPURPC_INLINE_PUMP={mode}"
            with _Landings() as land:
                rs_mod.launches = rw_mod.launches = 0
                ch = _dial_in_mode(rig.port, mode)
                try:
                    _pump_mode_of(label, ch._conn, mode == "auto")
                    client = TensorClient(ch)
                    for i in range(PUMP_WARM):
                        got = _lc_call(f"{label} warm-up {i}", client,
                                       images[i % len(images)])
                        _bit_equal(f"{label} warm-up {i}", got,
                                   first[i % len(images)])
                    lat = []
                    for i in range(calls):
                        k = (PUMP_WARM + i) % len(images)
                        t = time.perf_counter()
                        got = _lc_call(f"{label} call {i}", client, images[k])
                        lat.append((time.perf_counter() - t) * 1e3)
                        _bit_equal(f"{label} call {i}", got, first[k])
                    _pump_mode_of(label, ch._conn, mode == "auto")
                finally:
                    ch.close()
                got_l = {"ring_scatter": rs_mod.launches,
                         "ring_window": rw_mod.launches}
            want_l = land.launches()
            check(got_l == want_l, f"{label}: launched {got_l}, the "
                  f"{len(land.recs)} landings' ring offsets give {want_l}")
            rec = {"mode": mode, "p50": float(np.percentile(lat, 50)),
                   "p99": float(np.percentile(lat, 99)), "launches": got_l}
            turns.append(rec)
            per_turn.append(got_l)
            print(f"{label}: {calls} calls p50 {rec['p50']:.3f} ms p99 "
                  f"{rec['p99']:.3f} ms, launches {got_l} ({card})",
                  flush=True)
    finally:
        rig.server.stop()
    # each turn's fresh connection lands from offset 0 of a fresh ring: the
    # launches must not depend on who reads the connection
    check(all(t == per_turn[0] for t in per_turn),
          f"pump (a): launches differ between turns: {per_turn}")
    out = {"turns": turns}
    for mode in ("auto", "0"):
        recs = [r for r in turns if r["mode"] == mode]
        out[mode] = {"p50_median": float(np.median([r["p50"] for r in recs])),
                     "p99_median": float(np.median([r["p99"] for r in recs])),
                     "launches": [r["launches"] for r in recs]}
    spread = [r["p50"] for r in turns]
    # turn pairs: each on turn against the off turn beside it (turns 0/1,
    # 2/3, ...): in how many the pump's p50 read lower
    won = sum(int(a["p50"] < b["p50"]) if a["mode"] == "auto"
              else int(b["p50"] < a["p50"])
              for a, b in zip(turns[::2], turns[1::2]))
    out["pairs"], out["pump_won"] = len(turns) // 2, won
    print(f"pump (a): phase 3's path, {len(pattern)} turns of {calls} "
          f"calls; median p50/p99 ms pump on {out['auto']['p50_median']:.3f}"
          f"/{out['auto']['p99_median']:.3f}, off "
          f"{out['0']['p50_median']:.3f}/{out['0']['p99_median']:.3f}; "
          f"on/off p50 {out['auto']['p50_median'] / out['0']['p50_median']}"
          f"; turn p50s {min(spread):.3f}..{max(spread):.3f} ms; the pump's "
          f"p50 lower in {won} of {out['pairs']} turn pairs; replies "
          f"bit-equal to phase 3's in both modes ({card})", flush=True)
    return out


def _pump_pipeline(dev, card, classify, images, first, n) -> dict:
    """Phase 17 (b): ``n`` calls through one ``PipelinedUnary`` of depth
    PUMP_PIPE_DEPTH on one pump-mode device-ring connection."""
    import torch

    from tpurpc_torch.torchshim.service import TensorClient

    rig = CallPlaneServer(classify)
    try:
        ch = _dial_in_mode(rig.port, "auto")
        try:
            _pump_mode_of("pump (b)", ch._conn, True)
            client = TensorClient(ch)
            pipe = client.pipeline("Classify", depth=PUMP_PIPE_DEPTH)

            def servicing():
                with pipe._lock:
                    return [t for t in pipe._pump_threads.values()
                            if t.is_alive()]

            most, futs = 0, []
            t0 = time.perf_counter()
            for i in range(n):
                futs.append(pipe.call_async(
                    {"images": torch.from_numpy(images[i % len(images)])},
                    timeout=120))
                most = max(most, len(servicing()))
            replies = [f.result(timeout=120) for f in futs]
            wall = time.perf_counter() - t0
            for i, got in enumerate(replies):
                _bit_equal(f"pump (b) call {i}", got, first[i % len(images)])
            check(most == 1, f"pump (b): {most} servicing threads while "
                  f"calls were in flight, want 1")
            drained = time.monotonic()
            while servicing() and time.monotonic() - drained < PUMP_LINGER_S:
                time.sleep(0.005)
            left = len(servicing())
            check(left == 0, f"pump (b): {left} servicing threads "
                  f"{PUMP_LINGER_S} s after the window drained")
            pipe.close()
        finally:
            ch.close()
    finally:
        rig.server.stop()
    print(f"pump (b): {n} pipelined calls at depth {PUMP_PIPE_DEPTH} on one "
          f"pump-mode connection in {wall:.3f} s ({n / wall:.3f} calls/s), "
          f"every reply bit-equal to phase 3's, one servicing thread while "
          f"in flight, none {PUMP_LINGER_S} s after ({card})", flush=True)
    return {"wall_s": wall}


def _pump_sink(dev, card, want, rounds, ring) -> dict:
    """Phase 17 (c): phase 15 (a)'s device-ring leg (the descriptor ring
    on), the pump on and off in PUMP_SINK_PATTERN's turns."""
    n = len(want[0])
    leaves = (8, want[0][0].nbytes)
    got = {"auto": [], "0": []}
    for turn, mode in enumerate(PUMP_SINK_PATTERN):
        label = f"pump (c) turn {turn}, TPURPC_INLINE_PUMP={mode}"
        recs, _ = sink_leg(label, dev, card, want,
                           {"GRPC_PLATFORM_TYPE": "TPU",
                            "TPURPC_HBM_RING_SIZE_KB": str(ring >> 10),
                            "TPURPC_CTRL_RING": "1",
                            "TPURPC_INLINE_PUMP": mode},
                           device_ring=True, rounds=rounds)
        _set_env({"TPURPC_INLINE_PUMP": None, "TPURPC_CTRL_RING": None})
        for r, rec in enumerate(recs):
            cl = rec["link"]
            check(cl["sent"] == n and cl["fallbacks"] == 0
                  and cl["ctrl_frames"] == 0,
                  f"{label} round {r}: not every payload rode rendezvous "
                  f"with its control ops on the ring: {cl}")
            tails = rec["ring_tails"]
            check(len(tails) == 1
                  and tails[0][1] - tails[0][0] == n * sum(leaves),
                  f"{label} round {r}: the server's rings advanced {tails}")
            want_l = _landing_launches(*tails[0], leaves, ring)
            check(rec["launches"] == want_l and min(want_l.values()) >= 1,
                  f"{label} round {r}: launched {rec['launches']}, the "
                  f"landings give {want_l}")
        got[mode].append(recs)
    out = {}
    for mode, turns in got.items():
        out[mode] = _ctrl_summary(turns)
        out[mode]["launches"] = [rec["launches"] for recs in turns
                                 for rec in recs]
    ratio = out["auto"]["gbps_median"] / out["0"]["gbps_median"]
    print(f"pump (c): phase 15 (a)'s device-ring leg, GB/s median (q1, q3) "
          f"after each turn's first round: pump on "
          f"{out['auto']['gbps_median']} ({out['auto']['gbps_q1']}, "
          f"{out['auto']['gbps_q3']}), off {out['0']['gbps_median']} "
          f"({out['0']['gbps_q1']}, {out['0']['gbps_q3']}); on/off {ratio} "
          f"({card})", flush=True)
    return out


def _pump_idle(dev, card, classify, images, first) -> dict:
    """Phase 17 (d): an idle pump-mode connection reads the server's
    GOAWAY through the backup pump, keepalive keeps a healthy one, and
    ``ping`` pumps."""
    import numpy as np

    from tpurpc_torch.torchshim.service import TensorClient

    res = {}
    _set_env({"TPURPC_MAX_CONNECTION_AGE_MS": str(PUMP_AGE_MS)})
    rig = CallPlaneServer(classify)
    try:
        ch = _dial_in_mode(rig.port, "auto")
        try:
            got = _lc_call("pump (d) max age", TensorClient(ch), images[0])
            _bit_equal("pump (d) max age", got, first[0])
            conn = ch._conn
            _pump_mode_of("pump (d) max age", conn, True)
            sconn = _conn_of(rig.server, ch)
            sent = {}
            goaway = sconn.goaway

            def timed_goaway(why):
                sent.setdefault("t", time.monotonic())
                return goaway(why)

            sconn.goaway = timed_goaway
            _await(lambda: not conn.alive, PUMP_AGE_MS / 1e3 + 10,
                   "pump (d): the idle connection's death")
            dead = time.monotonic()
            check("t" in sent, "pump (d): the server sent no GOAWAY")
            res["goaway_read_s"] = dead - sent["t"]
            check(conn.draining and res["goaway_read_s"] < PUMP_GOAWAY_S,
                  f"pump (d): the idle connection died "
                  f"{res['goaway_read_s']} s after the GOAWAY (draining "
                  f"{conn.draining}), want it read within {PUMP_GOAWAY_S} s")
        finally:
            ch.close()
    finally:
        rig.server.stop()
        _set_env({"TPURPC_MAX_CONNECTION_AGE_MS": None})

    _set_env({"TPURPC_KEEPALIVE_TIME_MS": str(PUMP_KA_TIME_MS),
              "TPURPC_KEEPALIVE_TIMEOUT_MS": str(PUMP_KA_TIMEOUT_MS)})
    rig = CallPlaneServer(classify)
    try:
        ch = _dial_in_mode(rig.port, "auto")
        try:
            client = TensorClient(ch)
            _lc_call("pump (d) keepalive", client, images[0])
            conn = ch._conn
            before = conn.pong_count
            time.sleep(PUMP_KA_IDLE_S)
            pongs = conn.pong_count - before
            check(ch._conn is conn and conn.alive and pongs >= 2,
                  f"pump (d): keepalive over {PUMP_KA_IDLE_S} s idle: same "
                  f"connection {ch._conn is conn}, alive {conn.alive}, "
                  f"{pongs} PONGs (want at least 2)")
            got = _lc_call("pump (d) keepalive after idle", client,
                           images[0])
            _bit_equal("pump (d) keepalive after idle", got, first[0])
            res["ka_pongs"] = pongs
            rtts = [ch.ping(timeout=5) * 1e3 for _ in range(PUMP_PINGS)]
            res["ping_p50_ms"] = float(np.percentile(rtts, 50))
            res["ping_p99_ms"] = float(np.percentile(rtts, 99))
        finally:
            ch.close()
    finally:
        rig.server.stop()
        _set_env({"TPURPC_KEEPALIVE_TIME_MS": None,
                  "TPURPC_KEEPALIVE_TIMEOUT_MS": None})
    print(f"pump (d): an idle pump-mode connection read the server's GOAWAY "
          f"{res['goaway_read_s']:.4f} s after it left (bound "
          f"{PUMP_GOAWAY_S} s); keepalive {PUMP_KA_TIME_MS}/"
          f"{PUMP_KA_TIMEOUT_MS} ms kept an idle connection "
          f"{PUMP_KA_IDLE_S} s with {res['ka_pongs']} PONGs; {PUMP_PINGS} "
          f"pings p50 {res['ping_p50_ms']:.4f} ms p99 "
          f"{res['ping_p99_ms']:.4f} ms ({card})", flush=True)
    return res


def _pump_threads(dev, card, classify, images, first, threads,
                  per_thread) -> dict:
    """Phase 17 (e): ``threads`` threads make ``per_thread`` calls each on
    one pump-mode device-ring connection."""
    import numpy as np

    from tpurpc_torch.torchshim.service import TensorClient

    rig = CallPlaneServer(classify)
    errors, lat = [], []
    lock = threading.Lock()
    try:
        ch = _dial_in_mode(rig.port, "auto")
        try:
            conn = ch._conn
            client = TensorClient(ch)

            def worker(t):
                import torch

                for i in range(per_thread):
                    k = (t + i) % len(images)
                    try:
                        t0 = time.perf_counter()
                        got = client.call(
                            "Classify",
                            {"images": torch.from_numpy(images[k])},
                            timeout=120)
                        ms = (time.perf_counter() - t0) * 1e3
                        ok = all(torch.equal(got[n], first[k][n])
                                 for n in ("logits", "top1"))
                        with lock:
                            lat.append(ms)
                            if not ok:
                                errors.append(f"thread {t} call {i}: not "
                                              f"bit-equal")
                    except Exception as exc:
                        with lock:
                            errors.append(f"thread {t} call {i}: {exc!r}")

            ts = [threading.Thread(target=worker, args=(t,))
                  for t in range(threads)]
            t0 = time.perf_counter()
            for t in ts:
                t.start()
            for t in ts:
                t.join(300)
            wall = time.perf_counter() - t0
            check(not any(t.is_alive() for t in ts),
                  "pump (e): a caller thread never finished")
            check(not errors, f"pump (e): {errors[:4]}")
            check(ch._conn is conn, "pump (e): the connection was redialed")
            _pump_mode_of("pump (e)", conn, True)
        finally:
            ch.close()
    finally:
        rig.server.stop()
    n = threads * per_thread
    print(f"pump (e): {threads} threads x {per_thread} calls on one "
          f"pump-mode connection: every reply bit-equal, none past its "
          f"deadline, {n / wall:.3f} calls/s, p50 "
          f"{float(np.percentile(lat, 50)):.3f} ms p99 "
          f"{float(np.percentile(lat, 99)):.3f} ms ({card})", flush=True)
    return {"calls_per_s": n / wall}


def pump_profile(dev, card, turns: int) -> dict:
    """Phase 17 (a) alone in ``turns`` turns of PUMP_SINK_PATTERN's order
    (on, off, off, on, ...), after phase 3, with its checks. Returns the
    summary: the median p50 and p99 of each mode and the turn pairs the
    pump won."""
    saved = {k: os.environ.get(k) for k in PUMP_ENV}
    _set_env({"GRPC_PLATFORM_TYPE": "TPU", "TPURPC_TORCH_DEVICE": str(dev),
              "TPURPC_HBM_RING_SIZE_KB": str(RING >> 10),
              "TPURPC_INLINE_PUMP": None})
    infer = _PHASE3["infer"]

    def classify(tree):
        logits = infer(tree["images"].to(dev))
        return {"logits": logits, "top1": logits.argmax(dim=1)}

    try:
        res = _pump_turns(dev, card, classify, _PHASE3["images"],
                          _PHASE3["replies"], PUMP_CALLS,
                          pattern=tuple(PUMP_SINK_PATTERN[i % 4]
                                        for i in range(turns)))
    finally:
        _set_env(saved)
    return {mode: {k: res[mode][k] for k in ("p50_median", "p99_median")}
            for mode in ("auto", "0")} | {"pairs": res["pairs"],
                                         "pump_won": res["pump_won"]}


def pump_plane(dev, card, size=SIZE, ring=RING, requests=REQUESTS,
               calls=PUMP_CALLS, pipe_calls=PUMP_PIPE_CALLS,
               sink_rounds=CTRL_ROUNDS, want=None, threads=PUMP_THREADS,
               per_thread=PUMP_THREAD_CALLS) -> dict:
    """Phase 17: the inline pump (docstring of this file). Returns each
    part's launches, each checked against what its landings' ring offsets
    give."""
    import numpy as np
    import torch

    from tpurpc_torch.models.resnet import make_infer_fn, resnet50
    from tpurpc_torch.ops import ring_scatter as rs_mod
    from tpurpc_torch.ops import ring_window as rw_mod

    t_phase = time.perf_counter()
    saved = {k: os.environ.get(k) for k in PUMP_ENV}
    _set_env({"GRPC_PLATFORM_TYPE": "TPU", "TPURPC_TORCH_DEVICE": str(dev),
              "TPURPC_HBM_RING_SIZE_KB": str(ring >> 10),
              "TPURPC_INLINE_PUMP": None})
    res = {}
    try:
        if _PHASE3 and size == SIZE:
            infer, images = _PHASE3["infer"], _PHASE3["images"]
        else:   # a rehearsal without phase 3: the same seeds
            torch.manual_seed(SEED)
            infer = make_infer_fn(resnet50().to(dev))
            rng = np.random.default_rng(SEED)
            images = [rng.standard_normal((BATCH, size, size, 3)).astype(
                np.float32) for _ in range(requests)]

        def classify(tree):
            logits = infer(tree["images"].to(dev))
            return {"logits": logits, "top1": logits.argmax(dim=1)}

        first = (_PHASE3.get("replies") if _PHASE3 and size == SIZE
                 else None)
        res["first_from_phase3"] = first is not None

        def part(name, fn, *args):
            """One part, the wrappers' counts set to 0 just before it; its
            launches must be what its landings' ring offsets give."""
            t = time.perf_counter()
            with _Landings() as land:
                rs_mod.launches = rw_mod.launches = 0
                out = fn(*args)
                got = {"ring_scatter": rs_mod.launches,
                       "ring_window": rw_mod.launches}
            want_l = land.launches()
            check(got == want_l, f"pump ({name}): launched {got}, the "
                  f"{len(land.recs)} landings' ring offsets give {want_l}")
            out["launches"] = got
            print(f"pump: ({name}) took {time.perf_counter() - t} s",
                  flush=True)
            return out

        if first is None:   # rehearsal: a reader-mode run sets the replies
            from tpurpc_torch.torchshim.service import TensorClient

            rig = CallPlaneServer(classify)
            try:
                ch = _dial_in_mode(rig.port, "0")
                try:
                    client = TensorClient(ch)
                    first = [_lc_call(f"pump reference reply {i}", client, x)
                             for i, x in enumerate(images)]
                finally:
                    ch.close()
            finally:
                rig.server.stop()
        # (a) and (c) check each turn's launches themselves
        res["a"] = _pump_turns(dev, card, classify, images, first, calls)
        res["b"] = part("b", _pump_pipeline, dev, card, classify, images,
                        first, pipe_calls)
        res["c"] = _pump_sink(dev, card, want or sink_payloads(),
                              sink_rounds, ring)
        res["d"] = part("d", _pump_idle, dev, card, classify, images, first)
        res["e"] = part("e", _pump_threads, dev, card, classify, images,
                        first, threads, per_thread)
    finally:
        _set_env(saved)
    total = {k: sum(res[p]["launches"][k] for p in "bde")
             + sum(r[k] for p in "ac" for m in ("auto", "0")
                   for r in res[p][m]["launches"])
             for k in ("ring_scatter", "ring_window")}
    check(min(total.values()) >= 1, f"pump: phase 17 launched {total}")
    print(f"pump: phase 17 took {time.perf_counter() - t_phase} s, "
          f"launches {total} ({card})", flush=True)
    return res


# -- phase 18 ----------------------------------------------------------------

#: phase 18 (a): pipelined calls across the drain of one of two servers
OBS_CALLS, OBS_DEPTH, OBS_DRAIN_AFTER = 32, 4, 8
#: (a): how long the drained server's GOAWAY may wait for the first refused
#: call to replay
OBS_GOAWAY_HOLD_S = 2.0
#: (c): alternating turns of the plane at its defaults and switched off
OBS_TURNS, OBS_TURN_CALLS = 20, 16
OBS_ENV = PUMP_ENV + ("TPURPC_TRACE_SAMPLE",)
OBS_METHOD = "/tpurpc.Tensor/Classify"


class _CountedStarts:
    """Counts the attempts of every unary call while on: both a call's
    first attempt and each of its replays open their stream through
    ``_MultiCallable._start``."""

    def __enter__(self):
        from tpurpc_torch.rpc import channel as chmod

        self._cls = chmod._MultiCallable
        self._orig = self._cls._start
        self.n = 0
        lock, orig, me = threading.Lock(), self._orig, self

        def counted(mc, *a, **kw):
            with lock:
                me.n += 1
            return orig(mc, *a, **kw)

        self._cls._start = counted
        return self

    def __exit__(self, *exc):
        self._cls._start = self._orig


def pipelined_drain(classify, images, first, calls, drain_after, depth,
                    hold_s=OBS_GOAWAY_HOLD_S, label="obs (a)") -> dict:
    """Two device-ring servers behind one ``round_robin`` channel, a
    ``PipelinedUnary`` of ``depth`` and ``calls`` calls; server A drains
    once reply ``drain_after`` has arrived. A's GOAWAY waits (at most
    ``hold_s``) until a refused call has replayed, so the drain meets calls
    already sent to A: the race any drain or max-age GOAWAY meets. Every
    reply must be bit-equal to ``first``'s of the same request, no call may
    fail, and A must admit nothing once its drain has finished. Returns the
    replays, the servers' measured launches, what their rings' offsets give,
    and the flight events the part left."""
    import torch

    from tpurpc_torch.obs import flight
    from tpurpc_torch.rpc.channel import Channel
    from tpurpc_torch.torchshim.service import TensorClient

    rigs = [CallPlaneServer(classify), CallPlaneServer(classify)]
    target = "ipv4:" + ",".join(f"127.0.0.1:{r.port}" for r in rigs)
    t_ns = time.monotonic_ns()
    issued, drained, seen_at = [0], [], []
    span = images[0].nbytes
    try:
        with Channel(target, lb_policy="round_robin") as ch, \
                _CountedStarts() as starts:
            for sc in ch._subchannels:
                sc.get()
            _await(lambda: all(len(r.server._connections) == 1
                               for r in rigs), 10, f"{label}: connections")
            rings = [r.ring() for r in rigs]
            conn_a = rigs[0].server._connections[0]
            goaway = conn_a.goaway

            def held_goaway(*a, **kw):
                deadline = time.monotonic() + hold_s
                while (starts.n - issued[0] < 1
                       and time.monotonic() < deadline):
                    time.sleep(0.001)
                return goaway(*a, **kw)

            conn_a.goaway = held_goaway

            def drain():
                drained.append(rigs[0].server.drain(linger=30.0))
                seen_at.append(len(rigs[0].seen))

            pipe = TensorClient(ch).pipeline("Classify", depth=depth)
            futs, drainer = [], threading.Thread(target=drain)
            for i in range(calls):
                issued[0] += 1
                futs.append(pipe.call_async(
                    {"images": torch.from_numpy(images[i % len(images)])},
                    timeout=120))
                if i + 1 == drain_after:
                    futs[drain_after - 1].add_done_callback(
                        lambda _f: drainer.start())
            replies = []
            for i, f in enumerate(futs):
                try:
                    replies.append(f.result(timeout=120))
                except Exception as exc:
                    fail(f"{label}: pipelined call {i} failed: {exc!r}")
            drainer.join(60)
            pipe.close()
            replays = starts.n - calls
        check(drained == [True], f"{label}: drain {drained}")
        stats = [ring.stats() for ring in rings]
    finally:
        for r in rigs:
            r.server.stop()
    for i, got in enumerate(replies):
        _bit_equal(f"{label} call {i}", got, first[i % len(images)])
    served = [len(r.done) for r in rigs]
    check(sum(served) == calls, f"{label}: servers ran {served} handlers "
          f"for {calls} calls")
    check(len(rigs[0].seen) == seen_at[0], f"{label}: A admitted "
          f"{len(rigs[0].seen) - seen_at[0]} calls after its drain")
    check(replays >= 1, f"{label}: no call replayed across the drain")
    want = [_ring_wraps(st["tail"], span, st["capacity"]) for st in stats]
    for k, (rig, w, st) in enumerate(zip(rigs, want, stats)):
        check(rig.launched == {"ring_scatter": w, "ring_window": w},
              f"{label}: server {'AB'[k]} launched {rig.launched}, its "
              f"ring's {st['tail'] // span} landings wrap {w} times")
        check(st["live_spans"] == 0, f"{label}: server {'AB'[k]}'s ring "
              f"holds live spans: {st}")
    events = flight.snapshot(since_ns=t_ns)
    return {"replays": replays, "served": served,
            "admitted_after_drain": len(rigs[0].seen) - seen_at[0],
            "launched": [dict(r.launched) for r in rigs], "wraps": want,
            "events": events, "servers": rigs}


def _obs_switch(on: bool) -> None:
    """(c): the obs plane at its defaults (``on``), or every switch off:
    the stall watchdog, tail capture, the lens sampler and profile spans
    (the variables ``TPURPC_WATCHDOG``, ``TPURPC_TRACE_TAIL``,
    ``TPURPC_LENS``, ``TPURPC_PROFILING``, set on the live modules)."""
    from tpurpc_torch.obs import profiler, tracing, watchdog
    from tpurpc_torch.utils import stats

    watchdog.get().enabled = on
    tracing.tail(None if on else False)
    stats.enable(None if on else False)
    if on:
        profiler.ensure_started()
    else:
        profiler.stop()


def _obs_cost(dev, card, classify, images, first, turns, per_turn,
              label="obs (c)") -> dict:
    """(c): phase 3's device-ring unary path in alternating turns, the obs
    plane at its defaults and switched off; a fresh channel each turn.
    ``label`` names the part in what it prints."""
    import numpy as np
    import torch

    from tpurpc_torch.obs import profiler
    from tpurpc_torch.ops import ring_scatter as rs_mod
    from tpurpc_torch.ops import ring_window as rw_mod
    from tpurpc_torch.rpc.channel import Channel
    from tpurpc_torch.torchshim.service import TensorClient

    rig = CallPlaneServer(classify)
    sides = {"on": [], "off": []}
    turn_p50 = {"on": [], "off": []}
    launches = {"on": {"ring_scatter": 0, "ring_window": 0},
                "off": {"ring_scatter": 0, "ring_window": 0}}
    profiler.get().reset()
    try:
        for t in range(turns):
            side = "on" if t % 2 == 0 else "off"
            _obs_switch(side == "on")
            with Channel(f"127.0.0.1:{rig.port}") as ch:
                client = TensorClient(ch)
                lat = []
                with _Landings() as land:
                    rs_mod.launches = rw_mod.launches = 0
                    for i in range(per_turn):
                        x = images[i % len(images)]
                        t0 = time.perf_counter()
                        got = _lc_call(f"{label} turn {t} call {i}", client,
                                       x)
                        lat.append((time.perf_counter() - t0) * 1e3)
                        _bit_equal(f"{label} turn {t} call {i}", got,
                                   first[i % len(images)])
                    got_l = {"ring_scatter": rs_mod.launches,
                             "ring_window": rw_mod.launches}
                check(got_l == land.launches(), f"{label} turn {t}: "
                      f"launched {got_l}, its landings give "
                      f"{land.launches()}")
                for k in got_l:
                    launches[side][k] += got_l[k]
            sides[side] += lat
            turn_p50[side].append(float(np.percentile(lat, 50)))
            print(f"{label} turn {t} ({side}): p50 {turn_p50[side][-1]} ms "
                  f"p99 {float(np.percentile(lat, 99))} ms", flush=True)
        prof = profiler.get().snapshot()
    finally:
        _obs_switch(True)
        profiler.stop()
        rig.server.stop()
    won = sum(1 for a, b in zip(turn_p50["on"], turn_p50["off"]) if a < b)
    out = {"p50_on": float(np.percentile(sides["on"], 50)),
           "p50_off": float(np.percentile(sides["off"], 50)),
           "turn_p50_on": turn_p50["on"], "turn_p50_off": turn_p50["off"],
           "pairs_won_by_on": won, "pairs": min(len(turn_p50["on"]),
                                                len(turn_p50["off"])),
           "dispatch_pct": prof["stage_pct"].get("dispatch", 0.0),
           "stage_pct": prof["stage_pct"],
           "attributed_pct": prof["attributed_pct"],
           "samples": prof["samples"], "launches": launches}
    print(f"{label}: {turns} alternating turns of {per_turn} device-ring "
          f"calls: p50 with the obs plane at its defaults {out['p50_on']} "
          f"ms, with every switch off {out['p50_off']} ms; turn pairs where "
          f"the defaults were faster {won} of {out['pairs']}; the "
          f"profiler's dispatch stage {out['dispatch_pct']} % of "
          f"{prof['samples']} attributed thread samples in the defaults' "
          f"turns (stage shares {prof['stage_pct']}, attributed "
          f"{prof['attributed_pct']} %); launches {launches} ({card})",
          flush=True)
    return out


def obs_plane(dev, card, size=SIZE, ring=RING, requests=REQUESTS,
              calls=OBS_CALLS, drain_after=OBS_DRAIN_AFTER, depth=OBS_DEPTH,
              turns=OBS_TURNS, per_turn=OBS_TURN_CALLS) -> dict:
    """Phase 18: the pipelined drain migration and the obs plane (docstring
    of this file). Returns each part's launches."""
    import numpy as np
    import torch

    from tpurpc_torch.models.resnet import make_infer_fn, resnet50
    from tpurpc_torch.obs import flight, metrics, tracing, watchdog
    from tpurpc_torch.ops import ring_scatter as rs_mod
    from tpurpc_torch.ops import ring_window as rw_mod
    from tpurpc_torch.torchshim.service import TensorClient
    from tpurpc_torch.rpc.channel import Channel

    t_phase = time.perf_counter()
    saved = {k: os.environ.get(k) for k in OBS_ENV}
    _set_env({"GRPC_PLATFORM_TYPE": "TPU", "TPURPC_TORCH_DEVICE": str(dev),
              "TPURPC_HBM_RING_SIZE_KB": str(ring >> 10),
              "TPURPC_INLINE_PUMP": None, "TPURPC_TRACE_SAMPLE": None})
    res = {}
    try:
        if _PHASE3 and size == SIZE:
            infer, images = _PHASE3["infer"], _PHASE3["images"]
        else:   # a rehearsal without phase 3: the same seeds
            torch.manual_seed(SEED)
            infer = make_infer_fn(resnet50().to(dev))
            rng = np.random.default_rng(SEED)
            images = [rng.standard_normal((BATCH, size, size, 3)).astype(
                np.float32) for _ in range(requests)]

        def classify(tree):
            logits = infer(tree["images"].to(dev))
            return {"logits": logits, "top1": logits.argmax(dim=1)}

        first = (_PHASE3.get("replies") if _PHASE3 and size == SIZE
                 else None)
        if first is None:   # rehearsal: sequential calls set the replies
            rig = CallPlaneServer(classify)
            try:
                with Channel(f"127.0.0.1:{rig.port}") as ch:
                    client = TensorClient(ch)
                    first = [_lc_call(f"obs reference reply {i}", client, x)
                             for i, x in enumerate(images)]
            finally:
                rig.server.stop()
        wd = watchdog.get()
        trips = metrics.counter("watchdog_trips")
        call_us = metrics.histogram("pipeline_call_us", kind="latency")
        calls_fam = metrics.labeled_counter("srv_calls", ("method", "code"))
        trips0, n0 = trips.snapshot(), call_us.snapshot()["count"]
        ok0 = calls_fam.snapshot().get((OBS_METHOD, "0"), 0)

        # (a) the pipelined drain migration
        t = time.perf_counter()
        rs_mod.launches = rw_mod.launches = 0
        a = pipelined_drain(classify, images, first, calls, drain_after,
                            depth)
        res["a"] = {"ring_scatter": rs_mod.launches,
                    "ring_window": rw_mod.launches,
                    "per_server": a["launched"]}
        total = {k: sum(p[k] for p in a["launched"])
                 for k in ("ring_scatter", "ring_window")}
        check(total == {k: res["a"][k] for k in total}, f"obs (a): the "
              f"servers' launches {a['launched']} do not add up to the "
              f"part's {res['a']}")
        check(min(total.values()) >= 1, f"obs (a): launched {total}")
        print(f"obs (a): {calls} pipelined calls (depth {depth}), "
              f"round_robin over two device-ring servers, A drained after "
              f"reply {drain_after} (its GOAWAY held until a refused call "
              f"replayed): none failed, every reply bit-equal to phase 3's; "
              f"replays at the client {a['replays']}; served A/B "
              f"{a['served']}, A admitted {a['admitted_after_drain']} after "
              f"its drain; launches {res['a']} (the rings' offsets give "
              f"{a['wraps']} each); took {time.perf_counter() - t} s "
              f"({card})", flush=True)

        # (b) what the obs plane read of (a), then a sampled unary call
        rigs = a.pop("servers")
        ev = a.pop("events")
        names = [e["event"] for e in ev]
        drain_edges = [e["event"] for e in ev if e["entity"] == "srv-drain"]
        conns = sorted({e["entity"] for e in ev
                        if e["event"] == "conn-connect"})
        n_calls = call_us.snapshot()["count"] - n0
        ok_calls = calls_fam.snapshot().get((OBS_METHOD, "0"), 0) - ok0
        n_trips = trips.snapshot() - trips0
        p99 = wd.rolling_p99_ns()
        reports = [r.server._load_md() for r in rigs]
        check(n_calls == calls, f"obs (b): pipeline_call_us counted "
              f"{n_calls} of {calls} calls")
        check(ok_calls == sum(a["served"]), f"obs (b): srv_calls"
              f"{{{OBS_METHOD},0}} counted {ok_calls}, the servers ran "
              f"{a['served']}")
        check(drain_edges == ["drain-begin", "drain-end"], f"obs (b): the "
              f"drain's flight edges {drain_edges}")
        check(len(conns) >= 2 and "call-first-ok" in names,
              f"obs (b): conn-connect for {conns}; events {sorted(set(names))}")
        check(n_trips == 0, f"obs (b): the watchdog tripped {n_trips} times")
        check(p99 is not None and p99 > 0, f"obs (b): rolling p99 {p99}")
        p99s = [float(md[0][1].split(",")[2]) for md in reports if md]
        check(len(p99s) == 2 and min(p99s) > 0, f"obs (b): load report "
              f"p99s {reports}")
        rs_mod.launches = rw_mod.launches = 0
        os.environ["TPURPC_TRACE_SAMPLE"] = "1"
        tracing.configure()
        rig = CallPlaneServer(classify)
        try:
            with Channel(f"127.0.0.1:{rig.port}") as ch:
                got = _lc_call("obs (b) sampled call", TensorClient(ch),
                               images[0])
        finally:
            rig.server.stop()
            os.environ.pop("TPURPC_TRACE_SAMPLE", None)
            tracing.configure()
        _bit_equal("obs (b) sampled call", got, first[0])
        res["b"] = {"ring_scatter": rs_mod.launches,
                    "ring_window": rw_mod.launches}
        check(res["b"] == {"ring_scatter": 0, "ring_window": 0},
              f"obs (b): one landing at offset 0 launched {res['b']}")
        tree = None
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            by = {}
            for sp in tracing.spans():
                by.setdefault(sp["trace_id"], {})[sp["name"]] = sp
            full = [d for d in by.values()
                    if {"client-send", "wire", "dispatch", "respond"} <= set(d)]
            if full:
                tree = full[-1]
                break
            time.sleep(0.01)
        check(tree is not None, "obs (b): no sampled span tree")
        order = ["client-send", "wire", "dispatch", "respond"]
        t0s = [tree[k]["t0_ns"] for k in order]
        wire = tree["wire"]
        inside = all(wire["t0_ns"] <= tree[k]["t0_ns"]
                     and tree[k]["t0_ns"] + tree[k]["dur_ns"]
                     <= wire["t0_ns"] + wire["dur_ns"]
                     for k in ("dispatch", "respond"))
        check(t0s == sorted(t0s) and inside, f"obs (b): spans out of order "
              f"{ {k: (tree[k]['t0_ns'], tree[k]['dur_ns']) for k in order} }")
        res["b_obs"] = {"pipeline_call_us": n_calls, "srv_calls_ok": ok_calls,
                        "watchdog_trips": n_trips, "p99_ms": p99 / 1e6,
                        "report_p99_ms": p99s, "conns": conns}
        print(f"obs (b): pipeline_call_us counted {n_calls} calls, "
              f"srv_calls{{{OBS_METHOD},0}} {ok_calls} (A/B ran "
              f"{a['served']}); flight: drain {drain_edges}, conn-connect "
              f"{conns}; watchdog trips {n_trips}; rolling p99 "
              f"{p99 / 1e6} ms, load reports' p99 {p99s}; a sampled "
              f"device-ring call's spans in order {order} (ms "
              f"{[tree[k]['dur_ns'] / 1e6 for k in order]}), dispatch and "
              f"respond inside wire; its launches {res['b']} ({card})",
              flush=True)

        # (c) what the plane costs phase 3's device-ring unary path
        res["c"] = _obs_cost(dev, card, classify, images, first, turns,
                             per_turn)
    finally:
        os.environ.pop("TPURPC_TRACE_SAMPLE", None)
        _set_env(saved)
        tracing.configure()
        watchdog.get().stop()
    res["replays"] = a["replays"]
    print(f"obs: phase 18 took {time.perf_counter() - t_phase} s ({card})",
          flush=True)
    return res


# -- phase 19 ----------------------------------------------------------------

#: (a): phase 3's device-ring unary calls under the sampling profiler
HOOK_CALLS = 64
#: the profiler stages the transport's hooks brought (the call plane's
#: ``dispatch`` came before them)
NEW_STAGES = ("ring-read", "ring-write", "pair-send", "poller-wait",
              "ctrl-ring", "rendezvous", "codec", "hbm-place",
              "device-dispatch", "batcher", "h2-framing", "wire")
#: (b): messages of phase 5's device-ring stream, after its warm-up
HOOK_STREAM_MSGS = 16
#: (d): alternating turns, calls a turn
HOOK_TURNS, HOOK_TURN_CALLS = 20, 8
#: (e): calls over one H2Channel
HOOK_H2_CALLS = 16
HOOK_METHOD = "/obs19.S/Echo"


class _HookCounts:
    """While on, counts the obs plane's per-event work in this process:
    flight emits, counter adds and histogram records (labelled counters'
    children are counters)."""

    def __enter__(self):
        from tpurpc_torch.obs import flight, metrics

        self.n = {"flight_emits": 0, "counter_adds": 0, "hist_records": 0}
        n, lock = self.n, threading.Lock()
        self._saved = [(flight, "emit", flight.emit),
                       (metrics.Counter, "inc", metrics.Counter.inc),
                       (metrics.Histogram, "record",
                        metrics.Histogram.record)]

        def counted(key, fn):
            def wrapper(*a, **kw):
                with lock:
                    n[key] += 1
                return fn(*a, **kw)
            return wrapper

        flight.emit = counted("flight_emits", flight.emit)
        metrics.Counter.inc = counted("counter_adds", metrics.Counter.inc)
        metrics.Histogram.record = counted("hist_records",
                                           metrics.Histogram.record)
        return self

    def __exit__(self, *exc):
        for obj, name, fn in self._saved:
            setattr(obj, name, fn)


def _hooks_profile(card, classify, images, first, calls) -> dict:
    """(a): ``calls`` device-ring unary calls of phase 3's request under the
    stage profiler at its default rate; each stage's share of the
    attributed samples, then the idle, unattributed and unmarked shares."""
    from tpurpc_torch.obs import profiler
    from tpurpc_torch.rpc.channel import Channel
    from tpurpc_torch.torchshim.service import TensorClient

    rig = CallPlaneServer(classify)
    prof = profiler.get()
    try:
        with Channel(f"127.0.0.1:{rig.port}") as ch:
            client = TensorClient(ch)
            _bit_equal("hooks (a) warm-up", _lc_call(
                "hooks (a) warm-up", client, images[0]), first[0])
            prof.stop()
            prof.reset()
            check(profiler.ensure_started(), "hooks (a): the lens is off")
            with _Landings() as land:
                t0 = time.perf_counter()
                for i in range(calls):
                    got = _lc_call(f"hooks (a) call {i}", client,
                                   images[i % len(images)])
                    _bit_equal(f"hooks (a) call {i}", got,
                               first[i % len(images)])
                wall = time.perf_counter() - t0
            profiler.stop()
            snap = prof.snapshot()
    finally:
        profiler.stop()
        rig.server.stop()
    stages = snap["stages"]
    other = stages.get("other", 0)
    denom = snap["samples"] - other
    idle = stages.get("idle", 0)
    unatt = stages.get("unattributed", 0)
    attributed = denom - unatt
    work = {k: v for k, v in stages.items()
            if k not in ("other", "idle", "unattributed")}
    share = {k: (100.0 * v / attributed if attributed else 0.0)
             for k, v in sorted(work.items(), key=lambda kv: -kv[1])}
    per_call_ms = {k: 1e3 * v / snap["hz"] / calls for k, v in work.items()}
    new = sum(work.get(k, 0) for k in NEW_STAGES)
    check(new > 0, f"hooks (a): the transport's stages drew no sample: "
          f"{stages}")
    out = {"calls": calls, "wall_ms_per_call": 1e3 * wall / calls,
           "hz": snap["hz"], "samples": snap["samples"], "stages": stages,
           "share_of_attributed_pct": share,
           "thread_ms_per_call": per_call_ms,
           "idle_pct": 100.0 * idle / denom if denom else 0.0,
           "unattributed_pct": 100.0 * unatt / denom if denom else 0.0,
           "other_samples": other, "new_stage_samples": new,
           "launches": land.launches(), "launched": dict(rig.launched)}
    check(rig.launched == land.launches(), f"hooks (a): launched "
          f"{rig.launched}, the landings give {land.launches()}")
    print(f"hooks (a): {calls} device-ring calls of phase 3's request, "
          f"{out['wall_ms_per_call']} ms each by host clock, profiled at "
          f"{snap['hz']} Hz ({snap['samples']} thread samples): share of "
          f"the attributed samples by stage {share} %; thread ms per call "
          f"by stage {per_call_ms}; of this package's samples idle "
          f"{out['idle_pct']} %, unattributed {out['unattributed_pct']} %; "
          f"samples outside the package {other}; the transport's stages "
          f"drew {new}; launches {rig.launched} ({card})", flush=True)
    return out


def _hooks_waterfall(dev, card, ring, msgs) -> dict:
    """(b): phase 5's device-ring stream, one round of ``msgs`` after its
    warm-up: each hop's bytes, busy time and GB/s, and the landings the
    ``hbm`` hop and ``hbm_place_*`` must equal."""
    from tpurpc_torch.obs import lens, metrics
    from tpurpc_torch.ops import ring_scatter as rs_mod
    from tpurpc_torch.ops import ring_window as rw_mod

    want = sink_payloads(msgs=msgs)
    hops = {h: lens.hop_counters(h) for h in lens.HOP_NAMES}
    before = {h: tuple(c.snapshot() for c in cs) for h, cs in hops.items()}
    places = metrics.counter("hbm_place_msgs")
    pbytes = metrics.counter("hbm_place_bytes")
    m0, b0 = places.snapshot(), pbytes.snapshot()
    rs0, rw0 = rs_mod.launches, rw_mod.launches
    saved = {k: os.environ.get(k) for k in SINK_ENV}
    try:
        with _Landings() as land:
            recs, _ = sink_leg("hooks (b) device-ring stream", dev, card,
                                  want, {"GRPC_PLATFORM_TYPE": "TPU",
                                         "TPURPC_HBM_RING_SIZE_KB":
                                         str(ring >> 10)},
                                  device_ring=True, rounds=1)
    finally:
        _set_env(saved)
    launched = {"ring_scatter": rs_mod.launches - rs0,
                "ring_window": rw_mod.launches - rw0}
    rows = {}
    for h, cs in hops.items():
        b, ns, cp = (c.snapshot() - x for c, x in zip(cs, before[h]))
        rows[h] = {"bytes": b, "busy_ms": ns / 1e6, "copy_bytes": cp,
                   "gbps": b / ns if ns else 0.0}
    n_msgs = SINK_WARM + msgs
    leaves = [len(r[3]) for r in land.recs]
    landed = sum(sum(r[3]) for r in land.recs)
    payload = n_msgs * (want[0][0].nbytes + 8)   # x and the int64 index
    got = {"hbm_place_msgs": places.snapshot() - m0,
           "hbm_place_bytes": pbytes.snapshot() - b0,
           "hbm_hop_bytes": rows["hbm"]["bytes"]}
    check(landed == payload and got["hbm_place_bytes"] == payload
          and got["hbm_hop_bytes"] == payload,
          f"hooks (b): {payload} payload bytes, landings {landed}, "
          f"readings {got}")
    check(got["hbm_place_msgs"] == sum(leaves) == 2 * n_msgs,
          f"hooks (b): {n_msgs} messages of 2 leaves, landings {leaves}, "
          f"hbm_place_msgs {got['hbm_place_msgs']}")
    check(launched == land.launches(), f"hooks (b): launched {launched}, "
          f"the landings' offsets give {land.launches()}")
    print(f"hooks (b): phase 5's device-ring stream, {n_msgs} messages "
          f"({payload} payload bytes, {recs[0]['gbps']} GB/s): waterfall "
          f"{ {h: r for h, r in rows.items() if r['bytes']} }; "
          f"{got} equal the landings; launches {launched} as the offsets "
          f"give ({card})", flush=True)
    return {"rows": rows, "readings": got, "launches": launched,
            "payload": payload, "gbps": recs[0]["gbps"]}


def _hooks_flight(card, classify, images) -> dict:
    """(c): one rendezvous transfer's edges under its link's tag, and a
    slow handler on the device ring named ``device-infer``."""
    import torch

    from tpurpc_torch.obs import flight, watchdog
    from tpurpc_torch.rpc.channel import Channel
    from tpurpc_torch.rpc.server import Server, unary_unary_rpc_method_handler
    from tpurpc_torch.torchshim.service import TensorClient

    t_ns = time.monotonic_ns()
    srv = Server(max_workers=4)
    srv.add_method(HOOK_METHOD, unary_unary_rpc_method_handler(
        lambda req, ctx: bytes(req)))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    big = bytes(range(256)) * 4096
    try:
        with Channel(f"127.0.0.1:{port}") as ch:
            mc = ch.unary_unary(HOOK_METHOD)
            check(bytes(mc(b"warm", timeout=30)) == b"warm",
                  "hooks (c): warm-up")
            check(bytes(mc(big, timeout=30)) == big, "hooks (c): echo")
    finally:
        srv.stop()
    evs = [e for e in flight.snapshot(since_ns=t_ns)
           if e["entity"].startswith("rdv:")]
    seq = None
    for w in (e for e in evs if e["event"] == "rdv-write"):
        same = [e for e in evs if e["tag"] == w["tag"]]
        claim = [e for e in same if e["event"] == "rdv-claim"
                 and e["a2"] == w["a1"] and e["t_ns"] <= w["t_ns"]]
        if not claim:
            continue
        offer = [e for e in same if e["event"] == "rdv-offer"
                 and e["a1"] == claim[-1]["a1"]
                 and e["t_ns"] <= claim[-1]["t_ns"]]
        done = [e for e in same if e["event"] == "rdv-complete"
                and e["a1"] == w["a1"] and e["t_ns"] >= w["t_ns"]]
        if offer and done:
            seq = (w["entity"], [(e["event"], e["a1"], e["a2"]) for e in
                                 (offer[-1], claim[-1], w, done[0])])
            break
    check(seq is not None, f"hooks (c): no offer-claim-write-complete "
          f"under one tag in {[(e['entity'], e['event']) for e in evs]}")

    # the handler's method has a history (phase 3's calls): its stall bar is
    # the larger of 0.3 s and its rolling p99 (a multiple of 1), below the
    # 1.5 s the handler sleeps even where cold first calls fill the window
    wd = watchdog.get()
    prev = (wd.min_stall_s, wd.sweep_s, wd.mult)
    wd.min_stall_s, wd.sweep_s, wd.mult = 0.3, 0.1, 1.0

    def slow(tree):
        time.sleep(1.5)
        return classify(tree)

    rig = CallPlaneServer(slow)
    diag = None
    try:
        with Channel(f"127.0.0.1:{rig.port}") as ch:
            client = TensorClient(ch)
            out = []
            t = threading.Thread(target=lambda: out.append(client.call(
                "Classify", {"images": torch.from_numpy(images[0])},
                timeout=60)))
            t.start()
            deadline = time.monotonic() + 10
            while diag is None and time.monotonic() < deadline:
                time.sleep(0.1)
                diag = next((d for d in wd.sweep_once()
                             if d["method"] == OBS_METHOD
                             and d["kind"] == "server"), None)
            t.join(60)
    finally:
        wd.min_stall_s, wd.sweep_s, wd.mult = prev
        rig.server.stop()
    check(diag is not None and diag["stage"] == "device-infer",
          f"hooks (c): the slow handler's diagnosis {diag}")
    check(len(out) == 1, "hooks (c): the slow call did not complete")
    print(f"hooks (c): one rendezvous transfer's edges under "
          f"{seq[0]}: {seq[1]}; a 1.5 s handler on the device ring "
          f"diagnosed {diag['stage']!r} ({diag['detail']}); launches "
          f"{rig.launched} ({card})", flush=True)
    return {"rdv": seq, "stage": diag["stage"],
            "launches": dict(rig.launched)}


def _hooks_counted(card, classify, images, first, calls) -> dict:
    """(d), the counted turn: the obs plane's events per device-ring call
    of phase 3's request (untimed)."""
    from tpurpc_torch.rpc.channel import Channel
    from tpurpc_torch.torchshim.service import TensorClient

    rig = CallPlaneServer(classify)
    try:
        with Channel(f"127.0.0.1:{rig.port}") as ch:
            client = TensorClient(ch)
            _bit_equal("hooks (d) warm-up", _lc_call(
                "hooks (d) warm-up", client, images[0]), first[0])
            with _HookCounts() as hc:
                for i in range(calls):
                    _bit_equal(f"hooks (d) counted call {i}", _lc_call(
                        f"hooks (d) counted call {i}", client,
                        images[i % len(images)]), first[i % len(images)])
    finally:
        rig.server.stop()
    per_call = {k: v / calls for k, v in hc.n.items()}
    print(f"hooks (d): per device-ring call, both ends in this process: "
          f"{per_call} ({card})", flush=True)
    return {"per_call": per_call, "launches": dict(rig.launched)}


def _hooks_h2(card, calls) -> dict:
    """(e): ``calls`` unary calls over one ``H2Channel``: every one in
    ``srv_calls{method,0}``, and the server's connection in
    ``h2_server_connections`` while the channel is open, gone after."""
    import gc

    from tpurpc_torch.obs import metrics
    from tpurpc_torch.rpc.server import Server, unary_unary_rpc_method_handler
    from tpurpc_torch.wire.h2_client import H2Channel

    fam = metrics.labeled_counter("srv_calls", ("method", "code"))
    gauge = metrics.fleet("h2_server_connections")
    ok0 = fam.snapshot().get((HOOK_METHOD, "0"), 0)
    srv = Server(max_workers=4)
    srv.add_method(HOOK_METHOD, unary_unary_rpc_method_handler(
        lambda req, ctx: bytes(req)))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()

    def live():
        gc.collect()
        return sum(1 for c in list(gauge._refs) if c.server is srv)

    try:
        with H2Channel(f"127.0.0.1:{port}") as ch:
            mc = ch.unary_unary(HOOK_METHOD)
            for i in range(calls):
                check(bytes(mc(b"%d" % i, timeout=30)) == b"%d" % i,
                      f"hooks (e) call {i}")
            open_n = live()
        _await(lambda: live() == 0, 10, "hooks (e): the closed connection")
        _await(lambda: fam.snapshot().get((HOOK_METHOD, "0"), 0) - ok0
               == calls, 10, "hooks (e): srv_calls")
    finally:
        srv.stop()
    ok = fam.snapshot().get((HOOK_METHOD, "0"), 0) - ok0
    check(open_n == 1, f"hooks (e): h2_server_connections read {open_n} "
          f"with the channel open")
    print(f"hooks (e): {calls} calls over one H2Channel: srv_calls"
          f"{{{HOOK_METHOD},0}} read {ok}; h2_server_connections read "
          f"{open_n} open, 0 after ({card})", flush=True)
    return {"srv_calls_ok": ok, "open": open_n}


def obs_hooks_plane(dev, card, ring=RING, calls=HOOK_CALLS,
                    msgs=HOOK_STREAM_MSGS, turns=HOOK_TURNS,
                    per_turn=HOOK_TURN_CALLS, h2_calls=HOOK_H2_CALLS) -> dict:
    """Phase 19: the other planes' obs hooks on the card (docstring of this
    file). Returns each part's launches."""
    import numpy as np
    import torch

    from tpurpc_torch.models.resnet import make_infer_fn, resnet50
    from tpurpc_torch.obs import watchdog
    from tpurpc_torch.ops import ring_scatter as rs_mod
    from tpurpc_torch.ops import ring_window as rw_mod

    t_phase = time.perf_counter()
    saved = {k: os.environ.get(k) for k in OBS_ENV}
    _set_env({"GRPC_PLATFORM_TYPE": "TPU", "TPURPC_TORCH_DEVICE": str(dev),
              "TPURPC_HBM_RING_SIZE_KB": str(ring >> 10),
              "TPURPC_INLINE_PUMP": None, "TPURPC_TRACE_SAMPLE": None})
    res = {}
    try:
        if _PHASE3:
            infer, images = _PHASE3["infer"], _PHASE3["images"]
            first = _PHASE3["replies"]
        else:   # a rehearsal without phase 3: the same seeds
            torch.manual_seed(SEED)
            infer = make_infer_fn(resnet50().to(dev))
            rng = np.random.default_rng(SEED)
            images = [rng.standard_normal((BATCH, SIZE, SIZE, 3)).astype(
                np.float32) for _ in range(REQUESTS)]
            first = None

        def classify(tree):
            logits = infer(tree["images"].to(dev))
            return {"logits": logits, "top1": logits.argmax(dim=1)}

        if first is None:
            from tpurpc_torch.rpc.channel import Channel
            from tpurpc_torch.torchshim.service import TensorClient

            rig = CallPlaneServer(classify)
            try:
                with Channel(f"127.0.0.1:{rig.port}") as ch:
                    client = TensorClient(ch)
                    first = [_lc_call(f"hooks reference reply {i}", client, x)
                             for i, x in enumerate(images)]
            finally:
                rig.server.stop()

        def part(key, fn):
            t = time.perf_counter()
            rs_mod.launches = rw_mod.launches = 0
            res[key] = fn()
            res[key]["part_launches"] = {"ring_scatter": rs_mod.launches,
                                         "ring_window": rw_mod.launches}
            print(f"hooks ({key}) took {time.perf_counter() - t} s; "
                  f"launches {res[key]['part_launches']}", flush=True)

        part("a", lambda: _hooks_profile(card, classify, images, first,
                                         calls))
        check(res["a"]["part_launches"] == res["a"]["launches"],
              f"hooks (a): launched {res['a']['part_launches']}, the "
              f"landings give {res['a']['launches']}")
        # phase 5's ring, whatever the phase's own
        part("b", lambda: _hooks_waterfall(dev, card, RING, msgs))
        _set_env({"GRPC_PLATFORM_TYPE": "TPU",
                  "TPURPC_HBM_RING_SIZE_KB": str(ring >> 10)})
        part("c", lambda: _hooks_flight(card, classify, images))

        def cost():
            out = _obs_cost(dev, card, classify, images, first, turns,
                            per_turn, label="hooks (d)")
            rs_mod.launches = rw_mod.launches = 0   # the counted turn's
            out["counted"] = _hooks_counted(card, classify, images, first,
                                            per_turn)
            print(f"hooks (d): p50 with the plane at its defaults "
                  f"{out['p50_on']} ms, every switch off {out['p50_off']} "
                  f"ms (+{out['p50_on'] - out['p50_off']} ms), {turns} "
                  f"alternating turns of {per_turn}; per call "
                  f"{out['counted']['per_call']} ({card})", flush=True)
            return out

        part("d", cost)
        check(res["d"]["part_launches"] == res["d"]["counted"]["launches"],
              f"hooks (d): the counted turn launched "
              f"{res['d']['part_launches']}, its server measured "
              f"{res['d']['counted']['launches']}")
        part("e", lambda: _hooks_h2(card, h2_calls))
        check(res["e"]["part_launches"] == {"ring_scatter": 0,
                                            "ring_window": 0},
              f"hooks (e): no device-ring landing, launched "
              f"{res['e']['part_launches']}")
    finally:
        _set_env(saved)
        watchdog.get().stop()
    print(f"hooks: phase 19 took {time.perf_counter() - t_phase} s ({card})",
          flush=True)
    return res


# -- phase 20 ----------------------------------------------------------------

#: (a): phase 3's device-ring calls around the scrapes; the fine tsdb grain
#: (s) while they run; alternating turns of calls with the sampler off and
#: at its defaults; timed sample ticks and renders
SCRAPE_CALLS = 64
SCRAPE_FINE_S = 0.05
SCRAPE_TURNS, SCRAPE_TURN_CALLS = 8, 8
SCRAPE_TICKS, SCRAPE_RENDERS = 50, 20
#: (b): the latency objective on phase 3's method (its least bar, in ms,
#: its target and its one window pair: fast s, slow s, burn threshold), the
#: evaluator's cadence (s), the device stretch a slow call spends in the
#: model's forwards (s), and the most slow calls and fast calls it makes
SLO_NAME = "phase20-p99"
SLO_BAR_MS, SLO_TARGET_PCT = 250.0, 50.0
SLO_WINDOWS = [(0.8, 1.6, 1.2)]
SLO_EVAL_S = 0.1
STALL_S = 1.2
STALL_CALLS, RECOVER_CALLS = 8, 600
#: (c): requests of phase 3's on each fleet worker
SCRAPE_FLEET_REQUESTS = 4
SCRAPE_ENV = OBS_ENV + ("TPURPC_TSDB", "TPURPC_TSDB_FINE_S",
                        "TPURPC_BUNDLE_DIR", "TPURPC_SCRAPE",
                        "TPURPC_DIAGNOSE")


def _http(port, path, verb="GET", timeout=30.0):
    """One HTTP/1.0 request on loopback: ``(status, headers, body)``."""
    import socket

    with socket.create_connection(("127.0.0.1", port),
                                  timeout=timeout) as s:
        s.settimeout(timeout)
        s.sendall(f"{verb} {path} HTTP/1.0\r\n\r\n".encode())
        buf = bytearray()
        while True:
            chunk = s.recv(1 << 16)
            if not chunk:
                break
            buf += chunk
    head, _, body = bytes(buf).partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    check(len(lines[0].split()) >= 2, f"scrape: no status line in {head!r}")
    hdrs = dict(ln.split(": ", 1) for ln in lines[1:] if ": " in ln)
    return int(lines[0].split()[1]), hdrs, body


def _prom(text: str) -> dict:
    """Prometheus text exposition → ``{(name, labels): value}``; fails on
    any line that is neither a ``# TYPE`` line nor a sample."""
    import re

    sample = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? '
                        r'(-?(?:[0-9.]+(?:[eE][-+]?[0-9]+)?|nan|inf))$')
    out = {}
    for ln in text.splitlines():
        if not ln:
            continue
        if ln.startswith("# TYPE "):
            check(len(ln.split()) == 4 and ln.split()[3] in (
                "counter", "gauge", "summary"), f"scrape: bad TYPE {ln!r}")
            continue
        m = sample.match(ln)
        check(m is not None, f"scrape: not a Prometheus sample: {ln!r}")
        out[(m.group(1), (m.group(2) or "")[1:-1])] = float(m.group(3))
    return out


def _once_us(fn) -> float:
    """The host clock's µs for one call of ``fn``."""
    t = time.perf_counter()
    fn()
    return (time.perf_counter() - t) * 1e6


def _fresh_tsdb() -> None:
    """Stop the process-wide sampler and forget its store; the next
    ``ensure_started`` builds one on the current variables."""
    from tpurpc_torch.obs import tsdb

    if tsdb._instance is not None:
        tsdb._instance.stop()
    tsdb.postfork_reset()


def _scrape_calls(label, client, images, first, calls, after=None):
    """``calls`` device-ring calls, each reply bit-equal to phase 3's; each
    call's host ms. ``after(i)`` runs after reply i."""
    lat = []
    for i in range(calls):
        t0 = time.perf_counter()
        got = _lc_call(f"{label} call {i}", client, images[i % len(images)])
        lat.append((time.perf_counter() - t0) * 1e3)
        _bit_equal(f"{label} call {i}", got, first[i % len(images)])
        if after is not None and after(i):
            break
    return lat


def _scrape_history(dev, card, classify, images, first, calls, turns,
                    per_turn) -> dict:
    """(a): the scrape and history planes on phase 3's device-ring path."""
    import numpy as np

    from tpurpc_torch.obs import scrape, tsdb
    from tpurpc_torch.ops import ring_scatter as rs_mod
    from tpurpc_torch.ops import ring_window as rw_mod
    from tpurpc_torch.rpc.channel import Channel
    from tpurpc_torch.torchshim.service import TensorClient
    from tpurpc_torch.tpu import ledger

    _set_env({"TPURPC_TSDB": None, "TPURPC_TSDB_FINE_S": str(SCRAPE_FINE_S)})
    _fresh_tsdb()
    rig = CallPlaneServer(classify)    # its start() starts the sampler
    try:
        check(tsdb.get().fine_s == SCRAPE_FINE_S and tsdb.get().doc()[
            "running"], f"scrape (a): sampler {tsdb.get().doc()}")
        with Channel(f"127.0.0.1:{rig.port}") as ch:
            client = TensorClient(ch)
            _scrape_calls("scrape (a) warm-up", client, images, first, 1)
            status, hdrs, body = _http(rig.port, "/metrics")
            check(status == 200 and hdrs.get("Content-Type", "").startswith(
                "text/plain"), f"scrape (a): /metrics {status} {hdrs}")
            before = _prom(body.decode())
            with _Landings() as land, ledger.track() as w:
                rs_mod.launches = rw_mod.launches = 0
                lat = _scrape_calls("scrape (a)", client, images, first,
                                    calls)
                launched = {"ring_scatter": rs_mod.launches,
                            "ring_window": rw_mod.launches}
            after = _prom(_http(rig.port, "/metrics")[2].decode())
        check(launched == land.launches(), f"scrape (a): launched "
              f"{launched}, the landings give {land.launches()}")

        def delta(name, labels=""):
            return after.get((name, labels), 0.0) - before.get(
                (name, labels), 0.0)

        for k, v in w.delta.items():
            name, kind = (("tpurpc_ledger_ops", k[:-4]) if k.endswith("_ops")
                          else ("tpurpc_ledger_bytes", k))
            got = delta(name, f'kind="{kind}"')
            check(got == v, f"scrape (a): {name}{{kind={kind}}} moved {got}, "
                  f"the ledger {v}")
        msgs = sum(len(leaves) for *_, leaves in land.recs)
        nbytes = sum(sum(leaves) for *_, leaves in land.recs)
        check((delta("tpurpc_hbm_place_msgs"), delta("tpurpc_hbm_place_bytes"))
              == (msgs, nbytes) and nbytes == calls * SPAN,
              f"scrape (a): hbm_place moved "
              f"{(delta('tpurpc_hbm_place_msgs'), delta('tpurpc_hbm_place_bytes'))}"
              f", the landings {(msgs, nbytes)} ({calls} x {SPAN} bytes)")
        red = (delta("tpurpc_srv_calls",
                     f'method="{OBS_METHOD}",code="0"'),
               delta("tpurpc_srv_call_us_count"))
        check(red == (calls, calls), f"scrape (a): srv_calls and "
              f"srv_call_us_count moved {red}, want {calls} each")
        # the history: the ring gauges' series on the shortened fine tier
        time.sleep(10 * SCRAPE_FINE_S)
        inv = json.loads(_http(rig.port, "/debug/history")[2])
        ring_series = sorted(s for s in inv["series"] if s.startswith("ring_"))
        check(inv["fine"]["grain_s"] == SCRAPE_FINE_S
              and "hbm_ring_occupancy_bytes" in inv["series"] and ring_series,
              f"scrape (a): /debug/history inventory {inv['fine']} "
              f"{len(inv['series'])} series")
        pts = {}
        for s in ("hbm_ring_occupancy_bytes", "ring_bytes_read"):
            doc = json.loads(_http(rig.port, f"/debug/history?series={s}"
                                             f"&window_s=30")[2])
            pts[s] = doc["points"]
            check(len(doc["points"]) >= 10, f"scrape (a): {s} has "
                  f"{len(doc['points'])} points")
        occ = max(v for _t, v in pts["hbm_ring_occupancy_bytes"])
        status, hdrs, body = _http(rig.port, "/healthz?json=1")
        hz = json.loads(body)
        check(status == 200 and hz["status"] == "ok"
              and hdrs.get("Content-Type") == "application/json",
              f"scrape (a): /healthz {status} {hz}")
        # host costs: one sample tick and one /metrics render
        db = tsdb.get()
        ticks = [_once_us(db.sample_once) for _ in range(SCRAPE_TICKS)]
        renders = [_once_us(lambda: scrape._route("/metrics"))
                   for _ in range(SCRAPE_RENDERS)]
        tick_us, render_us = float(np.median(ticks)), float(np.median(renders))
        n_series = len(db.series())
        # phase 3's path with the sampler off and at its defaults
        sides = {"off": [], "on": []}
        turn_p50 = {"off": [], "on": []}
        for t in range(turns):
            side = "off" if t % 2 == 0 else "on"
            _set_env({"TPURPC_TSDB": "0" if side == "off" else None,
                      "TPURPC_TSDB_FINE_S": None})
            _fresh_tsdb()
            check((tsdb.ensure_started() is None) == (side == "off"),
                  f"scrape (a) turn {t}: the sampler's switch")
            with Channel(f"127.0.0.1:{rig.port}") as ch:
                lat_t = _scrape_calls(f"scrape (a) turn {t}",
                                      TensorClient(ch), images, first,
                                      per_turn)
            sides[side] += lat_t
            turn_p50[side].append(float(np.percentile(lat_t, 50)))
            print(f"scrape (a) turn {t} (tsdb {side}): p50 "
                  f"{turn_p50[side][-1]} ms", flush=True)
    finally:
        rig.server.stop()
        _set_env({"TPURPC_TSDB": None, "TPURPC_TSDB_FINE_S": None})
        _fresh_tsdb()
    won = sum(1 for a, b in zip(turn_p50["on"], turn_p50["off"]) if a < b)
    out = {"launches": launched, "p50": float(np.percentile(lat, 50)),
           "tick_us": tick_us, "render_us": render_us, "series": n_series,
           "p50_off": float(np.percentile(sides["off"], 50)),
           "p50_on": float(np.percentile(sides["on"], 50)),
           "turn_p50_off": turn_p50["off"], "turn_p50_on": turn_p50["on"],
           "pairs_won_by_on": won, "ring_series": len(ring_series),
           "occupancy_max": occ}
    print(f"scrape (a): {calls} device-ring calls, p50 {out['p50']} ms; "
          f"/metrics parses and its deltas equal the calls' (the copy "
          f"ledger {dict(w.delta)}, hbm_place {msgs} msgs / {nbytes} bytes, "
          f"srv_calls and srv_call_us_count {calls}); /debug/history at "
          f"{SCRAPE_FINE_S} s: hbm_ring_occupancy_bytes (max {occ}) and "
          f"{len(ring_series)} ring_* series; one sample tick of "
          f"{n_series} series {tick_us} us (median of {SCRAPE_TICKS}), one "
          f"/metrics render {render_us} us (median of {SCRAPE_RENDERS}); "
          f"phase 3's path in {turns} alternating turns of {per_turn}: p50 "
          f"{out['p50_off']} ms with TPURPC_TSDB=0, {out['p50_on']} ms at "
          f"the default, the default faster in {won} of "
          f"{min(len(turn_p50['on']), len(turn_p50['off']))} pairs; "
          f"launches {launched} ({card})", flush=True)
    return out


def _slo_stall(dev, card, infer, classify, images, first) -> dict:
    """(b): a latency objective on phase 3's method; a handler stretch in
    the model's own forwards on the card trips the watchdog at
    ``device-infer``, fires the alert, writes one bundle, and is diagnosed
    live and from the bundle alike; fast calls resolve the alert."""
    import contextlib
    import io
    import shutil
    import tempfile

    import torch

    from tpurpc_torch.obs import bundle, flight, slo, watchdog
    from tpurpc_torch.ops import ring_scatter as rs_mod
    from tpurpc_torch.ops import ring_window as rw_mod
    from tpurpc_torch.rpc.channel import Channel
    from tpurpc_torch.tools import bundle as bundle_cli
    from tpurpc_torch.torchshim.service import TensorClient

    root = tempfile.mkdtemp(prefix="tpurpc-bundles-")
    _set_env({"TPURPC_BUNDLE_DIR": root, "TPURPC_TSDB": None,
              "TPURPC_TSDB_FINE_S": str(SCRAPE_FINE_S)})
    _fresh_tsdb()
    slo.reset()
    flight.RECORDER.reset()
    wd = watchdog.get()
    wd.reset()
    prev = (wd.min_stall_s, wd.sweep_s, wd.mult, wd.enabled)
    wd.min_stall_s, wd.sweep_s, wd.mult, wd.enabled = 0.3, 0.1, 1.0, True
    stall = {"on": False, "forwards": []}
    x_dev = torch.from_numpy(images[0]).to(dev)

    def slowable(tree):
        if stall["on"]:
            n, t0 = 0, time.perf_counter()
            while time.perf_counter() - t0 < STALL_S:
                infer(x_dev)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                n += 1
            stall["forwards"].append(n)
        return classify(tree)

    rig = CallPlaneServer(slowable)   # start(): sampler, bundle writer armed
    res = {}
    try:
        check(bundle.enabled() and bundle.get().root == root,
              "slo (b): TPURPC_BUNDLE_DIR did not arm the bundle writer")
        states = []
        with Channel(f"127.0.0.1:{rig.port}") as ch, _Landings() as land:
            client = TensorClient(ch)
            rs_mod.launches = rw_mod.launches = 0
            warm = _scrape_calls("slo (b) warm-up", client, images, first,
                                 16)
            # the bar: SLO_BAR_MS, or twice the warm-up's second slowest
            # call on a slower host (the rolling p99 of 16 calls is their
            # second largest), and well under the stall
            bar_ms = max(SLO_BAR_MS, 2 * sorted(warm)[-2])
            check(bar_ms <= STALL_S * 1e3 / 2, f"slo (b): calls of "
                  f"{sorted(warm)[-2]} ms leave no room under the stall")
            ev = slo.get()
            ev.eval_s = SLO_EVAL_S
            obj = slo.declare(SLO_NAME, method=OBS_METHOD, latency_ms=bar_ms,
                              latency_target_pct=SLO_TARGET_PCT,
                              windows=SLO_WINDOWS)
            st = obj.tracks["latency"]
            time.sleep(2 * SLO_WINDOWS[0][1])   # a window of healthy samples
            check(st.state == "ok", f"slo (b): {st.state} before the stall")
            # the first slow call: its stall live, while it lasts
            stall["on"] = True
            out = []
            t = threading.Thread(target=lambda: out.append(_lc_call(
                "slo (b) slow call 0", client, images[0], timeout=120)))
            t.start()
            diag = None
            deadline = time.monotonic() + 10
            while diag is None and time.monotonic() < deadline:
                time.sleep(0.05)
                diag = next((d for d in wd.active()
                             if d["method"] == OBS_METHOD
                             and d["kind"] == "server"), None)
            check(diag is not None and diag["stage"] == "device-infer",
                  f"slo (b): the slow handler's diagnosis {diag}")
            live = json.loads(_http(rig.port, "/debug/diagnose")[2])
            status, _h, body = _http(rig.port, "/healthz?json=1")
            stalled = json.loads(body)
            t.join(120)
            check(len(out) == 1, "slo (b): the slow call did not complete")
            _bit_equal("slo (b) slow call 0", out[0], first[0])
            live_top = live["hypotheses"][0]["cause"]
            check(live["symptom"]["stage"] == "device-infer"
                  and live_top == "device-infer",
                  f"slo (b): /debug/diagnose ranked {live['symptom']} / "
                  f"{[(h['cause'], h['confidence']) for h in live['hypotheses']]}")
            check(status == 503 and "watchdog-stall" in [
                r["reason"] for r in stalled["degraded_reasons"]],
                f"slo (b): /healthz during the stall {status} {stalled}")
            # more slow calls until the alert fires
            slow = 1
            while st.state != "firing" and slow < STALL_CALLS:
                states.append(st.state)
                got = _lc_call(f"slo (b) slow call {slow}", client,
                               images[slow % len(images)], timeout=120)
                _bit_equal(f"slo (b) slow call {slow}", got,
                           first[slow % len(images)])
                slow += 1
            stall["on"] = False
            firing_hz = None

            def recover(i):
                nonlocal firing_hz
                states.append(st.state)
                if st.state == "firing" and firing_hz is None:
                    status, _h, body = _http(rig.port, "/healthz")
                    doc = json.loads(_http(rig.port, "/healthz?json=1")[2])
                    firing_hz = (status, body.decode(),
                                 [r["reason"] for r in
                                  doc["degraded_reasons"]])
                return "firing" in states and st.state == "ok"

            fast = _scrape_calls("slo (b) recovery", client, images, first,
                                 RECOVER_CALLS, after=recover)
            launched = {"ring_scatter": rs_mod.launches,
                        "ring_window": rw_mod.launches}
        check(launched == land.launches(), f"slo (b): launched {launched}, "
              f"the landings give {land.launches()}")
        seen = [(h["from"], h["to"]) for h in ev.doc()["history"]
                if h["objective"] == SLO_NAME]
        fired = seen.index(("pending", "firing")) if (
            "pending", "firing") in seen else -1
        check(fired > 0 and ("ok", "pending") in seen[:fired]
              and ("firing", "ok") in seen[fired:] and st.state == "ok",
              f"slo (b): the alert went {seen}, now {st.state}")
        check(firing_hz is not None and firing_hz[0] == 503
              and "slo-firing" in firing_hz[2] and "SLO" in firing_hz[1],
              f"slo (b): /healthz while firing {firing_hz}")
        edges = [e["event"] for e in flight.snapshot()
                 if e["entity"] == f"slo:{SLO_NAME}"]
        check(edges == ["slo-firing", "slo-resolved"],
              f"slo (b): the objective's flight edges {edges}")
        names = bundle.list_bundles(root)
        check(len(names) == 1 and "-watchdog-" in names[0],
              f"slo (b): bundles {names}")
        path = os.path.join(root, names[0])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = bundle_cli.main([root])
        text = buf.getvalue()
        check(rc == 0 and "trigger  watchdog" in text
              and "device-infer" in text and "flight" in text,
              f"slo (b): tools.bundle rendered rc {rc}: {text[:400]}")
        from tpurpc_torch.obs import diagnose

        replay = diagnose.diagnose_bundle(path)
        check(replay["hypotheses"][0]["cause"] == live_top,
              f"slo (b): the bundle's diagnosis ranks "
              f"{replay['hypotheses'][0]['cause']}, live {live_top}")
        res = {"launches": launched, "slow_calls": slow, "bar_ms": bar_ms,
               "forwards": stall["forwards"], "fast_calls": len(fast),
               "states": seen, "bundle": names[0], "top": live_top,
               "confidence": live["hypotheses"][0]["confidence"]}
    finally:
        wd.min_stall_s, wd.sweep_s, wd.mult, wd.enabled = prev
        slo.reset()
        bundle.disable()
        rig.server.stop()
        _set_env({"TPURPC_BUNDLE_DIR": None, "TPURPC_TSDB_FINE_S": None})
        _fresh_tsdb()
        shutil.rmtree(root, ignore_errors=True)
    print(f"slo (b): objective {SLO_NAME}: p99 under {res['bar_ms']} ms "
          f"for {SLO_TARGET_PCT} % of the samples, windows {SLO_WINDOWS}; "
          f"a {STALL_S} s device stretch per slow call "
          f"({res['forwards']} synchronized ResNet-50 forwards) tripped the "
          f"watchdog at device-infer; the alert went {res['states']} over "
          f"{res['slow_calls']} slow and {res['fast_calls']} fast calls "
          f"(slo-firing, slo-resolved); one bundle {res['bundle']}, "
          f"rendered; /debug/diagnose and the bundle's replay rank "
          f"{res['top']} first (confidence {res['confidence']}); every "
          f"reply bit-equal; launches {res['launches']} ({card})",
          flush=True)
    return res


def _scrape_fleet(dev, card, requests) -> dict:
    """(c): phase 9's two spawned device-ring workers: their scrape ports,
    the aggregated /metrics and /debug/flight on the serving port, a fleet
    collector over both, and one worker's death."""
    import torch

    from tpurpc_torch.obs.collector import FleetCollector
    from tpurpc_torch.rpc.channel import Channel
    from tpurpc_torch.rpc.shard import ShardedServer
    from tpurpc_torch.torchshim.service import TensorClient

    first = _PHASE3.get("replies")
    images = _PHASE3.get("images")
    t0 = time.perf_counter()
    sup = ShardedServer(fleet_ring_build, workers=FLEET_WORKERS,
                        listener="handoff", handoff_policy="round_robin")
    sup.start(ready_timeout=600)
    chans, col = [], None
    try:
        ports = sup.scrape_ports()
        check(sorted(ports) == list(range(FLEET_WORKERS))
              and all(ports.values()) and len(set(ports.values())) ==
              FLEET_WORKERS, f"fleet (c): scrape ports {ports}")
        print(f"scrape (c): {FLEET_WORKERS} workers up in "
              f"{time.perf_counter() - t0} s, scrape ports {ports}",
              flush=True)
        stats = []
        for k in range(FLEET_WORKERS):   # dialed in turn: round robin
            ch = Channel(f"127.0.0.1:{sup.port}")
            chans.append(ch)
            client = TensorClient(ch)
            for i in range(requests):
                x = images[i % len(images)]
                got = client.call("Call", {"images": torch.from_numpy(x)},
                                  timeout=300)
                if first is not None:
                    _bit_equal(f"scrape (c) worker {k} call {i}", got,
                               first[i % len(images)])
            stats.append(json.loads(bytes(ch.unary_unary(
                "/tpurpc.Tensor/Stats")(b"", timeout=300))))
        check([s["shard"] for s in stats] == list(range(FLEET_WORKERS)),
              f"scrape (c): round robin put channels on {stats}")
        status, _h, body = _http(sup.port, "/metrics")
        check(status == 200, f"scrape (c): aggregated /metrics {status}")
        agg = _prom(body.decode())
        for k in range(FLEET_WORKERS):
            lab = f'shard="{k}"'
            landed = agg.get(("tpurpc_hbm_place_bytes", lab))
            calls = agg.get(("tpurpc_srv_calls", f'{lab},method='
                             f'"/tpurpc.Tensor/Call",code="0"'))
            check(agg.get(("tpurpc_shard_up", lab)) == 1
                  and landed == requests * SPAN and calls == requests,
                  f"scrape (c): shard {k}: up "
                  f"{agg.get(('tpurpc_shard_up', lab))}, hbm_place_bytes "
                  f"{landed} (want {requests * SPAN}), Call {calls}")
        fl = json.loads(_http(sup.port, "/debug/flight")[2])
        starts = sorted((e["a1"], e["shard"]) for e in fl["events"]
                        if e["event"] == "shard-start")
        check(starts == [(k, k) for k in range(FLEET_WORKERS)],
              f"scrape (c): shard-start events {starts}")
        # the collector's members are the workers' scrape ports; a worker
        # answers /metrics with the fleet's aggregate, shard-labeled
        col = FleetCollector([f"127.0.0.1:{p}" for p in ports.values()],
                             stale_after=2, fetch_timeout_s=5.0)
        col.poll_once()
        census = {c["member"]: c["state"] for c in col.census()}
        merged = col.merged_metrics()
        check(set(census.values()) == {"up"} and all(
            f'tpurpc_hbm_place_bytes{{member="127.0.0.1:{p}",shard="{k}"}} '
            f'{requests * SPAN}' in merged for p in ports.values()
            for k in range(FLEET_WORKERS)),
            f"scrape (c): the collector's census {census}; "
            f"{[ln for ln in merged.splitlines() if 'hbm_place_bytes' in ln]}")
        # one worker stops: its series leave the aggregate and the census
        gone = FLEET_WORKERS - 1
        check(sup.kill_worker(gone), f"scrape (c): worker {gone} not running")
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if sup.alive_workers() == list(range(gone)):
                break
            time.sleep(0.05)
        check(sup.alive_workers() == list(range(gone)),
              f"scrape (c): alive after the kill {sup.alive_workers()}")
        text = ""
        while time.monotonic() < deadline:
            status, _h, body = _http(sup.port, "/metrics")
            text = body.decode()
            if status == 200 and f'shard="{gone}"' not in text:
                break
            time.sleep(0.1)
        check(f'shard="{gone}"' not in text
              and 'tpurpc_shard_up{shard="0"} 1' in text,
              "scrape (c): the stopped worker's series stayed in the "
              "aggregate")
        for _ in range(col.stale_after):
            col.poll_once()
        dead = f"127.0.0.1:{ports[gone]}"
        census = {c["member"]: c["state"] for c in col.census()}
        merged = col.merged_metrics()
        check(census[dead] == "stale" and f'member="{dead}"}} 0' in merged
              and f'{{member="{dead}",' not in merged
              and f'shard="{gone}"' not in merged,
              f"scrape (c): the collector after the stop {census}")
    finally:
        if col is not None:
            col.stop()
        for ch in chans:
            ch.close()
        sup.stop()
    launches = {name: [s["launches"][name] for s in stats]
                for name in ("ring_scatter", "ring_window")}
    if dev.type == "cuda":
        for name, counts in launches.items():
            check(all(c >= 1 for c in counts), f"scrape (c): {name} "
                  f"launched {counts} times in the workers")
    print(f"scrape (c): {requests} requests on each of {FLEET_WORKERS} "
          f"workers; the aggregated /metrics carried each shard's "
          f"hbm_place_bytes and Call count and both shard-start events; "
          f"the collector saw both, then worker {gone}'s series left the "
          f"aggregate and the census (stale); launches per worker "
          f"{launches} ({card})", flush=True)
    return {"launches": launches}


def scrape_plane(dev, card, calls=SCRAPE_CALLS, turns=SCRAPE_TURNS,
                 per_turn=SCRAPE_TURN_CALLS,
                 fleet_requests=SCRAPE_FLEET_REQUESTS, ring=RING) -> dict:
    """Phase 20: history, alerting and the scrape plane on the card
    (docstring of this file). Returns each part's launches."""
    import numpy as np
    import torch

    from tpurpc_torch.models.resnet import make_infer_fn, resnet50
    from tpurpc_torch.obs import watchdog
    from tpurpc_torch.ops import ring_scatter as rs_mod
    from tpurpc_torch.ops import ring_window as rw_mod

    t_phase = time.perf_counter()
    saved = {k: os.environ.get(k) for k in SCRAPE_ENV}
    _set_env({"GRPC_PLATFORM_TYPE": "TPU", "TPURPC_TORCH_DEVICE": str(dev),
              "TPURPC_HBM_RING_SIZE_KB": str(ring >> 10),
              "TPURPC_INLINE_PUMP": None, "TPURPC_TRACE_SAMPLE": None})
    res = {}
    try:
        if not _PHASE3:   # a rehearsal without phase 3: the same seeds
            torch.manual_seed(SEED)
            infer = make_infer_fn(resnet50().to(dev))
            rng = np.random.default_rng(SEED)
            _PHASE3.update(infer=infer, images=[rng.standard_normal(
                (BATCH, SIZE, SIZE, 3)).astype(np.float32)
                for _ in range(REQUESTS)])
        infer, images = _PHASE3["infer"], _PHASE3["images"]

        def classify(tree):
            logits = infer(tree["images"].to(dev))
            return {"logits": logits, "top1": logits.argmax(dim=1)}

        if "replies" not in _PHASE3:
            from tpurpc_torch.rpc.channel import Channel
            from tpurpc_torch.torchshim.service import TensorClient

            rig = CallPlaneServer(classify)
            try:
                with Channel(f"127.0.0.1:{rig.port}") as ch:
                    client = TensorClient(ch)
                    _PHASE3["replies"] = [
                        _lc_call(f"scrape reference reply {i}", client, x)
                        for i, x in enumerate(images)]
            finally:
                rig.server.stop()
        first = _PHASE3["replies"]

        def part(key, fn):
            t = time.perf_counter()
            rs_mod.launches = rw_mod.launches = 0
            res[key] = fn()
            res[key]["part_launches"] = {"ring_scatter": rs_mod.launches,
                                         "ring_window": rw_mod.launches}
            print(f"scrape ({key}) took {time.perf_counter() - t} s; "
                  f"launches {res[key]['part_launches']}", flush=True)

        part("a", lambda: _scrape_history(dev, card, classify, images, first,
                                          calls, turns, per_turn))
        part("b", lambda: _slo_stall(dev, card, infer, classify, images,
                                     first))
        check(res["b"]["part_launches"] == res["b"]["launches"],
              f"slo (b): launched {res['b']['part_launches']}, the "
              f"landings give {res['b']['launches']}")
        part("c", lambda: _scrape_fleet(dev, card, fleet_requests))
        check(res["c"]["part_launches"] == {"ring_scatter": 0,
                                            "ring_window": 0},
              "scrape (c): the smoke process itself launched a kernel")
    finally:
        _set_env(saved)
        watchdog.get().stop()
    print(f"scrape: phase 20 took {time.perf_counter() - t_phase} s "
          f"({card})", flush=True)
    return res


# -- phase 21 -----------------------------------------------------------------

#: (a): the two accounts phase 8 (a)'s clients alternate, sent as
#: ``tpurpc-account``; the throughput reading's alternating turns
ODY_ACCOUNTS = ("tenant-a", "tenant-b")
ODY_TURNS = 8
ODY_PATTERN = ("0", "1", "1", "0")
#: (b): the odyssey smoke's journey: a 192-token prompt, 48 tokens, the
#: migration after the 6th; the decode servers' arenas
ODY_PROMPT, ODY_TOKENS, ODY_MIG_AT = 192, 48, 6
ODY_ACCOUNT = "tenant-journey"
#: (c): each held decode step spends STALL_S in synchronized card work; the
#: ITL objective (the bar far above a fast step, far below a held one) and
#: its windows, phase 20 (b)'s; rounds of ODY_ROUND streams x ODY_ROUND_TOKENS
ODY_ITL_MS, ODY_ITL_TARGET = 100.0, 50.0
ODY_SLO = "phase21-itl"
ODY_ROUND, ODY_ROUND_TOKENS = 8, 8
ODY_WAIT_S = 30.0


def _flight_tail(entity: str):
    """A thread that copies every flight event of ``entity`` out of the
    ring every 20 ms (the ring holds 4096 events; phase 8 (a)'s traffic
    emits more); ``stop()`` returns them, oldest first."""
    from tpurpc_torch.obs import flight

    seen, got, done = set(), [], threading.Event()
    since = [time.monotonic_ns()]

    def poll():
        for e in flight.snapshot(since_ns=since[0]):
            key = (e["t_ns"], e["code"], e["tid"], e["a1"], e["a2"])
            if e["entity"] == entity and key not in seen:
                seen.add(key)
                got.append(e)
            # an event stamped just before one already read may land in
            # the ring just after it: re-read the last 5 ms
            since[0] = max(since[0], e["t_ns"] - 5_000_000)

    def loop():
        while not done.wait(0.02):
            poll()

    t = threading.Thread(target=loop, daemon=True, name="phase21-flight")
    t.start()

    def stop():
        done.set()
        t.join(10)
        poll()
        got.sort(key=lambda e: e["t_ns"])
        return got
    return stop


def _journey_orders(events) -> dict:
    """sid -> the order of its submit/join/first-token/retire/leave edges."""
    keep = ("seq-submit", "gen-join", "seq-first-token", "gen-retire",
            "gen-leave")
    out = {}
    for e in events:
        if e["event"] in keep:
            out.setdefault(e["a1"], []).append(e["event"])
    return out


def _hist_count(name: str) -> int:
    from tpurpc_torch.obs import metrics

    return metrics.histogram(name, kind="latency").snapshot()["count"]


def _ody_colocated(dev, card) -> dict:
    """(a): phase 8 (a)'s traffic over two accounts, read back through the
    serving port; then tokens/s with the plane off and on."""
    from tpurpc_torch.obs import odyssey, profiler

    # the sampler starts with a server, not with a scrape: stop it here
    profiler.stop()
    profiler.get().reset()
    odyssey.reset()
    res = {}
    stop_tail = _flight_tail("decode:Generate")
    ttft0, itl0 = _hist_count("gen_ttft_us"), _hist_count("gen_itl_us")

    def inspect(port, sched):
        res["profiler_running"] = profiler.get().running()
        res["seq"] = json.loads(_http(port, "/debug/seq")[2])
        status, _h, body = _http(port, "/healthz?json=1")
        res["healthz"] = (status, json.loads(body))
        res["profile"] = json.loads(_http(port, "/debug/profile")[2])
        res["ttft"] = _hist_count("gen_ttft_us") - ttft0
        res["itl"] = _hist_count("gen_itl_us") - itl0

    try:
        run = _colocated(dev, card, accounts=ODY_ACCOUNTS, inspect=inspect,
                         profile=False)
    finally:
        events = stop_tail()
    check(res.get("profiler_running"), "odyssey (a): the stage profiler "
          "was not running before its first scrape (Server.start)")
    by = run["by_account"]
    seq = res["seq"]
    check(seq["enabled"], f"odyssey (a): /debug/seq {seq}")
    streams = tokens = 0
    for acct in ODY_ACCOUNTS:
        got, want = seq["accounts"].get(acct), by[acct]
        check(got is not None and got["tokens"] == want["tokens"]
              and got["seqs"] - got["sheds"] == want["streams"]
              and got["sheds"] <= want["sheds"] and got["failed"] == 0,
              f"odyssey (a): account {acct}: /debug/seq {got}, the clients "
              f"saw {want}")
        streams += want["streams"]
        tokens += want["tokens"]
    check(seq["attributed_pct"] is not None and seq["attributed_pct"] >= 95,
          f"odyssey (a): {seq['attributed_pct']} % of the step time "
          "attributed")
    check(res["ttft"] == streams and res["itl"] == tokens - streams,
          f"odyssey (a): gen_ttft_us counted {res['ttft']} and gen_itl_us "
          f"{res['itl']}; the streams were {streams} of {tokens} tokens")
    orders = _journey_orders(events)
    want_order = ["seq-submit", "gen-join", "seq-first-token", "gen-retire"]
    bad = {sid: o for sid, o in orders.items() if o != want_order}
    check(len(orders) == streams and not bad,
          f"odyssey (a): {len(orders)} sequences in the flight ring for "
          f"{streams} streams; out of order: {dict(list(bad.items())[:4])}")
    status, hz = res["healthz"]
    gen_lines = [ln for ln in hz["lines"] if ln.startswith("gen Generate:")]
    check(status == 200 and len(gen_lines) == 1,
          f"odyssey (a): /healthz?json=1 {status} {hz['lines']}")
    stages = res["profile"]["stages"]
    check(stages.get("decode_step", 0) > 0,
          f"odyssey (a): /debug/profile stages {stages}")
    out = {"streams": streams, "tokens": tokens,
           "attributed_pct": seq["attributed_pct"],
           "accounts": {a: seq["accounts"][a] for a in ODY_ACCOUNTS},
           "decode_step_samples": stages["decode_step"],
           "decode_step_pct": res["profile"]["stage_pct"]["decode_step"],
           "itl": seq["itl"], "ttft_p99_rolling_us":
               seq["ttft_p99_rolling_us"], "healthz": gen_lines[0]}
    print(f"odyssey (a): {streams} streams of {tokens} tokens over accounts "
          f"{list(ODY_ACCOUNTS)}; /debug/seq on the serving port rolls up "
          f"{ {a: (out['accounts'][a]['seqs'], out['accounts'][a]['tokens'], out['accounts'][a]['step_us']) for a in ODY_ACCOUNTS} } "
          f"(seqs, tokens, step us) and attributes {seq['attributed_pct']} "
          f"% of {seq['step_us_total']} step us; gen_ttft_us +{res['ttft']}, "
          f"gen_itl_us +{res['itl']}; ITL {seq['itl']}; every stream's "
          f"flight edges submit -> join -> first token -> retire; healthz "
          f"'{gen_lines[0]}'; the profiler (started by Server.start) holds "
          f"{stages['decode_step']} decode_step samples "
          f"({out['decode_step_pct']} % attributed) ({card})", flush=True)

    # the plane's cost to the same traffic: TPURPC_ODYSSEY=0 against the
    # default, alternating
    saved = os.environ.get("TPURPC_ODYSSEY")
    rates = {"0": [], "1": []}
    try:
        for i in range(ODY_TURNS):
            side = ODY_PATTERN[i % len(ODY_PATTERN)]
            _set_env({"TPURPC_ODYSSEY": "0" if side == "0" else None})
            odyssey.configure()
            check(odyssey.ACTIVE == (side == "1"),
                  "odyssey (a): TPURPC_ODYSSEY did not switch the plane")
            rates[side].append(_colocated(dev, card, accounts=ODY_ACCOUNTS,
                                          profile=False)["tokens_per_s"])
    finally:
        _set_env({"TPURPC_ODYSSEY": saved})
        odyssey.configure()
    med = {k: _pct(v, 0.5) for k, v in rates.items()}
    won = sum(on > off for on, off in zip(rates["1"], rates["0"]))
    out.update(rates=rates, median_off=med["0"], median_on=med["1"])
    print(f"odyssey (a): tokens/s in {ODY_TURNS} alternating turns: "
          f"TPURPC_ODYSSEY=0 {rates['0']} (median {med['0']}), default "
          f"{rates['1']} (median {med['1']}); the default faster in {won} "
          f"of {len(rates['1'])} pairs ({card})", flush=True)
    return out


def _ody_journey(dev, card) -> dict:
    """(b): one trace id from a spawned prefill child through decode A, a
    live migration and decode B, all on the card."""
    import numpy as np

    from tpurpc_torch.obs import flight, odyssey, tracing
    from tpurpc_torch.rpc.channel import Channel
    from tpurpc_torch.serving import DisaggClient, migrate, serve_decode
    from tpurpc_torch.tools.odyssey_smoke import spawn_prefill, stop_prefill
    from tpurpc_torch.torchshim.generate import (ToyDecodeModel,
                                                 reference_decode)

    odyssey.reset()
    tracing.force(True)
    t0 = time.monotonic_ns()
    decodes = [serve_decode(ToyDecodeModel(device=dev, step_delay_s=0.01),
                            kv_blocks=96, block_bytes=512, kv_kind="shm",
                            name=name) for name in ("odyA", "odyB")]
    (a_srv, a_port, a_sched, a_state), (_b, b_port, b_sched, b_state) = \
        decodes
    a_addr, b_addr = f"127.0.0.1:{a_port}", f"127.0.0.1:{b_port}"
    b_ch = Channel(b_addr)
    child = p_ch = cli = None
    try:
        child, p_port, p_dev = spawn_prefill(a_addr)
        check(p_dev.startswith(dev.type), f"odyssey (b): the prefill child "
              f"runs on {p_dev}, not {dev}")
        p_ch = Channel(f"127.0.0.1:{p_port}")
        cli = DisaggClient(p_ch, a_addr, account=ODY_ACCOUNT)
        prompt = np.arange(ODY_PROMPT, dtype=np.int32) % 97
        ctx = tracing.TraceContext(int.from_bytes(os.urandom(8), "big"), 1)
        pairs = []
        with tracing.use(ctx):
            it = cli.generate_with_meta(prompt, max_tokens=ODY_TOKENS,
                                        timeout=60)
            for _ in range(ODY_MIG_AT):
                pairs.append(next(it))
            moved = migrate(a_state, b_ch, b_addr)
            pairs.extend(it)
        check(moved == (1, 0), f"odyssey (b): migrate gave {moved}")
        _check_stream("odyssey (b)", pairs, [int(t) for t in prompt],
                      ODY_TOKENS)
        status, _h, body = _http(a_port, "/healthz?json=1")
        hz = json.loads(body)
        lines = [ln for ln in hz["lines"]
                 if ln.startswith(("gen odyA:", "kv odyA:"))]
        check(status == 200 and len(lines) == 2,
              f"odyssey (b): /healthz?json=1 on decode A {status} "
              f"{hz['lines']}")
        doc = odyssey.journey([a_addr, f"127.0.0.1:{p_port}"], ctx.trace_id)
        doc = json.loads(json.dumps(doc))
        meta = doc["otherData"]
        spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
        tid = f"{ctx.trace_id:016x}"
        names = {e["name"] for e in spans}
        lanes = {e["pid"] for e in spans}
        check(meta["lanes"] >= 2 and not meta["unanchored"]
              and len(lanes) >= 2
              and {"seq-ship", "seq-decode", "seq-migrate"} <= names
              and all(e["args"]["trace_id"] == tid for e in spans),
              f"odyssey (b): journey {meta}, spans {sorted(names)} in "
              f"{len(lanes)} lanes")
        deadline = time.monotonic() + ODY_WAIT_S
        while time.monotonic() < deadline:
            seq = odyssey.seq_doc({"account": ODY_ACCOUNT})
            if len(seq["recent"]) >= 2 and not seq["live"]:
                break
            time.sleep(0.01)
        rows = {r["outcome"]: r for r in seq["recent"]}
        mig = [e for e in flight.snapshot(since_ns=t0)
               if e["entity"] == "disagg:odyA"
               and e["event"] == "migration-begin"]
        check(len(mig) == 1, f"odyssey (b): {len(mig)} migration-begin "
              "edges on decode A")
        entries = mig[0]["a2"]
        src, dst = rows.get("migrated"), rows.get("retire")
        check(src is not None and dst is not None
              and src["migrations"] == 1 and dst["migrations"] == 0
              and src["shipped_bytes"] == 16 * (ODY_PROMPT + 1 + entries)
              and dst["shipped_bytes"] == 16 * entries
              and src["tokens"] + dst["tokens"] == ODY_TOKENS - 1
              and src.get("trace_id") == dst.get("trace_id") == tid,
              f"odyssey (b): ledgers {rows}, the hop moved {entries} "
              "entries")
    finally:
        for c in (cli, p_ch):
            if c is not None:
                c.close()
        if child is not None:
            stop_prefill(child)
        tracing.force(None)
        for srv, _p, sched, state in decodes:
            srv.stop(grace=0)
            sched.close()
            state.close()
            state.mgr.close()
        b_ch.close()
    out = {"lanes": meta["lanes"], "spans": sorted(names),
           "entries": entries, "source": src, "target": dst}
    print(f"odyssey (b): {ODY_TOKENS} tokens exact across the prefill child "
          f"({p_dev}) -> decode A -> migration after {ODY_MIG_AT} -> decode "
          f"B; one trace id in {meta['lanes']} anchored lanes with spans "
          f"{sorted(names)}; the source ledger settled migrated: "
          f"{src['shipped_bytes']} bytes shipped = 16 x ({ODY_PROMPT + 1} "
          f"handoff + {entries} hop) entries, the target's "
          f"{dst['shipped_bytes']} = 16 x {entries}; healthz {lines} "
          f"({card})", flush=True)
    return out


def _ody_round(port, prompts, label):
    """One round: a stream per prompt at once, each exact."""
    from tpurpc_torch.rpc.channel import Channel
    from tpurpc_torch.serving import GenerationClient

    out, errs = {}, []

    def go(i, prompt):
        try:
            with Channel(f"127.0.0.1:{port}") as ch:
                out[i] = list(GenerationClient(ch).generate_with_meta(
                    prompt, max_tokens=ODY_ROUND_TOKENS, timeout=60))
        except BaseException as exc:  # noqa: BLE001 - reported below
            errs.append(repr(exc))

    threads = [threading.Thread(target=go, args=(i, p), daemon=True)
               for i, p in enumerate(prompts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    check(not errs and len(out) == len(prompts), f"{label}: {errs}")
    for i, p in enumerate(prompts):
        _check_stream(label, out[i], p, ODY_ROUND_TOKENS)


def _ody_stall(dev, card) -> dict:
    """(c): one decode step held STALL_S in synchronized card work trips
    the watchdog at ``decode-step`` and fires an ITL objective, which fast
    rounds resolve."""
    import numpy as np
    import torch

    from tpurpc_torch.obs import odyssey, slo, watchdog
    from tpurpc_torch.serving import serve_generation
    from tpurpc_torch.torchshim.generate import ToyDecodeModel

    class Held(ToyDecodeModel):
        """Holds its next ``holds`` steps of ODY_ROUND rows, each STALL_S
        of its own step over the batch's rows on the card, synchronized
        (every stream of the held round then has one long gap). While
        ``gather`` is set, the next prefill waits on it: the rest of a
        round queues meanwhile and joins at one boundary."""

        holds = 0
        gather = None

        def prefill(self, prompts):
            gate, self.gather = self.gather, None
            if gate is not None:
                gate.wait(60)
            return super().prefill(prompts)

        def step(self, states, tokens):
            if self.holds > 0 and len(tokens) >= ODY_ROUND:
                self.holds -= 1
                n, t0 = 0, time.perf_counter()
                while time.perf_counter() - t0 < STALL_S:
                    super().step(states, tokens)
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                    n += 1
                self.reps.append(n)
            return super().step(states, tokens)

    _set_env({"TPURPC_TSDB": None, "TPURPC_TSDB_FINE_S": str(SCRAPE_FINE_S)})
    _fresh_tsdb()
    slo.reset()
    odyssey.reset()
    wd = watchdog.get()
    wd.reset()
    prev = (wd.min_stall_s, wd.sweep_s, wd.mult, wd.enabled)
    wd.min_stall_s, wd.sweep_s, wd.mult, wd.enabled = 0.3, 0.1, 1.0, True
    model = Held(device=dev)
    model.reps = []
    _warm(model)
    srv, port, sched = serve_generation(model, max_batch=MAX_BATCH)
    rng = np.random.default_rng(SEED + 210)
    res = {}
    try:
        _ody_round(port, _gen_prompts(rng, ODY_ROUND, 2, 8),
                   "odyssey (c) warm-up")
        ev = slo.get()
        ev.eval_s = SLO_EVAL_S
        obj = slo.declare(ODY_SLO, itl_ms=ODY_ITL_MS,
                          token_target_pct=ODY_ITL_TARGET,
                          windows=SLO_WINDOWS)
        st = obj.tracks["itl"]
        time.sleep(2 * SLO_WINDOWS[0][1])  # a window of healthy samples
        check(st.state == "ok", f"odyssey (c): {st.state} before the stall")
        # one held step under a round of streams, all in its batch
        gather = threading.Event()
        model.holds, model.gather = 1, gather
        held_err = []

        def held_round():
            try:
                _ody_round(port, _gen_prompts(rng, ODY_ROUND, 2, 8),
                           "odyssey (c) held round")
            except BaseException as exc:  # noqa: BLE001 - checked below
                held_err.append(repr(exc))

        t = threading.Thread(target=held_round, daemon=True)
        t.start()
        deadline = time.monotonic() + 60
        while sched.queue_depth() < ODY_ROUND - 1 \
                and time.monotonic() < deadline:
            time.sleep(0.005)
        gather.set()
        diag = None
        deadline = time.monotonic() + 10
        while diag is None and time.monotonic() < deadline:
            time.sleep(0.05)
            diag = next((d for d in wd.active() if d["kind"] == "server"
                         and d["method"] == "/tpurpc.Generate/Generate"),
                        None)
        check(diag is not None and diag["stage"] == "decode-step",
              f"odyssey (c): the held step's diagnosis {diag}")
        live = json.loads(_http(port, "/debug/diagnose")[2])
        t.join(120)
        check(not t.is_alive() and not held_err,
              f"odyssey (c): the held round {held_err or 'hung'}")
        top = live["hypotheses"][0]["cause"] if live["hypotheses"] else None
        check(top == "decode-step", f"odyssey (c): /debug/diagnose ranked "
              f"{[(h['cause'], h['confidence']) for h in live['hypotheses']]}")
        p99_held = odyssey.itl_p99_us()
        deadline = time.monotonic() + ODY_WAIT_S
        while st.state != "firing" and time.monotonic() < deadline:
            time.sleep(0.05)
        check(st.state == "firing", f"odyssey (c): the ITL objective is "
              f"{st.state} {ODY_WAIT_S} s after the held step (rolling ITL "
              f"p99 {p99_held} us)")
        rounds = 0
        deadline = time.monotonic() + 2 * ODY_WAIT_S
        while st.state != "ok" and time.monotonic() < deadline:
            _ody_round(port, _gen_prompts(rng, ODY_ROUND, 2, 8),
                       f"odyssey (c) recovery round {rounds}")
            rounds += 1
        check(st.state == "ok", f"odyssey (c): the ITL objective is "
              f"{st.state} after {rounds} fast rounds")
        seen = [(h["from"], h["to"]) for h in ev.doc()["history"]
                if h["objective"] == ODY_SLO]
        fired = seen.index(("pending", "firing")) if (
            "pending", "firing") in seen else -1
        check(fired > 0 and ("ok", "pending") in seen[:fired]
              and ("firing", "ok") in seen[fired:],
              f"odyssey (c): the objective went {seen}")
        res = {"stage": diag["stage"], "top": top,
               "confidence": live["hypotheses"][0]["confidence"],
               "reps": list(model.reps), "p99_held_us": p99_held,
               "states": seen, "rounds": rounds,
               "p99_after_us": odyssey.itl_p99_us()}
    finally:
        wd.min_stall_s, wd.sweep_s, wd.mult, wd.enabled = prev
        slo.reset()
        srv.stop(grace=0)
        sched.close()
        _set_env({"TPURPC_TSDB_FINE_S": None})
        _fresh_tsdb()
    print(f"odyssey (c): one decode step held {STALL_S} s "
          f"({res['reps']} synchronized steps of the batch on the card) "
          f"tripped the watchdog at {res['stage']}; /debug/diagnose ranks "
          f"{res['top']} first (confidence {res['confidence']}); the rolling "
          f"ITL p99 read {res['p99_held_us']} us and the objective "
          f"{ODY_SLO} (ITL p99 under {ODY_ITL_MS} ms for {ODY_ITL_TARGET} % "
          f"of the samples, windows {SLO_WINDOWS}) went {res['states']}, "
          f"resolved after {res['rounds']} rounds of {ODY_ROUND} x "
          f"{ODY_ROUND_TOKENS} tokens (p99 {res['p99_after_us']} us) "
          f"({card})", flush=True)
    return res


def odyssey_plane(dev, card) -> dict:
    """Phase 21: the generation plane's observability on the card
    (docstring of this file). Returns each part's readings and launches."""
    from tpurpc_torch.obs import watchdog
    from tpurpc_torch.ops import ring_scatter as rs_mod
    from tpurpc_torch.ops import ring_window as rw_mod

    t_phase = time.perf_counter()
    res = {}
    try:
        for key, fn in (("a", _ody_colocated), ("b", _ody_journey),
                        ("c", _ody_stall)):
            t = time.perf_counter()
            rs_mod.launches = rw_mod.launches = 0
            with _Landings() as land:
                res[key] = fn(dev, card)
            res[key]["launches"] = {"ring_scatter": rs_mod.launches,
                                    "ring_window": rw_mod.launches}
            check(res[key]["launches"] == land.launches(),
                  f"odyssey ({key}): launched {res[key]['launches']}, the "
                  f"landings give {land.launches()}")
            print(f"odyssey ({key}) took {time.perf_counter() - t} s; "
                  f"launches {res[key]['launches']} ({len(land.recs)} "
                  f"device-ring landings)", flush=True)
    finally:
        watchdog.get().stop()
    print(f"odyssey: phase 21 took {time.perf_counter() - t_phase} s "
          f"({card})", flush=True)
    return res


# -- phase 22 -----------------------------------------------------------------

#: phase 22 (a): alternating turns, distinct requests a turn (each a full
#: [8,128] bucket), the pipeline's depth
NP_TURNS, NP_REQUESTS, NP_DEPTH = 4, 16, 8
#: phase 22 (b): 64-byte echoes, turns of calls (warm-up calls not kept)
NP_ECHO_TURNS, NP_ECHO_CALLS, NP_ECHO_WARM = 10, 200, 20
#: phase 22 (c): alternating turns of a stream of 4 MiB float32 tensors
NP_STREAM_TURNS, NP_STREAM_MSGS = 4, 16
NP_STREAM_SHAPE = (1024, 1024)


def _np_platform(name: str, **env) -> None:
    from tpurpc_torch.utils import config

    _set_env({"GRPC_PLATFORM_TYPE": name, "TPURPC_NATIVE_FAST_UNARY": None,
              **env})
    config.set_config(None)


def _np_python_calls(srv, before) -> int:
    """Calls the server's Python plane started since ``before``."""
    return srv.call_counters.started - before


def _np_check_native(label, srv, calls0, ch=None, adopted0=0) -> None:
    """The native plane carried ``label``: the server adopted, its Python
    plane started no call and holds no connection, and the channel (if
    any) dialed its fast path and no Python-transport connection."""
    dp = srv._native_dp
    check(dp is not None, f"{label}: the server did not start its native "
          f"data plane")
    check(dp.adopted > adopted0, f"{label}: no connection adopted")
    check(_np_python_calls(srv, calls0) == 0,
          f"{label}: {_np_python_calls(srv, calls0)} calls reached the "
          f"server's Python plane")
    check(not srv._connections, f"{label}: the server's Python plane holds "
          f"{len(srv._connections)} connections")
    if ch is not None:
        check(ch._native_ch is not None, f"{label}: no native fast path")
        check(all(sc._conn is None for sc in ch._subchannels),
              f"{label}: a Python-transport connection was dialed")


def _np_serving(dev, card, turns=NP_TURNS, requests=NP_REQUESTS,
                cfg=None) -> dict:
    """Phase 22 (a): the transformer behind an adopting server."""
    import numpy as np
    import torch

    from tpurpc_torch.models.transformer import (Transformer,
                                                 TransformerConfig,
                                                 make_serve_fn)
    from tpurpc_torch.parallel import build_mesh
    from tpurpc_torch.rpc.channel import Channel
    from tpurpc_torch.rpc.native_client import NativeChannel
    from tpurpc_torch.rpc.server import Server
    from tpurpc_torch.torchshim.service import TensorClient, add_tensor_method

    cfg = cfg or TransformerConfig()
    mesh = build_mesh(1, device=dev)
    model = Transformer(cfg, mesh,
                        generator=torch.Generator().manual_seed(SEED))
    serve = make_serve_fn(model)

    def generate(tree):
        # a pageable .to(dev) finishes reading the request before the
        # handler returns and the C loop frees the message
        with torch.inference_mode():
            return {"logits": serve({"tokens": tree["tokens"].to(dev)})[
                "logits"].cpu()}

    rng = np.random.default_rng(SEED + 22)
    rows = [torch.from_numpy(rng.integers(0, cfg.vocab, (MAX_BATCH, TF_SEQ),
                                          dtype=np.int32))
            for _ in range(requests)]
    _np_platform("RDMA_BPEV")
    servers = {}
    for plane, opt in (("python", False), ("native", None)):
        srv = Server(max_workers=WORKERS, native_dataplane=opt)
        add_tensor_method(srv, "Generate", generate)
        srv.start()
        servers[plane] = (srv, srv.add_insecure_port("127.0.0.1:0"))
    check(servers["python"][0]._native_dp is None,
          "native (a): the Python-plane server adopted")
    want = {}
    rates = {"python": [], "native": [], "python_pipe": [],
             "native_pipe": []}

    def same(label, got):
        for i, t in enumerate(got):
            if i not in want:
                want[i] = t["logits"]
            check(torch.equal(t["logits"], want[i]),
                  f"native (a) {label}: request {i}'s reply differs from "
                  f"its first Python-plane reply")

    def run(plane, profile=False):
        srv, port = servers[plane]
        calls0 = srv.call_counters.started
        adopted0 = srv._native_dp.adopted if srv._native_dp else 0
        _set_env({"TPURPC_NATIVE_FAST_UNARY":
                  "0" if plane == "python" else None})
        with Channel(f"127.0.0.1:{port}") as ch:
            cli = TensorClient(ch)
            cli.call("Generate", {"tokens": rows[0]}, timeout=120)  # warm
            t0 = time.perf_counter()
            seq = [cli.call("Generate", {"tokens": r}, timeout=120)
                   for r in rows]
            rate = len(rows) / (time.perf_counter() - t0)
            if plane == "native":
                _np_check_native("native (a) channel", srv, calls0, ch,
                                 adopted0)
            else:
                check(ch._native_ch is None,
                      "native (a): the Python-plane channel dialed natively")
            pl_ch = (NativeChannel("127.0.0.1", port) if plane == "native"
                     else ch)
            try:
                pl = TensorClient(pl_ch).pipeline("Generate", depth=NP_DEPTH)
                prof = None
                if profile:
                    prof = torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA])
                    prof.__enter__()
                t0 = time.perf_counter()
                futs = [pl.call_async({"tokens": r}, timeout=120)
                        for r in rows]
                piped = [f.result(120) for f in futs]
                window = time.perf_counter() - t0
                if prof is not None:
                    prof.__exit__(None, None, None)
            finally:
                if pl_ch is not ch:
                    pl_ch.close()
        _set_env({"TPURPC_NATIVE_FAST_UNARY": None})
        if plane == "native":
            check(_np_python_calls(srv, calls0) == 0,
                  "native (a): a pipelined call reached the Python plane")
        else:
            check(_np_python_calls(srv, calls0) == 2 * len(rows) + 1,
                  "native (a): the Python plane missed calls")
        same(f"{plane} one at a time", seq)
        same(f"{plane} pipelined", piped)
        busy = None
        if prof is not None:
            busy = device_busy_ms(prof) / (window * 1e3)
        return rate, len(rows) / window, busy

    out = {}
    try:
        for turn in range(turns):
            order = ("python", "native") if turn % 2 == 0 else (
                "native", "python")
            for plane in order:
                rate, pipe, _ = run(plane)
                rates[plane].append(rate)
                rates[plane + "_pipe"].append(pipe)
                print(f"native (a) turn {turn} {plane} plane: "
                      f"{rate} requests/s one at a time, {pipe} requests/s "
                      f"pipelined (depth {NP_DEPTH}) ({card})", flush=True)
        if dev.type == "cuda":
            _, pipe, busy = run("native", profile=True)
            out["busy"] = busy
            print(f"native (a) profiled native window: card busy share "
                  f"{busy} at {pipe} requests/s ({card})", flush=True)
    finally:
        for srv, _ in servers.values():
            srv.stop()
    for key, vals in rates.items():
        out[key] = sorted(vals)[len(vals) // 2]
    print(f"native (a): median requests/s over {turns} turns: Python plane "
          f"{out['python']} one at a time, {out['python_pipe']} pipelined; "
          f"native plane {out['native']} and {out['native_pipe']}; every "
          f"reply bit-equal ({card})", flush=True)
    return out


def _np_echo(card, turns=NP_ECHO_TURNS, calls=NP_ECHO_CALLS,
             warm=NP_ECHO_WARM) -> dict:
    """Phase 22 (b): 64-byte unary echoes, three legs in alternating turns,
    each turn on a fresh server and channel."""
    from tpurpc_torch.rpc.channel import Channel
    from tpurpc_torch.rpc.server import Server
    from tpurpc_torch.rpc.server import unary_unary_rpc_method_handler as uu

    body = bytes(range(64))
    legs = {"python_ring": ("RDMA_BPEV", False, False),
            "native": ("RDMA_BPEV", None, True),
            "tcp": ("TCP", None, True)}
    lat = {leg: [] for leg in legs}
    for turn in range(turns):
        order = list(legs) if turn % 2 == 0 else list(reversed(legs))
        for leg in order:
            plat, opt, allow = legs[leg]
            _np_platform(plat)
            srv = Server(max_workers=4, native_dataplane=opt)
            # inline: the C loop runs it on its poller thread and the
            # Python plane on the connection's reader (no pool hop)
            srv.add_method("/np.S/Echo", uu(lambda r, c: bytes(r),
                                            inline=True))
            port = srv.add_insecure_port("127.0.0.1:0")
            srv.start()
            calls0 = srv.call_counters.started
            try:
                with Channel(f"127.0.0.1:{port}") as ch:
                    mc = ch.unary_unary("/np.S/Echo", tpurpc_native=allow)
                    for _ in range(warm):
                        check(bytes(mc(body, timeout=30)) == body,
                              f"native (b) {leg}: a bad echo")
                    for _ in range(calls):
                        t0 = time.perf_counter()
                        got = mc(body, timeout=30)
                        lat[leg].append(time.perf_counter() - t0)
                        check(bytes(got) == body,
                              f"native (b) {leg}: a bad echo")
                    if leg == "native":
                        _np_check_native("native (b)", srv, calls0, ch)
                    else:
                        check(ch._native_ch is None and
                              _np_python_calls(srv, calls0)
                              == calls + warm,
                              f"native (b) {leg}: not on the Python plane")
            finally:
                srv.stop()
    out = {}
    for leg, xs in lat.items():
        xs = sorted(xs)
        out[leg] = {"p50_us": xs[len(xs) // 2] * 1e6,
                    "p99_us": xs[int(len(xs) * 0.99)] * 1e6, "n": len(xs)}
        print(f"native (b) {leg}: 64-byte echo p50 {out[leg]['p50_us']} us, "
              f"p99 {out[leg]['p99_us']} us over {len(xs)} calls in {turns} "
              f"turns ({card})", flush=True)
    return out


def _np_echo_both(dev, card, **kw) -> dict:
    """Phase 22 (b) in this process, whose earlier phases left their
    threads (samplers, pollers, servers) contending for the interpreter,
    then, on a card, alone in a fresh one (``--native-echo``)."""
    out = _np_echo(card, **kw)
    if dev.type != "cuda":
        print("native (b) in a fresh process: not measured (no card)",
              flush=True)
        return out
    here = os.path.abspath(__file__)
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, here, "--native-echo",
         str(kw.get("turns", NP_ECHO_TURNS))],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(here))
    check(child.returncode == 0, f"native (b) fresh process failed: "
          f"{child.stderr[-2000:]}")
    fresh = json.loads(child.stdout.strip().splitlines()[-1])
    for leg in ("python_ring", "native", "tcp"):
        check(fresh[leg]["n"] > 0, f"native (b) fresh: no {leg} calls")
    out["fresh"] = {leg: fresh[leg] for leg in ("python_ring", "native",
                                                "tcp")}
    print(f"native (b) in a fresh process ({time.perf_counter() - t0} s with "
          f"its start): " + ", ".join(
              f"{leg} p50 {v['p50_us']} us p99 {v['p99_us']} us"
              for leg, v in out["fresh"].items()) + f" ({card})", flush=True)
    return out


def _np_stream(dev, card, turns=NP_STREAM_TURNS, msgs=NP_STREAM_MSGS,
               shape=NP_STREAM_SHAPE) -> dict:
    """Phase 22 (c): a 4 MiB float32 tensor stream, native against Python
    plane in alternating turns, each tensor summed on the card; then the
    same tensors as unary calls on the native path."""
    import numpy as np
    import torch

    from tpurpc_torch.rpc import native_client as nc
    from tpurpc_torch.rpc.channel import Channel
    from tpurpc_torch.rpc.server import Server
    from tpurpc_torch.torchshim.service import TensorClient, add_tensor_method

    rng = np.random.default_rng(SEED + 23)
    base = rng.standard_normal(shape).astype(np.float32)
    xs = [torch.from_numpy(base + np.float32(i)) for i in range(msgs)]
    nbytes = xs[0].numel() * xs[0].element_size()

    def to_card_sum(t):
        # the pageable copy completes before the handler returns
        return t.to(dev).double().sum().cpu()

    def sink(trees):
        for tree in trees:
            yield {"i": tree["i"].clone(), "s": to_card_sum(tree["x"])}

    def gen():
        for i, x in enumerate(xs):
            yield {"i": torch.tensor([i]), "x": x}

    _np_platform("RDMA_BPEV")
    servers = {}
    for plane, opt in (("python", False), ("native", None)):
        srv = Server(max_workers=8, native_dataplane=opt)
        add_tensor_method(srv, "Sink", sink, kind="stream_stream")
        add_tensor_method(srv, "Sum", lambda t: {"s": to_card_sum(t["x"])})
        srv.start()
        servers[plane] = (srv, srv.add_insecure_port("127.0.0.1:0"))
    gbps = {"python": [], "native": []}
    want = None
    deltas = []
    out = {}
    chans = {}
    try:
        # one channel a plane for every turn, warmed by a stream of two
        # (the Python plane's rendezvous arms in its first exchanges)
        for plane, (srv, port) in servers.items():
            chans[plane] = Channel(f"127.0.0.1:{port}")
            list(TensorClient(chans[plane]).duplex(
                "Sink", ({"i": torch.tensor([i]), "x": xs[i]}
                         for i in range(2)), timeout=300,
                native=plane == "native"))
        for turn in range(turns):
            order = ("python", "native") if turn % 2 == 0 else (
                "native", "python")
            for plane in order:
                srv, port = servers[plane]
                ch = chans[plane]
                calls0 = srv.call_counters.started
                c0 = nc.rdv_counters()
                cli = TensorClient(ch)
                t0 = time.perf_counter()
                replies = list(cli.duplex("Sink", gen(), timeout=300,
                                          native=plane == "native"))
                dt = time.perf_counter() - t0
                if plane == "native":
                    _np_check_native("native (c) stream", srv, calls0, ch)
                c1 = nc.rdv_counters()
                delta = {k: c1[k] - c0[k] for k in c1}
                sums = [r["s"].item() for r in replies]
                idx = [r["i"].item() for r in replies]
                check(idx == list(range(msgs)),
                      f"native (c) {plane}: replies out of order {idx}")
                if want is None:
                    want = sums
                check(sums == want, f"native (c) {plane} turn {turn}: sums "
                      f"{sums} differ from {want}")
                if plane == "native":
                    deltas.append(delta)
                    # the stream's tensor writes ride the send lease, framed
                    # in the ring: the C loop copies them, nothing one-sided
                    check(delta["rdv_sent"] == 0
                          and delta["host_copy_bytes"] >= msgs * nbytes,
                          f"native (c): the stream's ledger {delta}")
                else:
                    check(_np_python_calls(srv, calls0) == 1,
                          "native (c): the Python-plane stream missed")
                rate = msgs * nbytes / dt / 1e9
                gbps[plane].append(rate)
                print(f"native (c) turn {turn} {plane} plane: {rate} GB/s, "
                      f"{msgs} x {nbytes} bytes; library ledger delta "
                      f"{delta} ({card})", flush=True)
        # the same tensors as unary calls on the native path: each request
        # passes the C loop one buffer and rendezvous above the threshold
        srv, port = servers["native"]
        calls0 = srv.call_counters.started
        with Channel(f"127.0.0.1:{port}") as ch:
            cli = TensorClient(ch)
            # one warm-up call: the connection's rendezvous plane arms in
            # its first exchanges, and a message before that goes framed
            cli.call("Sum", {"x": xs[0][:4]}, timeout=120)
            c0 = nc.rdv_counters()
            t0 = time.perf_counter()
            unary = [cli.call("Sum", {"x": x}, timeout=120)["s"].item()
                     for x in xs]
            dt = time.perf_counter() - t0
            c1 = nc.rdv_counters()
            _np_check_native("native (c) unary", srv, calls0, ch)
        udelta = {k: c1[k] - c0[k] for k in c1}
        check(unary == want, f"native (c) unary: sums {unary} differ")
        min_kb = int(os.environ.get("TPURPC_RENDEZVOUS_MIN_KB", "256"))
        bulk = sum(1 for _ in xs if nbytes >= min_kb << 10)
        check(udelta["rdv_sent"] == bulk and udelta["rdv_recv"] == bulk,
              f"native (c) unary: rdv_sent/rdv_recv {udelta} against "
              f"{bulk} messages above {min_kb} KiB")
        out["unary_gbps"] = msgs * nbytes / dt / 1e9
        out["unary_rdv"] = udelta
        print(f"native (c) unary on the native path: "
              f"{out['unary_gbps']} GB/s; library ledger delta {udelta} "
              f"({card})", flush=True)
    finally:
        for ch in chans.values():
            ch.close()
        for srv, _ in servers.values():
            srv.stop()
    for plane, vals in gbps.items():
        out[plane] = sorted(vals)[len(vals) // 2]
    out["stream_rdv"] = deltas
    print(f"native (c): median GB/s over {turns} turns: Python plane "
          f"{out['python']}, native plane {out['native']} ({card})",
          flush=True)
    return out


def native_plane(dev, card, **kw) -> dict:
    """Phase 22: the native plane on ``RDMA_BPEV`` (docstring of this
    file). Returns each part's readings and launches (none expected: no
    payload lands in a device ring off ``TPU``)."""
    from tpurpc_torch.core import _native
    from tpurpc_torch.ops import ring_scatter as rs_mod
    from tpurpc_torch.ops import ring_window as rw_mod
    from tpurpc_torch.rpc import native_client as nc

    t_phase = time.perf_counter()
    t = time.perf_counter()
    lib = _native.load()
    check(lib is not None, f"native: the port's library did not build or "
          f"load from tpurpc_torch/native ({_native._lib_path()})")
    nc._load()
    print(f"native: library {_native._lib_path()} loaded in "
          f"{time.perf_counter() - t} s", flush=True)
    saved = {k: os.environ.get(k) for k in
             ("GRPC_PLATFORM_TYPE", "TPURPC_NATIVE_FAST_UNARY",
              "TPURPC_TORCH_DEVICE")}
    _set_env({"TPURPC_TORCH_DEVICE": str(dev)})
    res = {}
    try:
        for key, fn in (("a", lambda: _np_serving(dev, card, **kw.get(
                            "a", {}))),
                        ("b", lambda: _np_echo_both(dev, card, **kw.get(
                            "b", {}))),
                        ("c", lambda: _np_stream(dev, card, **kw.get(
                            "c", {})))):
            t = time.perf_counter()
            rs_mod.launches = rw_mod.launches = 0
            res[key] = fn()
            res[key]["launches"] = {"ring_scatter": rs_mod.launches,
                                    "ring_window": rw_mod.launches}
            check(res[key]["launches"] == {"ring_scatter": 0,
                                           "ring_window": 0},
                  f"native ({key}): launched {res[key]['launches']} with no "
                  f"device-ring landing")
            print(f"native ({key}) took {time.perf_counter() - t} s",
                  flush=True)
    finally:
        _set_env(saved)
        from tpurpc_torch.utils import config

        config.set_config(None)
    print(f"native: phase 22 took {time.perf_counter() - t_phase} s "
          f"({card})", flush=True)
    return res


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", action="store_true",
                    help="run phases 1 and 2 only; end with the kernels line")
    ap.add_argument("--ctrl-profile", type=int, metavar="TURNS",
                    help="build the kernels, then run phase 15 (a) alone in "
                         "TURNS turns and end with its summary")
    ap.add_argument("--pump-profile", type=int, metavar="TURNS",
                    help="build the kernels, run phase 3, then phase 17 (a) "
                         "alone in TURNS turns and end with its summary")
    ap.add_argument("--native-echo", type=int, metavar="TURNS",
                    help="run phase 22 (b) alone in TURNS turns in this "
                         "fresh process and end with its summary")
    args = ap.parse_args()
    kernels_only = args.kernels
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import torch
    except ImportError as exc:
        fail(f"torch not importable: {exc}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a card")
    if not os.path.isdir(os.path.join(here, "tpurpc_torch")):
        fail("tpurpc_torch not found beside chip_smoke.py: run from a checkout")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)

    card = card_line()
    if args.native_echo:
        res = _np_echo(card, turns=args.native_echo)
        print(json.dumps(dict(res, card=card, turns=args.native_echo)),
              flush=True)
        return
    build_kernels()
    if args.ctrl_profile:
        res = _ctrl_turns(dev, card, sink_payloads(), CTRL_ROUNDS, RING,
                          turns=args.ctrl_profile)
        print(json.dumps(dict(res["summary"], card=card,
                              turns=args.ctrl_profile, rounds=CTRL_ROUNDS)),
              flush=True)
        return
    if args.pump_profile:
        main_path(dev)
        res = pump_profile(dev, card, args.pump_profile)
        print(json.dumps(dict(res, card=card, turns=args.pump_profile,
                              calls=PUMP_CALLS,
                              ctrl_ring=os.environ.get("TPURPC_CTRL_RING"))),
              flush=True)
        return
    err, timings = check_kernels(dev)
    if kernels_only:
        launches = {"ring_scatter": None, "ring_window": None}
        stream = tf_launches = train_launches = gen_launches = None
        fleet_launches = h2_launches = cp_launches = tls_launches = None
        aio_launches = lb_launches = tp_launches = lc_launches = None
        pump_launches = obs_launches = hook_launches = None
        scrape_launches = ody_launches = np_launches = None
    else:
        from tpurpc_torch.ops import ring_scatter as rs_mod
        from tpurpc_torch.ops import ring_window as rw_mod

        saved_env = {k: os.environ.get(k) for k in RING_ENV}
        launches = main_path(dev)
        fanin_serving(dev, card, saved_env)
        stream = sink_stream(dev, card)
        # phase 6 takes neither kernel (fan-in decodes on the host, as the
        # reference's example does); its launches are counted all the same
        rs_mod.launches = rw_mod.launches = 0
        t0 = time.perf_counter()
        transformer_serving(dev, card)
        tf_launches = {"ring_scatter": rs_mod.launches,
                       "ring_window": rw_mod.launches}
        print(f"transformer: kernel launches in phase 6 {tf_launches}; "
              f"phase 6 took {time.perf_counter() - t0} s", flush=True)
        # phase 7 takes neither kernel either (training lands no payload
        # in a ring); its launches are counted all the same
        rs_mod.launches = rw_mod.launches = 0
        t0 = time.perf_counter()
        transformer_training(dev, card)
        train_launches = {"ring_scatter": rs_mod.launches,
                          "ring_window": rw_mod.launches}
        print(f"training: kernel launches in phase 7 {train_launches}; "
              f"phase 7 took {time.perf_counter() - t0} s", flush=True)
        # phase 8 takes neither kernel either (token trees are framed and
        # the step model's state never enters a ring); counted all the same
        rs_mod.launches = rw_mod.launches = 0
        t0 = time.perf_counter()
        generation_serving(dev, card)
        gen_launches = {"ring_scatter": rs_mod.launches,
                        "ring_window": rw_mod.launches}
        print(f"generation: kernel launches in phase 8 {gen_launches}; "
              f"phase 8 took {time.perf_counter() - t0} s", flush=True)
        # phase 9: (b) launches both kernels inside its worker processes,
        # which count them there; this process launches neither
        rs_mod.launches = rw_mod.launches = 0
        t0 = time.perf_counter()
        fleet = fleet_serving(dev, card)
        fleet_launches = fleet["b"]["launches"]
        check((rs_mod.launches, rw_mod.launches) == (0, 0),
              "fleet: the smoke process itself launched a kernel")
        print(f"fleet: kernel launches in phase 9's workers {fleet_launches}; "
              f"phase 9 took {time.perf_counter() - t0} s ({card})",
              flush=True)
        # phase 10 takes neither kernel (h2 requests decode on the host, in
        # both packages); counted all the same
        rs_mod.launches = rw_mod.launches = 0
        t0 = time.perf_counter()
        h2_serving(dev, card)
        h2_launches = {"ring_scatter": rs_mod.launches,
                       "ring_window": rw_mod.launches}
        print(f"h2: kernel launches in phase 10 {h2_launches}; phase 10 took "
              f"{time.perf_counter() - t0} s ({card})", flush=True)
        # phase 11: both kernels on every part, counted per part inside
        cp_launches = call_plane(dev, card)
        # phase 12: (a) both kernels, plaintext and mTLS; (b) and (c) none
        tls_launches = tls_plane(dev, card)
        # phase 13: both kernels on every part, counted per part inside
        aio_launches = aio_plane(dev, card)
        # phase 14: both kernels on every part, counted per part and per
        # server inside
        lb_launches = lookaside_plane(dev, card)
        # phase 15: (a) per round of the device-ring leg, (b) per server,
        # (c) in the spawned server process; (d) launches neither
        tp_launches = transport_plane(dev, card)
        # phase 16: every part's launches as its landings' offsets give;
        # (b)'s inproc leg has no ring and launches neither
        lc_launches = lifecycle_plane(dev, card)
        # phase 17: every part's launches as its landings' offsets give;
        # (c) per round of the device-ring leg, pump on and off
        pump_launches = pump_plane(dev, card)
        # phase 18: (a) per server as their rings' offsets give, (b) one
        # unwrapped landing, (c) per side as the landings' offsets give
        obs_launches = obs_plane(dev, card)
        # phase 19: (a) and (b) as their landings' offsets give, (c) the
        # slow call's landing, (d) per side as the landings' offsets give,
        # (e) none (no device-ring landing)
        hook_launches = obs_hooks_plane(dev, card)
        # phase 20: (a) and (b) as their landings' offsets give, (c) in the
        # fleet's worker processes (this process launches neither there)
        scrape_launches = scrape_plane(dev, card)
        # phase 21 lands no payload in a device ring (token trees are
        # framed, KV ships over block grants): its launches are counted
        # per part all the same, against its landings
        ody_launches = odyssey_plane(dev, card)
        # phase 22, the native plane off TPU: no device-ring landing, no
        # launch; counted per part all the same
        np_launches = native_plane(dev, card)

    sources = {"ring_scatter": "tpurpc/ops/ring_scatter.py:133",
               "ring_window": "tpurpc/ops/ring_window.py:138"}
    kernels = []
    for name in ("ring_scatter", "ring_window"):
        t = timings[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"tpurpc_torch/csrc/{name}.cu",
            "replaces": sources[name], "launches": launches[name],
            "max_abs_err": err[name],
            "ms": t["aligned_kernel"][0], "ms_min": t["aligned_kernel"][1],
            "ms_max": t["aligned_kernel"][2],
            "skewed_ms": t["skewed_kernel"][0],
            "skewed_ms_min": t["skewed_kernel"][1],
            "skewed_ms_max": t["skewed_kernel"][2],
            "plain_ms": t["aligned_plain"][0],
            "skewed_plain_ms": t["skewed_plain"][0],
            "library_ms": t["aligned_library"][0],
            "skewed_library_ms": t["skewed_library"][0],
            "bound_ms": 2 * SPANS["aligned"][1] / HBM_BYTES_PER_MS,
            "skewed_bound_ms": 2 * SPANS["skewed"][1] / HBM_BYTES_PER_MS,
            "bound_by": "bytes",
            "launch_floor_ms": t["tiny_kernel"][0],
            "host_us": t["host_us"][0],
            "plain_host_us": t["plain_host_us"][0],
            # phase 5 (c): launches in each timed round of the stream
            "stream_launches": (None if stream is None else
                                [r[name] for r in stream]),
            # phase 6, the transformer behind fan-in
            "transformer_launches": (None if tf_launches is None else
                                     tf_launches[name]),
            # phase 7, training
            "training_launches": (None if train_launches is None else
                                  train_launches[name]),
            # phase 8, generation serving
            "generation_launches": (None if gen_launches is None else
                                    gen_launches[name]),
            # phase 9 (b), in each fleet worker: [worker 0, worker 1]
            "fleet_launches": (None if fleet_launches is None else
                               fleet_launches[name]),
            # phase 10, the gRPC wire plane
            "h2_launches": (None if h2_launches is None else
                            h2_launches[name]),
            # phase 11, the call plane: (a) retries, (b) hedging [server
            # 0, server 1], (c) the drain
            "call_plane_launches": (None if cp_launches is None else {
                "a": cp_launches["a"][name],
                "b": [p[name] for p in cp_launches["b_per_server"]],
                "c": cp_launches["c"][name]}),
            # phase 12, TLS: (a) over mTLS and in plaintext on the device
            # ring, (b) h2 over TLS, (c) the refusals
            "tls_launches": (None if tls_launches is None else {
                "a": tls_launches["a"][name],
                "a_plaintext": tls_launches["a_plaintext"][name],
                "b": tls_launches["b"][name],
                "c": tls_launches["c"][name]}),
            # phase 13, the asyncio surface on the device ring: (a) the
            # requests at once, then in sequence, (b) one stream
            "aio_launches": (None if aio_launches is None else {
                part: aio_launches[part][name]
                for part in ("a", "a_sequential", "b")}),
            # phase 14 (a), grpclb, and (b), xDS EDS: [server A, server B]
            "lookaside_launches": (None if lb_launches is None else
                                   [p[name] for p in
                                    lb_launches["a_per_server"]]),
            "xds_launches": (None if lb_launches is None else
                             [p[name] for p in lb_launches["b_per_server"]]),
            # phase 15, the transport's head: (a) phase 5's device-ring leg
            # per round with the descriptor ring on and off, (b) with and
            # without gzip, (c) the spawned server over shm and tcp_window
            "transport_launches": (None if tp_launches is None else {
                "a": {"on": [r[name] for r in tp_launches["a"]["1"]],
                      "off": [r[name] for r in tp_launches["a"]["0"]]},
                "b": {way: n[name] for way, n in tp_launches["b"].items()},
                "c": {dom: n[name]
                      for dom, n in tp_launches["c"].items()}}),
            # phase 16, the connection lifecycle: (a) the parked fleet and
            # its wakes, (b) inproc and inline, (c) connectivity, max age
            # and keepalive, (d) the burst and admission
            "lifecycle_launches": (None if lc_launches is None else {
                part: lc_launches[part]["launches"][name]
                for part in "abcd"}),
            # phase 17, the inline pump: (a) per turn with the pump on
            # (auto) and off (0), (b) the pipeline, (c) per round of the
            # device-ring leg on and off, (d) idle servicing, (e) eight
            # threads on one connection
            "pump_launches": (None if pump_launches is None else {
                "a": {mode: [r[name] for r in pump_launches["a"][mode][
                    "launches"]] for mode in ("auto", "0")},
                "b": pump_launches["b"]["launches"][name],
                "c": {mode: [r[name] for r in pump_launches["c"][mode][
                    "launches"]] for mode in ("auto", "0")},
                "d": pump_launches["d"]["launches"][name],
                "e": pump_launches["e"]["launches"][name]}),
            # phase 18: (a) the pipelined drain [server A, server B], (b)
            # the sampled call, (c) the obs plane's turns on and off
            "obs_launches": (None if obs_launches is None else {
                "a": [p[name] for p in obs_launches["a"]["per_server"]],
                "b": obs_launches["b"][name],
                "c": {side: obs_launches["c"]["launches"][side][name]
                      for side in ("on", "off")}}),
            # phase 19, the other planes' obs hooks: (a) the profiled
            # calls, (b) the device-ring stream, (c) the slow call, (d) the
            # turns on and off and the counted turn, (e) the h2 calls
            "obs_hooks_launches": (None if hook_launches is None else {
                "a": hook_launches["a"]["part_launches"][name],
                "b": hook_launches["b"]["part_launches"][name],
                "c": hook_launches["c"]["part_launches"][name],
                "d": {**{side: hook_launches["d"]["launches"][side][name]
                         for side in ("on", "off")},
                      "counted": hook_launches["d"]["counted"]["launches"][
                          name]},
                "e": hook_launches["e"]["part_launches"][name]}),
            # phase 20, history, alerting and the scrape plane: (a) the
            # scraped calls and the tsdb turns, (b) the stall and the
            # recovery, (c) in each fleet worker: [worker 0, worker 1]
            "scrape_launches": (None if scrape_launches is None else {
                "a": scrape_launches["a"]["part_launches"][name],
                "b": scrape_launches["b"]["part_launches"][name],
                "c": scrape_launches["c"]["launches"][name]}),
            # phase 21, the generation plane's observability: (a) the
            # colocated traffic and its turns, (b) the journey across the
            # prefill child, (c) the held step and the ITL objective
            "odyssey_launches": (None if ody_launches is None else {
                part: ody_launches[part]["launches"][name]
                for part in "abc"}),
            # phase 22, the native plane: (a) the transformer's turns, (b)
            # the echoes, (c) the streams and the unary bulk calls
            "native_launches": (None if np_launches is None else {
                part: np_launches[part]["launches"][name]
                for part in "abc"})})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    if kernels_only:
        return
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
