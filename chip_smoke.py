#!/usr/bin/env python3
"""Smoke of the PyTorch/CUDA port (batch_scheduler_tpu_torch) on one NVIDIA
GPU: builds the port's kernels from csrc/, drives its gang-admission path
at the north-star size, and holds every kernel against its plain PyTorch
version.

Run from the repository root:  python3 chip_smoke.py

Phases (one JSON line each; any failure makes the exit code non-zero):

- build            nvcc csrc/assign_scan.cu (twice: the serial kernel, and
                   with -DBST_POLICY_SCAN its policy variant),
                   csrc/assign_wave.cu and csrc/assign_topk.cu, one nvcc
                   each, started together, into the gitignored build/
- north_star       bench.py's deployment — 5,000 nodes (64 cpu, 256Gi, 110
                   pods, 8 GPUs), 1,000 gangs x 10 pods (4 cpu, 8 GiB, 1 GPU)
                   -> [G=1024, N=8192, R=5], broadcast mask — through
                   OracleScorer.refresh on cuda; every gang must place.
                   The seven refreshes of an unchanged cluster are the
                   steady state: a first keyframe, then snapshot-lite scans
                   with the packed buffers resident on the card and the
                   cached derived fit row and queue order. Medians of the
                   host pack, the device batch and the whole refresh, and
                   keyframe_refresh_ms_median (a fresh scorer each: a full
                   pack and a full upload); the kernel alone (its cluster
                   size, leftover placement and time a gang), the same
                   kernel launched at cluster sizes 1 and 8 beside the
                   device's plan (the design steps), and the plain scan
                   alone.
- mixed            seeded numpy at the same scale: 4 node shapes, gangs of
                   1-64 members, some infeasible, ~30% with a node selector
                   ([1024, 8192] mask), some per-node capacities >= 127.
                   Kernel vs plain bit for bit, and the cuda host dict vs the
                   CPU one, in both mask modes (leftover in shared memory).
- global_leftover  the same checks on 10,000 nodes (bucket 16384) x 256
                   gangs, where both kernels' leftover fits the cluster's
                   shared memory, and on 150,000 nodes (bucket 262144) x
                   64 gangs, where both keep it in global scratch; and on
                   1,100,000 nodes (bucket 2^21) x 16 gangs, past 64 nodes
                   a thread, where both kernels run a thread's nodes as
                   slabs: both kernels (the wave kernel at W=8) against
                   the plain scans bit for bit in both mask modes and on a
                   uniform input, with their times and plans.
- race             the README race scenario through ScheduleOperation on
                   cuda: gang 1 permits all five pods, gang 2 is denied and
                   its retry hits the deny backoff. Every batch of that run
                   launches the kernel once, as a cluster of one block (the
                   8-node bucket); kernel vs plain on its last batch's
                   inputs.

- north_star_churn the north-star deployment held in the port's
                   ClusterState (whose event hooks feed the scorer's event
                   log): each refresh follows one round of churn, 16 node
                   rows (assume/forget of 1-cpu pods, benchmarks/
                   delta_gate.py's CHURN_ROWS) and 4 gangs' progress rows
                   named by mark_dirty(group=...); one round also moves a
                   gang's priority. Every refresh after the first must be
                   an event fold with no keyframe but the first, and one
                   round also changes a gang's member request, whose [G,R]
                   row must scatter. After each the host dict must equal
                   the full pack's (one ClusterSnapshot of the whole
                   ClusterState run as one batch), and all seven batch
                   args the resident state handed the batch that pack's
                   arrays. Medians of the refresh, host pack and device
                   batch, fold outcomes, keyframes, rows scattered, derived
                   batches, one profiled refresh, and, report-only, the
                   same rounds through a scorer that skips the holder
                   (every batch's arrays uploaded whole) and one round of
                   1,000 node rows. Also report-only: the holder's scatter
                   against the whole upload alone, at 5,000, 40,000 and
                   150,000 nodes (residency_vs_upload).
- churn_loop       benchmarks/ladder.py:250 config5_churn on cuda through
                   the port's ChurnRescorer and TickPipeline: the north-star
                   nodes, 10,000 gangs x 10 pods (4 cpu, 8 GiB, 1 GPU), a
                   600-gang backlog admitted through a 32-gang window, 50
                   ticks of 100 ms, ~2% of the running gangs released and 2
                   arrivals a tick, the depth from probe_link_depth after a
                   warm on {8, 16, 32, 64, window}. Fails unless no new
                   bucket shape appears after the warm, the backlog drains
                   and stays at or below the window, nothing is re-uploaded,
                   the p95 loop tick is <= 100 ms with no deadline miss,
                   each dispatched tick launches the serial kernel once, every
                   collected tick's host dict equals its snapshot's batch run
                   by the plain path on the CPU (after the loop), and the
                   resident occupancy equals the padded mirror. Then,
                   report-only, 20 ticks at a forced depth of 2 after a
                   burst of 200 arrivals (admit_verified's skips), where the
                   drain and no re-upload are still checked.
- audit_replay     north_star_churn's deployment and churn through a
                   ScheduleOperation's OracleScorer on cuda with an audit
                   log and the identity audit on every 2nd batch: a first
                   refresh and 12 churn rounds into an ``array`` ring
                   (keyframe every 16) and into a ``v2`` ring (keyframe
                   every 4, event_batch records between). Each ring is
                   flushed and read back: nothing dropped, failed or
                   swallowed at publish, every record reconstructed, its
                   inputs (and its recorded input_digest) equal to the
                   args the batch ran on, the identity audit drained with
                   at least one audit and no mismatch or error. Every
                   record replays identically on steady (the kernel) and
                   the last three on cpu-ladder (the plain serial scan on
                   the CPU); a copy of one record with one assignment
                   count changed is reported divergent, blamed on that
                   field and gang. Reported: the publish cost a batch
                   (_audit_publish: digest, tenants, enqueue), bytes a
                   record by kind, replay ms by rung, the identity audit's
                   ms, and, report-only, the churn refresh with the audit
                   off and on in turns on one scorer, each with and
                   without an identity verification in flight. Then a
                   policy ring: the policy deployment (below) into an
                   ``array`` ring, a first refresh and 3 churn rounds, the
                   identity audit on every 4th batch; every record carries
                   its policy columns, terms and weights, and replays
                   identically on steady (the policy kernel) and the last on
                   cpu-ladder (the plain policy scan on the CPU).
- policy           the policy engine at the north star: the north-star
                   deployment in a ClusterState with node labels (zone in
                   8 values, pool in 4, rack in 16, team in 3: all 4 hash
                   lanes full), ~30% of the gangs with affinity to a pool,
                   ~10% with anti-affinity against one, ~30% spread, and 100
                   spread gangs with 3 of 10 members matched (seed 8);
                   BST_POLICY=affinity,anti-affinity,spread,preempt and the
                   default weights (32, 8, 3), through a ScheduleOperation's
                   OracleScorer: a keyframe refresh and 6 churn refreshes
                   (north_star_churn's Churn rounds; the policy turns off
                   the lite scan and the event fold, so each is an O(N+G)
                   pack). Every refresh equals the full pack (host dict,
                   batch args, the six policy columns the batch ran on);
                   every gang places. The policy kernel (assign_policy)
                   once a refresh and no other kernel; the kernel against
                   the plain policy scan on the last batch's CUDA inputs,
                   its time beside the base kernel's on the same inputs.
- policy_identity  the zero-policy identity on the card (all terms with
                   zero columns, and real columns with no term, equal the
                   base kernel) at the north star and on mixed's inputs in
                   both mask modes; the policy kernel against the plain
                   policy scan on mixed's inputs with seeded columns and at
                   the 2^21-node bucket (its slabs), both mask modes.
- preemption       spot_vs_guaranteed_scenario through a ScheduleOperation
                   on cuda with the "preempt" term: the spot gangs fill the
                   cluster, the guaranteed gang is denied,
                   preempt_victim_plan (plan_victims on the card) plans
                   spot-000, the planner verifies it, the commit steps run
                   (victims removed, note_gang_evicted, forget_denied, a
                   blind mark) and PreFilter places the guaranteed gang.
                   Then plan_victims at 512 victims and 8,192 nodes, timed
                   on the card and on the CPU, the two results equal.
- sidecar          the oracle sidecar at the north star: serve_background(
                   device="cuda") and three scorers of north_star_churn's
                   deployment — a RemoteScorer on a windowed
                   ResilientOracleClient (wire deltas), a second pinned to
                   full snapshots, the in-process OracleScorer — through a
                   keyframe refresh and 8 Churn refreshes. After each the
                   three host dicts are equal, every gang is placed, and 4
                   gangs' capacity and score rows read over ROW_REQ (both
                   remote scorers) equal the local ones; at least 7 batches
                   are wire deltas; the server runs the serial kernel once
                   a batch (the main path's launches: the two remote
                   scorers' batches) and the fallback counter stays 0.
                   Then against that server: 5 traced requests (the server
                   split from TRACE_INFO: unpack_pad, lock_wait, device;
                   telemetry scan cuda_kernel), mixed's per-group batch
                   (~8.8 MB) against the plain CPU batch of the same padded
                   args, the native client's answer against the Python
                   client's, a 1 ms DEADLINE (DEADLINE_ERROR, then a right
                   answer), load windows of 40 requests over one connection
                   and over two at once (every answer and row right; the
                   card's idle share of each), and drain (work gets
                   DRAINING, PING gets PONG). Then the outage path on its
                   own server: RemoteScorer(fallback="local-cpu") inside
                   ScheduleOperation, the server stopped (degraded, one
                   fallback batch, only the gang that fits no node denied)
                   and restarted on the same port (recovered). Reported:
                   the remote refresh on wire deltas, on keyframes and on
                   full snapshots beside the local churn refresh, the
                   remote scorer's pack and round trip, request and
                   response bytes.
- coalesce_span    the multi-tenant sidecar at the north star: 8 tenants
                   (benchmarks/coalesce_gate.py's client count), each its
                   own seeded north-star ClusterState and TENANT
                   announcement, a RemoteScorer on wire deltas through a
                   keyframe refresh and 8 Churn refreshes, all on their
                   own threads: time-sliced (one request in flight across
                   all eight) against a dedicated sidecar, then coalesced
                   against serve_background(device="cuda", coalesce=True)
                   (the main path), then each again under the profiler.
                   BST_CAPACITY=0, as the gate runs. Every tenant's host
                   dicts and plan_digest sequence equal in both runs; every
                   group span (G_tot·N_tot far above 2^21); one serial-
                   kernel launch a tenant batch. Reported: aggregate
                   batches a second, per-tenant coalescer queue wait and
                   request time p50/p95, groups and mean span width, the
                   card's idle share of each run.
- coalesce_mega    8 tenants at BASELINE config 2 (100 PodGroups x 10
                   pods, 50 nodes, cpu + mem; 320,000 merged cells, under
                   2^21): 4 lockstep rounds, the coalescer's selection held
                   until all 8 are pending, so each round is one block-
                   diagonal mega batch (one launch); every response and row
                   equal to a dedicated sidecar's bytes; no failed mega
                   group.
- coalesce_drf     the gate's whale storm at BASELINE config 3 (1k
                   PodGroups of 4 pods, 500 nodes): 6 connections flood
                   "whale", one "small" tenant trickles; traced requests
                   feed the sidecar's capacity sampler and so the DRF
                   weights. The small tenant's p95 <= max(10 x the solo
                   batch, 1 s) and <= 1.25 x the whale's p95.
- coalesce_busy    BST_COALESCE_DEPTH=2 with the executor parked: a full
                   request and a wire delta answered BUSY, the delta's
                   mirror generation kept, ResilientOracleClient retries
                   after the hint with its breaker closed.
- capacity         the observatory at the north star: an OracleScorer on
                   cuda with an audit log and BST_CAPACITY_BUDGET_FRAC=1.0
                   (every refresh sampled, no error outcome); the summary
                   from the resident tensors on the card equal to the CPU
                   copies', the function's outputs on the card equal to the
                   CPU's and bit-equal across two runs, its time by CUDA
                   events beside its bound; every batch record's audit id
                   on a capacity_sample event; a traced sidecar request's
                   TRACE_INFO capacity block under the announced tenant;
                   then 40 churn refreshes at the default 2% budget with
                   the observatory on and off in turns: the hook's share of
                   the refresh wall clock and both refresh medians.

- metrics          the in-process batch path's series in the port's
                   DEFAULT_REGISTRY: north_star_churn's deployment and churn
                   (a keyframe and 8 churn refreshes) through a fresh
                   OracleScorer on cuda, serial and with BST_SCAN_WAVE=8
                   (run after north_star_churn_wave). Each series' delta
                   across the refreshes must equal what the run counts
                   itself: batches and the pack and batch histograms' counts
                   the refreshes, fold outcomes the scorer's stats(), rows
                   scattered, keyframes by reason, derived batches and the
                   generation the holder's, rows rewritten, lite packs and
                   resorts the packer's, waves, demotions and uniform waves
                   the batches' telemetry. The churn refresh median with
                   the series recorded, beside north_star_churn(_wave)'s,
                   and (report-only) 10 pairs of churn refreshes with the
                   recording on and off in turns.
- observability    the observability layer (utils.trace, utils.lifecycle,
                   utils.health, serve_metrics) at the north star:
                   north_star_churn's deployment and churn through a
                   ScheduleOperation's OracleScorer on cuda (audit log on),
                   tracing on at sample 1.0, a keyframe and 8 churn
                   refreshes, each under a schedule_cycle root. Each
                   refresh's span tree is the reference's (refresh > pack or
                   fold, device-state sync, batch), oracle.batch carries the
                   shape and is no shorter than the scan kernel's CUDA-event
                   time in that refresh (events recorded around the launch,
                   no synchronization), one _batch flight record with host
                   values only under the refresh's trace id, the ledger's
                   batch context carries the audit record's id, the audit
                   records carry the refreshes' trace ids; health ok. Then,
                   report-only, 10 pairs of churn refreshes traced and
                   untraced in turns and evaluate()'s time; serve_metrics
                   up while a thread refreshes 4 more times: every route
                   200 with the reference's keys (since PR 16 also
                   /debug/buckets, /debug/perf, /debug/profile and
                   /debug/drain, bare GETs), an unknown one 404; mixed's
                   node shapes and gang demands (seed 11)
                   through PreFilter: every denied gang's pre_filter record
                   has feasible_nodes equal to the served capacity row's
                   count; the policy deployment's refresh through PreFilter:
                   one policy record a placed gang, no row read from the
                   card; traced RemoteScorer refreshes against
                   serve_background(device="cuda"): the sidecar's spans
                   stitched under the client's trace id.
- observability_wave  observability with BST_SCAN_WAVE=8.
- explain_whatif   explain and what-if (core.explain, ops.explain):
                   benchmarks/whatif_gate.py's four phases on the card at
                   its sizes, and the explain scan's kernel route (two
                   launches of the serial kernel, of its policy variant for
                   a policy batch) against its plain capture scan on the
                   CPU, every field, for the first, a middle, the last and
                   an unplaced gang of the north star, mixed (both mask
                   modes) and the policy deployment, with 5 timed queries
                   and the bound (twice scan_bound) at the north star.
                   Identity: at 48 nodes / 24 gangs each of the five
                   counterfactuals' plan digests (and the baseline's) equal
                   to a cluster that applied the change, on steady,
                   wavefront and cpu-ladder. Isolation: 4 threads x 3
                   what-if queries fork a live OracleScorer's holder at the
                   north star while a thread runs 4 churn refreshes; the
                   holder's generation, rows scattered, keyframes and next
                   batch's plan digest equal a run without the storm, and
                   its tensors' data pointers never move. Blame: mixed's
                   denials through PreFilter, then /debug/explain
                   (serve_metrics) for every denied gang agrees with its
                   pre_filter record. Latency, report-only: the warm
                   what-if query (split into pack, batches and diff)
                   against one steady batch at 5,120 nodes / 2,048 gangs x
                   5; the reference gate's 2.0x ceiling is printed beside
                   the ratio, not enforced.
- explain_whatif_wave  explain_whatif with BST_SCAN_WAVE=8 (the what-if
                   steady rung on the wave kernel; the explain scan stays
                   serial), the explain scan on the north star and mixed's
                   per-group batch.
- lockcheck        a child process (chip_smoke.py --lockcheck-child) with
                   BST_LOCKCHECK=1, the instrumentation kept out of every
                   other phase (run last): the number of instrumented
                   classes; 8 threads storm one OracleCoalescer over a live
                   OracleServer(device="cuda") executor with BASELINE
                   config 2 batches (schedule, check_admission, stats); one
                   thread refreshes OracleScorer(device="cuda") on
                   north_star_churn's deployment and churn (traced) while 3
                   threads call stats() and one scrapes every ported
                   serve_metrics route. Any LockDisciplineError fails the
                   phase (both stacks on stderr); the storm and refresh
                   times, the scrapes.

With BST_SCAN_WAVE unset, the phases above (but policy) run the serial
kernel (assign_scan) and never the wave kernel. The wavefront path
(BST_SCAN_WAVE=W, the wave kernel assign_wave):

- north_star_wave  north_star with W=8: every gang placed, telemetry 128
                   waves, all uniform, none demoted; the wave kernel once per
                   batch and the serial kernel never; the wave kernel vs the
                   plain serial scan and the plain wavefront (outputs and
                   per-wave flags); both kernels timed in turns, and the
                   serial kernel's output held against the plain serial scan;
                   the wave kernel's plan, and the same kernel launched at
                   cluster sizes 1 and 8 beside it (the design steps).
- mixed_wave       mixed and both global_leftover inputs at W=8 and W=32 in
                   both mask modes (the wave kernel's leftover in shared
                   memory, and in global scratch at bucket 262144), and
                   mixed per-group restricted to zone node % 8 == scan
                   position % 8 at W=8 (non-uniform waves without a
                   conflict): both kernels vs plain everywhere, the cuda
                   host dict and wave telemetry vs the CPU ones, both
                   kernels timed in turns; each of the reference's branch
                   outcomes (uniform commit, speculative commit, demotion;
                   read from the per-wave flags) at least once.
- race_wave        race with W=32 (the 8-group bucket padded to one wave):
                   the same outcomes, the wave kernel once per batch, and it
                   matches the plain scans on the last batch.
- north_star_churn_wave  north_star_churn with W=8: the wave kernel once
                   per refresh, 128 waves a batch, and the wave telemetry
                   equal to the full-pack scorer's after every refresh.
- churn_loop_wave  churn_loop with W=8: the wave kernel once a dispatched
                   tick, the serial kernel never.
- audit_replay_wave  audit_replay with W=8 (without its policy ring): the
                   wave kernel once per refresh and per steady replay, and
                   every record also replays identically on wavefront.
- policy_wave      policy with W=8: a policy batch ignores the wave width,
                   so the policy kernel runs once a refresh and the wave
                   kernel never (telemetry: wave width 0, scan_policy), and
                   every refresh's plan equals the policy phase's.
- sidecar_wave     sidecar with W=8 on the server: the wave kernel once a
                   server batch and the serial kernel never, 128 waves a
                   batch in the server's telemetry.
- coalesce_span_wave  coalesce_span with W=8 on both servers: the wave
                   kernel once a tenant batch, the serial kernel never.

The top-K rung (BST_SCAN_TOPK=K, the top-K kernel assign_topk):

- north_star_topk  north_star_churn's deployment and churn through
                   OracleScorer(device="cuda") with BST_SCAN_TOPK=16 (W
                   unset: the rung's 8) and an ``array`` audit ring: a
                   keyframe and 8 churn refreshes, the top-K kernel once a
                   refresh and no other kernel; each refresh's host dict
                   equal to the full pack's on the serial rung; each
                   batch's kernel series (replayed and uniform waves,
                   demotions) equal to the plain top-K scan's on its scan
                   inputs and to the refresh's telemetry. The ring replays
                   identically on steady (the serial kernel) and its last
                   3 records on cpu-ladder; a serial-recorded ring (a
                   keyframe and 2 refreshes) replays identically on topk.
                   /debug/whatif?rung=topk on a live observatory gives the
                   steady rung's digests. The kernel on the last batch's
                   inputs timed against the wave kernel in turns, the
                   plain version's time and topk_bound.
- xl_topk          the XL tier: XLClusterSpec() (100,000 nodes padded to
                   131072, 4,096 gangs, 6 lanes, seed 0), the same with 3
                   request profiles, and benchmarks/xl_scaling.py's
                   acceptance bucket [G=2048, N=65536] (seed 1): the serial
                   kernel, the wave kernel at W=8 and the top-K kernel at
                   K=16 and K=128, every output bit-identical, the top-K
                   series equal to the plain top-K scan's on the card, all
                   timed in turns; 3 xl_churn_burst re-runs at K=128, each
                   held to the serial kernel; one full batch through
                   execute_batch_host, BST_SCAN_TOPK=128 against unset,
                   the host dicts equal (the unpacked tail), with the
                   device batch's split (head, scan, compaction).

The scheduler loop (framework/, plugin/, controller/, client/, sim/):

- framework_e2e    BASELINE config 6 as benchmarks/ladder.py:469-600
                   builds it: SimCluster(scorer="oracle", device="cuda")
                   with the ladder's settings (16 bind workers, kubelet
                   start 50 ms, backoff 0.5-5 s, controller resync 2 s,
                   min_batch_interval 1 s, the background refresh), 5,000
                   nodes (64 cpu, 256Gi, 110 pods, 8 GPUs), 1,000 gangs x
                   10 pods (4 cpu, 8 GiB, 1 GPU; the member shape in the
                   group spec, recent creation stamps); the controller's
                   phase sweep and the standing batch before the clock;
                   the pod documents serialized outside it; the window
                   under the ladder's 20 ms switch interval and GC
                   thresholds + freeze. Fails unless all 10,000 pods bind
                   and every gang reaches Running, no gang is bound in part
                   before its release at any sample (a pass over the API
                   server's store under
                   its lock every 250 ms: a gang seen part-bound must be
                   released, its quorum permitted; the fast lane binds a
                   gang in one bind_many, the per-pod path member by
                   member after the release), the last batch's inputs give
                   the same assignment on the kernel as on the plain scan,
                   the ledger holds 1,000 arrivals, admissions and binds,
                   bst_schedule_cycle_seconds counts the cycles run (and
                   preFilter's and the bind counter's series theirs), a
                   traced cycle (a gang whose first member arrives alone)
                   has the reference's spans (schedule_cycle -> pre_filter,
                   gang_transaction, select_node), the health verdict
                   (/debug/health's: the rolling 300 s window ending after
                   the flood) is ok, the settled state's refresh (a fold)
                   equals its full pack, the kernel launches once a batch
                   and no batch is in flight after stop.
                   Reported: ladder config 6's detail keys, fold outcomes,
                   and a second flood of 200 new gangs under the profiler
                   (the device's idle share) and a stack sampler (the
                   host's running share by thread and function).
- framework_e2e_wave  the same with BST_SCAN_WAVE=8 (the wave kernel).
- sim_scenarios    the README's scenarios through SimCluster(device=
                   "cuda"), the first three read from examples/*.yaml by
                   the port's manifest loader: the race (one gang binds, the
                   other nothing), example1's gang of 9 on 4 nodes of 4
                   cpu, the zone-pinned gang, and spot_vs_guaranteed with
                   BST_POLICY set (the guaranteed gang placed through the
                   scheduler's own _policy_preempt / _evict_gang_plan, a
                   spot gang respawned); each scenario's kernel once a
                   batch (the policy kernel for the last).
- http_e2e         config 6 (framework_e2e's deployment and settings) run
                   as SimCluster(api=HTTPAPIServer(host, port, qps=0),
                   device="cuda") against serve_gateway(APIServer()) over
                   loopback sockets: nodes and gangs created through the
                   scheduler's client, the 10,000 pods by a load generator
                   with its own client; once a third of the pods are bound
                   in the backing store the gateway is shut down and
                   restarted on the same port after 0.5 s
                   (benchmarks/http_e2e.py's restart). Fails unless every
                   pod is bound in the backing store, every gang Running
                   there, no gang part-bound before its release at any
                   sample of the store, no node over-committed (judged
                   from the store), the serial kernel once a batch and
                   nothing in flight after stop. Reported: the wall clock
                   from the first pod to the last bind in the store, pods a
                   second, batches, the restart's binds_before and
                   outage, beside framework_e2e's in-memory wall clock.
- chaos            the port's sidecar on the card (serve_background(
                   device="cuda")) behind sim.chaos.ChaosProxy at the north
                   star: each of reset, hang, delay, truncate and garbage
                   once through a ResilientOracleClient, the answer equal to
                   a dedicated sidecar's for the same request; on the wire-
                   delta stream a dropped and a duplicated request frame
                   (refused on the generation check, resynced through a
                   keyframe) and the primary killed mid-stream (a pooled
                   client fails over to a standby and resyncs), every
                   refresh's host dict equal to a remote scorer's on the
                   dedicated sidecar; all of it at W unset and at
                   BST_SCAN_WAVE=8; then tests/test_fuzz_e2e.py:296's
                   drizzle (delay 0.15, reset 0.04, truncate 0.03, garbage
                   0.03) under SimCluster(device="cuda") with
                   RemoteScorer(fallback="local-cpu"): the feasible set
                   bound, the infeasible gangs not, no over-commit, the
                   server's launches against the client's fallback
                   batches (the card must have served batches).
- warmer           the bucket warmer in fresh child processes
                   (chip_smoke.py --warmer-child MODE): two with it off and
                   two with it on, alternating, each an OracleScorer at the
                   north star [1024, 8192] and then the cluster grown to
                   8,200 nodes (N bucket 16384): the first and a second
                   batch there; then a sidecar started as `serve --warmup
                   --compile-warmer` is (one warm-up batch, the warmer on)
                   serving the north star twice, its warmth_snapshot()
                   replicated into a second such sidecar in another
                   process (replicate_warmth) and that standby's first and
                   second request. Fails unless the
                   four grown plans are equal, the warmed first grown batch
                   is a hit (not ``compiled``) and the unwarmed one is
                   ``compiled``, and the standby's first request is a hit.
                   Reported: the batch times (first and second grown batch
                   by mode), the counters and the wait for the warm shape.

- cli              the CLI (python -m batch_scheduler_tpu_torch) in child
                   processes from the repository root: version,
                   check-config on the shipped config, and the README's
                   manifests with the README's outcomes (race.yaml: one
                   gang Running with 5 bound, the other 0; example1.yaml
                   --nodes 4 --node-cpu 4: the gang of 9 Running;
                   zones.yaml: every recorded plan puts the pinned gang on
                   east-1), spot-vs-guaranteed with BST_POLICY set (the
                   guaranteed gang Running through a preemption, one spot
                   gang evicted); explain and whatif --rung steady|topk
                   against the live race process (the two what-ifs equal
                   but for their rung and time);
                   the full-width run `sim --scenario synthetic --nodes
                   5000 --node-cpu 64 --node-memory 256Gi --groups 1000
                   --members 10 --scorer oracle` (with --settle 20) with
                   --audit-dir (--audit-cap-mb 64), --lifecycle-dir and
                   --metrics-port (all 10,000 pods
                   bound, every gang Running; its wall clock and pods a
                   second, batches and fold outcomes); replay, explain,
                   capacity and timeline on its audit ring, each equal to
                   the in-process function on the same records (replay:
                   every record identical in the child, the last 4 also in
                   process); the synthetic deployment at a quarter of the
                   count (1,250 nodes, 250 gangs x 10) through `serve` and
                   `sim --oracle-addr`, then the served process's
                   /debug/buckets (the [256, 2048] bucket's plan and bound),
                   /debug/perf, /debug/profile?seconds=1 (a torch.profiler
                   trace naming the scan kernel, while the smoke sends
                   requests) and /debug/drain?go=1, after which SIGTERM
                   ends it with exit 0; and one run with
                   CUDA_VISIBLE_DEVICES= that must exit non-zero (no CPU
                   fallback). The served process's launches of each
                   kernel (bst_kernel_launches_total, counted by the
                   wrappers) just before the remote run and just after it
                   are cli_serve: one a batch of the run, plus its warm
                   batch; the profiled window's are reported apart.
- cli_wave         with BST_SCAN_WAVE=8 in the children: replay --against
                   wavefront and topk (and explain, capacity, timeline) on
                   the cli phase's full-width ring; the quarter deployment
                   in a sim child with one more gang that never fits (the
                   child stays up once the 2,500 pods are bound): its
                   launches against its batches (cli_wave),
                   then whatif --rung steady and --rung topk (one added
                   256-cpu node) against it live, equal to each other and
                   to its /debug/whatif, the held gang newly placeable;
                   and the quarter deployment through `serve` with its
                   routes as in cli (cli_wave_serve). The README's
                   examples, the no-card run and the direct full-width run
                   only in cli, where the first two run beside the third
                   (they mostly wait): a full-width run with the CLI's
                   defaults makes a batch a gang (PERF.md).
- cli_main         last: cmd.main.main(argv) of the synthetic run at a
                   quarter of config 6's count (1,250 nodes, 250 gangs x
                   10; the full-width runs are cli's) in process, each
                   kernel's count zeroed just before and read just after
                   (cli_main), under the stack sampler and
                   torch.profiler recording the card (its idle share over
                   the run); the CLI's GC thresholds, freeze and switch
                   interval put back after it.

The metrics phase also holds the scheduler loop's series (cycles, the
extension points, binds, releases, time to placement) to a SimCluster
run's own counts, and the lockcheck child also runs the race and a seeded
200-node x 40-gang SimCluster (background refresh, the 1 s interval and
dispatch-ahead on) with every LockDisciplineError counted, swallowed or
not.

Then the card's name and power limit (nvidia-smi), one ``kernels`` line and,
last, ``{"ok": true, "device": {...}}``. Launch counts are read for each
path that drives the scorer or the re-scorer — north_star, race,
north_star_churn, churn_loop, policy, audit_replay (and its policy ring),
sidecar, coalesce_span, coalesce_mega, coalesce_drf, coalesce_busy,
capacity, north_star_wave, race_wave, north_star_churn_wave,
churn_loop_wave, policy_wave, audit_replay_wave, sidecar_wave,
coalesce_span_wave, metrics, metrics_wave, observability(_wave) and its
scrape, mixed, policy and sidecar paths, explain_whatif(_wave)'s explain
scan, what-if rungs, storm, blame and latency paths, north_star_topk (its
refreshes, its rings' replays and its what-if query), xl_topk (its
kernel calls and its full batch), framework_e2e(_wave) (the standing
batch through the flood, and the profiled flood), http_e2e (the same over
the HTTP gateway), sim_scenarios (each scenario), chaos, chaos_wave and
chaos_drizzle (the sidecar's batches through the proxy), metrics_framework, lockcheck and lockcheck_sims (counted in
its child), cli_serve, cli_wave_serve and cli_wave (a child's
bst_kernel_launches_total just before and just after its run, or at its
held state), cli_main (the CLI's quarter-width run in process), and
the audit phases' replays (``audit_replay_replays``,
``audit_replay_wave_replays``, ``audit_replay_policy_replays``) — with
every kernel's count zeroed just before the path and read just after;
``launches`` in the kernels line is the path's of the kernel's first
phase (north_star, north_star_wave, policy, north_star_topk),
``launches_by_path`` holds each path. Comparison and timing
launches are not counted.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
import traceback

GPU = "nvidia.com/gpu"
PHASES = []  # (name, ok)
# bench.py's deployment: nodes, gangs of 10 members, and the padded batch
NORTH_STAR_NODES, NORTH_STAR_GANGS = 5000, 1000
NORTH_STAR_SHAPE = (1024, 8192, 5)
# (nodes, gangs, seed) of the mixed and global_leftover inputs, and where
# each kernel keeps the leftover on them: (serial, wave)
MIXED = (5000, 1000, 11)
GLOBAL_LEFTOVER = (10000, 256, 12)
SERIAL_GLOBAL = (150000, 64, 13)
LEFTOVER = {MIXED: ("shared", "shared"), GLOBAL_LEFTOVER: ("shared", "shared"),
            SERIAL_GLOBAL: ("global", "global")}
# past 2^20 nodes (bucket 2^21): both kernels run a thread's nodes as slabs
BIG_BUCKET = (1100000, 16, 14)


def emit(obj):
    print(json.dumps(obj, sort_keys=False), flush=True)


def phase(name):
    def wrap(fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kwargs)
            except Exception as e:  # noqa: BLE001 — report and keep going
                traceback.print_exc(file=sys.stderr)
                emit({"phase": name, "ok": False, "error": repr(e)[:2000],
                      "seconds": round(time.perf_counter() - t0, 3)})
                PHASES.append((name, False))
                return None
            emit({"phase": name, "ok": True,
                  "seconds": round(time.perf_counter() - t0, 3), **(out or {})})
            PHASES.append((name, True))
            return out
        return run
    return wrap


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn()`` over ``reps`` launches, CUDA events."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class InMemoryCluster:
    """A static ClusterStateProvider: nodes plus per-node requested dicts."""

    def __init__(self, nodes):
        self.nodes = list(nodes)
        self.bound = {n.metadata.name: [] for n in self.nodes}

    def list_nodes(self):
        return list(self.nodes)

    def node_requested(self, name):
        from batch_scheduler_tpu_torch.ops.snapshot import node_requested_from_pods

        return node_requested_from_pods(self.bound.get(name, []))

    def bind(self, pod, node_name):
        pod.spec.node_name = node_name
        self.bound[node_name].append(pod)


def profile_refresh(scorer, cluster, cache):
    """One refresh under torch.profiler: the device's busy time (sum of
    kernel and copy self-times on the card) against the refresh's wall
    clock, and the five device ops that took longest."""
    return profile_window(lambda: scorer.refresh(cluster, cache), "profiled_refresh_ms")


def profile_window(fn, wall_key, host_ops=True):
    """``fn()`` under torch.profiler, the card synchronized at its end: its
    wall clock (under ``wall_key``), the device's busy time (sum of kernel
    and copy self-times on the card, whichever thread launched them), the
    idle share and the five device ops that took longest. ``host_ops``
    False records the card's activity alone (less overhead on a long
    window)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] if host_ops else []
    with profile(activities=activities + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        # the card's own events (kernels, copies, memsets); the host ops
        # that launched them carry the same time again
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.key, ev.count))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    if busy_ms == 0:
        return {wall_key: wall_ms, "profile": "no device time in the trace: not measured"}
    return {
        wall_key: wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1 - busy_ms / wall_ms,
        "top_device_ops": [
            {"op": key[:80], "ms": ms, "calls": n} for ms, key, n in rows[:5]
        ],
    }


def counters():
    """The port's kernel wrappers by kernel name; each counts its launches
    in ``.launches``."""
    from batch_scheduler_tpu_torch.ops.assign_scan import (
        assign_gangs_cuda, assign_gangs_policy_cuda, assign_gangs_topk_cuda,
        assign_gangs_wave_cuda)

    return {"assign_scan": assign_gangs_cuda, "assign_wave": assign_gangs_wave_cuda,
            "assign_policy": assign_gangs_policy_cuda, "assign_topk": assign_gangs_topk_cuda}


def only(**launches):
    """A launch count for every kernel: the named ones, 0 for the rest."""
    return {name: launches.get(name, 0) for name in KERNELS}


def zero_counts():
    """Every kernel's launch count set to 0 (just before a path)."""
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    """Every kernel's launch count (just after a path)."""
    return {name: fn.launches for name, fn in counters().items()}


def restore_counts(saved):
    """Counts put back to ``saved`` (after launches that must not count)."""
    for name, fn in counters().items():
        fn.launches = saved[name]


def max_err(got, want):
    """(max_abs_err, all_equal) of two sequences of tensors."""
    import torch

    err = 0
    equal = True
    for a, b in zip(got, want):
        equal &= torch.equal(a, b)
        err = max(err, int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())
                  if a.numel() else 0)
    return err, bool(equal)


def compare_scan(args, want=None):
    """Kernel vs plain on the same CUDA inputs: (max_abs_err, all_equal).
    ``want`` reuses a plain serial result."""
    import torch

    from batch_scheduler_tpu_torch.ops.assign_scan import assign_gangs_cuda, assign_gangs_plain

    got = assign_gangs_cuda(*args)
    if want is None:
        want = assign_gangs_plain(*args)
    torch.cuda.synchronize()
    return max_err(got, want)


def serial_plan(n, r):
    """The serial kernel's launch plan on device 0, as the wrapper takes it."""
    from batch_scheduler_tpu_torch.ops.assign_scan import scan_plan

    return scan_plan(n, r, 0)


def wave_plan(n, r):
    """The wave kernel's launch plan on device 0, as the wrapper takes it."""
    from batch_scheduler_tpu_torch.ops.assign_scan import wave_scan_plan

    return wave_scan_plan(n, r, 0)


def compare_wave(args, wave, serial=None):
    """The wave kernel vs the plain serial scan (alloc, placed, left_after)
    and vs the plain wavefront (the same and the per-wave flags), on the
    same CUDA inputs: (max_abs_err, all_equal, conflicts, megas) with the
    kernel's flags as numpy arrays. ``serial`` reuses a plain serial result."""
    import torch

    from batch_scheduler_tpu_torch.ops.assign_scan import (
        assign_gangs_plain, assign_gangs_wave_cuda)
    from batch_scheduler_tpu_torch.ops.oracle import assign_gangs_wavefront

    got = assign_gangs_wave_cuda(*args, wave)
    plain = assign_gangs_wavefront(*args, wave=wave, with_stats=True)
    if serial is None:
        serial = assign_gangs_plain(*args)
    torch.cuda.synchronize()
    err1, eq1 = max_err(got[:3], serial)
    err2, eq2 = max_err(list(got[:3]) + list(got[3]), list(plain[:3]) + list(plain[3]))
    conflicts, megas = (x.cpu().numpy() for x in got[3])
    return max(err1, err2), eq1 and eq2, conflicts, megas


@contextlib.contextmanager
def env_set(values):
    """Environment variables set to ``values`` inside the block (a None
    value unsets one)."""
    saved = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def scan_wave_env(wave):
    """BST_SCAN_WAVE set to ``wave`` inside the block (unset for None)."""
    return env_set({"BST_SCAN_WAVE": None if wave is None else str(wave)})


def scan_inputs(batch_args):
    """The scan's CUDA inputs for a packed numpy batch, as the batch feeds
    them: (left, group_req, remaining, fit_mask, order)."""
    import numpy as np

    from batch_scheduler_tpu_torch.ops.convert import batch_from_numpy
    from batch_scheduler_tpu_torch.ops.oracle import left_resources

    z = np.zeros(batch_args[2].shape[0], np.int32)
    batch, _ = batch_from_numpy(batch_args, (z, z, z, z.astype(bool), z), "cuda")
    alloc, requested, group_req, remaining, fit_mask, _, order = batch
    return (left_resources(alloc, requested), group_req, remaining, fit_mask, order)


def host_dicts_equal(batch_args, progress_args):
    """The cuda host dict (kernel scan) vs the CPU host dict (plain scan),
    the wave telemetry, and the capacity/score tensors."""
    import numpy as np

    from batch_scheduler_tpu_torch.ops.oracle import execute_batch_host

    gpu_host, gpu_dev = execute_batch_host(batch_args, progress_args, device="cuda")
    cpu_host, cpu_dev = execute_batch_host(batch_args, progress_args, device="cpu")
    diff = [k for k in cpu_host if k != "telemetry"
            and not np.array_equal(np.asarray(gpu_host[k]), np.asarray(cpu_host[k]))]
    diff += [f"telemetry.{k}" for k in WAVE_TELEMETRY
             if gpu_host["telemetry"].get(k) != cpu_host["telemetry"].get(k)]
    diff += [k for k in ("capacity", "scores")
             if not np.array_equal(gpu_dev[k].cpu().numpy(), cpu_dev[k].numpy())]
    return diff, gpu_host, gpu_dev


WAVE_TELEMETRY = ("wave_width", "waves_per_batch", "wave_demotions", "wave_uniform")


# -- phases -------------------------------------------------------------------

KERNELS = ("assign_scan", "assign_wave", "assign_policy", "assign_topk")


@phase("build")
def build():
    from concurrent.futures import ThreadPoolExecutor

    from batch_scheduler_tpu_torch.ops import _build

    # one nvcc per source, all started together
    with ThreadPoolExecutor(max_workers=len(KERNELS)) as pool:
        libs = list(pool.map(_build.library, KERNELS))
    return {"built": list(KERNELS),
            "libraries": [os.path.basename(lib._name) for lib in libs]}


def north_star_cluster():
    from batch_scheduler_tpu_torch.cache import PGStatusCache, PodGroupMatchStatus
    from batch_scheduler_tpu_torch.api.types import PodGroupPhase
    from batch_scheduler_tpu_torch.sim.scenarios import (
        make_member_pods, make_sim_group, make_sim_node)

    nodes = [make_sim_node(f"n{i:05d}", {"cpu": "64", "memory": "256Gi", "pods": "110", GPU: "8"})
             for i in range(NORTH_STAR_NODES)]
    cache = PGStatusCache()
    for g in range(NORTH_STAR_GANGS):
        pg = make_sim_group(f"gang-{g:04d}", 10, creation_ts=float(g))
        pg.spec.min_resources = {"cpu": 4000, "memory": 8 * 1024**3, GPU: 1}
        pg.status.phase = PodGroupPhase.PENDING
        pgs = PodGroupMatchStatus(pg)
        pgs.pod = make_member_pods(f"gang-{g:04d}", 1, {"cpu": "4", "memory": "8Gi", GPU: "1"})[0]
        cache.set(pg.full_name(), pgs)
    return InMemoryCluster(nodes), cache


def drive_north_star(wave):
    """The north-star deployment through ``OracleScorer.refresh``: seven
    batches with ``BST_SCAN_WAVE`` set to ``wave`` (None: unset), both scan
    kernels' launch counts zeroed just before the seven and read just
    after, then one profiled refresh, then the keyframe figure: one
    refresh each by seven fresh scorers (a full pack and a full upload),
    the last five timed. Checks the shape, that every gang placed and that
    the seven were the steady state (one first keyframe, then lite scans
    reusing the derived columns). Returns (scorer, launches by kernel,
    report)."""
    import torch

    from batch_scheduler_tpu_torch.core import OracleScorer

    cluster, cache = north_star_cluster()
    scorer = OracleScorer(device="cuda")
    torch.cuda.reset_peak_memory_stats()
    with scan_wave_env(wave):
        # the main path: counts zeroed just before, read just after
        zero_counts()
        refresh_s = []
        for _ in range(7):
            t0 = time.perf_counter()
            scorer.refresh(cluster, cache)
            refresh_s.append(time.perf_counter() - t0)
        launches = read_counts()
        batches = scorer.batches_run
        telemetry = dict(scorer.last_telemetry)
        stats = scorer.stats()
        scan_pack_s = list(scorer.pack_seconds_by_path["scan"])
        sync_s = list(scorer.sync_seconds)
        try:
            prof = profile_refresh(scorer, cluster, cache)
        except Exception as e:  # noqa: BLE001 — a measurement, not a check
            prof = {"profile": f"failed: {e!r}"[:300]}
        # the keyframe refresh (a full pack and a full upload): one refresh
        # each by a fresh scorer, two warmups then five timed
        keyframe_s, keyframe_pack_s = [], []
        for _ in range(7):
            fresh = OracleScorer(device="cuda")
            t0 = time.perf_counter()
            fresh.refresh(cluster, cache)
            keyframe_s.append(time.perf_counter() - t0)
            keyframe_pack_s.append(fresh.pack_seconds_by_path["keyframe"][0])
            if fresh.snapshot.delta.reason != "first":
                raise AssertionError(f"keyframe refresh packed {fresh.snapshot.delta}")
    # the seven are the steady state: one first keyframe, then lite scans
    # of an unchanged cluster reusing the cached derived columns
    ds = stats["device_state"]
    if ds["keyframes"] != {"first": 1} or stats["packer"]["lite_packs"] != 6 \
            or ds["derives"] != 1 or ds["rows_scattered"] != 0:
        raise AssertionError(f"steady state {stats}")
    timed = slice(2, None)  # two warmup batches
    names = sorted(cache.snapshot())
    placed = sum(scorer.placed(n) for n in names)
    feasible = sum(scorer.gang_feasible(n) for n in names)
    members = sum(sum(scorer.assignment(n).values()) for n in names)
    snap = scorer.snapshot
    if snap.shape != NORTH_STAR_SHAPE:
        raise AssertionError(f"north-star shape {snap.shape} != {NORTH_STAR_SHAPE}")
    want = (NORTH_STAR_GANGS, NORTH_STAR_GANGS, 10 * NORTH_STAR_GANGS)
    if (placed, feasible, members) != want:
        raise AssertionError(f"placed {placed}, feasible {feasible}, members {members} "
                             f"(want {want})")
    refresh_ms_median = statistics.median(refresh_s[timed]) * 1e3
    if "device_busy_ms" in prof:
        # the profiler stretches the refresh it traces; this share sets the
        # same busy time against the unprofiled median instead
        prof["device_idle_share_vs_median"] = 1 - prof["device_busy_ms"] / refresh_ms_median
    report = {
        "shape": list(snap.shape), "mask_rows": int(snap.fit_mask.shape[0]),
        "placed": placed, "feasible": feasible, "members_placed": members,
        "batches": batches, "launches_by_kernel": launches,
        "telemetry": telemetry,
        "host_pack_ms_median": statistics.median(scorer.pack_seconds[timed]) * 1e3,
        "device_batch_ms_median": statistics.median(scorer.batch_seconds[timed]) * 1e3,
        "refresh_ms_median": refresh_ms_median,
        "timed_runs": len(refresh_s[timed]),
        "keyframe_refresh_ms_median": statistics.median(keyframe_s[2:]) * 1e3,
        "keyframe_refresh_ms": [t * 1e3 for t in keyframe_s[2:]],
        "keyframe_pack_ms_median": statistics.median(keyframe_pack_s[2:]) * 1e3,
        "scan_pack_ms_median": statistics.median(scan_pack_s[1:]) * 1e3,
        "sync_ms_median": statistics.median(sync_s[timed]) * 1e3,
        "packer": stats["packer"], "device_state": stats["device_state"],
        "peak_device_mib": torch.cuda.max_memory_allocated() / 2**20,
        **prof,
    }
    return scorer, launches, report


@phase("north_star")
def north_star(results):
    from batch_scheduler_tpu_torch.ops.assign_scan import assign_gangs_cuda, assign_gangs_plain

    scorer, launches, report = drive_north_star(None)
    batches = report["batches"]
    if launches["assign_scan"] != batches or launches["assign_wave"] != 0 \
            or launches["assign_policy"] != 0 or launches["assign_topk"] != 0:
        raise AssertionError(f"{launches} launches in {batches} batches "
                             "(want assign_scan once per batch, assign_wave never)")
    args = scan_inputs(scorer.snapshot.device_args())
    plan = serial_plan(*args[0].shape)
    if plan.cluster_blocks < 2:
        raise AssertionError(f"north-star plan {plan} is not a cluster")
    want = assign_gangs_plain(*args)
    err, equal = compare_scan(args, want)
    if not equal:
        raise AssertionError(f"kernel disagrees with the plain scan (max abs err {err})")
    kernel_ms = cuda_ms(lambda: assign_gangs_cuda(*args), 20)
    kernel_ms2 = cuda_ms(lambda: assign_gangs_cuda(*args), 20)
    steps = design_steps(args, want, plan)
    plain_ms = cuda_ms(lambda: assign_gangs_plain(*args), 2)
    from batch_scheduler_tpu_torch.ops.bounds import scan_bound

    bound_ms, bound_by, nbytes, ops = scan_bound(*args)
    ms = min(kernel_ms, kernel_ms2)
    gangs = args[1].shape[0]
    results["assign_scan"] = {
        "launches": launches["assign_scan"],
        "launches_by_path": {"north_star": launches["assign_scan"]},
        "max_abs_err": err, "matched": equal,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "cluster_blocks": plan.cluster_blocks, "leftover": plan.leftover,
        "us_per_gang": ms * 1e3 / gangs,
    }
    return {
        **report, "launches": launches["assign_scan"],
        "kernel_ms": [kernel_ms, kernel_ms2], "plain_ms": plain_ms,
        "plan": plan._asdict(), "us_per_gang": ms * 1e3 / gangs,
        "design_steps": steps,
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "int_ops": ops,
        "kernel_vs_plain_equal": equal,
    }


def design_steps(args, want, plan, wave=0):
    """A kernel on the north-star inputs at cluster sizes 1 and 8 beside the
    device's plan: the serial kernel, or the wave kernel at width ``wave``
    (> 0). Each is launched through the wrapper's launcher (not counted),
    checked against the plain result (with the per-wave flags for the wave
    kernel) and timed, 20 launches in two rounds of alternating sizes."""
    from batch_scheduler_tpu_torch.ops.assign_scan import (
        _launch_scan, _launch_wave, _shared_budget, kernel_plan, wave_kernel_plan)

    n, r = args[0].shape
    if wave:
        layout, name = wave_kernel_plan, "assign_wave"
        launch = lambda p: _launch_wave(p, *args, wave)  # noqa: E731
        flat = lambda out: list(out[:3]) + list(out[3])  # noqa: E731
    else:
        layout, name = kernel_plan, "assign_scan"
        launch = lambda p: _launch_scan(p, *args)  # noqa: E731
        flat = list
    plans = {c: layout(n, r, c, _shared_budget(0, name)) for c in (1, 8)}
    plans[plan.cluster_blocks] = plan
    times = {c: [] for c in sorted(plans)}
    for rnd in range(2):
        for c in sorted(plans, reverse=bool(rnd)):
            if rnd == 0:
                err, equal = max_err(flat(launch(plans[c])), flat(want))
                if not equal:
                    raise AssertionError(f"{name} at C={c} disagrees with the plain "
                                         f"scan (max abs err {err})")
            times[c].append(cuda_ms(lambda: launch(plans[c]), 20))
    steps = -(-args[1].shape[0] // wave) if wave else args[1].shape[0]
    unit = "us_per_wave" if wave else "us_per_gang"
    return [{"cluster_blocks": c, "threads": plans[c].threads,
             "per_thread": plans[c].per_thread, "leftover": plans[c].leftover,
             "ms": times[c], unit: min(times[c]) * 1e3 / steps}
            for c in sorted(plans)]


@phase("north_star_wave")
def north_star_wave(results):
    from batch_scheduler_tpu_torch.ops.assign_scan import (
        assign_gangs_cuda, assign_gangs_plain, assign_gangs_wave_cuda)
    from batch_scheduler_tpu_torch.ops.oracle import assign_gangs_wavefront

    wave = 8
    scorer, launches, report = drive_north_star(wave)
    plan = wave_plan(*NORTH_STAR_SHAPE[1:])
    if plan.cluster_blocks < 2:
        raise AssertionError(f"north-star wave plan {plan} is not a cluster")
    batches = report["batches"]
    if launches["assign_wave"] != batches or launches["assign_scan"] != 0 \
            or launches["assign_policy"] != 0 or launches["assign_topk"] != 0:
        raise AssertionError(f"{launches} launches in {batches} batches "
                             "(want assign_wave once per batch, assign_scan never)")
    waves = NORTH_STAR_SHAPE[0] // wave
    want = {"wave_width": wave, "waves_per_batch": waves, "wave_uniform": waves,
            "wave_demotions": 0}
    got = {k: report["telemetry"].get(k) for k in want}
    if got != want:
        raise AssertionError(f"wave telemetry {got} != {want}")
    args = scan_inputs(scorer.snapshot.device_args())
    serial = assign_gangs_plain(*args)
    err, equal, conflicts, megas = compare_wave(args, wave, serial)
    if not equal:
        raise AssertionError(f"wave kernel disagrees with the plain scans (max abs err {err})")
    serial_err, serial_equal = compare_scan(args, serial)
    if not serial_equal:
        raise AssertionError(f"serial kernel disagrees with the plain scan "
                             f"(max abs err {serial_err})")
    # both kernels on the same inputs, in turns: serial, wave, wave, serial
    serial_ms = [cuda_ms(lambda: assign_gangs_cuda(*args), 20)]
    wave_ms = [cuda_ms(lambda: assign_gangs_wave_cuda(*args, wave), 20)]
    wave_ms.append(cuda_ms(lambda: assign_gangs_wave_cuda(*args, wave), 20))
    serial_ms.append(cuda_ms(lambda: assign_gangs_cuda(*args), 20))
    plain = assign_gangs_wavefront(*args, wave=wave, with_stats=True)
    plain_ms = cuda_ms(
        lambda: assign_gangs_wavefront(*args, wave=wave, with_stats=True), 2)
    steps = design_steps(args, plain, plan, wave)
    from batch_scheduler_tpu_torch.ops.bounds import scan_bound

    bound_ms, bound_by, nbytes, ops = scan_bound(*args, wave=wave)
    waves = len(conflicts)
    results["assign_wave"] = {
        "launches": launches["assign_wave"],
        "launches_by_path": {"north_star_wave": launches["assign_wave"]},
        "max_abs_err": err, "matched": equal,
        "ms": min(wave_ms), "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "cluster_blocks": plan.cluster_blocks, "leftover": plan.leftover,
        "us_per_wave": min(wave_ms) * 1e3 / waves,
    }
    return {
        **report, "launches": launches["assign_wave"],
        "plan": plan._asdict(), "design_steps": steps,
        "us_per_wave": min(wave_ms) * 1e3 / waves,
        "kernel_ms": wave_ms, "serial_kernel_ms": serial_ms, "plain_ms": plain_ms,
        "serial_kernel_vs_plain_equal": serial_equal,
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "int_ops": ops,
        "kernel_vs_plain_equal": equal,
        "kernel_waves": {"waves": len(conflicts), "demoted": int(conflicts.sum()),
                         "uniform": int(megas.sum())},
    }


HOST_KEYS = ("placed", "gang_feasible", "progress", "best", "best_exists",
             "assignment_nodes", "assignment_counts")
CHURN_ROWS = 16  # benchmarks/delta_gate.py:72
CHURN_GANGS = 4
CHURN_WIDE_ROWS = 1000  # the top of benchmarks/delta_gate.py:73's sweep
CHURN_ROUNDS, CHURN_WARMUP = 10, 2
# the rounds that move a gang's priority (the order re-derives on the
# card) and a gang's member request (a [G,R] row scatters on the card)
CHURN_PRIORITY_ROUND, CHURN_REQUEST_ROUND = CHURN_ROUNDS // 2, 3


def north_star_state():
    """The north-star deployment held in the port's ClusterState (the
    provider with event hooks), with north_star_cluster's gangs."""
    from batch_scheduler_tpu_torch.framework import ClusterState

    static, cache = north_star_cluster()
    cluster = ClusterState()
    for node in static.nodes:
        cluster.add_node(node)
    return cluster, cache


class Churn:
    """One round of north_star_churn's churn on a ClusterState per call
    ``churn(r)``: CHURN_ROWS node rows change (assume of a 1-cpu pod on
    half of them, forget of the previous round's pods on the other half,
    rotating through the node list) and CHURN_GANGS gangs' progress rows
    (``status.scheduled``, each named to ``mark``); round
    CHURN_PRIORITY_ROUND also moves a gang's priority (the queue order
    re-derives on the card) and round CHURN_REQUEST_ROUND a gang's member
    request (a [G,R] row scatters there). ``pods`` holds the churn pods
    left, for callers that assume more."""

    def __init__(self, cluster, cache, mark, rounds, extra_pods=0):
        from batch_scheduler_tpu_torch.sim.scenarios import make_member_pods

        self.cluster, self.cache, self.mark = cluster, cache, mark
        self.names = sorted(cache.snapshot())
        self.node_names = [n.metadata.name for n in cluster.list_nodes()]
        self.pods = iter(make_member_pods("churn", rounds * CHURN_ROWS + extra_pods,
                                          {"cpu": "1"}))
        self.held = []  # the previous round's assumed pods

    def __call__(self, r):
        cluster, cache, names = self.cluster, self.cache, self.names
        for uid in self.held:
            cluster.forget(uid)
        self.held = []
        for k in range(CHURN_ROWS // 2):
            pod = next(self.pods)
            cluster.assume(pod, self.node_names[(r * CHURN_ROWS + k) % len(self.node_names)])
            self.held.append(pod.metadata.uid)
        for k in range(CHURN_GANGS):
            name = names[(r * CHURN_GANGS + k) % len(names)]
            cache.get(name).pod_group.status.scheduled += 1
            self.mark(name)
        if r == CHURN_PRIORITY_ROUND:
            name = names[-1]
            cache.get(name).pod.spec.priority = 5  # jumps the queue
            self.mark(name)
        if r == CHURN_REQUEST_ROUND:
            name = names[len(names) // 2]
            cache.get(name).pod_group.spec.min_resources = {
                "cpu": 2000, "memory": 4 * 1024**3, GPU: 1}
            self.mark(name)


def full_pack_diff(scorer, cluster, cache):
    """What differs between the scorer's last batch and the full pack of
    the same state: one ClusterSnapshot of read_cluster_inputs (the path
    every refresh took before the delta packer, which shares no row
    packing with it) run as one batch on the card. Compares the host dict
    and the wave telemetry, and — for a scorer with resident state — all
    seven batch args the holder handed the batch (resident lanes, the host
    tail, the derived fit row and order) with the full pack's arrays. The
    full pack's kernel launches are restored: comparisons do not count."""
    import numpy as np

    from batch_scheduler_tpu_torch.core.oracle_scorer import read_cluster_inputs
    from batch_scheduler_tpu_torch.ops.oracle import execute_batch_host
    from batch_scheduler_tpu_torch.ops.snapshot import ClusterSnapshot

    saved = read_counts()
    snap = ClusterSnapshot(*read_cluster_inputs(cluster, cache))
    want, _ = execute_batch_host(snap.device_args(), snap.progress_args(), device="cuda")
    restore_counts(saved)
    got = scorer._state.result
    diff = [k for k in HOST_KEYS if not np.array_equal(got[k], want[k])]
    diff += [f"telemetry.{k}" for k in WAVE_TELEMETRY
             if got["telemetry"].get(k) != want["telemetry"].get(k)]
    args = scorer._device_state.last_args()
    if args is not None:
        diff += [f"batch arg {i}" for i, (a, h) in enumerate(zip(args, snap.device_args()))
                 if not np.array_equal(a.cpu().numpy() if hasattr(a, "cpu") else a, h)]
    return diff


def drive_north_star_churn(wave):
    """The north-star deployment in a ClusterState through
    ``OracleScorer(device="cuda")`` with ``BST_SCAN_WAVE`` set to ``wave``
    (None: unset): a first refresh, then CHURN_ROUNDS rounds of churn,
    each followed by one refresh (the first CHURN_WARMUP untimed); a round
    is one call of ``Churn``, its gangs named by ``mark_dirty(group=...)``.
    Both kernels' counts are zeroed just before the rounds and read just
    after. After every refresh the scorer must equal the full pack
    (full_pack_diff). Report-only, each round also refreshes a second
    scorer whose packs skip the holder (the same fold, every batch's
    arrays uploaded whole, as before the holder) on the same
    ClusterState, in turns with the first (its launches restored), held
    to the full pack too. Then one
    profiled churn refresh and one report-only round of CHURN_WIDE_ROWS
    node rows. Returns (launches by kernel, report)."""
    import torch

    from batch_scheduler_tpu_torch.core import OracleScorer

    cluster, cache = north_star_state()
    node_names = [n.metadata.name for n in cluster.list_nodes()]

    class UploadScorer(OracleScorer):
        """The same scorer with the holder skipped: the batch uploads the
        pack's host arrays whole."""

        def _note_pack(self, snap):
            snap.device_state_args = snap.device_args()

    scorer = OracleScorer(device="cuda")
    upload = UploadScorer(device="cuda")

    def mark(name):
        scorer.mark_dirty(group=name)
        upload.mark_dirty(group=name)

    churn = Churn(cluster, cache, mark, 4 * CHURN_ROUNDS, extra_pods=CHURN_WIDE_ROWS)

    def compare(label, who=scorer):
        diff = full_pack_diff(who, cluster, cache)
        if diff:
            kind = "resident" if who is scorer else "upload"
            raise AssertionError(f"{label}: the {kind} scorer differs from the full pack "
                                 f"in {diff}")

    def timed_refresh(who):
        t0 = time.perf_counter()
        who.refresh(cluster, cache)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def refresh_upload(label, out):
        saved = read_counts()
        out.append(timed_refresh(upload))
        restore_counts(saved)
        compare(label, upload)

    with scan_wave_env(wave):
        scorer.refresh(cluster, cache)
        compare("first refresh")
        refresh_upload("first refresh", [])
        first = scorer.last_fold_outcome
        # the main path: counts zeroed just before, read just after
        zero_counts()
        refresh_s, upload_s, outcomes, group_rows = [], [], [], {}
        for r in range(1, CHURN_ROUNDS):
            churn(r)
            if r % 2:  # the two scorers in turns
                refresh_upload(f"round {r}", upload_s)
            refresh_s.append(timed_refresh(scorer))
            outcomes.append(scorer.last_fold_outcome)
            if len(scorer.snapshot.delta.group_rows):
                group_rows[r] = scorer.snapshot.delta.group_rows.tolist()
            compare(f"round {r}")
            if not r % 2:
                refresh_upload(f"round {r}", upload_s)
        launches = read_counts()
        refreshes = CHURN_ROUNDS - 1
        stats = scorer.stats()
        telemetry = dict(scorer.last_telemetry)
        pack_s, batch_s = scorer.pack_seconds[1:], scorer.batch_seconds[1:]
        fold_s, sync_s = scorer.pack_seconds_by_path["fold"], scorer.sync_seconds[1:]
        upload_pack_s, upload_batch_s = upload.pack_seconds[1:], upload.batch_seconds[1:]
        upload_outcomes = dict(upload.fold_outcomes)
        if len(fold_s) != refreshes:
            raise AssertionError(f"{len(fold_s)} fold packs in {refreshes} refreshes")
        churn(CHURN_ROUNDS)
        try:
            prof = profile_refresh(scorer, cluster, cache)
        except Exception as e:  # noqa: BLE001 — a measurement, not a check
            prof = {"profile": f"failed: {e!r}"[:300]}
        compare("profiled round")
        # report-only: CHURN_WIDE_ROWS node rows in one round
        for k in range(CHURN_WIDE_ROWS):
            cluster.assume(next(churn.pods), node_names[(7 * k + 3) % len(node_names)])
        wide_s = timed_refresh(scorer)
        wide = {"node_rows": CHURN_WIDE_ROWS, "outcome": scorer.last_fold_outcome,
                "rows_scattered": int(len(scorer.snapshot.delta.node_rows)),
                "refresh_ms": wide_s * 1e3,
                "host_pack_ms": scorer.pack_seconds[-1] * 1e3,
                "device_batch_ms": scorer.batch_seconds[-1] * 1e3}
        compare("wide round")
    timed = slice(CHURN_WARMUP - 1, None)
    ds = stats["device_state"]
    if first != "no-base" or any(o != "folded" for o in outcomes):
        raise AssertionError(f"fold outcomes: first {first}, rounds {outcomes}")
    if upload_outcomes != {"no-base": 1, "folded": refreshes}:
        raise AssertionError(f"upload scorer fold outcomes {upload_outcomes}")
    if ds["keyframes"] != {"first": 1}:
        raise AssertionError(f"keyframes {ds['keyframes']} (want only the first)")
    if ds["derives"] != 2:
        raise AssertionError(f"{ds['derives']} derivations (want the first and the "
                             "priority round's)")
    if list(group_rows) != [CHURN_REQUEST_ROUND] or len(group_rows[CHURN_REQUEST_ROUND]) != 1:
        raise AssertionError(f"[G,R] rows scattered by round: {group_rows} (want one row "
                             f"in round {CHURN_REQUEST_ROUND})")
    med = lambda xs: statistics.median(xs[timed]) * 1e3  # noqa: E731
    refresh_ms_median = med(refresh_s)
    if "device_busy_ms" in prof:
        prof["device_idle_share_vs_median"] = 1 - prof["device_busy_ms"] / refresh_ms_median
    report = {
        "shape": list(scorer.snapshot.shape), "churn_rows": CHURN_ROWS,
        "churn_gangs": CHURN_GANGS, "refreshes": refreshes,
        "timed_runs": len(refresh_s[timed]), "launches_by_kernel": launches,
        "refresh_ms_median": refresh_ms_median,
        "host_pack_ms_median": med(pack_s),
        "device_batch_ms_median": med(batch_s),
        "fold_pack_ms_median": med(fold_s),
        "sync_ms_median": med(sync_s),
        "refresh_ms": [t * 1e3 for t in refresh_s[timed]],
        # report-only: the same fold with every batch's arrays uploaded
        "upload_refresh_ms_median": med(upload_s),
        "upload_host_pack_ms_median": med(upload_pack_s),
        "upload_device_batch_ms_median": med(upload_batch_s),
        "upload_refresh_ms": [t * 1e3 for t in upload_s[timed]],
        "fold_outcomes": stats["fold_outcomes"], "keyframes": ds["keyframes"],
        "rows_scattered": ds["rows_scattered"], "group_rows_by_round": group_rows,
        "derived_batches": ds["derived_batches"],
        "derives": ds["derives"], "packer": stats["packer"],
        "event_log": stats.get("event_log"), "telemetry": telemetry,
        "equal_full_pack": True, "wide_round": wide,
        **prof,
    }
    return launches, report


# report-only: the holder's scatter against the whole upload it replaces,
# at the north star and at two larger node counts (buckets 65536, 262144)
RESIDENCY_NODES = (NORTH_STAR_NODES, 40000, 150000)
RESIDENCY_TRIALS = 9


def residency_vs_upload():
    """Report-only, per node count in RESIDENCY_NODES (north-star node and
    gang shapes): after a first full pack, RESIDENCY_TRIALS event folds of
    CHURN_ROWS node rows each; per fold, in turns, the card-side inputs of
    one batch made two ways and synchronized — the holder's ``sync`` (row
    scatter, cached derive) plus the upload of what stays host, against
    ``batch_from_numpy`` of the whole pack (what every batch uploaded
    before the holder). The two sets of tensors must be equal. Medians in ms, and
    the bytes the whole upload moves."""
    import numpy as np
    import torch

    from batch_scheduler_tpu_torch.ops.convert import batch_from_numpy
    from batch_scheduler_tpu_torch.ops.device_state import DeviceStateHolder
    from batch_scheduler_tpu_torch.ops.snapshot import DeltaSnapshotPacker, GroupDemand
    from batch_scheduler_tpu_torch.sim.scenarios import make_sim_node

    groups = [GroupDemand(full_name=f"default/gang-{g:04d}", min_member=10,
                          member_request={"cpu": 4000, "memory": 8 * 1024**3, GPU: 1},
                          creation_ts=float(g))
              for g in range(NORTH_STAR_GANGS)]
    out = []
    for count in RESIDENCY_NODES:
        nodes = [make_sim_node(f"n{i:06d}", {"cpu": "64", "memory": "256Gi", "pods": "110",
                                             GPU: "8"})
                 for i in range(count)]
        node_req = {n.metadata.name: {} for n in nodes}
        packer = DeltaSnapshotPacker()
        holder = DeviceStateHolder("cuda", label="residency")
        snap = packer.pack(nodes, node_req, groups)
        holder.sync(snap)
        resident_s, upload_s = [], []

        def resident():
            args = holder.sync(snap)
            got, _ = batch_from_numpy(args, snap.progress_args(), "cuda")
            return got

        def upload():
            got, _ = batch_from_numpy(snap.device_args(), snap.progress_args(), "cuda")
            return got

        for t in range(RESIDENCY_TRIALS):
            updates = []
            for k in range(CHURN_ROWS):
                name = nodes[(t * CHURN_ROWS + k) * 7 % count].metadata.name
                node_req[name] = {"cpu": 1000 * (t + 1), "pods": t + 1}
                updates.append((name, node_req[name]))
            snap = packer.pack_fold(updates, [])
            if snap is None:
                raise AssertionError(f"{count} nodes: the fold did not apply")
            got = {}
            for name, fn, times in (("resident", resident, resident_s),
                                    ("upload", upload, upload_s))[::1 if t % 2 else -1]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got[name] = fn()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            bad = [i for i, (a, b) in enumerate(zip(got["resident"], got["upload"]))
                   if not torch.equal(a, b)]
            if bad:
                raise AssertionError(f"{count} nodes, fold {t}: resident args {bad} differ "
                                     "from the upload")
        args = snap.device_args()
        out.append({
            "nodes": count, "n_bucket": int(args[0].shape[0]),
            "upload_bytes": int(sum(np.asarray(a).nbytes for a in args)),
            "resident_ms_median": statistics.median(resident_s[1:]) * 1e3,
            "upload_ms_median": statistics.median(upload_s[1:]) * 1e3,
            "resident_ms": [x * 1e3 for x in resident_s[1:]],
            "upload_ms": [x * 1e3 for x in upload_s[1:]],
        })
        del nodes, node_req, packer, holder, snap
    return out


@phase("north_star_churn")
def north_star_churn(results):
    launches, report = drive_north_star_churn(None)
    n = report["refreshes"]
    if launches["assign_scan"] != n or launches["assign_wave"] != 0 \
            or launches["assign_policy"] != 0 or launches["assign_topk"] != 0:
        raise AssertionError(f"{launches} launches in {n} refreshes "
                             "(want assign_scan once per refresh, assign_wave never)")
    if "assign_scan" in results:
        results["assign_scan"]["launches_by_path"]["north_star_churn"] = launches["assign_scan"]
    FIGURES["north_star_churn"] = report["refresh_ms_median"]
    return {**report, "launches": launches["assign_scan"],
            "residency_vs_upload": residency_vs_upload()}


@phase("north_star_churn_wave")
def north_star_churn_wave(results):
    wave = 8
    launches, report = drive_north_star_churn(wave)
    n = report["refreshes"]
    if launches["assign_wave"] != n or launches["assign_scan"] != 0 \
            or launches["assign_policy"] != 0 or launches["assign_topk"] != 0:
        raise AssertionError(f"{launches} launches in {n} refreshes "
                             "(want assign_wave once per refresh, assign_scan never)")
    tele = report["telemetry"]
    if tele.get("wave_width") != wave or tele.get("waves_per_batch") != NORTH_STAR_SHAPE[0] // wave:
        raise AssertionError(f"wave telemetry {tele}")
    if "assign_wave" in results:
        results["assign_wave"]["launches_by_path"]["north_star_churn_wave"] = \
            launches["assign_wave"]
    FIGURES["north_star_churn_wave"] = report["refresh_ms_median"]
    return {**report, "launches": launches["assign_wave"]}


# the metrics phase: the in-process batch path's series in the port's
# DEFAULT_REGISTRY (the reference's names, kinds and labels), read as
# deltas across north_star_churn's churn and held against what the scorer,
# its packer and its holder count themselves
METRICS_ROUNDS = 8  # churn refreshes after the keyframe
METRICS_AB_PAIRS = 10  # report-only: churn refreshes with recording on / off
METRICS_COUNTERS = (
    "bst_oracle_batches_total", "bst_event_folds_total", "bst_scan_waves_total",
    "bst_scan_wave_demotions_total", "bst_scan_wave_uniform_total",
    "bst_pack_rows_rewritten", "bst_refresh_lite_packs_total",
    "bst_pack_policy_rows_rewritten", "bst_refresh_order_resorts_total",
    "bst_policy_label_truncations_total", "bst_device_keyframe_resyncs_total",
    "bst_device_rows_scattered_total", "bst_refresh_derived_batches_total",
)
METRICS_GAUGES = ("bst_oracle_inflight_batches", "bst_scan_wave_enabled",
                  "bst_device_state_generation")
METRICS_HISTOGRAMS = ("bst_oracle_batch_seconds", "bst_oracle_pack_seconds",
                      "bst_scan_waves_per_batch")
# launches of paths whose kernel's results entry is made by a later phase,
# merged into the kernels line at the end: {(kernel, path): launches}
LATE_PATHS = {}
FIGURES = {}  # figures one phase reports beside another's


def registry_series():
    """The batch path's series in the port's DEFAULT_REGISTRY: counters
    and gauges by label set, histograms by observation count."""
    from batch_scheduler_tpu_torch.utils.metrics import DEFAULT_REGISTRY

    out = {}
    for name in METRICS_COUNTERS + METRICS_GAUGES:
        m = DEFAULT_REGISTRY.get(name)
        out[name] = {} if m is None else {
            ",".join(f"{k}={v}" for k, v in key): val for key, val in m.values().items()}
    for name in METRICS_HISTOGRAMS:
        m = DEFAULT_REGISTRY.get(name)
        out[name] = {} if m is None else {
            ",".join(f"{k}={v}" for k, v in key): snap[2]
            for key, snap in m.snapshots().items()}
    return out


def series_delta(before, after):
    """Counters and histogram counts as differences (label sets that
    moved); gauges as their values after."""
    out = {}
    for name, now in after.items():
        if name in METRICS_GAUGES:
            out[name] = dict(now)
        else:
            out[name] = {k: v - before[name].get(k, 0) for k, v in now.items()
                         if v != before[name].get(k, 0)}
    return out


class _NullMetric:
    def inc(self, *args, **labels):
        pass

    set = observe = inc


@contextlib.contextmanager
def recording_off():
    """The port's DEFAULT_REGISTRY records nothing inside the block: its
    counter / gauge / histogram lookups answer a metric that drops every
    value (every module shares the one registry object)."""
    from batch_scheduler_tpu_torch.utils.metrics import DEFAULT_REGISTRY

    null = _NullMetric()
    for kind in ("counter", "gauge", "histogram"):
        setattr(DEFAULT_REGISTRY, kind, lambda *args, **kwargs: null)
    try:
        yield
    finally:
        for kind in ("counter", "gauge", "histogram"):
            delattr(DEFAULT_REGISTRY, kind)


def drive_metrics(wave):
    """north_star_churn's deployment and churn through a fresh
    ``OracleScorer(device="cuda")`` with ``BST_SCAN_WAVE`` at ``wave``: a
    keyframe refresh and METRICS_ROUNDS churn refreshes (16 node rows and 4
    gang rows each), the registry read just before and just after, kernel
    counts zeroed and read around the same refreshes. Every series must
    agree with what the run counts itself. Report-only, then
    METRICS_AB_PAIRS pairs of churn refreshes with the recording on and
    off (``recording_off``), in turns, which side first alternating.
    Returns (launches, report)."""
    import torch

    from batch_scheduler_tpu_torch.core import OracleScorer

    cluster, cache = north_star_state()
    scorer = OracleScorer(device="cuda")
    churn = Churn(cluster, cache, lambda name: scorer.mark_dirty(group=name),
                  METRICS_ROUNDS + 1 + 2 * METRICS_AB_PAIRS)
    refresh_s, tele = [], []

    def timed_refresh():
        t0 = time.perf_counter()
        scorer.refresh(cluster, cache)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    with scan_wave_env(wave):
        before = registry_series()
        zero_counts()
        for r in range(METRICS_ROUNDS + 1):
            if r:
                churn(r)
            refresh_s.append(timed_refresh())
            tele.append(dict(scorer.last_telemetry))
        launches = read_counts()
        delta = series_delta(before, registry_series())
        stats = scorer.stats()
        saved = read_counts()
        on_s, off_s = [], []
        r = METRICS_ROUNDS + 1
        for pair in range(METRICS_AB_PAIRS):
            for recording in ((True, False) if pair % 2 else (False, True)):
                churn(r)
                r += 1
                if recording:
                    on_s.append(timed_refresh())
                else:
                    with recording_off():
                        off_s.append(timed_refresh())
        restore_counts(saved)
    ds, packer = stats["device_state"], stats["packer"]
    batches = METRICS_ROUNDS + 1
    one = lambda n: {"": n} if n else {}  # noqa: E731 — an unlabelled series
    want = {
        "bst_oracle_batches_total": one(batches),
        "bst_oracle_batch_seconds": one(batches),
        "bst_oracle_pack_seconds": one(batches),
        "bst_event_folds_total": {f"outcome={k}": v for k, v in stats["fold_outcomes"].items()},
        "bst_device_keyframe_resyncs_total": {f"reason={k}": v
                                              for k, v in ds["keyframes"].items()},
        "bst_device_rows_scattered_total": one(ds["rows_scattered"]),
        "bst_refresh_derived_batches_total": one(ds["derived_batches"]),
        "bst_pack_rows_rewritten": one(packer["rows_rewritten"]),
        "bst_refresh_lite_packs_total": {
            **({"path=scan": packer["lite_packs"]} if packer["lite_packs"] else {}),
            **({"path=fold": packer["fold_packs"]} if packer["fold_packs"] else {})},
        "bst_refresh_order_resorts_total": one(packer["order_resorts"]),
        "bst_pack_policy_rows_rewritten": {},
        "bst_policy_label_truncations_total": {},
        "bst_scan_waves_total": one(sum(t.get("waves_per_batch", 0) for t in tele)),
        "bst_scan_wave_demotions_total": one(sum(t.get("wave_demotions", 0) for t in tele)),
        "bst_scan_wave_uniform_total": one(sum(t.get("wave_uniform", 0) for t in tele)),
        "bst_scan_waves_per_batch": one(batches if wave else 0),
    }
    bad = {name: {"recorded": delta[name], "want": w} for name, w in want.items()
           if {k: float(v) for k, v in delta[name].items()}
           != {k: float(v) for k, v in w.items()}}
    gauges = {"bst_oracle_inflight_batches": 0.0, "bst_scan_wave_enabled": 1.0}
    bad.update({name: {"recorded": delta[name].get(""), "want": v}
                for name, v in gauges.items() if delta[name].get("") != v})
    gen = delta["bst_device_state_generation"].get("holder=scorer")
    if gen != ds["generation"]:
        bad["bst_device_state_generation"] = {"recorded": gen, "want": ds["generation"]}
    if bad:
        raise AssertionError(f"series disagree with the run's own counts: {bad}")
    if stats["fold_outcomes"] != {"no-base": 1, "folded": METRICS_ROUNDS}:
        raise AssertionError(f"fold outcomes {stats['fold_outcomes']}")
    timed = refresh_s[1 + CHURN_WARMUP - 1:]
    return launches, {
        "refreshes": batches, "launches_by_kernel": launches,
        "refresh_ms_median": statistics.median(timed) * 1e3,
        "refresh_ms": [t * 1e3 for t in timed],
        "keyframe_refresh_ms": refresh_s[0] * 1e3,
        # report-only: the same churn with the recording on and off in turns
        "recording_on_ms_median": statistics.median(on_s) * 1e3,
        "recording_off_ms_median": statistics.median(off_s) * 1e3,
        "recording_on_ms": [t * 1e3 for t in on_s],
        "recording_off_ms": [t * 1e3 for t in off_s],
        "series": delta,
    }


@phase("metrics")
def metrics(results):
    """The metrics phase, serial and at W=8 (see drive_metrics), beside
    north_star_churn(_wave)'s medians of the same churn."""
    out = {}
    for wave, kernel, path in ((None, "assign_scan", "metrics"),
                               (8, "assign_wave", "metrics_wave")):
        launches, report = drive_metrics(wave)
        others = [k for k in KERNELS if k != kernel and launches[k]]
        if launches[kernel] != report["refreshes"] or others:
            raise AssertionError(f"{path}: {launches} launches in {report['refreshes']} "
                                 f"refreshes (want {kernel} once a refresh, no other)")
        LATE_PATHS[(kernel, path)] = launches[kernel]
        report["north_star_churn_refresh_ms_median"] = FIGURES.get(
            "north_star_churn" if wave is None else "north_star_churn_wave")
        out["serial" if wave is None else "wave8"] = report
    # the scheduler loop's series (framework.scheduler, plugin.batch_plugin,
    # the ledger's time to placement) against its own counts
    launches, out["framework"] = drive_framework_metrics()
    LATE_PATHS[("assign_scan", "metrics_framework")] = launches["assign_scan"]
    return out


# the observability phases: north_star_churn's deployment and churn traced
# (utils.trace on, every root kept) through a ScheduleOperation's scorer
OBS_ROUNDS = 8  # churn refreshes after the keyframe
OBS_AB_PAIRS = 10  # report-only: churn refreshes with tracing on / off in turns
OBS_SCRAPE_ROUNDS = 4  # churn refreshes on a thread while every route is scraped
OBS_SIDECAR_ROUNDS = 2  # traced remote refreshes: a keyframe, then a wire delta
OBS_EVAL_REPS = 20  # report-only: HealthModel.evaluate() calls timed
# the reference's span tree of one traced in-process refresh: (span, parent)
OBS_TREE = {
    "keyframe": sorted([("schedule_cycle", None), ("oracle.refresh", "schedule_cycle"),
                        ("oracle.snapshot_pack", "oracle.refresh"),
                        ("oracle.device_state_sync", "oracle.refresh"),
                        ("oracle.batch", "oracle.refresh")]),
    "fold": sorted([("schedule_cycle", None), ("oracle.refresh", "schedule_cycle"),
                    ("oracle.event_fold", "oracle.refresh"),
                    ("oracle.device_state_sync", "oracle.refresh"),
                    ("oracle.batch", "oracle.refresh")]),
}
# the sidecar's spans a TRACE_INFO reply carries (service/server.py)
OBS_SERVER_SPANS = ("oracle.schedule", "oracle.unpack_pad", "oracle.lock_wait",
                    "oracle.device_batch")
# every ported route and the reference's payload keys (utils/metrics.py);
# /debug/policy and /debug/capacity answer one of two shapes
OBS_ROUTE_KEYS = {
    "/debug/": [{"endpoints"}],
    "/debug/trace": [{"traceEvents", "displayTimeUnit", "otherData"}],
    "/debug/decisions": [{"decisions", "dropped_gangs"}],
    "/debug/gangs": [{"gangs", "count", "dropped_gangs"}],
    "/debug/events?since=0": [{"events", "cursor", "dropped"}],
    "/debug/health": [{"verdict", "ts", "window_s", "signals"}],
    "/debug/policy": [{"enabled"}, {"config", "registry", "columns", "counters", "enabled"}],
    "/debug/capacity": [{"enabled", "sampler", "hint"},
                        {"label", "samples", "skipped", "last_kernel_s", "budget_frac",
                         "lane_names", "last", "ring", "series", "enabled"}],
    # a bare GET describes the route (no device work)
    "/debug/explain": [{"usage", "serves"}],
    "/debug/whatif": [{"usage", "kinds", "serves"}],
    # PR 16's four: a bare GET of each reads a copy (a capture and a drain
    # need ?seconds= and ?go=1)
    "/debug/perf": [{"phases", "scan_rung_mix", "device_memory", "device_state", "audit",
                     "compile_ledger", "profiler"}],
    "/debug/profile": [{"profile_dir", "busy", "closed", "captures", "last_capture"}],
    "/debug/drain": [{"ok", "servers", "draining"}],
}
OBS_UNKNOWN = ("/debug/nope",)


class _EventTimed:
    """A scan wrapper's stand-in: records a CUDA event pair on the
    launching stream around each launch (no synchronization) and keeps the
    wrapped function's launch count."""

    def __init__(self, fn):
        self.fn = fn
        self.pairs = []

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, n):
        self.fn.launches = n

    def __call__(self, *args, **kwargs):
        import torch

        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.fn(*args, **kwargs)
        end.record()
        self.pairs.append((start, end))
        return out

    def take_ms(self):
        """The event times of the launches since the last call (each end
        event waited for: the batch has already completed)."""
        pairs, self.pairs = self.pairs, []
        for _, end in pairs:
            end.synchronize()
        return [start.elapsed_time(end) for start, end in pairs]


@contextlib.contextmanager
def kernel_event_times():
    """The three scan wrappers of ops.assign_scan replaced, in the block,
    by _EventTimed stand-ins (ops.oracle and ops.explain look them up at
    each call); yields {kernel: stand-in}."""
    from batch_scheduler_tpu_torch.ops import assign_scan

    timed = {"assign_scan": _EventTimed(assign_scan.assign_gangs_cuda),
             "assign_wave": _EventTimed(assign_scan.assign_gangs_wave_cuda),
             "assign_policy": _EventTimed(assign_scan.assign_gangs_policy_cuda)}
    assign_scan.assign_gangs_cuda = timed["assign_scan"]
    assign_scan.assign_gangs_wave_cuda = timed["assign_wave"]
    assign_scan.assign_gangs_policy_cuda = timed["assign_policy"]
    try:
        yield timed
    finally:
        assign_scan.assign_gangs_cuda = timed["assign_scan"].fn
        assign_scan.assign_gangs_wave_cuda = timed["assign_wave"].fn
        assign_scan.assign_gangs_policy_cuda = timed["assign_policy"].fn


def span_tree(events, ids=None):
    """(name, parent name) of each span event, sorted; ``ids`` maps the
    span ids of parents recorded elsewhere."""
    names = dict(ids or {})
    names.update({e["args"]["span_id"]: e["name"] for e in events if "span_id" in e["args"]})
    return sorted((e["name"], names.get(e["args"].get("parent_id"))) for e in events)


def no_tensor(obj):
    """True when ``obj`` holds no torch tensor (host values only)."""
    import torch

    if isinstance(obj, torch.Tensor):
        return False
    if isinstance(obj, dict):
        return all(no_tensor(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return all(no_tensor(v) for v in obj)
    return True


def http_get(port, path):
    """(status, body, ms) of one GET on the local metrics endpoint."""
    import urllib.error
    import urllib.request

    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as resp:
            status, body = resp.status, resp.read()
    except urllib.error.HTTPError as e:
        status, body = e.code, e.read()
    return status, body, (time.perf_counter() - t0) * 1e3


def check_routes(port):
    """Every route once: 200 and the reference's keys (``/metrics`` with the
    batch series, ``/healthz`` ok; ``/debug/buckets`` an entry a bucket that
    ran); an unknown path 404. Returns ({route: ms}, problems)."""
    ms, bad = {}, []
    status, body, ms["/metrics"] = http_get(port, "/metrics")
    if status != 200 or b"bst_oracle_batches_total" not in body \
            or b"bst_oracle_batch_seconds_bucket" not in body:
        bad.append(f"/metrics: {status}")
    status, body, ms["/healthz"] = http_get(port, "/healthz")
    if (status, body) != (200, b"ok\n"):
        bad.append(f"/healthz: {status} {body[:40]!r}")
    for route, shapes in OBS_ROUTE_KEYS.items():
        status, body, ms[route] = http_get(port, route)
        keys = set(json.loads(body)) if status == 200 else None
        if keys not in shapes:
            bad.append(f"{route}: {status} keys {keys}")
    status, body, ms["/debug/buckets"] = http_get(port, "/debug/buckets")
    buckets = json.loads(body) if status == 200 else None
    if not buckets or not all("rungs" in entry for entry in buckets.values()):
        bad.append(f"/debug/buckets: {status} {str(buckets)[:200]}")
    for route in OBS_UNKNOWN:
        status, body, _ = http_get(port, route)
        if (status, body) != (404, b""):
            bad.append(f"{route}: {status} (want 404, as an unknown path)")
    return ms, bad


def mixed_state(num_nodes, num_groups, seed):
    """mixed's node shapes and gang demands drawn from its seed, as a
    ClusterState and a status cache: 4 node shapes, gangs of 1-64 members
    in mixed's six demand shapes, ~3% asking 200 cpus (no node has more
    than 96: infeasible)."""
    import numpy as np

    from batch_scheduler_tpu_torch.api.types import PodGroupPhase
    from batch_scheduler_tpu_torch.cache import PGStatusCache, PodGroupMatchStatus
    from batch_scheduler_tpu_torch.framework import ClusterState
    from batch_scheduler_tpu_torch.sim.scenarios import (
        make_member_pods, make_sim_group, make_sim_node)

    rng = np.random.default_rng(seed)
    shapes = [
        {"cpu": "64", "memory": "256Gi", "ephemeral-storage": "100Gi", "pods": "110", GPU: "8"},
        {"cpu": "32", "memory": "128Gi", "ephemeral-storage": "50Gi", "pods": "110"},
        {"cpu": "96", "memory": "384Gi", "ephemeral-storage": "200Gi", "pods": "250", GPU: "4"},
        {"cpu": "16", "memory": "64Gi", "ephemeral-storage": "20Gi", "pods": "64"},
    ]
    demands = [
        {"cpu": "100m", "memory": "256Mi"},
        {"cpu": "500m", "memory": "1Gi", "ephemeral-storage": "512Mi"},
        {"cpu": "2", "memory": "4Gi"},
        {"cpu": "4", "memory": "8Gi", GPU: "1"},
        {"cpu": "8", "memory": "32Gi", "ephemeral-storage": "1Gi", GPU: "2"},
        {"cpu": "200", "memory": "1Gi"},
    ]
    kind = rng.integers(0, 4, size=num_nodes)
    cluster = ClusterState()
    for i in range(num_nodes):
        cluster.add_node(make_sim_node(f"m{i:05d}", shapes[kind[i]]))
    pick = rng.choice(len(demands), size=num_groups, p=[0.2, 0.2, 0.2, 0.2, 0.17, 0.03])
    members = rng.integers(1, 65, size=num_groups)
    cache = PGStatusCache()
    for k in range(num_groups):
        name = f"mixed-{k:04d}"
        pg = make_sim_group(name, int(members[k]), creation_ts=float(k))
        pg.status.phase = PodGroupPhase.PENDING
        pgs = PodGroupMatchStatus(pg)
        pgs.pod = make_member_pods(name, 1, demands[pick[k]])[0]
        pg.spec.min_resources = pgs.pod.resource_require()
        cache.set(pg.full_name(), pgs)
    return cluster, cache, int((pick == len(demands) - 1).sum())


def obs_denials(wave):
    """mixed_state through a ScheduleOperation on cuda, every gang's
    representative pod through PreFilter under a live trace: every denied
    gang's pre_filter record carries feasible_nodes equal to the served
    capacity row's count of nodes with room (0 for the gangs that fit no
    node). Returns (launches, report)."""
    from batch_scheduler_tpu_torch.core import ScheduleOperation
    from batch_scheduler_tpu_torch.utils import errors as errs
    from batch_scheduler_tpu_torch.utils import trace

    cluster, cache, infeasible = mixed_state(*MIXED)
    op = ScheduleOperation(cache, cluster, device="cuda")
    trace.DEFAULT_FLIGHT_RECORDER.clear()
    denied = []
    with scan_wave_env(wave):
        zero_counts()
        t0 = time.perf_counter()
        with trace.start_trace("schedule_cycle"):
            for name, pgs in sorted(cache.snapshot().items()):
                try:
                    op.pre_filter(pgs.pod)
                except errs.SchedulingError:
                    denied.append(name)
        prefilter_s = time.perf_counter() - t0
        launches = read_counts()
    state = op.oracle._state
    n_real = len(state.snapshot.node_names)
    bad, zero = [], 0
    for name in denied:
        recs = [r for r in trace.DEFAULT_FLIGHT_RECORDER.snapshot(gang=name).get(name, [])
                if r["phase"] == "pre_filter"]
        row = state.row("capacity", state.snapshot.group_index(name))
        want = int((row[:n_real] > 0).sum())
        zero += want == 0
        if len(recs) != 1 or recs[0].get("feasible_nodes") != want or \
                recs[0]["verdict"] != "denied" or not recs[0]["reason"]:
            bad.append((name, recs, want))
    if bad or zero < infeasible or not denied:
        raise AssertionError(f"denial records: {len(denied)} denied, {zero} with no node "
                             f"(want >= {infeasible}); disagreeing: {bad[:3]}")
    return launches, {"gangs": len(cache), "denied": len(denied),
                      "denied_fitting_no_node": zero, "infeasible_drawn": infeasible,
                      "prefilter_ms": prefilter_s * 1e3}


def obs_policy(wave):
    """One traced refresh of the policy deployment (POLICY_ENV) through a
    ScheduleOperation, every gang's pod through PreFilter: one ``policy``
    flight record a placed gang, its terms computed on the snapshot's host
    columns (numpy) with no capacity or score row read from the card.
    Returns (launches, report)."""
    import numpy as np

    from batch_scheduler_tpu_torch.core import ScheduleOperation
    from batch_scheduler_tpu_torch.core.oracle_scorer import _BatchState
    from batch_scheduler_tpu_torch.utils import trace

    with env_set({**POLICY_ENV, "BST_SCAN_WAVE": None if wave is None else str(wave)}):
        cluster, cache = policy_state()
        op = ScheduleOperation(cache, cluster, device="cuda")
        trace.DEFAULT_FLIGHT_RECORDER.clear()
        rows = [0]
        row = _BatchState.row

        def counted_row(self, kind, g):
            rows[0] += 1
            return row(self, kind, g)

        _BatchState.row = counted_row
        zero_counts()
        try:
            t0 = time.perf_counter()
            with trace.start_trace("schedule_cycle"):
                for name, pgs in sorted(cache.snapshot().items()):
                    op.pre_filter(pgs.pod)
            prefilter_s = time.perf_counter() - t0
        finally:
            _BatchState.row = row
        launches = read_counts()
    scorer = op.oracle
    names = sorted(cache.snapshot())
    placed = [n for n in names if scorer.placed(n)]
    records = {n: [r for r in recs if r["phase"] == "policy"]
               for n, recs in trace.DEFAULT_FLIGHT_RECORDER.snapshot().items()}
    per_gang = [len(records.get(n, [])) for n in placed]
    host_cols = all(isinstance(c, np.ndarray) for c in scorer.snapshot.policy_cols)
    if per_gang != [1] * len(placed) or len(placed) != len(names) or rows[0] or not host_cols:
        raise AssertionError(f"policy records: {len(placed)} of {len(names)} placed, "
                             f"records a placed gang {sorted(set(per_gang))}, {rows[0]} "
                             f"rows read from the card, host columns {host_cols}")
    terms = sorted({k for recs in records.values() for r in recs for k in r["terms"]})
    return launches, {"placed": len(placed), "policy_records": sum(per_gang),
                      "row_reads": rows[0], "terms": terms,
                      "prefilter_ms": prefilter_s * 1e3}


def obs_sidecar(wave):
    """Traced RemoteScorer refreshes (a keyframe, then one Churn round on
    wire deltas) against serve_background(device="cuda"): the round trip
    nests under oracle.batch, and the sidecar's four spans come back under
    the client's trace id with the round trip as their parent — twice, as
    the server's own ring and the client's are one ring in this process.
    Returns (launches, report)."""
    from batch_scheduler_tpu_torch.service import (
        RemoteScorer, ResilientOracleClient, serve_background)
    from batch_scheduler_tpu_torch.utils import trace

    with scan_wave_env(wave):
        server = serve_background(device="cuda")
        try:
            cluster, cache = north_star_state()
            remote = RemoteScorer(ResilientOracleClient(*server.address, window=2))
            churn = Churn(cluster, cache, lambda name: remote.mark_dirty(group=name),
                          OBS_SIDECAR_ROUNDS)
            trees, round_trip_ms = [], []
            zero_counts()
            for r in range(OBS_SIDECAR_ROUNDS):
                if r:
                    churn(r)
                trace.DEFAULT_RECORDER.clear()
                with trace.start_trace("schedule_cycle"):
                    tid = trace.current_context()[0]
                    remote.refresh(cluster, cache)
                events = trace.DEFAULT_RECORDER.snapshot()
                if {e["args"].get("trace_id") for e in events} != {tid}:
                    raise AssertionError(f"round {r}: spans outside trace {tid}")
                tree = span_tree(events)
                trees.append(tree)
                want = [(name, "oracle.wire_round_trip") for name in OBS_SERVER_SPANS
                        for _ in range(2)]
                server_spans = sorted((n, p) for n, p in tree if n in OBS_SERVER_SPANS)
                if server_spans != sorted(want) or \
                        ("oracle.wire_round_trip", "oracle.batch") not in tree:
                    raise AssertionError(f"round {r}: span tree {tree}")
                round_trip_ms += [e["dur"] / 1e3 for e in events
                                  if e["name"] == "oracle.wire_round_trip"]
            launches = read_counts()
            remote.close()
        finally:
            server.shutdown()
            server.server_close()
    return launches, {"refreshes": OBS_SIDECAR_ROUNDS, "span_trees": trees,
                      "wire_round_trip_ms": round_trip_ms}


OBS_HOOK_REPS = 2000


def untraced_hooks_us(telemetry):
    """Report-only: microseconds of host time a refresh spends in the
    observability hooks with tracing off (its four span sites, one
    ``_batch`` record, one ledger batch context), the mean of OBS_HOOK_REPS
    repetitions into a private recorder and ledger."""
    from batch_scheduler_tpu_torch.utils import trace
    from batch_scheduler_tpu_torch.utils.lifecycle import GangLifecycleLedger
    from batch_scheduler_tpu_torch.utils.metrics import Registry

    recorder, ledger = trace.FlightRecorder(), GangLifecycleLedger(registry=Registry())
    span_sites = [name for name, parent in OBS_TREE["fold"] if parent]
    was = trace.enabled()
    trace.configure(enabled=False)
    try:
        t0 = time.perf_counter()
        for i in range(OBS_HOOK_REPS):
            for name in span_sites:
                with trace.span(name, cat="oracle"):
                    pass
            recorder.record("_batch", phase="batch", verdict="info", batch=i,
                            batch_ms=1.0, pack_ms=0.5, groups=NORTH_STAR_GANGS,
                            nodes=NORTH_STAR_NODES, degraded=False, speculative=False,
                            audit_id=None, telemetry=telemetry)
            ledger.note_batch_context("a" * 16, telemetry)
        return (time.perf_counter() - t0) / OBS_HOOK_REPS * 1e6
    finally:
        trace.configure(enabled=was)


def drive_observability(wave):
    """north_star_churn's deployment through a ScheduleOperation's
    OracleScorer on cuda (audit log on) with tracing on at sample 1.0 and
    BST_SCAN_WAVE at ``wave``: a keyframe and OBS_ROUNDS churn refreshes,
    each under a ``schedule_cycle`` root, kernel counts zeroed just before
    and read just after. Per refresh: the reference's span tree, oracle.batch
    (groups, nodes) no shorter than the scan kernel's CUDA-event time, one
    ``_batch`` flight record with host values only under the refresh's
    trace id, the ledger's batch context carrying the audit record's id;
    the audit records keyed by the refreshes' trace ids; health ok. Then,
    report-only, OBS_AB_PAIRS pairs of churn refreshes with tracing on and
    off in turns and evaluate()'s time; every route scraped while a thread
    refreshes (OBS_SCRAPE_ROUNDS); obs_denials, obs_policy, obs_sidecar.
    Returns {path: launches} and the report."""
    import tempfile
    import threading

    import torch

    from batch_scheduler_tpu_torch.core import ScheduleOperation
    from batch_scheduler_tpu_torch.utils import audit as audit_mod
    from batch_scheduler_tpu_torch.utils import health, lifecycle, metrics, trace

    kernel = "assign_wave" if wave else "assign_scan"
    suffix = "_wave" if wave else ""
    paths, out = {}, {}
    trace.configure(enabled=True, sample=1.0, capacity=trace.DEFAULT_CAPACITY)
    trace.DEFAULT_FLIGHT_RECORDER.clear()
    try:
        with scan_wave_env(wave), tempfile.TemporaryDirectory() as tmp:
            cluster, cache = north_star_state()
            log = audit_mod.AuditLog(tmp, fmt="array", keyframe_every=16)
            op = ScheduleOperation(cache, cluster, device="cuda", audit_log=log)
            scorer = op.oracle
            health.DEFAULT_HEALTH.reset()
            churn = Churn(cluster, cache, lambda name: scorer.mark_dirty(group=name),
                          OBS_ROUNDS + 1 + OBS_SCRAPE_ROUNDS + 2 * OBS_AB_PAIRS)
            root_ids, spans_ms, problems = [], [], []
            with kernel_event_times() as timed:
                zero_counts()
                for r in range(OBS_ROUNDS + 1):
                    if r:
                        churn(r)
                    trace.DEFAULT_RECORDER.clear()
                    with trace.start_trace("schedule_cycle", round=r):
                        root_ids.append(trace.current_context()[0])
                        scorer.refresh(cluster, cache)
                    lifecycle.DEFAULT_LEDGER.note_admitted(f"smoke/probe-{r:02d}")
                    kernel_ms = timed[kernel].take_ms()
                    events = trace.DEFAULT_RECORDER.snapshot()
                    tree = span_tree(events)
                    want = OBS_TREE["keyframe" if r == 0 else "fold"]
                    batch = [e for e in events if e["name"] == "oracle.batch"]
                    if tree != want:
                        problems.append(f"refresh {r}: span tree {tree}")
                    if {e["args"]["trace_id"] for e in events} != {root_ids[-1]}:
                        problems.append(f"refresh {r}: spans outside the root's trace")
                    if len(batch) != 1 or len(kernel_ms) != 1 or \
                            batch[0]["args"].get("groups") != NORTH_STAR_GANGS or \
                            batch[0]["args"].get("nodes") != NORTH_STAR_NODES:
                        problems.append(f"refresh {r}: oracle.batch {batch[:1]}, "
                                        f"{len(kernel_ms)} kernel launches")
                        continue
                    spans_ms.append((batch[0]["dur"] / 1e3, kernel_ms[0]))
                    if spans_ms[-1][0] < spans_ms[-1][1]:
                        problems.append(f"refresh {r}: oracle.batch {spans_ms[-1][0]} ms "
                                        f"shorter than the kernel's {spans_ms[-1][1]} ms")
                launches = read_counts()
            paths[(kernel, f"observability{suffix}")] = launches[kernel]
            if launches[kernel] != OBS_ROUNDS + 1 or any(
                    n for k, n in launches.items() if k != kernel):
                problems.append(f"launches {launches} (want {kernel} {OBS_ROUNDS + 1})")
            if scorer.stats()["fold_outcomes"] != {"no-base": 1, "folded": OBS_ROUNDS}:
                problems.append(f"fold outcomes {scorer.stats()['fold_outcomes']}")
            records = trace.DEFAULT_FLIGHT_RECORDER.snapshot(gang="_batch")["_batch"]
            if [r.get("trace_id") for r in records] != root_ids or \
                    not all(no_tensor(r) and r["phase"] == "batch" for r in records) or \
                    [r["batch"] for r in records] != list(range(1, OBS_ROUNDS + 2)):
                problems.append(f"_batch records {records[:2]}")
            log.flush()
            audit, skipped = audit_mod.AuditReader(tmp).batches()
            probes = lifecycle.DEFAULT_LEDGER.snapshot()["gangs"]
            probe_aids = [probes[f"smoke/probe-{r:02d}"]["events"][0].get("audit_id")
                          for r in range(OBS_ROUNDS + 1)]
            if [rec.get("trace_id") for rec in audit] != root_ids or skipped or \
                    [rec.get("audit_id") for rec in audit] != probe_aids or None in probe_aids:
                problems.append(f"audit trace ids {[rec.get('trace_id') for rec in audit]} "
                                f"vs roots {root_ids}; ledger audit ids {probe_aids}")
            t0 = time.perf_counter()
            verdict = health.DEFAULT_HEALTH.evaluate()
            first_eval_ms = (time.perf_counter() - t0) * 1e3
            not_ok = {k: v for k, v in verdict["signals"].items() if v["verdict"] != "ok"}
            if verdict["verdict"] != "ok":
                problems.append(f"health {verdict['verdict']}: {not_ok}")
            eval_ms = []
            for _ in range(OBS_EVAL_REPS):
                t0 = time.perf_counter()
                health.DEFAULT_HEALTH.evaluate()
                eval_ms.append((time.perf_counter() - t0) * 1e3)
            if problems:
                raise AssertionError("; ".join(problems))
            out["main"] = {
                "refreshes": OBS_ROUNDS + 1, "launches_by_kernel": launches,
                "batch_span_vs_kernel_ms": spans_ms,
                "spans_a_refresh": len(OBS_TREE["fold"]),
                "health": verdict["verdict"],
                "health_observations": {k: verdict["signals"][k].get("observations")
                                        for k in ("pack", "batch", "cycle", "device")},
                "evaluate_ms_first": first_eval_ms,
                "evaluate_ms_median": statistics.median(eval_ms),
            }

            # report-only: churn refreshes with tracing on and off in turns
            saved = read_counts()
            on_s, off_s = [], []
            r = OBS_ROUNDS + 1
            for pair in range(OBS_AB_PAIRS):
                for traced in ((True, False) if pair % 2 else (False, True)):
                    churn(r)
                    r += 1
                    trace.configure(enabled=traced, sample=1.0)
                    t0 = time.perf_counter()
                    with trace.start_trace("schedule_cycle"):
                        scorer.refresh(cluster, cache)
                    torch.cuda.synchronize()
                    (on_s if traced else off_s).append(time.perf_counter() - t0)
            trace.configure(enabled=True, sample=1.0)
            restore_counts(saved)
            out["tracing_ab"] = {
                "untraced_hooks_us": untraced_hooks_us(scorer.last_telemetry),
                "traced_ms_median": statistics.median(on_s) * 1e3,
                "untraced_ms_median": statistics.median(off_s) * 1e3,
                "traced_ms": [t * 1e3 for t in on_s],
                "untraced_ms": [t * 1e3 for t in off_s],
                "traced_spread_ms": (max(on_s) - min(on_s)) * 1e3,
                "untraced_spread_ms": (max(off_s) - min(off_s)) * 1e3,
            }

            # every route scraped while a thread refreshes the card
            server = metrics.serve_metrics(port=0)
            port = server.server_address[1]
            done, errors, scrape_ms = threading.Event(), [], {}

            def refresher(first):
                try:
                    for k in range(OBS_SCRAPE_ROUNDS):
                        churn(first + k)
                        with trace.start_trace("schedule_cycle"):
                            scorer.refresh(cluster, cache)
                    torch.cuda.synchronize()
                except Exception as e:  # noqa: BLE001 — reported below
                    errors.append(e)
                finally:
                    done.set()

            zero_counts()
            thread = threading.Thread(target=refresher, args=(r,))
            passes = 0
            try:
                thread.start()
                while not done.is_set() or passes < 2:
                    ms, bad = check_routes(port)
                    passes += 1
                    for route, t in ms.items():
                        scrape_ms.setdefault(route, []).append(t)
                    if bad:
                        errors.append(AssertionError(f"pass {passes}: {bad}"))
                        break
                thread.join(LOCKCHECK_TIMEOUT)
            finally:
                server.shutdown()
                server.server_close()
            scrape_launches = read_counts()
            paths[(kernel, f"observability_scrape{suffix}")] = scrape_launches[kernel]
            if errors or scrape_launches[kernel] != OBS_SCRAPE_ROUNDS:
                raise AssertionError(f"scrape: {errors[:3]}, launches {scrape_launches}")
            out["routes"] = {"passes": passes, "ms_median": {
                route: statistics.median(t) for route, t in scrape_ms.items()}}
    finally:
        trace.configure(enabled=True, sample=1.0)

    try:
        launches, out["denials"] = obs_denials(wave)
        paths[(kernel, f"observability_mixed{suffix}")] = launches[kernel]
        if launches[kernel] != 1:
            raise AssertionError(f"denials: launches {launches}")
        launches, out["policy"] = obs_policy(wave)
        paths[("assign_policy", f"observability_policy{suffix}")] = launches["assign_policy"]
        if launches["assign_policy"] != 1 or launches["assign_scan"] or launches["assign_wave"] \
                or launches["assign_topk"]:
            raise AssertionError(f"policy: launches {launches}")
        launches, out["sidecar"] = obs_sidecar(wave)
        paths[(kernel, f"observability_sidecar{suffix}")] = launches[kernel]
        if launches[kernel] != OBS_SIDECAR_ROUNDS:
            raise AssertionError(f"sidecar: launches {launches}")
    finally:
        trace.configure(enabled=False)
        trace.DEFAULT_RECORDER.clear()
        trace.DEFAULT_FLIGHT_RECORDER.clear()
    return paths, out


def observability_phase(wave, results):
    paths, out = drive_observability(wave)
    for key, n in paths.items():
        LATE_PATHS[key] = n
    out["launches_by_path"] = {path: n for (_, path), n in paths.items()}
    out["north_star_churn_refresh_ms_median"] = FIGURES.get(
        "north_star_churn" if wave is None else "north_star_churn_wave")
    return out


@phase("observability")
def observability(results):
    """The observability layer at the north star with the serial kernel
    (drive_observability)."""
    return observability_phase(None, results)


@phase("observability_wave")
def observability_wave(results):
    """observability with BST_SCAN_WAVE=8 (the wave kernel)."""
    return observability_phase(8, results)


# the lockcheck phase: a child process with BST_LOCKCHECK=1 (the
# instrumentation stays out of every other phase's timings)
LOCKCHECK_THREADS = 8
LOCKCHECK_JOBS = 6  # schedule calls a storm thread makes
LOCKCHECK_READERS = 3
LOCKCHECK_TIMEOUT = 600


def lockcheck_child() -> int:
    """The lockcheck phase's child (``chip_smoke.py --lockcheck-child``,
    BST_LOCKCHECK=1 set): (a) LOCKCHECK_THREADS threads storm one
    OracleCoalescer over a live ``OracleServer(device="cuda")`` executor
    with BASELINE config 2 batches (schedule, check_admission, stats);
    (b) one thread runs ``OracleScorer(device="cuda")`` refreshes on
    north_star_churn's deployment and churn while LOCKCHECK_READERS
    threads call ``stats()``. Prints one JSON line; any error (a
    LockDisciplineError with both stacks) goes to stderr and exits 1."""
    import threading

    import torch

    from batch_scheduler_tpu_torch.analysis import lockcheck
    from batch_scheduler_tpu_torch.core import OracleScorer
    from batch_scheduler_tpu_torch.ops.bucketing import pad_oracle_batch
    from batch_scheduler_tpu_torch.service import serve_background
    from batch_scheduler_tpu_torch.service.coalescer import CoalesceJob, CoalesceSaturated
    from batch_scheduler_tpu_torch.utils import trace
    from batch_scheduler_tpu_torch.utils.metrics import (
        DEFAULT_REGISTRY, LONG_OP_BUCKETS, serve_metrics)

    if not lockcheck._installed[0]:
        print("chip_smoke: BST_LOCKCHECK=1 did not install the checker", file=sys.stderr)
        return 1
    classes = lockcheck.install()
    errors = []
    # every LockDisciplineError raised, also where a thread's own handler
    # swallows it (the scheduler requeues a pod whose cycle raised)
    raised = []

    class Recorded(lockcheck.LockDisciplineError):
        def __init__(self, *args):
            super().__init__(*args)
            raised.append(self)

    lockcheck.LockDisciplineError = Recorded

    def guarded(fn, *args):
        try:
            fn(*args)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    def job(req, tenant):
        args, progress = pad_oracle_batch(
            alloc=req.alloc, requested=req.requested, group_req=req.group_req,
            remaining=req.remaining, fit_mask=req.fit_mask, group_valid=req.group_valid,
            order=req.order, min_member=req.min_member, scheduled=req.scheduled,
            matched=req.matched, ineligible=req.ineligible, creation_rank=req.creation_rank)
        raw = (req.alloc, req.requested, req.group_req, req.remaining, req.fit_mask,
               req.group_valid, req.order, req.min_member, req.scheduled, req.matched,
               req.ineligible, req.creation_rank)
        return CoalesceJob(tenant=tenant, n=req.alloc.shape[0], g=req.group_req.shape[0],
                           r=req.alloc.shape[1], padded_args=args, progress_args=progress,
                           raw_fn=lambda raw=raw: raw)

    streams = [tenant_stream(t, LOCKCHECK_JOBS, *MEGA_SHAPE) for t in range(3)]
    server = serve_background(device="cuda", coalesce=True)
    coal = server.coalescer
    groups = record_groups(coal)
    busy = [0]

    def storm(i):
        for b in range(LOCKCHECK_JOBS):
            try:
                coal.check_admission()
                coal.schedule(job(streams[i % 3][b], f"tenant-{i % 3}"))
            except CoalesceSaturated:
                busy[0] += 1
                time.sleep(0.005)
            coal.stats()

    zero_counts()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=guarded, args=(storm, i))
               for i in range(LOCKCHECK_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(LOCKCHECK_TIMEOUT)
    storm_s = time.perf_counter() - t0
    coal_stats = coal.stats()
    server.shutdown()
    server.server_close()

    cluster, cache = north_star_state()
    scorer = OracleScorer(device="cuda")
    churn = Churn(cluster, cache, lambda name: scorer.mark_dirty(group=name),
                  METRICS_ROUNDS + 1)
    done = threading.Event()
    reads = [0]
    scrapes = [0]
    # the refreshes traced, and every ported /debug route scraped meanwhile
    trace.configure(enabled=True, sample=1.0)
    endpoint = serve_metrics(port=0)

    def refresher():
        try:
            for r in range(METRICS_ROUNDS + 1):
                if r:
                    churn(r)
                with trace.start_trace("schedule_cycle"):
                    scorer.ensure_fresh(cluster, cache)
            torch.cuda.synchronize()
        finally:
            done.set()

    def reader():
        while not done.is_set():
            scorer.stats()
            reads[0] += 1
        scorer.stats()

    def scraper():
        # /metrics holds the batch series once the first batch has published
        # them (batches_run moves a few lines before they are observed)
        batch_hist = DEFAULT_REGISTRY.histogram("bst_oracle_batch_seconds",
                                                buckets=LONG_OP_BUCKETS)
        while not batch_hist.count() and not done.is_set():
            time.sleep(0.01)
        while not done.is_set() or not scrapes[0]:
            _, bad = check_routes(endpoint.server_address[1])
            if bad:
                raise AssertionError(f"scrape {scrapes[0]}: {bad}")
            scrapes[0] += 1

    t0 = time.perf_counter()
    threads = [threading.Thread(target=guarded, args=(refresher,))]
    threads += [threading.Thread(target=guarded, args=(reader,))
                for _ in range(LOCKCHECK_READERS)]
    threads.append(threading.Thread(target=guarded, args=(scraper,)))
    for t in threads:
        t.start()
    for t in threads:
        t.join(LOCKCHECK_TIMEOUT)
    scorer_s = time.perf_counter() - t0
    endpoint.shutdown()
    endpoint.server_close()
    trace.configure(enabled=False)
    launches = read_counts()
    stats = scorer.stats()
    # the scheduler loop: its own launch count (one kernel launch a batch)
    zero_counts()
    t0 = time.perf_counter()
    try:
        sims, sim_batches = lockcheck_sims()
    except Exception as e:  # noqa: BLE001 — reported below
        errors.append(e)
        sims, sim_batches = {}, None
    sims_s = time.perf_counter() - t0
    sim_launches = read_counts()
    errors += [e for e in raised if e not in errors]
    for e in errors:
        print(f"{type(e).__name__}: {e}", file=sys.stderr)
    emit({"lockcheck_child": True, "instrumented_classes": len(classes),
          "classes": classes, "storm_threads": LOCKCHECK_THREADS,
          "storm_jobs": LOCKCHECK_THREADS * LOCKCHECK_JOBS, "storm_s": storm_s,
          "busy_answers": busy[0], "groups": sorted(set(groups)),
          "groups_run": coal_stats["groups_run"], "mega_groups": coal_stats["mega_groups"],
          "storm_jobs_run": sum(w for _, w in groups),
          # one launch a span job, one a mega group
          "storm_launches_want": sum(w if mode == "span" else 1 for mode, w in groups),
          "scorer_refreshes": stats["batches_run"], "scorer_s": scorer_s,
          "stats_reads": reads[0], "debug_scrapes": scrapes[0],
          "fold_outcomes": stats["fold_outcomes"],
          "launches_by_kernel": launches,
          "sims": sims, "sims_s": sims_s, "sim_batches": sim_batches,
          "sim_launches_by_kernel": sim_launches, "lock_errors_raised": len(raised),
          "errors": [f"{type(e).__name__}: {str(e)[:300]}" for e in errors]})
    return 1 if errors else 0


@phase("lockcheck")
def lockcheck_phase(results):
    """Runs lockcheck_child in a child process with BST_LOCKCHECK=1 and
    requires it clean: no LockDisciplineError, every storm job answered
    or refused BUSY, every refresh run. Its kernel launches are the
    ``lockcheck`` path."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, BST_LOCKCHECK="1")
    env.pop("BST_SCAN_WAVE", None)
    proc = subprocess.run(
        [sys.executable, os.path.join(here, "chip_smoke.py"), "--lockcheck-child"],
        cwd=here, env=env, capture_output=True, text=True, timeout=LOCKCHECK_TIMEOUT + 120)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith('{"lockcheck_child"')]
    if proc.returncode != 0 or not lines:
        sys.stderr.write(proc.stderr[-20000:])
        raise AssertionError(f"lockcheck child exited {proc.returncode}: "
                             f"{proc.stderr[-1500:]}")
    out = json.loads(lines[-1])
    out.pop("lockcheck_child")
    launches = out["launches_by_kernel"]
    refreshes = METRICS_ROUNDS + 1
    if out["scorer_refreshes"] != refreshes:
        raise AssertionError(f"{out['scorer_refreshes']} refreshes (want {refreshes})")
    if out["debug_scrapes"] < 1:
        raise AssertionError("no /debug scrape completed during the stats() storm")
    if out["storm_jobs_run"] + out["busy_answers"] != out["storm_jobs"]:
        raise AssertionError(f"{out['storm_jobs_run']} storm jobs run and "
                             f"{out['busy_answers']} refused of {out['storm_jobs']}")
    want = refreshes + out["storm_launches_want"]
    if launches["assign_scan"] != want or launches["assign_wave"] or launches["assign_policy"] \
            or launches["assign_topk"]:
        raise AssertionError(f"launches {launches} (want assign_scan {want}: {refreshes} "
                             f"refreshes and the storm's groups {out['groups']})")
    if out["sim_launches_by_kernel"] != only(assign_scan=out["sim_batches"]):
        raise AssertionError(f"scheduler loop: {out['sim_launches_by_kernel']} launches in "
                             f"{out['sim_batches']} batches (want assign_scan once a batch)")
    if "assign_scan" in results:
        results["assign_scan"]["launches_by_path"]["lockcheck"] = launches["assign_scan"]
        results["assign_scan"]["launches_by_path"]["lockcheck_sims"] = out["sim_batches"]
    out["lock_violations"] = out["lock_errors_raised"]
    return out


# the audit phases: north_star_churn's deployment and churn recorded to an
# audit ring in each format (format, keyframe_every), AUDIT_ROUNDS churn
# rounds after the first refresh, the identity audit on every 2nd batch
AUDIT_RINGS = (("array", 16), ("v2", 4))
AUDIT_ROUNDS = 12
AUDIT_IDENTITY_EVERY = 2
AUDIT_CPU_REPLAYS = 3  # cpu-ladder replays: the last records of each ring
# report-only: pairs of refreshes, audit off / on (cut from 12 for the
# smoke's time)
AUDIT_TIMING_ROUNDS = 6


def ran_input_digest(scorer):
    """input_digest of the seven batch args the scorer's last batch ran on
    (the holder's resident tensors, read back) and its five progress
    args."""
    from batch_scheduler_tpu_torch.utils import audit as audit_mod

    args = [a.cpu().numpy() if hasattr(a, "cpu") else a
            for a in scorer._device_state.last_args()]
    arrays = dict(zip(audit_mod.BATCH_ARG_NAMES, args))
    arrays.update(zip(audit_mod.PROGRESS_ARG_NAMES, scorer.snapshot.progress_args()))
    return audit_mod.input_digest(arrays)


def timed_calls(fn, out):
    """``fn`` wrapped to append each call's seconds to ``out``."""
    def run(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            out.append(time.perf_counter() - t0)
    return run


def record_ring(fmt, keyframe_every, directory):
    """One audit ring at the north star: north_star_churn's deployment and
    churn through a ScheduleOperation's OracleScorer on cuda with an
    AuditLog(fmt, keyframe_every) and the identity audit on every
    AUDIT_IDENTITY_EVERY-th batch; a first refresh and AUDIT_ROUNDS churn
    rounds, each followed by one refresh. Both kernels' counts are zeroed
    just before the refreshes and read just after. Returns (scorer, log,
    input digests of what each batch ran on, launches by kernel, publish
    seconds, identity-audit seconds)."""
    from batch_scheduler_tpu_torch.core import ScheduleOperation
    from batch_scheduler_tpu_torch.utils.audit import AuditLog

    cluster, cache = north_star_state()
    log = AuditLog(directory, fmt=fmt, keyframe_every=keyframe_every)
    op = ScheduleOperation(cache, cluster, device="cuda", audit_log=log,
                           identity_audit_every=AUDIT_IDENTITY_EVERY)
    scorer = op.oracle
    publish_s, identity_s = [], []
    scorer._audit_publish = timed_calls(scorer._audit_publish, publish_s)
    auditor = scorer._identity
    auditor._verify = timed_calls(auditor._verify, identity_s)
    churn = Churn(cluster, cache, lambda name: scorer.mark_dirty(group=name), AUDIT_ROUNDS + 1)
    ran = []
    zero_counts()
    for r in range(AUDIT_ROUNDS + 1):
        if r:
            churn(r)
        scorer.refresh(cluster, cache)
        ran.append(ran_input_digest(scorer))
    launches = read_counts()
    return scorer, log, ran, launches, publish_s, identity_s


def check_ring(scorer, log, ran, wave):
    """Flush the ring, read it back and hold it to what the scorer ran:
    nothing dropped, failed or swallowed, every record reconstructed,
    every reconstructed input (and every recorded input_digest) equal to
    the args its batch ran on, the identity audit drained with at least
    one audit and no mismatch or error. Returns the records."""
    from batch_scheduler_tpu_torch.utils import audit as audit_mod
    from batch_scheduler_tpu_torch.utils.audit import AuditReader

    if not scorer._identity.drain(600.0) or not log.flush(120.0):
        raise AssertionError("the identity audit or the audit writer did not finish")
    stats = scorer.stats()["audit"]
    bad = {k: stats[k] for k in ("publish_errors", "audit_dropped", "audit_write_errors",
                                 "identity_mismatches", "identity_errors") if stats[k]}
    if bad or stats["identity_audits"] < 1:
        raise AssertionError(f"audit counters {stats}")
    batches, skipped = AuditReader(log.directory).batches()
    if skipped or len(batches) != len(ran):
        raise AssertionError(f"{len(batches)} records read back of {len(ran)}, "
                             f"unreconstructable: {skipped[:2]}")
    for rec, want in zip(batches, ran):
        arrays = dict(zip(audit_mod.BATCH_ARG_NAMES, rec["batch_args"]))
        arrays.update(zip(audit_mod.PROGRESS_ARG_NAMES, rec["progress_args"]))
        got = {audit_mod.input_digest(arrays), rec.get("input_digest", want)}
        if got != {want}:
            raise AssertionError(f"record {rec['seq']}: inputs differ from the batch's")
        if (rec.get("refold") or {"input_digest_ok": True})["input_digest_ok"] is not True:
            raise AssertionError(f"record {rec['seq']}: re-fold {rec['refold']}")
        tele = rec["telemetry"]
        if (tele["scan"], tele["wave_width"]) != ("cuda_kernel", wave or 0):
            raise AssertionError(f"record {rec['seq']}: telemetry {tele}")
    return batches, stats


def replay_ring(batches, wave):
    """Replay the records: every one on steady (the rung's kernel) and, in
    the wave phase, on wavefront; the last AUDIT_CPU_REPLAYS on
    cpu-ladder. Each must be identical and report the rung it ran.
    Returns ms by rung."""
    from batch_scheduler_tpu_torch.core.oracle_scorer import replay_audit_record

    rungs = [("steady", batches, ("cuda_kernel", wave or 0))]
    if wave:
        rungs.append(("wavefront", batches, ("cuda_kernel", 8)))
    rungs.append(("cpu-ladder", batches[-AUDIT_CPU_REPLAYS:], ("plain", 0)))
    ms = {}
    for rung, recs, executed in rungs:
        times = []
        for rec in recs:
            t0 = time.perf_counter()
            rep = replay_audit_record(rec, against=rung)
            times.append((time.perf_counter() - t0) * 1e3)
            ran = rep["executed_rung"]
            if not rep["identical"] or (ran["scan"], ran["wave_width"]) != executed:
                raise AssertionError(f"record {rec['seq']} on {rung}: {rep}")
        ms[rung] = {"replays": len(times), "ms_median": statistics.median(times),
                    "ms_max": max(times)}
    return ms


def tamper_check(rec):
    """A copy of one record with one assignment count changed (and its
    digest taken over the changed plan): the replay must report it
    divergent and blame assignment_counts at that gang."""
    import numpy as np

    from batch_scheduler_tpu_torch.core.oracle_scorer import replay_audit_record
    from batch_scheduler_tpu_torch.utils import audit as audit_mod

    rec = dict(rec, result_arrays={k: np.array(v) for k, v in rec["result_arrays"].items()})
    counts = rec["result_arrays"]["assignment_counts"]
    g = int(np.flatnonzero(counts[:, 0] > 0)[0])
    counts[g, 0] += 1
    rec["plan_digest"] = audit_mod.plan_digest(rec["result_arrays"])
    rep = replay_audit_record(rec, against="steady")
    blame = rep.get("blame") or {}
    gang = rec["names"]["groups"][g]
    if rep["identical"] is not False or (blame.get("field"), blame.get("gang")) != (
            "assignment_counts", gang):
        raise AssertionError(f"tampered record not blamed: {rep}")
    return {"identical": False, "field": blame["field"], "gang": gang,
            "slot": blame["slot"], "node": blame.get("node")}


def audit_timing(directory):
    """Report-only: the churn refresh with the audit off and on (an array
    ring: publish and the writer's serialization), in turns on one scorer,
    in rounds with no identity verification in flight and in rounds with
    one: a verification of the last served batch (``IdentityAuditor``, the
    plain serial scan on the CPU on its daemon thread) started just before
    the round. Before each round the verification and the writer are
    drained, and after each audited refresh the writer is flushed, outside
    the timed refresh. Also the two host parts of the publish alone on the last
    batch, with nothing else running: plan_digest and the tenant stamp.
    Medians in ms."""
    import torch

    from batch_scheduler_tpu_torch.core import OracleScorer
    from batch_scheduler_tpu_torch.core.oracle_scorer import _snapshot_tenancy
    from batch_scheduler_tpu_torch.utils import audit as audit_mod
    from batch_scheduler_tpu_torch.utils import tenancy
    from batch_scheduler_tpu_torch.utils.audit import AuditLog
    from batch_scheduler_tpu_torch.utils.health import IdentityAuditor

    cluster, cache = north_star_state()
    log = AuditLog(directory)
    scorer = OracleScorer(device="cuda")
    verifier = IdentityAuditor(1)
    churn = Churn(cluster, cache, lambda name: scorer.mark_dirty(group=name),
                  2 * AUDIT_TIMING_ROUNDS + 1)
    scorer.refresh(cluster, cache)
    samples = {}
    r = 0
    for t in range(AUDIT_TIMING_ROUNDS):
        verifier.drain(600.0)
        log.flush(120.0)
        if t % 2:
            snap = scorer.snapshot
            verifier.note_batch(snap.device_args(), snap.progress_args(),
                                audit_mod.plan_digest(scorer._state.result), None)
        for audited in ((True, False) if t % 4 < 2 else (False, True)):
            r += 1
            churn(r)
            scorer.configure_audit(log if audited else None)
            thread = verifier._thread
            verifying = thread is not None and thread.is_alive()
            t0 = time.perf_counter()
            scorer.refresh(cluster, cache)
            torch.cuda.synchronize()
            key = ("audit_on" if audited else "audit_off") + (
                "_verifying" if verifying else "_idle")
            samples.setdefault(key, []).append((time.perf_counter() - t0) * 1e3)
            if audited:
                # the writer serializes the record after the publish has
                # returned: finish it before the next timed refresh, or
                # an unaudited refresh would carry the audit's cost
                log.flush(120.0)
    verifier.drain(600.0)
    log.stop()
    if verifier.mismatches or verifier.errors or scorer.stats()["audit"]["publish_errors"]:
        raise AssertionError(f"while timing: {verifier.stats()}, {scorer.stats()['audit']}")
    host, snap = scorer._state.result, scorer.snapshot
    parts = {}
    for name, fn in (("plan_digest", lambda: audit_mod.plan_digest(host)),
                     ("tenants", lambda: {tenancy.tenant_label(ns): n
                                          for ns, n in _snapshot_tenancy(snap).items()})):
        times = []
        for _ in range(20):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        parts[name] = statistics.median(times)
    return {f"refresh_ms_median_{k}": statistics.median(v) for k, v in sorted(samples.items())} | {
        "refreshes": {k: len(v) for k, v in sorted(samples.items())},
        "publish_parts_ms_median": parts}


def record_bytes(directory):
    """Bytes a record by record kind and keyframe flag, from the ring's
    segment files (``ring_stats`` has one ``batch`` kind for keyframes
    and array deltas)."""
    out = {}
    for path in sorted(os.listdir(directory)):
        with open(os.path.join(directory, path)) as f:
            for line in f:
                key = ("event_batch" if '"kind": "event_batch"' in line
                       else "event" if '"kind": "event"' in line
                       else "keyframe" if '"keyframe": true' in line else "delta")
                out.setdefault(key, []).append(len(line))
    return {k: {"records": len(v), "bytes_median": statistics.median(v)}
            for k, v in sorted(out.items())}


def drive_audit_replay(wave):
    """Both audit rings at the north star with ``BST_SCAN_WAVE`` set to
    ``wave`` (None: unset): record_ring, check_ring and replay_ring for
    each format, the replays' kernel launches zeroed just before the
    replays of a ring and read just after (the rung's kernel must have
    launched), tamper_check on the array ring's last record, then
    audit_timing. Returns (launches of the refreshes, launches of the
    replays, report)."""
    import tempfile

    from batch_scheduler_tpu_torch.utils import audit as audit_mod

    kernel = "assign_wave" if wave else "assign_scan"
    refresh_launches = dict.fromkeys(KERNELS, 0)
    replay_launches = dict.fromkeys(KERNELS, 0)
    report = {"rings": {}}
    with scan_wave_env(wave), tempfile.TemporaryDirectory(prefix="bst-audit-") as tmp:
        for fmt, keyframe_every in AUDIT_RINGS:
            directory = os.path.join(tmp, fmt)
            scorer, log, ran, launches, publish_s, identity_s = record_ring(
                fmt, keyframe_every, directory)
            if launches[kernel] != len(ran) or sum(launches.values()) != len(ran):
                raise AssertionError(f"{fmt} ring: {launches} launches in {len(ran)} refreshes")
            batches, stats = check_ring(scorer, log, ran, wave)
            zero_counts()
            replay_ms = replay_ring(batches, wave)
            got = read_counts()
            cuda_replays = sum(v["replays"] for k, v in replay_ms.items() if k != "cpu-ladder")
            if got[kernel] != cuda_replays or sum(got.values()) != cuda_replays:
                raise AssertionError(f"{fmt} ring replays: {got} launches in {cuda_replays} "
                                     "cuda replays")
            for k in KERNELS:
                refresh_launches[k] += launches[k]
                replay_launches[k] += got[k]
            kinds = [rec.get("record_kind", "batch") for rec in batches]
            if fmt == "v2" and "event_batch" not in kinds:
                raise AssertionError(f"v2 ring without event records: {kinds}")
            ring = [r for r in audit_mod.ring_stats() if r["dir"] == directory][0]
            report["rings"][fmt] = {
                "keyframe_every": keyframe_every, "records": len(batches),
                "record_kinds": {k: kinds.count(k) for k in sorted(set(kinds))},
                "publish_ms_median": statistics.median(publish_s[1:]) * 1e3,
                "publish_ms_max": max(publish_s[1:]) * 1e3,
                "bytes_by_kind": {k: v["bytes_per_record"] for k, v in ring["by_kind"].items()},
                "record_bytes": record_bytes(directory),
                "ring_bytes": ring["ring_bytes"],
                "replay": replay_ms,
                "identity_audit_ms": [x * 1e3 for x in identity_s],
                "audit": {k: v for k, v in stats.items() if k != "audit_dir"},
                "launches_refresh": launches, "launches_replay": got,
            }
            if fmt == "array":
                report["tamper"] = tamper_check(batches[-1])
            log.stop()
        report["timing"] = audit_timing(os.path.join(tmp, "timing"))
    return refresh_launches, replay_launches, report


def audit_phase(results, wave, path):
    refresh_launches, replay_launches, report = drive_audit_replay(wave)
    kernel = "assign_wave" if wave else "assign_scan"
    if kernel in results:
        by_path = results[kernel]["launches_by_path"]
        by_path[path] = refresh_launches[kernel]
        by_path[f"{path}_replays"] = replay_launches[kernel]
    return {**report, "launches": refresh_launches[kernel],
            "launches_replays": replay_launches[kernel]}


@phase("audit_replay")
def audit_replay(results):
    """audit_phase without BST_SCAN_WAVE, then the policy ring
    (policy_ring): recorded on the card, replayed on steady and
    cpu-ladder."""
    import tempfile

    out = audit_phase(results, None, "audit_replay")
    with tempfile.TemporaryDirectory(prefix="bst-audit-policy-") as tmp:
        launches, replays, report = policy_ring(tmp)
    if launches != only(assign_policy=report["records"]):
        raise AssertionError(f"policy ring refreshes: {launches}")
    if "assign_policy" in results:
        by_path = results["assign_policy"]["launches_by_path"]
        by_path["audit_replay_policy"] = launches["assign_policy"]
        by_path["audit_replay_policy_replays"] = replays["assign_policy"]
    return {**out, "policy_ring": report}


@phase("audit_replay_wave")
def audit_replay_wave(results):
    return audit_phase(results, 8, "audit_replay_wave")


# the sidecar phases: bench.py's deployment served over the wire by the
# port's OracleServer on the card. SIDECAR_ROUNDS churn refreshes follow
# the keyframe refresh; each reads SIDECAR_ROW_GANGS gangs' capacity and
# score rows over ROW_REQ; SIDECAR_TRACED traced requests give the server
# split; the load windows send SIDECAR_WINDOW requests each, over one
# connection or split over two at once, in the order SIDECAR_LOAD
SIDECAR_ROUNDS = 8
SIDECAR_ROW_GANGS = 4
SIDECAR_TRACED = 5
SIDECAR_WINDOW = 40
SIDECAR_LOAD = (1, 2, 2, 1)
SIDECAR_HUGE_CPU = 128  # the outage check's infeasible gang: fits no node


@contextlib.contextmanager
def frame_log():
    """Every frame the port's protocol writes inside the block, client or
    server side, as ``(msg_type, bytes on the wire)`` in write order."""
    from batch_scheduler_tpu_torch.service import protocol as proto

    real = proto.write_frame
    log = []

    def logged(sock, msg_type, payload):
        log.append((msg_type, proto._HEADER.size + len(payload)))
        real(sock, msg_type, payload)

    proto.write_frame = logged
    try:
        yield log
    finally:
        proto.write_frame = real


def snapshot_request(snap):
    """The ScheduleRequest a remote scorer ships for ``snap`` (its padded
    host arrays, the broadcast row as one row)."""
    from batch_scheduler_tpu_torch.service import protocol as proto

    return proto.ScheduleRequest(
        alloc=snap.alloc, requested=snap.requested, group_req=snap.group_req,
        remaining=snap.remaining, fit_mask=snap.fit_mask,
        group_valid=snap.group_valid, order=snap.order,
        min_member=snap.min_member, scheduled=snap.scheduled,
        matched=snap.matched, ineligible=snap.ineligible,
        creation_rank=snap.creation_rank,
    )


def same_response(a, b):
    """Two ScheduleResponses equal but for their per-connection sequence."""
    import dataclasses

    from batch_scheduler_tpu_torch.service import protocol as proto

    return (proto.pack_schedule_response(dataclasses.replace(a, batch_seq=0))
            == proto.pack_schedule_response(dataclasses.replace(b, batch_seq=0)))


def host_diff(got, want, g=None):
    """The HOST_KEYS on which two host dicts differ (the first ``g`` gangs)."""
    import numpy as np

    def cut(v):
        v = np.asarray(v)
        return v[:g] if g is not None and v.ndim else v

    return [k for k in HOST_KEYS if not np.array_equal(cut(got[k]), cut(want[k]))]


def sidecar_churn(server, wave):
    """The main path: three scorers of bench.py's deployment in a
    ClusterState — a RemoteScorer on a windowed ResilientOracleClient (wire
    deltas), a second pinned to full snapshots, and the in-process
    OracleScorer — through one keyframe refresh and SIDECAR_ROUNDS Churn
    refreshes. Every kernel's count is zeroed just before and read just
    after; the local scorer's launches are restored (they are not the
    sidecar's). After each refresh the three host dicts must be equal,
    and SIDECAR_ROW_GANGS gangs' capacity and score rows read over ROW_REQ
    (from both remote scorers) equal the local scorer's."""
    import numpy as np
    import torch

    from batch_scheduler_tpu_torch.core import OracleScorer
    from batch_scheduler_tpu_torch.service import RemoteScorer, ResilientOracleClient
    from batch_scheduler_tpu_torch.service import protocol as proto
    from batch_scheduler_tpu_torch.utils.metrics import DEFAULT_REGISTRY

    wire = DEFAULT_REGISTRY.counter("bst_oracle_wire_delta_batches_total")
    host, port = server.address
    cluster, cache = north_star_state()
    delta_remote = RemoteScorer(ResilientOracleClient(host, port, window=2))
    full_remote = RemoteScorer(ResilientOracleClient(host, port, window=2))
    full_remote._wire_delta_ok = False  # pinned to full snapshots
    local = OracleScorer(device="cuda")
    scorers = (delta_remote, full_remote, local)

    def mark(name):
        for s in scorers:
            s.mark_dirty(group=name)

    churn = Churn(cluster, cache, mark, SIDECAR_ROUNDS + 1)
    row_gangs = np.linspace(0, NORTH_STAR_GANGS - 1, SIDECAR_ROW_GANGS).astype(int)
    times = {"delta": [], "keyframe": [], "full": [], "local": []}
    frames = {"delta": [], "keyframe": [], "full": [], "response": []}
    deltas0 = wire.value(kind="delta")
    zero_counts()
    for r in range(SIDECAR_ROUNDS + 1):
        if r:
            churn(r)
        with frame_log() as log:
            before = wire.value(kind="delta")
            t0 = time.perf_counter()
            delta_remote.refresh(cluster, cache)
            kind = "delta" if wire.value(kind="delta") > before else "keyframe"
            times[kind].append(time.perf_counter() - t0)
            frames[kind] += [b for t, b in log
                             if t == proto.MsgType.DELTA_SCHEDULE_REQ]
            frames["response"] += [b for t, b in log
                                   if t == proto.MsgType.SCHEDULE_RESP]
            log.clear()
            t0 = time.perf_counter()
            full_remote.refresh(cluster, cache)
            times["full"].append(time.perf_counter() - t0)
            frames["full"] += [b for t, b in log if t == proto.MsgType.SCHEDULE_REQ]
        saved = read_counts()
        t0 = time.perf_counter()
        local.refresh(cluster, cache)
        torch.cuda.synchronize()
        times["local"].append(time.perf_counter() - t0)
        restore_counts(saved)
        want = local._state.result
        for s, label in ((delta_remote, "wire-delta"), (full_remote, "full-snapshot")):
            diff = host_diff(s._state.result, want)
            if diff:
                raise AssertionError(f"refresh {r}: the {label} remote plan differs "
                                     f"from the local one in {diff}")
            for g in row_gangs:
                for k in proto.ROW_KINDS:
                    if not np.array_equal(s._state.row(k, int(g)), local._state.row(k, int(g))):
                        raise AssertionError(f"refresh {r}: the {label} scorer's {k} row "
                                             f"of gang {g} differs from the local one")
        if not want["placed"][:NORTH_STAR_GANGS].all():
            raise AssertionError(f"refresh {r}: "
                                 f"{int((~want['placed'][:NORTH_STAR_GANGS]).sum())} "
                                 "gangs not placed")
    launches = read_counts()
    wire_deltas = wire.value(kind="delta") - deltas0
    if wire_deltas < SIDECAR_ROUNDS - 1:
        raise AssertionError(f"{wire_deltas} wire-delta batches in {SIDECAR_ROUNDS} "
                             "churn refreshes")
    med = lambda xs: statistics.median(xs) * 1e3  # noqa: E731
    report = {
        "shape": list(local.snapshot.shape), "refreshes": SIDECAR_ROUNDS + 1,
        "wire_delta_batches": wire_deltas, "launches_by_kernel": launches,
        "remote_delta_refresh_ms_median": med(times["delta"]),
        "remote_delta_refresh_ms": [t * 1e3 for t in times["delta"]],
        "remote_keyframe_refresh_ms": [t * 1e3 for t in times["keyframe"]],
        "remote_full_refresh_ms_median": med(times["full"]),
        "local_refresh_ms_median": med(times["local"][1:]),
        "local_keyframe_refresh_ms": times["local"][0] * 1e3,
        # the delta scorer's own split: host pack, and the wire round trip
        # (its _execute: the request, the server's batch, the response)
        "remote_pack_ms_median": med(delta_remote.pack_seconds[1:]),
        "remote_round_trip_ms_median": med(delta_remote.batch_seconds[1:]),
        "request_bytes": {"keyframe": frames["keyframe"],
                          "delta_median": statistics.median(frames["delta"]),
                          "full_median": statistics.median(frames["full"])},
        "response_bytes_median": statistics.median(frames["response"]),
        "row_bytes": 4 * NORTH_STAR_SHAPE[1],
        "equal_local": True, "all_placed": True,
    }
    delta_remote.close()
    full_remote.close()
    return launches, report, local


def sidecar_checks(server, local, wave):
    """Against the same server after the main path (every launch here
    restored: checks and timings): the server split of traced requests,
    mixed's per-group batch over the wire against the plain CPU batch,
    the native client against the Python one, a 1 ms deadline, load
    windows over one connection and over two at once (every answer and
    row right; the card's idle share of each window), and drain. The load
    comes from native clients, whose calls run without the interpreter
    lock (ctypes releases it), as the scheduler's client runs in its own
    process: the server's threads then hold the lock alone."""
    import threading

    from batch_scheduler_tpu_torch.ops.oracle import execute_batch_host
    from batch_scheduler_tpu_torch.service import OracleClient
    from batch_scheduler_tpu_torch.service import protocol as proto
    from batch_scheduler_tpu_torch.service.native import NativeOracleClient
    from batch_scheduler_tpu_torch.utils import errors as errs
    from batch_scheduler_tpu_torch.utils.trace import new_trace_id

    saved = read_counts()
    host, port = server.address
    client = OracleClient(host, port)
    req = snapshot_request(local.snapshot)
    payload = proto.pack_schedule_request(req)
    # the server split, from traced requests' TRACE_INFO
    split = {"unpack_pad_seconds": [], "lock_wait_seconds": [], "device_seconds": []}
    for _ in range(SIDECAR_TRACED):
        _, body = client._round_trip(proto.MsgType.SCHEDULE_REQ, payload,
                                     trace_ctx=(new_trace_id(), ""))
        tele = client.last_telemetry
        for k in split:
            split[k].append(tele[k])
    resp_py = proto.unpack_schedule_response(body)
    if tele["scan"] != "cuda_kernel" or not tele["device"].startswith("cuda") \
            or tele["wave_width"] != (wave or 0) or tele["mask_mode"] != "broadcast":
        raise AssertionError(f"server telemetry {tele}")
    if host_diff(vars(resp_py), local._state.result, NORTH_STAR_GANGS):
        raise AssertionError("the traced request's plan differs from the local one")
    # mixed's per-group batch over the wire vs the plain CPU batch of the
    # same padded args (serial rung: the kernels equal it at any width)
    batch_args, progress_args = mixed_batch(*MIXED, per_group=True)
    mixed_req = proto.ScheduleRequest(*batch_args, *progress_args)
    t0 = time.perf_counter()
    mixed_resp = client.schedule(mixed_req)
    mixed_ms = (time.perf_counter() - t0) * 1e3
    with scan_wave_env(None):
        cpu_host, cpu_dev = execute_batch_host(batch_args, progress_args, device="cpu")
    diff = host_diff(vars(mixed_resp), cpu_host)
    for g in (0, MIXED[1] // 2, MIXED[1] - 1):
        for k in proto.ROW_KINDS:
            if not (client.row(k, g, mixed_resp.batch_seq) == cpu_dev[k][g].numpy()).all():
                diff.append(f"{k} row {g}")
    if diff:
        raise AssertionError(f"mixed over the wire differs from the plain CPU batch in {diff}")
    # the native client (the Go plugin's stand-in) gets the same answer
    native = NativeOracleClient(host, port)
    resp_native = native.schedule(req)
    native_row = native.row("capacity", 7, resp_native.batch_seq)
    native.close()
    if not same_response(resp_native, resp_py) \
            or not (native_row == local._state.row("capacity", 7)).all():
        raise AssertionError("the native client's answer differs from the Python client's")
    # a 1 ms deadline: DEADLINE_ERROR, then the connection answers right
    deadline_errors = 0
    for _ in range(3):
        try:
            client._round_trip(proto.MsgType.SCHEDULE_REQ, payload, deadline_ms=1)
        except errs.OracleDeadlineError:
            deadline_errors += 1
    after = client.schedule(req)
    if not deadline_errors or not same_response(after, resp_py):
        raise AssertionError(f"deadline: {deadline_errors} DEADLINE_ERROR answers, "
                             f"next answer right: {same_response(after, resp_py)}")
    # load windows: one connection, or two at once (each connection's
    # rows come from its own last batch); every answer and row right
    want_row = local._state.row("capacity", 7)
    answers, errors = [], []

    def load(n):
        try:
            c = NativeOracleClient(host, port)
            for _ in range(n):
                resp = c.schedule(req)
                answers.append((resp, c.row("capacity", 7, resp.batch_seq)))
            c.close()
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    def window(connections):
        threads = [threading.Thread(target=load, args=(SIDECAR_WINDOW // connections,))
                   for _ in range(connections)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120.0)

    windows = []
    for connections in SIDECAR_LOAD:
        w = profile_window(lambda: window(connections), "window_ms")
        w.pop("top_device_ops", None)
        windows.append({"connections": connections, "requests": SIDECAR_WINDOW,
                        "requests_per_s": SIDECAR_WINDOW / w["window_ms"] * 1e3, **w})
    wrong = sum(not same_response(a, resp_py) or not (row == want_row).all()
                for a, row in answers)
    if errors or wrong or len(answers) != SIDECAR_WINDOW * len(SIDECAR_LOAD):
        raise AssertionError(f"load windows: {len(answers)} answers, {wrong} wrong, "
                             f"errors {errors[:2]}")
    # drain: work gets DRAINING, PING gets PONG
    drain = server.drain(timeout=30.0)
    try:
        client.schedule(req)
        raise AssertionError("a drained server executed a batch")
    except errs.OracleDrainingError:
        pass
    if not client.ping() or not drain["drained"]:
        raise AssertionError(f"drain: report {drain}")
    client.close()
    restore_counts(saved)
    med = lambda xs: statistics.median(xs) * 1e3  # noqa: E731
    return {
        "server_split_ms_median": {k.replace("_seconds", ""): med(v)
                                   for k, v in split.items()},
        "server_split_ms": {k.replace("_seconds", ""): [x * 1e3 for x in v]
                            for k, v in split.items()},
        "server_telemetry": tele,
        "request_bytes_north_star_full": len(payload) + 16,
        "mixed": {"request_bytes": len(proto.pack_schedule_request(mixed_req)) + 16,
                  "mask_rows": int(batch_args[4].shape[0]),
                  "round_trip_ms": mixed_ms, "equal_plain_cpu": True},
        "native_equal": True, "deadline_errors": deadline_errors,
        "load_windows": windows,
        "drain": drain,
    }


def sidecar_outage():
    """RemoteScorer(fallback="local-cpu") inside ScheduleOperation on bench.py's
    deployment plus one gang that fits no node, against its own server:
    healthy, then the server stopped (the scorer degrades, counts the
    fallback batch, passes a feasible gang without a plan and denies only
    the infeasible one), then a server restarted on the same port (the
    scorer recovers once the breaker's cooldown ends). Launches restored."""
    import socket

    from batch_scheduler_tpu_torch.api.types import PodGroupPhase
    from batch_scheduler_tpu_torch.cache import PodGroupMatchStatus
    from batch_scheduler_tpu_torch.core import ScheduleOperation
    from batch_scheduler_tpu_torch.service import RemoteScorer, ResilientOracleClient
    from batch_scheduler_tpu_torch.service import serve_background
    from batch_scheduler_tpu_torch.sim.scenarios import make_member_pods, make_sim_group
    from batch_scheduler_tpu_torch.utils import errors as errs
    from batch_scheduler_tpu_torch.utils.metrics import DEFAULT_REGISTRY
    from batch_scheduler_tpu_torch.utils.retry import CircuitBreaker, RetryPolicy

    saved = read_counts()
    fallback = DEFAULT_REGISTRY.counter("bst_oracle_fallback_batches_total")
    cluster, cache = north_star_state()
    huge = make_sim_group("gang-huge", 2, creation_ts=-1.0)
    huge.spec.min_resources = {"cpu": SIDECAR_HUGE_CPU * 1000}
    huge.status.phase = PodGroupPhase.PENDING
    pgs = PodGroupMatchStatus(huge)
    pgs.pod = make_member_pods("gang-huge", 1, {"cpu": str(SIDECAR_HUGE_CPU)})[0]
    cache.set(huge.full_name(), pgs)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    server = serve_background(port=port, device="cuda")
    scorer = RemoteScorer(ResilientOracleClient(
        "127.0.0.1", port, timeout=60.0, connect_timeout=1.0,
        retry_policy=RetryPolicy(max_attempts=2, base_delay=0.01, max_delay=0.02),
        breaker=CircuitBreaker(failure_threshold=1, reset_timeout=0.5)),
        fallback="local-cpu")
    op = ScheduleOperation(cache, cluster, scorer=scorer)
    member = {name: make_member_pods(name, 1, {"cpu": "4"})[0]
              for name in ("gang-0000", "gang-0001", "gang-0002", "gang-huge")}
    out = {}
    try:
        f0 = fallback.value()
        op.pre_filter(member["gang-0000"])
        if scorer.degraded or fallback.value() != f0 or not scorer.placed("default/gang-0000"):
            raise AssertionError("the healthy batch was not served")
        server.shutdown()
        server.server_close()
        op.mark_dirty()
        t0 = time.perf_counter()
        op.pre_filter(member["gang-0001"])  # feasible: passes without a plan
        out["degraded_prefilter_ms"] = (time.perf_counter() - t0) * 1e3
        if not scorer.degraded or fallback.value() != f0 + 1 \
                or scorer.placed("default/gang-0001"):
            raise AssertionError(f"outage: degraded {scorer.degraded}, fallback batches "
                                 f"{fallback.value() - f0}")
        try:
            op.pre_filter(member["gang-huge"])
            raise AssertionError("the infeasible gang passed a degraded PreFilter")
        except errs.ResourceNotEnoughError as e:
            if "degraded oracle" not in str(e):
                raise
        infeasible = [n for n in sorted(cache.snapshot()) if not scorer.gang_feasible(n)]
        if infeasible != ["default/gang-huge"]:
            raise AssertionError(f"degraded batch: infeasible gangs {infeasible[:5]}")
        server = serve_background(port=port, device="cuda")
        time.sleep(0.6)  # the breaker's cooldown
        t0 = time.perf_counter()
        op.pre_filter(member["gang-0002"])
        out["recovery_prefilter_ms"] = (time.perf_counter() - t0) * 1e3
        if scorer.degraded or not scorer.placed("default/gang-0002"):
            raise AssertionError("the scorer did not recover after the restart")
        out.update(fallback_batches=fallback.value() - f0, recovered=True)
    finally:
        scorer.close()
        server.shutdown()
        server.server_close()
        restore_counts(saved)
    return out


def drive_sidecar(wave):
    """The sidecar at the north star with ``BST_SCAN_WAVE`` set to ``wave``
    (None: unset) for the whole phase: serve_background(device="cuda"), the
    main path (sidecar_churn), the checks on that server (sidecar_checks),
    then the outage path on its own server (sidecar_outage). The fallback
    counter must not move on the healthy path. Returns (launches by
    kernel, report)."""
    from batch_scheduler_tpu_torch.service import serve_background
    from batch_scheduler_tpu_torch.utils.metrics import DEFAULT_REGISTRY

    fallback = DEFAULT_REGISTRY.counter("bst_oracle_fallback_batches_total")
    f0 = fallback.value()
    with scan_wave_env(wave):
        server = serve_background(device="cuda")
        try:
            if server.device.type != "cuda":
                raise AssertionError(f"server on {server.device}")
            launches, report, local = sidecar_churn(server, wave)
            report.update(sidecar_checks(server, local, wave))
        finally:
            server.shutdown()
            server.server_close()
        if fallback.value() != f0:
            raise AssertionError(f"{fallback.value() - f0} fallback batches on the "
                                 "healthy path")
        report["fallback_batches_healthy"] = 0
        report["outage"] = sidecar_outage()
    return launches, report


@phase("sidecar")
def sidecar(results):
    launches, report = drive_sidecar(None)
    batches = 2 * report["refreshes"]  # the two remote scorers' batches
    if launches != only(assign_scan=batches):
        raise AssertionError(f"{launches} launches in {batches} server batches "
                             "(want assign_scan once per batch, assign_wave never)")
    if "assign_scan" in results:
        results["assign_scan"]["launches_by_path"]["sidecar"] = launches["assign_scan"]
    return {**report, "launches": launches["assign_scan"]}


@phase("sidecar_wave")
def sidecar_wave(results):
    wave = 8
    launches, report = drive_sidecar(wave)
    batches = 2 * report["refreshes"]
    if launches != only(assign_wave=batches):
        raise AssertionError(f"{launches} launches in {batches} server batches "
                             "(want assign_wave once per batch, assign_scan never)")
    tele = report["server_telemetry"]
    if tele.get("waves_per_batch") != NORTH_STAR_SHAPE[0] // wave:
        raise AssertionError(f"server wave telemetry {tele}")
    if "assign_wave" in results:
        results["assign_wave"]["launches_by_path"]["sidecar_wave"] = launches["assign_wave"]
    return {**report, "launches": launches["assign_wave"]}


# -- the multi-tenant sidecar: the coalescer and the capacity observatory -----

COALESCE_TENANTS = 8  # benchmarks/coalesce_gate.py:65 CLIENTS
COALESCE_ROUNDS = 8  # churn refreshes after each tenant's keyframe
COALESCE_SEED_PODS = 64  # seeded 2-cpu pods that make each tenant's cluster its own
MEGA_SHAPE = (50, 100, 10)  # BASELINE config 2: nodes, gangs, members
MEGA_ROUNDS = 4
DRF_SHAPE = (500, 1000, 4)  # BASELINE config 3: 1k PodGroups, 500 nodes
DRF_WHALES, DRF_REQUESTS, DRF_SOLO = 6, 8, 6  # benchmarks/coalesce_gate.py:213-282
BUSY_DEPTH = 2
CAPACITY_ROUNDS = 4  # refreshes sampled at BST_CAPACITY_BUDGET_FRAC=1.0
CAPACITY_CHURN = 40  # churn refreshes at the default 2% budget, capacity on/off in turns
CAPACITY_REPS = 20


def coalesce_tenant_state(i):
    """Tenant ``i``'s north-star deployment: north_star_state plus
    COALESCE_SEED_PODS 2-cpu pods assumed on seeded nodes, so every
    tenant's keyframe is its own."""
    import numpy as np

    from batch_scheduler_tpu_torch.sim.scenarios import make_member_pods

    cluster, cache = north_star_state()
    rng = np.random.default_rng(1000 + i)
    names = [n.metadata.name for n in cluster.list_nodes()]
    pods = make_member_pods(f"tenant{i}-seed", COALESCE_SEED_PODS, {"cpu": "2"})
    for pod, k in zip(pods, rng.integers(0, len(names), COALESCE_SEED_PODS)):
        cluster.assume(pod, names[int(k)])
    return cluster, cache


def drive_tenants(server, time_sliced, profiled=False):
    """Every tenant's script against ``server``, each tenant on its own
    thread with a RemoteScorer (a windowed ResilientOracleClient: wire
    deltas; its own TENANT announcement) on a fresh seeded state: a
    keyframe refresh and COALESCE_ROUNDS Churn refreshes (tenant i's
    rounds offset by 3i). ``time_sliced`` holds one lock around every
    refresh: one request in flight across all tenants (the gate's
    baseline). Returns (per-tenant results, wall seconds of the
    refreshes, and with ``profiled`` the profiler's view of that window:
    the card's busy time and idle share)."""
    import threading

    import numpy as np

    from batch_scheduler_tpu_torch.service import RemoteScorer, ResilientOracleClient
    from batch_scheduler_tpu_torch.utils import audit as audit_mod

    host, port = server.address
    states = [coalesce_tenant_state(i) for i in range(COALESCE_TENANTS)]
    lock = threading.Lock() if time_sliced else contextlib.nullcontext()
    start = threading.Barrier(COALESCE_TENANTS + 1)
    results = [None] * COALESCE_TENANTS
    errors = []

    def run(i):
        try:
            cluster, cache = states[i]
            scorer = RemoteScorer(ResilientOracleClient(host, port, window=2, timeout=120),
                                  tenant=f"tenant-{i}")
            churn = Churn(cluster, cache, lambda name: scorer.mark_dirty(group=name),
                          COALESCE_ROUNDS + 1)
            out = {"digests": [], "hosts": [], "latency": []}
            start.wait(600)
            for r in range(COALESCE_ROUNDS + 1):
                if r:
                    churn(r + 3 * i)
                with lock:
                    t0 = time.perf_counter()
                    scorer.refresh(cluster, cache)
                    out["latency"].append(time.perf_counter() - t0)
                res = scorer._state.result
                if not res["placed"][:NORTH_STAR_GANGS].all():
                    raise AssertionError(f"tenant {i} refresh {r}: not every gang placed")
                out["digests"].append(audit_mod.plan_digest(res))
                out["hosts"].append({k: np.array(res[k]) for k in HOST_KEYS})
            scorer.close()
            results[i] = out
        except BaseException as e:  # noqa: BLE001 — raised below
            errors.append(e)
            start.abort()

    def window():
        try:
            start.wait(600)
        except threading.BrokenBarrierError:
            pass
        for t in threads:
            t.join(600)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(COALESCE_TENANTS)]
    for t in threads:
        t.start()
    prof = None
    t0 = time.perf_counter()
    if profiled:
        prof = profile_window(window, "window_ms")
        prof.pop("top_device_ops", None)
    else:
        window()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return results, wall, prof


def p50_p95(xs):
    """(p50, p95) in ms by sorted index (sim/harness.py:27 wait_p95's
    convention)."""
    xs = sorted(xs)
    pick = lambda q: xs[min(int(len(xs) * q), len(xs) - 1)] * 1e3  # noqa: E731
    return pick(0.5), pick(0.95)


def drive_coalesce_span(wave):
    """coalesce_span with ``BST_SCAN_WAVE`` set to ``wave`` (None: unset)
    on the servers, BST_CAPACITY=0 (the coalesce gate's setting: the
    remote scorers' own capacity samples on the host would load the CPU
    the runs compare): COALESCE_TENANTS tenants at the north star. The
    time-sliced run against a dedicated sidecar (coalesce=False) and the
    coalesced run (the main path; every kernel's count zeroed just before
    it and read just after) against serve_background(coalesce=True), then
    each again under the profiler for the card's idle share. Every
    tenant's host dicts and plan_digest sequence must be equal in the two
    runs; G_tot·N_tot is far above 2^21, so every group runs the span
    lowering. Returns (launches by kernel, report)."""
    from batch_scheduler_tpu_torch.service import serve_background

    batches = COALESCE_TENANTS * (COALESCE_ROUNDS + 1)
    with scan_wave_env(wave), env_set({"BST_CAPACITY": "0"}):
        ded = serve_background(device="cuda", coalesce=False)
        srv = serve_background(device="cuda", coalesce=True)
        try:
            coal = srv.coalescer
            if coal.mode != "auto" or srv.device.type != "cuda":
                raise AssertionError(f"coalescer mode {coal.mode} on {srv.device}")
            sliced, sliced_wall, _ = drive_tenants(ded, True)
            waits = {}
            coal._wait = type("Waits", (), {"observe": staticmethod(
                lambda v, tenant: waits.setdefault(tenant, []).append(v))})()
            zero_counts()
            coalesced, wall, _ = drive_tenants(srv, False)
            launches = read_counts()
            stats = coal.stats()
            main_waits = {k: list(v) for k, v in waits.items()}
            saved = read_counts()
            profiled = {"time_sliced": drive_tenants(ded, True, profiled=True)[2],
                        "coalesced": drive_tenants(srv, False, profiled=True)[2]}
            restore_counts(saved)
        finally:
            for s in (srv, ded):
                s.shutdown()
                s.server_close()
    for i in range(COALESCE_TENANTS):
        a, b = coalesced[i], sliced[i]
        if a["digests"] != b["digests"]:
            raise AssertionError(f"tenant {i}: coalesced plan digests differ from the "
                                 "dedicated sidecar's")
        for r, (x, y) in enumerate(zip(a["hosts"], b["hosts"])):
            diff = host_diff(x, y)
            if diff:
                raise AssertionError(f"tenant {i} refresh {r}: host dict differs in {diff}")
    if stats["mega_groups"] or stats["mega_failures"] or not stats["groups_run"]:
        raise AssertionError(f"coalescer stats {stats} (want span groups only)")
    per_tenant = {}
    for i in range(COALESCE_TENANTS):
        t = f"tenant-{i}"
        per_tenant[t] = {
            "queue_wait_ms_p50_p95": p50_p95(main_waits[t]),
            "request_ms_p50_p95_coalesced": p50_p95(coalesced[i]["latency"]),
            "request_ms_p50_p95_time_sliced": p50_p95(sliced[i]["latency"]),
        }
    report = {
        "tenants": COALESCE_TENANTS, "batches": batches,
        "aggregate_batches_per_s": {"coalesced": batches / wall,
                                    "time_sliced": batches / sliced_wall},
        "wall_s": {"coalesced": wall, "time_sliced": sliced_wall},
        "per_tenant": per_tenant,
        "groups_run": stats["groups_run"], "mean_span_width": batches / stats["groups_run"],
        "mega_groups": stats["mega_groups"], "mega_failures": stats["mega_failures"],
        "profiled": profiled, "equal_dedicated": True,
        "launches_by_kernel": launches,
    }
    return launches, report


@phase("coalesce_span")
def coalesce_span(results):
    launches, report = drive_coalesce_span(None)
    want = only(assign_scan=report["batches"])
    if launches != want:
        raise AssertionError(f"{launches} launches in {report['batches']} tenant batches "
                             "(want assign_scan once per batch)")
    if "assign_scan" in results:
        results["assign_scan"]["launches_by_path"]["coalesce_span"] = launches["assign_scan"]
    return report


@phase("coalesce_span_wave")
def coalesce_span_wave(results):
    launches, report = drive_coalesce_span(8)
    want = only(assign_wave=report["batches"])
    if launches != want:
        raise AssertionError(f"{launches} launches in {report['batches']} tenant batches "
                             "(want assign_wave once per batch)")
    if "assign_wave" in results:
        results["assign_wave"]["launches_by_path"]["coalesce_span_wave"] = launches["assign_wave"]
    return report


def tenant_stream(tenant, batches, num_nodes, num_gangs, members):
    """Tenant ``tenant``'s deterministic unpadded ScheduleRequests: the
    port's packer over ``num_nodes`` nodes of 16 cpu / 64 GiB / 110 pods
    and ``num_gangs`` gangs of ``members`` pods (1-4 cpu, 2-8 GiB each,
    priorities -1..1), seeded by the tenant; each batch moves 4 nodes'
    requested rows (to 0-50% of alloc) and one gang's remaining count."""
    import numpy as np

    from batch_scheduler_tpu_torch.ops.snapshot import ClusterSnapshot, GroupDemand
    from batch_scheduler_tpu_torch.service import protocol as proto
    from batch_scheduler_tpu_torch.sim.scenarios import make_sim_node

    rng = np.random.default_rng(7000 + tenant)
    nodes = [make_sim_node(f"n{i:04d}", {"cpu": "16", "memory": "64Gi", "pods": "110"})
             for i in range(num_nodes)]
    demands = [GroupDemand(f"tenant-{tenant}/gang-{g:04d}", members,
                           member_request={"cpu": int(rng.integers(1, 5)) * 1000,
                                           "memory": int(rng.integers(2, 9)) * 2**30},
                           creation_ts=float(g), priority=g % 3 - 1)
               for g in range(num_gangs)]
    snap = ClusterSnapshot(nodes, {}, demands)
    n, g = num_nodes, num_gangs
    base = [np.array(a) for a in (
        snap.alloc[:n], snap.requested[:n], snap.group_req[:g], snap.remaining[:g],
        snap.fit_mask[:, :n], snap.group_valid[:g], snap.order[:g], snap.min_member[:g],
        snap.scheduled[:g], snap.matched[:g], snap.ineligible[:g], snap.creation_rank[:g])]
    if sorted(base[6].tolist()) != list(range(g)):
        raise AssertionError("the packed order is not a permutation of the real gangs")
    out = []
    for _ in range(batches):
        rows = rng.integers(0, n, size=4)
        base[1][rows] = (base[0][rows] * rng.random((4, base[0].shape[1])) * 0.5).astype(np.int32)
        base[3][int(rng.integers(0, g))] = int(rng.integers(1, members + 1))
        out.append(proto.ScheduleRequest(*[a.copy() for a in base]))
    return out


def record_groups(coal):
    """Every group the coalescer runs from now on, as (lowering, width)."""
    groups = []
    real = coal._note_group

    def note(mode, group):
        groups.append((mode, len(group)))
        real(mode, group)

    coal._note_group = note
    return groups


def gate_selection(coal, k):
    """Hold the coalescer's group selection until ``k`` jobs are pending
    (each lockstep round of ``k`` tenants forms one group of width
    ``k``); returns a function that lifts the gate."""
    real = coal._select_group_locked

    def select():  # lock-held: _cv
        if coal._pending < k:
            coal._cv.wait(0.01)
            return []
        return real()

    coal._select_group_locked = select
    return lambda: setattr(coal, "_select_group_locked", real)


def tenant_answers(server, streams, lockstep):
    """Each tenant's stream on its own connection (its TENANT announced),
    every SCHEDULE_RESP and one ROW_RESP after it as raw bytes;
    ``lockstep`` holds the tenants to rounds (a barrier between rounds),
    else they run one after another."""
    import threading

    from batch_scheduler_tpu_torch.service import OracleClient
    from batch_scheduler_tpu_torch.service import protocol as proto

    answers = [None] * len(streams)
    barrier = threading.Barrier(len(streams)) if lockstep else None
    errors = []

    def run(i):
        try:
            client = OracleClient(*server.address, timeout=120)
            out = []
            for req in streams[i]:
                if barrier is not None:
                    barrier.wait(300)
                kind, body = client._round_trip(proto.MsgType.SCHEDULE_REQ,
                                                proto.pack_schedule_request(req),
                                                tenant=f"tenant-{i}")
                seq = proto.unpack_schedule_response(body).batch_seq
                row = client.row("capacity", req.group_req.shape[0] - 1, seq)
                out.append((kind, body, row.tobytes()))
            client.close()
            answers[i] = out
        except BaseException as e:  # noqa: BLE001 — raised below
            errors.append(e)
            if barrier is not None:
                barrier.abort()

    if lockstep:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(streams))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
    else:
        for i in range(len(streams)):
            run(i)
    if errors:
        raise errors[0]
    return answers


@phase("coalesce_mega")
def coalesce_mega(results):
    """COALESCE_TENANTS tenants at BASELINE config 2 (MEGA_SHAPE: 100
    PodGroups x 10 pods, 50 nodes, cpu + mem): G_tot·N_tot = 800·400 =
    320,000 cells, under BST_COALESCE_MEGA_CELLS' 2^21, so the auto mode
    merges block-diagonal mega batches. The tenants run MEGA_ROUNDS
    requests in lockstep against serve_background(coalesce=True) with the
    group selection held until all are pending (one merged group a round:
    the main path, every kernel's count zeroed just before and read just
    after), then one after another against a dedicated sidecar. Every
    response and row must equal its dedicated bytes; mega_groups > 0, no
    failed mega group, one serial-kernel launch a merged group."""
    from batch_scheduler_tpu_torch.service import protocol as proto
    from batch_scheduler_tpu_torch.service import serve_background

    n, g, members = MEGA_SHAPE
    streams = [tenant_stream(i, MEGA_ROUNDS, n, g, members)
               for i in range(COALESCE_TENANTS)]
    srv = serve_background(device="cuda", coalesce=True)
    ded = serve_background(device="cuda", coalesce=False)
    try:
        coal = srv.coalescer
        gate_selection(coal, COALESCE_TENANTS)
        zero_counts()
        t0 = time.perf_counter()
        got = tenant_answers(srv, streams, lockstep=True)
        wall = time.perf_counter() - t0
        launches = read_counts()
        stats = coal.stats()
        saved = read_counts()
        want = tenant_answers(ded, streams, lockstep=False)
        restore_counts(saved)
    finally:
        for s in (srv, ded):
            s.shutdown()
            s.server_close()
    for i in range(COALESCE_TENANTS):
        if got[i] != want[i]:
            raise AssertionError(f"tenant {i}: mega answers differ from the dedicated bytes")
    placed = [int(proto.unpack_schedule_response(body).placed.sum()) for _, body, _ in got[0]]
    if not stats["mega_groups"] or stats["mega_failures"] \
            or stats["mega_groups"] != MEGA_ROUNDS:
        raise AssertionError(f"coalescer stats {stats}")
    if launches != only(assign_scan=stats["groups_run"]):
        raise AssertionError(f"{launches} launches in {stats['groups_run']} merged groups")
    if "assign_scan" in results:
        results["assign_scan"]["launches_by_path"]["coalesce_mega"] = launches["assign_scan"]
    return {"tenants": COALESCE_TENANTS, "rounds": MEGA_ROUNDS,
            "cells": COALESCE_TENANTS * g * COALESCE_TENANTS * n,
            "groups_run": stats["groups_run"], "mega_groups": stats["mega_groups"],
            "mega_failures": stats["mega_failures"], "launches_by_kernel": launches,
            "tenant0_placed_by_round": placed, "wall_ms": wall * 1e3,
            "equal_dedicated_bytes": True}


@phase("coalesce_drf")
def coalesce_drf(results):
    """The whale storm of benchmarks/coalesce_gate.py:213 at BASELINE
    config 3 (DRF_SHAPE: 1k PodGroups of 4 pods, 500 nodes, mixed
    priorities) on serve_background(device="cuda", coalesce=True) with the
    capacity observatory on (its default): an idle-server baseline
    (DRF_SOLO requests, their median the solo batch), then DRF_WHALES
    connections flood the "whale" label with DRF_REQUESTS requests each
    while one "small" tenant trickles DRF_REQUESTS requests, sleeping a
    solo batch between them. Every request is traced, so the sidecar's
    capacity samples feed _capacity_tenant_shares, the coalescer's DRF
    weights. Holds the small tenant's p95 request time to the gate's two
    bounds: <= max(10 x solo, 1 s) and <= 1.25 x the whale's p95. Every
    kernel's count is zeroed just before the storm and read just after:
    one serial-kernel launch a span group's batch and one a mega group
    (two config-3 tenants are 2,000,000 cells, under 2^21: a group of
    two merges)."""
    import threading

    from batch_scheduler_tpu_torch.service import OracleClient, serve_background
    from batch_scheduler_tpu_torch.service import protocol as proto
    from batch_scheduler_tpu_torch.service import server as server_mod
    from batch_scheduler_tpu_torch.utils.metrics import DEFAULT_REGISTRY
    from batch_scheduler_tpu_torch.utils.trace import new_trace_id

    n, g, members = DRF_SHAPE
    samples = DEFAULT_REGISTRY.counter("bst_capacity_samples_total")
    errors0 = samples.value(outcome="error")
    srv = serve_background(device="cuda", coalesce=True)
    host, port = srv.address
    errors = []

    def traced(client, req, tenant):
        t0 = time.perf_counter()
        kind, body = client._round_trip(proto.MsgType.SCHEDULE_REQ,
                                        proto.pack_schedule_request(req),
                                        trace_ctx=(new_trace_id(), ""), tenant=tenant)
        if kind != proto.MsgType.SCHEDULE_RESP:
            raise AssertionError(f"answer {kind}")
        return time.perf_counter() - t0

    try:
        base = OracleClient(host, port, timeout=300)
        solo = [traced(base, req, "warm") for req in tenant_stream(50, DRF_SOLO, n, g, members)]
        base.close()
        solo_s = sorted(solo[1:])[len(solo[1:]) // 2]
        whale_waits, small_waits = [], []

        def whale(i):
            try:
                c = OracleClient(host, port, timeout=300)
                for req in tenant_stream(60 + i, DRF_REQUESTS, n, g, members):
                    whale_waits.append(traced(c, req, "whale"))
                c.close()
            except BaseException as e:  # noqa: BLE001 — raised below
                errors.append(e)

        def small():
            try:
                c = OracleClient(host, port, timeout=300)
                for req in tenant_stream(99, DRF_REQUESTS, n, g, members):
                    small_waits.append(traced(c, req, "small"))
                    time.sleep(solo_s)  # a trickle, not a flood
                c.close()
            except BaseException as e:  # noqa: BLE001 — raised below
                errors.append(e)

        groups = record_groups(srv.coalescer)
        zero_counts()
        threads = [threading.Thread(target=whale, args=(i,)) for i in range(DRF_WHALES)]
        for t in threads:
            t.start()
        time.sleep(solo_s * 2)  # let the whale backlog form first
        st = threading.Thread(target=small)
        st.start()
        for t in threads + [st]:
            t.join(600)
        launches = read_counts()
        stats = srv.coalescer.stats()
        shares = server_mod._capacity_tenant_shares()
    finally:
        srv.shutdown()
        srv.server_close()
    if errors:
        raise errors[0]
    storm = (DRF_WHALES + 1) * DRF_REQUESTS
    batches = sum(w if mode == "span" else 1 for mode, w in groups)
    if sum(w for _, w in groups) != storm or stats["mega_failures"] \
            or launches != only(assign_scan=batches):
        raise AssertionError(f"{launches} launches in {storm} storm requests, groups "
                             f"{groups}, stats {stats}")
    cap_errors = samples.value(outcome="error") - errors0
    if cap_errors or not shares:
        raise AssertionError(f"capacity samples: {cap_errors} errors, shares {shares}")
    small_p50, small_p95 = p50_p95(small_waits)
    whale_p50, whale_p95 = p50_p95(whale_waits)
    bound_ms = max(10 * solo_s, 1.0) * 1e3
    if not (small_p95 <= bound_ms and small_p95 <= 1.25 * whale_p95):
        raise AssertionError(f"small tenant p95 {small_p95:.3f} ms vs bound {bound_ms:.3f} ms "
                             f"(whale p95 {whale_p95:.3f} ms)")
    if "assign_scan" in results:
        results["assign_scan"]["launches_by_path"]["coalesce_drf"] = launches["assign_scan"]
    return {"solo_batch_ms": solo_s * 1e3, "small_ms_p50_p95": [small_p50, small_p95],
            "whale_ms_p50_p95": [whale_p50, whale_p95], "starvation_bound_ms": bound_ms,
            "relative_bound_ms": 1.25 * whale_p95, "observatory_shares": shares,
            "groups": {"span": sum(m == "span" for m, _ in groups),
                       "mega": sum(m == "mega" for m, _ in groups),
                       "mean_width": storm / max(len(groups), 1)},
            "served_share": stats["served_share"], "launches_by_kernel": launches}


@phase("coalesce_busy")
def coalesce_busy(results):
    """Admission control on the card: BST_COALESCE_DEPTH=BUSY_DEPTH and the
    executor parked behind a closure that waits on an event. One job taken
    by the coalescer's worker and BUSY_DEPTH pending fill the queue
    deterministically; then a full request and a wire delta are both
    answered BUSY (the span lowering: BST_COALESCE_MODE=span), the refused delta leaves its mirror's generation as it
    was (the same delta applies once the queue drains), and
    ResilientOracleClient waits out the hint (its sleep opens the gate and
    waits for the queue to drain) and succeeds with its breaker closed.
    The main path (every count zeroed before it, read after): the three
    filler batches, the retried one and the delta's, one serial-kernel
    launch each."""
    import threading
    import types

    import numpy as np

    from batch_scheduler_tpu_torch.service import client as tclient
    from batch_scheduler_tpu_torch.service import protocol as proto
    from batch_scheduler_tpu_torch.service import serve_background
    from batch_scheduler_tpu_torch.utils.metrics import DEFAULT_REGISTRY

    T, P = proto.MsgType, proto
    n, g, members = MEGA_SHAPE
    req = tenant_stream(5, 1, n, g, members)[0]
    busy_counter = DEFAULT_REGISTRY.counter("bst_oracle_busy_total")
    with env_set({"BST_COALESCE_DEPTH": str(BUSY_DEPTH), "BST_COALESCE_MODE": "span"}):
        srv = serve_background(device="cuda", coalesce=True)
    coal = srv.coalescer
    gate, parked = threading.Event(), threading.Event()
    real_time = tclient.time
    try:
        if coal.depth != BUSY_DEPTH:
            raise AssertionError(f"coalescer depth {coal.depth}")
        delta = tclient.OracleClient(*srv.address, timeout=120)
        kind, _ = delta._round_trip(T.DELTA_SCHEDULE_REQ, P.pack_delta_keyframe(1, req))
        if kind != T.SCHEDULE_RESP:
            raise AssertionError(f"keyframe answer {kind}")
        rows = P.DeltaScheduleRequest(
            node_idx=np.array([3], np.int32), node_rows=req.requested[[3]] + 1,
            group_idx=np.zeros(0, np.int32),
            group_rows=np.zeros((0, req.alloc.shape[1]), np.int32),
            remaining=req.remaining, fit_mask=req.fit_mask, group_valid=req.group_valid,
            order=req.order, min_member=req.min_member, scheduled=req.scheduled,
            matched=req.matched, ineligible=req.ineligible,
            creation_rank=req.creation_rank, n=n, g=g, r=req.alloc.shape[1])

        def park():
            parked.set()
            gate.wait(300)

        zero_counts()
        threading.Thread(target=srv.executor.run, args=(park,), daemon=True).start()
        if not parked.wait(60):
            raise AssertionError("the executor never took the parking closure")
        answers = []

        def fill():
            c = tclient.OracleClient(*srv.address, timeout=300)
            answers.append(c._round_trip(T.SCHEDULE_REQ, P.pack_schedule_request(req))[0])
            c.close()

        fillers = [threading.Thread(target=fill) for _ in range(BUSY_DEPTH + 1)]
        fillers[0].start()
        deadline = time.monotonic() + 60
        while srv.executor._q.qsize() < 1:
            if time.monotonic() > deadline:
                raise AssertionError("the first job never reached the executor")
            time.sleep(0.001)
        for t in fillers[1:]:
            t.start()
        while coal.stats()["pending"] < BUSY_DEPTH:
            if time.monotonic() > deadline:
                raise AssertionError(f"queue never filled: {coal.stats()}")
            time.sleep(0.001)
        busy = tclient.OracleClient(*srv.address, timeout=120)
        refused = []
        for client, msg, payload in (
                (busy, T.SCHEDULE_REQ, P.pack_schedule_request(req)),
                (delta, T.DELTA_SCHEDULE_REQ, P.pack_delta_rows(1, 2, rows))):
            try:
                client._round_trip(msg, payload)
                raise AssertionError(f"message {msg} executed on a full queue")
            except tclient.OracleBusyError as e:
                refused.append(e.retry_after_ms)
        busy.close()

        def drained_sleep(seconds):
            gate.set()
            for t in fillers:
                t.join(120)
            while coal.stats()["pending"]:
                real_time.sleep(0.001)

        fake = types.SimpleNamespace(**{k: getattr(real_time, k) for k in dir(real_time)
                                        if not k.startswith("_")})
        fake.sleep = drained_sleep
        tclient.time = fake
        busy0 = sum(busy_counter.values().values())
        rc = tclient.ResilientOracleClient(*srv.address, timeout=120)
        resp = rc.schedule(req, tenant="retrier")
        tclient.time = real_time
        retried_busy = sum(busy_counter.values().values()) - busy0
        breaker = rc.breaker.state
        rc.close()
        if retried_busy != 1 or breaker != "closed" or not resp.placed.any():
            raise AssertionError(f"resilient retry: {retried_busy} BUSY, breaker {breaker}")
        kind, _ = delta._round_trip(T.DELTA_SCHEDULE_REQ, P.pack_delta_rows(1, 2, rows))
        if kind != T.SCHEDULE_RESP:
            raise AssertionError(f"the refused delta's retry answered {kind}")
        delta.close()
        launches = read_counts()
    finally:
        tclient.time = real_time
        gate.set()
        srv.shutdown()
        srv.server_close()
    if answers != [T.SCHEDULE_RESP] * (BUSY_DEPTH + 1) or not all(
            25 <= ms <= 5000 for ms in refused):
        raise AssertionError(f"fillers {answers}, BUSY hints {refused}")
    batches = BUSY_DEPTH + 1 + 2
    if launches != only(assign_scan=batches):
        raise AssertionError(f"{launches} launches in {batches} batches")
    if "assign_scan" in results:
        results["assign_scan"]["launches_by_path"]["coalesce_busy"] = launches["assign_scan"]
    return {"busy_hints_ms": refused, "depth": BUSY_DEPTH, "retried_busy": retried_busy,
            "breaker": breaker, "delta_generation_kept": True,
            "busy_total": int(coal._busy.value()), "launches_by_kernel": launches}


def device_work(fn):
    """(device busy ms, device operations) of one ``fn()`` under
    torch.profiler: the card's kernels, copies and memsets."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy, ops = 0.0, 0
    for ev in prof.key_averages():
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        busy += dev_us / 1e3
        ops += ev.count
    return busy, ops


def capacity_bound(args, tenants):
    """(bound_ms, bound_by) of one _capacity_kernel on these inputs: every
    input read once and the outputs written once over HBM bandwidth, vs
    its integer operations over the int32 rate — per (gang, node) a
    division and a minimum per requested lane plus the mask, twice (the
    capacity at batch entry and after the plan), and per node the lane
    bucket, stranded and consumable tests and the 5 size sweeps of 19
    sizes."""
    n, r = args[0].shape
    g, k = args[7].shape
    in_bytes = sum(t.numel() * t.element_size() for t in args)
    out_bytes = 4 * (r * (5 + 128) + 128 + 2 * 4 + 4 + tenants * (r + 1) + 10)
    lanes = int((args[2] > 0).sum().item())
    ops = 2 * n * (2 * lanes + 2 * g) + n * r * 6 + 5 * 19 * n * 2 + g * k * r * 2
    from batch_scheduler_tpu_torch.ops.bounds import bound

    return bound(in_bytes + out_bytes, ops)


@phase("capacity")
def capacity(results):
    """The capacity observatory at the north star. An OracleScorer on cuda
    (north_star_churn's deployment) with an audit log and
    BST_CAPACITY_BUDGET_FRAC=1.0: a keyframe refresh and CAPACITY_ROUNDS-1
    Churn refreshes, each sampled (the main path: every kernel's count
    zeroed before, read after; the sampler's error outcome must stay 0).
    On the last batch's resident tensors: the summary computed on the card
    equals the same function on CPU copies, the function's outputs on the
    card equal the CPU's (integers exactly; floats exactly too, both sum
    in int64) and two card runs are bit-equal; its time by CUDA events
    beside its bound. Every batch record's audit id has its
    capacity_sample event. A traced sidecar request's TRACE_INFO carries
    the capacity block, attributed to the announced tenant. Then, at the
    default 2% budget, CAPACITY_CHURN churn refreshes of two scorers on
    one cluster, BST_CAPACITY on and off, in turns: the share of the on
    scorer's refresh wall clock its hook took, and both refresh
    medians."""
    import tempfile

    import numpy as np
    import torch

    from batch_scheduler_tpu_torch.core import OracleScorer
    from batch_scheduler_tpu_torch.ops import capacity as cap
    from batch_scheduler_tpu_torch.service import OracleClient, serve_background
    from batch_scheduler_tpu_torch.service import protocol as proto
    from batch_scheduler_tpu_torch.service import server as server_mod
    from batch_scheduler_tpu_torch.utils import tenancy
    from batch_scheduler_tpu_torch.utils.audit import AuditLog, AuditReader
    from batch_scheduler_tpu_torch.utils.metrics import DEFAULT_REGISTRY
    from batch_scheduler_tpu_torch.utils.trace import new_trace_id

    samples = DEFAULT_REGISTRY.counter("bst_capacity_samples_total")
    errors0 = samples.value(outcome="error")
    out = {}
    with tempfile.TemporaryDirectory(prefix="bst-capacity-") as tmp, \
            env_set({"BST_CAPACITY": "1", "BST_CAPACITY_BUDGET_FRAC": "1.0"}):
        cluster, cache = north_star_state()
        log = AuditLog(tmp)
        scorer = OracleScorer(device="cuda", audit_log=log)
        if cap.active_sampler() is not scorer._capacity or scorer._capacity is None:
            raise AssertionError("the scorer's sampler is not the active one")
        churn = Churn(cluster, cache, lambda name: scorer.mark_dirty(group=name),
                      CAPACITY_ROUNDS)
        zero_counts()
        for r in range(CAPACITY_ROUNDS):
            if r:
                churn(r)
            scorer.refresh(cluster, cache)
        launches = read_counts()
        torch.cuda.synchronize()
        sampler = scorer._capacity
        if sampler.samples != CAPACITY_ROUNDS:
            raise AssertionError(f"{sampler.samples} samples in {CAPACITY_ROUNDS} refreshes")
        # the last batch's resident tensors, on the card and as CPU copies
        snap = scorer.snapshot
        resident = scorer._device_state.last_args()
        host = scorer._state.result
        progress = snap.progress_args()
        kw = dict(group_names=snap.group_names, scheduled=progress[1], matched=progress[2])
        with torch.cuda.stream(scorer.stream):
            on_card = cap.capacity_summary(resident, host, device="cuda", **kw)
            cpu_args = tuple(a.cpu() if hasattr(a, "cpu") else a for a in resident)
        on_cpu = cap.capacity_summary(cpu_args, host, device="cpu", **kw)
        if on_card != on_cpu or on_card != sampler.last():
            raise AssertionError("the summary on the card differs from the CPU's")
        tid, labels = tenancy.batch_tenants(snap.group_names, resident[2].shape[0])
        cols = (*resident[:6], np.asarray(host["placed"]).astype(np.int32),
                host["assignment_nodes"], host["assignment_counts"], progress[1],
                progress[2], tid, np.zeros(resident[2].shape[0], np.int32))
        dts = (np.int32,) * 4 + (np.bool_, np.bool_) + (np.int32,) * 7

        def kernel_args(device):
            from batch_scheduler_tpu_torch.ops.convert import _place_one

            dev = torch.device(device)
            return tuple(
                _place_one(a.cpu().numpy() if device == "cpu" and hasattr(a, "cpu") else a,
                           dt, dev)
                for a, dt in zip(cols, dts))

        card_args = kernel_args("cuda")
        runs = [cap._capacity_kernel(*card_args, tenants=len(labels)) for _ in range(2)]
        cpu_out = cap._capacity_kernel(*kernel_args("cpu"), tenants=len(labels))
        torch.cuda.synchronize()
        rel_err = 0.0
        for k, v in cpu_out.items():
            a, b = runs[0][k].cpu(), runs[1][k].cpu()
            if not torch.equal(a, b):
                raise AssertionError(f"two card runs differ in {k}")
            if v.dtype == torch.float32:
                rel_err = max(rel_err, float(((a - v).abs() / v.abs().clamp(min=1)).max()))
            elif not torch.equal(a, v):
                raise AssertionError(f"{k} on the card differs from the CPU's")
        kernel_ms = cuda_ms(lambda: cap._capacity_kernel(*card_args, tenants=len(labels)),
                            CAPACITY_REPS)
        busy_ms, device_ops = device_work(
            lambda: cap._capacity_kernel(*card_args, tenants=len(labels)))
        bound_ms, bound_by = capacity_bound(card_args, len(labels))
        if not log.flush(120.0):
            raise AssertionError("the audit log did not flush")
        records = list(AuditReader(tmp).records())
        batch_ids = [r["audit_id"] for r in records if r.get("kind") == "batch"]
        event_ids = [r["audit_id"] for r in records
                     if r.get("kind") == "event" and r["event"] == "capacity_sample"]
        if len(batch_ids) != CAPACITY_ROUNDS or event_ids != batch_ids or None in batch_ids:
            raise AssertionError(f"audit ids: batches {batch_ids}, samples {event_ids}")
        log.stop()
        out.update(refreshes=CAPACITY_ROUNDS, launches_by_kernel=launches,
                   summary_equal_cpu=True, repeat_bit_equal=True,
                   float_max_rel_err_vs_cpu=rel_err, kernel_ms=kernel_ms,
                   device_busy_ms=busy_ms, device_ops_a_call=device_ops,
                   bound_ms=bound_ms, bound_by=bound_by, tenants=len(labels),
                   sample_wall_ms=sampler.last_kernel_s * 1e3,
                   audit_events=len(event_ids),
                   last_summary={k: on_card[k] for k in (
                       "nodes", "fragmentation_index", "largest_placeable_gang",
                       "stranded", "pending", "placed", "top_tenant")})
        # the sidecar's traced sample, attributed to the announced tenant
        saved = read_counts()
        server_mod._server_capacity = None
        srv = serve_background(device="cuda")
        try:
            client = OracleClient(*srv.address, timeout=120)
            kind, body = client._round_trip(
                proto.MsgType.SCHEDULE_REQ,
                proto.pack_schedule_request(snapshot_request(snap)),
                trace_ctx=(new_trace_id(), ""), tenant="tenant-cap")
            tele = client.last_telemetry
            client.close()
        finally:
            srv.shutdown()
            srv.server_close()
        restore_counts(saved)
        shares = server_mod._capacity_tenant_shares()
        if "capacity" not in tele or set(shares) != {"tenant-cap"}:
            raise AssertionError(f"sidecar capacity: telemetry keys {sorted(tele)}, "
                                 f"shares {shares}")
        out["sidecar_capacity"] = {"telemetry": tele["capacity"], "shares": shares}
    # the default budget, capacity on and off in turns on one cluster
    saved = read_counts()
    cluster, cache = north_star_state()
    with env_set({"BST_CAPACITY": "1", "BST_CAPACITY_BUDGET_FRAC": None}):
        on = OracleScorer(device="cuda")
    with env_set({"BST_CAPACITY": "0"}):
        off = OracleScorer(device="cuda")
    hook_s = []
    on._capacity_sample = timed_calls(on._capacity_sample, hook_s)

    def mark(name):
        on.mark_dirty(group=name)
        off.mark_dirty(group=name)

    churn = Churn(cluster, cache, mark, CAPACITY_CHURN + 1)
    times = {"on": [], "off": []}
    for s in (on, off):
        s.refresh(cluster, cache)
    sampled0 = on._capacity.samples
    for r in range(1, CAPACITY_CHURN + 1):
        churn(r % CHURN_ROUNDS + CHURN_ROUNDS)  # off the priority/request rounds
        pair = ((on, "on"), (off, "off")) if r % 2 else ((off, "off"), (on, "on"))
        for s, label in pair:
            t0 = time.perf_counter()
            s.refresh(cluster, cache)
            torch.cuda.synchronize()
            times[label].append(time.perf_counter() - t0)
    restore_counts(saved)
    if samples.value(outcome="error") != errors0:
        raise AssertionError(f"{samples.value(outcome='error') - errors0} capacity errors")
    med = lambda xs: statistics.median(xs) * 1e3  # noqa: E731
    out["default_budget"] = {
        "churn_refreshes": CAPACITY_CHURN,
        "samples": on._capacity.samples - sampled0,
        "hook_share_of_refresh_wall": sum(hook_s[1:]) / sum(times["on"]),
        "churn_refresh_ms_median": {"capacity_on": med(times["on"]),
                                    "capacity_off": med(times["off"])},
        "budget_frac": cap.capacity_budget_frac(),
    }
    if "assign_scan" in results:
        results["assign_scan"]["launches_by_path"]["capacity"] = launches["assign_scan"]
    if launches != only(assign_scan=CAPACITY_ROUNDS):
        raise AssertionError(f"{launches} launches in {CAPACITY_ROUNDS} refreshes")
    return out


# benchmarks/ladder.py:250 config5_churn: 10,000 gangs of 10 pods (4 cpu,
# 8 GiB, 1 GPU) on the north-star nodes, a 600-gang backlog admitted through
# a 32-gang window, a 100 ms tick, ~2% of running gangs released a tick
CHURN_LOOP_GANGS, CHURN_LOOP_BACKLOG = 10000, 600
ADMIT_WINDOW, TICK_INTERVAL, LOOP_TICKS, LOOP_SEED = 32, 0.1, 50, 0
ARRIVALS_PER_TICK = 2
# report-only: ticks at a forced depth of 2 after the loop, and the burst
# of arrivals they start with (so stale placements collide and skip)
DEPTH2_TICKS, DEPTH2_BURST = 20, 200


def synthetic_demands(num_groups, members, cpu=2000, mem=4 * 1024**3, extra=None):
    """benchmarks/ladder.py:104 ``_synthetic_demands`` with the port's
    GroupDemand: gang g has ``members`` members of the given request,
    creation time g and priority (g % 3) - 1."""
    from batch_scheduler_tpu_torch.ops.snapshot import GroupDemand

    out = []
    for g in range(num_groups):
        req = {"cpu": cpu, "memory": mem}
        if extra:
            req.update(extra)
        out.append(GroupDemand(full_name=f"default/gang-{g:05d}", min_member=members,
                               member_request=req, creation_ts=float(g),
                               priority=(g % 3) - 1, has_pod=True))
    return out


def drive_churn_loop(wave):
    """benchmarks/ladder.py:250 ``config5_churn`` on cuda through the port's
    ChurnRescorer and TickPipeline, with ``BST_SCAN_WAVE`` set to ``wave``
    (None: unset): the north-star nodes, a CHURN_LOOP_BACKLOG-gang backlog
    of CHURN_LOOP_GANGS, warm on {8}, the depth from probe_link_depth,
    warm on {8, 16, 32, 64, window}, then LOOP_TICKS ticks of TICK_INTERVAL
    (collect the oldest batch, admit it whole, release ~2% of the running
    gangs, ARRIVALS_PER_TICK arrivals, dispatch the next window). Both
    kernels' counts are zeroed just before the pipeline's first dispatch
    and read after its drain. Every collected tick's snapshot is kept and,
    after the loop (so that its clock stays clean), run on the CPU by the
    plain path: its host dict must equal the tick's. Then one synchronous
    tick drains the queued deltas, and the resident occupancy must equal
    the padded mirror. Then, report-only, DEPTH2_TICKS ticks through
    TickPipeline(r, 2) after a burst of DEPTH2_BURST arrivals. Returns
    (launches by kernel, dispatches, report)."""
    import numpy as np
    import torch

    from batch_scheduler_tpu_torch.ops.oracle import execute_batch_host
    from batch_scheduler_tpu_torch.ops.rescore import (
        ChurnRescorer, TickPipeline, probe_link_depth)
    from batch_scheduler_tpu_torch.sim.scenarios import make_sim_node

    rng = np.random.default_rng(LOOP_SEED)
    nodes = [make_sim_node(f"n{i:05d}", {"cpu": "64", "memory": "256Gi", "pods": "110", GPU: "8"})
             for i in range(NORTH_STAR_NODES)]
    all_gangs = synthetic_demands(CHURN_LOOP_GANGS, 10, cpu=4000, mem=8 * 1024**3,
                                  extra={GPU: 1})
    pending = all_gangs[:CHURN_LOOP_BACKLOG]
    arrivals = iter(all_gangs[CHURN_LOOP_BACKLOG:])

    def churn(r):
        """~2% of the running gangs finish; ARRIVALS_PER_TICK gangs arrive."""
        running = r.running
        for _ in range(max(1, len(running) // 50) if running else 0):
            r.release(running.pop(int(rng.integers(len(running)))))
        for _ in range(ARRIVALS_PER_TICK):
            g = next(arrivals, None)
            if g is not None:
                pending.append(g)

    with scan_wave_env(wave):
        r = ChurnRescorer(nodes, extra_resources=[GPU], device="cuda")
        r.warm([8])
        depth, rtt = probe_link_depth(r, TICK_INTERVAL)
        window = ADMIT_WINDOW * depth
        r.warm(sorted({8, 16, 32, 64, window}))
        warmed = r.recompiles
        r.clear_stats()
        deadline_misses, loop_s, collected = 0, [], []
        backlog_drained_tick = None
        # the main path: counts zeroed just before, read just after
        zero_counts()
        with TickPipeline(r, depth) as pipe:
            for _ in range(depth):  # pipeline fill: each batch gets an interval
                pipe.submit(pending[:window])
                time.sleep(TICK_INTERVAL)
            for tick_i in range(LOOP_TICKS):
                t0 = time.perf_counter()
                out, tick_groups = pipe.collect()
                pipe.admit_all(out, tick_groups)
                collected.append(out)
                pending = [g for g in pending if g.full_name not in pipe.placed_ever]
                if backlog_drained_tick is None and len(pending) < ADMIT_WINDOW:
                    backlog_drained_tick = tick_i
                churn(r)
                pipe.submit(pending[:window])
                elapsed = time.perf_counter() - t0
                loop_s.append(elapsed)
                if elapsed > TICK_INTERVAL:
                    deadline_misses += 1
                else:
                    time.sleep(TICK_INTERVAL - elapsed)
        launches = read_counts()
        dispatches = depth + LOOP_TICKS
        summary = r.summary()
        # the re-scorer's own series, unrounded (summary() rounds)
        rescorer_ms = {f"rescorer_p50_{name}_ms": statistics.median(series) * 1e3
                       for name, series in (("pack", r.pack_times),
                                            ("dispatch", r.dispatch_times),
                                            ("collect", r.collect_times),
                                            ("tick", r.latencies))}
        rescorer_ms["rescorer_max_tick_ms"] = max(r.latencies) * 1e3
        steady_recompiles = summary["recompiles"] - warmed
        admit_skips = pipe.admit_skips
        pending_final = len(pending)
        running_final = len(r.running)
        # after the loop: every collected tick against the plain path on
        # the CPU, on the snapshot it was scored against
        diffs = {}
        for i, out in enumerate(collected):
            snap = out.snapshot
            want, _ = execute_batch_host(snap.device_args(), snap.progress_args(), device="cpu")
            bad = [k for k in HOST_KEYS if not np.array_equal(out.host[k], want[k])]
            bad += [f"telemetry.{k}" for k in WAVE_TELEMETRY
                    if out.host["telemetry"].get(k) != want["telemetry"].get(k)]
            if out.host["telemetry"]["scan"] != "cuda_kernel":
                bad.append("telemetry.scan")
            if bad:
                diffs[i] = bad
        # one synchronous tick drains the queued deltas: then the resident
        # occupancy is the padded mirror
        saved = read_counts()
        r.tick(None, pending[:window])
        restore_counts(saved)
        torch.cuda.synchronize()
        with r._state_lock:
            resident = r._req_dev.cpu().numpy()
            mirror = r.requested_lanes.copy()
        padded = np.zeros_like(resident)
        padded[:len(mirror)] = mirror
        resident_equal = bool(np.array_equal(resident, padded))

        # report-only: forced depth 2 after a burst of arrivals
        for _ in range(DEPTH2_BURST):
            g = next(arrivals, None)
            if g is not None:
                pending.append(g)
        r.clear_stats()
        saved = read_counts()
        zero_counts()
        d2_loop_s, d2_window = [], 2 * ADMIT_WINDOW
        with TickPipeline(r, 2) as pipe2:
            pipe2.placed_ever |= pipe.placed_ever
            for _ in range(2):
                pipe2.submit(pending[:d2_window])
                time.sleep(TICK_INTERVAL)
            for _ in range(DEPTH2_TICKS):
                t0 = time.perf_counter()
                out, tick_groups = pipe2.collect()
                pipe2.admit_all(out, tick_groups)
                pending = [g for g in pending if g.full_name not in pipe2.placed_ever]
                churn(r)
                pipe2.submit(pending[:d2_window])
                elapsed = time.perf_counter() - t0
                d2_loop_s.append(elapsed)
                time.sleep(max(0.0, TICK_INTERVAL - elapsed))
        d2_launches = read_counts()
        restore_counts(saved)
        d2_summary = r.summary()
    depth2 = {
        "ticks": DEPTH2_TICKS, "burst": DEPTH2_BURST, "window": d2_window,
        "admit_skips": pipe2.admit_skips, "pending_final": len(pending),
        "reupload_fallbacks": d2_summary["reupload_fallbacks"],
        "loop_p50_ms": statistics.median(d2_loop_s) * 1e3,
        "loop_p95_ms": float(np.percentile(d2_loop_s, 95)) * 1e3,
        "loop_max_ms": max(d2_loop_s) * 1e3,
        "launches_by_kernel": d2_launches,
    }
    loop = np.array(loop_s)
    report = {
        "nodes": NORTH_STAR_NODES, "gangs": CHURN_LOOP_GANGS, "backlog": CHURN_LOOP_BACKLOG,
        "admit_window": ADMIT_WINDOW, "interval_s": TICK_INTERVAL, "ticks": LOOP_TICKS,
        "depth": depth, "link_rtt_probe_ms": rtt * 1e3, "window": window,
        "loop_p50_ms": float(np.median(loop)) * 1e3,
        "loop_p95_ms": float(np.percentile(loop, 95)) * 1e3,
        "loop_max_ms": float(loop.max()) * 1e3,
        "deadline_misses": deadline_misses,
        **rescorer_ms,
        "bucket_shapes": summary["bucket_shapes"], "steady_recompiles": steady_recompiles,
        "reupload_fallbacks": summary["reupload_fallbacks"],
        "backlog_drained_tick": backlog_drained_tick, "pending_final": pending_final,
        "running_final": running_final, "admit_skips": admit_skips,
        "launches_by_kernel": launches, "dispatches": dispatches,
        "ticks_equal_plain_cpu": len(collected) - len(diffs), "tick_diffs": diffs,
        "resident_equal_mirror": resident_equal,
        "depth2": depth2,
    }
    if steady_recompiles != 0:
        raise AssertionError(f"{steady_recompiles} new bucket shapes after the warm "
                             f"({summary['bucket_shapes']})")
    if backlog_drained_tick is None or pending_final > ADMIT_WINDOW:
        raise AssertionError(f"backlog not drained: {pending_final} pending (first below "
                             f"the window at tick {backlog_drained_tick})")
    if summary["reupload_fallbacks"] or d2_summary["reupload_fallbacks"]:
        raise AssertionError(f"re-upload fallbacks: {summary['reupload_fallbacks']} in the "
                             f"loop, {d2_summary['reupload_fallbacks']} at depth 2")
    if depth2["pending_final"] > d2_window:
        raise AssertionError(f"depth 2: backlog not drained, {depth2['pending_final']} pending")
    if report["loop_p95_ms"] > TICK_INTERVAL * 1e3 or deadline_misses:
        raise AssertionError(f"p95 loop tick {report['loop_p95_ms']:.3f} ms, "
                             f"{deadline_misses} deadline misses")
    if diffs or len(collected) != LOOP_TICKS:
        raise AssertionError(f"ticks differing from the plain CPU batch: {diffs}")
    if not resident_equal:
        raise AssertionError("the resident occupancy differs from the padded mirror")
    return launches, dispatches, report


@phase("churn_loop")
def churn_loop(results):
    launches, dispatches, report = drive_churn_loop(None)
    if launches["assign_scan"] != dispatches or launches["assign_wave"] != 0 \
            or launches["assign_policy"] != 0 or launches["assign_topk"] != 0:
        raise AssertionError(f"{launches} launches in {dispatches} dispatched ticks "
                             "(want assign_scan once a tick, assign_wave never)")
    if "assign_scan" in results:
        results["assign_scan"]["launches_by_path"]["churn_loop"] = launches["assign_scan"]
    return {**report, "launches": launches["assign_scan"]}


@phase("churn_loop_wave")
def churn_loop_wave(results):
    launches, dispatches, report = drive_churn_loop(8)
    if launches["assign_wave"] != dispatches or launches["assign_scan"] != 0 \
            or launches["assign_policy"] != 0 or launches["assign_topk"] != 0:
        raise AssertionError(f"{launches} launches in {dispatches} dispatched ticks "
                             "(want assign_wave once a tick, assign_scan never)")
    if "assign_wave" in results:
        results["assign_wave"]["launches_by_path"]["churn_loop_wave"] = launches["assign_wave"]
    return {**report, "launches": launches["assign_wave"]}


def mixed_batch(num_nodes, num_groups, seed, per_group, zone_by_position=False):
    """Seeded numpy cluster: 4 node shapes, gangs of 1-64 members (a few
    infeasible), ~30% with a zone selector when ``per_group``.
    ``zone_by_position`` (per-group only) also restricts the gang at scan
    position p to the nodes with ``node % 8 == p % 8``, so the gangs of a
    wave of 8 see disjoint nodes."""
    import numpy as np

    from batch_scheduler_tpu_torch.ops.bucketing import pad_oracle_batch

    rng = np.random.default_rng(seed)
    # lanes: cpu (milli), memory (KiB), ephemeral-storage (KiB), pods, gpu
    shapes = np.array([
        [64000, 256 * 2**20, 100 * 2**20, 110, 8],
        [32000, 128 * 2**20, 50 * 2**20, 110, 0],
        [96000, 384 * 2**20, 200 * 2**20, 250, 4],
        [16000, 64 * 2**20, 20 * 2**20, 64, 0],
    ], dtype=np.int64)
    kind = rng.integers(0, 4, size=num_nodes)
    alloc = shapes[kind]
    requested = (alloc * rng.random((num_nodes, 5)) * 0.6).astype(np.int64)
    requested[rng.random(num_nodes) < 0.5] = 0
    zone = rng.integers(0, 4, size=num_nodes)
    valid = rng.random(num_nodes) > 0.02
    demands = np.array([
        [100, 2**18, 0, 1, 0],      # tiny: a 250-pod node holds >= 127
        [500, 2**20, 2**19, 1, 0],
        [2000, 4 * 2**20, 0, 1, 0],
        [4000, 8 * 2**20, 0, 1, 1],
        [8000, 32 * 2**20, 2**20, 1, 2],
        [200000, 2**20, 0, 1, 0],   # fits no node: infeasible
    ], dtype=np.int64)
    pick = rng.choice(len(demands), size=num_groups, p=[0.2, 0.2, 0.2, 0.2, 0.17, 0.03])
    group_req = demands[pick]
    remaining = rng.integers(1, 65, size=num_groups)
    order = rng.permutation(num_groups)
    if per_group:
        sel = rng.random(num_groups) < 0.3
        want = rng.integers(0, 4, size=num_groups)
        fit = np.where(sel[:, None], zone[None, :] == want[:, None], True) & valid[None, :]
        if zone_by_position:
            position = np.empty(num_groups, np.int64)
            position[order] = np.arange(num_groups)
            fit &= np.arange(num_nodes)[None, :] % 8 == position[:, None] % 8
    else:
        fit = valid[None, :]
    g = num_groups
    return pad_oracle_batch(
        alloc=alloc, requested=requested, group_req=group_req, remaining=remaining,
        fit_mask=fit, group_valid=np.ones(g, bool), order=order,
        min_member=remaining, scheduled=np.zeros(g, np.int32),
        matched=np.zeros(g, np.int32), ineligible=rng.random(g) < 0.1,
        creation_rank=rng.permutation(g),
    )


def check_mixed(num_nodes, num_groups, seed):
    want_leftover = LEFTOVER[(num_nodes, num_groups, seed)][0]
    out = {}
    for mode, per_group in (("per_group", True), ("broadcast", False)):
        batch_args, progress_args = mixed_batch(num_nodes, num_groups, seed, per_group)
        n, r = batch_args[0].shape
        plan = serial_plan(n, r)
        if plan.leftover != want_leftover:
            raise AssertionError(f"serial kernel plan {plan} at N={n}, R={r}: leftover "
                                 f"in {plan.leftover} memory, expected {want_leftover}")
        args = scan_inputs(batch_args)
        err, equal = compare_scan(args)
        with scan_wave_env(None):
            diff, host, dev = host_dicts_equal(batch_args, progress_args)
        g_real = num_groups
        placed = int(host["placed"][:g_real].sum())
        infeasible = int((~host["gang_feasible"][:g_real]).sum())
        loose = int((dev["capacity"] >= 127).sum().item())
        if not equal or diff:
            raise AssertionError(f"{mode}: kernel vs plain max abs err {err}, "
                                 f"host dict fields differing {diff}")
        if not (0 < placed < g_real and infeasible > 0 and loose > 0):
            raise AssertionError(f"{mode}: scenario lost its edges (placed {placed}, "
                                 f"infeasible {infeasible}, cap>=127 cells {loose})")
        out[mode] = {
            "shape": [int(batch_args[2].shape[0]), int(n), int(r)],
            "mask_rows": int(batch_args[4].shape[0]),
            "cluster_blocks": plan.cluster_blocks, "leftover": plan.leftover,
            "kernel_vs_plain_equal": equal, "max_abs_err": err,
            "host_dict_equal": not diff, "placed": placed,
            "infeasible": infeasible, "cap_ge_127_cells": loose,
        }
    return out


@phase("mixed")
def mixed():
    return check_mixed(*MIXED)


def check_big_bucket(num_nodes, num_groups, seed):
    """Both kernels against the plain scans, bit for bit, at a bucket past
    2^20 nodes (more than 64 nodes a thread: the kernels' slabs), in both
    mask modes and on a uniform input (every gang with the first one's
    request row and need, so each wave of 8 takes the uniform branch): the
    serial kernel against the plain serial scan, the wave kernel at W=8
    against the plain serial scan and the plain wavefront. Kernel times
    (3 launches each, in turns) and the plans that ran."""
    import numpy as np

    from batch_scheduler_tpu_torch.ops.assign_scan import assign_gangs_cuda, assign_gangs_plain
    from batch_scheduler_tpu_torch.ops.assign_scan import assign_gangs_wave_cuda

    wave = 8
    out = {}
    for mode, per_group in (("per_group", True), ("broadcast", False), ("uniform", False)):
        batch_args, _ = mixed_batch(num_nodes, num_groups, seed, per_group)
        if mode == "uniform":
            batch_args = list(batch_args)
            batch_args[2] = np.tile(batch_args[2][:1], (len(batch_args[2]), 1))
            batch_args[3] = np.full_like(batch_args[3], batch_args[3][0])
        n, r = batch_args[0].shape
        plans = {"assign_scan": serial_plan(n, r), "assign_wave": wave_plan(n, r)}
        for name, plan in plans.items():
            if plan.per_thread <= 64 or plan.leftover != "global":
                raise AssertionError(f"{mode}: {name} plan {plan} at N={n} does not run slabs")
        args = scan_inputs(batch_args)
        serial = assign_gangs_plain(*args)
        serial_err, serial_equal = compare_scan(args, serial)
        err, equal, conflicts, megas = compare_wave(args, wave, serial)
        if not (serial_equal and equal):
            raise AssertionError(f"{mode}: serial kernel max abs err {serial_err} (equal "
                                 f"{serial_equal}), wave kernel max abs err {err} (equal "
                                 f"{equal})")
        if mode == "uniform" and not megas.all():
            raise AssertionError(f"uniform input: waves {megas.tolist()} not all uniform")
        serial_ms = [cuda_ms(lambda: assign_gangs_cuda(*args), 3)]
        wave_ms = [cuda_ms(lambda: assign_gangs_wave_cuda(*args, wave), 3)]
        wave_ms.append(cuda_ms(lambda: assign_gangs_wave_cuda(*args, wave), 3))
        serial_ms.append(cuda_ms(lambda: assign_gangs_cuda(*args), 3))
        out[mode] = {
            "shape": [int(batch_args[2].shape[0]), int(n), int(r)],
            "mask_rows": int(batch_args[4].shape[0]),
            "plans": {k: v._asdict() for k, v in plans.items()},
            "serial_kernel_vs_plain_equal": serial_equal, "serial_max_abs_err": serial_err,
            "wave_kernel_vs_plain_equal": equal, "wave_max_abs_err": err,
            "waves": len(conflicts), "demoted": int(conflicts.sum()),
            "uniform": int(megas.sum()),
            "placed": int(serial[1].sum().item()),
            "serial_kernel_ms": serial_ms, "wave_kernel_ms": wave_ms,
        }
        del args, serial
    return out


@phase("global_leftover")
def global_leftover():
    return {"bucket_16384": check_mixed(*GLOBAL_LEFTOVER),
            "bucket_262144": check_mixed(*SERIAL_GLOBAL),
            "bucket_2097152": check_big_bucket(*BIG_BUCKET)}


@phase("mixed_wave")
def mixed_wave(results):
    """The mixed and both global_leftover inputs at W=8 and W=32 in both
    mask modes, and the zone-by-position per-group input at W=8: the wave
    kernel against the plain serial scan and the plain wavefront, the cuda
    host dict (with the wave telemetry) against the CPU one, and both
    kernels' times on each input, in turns. Each branch must be taken at
    least once across the phase."""
    from batch_scheduler_tpu_torch.ops.assign_scan import (
        assign_gangs_cuda, assign_gangs_plain, assign_gangs_wave_cuda)

    inputs = []
    for name, cell in (("mixed", MIXED), ("global_leftover", GLOBAL_LEFTOVER),
                       ("global_leftover_262144", SERIAL_GLOBAL)):
        for mode, per_group in (("per_group", True), ("broadcast", False)):
            inputs.append((f"{name}/{mode}", mixed_batch(*cell, per_group), (8, 32),
                           LEFTOVER[cell][1]))
    inputs.append(("mixed/zone_by_position",
                   mixed_batch(*MIXED, True, zone_by_position=True), (8,), LEFTOVER[MIXED][1]))
    branches = {"uniform_commit": 0, "speculative_commit": 0, "demoted": 0}
    runs = []
    matched = True
    for label, (batch_args, progress_args), waves, want_leftover in inputs:
        n, r = batch_args[0].shape
        plan = wave_plan(n, r)
        if plan.leftover != want_leftover:
            raise AssertionError(f"{label}: wave plan {plan} keeps the leftover in "
                                 f"{plan.leftover} memory, expected {want_leftover}")
        args = scan_inputs(batch_args)
        serial = assign_gangs_plain(*args)
        serial_err, serial_equal = compare_scan(args, serial)
        if not serial_equal:
            raise AssertionError(f"{label}: serial kernel disagrees with the plain scan "
                                 f"(max abs err {serial_err})")
        for wave in waves:
            err, equal, conflicts, megas = compare_wave(args, wave, serial)
            with scan_wave_env(wave):
                diff, host, _ = host_dicts_equal(batch_args, progress_args)
            tele = host["telemetry"]
            counts = {"uniform_commit": int((megas & ~conflicts).sum()),
                      "speculative_commit": int((~megas & ~conflicts).sum()),
                      "demoted": int(conflicts.sum())}
            want_tele = {"wave_width": wave, "waves_per_batch": len(conflicts),
                         "wave_demotions": counts["demoted"], "wave_uniform": int(megas.sum())}
            got_tele = {k: tele.get(k) for k in want_tele}
            if not equal or diff or got_tele != want_tele:
                raise AssertionError(f"{label} W={wave}: kernel vs plain max abs err {err} "
                                     f"(equal {equal}), host dict fields differing {diff}, "
                                     f"telemetry {got_tele} != {want_tele}")
            # both kernels on the same inputs, in turns: serial, wave, wave, serial
            serial_ms = [cuda_ms(lambda: assign_gangs_cuda(*args), 3)]
            wave_ms = [cuda_ms(lambda: assign_gangs_wave_cuda(*args, wave), 3)]
            wave_ms.append(cuda_ms(lambda: assign_gangs_wave_cuda(*args, wave), 3))
            serial_ms.append(cuda_ms(lambda: assign_gangs_cuda(*args), 3))
            for k, v in counts.items():
                branches[k] += v
            matched &= equal
            runs.append({
                "input": label, "wave": wave,
                "shape": [int(batch_args[2].shape[0]), int(n), int(r)],
                "mask_rows": int(batch_args[4].shape[0]),
                "cluster_blocks": plan.cluster_blocks, "leftover": plan.leftover,
                "kernel_vs_plain_equal": equal, "max_abs_err": err,
                "serial_kernel_vs_plain_equal": serial_equal,
                "host_dict_equal": not diff, "waves": len(conflicts), **counts,
                "placed": int(host["placed"].sum()),
                "wave_kernel_ms": wave_ms, "serial_kernel_ms": serial_ms,
            })
    missing = [k for k, v in branches.items() if v == 0]
    if missing:
        raise AssertionError(f"branches never taken across the phase: {missing}")
    if "assign_wave" in results:
        results["assign_wave"]["matched"] &= matched
    return {"runs": runs, "branches": branches}


def drive_race(wave):
    """The README race scenario through ScheduleOperation on cuda with
    ``BST_SCAN_WAVE`` set to ``wave`` (None: unset): gang 1 permits all five
    pods, gang 2 is denied and its retry hits the deny backoff. Both scan
    kernels' launch counts are zeroed just before the path and read just
    after. Returns (operation, launches by kernel, report)."""
    from batch_scheduler_tpu_torch.api.types import PodGroupPhase
    from batch_scheduler_tpu_torch.cache import PGStatusCache, PodGroupMatchStatus
    from batch_scheduler_tpu_torch.core import ScheduleOperation
    from batch_scheduler_tpu_torch.sim.scenarios import make_member_pods, race_scenario
    from batch_scheduler_tpu_torch.utils import errors as errs

    nodes, groups, pods = race_scenario()
    cluster = InMemoryCluster(nodes)
    sys_pod = make_member_pods("sys", 1, {"cpu": "900m"})[0]
    sys_pod.metadata.labels = {}  # 0.9 cpu of system pods, no gang
    cluster.bind(sys_pod, "node-1")
    cache = PGStatusCache()
    for pg in groups:
        pg.status.phase = PodGroupPhase.PENDING
        cache.set(pg.full_name(), PodGroupMatchStatus(pg))
    op = ScheduleOperation(cache, cluster, scorer="oracle")  # default device: cuda
    if op.oracle.device.type != "cuda":
        raise AssertionError(f"scorer on {op.oracle.device}")
    with scan_wave_env(wave):
        # this path's counts: zeroed just before, read just after
        zero_counts()
        ready = []
        for pod in pods["web-group-race1"]:
            op.pre_filter(pod)
            op.filter(pod, "node-1")
            ready.append(op.permit(pod, "node-1").ready)
        for pod in pods["web-group-race1"]:
            cluster.bind(pod, "node-1")
            op.post_bind(pod, "node-1")
        pg1 = cache.get("default/web-group-race1").pod_group
        outcomes = []
        for pod in pods["web-group-race2"][:2]:
            try:
                op.pre_filter(pod)
                outcomes.append("admitted")
            except errs.SchedulingError as e:
                outcomes.append(type(e).__name__)
        launches = read_counts()
    batches = op.oracle.batches_run
    want = ["ResourceNotEnoughError", "DeniedError"]
    if ready != [False] * 4 + [True] or pg1.status.scheduled != 5 or outcomes != want:
        raise AssertionError(f"race: ready {ready}, gang 1 scheduled "
                             f"{pg1.status.scheduled}, gang 2 {outcomes}")
    return op, launches, {
        "gang1_ready": ready, "gang1_phase": pg1.status.phase.value,
        "gang2": outcomes, "batches": batches, "launches_by_kernel": launches,
        "shape": list(op.oracle.snapshot.shape),
        "telemetry": dict(op.oracle.last_telemetry),
    }


@phase("race")
def race(results):
    op, launches, report = drive_race(None)
    batches = report["batches"]
    if launches["assign_scan"] == 0 or launches["assign_scan"] != batches \
            or launches["assign_wave"] != 0 \
            or launches["assign_policy"] != 0 or launches["assign_topk"] != 0:
        raise AssertionError(f"{launches} launches in {batches} batches "
                             "(want assign_scan once per batch, assign_wave never)")
    args = scan_inputs(op.oracle.snapshot.device_args())
    plan = serial_plan(*args[0].shape)
    if plan.cluster_blocks != 1:
        raise AssertionError(f"race plan {plan}: the 8-node bucket is one block")
    err, equal = compare_scan(args)
    if not equal:
        raise AssertionError(f"kernel disagrees with the plain scan (max abs err {err})")
    if "assign_scan" in results:
        results["assign_scan"]["launches_by_path"]["race"] = launches["assign_scan"]
    return {**report, "launches": launches["assign_scan"], "plan": plan._asdict(),
            "kernel_vs_plain_equal": equal, "max_abs_err": err}


@phase("race_wave")
def race_wave(results):
    wave = 32  # pads the 8-group bucket to one wave of 32
    op, launches, report = drive_race(wave)
    batches = report["batches"]
    if launches["assign_wave"] == 0 or launches["assign_wave"] != batches \
            or launches["assign_scan"] != 0 \
            or launches["assign_policy"] != 0 or launches["assign_topk"] != 0:
        raise AssertionError(f"{launches} launches in {batches} batches "
                             "(want assign_wave once per batch, assign_scan never)")
    tele = report["telemetry"]
    if tele.get("wave_width") != wave or tele.get("waves_per_batch") != 1:
        raise AssertionError(f"race_wave telemetry {tele}")
    err, equal, _, _ = compare_wave(scan_inputs(op.oracle.snapshot.device_args()), wave)
    if not equal:
        raise AssertionError(f"wave kernel disagrees with the plain scans (max abs err {err})")
    if "assign_wave" in results:
        results["assign_wave"]["launches_by_path"]["race_wave"] = launches["assign_wave"]
        results["assign_wave"]["matched"] &= equal
    return {**report, "launches": launches["assign_wave"],
            "kernel_vs_plain_equal": equal, "max_abs_err": err}


# -- the policy engine ------------------------------------------------------
# The north-star deployment with policy labels (policy_state): the nodes
# carry a zone (8 values), a pool (4), a rack (16) and a team (3), so all 4
# label-hash lanes are full; ~30% of the gangs prefer a pool (affinity), ~10%
# avoid one (anti-affinity), ~30% spread over zones, and 100 of the spread
# gangs have 3 of their 10 members matched already (assumed on nodes).
POLICY_ENV = {"BST_POLICY": "affinity,anti-affinity,spread,preempt"}
POLICY_TERMS = ("affinity", "anti-affinity", "spread")
POLICY_WEIGHTS = (32, 8, 3)  # PolicyConfig's defaults
POLICY_SEED = 8
POLICY_SPREAD_MATCHED, POLICY_MATCHED_MEMBERS = 100, 3
POLICY_ROUNDS = 6  # churn rounds after the keyframe refresh (Churn's rounds)
# plan_victims at the size a planner meets in a full north-star cluster
VICTIMS, VICTIM_NODES, VICTIM_LANES = 512, 8192, 5


def policy_state():
    """The policy deployment (see above) in a ClusterState and a status
    cache, from POLICY_SEED: nodes as north_star_cluster's plus labels,
    gangs as its gangs plus the policy labels on their representative pods;
    the matched members of the spread gangs are assumed on random nodes and
    recorded in the gangs' matched sets (their domain occupancy)."""
    import numpy as np

    from batch_scheduler_tpu_torch.api.types import PodGroupPhase
    from batch_scheduler_tpu_torch.cache import PGStatusCache, PodGroupMatchStatus
    from batch_scheduler_tpu_torch.cache.pg_cache import PodNodePair
    from batch_scheduler_tpu_torch.framework import ClusterState
    from batch_scheduler_tpu_torch.sim.scenarios import (
        make_member_pods, make_sim_group, make_sim_node)
    from batch_scheduler_tpu_torch.utils.labels import (
        POLICY_AFFINITY_LABEL, POLICY_ANTI_AFFINITY_LABEL, POLICY_SPREAD_LABEL)

    rng = np.random.default_rng(POLICY_SEED)
    n, g = NORTH_STAR_NODES, NORTH_STAR_GANGS
    zone, pool = rng.integers(0, 8, n), rng.integers(0, 4, n)
    rack, team = rng.integers(0, 16, n), rng.integers(0, 3, n)
    cluster = ClusterState()
    names = []
    for i in range(n):
        names.append(f"n{i:05d}")
        cluster.add_node(make_sim_node(
            names[-1], {"cpu": "64", "memory": "256Gi", "pods": "110", GPU: "8"},
            labels={"zone": f"z{zone[i]}", "pool": f"p{pool[i]}", "rack": f"r{rack[i]}",
                    "team": f"t{team[i]}"}))
    want_aff, want_anti = rng.random(g) < 0.3, rng.random(g) < 0.1
    want_spread = rng.random(g) < 0.3
    aff_pool, anti_pool = rng.integers(0, 4, g), rng.integers(0, 4, g)
    cache = PGStatusCache()
    spread = []
    for k in range(g):
        name = f"gang-{k:04d}"
        pg = make_sim_group(name, 10, creation_ts=float(k))
        pg.spec.min_resources = {"cpu": 4000, "memory": 8 * 1024**3, GPU: 1}
        pg.status.phase = PodGroupPhase.PENDING
        pgs = PodGroupMatchStatus(pg)
        pgs.pod = make_member_pods(name, 1, {"cpu": "4", "memory": "8Gi", GPU: "1"})[0]
        labels = pgs.pod.metadata.labels
        if want_aff[k]:
            labels[POLICY_AFFINITY_LABEL] = f"pool:p{aff_pool[k]}"
        if want_anti[k]:
            labels[POLICY_ANTI_AFFINITY_LABEL] = f"pool:p{anti_pool[k]}"
        if want_spread[k]:
            labels[POLICY_SPREAD_LABEL] = "1"
            spread.append(pgs)
        cache.set(pg.full_name(), pgs)
    for pgs in spread[:POLICY_SPREAD_MATCHED]:
        name = pgs.pod_group.metadata.name
        members = make_member_pods(name, POLICY_MATCHED_MEMBERS,
                                   {"cpu": "4", "memory": "8Gi", GPU: "1"})
        for m in members:
            node = names[int(rng.integers(n))]
            cluster.assume(m, node)
            pgs.matched_pod_nodes.set(m.metadata.uid, PodNodePair(
                f"default/{m.metadata.name}", node), 3600.0)
    return cluster, cache


def policy_full_pack_diff(scorer, cluster, cache):
    """full_pack_diff for a policy scorer: one ClusterSnapshot of the whole
    state with the scorer's engine, run as one policy batch on the card
    (launches restored), against the scorer's last batch: the host dict,
    the scan telemetry, all seven batch args and the six policy columns
    the batch ran on (the holder's resident node columns read back)."""
    import numpy as np

    from batch_scheduler_tpu_torch.core.oracle_scorer import read_cluster_inputs
    from batch_scheduler_tpu_torch.ops.oracle import execute_batch_host
    from batch_scheduler_tpu_torch.ops.snapshot import ClusterSnapshot

    saved = read_counts()
    snap = ClusterSnapshot(*read_cluster_inputs(cluster, cache),
                           policy_engine=scorer.policy_engine)
    want, _ = execute_batch_host(snap.device_args(), snap.progress_args(), device="cuda",
                                 policy=snap.policy_payload())
    restore_counts(saved)
    got = scorer._state.result
    diff = [k for k in HOST_KEYS if not np.array_equal(got[k], want[k])]
    diff += [f"telemetry.{k}" for k in ("scan", "wave_width", "scan_policy")
             if got["telemetry"].get(k) != want["telemetry"].get(k)]
    host = lambda a: a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)  # noqa: E731
    diff += [f"batch arg {i}" for i, (a, h) in enumerate(
        zip(scorer._device_state.last_args(), snap.device_args()))
        if not np.array_equal(host(a), h)]
    holder = scorer._device_state
    ran_cols = scorer.snapshot.policy_cols[:4] + (holder._policy_hash, holder._policy_dom)
    diff += [f"policy column {i}" for i, (a, h) in enumerate(zip(ran_cols, snap.policy_cols))
             if not np.array_equal(host(a), h)]
    return diff


def policy_cols_cuda(snap):
    """A snapshot's six policy columns as CUDA tensors."""
    from batch_scheduler_tpu_torch.ops.convert import policy_from_numpy

    return policy_from_numpy(snap.policy_cols, "cuda")


def drive_policy(wave):
    """The policy deployment through a ScheduleOperation's OracleScorer on
    cuda with POLICY_ENV (every term, the default weights; the engine from
    BST_POLICY) and BST_SCAN_WAVE set to ``wave`` (None: unset): a first
    (keyframe) refresh and POLICY_ROUNDS churn rounds (Churn), each followed
    by one refresh; every kernel's count zeroed just before the refreshes
    and read just after. After every refresh the scorer must equal the full
    pack (policy_full_pack_diff); every gang must place. Then one profiled
    refresh. Returns (scorer, launches, plan digests a refresh, report)."""
    import torch

    from batch_scheduler_tpu_torch.core import ScheduleOperation
    from batch_scheduler_tpu_torch.utils import audit as audit_mod

    with env_set({**POLICY_ENV, "BST_SCAN_WAVE": None if wave is None else str(wave)}):
        cluster, cache = policy_state()
        op = ScheduleOperation(cache, cluster, device="cuda")
        scorer = op.oracle
        if op.policy is None or op.preempt_planner is None or \
                op.policy.config.scoring_terms != POLICY_TERMS or \
                op.policy.config.weights != POLICY_WEIGHTS:
            raise AssertionError(f"policy engine from {POLICY_ENV}: {op.policy}")
        churn = Churn(cluster, cache, lambda name: scorer.mark_dirty(group=name),
                      POLICY_ROUNDS + 1)
        refresh_s, digests = [], []
        zero_counts()
        for r in range(POLICY_ROUNDS + 1):
            if r:
                churn(r)
            t0 = time.perf_counter()
            scorer.refresh(cluster, cache)
            torch.cuda.synchronize()
            refresh_s.append(time.perf_counter() - t0)
            digests.append(audit_mod.plan_digest(scorer._state.result))
            diff = policy_full_pack_diff(scorer, cluster, cache)
            if diff:
                raise AssertionError(f"refresh {r}: the policy scorer differs from the full "
                                     f"pack in {diff}")
        launches = read_counts()
        telemetry = dict(scorer.last_telemetry)
        stats = scorer.stats()
        try:
            prof = profile_refresh(scorer, cluster, cache)
        except Exception as e:  # noqa: BLE001 — a measurement, not a check
            prof = {"profile": f"failed: {e!r}"[:300]}
    # every gang placed, with every member it still needed
    snap = scorer.snapshot
    names = sorted(cache.snapshot())
    placed = sum(scorer.placed(n) for n in names)
    feasible = sum(scorer.gang_feasible(n) for n in names)
    members = sum(sum(scorer.assignment(n).values()) for n in names)
    want = (NORTH_STAR_GANGS, NORTH_STAR_GANGS, int(snap.remaining.sum()))
    if (placed, feasible, members) != want:
        raise AssertionError(f"placed {placed}, feasible {feasible}, members {members} "
                             f"(want {want})")
    if snap.shape != NORTH_STAR_SHAPE or telemetry.get("scan_policy") is not True \
            or telemetry.get("wave_width") != 0:
        raise AssertionError(f"shape {snap.shape}, telemetry {telemetry}")
    aff, anti, gang_dom, node_hash = snap.policy_cols[1:5]
    columns = {"affinity_gangs": int((aff > 0).sum()), "anti_gangs": int((anti > 0).sum()),
               "spread_occupied_gangs": int((gang_dom.sum(axis=1) > 0).sum()),
               "full_hash_lanes_nodes": int((node_hash[:NORTH_STAR_NODES] > 0).all(axis=1).sum())}
    if columns["spread_occupied_gangs"] != POLICY_SPREAD_MATCHED or \
            columns["full_hash_lanes_nodes"] != NORTH_STAR_NODES:
        raise AssertionError(f"policy columns {columns}")
    timed = slice(2, None)  # the keyframe and one warm refresh
    med = lambda xs: statistics.median(xs[timed]) * 1e3  # noqa: E731
    refresh_ms_median = med(refresh_s)
    if "device_busy_ms" in prof:
        prof["device_idle_share_vs_median"] = 1 - prof["device_busy_ms"] / refresh_ms_median
    report = {
        "shape": list(snap.shape), "refreshes": len(refresh_s), "launches_by_kernel": launches,
        "placed": placed, "feasible": feasible, "members_placed": members,
        "columns": columns, "telemetry": telemetry,
        "keyframe_refresh_ms": refresh_s[0] * 1e3,
        "refresh_ms_median": refresh_ms_median,
        "refresh_ms": [t * 1e3 for t in refresh_s[timed]],
        "host_pack_ms_median": med(scorer.pack_seconds),
        "sync_ms_median": med(scorer.sync_seconds),
        "device_batch_ms_median": med(scorer.batch_seconds),
        "fold_outcomes": stats["fold_outcomes"], "packer": stats["packer"],
        "device_state": stats["device_state"],
        "batches_scored": op.policy.batches_scored,
        **prof,
    }
    return scorer, launches, digests, report


@phase("policy")
def policy(results):
    """The policy path at the north star (drive_policy, BST_SCAN_WAVE
    unset): the policy kernel once a refresh and no other kernel; then the
    kernel against the plain policy scan on the last batch's CUDA inputs,
    its time beside the base serial kernel's on the same inputs (in
    turns: base, policy, policy, base), the plain scan's time and the
    bound."""
    from batch_scheduler_tpu_torch.ops.assign_scan import (
        assign_gangs_cuda, assign_gangs_policy_cuda, policy_scan_plan)
    from batch_scheduler_tpu_torch.ops.oracle import assign_gangs_policy

    scorer, launches, digests, report = drive_policy(None)
    n = report["refreshes"]
    if launches != only(assign_policy=n):
        raise AssertionError(f"{launches} launches in {n} refreshes (want assign_policy once "
                             "a refresh and no other kernel)")
    args = scan_inputs(scorer.snapshot.device_args())
    cols = policy_cols_cuda(scorer.snapshot)
    plan = policy_scan_plan(*args[0].shape, 0)
    got = assign_gangs_policy_cuda(*args, *cols, POLICY_TERMS, POLICY_WEIGHTS)
    want = assign_gangs_policy(*args, *cols, POLICY_TERMS, POLICY_WEIGHTS)
    err, equal = max_err(got, want)
    if not equal:
        raise AssertionError(f"policy kernel disagrees with the plain policy scan "
                             f"(max abs err {err})")
    run = lambda: assign_gangs_policy_cuda(*args, *cols, POLICY_TERMS, POLICY_WEIGHTS)  # noqa: E731
    base_ms = [cuda_ms(lambda: assign_gangs_cuda(*args), 20)]
    policy_ms = [cuda_ms(run, 20), cuda_ms(run, 20)]
    base_ms.append(cuda_ms(lambda: assign_gangs_cuda(*args), 20))
    plain_ms = cuda_ms(lambda: assign_gangs_policy(*args, *cols, POLICY_TERMS,
                                                   POLICY_WEIGHTS), 1)
    from batch_scheduler_tpu_torch.ops.bounds import policy_bound

    bound_ms, bound_by, nbytes, ops = policy_bound(args)
    ms = min(policy_ms)
    results["assign_policy"] = {
        "launches": launches["assign_policy"],
        "launches_by_path": {"policy": launches["assign_policy"]},
        "max_abs_err": err, "matched": equal,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "cluster_blocks": plan.cluster_blocks, "leftover": plan.leftover,
        "us_per_gang": ms * 1e3 / args[1].shape[0],
    }
    results["policy_digests"] = digests
    return {**report, "launches": launches["assign_policy"], "plan": plan._asdict(),
            "kernel_ms": policy_ms, "base_kernel_ms_same_inputs": base_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": nbytes, "int_ops": ops, "kernel_vs_plain_equal": equal,
            "max_abs_err": err, "plan_digests": digests}


@phase("policy_wave")
def policy_wave(results):
    """The policy path with BST_SCAN_WAVE=8: the batch ignores the wave
    width, so the policy kernel runs once a refresh and the wave kernel
    never; the telemetry says so, and every refresh's plan equals the
    policy phase's (its plan_digest sequence)."""
    scorer, launches, digests, report = drive_policy(8)
    n = report["refreshes"]
    if launches != only(assign_policy=n):
        raise AssertionError(f"{launches} launches in {n} refreshes with BST_SCAN_WAVE=8 "
                             "(want assign_policy once a refresh, assign_wave never)")
    if "policy_digests" in results and digests != results["policy_digests"]:
        raise AssertionError("the plans differ from the policy phase's")
    if "assign_policy" in results:
        results["assign_policy"]["launches_by_path"]["policy_wave"] = launches["assign_policy"]
    return {**report, "launches": launches["assign_policy"],
            "same_plans_as_policy": "policy_digests" in results}


@phase("policy_identity")
def policy_identity(results):
    """The zero-policy identity on the card: the policy kernel with every
    term on and all-zero columns, and with real columns and no term,
    equals the base serial kernel bit for bit, on the north star's scan
    inputs and on mixed's in both mask modes. And the policy kernel
    against the plain policy scan on mixed's inputs with seeded policy
    columns in both mask modes, and at the 2^21-node bucket (its slabs)."""
    import numpy as np
    import torch

    from batch_scheduler_tpu_torch.ops.assign_scan import (
        assign_gangs_cuda, assign_gangs_policy_cuda, policy_scan_plan)
    from batch_scheduler_tpu_torch.ops.oracle import assign_gangs_policy
    from batch_scheduler_tpu_torch.ops.snapshot import ClusterSnapshot
    from batch_scheduler_tpu_torch.policy import PolicyConfig, PolicyEngine
    from batch_scheduler_tpu_torch.core.oracle_scorer import read_cluster_inputs

    def seeded_cols(rng, n, g):
        vocab = np.array([0, 11, 22, 33, 44, 55], np.int64)
        cols = (rng.integers(0, 3, g),
                np.where(rng.random(g) < 0.3, vocab[rng.integers(1, 6, g)], 0),
                np.where(rng.random(g) < 0.1, vocab[rng.integers(1, 6, g)], 0),
                rng.integers(0, 4, (g, 16)) * (rng.random((g, 1)) < 0.3),
                vocab[rng.integers(0, 6, (n, 4))], rng.integers(-1, 18, n))
        return tuple(torch.from_numpy(np.ascontiguousarray(c, np.int32)).cuda() for c in cols)

    cluster, cache = policy_state()
    engine = PolicyEngine(PolicyConfig(terms=POLICY_TERMS))
    snap = ClusterSnapshot(*read_cluster_inputs(cluster, cache), policy_engine=engine)
    inputs = [("north_star", scan_inputs(snap.device_args()), policy_cols_cuda(snap))]
    rng = np.random.default_rng(POLICY_SEED)
    for mode, per_group in (("per_group", True), ("broadcast", False)):
        args = scan_inputs(mixed_batch(*MIXED, per_group)[0])
        inputs.append((f"mixed/{mode}", args,
                       seeded_cols(rng, args[0].shape[0], args[1].shape[0])))
    out = {}
    for label, args, cols in inputs:
        base = assign_gangs_cuda(*args)
        zero = tuple(torch.zeros_like(c) for c in cols)
        checks = {"zero_columns": assign_gangs_policy_cuda(*args, *zero, POLICY_TERMS,
                                                            POLICY_WEIGHTS),
                  "no_term": assign_gangs_policy_cuda(*args, *cols, (), POLICY_WEIGHTS)}
        res = {k: max_err(v, base) for k, v in checks.items()}
        if not all(eq for _, eq in res.values()):
            raise AssertionError(f"{label}: the zero-policy identity fails: {res}")
        out[label] = {f"{k}_equal_base": eq for k, (_, eq) in res.items()}
        if label.startswith("mixed"):
            got = assign_gangs_policy_cuda(*args, *cols, POLICY_TERMS, POLICY_WEIGHTS)
            want = assign_gangs_policy(*args, *cols, POLICY_TERMS, POLICY_WEIGHTS)
            err, equal = max_err(got, want)
            if not equal:
                raise AssertionError(f"{label}: policy kernel vs plain max abs err {err}")
            out[label].update(kernel_vs_plain_equal=equal, max_abs_err=err,
                              placed=int(got[1].sum().item()),
                              mask_rows=int(args[3].shape[0]))
    big = {}
    for mode, per_group in (("per_group", True), ("broadcast", False)):
        args = scan_inputs(mixed_batch(*BIG_BUCKET, per_group)[0])
        plan = policy_scan_plan(*args[0].shape, 0)
        if plan.per_thread <= 64 or plan.leftover != "global":
            raise AssertionError(f"2^21 bucket: policy plan {plan} does not run slabs")
        cols = seeded_cols(rng, args[0].shape[0], args[1].shape[0])
        got = assign_gangs_policy_cuda(*args, *cols, POLICY_TERMS, POLICY_WEIGHTS)
        want = assign_gangs_policy(*args, *cols, POLICY_TERMS, POLICY_WEIGHTS)
        err, equal = max_err(got, want)
        if not equal:
            raise AssertionError(f"2^21 {mode}: policy kernel vs plain max abs err {err}")
        big[mode] = {"plan": plan._asdict(), "kernel_vs_plain_equal": equal,
                     "max_abs_err": err, "placed": int(got[1].sum().item()),
                     "kernel_ms": cuda_ms(lambda: assign_gangs_policy_cuda(
                         *args, *cols, POLICY_TERMS, POLICY_WEIGHTS), 3)}
        del args, cols, got, want
    out["bucket_2097152"] = big
    return out


def preemption_path():
    """spot_vs_guaranteed_scenario through a ScheduleOperation on cuda with
    the "preempt" term: the spot gangs placed and bound (PreFilter, Permit,
    assume, bind on their batch plans) fill the cluster; the guaranteed
    gang is denied at PreFilter; preempt_victim_plan (plan_victims on the
    card) gives a plan that the planner verifies against the live cluster;
    then the framework's commit steps in its order (every victim member
    removed from the ClusterState, note_gang_evicted, forget_denied, a
    blind mark) and PreFilter again places the guaranteed gang."""
    from batch_scheduler_tpu_torch.api.types import PodGroupPhase
    from batch_scheduler_tpu_torch.cache import PGStatusCache, PodGroupMatchStatus
    from batch_scheduler_tpu_torch.core import ScheduleOperation
    from batch_scheduler_tpu_torch.framework import ClusterState
    from batch_scheduler_tpu_torch.policy import PolicyConfig
    from batch_scheduler_tpu_torch.sim.scenarios import spot_vs_guaranteed_scenario
    from batch_scheduler_tpu_torch.utils import errors as errs
    from batch_scheduler_tpu_torch.utils.labels import POD_GROUP_LABEL

    nodes, groups, pods = spot_vs_guaranteed_scenario()
    cluster = ClusterState()
    for node in nodes:
        cluster.add_node(node)
    cache = PGStatusCache()
    for pg in groups:
        pg.status.phase = PodGroupPhase.PENDING
        cache.set(pg.full_name(), PodGroupMatchStatus(pg))
    op = ScheduleOperation(cache, cluster, device="cuda",
                           policy=PolicyConfig(terms=("preempt",)))
    if op.preempt_planner is None or op.preempt_planner.device.type != "cuda":
        raise AssertionError("no preemption planner on cuda")

    def admit(gang_pods):
        op.pre_filter(gang_pods[0])
        pgs = cache.get(f"default/{gang_pods[0].metadata.labels[POD_GROUP_LABEL]}")
        seats = [node for node, count in sorted(pgs.placement_plan.items())
                 for _ in range(count)]
        for pod, node in zip(gang_pods, seats):
            op.pre_filter(pod)
            op.permit(pod, node)
            cluster.assume(pod, node)
        for pod, node in zip(gang_pods, seats):
            pod.spec.node_name = node
            cluster.observe_pod(pod)
            op.post_bind(pod, node)

    for name in sorted(pods):
        if name.startswith("spot"):
            admit(pods[name])
    spot_bound = {n: len(cluster.pods_on(n)) for n in ("node-000", "node-001")}
    guaranteed = pods["guaranteed-000"]
    try:
        op.pre_filter(guaranteed[0])
        denied = None
    except errs.SchedulingError as e:
        denied = type(e).__name__
    t0 = time.perf_counter()
    plan = op.preempt_victim_plan(guaranteed[0])
    plan_s = time.perf_counter() - t0
    if plan is None:
        raise AssertionError("no victim plan for the guaranteed gang")
    verified = op.preempt_planner.verify(plan, guaranteed[0], cluster)
    for victim_gang in plan.gangs:
        for victim in plan.pods_by_gang[victim_gang]:
            cluster.remove_pod(victim)
        op.note_gang_evicted(victim_gang)
    op.forget_denied("default/guaranteed-000")
    op.mark_dirty()
    op.pre_filter(guaranteed[0])
    placed = op.oracle.placed("default/guaranteed-000")
    seats = sum(op.oracle.assignment("default/guaranteed-000").values())
    out = {"spot_pods_bound": spot_bound, "guaranteed_denied": denied,
           "victims": list(plan.gangs), "evicted_pods": plan.evicted_pods,
           "pooled_after": plan.pooled_after, "verified": verified,
           "guaranteed_placed": placed, "guaranteed_seats": seats,
           "preempt_victim_plan_ms": plan_s * 1e3,
           "plans": (op.policy.preempt_plans, op.policy.preempt_no_plan)}
    # the CPU test (tests/test_torch_preempt.py) holds these victims to the
    # JAX planner's on the same scenario
    if (spot_bound != {"node-000": 4, "node-001": 4} or denied != "ResourceNotEnoughError"
            or not verified or not placed or seats != 4
            or plan.gangs != ["default/spot-000"]):
        raise AssertionError(f"preemption path: {out}")
    return out


def victim_inputs(seed):
    """plan_victims' inputs at VICTIMS victims over VICTIM_NODES nodes and
    VICTIM_LANES lanes (seeded numpy): a full cluster's leftover, each
    victim gang on 1-16 nodes with 1-4 members each, tiers 0-9 against a
    preemptor of tier 5, the greedy order the planner computes."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n, v, r = VICTIM_NODES, VICTIMS, VICTIM_LANES
    # lanes: cpu (milli; 0-2 cpus left), memory, pods, gpu, one unrequested
    left = np.zeros((n, r), np.int32)
    left[:, 0] = rng.integers(0, 3, n) * 1000
    left[:, 1], left[:, 2], left[:, 3] = 2**20, 100, 8
    fit = (rng.random(n) < 0.95).astype(np.int32)
    req = np.array([4000, 8000, 1, 1, 0], np.int32)
    valloc = np.zeros((v, n), np.int32)
    for i in range(v):
        where = rng.integers(0, n, rng.integers(1, 17))
        valloc[i, where] = rng.integers(1, 5, len(where))
    vreq = np.tile(np.array([[2000, 4000, 1, 1, 0]], np.int32), (v, 1))
    vreq[:, 0] *= rng.integers(1, 4, v).astype(np.int32)
    vprio = rng.integers(0, 10, v).astype(np.int32)
    vvalid = np.ones(v, np.int32)
    order = np.array(sorted(range(v), key=lambda i: (-vvalid[i], int(vprio[i]),
                                                     int(valloc[i].sum()), i)), np.int32)
    return left, fit, req, 400, 5, valloc, vreq, vprio, vvalid, order


@phase("preemption")
def preemption(results):
    """The preemption path (preemption_path), and plan_victims (plain
    PyTorch) timed at VICTIMS victims and VICTIM_NODES nodes on the card and
    on the host CPU, the two results held equal (taken set, feasibility,
    pooled capacity after)."""
    import torch

    from batch_scheduler_tpu_torch.policy.preempt import plan_victims

    out = preemption_path()
    arrays = victim_inputs(POLICY_SEED)
    tensors = {dev: [torch.from_numpy(a).to(dev) if hasattr(a, "dtype") else a
                     for a in arrays] for dev in ("cuda", "cpu")}
    got, times = {}, {"cuda": [], "cpu": []}
    for dev, reps in (("cuda", 3), ("cpu", 2)):
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got[dev] = plan_victims(*tensors[dev])
            torch.cuda.synchronize()
            times[dev].append((time.perf_counter() - t0) * 1e3)
    equal = all(torch.equal(a.cpu(), b) for a, b in zip(got["cuda"], got["cpu"]))
    if not equal:
        raise AssertionError("plan_victims on the card differs from the CPU")
    taken = int(got["cuda"][0].sum().item())
    return {**out, "plan_victims": {
        "victims": VICTIMS, "nodes": VICTIM_NODES, "lanes": VICTIM_LANES,
        "taken": taken, "feasible": bool(got["cuda"][1]),
        "pooled_after": int(got["cuda"][2]), "cuda_equal_cpu": equal,
        "cuda_ms": times["cuda"], "cpu_ms": times["cpu"],
        "cuda_ms_min": min(times["cuda"]), "cpu_ms_min": min(times["cpu"])}}


def policy_ring(directory):
    """An audit ring of the policy path on the card: the policy deployment
    through a ScheduleOperation with POLICY_ENV, an ``array`` AuditLog
    (keyframe every 4) and the identity audit on every 4th batch; a first
    refresh and 3 churn rounds. Read back: every record carries the policy
    terms, weights and columns, its inputs equal the batch's; every record
    replays identically on steady (the policy kernel; launches counted) and
    the last on cpu-ladder (the plain policy scan on the CPU). Returns
    (refresh launches, replay launches, report)."""
    import numpy as np

    from batch_scheduler_tpu_torch.core import ScheduleOperation
    from batch_scheduler_tpu_torch.core.oracle_scorer import replay_audit_record
    from batch_scheduler_tpu_torch.utils import audit as audit_mod
    from batch_scheduler_tpu_torch.utils.audit import AuditLog, AuditReader

    with env_set({**POLICY_ENV, "BST_SCAN_WAVE": None}):
        cluster, cache = policy_state()
        log = AuditLog(directory, fmt="array", keyframe_every=4)
        op = ScheduleOperation(cache, cluster, device="cuda", audit_log=log,
                               identity_audit_every=4)
        scorer = op.oracle
        churn = Churn(cluster, cache, lambda name: scorer.mark_dirty(group=name), 4)
        ran, cols = [], []
        zero_counts()
        for r in range(4):
            if r:
                churn(r)
            scorer.refresh(cluster, cache)
            ran.append(ran_input_digest(scorer))
            cols.append(scorer.snapshot.policy_cols)
        launches = read_counts()
        if not scorer._identity.drain(600.0) or not log.flush(120.0):
            raise AssertionError("the identity audit or the audit writer did not finish")
        stats = scorer.stats()["audit"]
        log.stop()
    batches, skipped = AuditReader(directory).batches()
    if skipped or len(batches) != len(ran) or stats["identity_mismatches"] or \
            stats["identity_errors"] or stats["identity_audits"] < 1 or stats["publish_errors"]:
        raise AssertionError(f"policy ring: {len(batches)} of {len(ran)} records, "
                             f"skipped {skipped[:2]}, {stats}")
    for rec, want, want_cols in zip(batches, ran, cols):
        arrays = dict(zip(audit_mod.BATCH_ARG_NAMES, rec["batch_args"]))
        arrays.update(zip(audit_mod.PROGRESS_ARG_NAMES, rec["progress_args"]))
        cols_ok = rec.get("policy_args") is not None and all(
            np.array_equal(a, b) for a, b in zip(rec["policy_args"][0], want_cols))
        if audit_mod.input_digest(arrays) != want or not cols_ok or \
                rec["policy_args"][1:] != (POLICY_TERMS, POLICY_WEIGHTS):
            raise AssertionError(f"policy record {rec['seq']}: inputs or columns differ")
    zero_counts()
    ms = {}
    for rung, recs in (("steady", batches), ("cpu-ladder", batches[-1:])):
        times = []
        for rec in recs:
            t0 = time.perf_counter()
            rep = replay_audit_record(rec, against=rung)
            times.append((time.perf_counter() - t0) * 1e3)
            if not rep["identical"] or not rep["executed_rung"].get("scan_policy"):
                raise AssertionError(f"policy record {rec['seq']} on {rung}: {rep}")
        ms[rung] = {"replays": len(times), "ms_median": statistics.median(times)}
    replays = read_counts()
    if replays != only(assign_policy=len(batches)):
        raise AssertionError(f"policy ring replays: {replays}")
    return launches, replays, {
        "records": len(batches), "replay": ms, "launches_refresh": launches,
        "launches_replay": replays,
        "audit": {k: v for k, v in stats.items() if k != "audit_dir"}}


# -- explain and what-if (core.explain, ops.explain) ---------------------------
# benchmarks/whatif_gate.py's four phases on the card at the gate's sizes
# (:64-70): counterfactual identity and fork isolation at 48 nodes / 24
# gangs, latency at 5,120 nodes / 2,048 gangs x 5 members. The explain scan
# is also held against its plain version at the north star (bench.py:37-104),
# on mixed's inputs (both mask modes) and on the policy cell's deployment.
WHATIF_SMALL = (48, 24)
WHATIF_LATENCY = (5120, 2048, 5)
# warm what-if queries and steady batches timed for the medians (cut from 7
# for the smoke's time)
WHATIF_REPS = 4
WHATIF_STORM_THREADS, WHATIF_STORM_QUERIES = 4, 3
WHATIF_STORM_ROUNDS = 4  # churn refreshes the live scorer runs under the storm
EXPLAIN_TIMED = 5  # kernel-route explain queries timed at the north star
WHATIF_RUNGS = ("steady", "wavefront", "cpu-ladder")


def whatif_inputs(n_nodes, n_groups, members=3, seed=7):
    """benchmarks/whatif_gate.py's ``_inputs`` with the port's types:
    32-cpu nodes, half of them partly requested, gangs of ``members`` with
    1-8 cpus and 1-8 GiB each in three priority tiers."""
    import numpy as np

    from batch_scheduler_tpu_torch.ops.snapshot import GroupDemand
    from batch_scheduler_tpu_torch.sim.scenarios import make_sim_node

    rng = np.random.default_rng(seed)
    nodes = [make_sim_node(f"node-{i:04d}", {"cpu": "32", "memory": "128Gi", "pods": "110"})
             for i in range(n_nodes)]
    node_req = {n.metadata.name: {"cpu": int(rng.integers(0, 16000)), "pods": 2}
                for n in nodes[: n_nodes // 2]}
    demands = [
        GroupDemand(f"default/gang-{g:04d}", members,
                    member_request={"cpu": int(rng.integers(1000, 8000)),
                                    "memory": int(rng.integers(1, 8)) * 1024**3},
                    priority=int(rng.integers(0, 3)), creation_ts=float(g))
        for g in range(n_groups)
    ]
    return nodes, node_req, demands


def whatif_cfs(nodes, demands):
    """The gate's five counterfactuals (whatif_gate.py ``_counterfactuals``)."""
    return [
        {"kind": "drain", "node": nodes[1].metadata.name},
        {"kind": "cordon", "node": nodes[2].metadata.name},
        {"kind": "add-nodes", "count": 4,
         "shape": {"cpu": "32", "memory": "128Gi", "pods": "110"}},
        {"kind": "bump-gang", "gang": demands[-1].full_name, "tier": 9},
        {"kind": "remove-gang", "gang": demands[0].full_name},
    ]


def direct_digest(nodes, node_req, demands):
    """The plan digest of a cluster that holds these inputs, packed and run
    as one batch on the card (launches restored: a comparison)."""
    from batch_scheduler_tpu_torch.ops.oracle import execute_batch_host
    from batch_scheduler_tpu_torch.ops.snapshot import ClusterSnapshot
    from batch_scheduler_tpu_torch.utils.audit import plan_digest

    saved = read_counts()
    snap = ClusterSnapshot(nodes, node_req, demands)
    host, _ = execute_batch_host(snap.device_args(), snap.progress_args(), device="cuda")
    restore_counts(saved)
    return plan_digest(host)


def explain_inputs(full):
    """(name, batch args, progress args, real nodes, policy payload) of the
    inputs the explain scan is checked on: the north star and mixed's
    per-group batch, and with ``full`` also mixed's broadcast batch and the
    policy cell's deployment (its policy columns, terms and weights)."""
    from batch_scheduler_tpu_torch.core.oracle_scorer import read_cluster_inputs
    from batch_scheduler_tpu_torch.ops.snapshot import ClusterSnapshot
    from batch_scheduler_tpu_torch.policy import engine as engine_mod

    cluster, cache = north_star_cluster()
    snap = ClusterSnapshot(*read_cluster_inputs(cluster, cache))
    out = [("north_star", snap.device_args(), snap.progress_args(), NORTH_STAR_NODES, None)]
    modes = (("mixed_per_group", True), ("mixed_broadcast", False))
    for mode, per_group in modes if full else modes[:1]:
        args, prog = mixed_batch(*MIXED, per_group)
        out.append((mode, args, prog, MIXED[0], None))
    if full:
        cluster, cache = policy_state()
        saved = engine_mod._active[0]
        try:
            with env_set(POLICY_ENV):
                eng = engine_mod.PolicyEngine(engine_mod.PolicyConfig.from_env())
            snap = ClusterSnapshot(*read_cluster_inputs(cluster, cache), policy_engine=eng)
            out.append(("policy", snap.device_args(), snap.progress_args(),
                        NORTH_STAR_NODES, snap.policy_payload()))
        finally:
            engine_mod._active[0] = saved
    return out


def explain_targets(batch_args, host):
    """Gang indices at the first, a middle and the last position of the
    queue order (real gangs), and the first unplaced gang with a need."""
    valid = batch_args[5]
    order = [int(o) for o in batch_args[6] if valid[o]]
    targets = {"first": order[0], "middle": order[len(order) // 2], "last": order[-1]}
    unplaced = [g for g in order if not host["placed"][g] and batch_args[3][g] > 0]
    if unplaced:
        targets["unplaced"] = unplaced[0]
    return targets


def check_explain_scan(full):
    """The explain scan's kernel route (two launches of the serial kernel,
    or of its policy variant for the policy input) against its plain
    version on the CPU (the capture scan step by step), every field equal,
    for each input's targets; then EXPLAIN_TIMED timed queries at the north
    star: the two launches' CUDA-event time and the whole call's wall
    clock, the plain version's time on the card and on the CPU, and the
    bound (twice the serial scan's). Returns (launches by kernel, report)."""
    import numpy as np
    import torch

    from batch_scheduler_tpu_torch.ops.convert import args_from_numpy, policy_from_numpy
    from batch_scheduler_tpu_torch.ops.explain import explain_gang, explain_gang_plain
    from batch_scheduler_tpu_torch.ops.oracle import execute_batch_host, left_resources

    launches = {k: 0 for k in KERNELS}
    report, problems = {}, []
    queries = 0
    for name, args, prog, n_real, policy in explain_inputs(full):
        saved = read_counts()
        host, _ = execute_batch_host(args, prog, device="cuda", policy=policy)
        restore_counts(saved)
        kernel = "assign_scan" if policy is None else "assign_policy"
        dev_args, cpu_args = args_from_numpy(args, "cuda"), args_from_numpy(args, "cpu")
        kw_dev = kw_cpu = {}
        if policy is not None:
            cols, terms, weights = policy
            kw_dev = {"policy_cols": policy_from_numpy(cols, "cuda"),
                      "policy_terms": terms, "policy_weights": weights}
            kw_cpu = dict(kw_dev, policy_cols=policy_from_numpy(cols, "cpu"))
        rows = {}
        for target, g in explain_targets(args, host).items():
            zero_counts()
            with kernel_event_times() as timed:
                t0 = time.perf_counter()
                got = {k: v.cpu().numpy() for k, v in explain_gang(
                    *dev_args, g, n_real, **kw_dev).items()}
                wall_ms = (time.perf_counter() - t0) * 1e3
                event_ms = timed[kernel].take_ms()
            counted = read_counts()
            queries += 1
            for k, n in counted.items():
                launches[k] += n
            t0 = time.perf_counter()
            want = {k: v.numpy() for k, v in explain_gang_plain(
                *cpu_args, g, n_real, **kw_cpu).items()}
            plain_cpu_ms = (time.perf_counter() - t0) * 1e3
            diff = [k for k in want if not np.array_equal(got[k], want[k])]
            if diff or counted[kernel] != 2 or sum(counted.values()) != 2:
                problems.append(f"{name}/{target} (gang {g}): fields {diff}, launches {counted}")
            rows[target] = {"gang": g, "placed": bool(host["placed"][g]),
                            "nodes_entry": int(got["nodes_entry"]),
                            "nodes_indep": int(got["nodes_indep"]),
                            "feasible_at_entry": bool(got["feasible_entry"]),
                            "two_launches_ms": sum(event_ms), "query_wall_ms": wall_ms,
                            "plain_cpu_ms": plain_cpu_ms}
        report[name] = {"shape": [int(args[2].shape[0]), int(args[0].shape[0]),
                                  int(args[0].shape[1])], "mask_rows": int(args[4].shape[0]),
                        "kernel": kernel, "targets": rows}
        if name == "north_star":
            g = rows["middle"]["gang"]
            event_ms, wall_ms = [], []
            zero_counts()
            with kernel_event_times() as timed:
                for _ in range(EXPLAIN_TIMED):
                    t0 = time.perf_counter()
                    out = explain_gang(*dev_args, g, n_real)
                    out["near_idx"].cpu()
                    wall_ms.append((time.perf_counter() - t0) * 1e3)
                    event_ms.append(sum(timed["assign_scan"].take_ms()))
            counted = read_counts()
            queries += EXPLAIN_TIMED
            for k, n in counted.items():
                launches[k] += n
            saved = read_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            explain_gang_plain(*dev_args, g, n_real)["near_idx"].cpu()
            plain_cuda_ms = (time.perf_counter() - t0) * 1e3
            restore_counts(saved)
            left = left_resources(dev_args[0], dev_args[1])
            from batch_scheduler_tpu_torch.ops.bounds import scan_bound

            bound_ms, bound_by, nbytes, ops = scan_bound(left, *dev_args[2:5], dev_args[6])
            report["north_star_timed"] = {
                "gang": g, "queries": EXPLAIN_TIMED,
                "two_launches_ms_median": statistics.median(event_ms),
                "two_launches_ms": event_ms,
                "query_wall_ms_median": statistics.median(wall_ms), "query_wall_ms": wall_ms,
                "plain_cuda_ms": plain_cuda_ms,
                "plain_cpu_ms": rows["middle"]["plain_cpu_ms"],
                "bound_ms": 2 * bound_ms, "bound_by": bound_by, "bytes": 2 * nbytes,
                "int_ops": 2 * ops,
            }
    if problems:
        raise AssertionError("explain scan: " + "; ".join(problems[:4]))
    report["queries"] = queries
    return launches, report


def check_whatif_identity(kernel):
    """The gate's counterfactual identity on the card: for each rung and
    each of the five kinds, the what-if plan digest equals a cluster that
    applied the change and ran the batch directly, and the baseline digest
    a direct baseline. Launches (one baseline and five counterfactual
    batches a rung) counted per rung. Returns (launches by rung, report)."""
    from batch_scheduler_tpu_torch.core.explain import WhatIfEngine, apply_counterfactual

    nodes, node_req, demands = whatif_inputs(*WHATIF_SMALL)
    cfs = whatif_cfs(nodes, demands)
    base = direct_digest(nodes, node_req, demands)
    applied = {cf["kind"]: direct_digest(*apply_counterfactual(nodes, node_req, demands, cf))
               for cf in cfs}
    report, problems, by_rung = {}, [], {}
    want_kernel = {"steady": kernel, "wavefront": "assign_wave", "cpu-ladder": None}
    for rung in WHATIF_RUNGS:
        engine = WhatIfEngine(device="cuda")
        zero_counts()
        answers = [engine.query_on(nodes, node_req, demands, cf, rung=rung,
                                   baseline_key="identity") for cf in cfs]
        counted = read_counts()
        by_rung[rung] = counted
        k = want_kernel[rung]
        want = {name: (len(cfs) + 1 if name == k else 0) for name in KERNELS}
        if counted != want:
            problems.append(f"{rung}: launches {counted}, want {want}")
        for cf, res in zip(cfs, answers):
            if res["whatif"]["plan_digest"] != applied[cf["kind"]] or \
                    res["base"]["plan_digest"] != base:
                problems.append(f"{rung}/{cf['kind']}: digests differ")
        report[rung] = {res["kind"]: {"newly_placeable": len(res["newly_placeable"]),
                                      "no_longer_placeable": len(res["no_longer_placeable"]),
                                      "displaced_seats": res["displaced_seats"],
                                      "whatif_nodes": res["whatif"]["nodes"]}
                        for res in answers}
    if problems:
        raise AssertionError("what-if identity: " + "; ".join(problems[:4]))
    return by_rung, report


def storm_run(storm):
    """north_star_churn's deployment through an OracleScorer on cuda: a
    first refresh, then WHATIF_STORM_ROUNDS churn refreshes on a thread
    and, with ``storm``, WHATIF_STORM_THREADS threads of what-if queries
    forking the live holder meanwhile; then one more churn round and
    refresh (the next batch). Returns the holder's stats, its data
    pointers after the first refresh (``ptrs0``) and at the end
    (``ptrs1``), the next batch's plan digest, the launches while the
    threads ran (``during``) and of the next batch (``next``), and the
    what-if queries run."""
    import threading

    import torch

    from batch_scheduler_tpu_torch.core import OracleScorer
    from batch_scheduler_tpu_torch.core.explain import WhatIfEngine
    from batch_scheduler_tpu_torch.core.oracle_scorer import read_cluster_inputs
    from batch_scheduler_tpu_torch.utils.audit import plan_digest

    cluster, cache = north_star_state()
    scorer = OracleScorer(device="cuda")
    churn = Churn(cluster, cache, lambda name: scorer.mark_dirty(group=name),
                  WHATIF_STORM_ROUNDS + 2)
    scorer.refresh(cluster, cache)
    holder = scorer._device_state
    names = ("_alloc", "_requested", "_group_req")
    ptrs0 = {n: getattr(holder, n).data_ptr() for n in names}
    nodes, node_req, demands = read_cluster_inputs(cluster, cache)
    cfs = whatif_cfs(nodes, demands)
    engine = WhatIfEngine(holder_source=lambda: holder, device="cuda")
    errors = []

    def refresher():
        try:
            for r in range(1, WHATIF_STORM_ROUNDS + 1):
                churn(r)
                scorer.refresh(cluster, cache)
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    def storm_thread(w):
        try:
            for i in range(WHATIF_STORM_QUERIES):
                engine.query_on(nodes, node_req, demands, cfs[(w + i) % len(cfs)],
                                baseline_key="storm")
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    zero_counts()
    threads = [threading.Thread(target=refresher)]
    if storm:
        threads += [threading.Thread(target=storm_thread, args=(w,))
                    for w in range(WHATIF_STORM_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(LOCKCHECK_TIMEOUT)
    during = read_counts()
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"storm run (storm={storm}): {errors[:3]}")
    churn(WHATIF_STORM_ROUNDS + 1)
    zero_counts()
    scorer.refresh(cluster, cache)
    return {"stats": holder.stats(), "ptrs0": ptrs0,
            "ptrs1": {n: getattr(holder, n).data_ptr() for n in names},
            "digest": plan_digest(scorer._state.result), "during": during,
            "next": read_counts(), "queries": engine.queries}


def check_fork_isolation(kernel):
    """The gate's fork isolation at the north star on the card: the storm
    run's live holder ends with the generation, rows scattered, keyframes
    and next-batch plan digest of the run without the storm, and its
    tensors' data pointers never move. Returns (launches, report)."""
    control = storm_run(False)
    stormed = storm_run(True)
    keys = ("generation", "rows_scattered", "keyframes", "deltas_applied")
    problems = [k for k in keys if control["stats"][k] != stormed["stats"][k]]
    if control["digest"] != stormed["digest"]:
        problems.append("next-batch plan digest")
    for run in (control, stormed):
        if run["ptrs0"] != run["ptrs1"]:
            problems.append(f"live data pointers moved {run['ptrs0']} -> {run['ptrs1']}")
    rounds = WHATIF_STORM_ROUNDS
    queries = WHATIF_STORM_THREADS * WHATIF_STORM_QUERIES
    if control["during"][kernel] != rounds or \
            stormed["during"][kernel] != rounds + queries + 1 or \
            stormed["next"][kernel] != 1 or stormed["queries"] != queries:
        problems.append(f"launches: control {control['during']}, storm {stormed['during']} "
                        f"(want {rounds} and {rounds} + {queries} + 1 {kernel}), "
                        f"next {stormed['next']}, queries {stormed['queries']}")
    if problems:
        raise AssertionError("fork isolation: " + "; ".join(problems))
    return stormed["during"][kernel] - rounds, {
        **{k: stormed["stats"][k] for k in keys}, "storm_queries": queries,
        "churn_refreshes": rounds, "next_batch_digest_equal": True,
        "data_ptrs_unchanged": True}


def check_explain_agrees(kernel):
    """mixed's denials (obs_denials' deployment) through a ScheduleOperation
    on cuda, every gang's pod through PreFilter; then for every denied gang
    in the flight recorder, /debug/explain served by serve_metrics: 200,
    recorded_agrees true, the recorded blame and feasible-node count.
    Returns (PreFilter launches, explain launches, report)."""
    from batch_scheduler_tpu_torch.core import ScheduleOperation
    from batch_scheduler_tpu_torch.utils import errors as errs
    from batch_scheduler_tpu_torch.utils import metrics, trace

    cluster, cache, _ = mixed_state(*MIXED)
    op = ScheduleOperation(cache, cluster, device="cuda")
    trace.DEFAULT_FLIGHT_RECORDER.clear()
    denied = []
    zero_counts()
    for name, pgs in sorted(cache.snapshot().items()):
        try:
            op.pre_filter(pgs.pod)
        except errs.SchedulingError:
            denied.append(name)
    prefilter = read_counts()
    server = metrics.serve_metrics(port=0)
    port = server.server_address[1]
    bad, ms, verdicts = [], [], {}
    try:
        zero_counts()
        recorded = trace.DEFAULT_FLIGHT_RECORDER.snapshot()
        checked = 0
        for gang, recs in sorted(recorded.items()):
            rec = next((r for r in reversed(recs) if r.get("phase") == "pre_filter"), None)
            if rec is None or rec.get("verdict") != "denied":
                continue
            status, body, t = http_get(port, f"/debug/explain?gang={gang}")
            ms.append(t)
            checked += 1
            exp = json.loads(body) if status == 200 else {}
            verdicts[exp.get("feasible_alone")] = verdicts.get(exp.get("feasible_alone"), 0) + 1
            if status != 200 or exp.get("recorded_agrees") is not True or \
                    exp.get("deny_reason") != rec.get("reason") or \
                    exp.get("feasible_nodes") != rec.get("feasible_nodes"):
                bad.append((gang, status, {k: exp.get(k) for k in (
                    "deny_reason", "feasible_nodes", "recorded_agrees", "error")}, rec))
        explained = read_counts()
    finally:
        server.shutdown()
        server.server_close()
    if bad or not checked or checked != len(denied) or prefilter[kernel] != 1 or \
            explained["assign_scan"] != 2 * checked or \
            sum(explained.values()) != 2 * checked:
        raise AssertionError(f"explain vs recorded blame: {len(denied)} denied, {checked} "
                             f"checked, PreFilter launches {prefilter}, explain launches "
                             f"{explained}; disagreeing {bad[:3]}")
    return prefilter[kernel], explained["assign_scan"], {
        "gangs": len(cache), "denied": len(denied), "explained": checked,
        "recorded_agrees": checked, "feasible_alone": {str(k): v for k, v in verdicts.items()},
        "explain_route_ms_median": statistics.median(ms), "explain_route_ms_max": max(ms)}


def check_whatif_latency():
    """The gate's latency at its acceptance bucket on the card: the median
    of WHATIF_REPS warm what-if queries (baseline cached) against the
    median of WHATIF_REPS steady execute_batch_host calls, each query split
    into pack (the counterfactual's ClusterSnapshot and the fork's row
    scatters), batches (the fork's batch) and diff (the rest: fork, digests,
    placement diff, metrics). The reference gate's 2.0x ceiling is printed
    beside the ratio, not enforced. Returns (launches, report)."""
    import numpy as np

    from batch_scheduler_tpu_torch.core import explain as explain_mod
    from batch_scheduler_tpu_torch.ops.device_state import DeviceStateHolder
    from batch_scheduler_tpu_torch.ops.oracle import execute_batch_host
    from batch_scheduler_tpu_torch.ops.snapshot import ClusterSnapshot

    nodes, node_req, demands = whatif_inputs(*WHATIF_LATENCY, seed=3)
    snap = ClusterSnapshot(nodes, node_req, demands)
    args, prog = snap.device_args(), snap.progress_args()
    zero_counts()
    execute_batch_host(args, prog, device="cuda")
    steady = []
    for _ in range(WHATIF_REPS):
        t0 = time.perf_counter()
        execute_batch_host(args, prog, device="cuda")
        steady.append((time.perf_counter() - t0) * 1e3)
    engine = explain_mod.WhatIfEngine(device="cuda")
    cf = {"kind": "drain", "node": nodes[1].metadata.name}
    t0 = time.perf_counter()
    engine.query_on(nodes, node_req, demands, cf, baseline_key="lat")
    cold_ms = (time.perf_counter() - t0) * 1e3
    parts = {"pack": 0.0, "batches": 0.0}

    def timed(fn, part):
        def run(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                parts[part] += time.perf_counter() - t
        return run

    orig_exec, orig_pack, orig_apply = (explain_mod._execute_rung, engine._pack,
                                        DeviceStateHolder.apply_batch)
    explain_mod._execute_rung = timed(orig_exec, "batches")
    engine._pack = timed(orig_pack, "pack")
    DeviceStateHolder.apply_batch = timed(orig_apply, "pack")
    rows = []
    try:
        for _ in range(WHATIF_REPS):
            parts.update(pack=0.0, batches=0.0)
            t0 = time.perf_counter()
            res = engine.query_on(nodes, node_req, demands, cf, baseline_key="lat")
            total = (time.perf_counter() - t0) * 1e3
            if not res["baseline_cached"]:
                raise AssertionError("the warm what-if query rebuilt its baseline")
            rows.append((total, parts["pack"] * 1e3, parts["batches"] * 1e3))
    finally:
        explain_mod._execute_rung = orig_exec
        del engine._pack
        DeviceStateHolder.apply_batch = orig_apply
    launches = read_counts()
    total = [r[0] for r in rows]
    med = statistics.median(total)
    steady_med = statistics.median(steady)
    k = int(np.argsort(total)[len(total) // 2])
    return launches, {
        "shape": {"nodes": WHATIF_LATENCY[0], "groups": WHATIF_LATENCY[1],
                  "pods": WHATIF_LATENCY[1] * WHATIF_LATENCY[2],
                  "bucket": [int(args[2].shape[0]), int(args[0].shape[0]),
                             int(args[0].shape[1])]},
        "steady_batch_ms_median": steady_med, "steady_batch_ms": steady,
        "whatif_query_ms_median": med, "whatif_query_ms": total,
        "whatif_cold_query_ms": cold_ms,
        "ratio": med / steady_med, "reference_ceiling": 2.0,
        "split_ms_of_median_query": {"pack": rows[k][1], "batches": rows[k][2],
                                     "diff": rows[k][0] - rows[k][1] - rows[k][2]},
        "split_ms_medians": {
            "pack": statistics.median(r[1] for r in rows),
            "batches": statistics.median(r[2] for r in rows),
            "diff": statistics.median(r[0] - r[1] - r[2] for r in rows)},
    }


def explain_whatif_phase(wave, results):
    """The four gate phases and the explain scan check, with
    BST_SCAN_WAVE at ``wave`` (the explain scan is the serial kernel's on
    every rung; the what-if steady rung follows the knob)."""
    kernel = "assign_wave" if wave else "assign_scan"
    suffix = "_wave" if wave else ""
    paths, out = {}, {}
    with scan_wave_env(wave):
        launches, out["explain_scan"] = check_explain_scan(full=wave is None)
        for k, n in launches.items():
            if n:
                paths[(k, f"explain_scan{suffix}")] = n
        by_rung, out["identity"] = check_whatif_identity(kernel)
        for rung, counted in by_rung.items():
            for k, n in counted.items():
                if n:
                    paths[(k, f"whatif_{rung}{suffix}")] = n
        n, out["isolation"] = check_fork_isolation(kernel)
        paths[(kernel, f"whatif_storm{suffix}")] = n
        n_pre, n_exp, out["explain_agrees"] = check_explain_agrees(kernel)
        paths[(kernel, f"explain_agrees_prefilter{suffix}")] = n_pre
        paths[("assign_scan", f"explain_agrees{suffix}")] = n_exp
        launches, out["latency"] = check_whatif_latency()
        paths[(kernel, f"whatif_latency{suffix}")] = launches[kernel]
        if sum(launches.values()) != launches[kernel]:
            raise AssertionError(f"latency launches {launches}")
    for (k, path), n in paths.items():
        if k in results:
            results[k]["launches_by_path"][path] = n
    out["launches_by_path"] = {f"{k}:{path}": n for (k, path), n in paths.items()}
    return out


@phase("explain_whatif")
def explain_whatif(results):
    """Explain and what-if on the card with the serial kernel."""
    return explain_whatif_phase(None, results)


@phase("explain_whatif_wave")
def explain_whatif_wave(results):
    """explain_whatif with BST_SCAN_WAVE=8 (the what-if steady rung on the
    wave kernel; the explain scan stays on the serial kernel)."""
    return explain_whatif_phase(8, results)


# -- the hierarchical top-K rung (BST_SCAN_TOPK) --------------------------------

XL_PAD = 131072  # XLClusterSpec()'s 100,000 nodes in their bucket
XL_ACCEPT = (2048, 65536)  # benchmarks/xl_scaling.py:250, the acceptance bucket
TOPK_WAVE = 8  # the rung's width with BST_SCAN_WAVE unset
XL_K = (16, 128)
XL_REPS = 3
XL_CHURN_STEPS = 3
TOPK_K = 16  # north_star_topk's BST_SCAN_TOPK (the reference's replay rung)
TOPK_ROUNDS = 8  # churn refreshes after the keyframe
TOPK_SERIAL_ROUNDS = 2  # churn refreshes of the serial-recorded ring


def xl_operands(spec, pad):
    """xl_scan_operands(spec) on the card, the node axis padded to ``pad``
    (padded nodes: no leftover, out of the fit row, as the batch pads)."""
    import numpy as np
    import torch

    from batch_scheduler_tpu_torch.sim.scenarios import xl_scan_operands

    left, req, rem, mask, order = xl_scan_operands(spec)
    left = np.pad(left, ((0, pad - left.shape[0]), (0, 0)))
    mask = np.pad(mask, ((0, 0), (0, pad - mask.shape[1]))) != 0
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).cuda()
                 for a in (left, req, rem, mask, order))


def series(stats):
    """The three per-wave series as lists (flags as 0/1)."""
    import torch

    return [x.to("cpu", torch.int32).tolist() for x in stats]


def check_xl(name, args):
    """The serial kernel, the wave kernel at TOPK_WAVE and the top-K kernel at
    each of XL_K on one XL input: every output bit-identical across them,
    the top-K series equal to the plain top-K scan's (run on the card), the
    kernels timed under CUDA events (XL_REPS each, in turns: serial, wave,
    top-K, top-K, wave, serial), the plain scan's wall clock."""
    import torch

    from batch_scheduler_tpu_torch.ops.assign_scan import (
        assign_gangs_cuda, assign_gangs_topk_cuda, assign_gangs_wave_cuda)
    from batch_scheduler_tpu_torch.ops.oracle import assign_gangs_topk

    serial = assign_gangs_cuda(*args)
    wave = assign_gangs_wave_cuda(*args, TOPK_WAVE)
    err, equal = max_err(wave[:3], serial)
    if not equal:
        raise AssertionError(f"{name}: the wave kernel differs from the serial one ({err})")
    out = {"shape": [args[1].shape[0], args[0].shape[0], args[0].shape[1]],
           "serial_ms": [], "wave_ms": []}
    runs = {"serial": lambda: assign_gangs_cuda(*args),
            "wave": lambda: assign_gangs_wave_cuda(*args, TOPK_WAVE)}
    out["serial_ms"].append(cuda_ms(runs["serial"], XL_REPS))
    out["wave_ms"].append(cuda_ms(runs["wave"], XL_REPS))
    for k in XL_K:
        got = assign_gangs_topk_cuda(*args, TOPK_WAVE, k)
        err, equal = max_err(got[:3], serial)
        if not equal:
            raise AssertionError(f"{name}, K={k}: the top-K kernel differs from the serial "
                                 f"one (max abs err {err})")
        t0 = time.perf_counter()
        plain = assign_gangs_topk(*args, wave=TOPK_WAVE, k=k, with_stats=True)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        perr, pequal = max_err(list(got[:3]) + list(got[3]), list(plain[:3]) + list(plain[3]))
        if not pequal:
            raise AssertionError(f"{name}, K={k}: the top-K kernel differs from the plain "
                                 f"version (max abs err {perr})")
        run = lambda: assign_gangs_topk_cuda(*args, TOPK_WAVE, k)  # noqa: E731
        ms = [cuda_ms(run, XL_REPS), cuda_ms(run, XL_REPS)]
        conflicts, megas, dem = series(got[3])
        from batch_scheduler_tpu_torch.ops.bounds import topk_bound

        bound_ms, bound_by, nbytes, ops = topk_bound(*args, TOPK_WAVE, got[3])
        out[f"topk_{k}"] = {
            "kernel_ms": ms, "plain_s": plain_s, "max_abs_err": max(err, perr),
            "waves": len(conflicts), "replayed": sum(conflicts), "uniform": sum(megas),
            "demotions": sum(dem), "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": nbytes, "int_ops": ops}
        del got, plain
    out["wave_ms"].append(cuda_ms(runs["wave"], XL_REPS))
    out["serial_ms"].append(cuda_ms(runs["serial"], XL_REPS))
    out["bit_identical"] = True
    return out


def xl_batch_args(args):
    """The padded XL operands as a packed batch: the leftover as
    allocatable with nothing requested, every gang valid, the needs as
    min_member with nothing scheduled."""
    import numpy as np

    left, req, rem, mask, order = (a.cpu().numpy() for a in args)
    g = req.shape[0]
    batch = (left, np.zeros_like(left), req, rem, mask, np.ones(g, bool), order)
    progress = (rem.copy(), np.zeros(g, np.int32), np.zeros(g, np.int32), np.zeros(g, bool),
                np.arange(g, dtype=np.int32))
    return batch, progress


def xl_full_batch(args):
    """One full batch on the padded XL operands through execute_batch_host,
    BST_SCAN_TOPK=128 against unset: the host dicts equal (the unpacked
    tail: N > 2^15); one top-K launch; the device batch's split: the head
    (leftover, capacity, feasibility, scores), the scan kernel and the
    compaction (_top_k_ties_by_index), each timed alone under CUDA events
    on the batch's own tensors, beside the whole batch's wall clock."""
    import numpy as np
    import torch

    from batch_scheduler_tpu_torch.ops.assign_scan import (
        assign_gangs_cuda, assign_gangs_topk_cuda)
    from batch_scheduler_tpu_torch.ops.convert import batch_from_numpy
    from batch_scheduler_tpu_torch.ops.oracle import (
        _top_k_ties_by_index, batch_top_k, execute_batch_host, gang_feasible,
        group_capacity, left_resources, score_nodes)

    batch, progress = xl_batch_args(args)
    walls, hosts = {}, {}
    zero_counts()
    for label, env in (("topk", "128"), ("serial", None), ("topk_again", "128")):
        with env_set({"BST_SCAN_TOPK": env, "BST_SCAN_WAVE": None}):
            t0 = time.perf_counter()
            hosts[label], _ = execute_batch_host(batch, progress, device="cuda")
            torch.cuda.synchronize()
            walls[label] = (time.perf_counter() - t0) * 1e3
    launches = read_counts()
    if launches != only(assign_scan=1, assign_topk=2):
        raise AssertionError(f"full XL batches launched {launches}")
    diff = [k for k in HOST_KEYS if not np.array_equal(hosts["topk"][k], hosts["serial"][k])]
    tele = hosts["topk"]["telemetry"]
    if diff or tele["scan_topk"] != 128 or tele["n_bucket"] != XL_PAD:
        raise AssertionError(f"full XL batch: top-K against serial differs in {diff}; "
                             f"telemetry {tele}")
    k = batch_top_k(XL_PAD, int(batch[3].max()))
    if hosts["topk"]["assignment_nodes"].shape != (batch[2].shape[0], k):
        raise AssertionError("full XL batch: the unpacked tail's shape")
    saved = read_counts()
    dev_batch, _ = batch_from_numpy(batch, progress, "cuda")
    alloc, requested, group_req, remaining, fit_mask, group_valid, order = dev_batch

    def head():
        left = left_resources(alloc, requested)
        cap = group_capacity(left, group_req, fit_mask)
        return left, cap, gang_feasible(cap, remaining, group_valid), score_nodes(cap)

    left = head()[0]
    scan_args = (left, group_req, remaining, fit_mask, order)
    assignment = assign_gangs_topk_cuda(*scan_args, TOPK_WAVE, 128)[0]
    split = {"head_ms": cuda_ms(head, XL_REPS),
             "scan_topk_128_ms": cuda_ms(lambda: assign_gangs_topk_cuda(*scan_args, TOPK_WAVE, 128),
                                         XL_REPS),
             "scan_serial_ms": cuda_ms(lambda: assign_gangs_cuda(*scan_args), XL_REPS),
             "compaction_ms": cuda_ms(lambda: _top_k_ties_by_index(assignment, k), XL_REPS)}
    restore_counts(saved)
    return {"batch_wall_ms": walls, "device_split": split, "top_k": k,
            "telemetry": {key: tele[key] for key in ("scan_topk", "wave_width", "waves_per_batch",
                                                     "wave_demotions", "wave_uniform",
                                                     "topk_demotions")},
            "launches": launches, "host_equal_serial": True}


@phase("xl_topk")
def xl_topk(results):
    """The XL tier on the card (see the module docstring)."""
    from batch_scheduler_tpu_torch.ops.assign_scan import assign_gangs_cuda, assign_gangs_topk_cuda
    from batch_scheduler_tpu_torch.sim.scenarios import XLClusterSpec, xl_churn_burst

    report = {}
    zero_counts()
    inputs = (("xl", XLClusterSpec(), XL_PAD),
              ("xl_3_profiles", XLClusterSpec(request_profiles=3), XL_PAD),
              ("accept", XLClusterSpec(num_nodes=XL_ACCEPT[1], num_groups=XL_ACCEPT[0], seed=1),
               XL_ACCEPT[1]))
    for name, spec, pad in inputs:
        report[name] = check_xl(name, xl_operands(spec, pad))
    # churn: bursts of the reference's xl_churn_burst, each re-run held to
    # the serial kernel
    spec = XLClusterSpec()
    args = xl_operands(spec, XL_PAD)
    left = args[0].cpu().numpy()[: spec.num_nodes]
    churn = []
    for step in range(1, XL_CHURN_STEPS + 1):
        left = xl_churn_burst(spec, left, step)
        burst = (xl_operands_left(left, XL_PAD),) + args[1:]
        got = assign_gangs_topk_cuda(*burst, TOPK_WAVE, 128)
        err, equal = max_err(got[:3], assign_gangs_cuda(*burst))
        if not equal:
            raise AssertionError(f"churn step {step}: the top-K kernel differs from the serial "
                                 f"one (max abs err {err})")
        conflicts, megas, dem = series(got[3])
        churn.append({"step": step, "kernel_ms": cuda_ms(
            lambda: assign_gangs_topk_cuda(*burst, TOPK_WAVE, 128), XL_REPS),
            "replayed": sum(conflicts), "demotions": sum(dem)})
    report["churn_k128"] = churn
    launches = read_counts()
    report["full_batch"] = xl_full_batch(args)
    if "assign_topk" in results:
        paths = results["assign_topk"]["launches_by_path"]
        paths["xl_topk"] = launches["assign_topk"]
        paths["xl_topk_full_batch"] = report["full_batch"]["launches"]["assign_topk"]
    return report


def xl_operands_left(left, pad):
    """A churned XL leftover on the card, padded to ``pad`` nodes."""
    import numpy as np
    import torch

    return torch.from_numpy(np.ascontiguousarray(np.pad(left, ((0, pad - left.shape[0]),
                                                               (0, 0))))).cuda()


def check_topk_series(scorer, snap):
    """The top-K kernel on the scorer's last batch's scan inputs against
    the plain top-K scan (outputs and series), and its series held to the
    batch's telemetry. Launches restored. Returns (max_abs_err, args,
    kernel output)."""
    from batch_scheduler_tpu_torch.ops.assign_scan import assign_gangs_topk_cuda
    from batch_scheduler_tpu_torch.ops.oracle import assign_gangs_topk

    saved = read_counts()
    args = scan_inputs(snap.device_args())
    got = assign_gangs_topk_cuda(*args, TOPK_WAVE, TOPK_K)
    plain = assign_gangs_topk(*args, wave=TOPK_WAVE, k=TOPK_K, with_stats=True)
    restore_counts(saved)
    err, equal = max_err(list(got[:3]) + list(got[3]), list(plain[:3]) + list(plain[3]))
    conflicts, megas, dem = series(got[3])
    tele = scorer.last_telemetry
    want = {"wave_width": TOPK_WAVE, "scan_topk": TOPK_K, "waves_per_batch": len(conflicts),
            "wave_demotions": sum(conflicts), "wave_uniform": sum(megas),
            "topk_demotions": sum(dem)}
    if not equal or {k: tele.get(k) for k in want} != want:
        raise AssertionError(f"top-K kernel against plain equal={equal} (err {err}); "
                             f"series {want}, telemetry {tele}")
    return err, args, got


def serial_diff(scorer, cluster, cache):
    """What differs between the scorer's last batch and the full pack of the
    same state run on the serial rung (forced_scan_rung(0)), launches
    restored."""
    import numpy as np

    from batch_scheduler_tpu_torch.core.oracle_scorer import read_cluster_inputs
    from batch_scheduler_tpu_torch.ops.oracle import execute_batch_host, forced_scan_rung
    from batch_scheduler_tpu_torch.ops.snapshot import ClusterSnapshot

    saved = read_counts()
    snap = ClusterSnapshot(*read_cluster_inputs(cluster, cache))
    with forced_scan_rung(0):
        want, _ = execute_batch_host(snap.device_args(), snap.progress_args(), device="cuda")
    restore_counts(saved)
    got = scorer._state.result
    return [k for k in HOST_KEYS if not np.array_equal(got[k], want[k])], snap


def topk_ring(directory, topk, rounds):
    """north_star_churn's deployment through OracleScorer(device="cuda")
    with an ``array`` AuditLog, BST_SCAN_TOPK=``topk`` (None: unset) and
    BST_SCAN_WAVE unset: a keyframe and ``rounds`` churn refreshes (Churn),
    every kernel's count zeroed just before and read just after; each
    refresh's host dict equal to the serial rung's full pack, and on the
    top-K rung its series checked (check_topk_series). Returns (scorer,
    launches, refresh seconds, max_abs_err, the last scan args and the
    kernel's output on them, the ring's records)."""
    import torch

    from batch_scheduler_tpu_torch.core import OracleScorer
    from batch_scheduler_tpu_torch.utils.audit import AuditLog, AuditReader

    cluster, cache = north_star_state()
    log = AuditLog(directory, fmt="array", keyframe_every=16)
    scorer = OracleScorer(device="cuda", audit_log=log)
    churn = Churn(cluster, cache, lambda name: scorer.mark_dirty(group=name), rounds + 1)
    refresh_s, err, last = [], 0, None
    with env_set({"BST_SCAN_TOPK": None if topk is None else str(topk), "BST_SCAN_WAVE": None}):
        zero_counts()
        for r in range(rounds + 1):
            if r:
                churn(r)
            t0 = time.perf_counter()
            scorer.refresh(cluster, cache)
            torch.cuda.synchronize()
            refresh_s.append(time.perf_counter() - t0)
            diff, snap = serial_diff(scorer, cluster, cache)
            if diff:
                raise AssertionError(f"refresh {r}: the plan differs from the serial rung's "
                                     f"in {diff}")
            if topk is not None:
                e, args, out = check_topk_series(scorer, snap)
                err, last = max(err, e), (args, out)
        launches = read_counts()
    if not log.flush(120.0):
        raise AssertionError("the audit writer did not finish")
    batches, skipped = AuditReader(directory).batches()
    if skipped or len(batches) != rounds + 1:
        raise AssertionError(f"{len(batches)} records of {rounds + 1}, skipped {skipped[:2]}")
    return scorer, cluster, cache, launches, refresh_s, err, last, batches


def topk_replays(batches, rungs):
    """Replay the records on each (rung, how many of the last, the executed
    (scan, wave width, scan_topk)); every one identical. Returns the
    launches of the cuda rungs' replays by kernel and ms by rung."""
    from batch_scheduler_tpu_torch.core.oracle_scorer import replay_audit_record

    ms = {}
    zero_counts()
    for rung, last, executed in rungs:
        times = []
        for rec in batches[-last:]:
            t0 = time.perf_counter()
            rep = replay_audit_record(rec, against=rung)
            times.append((time.perf_counter() - t0) * 1e3)
            ran = rep["executed_rung"]
            if not rep["identical"] or \
                    (ran["scan"], ran["wave_width"], ran.get("scan_topk", 0)) != executed:
                raise AssertionError(f"record {rec['seq']} on {rung}: {rep}")
        ms[rung] = {"replays": len(times), "ms_median": statistics.median(times)}
    return read_counts(), ms


def whatif_topk(cluster, cache):
    """/debug/whatif?rung=topk on a live observatory (an oracle
    ScheduleOperation on the card over north_star_churn's deployment,
    BST_SCAN_TOPK unset) against rung=steady: the same what-if and
    baseline digests. Returns (launches of the topk query, report)."""
    from batch_scheduler_tpu_torch.core import ScheduleOperation
    from batch_scheduler_tpu_torch.utils.metrics import serve_metrics

    op = ScheduleOperation(cache, cluster, device="cuda")
    op.oracle.refresh(cluster, cache)
    node = cluster.list_nodes()[1].metadata.name
    srv = serve_metrics(port=0)
    try:
        port = srv.server_address[1]
        answers, launches = {}, {}
        for rung in ("steady", "topk"):
            zero_counts()
            status, body, ms = http_get(port, f"/debug/whatif?drain={node}&rung={rung}")
            launches[rung] = read_counts()
            if status != 200:
                raise AssertionError(f"/debug/whatif rung={rung}: {status} {body[:300]!r}")
            answers[rung] = (json.loads(body), ms)
    finally:
        srv.shutdown()
        srv.server_close()
    (steady, steady_ms), (topk, topk_ms) = answers["steady"], answers["topk"]
    if topk["rung"] != "topk" or any(topk[s]["plan_digest"] != steady[s]["plan_digest"]
                                     for s in ("base", "whatif")):
        raise AssertionError(f"/debug/whatif: topk {topk} against steady {steady}")
    if launches["topk"]["assign_topk"] < 1:
        raise AssertionError(f"/debug/whatif rung=topk launched {launches['topk']}")
    return launches["topk"], {"route_ms": {"steady": steady_ms, "topk": topk_ms},
                              "plan_digest": topk["whatif"]["plan_digest"],
                              "placed": topk["whatif"]["placed"]}


@phase("north_star_topk")
def north_star_topk(results):
    """The north star through the normal entry point on the top-K rung (see
    the module docstring)."""
    import tempfile

    from batch_scheduler_tpu_torch.ops.assign_scan import (
        assign_gangs_topk_cuda, assign_gangs_wave_cuda, topk_scan_plan)
    from batch_scheduler_tpu_torch.ops.oracle import assign_gangs_topk

    with tempfile.TemporaryDirectory() as tmp:
        scorer, cluster, cache, launches, refresh_s, err, (args, out), batches = topk_ring(
            os.path.join(tmp, "topk"), TOPK_K, TOPK_ROUNDS)
        n = TOPK_ROUNDS + 1
        if launches != only(assign_topk=n):
            raise AssertionError(f"{launches} launches in {n} refreshes (want assign_topk once a "
                                 "refresh and no other kernel)")
        if any(rec["telemetry"].get("scan_topk") != TOPK_K for rec in batches):
            raise AssertionError("a record's telemetry is not the top-K rung's")
        # a ring recorded on topk replays on steady (BST_SCAN_TOPK unset: the
        # serial kernel) and cpu-ladder; a serial-recorded ring on topk
        replays, replay_ms = topk_replays(batches, (
            ("steady", len(batches), ("cuda_kernel", 0, 0)),
            ("cpu-ladder", AUDIT_CPU_REPLAYS, ("plain", 0, 0))))
        if replays != only(assign_scan=len(batches)):
            raise AssertionError(f"steady replays launched {replays}")
        _, _, _, serial_launches, _, _, _, serial_batches = topk_ring(
            os.path.join(tmp, "serial"), None, TOPK_SERIAL_ROUNDS)
        if serial_launches != only(assign_scan=TOPK_SERIAL_ROUNDS + 1):
            raise AssertionError(f"serial ring launched {serial_launches}")
        topk_replay, topk_replay_ms = topk_replays(serial_batches, (
            ("topk", len(serial_batches), ("cuda_kernel", TOPK_WAVE, TOPK_K)),))
        if topk_replay != only(assign_topk=len(serial_batches)):
            raise AssertionError(f"topk replays launched {topk_replay}")
    whatif_launches, whatif = whatif_topk(cluster, cache)
    # the kernel on the last batch's inputs: timed against the plain version
    # and the wave kernel in turns (launches restored)
    saved = read_counts()
    run = lambda: assign_gangs_topk_cuda(*args, TOPK_WAVE, TOPK_K)  # noqa: E731
    wave_run = lambda: assign_gangs_wave_cuda(*args, TOPK_WAVE)  # noqa: E731
    wave_ms = [cuda_ms(wave_run, 20)]
    ms = [cuda_ms(run, 20), cuda_ms(run, 20)]
    wave_ms.append(cuda_ms(wave_run, 20))
    plain_ms = cuda_ms(lambda: assign_gangs_topk(*args, wave=TOPK_WAVE, k=TOPK_K,
                                                 with_stats=True), 1)
    restore_counts(saved)
    from batch_scheduler_tpu_torch.ops.bounds import topk_bound

    bound_ms, bound_by, nbytes, ops = topk_bound(*args, TOPK_WAVE, out[3])
    plan = topk_scan_plan(args[0].shape[0], args[0].shape[1], TOPK_WAVE, TOPK_K, 0)
    conflicts, megas, dem = series(out[3])
    results["assign_topk"] = {
        "launches": n,
        "launches_by_path": {"north_star_topk": n, "north_star_topk_replays": topk_replay[
            "assign_topk"], "whatif_topk": whatif_launches["assign_topk"]},
        "max_abs_err": err, "matched": True, "ms": min(ms), "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "cluster_blocks": plan.cluster_blocks, "leftover": plan.leftover,
        "us_per_wave": min(ms) * 1e3 / len(conflicts),
    }
    timed = slice(2, None)
    return {
        "shape": list(scorer.snapshot.shape), "k": TOPK_K, "wave": TOPK_WAVE,
        "refreshes": n, "launches": launches,
        "refresh_ms_median": statistics.median(refresh_s[timed]) * 1e3,
        "refresh_ms": [t * 1e3 for t in refresh_s[timed]],
        "device_batch_ms_median": statistics.median(scorer.batch_seconds[timed]) * 1e3,
        "telemetry": dict(scorer.last_telemetry),
        "series_last_batch": {"waves": len(conflicts), "replayed": sum(conflicts),
                              "uniform": sum(megas), "demotions": sum(dem)},
        "kernel_ms": ms, "wave_kernel_ms_same_inputs": wave_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "int_ops": ops,
        "plan": plan._asdict(), "max_abs_err": err, "plans_equal_serial": True,
        "replays": {"topk_ring": replay_ms, "serial_ring_on_topk": topk_replay_ms},
        "whatif": whatif,
    }



# -- the scheduler loop (framework/, plugin/, controller/, client/, sim/) ----
# BASELINE config 6 as benchmarks/ladder.py:469 builds it: 5,000 nodes of
# 64 cpu / 256Gi / 110 pods / 8 GPUs, 1,000 gangs x 10 pods of 4 cpu / 8 GiB
# / 1 GPU, through SimCluster(scorer="oracle", device="cuda") with the
# ladder's settings (ladder.py:506-526) and its interpreter posture for the
# measured window (the 20 ms GIL switch interval; ladder.py:622-631's GC
# thresholds and freeze, the reference's utils/runtime_tuning.py values)
FRAMEWORK_SHAPE = (5000, 1000, 10)  # nodes, gangs, members
FRAMEWORK_SETTINGS = {"bind_workers": 16, "kubelet_start_delay": 0.05, "backoff_base": 0.5,
                      "backoff_cap": 5.0, "controller_resync_seconds": 2.0,
                      "min_batch_interval": 1.0, "oracle_background_refresh": True}
FRAMEWORK_SWITCH_INTERVAL = 0.02
FRAMEWORK_SAMPLE_S = 0.25  # the bound-gang sampler's period in the window
FRAMEWORK_STACK_S = 0.005  # the stack sampler's period (the profiled second flood)
FRAMEWORK_PROFILED_GANGS = 200  # a second flood of new gangs, under the profiler
FRAMEWORK_TIMEOUT = 300.0


def framework_nodes(num_nodes):
    from batch_scheduler_tpu_torch.sim.scenarios import make_sim_node

    return [make_sim_node(f"n{i:05d}", {"cpu": "64", "memory": "256Gi", "pods": "110",
                                        GPU: "8"}) for i in range(num_nodes)]


def framework_gangs(cluster, names, members):
    """PodGroups with the spec-level member shape (their demand rows are
    real before any pod arrives) and recent creation stamps in order (an
    epoch-old stamp trips the controller's 48 h GC horizon); returns the
    member pods' documents, serialized here, outside any clock."""
    from batch_scheduler_tpu_torch.api.types import to_dict
    from batch_scheduler_tpu_torch.sim.scenarios import make_member_pods, make_sim_group

    base_ts = time.time() - len(names) * 1e-3
    docs = []
    for g, name in enumerate(names):
        pg = make_sim_group(name, members, creation_ts=base_ts + g * 1e-3)
        pg.spec.min_resources = {"cpu": 4000, "memory": 8 * 1024**3, GPU: 1}
        cluster.create_group(pg)
        docs += [to_dict(p) for p in
                 make_member_pods(name, members, {"cpu": "4", "memory": "8Gi", GPU: "1"})]
    return docs


def phases_settled(cluster, timeout=60.0):
    """The controller's ""->Pending sweep over every PodGroup done."""
    return cluster.wait_for(lambda: all((pg.get("status") or {}).get("phase")
                                        for pg in cluster.api.list("PodGroup")),
                            timeout=timeout, interval=0.05)


class BoundSampler:
    """Every FRAMEWORK_SAMPLE_S, one pass over the API server's pod store
    under its lock (a bind_many commits under the same lock): the gangs
    with some but not all members bound. Such a gang must already be
    released (``released(gang)``: its whole quorum permitted, the status
    cache's flag that precedes every bind) — the all-or-nothing rule. A
    gang the fast lane admits binds in one bind_many and is never seen
    part-bound; one that took the per-pod path (its members arrived apart)
    binds member by member after its release, as in the reference, and is
    counted in ``mid_bind``. Sample passes are timed."""

    def __init__(self, api, members, released):
        import threading

        self.api, self.members, self.released = api, members, released
        self.samples, self.partial, self.mid_bind, self.seconds = 0, [], 0, 0.0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="bound-sampler", daemon=True)

    def sample(self):
        from batch_scheduler_tpu_torch.utils.labels import POD_GROUP_LABEL

        t0 = time.perf_counter()
        bound = {}
        with self.api._lock:
            for d in self.api._kind_store("Pod").values():
                gang = ((d.get("metadata") or {}).get("labels") or {}).get(POD_GROUP_LABEL)
                if gang and (d.get("spec") or {}).get("node_name"):
                    bound[gang] = bound.get(gang, 0) + 1
        self.seconds += time.perf_counter() - t0
        self.samples += 1
        part = [(g, n) for g, n in bound.items() if n % self.members]
        self.mid_bind += len(part)
        self.partial += [(g, n) for g, n in part if not self.released(g)]
        return bound

    def _run(self):
        while not self._stop.wait(FRAMEWORK_SAMPLE_S):
            self.sample()

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


class StackSampler:
    """Report-only host profile of a window: every FRAMEWORK_STACK_S, every
    thread's current frame (``sys._current_frames``). A thread whose
    innermost frame is a wait (a lock, a condition, a queue, a sleep, a
    poll) counts as parked; a running one is charged to its innermost
    frame in the port's package, by thread group (the name without its
    index) and by function. The sampler holds the interpreter lock while
    it reads the frames, so the window runs a little slower under it."""

    PARKED = {"wait", "get", "sleep", "select", "acquire", "poll", "join", "accept",
              "_wait_for_tstate_lock", "wait_for", "readinto", "recv", "recv_into"}
    # a C call (time.sleep, Lock.acquire) leaves no Python frame: read the
    # innermost frame's current line
    # (and a thread blocked entering ``with self._lock:`` shows that line;
    # one entering ``with self._cond:`` shows Condition.__enter__'s)
    PARKED_LINE = (r"(sleep\(|\.wait\(|\.get\(timeout|\.get\(\)|select\(|\.acquire\(|"
                   r"\.join\(|\.recv|^\s*with [\w.]*(lock|_cond)\w*:|"
                   r"return self\._lock\.__enter__\(\))")

    def __init__(self):
        import threading

        self.samples = 0
        self.by_thread, self.by_function = {}, {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="stack-sampler", daemon=True)

    def _run(self):
        import linecache
        import re
        import threading

        parked_line = re.compile(self.PARKED_LINE)
        me = threading.get_ident()
        while not self._stop.wait(FRAMEWORK_STACK_S):
            names = {t.ident: re.sub(r"[-_]?\d+$", "", t.name) for t in threading.enumerate()}
            self.samples += 1
            for ident, frame in sys._current_frames().items():
                if ident == me or ident not in names:
                    continue
                group = names[ident]
                running = frame.f_code.co_name not in self.PARKED and not parked_line.search(
                    linecache.getline(frame.f_code.co_filename, frame.f_lineno))
                row = self.by_thread.setdefault(group, [0, 0])
                row[0] += 1
                row[1] += running
                if not running:
                    continue
                f = frame
                while f is not None and "batch_scheduler_tpu_torch" not in f.f_code.co_filename:
                    f = f.f_back
                if f is None:
                    continue
                mod = f.f_code.co_filename.split("batch_scheduler_tpu_torch/")[-1]
                key = f"{mod}:{f.f_code.co_name}"
                self.by_function[key] = self.by_function.get(key, 0) + 1

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()

    def report(self, top=15):
        """Running share of each thread group (sampled running / sampled),
        the samples' count, and the functions most often running."""
        return {
            "samples": self.samples,
            "running_share_by_thread": {
                g: {"running": r, "sampled": n, "share": r / n if n else 0.0}
                for g, (n, r) in sorted(self.by_thread.items(), key=lambda kv: -kv[1][1])},
            "top_running_functions": sorted(self.by_function.items(),
                                            key=lambda kv: -kv[1])[:top],
        }


def framework_series():
    """The scheduler loop's series in the port's DEFAULT_REGISTRY: the
    cycle histogram's count and sum, the plugin's extension points' counts
    and sums by point, and the bind / release / error / preemption
    counters by label set."""
    from batch_scheduler_tpu_torch.utils.metrics import DEFAULT_REGISTRY

    out = {}
    for name in ("bst_schedule_cycle_seconds", "bst_extension_point_seconds",
                 "bst_gang_ttp_seconds"):
        m = DEFAULT_REGISTRY.get(name)
        out[name] = {} if m is None else {
            ",".join(f"{k}={v}" for k, v in key): (snap[2], snap[1])
            for key, snap in m.snapshots().items()}
    for name in ("bst_pods_bound_total", "bst_gang_releases_total", "bst_cycle_errors_total",
                 "bst_preemptions_total"):
        m = DEFAULT_REGISTRY.get(name)
        out[name] = {} if m is None else {
            ",".join(f"{k}={v}" for k, v in key): v for key, v in m.values().items()}
    return out


def framework_delta(before, after):
    """Counts (and histogram sums) that moved between two reads."""
    out = {}
    for name, now in after.items():
        moved = {}
        for key, v in now.items():
            was = before[name].get(key, (0, 0.0) if isinstance(v, tuple) else 0)
            if isinstance(v, tuple):
                if v[0] != was[0]:
                    moved[key] = (v[0] - was[0], v[1] - was[1])
            elif v != was:
                moved[key] = v - was
        out[name] = moved
    return out


def traced_cycle(cluster):
    """One gang (2 members of the config's shape) whose first member arrives
    alone, traced at sample 1.0: its cycle's root span ``schedule_cycle``
    with the reference's children pre_filter, gang_transaction (the
    partial arrival falls through) and select_node in that order (the
    member parks in Permit); then the second member completes the gang.
    Returns the cycle's (name, parent name) pairs in start order."""
    from batch_scheduler_tpu_torch.api.types import to_dict
    from batch_scheduler_tpu_torch.sim.scenarios import make_member_pods, make_sim_group
    from batch_scheduler_tpu_torch.utils import trace

    pg = make_sim_group("traced", 2, creation_ts=time.time())
    pg.spec.min_resources = {"cpu": 4000, "memory": 8 * 1024**3, GPU: 1}
    cluster.create_group(pg)
    if not cluster.wait_for(lambda: cluster.runtime.operation.status_cache.get(
            "default/traced") is not None, timeout=30.0):
        raise AssertionError("traced gang never reached the status cache")
    pods = make_member_pods("traced", 2, {"cpu": "4", "memory": "8Gi", GPU: "1"})
    trace.configure(enabled=True, sample=1.0)
    try:
        trace.DEFAULT_RECORDER.clear()
        cluster.create_pod_docs([to_dict(pods[0])])
        if not cluster.wait_for(lambda: len(cluster.scheduler.waiting) >= 1, timeout=30.0):
            raise AssertionError("the traced member never parked in Permit")
        events = trace.DEFAULT_RECORDER.snapshot()
    finally:
        trace.configure(enabled=False)
    cluster.create_pod_docs([to_dict(pods[1])])
    if not cluster.wait_for_bound("traced", 2, timeout=30.0):
        raise AssertionError("the traced gang did not bind")
    roots = [e for e in events if e["name"] == "schedule_cycle"
             and e["args"].get("pod") == pods[0].metadata.name]
    if not roots:
        raise AssertionError("no schedule_cycle root for the traced member")
    root = roots[-1]
    tid = root["args"].get("trace_id")
    spans = sorted((e for e in events if e["args"].get("trace_id") == tid),
                   key=lambda e: e["ts"])
    return span_tree(spans), [e["name"] for e in spans
                              if e["args"].get("parent_id") == root["args"]["span_id"]]


def drive_framework_e2e(wave, shape):
    """Config 6 through the port's scheduler loop on the card (see the
    module docstring). Returns (launches of the main path, report)."""
    import gc

    import torch

    from batch_scheduler_tpu_torch.api.types import PodGroupPhase
    from batch_scheduler_tpu_torch.ops.oracle import inflight_batches
    from batch_scheduler_tpu_torch.sim import SimCluster
    from batch_scheduler_tpu_torch.utils.health import DEFAULT_HEALTH
    from batch_scheduler_tpu_torch.utils.lifecycle import DEFAULT_LEDGER
    from batch_scheduler_tpu_torch.utils.metrics import DEFAULT_REGISTRY
    from batch_scheduler_tpu_torch.utils.runtime_tuning import apply_gc_tuning, freeze_startup

    num_nodes, num_groups, members = shape
    total = num_groups * members
    marks = {}
    t_setup = time.perf_counter()
    with scan_wave_env(wave):
        cluster = SimCluster(scorer="oracle", device="cuda", **FRAMEWORK_SETTINGS)
        try:
            op = cluster.runtime.operation
            if op.oracle.device.type != "cuda":
                raise AssertionError(f"scorer on {op.oracle.device}")
            cluster.add_nodes(framework_nodes(num_nodes))
            names = [f"gang-{g:04d}" for g in range(num_groups)]
            docs = framework_gangs(cluster, names, members)
            cluster.start()
            if not phases_settled(cluster):
                raise AssertionError("controller phase sweep did not finish")
            marks["setup_s"] = time.perf_counter() - t_setup
            # the main path's counts zeroed just before the standing batch,
            # read just after the flood
            zero_counts()
            batches0 = op.oracle.batches_run
            t_standing = time.perf_counter()
            op.oracle.ensure_fresh(cluster.cluster, op.status_cache)
            torch.cuda.synchronize()
            standing_s = time.perf_counter() - t_standing
            batches_prewarm = op.oracle.batches_run
            series0 = framework_series()
            stats0 = dict(cluster.scheduler.stats)
            cyc = DEFAULT_REGISTRY.histogram("bst_schedule_cycle_seconds")
            cyc0 = cyc.snapshot()
            prev_switch = sys.getswitchinterval()
            prev_gc = gc.get_threshold()
            # the CLI's runtime tuning (cmd.main: GC thresholds, then the
            # freeze after warmup), undone after the window
            apply_gc_tuning()
            freeze_startup()
            sys.setswitchinterval(FRAMEWORK_SWITCH_INTERVAL)
            try:
                def released(gang):
                    pgs = op.status_cache.get(f"default/{gang}")
                    return pgs is not None and pgs.scheduled

                with BoundSampler(cluster.api, members, released) as sampler:
                    t0 = time.perf_counter()
                    cluster.create_pod_docs(docs)
                    ok = cluster.wait_for(lambda: cluster.scheduler.stats["binds"] >= total,
                                          timeout=FRAMEWORK_TIMEOUT, interval=0.02)
                    elapsed = time.perf_counter() - t0
            finally:
                sys.setswitchinterval(prev_switch)
                gc.set_threshold(*prev_gc)
                gc.unfreeze()
            if not ok:
                raise AssertionError(f"{cluster.scheduler.stats['binds']}/{total} pods bound "
                                     f"in {elapsed:.1f}s")
            # a background refresh still in flight belongs to the main path
            bg = getattr(op.oracle, "_bg_thread", None)
            if bg is not None:
                bg.join(60.0)
            torch.cuda.synchronize()
            launches = read_counts()
            batches = op.oracle.batches_run
            stats = {k: v - stats0.get(k, 0) for k, v in cluster.scheduler.stats.items()}
            series = framework_delta(series0, framework_series())
            cyc1 = cyc.snapshot()
            ostats = op.oracle.stats()
            # the last batch's inputs: the kernel against the plain scan
            args = scan_inputs(op.oracle.snapshot.device_args())
            saved = read_counts()
            if wave:
                err, equal, _, _ = compare_wave(args, wave)
            else:
                err, equal = compare_scan(args)
            restore_counts(saved)
            if not equal:
                raise AssertionError(f"last batch: kernel disagrees with the plain scan "
                                     f"(max abs err {err})")
            final = sampler.sample()
            if not cluster.wait_for(lambda: all(
                    (pg.get("status") or {}).get("phase") == PodGroupPhase.RUNNING.value
                    for pg in cluster.api.list("PodGroup")), timeout=120.0, interval=0.2):
                raise AssertionError("not every gang reached Running")
            ledger = DEFAULT_LEDGER.snapshot()["gangs"]
            kinds = {}
            for view in ledger.values():
                for kind in {e["event"] for e in view["events"]}:
                    kinds[kind] = kinds.get(kind, 0) + 1
            # the verdict /debug/health serves: the model's rolling window
            # (BST_SLO_WINDOW_S, 300 s) ending now, the flood included.
            # Not re-baselined at the run's start: a p95 over the window's
            # 1-4 refreshes alone is its maximum, which one pack starved by
            # the window's busy threads decides
            health = DEFAULT_HEALTH.evaluate()
            # the settled state refreshed once more (a fold of the events
            # since the last pack) against its full pack; a controller
            # resync landing between the two reads is retried once
            for _ in range(2):
                with op.oracle._refresh_lock:
                    op.oracle.refresh(cluster.cluster, op.status_cache)
                fold_check = {"outcome": op.oracle.last_fold_outcome,
                              "diff": full_pack_diff(op.oracle, cluster.cluster,
                                                     op.status_cache)}
                if not fold_check["diff"]:
                    break
            # a second flood of new gangs under the profiler: new demand
            # rows (the blocking refresh on the card), the same loop
            saved = read_counts()
            zero_counts()
            more = framework_gangs(cluster, [f"more-{g:04d}" for g in
                                             range(FRAMEWORK_PROFILED_GANGS)], members)
            if not phases_settled(cluster):
                raise AssertionError("controller phase sweep (second flood) did not finish")
            target = total + FRAMEWORK_PROFILED_GANGS * members
            b_prof = op.oracle.batches_run

            def flood():
                cluster.create_pod_docs(more)
                if not cluster.wait_for(lambda: cluster.scheduler.stats["binds"] >= target,
                                        timeout=FRAMEWORK_TIMEOUT, interval=0.02):
                    raise AssertionError("second flood not bound")

            # the profiler's own overhead stretches this flood's host times:
            # its refreshes stay out of the registry (recording_off), so
            # the health model's pack signal never reads them
            with StackSampler() as stacks, recording_off():
                profiled = profile_window(flood, "profiled_flood_ms")
            profiled["host_stacks"] = stacks.report()
            profiled["batches"] = op.oracle.batches_run - b_prof
            profiled["pods"] = FRAMEWORK_PROFILED_GANGS * members
            profiled["launches"] = read_counts()
            restore_counts(saved)
            spans, children = traced_cycle(cluster)
        finally:
            cluster.stop()
    if inflight_batches() != 0:
        raise AssertionError(f"{inflight_batches()} batches still in flight after stop")
    kernel = "assign_wave" if wave else "assign_scan"
    if launches != only(**{kernel: batches - batches0}) or not launches[kernel]:
        raise AssertionError(f"{launches} launches in {batches - batches0} batches "
                             f"(want {kernel} once a batch, no other kernel)")
    if profiled["launches"] != only(**{kernel: profiled["batches"]}):
        raise AssertionError(f"profiled flood: {profiled['launches']} launches in "
                             f"{profiled['batches']} batches")
    if fold_check["diff"]:
        raise AssertionError(f"the settled refresh ({fold_check['outcome']}) differs from "
                             f"the full pack: {fold_check['diff']}")
    if len(final) != num_groups or any(n != members for n in final.values()):
        raise AssertionError("the final sample is not every gang whole")
    if sampler.partial:
        raise AssertionError(f"gangs partly bound before their release: {sampler.partial[:5]}")
    for kind in ("arrival", "admitted", "bind"):
        if kinds.get(kind) != num_groups:
            raise AssertionError(f"ledger: {kinds.get(kind)} gangs with a {kind} event "
                                 f"(want {num_groups})")
    cycles = cyc1[2] - cyc0[2]
    if cycles != stats["cycles"]:
        raise AssertionError(f"bst_schedule_cycle_seconds counted {cycles} cycles, "
                             f"the scheduler ran {stats['cycles']}")
    points = {k.split("=", 1)[1]: v for k, v in
              series["bst_extension_point_seconds"].items()}
    if series["bst_pods_bound_total"] != {"": stats["binds"]}:
        raise AssertionError(f"bst_pods_bound_total {series['bst_pods_bound_total']} "
                             f"(binds {stats['binds']})")
    if points.get("preFilter", (0, 0))[0] != stats["cycles"]:
        raise AssertionError(f"preFilter observed {points.get('preFilter')} "
                             f"in {stats['cycles']} cycles")
    want_children = ["pre_filter", "gang_transaction", "select_node"]
    if children[:3] != want_children:
        raise AssertionError(f"traced cycle's children {children} (want {want_children} first)")
    if health.get("verdict") != "ok":
        bad = {k: v for k, v in health.get("signals", {}).items() if v.get("verdict") != "ok"}
        raise AssertionError(f"health verdict {health.get('verdict')}: {json.dumps(bad)[:800]}; "
                             f"wall {elapsed:.3f} s, pack s {op.oracle.pack_seconds}, "
                             f"batch s {op.oracle.batch_seconds}, cycles {stats['cycles']}")
    ext = lambda p: points.get(p, (0, 0.0))[1]  # noqa: E731
    report = {
        "nodes": num_nodes, "gangs": num_groups, "pods": total, "wave": wave,
        "wall_clock_s": elapsed, "pods_per_sec": total / max(elapsed, 1e-9),
        "standing_batch_s": standing_s, "binds": stats["binds"],
        "oracle_batches": batches - batches0,
        "oracle_batches_in_window": batches - batches_prewarm,
        "gil_switch_interval_s": FRAMEWORK_SWITCH_INTERVAL,
        "cycle_breakdown": {
            "cycle_p50_ms": cyc.quantile(0.5, since=cyc0) * 1e3,
            "cycle_p95_ms": cyc.quantile(0.95, since=cyc0) * 1e3,
            "cycle_total_s": cyc1[1] - cyc0[1], "cycles": cycles,
            "prefilter_total_s": ext("preFilter"), "permit_total_s": ext("permit"),
            "postbind_total_s": ext("postBind"),
        },
        "unschedulable_retries": stats["unschedulable"],
        "permit_rejects": stats["permit_rejects"], "permit_waits": stats["permit_waits"],
        "fold_outcomes": ostats["fold_outcomes"], "launches_by_kernel": launches,
        "oracle_stats": {"batch_ms": [t * 1e3 for t in op.oracle.batch_seconds],
                         "pack_ms": [t * 1e3 for t in op.oracle.pack_seconds],
                         "spec_served": ostats.get("spec_served"),
                         "device_state": ostats["device_state"]},
        "kernel_vs_plain_equal": equal, "max_abs_err": err,
        "settled_refresh": fold_check,
        "bound_samples": sampler.samples, "partly_bound_unreleased": 0,
        "mid_bind_gangs_seen": sampler.mid_bind,
        "sampler_ms_total": sampler.seconds * 1e3,
        "ledger_gangs_by_event": kinds, "health": health.get("verdict"),
        "series": series, "traced_cycle": {"spans": spans, "root_children": children},
        "profiled_flood": profiled, "setup_s": marks["setup_s"],
    }
    return launches, report


@phase("framework_e2e")
def framework_e2e(results):
    """Config 6 through SimCluster on the card, serial kernel."""
    launches, report = drive_framework_e2e(None, FRAMEWORK_SHAPE)
    FIGURES["framework_e2e_wall_s"] = report["wall_clock_s"]
    if "assign_scan" in results:
        results["assign_scan"]["launches_by_path"]["framework_e2e"] = launches["assign_scan"]
        results["assign_scan"]["launches_by_path"]["framework_e2e_profiled"] = \
            report["profiled_flood"]["launches"]["assign_scan"]
    return report


@phase("framework_e2e_wave")
def framework_e2e_wave(results):
    """Config 6 through SimCluster on the card with BST_SCAN_WAVE=8."""
    launches, report = drive_framework_e2e(8, FRAMEWORK_SHAPE)
    if "assign_wave" in results:
        results["assign_wave"]["launches_by_path"]["framework_e2e_wave"] = \
            launches["assign_wave"]
        results["assign_wave"]["launches_by_path"]["framework_e2e_wave_profiled"] = \
            report["profiled_flood"]["launches"]["assign_wave"]
    return report


def sim_cluster(**kwargs):
    from batch_scheduler_tpu_torch.sim import SimCluster

    c = SimCluster(scorer="oracle", device="cuda", **kwargs)
    if c.runtime.operation.oracle.device.type != "cuda":
        raise AssertionError(f"scorer on {c.runtime.operation.oracle.device}")
    return c


def bound_of(c, gang):
    return sorted(p.spec.node_name for p in c.member_pods(gang) if p.spec.node_name)


def manifest(name):
    """(nodes, groups, pods) of ``examples/<name>.yaml`` through the port's
    manifest loader (api/manifest.py), as ``sim -f`` reads it."""
    from batch_scheduler_tpu_torch.api.manifest import load_manifest_file
    from batch_scheduler_tpu_torch.api.types import Node, Pod, PodGroup

    objs = load_manifest_file(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                           "examples", f"{name}.yaml"))
    return ([o for o in objs if isinstance(o, Node)],
            [o for o in objs if isinstance(o, PodGroup)],
            [o for o in objs if isinstance(o, Pod)])


def run_manifest(name, extra_nodes=(), wait_running=()):
    """``examples/<name>.yaml`` (plus ``extra_nodes``) through a
    SimCluster on the card: every gang named in ``wait_running`` waited
    for until Running. Returns (cluster, [all Running])."""
    from batch_scheduler_tpu_torch.api.types import PodGroupPhase

    nodes, groups, pods = manifest(name)
    c = sim_cluster()
    c.add_nodes(nodes + list(extra_nodes))
    for pg in groups:
        c.create_group(pg)
    c.start()
    c.create_pods(pods)
    ok = [c.wait_for_group_phase(g, PodGroupPhase.RUNNING, timeout=60.0) for g in wait_running]
    return c, all(ok)


def scenario_race():
    """README race (examples/race.yaml): one gang of five binds, the other
    binds nothing."""
    c, ok = run_manifest("race", wait_running=("web-group-race1",))
    try:
        denied = c.wait_for(lambda: c.scheduler.stats["unschedulable"] >= 1, timeout=60.0)
        out = {"race1": bound_of(c, "web-group-race1"), "race2": bound_of(c, "web-group-race2"),
               "race1_phase": c.group_phase("web-group-race1").value,
               "race2_phase": c.group_phase("web-group-race2").value}
    finally:
        c.stop()
    # read after stop: a retrying denied gang may still be refreshing
    out["batches"] = c.runtime.operation.oracle.batches_run
    if not (ok and denied) or len(out["race1"]) != 5 or out["race2"]:
        raise AssertionError(f"race: {out}")
    return out


def scenario_example1():
    """examples/example1.yaml with ``--nodes 4 --node-cpu 4`` (the CLI's
    synthetic nodes): a gang of 9 one-cpu pods across four 4-cpu nodes."""
    from batch_scheduler_tpu_torch.sim.scenarios import make_sim_node

    extra = [make_sim_node(f"sim-node-{i:04d}", {"cpu": "4", "memory": "128Gi", "pods": "110"})
             for i in range(4)]
    c, ok = run_manifest("example1", extra, wait_running=("group1",))
    try:
        out = {"bound": bound_of(c, "group1"), "phase": c.group_phase("group1").value}
    finally:
        c.stop()
    out["batches"] = c.runtime.operation.oracle.batches_run
    if not ok or len(out["bound"]) != 9:
        raise AssertionError(f"example1: {out}")
    return out


def scenario_zones():
    """examples/zones.yaml: the east-pinned gang lands entirely on east-1
    although west-1 has more room; the free gang takes what fits."""
    c, ok = run_manifest("zones", wait_running=("pinned-east", "free-roam"))
    try:
        out = {"pinned-east": bound_of(c, "pinned-east"), "free-roam": bound_of(c, "free-roam")}
    finally:
        c.stop()
    out["batches"] = c.runtime.operation.oracle.batches_run
    if not ok or out["pinned-east"] != ["east-1"] * 3 or len(out["free-roam"]) != 4:
        raise AssertionError(f"zones: {out}")
    return out


def scenario_spot_vs_guaranteed():
    """spot_vs_guaranteed_scenario with BST_POLICY set: the spot gangs fill
    the cluster, the guaranteed gang is denied, and the scheduler's own
    preemption commit (_policy_preempt: the victim plan on the card, the
    live re-verification, _evict_gang_plan: eviction, note_gang_evicted,
    the respawn) places it."""
    from batch_scheduler_tpu_torch.sim.scenarios import spot_vs_guaranteed_scenario
    from batch_scheduler_tpu_torch.utils.lifecycle import DEFAULT_LEDGER
    from batch_scheduler_tpu_torch.utils.metrics import DEFAULT_REGISTRY

    preempts = DEFAULT_REGISTRY.counter("bst_preemptions_total", "")
    before = preempts.value(reason="priority-tier")
    with env_set(POLICY_ENV):
        c = sim_cluster(kubelet_start_delay=0.01)
        try:
            if c.runtime.operation.preempt_planner is None:
                raise AssertionError("BST_POLICY did not arm the preemption planner")
            nodes, groups, pods = spot_vs_guaranteed_scenario()
            c.add_nodes(nodes)
            spot = [g.metadata.name for g in groups if g.metadata.name.startswith("spot")]
            for g in groups:
                if g.metadata.name in spot:
                    c.create_group(g)
            c.start()
            for name in spot:
                c.create_pods(pods[name])
            spot_ok = all(c.wait_for_bound(name, 4, timeout=120.0) for name in spot)
            uids = {name: {p.metadata.uid for p in c.member_pods(name)} for name in spot}
            for g in groups:
                if g.metadata.name.startswith("guaranteed"):
                    c.create_group(g)
            c.create_pods(pods["guaranteed-000"])
            ok = c.wait_for_bound("guaranteed-000", 4, timeout=120.0)

            def evicted_respawned():
                return [g for g, tv in DEFAULT_LEDGER.snapshot()["gangs"].items()
                        if {"evicted", "respawn"} <= {e["event"] for e in tv["events"]}]

            respawn_seen = c.wait_for(lambda: bool(evicted_respawned()), timeout=30.0)
            respawned = [name for name in spot
                         if not ({p.metadata.uid for p in c.member_pods(name)} & uids[name])]
            out = {"spot_bound_first": spot_ok, "guaranteed": bound_of(c, "guaranteed-000"),
                   "preemptions": c.scheduler.stats["preemptions"],
                   "priority_tier_preemptions": preempts.value(reason="priority-tier") - before,
                   "respawned_gangs": respawned, "ledger_evicted_respawn": evicted_respawned(),
                   "telemetry": dict(c.runtime.operation.oracle.last_telemetry or {})}
        finally:
            c.stop()
        # read after stop: the respawned spot gang retries (and refreshes)
        # until the scheduler stops
        out["batches"] = c.runtime.operation.oracle.batches_run
    if not (spot_ok and ok and respawn_seen) or out["preemptions"] < 1 \
            or out["priority_tier_preemptions"] < 1 or not respawned \
            or not out["telemetry"].get("scan_policy"):
        raise AssertionError(f"spot_vs_guaranteed: {out}")
    return out



LOCKCHECK_SIM_SHAPE = (200, 40)  # the seeded cluster: nodes, gangs


def settled_start(cluster):
    """SimCluster.start() with the scheduler held back: informers, plugin
    runtime and kubelet started, caches synced and the controller's
    ""->Pending sweep done; the caller queues pods and then starts
    ``cluster.scheduler`` (each pod's queue key then sees its group)."""
    cluster._started = True
    cluster._fwk_informers.start()
    cluster.runtime.start()
    cluster.kubelet.start()
    cluster._fwk_informers.wait_for_cache_sync()
    cluster.runtime.informers.wait_for_cache_sync()
    cluster._wait_for_status_cache()
    if not phases_settled(cluster):
        raise AssertionError("controller phase sweep did not finish")


def seeded_sim_cluster(cluster, num_nodes, num_gangs, seed=5):
    """A seeded cluster (3 node shapes, 3 zones; gangs of 2-11 members of
    1-3 cpu, a third pinned to a zone, a third at priority 1), every pod
    queued before the scheduler starts; returns the pod count."""
    import random

    from batch_scheduler_tpu_torch.sim.scenarios import (
        make_member_pods, make_sim_group, make_sim_node)

    rng = random.Random(seed)
    cluster.add_nodes([make_sim_node(f"s{i:03d}", {"cpu": rng.choice(["4", "8", "16"]),
                                                   "memory": "64Gi", "pods": "110"},
                                     labels={"zone": rng.choice(["a", "b", "c"])})
                       for i in range(num_nodes)])
    base_ts = time.time() - 1.0
    pods = []
    for g in range(num_gangs):
        members, cpu = rng.randrange(2, 12), rng.choice(["1", "2", "3"])
        zone, prio = rng.choice(["", "", "a"]), rng.choice([0, 0, 1])
        cluster.create_group(make_sim_group(f"sg{g:02d}", members,
                                            creation_ts=base_ts + g * 1e-3))
        for p in make_member_pods(f"sg{g:02d}", members, {"cpu": cpu, "memory": "1Gi"},
                                  priority=prio):
            if zone:
                p.spec.node_selector = {"zone": zone}
            pods.append(p)
    settled_start(cluster)
    cluster.create_pods(pods)
    if not cluster.wait_for(lambda: len(cluster.scheduler.queue) == len(pods), timeout=60.0):
        raise AssertionError("pods not queued")
    cluster.scheduler.start()
    return len(pods)


def lockcheck_sims():
    """The scheduler loop under the lock checker: the README race, then the
    seeded 200-node x 40-gang cluster with the background refresh, the
    1 s batch interval and dispatch-ahead on, through
    SimCluster(device="cuda"). Returns (report, batches)."""
    from batch_scheduler_tpu_torch.ops.oracle import inflight_batches

    race = scenario_race()
    nodes, gangs = LOCKCHECK_SIM_SHAPE
    c = sim_cluster(min_batch_interval=1.0, oracle_background_refresh=True,
                    oracle_dispatch_ahead=True, bind_workers=16)
    oracle = c.runtime.operation.oracle
    try:
        total = seeded_sim_cluster(c, nodes, gangs)
        ok = c.wait_for(lambda: c.scheduler.stats["binds"] >= total, timeout=120.0)
        stats = dict(c.scheduler.stats)
    finally:
        c.stop()  # drains the background and speculative batches
    if not ok:
        raise AssertionError(f"seeded cluster: {stats}")
    if inflight_batches():
        raise AssertionError(f"{inflight_batches()} batches in flight after stop")
    # one launch a blocking refresh, one a speculative dispatch (served,
    # discarded, or collected unconsumed by the drain)
    spec = {k: getattr(oracle, k) for k in ("spec_served", "spec_discarded", "spec_dispatched")}
    launched = oracle.batches_run - spec["spec_served"] + spec["spec_dispatched"]
    return {"race": race, "seeded": {"pods": total, "stats": stats,
                                      "batches": oracle.batches_run, **spec}}, \
        race["batches"] + launched


def drive_framework_metrics():
    """The scheduler loop's series held to the run's own counts: a
    SimCluster(device="cuda") of 6 gangs of 3 that fit and one of 2 that
    fits nowhere, every pod queued before the scheduler starts, each
    whole-gang transaction committed before the next cycle
    (``FLUSH_GANGS = 1``) and a backoff past the run, so each count is
    fixed: one cycle a placed gang (the fast lane), one a denied member.
    The series' deltas must equal the scheduler's stats, six releases
    and six time-to-placement observations; the serial kernel once a
    batch. Returns (launches, report)."""
    from batch_scheduler_tpu_torch.sim.scenarios import (
        make_member_pods, make_sim_group, make_sim_node)

    c = sim_cluster(backoff_base=300.0, backoff_cap=300.0)
    try:
        c.add_nodes([make_sim_node(f"m{i}", {"cpu": "8", "memory": "32Gi", "pods": "64"})
                     for i in range(6)])
        base = time.time() - 1.0
        pods = []
        for g in range(7):
            members, cpu = (3, "2") if g < 6 else (2, "64")
            c.create_group(make_sim_group(f"fw{g}", members, creation_ts=base + g * 1e-3))
            pods += make_member_pods(f"fw{g}", members, {"cpu": cpu})
        settled_start(c)
        c.create_pods(pods)
        if not c.wait_for(lambda: len(c.scheduler.queue) == len(pods), timeout=60.0):
            raise AssertionError("pods not queued")
        c.scheduler.FLUSH_GANGS = 1
        before = framework_series()
        zero_counts()
        b0 = c.runtime.operation.oracle.batches_run
        c.scheduler.start()
        ok = c.wait_for(lambda: c.scheduler.stats["binds"] >= 18
                        and c.scheduler.stats["unschedulable"] >= 2, timeout=60.0)
        launches = read_counts()
        batches = c.runtime.operation.oracle.batches_run - b0
        stats = dict(c.scheduler.stats)
        delta = framework_delta(before, framework_series())
    finally:
        c.stop()
    if not ok:
        raise AssertionError(f"framework metrics run: {stats}")
    counts = {name: {k: (v[0] if isinstance(v, tuple) else v) for k, v in d.items()}
              for name, d in delta.items()}
    want = {
        "bst_schedule_cycle_seconds": {"": stats["cycles"]},
        "bst_pods_bound_total": {"": stats["binds"]},
        "bst_gang_releases_total": {"": 6},
        "bst_cycle_errors_total": {},
        "bst_preemptions_total": {},
    }
    bad = {n: {"recorded": counts[n], "want": w} for n, w in want.items()
           if {k: float(v) for k, v in counts[n].items()} != {k: float(v) for k, v in w.items()}}
    points = {k.split("=", 1)[1]: v for k, v in counts["bst_extension_point_seconds"].items()}
    if points.get("preFilter") != stats["cycles"] or points.get("permit") != 6:
        bad["bst_extension_point_seconds"] = {"recorded": points,
                                              "want": {"preFilter": stats["cycles"],
                                                       "permit": 6}}
    if sum(counts["bst_gang_ttp_seconds"].values()) != 6:
        bad["bst_gang_ttp_seconds"] = {"recorded": counts["bst_gang_ttp_seconds"], "want": 6}
    if stats["cycles"] != 8 or stats["binds"] != 18:
        bad["stats"] = stats
    if bad:
        raise AssertionError(f"scheduler series disagree with the run's own counts: {bad}")
    if launches != only(assign_scan=batches) or not batches:
        raise AssertionError(f"{launches} launches in {batches} batches")
    return launches, {"batches": batches, "stats": stats, "series": counts,
                      "launches_by_kernel": launches}

@phase("sim_scenarios")
def sim_scenarios(results):
    """The README's scenarios through SimCluster(device="cuda"), the first
    three read from examples/*.yaml by the port's manifest loader: each
    scenario's launches counted on its own (the policy one runs the policy
    kernel, the others the serial kernel, once a batch)."""
    out = {}
    for name, fn, kernel in (("race", scenario_race, "assign_scan"),
                             ("example1", scenario_example1, "assign_scan"),
                             ("zones", scenario_zones, "assign_scan"),
                             ("spot_vs_guaranteed", scenario_spot_vs_guaranteed,
                              "assign_policy")):
        zero_counts()
        t0 = time.perf_counter()
        report = fn()
        report["seconds"] = time.perf_counter() - t0
        launches = read_counts()
        if launches != only(**{kernel: report["batches"]}) or not report["batches"]:
            raise AssertionError(f"{name}: {launches} launches in {report['batches']} batches "
                                 f"(want {kernel} once a batch)")
        report["launches_by_kernel"] = launches
        out[name] = report
        if kernel in results:
            results[kernel]["launches_by_path"][f"sim_{name}"] = launches[kernel]
        else:
            LATE_PATHS[(kernel, f"sim_{name}")] = launches[kernel]
    return out


# ---------------------------------------------------------------------------
# the CLI (python -m batch_scheduler_tpu_torch) in child processes
# ---------------------------------------------------------------------------

CLI_FULL = ("--scenario", "synthetic", "--nodes", "5000", "--node-cpu", "64",
            "--node-memory", "256Gi", "--groups", "1000", "--members", "10",
            "--scorer", "oracle")  # BASELINE config 6's count: [1024, 8192, R]
# sim ends when every gang is terminal, or after --settle seconds with no
# change: the default 3 s ended a full-width flood on a loaded host after
# 80 binds, so the full-width runs wait 20 s before calling it settled (a
# full-width flood binds continuously: no bind for 20 s means it is done)
CLI_FULL_RUN = ("--timeout", "300", "--settle", "20")
# the full-width ring's cap: the newest ~quarter of its ~1,000 records
CLI_AUDIT_CAP_MB = "64"
CLI_FULL_NODES, CLI_FULL_GANGS, CLI_FULL_PODS = 5000, 1000, 10000
# the served, the held and the in-process runs at a quarter of config 6's
# count (the smoke's time; the cli phase's ring run keeps the full width):
# [G=256, N=2048]
CLI_QUARTER_NODES, CLI_QUARTER_GANGS, CLI_QUARTER_PODS = 1250, 250, 2500
CLI_QUARTER = ("--scenario", "synthetic", "--nodes", str(CLI_QUARTER_NODES), "--node-cpu",
               "64", "--node-memory", "256Gi", "--groups", str(CLI_QUARTER_GANGS),
               "--members", "10", "--scorer", "oracle")
CLI_QUARTER_BUCKET = "256x2048"
# a quarter run binds its 2,500 pods in a few seconds: 10 s without a change
# ends it
CLI_QUARTER_RUN = ("--timeout", "300", "--settle", "10")
CLI_TIMEOUT = 420  # seconds a child may take
CLI_EXPLAIN_GANG = "default/group-999"  # the last gang placed: in the capped ring
CLI_REPLAY_SAMPLE = 4  # records replayed in process beside the children's full replays
CLI_KNOBS = ("BST_SCAN_WAVE", "BST_SCAN_TOPK", "BST_POLICY", "BST_COORDINATOR")


def cli_env(**extra):
    """The children's environment: the smoke's, without the rung and policy
    knobs an earlier phase may have left, plus ``extra``."""
    env = {k: v for k, v in os.environ.items() if k not in CLI_KNOBS}
    env.update(extra)
    return env


def cli_start(args, env=None):
    """``python -m batch_scheduler_tpu_torch args`` started in the
    repository root; its stdout is a pipe, its stderr a temporary file (a
    long-lived child never blocks on a full pipe), both read by
    ``cli_wait``."""
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    err = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen([sys.executable, "-m", "batch_scheduler_tpu_torch", *args],
                            cwd=here, env=env or cli_env(), stdout=subprocess.PIPE,
                            stderr=err, text=True)
    proc.err_file = err
    return proc


def cli_wait(proc, timeout=CLI_TIMEOUT):
    """(exit code, stdout, stderr) of a started child; killed at the
    timeout."""
    try:
        out, _ = proc.communicate(timeout=timeout)
        timed_out = False
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        timed_out = True
    proc.err_file.seek(0)
    err = proc.err_file.read()
    proc.err_file.close()
    if timed_out:
        raise AssertionError(f"CLI child {proc.args[3:]} ran past {timeout} s: "
                             f"{err[-1500:]}")
    return proc.returncode, out, err


def cli(args, env=None, want_rc=0, timeout=CLI_TIMEOUT):
    """One CLI child run to its end; fails unless it exits ``want_rc``."""
    rc, out, err = cli_wait(cli_start(args, env), timeout)
    if want_rc is not None and rc != want_rc:
        raise AssertionError(f"`{' '.join(args)}` exited {rc} (want {want_rc}): "
                             f"{err[-1500:]} {out[-500:]}")
    return rc, out, err


def cli_json(out):
    """The JSON document a read-side command prints last (from the first
    line that opens it)."""
    lines = out.splitlines()
    for i, line in enumerate(lines):
        if line.startswith("{"):
            try:
                return json.loads("\n".join(lines[i:]))
            except ValueError:
                continue
    raise AssertionError(f"no JSON document in: {out[-800:]}")


def sim_table(out):
    """The sim table's rows: gang -> (phase, min_member, bound)."""
    rows = {}
    for line in out.splitlines():
        if line.startswith("default/"):
            f = line.split()
            rows[f[0]] = (f[1], int(f[2]), int(f[3]))
    return rows


def sim_wall(out):
    """(wall seconds, pods bound, pods/s) of the sim's ``sim wall:`` line."""
    import re

    for line in out.splitlines():
        m = re.match(r"sim wall: ([\d.]+)s .*?, (\d+) of (\d+) pods bound \(([\d.]+) pods/s\)",
                     line)
        if m:
            return float(m.group(1)), int(m.group(2)), float(m.group(4))
    raise AssertionError(f"no `sim wall:` line in: {out[-800:]}")


def read_port(proc, pattern, timeout=120.0):
    """The first match of ``pattern`` in a running child's stdout (its
    lines before it are kept in ``proc.seen``)."""
    import re

    proc.seen = getattr(proc, "seen", [])
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        proc.seen.append(line)
        m = re.search(pattern, line)
        if m:
            return m.group(1)
    raise AssertionError(f"child never printed {pattern!r}: {''.join(proc.seen)[-800:]}")


def metric_values(port, name):
    """{labels text: value} of one series on a child's /metrics."""
    status, body, _ = http_get(port, "/metrics")
    if status != 200:
        raise AssertionError(f"/metrics answered {status}")
    out = {}
    for line in body.decode().splitlines():
        if line.startswith(name + "{") or line.startswith(name + " "):
            key, _, value = line.rpartition(" ")
            out[key[len(name):]] = float(value)
    return out


def kernel_launches(port):
    """A child's launches of each kernel (``bst_kernel_launches_total``,
    counted by each wrapper where it launches)."""
    launches = only()
    for labels, v in metric_values(port, "bst_kernel_launches_total").items():
        for kernel in KERNELS:
            if f'kernel="{kernel}"' in labels:
                launches[kernel] += int(v)
    return launches


def launch_delta(before, after):
    return {k: after[k] - before[k] for k in KERNELS}


def check_readme_examples(tmp):
    """version, check-config, and the README's manifests (examples/*.yaml)
    with the README's outcomes, all started together. The race run stays
    up (``--settle 20``: its denied gang never turns terminal) so that
    ``explain`` and ``whatif --rung steady|topk`` query it live."""
    here = os.path.dirname(os.path.abspath(__file__))
    zones_audit = os.path.join(tmp, "zones-audit")
    procs = {
        "version": cli_start(["version"]),
        "check_config": cli_start(["check-config", "--config", os.path.join(
            here, "deploy", "scheduler", "config", "batch_scheduler_config.json")]),
        # --settle 10: started beside the full-width run, a child's first
        # batch can take more than 2 s, and a 2 s settle ended one before it
        "example1": cli_start(["sim", "-f", "examples/example1.yaml", "--nodes", "4",
                               "--node-cpu", "4", "--timeout", "60", "--settle", "10"]),
        "zones": cli_start(["sim", "-f", "examples/zones.yaml", "--timeout", "60",
                            "--settle", "10", "--audit-dir", zones_audit]),
        "spot_vs_guaranteed": cli_start(["sim", "--scenario", "spot-vs-guaranteed",
                                         "--timeout", "120"], cli_env(**POLICY_ENV)),
    }
    race = cli_start(["sim", "-f", "examples/race.yaml", "--timeout", "150", "--settle", "30",
                      "--metrics-port", "0"])
    port = int(read_port(race, r"metrics on :(\d+)"))
    # the race settles when race2's denial is on record
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        status, body, _ = http_get(port, "/debug/decisions?gang=default/web-group-race2")
        if status == 200 and b'"denied"' in body:
            break
        time.sleep(0.2)
    addr = f"127.0.0.1:{port}"
    live = {"explain": cli_start(["explain", "default/web-group-race2", "--addr", addr])}
    for rung in ("steady", "topk"):
        live[rung] = cli_start(["whatif", "--addr", addr, "--cordon", "node-1", "--rung", rung])
    answers = {}
    for name, proc in live.items():
        rc, out, err = cli_wait(proc)
        if rc != 0:
            raise AssertionError(f"live {name} exited {rc}: {err[-800:]} {out[-800:]}")
        answers[name] = cli_json(out)
    live_explain = answers.pop("explain")
    whatifs = answers
    report = {}
    rc, out, err = cli_wait(race)
    race_out = "".join(race.seen) + out
    report["race"] = {k: v for k, v in sim_table(race_out).items()}
    if rc != 0 or report["race"].get("default/web-group-race1", ("",))[0] != "Running" \
            or report["race"]["default/web-group-race1"][2] != 5 \
            or report["race"].get("default/web-group-race2", ("", 0, -1))[2] != 0:
        raise AssertionError(f"race: rc {rc}, {report['race']} {err[-800:]}")
    if live_explain.get("gang") != "default/web-group-race2" or "error" in live_explain:
        raise AssertionError(f"explain --addr: {live_explain}")
    plans = {r: {k: v for k, v in w.items() if k not in ("rung", "elapsed_s", "baseline_cached")}
             for r, w in whatifs.items()}
    if any("error" in w for w in whatifs.values()) or plans["steady"] != plans["topk"]:
        raise AssertionError(f"whatif steady/topk differ: {whatifs}")
    report["whatif_keys"] = sorted(whatifs["topk"])
    outs = {}
    for name, proc in procs.items():
        rc, out, err = cli_wait(proc)
        if rc != 0:
            raise AssertionError(f"{name}: exit {rc}: {err[-1500:]}")
        outs[name] = out
    if "batch-scheduler-tpu-torch v" not in outs["version"]:
        raise AssertionError(f"version: {outs['version']}")
    cfg = json.loads(outs["check_config"])
    if not cfg.get("valid") or cfg.get("scorer") != "oracle":
        raise AssertionError(f"check-config: {cfg}")
    report["example1"] = sim_table(outs["example1"])
    if report["example1"].get("default/group1") != ("Running", 9, 9):
        raise AssertionError(f"example1: {report['example1']}")
    report["zones"] = sim_table(outs["zones"])
    if report["zones"].get("default/pinned-east", ("",))[0] != "Running" \
            or report["zones"].get("default/free-roam", ("",))[0] != "Running":
        raise AssertionError(f"zones: {report['zones']}")
    report["zones_pinned_to"] = zones_pinned_to(zones_audit)
    if report["zones_pinned_to"] != ["east-1"]:
        raise AssertionError(f"zones: pinned-east planned onto {report['zones_pinned_to']}")
    report["spot_vs_guaranteed"] = spot = sim_table(outs["spot_vs_guaranteed"])
    bound = sorted(spot.get(f"default/spot-{i:03d}", ("", 0, -1))[2] for i in range(2))
    if spot.get("default/guaranteed-000") != ("Running", 4, 4) or bound != [0, 4] \
            or "'preemptions': 0" in outs["spot_vs_guaranteed"]:
        raise AssertionError(f"spot-vs-guaranteed: {spot} {outs['spot_vs_guaranteed'][-1500:]}")
    return report


def zones_pinned_to(audit_dir):
    """The nodes every recorded plan gives the pinned-east gang."""
    from batch_scheduler_tpu_torch.utils.audit import AuditReader

    nodes = set()
    for rec in AuditReader(audit_dir).batches()[0]:
        names = rec.get("names") or {}
        groups, node_names = names.get("groups") or [], names.get("nodes") or []
        if "default/pinned-east" not in groups:
            continue
        g = groups.index("default/pinned-east")
        res = rec["result_arrays"]
        for n, k in zip(res["assignment_nodes"][g], res["assignment_counts"][g]):
            if k > 0:
                nodes.add(node_names[int(n)])
    return sorted(nodes)


def full_width_sim(tmp, extra=(), env=None, tag="direct"):
    """The full-width synthetic run (5,000 nodes, 1,000 gangs x 10) with an
    audit ring, a lifecycle export and a metrics port: every gang Running
    with 10 bound. Returns its report."""
    audit, life = os.path.join(tmp, f"{tag}-audit"), os.path.join(tmp, f"{tag}-life")
    _, out, _ = cli(["sim", *CLI_FULL, *CLI_FULL_RUN, "--audit-dir", audit, "--audit-cap-mb",
                     CLI_AUDIT_CAP_MB, "--lifecycle-dir", life, "--metrics-port", "0", *extra],
                    env=env)
    rows = sim_table(out)
    wall, bound, rate = sim_wall(out)
    running = sum(1 for phase, _, b in rows.values() if phase == "Running" and b == 10)
    if len(rows) != CLI_FULL_GANGS or running != CLI_FULL_GANGS or bound != CLI_FULL_PODS:
        raise AssertionError(f"{tag}: {running} of {len(rows)} gangs Running, {bound} pods "
                             f"bound: {out[-1500:]}")
    events = os.path.join(life, "events.jsonl")
    with open(events) as f:
        lines = sum(1 for _ in f)
    if not lines:
        raise AssertionError(f"{tag}: empty lifecycle export {events}")
    return {"wall_s": wall, "pods_bound": bound, "pods_per_s": rate,
            "gangs_running": running, "lifecycle_events": lines, **oracle_stats(out),
            "phases": sorted({phase for phase, _, _ in rows.values()}),
            "audit_dir": audit, "lifecycle_dir": life}


def oracle_stats(out):
    """The batches and fold outcomes of a sim child's ``oracle stats:``
    line (and its scheduler cycles)."""
    import ast

    got = {}
    for line in out.splitlines():
        if line.startswith("oracle stats: "):
            stats = ast.literal_eval(line[len("oracle stats: "):])
            got.update(batches=stats.get("batches_run"),
                       fold_outcomes=stats.get("fold_outcomes"))
        elif line.startswith("scheduler stats: "):
            got["cycles"] = ast.literal_eval(line[len("scheduler stats: "):]).get("cycles")
    return got


def strip_ms(obj):
    """A payload without its wall-clock fields (``*_ms``, ``*seconds``)."""
    if isinstance(obj, dict):
        return {k: strip_ms(v) for k, v in obj.items()
                if not (k.endswith("_ms") or k.endswith("seconds") or k.endswith("_s"))}
    if isinstance(obj, list):
        return [strip_ms(v) for v in obj]
    return obj


def check_read_side(audit, rungs, env):
    """replay (each of ``rungs``), explain, capacity and timeline on a
    full-width run's audit ring, each a child that exits 0 and equals the
    in-process function on the same records (the replays: every record
    identical in the child, and the last ``CLI_REPLAY_SAMPLE`` records
    identical in process too)."""
    from batch_scheduler_tpu_torch.core.explain import explain_arrays
    from batch_scheduler_tpu_torch.core.oracle_scorer import replay_audit_record
    from batch_scheduler_tpu_torch.ops.capacity import capacity_summary
    from batch_scheduler_tpu_torch.utils.audit import AuditReader
    from batch_scheduler_tpu_torch.utils.lifecycle import GangLifecycleLedger

    procs = {f"replay_{r}": cli_start(["replay", audit, "--against", r], env) for r in rungs}
    procs["explain"] = cli_start(["explain", CLI_EXPLAIN_GANG, "--audit-dir", audit])
    procs["capacity"] = cli_start(["capacity", "--audit-dir", audit])
    procs["timeline"] = cli_start(["timeline", CLI_EXPLAIN_GANG, "--audit-dir", audit])
    outs = {}
    for name, proc in procs.items():
        rc, out, err = cli_wait(proc)
        if rc != 0:
            raise AssertionError(f"{name}: exit {rc}: {err[-1500:]} {out[-500:]}")
        outs[name] = cli_json(out.splitlines()[-1] if name.startswith("replay") else out)
    reader = AuditReader(audit)
    batches, _ = reader.batches()
    report = {"records": len(batches)}
    for r in rungs:
        got = outs[f"replay_{r}"]
        sample = batches[-CLI_REPLAY_SAMPLE:]
        reps = [replay_audit_record(rec, against=r, device="cuda") for rec in sample]
        if got["divergent"] or got["identical"] != len(batches) \
                or not all(rep.get("identical") for rep in reps):
            raise AssertionError(f"replay {r}: {got}; in process {reps}")
        report[f"replay_{r}"] = got["identical"]
    report["ring_bytes"] = sum(os.path.getsize(os.path.join(audit, f)) for f in os.listdir(audit))
    rec = batches[-1]
    names = rec.get("names") or {}
    want = explain_arrays(rec["batch_args"], names["groups"].index(CLI_EXPLAIN_GANG),
                          node_names=names.get("nodes"), policy=rec.get("policy_args"),
                          device="cuda")
    got = outs["explain"]
    if strip_ms(json.loads(json.dumps(want, default=str))) != strip_ms(
            {k: v for k, v in got.items() if k not in ("gang", "source")}):
        raise AssertionError(f"explain differs from explain_arrays: {got}")
    cap = outs["capacity"]
    if cap["divergent"] or cap["replayed"] != len(batches):
        raise AssertionError(f"capacity: {cap['divergent']} divergent, {cap['replayed']} "
                             f"of {len(batches)}")
    for entry, rec in zip(cap["series"], batches):
        res = rec["result_arrays"]
        want = capacity_summary(rec["batch_args"], res,
                                group_names=(rec.get("names") or {}).get("groups") or [],
                                scheduled=rec["progress_args"][1],
                                matched=rec["progress_args"][2], device="cuda")
        if json.loads(json.dumps(want, sort_keys=True)) != entry["summary"]:
            raise AssertionError(f"capacity seq {entry['seq']} differs from capacity_summary")
    report["capacity_compared"] = cap["compared"]
    records = [r for r in reader.records()
               if r.get("kind") == "event" and r.get("event") == "gang_lifecycle"]
    folded = GangLifecycleLedger.fold(records)
    want = {CLI_EXPLAIN_GANG: GangLifecycleLedger.timeline_view(folded[CLI_EXPLAIN_GANG])}
    if outs["timeline"]["gangs"] != json.loads(json.dumps(want, default=str)):
        raise AssertionError(f"timeline differs from the ledger's fold: {outs['timeline']}")
    report["timeline_events"] = len(want[CLI_EXPLAIN_GANG].get("events", []))
    return report


# one gang that no 64-cpu node can hold: keeps a full-width sim child up
# past its flood (a denied gang never turns terminal) for live queries
CLI_HELD_GANG = """apiVersion: batch.scheduler.tpu/v1
kind: PodGroup
metadata:
  name: held
spec:
  minMember: 1
---
apiVersion: apps/v1
kind: StatefulSet
metadata:
  name: held
spec:
  podManagementPolicy: Parallel
  replicas: 1
  template:
    metadata:
      labels:
        group.batch.scheduler.tpu: "held"
    spec:
      containers:
        - name: held
          image: nginx
          resources:
            requests:
              cpu: "128"
"""
CLI_WHATIF = ("--add-nodes", "1", "--node-cpu", "256")  # places the held gang


def whatif_plan(w):
    """A what-if answer without its rung, clock and cache flag."""
    return {k: v for k, v in w.items() if k not in ("rung", "elapsed_s", "baseline_cached")}


def live_full_width(tmp, env):
    """The quarter deployment in a sim child (``env``'s rung) with one
    more gang that never fits, so the child stays up once the 2,500 pods
    are bound. Then, live: its launches of each kernel
    against its batches (one launch a batch, plus the warm batch), and
    ``whatif --rung steady|topk`` (add one 256-cpu node) from CLI children,
    equal to each other and to ``/debug/whatif`` on the same process, the
    held gang newly placeable. The child is then stopped. Returns (report,
    launches by kernel)."""
    held = os.path.join(tmp, "held.yaml")
    with open(held, "w") as f:
        f.write(CLI_HELD_GANG)
    child = cli_start(["sim", *CLI_QUARTER, "--timeout", "300", "--settle", "300",
                       "-f", held, "--metrics-port", "0"], env)
    try:
        port = int(read_port(child, r"metrics on :(\d+)"))
        t0 = time.perf_counter()
        deadline = t0 + CLI_TIMEOUT
        while time.perf_counter() < deadline:
            bound = sum(metric_values(port, "bst_pods_bound_total").values())
            if bound >= CLI_QUARTER_PODS:
                break
            if child.poll() is not None:
                raise AssertionError(f"the held sim exited {child.returncode}")
            time.sleep(0.5)
        else:
            raise AssertionError(f"{bound} of {CLI_QUARTER_PODS} pods bound by the deadline")
        report = {"pods_bound_s": time.perf_counter() - t0}
        # the held gang's retries keep batching: a read whose counts
        # straddle a batch (launched, not yet collected) is taken again
        for _ in range(20):
            launches = kernel_launches(port)
            batches = int(sum(metric_values(port, "bst_oracle_batches_total").values()))
            if sum(launches.values()) == batches + 1:
                break
            time.sleep(0.25)
        report.update(batches=batches, launches=launches)
        addr = f"127.0.0.1:{port}"
        procs = {r: cli_start(["whatif", "--addr", addr, *CLI_WHATIF, "--rung", r], env)
                 for r in ("steady", "topk")}
        answers = {}
        for rung, proc in procs.items():
            rc, out, err = cli_wait(proc)
            if rc != 0:
                raise AssertionError(f"whatif --rung {rung}: exit {rc}: {err[-800:]} "
                                     f"{out[-800:]}")
            answers[rung] = cli_json(out)
        status, body, _ = http_get(port, "/debug/whatif?add_nodes=1&node_cpu=256&rung=topk")
        route = json.loads(body)
    finally:
        child.terminate()
        try:
            child.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            child.kill()
            child.communicate()
        child.err_file.close()
    plans = {r: whatif_plan(w) for r, w in answers.items()}
    if status != 200 or any("error" in w for w in (*answers.values(), route)) \
            or plans["steady"] != plans["topk"] or whatif_plan(route) != plans["topk"] \
            or "default/held" not in plans["topk"]["newly_placeable"] \
            or plans["topk"]["base"]["nodes"] != CLI_QUARTER_NODES:
        raise AssertionError(f"full-width whatif: steady {answers.get('steady')}, topk "
                             f"{answers.get('topk')}, route {status} {route}")
    if sum(launches.values()) != batches + 1:
        raise AssertionError(f"held sim: launches {launches} against {batches} batches + 1")
    report["whatif"] = {"newly_placeable": plans["topk"]["newly_placeable"],
                        "base": plans["topk"]["base"], "whatif": plans["topk"]["whatif"],
                        "elapsed_s": {r: w["elapsed_s"] for r, w in answers.items()}}
    return report, launches


def drive_sidecar_requests(addr, stop):
    """Schedule requests of a small deployment sent to a sidecar until
    ``stop`` is set (the profiled window's work); returns how many."""
    from batch_scheduler_tpu_torch.ops.snapshot import ClusterSnapshot, GroupDemand
    from batch_scheduler_tpu_torch.service.client import OracleClient
    from batch_scheduler_tpu_torch.sim.scenarios import make_sim_node

    nodes = [make_sim_node(f"p{i}", {"cpu": "8", "memory": "32Gi", "pods": "110"})
             for i in range(64)]
    demands = [GroupDemand(f"default/p{g}", 4, member_request={"cpu": 1000})
               for g in range(32)]
    req = snapshot_request(ClusterSnapshot(nodes, {}, demands))
    host, port = addr.rsplit(":", 1)
    client = OracleClient(host, int(port))
    sent = 0
    try:
        while not stop.is_set():
            client.schedule(req)
            sent += 1
    finally:
        client.close()
    return sent


def check_served(tmp, env, wave):
    """``serve --port 0 --metrics-port 0``, the quarter deployment through
    it (``sim ... --oracle-addr``), then the four routes scraped from the
    served process: /debug/buckets lists its [256, 2048] bucket with its
    plan and bound, /debug/perf, /debug/profile?seconds=1 writes a trace
    naming the scan kernel (while the smoke sends it requests), and
    /debug/drain?go=1 drains, after which SIGTERM ends it with exit 0.
    Returns (report, the served main path's launches by kernel: the
    server's ``bst_kernel_launches_total`` just before and just after the
    remote run)."""
    import signal
    import threading

    profile_dir = os.path.join(tmp, f"profiles-{wave or 0}")
    server = cli_start(["serve", "--port", "0", "--metrics-port", "0",
                        "--profile-dir", profile_dir], env)
    try:
        mport = int(read_port(server, r"metrics on :(\d+)"))
        addr = read_port(server, r"listening on ([\d.]+:\d+)")
        kernel = "assign_wave" if wave else "assign_scan"
        # the served main path's launches: the counts just before the
        # remote run and just after it, before any other request
        before = kernel_launches(mport)
        _, out, _ = cli(["sim", *CLI_QUARTER, *CLI_QUARTER_RUN, "--oracle-addr", addr], env=env)
        launches = launch_delta(before, kernel_launches(mport))
        rows = sim_table(out)
        wall, bound, rate = sim_wall(out)
        running = sum(1 for phase, _, b in rows.values() if phase == "Running" and b == 10)
        if running != CLI_QUARTER_GANGS or bound != CLI_QUARTER_PODS:
            raise AssertionError(f"remote: {running} gangs Running, {bound} pods bound: "
                                 f"{out[-1500:]}")
        report = {"remote": {"wall_s": wall, "pods_bound": bound, "pods_per_s": rate,
                             "gangs_running": running, **oracle_stats(out)}}
        # one launch a batch: the run's batches and its warm batch (sent
        # over the wire before the first pod)
        warm = int("oracle warmup batch:" in out)
        want = report["remote"]["batches"] + warm
        if launches != only(**{kernel: want}):
            raise AssertionError(f"served run: launches {launches}, want {kernel} {want} "
                                 f"({report['remote']['batches']} batches + {warm} warm)")
        report["remote"]["launches"] = launches[kernel]
        status, body, _ = http_get(mport, "/debug/buckets")
        buckets = json.loads(body)
        path = "wavefront" if wave else "serial"
        ns = (buckets.get(CLI_QUARTER_BUCKET) or {}).get("rungs", {}).get(path) or {}
        if status != 200 or ns.get("kernel") != kernel or not ns.get("plan") \
                or not ns.get("bound_ms"):
            raise AssertionError(f"/debug/buckets {status}: {buckets}")
        report["served_bucket"] = {CLI_QUARTER_BUCKET: ns}
        status, body, _ = http_get(mport, "/debug/perf")
        perf = json.loads(body)
        if status != 200 or not perf.get("device_memory") \
                or not perf["compile_ledger"]["totals"] or not perf["scan_rung_mix"]:
            raise AssertionError(f"/debug/perf {status}: {perf}")
        report["perf"] = {k: perf[k] for k in ("phases", "scan_rung_mix", "device_memory",
                                               "compile_ledger")}
        stop = threading.Event()
        sent = []
        before = kernel_launches(mport)
        sender = threading.Thread(target=lambda: sent.append(drive_sidecar_requests(addr, stop)))
        sender.start()
        try:
            time.sleep(0.3)
            status, body, _ = http_get(mport, "/debug/profile?seconds=1")
        finally:
            stop.set()
            sender.join(60)
        capture = json.loads(body)
        trace = capture.get("trace") or ""
        text = open(trace).read() if trace and os.path.exists(trace) else ""
        if status != 200 or not capture.get("ok") or not capture.get("cuda") \
                or f"{kernel}_kernel" not in text:
            raise AssertionError(f"/debug/profile {status}: {capture}, {len(text)} bytes, "
                                 f"{sent} requests sent")
        report["profile"] = {"events": capture["events"], "trace_bytes": len(text),
                             "requests_in_window": sent[0] if sent else None,
                             "launches_in_window": launch_delta(
                                 before, kernel_launches(mport))[kernel]}
        status, body, _ = http_get(mport, "/debug/drain?go=1")
        drained = json.loads(body)
        if status != 200 or drained.get("servers") != 1 \
                or not all(r.get("drained") for r in drained["reports"]):
            raise AssertionError(f"/debug/drain?go=1 {status}: {drained}")
        report["drain"] = drained["reports"][0]
        server.send_signal(signal.SIGTERM)
        rc, out, err = cli_wait(server, 120)
        if rc != 0 or "drain complete" not in "".join(getattr(server, "seen", [])) + out:
            raise AssertionError(f"serve exited {rc} after the drain: {err[-1500:]}")
    finally:
        if server.poll() is None:
            server.kill()
            server.communicate()
    return report, launches


def check_no_card():
    """A cuda command with no card visible exits non-zero: no CPU fallback."""
    rc, out, err = cli(["sim", "-f", "examples/race.yaml", "--timeout", "30"],
                       env=cli_env(CUDA_VISIBLE_DEVICES=""), want_rc=None)
    if rc == 0 or "no CUDA card" not in err:
        raise AssertionError(f"no-card run exited {rc}: {err[-800:]} {out[-400:]}")
    return {"exit": rc}


CLI_RING = {}  # the cli phase's full-width audit ring, read again by cli_wave


def cli_phase(results, wave):
    """The CLI phase (see the module docstring); ``wave`` sets BST_SCAN_WAVE
    in the children. Seconds of each step under ``step_s``."""
    import atexit
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    env = cli_env(**({"BST_SCAN_WAVE": str(wave)} if wave else {}))
    tag = "cli_wave" if wave else "cli"
    report, steps = {}, {}

    def step(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        steps[name] = time.perf_counter() - t0
        return out

    kernel = "assign_wave" if wave else "assign_scan"
    if wave:
        if "audit" not in CLI_RING:
            raise AssertionError("the cli phase left no full-width audit ring")
        tmp = CLI_RING["tmp"]
    else:
        tmp = tempfile.mkdtemp(prefix="cli-")
        atexit.register(shutil.rmtree, tmp, True)
        # the README's examples and the no-card run mostly wait (deny
        # windows, settles, a refused start): they run beside the
        # full-width run's child
        with ThreadPoolExecutor(max_workers=2) as pool:
            readme = pool.submit(step, "readme", check_readme_examples, tmp)
            no_card = pool.submit(step, "no_card", check_no_card)
            full = step("full_width", full_width_sim, tmp, (), env)
            report["readme"], report["no_card"] = readme.result(), no_card.result()
        report["full_width"] = {k: v for k, v in full.items() if not k.endswith("_dir")}
        CLI_RING.update(tmp=tmp, audit=full["audit_dir"])
    report["read_side"] = step("read_side", check_read_side, CLI_RING["audit"],
                               ("wavefront", "topk") if wave else ("steady",), env)
    if wave:
        report["live"], launches = step("live", live_full_width, tmp, env)
        if launches != only(**{kernel: launches[kernel]}) or not launches[kernel]:
            raise AssertionError(f"held sim launches {launches} (want {kernel} only)")
        note_path(results, kernel, tag, launches[kernel])
    report["served"], launches = step("served", check_served, tmp, env, wave)
    note_path(results, kernel, f"{tag}_serve", launches[kernel])
    report["step_s"] = steps
    return report


@phase("cli")
def cli_serial(results):
    return cli_phase(results, None)


@phase("cli_wave")
def cli_wave(results):
    return cli_phase(results, 8)


CLI_MAIN_ARGV = ("sim", *CLI_QUARTER, *CLI_QUARTER_RUN)


@phase("cli_main")
def cli_main(results):
    """The CLI's main path counted in process: ``cmd.main.main(argv)`` of the
    synthetic run at a quarter of config 6's count, each kernel's count
    zeroed just before and read just after, under the stack sampler (where the host's time goes, by thread
    and function) and torch.profiler recording the card alone (its busy
    time and idle share over the run). Runs last: the CLI's GC
    thresholds, freeze and switch interval are put back after the call."""
    import contextlib as _contextlib
    import gc
    import io

    from batch_scheduler_tpu_torch.cmd.main import main as cli_main_fn

    out = {}
    for wave, kernel, path in ((None, "assign_scan", "cli_main"),):
        prev = (sys.getswitchinterval(), gc.get_threshold())
        buf = io.StringIO()
        ran = {}
        try:
            with scan_wave_env(wave), _contextlib.redirect_stdout(buf), \
                    StackSampler() as stacks:
                zero_counts()
                prof = profile_window(
                    lambda: ran.setdefault("rc", cli_main_fn(list(CLI_MAIN_ARGV))),
                    "profiled_ms", host_ops=False)
                launches = read_counts()
            rc = ran.get("rc")
        finally:
            sys.setswitchinterval(prev[0])
            gc.set_threshold(*prev[1])
            gc.unfreeze()
        text = buf.getvalue()
        rows = sim_table(text)
        running = sum(1 for phase_, _, b in rows.values() if phase_ == "Running" and b == 10)
        if rc != 0 or running != CLI_QUARTER_GANGS:
            raise AssertionError(f"{path}: exit {rc}, {running} gangs Running: {text[-1500:]}")
        if launches != only(**{kernel: launches[kernel]}) or not launches[kernel]:
            raise AssertionError(f"{path}: launches {launches} (want {kernel} only)")
        wall, bound, rate = sim_wall(text)
        out[path] = {"launches": launches, "wall_s": wall, "pods_per_s": rate,
                     **oracle_stats(text), "profile": prof, "host_stacks": stacks.report(20)}
        note_path(results, kernel, path, launches[kernel])
    return out


# -- the HTTP control plane, the chaos proxy and the bucket warmer ----------

HTTP_E2E_RESTART_AT = 1 / 3  # tests/test_fuzz_e2e.py:572: a third of the binds landed
HTTP_E2E_OUTAGE_S = 0.5  # benchmarks/http_e2e.py:133: the gateway dark this long
HTTP_E2E_TIMEOUT = 300.0


def store_bound_count(backing):
    """Pods bound to a node in the backing store (the store's truth)."""
    from batch_scheduler_tpu_torch.utils.labels import POD_GROUP_LABEL

    return sum(backing.bound_pods_by_label(POD_GROUP_LABEL).values())


def store_overcommit(backing, nodes):
    """Nodes whose bound, non-terminal pods in the backing store ask for
    more than the node's allocatable on some lane (the pod slot counted)."""
    from batch_scheduler_tpu_torch.api.serde import pod_from_dict

    alloc = {n.metadata.name: n.status.allocatable for n in nodes}
    used = {}
    for d in backing.list("Pod"):
        node = (d.get("spec") or {}).get("node_name")
        if not node or (d.get("status") or {}).get("phase") in ("Succeeded", "Failed"):
            continue
        u = used.setdefault(node, {})
        for k, v in pod_from_dict(d).resource_require().items():
            u[k] = u.get(k, 0) + v
        u["pods"] = u.get("pods", 0) + 1
    return [(name, k, v) for name, u in used.items() for k, v in u.items()
            if name not in alloc or v > int(alloc[name].get(k, 0))]


class PodCreator:
    """The load generator: one thread with its own keep-alive client
    (``make_client``) POSTs the pod documents in order, as
    benchmarks/http_e2e.py runs it. A create the outage cut is sent again
    once the gateway answers; AlreadyExists on a re-send means the first
    one landed (its answer was lost). ``resent`` and ``errors`` are read
    after ``join``."""

    def __init__(self, make_client, docs):
        import threading

        self.resent, self.errors = 0, []
        self.client = make_client()
        self.thread = threading.Thread(target=self._run, name="pod-creator", daemon=True,
                                       args=(docs,))

    def start(self):
        self.thread.start()

    def join(self, timeout):
        self.thread.join(timeout)

    def close(self):
        self.client.close()

    def _run(self, docs):
        import http.client

        from batch_scheduler_tpu_torch.client import AlreadyExistsError

        try:
            for d in docs:
                for attempt in range(400):
                    try:
                        self.client.create("Pod", d)
                        break
                    except AlreadyExistsError:
                        if not attempt:
                            raise
                        break
                    except (OSError, http.client.HTTPException):
                        self.resent += 1
                        time.sleep(0.05)
                else:
                    raise AssertionError("the gateway did not come back for a create")
        except Exception as e:  # noqa: BLE001 — reported by the phase
            self.errors.append(e)


def http_mark(t0, what):
    """A progress mark on stderr (a run cut by its time limit shows where
    it got to)."""
    print(f"# http_e2e {time.perf_counter() - t0:.2f} s {what}", file=sys.stderr, flush=True)


def drive_http_e2e(shape):
    """Config 6 through the port's scheduler loop over its HTTP gateway on
    the card (see the module docstring). Returns (launches, report)."""
    import torch

    from batch_scheduler_tpu_torch.client import APIServer, HTTPAPIServer, serve_gateway
    from batch_scheduler_tpu_torch.ops.oracle import inflight_batches
    from batch_scheduler_tpu_torch.sim import SimCluster

    num_nodes, num_groups, members = shape
    total = num_groups * members
    creator = None
    backing = APIServer()
    server = serve_gateway(backing)
    host, port = server.server_address[:2]
    # throttles off, as tests/test_fuzz_e2e.py:492-495 runs the composition
    api = HTTPAPIServer(host, port, qps=0)
    t_setup = time.perf_counter()
    with scan_wave_env(None):
        cluster = SimCluster(scorer="oracle", device="cuda", api=api, **FRAMEWORK_SETTINGS)
        try:
            op = cluster.runtime.operation
            if op.oracle.device.type != "cuda":
                raise AssertionError(f"scorer on {op.oracle.device}")
            nodes = framework_nodes(num_nodes)
            cluster.add_nodes(nodes)
            docs = framework_gangs(cluster, [f"gang-{g:04d}" for g in range(num_groups)],
                                   members)
            cluster.start()
            if not phases_settled(cluster, timeout=120.0):
                raise AssertionError("controller phase sweep did not finish")
            setup_s = time.perf_counter() - t_setup
            http_mark(t_setup, "set up")
            zero_counts()
            batches0 = op.oracle.batches_run
            op.oracle.ensure_fresh(cluster.cluster, op.status_cache)
            torch.cuda.synchronize()

            def released(gang):
                pgs = op.status_cache.get(f"default/{gang}")
                return pgs is not None and pgs.scheduled

            creator = PodCreator(lambda: HTTPAPIServer(host, port, qps=0), docs)
            with BoundSampler(backing, members, released) as sampler:
                t0 = time.perf_counter()
                creator.start()
                # the store is polled every 0.5 s: a pass over 10,000 pods
                # under its lock, which the gateway's handlers wait for
                if not cluster.wait_for(
                        lambda: store_bound_count(backing) >= total * HTTP_E2E_RESTART_AT,
                        timeout=HTTP_E2E_TIMEOUT, interval=0.5):
                    raise AssertionError(f"{store_bound_count(backing)} pods bound before "
                                         "the restart point")
                binds_before = store_bound_count(backing)
                http_mark(t0, f"restart at {binds_before} bound")
                t_kill = time.perf_counter()
                server.shutdown()
                server.server_close()
                time.sleep(HTTP_E2E_OUTAGE_S)
                server = serve_gateway(backing, host, port)  # same port, same store
                restart = {"binds_before": binds_before, "outage_s": HTTP_E2E_OUTAGE_S,
                           "at_s": t_kill - t0, "restored_at_s": time.perf_counter() - t0}
                marks = [time.perf_counter()]

                def all_bound():
                    n = store_bound_count(backing)
                    if time.perf_counter() - marks[-1] >= 5.0:
                        marks.append(time.perf_counter())
                        http_mark(t0, f"{n} bound, {cluster.scheduler.stats}")
                    return n >= total

                ok = cluster.wait_for(all_bound, timeout=HTTP_E2E_TIMEOUT, interval=0.5)
                elapsed = time.perf_counter() - t0
                http_mark(t0, f"all bound: {ok}")
                creator.join(60)
            if creator.errors:
                raise AssertionError(f"pod creation failed: {creator.errors[:3]!r}")
            if not ok:
                raise AssertionError(f"{store_bound_count(backing)}/{total} pods bound in the "
                                     f"store in {elapsed:.1f}s ({cluster.scheduler.stats})")
            bg = getattr(op.oracle, "_bg_thread", None)
            if bg is not None:
                bg.join(60.0)
            torch.cuda.synchronize()
            launches = read_counts()
            batches = op.oracle.batches_run
            final = sampler.sample()
            if not cluster.wait_for(lambda: all(
                    (pg.get("status") or {}).get("phase") == "Running"
                    for pg in backing.list("PodGroup")), timeout=120.0, interval=0.2):
                raise AssertionError("not every gang reached Running in the store")
            over = store_overcommit(backing, nodes)
            stats = dict(cluster.scheduler.stats)
        finally:
            cluster.stop()
            api.close()
            if creator is not None:
                creator.close()
            server.shutdown()
            server.server_close()
    if inflight_batches() != 0:
        raise AssertionError(f"{inflight_batches()} batches still in flight after stop")
    if launches != only(assign_scan=batches - batches0) or not launches["assign_scan"]:
        raise AssertionError(f"{launches} launches in {batches - batches0} batches "
                             "(want assign_scan once a batch, no other kernel)")
    if over:
        raise AssertionError(f"over-committed in the store: {over[:5]}")
    if len(final) != num_groups or any(n != members for n in final.values()):
        raise AssertionError("the final sample is not every gang whole")
    if sampler.partial:
        raise AssertionError(f"gangs partly bound before their release: {sampler.partial[:5]}")
    report = {
        "nodes": num_nodes, "gangs": num_groups, "pods": total,
        "wall_clock_s": elapsed, "pods_per_sec": total / max(elapsed, 1e-9),
        "oracle_batches": batches - batches0, "launches_by_kernel": launches,
        "gateway_restart": restart, "creates_resent": creator.resent,
        "creator_threads": 1,
        "binds_counted_by_scheduler": stats["binds"], "bound_in_store": total,
        "unschedulable_retries": stats["unschedulable"],
        "permit_rejects": stats["permit_rejects"],
        "bound_samples": sampler.samples, "mid_bind_gangs_seen": sampler.mid_bind,
        "partly_bound_unreleased": 0, "overcommitted_nodes": 0, "setup_s": setup_s,
        "framework_e2e_wall_clock_s": FIGURES.get("framework_e2e_wall_s"),
        "transport": "HTTP/1.1 keep-alive over loopback, reflector watches, pods:bindmany",
    }
    return launches, report


@phase("http_e2e")
def http_e2e(results):
    """Config 6 over the HTTP gateway, serial kernel, with a gateway restart."""
    launches, report = drive_http_e2e(FRAMEWORK_SHAPE)
    note_path(results, "assign_scan", "http_e2e", launches["assign_scan"])
    return report


CHAOS_DELTA_ROUNDS = 3  # churn refreshes after the keyframe on each delta stream
CHAOS_HANG_S = 0.5  # the proxy's black-hole before it drops the connection
CHAOS_DRIZZLE = {"delay": 0.15, "reset": 0.04, "truncate": 0.03, "garbage": 0.03}
CHAOS_DRIZZLE_SEED = 909  # tests/test_fuzz_e2e.py:296


def chaos_client(addr, window=1, **kw):
    from batch_scheduler_tpu_torch.service import ResilientOracleClient
    from batch_scheduler_tpu_torch.utils.metrics import Registry
    from batch_scheduler_tpu_torch.utils.retry import CircuitBreaker, RetryPolicy

    # a (host, port) pair, or the pooled address spec "h1:p1,h2:p2"
    return ResilientOracleClient(
        *((addr,) if isinstance(addr, str) else addr), timeout=kw.pop("timeout", 5.0),
        registry=Registry(), window=window,
        retry_policy=RetryPolicy(max_attempts=kw.pop("attempts", 4), base_delay=0.01,
                                 max_delay=0.05),
        breaker=CircuitBreaker(failure_threshold=kw.pop("failure_threshold", 8),
                               reset_timeout=kw.pop("reset_timeout", 0.3)), **kw)


def chaos_faults(server, dedicated_answer, req):
    """Each response-direction fault once through a ChaosProxy in front of
    ``server``: the answer equals the dedicated sidecar's, the breaker
    stays closed, the fault was injected."""
    from batch_scheduler_tpu_torch.sim.chaos import FAULT_KINDS, ChaosProxy

    out = {}
    for kind in FAULT_KINDS:
        proxy = ChaosProxy(*server.address)
        client = chaos_client(proxy.address, timeout=1.0)
        try:
            if not same_response(client.schedule(req), dedicated_answer):
                raise AssertionError(f"{kind}: the healthy answer differs")
            proxy.set_fault(kind, probability=1.0, limit=1, delay_s=0.1, hang_s=CHAOS_HANG_S)
            t0 = time.perf_counter()
            resp = client.schedule(req)
            ms = (time.perf_counter() - t0) * 1e3
            injected = proxy.injected_counts()[kind]
            if injected != 1 or client.breaker.state != "closed" \
                    or not same_response(resp, dedicated_answer):
                raise AssertionError(f"{kind}: injected {injected}, breaker "
                                     f"{client.breaker.state}, answer equal "
                                     f"{same_response(resp, dedicated_answer)}")
            if not client.ping():
                raise AssertionError(f"{kind}: the link is not usable afterwards")
            out[kind] = {"recovered_request_ms": ms}
        finally:
            client.close()
            proxy.stop()
    return out


def chaos_delta_stream(server, dedicated, standby):
    """The wire-delta stream at the north star through proxies: a dropped
    and a duplicated request frame (the duplicate refused on the generation
    check, the client resyncing through a keyframe), then the primary
    killed mid-stream with a pooled client failing over to the standby and
    resyncing. After every refresh the remote scorer's host dict equals a
    second remote scorer's on the dedicated sidecar."""
    from batch_scheduler_tpu_torch.service import RemoteScorer
    from batch_scheduler_tpu_torch.sim.chaos import ChaosProxy
    from batch_scheduler_tpu_torch.utils.metrics import DEFAULT_REGISTRY

    kinds = DEFAULT_REGISTRY.counter("bst_oracle_wire_delta_batches_total")
    resyncs = DEFAULT_REGISTRY.counter("bst_oracle_wire_delta_resyncs_total")
    out = {}
    for case in ("drop_c2s", "dup_c2s", "kill"):
        cluster, cache = north_star_state()
        if case == "kill":
            proxy = ChaosProxy(*server.address)
            client = chaos_client("%s:%s,%s:%s" % (proxy.address + standby.address),
                                  attempts=6, failure_threshold=2, reset_timeout=5.0)
        else:
            proxy = ChaosProxy(*server.address, c2s_frames=True)
            client = chaos_client(proxy.address, failure_threshold=16)
        remote = RemoteScorer(client, fallback="deny")
        remote._wire_tenant_ok = False  # one frame a request: the fault hits the delta
        want = RemoteScorer(chaos_client(dedicated.address), fallback="deny")
        scorers = (remote, want)
        churn = Churn(cluster, cache, lambda name: [s.mark_dirty(group=name) for s in scorers],
                      CHAOS_DELTA_ROUNDS + 2)
        seen = {"resyncs": resyncs.value(), "keyframes": kinds.value(kind="keyframe")}
        try:
            for r in range(CHAOS_DELTA_ROUNDS + 1):
                if r:
                    churn(r)
                if r == 2:
                    if case == "kill":
                        primary = client.active_address
                        proxy.kill_endpoint()
                    else:
                        proxy.set_fault(case, probability=1.0, limit=1)
                for s in scorers:
                    s.ensure_fresh(cluster, cache)
                diff = host_diff(remote._state.result, want._state.result)
                if diff:
                    raise AssertionError(f"{case} round {r}: differs from the dedicated "
                                         f"sidecar on {diff}")
            rep = {"resyncs": resyncs.value() - seen["resyncs"],
                   "keyframes": kinds.value(kind="keyframe") - seen["keyframes"]}
            if case == "kill":
                if client.active_address == primary or \
                        tuple(client.active_address) != tuple(standby.address):
                    raise AssertionError(f"no failover: active {client.active_address}")
                rep["failed_over_to_standby"] = True
            else:
                rep["injected"] = proxy.injected_counts()[case]
                if rep["injected"] != 1:
                    raise AssertionError(f"{case}: injected {rep['injected']}")
            if rep["resyncs"] < 1 or rep["keyframes"] < 2:
                raise AssertionError(f"{case}: no resync through a keyframe: {rep}")
            out[case] = rep
        finally:
            remote.close()
            want.close()
            proxy.stop()
    return out


def drive_chaos(wave):
    """The faults and the delta-stream drills at ``wave`` (None: unset)
    against a sidecar on the card; each answer against a dedicated sidecar.
    Returns (the served launches, report)."""
    import torch

    from batch_scheduler_tpu_torch.core.oracle_scorer import read_cluster_inputs
    from batch_scheduler_tpu_torch.ops.snapshot import ClusterSnapshot
    from batch_scheduler_tpu_torch.service import OracleClient, serve_background

    kernel = "assign_wave" if wave else "assign_scan"
    with scan_wave_env(wave):
        server = serve_background(device="cuda")
        dedicated = serve_background(device="cuda")
        standby = serve_background(device="cuda")
        try:
            req = snapshot_request(ClusterSnapshot(*read_cluster_inputs(*north_star_cluster())))
            client = OracleClient(*dedicated.address)
            want = client.schedule(req)
            client.close()
            zero_counts()
            faults = chaos_faults(server, want, req)
            deltas = chaos_delta_stream(server, dedicated, standby)
            torch.cuda.synchronize()
            launches = read_counts()
        finally:
            for srv in (server, dedicated, standby):
                srv.shutdown()
                srv.server_close()
    if launches != only(**{kernel: launches[kernel]}) or not launches[kernel]:
        raise AssertionError(f"launches {launches} (want {kernel} only)")
    return launches, {"faults": faults, "delta_stream": deltas}


def chaos_drizzle():
    """tests/test_fuzz_e2e.py:296's drizzle of faults under the scheduler
    loop on the card: the sidecar on the card behind a proxy, a
    RemoteScorer(fallback="local-cpu") in a SimCluster(device="cuda"), the
    reference's seeded scenario. Returns (the server's launches, report)."""
    import numpy as np

    from batch_scheduler_tpu_torch.service import RemoteScorer, serve_background
    from batch_scheduler_tpu_torch.sim import SimCluster
    from batch_scheduler_tpu_torch.sim.chaos import ChaosProxy
    from batch_scheduler_tpu_torch.sim.scenarios import (
        make_member_pods, make_sim_group, make_sim_node)
    from batch_scheduler_tpu_torch.utils.metrics import DEFAULT_REGISTRY

    fallback = DEFAULT_REGISTRY.counter("bst_oracle_fallback_batches_total")
    server = serve_background(device="cuda")
    proxy = ChaosProxy(*server.address, seed=CHAOS_DRIZZLE_SEED)
    proxy.set_fault(dict(CHAOS_DRIZZLE), delay_s=0.03, hang_s=1.0)
    scorer = RemoteScorer(chaos_client(proxy.address, failure_threshold=4),
                          fallback="local-cpu")
    rng = np.random.default_rng(CHAOS_DRIZZLE_SEED)
    cluster = SimCluster(scorer=scorer, device="cuda", max_schedule_minutes=0.05,
                         backoff_base=0.1, backoff_cap=0.5)
    f0 = fallback.value()
    zero_counts()
    try:
        n_nodes = int(rng.integers(8, 24))
        node_cpus = rng.choice([4, 8, 16], size=n_nodes)
        nodes = [make_sim_node(f"fz-n{i:03d}", {"cpu": str(int(c)),
                                                "memory": f"{int(c) * 4}Gi", "pods": "110"})
                 for i, c in enumerate(node_cpus)]
        cluster.add_nodes(nodes)
        budget, max_cpu = int(node_cpus.sum()) * 0.6, int(node_cpus.max())
        feasible, infeasible, batches = [], [], []
        n_gangs = int(rng.integers(10, 25))
        for g in range(n_gangs):
            members, prio = int(rng.integers(2, 6)), int(rng.integers(0, 3))
            if rng.random() < 0.2:
                cpu, name = max_cpu + int(rng.integers(1, 4)), f"fz-bad-{g:03d}"
                infeasible.append((name, members))
            else:
                cpu = int(rng.integers(1, 4))
                if budget - members * cpu < 0:
                    continue
                budget -= members * cpu
                name = f"fz-ok-{g:03d}"
                feasible.append((name, members))
            cluster.create_group(make_sim_group(
                name, members, creation_ts=time.time() - (n_gangs - g) * 1e-3))
            batches.append(make_member_pods(name, members, {"cpu": str(cpu)}, priority=prio))
        loose = make_member_pods("fz-loose", int(rng.integers(3, 8)), {"cpu": "1"})
        for p in loose:
            p.metadata.labels = {}
        batches.append(loose)
        cluster.start()
        t0 = time.perf_counter()
        for i in rng.permutation(len(batches)):
            cluster.create_pods(batches[int(i)])
        expected = sum(m for _, m in feasible) + len(loose)
        if not cluster.wait_for(lambda: cluster.scheduler.stats["binds"] >= expected,
                                timeout=120.0, interval=0.2):
            raise AssertionError(f"feasible work never bound under the drizzle: "
                                 f"{cluster.scheduler.stats}, {proxy.injected_counts()}")
        elapsed = time.perf_counter() - t0
        over = store_overcommit(cluster.api, nodes)
        bound = cluster.bound_member_counts()
        launches = read_counts()
        injected = proxy.injected_counts()
    finally:
        cluster.stop()
        scorer.close()
        proxy.stop()
        server.shutdown()
        server.server_close()
    if over:
        raise AssertionError(f"over-committed: {over[:5]}")
    short = [n for n, m in feasible if bound.get(("default", n), 0) < m]
    wrong = [n for n, _ in infeasible if bound.get(("default", n), 0)]
    if short or wrong:
        raise AssertionError(f"feasible gangs short {short}, infeasible bound {wrong}")
    fell_back = fallback.value() - f0
    if not launches["assign_scan"] or sum(injected.values()) == 0:
        raise AssertionError(f"the card served {launches} (fallback batches {fell_back}), "
                             f"injected {injected}")
    return launches, {"wall_s": elapsed, "feasible_gangs": len(feasible),
                      "infeasible_gangs": len(infeasible), "injected": injected,
                      "server_launches": launches["assign_scan"],
                      "client_fallback_batches": fell_back}


@phase("chaos")
def chaos(results):
    """The port's sidecar on the card behind ChaosProxy (see the module
    docstring): every fault kind and the delta-stream drills at W unset
    and W=8, then the drizzle under the scheduler loop."""
    report = {}
    for wave, kernel in ((None, "assign_scan"), (8, "assign_wave")):
        launches, rep = drive_chaos(wave)
        tag = "chaos_wave" if wave else "chaos"
        note_path(results, kernel, tag, launches[kernel])
        report[tag] = {**rep, "launches": launches[kernel]}
    launches, report["drizzle"] = chaos_drizzle()
    note_path(results, "assign_scan", "chaos_drizzle", launches["assign_scan"])
    return report


WARMER_GROWN_NODES = 8200  # past the 8192 boundary: N bucket 16384
WARMER_GROWN_BUCKET = 16384
WARMER_TIMEOUT = 300  # seconds a warmer child may take


def warmer_child(mode) -> int:
    """One fresh process of the warmer phase (``--warmer-child MODE``),
    printing one JSON line. ``on`` / ``off``: an OracleScorer at the north
    star with the warmer on or off, then the cluster grown to
    WARMER_GROWN_NODES (the next N bucket): the first and a second batch
    there. ``primary:FILE``: a sidecar warmed up as ``serve --warmup``
    does, with the warmer, serving the north star twice, its
    warmth_snapshot written to FILE. ``standby:FILE``: the same sidecar,
    which replicates FILE's snapshot, then serves the north star twice."""
    import pickle

    import torch

    from batch_scheduler_tpu_torch.core import OracleScorer
    from batch_scheduler_tpu_torch.utils.audit import plan_digest

    if build() is None:
        return 1
    out = {"mode": mode.split(":")[0]}
    if mode in ("on", "off"):
        cluster, cache = north_star_cluster()
        scorer = OracleScorer(device="cuda", compile_warmer=mode == "on")
        times = []
        for _ in range(2):
            scorer.mark_dirty()
            scorer.refresh(cluster, cache)
            times.append(scorer.batch_seconds[-1] * 1e3)
        out["north_star_batch_ms"] = times
        if scorer._warmer is not None:
            # the grown bucket's key: (G, N, lanes, per-gang mask, wave)
            key = (NORTH_STAR_SHAPE[0], WARMER_GROWN_BUCKET, NORTH_STAR_SHAPE[2], False, 0)
            t0 = time.perf_counter()
            while key not in scorer._warmer.warmed_shapes():
                if time.perf_counter() - t0 > 60:
                    raise AssertionError("the warmer never warmed the grown bucket")
                time.sleep(0.01)
            out["warm_wait_s"] = time.perf_counter() - t0
        from batch_scheduler_tpu_torch.sim.scenarios import make_sim_node

        cluster.nodes += [make_sim_node(f"g{i:05d}", {"cpu": "64", "memory": "256Gi",
                                                     "pods": "110", GPU: "8"})
                          for i in range(WARMER_GROWN_NODES - len(cluster.nodes))]
        cluster.bound.update({n.metadata.name: [] for n in cluster.nodes})
        grown = []
        for _ in range(2):
            scorer.mark_dirty()
            scorer.refresh(cluster, cache)
            torch.cuda.synchronize()
            grown.append({"batch_ms": scorer.batch_seconds[-1] * 1e3,
                          "compiled": scorer.last_telemetry.get("compiled"),
                          "n_bucket": scorer.last_telemetry.get("n_bucket")})
        out.update(grown=grown, digest=plan_digest(scorer._state.result),
                   placed=int(sum(scorer._state.result["placed"])),
                   stats={k: v for k, v in scorer.stats().items() if k.startswith("warmer")})
        if not scorer.drain_background(60.0):
            raise AssertionError("drain left work in flight")
        # the process's launches: one a batch, served or warm (counted from
        # the process's start: nothing else launched here)
        out.update(launches=read_counts(), batches=scorer.batches_run,
                   warm_batches=0 if scorer._warmer is None
                   else int(scorer._warmer._warms.value()))
    else:
        from batch_scheduler_tpu_torch.core.oracle_scorer import read_cluster_inputs
        from batch_scheduler_tpu_torch.ops.snapshot import ClusterSnapshot
        from batch_scheduler_tpu_torch.service import OracleClient, serve_background

        from batch_scheduler_tpu_torch.cmd.main import warm_oracle

        kind, path = mode.split(":", 1)
        req = snapshot_request(ClusterSnapshot(*read_cluster_inputs(*north_star_cluster())))
        # both sidecars start as `serve --warmup --compile-warmer` does: one
        # warm-up batch first, so the standby's first request is compared
        # with a warmed-up sidecar's, and only the replication differs
        out["warmup_s"] = warm_oracle(device="cuda")
        server = serve_background(device="cuda", compile_warmer=True)
        try:
            if kind == "standby":
                with open(path, "rb") as f:
                    protos = pickle.load(f)
                out["replicated"] = server.replicate_warmth(protos)
                t0 = time.perf_counter()
                while len(server.warmer.warmed_shapes()) < 1 + 4:
                    if time.perf_counter() - t0 > 60:
                        raise AssertionError(f"standby warmed {server.warmer.warmed_shapes()}")
                    time.sleep(0.01)
                out["warm_wait_s"] = time.perf_counter() - t0
            client = OracleClient(*server.address)
            times, answers = [], []
            for _ in range(2):
                t0 = time.perf_counter()
                answers.append(client.schedule(req))
                times.append((time.perf_counter() - t0) * 1e3)
            client.close()
            out["request_ms"] = times
            out["placed"] = int(answers[0].placed.sum())
            out["same_answers"] = same_response(*answers)
            out["stats"] = server.warmer.stats()
            if kind == "primary":
                with open(path, "wb") as f:
                    pickle.dump(server.warmth_snapshot(), f)
        finally:
            server.shutdown()
            server.server_close()
        # the warm-up batch, the two requests, and the warmer's batches
        out.update(launches=read_counts(), batches=1 + len(times),
                   warm_batches=int(server.warmer._warms.value()))
    emit(out)
    return 0


def warmer_run(mode):
    """One warmer child run to its end; its JSON line."""
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--warmer-child", mode],
                          cwd=here, env=cli_env(), capture_output=True, text=True,
                          timeout=WARMER_TIMEOUT)
    if proc.returncode != 0:
        raise AssertionError(f"warmer child {mode} exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


@phase("warmer")
def warmer(results):
    """The bucket warmer in fresh processes (see the module docstring):
    two with it off and two with it on, alternating, each at the north
    star and then grown past one N bucket; then a primary sidecar's warmth
    replicated to a standby's. Passes on equal plans and on the counters;
    the times are reported."""
    import tempfile

    runs = [warmer_run(mode) for mode in ("off", "on", "off", "on")]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "warmth.pkl")
        primary = warmer_run(f"primary:{path}")
        standby = warmer_run(f"standby:{path}")
    for r in (*runs, primary, standby):
        want = only(assign_scan=r["batches"] + r["warm_batches"])
        if r["launches"] != want:
            raise AssertionError(f"{r['mode']} child: launches {r['launches']}, want {want} "
                                 "(one a served or warm batch)")
    note_path(results, "assign_scan", "warmer",
              sum(r["launches"]["assign_scan"] for r in (*runs, primary, standby)))
    digests = {r["digest"] for r in runs}
    if len(digests) != 1 or any(r["placed"] != NORTH_STAR_GANGS for r in runs):
        raise AssertionError(f"the grown plans differ: {[(r['mode'], r['digest'][:12], r['placed']) for r in runs]}")
    for r in runs:
        first, second = r["grown"]
        if first["n_bucket"] != WARMER_GROWN_BUCKET or second["compiled"]:
            raise AssertionError(f"{r['mode']}: grown batches {r['grown']}")
        if r["mode"] == "off" and (r["stats"] or not first["compiled"]):
            raise AssertionError(f"warmer off: {r['stats']}, first grown {first}")
        if r["mode"] == "on" and (first["compiled"] or r["stats"].get("warmer_hits") != 1
                                  or r["stats"].get("warmer_misses") != 1
                                  or r["stats"].get("warmer_shapes", 0) < 1):
            raise AssertionError(f"warmer on: {r['stats']}, first grown {first}")
    if primary["placed"] != NORTH_STAR_GANGS or standby["placed"] != NORTH_STAR_GANGS \
            or not standby["same_answers"] or standby["replicated"] != 1 \
            or standby["stats"]["warmer_hits"] != 1 or standby["stats"]["warmer_misses"]:
        raise AssertionError(f"replication: primary {primary}, standby {standby}")
    by_mode = {m: [r for r in runs if r["mode"] == m] for m in ("off", "on")}
    return {
        "grown_nodes": WARMER_GROWN_NODES,
        "grown_bucket": [NORTH_STAR_SHAPE[0], WARMER_GROWN_BUCKET],
        "first_grown_batch_ms": {m: [r["grown"][0]["batch_ms"] for r in rs]
                                 for m, rs in by_mode.items()},
        "second_grown_batch_ms": {m: [r["grown"][1]["batch_ms"] for r in rs]
                                  for m, rs in by_mode.items()},
        "north_star_batch_ms": {m: [r["north_star_batch_ms"] for r in rs]
                                for m, rs in by_mode.items()},
        "warm_wait_s": [r["warm_wait_s"] for r in by_mode["on"]],
        "counters_on": [r["stats"] for r in by_mode["on"]],
        "launches": {r["mode"]: r["launches"]["assign_scan"] for r in (primary, standby)},
        "launches_by_child": [(r["mode"], r["batches"], r["warm_batches"])
                              for r in (*runs, primary, standby)],
        "plans_equal": True,
        "replication": {"warmup_s": [primary["warmup_s"], standby["warmup_s"]],
                        "primary_request_ms": primary["request_ms"],
                        "standby_request_ms": standby["request_ms"],
                        "standby_warm_wait_s": standby["warm_wait_s"],
                        "standby_counters": standby["stats"]},
    }


def note_path(results, kernel, path, n):
    """A path's launches of ``kernel`` into the kernels line (kept for the
    end when the kernel's first phase has not reported)."""
    if kernel in results:
        results[kernel]["launches_by_path"][path] = n
    else:
        LATE_PATHS[(kernel, path)] = n


def card_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e!r}"
    return out.splitlines()[0] if out else "nvidia-smi printed nothing"


def main() -> int:
    if sys.argv[1:] == ["--lockcheck-child"]:
        return lockcheck_child()
    if sys.argv[1:2] == ["--warmer-child"] and len(sys.argv) == 3:
        return warmer_child(sys.argv[2])
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    try:
        import batch_scheduler_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run from the repository root (batch_scheduler_tpu_torch "
              "not found)", file=sys.stderr)
        return 2

    results = {}
    if build() is None:
        return 1
    north_star(results)
    mixed()
    global_leftover()
    race(results)
    north_star_churn(results)
    churn_loop(results)
    policy(results)
    policy_identity(results)
    preemption(results)
    audit_replay(results)
    sidecar(results)
    coalesce_span(results)
    coalesce_mega(results)
    coalesce_drf(results)
    coalesce_busy(results)
    capacity(results)
    north_star_wave(results)
    mixed_wave(results)
    race_wave(results)
    north_star_churn_wave(results)
    metrics(results)
    churn_loop_wave(results)
    policy_wave(results)
    audit_replay_wave(results)
    sidecar_wave(results)
    coalesce_span_wave(results)
    observability(results)
    observability_wave(results)
    explain_whatif(results)
    explain_whatif_wave(results)
    north_star_topk(results)
    xl_topk(results)
    framework_e2e(results)
    framework_e2e_wave(results)
    http_e2e(results)
    sim_scenarios(results)
    chaos(results)
    warmer(results)
    cli_serial(results)
    cli_wave(results)
    lockcheck_phase(results)
    cli_main(results)
    for (kernel, path), n in LATE_PATHS.items():
        if kernel in results:
            results[kernel]["launches_by_path"][path] = n

    sources = {
        "assign_scan": ("batch_scheduler_tpu_torch/csrc/assign_scan.cu",
                        "batch_scheduler_tpu/ops/pallas_assign.py:63"),
        "assign_wave": ("batch_scheduler_tpu_torch/csrc/assign_wave.cu",
                        "batch_scheduler_tpu/ops/pallas_assign.py:104"),
        # the policy variant of the serial kernel (assign_scan.cu built with
        # BST_POLICY_SCAN); its reference is the lax rung assign_gangs_policy
        "assign_policy": ("batch_scheduler_tpu_torch/csrc/assign_scan.cu",
                          "batch_scheduler_tpu/ops/oracle.py:438"),
        # the top-K rung's cluster kernel; its reference is the lax rung
        # assign_gangs_topk
        "assign_topk": ("batch_scheduler_tpu_torch/csrc/assign_topk.cu",
                        "batch_scheduler_tpu/ops/oracle.py:1156"),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "library_ms": None, **results[name]}
        for name in KERNELS if name in results
    ]
    print(card_line(), flush=True)
    emit({"kernels": kernels})
    failed = [name for name, ok in PHASES if not ok]
    if failed or len(kernels) != len(KERNELS):
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
