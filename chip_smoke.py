#!/usr/bin/env python3
"""Smoke of the PyTorch/CUDA port (batch_scheduler_tpu_torch) on one NVIDIA
GPU: builds the port's kernels from csrc/, drives its gang-admission path
at the north-star size, and holds every kernel against its plain PyTorch
version.

Run from the repository root:  python3 chip_smoke.py

Phases (one JSON line each; any failure makes the exit code non-zero):

- build            nvcc csrc/assign_scan.cu (twice: the serial kernel, and
                   with -DBST_POLICY_SCAN its policy variant) and
                   csrc/assign_wave.cu, one nvcc each, started together, into
                   the gitignored build/
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
                   up while a thread refreshes 4 more times: every ported
                   route 200 with the reference's keys, the left-out ones
                   404; mixed's node shapes and gang demands (seed 11)
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

Then the card's name and power limit (nvidia-smi), one ``kernels`` line and,
last, ``{"ok": true, "device": {...}}``. Launch counts are read for each
path that drives the scorer or the re-scorer — north_star, race,
north_star_churn, churn_loop, policy, audit_replay (and its policy ring),
sidecar, coalesce_span, coalesce_mega, coalesce_drf, coalesce_busy,
capacity, north_star_wave, race_wave, north_star_churn_wave,
churn_loop_wave, policy_wave, audit_replay_wave, sidecar_wave,
coalesce_span_wave, metrics, metrics_wave, observability(_wave) and its
scrape, mixed, policy and sidecar paths, explain_whatif(_wave)'s explain
scan, what-if rungs, storm, blame and latency paths, lockcheck (counted
in its child), and the audit phases' replays
(``audit_replay_replays``, ``audit_replay_wave_replays``,
``audit_replay_policy_replays``) — with every kernel's count zeroed just
before the path and read just after; ``launches`` in the kernels line is
the path's of the kernel's first phase (north_star, north_star_wave,
policy), ``launches_by_path`` holds each path. Comparison and timing
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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# int32 rate: the data sheet's 67 TFLOP/s float32 counts an FMA as two
# operations on 128 lanes per SM; Hopper has 64 int32 lanes per SM.
INT32_OPS_PER_S = 67e12 / 4
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


def profile_window(fn, wall_key):
    """``fn()`` under torch.profiler, the card synchronized at its end: its
    wall clock (under ``wall_key``), the device's busy time (sum of kernel
    and copy self-times on the card, whichever thread launched them), the
    idle share and the five device ops that took longest."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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


def scan_bound(left, group_req, remaining, fit_mask, order, wave=0):
    """(bound_ms, bound_by, bytes, ops) of one scan on these inputs: each
    input read once and each output written once over HBM bandwidth, vs
    the integer operations these inputs need over the int32 rate (per
    gang and node: a division and a minimum per lane the gang requests,
    plus the mask, need clip, bin key, histogram add, threshold compare
    and take select). The wavefront scan computes the same function plus
    two flag bytes per wave (``wave`` > 0)."""
    n, r = left.shape
    g = group_req.shape[0]
    in_bytes = sum(t.numel() * t.element_size()
                   for t in (left, group_req, remaining, fit_mask, order))
    out_bytes = g * n * 4 + g + n * r * 4 + (2 * -(-g // wave) if wave else 0)
    lanes = int((group_req > 0).sum().item())
    ops = n * (2 * lanes + 6 * g)
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S
    t_ops = ops / INT32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            in_bytes + out_bytes, ops)


def counters():
    """The port's kernel wrappers by kernel name; each counts its launches
    in ``.launches``."""
    from batch_scheduler_tpu_torch.ops.assign_scan import (
        assign_gangs_cuda, assign_gangs_policy_cuda, assign_gangs_wave_cuda)

    return {"assign_scan": assign_gangs_cuda, "assign_wave": assign_gangs_wave_cuda,
            "assign_policy": assign_gangs_policy_cuda}


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

KERNELS = ("assign_scan", "assign_wave", "assign_policy")


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
            or launches["assign_policy"] != 0:
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
            or launches["assign_policy"] != 0:
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
            or launches["assign_policy"] != 0:
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
            or launches["assign_policy"] != 0:
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
}
OBS_LEFT_OUT = ("/debug/buckets", "/debug/perf", "/debug/profile", "/debug/drain")


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
    """Every ported route once: 200 and the reference's keys (``/metrics``
    with the batch series, ``/healthz`` ok); every left-out route 404.
    Returns ({route: ms}, problems)."""
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
    for route in OBS_LEFT_OUT:
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
        if launches["assign_policy"] != 1 or launches["assign_scan"] or launches["assign_wave"]:
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
    if launches["assign_scan"] != want or launches["assign_wave"] or launches["assign_policy"]:
        raise AssertionError(f"launches {launches} (want assign_scan {want}: {refreshes} "
                             f"refreshes and the storm's groups {out['groups']})")
    if "assign_scan" in results:
        results["assign_scan"]["launches_by_path"]["lockcheck"] = launches["assign_scan"]
    out["lock_violations"] = 0
    return out


# the audit phases: north_star_churn's deployment and churn recorded to an
# audit ring in each format (format, keyframe_every), AUDIT_ROUNDS churn
# rounds after the first refresh, the identity audit on every 2nd batch
AUDIT_RINGS = (("array", 16), ("v2", 4))
AUDIT_ROUNDS = 12
AUDIT_IDENTITY_EVERY = 2
AUDIT_CPU_REPLAYS = 3  # cpu-ladder replays: the last records of each ring
AUDIT_TIMING_ROUNDS = 12  # report-only: pairs of refreshes, audit off / on


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
    if launches != {"assign_scan": 0, "assign_wave": 0, "assign_policy": report["records"]}:
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
    if launches != {"assign_scan": batches, "assign_wave": 0, "assign_policy": 0}:
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
    if launches != {"assign_scan": 0, "assign_wave": batches, "assign_policy": 0}:
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
    want = {"assign_scan": report["batches"], "assign_wave": 0, "assign_policy": 0}
    if launches != want:
        raise AssertionError(f"{launches} launches in {report['batches']} tenant batches "
                             "(want assign_scan once per batch)")
    if "assign_scan" in results:
        results["assign_scan"]["launches_by_path"]["coalesce_span"] = launches["assign_scan"]
    return report


@phase("coalesce_span_wave")
def coalesce_span_wave(results):
    launches, report = drive_coalesce_span(8)
    want = {"assign_scan": 0, "assign_wave": report["batches"], "assign_policy": 0}
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
    if launches != {"assign_scan": stats["groups_run"], "assign_wave": 0, "assign_policy": 0}:
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
            or launches != {"assign_scan": batches, "assign_wave": 0, "assign_policy": 0}:
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
    if launches != {"assign_scan": batches, "assign_wave": 0, "assign_policy": 0}:
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
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S
    t_ops = ops / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


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
    if launches != {"assign_scan": CAPACITY_ROUNDS, "assign_wave": 0, "assign_policy": 0}:
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
            or launches["assign_policy"] != 0:
        raise AssertionError(f"{launches} launches in {dispatches} dispatched ticks "
                             "(want assign_scan once a tick, assign_wave never)")
    if "assign_scan" in results:
        results["assign_scan"]["launches_by_path"]["churn_loop"] = launches["assign_scan"]
    return {**report, "launches": launches["assign_scan"]}


@phase("churn_loop_wave")
def churn_loop_wave(results):
    launches, dispatches, report = drive_churn_loop(8)
    if launches["assign_wave"] != dispatches or launches["assign_scan"] != 0 \
            or launches["assign_policy"] != 0:
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
            or launches["assign_policy"] != 0:
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
            or launches["assign_policy"] != 0:
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


def policy_bound(args, cols):
    """scan_bound of the policy scan: the serial scan's bytes plus the
    node columns it reads (4 label hashes and a domain, 20 bytes a node)
    and the gang columns (aff, anti and 16 domain counts, 72 bytes a gang),
    and its operations plus, per gang and node, the 8 hash compares, the
    domain clamp and read, the penalty and the key (~14)."""
    n, g = args[0].shape[0], args[1].shape[0]
    bound_ms, bound_by, nbytes, ops = scan_bound(*args)
    nbytes += n * 20 + g * 72
    ops += 14 * n * g
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            nbytes, ops)


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
    if launches != {"assign_scan": 0, "assign_wave": 0, "assign_policy": n}:
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
    bound_ms, bound_by, nbytes, ops = policy_bound(args, cols)
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
    if launches != {"assign_scan": 0, "assign_wave": 0, "assign_policy": n}:
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
    if replays != {"assign_scan": 0, "assign_wave": 0, "assign_policy": len(batches)}:
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
WHATIF_REPS = 7  # warm what-if queries and steady batches timed for the medians
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
    lockcheck_phase(results)
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
