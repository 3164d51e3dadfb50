"""``python -m batch_scheduler_tpu_torch`` — the port's CLI entry point, the
counterpart of ``batch_scheduler_tpu/cmd/main.py`` with the same nine
commands, flags and defaults:

  sim           run the full scheduler over a simulated cluster (scenario
                generators or -f Kubernetes manifests), print the outcome
  serve         run the oracle sidecar service (packed-array protocol)
  replay        re-execute recorded batches from an audit ring
  explain       why is this gang pending (live or from an audit ring)
  whatif        score a counterfactual against a live scheduler
  capacity      the capacity observatory (live or from an audit ring)
  timeline      a gang's lifecycle story (live or from an audit ring)
  check-config  validate a scheduler configuration JSON
  version       print the build stamp

``--config`` takes the same JSON shape as the reference's
``KubeSchedulerConfiguration`` (extension points + pluginConfig args).

The port's deltas from the reference:

- ``--device {cuda,cpu}`` on every command that can touch the device
  (``sim``, ``serve``, ``replay``, ``explain``, ``capacity``), ``cuda`` by
  default. Without a card a ``cuda`` command exits 2 naming the missing
  card: the reference's degrade-to-CPU probe is not carried over, and
  neither is its persistent XLA compilation cache (the kernel libraries'
  build directory, ``ops._build``, is the port's).
- ``--compile-warmer`` (``sim``, ``serve``) runs the bucket warmer
  (``ops.bucketing.CompileWarmer``) on the card.
- Refused with exit 2, never ignored: ``--device-state off`` (the port
  always keeps the cluster state on the device) and ``serve`` with
  ``BST_COORDINATOR`` set (no multi-process bootstrap yet).
- ``--oracle-background-refresh`` with ``--oracle-addr`` runs on the
  resilient client's second connection slot (the port's ``RemoteScorer``
  has no separate background client).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from typing import Dict, List, Optional

from .config import load_scheduler_config
from ..utils.labels import POD_GROUP_LABEL

DEVICES = ("cuda", "cpu")


def _add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--device", choices=DEVICES, default="cuda",
        help="where batches run: 'cuda' (the default: the card; the "
             "command exits 2 without one) or 'cpu' (the kernels' plain "
             "versions)",
    )


def _require_device(args) -> bool:
    """True when the asked device is there. ``cuda`` without a card prints
    an error naming it and the caller exits 2: there is no CPU fallback."""
    if getattr(args, "device", "cuda") != "cuda":
        return True
    import torch

    if torch.cuda.is_available():
        return True
    print(
        "error: --device cuda: no CUDA card is visible "
        "(torch.cuda.is_available() is False); pass --device cpu to run "
        "the plain versions on the CPU",
        file=sys.stderr,
    )
    return False


def _refused(what: str) -> int:
    print(f"error: {what}", file=sys.stderr)
    return 2


def _add_config_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--config",
        default=None,
        help="scheduler configuration JSON (KubeSchedulerConfiguration shape)",
    )


def _add_metrics_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--metrics-port", type=int, default=None, metavar="PORT",
        help="serve Prometheus /metrics (+/healthz, /debug/trace, "
             "/debug/decisions) on this port (0 = ephemeral; the bound "
             "port is printed)",
    )


def _add_profile_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--profile-dir", default=None, metavar="DIR",
        help="directory for on-demand torch.profiler captures "
             "(/debug/profile?seconds=N on --metrics-port writes bounded "
             "trace dirs here; default: a per-process tmpdir)",
    )


def _start_profiler(args) -> None:
    """Shared sim/serve profiler bring-up: capture dir + the device-memory
    gauge sampler (daemon; a process asked for the CPU has no device
    memory and the sampler exits after its first empty pass)."""
    from ..utils import profiler as profiler_mod

    profiler_mod.configure(profile_dir=getattr(args, "profile_dir", None),
                           device=args.device)
    profiler_mod.start_memory_sampler()


def _add_trace_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--trace", action="store_true",
        help="record spans for the full decision path (cycle -> gang "
             "transaction -> oracle batch -> wire -> device scan -> bind) "
             "into a bounded ring; sim exports a Chrome-trace JSON on "
             "exit, and --metrics-port serves the live ring at "
             "/debug/trace (docs/observability.md)",
    )
    p.add_argument(
        "--trace-dir", default=".", metavar="DIR",
        help="directory the Chrome-trace JSON is written to on exit "
             "(sim only; default: current directory)",
    )
    p.add_argument(
        "--trace-sample", type=float, default=1.0, metavar="FRACTION",
        help="fraction of scheduling cycles traced (children follow "
             "their root's fate; 1.0 = every cycle)",
    )


def _add_audit_flags(p: argparse.ArgumentParser, identity: bool = False) -> None:
    p.add_argument(
        "--audit-dir", default=None, metavar="DIR",
        help="record every oracle batch (the exact packed inputs + the "
             "resulting plan digest) into a bounded on-disk audit ring in "
             "DIR, written off the hot path — the black-box flight data "
             "the `replay` subcommand re-executes deterministically "
             "(docs/observability.md)",
    )
    p.add_argument(
        "--audit-cap-mb", type=int, default=256, metavar="MB",
        help="total size cap of the audit ring; oldest segments are "
             "deleted first (default: 256)",
    )
    p.add_argument(
        "--lifecycle-dir", default=None, metavar="DIR",
        help="stream gang lifecycle events (arrival/admission/deny "
             "streaks/eviction/permit/bind — utils.lifecycle) as bounded "
             "JSONL into DIR/events.jsonl, size-rotated to events.jsonl.1 "
             "(cap: BST_LIFECYCLE_EXPORT_MAX_MB); the offline half of "
             "/debug/events (docs/observability.md 'Gang lifecycle')",
    )
    if identity:
        p.add_argument(
            "--identity-audit-every", type=int, default=0, metavar="K",
            help="in-production identity audit: re-verify every Kth "
                 "non-speculative batch bit-for-bit on the CPU fallback "
                 "rung (daemon thread); a mismatch breaches /debug/health "
                 "and flags the audit ring (0 = off)",
        )


def _maybe_audit_log(args):
    if not getattr(args, "audit_dir", None):
        return None
    from ..utils.audit import AuditLog

    log = AuditLog(
        args.audit_dir, cap_bytes=max(args.audit_cap_mb, 1) * 1024 * 1024
    )
    print(
        f"audit ring: {args.audit_dir} (cap {args.audit_cap_mb} MB, "
        f"format {log.fmt})",
        flush=True,
    )
    return log


def _maybe_lifecycle(args, audit_log=None) -> None:
    """Wire the gang lifecycle ledger's sinks: mirror occurrences into
    the audit ring (the `timeline --audit-dir` / slo_gate evidence
    chain) and, with --lifecycle-dir, the bounded JSONL export. MUST run
    AFTER the cluster/operation is constructed — ScheduleOperation
    resets DEFAULT_LEDGER at construction (per-run isolation), which
    detaches sinks."""
    from ..utils.lifecycle import DEFAULT_LEDGER

    if audit_log is not None:
        DEFAULT_LEDGER.attach_audit(audit_log)
    if getattr(args, "lifecycle_dir", None):
        DEFAULT_LEDGER.set_export_dir(args.lifecycle_dir)
        print(
            f"lifecycle export: "
            f"{os.path.join(args.lifecycle_dir, 'events.jsonl')}",
            flush=True,
        )


def _maybe_configure_trace(args) -> bool:
    if not getattr(args, "trace", False):
        return False
    from ..utils import trace as trace_mod

    trace_mod.configure(enabled=True, sample=args.trace_sample)
    return True


def _export_trace(args) -> None:
    from ..utils import trace as trace_mod

    os.makedirs(args.trace_dir, exist_ok=True)
    path = os.path.join(
        args.trace_dir, f"bst-trace-{os.getpid()}.json"
    )
    trace_mod.DEFAULT_RECORDER.export(path)
    n = len(trace_mod.DEFAULT_RECORDER.snapshot())
    print(f"trace written: {path} ({n} spans)", flush=True)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="batch-scheduler-tpu-torch",
        description="gang/batch scheduling framework, PyTorch and CUDA",
    )
    parser.add_argument("--v", type=int, default=0, help="log verbosity (klog-style)")
    sub = parser.add_subparsers(dest="command", required=True)

    sim = sub.add_parser("sim", help="run the scheduler over a simulated cluster")
    _add_config_flag(sim)
    sim.add_argument(
        "-f",
        "--filename",
        action="append",
        default=[],
        help="Kubernetes manifest(s) to apply (PodGroup/Pod/Node/workloads)",
    )
    sim.add_argument(
        "--scenario",
        choices=["race", "synthetic", "spot-vs-guaranteed"],
        default=None,
    )
    sim.add_argument("--scorer", choices=["oracle", "serial"], default=None,
                     help="override the scorer gate (oracle = the batch on "
                          "--device)")
    sim.add_argument("--oracle-addr", default=None,
                     metavar="HOST:PORT[,HOST:PORT...]",
                     help="score via a remote oracle sidecar (see `serve`) "
                          "instead of the in-process oracle; a comma list "
                          "names warm standbys after the primary — the "
                          "client promotes on DRAINING (graceful drain) or "
                          "breaker-open (crash), see docs/resilience.md "
                          "\"High availability\"")
    sim.add_argument(
        "--oracle-fallback", choices=["deny", "local-cpu"], default="deny",
        help="behavior when the sidecar transport is down (breaker open / "
             "retries exhausted): 'deny' surfaces the error into the cycle "
             "(pods requeue with backoff); 'local-cpu' serves a "
             "conservative host-side batch — deny only provably-infeasible "
             "gangs, admit nothing speculatively (docs/resilience.md)",
    )
    sim.add_argument(
        "--oracle-deadline-ms", type=int, default=None, metavar="MS",
        help="per-request budget propagated to the sidecar: a batch "
             "stalled past it (e.g. a first kernel build) answers an "
             "in-band deadline error within ~2x the budget instead of "
             "holding the scheduling cycle",
    )
    sim.add_argument("--nodes", type=int, default=0,
                     help="synthetic nodes to add (in addition to manifests)")
    sim.add_argument("--node-cpu", default="32")
    sim.add_argument("--node-memory", default="128Gi")
    sim.add_argument("--groups", type=int, default=10, help="synthetic scenario groups")
    sim.add_argument("--members", type=int, default=5, help="pods per synthetic group")
    sim.add_argument("--timeout", type=float, default=60.0)
    sim.add_argument(
        "--oracle-background-refresh",
        action="store_true",
        help="re-batch the oracle on a daemon thread while cycles keep "
             "reading the stale (known-complete) batch — takes the device "
             "round-trip off the scheduling critical path",
    )
    sim.add_argument(
        "--dispatch-ahead",
        action="store_true",
        help="speculatively pack + dispatch batch N+1 while the control "
             "plane works against batch N; a later refresh publishes it "
             "without a blocking device round-trip iff nothing changed "
             "since it packed (bit-identical plans either way — "
             "docs/pipelining.md). With --oracle-addr the client gets an "
             "in-flight window of 2 connections",
    )
    sim.add_argument(
        "--compile-warmer",
        action="store_true",
        help="run one batch at each (G, N) bucket shape adjacent to the "
             "live working set on a daemon thread, so a bucket transition "
             "finds the kernel loaded and its plan cached (in-process "
             "oracle; for --oracle-addr pass --compile-warmer to `serve` "
             "instead)",
    )
    sim.add_argument(
        "--device-state", choices=["on", "off"], default=None,
        help="device-resident cluster state: the port always keeps the "
             "packed [N,R]/[G,R] buffers on the device and scatters churned "
             "rows (with --oracle-addr the sidecar keeps them, fed by wire "
             "deltas); 'on' is accepted, 'off' refused",
    )
    sim.add_argument(
        "--policy", default=None, metavar="TERMS",
        help="enable the vectorized policy engine (docs/policy.md): a "
             "comma list of terms from "
             "{affinity,anti-affinity,spread,preempt}, or 'all'. "
             "Equivalent to BST_POLICY; weights ride the BST_POLICY_* "
             "knobs. Empty/off = the exact pre-policy scan paths",
    )
    sim.add_argument(
        "--multi-client", type=int, default=0, metavar="K",
        help="multi-tenant coalescer mode (docs/multitenancy.md): instead "
             "of the full framework sim, drive K concurrent scheduler "
             "clients' deterministic oracle streams through ONE sidecar "
             "(--oracle-addr, or an in-process coalescing sidecar when "
             "omitted) and print aggregate throughput + per-tenant queue "
             "waits; --nodes/--groups size each tenant's cluster",
    )
    sim.add_argument(
        "--mc-batches", type=int, default=8, metavar="B",
        help="batches per client in --multi-client mode",
    )
    _add_device_flag(sim)
    _add_metrics_flag(sim)
    _add_profile_flag(sim)
    _add_trace_flags(sim)
    _add_audit_flags(sim, identity=True)
    sim.add_argument("--settle", type=float, default=3.0,
                     help="finish early once group phases and bound counts "
                          "have been stable this many seconds (a denied gang "
                          "never reaches a terminal phase)")

    serve = sub.add_parser("serve", help="run the oracle sidecar service")
    serve.add_argument("--host", default="127.0.0.1")
    serve.add_argument("--port", type=int, default=9090)
    serve.add_argument(
        "--warmup",
        action="store_true",
        help="run one batch of the smallest bucket before accepting "
             "traffic (builds or loads the kernel libraries)",
    )
    serve.add_argument(
        "--compile-warmer",
        action="store_true",
        help="keep a background thread running one batch at each (G, N) "
             "bucket shape adjacent to live traffic, so bucket transitions "
             "find the kernel loaded and its plan cached (hit/miss counters in "
             "/metrics and the traced telemetry)",
    )
    serve.add_argument(
        "--coalesce",
        action="store_true",
        help="multi-tenant cross-client coalescer (docs/multitenancy.md): "
             "merge compatible pending batches from different connections "
             "in a DRF-fair admission order in front of the device "
             "executor (single-device servers only; equivalent to "
             "BST_COALESCE=1 — depth/fairness ride the BST_COALESCE_* "
             "knobs)",
    )
    _add_device_flag(serve)
    _add_metrics_flag(serve)
    _add_profile_flag(serve)
    _add_trace_flags(serve)
    _add_audit_flags(serve)

    rep = sub.add_parser(
        "replay",
        help="deterministically re-execute recorded oracle batches from "
             "an audit ring (`sim`/`serve` --audit-dir) and bit-compare "
             "the plans against their recorded digests",
    )
    rep.add_argument(
        "audit_dir",
        help="audit ring directory written by a --audit-dir run",
    )
    sel = rep.add_mutually_exclusive_group()
    sel.add_argument(
        "--batch", type=int, default=None, metavar="K",
        help="replay only the record with seq K",
    )
    sel.add_argument(
        "--all", action="store_true",
        help="replay every reconstructable record (the default)",
    )
    rep.add_argument(
        "--against", default="steady",
        choices=("steady", "wavefront", "cpu-ladder", "topk"),
        help="the rung to re-execute on: 'steady' = exactly what this "
             "process would dispatch now (same-backend bit-identity); "
             "'wavefront' = the wavefront scan forced on; 'cpu-ladder' = "
             "the serial fallback rung pinned to a CPU device (the "
             "cross-backend divergence probe); 'topk' = the hierarchical "
             "top-K scan forced on (the XL-tier rung)",
    )
    rep.add_argument(
        "--json", default=None, metavar="PATH",
        help="also write the summary JSON (with full blame reports) here",
    )
    _add_device_flag(rep)

    exp = sub.add_parser(
        "explain",
        help="why is this gang pending — structured denial breakdown "
             "(per-lane deficits, binding lane, near-miss nodes, "
             "preemption candidacy) from a live scheduler's "
             "/debug/explain or offline from an audit ring "
             "(docs/observability.md 'Explain')",
    )
    exp.add_argument("gang", help="the gang's full name (namespace/name)")
    exp_src = exp.add_mutually_exclusive_group(required=True)
    exp_src.add_argument(
        "--addr", metavar="HOST:PORT",
        help="a live scheduler's --metrics-port endpoint "
             "(queries /debug/explain)",
    )
    exp_src.add_argument(
        "--audit-dir", metavar="DIR",
        help="explain offline from a recorded audit ring (the exact "
             "packed inputs of a recorded batch; lane names degrade to "
             "lane<i> — the record carries no schema)",
    )
    exp.add_argument(
        "--batch", type=int, default=None, metavar="K",
        help="with --audit-dir: explain the record with seq K "
             "(default: the newest reconstructable record)",
    )
    _add_device_flag(exp)

    wi = sub.add_parser(
        "whatif",
        help="score a counterfactual against a live scheduler's cluster "
             "state on a forked device-resident buffer and print the "
             "placement diff (docs/observability.md 'What-if')",
    )
    wi.add_argument(
        "--addr", required=True, metavar="HOST:PORT",
        help="a live scheduler's --metrics-port endpoint "
             "(queries /debug/whatif)",
    )
    wi_kind = wi.add_mutually_exclusive_group(required=True)
    wi_kind.add_argument("--drain", metavar="NODE",
                         help="remove NODE (and its load) from the cluster")
    wi_kind.add_argument("--cordon", metavar="NODE",
                         help="mark NODE unschedulable, load kept")
    wi_kind.add_argument("--add-nodes", type=int, metavar="N",
                         help="add N nodes of --node-cpu/--node-memory")
    wi_kind.add_argument("--bump-gang", metavar="NS/NAME",
                         help="set a gang's priority tier to --tier")
    wi_kind.add_argument("--remove-gang", metavar="NS/NAME",
                         help="remove a gang from the queue")
    wi.add_argument("--tier", type=int, default=None,
                    help="the priority tier for --bump-gang")
    wi.add_argument("--node-cpu", default="32",
                    help="shape of --add-nodes nodes (default 32)")
    wi.add_argument("--node-memory", default="128Gi",
                    help="shape of --add-nodes nodes (default 128Gi)")
    wi.add_argument("--node-pods", default="110",
                    help="pod capacity of --add-nodes nodes (default 110)")
    wi.add_argument(
        "--rung", default="steady",
        choices=("steady", "wavefront", "cpu-ladder", "topk"),
        help="the scan rung the what-if scores on (non-steady rungs are "
             "thread-locally pinned — the replay discipline; plans are "
             "bit-identical across rungs by construction)",
    )

    cap = sub.add_parser(
        "capacity",
        help="the capacity observatory: per-lane utilization/headroom "
             "spectra, fragmentation index, stranded capacity, tenant "
             "shares — live from a scheduler's /debug/capacity, or "
             "offline by replaying a recorded audit ring through the "
             "same analytics kernel (bit-identical to the live series — "
             "docs/observability.md 'Capacity observatory')",
    )
    cap_src = cap.add_mutually_exclusive_group(required=True)
    cap_src.add_argument(
        "--addr", metavar="HOST:PORT",
        help="a live scheduler's --metrics-port endpoint "
             "(queries /debug/capacity)",
    )
    cap_src.add_argument(
        "--audit-dir", metavar="DIR",
        help="replay a recorded audit ring offline: recompute the "
             "capacity summary of every reconstructable batch and "
             "bit-compare against the ring's recorded capacity_sample "
             "events (exit 1 on divergence)",
    )
    cap.add_argument(
        "--batch", type=int, default=None, metavar="K",
        help="with --audit-dir: only the record with seq K",
    )
    cap.add_argument(
        "--points", type=int, default=None, metavar="K",
        help="with --addr: trim the returned series to the newest K "
             "points",
    )
    cap.add_argument(
        "--json", default=None, metavar="PATH",
        help="also write the summary JSON (offline mode: the replayed "
             "series + comparison verdicts) here",
    )
    _add_device_flag(cap)

    tl = sub.add_parser(
        "timeline",
        help="a gang's reconstructed lifecycle story — arrival, "
             "admission, deny streaks, preemption eviction/respawn, "
             "permit, bind — with the phase-decomposed time-to-placement "
             "(queue/scheduling/sidecar/bind waits), live from a "
             "scheduler's /debug/gangs or offline by re-folding a "
             "recorded audit ring's gang_lifecycle events "
             "(docs/observability.md 'Gang lifecycle')",
    )
    tl.add_argument(
        "gang", nargs="?", default=None,
        help="the gang's full name (namespace/name); omit to list every "
             "recorded gang (scope with --tenant/--limit)",
    )
    tl_src = tl.add_mutually_exclusive_group(required=True)
    tl_src.add_argument(
        "--addr", metavar="HOST:PORT",
        help="a live scheduler's --metrics-port endpoint "
             "(queries /debug/gangs)",
    )
    tl_src.add_argument(
        "--audit-dir", metavar="DIR",
        help="reconstruct offline from a recorded audit ring: re-fold "
             "its gang_lifecycle event records through the live ledger's "
             "coalesce rule (byte-identical timelines — the slo_gate "
             "contract)",
    )
    tl.add_argument("--tenant", default=None, metavar="T",
                    help="scope to one tenant's gangs")
    tl.add_argument("--limit", type=int, default=None, metavar="K",
                    help="only the K most recently active gangs")
    tl.add_argument(
        "--json", default=None, metavar="PATH",
        help="also write the timelines JSON here",
    )

    chk = sub.add_parser("check-config", help="validate a scheduler config JSON")
    _add_config_flag(chk)

    sub.add_parser("version", help="print the build stamp")
    return parser


def cmd_version(_args) -> int:
    from ..version import version_string

    print(version_string())
    return 0


def cmd_check_config(args) -> int:
    cfg = load_scheduler_config(args.config)
    print(
        json.dumps(
            {
                "valid": True,
                "scorer": cfg.plugin_config.scorer,
                "max_schedule_minutes": cfg.plugin_config.max_schedule_minutes,
                "enabled_points": sorted(cfg.enabled_points),
                "controller_workers": cfg.plugin_config.controller_workers,
                "min_batch_interval_seconds": (
                    cfg.plugin_config.min_batch_interval_seconds
                ),
                "oracle_background_refresh": (
                    cfg.plugin_config.oracle_background_refresh
                ),
                "oracle_dispatch_ahead": (
                    cfg.plugin_config.oracle_dispatch_ahead
                ),
                "oracle_compile_warmer": (
                    cfg.plugin_config.oracle_compile_warmer
                ),
            }
        )
    )
    return 0


def warm_oracle(nodes=None, groups=None, pods=None, remote_scorer=None,
                device="cuda") -> float:
    """Run one batch of the bucket the given cluster will actually hit
    (falling back to the smallest bucket) on ``device`` before traffic, so
    the first real batch does not pay for building or loading the kernel
    libraries (``ops._build``) and the bucket's scratch inside a
    scheduling callback; the build directory is the cache across
    processes. With ``remote_scorer`` the warm batch is sent through the
    sidecar wire path instead — warming the *server*, the only one a
    remote run exercises. Returns elapsed seconds."""
    from ..ops.oracle import execute_batch_host
    from ..ops.snapshot import ClusterSnapshot, GroupDemand
    from ..sim.scenarios import make_sim_node

    t0 = time.perf_counter()
    warm_nodes = list(nodes) if nodes else [
        make_sim_node("warm", {"cpu": "8", "memory": "32Gi", "pods": "110"})
    ]
    rep_pods: Dict[str, object] = {}
    for pod in pods or []:
        label = pod.metadata.labels.get(POD_GROUP_LABEL)
        if label and label not in rep_pods:
            rep_pods[label] = pod
    warm_groups = []
    for pg in groups or []:
        rep = rep_pods.get(pg.metadata.name)
        warm_groups.append(
            GroupDemand(
                f"{pg.metadata.namespace}/{pg.metadata.name}",
                pg.spec.min_member,
                member_request=dict(
                    pg.spec.min_resources
                    or (rep.resource_require() if rep else None)
                    or {"cpu": 1000}
                ),
                # selectors/tolerations decide the fit-mask mode ([1,N]
                # broadcast vs full [G,N]) — warm what traffic will hit
                node_selector=dict(rep.spec.node_selector) if rep else {},
                tolerations=list(rep.spec.tolerations) if rep else [],
            )
        )
    warm_groups = warm_groups or [
        GroupDemand("default/warm", 1, member_request={"cpu": 1000})
    ]
    snap = ClusterSnapshot(warm_nodes, {}, warm_groups)
    if remote_scorer is not None:
        remote_scorer._execute(snap)
    else:
        execute_batch_host(snap.device_args(), snap.progress_args(), device=device)
    return time.perf_counter() - t0


def _maybe_serve_metrics(args):
    """--metrics-port wiring shared by sim and serve: the reference's only
    observability surface is the embedded kube-scheduler's /metrics
    (SURVEY §5); ours exposes the bst_* series over the same protocol."""
    if getattr(args, "metrics_port", None) is None:
        return None
    from ..utils.metrics import serve_metrics

    server = serve_metrics(host="0.0.0.0", port=args.metrics_port)
    print(f"metrics on :{server.server_address[1]}/metrics", flush=True)
    return server


def cmd_replay(args) -> int:
    """Deterministic replay: reconstruct recorded batches from the audit
    ring, re-execute each on the requested rung, and bit-compare the plan
    digests. Exit 0 = all replayed batches identical; 1 = at least one
    divergence (the structured blame reports are in the summary JSON);
    2 = nothing replayable."""
    from ..core.oracle_scorer import replay_audit_record
    from ..utils.audit import AuditReader

    if not _require_device(args):
        return 2
    batches, skipped = AuditReader(args.audit_dir).batches()
    if skipped:
        print(
            f"note: {len(skipped)} record(s) unreconstructable (ring "
            "rotated past their keyframe)",
            file=sys.stderr,
        )
    if not batches:
        print(
            f"error: no reconstructable batch records in {args.audit_dir}",
            file=sys.stderr,
        )
        return 2
    if args.batch is not None:
        selected = [r for r in batches if r.get("seq") == args.batch]
        if not selected:
            print(
                f"error: no batch with seq {args.batch} (have seqs "
                f"{batches[0].get('seq')}..{batches[-1].get('seq')})",
                file=sys.stderr,
            )
            return 2
    else:
        selected = batches
    reports, divergent, skipped_degraded = [], 0, 0
    for rec in selected:
        rep = replay_audit_record(rec, against=args.against, device=args.device)
        reports.append(rep)
        if rep.get("skipped"):
            skipped_degraded += 1
            print(
                f"batch seq={rep['seq']} audit_id={rep['audit_id']} "
                f"skipped: {rep['skipped']}",
                flush=True,
            )
            continue
        if rep["identical"]:
            fell_back = (
                " (WARNING: requested rung fell back to serial)"
                if rep.get("rung_fell_back") else ""
            )
            refolded = " (re-folded)" if rep.get("refolded") else ""
            print(
                f"batch seq={rep['seq']} audit_id={rep['audit_id']} "
                f"[{args.against}] identical{refolded}{fell_back}",
                flush=True,
            )
            continue
        divergent += 1
        blame = rep.get("blame") or {}
        print(
            f"batch seq={rep['seq']} audit_id={rep['audit_id']} "
            f"[{args.against}] DIVERGED: field={blame.get('field')} "
            f"gang={blame.get('gang', blame.get('gang_index'))} "
            f"node={blame.get('node', blame.get('node_index'))} "
            f"recorded={blame.get('recorded')} "
            f"replayed={blame.get('replayed')}",
            flush=True,
        )
    summary = {
        "audit_dir": args.audit_dir,
        "against": args.against,
        "replayed": len(selected) - skipped_degraded,
        "identical": len(selected) - divergent - skipped_degraded,
        "divergent": divergent,
        "skipped_degraded": skipped_degraded,
        "unreconstructable": len(skipped),
        # v2 event_batch records reconstructed by re-folding the
        # recorded event stream (docs/observability.md "Audit format v2")
        "refolded": sum(
            1 for r in selected if r.get("record_kind") == "event_batch"
        ),
        "reports": [
            r for r in reports
            if not r.get("skipped") and not r["identical"]
        ],
    }
    print(json.dumps(summary, default=str))
    if args.json:
        # the bare summary: the reference wraps it in the benchmarks'
        # artifact envelope, which the port does not import
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=2, default=str)
    if divergent:
        return 1
    if summary["replayed"] == 0:
        # every selected record was a degraded conservative-fallback
        # batch: nothing was actually verified, and exit 0 would let a
        # capture step claim "bit-identical" on zero evidence
        print(
            "error: nothing replayed — every selected record is a "
            "degraded conservative-fallback batch",
            file=sys.stderr,
        )
        return 2
    return 0


def _debug_get(addr: str, path: str, params: Dict[str, str]) -> tuple:
    """GET a /debug endpoint on a live --metrics-port; returns
    (payload dict, http status)."""
    import urllib.error
    import urllib.parse
    import urllib.request

    host, _, port = addr.rpartition(":")
    if not port.isdigit():
        return {"error": f"--addr {addr!r} is not HOST:PORT"}, 0
    url = (
        f"http://{host or '127.0.0.1'}:{port}{path}"
        f"?{urllib.parse.urlencode(params)}"
    )
    try:
        with urllib.request.urlopen(url, timeout=120) as resp:
            return json.loads(resp.read().decode()), resp.status
    except urllib.error.HTTPError as e:
        try:
            return json.loads(e.read().decode()), e.code
        except ValueError:
            return {"error": f"HTTP {e.code}"}, e.code
    except (urllib.error.URLError, OSError, ValueError) as e:
        # connection refused / unreachable endpoint: a clean error (and
        # exit 2 in the callers), never a traceback — this is the
        # ready-to-paste command line sim's exit verdict prints
        return {"error": f"cannot reach {addr}: {e}"}, 0


def cmd_explain(args) -> int:
    """Why is this gang pending. Live mode queries /debug/explain on a
    running scheduler; offline mode re-derives the breakdown from a
    recorded audit batch (the replay machinery's inputs). Exit 0 on a
    structured answer, 2 when the gang/record cannot be found."""
    if args.addr:
        payload, status = _debug_get(
            args.addr, "/debug/explain", {"gang": args.gang}
        )
        print(json.dumps(payload, indent=2, default=str))
        return 0 if status == 200 and "error" not in payload else 2
    from ..core.explain import explain_arrays
    from ..utils.audit import AuditReader

    if not _require_device(args):
        return 2
    batches, _skipped = AuditReader(args.audit_dir).batches()
    if args.batch is not None:
        batches = [r for r in batches if r.get("seq") == args.batch]
    if not batches:
        print(
            f"error: no reconstructable batch record in {args.audit_dir}"
            + (f" with seq {args.batch}" if args.batch is not None else ""),
            file=sys.stderr,
        )
        return 2
    record = batches[-1]
    names = record.get("names") or {}
    groups = names.get("groups") or []
    if args.gang not in groups:
        print(
            f"error: gang {args.gang!r} not in record seq="
            f"{record.get('seq')} ({len(groups)} gangs)",
            file=sys.stderr,
        )
        return 2
    out = explain_arrays(
        record["batch_args"], groups.index(args.gang),
        node_names=names.get("nodes"),
        policy=record.get("policy_args"),
        device=args.device,
    )
    out["gang"] = args.gang
    out["source"] = {
        "audit_dir": args.audit_dir,
        "seq": record.get("seq"),
        "audit_id": record.get("audit_id"),
    }
    print(json.dumps(out, indent=2, default=str))
    return 0


def cmd_capacity(args) -> int:
    """The capacity observatory's CLI face. Live mode proxies
    /debug/capacity; offline mode replays a recorded audit ring through
    the SAME analytics kernel (ops.capacity.capacity_summary) and
    bit-compares each recomputed summary with the ring's recorded
    ``capacity_sample`` event — the replay discipline applied to the
    analytics series, so a post-mortem sees the identical numbers the
    live process saw. Exit 0 = answered (and, offline, every compared
    sample identical); 1 = divergence; 2 = nothing to answer."""
    if args.addr:
        params: Dict[str, str] = {}
        if args.points is not None:
            params["points"] = str(args.points)
        payload, status = _debug_get(args.addr, "/debug/capacity", params)
        print(json.dumps(payload, indent=2, default=str))
        if args.json:
            with open(args.json, "w") as f:
                json.dump(payload, f, indent=2, default=str)
        # a no-sampler answer is self-describing ({"sampler": null,
        # "hint": ...}) but it is NOT capacity data — honor the exit
        # contract: 2 = nothing to answer
        answered = (
            status == 200
            and "error" not in payload
            and payload.get("sampler", "present") is not None
        )
        return 0 if answered else 2

    from ..ops.capacity import capacity_summary
    from ..utils.audit import AuditReader

    if not _require_device(args):
        return 2
    recorded: Dict[str, dict] = {}
    batches: List[dict] = []
    for rec in AuditReader(args.audit_dir).records():
        if rec.get("kind") == "batch":
            batches.append(rec)
        elif (
            rec.get("kind") == "event"
            and rec.get("event") == "capacity_sample"
            and rec.get("audit_id")
        ):
            recorded[rec["audit_id"]] = rec.get("summary")
    if args.batch is not None:
        batches = [r for r in batches if r.get("seq") == args.batch]
    if not batches:
        print(
            f"error: no reconstructable batch record in {args.audit_dir}"
            + (f" with seq {args.batch}" if args.batch is not None else ""),
            file=sys.stderr,
        )
        return 2
    series, divergent, compared = [], 0, 0
    for rec in batches:
        names = rec.get("names") or {}
        policy = rec.get("policy_args")
        result = rec["result_arrays"]
        if rec.get("record_kind") == "event_batch":
            # v2 event records keep only the compact plan vectors; the
            # assignment arrays the analytics kernel reads are recovered
            # by re-executing the re-folded inputs, gated on the recorded
            # plan digest (the same identity contract `replay` enforces)
            from ..core.oracle_scorer import replay_batch
            from ..utils.audit import plan_digest

            host, _ = replay_batch(
                rec["batch_args"], rec["progress_args"], against="steady",
                device=args.device, policy=policy,
            )
            if plan_digest(host) != rec.get("plan_digest"):
                divergent += 1
                series.append({
                    "seq": rec.get("seq"),
                    "audit_id": rec.get("audit_id"),
                    "identical": False,
                    "error": "re-executed plan diverges from the recorded "
                             "digest — assignment arrays unrecoverable",
                })
                continue
            result = dict(result)
            for k in ("assignment_nodes", "assignment_counts"):
                result.setdefault(k, host[k])
        summary = capacity_summary(
            rec["batch_args"], result,
            group_names=names.get("groups") or [],
            scheduled=rec["progress_args"][1],
            matched=rec["progress_args"][2],
            policy_prio=policy[0][0] if policy else None,
            device=args.device,
        )
        # normalize through the same JSON round-trip the recorded event
        # took, so the comparison is representation-for-representation
        summary = json.loads(json.dumps(summary, sort_keys=True))
        entry = {
            "seq": rec.get("seq"),
            "audit_id": rec.get("audit_id"),
            "summary": summary,
        }
        live = recorded.get(rec.get("audit_id"))
        if live is not None:
            compared += 1
            entry["identical"] = live == summary
            if not entry["identical"]:
                divergent += 1
                entry["recorded_summary"] = live
                print(
                    f"batch seq={entry['seq']} audit_id="
                    f"{entry['audit_id']} capacity DIVERGED from the "
                    "recorded live sample",
                    flush=True,
                )
        series.append(entry)
    out = {
        "audit_dir": args.audit_dir,
        "replayed": len(series),
        "compared": compared,
        "divergent": divergent,
        "series": series,
    }
    print(json.dumps(out, indent=2, default=str))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2, default=str)
    return 1 if divergent else 0


def cmd_timeline(args) -> int:
    """A gang's lifecycle timeline. Live mode proxies /debug/gangs on a
    running scheduler; offline mode re-folds the audit ring's
    ``gang_lifecycle`` event records through the ledger's own coalesce
    rule (GangLifecycleLedger.fold) — byte-identical to what the live
    process served (the slo_gate contract). Exit 0 on a structured
    answer, 2 when nothing matches."""
    if args.addr:
        params: Dict[str, str] = {}
        if args.gang:
            params["gang"] = args.gang
        if args.tenant:
            params["tenant"] = args.tenant
        if args.limit is not None:
            params["limit"] = str(args.limit)
        payload, status = _debug_get(args.addr, "/debug/gangs", params)
        print(json.dumps(payload, indent=2, default=str))
        if args.json:
            with open(args.json, "w") as f:
                json.dump(payload, f, indent=2, default=str)
        answered = (
            status == 200
            and "error" not in payload
            and payload.get("count", 0) > 0
        )
        return 0 if answered else 2

    # offline: pure record re-fold — no backend, no device, no drain
    from ..utils.audit import AuditReader
    from ..utils.lifecycle import GangLifecycleLedger

    records = [
        rec
        for rec in AuditReader(args.audit_dir).records()
        if rec.get("kind") == "event"
        and rec.get("event") == "gang_lifecycle"
    ]
    folded = GangLifecycleLedger.fold(records)
    items = [
        (g, rec)
        for g, rec in folded.items()
        if (args.gang is None or g == args.gang)
        and (args.tenant is None or rec.get("tenant") == args.tenant)
    ]
    if args.limit is not None and args.limit >= 0:
        items = items[-args.limit:] if args.limit else []
    gangs = {g: GangLifecycleLedger.timeline_view(rec) for g, rec in items}
    out = {
        "audit_dir": args.audit_dir,
        "records": len(records),
        "gangs": gangs,
        "count": len(gangs),
    }
    print(json.dumps(out, indent=2, default=str))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2, default=str)
    if not gangs:
        print(
            f"error: no gang_lifecycle records in {args.audit_dir}"
            + (f" match gang={args.gang!r}" if args.gang else "")
            + (f" tenant={args.tenant!r}" if args.tenant else ""),
            file=sys.stderr,
        )
        return 2
    return 0


def cmd_whatif(args) -> int:
    """Score one counterfactual against live cluster state (the
    /debug/whatif endpoint's CLI face). Exit 0 on a diff, 2 on error."""
    # `is not None`, not truthiness: argparse guarantees exactly one of
    # the group was provided, and `--add-nodes 0` must reach the server's
    # own range validation (a 400) instead of silently sending nothing
    params: Dict[str, str] = {"rung": args.rung}
    if args.drain is not None:
        params["drain"] = args.drain
    elif args.cordon is not None:
        params["cordon"] = args.cordon
    elif args.add_nodes is not None:
        params.update(
            add_nodes=str(args.add_nodes), node_cpu=args.node_cpu,
            node_memory=args.node_memory, node_pods=args.node_pods,
        )
    elif args.bump_gang is not None:
        if args.tier is None:
            print("error: --bump-gang requires --tier", file=sys.stderr)
            return 2
        params.update(bump_gang=args.bump_gang, tier=str(args.tier))
    elif args.remove_gang is not None:
        params["remove_gang"] = args.remove_gang
    payload, status = _debug_get(args.addr, "/debug/whatif", params)
    print(json.dumps(payload, indent=2, default=str))
    return 0 if status == 200 and "error" not in payload else 2


def cmd_serve(args) -> int:
    from ..service.server import OracleServer

    # the reference bootstraps a multi-host slice here when BST_COORDINATOR
    # is set (parallel.distributed); the port has no multi-process
    # bootstrap yet, and a coordinator it ignored would split the fleet
    if os.environ.get("BST_COORDINATOR", "").strip():
        return _refused(
            "BST_COORDINATOR is set, but the port's sidecar has no "
            "multi-process bootstrap yet: unset it to serve one process"
        )
    if not _require_device(args):
        return 2

    if args.warmup:
        print(f"warmup batch done in {warm_oracle(device=args.device):.1f}s",
              flush=True)
    from ..utils.runtime_tuning import freeze_startup

    freeze_startup()

    # server-side local span ring: traced requests' spans land in this
    # process's /debug/trace too (they ALWAYS go back to the client in
    # TRACE_INFO frames, --trace or not)
    _maybe_configure_trace(args)
    _maybe_serve_metrics(args)
    _start_profiler(args)

    server = OracleServer(
        host=args.host, port=args.port, device=args.device,
        audit_log=_maybe_audit_log(args),
        # flag is sugar over BST_COALESCE; None lets the env decide
        coalesce=True if args.coalesce else None,
        compile_warmer=args.compile_warmer,
    )
    # sidecar-side lifecycle export: nothing flows unless a scheduler
    # runs in-process, but the flag contract is uniform across sim/serve
    _maybe_lifecycle(args)
    host, port = server.address
    print(f"oracle sidecar listening on {host}:{port}", flush=True)

    # SIGTERM = graceful drain (docs/resilience.md "High availability"):
    # stop admitting, finish the in-flight window, flush warmer ->
    # executor -> telemetry -> audit in producer-before-join order, keep
    # answering DRAINING + failover hint meanwhile, THEN exit. Runs on a
    # helper thread so the signal handler returns immediately (drain can
    # legitimately take BST_DRAIN_TIMEOUT_S); shutdown() unblocks
    # serve_forever once the flush is done.
    import signal

    def _drain_and_exit() -> None:
        report = server.drain()
        print(f"drain complete: {json.dumps(report, sort_keys=True)}",
              flush=True)
        server.shutdown()

    def _on_sigterm(signum, frame):  # noqa: ARG001 — signal signature
        print("SIGTERM: draining oracle sidecar", flush=True)
        threading.Thread(
            target=_drain_and_exit, name="drain-sigterm", daemon=True
        ).start()

    try:
        signal.signal(signal.SIGTERM, _on_sigterm)
    except (ValueError, OSError):
        pass  # non-main thread / unsupported platform: abrupt kill remains

    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        server.server_close()
        from ..utils import profiler as profiler_mod

        profiler_mod.shutdown()
    return 0


def _cmd_sim_multi_client(args) -> int:
    """sim --multi-client K: the coalescer acceptance harness as a CLI —
    K concurrent scheduler clients' deterministic oracle streams through
    one sidecar (docs/multitenancy.md "Multi-client sim")."""
    from ..sim.harness import drive_multi_client

    nodes = args.nodes or 256
    gangs = max(args.groups, 1)
    server = None
    addr = args.oracle_addr
    if not addr:
        from ..service.server import serve_background

        # in-process coalescing sidecar: --oracle-addr points the driver
        # at an external `serve --coalesce` instead
        server = serve_background(coalesce=True, device=args.device)
        host, port = server.address
        addr = f"{host}:{port}"
    print(
        f"multi-client sim: {args.multi_client} clients x "
        f"{args.mc_batches} batches, per-tenant [{nodes} nodes, "
        f"{gangs} gangs] via {addr}",
        flush=True,
    )
    try:
        result = drive_multi_client(
            addr,
            clients=args.multi_client,
            batches=args.mc_batches,
            nodes=nodes,
            gangs=gangs,
            deadline_ms=args.oracle_deadline_ms,
        )
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
    wall = result.pop("_wall_s")
    total = sum(len(v["digests"]) for v in result.values())
    busy = sum(v["busy"] for v in result.values())
    print(
        f"aggregate: {total} batches in {wall:.2f}s = "
        f"{total / max(wall, 1e-9):.1f} batches/s"
        + (f", {busy} busy-dropped" if busy else "")
    )
    from ..sim.harness import wait_p95

    for tenant in sorted(result):
        waits = sorted(result[tenant]["waits"])
        if not waits:
            print(f"  {tenant}: no completed batches")
            continue
        p95 = wait_p95(waits)
        print(
            f"  {tenant}: {len(waits)} batches, wait p50 "
            f"{waits[len(waits) // 2] * 1000:.1f}ms p95 {p95 * 1000:.1f}ms"
        )
    return 0


def _terminal(phase) -> bool:
    from ..api import PodGroupPhase

    return phase in (
        PodGroupPhase.RUNNING,
        PodGroupPhase.FINISHED,
        PodGroupPhase.FAILED,
    )


def cmd_sim(args) -> int:
    from ..api.manifest import load_manifest_file
    from ..api.types import Node, Pod, PodGroup
    from ..sim import SimCluster, make_member_pods, make_sim_group, make_sim_node
    from ..sim.scenarios import race_scenario

    cfg = load_scheduler_config(args.config)
    if args.scorer:
        cfg.plugin_config.scorer = args.scorer
    if args.device_state == "off":
        return _refused(
            "--device-state off: the port always keeps the cluster state "
            "on the device (there is no host-upload rung to fall back to)"
        )
    if not _require_device(args):
        return 2

    tracing = _maybe_configure_trace(args)
    _maybe_serve_metrics(args)
    _start_profiler(args)

    if args.multi_client > 0:
        return _cmd_sim_multi_client(args)

    scorer = cfg.plugin_config.scorer
    oracle_client = None
    remote_scorer = None
    want_bg_refresh = (
        args.oracle_background_refresh
        or cfg.plugin_config.oracle_background_refresh
    )
    want_dispatch_ahead = (
        args.dispatch_ahead or cfg.plugin_config.oracle_dispatch_ahead
    )
    want_warmer = (
        args.compile_warmer or cfg.plugin_config.oracle_compile_warmer
    )
    if args.oracle_addr:
        from ..service.client import RemoteScorer, ResilientOracleClient

        # resilient transport: reconnect + retry + breaker + deadline —
        # connections are lazy, so a sidecar that is still coming up (or
        # briefly gone) no longer kills the whole run at construction.
        # A comma list configures a warm-standby pool (the client parses
        # the spec itself — parse_oracle_addresses).
        # Dispatch-ahead and background refresh widen the in-flight
        # window to 2 connection slots, so the off-cycle batch never
        # contends with row reads on the served batch.
        oracle_client = ResilientOracleClient(
            args.oracle_addr,
            deadline_ms=args.oracle_deadline_ms, name="fg",
            window=2 if (want_dispatch_ahead or want_bg_refresh) else 1,
        )
        scorer = RemoteScorer(oracle_client, fallback=args.oracle_fallback)
        remote_scorer = scorer
        if want_warmer:
            print(
                "note: --compile-warmer warms the LOCAL batch path; with "
                "--oracle-addr batches run on the sidecar — start "
                "`serve --compile-warmer` there instead",
                file=sys.stderr,
            )

    policy_cfg = None
    if args.policy:
        # CLI form of BST_POLICY: the env var keeps working (PolicyConfig
        # reads it when no explicit config is passed); the flag wins
        import os as _os

        from ..policy.engine import PolicyConfig

        _os.environ["BST_POLICY"] = args.policy
        policy_cfg = PolicyConfig.from_env()
        print(
            f"policy engine: terms={list(policy_cfg.terms)} "
            f"fingerprint={policy_cfg.fingerprint()['fingerprint']}",
            file=sys.stderr,
        )

    audit_log = _maybe_audit_log(args)
    cluster = SimCluster(
        scorer=scorer,
        max_schedule_minutes=cfg.plugin_config.max_schedule_minutes,
        enabled_points=cfg.enabled_points,
        min_batch_interval=cfg.plugin_config.min_batch_interval_seconds,
        oracle_background_refresh=want_bg_refresh,
        oracle_dispatch_ahead=want_dispatch_ahead,
        oracle_compile_warmer=want_warmer and oracle_client is None,
        audit_log=audit_log,
        identity_audit_every=args.identity_audit_every,
        policy=policy_cfg,
        device=args.device,
    )
    # after SimCluster: the operation's construction reset the ledger
    _maybe_lifecycle(args, audit_log)

    nodes: List[Node] = []
    groups: List[PodGroup] = []
    pods: List[Pod] = []

    for path in args.filename:
        for obj in load_manifest_file(path):
            if isinstance(obj, Node):
                nodes.append(obj)
            elif isinstance(obj, PodGroup):
                groups.append(obj)
            elif isinstance(obj, Pod):
                pods.append(obj)

    if args.scenario == "race":
        rnodes, rgroups, rpods = race_scenario()
        nodes += rnodes
        groups += rgroups
        for plist in rpods.values():
            pods += plist
    elif args.scenario == "synthetic":
        for g in range(args.groups):
            name = f"group-{g:03d}"
            groups.append(make_sim_group(name, args.members))
            pods += make_member_pods(name, args.members, {"cpu": "1"})
    elif args.scenario == "spot-vs-guaranteed":
        from ..sim.scenarios import spot_vs_guaranteed_scenario

        snodes, sgroups, spods = spot_vs_guaranteed_scenario()
        nodes += snodes
        groups += sgroups
        for plist in spods.values():
            pods += plist
        # the operation reads BST_POLICY itself when no explicit config is
        # passed — check the EFFECTIVE config before warning
        from ..policy.engine import PolicyConfig as _PC

        effective = policy_cfg if policy_cfg is not None else _PC.from_env()
        if not effective.preemption:
            print(
                "note: spot-vs-guaranteed without the preempt term "
                "(--policy preempt / BST_POLICY) — the guaranteed gang "
                "will queue-jump but cannot evict spot capacity",
                file=sys.stderr,
            )
        if args.settle <= 3.0:
            # permit-parked quorums and deny-cache retries produce no
            # observable change for up to a 20s TTL window; the default
            # settle would conclude "stuck" mid-transaction
            args.settle = 30.0
            print(
                "note: --settle raised to 30s for this scenario (permit "
                "parks + deny-TTL retries look idle to a shorter window)",
                file=sys.stderr,
            )

    for i in range(args.nodes):
        nodes.append(
            make_sim_node(
                f"sim-node-{i:04d}",
                {"cpu": args.node_cpu, "memory": args.node_memory, "pods": "110"},
            )
        )

    if not nodes:
        print("error: no nodes (use -f with Node manifests or --nodes N)", file=sys.stderr)
        return 2
    if not groups:
        print("error: no PodGroups (use -f or --scenario)", file=sys.stderr)
        return 2

    if scorer == "oracle" or oracle_client is not None:
        # Run one batch of this cluster's bucket before admitting traffic:
        # building or loading the kernel libraries otherwise lands inside
        # the first scheduling callback, and on a short --settle the run
        # can conclude "nothing is moving" while nvcc runs. For
        # --oracle-addr the warm batch goes over the wire so the
        # *sidecar* (the one real traffic hits) is what warms.
        elapsed = warm_oracle(
            nodes=nodes, groups=groups, pods=pods,
            remote_scorer=scorer if oracle_client is not None else None,
            device=args.device,
        )
        print(f"oracle warmup batch: {elapsed:.1f}s", flush=True)
    from ..utils.runtime_tuning import freeze_startup

    freeze_startup()

    cluster.add_nodes(nodes)
    for pg in groups:
        cluster.create_group(pg)
    cluster.start()
    t_flood = time.monotonic()
    try:
        if args.scenario == "spot-vs-guaranteed":
            # staged arrival: the scenario demos PREEMPTION, which needs
            # the spot tier bound BEFORE the guaranteed tier arrives
            # (simultaneous arrival just demos queue priority). Hold the
            # guaranteed pods back until spot stops making progress.
            guar = [
                p for p in pods
                if p.metadata.labels.get(POD_GROUP_LABEL, "").startswith(
                    "guaranteed"
                )
            ]
            spot = [p for p in pods if p not in guar]
            cluster.create_pods(spot)
            spot_deadline = time.monotonic() + min(args.timeout / 2, 90)
            last_bound, stable = -1, time.monotonic()
            while time.monotonic() < spot_deadline:
                bound = sum(
                    1
                    for p in spot
                    if (cluster.clientset.pods(p.metadata.namespace)
                        .get(p.metadata.name).spec.node_name)
                )
                if bound >= len(spot):
                    last_bound = bound
                    break
                if bound != last_bound:
                    last_bound, stable = bound, time.monotonic()
                elif time.monotonic() - stable > 25.0:
                    # a full deny-cache TTL with no progress: the spot
                    # tier is as bound as it gets
                    break
                time.sleep(0.2)
            print(
                f"spot tier settled ({last_bound} bound); releasing "
                f"guaranteed tier",
                flush=True,
            )
            cluster.create_pods(guar)
        else:
            cluster.create_pods(pods)

        deadline = time.monotonic() + args.timeout
        names = [(pg.metadata.namespace, pg.metadata.name) for pg in groups]
        last_state, stable_since = None, time.monotonic()
        while time.monotonic() < deadline:
            # every gang's bound members in one pass over the pods: a
            # list per gang (the reference's poll) holds the interpreter
            # for ~0.2 s a poll at 10,000 pods, beside the scheduler
            bound = cluster.bound_member_counts()
            state = tuple(
                (cluster.group_phase(n, ns), bound.get((ns, n), 0))
                for ns, n in names
            )
            if all(_terminal(p) for p, _ in state):
                break
            now = time.monotonic()
            if state != last_state:
                last_state, stable_since = state, now
            elif now - stable_since >= args.settle:
                # nothing has moved for a while: denied gangs never reach a
                # terminal phase, so this is the settled outcome
                break
            time.sleep(0.2)
        wall = time.monotonic() - t_flood

        print(f"{'GROUP':<28} {'PHASE':<14} {'MINMEMBER':>9} {'BOUND':>6} MEMBERS")
        for ns, name in names:
            pg = cluster.group(name, ns)
            members = cluster.member_phase_counts(name, ns)
            bound = sum(
                1 for p in cluster.member_pods(name, ns) if p.spec.node_name
            )
            print(
                f"{ns + '/' + name:<28} {pg.status.phase.value or 'Pending':<14} "
                f"{pg.spec.min_member:>9} {bound:>6} {members}"
            )
        # the run's wall clock, from the first pod to the outcome the loop
        # above observed (its 0.2 s polls included): a line the reference
        # does not print
        bound_total = sum(
            1 for ns, name in names
            for p in cluster.member_pods(name, ns) if p.spec.node_name
        )
        print(
            f"sim wall: {wall:.3f}s from the first pod to the outcome, "
            f"{bound_total} of {len(pods)} pods bound "
            f"({bound_total / max(wall, 1e-9):.1f} pods/s)"
        )
        stats = cluster.scheduler.stats
        print(f"scheduler stats: {dict(stats)}")
        oracle = getattr(cluster.runtime.operation, "oracle", None)
        if oracle is not None and getattr(oracle, "batches_run", 0):
            print(f"oracle stats: {oracle.stats()}")
        if audit_log is not None:
            audit_log.flush()
            print(f"audit stats: {audit_log.stats()}")
            print(
                "replay with: python -m batch_scheduler_tpu_torch replay "
                f"{args.audit_dir}"
            )
        # the SLO health verdict on exit: "degraded and why" without an
        # operator asking (live form: /debug/health on --metrics-port)
        health = cluster.health()
        bad = {
            name: sig.get("reason") or f"p95 {sig.get('p95_s')}s"
            for name, sig in health["signals"].items()
            if sig["verdict"] != "ok"
        }
        print(
            f"slo health: {health['verdict']}"
            + (f" ({bad})" if bad else "")
        )
        # capacity observatory verdict beside the health line: how full,
        # how fragmented, who is consuming it (live form: /debug/capacity)
        from ..ops.capacity import active_sampler, format_capacity_verdict

        sampler = active_sampler()
        cap_last = sampler.last() if sampler is not None else None
        if cap_last is not None:
            print(format_capacity_verdict(cap_last, sampler.lane_names()))
            burn = health["signals"].get("burn:capacity") or {}
            if burn.get("verdict") not in (None, "ok"):
                print(
                    f"capacity burn: {burn['verdict']} ({burn['reason']})"
                )
        # pending-gang aging in the exit verdict: who is starving and how
        # long (the live form is the /debug/health "pending" signal)
        pend = health["signals"].get("pending") or {}
        if pend.get("pending_gangs"):
            print(
                f"pending gangs: {pend['pending_gangs']} "
                f"(oldest {pend.get('oldest_gang')} "
                f"{pend.get('oldest_age_s', 0):.1f}s, max deny streak "
                f"{pend.get('max_deny_streak', 0)}) — explain with: "
                f"python -m batch_scheduler_tpu_torch explain "
                f"{pend.get('oldest_gang')} --addr <metrics-port>"
            )
        # per-tenant placement verdict: p99 time-to-placement from the
        # gang lifecycle ledger (live forms: /debug/gangs timelines and
        # the /debug/health burn:ttp signal)
        from ..utils.lifecycle import DEFAULT_LEDGER

        life = DEFAULT_LEDGER.report()
        if life.get("tenants"):
            parts = ", ".join(
                f"{t} p99 {d['p99_ttp_s']:.2f}s/{d['count']}"
                for t, d in sorted(life["tenants"].items())
            )
            print(f"placement ttp (tenant p99/gangs): {parts}")
            ttp_burn = health["signals"].get("burn:ttp") or {}
            if ttp_burn.get("verdict") not in (None, "ok"):
                print(
                    f"ttp burn: {ttp_burn['verdict']} "
                    f"({ttp_burn['reason']})"
                )
        if tracing:
            from ..utils.trace import DEFAULT_FLIGHT_RECORDER

            _export_trace(args)
            verdicts: Dict[str, int] = {}
            for recs in DEFAULT_FLIGHT_RECORDER.snapshot().values():
                for r in recs:
                    verdicts[r["verdict"]] = verdicts.get(r["verdict"], 0) + 1
            print(f"flight recorder decisions: {verdicts}")
    finally:
        cluster.stop()
        if audit_log is not None:
            audit_log.stop()
        if remote_scorer is not None:
            remote_scorer.close()  # closes both connections
        from ..utils import profiler as profiler_mod

        profiler_mod.shutdown()
    return 0


COMMANDS = {
    "version": cmd_version,
    "check-config": cmd_check_config,
    "serve": cmd_serve,
    "sim": cmd_sim,
    "replay": cmd_replay,
    "explain": cmd_explain,
    "whatif": cmd_whatif,
    "capacity": cmd_capacity,
    "timeline": cmd_timeline,
}


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    # klog-style: --v 0 warnings only, 1-2 info, >=3 debug
    import logging

    level = (
        logging.WARNING if args.v <= 0 else logging.INFO if args.v <= 2 else logging.DEBUG
    )
    logging.basicConfig(level=level)
    # Runtime tuning (the knob the Go reference reaches via GOMAXPROCS):
    # the scheduler is one compute-bound cycle thread beside ~25 mostly-
    # idle service threads; CPython's default 5ms GIL switch interval
    # costs measurable handoff time under a 10k-pod drain (ladder config
    # 6: cycle_total 0.77s -> ~0.4-0.6s at 20ms). BST_GIL_SWITCH_INTERVAL
    # overrides; 0 keeps the interpreter default.
    try:
        interval = float(os.environ.get("BST_GIL_SWITCH_INTERVAL", "0.02"))
    except ValueError:
        logging.warning(
            "ignoring malformed BST_GIL_SWITCH_INTERVAL=%r; using 0.02",
            os.environ.get("BST_GIL_SWITCH_INTERVAL"),
        )
        interval = 0.02
    if interval > 0:
        sys.setswitchinterval(interval)
    # GC thresholds are runtime tuning of the same kind (see
    # utils.runtime_tuning); freeze_startup runs after each command's
    # warmup so the loaded kernel libraries land in the frozen set too
    from ..utils.runtime_tuning import apply_gc_tuning

    apply_gc_tuning()
    return COMMANDS[args.command](args)
