// assign_scan.cu — the serial greedy gang-placement scan, hand-written for
// Hopper (sm_90a) as one thread-block cluster.
//
// Replaces: batch_scheduler_tpu/ops/pallas_assign.py `_kernel` (:63, reached
// by `assign_gangs_pallas`, with `_cap_t` and ops/oracle.py
// `_select_best_fit`). It computes exactly what that kernel and the
// reference `assign_gangs` compute. For each gang in scan order:
//   cap[n]  = mask[n] * min over lanes with req > 0 of
//             floor(clamp(left[n], 0, 2^30) / clamp(req, 1, 2^30))
//   capc[n] = min(cap[n], need)
//   tightest-first take by a 128-bin histogram threshold over
//   key[n] = min(cap[n], 127): bins below the threshold give all of capc,
//   the threshold bin gives the rest in node-index order, bins above give
//   nothing; the whole take is zeroed unless sum(capc) >= need;
//   left[n] -= take[n] * req.
//
// What bounds it on an H100: the G gangs are G dependent steps (each gang
// sees the leftover the previous gangs left). The bytes the function must
// move (the [G,N] take rows, which the wrapper zeroes before the launch,
// plus the [N,R] leftover in and out) take about 10 us at 3.35 TB/s at the
// 1024 x 8192 x 5 north-star shape, and its integer operations less; the
// chain of G steps is what bounds it. A step is latency, not work: the
// per-node arithmetic of 1/C of the nodes, two block barriers, and one
// exchange of histograms between the C blocks, whose one-way latency
// between SMs is the largest single part.
//
// Design:
// - The node axis is split over a cluster of C blocks (C = 16, 8, or 1 for
//   small buckets; the wrapper's kernel_plan picks C, the threads and the
//   nodes per thread). Block b owns nodes [b*B, (b+1)*B), B = ceil(N/C);
//   each thread owns `per` consecutive nodes of that range.
// - Per gang step: every block builds its 128-bin histogram of capc by key
//   (and one per warp); after a block barrier its warp 0 pushes the
//   histogram into an inbox slot of every block of the cluster with
//   st.async, whose bytes complete the receiving block's mbarrier
//   transaction count. Warp 0 of every block waits on its own mbarrier for
//   all C histograms, then finds the threshold bin, the remainder, the
//   feasibility, and its block's prefix in the threshold bin (the sum of
//   the lower-ranked blocks' entries: a bin's entry is the sum of capc over
//   it). The arithmetic is integer, so every block gets identical values.
//   A second block barrier publishes them. A warp's prefix is the sum of
//   the lower warps' per-warp histogram entries at the threshold, a lane's
//   is a shuffle scan: no block scan and no second exchange. Pushing
//   instead of reading remote shared memory after a cluster barrier saves
//   the barrier's cluster-wide release and the reads' round trip.
// - Inboxes, their mbarriers and the per-warp histograms are
//   double-buffered by step parity. A block pushes into a parity-p inbox
//   (step s+2) only after it has received every block's step s+1
//   histogram, which each block pushes after reading its step-s inbox; so
//   no slot is overwritten before it is read, and no transaction reaches
//   an mbarrier before the phase it belongs to. Cluster barriers run only
//   before the loop (the mbarriers exist) and after it (no block exits
//   with pushes in flight).
// - Exact division without a divide: every divisor is a gang's request on
//   one lane. The wrapper computes, per [G,R] entry, l = ceil(log2 d) and
//   m = floor(2^(31+l) / d) + 1 (< 2^32; ops/assign_scan.py
//   `division_magic`), and for numerators and divisors in [0, 2^30] x
//   [1, 2^30], floor(n / d) = umulhi(n, m) >> (l - 1), and n for d = 1.
// - Prefetch: the scan order is read two steps ahead, and the next gang's
//   need, request/magic/shift row and (per-group mask) this thread's mask
//   bytes one step ahead, into registers, while warp 0 waits; the last 3R
//   threads stage the row in shared memory before the second barrier. A
//   broadcast [1,N] mask is read once.
// - The leftover lives in shared memory transposed to [R][per][threads]
//   (slot (k, j) of thread t at k*per*T + j*T + t: no bank conflicts) when
//   it fits the block's budget, else in a wrapper-allocated global scratch
//   slab per block (coalesced the same way; it stays in the 50 MB L2).
//   Capacities stay in registers between the phases of a step.
// - Buckets past 2^20 nodes (more than 64 nodes a thread even at 16
//   blocks): the thread's nodes run as slabs of 64 through the same device
//   functions, from global scratch, with each slab's capacities recomputed
//   in each pass (histogram, bin sum, take) instead of kept in registers.
//   One instantiation serves any number of slabs.
// - Each take row is written straight to alloc[order[s]] (only its nonzero
//   entries: the wrapper hands over an alloc zeroed by torch.zeros, whose
//   memset the wrapper's time includes).
// - The step's device functions (capacity pass, histogram add, push,
//   threshold select, bin prefix, take) are cluster_scan.cuh's, which the
//   wavefront scan (assign_wave.cu) runs too.
// - Every step runs the same barriers and exchange in every block: an
//   out-of-range order entry is a step with need 0 that writes nothing,
//   and the infeasible case only skips the take, which has no barrier.
// - Domain: the reference's batch boundary (LANE_MAX, the gang bound of
//   pad_oracle_batch) keeps every need-clipped sum inside int32. The
//   leftover update wraps in int32 like the reference. Integer atomics
//   only, so the result is deterministic.
//
// The policy variant (this source built with -DBST_POLICY_SCAN, library
// `assign_policy`; entry point bst_assign_policy) replaces the reference's
// policy rung, batch_scheduler_tpu/ops/oracle.py `assign_gangs_policy`
// (:438, a lax.scan, not a Pallas kernel): the same scan with the
// selection key of gang g on node n
//   key = cap > 0 ? clip(min(cap, 127) + pen, 1, 127) : 0,
//   pen = w_aff * (aff[g] > 0 and no label hash of n equals aff[g])
//       + w_spread * min(gang_dom[g][clip(node_dom[n], 0, 15)], spread_cap)
// and cap also 0 where anti-affinity is on, anti[g] > 0 and a label hash
// of n equals anti[g]. The wrapper folds the enabled terms into the
// weights (a disabled penalty term has weight 0). What bounds it is the
// serial kernel's chain of G steps; a step adds, per own node, up to eight
// compares of its 4 label hashes and one read of the gang's 16 domain
// counts, and the bytes grow by the node columns (20 bytes a node) and
// the gang columns (72 bytes a gang). Design: the gang's aff, anti and
// domain counts are staged into shared memory with the request row, by 18
// more of the last threads, one step ahead (20 ints a parity); the node
// columns are read once into shared memory beside the leftover when it
// lives there, else read from the inputs (L2); anti-affinity clears the
// node's capacity before the division pass, as a failed fit bit would;
// the penalties stay in registers (one a node) and reach the histogram
// add, the bin sum and the take through cluster_scan.cuh's PenaltyKey.
// Ties inside a bin stay in node order. With every weight 0 and
// anti-affinity off (or all-zero columns) every key is min(cap, 127) and
// the variant equals the base kernel. The base kernel is this template
// with kPolicy = false and TightKey: its code is unchanged by the variant.
//
// Launch rules: the kernel runs on the caller's stream, allocates nothing,
// and the C entry point returns the launch's CUDA error code.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "cluster_scan.cuh"

namespace cg = cooperative_groups;

namespace {

#ifdef BST_POLICY_SCAN
constexpr bool kPolicyBuild = true;
#else
constexpr bool kPolicyBuild = false;
#endif

// the policy variant's shared-memory rows and threads: a gang's policy row
// (aff, anti, its kDomains spread-domain counts; padded to kPolicyRow ints)
// staged by kPolicyStagers threads, and a node's 4 label hashes and spread
// domain beside a shared leftover (kNodeInts ints)
constexpr int kDomains = 16;        // policy.terms DOMAIN_BUCKETS
constexpr int kPolicyRow = 20;
constexpr int kPolicyStagers = 2 + kDomains;
constexpr int kNodeInts = 4 + 1;    // policy.terms HASH_LANES, the domain

struct ScanArgs {
  const int* left0;
  const int* group_req;
  const int* remaining;
  const unsigned char* mask;
  const int* order;
  const int* magic;
  const int* shift;
  int* alloc;
  unsigned char* placed;
  int* left_after;
  int* scratch;
  int n, g, r, mask_per_group, block_nodes, per;
  // the policy variant's columns and weights (the base kernel reads none):
  // aff[G], anti[G], gang_dom[G][16], node_hash[N] (4 hashes a node),
  // node_dom[N]
  const int* aff;
  const int* anti;
  const int* gang_dom;
  const int4* node_hash;
  const int* node_dom;
  int anti_on, w_aff, w_spread, spread_cap;
};

// kSlabs (with kPer = 64, leftover in global scratch): a thread's `per`
// nodes, any number of them, run as slabs of at most kPer in runtime loops
// (not unrolled: see `opaque`); each pass of a step recomputes a slab's
// capacities (and, with kPolicy, penalties) from the leftover, its mask
// bytes and the node columns (none changes inside the step before the
// take), so nothing per node is kept across the phases.
// kPolicy: the policy variant (the header's second part).
template <int kPer, bool kShared, bool kSlabs = false, bool kPolicy = false>
__global__ void __launch_bounds__(kMaxThreads, 1)
assign_scan_kernel(const ScanArgs a) {
  static_assert(!kSlabs || (kPer == 64 && !kShared), "slabs run from global scratch");
  using Bits = std::conditional_t<(kPer > 32), unsigned long long, unsigned>;
  using Key = std::conditional_t<kPolicy, PenaltyKey<kPer>, TightKey>;
  extern __shared__ int dyn[];
  __shared__ __align__(16) int bhist[kBins];
  // inbox[p][c]: cluster block c's histogram of the step of parity p
  __shared__ __align__(16) int inbox[2][kMaxCluster][kBins];
  __shared__ __align__(8) unsigned long long inbox_full[2];
  __shared__ int sh_thresh, sh_rem, sh_pre, sh_feasible;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int blocks = (int)cluster.num_blocks();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int threads = blockDim.x;
  const int n = a.n, g = a.g, r = a.r, per = a.per;
  const int b0 = min(rank * a.block_nodes, n);
  const int b1 = min(b0 + a.block_nodes, n);
  const int n0 = min(b0 + tid * per, b1);
  const int cnt = min(n0 + per, b1) - n0;
  const int lane_slots = per * threads;
  const int warps = threads / 32;

  // dynamic shared memory: rows[(p*r + k)*4 ...], lane k's (request, magic,
  // shift, -) of the gang of parity p; with kPolicy prow[p*kPolicyRow ...],
  // the gang's (aff, anti, domain counts); whist[(p*warps + w)*128 ...],
  // warp w's histogram of the step of parity p; then the leftover when
  // kShared, and with kPolicy the node columns after it
  int* rows = dyn;
  int* prow = dyn + 8 * r;
  int* whist = prow + (kPolicy ? 2 * kPolicyRow : 0);
  // this thread's leftover: lane k of node n0 + j at left[k*lane_slots + j*threads]
  int* left = (kShared ? whist + 2 * warps * kBins
                       : a.scratch + (size_t)rank * r * lane_slots) + tid;

  for (int j = 0; j < cnt; ++j)
    for (int k = 0; k < r; ++k)
      left[k * lane_slots + j * threads] = a.left0[(size_t)(n0 + j) * r + k];

  // kPolicy: this thread's node j's label hashes at nhash[j * nstride] and
  // spread domain at ndom[j * nstride] (shared memory beside the leftover,
  // else the inputs)
  const int4* nhash = nullptr;
  const int* ndom = nullptr;
  int nstride = 1;
  if constexpr (kPolicy) {
    if constexpr (kShared) {
      int4* sh_hash = reinterpret_cast<int4*>(whist + 2 * warps * kBins + r * lane_slots) + tid;
      int* sh_dom = reinterpret_cast<int*>(sh_hash - tid + lane_slots) + tid;
      for (int j = 0; j < cnt; ++j) {
        sh_hash[j * threads] = __ldg(a.node_hash + n0 + j);
        sh_dom[j * threads] = __ldg(a.node_dom + n0 + j);
      }
      nhash = sh_hash;
      ndom = sh_dom;
      nstride = threads;
    } else {
      nhash = a.node_hash + n0;
      ndom = a.node_dom + n0;
    }
  }
  // kPolicy: own node j under the gang's policy row pr: clears cap_j when
  // anti-affinity excludes the node, and returns its penalty
  auto node_policy = [&](int j, const int* pr, int& cap_j) {
    int4 h;
    int d;
    if constexpr (kShared) {
      h = nhash[j * nstride];
      d = ndom[j * nstride];
    } else {
      h = __ldg(nhash + j);
      d = __ldg(ndom + j);
    }
    const int g_aff = pr[0], g_anti = pr[1];
    if (a.anti_on && g_anti > 0 &&
        (h.x == g_anti || h.y == g_anti || h.z == g_anti || h.w == g_anti))
      cap_j = 0;
    const bool miss = g_aff > 0 && h.x != g_aff && h.y != g_aff && h.z != g_aff && h.w != g_aff;
    const int occ = pr[2 + min(max(d, 0), kDomains - 1)];
    return (int)((miss ? (unsigned)a.w_aff : 0u) +
                 (unsigned)min(occ, a.spread_cap) * (unsigned)a.w_spread);
  };
  for (int i = tid; i < kBins; i += threads) bhist[i] = 0;
  for (int i = tid; i < 2 * warps * kBins; i += threads) whist[i] = 0;

  // the thread that stages one (lane, which) int of a gang's rows: the last
  // 3R threads, so that warp 0 (phase 2) never waits on these loads
  const int* row_src = nullptr;
  int row_k = 0, row_slot = 0;
  const int rt = threads - 1 - tid;
  if (rt < 3 * r) {
    const int which = rt / r;
    row_k = rt - which * r;
    row_slot = row_k * 4 + which;
    row_src = which == 0 ? a.group_req : which == 1 ? a.magic : a.shift;
  }
  // kPolicy: the thread that stages int `prow_slot` of a gang's policy row
  // (the kPolicyStagers threads below the row stagers), from
  // prow_src[ge * prow_stride + prow_off]
  const int* prow_src = nullptr;
  int prow_slot = 0, prow_stride = 1, prow_off = 0;
  if (kPolicy && rt >= 3 * r && rt < 3 * r + kPolicyStagers) {
    prow_slot = rt - 3 * r;
    if (prow_slot < 2) {
      prow_src = prow_slot == 0 ? a.aff : a.anti;
    } else {
      prow_src = a.gang_dom;
      prow_stride = kDomains;
      prow_off = prow_slot - 2;
    }
  }

  // step 0's gang; an out-of-range order entry is a step with need 0
  int gi = g > 0 ? __ldg(a.order) : -1;
  bool ok = (unsigned)gi < (unsigned)g;
  int ge = ok ? gi : 0;
  int need = ok ? __ldg(a.remaining + ge) : 0;
  int gi_next = g > 1 ? __ldg(a.order + 1) : -1;
  if (row_src != nullptr && g > 0) rows[row_slot] = __ldg(row_src + (size_t)ge * r + row_k);
  if (prow_src != nullptr && g > 0)
    prow[prow_slot] = __ldg(prow_src + (size_t)ge * prow_stride + prow_off);
  Bits mbits = 0;  // bit j: node n0 + j is in this gang's fit row
  if (!kSlabs && g > 0) {
    const unsigned char* mrow =
        a.mask + (a.mask_per_group ? (size_t)ge * n : (size_t)0) + n0;
    for (int j = 0; j < cnt; ++j) mbits |= (Bits)(__ldg(mrow + j) != 0) << j;
  }
  if (tid == 0) {
    mbar_init(smem_addr(&inbox_full[0]), 1);
    mbar_init(smem_addr(&inbox_full[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // slab c of the thread's nodes: how many (0 past the last), and their
  // capacities for the gang with request row `row` and mask row `mrow`
  // (with kPolicy, and policy row `pr`, their penalties too)
  const int slabs = kSlabs ? (per + kPer - 1) / kPer : 1;
  auto slab_caps = [&](int c, const int4* row, const unsigned char* mrow, const int* pr,
                       int (&cap)[kPer], int (&pen)[kPer]) {
    const int base = c * kPer;
    const int sc = opaque(min(max(cnt - base, 0), kPer));
    for (int j = 0; j < sc; ++j) cap[j] = __ldg(mrow + base + j) != 0 ? kBig : 0;
    if constexpr (kPolicy)
      for (int j = 0; j < sc; ++j) pen[j] = node_policy(base + j, pr, cap[j]);
    node_caps(cap, sc, row, r, left + base * threads, lane_slots, threads,
              min(per - base, kPer));
    return sc;
  };

  // every block's barriers exist before any block pushes into them
  cluster_barrier();

  for (int s = 0; s < g; ++s) {
    const int p = s & 1;
    const int4* row = reinterpret_cast<const int4*>(rows) + p * r;
    const int* pr = prow + p * kPolicyRow;
    int* wh = whist + (p * warps + warp) * kBins;
    const unsigned char* mrow =
        a.mask + (a.mask_per_group ? (size_t)ge * n : (size_t)0) + n0;

    // phase 1: capacities of the owned nodes, histograms of capc by key
    // (pen: the nodes' penalties, kPolicy only)
    int cap[kPer];
    int pen[kPer];
    const Key key(pen);
    if constexpr (kSlabs) {
      for (int c = 0; c < slabs; ++c) {
        const int sc = slab_caps(c, row, mrow, pr, cap, pen);
        hist_add(cap, sc, sc, need, lane, bhist, wh, key);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kPer; ++j) cap[j] = (mbits >> j) & 1 ? kBig : 0;
      if constexpr (kPolicy) {
#pragma unroll
        for (int j = 0; j < kPer; ++j) pen[j] = j < cnt ? node_policy(j, pr, cap[j]) : 0;
      }
      node_caps(cap, kPer, row, r, left, lane_slots, threads, per);
      hist_add(cap, kPer, cnt, need, lane, bhist, wh, key);
    }

    __syncthreads();

    // phase 2: warp 0 pushes this block's histogram into every block's
    // inbox; every block's warp 0 waits for all C of them and finds the
    // threshold bin (the same integers everywhere, so the same bin)
    const unsigned full = smem_addr(&inbox_full[p]);
    if (warp == 0)
      push_hist(bhist, smem_addr(&inbox[p][rank][lane * 4]), full, blocks, lane,
                blocks * kBins * 4);
    // prefetch step s+1 (and the order entry of s+2) into registers
    const bool has_next = s + 1 < g;
    const bool ok_next = has_next && (unsigned)gi_next < (unsigned)g;
    const int ge_next = ok_next ? gi_next : 0;
    const int need_next = ok_next ? __ldg(a.remaining + ge_next) : 0;
    const int gi_after = s + 2 < g ? __ldg(a.order + s + 2) : -1;
    int row_next = 0;
    if (row_src != nullptr && has_next)
      row_next = __ldg(row_src + (size_t)ge_next * r + row_k);
    int prow_next = 0;
    if (prow_src != nullptr && has_next)
      prow_next = __ldg(prow_src + (size_t)ge_next * prow_stride + prow_off);
    unsigned char mask_next[kPer];
    const bool load_mask = !kSlabs && a.mask_per_group && has_next;
    if (load_mask) {
      const unsigned char* mrow = a.mask + (size_t)ge_next * n + n0;
#pragma unroll
      for (int j = 0; j < kPer; ++j) mask_next[j] = j < cnt ? __ldg(mrow + j) : 0;
    }
    if (warp == 0) {
      mbar_wait(full, (s >> 1) & 1);
      int h[4], lo[4], c[4];
      const Sel sel = select_bin(&inbox[p][0][0], kBins, blocks, rank, need, lane, h, lo, c);
      if (lane == (sel.thresh >> 2)) {
        sh_thresh = sel.thresh;
        sh_rem = sel.rem;
        sh_pre = sel.pre;
      }
      if (lane == 0) sh_feasible = sel.feasible;
    }
    // every warp's step s-1 histogram was last read before the barrier above
    reinterpret_cast<int4*>(whist + ((p ^ 1) * warps + warp) * kBins)[lane] =
        make_int4(0, 0, 0, 0);
    if (row_src != nullptr && has_next) rows[(p ^ 1) * 4 * r + row_slot] = row_next;
    if (prow_src != nullptr && has_next) prow[(p ^ 1) * kPolicyRow + prow_slot] = prow_next;
    __syncthreads();

    // phase 3: the take, the leftover update and the take row
    const int feasible = sh_feasible;
    if (ok && rank == 0 && tid == 0) a.placed[gi] = (unsigned char)feasible;
    if (feasible) {  // same value in every thread of the cluster
      const int thresh = sh_thresh;
      const int* wh0 = whist + p * warps * kBins;
      int* arow = a.alloc + (size_t)ge * n + n0;
      if constexpr (kSlabs) {
        int own = 0;
        for (int c = 0; c < slabs; ++c) {
          const int sc = slab_caps(c, row, mrow, pr, cap, pen);
          own += bin_sum(cap, sc, sc, thresh, need, key);
        }
        int prefix = sh_pre + block_prefix(own, thresh, wh0, warp, lane);
        for (int c = 0; c < slabs; ++c) {
          const int sc = slab_caps(c, row, mrow, pr, cap, pen);
          prefix = take_commit(cap, sc, sc, need, thresh, sh_rem, prefix, row, r,
                               left + c * kPer * threads, lane_slots, threads, arow + c * kPer,
                               key);
        }
      } else {
        const int prefix =
            sh_pre + bin_prefix(cap, kPer, cnt, thresh, need, wh0, warp, lane, key);
        take_commit(cap, kPer, cnt, need, thresh, sh_rem, prefix, row, r, left, lane_slots,
                    threads, arow, key);
      }
    }

    gi = gi_next;
    ok = ok_next;
    ge = ge_next;
    need = need_next;
    gi_next = gi_after;
    if (load_mask) {
      mbits = 0;
#pragma unroll
      for (int j = 0; j < kPer; ++j) mbits |= (Bits)(mask_next[j] != 0) << j;
    }
  }

  // no block exits while its pushes may be in flight
  cluster_barrier();
  for (int j = 0; j < cnt; ++j)
    for (int k = 0; k < r; ++k)
      a.left_after[(size_t)(n0 + j) * r + k] = left[k * lane_slots + j * threads];
}

using KernelFn = void (*)(const ScanArgs);

// this build's instantiation for `per` nodes a thread: the next power of
// two <= 64 (the policy variant in the BST_POLICY_SCAN build)
template <int kPer>
KernelFn kernel_at_least(int per, int shared) {
  if (per <= kPer)
    return shared ? assign_scan_kernel<kPer, true, false, kPolicyBuild>
                  : assign_scan_kernel<kPer, false, false, kPolicyBuild>;
  if constexpr (kPer < 64) return kernel_at_least<kPer * 2>(per, shared);
  return nullptr;
}

// more than 64 nodes a thread: slabs of 64, leftover in global scratch
KernelFn kernel_for(int per, int shared) {
  if (per > 64) return shared ? nullptr : assign_scan_kernel<64, false, true, kPolicyBuild>;
  return per < 1 ? nullptr : kernel_at_least<1>(per, shared);
}

// the launch both builds' entry points make: checks the shape against the
// kernel's limits and the dynamic shared memory against its layout (8R ints
// of gang rows, with the policy variant 2 * kPolicyRow ints of policy rows,
// 2 * 128 ints a warp of histograms, and when `shared` the leftover, R ints
// a node, with the policy variant also the node columns, kNodeInts a node)
int launch_scan(const ScanArgs& args, int cluster_blocks, int threads, int shared,
                int shared_bytes, void* stream) {
  const int r = args.r, per = args.per;
  const int stagers = 3 * r + (kPolicyBuild ? kPolicyStagers : 0);
  const int policy_rows = kPolicyBuild ? 2 * kPolicyRow : 0;
  const int node_ints = r + (kPolicyBuild ? kNodeInts : 0);
  const KernelFn fn = kernel_for(per, shared);
  if (fn == nullptr || cluster_blocks < 1 || cluster_blocks > kMaxCluster ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      stagers > threads || (long long)threads * per < args.block_nodes ||
      (!shared && args.scratch == nullptr) ||
      shared_bytes <
          4 * (8 * r + policy_rows + 8 * threads + (shared ? node_ints * per * threads : 0)))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = configure((const void*)fn, cluster_blocks, shared_bytes);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(
      cluster_blocks, threads, shared_bytes, static_cast<cudaStream_t>(stream), &attr);
  e = cudaLaunchKernelEx(&cfg, fn, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Dynamic shared memory a block may use on `device`: the per-block opt-in
// limit less the kernel's static shared memory (the same in every
// instantiation). Negative on error (minus the CUDA error code).
int shared_budget(int device) {
  int optin = 0;
  cudaError_t e = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return -(int)e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, assign_scan_kernel<1, true, false, kPolicyBuild>);
  if (e != cudaSuccess) return -(int)e;
  return optin - (int)attr.sharedSizeBytes;
}

// How many clusters of this shape the current device can hold at once
// (cudaOccupancyMaxActiveClusters): 0 means the shape cannot be scheduled.
// Negative on error (minus the CUDA error code).
int clusters(int cluster_blocks, int threads, int per, int shared, int shared_bytes) {
  const KernelFn fn = kernel_for(per, shared);
  if (fn == nullptr || cluster_blocks < 1 || cluster_blocks > kMaxCluster ||
      threads < 32 || threads > kMaxThreads)
    return -(int)cudaErrorInvalidValue;
  cudaError_t e = configure((const void*)fn, cluster_blocks, shared_bytes);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(cluster_blocks, threads, shared_bytes, nullptr, &attr);
  int count = 0;
  e = cudaOccupancyMaxActiveClusters(&count, (const void*)fn, &cfg);
  if (e != cudaSuccess) return -(int)e;
  return count;
}

}  // namespace

extern "C" {

#ifndef BST_POLICY_SCAN

int bst_assign_scan_shared_budget(int device) { return shared_budget(device); }

int bst_assign_scan_clusters(int cluster_blocks, int threads, int per, int shared,
                             int shared_bytes) {
  return clusters(cluster_blocks, threads, per, shared, shared_bytes);
}

// Launch the scan as one cluster of `cluster_blocks` blocks of `threads`
// threads; block b owns nodes [b * block_nodes, (b + 1) * block_nodes) and
// each thread `per` of them. `shared` selects the leftover in shared
// memory; otherwise the kernel reads and writes `scratch`
// (cluster_blocks * R * per * threads ints). `shared_bytes` is the dynamic
// shared memory (launch_scan's layout). alloc and placed must be zeroed by
// the caller.
int bst_assign_scan(const void* left0, const void* group_req,
                    const void* remaining, const void* mask,
                    const void* order, const void* magic, const void* shift,
                    void* alloc, void* placed, void* left_after,
                    void* scratch, int n, int g, int r, int mask_per_group,
                    int cluster_blocks, int block_nodes, int threads, int per,
                    int shared, int shared_bytes, void* stream) {
  ScanArgs args{(const int*)left0, (const int*)group_req,
                (const int*)remaining, (const unsigned char*)mask,
                (const int*)order, (const int*)magic, (const int*)shift,
                (int*)alloc, (unsigned char*)placed, (int*)left_after,
                (int*)scratch, n, g, r, mask_per_group, block_nodes, per};
  return launch_scan(args, cluster_blocks, threads, shared, shared_bytes, stream);
}

#else

int bst_assign_policy_shared_budget(int device) { return shared_budget(device); }

int bst_assign_policy_clusters(int cluster_blocks, int threads, int per, int shared,
                               int shared_bytes) {
  return clusters(cluster_blocks, threads, per, shared, shared_bytes);
}

// The policy scan: bst_assign_scan's arguments, then the policy columns
// (aff[G], anti[G], gang_dom[G][16], node_hash[N][4], node_dom[N], int32)
// and, after shared_bytes, anti_on and the weights w_aff, w_spread,
// spread_cap (a disabled penalty term's weight is 0).
int bst_assign_policy(const void* left0, const void* group_req,
                      const void* remaining, const void* mask,
                      const void* order, const void* magic, const void* shift,
                      void* alloc, void* placed, void* left_after,
                      void* scratch, const void* aff, const void* anti,
                      const void* gang_dom, const void* node_hash, const void* node_dom,
                      int n, int g, int r, int mask_per_group,
                      int cluster_blocks, int block_nodes, int threads, int per,
                      int shared, int shared_bytes, int anti_on, int w_aff, int w_spread,
                      int spread_cap, void* stream) {
  ScanArgs args{(const int*)left0, (const int*)group_req,
                (const int*)remaining, (const unsigned char*)mask,
                (const int*)order, (const int*)magic, (const int*)shift,
                (int*)alloc, (unsigned char*)placed, (int*)left_after,
                (int*)scratch, n, g, r, mask_per_group, block_nodes, per,
                (const int*)aff, (const int*)anti, (const int*)gang_dom,
                (const int4*)node_hash, (const int*)node_dom,
                anti_on, w_aff, w_spread, spread_cap};
  return launch_scan(args, cluster_blocks, threads, shared, shared_bytes, stream);
}

#endif

const char* bst_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
