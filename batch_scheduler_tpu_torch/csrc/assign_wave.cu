// assign_wave.cu — the wavefront greedy gang-placement scan, hand-written
// for Hopper (sm_90a) as one thread-block cluster.
//
// Replaces: batch_scheduler_tpu/ops/pallas_assign.py `_kernel_wave` (:104,
// reached by `assign_gangs_pallas(..., wave=W)`), the kernel form of
// ops/oracle.py `assign_gangs_wavefront`. It computes the serial scan's
// alloc, placed and left_after bit for bit (see assign_scan.cu for the
// per-gang selection), one wave of W consecutive gangs of the scan order
// at a time, and writes conflicts[s] = 1 for each wave the reference
// replays serially. megas[s] (the wave takes the uniform branch) depends
// on the inputs alone: the launch's first kernel (`wave_prepare_kernel`)
// computes all S flags, and the division numbers, before the scan (plain
// versions: ops/assign_scan.py `wave_uniform`, `division_magic`).
//
// What bounds it on an H100: the chain of S = ceil(G/W) waves. A uniform
// wave is one exchange of histograms between the cluster's SMs and two
// block barriers; any other wave is one serial step (one exchange) a gang.
// The bytes the function must move (~10 us at 3.35 TB/s at the 1024 x
// 8192 x 5 north-star shape) and its integer operations are far below
// that chain.
//
// How it reaches the serial results and the reference's flags:
// - uniform wave (every gang has the first gang's request and mask row and
//   sum(need) * N fits int32): with identical requests, taking t members
//   off a node drops its capacity by exactly t, so the serial fill is one
//   stream of member units ordered by (tightness bin, node index); gang j
//   takes units [A_j, A_j + need_j), A_j the sum of earlier needs. One
//   histogram exchange gives every block the cluster's 128-bin histogram of
//   min(cap, total need), hence each boundary's bin and offset, and this
//   block's prefix in every bin (the lower-ranked blocks' entries). Gang j
//   is feasible at its boundary iff need_j == 0 or A_{j+1} <= H, H the
//   stream's length: if H >= A_{j+1} the units after A_j cover need_j
//   (sum of min(x, c) >= min(sum x, c)); if not, no node's capacity reaches
//   the total need, so every node's capacity is its stream units and less
//   than need_j remain. This is the reference's batched feasibility check,
//   with no second exchange (needs are >= 0, as the packers give them).
//   Gangs before the first infeasible gang j* sit at their serial
//   boundaries (by induction), so they are committed, and the wave is
//   replayed serially from j* (conflicts = 1, as the reference replays the
//   whole wave).
// - any other wave: the checked replay. Its gangs run the serial kernel's
//   cluster step, which also runs the reference's conflict check: is gang
//   j's capacity row under the serial leftover different from its row
//   under the wave-start leftover? The reference compares against the
//   prefix of the wave's speculative takes; up to its first conflicted
//   gang k those are the serial takes (the induction in the reference's
//   docstring, oracle.py), so the first row that changes here is k's, and
//   conflicts = 1 iff some row changed. One flag word a block rides each
//   step's exchange until a change is known; the steps after it run
//   unchecked. (A speculative branch on the cluster, as the
//   reference has, was built and measured: its per-gang capacity passes
//   and conflict walk cost as much as a serial step, so it gained nothing
//   on any input and was removed; see PERF.md.)
// No take is written to alloc before the gang is known to keep it.
//
// Design:
// - The node axis is split over the cluster as in assign_scan.cu (the
//   wrapper's wave_kernel_plan picks C, threads and nodes a thread). The
//   leftover, and the checked replay's copy of the wave-start leftover,
//   live in shared memory transposed to [R][per][threads] when they fit,
//   else in a global scratch slab per block. Capacities come from the
//   leftover by exact multiply-shift division (`division_magic`) and stay
//   in registers across the passes of a uniform wave.
// - Exchanges are st.async pushes completing the receiver's mbarrier, as
//   in assign_scan.cu: inboxes and mbarriers double-buffered by round
//   parity, a block pushing round e + 2 only after it has received every
//   block's round e + 1, which each block pushes after reading its round-e
//   inbox. Every block runs every round of every wave (the branch comes
//   from the precomputed flag); cluster barriers run only before the loop
//   and after it. Positions past G in the last wave are inert (need 0,
//   masked out) and run no step.
// - Prefetch: wave s+1's needs, request/magic/shift rows and flag, and
//   wave s+2's order entries, are staged into shared memory (double-buffered
//   by wave parity) by the block's last threads while warp 0 waits on wave
//   s's first exchange; wave s+1's per-group mask bits are loaded into
//   registers after that.
// - Nodes a thread: 1 (every bucket up to 16384 nodes) has its own
//   instantiation with the per-node loops unrolled; 2 to 64 share one with
//   runtime loops (local arrays); more (buckets past 2^20 nodes) run as
//   slabs of 64 through the same device functions in a third, from global
//   scratch, each slab's capacities recomputed in each pass.
// - The per-gang step's device functions are cluster_scan.cuh's, the
//   serial kernel's own.
// - int32: the uniform stream positions stay exact because sum(need) * N
//   < 2^31; committed takes update the leftover with the serial kernel's
//   wrapping subtraction. Integer atomics only, so the result is
//   deterministic.
//
// Launch rules: the kernel runs on the caller's stream, allocates nothing,
// and the C entry point returns the launch's CUDA error code.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "cluster_scan.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxWave = 32;
constexpr int kMaxPer = 64;  // nodes a thread
// a block's slot in an inbox: 128 bins and one 16-byte word (the checked
// replay's conflict flag)
constexpr int kSlot = kBins + 4;
constexpr int kInbox = kMaxCluster * kSlot;  // ints of one inbox parity
// stage: gi[32], need[32], flag, pad, the next wave's gi[32]; then rows
constexpr int kGiNext = 68;
constexpr int kStageRows = 100;

struct WaveArgs {
  const int* left0;
  const int* group_req;
  const int* remaining;
  const unsigned char* mask;
  const int* order;
  const int* magic;
  const int* shift;
  // [2S] from the prepare kernel: the rows-and-needs test of each wave,
  // then whether a per-group mask row of the wave differs from the first
  const unsigned char* uniform;
  unsigned char* megas;
  int* alloc;
  unsigned char* placed;
  int* left_after;
  unsigned char* conflicts;
  int* scratch;
  int n, g, r, mask_per_group, wave, block_nodes, per;
};

struct __align__(16) WaveShared {
  int bh[kBins];             // this block's histogram of the round
  int cum[kBins];            // uniform: inclusive prefix of the cluster's histogram
  int cumx[kBins];           // uniform: the same, exclusive
  int blockpre[kBins];       // uniform: this block's prefix of each bin in the cluster
  int bbkt[kMaxWave + 1];    // uniform: bin of each boundary (kBins past the end)
  int boff[kMaxWave + 1];    // uniform: boundary less the units below its bin
  int slot_bin[kMaxWave + 1];  // uniform: the distinct boundary bins
  int slots;
  int limit;                 // uniform: gangs kept before the replay (j*)
  int flag;                  // checked replay: a capacity row of this block changed
  int wave_flag;             // checked replay: one changed anywhere in the wave
  int thresh, rem, pre, feasible;  // serial step
  unsigned long long full[2];      // mbarriers by round parity
};

// kPer nodes a thread with the per-node loops unrolled and their values in
// registers, or kPer = 0: up to kMaxPer nodes a thread in runtime loops
// (the buckets from 32768 nodes, whose leftover is mostly in global scratch),
// or kPer = -1 (slabs, leftover in global scratch): any number of nodes a
// thread, run as slabs of at most kMaxPer in runtime loops; each pass of a
// step recomputes a slab's capacities from the leftover and the mask bytes,
// so nothing per node is kept across the phases
template <int kPer, bool kShared>
__global__ void __launch_bounds__(kMaxThreads, 1)
assign_wave_kernel(const WaveArgs a) {
  constexpr bool kSlabs = kPer < 0;
  static_assert(!kSlabs || !kShared, "slabs run from global scratch");
  constexpr int kArr = kPer > 0 ? kPer : kMaxPer;
  using Bits = std::conditional_t<(kArr > 32), unsigned long long, unsigned>;
  extern __shared__ __align__(16) int dyn[];
  __shared__ WaveShared sh;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int blocks = (int)cluster.num_blocks();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int threads = blockDim.x;
  const int warps = threads / 32;
  const int n = a.n, g = a.g, r = a.r, per = a.per, wave = a.wave;
  const int b0 = min(rank * a.block_nodes, n);
  const int b1 = min(b0 + a.block_nodes, n);
  const int n0 = min(b0 + tid * per, b1);
  const int cnt = min(n0 + per, b1) - n0;
  const int np = kPer > 0 ? kPer : cnt;  // the per-node loops' trip count
  const int lane_slots = per * threads;
  const int steps = (g + wave - 1) / wave;

  // dynamic shared memory: inbox[2][kInbox]; stage[2][kStageRows + 128 r]
  // (gi, need, flag, then lane k of position j's (request, magic, shift, -)
  // at kStageRows + (j r + k) 4); whist[2][warps][128]; then, when kShared,
  // the leftover and the wave-start leftover, R * per * threads ints each
  int* inbox = dyn;
  const int stage_ints = kStageRows + 4 * kMaxWave * r;
  int* stage_base = inbox + 2 * kInbox;
  int* whist = stage_base + 2 * stage_ints;
  // lane k of node n0 + j at left[k * lane_slots + j * threads]
  int* left = (kShared ? whist + 2 * warps * kBins
                       : a.scratch + (size_t)rank * 2 * r * lane_slots) + tid;
  int* wave_left = left + r * lane_slots;  // the checked replay's wave-start leftover

  for (int j = 0; j < cnt; ++j)
    for (int k = 0; k < r; ++k)
      left[k * lane_slots + j * threads] = a.left0[(size_t)(n0 + j) * r + k];
  for (int i = tid; i < kBins; i += threads) sh.bh[i] = 0;
  for (int i = tid; i < 2 * warps * kBins; i += threads) whist[i] = 0;
  Bits m0 = 0;  // broadcast mask: bit j, node n0 + j is in the fit row
  if (!kSlabs && !a.mask_per_group)
    for (int j = 0; j < cnt; ++j) m0 |= (Bits)(__ldg(a.mask + n0 + j) != 0) << j;

  // wave t + 1's gang indices (-1 inert), validated, into `dst`
  auto stage_order = [&](int t, int* dst, int j) {
    const int pos = (t + 1) * wave + j;
    const int gi = pos < g ? __ldg(a.order + pos) : -1;
    dst[j] = (unsigned)gi < (unsigned)g ? gi : -1;
  };
  // wave t's gang indices, needs, flag and rows into stage parity t & 1,
  // by the block's last threads: the indices were staged with wave t - 1,
  // so each entry is one global load; wave t + 1's indices come along
  auto stage = [&](int t) {
    int* st = stage_base + (t & 1) * stage_ints;
    const int* gis = stage_base + ((t - 1) & 1) * stage_ints + kGiNext;
    const int per_pos = 3 + 3 * r;
    const int total = wave * per_pos + 1;
    for (int q = threads - 1 - tid; q < total; q += threads) {
      if (q == wave * per_pos) {
        st[2 * kMaxWave] = a.uniform[t] && !a.uniform[steps + t];
        continue;
      }
      const int j = q / per_pos, f = q - j * per_pos;
      const int gi = gis[j];
      if (f == 0) {
        st[j] = gi;
      } else if (f == 1) {
        st[kMaxWave + j] = gi >= 0 ? __ldg(a.remaining + gi) : 0;
      } else if (f == 2) {
        stage_order(t, st + kGiNext, j);
      } else {
        const int which = (f - 3) / r, k = f - 3 - which * r;
        const int* src = which == 0 ? a.group_req : which == 1 ? a.magic : a.shift;
        st[kStageRows + (j * r + k) * 4 + which] = gi >= 0 ? __ldg(src + (size_t)gi * r + k) : 0;
      }
    }
  };

  // bit j of mw[i]: node n0 + i is in the fit row of wave position j
  auto mask_bits = [&](const int* st, unsigned (&mw)[kArr]) {
    if (a.mask_per_group) {
#pragma unroll
      for (int i = 0; i < np; ++i) mw[i] = 0;
      for (int j = 0; j < wave; ++j) {
        const int gi = st[j];
        if (gi < 0) continue;
        const unsigned char* mr = a.mask + (size_t)gi * n + n0;
#pragma unroll
        for (int i = 0; i < np; ++i)
          if (i < cnt) mw[i] |= (unsigned)(__ldg(mr + i) != 0) << j;
      }
    } else {
      unsigned valid = 0;
      for (int j = 0; j < wave; ++j) valid |= (unsigned)(st[j] >= 0) << j;
#pragma unroll
      for (int i = 0; i < np; ++i) mw[i] = (m0 >> i) & 1 ? valid : 0u;
    }
  };

  // members of wave position j that fit on each own node of leftover slab
  // `src` (cluster_scan.cuh's capacity pass)
  auto caps = [&](const int* src, const int4* rows, int j, const unsigned (&mw)[kArr],
                  int (&cap)[kArr]) {
#pragma unroll
    for (int i = 0; i < np; ++i) cap[i] = (mw[i] >> j) & 1 ? kBig : 0;
    node_caps(cap, np, rows + j * r, r, src, lane_slots, threads, per);
  };
  // slab c of the own nodes (kSlabs): how many (0 past the last), and the
  // capacities of wave position j on leftover slab `src`, the fit bits read
  // from the mask as mask_bits reads them
  const int slabs = kSlabs ? (per + kMaxPer - 1) / kMaxPer : 1;
  auto slab_caps = [&](const int* src, const int* st, int j, int c, int (&cap)[kArr]) {
    const int base = c * kMaxPer;
    const int sc = opaque(min(max(cnt - base, 0), kMaxPer));  // runtime loops
    const int gi = st[j];
    const unsigned char* mr =
        a.mask + (a.mask_per_group ? (size_t)max(gi, 0) * n : (size_t)0) + n0 + base;
    for (int i = 0; i < sc; ++i) cap[i] = gi >= 0 && __ldg(mr + i) != 0 ? kBig : 0;
    node_caps(cap, sc, reinterpret_cast<const int4*>(st + kStageRows) + j * r, r,
              src + base * threads, lane_slots, threads, min(per - base, kMaxPer));
    return sc;
  };

  int e = 0;   // exchange rounds so far: round e uses inbox and mbarrier e & 1
  int hs = 0;  // histogram rounds so far: they use the per-warp histograms hs & 1
  auto inbox_of = [&](int round) { return inbox + (round & 1) * kInbox; };
  auto full_of = [&](int round) { return smem_addr(&sh.full[round & 1]); };
  auto phase_of = [&](int round) { return (round >> 1) & 1; };

  // warp 0: push sh.bh into every block's inbox (slot `rank`) and wait
  // for all of them; clears sh.bh. With `check` (the same in every
  // block), this block's conflict flag rides along: sh.flag is cleared and
  // the cluster's flags are ORed into sh.wave_flag
  auto exchange_hist = [&](bool check) {
    const unsigned full = full_of(e);
    const unsigned slot = smem_addr(inbox_of(e) + rank * kSlot + lane * 4);
    push_hist(sh.bh, slot, full, blocks, lane, blocks * (check ? kSlot : kBins) * 4);
    if (check && lane == 0) {
      const int4 flag = make_int4(sh.flag, 0, 0, 0);
      sh.flag = 0;
#pragma unroll
      for (int c = 0; c < kMaxCluster; ++c)
        if (c < blocks) push16(cluster_addr(slot + kBins * 4, c), flag, cluster_addr(full, c));
    }
    mbar_wait(full, phase_of(e));
    if (check &&
        __any_sync(kFull, lane < blocks && inbox_of(e)[lane * kSlot + kBins] != 0) &&
        lane == 0)
      sh.wave_flag = 1;
  };

  // the serial scan's step (cluster_scan.cuh) for wave position j against
  // the live leftover
  int cap[kArr];
  // with `check`, it also runs the reference's conflict check for the gang:
  // does its capacity row under the live (serial) leftover differ from the
  // one under the wave-start leftover kept in wave_left?
  auto serial_step = [&](const int* st, const unsigned (&mw)[kArr], int j, bool check) {
    const int4* rows = reinterpret_cast<const int4*>(st + kStageRows);
    const int need = st[kMaxWave + j];
    int* wh_cur = whist + ((hs & 1) * warps) * kBins;
    if constexpr (kSlabs) {
      bool differs = false;
      for (int c = 0; c < slabs; ++c) {
        const int sc = slab_caps(left, st, j, c, cap);
        if (check) {
          int start[kArr];
          slab_caps(wave_left, st, j, c, start);
          for (int i = 0; i < sc; ++i) differs |= cap[i] != start[i];
        }
        hist_add(cap, sc, sc, need, lane, sh.bh, wh_cur + warp * kBins);
      }
      if (differs) sh.flag = 1;
    } else {
      caps(left, rows, j, mw, cap);
      if (check) {
        int start[kArr];
        caps(wave_left, rows, j, mw, start);
        bool differs = false;
#pragma unroll
        for (int i = 0; i < np; ++i) differs |= i < cnt && cap[i] != start[i];
        if (differs) sh.flag = 1;
      }
      hist_add(cap, np, cnt, need, lane, sh.bh, wh_cur + warp * kBins);
    }
    __syncthreads();
    if (warp == 0) {
      exchange_hist(check);
      int h[4], lo[4], c[4];
      const Sel sel = select_bin(inbox_of(e), kSlot, blocks, rank, need, lane, h, lo, c);
      if (lane == (sel.thresh >> 2)) {
        sh.thresh = sel.thresh;
        sh.rem = sel.rem;
        sh.pre = sel.pre;
      }
      if (lane == 0) sh.feasible = sel.feasible;
    }
    reinterpret_cast<int4*>(whist + (((hs + 1) & 1) * warps + warp) * kBins)[lane] =
        make_int4(0, 0, 0, 0);
    __syncthreads();
    ++e;
    ++hs;
    const int feasible = sh.feasible;
    const int gi = st[j];
    if (rank == 0 && tid == 0 && gi >= 0) a.placed[gi] = (unsigned char)feasible;
    if (feasible && gi >= 0) {  // same values in every thread of the cluster
      const int th = sh.thresh;
      int* arow = a.alloc + (size_t)gi * n + n0;
      if constexpr (kSlabs) {
        int own = 0;
        for (int c = 0; c < slabs; ++c) {
          const int sc = slab_caps(left, st, j, c, cap);
          own += bin_sum(cap, sc, sc, th, need);
        }
        int prefix = sh.pre + block_prefix(own, th, wh_cur, warp, lane);
        for (int c = 0; c < slabs; ++c) {
          const int sc = slab_caps(left, st, j, c, cap);
          prefix = take_commit(cap, sc, sc, need, th, sh.rem, prefix, rows + j * r, r,
                               left + c * kMaxPer * threads, lane_slots, threads,
                               arow + c * kMaxPer);
        }
      } else {
        const int prefix = sh.pre + bin_prefix(cap, np, cnt, th, need, wh_cur, warp, lane);
        take_commit(cap, np, cnt, need, th, sh.rem, prefix, rows + j * r, r, left, lane_slots,
                    threads, arow);
      }
    }
  };

  // wave 0's indices where stage(0) reads them (parity 1), then wave 0
  if (tid < wave) stage_order(-1, stage_base + stage_ints + kGiNext, tid);
  __syncthreads();
  if (steps > 0) stage(0);
  if (tid == 0) {
    mbar_init(smem_addr(&sh.full[0]), 1);
    mbar_init(smem_addr(&sh.full[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    sh.flag = 0;
  }
  __syncthreads();
  // every block's barriers exist before any block pushes into them
  cluster_barrier();
  unsigned mw_next[kArr];
  if (!kSlabs && steps > 0) mask_bits(stage_base, mw_next);

  for (int s = 0; s < steps; ++s) {
    const int* st = stage_base + (s & 1) * stage_ints;
    const int4* rows = reinterpret_cast<const int4*>(st + kStageRows);
    unsigned mw[kArr];
    if constexpr (!kSlabs) {
#pragma unroll
      for (int i = 0; i < np; ++i) mw[i] = mw_next[i];
    }
    const bool has_next = s + 1 < steps;
    // between a wave's first two block barriers: stage the next wave;
    // after the second: load its mask bits (slabs read them in each pass)
    auto after_b2 = [&]() {
      if (!kSlabs && has_next) mask_bits(stage_base + ((s + 1) & 1) * stage_ints, mw_next);
    };
    int keep;  // gangs the wave's branch placed; the rest are replayed
    bool conflicted;  // the wave's conflicts flag

    if (st[2 * kMaxWave]) {
      // ---- uniform: one exchange of the histogram of min(cap, total need)
      int total = 0;
      for (int j = 0; j < wave; ++j) total += st[kMaxWave + j];
      int* wh_cur = whist + ((hs & 1) * warps) * kBins;
      if constexpr (kSlabs) {
        for (int c = 0; c < slabs; ++c) {
          const int sc = slab_caps(left, st, 0, c, cap);
          hist_add(cap, sc, sc, total, lane, sh.bh, wh_cur + warp * kBins);
        }
      } else {
        caps(left, rows, 0, mw, cap);
        hist_add(cap, np, cnt, total, lane, sh.bh, wh_cur + warp * kBins);
      }
      __syncthreads();
      if (has_next && warp != 0) stage(s + 1);
      if (warp == 0) {
        exchange_hist(false);
        int h[4], lo[4], c[4];
        select_bin(inbox_of(e), kSlot, blocks, rank, 0, lane, h, lo, c);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          sh.cum[lane * 4 + i] = c[i];
          sh.cumx[lane * 4 + i] = c[i] - h[i];
          sh.blockpre[lane * 4 + i] = lo[i];
        }
        const int stream = __shfl_sync(kFull, c[3], 31);  // H, the stream's length
        __syncwarp();
        // boundary A_j = sum of earlier needs: its bin is the number of
        // bins whose inclusive prefix is <= A_j (kBins past the end)
        const int need = lane < wave ? st[kMaxWave + lane] : 0;
        const int incl = warp_inclusive_scan(need, lane);
        const int total_all = __shfl_sync(kFull, incl, 31);
        const unsigned bad = __ballot_sync(kFull, lane < wave && need > 0 && incl > stream);
        const int jstar = bad ? __ffs(bad) - 1 : wave;
        int bin_lane = kBins;
        for (int j = lane; j <= wave; j += 32) {
          const int bound = j == 32 ? total_all : incl - need;
          int lo_b = 0, hi_b = kBins;
          while (lo_b < hi_b) {
            const int mid = (lo_b + hi_b) >> 1;
            if (sh.cum[mid] <= bound) lo_b = mid + 1;
            else hi_b = mid;
          }
          sh.bbkt[j] = lo_b;
          sh.boff[j] = bound - sh.cumx[min(lo_b, kBins - 1)];
          if (j < 32) bin_lane = lo_b;
        }
        // the distinct boundary bins up to j* (boundaries are sorted)
        const int prev = __shfl_up_sync(kFull, bin_lane, 1);
        const bool first =
            lane <= jstar && bin_lane < kBins && (lane == 0 || prev != bin_lane);
        const unsigned firsts = __ballot_sync(kFull, first);
        if (first) sh.slot_bin[__popc(firsts & ((1u << lane) - 1))] = bin_lane;
        __syncwarp();
        if (lane == 0) {
          int slots = __popc(firsts);
          if (jstar == 32 && sh.bbkt[32] < kBins && sh.bbkt[32] != sh.bbkt[31])
            sh.slot_bin[slots++] = sh.bbkt[32];
          sh.slots = slots;
          sh.limit = jstar;
        }
        if (has_next) stage(s + 1);
      }
      reinterpret_cast<int4*>(whist + (((hs + 1) & 1) * warps + warp) * kBins)[lane] =
          make_int4(0, 0, 0, 0);
      __syncthreads();
      ++e;
      ++hs;
      after_b2();
      keep = sh.limit;
      const int slots = sh.slots;
      // gang j takes the units between boundaries j and j+1 of the own
      // nodes held in `cap` (the nodes from n0 + off), given each one's
      // units in its bin on earlier nodes of the cluster (`within`, for
      // the nodes in a boundary bin)
      auto boundary_take = [&](const int (&within)[kArr], int np_, int cnt_, int off) {
#pragma unroll
        for (int i = 0; i < np_; ++i) {
          if (i >= cnt_) continue;
          const int key = min(cap[i], kBins - 1);
          const int capc = min(cap[i], total);
          auto taken = [&](int j) {
            const int b = sh.bbkt[j];
            return key < b ? capc : key == b ? min(max(sh.boff[j] - within[i], 0), capc) : 0;
          };
          int prev = taken(0);
          for (int j = 0; j < keep; ++j) {
            const int next = taken(j + 1);
            const int gi = st[j];
            if (next != prev && gi >= 0) a.alloc[(size_t)gi * n + n0 + off + i] = next - prev;
            prev = next;
          }
          if (prev != 0) {
            for (int k = 0; k < r; ++k) {
              int* cell = left + k * lane_slots + (off + i) * threads;
              *cell = (int)((unsigned)*cell - (unsigned)prev * (unsigned)rows[k].x);
            }
          }
        }
      };
      int within[kArr];
      if constexpr (kSlabs) {
        // each boundary bin's running prefix: the thread's units in it over
        // every slab first, then slab by slab
        int run[kMaxWave + 1];
        for (int q = 0; q < slots; ++q) run[q] = 0;
        for (int c = 0; c < slabs; ++c) {
          const int sc = slab_caps(left, st, 0, c, cap);
          for (int q = 0; q < slots; ++q) run[q] += bin_sum(cap, sc, sc, sh.slot_bin[q], total);
        }
        for (int q = 0; q < slots; ++q) {
          const int b = sh.slot_bin[q];
          run[q] = sh.blockpre[b] + block_prefix(run[q], b, wh_cur, warp, lane);
        }
        for (int c = 0; c < slabs; ++c) {
          const int sc = slab_caps(left, st, 0, c, cap);
          for (int i = 0; i < sc; ++i) within[i] = 0;
          for (int q = 0; q < slots; ++q) {
            const int b = sh.slot_bin[q];
            for (int i = 0; i < sc; ++i) {
              if (min(cap[i], kBins - 1) == b) {
                within[i] = run[q];
                run[q] += min(cap[i], total);
              }
            }
          }
          boundary_take(within, sc, sc, c * kMaxPer);
        }
      } else {
#pragma unroll
        for (int i = 0; i < np; ++i) within[i] = 0;
        for (int q = 0; q < slots; ++q) {
          const int b = sh.slot_bin[q];
          int run = sh.blockpre[b] + bin_prefix(cap, np, cnt, b, total, wh_cur, warp, lane);
#pragma unroll
          for (int i = 0; i < np; ++i) {
            if (i < cnt && min(cap[i], kBins - 1) == b) {
              within[i] = run;
              run += min(cap[i], total);
            }
          }
        }
        boundary_take(within, np, cnt, 0);
      }
      if (rank == 0 && tid < keep && st[tid] >= 0) a.placed[st[tid]] = 1;
      conflicted = keep < wave;
    } else {
      // ---- checked replay: serial steps that also run the conflict check;
      // the first gang whose row changes is the reference's first conflict
      for (int i = 0; i < cnt; ++i)
        for (int k = 0; k < r; ++k)
          wave_left[k * lane_slots + i * threads] = left[k * lane_slots + i * threads];
      __syncthreads();  // every thread is past wave s - 1 and its stage
      if (tid == 0) sh.wave_flag = 0;
      if (has_next) stage(s + 1);
      __syncthreads();
      after_b2();
      // once a row has changed anywhere (known to every block after that
      // step's exchange) the flag is 1, and the rest run unchecked
      for (int j = 0; j < wave; ++j)
        if (st[j] >= 0) serial_step(st, mw, j, sh.wave_flag == 0);
      keep = wave;
      conflicted = sh.wave_flag != 0;
    }

    // ---- a uniform wave's replay from its first infeasible gang
    for (int j = keep; j < wave; ++j)
      if (st[j] >= 0) serial_step(st, mw, j, false);  // the same value in every block
    if (rank == 0 && tid == 0) {
      a.conflicts[s] = (unsigned char)conflicted;
      a.megas[s] = (unsigned char)(st[2 * kMaxWave] != 0);
    }
  }

  // no block exits while its pushes may be in flight
  cluster_barrier();
  for (int j = 0; j < cnt; ++j)
    for (int k = 0; k < r; ++k)
      a.left_after[(size_t)(n0 + j) * r + k] = left[k * lane_slots + j * threads];
}

// The launch's first kernel: the multiply-shift numbers of every [G,R]
// request (ops/assign_scan.py `division_magic`) and the two halves of the
// uniform flags (`wave_uniform`): uniform[s] = every position's request row
// equals the first position's and the needs sum to at most (2^31 - 1) / N,
// uniform[S + s] = 1 when a per-group mask row of wave s differs from its
// first position's (zeroed by the caller). Inert positions have a zero
// row, need 0 and no mask. Block p compares scan position p's mask row.
__global__ void __launch_bounds__(256)
wave_prepare_kernel(const WaveArgs a, int* magic, int* shift, unsigned char* uniform) {
  const int g = a.g, r = a.r, n = a.n, wave = a.wave;
  const int steps = (g + wave - 1) / wave;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < g * r; i += gridDim.x * blockDim.x) {
    const int d = min(max(a.group_req[i], 1), kBig);
    const int l = 32 - __clz(d - 1);  // ceil(log2 d)
    const unsigned long long m = (1ull << (31 + l)) / (unsigned)d + 1;
    magic[i] = (int)(unsigned)m;
    shift[i] = l;
  }
  auto index = [&](int pos) {
    const int gi = pos < g ? a.order[pos] : -1;
    return (unsigned)gi < (unsigned)g ? gi : -1;
  };
  if (a.mask_per_group) {
    for (int p = blockIdx.x; p < steps * wave; p += gridDim.x) {
      const int s = p / wave;
      if (p == s * wave) continue;
      const int gj = index(p), g0 = index(s * wave);
      bool differs = false;
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const bool b = gj >= 0 && a.mask[(size_t)gj * n + i] != 0;
        const bool b0 = g0 >= 0 && a.mask[(size_t)g0 * n + i] != 0;
        differs |= b != b0;
      }
      if (__syncthreads_or(differs) && threadIdx.x == 0) uniform[steps + s] = 1;
    }
  }
  // one warp a wave: rows and needs
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (blockDim.x / 32);
  for (int s = blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5); s < steps; s += warps) {
    const int g0 = index(s * wave);
    bool same = true;
    long long total = 0;
    for (int j = lane; j < wave; j += 32) {
      const int gj = index(s * wave + j);
      if (gj >= 0) total += a.remaining[gj];
      for (int k = 0; k < r; ++k) {
        const int v = gj >= 0 ? a.group_req[(size_t)gj * r + k] : 0;
        const int v0 = g0 >= 0 ? a.group_req[(size_t)g0 * r + k] : 0;
        same &= v == v0;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) total += __shfl_xor_sync(kFull, total, o);
    same = __all_sync(kFull, same);
    if (lane == 0)
      uniform[s] = (unsigned char)(same && total <= 2147483647LL / max(n, 1));
  }
}

using KernelFn = void (*)(const WaveArgs);

template <int kPer>
KernelFn instance(int shared) {
  return shared ? assign_wave_kernel<kPer, true> : assign_wave_kernel<kPer, false>;
}

// the instantiation for `per` nodes a thread: unrolled for 1, the runtime
// loops up to 64, slabs of 64 beyond (leftover in global scratch only)
KernelFn kernel_for(int per, int shared) {
  if (per > kMaxPer) return shared ? nullptr : assign_wave_kernel<-1, false>;
  if (per < 1) return nullptr;
  return per == 1 ? instance<1>(shared) : instance<0>(shared);
}

}  // namespace

extern "C" {

// Dynamic shared memory a block may use on `device`: the per-block opt-in
// limit less the kernel's static shared memory (the same in every
// instantiation). Negative on error (minus the CUDA error code).
int bst_assign_wave_shared_budget(int device) {
  int optin = 0;
  cudaError_t e = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return -(int)e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, assign_wave_kernel<1, true>);
  if (e != cudaSuccess) return -(int)e;
  return optin - (int)attr.sharedSizeBytes;
}

// How many clusters of this shape the current device can hold at once
// (cudaOccupancyMaxActiveClusters): 0 means the shape cannot be scheduled.
// Negative on error (minus the CUDA error code).
int bst_assign_wave_clusters(int cluster_blocks, int threads, int per, int shared,
                             int shared_bytes) {
  const KernelFn fn = kernel_for(per, shared);
  if (fn == nullptr || cluster_blocks < 1 || cluster_blocks > kMaxCluster ||
      threads < 32 || threads > kMaxThreads)
    return -(int)cudaErrorInvalidValue;
  cudaError_t e = configure((const void*)fn, cluster_blocks, shared_bytes);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(cluster_blocks, threads, shared_bytes, nullptr, &attr);
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, (const void*)fn, &cfg);
  if (e != cudaSuccess) return -(int)e;
  return clusters;
}

// Launch the wavefront scan at width `wave` (1..32): first the prepare
// kernel, which writes `magic` and `shift` ([G,R] int32) and `uniform`
// (2S bytes, which the caller zeroes), then the scan as one cluster of
// `cluster_blocks` blocks of `threads` threads, which writes `megas` (the
// S uniform flags) and `conflicts`. Block b owns nodes
// [b * block_nodes, (b + 1) * block_nodes) and each thread `per` of them.
// `shared` selects the leftover and wave-start leftover in shared memory;
// otherwise the kernel reads and writes `scratch` (cluster_blocks * 2 * R
// * per * threads ints). `shared_bytes` is the dynamic shared memory: two
// inboxes of 16 * 132 ints, two stages of 100 + 128 R ints, two 128-bin
// histograms a warp, plus 2 * R * per * threads ints when `shared`. alloc
// and placed must be zeroed by the caller.
int bst_assign_wave(const void* left0, const void* group_req, const void* remaining,
                    const void* mask, const void* order, void* magic,
                    void* shift, void* uniform, void* megas, void* alloc, void* placed,
                    void* left_after, void* conflicts, void* scratch, int n, int g,
                    int r, int mask_per_group, int wave, int cluster_blocks,
                    int block_nodes, int threads, int per, int shared, int shared_bytes,
                    void* stream) {
  const KernelFn fn = kernel_for(per, shared);
  const long long fixed = 2LL * kInbox + 2LL * (kStageRows + 4 * kMaxWave * r) +
                          2LL * (threads / 32) * kBins;
  if (fn == nullptr || wave < 1 || wave > kMaxWave || cluster_blocks < 1 ||
      cluster_blocks > kMaxCluster || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || (long long)threads * per < block_nodes ||
      (!shared && scratch == nullptr) ||
      shared_bytes < 4 * (fixed + (shared ? 2LL * r * per * threads : 0)))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = configure((const void*)fn, cluster_blocks, shared_bytes);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  WaveArgs args{(const int*)left0, (const int*)group_req, (const int*)remaining,
                (const unsigned char*)mask, (const int*)order, (const int*)magic,
                (const int*)shift, (const unsigned char*)uniform, (unsigned char*)megas,
                (int*)alloc,
                (unsigned char*)placed, (int*)left_after, (unsigned char*)conflicts,
                (int*)scratch, n, g, r, mask_per_group, wave, block_nodes, per};
  const int steps = (g + wave - 1) / wave;
  wave_prepare_kernel<<<max(1, min(steps * wave, 2048)), 256, 0, st>>>(
      args, (int*)magic, (int*)shift, (unsigned char*)uniform);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(cluster_blocks, threads, shared_bytes, st, &attr);
  e = cudaLaunchKernelEx(&cfg, fn, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* bst_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
