// assign_topk.cu — the hierarchical top-K gang-placement scan, hand-written
// for Hopper (sm_90a) as one thread-block cluster.
//
// Replaces: batch_scheduler_tpu/ops/oracle.py `assign_gangs_topk` (:1156, a
// lax.scan over waves; with `_coarse_rank` :1106, `_member_capacity` :213
// and `_select_best_fit` :176). Plain version: ops/oracle.py
// `assign_gangs_topk` of this package. It computes the serial scan's
// alloc, placed and left_after bit for bit, one wave of W consecutive gangs
// of the scan order at a time, with each gang's exact selection run on its
// kk = max(2, min(K, N)) candidate nodes, and the reference's three per-wave
// series: conflicts[s] (the wave was replayed gang by gang), megas[s] (it
// passed the uniform test, from the prepare kernel) and demotions[s] (gangs
// of its replay that took the dense column).
//
// Per wave, against the wave-entry leftover, as the reference's step:
// - coarse rank: every block sweeps its nodes for the wave's gangs,
//   writing each (gang, node)'s tightness key min(cap, 127) as a byte and
//   adding to a per-gang 128-bin count histogram of the fitting nodes, and
//   sums the need-clipped capacities (the pooled sums). One exchange (the
//   cluster reads every block's histograms through distributed shared
//   memory) gives each gang its candidate cut: the bin b* where the count
//   reaches kk and how many nodes of b* are in (the first by node index).
//   That is an exact top-kk of the composite min(cap, 127) * (N + 1) +
//   node, which is unique for every fitting node. Each block lists its own
//   candidates (node, capacity): a node of b* knows its index rank from
//   the lower blocks' counts and a block scan.
// - gather: a second exchange; every block reads all the lists (at most kk
//   entries a gang in the cluster) and sorts them by (key, node), the
//   reference's candidate slice, sentinel slots after.
// - speculative wave: one warp a gang runs the selection on its slice
//   (the histogram threshold of `_select_best_fit`: on slots sorted by key
//   the threshold is the key of the first slot whose prefix reaches the
//   need, and a threshold slot takes clip(need - prefix, 0, capc)). A gang
//   whose slice cannot cover its need while the pooled sum says it may fit
//   conflicts the wave. Otherwise the conflict check: the positive takes
//   sorted by (node, gang); for each touched node and each gang after its
//   first taker, the gang's capacity under the earlier gangs' takes (in
//   int64, each lane clamped at 0 as the reference's clamped prefix is)
//   against its capacity at wave entry. Only touched columns can change,
//   and every touched column is in the reference's candidate union, so the
//   verdict is the reference's. Every block computes the same verdict from
//   the same data; without a conflict, after one more cluster barrier (no
//   block may still be reading a leftover the commit changes), each block
//   commits the takes on its own nodes.
// - mega wave (the uniform flag): the gather runs for the first position's
//   row with the stream clip T = the wave's total need, and the pooled
//   sums are the full-row sum of min(cap, need_w) for every position w.
//   The reference's boundary feasibility (pooled less the candidates'
//   entry terms plus their post-take terms) and coverage decide; a
//   committed wave takes the stream units between the gang boundaries over
//   the slice.
// - replay: gang by gang, each ranks afresh against the live leftover
//   (two exchanges); a covering slice, or a pooled sum below the need,
//   selects on the slice; anything else is a dense-column demotion: the
//   full-row selection, with a third exchange of the 128-bin histogram of
//   min(cap, need) and the lower blocks' prefix in the threshold bin.
//
// Design:
// - Nodes are split over the cluster as in the serial kernel (the wrapper's
//   topk_kernel_plan: C blocks, `per` consecutive nodes a thread). The
//   leftover lives in a global scratch slab a block, transposed to
//   [R][per][threads]; only its owner block writes it (after a cluster
//   barrier other blocks read it through L2 for the conflict check), and
//   the key bytes sit beside it, [W][per][threads] a block.
// - Exchanges are cluster barriers (release/acquire) and reads of the other
//   blocks' shared memory through distributed shared memory. The rounds
//   alternate, gather after rank, so each round's buffer is written only
//   after a barrier that follows every read of its previous contents.
// - Capacities divide by each request with the prepare kernel's exact
//   multiply-shift numbers (cluster_scan.cuh `magic_div`), recomputed from
//   the leftover in each pass that needs them: the sweep (every node), the
//   candidate list and the commit (candidates only), the dense step.
// - int32 as the reference: counts, prefixes and need-clipped sums are at
//   most need * N, below 2^31 at the batch boundary; the pooled sums and
//   the conflict check's prefixes are int64. Takes update the leftover with
//   the serial kernel's wrapping subtraction. Integer atomics only, so the
//   result is deterministic.
//
// What bounds it on an H100: the chain of waves. A committed mega wave is
// two exchanges and one sweep of a gang's row, a committed speculative wave
// three barriers and one sweep of the wave's gangs, and a replayed wave two
// or three exchanges a gang after the failed attempt. The bytes and integer
// operations the function needs are far below that chain.
//
// Launch rules: the kernels run on the caller's stream, allocate nothing,
// and the C entry point returns the launch's CUDA error code.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster_scan.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxWave = 32;
constexpr int kMaxK = 128;
constexpr int kNodeShift = 5;  // an entry key is node << 5 | wave position

struct TopkArgs {
  const int* left0;
  const int* group_req;
  const int* remaining;
  const unsigned char* mask;
  const int* order;
  const int* magic;
  const int* shift;
  const unsigned char* uniform;  // [2S] from the prepare kernel
  int* alloc;
  unsigned char* placed;
  int* left_after;
  unsigned char* conflicts;
  unsigned char* megas;
  int* demotions;
  int* left;           // [C][R][per][threads] leftover slabs
  unsigned char* keys;  // [C][W][per][threads] tightness keys
  int n, g, r, mask_per_group, wave, kk, block_nodes, per;
};

struct TopkShared {
  long long pool[kMaxWave];    // round A: this block's pooled sums (read by the cluster)
  long long pooled[kMaxWave];  // the cluster's pooled sums
  int gi[kMaxWave];            // the wave's gang indices (-1 past G)
  int need[kMaxWave];
  int bstar[kMaxWave];         // candidate cut: bin b*, 128 when every fitting node is in
  int mneed[kMaxWave];         // nodes of b* that are candidates
  int lower[kMaxWave];         // nodes of b* in the lower-ranked blocks
  int lcnt[kMaxWave];          // round B: this block's candidates (read by the cluster)
  int total[kMaxWave];         // the cluster's candidates
  int feas[kMaxWave];          // selection on the slice: sum of need-clipped capacity >= need
  int mdiff[kMaxWave];         // mega: candidates' post-take less entry terms
  int bound[kMaxWave + 1];     // mega: the gang boundaries in the member stream
  int goff[kMaxWave * kMaxCluster];  // gather: a block's offset in the gang's list
  int gcnt[kMaxWave * kMaxCluster];  // gather: a block's candidates
  int wsum[32 * kMaxWave];     // block scans: per-warp sums
  alignas(16) int dhist[kBins];  // round D: this block's dense histogram (read by the cluster)
  int dsel[4];                 // dense step: threshold, remainder, lower prefix, feasible
  int flag;
  int nent;
};

// in-place exclusive prefix over the block's threads (thread order is node
// order) of vals[0..count); every thread of the block calls it
__device__ void block_scan(int* vals, int count, int* wsum, int lane, int warp, int warps) {
  for (int v = 0; v < count; ++v) {
    const int x = vals[v];
    const int inc = warp_inclusive_scan(x, lane);
    if (lane == 31) wsum[warp * kMaxWave + v] = inc;
    vals[v] = inc - x;
  }
  __syncthreads();
  for (int v = warp; v < count; v += warps) {
    const int x = lane < warps ? wsum[lane * kMaxWave + v] : 0;
    const int inc = warp_inclusive_scan(x, lane);
    __syncwarp();
    if (lane < warps) wsum[lane * kMaxWave + v] = inc - x;
  }
  __syncthreads();
  for (int v = 0; v < count; ++v) vals[v] += wsum[warp * kMaxWave + v];
  __syncthreads();
}

__device__ __forceinline__ long long warp_sum64(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// members of a gang with lane rows `row` ((request, magic, shift, -) a lane)
// that fit on the node whose lane 0 is at `lv` (lanes lane_slots apart)
__device__ __forceinline__ int member_cap(const int* lv, int lane_slots, const int4* row, int r) {
  int c = kBig;
  for (int k = 0; k < r; ++k) {
    const int4 q = row[k];
    if (q.x > 0) {
      const int v = min(max(lv[k * lane_slots], 0), kBig);
      c = min(c, magic_div(v, (unsigned)q.y, q.z));
    }
  }
  return c;
}

__global__ void __launch_bounds__(kMaxThreads, 1) assign_topk_kernel(const TopkArgs a) {
  extern __shared__ __align__(16) int dyn[];
  __shared__ TopkShared sh;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int blocks = (int)cluster.num_blocks();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int threads = blockDim.x;
  const int warps = threads / 32;
  const int n = a.n, g = a.g, r = a.r, per = a.per, wave = a.wave, kk = a.kk;
  const int b0 = min(rank * a.block_nodes, n);
  const int b1 = min(b0 + a.block_nodes, n);
  const int n0 = min(b0 + tid * per, b1);
  const int cnt = min(n0 + per, b1) - n0;
  const int lane_slots = per * threads;
  const int steps = (g + wave - 1) / wave;

  // dynamic shared memory: rows[W][R] (int4); hist[W][128]; list, slice,
  // gat, ents [W][kk] (int2: node, capacity; the conflict check's entries
  // reuse gat and ents); tk[W][kk]
  int4* rows = reinterpret_cast<int4*>(dyn);
  int* hist = reinterpret_cast<int*>(rows + wave * r);
  int2* list = reinterpret_cast<int2*>(hist + wave * kBins);
  int2* slice = list + wave * kk;
  int2* gat = slice + wave * kk;
  int2* ents = gat + wave * kk;
  int* tk = reinterpret_cast<int*>(ents + wave * kk);

  int* left = a.left + (size_t)rank * r * lane_slots + tid;  // own node i, lane k: [k * lane_slots + i * threads]
  unsigned char* keys = a.keys + (size_t)rank * wave * lane_slots + tid;

  // the leftover of any node (lane 0; lanes lane_slots apart)
  auto node_left = [&](int node) -> int* {
    const int b = node / a.block_nodes;
    const int loc = node - b * a.block_nodes;
    const int t = loc / per;
    return a.left + (size_t)b * r * lane_slots + (loc - t * per) * threads + t;
  };
  auto fits = [&](int j, int node) -> bool {
    const int gj = sh.gi[j];
    return gj >= 0 &&
           __ldg(a.mask + (a.mask_per_group ? (size_t)gj * n : (size_t)0) + node) != 0;
  };
  // take t members of wave position j on node (its owner block only)
  auto commit = [&](int j, int node, int t) {
    a.alloc[(size_t)sh.gi[j] * n + node] = t;
    int* lv = node_left(node);
    for (int k = 0; k < r; ++k) {
      int* cell = lv + k * lane_slots;
      *cell = (int)((unsigned)*cell - (unsigned)t * (unsigned)rows[j * r + k].x);
    }
  };

  for (int i = 0; i < cnt; ++i)
    for (int k = 0; k < r; ++k) left[k * lane_slots + i * threads] = a.left0[(size_t)(n0 + i) * r + k];
  __syncthreads();

  // ---- rank and gather the candidates of wave positions [j0, j1); with
  // `mega`, position j0's row feeds the pooled sums of every position
  auto rank_candidates = [&](int j0, int j1, bool mega) {
    // the cluster read these buffers between the last two barriers
    for (int q = tid; q < (j1 - j0) * kBins; q += threads) hist[j0 * kBins + q] = 0;
    if (tid < kMaxWave) sh.pool[tid] = 0;
    __syncthreads();
    const int pw = mega ? wave : j1;
    long long psum[kMaxWave];
    for (int w = j0; w < pw; ++w) psum[w] = 0;
    for (int i = 0; i < per; ++i) {  // every lane runs every slot (the warp votes)
      const bool valid = i < cnt;
      for (int j = j0; j < j1; ++j) {
        const int cap = valid && fits(j, n0 + i)
                            ? member_cap(left + i * threads, lane_slots, rows + j * r, r)
                            : 0;
        const int key = min(cap, kBins - 1);
        if (valid) keys[j * lane_slots + i * threads] = (unsigned char)key;
        const unsigned peers = __match_any_sync(kFull, key);
        if (key > 0 && lane == __ffs(peers) - 1) atomicAdd(hist + j * kBins + key, __popc(peers));
        if (mega) {
          for (int w = 0; w < wave; ++w) psum[w] += min(cap, sh.need[w]);
        } else {
          psum[j] += min(cap, sh.need[j]);
        }
      }
    }
    for (int w = j0; w < pw; ++w) {
      const long long v = warp_sum64(psum[w]);
      if (lane == 0 && v != 0)
        atomicAdd(reinterpret_cast<unsigned long long*>(&sh.pool[w]), (unsigned long long)v);
    }
    __syncthreads();
    cluster_barrier();  // round A
    if (tid < kMaxWave) sh.lcnt[tid] = 0;
    // the cut of each gang (a warp a gang): cluster counts by bin, 4 a lane
    for (int j = j0 + warp; j < j1; j += warps) {
      int h[4] = {0, 0, 0, 0};
      for (int c = 0; c < blocks; ++c) {
        const int4 v = *cluster.map_shared_rank(reinterpret_cast<int4*>(hist + j * kBins) + lane, c);
        h[0] += v.x; h[1] += v.y; h[2] += v.z; h[3] += v.w;
      }
      const int local = h[0] + h[1] + h[2] + h[3];
      const int incl = warp_inclusive_scan(local, lane);
      int cum = incl - local, below = 0, before = 0;
      for (int t = 0; t < 4; ++t) {
        if (cum + h[t] < kk) ++below;
        else if (cum < kk) before = cum;  // the cut's bin: the count below it
        cum += h[t];
      }
      const int bs = __reduce_add_sync(kFull, below);  // 128 when fewer than kk fit
      if (bs < kBins && lane == (bs >> 2)) {
        sh.bstar[j] = bs;
        sh.mneed[j] = kk - before;
      } else if (bs == kBins && lane == 0) {
        sh.bstar[j] = kBins;
        sh.mneed[j] = 0;
      }
      const int lo = lane < blocks && lane < rank && bs < kBins
                         ? *cluster.map_shared_rank(hist + j * kBins + bs, lane)
                         : 0;
      const int lower = __reduce_add_sync(kFull, lo);
      const long long pl = lane < blocks ? *cluster.map_shared_rank(&sh.pool[j], lane) : 0;
      const long long pooled = warp_sum64(pl);
      if (lane == 0) {
        sh.lower[j] = lower;
        sh.pooled[j] = pooled;
      }
    }
    if (mega) {  // the other positions' pooled sums
      for (int w = j1 + warp; w < wave; w += warps) {
        const long long pl = lane < blocks ? *cluster.map_shared_rank(&sh.pool[w], lane) : 0;
        const long long pooled = warp_sum64(pl);
        if (lane == 0) sh.pooled[w] = pooled;
      }
    }
    __syncthreads();
    // this thread's index rank in each cut bin, then its candidates
    int ranks[kMaxWave];
    for (int j = j0; j < j1; ++j) {
      int c = 0;
      const int bs = sh.bstar[j];
      for (int i = 0; i < cnt; ++i) c += keys[j * lane_slots + i * threads] == bs;
      ranks[j - j0] = c;
    }
    block_scan(ranks, j1 - j0, sh.wsum, lane, warp, warps);
    for (int j = j0; j < j1; ++j) {
      const int bs = sh.bstar[j], m = sh.mneed[j];
      int run = sh.lower[j] + ranks[j - j0];
      for (int i = 0; i < cnt; ++i) {
        const int key = keys[j * lane_slots + i * threads];
        bool in = key > 0 && key < bs;
        if (key > 0 && key == bs) in = run++ < m;
        if (in) {
          const int cap = member_cap(left + i * threads, lane_slots, rows + j * r, r);
          list[j * kk + atomicAdd(&sh.lcnt[j], 1)] = make_int2(n0 + i, cap);
        }
      }
    }
    __syncthreads();
    cluster_barrier();  // round B
    // every block's list offsets, a warp a gang
    for (int j = j0 + warp; j < j1; j += warps) {
      const int c = lane < blocks ? *cluster.map_shared_rank(&sh.lcnt[j], lane) : 0;
      const int incl = warp_inclusive_scan(c, lane);
      if (lane < blocks) {
        sh.goff[j * kMaxCluster + lane] = incl - c;
        sh.gcnt[j * kMaxCluster + lane] = c;
      }
      if (lane == 31) sh.total[j] = incl;
    }
    __syncthreads();
    for (int q = tid; q < (j1 - j0) * blocks * kk; q += threads) {
      const int j = j0 + q / (blocks * kk);
      const int c = (q / kk) % blocks, p = q % kk;
      if (p < sh.gcnt[j * kMaxCluster + c])
        gat[j * kk + sh.goff[j * kMaxCluster + c] + p] =
            *cluster.map_shared_rank(list + j * kk + p, c);
    }
    __syncthreads();
    // the slice: the candidates by (key, node), sentinels (node -1,
    // capacity 0) after
    for (int q = tid; q < (j1 - j0) * kk; q += threads) {
      const int j = j0 + q / kk, e = q % kk;
      const int tot = sh.total[j];
      if (e < tot) {
        const int2 me = gat[j * kk + e];
        const int mk = min(me.y, kBins - 1);
        int pos = 0;
        for (int f = 0; f < tot; ++f) {
          const int2 o = gat[j * kk + f];
          const int ok = min(o.y, kBins - 1);
          pos += ok < mk || (ok == mk && o.x < me.x);
        }
        slice[j * kk + pos] = me;
      } else {
        slice[j * kk + e] = make_int2(-1, 0);
      }
    }
    __syncthreads();
  };

  // ---- one warp: `_select_best_fit` of position j on its slice with need
  // `need`; takes into tk[j], returns feasible (the slice covers the need)
  auto select_slice = [&](int j, int need) -> int {
    int cap[4], capc[4];
    int sum = 0;
    for (int t = 0; t < 4; ++t) {
      const int s = lane * 4 + t;
      cap[t] = s < kk ? slice[j * kk + s].y : 0;
      capc[t] = min(cap[t], need);
      sum += capc[t];
    }
    const int incl = warp_inclusive_scan(sum, lane);
    const int total = __shfl_sync(kFull, incl, 31);
    const int feasible = total >= need;
    // threshold bin: the key of the first live slot whose inclusive prefix
    // reaches the need (live slots ascend by key); 0 for need <= 0
    int first = kBins, p = incl - sum;
    for (int t = 0; t < 4; ++t) {
      p += capc[t];
      if (cap[t] > 0 && p >= need && first == kBins) first = min(cap[t], kBins - 1);
    }
    const int thresh = need <= 0 ? 0 : min(__reduce_min_sync(kFull, first), kBins - 1);
    p = incl - sum;
    for (int t = 0; t < 4; ++t) {
      const int s = lane * 4 + t;
      const int key = min(cap[t], kBins - 1);
      int take = 0;
      if (key < thresh) take = capc[t];
      else if (key == thresh) take = min(max(need - p, 0), capc[t]);
      p += capc[t];
      if (s < kk) tk[j * kk + s] = feasible ? take : 0;
    }
    return feasible;
  };

  // ---- the dense-column step of position j: the full-row selection
  auto dense_step = [&](int j) {
    const int need = sh.need[j];
    for (int q = tid; q < kBins; q += threads) sh.dhist[q] = 0;
    __syncthreads();
    for (int i = 0; i < cnt; ++i) {
      const int cap = fits(j, n0 + i) ? member_cap(left + i * threads, lane_slots, rows + j * r, r) : 0;
      const int capc = min(cap, need);
      if (capc > 0) atomicAdd(&sh.dhist[min(cap, kBins - 1)], capc);
    }
    __syncthreads();
    cluster_barrier();  // round D
    if (warp == 0) {
      int h[4] = {0, 0, 0, 0}, lo[4] = {0, 0, 0, 0};
      for (int c = 0; c < blocks; ++c) {
        const int4 v = *cluster.map_shared_rank(reinterpret_cast<int4*>(sh.dhist) + lane, c);
        h[0] += v.x; h[1] += v.y; h[2] += v.z; h[3] += v.w;
        if (c < rank) {
          lo[0] += v.x; lo[1] += v.y; lo[2] += v.z; lo[3] += v.w;
        }
      }
      const int local = h[0] + h[1] + h[2] + h[3];
      const int incl = warp_inclusive_scan(local, lane);
      int cum[4];
      cum[0] = incl - local + h[0];
      cum[1] = cum[0] + h[1];
      cum[2] = cum[1] + h[2];
      cum[3] = cum[2] + h[3];
      const int below = __reduce_add_sync(
          kFull, (cum[0] < need) + (cum[1] < need) + (cum[2] < need) + (cum[3] < need));
      const int th = min(below, kBins - 1);
      const int total = __shfl_sync(kFull, cum[3], 31);
      if (lane == (th >> 2)) {
        const int q = th & 3;
        sh.dsel[0] = th;
        sh.dsel[1] = need - (cum[q] - h[q]);
        sh.dsel[2] = lo[q];
      }
      if (lane == 0) sh.dsel[3] = total >= need;
    }
    __syncthreads();
    const int th = sh.dsel[0], rem = sh.dsel[1], feasible = sh.dsel[3];
    int own[1] = {0};
    for (int i = 0; i < cnt; ++i) {
      const int cap = fits(j, n0 + i) ? member_cap(left + i * threads, lane_slots, rows + j * r, r) : 0;
      if (cap > 0 && min(cap, kBins - 1) == th) own[0] += min(cap, need);
    }
    block_scan(own, 1, sh.wsum, lane, warp, warps);
    if (feasible) {
      int prefix = sh.dsel[2] + own[0];
      for (int i = 0; i < cnt; ++i) {
        const int cap = fits(j, n0 + i) ? member_cap(left + i * threads, lane_slots, rows + j * r, r) : 0;
        const int key = min(cap, kBins - 1), capc = min(cap, need);
        int take = 0;
        if (cap > 0 && key < th) {
          take = capc;
        } else if (cap > 0 && key == th) {
          take = min(max(rem - prefix, 0), capc);
          prefix += capc;
        }
        if (take > 0) commit(j, n0 + i, take);
      }
    }
    if (rank == 0 && tid == 0) a.placed[sh.gi[j]] = (unsigned char)feasible;
    __syncthreads();
  };

  // ---- position j's turn in a replay; returns 1 for a dense demotion
  auto replay_gang = [&](int j) -> int {
    const int need = sh.need[j];
    rank_candidates(j, j + 1, false);
    if (warp == 0) {
      const int f = select_slice(j, need);
      if (lane == 0) sh.feas[j] = f;
    }
    __syncthreads();
    if (!sh.feas[j] && sh.pooled[j] >= need) {
      dense_step(j);
      return 1;
    }
    for (int s = tid; s < kk; s += threads) {
      const int node = slice[j * kk + s].x, t = tk[j * kk + s];
      if (t > 0 && node >= b0 && node < b1) commit(j, node, t);
    }
    if (rank == 0 && tid == 0) a.placed[sh.gi[j]] = (unsigned char)sh.feas[j];
    __syncthreads();
    return 0;
  };

  for (int s = 0; s < steps; ++s) {
    __syncthreads();  // the last wave's reads of the stage are done
    for (int j = tid; j < wave; j += threads) {
      const int pos = s * wave + j;
      const int gi = pos < g ? __ldg(a.order + pos) : -1;
      sh.gi[j] = (unsigned)gi < (unsigned)g ? gi : -1;
      sh.need[j] = sh.gi[j] >= 0 ? __ldg(a.remaining + sh.gi[j]) : 0;
    }
    for (int q = tid; q < wave * r; q += threads) {
      const int j = q / r, k = q - j * r;
      const int pos = s * wave + j;
      const int gi0 = pos < g ? __ldg(a.order + pos) : -1;
      const int gi = (unsigned)gi0 < (unsigned)g ? gi0 : -1;
      rows[q] = gi >= 0 ? make_int4(__ldg(a.group_req + (size_t)gi * r + k),
                                    __ldg(a.magic + (size_t)gi * r + k),
                                    __ldg(a.shift + (size_t)gi * r + k), 0)
                        : make_int4(0, 0, 0, 0);
    }
    __syncthreads();
    const bool mega = a.uniform[s] && !a.uniform[steps + s];
    bool replay;
    if (mega) {
      // ---- uniform: the member stream over position 0's candidates
      if (tid == 0) {
        int acc = 0;
        for (int w = 0; w < wave; ++w) {
          sh.bound[w] = acc;
          acc += sh.need[w];
        }
        sh.bound[wave] = acc;
      }
      __syncthreads();
      const int total = sh.bound[wave];
      rank_candidates(0, 1, true);
      if (warp == 0) {  // exclusive prefix of min(cap, total) over the slots, into tk[0]
        int capc[4], sum = 0;
        for (int t = 0; t < 4; ++t) {
          const int s2 = lane * 4 + t;
          capc[t] = s2 < kk ? min(slice[s2].y, total) : 0;
          sum += capc[t];
        }
        const int incl = warp_inclusive_scan(sum, lane);
        int p = incl - sum;
        for (int t = 0; t < 4; ++t) {
          const int s2 = lane * 4 + t;
          if (s2 < kk) tk[s2] = p;
          p += capc[t];
        }
        if (lane == 31) sh.flag = incl >= total;  // covered
      }
      if (tid < kMaxWave) sh.mdiff[tid] = 0;
      __syncthreads();
      for (int q = tid; q < wave * kk; q += threads) {
        const int w = q / kk, s2 = q % kk;
        const int cap = slice[s2].y, need = sh.need[w];
        const int taken = min(max(sh.bound[w] - tk[s2], 0), min(cap, total));
        const int d = min(cap - taken, need) - min(cap, need);
        if (d != 0) atomicAdd(&sh.mdiff[w], d);
      }
      __syncthreads();
      bool ok = sh.flag != 0;
      for (int w = 0; w < wave; ++w) ok &= sh.pooled[w] + sh.mdiff[w] >= sh.need[w];
      if (ok) {
        for (int s2 = tid; s2 < kk; s2 += threads) {
          const int node = slice[s2].x;
          if (node < b0 || node >= b1) continue;  // a sentinel, or not this block's
          const int capc = min(slice[s2].y, total), pre = tk[s2];
          int prev = 0;  // stream units of this node before boundary w
          for (int w = 0; w < wave; ++w) {
            const int next = min(max(sh.bound[w + 1] - pre, 0), capc);
            if (next != prev) a.alloc[(size_t)sh.gi[w] * n + node] = next - prev;
            prev = next;
          }
          if (prev != 0) {
            int* lv = node_left(node);
            for (int k = 0; k < r; ++k) {
              int* cell = lv + k * lane_slots;
              *cell = (int)((unsigned)*cell - (unsigned)prev * (unsigned)rows[k].x);
            }
          }
        }
        if (rank == 0)
          for (int w = tid; w < wave; w += threads)
            if (sh.gi[w] >= 0) a.placed[sh.gi[w]] = 1;
      }
      replay = !ok;
    } else {
      // ---- speculative: every position selects on its slice at wave entry
      rank_candidates(0, wave, false);
      for (int j = warp; j < wave; j += warps) {
        const int f = select_slice(j, sh.need[j]);
        if (lane == 0) sh.feas[j] = f;
      }
      __syncthreads();
      bool conflict = false;
      for (int j = 0; j < wave; ++j) conflict |= !sh.feas[j] && sh.pooled[j] >= sh.need[j];
      if (!conflict) {
        // the conflict check on the touched columns: positive takes sorted
        // by (node, position)
        if (tid == 0) sh.nent = 0;
        __syncthreads();
        for (int q = tid; q < wave * kk; q += threads) {
          const int t = tk[q];
          if (t > 0)
            gat[atomicAdd(&sh.nent, 1)] = make_int2((slice[q].x << kNodeShift) | (q / kk), t);
        }
        __syncthreads();
        const int ne = sh.nent;
        for (int e = tid; e < ne; e += threads) {
          const int2 me = gat[e];
          int pos = 0;
          for (int f = 0; f < ne; ++f) pos += gat[f].x < me.x;
          ents[pos] = me;
        }
        __syncthreads();
        bool bad = false;
        for (int q = tid; q < ne * wave; q += threads) {
          const int e = q / wave, j = q % wave;
          const int node = ents[e].x >> kNodeShift;
          if (e > 0 && (ents[e - 1].x >> kNodeShift) == node) continue;  // not the node's first
          if (!fits(j, node)) continue;
          int e_end = e;
          bool touched = false;
          while (e_end < ne && (ents[e_end].x >> kNodeShift) == node) {
            touched |= (ents[e_end].x & (kMaxWave - 1)) < j;
            ++e_end;
          }
          if (!touched) continue;
          const int* lv = node_left(node);
          int c0 = kBig, c1 = kBig;
          for (int k = 0; k < r; ++k) {
            const int4 qr = rows[j * r + k];
            if (qr.x <= 0) continue;
            const long long v = __ldcg(lv + k * lane_slots);
            long long d = 0;
            for (int f = e; f < e_end; ++f) {
              const int jj = ents[f].x & (kMaxWave - 1);
              if (jj < j) d += (long long)ents[f].y * rows[jj * r + k].x;
            }
            const int v0 = (int)min(max(v, 0LL), (long long)kBig);
            const int v1 = (int)min(max(v - d, 0LL), (long long)kBig);
            c0 = min(c0, magic_div(v0, (unsigned)qr.y, qr.z));
            c1 = min(c1, magic_div(v1, (unsigned)qr.y, qr.z));
          }
          bad |= c0 != c1;
        }
        conflict = __syncthreads_or(bad);
        // no block commits while another may still read the wave-entry
        // leftover of its nodes
        cluster_barrier();
      }
      if (!conflict) {
        for (int j = 0; j < wave; ++j) {
          if (sh.gi[j] < 0) continue;
          for (int s2 = tid; s2 < kk; s2 += threads) {
            const int node = slice[j * kk + s2].x, t = tk[j * kk + s2];
            if (t > 0 && node >= b0 && node < b1) commit(j, node, t);
          }
          __syncthreads();  // a node may take from several positions
        }
        if (rank == 0)
          for (int j = tid; j < wave; j += threads)
            if (sh.gi[j] >= 0) a.placed[sh.gi[j]] = (unsigned char)sh.feas[j];
      }
      replay = conflict;
    }
    __syncthreads();
    int dem = 0;
    if (replay)
      for (int j = 0; j < wave; ++j)
        if (sh.gi[j] >= 0) dem += replay_gang(j);
    if (rank == 0 && tid == 0) {
      a.conflicts[s] = (unsigned char)replay;
      a.megas[s] = (unsigned char)mega;
      a.demotions[s] = dem;
    }
  }

  // no block exits while the cluster may read its shared memory
  cluster_barrier();
  for (int i = 0; i < cnt; ++i)
    for (int k = 0; k < r; ++k) a.left_after[(size_t)(n0 + i) * r + k] = left[k * lane_slots + i * threads];
}

// The launch's first kernel (assign_wave.cu's): the multiply-shift numbers
// of every [G,R] request (ops/assign_scan.py `division_magic`) and the two
// halves of the uniform flags (`wave_uniform`): uniform[s] = every
// position's request row equals the first position's and the needs sum to
// at most (2^31 - 1) / N, uniform[S + s] = 1 when a per-group mask row of
// wave s differs from its first position's (zeroed by the caller).
__global__ void __launch_bounds__(256)
topk_prepare_kernel(const TopkArgs a, int* magic, int* shift, unsigned char* uniform) {
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
  const int lane = threadIdx.x & 31;
  const int nwarps = gridDim.x * (blockDim.x / 32);
  for (int s = blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5); s < steps; s += nwarps) {
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
    if (lane == 0) uniform[s] = (unsigned char)(same && total <= 2147483647LL / max(n, 1));
  }
}

// the dynamic shared memory a launch needs (see the kernel's layout)
long long shared_need(int wave, int kk, int r) {
  return (long long)wave * (16LL * r + 4LL * kBins + 36LL * kk);
}

}  // namespace

extern "C" {

// Dynamic shared memory a block may use on `device`: the per-block opt-in
// limit less the kernel's static shared memory. Negative on error (minus
// the CUDA error code).
int bst_assign_topk_shared_budget(int device) {
  int optin = 0;
  cudaError_t e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return -(int)e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, assign_topk_kernel);
  if (e != cudaSuccess) return -(int)e;
  return optin - (int)attr.sharedSizeBytes;
}

// How many clusters of this shape the current device can hold at once
// (cudaOccupancyMaxActiveClusters): 0 means the shape cannot be scheduled.
// Negative on error (minus the CUDA error code). `per` and `shared` are
// unused (the kernel has one instantiation and its leftover is in global
// scratch); they keep the other kernels' signature.
int bst_assign_topk_clusters(int cluster_blocks, int threads, int per, int shared,
                             int shared_bytes) {
  (void)per;
  (void)shared;
  if (cluster_blocks < 1 || cluster_blocks > kMaxCluster || threads < 32 ||
      threads > kMaxThreads)
    return -(int)cudaErrorInvalidValue;
  cudaError_t e = configure((const void*)assign_topk_kernel, cluster_blocks, shared_bytes);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(cluster_blocks, threads, shared_bytes, nullptr, &attr);
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, (const void*)assign_topk_kernel, &cfg);
  if (e != cudaSuccess) return -(int)e;
  return clusters;
}

// Launch the top-K scan at width `wave` (2..32) with kk candidates a gang
// (2..128, at most N): first the prepare kernel, which writes `magic` and
// `shift` ([G,R] int32) and `uniform` (2S bytes, which the caller zeroes),
// then the scan as one cluster of `cluster_blocks` blocks of `threads`
// threads, which writes `megas`, `conflicts` (S bytes) and `demotions` (S
// int32). Block b owns nodes [b * block_nodes, (b + 1) * block_nodes) and
// each thread `per` of them; `left` holds cluster_blocks * R * per *
// threads ints and `keys` cluster_blocks * wave * per * threads bytes.
// `shared_bytes` is the dynamic shared memory, at least wave * (16 R + 512
// + 36 kk). alloc and placed must be zeroed by the caller.
int bst_assign_topk(const void* left0, const void* group_req, const void* remaining,
                    const void* mask, const void* order, void* magic, void* shift,
                    void* uniform, void* alloc, void* placed, void* left_after,
                    void* conflicts, void* megas, void* demotions, void* left, void* keys,
                    int n, int g, int r, int mask_per_group, int wave, int kk,
                    int cluster_blocks, int block_nodes, int threads, int per, int shared_bytes,
                    void* stream) {
  if (wave < 2 || wave > kMaxWave || kk < 2 || kk > kMaxK || kk > n || cluster_blocks < 1 ||
      cluster_blocks > kMaxCluster || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || per < 1 || (long long)threads * per < block_nodes ||
      (long long)cluster_blocks * block_nodes < n || n >= (1 << (31 - kNodeShift)) ||
      left == nullptr || keys == nullptr || shared_bytes < shared_need(wave, kk, r))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = configure((const void*)assign_topk_kernel, cluster_blocks, shared_bytes);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  TopkArgs args{(const int*)left0, (const int*)group_req, (const int*)remaining,
                (const unsigned char*)mask, (const int*)order, (const int*)magic,
                (const int*)shift, (const unsigned char*)uniform, (int*)alloc,
                (unsigned char*)placed, (int*)left_after, (unsigned char*)conflicts,
                (unsigned char*)megas, (int*)demotions, (int*)left, (unsigned char*)keys,
                n, g, r, mask_per_group, wave, kk, block_nodes, per};
  const int steps = (g + wave - 1) / wave;
  topk_prepare_kernel<<<max(1, min(steps * wave, 2048)), 256, 0, st>>>(
      args, (int*)magic, (int*)shift, (unsigned char*)uniform);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(cluster_blocks, threads, shared_bytes, st, &attr);
  e = cudaLaunchKernelEx(&cfg, assign_topk_kernel, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* bst_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
