// shard_topk.cu — one wave of the node-sharded hierarchical top-K gang scan
// on one rank's block of the node axis, hand-written for Hopper (sm_90a).
//
// Replaces: no Pallas kernel. Its reference is lax: the body of the
// shard_map in batch_scheduler_tpu/ops/oracle.py `assign_gangs_topk_sharded`
// (:1435), with `_select_best_fit_wave` (:1865) and `_hist_select` (:759).
// Plain versions: ops/oracle.py `shard_topk_summary` and `shard_topk_apply`;
// the collectives between the two steps, and the loop over waves, are
// ops/oracle.py `assign_gangs_topk_sharded`'s.
//
// Two entry points, one launch each, on the caller's stream. Both split
// the rank's nl nodes over a thread-block cluster (shard_common.cuh
// `split_nodes`: consecutive chunks a block, consecutive segments a warp):
// - bst_shard_topk_summary: a cluster a demand row (a speculative wave's W
//   gangs, a uniform wave's one stream row, one replayed gang). Each block
//   computes the member capacity of its nodes under the row's mask
//   (written to `cap`), a 128-bin count histogram of the tightness key
//   min(cap, 127) over the fitting nodes and its share of the pooled sums
//   (a uniform wave's W pooled needs in one pass, W partials a thread). It
//   pushes its counts into every block's shared memory and its histogram
//   and pooled parts into the leader's; one barrier phase; every block
//   finds with one warp the bin where the count reaches kk_l and pushes its
//   candidates to the leader: every fitting node below that bin and the
//   first ones of that bin by index (the earlier blocks' counts plus warp
//   ballot ranks in node order). A second phase, which only the leader
//   waits on; the leader sorts the at most 128 candidates by the global
//   composite key*(n_pad+1) + global index and writes the payload row
//   (ops/oracle.py's comment above TOPK_SPECULATIVE gives the columns) into
//   slot `rank` of an [S, rows, P] buffer whose other slots it zeroes, so
//   the merge is an all-reduce (sum).
// - bst_shard_topk_apply: one cluster: a leader block and up to 15 blocks
//   a chunk of nodes each. The leader merges each row's S sorted lists of
//   kk_l composites: a composite's merged rank is its index in its own list
//   plus, for each other rank, a binary-search count of the composites
//   before it (the lower rank first on equal keys: only the kBig sentinels
//   tie, and they order by position, as lax.top_k). The kk smallest decode
//   into key, global index and ownership; one warp a row then runs the
//   selection on them: the tightest-first take of `_select_best_fit` (the
//   merged order is the key order, so a candidate's prefix in the
//   threshold bucket is its prefix over all earlier candidates less the
//   units below), or a uniform wave's stream cut at its gang boundaries
//   with their feasibility sums (a warp a gang). Meanwhile the other blocks
//   write their chunk's takes rows (zero) and the unchanged leftover. One
//   barrier phase, which only the leader waits on; the leader writes the
//   candidates' takes and commits them: off the candidates every take is
//   zero, so the speculative conflict check (shard_common.cuh
//   `speculative_commit`) runs on the candidate nodes only, and so does a
//   stream's leftover. A replayed gang whose candidates cannot cover its
//   need while its pooled capacity could takes the dense-column selection
//   instead: every block computes `_hist_select` from the merged histograms,
//   and the threshold bucket's partials go to the later blocks in the same
//   exchange that carries the leader's verdict and candidates to the chunk
//   blocks; each block writes its chunk. The verify word is written, never
//   accumulated: no memset.
//
// What bounds it on an H100: neither bytes nor operations. A wave reads the
// block's leftover once or twice (nl = N / S nodes) and does ~W * nl * (2R +
// 10) integer operations, well under a microsecond of memory or ALU time at
// the north star. What a step costs is its two launches and their barrier
// phases, and the one or two collectives between them, which go through
// the host.

#include <cuda_runtime.h>
#include <stdint.h>

#include "shard_common.cuh"

namespace {

constexpr int kMaxK = 128;      // ops/assign_scan.py _MAX_TOPK
constexpr int kMaxPool = 1024;  // ops/assign_scan.py _SHARD_TOPK_POOL
constexpr int kSpeculative = 0, kMega = 1, kReplay = 2;  // ops/oracle.py TOPK_*

__host__ __device__ __forceinline__ int payload(int mode, int kk_l, int w) {
  return mode == kSpeculative ? 2 * kk_l + 1 : (mode == kMega ? 3 * kk_l + w : 2 * kk_l + 1 + kBins);
}

// The summary of a row of a wave of w <= kW gangs.
template <int kW>
__global__ void __launch_bounds__(kMaxThreads)
summary_kernel(int mode, const int* __restrict__ left, const int* __restrict__ req,
               const int* __restrict__ needs, const uint8_t* __restrict__ mask,
               int* __restrict__ cap, int* __restrict__ buf, int nl, int r, int w, int rows,
               int mask_stride, int s, int rank, int kk_l, int chunk) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ int cnt[kBins];        // this block's fitting nodes by key (published)
  __shared__ int hist[kBins];       // this block's clipped capacity by key (a replay's; published)
  __shared__ unsigned pool[kMaxWave];        // a stream's pooled needs (published)
  __shared__ unsigned long long mine_sum;    // the clipped pooled capacity (published)
  __shared__ int gcnt[kBins], ecnt[kBins];   // all blocks' counts, the earlier blocks'
  __shared__ int wlt[kMaxWarps], wtb[kMaxWarps];  // a warp's nodes below / at the cut bin
  __shared__ int cand_v[kMaxK], cand_c[kMaxK];    // the leader's: candidates by slot
  __shared__ int sort_v[kMaxK], sort_c[kMaxK];
  __shared__ int cnt_all[kMaxBlocks * kBins];  // every block's counts (pushed by each)
  // the leader's: every block's histogram, pooled parts and pooled sum
  __shared__ int hist_all[kMaxBlocks * kBins];
  __shared__ unsigned pool_all[kMaxBlocks * kMaxWave];
  __shared__ unsigned long long mine_all[kMaxBlocks];
  __shared__ int sh_tb, sh_lt, sh_want, sh_ncand, sh_elt, sh_etb;
  cluster_arrive_relaxed();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int me = (int)cluster.block_rank(), blocks = (int)cluster.num_blocks();
  const int row = blockIdx.y;
  const int* q = req + (size_t)row * r;
  const uint8_t* m = mask + (size_t)row * mask_stride;
  int* cap_row = cap + (size_t)row * nl;
  // the clips: a speculative or replayed gang's need; a stream's total need
  // (capc) and the total plus the largest need (capx)
  long long clip, clip_x = 0;
  if (mode == kMega) {
    long long total = 0, most = 0;
    for (int j = 0; j < w; ++j) {
      total += needs[j];
      most = max(most, (long long)needs[j]);
    }
    clip = total;
    clip_x = total + most;
  } else {
    clip = needs[mode == kSpeculative ? row : 0];
  }
  for (int b = threadIdx.x; b < kBins; b += blockDim.x) cnt[b] = hist[b] = 0;
  for (int j = threadIdx.x; j < kMaxWave; j += blockDim.x) pool[j] = 0;
  if (threadIdx.x == 0) mine_sum = 0;
  __syncthreads();
  const Segment g = segment_of(me, chunk, nl);
  long long mine = 0;  // saturated at the clip: only pooled < need is read
  unsigned part[kW];  // a stream's pooled needs, int32 wraparound as the payload's
#pragma unroll
  for (int j = 0; j < kW; ++j) part[j] = 0;
  for (int n = g.s0 + lane; n < g.s1; n += 32) {
    const int v = m[n] ? member_cap(left + (size_t)n * r, q, r) : 0;
    cap_row[n] = v;
    if (v > 0) atomicAdd(&cnt[min(v, kBins - 1)], 1);
    if (mode == kMega) {
#pragma unroll
      for (int j = 0; j < kW; ++j)
        if (j < w) part[j] += (unsigned)min(v, needs[j]);
    } else {
      const long long c = min((long long)v, clip);
      if (c > 0) {
        mine = min(mine + c, clip);
        if (mode == kReplay) atomicAdd(&hist[min(v, kBins - 1)], (int)c);
      }
    }
  }
  if (mode == kMega) {
#pragma unroll
    for (int j = 0; j < kW; ++j) {
      if (j < w) {
        const unsigned t = __reduce_add_sync(kFull, part[j]);
        if (lane == 0 && t != 0) atomicAdd(&pool[j], t);
      }
    }
  } else {
    for (int o = 16; o > 0; o >>= 1) mine = min(mine + __shfl_down_sync(kFull, mine, o), clip);
    if (lane == 0 && mine != 0) atomicAdd(&mine_sum, (unsigned long long)mine);
  }
  __syncthreads();
  cluster_wait();  // every block has started
  // this block's counts into every block's memory; its histogram (a
  // replay's), pooled parts (a stream's) and pooled sum into the leader's
  for (int i = threadIdx.x; i < blocks * kBins; i += blockDim.x) {
    const int c = i / kBins, b = i - c * kBins;
    *cluster.map_shared_rank(cnt_all + me * kBins + b, c) = cnt[b];
  }
  if (mode == kReplay) {
    int* lead = cluster.map_shared_rank(hist_all + me * kBins, 0);
    for (int b = threadIdx.x; b < kBins; b += blockDim.x) lead[b] = hist[b];
  }
  if (mode == kMega) {
    unsigned* lead = cluster.map_shared_rank(pool_all + me * kMaxWave, 0);
    for (int j = threadIdx.x; j < w; j += blockDim.x) lead[j] = pool[j];
  }
  if (threadIdx.x == 0) *cluster.map_shared_rank(mine_all + me, 0) = mine_sum;
  cluster_arrive();
  cluster_wait();  // every block's pushes are in
  for (int b = threadIdx.x; b < kBins; b += blockDim.x) {
    int t = 0, e = 0;
    for (int x = 0; x < blocks; ++x) {
      const int v = cnt_all[x * kBins + b];
      t += v;
      if (x < me) e += v;
    }
    gcnt[b] = t;
    ecnt[b] = e;
  }
  __syncthreads();
  if (warp == 0) {
    // the bin where the fitting count reaches kk_l (kBins: every fitting
    // node; bin 0 holds none), the counts below it, and the earlier blocks'
    // nodes below it and in it
    const int b0 = lane * 4;
    int c4[4], e4[4], four = 0, efour = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      c4[i] = gcnt[b0 + i];
      e4[i] = ecnt[b0 + i];
      four += c4[i];
    }
    const int incl = warp_inclusive_scan(four);
    int cum = incl - four, first = kBins;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      cum += c4[i];
      if (first == kBins && cum >= kk_l) first = b0 + i;
    }
    const unsigned hit = __ballot_sync(kFull, first < kBins);
    const int tb = hit ? __shfl_sync(kFull, first, __ffs(hit) - 1) : kBins;
    int below = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      below += b0 + i < tb ? c4[i] : 0;
      efour += b0 + i < tb ? e4[i] : 0;
    }
    below = __reduce_add_sync(kFull, below);
    efour = __reduce_add_sync(kFull, efour);
    if (lane == 0) {
      sh_tb = tb;
      sh_lt = below;
      sh_want = tb < kBins ? kk_l - below : 0;
      sh_ncand = tb < kBins ? kk_l : below;
      sh_elt = efour;
      sh_etb = tb < kBins ? ecnt[tb] : 0;
    }
  }
  __syncthreads();
  const int tb = sh_tb, lt = sh_lt, want = sh_want;
  // this block's candidates in node order: a warp's count of nodes below
  // the cut bin and in it, then each node's rank among them by ballots
  int nlt = 0, ntb = 0;
  for (int base = g.s0; base < g.s1; base += 32) {
    const int n = base + lane;
    const int v = n < g.s1 ? cap_row[n] : 0;
    const int key = min(v, kBins - 1);
    nlt += __popc(__ballot_sync(kFull, v > 0 && key < tb));
    ntb += __popc(__ballot_sync(kFull, v > 0 && key == tb));
  }
  if (lane == 0) {
    wlt[warp] = nlt;
    wtb[warp] = ntb;
  }
  __syncthreads();
  int rlt = sh_elt, rtb = sh_etb;
  for (int x = 0; x < warp; ++x) rlt += wlt[x], rtb += wtb[x];
  const int span = s * nl + 1, off = rank * nl;
  int* lead_v = cluster.map_shared_rank(cand_v, 0);
  int* lead_c = cluster.map_shared_rank(cand_c, 0);
  const unsigned below_me = (1u << lane) - 1;
  for (int base = g.s0; base < g.s1; base += 32) {
    const int n = base + lane;
    const int v = n < g.s1 ? cap_row[n] : 0;
    const int key = min(v, kBins - 1);
    const unsigned a = __ballot_sync(kFull, v > 0 && key < tb);
    const unsigned b = __ballot_sync(kFull, v > 0 && key == tb);
    int slot = -1;
    if (v > 0 && key < tb) {
      slot = rlt + __popc(a & below_me);
    } else if (v > 0 && key == tb) {
      const int at = rtb + __popc(b & below_me);
      if (at < want) slot = lt + at;
    }
    if (slot >= 0) {
      lead_v[slot] = key * span + off + n;
      lead_c[slot] = v;
    }
    rlt += __popc(a);
    rtb += __popc(b);
  }
  cluster_arrive();
  if (me != 0) return;
  cluster_wait();  // every block's candidates are in the leader's memory
  for (int b = threadIdx.x; b < kBins; b += blockDim.x) {
    int t = 0;
    for (int x = 0; x < blocks; ++x) t += hist_all[x * kBins + b];
    hist[b] = t;  // the rank's histogram, for the payload
  }
  for (int j = threadIdx.x; j < w; j += blockDim.x) {
    unsigned t = 0;
    for (int x = 0; x < blocks; ++x) t += pool_all[x * kMaxWave + j];
    pool[j] = t;
  }
  if (threadIdx.x == 0) {
    unsigned long long t = 0;
    for (int x = 0; x < blocks; ++x) t += mine_all[x];
    mine_sum = (unsigned long long)min((long long)t, clip);
  }
  const int ncand = sh_ncand;
  for (int i = threadIdx.x; i < ncand; i += blockDim.x) {
    const int x = cand_v[i];
    int at = 0;
    for (int e = 0; e < ncand; ++e) at += cand_v[e] < x;  // composites are unique
    sort_v[at] = x;
    sort_c[at] = cand_c[i];
  }
  __syncthreads();
  const int p = payload(mode, kk_l, w);
  for (int i = threadIdx.x; i < p; i += blockDim.x) {
    int val;
    if (i < kk_l) {
      val = i < ncand ? sort_v[i] : kBig;
    } else if (i < 2 * kk_l) {
      const int c = i - kk_l;
      val = c < ncand ? (int)min((long long)sort_c[c], clip) : 0;
    } else if (mode == kMega) {
      if (i < 3 * kk_l) {
        const int c = i - 2 * kk_l;
        val = c < ncand ? (int)min((long long)sort_c[c], clip_x) : 0;
      } else {
        val = (int)pool[i - 3 * kk_l];
      }
    } else if (i == 2 * kk_l) {
      val = (int)(long long)mine_sum;
    } else {
      val = hist[i - 2 * kk_l - 1];
    }
    for (int t = 0; t < s; ++t) buf[((size_t)t * rows + row) * p + i] = t == rank ? val : 0;
  }
}

// the composites of a sorted list of n before v: those < v, or <= v
__device__ __forceinline__ int count_before(const int* list, int n, int v, bool or_equal) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int x = list[mid];
    if (x < v || (or_equal && x == v)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// The apply of a wave of w <= kW gangs.
template <int kW>
__global__ void __launch_bounds__(kMaxThreads)
apply_kernel(int mode, const int* __restrict__ merged, const int* __restrict__ cap,
             const int* __restrict__ needs, const int* __restrict__ left,
             const int* __restrict__ req, const uint8_t* __restrict__ mask, int mask_stride,
             int* __restrict__ takes, uint8_t* __restrict__ feas, int* __restrict__ left_out,
             int* __restrict__ verify, int* __restrict__ dense, int nl, int r, int w, int rows,
             int s, int rank, int kk_l, int kk, int chunk) {
  cg::cluster_group cluster = cg::this_cluster();
  // the leader's candidate table, row-major [rows, kk]
  __shared__ uint8_t t_key[kMaxWave * kMaxK];
  __shared__ int t_val[kMaxWave * kMaxK];   // the clipped capacity, then the take
  __shared__ int t_lidx[kMaxWave * kMaxK];  // the local node, -1 off this rank's block
  __shared__ int t_capx[kMaxK];             // a stream's capx
  __shared__ long long t_pre[kMaxK];        // a stream's exclusive prefix
  __shared__ int s_ok[kMaxWave], s_flag[kMaxWave];
  __shared__ int s_covered, s_verify;
  // a replay's dense-column selection
  __shared__ int s_thresh[1], s_rem[1], s_clip[1], s_dok;
  __shared__ int s_part[kMaxRows];
  __shared__ int s_wsum[kMaxWarps * kMaxRows];
  __shared__ int s_slots[kMaxBlocks * kMaxRows];
  __shared__ int r_lidx[kMaxK], r_take[kMaxK], r_flag;  // the leader's, pushed
  if (mode == kReplay) cluster_arrive_relaxed();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int me = (int)cluster.block_rank(), blocks = (int)cluster.num_blocks();
  const int p = payload(mode, kk_l, w);
  const Segment g = segment_of(me - 1, chunk, nl);  // the leader walks no nodes
  if (me == 0) {
    // the merged candidates: the kk smallest of each row's S lists
    for (int e = threadIdx.x; e < rows * kk; e += blockDim.x) {
      t_key[e] = kBins - 1;  // slots past the S * kk_l candidates are sentinels
      t_val[e] = 0;
      t_lidx[e] = -1;
    }
    for (int c = threadIdx.x; c < kk; c += blockDim.x) t_capx[c] = 0;
    __syncthreads();
    const int npool = s * kk_l;
    const int span = s * nl + 1, off = rank * nl;
    for (int e = threadIdx.x; e < rows * npool; e += blockDim.x) {
      const int row = e / npool, el = e - row * npool, x = el / kk_l, i = el - x * kk_l;
      const int* mine = merged + ((size_t)x * rows + row) * p;
      const int v = mine[i];
      int at = i;
      for (int y = 0; y < s && at < kk; ++y)
        if (y != x) at += count_before(merged + ((size_t)y * rows + row) * p, kk_l, v, y < x);
      if (at < kk) {
        const int slot = row * kk + at;
        const int key = v / span, gidx = v - key * span;
        t_key[slot] = (uint8_t)min(key, kBins - 1);
        t_val[slot] = mine[kk_l + i];
        t_lidx[slot] = v < kBig && gidx >= off && gidx < off + nl ? gidx - off : -1;
        if (mode == kMega) t_capx[at] = mine[2 * kk_l + i];
      }
    }
    __syncthreads();
    if (mode == kMega) {
      // the stream over the candidates: each one's exclusive prefix, and
      // whether they cover the wave
      if (warp == 0) {
        long long total = 0, c4[4], four = 0;
        for (int j = 0; j < w; ++j) total += needs[j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = lane * 4 + i;
          c4[i] = c < kk ? t_val[c] : 0;
          four += c4[i];
        }
        const long long incl = warp_inclusive_scan64(four);
        long long pre = incl - four;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = lane * 4 + i;
          if (c < kk) t_pre[c] = pre;
          pre += c4[i];
        }
        if (lane == 31) s_covered = incl >= total;
      }
      __syncthreads();
      // a warp a gang: its boundary's feasibility, the pooled need less the
      // candidates' entry terms plus their post-take terms
      for (int j = warp; j < w; j += nw) {
        long long bound = 0;
        for (int i = 0; i < j; ++i) bound += needs[i];
        const int nd = needs[j];
        long long d = 0;
        for (int c = lane; c < kk; c += 32) {
          const int cx = t_capx[c];
          const int t = (int)min(max(bound - t_pre[c], 0LL), (long long)t_val[c]);
          d += (long long)min(cx, nd) - min(cx - t, nd);
        }
        d = warp_sum64(d);
        if (lane == 0) {
          long long pooled = 0;
          for (int x = 0; x < s; ++x) pooled += merged[(size_t)x * p + 3 * kk_l + j];
          s_ok[j] = pooled - d >= nd;
        }
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        int ok = s_covered;
        for (int j = 0; j < w; ++j) ok = ok && s_ok[j];
        s_verify = ok;
      }
    } else {
      // a warp a row: the tightest-first take on its candidates in merged
      // order, which is key order
      for (int row = warp; row < rows; row += nw) {
        const long long need = needs[mode == kSpeculative ? row : 0];
        long long c4[4], four = 0;
        int k4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = lane * 4 + i;
          c4[i] = c < kk ? t_val[row * kk + c] : 0;
          k4[i] = c < kk ? t_key[row * kk + c] : kBins - 1;
          four += c4[i];
        }
        const long long incl = warp_inclusive_scan64(four);
        const long long total = __shfl_sync(kFull, incl, 31);
        const bool ok = total >= need;
        // the threshold: the key of the first candidate whose inclusive
        // prefix reaches the need (0 for a need <= 0, 127 when none does)
        long long cum = incl - four;
        int first = -1;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          cum += c4[i];
          if (first < 0 && cum >= need) first = k4[i];
        }
        const unsigned hit = __ballot_sync(kFull, first >= 0);
        int thresh = hit ? __shfl_sync(kFull, first, __ffs(hit) - 1) : kBins - 1;
        if (need <= 0) thresh = 0;
        long long pre = incl - four;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = lane * 4 + i;
          long long t = 0;
          if (k4[i] < thresh) t = c4[i];
          else if (k4[i] == thresh) t = min(max(need - pre, 0LL), c4[i]);
          if (c < kk) t_val[row * kk + c] = ok ? (int)t : 0;
          pre += c4[i];
        }
        if (lane == 0) {
          long long pooled = 0;
          for (int x = 0; x < s; ++x) pooled += merged[((size_t)x * rows + row) * p + 2 * kk_l];
          s_ok[row] = ok;
          s_flag[row] = ok || pooled < need;  // restricted (replay), or no verify (speculative)
        }
      }
    }
  }
  if (mode == kReplay) {
    // the dense-column selection's plan from the merged histograms, and the
    // cluster's threshold-bucket carries; the leader pushes its verdict and
    // its candidates (local node, take) to the chunk blocks in the same
    // exchange
    if (warp == 0) {
      const Plan pl = warp_plan(warp_bins(merged + 2 * kk_l + 1, (size_t)p, s, rank), needs[0],
                                false);
      if (lane == 0) {
        s_thresh[0] = pl.thresh;
        s_rem[0] = pl.rem;
        s_dok = pl.ok;
        s_clip[0] = needs[0];
      }
    }
    __syncthreads();
    bucket_carries<1>(cluster, cap, 0, 1, s_thresh, s_clip, g, s_part, s_wsum, s_slots,
                      [&] {
                        if (me != 0) return;
                        for (int i = threadIdx.x; i < (blocks - 1) * (kk + 1); i += blockDim.x) {
                          const int c = 1 + i / (kk + 1), e = i - (c - 1) * (kk + 1);
                          if (e == kk) {
                            *cluster.map_shared_rank(&r_flag, c) = s_flag[0];
                          } else {
                            *cluster.map_shared_rank(r_lidx + e, c) = t_lidx[e];
                            *cluster.map_shared_rank(r_take + e, c) = t_val[e];
                          }
                        }
                      });
    const int flag = me == 0 ? s_flag[0] : r_flag;
    if (!flag) {
      int carry = s_wsum[warp * kMaxRows];
      for (int base = g.s0; base < g.s1; base += 32) {
        const int n = base + lane;
        const bool valid = n < g.s1;
        const int v = valid ? cap[n] : 0;
        const int t = row_take(v, s_thresh[0], s_rem[0], s_clip[0], s_dok, carry);
        if (valid) {
          takes[n] = t;
          for (int x = 0; x < r; ++x)
            left_out[(size_t)n * r + x] = left[(size_t)n * r + x] - t * req[x];
        }
      }
    } else if (me != 0) {
      for (int n = g.c0 + threadIdx.x; n < g.c1; n += blockDim.x) {
        takes[n] = 0;
        for (int x = 0; x < r; ++x) left_out[(size_t)n * r + x] = left[(size_t)n * r + x];
      }
      __syncthreads();
      for (int c = threadIdx.x; c < kk; c += blockDim.x) {
        const int l = r_lidx[c];
        if (l < g.c0 || l >= g.c1) continue;
        const int t = r_take[c];
        takes[l] = t;
        for (int x = 0; x < r; ++x)
          left_out[(size_t)l * r + x] = left[(size_t)l * r + x] - t * req[x];
      }
    }
    if (me == 0 && threadIdx.x == 0) {
      feas[0] = (uint8_t)(flag ? s_ok[0] : s_dok);
      if (!flag) atomicAdd(dense, 1);
    }
    return;  // no block reads another's memory after the exchange
  }
  // the chunk blocks: zero takes rows and the unchanged leftover (clamped
  // at -2^30 by a speculative wave's commit, as every node's is)
  for (int n = g.c0 + threadIdx.x; n < g.c1; n += blockDim.x) {
    for (int j = 0; j < w; ++j) takes[(size_t)j * nl + n] = 0;
    for (int x = 0; x < r; ++x) {
      const int v = left[(size_t)n * r + x];
      left_out[(size_t)n * r + x] = mode == kSpeculative ? max(v, -kBig) : v;
    }
  }
  cluster_arrive();
  if (me != 0) return;
  cluster_wait();  // the chunks are written: the candidates' entries go over them
  if (mode == kMega) {
    for (int c = threadIdx.x; c < kk; c += blockDim.x) {
      const int l = t_lidx[c];
      if (l < 0) continue;
      long long bound = 0;
      int prev = (int)min(max(-t_pre[c], 0LL), (long long)t_val[c]);
      for (int j = 0; j < w; ++j) {
        bound += needs[j];
        const int t = (int)min(max(bound - t_pre[c], 0LL), (long long)t_val[c]);
        takes[(size_t)j * nl + l] = t - prev;
        prev = t;
      }
      for (int x = 0; x < r; ++x)
        left_out[(size_t)l * r + x] = left[(size_t)l * r + x] - prev * req[x];
    }
    for (int j = threadIdx.x; j < w; j += blockDim.x) feas[j] = 1;
    if (threadIdx.x == 0) verify[0] = s_verify;
    return;
  }
  for (int e = threadIdx.x; e < rows * kk; e += blockDim.x) {
    const int l = t_lidx[e];
    if (l >= 0) takes[(size_t)(e / kk) * nl + l] = t_val[e];
  }
  __syncthreads();
  bool bad = false;
  for (int e = threadIdx.x; e < rows * kk; e += blockDim.x) {
    const int l = t_lidx[e];
    if (l < 0) continue;
    int c[kW], t[kW];
#pragma unroll
    for (int j = 0; j < kW; ++j) {
      c[j] = j < w ? cap[(size_t)j * nl + l] : 0;
      t[j] = j < w ? takes[(size_t)j * nl + l] : 0;
    }
    bad |= speculative_commit<kW>(l, c, t, left, req, mask, mask_stride, left_out, r, w);
  }
  for (int j = threadIdx.x; j < rows; j += blockDim.x) {
    feas[j] = (uint8_t)s_ok[j];
    bad |= !s_flag[j];
  }
  bad = __syncthreads_or(bad);
  if (threadIdx.x == 0) verify[0] = bad;
}

bool widths_ok(int nl, int r, int w, int s, int rank, int kk_l) {
  return nl >= 1 && r >= 1 && r <= kMaxLanes && w >= 1 && w <= kMaxWave && s >= 1 && rank >= 0 &&
         rank < s && kk_l >= 1 && kk_l <= kMaxK && kk_l <= nl && s * kk_l <= kMaxPool &&
         (long long)s * nl * kBins + (long long)s * nl < kBig;
}

}  // namespace

extern "C" {

const char* bst_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The summary of a wave's rows into slot `rank` of buf [s, rows, P]; rows is
// w for the speculative mode, else 1. Returns a CUDA error code.
int bst_shard_topk_summary(const int* left, const int* req, const int* needs, const uint8_t* mask,
                           int* cap, int* buf, int mode, int nl, int r, int w, int mask_stride,
                           int s, int rank, int kk_l, void* stream) {
  if (mode < kSpeculative || mode > kReplay || !widths_ok(nl, r, w, s, rank, kk_l) ||
      (mode == kReplay && w != 1))
    return (int)cudaErrorInvalidValue;
  const int rows = mode == kSpeculative ? w : 1;
  const Split sp = split_nodes(nl, kMaxBlocks);
  const int bucket = wave_bucket(w);
  auto* kernel = bucket == 8 ? summary_kernel<8> : (bucket == 16 ? summary_kernel<16>
                                                                 : summary_kernel<kMaxWave>);
  return (int)launch_clusters(kernel, sp.blocks, rows, sp.threads, (cudaStream_t)stream,
                              mode, left, req, needs, mask, cap, buf, nl, r, w, rows, mask_stride,
                              s, rank, kk_l, sp.chunk);
}

// The apply of one wave (w gangs) or one replayed gang (w = 1) from the
// merged buffer [s, rows, P]. `verify` is one word (null for a replay),
// `dense` one word a replayed gang's dense demotion adds to. Returns a
// CUDA error code.
int bst_shard_topk_apply(const int* merged, const int* cap, const int* needs, const int* left,
                         const int* req, const uint8_t* mask, int* takes, uint8_t* feas,
                         int* left_out, int* verify, int* dense, int mode, int nl, int r, int w,
                         int s, int rank, int kk_l, int kk, int mask_stride, void* stream) {
  if (mode < kSpeculative || mode > kReplay || !widths_ok(nl, r, w, s, rank, kk_l) || kk < 1 ||
      kk > kMaxK || (mode == kReplay && w != 1) || ((mode == kReplay) != (verify == nullptr)) ||
      dense == nullptr)
    return (int)cudaErrorInvalidValue;
  const int rows = mode == kSpeculative ? w : 1;
  // a leader block and up to 15 blocks a chunk of nodes
  const Split sp = split_nodes(nl, kMaxBlocks - 1);
  const int bucket = wave_bucket(w);
  auto* kernel = bucket == 8 ? apply_kernel<8> : (bucket == 16 ? apply_kernel<16>
                                                               : apply_kernel<kMaxWave>);
  return (int)launch_clusters(kernel, sp.blocks + 1, 1, max(sp.threads, 256),
                              (cudaStream_t)stream, mode, merged, cap, needs, left, req, mask,
                              mask_stride, takes, feas, left_out, verify, dense, nl, r, w, rows,
                              s, rank, kk_l, kk, sp.chunk);
}

}  // extern "C"
