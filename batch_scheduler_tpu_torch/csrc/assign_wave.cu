// assign_wave.cu — the wavefront greedy gang-placement scan, hand-written
// for Hopper (sm_90a).
//
// Replaces: batch_scheduler_tpu/ops/pallas_assign.py `_kernel_wave` (reached
// by `assign_gangs_pallas(..., wave=W)`), the kernel form of ops/oracle.py
// `assign_gangs_wavefront`. It computes the serial scan's alloc, placed and
// left_after bit for bit (see assign_scan.cu for the per-gang selection),
// one wave of W consecutive gangs of the scan order at a time, and writes
// per-wave flags with the reference's lax definitions:
//   megas[s]     the wave took the uniform branch (committed or replayed);
//   conflicts[s] the wave was replayed serially.
// Three branches per wave, as in the reference:
//   uniform      every gang of the wave has the same demand row and mask
//                row, and sum(need) <= (2^31-1)/N: one aggregate
//                tightest-first fill split at the gang boundaries that
//                hold when every gang is feasible; if some gang is not
//                feasible at its assumed boundary, the wave is replayed;
//   speculative  otherwise every gang selects against the wave-start
//                leftover; the takes are kept only if every gang's
//                capacity row is unchanged under the exclusive prefix of
//                the earlier gangs' takes, else the wave is replayed;
//   replay       the serial body over the wave's gangs.
// Positions past G in the last wave are inert (no demand, need 0, masked
// out), as the reference's padding rows are.
//
// What bounds it on an H100: like the serial kernel it is one persistent
// block on one of the 132 SMs walking a chain of dependent steps; the
// bytes it must move would take ~10 us at 3.35 TB/s at the north-star
// shape. What the wave changes is the chain: a committed wave costs a
// fixed number of block barriers (about eight) instead of about four per
// gang. A replayed wave costs the failed attempt on top of the serial
// steps, so a workload that demotes every wave is slower than the serial
// kernel.
//
// Design:
// - The leftover lives in shared memory transposed to [R][N] (each thread
//   owns a contiguous run of nodes at `tid * stride`, stride odd), or in a
//   wrapper-allocated global scratch buffer when R rows do not fit. No
//   capacity row is kept: a wave needs W of them, which do not fit beside
//   the leftover, so capacities are recomputed from the leftover where
//   needed (integer division is exact, so recomputing gives the same
//   value).
// - The speculative branch batches the W selections: W histograms in
//   shared memory, filled in one pass without barriers between gangs;
//   warp j finds gang j's threshold bin; one block scan per gang gives the
//   threshold-bin prefix. Its takes go straight into alloc[order[p]]. The
//   conflict check is per node: a thread walks the wave's gangs over its
//   own nodes with the clamp-accumulated prefix leftover in registers
//   (lanes in chunks of 8). A wave that is replayed first clears the
//   entries it wrote.
// - The uniform branch builds one histogram of min(cap, total need), and
//   resolves node order within a bucket only for the <= W+1 buckets that
//   hold a gang boundary: one block scan per distinct boundary bucket.
// - int32: stream positions stay exact because sum(need) * N < 2^31 on the
//   uniform branch; the conflict check's prefix subtracts with a clamp at
//   -2^30, and a committed speculative wave updates the leftover with the
//   serial kernel's unsigned-wrap subtraction (no clamp can have fired).
// - Integer atomics only, so the result is deterministic.
//
// Launch rules: the kernel runs on the caller's stream, allocates nothing,
// and the C entry point returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 128;
constexpr int kBig = 1 << 30;
constexpr int kMaxWave = 32;   // one gang per warp in the batched phases
constexpr int kLaneChunk = 8;  // lanes the conflict check holds in registers
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// members of a demand lane q > 0 that fit in leftover lane l
__device__ __forceinline__ int lane_fit(int l, int q) {
  return (int)((unsigned)min(max(l, 0), kBig) / (unsigned)min(q, kBig));
}

struct WaveShared {
  int hist[kMaxWave][kBins];       // one histogram per gang of the wave
  int wsum[kMaxWave + 1][kWarps];  // per-warp sums of the block scans
  int cum_incl[kBins];             // uniform branch: inclusive bin prefix
  int bin_tot[kBins];
  int bucket_slot[kBins];          // uniform branch: boundary bucket's slot, -1
  int gi[kMaxWave];                // group of each wave position, -1 inert
  int need[kMaxWave];
  int thresh[kMaxWave];
  int rem[kMaxWave];
  int feasible[kMaxWave];
  int fsum[kMaxWave];
  int bbkt[kMaxWave + 1];          // bucket of each assumed boundary
  int boff[kMaxWave + 1];          // boundary less the units below its bucket
  int slots;
  int total_need;
  int uniform;
};

// One thread's view of the scan: its run of nodes and the shared state.
struct Thread {
  WaveShared& sh;
  const int* group_req;
  const unsigned char* mask;
  int* alloc;
  unsigned char* placed;
  int* left;  // lane k of own node i at left[k * row + i]
  size_t row;
  int n, r, n0, cnt, lane, warp, tid, mask_per_group;

  __device__ int req(int j, int k) const {
    const int gi = sh.gi[j];
    return gi < 0 ? 0 : __ldg(group_req + (size_t)gi * r + k);
  }

  // mask row of wave position j at this thread's first node; null: all 0
  __device__ const unsigned char* mrow(int j) const {
    if (!mask_per_group) return mask + n0;
    const int gi = sh.gi[j];
    return gi < 0 ? nullptr : mask + (size_t)gi * n + n0;
  }

  // members of gang j that fit on own node i's live leftover
  __device__ int cap(int i, int j, const unsigned char* m) const {
    if (m == nullptr || m[i] == 0) return 0;
    int c = kBig;
    for (int k = 0; k < r; ++k) {
      const int q = req(j, k);
      if (q > 0) c = min(c, lane_fit(left[k * row + i], q));
    }
    return c;
  }

  // hist[min(cap, 127)] += min(cap, clip) over own nodes for gang j: runs
  // of equal keys are summed first, and a warp whose lanes all hold one
  // run of one key adds once
  __device__ void hist_pass(int j, int clip, int* hist) const {
    const unsigned char* m = mrow(j);
    int run_key = 0, run_sum = 0;
    bool single = true;
    for (int i = 0; i < cnt; ++i) {
      const int c = cap(i, j, m);
      const int key = min(c, kBins - 1);
      const int capc = min(c, clip);
      if (i == 0) {
        run_key = key;
        run_sum = capc;
      } else if (key == run_key) {
        run_sum += capc;
      } else {
        atomicAdd(&hist[run_key], run_sum);
        run_key = key;
        run_sum = capc;
        single = false;
      }
    }
    const int lead_key = __shfl_sync(kFull, run_key, 0);
    const int vote = single ? (cnt > 0 ? run_key : lead_key) : kBins + lane;
    int all_same = 0;
    __match_all_sync(kFull, vote, &all_same);
    if (all_same) {
      const int v = warp_sum(cnt > 0 ? run_sum : 0);
      if (lane == 0) atomicAdd(&hist[vote], v);
    } else if (cnt > 0) {
      atomicAdd(&hist[run_key], run_sum);
    }
  }

  // one warp: gang j's threshold bin, what it still needs there and
  // whether the gang fits at all; clears the histogram
  __device__ void threshold(int j, int* hist) const {
    const int need = sh.need[j];
    const int b = lane * 4;
    const int h0 = hist[b], h1 = hist[b + 1], h2 = hist[b + 2], h3 = hist[b + 3];
    hist[b] = hist[b + 1] = hist[b + 2] = hist[b + 3] = 0;
    const int local = h0 + h1 + h2 + h3;
    const int incl = warp_inclusive_scan(local, lane);
    const int c0 = incl - local + h0, c1 = c0 + h1, c2 = c1 + h2, c3 = c2 + h3;
    const int below =
        warp_sum((c0 < need) + (c1 < need) + (c2 < need) + (c3 < need));
    const int thresh = min(below, kBins - 1);
    if (lane == (thresh >> 2)) {
      const int q = thresh & 3;
      const int cum_at = q == 0 ? c0 : q == 1 ? c1 : q == 2 ? c2 : c3;
      const int tot_at = q == 0 ? h0 : q == 1 ? h1 : q == 2 ? h2 : h3;
      sh.thresh[j] = thresh;
      sh.rem[j] = need - (cum_at - tot_at);
    }
    const int total = __shfl_sync(kFull, c3, 31);
    if (lane == 0) sh.feasible[j] = total >= need;
  }

  // own nodes' share of gang j's threshold bin
  __device__ int thresh_sum(int j) const {
    const unsigned char* m = mrow(j);
    const int need = sh.need[j], th = sh.thresh[j];
    int sum = 0;
    for (int i = 0; i < cnt; ++i) {
      const int c = cap(i, j, m);
      if (min(c, kBins - 1) == th) sum += min(c, need);
    }
    return sum;
  }

  // exclusive prefix of v over the block in thread order (row `slot` of wsum)
  __device__ int block_exclusive_scan(int v, int slot) const {
    const int incl = warp_inclusive_scan(v, lane);
    if (lane == 31) sh.wsum[slot][warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int w = sh.wsum[slot][lane];
      sh.wsum[slot][lane] = warp_inclusive_scan(w, lane) - w;
    }
    __syncthreads();
    return sh.wsum[slot][warp] + incl - v;
  }

  // gang j's take on own nodes into its alloc row (nonzero entries only),
  // given this thread's threshold-bin prefix; with `update`, the leftover
  // too (unsigned wrap, as the serial kernel)
  __device__ void take_pass(int j, int prefix, bool update) const {
    const unsigned char* m = mrow(j);
    const int need = sh.need[j], th = sh.thresh[j], rem = sh.rem[j];
    int* arow = alloc + (size_t)sh.gi[j] * n + n0;
    for (int i = 0; i < cnt; ++i) {
      const int c = cap(i, j, m);
      const int key = min(c, kBins - 1);
      const int capc = min(c, need);
      int take = 0;
      if (key < th) {
        take = capc;
      } else if (key == th) {
        take = min(max(rem - prefix, 0), capc);
        prefix += capc;
      }
      if (take == 0) continue;
      arow[i] = take;
      if (update) {
        for (int k = 0; k < r; ++k) {
          int* cell = left + k * row + i;
          *cell = (int)((unsigned)*cell - (unsigned)take * (unsigned)req(j, k));
        }
      }
    }
  }

  // the serial scan body over the wave's gangs
  __device__ void replay(int wave) const {
    for (int j = 0; j < wave; ++j) {
      const int gi = sh.gi[j];
      if (gi < 0) continue;  // same value in every thread
      hist_pass(j, sh.need[j], sh.hist[0]);
      __syncthreads();
      if (warp == 0) threshold(j, sh.hist[0]);
      __syncthreads();
      if (tid == 0) placed[gi] = (unsigned char)sh.feasible[j];
      if (!sh.feasible[j]) continue;
      take_pass(j, block_exclusive_scan(thresh_sum(j), 0), true);
    }
  }

  // does any gang's capacity on own node i change under the exclusive
  // prefix of the wave's earlier speculative takes?
  __device__ int node_conflict(int i, int wave) const {
    int cap_start[kMaxWave], cap_pref[kMaxWave], take[kMaxWave];
    for (int j = 0; j < wave; ++j) {
      const int gi = sh.gi[j];
      cap_start[j] = cap_pref[j] = kBig;
      take[j] = gi < 0 ? 0 : alloc[(size_t)gi * n + n0 + i];
    }
    for (int k0 = 0; k0 < r; k0 += kLaneChunk) {
      int acc[kLaneChunk];
#pragma unroll
      for (int kk = 0; kk < kLaneChunk; ++kk)
        acc[kk] = k0 + kk < r ? left[(k0 + kk) * row + i] : 0;
      for (int j = 0; j < wave; ++j) {
#pragma unroll
        for (int kk = 0; kk < kLaneChunk; ++kk) {
          if (k0 + kk >= r) continue;
          const int q = req(j, k0 + kk);
          if (q <= 0) continue;  // the lane neither limits nor changes
          cap_start[j] = min(cap_start[j], lane_fit(left[(k0 + kk) * row + i], q));
          cap_pref[j] = min(cap_pref[j], lane_fit(acc[kk], q));
          acc[kk] = max(acc[kk] - take[j] * q, -kBig);
        }
      }
    }
    for (int j = 0; j < wave; ++j) {
      const unsigned char* m = mrow(j);
      if (m != nullptr && m[i] != 0 && cap_start[j] != cap_pref[j]) return 1;
    }
    return 0;
  }

  // the speculative branch; false when the wave must be replayed
  __device__ bool speculative(int wave) const {
    for (int j = 0; j < wave; ++j) hist_pass(j, sh.need[j], sh.hist[j]);
    __syncthreads();
    if (warp < wave) threshold(warp, sh.hist[warp]);
    __syncthreads();
    int ex[kMaxWave];  // exclusive prefix within the warp, per gang
    for (int j = 0; j < wave; ++j) {
      if (sh.gi[j] < 0 || !sh.feasible[j]) continue;
      const int v = thresh_sum(j);
      const int incl = warp_inclusive_scan(v, lane);
      ex[j] = incl - v;
      if (lane == 31) sh.wsum[j][warp] = incl;
    }
    __syncthreads();
    if (warp < wave && sh.gi[warp] >= 0 && sh.feasible[warp]) {
      const int w = sh.wsum[warp][lane];
      sh.wsum[warp][lane] = warp_inclusive_scan(w, lane) - w;
    }
    __syncthreads();
    for (int j = 0; j < wave; ++j) {
      if (sh.gi[j] < 0 || !sh.feasible[j]) continue;
      take_pass(j, sh.wsum[j][warp] + ex[j], false);
    }
    // each thread reads back only the alloc entries it wrote itself
    int conflict = 0;
    for (int i = 0; i < cnt && !conflict; ++i) conflict = node_conflict(i, wave);
    if (__syncthreads_or(conflict)) {
      for (int j = 0; j < wave; ++j) {
        if (sh.gi[j] < 0 || !sh.feasible[j]) continue;
        int* arow = alloc + (size_t)sh.gi[j] * n + n0;
        for (int i = 0; i < cnt; ++i) arow[i] = 0;
      }
      return false;
    }
    for (int i = 0; i < cnt; ++i) {
      for (int j = 0; j < wave; ++j) {
        const int gi = sh.gi[j];
        if (gi < 0) continue;
        const int take = alloc[(size_t)gi * n + n0 + i];
        if (take == 0) continue;
        for (int k = 0; k < r; ++k) {
          int* cell = left + k * row + i;
          *cell = (int)((unsigned)*cell - (unsigned)take * (unsigned)req(j, k));
        }
      }
    }
    if (tid < wave && sh.gi[tid] >= 0)
      placed[sh.gi[tid]] = (unsigned char)sh.feasible[tid];
    return true;
  }

  // units of a node (bucket `key`, `capc` stream units, `within` units of
  // its bucket on earlier nodes) inside the first A_j units of the stream
  __device__ int taken(int j, int key, int capc, int within) const {
    const int b = sh.bbkt[j];
    return key < b ? capc : key == b ? min(max(sh.boff[j] - within, 0), capc) : 0;
  }

  // the uniform branch; false when a gang is infeasible at its assumed
  // boundary and the wave must be replayed
  __device__ bool uniform(int wave) const {
    const int total = sh.total_need;
    const unsigned char* m = mrow(0);
    if (tid < kBins) sh.bucket_slot[tid] = -1;
    hist_pass(0, total, sh.hist[0]);
    __syncthreads();
    if (warp == 0) {
      const int b = lane * 4;
      const int h0 = sh.hist[0][b], h1 = sh.hist[0][b + 1],
                h2 = sh.hist[0][b + 2], h3 = sh.hist[0][b + 3];
      sh.hist[0][b] = sh.hist[0][b + 1] = sh.hist[0][b + 2] = sh.hist[0][b + 3] = 0;
      const int local = h0 + h1 + h2 + h3;
      const int c0 = warp_inclusive_scan(local, lane) - local + h0;
      sh.cum_incl[b] = c0;
      sh.cum_incl[b + 1] = c0 + h1;
      sh.cum_incl[b + 2] = c0 + h1 + h2;
      sh.cum_incl[b + 3] = c0 + h1 + h2 + h3;
      sh.bin_tot[b] = h0;
      sh.bin_tot[b + 1] = h1;
      sh.bin_tot[b + 2] = h2;
      sh.bin_tot[b + 3] = h3;
    }
    __syncthreads();
    if (tid == 0) {
      // boundary A_j = sum of earlier needs; its bucket is the number of
      // bins whose inclusive prefix is <= A_j (kBins when past the end)
      int bound = 0, b = 0, slots = 0;
      for (int j = 0; j <= wave; ++j) {
        if (j > 0) bound += sh.need[j - 1];
        while (b < kBins && sh.cum_incl[b] <= bound) ++b;
        const int bb = min(b, kBins - 1);
        sh.bbkt[j] = b;
        sh.boff[j] = bound - (sh.cum_incl[bb] - sh.bin_tot[bb]);
        if (b < kBins && sh.bucket_slot[b] < 0) sh.bucket_slot[b] = slots++;
        if (j < wave) sh.fsum[j] = 0;
      }
      sh.slots = slots;
    }
    __syncthreads();
    const int slots = sh.slots;
    // this thread's exclusive prefix of each boundary bucket in node order
    int run[kMaxWave + 1];
    for (int s = 0; s < slots; ++s) run[s] = 0;
    for (int i = 0; i < cnt; ++i) {
      const int c = cap(i, 0, m);
      const int s = sh.bucket_slot[min(c, kBins - 1)];
      if (s >= 0) run[s] += min(c, total);
    }
    for (int s = 0; s < slots; ++s) {
      const int v = run[s];
      const int incl = warp_inclusive_scan(v, lane);
      run[s] = incl - v;
      if (lane == 31) sh.wsum[s][warp] = incl;
    }
    __syncthreads();
    for (int s = warp; s < slots; s += kWarps) {
      const int w = sh.wsum[s][lane];
      sh.wsum[s][lane] = warp_inclusive_scan(w, lane) - w;
    }
    __syncthreads();
    for (int s = 0; s < slots; ++s) run[s] += sh.wsum[s][warp];

    // every gang feasible at its assumed boundary: the capacity left after
    // the first A_j units is cap - taken_j
    {
      int fs[kMaxWave], cur[kMaxWave + 1];
      for (int j = 0; j < wave; ++j) fs[j] = 0;
      for (int s = 0; s < slots; ++s) cur[s] = run[s];
      for (int i = 0; i < cnt; ++i) {
        const int c = cap(i, 0, m);
        const int key = min(c, kBins - 1);
        const int capc = min(c, total);
        const int s = sh.bucket_slot[key];
        const int within = s >= 0 ? cur[s] : 0;
        for (int j = 0; j < wave; ++j)
          fs[j] += min(c - taken(j, key, capc, within), sh.need[j]);
        if (s >= 0) cur[s] += capc;
      }
      for (int j = 0; j < wave; ++j) {
        const int v = warp_sum(fs[j]);
        if (lane == 0 && v != 0) atomicAdd(&sh.fsum[j], v);
      }
    }
    __syncthreads();
    for (int j = 0; j < wave; ++j)
      if (sh.fsum[j] < sh.need[j]) return false;

    // commit: gang j takes the units between boundaries j and j+1
    for (int i = 0; i < cnt; ++i) {
      const int c = cap(i, 0, m);
      const int key = min(c, kBins - 1);
      const int capc = min(c, total);
      const int s = sh.bucket_slot[key];
      const int within = s >= 0 ? run[s] : 0;
      int prev = taken(0, key, capc, within);
      for (int j = 0; j < wave; ++j) {
        const int next = taken(j + 1, key, capc, within);
        const int gi = sh.gi[j];
        if (next != prev && gi >= 0) alloc[(size_t)gi * n + n0 + i] = next - prev;
        prev = next;
      }
      if (prev != 0) {
        for (int k = 0; k < r; ++k) {
          int* cell = left + k * row + i;
          *cell = (int)((unsigned)*cell - (unsigned)prev * (unsigned)req(0, k));
        }
      }
      if (s >= 0) run[s] += capc;
    }
    if (tid < wave && sh.gi[tid] >= 0) placed[sh.gi[tid]] = 1;
    return true;
  }
};

template <bool kShared>
__global__ void __launch_bounds__(kThreads, 1)
assign_wave_kernel(const int* __restrict__ left0,
                   const int* __restrict__ group_req,
                   const int* __restrict__ remaining,
                   const unsigned char* __restrict__ mask,
                   const int* __restrict__ order,
                   int* __restrict__ alloc,
                   unsigned char* __restrict__ placed,
                   int* __restrict__ left_after,
                   unsigned char* __restrict__ conflicts,
                   unsigned char* __restrict__ megas,
                   int* __restrict__ scratch,
                   int n, int g, int r, int mask_per_group, int wave) {
  extern __shared__ int dyn[];
  __shared__ WaveShared sh;

  const int tid = threadIdx.x;
  const int per = (n + kThreads - 1) / kThreads;
  const int stride = per | 1;
  const size_t row = (size_t)kThreads * stride;
  const int n0 = min(tid * per, n);
  const int cnt = min(n0 + per, n) - n0;
  int* work = kShared ? dyn : scratch;
  const Thread t{sh, group_req, mask, alloc, placed,
                 work + (size_t)tid * stride, row, n, r, n0, cnt,
                 tid & 31, tid >> 5, tid, mask_per_group};

  for (int i = 0; i < cnt; ++i)
    for (int k = 0; k < r; ++k)
      t.left[k * row + i] = left0[(size_t)(n0 + i) * r + k];
  for (int b = tid; b < kMaxWave * kBins; b += kThreads) (&sh.hist[0][0])[b] = 0;
  __syncthreads();

  // the uniform branch's stream positions stay exact in int32 only while
  // sum(need) * N does
  const long long mega_need_max = 2147483647LL / max(n, 1);
  const int steps = (g + wave - 1) / wave;
  for (int s = 0; s < steps; ++s) {
    if (tid == 0) {
      long long total = 0;
      for (int j = 0; j < wave; ++j) {
        const int p = s * wave + j;
        int gi = p < g ? order[p] : -1;
        if (gi >= g) gi = -1;
        sh.gi[j] = gi;
        sh.need[j] = gi >= 0 ? remaining[gi] : 0;
        total += sh.need[j];
      }
      int same = 1;
      for (int j = 1; j < wave && same; ++j)
        for (int k = 0; k < r; ++k) same &= t.req(j, k) == t.req(0, k);
      sh.total_need = (int)min(total, 2147483647LL);
      sh.uniform = same && total <= mega_need_max;
    }
    __syncthreads();
    int uniform = sh.uniform;
    if (uniform && mask_per_group) {
      const unsigned char* m0 = t.mrow(0);
      int differs = 0;
      for (int j = 1; j < wave; ++j) {
        const unsigned char* mj = t.mrow(j);
        for (int i = 0; i < cnt; ++i)
          differs |= (mj ? mj[i] : 0) != (m0 ? m0[i] : 0);
      }
      uniform = !__syncthreads_or(differs);
    }
    const bool committed = uniform ? t.uniform(wave) : t.speculative(wave);
    if (!committed) t.replay(wave);
    if (tid == 0) {
      conflicts[s] = (unsigned char)!committed;
      megas[s] = (unsigned char)(uniform != 0);
    }
    __syncthreads();
  }

  for (int i = 0; i < cnt; ++i)
    for (int k = 0; k < r; ++k)
      left_after[(size_t)(n0 + i) * r + k] = t.left[k * row + i];
}

}  // namespace

extern "C" {

// Dynamic shared memory the shared-leftover variant may use on `device`:
// the per-block opt-in limit less the kernel's static shared memory.
// Negative on error (minus the CUDA error code).
int bst_assign_wave_shared_budget(int device) {
  int optin = 0;
  cudaError_t e = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return -(int)e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, assign_wave_kernel<true>);
  if (e != cudaSuccess) return -(int)e;
  return optin - (int)attr.sharedSizeBytes;
}

// Launch the wavefront scan at width `wave` (1..32). `shared_bytes` > 0
// selects the shared-leftover variant with that much dynamic shared
// memory; 0 selects the global-scratch variant, which reads and writes
// `scratch` (R * 1024 * stride ints). alloc, placed, conflicts and megas
// must be zeroed by the caller.
int bst_assign_wave(const void* left0, const void* group_req,
                    const void* remaining, const void* mask,
                    const void* order, void* alloc, void* placed,
                    void* left_after, void* conflicts, void* megas,
                    void* scratch, int n, int g, int r, int mask_per_group,
                    int wave, int shared_bytes, void* stream) {
  if (wave < 1 || wave > kMaxWave) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (shared_bytes > 0) {
    cudaError_t e = cudaFuncSetAttribute(
        assign_wave_kernel<true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (e != cudaSuccess) return (int)e;
    assign_wave_kernel<true><<<1, kThreads, shared_bytes, st>>>(
        (const int*)left0, (const int*)group_req, (const int*)remaining,
        (const unsigned char*)mask, (const int*)order, (int*)alloc,
        (unsigned char*)placed, (int*)left_after, (unsigned char*)conflicts,
        (unsigned char*)megas, nullptr, n, g, r, mask_per_group, wave);
  } else {
    assign_wave_kernel<false><<<1, kThreads, 0, st>>>(
        (const int*)left0, (const int*)group_req, (const int*)remaining,
        (const unsigned char*)mask, (const int*)order, (int*)alloc,
        (unsigned char*)placed, (int*)left_after, (unsigned char*)conflicts,
        (unsigned char*)megas, (int*)scratch, n, g, r, mask_per_group, wave);
  }
  return (int)cudaGetLastError();
}

const char* bst_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
