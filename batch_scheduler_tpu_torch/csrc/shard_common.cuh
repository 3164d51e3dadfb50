// shard_common.cuh — device helpers shared by the port's two node-sharded
// wave libraries (shard_wave.cu, the dense sharded scan; shard_topk.cu, its
// top-K form), both on one rank's block of the node axis (sm_90a):
// - a gang's member capacity on a leftover row;
// - the block prefix sum over kThreads-thread blocks;
// - `_hist_select` on merged histograms: each bucket's total over the ranks
//   and this rank's offset in it, the threshold bucket of a need, and this
//   rank's takes in node order;
// - a speculative wave's commit at a node: the conflict check against the
//   summary's capacities and the candidate leftover.
// ops/_build.py hashes this header with every source that includes it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBins = 128;
constexpr int kBig = 1 << 30;
constexpr int kMaxLanes = 32;  // ops/assign_scan.py _SHARD_MAX_LANES
constexpr int kMaxWave = 32;   // ops/assign_scan.py _MAX_WAVE (WAVE_WIDTHS' largest)
constexpr int kThreads = 1024;  // 32 warps: block_exclusive_scan's shape
constexpr int kNodeThreads = 256;

// floor(clamp(left, 0, 2^30) / clamp(q, 1, 2^30)) for a requested lane
__device__ __forceinline__ int lane_cap(int left, int q) {
  const int l = left < 0 ? 0 : (left > kBig ? kBig : left);
  const int d = q > kBig ? kBig : q;
  return l / d;
}

// members of a demand row that fit a leftover row: the minimum over the
// requested lanes (2^30 when no lane is requested)
__device__ __forceinline__ int member_cap(const int* left, const int* req, int r) {
  int cap = kBig;
  for (int x = 0; x < r; ++x) {
    const int q = req[x];
    if (q > 0) cap = min(cap, lane_cap(left[x], q));
  }
  return cap;
}

// exclusive prefix sum of `v` over a block of kThreads threads
__device__ int block_exclusive_scan(int v, int* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int t = warp_tot[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += y;
    }
    warp_tot[lane] = t;
  }
  __syncthreads();
  const int out = (warp > 0 ? warp_tot[warp - 1] : 0) + x - v;
  __syncthreads();  // warp_tot is free for the next scan
  return out;
}

// each bucket's total over the s ranks' histograms (rank x's at hist[x *
// stride]) and the units of the ranks before `rank` in it (global node
// order is rank-major); the caller synchronises before reading them
__device__ void merged_buckets(const int* hist, size_t stride, int s, int rank, int* tot,
                               int* off) {
  for (int b = threadIdx.x; b < kBins; b += blockDim.x) {
    int t = 0, o = 0;
    for (int x = 0; x < s; ++x) {
      const int v = hist[(size_t)x * stride + b];
      t += v;
      if (x < rank) o += v;
    }
    tot[b] = t;
    off[b] = o;
  }
}

// `_hist_select`'s threshold for `need` over the bucket totals: the first
// bucket whose inclusive sum reaches it (the last when none does) and the
// units below that bucket; returns whether the totals cover the need
__device__ bool hist_threshold(const int* tot, int need, int* thresh, int* below) {
  int cum = 0, t = 0, u = 0;
  for (int b = 0; b < kBins; ++b) {
    cum += tot[b];
    t += cum < need;
  }
  t = min(t, kBins - 1);
  for (int b = 0; b < t; ++b) u += tot[b];
  *thresh = t;
  *below = u;
  return cum >= need;
}

// this rank's takes of one row in node order: min(cap, clipv) of every node
// below the threshold bucket, the first `rem` units of the bucket itself (a
// block prefix over each thread's consecutive nodes), none above it; zeros
// when !ok
__device__ void bucket_take(const int* cap_row, int* out_row, int nl, int thresh, int rem,
                            int clipv, int ok, int* warp_tot) {
  const int per = (nl + blockDim.x - 1) / blockDim.x;
  const int n0 = min((int)threadIdx.x * per, nl), n1 = min(n0 + per, nl);
  int part = 0;
  for (int n = n0; n < n1; ++n) {
    const int v = cap_row[n];
    if (min(v, kBins - 1) == thresh) part += min(v, clipv);
  }
  int prefix = block_exclusive_scan(part, warp_tot);
  for (int n = n0; n < n1; ++n) {
    const int v = cap_row[n];
    const int key = min(v, kBins - 1);
    const int capc = min(v, clipv);
    int take = 0;
    if (key < thresh) {
      take = capc;
    } else if (key == thresh) {
      take = min(max(rem - prefix, 0), capc);
      prefix += capc;
    }
    out_row[n] = ok ? take : 0;
  }
}

// a speculative wave's commit at node n: each gang's capacity under the
// exclusive prefix of the earlier gangs' takes (clamped at -2^30) against
// its summary capacity (a difference sets *verify), and the candidate
// leftover
__device__ void speculative_commit(int n, const int* cap, const int* left, const int* req,
                                   const uint8_t* mask, int mask_stride, const int* takes,
                                   int* left_out, int* verify, int nl, int r, int w) {
  int acc[kMaxLanes];
  for (int x = 0; x < r; ++x) acc[x] = left[(size_t)n * r + x];
  bool conflict = false;
  for (int j = 0; j < w; ++j) {
    const int* q = req + (size_t)j * r;
    const int v = mask[(size_t)j * mask_stride + n] ? member_cap(acc, q, r) : 0;
    conflict |= v != cap[(size_t)j * nl + n];
    const int t = takes[(size_t)j * nl + n];
    for (int x = 0; x < r; ++x) acc[x] = max(acc[x] - t * q[x], -kBig);
  }
  for (int x = 0; x < r; ++x) left_out[(size_t)n * r + x] = acc[x];
  if (conflict) atomicOr(verify, 1);
}

}  // namespace
