// shard_common.cuh — device helpers shared by the port's two node-sharded
// wave libraries (shard_wave.cu, the dense sharded scan; shard_topk.cu, its
// top-K form), both on one rank's block of the node axis (sm_90a):
// - a gang's member capacity on a leftover row;
// - the split phases of the cluster barrier;
// - the split of a rank's nodes over one thread-block cluster: consecutive
//   chunks a block, consecutive segments a warp, 32 consecutive nodes a
//   step of a warp (so every pass over the nodes is coalesced);
// - `_hist_select` on merged histograms by one warp: the threshold bucket
//   of a need (or of a uniform wave's boundary) and the remainder at it,
//   less the earlier ranks' units there;
// - the threshold bucket's prefix in node order over the cluster: each
//   block's partial, pushed into the later blocks' shared memory behind one
//   barrier phase, the earlier warps', then a warp scan a step;
// - a speculative wave's commit at a node: the conflict check against the
//   summary's capacities and the candidate leftover;
// - the kernels' instantiations by wave width, and the cluster launch.
// ops/_build.py hashes this header with every source that includes it.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace cg = cooperative_groups;

namespace {

constexpr int kBins = 128;
constexpr int kBig = 1 << 30;
constexpr int kMaxLanes = 32;  // ops/assign_scan.py _SHARD_MAX_LANES
constexpr int kMaxWave = 32;   // ops/assign_scan.py _MAX_WAVE (WAVE_WIDTHS' largest)
constexpr int kMaxRows = kMaxWave + 1;  // a uniform wave's w + 1 stream boundaries
constexpr int kMaxBlocks = 16;          // blocks of a cluster (non-portable past 8)
constexpr int kMinChunk = 256;          // a block's nodes, at least (but the last)
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

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

__device__ __forceinline__ int warp_inclusive_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

__device__ __forceinline__ long long warp_inclusive_scan64(long long v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long t = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

__device__ __forceinline__ long long warp_sum64(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Split phases of the cluster barrier. Every thread of the cluster arrives
// once a phase; a wait returns once every thread that has not exited has
// arrived. A kernel arrives (relaxed) at its start and waits before its
// first access to another block's shared memory, so every block has
// started; a block that only writes others' memory in a phase arrives
// (release) and may exit without waiting.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The nodes of a rank's block that one warp walks: block `chunk_index` of
// the cluster owns [chunk_index * chunk, + chunk) (clipped at nl; an index
// below 0 owns none), and its warps split that into consecutive segments
// of whole 32-node steps.
struct Segment {
  int c0, c1;  // the block's chunk
  int s0, s1;  // this warp's segment
};

__device__ __forceinline__ Segment segment_of(int chunk_index, int chunk, int nl) {
  Segment g;
  g.c0 = chunk_index < 0 ? nl : min(chunk_index * chunk, nl);
  g.c1 = chunk_index < 0 ? nl : min(g.c0 + chunk, nl);
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int seg = ((g.c1 - g.c0 + nw - 1) / nw + 31) & ~31;
  g.s0 = min(g.c0 + warp * seg, g.c1);
  g.s1 = min(g.s0 + seg, g.c1);
  return g;
}

// A lane's four bins of one row's merged histograms (rank x's 128 bins at
// hp[x * stride]; global node order is rank-major): the totals over the
// ranks, the earlier ranks' units, the inclusive cumulative sums, and the
// row's total. Loaded by a whole warp.
struct Bins4 {
  int t[4], o[4], cum[4], total;
};

__device__ Bins4 warp_bins(const int* hp, size_t stride, int s, int rank) {
  const int b0 = (threadIdx.x & 31) * 4;
  Bins4 h = {{0, 0, 0, 0}, {0, 0, 0, 0}, {0, 0, 0, 0}, 0};
  for (int x = 0; x < s; ++x) {
    const int* row = hp + (size_t)x * stride + b0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int v = row[i];
      h.t[i] += v;
      if (x < rank) h.o[i] += v;
    }
  }
  const int four = h.t[0] + h.t[1] + h.t[2] + h.t[3];
  const int incl = warp_inclusive_scan(four);
  int cum = incl - four;
#pragma unroll
  for (int i = 0; i < 4; ++i) h.cum[i] = cum += h.t[i];
  h.total = __shfl_sync(kFull, incl, 31);
  return h;
}

// `_hist_select` of one row by one warp from its bins: with `bound` false,
// the threshold of the need `target` (the first bucket whose inclusive sum
// reaches it, the last when none does) and whether the totals cover it;
// with `bound` true, a uniform wave's stream boundary `target` (the
// buckets whose inclusive sum is <= it: 128 past the stream), always
// covered. rem is the target less the units below the threshold bucket and
// the earlier ranks' units in it. Every lane returns the same values.
struct Plan {
  int thresh, rem, ok;
};

__device__ Plan warp_plan(const Bins4& h, int target, bool bound) {
  const int b0 = (threadIdx.x & 31) * 4;
  int n = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) n += bound ? h.cum[i] <= target : h.cum[i] < target;
  n = __reduce_add_sync(kFull, n);
  Plan p;
  p.thresh = bound ? n : min(n, kBins - 1);
  const int tc = min(p.thresh, kBins - 1);
  int below = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) below += b0 + i < tc ? h.t[i] : 0;
  below = __reduce_add_sync(kFull, below);
  const int q = tc & 3;
  const int mine = q == 0 ? h.o[0] : (q == 1 ? h.o[1] : (q == 2 ? h.o[2] : h.o[3]));
  const int off = __shfl_sync(kFull, mine, tc >> 2);
  p.rem = target - below - off;
  p.ok = bound ? 1 : h.total >= target;
  return p;
}

// The threshold-bucket prefix of `rows` <= kR rows in node order over the
// cluster. Row j reads capacities at cap[j * cap_stride] (stride 0: one
// row shared by every j), its threshold thresh[j] and clip clip[j]. On
// return wsum[warp * kMaxRows + j] is, for each warp of this block, the sum
// of min(cap, clip[j]) over the rank's nodes before the warp's segment
// whose bucket min(cap, 127) is thresh[j]. Each block pushes its partials into the later
// blocks' `slots` ([kMaxBlocks, kMaxRows]) after the wait of the phase the
// kernel arrived at on its start, runs `push()` (the caller's own stores
// into other blocks, if any), then one barrier phase: no block reads
// another's memory. Every thread of every block calls it; `wsum` is
// [kMaxWarps, kMaxRows] and `part` [kMaxRows] of this block.
template <int kR, class Push>
__device__ void bucket_carries(cg::cluster_group& cluster, const int* cap, size_t cap_stride,
                               int rows, const int* thresh, const int* clip, const Segment& g,
                               int* part, int* wsum, int* slots, Push push) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int me = (int)cluster.block_rank(), blocks = (int)cluster.num_blocks();
  int sum[kR];
#pragma unroll
  for (int j = 0; j < kR; ++j) sum[j] = 0;
  for (int n = g.s0 + lane; n < g.s1; n += 32) {
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      if (j < rows) {
        const int v = cap[(size_t)j * cap_stride + n];
        if (min(v, kBins - 1) == thresh[j]) sum[j] += min(v, clip[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kR; ++j) {
    if (j < rows) {
      const int t = __reduce_add_sync(kFull, sum[j]);
      if (lane == 0) wsum[warp * kMaxRows + j] = t;
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < rows; j += blockDim.x) {
    int acc = 0;
    for (int x = 0; x < nw; ++x) {
      const int v = wsum[x * kMaxRows + j];
      wsum[x * kMaxRows + j] = acc;
      acc += v;
    }
    part[j] = acc;
  }
  __syncthreads();
  cluster_wait();  // every block has started
  for (int i = threadIdx.x; i < rows * (blocks - me - 1); i += blockDim.x) {
    const int c = me + 1 + i / rows, j = i - (c - me - 1) * rows;
    *cluster.map_shared_rank(slots + me * kMaxRows + j, c) = part[j];
  }
  push();
  cluster_arrive();
  cluster_wait();  // the earlier blocks' partials are in this block's slots
  for (int j = threadIdx.x; j < rows; j += blockDim.x) {
    int off = 0;
    for (int b = 0; b < me; ++b) off += slots[b * kMaxRows + j];
    for (int x = 0; x < nw; ++x) wsum[x * kMaxRows + j] += off;
  }
  __syncthreads();
}

// One warp step of a row's take (every lane calls it, `v` the capacity of
// its node or 0 past the segment): the tightest-first take of
// `_hist_select` under threshold th and remainder rem, min(cap, clip) below
// the threshold bucket, the rest of the remainder in node order at it,
// none above; zero when !ok. Advances the warp's carry (every lane's copy).
__device__ __forceinline__ int row_take(int v, int th, int rem, int clip, int ok, int& carry) {
  const int key = min(v, kBins - 1), capc = min(v, clip);
  const int x = key == th ? capc : 0;
  const int incl = warp_inclusive_scan(x);
  const int prefix = carry + incl - x;
  carry += __shfl_sync(kFull, incl, 31);
  const int take = key < th ? capc : (key == th ? min(max(rem - prefix, 0), capc) : 0);
  return ok ? take : 0;
}

// a speculative wave's commit at node n from the wave's takes[j] there
// and the summary's capacities cap[j] (w <= kW gangs): each gang's capacity
// under the exclusive prefix of the earlier gangs' takes (clamped at
// -2^30) against its summary capacity (returns whether one differs), and
// the candidate leftover. Until a gang takes from the node its leftover is
// the summary's, up to the clamp, which changes no capacity: nothing to
// check before the first gang that takes, and where none does the leftover
// out is the clamped one. After it the leftover only shrinks, so a
// capacity differs exactly when it drops below the summary's: when some
// requested lane holds less than cap * request (no division).
template <int kW>
__device__ __forceinline__ bool speculative_commit(int n, const int (&cap)[kW],
                                                   const int (&takes)[kW], const int* left,
                                                   const int* req, const uint8_t* mask,
                                                   int mask_stride, int* left_out, int r, int w) {
  int first = kW;
#pragma unroll
  for (int j = kW - 1; j >= 0; --j)
    if (j < w && takes[j] != 0) first = j;
  const int* ln = left + (size_t)n * r;
  int* out = left_out + (size_t)n * r;
  if (first == kW) {
    for (int x = 0; x < r; ++x) out[x] = max(ln[x], -kBig);
    return false;
  }
  int acc[kMaxLanes];
  for (int x = 0; x < r; ++x) acc[x] = max(ln[x], -kBig);
  bool conflict = false;
#pragma unroll
  for (int j = 0; j < kW; ++j) {
    if (j >= first && j < w) {
      const int* q = req + (size_t)j * r;
      if (j > first && mask[(size_t)j * mask_stride + n]) {
        for (int x = 0; x < r; ++x) {
          const int d = min(q[x], kBig);
          conflict |= q[x] > 0 && (long long)min(max(acc[x], 0), kBig) < (long long)cap[j] * d;
        }
      }
      if (takes[j] != 0)
        for (int x = 0; x < r; ++x) acc[x] = max(acc[x] - takes[j] * q[x], -kBig);
    }
  }
  for (int x = 0; x < r; ++x) out[x] = acc[x];
  return conflict;
}

// the kernels' instantiations by the most gangs a wave: 8, 16 or 32
inline int wave_bucket(int w) { return w <= 8 ? 8 : (w <= 16 ? 16 : kMaxWave); }

// The cluster split of nl nodes: `blocks` chunks of `chunk` nodes (at least
// kMinChunk a block, at most kMaxBlocks blocks), `threads` a block (512 once
// a block holds 4096 nodes or more, else 256).
struct Split {
  int blocks, chunk, threads;
};

inline Split split_nodes(int nl, int max_blocks) {
  Split sp;
  sp.blocks = max(1, min(max_blocks, (nl + kMinChunk - 1) / kMinChunk));
  sp.chunk = (nl + sp.blocks - 1) / sp.blocks;
  sp.threads = sp.chunk >= 4096 ? kMaxThreads : 256;
  return sp;
}

// `kernel` on a grid of `rows` clusters of `blocks` blocks (x: the block in
// its cluster, y: the row), `threads` a block, on `stream`
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), int blocks, int rows, int threads,
                            cudaStream_t stream, Args&&... args) {
  cudaError_t e = cudaFuncSetAttribute((const void*)kernel,
                                       cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = blocks;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, rows);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace
