// shard_wave.cu — one wave of the node-sharded gang scan on one rank's
// block of the node axis, hand-written for Hopper (sm_90a).
//
// Replaces: no Pallas kernel. Its reference is lax: the body of the
// shard_map in batch_scheduler_tpu/ops/oracle.py `assign_gangs_sharded`
// (:802), with `_hist_select` (:759). Plain versions: ops/oracle.py
// `shard_wave_summary` and `shard_wave_apply`; the collectives between the
// two steps, and the loop over waves, are ops/oracle.py
// `assign_gangs_sharded`'s.
//
// Two entry points, one launch each, on the caller's stream. Both split
// the rank's nl nodes over a thread-block cluster of up to 16 blocks
// (shard_common.cuh `split_nodes`: consecutive chunks of at least 256 nodes
// a block, consecutive segments a warp, 32 consecutive nodes a warp step,
// so every pass over the nodes is coalesced):
// - bst_shard_summary: a cluster a demand row (a wave's W gangs, the one
//   member stream of a uniform wave, or one gang of a replay). Each block
//   computes the member capacity of its nodes under the row's mask row
//   (written to `cap`) and its 128-bin histogram of min(cap, clip) by
//   tightness bucket min(cap, 127) in shared memory, then pushes it into
//   the leader block's shared memory; one barrier phase, which only the
//   leader waits on, and the leader writes the sum into row `rank` of an
//   [S, k, 128] buffer whose other rows it zeroes: the merge is then an
//   all-reduce (sum) of that buffer. A sum is the same in any order (int32,
//   wraparound included).
// - bst_shard_apply: one cluster. Every block derives, one warp a row, each
//   row's threshold bucket and remainder from the merged buffer as
//   `_hist_select` does (a speculative or replayed gang's need, or each of
//   a uniform wave's W + 1 stream boundaries from one load of its
//   histogram), this rank's offset in that bucket being the earlier ranks'
//   units (global node order is rank-major). The prefix of the threshold
//   bucket in node order is each warp's carry: the earlier blocks'
//   partials (each block pushes its own into the later blocks' shared
//   memory, one barrier phase), the earlier warps', then a warp scan a
//   step; a uniform wave's boundaries scan once for a run of equal
//   thresholds. Each block then commits its own nodes: the takes, and a
//   speculative wave's conflict check (each gang's capacity under the
//   exclusive prefix of the earlier gangs' takes, clamped at -2^30: only
//   at nodes an earlier gang takes from, and without a division) with its
//   candidate leftover, or a uniform wave's gang takes between boundaries,
//   feasibility sums and leftover, or a replayed gang's leftover. The
//   leader zeroes `verify` before the exchange and every block adds its
//   conflict bit or sums into it after (global atomics): no block waits at
//   the end. The candidate leftover goes to a second buffer: the caller
//   adopts it after the verify reduce, or replays the wave from the first.
//
// What bounds it on an H100: neither bytes nor operations. A wave moves a
// few passes over the block (nl = N / S nodes: 4096 at the north star on
// two ranks, ~0.1 MB of leftover and 4 KB of mask) and does ~W * nl * (2R +
// 10) integer operations: well under a microsecond of memory or ALU time.
// What a step costs is its two launches and their barrier phases (a few
// microseconds each at the north star), the loads each warp keeps in
// flight over up to 16 SMs on the XL block, and the two collectives
// between and after the launches, which go through the host. The design
// spreads every pass over up to 16 SMs a row and keeps no state between
// the launches but `cap` (L2-resident).

#include <cuda_runtime.h>
#include <stdint.h>

#include "shard_common.cuh"

namespace {

constexpr int kSpeculative = 0, kMega = 1, kReplay = 2;  // ops/oracle.py SHARD_*

__global__ void __launch_bounds__(kMaxThreads)
summary_kernel(const int* __restrict__ left, const int* __restrict__ req,
               const int* __restrict__ clip, const uint8_t* __restrict__ mask,
               int* __restrict__ cap, int* __restrict__ hist, int nl, int r, int k,
               int mask_stride, int s, int rank, int chunk) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ int h[kBins];
  __shared__ int h_all[kMaxBlocks * kBins];  // the leader's: every block's histogram
  cluster_arrive_relaxed();
  const int me = (int)cluster.block_rank(), blocks = (int)cluster.num_blocks();
  const int j = blockIdx.y;
  for (int b = threadIdx.x; b < kBins; b += blockDim.x) h[b] = 0;
  __syncthreads();
  const int* q = req + (size_t)j * r;
  const uint8_t* m = mask + (size_t)j * mask_stride;
  const int c = clip[j];
  int* cap_row = cap + (size_t)j * nl;
  const int n0 = min(me * chunk, nl), n1 = min(n0 + chunk, nl);
  for (int n = n0 + threadIdx.x; n < n1; n += blockDim.x) {
    const int v = m[n] ? member_cap(left + (size_t)n * r, q, r) : 0;
    cap_row[n] = v;
    const int capc = min(v, c);
    if (capc > 0) atomicAdd(&h[min(v, kBins - 1)], capc);
  }
  __syncthreads();
  cluster_wait();  // every block has started
  int* lead = cluster.map_shared_rank(h_all + me * kBins, 0);
  for (int b = threadIdx.x; b < kBins; b += blockDim.x) lead[b] = h[b];
  cluster_arrive();
  if (me != 0) return;
  cluster_wait();  // every block's histogram is in the leader's memory
  for (int b = threadIdx.x; b < kBins; b += blockDim.x) {
    int t = 0;
    for (int x = 0; x < blocks; ++x) t += h_all[x * kBins + b];
    for (int x = 0; x < s; ++x) hist[((size_t)x * k + j) * kBins + b] = x == rank ? t : 0;
  }
}

// The apply of a wave of w <= kW gangs.
template <int kW>
__global__ void __launch_bounds__(kMaxThreads)
apply_kernel(int mode, const int* __restrict__ merged, const int* __restrict__ cap,
             const int* __restrict__ needs, const int* __restrict__ left,
             const int* __restrict__ req, const uint8_t* __restrict__ mask, int mask_stride,
             int* __restrict__ takes, uint8_t* __restrict__ feas, int* __restrict__ left_out,
             int* __restrict__ verify, int nl, int r, int w, int s, int rank, int chunk) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ int s_thresh[kMaxRows], s_rem[kMaxRows], s_clip[kMaxRows], s_ok[kMaxRows];
  __shared__ int s_need[kMaxWave];
  __shared__ int s_part[kMaxRows];
  __shared__ int s_wsum[kMaxWarps * kMaxRows];
  __shared__ int s_slots[kMaxBlocks * kMaxRows];  // the earlier blocks' partials
  __shared__ int s_sum[kMaxWave];                 // this block's part of each boundary sum
  cluster_arrive_relaxed();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int me = (int)cluster.block_rank();
  const int k = mode == kSpeculative ? w : 1;
  const int rows = mode == kMega ? w + 1 : w;
  for (int i = threadIdx.x; i < kMaxWave; i += blockDim.x) {
    s_sum[i] = 0;
    s_need[i] = i < w ? needs[i] : 0;
  }
  // each row's threshold, remainder and clip: a gang's (speculative,
  // replay) or a stream boundary's (mega: row j holds the units of the
  // first j gangs' needs, clipped at the wave's total; one histogram)
  if (mode == kMega) {
    if (warp < rows) {
      const Bins4 h = warp_bins(merged, kBins, s, rank);
      int total = 0;
      for (int i = 0; i < w; ++i) total += needs[i];
      for (int j = warp; j < rows; j += nw) {
        int bound = 0;
        for (int i = 0; i < j; ++i) bound += needs[i];
        const Plan p = warp_plan(h, bound, true);
        if (lane == 0) {
          s_thresh[j] = p.thresh;
          s_rem[j] = p.rem;
          s_ok[j] = 1;
          s_clip[j] = total;
        }
      }
    }
  } else {
    for (int j = warp; j < rows; j += nw) {
      const Plan p = warp_plan(warp_bins(merged + (size_t)j * kBins, (size_t)k * kBins, s, rank),
                               needs[j], false);
      if (lane == 0) {
        s_thresh[j] = p.thresh;
        s_rem[j] = p.rem;
        s_ok[j] = p.ok;
        s_clip[j] = needs[j];
      }
    }
  }
  __syncthreads();
  if (me == 0)
    for (int j = threadIdx.x; j < w; j += blockDim.x) feas[j] = (uint8_t)s_ok[j];
  const Segment g = segment_of(me, chunk, nl);
  bucket_carries<kW + 1>(cluster, cap, mode == kMega ? 0 : (size_t)nl, rows, s_thresh, s_clip, g,
                         s_part, s_wsum, s_slots, [&] {
                           // zeroed before the exchange, summed into after it
                           if (me == 0 && mode != kReplay)
                             for (int j = threadIdx.x; j < (mode == kMega ? w : 1);
                                  j += blockDim.x)
                               verify[j] = 0;
                         });
  const int* carries = s_wsum + warp * kMaxRows;  // this warp's, a row each
  bool conflict = false;
  if (mode == kSpeculative) {
    int carry[kW];
#pragma unroll
    for (int j = 0; j < kW; ++j) carry[j] = j < w ? carries[j] : 0;
    for (int base = g.s0; base < g.s1; base += 32) {
      const int n = base + lane;
      const bool valid = n < g.s1;
      int v[kW], t[kW];
#pragma unroll
      for (int j = 0; j < kW; ++j) v[j] = j < w && valid ? cap[(size_t)j * nl + n] : 0;
#pragma unroll
      for (int j = 0; j < kW; ++j)
        t[j] = j < w ? row_take(v[j], s_thresh[j], s_rem[j], s_clip[j], s_ok[j], carry[j]) : 0;
      if (valid) {
#pragma unroll
        for (int j = 0; j < kW; ++j)
          if (j < w) takes[(size_t)j * nl + n] = t[j];
        conflict |= speculative_commit<kW>(n, v, t, left, req, mask, mask_stride, left_out, r, w);
      }
    }
  }
  int fsum[kW];  // a uniform wave's feasibility parts, this lane's nodes
#pragma unroll
  for (int j = 0; j < kW; ++j) fsum[j] = 0;
  if (mode == kMega) {
    // the boundaries' thresholds rise with the boundary: one scan for a
    // run of equal ones (a node's prefix in a bucket is the same for all)
    int carry[kW + 1];
#pragma unroll
    for (int b = 0; b <= kW; ++b) carry[b] = b <= w ? carries[b] : 0;
    for (int base = g.s0; base < g.s1; base += 32) {
      const int n = base + lane;
      const bool valid = n < g.s1;
      const int v = valid ? cap[n] : 0;
      const int key = min(v, kBins - 1), capc = min(v, s_clip[0]);
      int prev = 0, pre = 0;
#pragma unroll
      for (int b = 0; b <= kW; ++b) {
        if (b <= w) {
          const int th = s_thresh[b];
          if (b == 0 || th != s_thresh[b - 1]) {
            const int x = key == th ? capc : 0;
            const int incl = warp_inclusive_scan(x);
            pre = carry[b] + incl - x;
            carry[b] += __shfl_sync(kFull, incl, 31);
          }
          const int t = key < th ? capc : (key == th ? min(max(s_rem[b] - pre, 0), capc) : 0);
          if (b > 0 && valid) {
            takes[(size_t)(b - 1) * nl + n] = t - prev;
            fsum[b - 1] += min(v - prev, s_need[b - 1]);
          }
          prev = t;
        }
      }
      if (valid)
        for (int x = 0; x < r; ++x)
          left_out[(size_t)n * r + x] = left[(size_t)n * r + x] - prev * req[x];
    }
  }
  if (mode == kReplay) {
    int carry = carries[0];
    for (int base = g.s0; base < g.s1; base += 32) {
      const int n = base + lane;
      const bool valid = n < g.s1;
      const int v = valid ? cap[n] : 0;
      const int t = row_take(v, s_thresh[0], s_rem[0], s_clip[0], s_ok[0], carry);
      if (valid) {
        takes[n] = t;
        for (int x = 0; x < r; ++x)
          left_out[(size_t)n * r + x] = left[(size_t)n * r + x] - t * req[x];
      }
    }
  }
  if (mode == kSpeculative) {
    if (__syncthreads_or(conflict) && threadIdx.x == 0) atomicOr(verify, 1);
  } else if (mode == kMega) {
#pragma unroll
    for (int j = 0; j < kW; ++j) {
      if (j < w) {
        const int f = __reduce_add_sync(kFull, fsum[j]);
        if (lane == 0 && f != 0) atomicAdd(&s_sum[j], f);
      }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < w; j += blockDim.x)
      if (s_sum[j] != 0) atomicAdd(verify + j, s_sum[j]);
  }
}

}  // namespace

extern "C" {

const char* bst_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The summary of k rows; hist is [s, k, 128]. Returns a CUDA error code.
int bst_shard_summary(const int* left, const int* req, const int* clip, const uint8_t* mask,
                      int* cap, int* hist, int nl, int r, int k, int mask_stride, int s,
                      int rank, void* stream) {
  if (nl < 1 || r < 1 || r > kMaxLanes || k < 1 || s < 1 || rank < 0 || rank >= s)
    return (int)cudaErrorInvalidValue;
  const Split sp = split_nodes(nl, kMaxBlocks);
  return (int)launch_clusters(summary_kernel, sp.blocks, k, sp.threads, (cudaStream_t)stream,
                              left, req, clip, mask, cap, hist, nl, r, k, mask_stride, s, rank,
                              sp.chunk);
}

// The apply of one wave of w gangs (w = 1 for a replayed gang); merged is
// [s, k, 128] with k = w for the speculative mode, else 1. `verify` is one
// word (speculative), w words (mega) or null (replay). Returns a CUDA
// error code.
int bst_shard_apply(const int* merged, const int* cap, const int* needs, const int* left,
                    const int* req, const uint8_t* mask, int* takes, uint8_t* feas,
                    int* left_out, int* verify, int mode, int nl, int r, int w, int s, int rank,
                    int mask_stride, void* stream) {
  if (mode < kSpeculative || mode > kReplay || nl < 1 || r < 1 || r > kMaxLanes || w < 1 ||
      w > kMaxWave || s < 1 || rank < 0 || rank >= s || (mode == kReplay && w != 1) ||
      ((mode == kReplay) != (verify == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Split sp = split_nodes(nl, kMaxBlocks);
  const int bucket = wave_bucket(w);
  auto* kernel = bucket == 8 ? apply_kernel<8> : (bucket == 16 ? apply_kernel<16>
                                                               : apply_kernel<kMaxWave>);
  return (int)launch_clusters(kernel, sp.blocks, 1, sp.threads, (cudaStream_t)stream, mode,
                              merged, cap, needs, left, req, mask, mask_stride, takes, feas,
                              left_out, verify, nl, r, w, s, rank, sp.chunk);
}

}  // extern "C"
