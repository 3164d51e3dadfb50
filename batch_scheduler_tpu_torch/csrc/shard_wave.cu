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
// Two entry points, each on the caller's stream:
// - bst_shard_summary: for k demand rows (a wave's W gangs, the one member
//   stream of a uniform wave, or one gang of a replay) the member capacity
//   of every node of the block under the row's mask row, and the row's
//   128-bin histogram of min(cap, clip) by tightness bucket min(cap, 127),
//   written into row `rank` of an [S, k, 128] buffer whose other rows it
//   zeroes: the merge is then an all-reduce (sum) of that buffer. One
//   block a row, the histogram in shared memory (int32 atomics: a sum is
//   the same in any order, wraparound included).
// - bst_shard_apply: two kernels. `select_kernel`, one block a row: from
//   the merged buffer the global bucket totals and this rank's offset in
//   each bucket (the earlier ranks' rows: global node order is rank-major),
//   the row's threshold bucket and remainder as `_hist_select` derives them
//   (or, for a uniform wave, each of the W + 1 stream boundaries'), then
//   this rank's slice of the take vector in node order (a block prefix sum
//   over the threshold bucket). `commit_kernel`, one thread a node: the
//   speculative wave's conflict check (each gang's capacity row under the
//   exclusive prefix of the earlier gangs' takes, clamped at -2^30) and its
//   candidate leftover; or the uniform wave's gang takes, boundary
//   feasibility sums and leftover; or a replayed gang's leftover. The
//   candidate leftover goes to a second buffer: the caller adopts it after
//   the verify reduce, or replays the wave from the first.
//
// What bounds it on an H100: neither bytes nor operations. A wave moves a
// few passes over the block (nl = N / S nodes: 4096 at the north star on
// two ranks, ~0.1 MB of leftover and 4 KB of mask) and does ~W * nl * (2R +
// 10) integer operations: well under a microsecond of memory or ALU time.
// What a wave costs is its launches (two here) and the two collectives
// between and after them, which go through the host. The design keeps the
// device part of a wave to those two launches: the plain version is some
// 50-100 small launches a wave.

#include <cuda_runtime.h>
#include <stdint.h>

#include "shard_common.cuh"

namespace {

constexpr int kSummaryThreads = 512;
constexpr int kSpeculative = 0, kMega = 1, kReplay = 2;  // ops/oracle.py SHARD_*

__global__ void summary_kernel(const int* __restrict__ left, const int* __restrict__ req,
                               const int* __restrict__ clip, const uint8_t* __restrict__ mask,
                               int* __restrict__ cap, int* __restrict__ hist, int nl, int r,
                               int k, int mask_stride, int s, int rank) {
  __shared__ int h[kBins];
  const int j = blockIdx.x;
  for (int b = threadIdx.x; b < kBins; b += blockDim.x) h[b] = 0;
  __syncthreads();
  const int* q = req + (size_t)j * r;
  const uint8_t* m = mask + (size_t)j * mask_stride;
  const int c = clip[j];
  int* cap_row = cap + (size_t)j * nl;
  for (int n = threadIdx.x; n < nl; n += blockDim.x) {
    const int v = m[n] ? member_cap(left + (size_t)n * r, q, r) : 0;
    cap_row[n] = v;
    const int capc = min(v, c);
    if (capc > 0) atomicAdd(&h[min(v, kBins - 1)], capc);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < kBins; b += blockDim.x)
    for (int t = 0; t < s; ++t) hist[((size_t)t * k + j) * kBins + b] = t == rank ? h[b] : 0;
}

// One row of takes: a gang's (speculative, replay) or a stream boundary's
// (mega: row j holds the units of the first j gangs' needs).
__global__ void select_kernel(int mode, const int* __restrict__ merged, const int* __restrict__ cap,
                              const int* __restrict__ needs, int* __restrict__ out,
                              uint8_t* __restrict__ feas, int* __restrict__ verify, int nl, int w,
                              int k, int s, int rank) {
  __shared__ int tot[kBins];
  __shared__ int off[kBins];
  __shared__ int warp_tot[32];
  __shared__ int sh_thresh, sh_rem, sh_ok, sh_clip;
  const int row = blockIdx.x;
  const int hrow = mode == kMega ? 0 : row;
  // the commit kernel accumulates into verify after this launch
  if (row == 0 && verify != nullptr && threadIdx.x < (mode == kMega ? w : 1))
    verify[threadIdx.x] = 0;
  merged_buckets(merged + (size_t)hrow * kBins, (size_t)k * kBins, s, rank, tot, off);
  __syncthreads();
  if (threadIdx.x == 0) {
    int thresh, excl = 0, ok = 1, target, clipv;
    if (mode == kMega) {
      int total = 0, bound = 0;
      for (int j = 0; j < w; ++j) {
        total += needs[j];
        if (j < row) bound += needs[j];
      }
      int cum = 0;
      thresh = 0;  // buckets whose inclusive sum is <= the boundary: kBins past the stream
      for (int b = 0; b < kBins; ++b) {
        cum += tot[b];
        thresh += cum <= bound;
      }
      target = bound;
      clipv = total;
      for (int b = 0; b < min(thresh, kBins - 1); ++b) excl += tot[b];
    } else {
      target = clipv = needs[row];
      ok = hist_threshold(tot, target, &thresh, &excl);
      feas[row] = (uint8_t)ok;
    }
    sh_thresh = thresh;
    sh_rem = target - excl - off[min(thresh, kBins - 1)];
    sh_ok = ok;
    sh_clip = clipv;
  }
  __syncthreads();
  const int thresh = sh_thresh, rem = sh_rem, ok = sh_ok, clipv = sh_clip;
  bucket_take(cap + (size_t)(mode == kMega ? 0 : row) * nl, out + (size_t)row * nl, nl, thresh,
              rem, clipv, ok, warp_tot);
}

__global__ void commit_kernel(int mode, const int* __restrict__ cap, const int* __restrict__ needs,
                              const int* __restrict__ left, const int* __restrict__ req,
                              const uint8_t* __restrict__ mask, int mask_stride,
                              const int* __restrict__ taken, int* __restrict__ takes,
                              uint8_t* __restrict__ feas, int* __restrict__ left_out,
                              int* __restrict__ verify, int nl, int r, int w) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (mode == kMega) {
    // the gangs' takes between consecutive boundaries, each gang's part of
    // its boundary feasibility sum, and the leftover after the last one
    __shared__ int part[kMaxWave];
    for (int j = threadIdx.x; j < w; j += blockDim.x) {
      part[j] = 0;
      if (blockIdx.x == 0) feas[j] = 1;
    }
    __syncthreads();
    if (n < nl) {
      const int cap0 = cap[n];
      int a = taken[n];
      for (int j = 0; j < w; ++j) {
        const int b = taken[(size_t)(j + 1) * nl + n];
        takes[(size_t)j * nl + n] = b - a;
        const int f = min(cap0 - a, needs[j]);
        if (f != 0) atomicAdd(&part[j], f);
        a = b;
      }
      for (int x = 0; x < r; ++x)
        left_out[(size_t)n * r + x] = left[(size_t)n * r + x] - a * req[x];
    }
    __syncthreads();
    for (int j = threadIdx.x; j < w; j += blockDim.x)
      if (part[j] != 0) atomicAdd(&verify[j], part[j]);
    return;
  }
  if (n >= nl) return;
  if (mode == kReplay) {
    const int t = taken[n];
    for (int x = 0; x < r; ++x)
      left_out[(size_t)n * r + x] = left[(size_t)n * r + x] - t * req[x];
    return;
  }
  speculative_commit(n, cap, left, req, mask, mask_stride, taken, left_out, verify, nl, r, w);
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
  summary_kernel<<<k, kSummaryThreads, 0, (cudaStream_t)stream>>>(
      left, req, clip, mask, cap, hist, nl, r, k, mask_stride, s, rank);
  return (int)cudaGetLastError();
}

// The apply of one wave of w gangs (w = 1 for a replayed gang); merged is
// [s, k, 128] with k = w for the speculative mode, else 1. `taken` is the
// [w + 1, nl] scratch of the uniform wave's boundaries; `verify` is one word
// (speculative), w words (mega) or null (replay). Returns a CUDA error code.
int bst_shard_apply(const int* merged, const int* cap, const int* needs, const int* left,
                    const int* req, const uint8_t* mask, int* taken, int* takes, uint8_t* feas,
                    int* left_out, int* verify, int mode, int nl, int r, int w, int s, int rank,
                    int mask_stride, void* stream) {
  if (mode < kSpeculative || mode > kReplay || nl < 1 || r < 1 || r > kMaxLanes || w < 1 ||
      w > kMaxWave || s < 1 || rank < 0 || rank >= s || (mode == kReplay && w != 1) ||
      ((mode == kReplay) != (verify == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int k = mode == kSpeculative ? w : 1;
  const int rows = mode == kMega ? w + 1 : w;
  int* sel = mode == kMega ? taken : takes;
  select_kernel<<<rows, kThreads, 0, st>>>(mode, merged, cap, needs, sel, feas, verify, nl,
                                                 w, k, s, rank);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  commit_kernel<<<(nl + kNodeThreads - 1) / kNodeThreads, kNodeThreads, 0, st>>>(
      mode, cap, needs, left, req, mask, mask_stride, sel, takes, feas, left_out, verify, nl, r, w);
  return (int)cudaGetLastError();
}

}  // extern "C"
