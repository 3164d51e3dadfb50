// batch_tail.cu — the tail of one oracle batch, hand-written for Hopper
// (sm_90a): the compact top-K readback of the [G, N] assignment and the
// whole host blob, in one launch on the caller's stream.
//
// Replaces: no Pallas kernel. Its reference is XLA-fused code inside the
// jit'd batch program: batch_scheduler_tpu/ops/oracle.py `schedule_batch`'s
// `jax.lax.top_k(assignment, k)` (:2203) and the `node << 16 | count` pack,
// `find_max_group` (:270) and `_batch_blob_impl`'s concatenation (:2247).
// Plain versions: batch_scheduler_tpu_torch/ops/oracle.py
// `_top_k_ties_by_index`, the pack, `find_max_group` and the blob's
// `torch.cat`, chained by ops/batch_kernels.py `batch_tail_plain`.
//
// What it computes:
// - per gang row g of the non-negative int32 assignment, the k = min(top_k,
//   N) largest counts with ties in ascending node order (lax.top_k's
//   order, which the decode and the coalescer's demux depend on): the
//   nodes and counts [G, k], and, when asked, the packed
//   node << 16 | min(count, 65535);
// - placed & group_valid;
// - with the blob: placed, gang_feasible, findMaxPG's progress, the best
//   group (the first maximum of its key) and whether it exists, and the
//   stats ints of the wavefront and top-K rungs, in `_batch_blob`'s layout
//   (its nodes, counts or packed tail are the [G, k] outputs above, which
//   the caller points into the blob).
//
// Layout: one block of 256 threads a gang row, plus one block (index G)
// for the O(G) part. A row block walks its row once in tiles of 1,024
// consecutive entries (4 a thread), an ordered block scan a tile, and
// collects into shared memory the entries above a threshold T (at most k,
// any count past k stops the walk) and the first entries equal to T, both
// in ascending node order. The first walk takes T = 0: a row has at most
// `remaining[g]` nonzero takes, so when they are at most k they are the
// row's head and its first k - P zero entries the tail. A row with more
// than k nonzero takes (a gang wider than k) finds the k-th largest count
// by a radix select (four passes of 8-bit digits over the row, histograms
// in shared memory) and walks again with that T. The collected entries
// above T are ranked by (count desc, node asc), at most 128 x 128
// comparisons, and the equal ones follow in node order.
//
// What bounds it on an H100: the [G, N] read of the assignment (32 MiB at
// the north star, 2.1 GB at XL) over the memory rate; a row wider than k
// reads its row five more times.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
constexpr int kMaxK = 128;  // ops/oracle.py ASSIGNMENT_TOP_K
constexpr unsigned kFull = 0xffffffffu;

struct TailArgs {
  const int* assignment;      // [g, n], non-negative
  const uint8_t* placed;      // [g]
  const uint8_t* valid;       // [g]
  const uint8_t* feasible;    // [g] (with the blob)
  const int* min_member;      // [g] (with the blob)
  const int* scheduled;
  const int* matched;
  const uint8_t* ineligible;
  const int* creation_rank;
  const uint8_t* conflicts;   // [steps] or null (no stats)
  const uint8_t* megas;       // [steps]
  const int* demotions;       // [steps] or null (not the top-K rung)
  uint8_t* placed_out;        // [g]
  int* nodes;                 // [g, k]
  int* counts;                // [g, k]
  int* packed;                // [g, k] or null
  int* blob;                  // the blob's head [3g + 2] or null
  int* stats_out;             // 3 or 4 ints or null
  int g, n, k, steps;
};

__device__ __forceinline__ int warp_inclusive_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// The exclusive prefix of v over the block in thread order, and the
// block's total; every thread of the block calls it.
__device__ __forceinline__ int block_exclusive(int v, int* s_warp, int* s_total, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int inc = warp_inclusive_scan(v);
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kWarps ? s_warp[lane] : 0;
    const int wi = warp_inclusive_scan(w);
    if (lane < kWarps) s_warp[lane] = wi - w;
    if (lane == kWarps - 1) *s_total = wi;
  }
  __syncthreads();
  const int excl = s_warp[warp] + inc - v;
  *total = *s_total;
  __syncthreads();  // s_warp and s_total are reused by the next call
  return excl;
}

// One ordered walk of `row` (n entries): the entries above t into (s_gv,
// s_gi) at their order among those (while below kMaxK), the first
// `need_eq` entries equal to t into s_ei. Returns the count of entries
// above t, or a count past k as soon as the walk has seen that many when
// `stop_past_k`.
__device__ int collect(const int* row, int n, int t, int need_eq, int k, bool stop_past_k,
                       int* s_gv, int* s_gi, int* s_ei, int* s_warp, int* s_total) {
  int base_gt = 0, base_eq = 0;
  for (int tile = 0; tile < n; tile += kTile) {
    const int first = tile + threadIdx.x * kItems;
    int v[kItems];
    int gt = 0, eq = 0;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int idx = first + i;
      v[i] = idx < n ? row[idx] : INT_MIN;
      gt += v[i] > t;
      eq += v[i] == t;
    }
    int total;
    const int excl = block_exclusive(gt | (eq << 16), s_warp, s_total, &total);
    int og = base_gt + (excl & 0xffff), oe = base_eq + (excl >> 16);
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (v[i] > t) {
        if (og < kMaxK) {
          s_gv[og] = v[i];
          s_gi[og] = first + i;
        }
        ++og;
      } else if (v[i] == t) {
        if (oe < need_eq) s_ei[oe] = first + i;
        ++oe;
      }
    }
    base_gt += total & 0xffff;
    base_eq += total >> 16;
    if (stop_past_k && base_gt > k) break;  // uniform: every thread has the same totals
  }
  __syncthreads();
  return base_gt;
}

__device__ __forceinline__ int floor_div(int a, int b) {  // b >= 1
  int q = a / b;
  if ((a % b != 0) && (a < 0)) --q;
  return q;
}

__device__ void row_block(const TailArgs& a, int g) {
  __shared__ int s_gv[kMaxK], s_gi[kMaxK], s_ei[kMaxK];
  __shared__ int s_warp[kWarps], s_total;
  __shared__ int s_hist[256];
  __shared__ int s_sel[2];
  const int* row = a.assignment + (size_t)g * a.n;
  const int k = a.k;
  int t = 0;
  int gt = collect(row, a.n, 0, k, k, true, s_gv, s_gi, s_ei, s_warp, &s_total);
  int need_eq = k - gt;
  if (gt > k) {
    // more than k nonzero takes: the k-th largest count by radix select
    unsigned prefix = 0, hi = 0;
    int kk = k;
    for (int shift = 24; shift >= 0; shift -= 8) {
      for (int b = threadIdx.x; b < 256; b += kThreads) s_hist[b] = 0;
      __syncthreads();
      for (int idx = threadIdx.x; idx < a.n; idx += kThreads) {
        const unsigned v = (unsigned)row[idx];
        if ((v & hi) == prefix) atomicAdd(&s_hist[(v >> shift) & 255u], 1);
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        int cum = 0, b = 255;
        for (; b > 0; --b) {
          if (cum + s_hist[b] >= kk) break;
          cum += s_hist[b];
        }
        s_sel[0] = b;
        s_sel[1] = cum;
      }
      __syncthreads();
      prefix |= (unsigned)s_sel[0] << shift;
      hi |= 255u << shift;
      kk -= s_sel[1];
      __syncthreads();  // s_sel and s_hist are rewritten by the next pass
    }
    t = (int)prefix;
    need_eq = kk;
    gt = collect(row, a.n, t, need_eq, k, false, s_gv, s_gi, s_ei, s_warp, &s_total);
  }
  int* nodes = a.nodes + (size_t)g * k;
  int* counts = a.counts + (size_t)g * k;
  int* packed = a.packed != nullptr ? a.packed + (size_t)g * k : nullptr;
  for (int i = threadIdx.x; i < k; i += kThreads) {
    int slot, node, cnt;
    if (i < gt) {
      // rank by (count desc, node asc); s_gi ascends with the index
      const int v = s_gv[i];
      slot = 0;
      for (int j = 0; j < gt; ++j) slot += (s_gv[j] > v) || (s_gv[j] == v && j < i);
      node = s_gi[i];
      cnt = v;
    } else {
      slot = i;
      node = s_ei[i - gt];
      cnt = t;
    }
    nodes[slot] = node;
    counts[slot] = cnt;
    if (packed != nullptr)
      packed[slot] = (int)(((unsigned)node << 16) + (unsigned)min(cnt, 65535));
  }
}

__device__ void vector_block(const TailArgs& a) {
  __shared__ int s_key[kWarps], s_idx[kWarps];
  __shared__ int s_stat[4];
  const int g = a.g;
  int best_key = INT_MIN, best_idx = INT_MAX;
  for (int i = threadIdx.x; i < g; i += kThreads) {
    const uint8_t p = (uint8_t)(a.placed[i] != 0 && a.valid[i] != 0);
    a.placed_out[i] = p;
    if (a.blob == nullptr) continue;
    a.blob[i] = p;
    a.blob[g + i] = a.feasible[i] != 0;
    const int mm = a.min_member[i], sc = a.scheduled[i];
    const bool needs = (int)((unsigned)mm - (unsigned)sc) > 0;
    const int num = (int)(((unsigned)a.matched[i] + (unsigned)sc) * 1000u);
    int progress = needs ? floor_div(num, mm < 1 ? 1 : mm) : 0;
    progress = progress < 0 ? 0 : (progress > 2047 ? 2047 : progress);
    a.blob[2 * g + i] = progress;
    int key = (int)((unsigned)progress * (unsigned)(2 * g + 2) +
                    (sc == 0 ? (unsigned)(g + 1) : 0u) +
                    ((unsigned)g - (unsigned)a.creation_rank[i]));
    if (a.ineligible[i]) key = -1;
    if (key > best_key) {  // i ascends: the first maximum of this thread's share
      best_key = key;
      best_idx = i;
    }
  }
  if (a.blob == nullptr) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int k2 = __shfl_xor_sync(kFull, best_key, o);
    const int i2 = __shfl_xor_sync(kFull, best_idx, o);
    if (k2 > best_key || (k2 == best_key && i2 < best_idx)) {
      best_key = k2;
      best_idx = i2;
    }
  }
  if (lane == 0) {
    s_key[warp] = best_key;
    s_idx[warp] = best_idx;
  }
  if (threadIdx.x < 4) s_stat[threadIdx.x] = 0;
  __syncthreads();
  if (a.stats_out != nullptr) {
    int c = 0, m = 0, d = 0;
    for (int s = threadIdx.x; s < a.steps; s += kThreads) {
      c += a.conflicts[s] != 0;
      m += a.megas[s] != 0;
      if (a.demotions != nullptr) d += a.demotions[s];
    }
    atomicAdd(&s_stat[1], c);
    atomicAdd(&s_stat[2], m);
    atomicAdd(&s_stat[3], d);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int bk = s_key[0], bi = s_idx[0];
    for (int w = 1; w < kWarps; ++w) {
      if (s_key[w] > bk || (s_key[w] == bk && s_idx[w] < bi)) {
        bk = s_key[w];
        bi = s_idx[w];
      }
    }
    a.blob[3 * g] = bi;
    a.blob[3 * g + 1] = bk >= 0;
    if (a.stats_out != nullptr) {
      a.stats_out[0] = a.steps;
      a.stats_out[1] = s_stat[1];
      a.stats_out[2] = s_stat[2];
      if (a.demotions != nullptr) a.stats_out[3] = s_stat[3];
    }
  }
}

__global__ void __launch_bounds__(kThreads) tail_kernel(TailArgs a) {
  if ((int)blockIdx.x == a.g) {
    vector_block(a);
  } else {
    row_block(a, blockIdx.x);
  }
}

}  // namespace

extern "C" {

const char* bst_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// One launch of the tail. With `blob` null the blob's pointers are
// ignored (schedule_batch's compaction alone). Returns a CUDA error code.
int bst_batch_tail(const int* assignment, const uint8_t* placed, const uint8_t* valid,
                   const uint8_t* feasible, const int* min_member, const int* scheduled,
                   const int* matched, const uint8_t* ineligible, const int* creation_rank,
                   const uint8_t* conflicts, const uint8_t* megas, const int* demotions,
                   uint8_t* placed_out, int* nodes, int* counts, int* packed, int* blob,
                   int* stats_out, int g, int n, int k, int steps, void* stream) {
  if (g < 1 || n < 1 || k < 1 || k > kMaxK || k > n || steps < 0)
    return (int)cudaErrorInvalidValue;
  if (blob != nullptr && (feasible == nullptr || min_member == nullptr || scheduled == nullptr ||
                          matched == nullptr || ineligible == nullptr ||
                          creation_rank == nullptr))
    return (int)cudaErrorInvalidValue;
  if (stats_out != nullptr && (blob == nullptr || conflicts == nullptr || megas == nullptr))
    return (int)cudaErrorInvalidValue;
  TailArgs a = {assignment, placed, valid, feasible, min_member, scheduled, matched,
                ineligible, creation_rank, conflicts, megas, demotions, placed_out, nodes,
                counts, packed, blob, stats_out, g, n, k, steps};
  tail_kernel<<<g + 1, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
