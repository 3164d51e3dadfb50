// batch_head.cu — the head of one oracle batch, hand-written for Hopper
// (sm_90a): the leftover, the member-capacity matrix, the policy's
// anti-affinity fold, the per-gang feasibility and the Score ranks, in one
// launch on the caller's stream.
//
// Replaces: no Pallas kernel. Its reference is XLA-fused code inside the
// jit'd batch program: batch_scheduler_tpu/ops/oracle.py `schedule_batch`
// (:2091-2102), i.e. `left_resources`, `group_capacity`, policy/terms.py
// `compose_keep_dense`, `gang_feasible` and `score_nodes`. Plain versions:
// the same functions in batch_scheduler_tpu_torch/ops/oracle.py and
// policy/terms.py, chained by ops/batch_kernels.py `batch_head_plain`.
//
// What it computes, for gang rows g < gv and node columns j < nv of the
// output block (node n = n_lo + j):
//   left[n, r]  = alloc[n, r] - requested[n, r]            (all n_total rows)
//   cap[g, j]   = mask[g|0, j] * min over lanes with req[g, r] > 0 of
//                 floor(clamp(left, 0, 2^30) / clamp(req, 1, 2^30))
//                 (2^30 when the row requests nothing), times
//                 keep = !(anti[g] > 0 && any_h node_hash[n, h] == anti[g])
//                 when the anti-affinity term is on
//   score[g, j] = cap > 0 ? 2^30 - cap : -2^30
//   feasible[g] = sum_j min(cap, remaining[g]) >= remaining[g] && valid[g]
// Rows past gv and columns past nv of a [gb, nb] block are written 0 (the
// replicated mesh rung's zero-padded blocks). Which outputs it writes
// follows from the pointers the caller passes: `left_out` alone (a mesh
// follower's leftover), `cap_out` without scores (a rank's capacity
// block), everything (the whole batch), or `cap_in` given (the finish on
// a gathered matrix: scores and feasibility only).
//
// Divisions: the multiply-shift numbers of ops/assign_scan.py
// `division_magic`, computed here per gang and lane from the request row
// staged in shared memory (exact for every numerator in [0, 2^30]).
//
// The feasibility sum accumulates in int64 (it reaches 2^39 at 2^21 nodes
// and a 2^18-member gang): each thread's partial, a warp and then a block
// reduction, and across the node chunks of a row one thread-block cluster
// (up to 8 blocks along the node axis) whose first block reads the others'
// partials from their shared memory.
//
// Layout: a grid of (C node chunks, rows of GB gangs), the C chunk blocks
// of a row one cluster, 256 threads a block; a thread walks its chunk's
// nodes with a stride of 256 (coalesced loads of each lane and of the mask
// bytes, coalesced stores of cap and scores), loads a node's leftover lanes
// once and divides them for the block's GB gangs (1, 4 or 8 by G), kept in
// registers. `left` is read from alloc and requested directly (the leftover
// the same launch writes is not visible to other blocks), both L2-resident
// at the batch's sizes (160 KB at the north star, 3 MB at XL).
//
// What bounds it on an H100: the [G, N] writes (cap and scores, 64 MiB at
// the north star, 4.3 GB at XL) over the memory rate.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBig = 1 << 30;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLanes = 32;
constexpr int kMaxHash = 8;
constexpr int kMaxCluster = 8;
constexpr int kMinChunk = 2048;  // nodes a block, at least, before a row splits
constexpr unsigned kFull = 0xffffffffu;

struct HeadArgs {
  const int* alloc;          // [n_total, r]
  const int* requested;      // [n_total, r]
  const int* req;            // [gv, r]
  const int* remaining;      // [gv]
  const uint8_t* mask;       // row g at mask + g * mask_stride, node j at + j
  const uint8_t* valid;      // [gv]
  const int* anti;           // [gv] or null (the anti-affinity term off)
  const int* node_hash;      // [n_total, h] or null
  const int* cap_in;         // [gv, nb] or null (finish)
  int* left_out;             // [n_total, r] or null
  int* cap_out;              // [gb, nb] or null
  int* scores_out;           // [gb, nb] or null
  uint8_t* feasible_out;     // [gv] or null
  int n_total, r, h, n_lo, nv, gv, gb, nb, mask_stride, chunk;
};

__device__ __forceinline__ int magic_div(int v, unsigned m, int l) {
  return l == 0 ? v : (int)(__umulhi((unsigned)v, m) >> (l - 1));
}

template <int GB>
__global__ void __launch_bounds__(kThreads) head_kernel(HeadArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ int s_req[GB][kMaxLanes];
  __shared__ unsigned s_magic[GB][kMaxLanes];
  __shared__ int s_shift[GB][kMaxLanes];
  __shared__ int s_anti[GB];
  __shared__ int s_rem[GB];
  __shared__ long long s_warp[kWarps][GB];
  __shared__ long long s_part[GB];

  const int tid = threadIdx.x;
  const int c = blockIdx.x;  // the node chunk (this block's rank in the cluster)
  const int g0 = blockIdx.y * GB;

  if (a.left_out != nullptr) {
    const long long total = (long long)a.n_total * a.r;
    const long long step = (long long)gridDim.x * gridDim.y * kThreads;
    for (long long i = ((long long)blockIdx.y * gridDim.x + c) * kThreads + tid; i < total;
         i += step)
      a.left_out[i] = a.alloc[i] - a.requested[i];
  }
  const bool rows = a.cap_in != nullptr || a.cap_out != nullptr || a.scores_out != nullptr ||
                    a.feasible_out != nullptr;
  if (!rows) return;  // the leftover alone: no cluster exchange follows

  for (int i = tid; i < GB * kMaxLanes; i += kThreads) {
    const int b = i / kMaxLanes, x = i % kMaxLanes, g = g0 + b;
    int q = 0;
    if (g < a.gv && x < a.r && a.cap_in == nullptr) q = a.req[(size_t)g * a.r + x];
    const int d = q < 1 ? 1 : (q > kBig ? kBig : q);
    const int l = d > 1 ? 32 - __clz(d - 1) : 0;
    s_req[b][x] = q;
    s_shift[b][x] = l;
    s_magic[b][x] = (unsigned)((1ull << (31 + l)) / (unsigned long long)d + 1ull);
  }
  if (tid < GB) {
    const int g = g0 + tid;
    s_anti[tid] = (a.anti != nullptr && g < a.gv) ? a.anti[g] : 0;
    s_rem[tid] = (a.feasible_out != nullptr && g < a.gv) ? a.remaining[g] : 0;
  }
  __syncthreads();

  long long acc[GB];
#pragma unroll
  for (int b = 0; b < GB; ++b) acc[b] = 0;

  const int j0 = min(c * a.chunk, a.nb), j1 = min(j0 + a.chunk, a.nb);
  for (int j = j0 + tid; j < j1; j += kThreads) {
    int cap[GB];
    const bool live = j < a.nv;
    if (a.cap_in != nullptr) {
#pragma unroll
      for (int b = 0; b < GB; ++b) {
        const int g = g0 + b;
        cap[b] = (live && g < a.gv) ? a.cap_in[(size_t)g * a.nb + j] : 0;
      }
    } else {
#pragma unroll
      for (int b = 0; b < GB; ++b) cap[b] = kBig;
      if (live) {
        const size_t n = (size_t)(a.n_lo + j);
        for (int x = 0; x < a.r; ++x) {
          int v = a.alloc[n * a.r + x] - a.requested[n * a.r + x];
          v = v < 0 ? 0 : (v > kBig ? kBig : v);
#pragma unroll
          for (int b = 0; b < GB; ++b) {
            if (s_req[b][x] > 0) cap[b] = min(cap[b], magic_div(v, s_magic[b][x], s_shift[b][x]));
          }
        }
        int hash[kMaxHash];
        if (a.node_hash != nullptr) {
#pragma unroll
          for (int x = 0; x < kMaxHash; ++x) hash[x] = x < a.h ? a.node_hash[n * a.h + x] : 0;
        }
#pragma unroll
        for (int b = 0; b < GB; ++b) {
          const int g = g0 + b;
          if (g >= a.gv) {
            cap[b] = 0;
            continue;
          }
          if (!a.mask[(size_t)g * a.mask_stride + j]) cap[b] = 0;
          if (a.node_hash != nullptr && s_anti[b] > 0) {
            bool hit = false;
#pragma unroll
            for (int x = 0; x < kMaxHash; ++x) hit |= (x < a.h) && hash[x] == s_anti[b];
            if (hit) cap[b] = 0;
          }
        }
      } else {
#pragma unroll
        for (int b = 0; b < GB; ++b) cap[b] = 0;
      }
    }
#pragma unroll
    for (int b = 0; b < GB; ++b) {
      const int g = g0 + b;
      if (g >= a.gb) continue;
      const size_t o = (size_t)g * a.nb + j;
      if (a.cap_out != nullptr) a.cap_out[o] = cap[b];
      if (a.scores_out != nullptr) a.scores_out[o] = cap[b] > 0 ? kBig - cap[b] : -kBig;
      if (live) acc[b] += (long long)min(cap[b], s_rem[b]);
    }
  }

  if (a.feasible_out == nullptr) return;  // no exchange: every block of the cluster returns here
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int b = 0; b < GB; ++b) {
    long long v = acc[b];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    if (lane == 0) s_warp[warp][b] = v;
  }
  __syncthreads();
  if (tid < GB) {
    long long v = 0;
    for (int w = 0; w < kWarps; ++w) v += s_warp[w][tid];
    s_part[tid] = v;
  }
  cluster.sync();  // every block's partials are in its shared memory
  if (c == 0 && tid < GB) {
    const int g = g0 + tid;
    if (g < a.gv) {
      long long total = 0;
      for (int k = 0; k < (int)cluster.num_blocks(); ++k)
        total += *cluster.map_shared_rank(&s_part[tid], k);
      a.feasible_out[g] = (uint8_t)(total >= (long long)s_rem[tid] && a.valid[g] != 0);
    }
  }
  cluster.sync();  // no block leaves while the first still reads its partials
}

template <int GB>
cudaError_t launch(const HeadArgs& a, int blocks, int rows, cudaStream_t stream) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = blocks;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, rows);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, head_kernel<GB>, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* bst_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// One launch of the head. Pointers the mode does not use are null (see
// the header). Returns a CUDA error code.
int bst_batch_head(const int* alloc, const int* requested, const int* req, const int* remaining,
                   const uint8_t* mask, const uint8_t* valid, const int* anti,
                   const int* node_hash, const int* cap_in, int* left_out, int* cap_out,
                   int* scores_out, uint8_t* feasible_out, int n_total, int r, int h, int n_lo,
                   int nv, int gv, int gb, int nb, int mask_stride, void* stream) {
  const bool rows = cap_in != nullptr || cap_out != nullptr || scores_out != nullptr ||
                    feasible_out != nullptr;
  if (r < 1 || r > kMaxLanes || n_total < 0 || h < 0 || h > kMaxHash || gv < 0 || gb < gv ||
      nb < nv || nv < 0 || n_lo < 0)
    return (int)cudaErrorInvalidValue;
  // a finish reads the gathered matrix, not the lanes
  if (rows && cap_in == nullptr && (n_lo + nv > n_total || mask == nullptr))
    return (int)cudaErrorInvalidValue;
  if (feasible_out != nullptr && (remaining == nullptr || valid == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((node_hash != nullptr) != (anti != nullptr)) return (int)cudaErrorInvalidValue;
  HeadArgs a = {alloc, requested, req, remaining, mask, valid, anti, node_hash, cap_in,
                left_out, cap_out, scores_out, feasible_out, n_total, r, h, n_lo, nv, gv, gb,
                nb, mask_stride, 0};
  const int gb_rows = rows ? gb : 0;
  const int width = rows ? nb : 0;
  int blocks = (width + kMinChunk - 1) / kMinChunk;
  blocks = blocks < 1 ? 1 : (blocks > kMaxCluster ? kMaxCluster : blocks);
  a.chunk = width > 0 ? (width + blocks - 1) / blocks : 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (!rows) {
    // the leftover alone: one row of blocks, enough to cover n_total * r
    const long long total = (long long)n_total * r;
    long long want = (total + kThreads - 1) / kThreads;
    if (want < 1) return (int)cudaSuccess;
    const int nblocks = (int)(want < 1024 ? want : 1024);
    return (int)launch<1>(a, 1, nblocks, s);
  }
  if (gb_rows == 0) return (int)cudaSuccess;
  if (gb_rows <= 256) return (int)launch<1>(a, blocks, gb_rows, s);
  if (gb_rows <= 4 * 65535) return (int)launch<4>(a, blocks, (gb_rows + 3) / 4, s);
  return (int)launch<8>(a, blocks, (gb_rows + 7) / 8, s);
}

}  // extern "C"
