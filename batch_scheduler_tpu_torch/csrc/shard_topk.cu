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
// Two entry points, each on the caller's stream:
// - bst_shard_topk_summary: one block a demand row (a speculative wave's W
//   gangs, a uniform wave's one stream row, one replayed gang). The block
//   computes the member capacity of every node of the rank's block under
//   the row's mask (written to `cap`), a 128-bin count histogram of the
//   tightness key min(cap, 127) over the fitting nodes in shared memory,
//   the bin where the count reaches kk_l, and the candidates: every
//   fitting node below that bin and the first ones of that bin by index (a
//   block prefix sum over each thread's consecutive nodes), sorted by the
//   global composite key*(n_pad+1) + global index (a rank sort of at most
//   128 keys). Its payload row (ops/oracle.py's comment above
//   TOPK_SPECULATIVE gives the columns) goes into slot `rank` of an
//   [S, rows, P] buffer whose other slots it zeroes, so the merge is an
//   all-reduce (sum).
// - bst_shard_topk_apply: two kernels. `select_kernel`, one block a row:
//   the kk smallest of the S * kk_l merged composites (a stable rank sort:
//   the lower position first on equal keys, as lax.top_k), decoded into
//   key, global index and ownership; then the replicated selection on them
//   — the tightest-first take of `_select_best_fit` (one thread over the
//   at most 128 candidates), a uniform wave's stream cut at its gang
//   boundaries with their feasibility sums, or a replayed gang's
//   dense-column take from the merged histograms — and this rank's takes
//   written into rows zeroed first. `commit_kernel`, one thread a node: a
//   speculative wave's conflict check (each gang's capacity under the
//   exclusive prefix of the earlier gangs' takes, clamped at -2^30; off the
//   candidates every take is zero, so checking every node checks the
//   reference's union of candidate columns) and its candidate leftover, or
//   a stream's or replayed gang's leftover. The candidate leftover goes to
//   a second buffer, which the caller adopts after the verify.
//
// What bounds it on an H100: neither bytes nor operations. A wave reads the
// block's leftover once or twice (nl = N / S nodes) and does ~W * nl * (2R +
// 10) integer operations, well under a microsecond of memory or ALU time at
// the north star. What a wave costs is its three launches and the one or
// two collectives between them, which go through the host.

#include <cuda_runtime.h>
#include <stdint.h>

#include "shard_common.cuh"

namespace {

constexpr int kMaxK = 128;      // ops/assign_scan.py _MAX_TOPK
constexpr int kMaxPool = 1024;  // ops/assign_scan.py _SHARD_TOPK_POOL
constexpr int kSpeculative = 0, kMega = 1, kReplay = 2;  // ops/oracle.py TOPK_*

__device__ __forceinline__ long long warp_sum(long long v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__global__ void summary_kernel(int mode, const int* __restrict__ left, const int* __restrict__ req,
                               const int* __restrict__ needs, const uint8_t* __restrict__ mask,
                               int* __restrict__ cap, int* __restrict__ buf, int nl, int r, int w,
                               int rows, int mask_stride, int s, int rank, int kk_l) {
  __shared__ int cnt[kBins];
  __shared__ int hist[kBins];
  __shared__ unsigned long long pool[kMaxWave];
  __shared__ int warp_tot[32];
  __shared__ long long cand_v[kMaxK];
  __shared__ int cand_c[kMaxK];
  __shared__ long long sort_v[kMaxK];
  __shared__ int sort_c[kMaxK];
  __shared__ int sh_tb, sh_lt, sh_want, sh_ncand;
  const int row = blockIdx.x;
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
  __syncthreads();
  const int per = (nl + blockDim.x - 1) / blockDim.x;
  const int n0 = min((int)threadIdx.x * per, nl), n1 = min(n0 + per, nl);
  long long mine = 0;  // saturated at the clip: only pooled < need is read
  for (int n = n0; n < n1; ++n) {
    const int v = m[n] ? member_cap(left + (size_t)n * r, q, r) : 0;
    cap_row[n] = v;
    if (v > 0) atomicAdd(&cnt[min(v, kBins - 1)], 1);
    if (mode != kMega) {
      const long long c = min((long long)v, clip);
      if (c > 0) {
        mine = min(mine + c, clip);
        if (mode == kReplay) atomicAdd(&hist[min(v, kBins - 1)], (int)c);
      }
    }
  }
  if (mode == kMega) {
    // each gang's pooled need: exact in int32 inside the stream bound
    for (int j = 0; j < w; ++j) {
      long long part = 0;
      for (int n = n0; n < n1; ++n) part += min(cap_row[n], needs[j]);
      part = warp_sum(part);
      if ((threadIdx.x & 31) == 0 && part != 0) atomicAdd(&pool[j], (unsigned long long)part);
    }
  } else {
    for (int o = 16; o > 0; o >>= 1) mine = min(mine + __shfl_down_sync(0xffffffffu, mine, o), clip);
    if ((threadIdx.x & 31) == 0 && mine != 0) atomicAdd(&pool[0], (unsigned long long)mine);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // the bin where the fitting count reaches kk_l (kBins: every fitting node)
    int cum = 0, tb = kBins;
    for (int b = 1; b < kBins; ++b) {
      if (cum + cnt[b] >= kk_l) {
        tb = b;
        break;
      }
      cum += cnt[b];
    }
    sh_tb = tb;
    sh_lt = cum;
    sh_want = tb < kBins ? kk_l - cum : 0;
    sh_ncand = tb < kBins ? kk_l : cum;
    if (mode != kMega) pool[0] = min((long long)pool[0], clip);
  }
  __syncthreads();
  const int tb = sh_tb, lt = sh_lt, want = sh_want;
  int a = 0, b = 0;
  for (int n = n0; n < n1; ++n) {
    const int v = cap_row[n];
    if (v <= 0) continue;
    const int key = min(v, kBins - 1);
    a += key < tb;
    b += key == tb;
  }
  int pa = block_exclusive_scan(a, warp_tot);
  int pb = block_exclusive_scan(b, warp_tot);
  const long long span = (long long)s * nl + 1;
  const long long off = (long long)rank * nl;
  for (int n = n0; n < n1; ++n) {
    const int v = cap_row[n];
    if (v <= 0) continue;
    const int key = min(v, kBins - 1);
    int slot = -1;
    if (key < tb) {
      slot = pa++;
    } else if (key == tb) {
      if (pb < want) slot = lt + pb;
      ++pb;
    }
    if (slot >= 0) {
      cand_v[slot] = key * span + off + n;
      cand_c[slot] = v;
    }
  }
  __syncthreads();
  const int ncand = sh_ncand;
  if (threadIdx.x < ncand) {
    const long long x = cand_v[threadIdx.x];
    int at = 0;
    for (int i = 0; i < ncand; ++i) at += cand_v[i] < x;  // composites are unique
    sort_v[at] = x;
    sort_c[at] = cand_c[threadIdx.x];
  }
  __syncthreads();
  const int p = mode == kSpeculative ? 2 * kk_l + 1
                                     : (mode == kMega ? 3 * kk_l + w : 2 * kk_l + 1 + kBins);
  for (int i = threadIdx.x; i < p; i += blockDim.x) {
    int val;
    if (i < kk_l) {
      val = i < ncand ? (int)sort_v[i] : kBig;
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
      val = (int)pool[0];
    } else {
      val = hist[i - 2 * kk_l - 1];
    }
    for (int t = 0; t < s; ++t) buf[((size_t)t * rows + row) * p + i] = t == rank ? val : 0;
  }
}

// the tightest-first take of `_select_best_fit` on n candidates in merged
// (composite) order, by one thread; returns the feasibility
__device__ bool select_candidates(const int* key, const int* capc, int n, long long need,
                                  long long* bins, int* take) {
  for (int b = 0; b < kBins; ++b) bins[b] = 0;
  long long total = 0;
  for (int c = 0; c < n; ++c) {
    bins[key[c]] += capc[c];
    total += capc[c];
  }
  const bool ok = total >= need;
  long long cum = 0, below = 0;
  int thresh = 0;
  for (int b = 0; b < kBins; ++b) {
    cum += bins[b];
    thresh += cum < need;
  }
  thresh = min(thresh, kBins - 1);
  for (int b = 0; b < thresh; ++b) below += bins[b];
  const long long rem = need - below;
  long long prefix = 0;
  for (int c = 0; c < n; ++c) {
    long long t = 0;
    if (key[c] < thresh) {
      t = capc[c];
    } else if (key[c] == thresh) {
      t = min(max(rem - prefix, 0LL), (long long)capc[c]);
      prefix += capc[c];
    }
    take[c] = ok ? (int)t : 0;
  }
  return ok;
}

__global__ void select_kernel(int mode, const int* __restrict__ merged, const int* __restrict__ cap,
                              const int* __restrict__ needs, int* __restrict__ takes,
                              uint8_t* __restrict__ feas, int* __restrict__ stream_take,
                              int* __restrict__ verify, int* __restrict__ dense, int nl, int w,
                              int rows, int s, int rank, int kk_l, int kk) {
  __shared__ int pv[kMaxPool];
  __shared__ int m_v[kMaxK], m_c[kMaxK], m_x[kMaxK], m_key[kMaxK], m_l[kMaxK];
  __shared__ uint8_t m_own[kMaxK];
  __shared__ int t_sel[kMaxK];
  __shared__ int taken[(kMaxWave + 1) * kMaxK];
  __shared__ long long bins[kBins];
  __shared__ long long pre[kMaxK];
  __shared__ unsigned long long dsum[kMaxWave];
  __shared__ int tot[kBins], hoff[kBins];
  __shared__ int warp_tot[32];
  __shared__ int sh_flag, sh_ok, sh_thresh, sh_rem;
  const int row = blockIdx.x;
  const int p = mode == kSpeculative ? 2 * kk_l + 1
                                     : (mode == kMega ? 3 * kk_l + w : 2 * kk_l + 1 + kBins);
  const int npool = s * kk_l;
  for (int e = threadIdx.x; e < npool; e += blockDim.x)
    pv[e] = merged[((size_t)(e / kk_l) * rows + row) * p + e % kk_l];
  for (int c = threadIdx.x; c < kk; c += blockDim.x) {
    m_v[c] = kBig;  // slots past the S * kk_l candidates are sentinels
    m_c[c] = m_x[c] = 0;
  }
  for (int j = threadIdx.x; j < kMaxWave; j += blockDim.x) dsum[j] = 0;
  __syncthreads();
  for (int e = threadIdx.x; e < npool; e += blockDim.x) {
    const int x = pv[e];
    int at = 0;
    for (int f = 0; f < npool; ++f) {
      const int y = pv[f];
      at += y < x || (y == x && f < e);
    }
    if (at < kk) {
      const size_t base = ((size_t)(e / kk_l) * rows + row) * p + e % kk_l;
      m_v[at] = x;
      m_c[at] = merged[base + kk_l];
      if (mode == kMega) m_x[at] = merged[base + 2 * kk_l];
    }
  }
  __syncthreads();
  const int span = s * nl + 1;
  const int off = rank * nl;
  for (int c = threadIdx.x; c < kk; c += blockDim.x) {
    const int v = m_v[c];
    const int k = v / span;
    const int g = v - k * span;
    m_key[c] = min(k, kBins - 1);
    m_own[c] = v < kBig && g >= off && g < off + nl;
    m_l[c] = min(max(g - off, 0), nl - 1);
  }
  __syncthreads();
  if (mode == kMega) {
    if (threadIdx.x == 0) {
      long long total = 0, covered = 0, acc = 0;
      for (int j = 0; j < w; ++j) total += needs[j];
      for (int c = 0; c < kk; ++c) {
        pre[c] = acc;
        acc += m_c[c];
      }
      covered = acc;
      sh_ok = covered >= total;
    }
    __syncthreads();
    for (int c = threadIdx.x; c < kk; c += blockDim.x) {
      long long bound = 0;
      int prev = 0;
      for (int b = 0; b <= w; ++b) {
        const int t = (int)min(max(bound - pre[c], 0LL), (long long)m_c[c]);
        taken[b * kk + c] = t;
        if (b > 0) {
          const int nd = needs[b - 1];
          const long long d = (long long)min(m_x[c], nd) - min(m_x[c] - prev, nd);
          if (d != 0) atomicAdd(&dsum[b - 1], (unsigned long long)d);
        }
        prev = t;
        if (b < w) bound += needs[b];
      }
    }
    for (int x = threadIdx.x; x < w * nl; x += blockDim.x) takes[x] = 0;
    for (int n = threadIdx.x; n < nl; n += blockDim.x) stream_take[n] = 0;
    if (threadIdx.x < w) feas[threadIdx.x] = 1;
    __syncthreads();
    if (threadIdx.x == 0) {
      bool ok = sh_ok;
      for (int j = 0; j < w; ++j) {
        long long pooled = 0;
        for (int x = 0; x < s; ++x) pooled += merged[(size_t)x * p + 3 * kk_l + j];
        ok = ok && pooled - (long long)dsum[j] >= needs[j];
      }
      verify[0] = ok;
    }
    for (int c = threadIdx.x; c < kk; c += blockDim.x) {
      if (!m_own[c]) continue;
      const int l = m_l[c];
      for (int j = 0; j < w; ++j) takes[(size_t)j * nl + l] = taken[(j + 1) * kk + c] - taken[j * kk + c];
      stream_take[l] = taken[w * kk + c];
    }
    return;
  }
  const long long need = needs[mode == kSpeculative ? row : 0];
  if (threadIdx.x == 0) {
    long long pooled = 0;
    for (int x = 0; x < s; ++x) pooled += merged[((size_t)x * rows + row) * p + 2 * kk_l];
    const bool ok = select_candidates(m_key, m_c, kk, need, bins, t_sel);
    sh_ok = ok;
    sh_flag = ok || pooled < need;  // restricted (replay), or this gang's verify (speculative)
    if (mode == kSpeculative && !sh_flag) atomicOr(verify, 1);
  }
  __syncthreads();
  int* out = takes + (size_t)row * nl;
  if (mode == kSpeculative || sh_flag) {
    for (int n = threadIdx.x; n < nl; n += blockDim.x) out[n] = 0;
    if (threadIdx.x == 0) feas[row] = sh_ok;
    __syncthreads();
    for (int c = threadIdx.x; c < kk; c += blockDim.x)
      if (m_own[c]) out[m_l[c]] = t_sel[c];
    return;
  }
  // a replayed gang's dense-column take: `_hist_select` from the merged
  // histograms (global node order is rank-major)
  merged_buckets(merged + 2 * kk_l + 1, (size_t)p, s, rank, tot, hoff);
  __syncthreads();
  if (threadIdx.x == 0) {
    int thresh, below;
    const bool ok = hist_threshold(tot, (int)need, &thresh, &below);
    sh_ok = ok;
    sh_thresh = thresh;
    sh_rem = (int)need - below - hoff[thresh];
    feas[0] = ok;
    atomicAdd(dense, 1);
  }
  __syncthreads();
  bucket_take(cap, out, nl, sh_thresh, sh_rem, (int)need, sh_ok, warp_tot);
}

__global__ void commit_kernel(int mode, const int* __restrict__ cap, const int* __restrict__ left,
                              const int* __restrict__ req, const uint8_t* __restrict__ mask,
                              int mask_stride, const int* __restrict__ takes,
                              const int* __restrict__ stream_take, int* __restrict__ left_out,
                              int* __restrict__ verify, int nl, int r, int w) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= nl) return;
  if (mode != kSpeculative) {
    const int t = mode == kMega ? stream_take[n] : takes[n];
    for (int x = 0; x < r; ++x)
      left_out[(size_t)n * r + x] = left[(size_t)n * r + x] - t * req[x];
    return;
  }
  speculative_commit(n, cap, left, req, mask, mask_stride, takes, left_out, verify, nl, r, w);
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
  summary_kernel<<<rows, kThreads, 0, (cudaStream_t)stream>>>(
      mode, left, req, needs, mask, cap, buf, nl, r, w, rows, mask_stride, s, rank, kk_l);
  return (int)cudaGetLastError();
}

// The apply of one wave (w gangs) or one replayed gang (w = 1) from the
// merged buffer [s, rows, P]. `verify` is one word (null for a replay),
// `dense` one word a replayed gang's dense demotion adds to, `stream_take`
// the [nl] scratch of a uniform wave. Returns a CUDA error code.
int bst_shard_topk_apply(const int* merged, const int* cap, const int* needs, const int* left,
                         const int* req, const uint8_t* mask, int* takes, uint8_t* feas,
                         int* left_out, int* verify, int* dense, int* stream_take, int mode,
                         int nl, int r, int w, int s, int rank, int kk_l, int kk, int mask_stride,
                         void* stream) {
  if (mode < kSpeculative || mode > kReplay || !widths_ok(nl, r, w, s, rank, kk_l) || kk < 1 ||
      kk > kMaxK || (mode == kReplay && w != 1) || ((mode == kReplay) != (verify == nullptr)) ||
      dense == nullptr || stream_take == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (mode == kSpeculative) {
    cudaError_t e = cudaMemsetAsync(verify, 0, sizeof(int), st);
    if (e != cudaSuccess) return (int)e;
  }
  const int rows = mode == kSpeculative ? w : 1;
  select_kernel<<<rows, kThreads, 0, st>>>(mode, merged, cap, needs, takes, feas, stream_take,
                                           verify, dense, nl, w, rows, s, rank, kk_l, kk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  commit_kernel<<<(nl + kNodeThreads - 1) / kNodeThreads, kNodeThreads, 0, st>>>(
      mode, cap, left, req, mask, mask_stride, takes, stream_take, left_out, verify, nl, r, w);
  return (int)cudaGetLastError();
}

}  // extern "C"
