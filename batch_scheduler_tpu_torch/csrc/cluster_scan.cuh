// cluster_scan.cuh — device helpers shared by the port's two assignment
// scans (assign_scan.cu, the serial scan; assign_wave.cu, the wavefront
// scan), both thread-block clusters on Hopper (sm_90a):
// - exact division by a gang's request with the wrapper's multiply-shift
//   numbers (ops/assign_scan.py `division_magic`);
// - the cluster barrier, and the push of 16 bytes into another block's
//   shared memory with st.async, whose bytes complete the transaction
//   count of that block's mbarrier;
// - the mbarrier helpers and the cluster launch configuration;
// - the per-gang cluster step both kernels run: the capacity pass, the
//   histogram add, the push of a block's histogram, the threshold select
//   from an inbox, a thread's sum and prefix in a bin, and the take;
// - the selection key those functions bin a node by: the tightness bucket
//   min(cap, 127) (TightKey, the default), or the policy scan's composite
//   (PenaltyKey: the bucket plus the node's penalty, clipped to [1, 127]).
// ops/_build.py hashes this header with every source that includes it.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxCluster = 16;
constexpr int kBins = 128;
constexpr int kBig = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// floor(v / d) for v in [0, 2^30], d in [1, 2^30], from d's (m, l)
__device__ __forceinline__ int magic_div(int v, unsigned m, int l) {
  return l == 0 ? v : (int)(__umulhi((unsigned)v, m) >> (l - 1));
}

// `v`, with nothing about it known to the compiler. A slab's node count has
// a known bound (64); with it, the compiler unrolls every per-node loop of
// the slab paths in full, which took minutes of nvcc and spilled tens of
// KB of registers.
__device__ __forceinline__ int opaque(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile(
      "barrier.cluster.arrive.release;\n\t"
      "barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// the address of this block's shared word `addr` in cluster block `rank`
__device__ __forceinline__ unsigned cluster_addr(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// 16 bytes into another block's shared memory; the bytes count against
// the transaction count of that block's mbarrier `bar`
__device__ __forceinline__ void push16(unsigned dst, int4 v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];"
      :: "r"(dst), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect(unsigned bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, int parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// the function attributes a launch of `fn` with this shape needs
inline cudaError_t configure(const void* fn, int cluster_blocks, int shared_bytes) {
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed,
                              cluster_blocks > 8 ? 1 : 0);
}

// one cluster of `cluster_blocks` blocks; `attr` holds the cluster shape
inline cudaLaunchConfig_t launch_config(int cluster_blocks, int threads, int shared_bytes,
                                        cudaStream_t stream, cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster_blocks;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster_blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = shared_bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// ---- the selection key ------------------------------------------------------
// key(cap, i): the bin of own node i, whose capacity is cap. Every key is 0
// exactly where the capacity is 0, so the threshold and remainder formulas
// hold for either.

// the tightness bucket, min(cap, 127): the base scan's key
struct TightKey {
  TightKey() = default;
  template <class T>
  __device__ __forceinline__ explicit TightKey(const T&) {}
  __device__ __forceinline__ int operator()(int cap, int) const { return min(cap, kBins - 1); }
};

// the policy scan's composite key: clip(min(cap, 127) + pen[i], 1, 127)
// where cap > 0, else 0 (the sum wraps in int32, as the reference's)
template <int kN>
struct PenaltyKey {
  const int* pen;
  __device__ __forceinline__ explicit PenaltyKey(const int (&p)[kN]) : pen(p) {}
  __device__ __forceinline__ int operator()(int cap, int i) const {
    const int k = (int)((unsigned)min(cap, kBins - 1) + (unsigned)pen[i]);
    return cap > 0 ? min(max(k, 1), kBins - 1) : 0;
  }
};

// ---- the per-gang cluster step ---------------------------------------------
// A thread owns `cnt` consecutive nodes; the per-node loops run `np` times
// (the kernel's compile-time nodes a thread, or cnt in a runtime loop), and
// a slot past cnt is skipped or holds capacity 0. Lane k of own node i of
// a leftover slab lives at slab[k * lane_slots + i * threads] (`per` slots
// a thread). row[k] is lane k's (request, magic, shift, -) of the gang.
// A thread with more than 64 nodes runs them as slabs of at most 64
// through the same functions: bin_sum over every slab, one block_prefix,
// then take_commit slab by slab, carrying the prefix it returns.
// int32: a histogram entry, a prefix, a cluster sum or a remainder is a
// sum of need-clipped capacities, min(cap, need), over at most N nodes, so
// it is at most need * N, which the reference's batch boundary keeps below
// 2^31 (pad_oracle_batch's gang bound (2^31 - 1) // N), however many nodes
// a block or a thread holds.

// capacities of the own nodes: cap[i] enters as kBig (the node is in the
// gang's fit row) or 0, and leaves as the min over requested lanes of
// floor(clamp(left, 0, 2^30) / request)
template <int kN>
__device__ __forceinline__ void node_caps(int (&cap)[kN], int np, const int4* row, int r,
                                          const int* slab, int lane_slots, int threads,
                                          int per) {
  // every slot is read, with no branch, so that the loads of all the
  // thread's nodes are in flight together; a lane with no request leaves
  // the capacity as it is
#pragma unroll 4
  for (int k = 0; k < r; ++k) {
    const int4 q = row[k];
    const int* lk = slab + k * lane_slots;
#pragma unroll
    for (int i = 0; i < np; ++i) {
      const int v = min(max(lk[min(i, per - 1) * threads], 0), kBig);
      const int d = magic_div(v, (unsigned)q.y, q.z);
      cap[i] = q.x > 0 ? min(cap[i], d) : cap[i];
    }
  }
}

// bh[key] += min(cap, clip) over the own nodes, and the same into this
// warp's histogram wh; runs of equal keys are summed first (nodes whose
// keys differ, by capacity or by penalty alone, never merge), and a warp
// whose lanes all end on one key adds once
template <int kN, class Key = TightKey>
__device__ __forceinline__ void hist_add(const int (&cap)[kN], int np, int cnt, int clip,
                                         int lane, int* bh, int* wh, Key key_of = Key()) {
  int run_key = 0, run_sum = 0;
  bool single = true;
#pragma unroll
  for (int i = 0; i < np; ++i) {
    if (i < cnt) {
      const int key = key_of(cap[i], i);
      const int capc = min(cap[i], clip);
      if (i == 0) {
        run_key = key;
        run_sum = capc;
      } else if (key == run_key) {
        run_sum += capc;
      } else {
        if (run_sum != 0) {
          atomicAdd(wh + run_key, run_sum);
          atomicAdd(bh + run_key, run_sum);
        }
        run_key = key;
        run_sum = capc;
        single = false;
      }
    }
  }
  const int lead_key = __shfl_sync(kFull, run_key, 0);
  const int vote = single ? (cnt > 0 ? run_key : lead_key) : kBins + lane;
  int all_same = 0;
  __match_all_sync(kFull, vote, &all_same);
  if (all_same) {
    const int v = __reduce_add_sync(kFull, cnt > 0 ? run_sum : 0);
    if (lane == 0 && v != 0) {
      atomicAdd(wh + vote, v);
      atomicAdd(bh + vote, v);
    }
  } else if (cnt > 0 && run_sum != 0) {
    atomicAdd(wh + run_key, run_sum);
    atomicAdd(bh + run_key, run_sum);
  }
}

// one warp: this block's histogram bh (cleared on the way; the next round
// adds after a block barrier) into every cluster block's inbox at this
// lane's address `slot`, counted by that block's mbarrier `full`, which
// this block arms for `bytes` of the round
__device__ __forceinline__ void push_hist(int* bh, unsigned slot, unsigned full, int blocks,
                                          int lane, int bytes) {
  int4* mine = reinterpret_cast<int4*>(bh) + lane;
  const int4 hv = *mine;
  *mine = make_int4(0, 0, 0, 0);
  if (lane == 0) mbar_arrive_expect(full, bytes);
#pragma unroll
  for (int c = 0; c < kMaxCluster; ++c)
    if (c < blocks) push16(cluster_addr(slot, c), hv, cluster_addr(full, c));
}

// the threshold select of a gang with `need`; `thresh` and `feasible` are
// the same in every lane, `rem` (need less the units below the threshold
// bin) and `pre` (the lower-ranked blocks' entries in it) are valid in
// lane thresh >> 2
struct Sel {
  int thresh, rem, pre, feasible;
};

// one warp, from the `blocks` histograms of an inbox (block c's at
// inbox + c * stride); this lane's 4 bins' cluster sums in `h`, their
// prefix over blocks < `rank` in `lo`, and their inclusive prefix over the
// bins in `c`. The arithmetic is integer, so every block gets the same.
__device__ __forceinline__ Sel select_bin(const int* inbox, int stride, int blocks, int rank,
                                          int need, int lane, int (&h)[4], int (&lo)[4],
                                          int (&c)[4]) {
  int4 v[kMaxCluster];
#pragma unroll
  for (int b = 0; b < kMaxCluster; ++b)
    v[b] = b < blocks ? reinterpret_cast<const int4*>(inbox + b * stride)[lane]
                      : make_int4(0, 0, 0, 0);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = lo[i] = 0;
#pragma unroll
  for (int b = 0; b < kMaxCluster; ++b) {
    h[0] += v[b].x; h[1] += v[b].y; h[2] += v[b].z; h[3] += v[b].w;
    if (b < rank) {
      lo[0] += v[b].x; lo[1] += v[b].y; lo[2] += v[b].z; lo[3] += v[b].w;
    }
  }
  const int local = h[0] + h[1] + h[2] + h[3];
  const int incl = warp_inclusive_scan(local, lane);
  c[0] = incl - local + h[0];
  c[1] = c[0] + h[1];
  c[2] = c[1] + h[2];
  c[3] = c[2] + h[3];
  const int below = __reduce_add_sync(
      kFull, (c[0] < need) + (c[1] < need) + (c[2] < need) + (c[3] < need));
  Sel s;
  s.thresh = min(below, kBins - 1);
  const int q = s.thresh & 3;
  const int cum_at = q == 0 ? c[0] : q == 1 ? c[1] : q == 2 ? c[2] : c[3];
  const int tot_at = q == 0 ? h[0] : q == 1 ? h[1] : q == 2 ? h[2] : h[3];
  s.rem = need - (cum_at - tot_at);
  s.pre = q == 0 ? lo[0] : q == 1 ? lo[1] : q == 2 ? lo[2] : lo[3];
  s.feasible = __shfl_sync(kFull, c[3], 31) >= need;
  return s;
}

// the sum of min(cap, clip) over the own nodes in bin `th`
template <int kN, class Key = TightKey>
__device__ __forceinline__ int bin_sum(const int (&cap)[kN], int np, int cnt, int th,
                                       int clip, Key key_of = Key()) {
  int sum = 0;
#pragma unroll
  for (int i = 0; i < np; ++i)
    if (i < cnt && key_of(cap[i], i) == th) sum += min(cap[i], clip);
  return sum;
}

// this thread's prefix in bin `th` within its block, given `sum`, its own
// nodes' entries in the bin: the lower warps' entries of the per-warp
// histograms wh (warp w's at wh + w * kBins) and the lower lanes' sums
__device__ __forceinline__ int block_prefix(int sum, int th, const int* wh, int warp,
                                            int lane) {
  const int warp_pre = __reduce_add_sync(kFull, lane < warp ? wh[lane * kBins + th] : 0);
  return warp_pre + warp_inclusive_scan(sum, lane) - sum;
}

// block_prefix of the own nodes held in `cap`
template <int kN, class Key = TightKey>
__device__ __forceinline__ int bin_prefix(const int (&cap)[kN], int np, int cnt, int th,
                                          int clip, const int* wh, int warp, int lane,
                                          Key key_of = Key()) {
  return block_prefix(bin_sum(cap, np, cnt, th, clip, key_of), th, wh, warp, lane);
}

// the gang's tightest-first take on the own nodes, given this thread's
// prefix in the threshold bin `th` and the cluster's remainder `rem`: each
// nonzero take goes to arow[i] and off the leftover slab (wrapping in
// int32, as the reference). Returns the prefix after these nodes, where
// the thread's next nodes in the bin start.
template <int kN, class Key = TightKey>
__device__ __forceinline__ int take_commit(const int (&cap)[kN], int np, int cnt, int need,
                                            int th, int rem, int prefix, const int4* row,
                                            int r, int* slab, int lane_slots, int threads,
                                            int* arow, Key key_of = Key()) {
#pragma unroll
  for (int i = 0; i < np; ++i) {
    if (i < cnt) {
      const int key = key_of(cap[i], i);
      const int capc = min(cap[i], need);
      int take = 0;
      if (key < th) {
        take = capc;
      } else if (key == th) {
        take = min(max(rem - prefix, 0), capc);
        prefix += capc;
      }
      if (take != 0) {
        arow[i] = take;
        for (int k = 0; k < r; ++k) {
          int* cell = slab + k * lane_slots + i * threads;
          *cell = (int)((unsigned)*cell - (unsigned)take * (unsigned)row[k].x);
        }
      }
    }
  }
  return prefix;
}

}  // namespace
