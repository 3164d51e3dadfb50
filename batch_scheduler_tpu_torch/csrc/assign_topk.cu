// assign_topk.cu — the hierarchical top-K gang-placement scan, hand-written
// for Hopper (sm_90a) as one thread-block cluster.
//
// Replaces: batch_scheduler_tpu/ops/oracle.py `assign_gangs_topk` (:1156, a
// lax.scan over waves; with `_coarse_rank` :1106, `_member_capacity` :213
// and `_select_best_fit` :176). Plain version: ops/oracle.py
// `assign_gangs_topk` of this package. It computes the serial scan's
// alloc, placed and left_after bit for bit, one wave of W consecutive gangs
// of the scan order at a time, with each gang's exact selection run on its
// kk = max(2, min(K, N)) candidate nodes, and the reference's three per-wave
// series: conflicts[s] (the wave was replayed gang by gang), megas[s] (it
// passed the uniform test, from the prepare kernel) and demotions[s] (gangs
// of its replay that took the dense column).
//
// What bounds it on an H100: the chain of steps a wave makes, each a
// latency (a block or cluster barrier, a read of another block's shared
// memory), and at XL the sweep over a block's nodes (16 a thread), not
// bytes or operations (a wave moves a few KB and does ~W * N * R integer
// operations). The design keeps that chain short:
// - Blocks of at most 512 threads (128 registers; at 1024 threads the
//   kernel spilled). The leftover lives in the cluster's shared memory where
//   the plan finds room (topk_kernel_plan: up to the 65,536-node bucket at
//   R=6, so the north star and the acceptance bucket [2048, 65536]), in a
//   global scratch slab past it; the sweep's key bytes sit in shared memory
//   when they fit (its capacities, when it ranks one row), else the later
//   passes recompute them from the leftover. The prepare kernel writes each
//   position's stage (gang, need, request row with its division numbers);
//   a wave's stage is read during the exchange before it.
// - One cluster exchange ranks a wave. Each block sweeps its nodes for the
//   wave's rows (positions with equal requests share one row and one list;
//   a uniform wave ranks one row), eight nodes a thread at a time with
//   every lane's read in flight, then publishes, per row, a cumulative
//   128-bin count histogram of the tightness key min(cap, 127) over its
//   fitting nodes and its own first L = kk + margin nodes by the composite
//   key << 25 | node, sorted (with one node a thread, placed at once from
//   the histogram and per-warp key counts; else a local cut, a block scan
//   over the cut bin and a rank sort). After one cluster barrier every
//   block sums the histograms into the global cut and copies, from each
//   block's list, its entries at or before that cut: the global first L,
//   sorted again. Exact: composites are unique, so a block's share of the
//   global first L is a prefix of its own sorted list, and the cut's bin
//   takes its nodes from the lower blocks first (node order is block
//   order). The pooled sums of min(cap, need) come from the summed
//   histogram (a key below 127 is the capacity itself) plus the blocks'
//   exact sums over nodes of key 127. Two publish buffers alternate between
//   exchanges, so a block writes one only after the barrier that follows
//   every read of the exchange before (where shared memory holds only one,
//   as at W=32 with K=128, a barrier opens each exchange instead).
// - Every block then runs the same selection on the same copies (one warp
//   a gang, `_select_best_fit`'s histogram threshold on slots sorted by
//   key), the same mega boundary algebra (a warp a gang) or conflict check,
//   and only the owner block writes a node. A block reads another block's
//   leftover only for a speculative wave's conflict check and a carried
//   replay (below); any such read is followed by a cluster barrier before
//   any block writes its leftover again (`settle`), so a committed mega
//   wave costs one barrier and a committed speculative wave two.
// - Replays on the wave's carried candidates. Within a wave a take only
//   lowers the leftover of the nodes it touches, so for a later gang a
//   touched node's composite can only fall, or the node leaves (capacity
//   0), and every other node keeps its key. A replayed gang's live top-kk
//   is then the top-kk of its list from the wave's exchange (L entries)
//   with the touched nodes at their live capacity added, as long as at
//   most L - kk of its listed nodes have left (or the list held every
//   fitting node): every node past the list ranks behind all of it. Its
//   live pooled sum is the listed one less min(cap, need) lost on the
//   touched nodes. Every block keeps the touched nodes and their summed
//   takes (at most `tmax`) and reads their entry rows from the owners, so
//   the common replayed gang needs no sweep and no exchange; the owners
//   apply the takes after a cluster barrier (`settle`). A gang past either
//   limit, or after a dense demotion, ranks afresh (one exchange for the
//   rest of the wave); a demotion runs the full-row selection with one
//   exchange.
//
// Per wave, against the wave-entry leftover, as the reference's step:
// - mega wave (the uniform flag): position 0's row is ranked, with the
//   pooled sums of min(cap, need_w) for every position w; the stream of the
//   wave's total need runs over the candidates, and the reference's boundary
//   feasibility (pooled less the candidates' entry terms plus their
//   post-take terms) and coverage decide; a committed wave takes the stream
//   units between the gang boundaries.
// - speculative: every position selects on its candidates; a gang whose
//   candidates cannot cover its need while the pooled sum says it may fit
//   conflicts the wave; otherwise the conflict check on the touched
//   columns (each later gang's capacity under the earlier gangs' takes, in
//   int64 with each lane clamped at 0, against its capacity at wave entry).
// - replay: gang by gang as above (`carried_gang`, `dense_step`).
//
// int32 as the reference: counts, prefixes, need-clipped and pooled sums
// are at most need * N, below 2^31 at the batch boundary; the conflict
// check's prefixes are int64. Takes update the leftover with the
// serial kernel's wrapping subtraction. Integer atomics only, so the result
// is deterministic.
//
// Launch rules: the kernels run on the caller's stream, allocate nothing,
// and the C entry point returns the launch's CUDA error code.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster_scan.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxWave = 32;
constexpr int kMaxK = 128;
constexpr int kTopkThreads = 512;  // a block's threads: 128 registers a thread
constexpr int kMaxList = 256;     // kk + margin
constexpr int kNodeShift = 5;     // a take entry's key is node << 5 | wave position
constexpr int kCompShift = 25;    // a candidate's composite is key << 25 | node
constexpr unsigned kNodeMask = (1u << kCompShift) - 1;

struct TopkArgs {
  const int* left0;
  const int* group_req;
  const int* remaining;
  const unsigned char* mask;
  const int* order;
  int4* stage;                   // [S * W][R + 1], from the prepare kernel
  const unsigned char* uniform;  // [2S] from the prepare kernel
  int* alloc;
  unsigned char* placed;
  int* left_after;
  unsigned char* conflicts;
  unsigned char* megas;
  int* demotions;
  int* counts;  // [2]: replayed gangs served by carried lists, ranked afresh
  int* left;    // [C][R][per][threads] leftover slabs (null: shared memory)
  int n, g, r, mask_per_group, wave, kk, list, tmax, block_nodes, per, shared_left,
      shared_keys, pub_buffers;
};

__host__ __device__ inline long long align16(long long b) { return (b + 15) & ~15LL; }

// The dynamic shared memory layout (byte offsets), the same on the host
// (shared_need) and in the kernel; ops/assign_scan.py _topk_shared_bytes
// computes the same total.
struct Layout {
  long long stage, pub, pub_bytes, pub_pool, pub_list, ent, tk, wsum, goff, scr, wc, keys,
      left, total;
  // inside scr, for a carried replay
  long long u_delta, u_node, u_comp, u_cap, u_eidx, eflag, slice, src;
};

// Stages of a wave's rows: two (the next wave's read during an exchange)
// when a thread a stage entry can read it, else one.
__host__ __device__ inline int stage_count(int wave, int r, int threads) {
  return wave * (r + 1) <= threads ? 2 : 1;
}

__host__ __device__ inline Layout layout(int wave, int kk, int list, int tmax, int r, int per,
                                         int threads, int shared_left, int shared_keys,
                                         int pub_buffers) {
  Layout o;
  long long at = 0;
  o.stage = at;  // stages of a wave's rows: [W][R + 1] int4 each
  at += align16((long long)stage_count(wave, r, threads) * wave * (r + 1) * 16);
  // a publish buffer: cumulative histograms [W][128], pooled sums [W],
  // sorted candidate lists [W][L] (composite, capacity)
  o.pub_pool = align16(wave * kBins * 4LL);
  o.pub_list = o.pub_pool + align16(wave * 8LL);
  o.pub_bytes = o.pub_list + align16((long long)wave * list * 8);
  o.pub = at;
  at += pub_buffers * o.pub_bytes;
  o.ent = at;  // the gathered lists [W][L]
  at += align16((long long)wave * list * 8);
  o.tk = at;  // takes [W][kk]
  at += align16((long long)wave * kk * 4);
  o.wsum = at;  // block scans: [32 warps][2W]
  at += align16(64LL * wave * 4);
  o.goff = at;  // gather: a block's offset and count in a list, [W][16] each
  at += align16(2LL * wave * kMaxCluster * 4);
  // scratch: an unsorted list [W][L]; the conflict check's entries (two
  // [W][kk] int2 tables); or a carried replay's tables
  o.u_delta = 0;
  o.u_node = o.u_delta + align16((long long)tmax * r * 4);
  o.u_comp = o.u_node + align16(tmax * 4LL);
  o.u_cap = o.u_comp + align16(tmax * 4LL);
  o.u_eidx = o.u_cap + align16(tmax * 4LL);
  o.eflag = o.u_eidx + align16(tmax * 4LL);
  o.slice = o.eflag + align16(list * 4LL);
  o.src = o.slice + align16(kk * 8LL);
  const long long carried = o.src + align16(kk * 4LL);
  long long scr = (long long)wave * list * 8;
  if (scr < (long long)wave * kk * 16) scr = (long long)wave * kk * 16;
  if (scr < carried) scr = carried;
  o.scr = at;
  at += align16(scr);
  o.wc = at;  // one node a thread: per-warp key counts [threads / 32][128]
  if (per == 1) at += align16(threads / 32 * kBins * 4LL);
  o.keys = at;  // tightness keys [W][per][threads] bytes
  if (shared_keys) at += align16((long long)wave * per * threads);
  o.left = at;  // the leftover [R][per][threads]
  if (shared_left) at += (long long)r * per * threads * 4;
  o.total = at;
  return o;
}

struct TopkShared {
  long long pooled[kMaxWave];  // the cluster's pooled sums (at the lists' seed)
  unsigned long long corr;     // carried replay: pooled capacity lost on touched nodes
  int ecnt[kMaxWave];          // entries of a gathered list: min(L, fitting nodes)
  int complete[kMaxWave];      // the gathered list holds every fitting node
  int ltb[kMaxWave];           // local cut: the bin where the count reaches L (128: none)
  int llt[kMaxWave];           // local cut: fitting nodes below that bin
  int lne[kMaxWave];           // the local list's entries
  int feas[kMaxWave];
  int bound[kMaxWave + 1];     // mega: the gang boundaries in the member stream
  int dsel[4];                 // dense step: threshold, remainder, lower prefix, feasible
  int flag;
  int nent;
  int left;                    // carried replay: listed nodes that left
  int mega_next;               // the next wave's uniform flag, read ahead
  int cls[2][kMaxWave];        // a wave's positions by request row: the first equal one
  int lst[kMaxWave];           // the list a position selects on (its row's first position)
};

// in-place exclusive prefix over the block's threads (thread order is node
// order) of vals[0..count); wsum holds [32][stride] and must not be written
// again before the next block barrier; every thread calls it
__device__ void block_scan(int* vals, int count, int* wsum, int stride, int lane, int warp) {
  for (int v = 0; v < count; ++v) {
    const int x = vals[v];
    const int inc = warp_inclusive_scan(x, lane);
    if (lane == 31) wsum[warp * stride + v] = inc;
    vals[v] = inc - x;
  }
  __syncthreads();
  for (int v = 0; v < count; ++v)
    vals[v] += __reduce_add_sync(kFull, lane < warp ? wsum[lane * stride + v] : 0);
}

template <int N>
struct Width {
  static constexpr int value = N;
};

__device__ __forceinline__ int lane_of(int4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ unsigned composite(int cap, int node) {
  return ((unsigned)min(cap, kBins - 1) << kCompShift) | (unsigned)node;
}

// members of a gang with lane rows `row` ((request, magic, shift, -) a lane)
// that fit on the node whose lane 0 is at `lv` (lanes lane_slots apart)
__device__ __forceinline__ int member_cap(const int* lv, int lane_slots, const int4* row, int r) {
  int c = kBig;
  for (int k = 0; k < r; ++k) {
    const int4 q = row[k];
    if (q.x > 0) {
      const int v = min(max(lv[k * lane_slots], 0), kBig);
      c = min(c, magic_div(v, (unsigned)q.y, q.z));
    }
  }
  return c;
}

// entries of sorted composites e[0..cnt) below c
__device__ __forceinline__ int lower_bound_comp(const uint2* e, int cnt, unsigned c) {
  int lo = 0, hi = cnt;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (e[mid].x < c) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// the capacities of kN nodes of a leftover slab (node t's lane k at
// lv[k * lane_slots + t * threads]) for a gang with lane rows rq, for the
// nodes whose bit is set in `live` (0 for the others); the reads of four
// lanes of every node in flight together
template <int kN>
__device__ __forceinline__ void slab_caps(int (&cap)[kN], unsigned live, const int* lv,
                                          int lane_slots, int threads, const int4* rq, int r) {
#pragma unroll
  for (int t = 0; t < kN; ++t) cap[t] = (live >> t) & 1 ? kBig : 0;
  for (int k0 = 0; k0 < r; k0 += 4) {
    int v[4][kN];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const bool use = k0 + u < r && rq[min(k0 + u, r - 1)].x > 0;
#pragma unroll
      for (int t = 0; t < kN; ++t)
        v[u][t] = use && ((live >> t) & 1) ? lv[(k0 + u) * lane_slots + t * threads] : 0;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int4 q = rq[min(k0 + u, r - 1)];
      const bool use = k0 + u < r && q.x > 0;
#pragma unroll
      for (int t = 0; t < kN; ++t)
        if (use && ((live >> t) & 1))
          cap[t] = min(cap[t], magic_div(min(max(v[u][t], 0), kBig), (unsigned)q.y, q.z));
    }
  }
}

// sort lists p in [p0, p1) by composite, list p's cnts[p] entries from
// in + p * len into out + p * len: eight lanes an entry, each counting the
// entries below it among an eighth of the list
__device__ __forceinline__ void sort_lists(int p0, int p1, const int* cnts, const uint2* in,
                                           uint2* out, int len, int lane, int warp, int warps) {
  const int grp = lane >> 3, gl = lane & 7;
  const int total = (p1 - p0) * len;
  for (int qb = warp * 4; qb < total; qb += warps * 4) {
    const int q = qb + grp;
    const int p = p0 + q / len, e = q % len;
    const int ne = q < total ? cnts[p] : 0;
    const bool act = e < ne;
    int c = 0;
    uint2 me = make_uint2(0, 0);
    if (act) {
      me = in[p * len + e];
      for (int f = gl; f < ne; f += 8) c += in[p * len + f].x < me.x;
    }
    c += __shfl_xor_sync(kFull, c, 1);
    c += __shfl_xor_sync(kFull, c, 2);
    c += __shfl_xor_sync(kFull, c, 4);
    if (act && gl == 0) out[p * len + c] = me;
  }
}

// where lane k of any node's leftover lives: its owner block's shared
// memory (through the cluster) or its global slab
struct LeftView {
  int* shared_base;  // this block's shared leftover (null: global slabs)
  const int* global;
  int block_nodes, per, threads, lane_slots, r;
};

__device__ __forceinline__ int remote_lane(const cg::cluster_group& cluster, const LeftView& v,
                                           int node, int k) {
  const int b = node / v.block_nodes;
  const int loc = node - b * v.block_nodes;
  const int t = loc / v.per;
  const int off = k * v.lane_slots + (loc - t * v.per) * v.threads + t;
  if (v.shared_base != nullptr) return *cluster.map_shared_rank(v.shared_base + off, b);
  return __ldcg(v.global + (size_t)b * v.r * v.lane_slots + off);
}

// lanes k0..k0+7 of any node's leftover that the lane rows rq request (0
// for the others), the reads in flight together
__device__ __forceinline__ void remote_lanes8(const cg::cluster_group& cluster,
                                              const LeftView& lv, int node, int k0,
                                              const int4* rq, int (&v)[8]) {
#pragma unroll
  for (int t = 0; t < 8; ++t)
    v[t] = k0 + t < lv.r && rq[min(k0 + t, lv.r - 1)].x > 0 ? remote_lane(cluster, lv, node, k0 + t)
                                                            : 0;
}

__global__ void __launch_bounds__(kTopkThreads, 1) assign_topk_kernel(const TopkArgs a) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ TopkShared sh;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int blocks = (int)cluster.num_blocks();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int threads = blockDim.x;
  const int warps = threads / 32;
  const int n = a.n, g = a.g, r = a.r, per = a.per, wave = a.wave, kk = a.kk, L = a.list;
  const int margin = L - kk;
  const int b0 = min(rank * a.block_nodes, n);
  const int b1 = min(b0 + a.block_nodes, n);
  const int n0 = min(b0 + tid * per, b1);
  const int cnt = min(n0 + per, b1) - n0;
  const int lane_slots = per * threads;
  const int steps = (g + wave - 1) / wave;
  const int srow = r + 1;  // int4 a position in a stage: (gi, need), then the lane rows

  const Layout lay = layout(wave, kk, L, a.tmax, r, per, threads, a.shared_left, a.shared_keys,
                            a.pub_buffers);
  const int nstage = stage_count(wave, r, threads);
  int4* stage_sh = reinterpret_cast<int4*>(dyn + lay.stage);
  uint2* ent = reinterpret_cast<uint2*>(dyn + lay.ent);
  int* tk = reinterpret_cast<int*>(dyn + lay.tk);
  int* wsum = reinterpret_cast<int*>(dyn + lay.wsum);
  int* goff = reinterpret_cast<int*>(dyn + lay.goff);
  int* gcnt = goff + wave * kMaxCluster;
  unsigned char* scr = dyn + lay.scr;
  uint2* tmp = reinterpret_cast<uint2*>(scr);  // an unsorted list [W][L]
  int2* gat = reinterpret_cast<int2*>(scr);    // conflict entries, unsorted [W * kk]
  int2* ents = gat + wave * kk;                // and sorted
  int* u_delta = reinterpret_cast<int*>(scr + lay.u_delta);
  int* u_node = reinterpret_cast<int*>(scr + lay.u_node);
  unsigned* u_comp = reinterpret_cast<unsigned*>(scr + lay.u_comp);
  int* u_cap = reinterpret_cast<int*>(scr + lay.u_cap);
  int* u_eidx = reinterpret_cast<int*>(scr + lay.u_eidx);
  int* eflag = reinterpret_cast<int*>(scr + lay.eflag);
  uint2* slice = reinterpret_cast<uint2*>(scr + lay.slice);
  int* src = reinterpret_cast<int*>(scr + lay.src);
  unsigned char* keys = a.shared_keys ? dyn + lay.keys + tid : nullptr;
  // per-warp key counts of a one-node-a-thread sweep ([warps][128]), for
  // the local list without a sort
  int* wc = per == 1 ? reinterpret_cast<int*>(dyn + lay.wc) : nullptr;
  int* left_base = a.shared_left
                       ? reinterpret_cast<int*>(dyn + lay.left)
                       : a.left + (size_t)rank * r * lane_slots;
  int* left = left_base + tid;  // own node i, lane k: [k * lane_slots + i * threads]
  const int4* rows = stage_sh;  // the current stage

  const int* wcls = sh.cls[0];  // the current wave's classes
  int xc = 0;          // exchanges so far: the publish buffer is xc % pub_buffers
  bool dirty = false;  // other blocks' leftover read since the last barrier
  int nu = 0;          // carried replay: touched nodes
  bool clean = false;  // carried replay: its scratch tables are zero
  int served = 0, fresh = 0;

  auto row = [&](int j) { return rows + j * srow + 1; };
  auto gi_of = [&](int j) { return rows[j * srow].x; };    // the gang index (-1 past G)
  auto need_of = [&](int j) { return rows[j * srow].y; };
  // one warp: each position of the stage at st its row's first position
  // (equal requests, both real or both past G; with a fit row a gang, each
  // its own), into cls
  auto classify = [&](const int4* st, int* cls) {
    if (lane >= wave) return;
    int c = lane;
    if (!a.mask_per_group) {
      const bool real = st[lane * srow].x >= 0;
      for (int p = 0; p < lane && c == lane; ++p) {
        bool same = (st[p * srow].x >= 0) == real;
        for (int k = 0; k < r && same; ++k) same = st[p * srow + 1 + k].x == st[lane * srow + 1 + k].x;
        if (same) c = p;
      }
    }
    cls[lane] = c;
  };
  auto pub = [&](int b) { return dyn + lay.pub + b * lay.pub_bytes; };
  // zero publish buffer b's histograms and pooled sums
  auto clear_pub = [&](int b) {
    int4* h = reinterpret_cast<int4*>(pub(b));
    for (int q = tid; q < wave * kBins / 4; q += threads) h[q] = make_int4(0, 0, 0, 0);
    unsigned long long* pool = reinterpret_cast<unsigned long long*>(pub(b) + lay.pub_pool);
    for (int w = tid; w < wave; w += threads) pool[w] = 0;
  };
  // the publish buffer of the next exchange, zeroed: with two, the one the
  // exchange before last used, zeroed after the last exchange's barrier
  // (`after_barrier`); with one, after a barrier that follows every block's
  // reads of the exchange before
  auto pub_next = [&]() {
    const int b = xc++ % a.pub_buffers;
    if (a.pub_buffers == 1) {
      __syncthreads();
      cluster_barrier();
      clear_pub(b);
      __syncthreads();
    }
    return pub(b);
  };
  // right after an exchange's barrier: no block reads the other buffer again
  auto after_barrier = [&]() {
    if (a.pub_buffers == 2) clear_pub(xc % 2);
  };
  // any node's leftover, read only between a cluster barrier and the next
  // `settle`
  const LeftView lview{a.shared_left ? left_base : nullptr, a.left, a.block_nodes, per, threads,
                       lane_slots, r};
  // lane k of an own node's leftover
  auto own_cell = [&](int node, int k) -> int* {
    const int loc = node - b0;
    const int t = loc / per;
    return left_base + k * lane_slots + (loc - t * per) * threads + t;
  };
  auto own = [&](int node) { return node >= b0 && node < b1; };
  auto fits = [&](int j, int node) -> bool {
    const int gj = gi_of(j);
    return gj >= 0 &&
           __ldg(a.mask + (a.mask_per_group ? (size_t)gj * n : (size_t)0) + node) != 0;
  };
  // the fit row's bits of the first 64 own nodes, when every gang shares it
  unsigned long long own_bits = 0;
  if (!a.mask_per_group)
    for (int i = 0; i < min(cnt, 64); ++i)
      own_bits |= (unsigned long long)(__ldg(a.mask + n0 + i) != 0) << i;
  auto own_fits = [&](int j, int i) -> bool {
    if (a.mask_per_group || i >= 64) return fits(j, n0 + i);
    return gi_of(j) >= 0 && ((own_bits >> i) & 1);
  };
  auto own_cap = [&](int j, int i) -> int {  // own node i's capacity for position j
    return i < cnt && own_fits(j, i) ? member_cap(left + i * threads, lane_slots, row(j), r) : 0;
  };
  // which of own nodes i0 .. i0 + n_ - 1 fit position j (bits), of those
  // set in `want`
  auto fit_bits = [&](int j, int i0, int n_, unsigned want) -> unsigned {
    unsigned b = 0;
    for (int t = 0; t < n_; ++t)
      if (((want >> t) & 1) && i0 + t < cnt && own_fits(j, i0 + t)) b |= 1u << t;
    return b;
  };

  for (int i = 0; i < cnt; ++i)
    for (int k = 0; k < r; ++k) left[k * lane_slots + i * threads] = a.left0[(size_t)(n0 + i) * r + k];
  for (int q = tid; q < wave * srow; q += threads) stage_sh[q] = a.stage[q];
  for (int b = 0; b < a.pub_buffers; ++b) clear_pub(b);
  if (wc != nullptr)
    for (int q = tid; q < warps * kBins; q += threads) wc[q] = 0;
  if (tid == 0 && steps > 0) sh.mega_next = a.uniform[0] && !a.uniform[steps];
  __syncthreads();
  if (warp == 0) classify(stage_sh, sh.cls[0]);
  __syncthreads();


  // ---- no other block still reads this block's leftover: a barrier after
  // remote reads, then the carried takes on the own nodes
  auto settle = [&]() {
    if (dirty) {
      __syncthreads();
      cluster_barrier();
      dirty = false;
    }
    for (int u = tid; u < nu; u += threads) {
      const int x = u_node[u];
      if (!own(x)) continue;
      for (int k = 0; k < r; ++k) {
        int* cell = own_cell(x, k);
        *cell = (int)((unsigned)*cell - (unsigned)u_delta[u * r + k]);
      }
    }
    nu = 0;
    __syncthreads();
  };

  // ---- rank positions [j0, j1) in one exchange (see the header); with
  // `mega`, position j0's row feeds the pooled sums of every position. With
  // `next`, the stage of wave `next` is read around the barrier.
  auto rank_exchange = [&](int j0, int j1, bool mega, int next) {
    clean = false;
    // positions sharing a request row share a list: the exchange ranks the
    // first of them (bit set in `dmask`), the others select on its list
    auto lst_of = [&](int j) {
      for (int p = j0; p < j; ++p)
        if (wcls[p] == wcls[j]) return p;
      return j;
    };
    unsigned dmask = 0;
    for (int j = j0; j < j1; ++j)
      if (mega || lst_of(j) == j) dmask |= 1u << j;
    auto ranked = [&](int j) { return ((dmask >> j) & 1) != 0; };
    unsigned char* pb = pub_next();
    int* cum = reinterpret_cast<int*>(pb);
    unsigned long long* pool = reinterpret_cast<unsigned long long*>(pb + lay.pub_pool);
    uint2* list = reinterpret_cast<uint2*>(pb + lay.pub_list);
    // the sweep: each own node's capacity for each position, its key and
    // the count histogram (equal keys of a warp added once); a thread's
    // nodes eight at a time, their reads in flight together. The pooled
    // sums of min(cap, need) come from the cluster's histogram (a key below
    // 127 is the capacity itself); only nodes of key 127 add their exact
    // min(cap, need) to `pool` (a warp's sum once; at most need * N, so
    // int32 inside the batch boundary).
    const bool fast = wc != nullptr && j1 - j0 == 1;  // one node a thread, one position
    // one position, and room for an int a node in the key bytes' place: the
    // sweep keeps the capacities themselves, so the list needs no reread
    int* capk = keys != nullptr && j1 - j0 == 1 && wave >= 4
                    ? reinterpret_cast<int*>(dyn + lay.keys) + tid
                    : nullptr;
    int fcap = 0, fkey = 0;
    unsigned fpeers = 0;
    auto sweep = [&](auto width) {
      constexpr int kN = decltype(width)::value;
      for (int i0 = 0; i0 < per; i0 += kN) {
        for (int j = j0; j < j1; ++j) {
          if (!ranked(j)) continue;
          int cap[kN];
          slab_caps<kN>(cap, fit_bits(j, i0, kN, (1u << kN) - 1), left + i0 * threads, lane_slots,
                        threads, row(j), r);
          bool top = false;
#pragma unroll
          for (int t = 0; t < kN; ++t) {
            const int key = min(cap[t], kBins - 1);
            top |= key == kBins - 1;
            if (capk != nullptr && i0 + t < cnt) capk[(i0 + t) * threads] = cap[t];
            else if (keys != nullptr && i0 + t < cnt)
              keys[(j * per + i0 + t) * threads] = (unsigned char)key;
            const unsigned peers = __match_any_sync(kFull, key);
            if (key > 0 && lane == __ffs(peers) - 1) {
              atomicAdd(cum + j * kBins + key, __popc(peers));
              if (kN == 1 && fast) wc[warp * kBins + key] = __popc(peers);
            }
            if (kN == 1) {
              fcap = cap[t];
              fkey = key;
              fpeers = peers;
            }
          }
          if (__any_sync(kFull, top)) {
            for (int w = mega ? 0 : j0; w < (mega ? wave : j1); ++w) {
              if (!mega && lst_of(w) != j) continue;
              const int need = need_of(w);
              int sum = 0;
#pragma unroll
              for (int t = 0; t < kN; ++t) sum += cap[t] >= kBins - 1 ? min(cap[t], need) : 0;
              sum = __reduce_add_sync(kFull, sum);
              if (lane == 0 && sum != 0) atomicAdd(pool + w, (unsigned long long)sum);
            }
          }
        }
      }
    };
    if (per == 1) sweep(Width<1>());
    else sweep(Width<8>());
    __syncthreads();
    // the local cut of each position (a warp a position); the histogram
    // becomes cumulative in place, as published
    for (int j = j0 + warp; j < j1; j += warps) {
      if (!ranked(j)) {
        if (lane == 0) {
          sh.ltb[j] = kBins;
          sh.llt[j] = 0;
          sh.lne[j] = 0;
        }
        continue;
      }
      int4* h4 = reinterpret_cast<int4*>(cum + j * kBins) + lane;
      const int4 c = *h4;
      const int local = c.x + c.y + c.z + c.w;
      const int ex = warp_inclusive_scan(local, lane) - local;
      int4 o;
      o.x = ex + c.x;
      o.y = o.x + c.y;
      o.z = o.y + c.z;
      o.w = o.z + c.w;
      *h4 = o;
      const int tb = __reduce_add_sync(kFull, (o.x < L) + (o.y < L) + (o.z < L) + (o.w < L));
      const int lt = __shfl_sync(kFull, lane_of(o, (tb - 1) & 3), (tb - 1) >> 2);
      if (lane == 0) {
        sh.ltb[j] = tb;
        sh.llt[j] = lt;
        sh.lne[j] = tb < kBins ? L : lt;
      }
    }
    __syncthreads();
    if (fast) {
      // the sorted local list at once: a node's slot is the count below its
      // key, the lower warps' count of its key, and its lower peers'
      if (fkey > 0) {
        int pos = cum[j0 * kBins + fkey - 1] + __popc(fpeers & ((1u << lane) - 1));
        for (int w = 0; w < warp; ++w) pos += wc[w * kBins + fkey];
        if (pos < L) list[j0 * L + pos] = make_uint2(composite(fcap, n0), (unsigned)fcap);
      }
      __syncthreads();
    } else {
      auto key_at = [&](int j, int i) -> int {
        if (capk != nullptr) return min(capk[i * threads], kBins - 1);
        return keys != nullptr ? keys[(j * per + i) * threads] : min(own_cap(j, i), kBins - 1);
      };
      // this thread's ranks among the nodes below each cut bin and in it (a
      // block scan), then the local lists, unsorted: every node below the
      // cut bin, and the first ones of that bin by index
      int eq[2 * kMaxWave];
      for (int j = j0; j < j1; ++j) {
        const int tb = sh.ltb[j];
        int lo = 0, at = 0;
        for (int i = 0; i < cnt && ranked(j); ++i) {
          const int key = key_at(j, i);
          lo += key > 0 && key < tb;
          at += key == tb;
        }
        eq[2 * (j - j0)] = lo;
        eq[2 * (j - j0) + 1] = at;
      }
      block_scan(eq, 2 * (j1 - j0), wsum, 2 * wave, lane, warp);
      for (int j = j0; j < j1; ++j) {
        if (!ranked(j)) continue;
        const int tb = sh.ltb[j], lt = sh.llt[j];
        int lo = eq[2 * (j - j0)], at = eq[2 * (j - j0) + 1];
        for (int i0 = 0; i0 < cnt; i0 += 8) {
          int slot[8];
          unsigned want = 0;
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            slot[t] = -1;
            if (i0 + t < cnt) {
              const int key = key_at(j, i0 + t);
              if (key > 0 && key < tb) {
                slot[t] = lo++;
              } else if (key == tb) {
                if (at < L - lt) slot[t] = lt + at;
                ++at;
              }
            }
            if (slot[t] >= 0) want |= 1u << t;
          }
          if (want == 0) continue;
          int cap[8];
          if (capk != nullptr) {
#pragma unroll
            for (int t = 0; t < 8; ++t) cap[t] = slot[t] >= 0 ? capk[(i0 + t) * threads] : 0;
          } else {
            slab_caps<8>(cap, fit_bits(j, i0, 8, want), left + i0 * threads, lane_slots, threads,
                         row(j), r);
          }
#pragma unroll
          for (int t = 0; t < 8; ++t)
            if (slot[t] >= 0)
              tmp[j * L + slot[t]] = make_uint2(composite(cap[t], n0 + i0 + t), (unsigned)cap[t]);
        }
      }
      __syncthreads();
      sort_lists(j0, j1, sh.lne, tmp, list, L, lane, warp, warps);
      __syncthreads();
    }
    int4 pre = make_int4(0, 0, 0, 0);
    const bool ahead = next >= 0 && next < steps && nstage == 2;
    const bool fetch = ahead && tid < wave * srow;
    if (fetch) pre = a.stage[(size_t)next * wave * srow + tid];
    int uni = 0;
    if (ahead && tid == 0) uni = a.uniform[next] && !a.uniform[steps + next];
    cluster_barrier();
    after_barrier();
    if (fast)  // read only before the barrier: zero it for the next sweep
      for (int q = tid; q < warps * kBins; q += threads) wc[q] = 0;
    if (fetch) stage_sh[(next & 1) * wave * srow + tid] = pre;
    if (ahead && tid == 0) sh.mega_next = uni;
    // the global cut of each position (a warp a position), every block's
    // share of the global first L, and the pooled sums
    if (!mega)
      for (int j = j0 + tid; j < j1; j += threads) sh.lst[j] = lst_of(j);
    for (int j = j0 + warp; j < j1; j += warps) {
      if (!ranked(j)) {
        if (lane < blocks) gcnt[j * kMaxCluster + lane] = 0;
        if (lane == 0) sh.ecnt[j] = 0;
        continue;
      }
      int4 gsum = make_int4(0, 0, 0, 0);
      int4* mine = reinterpret_cast<int4*>(cum + j * kBins) + lane;
      {  // every block's read in flight together
        int4 v[kMaxCluster];
#pragma unroll
        for (int c = 0; c < kMaxCluster; ++c)
          v[c] = c < blocks ? *cluster.map_shared_rank(mine, c) : make_int4(0, 0, 0, 0);
#pragma unroll
        for (int c = 0; c < kMaxCluster; ++c) {
          gsum.x += v[c].x; gsum.y += v[c].y; gsum.z += v[c].z; gsum.w += v[c].w;
        }
      }
      const int total = __shfl_sync(kFull, gsum.w, 31);
      const int bs = __reduce_add_sync(
          kFull, (gsum.x < L) + (gsum.y < L) + (gsum.z < L) + (gsum.w < L));
      int nc = 0;
      if (bs < kBins) {
        const int gbelow = __shfl_sync(kFull, lane_of(gsum, (bs - 1) & 3), (bs - 1) >> 2);
        int below = 0, at = 0;
        if (lane < blocks) {
          below = *cluster.map_shared_rank(cum + j * kBins + bs - 1, lane);
          at = *cluster.map_shared_rank(cum + j * kBins + bs, lane) - below;
        }
        const int lower = warp_inclusive_scan(at, lane) - at;
        nc = below + min(max(L - gbelow - lower, 0), at);
      } else if (lane < blocks) {
        nc = *cluster.map_shared_rank(cum + j * kBins + kBins - 1, lane);
      }
      const int off = warp_inclusive_scan(nc, lane) - nc;
      if (lane < blocks) {
        goff[j * kMaxCluster + lane] = off;
        gcnt[j * kMaxCluster + lane] = nc;
      }
      if (lane == 0) {
        sh.ecnt[j] = min(total, L);
        sh.complete[j] = total <= L;
      }
      // the pooled sums (of every position's need for a mega wave): the
      // count of each key below 127 times min(key, need), plus the blocks'
      // exact sums over key 127 when the cluster has such nodes
      const int gprev = __shfl_up_sync(kFull, gsum.w, 1);
      int4 hc;  // the counts of this lane's four bins
      hc.x = gsum.x - (lane == 0 ? 0 : gprev);
      hc.y = gsum.y - gsum.x;
      hc.z = gsum.z - gsum.y;
      hc.w = gsum.w - gsum.z;
      const int top = __shfl_sync(kFull, hc.w, 31);
      if (lane == 31) hc.w = 0;
      const int kb = lane * 4;
      for (int w = mega ? 0 : j0; w < (mega ? wave : j1); ++w) {
        if (!mega && lst_of(w) != j) continue;
        const int need = need_of(w);
        int part = hc.x * min(kb, need) + hc.y * min(kb + 1, need) + hc.z * min(kb + 2, need) +
                   hc.w * min(kb + 3, need);
        if (top > 0 && lane < blocks) part += (int)*cluster.map_shared_rank(pool + w, lane);
        const int pooled = __reduce_add_sync(kFull, part);
        if (lane == 0) sh.pooled[w] = pooled;
      }
    }
    __syncthreads();
    if (ahead && warp == warps - 1)  // the next wave's classes, from its stage read ahead
      classify(stage_sh + (next & 1) * wave * srow, sh.cls[next & 1]);
    for (int q = tid; q < (j1 - j0) * blocks * L; q += threads) {
      const int j = j0 + q / (blocks * L);
      const int c = (q / L) % blocks, p = q % L;
      if (p < gcnt[j * kMaxCluster + c])
        tmp[j * L + goff[j * kMaxCluster + c] + p] = *cluster.map_shared_rank(list + j * L + p, c);
    }
    __syncthreads();
    sort_lists(j0, j1, sh.ecnt, tmp, ent, L, lane, warp, warps);
    __syncthreads();
  };

  // ---- one warp: `_select_best_fit` with need `need` on the first kk slots
  // of the sorted list sl (ne entries; capacity 0 past them); takes into
  // tko, returns feasible (the slots cover the need)
  auto select_slice = [&](const uint2* sl, int ne, int* tko, int need) -> int {
    int cap[4], capc[4];
    int sum = 0;
    for (int t = 0; t < 4; ++t) {
      const int s = lane * 4 + t;
      cap[t] = s < kk && s < ne ? (int)sl[s].y : 0;
      capc[t] = min(cap[t], need);
      sum += capc[t];
    }
    const int incl = warp_inclusive_scan(sum, lane);
    const int total = __shfl_sync(kFull, incl, 31);
    const int feasible = total >= need;
    // threshold bin: the key of the first live slot whose inclusive prefix
    // reaches the need (live slots ascend by key); 0 for need <= 0
    int first = kBins, p = incl - sum;
    for (int t = 0; t < 4; ++t) {
      p += capc[t];
      if (cap[t] > 0 && p >= need && first == kBins) first = min(cap[t], kBins - 1);
    }
    const int thresh = need <= 0 ? 0 : min(__reduce_min_sync(kFull, first), kBins - 1);
    p = incl - sum;
    for (int t = 0; t < 4; ++t) {
      const int s = lane * 4 + t;
      const int key = min(cap[t], kBins - 1);
      int take = 0;
      if (key < thresh) take = capc[t];
      else if (key == thresh) take = min(max(need - p, 0), capc[t]);
      p += capc[t];
      if (s < kk) tko[s] = feasible ? take : 0;
    }
    return feasible;
  };

  // ---- the dense-column step of position j: the full-row selection on the
  // live leftover (after `settle`), one exchange of the 128-bin histogram
  // of min(cap, need); the owners take at once (no block reads another's
  // leftover until the next exchange)
  auto dense_step = [&](int j) {
    int* dh = reinterpret_cast<int*>(pub_next());
    const int need = need_of(j);
    // the own capacities, kept in the key bytes' room when it holds them
    int* caps = keys != nullptr && wave >= 4 ? reinterpret_cast<int*>(dyn + lay.keys) + tid
                                             : nullptr;
    auto cap_at = [&](int i) { return caps != nullptr ? caps[i * threads] : own_cap(j, i); };
    auto pass = [&](auto width) {  // a thread's nodes eight at a time, reads in flight
      constexpr int kN = decltype(width)::value;
      for (int i0 = 0; i0 < cnt; i0 += kN) {
        int cap[kN];
        slab_caps<kN>(cap, fit_bits(j, i0, kN, (1u << kN) - 1), left + i0 * threads, lane_slots,
                      threads, row(j), r);
#pragma unroll
        for (int t = 0; t < kN; ++t) {
          if (caps != nullptr && i0 + t < cnt) caps[(i0 + t) * threads] = cap[t];
          const int capc = min(cap[t], need);
          if (capc > 0) atomicAdd(&dh[min(cap[t], kBins - 1)], capc);
        }
      }
    };
    if (per == 1) pass(Width<1>());
    else pass(Width<8>());
    __syncthreads();
    cluster_barrier();
    after_barrier();
    if (warp == 0) {
      int h[4] = {0, 0, 0, 0}, lo[4] = {0, 0, 0, 0};
      int4* mine = reinterpret_cast<int4*>(dh) + lane;
      for (int c0 = 0; c0 < blocks; c0 += 8) {  // eight reads in flight
        int4 v[8];
#pragma unroll
        for (int c = 0; c < 8; ++c)
          v[c] = c0 + c < blocks ? *cluster.map_shared_rank(mine, c0 + c) : make_int4(0, 0, 0, 0);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          h[0] += v[c].x; h[1] += v[c].y; h[2] += v[c].z; h[3] += v[c].w;
          if (c0 + c < rank) {
            lo[0] += v[c].x; lo[1] += v[c].y; lo[2] += v[c].z; lo[3] += v[c].w;
          }
        }
      }
      const int local = h[0] + h[1] + h[2] + h[3];
      const int incl = warp_inclusive_scan(local, lane);
      int cum[4];
      cum[0] = incl - local + h[0];
      cum[1] = cum[0] + h[1];
      cum[2] = cum[1] + h[2];
      cum[3] = cum[2] + h[3];
      const int below = __reduce_add_sync(
          kFull, (cum[0] < need) + (cum[1] < need) + (cum[2] < need) + (cum[3] < need));
      const int th = min(below, kBins - 1);
      const int total = __shfl_sync(kFull, cum[3], 31);
      if (lane == (th >> 2)) {
        const int q = th & 3;
        sh.dsel[0] = th;
        sh.dsel[1] = need - (cum[q] - h[q]);
        sh.dsel[2] = lo[q];
      }
      if (lane == 0) sh.dsel[3] = total >= need;
    }
    __syncthreads();
    const int th = sh.dsel[0], rem = sh.dsel[1], feasible = sh.dsel[3];
    if (feasible) {
      int own_sum[1] = {0};
      for (int i = 0; i < cnt; ++i) {
        const int cap = cap_at(i);
        if (cap > 0 && min(cap, kBins - 1) == th) own_sum[0] += min(cap, need);
      }
      block_scan(own_sum, 1, wsum, 2 * wave, lane, warp);
      int prefix = sh.dsel[2] + own_sum[0];
      const int4* rj = row(j);
      for (int i = 0; i < cnt; ++i) {
        const int cap = cap_at(i);
        const int key = min(cap, kBins - 1), capc = min(cap, need);
        int take = 0;
        if (cap > 0 && key < th) {
          take = capc;
        } else if (cap > 0 && key == th) {
          take = min(max(rem - prefix, 0), capc);
          prefix += capc;
        }
        if (take > 0) {
          a.alloc[(size_t)gi_of(j) * n + n0 + i] = take;
          for (int k = 0; k < r; ++k) {
            int* cell = left + k * lane_slots + i * threads;
            *cell = (int)((unsigned)*cell - (unsigned)take * (unsigned)rj[k].x);
          }
        }
      }
    }
    if (rank == 0 && tid == 0) a.placed[gi_of(j)] = (unsigned char)feasible;
    __syncthreads();
  };

  // ---- position j's turn in a replay on the carried lists (list `lj`):
  // 0 selected on its candidates, 1 a dense demotion, 2 the lists cannot
  // serve it (more than `margin` listed nodes left, or the touched table
  // would overflow): rank afresh and call again. The tables it uses (the
  // listed nodes' touched flags, the slice and its sources) are zero on
  // entry: `clean` says so after the first call since the scratch was
  // last used otherwise.
  auto carried_gang = [&](int j, int lj) -> int {
    const uint2* E = ent + lj * L;
    const int ne = sh.ecnt[lj], complete = sh.complete[lj];
    const int need = need_of(j);
    const int4* rj = row(j);
    if (!clean) {
      for (int p = tid; p < L; p += threads) eflag[p] = -1;
      for (int q = tid; q < kk; q += threads) {
        slice[q] = make_uint2(0, 0);
        src[q] = -1;
      }
      if (tid == 0) {
        sh.left = 0;
        sh.corr = 0;
      }
      __syncthreads();
      clean = true;
    }
    // the touched nodes at their entry and live capacity, and where their
    // entry composite sits in the list (u_eidx; ne when not listed)
    for (int u0 = 0; u0 < nu; u0 += threads) {
      const int u = u0 + tid;
      int c0 = 0, c1 = 0;
      if (u < nu) {
        const int x = u_node[u];
        if (fits(j, x)) {
          c0 = c1 = kBig;
          for (int k0 = 0; k0 < r; k0 += 8) {
            int v[8];
            remote_lanes8(cluster, lview, x, k0, rj, v);
#pragma unroll
            for (int t = 0; t < 8; ++t) {
              const int k = k0 + t;
              if (k >= r || rj[k].x <= 0) continue;
              const int4 q = rj[k];
              const int v1 = (int)((unsigned)v[t] - (unsigned)u_delta[u * r + k]);
              c0 = min(c0, magic_div(min(max(v[t], 0), kBig), (unsigned)q.y, q.z));
              c1 = min(c1, magic_div(min(max(v1, 0), kBig), (unsigned)q.y, q.z));
            }
          }
        }
        u_cap[u] = c1;
        u_comp[u] = composite(c1, x);
        int at = ne;
        if (c0 > 0) {
          const unsigned c = composite(c0, x);
          const int p = lower_bound_comp(E, ne, c);
          if (p < ne && E[p].x == c) {
            at = p;
            eflag[p] = u;
            if (c1 == 0) atomicAdd(&sh.left, 1);
          }
        }
        u_eidx[u] = at;
      }
      const int d = __reduce_add_sync(kFull, min(c0, need) - min(c1, need));
      if (lane == 0 && d != 0) atomicAdd(&sh.corr, (unsigned long long)d);
    }
    if (nu > 0) dirty = true;
    __syncthreads();
    clean = false;
    if (!complete && sh.left > margin) return 2;
    // the live top-kk of the untouched listed nodes and the touched ones
    auto touched_before = [&](int p) {  // listed nodes before slot p that are touched
      int c = 0;
      for (int u = 0; u < nu; ++u) c += u_eidx[u] < p;
      return c;
    };
    auto live_below = [&](unsigned c) {  // touched nodes live below composite c
      int b = 0;
      for (int u = 0; u < nu; ++u) b += u_cap[u] > 0 && u_comp[u] < c;
      return b;
    };
    for (int p = tid; p < ne; p += threads) {
      if (eflag[p] >= 0) continue;
      const int rk = p - touched_before(p);
      if (rk >= kk) continue;
      const unsigned c = E[p].x;
      const int rk2 = rk + live_below(c);
      if (rk2 < kk) slice[rk2] = E[p];
    }
    for (int u = tid; u < nu; u += threads) {
      if (u_cap[u] <= 0) continue;
      const unsigned c = u_comp[u];
      const int lb = lower_bound_comp(E, ne, c);
      const int rk = lb - touched_before(lb) + live_below(c);
      if (rk < kk) {
        slice[rk] = make_uint2(c, (unsigned)u_cap[u]);
        src[rk] = u;
      }
    }
    __syncthreads();
    if (warp == 0) {
      const int f = select_slice(slice, kk, tk, need);
      if (lane == 0) sh.feas[j] = f;
    }
    __syncthreads();
    const int feasible = sh.feas[j];
    const bool demote = !feasible && sh.pooled[j] - (long long)sh.corr >= need;
    const int added = __syncthreads_count(tid < kk && tk[tid] > 0 && src[tid] < 0);
    if (demote) return 1;
    if (nu + added > a.tmax) return 2;
    // warp 0 records the takes (new touched nodes in slot order) and zeroes
    // the slice; the other warps zero the touched flags
    if (warp == 0) {
      int fresh_slots = 0;
      for (int t = 0; t < 4; ++t) {
        const int q = lane * 4 + t;
        fresh_slots += q < kk && tk[q] > 0 && src[q] < 0;
      }
      int idx = nu + warp_inclusive_scan(fresh_slots, lane) - fresh_slots;
      for (int t = 0; t < 4; ++t) {
        const int q = lane * 4 + t;
        if (q >= kk) continue;
        const int tq = tk[q];
        if (tq > 0) {
          const int x = (int)(slice[q].x & kNodeMask);
          if (own(x)) a.alloc[(size_t)gi_of(j) * n + x] = tq;
          int u = src[q];
          if (u < 0) {
            u = idx++;
            u_node[u] = x;
            for (int k = 0; k < r; ++k) u_delta[u * r + k] = (int)((unsigned)tq * (unsigned)rj[k].x);
          } else {
            for (int k = 0; k < r; ++k)
              u_delta[u * r + k] =
                  (int)((unsigned)u_delta[u * r + k] + (unsigned)tq * (unsigned)rj[k].x);
          }
        }
        slice[q] = make_uint2(0, 0);
        src[q] = -1;
      }
      if (lane == 0) {
        sh.left = 0;
        sh.corr = 0;
        if (rank == 0) a.placed[gi_of(j)] = (unsigned char)feasible;
      }
    }
    for (int p = tid; p < ne; p += threads) eflag[p] = -1;
    nu += added;
    clean = true;
    __syncthreads();
    return 0;
  };

  for (int s = 0; s < steps; ++s) {
    rows = stage_sh + (s % nstage) * wave * srow;
    wcls = sh.cls[s & 1];
    if (nstage == 1 && s > 0) {  // too wide to read ahead: read it now
      for (int q = tid; q < wave * srow; q += threads)
        stage_sh[q] = a.stage[(size_t)s * wave * srow + q];
      if (tid == 0) sh.mega_next = a.uniform[s] && !a.uniform[steps + s];
      __syncthreads();
      if (warp == 0) classify(stage_sh, sh.cls[s & 1]);
      __syncthreads();
    }
    const bool mega = sh.mega_next != 0;
    // the member stream's gang boundaries (warp 0; read after the exchange)
    if (warp == 0) {
      const int v = lane < wave ? need_of(lane) : 0;
      const int incl = warp_inclusive_scan(v, lane);
      if (lane < wave) sh.bound[lane] = incl - v;
      if (lane == wave - 1) sh.bound[wave] = incl;
    }
    bool replay;
    if (mega) {
      // ---- uniform: the member stream over position 0's candidates. The
      // stream's total is read after the exchange: its block barriers are
      // what make warp 0's boundaries visible to the other warps
      rank_exchange(0, 1, true, s + 1);
      const int total = sh.bound[wave];
      const int ne = min(sh.ecnt[0], kk);
      // warp w (each warp for the positions w it has): the exclusive prefix
      // of min(cap, total) over the slots (warp 0 keeps it in tk), coverage
      // and gang w's boundary term: candidates' post-take less entry terms
      for (int w0 = 0; w0 < wave; w0 += warps) {
        const int w = w0 + warp;
        if (w >= wave && w0 > 0) continue;  // warp-uniform; warp 0 always runs
        int capc[4], pre[4], cap[4], sum = 0;
        for (int t = 0; t < 4; ++t) {
          const int s2 = lane * 4 + t;
          cap[t] = s2 < ne ? (int)ent[s2].y : 0;
          capc[t] = min(cap[t], total);
          sum += capc[t];
        }
        const int incl = warp_inclusive_scan(sum, lane);
        int p = incl - sum;
        for (int t = 0; t < 4; ++t) {
          const int s2 = lane * 4 + t;
          pre[t] = p;
          if (w == 0 && s2 < kk) tk[s2] = p;
          p += capc[t];
        }
        const bool covered = __shfl_sync(kFull, incl, 31) >= total;
        if (w == 0 && lane == 0) sh.flag = covered;
        if (w < wave) {
          const int need = need_of(w), bw = sh.bound[w];
          int d = 0;
          for (int t = 0; t < 4; ++t) {
            const int taken = min(max(bw - pre[t], 0), capc[t]);
            d += min(cap[t] - taken, need) - min(cap[t], need);
          }
          d = __reduce_add_sync(kFull, d);
          if (lane == 0) sh.feas[w] = sh.pooled[w] + d >= need;
        }
      }
      __syncthreads();
      bool ok = sh.flag != 0;
      for (int w = 0; w < wave; ++w) ok &= sh.feas[w] != 0;
      if (ok) {
        // the stream units between the gang boundaries, by the owners: a
        // thread a (candidate, gang) pair; the candidate's first also takes
        // its total off the leftover
        const int4* r0 = row(0);
        for (int q = tid; q < ne * wave; q += threads) {
          const int s2 = q / wave, w = q - s2 * wave;
          const int node = (int)(ent[s2].x & kNodeMask);
          if (!own(node)) continue;
          const int capc = min((int)ent[s2].y, total), pre = tk[s2];
          const int before = min(max(sh.bound[w] - pre, 0), capc);
          const int upto = min(max(sh.bound[w + 1] - pre, 0), capc);
          if (upto != before) a.alloc[(size_t)gi_of(w) * n + node] = upto - before;
          if (w == 0) {
            const int all = min(max(sh.bound[wave] - pre, 0), capc);
            if (all != 0)
              for (int k = 0; k < r; ++k) {
                int* cell = own_cell(node, k);
                *cell = (int)((unsigned)*cell - (unsigned)all * (unsigned)r0[k].x);
              }
          }
        }
        if (rank == 0)
          for (int w = tid; w < wave; w += threads)
            if (gi_of(w) >= 0) a.placed[gi_of(w)] = 1;
      }
      replay = !ok;
    } else {
      // ---- speculative: every position selects on its candidates at wave entry
      rank_exchange(0, wave, false, s + 1);
      for (int j = warp; j < wave; j += warps) {
        const int lj = sh.lst[j];
        const int f = select_slice(ent + lj * L, sh.ecnt[lj], tk + j * kk, need_of(j));
        if (lane == 0) sh.feas[j] = f;
      }
      __syncthreads();
      bool conflict = false;
      for (int j = 0; j < wave; ++j) conflict |= !sh.feas[j] && sh.pooled[j] >= need_of(j);
      if (!conflict) {
        // the conflict check on the touched columns: positive takes sorted
        // by (node, position)
        clean = false;
        if (tid == 0) sh.nent = 0;
        __syncthreads();
        for (int q = tid; q < wave * kk; q += threads) {
          const int t = tk[q];
          if (t > 0) {
            const int node = (int)(ent[sh.lst[q / kk] * L + q % kk].x & kNodeMask);
            gat[atomicAdd(&sh.nent, 1)] = make_int2((node << kNodeShift) | (q / kk), t);
          }
        }
        __syncthreads();
        const int ne = sh.nent;
        for (int e = tid; e < ne; e += threads) {
          const int2 me = gat[e];
          int pos = 0;
          for (int f = 0; f < ne; ++f) pos += gat[f].x < me.x;
          ents[pos] = me;
        }
        __syncthreads();
        bool bad = false;
        for (int q = tid; q < ne * wave; q += threads) {
          const int e = q / wave, j = q % wave;
          const int node = ents[e].x >> kNodeShift;
          if (e > 0 && (ents[e - 1].x >> kNodeShift) == node) continue;  // not the node's first
          if (!fits(j, node)) continue;
          int e_end = e;
          bool touched = false;
          while (e_end < ne && (ents[e_end].x >> kNodeShift) == node) {
            touched |= (ents[e_end].x & (kMaxWave - 1)) < j;
            ++e_end;
          }
          if (!touched) continue;
          int c0 = kBig, c1 = kBig;
          const int4* rq = row(j);
          for (int k0 = 0; k0 < r; k0 += 8) {
            int vv[8];
            remote_lanes8(cluster, lview, node, k0, rq, vv);
#pragma unroll
            for (int t = 0; t < 8; ++t) {
              const int k = k0 + t;
              if (k >= r || rq[k].x <= 0) continue;
              const int4 qr = rq[k];
              const long long v = vv[t];
              long long d = 0;
              for (int f = e; f < e_end; ++f) {
                const int jj = ents[f].x & (kMaxWave - 1);
                if (jj < j) d += (long long)ents[f].y * row(jj)[k].x;
              }
              const int v0 = (int)min(max(v, 0LL), (long long)kBig);
              const int v1 = (int)min(max(v - d, 0LL), (long long)kBig);
              c0 = min(c0, magic_div(v0, (unsigned)qr.y, qr.z));
              c1 = min(c1, magic_div(v1, (unsigned)qr.y, qr.z));
            }
          }
          bad |= c0 != c1;
        }
        dirty = true;
        conflict = __syncthreads_or(bad);
      }
      if (!conflict) {
        settle();
        // each own node's takes, one thread a node
        const int ne = sh.nent;
        for (int e = tid; e < ne; e += threads) {
          const int node = ents[e].x >> kNodeShift;
          if (!own(node)) continue;
          const int jj = ents[e].x & (kMaxWave - 1);
          a.alloc[(size_t)gi_of(jj) * n + node] = ents[e].y;
          if (e > 0 && (ents[e - 1].x >> kNodeShift) == node) continue;
          for (int k = 0; k < r; ++k) {
            unsigned d = 0;
            for (int f = e; f < ne && (ents[f].x >> kNodeShift) == node; ++f)
              d += (unsigned)ents[f].y * (unsigned)row(ents[f].x & (kMaxWave - 1))[k].x;
            int* cell = own_cell(node, k);
            *cell = (int)((unsigned)*cell - d);
          }
        }
        if (rank == 0)
          for (int j = tid; j < wave; j += threads)
            if (gi_of(j) >= 0) a.placed[gi_of(j)] = (unsigned char)sh.feas[j];
      }
      replay = conflict;
    }
    __syncthreads();
    int dem = 0;
    if (replay) {
      // the lists of the wave's exchange seed the replay. A mega wave's
      // gangs share one row and fit row: one list serves them all (`lj`),
      // and ranking afresh ranks that row once (with every position's
      // pooled sum); else each gang selects on its row's list (sh.lst).
      bool listed = true;
      int lj = mega ? 0 : -1;
      auto rerank = [&](int j) {
        settle();
        if (mega) {
          rank_exchange(j, j + 1, true, -1);
          lj = j;
        } else {
          rank_exchange(j, wave, false, -1);
        }
        listed = true;
      };
      for (int j = 0; j < wave; ++j) {
        if (gi_of(j) < 0) continue;
        bool ranked = false;
        if (!listed) {
          rerank(j);
          ranked = true;
        }
        int got = carried_gang(j, lj < 0 ? sh.lst[j] : lj);
        if (got == 2) {
          rerank(j);
          ranked = true;
          got = carried_gang(j, lj < 0 ? sh.lst[j] : lj);
        }
        if (got == 1) {
          settle();
          dense_step(j);
          ++dem;
          listed = false;
        }
        if (ranked) ++fresh;
        else ++served;
      }
      settle();
    }
    if (rank == 0 && tid == 0) {
      a.conflicts[s] = (unsigned char)replay;
      a.megas[s] = (unsigned char)mega;
      a.demotions[s] = dem;
    }
  }

  // no block exits while the cluster may read its shared memory
  __syncthreads();
  cluster_barrier();
  for (int i = 0; i < cnt; ++i)
    for (int k = 0; k < r; ++k) a.left_after[(size_t)(n0 + i) * r + k] = left[k * lane_slots + i * threads];
  if (rank == 0 && tid == 0) {
    a.counts[0] = served;
    a.counts[1] = fresh;
  }
}

// The launch's first kernel: every position's stage (ops/assign_scan.py
// `division_magic` for each lane of its gang's request, the gang index and
// need; zeros past G) and the two halves of the uniform flags
// (`wave_uniform`): uniform[s] = every position's request row equals the
// first position's and the needs sum to at most (2^31 - 1) / N, uniform[S +
// s] = 1 when a per-group mask row of wave s differs from its first
// position's (zeroed by the caller).
__global__ void __launch_bounds__(256) topk_prepare_kernel(const TopkArgs a) {
  const int g = a.g, r = a.r, n = a.n, wave = a.wave;
  const int steps = (g + wave - 1) / wave;
  auto index = [&](int pos) {
    const int gi = pos < g ? a.order[pos] : -1;
    return (unsigned)gi < (unsigned)g ? gi : -1;
  };
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < steps * wave * (r + 1);
       i += gridDim.x * blockDim.x) {
    const int p = i / (r + 1), k = i - p * (r + 1) - 1;
    const int gi = index(p);
    int4 v = make_int4(0, 0, 0, 0);
    if (k < 0) {
      v = make_int4(gi, gi >= 0 ? a.remaining[gi] : 0, 0, 0);
    } else if (gi >= 0) {
      const int q = a.group_req[(size_t)gi * r + k];
      const int d = min(max(q, 1), kBig);
      const int l = 32 - __clz(d - 1);  // ceil(log2 d)
      const unsigned long long m = (1ull << (31 + l)) / (unsigned)d + 1;
      v = make_int4(q, (int)(unsigned)m, l, 0);
    }
    a.stage[i] = v;
  }
  unsigned char* uniform = const_cast<unsigned char*>(a.uniform);
  if (a.mask_per_group) {
    for (int p = blockIdx.x; p < steps * wave; p += gridDim.x) {
      const int s = p / wave;
      if (p == s * wave) continue;
      const int gj = index(p), g0 = index(s * wave);
      bool differs = false;
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const bool b = gj >= 0 && a.mask[(size_t)gj * n + i] != 0;
        const bool b0 = g0 >= 0 && a.mask[(size_t)g0 * n + i] != 0;
        differs |= b != b0;
      }
      if (__syncthreads_or(differs) && threadIdx.x == 0) uniform[steps + s] = 1;
    }
  }
  const int lane = threadIdx.x & 31;
  const int nwarps = gridDim.x * (blockDim.x / 32);
  for (int s = blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5); s < steps; s += nwarps) {
    const int g0 = index(s * wave);
    bool same = true;
    long long total = 0;
    for (int j = lane; j < wave; j += 32) {
      const int gj = index(s * wave + j);
      if (gj >= 0) total += a.remaining[gj];
      for (int k = 0; k < r; ++k) {
        const int v = gj >= 0 ? a.group_req[(size_t)gj * r + k] : 0;
        const int v0 = g0 >= 0 ? a.group_req[(size_t)g0 * r + k] : 0;
        same &= v == v0;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) total += __shfl_xor_sync(kFull, total, o);
    same = __all_sync(kFull, same);
    if (lane == 0) uniform[s] = (unsigned char)(same && total <= 2147483647LL / max(n, 1));
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory a block may use on `device`: the per-block opt-in
// limit less the kernel's static shared memory. Negative on error (minus
// the CUDA error code).
int bst_assign_topk_shared_budget(int device) {
  int optin = 0;
  cudaError_t e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return -(int)e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, assign_topk_kernel);
  if (e != cudaSuccess) return -(int)e;
  return optin - (int)attr.sharedSizeBytes;
}

// The dynamic shared memory a launch of this shape needs (the kernel's
// layout), for the wrapper's plan to be checked against.
long long bst_assign_topk_shared_need(int wave, int kk, int list, int tmax, int r, int per,
                                      int threads, int shared_left, int shared_keys,
                                      int pub_buffers) {
  return layout(wave, kk, list, tmax, r, per, threads, shared_left, shared_keys, pub_buffers)
      .total;
}

// How many clusters of this shape the current device can hold at once
// (cudaOccupancyMaxActiveClusters): 0 means the shape cannot be scheduled.
// Negative on error (minus the CUDA error code). `per` and `shared` are
// unused (one instantiation); they keep the other kernels' signature.
int bst_assign_topk_clusters(int cluster_blocks, int threads, int per, int shared,
                             int shared_bytes) {
  (void)per;
  (void)shared;
  if (cluster_blocks < 1 || cluster_blocks > kMaxCluster || threads < 32 ||
      threads > kTopkThreads)
    return -(int)cudaErrorInvalidValue;
  cudaError_t e = configure((const void*)assign_topk_kernel, cluster_blocks, shared_bytes);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(cluster_blocks, threads, shared_bytes, nullptr, &attr);
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, (const void*)assign_topk_kernel, &cfg);
  if (e != cudaSuccess) return -(int)e;
  return clusters;
}

// Launch the top-K scan at width `wave` (2..32) with kk candidates a gang
// (2..128, at most N) and lists of `list` entries (kk..256) a gang: first
// the prepare kernel, which writes `stage` ([S * wave][R + 1] int4) and
// `uniform` (2S bytes, which the caller zeroes), then the scan as one
// cluster of `cluster_blocks` blocks of `threads` threads, which writes
// `megas`, `conflicts` (S bytes), `demotions` (S int32) and `counts` (2
// int32). Block b owns nodes [b * block_nodes, (b + 1) * block_nodes) and
// each thread `per` of them. With `shared_left` the leftover lives in
// shared memory and `left` is null; else `left` holds cluster_blocks * R *
// per * threads ints. `tmax` (at least kk) bounds a carried replay's
// touched nodes; `shared_keys` keeps the sweep's keys in shared memory;
// `pub_buffers` (1 or 2) publish buffers alternate. `shared_bytes` is
// the dynamic shared memory, at least bst_assign_topk_shared_need. alloc
// and placed must be zeroed by the caller.
int bst_assign_topk(const void* left0, const void* group_req, const void* remaining,
                    const void* mask, const void* order, void* stage, void* uniform,
                    void* alloc, void* placed, void* left_after, void* conflicts, void* megas,
                    void* demotions, void* counts, void* left, int n, int g, int r,
                    int mask_per_group, int wave, int kk, int list, int tmax,
                    int cluster_blocks, int block_nodes, int threads, int per, int shared_left,
                    int shared_keys, int pub_buffers, int shared_bytes, void* stream) {
  if (wave < 2 || wave > kMaxWave || kk < 2 || kk > kMaxK || kk > n || list < kk ||
      list > kMaxList || tmax < kk || cluster_blocks < 1 || cluster_blocks > kMaxCluster ||
      threads < 32 || threads > kTopkThreads || threads % 32 != 0 || per < 1 ||
      (long long)threads * per < block_nodes || (long long)cluster_blocks * block_nodes < n ||
      n >= (1 << kCompShift) || (left == nullptr) != (shared_left != 0) ||
      (pub_buffers != 1 && pub_buffers != 2) ||
      shared_bytes <
          layout(wave, kk, list, tmax, r, per, threads, shared_left, shared_keys, pub_buffers)
              .total)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = configure((const void*)assign_topk_kernel, cluster_blocks, shared_bytes);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  TopkArgs args{(const int*)left0, (const int*)group_req, (const int*)remaining,
                (const unsigned char*)mask, (const int*)order, (int4*)stage,
                (const unsigned char*)uniform, (int*)alloc, (unsigned char*)placed,
                (int*)left_after, (unsigned char*)conflicts, (unsigned char*)megas,
                (int*)demotions, (int*)counts, (int*)left, n, g, r, mask_per_group, wave, kk,
                list, tmax, block_nodes, per, shared_left, shared_keys, pub_buffers};
  const int steps = (g + wave - 1) / wave;
  topk_prepare_kernel<<<max(1, min(steps * wave, 2048)), 256, 0, st>>>(args);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(cluster_blocks, threads, shared_bytes, st, &attr);
  e = cudaLaunchKernelEx(&cfg, assign_topk_kernel, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* bst_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
